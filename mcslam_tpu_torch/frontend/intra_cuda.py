"""The intra-rig pair match in two launches, a CUDA entry (kernel source
csrc/intra_match.cu), the port's counterpart of the TPU-shaped pair stage
of the JAX package's intra match (mcslam_tpu/frontend/intra.py
intra_match :110-147); no Pallas kernel corresponds to it.

`intra_pairs` takes the rig's descriptors, validity and the Sampson gate
of every camera pair to the parent table of the feature groups: the
Hamming distances, each pair's gated mutual-best match with the distance
and ratio tests, and the merge of the pairs' matches into the least
matched feature of a lower camera. CUDA tensors launch the kernel; CPU
tensors run `intra_pairs_reference`, the plain PyTorch version. Every
output is an integer, so the two agree exactly.
"""

from __future__ import annotations

import torch

from mcslam_tpu_torch import _build
from mcslam_tpu_torch.ops import hamming, match
from mcslam_tpu_torch.utils import graphs

ROW_TILE = 32  # rows of a block's tile in csrc/intra_match.cu (RT)


def camera_pairs(C: int) -> tuple[list[int], list[int]]:
    """The pairs (i, j), i < j, in the order (0, 1), (0, 2), ..., (C - 2,
    C - 1): pair_i, pair_j."""
    pair_i = [i for i in range(C - 1) for _ in range(i + 1, C)]
    pair_j = [j for i in range(C - 1) for j in range(i + 1, C)]
    return pair_i, pair_j


def intra_pairs_reference(desc: torch.Tensor, valid: torch.Tensor,
                          gate: torch.Tensor, max_dist: int = 60,
                          ratio: float = 0.85) -> torch.Tensor:
    """Plain PyTorch version of intra_pairs: desc (C, N, 8) int32 words,
    valid (C, N) bool, gate (P, N, N) bool of the camera_pairs(C) ->
    parent (C, N) int32 flat indices."""
    C, N = desc.shape[:2]
    dev = desc.device
    planes = hamming.to_planes(desc.reshape(C * N, 8)).reshape(C, N, -1)
    flat_self = torch.arange(C * N, dtype=torch.int32, device=dev).reshape(C, N)
    pair_i, pair_j = camera_pairs(C)
    # camera pairs by index tensors made once per device (a Python list
    # index is a host upload)
    pi = graphs.values(tuple(pair_i), torch.int64, dev)
    pj = graphs.values(tuple(pair_j), torch.int64, dev)
    d = hamming.hamming_from_planes(planes.index_select(0, pi),
                                    planes.index_select(0, pj))
    cands = []
    for p, (i, j) in enumerate(zip(pair_i, pair_j)):
        res = match.match_mutual(
            d[p], row_mask=valid[i], col_mask=valid[j],
            max_dist=max_dist, ratio=ratio, pair_mask=gate[p],
        )
        # cam-j feature -> flat index of its matched cam-i feature;
        # mutual-best makes it 1-1 (lowest row on duplicates)
        eq = res.ok[:, None] & (
            res.idx[:, None] == torch.arange(N, device=dev)[None, :])
        row = torch.argmax(eq.to(torch.uint8), dim=0)
        cands.append(torch.where(
            torch.any(eq, dim=0), flat_self[i][row],
            torch.full_like(flat_self[i], C * N)))
    rows = [flat_self[0]]
    for j in range(1, C):
        sel = [p for p in range(len(pair_i)) if pair_j[p] == j]
        best = cands[sel[0]]
        for p in sel[1:]:
            best = torch.minimum(best, cands[p])
        rows.append(torch.where(best < flat_self[j], best, flat_self[j]))
    return torch.stack(rows)


def intra_pairs(desc: torch.Tensor, valid: torch.Tensor, gate: torch.Tensor,
                max_dist: int = 60, ratio: float = 0.85) -> torch.Tensor:
    """desc (C, N, 8) int32, valid (C, N) bool, gate (P, N, N) bool for
    the P = C (C - 1) / 2 camera_pairs(C), C >= 2 -> parent (C, N) int32:
    the flat index c N + n of each feature's parent (the least matched
    feature of a lower camera, else itself). CUDA tensors launch the kernel
    (contiguous inputs only); CPU tensors take intra_pairs_reference."""
    if desc.dim() != 3 or desc.shape[-1] != 8:
        raise ValueError(f"intra_pairs: desc must be (C, N, 8), got "
                         f"{tuple(desc.shape)}")
    C, N = desc.shape[:2]
    P = C * (C - 1) // 2
    if tuple(valid.shape) != (C, N) or tuple(gate.shape) != (P, N, N):
        raise ValueError(f"intra_pairs: valid {tuple(valid.shape)} and gate "
                         f"{tuple(gate.shape)} must be {(C, N)} and "
                         f"{(P, N, N)}")
    if desc.device.type == "cpu":
        return intra_pairs_reference(desc, valid, gate, max_dist, ratio)
    if desc.device.type != "cuda":
        raise ValueError(f"intra_pairs: unsupported device {desc.device}")
    dev = desc.device
    for name, x, dtype in (("desc", desc, torch.int32),
                           ("valid", valid, torch.bool),
                           ("gate", gate, torch.bool)):
        if x.dtype != dtype or x.device != dev or not x.is_contiguous():
            raise ValueError(f"intra_pairs: the kernel takes a contiguous "
                             f"{dtype} {name} on {dev}, got {x.dtype} on "
                             f"{x.device}, contiguous {x.is_contiguous()}")
    T = -(-N // ROW_TILE)
    parent = torch.empty(C, N, dtype=torch.int32, device=dev)
    rows = torch.empty(3, P, N, dtype=torch.int32, device=dev)
    colpart = torch.empty(P, T, N, dtype=torch.int64, device=dev)
    lib = _build.library()
    _build.count("intra_pairs")
    _build.check(lib.mc_intra_pairs(
        desc.data_ptr(), valid.data_ptr(), gate.data_ptr(), parent.data_ptr(),
        rows.data_ptr(), colpart.data_ptr(), C, N, T, int(max_dist),
        float(ratio), _build.stream_ptr(dev),
    ), "mc_intra_pairs")
    return parent
