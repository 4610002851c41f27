"""Gated descriptor matching on the card (counterpart of
mcslam_tpu/ops/match_pallas.py hamming_argmin2; kernel source
csrc/hamming_argmin2.cu: a tensor-core tile launch and a fixed-order
merge launch, no atomics).

`hamming_argmin2` launches the kernel for CUDA tensors and runs
`hamming_argmin2_reference`, the plain PyTorch version, for CPU tensors.
Distances are integers and the tie rules (first index) are the same, so
the two agree exactly except where a pair's f32 gate distance d2 sits at
the threshold, where the two summation orders may round to opposite
sides.
"""

from __future__ import annotations

import torch

from mcslam_tpu_torch import _build
from mcslam_tpu_torch.ops import hamming
from mcslam_tpu_torch.utils import graphs

BIGF = float(1 << 20)  # matches ops/match.BIG
# bias magnitude for validity folding: must dominate the largest raw d2
# (projections are clipped to +-1e5 -> d2 <= ~4e10) plus the 1e12
# behind-camera penalty already inside the gate factors
PASS_BIAS = 1e13
DG_MAX = 16  # gate factors the kernel holds in registers
MAX_ROWS = (1 << 22) - 1  # query rows a column key can name


def hamming_argmin2_reference(a_desc: torch.Tensor, b_desc: torch.Tensor,
                              ahat: torch.Tensor, bhat: torch.Tensor,
                              thr2: float, want_cols: bool = True):
    """Plain PyTorch version. a_desc (M, 8) / b_desc (N, 8) int32 words,
    ahat (M, DG), bhat (DG, N) f32 -> (row_best f32 (M,), row_second f32
    (M,), row_idx int32 (M,), col_idx int32 (N,) or None). Pair (i, j) is
    admissible iff (ahat @ bhat)[i, j] < thr2; others score BIGF."""
    dist = hamming.hamming_matrix(a_desc, b_desc).to(torch.float32)
    d2 = ahat @ bhat
    thr = graphs.values(thr2, torch.float32, d2.device)
    gated = torch.where(d2 < thr, dist, torch.full_like(dist, BIGF))
    idx = torch.argmin(gated, dim=1, keepdim=True)
    best = torch.gather(gated, 1, idx)[:, 0]
    second = torch.amin(gated.scatter(1, idx, BIGF), dim=1)
    col_idx = (torch.argmin(gated, dim=0).to(torch.int32)
               if want_cols else None)
    return best, second, idx[:, 0].to(torch.int32), col_idx


def hamming_argmin2(a_desc: torch.Tensor, b_desc: torch.Tensor,
                    ahat: torch.Tensor, bhat: torch.Tensor, thr2: float,
                    want_cols: bool = True):
    """See hamming_argmin2_reference. CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    if a_desc.device.type == "cpu":
        return hamming_argmin2_reference(a_desc, b_desc, ahat, bhat, thr2,
                                         want_cols)
    dev = a_desc.device
    if dev.type != "cuda":
        raise ValueError(f"hamming_argmin2: unsupported device {dev}")
    M, N = a_desc.shape[0], b_desc.shape[0]
    DG = ahat.shape[-1]
    for name, v, shape, dt in (
        ("a_desc", a_desc, (M, 8), torch.int32),
        ("b_desc", b_desc, (N, 8), torch.int32),
        ("ahat", ahat, (M, DG), torch.float32),
        ("bhat", bhat, (DG, N), torch.float32),
    ):
        if (v.device != dev or v.dtype != dt or tuple(v.shape) != shape
                or not v.is_contiguous()):
            raise ValueError(f"hamming_argmin2: {name} must be a contiguous "
                             f"{shape} {dt} tensor on {dev}, got "
                             f"{tuple(v.shape)} {v.dtype} {v.device}")
    if not 1 <= DG <= DG_MAX:
        raise ValueError(f"hamming_argmin2: DG={DG} outside [1, {DG_MAX}]")
    if N == 0:
        raise ValueError("hamming_argmin2: no target columns")
    if M > MAX_ROWS:
        raise ValueError(f"hamming_argmin2: M={M} rows over {MAX_ROWS}")
    best = torch.empty(M, dtype=torch.float32, device=dev)
    second = torch.empty(M, dtype=torch.float32, device=dev)
    idx = torch.empty(M, dtype=torch.int32, device=dev)
    col_idx = (torch.empty(N, dtype=torch.int32, device=dev) if want_cols
               else None)
    lib = _build.library()
    # per-split row and per-tile column partials, merged by the kernel's
    # second launch
    fscratch = torch.empty(lib.mc_hamming_scratch_floats(M, N),
                           dtype=torch.float32, device=dev)
    iscratch = torch.empty(lib.mc_hamming_scratch_ints(M, N),
                           dtype=torch.int32, device=dev)
    _build.count("hamming_argmin2")
    _build.check(lib.mc_hamming_argmin2(
        a_desc.data_ptr(), b_desc.data_ptr(), ahat.data_ptr(),
        bhat.data_ptr(), best.data_ptr(), second.data_ptr(), idx.data_ptr(),
        col_idx.data_ptr() if want_cols else None, fscratch.data_ptr(),
        iscratch.data_ptr(), M, N, DG, float(thr2), _build.stream_ptr(dev),
    ), "mc_hamming_argmin2")
    return best, second, idx, col_idx
