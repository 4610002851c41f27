"""The intra-rig match and the triangulation's gathers as CUDA entries
(kernel sources csrc/intra_match.cu and csrc/intra_glue.cu), the port's
counterparts of the TPU-shaped code of the JAX package's frame build
(mcslam_tpu/frontend/intra.py intra_match :68-200 and
mcslam_tpu/frontend/frame.py _triangulate_stage :91-122); no Pallas
kernel corresponds to them.

- `intra_gate`: the Sampson gate of every camera pair from the
  undistorted keypoints and the rig's pair constants (frontend/intra.
  pair_constants);
- `intra_pairs`: the rig's descriptors, validity and that gate to the
  parent table of the feature groups: the Hamming distances, each pair's
  gated mutual-best match with the distance and ratio tests, and the
  merge of the pairs' matches into the least matched feature of a lower
  camera;
- `intra_groups`: the parent table to the groups: the roots by pointer
  jumping, the per-camera ray table, the priority and its stable top-k,
  the group slots;
- `tri_gather`: the groups' pixels, sigmas, masks and anchors that the
  triangulation reads.

CUDA tensors launch the kernel (or raise); CPU tensors run the plain
version, `<name>_reference`. The gate's plain version writes its dots in
the kernel's order and the rest are integers, selects and gathers, so
on the card each kernel equals its plain version bit for bit.
"""

from __future__ import annotations

import functools

import torch

from mcslam_tpu_torch import _build
from mcslam_tpu_torch.ops import hamming, match
from mcslam_tpu_torch.ops.topk_grid import topk_stable
from mcslam_tpu_torch.utils import graphs, outputs

TILE = 128  # rows and columns of a block's tile in csrc/intra_match.cu
COUNTERS = 128  # arrival counters of a device's buffer (P + C <= COUNTERS)
MAX_KEYS = 16384  # C N that intra_groups ranks (every block holds them)
MAX_CAMERAS = 32  # C of intra_groups (a camera bitmask per root)

def tiles(N: int) -> int:
    """Row tiles (and column splits) of the kernel's grid for N features."""
    return -(-N // TILE)


def scratch_ints(C: int, N: int) -> int:
    """int32 scratch of one call: per (pair, row) its (best, second) keys
    for each column split (the splits rounded up to even), per (pair,
    column) its key for each row tile, and per (pair, column) its
    candidate."""
    P, T = C * (C - 1) // 2, tiles(N)
    return P * N * (2 * (T + T % 2) + T + 1)


def check_buffers(C: int, N: int, scratch: torch.Tensor,
                  counters: torch.Tensor) -> None:
    """Raise unless scratch and counters are what a launch at (C, N)
    needs: contiguous int32, scratch_ints(C, N) and P + C elements at
    least (a counter per pair, then per camera)."""
    P = C * (C - 1) // 2
    for name, x, n in (("scratch", scratch, scratch_ints(C, N)),
                       ("counters", counters, P + C)):
        if x.dtype != torch.int32 or not x.is_contiguous() or x.numel() < n:
            raise ValueError(f"intra_pairs: {name} must be contiguous int32 "
                             f"of {n} elements at least, got {x.dtype} of "
                             f"{x.numel()}, contiguous {x.is_contiguous()}")


def counters(dev: torch.device) -> torch.Tensor:
    """The kernel's arrival counters on `dev` (graphs.counters)."""
    return graphs.counters("intra_pairs", COUNTERS, dev)


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
    parent = torch.empty(C, N, dtype=torch.int32, device=dev)
    scratch = torch.empty(scratch_ints(C, N), dtype=torch.int32, device=dev)
    cnt = counters(dev)
    check_buffers(C, N, scratch, cnt)
    lib = _build.library()
    _build.count("intra_pairs")
    _build.check(lib.mc_intra_pairs(
        desc.data_ptr(), valid.data_ptr(), gate.data_ptr(), parent.data_ptr(),
        scratch.data_ptr(), cnt.data_ptr(), C, N, tiles(N), scratch.numel(),
        cnt.numel(), int(max_dist), float(ratio), _build.stream_ptr(dev),
    ), "mc_intra_pairs")
    return parent


def normalized(xy_ud: torch.Tensor, fxycxy: torch.Tensor) -> torch.Tensor:
    """(C, N, 2) undistorted pixels -> normalized coordinates (xy - c) / f
    under the (C, 4) intrinsics."""
    f = fxycxy[:, None, :]
    return (xy_ud - f[..., 2:]) / f[..., :2]


def sampson_terms(xn_i: torch.Tensor, xn_j: torch.Tensor,
                  E: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., Ni, 2) x (..., Nj, 2) normalized coords, E (..., 3, 3) ->
    the Sampson distance's numerator t^2 and denominator per (..., Ni, Nj)
    cell, in csrc/intra_glue.cu's order: the three-term dots with the
    homogeneous 1 last, the denominator summed left to right from the
    column's two terms, clamped at 1e-12."""
    xi0, xi1 = xn_i[..., :, None, 0], xn_i[..., :, None, 1]
    xj0, xj1 = xn_j[..., None, :, 0], xn_j[..., None, :, 1]

    def e(k, l):
        return E[..., k, l][..., None, None]

    Exj = [(e(k, 0) * xj0 + e(k, 1) * xj1) + e(k, 2) for k in range(3)]
    Ethi = [(xi0 * e(0, k) + xi1 * e(1, k)) + e(2, k) for k in range(2)]
    t = (xi0 * Exj[0] + xi1 * Exj[1]) + Exj[2]
    den = ((Exj[0] * Exj[0] + Exj[1] * Exj[1]) + Ethi[0] * Ethi[0]) \
        + Ethi[1] * Ethi[1]
    return t * t, torch.clamp(den, min=1e-12)


def sampson_gate_sq(xn_i: torch.Tensor, xn_j: torch.Tensor,
                    E: torch.Tensor, thr2) -> torch.Tensor:
    """(..., Ni, 2) x (..., Nj, 2) normalized coords -> (..., Ni, Nj) bool
    Sampson-distance gate under E (..., 3, 3) (x_i^T E x_j = 0): the
    squared distance below thr2, sampson_terms' numerator over its
    denominator by one division."""
    num, den = sampson_terms(xn_i, xn_j, E)
    return num / den < thr2


def intra_gate_reference(xy_ud: torch.Tensor, fxycxy: torch.Tensor,
                         E: torch.Tensor, thr2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of intra_gate: xy_ud (C, N, 2), fxycxy (C,
    4), E (P, 3, 3) of the camera_pairs(C), thr2 a 0-d float32 ->
    (P, N, N) bool."""
    C = xy_ud.shape[0]
    xn = normalized(xy_ud, fxycxy)
    pair_i, pair_j = camera_pairs(C)
    pi = graphs.values(tuple(pair_i), torch.int64, xy_ud.device)
    pj = graphs.values(tuple(pair_j), torch.int64, xy_ud.device)
    return sampson_gate_sq(xn.index_select(0, pi), xn.index_select(0, pj),
                           E, thr2)


def intra_gate(xy_ud: torch.Tensor, fxycxy: torch.Tensor, E: torch.Tensor,
               thr2: torch.Tensor) -> torch.Tensor:
    """The Sampson gate of the P = C (C - 1) / 2 camera_pairs(C), C >= 2:
    xy_ud (C, N, 2) undistorted pixels, fxycxy (C, 4), E (P, 3, 3) the
    pairs' essential matrices, thr2 the 0-d float32 squared threshold in
    normalized units -> (P, N, N) bool, intra_pairs' gate. CUDA tensors
    launch the kernel; CPU tensors take intra_gate_reference."""
    if xy_ud.dim() != 3 or xy_ud.shape[-1] != 2 or xy_ud.shape[0] < 2:
        raise ValueError(f"intra_gate: xy_ud must be (C >= 2, N, 2), got "
                         f"{tuple(xy_ud.shape)}")
    C, N = xy_ud.shape[:2]
    P = C * (C - 1) // 2
    if _build.device_type(xy_ud, "intra_gate") == "cpu":
        return intra_gate_reference(xy_ud, fxycxy, E, thr2)
    dev = xy_ud.device
    f32 = torch.float32
    xy, f, e, t = _build.kernel_inputs(
        "intra_gate", dev, xy_ud=(xy_ud, f32, (C, N, 2)),
        fxycxy=(fxycxy, f32, (C, 4)), E=(E, f32, (P, 3, 3)),
        thr2=(thr2, f32, ()))
    gate = torch.empty(P, N, N, dtype=torch.bool, device=dev)
    if N == 0:
        return gate
    lib = _build.library()
    _build.count("intra_gate")
    _build.check(lib.mc_intra_gate(
        xy.data_ptr(), f.data_ptr(), e.data_ptr(), t.data_ptr(),
        gate.data_ptr(), C, N, _build.stream_ptr(dev)), "mc_intra_gate")
    return gate


def intra_groups_reference(parent: torch.Tensor, valid: torch.Tensor,
                           response: torch.Tensor, desc: torch.Tensor,
                           max_out: int):
    """Plain PyTorch version of intra_groups: parent (C, N) int32 flat
    indices, valid (C, N) bool, response (C, N) float32, desc (C, N, 8)
    int32 -> (ray_idx (max_out, C) int32, desc (max_out, 8) int32, valid
    (max_out,) bool)."""
    C, N = valid.shape
    dev = valid.device
    flat_parent = parent.reshape(C * N).long()
    for _ in range(3):  # 2^3 = 8 >= C hops
        flat_parent = flat_parent[flat_parent]
    flat_valid = valid.reshape(C * N)
    is_root = (flat_parent == torch.arange(C * N, device=dev)) & flat_valid

    # per camera: does it contribute a ray to root r, and with which
    # feature (the largest index on duplicates)
    parent_cn = flat_parent.reshape(C, N)
    feat = torch.arange(N, device=dev)[None, :].expand(C, N)
    ray_of_root = torch.full((C, C * N), -1, dtype=torch.int64, device=dev)
    ray_of_root = ray_of_root.scatter_reduce(
        1, parent_cn, torch.where(valid, feat, -1), reduce="amax")
    n_rays = torch.sum(ray_of_root >= 0, dim=0)

    priority = torch.where(
        is_root, n_rays.to(torch.float32) * 1e3 + response.reshape(C * N),
        torch.full((C * N,), -1.0, device=dev))
    k = min(max_out, C * N)
    top_p, top_i = topk_stable(priority, k)
    out_valid = top_p > 0.0
    table = ray_of_root[:, top_i].T.to(torch.int32)  # (k, C)
    ray_idx = torch.where(out_valid[:, None], table, torch.full_like(table, -1))
    out_desc = desc.reshape(C * N, 8)[top_i]
    if k < max_out:
        pad = max_out - k
        ray_idx = torch.cat([ray_idx, torch.full(
            (pad, C), -1, dtype=torch.int32, device=dev)])
        out_desc = torch.cat([out_desc, torch.zeros(
            pad, 8, dtype=out_desc.dtype, device=dev)])
        out_valid = torch.cat([out_valid, torch.zeros(
            pad, dtype=torch.bool, device=dev)])
    return ray_idx, out_desc, out_valid


def intra_groups(parent: torch.Tensor, valid: torch.Tensor,
                 response: torch.Tensor, desc: torch.Tensor, max_out: int):
    """The feature groups of a parent table (intra_pairs'): parent (C, N)
    int32 flat indices, valid (C, N) bool, response (C, N) float32, desc
    (C, N, 8) int32 -> (ray_idx (max_out, C) int32 the feature of each
    camera in each group slot, -1 none; desc (max_out, 8) int32 the root's
    descriptor; valid (max_out,) bool), the slots by priority (more rays,
    then response; ties to the lower flat index), padded past C N. CUDA
    tensors launch the kernel (C N <= MAX_KEYS, C <= MAX_CAMERAS); CPU
    tensors take intra_groups_reference."""
    if valid.dim() != 2:
        raise ValueError(f"intra_groups: valid must be (C, N), got "
                         f"{tuple(valid.shape)}")
    C, N = valid.shape
    if max_out < 1:
        raise ValueError(f"intra_groups: max_out must be >= 1, got {max_out}")
    if _build.device_type(valid, "intra_groups") == "cpu":
        return intra_groups_reference(parent, valid, response, desc, max_out)
    dev = valid.device
    if not (1 <= C * N <= MAX_KEYS and C <= MAX_CAMERAS):
        raise ValueError(f"intra_groups: the kernel ranks 1 to {MAX_KEYS} "
                         f"features of at most {MAX_CAMERAS} cameras (a "
                         f"camera bitmask per root), got C = {C}, C N = "
                         f"{C * N}")
    p, v, r, d = _build.kernel_inputs(
        "intra_groups", dev, parent=(parent, torch.int32, (C, N)),
        valid=(valid, torch.bool, (C, N)),
        response=(response, torch.float32, (C, N)),
        desc=(desc, torch.int32, (C, N, 8)))
    ray_idx = torch.empty(max_out, C, dtype=torch.int32, device=dev)
    out_desc = torch.empty(max_out, 8, dtype=torch.int32, device=dev)
    out_valid = torch.empty(max_out, dtype=torch.bool, device=dev)
    lib = _build.library()
    _build.count("intra_groups")
    _build.check(lib.mc_intra_groups(
        p.data_ptr(), v.data_ptr(), r.data_ptr(), d.data_ptr(),
        ray_idx.data_ptr(), out_desc.data_ptr(),
        out_valid.data_ptr(), C, N, int(max_out), _build.stream_ptr(dev)),
        "mc_intra_groups")
    return ray_idx, out_desc, out_valid


def tri_gather_reference(ray_idx: torch.Tensor, valid: torch.Tensor,
                         xy_ud: torch.Tensor, kp_sigma2: torch.Tensor):
    """Plain PyTorch version of tri_gather: ray_idx (M, C) int32, valid
    (M,) bool, xy_ud (C, N, 2), kp_sigma2 (C, N) -> (uv (M, C, 2), sigma
    (M, C), mask (M, C), anchor_cam (M,) int32, uv_ref (M, 2),
    anchor_sigma2 (M,), n_rays (M,) int32, multi & valid (M,))."""
    M, C = ray_idx.shape
    dev = ray_idx.device
    ray_valid = ray_idx >= 0
    safe_idx = torch.clamp(ray_idx, min=0).long()
    cam_idx = torch.arange(C, device=dev)[None, :].expand(M, C)
    uv = xy_ud[cam_idx, safe_idx]
    sig2 = kp_sigma2[cam_idx, safe_idx]
    multi = torch.sum(ray_valid, dim=-1) >= 2
    # a correctly rounded float32 square root on every device
    sigma = torch.sqrt(sig2.double()).float()
    anchor_cam = torch.argmax(ray_valid.to(torch.uint8), dim=-1)
    anchor_kp = torch.gather(safe_idx, 1, anchor_cam[:, None])[:, 0]
    uv_ref = xy_ud[anchor_cam, anchor_kp]
    anchor_sigma2 = kp_sigma2[anchor_cam, anchor_kp]
    n_rays = torch.sum(ray_valid, dim=-1).to(torch.int32)
    return (uv, sigma, ray_valid & multi[:, None],
            anchor_cam.to(torch.int32), uv_ref, anchor_sigma2, n_rays,
            multi & valid)


@functools.lru_cache(maxsize=16)
def _tri_gather_layout(M: int, C: int):
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    return outputs.layout(((M, C, 2), (M, C), (M, C), (M,), (M, 2), (M,),
                           (M,), (M,)), (f32, f32, b8, i32, f32, f32, i32, b8))


def tri_gather_outputs(M: int, C: int, dev):
    """tri_gather's eight outputs on dev, carved from one buffer: each
    contiguous, of tri_gather_reference's shape and dtype, at an
    outputs.ALIGN-byte boundary."""
    return tuple(outputs.carve(_tri_gather_layout(M, C), dev))


def tri_gather(ray_idx: torch.Tensor, valid: torch.Tensor,
               xy_ud: torch.Tensor, kp_sigma2: torch.Tensor):
    """The triangulation's inputs from the groups: ray_idx (M, C) int32
    (-1: no ray), valid (M,) bool, xy_ud (C, N, 2) float32, kp_sigma2 (C,
    N) float32 -> (uv (M, C, 2) the rays' pixels, sigma (M, C) their
    correctly rounded sqrt(sigma2), mask (M, C) the rays of groups of two
    rays or more, anchor_cam (M,) int32 the first camera with a ray (0
    without one), uv_ref (M, 2) and anchor_sigma2 (M,) its pixel and
    sigma2, n_rays (M,) int32, multi & valid (M,) bool). CUDA tensors
    launch the kernel (its outputs carved from one buffer,
    tri_gather_outputs); CPU tensors take tri_gather_reference."""
    if ray_idx.dim() != 2 or xy_ud.dim() != 3:
        raise ValueError(f"tri_gather: ray_idx must be (M, C) and xy_ud "
                         f"(C, N, 2), got {tuple(ray_idx.shape)} and "
                         f"{tuple(xy_ud.shape)}")
    M, C = ray_idx.shape
    N = xy_ud.shape[1]
    if _build.device_type(ray_idx, "tri_gather") == "cpu":
        return tri_gather_reference(ray_idx, valid, xy_ud, kp_sigma2)
    dev = ray_idx.device
    f32 = torch.float32
    r, v, xy, s2 = _build.kernel_inputs(
        "tri_gather", dev, ray_idx=(ray_idx, torch.int32, (M, C)),
        valid=(valid, torch.bool, (M,)), xy_ud=(xy_ud, f32, (C, N, 2)),
        kp_sigma2=(kp_sigma2, f32, (C, N)))
    if N < 1:
        raise ValueError("tri_gather: the kernel needs N >= 1 features")
    outs = tri_gather_outputs(M, C, dev)
    lib = _build.library()
    _build.count("tri_gather")
    _build.check(lib.mc_tri_gather(
        r.data_ptr(), v.data_ptr(), xy.data_ptr(), s2.data_ptr(),
        *(o.data_ptr() for o in outs), M, C, N, _build.stream_ptr(dev)),
        "mc_tri_gather")
    return outs
