"""The RANSAC portfolio's three steps as CUDA entries (kernel sources
csrc/ransac_score.cu, csrc/kabsch_hyp.cu, csrc/pnp_hyp.cu), the port's
counterparts of the TPU-shaped scoring and minimal solvers of the JAX
package's RANSAC (mcslam_tpu/frontend/ransac.py _score_reprojection
:150, ransac_kabsch :176 with geometry/alignment.py kabsch_quat :59,
ransac_pnp :293 with _dlt_pnp :263 and _dlt_gpnp :209); no Pallas kernel
corresponds to them.

- `score`: K pose hypotheses against M correspondences -> inlier counts,
  the first hypothesis of the most inliers, its pose, count (int32) and
  inlier mask, in one launch (a 2-D grid of tiles; the flags kept as bit
  rows in a scratch the wrapper allocates, the winner's mask expanded
  from its row);
- `kabsch_hyp`: (K, 3) sample indices -> K 3-point Kabsch hypotheses;
- `pnp_hyp`: (K, S) sample indices -> K 6-point DLT hypotheses, the
  first half central, the rest generalized where the rig has a lever arm
  (read on the card).

CUDA tensors launch the kernel (or raise); CPU tensors run the plain
version, the functions of frontend/ransac (`score_reference`,
`ransac.kabsch_hypotheses`, `ransac.pnp_hypotheses`), bit for bit. On
the card the scores equal the plain version's but where an error lies
within the rounding of the plain version's matmuls of px^2; the
hypotheses agree to float32 rounding (chip_smoke.py phase 2 states the
criteria).
"""

from __future__ import annotations

import torch

from mcslam_tpu_torch import _build
from mcslam_tpu_torch.utils import graphs


def _device(x: torch.Tensor, name: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.device.type


def _inputs(name, dev, **tensors):
    """The kernel's contiguous views of tensors {name: (tensor, dtype,
    trailing shape)}; raises on another device, type or shape (the
    launcher refuses poses and intrinsics not 16-byte aligned)."""
    out = []
    for arg, (x, dtype, tail) in tensors.items():
        if (x.device != dev or x.dtype != dtype
                or tuple(x.shape[1:]) != tail):
            raise ValueError(f"{name}: {arg} must be {dtype} (n, "
                             f"{', '.join(map(str, tail))}) on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
        out.append(x.contiguous())
    return out


def score_reference(world_T_ref_h, X_world, uv, cam_T_ref, fxycxy, mask,
                    px_thresh: float):
    """Plain PyTorch version of score: ransac._score_reprojection, then
    the first argmax and its gathers -> (counts (K,) int64, best
    (1,) int64, pose (4, 4), count () int32, inliers (M,) bool)."""
    from mcslam_tpu_torch.frontend import ransac

    counts, inl = ransac._score_reprojection(
        world_T_ref_h, X_world, uv, cam_T_ref, fxycxy, mask, px_thresh)
    # index_select: indexing by a 0-d tensor reads it on the host
    best = torch.argmax(counts).reshape(1)
    n = counts.index_select(0, best)[0]
    return (counts, best, world_T_ref_h.index_select(0, best)[0],
            n.to(torch.int32), inl.index_select(0, best)[0])


def score(world_T_ref_h, X_world, uv, cam_T_ref, fxycxy, mask,
          px_thresh: float):
    """world_T_ref_h (K, 4, 4) hypotheses, K >= 1; X_world (M, 3), uv (M,
    2), cam_T_ref (M, 4, 4), fxycxy (M, 4) float32, mask (M,) bool ->
    (counts (K,) int64, best (1,) int64, the best's pose (4, 4), inlier
    count () int32 and inliers (M,) bool). CUDA tensors launch
    ransac_score (one launch); CPU tensors take score_reference."""
    if world_T_ref_h.dim() != 3 or world_T_ref_h.shape[0] < 1:
        raise ValueError(f"score: world_T_ref_h must be (K, 4, 4), K >= 1, "
                         f"got {tuple(world_T_ref_h.shape)}")
    if _device(world_T_ref_h, "score") == "cpu":
        return score_reference(world_T_ref_h, X_world, uv, cam_T_ref, fxycxy,
                               mask, px_thresh)
    dev = world_T_ref_h.device
    f32 = torch.float32
    hyp, X, u, T, f, m = _inputs(
        "score", dev, world_T_ref_h=(world_T_ref_h, f32, (4, 4)),
        X_world=(X_world, f32, (3,)), uv=(uv, f32, (2,)),
        cam_T_ref=(cam_T_ref, f32, (4, 4)), fxycxy=(fxycxy, f32, (4,)),
        mask=(mask, torch.bool, ()))
    K, M = hyp.shape[0], X.shape[0]
    if not (u.shape[0] == T.shape[0] == f.shape[0] == m.shape[0] == M):
        raise ValueError(f"score: the correspondences' arrays differ in "
                         f"length: {X.shape[0]}, {u.shape[0]}, {T.shape[0]}, "
                         f"{f.shape[0]}, {m.shape[0]}")
    counts = torch.empty(K, dtype=torch.int64, device=dev)
    best = torch.empty(1, dtype=torch.int64, device=dev)
    pose = torch.empty(4, 4, dtype=f32, device=dev)
    n = torch.empty(1, dtype=torch.int32, device=dev)
    inl = torch.empty(M, dtype=torch.bool, device=dev)
    # the hypotheses' inlier flags as bit rows (uint32 words in int32)
    rows = torch.empty(K, (M + 31) // 32, dtype=torch.int32, device=dev)
    lib = _build.library()
    _build.count("ransac_score")
    _build.check(lib.mc_ransac_score(
        hyp.data_ptr(), X.data_ptr(), u.data_ptr(), T.data_ptr(),
        f.data_ptr(), m.data_ptr(), counts.data_ptr(), best.data_ptr(),
        pose.data_ptr(), n.data_ptr(), inl.data_ptr(), rows.data_ptr(),
        counters(dev, K).data_ptr(), K, M, float(px_thresh) ** 2,
        _build.stream_ptr(dev)), "mc_ransac_score")
    return counts, best, pose, n[0], inl


def counters(dev: torch.device, K: int) -> torch.Tensor:
    """ransac_score's K count accumulators and its arrival counter on
    `dev` (graphs.counters, K + 1 ints, one set per K: zero between
    launches)."""
    return graphs.counters("ransac_score", K + 1, dev)


def _idx(idx, S, name, dev):
    if (idx.dim() != 2 or idx.shape[1] != S or idx.dtype != torch.int64
            or idx.device != dev):
        raise ValueError(f"{name}: idx must be int64 (K, {S}) on {dev}, got "
                         f"{idx.dtype} {tuple(idx.shape)} on {idx.device}")
    return idx.contiguous()


def kabsch_hyp(idx, X_rig, X_world) -> torch.Tensor:
    """idx (K, 3) int64 sample indices into X_rig, X_world (M, 3) float32
    -> (K, 4, 4) world_T_ref hypotheses. CUDA tensors launch kabsch_hyp
    (one thread per hypothesis); CPU tensors take
    ransac.kabsch_hypotheses."""
    if _device(idx, "kabsch_hyp") == "cpu":
        from mcslam_tpu_torch.frontend import ransac

        return ransac.kabsch_hypotheses(idx, X_rig, X_world)
    dev = idx.device
    i = _idx(idx, 3, "kabsch_hyp", dev)
    src, dst = _inputs("kabsch_hyp", dev,
                       X_rig=(X_rig, torch.float32, (3,)),
                       X_world=(X_world, torch.float32, (3,)))
    if src.shape[0] != dst.shape[0] or src.shape[0] < 1:
        raise ValueError(f"kabsch_hyp: X_rig {tuple(src.shape)} and X_world "
                         f"{tuple(dst.shape)} must hold the same M >= 1 points")
    K = i.shape[0]
    out = torch.empty(K, 4, 4, dtype=torch.float32, device=dev)
    lib = _build.library()
    _build.count("kabsch_hyp")
    _build.check(lib.mc_kabsch_hyp(
        i.data_ptr(), src.data_ptr(), dst.data_ptr(), out.data_ptr(), K,
        src.shape[0], _build.stream_ptr(dev)), "mc_kabsch_hyp")
    return out


PNP_MAX_SAMPLES = 10  # csrc/pnp_hyp.cu's MAX_S
PNP_MAX_COLS = 13  # csrc/pnp_hyp.cu's NMAX


def _pnp_starts(dev: torch.device) -> torch.Tensor:
    """The inverse iterations' start vectors of ransac._nullspace_vecs,
    cos(1.7 i + 0.3) then sin(2.3 i + 1.1) for i < 13, computed on `dev`
    by the same torch calls (a const, made at the first call)."""
    def make():
        ar = torch.arange(PNP_MAX_COLS, dtype=torch.float32, device=dev)
        return torch.cat([torch.cos(ar * 1.7 + 0.3),
                          torch.sin(ar * 2.3 + 1.1)])

    return graphs.const(("pnp_starts",), dev, make)


def pnp_hyp(idx, X_world, uv, obs_cam_T_ref, obs_fxycxy) -> torch.Tensor:
    """idx (K, S) int64 sample indices, 6 <= S <= 10, into X_world (M,
    3), uv (M, 2), obs_cam_T_ref (M, 4, 4), obs_fxycxy (M, 4) float32 ->
    (K, 4, 4) world_T_ref hypotheses: the first K // 2 central DLTs, the
    rest generalized DLTs where any |t_cr| > 1e-6, else central. CUDA
    tensors launch pnp_hyp (one warp per hypothesis, the lever flag read
    on the card); CPU tensors take ransac.pnp_hypotheses."""
    if _device(idx, "pnp_hyp") == "cpu":
        from mcslam_tpu_torch.frontend import ransac

        return ransac.pnp_hypotheses(idx, X_world, uv, obs_cam_T_ref,
                                     obs_fxycxy)
    dev = idx.device
    S = idx.shape[-1]
    if not 6 <= S <= PNP_MAX_SAMPLES:
        raise ValueError(f"pnp_hyp: the kernel takes 6-{PNP_MAX_SAMPLES} "
                         f"samples a hypothesis, got {S}")
    i = _idx(idx, S, "pnp_hyp", dev)
    f32 = torch.float32
    X, u, T, f = _inputs("pnp_hyp", dev, X_world=(X_world, f32, (3,)),
                         uv=(uv, f32, (2,)),
                         obs_cam_T_ref=(obs_cam_T_ref, f32, (4, 4)),
                         obs_fxycxy=(obs_fxycxy, f32, (4,)))
    M = X.shape[0]
    if not (u.shape[0] == T.shape[0] == f.shape[0] == M) or M < 1:
        raise ValueError(f"pnp_hyp: the correspondences' arrays must hold "
                         f"the same M >= 1 rows: {M}, {u.shape[0]}, "
                         f"{T.shape[0]}, {f.shape[0]}")
    K = i.shape[0]
    out = torch.empty(K, 4, 4, dtype=f32, device=dev)
    lib = _build.library()
    _build.count("pnp_hyp")
    _build.check(lib.mc_pnp_hyp(
        i.data_ptr(), X.data_ptr(), u.data_ptr(), T.data_ptr(), f.data_ptr(),
        _pnp_starts(dev).data_ptr(), out.data_ptr(), K, S, M,
        _build.stream_ptr(dev)), "mc_pnp_hyp")
    return out
