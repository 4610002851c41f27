"""Vectorized RANSAC: fixed batches of minimal-solver hypotheses
(counterpart of mcslam_tpu/frontend/ransac.py): Kabsch and PnP scored by
generalized reprojection, and the 8-point essential of the monocular
bootstrap scored by the Sampson distance. Sampling draws from an explicit
torch.Generator; the solvers and the scoring are the JAX package's, and
each RANSAC takes its sample indices as `idx` instead."""

from __future__ import annotations

from typing import NamedTuple

import math

import torch

from mcslam_tpu_torch.geometry import alignment, lie, linalg3


class RansacResult(NamedTuple):
    world_T_ref: torch.Tensor  # (4, 4) best rig pose hypothesis
    inliers: torch.Tensor  # (M,) bool
    num_inliers: torch.Tensor  # () int32
    ok: torch.Tensor  # () bool


def _sample_idx(gen: torch.Generator, num_hyp: int, sample_size: int,
                m: int, weights: torch.Tensor) -> torch.Tensor:
    """(K, S) int64 correspondence indices drawn with replacement, with
    probability ~ max(weights, 1e-9) (jax.random.categorical over
    log-weights)."""
    p = torch.clamp(weights.to(torch.float32), min=1e-9)
    idx = torch.multinomial(p, num_hyp * sample_size, replacement=True,
                            generator=gen)
    return idx.reshape(num_hyp, sample_size)


def _nullspace_vecs(A: torch.Tensor, second: bool = False, iters: int = 5):
    """Smallest (and optionally second-smallest, deflated) right-singular
    vector of batched A (K, R, N) by inverse iteration on the shifted
    normal matrix A^T A + eps I (one batched Cholesky)."""
    G = A.transpose(-1, -2) @ A
    N = G.shape[-1]
    tr = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)
    eps = tr / N * 1e-7 + 1e-12
    eye = torch.eye(N, dtype=G.dtype, device=G.device)
    L, info = torch.linalg.cholesky_ex(G + eps[:, None, None] * eye)
    L = torch.where((info == 0)[:, None, None], L,
                    torch.full_like(L, float("nan")))

    def solve(v):
        y = torch.linalg.solve_triangular(L, v[..., None], upper=False)
        return torch.linalg.solve_triangular(
            L.transpose(-1, -2), y, upper=True)[..., 0]

    def normalize(v):
        return v * torch.rsqrt(
            torch.clamp(torch.sum(v * v, dim=-1, keepdim=True), min=1e-30))

    ar = torch.arange(N, dtype=G.dtype, device=G.device)
    v = torch.cos(ar * 1.7 + 0.3).expand(G.shape[0], N)
    for _ in range(iters):
        v = normalize(solve(v))
    if not second:
        return v
    w = torch.sin(ar * 2.3 + 1.1).expand(G.shape[0], N)
    for _ in range(iters):
        w = solve(w)
        w = w - torch.sum(w * v, dim=-1, keepdim=True) * v
        w = normalize(w)
    return v, w


def _project_so3(Rraw: torch.Tensor) -> torch.Tensor:
    """Nearest rotation by scaled Newton-Schulz polar iteration, after a
    sign flip that makes det > 0."""
    det = linalg3.det3(Rraw)
    X = Rraw * torch.where(det < 0, -1.0, 1.0)[..., None, None]
    fro = torch.sqrt(torch.clamp(torch.sum(X * X, dim=(-2, -1)), min=1e-30))
    X = X * (math.sqrt(3.0) / fro)[..., None, None]
    eye = torch.eye(3, dtype=Rraw.dtype, device=Rraw.device)
    for _ in range(6):
        X = 0.5 * X @ (3.0 * eye - X.transpose(-1, -2) @ X)
    return X


def _score_reprojection(world_T_ref_h, X_world, uv, cam_T_ref, fxycxy, mask,
                        px_thresh: float):
    """world_T_ref_h (K, 4, 4) -> (inlier counts (K,), masks (K, M)); each
    correspondence is projected into its own rig camera."""
    ref_T_world = lie.se3_inverse(world_T_ref_h)
    p_ref = lie.se3_apply(ref_T_world[:, None], X_world[None])
    p_cam = lie.se3_apply(cam_T_ref[None], p_ref)
    z = p_cam[..., 2]
    good_z = z > 0.05
    zs = torch.where(good_z, z, torch.ones_like(z))
    pred = p_cam[..., :2] / zs[..., None] * fxycxy[None, ..., :2] \
        + fxycxy[None, ..., 2:]
    err2 = torch.sum((pred - uv[None]) ** 2, dim=-1)
    inl = good_z & (err2 < px_thresh**2) & mask[None]
    return torch.sum(inl, dim=-1), inl


def _best(hyp, counts, inl, min_inliers):
    best = torch.argmax(counts)
    n = counts[best]
    return RansacResult(world_T_ref=hyp[best], inliers=inl[best],
                        num_inliers=n.to(torch.int32), ok=n >= min_inliers)


def kabsch_hypotheses(idx, X_rig, X_world) -> torch.Tensor:
    """(K, 3) sample indices -> (K, 4, 4) world_T_ref hypotheses."""
    R, t = alignment.kabsch_quat(X_rig[idx], X_world[idx])
    return lie.se3_matrix(R, t)


def ransac_kabsch(gen, X_rig, X_world, uv, cam_T_ref, fxycxy, mask,
                  num_hyp: int = 512, px_thresh: float = 5.0,
                  min_inliers: int = 10, idx=None) -> RansacResult:
    """3-point 3D-3D hypotheses aligning rig points to landmarks, scored
    by generalized reprojection. `idx` (K, 3) overrides the sampling."""
    if idx is None:
        idx = _sample_idx(gen, num_hyp, 3, X_rig.shape[0], mask.float())
    hyp = kabsch_hypotheses(idx, X_rig, X_world)
    counts, inl = _score_reprojection(hyp, X_world, uv, cam_T_ref, fxycxy,
                                      mask, px_thresh)
    return _best(hyp, counts, inl, min_inliers)


def _dlt_gpnp(Xw, rays, Tcr) -> torch.Tensor:
    """Generalized (non-central) linear absolute pose from S >= 6
    correspondences: Xw (K, S, 3), rays (K, S, 3) in each observing
    camera, Tcr (K, S, 4, 4) cam_T_ref -> ref_T_world (K, 4, 4)."""
    K_, S = Xw.shape[:2]
    R_cr = Tcr[..., :3, :3]
    t_cr = Tcr[..., :3, 3]
    dx = lie.so3_hat(rays)
    B = dx @ R_cr
    A_R = (B[..., :, :, None] * Xw[..., None, None, :]).reshape(K_, S, 3, 9)
    b = (dx @ t_cr[..., None])
    M_full = torch.cat([A_R, B, b], dim=-1).reshape(K_, S * 3, 13)
    v_a, v_b = _nullspace_vecs(M_full, second=True)
    use_a = torch.linalg.vector_norm(v_a[..., :12], dim=-1) > 0.3
    v = torch.where(use_a[:, None], v_a, v_b)
    hom = v[..., 12]
    tiny = torch.where(hom < 0, -1e-8, 1e-8).to(hom.dtype)
    theta = v[..., :12] / torch.where(torch.abs(hom) > 1e-8, hom,
                                      tiny)[..., None]
    Rraw = theta[..., :9].reshape(K_, 3, 3)
    t = theta[..., 9:12]
    R = _project_so3(Rraw)
    s = torch.clamp(torch.sqrt(torch.sum(Rraw * Rraw, dim=(-2, -1)) / 3.0),
                    min=1e-9)
    return lie.se3_matrix(R, t / s[:, None])


def _dlt_pnp(Xw, xn) -> torch.Tensor:
    """Central linear PnP from S >= 6 correspondences: Xw (K, S, 3), xn
    (K, S, 2) normalized coords -> cam_T_world (K, 4, 4)."""
    K_, S = Xw.shape[:2]
    zeros = torch.zeros(K_, S, 4, dtype=Xw.dtype, device=Xw.device)
    Xh = torch.cat([Xw, torch.ones_like(Xw[..., :1])], dim=-1)
    u = xn[..., 0:1]
    v = xn[..., 1:2]
    row1 = torch.cat([Xh, zeros, -u * Xh], dim=-1)
    row2 = torch.cat([zeros, Xh, -v * Xh], dim=-1)
    A = torch.cat([row1, row2], dim=-2)
    p = _nullspace_vecs(A).reshape(K_, 3, 4)
    scale = torch.linalg.vector_norm(p[:, 2, :3], dim=-1, keepdim=True)
    p = p / torch.clamp(scale, min=1e-12)[..., None]
    zmean = (Xh @ p[:, 2, :, None])[..., 0].mean(dim=-1)
    p = p * torch.where(zmean < 0, -1.0, 1.0).to(p.dtype)[:, None, None]
    R = _project_so3(p[:, :, :3])
    return lie.se3_matrix(R, p[:, :, 3])


def pnp_hypotheses(idx, X_world, uv, obs_cam_T_ref, obs_fxycxy):
    """(K, S) sample indices -> (K, 4, 4) world_T_ref hypotheses: the
    first half central DLT in the reference camera, the second half the
    generalized DLT (central DLT again for a rig without lever arms)."""
    num_hyp = idx.shape[0]
    Xs = X_world[idx]
    f = obs_fxycxy[idx]
    xn_cam = (uv[idx] - f[..., 2:]) / f[..., :2]
    rays = torch.cat([xn_cam, torch.ones_like(xn_cam[..., :1])], dim=-1)
    Tcr = obs_cam_T_ref[idx]
    R_ref_cam = Tcr[..., :3, :3].transpose(-1, -2)
    rays_ref = (R_ref_cam @ rays[..., None])[..., 0]
    xn_ref = rays_ref[..., :2] / torch.clamp(rays_ref[..., 2:], min=1e-6)
    kc = num_hyp // 2
    ref_T_world_c = _dlt_pnp(Xs[:kc], xn_ref[:kc])
    lever = torch.amax(
        torch.linalg.vector_norm(obs_cam_T_ref[..., :3, 3], dim=-1))
    noncentral = lever > 1e-6
    ref_T_world_g = torch.where(
        noncentral, _dlt_gpnp(Xs[kc:], rays[kc:], Tcr[kc:]),
        _dlt_pnp(Xs[kc:], xn_ref[kc:]),
    )
    return lie.se3_inverse(torch.cat([ref_T_world_c, ref_T_world_g], dim=0))


def ransac_pnp(gen, X_world, uv, obs_cam_T_ref, obs_fxycxy, mask,
               num_hyp: int = 256, sample_size: int = 6,
               px_thresh: float = 5.0, min_inliers: int = 10,
               idx=None) -> RansacResult:
    """2D-3D absolute pose from a half-central / half-generalized DLT
    portfolio, scored generalized over the rig. `idx` (K, S) overrides
    the sampling."""
    if idx is None:
        idx = _sample_idx(gen, num_hyp, sample_size, X_world.shape[0],
                          mask.float())
    hyp = pnp_hypotheses(idx, X_world, uv, obs_cam_T_ref, obs_fxycxy)
    counts, inl = _score_reprojection(hyp, X_world, uv, obs_cam_T_ref,
                                      obs_fxycxy, mask, px_thresh)
    return _best(hyp, counts, inl, min_inliers)


class EssentialResult(NamedTuple):
    E: torch.Tensor  # (3, 3)
    rel_T: torch.Tensor  # (4, 4) cam1_T_cam0 with unit translation
    inliers: torch.Tensor  # (M,)
    num_inliers: torch.Tensor
    ok: torch.Tensor


def _eight_point(xn0: torch.Tensor, xn1: torch.Tensor) -> torch.Tensor:
    """Batched 8-point essential: (K, 8, 2) x2 -> (K, 3, 3) with singular
    values projected to (1, 1, 0). The nullspace takes 6 inverse
    iterations (the mono bootstrap is gated directly by E)."""
    x0, y0 = xn0[..., 0], xn0[..., 1]
    x1, y1 = xn1[..., 0], xn1[..., 1]
    ones = torch.ones_like(x0)
    # epipolar constraint x1^T E x0 = 0
    A = torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0,
                     ones], dim=-1)  # (K, 8, 9)
    E = _nullspace_vecs(A, iters=6).reshape(-1, 3, 3)
    # a sample whose normal matrix fails its Cholesky gives NaN (which
    # scores no inlier, as in the JAX package); the SVD refuses NaN
    bad = ~torch.isfinite(E).all(dim=(-2, -1))[:, None, None]
    U, S, Vt = torch.linalg.svd(torch.where(bad, torch.zeros_like(E), E))
    S2 = torch.stack([torch.ones_like(S[..., 0]), torch.ones_like(S[..., 0]),
                      torch.zeros_like(S[..., 0])], dim=-1)
    return torch.where(bad, E, U @ (S2[..., :, None] * Vt))


def _decompose_E(E: torch.Tensor, xn0: torch.Tensor, xn1: torch.Tensor,
                 mask) -> torch.Tensor:
    """Pick the (R, t) of the 4 decompositions with the most points in
    front of both cameras (midpoint triangulation). E: (3, 3); xn: (M, 2).
    Returns cam1_T_cam0 (4, 4), |t| = 1. Invariant to the signs of the
    SVD's singular vectors."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.where(linalg3.det3(U) < 0, -1.0, 1.0)
    Vt = Vt * torch.where(linalg3.det3(Vt) < 0, -1.0, 1.0)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    cands = lie.se3_matrix(torch.stack([R1, R1, R2, R2]),
                           torch.stack([t, -t, t, -t]))  # (4, 4, 4)

    # midpoint triangulation cheirality for all matches, per candidate
    d0 = torch.cat([xn0, torch.ones_like(xn0[..., :1])], dim=-1)
    d0 = d0 / torch.linalg.vector_norm(d0, dim=-1, keepdim=True)
    T01 = lie.se3_inverse(cands)
    o1 = T01[:, :3, 3]  # (4, 3); o0 = 0
    d1c = torch.cat([xn1, torch.ones_like(xn1[..., :1])], dim=-1)
    d1 = torch.einsum("cij,mj->cmi", T01[:, :3, :3], d1c)
    d1 = d1 / torch.linalg.vector_norm(d1, dim=-1, keepdim=True)
    b = o1[:, None, :]
    d0d1 = torch.sum(d0[None] * d1, dim=-1)
    denom = torch.clamp(1.0 - d0d1 ** 2, min=1e-9)
    bd0 = torch.sum(b * d0[None], dim=-1)
    bd1 = torch.sum(b * d1, dim=-1)
    s = (bd0 - d0d1 * bd1) / denom
    u = (d0d1 * bd0 - bd1) / denom
    X = s[..., None] * d0[None]  # (4, M, 3)
    z1 = lie.se3_apply(cands[:, None], X)[..., 2]
    scores = torch.sum((X[..., 2] > 0) & (z1 > 0) & (s > 0) & (u > 0)
                       & mask[None], dim=-1)
    return cands[torch.argmax(scores)]


def essential_hypotheses(idx, xn0, xn1) -> torch.Tensor:
    """(K, 8) sample indices -> (K, 3, 3) essential hypotheses."""
    return _eight_point(xn0[idx], xn1[idx])


def ransac_essential(gen, xn0, xn1, mask, num_hyp: int = 512,
                     thresh_n: float = 2.0 / 400.0, min_inliers: int = 30,
                     idx=None) -> EssentialResult:
    """Monocular relative-pose bootstrap: 8-point hypotheses on normalized
    coordinates (M, 2) of frames 0 and 1, scored by the Sampson distance.
    `idx` (K, 8) overrides the sampling."""
    if idx is None:
        idx = _sample_idx(gen, num_hyp, 8, xn0.shape[0], mask.float())
    E = essential_hypotheses(idx, xn0, xn1)  # (K, 3, 3)
    h0 = torch.cat([xn0, torch.ones_like(xn0[..., :1])], dim=-1)  # (M, 3)
    h1 = torch.cat([xn1, torch.ones_like(xn1[..., :1])], dim=-1)
    Ex0 = torch.einsum("kij,mj->kmi", E, h0)  # (K, M, 3)
    Eth1 = torch.einsum("kji,mj->kmi", E, h1)
    num = torch.einsum("mi,kmi->km", h1, Ex0) ** 2
    den = Ex0[..., 0] ** 2 + Ex0[..., 1] ** 2 + Eth1[..., 0] ** 2 \
        + Eth1[..., 1] ** 2
    d2 = num / torch.clamp(den, min=1e-12)
    inl = (d2 < thresh_n ** 2) & mask[None]
    counts = torch.sum(inl, dim=-1)
    best = torch.argmax(counts)
    n = counts[best]
    return EssentialResult(E=E[best], rel_T=_decompose_E(E[best], xn0, xn1,
                                                         inl[best]),
                           inliers=inl[best], num_inliers=n.to(torch.int32),
                           ok=n >= min_inliers)
