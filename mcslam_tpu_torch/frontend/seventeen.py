"""Non-central (generalized-camera) relative pose from 2D-2D ray
correspondences across a rigid multi-camera rig (counterpart of
mcslam_tpu/frontend/seventeen.py, function for function).

The rig's lever arm pins the metric scale of the relative translation, so
a rig can bootstrap on distant scenery where intra-rig parallax is too
thin to triangulate. Hypotheses are a fixed-shape portfolio: thirds of
central 8-point essentials on rig-frame bearings, bearing Procrustes with
a linear translation, and linear 17-point null vectors of the generalized
epipolar constraint; each is expanded over a log grid of |t| and scored
with a truncated (MSAC) midpoint-triangulation angular cost. The winner
is polished by a damped Gauss-Newton on the geometric residuals (Jacobian
by torch.func.jacfwd) and rescanned in scale, twice, each step adopted
only when the MSAC cost does not rise. Sampling draws from an explicit
torch.Generator; `ransac_seventeen(idx=...)` takes the sample indices
instead.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from mcslam_tpu_torch.geometry import lie, linalg3


class SeventeenResult(NamedTuple):
    rel_T: torch.Tensor  # (4, 4) frame1_T_frame2, metric translation
    inliers: torch.Tensor  # (M,) bool
    num_inliers: torch.Tensor  # () int32
    ok: torch.Tensor  # () bool


def plucker_rays(uv, anchor_cam, rig):
    """Undistorted anchor observations -> rays in the rig ref frame.

    uv: (M, 2) undistorted pixels; anchor_cam: (M,) int.
    Returns (f (M, 3) unit directions, o (M, 3) camera centers)."""
    cam = anchor_cam.long()
    fx = rig.fxycxy[cam]
    xn = (uv - fx[:, 2:]) / fx[:, :2]
    d_cam = torch.cat([xn, torch.ones_like(xn[:, :1])], dim=-1)
    d_cam = d_cam / torch.linalg.vector_norm(d_cam, dim=-1, keepdim=True)
    ref_T_cam = lie.se3_inverse(rig.cam_T_ref)[cam]  # (M, 4, 4)
    f = torch.einsum("mij,mj->mi", ref_T_cam[:, :3, :3], d_cam)
    return f, ref_T_cam[:, :3, 3]


def rig_lever(rig) -> float:
    """The largest camera-center distance from the rig's reference frame."""
    centers = lie.se3_inverse(rig.cam_T_ref)[:, :3, 3].cpu().numpy()
    return float(np.linalg.norm(centers, axis=-1).max())


def is_noncentral(rig, eps: float = 1e-6) -> bool:
    """Metric scale needs a genuine lever arm; callers must gate on this."""
    return rig_lever(rig) > eps


# -- hypothesis families -----------------------------------------------------


def _eye(x: torch.Tensor, n: int = 3) -> torch.Tensor:
    return torch.eye(n, dtype=x.dtype, device=x.device)


def _project_so3(Rraw):
    """(..., 3, 3) -> nearest rotations (sign-fixed) + mean scale."""
    U, sv, Vt = torch.linalg.svd(Rraw)
    det = linalg3.det3(U @ Vt)
    D = torch.ones(Rraw.shape[:-2] + (3,), dtype=Rraw.dtype,
                   device=Rraw.device)
    D[..., 2] = torch.sign(det) + (det == 0).to(Rraw.dtype)
    R = U @ (D[..., :, None] * Vt)
    return R, torch.clamp(sv.mean(dim=-1), min=1e-9)


def _gec_rows(f1, o1, f2, o2):
    """(..., 3) dirs/centers -> (..., 18) linear-GEC rows [vec(E); vec(R)]."""
    m1 = torch.linalg.cross(o1, f1)
    m2 = torch.linalg.cross(o2, f2)
    kE = (f1[..., :, None] * f2[..., None, :]).reshape(f1.shape[:-1] + (9,))
    kR = (f1[..., :, None] * m2[..., None, :]
          + m1[..., :, None] * f2[..., None, :]).reshape(f1.shape[:-1] + (9,))
    return torch.cat([kE, kR], dim=-1)


def _pick_null_combination(vecs, n_grid: int = 64):
    """Search combinations of the two smallest eigenvectors for the most
    rotation-like R block (the axial-rig spurious null vector mixes into
    the eigenbasis; R^T R isotropy disambiguates)."""
    v0 = vecs[..., :, 0]
    v1 = vecs[..., :, 1]
    theta = torch.arange(n_grid, dtype=vecs.dtype, device=vecs.device) \
        * (math.pi / n_grid)
    x = (torch.cos(theta)[None, :, None] * v0[:, None, :]
         + torch.sin(theta)[None, :, None] * v1[:, None, :])  # (K, G, 18)
    Rr = x[..., 9:].reshape(x.shape[:-1] + (3, 3))
    M = Rr.transpose(-1, -2) @ Rr
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1) / 3.0
    dev = M - tr[..., None, None] * _eye(M)
    obj = torch.sum(dev * dev, dim=(-2, -1)) / torch.clamp(tr, min=1e-12) ** 2
    g = torch.argmin(obj, dim=-1)
    return x[torch.arange(x.shape[0], device=x.device), g]


def _extract_pose(x):
    """(K, 18) null vectors -> (R (K,3,3), t (K,3)) with metric scale."""
    E = x[..., :9].reshape(-1, 3, 3)
    Rr = x[..., 9:].reshape(-1, 3, 3)
    s = torch.sign(linalg3.det3(Rr))
    s = torch.where(s == 0, torch.ones_like(s), s)[:, None, None]
    E = E * s
    Rr = Rr * s
    R, lam = _project_so3(Rr)
    A = (E / lam[:, None, None]) @ R.transpose(-1, -2)
    S = (A - A.transpose(-1, -2)) * 0.5
    t = torch.stack([S[:, 2, 1], S[:, 0, 2], S[:, 1, 0]], dim=-1)
    return R, t


def _linear_t(R, f1, o1, f2, o2, w):
    """Given R, the GEC is LINEAR in t: rows (R f2 x f1) . t = -(f1^T R m2
    + m1^T R f2). Weighted 3x3 normal-equation solve."""
    m1 = torch.linalg.cross(o1, f1)
    m2 = torch.linalg.cross(o2, f2)
    Rf2 = torch.einsum("kij,ksj->ksi", R, f2)
    Rm2 = torch.einsum("kij,ksj->ksi", R, m2)
    c = torch.linalg.cross(Rf2, f1)  # (K,S,3)
    rhs = -(torch.sum(f1 * Rm2, dim=-1) + torch.sum(m1 * Rf2, dim=-1))
    H = torch.einsum("ksi,ksj,ks->kij", c, c, w) + 1e-9 * _eye(c)
    g = torch.einsum("ksi,ks->ki", c * rhs[..., None], w)
    return torch.linalg.solve_ex(H, g[..., None])[0][..., 0]


def _procrustes_seed(f1, f2, o1, o2, w):
    """R from bearing Procrustes (f1 ~ R f2; exact for distant scenes),
    then the linear-t solve. (K,S,3) rays -> (R, t)."""
    C = torch.einsum("ksi,ksj,ks->kij", f1, f2, w)
    R, _ = _project_so3(C)
    return R, _linear_t(R, f1, o1, f2, o2, w)


def _eight_point_bearings(f1s, f2s, w):
    """Central essential from unit bearings: f1^T E f2 = 0. (K,S,3) x2 ->
    E (K,3,3) projected to the essential manifold."""
    K_, S = f1s.shape[:2]
    A = (f1s[..., :, None] * f2s[..., None, :]).reshape(K_, S, 9)
    G = torch.einsum("ksi,ksj,ks->kij", A, A, w)
    _, vecs = torch.linalg.eigh(G)
    E = vecs[..., :, 0].reshape(-1, 3, 3)
    U, S_, Vt = torch.linalg.svd(E)
    S2 = torch.stack([torch.ones_like(S_[..., 0]), torch.ones_like(S_[..., 0]),
                      torch.zeros_like(S_[..., 0])], dim=-1)
    return U @ (S2[..., :, None] * Vt)


def _decompose_E_batch(E, f1, o1, f2, o2, mask):
    """(K,3,3) essentials -> (R (K,3,3), unit t (K,3)) picking the
    decomposition with most points passing midpoint cheirality."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.where(linalg3.det3(U) < 0, -1.0, 1.0)[:, None, None]
    Vt = Vt * torch.where(linalg3.det3(Vt) < 0, -1.0, 1.0)[:, None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    tu = U[:, :, 2]
    Rs = torch.stack([R1, R1, R2, R2], dim=1)  # (K,4,3,3)
    ts = torch.stack([tu, -tu, tu, -tu], dim=1)  # (K,4,3)
    K = E.shape[0]
    counts, _ = _score(Rs.reshape(K * 4, 3, 3), ts.reshape(K * 4, 3), f1, o1,
                       f2, o2, mask, 1e9)  # cheirality only
    pick = torch.argmax(counts.reshape(K, 4), dim=1)
    ar = torch.arange(K, device=E.device)
    return Rs[ar, pick], ts[ar, pick]


# -- geometric scoring + refinement ------------------------------------------


def _midpoint_errors(R, t, f1, o1, f2, o2):
    """(K,) hypotheses x (M,) rays -> (err (K, M), front (K, M)): the two
    rays' angular errors to their midpoint (1 - cos each, summed) and
    whether both midpoint depths are positive."""
    f2w = torch.einsum("kij,mj->kmi", R, f2)
    o2w = torch.einsum("kij,mj->kmi", R, o2) + t[:, None, :]
    d0 = f1[None].expand(f2w.shape)
    o0 = o1[None].expand(o2w.shape)
    b = o2w - o0
    dd = torch.sum(d0 * f2w, dim=-1)
    denom = torch.clamp(1.0 - dd * dd, min=1e-9)
    bd0 = torch.sum(b * d0, dim=-1)
    bd1 = torch.sum(b * f2w, dim=-1)
    s = (bd0 - dd * bd1) / denom
    u = (dd * bd0 - bd1) / denom
    X = 0.5 * (o0 + s[..., None] * d0 + o2w + u[..., None] * f2w)
    v1 = X - o0
    v2 = X - o2w
    n1 = torch.sqrt(torch.sum(v1 * v1, dim=-1) + 1e-12)
    n2 = torch.sqrt(torch.sum(v2 * v2, dim=-1) + 1e-12)
    c1 = torch.sum(v1 * d0, dim=-1) / n1
    c2 = torch.sum(v2 * f2w, dim=-1) / n2
    return (1.0 - c1) + (1.0 - c2), (s > 0) & (u > 0)


def _score(R, t, f1, o1, f2, o2, mask, thresh):
    """Midpoint-triangulation angular error, both rays (OpenGV semantics:
    inlier iff (1-cos th1) + (1-cos th2) < thresh, plus cheirality).
    Returns (counts (K,), inliers (K, M))."""
    err, front = _midpoint_errors(R, t, f1, o1, f2, o2)
    err = torch.where(front & mask[None], err, torch.full_like(err, math.inf))
    inl = err < thresh
    return torch.sum(inl, dim=-1), inl


def _score_msac(R, t, f1, o1, f2, o2, mask, thresh):
    """As _score, plus the truncated cost sum(min(err, thresh)) (K,); a
    ray behind a camera or masked costs 10 * thresh."""
    err, front = _midpoint_errors(R, t, f1, o1, f2, o2)
    err = torch.where(front & mask[None], err,
                      torch.full_like(err, 10.0 * thresh))
    inl = err < thresh
    msac = torch.sum(torch.clamp(err, max=thresh), dim=-1)
    return torch.sum(inl, dim=-1), inl, msac


def _geo_residuals(d, R0, t0, f1, o1, f2, o2, w):
    """(6,) tangent delta -> weighted (M*6,) midpoint angular residual
    vector (cross products with the triangulated directions)."""
    R = R0 @ lie.so3_exp(d[:3])
    t = t0 + d[3:]
    f2w = f2 @ R.T
    o2w = o2 @ R.T + t[None]
    b = o2w - o1
    dd = torch.sum(f1 * f2w, dim=-1)
    den = torch.clamp(1.0 - dd * dd, min=1e-9)
    bd0 = torch.sum(b * f1, dim=-1)
    bd1 = torch.sum(b * f2w, dim=-1)
    s = (bd0 - dd * bd1) / den
    u = (dd * bd0 - bd1) / den
    X = 0.5 * (o1 + s[:, None] * f1 + o2w + u[:, None] * f2w)
    v1 = X - o1
    v2 = X - o2w
    n1 = torch.sqrt(torch.sum(v1 * v1, dim=-1) + 1e-8)
    n2 = torch.sqrt(torch.sum(v2 * v2, dim=-1) + 1e-8)
    r1 = torch.linalg.cross(f1, v1 / n1[:, None])
    r2 = torch.linalg.cross(f2w, v2 / n2[:, None])
    return (torch.cat([r1, r2], dim=-1) * w[:, None]).reshape(-1)


def _geo_lm(R, t, f1, o1, f2, o2, w, iters: int):
    """Damped GN on the geometric residuals (single pose), Jacobian by
    torch.func.jacfwd (taken in float64), Jacobi-scaled solve, cost-gated
    steps with a lambda ladder."""
    jac_fn = torch.func.jacfwd(_geo_residuals)

    def jac(*args):
        # in float64: under jacfwd, torch gives the tangents of float32
        # ops with a Python scalar (so3_exp's t2 / 6.0) as float64, and a
        # float32 matmul with them then fails
        return jac_fn(*(a.double() for a in args)).to(R.dtype)

    zero = torch.zeros(6, dtype=R.dtype, device=R.device)
    eye6 = _eye(R, 6)
    lam = torch.full((), 1e-4, dtype=R.dtype, device=R.device)
    r = _geo_residuals(zero, R, t, f1, o1, f2, o2, w)
    cost = torch.sum(r * r)
    for _ in range(iters):
        r = _geo_residuals(zero, R, t, f1, o1, f2, o2, w)
        J = jac(zero, R, t, f1, o1, f2, o2, w)
        H = J.T @ J
        g = J.T @ r
        sc = 1.0 / torch.sqrt(torch.diagonal(H) + 1e-12)
        Hs = H * sc[:, None] * sc[None, :] + lam * eye6
        d = sc * (-torch.linalg.solve_ex(Hs, (g * sc)[:, None])[0][:, 0])
        R_t = R @ lie.so3_exp(d[:3])
        t_t = t + d[3:]
        c_t = torch.sum(_geo_residuals(zero, R_t, t_t, f1, o1, f2, o2, w) ** 2)
        adopt = c_t < cost
        R = torch.where(adopt, R_t, R)
        t = torch.where(adopt, t_t, t)
        cost = torch.where(adopt, c_t, cost)
        lam = torch.clamp(torch.where(adopt, lam * 0.3, lam * 10.0), 1e-7, 1e3)
    return R, t


# -- RANSAC ------------------------------------------------------------------


def seventeen_hypotheses(idx, f1, o1, f2, o2, mask):
    """(K, S) sample indices -> the portfolio (R (K, 3, 3), t (K, 3)):
    thirds of central essential (unit t), Procrustes + linear t, and
    linear 17-point null vectors (metric t)."""
    sf1, so1 = f1[idx], o1[idx]  # (K,S,3)
    sf2, so2 = f2[idx], o2[idx]
    sw = mask[idx].to(f1.dtype)
    k3 = idx.shape[0] // 3
    E8 = _eight_point_bearings(sf1[:k3], sf2[:k3], sw[:k3])
    R_e, td_e = _decompose_E_batch(E8, f1, o1, f2, o2, mask)
    R_p, t_p = _procrustes_seed(sf1[k3:2 * k3], sf2[k3:2 * k3],
                                so1[k3:2 * k3], so2[k3:2 * k3],
                                sw[k3:2 * k3])
    rows = _gec_rows(sf1[2 * k3:], so1[2 * k3:], sf2[2 * k3:], so2[2 * k3:])
    G = torch.einsum("ksi,ksj,ks->kij", rows, rows, sw[2 * k3:])
    _, vecs = torch.linalg.eigh(G)
    R_l, t_l = _extract_pose(_pick_null_combination(vecs))
    return (torch.cat([R_e, R_p, R_l], dim=0),
            torch.cat([td_e, t_p, t_l], dim=0))


def ransac_seventeen(gen, f1, o1, f2, o2, mask, num_hyp: int = 96,
                     sample_size: int = 20, angle_thresh: float = 3e-5,
                     min_inliers: int = 30, num_scales: int = 16,
                     scale_lo: float = 0.02, scale_hi: float = 10.0,
                     refine_iters: int = 8, idx=None) -> SeventeenResult:
    """Batched-hypothesis non-central relative-pose RANSAC over rays (f, o)
    of two frames in the rig ref frame (M, 3) each and a validity mask
    (M,). Returns frame1_T_frame2 with metric translation; the |t| grid is
    in the units of the ray origins (metres). `idx` (num_hyp, sample_size)
    overrides the sampling."""
    from mcslam_tpu_torch.frontend import ransac as _ransac

    if idx is None:
        idx = _ransac._sample_idx(gen, num_hyp, sample_size, f1.shape[0],
                                  mask.to(torch.float32))
    R, t = seventeen_hypotheses(idx, f1, o1, f2, o2, mask)

    # expand every hypothesis over a log grid of |t| along its own
    # direction (+ its raw t): metric scale is the weakly observed quantity
    K = R.shape[0]
    tn = t / torch.sqrt(torch.sum(t * t, dim=-1, keepdim=True) + 1e-12)
    scales = torch.from_numpy(np.geomspace(scale_lo, scale_hi, num_scales - 1)
                              .astype(np.float32)).to(f1.device)
    t_grid = tn[:, None, :] * scales[None, :, None]  # (K,G-1,3)
    t_all = torch.cat([t[:, None, :], t_grid], dim=1).reshape(
        K * num_scales, 3)
    R_all = torch.repeat_interleave(R, num_scales, dim=0)

    _, inl, msac = _score_msac(R_all, t_all, f1, o1, f2, o2, mask,
                               angle_thresh)
    best = torch.argmin(msac)
    bR, bt = R_all[best], t_all[best]
    b_inl = inl[best]
    b_msac = msac[best]

    # two rounds of: geometric-LM polish on the winner's inliers, then a
    # scale rescan along the polished direction, each adopted only on MSAC
    # improvement
    for _ in range(2):
        Rr_, tr_ = _geo_lm(bR, bt, f1, o1, f2, o2, b_inl.to(f1.dtype),
                           iters=refine_iters)
        _, ir, mr = _score_msac(Rr_[None], tr_[None], f1, o1, f2, o2, mask,
                                angle_thresh)
        adopt = mr[0] <= b_msac
        bR = torch.where(adopt, Rr_, bR)
        bt = torch.where(adopt, tr_, bt)
        b_inl = torch.where(adopt, ir[0], b_inl)
        b_msac = torch.where(adopt, mr[0], b_msac)

        btn = bt / torch.sqrt(torch.sum(bt * bt) + 1e-12)
        t_res = torch.cat([bt[None], btn[None, :] * scales[:, None]], dim=0)
        R_res = bR[None].expand(num_scales, 3, 3)
        _, is_, ms = _score_msac(R_res, t_res, f1, o1, f2, o2, mask,
                                 angle_thresh)
        sb = torch.argmin(ms)
        adopt = ms[sb] <= b_msac
        bt = torch.where(adopt, t_res[sb], bt)
        b_inl = torch.where(adopt, is_[sb], b_inl)
        b_msac = torch.where(adopt, ms[sb], b_msac)
    b_n = torch.sum(b_inl)
    return SeventeenResult(rel_T=lie.se3_matrix(bR, bt), inliers=b_inl,
                           num_inliers=b_n.to(torch.int32),
                           ok=b_n >= min_inliers)
