"""Batched multi-view triangulation: midpoint initialization, per-point
Gauss-Newton refine and chi2/cheirality gating (counterpart of
mcslam_tpu/geometry/triangulation.py).

triangulate_and_refine, the fused form the frame build uses, is one
kernel launch on the card (geometry/triangulation_cuda.py); its plain
version computes in the JAX package's transposed component form: every
scalar component is an (R, M) tensor with the point axis minor. The
separate steps (triangulate_rays, reprojection_residuals,
refine_points_gn, chi2_gate, parallax_cosine) take (..., R, ...) tensors
as the JAX functions do.
"""

from __future__ import annotations

import torch

from mcslam_tpu_torch.geometry import lie, linalg3, triangulation_cuda
from mcslam_tpu_torch.geometry.linalg3 import safe_det


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def triangulate_rays(origins: torch.Tensor, dirs: torch.Tensor,
                     mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Least-squares midpoint of up to R rays per point: origins, dirs
    (unit) (..., R, 3) in the world frame, mask (..., R) -> (X (..., 3),
    ok (...,): >= 2 valid rays and a well-conditioned system). Minimizes
    sum_r || (I - d_r d_r^T)(X - o_r) ||^2."""
    m = mask[..., None, None].to(dirs.dtype)
    d = dirs[..., :, None]
    eye = torch.eye(3, dtype=dirs.dtype, device=dirs.device)
    P = (eye - d @ d.transpose(-1, -2)) * m  # (..., R, 3, 3)
    A = torch.sum(P, dim=-3)
    b = torch.sum(P @ origins[..., :, None], dim=-3)[..., 0]
    n_valid = torch.sum(mask, dim=-1)
    A_reg = A + 1e-6 * eye  # keeps the solve defined for empty sets
    X = linalg3.solve3(A_reg, b)
    det = linalg3.det3(A_reg)
    ok = (n_valid >= 2) & (det > 1e-9) & torch.all(torch.isfinite(X), dim=-1)
    return X, ok


def reprojection_residuals(X: torch.Tensor, world_T_cam: torch.Tensor,
                           uv: torch.Tensor,
                           fxycxy: torch.Tensor) -> torch.Tensor:
    """Pinhole reprojection residuals in pixels (uv undistorted): X
    (..., 3), world_T_cam (..., R, 4, 4), uv (..., R, 2), fxycxy
    (..., R, 4) -> (..., R, 2)."""
    p_cam = lie.se3_apply(lie.se3_inverse(world_T_cam), X[..., None, :])
    z = torch.clamp(p_cam[..., 2], min=1e-6)
    pred = p_cam[..., :2] / z[..., None] * fxycxy[..., :2] + fxycxy[..., 2:]
    return pred - uv


def refine_points_gn(X0: torch.Tensor, world_T_cam: torch.Tensor,
                     uv: torch.Tensor, fxycxy: torch.Tensor,
                     mask: torch.Tensor, iters: int = 5,
                     damping: float = 1e-3) -> torch.Tensor:
    """Batched per-point Gauss-Newton on the reprojection error with
    analytic Jacobians (dr/dX = J_proj @ R_cam_world) -> X (..., 3)."""
    cam_T_world = lie.se3_inverse(world_T_cam)  # (..., R, 4, 4)
    R_cw = cam_T_world[..., :3, :3]
    t_cw = cam_T_world[..., :3, 3]
    fx = fxycxy[..., 0]
    fy = fxycxy[..., 1]
    m = mask.to(X0.dtype)
    eye3 = torch.eye(3, dtype=X0.dtype, device=X0.device)
    zero = torch.zeros_like(fx)
    X = X0
    for _ in range(iters):
        p = _matvec(R_cw, X[..., None, :]) + t_cw  # (..., R, 3)
        inv_z = 1.0 / torch.clamp(p[..., 2], min=1e-3)
        pred = (p[..., :2] * inv_z[..., None] * fxycxy[..., :2]
                + fxycxy[..., 2:])
        r = (pred - uv) * m[..., None]
        Jp = torch.stack([
            torch.stack([fx * inv_z, zero, -fx * p[..., 0] * inv_z * inv_z],
                        -1),
            torch.stack([zero, fy * inv_z, -fy * p[..., 1] * inv_z * inv_z],
                        -1)], dim=-2)  # (..., R, 2, 3)
        J = (Jp @ R_cw) * m[..., None, None]
        H = torch.einsum("...rai,...raj->...ij", J, J) + damping * eye3
        g = torch.einsum("...rai,...ra->...i", J, r)
        X = X - linalg3.solve3(H, g)
    return X


def chi2_gate(X: torch.Tensor, world_T_cam: torch.Tensor, uv: torch.Tensor,
              fxycxy: torch.Tensor, mask: torch.Tensor,
              sigma: torch.Tensor | float = 1.0, chi2_thresh: float = 5.991,
              min_z: float = 0.1, max_z: float = 1e4) -> torch.Tensor:
    """Per-ray chi-square and cheirality gate -> (..., R) bool of the rays
    that pass; sigma may be per ray (..., R) (octave-scaled)."""
    r = reprojection_residuals(X, world_T_cam, uv, fxycxy)
    sigma = torch.as_tensor(sigma, dtype=r.dtype, device=r.device)
    chi2 = torch.sum((r / sigma[..., None]) ** 2, dim=-1)
    z = lie.se3_apply(lie.se3_inverse(world_T_cam), X[..., None, :])[..., 2]
    return mask & (chi2 < chi2_thresh) & (z > min_z) & (z < max_z)


def parallax_cosine(X: torch.Tensor, origins: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Cosine between the two most separated viewing rays of each point
    (the reference's cosParallax < 0.99998 gate, FrontEnd.cpp:2725-2754):
    X (..., 3), origins (..., R, 3), mask (..., R) -> (...,); invalid ray
    pairs count as cos = 1 (no parallax)."""
    rays = X[..., None, :] - origins
    rays = rays / torch.clamp(
        torch.linalg.vector_norm(rays, dim=-1, keepdim=True), min=1e-9)
    cos = rays @ rays.transpose(-1, -2)
    pair_mask = mask[..., :, None] & mask[..., None, :]
    cos = torch.where(pair_mask, cos, torch.ones_like(cos))
    return torch.amin(cos, dim=(-1, -2))


def _solve3_elem(A, b, damping=0.0):
    """Cofactor solve of a 3x3 system given as nested lists of (...,)
    component tensors. Returns ([x0, x1, x2], det)."""
    a00, a01, a02 = A[0][0] + damping, A[0][1], A[0][2]
    a10, a11, a12 = A[1][0], A[1][1] + damping, A[1][2]
    a20, a21, a22 = A[2][0], A[2][1], A[2][2] + damping
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = 1.0 / safe_det(det)
    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10
    b0, b1, b2 = b
    x0 = (c00 * b0 + c10 * b1 + c20 * b2) * inv_det
    x1 = (c01 * b0 + c11 * b1 + c21 * b2) * inv_det
    x2 = (c02 * b0 + c12 * b1 + c22 * b2) * inv_det
    return [x0, x1, x2], det


def triangulate_and_refine(
    world_T_cam: torch.Tensor,
    uv: torch.Tensor,
    fxycxy: torch.Tensor,
    mask: torch.Tensor,
    sigma: torch.Tensor | float = 1.0,
    chi2_thresh: float = 5.991,
    min_z: float = 0.1,
    max_z: float = 40.0,
    gn_iters: int = 5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """world_T_cam (..., R, 4, 4); uv (..., R, 2) undistorted pixels;
    fxycxy (..., R, 4); mask (..., R). -> (X (..., 3), ok (...,)).

    CUDA tensors launch the tri_refine kernel
    (geometry/triangulation_cuda.py); CPU tensors take
    triangulate_and_refine_reference, which the kernel equals bit for bit
    on the card."""
    if mask.device.type == "cpu":
        return triangulate_and_refine_reference(
            world_T_cam, uv, fxycxy, mask, sigma, chi2_thresh, min_z, max_z,
            gn_iters)
    if mask.device.type != "cuda":
        raise ValueError(f"triangulate_and_refine: unsupported device "
                         f"{mask.device}")
    return triangulation_cuda.tri_refine(
        world_T_cam, uv, fxycxy, mask, sigma, chi2_thresh, min_z, max_z,
        gn_iters)


def ray_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the rays of an (R, M) float32 component in the order the
    card's torch.sum(dim=0) takes on a contiguous (R, M) array, which
    csrc/tri_refine.cu repeats (scripts/tri_sum_order.py): ray r into
    accumulator r % 4, each started as 0 + x, the unused ones 0, folded
    as ((a0 + a1) + a2) + a3. Written as explicit adds, so the CPU gives
    the card's bits."""
    zero = torch.zeros_like(x[0])
    acc = [zero + x[r] if r < x.shape[0] else zero for r in range(4)]
    for r in range(4, x.shape[0]):
        acc[r % 4] = acc[r % 4] + x[r]
    return ((acc[0] + acc[1]) + acc[2]) + acc[3]


def triangulate_and_refine_reference(
    world_T_cam: torch.Tensor,
    uv: torch.Tensor,
    fxycxy: torch.Tensor,
    mask: torch.Tensor,
    sigma: torch.Tensor | float = 1.0,
    chi2_thresh: float = 5.991,
    min_z: float = 0.1,
    max_z: float = 40.0,
    gn_iters: int = 5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of triangulate_and_refine, in the JAX
    package's transposed component form. Every component is made a
    contiguous (R, M) tensor, and every float sum over the rays is
    ray_sum: the card's order of adds, which csrc/tri_refine.cu repeats,
    on every device."""
    batch_shape = mask.shape[:-1]
    R = mask.shape[-1]
    M = 1
    for s in batch_shape:
        M *= s
    f32 = torch.float32

    def t2(x):  # (..., R) -> contiguous (R, M)
        return x.reshape(M, R).transpose(0, 1).to(f32).contiguous()

    T = [[t2(world_T_cam[..., i, j]) for j in range(4)] for i in range(3)]
    u = t2(uv[..., 0])
    v = t2(uv[..., 1])
    fx = t2(fxycxy[..., 0])
    fy = t2(fxycxy[..., 1])
    cx = t2(fxycxy[..., 2])
    cy = t2(fxycxy[..., 3])
    m = t2(mask)

    xn = (u - cx) / fx
    yn = (v - cy) / fy
    # a correctly rounded float32 square root on every device (the CPU's
    # vectorized float32 sqrt is not; the kernel's __fsqrt_rn is)
    inv_n = 1.0 / torch.sqrt((xn * xn + yn * yn + 1.0).double()).float()
    dc = [xn * inv_n, yn * inv_n, inv_n]
    d = [T[i][0] * dc[0] + T[i][1] * dc[1] + T[i][2] * dc[2]
         for i in range(3)]
    o = [T[i][3] for i in range(3)]

    A = [[None] * 3 for _ in range(3)]
    b = [None] * 3
    for i in range(3):
        for j in range(3):
            eye = 1.0 if i == j else 0.0
            A[i][j] = ray_sum(m * (eye - d[i] * d[j]))
    for i in range(3):
        acc = 0.0
        for j in range(3):
            eye = 1.0 if i == j else 0.0
            acc = acc + m * (eye - d[i] * d[j]) * o[j]
        b[i] = ray_sum(acc)
    X0, det = _solve3_elem(A, b, damping=1e-6)
    n_valid = torch.sum(mask, dim=-1).reshape(M)
    ok0 = (n_valid >= 2) & (det > 1e-9)
    ok0 = ok0 & torch.isfinite(X0[0]) & torch.isfinite(X0[1]) \
        & torch.isfinite(X0[2])

    Rcw = [[T[j][i] for j in range(3)] for i in range(3)]
    tcw = [-(T[0][i] * T[0][3] + T[1][i] * T[1][3] + T[2][i] * T[2][3])
           for i in range(3)]

    def project(X):
        return [Rcw[i][0] * X[0] + Rcw[i][1] * X[1] + Rcw[i][2] * X[2]
                + tcw[i] for i in range(3)]

    X = X0
    for _ in range(gn_iters):
        p = project(X)
        z = torch.clamp(p[2], min=1e-3)
        inv_z = 1.0 / z
        ru = (p[0] * inv_z * fx + cx - u) * m
        rv = (p[1] * inv_z * fy + cy - v) * m
        gx = fx * inv_z
        gy = fy * inv_z
        hx = -gx * p[0] * inv_z
        hy = -gy * p[1] * inv_z
        Jc = [[(gx * Rcw[0][i] + hx * Rcw[2][i]) * m for i in range(3)],
              [(gy * Rcw[1][i] + hy * Rcw[2][i]) * m for i in range(3)]]
        H = [[ray_sum(Jc[0][i] * Jc[0][j] + Jc[1][i] * Jc[1][j])
              for j in range(3)] for i in range(3)]
        g = [ray_sum(Jc[0][i] * ru + Jc[1][i] * rv)
             for i in range(3)]
        dX, _ = _solve3_elem(H, g, damping=1e-3)
        X = [X[i] - dX[i] for i in range(3)]
    fin = torch.isfinite(X[0]) & torch.isfinite(X[1]) & torch.isfinite(X[2])
    X = [torch.where(fin, X[i], X0[i]) for i in range(3)]

    p = project(X)
    z = p[2]
    zs = torch.clamp(z, min=1e-6)
    ru = p[0] / zs * fx + cx - u
    rv = p[1] / zs * fy + cy - v
    sig = torch.as_tensor(sigma, dtype=f32, device=mask.device)
    sig = t2(torch.broadcast_to(sig, mask.shape))
    chi2 = (ru * ru + rv * rv) / (sig * sig)
    ray_ok = (m > 0.5) & (chi2 < chi2_thresh) & (z > min_z) & (z < max_z)
    ok = ok0 & (torch.sum(ray_ok, dim=0) >= 2)
    Xout = torch.stack(X, dim=-1).reshape(*batch_shape, 3)
    return Xout, ok.reshape(batch_shape)
