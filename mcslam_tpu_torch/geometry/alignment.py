"""Point-set alignment (counterpart of mcslam_tpu/geometry/alignment.py:
kabsch with SE(3) / Sim(3) alignment (umeyama), the SVD-free batched absolute
orientation kabsch_quat with _dominant_eigvec4, and the gravity
alignment of IMU initialization)."""

from __future__ import annotations

import torch

from mcslam_tpu_torch.geometry import lie, linalg3
from mcslam_tpu_torch.utils import graphs


def kabsch(src: torch.Tensor, dst: torch.Tensor,
           weights: torch.Tensor | None = None,
           estimate_scale: bool = False):
    """(R, t, s) minimizing sum_i w_i || dst_i - (s R src_i + t) ||^2 by
    SVD of the weighted cross-covariance (Umeyama's scale when
    estimate_scale, else s = 1). src, dst (..., M, 3); weights (..., M)
    -> R (..., 3, 3), t (..., 3), s (...,)."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype,
                             device=src.device)
    w = weights[..., None]
    wsum = torch.clamp(torch.sum(w, dim=-2), min=1e-12)
    mu_src = torch.sum(src * w, dim=-2) / wsum
    mu_dst = torch.sum(dst * w, dim=-2) / wsum
    xs = src - mu_src[..., None, :]
    xd = dst - mu_dst[..., None, :]
    C = torch.einsum("...mi,...mj->...ij", xd * w, xs)
    U, S, Vt = torch.linalg.svd(C)
    # proper rotation: flip the last singular vector if det < 0
    det = torch.linalg.det(U @ Vt)
    D = torch.ones(*C.shape[:-2], 3, dtype=C.dtype, device=C.device)
    D[..., 2] = torch.sign(det) + (det == 0).to(C.dtype)
    R = U @ (D[..., :, None] * Vt)
    if estimate_scale:
        var_src = torch.sum(torch.sum(xs * xs, dim=-1) * weights, dim=-1)
        s = torch.sum(S * D, dim=-1) / torch.clamp(var_src, min=1e-12)
    else:
        s = torch.ones(C.shape[:-2], dtype=C.dtype, device=C.device)
    t = mu_dst - s[..., None] * (R @ mu_src.unsqueeze(-1)).squeeze(-1)
    return R, t, s


def umeyama(src: torch.Tensor, dst: torch.Tensor, weights=None):
    """Similarity-transform alignment (kabsch with the scale estimated)."""
    return kabsch(src, dst, weights, estimate_scale=True)


def davenport(src: torch.Tensor, dst: torch.Tensor,
              weights: torch.Tensor | None = None):
    """Davenport's 4x4 matrix of the weighted cross-covariance of src, dst
    (..., M, 3), whose dominant eigenvector is Horn's optimal quaternion
    (w, x, y, z) -> (K (..., 4, 4), mu_s, mu_d (..., 3))."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype,
                             device=src.device)
    w = weights[..., None]
    wsum = torch.clamp(torch.sum(w, dim=-2), min=1e-12)
    mu_s = torch.sum(src * w, dim=-2) / wsum
    mu_d = torch.sum(dst * w, dim=-2) / wsum
    xs = src - mu_s[..., None, :]
    xd = dst - mu_d[..., None, :]
    B = torch.einsum("...mi,...mj->...ij", xs * w, xd)
    tr = B[..., 0, 0] + B[..., 1, 1] + B[..., 2, 2]
    z = torch.stack(
        [B[..., 1, 2] - B[..., 2, 1], B[..., 2, 0] - B[..., 0, 2],
         B[..., 0, 1] - B[..., 1, 0]], dim=-1,
    )
    S = B + B.transpose(-1, -2)
    eye = torch.eye(3, dtype=B.dtype, device=B.device)
    K = torch.zeros(*B.shape[:-2], 4, 4, dtype=B.dtype, device=B.device)
    K[..., 0, 0] = tr
    K[..., 0, 1:] = z
    K[..., 1:, 0] = z
    K[..., 1:, 1:] = S - tr[..., None, None] * eye
    return K, mu_s, mu_d


def kabsch_quat(src: torch.Tensor, dst: torch.Tensor,
                weights: torch.Tensor | None = None):
    """Horn's quaternion absolute orientation, batched: the optimal
    rotation is the dominant eigenvector of the 4x4 Davenport matrix.
    src, dst (..., M, 3) -> (R (..., 3, 3), t (..., 3)) with
    dst ~ R src + t."""
    K, mu_s, mu_d = davenport(src, dst, weights)
    q = _dominant_eigvec4(K)  # (w, x, y, z)
    R = lie.rot_from_quat(
        torch.stack([q[..., 1], q[..., 2], q[..., 3], q[..., 0]], dim=-1)
    )
    t = mu_d - (R @ mu_s.unsqueeze(-1)).squeeze(-1)
    return R, t


def gravity_align_rotation(acc_mean: torch.Tensor,
                           g_world: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """world_R_body taking the mean accelerometer direction to g_world
    (default +z), for IMU gravity initialization: Rodrigues from the cross
    product, and for antiparallel vectors a 180-degree turn about an axis
    orthogonal to acc_mean."""
    f = dict(dtype=acc_mean.dtype, device=acc_mean.device)
    if g_world is None:
        g_world = torch.tensor([0.0, 0.0, 1.0], **f)
    a = acc_mean / torch.clamp(
        torch.linalg.vector_norm(acc_mean, dim=-1, keepdim=True), min=1e-12)
    b = g_world / torch.linalg.vector_norm(g_world, dim=-1, keepdim=True)
    v = torch.linalg.cross(a, b.expand_as(a))
    c = torch.sum(a * b, dim=-1)
    s2 = torch.sum(v * v, dim=-1)
    vx = lie.so3_hat(v)
    eye = torch.eye(3, **f)
    generic = eye + vx + vx @ vx * (
        (1.0 - c) / torch.clamp(s2, min=1e-12))[..., None, None]
    ortho = torch.where(torch.abs(a[..., 0:1]) < 0.9,
                        torch.tensor([1.0, 0.0, 0.0], **f),
                        torch.tensor([0.0, 1.0, 0.0], **f))
    axis = torch.linalg.cross(a, ortho)
    axis = axis / torch.clamp(
        torch.linalg.vector_norm(axis, dim=-1, keepdim=True), min=1e-12)
    ax = lie.so3_hat(axis)
    flip = eye + 2.0 * ax @ ax
    return torch.where((c < -1.0 + 1e-6)[..., None, None], flip, generic)


NEWTON_STEPS = 12  # the Newton steps of _dominant_eigvec4


def charpoly4(K: torch.Tensor):
    """The characteristic polynomial lambda^4 + a3 lambda^3 + a2 lambda^2 +
    a1 lambda + a0 of a 4x4 (batched) by Faddeev-LeVerrier, and Newton's
    start from the Frobenius bound -> (a3, a2, a1, a0, lambda_0)."""
    eye = torch.eye(4, dtype=K.dtype, device=K.device)

    def tr(M):
        return torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)

    M1 = K
    a3 = -tr(M1)
    M2 = K @ (M1 + a3[..., None, None] * eye)
    a2 = -tr(M2) / 2.0
    M3 = K @ (M2 + a2[..., None, None] * eye)
    a1 = -tr(M3) / 3.0
    M4 = K @ (M3 + a1[..., None, None] * eye)
    a0 = -tr(M4) / 4.0
    lam = torch.sqrt(torch.sum(K * K, dim=(-1, -2))) + 1e-9
    return a3, a2, a1, a0, lam


def newton_step(lam, a3, a2, a1, a0):
    """One Newton step on the characteristic polynomial (a derivative
    under 1e-12 in magnitude taken as 1e-12). It depends on lam and the
    coefficients alone, so a lam it leaves unchanged bit for bit stays so
    through every later step: csrc/kabsch_hyp.cu stops there."""
    p = (((lam + a3) * lam + a2) * lam + a1) * lam + a0
    dp = ((4.0 * lam + 3.0 * a3) * lam + 2.0 * a2) * lam + a1
    dp = torch.where(torch.abs(dp) < 1e-12, torch.full_like(dp, 1e-12), dp)
    return lam - p / dp


def newton_fixed_steps(K: torch.Tensor) -> torch.Tensor:
    """The steps (..., int64) that Newton runs on each 4x4 of K until a
    step leaves lambda unchanged bit for bit, that step included, at most
    NEWTON_STEPS: what csrc/kabsch_hyp.cu's early exit runs of them."""
    a3, a2, a1, a0, lam = charpoly4(K)
    steps = torch.full(lam.shape, NEWTON_STEPS, dtype=torch.int64,
                       device=lam.device)
    ibits = {torch.float32: torch.int32, torch.float64: torch.int64}[lam.dtype]
    for it in range(NEWTON_STEPS):
        nxt = newton_step(lam, a3, a2, a1, a0)
        fixed = torch.eq(nxt.view(ibits), lam.view(ibits))
        steps = torch.where(fixed & (steps == NEWTON_STEPS),
                            torch.full_like(steps, it + 1), steps)
        lam = nxt
    return steps


def _dominant_eigvec4(K: torch.Tensor) -> torch.Tensor:
    """Dominant eigenvector of a symmetric 4x4 (batched): characteristic
    polynomial by Faddeev-LeVerrier, lambda_max by 12 Newton steps from
    the Frobenius bound, eigenvector = the adjugate column of largest
    norm of (K - lambda I)."""
    eye = torch.eye(4, dtype=K.dtype, device=K.device)
    a3, a2, a1, a0, lam = charpoly4(K)
    for _ in range(NEWTON_STEPS):
        lam = newton_step(lam, a3, a2, a1, a0)

    A = K - lam[..., None, None] * eye
    keep = [graphs.values(tuple(i for i in range(4) if i != r), torch.int64,
                          A.device) for r in range(4)]
    cof = torch.stack(
        [
            torch.stack(
                [((-1.0) ** (r + c)) * linalg3.det3(
                    A.index_select(-2, keep[r]).index_select(-1, keep[c]))
                 for c in range(4)],
                dim=-1,
            )
            for r in range(4)
        ],
        dim=-2,
    )
    adj = cof.transpose(-1, -2)  # columns span null(A)
    norms = torch.sum(adj * adj, dim=-2)
    best = torch.argmax(norms, dim=-1)
    q = torch.take_along_dim(
        adj, best[..., None, None].expand(*adj.shape[:-1], 1), dim=-1
    )[..., 0]
    return q / torch.clamp(
        torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12
    )
