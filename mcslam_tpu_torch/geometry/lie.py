"""SO(3)/SE(3) Lie-group operations on batched torch tensors.

Counterpart of mcslam_tpu/geometry/lie.py with the same conventions:
rotations are (..., 3, 3), poses (..., 4, 4) homogeneous matrices, se3
tangents (..., 6) ordered (omega, v) with the left-jacobian convention,
and the optimizers retract on the right: se3_retract(T, xi) = T @ exp(xi).
The small-angle branches use the same Taylor series in theta^2.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _apply_mat(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) x (..., 3) -> (..., 3), broadcasting the batch dims."""
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def so3_vee(W: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) skew -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _theta_terms(w: torch.Tensor):
    """(t2, theta, small) with theta computed from a clamped t2."""
    t2 = torch.sum(w * w, dim=-1)
    small = t2 < _EPS
    theta = torch.sqrt(torch.where(small, torch.ones_like(t2), t2))
    return t2, theta, small


def _eye3(w: torch.Tensor, batch_shape) -> torch.Tensor:
    return torch.eye(3, dtype=w.dtype, device=w.device).expand(
        *batch_shape, 3, 3
    )


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) tangent -> (..., 3, 3) rotation."""
    t2, theta, small = _theta_terms(w)
    a = torch.where(
        small, 1.0 - t2 / 6.0 + t2 * t2 / 120.0, torch.sin(theta) / theta
    )
    b = torch.where(
        small, 0.5 - t2 / 24.0 + t2 * t2 / 720.0,
        (1.0 - torch.cos(theta)) / (theta * theta),
    )
    W = so3_hat(w)
    W2 = W @ W
    return _eye3(w, W.shape[:-2]) + a[..., None, None] * W \
        + b[..., None, None] * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 3) tangent. Handles theta near 0 and
    pi exactly like the JAX version (atan2 angle, diagonal extraction
    near pi)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w_skew = 0.5 * (R - R.transpose(-1, -2))
    w_sin = so3_vee(w_skew)
    s2 = torch.sum(w_sin * w_sin, dim=-1)
    small = s2 < 1e-10
    sin_safe = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    sin_theta = torch.where(small, torch.zeros_like(s2), sin_safe)
    theta = torch.atan2(sin_theta, cos_theta)
    near_pi = (sin_theta < 1e-3) & (theta > 3.0)
    scale = torch.where(small, 1.0 + s2 / 6.0, theta / sin_safe)
    w_generic = w_sin * scale[..., None]
    B = (R + torch.eye(3, dtype=R.dtype, device=R.device)) * 0.5
    diag = torch.clamp(
        torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], dim=-1),
        0.0, 1.0,
    )
    axis_abs = torch.sqrt(diag)
    one = torch.ones_like(axis_abs[..., 0])
    sx = one
    sy = torch.where(B[..., 0, 1] >= 0, one, -one) * sx
    sz = torch.where(B[..., 0, 2] >= 0, one, -one) * sx
    sz = torch.where(
        axis_abs[..., 0] < 1e-3,
        torch.where(B[..., 1, 2] >= 0, one, -one) * sy, sz,
    )
    axis_pi = axis_abs * torch.stack([sx, sy, sz], dim=-1)
    w_pi = axis_pi * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w_generic)


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """J_l(w) = I + (1-cos)/t^2 W + (t - sin)/t^3 W^2."""
    t2, theta, small = _theta_terms(w)
    b = torch.where(
        small, 0.5 - t2 / 24.0, (1.0 - torch.cos(theta)) / (theta * theta)
    )
    c = torch.where(
        small, 1.0 / 6.0 - t2 / 120.0,
        (theta - torch.sin(theta)) / (theta * theta * theta),
    )
    W = so3_hat(w)
    W2 = W @ W
    return _eye3(w, W.shape[:-2]) + b[..., None, None] * W \
        + c[..., None, None] * W2


def so3_left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """J_l^{-1}(w) = I - W/2 + (1/t^2 - (1+cos)/(2 t sin)) W^2."""
    t2, theta, small = _theta_terms(w)
    sin_theta = torch.sin(theta)
    safe = torch.where(
        torch.abs(sin_theta) < 1e-12, torch.ones_like(sin_theta), sin_theta
    )
    coeff = torch.where(
        small, 1.0 / 12.0 + t2 / 720.0,
        1.0 / (theta * theta) - (1.0 + torch.cos(theta)) / (2.0 * theta * safe),
    )
    W = so3_hat(w)
    W2 = W @ W
    return _eye3(w, W.shape[:-2]) - 0.5 * W + coeff[..., None, None] * W2


def se3_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(*batch, 3, 3)
    t = t.expand(*batch, 3)
    top = torch.cat([R, t.unsqueeze(-1)], dim=-1)
    bottom = torch.zeros(*batch, 1, 4, dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return se3_matrix(Rt, -_apply_mat(Rt, t))


def se3_apply(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Transform points: (..., 4, 4) x (..., 3) -> (..., 3)."""
    return _apply_mat(T[..., :3, :3], p) + T[..., :3, 3]


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) tangent (omega, v) -> (..., 4, 4)."""
    w, v = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    J = so3_left_jacobian(w)
    return se3_matrix(R, _apply_mat(J, v))


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6) tangent (omega, v)."""
    w = so3_log(T[..., :3, :3])
    v = _apply_mat(so3_left_jacobian_inv(w), T[..., :3, 3])
    return torch.cat([w, v], dim=-1)


def se3_retract(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Right-multiplicative retraction used by all optimizers."""
    return T @ se3_exp(xi)


def quat_from_rot(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) quaternion (x, y, z, w), TUM order, w >= 0.
    Branchless Shepperd's method: all four pivot candidates, the one with
    the largest pivot selected."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def piv(x):
        h = torch.sqrt(torch.clamp(x, min=0.0)) * 0.5
        return h, 4.0 * torch.clamp(h, min=1e-12)

    qw0, d0 = piv(1.0 + tr)
    qx1, d1 = piv(1.0 + m00 - m11 - m22)
    qy2, d2 = piv(1.0 - m00 + m11 - m22)
    qz3, d3 = piv(1.0 - m00 - m11 + m22)
    cands = torch.stack([
        torch.stack([(m21 - m12) / d0, (m02 - m20) / d0, (m10 - m01) / d0,
                     qw0], -1),
        torch.stack([qx1, (m01 + m10) / d1, (m02 + m20) / d1,
                     (m21 - m12) / d1], -1),
        torch.stack([(m01 + m10) / d2, qy2, (m12 + m21) / d2,
                     (m02 - m20) / d2], -1),
        torch.stack([(m02 + m20) / d3, (m12 + m21) / d3, qz3,
                     (m10 - m01) / d3], -1),
    ], dim=-2)  # (..., 4, 4)
    idx = torch.argmax(torch.stack(
        [tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22], -1), -1)
    q = torch.take_along_dim(
        cands, idx[..., None, None].expand(*idx.shape, 1, 4), dim=-2)[..., 0, :]
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)


def rot_from_quat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternion (x, y, z, w) -> (..., 3, 3)."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
        ],
        dim=-2,
    )
