"""Closed-form 3x3 linear algebra (counterpart of
mcslam_tpu/geometry/linalg3.py): determinant, adjugate, inverse and solve
by cofactors, batched over leading dims."""

from __future__ import annotations

import torch


def det3(A: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (...,) determinant, closed form."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def adjugate3(A: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3, 3) adjugate (inverse * det)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    return torch.stack(
        [
            torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
            torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
            torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
        ],
        dim=-2,
    )


def safe_det(det: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Clamp |det| at eps PRESERVING its sign (0 maps to +eps)."""
    return torch.where(
        torch.abs(det) < eps,
        torch.sign(det) * eps + (det == 0).to(det.dtype) * eps,
        det,
    )


def inv3(A: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3, 3) inverse via adjugate / det."""
    return adjugate3(A) / safe_det(det3(A), eps)[..., None, None]


def solve3(A: torch.Tensor, b: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Solve A x = b for (..., 3, 3) x (..., 3) -> (..., 3), closed form."""
    x = (adjugate3(A) @ b.unsqueeze(-1)).squeeze(-1)
    return x / safe_det(det3(A), eps)[..., None]
