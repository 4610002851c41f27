"""Closed-form small linear algebra (counterpart of
mcslam_tpu/geometry/linalg3.py): 3x3 determinant, adjugate, inverse and
solve by cofactors, and the unrolled Cholesky solve of small SPD systems,
batched over leading dims."""

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


def chol_solve_nn(H: torch.Tensor, g: torch.Tensor, n: int) -> torch.Tensor:
    """Solve H x = g for small SPD systems by a fully unrolled Cholesky
    (no pivoting, no control flow; batched over leading dims): H
    (..., n, n), g (..., n) -> (..., n). Intended for n <= 8."""
    Hc = [[H[..., i, j] for j in range(n)] for i in range(n)]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        d = Hc[j][j]
        for k in range(j):
            d = d - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(torch.clamp(d, min=1e-30))
        inv = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = Hc[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    y = [None] * n  # forward substitution L y = g
    for i in range(n):
        s = g[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n  # back substitution L^T x = y
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def chol_solve6(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Unrolled-Cholesky solve of (..., 6, 6) SPD systems (chol_solve_nn)."""
    return chol_solve_nn(H, g, 6)
