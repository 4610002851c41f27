"""Motion-only pose optimization: robust LM on SE(3) with chi2 re-gating
rounds (counterpart of mcslam_tpu/frontend/pose_opt.py). The refine
always goes through the one-launch LM of pose_opt_cuda, as on the TPU."""

from __future__ import annotations

from typing import NamedTuple

import torch

from mcslam_tpu_torch.frontend import pose_opt_cuda

CHI2_2DOF = pose_opt_cuda.CHI2_2DOF


class PoseOptResult(NamedTuple):
    world_T_ref: torch.Tensor  # (..., 4, 4)
    inliers: torch.Tensor  # (..., M) bool
    num_inliers: torch.Tensor  # (...,) int32
    final_cost: torch.Tensor  # (...,) float32


def optimize_pose(T_init: torch.Tensor, X_world: torch.Tensor,
                  uv: torch.Tensor, cam_T_ref: torch.Tensor,
                  fxycxy: torch.Tensor, mask: torch.Tensor,
                  sigma2: torch.Tensor | None = None,
                  iters: int | tuple = 8, rounds: int = 2,
                  huber_px: float = 2.5, chi2_thresh: float = CHI2_2DOF,
                  lm_lambda: float = 1e-3) -> PoseOptResult:
    """Refine T_init (4, 4) — or a batch (B, 4, 4) with masks (B, M), in
    one launch — against M observations: X_world (M, 3), uv (M, 2),
    per-observation cam_T_ref (M, 4, 4) and fxycxy (M, 4). `iters` is a
    per-round schedule tuple or an int repeated `rounds` times."""
    single = T_init.ndim == 2
    if sigma2 is None:
        sigma2 = torch.ones(X_world.shape[0], dtype=torch.float32,
                            device=X_world.device)
    data = pose_opt_cuda._pack_obs(X_world, uv, cam_T_ref, fxycxy,
                                   1.0 / sigma2)
    T, chi2 = refine_packed(T_init, data, mask, iters, rounds, huber_px,
                            chi2_thresh, lm_lambda)
    m = mask[None] if mask.ndim == 1 else mask
    inl = m.bool() & (chi2 < chi2_thresh)
    res = PoseOptResult(
        world_T_ref=T,
        inliers=inl,
        num_inliers=torch.sum(inl, dim=-1).to(torch.int32),
        final_cost=torch.sum(torch.where(inl, chi2, torch.zeros_like(chi2)),
                             dim=-1),
    )
    if single:
        res = PoseOptResult(*(x[0] for x in res))
    return res


def refine_packed(T_init: torch.Tensor, data: torch.Tensor,
                  mask: torch.Tensor, iters: int | tuple = 8,
                  rounds: int = 2, huber_px: float = 2.5,
                  chi2_thresh: float = CHI2_2DOF,
                  lm_lambda: float = 1e-3):
    """optimize_pose on observation rows already packed as pose_lm reads
    them (data (22, M), pose_opt_cuda._pack_obs' layout, 1 / sigma^2
    included; the tracking step's epilogue kernels write them): T_init (4,
    4) or (B, 4, 4), mask (M,) or (B, M), bool or float 0/1 -> pose_lm's
    (T (B, 4, 4), chi2 (B, M)), B = 1 for a single pose."""
    T0 = T_init[None] if T_init.ndim == 2 else T_init
    m = mask[None] if mask.ndim == 1 else mask
    sched = iters if isinstance(iters, tuple) else (iters,) * rounds
    return pose_opt_cuda.pose_lm(
        T0.to(torch.float32).contiguous(), data,
        m.to(torch.float32).contiguous(), sched, huber_px=huber_px,
        chi2_thresh=chi2_thresh, lm_lambda=lm_lambda,
    )
