"""Trajectory evaluation (counterpart of mcslam_tpu/utils/metrics.py):
timestamp association, ATE after SE(3) / Sim(3) alignment, and RPE over
a fixed frame delta. Inputs and outputs are numpy; the small math runs on
CPU tensors."""

from __future__ import annotations

import numpy as np
import torch

from mcslam_tpu_torch.geometry import alignment, lie


def associate(ts_est, ts_gt, max_dt=0.02):
    """Greedy nearest-timestamp association -> (idx_est, idx_gt)."""
    ie, ig = [], []
    for i, t in enumerate(ts_est):
        j = int(np.argmin(np.abs(ts_gt - t)))
        if abs(ts_gt[j] - t) <= max_dt:
            ie.append(i)
            ig.append(j)
    return np.asarray(ie, int), np.asarray(ig, int)


def ate_rmse(poses_est, poses_gt, align: bool = True,
             with_scale: bool = False) -> float:
    """Absolute trajectory error RMSE (metres) after SE(3) (or Sim(3))
    alignment of the positions."""
    p_est = np.asarray(poses_est)[:, :3, 3]
    p_gt = np.asarray(poses_gt)[:, :3, 3]
    if align:
        R, t, s = alignment.kabsch(
            torch.as_tensor(p_est, dtype=torch.float32),
            torch.as_tensor(p_gt, dtype=torch.float32),
            estimate_scale=with_scale)
        p_est = float(s) * p_est @ R.numpy().T + t.numpy()
    err = np.linalg.norm(p_est - p_gt, axis=-1)
    return float(np.sqrt(np.mean(err ** 2)))


def rpe(poses_est, poses_gt, delta: int = 1):
    """Relative pose error: (trans_rmse [m/step], rot_rmse [rad/step])."""
    pe = np.asarray(poses_est)
    pg = np.asarray(poses_gt)
    terr, rerr = [], []
    for i in range(len(pe) - delta):
        e = np.linalg.inv(np.linalg.inv(pg[i]) @ pg[i + delta]) @ (
            np.linalg.inv(pe[i]) @ pe[i + delta])
        terr.append(np.linalg.norm(e[:3, 3]))
        w = lie.so3_log(torch.as_tensor(e[:3, :3], dtype=torch.float32))
        rerr.append(float(torch.linalg.vector_norm(w)))
    return (float(np.sqrt(np.mean(np.square(terr)))),
            float(np.sqrt(np.mean(np.square(rerr)))))
