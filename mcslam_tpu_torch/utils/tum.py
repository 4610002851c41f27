"""TUM-format trajectory I/O (counterpart of mcslam_tpu/utils/tum.py),
byte-compatible with it: `timestamp tx ty tz qx qy qz qw` per line."""

from __future__ import annotations

import numpy as np
import torch

from mcslam_tpu_torch.geometry import lie


def write_tum(path, timestamps, poses) -> None:
    """timestamps (F,), poses (F, 4, 4) world_T_cam -> TUM text file."""
    poses = np.asarray(poses)
    q = lie.quat_from_rot(torch.as_tensor(poses[:, :3, :3])).numpy()
    t = poses[:, :3, 3]
    with open(path, "w") as f:
        for i, ts in enumerate(timestamps):
            f.write(
                f"{ts:.9f} {t[i,0]:.9f} {t[i,1]:.9f} {t[i,2]:.9f} "
                f"{q[i,0]:.9f} {q[i,1]:.9f} {q[i,2]:.9f} {q[i,3]:.9f}\n"
            )


def read_tum(path):
    """-> (timestamps (F,), poses (F, 4, 4) float32)."""
    data = np.loadtxt(path)
    if data.ndim == 1:
        data = data[None]
    ts = data[:, 0]
    R = lie.rot_from_quat(torch.as_tensor(data[:, 4:8], dtype=torch.float32))
    poses = np.tile(np.eye(4, dtype=np.float32), (len(ts), 1, 1))
    poses[:, :3, :3] = R.numpy()
    poses[:, :3, 3] = data[:, 1:4]
    return ts, poses
