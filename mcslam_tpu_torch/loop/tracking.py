"""Fast tracking: pose-indexed map reuse after global relocalization
(counterpart of mcslam_tpu/loop/tracking.py).

From the predicted pose: the stored keyframes nearest to it (an argmin
over a dense distance vector on the host), the union of their landmarks,
projected into every rig camera and matched to the frame's features by the
same pixel-gated Hamming kernel as local-map tracking
(tracking_kernels._project_and_match_local, `hamming_argmin2`), then the
relocalizer's PnP + pose-LM verification.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mcslam_tpu_torch.loop.reloc import verify_pnp
from mcslam_tpu_torch.ops import hamming
from mcslam_tpu_torch.tracking_kernels import _project_and_match_local


@dataclasses.dataclass
class FastTrackConfig:
    knn_keyframes: int = 5
    radius_px: float = 20.0
    max_dist: int = 64
    min_inliers: int = 12
    min_inlier_ratio: float = 0.2
    ransac_px: float = 6.0
    max_landmarks: int = 4096


class FastTracker:
    def __init__(self, relocalizer, config: FastTrackConfig = None,
                 seed: int = 0):
        self.reloc = relocalizer
        self.cfg = config or FastTrackConfig()
        self.gen = torch.Generator(
            device=relocalizer.device).manual_seed(seed)
        self.kf_positions = np.stack(
            [e["pose"][:3, 3] for e in relocalizer.kf_entries])

    def track(self, frame, predicted_pose: np.ndarray) -> Optional[np.ndarray]:
        """FrameFeatures + predicted world_T_ref -> refined pose or None."""
        cfg = self.cfg
        rig = self.reloc.rig
        dev = frame.im_desc.device
        # 1. the nearest stored keyframes by metric distance
        d = np.linalg.norm(self.kf_positions - predicted_pose[:3, 3][None],
                           axis=-1)
        near = np.argsort(d)[:cfg.knn_keyframes]
        slots = np.unique(np.concatenate(
            [self.reloc.kf_entries[i]["slots"] for i in near]
        ))[:cfg.max_landmarks]
        if len(slots) < cfg.min_inliers:
            return None
        L = cfg.max_landmarks
        lm_pos = np.zeros((L, 3), np.float32)
        lm_desc = np.zeros((L, 8), np.uint32)
        lm_pos[:len(slots)] = self.reloc.lm_pos[slots]
        lm_desc[:len(slots)] = self.reloc.lm_desc[slots]
        # 2-4. project and match, pixel-gated
        res = _project_and_match_local(
            torch.from_numpy(np.asarray(predicted_pose, np.float32)).to(dev),
            torch.from_numpy(lm_pos).to(dev),
            hamming.desc_to_torch(lm_desc, dev),
            torch.arange(L, device=dev) < len(slots), frame.im_desc,
            frame.im_uv_ref, frame.im_anchor_cam, frame.im_valid,
            rig.cam_T_ref, rig.fxycxy, rig.image_size, cfg.radius_px,
            cfg.max_dist)
        v = torch.stack([res.ok.to(torch.int32), res.idx]).cpu().numpy()
        # 5. robust refine with the inlier-ratio gate
        return verify_pnp(self.gen, rig, frame, v[0] > 0, lm_pos, v[1],
                          cfg.min_inliers, cfg.ransac_px, cfg.min_inliers,
                          cfg.min_inlier_ratio)
