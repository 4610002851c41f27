"""Host-side keyframe records (counterpart of mcslam_tpu/keyframe.py): the
padded SoA snapshot a frame leaves behind when promoted, fetched from the
device in one copy."""

from __future__ import annotations

import numpy as np
import torch

from mcslam_tpu_torch.frontend.frame import FrameFeatures
from mcslam_tpu_torch.ops import hamming


def _pack_kf(frame: FrameFeatures) -> torch.Tensor:
    """Every array a Keyframe needs, packed on the device into ONE int32
    buffer: descriptors as their int32 words, float fields bit-cast (so
    the copy is bit-exact), bools and indices as int32."""
    C = frame.kp_xy_ud.shape[0]
    i32 = torch.int32
    safe = torch.clamp(frame.im_ray_idx, min=0).long()
    cam = torch.arange(C, device=safe.device)[None, :]

    def bits(x):
        return x.to(torch.float32).contiguous().view(i32).reshape(-1)

    return torch.cat([
        frame.im_desc.to(i32).reshape(-1), bits(frame.im_uv_ref),
        frame.im_anchor_cam.to(i32), frame.im_valid.to(i32),
        bits(frame.im_sigma2), bits(frame.im_point3d),
        frame.im_has_depth.to(i32), frame.im_ray_idx.to(i32).reshape(-1),
        bits(frame.kp_xy_ud[cam, safe]),  # ray_uv (M, C, 2)
        bits(frame.kp_sigma2[cam, safe]),  # ray_sigma2 (M, C)
    ]).reshape(-1)


class Keyframe:
    """Host-side keyframe record (small numpy arrays + landmark id table);
    descriptors are uint32 on the host, as in the JAX package."""

    is_dummy = False

    def __init__(self, kf_id, timestamp, world_T_ref, frame: FrameFeatures):
        self.kf_id = kf_id
        self.timestamp = timestamp
        self.world_T_ref = np.asarray(world_T_ref)
        C = frame.kp_xy_ud.shape[0]
        M = frame.im_ray_idx.shape[0]
        v = _pack_kf(frame).cpu().numpy()  # one fetch
        o = 0

        def take(n, shape, as_float=False):
            nonlocal o
            out = v[o:o + n].reshape(shape)
            o += n
            return out.view(np.float32) if as_float else out

        self.im_desc = take(M * 8, (M, 8)).view(np.uint32)
        self.im_uv = take(M * 2, (M, 2), True)
        self.im_anchor_cam = take(M, (M,))
        self.im_valid = take(M, (M,)) > 0
        self.im_sigma2 = take(M, (M,), True)
        self.im_point3d = take(M * 3, (M, 3), True)
        self.im_has_depth = take(M, (M,)) > 0
        self.im_ray_idx = take(M * C, (M, C))
        self.ray_uv = take(M * C * 2, (M, C, 2), True)
        self.ray_sigma2 = take(M * C, (M, C), True)
        self.ray_valid = self.im_ray_idx >= 0
        self.lm_id = np.full(M, -1, np.int32)
        # device-resident copies for the tracking programs (the frame's own
        # tensors; re-uploaded only after release_device)
        self.device = frame.im_desc.device
        self.d_desc = frame.im_desc
        self.d_valid = frame.im_valid
        self._d_lm_id = None

    def d_lm_id(self) -> torch.Tensor:
        if self._d_lm_id is None:
            self._d_lm_id = torch.tensor(self.lm_id, device=self.device)
        return self._d_lm_id

    def device_desc(self):
        """Device-resident (desc, valid), re-uploaded if released."""
        if self.d_desc is None:
            self.d_desc = hamming.desc_to_torch(self.im_desc, self.device)
            self.d_valid = torch.tensor(self.im_valid, device=self.device)
        return self.d_desc, self.d_valid

    def release_device(self):
        """Free this keyframe's device copies (only the tracking reference
        keyframe is read on the device); host arrays stay."""
        self.d_desc = None
        self.d_valid = None
        self._d_lm_id = None

    def lm_dirty(self):
        """Call after mutating lm_id so the device copy refreshes lazily."""
        self._d_lm_id = None
