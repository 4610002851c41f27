"""Host-side keyframe records (counterpart of mcslam_tpu/keyframe.py): the
padded SoA snapshot a frame leaves behind when promoted, fetched from the
device in one copy, and the GPS dummy keyframe with no vision content."""

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

    is_dummy = False  # GPS dummy keyframes (no vision content) override

    @classmethod
    def dummy(cls, kf_id, timestamp, world_T_ref, num_cams: int,
              num_slots: int):
        """An IMU-predicted GPS keyframe with no vision content: a pure
        state node that the window BA constrains by IMU and GPS factors
        only. It has no device copy (device_desc / d_lm_id raise; the
        tracking reference is always a vision keyframe)."""
        kf = cls.__new__(cls)
        kf.kf_id = kf_id
        kf.timestamp = timestamp
        kf.world_T_ref = np.asarray(world_T_ref, np.float32)
        kf.is_dummy = True
        M, C = num_slots, num_cams
        kf.im_desc = np.zeros((M, 8), np.uint32)
        kf.im_uv = np.zeros((M, 2), np.float32)
        kf.im_anchor_cam = np.zeros(M, np.int32)
        kf.im_valid = np.zeros(M, bool)
        kf.im_sigma2 = np.ones(M, np.float32)
        kf.im_point3d = np.zeros((M, 3), np.float32)
        kf.im_has_depth = np.zeros(M, bool)
        kf.im_ray_idx = np.full((M, C), -1, np.int32)
        kf.ray_uv = np.zeros((M, C, 2), np.float32)
        kf.ray_sigma2 = np.ones((M, C), np.float32)
        kf.ray_valid = np.zeros((M, C), bool)
        kf.lm_id = np.full(M, -1, np.int32)
        kf.device = None
        kf.d_desc = None
        kf.d_valid = None
        kf._d_lm_id = None
        return kf

    def _need_device(self):
        if self.is_dummy:
            raise ValueError(f"keyframe {self.kf_id} is a GPS dummy: it has "
                             f"no descriptors on a device")

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
        # device-resident copies for the tracking programs (re-uploaded
        # only after release_device); cloned, since a frame of the graphed
        # step lives in the graph's outputs, which the next frame overwrites
        self.device = frame.im_desc.device
        self.d_desc = frame.im_desc.clone()
        self.d_valid = frame.im_valid.clone()
        self._d_lm_id = None

    def d_lm_id(self) -> torch.Tensor:
        self._need_device()
        if self._d_lm_id is None:
            t = torch.from_numpy(np.array(self.lm_id))
            # on the card from pinned memory, non-blocking: the graphed
            # frame step makes no host sync besides its packed fetch
            self._d_lm_id = (t.pin_memory().to(self.device, non_blocking=True)
                             if self.device.type == "cuda"
                             else t.to(self.device))
        return self._d_lm_id

    def device_desc(self):
        """Device-resident (desc, valid), re-uploaded if released."""
        self._need_device()
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
