"""Device-resident mirror of the landmark map (counterpart of
mcslam_tpu/mapping/device_map.py).

The host LandmarkMap stays the source of truth for bookkeeping (ids, free
list); the tracking programs read landmark positions, descriptors (int32
words with the host's uint32 bits), viewing normals and validity from this
mirror on the device, so a frame's tracking chains on the device with one
fetch at the end. Updates are in-place `index_copy_` / `index_fill_` from
small (ids, values) uploads, never a whole-array upload.

The JAX mirror rounds every update to a power-of-two size so that eager
XLA scatters compile a handful of shapes; PyTorch runs eagerly with no
per-shape compile, so the port updates at the exact size.
"""

from __future__ import annotations

import numpy as np
import torch


class DeviceMap:
    def __init__(self, capacity: int = 65536, device="cpu"):
        self.capacity = capacity
        self.device = torch.device(device)
        self.pos = torch.zeros(capacity, 3, dtype=torch.float32,
                               device=self.device)
        self.desc = torch.zeros(capacity, 8, dtype=torch.int32,
                                device=self.device)
        self.normal = torch.zeros(capacity, 3, dtype=torch.float32,
                                  device=self.device)
        self.valid = torch.zeros(capacity, dtype=torch.bool,
                                 device=self.device)

    def _up(self, a, dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device).to(dtype)

    def upsert(self, ids, pos=None, desc=None, valid=None, normal=None):
        """Write the given fields of landmarks `ids`; `desc` is (N, 8)
        uint32 (viewed as int32, same bits), `valid` one bool for all."""
        ids = np.asarray(ids, np.int64)
        if len(ids) == 0:
            return
        idx = self._up(ids, torch.int64)
        if pos is not None:
            self.pos.index_copy_(0, idx, self._up(
                np.asarray(pos, np.float32).reshape(-1, 3), torch.float32))
        if normal is not None:
            self.normal.index_copy_(0, idx, self._up(
                np.asarray(normal, np.float32).reshape(-1, 3), torch.float32))
        if desc is not None:
            words = np.asarray(desc, np.uint32).reshape(-1, 8).view(np.int32)
            self.desc.index_copy_(0, idx, self._up(words, torch.int32))
        if valid is not None:
            self.valid.index_fill_(0, idx, bool(valid))

    def remove(self, ids):
        ids = np.asarray(ids, np.int64)
        if len(ids) == 0:
            return
        self.valid.index_fill_(0, self._up(ids, torch.int64), False)
