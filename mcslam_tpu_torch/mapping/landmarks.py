"""Global landmark store: padded SoA pool with free-list semantics (the
numpy bookkeeping of mcslam_tpu/mapping/landmarks.py, unchanged).

Insert / delete / update landmarks, per-landmark observing keyframes and
the viewing-normal running average, with the update gate ||delta|| < 5.0.
A numpy structure-of-arrays on the host: fixed capacity with a free list;
ids are stable slot indices, so keyframe association tables stay valid.
Descriptors are uint32 here, as in the JAX package; the device mirror
(device_map.DeviceMap) holds the same bits as int32 words.
"""

from __future__ import annotations

import numpy as np

UPDATE_GATE = 5.0  # max position jump accepted by update()


class LandmarkMap:
    def __init__(self, capacity: int = 65536):
        self.capacity = capacity
        self.pos = np.zeros((capacity, 3), np.float32)
        self.desc = np.zeros((capacity, 8), np.uint32)
        self.normal = np.zeros((capacity, 3), np.float32)
        self.n_obs = np.zeros(capacity, np.int32)
        self.first_kf = np.full(capacity, -1, np.int32)
        self.last_kf = np.full(capacity, -1, np.int32)
        self.valid = np.zeros(capacity, bool)
        self._free = list(range(capacity - 1, -1, -1))

    @property
    def num_valid(self) -> int:
        return int(self.valid.sum())

    def insert(self, pos, desc, normal, kf_id) -> np.ndarray:
        """Insert N landmarks -> their slot ids (int32 array)."""
        n = len(pos)
        if n > len(self._free):
            raise RuntimeError("landmark pool exhausted")
        ids = np.array([self._free.pop() for _ in range(n)], np.int32)
        self.pos[ids] = pos
        self.desc[ids] = desc
        self.normal[ids] = normal
        self.n_obs[ids] = 1
        self.first_kf[ids] = kf_id
        self.last_kf[ids] = kf_id
        self.valid[ids] = True
        return ids

    def delete(self, ids):
        ids = np.asarray(ids, np.int32)
        ids = ids[self.valid[ids]]
        self.valid[ids] = False
        self.n_obs[ids] = 0
        self._free.extend(int(i) for i in ids)

    def update_positions(self, ids, new_pos):
        """Accept optimized positions unless they jumped implausibly far
        (reference updateLandmark gate)."""
        ids = np.asarray(ids, np.int32)
        ok = self.valid[ids]
        delta = np.linalg.norm(new_pos - self.pos[ids], axis=-1)
        ok &= delta < UPDATE_GATE
        self.pos[ids[ok]] = new_pos[ok]
        return ok

    def add_observation(self, ids, kf_id, view_dirs):
        """Record another observation: bump counters, running-average normal
        (reference Landmark::updateNormal)."""
        ids = np.asarray(ids, np.int32)
        m = self.valid[ids]
        ids = ids[m]
        vd = view_dirs[m]
        n = self.n_obs[ids].astype(np.float32)[:, None]
        self.normal[ids] = (self.normal[ids] * n + vd) / (n + 1)
        self.n_obs[ids] += 1
        self.last_kf[ids] = kf_id
