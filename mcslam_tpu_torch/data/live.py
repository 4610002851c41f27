"""Live multi-sensor ingestion without ROS (counterpart of
mcslam_tpu/data/live.py, the same host code).

Parity (WHAT): RosDataReader (MCDataUtils/src/
RosDataReader.cpp) — per-camera subscribers with mutex-guarded deques, IMU
and GPS queues, and message slicing up to each image timestamp — and the
live capture half of VideoStreamReader (one capture thread per camera,
VideoStreamReader.cpp:190).

HOW: a transport-agnostic LiveRig: any producer (camera driver callback,
socket, cv2.VideoCapture thread) pushes timestamped messages; get_next()
assembles time-synchronized camera groups and slices IMU/GPS exactly like
the reference's share_imu_data/share_gps_data. No ROS dependency; a ROS 1/2
node can feed this directly from its callbacks.
"""

from __future__ import annotations

import threading
from collections import deque

import numpy as np


class _Queue:
    def __init__(self, maxlen=512):
        self.q = deque(maxlen=maxlen)
        self.mu = threading.Lock()
        self.cv = threading.Condition(self.mu)

    def push(self, item):
        with self.mu:
            self.q.append(item)
            self.cv.notify_all()

    def pop_upto(self, t):
        """All items with timestamp <= t, removed from the queue."""
        out = []
        with self.mu:
            while self.q and self.q[0][0] <= t:
                out.append(self.q.popleft())
        return out

    def wait_nonempty(self, timeout):
        with self.mu:
            if not self.q:
                self.cv.wait(timeout)
            return bool(self.q)


class LiveRig:
    """Synchronized live feed for an N-camera rig + IMU + GPS."""

    def __init__(self, num_cams: int, sync_tol: float = 0.01,
                 queue_len: int = 64):
        self.num_cams = num_cams
        self.sync_tol = sync_tol
        self._cams = [_Queue(queue_len) for _ in range(num_cams)]
        self._imu = _Queue(4096)
        self._gps = _Queue(512)
        self._stopped = threading.Event()

    # -- producer side (camera driver / socket / ROS callback) -------------

    def push_image(self, cam: int, timestamp: float, img: np.ndarray):
        """img: (H, W) float32 [0,1] or uint8."""
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        self._cams[cam].push((float(timestamp), img))

    def push_imu(self, timestamp: float, gyro, accel):
        self._imu.push((float(timestamp), np.asarray(gyro, np.float64),
                        np.asarray(accel, np.float64)))

    def push_gps(self, timestamp: float, lat, lon, alt):
        self._gps.push((float(timestamp), np.array([lat, lon, alt])))

    def stop(self):
        self._stopped.set()
        for c in self._cams:
            c.push((np.inf, None))

    # -- consumer side (the SLAM loop) --------------------------------------

    def get_next(self, timeout: float = 1.0):
        """Blocking: next synchronized frame group.

        Returns (imgs (C, H, W), t, imu_slice, gps_slice) or None when
        stopped / timed out. imu_slice = (ts, gyro, accel) arrays of all IMU
        samples up to t; gps_slice likewise (reference share_imu_data).
        """
        # anchor on camera 0; loop (not recurse) over unmatched anchors so a
        # stalled/late camera on a long-running session cannot blow the
        # Python recursion limit
        while True:
            if not self._cams[0].wait_nonempty(timeout):
                return None
            with self._cams[0].mu:
                if not self._cams[0].q:
                    return None
                t0, img0 = self._cams[0].q.popleft()
            if img0 is None:
                return None  # stop sentinel — queues drained
            out = self._assemble(t0, img0, timeout)
            if out is not None:
                return out
            # unmatched group (async camera start): try the next anchor

    def _assemble(self, t0, img0, timeout):
        imgs = [img0]
        for c in range(1, self.num_cams):
            best = None
            tries = 50
            while best is None and tries > 0:
                with self._cams[c].mu:
                    q = self._cams[c].q
                    while q and q[0][0] < t0 - self.sync_tol:
                        q.popleft()
                    if q and abs(q[0][0] - t0) <= self.sync_tol:
                        best = q.popleft()[1]
                    elif q and q[0][0] > t0 + self.sync_tol:
                        return None  # this group can never complete
                if best is None:
                    if not self._cams[c].wait_nonempty(timeout / 50):
                        tries -= 1
            if best is None:
                return None
            imgs.append(best)
        imu_raw = self._imu.pop_upto(t0)
        gps_raw = self._gps.pop_upto(t0)
        imu_slice = (
            np.array([m[0] for m in imu_raw]),
            np.array([m[1] for m in imu_raw]).reshape(-1, 3),
            np.array([m[2] for m in imu_raw]).reshape(-1, 3),
        )
        gps_slice = (
            np.array([m[0] for m in gps_raw]),
            np.array([m[1] for m in gps_raw]).reshape(-1, 3),
        )
        return np.stack(imgs), t0, imu_slice, gps_slice
