"""Sensor-ingestion half of the SLAM driver (mixin; counterpart of
mcslam_tpu/driver_sensors.py): IMU buffering, gravity initialization and
preintegration spans; GPS ENU conversion, the Kabsch / yaw-only
alignment init and refit, keyframe attachment and IMU-predicted dummy
keyframes.

Everything here is host work on small arrays. The IMU math
(backend/imu) and the Kabsch fits run on CPU tensors whatever the
session's device: the samples live in a host buffer and every result is
read back on the host at once, so on the card each call would be a chain
of tiny launches and a sync. This placement does not depend on whether a
card is present.
"""

from __future__ import annotations

import numpy as np
import torch

from mcslam_tpu_torch.backend import imu as imu_mod
from mcslam_tpu_torch.geometry import alignment
from mcslam_tpu_torch.geometry.geodesy import EnuConverter
from mcslam_tpu_torch.keyframe import Keyframe


def _host(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32))


def _yaw_rotation(Vc, Ec):
    """2D Procrustes: the rotation about z that best maps the centred
    xy cloud Vc onto Ec."""
    M = Ec[:, :2].T @ Vc[:, :2]
    yaw = np.arctan2(M[1, 0] - M[0, 1], M[0, 0] + M[1, 1])
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


class SensorsMixin:
    # merge window: a GPS fix this close to a vision keyframe is attached
    # to it rather than spawning a dummy keyframe
    GPS_MERGE_DT = 0.05

    # -- IMU ---------------------------------------------------------------

    def _ingest_imu(self, imu):
        """imu = (ts (S,), gyro (S, 3), accel (S, 3)) message slice."""
        ts, gyro, accel = imu
        for k in range(len(ts)):
            self._imu_buf.append((float(ts[k]), gyro[k], accel[k]))
            if self.graph_log is not None:
                self.graph_log.imu_raw(float(ts[k]), gyro[k], accel[k])
        if self.imu_initialized:
            return
        self._imu_init_buf.extend((gyro[k], accel[k]) for k in range(len(ts)))
        # gravity alignment once enough (stationary) samples are in
        if len(self._imu_init_buf) < self.cfg.imu_init_samples:
            return
        g = np.stack([s[0] for s in self._imu_init_buf])
        a = np.stack([s[1] for s in self._imu_init_buf])
        R_wb, bias = imu_mod.init_gravity_aligned(
            _host(a), _host(g), torch.ones(len(a), dtype=torch.bool),
            self.imu_params)
        self.bias = bias.numpy()
        if self.relocalizer is None:
            # world frame = the gravity-aligned body frame at init
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = R_wb.numpy()
            self.cur_pose = pose
        self.imu_initialized = True
        self._imu_buf = [s for s in self._imu_buf if s[0] >= 0]

    def _preintegrate_span(self, t0, t1):
        """Preintegrate the buffered IMU samples with t0 < ts <= t1 (on CPU
        tensors); None with fewer than 3 samples."""
        sel = [(t, g, a) for (t, g, a) in self._imu_buf if t0 < t <= t1]
        if len(sel) < 3:
            return None
        ts = np.array([s[0] for s in sel])
        dts = np.clip(np.diff(ts, prepend=t0), 1e-4, 0.1)
        return imu_mod.preintegrate(
            _host(dts), _host(np.stack([s[1] for s in sel])),
            _host(np.stack([s[2] for s in sel])),
            torch.ones(len(sel), dtype=torch.bool), _host(self.bias),
            self.imu_params)

    def _imu_predict(self, world_T_ref, vel, pre) -> imu_mod.ImuState:
        """Dead-reckon the body state of a reference pose over `pre`."""
        state = imu_mod.ImuState(
            world_T_body=_host(world_T_ref @ self._inv_btc0),
            vel=_host(vel), bias=_host(self.bias))
        return imu_mod.predict(state, pre, self.imu_params)

    # -- GPS ---------------------------------------------------------------

    def _ingest_gps(self, gps):
        """gps = (ts (G,), lla (G, 3)) geodetic fixes."""
        ts, lla = gps
        for k in range(len(ts)):
            if self.enu_converter is None:
                self.enu_converter = EnuConverter(*lla[k])
            self._gps_buf.append((float(ts[k]),
                                  self.enu_converter.to_enu(*lla[k])))

    def _set_alignment(self, R, V, E):
        t = E.mean(axis=0) - R @ V.mean(axis=0)
        self.E_T_V = np.eye(4, dtype=np.float32)
        self.E_T_V[:3, :3] = R.astype(np.float32)
        self.E_T_V[:3, 3] = t.astype(np.float32)

    def _try_gps_init(self):
        """Align the buffered fixes to interpolated VIO positions (>= 15
        fixes, >= 3 keyframes, >= 8 fixes inside the keyframes' span).
        With a gravity-aligned world both frames share the up axis, so
        E_T_V's rotation is a pure yaw: fit yaw + translation once the
        horizontal spread beats the noise (a full Kabsch on a short
        near-linear track is degenerate about the track direction).
        Without IMU, a full Kabsch once the cloud has 3D shape."""
        if self.gps_initialized or len(self._gps_buf) < 15:
            return
        if len(self.keyframes) < 3:
            return
        kf_ts = np.array([k.timestamp for k in self.keyframes])
        kf_pos = np.stack([k.world_T_ref[:3, 3] for k in self.keyframes])
        pts_v, pts_e = [], []
        for t, enu in self._gps_buf:
            if t < kf_ts[0] or t > kf_ts[-1]:
                continue
            j = int(np.searchsorted(kf_ts, t))
            j = min(max(j, 1), len(kf_ts) - 1)
            a = (t - kf_ts[j - 1]) / max(kf_ts[j] - kf_ts[j - 1], 1e-6)
            pts_v.append((1 - a) * kf_pos[j - 1] + a * kf_pos[j])
            pts_e.append(enu)
        if len(pts_v) < 8:
            return
        V = np.stack(pts_v).astype(np.float64)
        E = np.stack(pts_e).astype(np.float64)
        Vc = V - V.mean(axis=0)
        Ec = E - E.mean(axis=0)
        if self.use_imu and self.imu_initialized:
            # the yaw must be observable above the noise; the window solve
            # never rotates E_T_V (rotation-pinned prior), only
            # _refit_gps_alignment does
            ext = 2.0 * np.linalg.norm(Vc[:, :2], axis=1).max()
            if ext < 3.0 * self.cfg.gps_sigma:
                return
            R = _yaw_rotation(Vc, Ec)
        else:
            # a full Kabsch needs the centred cloud's second singular
            # value above the noise floor
            sv = np.linalg.svd(Vc, compute_uv=False)
            if sv[1] < 3.0 * self.cfg.gps_sigma:
                return
            R = alignment.kabsch(_host(V), _host(E))[0].numpy().astype(
                np.float64)
        self._set_alignment(R, V, E)
        self.gps_initialized = True

    def _refit_gps_alignment(self) -> bool:
        """Re-fit E_T_V against the whole session's GPS-carrying keyframes
        (the fixed-lag counterpart of one alignment variable that every GPS
        factor of the session constrains: the in-window estimate wanders on
        short arcs). Returns True when a re-fit was applied; it also sets
        the fit's diagonal information as the next window's E_T_V prior."""
        if len(self.kf_gps) < 4:
            return False
        inv_btc0 = np.linalg.inv(self._btc0.astype(np.float64))
        by_id = {k.kf_id: k for k in self.keyframes}
        pts_v, pts_e = [], []
        for kf_id, enu in self.kf_gps.items():
            kf = by_id.get(kf_id)
            if kf is None:
                continue
            wTb = np.asarray(kf.world_T_ref, np.float64) @ inv_btc0
            pts_v.append(wTb[:3, 3] + wTb[:3, :3] @ self.gps_lever_arm)
            pts_e.append(np.asarray(enu, np.float64))
        if len(pts_v) < 4:
            return False
        V = np.stack(pts_v)
        E = np.stack(pts_e)
        Vc = V - V.mean(axis=0)
        Ec = E - E.mean(axis=0)
        if self.use_imu and self.imu_initialized:
            # gravity-aligned worlds: yaw only (see _try_gps_init)
            spread2 = float((Vc[:, :2] ** 2).sum(axis=1).mean())
            if spread2 < (2.0 * self.cfg.gps_sigma) ** 2:
                return False
            R = _yaw_rotation(Vc, Ec)
        else:
            sv = np.linalg.svd(Vc, compute_uv=False)
            if sv[1] < 3.0 * self.cfg.gps_sigma:
                return False
            R = alignment.kabsch(_host(V), _host(E))[0].numpy().astype(
                np.float64)
            spread2 = float((Vc ** 2).sum(axis=1).mean())
        self._set_alignment(R, V, E)
        # the fit's information on the right-retract (omega, v) tangent:
        # n / sigma^2 on translation, n spread^2 / sigma^2 on rotation (a
        # yaw perturbation moves a point by about its horizontal radius)
        n = len(pts_v)
        inv_s2 = 1.0 / max(float(self.cfg.gps_sigma) ** 2, 1e-12)
        H = np.zeros((6, 6), np.float32)
        H[:3, :3] = np.eye(3) * n * spread2 * inv_s2
        H[3:, 3:] = np.eye(3) * n * inv_s2
        self._etv_prior_H = np.clip(H, -1e7, 1e7)
        return True

    def _set_kf_gps(self, kf_id: int, enu) -> None:
        self.kf_gps[kf_id] = enu
        if self.graph_log is not None and self.enu_converter is not None:
            self.graph_log.gps(kf_id, enu, self.enu_converter.ref_geodetic)

    def _attach_gps_to_kf(self, kf):
        """Attach the nearest buffered fix within GPS_MERGE_DT to this
        vision keyframe, unless it moved less than gps_min_move from the
        last accepted fix."""
        if not self._gps_buf:
            return
        best, best_t, best_dt = None, None, self.GPS_MERGE_DT
        for t, enu in self._gps_buf:
            dt = abs(t - kf.timestamp)
            if dt < best_dt:
                best, best_t, best_dt = enu, t, dt
        if best is not None:
            prev = self._gps_last_enu
            if (prev is not None
                    and np.linalg.norm(best - prev) < self.cfg.gps_min_move):
                return
            self._set_kf_gps(kf.kf_id, best)
            self._gps_last_enu = best
            self._gps_buf = [(t, e) for (t, e) in self._gps_buf
                             if t != best_t]
        if self.gps_initialized:
            # fixes that can never attach any more (the Kabsch init needs
            # the whole buffer until then): keeps a session without IMU
            # from growing the buffer for ever
            horizon = kf.timestamp - 1.0
            self._gps_buf = [(t, e) for (t, e) in self._gps_buf
                             if t > horizon]

    def _process_gps_dummies(self, t_now: float):
        """IMU-predicted dummy keyframes for fixes that fall between vision
        keyframes: a pure state node that the VIO window links to its
        neighbours by IMU factors and to the fix by a GPS factor. A fix
        within GPS_MERGE_DT of the last keyframe is merged into it."""
        if not (self.use_imu and self.imu_initialized
                and self.gps_initialized and self.keyframes):
            return
        # consumed fixes are tracked by buffer index, not timestamp:
        # distinct fixes may share a timestamp
        consumed: set[int] = set()
        order = sorted(range(len(self._gps_buf)),
                       key=lambda i: self._gps_buf[i][0])
        for bi in order:
            t, enu = self._gps_buf[bi]
            last_kf = self.keyframes[-1]
            if t <= last_kf.timestamp or t > t_now:
                continue
            prev = self._gps_last_enu
            if (prev is not None
                    and np.linalg.norm(enu - prev) < self.cfg.gps_min_move):
                continue  # the fix barely moved
            if t - last_kf.timestamp < self.GPS_MERGE_DT:
                if last_kf.kf_id not in self.kf_gps:
                    self._set_kf_gps(last_kf.kf_id, enu)
                    self._gps_last_enu = enu
                    consumed.add(bi)
                continue
            pre = self._preintegrate_span(last_kf.timestamp, t)
            if pre is None:
                continue  # < 3 IMU samples in the gap: no constraint
            pred = self._imu_predict(
                last_kf.world_T_ref,
                self.kf_vel.get(last_kf.kf_id, np.zeros(3)), pre)
            pose_ref = (pred.world_T_body.numpy() @ self._btc0).astype(
                np.float32)
            kf = Keyframe.dummy(self.kf_counter, t, pose_ref,
                                self.rig.num_cams, last_kf.lm_id.shape[0])
            self.kf_counter += 1
            self.keyframes.append(kf)
            self.stats["gps_dummy_kfs"] = self.stats.get(
                "gps_dummy_kfs", 0) + 1
            self.kf_time[kf.kf_id] = t
            self._kf_preints[kf.kf_id] = (last_kf.kf_id, pre)
            self.kf_vel[kf.kf_id] = pred.vel.numpy()
            self.kf_bias[kf.kf_id] = self.bias.copy()
            self._set_kf_gps(kf.kf_id, enu)
            self._gps_last_enu = enu
            consumed.add(bi)
        if consumed:
            self._gps_buf = [f for i, f in enumerate(self._gps_buf)
                             if i not in consumed]
            # the new state nodes need the optimizer to see them
            self._run_window_ba()
        # prune fixes that can never attach any more
        horizon = self.keyframes[-1].timestamp - 1.0
        self._gps_buf = [(t, e) for (t, e) in self._gps_buf if t > horizon]
