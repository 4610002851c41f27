"""Top-level SLAM pipeline, vision-only (counterpart of mcslam_tpu/slam.py):
the host-side state machine that sequences the device programs (frame
build, fused frame build + tracking, window BA).

A session is `MultiCameraSLAM(rig, config, device=...).process_image(...)`
per frame, then `finalize()` / `trajectory_arrays()` / `write_trajectory()`.
The port covers the rig-depth bootstrap, the fused per-frame program with
its motion fast path, keyframe insertion (tracked landmarks, new
landmarks from rig depth and from two-view matches) and window BA on every
keyframe with deferred write-back. It raises NotImplementedError for
what it does not port yet: loop closure (`vocab`), IMU (`imu_params`,
`imu=`), GPS (`gps_lever_arm`, `gps=`), multi-device BA (`mesh`),
segmentation masks, the final global BA, and the monocular / 17-point
bootstraps that the JAX driver falls back to when a frame has too little
intra-rig depth.

States: NOT_INITIALIZED -> INITIALIZED, with REINITIALIZING after
`max_track_failures` consecutive tracking failures.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Optional

import numpy as np
import torch

from mcslam_tpu_torch.driver_window import WindowBAMixin
from mcslam_tpu_torch.frontend.frame import (
    FrameFeatures, assemble_frame, build_frame,
)
from mcslam_tpu_torch.geometry import lie
from mcslam_tpu_torch.keyframe import Keyframe
from mcslam_tpu_torch.mapping.device_map import DeviceMap
from mcslam_tpu_torch.mapping.landmarks import LandmarkMap
from mcslam_tpu_torch.tracking_kernels import (
    _build_and_track_step, _track_and_map_step, _triangulate_pairs,
)
from mcslam_tpu_torch.utils.profiling import StageTimers

NOT_INITIALIZED = 0
INITIALIZED = 1
REINITIALIZING = 2


@dataclasses.dataclass
class SlamConfig:
    """The JAX package's SlamConfig, field for field with the same
    defaults (see mcslam_tpu/slam.py for the rationale of each value).
    Fields of unported paths (mono / 17-point init, loop closure, global
    BA, IMU, GPS) are kept so that configurations carry over."""

    # matching
    inter_max_dist: int = 64
    inter_ratio: float = 0.85
    min_inter_matches: int = 60
    # pose estimation
    ransac_hyps: int = 512
    ransac_px: float = 5.0
    min_pose_inliers: int = 10
    # search-by-projection gate of inter-frame matching (pixels)
    track_match_radius_px: float = 100.0
    # motion-model fast path: skip the RANSAC portfolio when the refined
    # motion candidate explains >= frac of the landmark matches (and >=
    # min inliers); frac > 1 forces the portfolio
    track_fastpath_frac: float = 0.6
    track_fastpath_min_inliers: int = 30
    # keyframe policy
    kf_translation: float = 0.12
    kf_rotation: float = 0.12
    kf_tracked_ratio: float = 0.4
    # local map tracking
    local_map_landmarks: int = 4096
    local_map_radius_px: float = 18.0
    local_map_max_dist: int = 60
    # mapping
    new_lm_min_parallax_cos: float = 0.99998
    min_z: float = 0.5
    max_z: float = 60.0
    # monocular bootstrap (not ported)
    mono_init_min_disparity_px: float = 25.0
    mono_init_scale: float = 4.0
    # 17-point rig bootstrap (not ported)
    init17_min_inliers: int = 40
    init17_min_landmarks: int = 30
    init17_max_z: float = 400.0
    init17_scale_hi: float = 3.0
    init17_min_baseline_frac: float = 0.5
    # pixel measurement sigma of window BA (sigma2 = px_sigma^2 octave^2)
    px_sigma: float = 1.0
    # MIN_FEATS init condition: wait for > 150 triangulated intra matches
    init_min_feats: bool = False
    # window BA
    window_size: int = 6
    ba_iters: int = 1  # per gate round (x2 rounds), warm windows
    ba_iters_cold: int = 8  # first solve after init / reinit
    ba_obs_capacity: int = 16384
    ba_lm_capacity: int = 2048
    # loop closure (not ported)
    loop_pgo_min_trans: float = 0.2
    loop_pgo_min_rot: float = 0.05
    loop_cooldown_kfs: int = 8
    global_ba: bool = True
    final_global_ba: bool = False
    global_ba_max_kfs: int = 64
    global_ba_lm_capacity: int = 8192
    global_ba_obs_per_kf: int = 512
    global_ba_iters: int = 10
    # failure handling
    max_track_failures: int = 2
    # async backend: defer BA write-back; land a deferred solve this many
    # frames after dispatch (finalize() flushes)
    async_ba: bool = True
    async_ba_land_frames: int = 1
    async_gba: bool = True
    gba_land_frames: int = 4
    # inertial / GPS (not ported)
    imu_init_samples: int = 200
    gps_sigma: float = 0.5
    gps_min_move: float = 0.5


# build_frame's own keyword defaults, used by process_image to parameterize
# the fused frame-build + track program identically to build_frame
_BUILD_FRAME_DEFAULTS = {
    k: v.default
    for k, v in inspect.signature(build_frame).parameters.items()
    if v.default is not inspect.Parameter.empty
}


def _unit_rows(v: np.ndarray) -> np.ndarray:
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-9)


class MultiCameraSLAM(WindowBAMixin):
    def __init__(self, rig, config: SlamConfig = None, seed: int = 0,
                 device=None, vocab=None, loop_config=None, imu_params=None,
                 gps_lever_arm=None, mesh=None):
        """`device`: where the device programs run (default: the rig's,
        which is the card unless the rig was built with device="cpu");
        the rig is moved there. `seed` seeds the torch.Generator the
        RANSAC stages draw from."""
        for name, v in (("vocab (loop closure)", vocab),
                        ("imu_params (visual-inertial)", imu_params),
                        ("gps_lever_arm (GPS)", gps_lever_arm),
                        ("mesh (multi-device BA)", mesh)):
            if v is not None:
                raise NotImplementedError(
                    f"MultiCameraSLAM: {name} is not ported to "
                    f"mcslam_tpu_torch yet")
        self.cfg = config or SlamConfig()
        if self.cfg.final_global_ba:
            raise NotImplementedError(
                "MultiCameraSLAM: final_global_ba (global BA) is not ported "
                "to mcslam_tpu_torch yet")
        self.device = torch.device(device) if device is not None \
            else rig.device
        self.rig = rig.to(self.device)
        # mono guard of the motion fast path: with one camera the
        # prediction is scale-weak, so the full portfolio always runs
        self._fastpath_frac = (
            self.cfg.track_fastpath_frac if rig.num_cams >= 2 else 2.0)
        self.map = LandmarkMap()
        self.dmap = DeviceMap(self.map.capacity, self.device)
        self.keyframes: list[Keyframe] = []
        self.state = NOT_INITIALIZED
        self.track_failures = 0
        self.cur_pose = np.eye(4, dtype=np.float32)
        self.last_pose = np.eye(4, dtype=np.float32)
        self.trajectory: list[tuple[float, np.ndarray]] = []
        self.kf_counter = 0
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.stats = {"frames": 0, "keyframes": 0, "failures": 0, "loops": 0}
        self._ba_warm = False  # adaptive LM budget: cold until a solve lands
        # the first window_size solves after construction / reinit land
        # synchronously (young geometry)
        self._ba_sync_left = self.cfg.window_size
        self.timers = StageTimers()

    # -- helpers ----------------------------------------------------------

    def _prev_kf(self) -> Optional[Keyframe]:
        """The last (vision) keyframe: the tracking reference."""
        return self.keyframes[-1] if self.keyframes else None

    def _to_device(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # host map + device mirror kept in lockstep
    def _map_insert(self, pos, desc, normal, kf_id):
        ids = self.map.insert(pos, desc, normal, kf_id)
        self.dmap.upsert(ids, pos=pos, desc=desc, valid=True, normal=normal)
        return ids

    def _map_update_positions(self, ids, new_pos):
        ok = self.map.update_positions(ids, new_pos)
        ids = np.asarray(ids)
        if ok.any():
            self.dmap.upsert(ids[ok], pos=new_pos[ok])

    def _record_pose(self, timestamp):
        self.trajectory.append((timestamp, self.cur_pose.copy()))

    # -- pipeline stages --------------------------------------------------

    def _initialize(self, frame: FrameFeatures, timestamp: float) -> bool:
        """Bootstrap from rig depth: triangulated intra-rig matches become
        the seed map, anchored at the current pose."""
        pose = self.cur_pose  # identity or reinit seed
        kf = Keyframe(self.kf_counter, timestamp, pose, frame)
        n3d = int(kf.im_has_depth.sum())
        if self.cfg.init_min_feats:
            if n3d <= 150:
                return False
        elif n3d < 30:
            lever = np.linalg.norm(
                self.rig.ref_T_cam[:, :3, 3].cpu().numpy(), axis=-1)
            path = ("17-point (non-central relative pose)"
                    if self.rig.num_cams >= 2 and lever.max() > 1e-6
                    else "monocular (essential-matrix)")
            raise NotImplementedError(
                f"MultiCameraSLAM: the frame has {n3d} triangulated intra-rig "
                f"matches (< 30), so the JAX driver would bootstrap with the "
                f"{path} initialization, which is not ported to "
                f"mcslam_tpu_torch yet")
        sel = np.nonzero(kf.im_has_depth)[0]
        X_world = kf.im_point3d[sel] @ pose[:3, :3].T + pose[:3, 3]
        ids = self._map_insert(X_world, kf.im_desc[sel],
                               _unit_rows(X_world - pose[:3, 3]), kf.kf_id)
        kf.lm_id[sel] = ids
        kf.lm_dirty()
        self.keyframes.append(kf)
        self.kf_counter += 1
        self.state = INITIALIZED
        self.stats["keyframes"] += 1
        return True

    def _local_map_candidates(self):
        """Landmark ids seen by recent keyframes (covisible set)."""
        ids = [kf.lm_id[kf.lm_id >= 0]
               for kf in self.keyframes[-self.cfg.window_size:]]
        if not ids:
            return np.zeros(0, np.int32)
        ids = np.unique(np.concatenate(ids))
        ids = ids[self.map.valid[ids]]
        return ids[: self.cfg.local_map_landmarks]

    def _candidates_on_device(self):
        """(cand_ids (Lm,), cand_valid (Lm,)) padded to local_map_landmarks,
        uploaded as one int32 buffer."""
        cand = self._local_map_candidates()
        L = self.cfg.local_map_landmarks
        buf = np.zeros(2 * L, np.int32)
        buf[:len(cand)] = cand
        buf[L:L + len(cand)] = 1
        d = self._to_device(buf)
        return d[:L], d[L:] > 0

    def _predict_pose(self) -> np.ndarray:
        """Constant-velocity motion model T_pred = T_k (T_{k-1}^-1 T_k)."""
        delta = np.linalg.inv(self.last_pose) @ self.cur_pose
        return (self.cur_pose @ delta).astype(np.float32)

    def _track_frame_fused(self, frame: FrameFeatures, kf: Keyframe,
                           packed=None):
        """Inter-frame tracking + local-map tracking as one device program
        and one fetch. Returns (ok, pose, (m_ok, m_idx), lm_of_match,
        lm_match, inliers); when ok is False the local-map section is
        ignored. `packed`: an already-dispatched result buffer of the same
        layout (the fused program of process_image) to parse instead."""
        cfg = self.cfg
        if packed is None:
            cand_ids, cand_valid = self._candidates_on_device()
            with self.timers.span("track.dispatch"):
                packed = _track_and_map_step(
                    self._gen, frame.im_desc, frame.im_valid,
                    frame.im_uv_ref, frame.im_anchor_cam, frame.im_sigma2,
                    frame.im_point3d, frame.im_has_depth, *kf.device_desc(),
                    kf.d_lm_id(), self.dmap.pos, self.dmap.valid,
                    self.dmap.desc, self.dmap.normal, cand_ids, cand_valid,
                    self.rig.cam_T_ref, self.rig.fxycxy,
                    self._to_device(self._predict_pose()),
                    cfg.ransac_hyps, cfg.ransac_px, cfg.inter_max_dist,
                    cfg.inter_ratio, self.rig.image_size,
                    cfg.local_map_radius_px, cfg.local_map_max_dist,
                    cfg.track_match_radius_px, self._fastpath_frac,
                    cfg.track_fastpath_min_inliers,
                )
        with self.timers.span("track.fetch"):
            v = packed.cpu().numpy()
        M = frame.im_valid.shape[0]
        n_inl, n_matches, n_lm, rr_ok, fastpath = v[16:21]
        self.stats["track_dispatch"] = self.stats.get("track_dispatch", 0) + 1
        self.stats["track_fastpath"] = (
            self.stats.get("track_fastpath", 0) + int(fastpath > 0.5))
        m_ok = v[21:21 + M] > 0.5
        m_idx = v[21 + M:21 + 2 * M].astype(np.int32)
        lm_of_match = v[21 + 2 * M:21 + 3 * M].astype(np.int32)
        off = 21 + 3 * M
        lm_pose = v[off:off + 16].reshape(4, 4).astype(np.float32)
        lm_match = v[off + 16:off + 16 + M].astype(np.int32)
        inliers = v[off + 16 + M:] > 0.5
        ok = not (int(n_matches) < cfg.min_inter_matches
                  or int(n_lm) < cfg.min_pose_inliers or rr_ok < 0.5
                  or int(n_inl) < cfg.min_pose_inliers)
        return (ok, lm_pose if ok else None, (m_ok, m_idx), lm_of_match,
                lm_match, inliers)

    def _need_keyframe(self, pose, n_tracked, n_tracked_prev) -> bool:
        kf = self._prev_kf()
        d = np.linalg.norm(pose[:3, 3] - kf.world_T_ref[:3, 3])
        # small host math on CPU tensors: on the card each call would sync
        dR = float(torch.linalg.vector_norm(lie.so3_log(torch.as_tensor(
            kf.world_T_ref[:3, :3].T @ pose[:3, :3], dtype=torch.float32))))
        moved = d > self.cfg.kf_translation or dR > self.cfg.kf_rotation
        weak = n_tracked < self.cfg.kf_tracked_ratio * max(n_tracked_prev, 1)
        return moved or weak

    def _insert_keyframe(self, frame: FrameFeatures, timestamp, pose,
                         lm_match, inliers, inter=None):
        kf = Keyframe(self.kf_counter, timestamp, pose, frame)
        # attach tracked landmarks
        sel = (lm_match >= 0) & inliers
        kf.lm_id[sel] = lm_match[sel]
        kf.lm_dirty()
        self.map.add_observation(
            lm_match[sel], kf.kf_id,
            _unit_rows(self.map.pos[lm_match[sel]] - pose[:3, 3]))
        # keep the mirror's viewing normal at the running average (the
        # local-map cone gate reads it)
        if sel.any():
            self.dmap.upsert(lm_match[sel],
                             normal=self.map.normal[lm_match[sel]])

        # new landmarks from rig depth (unmatched intra features with 3D)
        new_sel = kf.im_has_depth & (kf.lm_id < 0) & kf.im_valid
        if new_sel.sum() > 0:
            X_world = kf.im_point3d[new_sel] @ pose[:3, :3].T + pose[:3, 3]
            ids = self._map_insert(X_world, kf.im_desc[new_sel],
                                   _unit_rows(X_world - pose[:3, 3]),
                                   kf.kf_id)
            kf.lm_id[np.nonzero(new_sel)[0]] = ids
            kf.lm_dirty()

        # two-view landmarks from inter-frame matches without rig depth
        if inter is not None:
            m_ok, m_idx, prev_kf = inter
            cand = m_ok & (kf.lm_id < 0) & ~kf.im_has_depth & kf.im_valid
            cand &= prev_kf.lm_id[m_idx] < 0  # new in both frames
            if int(cand.sum()) >= 5:
                M = len(cand)
                a1 = kf.im_anchor_cam
                a0 = prev_kf.im_anchor_cam[m_idx]
                ref_T_cam = self.rig.ref_T_cam.cpu().numpy()
                wTc = np.stack([prev_kf.world_T_ref @ ref_T_cam[a0],
                                pose @ ref_T_cam[a1]], axis=1)
                fmat = self.rig.fxycxy.cpu().numpy()
                f32 = torch.float32
                X, tri_ok = _triangulate_pairs(
                    torch.as_tensor(wTc, dtype=f32),
                    torch.as_tensor(np.stack(
                        [prev_kf.im_uv[m_idx], kf.im_uv], axis=1), dtype=f32),
                    torch.as_tensor(np.stack([fmat[a0], fmat[a1]], axis=1)),
                    torch.as_tensor(np.repeat(cand[:, None], 2, axis=1)),
                    torch.ones(M, 2))
                good = tri_ok.numpy() & cand
                if good.sum() > 0:
                    gsel = np.nonzero(good)[0]
                    Xg = X.numpy()[gsel]
                    ids = self._map_insert(Xg, kf.im_desc[gsel],
                                           _unit_rows(Xg - pose[:3, 3]),
                                           kf.kf_id)
                    kf.lm_id[gsel] = ids
                    prev_kf.lm_id[m_idx[gsel]] = ids
                    kf.lm_dirty()
                    prev_kf.lm_dirty()

        self.keyframes.append(kf)
        self.kf_counter += 1
        self.stats["keyframes"] += 1
        # keyframes that left the tracking horizon release their device
        # copies; host arrays stay for window BA
        for old in self.keyframes[: -(self.cfg.window_size + 2)]:
            old.release_device()
        with self.timers.span("window_ba"):
            self._run_window_ba()

    # -- main entry -------------------------------------------------------

    def process_image(self, imgs, timestamp: float, imu=None, gps=None,
                      seg_masks=None, extract_cfg=None) -> dict:
        """One SLAM step straight from (C, H, W) images (float in [0, 1] or
        uint8; numpy or a tensor). In INITIALIZED steady state the frame
        build and the tracking step run as one fused device program with
        one packed fetch (_build_and_track_step); otherwise build_frame +
        process_frame. extract_cfg: build_frame keyword overrides
        (num_points, num_levels, max_intra, angle_bins, route, ...)."""
        if seg_masks is not None:
            raise NotImplementedError(
                "process_image: segmentation masks are not ported to "
                "mcslam_tpu_torch yet")
        self._refuse_sensors(imu, gps)
        cfg = self.cfg
        imgs = torch.as_tensor(imgs, device=self.device)
        ecfg = dict(extract_cfg or {})
        if self.state != INITIALIZED or not self.keyframes:
            frame = build_frame(imgs, self.rig, **ecfg)
            return self.process_frame(frame, timestamp)
        # a matured deferred solve lands before the fused dispatch (the
        # program consumes the predicted pose and the map mirror)
        if (getattr(self, "_pending_ba", None) is not None
                and self.stats["frames"] + 1
                - getattr(self, "_ba_dispatch_frame", 0)
                >= cfg.async_ba_land_frames):
            self._finish_pending_ba()
        kf_prev = self._prev_kf()
        cand_ids, cand_valid = self._candidates_on_device()
        kw = dict(_BUILD_FRAME_DEFAULTS)
        kw.update(ecfg)
        with self.timers.span("track.dispatch"):
            kps, xy_ud, groups, tri, packed = _build_and_track_step(
                self._gen, imgs, self.rig, *kf_prev.device_desc(),
                kf_prev.d_lm_id(), self.dmap.pos, self.dmap.valid,
                self.dmap.desc, self.dmap.normal, cand_ids, cand_valid,
                self._to_device(self._predict_pose()),
                num_points=kw["num_points"], num_levels=kw["num_levels"],
                fast_threshold=kw["fast_threshold"],
                min_threshold=kw["min_threshold"], max_intra=kw["max_intra"],
                min_z=kw["min_z"], max_z=kw["max_z"],
                angle_bins=kw["angle_bins"], num_hyp=cfg.ransac_hyps,
                px=cfg.ransac_px, max_dist=cfg.inter_max_dist,
                ratio=cfg.inter_ratio, image_wh=self.rig.image_size,
                lm_radius=cfg.local_map_radius_px,
                lm_max_dist=cfg.local_map_max_dist,
                gate_px=cfg.track_match_radius_px,
                fastpath_frac=self._fastpath_frac,
                fastpath_min=cfg.track_fastpath_min_inliers,
                route=kw["route"],
            )
        frame = assemble_frame(kps, xy_ud, groups, tri)
        return self.process_frame(frame, timestamp, _packed=packed)

    @staticmethod
    def _refuse_sensors(imu, gps):
        if imu is not None or gps is not None:
            raise NotImplementedError(
                "MultiCameraSLAM: IMU and GPS input is not ported to "
                "mcslam_tpu_torch yet")

    def process_frame(self, frame: FrameFeatures, timestamp: float,
                      imu=None, gps=None, _packed=None) -> dict:
        """One SLAM step on an already-built FrameFeatures; returns this
        frame's stats. `_packed`: internal, a pre-dispatched tracking
        buffer of the fused program (process_image)."""
        self._refuse_sensors(imu, gps)
        cfg = self.cfg
        self.stats["frames"] += 1
        info = {"keyframe": False, "tracked": 0, "state": self.state}

        if self.state != INITIALIZED:
            info["initialized"] = self._initialize(frame, timestamp)
            self._record_pose(timestamp)
            return info

        # land a matured deferred solve before tracking, so tracking sees
        # the corrected map
        if (getattr(self, "_pending_ba", None) is not None
                and self.stats["frames"]
                - getattr(self, "_ba_dispatch_frame", 0)
                >= cfg.async_ba_land_frames):
            self._finish_pending_ba()

        kf_prev = self._prev_kf()
        with self.timers.span("track"):
            ok, pose, (m_ok, m_idx), _, lm_match, inliers = (
                self._track_frame_fused(frame, kf_prev, packed=_packed))
        if not ok and getattr(self, "_pending_ba", None) is not None:
            # async rescue: land the deferred corrections and retry once
            self._finish_pending_ba()
            with self.timers.span("track"):
                ok, pose, (m_ok, m_idx), _, lm_match, inliers = (
                    self._track_frame_fused(frame, kf_prev))
        if not ok:
            self.track_failures += 1
            self.stats["failures"] += 1
            if self.track_failures >= cfg.max_track_failures:
                self.state = REINITIALIZING
                self.track_failures = 0
                self._ba_warm = False
                self._ba_sync_left = cfg.window_size
            self._record_pose(timestamp)
            info["state"] = self.state
            return info
        self.track_failures = 0
        n_tracked = int(((lm_match >= 0) & inliers).sum())
        prev_tracked = int((kf_prev.lm_id >= 0).sum())
        if (n_tracked < cfg.kf_tracked_ratio * max(prev_tracked, 1)
                and getattr(self, "_pending_ba", None) is not None):
            # weak-track rescue: land the deferred corrections, re-track
            self._finish_pending_ba()
            with self.timers.span("track"):
                ok2, pose2, mm2, _, lm_match2, inl2 = (
                    self._track_frame_fused(frame, kf_prev))
            if ok2:
                pose, (m_ok, m_idx) = pose2, mm2
                lm_match, inliers = lm_match2, inl2
                n_tracked = int(((lm_match >= 0) & inliers).sum())
        info["tracked"] = n_tracked

        self.last_pose = self.cur_pose
        self.cur_pose = pose
        if self._need_keyframe(pose, n_tracked, prev_tracked):
            with self.timers.span("keyframe"):
                self._insert_keyframe(frame, timestamp, pose, lm_match,
                                      inliers, inter=(m_ok, m_idx, kf_prev))
            info["keyframe"] = True
        self._record_pose(timestamp)
        return info

    # -- outputs ----------------------------------------------------------

    def finalize(self):
        """Flush asynchronous backend work (call before reading poses/map)."""
        self._finish_pending_ba()

    def trajectory_arrays(self):
        self.finalize()
        ts = np.array([t for t, _ in self.trajectory])
        poses = np.stack([p for _, p in self.trajectory])
        return ts, poses

    def write_trajectory(self, path):
        from mcslam_tpu_torch.utils import tum

        ts, poses = self.trajectory_arrays()
        tum.write_tum(path, ts, poses)
