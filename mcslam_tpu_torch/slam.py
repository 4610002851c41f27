"""Top-level SLAM pipeline (counterpart of mcslam_tpu/slam.py): the
host-side state machine that sequences the device programs (frame build,
fused frame build + tracking, window BA).

A session is `MultiCameraSLAM(rig, config, device=..., vocab=...,
loop_config=..., imu_params=..., gps_lever_arm=...).process_image(imgs, t,
imu=(ts, gyro, accel), gps=(ts, lla), seg_masks=...)` per frame, then
`finalize()` / `trajectory_arrays()` / `write_trajectory()`. The port
covers the three vision-only bootstraps (rig depth; the 17-point
non-central relative pose and the monocular essential matrix for frames
with too little intra-rig depth, each holding a pending anchor frame),
the fused per-frame program
with its motion fast path, the segmentation-mask veto, keyframe insertion
(tracked landmarks, new landmarks from rig depth and from two-view
matches) and window BA on every keyframe with deferred write-back; with
`imu_params`, gravity initialization, IMU-predicted tracking and the
visual-inertial window solve (driver_window, backend/ba_vio); with
`gps_lever_arm`, GPS factors, the E_T_V alignment and GPS dummy keyframes
(driver_sensors); with `vocab`, loop detection on every keyframe
(loop/detector) and loop closing with PGO, the loop-window BA and global
BA (driver_loop); `final_global_ba`, one global BA at finalize();
`enable_relocalization`, a map-reuse session against a saved map
(loop/reloc, loop/tracking); `mesh` (parallel/mesh.Mesh), the window
solves observation-sharded and the global solve landmark-sharded over the
mesh (parallel/sharded_ba).

On the card (`cuda_graphs`, on by default there) the steady-state fused
frame program and the window solve replay captured CUDA graphs
(utils/graphs), with the fast-path decision on the device; bootstrap,
relocalization, segmentation masks and the frames before IMU gravity
alignment stay eager, as do all CPU sessions.

States: NOT_INITIALIZED -> INITIALIZED, with REINITIALIZING after
`max_track_failures` consecutive tracking failures.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Optional

import numpy as np
import torch

from mcslam_tpu_torch.driver_loop import LoopClosingMixin
from mcslam_tpu_torch.driver_sensors import SensorsMixin
from mcslam_tpu_torch.driver_window import WindowBAMixin
from mcslam_tpu_torch.frontend import ransac, seventeen
from mcslam_tpu_torch.frontend.frame import (
    FrameFeatures, assemble_frame, build_frame,
)
from mcslam_tpu_torch.geometry import lie
from mcslam_tpu_torch.keyframe import Keyframe
from mcslam_tpu_torch.mapping.device_map import DeviceMap
from mcslam_tpu_torch.mapping.landmarks import LandmarkMap
from mcslam_tpu_torch.parallel.mesh import Mesh
from mcslam_tpu_torch.tracking_kernels import (
    _build_and_track_step, _match_descriptors, _mutual_match,
    _track_and_map_step, _triangulate_pairs, _triangulate_pairs_far,
)
from mcslam_tpu_torch.utils import graphs
from mcslam_tpu_torch.utils.profiling import StageTimers

NOT_INITIALIZED = 0
INITIALIZED = 1
REINITIALIZING = 2


@dataclasses.dataclass
class SlamConfig:
    """The JAX package's SlamConfig, field for field with the same
    defaults (see mcslam_tpu/slam.py for the rationale of each value)."""

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
    # monocular bootstrap
    mono_init_min_disparity_px: float = 25.0
    mono_init_scale: float = 4.0
    # 17-point rig bootstrap
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
    # loop closure: the PGO bend runs only where the trajectory disagrees
    # with the verified loop by more than this; closures are suppressed for
    # loop_cooldown_kfs keyframes after one fires
    loop_pgo_min_trans: float = 0.2
    loop_pgo_min_rot: float = 0.05
    loop_cooldown_kfs: int = 8
    # global BA after a closure's bend, and one at finalize()
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
    # inertial: samples collected before gravity alignment
    imu_init_samples: int = 200
    # GPS position sigma [m], and the least ENU move [m] before a new fix
    # is accepted (car scale; small rigs lower it)
    gps_sigma: float = 0.5
    gps_min_move: float = 0.5


# build_frame's own keyword defaults, used by process_image to parameterize
# the fused frame-build + track program identically to build_frame
_BUILD_FRAME_DEFAULTS = {
    k: v.default
    for k, v in inspect.signature(build_frame).parameters.items()
    if v.default is not inspect.Parameter.empty and k != "seg_masks"
}


def _split_track_inputs(buf, L: int):
    """A _track_inputs_host buffer (on the host or the device) -> views
    (cand_ids (L,), cand_valid (L,), predicted pose (4, 4) float32)."""
    return (buf[:L], buf[L:2 * L] > 0,
            buf[2 * L:].view(torch.float32).reshape(4, 4))


def _unit_rows(v: np.ndarray) -> np.ndarray:
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-9)


class MultiCameraSLAM(LoopClosingMixin, WindowBAMixin, SensorsMixin):
    def __init__(self, rig, config: SlamConfig = None, seed: int = 0,
                 device=None, vocab=None, loop_config=None, imu_params=None,
                 gps_lever_arm=None, mesh=None):
        """`device`: where the device programs run (default: the rig's,
        which is the card unless the rig was built with device="cpu");
        the rig is moved there. `seed` seeds the torch.Generator the
        RANSAC stages draw from. `vocab` (loop.vocab.Vocabulary) turns on
        loop closure with `loop_config` (loop.detector.LoopConfig), its
        RANSAC seeded seed + 1; `imu_params` (backend.imu.ImuParams) the
        visual-inertial path, `gps_lever_arm` (body -> GPS antenna, metres)
        the GPS factors; `mesh` (parallel/mesh.Mesh) the window and global
        solves over a device mesh."""
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, not "
                            f"{type(mesh).__name__}")
        self.mesh = mesh
        self.cfg = config or SlamConfig()
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
        # on the card, the steady-state frame step and the window solve
        # replay CUDA graphs (utils/graphs), one program cache each (their
        # own memory pools: the solve runs on a side stream beside the
        # frames); False runs every op eagerly, as on the CPU
        self.cuda_graphs = self.device.type == "cuda"
        self._frame_programs = graphs.ProgramCache(self.device, self._gen)
        self._solve_programs = graphs.ProgramCache(self.device)
        self.stats = {"frames": 0, "keyframes": 0, "failures": 0, "loops": 0}
        self._ba_warm = False  # adaptive LM budget: cold until a solve lands
        # the first window_size solves after construction / reinit land
        # synchronously (young geometry)
        self._ba_sync_left = self.cfg.window_size
        self.timers = StageTimers()
        # optional streaming graph_logs writer (attach_graph_log)
        self.graph_log = None
        # map-reuse session state (enable_relocalization)
        self.relocalizer = None
        self.fast_tracker = None
        self._reloc_localized = False
        self._reloc_delta = np.eye(4, dtype=np.float32)
        self._reloc_prev_ts = None  # the last relocalized frame's time
        self._reloc_vel = np.zeros(3, np.float32)  # world-frame velocity
        self.looper = None
        if vocab is not None:
            from mcslam_tpu_torch.loop.detector import LoopCloser

            self.looper = LoopCloser(vocab, self.rig, loop_config,
                                     seed=seed + 1)
        # host copies of the rig's body_T_cam (read every keyframe)
        self._btc = self.rig.body_T_cam.cpu().numpy()
        self._btc0 = self._btc[0]
        self._inv_btc0 = np.linalg.inv(self._btc0)

        # inertial state
        self.use_imu = imu_params is not None
        self.imu_params = imu_params
        self.imu_initialized = not self.use_imu
        self._imu_buf = []  # (ts, gyro, accel) pending samples
        self._imu_init_buf = []  # stationary samples for gravity init
        self.bias = np.zeros(6, np.float32)
        self.kf_vel: dict[int, np.ndarray] = {}  # kf_id -> velocity
        self.kf_bias: dict[int, np.ndarray] = {}
        self.kf_time: dict[int, float] = {}
        self._kf_preints: dict[int, tuple] = {}  # kf_id -> (prev id, preint)
        self._last_track_ts = None  # the IMU prediction's span starts here
        self._pred_span = None
        self._track_vel = np.zeros(3, np.float32)

        # GPS state
        self.use_gps = gps_lever_arm is not None
        self.gps_lever_arm = (np.zeros(3, np.float32) if gps_lever_arm is None
                              else np.asarray(gps_lever_arm, np.float32))
        self.enu_converter = None
        self.gps_initialized = False
        self.E_T_V = np.eye(4, dtype=np.float32)  # ENU <- VIO world
        self._gps_buf = []  # (t, enu) pending fixes
        self._gps_last_enu = None
        self.kf_gps: dict[int, np.ndarray] = {}  # kf_id -> attached fix

    # -- helpers ----------------------------------------------------------

    def _prev_kf(self) -> Optional[Keyframe]:
        """The last vision keyframe, the tracking reference (GPS dummy
        keyframes interleave in the list)."""
        for kf in reversed(self.keyframes):
            if not kf.is_dummy:
                return kf
        return None

    def _seed_inertial(self, kfs_and_times):
        """Zero velocity and the current bias for bootstrap keyframes."""
        if self.use_imu:
            for kf, t in kfs_and_times:
                self.kf_time[kf.kf_id] = t
                self.kf_vel[kf.kf_id] = np.zeros(3, np.float32)
                self.kf_bias[kf.kf_id] = self.bias.copy()

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

    def _map_delete(self, ids):
        self.map.delete(ids)
        self.dmap.remove(np.asarray(ids, np.int32))

    def _record_pose(self, timestamp):
        self.trajectory.append((timestamp, self.cur_pose.copy()))

    # -- pipeline stages --------------------------------------------------

    def _initialize(self, frame: FrameFeatures, timestamp: float) -> bool:
        """Bootstrap: a frame with >= 30 triangulated intra-rig matches
        seeds the map from rig depth at the current pose; with fewer, a
        rig with a lever arm takes the 17-point two-frame bootstrap and
        any other rig the monocular one (mcslam_tpu/slam.py:331-353)."""
        n3d = int(frame.im_has_depth.sum())
        if self.cfg.init_min_feats:
            if n3d <= 150:
                return False
        elif n3d < 30:
            if self.rig.num_cams >= 2 and seventeen.is_noncentral(self.rig):
                return self._initialize_rig_17pt(frame, timestamp)
            return self._initialize_mono(frame, timestamp)
        pose = self.cur_pose  # identity or reinit seed
        kf = Keyframe(self.kf_counter, timestamp, pose, frame)
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
        self._seed_inertial([(kf, timestamp)])
        return True

    def _anchor_matches(self, frame: FrameFeatures, pf: FrameFeatures):
        """Mutual descriptor matches of the current frame's intra groups
        to the pending anchor's -> (ok (M,), idx (M,)) on the host."""
        cfg = self.cfg
        dist = _match_descriptors(frame.im_desc, frame.im_valid, pf.im_desc,
                                  pf.im_valid)
        res = _mutual_match(dist, frame.im_valid, pf.im_valid,
                            cfg.inter_max_dist, cfg.inter_ratio)
        v = torch.stack([res.ok.to(torch.int32), res.idx]).cpu().numpy()
        return v[0] > 0, v[1]

    def _seed_two_view(self, pf, pts_t, pose0, frame, timestamp, pose1, X,
                       good, idx):
        """Both frames of a two-view bootstrap become keyframes; the good
        triangulated matches become landmarks seen by both; then the
        two-view BA over the init pair polishes the seed map."""
        kf0 = Keyframe(self.kf_counter, pts_t, pose0, pf)
        self.kf_counter += 1
        kf1 = Keyframe(self.kf_counter, timestamp, pose1, frame)
        self.kf_counter += 1
        sel = np.nonzero(good)[0]
        ids = self._map_insert(X[sel], kf1.im_desc[sel],
                               _unit_rows(X[sel] - pose1[:3, 3]), kf1.kf_id)
        kf1.lm_id[sel] = ids
        kf0.lm_id[idx[sel]] = ids
        kf0.lm_dirty()
        kf1.lm_dirty()
        self.keyframes.extend([kf0, kf1])
        self.state = INITIALIZED
        self.stats["keyframes"] += 2
        self.cur_pose = pose1.astype(np.float32)
        self._run_window_ba()
        self.cur_pose = kf1.world_T_ref.copy()
        self._seed_inertial([(kf0, pts_t), (kf1, timestamp)])

    def _initialize_mono(self, frame: FrameFeatures, timestamp: float) -> bool:
        """Two-view monocular bootstrap (mcslam_tpu/slam.py:376-477):
        essential-matrix RANSAC between the pending anchor frame and the
        current one, two-view triangulation of the inliers, median-depth
        scale normalization. The anchor is kept while the parallax grows
        and restarted from the current frame when matching or the
        geometry fails."""
        pending = getattr(self, "_mono_pending", None)
        if pending is None:
            self._mono_pending = (frame, timestamp, self.cur_pose.copy())
            return False
        pf, pts_t, p_pose = pending
        ok, idx = self._anchor_matches(frame, pf)
        if ok.sum() < 80:
            # lost the anchor frame: restart from the current one
            self._mono_pending = (frame, timestamp, self.cur_pose.copy())
            return False
        f0 = self.rig.fxycxy[0].cpu().numpy()
        uv1 = frame.im_uv_ref.cpu().numpy()
        uv0 = pf.im_uv_ref.cpu().numpy()[idx]
        # baseline gate: keep the anchor until the parallax suffices
        med_disp = float(np.median(np.linalg.norm((uv1 - uv0)[ok], axis=-1)))
        if med_disp < self.cfg.mono_init_min_disparity_px:
            return False
        xn1 = (uv1 - f0[2:]) / f0[:2]
        xn0 = (uv0 - f0[2:]) / f0[:2]
        f32 = np.float32
        er = ransac.ransac_essential(
            self._gen, self._to_device(xn0.astype(f32)),
            self._to_device(xn1.astype(f32)), self._to_device(ok),
            thresh_n=2.0 / float(f0[0]), min_inliers=50)
        if not bool(er.ok):
            self._mono_pending = (frame, timestamp, self.cur_pose.copy())
            return False
        # cur_T_prev with unit translation; world frame anchored at prev
        rel = er.rel_T.cpu().numpy()  # cam1_T_cam0
        pose0 = p_pose
        pose1 = pose0 @ np.linalg.inv(rel)
        inl = er.inliers.cpu().numpy() & ok
        M = len(ok)
        wTc = np.stack([np.broadcast_to(pose0, (M, 4, 4)),
                        np.broadcast_to(pose1, (M, 4, 4))], axis=1)
        X, tri_ok = _triangulate_pairs(
            torch.as_tensor(wTc, dtype=torch.float32),
            torch.as_tensor(np.stack([uv0, uv1], axis=1), dtype=torch.float32),
            torch.as_tensor(np.broadcast_to(f0, (M, 2, 4)).copy()),
            torch.as_tensor(np.repeat(inl[:, None], 2, axis=1)),
            torch.ones(M, 2))
        X = X.numpy()
        good = tri_ok.numpy() & inl
        if good.sum() < 50:
            self._mono_pending = (frame, timestamp, self.cur_pose.copy())
            return False
        # scale: median depth (in the prev camera) -> mono_init_scale units
        depths = (np.linalg.inv(pose0) @ np.concatenate(
            [X, np.ones((M, 1), np.float32)], axis=1).T).T[:, 2]
        scale = self.cfg.mono_init_scale / max(np.median(depths[good]), 1e-6)
        X = X * scale
        pose1[:3, 3] = pose0[:3, 3] + (pose1[:3, 3] - pose0[:3, 3]) * scale
        self._mono_pending = None
        self._seed_two_view(pf, pts_t, pose0, frame, timestamp, pose1, X,
                            good, idx)
        return True

    def _initialize_rig_17pt(self, frame: FrameFeatures,
                             timestamp: float) -> bool:
        """Two-frame rig bootstrap by non-central relative pose
        (mcslam_tpu/slam.py:479-587): when the scene is too distant for
        intra-rig triangulation, the 17-point family recovers prev_T_cur
        with METRIC translation from 2D-2D matches, and the seed map comes
        from two-frame triangulation with a relaxed depth ceiling. The
        anchor is kept while the baseline grows and restarted from the
        current frame when matching or the geometry fails."""
        cfg = self.cfg
        pending = getattr(self, "_pending17", None)
        if pending is None:
            self._pending17 = (frame, timestamp, self.cur_pose.copy())
            return False
        pf, pts_t, p_pose = pending
        ok, idx = self._anchor_matches(frame, pf)
        if ok.sum() < cfg.min_inter_matches:
            self._pending17 = (frame, timestamp, self.cur_pose.copy())
            return False
        d_idx = self._to_device(idx).long()
        f1, o1 = seventeen.plucker_rays(pf.im_uv_ref[d_idx],
                                        pf.im_anchor_cam[d_idx], self.rig)
        f2, o2 = seventeen.plucker_rays(frame.im_uv_ref, frame.im_anchor_cam,
                                        self.rig)
        fmat = self.rig.fxycxy.cpu().numpy()
        thr = float(2.0 * (1.0 - np.cos(3.0 / float(np.mean(fmat[:, 0])))))
        sr = seventeen.ransac_seventeen(
            self._gen, f1, o1, f2, o2, self._to_device(ok),
            angle_thresh=thr, min_inliers=cfg.init17_min_inliers,
            scale_hi=cfg.init17_scale_hi)
        if not bool(sr.ok):
            self._pending17 = (frame, timestamp, self.cur_pose.copy())
            return False
        rel = sr.rel_T.cpu().numpy()  # prev_T_cur
        # baseline gate: keep the anchor while the baseline grows
        if (np.linalg.norm(rel[:3, 3])
                < cfg.init17_min_baseline_frac * cfg.kf_translation):
            return False
        pose0 = p_pose
        pose1 = (pose0 @ rel).astype(np.float32)
        inl = sr.inliers.cpu().numpy() & ok
        M = len(ok)
        a1 = pf.im_anchor_cam.cpu().numpy()[idx]
        a2 = frame.im_anchor_cam.cpu().numpy()
        uv1 = pf.im_uv_ref.cpu().numpy()[idx]
        uv2 = frame.im_uv_ref.cpu().numpy()
        ref_T_cam = self.rig.ref_T_cam.cpu().numpy()
        wTc = np.stack([pose0 @ ref_T_cam[a1], pose1 @ ref_T_cam[a2]], axis=1)
        X, tri_ok = _triangulate_pairs_far(
            torch.as_tensor(wTc, dtype=torch.float32),
            torch.as_tensor(np.stack([uv1, uv2], axis=1), dtype=torch.float32),
            torch.as_tensor(np.stack([fmat[a1], fmat[a2]], axis=1)),
            torch.as_tensor(np.repeat(inl[:, None], 2, axis=1)),
            torch.ones(M, 2), cfg.min_z, cfg.init17_max_z)
        X = X.numpy()
        good = tri_ok.numpy() & inl
        if good.sum() < cfg.init17_min_landmarks:
            self._pending17 = (frame, timestamp, self.cur_pose.copy())
            return False
        self._pending17 = None
        self.stats["init_17pt"] = self.stats.get("init_17pt", 0) + 1
        self._seed_two_view(pf, pts_t, pose0, frame, timestamp, pose1, X,
                            good, idx)
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

    def _track_inputs_host(self) -> np.ndarray:
        """The tracking step's host-made inputs as one int32 buffer of
        2 L + 16 words (L = local_map_landmarks): the local-map candidate
        ids padded to L, their validity, and the predicted pose's float32
        words; _split_track_inputs takes it apart."""
        cand = self._local_map_candidates()
        L = self.cfg.local_map_landmarks
        buf = np.zeros(2 * L + 16, np.int32)
        buf[:len(cand)] = cand
        buf[L:L + len(cand)] = 1
        buf[2 * L:] = np.ascontiguousarray(
            self._predict_pose(), np.float32).reshape(16).view(np.int32)
        return buf

    def _track_inputs_on_device(self):
        """(cand_ids (L,), cand_valid (L,), predicted pose (4, 4)) from one
        upload of _track_inputs_host."""
        return _split_track_inputs(self._to_device(self._track_inputs_host()),
                                   self.cfg.local_map_landmarks)

    def _predict_pose(self) -> np.ndarray:
        """The pose prediction of the projection gate and the portfolio's
        motion candidate: with the IMU gravity-initialized, dead reckoning
        by the preintegrated samples since the last tracked frame (constant
        velocity misses across low-rate-vision gaps under acceleration);
        otherwise the constant-velocity model T_k (T_{k-1}^-1 T_k)."""
        span = self._pred_span
        if (self.use_imu and self.imu_initialized and span is not None
                and span[1] > span[0]):
            pre = self._preintegrate_span(span[0], span[1])
            if pre is not None:
                pred = self._imu_predict(self.cur_pose, self._track_vel, pre)
                return (pred.world_T_body.numpy() @ self._btc0).astype(
                    np.float32)
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
            cand_ids, cand_valid, pred = self._track_inputs_on_device()
            with self.timers.span("track.dispatch"):
                packed = _track_and_map_step(
                    self._gen, frame.im_desc, frame.im_valid,
                    frame.im_uv_ref, frame.im_anchor_cam, frame.im_sigma2,
                    frame.im_point3d, frame.im_has_depth, *kf.device_desc(),
                    kf.d_lm_id(), self.dmap.pos, self.dmap.valid,
                    self.dmap.desc, self.dmap.normal, cand_ids, cand_valid,
                    self.rig.cam_T_ref, self.rig.fxycxy, pred,
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

        if self.use_imu and self.imu_initialized:
            self._inertial_bookkeeping(kf, timestamp, pose)
        if self.use_gps:
            self._attach_gps_to_kf(kf)
            self._try_gps_init()
        if self.looper is not None:
            # the keyframes after a closure re-detect the same place:
            # closures are suppressed for loop_cooldown_kfs keyframes
            with self.timers.span("loop_detect"):
                det = self.looper.detect(kf, *kf.device_desc(),
                                         self.keyframes, self.map)
            cooled = (kf.kf_id - getattr(self, "_last_loop_kf", -10**9)
                      >= self.cfg.loop_cooldown_kfs)
            if det.detected and cooled:
                self._last_loop_kf = kf.kf_id
                with self.timers.span("close_loop"):
                    self._close_loop(kf, det)
        with self.timers.span("window_ba"):
            self._run_window_ba()

    def _inertial_bookkeeping(self, kf, timestamp, pose):
        """Preintegrate the span since the previous keyframe (a dummy
        included) and seed the new keyframe's velocity by IMU propagation
        of the previous one's state (a finite difference of positions would
        amplify pose noise by 1 / dt); drop consumed samples."""
        self.kf_time[kf.kf_id] = timestamp
        if len(self.keyframes) >= 2:
            prev = self.keyframes[-2]
            pre = self._preintegrate_span(prev.timestamp, timestamp)
            if pre is not None:
                self._kf_preints[kf.kf_id] = (prev.kf_id, pre)
            if pre is not None and prev.kf_id in self.kf_vel:
                v = self._imu_predict(prev.world_T_ref,
                                      self.kf_vel[prev.kf_id],
                                      pre).vel.numpy()
            else:
                # no usable preintegration: a finite difference over a
                # noise-safe baseline
                dt = max(timestamp - prev.timestamp, 0.05)
                v = ((pose[:3, 3] - prev.world_T_ref[:3, 3]) / dt).astype(
                    np.float32)
            self.kf_vel[kf.kf_id] = v
        else:
            self.kf_vel[kf.kf_id] = np.zeros(3, np.float32)
        self.kf_bias[kf.kf_id] = self.bias.copy()
        self._imu_buf = [s for s in self._imu_buf if s[0] > timestamp - 0.2]

    # -- map reuse --------------------------------------------------------

    def attach_graph_log(self, writer):
        """Stream loop graph_logs records ('k' loop poses, 'm' loop
        measurements) to `writer` (utils.mapio.GraphLogWriter) as closures
        happen."""
        self.graph_log = writer

    def enable_relocalization(self, relocalizer, fast_tracker=None):
        """Switch to a map-reuse session: frames are localized against the
        saved map of `relocalizer` (loop.reloc.Relocalizer) instead of
        building a new one. While lost, every frame queries the saved BoW
        database and verifies by PnP; once localized, `fast_tracker`
        (loop.tracking.FastTracker, when given) tracks the prior map from
        the predicted pose, falling back to global relocalization on
        loss."""
        self.relocalizer = relocalizer
        self.fast_tracker = fast_tracker
        self.stats.setdefault("relocalizations", 0)
        self.stats.setdefault("fast_tracked", 0)

    def _process_frame_reloc(self, frame: FrameFeatures, timestamp: float,
                             info: dict) -> dict:
        pose = None
        if self._reloc_localized and self.fast_tracker is not None:
            pred = self._predict_reloc_pose(timestamp)
            with self.timers.span("fast_track"):
                pose = self.fast_tracker.track(frame, pred)
            if pose is not None:
                self.stats["fast_tracked"] += 1
        if pose is None:
            with self.timers.span("relocalize"):
                pose = self.relocalizer.relocalize(frame)
            if pose is not None:
                self.stats["relocalizations"] += 1
                self._reloc_delta = np.eye(4, dtype=np.float32)
                self._reloc_vel = np.zeros(3, np.float32)
        if pose is not None:
            pose = np.asarray(pose, np.float32)
            if self._reloc_localized:
                self._reloc_delta = (np.linalg.inv(self.cur_pose)
                                     @ pose).astype(np.float32)
                if self._reloc_prev_ts is not None:
                    dt = max(timestamp - self._reloc_prev_ts, 1e-3)
                    self._reloc_vel = ((pose[:3, 3] - self.cur_pose[:3, 3])
                                       / dt).astype(np.float32)
            self.cur_pose = pose
            self._reloc_localized = True
            self.state = INITIALIZED
            info["tracked"] = 1
        else:
            if self._reloc_localized:
                self.stats["failures"] += 1
            self._reloc_localized = False
            self.state = REINITIALIZING
        info["state"] = self.state
        info["relocalized"] = pose is not None
        self._reloc_prev_ts = timestamp
        self._record_pose(timestamp)
        return info

    def _predict_reloc_pose(self, timestamp: float) -> np.ndarray:
        """Pose prior of fast tracking: with the IMU gravity-initialized,
        dead reckoning from the last tracked pose by the preintegrated
        samples (the loaded map's world frame must be gravity-aligned, as
        a VIO session's is); otherwise the constant-velocity model."""
        if (self.use_imu and self.imu_initialized
                and self._reloc_prev_ts is not None):
            pre = self._preintegrate_span(self._reloc_prev_ts, timestamp)
            if pre is not None:
                pred = self._imu_predict(self.cur_pose, self._reloc_vel, pre)
                return (pred.world_T_body.numpy() @ self._btc0).astype(
                    np.float32)
        return (self.cur_pose @ self._reloc_delta).astype(np.float32)

    # -- main entry -------------------------------------------------------

    def _land_matured(self, frames_ahead: int = 0):
        """Land deferred window and global BA solves that have had their
        frames of overlap (frames_ahead = 1 before the fused dispatch,
        which runs ahead of process_frame's frame count)."""
        cfg = self.cfg
        n = self.stats["frames"] + frames_ahead
        if (getattr(self, "_pending_ba", None) is not None
                and n - getattr(self, "_ba_dispatch_frame", 0)
                >= cfg.async_ba_land_frames):
            self._finish_pending_ba()
        if (getattr(self, "_pending_gba", None) is not None
                and n - getattr(self, "_gba_dispatch_frame", 0)
                >= cfg.gba_land_frames):
            self._finish_pending_gba()

    def process_image(self, imgs, timestamp: float, imu=None, gps=None,
                      seg_masks=None, extract_cfg=None) -> dict:
        """One SLAM step straight from (C, H, W) images (float in [0, 1] or
        uint8; numpy or a tensor). In INITIALIZED steady state the frame
        build and the tracking step run as one fused device program with
        one packed fetch (_build_and_track_step); otherwise build_frame +
        process_frame (also with seg_masks, and while the IMU waits for
        gravity alignment). extract_cfg: build_frame keyword overrides
        (num_points, num_levels, max_intra, angle_bins, route, ...);
        imu / gps: the sensor messages since the previous frame, as for
        process_frame. A relocalization session always takes the split
        path."""
        cfg = self.cfg
        imgs = torch.as_tensor(imgs)
        ecfg = dict(extract_cfg or {})
        if (self.state != INITIALIZED or self.relocalizer is not None
                or not self.keyframes or seg_masks is not None
                or (self.use_imu and not self.imu_initialized)):
            frame = build_frame(imgs.to(self.device), self.rig,
                                seg_masks=seg_masks, **ecfg)
            return self.process_frame(frame, timestamp, imu=imu, gps=gps)
        # sensor ingestion and a matured deferred solve come before the
        # fused dispatch (the program consumes the predicted pose and the
        # map mirror); process_frame skips both when it gets _packed
        if imu is not None and self.use_imu:
            self._ingest_imu(imu)
        if gps is not None and self.use_gps:
            self._ingest_gps(gps)
            self._process_gps_dummies(timestamp)
        self._land_matured(frames_ahead=1)
        kf_prev = self._prev_kf()
        self._set_pred_span(timestamp)
        kw = dict(_BUILD_FRAME_DEFAULTS)
        kw.update(ecfg)
        statics = dict(
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
            fastpath_min=cfg.track_fastpath_min_inliers, route=kw["route"])
        with self.timers.span("track.dispatch"):
            if self.cuda_graphs:
                kps, xy_ud, groups, tri, packed = self._replay_frame(
                    imgs, kf_prev, statics)
            else:
                kps, xy_ud, groups, tri, packed = _build_and_track_step(
                    self._gen, imgs.to(self.device), self.rig,
                    *kf_prev.device_desc(), kf_prev.d_lm_id(), self.dmap.pos,
                    self.dmap.valid, self.dmap.desc, self.dmap.normal,
                    *self._track_inputs_on_device(), **statics)
        frame = assemble_frame(kps, xy_ud, groups, tri)
        return self.process_frame(frame, timestamp, _packed=packed)

    def _replay_frame(self, imgs, kf_prev, statics):
        """The fused frame program as a captured CUDA graph
        (utils/graphs), keyed on `statics` and the images' shape and type,
        the fast-path decision on the device (branch="device"). Its inputs
        are copied in before each replay: the images, the reference
        keyframe's descriptors, validity and landmark ids, and the
        _track_inputs_host buffer; the graph reads the map mirror in place
        (DeviceMap updates in place). -> the outputs, the graph's, which
        the next frame overwrites."""
        L = self.cfg.local_map_landmarks

        def step(imgs, desc, valid, lm_id, buf):
            return _build_and_track_step(
                self._gen, imgs, self.rig, desc, valid, lm_id, self.dmap.pos,
                self.dmap.valid, self.dmap.desc, self.dmap.normal,
                *_split_track_inputs(buf, L), branch="device", **statics)

        key = (tuple(imgs.shape), imgs.dtype, tuple(sorted(statics.items())))
        outs, _ = self._frame_programs(
            key, step, (imgs, *kf_prev.device_desc(), kf_prev.d_lm_id(),
                        torch.from_numpy(self._track_inputs_host())))
        return outs

    def _set_pred_span(self, timestamp):
        """The IMU prediction's span: the last tracked frame -> now."""
        self._pred_span = (None if self._last_track_ts is None
                           else (self._last_track_ts, timestamp))

    def process_frame(self, frame: FrameFeatures, timestamp: float,
                      imu=None, gps=None, _packed=None) -> dict:
        """One SLAM step on an already-built FrameFeatures; returns this
        frame's stats. imu = (ts (S,), gyro (S, 3), accel (S, 3)) and
        gps = (ts (G,), lla (G, 3)): the sensor messages since the previous
        frame (with imu_params / gps_lever_arm; ignored otherwise). While
        the IMU waits for gravity alignment a frame only records the pose.
        `_packed`: internal, a pre-dispatched tracking buffer of the fused
        program (process_image)."""
        cfg = self.cfg
        self.stats["frames"] += 1
        info = {"keyframe": False, "tracked": 0, "state": self.state}

        if imu is not None and self.use_imu:
            self._ingest_imu(imu)
            if not self.imu_initialized:
                self._record_pose(timestamp)
                return info
        if gps is not None and self.use_gps:
            self._ingest_gps(gps)
            if self.state == INITIALIZED:
                # fixes between vision keyframes become dummy keyframes
                self._process_gps_dummies(timestamp)

        if self.relocalizer is not None:
            return self._process_frame_reloc(frame, timestamp, info)

        if self.state != INITIALIZED:
            ok = self._initialize(frame, timestamp)
            info["initialized"] = ok
            if ok:
                # fresh motion state for the predictor
                self._last_track_ts = timestamp
                self._track_vel = np.zeros(3, np.float32)
            self._record_pose(timestamp)
            return info

        # land matured deferred solves before tracking, so tracking sees
        # the corrected map
        self._land_matured()

        kf_prev = self._prev_kf()
        self._set_pred_span(timestamp)
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

        # world-frame velocity of the IMU predictor (finite difference of
        # reference positions)
        if self._last_track_ts is not None and timestamp > self._last_track_ts:
            self._track_vel = ((pose[:3, 3] - self.cur_pose[:3, 3]) / max(
                timestamp - self._last_track_ts, 1e-3)).astype(np.float32)
        self._last_track_ts = timestamp

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
        """Flush asynchronous backend work (call before reading poses/map);
        with final_global_ba, one global BA over the whole session, its
        correction carried to every recorded pose by the nearest (in time)
        keyframe's."""
        self._finish_pending_ba()
        self._finish_pending_gba()
        if (self.cfg.final_global_ba
                and not getattr(self, "_final_gba_done", False)
                and self.state == INITIALIZED and len(self.keyframes) >= 3):
            self._final_gba_done = True
            vis = [k for k in self.keyframes if not k.is_dummy]
            pre = {k.kf_id: k.world_T_ref.copy() for k in vis}
            self._run_global_ba()
            self._finish_pending_gba()
            kf_ts = np.array([k.timestamp for k in vis])
            corr = [(k.world_T_ref @ np.linalg.inv(pre[k.kf_id])).astype(
                np.float32) for k in vis]
            for i, (t, p) in enumerate(self.trajectory):
                j = int(np.argmin(np.abs(kf_ts - t)))
                self.trajectory[i] = (t, (corr[j] @ p).astype(np.float32))

    def trajectory_arrays(self):
        self.finalize()
        ts = np.array([t for t, _ in self.trajectory])
        poses = np.stack([p for _, p in self.trajectory])
        return ts, poses

    def write_trajectory(self, path):
        from mcslam_tpu_torch.utils import tum

        ts, poses = self.trajectory_arrays()
        tum.write_tum(path, ts, poses)
