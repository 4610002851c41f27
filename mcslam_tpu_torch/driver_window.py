"""Window-BA half of the SLAM driver (mixin; counterpart of
mcslam_tpu/driver_window.py): window assembly in the kf-blocked layout
with the same capacity tiers; the vision solve with deferred write-back
and the fixed-lag marginal carry-over (over a device mesh, the
observation-sharded solve of parallel/sharded_ba, with no marginal: the
anchor falls back to the gauge clamp, as in the JAX driver); and, once
the IMU is gravity-initialized, the visual-inertial(-GPS) solve
(backend/ba_vio) with its body-frame states, IMU and GPS factor tables,
priors and synchronous write-back.

On a CUDA device the vision solve (and driver_loop's global solve) runs on
a side stream of its own (a mesh solve's work on the session's device
too; its other devices' shards queue on their current streams, and the
copies between cards are ordered on the streams by torch's cross-device
copy events). The tracking
path syncs its stream every frame (the packed fetch; off the graphed
path also the fast-path read and pageable uploads); on a shared stream
each of those syncs would wait for the queued solve and make the deferred
write-back synchronous. With cuda_graphs the vision solve replays a CUDA
graph captured on that side stream (_replay_solve). The side
stream waits for the main stream before the solve, its input tensors are
recorded on it (so the allocator does not hand their memory to the main
stream while the solve reads them), and the main stream waits for it
before the result is read. The VIO solve stays on the current stream
(its write-back is synchronous); with cuda_graphs its warm solves
replay a CUDA graph too (_replay_vio_solve). A cold VIO solve runs
eagerly: it comes once per session and again only after a reset or a
loop closure, so its program would seldom repeat and a capture costs
about two eager solves.
"""

from __future__ import annotations

import numpy as np
import torch

from mcslam_tpu_torch.backend import ba, ba_vio
from mcslam_tpu_torch.parallel import sharded_ba


class WindowBAMixin:
    # -- window bundle adjustment ----------------------------------------

    def _run_window_ba(self):
        self._finish_pending_ba()  # consume the previous async solve
        window = self.keyframes[-self.cfg.window_size:]
        self._solve_window(window)

    def _ba_side_stream(self):
        """The solve's CUDA stream (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        if getattr(self, "_ba_stream", None) is None:
            self._ba_stream = torch.cuda.Stream(self.device)
        return self._ba_stream

    def _dispatch_solve(self, problem, iters: int,
                        landmark_sharded: bool = False,
                        graphed: bool = False) -> ba.BAResult:
        """Queue the solve of a kf-blocked BAProblem: ba_solve on the
        ba_linearize kernel, or over the session's mesh the
        observation-sharded solve (the landmark-sharded one for a
        shard_by_landmark table), whose result has a zero marginal_H. On
        a CUDA device it runs on the side stream, after the main stream,
        with the problem's tensors recorded on it. `graphed` (the window
        solve, with cuda_graphs, no mesh): ba_solve replays a CUDA graph
        captured on the side stream per (K, Ok, L, C, iters, gate rounds);
        its result is the graph's output, which lands before the next
        solve replays."""
        def solve():
            if self.mesh is None and graphed and self.cuda_graphs:
                return self._replay_solve(problem, iters)
            if self.mesh is None:
                return ba.ba_solve(problem, iters=iters, kf_blocked=True)
            fn = (sharded_ba.sharded_ba_solve_lm if landmark_sharded
                  else sharded_ba.sharded_ba_solve)
            out = fn(self.mesh, problem.poses, problem.landmarks,
                     problem.lm_valid, problem.kf_valid, problem.obs,
                     problem.cam_T_ref, problem.fxycxy, problem.prior_H,
                     problem.prior_b, iters=iters)
            return ba.BAResult(*out, marginal_H=torch.zeros_like(
                problem.prior_H, device=out[0].device))

        stream = self._ba_side_stream()
        if stream is None:
            return solve()
        stream.wait_stream(torch.cuda.current_stream(self.device))
        for t in (*problem[:3], *problem.obs, *problem[4:]):
            t.record_stream(stream)
        with torch.cuda.stream(stream):
            return solve()

    def _replay_solve(self, problem, iters: int,
                      gate_rounds: int = 2) -> ba.BAResult:
        """ba_solve (kf-blocked) of `problem` as a replayed CUDA graph on
        the current stream."""
        K, L, C = (problem.poses.shape[0], problem.landmarks.shape[0],
                   problem.cam_T_ref.shape[0])
        Ok = problem.obs.kf.shape[0] // K
        flat = (*problem[:3], *problem.obs, *problem[4:])

        def solve(*t):
            p = ba.BAProblem(*t[:3], ba.BAObservations(*t[3:9]), *t[9:])
            return tuple(ba.ba_solve(p, iters=iters, gate_rounds=gate_rounds,
                                     kf_blocked=True))

        outs, _ = self._solve_programs(
            (K, Ok, L, C, iters, gate_rounds), solve, flat)
        return ba.BAResult(*outs)  # a new tuple: _pending_vis_marg tests it

    def _replay_vio_solve(self, problem, iters: int,
                          gate_rounds: int = 2) -> ba_vio.VioResult:
        """ba_vio.vio_solve (kf-blocked) of `problem` as a replayed CUDA
        graph on the current stream (the VIO write-back reads it at once,
        before the next replay overwrites it). The factor tables' index
        columns are inputs of the program, not part of its key: one
        program per shape, iters, gate rounds, g_norm and set of factor
        tables serves every keyframe pattern of the window's IMU pairs
        and GPS fixes."""
        flat, present = ba_vio._flatten(problem)

        def solve(*t):
            return tuple(ba_vio.vio_solve(
                ba_vio._unflatten(t, present, problem.g_norm), iters=iters,
                gate_rounds=gate_rounds, kf_blocked=True))

        key = ("vio", iters, gate_rounds, problem.g_norm, present,
               tuple((tuple(t.shape), t.dtype) for t in flat))
        outs, _ = self._solve_programs(key, solve, flat)
        return ba_vio.VioResult(*outs)

    def _solve_window(self, window, force_sync=False, allow_vio=True):
        """Window BA over an explicit keyframe list (gauge on window[0]);
        the VIO solve once the IMU is gravity-initialized (unless
        allow_vio is False). GPS dummy keyframes have no observations and
        take part as state nodes. _run_window_ba passes the trailing
        window; _close_loop passes [matched old keyframe] + recent ones
        with force_sync=True (written back at once, no marginal kept)."""
        cfg = self.cfg
        if len(window) < 2:
            return
        # a deferred global BA lands first: this window would otherwise
        # linearize at poses the landing is about to move
        self._finish_pending_gba()
        K = cfg.window_size

        # collect landmark ids observed by >= 2 window keyframes
        all_ids = np.concatenate([kf.lm_id[kf.lm_id >= 0] for kf in window])
        uniq, counts = np.unique(all_ids, return_counts=True)
        lm_ids = uniq[(counts >= 2) & self.map.valid[uniq]]
        if len(lm_ids) < 10:
            return
        lm_ids = lm_ids[: cfg.ba_lm_capacity]
        L = cfg.ba_lm_capacity
        # the observation table is laid out in K contiguous blocks of
        # Ok = O // K slots, one per window keyframe (kf-blocked layout)
        slot_lookup = np.full(self.map.capacity, -1, np.int32)
        slot_lookup[lm_ids] = np.arange(len(lm_ids), dtype=np.int32)
        # capacity tiers: the smallest power-of-two block (from 256) that
        # fits this window's densest keyframe, capped by the configured
        # capacity; the same padded problem as the JAX driver solves
        kf_pairs = []  # (slots, mm, cc) per keyframe, reused by the fill
        need_ok = 0
        for kf in window:
            slots = slot_lookup[np.maximum(kf.lm_id, 0)]
            m_ok = (kf.lm_id >= 0) & (slots >= 0)
            mm, cc = np.nonzero(m_ok[:, None] & kf.ray_valid)
            kf_pairs.append((slots, mm, cc))
            need_ok = max(need_ok, len(mm))
        Ok_max = cfg.ba_obs_capacity // K
        Ok = 256
        while Ok < need_ok and Ok < Ok_max:
            Ok *= 2
        Ok = min(Ok, Ok_max)
        O = Ok * K
        obs_cam = np.zeros(O, np.int32)
        obs_lm = np.zeros(O, np.int32)
        obs_uv = np.zeros((O, 2), np.float32)
        obs_s2 = np.ones(O, np.float32)
        obs_val = np.zeros(O, bool)
        n_obs = 0
        for wk, kf in enumerate(window):
            slots, mm, cc = kf_pairs[wk]
            n = min(len(mm), Ok)
            base = wk * Ok
            obs_cam[base:base + n] = cc[:n]
            obs_lm[base:base + n] = slots[mm[:n]]
            obs_uv[base:base + n] = kf.ray_uv[mm[:n], cc[:n]]
            obs_s2[base:base + n] = np.maximum(
                kf.ray_sigma2[mm[:n], cc[:n]], 1e-3) * (cfg.px_sigma ** 2)
            obs_val[base:base + n] = True
            n_obs += n
        if n_obs < 30:
            return

        poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
        kf_valid = np.zeros(K, bool)
        for wk, kf in enumerate(window):
            poses[wk] = kf.world_T_ref
            kf_valid[wk] = True
        lms = np.zeros((L, 3), np.float32)
        lms[: len(lm_ids)] = self.map.pos[lm_ids]
        lm_valid = np.zeros(L, bool)
        lm_valid[: len(lm_ids)] = True
        obs = ba.BAObservations(
            kf=np.repeat(np.arange(K, dtype=np.int32), Ok), cam=obs_cam,
            lm=obs_lm, uv=obs_uv, sigma2=obs_s2, valid=obs_val)

        if allow_vio and self.use_imu and self.imu_initialized:
            self._run_window_ba_vio(window, obs, poses, kf_valid, lms,
                                    lm_valid, lm_ids)
            return

        prior_H = np.zeros((K * 6, K * 6), np.float32)
        # fixed-lag marginalization: anchor the oldest window pose with the
        # marginal information carried from the previous solve; a cold
        # window clamps it
        vis_marg = getattr(self, "_vis_marg_prior", None)
        if vis_marg is not None and window[0].kf_id == vis_marg[0]:
            prior_H[:6, :6] = np.clip(vis_marg[1], -1e6, 1e6) + np.eye(6) * 1e2
        else:
            prior_H[:6, :6] = np.eye(6) * 1e6
        problem = ba.problem_from_numpy(
            poses, lms, lm_valid, obs,
            self.rig.cam_T_ref, self.rig.fxycxy, prior_H,
            np.zeros(K * 6, np.float32), kf_valid, device=self.device)
        # warm windows (previous solve landed, no reinit since) are
        # re-linearizations of a converged system; cold ones get the full
        # budget
        iters = cfg.ba_iters if self._ba_warm else cfg.ba_iters_cold
        result = self._dispatch_solve(problem, iters, graphed=True)
        self.stats["window_ba"] = self.stats.get("window_ba", 0) + 1
        self._ba_warm = True
        # stash the marginal information of the state that becomes the
        # oldest when the trailing window slides (consumed above); the
        # mesh solve has none, so its next window clamps the anchor
        if not force_sync and self.mesh is None:
            self._pending_vis_marg = (window[1].kf_id, result)
        # deferred write-back: the solve runs on the device while the next
        # frame is tracked; its results land async_ba_land_frames frames
        # later (or at the next keyframe / finalize)
        self._pending_ba = (result, lm_ids, list(window))
        self._ba_dispatch_frame = self.stats["frames"]
        # young maps cannot take deferred corrections: the first
        # window_size solves after construction or reinit land at once
        sync_left = getattr(self, "_ba_sync_left", 0)
        if sync_left > 0:
            self._ba_sync_left = sync_left - 1
        if force_sync or sync_left > 0 or not self._async_ba_active:
            self._finish_pending_ba()

    def _finish_pending_ba(self):
        pending = getattr(self, "_pending_ba", None)
        if pending is None:
            return
        self._pending_ba = None
        result, lm_ids, window = pending
        stream = self._ba_side_stream()
        if stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(stream)
        n_lm = len(lm_ids)
        pm = getattr(self, "_pending_vis_marg", None)
        take_marg = pm is not None and pm[1] is result
        # one fetch: poses, landmarks and the marginal's second pose block
        K = result.poses.shape[0]
        v = torch.cat([
            result.poses.reshape(-1), result.landmarks[:n_lm].reshape(-1),
            result.marginal_H[6:12, 6:12].reshape(-1),
        ]).cpu().numpy()
        new_poses = v[:K * 16].reshape(K, 4, 4)
        new_lms = v[K * 16:K * 16 + 3 * n_lm].reshape(n_lm, 3)
        if take_marg:
            self._pending_vis_marg = None
            # the conditional block, deliberately (not the Schur marginal):
            # in a pure-odometry chain the anchor prior doubles as the gauge
            blk = v[K * 16 + 3 * n_lm:].reshape(6, 6)
            self._vis_marg_prior = (pm[0], (blk + blk.T) * 0.5)
        old_last = window[-1].world_T_ref.copy()
        for wk, kf in enumerate(window):
            kf.world_T_ref = new_poses[wk]
        self._map_update_positions(lm_ids, new_lms)
        if self._async_ba_active:
            # deferred landing: retro-correct every pose recorded since the
            # window's last keyframe by the correction it received
            delta = new_poses[len(window) - 1] @ np.linalg.inv(old_last)
            t_kf = window[-1].timestamp
            for i in range(len(self.trajectory) - 1, -1, -1):
                t, p = self.trajectory[i]
                if t < t_kf:
                    break
                self.trajectory[i] = (t, (delta @ p).astype(np.float32))
            self.cur_pose = (delta @ self.cur_pose).astype(np.float32)
        else:
            self.cur_pose = window[-1].world_T_ref.copy()

    @property
    def _async_ba_active(self) -> bool:
        """Deferred write-back is a rig-only optimization: monocular
        sessions run synchronously regardless of the flag."""
        return self.cfg.async_ba and self.rig.num_cams >= 2

    def _discard_pending_ba(self):
        """Drop an in-flight BA (its linearization is invalidated)."""
        stream = self._ba_side_stream()
        if stream is not None and getattr(self, "_pending_ba", None):
            torch.cuda.current_stream(self.device).wait_stream(stream)
        self._pending_ba = None

    def _run_window_ba_vio(self, window, obs, poses, kf_valid, lms, lm_valid,
                           lm_ids):
        """Visual-inertial(-GPS) window BA by ba_vio.vio_solve, written
        back at once (no deferred landing). The inertial state is the body
        frame: world_T_body = world_T_ref @ inv(body_T_cam[0])."""
        cfg = self.cfg
        K = cfg.window_size
        D = ba_vio.D
        N = K * D + 6
        e0 = K * D
        poses_body = poses.copy()
        vels = np.zeros((K, 3), np.float32)
        biases = np.zeros((K, 6), np.float32)
        for wk, kf in enumerate(window):
            poses_body[wk] = kf.world_T_ref @ self._inv_btc0
            vels[wk] = self.kf_vel.get(kf.kf_id, np.zeros(3))
            biases[wk] = self.kf_bias.get(kf.kf_id, self.bias)

        # IMU factors between consecutive window keyframes
        idx_of = {kf.kf_id: wk for wk, kf in enumerate(window)}
        preints, pairs = [], []
        for kf in window[1:]:
            entry = self._kf_preints.get(kf.kf_id)
            if entry is not None and entry[0] in idx_of:
                preints.append(entry[1])
                pairs.append((idx_of[entry[0]], idx_of[kf.kf_id]))
        imu_factors = None
        if preints:
            imu_factors = ba_vio.make_imu_factors(
                preints, pairs, capacity=K - 1, params=self.imu_params,
                device=self.device)

        # GPS factors, held until >= 3 fixes are attached
        gps_factors = None
        if self.use_gps and self.gps_initialized and len(self.kf_gps) >= 3:
            g_kf = [idx_of[kf.kf_id] for kf in window
                    if kf.kf_id in self.kf_gps]
            if g_kf:
                enu = np.zeros((K, 3), np.float32)
                enu[:len(g_kf)] = [self.kf_gps[window[k].kf_id]
                                   for k in g_kf]
                gps_factors = ba_vio.factor_table(
                    ba_vio.GpsFactors, self.device,
                    kf=np.pad(g_kf, (0, K - len(g_kf))), enu=enu,
                    t_bg=self.gps_lever_arm,
                    sigma=np.full(K, cfg.gps_sigma, np.float32),
                    valid=np.arange(K) < len(g_kf))

        prior_H = np.zeros((N, N), np.float32)
        prior_H[:6, :6] = np.eye(6) * 1e6  # gauge on the oldest pose
        # fixed-lag marginalization: the previous window's marginal of the
        # state that is now the oldest (velocity and bias are weakly
        # observable inside one window)
        marg = getattr(self, "_marg_prior", None)
        if marg is not None and window[0].kf_id == marg[0]:
            prior_H[6:D, 6:D] += marg[1][6:, 6:]
        else:
            prior_H[6:9, 6:9] = np.eye(3) * 1.0
            # a cold bias may only drift at the random-walk scale
            prior_H[9:15, 9:15] = np.eye(6) * 1e5
        if gps_factors is None:
            prior_H[e0:, e0:] = np.eye(6) * 1e8  # E_T_V unobserved: clamp
        else:
            # E_T_V is a global state: carry its information across
            # windows, and pin its rotation (only _refit_gps_alignment,
            # over the whole history, rotates it)
            carry = getattr(self, "_etv_prior_H", None)
            prior_H[e0:, e0:] = carry if carry is not None else np.eye(6)
            for d in range(3):
                prior_H[e0 + d, e0 + d] = max(prior_H[e0 + d, e0 + d], 1e8)

        problem = ba_vio.problem_from_numpy(
            poses_body, vels, biases, lms, lm_valid, obs,
            np.linalg.inv(self._btc), self.rig.fxycxy, self.E_T_V, prior_H,
            np.zeros(N, np.float32), kf_valid, imu=imu_factors,
            gps=gps_factors, g_norm=self.imu_params.g_norm,
            device=self.device)
        iters = cfg.ba_iters if self._ba_warm else cfg.ba_iters_cold
        result = (self._replay_vio_solve(problem, iters)
                  if self.cuda_graphs and self._ba_warm
                  else ba_vio.vio_solve(problem, iters=iters,
                                        kf_blocked=True))
        self.stats["window_ba_vio"] = self.stats.get("window_ba_vio", 0) + 1
        self._ba_warm = True

        # one fetch: poses, velocities, biases, E_T_V, landmarks, marginal
        n_lm = len(lm_ids)
        v = torch.cat([result.poses.reshape(-1), result.vels.reshape(-1),
                       result.biases.reshape(-1), result.E_T_V.reshape(-1),
                       result.landmarks[:n_lm].reshape(-1),
                       result.marginal_H.reshape(-1)]).cpu().numpy()
        sizes = (K * 16, K * 3, K * 6, 16, n_lm * 3, N * N)
        parts = np.split(v, np.cumsum(sizes)[:-1])
        new_poses_body = parts[0].reshape(K, 4, 4)
        new_vels, new_biases = parts[1].reshape(K, 3), parts[2].reshape(K, 6)
        margH = parts[5].reshape(N, N)
        for wk, kf in enumerate(window):
            kf.world_T_ref = (new_poses_body[wk] @ self._btc0).astype(
                np.float32)
            self.kf_vel[kf.kf_id] = new_vels[wk]
            self.kf_bias[kf.kf_id] = new_biases[wk]
        self.bias = new_biases[len(window) - 1]
        if gps_factors is not None:
            self.E_T_V = parts[3].reshape(4, 4)
            # re-fit E_T_V over the whole history; while that history is
            # too small or flat, carry half the window's E_T_V block
            if not self._refit_gps_alignment():
                blk = margH[e0:, e0:]
                self._etv_prior_H = np.clip((blk + blk.T) * 0.5, -1e5,
                                            1e5) * 0.5
        self._map_update_positions(lm_ids, parts[4].reshape(n_lm, 3))
        self.cur_pose = window[-1].world_T_ref.copy()
        # the fixed-lag prior of the next window: the conditional block of
        # the state that becomes the oldest, capped so that stale
        # linearizations cannot over-constrain
        if len(window) >= 2:
            blk = margH[D:2 * D, D:2 * D]
            self._marg_prior = (window[1].kf_id,
                                np.clip((blk + blk.T) * 0.5, -1e6, 1e6))
