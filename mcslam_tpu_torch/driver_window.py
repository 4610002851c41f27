"""Window-BA half of the SLAM driver (mixin; counterpart of
mcslam_tpu/driver_window.py, vision branch): window assembly in the
kf-blocked layout with the same capacity tiers, the solve, deferred
write-back and the fixed-lag marginal carry-over.

On a CUDA device the solve runs on a side stream of its own. The tracking
path syncs its stream every frame (the packed fetch, the fast-path read,
pageable uploads); on a shared stream each of those syncs would wait for
the queued solve and make the deferred write-back synchronous. The side
stream waits for the main stream before the solve, its input tensors are
recorded on it (so the allocator does not hand their memory to the main
stream while the solve reads them), and the main stream waits for it
before the result is read.
"""

from __future__ import annotations

import numpy as np
import torch

from mcslam_tpu_torch.backend import ba


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

    def _solve_window(self, window):
        """Window BA over an explicit keyframe list (gauge on window[0])."""
        cfg = self.cfg
        if len(window) < 2:
            return
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
            poses, lms, lm_valid,
            ba.BAObservations(
                kf=np.repeat(np.arange(K, dtype=np.int32), Ok), cam=obs_cam,
                lm=obs_lm, uv=obs_uv, sigma2=obs_s2, valid=obs_val),
            self.rig.cam_T_ref, self.rig.fxycxy, prior_H,
            np.zeros(K * 6, np.float32), kf_valid, device=self.device)
        # warm windows (previous solve landed, no reinit since) are
        # re-linearizations of a converged system; cold ones get the full
        # budget
        iters = cfg.ba_iters if self._ba_warm else cfg.ba_iters_cold
        stream = self._ba_side_stream()
        if stream is None:
            result = ba.ba_solve(problem, iters=iters, kf_blocked=True)
        else:
            stream.wait_stream(torch.cuda.current_stream(self.device))
            for t in (*problem[:3], *problem.obs, *problem[4:]):
                t.record_stream(stream)
            with torch.cuda.stream(stream):
                result = ba.ba_solve(problem, iters=iters, kf_blocked=True)
        self.stats["window_ba"] = self.stats.get("window_ba", 0) + 1
        self._ba_warm = True
        # stash the marginal information of the state that becomes the
        # oldest when the trailing window slides (consumed above)
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
        if sync_left > 0 or not self._async_ba_active:
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
