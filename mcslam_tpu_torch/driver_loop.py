"""Loop-closure half of the SLAM driver (mixin; counterpart of
mcslam_tpu/driver_loop.py): landmark identity merge, the PGO gate and
bend, landmark re-anchoring, the loop-window BA, re-triangulation and the
global BA with its deferred landing.

The host bookkeeping (keyframe landmark tables, the map) is the JAX
driver's numpy code. PGO, the BA solves and the triangulation run on the
session's device. With `async_gba` the global solve is queued on the
window BA's side CUDA stream (driver_window._ba_side_stream) and lands
`gba_land_frames` frames later, or before the next window solve, loop
closure or finalize(); nothing waits for it at dispatch. Over a device
mesh the global solve is the landmark-sharded one (parallel/sharded_ba).
"""

from __future__ import annotations

import numpy as np
import torch

from mcslam_tpu_torch.backend import ba, pgo
from mcslam_tpu_torch.parallel import sharded_ba
from mcslam_tpu_torch.tracking_kernels import _triangulate_pairs


class LoopClosingMixin:
    # -- loop closing ------------------------------------------------------

    def _close_loop(self, kf, det):
        """Merge re-observed landmarks, bend the keyframe trajectory by
        pose-graph optimization where it disagrees with the loop, re-anchor
        landmarks to their first-observing keyframe, digest the loop in a
        window BA, then re-triangulate and run global BA."""
        # an in-flight window BA linearized at pre-loop poses is stale; a
        # deferred global BA of the previous closure lands first
        self._finish_pending_ba()
        self._finish_pending_gba()
        cfg = self.cfg
        self.stats["loops"] += 1
        self._ba_warm = False  # post-loop windows take the full LM budget
        self._ba_sync_left = cfg.window_size  # young post-loop geometry
        if self.graph_log is not None:
            self.graph_log.loop_pose(kf.kf_id, det.match_kf, det.rel_pose)
            for slot, old_lm in zip(det.query_slots, det.lm_ids):
                self.graph_log.loop_measurement(
                    kf.kf_id, int(kf.im_anchor_cam[slot]), int(old_lm),
                    float(kf.im_uv[slot, 0]), float(kf.im_uv[slot, 1]))
        # 1. merge landmark identities: the query slots re-observe old
        # landmarks. A fresh duplicate may be referenced by other
        # keyframes too, so remap it everywhere before freeing its slot
        # (the free list would otherwise alias an unrelated landmark).
        remap = {}
        for slot, old_lm in zip(det.query_slots, det.lm_ids):
            cur_lm = int(kf.lm_id[slot])
            if cur_lm >= 0 and cur_lm != old_lm:
                remap[cur_lm] = int(old_lm)
            kf.lm_id[slot] = old_lm
        kf.lm_dirty()
        if remap:
            remap_arr = np.arange(self.map.capacity, dtype=np.int32)
            for cur, old in remap.items():
                remap_arr[cur] = old
            for k in self.keyframes:
                m = k.lm_id >= 0
                if m.any():
                    new_ids = remap_arr[k.lm_id[m]]
                    if np.any(new_ids != k.lm_id[m]):
                        k.lm_id[m] = new_ids
                        k.lm_dirty()
            for cur, old in remap.items():
                self.map.n_obs[old] += self.map.n_obs[cur]
            self._map_delete(list(remap.keys()))

        # 2. pose graph (odometry edges + the loop edge), only where the
        # trajectory disagrees with the loop constraint: bending a
        # consistent trajectory would inject the loop's verification noise
        N = len(self.keyframes)
        poses_old = np.stack([k.world_T_ref for k in self.keyframes])
        match_idx = next(i for i, k in enumerate(self.keyframes)
                         if k.kf_id == det.match_kf)
        pred_query = poses_old[match_idx] @ det.rel_pose
        delta = np.linalg.inv(kf.world_T_ref) @ pred_query
        d_trans = float(np.linalg.norm(delta[:3, 3]))
        d_rot = float(np.arccos(np.clip((np.trace(delta[:3, :3]) - 1) / 2,
                                        -1, 1)))
        run_pgo = (d_trans > cfg.loop_pgo_min_trans
                   or d_rot > cfg.loop_pgo_min_rot)
        scales = np.ones(N, np.float32)
        poses_new = poses_old
        if run_pgo:
            meas = np.einsum("nij,njk->nik", np.linalg.inv(poses_old[:-1]),
                             poses_old[1:])
            ei = np.arange(N - 1, dtype=np.int32)
            graph = pgo.PoseGraph(
                poses=self._to_device(poses_old.astype(np.float32)),
                edge_i=self._to_device(np.append(ei, match_idx).astype(
                    np.int32)),
                edge_j=self._to_device(np.append(ei + 1, N - 1).astype(
                    np.int32)),
                edge_meas=self._to_device(np.concatenate(
                    [meas, det.rel_pose[None]]).astype(np.float32)),
                edge_weight=self._to_device(np.append(
                    np.ones(N - 1), float(det.n_inliers)).astype(np.float32)),
                edge_valid=self._to_device(np.ones(N, bool)),
                anchor=0)
            if self.rig.num_cams == 1:
                # monocular: scale drifts too, relax over Sim(3)
                p7, s7 = pgo.pgo_solve_sim3(graph, iters=8)
                v = torch.cat([p7.reshape(-1), s7]).cpu().numpy()
                poses_new = v[:N * 16].reshape(N, 4, 4)
                scales = v[N * 16:].astype(np.float32)
            else:
                poses_new = pgo.pgo_solve(graph, iters=8).cpu().numpy()
            self.stats["pgo"] = self.stats.get("pgo", 0) + 1
            # marginal priors linearized at the pre-loop poses are stale
            self._vis_marg_prior = None
            self._marg_prior = None

        # 3. re-anchor landmarks with their first-observing keyframe's
        # full correction: X_new = s R_new R_old^T (X_old - t_old) + t_new
        valid_ids = np.nonzero(self.map.valid)[0]
        id2idx = {k.kf_id: i for i, k in enumerate(self.keyframes)}
        fidx = np.array([id2idx.get(int(f), 0)
                         for f in self.map.first_kf[valid_ids]], np.int64)
        R_corr = np.einsum("nij,nkj->nik", poses_new[fidx, :3, :3],
                           poses_old[fidx, :3, :3])
        p = self.map.pos[valid_ids] - poses_old[fidx, :3, 3]
        self.map.pos[valid_ids] = (
            scales[fidx, None] * np.einsum("nij,nj->ni", R_corr, p)
            + poses_new[fidx, :3, 3])
        self.dmap.upsert(valid_ids, pos=self.map.pos[valid_ids])
        for i, k in enumerate(self.keyframes):
            k.world_T_ref = poses_new[i]
        self.cur_pose = poses_new[-1].copy()

        # 4. digest the loop evidence in BA: a window of [matched old
        # keyframe] + recent keyframes, gauge on the old one
        recent = [k for k in self.keyframes[-(cfg.window_size - 1):]
                  if k.kf_id != det.match_kf]
        self._solve_window([self.keyframes[match_idx]] + recent,
                           force_sync=True, allow_vio=False)

        # 5. re-triangulate from the corrected poses, but only when poses
        # moved (it would replace BA-refined positions by noisier anchor
        # triangulations), then 6. global BA
        if run_pgo:
            self._retriangulate_landmarks()
            if cfg.global_ba:
                self._run_global_ba()

    def _run_global_ba(self):
        """BA over every vision keyframe (an even subsample beyond
        global_ba_max_kfs) and every landmark they see >= 2 times, padded to
        power-of-two Kb / L / Ok buckets with clamped pad slots; queued and
        landed by _finish_pending_gba (at once unless async_gba)."""
        cfg = self.cfg
        vis = [k for k in self.keyframes if not k.is_dummy]
        if len(vis) < 3:
            return
        if len(vis) > cfg.global_ba_max_kfs:
            step = (len(vis) - 1) / (cfg.global_ba_max_kfs - 1)
            sel_idx = sorted({round(i * step)
                              for i in range(cfg.global_ba_max_kfs)})
        else:
            sel_idx = list(range(len(vis)))
        sel = [vis[i] for i in sel_idx]
        K = len(sel)
        Kb = 8
        while Kb < K:
            Kb *= 2
        Kb = min(Kb, max(cfg.global_ba_max_kfs, 8))

        all_ids = np.concatenate([k.lm_id[k.lm_id >= 0] for k in sel])
        uniq, counts = np.unique(all_ids, return_counts=True)
        keep = (counts >= 2) & self.map.valid[uniq]
        uniq, counts = uniq[keep], counts[keep]
        if len(uniq) < 30:
            return
        if len(uniq) > cfg.global_ba_lm_capacity:
            # the most-observed landmarks constrain the most poses
            order = np.argsort(-counts, kind="stable")
            uniq = uniq[order[:cfg.global_ba_lm_capacity]]
        lm_ids = np.sort(uniq)
        L = 256
        while L < len(lm_ids):
            L *= 2
        L = min(L, cfg.global_ba_lm_capacity)
        lm_ids = lm_ids[:L]

        slot_lookup = np.full(self.map.capacity, -1, np.int32)
        slot_lookup[lm_ids] = np.arange(len(lm_ids), dtype=np.int32)
        kf_pairs = []
        need_ok = 0
        for kf in sel:
            slots = slot_lookup[np.maximum(kf.lm_id, 0)]
            m_ok = (kf.lm_id >= 0) & (slots >= 0)
            mm, cc = np.nonzero(m_ok[:, None] & kf.ray_valid)
            kf_pairs.append((slots, mm, cc))
            need_ok = max(need_ok, len(mm))
        Ok = 64
        while Ok < need_ok and Ok < cfg.global_ba_obs_per_kf:
            Ok *= 2
        Ok = min(Ok, cfg.global_ba_obs_per_kf)
        O = Ok * Kb
        obs_cam = np.zeros(O, np.int32)
        obs_lm = np.zeros(O, np.int32)
        obs_uv = np.zeros((O, 2), np.float32)
        obs_s2 = np.ones(O, np.float32)
        obs_val = np.zeros(O, bool)
        n_obs = 0
        for wk, kf in enumerate(sel):
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
        if n_obs < 60:
            return
        poses_old = np.tile(np.eye(4, dtype=np.float32), (Kb, 1, 1))
        poses_old[:K] = np.stack([k.world_T_ref for k in sel])
        kf_valid = np.arange(Kb) < K
        lms = np.zeros((L, 3), np.float32)
        lms[:len(lm_ids)] = self.map.pos[lm_ids]
        prior_H = np.zeros((Kb * 6, Kb * 6), np.float32)
        prior_H[:6, :6] = np.eye(6) * 1e6  # gauge on the first keyframe
        for pk in range(K, Kb):  # clamp the padded slots
            prior_H[pk * 6:(pk + 1) * 6, pk * 6:(pk + 1) * 6] = np.eye(6) * 1e6
        obs = ba.BAObservations(
            kf=np.repeat(np.arange(Kb, dtype=np.int32), Ok), cam=obs_cam,
            lm=obs_lm, uv=obs_uv, sigma2=obs_s2, valid=obs_val)
        if self.mesh is not None:
            # landmark-sharded over the mesh: the table regrouped by
            # landmark shard on the host (L is a power of two, divisible
            # by the mesh)
            obs = sharded_ba.shard_by_landmark(obs, L, self.mesh.size)
        problem = ba.problem_from_numpy(
            poses_old, lms, np.arange(L) < len(lm_ids), obs,
            self.rig.cam_T_ref, self.rig.fxycxy, prior_H,
            np.zeros(Kb * 6, np.float32), kf_valid, device=self.device)
        result = self._dispatch_solve(problem, cfg.global_ba_iters,
                                      landmark_sharded=True)
        # deferred write-back: the PGO bend and the landmark merge (already
        # applied) carry tracking while the solve runs
        self._pending_gba = {
            "sp": result.poses, "sl": result.landmarks,
            "sel_kf_ids": [k.kf_id for k in sel],
            "poses_old": poses_old[:K].copy(), "lm_ids": lm_ids}
        self._gba_dispatch_frame = self.stats["frames"]
        if not cfg.async_gba:
            self._finish_pending_gba()

    def _finish_pending_gba(self):
        """Land a deferred global BA: one fetch; write the selected
        keyframes, move every other vision keyframe (also ones inserted
        since dispatch) by its nearest optimized neighbour's correction,
        and write the landmarks."""
        pg = getattr(self, "_pending_gba", None)
        if pg is None:
            return
        self._pending_gba = None
        stream = self._ba_side_stream()
        if stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(stream)
        sel_kf_ids, lm_ids = pg["sel_kf_ids"], pg["lm_ids"]
        K, n_lm = len(sel_kf_ids), len(lm_ids)
        v = torch.cat([pg["sp"][:K].reshape(-1),
                       pg["sl"][:n_lm].reshape(-1)]).cpu().numpy()
        new_poses = v[:K * 16].reshape(K, 4, 4)
        new_lms = v[K * 16:].reshape(n_lm, 3)
        id2kf = {k.kf_id: k for k in self.keyframes}
        corr_ids, corrs = [], []
        for j, kid in enumerate(sel_kf_ids):
            kf = id2kf.get(kid)
            if kf is None:
                continue
            corrs.append((new_poses[j] @ np.linalg.inv(
                pg["poses_old"][j])).astype(np.float32))
            corr_ids.append(kid)
            kf.world_T_ref = new_poses[j].astype(np.float32)
        if corr_ids:
            corr_arr = np.asarray(corr_ids)
            sel_set = set(corr_ids)
            for k in self.keyframes:
                if k.is_dummy or k.kf_id in sel_set:
                    continue
                nearest = int(np.argmin(np.abs(corr_arr - k.kf_id)))
                k.world_T_ref = (corrs[nearest] @ k.world_T_ref).astype(
                    np.float32)
            # the live pose rides the newest keyframe's correction
            self.cur_pose = (corrs[-1] @ self.cur_pose).astype(np.float32)
            self.last_pose = (corrs[-1] @ self.last_pose).astype(np.float32)
        # landmarks: a direct write (global corrections may exceed the
        # incremental update gate); slots freed since dispatch are skipped
        alive = self.map.valid[lm_ids]
        lm_ids, new_lms = lm_ids[alive], new_lms[alive]
        if len(lm_ids):
            self.map.pos[lm_ids] = new_lms
            self.dmap.upsert(lm_ids, pos=new_lms)
        self.stats["global_ba"] = self.stats.get("global_ba", 0) + 1
        # marginal priors are linearized at pre-global-BA poses
        self._vis_marg_prior = None
        self._marg_prior = None

    def _retriangulate_landmarks(self, min_obs: int = 2, max_rays: int = 4):
        """Re-triangulate every landmark observed by >= min_obs keyframes
        (the widest-baseline max_rays observations); landmarks whose
        triangulation fails (chi2, cheirality, parallax) are deleted and
        their keyframe references cleared. One triangulation call on the
        session's device."""
        lm_p, uv_p, anc_p, sig_p, kfi_p = [], [], [], [], []
        for i, k in enumerate(self.keyframes):
            s = np.nonzero((k.lm_id >= 0) & k.im_valid)[0]
            lm_p.append(k.lm_id[s])
            uv_p.append(k.im_uv[s])
            anc_p.append(k.im_anchor_cam[s])
            sig_p.append(k.im_sigma2[s])
            kfi_p.append(np.full(len(s), i, np.int32))
        if not lm_p:
            return
        lm_all = np.concatenate(lm_p)
        keep = self.map.valid[lm_all]
        lm_all = lm_all[keep]
        uv_all = np.concatenate(uv_p)[keep]
        anc_all = np.concatenate(anc_p)[keep]
        sig_all = np.concatenate(sig_p)[keep]
        kfi_all = np.concatenate(kfi_p)[keep]
        if len(lm_all) == 0:
            return
        order = np.argsort(lm_all, kind="stable")
        uniq, starts, counts = np.unique(lm_all[order], return_index=True,
                                         return_counts=True)
        tgt = counts >= min_obs
        uniq, starts, counts = uniq[tgt], starts[tgt], counts[tgt]
        n = len(uniq)
        if n == 0:
            return
        R = max_rays
        idx_sel = np.zeros((n, R), np.int64)
        ray_mask = np.zeros((n, R), bool)
        for row in range(n):
            s, c = starts[row], counts[row]
            if c <= R:
                idx_sel[row, :c] = order[s:s + c]
                ray_mask[row, :c] = True
            else:
                # widest baseline: first and last observing keyframes
                h1 = R // 2
                idx_sel[row, :h1] = order[s:s + h1]
                idx_sel[row, h1:] = order[s + c - (R - h1):s + c]
                ray_mask[row] = True
        poses_all = np.stack([k.world_T_ref for k in self.keyframes])
        inv_ctr = np.linalg.inv(self.rig.cam_T_ref.cpu().numpy())
        anc = anc_all[idx_sel]
        wTc = np.einsum("nrij,nrjk->nrik", poses_all[kfi_all[idx_sel]],
                        inv_ctr[anc]).astype(np.float32)
        f = self.rig.fxycxy.cpu().numpy()[anc]
        X, ok = _triangulate_pairs(
            self._to_device(wTc),
            self._to_device(uv_all[idx_sel].astype(np.float32)),
            self._to_device(f.astype(np.float32)), self._to_device(ray_mask),
            self._to_device(np.maximum(sig_all[idx_sel], 1e-3).astype(
                np.float32)))
        v = torch.cat([X.reshape(-1), ok.to(X.dtype)]).cpu().numpy()
        X, ok = v[:3 * n].reshape(n, 3), v[3 * n:] > 0.5
        good = uniq[ok]
        if len(good):
            # a direct write: loop corrections may exceed the update gate
            self.map.pos[good] = X[ok]
            self.dmap.upsert(good, pos=X[ok])
        bad = uniq[~ok]
        if len(bad):
            drop = np.zeros(self.map.capacity, bool)
            drop[bad] = True
            for k in self.keyframes:
                m = (k.lm_id >= 0) & drop[np.maximum(k.lm_id, 0)]
                if m.any():
                    k.lm_id[m] = -1
                    k.lm_dirty()
            self._map_delete(bad)
