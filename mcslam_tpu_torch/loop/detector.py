"""Loop-closure detection: BoW retrieval, temporal consistency and
geometric verification (counterpart of mcslam_tpu/loop/detector.py).

The database, retrieval (nss gate, alpha threshold, islands, temporal
consistency with group expiry) and their host numpy bookkeeping are the
JAX package's code. The BoW transform, descriptor matching and
verification run on the rig's device: the Hamming matrix and mutual-best
matching with the vocabulary-node pair mask (the direct index), then
RANSAC-PnP and the robust pose LM (`pose_lm`) against the matched old
keyframe's landmarks, or the 17-point 2D-2D check where that keyframe has
too few landmarks. RANSAC draws from a torch.Generator of the given seed
(the driver passes seed + 1, as the JAX driver seeds its PRNGKey). Each
verification reads its verdict on the host (`bool(rr.ok)`, the inlier
count), as the JAX driver does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mcslam_tpu_torch.frontend import pose_opt, ransac, seventeen
from mcslam_tpu_torch.ops import hamming, match as match_ops


@dataclasses.dataclass
class LoopConfig:
    """The JAX package's LoopConfig, field for field with the same
    defaults (see mcslam_tpu/loop/detector.py for each rationale)."""

    alpha: float = 0.2  # candidate score >= alpha * nss
    min_nss: float = 0.05
    k_consistency: int = 2  # temporal consistency frames
    dislocal: int = 20  # exclude this many recent keyframes
    island_gap: int = 3  # max id gap within an island
    group_expiry: int = 3  # groups die after this many unextended KFs
    min_matches: int = 20
    min_inliers: int = 12
    ransac_px: float = 5.0
    max_dist: int = 64
    ratio: float = 0.85
    # direct index: also accept mutual-best pairs within a shared
    # vocabulary node di_levels above the leaves (0 disables)
    di_levels: int = 2
    # ranked retrieval candidates tried by verification (first wins)
    max_verify_candidates: int = 3
    # 17-point 2D-2D check where the old keyframe has too few landmarks
    # (needs a non-central rig for metric scale)
    seventeen_fallback: bool = True
    seventeen_min_inliers: int = 30
    seventeen_scale_hi: float = 10.0  # |t| ceiling [m]


@dataclasses.dataclass
class LoopDetection:
    detected: bool
    query_kf: int = -1
    match_kf: int = -1
    # relative pose: match_T_query (match-KF frame from query frame)
    rel_pose: Optional[np.ndarray] = None
    world_T_query: Optional[np.ndarray] = None
    lm_ids: Optional[np.ndarray] = None  # matched old landmark ids
    query_slots: Optional[np.ndarray] = None  # intra slots in the query
    n_inliers: int = 0


class LoopCloser:
    """Host driver; owns the BoW database and the consistency state."""

    def __init__(self, vocab, rig, config: LoopConfig = None, seed: int = 0):
        self.vocab = vocab
        self.rig = rig
        self.device = rig.device
        self.cfg = config or LoopConfig()
        # per-keyframe BoW rows in a preallocated matrix (doubling growth):
        # retrieval is one matvec over a contiguous view
        self._bow_mat = np.zeros((64, vocab.num_words), np.float32)
        self._n_bows = 0
        self.kf_ids: list[int] = []
        self._last_bow: Optional[np.ndarray] = None
        # temporal-consistency groups: (island ids, count, db size at the
        # last extension)
        self._consistent_groups: list[tuple[set, int, int]] = []
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def _up(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _desc(self, a) -> torch.Tensor:
        return hamming.desc_to_torch(a, self.device)

    # -- database ----------------------------------------------------------

    def compute_bow(self, desc: torch.Tensor, valid: torch.Tensor):
        return self.vocab.transform(desc, valid).cpu().numpy()

    @property
    def bows(self) -> list[np.ndarray]:
        """Row views of the stored BoW vectors."""
        return [self._bow_mat[i] for i in range(self._n_bows)]

    @bows.setter
    def bows(self, rows):
        rows = list(rows)
        self._bow_mat = np.zeros((max(64, len(rows)), self.vocab.num_words),
                                 np.float32)
        for i, r in enumerate(rows):
            self._bow_mat[i] = r
        self._n_bows = len(rows)

    def add_keyframe(self, kf_id: int, bow: np.ndarray):
        if self._n_bows == self._bow_mat.shape[0]:
            grown = np.zeros((2 * self._bow_mat.shape[0],
                              self._bow_mat.shape[1]), np.float32)
            grown[:self._n_bows] = self._bow_mat
            self._bow_mat = grown
        self._bow_mat[self._n_bows] = bow
        self._n_bows += 1
        self.kf_ids.append(kf_id)

    def save_database(self, path):
        np.savez_compressed(path, bows=self._bow_mat[:self._n_bows].copy(),
                            kf_ids=np.asarray(self.kf_ids, np.int32))

    def load_database(self, path):
        z = np.load(path)
        self.bows = z["bows"]
        self.kf_ids = [int(i) for i in z["kf_ids"]]

    # -- detection ---------------------------------------------------------

    def detect(self, query_kf, frame_desc, frame_valid, keyframes, lm_map):
        """Full detection for a new keyframe (already posed): retrieval,
        then verification of up to max_verify_candidates candidates;
        adds the query to the database -> LoopDetection."""
        bow = self.compute_bow(frame_desc, frame_valid)
        detection = LoopDetection(detected=False, query_kf=query_kf.kf_id)
        for cand in self.retrieve_topn(bow, self.cfg.max_verify_candidates):
            detection = self._verify(query_kf, keyframes[cand], lm_map)
            if detection.detected:
                break
        self.add_keyframe(query_kf.kf_id, bow)
        return detection

    def retrieve(self, bow: np.ndarray):
        """The best single candidate of retrieve_topn, or None."""
        top = self.retrieve_topn(bow, 1)
        return top[0] if top else None

    def retrieve_topn(self, bow: np.ndarray, n: int) -> list[int]:
        """Retrieval alone: the nss gate against the previous query, the
        alpha threshold over the usable database, island grouping and
        temporal consistency -> up to n database indices, the best
        island's best entry first, then the next-scored candidates, or []
        when no candidate passes. Mutates the consistency state
        (sequential queries form the evidence chain)."""
        cfg = self.cfg
        prev_bow = self._last_bow
        self._last_bow = bow
        n_db = self._n_bows
        # groups age on every keyframe, also one with no candidate
        self._consistent_groups = [
            (g, c, last) for (g, c, last) in self._consistent_groups
            if n_db - last <= cfg.group_expiry]
        usable = n_db - cfg.dislocal
        if usable > 0 and prev_bow is not None:
            nss = float(bow @ prev_bow)
            if nss >= cfg.min_nss:
                scores = self._bow_mat[:usable] @ bow
                cand = np.nonzero(scores >= cfg.alpha * nss)[0]
                if len(cand):
                    best = self._best_island(cand, scores)
                    if best is not None and self._temporally_consistent(
                            best, n_db):
                        first = int(best[np.argmax(scores[best])])
                        order = cand[np.argsort(scores[cand])[::-1]]
                        rest = [int(i) for i in order if int(i) != first]
                        return [first] + rest[:max(n - 1, 0)]
        return []

    def _best_island(self, cand: np.ndarray, scores: np.ndarray):
        """Group candidate ids into islands of nearby ids -> the island
        (id array) with the best summed score."""
        islands, cur = [], [cand[0]]
        for c in cand[1:]:
            if c - cur[-1] <= self.cfg.island_gap:
                cur.append(c)
            else:
                islands.append(np.asarray(cur))
                cur = [c]
        islands.append(np.asarray(cur))
        sums = [scores[i].sum() for i in islands]
        return islands[int(np.argmax(sums))]

    def _temporally_consistent(self, island: np.ndarray, n_db: int) -> bool:
        """cfg.k_consistency consecutive detections with overlapping
        islands; groups the island does not extend survive until expiry."""
        cfg = self.cfg
        ids = set(int(i) for i in island)
        matched = False
        new_groups = []
        extended = False
        for group, count, last in self._consistent_groups:
            near = any(abs(i - j) <= cfg.island_gap
                       for i in ids for j in group)
            if near and not extended:
                extended = True
                new_groups.append((ids, count + 1, n_db))
                if count + 1 >= cfg.k_consistency:
                    matched = True
            else:
                new_groups.append((group, count, last))  # ages to expiry
        if not extended:
            new_groups.append((ids, 1, n_db))
        self._consistent_groups = new_groups
        return matched or cfg.k_consistency <= 1

    def _match_direct_index(self, q_desc, q_valid, o_desc, o_mask):
        """Union of global mutual-best matching and direct-index bucketed
        matching (pairs sharing a vocabulary node di_levels above the
        leaves); global matches win. Host numpy inputs (uint32 words,
        bool masks) -> (MatchResult, distance matrix) on the device."""
        cfg = self.cfg
        qd, od = self._desc(q_desc), self._desc(o_desc)
        qv, ov = self._up(q_valid), self._up(o_mask)
        d = hamming.hamming_matrix(qd, od)
        g = match_ops.match_mutual(d, row_mask=qv, col_mask=ov,
                                   max_dist=cfg.max_dist, ratio=cfg.ratio)
        if cfg.di_levels <= 0 or self.vocab is None:
            return g, d
        nq = self.vocab.node_ids(qd, cfg.di_levels)
        no = self.vocab.node_ids(od, cfg.di_levels)
        b = match_ops.match_mutual(d, row_mask=qv, col_mask=ov,
                                   max_dist=cfg.max_dist, ratio=cfg.ratio,
                                   pair_mask=nq[:, None] == no[None, :])
        return match_ops.MatchResult(
            idx=torch.where(g.ok, g.idx, b.idx),
            dist=torch.where(g.ok, g.dist, b.dist), ok=g.ok | b.ok), d

    @staticmethod
    def _ok_idx(res):
        """(ok, idx) of a MatchResult on the host, one copy."""
        v = torch.stack([res.ok.to(torch.int32), res.idx]).cpu().numpy()
        return v[0] > 0, v[1]

    def _verify(self, query_kf, old_kf, lm_map) -> LoopDetection:
        """Descriptor match of the query's and the old keyframe's intra
        features, then robust absolute pose of the query rig against the
        old keyframe's landmarks."""
        cfg = self.cfg
        fail = LoopDetection(False, query_kf.kf_id, old_kf.kf_id)
        res, _ = self._match_direct_index(
            query_kf.im_desc, query_kf.im_valid, old_kf.im_desc,
            old_kf.im_valid & (old_kf.lm_id >= 0))
        ok, idx = self._ok_idx(res)
        lm = np.where(ok, old_kf.lm_id[idx], -1)
        lm = np.where((lm >= 0) & lm_map.valid[np.maximum(lm, 0)], lm, -1)
        if int((lm >= 0).sum()) < cfg.min_matches:
            if int((old_kf.lm_id >= 0).sum()) < cfg.min_matches:
                # the landmark check cannot run: the 2D-2D 17-point check
                return self._verify_seventeen(query_kf, old_kf)
            # matching failed against an old keyframe with landmarks:
            # evidence against the candidate
            return fail

        M = len(ok)
        sel = lm >= 0
        X_world = np.zeros((M, 3), np.float32)
        X_world[sel] = lm_map.pos[lm[sel]]
        anchor = self._up(query_kf.im_anchor_cam).long()
        cam_T_ref = self.rig.cam_T_ref[anchor]
        fxy = self.rig.fxycxy[anchor]
        Xw, uv, msk = self._up(X_world), self._up(query_kf.im_uv), \
            self._up(sel)
        rr = ransac.ransac_pnp(self.gen, Xw, uv, cam_T_ref, fxy, msk,
                               num_hyp=256, px_thresh=cfg.ransac_px,
                               min_inliers=cfg.min_inliers)
        if not bool(rr.ok):
            # the landmark path ran and rejected: no 2D-2D re-check
            return fail
        ref = pose_opt.optimize_pose(
            rr.world_T_ref, Xw, uv, cam_T_ref, fxy, msk & rr.inliers,
            sigma2=self._up(query_kf.im_sigma2))
        v = torch.cat([ref.num_inliers.reshape(1).to(torch.float32),
                       ref.world_T_ref.reshape(16),
                       ref.inliers.to(torch.float32)]).cpu().numpy()
        n_inl = int(v[0])
        if n_inl < cfg.min_inliers:
            return fail
        world_T_query = v[1:17].reshape(4, 4)
        inl = v[17:] > 0.5
        rel = np.linalg.inv(old_kf.world_T_ref) @ world_T_query
        return LoopDetection(
            detected=True, query_kf=query_kf.kf_id, match_kf=old_kf.kf_id,
            rel_pose=rel, world_T_query=world_T_query, lm_ids=lm[inl],
            query_slots=np.nonzero(inl)[0], n_inliers=n_inl)

    def _verify_seventeen(self, query_kf, old_kf) -> LoopDetection:
        """2D-2D fallback: non-central relative pose between the two rigs
        from descriptor matches alone (non-central rigs only: metric
        scale needs the lever arm)."""
        cfg = self.cfg
        fail = LoopDetection(False, query_kf.kf_id, old_kf.kf_id)
        if not cfg.seventeen_fallback or not seventeen.is_noncentral(
                self.rig):
            return fail
        res, _ = self._match_direct_index(
            query_kf.im_desc, query_kf.im_valid, old_kf.im_desc,
            old_kf.im_valid)
        ok, idx = self._ok_idx(res)
        if ok.sum() < max(cfg.min_matches, 17):
            return fail
        # frame1 = old keyframe, frame2 = query -> rel_T = old_T_query
        f1, o1 = seventeen.plucker_rays(
            self._up(old_kf.im_uv[idx]), self._up(old_kf.im_anchor_cam[idx]),
            self.rig)
        f2, o2 = seventeen.plucker_rays(
            self._up(query_kf.im_uv), self._up(query_kf.im_anchor_cam),
            self.rig)
        mean_f = float(self.rig.fxycxy[:, 0].mean())
        thr = float(2.0 * (1.0 - np.cos(cfg.ransac_px / mean_f)))
        sr = seventeen.ransac_seventeen(
            self.gen, f1, o1, f2, o2, self._up(ok), angle_thresh=thr,
            min_inliers=cfg.seventeen_min_inliers,
            scale_hi=cfg.seventeen_scale_hi)
        if not bool(sr.ok):
            return fail
        v = torch.cat([sr.num_inliers.reshape(1).to(torch.float32),
                       sr.rel_T.reshape(16),
                       sr.inliers.to(torch.float32)]).cpu().numpy()
        rel = v[1:17].reshape(4, 4)  # old_T_query
        world_T_query = (old_kf.world_T_ref @ rel).astype(np.float32)
        inl = (v[17:] > 0.5) & ok
        lm = np.where(inl, old_kf.lm_id[idx], -1)
        sel = lm >= 0
        return LoopDetection(
            detected=True, query_kf=query_kf.kf_id, match_kf=old_kf.kf_id,
            rel_pose=rel, world_T_query=world_T_query, lm_ids=lm[sel],
            query_slots=np.nonzero(sel)[0], n_inliers=int(v[0]))
