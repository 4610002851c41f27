"""Relocalization against a saved session map (counterpart of
mcslam_tpu/loop/reloc.py).

Loads a saved BoW database and JSON map (or a "navability" map, scored by
BoW vectors computed from its stored descriptors); for an incoming frame
it scores the database (host matvec), descriptor-matches the best
candidates' landmarks (Hamming matrix and mutual-best matching on the
frame's device) and verifies by RANSAC-PnP and the robust pose LM
(`pose_lm`) with a minimum inlier ratio -> the world pose. RANSAC draws
from a torch.Generator of the given seed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mcslam_tpu_torch.frontend import pose_opt, ransac
from mcslam_tpu_torch.ops import hamming, match as match_ops
from mcslam_tpu_torch.utils import mapio


@dataclasses.dataclass
class RelocConfig:
    top_candidates: int = 3
    min_matches: int = 15
    min_inlier_ratio: float = 0.04
    min_inliers: int = 12
    max_dist: int = 64
    ratio: float = 0.9
    ransac_px: float = 6.0


class Relocalizer:
    """Loads a saved session (vocabulary database + JSON map) and
    localizes incoming frames against it."""

    def __init__(self, vocab, rig, map_path, db_path,
                 config: RelocConfig = None, seed: int = 0,
                 _preloaded=None):
        self.vocab = vocab
        self.rig = rig
        self.device = rig.device
        self.cfg = config or RelocConfig()
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        kfs, lms = (_preloaded if _preloaded is not None
                    else mapio.load_map_json(map_path))
        self.kf_entries = kfs
        # the stored landmark table; each entry's landmarks as slots in it
        self.lm_ids = sorted(lms.keys())
        id2slot = {lid: i for i, lid in enumerate(self.lm_ids)}
        self.lm_pos = np.stack([lms[lid][0] for lid in self.lm_ids])
        self.lm_desc = np.stack([lms[lid][1] for lid in self.lm_ids])
        for e in self.kf_entries:
            e["slots"] = np.array([id2slot[int(lid)] for lid in e["lids"]],
                                  np.int32)
        if db_path is not None:
            z = np.load(db_path)
            self.db_bows = z["bows"]
            self.db_kf_ids = z["kf_ids"]
        else:
            # no saved database (navability maps ship none): BoW vectors of
            # each entry's stored landmark descriptors
            bows, ids = [], []
            for e in self.kf_entries:
                if len(e["descs"]) == 0:
                    continue
                d = hamming.desc_to_torch(e["descs"], self.device)
                bows.append(self.vocab.transform(
                    d, torch.ones(len(e["descs"]), dtype=torch.bool,
                                  device=self.device)).cpu().numpy())
                ids.append(e["kfID"])
            V = getattr(self.vocab, "num_words", 1)
            self.db_bows = (np.stack(bows) if bows
                            else np.zeros((0, V), np.float32))
            self.db_kf_ids = np.array(ids, np.int64)
        self._kf_by_id = {e["kfID"]: e for e in self.kf_entries}

    @classmethod
    def from_navability(cls, vocab, rig, features_path, poses_path,
                        config: RelocConfig = None, seed: int = 0):
        """Relocalize against an external "navability" two-file JSON map,
        through the same query / verify pipeline."""
        pre = mapio.load_map_navability(features_path, poses_path)
        return cls(vocab, rig, None, None, config=config, seed=seed,
                   _preloaded=pre)

    def relocalize(self, frame) -> Optional[np.ndarray]:
        """FrameFeatures -> world_T_ref (4, 4) or None."""
        if len(self.db_bows) == 0:
            return None
        bow = self.vocab.transform(frame.im_desc, frame.im_valid)
        scores = self.db_bows @ bow.cpu().numpy()
        for ci in np.argsort(-scores)[:self.cfg.top_candidates]:
            entry = self._kf_by_id.get(int(self.db_kf_ids[ci]))
            if entry is None or len(entry["slots"]) == 0:
                continue
            pose = self._verify(frame, entry)
            if pose is not None:
                return pose
        return None

    def _verify(self, frame, entry) -> Optional[np.ndarray]:
        cfg = self.cfg
        dev = frame.im_desc.device
        cand_desc = hamming.desc_to_torch(self.lm_desc[entry["slots"]], dev)
        d = hamming.hamming_matrix(frame.im_desc, cand_desc)
        res = match_ops.match_mutual(
            d, row_mask=frame.im_valid,
            col_mask=torch.ones(cand_desc.shape[0], dtype=torch.bool,
                                device=dev),
            max_dist=cfg.max_dist, ratio=cfg.ratio)
        v = torch.stack([res.ok.to(torch.int32), res.idx]).cpu().numpy()
        ok, idx = v[0] > 0, v[1]
        return verify_pnp(self.gen, self.rig, frame, ok,
                          self.lm_pos[entry["slots"]], idx, cfg.min_matches,
                          cfg.ransac_px, cfg.min_inliers,
                          cfg.min_inlier_ratio)


def verify_pnp(gen, rig, frame, ok, lm_pos, idx, min_matches, ransac_px,
               min_inliers, min_inlier_ratio) -> Optional[np.ndarray]:
    """RANSAC-PnP then the robust pose LM of the frame's rig against the
    matched landmarks (frame slot m -> lm_pos[idx[m]] where ok[m]), with
    the count, inlier-ratio and inlier gates -> world_T_ref or None (the
    relocalizer's and the fast tracker's shared verification)."""
    n = int(ok.sum())
    if n < min_matches:
        return None
    dev = frame.im_desc.device
    X_world = np.zeros((len(ok), 3), np.float32)
    X_world[ok] = lm_pos[idx[ok]]
    Xw = torch.from_numpy(X_world).to(dev)
    msk = torch.from_numpy(ok).to(dev)
    anchor = frame.im_anchor_cam.long()
    cam_T_ref, fxy = rig.cam_T_ref[anchor], rig.fxycxy[anchor]
    rr = ransac.ransac_pnp(gen, Xw, frame.im_uv_ref, cam_T_ref, fxy, msk,
                           num_hyp=256, px_thresh=ransac_px,
                           min_inliers=min_inliers)
    v = torch.stack([rr.ok.to(torch.int32), rr.num_inliers]).cpu().numpy()
    if not v[0] or v[1] < min_inlier_ratio * n:
        return None
    ref = pose_opt.optimize_pose(rr.world_T_ref, Xw, frame.im_uv_ref,
                                 cam_T_ref, fxy, msk & rr.inliers,
                                 sigma2=frame.im_sigma2)
    v = torch.cat([ref.num_inliers.reshape(1).to(torch.float32),
                   ref.world_T_ref.reshape(16)]).cpu().numpy()
    if int(v[0]) < min_inliers:
        return None
    return v[1:].reshape(4, 4)
