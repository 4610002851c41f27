"""Per-frame tracking programs (counterpart of mcslam_tpu/tracking_kernels.py):
projection-gated matching to the reference keyframe, the pose-candidate
portfolio with its motion-model fast path, robust motion-only LM, and
local-map tracking, with the JAX package's packed output layout.

Both matchers go through the gated matching kernel (ops/match_cuda),
every pose refine through the one-launch LM (frontend/pose_opt_cuda), as
on the TPU, and every RANSAC hypothesis batch and reprojection score
through the RANSAC kernels (frontend/ransac_cuda). The fast-path
decision is taken by `branch`: "host" reads it once per frame (one
device sync) and runs one side; "device" keeps it on
the device, as the JAX program's lax.cond does: utils/graphs.cond runs
the portfolio as a conditional node of a captured frame program (the
session's graphed frame step) and, outside a capture, runs both sides and
selects on the device. Both modes draw the RANSAC samples in the same
order from the same generator; "device" draws them before the branch, on
fast-path frames too.

`_triangulate_pairs` is the two-view triangulation of keyframe
insertion; `_match_descriptors`, `_mutual_match` and
`_triangulate_pairs_far` serve the monocular and 17-point bootstraps.

Packed layout of `_track_and_map_step` / `_build_and_track_step`
(M = intra slots): [pose (16), n_uniform, n_matches, n_with_lm, rr_ok,
fastpath, ok (M), match idx (M), lm id (M), local-map pose (16),
local-map lm id (M), local-map inliers (M)].
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mcslam_tpu_torch.frontend import (pose_opt, ransac, ransac_cuda,
                                      track_cuda)
from mcslam_tpu_torch.geometry import triangulation
from mcslam_tpu_torch.ops import hamming, match as match_ops, match_cuda, orb
from mcslam_tpu_torch.utils import graphs

_GATE_BIG = track_cuda.GATE_BIG
LM_SCHED = (8, 8)  # per-round LM schedule of every refine on this path


def map_mirror_from_numpy(pos, valid, desc_u32, normal, device="cuda"):
    """(pos (L, 3), valid (L,), desc (L, 8) int32 words, normal (L, 3))
    tensors from numpy map-mirror arrays (uint32 descriptors)."""
    return (
        torch.tensor(np.asarray(pos, np.float32), device=device),
        torch.tensor(np.asarray(valid, bool), device=device),
        hamming.desc_to_torch(desc_u32, device),
        torch.tensor(np.asarray(normal, np.float32), device=device),
    )


def _one_hot(idx, n: int, dtype):
    """(M,) indices -> (M, n) 0/1 rows (F.one_hot checks its range on
    the host, a sync on the CPU)."""
    return (idx.long()[:, None]
            == torch.arange(n, device=idx.device)[None, :]).to(dtype)


def _anchored_sq_px_dist(uv, anchor, proj, penalize):
    """(M, N) squared pixel distance from each row feature to each column
    target's projection in the row's anchor camera, as two matmuls over
    one-hot anchor weights (no (M, N, 2) gather). uv (M, 2); anchor (M,);
    proj (C, N, 2); penalize (C, N) adds _GATE_BIG."""
    C = proj.shape[0]
    oh = _one_hot(anchor, C, uv.dtype)
    P2 = torch.sum(proj * proj, dim=-1) + _GATE_BIG * penalize.to(uv.dtype)
    A = (oh[:, :, None] * uv[:, None, :]).reshape(uv.shape[0], 2 * C)
    B = proj.permute(0, 2, 1).reshape(2 * C, proj.shape[1])
    return torch.sum(uv * uv, dim=-1)[:, None] - 2.0 * (A @ B) + oh @ P2


def _gate_factors(uv, anchor, proj, penalize, row_invalid, col_invalid,
                  col_pass=None):
    """Low-rank factors (ahat (M, DG), bhat (DG, N)) whose product is the
    anchored squared pixel distance plus validity biases:
        d2_eff = d2_raw + 4*PB*row_invalid + 2*PB*col_invalid - PB*col_pass
    (PB = PASS_BIAS), so invalid rows/columns always fail the gate and
    pass-always columns always pass. proj (C, N, 2)."""
    return track_cuda.gate_rows(uv, anchor, row_invalid, proj[..., 0],
                                proj[..., 1], penalize, col_invalid,
                                col_pass)


def _track_core(gen, cur_desc, cur_valid, cur_uv, cur_anchor, cur_sigma2,
                cur_p3d, cur_has_depth, prev_desc, prev_valid, prev_lm_id,
                map_pos, map_valid, cam_T_ref_all, fxycxy_all, pred_T_wr,
                num_hyp: int, px: float, max_dist: int, ratio: float,
                gate_px: float, fastpath_frac: float = 0.95,
                fastpath_min: int = 100, branch: str = "host", *, out):
    """Inter-frame tracking: projection-gated mutual match (prev features
    with a landmark only match current features within gate_px of the
    landmark's projection under pred_T_wr) -> landmark lookup in the map
    mirror -> the motion candidate refined up front; when it explains
    >= fastpath_frac of the landmark matches (and >= fastpath_min) the
    Kabsch/PnP RANSAC portfolio is skipped (`branch`: "host" or "device",
    see the module docstring). The match's prologue and epilogue are the
    track_gate and track_epilogue kernels (frontend/track_cuda). Writes
    the packed section [pose (16), n_uniform, n_matches, n_with_lm, rr_ok,
    fastpath, ok (M), match idx (M), lm id (M)] into `out` -> (pose, the
    epilogue's TrackObs)."""
    if gate_px <= 0.0:
        raise ValueError("_track_core: the port implements the projection-"
                         "gated matcher only (gate_px > 0)")
    if branch not in ("host", "device"):
        raise ValueError(f"_track_core: branch must be 'host' or 'device', "
                         f"got {branch!r}")
    M = cur_desc.shape[0]
    ahat, bhat = track_cuda.track_gate(
        cur_uv, cur_anchor, cur_valid, prev_lm_id, prev_valid, map_pos,
        map_valid, cam_T_ref_all, fxycxy_all, pred_T_wr)
    best, second, idx, col_idx = match_cuda.hamming_argmin2(
        cur_desc, prev_desc, ahat, bhat, gate_px * gate_px, want_cols=True)
    obs = track_cuda.track_epilogue(
        best, second, idx, col_idx, cur_valid, cur_has_depth, cur_uv,
        cur_anchor, cur_sigma2, prev_lm_id, map_valid, map_pos,
        cam_T_ref_all, fxycxy_all, max_dist, ratio, out)
    X_world, cTr, f = obs.X_world, obs.cam_T_ref, obs.fxycxy

    T_pred = pose_opt.refine_packed(pred_T_wr, obs.rows, obs.with_f,
                                    LM_SCHED)[0]
    n_pred = ransac_cuda.score(T_pred, X_world, cur_uv, cTr, f, obs.with_lm,
                               px)[3]
    T_pred = T_pred[0]
    # out[18]: the epilogue's count of matches with a landmark
    strong_t = (n_pred >= fastpath_min) & (
        n_pred.to(torch.float32) >= fastpath_frac * out[18])
    fast = (T_pred, n_pred)
    n_pnp = max(num_hyp // 2, 64)

    def draws():
        return (ransac._sample_idx(gen, num_hyp, 3, M, obs.mask3d_f),
                ransac._sample_idx(gen, n_pnp, 6, M, obs.with_f))

    args = (T_pred, cur_p3d, X_world, cur_uv, cTr, f, obs.mask3d,
            obs.with_lm, obs.rows)
    if branch == "host":
        if bool(strong_t.item()):  # the one host sync of the frame
            T_best, n_uniform = fast
        else:
            T_best, n_uniform = _portfolio(px, *args, *draws())
    else:
        T_best, n_uniform = graphs.cond(
            ~strong_t, functools.partial(_portfolio, px), (*args, *draws()),
            fast)
    out[:16] = T_best.reshape(16)
    out[16] = n_uniform
    out[19] = n_uniform >= 10
    out[20] = strong_t
    return T_best, obs


def _portfolio(px: float, T_pred, cur_p3d, X_world, cur_uv, cTr, f, mask3d,
               with_lm, rows, idx_kab, idx_pnp):
    """The pose-candidate portfolio of a frame off the fast path: Kabsch
    and PnP RANSAC on the given samples, both refined (on the epilogue's
    pose_lm rows), scored with the refined motion candidate T_pred ->
    (best pose, its inlier count as int32)."""
    rr_kab = ransac.ransac_kabsch(None, cur_p3d, X_world, cur_uv, cTr, f,
                                  mask3d, px_thresh=px, idx=idx_kab)
    rr_pnp = ransac.ransac_pnp(None, X_world, cur_uv, cTr, f, with_lm,
                               px_thresh=px, idx=idx_pnp)
    inits = torch.stack([rr_kab.world_T_ref, rr_pnp.world_T_ref])
    masks = torch.stack([with_lm & rr_kab.inliers, with_lm & rr_pnp.inliers])
    T_refs = pose_opt.refine_packed(inits, rows, masks, LM_SCHED)[0]
    cand_T = torch.cat([T_pred[None], T_refs])
    _, _, T_best, n_best, _ = ransac_cuda.score(cand_T, X_world, cur_uv, cTr,
                                                f, with_lm, px)
    return T_best, n_best


def _project_and_match_local(T_wr, lm_pos, lm_desc, lm_valid, im_desc, im_uv,
                             im_anchor, im_valid, cam_T_ref, fxycxy, image_wh,
                             radius: float, max_dist: int, lm_normal=None,
                             min_view_cos: float = 0.5):
    """Project candidate landmarks into the rig and match current
    features one way, gated by frustum, pixel radius and the viewing-
    normal cone (none without lm_normal): the localmap_gate kernel over
    the landmarks as they are given (frontend/track_cuda), then the
    gated matcher."""
    L = lm_pos.shape[0]
    ids = torch.arange(L, dtype=torch.int32, device=lm_pos.device)
    normal = torch.zeros_like(lm_pos) if lm_normal is None else lm_normal
    _, ahat, bhat, _ = track_cuda.localmap_gate(
        T_wr, ids, lm_valid, lm_pos, lm_desc, normal, im_uv, im_anchor,
        im_valid, cam_T_ref, fxycxy, image_wh, min_view_cos)
    best, second, idx, _ = match_cuda.hamming_argmin2(
        im_desc, lm_desc, ahat, bhat, radius * radius, want_cols=False)
    ok = (best <= max_dist) & (best <= second) & im_valid
    return match_ops.MatchResult(idx=idx, dist=best.to(torch.int32), ok=ok)


def _localmap_core(T_wr, cand_ids, cand_valid, map_pos, map_desc, map_normal,
                   im_desc, im_uv, im_anchor, im_valid, obs_rows, cam_T_ref,
                   fxycxy, image_wh, radius: float, max_dist: int, *, out):
    """Local-map tracking: the candidates gathered from the map mirror,
    projected and gated (localmap_gate), matched, then the epilogue
    (localmap_epilogue: the landmark ids and pose_lm's rows, reusing rows
    3-21 of the inter-frame match's obs_rows: the same features, and the
    gate's candidate positions) and the pose refine -> packed [pose (16),
    lm id (M), inliers (M)], written into `out`."""
    M = im_desc.shape[0]
    lm_desc, ahat, bhat, lm_pos = track_cuda.localmap_gate(
        T_wr, cand_ids, cand_valid, map_pos, map_desc, map_normal, im_uv,
        im_anchor, im_valid, cam_T_ref, fxycxy, image_wh)
    best, second, idx, _ = match_cuda.hamming_argmin2(
        im_desc, lm_desc, ahat, bhat, radius * radius, want_cols=False)
    rows, mask, lm = track_cuda.localmap_epilogue(
        best, second, idx, im_valid, cand_ids, lm_pos, map_pos, obs_rows,
        max_dist)
    T, chi2 = pose_opt.refine_packed(T_wr, rows, mask, LM_SCHED)
    inl = (chi2[0] < pose_opt.CHI2_2DOF) & (lm >= 0)
    out[:16] = T.reshape(16)
    out[16:16 + M] = torch.where(inl, lm, -1)
    out[16 + M:] = inl


def _track_and_map_step(gen, cur_desc, cur_valid, cur_uv, cur_anchor,
                        cur_sigma2, cur_p3d, cur_has_depth, prev_desc,
                        prev_valid, prev_lm_id, map_pos, map_valid, map_desc,
                        map_normal, cand_ids, cand_valid, cam_T_ref_all,
                        fxycxy_all, pred_T_wr, num_hyp: int, px: float,
                        max_dist: int, ratio: float, image_wh=None,
                        lm_radius: float = 15.0, lm_max_dist: int = 64,
                        gate_px: float = 0.0, fastpath_frac: float = 0.95,
                        fastpath_min: int = 100, branch: str = "host"):
    """Inter-frame tracking + local-map tracking with one packed output,
    which both halves write in place; the local-map half consumes the
    tracking pose and the tracking's pose_lm rows."""
    M = cur_desc.shape[0]
    head = track_cuda.HEAD + 3 * M
    packed = torch.empty(head + 16 + 2 * M, dtype=torch.float32,
                         device=cur_desc.device)
    pose, obs = _track_core(
        gen, cur_desc, cur_valid, cur_uv, cur_anchor, cur_sigma2, cur_p3d,
        cur_has_depth, prev_desc, prev_valid, prev_lm_id, map_pos,
        map_valid, cam_T_ref_all, fxycxy_all, pred_T_wr, num_hyp, px,
        max_dist, ratio, gate_px, fastpath_frac, fastpath_min, branch,
        out=packed[:head])
    _localmap_core(
        pose, cand_ids, cand_valid, map_pos, map_desc, map_normal, cur_desc,
        cur_uv, cur_anchor, cur_valid, obs.rows, cam_T_ref_all, fxycxy_all,
        image_wh, lm_radius, lm_max_dist, out=packed[head:])
    return packed


def _build_and_track_step(gen, imgs, rig, prev_desc, prev_valid, prev_lm_id,
                          map_pos, map_valid, map_desc, map_normal, cand_ids,
                          cand_valid, pred_T_wr, *, num_points: int,
                          num_levels: int, fast_threshold: float,
                          min_threshold: float, max_intra: int, min_z: float,
                          max_z: float, angle_bins: int, num_hyp: int,
                          px: float, max_dist: int, ratio: float, image_wh,
                          lm_radius: float, lm_max_dist: int, gate_px: float,
                          fastpath_frac: float, fastpath_min: int,
                          route: orb.OrbRoute = orb.OrbRoute(),
                          branch: str = "host"):
    """Frame build + inter-frame/local-map tracking of one frame:
    extraction -> intra-match -> triangulate -> projection-gated match ->
    pose portfolio -> local-map track. `gen` is the torch.Generator (on
    the images' device) the RANSAC stages draw from; `route` is the
    extraction route; `branch` where the fast-path decision is taken
    (module docstring). Returns (kps, xy_ud, groups, tri, packed);
    frame.assemble_frame turns the first four into a FrameFeatures."""
    from mcslam_tpu_torch.frontend import frame as frame_mod

    kps, xy_ud, groups, tri = frame_mod._fused_stage(
        imgs, rig, num_points, num_levels, fast_threshold, min_threshold,
        max_intra, min_z, max_z, angle_bins, route)
    X, has_depth, anchor_cam, uv_ref, anchor_sigma2, _n_rays = tri
    packed = _track_and_map_step(
        gen, groups.desc, groups.valid, uv_ref, anchor_cam, anchor_sigma2, X,
        has_depth, prev_desc, prev_valid, prev_lm_id, map_pos, map_valid,
        map_desc, map_normal, cand_ids, cand_valid, rig.cam_T_ref,
        rig.fxycxy, pred_T_wr, num_hyp, px, max_dist, ratio, image_wh,
        lm_radius, lm_max_dist, gate_px, fastpath_frac, fastpath_min, branch)
    return kps, xy_ud, groups, tri, packed


def _triangulate_pairs(wTc_rays, uv_rays, f_rays, mask_rays, sigma_rays):
    """Two-view triangulation of the new landmarks at keyframe insertion:
    wTc (M, 2, 4, 4), uv (M, 2, 2), f (M, 2, 4), mask and sigma (M, 2) ->
    (X (M, 3), ok (M,)), depth gate 0.1-100 m."""
    return _triangulate_pairs_far(wTc_rays, uv_rays, f_rays, mask_rays,
                                  sigma_rays, 0.1, 100.0)


def _triangulate_pairs_far(wTc_rays, uv_rays, f_rays, mask_rays, sigma_rays,
                           min_z: float, max_z: float):
    """_triangulate_pairs with the caller's depth gate (the 17-point
    distant-scene bootstrap seeds landmarks beyond the 100 m cap)."""
    return triangulation.triangulate_and_refine(
        wTc_rays, uv_rays, f_rays, mask_rays, sigma=sigma_rays,
        min_z=min_z, max_z=max_z)


def _match_descriptors(desc_a, valid_a, desc_b, valid_b):
    """(N, 8) x (M, 8) descriptor words -> (N, M) int32 Hamming distances
    (the validity masks are applied by the matcher)."""
    return hamming.hamming_matrix(desc_a, desc_b)


def _mutual_match(dist, valid_a, valid_b, max_dist: int, ratio: float):
    """Mutual-best match of an (N, M) distance matrix with the distance
    threshold and the ratio test -> MatchResult over the N rows."""
    return match_ops.match_mutual(dist, row_mask=valid_a, col_mask=valid_b,
                                  max_dist=max_dist, ratio=ratio)
