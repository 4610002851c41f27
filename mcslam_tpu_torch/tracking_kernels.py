"""Per-frame tracking programs (counterpart of mcslam_tpu/tracking_kernels.py):
projection-gated matching to the reference keyframe, the pose-candidate
portfolio with its motion-model fast path, robust motion-only LM, and
local-map tracking, with the JAX package's packed output layout.

Both matchers go through the gated matching kernel (ops/match_cuda) and
every pose refine through the one-launch LM (frontend/pose_opt_cuda), as
on the TPU. The fast-path decision is read on the host once per frame
(one device sync); the JAX program makes it with a device-side lax.cond.

`_triangulate_pairs` is the two-view triangulation of keyframe
insertion; `_match_descriptors`, `_mutual_match` and
`_triangulate_pairs_far` serve the monocular and 17-point bootstraps.

Packed layout of `_track_and_map_step` / `_build_and_track_step`
(M = intra slots): [pose (16), n_uniform, n_matches, n_with_lm, rr_ok,
fastpath, ok (M), match idx (M), lm id (M), local-map pose (16),
local-map lm id (M), local-map inliers (M)].
"""

from __future__ import annotations

import numpy as np
import torch

from mcslam_tpu_torch.frontend import pose_opt, ransac
from mcslam_tpu_torch.geometry import lie, triangulation
from mcslam_tpu_torch.ops import hamming, match as match_ops, match_cuda, orb

_GATE_BIG = 1e12
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


def _anchored_sq_px_dist(uv, anchor, proj, penalize):
    """(M, N) squared pixel distance from each row feature to each column
    target's projection in the row's anchor camera, as two matmuls over
    one-hot anchor weights (no (M, N, 2) gather). uv (M, 2); anchor (M,);
    proj (C, N, 2); penalize (C, N) adds _GATE_BIG."""
    C = proj.shape[0]
    oh = torch.nn.functional.one_hot(anchor.long(), C).to(uv.dtype)
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
    pass-always columns always pass."""
    C = proj.shape[0]
    M, N = uv.shape[0], proj.shape[1]
    f32 = torch.float32
    oh = torch.nn.functional.one_hot(anchor.long(), C).to(f32)
    P2 = torch.sum(proj * proj, dim=-1) + _GATE_BIG * penalize.to(f32)
    A = (oh[:, :, None] * uv[:, None, :]).reshape(M, 2 * C)
    B = proj.permute(0, 2, 1).reshape(2 * C, N)
    u2 = torch.sum(uv * uv, dim=-1)
    PB = match_cuda.PASS_BIAS
    r_bias = 2.0 * PB * col_invalid.to(f32)
    if col_pass is not None:
        r_bias = r_bias - PB * col_pass.to(f32)
    ones_m = torch.ones(M, 1, dtype=f32, device=uv.device)
    ones_n = torch.ones(1, N, dtype=f32, device=uv.device)
    ahat = torch.cat(
        [-2.0 * A, oh, (u2 + 4.0 * PB * row_invalid.to(f32))[:, None],
         ones_m], dim=1)
    bhat = torch.cat([B, P2, ones_n, r_bias[None, :]], dim=0)
    return ahat.contiguous(), bhat.contiguous()


def _track_core(gen, cur_desc, cur_valid, cur_uv, cur_anchor, cur_sigma2,
                cur_p3d, cur_has_depth, prev_desc, prev_valid, prev_lm_id,
                map_pos, map_valid, cam_T_ref_all, fxycxy_all, pred_T_wr,
                num_hyp: int, px: float, max_dist: int, ratio: float,
                gate_px: float, fastpath_frac: float = 0.95,
                fastpath_min: int = 100):
    """Inter-frame tracking: projection-gated mutual match (prev features
    with a landmark only match current features within gate_px of the
    landmark's projection under pred_T_wr) -> landmark lookup in the map
    mirror -> the motion candidate refined up front; when it explains
    >= fastpath_frac of the landmark matches (and >= fastpath_min) the
    Kabsch/PnP RANSAC portfolio is skipped -> (packed, pose)."""
    if gate_px <= 0.0:
        raise ValueError("_track_core: the port implements the projection-"
                         "gated matcher only (gate_px > 0)")
    dev = cur_desc.device
    safe_prev = torch.clamp(prev_lm_id, min=0).long()
    prev_has = (prev_lm_id >= 0) & map_valid[safe_prev]
    Xp = map_pos[safe_prev]
    cam_T_w = cam_T_ref_all @ lie.se3_inverse(pred_T_wr)
    pc = torch.einsum("cij,mj->cmi", cam_T_w[:, :3, :3], Xp) \
        + cam_T_w[:, None, :3, 3]
    z = pc[..., 2]
    uvp = torch.clamp(
        pc[..., :2] / torch.clamp(z[..., None], min=1e-6)
        * fxycxy_all[:, None, :2] + fxycxy_all[:, None, 2:], -1e5, 1e5)
    pen = z <= 0.05
    ahat, bhat = _gate_factors(cur_uv, cur_anchor, uvp, pen, ~cur_valid,
                               ~prev_valid, col_pass=~prev_has)
    best, second, idx, col_idx = match_cuda.hamming_argmin2(
        cur_desc, prev_desc, ahat, bhat, gate_px * gate_px, want_cols=True)
    rows = torch.arange(cur_desc.shape[0], dtype=torch.int32, device=dev)
    ok = ((col_idx[idx.long()] == rows) & (best <= max_dist)
          & (best <= ratio * second) & cur_valid)
    res = match_ops.MatchResult(idx=idx, dist=best.to(torch.int32), ok=ok)

    lm = torch.where(res.ok, prev_lm_id[res.idx.long()],
                     torch.full_like(prev_lm_id, -1))
    safe = torch.clamp(lm, min=0).long()
    with_lm = (lm >= 0) & map_valid[safe]
    lm = torch.where(with_lm, lm, torch.full_like(lm, -1))
    X_world = map_pos[safe]
    cTr = cam_T_ref_all[cur_anchor.long()]
    f = fxycxy_all[cur_anchor.long()]
    mask3d = with_lm & cur_has_depth

    ref_pred = pose_opt.optimize_pose(
        pred_T_wr, X_world, cur_uv, cTr, f, with_lm, sigma2=cur_sigma2,
        iters=LM_SCHED)
    score_pred = ransac._score_reprojection(
        ref_pred.world_T_ref[None], X_world, cur_uv, cTr, f, with_lm, px)[0][0]
    n_with = torch.sum(with_lm)
    strong_t = (score_pred >= fastpath_min) & (
        score_pred.to(torch.float32) >= fastpath_frac * n_with.to(torch.float32))
    strong = bool(strong_t.item())  # the one host sync of the frame
    if strong:
        T_best, n_uniform = ref_pred.world_T_ref, score_pred.to(torch.int32)
    else:
        rr_kab = ransac.ransac_kabsch(gen, cur_p3d, X_world, cur_uv, cTr, f,
                                      mask3d, num_hyp=num_hyp, px_thresh=px)
        rr_pnp = ransac.ransac_pnp(gen, X_world, cur_uv, cTr, f, with_lm,
                                   num_hyp=max(num_hyp // 2, 64),
                                   px_thresh=px)
        inits = torch.stack([rr_kab.world_T_ref, rr_pnp.world_T_ref])
        masks = torch.stack([with_lm & rr_kab.inliers,
                             with_lm & rr_pnp.inliers])
        refs = pose_opt.optimize_pose(inits, X_world, cur_uv, cTr, f, masks,
                                      sigma2=cur_sigma2, iters=LM_SCHED)
        cand_T = torch.cat([ref_pred.world_T_ref[None], refs.world_T_ref])
        scores, _ = ransac._score_reprojection(cand_T, X_world, cur_uv, cTr,
                                               f, with_lm, px)
        b = torch.argmax(scores)
        T_best, n_uniform = cand_T[b], scores[b].to(torch.int32)
    rr_ok = n_uniform >= 10
    header = torch.stack([
        n_uniform.to(torch.float32), torch.sum(res.ok).to(torch.float32),
        torch.sum(with_lm).to(torch.float32), rr_ok.to(torch.float32),
        strong_t.to(torch.float32),
    ])
    packed = torch.cat([
        T_best.reshape(16), header, res.ok.to(torch.float32),
        res.idx.to(torch.float32), lm.to(torch.float32),
    ])
    return packed, T_best


def _project_and_match_local(T_wr, lm_pos, lm_desc, lm_valid, im_desc, im_uv,
                             im_anchor, im_valid, cam_T_ref, fxycxy, image_wh,
                             radius: float, max_dist: int, lm_normal=None,
                             min_view_cos: float = 0.5):
    """Project candidate landmarks into the rig and match current
    features one way, gated by frustum, pixel radius and the viewing-
    normal cone."""
    rTw = lie.se3_inverse(T_wr)
    p_ref = lie.se3_apply(rTw, lm_pos)
    p_cam = lie.se3_apply(cam_T_ref[None], p_ref[:, None])  # (L, C, 3)
    z = p_cam[..., 2]
    zs = torch.where(z > 0.05, z, torch.ones_like(z))
    proj = p_cam[..., :2] / zs[..., None] * fxycxy[None, :, :2] \
        + fxycxy[None, :, 2:]
    w, h = image_wh
    vis = ((z > 0.05) & (proj[..., 0] >= 0) & (proj[..., 0] < w)
           & (proj[..., 1] >= 0) & (proj[..., 1] < h))
    if lm_normal is not None:
        view = lm_pos - T_wr[:3, 3][None]
        view = view / torch.clamp(
            torch.linalg.vector_norm(view, dim=-1, keepdim=True), min=1e-9)
        has_n = torch.linalg.vector_norm(lm_normal, dim=-1) > 1e-6
        cosv = torch.sum(view * lm_normal, dim=-1)
        vis = vis & ((cosv > min_view_cos) | ~has_n)[:, None]
    proj_c = torch.clamp(proj.permute(1, 0, 2), -1e5, 1e5)
    pen = ~vis.T
    ahat, bhat = _gate_factors(im_uv, im_anchor, proj_c, pen, ~im_valid,
                               ~lm_valid)
    best, second, idx, _ = match_cuda.hamming_argmin2(
        im_desc, lm_desc, ahat, bhat, radius * radius, want_cols=False)
    ok = (best <= max_dist) & (best <= second) & im_valid
    return match_ops.MatchResult(idx=idx, dist=best.to(torch.int32), ok=ok)


def _localmap_core(T_wr, cand_ids, cand_valid, map_pos, map_desc, map_normal,
                   im_desc, im_uv, im_anchor, im_valid, im_sigma2, cam_T_ref,
                   fxycxy, image_wh, radius: float, max_dist: int):
    """Local-map tracking: gather the candidate landmarks from the map
    mirror, projection-gated matching, pose refine -> packed
    [pose (16), lm id (M), inliers (M)]."""
    ids = cand_ids.long()
    res = _project_and_match_local(
        T_wr, map_pos[ids], map_desc[ids], cand_valid, im_desc, im_uv,
        im_anchor, im_valid, cam_T_ref, fxycxy, image_wh, radius, max_dist,
        lm_normal=map_normal[ids])
    lm = torch.where(res.ok, cand_ids[res.idx.long()],
                     torch.full_like(res.idx, -1))
    X_world = map_pos[torch.clamp(lm, min=0).long()]
    ref = pose_opt.optimize_pose(
        T_wr, X_world, im_uv, cam_T_ref[im_anchor.long()],
        fxycxy[im_anchor.long()], lm >= 0, sigma2=im_sigma2, iters=LM_SCHED)
    lm_out = torch.where(ref.inliers, lm, torch.full_like(lm, -1))
    return torch.cat([ref.world_T_ref.reshape(16), lm_out.to(torch.float32),
                      ref.inliers.to(torch.float32)])


def _track_and_map_step(gen, cur_desc, cur_valid, cur_uv, cur_anchor,
                        cur_sigma2, cur_p3d, cur_has_depth, prev_desc,
                        prev_valid, prev_lm_id, map_pos, map_valid, map_desc,
                        map_normal, cand_ids, cand_valid, cam_T_ref_all,
                        fxycxy_all, pred_T_wr, num_hyp: int, px: float,
                        max_dist: int, ratio: float, image_wh=None,
                        lm_radius: float = 15.0, lm_max_dist: int = 64,
                        gate_px: float = 0.0, fastpath_frac: float = 0.95,
                        fastpath_min: int = 100):
    """Inter-frame tracking + local-map tracking with one packed output;
    the local-map half consumes the tracking pose."""
    track_packed, pose = _track_core(
        gen, cur_desc, cur_valid, cur_uv, cur_anchor, cur_sigma2, cur_p3d,
        cur_has_depth, prev_desc, prev_valid, prev_lm_id, map_pos,
        map_valid, cam_T_ref_all, fxycxy_all, pred_T_wr, num_hyp, px,
        max_dist, ratio, gate_px, fastpath_frac, fastpath_min)
    lm_packed = _localmap_core(
        pose, cand_ids, cand_valid, map_pos, map_desc, map_normal, cur_desc,
        cur_uv, cur_anchor, cur_valid, cur_sigma2, cam_T_ref_all, fxycxy_all,
        image_wh, lm_radius, lm_max_dist)
    return torch.cat([track_packed, lm_packed])


def _build_and_track_step(gen, imgs, rig, prev_desc, prev_valid, prev_lm_id,
                          map_pos, map_valid, map_desc, map_normal, cand_ids,
                          cand_valid, pred_T_wr, *, num_points: int,
                          num_levels: int, fast_threshold: float,
                          min_threshold: float, max_intra: int, min_z: float,
                          max_z: float, angle_bins: int, num_hyp: int,
                          px: float, max_dist: int, ratio: float, image_wh,
                          lm_radius: float, lm_max_dist: int, gate_px: float,
                          fastpath_frac: float, fastpath_min: int,
                          route: orb.OrbRoute = orb.OrbRoute()):
    """Frame build + inter-frame/local-map tracking of one frame:
    extraction -> intra-match -> triangulate -> projection-gated match ->
    pose portfolio -> local-map track. `gen` is the torch.Generator (on
    the images' device) the RANSAC stages draw from; `route` is the
    extraction route. Returns (kps, xy_ud, groups, tri, packed);
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
        lm_radius, lm_max_dist, gate_px, fastpath_frac, fastpath_min)
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
