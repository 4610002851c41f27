"""The tracking step's glue around its two gated matches as CUDA entries
(kernel source csrc/track_glue.cu), the port's counterparts of the
TPU-shaped code that XLA fuses around the Pallas matcher in the JAX
package's frame step (mcslam_tpu/tracking_kernels.py _track_core :160-219
with _gate_factors :94, _localmap_core :341-353 with
_project_and_match_local :479-516); no Pallas kernel corresponds to them.

- `track_gate`: the inter-frame match's prologue: the previous frame's
  landmarks projected through the predicted pose into every camera, and
  the gate factors (ahat (M, DG), bhat (DG, N)) of
  ops/match_cuda.hamming_argmin2;
- `track_epilogue`: its epilogue: the mutual / ratio test, the landmark
  lookup, the gathers the pose refine and the scores read, pose_lm's
  observation rows, and the match's counts and rows of the packed vector;
- `localmap_gate`: the local-map match's prologue: the candidates' map
  rows, their projections with the frustum and viewing-cone gates, the
  gate factors, and the candidates' positions for the epilogue;
- `localmap_epilogue`: its epilogue: the one-way test, the landmark ids
  and pose_lm's rows (the matched positions read from the gate's).

CUDA tensors launch the kernel (or raise); CPU tensors run the plain
version, `<name>_reference`, which writes each 3-term rotation, 4x4
product and norm out in one order, the kernel's: on the card the two are
bit-equal (-fmad=false, IEEE divisions and roots).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from mcslam_tpu_torch import _build
from mcslam_tpu_torch.frontend import pose_opt_cuda
from mcslam_tpu_torch.ops import match_cuda
from mcslam_tpu_torch.utils import graphs, outputs

GATE_BIG = 1e12  # the gate's frustum penalty (tracking_kernels._GATE_BIG)
PB = match_cuda.PASS_BIAS
MAX_CAMERAS = (match_cuda.DG_MAX - 2) // 3  # csrc/track_glue.cu's MAX_C
OBS_ROWS = 22  # pose_lm's observation rows (pose_opt_cuda._pack_obs)
HEAD = 21  # the packed vector's pose and counts before the match's rows
# track_epilogue's counter: the two counts in 22-bit fields of one 64-bit
# word (csrc/track_glue.cu), so M < 2^22
MAX_ROWS = (1 << 22) - 1


class TrackObs(NamedTuple):
    """track_epilogue's outputs, over the M current features."""
    X_world: torch.Tensor  # (M, 3) the matched landmark's position
    cam_T_ref: torch.Tensor  # (M, 4, 4) the anchor camera's pose
    fxycxy: torch.Tensor  # (M, 4) its intrinsics
    rows: torch.Tensor  # (22, M) pose_lm's observation rows
    with_lm: torch.Tensor  # (M,) bool: a match with a valid landmark
    mask3d: torch.Tensor  # (M,) bool: with_lm and a triangulated point
    with_f: torch.Tensor  # (M,) float32 with_lm
    mask3d_f: torch.Tensor  # (M,) float32 mask3d


@functools.lru_cache(maxsize=16)
def _epilogue_layout(M: int):
    f32, b8 = torch.float32, torch.bool
    return outputs.layout(((M, 3), (M, 4, 4), (M, 4), (OBS_ROWS, M), (M,),
                           (M,), (M,), (M,)),
                          (f32, f32, f32, f32, b8, b8, f32, f32))


@functools.lru_cache(maxsize=16)
def _localmap_gate_layout(M: int, L: int, C: int):
    DG = 3 * C + 2
    return outputs.layout(((L, 8), (M, DG), (DG, L), (L, 3)),
                          (torch.int32, torch.float32, torch.float32,
                           torch.float32))


@functools.lru_cache(maxsize=16)
def _localmap_epilogue_layout(M: int):
    return outputs.layout(((OBS_ROWS, M), (M,), (M,)),
                          (torch.float32, torch.float32, torch.int32))


def epilogue_outputs(M: int, dev) -> TrackObs:
    """track_epilogue's eight outputs on dev, carved from one buffer: each
    contiguous, of TrackObs' shape and dtype, at an outputs.ALIGN-byte
    boundary."""
    return TrackObs(*outputs.carve(_epilogue_layout(M), dev))


def localmap_gate_outputs(M: int, L: int, C: int, dev):
    """localmap_gate's outputs (lm_desc (L, 8) int32, ahat (M, 3C + 2),
    bhat (3C + 2, L), lm_pos (L, 3) float32) on dev, carved from one
    buffer as epilogue_outputs."""
    return tuple(outputs.carve(_localmap_gate_layout(M, L, C), dev))


def localmap_epilogue_outputs(M: int, dev):
    """localmap_epilogue's outputs (rows (22, M), mask (M,) float32, lm
    (M,) int32) on dev, carved from one buffer as epilogue_outputs."""
    return tuple(outputs.carve(_localmap_epilogue_layout(M), dev))


def _cameras(name, C):
    if not 1 <= C <= MAX_CAMERAS:
        raise ValueError(f"{name}: the kernel takes 1-{MAX_CAMERAS} cameras "
                         f"(3 C + 2 <= {match_cuda.DG_MAX} gate factors), "
                         f"got {C}")


def _dot3(a, b):
    """(a0 b0 + a1 b1) + a2 b2 over the last axis's three components."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) \
        + a[..., 2] * b[..., 2]


def _inverse(T):
    """se3_inverse of a (4, 4) pose as (R^T (3, 3), -(R^T t) (3,)), in the
    kernel's order."""
    R, t = T[:3, :3], T[:3, 3]
    return R.T, -((R[0] * t[0] + R[1] * t[1]) + R[2] * t[2])


def _apply(R, t, X):
    """R (..., 3, 3) X (..., 3) + t (..., 3), each component a 3-term dot
    then the translation, broadcasting the batch axes."""
    return torch.stack([_dot3(R[..., i, :], X) + t[..., i]
                        for i in range(3)], dim=-1)


def gate_rows(uv, anchor, row_invalid, u, v, pen, col_invalid,
              col_pass=None):
    """The gate factors of hamming_argmin2 from projections u, v (C, N)
    (clamped) and the penalty pen (C, N) bool -> (ahat (M, 3C + 2), bhat
    (3C + 2, N)), contiguous float32: ahat's rows -2 oh u, -2 oh v
    (camera-major), oh, u^2 + v^2 + 4 PB row_invalid, 1; bhat's u_c, v_c,
    u_c^2 + v_c^2 + 1e12 pen_c, 1, 2 PB col_invalid (- PB col_pass)."""
    f32 = torch.float32
    C, N = u.shape
    M = uv.shape[0]
    oh = (anchor.long()[:, None]
          == torch.arange(C, device=uv.device)[None, :]).to(f32)
    u0, v0 = uv[:, 0], uv[:, 1]
    A = torch.stack([oh * u0[:, None], oh * v0[:, None]], dim=-1)
    ahat = torch.cat([
        -2.0 * A.reshape(M, 2 * C), oh,
        ((u0 * u0 + v0 * v0) + 4.0 * PB * row_invalid.to(f32))[:, None],
        torch.ones(M, 1, dtype=f32, device=uv.device)], dim=1)
    bias = 2.0 * PB * col_invalid.to(f32)
    if col_pass is not None:
        bias = bias - PB * col_pass.to(f32)
    bhat = torch.cat([
        torch.stack([u, v], dim=1).reshape(2 * C, N),
        (u * u + v * v) + GATE_BIG * pen.to(f32),
        torch.ones(1, N, dtype=f32, device=uv.device), bias[None]], dim=0)
    return ahat.contiguous(), bhat.contiguous()


def track_gate_reference(uv, anchor, cur_valid, prev_lm_id, prev_valid,
                         map_pos, map_valid, cam_T_ref, fxycxy, pred_T_wr):
    """Plain PyTorch version of track_gate: the previous features'
    landmarks (prev_lm_id (N,), -1: none) in the map mirror, projected by
    cam_T_ref[c] se3_inverse(pred_T_wr) into the C cameras (z clamped at
    1e-6, the pixels at +-1e5, penalized where z <= 0.05) -> gate_rows for
    the current features (uv (M, 2), anchor (M,), cur_valid (M,)) against
    them, columns without a valid previous feature failing and those
    without a landmark passing."""
    safe = torch.clamp(prev_lm_id, min=0).long()
    has = (prev_lm_id >= 0) & map_valid[safe]
    X = map_pos[safe]
    Rinv, tinv = _inverse(pred_T_wr)
    cR, ct = cam_T_ref[:, :3, :3], cam_T_ref[:, :3, 3]
    # camera c's world pose: R_c R^T (entry (i, j) the dot of R_c's row i
    # and R^T's column j) and R_c t' + t_c
    Rcw = _dot3(cR[:, :, None, :], Rinv.T[None, None, :, :])
    tcw = _dot3(cR, tinv[None, None, :]) + ct
    p = _apply(Rcw[:, None], tcw[:, None], X[None])  # (C, N, 3)
    zc = torch.clamp(p[..., 2], min=1e-6)
    u = torch.clamp(p[..., 0] / zc * fxycxy[:, 0, None] + fxycxy[:, 2, None],
                    -1e5, 1e5)
    v = torch.clamp(p[..., 1] / zc * fxycxy[:, 1, None] + fxycxy[:, 3, None],
                    -1e5, 1e5)
    return gate_rows(uv, anchor, ~cur_valid, u, v, p[..., 2] <= 0.05,
                     ~prev_valid, ~has)


def track_gate(uv, anchor, cur_valid, prev_lm_id, prev_valid, map_pos,
               map_valid, cam_T_ref, fxycxy, pred_T_wr):
    """uv (M, 2) float32, anchor (M,) int32, cur_valid (M,) bool,
    prev_lm_id (N,) int32, prev_valid (N,) bool, map_pos (cap, 3) float32,
    map_valid (cap,) bool, cam_T_ref (C, 4, 4), fxycxy (C, 4) and
    pred_T_wr (4, 4) float32 -> (ahat (M, 3C + 2), bhat (3C + 2, N)): see
    track_gate_reference. CUDA tensors launch track_gate (one launch: the
    row blocks write ahat, the column blocks bhat); CPU tensors take the
    plain version."""
    if _build.device_type(uv, "track_gate") == "cpu":
        return track_gate_reference(uv, anchor, cur_valid, prev_lm_id,
                                    prev_valid, map_pos, map_valid, cam_T_ref,
                                    fxycxy, pred_T_wr)
    dev = uv.device
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    C = cam_T_ref.shape[0]
    _cameras("track_gate", C)
    M, N, cap = uv.shape[0], prev_lm_id.shape[0], map_pos.shape[0]
    ins = _build.kernel_inputs(
        "track_gate", dev, uv=(uv, f32, (M, 2)), anchor=(anchor, i32, (M,)),
        cur_valid=(cur_valid, b8, (M,)),
        prev_lm_id=(prev_lm_id, i32, (N,)),
        prev_valid=(prev_valid, b8, (N,)), map_pos=(map_pos, f32, (cap, 3)),
        map_valid=(map_valid, b8, (cap,)),
        cam_T_ref=(cam_T_ref, f32, (C, 4, 4)), fxycxy=(fxycxy, f32, (C, 4)),
        pred_T_wr=(pred_T_wr, f32, (4, 4)))
    if cap < 1:
        raise ValueError("track_gate: an empty map mirror")
    DG = 3 * C + 2
    ahat = torch.empty(M, DG, dtype=f32, device=dev)
    bhat = torch.empty(DG, N, dtype=f32, device=dev)
    lib = _build.library()
    _build.count("track_gate")
    _build.check(lib.mc_track_gate(
        *(x.data_ptr() for x in ins), ahat.data_ptr(), bhat.data_ptr(), M, N,
        C, cap, _build.stream_ptr(dev)), "mc_track_gate")
    return ahat, bhat


def track_epilogue_reference(best, second, idx, col_idx, cur_valid,
                             has_depth, uv, anchor, sigma2, prev_lm_id,
                             map_valid, map_pos, cam_T_ref, fxycxy,
                             max_dist: int, ratio: float, packed):
    """Plain PyTorch version of track_epilogue: the mutual match ok = (the
    column's best row is this row) & best <= max_dist & best <= ratio
    second & cur_valid; the previous feature's landmark where ok, kept
    where it is valid in the map; its position (map_pos at the landmark
    before that test, row 0 for none), the anchor camera's pose and
    intrinsics, pose_lm's rows -> TrackObs. Writes into packed (the frame
    step's vector, >= 21 + 3 M floats) the counts of ok and with_lm (slots
    17, 18) and ok, idx, the landmark ids (slots 21, 21 + M, 21 + 2 M)."""
    M = best.shape[0]
    i = idx.long()
    rows = torch.arange(M, dtype=torch.int32, device=best.device)
    ok = ((col_idx[i] == rows) & (best <= max_dist)
          & (best <= ratio * second) & cur_valid)
    lm = torch.where(ok, prev_lm_id[i], -1)
    safe = torch.clamp(lm, min=0).long()
    with_lm = (lm >= 0) & map_valid[safe]
    X = map_pos[safe]
    a = anchor.long()
    cTr, f = cam_T_ref[a], fxycxy[a]
    mask3d = with_lm & has_depth
    obs = pose_opt_cuda._pack_obs(X, uv, cTr, f, 1.0 / sigma2)
    packed[17] = ok.sum()
    packed[18] = with_lm.sum()
    packed[HEAD:HEAD + 3 * M] = torch.cat(
        [ok, idx, torch.where(with_lm, lm, -1)]).to(torch.float32)
    return TrackObs(X, cTr, f, obs, with_lm, mask3d,
                    with_lm.to(torch.float32), mask3d.to(torch.float32))


def track_epilogue(best, second, idx, col_idx, cur_valid, has_depth, uv,
                   anchor, sigma2, prev_lm_id, map_valid, map_pos, cam_T_ref,
                   fxycxy, max_dist: int, ratio: float, packed) -> TrackObs:
    """hamming_argmin2's row outputs best, second (M,) float32, idx (M,)
    int32 and column argmin col_idx (N,) int32; the current features'
    cur_valid, has_depth (M,) bool, uv (M, 2), anchor (M,) int32, sigma2
    (M,) float32; prev_lm_id (N,) int32; the map mirror's map_valid (cap,)
    bool and map_pos (cap, 3); the rig's cam_T_ref (C, 4, 4) and fxycxy (C,
    4); packed a contiguous float32 vector of >= 21 + 3 M -> TrackObs, and
    packed's slots written: see track_epilogue_reference. CUDA tensors
    launch track_epilogue (one launch; the last of its blocks to arrive
    writes the counts through one 64-bit counter, graphs.counters' two
    int32, zero between launches; M <= MAX_ROWS), its outputs carved from
    one buffer (epilogue_outputs); CPU tensors take the plain version."""
    if _build.device_type(best, "track_epilogue") == "cpu":
        return track_epilogue_reference(
            best, second, idx, col_idx, cur_valid, has_depth, uv, anchor,
            sigma2, prev_lm_id, map_valid, map_pos, cam_T_ref, fxycxy,
            max_dist, ratio, packed)
    dev = best.device
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    M, N, cap = best.shape[0], col_idx.shape[0], map_pos.shape[0]
    C = cam_T_ref.shape[0]
    ins = _build.kernel_inputs(
        "track_epilogue", dev, best=(best, f32, (M,)),
        second=(second, f32, (M,)), idx=(idx, i32, (M,)),
        col_idx=(col_idx, i32, (N,)), cur_valid=(cur_valid, b8, (M,)),
        has_depth=(has_depth, b8, (M,)), uv=(uv, f32, (M, 2)),
        anchor=(anchor, i32, (M,)), sigma2=(sigma2, f32, (M,)),
        prev_lm_id=(prev_lm_id, i32, (N,)),
        map_valid=(map_valid, b8, (cap,)), map_pos=(map_pos, f32, (cap, 3)),
        cam_T_ref=(cam_T_ref, f32, (C, 4, 4)), fxycxy=(fxycxy, f32, (C, 4)))
    if (packed.device != dev or packed.dtype != f32 or packed.dim() != 1
            or not packed.is_contiguous() or packed.shape[0] < HEAD + 3 * M):
        raise ValueError(f"track_epilogue: packed must be a contiguous "
                         f"float32 vector of >= {HEAD + 3 * M} on {dev}, got "
                         f"{packed.dtype} {tuple(packed.shape)} on "
                         f"{packed.device}")
    if N < 1 or cap < 1:
        raise ValueError(f"track_epilogue: N={N} and the map's {cap} rows "
                         f"must each be >= 1")
    _cameras("track_epilogue", C)
    if M > MAX_ROWS:
        raise ValueError(f"track_epilogue: the kernel counts at most "
                         f"{MAX_ROWS} rows, got {M}")
    out = epilogue_outputs(M, dev)
    lib = _build.library()
    _build.count("track_epilogue")
    _build.check(lib.mc_track_epilogue(
        *(x.data_ptr() for x in ins), *(x.data_ptr() for x in out),
        packed.data_ptr(), graphs.counters("track_epilogue", 2,
                                           dev).data_ptr(),
        M, N, C, cap, float(max_dist), float(ratio), _build.stream_ptr(dev)),
        "mc_track_epilogue")
    return out


def candidate_positions(cand_ids, map_pos):
    """map_pos[clamp(cand_ids, 0, cap - 1)] (L, 3): the candidates'
    positions as localmap_gate writes them (an id of -1 gives row 0)."""
    return map_pos[torch.clamp(cand_ids.long(), 0, map_pos.shape[0] - 1)]


def localmap_gate_reference(T_wr, cand_ids, cand_valid, map_pos, map_desc,
                            map_normal, uv, anchor, im_valid, cam_T_ref,
                            fxycxy, image_wh, min_view_cos: float = 0.5):
    """Plain PyTorch version of localmap_gate: the candidates' map rows
    (cand_ids (L,), clamped into the map), projected by se3_inverse(T_wr)
    then each cam_T_ref[c] (z below 0.05 divided as 1), visible where z >
    0.05, the pixel lies in [0, W) x [0, H) and the viewing ray from T_wr's
    centre agrees with the landmark's normal (cos > min_view_cos, or a
    normal of norm <= 1e-6) -> (their descriptor words lm_desc (L, 8),
    gate_rows for the current features (uv, anchor, im_valid) against
    them: the pixels clamped to +-1e5, penalized where not visible,
    invalid candidates failing; their positions lm_pos (L, 3),
    candidate_positions)."""
    ids = torch.clamp(cand_ids.long(), 0, map_pos.shape[0] - 1)
    X, nrm = map_pos[ids], map_normal[ids]
    Rinv, tinv = _inverse(T_wr)
    q = _apply(Rinv, tinv, X)  # (L, 3) in the reference frame
    p = _apply(cam_T_ref[:, None, :3, :3], cam_T_ref[:, None, :3, 3],
               q[None])  # (C, L, 3)
    z = p[..., 2]
    zs = torch.where(z > 0.05, z, torch.ones_like(z))
    u = p[..., 0] / zs * fxycxy[:, 0, None] + fxycxy[:, 2, None]
    v = p[..., 1] / zs * fxycxy[:, 1, None] + fxycxy[:, 3, None]
    w, h = image_wh
    view = X - T_wr[:3, 3][None]
    view = view / torch.clamp(torch.sqrt(_dot3(view, view)), min=1e-9)[:, None]
    has_n = torch.sqrt(_dot3(nrm, nrm)) > 1e-6
    cone = (_dot3(view, nrm) > min_view_cos) | ~has_n
    vis = ((z > 0.05) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
           & cone[None])
    ahat, bhat = gate_rows(uv, anchor, ~im_valid, torch.clamp(u, -1e5, 1e5),
                           torch.clamp(v, -1e5, 1e5), ~vis, ~cand_valid)
    return map_desc[ids], ahat, bhat, X


def localmap_gate(T_wr, cand_ids, cand_valid, map_pos, map_desc, map_normal,
                  uv, anchor, im_valid, cam_T_ref, fxycxy, image_wh,
                  min_view_cos: float = 0.5):
    """T_wr (4, 4) float32, cand_ids (L,) int32, cand_valid (L,) bool, the
    map mirror's map_pos (cap, 3), map_desc (cap, 8) int32 and map_normal
    (cap, 3), the current features' uv (M, 2), anchor (M,) int32 and
    im_valid (M,) bool, the rig's cam_T_ref (C, 4, 4) and fxycxy (C, 4),
    image_wh (W, H) -> (lm_desc (L, 8), ahat (M, 3C + 2), bhat (3C + 2,
    L), lm_pos (L, 3)): see localmap_gate_reference. CUDA tensors launch
    localmap_gate (one launch: the column blocks write the candidates'
    descriptors, positions and bhat, the row blocks ahat; the outputs
    carved from one buffer, localmap_gate_outputs); CPU tensors take the
    plain version."""
    if _build.device_type(uv, "localmap_gate") == "cpu":
        return localmap_gate_reference(
            T_wr, cand_ids, cand_valid, map_pos, map_desc, map_normal, uv,
            anchor, im_valid, cam_T_ref, fxycxy, image_wh, min_view_cos)
    dev = uv.device
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    C = cam_T_ref.shape[0]
    _cameras("localmap_gate", C)
    M, L, cap = uv.shape[0], cand_ids.shape[0], map_pos.shape[0]
    ins = _build.kernel_inputs(
        "localmap_gate", dev, uv=(uv, f32, (M, 2)),
        anchor=(anchor, i32, (M,)), im_valid=(im_valid, b8, (M,)),
        cand_ids=(cand_ids, i32, (L,)), cand_valid=(cand_valid, b8, (L,)),
        map_pos=(map_pos, f32, (cap, 3)), map_desc=(map_desc, i32, (cap, 8)),
        map_normal=(map_normal, f32, (cap, 3)),
        cam_T_ref=(cam_T_ref, f32, (C, 4, 4)), fxycxy=(fxycxy, f32, (C, 4)),
        T_wr=(T_wr, f32, (4, 4)))
    if cap < 1:
        raise ValueError("localmap_gate: an empty map mirror")
    out = localmap_gate_outputs(M, L, C, dev)
    w, h = image_wh
    lib = _build.library()
    _build.count("localmap_gate")
    _build.check(lib.mc_localmap_gate(
        *(x.data_ptr() for x in ins), *(x.data_ptr() for x in out), M, L, C,
        cap, float(w), float(h), float(min_view_cos),
        _build.stream_ptr(dev)), "mc_localmap_gate")
    return out


def localmap_epilogue_reference(best, second, idx, im_valid, cand_ids,
                                lm_pos, map_pos, obs, max_dist: int):
    """Plain PyTorch version of localmap_epilogue: ok = best <= max_dist &
    best <= second & im_valid, the landmark lm = cand_ids[idx] where ok
    (else -1) -> (pose_lm's rows (22, M): map_pos[max(lm, 0)], then rows
    3-21 of the inter-frame rows obs; the mask lm >= 0 as float32 (M,);
    lm (M,) int32). lm_pos, localmap_gate's candidate positions, is what
    the kernel reads the matched rows from (ok ? lm_pos[idx] : map_pos[0],
    the same values); the plain version gathers map_pos itself."""
    ok = (best <= max_dist) & (best <= second) & im_valid
    lm = torch.where(ok, cand_ids[idx.long()], -1).to(torch.int32)
    X = map_pos[torch.clamp(lm, min=0).long()]
    rows = torch.cat([X.T.to(torch.float32), obs[3:]], dim=0).contiguous()
    return rows, (lm >= 0).to(torch.float32), lm


def localmap_epilogue(best, second, idx, im_valid, cand_ids, lm_pos, map_pos,
                      obs, max_dist: int):
    """The local-map match's best, second (M,) float32 and idx (M,) int32,
    the current features' im_valid (M,) bool, cand_ids (L,) int32,
    localmap_gate's lm_pos (L, 3) of those candidates, map_pos (cap, 3)
    float32, the inter-frame match's pose_lm rows obs (22, M) -> (rows
    (22, M), mask (M,) float32, lm (M,) int32): see
    localmap_epilogue_reference. CUDA tensors launch localmap_epilogue
    (one launch, two dependent load rounds: idx, then cand_ids and lm_pos;
    the outputs carved from one buffer, localmap_epilogue_outputs); CPU
    tensors take the plain version."""
    if _build.device_type(best, "localmap_epilogue") == "cpu":
        return localmap_epilogue_reference(best, second, idx, im_valid,
                                           cand_ids, lm_pos, map_pos, obs,
                                           max_dist)
    dev = best.device
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    M, L, cap = best.shape[0], cand_ids.shape[0], map_pos.shape[0]
    ins = _build.kernel_inputs(
        "localmap_epilogue", dev, best=(best, f32, (M,)),
        second=(second, f32, (M,)), idx=(idx, i32, (M,)),
        im_valid=(im_valid, b8, (M,)), cand_ids=(cand_ids, i32, (L,)),
        lm_pos=(lm_pos, f32, (L, 3)), map_pos=(map_pos, f32, (cap, 3)),
        obs=(obs, f32, (OBS_ROWS, M)))
    if L < 1 or cap < 1:
        raise ValueError(f"localmap_epilogue: {L} candidates and the map's "
                         f"{cap} rows must each be >= 1")
    out = localmap_epilogue_outputs(M, dev)
    lib = _build.library()
    _build.count("localmap_epilogue")
    _build.check(lib.mc_localmap_epilogue(
        *(x.data_ptr() for x in ins), *(x.data_ptr() for x in out), M, L,
        float(max_dist), _build.stream_ptr(dev)), "mc_localmap_epilogue")
    return out
