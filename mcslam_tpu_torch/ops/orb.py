"""Oriented-BRIEF (ORB-class) feature extraction over the whole rig
(counterpart of mcslam_tpu/ops/orb.py).

The production route: pyramid -> all levels edge-padded to level 0's
shape and stacked into one (L*C, H, W) batch -> one fast_select launch
(FAST + NMS + blur + per-cell top-4) -> global top-N per image ->
per-level quota and edge margin -> cross-level compaction to num_points
per camera -> patch gather -> intensity-centroid orientation -> steered
BRIEF-256. The pyramid with its stack, the selection through the
compaction, and the orientation with the descriptors are the kernels of
ops/orb_cuda.py (their plain versions for CPU tensors). `OrbRoute` selects the JAX package's other routes (its
environment switches) as explicit arguments: the score map with the
selection chain outside the kernel, the standalone blur, no height skip,
the subcell selection, compaction after the descriptors, and the patch
gather that also computes the orientation moments.

Selection is exact (stable sorts everywhere): the JAX package's
approx_topk option lowers to exact top-k on the CPU, and the port keeps
that exact semantics on every device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from mcslam_tpu_torch.ops import fast as fast_ops
from mcslam_tpu_torch.ops import hamming, image as image_ops, topk_grid
from mcslam_tpu_torch.ops.fast_cuda import fast_corners, fast_select
from mcslam_tpu_torch.ops.patch_cuda import (
    PATCH, PATCH_R, patch_gather, patch_gather_batched, patch_gather_oriented)
from mcslam_tpu_torch.ops.topk_grid import topk_stable
from mcslam_tpu_torch.utils import graphs

PATCH_RADIUS = 15  # IC-angle circular patch radius (31x31 patch)
EDGE = 19  # keep-out border for orientation/descriptor sampling
ANGLE_BINS = 32  # steering quantization: 11.25 deg granularity


@functools.lru_cache(maxsize=None)
def brief_pattern(seed: int = 7, bits: int = 256) -> np.ndarray:
    """(bits, 2, 2) int32 array of (p, q) offsets, each (dx, dy) in [-13, 13].

    13 = PATCH_RADIUS - 2 keeps rotated samples inside the 31x31 patch for
    any angle (13 * sqrt(2) < 19-edge margin handles the rest).
    """
    rng = np.random.RandomState(seed)
    sigma = PATCH_RADIUS / 5.0 * 2.0
    pts = np.clip(np.round(rng.randn(bits, 2, 2) * sigma), -13, 13)
    return pts.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _circle_weights() -> tuple[np.ndarray, np.ndarray]:
    """(PATCH, PATCH) x/y weight masks of the IC-angle circular patch."""
    r = PATCH_RADIUS
    ys, xs = np.mgrid[-PATCH_R : PATCH_R + 1, -PATCH_R : PATCH_R + 1]
    circle = (xs * xs + ys * ys) <= r * r
    return (
        (xs * circle).astype(np.float32),
        (ys * circle).astype(np.float32),
    )


@functools.lru_cache(maxsize=None)
def _moment_weight_matrix() -> np.ndarray:
    """(PATCH*PATCH, 2) [kx | ky] stacked circular-moment weights."""
    kx, ky = _circle_weights()
    return np.stack([kx.reshape(-1), ky.reshape(-1)], axis=-1)


@functools.lru_cache(maxsize=None)
def _steered_bit_matrices(bins: int = ANGLE_BINS) -> np.ndarray:
    """(bins * 256, PATCH*PATCH) sparse ±1 matrices: row (b*256+s) has +1 at
    the rotated q-sample position and -1 at the p position for angle bin b,
    so bit = (D @ patch_flat) > 0. Turns steered-BRIEF sampling into one
    dense matmul on the MXU instead of 2M random gathers (~20x faster on
    v5e than the gather formulation)."""
    pat = brief_pattern().astype(np.float64)  # (256, 2, 2) (dx, dy)
    D = np.zeros((bins * 256, PATCH * PATCH), np.float32)
    c0 = PATCH_R
    for b in range(bins):
        a = 2.0 * np.pi * b / bins
        ca, sa = np.cos(a), np.sin(a)
        dx = pat[..., 0]
        dy = pat[..., 1]
        rx = np.round(ca * dx - sa * dy).astype(int)  # (256, 2)
        ry = np.round(sa * dx + ca * dy).astype(int)
        rx = np.clip(rx + c0, 0, PATCH - 1)
        ry = np.clip(ry + c0, 0, PATCH - 1)
        for s in range(256):
            row = b * 256 + s
            D[row, ry[s, 0] * PATCH + rx[s, 0]] += -1.0  # p sample
            D[row, ry[s, 1] * PATCH + rx[s, 1]] += 1.0  # q sample
    return D


@functools.lru_cache(maxsize=None)
def _steered_sample_index(bins: int = ANGLE_BINS) -> np.ndarray:
    """(bins, 256, 2) flat patch positions of the (p, q) samples of each
    steered pair — the nonzero columns of _steered_bit_matrices' rows."""
    pat = brief_pattern().astype(np.float64)
    out = np.zeros((bins, 256, 2), np.int64)
    for b in range(bins):
        a = 2.0 * np.pi * b / bins
        ca, sa = np.cos(a), np.sin(a)
        rx = np.round(ca * pat[..., 0] - sa * pat[..., 1]).astype(int)
        ry = np.round(sa * pat[..., 0] + ca * pat[..., 1]).astype(int)
        rx = np.clip(rx + PATCH_R, 0, PATCH - 1)
        ry = np.clip(ry + PATCH_R, 0, PATCH - 1)
        out[b] = ry * PATCH + rx
    return out


def extract_patches(img: torch.Tensor, yx: torch.Tensor):
    """(H, W) f32 image + (N, 2) int yx -> ((N, 39, 39) patches, (N, 2)
    int32 patch origins, clamped into the image): patch_gather on the
    one image (its kernel for CUDA tensors, its plain version for CPU
    tensors)."""
    yx = yx.to(torch.int32).contiguous()
    idx = torch.zeros(yx.shape[0], dtype=torch.int32, device=yx.device)
    return patch_gather(img[None].contiguous(), yx, idx)


def extract_patches_indexed(imgs: torch.Tensor, yx: torch.Tensor,
                            img_idx: torch.Tensor):
    """Flat-list patch extraction: imgs (B, H, W), yx (T, 2) int, img_idx
    (T,) int (each keypoint's source image) -> ((T, 39, 39) patches,
    (T, 2) int32 origins), through patch_gather."""
    return patch_gather(imgs.contiguous(), yx.to(torch.int32).contiguous(),
                        img_idx.to(torch.int32).contiguous())


MOMENT_SLOTS = 2048  # PATCH * PATCH products padded to a power of two


def patch_moments(patches: torch.Tensor) -> torch.Tensor:
    """(N, 2) circular moments (m10, m01) of (N, P, P) patches. Each sums
    the P^2 products patch * weight, padded with zeros to MOMENT_SLOTS,
    in a fixed pairwise halving tree (x[:n] + x[n:] down to one value):
    every add an f32 elementwise op, so every device and every batch size
    gives the same bits (csrc/orb_describe.cu repeats the tree; the
    camera-sharded build, parallel/sharded_frame, must equal the
    unsharded one)."""
    W = graphs.const("orb.moment_weights", patches.device,
                     _moment_weight_matrix)
    flat = patches.reshape(patches.shape[0], PATCH * PATCH)
    m = []
    for k in range(2):
        x = F.pad(flat * W[:, k], (0, MOMENT_SLOTS - PATCH * PATCH))
        n = MOMENT_SLOTS
        while n > 1:
            n //= 2
            x = x[:, :n] + x[:, n:]
        m.append(x[:, 0])
    return torch.stack(m, dim=-1)


def patch_orientation(patches: torch.Tensor) -> torch.Tensor:
    """IC angle atan2(m01, m10) of (N, P, P) patches (patch_moments)."""
    m = patch_moments(patches)
    return torch.atan2(m[:, 1], m[:, 0])


def compute_descriptors_patch(patches: torch.Tensor, angle: torch.Tensor,
                              angle_bins: int = ANGLE_BINS) -> torch.Tensor:
    """Steered BRIEF-256 -> (N, 8) int32 words. Patches are rounded to
    bf16 (nearest-even) as the JAX package's bf16 matmul rounds them; each
    bit is sign(q - p) of two samples, and the difference of two bf16
    values is exact in f32, so the bits equal the matmul form's."""
    n = patches.shape[0]
    dev = patches.device
    flat = patches.reshape(n, PATCH * PATCH).to(torch.bfloat16).to(
        torch.float32)
    two_pi = graphs.values(2.0 * np.pi, torch.float32, dev)
    b = torch.round((torch.remainder(angle, two_pi) / two_pi) * angle_bins)
    b = b.to(torch.int64) % angle_bins
    idx = graphs.const(("orb.steered_index", angle_bins), dev,
                       lambda: _steered_sample_index(angle_bins))[b]
    p = torch.gather(flat, 1, idx[..., 0])
    q = torch.gather(flat, 1, idx[..., 1])
    return hamming.pack_bits((q - p) > 0)


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set per camera (padded + masked)."""

    xy: torch.Tensor  # (C, N, 2) float32, level-0 pixel coords (x, y)
    response: torch.Tensor  # (C, N) float32
    angle: torch.Tensor  # (C, N) float32 radians
    octave: torch.Tensor  # (C, N) int32 pyramid level
    sigma2: torch.Tensor  # (C, N) float32 scale^(2*octave)
    desc: torch.Tensor  # (C, N, 8) int32 packed BRIEF-256
    valid: torch.Tensor  # (C, N) bool


@dataclasses.dataclass(frozen=True)
class OrbRoute:
    """The extraction route of extract_orb_rig: one field per environment
    switch that the JAX package reads at trace time (mcslam_tpu/ops/
    orb.py); the defaults are its production route.

    select_in_kernel: per-cell selection inside the FAST launch
        (fast_select); False (MCSLAM_NO_SEL_INKERNEL=1) writes the score
        map (fast_corners) and selects from it outside. Needs fused_blur.
    fused_blur: the FAST launch also writes the 7-tap blur; False
        (MCSLAM_NO_FUSED_BLUR=1) blurs in a separate pass
        (image.gaussian_blur).
    hskip: the score-map kernel skips the bands below each level's true
        height; False is MCSLAM_FAST_NO_HSKIP=1.
    sel_subcell: the score-map selection takes 2 candidates per 8x8
        subcell (MCSLAM_SEL_SUBCELL=1) instead of 4 per 16x16 cell.
    late_compact: descriptors for every per-level slot, cross-level
        compaction after (MCSLAM_LATE_COMPACT=1; takes precedence over
        fused_orient).
    fused_orient: the patch gather also sums the orientation moments and
        writes bf16 patches (MCSLAM_FUSED_ORIENT=1).
    """

    select_in_kernel: bool = True
    fused_blur: bool = True
    hskip: bool = True
    sel_subcell: bool = False
    late_compact: bool = False
    fused_orient: bool = False


@functools.lru_cache(maxsize=None)
def _level_budget(total: int, num_levels: int, scale: float) -> tuple:
    """Per-level keypoint budget, geometric decay like the reference."""
    inv = 1.0 / scale
    raw = np.array([inv**l for l in range(num_levels)])
    raw = raw / raw.sum() * total
    counts = np.maximum(8, np.round(raw).astype(int))
    counts[0] += total - counts.sum()
    return tuple(int(c) for c in counts)


def _select_from_cells(cand_v, cand_rid, maxb: int, *, per_cell: int,
                       cell: int, ncx: int):
    """Global top-maxb per image over fast_select's per-cell candidates
    (cell raster-major, round-minor) -> (yx (LC, maxb, 2) int32, resp,
    valid)."""
    LC = cand_v.shape[0]
    flat_v = cand_v.reshape(LC, -1)
    flat_r = cand_rid.reshape(LC, -1)
    n = min(maxb, flat_v.shape[1])
    resp, arg = topk_stable(flat_v, n)
    g = arg // per_cell
    rid = torch.gather(flat_r, 1, arg).to(torch.int64)
    valid = resp > 0.0
    zero = torch.zeros_like(g)
    ys = torch.where(valid, (g // ncx) * cell + rid // cell, zero)
    xs = torch.where(valid, (g % ncx) * cell + rid % cell, zero)
    yx = torch.stack([ys, xs], dim=-1).to(torch.int32)
    if n < maxb:
        pad = maxb - n
        yx = F.pad(yx, (0, 0, 0, pad))
        resp = F.pad(resp, (0, pad))
        valid = torch.cat([valid, torch.zeros(LC, pad, dtype=torch.bool,
                                              device=valid.device)], 1)
    return yx, resp, valid


def _compaction(valid, resp, n: int):
    """Cross-level compaction of (C, M) slots to the n best per camera
    (valid ones first, by response, ties to the lower slot): -> a function
    that takes those n slots of any (C, M, ...) tensor."""
    prio = torch.where(valid, resp + 1e3, torch.full_like(resp, -1.0))
    _, top = topk_stable(prio, n)

    def take(a):
        idx = top.reshape(*top.shape, *([1] * (a.ndim - 2)))
        return torch.take_along_dim(a, idx, dim=1)

    return take


def _slot_fields(yx, resp, valid, h_l, w_l, *, L: int, C: int,
                 budgets: tuple, scale: float):
    """Per (L C, maxb) slot of the selected candidates: the rank bonus
    undone, the level quota and the EDGE margin against the level's true
    size applied to the validity, then the slot metadata -> (yx, resp,
    valid, xy0 (level-0 pixels), octave, sigma2, image index)."""
    dev = yx.device
    maxb = yx.shape[1]
    resp = torch.where(resp > 1.0, resp - 1.0, resp)  # undo rank bonus
    budget_arr = graphs.values(tuple(b for b in budgets for _ in range(C)),
                               torch.int64, dev)
    valid = valid & (torch.arange(maxb, device=dev)[None, :]
                     < budget_arr[:, None])
    hl, wl = h_l.long()[:, None], w_l.long()[:, None]
    inb = ((yx[..., 0] >= EDGE) & (yx[..., 0] < hl - EDGE)
           & (yx[..., 1] >= EDGE) & (yx[..., 1] < wl - EDGE))
    valid = valid & inb

    s_lvl = graphs.values(tuple(scale**lvl for lvl in range(L)),
                          torch.float32, dev)
    xy_lvl = torch.stack([yx[..., 1], yx[..., 0]], dim=-1).to(torch.float32)
    xy0 = (xy_lvl.reshape(L, C, maxb, 2)
           * s_lvl[:, None, None, None]).reshape(L * C, maxb, 2)
    octv = torch.arange(L, dtype=torch.int32, device=dev)[:, None, None] \
        .expand(L, C, maxb).reshape(L * C, maxb)
    sigma2 = (s_lvl**2)[:, None, None].expand(L, C, maxb).reshape(L * C, maxb)
    img_idx = torch.arange(L * C, dtype=torch.int32, device=dev)[:, None] \
        .expand(L * C, maxb)
    return yx, resp, valid, xy0, octv, sigma2, img_idx


def _merge(x, L: int, C: int):
    """(L*C, maxb, ...) -> (C, L*maxb, ...), level-major slot order."""
    maxb = x.shape[1]
    x = x.reshape(L, C, maxb, *x.shape[2:])
    return x.movedim(1, 0).reshape(C, L * maxb, *x.shape[3:])


def _merge_compact(yx, resp, valid, xy0, octv, sigma2, img_idx, *, L: int,
                   C: int, n_out: int):
    """The slot fields merged per camera into level-major order, then the
    early cross-level compaction to the n_out best per camera -> (xy,
    response, octave, sigma2, valid (C, n_out, ...); flat yx (C n_out, 2)
    and image index (C n_out,), the patch gather's inputs)."""
    yxm, resp_m, valid_m, img_m, octv_m, sig2_m, xy0_m = (
        _merge(a, L, C) for a in (yx, resp, valid, img_idx, octv, sigma2,
                                  xy0))
    if yxm.shape[1] > n_out:
        take = _compaction(valid_m, resp_m, n_out)
        yxm, resp_m, valid_m, img_m, octv_m, sig2_m, xy0_m = (
            take(yxm), take(resp_m), take(valid_m), take(img_m),
            take(octv_m), take(sig2_m), take(xy0_m))
    T = C * n_out
    return (xy0_m, resp_m, octv_m, sig2_m, valid_m,
            yxm.reshape(T, 2).contiguous(), img_m.reshape(T).contiguous())


def _select_from_score(score, h_l, w_l, fast_threshold, maxb: int, *,
                       cell: int, per_cell: int, subcell: bool):
    """The selection chain over dense (LC, H, W) score maps: each image's
    true-bounds interior mask, the +1 rank bonus above fast_threshold,
    then the grid selection of all images at once -> (yx (LC, maxb, 2)
    int32, resp, valid)."""
    _, H, W = score.shape
    dev = score.device
    yy = torch.arange(H, device=dev)[None, :, None]
    xx = torch.arange(W, device=dev)[None, None, :]
    interior = ((yy < h_l.long()[:, None, None] - fast_ops.BORDER)
                & (xx < w_l.long()[:, None, None] - fast_ops.BORDER))
    score = torch.where(interior, score, torch.zeros_like(score))
    thr = graphs.values(fast_threshold, torch.float32, dev)
    score = torch.where(score > thr, score + 1.0, score)
    if subcell:
        return topk_grid.select_keypoints_subcell(score, maxb,
                                                  sub=max(4, cell // 2))
    return topk_grid.select_keypoints(score, maxb, cell=cell,
                                      per_cell=per_cell)


def extract_orb_rig(imgs: torch.Tensor, num_points: int = 1024,
                    num_levels: int = 8, scale: float = 1.2,
                    fast_threshold: float = 20.0 / 255.0,
                    min_threshold: float = 7.0 / 255.0,
                    angle_bins: int = ANGLE_BINS,
                    route: OrbRoute = OrbRoute()) -> Keypoints:
    """Camera-batched multi-scale ORB: imgs (C, H, W) float32 in [0, 1]
    -> Keypoints with a leading camera axis and num_points slots (cells
    of 16x16 pixels, 4 candidates per cell), by the given route. The
    pyramid is built straight into the stacked batch (orb_cuda.
    orb_pyramid)."""
    from mcslam_tpu_torch.ops import orb_cuda

    H0, W0 = imgs.shape[-2:]
    stacked = orb_cuda.orb_pyramid(imgs, num_levels, scale=scale)
    return _extract_stacked(
        stacked, image_ops.pyramid_shapes(H0, W0, num_levels, scale),
        num_points, scale, fast_threshold, min_threshold, angle_bins, route)


def extract_orb(img: torch.Tensor, **kwargs) -> Keypoints:
    """Single-image extraction: extract_orb_rig on img[None] (H, W), the
    camera axis dropped from every field."""
    kps = extract_orb_rig(img[None], **kwargs)
    return Keypoints(*(a[0] for a in kps))


def extract_orb_levels(levels: list[torch.Tensor], num_points: int = 1024,
                       scale: float = 1.2,
                       fast_threshold: float = 20.0 / 255.0,
                       min_threshold: float = 7.0 / 255.0,
                       angle_bins: int = ANGLE_BINS,
                       route: OrbRoute = OrbRoute()) -> Keypoints:
    """extract_orb_rig from an already built pyramid: levels[l] is the
    (C, h_l, w_l) image stack of level l."""
    hw = tuple((lv.shape[-2], lv.shape[-1]) for lv in levels)
    return _extract_stacked(stack_levels(levels), hw, num_points, scale,
                            fast_threshold, min_threshold, angle_bins, route)


def stack_levels(levels: list[torch.Tensor]) -> torch.Tensor:
    """Every (C, h_l, w_l) level edge-padded to level 0's (H0, W0) and
    stacked level-major: (L*C, H0, W0), the FAST kernels' input."""
    H0, W0 = levels[0].shape[-2:]
    return torch.cat(
        [F.pad(lv[None], (0, W0 - lv.shape[-1], 0, H0 - lv.shape[-2]),
               mode="replicate")[0] for lv in levels], dim=0).contiguous()


def _extract_stacked(stacked, hw, num_points, scale, fast_threshold,
                     min_threshold, angle_bins, route) -> Keypoints:
    """The extraction from the (L*C, H0, W0) level stack whose level l
    has the true size hw[l]."""
    from mcslam_tpu_torch.ops import orb_cuda

    cell, per_cell = 16, 4
    dev = stacked.device
    L = len(hw)
    C = stacked.shape[0] // L
    budgets = _level_budget(num_points, L, scale)
    maxb = max(budgets)
    n_out = min(num_points, L * maxb)
    W0 = stacked.shape[-1]
    # per-image level sizes, made once per device (no upload inside a
    # captured frame)
    h_l = graphs.values(tuple(h for h, _ in hw for _ in range(C)),
                        torch.int32, dev)
    w_l = graphs.values(tuple(w for _, w in hw for _ in range(C)),
                        torch.int32, dev)
    taps = image_ops._np_gaussian_taps(7, 2.0)
    ncx = (-(-W0 // 128) * 128) // cell
    if route.fused_blur and route.select_in_kernel:
        blurred, cand_v, cand_rid = fast_select(
            stacked, min_threshold, fast_threshold, h_l, w_l, taps=taps)
        if not route.late_compact:
            xy0, resp, octv, sigma2, valid, flat_yx, flat_img = \
                orb_cuda.orb_select(cand_v, cand_rid, h_l, w_l, C=C,
                                    budgets=budgets, n_out=n_out,
                                    scale=scale, ncx=ncx, cell=cell,
                                    per_cell=per_cell)
            return _describe(blurred, xy0, resp, octv, sigma2, valid,
                             flat_yx, flat_img, angle_bins, route)
        yx, resp, valid = _select_from_cells(
            cand_v, cand_rid, maxb, per_cell=per_cell, cell=cell, ncx=ncx)
    else:
        heights = h_l if route.hskip else None
        if route.fused_blur:
            score, blurred = fast_corners(stacked, min_threshold, heights,
                                          taps)
        else:
            blurred = image_ops.gaussian_blur(stacked, 7, 2.0)
            score = fast_corners(stacked, min_threshold, heights)
        yx, resp, valid = _select_from_score(
            score, h_l, w_l, fast_threshold, maxb, cell=cell,
            per_cell=per_cell, subcell=route.sel_subcell)
    fields = _slot_fields(yx, resp, valid, h_l, w_l, L=L, C=C,
                          budgets=budgets, scale=scale)
    if route.late_compact:
        return _finish_late_compact(blurred, *fields[:-1], L, C, num_points,
                                    angle_bins)
    return _describe(blurred, *_merge_compact(*fields, L=L, C=C, n_out=n_out),
                     angle_bins, route)


def _describe(blurred, xy0, resp, octv, sigma2, valid, flat_yx, flat_img,
              angle_bins, route) -> Keypoints:
    """The patch gather, orientation and descriptors of the compacted
    slots -> Keypoints."""
    from mcslam_tpu_torch.ops import orb_cuda

    C, n_out = valid.shape
    if route.fused_orient:
        patches, m, _origin = patch_gather_oriented(blurred, flat_yx,
                                                    flat_img)
        ang = torch.atan2(m[:, 1], m[:, 0])
        desc = compute_descriptors_patch(patches, ang, angle_bins)
    else:
        patches, _origin = patch_gather(blurred, flat_yx, flat_img)
        ang, desc = orb_cuda.orb_describe(patches, angle_bins)
    return Keypoints(
        xy=xy0, response=resp, angle=ang.reshape(C, n_out), octave=octv,
        sigma2=sigma2, desc=desc.reshape(C, n_out, 8), valid=valid,
    )


def _finish_late_compact(blurred, yx, resp, valid, xy0, octv, sigma2, L, C,
                         num_points, angle_bins) -> Keypoints:
    """Descriptors for all L*maxb slots of every camera, then the same
    cross-level compaction as the early route (the same keypoint set)."""
    from mcslam_tpu_torch.ops import orb_cuda

    LC, maxb = yx.shape[:2]
    patches, _origin = patch_gather_batched(blurred, yx.contiguous())
    ang, desc = orb_cuda.orb_describe(
        patches.reshape(LC * maxb, PATCH, PATCH), angle_bins)
    kp = Keypoints(
        xy=_merge(xy0, L, C), response=_merge(resp, L, C),
        angle=_merge(ang.reshape(LC, maxb), L, C),
        octave=_merge(octv, L, C), sigma2=_merge(sigma2, L, C),
        desc=_merge(desc.reshape(LC, maxb, 8), L, C),
        valid=_merge(valid, L, C),
    )
    if kp.valid.shape[1] > num_points:
        take = _compaction(kp.valid, kp.response, num_points)
        kp = Keypoints(*(take(a) for a in kp))
    return kp
