"""FAST + NMS (+ blur) with a 16-row band skip, two CUDA entries (kernel
source csrc/fast_select.cu):

* `fast_select`: FAST + NMS + blur + per-cell top-k selection in one
  launch (counterpart of mcslam_tpu/ops/fast_pallas.py
  fast_select_pallas);
* `fast_corners`: the NMS'd score map, optionally with the blur, with or
  without the per-image height skip (counterpart of fast_corners_pallas,
  both branches).

Each launches its kernel for CUDA tensors and runs its `_reference`, the
plain PyTorch version of the same function, for CPU tensors; the kernels
take the 7 blur taps by value. All skip in 16-row bands and share one
boundary rule (rows clamp to the image, columns wrap modulo the
128-rounded width and then clamp to the last column), so kernel and plain
version agree bit for bit, and the two blurs with each other. Against the Pallas kernels at tile_h=16 the scores, candidates and
zeroed bands are exact; the blur differs by the multiply-add contraction
of the Pallas kernel as XLA compiles it on the CPU (a few f32 ulps). The
JAX package calls fast_corners_pallas at its default tile_h=64 (orb.py
366-373) and fast_select_pallas at 96 (orb.py:359): the tile height moves
only the rows the height skip zeroes, which the caller masks (scores at or
beyond h - 3) or no descriptor samples (blur rows at or beyond h),
fast_pallas.py:66-78.
"""

from __future__ import annotations

import torch

from mcslam_tpu_torch import _build
from mcslam_tpu_torch.ops import fast as fast_ops
from mcslam_tpu_torch.utils import graphs

CELL = 16  # cell size and height of a skipped band
K = 4  # candidates per cell
NO_TAPS = (0.0,) * 7  # the by-value taps of a launch without the blur


def _round128(w: int) -> int:
    return -(-w // 128) * 128


def _blur(img: torch.Tensor, taps: tuple) -> torch.Tensor:
    """The kernels' separable blur of (LC, H, W): vertical then horizontal,
    taps in order, multiply and add rounded apart; rows clamp to the
    image, columns wrap modulo ceil128(W) and then clamp to W - 1."""
    _, H, W = img.shape
    dev = img.device
    t = graphs.values(tuple(taps), torch.float32, dev)
    r = len(taps) // 2
    offs = torch.arange(-r, r + 1, device=dev)
    rows = torch.clamp(torch.arange(H, device=dev)[:, None] + offs, 0, H - 1)
    cols = torch.remainder(torch.arange(W, device=dev)[:, None] + offs,
                           _round128(W))
    cols = torch.clamp(cols, max=W - 1)
    acc = img[:, rows[:, 0], :] * t[0]
    for k in range(1, len(taps)):
        acc = acc + img[:, rows[:, k], :] * t[k]
    out = acc[:, :, cols[:, 0]] * t[0]
    for k in range(1, len(taps)):
        out = out + acc[:, :, cols[:, k]] * t[k]
    return out


def _zero_skipped(x: torch.Tensor, skip_from: torch.Tensor) -> torch.Tensor:
    """Zero the rows of every 16-row band of x (LC, H, W) that starts at or
    beyond skip_from[c] (the kernels' band skip)."""
    H = x.shape[1]
    band_start = (torch.arange(H, device=x.device) // CELL) * CELL
    live = band_start[None, :] < skip_from.to(x.device)[:, None]  # (LC, H)
    return torch.where(live[:, :, None], x, torch.zeros_like(x))


def fast_select_reference(img: torch.Tensor, min_threshold: float,
                          fast_threshold: float, heights: torch.Tensor,
                          widths: torch.Tensor, taps: tuple):
    """Plain PyTorch version of the kernel. img (LC, H, W) f32 ->
    (blurred (LC, H, W), cand_v (LC, G, 4), cand_rid (LC, G, 4) int32),
    G = ceil(H/16) * ceil128(W)/16, candidates cell-raster-major and
    round-minor; candidate (g, r) sits at pixel
    (g // ncx * 16 + rid // 16, g % ncx * 16 + rid % 16)."""
    LC, H, W = img.shape
    dev = img.device
    Wp = _round128(W)
    ncx = Wp // CELL
    nb = -(-H // CELL)
    heights = heights.to(device=dev, dtype=torch.int64)
    widths = widths.to(device=dev, dtype=torch.int64)
    f32 = torch.float32
    blur = _zero_skipped(_blur(img, taps), heights)

    # score -> true-bounds mask -> rank bonus, on the (nb*16, Wp) grid
    score = fast_ops.fast_corners(img, min_threshold)
    s = torch.zeros(LC, nb * CELL, Wp, dtype=f32, device=dev)
    s[:, :H, :W] = score
    yy = torch.arange(nb * CELL, device=dev)[None, :, None]
    xx = torch.arange(Wp, device=dev)[None, None, :]
    ok = (yy < heights[:, None, None] - fast_ops.BORDER) & (
        xx < widths[:, None, None] - fast_ops.BORDER)
    s = torch.where(ok, s, torch.zeros_like(s))
    thr = graphs.values(fast_threshold, f32, dev)
    s = torch.where(s > thr, s + 1.0, s)

    # exact per-cell top-K: (value desc, raster rid asc), knock out winner
    cells = s.reshape(LC, nb, CELL, ncx, CELL).permute(0, 1, 3, 2, 4)
    cells = cells.reshape(LC, nb * ncx, CELL * CELL).clone()
    vals, rids = [], []
    for _ in range(K):
        a = torch.argmax(cells, dim=-1, keepdim=True)
        vals.append(torch.gather(cells, -1, a)[..., 0])
        rids.append(a[..., 0])
        cells.scatter_(-1, a, -1.0)
    cand_v = torch.stack(vals, dim=-1)
    cand_r = torch.stack(rids, dim=-1).to(torch.int32)
    skip = (torch.arange(nb, device=dev)[None, :] * CELL
            >= heights[:, None])  # (LC, nb)
    skip = skip[:, :, None, None].expand(LC, nb, ncx, K).reshape(
        LC, nb * ncx, K)
    cand_v = torch.where(skip, torch.zeros_like(cand_v), cand_v)
    cand_r = torch.where(skip, torch.zeros_like(cand_r), cand_r)
    return blur, cand_v, cand_r


def fast_select(img: torch.Tensor, min_threshold: float,
                fast_threshold: float, heights: torch.Tensor,
                widths: torch.Tensor, taps: tuple):
    """(LC, H, W) f32 -> (blurred, cand_v, cand_rid); see
    fast_select_reference for the layout. CUDA tensors launch the kernel;
    CPU tensors take the plain version."""
    if img.device.type == "cpu":
        return fast_select_reference(img, min_threshold, fast_threshold,
                                     heights, widths, taps)
    if img.device.type != "cuda":
        raise ValueError(f"fast_select: unsupported device {img.device}")
    if img.dtype != torch.float32 or img.ndim != 3 or not img.is_contiguous():
        raise ValueError("fast_select: img must be a contiguous (LC, H, W) "
                         f"float32 tensor, got {img.dtype} {tuple(img.shape)}")
    LC, H, W = img.shape
    for name, v in (("heights", heights), ("widths", widths)):
        if (v.device != img.device or v.dtype != torch.int32
                or v.shape != (LC,) or not v.is_contiguous()):
            raise ValueError(f"fast_select: {name} must be a contiguous "
                             f"({LC},) int32 tensor on {img.device}")
    if len(taps) != 7:
        raise ValueError("fast_select: the kernel takes 7 blur taps")
    if H < 8 or W < 8:
        raise ValueError("fast_select: image smaller than 8x8")
    nb = -(-H // CELL)
    G = nb * (_round128(W) // CELL)
    blur = torch.empty_like(img)
    cand_v = torch.empty(LC, G, K, dtype=torch.float32, device=img.device)
    cand_r = torch.empty(LC, G, K, dtype=torch.int32, device=img.device)
    lib = _build.library()
    _build.count("fast_select")
    _build.check(lib.mc_fast_select(
        img.data_ptr(), heights.data_ptr(), widths.data_ptr(),
        blur.data_ptr(), cand_v.data_ptr(), cand_r.data_ptr(), LC, H, W,
        float(min_threshold), float(fast_threshold), *map(float, taps),
        _build.stream_ptr(img.device),
    ), "mc_fast_select")
    return blur, cand_v, cand_r


def fast_corners_reference(img: torch.Tensor, threshold: float,
                           heights: torch.Tensor | None = None,
                           taps: tuple | None = None):
    """Plain PyTorch version of mc_fast_corners. img (LC, H, W) f32 ->
    the (LC, H, W) NMS'd FAST score map at `threshold`, and with `taps`
    also the 7-tap blur: (score, blurred). With `heights` (mode hskip)
    every 16-row band starting at or beyond heights[c] (with the blur) or
    heights[c] - 3 (without) is zero in both outputs."""
    score = fast_ops.fast_corners(img, threshold)
    blur = _blur(img, taps) if taps is not None else None
    if heights is not None:
        h = heights.to(device=img.device, dtype=torch.int64)
        score = _zero_skipped(score, h if taps is not None
                              else h - fast_ops.BORDER)
        if blur is not None:
            blur = _zero_skipped(blur, h)
    return score if blur is None else (score, blur)


def fast_corners(img: torch.Tensor, threshold: float,
                 heights: torch.Tensor | None = None,
                 taps: tuple | None = None):
    """(LC, H, W) f32 -> score, or (score, blurred) with `taps`; see
    fast_corners_reference. `heights` ((LC,) int32) selects mode hskip,
    None mode full. CUDA tensors launch the kernel; CPU tensors take the
    plain version."""
    if img.device.type == "cpu":
        return fast_corners_reference(img, threshold, heights, taps)
    if img.device.type != "cuda":
        raise ValueError(f"fast_corners: unsupported device {img.device}")
    if img.dtype != torch.float32 or img.ndim != 3 or not img.is_contiguous():
        raise ValueError("fast_corners: img must be a contiguous (LC, H, W) "
                         f"float32 tensor, got {img.dtype} {tuple(img.shape)}")
    LC, H, W = img.shape
    if heights is not None and (
            heights.device != img.device or heights.dtype != torch.int32
            or heights.shape != (LC,) or not heights.is_contiguous()):
        raise ValueError("fast_corners: heights must be a contiguous "
                         f"({LC},) int32 tensor on {img.device}")
    if taps is not None and len(taps) != 7:
        raise ValueError("fast_corners: the kernel takes 7 blur taps")
    if H < 8 or W < 8:
        raise ValueError("fast_corners: image smaller than 8x8")
    score = torch.empty_like(img)
    blur = torch.empty_like(img) if taps is not None else None
    lib = _build.library()
    _build.count("fast_corners_hskip" if heights is not None
                 else "fast_corners_full")
    _build.check(lib.mc_fast_corners(
        img.data_ptr(), heights.data_ptr() if heights is not None else None,
        score.data_ptr(), blur.data_ptr() if blur is not None else None,
        LC, H, W, float(threshold), *map(float, taps or NO_TAPS),
        _build.stream_ptr(img.device),
    ), "mc_fast_corners")
    return score if blur is None else (score, blur)
