"""FAST + NMS + blur + per-cell top-k selection in one CUDA launch
(counterpart of mcslam_tpu/ops/fast_pallas.py fast_select_pallas; kernel
source csrc/fast_select.cu).

`fast_select` launches the kernel for CUDA tensors and runs
`fast_select_reference`, the plain PyTorch version of the same function,
for CPU tensors. Both compute with 16-row bands and the same boundary
rule (rows clamp to the image, columns wrap modulo the 128-rounded width
and then clamp to the last column), so they agree bit for bit — and with
fast_select_pallas(..., tile_h=16).
"""

from __future__ import annotations

import torch

from mcslam_tpu_torch import _build
from mcslam_tpu_torch.ops import fast as fast_ops

CELL = 16  # cell size and band height of the kernel
K = 4  # candidates per cell
LAUNCHES = 0  # kernel launches since the last reset


def _round128(w: int) -> int:
    return -(-w // 128) * 128


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
    t = torch.tensor(taps, dtype=f32, device=dev)
    r = len(taps) // 2

    # blur: vertical then horizontal, taps in order, mul and add separate
    offs = torch.arange(-r, r + 1, device=dev)
    rows = torch.clamp(torch.arange(H, device=dev)[:, None] + offs, 0, H - 1)
    cols = torch.remainder(torch.arange(W, device=dev)[:, None] + offs, Wp)
    cols = torch.clamp(cols, max=W - 1)
    acc = img[:, rows[:, 0], :] * t[0]
    for k in range(1, len(taps)):
        acc = acc + img[:, rows[:, k], :] * t[k]
    blur = acc[:, :, cols[:, 0]] * t[0]
    for k in range(1, len(taps)):
        blur = blur + acc[:, :, cols[:, k]] * t[k]
    band_start = (torch.arange(H, device=dev) // CELL) * CELL
    live_row = band_start[None, :] < heights[:, None]  # (LC, H)
    blur = torch.where(live_row[:, :, None], blur, torch.zeros_like(blur))

    # score -> true-bounds mask -> rank bonus, on the (nb*16, Wp) grid
    score = fast_ops.fast_corners(img, min_threshold)
    s = torch.zeros(LC, nb * CELL, Wp, dtype=f32, device=dev)
    s[:, :H, :W] = score
    yy = torch.arange(nb * CELL, device=dev)[None, :, None]
    xx = torch.arange(Wp, device=dev)[None, None, :]
    ok = (yy < heights[:, None, None] - fast_ops.BORDER) & (
        xx < widths[:, None, None] - fast_ops.BORDER)
    s = torch.where(ok, s, torch.zeros_like(s))
    thr = torch.tensor(fast_threshold, dtype=f32, device=dev)
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
    t = torch.tensor(taps, dtype=torch.float32, device=img.device)
    lib = _build.library()
    global LAUNCHES
    LAUNCHES += 1
    _build.check(lib.mc_fast_select(
        img.data_ptr(), heights.data_ptr(), widths.data_ptr(), t.data_ptr(),
        blur.data_ptr(), cand_v.data_ptr(), cand_r.data_ptr(), LC, H, W,
        float(min_threshold), float(fast_threshold),
        _build.stream_ptr(img.device),
    ), "mc_fast_select")
    return blur, cand_v, cand_r
