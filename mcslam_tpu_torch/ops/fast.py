"""FAST-9/16 corner score and 3x3 NMS as dense tensor ops (counterpart of
mcslam_tpu/ops/fast.py). Min/max are exact, so the score map is
bit-identical to the JAX version's."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mcslam_tpu_torch.utils import graphs

# Bresenham circle radius 3: 16 (dy, dx) offsets in circular order.
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC_LEN = 9
BORDER = 3


def _shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = img[y + dy, x + dx], edge-padded."""
    h, w = img.shape[-2:]
    p = F.pad(img.reshape(-1, 1, h, w),
              (max(-dx, 0), max(dx, 0), max(-dy, 0), max(dy, 0)),
              mode="replicate")
    y0 = max(-dy, 0) + dy
    x0 = max(-dx, 0) + dx
    return p[:, 0, y0:y0 + h, x0:x0 + w].reshape(img.shape)


def fast_score(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Dense FAST-9/16 score map: max over the 16 arc starts of the min
    signed difference along a 9-long contiguous arc (bright and dark),
    zeroed where <= threshold and within BORDER of the image edge."""
    diffs = torch.stack([_shift(img, dy, dx) - img for (dy, dx) in CIRCLE],
                        dim=-3)

    def arc_min(d):
        r = d
        for j in range(1, ARC_LEN):
            r = torch.minimum(r, torch.roll(d, -j, dims=-3))
        return r

    bright = torch.amax(arc_min(diffs), dim=-3)
    dark = torch.amax(arc_min(-diffs), dim=-3)
    score = torch.maximum(bright, dark)
    thr = graphs.values(threshold, score.dtype, score.device)
    score = torch.where(score > thr, score, torch.zeros_like(score))
    h, w = img.shape[-2:]
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    interior = (ys >= BORDER) & (ys < h - BORDER) & (xs >= BORDER) \
        & (xs < w - BORDER)
    return torch.where(interior, score, torch.zeros_like(score))


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-max suppression: keep pixels >= every neighbour and > 0."""
    h, w = score.shape[-2:]
    x = score.reshape(-1, 1, h, w)
    pooled = F.max_pool2d(
        F.pad(x, (1, 1, 1, 1), value=float("-inf")), 3, stride=1
    )
    keep = (x >= pooled) & (x > 0.0)
    return torch.where(keep, x, torch.zeros_like(x)).reshape(score.shape)


def fast_corners(img: torch.Tensor, threshold: float,
                 nms: bool = True) -> torch.Tensor:
    s = fast_score(img, threshold)
    return nms3x3(s) if nms else s
