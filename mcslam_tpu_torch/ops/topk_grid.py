"""Grid-balanced keypoint selection from dense score maps (counterpart of
select_keypoints and select_keypoints_subcell in
mcslam_tpu/ops/topk_grid.py), always exact and batched over any leading
axes of the score map.

Every top-k here is a STABLE descending sort: among equal values the
lowest index comes first, which is jax.lax.top_k's tie rule (torch.topk
promises no tie order on CUDA, and tie drift on score plateaus changes
which keypoints a frame keeps).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from mcslam_tpu_torch.utils import graphs


def topk_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dim, ties to the
    lowest index — jax.lax.top_k semantics."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _global_top(flat_resp, flat_ys, flat_xs, num_points: int, lead):
    """Global top-num_points of (B, K) candidates -> (yx (*lead, N, 2)
    int32, resp (*lead, N), valid (*lead, N)); invalid slots have resp 0
    and yx (0, 0)."""
    n = min(num_points, flat_resp.shape[1])
    top_resp, top_arg = topk_stable(flat_resp, n)
    yx = torch.stack([torch.gather(flat_ys, 1, top_arg),
                      torch.gather(flat_xs, 1, top_arg)], -1)
    valid = top_resp > 0.0
    yx = torch.where(valid[..., None], yx, torch.zeros_like(yx))
    if n < num_points:
        pad = num_points - n
        yx = F.pad(yx, (0, 0, 0, pad))
        top_resp = F.pad(top_resp, (0, pad))
        valid = F.pad(valid, (0, pad))
    return (yx.to(torch.int32).reshape(*lead, num_points, 2),
            top_resp.reshape(*lead, num_points),
            valid.reshape(*lead, num_points))


def select_keypoints(score: torch.Tensor, num_points: int, cell: int = 16,
                     per_cell: int = 4):
    """score (..., H, W) dense NMS'd score maps -> (yx (..., N, 2) int32,
    resp (..., N), valid (..., N)), N = num_points; invalid slots have
    resp 0 and yx (0, 0). Per cell: per_cell rounds of (max, first argmax,
    knock out); then the global top-N over the (cell raster-major,
    round-minor) candidates of each map."""
    *lead, h, w = score.shape
    B = math.prod(lead)
    gh, gw = -(-h // cell), -(-w // cell)
    padded = F.pad(score.reshape(B, h, w), (0, gw * cell - w, 0, gh * cell - h))
    cells = padded.reshape(B, gh, cell, gw, cell).permute(0, 1, 3, 2, 4)
    cells = cells.reshape(B, gh * gw, cell * cell).clone()
    rv, ra = [], []
    for _ in range(min(per_cell, cell * cell)):
        a = torch.argmax(cells, dim=-1, keepdim=True)
        rv.append(torch.gather(cells, -1, a)[..., 0])
        ra.append(a[..., 0])
        cells.scatter_(-1, a, float("-inf"))
    cell_arg = torch.stack(ra, dim=-1)  # (B, G, k)
    g = torch.arange(gh * gw, device=score.device)[:, None]
    ys = (g // gw) * cell + cell_arg // cell
    xs = (g % gw) * cell + cell_arg % cell
    return _global_top(torch.stack(rv, dim=-1).reshape(B, -1),
                       ys.reshape(B, -1), xs.reshape(B, -1), num_points, lead)


def select_keypoints_subcell(score: torch.Tensor, num_points: int,
                             sub: int = 8, per_sub: int = 2):
    """Subcell-max variant: per_sub candidates per sub x sub subcell
    (max, first raster-order argmax, knock out), then the same global
    top-N over the (subcell raster-major, round-minor) candidates.
    score (..., H, W) -> (yx, resp, valid) as select_keypoints."""
    *lead, h, w = score.shape
    B = math.prod(lead)
    gh, gw = -(-h // sub), -(-w // sub)
    padded = F.pad(score.reshape(B, h, w), (0, gw * sub - w, 0, gh * sub - h))
    cells = padded.reshape(B, gh, sub, gw, sub).permute(0, 1, 3, 2, 4)
    cells = cells.reshape(B, gh, gw, sub * sub)
    dev = score.device
    rid = torch.arange(sub * sub, device=dev)  # raster offset in the cell
    big = graphs.values(sub * sub, torch.int64, dev)
    gy = torch.arange(gh, device=dev)[:, None] * sub
    gx = torch.arange(gw, device=dev)[None, :] * sub
    resp_r, ys_r, xs_r = [], [], []
    for _ in range(per_sub):
        m = torch.amax(cells, dim=-1)  # (B, gh, gw)
        hit = cells == m[..., None]
        amin = torch.amin(torch.where(hit, rid, big), dim=-1)
        amin = torch.clamp(amin, max=sub * sub - 1)  # empty cell -> masked
        resp_r.append(m)
        ys_r.append(gy + amin // sub)
        xs_r.append(gx + amin % sub)
        cells = torch.where(rid == amin[..., None],
                            torch.full_like(cells, float("-inf")), cells)
    return _global_top(torch.stack(resp_r, -1).reshape(B, -1),
                       torch.stack(ys_r, -1).reshape(B, -1),
                       torch.stack(xs_r, -1).reshape(B, -1), num_points,
                       lead)
