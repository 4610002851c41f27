"""Grid-balanced keypoint selection from dense score maps (counterpart of
select_keypoints in mcslam_tpu/ops/topk_grid.py), always exact.

Every top-k here is a STABLE descending sort: among equal values the
lowest index comes first, which is jax.lax.top_k's tie rule (torch.topk
promises no tie order on CUDA, and tie drift on score plateaus changes
which keypoints a frame keeps).
"""

from __future__ import annotations

import torch


def topk_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dim, ties to the
    lowest index — jax.lax.top_k semantics."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_keypoints(score: torch.Tensor, num_points: int, cell: int = 16,
                     per_cell: int = 4):
    """score (H, W) dense NMS'd score map -> (yx (N, 2) int32, resp (N,),
    valid (N,)), N = num_points; invalid slots have resp 0 and yx (0, 0).
    Per cell: per_cell rounds of (max, first argmax, knock out); then the
    global top-N over the (cell raster-major, round-minor) candidates."""
    h, w = score.shape
    gh, gw = -(-h // cell), -(-w // cell)
    padded = torch.nn.functional.pad(score, (0, gw * cell - w, 0, gh * cell - h))
    cells = padded.reshape(gh, cell, gw, cell).permute(0, 2, 1, 3)
    cells = cells.reshape(gh * gw, cell * cell).clone()
    k = min(per_cell, cell * cell)
    rv, ra = [], []
    rows = torch.arange(cells.shape[0], device=score.device)
    for _ in range(k):
        a = torch.argmax(cells, dim=1)
        rv.append(cells[rows, a])
        ra.append(a)
        cells[rows, a] = float("-inf")
    cell_resp = torch.stack(rv, dim=1)
    cell_arg = torch.stack(ra, dim=1)
    g = torch.arange(gh * gw, device=score.device)[:, None]
    ys = (g // gw) * cell + cell_arg // cell
    xs = (g % gw) * cell + cell_arg % cell
    flat_resp = cell_resp.reshape(-1)
    n = min(num_points, flat_resp.shape[0])
    top_resp, top_arg = topk_stable(flat_resp, n)
    yx = torch.stack([ys.reshape(-1)[top_arg], xs.reshape(-1)[top_arg]], -1)
    valid = top_resp > 0.0
    yx = torch.where(valid[:, None], yx, torch.zeros_like(yx))
    if n < num_points:
        pad = num_points - n
        yx = torch.nn.functional.pad(yx, (0, 0, 0, pad))
        top_resp = torch.nn.functional.pad(top_resp, (0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
    return yx.to(torch.int32), top_resp, valid
