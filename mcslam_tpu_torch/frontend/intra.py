"""Cross-camera intra-matching: group the rig's features that observe the
same 3D point (counterpart of mcslam_tpu/frontend/intra.py).

All C(C-1)/2 camera pairs get a Sampson-gated mutual-best Hamming match
in one batch; chains are merged by pointer jumping on a (C, N) parent
table (lowest camera wins); groups are compacted to max_out slots by a
stable priority sort (more rays first, then response).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mcslam_tpu_torch.geometry import lie
from mcslam_tpu_torch.ops import hamming, match
from mcslam_tpu_torch.ops.topk_grid import topk_stable
from mcslam_tpu_torch.utils import graphs


class IntraGroups(NamedTuple):
    ray_idx: torch.Tensor  # (M, C) int32 keypoint index per camera, -1 = none
    desc: torch.Tensor  # (M, 8) int32 representative descriptor
    valid: torch.Tensor  # (M,) bool


def pair_essential(rig, i: int, j: int) -> torch.Tensor:
    """Essential matrix E_ij with x_i^T E x_j = 0 (normalized coords)."""
    T_ij = rig.cam_T_ref[i] @ lie.se3_inverse(rig.cam_T_ref)[j]
    return lie.so3_hat(T_ij[:3, 3]) @ T_ij[:3, :3]


def sampson_gate(xn_i: torch.Tensor, xn_j: torch.Tensor, E: torch.Tensor,
                 thresh) -> torch.Tensor:
    """(..., Ni, 2) x (..., Nj, 2) normalized coords -> (..., Ni, Nj) bool
    Sampson-distance gate under E (..., 3, 3)."""
    hi = torch.cat([xn_i, torch.ones_like(xn_i[..., :1])], dim=-1)
    hj = torch.cat([xn_j, torch.ones_like(xn_j[..., :1])], dim=-1)
    Exj = hj @ E.transpose(-1, -2)
    Ethi = hi @ E
    num = (hi @ Exj.transpose(-1, -2)) ** 2
    den = (Exj[..., None, :, 0] ** 2 + Exj[..., None, :, 1] ** 2
           + Ethi[..., :, None, 0] ** 2 + Ethi[..., :, None, 1] ** 2)
    return num / torch.clamp(den, min=1e-12) < thresh**2


def intra_match(desc: torch.Tensor, xy_ud: torch.Tensor, valid: torch.Tensor,
                response: torch.Tensor, rig, max_out: int = 2048,
                max_dist: int = 60, ratio: float = 0.85,
                sampson_px: float = 3.0) -> IntraGroups:
    C, N = desc.shape[:2]
    dev = desc.device
    f = rig.fxycxy[:, None, :]
    xn = (xy_ud - f[..., 2:]) / f[..., :2]
    thr_n = sampson_px / torch.mean(rig.fxycxy[:, 0])
    planes = hamming.to_planes(desc.reshape(C * N, 8)).reshape(C, N, -1)
    flat_self = torch.arange(C * N, dtype=torch.int32, device=dev).reshape(C, N)

    pair_i = [i for i in range(C - 1) for _ in range(i + 1, C)]
    pair_j = [j for i in range(C - 1) for j in range(i + 1, C)]
    if pair_i:
        E_all = torch.stack([pair_essential(rig, i, j)
                             for i, j in zip(pair_i, pair_j)])
        # camera pairs by index tensors made once per device (a Python
        # list index is a host upload)
        pi = graphs.values(tuple(pair_i), torch.int64, dev)
        pj = graphs.values(tuple(pair_j), torch.int64, dev)
        d = hamming.hamming_from_planes(planes.index_select(0, pi),
                                        planes.index_select(0, pj))
        gate = sampson_gate(xn.index_select(0, pi), xn.index_select(0, pj),
                            E_all, thr_n)
        cands = []
        for p, (i, j) in enumerate(zip(pair_i, pair_j)):
            res = match.match_mutual(
                d[p], row_mask=valid[i], col_mask=valid[j],
                max_dist=max_dist, ratio=ratio, pair_mask=gate[p],
            )
            # cam-j feature -> flat index of its matched cam-i feature;
            # mutual-best makes it 1-1 (lowest row on duplicates)
            eq = res.ok[:, None] & (
                res.idx[:, None] == torch.arange(N, device=dev)[None, :])
            row = torch.argmax(eq.to(torch.uint8), dim=0)
            cands.append(torch.where(
                torch.any(eq, dim=0), flat_self[i][row],
                torch.full_like(flat_self[i], C * N)))
        rows = [flat_self[0]]
        for j in range(1, C):
            sel = [p for p in range(len(pair_i)) if pair_j[p] == j]
            best = cands[sel[0]]
            for p in sel[1:]:
                best = torch.minimum(best, cands[p])
            rows.append(torch.where(best < flat_self[j], best, flat_self[j]))
        parent = torch.stack(rows)
    else:
        parent = flat_self

    flat_parent = parent.reshape(C * N).long()
    for _ in range(3):  # 2^3 = 8 >= C hops
        flat_parent = flat_parent[flat_parent]
    flat_valid = valid.reshape(C * N)
    is_root = (flat_parent == torch.arange(C * N, device=dev)) & flat_valid

    # per camera: does it contribute a ray to root r, and with which
    # feature (the largest index on duplicates)
    parent_cn = flat_parent.reshape(C, N)
    feat = torch.arange(N, device=dev)[None, :].expand(C, N)
    ray_of_root = torch.full((C, C * N), -1, dtype=torch.int64, device=dev)
    ray_of_root = ray_of_root.scatter_reduce(
        1, parent_cn, torch.where(valid, feat, -1), reduce="amax")
    n_rays = torch.sum(ray_of_root >= 0, dim=0)

    priority = torch.where(
        is_root, n_rays.to(torch.float32) * 1e3 + response.reshape(C * N),
        torch.full((C * N,), -1.0, device=dev))
    k = min(max_out, C * N)
    top_p, top_i = topk_stable(priority, k)
    out_valid = top_p > 0.0
    table = ray_of_root[:, top_i].T.to(torch.int32)  # (k, C)
    ray_idx = torch.where(out_valid[:, None], table, torch.full_like(table, -1))
    out_desc = desc.reshape(C * N, 8)[top_i]
    if k < max_out:
        pad = max_out - k
        ray_idx = torch.cat([ray_idx, torch.full(
            (pad, C), -1, dtype=torch.int32, device=dev)])
        out_desc = torch.cat([out_desc, torch.zeros(
            pad, 8, dtype=out_desc.dtype, device=dev)])
        out_valid = torch.cat([out_valid, torch.zeros(
            pad, dtype=torch.bool, device=dev)])
    return IntraGroups(ray_idx=ray_idx, desc=out_desc, valid=out_valid)
