"""Cross-camera intra-matching: group the rig's features that observe the
same 3D point (counterpart of mcslam_tpu/frontend/intra.py).

All C(C-1)/2 camera pairs get a Sampson-gated mutual-best Hamming match
and their matches make a (C, N) parent table (lowest camera wins); chains
are merged by pointer jumping on the parent table; groups are compacted
to max_out slots by a stable priority sort (more rays first, then
response). On the card that is three kernel launches
(frontend/intra_cuda: intra_gate, intra_pairs, intra_groups); the pairs'
essential matrices and the gate's threshold are rig constants, made once
per rig (pair_constants).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mcslam_tpu_torch.frontend import intra_cuda
from mcslam_tpu_torch.geometry import lie
from mcslam_tpu_torch.utils import graphs


class IntraGroups(NamedTuple):
    ray_idx: torch.Tensor  # (M, C) int32 keypoint index per camera, -1 = none
    desc: torch.Tensor  # (M, 8) int32 representative descriptor
    valid: torch.Tensor  # (M,) bool


def pair_essential(rig, i: int, j: int) -> torch.Tensor:
    """Essential matrix E_ij with x_i^T E x_j = 0 (normalized coords)."""
    T_ij = rig.cam_T_ref[i] @ lie.se3_inverse(rig.cam_T_ref)[j]
    return lie.so3_hat(T_ij[:3, 3]) @ T_ij[:3, :3]


class PairConstants(NamedTuple):
    E: torch.Tensor  # (P, 3, 3) pair_essential of intra_cuda.camera_pairs(C)
    thr2: torch.Tensor  # 0-d squared Sampson threshold in normalized units


def pair_constants(rig, sampson_px: float = 3.0) -> PairConstants:
    """The rig's camera-pair constants of the intra match (C >= 2): the
    pairs' essential matrices and the squared threshold (sampson_px /
    mean fx)^2, made on the rig's device once per rig: graphs.derived on
    its intrinsics and extrinsics (another rig, or an in-place edit of
    either, makes them again). Never made under a capture: the warm-up
    makes them."""
    def make():
        pair_i, pair_j = intra_cuda.camera_pairs(rig.num_cams)
        E = torch.stack([pair_essential(rig, i, j)
                         for i, j in zip(pair_i, pair_j)])
        thr_n = sampson_px / torch.mean(rig.fxycxy[:, 0])
        return PairConstants(E, thr_n * thr_n)

    return graphs.derived(("intra_pairs", float(sampson_px)),
                          (rig.fxycxy, rig.cam_T_ref), make)


def sampson_gate(xn_i: torch.Tensor, xn_j: torch.Tensor, E: torch.Tensor,
                 thresh) -> torch.Tensor:
    """(..., Ni, 2) x (..., Nj, 2) normalized coords -> (..., Ni, Nj) bool
    Sampson-distance gate under E (..., 3, 3) below thresh, in the gate
    kernel's order (intra_cuda.sampson_gate_sq)."""
    return intra_cuda.sampson_gate_sq(xn_i, xn_j, E, thresh * thresh)


def intra_match(desc: torch.Tensor, xy_ud: torch.Tensor, valid: torch.Tensor,
                response: torch.Tensor, rig, max_out: int = 2048,
                max_dist: int = 60, ratio: float = 0.85,
                sampson_px: float = 3.0) -> IntraGroups:
    C, N = desc.shape[:2]
    if C > 1:
        pc = pair_constants(rig, sampson_px)
        gate = intra_cuda.intra_gate(xy_ud, rig.fxycxy, pc.E, pc.thr2)
        parent = intra_cuda.intra_pairs(desc, valid, gate, max_dist, ratio)
    else:
        parent = torch.arange(C * N, dtype=torch.int32,
                              device=desc.device).reshape(C, N)
    return IntraGroups(*intra_cuda.intra_groups(parent, valid, response,
                                                desc, max_out))
