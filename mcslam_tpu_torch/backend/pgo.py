"""Pose-graph optimization: Gauss-Newton over SE(3) (or Sim(3)) keyframe
poses with odometry and loop-closure edges (counterpart of
mcslam_tpu/backend/pgo.py).

All edges are one padded table; the residual of edge (i, j) is
log(meas^-1 Ti^-1 Tj) (the Sim(3) form adds the scale residual and
de-scales the translation by s_i). The edge Jacobians on both endpoint
tangents come from torch.func.jacfwd under vmap in float64 (float32
jacfwd mis-types the tangents of ops with a Python scalar, e.g. so3_exp's
t2 / 6.0). The dense (N*D)^2 normal system is assembled in a fixed order
instead of JAX's scatter-add: each edge's Jacobian is placed into the N*D
columns by 0/1 selection matrices built on the device from the edge
indices, and H = J^T W J, g = J^T W r are single matrix products (no
atomics). The solve, like the whole iteration, runs in float64 (JAX:
float32) against the 1e6 anchor prior; the poses come back in their input
dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mcslam_tpu_torch.geometry import lie


class PoseGraph(NamedTuple):
    poses: torch.Tensor  # (N, 4, 4) initial world_T_kf
    edge_i: torch.Tensor  # (E,) int
    edge_j: torch.Tensor  # (E,) int
    edge_meas: torch.Tensor  # (E, 4, 4) measured i_T_j
    edge_weight: torch.Tensor  # (E,) scalar information scale
    edge_valid: torch.Tensor  # (E,) bool
    anchor: torch.Tensor | int  # pose index held fixed


def _edge_residual(xi_i, xi_j, Ti, Tj, meas):
    Ti = lie.se3_retract(Ti, xi_i)
    Tj = lie.se3_retract(Tj, xi_j)
    return lie.se3_log(lie.se3_inverse(meas) @ lie.se3_inverse(Ti) @ Tj)


def _sim3_edge_residual(xi_i, xi_j, Ti, si, Tj, sj, meas, s_meas):
    """7-dim Sim(3) edge residual [r_R(3), r_t(3), r_s(1)]; xi =
    (omega(3), dt(3), dlogs(1)). The translation residual is measured in
    frame i and de-scaled by s_i, so accumulated monocular scale drift is
    absorbed along the chain."""
    Ri = Ti[:3, :3] @ lie.so3_exp(xi_i[:3])
    ti = Ti[:3, 3] + Ti[:3, :3] @ xi_i[3:6]
    si = si * torch.exp(xi_i[6])
    Rj = Tj[:3, :3] @ lie.so3_exp(xi_j[:3])
    tj = Tj[:3, 3] + Tj[:3, :3] @ xi_j[3:6]
    sj = sj * torch.exp(xi_j[6])
    r_R = lie.so3_log(meas[:3, :3].T @ (Ri.T @ Rj))
    r_t = (Ri.T @ (tj - ti)) / si - meas[:3, 3] / s_meas
    r_s = torch.log(sj / si) - torch.log(s_meas)
    return torch.cat([r_R, r_t, r_s[None]])


def _linearize(fn, D, *edge_args):
    """Residuals (E, D) and endpoint Jacobians (E, D, 2D) of every edge at
    the zero tangent, by jacfwd under vmap (the arguments are float64)."""
    def f(x, *a):
        r = fn(x[:D], x[D:], *a)
        return r, r

    E = edge_args[0].shape[0]
    z = torch.zeros(E, 2 * D, dtype=torch.float64,
                    device=edge_args[0].device)
    J, r = torch.func.vmap(torch.func.jacfwd(f, has_aux=True))(z, *edge_args)
    return r, J


def _gn_step(graph: PoseGraph, r, J, D, damping):
    """The damped Gauss-Newton step dx (N, D), float64."""
    N = graph.poses.shape[0]
    E = r.shape[0]
    dev = r.device
    f64 = torch.float64
    ar = torch.arange(N, device=dev)
    Si = (graph.edge_i.long()[:, None] == ar[None]).to(f64)  # (E, N)
    Sj = (graph.edge_j.long()[:, None] == ar[None]).to(f64)
    Jf = (torch.einsum("ea,erc->erac", Si, J[..., :D])
          + torch.einsum("ea,erc->erac", Sj, J[..., D:])).reshape(E * D,
                                                                  N * D)
    w = (graph.edge_weight.to(f64) * graph.edge_valid.to(f64))
    Jw = Jf * w.repeat_interleave(D)[:, None]
    H = Jw.T @ Jf
    g = Jw.T @ r.reshape(E * D)
    # anchor: a 1e6 prior on the anchored pose
    anchor = torch.as_tensor(graph.anchor, device=dev)
    blk = torch.arange(N * D, device=dev) // D
    H = H + torch.diag((blk == anchor).to(f64) * 1e6)
    H = H + damping * torch.eye(N * D, dtype=f64, device=dev)
    return -torch.linalg.solve_ex(H, g)[0].reshape(N, D)


def pgo_solve(graph: PoseGraph, iters: int = 10,
              damping: float = 1e-6) -> torch.Tensor:
    """SE(3) pose-graph Gauss-Newton -> optimized poses (N, 4, 4)."""
    f64 = torch.float64
    poses = graph.poses.to(f64)
    meas = graph.edge_meas.to(f64)
    ei, ej = graph.edge_i.long(), graph.edge_j.long()
    for _ in range(iters):
        r, J = _linearize(_edge_residual, 6, poses[ei], poses[ej], meas)
        dx = _gn_step(graph, r, J, 6, damping)
        poses = lie.se3_retract(poses, dx)
    return poses.to(graph.poses.dtype)


def pgo_solve_sim3(graph: PoseGraph, scales: torch.Tensor | None = None,
                   edge_scales: torch.Tensor | None = None, iters: int = 10,
                   damping: float = 1e-6):
    """Sim(3) pose-graph Gauss-Newton: corrects monocular scale drift at
    loop closure -> (poses (N, 4, 4), scales (N,))."""
    f64 = torch.float64
    N = graph.poses.shape[0]
    dev = graph.poses.device
    poses = graph.poses.to(f64)
    scales = (torch.ones(N, dtype=f64, device=dev) if scales is None
              else scales.to(f64))
    edge_scales = (torch.ones(graph.edge_i.shape[0], dtype=f64, device=dev)
                   if edge_scales is None else edge_scales.to(f64))
    meas = graph.edge_meas.to(f64)
    ei, ej = graph.edge_i.long(), graph.edge_j.long()
    for _ in range(iters):
        r, J = _linearize(_sim3_edge_residual, 7, poses[ei], scales[ei],
                          poses[ej], scales[ej], meas, edge_scales)
        dx = _gn_step(graph, r, J, 7, damping)
        R = poses[:, :3, :3] @ lie.so3_exp(dx[:, :3])
        t = poses[:, :3, 3] + torch.einsum("nij,nj->ni", poses[:, :3, :3],
                                           dx[:, 3:6])
        poses = lie.se3_matrix(R, t)
        scales = scales * torch.exp(dx[:, 6])
    dt = graph.poses.dtype
    return poses.to(dt), scales.to(dt)


def build_odometry_edges(poses: torch.Tensor, weights=None):
    """Sequential odometry edges from current estimates: meas = Ti^-1 Tj
    -> (i, j, meas, w)."""
    N = poses.shape[0]
    i = torch.arange(N - 1, dtype=torch.int32, device=poses.device)
    meas = lie.se3_inverse(poses[:-1]) @ poses[1:]
    w = (torch.ones(N - 1, dtype=torch.float32, device=poses.device)
         if weights is None else weights)
    return i, i + 1, meas, w
