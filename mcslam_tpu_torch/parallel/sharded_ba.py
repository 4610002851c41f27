"""Window bundle adjustment sharded over a device mesh (counterpart of
mcslam_tpu/parallel/sharded_ba.py), on parallel/mesh's single-process
mesh.

- Observation-sharded (sharded_ba_solve): each shard linearizes and
  assembles the partial normal equations of its observations by the
  generic layout (backend/ba._residuals_and_jacobians, _assemble); the
  partial (Hpp, gp, Hll, gl, W) and costs are summed in shard order on
  the mesh's first device, where the small Schur solve and the LM
  decisions run once.
- Landmark-sharded (sharded_ba_solve_lm): shard d owns landmark slots
  [d * Ls, (d + 1) * Ls) and every observation of them
  (shard_by_landmark); it eliminates its own landmarks and updates them
  where they lie, and only the pose side is summed: Hpp, gp and the
  (K*6)^2 Schur share W Hll^-1 W^T with its right-hand side.
Both take backend/ba.lm_schedule's schedule (one linearization and one
sum per step, chi2 gate rounds), the elimination in float64 as
backend/ba's, and queue with no host synchronization.
"""

from __future__ import annotations

import numpy as np
import torch

from mcslam_tpu_torch.backend import ba
from mcslam_tpu_torch.geometry import lie
from mcslam_tpu_torch.parallel import mesh as mesh_mod

AXIS = "obs"


def make_mesh(n_devices: int | None = None, device="cuda") -> mesh_mod.Mesh:
    return mesh_mod.make_mesh(n_devices, device, AXIS)


def _problem(poses, landmarks, lm_valid, kf_valid, obs, cam_T_ref, fxycxy,
             dev) -> ba.BAProblem:
    """A zero-prior BAProblem of one shard on `dev`."""
    K6 = poses.shape[0] * 6
    z = torch.zeros
    return ba.BAProblem(
        poses=poses.to(dev), landmarks=landmarks.to(dev),
        lm_valid=lm_valid.to(dev), obs=obs, cam_T_ref=cam_T_ref.to(dev),
        fxycxy=fxycxy.to(dev), prior_H=z(K6, K6, device=dev),
        prior_b=z(K6, device=dev), kf_valid=kf_valid.to(dev))


def _local_normal_eqs(poses, landmarks, lm_valid, kf_valid, obs, cam_T_ref,
                      fxycxy, huber_px):
    """Partial (Hpp, gp, Hll, gl, W) of one observation shard, on the
    shard's device."""
    p = _problem(poses, landmarks, lm_valid, kf_valid, obs, cam_T_ref,
                 fxycxy, obs.kf.device)
    r, Jp, Jl, w = ba._residuals_and_jacobians(p, huber_px)
    return ba._assemble(p, r, Jp, Jl, w)


def _on_first(mesh, *arrays):
    """Each array as a float32 / bool tensor on the mesh's first device
    (bool stays bool)."""
    out = []
    for a in arrays:
        is_bool = (a.dtype == torch.bool if isinstance(a, torch.Tensor)
                   else np.asarray(a).dtype == bool)
        out.append(ba._field(a, torch.bool if is_bool else torch.float32,
                             mesh.first))
    return out


def _obs_on_first(mesh, obs) -> ba.BAObservations:
    return ba.BAObservations(**{n: ba._field(getattr(obs, n), dt, mesh.first)
                                for n, dt in ba._OBS_DTYPES.items()})


def shard_observations(mesh, obs) -> list:
    """The observation table split over the mesh: O padded with invalid
    rows to a multiple of the mesh size, then one BAObservations of
    O / size rows per shard, on its device."""
    o = _obs_on_first(mesh, obs)
    O = o.kf.shape[0]
    pad = -O % mesh.size
    if pad:
        o = ba.BAObservations(*(torch.cat([
            f, (torch.ones if n == "sigma2" else torch.zeros)(
                (pad, *f.shape[1:]), dtype=f.dtype, device=f.device)])
            for n, f in zip(ba.BAObservations._fields, o)))
    per_field = [mesh.shard(f) for f in o]
    return [ba.BAObservations(*fields) for fields in zip(*per_field)]


def _obs_system(mesh, poses, landmarks, lm_valid, kf_valid, shards,
                cam_T_ref, fxycxy, prior_H, prior_b, huber_px):
    """system(state, obs_valid list) of the observation-sharded solve:
    each shard's generic system on its device, the partial systems and
    costs summed on the first device, the priors added there."""
    systems = [ba._generic_system(_problem(
        poses, landmarks, lm_valid, kf_valid, o, cam_T_ref, fxycxy, d),
        huber_px) for o, d in zip(shards, mesh.devices)]

    def system(state, obs_valid):
        poses, lms = state
        parts, costs, rs = zip(*[
            s((poses.to(d, non_blocking=True), lms.to(d, non_blocking=True)),
              v) for s, d, v in zip(systems, mesh.devices, obs_valid)])
        Hpp, gp, Hll, gl, Wc = (mesh.psum(list(f)) for f in zip(*parts))
        return ((Hpp + prior_H, gp + prior_b, Hll, gl, Wc),
                mesh.psum(list(costs)), list(rs))

    return system


def _as_shards(mesh, obs) -> list:
    return obs if isinstance(obs, list) else shard_observations(mesh, obs)


def sharded_lm_step(mesh, poses, landmarks, lm_valid, kf_valid, obs,
                    cam_T_ref, fxycxy, prior_H, prior_b, lam: float = 1e-3,
                    huber_px: float = 2.5):
    """One damped Schur LM step with observation-sharded assembly; `obs`
    a BAObservations or shard_observations' list. -> (new_poses,
    new_landmarks) on the mesh's first device."""
    (poses, landmarks, lm_valid, kf_valid, cam_T_ref, fxycxy, prior_H,
     prior_b) = _on_first(mesh, poses, landmarks, lm_valid, kf_valid,
                          cam_T_ref, fxycxy, prior_H, prior_b)
    parts = [_local_normal_eqs(poses, landmarks, lm_valid, kf_valid, o,
                               cam_T_ref, fxycxy, huber_px)
             for o in _as_shards(mesh, obs)]
    Hpp, gp, Hll, gl, Wc = (mesh.psum(list(f)) for f in zip(*parts))
    dp, dl = ba._schur_solve(Hpp + prior_H, gp + prior_b, Hll, gl, Wc,
                             torch.full((), lam, device=mesh.first),
                             lm_valid)
    return (lie.se3_retract(poses, dp.reshape(-1, 6)), landmarks + dl)


def sharded_ba_solve(mesh, poses, landmarks, lm_valid, kf_valid, obs,
                     cam_T_ref, fxycxy, prior_H, prior_b, iters: int = 10,
                     huber_px: float = 2.5, init_lambda: float = 1e-4,
                     chi2_thresh: float = 5.991, gate_rounds: int = 2):
    """The observation-sharded LM solve with ba.ba_solve's semantics
    (accept / reject damping per step, chi2 gate rounds): one
    linearization per shard and one sum of the partial systems per step,
    the Schur solve and the decisions once on the first device. `obs` a
    BAObservations (any layout) or shard_observations' list.

    -> (poses, landmarks, obs_inliers (the shards' masks concatenated,
    padding included), cost, num_inliers), all on the mesh's first
    device, in ba.BAResult's field order."""
    (poses, landmarks, lm_valid, kf_valid, cam_T_ref, fxycxy, prior_H,
     prior_b) = _on_first(mesh, poses, landmarks, lm_valid, kf_valid,
                          cam_T_ref, fxycxy, prior_H, prior_b)
    K = poses.shape[0]
    shards = _as_shards(mesh, obs)
    system = _obs_system(mesh, poses, landmarks, lm_valid, kf_valid, shards,
                         cam_T_ref, fxycxy, prior_H, prior_b, huber_px)
    gates = [ba.chi2_gate(o, chi2_thresh) for o in shards]

    def gate(rs):
        return [g(r) for g, r in zip(gates, rs)]

    def step(sys_, lam, state):
        dp, dl = ba._schur_solve(*sys_, lam, lm_valid)
        return (lie.se3_retract(state[0], dp.reshape(K, 6)), state[1] + dl)

    (poses, lms), _, cost, rs = ba.lm_schedule(
        system, step, (poses, landmarks), [o.valid for o in shards], gate,
        iters, gate_rounds, init_lambda)
    inliers = gate(rs)
    return (poses, lms, mesh.all_gather(inliers), cost,
            mesh.psum([torch.sum(v).to(torch.int32) for v in inliers]))


def shard_by_landmark(obs, L: int, n_dev: int, pad_multiple: int = 256):
    """Regroup an observation table by landmark shard for
    sharded_ba_solve_lm: shard d owns landmark slots [d * Ls, (d + 1) *
    Ls) and every valid observation of them. Host-side preparation, once
    per solve (reads the table to the host).

    -> BAObservations of numpy arrays whose rows are contiguous per shard,
    each group padded with invalid rows to the same multiple of
    `pad_multiple` (total length divisible by n_dev)."""
    def host(a):
        return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                else np.asarray(a))

    Ls = L // n_dev
    lm, valid = host(obs.lm), host(obs.valid).astype(bool)
    dev = np.clip(lm // Ls, 0, n_dev - 1)
    groups = [np.nonzero((dev == d) & valid)[0] for d in range(n_dev)]
    per = max(max((len(g) for g in groups), default=1), 1)
    per = -(-per // pad_multiple) * pad_multiple
    idx = np.zeros(per * n_dev, np.int64)
    out_valid = np.zeros(per * n_dev, bool)
    for d, g in enumerate(groups):
        idx[d * per:d * per + len(g)] = g
        out_valid[d * per:d * per + len(g)] = True
    return ba.BAObservations(
        kf=host(obs.kf)[idx], cam=host(obs.cam)[idx], lm=lm[idx],
        uv=host(obs.uv)[idx], sigma2=host(obs.sigma2)[idx], valid=out_valid)


def sharded_ba_solve_lm(mesh, poses, landmarks, lm_valid, kf_valid, obs,
                        cam_T_ref, fxycxy, prior_H, prior_b, iters: int = 10,
                        huber_px: float = 2.5, init_lambda: float = 1e-4,
                        chi2_thresh: float = 5.991, gate_rounds: int = 2):
    """The landmark-sharded LM solve: the map and its observations
    (grouped by shard_by_landmark; L divisible by the mesh size) are
    partitioned over the mesh; each shard eliminates its own landmark
    blocks and updates its landmarks with no communication. The sums per
    step are the pose side's: Hpp, gp, the cost and each shard's Schur
    share (K*6)^2 and its right-hand side, a size independent of the map.
    Same schedule as ba.ba_solve.

    -> (poses, landmarks (L, 3), obs_inliers (grouped order), cost,
    num_inliers), all on the mesh's first device."""
    (poses, landmarks, lm_valid, kf_valid, cam_T_ref, fxycxy, prior_H,
     prior_b) = _on_first(mesh, poses, landmarks, lm_valid, kf_valid,
                          cam_T_ref, fxycxy, prior_H, prior_b)
    K, L = poses.shape[0], landmarks.shape[0]
    Ls = L // mesh.size
    devs = mesh.devices
    per_field = [mesh.shard(f) for f in _obs_on_first(mesh, obs)]
    shards = []
    for d, fields in enumerate(zip(*per_field)):
        o = ba.BAObservations(*fields)
        # global -> local landmark slots
        shards.append(o._replace(lm=torch.clamp(o.lm - d * Ls, 0, Ls - 1)))
    lmv = mesh.shard(lm_valid)
    systems = [ba._generic_system(_problem(
        poses, lm_s, lmv_s, kf_valid, o, cam_T_ref, fxycxy, d), huber_px)
        for o, d, lm_s, lmv_s in zip(shards, devs, mesh.shard(landmarks),
                                     lmv)]
    gates = [ba.chi2_gate(o, chi2_thresh) for o in shards]

    def system(state, obs_valid):
        poses, lms = state
        parts, costs, rs = zip(*[
            s((poses.to(d, non_blocking=True), lm_s), v)
            for s, d, lm_s, v in zip(systems, devs, lms, obs_valid)])
        Hpp, gp, Hll, gl, Wc = (list(f) for f in zip(*parts))
        # the pose side is global: sum it; the landmark side stays local
        return ((mesh.psum(Hpp) + prior_H, mesh.psum(gp) + prior_b, Hll, gl,
                 Wc), mesh.psum(list(costs)), list(rs))

    def step(sys_, lam, state):
        Hpp, gp, Hll, gl, Wc = sys_
        lam = lam.to(torch.float64)
        terms = [ba._schur_terms(Hll[s], gl[s], Wc[s],
                                 lam.to(d, non_blocking=True))
                 for s, d in enumerate(devs)]
        dp = ba._solve_reduced(Hpp, gp, mesh.psum([t[2] for t in terms]),
                               mesh.psum([t[3] for t in terms]), lam)
        lms = [lm_s + ba._back_substitute(
            t[0], t[1], gl[s], dp.to(d, non_blocking=True),
            lmv[s]).to(torch.float32)
            for s, (t, d, lm_s) in enumerate(zip(terms, devs, state[1]))]
        return (lie.se3_retract(state[0], dp.to(torch.float32).reshape(K, 6)),
                lms)

    def gate(rs):
        return [g(r) for g, r in zip(gates, rs)]

    (poses, lms), _, cost, rs = ba.lm_schedule(
        system, step, (poses, mesh.shard(landmarks)),
        [o.valid for o in shards], gate, iters, gate_rounds, init_lambda)
    inliers = gate(rs)
    return (poses, mesh.all_gather(lms), mesh.all_gather(inliers), cost,
            mesh.psum([torch.sum(v).to(torch.int32) for v in inliers]))
