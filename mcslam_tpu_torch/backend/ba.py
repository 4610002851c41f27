"""Sliding-window bundle adjustment: Levenberg-Marquardt with a dense Schur
complement over a keyframe-blocked observation table (counterpart of
mcslam_tpu/backend/ba.py, its kf_blocked=True path).

The window is a fixed-size state: K keyframe poses, L landmark slots and
O = K * Ok observation slots, padded and masked, with observation o
belonging to keyframe o // Ok. Every LM iteration linearizes all
observations in one launch of the `ba_linearize` kernel (ops/ba_cuda;
its plain version on the CPU), reduces the 30-channel payload against the
landmark one-hot in one batched f32 product, eliminates the landmarks
with closed-form 3x3 inverses and solves the (K*6)^2 Schur system with
`torch.linalg.solve_ex`, the elimination in float64 (see _eliminate).

The solve queues on the current stream without the host waiting: no
`.item()`, no host branch on a tensor and no host<->device copy inside
`ba_solve`, so a driver can dispatch it and land it a frame later.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mcslam_tpu_torch.geometry import lie, linalg3
from mcslam_tpu_torch.ops import ba_cuda


class BAObservations(NamedTuple):
    """Padded observation table (O slots)."""

    kf: torch.Tensor  # (O,) int32 window frame index
    cam: torch.Tensor  # (O,) int32 rig camera index
    lm: torch.Tensor  # (O,) int32 landmark slot index
    uv: torch.Tensor  # (O, 2) undistorted pixels
    sigma2: torch.Tensor  # (O,) measurement variance scale (octave^2)
    valid: torch.Tensor  # (O,) bool


class BAProblem(NamedTuple):
    poses: torch.Tensor  # (K, 4, 4) world_T_ref per keyframe
    landmarks: torch.Tensor  # (L, 3)
    lm_valid: torch.Tensor  # (L,) bool
    obs: BAObservations
    cam_T_ref: torch.Tensor  # (C, 4, 4) rig extrinsics
    fxycxy: torch.Tensor  # (C, 4)
    # dense prior on the pose tangent (gauge + marginalization), cost
    # 0.5 xi^T H0 xi + b0^T xi with xi stacked (K*6,)
    prior_H: torch.Tensor  # (K*6, K*6)
    prior_b: torch.Tensor  # (K*6,)
    kf_valid: torch.Tensor  # (K,) bool


class BAResult(NamedTuple):
    poses: torch.Tensor
    landmarks: torch.Tensor
    obs_inliers: torch.Tensor  # (O,) bool chi2 gate at the solution
    cost: torch.Tensor
    num_inliers: torch.Tensor
    # pose-side marginal information at the solution (landmarks
    # eliminated): the source of the fixed-lag prior of the next window
    marginal_H: torch.Tensor  # (K*6, K*6)


_OBS_DTYPES = dict(kf=torch.int32, cam=torch.int32, lm=torch.int32,
                   uv=torch.float32, sigma2=torch.float32, valid=torch.bool)


def _field(x, dtype, device) -> torch.Tensor:
    """x as a `dtype` tensor on `device`. A host array reaches a CUDA
    device from pinned memory by a non-blocking copy, so building a
    problem does not wait for the work queued on the stream (the driver
    dispatches its deferred solves without a host sync)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    t = torch.from_numpy(np.array(x)).to(dtype)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def problem_from_numpy(poses, landmarks, lm_valid, obs, cam_T_ref, fxycxy,
                       prior_H, prior_b, kf_valid, device="cuda") -> BAProblem:
    """A BAProblem on `device` from arrays of the same fields (numpy, or
    anything np.asarray takes, e.g. the fields of a JAX BAProblem; tensors
    are moved). `obs` is any object with the BAObservations fields."""
    f32 = torch.float32
    return BAProblem(
        poses=_field(poses, f32, device),
        landmarks=_field(landmarks, f32, device),
        lm_valid=_field(lm_valid, torch.bool, device),
        obs=BAObservations(**{n: _field(getattr(obs, n), dt, device)
                              for n, dt in _OBS_DTYPES.items()}),
        cam_T_ref=_field(cam_T_ref, f32, device),
        fxycxy=_field(fxycxy, f32, device),
        prior_H=_field(prior_H, f32, device),
        prior_b=_field(prior_b, f32, device),
        kf_valid=_field(kf_valid, torch.bool, device),
    )


def _residuals_and_jacobians(problem: BAProblem, huber_px: float):
    """Per-observation r (O, 2), Jp (O, 2, 6), Jl (O, 2, 3), w (O,) for any
    observation layout (row gathers of poses and cameras)."""
    obs = problem.obs
    kf, cam, lm = obs.kf.long(), obs.cam.long(), obs.lm.long()
    rTw = lie.se3_inverse(problem.poses[kf])
    cTr = problem.cam_T_ref[cam]
    f = problem.fxycxy[cam]
    q = lie.se3_apply(rTw, problem.landmarks[lm])
    p = lie.se3_apply(cTr, q)
    inv_z = 1.0 / torch.clamp(p[..., 2], min=1e-3)
    r = p[..., :2] * inv_z[..., None] * f[..., :2] + f[..., 2:] - obs.uv
    fx, fy = f[..., 0], f[..., 1]
    zero = torch.zeros_like(fx)
    Jproj = torch.stack([
        torch.stack([fx * inv_z, zero, -fx * p[..., 0] * inv_z * inv_z], -1),
        torch.stack([zero, fy * inv_z, -fy * p[..., 1] * inv_z * inv_z], -1),
    ], dim=-2)
    A = Jproj @ cTr[..., :3, :3]
    Jp = torch.cat([A @ lie.so3_hat(q), -A], dim=-1)
    Jl = A @ rTw[..., :3, :3]
    rn = torch.linalg.vector_norm(r, dim=-1)
    w_huber = torch.where(rn <= huber_px, torch.ones_like(rn),
                          huber_px / torch.clamp(rn, min=1e-9))
    f32 = r.dtype
    w = (w_huber / torch.clamp(obs.sigma2, min=1e-6) * obs.valid.to(f32)
         * problem.lm_valid[lm].to(f32) * problem.kf_valid[kf].to(f32))
    return r, Jp, Jl, w


def _total_cost(problem: BAProblem, huber_px: float) -> torch.Tensor:
    r, _, _, w = _residuals_and_jacobians(problem, huber_px)
    return torch.sum(w * torch.sum(r * r, dim=-1))


def _landmark_onehot(problem: BAProblem) -> torch.Tensor:
    """(O, L) f32 one-hot of each observation's landmark slot: the
    landmark-axis reduction is a product against it (fixed summation
    order, unlike a scatter-add with atomics)."""
    L = problem.landmarks.shape[0]
    ar = torch.arange(L, device=problem.landmarks.device)
    return (problem.obs.lm.long()[:, None] == ar[None]).to(torch.float32)


def _lin_constants(problem: BAProblem) -> dict:
    """The per-solve inputs of ba_linearize: contiguous int32 / f32
    observation columns, the rig tables (Rc9 (C, 9), tc (C, 3), f4
    (C, 4)) and lm_vf, the landmark x keyframe validity of each
    observation (the observation's own validity changes per gate round)."""
    obs = problem.obs
    K = problem.poses.shape[0]
    O = obs.kf.shape[0]
    if O % K:
        raise ValueError(f"kf_blocked needs O ({O}) divisible by K ({K})")
    f32 = torch.float32
    obs_lm = obs.lm.to(torch.int32).contiguous()
    return dict(
        obs_lm=obs_lm, obs_cam=obs.cam.to(torch.int32).contiguous(),
        uv=obs.uv.to(f32).contiguous(), sigma2=obs.sigma2.to(f32).contiguous(),
        lm_vf=(problem.lm_valid[obs_lm.long()].to(f32)
               * problem.kf_valid.to(f32)[:, None].expand(K, O // K)
               .reshape(O)),
        Rc9=problem.cam_T_ref[:, :3, :3].reshape(-1, 9).to(f32).contiguous(),
        tc=problem.cam_T_ref[:, :3, 3].to(f32).contiguous(),
        f4=problem.fxycxy.to(f32).contiguous())


def _rtw12(poses: torch.Tensor) -> torch.Tensor:
    """(K, 4, 4) world_T_ref -> (K, 12) ref_T_world rows [R | t]."""
    rTw = lie.se3_inverse(poses)
    return torch.cat([rTw[:, :3, :3].reshape(-1, 9), rTw[:, :3, 3]],
                     dim=1).contiguous()


def linearize_inputs(problem: BAProblem) -> tuple:
    """ba_cuda.ba_linearize's positional arguments for a kf-blocked
    problem at its own state."""
    c = _lin_constants(problem)
    return (_rtw12(problem.poses), problem.landmarks.contiguous(),
            c["obs_lm"], c["obs_cam"], c["uv"], c["sigma2"],
            c["lm_vf"] * problem.obs.valid.to(torch.float32), c["Rc9"],
            c["tc"], c["f4"])


def _assemble_from_payload(problem: BAProblem, payload, Hpp36, gp6, oh_l):
    """Normal equations from the per-observation payload (K, 30, Ok) and
    the per-keyframe Hpp (K, 36) / gp (K, 6): -> (Hpp (K*6, K*6) dense with
    the prior, gp (K*6,), Hll (L, 3, 3), gl (L, 3), Wc (K, 6, L, 3))."""
    K = problem.poses.shape[0]
    L = problem.landmarks.shape[0]
    Ok = payload.shape[2]
    # f32 throughout (TF32 is off): the Schur complement and the gradient
    # cancel heavily, and rounded summands bias the converged poses
    R = torch.bmm(payload, oh_l.reshape(K, Ok, L))  # (K, 30, L)
    Wc = R[:, :18].reshape(K, 6, 3, L).permute(0, 1, 3, 2)
    Hll = R[:, 18:27].sum(dim=0).T.reshape(L, 3, 3)
    gl = R[:, 27:30].sum(dim=0).T
    Hpp = torch.block_diag(*Hpp36.reshape(K, 6, 6).unbind(0))
    return (Hpp + problem.prior_H, gp6.reshape(K * 6) + problem.prior_b, Hll,
            gl, Wc)


def _eliminate(Hll, Wc, damp):
    """Landmark elimination terms in float64: (Hll + damp I)^-1 (L, 3, 3),
    Wm = Wc as (K*6, L, 3) and W Hll^-1 (K*6, L, 3). The JAX package runs
    this in f32, where XLA's fused multiply-adds keep the closed-form 3x3
    inverses of near-singular landmark blocks accurate enough; torch rounds
    every product, and in f32 the Schur complement then comes out ~2 %
    off (7x XLA's error on the BA test scene). float64 costs nothing at
    these sizes and puts the step at the exact solution of the f32
    system."""
    f64 = torch.float64
    K6, L = Wc.shape[0] * Wc.shape[1], Hll.shape[0]
    eye3 = torch.eye(3, dtype=f64, device=Hll.device)
    Hll_inv = linalg3.inv3(Hll.to(f64) + damp * eye3)
    Wm = Wc.reshape(K6, L, 3).to(f64)
    return Hll_inv, Wm, torch.einsum("plj,ljk->plk", Wm, Hll_inv)


def _schur_solve(Hpp, gp, Hll, gl, Wc, lam, lm_valid):
    """Damped Schur solve -> (dpose (K*6,), dlm (L, 3)) in Hpp's dtype;
    lam a 0-d tensor."""
    f64 = torch.float64
    K6 = Hpp.shape[0]
    lam = lam.to(f64)
    # damp landmark blocks; empty / invalid blocks become identity (delta 0
    # since their gradient is 0 too)
    Hll_inv, Wm, WHinv = _eliminate(Hll, Wc, lam + 1e-6)
    S = (Hpp.to(f64) + lam * torch.eye(K6, dtype=f64, device=Hpp.device)
         - torch.einsum("plk,qlk->pq", WHinv, Wm))
    gl = gl.to(f64)
    rhs = gp.to(f64) - torch.einsum("plk,lk->p", WHinv, gl)
    # solve_ex, not solve: solve checks its info on the host (a sync)
    dp = -torch.linalg.solve_ex(S, rhs)[0]
    dl = -torch.einsum("ljk,lk->lj", Hll_inv,
                       gl + torch.einsum("plj,p->lj", Wm, dp))
    dl = dl * lm_valid[:, None].to(f64)
    return dp.to(Hpp.dtype), dl.to(Hpp.dtype)


def ba_solve(problem: BAProblem, iters: int = 10, huber_px: float = 2.5,
             init_lambda: float = 1e-4, chi2_thresh: float = 5.991,
             gate_rounds: int = 2, kf_blocked: bool = True) -> BAResult:
    """LM with accept/reject damping in `gate_rounds` rounds of `iters`
    steps, with the chi2 outlier gate (5.991) tightening the observation
    mask between rounds. One linearization per step: the trial point's
    pass doubles as the previous step's acceptance check, and a rejected
    step re-solves the carried system with a larger lambda. A gate step
    takes no LM step: it re-linearizes the carried state under the new
    mask, adopts it and resets lambda.

    The observation table must be kf-blocked (O = K * Ok, obs.kf[o] ==
    o // Ok); the generic layout (kf_blocked=False) is not ported."""
    if not kf_blocked:
        raise NotImplementedError(
            "ba_solve: only the kf-blocked observation layout is ported "
            "(kf_blocked=True)")
    dev = problem.poses.device
    f32 = torch.float32
    obs = problem.obs
    K = problem.poses.shape[0]

    # per-solve constants
    oh_l = _landmark_onehot(problem)
    c = _lin_constants(problem)

    lin = ba_cuda.Linearizer(c["obs_lm"], c["obs_cam"], c["uv"],
                             c["sigma2"], c["Rc9"], c["tc"], c["f4"], K,
                             problem.landmarks.shape[0], huber_px)

    def system(poses, lms, obs_valid):
        payload, r, w, Hpp36, gp6 = lin(
            _rtw12(poses), lms.contiguous(), c["lm_vf"] * obs_valid.to(f32))
        sys_ = _assemble_from_payload(problem, payload, Hpp36, gp6, oh_l)
        return sys_, torch.sum(w * torch.sum(r * r, dim=-1)), r

    def gate_weights(r):
        chi2 = torch.sum(r * r, dim=-1) / torch.clamp(c["sigma2"], min=1e-6)
        return obs.valid & (chi2 < chi2_thresh)

    def lam0():
        return torch.full((), init_lambda, dtype=f32, device=dev)

    obs_valid = obs.valid
    b_poses, b_lms = problem.poses, problem.landmarks
    b_sys, b_cost, b_r = system(b_poses, b_lms, obs_valid)
    lam = lam0()
    for idx in range(iters * gate_rounds):
        if idx > 0 and idx % iters == 0:
            # gate boundary: tighten the mask from the carried residuals,
            # re-linearize the carried state and adopt it unconditionally
            obs_valid = gate_weights(b_r)
            b_sys, b_cost, b_r = system(b_poses, b_lms, obs_valid)
            lam = lam0()
            continue
        dp, dl = _schur_solve(*b_sys, lam, problem.lm_valid)
        t_poses = lie.se3_retract(b_poses, dp.reshape(K, 6))
        t_lms = b_lms + dl
        sys_t, c_t, r_t = system(t_poses, t_lms, obs_valid)
        improved = c_t < b_cost

        def pick(a, b):
            return torch.where(improved, a, b)

        b_poses = pick(t_poses, b_poses)
        b_lms = pick(t_lms, b_lms)
        b_sys = tuple(pick(a, b) for a, b in zip(sys_t, b_sys))
        b_r = pick(r_t, b_r)
        b_cost = pick(c_t, b_cost)
        lam = torch.clamp(torch.where(improved, lam * 0.3, lam * 5.0),
                          1e-8, 1e4)
    # final gate for the reported inlier set
    inliers = gate_weights(b_r)

    # undamped pose-side marginal at the solution, from the carried system:
    # S = Hpp - W Hll^-1 W^T, the information fixed-lag marginalization
    # hands to the next window
    Hpp_f, _, Hll_f, _, Wc_f = b_sys
    _, Wm, WHinv = _eliminate(Hll_f, Wc_f, 1e-6)
    marginal_H = (Hpp_f.to(torch.float64)
                  - torch.einsum("plk,qlk->pq", WHinv, Wm)).to(f32)
    return BAResult(
        poses=b_poses, landmarks=b_lms, obs_inliers=inliers, cost=b_cost,
        num_inliers=torch.sum(inliers).to(torch.int32),
        marginal_H=marginal_H,
    )
