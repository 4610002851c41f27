"""Sliding-window bundle adjustment: Levenberg-Marquardt with a dense Schur
complement (counterpart of mcslam_tpu/backend/ba.py).

The window is a fixed-size state: K keyframe poses, L landmark slots and O
observation slots, padded and masked. Two observation layouts:
- kf-blocked (kf_blocked=True, what the SLAM driver builds): O = K * Ok
  with observation o belonging to keyframe o // Ok. Every LM iteration
  linearizes all observations in one launch of the `ba_linearize` kernel
  (ops/ba_cuda; its plain version on the CPU) and reduces the 30-channel
  payload against the landmark one-hot in one batched f32 product.
- generic (kf_blocked=False, the default as in the JAX package: any
  keyframe per observation, e.g. a replayed graph log or an observation
  shard): the linearization by row gathers (_residuals_and_jacobians)
  and every segment sum as one f32 product against a one-hot
  (_assemble): fixed summation order, no atomics, so two runs on the
  card are bit-equal.
Either way the landmarks are eliminated with closed-form 3x3 inverses and
the (K*6)^2 Schur system is solved with `torch.linalg.solve_ex`, the
elimination in float64 (see _eliminate). One LM schedule (lm_schedule)
serves both layouts, the VIO solve and the sharded solvers.

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


def _make_onehots(problem: BAProblem):
    """(O, K) and (O, L) f32 one-hots of each observation's keyframe and
    landmark slot: the generic layout's segment reductions, constant
    over a solve."""
    K = problem.poses.shape[0]
    ar = torch.arange(K, device=problem.poses.device)
    oh_k = (problem.obs.kf.long()[:, None] == ar[None]).to(torch.float32)
    return oh_k, _landmark_onehot(problem)


def _assemble(problem: BAProblem, r, Jp, Jl, w, onehots=None):
    """Normal equations of the generic layout from the per-observation
    linearization: -> (Hpp (K*6, K*6) dense with the prior, gp (K*6,),
    Hll (L, 3, 3), gl (L, 3), Wc (K, 6, L, 3)), the kf-blocked assembly's
    layout.

    Two f32 products, each a fixed-order reduction: the pose blocks
    [Hpp | gp] (O, 42) against the (O, K) keyframe one-hot, and one
    landmark-axis product for W, Hll and gl together: the payload
    [T placed in its keyframe's 18 columns (O, K*18) | Hll (O, 9) |
    gl (O, 3)] against the (O, L) landmark one-hot. W costs K times the
    kf-blocked product's operations, as the JAX package's K masked
    products do."""
    K = problem.poses.shape[0]
    L = problem.landmarks.shape[0]
    O = r.shape[0]
    oh_k, oh_l = _make_onehots(problem) if onehots is None else onehots
    Jpw = Jp * w[:, None, None]
    Jlw = Jl * w[:, None, None]
    pose = oh_k.T @ torch.cat([
        torch.einsum("ori,orj->oij", Jpw, Jp).reshape(O, 36),
        torch.einsum("ori,or->oi", Jpw, r)], dim=1)  # (K, 42)
    T = torch.einsum("ori,orj->oij", Jpw, Jl).reshape(O, 1, 18)
    payload = torch.cat([
        (oh_k[:, :, None] * T).reshape(O, K * 18),
        torch.einsum("ori,orj->oij", Jlw, Jl).reshape(O, 9),
        torch.einsum("ori,or->oi", Jlw, r)], dim=1)
    R = payload.T @ oh_l  # (K*18 + 12, L)
    Wc = R[:K * 18].reshape(K, 6, 3, L).permute(0, 1, 3, 2)
    Hll = R[K * 18:K * 18 + 9].T.reshape(L, 3, 3)
    gl = R[K * 18 + 9:].T
    Hpp = torch.block_diag(*pose[:, :36].reshape(K, 6, 6).unbind(0))
    return (Hpp + problem.prior_H, pose[:, 36:].reshape(K * 6)
            + problem.prior_b, Hll, gl, Wc)


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


def _schur_terms(Hll, gl, Wc, lam):
    """One landmark set's share of the damped Schur system, in float64:
    (Hll^-1, Wm, W Hll^-1 W^T (K*6, K*6), W Hll^-1 gl (K*6,)) with the
    landmark blocks damped by lam + 1e-6 (empty / invalid blocks become
    identity, their delta 0 since their gradient is 0 too)."""
    Hll_inv, Wm, WHinv = _eliminate(Hll, Wc, lam.to(torch.float64) + 1e-6)
    return (Hll_inv, Wm, torch.einsum("plk,qlk->pq", WHinv, Wm),
            torch.einsum("plk,lk->p", WHinv, gl.to(torch.float64)))


def _solve_reduced(Hpp, gp, S_part, rhs_part, lam):
    """The pose step of the damped Schur system (float64)."""
    f64 = torch.float64
    K6 = Hpp.shape[0]
    S = (Hpp.to(f64) + lam.to(f64) * torch.eye(K6, dtype=f64,
                                               device=Hpp.device) - S_part)
    # solve_ex, not solve: solve checks its info on the host (a sync)
    return -torch.linalg.solve_ex(S, gp.to(f64) - rhs_part)[0]


def _back_substitute(Hll_inv, Wm, gl, dp, lm_valid):
    """Landmark deltas (L, 3) in float64 given the pose step dp."""
    dl = -torch.einsum("ljk,lk->lj", Hll_inv,
                       gl.to(torch.float64)
                       + torch.einsum("plj,p->lj", Wm, dp))
    return dl * lm_valid[:, None].to(torch.float64)


def _schur_solve(Hpp, gp, Hll, gl, Wc, lam, lm_valid):
    """Damped Schur solve -> (dpose (K*6,), dlm (L, 3)) in Hpp's dtype;
    lam a 0-d tensor."""
    lam = lam.to(torch.float64)  # once: the steps below take it as is
    Hll_inv, Wm, S_part, rhs_part = _schur_terms(Hll, gl, Wc, lam)
    dp = _solve_reduced(Hpp, gp, S_part, rhs_part, lam)
    dl = _back_substitute(Hll_inv, Wm, gl, dp, lm_valid)
    return dp.to(Hpp.dtype), dl.to(Hpp.dtype)


def _marginal(Hpp, Hll, Wc) -> torch.Tensor:
    """Undamped pose-side marginal S = Hpp - W Hll^-1 W^T (f32): the
    information fixed-lag marginalization hands to the next window."""
    _, Wm, WHinv = _eliminate(Hll, Wc, 1e-6)
    return (Hpp.to(torch.float64)
            - torch.einsum("plk,qlk->pq", WHinv, Wm)).to(torch.float32)


def _where(cond, a, b):
    """torch.where over matching nests of tuples / lists of tensors, the
    0-d condition copied to each leaf's device (a no-op on its own)."""
    if isinstance(a, (tuple, list)):
        return type(a)(_where(cond, x, y) for x, y in zip(a, b))
    return torch.where(cond.to(a.device, non_blocking=True), a, b)


def lm_schedule(system, step, state, obs_valid, gate, iters: int,
                gate_rounds: int, init_lambda: float):
    """The LM schedule of every solver of the port (ba_solve, vio_solve,
    parallel/sharded_ba): accept / reject damping in `gate_rounds` rounds
    of `iters` steps, with the chi2 outlier gate tightening the
    observation mask between rounds. One linearization per step: the
    trial point's pass doubles as the previous step's acceptance check,
    and a rejected step re-solves the carried system with a larger
    lambda. A gate step takes no LM step: it re-linearizes the carried
    state under the new mask, adopts it and resets lambda.

    system(state, obs_valid) -> (sys, cost (0-d), r); step(sys, lam,
    state) -> the trial state; gate(r) -> obs_valid. state, sys, r and
    obs_valid may be nests of tuples / lists of tensors on several
    devices; cost and lambda live on one. Decisions are device tensors
    (torch.where), never read on the host.
    -> (state, sys, cost, r) of the last adopted state."""
    b_sys, b_cost, b_r = system(state, obs_valid)

    def lam0():
        return torch.full((), init_lambda, dtype=torch.float32,
                          device=b_cost.device)

    lam = lam0()
    for idx in range(iters * gate_rounds):
        if idx > 0 and idx % iters == 0:
            obs_valid = gate(b_r)
            b_sys, b_cost, b_r = system(state, obs_valid)
            lam = lam0()
            continue
        t_state = step(b_sys, lam, state)
        sys_t, c_t, r_t = system(t_state, obs_valid)
        improved = c_t < b_cost
        state, b_sys, b_r, b_cost = _where(
            improved, (t_state, sys_t, r_t, c_t), (state, b_sys, b_r, b_cost))
        lam = torch.clamp(torch.where(improved, lam * 0.3, lam * 5.0),
                          1e-8, 1e4)
    return state, b_sys, b_cost, b_r


def _blocked_system(problem: BAProblem, huber_px: float):
    """system(state, obs_valid) of the kf-blocked layout on the
    ba_linearize kernel (prepared once per solve)."""
    c = _lin_constants(problem)
    oh_l = _landmark_onehot(problem)
    lin = ba_cuda.Linearizer(c["obs_lm"], c["obs_cam"], c["uv"],
                             c["sigma2"], c["Rc9"], c["tc"], c["f4"],
                             problem.poses.shape[0],
                             problem.landmarks.shape[0], huber_px)

    def system(state, obs_valid):
        poses, lms = state
        payload, r, w, Hpp36, gp6 = lin(
            _rtw12(poses), lms.contiguous(),
            c["lm_vf"] * obs_valid.to(torch.float32))
        sys_ = _assemble_from_payload(problem, payload, Hpp36, gp6, oh_l)
        return sys_, torch.sum(w * torch.sum(r * r, dim=-1)), r

    return system


def _generic_system(problem: BAProblem, huber_px: float):
    """system(state, obs_valid) of the generic layout (plain PyTorch, as
    the JAX package's generic path is plain XLA)."""
    onehots = _make_onehots(problem)

    def system(state, obs_valid):
        poses, lms = state
        p = problem._replace(poses=poses, landmarks=lms,
                             obs=problem.obs._replace(valid=obs_valid))
        r, Jp, Jl, w = _residuals_and_jacobians(p, huber_px)
        sys_ = _assemble(p, r, Jp, Jl, w, onehots)
        return sys_, torch.sum(w * torch.sum(r * r, dim=-1)), r

    return system


def chi2_gate(obs: BAObservations, chi2_thresh: float):
    """gate(r) -> obs.valid & (|r|^2 / sigma^2 < chi2_thresh)."""
    sigma2 = torch.clamp(obs.sigma2.to(torch.float32), min=1e-6)

    def gate(r):
        return obs.valid & (torch.sum(r * r, dim=-1) / sigma2 < chi2_thresh)

    return gate


def ba_solve(problem: BAProblem, iters: int = 10, huber_px: float = 2.5,
             init_lambda: float = 1e-4, chi2_thresh: float = 5.991,
             gate_rounds: int = 2, kf_blocked: bool = False) -> BAResult:
    """LM over the window by lm_schedule (`gate_rounds` rounds of `iters`
    steps, the chi2 gate (5.991) between rounds), then the inlier set at
    the solution and the undamped pose-side marginal of the carried
    system.

    kf_blocked=True takes the kf-blocked layout on the ba_linearize
    kernel: the caller guarantees O = K * Ok and obs.kf[o] == o // Ok.
    The default, the generic layout, takes any observation table."""
    K = problem.poses.shape[0]
    system = (_blocked_system if kf_blocked else _generic_system)(
        problem, huber_px)

    def step(sys_, lam, state):
        dp, dl = _schur_solve(*sys_, lam, problem.lm_valid)
        return (lie.se3_retract(state[0], dp.reshape(K, 6)), state[1] + dl)

    gate = chi2_gate(problem.obs, chi2_thresh)
    (poses, lms), (Hpp, _, Hll, _, Wc), cost, r = lm_schedule(
        system, step, (problem.poses, problem.landmarks), problem.obs.valid,
        gate, iters, gate_rounds, init_lambda)
    inliers = gate(r)  # the reported inlier set
    return BAResult(
        poses=poses, landmarks=lms, obs_inliers=inliers, cost=cost,
        num_inliers=torch.sum(inliers).to(torch.int32),
        marginal_H=_marginal(Hpp, Hll, Wc),
    )
