"""Visual-inertial(-GPS) sliding-window bundle adjustment (counterpart of
mcslam_tpu/backend/ba_vio.py).

Per-keyframe state [pose(6), vel(3), bias(6)] (D = 15), plus one global
6-dof GPS alignment state E_T_V (ENU from the VIO world) appended as the
last column block of the dense pose-side system, N = K * D + 6.

- Vision observations touch the 6 pose dofs of one keyframe and one
  landmark. Their block is the window BA's system on a BAProblem view
  with zero priors, of either layout: kf-blocked, one `ba_linearize`
  launch per linearization (its plain version on the CPU), or generic,
  backend/ba._assemble's one-hot products (the layout a replayed graph
  log has). A constant 0/1 matrix E (N, K * 6) embeds the (K*6) pose
  blocks into the N layout exactly: no scatter, no atomics.
- IMU factors couple two keyframes' 15-dof states, GPS factors one pose
  and E_T_V, between factors two poses. Their residuals are whitened
  functions of the states. backend/vio_cuda.VioFactors (made once per
  solve) adds their w J^T J, w J^T r and w |r|^2 to the vision block and
  the prior: on CUDA tensors one vio_factors launch per linearization
  (the Jacobians by forward-mode duals in float64, each factor placed at
  its states' columns); on CPU tensors the plain version
  (vio_cuda.vio_factors_reference, the residuals and their
  torch.func.jacfwd Jacobians there too).
- Both read the index columns (`ImuFactors.i/j`, `GpsFactors.kf`,
  `BetweenFactors.i/j`: int32 tensors on the problem's device, uploaded
  with the tables' other fields) from device memory, so they are inputs
  like any other tensor: one captured program
  (driver_window._replay_vio_solve) serves every index pattern of its
  shapes. Padded factors carry weight 0.
- The damped Schur step and the final marginal reuse backend/ba's
  landmark elimination and solve, in float64 (the JAX package solves in
  float32; the priors reach 1e8 against 1e-2 information entries).

`vio_solve` queues on the current stream without the host waiting: no
`.item()`, no host branch on a tensor and no host<->device copy inside.

The reference's "hold the first optimization until >= 3 GPS factors" rule
lives in the driver, not here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mcslam_tpu_torch.backend import ba
from mcslam_tpu_torch.backend import imu as imu_mod
from mcslam_tpu_torch.backend import vio_cuda
from mcslam_tpu_torch.geometry import lie

D = 15  # per-keyframe state dims


class ImuFactors(NamedTuple):
    """Padded table of preintegrated IMU factors between window
    keyframes."""

    i: torch.Tensor  # (F,) int32 source keyframe (window index)
    j: torch.Tensor  # (F,) int32 target keyframe
    dR: torch.Tensor  # (F, 3, 3)
    dv: torch.Tensor  # (F, 3)
    dp: torch.Tensor  # (F, 3)
    dt: torch.Tensor  # (F,)
    dR_dbg: torch.Tensor  # (F, 3, 3)
    dv_dbg: torch.Tensor  # (F, 3, 3)
    dv_dba: torch.Tensor  # (F, 3, 3)
    dp_dbg: torch.Tensor  # (F, 3, 3)
    dp_dba: torch.Tensor  # (F, 3, 3)
    bias_hat: torch.Tensor  # (F, 6)
    sqrt_info: torch.Tensor  # (F, 15, 15) upper-triangular whitening
    valid: torch.Tensor  # (F,) bool


class BetweenFactors(NamedTuple):
    """SE(3) relative-pose factors between window keyframes (loop
    constraints of the replay harness)."""

    i: torch.Tensor  # (B,) int32 window keyframe index
    j: torch.Tensor  # (B,) int32 window keyframe index
    rel: torch.Tensor  # (B, 4, 4) measured i_T_j
    sigma_rot: torch.Tensor  # (B,) rad
    sigma_trans: torch.Tensor  # (B,) m
    valid: torch.Tensor  # (B,) bool


class GpsFactors(NamedTuple):
    """GPS position factors: enu = E_T_V * (p_body + R_body t_bg)."""

    kf: torch.Tensor  # (G,) int32 window keyframe index
    enu: torch.Tensor  # (G, 3) measured ENU position
    t_bg: torch.Tensor  # (3,) body->GPS lever arm
    sigma: torch.Tensor  # (G,) measurement sigma [m]
    valid: torch.Tensor  # (G,) bool


class VioProblem(NamedTuple):
    poses: torch.Tensor  # (K, 4, 4) world_T_body
    vels: torch.Tensor  # (K, 3)
    biases: torch.Tensor  # (K, 6)
    landmarks: torch.Tensor  # (L, 3)
    lm_valid: torch.Tensor  # (L,)
    obs: ba.BAObservations  # uv observations (either layout)
    cam_T_body: torch.Tensor  # (C, 4, 4) camera-from-body extrinsics
    fxycxy: torch.Tensor  # (C, 4)
    imu: ImuFactors | None
    gps: GpsFactors | None
    E_T_V: torch.Tensor  # (4, 4) ENU-from-VIO-world alignment state
    prior_H: torch.Tensor  # (K*D+6, K*D+6)
    prior_b: torch.Tensor  # (K*D+6,)
    kf_valid: torch.Tensor  # (K,)
    g_norm: float = 9.81
    between: BetweenFactors | None = None


class VioResult(NamedTuple):
    poses: torch.Tensor
    vels: torch.Tensor
    biases: torch.Tensor
    landmarks: torch.Tensor
    E_T_V: torch.Tensor
    obs_inliers: torch.Tensor
    cost: torch.Tensor
    # pose-side marginal information at the solution (landmarks
    # eliminated): the source of the next window's fixed-lag prior
    marginal_H: torch.Tensor  # (K*D+6, K*D+6)


_INDEX_FIELDS = ("i", "j", "kf")


def factor_table(cls, device="cuda", **fields):
    """A factor table (ImuFactors, GpsFactors or BetweenFactors) from
    arrays of its fields: index columns as int32, `valid` as bool and the
    rest as float32 tensors, all on `device`."""
    return cls(**{n: ba._field(fields[n], torch.int32 if n in _INDEX_FIELDS
                               else torch.bool if n == "valid"
                               else torch.float32, device)
                  for n in cls._fields})


def problem_from_numpy(poses, vels, biases, landmarks, lm_valid, obs,
                       cam_T_body, fxycxy, E_T_V, prior_H, prior_b, kf_valid,
                       imu=None, gps=None, between=None, g_norm=9.81,
                       device="cuda") -> VioProblem:
    """A VioProblem on `device` from arrays of the same fields (numpy, or
    anything np.asarray takes; tensors are moved). `obs` is any object
    with the BAObservations fields; the factor tables are factor_table()s
    (or None) and are moved too."""
    f32 = torch.float32
    b = ba.problem_from_numpy(poses, landmarks, lm_valid, obs, cam_T_body,
                              fxycxy, prior_H, prior_b, kf_valid,
                              device=device)

    def move(t):
        return None if t is None else factor_table(
            type(t), device, **t._asdict())

    return VioProblem(
        poses=b.poses, vels=ba._field(vels, f32, device),
        biases=ba._field(biases, f32, device), landmarks=b.landmarks,
        lm_valid=b.lm_valid, obs=b.obs, cam_T_body=b.cam_T_ref,
        fxycxy=b.fxycxy, imu=move(imu), gps=move(gps),
        E_T_V=ba._field(E_T_V, f32, device), prior_H=b.prior_H,
        prior_b=b.prior_b, kf_valid=b.kf_valid, g_norm=float(g_norm),
        between=move(between))


_TABLES = {"imu": ImuFactors, "gps": GpsFactors, "between": BetweenFactors}


def _flatten(problem: VioProblem) -> tuple:
    """A VioProblem as a captured program's inputs -> (its tensors in field
    order, the factor tables' index columns among them; which tables are
    present). g_norm is not among them: a program is keyed on it
    (unflatten takes it back)."""
    flat, present = [], []
    for name in VioProblem._fields:
        v = getattr(problem, name)
        if name == "obs":
            flat += list(v)
        elif name in _TABLES:
            present.append(v is not None)
            flat += [] if v is None else list(v)
        elif name != "g_norm":
            flat.append(v)
    return flat, tuple(present)


def _unflatten(flat, present, g_norm: float) -> VioProblem:
    """_flatten's inverse."""
    it = iter(flat)
    fields, tables = {}, iter(present)
    for name in VioProblem._fields:
        if name == "obs":
            fields[name] = ba.BAObservations(
                *(next(it) for _ in ba.BAObservations._fields))
        elif name in _TABLES:
            cls = _TABLES[name]
            fields[name] = (cls(*(next(it) for _ in cls._fields))
                            if next(tables) else None)
        elif name == "g_norm":
            fields[name] = g_norm
        else:
            fields[name] = next(it)
    return VioProblem(**fields)


def _vision_problem(problem: VioProblem) -> ba.BAProblem:
    """The vision block as a BAProblem with zero priors."""
    K = problem.poses.shape[0]
    z = problem.poses.new_zeros
    return ba.BAProblem(
        poses=problem.poses, landmarks=problem.landmarks,
        lm_valid=problem.lm_valid, obs=problem.obs,
        cam_T_ref=problem.cam_T_body, fxycxy=problem.fxycxy,
        prior_H=z((K * 6, K * 6)), prior_b=z(K * 6),
        kf_valid=problem.kf_valid)


class _System:
    """Everything of a VIO problem that is constant over a solve, and its
    linearization at a state."""

    def __init__(self, problem: VioProblem, huber_px: float,
                 kf_blocked: bool):
        p = problem
        dev = p.poses.device
        K = p.poses.shape[0]
        self.K, self.N = K, K * D + 6
        # the vision block: ba's system of either layout on the zero-prior
        # BAProblem view; its state is (poses, landmarks)
        self.vision = (ba._blocked_system if kf_blocked
                       else ba._generic_system)(_vision_problem(p), huber_px)
        # E (N, K*6): pose block k of the vision system -> rows k*D..k*D+5
        self.E = vio_cuda.embedding(K, dev)
        self.factors = vio_cuda.VioFactors(p, self.E)

    def __call__(self, state, obs_valid):
        """-> ((H (N, N), g (N,), Hll (L, 3, 3), gl (L, 3), Wc (K, 6, L,
        3)), total cost, vision residuals (O, 2))."""
        poses, vels, biases, lms, ETV = state
        (Hpp, gp, Hll, gl, Wc), cost, r = self.vision((poses, lms),
                                                      obs_valid)
        H, g, cost = self.factors(poses, vels, biases, ETV, Hpp, gp, cost)
        return (H, g, Hll, gl, Wc), cost, r

    def rows(self, Wc):
        """(K, 6, L, 3) vision cross terms -> (N, 1, L, 3) in the N
        layout (the shape backend/ba._eliminate flattens)."""
        L = Wc.shape[2]
        return (self.E @ Wc.reshape(self.K * 6, L * 3)).reshape(
            self.N, 1, L, 3)


def _assemble_vio(problem: VioProblem, huber_px: float,
                  kf_blocked: bool = False):
    """The dense pose-side system and the landmark blocks at the problem's
    state -> (H (N, N), g (N,), Hll (L, 3, 3), gl (L, 3), Wc (N, L, 3),
    (r, w), cost), the JAX package's layout. kf_blocked=True takes the
    ba_linearize kernel (O = K * Ok, obs.kf[o] == o // Ok); the default,
    the generic layout, any observation table."""
    s = _System(problem, huber_px, kf_blocked)
    (H, g, Hll, gl, Wc), cost, r = s(
        (problem.poses, problem.vels, problem.biases, problem.landmarks,
         problem.E_T_V), problem.obs.valid)
    _, _, _, w = ba._residuals_and_jacobians(_vision_problem(problem),
                                             huber_px)
    return H, g, Hll, gl, s.rows(Wc)[:, 0], (r, w), cost


def _vio_cost(problem: VioProblem, huber_px: float) -> torch.Tensor:
    """Total cost at the problem's state, residuals only (the vision
    residuals by the plain path)."""
    p = problem
    cost = ba._total_cost(_vision_problem(p), huber_px)
    for fac, args in vio_cuda.factors(p, p.poses.shape[0] * D + 6):
        cost = cost + fac.cost(*args(p.poses, p.vels, p.biases, p.E_T_V))
    return cost


def vio_solve(problem: VioProblem, iters: int = 10, huber_px: float = 2.5,
              init_lambda: float = 1e-4, chi2_thresh: float = 5.991,
              gate_rounds: int = 2, kf_blocked: bool = False) -> VioResult:
    """LM over the VIO window by backend/ba.lm_schedule (`gate_rounds`
    rounds of `iters` steps, the chi2 gate (5.991) on the vision
    observations between rounds); the marginal comes from the carried
    system. kf_blocked=True takes the kf-blocked vision layout on the
    ba_linearize kernel; the default, the generic layout, any
    observation table."""
    K = problem.poses.shape[0]
    system = _System(problem, huber_px, kf_blocked)

    def step(sys_, lam, state):
        H, g, Hll, gl, Wc = sys_
        dx, dl = ba._schur_solve(H, g, Hll, gl, system.rows(Wc), lam,
                                 problem.lm_valid)
        ds = dx[:K * D].reshape(K, D)
        poses, vels, biases, lms, ETV = state
        return (lie.se3_retract(poses, ds[:, :6]), vels + ds[:, 6:9],
                biases + ds[:, 9:], lms + dl,
                lie.se3_retract(ETV, dx[K * D:]))

    gate = ba.chi2_gate(problem.obs, chi2_thresh)
    state, (H, _, Hll, _, Wc), cost, r = ba.lm_schedule(
        system, step, (problem.poses, problem.vels, problem.biases,
                       problem.landmarks, problem.E_T_V),
        problem.obs.valid, gate, iters, gate_rounds, init_lambda)
    poses, vels, biases, lms, ETV = state
    return VioResult(poses=poses, vels=vels, biases=biases, landmarks=lms,
                     E_T_V=ETV, obs_inliers=gate(r), cost=cost,
                     marginal_H=ba._marginal(H, Hll, system.rows(Wc)))


def make_imu_factors(preints: list, pairs: list, capacity: int,
                     params: imu_mod.ImuParams = imu_mod.ImuParams(),
                     device="cuda") -> ImuFactors:
    """Stack host-side Preintegrated records into a padded factor table of
    `capacity` rows on `device` (padding: identity deltas, dt 1e-3, unit
    whitening, invalid). The whitening is the upper Cholesky factor of
    each record's information, in float64 on the host."""
    F = capacity
    z33 = np.zeros((F, 3, 3), np.float32)
    out = dict(
        i=np.zeros(F, np.int32), j=np.zeros(F, np.int32),
        dR=np.tile(np.eye(3, dtype=np.float32), (F, 1, 1)),
        dv=np.zeros((F, 3), np.float32), dp=np.zeros((F, 3), np.float32),
        dt=np.ones(F, np.float32) * 1e-3,
        dR_dbg=z33.copy(), dv_dbg=z33.copy(), dv_dba=z33.copy(),
        dp_dbg=z33.copy(), dp_dba=z33.copy(),
        bias_hat=np.zeros((F, 6), np.float32),
        sqrt_info=np.tile(np.eye(15, dtype=np.float32), (F, 1, 1)),
        valid=np.zeros(F, bool),
    )
    for n, (pre, (i, j)) in enumerate(zip(preints, pairs)):
        if n >= F:
            break
        info = imu_mod.information(pre, params).cpu().numpy()
        out["sqrt_info"][n] = np.linalg.cholesky(
            info + 1e-8 * np.eye(15)).T.astype(np.float32)
        out["i"][n], out["j"][n] = i, j
        for name in ("dR", "dv", "dp", "dt", "dR_dbg", "dv_dbg", "dv_dba",
                     "dp_dbg", "dp_dba", "bias_hat"):
            out[name][n] = getattr(pre, name).cpu().numpy()
        out["valid"][n] = True
    return factor_table(ImuFactors, device, **out)
