"""The factor half of a VIO window linearization as one CUDA launch
(kernel source csrc/vio_factors.cu, the residuals on forward-mode duals
in csrc/vio_dual.cuh), the port's counterpart of the factor Jacobians
that XLA fuses into the JAX package's vio_solve
(mcslam_tpu/backend/ba_vio.py _assemble_vio :161: jax.vmap(jax.jacfwd)
of the IMU :257-258, GPS :298-299 and between :339-340 residuals and
their scatter-adds); no Pallas kernel corresponds to them.

`VioFactors(problem)` is made once per solve (backend/ba_vio._System).
Called with a state (poses, vels, biases, E_T_V) and the vision block's
Hpp (K*6, K*6), gp (K*6,) and cost, it returns the dense pose-side
system and the total cost, N = 15 K + 6:

    H    = E Hpp E^T + prior_H + sum over tables of sum_f w_f J_f^T J_f
    g    = E gp + prior_b + sum over tables of sum_f w_f J_f^T r_f
    cost = vision cost + sum over tables of sum_f w_f |r_f|^2

with the tables in the order imu, gps, between, each factor's terms
placed at its states' columns, J_f the Jacobian of the whitened residual
r_f at tangent 0 in float64 cast to float32, and E the 0/1 matrix that
puts the vision block's pose rows at k D .. k D + 5. CUDA tensors launch
vio_factors once (or raise: no fallback); CPU tensors take the plain
version, `vio_factors_reference`: per table torch.func.vmap(
torch.func.jacfwd) in float64 of the residuals below, a product with a
0/1 selection matrix and two einsums (_Factor.linearize). The kernel
reads the tables' index columns from device memory, so a captured solve
keeps them as inputs (driver_window._replay_vio_solve). It is one
thread-block cluster: the factors spread over its blocks, each block
starting a band of rows of H and g under the residuals and placing it
after one cluster barrier; no arrival counter, no float atomics, so
launches and graph replays are bit-equal.

The two agree to rounding (chip_smoke.py phase 2 holds them on the card):
J_f and r_f after the float32 cast equal or 1 ulp apart where the float64
values round differently (torch's float64 products and sin / atan2 are
not repeatable to the bit); each factor's products and every entry of H,
g and the cost within the float32 rounding bound of that entry's own
terms (chip_smoke.vio_sum_bounds: the plain version's einsums sum over
(f, r) in an order that cannot be repeated), and H, g and the cost within
1e-6 of the largest entry of the factor part.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from mcslam_tpu_torch import _build
from mcslam_tpu_torch.backend import imu as imu_mod
from mcslam_tpu_torch.geometry import lie
from mcslam_tpu_torch.utils import outputs

D = 15  # per-keyframe state dims (backend/ba_vio.D)
# (tangent columns n, residual rows R) of a factor of each table
SHAPES = {"imu": (2 * D, D), "gps": (12, 3), "between": (12, 6)}
# each table's fields as the kernel reads them: (dtype, shape; None is the
# table's length F)
_I32, _F32, _B8 = torch.int32, torch.float32, torch.bool
FIELDS = {
    "imu": dict(i=(_I32, (None,)), j=(_I32, (None,)),
                dR=(_F32, (None, 3, 3)), dv=(_F32, (None, 3)),
                dp=(_F32, (None, 3)), dt=(_F32, (None,)),
                dR_dbg=(_F32, (None, 3, 3)), dv_dbg=(_F32, (None, 3, 3)),
                dv_dba=(_F32, (None, 3, 3)), dp_dbg=(_F32, (None, 3, 3)),
                dp_dba=(_F32, (None, 3, 3)), bias_hat=(_F32, (None, 6)),
                sqrt_info=(_F32, (None, 15, 15)), valid=(_B8, (None,))),
    "gps": dict(kf=(_I32, (None,)), enu=(_F32, (None, 3)),
                t_bg=(_F32, (3,)), sigma=(_F32, (None,)),
                valid=(_B8, (None,))),
    "between": dict(i=(_I32, (None,)), j=(_I32, (None,)),
                    rel=(_F32, (None, 4, 4)), sigma_rot=(_F32, (None,)),
                    sigma_trans=(_F32, (None,)), valid=(_B8, (None,))),
}
# slots of mc_vio_factors' pointer table (csrc/vio_factors.cu Args)
# 0-6: poses, vels, biases, E_T_V, Hpp, gp, the vision cost
_PRIOR_SLOT = 7  # prior_H, prior_b
_TABLE_SLOT = 9  # the tables' fields, in FIELDS' order
_OUT_SLOT = 34  # H, g, cost, scratch
_N_PTRS = 38


def rec_floats(table: str) -> int:
    """Floats of one factor's record in the scratch: J (R, n) and r (R,)
    as float32, (w J)^T J (n, n), (w J)^T r (n,) and w |r|^2."""
    n, R = SHAPES[table]
    return R * n + R + n * n + n + 1


def scratch_floats(F: int, G: int, B: int) -> int:
    """Floats of the scratch a launch with F IMU, G GPS and B between
    factors needs: the factors' records."""
    return (F * rec_floats("imu") + G * rec_floats("gps")
            + B * rec_floats("between"))


@functools.lru_cache(maxsize=16)
def _layout(N: int, S: int):
    f32 = torch.float32
    return outputs.layout(((N, N), (N,), (), (S,)), (f32,) * 4)


def embedding(K: int, device) -> torch.Tensor:
    """E (K*D+6, K*6): pose block k of the vision system -> rows
    k*D..k*D+5 (0/1)."""
    E = torch.zeros(K * D + 6, K * 6, dtype=torch.float32, device=device)
    for k in range(K):
        E[k * D:k * D + 6, k * 6:k * 6 + 6].diagonal().fill_(1.0)
    return E


def _present(problem) -> list:
    return [t for t in SHAPES if getattr(problem, t) is not None]


# -- factor residuals ---------------------------------------------------------
# Each takes the stacked tangent x of the states it touches and the
# factor's tensors, with any leading batch dims (a single factor under
# vmap, or all factors at once), and returns the whitened residual.


def _retract_state(pose, vel, bias, xi):
    return (lie.se3_retract(pose, xi[..., :6]), vel + xi[..., 6:9],
            bias + xi[..., 9:15])


def _imu_residual(x, Ti, vi, bi, Tj, vj, bj, dR, dv, dp, dt, dR_dbg, dv_dbg,
                  dv_dba, dp_dbg, dp_dba, bias_hat, sqrt_info, g_norm):
    """15-dim whitened residual of an IMU factor at the states retracted
    by x = [xi_i (15), xi_j (15)]."""
    pre = imu_mod.Preintegrated(
        dR=dR, dv=dv, dp=dp, dt=dt, dR_dbg=dR_dbg, dv_dbg=dv_dbg,
        dv_dba=dv_dba, dp_dbg=dp_dbg, dp_dba=dp_dba, cov=None,
        bias_hat=bias_hat, n_samples=None)
    si = imu_mod.ImuState(*_retract_state(Ti, vi, bi, x[..., :D]))
    sj = imu_mod.ImuState(*_retract_state(Tj, vj, bj, x[..., D:]))
    r = imu_mod.residual(si, sj, pre, imu_mod.ImuParams(g_norm=g_norm))
    return lie._apply_mat(sqrt_info, r)


def _gps_residual(x, pose, E_T_V, enu, t_bg):
    """3-dim residual E_T_V (pose t_bg) - enu at x = [xi_pose, xi_E]."""
    p_world = lie.se3_apply(lie.se3_retract(pose, x[..., :6]), t_bg)
    return lie.se3_apply(lie.se3_retract(E_T_V, x[..., 6:]), p_world) - enu


def _between_residual(x, Ti, Tj, rel, sigma_rot, sigma_trans):
    """6-dim whitened log(rel^-1 T_i^-1 T_j) at x = [xi_i, xi_j]."""
    Pi = lie.se3_retract(Ti, x[..., :6])
    Pj = lie.se3_retract(Tj, x[..., 6:])
    r6 = lie.se3_log(lie.se3_inverse(rel) @ (lie.se3_inverse(Pi) @ Pj))
    w = torch.cat([
        (1.0 / torch.clamp(sigma_rot, min=1e-6))[..., None].expand(
            *sigma_rot.shape, 3),
        (1.0 / torch.clamp(sigma_trans, min=1e-6))[..., None].expand(
            *sigma_trans.shape, 3)], dim=-1)
    return r6 * w


class _Factor:
    """One factor table prepared for a solve: its residual function, its
    weights and the selection matrix (F, n, N) that places each factor's
    n tangent columns at its states' columns of the dense system.
    `starts` lists, in the order of the tangent's columns, (first column,
    size) blocks; a first column is an int (every factor's) or a tensor
    of one per factor."""

    def __init__(self, fn, weight, starts, N):
        self.fn, self.weight = fn, weight
        F, dev = weight.shape[0], weight.device
        n = sum(size for _, size in starts)
        cols = torch.cat([
            (c0.long()[:, None] if isinstance(c0, torch.Tensor)
             else torch.full((F, 1), c0, dtype=torch.long, device=dev))
            + torch.arange(size, device=dev) for c0, size in starts],
            dim=1)  # (F, n): each tangent column's state column
        self.sel = torch.zeros(F, n, N, dtype=torch.float32,
                               device=dev).scatter_(2, cols[:, :, None], 1.0)

    def jacobian(self, *args):
        """(J (F, R, n), r (F, R)) float32 of the table at the states in
        args (the tangent is 0): Jacobians by jacfwd in float64."""
        def f(x, *a):
            r = self.fn(x, *a)
            return r, r

        a64 = [a.double() for a in args]
        z = torch.zeros(a64[0].shape[0], self.sel.shape[1],
                        dtype=torch.float64, device=a64[0].device)
        J, r = torch.func.vmap(torch.func.jacfwd(f, has_aux=True))(z, *a64)
        return J.float(), r.float()

    def linearize(self, *args):
        """(weighted cost, H (N, N), g (N,)) of the table at the states in
        args (the tangent is 0)."""
        J, r = self.jacobian(*args)
        J = J @ self.sel
        Jw = J * self.weight[:, None, None]
        return (torch.sum(self.weight * torch.sum(r * r, dim=-1)),
                torch.einsum("fri,frj->ij", Jw, J),
                torch.einsum("fri,fr->i", Jw, r))

    def cost(self, *args):
        r = self.fn(torch.zeros(args[0].shape[0], self.sel.shape[1],
                                dtype=args[0].dtype, device=args[0].device),
                    *args)
        return torch.sum(self.weight * torch.sum(r * r, dim=-1))


def factors(p, N: int) -> list:
    """[(factor, args)] of the VioProblem p's factor tables, in the order
    imu, gps, between (absent ones left out): args(poses, vels, biases,
    E_T_V) gives the factor residual's tensor arguments at a state."""
    K = p.poses.shape[0]
    out = []
    if p.imu is not None:
        fi = p.imu
        out.append((_Factor(
            lambda x, *a: _imu_residual(x, *a, p.g_norm), fi.valid.float(),
            [(fi.i * D, D), (fi.j * D, D)], N),
            lambda P, V, B, E: (
                *(t.index_select(0, fi.i) for t in (P, V, B)),
                *(t.index_select(0, fi.j) for t in (P, V, B)), fi.dR, fi.dv,
                fi.dp, fi.dt, fi.dR_dbg, fi.dv_dbg, fi.dv_dba, fi.dp_dbg,
                fi.dp_dba, fi.bias_hat, fi.sqrt_info)))
    if p.gps is not None:
        gf = p.gps
        G = gf.kf.shape[0]
        out.append((_Factor(
            _gps_residual,
            gf.valid.float() / torch.clamp(gf.sigma, min=1e-3) ** 2,
            [(gf.kf * D, 6), (K * D, 6)], N),
            lambda P, V, B, E: (P.index_select(0, gf.kf), E.expand(G, 4, 4),
                                gf.enu, gf.t_bg.expand(G, 3))))
    if p.between is not None:
        fb = p.between
        out.append((_Factor(
            _between_residual, fb.valid.float(),
            [(fb.i * D, 6), (fb.j * D, 6)], N),
            lambda P, V, B, E: (P.index_select(0, fb.i),
                                P.index_select(0, fb.j), fb.rel,
                                fb.sigma_rot, fb.sigma_trans)))
    return out




def vio_factors_reference(problem, poses, vels, biases, E_T_V, Hpp, gp,
                          cost, E=None, facs=None):
    """Plain PyTorch version: (H (N, N), g (N,), cost ()) of the problem's
    factor tables at the state (poses, vels, biases, E_T_V), with the
    vision block (Hpp, gp, cost) and the prior. E (embedding) and factors
    (factors()) may be given, made once per solve."""
    K = poses.shape[0]
    if E is None:
        E = embedding(K, poses.device)
    if facs is None:
        facs = factors(problem, K * D + 6)
    H = E @ Hpp @ E.T + problem.prior_H
    g = E @ gp + problem.prior_b
    for fac, args in facs:
        c_f, H_f, g_f = fac.linearize(*args(poses, vels, biases, E_T_V))
        cost, H, g = cost + c_f, H + H_f, g + g_f
    return H, g, cost


def factors_reference(problem, poses, vels, biases, E_T_V) -> dict:
    """{table: (J (F, R, n), r (F, R), w (F,), sel (F, n, N))} of each
    present table at the state: the float32 casts of the plain version's
    float64 jacfwd, each factor's weight and the 0/1 selection matrix
    that places its tangent columns at its states' columns."""
    facs = factors(problem, poses.shape[0] * D + 6)
    return {name: (*fac.jacobian(*args(poses, vels, biases, E_T_V)),
                   fac.weight, fac.sel)
            for name, (fac, args) in zip(_present(problem), facs)}


def record_views(scratch: torch.Tensor, counts) -> dict:
    """{table: (J (F, R, n), r (F, R), (w J)^T J (F, n, n), (w J)^T r
    (F, n), w |r|^2 (F,))} views of the factors' records in a launch's
    scratch slab (VioFactors.scratch) with counts = (F, G, B) factors
    (absent tables: 0). A factor joining a keyframe to itself keeps J as
    it is and its products in the columns of J with column c + n/2 added
    to column c (and columns n/2.. zero)."""
    out, base = {}, scratch.storage_offset()
    for name, F in zip(SHAPES, counts):
        n, R = SHAPES[name]
        rec = rec_floats(name)
        if F:
            parts, off = [], base
            for shape in ((R, n), (R,), (n, n), (n,), ()):
                strides = [math.prod(shape[k + 1:]) for k in range(len(shape))]
                parts.append(scratch.as_strided((F, *shape), (rec, *strides),
                                                off))
                off += math.prod(shape)
            out[name] = tuple(parts)
        base += F * rec
    return out


class VioFactors:
    """The factor half of a VIO problem's linearization, prepared once per
    solve: the tables checked and their pointers laid out (CUDA), or the
    plain version's factors with their selection matrices (CPU).
    call(poses, vels, biases, E_T_V, Hpp, gp, cost) -> (H, g, cost); on
    CUDA tensors `scratch` is then the launch's scratch slab, the
    factors' records (record_views)."""

    def __init__(self, problem, E=None):
        self.problem = problem
        self.kind = _build.device_type(problem.poses, "vio_factors")
        K = problem.poses.shape[0]
        self.K, self.N, self.scratch = K, K * D + 6, None
        if self.kind == "cpu":
            self.E = embedding(K, problem.poses.device) if E is None else E
            self.factors = factors(problem, self.N)
            return
        dev = self.device = problem.poses.device
        N = self.N
        keep = _build.kernel_inputs(
            "vio_factors", dev, prior_H=(problem.prior_H, _F32, (N, N)),
            prior_b=(problem.prior_b, _F32, (N,)))
        ptrs = [0] * _N_PTRS
        ptrs[_PRIOR_SLOT:_PRIOR_SLOT + 2] = [t.data_ptr() for t in keep]
        slot, counts = _TABLE_SLOT, []
        for name, fields in FIELDS.items():
            table = getattr(problem, name)
            counts.append(0 if table is None else table.valid.shape[0])
            if table is not None:
                F = counts[-1]
                got = _build.kernel_inputs(
                    f"vio_factors ({name})", dev,
                    **{f: (getattr(table, f), dt,
                           tuple(F if s is None else s for s in shape))
                       for f, (dt, shape) in fields.items()})
                keep += got
                ptrs[slot:slot + len(got)] = [t.data_ptr() for t in got]
            slot += len(fields)
        self.keep, self.counts = keep, tuple(counts)
        self.S = scratch_floats(*counts)
        self.ptrs = (ctypes.c_void_p * _N_PTRS)(*ptrs)
        self.g_norm = float(problem.g_norm)

    def __call__(self, poses, vels, biases, E_T_V, Hpp, gp, cost):
        if self.kind == "cpu":
            return vio_factors_reference(self.problem, poses, vels, biases,
                                         E_T_V, Hpp, gp, cost, self.E,
                                         self.factors)
        K, N, dev = self.K, self.N, self.device
        state = _build.kernel_inputs(
            "vio_factors", dev, poses=(poses, _F32, (K, 4, 4)),
            vels=(vels, _F32, (K, 3)), biases=(biases, _F32, (K, 6)),
            E_T_V=(E_T_V, _F32, (4, 4)), Hpp=(Hpp, _F32, (6 * K, 6 * K)),
            gp=(gp, _F32, (6 * K,)), cost=(cost, _F32, ()))
        H, g, c, self.scratch = outputs.carve(_layout(N, self.S), dev)
        for k, t in enumerate(state):
            self.ptrs[k] = t.data_ptr()
        for k, t in enumerate((H, g, c, self.scratch)):
            self.ptrs[_OUT_SLOT + k] = t.data_ptr()
        lib = _build.library()
        _build.count("vio_factors")
        _build.check(lib.mc_vio_factors(
            self.ptrs, K, *self.counts, self.g_norm,
            _build.stream_ptr(dev)), "vio_factors")
        return H, g, c
