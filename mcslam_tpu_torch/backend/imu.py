"""On-manifold IMU preintegration (counterpart of mcslam_tpu/backend/imu.py,
Forster et al. / the CombinedImuFactor math): delta rotation, velocity and
position between keyframes with first-order bias Jacobians and 9x9
covariance propagation, turned into a 15-dof factor (9 preintegration +
6 bias random walk).

Every function computes on its inputs' device in float32. The JAX
package integrates with one masked lax.scan; here the per-sample
quantities are computed batched and the recurrence is a Python loop over
the S samples. The SLAM driver hands these functions CPU tensors: its
sample buffer and the values it reads back live on the host, and S is
small (tens of samples per span), so on the card the loop would be
hundreds of launches and a sync per frame.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mcslam_tpu_torch.geometry import alignment, lie

GRAVITY = 9.81


class ImuParams(NamedTuple):
    accel_noise: float = 0.01  # sigma [m/s^2/sqrt(Hz)] discrete-equivalent
    gyro_noise: float = 0.001  # sigma [rad/s/sqrt(Hz)]
    accel_walk: float = 1e-4
    gyro_walk: float = 1e-5
    g_norm: float = GRAVITY
    integration_sigma: float = 1e-4


class Preintegrated(NamedTuple):
    dR: torch.Tensor  # (3, 3)
    dv: torch.Tensor  # (3,)
    dp: torch.Tensor  # (3,)
    dt: torch.Tensor  # () total time
    # first-order bias Jacobians
    dR_dbg: torch.Tensor  # (3, 3)
    dv_dbg: torch.Tensor  # (3, 3)
    dv_dba: torch.Tensor  # (3, 3)
    dp_dbg: torch.Tensor  # (3, 3)
    dp_dba: torch.Tensor  # (3, 3)
    cov: torch.Tensor  # (9, 9) [theta, v, p] covariance
    bias_hat: torch.Tensor  # (6,) [bg, ba] used for integration
    n_samples: torch.Tensor  # () int32


class ImuState(NamedTuple):
    """Navigation state of one keyframe."""

    world_T_body: torch.Tensor  # (4, 4)
    vel: torch.Tensor  # (3,) world-frame velocity
    bias: torch.Tensor  # (6,) [bg, ba]


def preintegrate(dts: torch.Tensor, gyro: torch.Tensor, accel: torch.Tensor,
                 mask: torch.Tensor, bias_hat: torch.Tensor,
                 params: ImuParams = ImuParams()) -> Preintegrated:
    """dts (S,) sample intervals, gyro / accel (S, 3), mask (S,) valid
    samples, bias_hat (6,) [bg, ba] -> the preintegrated deltas. A masked
    sample is an identity step: its dt and readings are zeroed, which
    leaves every delta, Jacobian and the covariance exactly unchanged."""
    f32 = torch.float32
    dev = dts.device
    bias_hat = bias_hat.to(f32)
    bg, ba = bias_hat[:3], bias_hat[3:]
    sg2 = params.gyro_noise ** 2
    sa2 = params.accel_noise ** 2
    si2 = params.integration_sigma ** 2
    m = mask.to(torch.bool)
    dt = torch.where(m, dts.to(f32), 0.0)
    w = torch.where(m[:, None], gyro.to(f32), 0.0)
    a = torch.where(m[:, None], accel.to(f32), 0.0)
    # per-sample terms of the recurrence, batched
    wd = (w - bg) * dt[:, None]
    ad = a - ba
    dR_inc = lie.so3_exp(wd)
    Jr = lie.so3_left_jacobian(-wd)  # right Jacobian of wd
    ax = lie.so3_hat(ad)
    q = torch.cat([torch.full((3,), sg2, dtype=f32, device=dev),
                   torch.full((3,), sa2, dtype=f32, device=dev)])
    qs = q[None] / torch.clamp(dt, min=1e-6)[:, None]  # (S, 6) diag of Q
    eye3 = torch.eye(3, dtype=f32, device=dev)
    eye9 = torch.eye(9, dtype=f32, device=dev)
    z3 = torch.zeros(3, 3, dtype=f32, device=dev)
    dR = eye3
    dv = torch.zeros(3, dtype=f32, device=dev)
    dp = torch.zeros(3, dtype=f32, device=dev)
    t = torch.zeros((), dtype=f32, device=dev)
    dRdbg = dvdbg = dvdba = dpdbg = dpdba = z3
    cov = torch.zeros(9, 9, dtype=f32, device=dev)
    for s in range(dts.shape[0]):
        h = dt[s]
        Ra = dR @ ad[s]  # rotated accel (pre-update dR)
        dRax = dR @ ax[s]
        M = dRax @ dRdbg
        dpdbg = dpdbg + dvdbg * h - 0.5 * M * h * h
        dpdba = dpdba + dvdba * h - 0.5 * dR * h * h
        dvdbg = dvdbg - M * h
        dvdba = dvdba - dR * h
        dRdbg = dR_inc[s].T @ dRdbg - Jr[s] * h
        # covariance propagation, state [dtheta, dv, dp]
        A = torch.cat([
            torch.cat([dR_inc[s].T, z3, z3], dim=1),
            torch.cat([-dRax * h, eye3, z3], dim=1),
            torch.cat([-0.5 * dRax * h * h, eye3 * h, eye3], dim=1)])
        B = torch.cat([
            torch.cat([Jr[s] * h, z3], dim=1),
            torch.cat([z3, dR * h], dim=1),
            torch.cat([z3, 0.5 * dR * h * h], dim=1)])
        cov = A @ cov @ A.T + (B * qs[s]) @ B.T + si2 * eye9 * h
        dp = dp + dv * h + 0.5 * Ra * h * h
        dv = dv + Ra * h
        dR = dR @ dR_inc[s]
        t = t + h
    return Preintegrated(
        dR=dR, dv=dv, dp=dp, dt=t, dR_dbg=dRdbg, dv_dbg=dvdbg,
        dv_dba=dvdba, dp_dbg=dpdbg, dp_dba=dpdba, cov=cov, bias_hat=bias_hat,
        n_samples=torch.sum(m).to(torch.int32))


def gravity_vec(params: ImuParams = ImuParams(), device="cpu",
                dtype=torch.float32) -> torch.Tensor:
    # made on the device: a host tensor or a scalar setitem would be a
    # host-to-device copy (a sync) inside vio_solve's jacfwd
    return torch.eye(3, dtype=dtype, device=device)[2] * -params.g_norm


def _corrected(state_i: ImuState, pre: Preintegrated):
    """The deltas corrected to first order for state_i's bias."""
    db = state_i.bias - pre.bias_hat
    dbg, dba = db[..., :3], db[..., 3:]
    mv = lie._apply_mat
    dR = pre.dR @ lie.so3_exp(mv(pre.dR_dbg, dbg))
    dv = pre.dv + mv(pre.dv_dbg, dbg) + mv(pre.dv_dba, dba)
    dp = pre.dp + mv(pre.dp_dbg, dbg) + mv(pre.dp_dba, dba)
    return dR, dv, dp


def predict(state: ImuState, pre: Preintegrated,
            params: ImuParams = ImuParams()) -> ImuState:
    """Dead-reckon state_j from state_i with the preintegrated deltas
    (bias-corrected to first order)."""
    dR, dv, dp = _corrected(state, pre)
    R_i = state.world_T_body[..., :3, :3]
    p_i = state.world_T_body[..., :3, 3]
    g = gravity_vec(params, state.vel.device, state.vel.dtype)
    t = pre.dt[..., None]
    R_j = R_i @ dR
    v_j = state.vel + g * t + lie._apply_mat(R_i, dv)
    p_j = p_i + state.vel * t + 0.5 * g * t * t + lie._apply_mat(R_i, dp)
    return ImuState(world_T_body=lie.se3_matrix(R_j, p_j), vel=v_j,
                    bias=state.bias)


def residual(state_i: ImuState, state_j: ImuState, pre: Preintegrated,
             params: ImuParams = ImuParams()) -> torch.Tensor:
    """15-dim residual [r_dR(3), r_dv(3), r_dp(3), r_bias(6)], whitened by
    the caller with `information`."""
    dR_c, dv_c, dp_c = _corrected(state_i, pre)
    R_i = state_i.world_T_body[..., :3, :3]
    p_i = state_i.world_T_body[..., :3, 3]
    R_j = state_j.world_T_body[..., :3, :3]
    p_j = state_j.world_T_body[..., :3, 3]
    g = gravity_vec(params, state_i.vel.device, state_i.vel.dtype)
    t = pre.dt[..., None]
    RiT = R_i.transpose(-1, -2)
    r_dR = lie.so3_log(dR_c.transpose(-1, -2) @ (RiT @ R_j))
    r_dv = lie._apply_mat(RiT, state_j.vel - state_i.vel - g * t) - dv_c
    r_dp = lie._apply_mat(
        RiT, p_j - p_i - state_i.vel * t - 0.5 * g * t * t) - dp_c
    r_b = state_j.bias - state_i.bias
    return torch.cat([r_dR, r_dv, r_dp, r_b], dim=-1)


def information(pre: Preintegrated,
                params: ImuParams = ImuParams()) -> torch.Tensor:
    """(15, 15) information (inverse covariance) of `residual`."""
    f = dict(dtype=pre.cov.dtype, device=pre.cov.device)
    info9 = torch.linalg.inv_ex(pre.cov + 1e-12 * torch.eye(9, **f))[0]
    t = torch.clamp(pre.dt, min=1e-4)
    walk = torch.cat([torch.ones(3, **f) * (params.gyro_walk ** 2 * t),
                      torch.ones(3, **f) * (params.accel_walk ** 2 * t)])
    info = torch.zeros(15, 15, **f)
    info[:9, :9] = info9
    info[9:, 9:] = torch.diag(1.0 / walk)
    return info


def init_gravity_aligned(accel_samples: torch.Tensor,
                         gyro_samples: torch.Tensor, mask: torch.Tensor,
                         params: ImuParams = ImuParams()):
    """world_R_body and bias from a stationary window: the mean
    accelerometer reading aligned to +z, the mean gyro as the gyro bias,
    the accelerometer bias as the residual after gravity alignment.
    accel / gyro (S, 3), mask (S,) -> (world_R_body (3, 3), bias (6,))."""
    m = mask[:, None].to(torch.float32)
    n = torch.clamp(torch.sum(m), min=1.0)
    acc_mean = torch.sum(accel_samples * m, dim=0) / n
    gyr_mean = torch.sum(gyro_samples * m, dim=0) / n
    R_wb = alignment.gravity_align_rotation(acc_mean)
    a_world = R_wb @ acc_mean
    ba_world = a_world - torch.tensor([0.0, 0.0, params.g_norm],
                                      dtype=a_world.dtype,
                                      device=a_world.device)
    ba_body = R_wb.T @ ba_world
    return R_wb, torch.cat([gyr_mean, ba_body])
