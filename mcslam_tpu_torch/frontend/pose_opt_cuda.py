"""Whole-schedule robust motion-only LM in one CUDA launch (counterpart of
mcslam_tpu/frontend/pose_opt_pallas.py optimize_pose_pallas; kernel
source csrc/pose_lm.cu).

`pose_lm` refines a batch of B initial poses against the same M
observations, each with its own mask, in one launch for CUDA tensors,
and through `pose_lm_reference`, the plain PyTorch version of the same
schedule, for CPU tensors. The two follow the same trajectory; the f32
sums over observations are taken in a different order, so they agree to
float tolerance.
"""

from __future__ import annotations

import torch

from mcslam_tpu_torch import _build

CHI2_2DOF = 5.991
MAX_ROUNDS = 4  # schedule rounds the kernel takes by value
_EPS = 1e-8


def _pack_obs(X_world, uv, cam_T_obs, fxycxy_obs, inv_sig2) -> torch.Tensor:
    """(22, M) f32 SoA observation rows: X (3), uv (2), camera rotation
    (9, row-major), camera translation (3), fx fy cx cy, 1/sigma^2."""
    f = torch.float32
    return torch.cat([
        X_world.to(f).T, uv.to(f).T,
        cam_T_obs[:, :3, :3].to(f).reshape(-1, 9).T,
        cam_T_obs[:, :3, 3].to(f).T, fxycxy_obs.to(f).T,
        inv_sig2.to(f)[None],
    ], dim=0).contiguous()


def _so3_exp_s(w0, w1, w2):
    """Rodrigues on (B,) components -> 9 rotation entries (row-major),
    with the small-angle series of lie.so3_exp."""
    t2 = w0 * w0 + w1 * w1 + w2 * w2
    small = t2 < _EPS
    th = torch.sqrt(torch.where(small, torch.ones_like(t2), t2))
    a = torch.where(small, 1.0 - t2 / 6.0 + t2 * t2 / 120.0,
                    torch.sin(th) / th)
    b = torch.where(small, 0.5 - t2 / 24.0 + t2 * t2 / 720.0,
                    (1.0 - torch.cos(th)) / (th * th))
    ww0, ww1, ww2 = w0 * w0, w1 * w1, w2 * w2
    return (1.0 + b * (-(ww1 + ww2)), -a * w2 + b * (w0 * w1),
            a * w1 + b * (w0 * w2),
            a * w2 + b * (w0 * w1), 1.0 + b * (-(ww0 + ww2)),
            -a * w0 + b * (w1 * w2),
            -a * w1 + b * (w0 * w2), a * w0 + b * (w1 * w2),
            1.0 + b * (-(ww0 + ww1)))


def _so3_left_jac_s(w0, w1, w2):
    t2 = w0 * w0 + w1 * w1 + w2 * w2
    small = t2 < _EPS
    th = torch.sqrt(torch.where(small, torch.ones_like(t2), t2))
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(th)) / (th * th))
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                    (th - torch.sin(th)) / (th * th * th))
    ww0, ww1, ww2 = w0 * w0, w1 * w1, w2 * w2
    return (1.0 + c * (-(ww1 + ww2)), -b * w2 + c * (w0 * w1),
            b * w1 + c * (w0 * w2),
            b * w2 + c * (w0 * w1), 1.0 + c * (-(ww0 + ww2)),
            -b * w0 + c * (w1 * w2),
            -b * w1 + c * (w0 * w2), b * w0 + c * (w1 * w2),
            1.0 + c * (-(ww0 + ww1)))


def _retract_s(R, t, xi):
    E = _so3_exp_s(xi[0], xi[1], xi[2])
    J = _so3_left_jac_s(xi[0], xi[1], xi[2])
    v0, v1, v2 = xi[3], xi[4], xi[5]
    te = [J[3 * i] * v0 + J[3 * i + 1] * v1 + J[3 * i + 2] * v2
          for i in range(3)]
    Rn = [R[3 * i + 0] * E[j] + R[3 * i + 1] * E[3 + j]
          + R[3 * i + 2] * E[6 + j] for i in range(3) for j in range(3)]
    tn = [R[3 * i] * te[0] + R[3 * i + 1] * te[1] + R[3 * i + 2] * te[2]
          + t[i] for i in range(3)]
    return Rn, tn


def _chol_solve6_s(H, g):
    """H: dict {(i, j): (B,)} lower triangle; g: 6 (B,) -> x (6 (B,))."""
    L = {}
    for i in range(6):
        for j in range(i + 1):
            s = H[(i, j)]
            for kk in range(j):
                s = s - L[(i, kk)] * L[(j, kk)]
            if i == j:
                L[(i, j)] = torch.sqrt(torch.clamp(s, min=1e-12))
            else:
                L[(i, j)] = s / L[(j, j)]
    y = []
    for i in range(6):
        s = g[i]
        for kk in range(i):
            s = s - L[(i, kk)] * y[kk]
        y.append(s / L[(i, i)])
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for kk in range(i + 1, 6):
            s = s - L[(kk, i)] * x[kk]
        x[i] = s / L[(i, i)]
    return x


def _residuals(R, t, d):
    """R 9 (B, 1), t 3 (B, 1) components; d (22, M) rows -> (r0, r1, q,
    p, iz) each (B, M)."""
    e0, e1, e2 = d[0] - t[0], d[1] - t[1], d[2] - t[2]
    q0 = R[0] * e0 + R[3] * e1 + R[6] * e2
    q1 = R[1] * e0 + R[4] * e1 + R[7] * e2
    q2 = R[2] * e0 + R[5] * e1 + R[8] * e2
    p0 = d[5] * q0 + d[6] * q1 + d[7] * q2 + d[14]
    p1 = d[8] * q0 + d[9] * q1 + d[10] * q2 + d[15]
    p2 = d[11] * q0 + d[12] * q1 + d[13] * q2 + d[16]
    iz = 1.0 / torch.clamp(p2, min=1e-3)
    r0 = p0 * iz * d[17] + d[19] - d[3]
    r1 = p1 * iz * d[18] + d[20] - d[4]
    return r0, r1, (q0, q1, q2), (p0, p1), iz


def _linearize(R, t, d, active, huber_px):
    r0, r1, (q0, q1, q2), (p0, p1), iz = _residuals(R, t, d)
    fx, fy = d[17], d[18]
    jp00, jp02 = fx * iz, -fx * p0 * iz * iz
    jp11, jp12 = fy * iz, -fy * p1 * iz * iz
    a00 = jp00 * d[5] + jp02 * d[11]
    a01 = jp00 * d[6] + jp02 * d[12]
    a02 = jp00 * d[7] + jp02 * d[13]
    a10 = jp11 * d[8] + jp12 * d[11]
    a11 = jp11 * d[9] + jp12 * d[12]
    a12 = jp11 * d[10] + jp12 * d[13]
    j0 = (a01 * q2 - a02 * q1, -a00 * q2 + a02 * q0, a00 * q1 - a01 * q0,
          -a00, -a01, -a02)
    j1 = (a11 * q2 - a12 * q1, -a10 * q2 + a12 * q0, a10 * q1 - a11 * q0,
          -a10, -a11, -a12)
    rn = torch.sqrt(r0 * r0 + r1 * r1)
    w_huber = torch.where(rn <= huber_px, torch.ones_like(rn),
                          huber_px / torch.clamp(rn, min=1e-9))
    w = w_huber * d[21] * active
    H = {}
    for i in range(6):
        for j in range(i + 1):
            H[(i, j)] = torch.sum(w * (j0[i] * j0[j] + j1[i] * j1[j]), -1,
                                  keepdim=True)
    g = [torch.sum(w * (j0[i] * r0 + j1[i] * r1), -1, keepdim=True)
         for i in range(6)]
    cost = torch.sum(w * (r0 * r0 + r1 * r1), -1, keepdim=True)
    return H, g, cost


def pose_lm_reference(T_init, data, mask, sched, huber_px=2.5,
                      chi2_thresh=CHI2_2DOF, lm_lambda=1e-3):
    """Plain PyTorch version. T_init (B, 4, 4); data (22, M) packed rows
    (_pack_obs); mask (B, M) f32 0/1 -> (T (B, 4, 4), chi2 (B, M))."""
    B = T_init.shape[0]
    T = T_init.to(torch.float32)
    R = [T[:, i, j, None] for i in range(3) for j in range(3)]  # (B, 1)
    t = [T[:, i, 3, None] for i in range(3)]
    active = mask
    for n_iters in sched:
        H, g, cst = _linearize(R, t, data, active, huber_px)
        lam = torch.full((B, 1), lm_lambda, dtype=torch.float32,
                         device=T.device)
        for _ in range(n_iters):
            Hlm = dict(H)
            for i in range(6):
                Hlm[(i, i)] = H[(i, i)] + lam
            xi = [-x for x in _chol_solve6_s(Hlm, g)]
            R_t, t_t = _retract_s(R, t, xi)
            H_t, g_t, c_t = _linearize(R_t, t_t, data, active, huber_px)
            imp = c_t < cst

            def pick(a, b):
                return torch.where(imp, a, b)

            R = [pick(a, b) for a, b in zip(R_t, R)]
            t = [pick(a, b) for a, b in zip(t_t, t)]
            H = {k: pick(H_t[k], H[k]) for k in H}
            g = [pick(a, b) for a, b in zip(g_t, g)]
            cst = pick(c_t, cst)
            lam = torch.where(imp, lam * 0.5, lam * 4.0)
        r0, r1 = _residuals(R, t, data)[:2]
        chi2 = (r0 * r0 + r1 * r1) * data[21]
        active = mask * (chi2 < chi2_thresh).to(torch.float32)
    r0, r1 = _residuals(R, t, data)[:2]
    chi2 = (r0 * r0 + r1 * r1) * data[21]
    zero = torch.zeros_like(R[0])
    one = torch.ones_like(R[0])
    T_out = torch.cat([R[0], R[1], R[2], t[0], R[3], R[4], R[5], t[1],
                       R[6], R[7], R[8], t[2], zero, zero, zero, one],
                      dim=-1).reshape(B, 4, 4)
    return T_out, chi2


def pose_lm(T_init, data, mask, sched, huber_px=2.5, chi2_thresh=CHI2_2DOF,
            lm_lambda=1e-3):
    """T_init (B, 4, 4), data (22, M) from _pack_obs, mask (B, M) f32 0/1,
    sched a tuple of at most MAX_ROUNDS per-round iteration counts -> (T
    (B, 4, 4), chi2 (B, M)). CUDA tensors launch the kernel (one cluster
    of CTAs per candidate; the schedule goes by value); CPU tensors take
    the plain version."""
    if T_init.device.type == "cpu":
        return pose_lm_reference(T_init, data, mask, sched, huber_px,
                                 chi2_thresh, lm_lambda)
    dev = T_init.device
    if dev.type != "cuda":
        raise ValueError(f"pose_lm: unsupported device {dev}")
    B = T_init.shape[0]
    M = data.shape[1]
    for name, v, shape in (("T_init", T_init, (B, 4, 4)),
                           ("data", data, (22, M)), ("mask", mask, (B, M))):
        if (v.device != dev or v.dtype != torch.float32
                or tuple(v.shape) != shape or not v.is_contiguous()):
            raise ValueError(f"pose_lm: {name} must be a contiguous {shape} "
                             f"float32 tensor on {dev}, got "
                             f"{tuple(v.shape)} {v.dtype} {v.device}")
    iters = [int(n) for n in sched]
    if len(iters) > MAX_ROUNDS or min(iters, default=0) < 0:
        raise ValueError(f"pose_lm: schedule {tuple(sched)} must have at most "
                         f"{MAX_ROUNDS} non-negative round lengths")
    lib = _build.library()
    if lib.mc_pose_lm_smem(M) < 0:
        raise ValueError(f"pose_lm: M={M} observations do not fit one "
                         f"cluster's shared memory")
    T_out = torch.empty(B, 4, 4, dtype=torch.float32, device=dev)
    chi2 = torch.empty(B, M, dtype=torch.float32, device=dev)
    _build.count("pose_lm")
    _build.check(lib.mc_pose_lm(
        T_init.data_ptr(), data.data_ptr(), mask.data_ptr(),
        T_out.data_ptr(), chi2.data_ptr(), B, M, len(iters),
        *(iters + [0] * (MAX_ROUNDS - len(iters))), float(huber_px),
        float(chi2_thresh), float(lm_lambda), _build.stream_ptr(dev),
    ), "mc_pose_lm")
    return T_out, chi2
