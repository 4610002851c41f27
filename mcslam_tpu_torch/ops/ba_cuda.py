"""Window-BA linearization of a keyframe-blocked observation table in one
CUDA launch (counterpart of mcslam_tpu/ops/ba_pallas.py
linearize_payload_pallas; kernel source csrc/ba_linearize.cu).

`ba_linearize` computes, for every observation, the reprojection residual,
the analytic pose and landmark Jacobians and the Huber x 1/sigma^2 x
validity weight, and returns the 30-channel [W | Hll | gl] payload that
the landmark one-hot product of the solve consumes, plus the per-keyframe
Hpp (upper triangle mirrored) and gp sums. CUDA tensors launch the kernel;
CPU tensors take `ba_linearize_reference`, the plain PyTorch version with
the math of ba._residuals_and_jacobians_blocked.

Unlike the TPU kernel, which takes pre-gathered per-observation rows,
both versions take the landmark table and the rig tables and gather by
`obs_lm` / `obs_cam` themselves (a gather equals the JAX one-hot row
product exactly). The observation table is kf-blocked: O = K * Ok with
observation o belonging to keyframe o // Ok.
"""

from __future__ import annotations

import numpy as np
import torch

from mcslam_tpu_torch import _build

NPAY = 30  # payload channels: W (18) | Hll (9) | gl (3)


def ba_linearize_reference(rTw12, lm_pos, obs_lm, obs_cam, uv, sigma2, validf,
                           Rc9, tc, f4, huber_px: float = 2.5):
    """Plain PyTorch version. rTw12 (K, 12) ref_T_world rows [R row-major |
    t]; lm_pos (L, 3); obs_lm, obs_cam (O,) int; uv (O, 2); sigma2, validf
    (O,); Rc9 (C, 9), tc (C, 3), f4 (C, 4) rig tables -> (payload (K, 30,
    Ok), r (O, 2), w (O,), Hpp (K, 36), gp (K, 6)). Written per component
    on (K, Ok) tensors in the kernel's order of operations."""
    K = rTw12.shape[0]
    O = obs_lm.shape[0]
    Ok = O // K
    P = [rTw12[:, i, None] for i in range(12)]  # (K, 1) each
    X = lm_pos[obs_lm.long()].reshape(K, Ok, 3).unbind(-1)
    cam = obs_cam.long()
    Rc = Rc9[cam].reshape(K, Ok, 9).unbind(-1)
    t_c = tc[cam].reshape(K, Ok, 3).unbind(-1)
    fx, fy, cx, cy = f4[cam].reshape(K, Ok, 4).unbind(-1)
    u, v = uv.reshape(K, Ok, 2).unbind(-1)

    q = [P[3 * a] * X[0] + P[3 * a + 1] * X[1] + P[3 * a + 2] * X[2]
         + P[9 + a] for a in range(3)]
    p = [Rc[3 * a] * q[0] + Rc[3 * a + 1] * q[1] + Rc[3 * a + 2] * q[2]
         + t_c[a] for a in range(3)]
    inv_z = 1.0 / torch.clamp(p[2], min=1e-3)
    r0 = p[0] * inv_z * fx + cx - u
    r1 = p[1] * inv_z * fy + cy - v
    jp00, jp02 = fx * inv_z, -fx * p[0] * inv_z * inv_z
    jp11, jp12 = fy * inv_z, -fy * p[1] * inv_z * inv_z
    A = [[jp00 * Rc[b] + jp02 * Rc[6 + b] for b in range(3)],
         [jp11 * Rc[3 + b] + jp12 * Rc[6 + b] for b in range(3)]]
    # Jp = [A hat(q) | -A], Jl = A R
    Jp = [[a[1] * q[2] - a[2] * q[1], -a[0] * q[2] + a[2] * q[0],
           a[0] * q[1] - a[1] * q[0], -a[0], -a[1], -a[2]] for a in A]
    Jl = [[a[0] * P[c] + a[1] * P[3 + c] + a[2] * P[6 + c] for c in range(3)]
          for a in A]
    rn = torch.sqrt(r0 * r0 + r1 * r1)
    w_h = torch.where(rn <= huber_px, torch.ones_like(rn),
                      huber_px / torch.clamp(rn, min=1e-9))
    w = (w_h / torch.clamp(sigma2.reshape(K, Ok), min=1e-6)
         * validf.reshape(K, Ok))

    rows = []
    for i in range(6):
        a0, a1 = w * Jp[0][i], w * Jp[1][i]
        rows += [a0 * Jl[0][j] + a1 * Jl[1][j] for j in range(3)]
    for i in range(3):
        a0, a1 = w * Jl[0][i], w * Jl[1][i]
        rows += [a0 * Jl[0][j] + a1 * Jl[1][j] for j in range(3)]
    rows += [(w * r0) * Jl[0][i] + (w * r1) * Jl[1][i] for i in range(3)]
    H = [[None] * 6 for _ in range(6)]
    g = []
    for i in range(6):
        a0, a1 = w * Jp[0][i], w * Jp[1][i]
        for j in range(i, 6):
            H[i][j] = H[j][i] = torch.sum(a0 * Jp[0][j] + a1 * Jp[1][j], -1)
        g.append(torch.sum(a0 * r0 + a1 * r1, -1))
    return (torch.stack(rows, dim=1), torch.stack([r0, r1], -1).reshape(O, 2),
            w.reshape(O), torch.stack([h for row in H for h in row], -1),
            torch.stack(g, -1))


class Linearizer:
    """ba_linearize prepared for one solve: the constant tables (obs_lm,
    obs_cam, uv, sigma2, Rc9, tc, f4) are checked once here, and each call
    checks only rTw12, lm_pos and validf and allocates its five outputs as
    views of one buffer. CUDA tables launch the kernel, on the CUDA stream
    that was current when the call was prepared (ba_solve prepares it
    under the stream it solves on); CPU tables take the plain version."""

    def __init__(self, obs_lm, obs_cam, uv, sigma2, Rc9, tc, f4, K: int,
                 L: int, huber_px: float = 2.5):
        self.consts = (obs_lm, obs_cam, uv, sigma2, Rc9, tc, f4)
        self.huber = float(huber_px)
        dev = obs_lm.device
        self.device = dev
        if dev.type == "cpu":
            return
        if dev.type != "cuda":
            raise ValueError(f"ba_linearize: unsupported device {dev}")
        O, C = obs_lm.shape[0], Rc9.shape[0]
        if K == 0 or O % K:
            raise ValueError(f"ba_linearize: O ({O}) must be a positive "
                             f"multiple of K ({K}) (kf-blocked layout)")
        if C < 1 or L < 1:
            raise ValueError(f"ba_linearize: needs C >= 1 cameras and L >= 1 "
                             f"landmarks, got C={C}, L={L}")
        f32, i32 = torch.float32, torch.int32
        for name, v, shape, dt in (
                ("obs_lm", obs_lm, (O,), i32), ("obs_cam", obs_cam, (O,), i32),
                ("uv", uv, (O, 2), f32), ("sigma2", sigma2, (O,), f32),
                ("Rc9", Rc9, (C, 9), f32), ("tc", tc, (C, 3), f32),
                ("f4", f4, (C, 4), f32)):
            _check(name, v, shape, dt, dev)
        self.K, self.L, self.O, self.C, self.Ok = K, L, O, C, O // K
        self.ptrs = tuple(v.data_ptr() for v in self.consts)
        self.stream = _build.stream_ptr(dev)
        Ok = self.Ok
        # the outputs as (shape, stride, offset) views of one buffer:
        # payload | r | w | Hpp | gp
        views, off = [], 0
        for shape in ((K, NPAY, Ok), (O, 2), (O,), (K, 36), (K, 6)):
            stride = tuple(int(np.prod(shape[i + 1:]))
                           for i in range(len(shape)))
            views.append((shape, stride, off))
            off += int(np.prod(shape))
        self.views, self.numel = tuple(views), off

    def __call__(self, rTw12, lm_pos, validf):
        """(rTw12 (K, 12), lm_pos (L, 3), validf (O,)) -> (payload (K, 30,
        Ok), r (O, 2), w (O,), Hpp (K, 36), gp (K, 6))."""
        if self.device.type == "cpu":
            return ba_linearize_reference(rTw12, lm_pos, *self.consts[:4],
                                          validf, *self.consts[4:],
                                          self.huber)
        f32, dev = torch.float32, self.device
        _check("rTw12", rTw12, (self.K, 12), f32, dev)
        _check("lm_pos", lm_pos, (self.L, 3), f32, dev)
        _check("validf", validf, (self.O,), f32, dev)
        buf = torch.empty(self.numel, dtype=f32, device=dev)
        outs = tuple(buf.as_strided(*v) for v in self.views)
        base = buf.data_ptr()
        lm, cam, uv, s2, Rc, tc, f4 = self.ptrs
        lib = _build.library()
        _build.count("ba_linearize")
        _build.check(lib.mc_ba_linearize(
            rTw12.data_ptr(), lm_pos.data_ptr(), lm, cam, uv, s2,
            validf.data_ptr(), Rc, tc, f4, *(base + 4 * off for *_, off in
                                              self.views),
            self.K, self.Ok, self.L, self.C, self.huber, self.stream,
        ), "mc_ba_linearize")
        return outs


def _check(name, v, shape, dt, dev):
    if (v.device != dev or v.dtype != dt or tuple(v.shape) != shape
            or not v.is_contiguous()):
        raise ValueError(f"ba_linearize: {name} must be a contiguous "
                         f"{shape} {dt} tensor on {dev}, got "
                         f"{tuple(v.shape)} {v.dtype} {v.device}")


def ba_linearize(rTw12, lm_pos, obs_lm, obs_cam, uv, sigma2, validf, Rc9, tc,
                 f4, huber_px: float = 2.5):
    """See ba_linearize_reference for shapes. CUDA tensors launch the
    kernel (float32 and int32, contiguous, one device); CPU tensors take
    the plain version. A solve that linearizes repeatedly prepares the
    call once (Linearizer)."""
    return Linearizer(obs_lm, obs_cam, uv, sigma2, Rc9, tc, f4,
                      rTw12.shape[0], lm_pos.shape[0], huber_px)(
        rTw12, lm_pos, validf)
