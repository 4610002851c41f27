"""Synthetic multi-camera rig, trajectories (smooth arc, closed loop, pan
shake), landmarks (slab, ring), blob images (plain or textured), the
ray-cast textured world with photometric corruption, and feature-level
frames (numpy counterpart of the generators in
mcslam_tpu/data/synthetic.py, projecting through the port's camera
model). Same seeds give the same scene as the JAX package's generators."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mcslam_tpu_torch.geometry import camera as cam_ops


class SyntheticRigSpec(NamedTuple):
    num_cams: int = 4
    image_size: tuple = (640, 480)
    focal: float = 400.0
    baseline: float = 0.12  # spacing between cameras along +x
    dist: tuple | None = None  # distortion coefficients (all cameras)
    dist_model: int | None = None  # camera.DIST_* (requires dist)


def make_synthetic_rig(spec: SyntheticRigSpec = SyntheticRigSpec(),
                       device="cuda") -> cam_ops.CameraRig:
    n = spec.num_cams
    w, h = spec.image_size
    fxycxy = np.tile(
        np.array([[spec.focal, spec.focal, w / 2.0, h / 2.0]], np.float32),
        (n, 1),
    )
    cam_T_ref = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        cam_T_ref[i, 0, 3] = -spec.baseline * i  # camera i at +x*i
    if spec.dist is not None:
        dist = np.tile(np.asarray(spec.dist, np.float32)[None], (n, 1))
        model = (spec.dist_model if spec.dist_model is not None
                 else cam_ops.DIST_RADTAN)
        return cam_ops.make_rig(fxycxy, dist=dist, cam_T_ref=cam_T_ref,
                                image_size=spec.image_size,
                                dist_model=model, device=device)
    return cam_ops.make_rig(fxycxy, dist=None, cam_T_ref=cam_T_ref,
                            image_size=spec.image_size, device=device)


def smooth_trajectory(num_frames: int, radius: float = 4.0,
                      height: float = 0.0, step_angle: float = 0.02,
                      seed: int = 0) -> np.ndarray:
    """(num_frames, 4, 4) float32 world_T_ref poses along a smooth arc,
    facing tangentially, with a small random-walk jitter."""
    rng = np.random.RandomState(seed)
    poses = np.zeros((num_frames, 4, 4), np.float32)
    jitter = rng.randn(num_frames, 3).cumsum(axis=0) * 0.001
    for k in range(num_frames):
        a = step_angle * k
        pos = np.array(
            [radius * np.sin(a), height + 0.2 * np.sin(2 * a),
             -radius * np.cos(a)], np.float64,
        ) + jitter[k]
        cy, sy = np.cos(a), np.sin(a)
        poses[k, :3, :3] = np.array(
            [[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float64
        )
        poses[k, :3, 3] = pos
        poses[k, 3, 3] = 1.0
    return poses


def loop_trajectory(num_frames: int, radius: float = 5.0,
                    revisit_frames: int = 6, seed: int = 0,
                    drift: float = 0.0) -> np.ndarray:
    """(num_frames, 4, 4) float32 closed circular trajectory: the camera
    rides a circle of `radius` facing tangentially, completes one turn in
    num_frames - revisit_frames frames, then re-traverses the start (the
    geometry of the loop-closure scenes; pair with make_ring_landmarks)."""
    rng = np.random.RandomState(seed)
    n_circle = num_frames - revisit_frames
    poses = np.zeros((num_frames, 4, 4), np.float32)
    jitter = rng.randn(num_frames, 3).cumsum(axis=0) * 0.0005
    for k in range(num_frames):
        a = 2.0 * np.pi * k / n_circle
        pos = np.array(
            [radius * np.sin(a), 0.1 * np.sin(3 * a), -radius * np.cos(a)],
            np.float64,
        ) + jitter[k] + drift * k * np.array([0.0, 0.001, 0.0])
        yaw = np.pi / 2 - a  # camera +z along the direction of travel
        cy, sy = np.cos(yaw), np.sin(yaw)
        poses[k, :3, :3] = np.array(
            [[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float64)
        poses[k, :3, 3] = pos
        poses[k, 3, 3] = 1.0
    return poses


def make_ring_landmarks(num: int, radius: float = 11.0, seed: int = 1,
                        y_spread: float = 4.0,
                        radial_spread: float = 3.0) -> np.ndarray:
    """(num, 3) float32 landmarks on an annulus around the origin (a
    camera riding loop_trajectory's inner circle always sees the stretch
    of ring ahead of it)."""
    rng = np.random.RandomState(seed)
    theta = rng.uniform(0, 2 * np.pi, num)
    r = radius + rng.uniform(-radial_spread, radial_spread, num)
    y = rng.uniform(-y_spread / 2, y_spread / 2, num)
    return np.stack([r * np.sin(theta), y, -r * np.cos(theta)],
                    axis=-1).astype(np.float32)


def make_landmarks(num: int, seed: int = 1, depth_range=(4.0, 14.0),
                   spread=(12.0, 6.0)) -> np.ndarray:
    """(num, 3) float32 landmarks in a slab in front of the trajectory."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-spread[0], spread[0], num)
    y = rng.uniform(-spread[1] / 2, spread[1] / 2, num)
    z = rng.uniform(depth_range[0], depth_range[1], num)
    return np.stack([x, y, z], axis=-1).astype(np.float32)


def make_descriptors(num: int, seed: int = 2) -> np.ndarray:
    """(num, 8) uint32 random 256-bit descriptors."""
    rng = np.random.RandomState(seed)
    return rng.randint(0, 1 << 32, (num, 8), dtype=np.uint64).astype(np.uint32)


def corrupt_descriptors(desc: np.ndarray, bits_to_flip: int,
                        rng) -> np.ndarray:
    """Flip `bits_to_flip` random bits in each descriptor (observation
    noise)."""
    out = desc.copy()
    n = desc.shape[0]
    for _ in range(bits_to_flip):
        word = rng.randint(0, 8, n)
        bit = rng.randint(0, 32, n).astype(np.uint32)
        out[np.arange(n), word] ^= (np.uint32(1) << bit)
    return out


class FeatureLevelFrame(NamedTuple):
    """Per-camera synthetic observations for one multi-camera frame."""

    uv: np.ndarray  # (C, K, 2) pixel observations (noisy)
    desc: np.ndarray  # (C, K, 8) observed descriptors (bit-noisy), uint32
    lm_id: np.ndarray  # (C, K) int32 true landmark id (for diagnostics)
    valid: np.ndarray  # (C, K) bool
    world_T_ref: np.ndarray  # (4, 4) ground-truth pose
    timestamp: float


def render_feature_frames(rig: cam_ops.CameraRig, poses: np.ndarray,
                          landmarks: np.ndarray, descriptors: np.ndarray,
                          kps_per_cam: int = 512, px_noise: float = 0.4,
                          desc_bit_noise: int = 6, fps: float = 20.0,
                          seed: int = 3, max_depth: float = float("inf")):
    """A FeatureLevelFrame per pose: each camera observes up to
    kps_per_cam visible landmarks (projected without distortion, 5 px
    inside the image, nearer than max_depth) with pixel noise and flipped
    descriptor bits. Same seeds, same frames as the JAX package."""
    rng = np.random.RandomState(seed)
    C = rig.num_cams
    frames = []
    fxycxy = rig.fxycxy.cpu().numpy()
    cam_T_ref = rig.cam_T_ref.cpu().numpy()
    w, h = rig.image_size
    for k, wTr in enumerate(poses):
        uv_all = np.zeros((C, kps_per_cam, 2), np.float32)
        d_all = np.zeros((C, kps_per_cam, 8), np.uint32)
        id_all = np.full((C, kps_per_cam), -1, np.int32)
        v_all = np.zeros((C, kps_per_cam), bool)
        rTw = np.linalg.inv(wTr)
        for c in range(C):
            cTw = cam_T_ref[c] @ rTw
            p = landmarks @ cTw[:3, :3].T + cTw[:3, 3]
            z = p[:, 2]
            uv = p[:, :2] / np.maximum(z[:, None], 1e-6) * fxycxy[c, :2] \
                + fxycxy[c, 2:]
            vis = (z > 0.3) & (z < max_depth) & (uv[:, 0] >= 5) & \
                (uv[:, 0] < w - 5) & (uv[:, 1] >= 5) & (uv[:, 1] < h - 5)
            vis_idx = np.nonzero(vis)[0]
            rng.shuffle(vis_idx)
            take = vis_idx[:kps_per_cam]
            nk = len(take)
            uv_all[c, :nk] = uv[take] + rng.randn(nk, 2) * px_noise
            d_all[c, :nk] = corrupt_descriptors(descriptors[take],
                                                desc_bit_noise, rng)
            id_all[c, :nk] = take
            v_all[c, :nk] = True
        frames.append(FeatureLevelFrame(
            uv=uv_all, desc=d_all, lm_id=id_all, valid=v_all,
            world_T_ref=wTr.astype(np.float32), timestamp=k / fps))
    return frames


def render_blob_images(rig: cam_ops.CameraRig, poses: np.ndarray,
                       landmarks: np.ndarray,
                       blob_intensity: np.ndarray | None = None,
                       seed: int = 4, textured: bool = False) -> np.ndarray:
    """(F, C, H, W) float32 images: each visible landmark is a square blob
    (half-size 18/z px) on low-amplitude noise. `textured=True` stamps a
    fixed per-landmark random 17x17 texture (half-size at most 8) instead of
    a constant intensity, so each landmark has a distinctive BRIEF
    signature (image-level place recognition needs that; uniform blobs all
    look alike to a descriptor). The random draws come in the JAX
    generator's order, so a seed gives the same images."""
    rng = np.random.RandomState(seed)
    C = rig.num_cams
    w, h = rig.image_size
    if blob_intensity is None:
        blob_intensity = rng.uniform(0.4, 1.0, len(landmarks)).astype(
            np.float32)
    tex = None
    if textured:
        tex = rng.uniform(0.25, 1.0, (len(landmarks), 17, 17)).astype(
            np.float32)
    fxycxy = rig.fxycxy.cpu().numpy()
    cam_T_ref = rig.cam_T_ref.cpu().numpy()
    dist = rig.dist.cpu()
    out = np.zeros((len(poses), C, h, w), np.float32)
    base = rng.rand(h, w).astype(np.float32) * 0.02
    for k, wTr in enumerate(poses):
        rTw = np.linalg.inv(wTr)
        for c in range(C):
            cTw = cam_T_ref[c] @ rTw
            p = landmarks @ cTw[:3, :3].T + cTw[:3, 3]
            z = p[:, 2]
            xn = p[:, :2] / np.maximum(z[:, None], 1e-6)
            if rig.dist_model != cam_ops.DIST_NONE:
                xn = cam_ops.distort(
                    torch.from_numpy(np.ascontiguousarray(xn)), dist[c],
                    rig.dist_model,
                ).numpy()
            uv = xn * fxycxy[c, :2] + fxycxy[c, 2:]
            img = base.copy()
            vis = (z > 0.3) & (uv[:, 0] >= 4) & (uv[:, 0] < w - 4) & \
                (uv[:, 1] >= 4) & (uv[:, 1] < h - 4)
            for i in np.nonzero(vis)[0]:
                x, y = int(round(uv[i, 0])), int(round(uv[i, 1]))
                s = max(1, int(round(3.0 * 6.0 / z[i])))
                if textured:
                    s = min(s, 8)  # texture stamps are 17x17
                y0, y1 = max(y - s, 0), min(y + s + 1, h)
                x0, x1 = max(x - s, 0), min(x + s + 1, w)
                if textured:
                    img[y0:y1, x0:x1] = (tex[i][:y1 - y0, :x1 - x0]
                                         * blob_intensity[i])
                else:
                    img[y0:y1, x0:x1] = blob_intensity[i]
            out[k, c] = img
    return out


def _circle_profile(t, omega, t0, ramp):
    """Piecewise yaw profile: stationary until t0, a constant angular
    acceleration ramp of duration `ramp`, then the constant rate omega ->
    (theta, dtheta, ddtheta), all exact."""
    t = np.asarray(t, np.float64)
    t1 = t - t0
    if ramp <= 1e-8:  # no ramp: constant rate from t0 on
        theta = np.where(t1 < 0.0, 0.0, omega * t1)
        dtheta = np.where(t1 < 0.0, 0.0, omega)
        return theta, dtheta, np.zeros_like(theta)
    theta = np.where(
        t1 <= 0.0, 0.0,
        np.where(t1 < ramp, omega * t1 * t1 / (2.0 * ramp),
                 omega * (t1 - ramp / 2.0)))
    dtheta = np.where(
        t1 <= 0.0, 0.0, np.where(t1 < ramp, omega * t1 / ramp, omega))
    ddtheta = np.where((t1 > 0.0) & (t1 < ramp), omega / ramp, 0.0)
    return theta, dtheta, ddtheta


def analytic_circle_imu(num_frames: int, fps: float = 20.0,
                        rate_hz: float = 200.0, radius: float = 4.0,
                        omega: float = 0.3, accel_noise: float = 0.0,
                        gyro_noise: float = 0.0, accel_bias=(0.0, 0.0, 0.0),
                        gyro_bias=(0.0, 0.0, 0.0), gravity: float = 9.81,
                        stationary_s: float = 0.0, ramp_s: float = 0.0,
                        seed: int = 5):
    """Circular trajectory with exact IMU samples: the body yaws about +y
    with the profile of _circle_profile (stationary, ramp, constant rate)
    while moving along p = radius (sin theta, 0, -cos theta); velocity and
    acceleration are the profile's closed-form derivatives. Gravity is
    -z in the world. Returns (poses (F, 4, 4) at the frame times, imu_ts
    (S,) at interval midpoints, gyro (S, 3), accel (S, 3)). Same seed,
    same samples as the JAX package's generator."""
    rng = np.random.RandomState(seed)
    g_world = np.array([0.0, 0.0, -gravity])

    def roty(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)

    def state(t):
        th, dth, ddth = _circle_profile(t, omega, stationary_s,
                                        max(ramp_s, 1e-9))
        s, c = np.sin(th), np.cos(th)
        p = radius * np.array([s, 0.0, -c])
        dp_dth = radius * np.array([c, 0.0, s])
        d2p_dth2 = radius * np.array([-s, 0.0, c])
        a = d2p_dth2 * dth * dth + dp_dth * ddth
        return roty(th), p, a, dth

    poses = np.zeros((num_frames, 4, 4), np.float32)
    for k in range(num_frames):
        R, p, _, _ = state(k / fps)
        poses[k, :3, :3] = R
        poses[k, :3, 3] = p
        poses[k, 3, 3] = 1.0
    dt = 1.0 / rate_hz
    n = int(round((num_frames - 1) / fps / dt))
    ts = (np.arange(n) + 0.5) * dt
    gyro = np.zeros((n, 3))
    accel = np.zeros((n, 3))
    for i, t in enumerate(ts):
        R, _, a_world, dth = state(t)
        gyro[i] = np.array([0.0, dth, 0.0]) + np.asarray(gyro_bias) \
            + rng.randn(3) * gyro_noise
        accel[i] = R.T @ (a_world - g_world) + np.asarray(accel_bias) \
            + rng.randn(3) * accel_noise
    return poses, ts, gyro, accel


def circle_velocity(t, radius=4.0, omega=0.3, stationary_s=0.0, ramp_s=0.0):
    """Closed-form world velocity of analytic_circle_imu at time t."""
    th, dth, _ = _circle_profile(t, omega, stationary_s, max(ramp_s, 1e-9))
    return radius * dth * np.array([np.cos(th), 0.0, np.sin(th)])


def random_vio_problem(rig: cam_ops.CameraRig, num_kfs: int = 6,
                       num_lms: int = 2048, obs_capacity: int = 8192,
                       num_gps: int = 0, seed: int = 0,
                       px_noise: float = 0.5, pose_noise: float = 0.01,
                       outlier_frac: float = 0.05) -> dict:
    """A consistent visual-inertial window at bench.py's stage D shape, as
    the keyword arguments of backend.ba_vio.problem_from_numpy (numpy
    fields and factor tables on the rig's device).

    K keyframes 0.2 s apart along analytic_circle_imu's circle (radius 4
    m, 0.35 rad/s; the body is the rig's reference frame), joined by K - 1
    IMU factors preintegrated from its 200 Hz samples (40 per gap, noise
    2e-3 / 2e-4, zero bias); L landmarks in a slab ahead; a kf-blocked
    table of obs_capacity // K observations per keyframe with random
    cameras and landmarks, the projections plus N(0, px_noise) noise,
    outlier_frac of them moved 30-120 px, those behind a camera invalid;
    every pose but the first perturbed by pose_noise and the velocities by
    0.05 m/s. num_gps > 0 adds that many GPS factors on keyframes 0, 1, ...
    (every third one invalid) of an ENU frame turned 0.3 rad about z, with
    0.05 m noise and sigma 0.1. The priors are the driver's: 1e6 on pose
    0, 1 on its velocity, 1e5 on its bias, E_T_V clamped at 1e8 without
    GPS and its rotation pinned at 1e8 with it."""
    from mcslam_tpu_torch.backend import ba_vio
    from mcslam_tpu_torch.backend import imu as imu_mod
    from mcslam_tpu_torch.backend.ba import BAObservations
    from mcslam_tpu_torch.geometry import lie

    rng = np.random.RandomState(seed)
    K, L, C, D = num_kfs, num_lms, rig.num_cams, ba_vio.D
    Ok = obs_capacity // K
    O = Ok * K
    poses, ts, gyro, acc = analytic_circle_imu(
        (K - 1) * 4 + 1, fps=20.0, radius=4.0, omega=0.35,
        accel_noise=2e-3, gyro_noise=2e-4, seed=seed + 1)
    kf_t = np.arange(K) * 0.2
    gt = poses[::4].astype(np.float64)
    preints = []
    for k in range(K - 1):
        sel = (ts > kf_t[k]) & (ts <= kf_t[k + 1])
        dts = np.clip(np.diff(ts[sel], prepend=kf_t[k]), 1e-4, 0.1)
        preints.append(imu_mod.preintegrate(
            *(torch.from_numpy(np.asarray(a, np.float32))
              for a in (dts, gyro[sel], acc[sel])),
            torch.ones(int(sel.sum()), dtype=torch.bool), torch.zeros(6)))
    imu = ba_vio.make_imu_factors(preints, [(k, k + 1) for k in range(K - 1)],
                                  K - 1, device=rig.device)
    lms = np.stack([rng.uniform(-6, 6, L), rng.uniform(-2, 2, L),
                    rng.uniform(2, 12, L)], 1).astype(np.float32)
    kf = np.repeat(np.arange(K, dtype=np.int32), Ok)
    cam = rng.randint(0, C, O).astype(np.int32)
    lm = rng.randint(0, L, O).astype(np.int32)
    cTr = rig.cam_T_ref.cpu().double().numpy()
    cTw = cTr[cam] @ np.linalg.inv(gt)[kf]
    p = np.einsum("oij,oj->oi", cTw[:, :3, :3], lms[lm]) + cTw[:, :3, 3]
    f = rig.fxycxy.cpu().double().numpy()[cam]
    uv = p[:, :2] / np.maximum(p[:, 2:], 1e-3) * f[:, :2] + f[:, 2:]
    uv += rng.randn(O, 2) * px_noise
    bad = rng.rand(O) < outlier_frac
    uv[bad] += rng.uniform(30, 120, (int(bad.sum()), 2))
    xi = rng.randn(K, 6) * pose_noise
    xi[0] = 0.0
    init = (torch.from_numpy(gt) @ lie.se3_exp(torch.from_numpy(xi))).float()
    vels = np.stack([circle_velocity(t, 4.0, 0.35) for t in kf_t])
    N = K * D + 6
    prior = np.zeros((N, N), np.float32)
    prior[:6, :6] = np.eye(6) * 1e6
    prior[6:9, 6:9] = np.eye(3)
    prior[9:15, 9:15] = np.eye(6) * 1e5
    E = np.eye(4, dtype=np.float32)
    E[:2, :2] = [[np.cos(0.3), -np.sin(0.3)], [np.sin(0.3), np.cos(0.3)]]
    E[:3, 3] = [5.0, -2.0, 1.0]
    gps = None
    if num_gps:
        gk = np.arange(num_gps, dtype=np.int32) % K
        enu = gt[gk, :3, 3] @ E[:3, :3].T + E[:3, 3] \
            + rng.randn(num_gps, 3) * 0.05
        gps = ba_vio.factor_table(
            ba_vio.GpsFactors, rig.device, kf=gk, enu=enu,
            t_bg=np.zeros(3), sigma=np.full(num_gps, 0.1),
            valid=np.arange(num_gps) % 3 != 2)
        prior[K * D:K * D + 3, K * D:K * D + 3] = np.eye(3) * 1e8
        prior[K * D + 3:, K * D + 3:] = np.eye(3)
    else:
        prior[K * D:, K * D:] = np.eye(6) * 1e8
    return dict(
        poses=init.numpy(),
        vels=(vels + rng.randn(K, 3) * 0.05).astype(np.float32),
        biases=np.zeros((K, 6), np.float32), landmarks=lms,
        lm_valid=np.ones(L, bool),
        obs=BAObservations(kf=kf, cam=cam, lm=lm, uv=uv.astype(np.float32),
                           sigma2=np.ones(O, np.float32), valid=p[:, 2] > 0.5),
        cam_T_body=cTr.astype(np.float32),
        fxycxy=rig.fxycxy.cpu().numpy(), E_T_V=E, prior_H=prior,
        prior_b=np.zeros(N, np.float32), kf_valid=np.ones(K, bool), imu=imu,
        gps=gps, device=rig.device)


def random_window_ba_problem(rig: cam_ops.CameraRig, num_kfs: int = 6,
                             num_lms: int = 2048, obs_capacity: int = 8192,
                             seed: int = 0, px_noise: float | None = None,
                             pose_noise: float = 0.01,
                             outlier_frac: float = 0.05,
                             step_angle: float = 0.02) -> dict:
    """A window-BA problem at bench.py's stage C shape, as the keyword
    arguments of backend.ba.problem_from_numpy (numpy fields, and the
    rig's device): K keyframes, L landmarks in a slab 2-14 m ahead, a
    kf-blocked table of obs_capacity // K observations per keyframe with
    random cameras and landmarks, unit sigma2, all valid, and the cold
    gauge prior (1e6 on pose 0).

    px_noise=None gives bench.py's own problem: identity poses and uniform
    random pixels. A float gives a consistent one: keyframes along
    smooth_trajectory, pixels the projections plus N(0, px_noise) noise
    with outlier_frac of them moved 30-120 px, and every pose but the
    first perturbed by pose_noise (per tangent component). step_angle is
    the trajectory's turn per keyframe: a long window (the global solve's
    64 keyframes) needs a smaller one to keep the slab ahead of every
    keyframe."""
    from mcslam_tpu_torch.backend.ba import BAObservations
    from mcslam_tpu_torch.geometry import lie

    rng = np.random.RandomState(seed)
    K, L = num_kfs, num_lms
    Ok = obs_capacity // K
    O = Ok * K
    lms = (rng.uniform(-6, 6, (L, 3)) + [0, 0, 8]).astype(np.float32)
    kf = np.repeat(np.arange(K, dtype=np.int32), Ok)
    cam = rng.randint(0, rig.num_cams, O).astype(np.int32)
    lm = rng.randint(0, L, O).astype(np.int32)
    if px_noise is None:
        poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
        uv = rng.uniform(0, rig.image_size[0], (O, 2)).astype(np.float32)
    else:
        gt = smooth_trajectory(K, step_angle=step_angle, seed=seed).astype(
            np.float64)
        gt[:, :3, 3] += [0.0, 0.0, 4.0]  # start at the world origin
        cTw = rig.cam_T_ref.cpu().double().numpy()[cam] @ np.linalg.inv(
            gt)[kf]
        p = np.einsum("oij,oj->oi", cTw[:, :3, :3], lms[lm]) + cTw[:, :3, 3]
        f = rig.fxycxy.cpu().double().numpy()[cam]
        uv = p[:, :2] / p[:, 2:] * f[:, :2] + f[:, 2:]
        uv += rng.randn(O, 2) * px_noise
        bad = rng.rand(O) < outlier_frac
        uv[bad] += rng.uniform(30, 120, (int(bad.sum()), 2))
        uv = uv.astype(np.float32)
        xi = rng.randn(K, 6) * pose_noise
        xi[0] = 0.0
        poses = (torch.from_numpy(gt) @ lie.se3_exp(torch.from_numpy(xi))
                 ).float().numpy()
    prior_H = np.zeros((K * 6, K * 6), np.float32)
    prior_H[:6, :6] = np.eye(6) * 1e6
    return dict(
        poses=poses, landmarks=lms, lm_valid=np.ones(L, bool),
        obs=BAObservations(kf=kf, cam=cam, lm=lm, uv=uv,
                     sigma2=np.ones(O, np.float32), valid=np.ones(O, bool)),
        cam_T_ref=rig.cam_T_ref.cpu().numpy(),
        fxycxy=rig.fxycxy.cpu().numpy(), prior_H=prior_H,
        prior_b=np.zeros(K * 6, np.float32), kf_valid=np.ones(K, bool),
        device=rig.device)


def pan_shake_imu(num_frames: int, fps: float = 10.0, rate_hz: float = 200.0,
                  amp: float = 0.2, shake_hz: float = 1.7,
                  accel_noise: float = 0.0, gyro_noise: float = 0.0,
                  gravity: float = 9.81, stationary_s: float = 0.5,
                  seed: int = 6):
    """Fixed-position pan oscillation about body +y with exact IMU:
    theta(t) = amp sin(2 pi shake_hz (t - stationary_s)) after
    stationary_s. The reversals are sharp enough that a constant-velocity
    prediction misses by ~2x the per-frame rotation while a preintegrated
    IMU prediction follows them. -> (poses (F, 4, 4), imu_ts, gyro,
    accel), gravity along world -z, as analytic_circle_imu."""
    rng = np.random.RandomState(seed)
    g_world = np.array([0.0, 0.0, -gravity])
    t0 = stationary_s
    w = 2.0 * np.pi * shake_hz

    def roty(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)

    def state(t):
        t1 = t - t0
        th = amp * np.sin(w * t1) if t1 > 0 else 0.0
        dth = amp * w * np.cos(w * t1) if t1 > 0 else 0.0
        return roty(th), dth

    poses = np.zeros((num_frames, 4, 4), np.float32)
    for k in range(num_frames):
        R, _ = state(k / fps)
        poses[k, :3, :3] = R
        poses[k, 3, 3] = 1.0
    total_t = (num_frames - 1) / fps
    dt = 1.0 / rate_hz
    n = int(round(total_t / dt))
    ts = (np.arange(n) + 0.5) * dt
    gyro = np.zeros((n, 3))
    accel = np.zeros((n, 3))
    for i, t in enumerate(ts):
        R, dth = state(t)
        gyro[i] = np.array([0.0, dth, 0.0]) + rng.randn(3) * gyro_noise
        accel[i] = R.T @ (-g_world) + rng.randn(3) * accel_noise
    return poses, ts, gyro, accel


# -- a continuous procedurally textured world (ray-cast cylinder room) and
# photometric corruption: continuous texture under exposure change, blur
# and sensor noise, where the blob renderer gives each landmark a clean
# isolated signature


def _upsample_bilinear_wrap(g: np.ndarray, H: int, W: int) -> np.ndarray:
    """Bilinear upsample (gh, gw) -> (H, W); wraps horizontally (the
    cylinder's azimuth), clamps vertically."""
    gh, gw = g.shape
    y = np.linspace(0.0, gh - 1.0, H)
    x = np.arange(W) * (gw / float(W))
    y0 = np.floor(y).astype(np.int64)
    y1 = np.minimum(y0 + 1, gh - 1)
    fy = (y - y0).astype(np.float32)[:, None]
    x0 = np.floor(x).astype(np.int64) % gw
    x1 = (x0 + 1) % gw
    fx = (x - np.floor(x)).astype(np.float32)[None, :]
    top = g[y0][:, x0] * (1 - fx) + g[y0][:, x1] * fx
    bot = g[y1][:, x0] * (1 - fx) + g[y1][:, x1] * fx
    return (top * (1 - fy) + bot * fy).astype(np.float32)


def make_procedural_texture(height: int = 512, width: int = 4096,
                            octaves: int = 6, persistence: float = 0.55,
                            num_posters: int = 60,
                            seed: int = 11) -> np.ndarray:
    """(height, width) multi-octave value noise with `num_posters` random
    high-contrast patches (checkerboards, binary noise, ramps): the
    location-specific structure BoW retrieval indexes."""
    rng = np.random.RandomState(seed)
    tex = np.zeros((height, width), np.float32)
    amp, norm = 1.0, 0.0
    for o in range(octaves):
        gh = max(2, height >> (octaves - 1 - o))
        gw = max(4, width >> (octaves - 1 - o))
        tex += amp * _upsample_bilinear_wrap(
            rng.rand(gh, gw).astype(np.float32), height, width)
        norm += amp
        amp *= persistence
    tex /= norm
    tex = 0.1 + 0.8 * (tex - tex.min()) / max(float(np.ptp(tex)), 1e-6)
    for _ in range(num_posters):
        ph = rng.randint(height // 8, height // 3)
        pw = rng.randint(width // 64, width // 24)
        py = rng.randint(0, height - ph)
        px = rng.randint(0, width - pw)
        kind = rng.randint(3)
        if kind == 0:  # checkerboard
            cell = rng.randint(4, 12)
            yy, xx = np.mgrid[:ph, :pw]
            patch = (((yy // cell) + (xx // cell)) % 2).astype(np.float32)
            patch = 0.15 + 0.7 * patch
        elif kind == 1:  # high-contrast binary noise
            patch = (rng.rand(ph, pw) > 0.5).astype(np.float32)
            patch = 0.1 + 0.8 * patch
        elif rng.rand() > 0.5:  # horizontal ramp
            patch = np.tile(np.linspace(0.1, 0.9, pw, dtype=np.float32),
                            (ph, 1))
        else:  # vertical ramp
            patch = np.tile(
                np.linspace(0.1, 0.9, ph, dtype=np.float32)[:, None],
                (1, pw))
        e = min(px + pw, width)
        tex[py:py + ph, px:e] = patch[:, :e - px]
    return tex


def render_textured_world(rig: cam_ops.CameraRig, poses: np.ndarray,
                          radius: float = 10.0, y_floor: float = -2.5,
                          y_ceil: float = 2.5, tex: np.ndarray | None = None,
                          floor_tex: np.ndarray | None = None,
                          seed: int = 11, return_depth: bool = False):
    """Ray-cast a textured cylindrical room of `radius` about the world y
    axis (wall texture by azimuth x height, wrapping so a closed loop
    revisits identical texture; tiled floor and ceiling) for a pinhole
    rig -> (F, C, H, W) float32 images in [0, 1], and with return_depth
    also the exact camera-z depth maps."""
    assert rig.dist_model == cam_ops.DIST_NONE, (
        "textured ray-cast renderer supports pinhole rigs only")
    if tex is None:
        tex = make_procedural_texture(seed=seed)
    if floor_tex is None:
        floor_tex = make_procedural_texture(height=1024, width=1024,
                                            num_posters=12, seed=seed + 1)
    th, tw = tex.shape
    fh, fw = floor_tex.shape
    C = rig.num_cams
    w, h = rig.image_size
    fxycxy = rig.fxycxy.cpu().numpy()
    cam_T_ref = rig.cam_T_ref.cpu().numpy()
    F = len(poses)
    out = np.zeros((F, C, h, w), np.float32)
    depth = np.zeros((F, C, h, w), np.float32) if return_depth else None
    vv, uu = np.mgrid[:h, :w]
    for c in range(C):
        fx, fy, cx, cy = fxycxy[c]
        # pixel-centre rays in the camera frame; t along one is camera z
        d_cam = np.stack(
            [(uu - cx) / fx, (vv - cy) / fy, np.ones_like(uu, np.float64)],
            axis=-1)
        for k in range(F):
            cTw = cam_T_ref[c] @ np.linalg.inv(poses[k])
            wTc = np.linalg.inv(cTw)
            o = wTc[:3, 3]
            d = d_cam @ wTc[:3, :3].T
            dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
            # wall: |o_xz + t d_xz| = radius (origin inside: the + root)
            a = dx * dx + dz * dz
            b = 2.0 * (o[0] * dx + o[2] * dz)
            cq = o[0] * o[0] + o[2] * o[2] - radius * radius
            disc = np.maximum(b * b - 4.0 * a * cq, 0.0)
            t_wall = (-b + np.sqrt(disc)) / np.maximum(2.0 * a, 1e-12)
            y_hit = o[1] + t_wall * dy
            with np.errstate(divide="ignore", invalid="ignore"):
                t_floor = (y_floor - o[1]) / dy
                t_ceil = (y_ceil - o[1]) / dy
            use_floor = y_hit < y_floor
            use_ceil = y_hit > y_ceil
            t = np.where(use_floor, t_floor,
                         np.where(use_ceil, t_ceil, t_wall))
            t = np.maximum(t, 1e-3)
            p = o[None, None, :] + t[..., None] * d
            az = np.arctan2(p[..., 0], -p[..., 2])
            tu = (az / (2.0 * np.pi) + 0.5) * tw
            tv = (p[..., 1] - y_floor) / (y_ceil - y_floor) * (th - 1)
            wall_val = _sample_bilinear_wrap(tex, tv, tu)
            fu = (p[..., 0] % 8.0) / 8.0 * (fw - 1)
            fv = (p[..., 2] % 8.0) / 8.0 * (fh - 1)
            plane_val = _sample_bilinear_clamp(floor_tex, fv, fu)
            out[k, c] = np.where(use_floor | use_ceil, plane_val, wall_val)
            if return_depth:
                depth[k, c] = t.astype(np.float32)
    if return_depth:
        return out, depth
    return out


def _sample_bilinear_wrap(tex, v, u):
    """Bilinear sample in texel units; u wraps, v clamps."""
    th, tw = tex.shape
    v = np.clip(v, 0.0, th - 1.0)
    v0 = np.floor(v).astype(np.int64)
    v1 = np.minimum(v0 + 1, th - 1)
    fv = (v - v0).astype(np.float32)
    u0 = np.floor(u).astype(np.int64) % tw
    u1 = (u0 + 1) % tw
    fu = (u - np.floor(u)).astype(np.float32)
    top = tex[v0, u0] * (1 - fu) + tex[v0, u1] * fu
    bot = tex[v1, u0] * (1 - fu) + tex[v1, u1] * fu
    return top * (1 - fv) + bot * fv


def _sample_bilinear_clamp(tex, v, u):
    """Bilinear sample in texel units, both axes clamped."""
    th, tw = tex.shape
    v = np.clip(v, 0.0, th - 1.0)
    u = np.clip(u, 0.0, tw - 1.0)
    v0 = np.floor(v).astype(np.int64)
    v1 = np.minimum(v0 + 1, th - 1)
    u0 = np.floor(u).astype(np.int64)
    u1 = np.minimum(u0 + 1, tw - 1)
    fv = (v - v0).astype(np.float32)
    fu = (u - u0).astype(np.float32)
    top = tex[v0, u0] * (1 - fu) + tex[v0, u1] * fu
    bot = tex[v1, u0] * (1 - fu) + tex[v1, u1] * fu
    return top * (1 - fv) + bot * fv


def apply_photometric(imgs: np.ndarray, seed: int = 0,
                      exposure_flicker: float = 0.2,
                      pixel_noise: float = 0.02, motion_blur_px: int = 0,
                      vignette: float = 0.0) -> np.ndarray:
    """Photometric corruption of (F, C, H, W) images, clipped to [0, 1]:
    a per-frame gain 2**N(0, exposure_flicker) shared by the cameras, a
    horizontal box blur of motion_blur_px, a radial vignette and additive
    Gaussian pixel noise."""
    rng = np.random.RandomState(seed)
    F, C, H, W = imgs.shape
    out = imgs.astype(np.float32).copy()
    gains = np.exp2(rng.randn(F) * exposure_flicker)
    if vignette > 0.0:
        yy, xx = np.mgrid[:H, :W]
        r2 = (((xx - W / 2.0) / (W / 2.0)) ** 2
              + ((yy - H / 2.0) / (H / 2.0)) ** 2)
        vig = (1.0 - vignette * r2 / 2.0).astype(np.float32)
    for k in range(F):
        im = out[k] * gains[k]
        if motion_blur_px and motion_blur_px > 1:
            L = int(motion_blur_px)
            pad = np.pad(im, ((0, 0), (0, 0), (L, 0)), mode="edge")
            cs = np.cumsum(pad, axis=-1, dtype=np.float64)
            im = ((cs[..., L:] - cs[..., :-L]) / L).astype(np.float32)
        if vignette > 0.0:
            im = im * vig[None]
        im = im + rng.randn(C, H, W).astype(np.float32) * pixel_noise
        out[k] = im
    return np.clip(out, 0.0, 1.0)
