"""Synthetic multi-camera rig, trajectory, landmarks, blob images and
feature-level frames (numpy counterpart of the generators in
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
                       landmarks: np.ndarray, seed: int = 4) -> np.ndarray:
    """(F, C, H, W) float32 images: each visible landmark is a constant
    square blob (half-size 18/z px) on low-amplitude noise."""
    rng = np.random.RandomState(seed)
    C = rig.num_cams
    w, h = rig.image_size
    blob_intensity = rng.uniform(0.4, 1.0, len(landmarks)).astype(np.float32)
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
                img[max(y - s, 0):min(y + s + 1, h),
                    max(x - s, 0):min(x + s + 1, w)] = blob_intensity[i]
            out[k, c] = img
    return out


def random_window_ba_problem(rig: cam_ops.CameraRig, num_kfs: int = 6,
                             num_lms: int = 2048, obs_capacity: int = 8192,
                             seed: int = 0, px_noise: float | None = None,
                             pose_noise: float = 0.01,
                             outlier_frac: float = 0.05) -> dict:
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
    first perturbed by pose_noise (per tangent component)."""
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
        gt = smooth_trajectory(K, step_angle=0.02, seed=seed).astype(
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
