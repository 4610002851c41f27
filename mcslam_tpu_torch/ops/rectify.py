"""Stereo rectification for general (non-parallel) rig pairs (counterpart
of mcslam_tpu/ops/rectify.py).

Parity (WHAT): DepthReconstructor::init
(MCSlam/src/DepthReconstructor.cpp:7-22) — cv::stereoRectify (Bouguet's
algorithm) + initUndistortRectifyMap + remap, producing the row-aligned
pair the disparity search requires and the Q matrix for disparity ->
depth.

HOW: the rectifying rotations are host numpy in float64 and the inverse
maps a host computation (CPU tensors, once per rig pair); the per-frame
remap is a bilinear gather on the rig's device. The inverse maps fold
undistortion in, so raw (distorted) images rectify in one resampling
pass, like the reference's combined initUndistortRectifyMap.
"""

from __future__ import annotations

import numpy as np
import torch

from mcslam_tpu_torch.geometry import camera as cam_ops


def _rodrigues(w: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _log_so3(R: np.ndarray) -> np.ndarray:
    c = np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)
    th = np.arccos(c)
    if th < 1e-12:
        return np.zeros(3)
    return th / (2 * np.sin(th)) * np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]
    )


def stereo_rectify(fxycxy1, fxycxy2, R, t, image_size):
    """Bouguet rectification (cv::stereoRectify semantics, CALIB_ZERO_
    DISPARITY): R, t map cam1 points into cam2 (p2 = R p1 + t).

    Returns (R1, R2, fxycxy_new, Q): per-camera rectifying rotations
    (new_cam <- old_cam), the shared rectified pinhole intrinsics, and the
    4x4 disparity-to-depth matrix."""
    w, h = image_size
    # split the relative rotation evenly between the two cameras
    R = np.asarray(R, np.float64)
    t = np.asarray(t, np.float64)
    om = _log_so3(R)
    R_half2 = _rodrigues(-0.5 * om)  # applied to cam2
    R_half1 = _rodrigues(0.5 * om)  # applied to cam1
    # baseline vector FROM cam1 TO cam2 expressed in the half-rotated
    # frame: +x along it keeps cam1 the LEFT camera (positive disparity)
    pos2_in_1 = -(R.T @ t)
    b_half = R_half1 @ pos2_in_1
    e1 = b_half / max(np.linalg.norm(b_half), 1e-12)
    e2 = np.array([-e1[1], e1[0], 0.0])
    n2 = np.linalg.norm(e2)
    e2 = e2 / n2 if n2 > 1e-12 else np.array([0.0, 1.0, 0.0])
    e3 = np.cross(e1, e2)
    Rrect = np.stack([e1, e2, e3])  # rows
    R1 = Rrect @ R_half1
    R2 = Rrect @ R_half2
    # shared rectified intrinsics: mean focal, centered principal point
    f1 = np.asarray(fxycxy1, np.float64)
    f2 = np.asarray(fxycxy2, np.float64)
    f_new = 0.5 * (f1[:2].mean() + f2[:2].mean())
    cx, cy = (w - 1) * 0.5, (h - 1) * 0.5
    fxycxy_new = np.array([f_new, f_new, cx, cy], np.float32)
    B = float(np.linalg.norm(t))
    Q = np.array(
        [
            [1.0, 0.0, 0.0, -cx],
            [0.0, 1.0, 0.0, -cy],
            [0.0, 0.0, 0.0, f_new],
            [0.0, 0.0, 1.0 / B, 0.0],
        ],
        np.float32,
    )
    return (
        R1.astype(np.float32), R2.astype(np.float32), fxycxy_new, Q,
    )


def rectify_maps(fxycxy, dist, dist_model: int, R_rect, fxycxy_new,
                 image_size):
    """Inverse maps for one camera: for each RECTIFIED pixel, the source
    pixel in the ORIGINAL (distorted) image (initUndistortRectifyMap
    semantics). Host numpy, the distortion by camera.distort on CPU
    tensors; returns (map_x, map_y) float32 (H, W)."""
    w, h = image_size
    u, v = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32))
    xn = (u - fxycxy_new[2]) / fxycxy_new[0]
    yn = (v - fxycxy_new[3]) / fxycxy_new[1]
    rays = np.stack([xn, yn, np.ones_like(xn)], axis=-1).reshape(-1, 3)
    # rectified cam -> original cam: apply R_rect^T
    rays = rays @ np.asarray(R_rect, np.float32)  # == (R_rect^T @ r)^T rows
    z = np.maximum(rays[:, 2:3], 1e-6)
    xn_src = torch.from_numpy(np.ascontiguousarray(rays[:, :2] / z))
    xd = cam_ops.distort(
        xn_src, torch.as_tensor(np.asarray(dist, np.float32)), dist_model
    ).numpy()
    fx = np.asarray(fxycxy, np.float32)
    mx = (xd[:, 0] * fx[0] + fx[2]).reshape(h, w).astype(np.float32)
    my = (xd[:, 1] * fx[1] + fx[3]).reshape(h, w).astype(np.float32)
    return mx, my


def remap_bilinear(img: torch.Tensor, map_x: torch.Tensor,
                   map_y: torch.Tensor) -> torch.Tensor:
    """(H, W) image sampled at (map_x, map_y) with bilinear weights;
    out-of-bounds samples clamp (cv::remap BORDER_REPLICATE-ish): the
    right / lower neighbour is the clamped left / upper one plus 1,
    clamped again."""
    H, W = img.shape
    x0 = torch.floor(map_x)
    y0 = torch.floor(map_y)
    fx = map_x - x0
    fy = map_y - y0
    x0i = torch.clamp(x0.to(torch.int64), 0, W - 1)
    x1i = torch.clamp(x0i + 1, 0, W - 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, H - 1)
    y1i = torch.clamp(y0i + 1, 0, H - 1)
    flat = img.reshape(-1)
    v00 = flat[y0i * W + x0i]
    v01 = flat[y0i * W + x1i]
    v10 = flat[y1i * W + x0i]
    v11 = flat[y1i * W + x1i]
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


class RigRectifier:
    """Per-rig-pair rectification bundle: host-computed maps, uploaded
    once to the rig's device, and the remap there.

    Usage:
        rr = RigRectifier(rig, cam_a, cam_b)
        la, lb = rr.rectify(imgs[cam_a]), rr.rectify_b(imgs[cam_b])
        depth = rr.depth_from_disparity(disp)
    """

    def __init__(self, rig, cam_a: int = 0, cam_b: int = 1):
        cam_T_ref = rig.cam_T_ref.cpu().numpy()
        T_ab = cam_T_ref[cam_b] @ np.linalg.inv(cam_T_ref[cam_a])
        R = T_ab[:3, :3]
        t = T_ab[:3, 3]
        fx = rig.fxycxy.cpu().numpy()
        dist = rig.dist.cpu().numpy()
        size = tuple(int(s) for s in rig.image_size)
        R1, R2, f_new, Q = stereo_rectify(fx[cam_a], fx[cam_b], R, t, size)
        self.fxycxy_new = f_new
        self.Q = Q
        self.baseline = float(np.linalg.norm(t))
        self.R_a = R1  # rect-from-cam_a rotation (unprojection needs it)
        self.map_a = tuple(
            torch.from_numpy(m).to(rig.device) for m in rectify_maps(
                fx[cam_a], dist[cam_a], rig.dist_model, R1, f_new, size))
        self.map_b = tuple(
            torch.from_numpy(m).to(rig.device) for m in rectify_maps(
                fx[cam_b], dist[cam_b], rig.dist_model, R2, f_new, size))
        # unrectified-parallel shortcut detection: identity rotations mean
        # the pair was already row-aligned
        self.is_identity = (
            np.abs(R1 - np.eye(3)).max() < 1e-5
            and np.abs(R2 - np.eye(3)).max() < 1e-5
        )

    def rectify(self, img_a: torch.Tensor) -> torch.Tensor:
        return remap_bilinear(img_a, *self.map_a)

    def rectify_b(self, img_b: torch.Tensor) -> torch.Tensor:
        return remap_bilinear(img_b, *self.map_b)

    def depth_from_disparity(self, disp: torch.Tensor,
                             min_disp: float = 0.5) -> torch.Tensor:
        """Z in the RECTIFIED cam_a frame: Z = f_new * B / d."""
        return (
            float(self.fxycxy_new[0]) * self.baseline
            / torch.clamp(disp, min=min_disp)
        )
