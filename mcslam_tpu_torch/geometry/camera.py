"""Pinhole camera rig with radial-tangential / equidistant distortion
(counterpart of mcslam_tpu/geometry/camera.py).

A rig is a plain dataclass of stacked per-camera tensors on one device;
the camera axis is a batch dimension of every op.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mcslam_tpu_torch.geometry import lie

DIST_NONE = 0
DIST_RADTAN = 1  # k1, k2, p1, p2[, k3]
DIST_EQUIDISTANT = 2  # k1, k2, k3, k4 (Kannala-Brandt / fisheye)


@dataclasses.dataclass(frozen=True)
class CameraRig:
    """Stacked per-camera calibration of an N-camera rigid rig.

    fxycxy (N, 4); dist (N, 5) zero-padded; cam_T_ref (N, 4, 4)
    camera-from-reference extrinsics (cam 0 is the reference);
    body_T_cam (N, 4, 4); image_size (width, height); dist_model DIST_*.
    """

    fxycxy: torch.Tensor
    dist: torch.Tensor
    cam_T_ref: torch.Tensor
    body_T_cam: torch.Tensor
    image_size: tuple
    dist_model: int = DIST_RADTAN

    @property
    def num_cams(self) -> int:
        return self.fxycxy.shape[0]

    @property
    def device(self) -> torch.device:
        return self.fxycxy.device

    @property
    def ref_T_cam(self) -> torch.Tensor:
        return lie.se3_inverse(self.cam_T_ref)

    def K(self) -> torch.Tensor:
        """(N, 3, 3) intrinsic matrices."""
        fx, fy, cx, cy = self.fxycxy.unbind(-1)
        z = torch.zeros_like(fx)
        o = torch.ones_like(fx)
        return torch.stack([torch.stack([fx, z, cx], -1),
                            torch.stack([z, fy, cy], -1),
                            torch.stack([z, z, o], -1)], dim=-2)

    def to(self, device) -> "CameraRig":
        return dataclasses.replace(
            self, fxycxy=self.fxycxy.to(device), dist=self.dist.to(device),
            cam_T_ref=self.cam_T_ref.to(device),
            body_T_cam=self.body_T_cam.to(device),
        )


def make_rig(fxycxy, dist=None, cam_T_ref=None, body_T_cam=None,
             image_size=(640, 480), dist_model=DIST_RADTAN,
             device="cuda") -> CameraRig:
    f32 = dict(dtype=torch.float32, device=device)
    fxycxy = torch.as_tensor(np.asarray(fxycxy, np.float32), **f32)
    if fxycxy.ndim == 1:
        fxycxy = fxycxy[None]
    n = fxycxy.shape[0]
    if dist is None:
        dist = torch.zeros(n, 5, **f32)
        dist_model = DIST_NONE
    else:
        dist = np.asarray(dist, np.float32)
        if dist.ndim == 1:
            dist = dist[None]
        dist = torch.as_tensor(
            np.pad(dist, ((0, 0), (0, 5 - dist.shape[1]))), **f32
        )
    eye = torch.eye(4, **f32).expand(n, 4, 4).contiguous()
    cam_T_ref = eye if cam_T_ref is None else torch.as_tensor(
        np.asarray(cam_T_ref, np.float32), **f32)
    body_T_cam = eye if body_T_cam is None else torch.as_tensor(
        np.asarray(body_T_cam, np.float32), **f32)
    return CameraRig(fxycxy=fxycxy, dist=dist, cam_T_ref=cam_T_ref,
                     body_T_cam=body_T_cam, image_size=tuple(image_size),
                     dist_model=int(dist_model))


def rig_from_numpy(fxycxy, dist, cam_T_ref, body_T_cam, image_size,
                   dist_model, device="cuda") -> CameraRig:
    """Build the port's rig from a JAX rig's fields taken with np.asarray
    (bit-identical f32 values)."""
    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return CameraRig(
        fxycxy=t(fxycxy), dist=t(dist), cam_T_ref=t(cam_T_ref),
        body_T_cam=t(body_T_cam),
        image_size=tuple(int(v) for v in image_size),
        dist_model=int(dist_model),
    )


def distort(xn: torch.Tensor, dist: torch.Tensor, model: int) -> torch.Tensor:
    """Distort normalized coordinates (..., 2); dist (..., 5) or (5,)."""
    if model == DIST_NONE:
        return xn
    x, y = xn[..., 0], xn[..., 1]
    if model == DIST_RADTAN:
        k1, k2, p1, p2, k3 = (dist[..., i] for i in range(5))
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        return torch.stack([xd, yd], dim=-1)
    if model == DIST_EQUIDISTANT:
        k1, k2, k3, k4 = (dist[..., i] for i in range(4))
        r2 = x * x + y * y
        r = torch.sqrt(torch.clamp(r2, min=1e-18))
        theta = torch.atan(r)
        t2 = theta * theta
        theta_d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
        scale = torch.where(r2 < 1e-12, torch.ones_like(r2), theta_d / r)
        return xn * scale[..., None]
    raise ValueError(f"unknown distortion model {model}")


def undistort(xd: torch.Tensor, dist: torch.Tensor, model: int,
              iters: int = 10) -> torch.Tensor:
    """Invert `distort` by fixed-point iteration (fixed iteration count)."""
    if model == DIST_NONE:
        return xd
    xn = xd
    for _ in range(iters):
        xn = xn - (distort(xn, dist, model) - xd)
    return xn


def project(p_cam: torch.Tensor, fxycxy: torch.Tensor, dist: torch.Tensor,
            model: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Camera-frame points (..., 3) -> ((..., 2) pixels, (...,) z > 0)."""
    z = p_cam[..., 2]
    valid = z > 1e-6
    safe_z = torch.where(valid, z, torch.ones_like(z))
    xn = p_cam[..., :2] / safe_z[..., None]
    xd = distort(xn, dist, model)
    return xd * fxycxy[..., :2] + fxycxy[..., 2:], valid


def backproject(uv: torch.Tensor, fxycxy: torch.Tensor, dist: torch.Tensor,
                model: int) -> torch.Tensor:
    """Pixels -> unit-depth normalized coords (..., 2) (undistorted)."""
    xd = (uv - fxycxy[..., 2:]) / fxycxy[..., :2]
    return undistort(xd, dist, model)


def bearing(uv: torch.Tensor, fxycxy: torch.Tensor, dist: torch.Tensor,
            model: int) -> torch.Tensor:
    """Pixels -> unit bearing vectors (..., 3) in the camera frame."""
    xn = backproject(uv, fxycxy, dist, model)
    rays = torch.cat([xn, torch.ones_like(xn[..., :1])], dim=-1)
    return rays / torch.linalg.vector_norm(rays, dim=-1, keepdim=True)


def project_rig(p_ref: torch.Tensor,
                rig: CameraRig) -> tuple[torch.Tensor, torch.Tensor]:
    """Reference-frame points (M, 3) into every camera of the rig ->
    (uv (N, M, 2), valid (N, M): in front of the camera and inside the
    image)."""
    p_cam = lie.se3_apply(rig.cam_T_ref[:, None], p_ref[None, :, :])
    uv, valid = project(p_cam, rig.fxycxy[:, None, :], rig.dist[:, None, :],
                        rig.dist_model)
    w, h = rig.image_size
    in_img = ((uv[..., 0] >= 0) & (uv[..., 0] < w) & (uv[..., 1] >= 0)
              & (uv[..., 1] < h))
    return uv, valid & in_img


def rig_bearings(uv: torch.Tensor, rig: CameraRig) -> torch.Tensor:
    """Per-camera pixel sets (N, K, 2) -> (N, K, 3) unit rays rotated into
    the reference-camera frame (their origins are rig.ref_T_cam[:, :3, 3])."""
    rays_cam = bearing(uv, rig.fxycxy[:, None, :], rig.dist[:, None, :],
                       rig.dist_model)
    return rays_cam @ rig.ref_T_cam[:, :3, :3].transpose(-1, -2)
