"""Multi-camera frame construction: extraction, undistortion, intra-rig
matching and rig triangulation (counterpart of
mcslam_tpu/frontend/frame.py). A frame is a NamedTuple of fixed-shape
tensors on the images' device; the camera axis is batched through every
op."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mcslam_tpu_torch.frontend import intra as intra_ops
from mcslam_tpu_torch.geometry import camera as cam_ops
from mcslam_tpu_torch.geometry import lie, triangulation
from mcslam_tpu_torch.ops import orb


class FrameFeatures(NamedTuple):
    """All per-frame feature state (C cameras, N kps/camera, M intra
    slots). Descriptors are (.., 8) int32 words."""

    kp_xy: torch.Tensor  # (C, N, 2) raw pixel coords (x, y)
    kp_xy_ud: torch.Tensor  # (C, N, 2) undistorted pixel coords
    kp_response: torch.Tensor  # (C, N)
    kp_angle: torch.Tensor  # (C, N)
    kp_octave: torch.Tensor  # (C, N) int32
    kp_sigma2: torch.Tensor  # (C, N) measurement variance scale
    kp_desc: torch.Tensor  # (C, N, 8) int32
    kp_valid: torch.Tensor  # (C, N) bool
    im_ray_idx: torch.Tensor  # (M, C) int32 keypoint index per camera, -1 none
    im_desc: torch.Tensor  # (M, 8) int32 representative descriptor
    im_uv_ref: torch.Tensor  # (M, 2) anchor observation (undistorted px)
    im_anchor_cam: torch.Tensor  # (M,) int32 camera of the anchor
    im_point3d: torch.Tensor  # (M, 3) rig-frame 3D (valid iff im_has_depth)
    im_has_depth: torch.Tensor  # (M,) bool
    im_n_rays: torch.Tensor  # (M,) int32
    im_valid: torch.Tensor  # (M,) bool
    im_sigma2: torch.Tensor  # (M,) anchor measurement variance factor

    @property
    def num_cams(self) -> int:
        return self.kp_xy.shape[0]

    @property
    def num_intra(self) -> int:
        return self.im_ray_idx.shape[0]


_DESC_FIELDS = ("kp_desc", "im_desc")


def frame_from_numpy(arrays, device="cuda") -> FrameFeatures:
    """Build a FrameFeatures from numpy arrays of the same fields (e.g.
    np.asarray of each field of a JAX FrameFeatures); uint32 descriptors
    become int32 words with identical bits."""
    from mcslam_tpu_torch.ops.hamming import desc_to_torch

    out = {}
    for name in FrameFeatures._fields:
        a = np.asarray(arrays[name] if isinstance(arrays, dict)
                       else getattr(arrays, name))
        out[name] = (desc_to_torch(a, device) if name in _DESC_FIELDS
                     else torch.from_numpy(np.array(a)).to(device))
    return FrameFeatures(**out)


def undistort_keypoints(xy: torch.Tensor, valid: torch.Tensor,
                        rig) -> torch.Tensor:
    """(C, N, 2) raw pixels -> undistorted pixels under the same K."""
    xn = cam_ops.backproject(xy, rig.fxycxy[:, None, :], rig.dist[:, None, :],
                             rig.dist_model)
    uv = xn * rig.fxycxy[:, None, :2] + rig.fxycxy[:, None, 2:]
    return torch.where(valid[..., None], uv, torch.zeros_like(uv))


def _triangulate_stage(groups, xy_ud, kp_sigma2, rig, min_z, max_z):
    C = xy_ud.shape[0]
    M = groups.ray_idx.shape[0]
    dev = xy_ud.device
    ray_valid = groups.ray_idx >= 0  # (M, C)
    safe_idx = torch.clamp(groups.ray_idx, min=0).long()
    cam_idx = torch.arange(C, device=dev)[None, :].expand(M, C)
    uv = xy_ud[cam_idx, safe_idx]  # (M, C, 2)
    sig2 = kp_sigma2[cam_idx, safe_idx]  # (M, C)
    world_T_cam = lie.se3_inverse(rig.cam_T_ref)[None].expand(M, C, 4, 4)
    fxy = rig.fxycxy[None].expand(M, C, 4)
    multi = torch.sum(ray_valid, dim=-1) >= 2
    X, tri_ok = triangulation.triangulate_and_refine(
        world_T_cam, uv, fxy, ray_valid & multi[:, None],
        sigma=torch.sqrt(sig2), min_z=min_z, max_z=max_z,
    )
    has_depth = tri_ok & multi & groups.valid
    anchor_cam = torch.argmax(ray_valid.to(torch.uint8), dim=-1)
    anchor_kp = torch.gather(safe_idx, 1, anchor_cam[:, None])[:, 0]
    uv_ref = xy_ud[anchor_cam, anchor_kp]
    anchor_sigma2 = kp_sigma2[anchor_cam, anchor_kp]
    n_rays = torch.sum(ray_valid, dim=-1).to(torch.int32)
    return (X, has_depth, anchor_cam.to(torch.int32), uv_ref, anchor_sigma2,
            n_rays)


def _fused_stage(imgs, rig, num_points, num_levels, fast_threshold,
                 min_threshold, max_intra, min_z, max_z,
                 angle_bins=orb.ANGLE_BINS, route=orb.OrbRoute()):
    """extract (by `route`) + undistort + intra-match + triangulate."""
    if imgs.dtype == torch.uint8:
        imgs = imgs.to(torch.float32) * (1.0 / 255.0)
    kps = orb.extract_orb_rig(
        imgs, num_points=num_points, num_levels=num_levels,
        fast_threshold=fast_threshold, min_threshold=min_threshold,
        angle_bins=angle_bins, route=route,
    )
    xy_ud = undistort_keypoints(kps.xy, kps.valid, rig)
    groups = intra_ops.intra_match(
        desc=kps.desc, xy_ud=xy_ud, valid=kps.valid, response=kps.response,
        rig=rig, max_out=max_intra,
    )
    tri = _triangulate_stage(groups, xy_ud, kps.sigma2, rig, min_z, max_z)
    return kps, xy_ud, groups, tri


def assemble_frame(kps, xy_ud, groups, tri) -> FrameFeatures:
    """Package the raw outputs of the fused stage as a FrameFeatures."""
    X, has_depth, anchor_cam, uv_ref, anchor_sigma2, n_rays = tri
    return FrameFeatures(
        kp_xy=kps.xy, kp_xy_ud=xy_ud, kp_response=kps.response,
        kp_angle=kps.angle, kp_octave=kps.octave, kp_sigma2=kps.sigma2,
        kp_desc=kps.desc, kp_valid=kps.valid, im_ray_idx=groups.ray_idx,
        im_desc=groups.desc, im_uv_ref=uv_ref, im_anchor_cam=anchor_cam,
        im_point3d=X, im_has_depth=has_depth, im_n_rays=n_rays,
        im_valid=groups.valid, im_sigma2=anchor_sigma2,
    )


def build_frame(imgs: torch.Tensor, rig, num_points: int = 1024,
                num_levels: int = 8, max_intra: int = 2048,
                fast_threshold: float = 20.0 / 255.0,
                min_threshold: float = 7.0 / 255.0, min_z: float = 0.5,
                max_z: float = 40.0, angle_bins: int = orb.ANGLE_BINS,
                route: orb.OrbRoute = orb.OrbRoute()) -> FrameFeatures:
    """(C, H, W) float images in [0, 1] (or uint8) on the rig's device ->
    FrameFeatures. ORB per camera (batched, by the extraction `route`) ->
    undistort -> cross-camera intra-matching -> rig triangulation of
    multi-view groups."""
    return assemble_frame(*_fused_stage(
        imgs, rig, num_points, num_levels, fast_threshold, min_threshold,
        max_intra, min_z, max_z, angle_bins, route,
    ))


def build_frame_from_keypoints(kp_xy: torch.Tensor, kp_desc: torch.Tensor,
                               kp_valid: torch.Tensor, rig,
                               kp_response: torch.Tensor | None = None,
                               kp_sigma2: torch.Tensor | None = None,
                               max_intra: int = 2048, min_z: float = 0.5,
                               max_z: float = 100.0) -> FrameFeatures:
    """FrameFeatures from externally supplied keypoints (synthetic
    feature-level data, replayed logs, or a foreign detector): raw pixels
    (C, N, 2), descriptor words (C, N, 8) int32 and validity (C, N) on
    the rig's device -> undistort -> intra-rig matching -> rig
    triangulation. Angles and octaves are 0; response defaults to the
    validity, sigma2 to 1."""
    C, N = kp_valid.shape
    dev = kp_xy.device
    if kp_response is None:
        kp_response = kp_valid.to(torch.float32)
    if kp_sigma2 is None:
        kp_sigma2 = torch.ones(C, N, dtype=torch.float32, device=dev)
    xy_ud = undistort_keypoints(kp_xy, kp_valid, rig)
    groups = intra_ops.intra_match(desc=kp_desc, xy_ud=xy_ud, valid=kp_valid,
                                   response=kp_response, rig=rig,
                                   max_out=max_intra)
    tri = _triangulate_stage(groups, xy_ud, kp_sigma2, rig, min_z, max_z)
    kps = orb.Keypoints(
        xy=kp_xy, response=kp_response,
        angle=torch.zeros(C, N, dtype=torch.float32, device=dev),
        octave=torch.zeros(C, N, dtype=torch.int32, device=dev),
        sigma2=kp_sigma2, desc=kp_desc, valid=kp_valid)
    return assemble_frame(kps, xy_ud, groups, tri)
