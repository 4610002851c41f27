"""Multi-camera frame build sharded over a device mesh (counterpart of
mcslam_tpu/parallel/sharded_frame.py), on parallel/mesh's single-process
mesh.

The camera axis is split over the mesh: each shard extracts ORB (by the
frame build's kernels, one launch of each per shard) and undistorts its
own cameras with the rig's tables sliced to them; the per-camera keypoint
tables are gathered in camera order on the mesh's first device (O(C * N),
not the O(C * H * W) images), where intra-rig matching and rig
triangulation run once. Extraction and undistortion are per camera (no
reduction crosses cameras), and the gathered tables are the single-device
build's, so the result is bit-exact against frontend/frame.build_frame.

sharded_build_frames is the frame-parallel mode: one whole frame per
shard.
"""

from __future__ import annotations

import dataclasses

import torch

from mcslam_tpu_torch.frontend import frame as frame_mod
from mcslam_tpu_torch.frontend import intra as intra_ops
from mcslam_tpu_torch.ops import orb
from mcslam_tpu_torch.parallel import mesh as mesh_mod

AXIS = "cam"


def make_mesh(n_devices: int | None = None, device="cuda") -> mesh_mod.Mesh:
    return mesh_mod.make_mesh(n_devices, device, AXIS)


def _sub_rig(rig, lo: int, hi: int, dev):
    """The rig's per-camera tables of cameras [lo, hi) on `dev`."""
    return dataclasses.replace(
        rig, fxycxy=rig.fxycxy[lo:hi].to(dev), dist=rig.dist[lo:hi].to(dev),
        cam_T_ref=rig.cam_T_ref[lo:hi].to(dev),
        body_T_cam=rig.body_T_cam[lo:hi].to(dev))


def _sharded_fused_stage(mesh, imgs, rig, num_points, num_levels,
                         fast_threshold, min_threshold, max_intra, min_z,
                         max_z, angle_bins, route):
    """frame._fused_stage with the camera axis split over the mesh."""
    c_local = imgs.shape[0] // mesh.size
    kps_parts, xy_ud_parts = [], []
    for s, dev in enumerate(mesh.devices):
        lo, hi = s * c_local, (s + 1) * c_local
        im = imgs[lo:hi].to(dev, non_blocking=True)
        if im.dtype == torch.uint8:
            im = im.to(torch.float32) * (1.0 / 255.0)
        kps = orb.extract_orb_rig(
            im, num_points=num_points, num_levels=num_levels,
            fast_threshold=fast_threshold, min_threshold=min_threshold,
            angle_bins=angle_bins, route=route)
        kps_parts.append(kps)
        xy_ud_parts.append(frame_mod.undistort_keypoints(
            kps.xy, kps.valid, _sub_rig(rig, lo, hi, dev)))
    # gather the camera axis: the keypoint tables, in camera order
    kps = orb.Keypoints(*(mesh.all_gather(list(f))
                          for f in zip(*kps_parts)))
    xy_ud = mesh.all_gather(xy_ud_parts)
    # cross-camera stages, once, on the first device
    rig0 = rig.to(mesh.first)
    groups = intra_ops.intra_match(
        desc=kps.desc, xy_ud=xy_ud, valid=kps.valid, response=kps.response,
        rig=rig0, max_out=max_intra)
    tri = frame_mod._triangulate_stage(groups, xy_ud, kps.sigma2, rig0,
                                       min_z, max_z)
    return kps, xy_ud, groups, tri


def sharded_build_frame(mesh, imgs: torch.Tensor, rig,
                        num_points: int = 1024, num_levels: int = 8,
                        max_intra: int = 2048,
                        fast_threshold: float = 20.0 / 255.0,
                        min_threshold: float = 7.0 / 255.0,
                        min_z: float = 0.5, max_z: float = 40.0,
                        angle_bins: int = orb.ANGLE_BINS,
                        route: orb.OrbRoute = orb.OrbRoute()
                        ) -> frame_mod.FrameFeatures:
    """build_frame with the camera axis split over `mesh` (bit-exact),
    the FrameFeatures on the mesh's first device. Needs num_cams
    divisible by the mesh size (cameras are the unit of work: a 4-camera
    rig splits over 1, 2 or 4 shards)."""
    C = imgs.shape[0]
    if C % mesh.size:
        raise ValueError(
            f"num_cams={C} not divisible by mesh devices={mesh.size}")
    return frame_mod.assemble_frame(*_sharded_fused_stage(
        mesh, imgs, rig, num_points, num_levels, fast_threshold,
        min_threshold, max_intra, min_z, max_z, angle_bins, route))


def sharded_build_frames(mesh, imgs: torch.Tensor, rig,
                         **kw) -> list[frame_mod.FrameFeatures]:
    """Frame-parallel batch build: imgs (B, C, H, W) with B == the mesh
    size, frame b built whole on shard b by build_frame(**kw) (bit-exact
    against B build_frame calls). The throughput mode for offline
    mapping, where frame builds do not depend on SLAM state. -> B
    FrameFeatures, frame b on device b."""
    B = imgs.shape[0]
    if B != mesh.size:
        raise ValueError(f"batch={B} must equal mesh devices={mesh.size}")
    return [frame_mod.build_frame(imgs[b].to(dev, non_blocking=True),
                                  rig.to(dev), **kw)
            for b, dev in enumerate(mesh.devices)]
