"""Dense depth fusion: per-keyframe stereo depth -> one world-frame cloud
(counterpart of mcslam_tpu/mapping/dense_fusion.py).

Parity (WHAT): the reference's DepthReconstructor computes per-keyframe
dense reconstructions that the viewer displays in the global frame
(MCSlam/src/DepthReconstructor.cpp compute-and-publish
loop; kept OFF the ATE path there and here — the fused cloud is a data
product). This module adds the fusion step the reference leaves to the
viewer: depth maps are unprojected on device, transformed into the world
frame with the keyframe pose, voxel-grid downsampled, and exported
(npz / PLY).

HOW: unprojection runs on the rig's device over the (H, W) depth map
(precomputed rectified-frame ray grid x depth, one matmul by the 3x3
world rotation). Voxel accumulation is host numpy
(np.unique over quantized int keys) — it is IO-bound bookkeeping on a
few hundred thousand points per keyframe, not device math.
"""

from __future__ import annotations

import numpy as np
import torch


def _unproject(depth, rays, R_w_rect, t_w, max_depth):
    """depth (H, W), rays (H, W, 3) rectified-frame unit-z rays ->
    world points (H*W, 3) and a finite/range mask (H*W,)."""
    pts = rays * depth[..., None]  # rectified-frame
    Xw = pts.reshape(-1, 3) @ R_w_rect.T + t_w
    ok = (depth > 0.0) & (depth < max_depth)
    return Xw, ok.reshape(-1)


class DenseFuser:
    """Accumulates per-keyframe stereo depth into one voxel-downsampled
    world-frame point cloud.

    Usage:
        fuser = DenseFuser(rig, voxel=0.1)
        ... per keyframe: fuser.add_keyframe(imgs, kf.world_T_ref) ...
        pts, intensity, counts = fuser.finalize()
        fuser.save_ply("cloud.ply")
    """

    def __init__(self, rig, cam_a: int = 0, cam_b: int = 1,
                 voxel: float = 0.1, max_depth: float = 30.0,
                 stride: int = 2, algo: str = "sgm", max_disp: int = 64):
        from mcslam_tpu_torch.ops.rectify import RigRectifier

        self.rig = rig
        self.cam_a = cam_a
        self.cam_b = cam_b
        self.voxel = float(voxel)
        self.max_depth = float(max_depth)
        self.stride = int(stride)
        self.algo = algo
        self.max_disp = int(max_disp)
        self.rectifier = RigRectifier(rig, cam_a, cam_b)

        w, h = (int(s) for s in rig.image_size)
        if self.rectifier.is_identity:
            f = rig.fxycxy.cpu().numpy()[cam_a]
            R_rect_a = np.eye(3, dtype=np.float64)
        else:
            f = np.asarray(self.rectifier.fxycxy_new, np.float64)
            R_rect_a = np.asarray(self.rectifier.R_a, np.float64)
        u, v = np.meshgrid(np.arange(w, dtype=np.float32),
                           np.arange(h, dtype=np.float32))
        rays = np.stack(
            [(u - f[2]) / f[0], (v - f[3]) / f[1], np.ones_like(u)], axis=-1
        )
        self._rays = torch.from_numpy(rays.astype(np.float32)).to(rig.device)
        # cam_a-from-rect rotation (unprojection happens in the rectified
        # frame; depth_from_rig_pair returns rectified-frame Z)
        self._a_R_rect = R_rect_a.T
        self._chunks: list[tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray]] = []

    def add_keyframe(self, imgs, world_T_ref) -> int:
        """imgs: (C, H, W) tensor or numpy array (moved to the rig's
        device); world_T_ref: (4, 4) host. Returns the number of voxels
        contributed."""
        from mcslam_tpu_torch.ops.stereo import depth_from_rig_pair

        imgs = torch.as_tensor(imgs, device=self.rig.device)
        depth, valid = depth_from_rig_pair(
            imgs, self.rig, self.cam_a, self.cam_b,
            max_disp=self.max_disp, algo=self.algo,
            rectifier=self.rectifier,
        )
        # world-from-rect transform for this keyframe
        a_T_r = np.linalg.inv(self.rig.cam_T_ref[self.cam_a].cpu().numpy())
        w_T_a = np.asarray(world_T_ref, np.float64) @ a_T_r
        R_w_rect = (w_T_a[:3, :3] @ self._a_R_rect).astype(np.float32)
        t_w = w_T_a[:3, 3].astype(np.float32)
        dev = self.rig.device
        Xw, ok = _unproject(
            depth, self._rays, torch.from_numpy(R_w_rect).to(dev),
            torch.from_numpy(t_w).to(dev), self.max_depth,
        )
        ok = (ok & valid.reshape(-1)).cpu().numpy()
        Xw = Xw.cpu().numpy()
        if self.stride > 1:
            H, W = depth.shape
            keep = np.zeros((H, W), bool)
            keep[:: self.stride, :: self.stride] = True
            ok = ok & keep.reshape(-1)
        # rectified intensity of the reference image for coloring
        if self.rectifier.is_identity:
            inten = imgs[self.cam_a].cpu().numpy().reshape(-1)
        else:
            inten = self.rectifier.rectify(imgs[self.cam_a]).cpu().numpy()
            inten = inten.reshape(-1)
        pts = Xw[ok]
        its = inten[ok]
        if len(pts) == 0:
            return 0
        keys = np.floor(pts / self.voxel).astype(np.int64)
        # pack 3 x 21-bit signed coords into one int64 key
        off = 1 << 20
        packed = (
            (keys[:, 0] + off)
            + ((keys[:, 1] + off) << 21)
            + ((keys[:, 2] + off) << 42)
        )
        uniq, inv = np.unique(packed, return_inverse=True)
        sums = np.zeros((len(uniq), 3), np.float64)
        isum = np.zeros(len(uniq), np.float64)
        cnt = np.zeros(len(uniq), np.int64)
        np.add.at(sums, inv, pts)
        np.add.at(isum, inv, its)
        np.add.at(cnt, inv, 1)
        self._chunks.append((uniq, sums, isum, cnt))
        return len(uniq)

    def finalize(self):
        """-> (points (N, 3) float32 voxel centroids, intensity (N,),
        counts (N,)) merged over all keyframes."""
        if not self._chunks:
            return (np.zeros((0, 3), np.float32), np.zeros(0, np.float32),
                    np.zeros(0, np.int64))
        keys = np.concatenate([c[0] for c in self._chunks])
        sums = np.concatenate([c[1] for c in self._chunks])
        isum = np.concatenate([c[2] for c in self._chunks])
        cnt = np.concatenate([c[3] for c in self._chunks])
        uniq, inv = np.unique(keys, return_inverse=True)
        msums = np.zeros((len(uniq), 3), np.float64)
        misum = np.zeros(len(uniq), np.float64)
        mcnt = np.zeros(len(uniq), np.int64)
        np.add.at(msums, inv, sums)
        np.add.at(misum, inv, isum)
        np.add.at(mcnt, inv, cnt)
        pts = (msums / mcnt[:, None]).astype(np.float32)
        inten = (misum / mcnt).astype(np.float32)
        return pts, inten, mcnt

    def save_ply(self, path) -> int:
        """ASCII PLY with per-point gray color. Returns point count."""
        pts, inten, _ = self.finalize()
        g = np.clip(inten * 255.0, 0, 255).astype(np.uint8)
        with open(path, "w") as f:
            f.write(
                "ply\nformat ascii 1.0\n"
                f"element vertex {len(pts)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\n"
                "property uchar blue\nend_header\n"
            )
            for p, c in zip(pts, g):
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {c} {c} {c}\n")
        return len(pts)

    def save_npz(self, path) -> int:
        pts, inten, cnt = self.finalize()
        np.savez_compressed(path, points=pts, intensity=inten, counts=cnt)
        return len(pts)
