"""39x39 patch gathers, three CUDA entries (kernel source
csrc/patch_gather.cu), counterparts of mcslam_tpu/ops/patch_pallas.py:

* `patch_gather`: flat keypoint list, each keypoint names its image
  (extract_patches_indexed_pallas);
* `patch_gather_batched`: (C, N) keypoints, keypoint (c, n) in image c
  (extract_patches_pallas);
* `patch_gather_oriented`: the indexed gather plus the intensity-centroid
  moments of each window, patches as bf16
  (extract_patches_oriented_pallas).

Each launches its kernel for CUDA tensors and runs its `_reference`, the
plain PyTorch version, for CPU tensors. The copies are bit-exact; the
moments are summed in the kernel's own fixed order (see
patch_gather_oriented_reference), so kernel and plain version agree bit
for bit there too.
"""

from __future__ import annotations

import numpy as np
import torch

from mcslam_tpu_torch import _build
from mcslam_tpu_torch.utils import graphs

PATCH = 39  # patch window: covers rotated BRIEF offsets (+-13*sqrt(2) < 19)
PATCH_R = PATCH // 2
CIRCLE_R = 15  # IC-angle circle radius (orb.PATCH_RADIUS)


def _origins(yx: torch.Tensor, H: int, W: int) -> torch.Tensor:
    y0 = torch.clamp(yx[:, 0] - PATCH_R, 0, H - PATCH)
    x0 = torch.clamp(yx[:, 1] - PATCH_R, 0, W - PATCH)
    return torch.stack([y0, x0], dim=-1).to(torch.int32)


def _check_yx(name, yx, shape, device):
    if (yx.device != device or yx.dtype != torch.int32
            or tuple(yx.shape) != shape or not yx.is_contiguous()):
        raise ValueError(f"{name}: yx must be a contiguous {shape} int32 "
                         f"tensor on {device}")


def _check_imgs(name, imgs):
    if (imgs.dtype != torch.float32 or imgs.ndim != 3
            or not imgs.is_contiguous()):
        raise ValueError(f"{name}: imgs must be a contiguous (B, H, W) "
                         "float32 tensor")
    if imgs.shape[1] < PATCH or imgs.shape[2] < PATCH:
        raise ValueError(f"{name}: images smaller than {PATCH}x{PATCH}")


def _check_indexed(name, imgs, yx, img_idx):
    """Validate the indexed gathers' inputs -> (B, H, W, T)."""
    _check_imgs(name, imgs)
    T = yx.shape[0]
    _check_yx(name, yx, (T, 2), imgs.device)
    if (img_idx.device != imgs.device or img_idx.dtype != torch.int32
            or img_idx.shape != (T,) or not img_idx.is_contiguous()):
        raise ValueError(f"{name}: img_idx must be a contiguous ({T},) int32 "
                         f"tensor on {imgs.device}")
    return (*imgs.shape, T)


def patch_gather_reference(imgs: torch.Tensor, yx: torch.Tensor,
                           img_idx: torch.Tensor):
    """Plain PyTorch version. imgs (B, H, W), yx (T, 2) int (y, x),
    img_idx (T,) int -> (patches (T, 39, 39), origins (T, 2) int32):
    the 39x39 window of image img_idx[t] at the clamped origin."""
    B, H, W = imgs.shape
    org = _origins(yx, H, W).long()
    b = torch.clamp(img_idx.long(), 0, B - 1)
    ar = torch.arange(PATCH, device=imgs.device)
    rows = org[:, 0, None] + ar  # (T, P)
    cols = org[:, 1, None] + ar
    patches = imgs[b[:, None, None], rows[:, :, None], cols[:, None, :]]
    return patches, org.to(torch.int32)


def patch_gather(imgs: torch.Tensor, yx: torch.Tensor, img_idx: torch.Tensor):
    """(B, H, W) f32, (T, 2) int32, (T,) int32 -> ((T, 39, 39) patches,
    (T, 2) int32 origins). CUDA tensors launch the kernel; CPU tensors
    take the plain version."""
    if imgs.device.type == "cpu":
        return patch_gather_reference(imgs, yx, img_idx)
    if imgs.device.type != "cuda":
        raise ValueError(f"patch_gather: unsupported device {imgs.device}")
    B, H, W, T = _check_indexed("patch_gather", imgs, yx, img_idx)
    patches = torch.empty(T, PATCH, PATCH, dtype=torch.float32,
                          device=imgs.device)
    origins = torch.empty(T, 2, dtype=torch.int32, device=imgs.device)
    lib = _build.library()
    _build.count("patch_gather")
    _build.check(lib.mc_patch_gather(
        imgs.data_ptr(), yx.data_ptr(), img_idx.data_ptr(),
        patches.data_ptr(), origins.data_ptr(), B, H, W, T,
        _build.stream_ptr(imgs.device),
    ), "mc_patch_gather")
    return patches, origins


def patch_gather_batched_reference(imgs: torch.Tensor, yx: torch.Tensor):
    """Plain PyTorch version. imgs (C, H, W), yx (C, N, 2) int (y, x) ->
    (patches (C, N, 39, 39), origins (C, N, 2) int32): keypoint (c, n)'s
    window of image c at the clamped origin."""
    C, N = yx.shape[:2]
    idx = torch.arange(C, device=imgs.device).repeat_interleave(N)
    patches, org = patch_gather_reference(imgs, yx.reshape(C * N, 2), idx)
    return patches.reshape(C, N, PATCH, PATCH), org.reshape(C, N, 2)


def patch_gather_batched(imgs: torch.Tensor, yx: torch.Tensor):
    """(C, H, W) f32, (C, N, 2) int32 -> ((C, N, 39, 39) patches,
    (C, N, 2) int32 origins). CUDA tensors launch the kernel; CPU tensors
    take the plain version."""
    if imgs.device.type == "cpu":
        return patch_gather_batched_reference(imgs, yx)
    if imgs.device.type != "cuda":
        raise ValueError(
            f"patch_gather_batched: unsupported device {imgs.device}")
    _check_imgs("patch_gather_batched", imgs)
    C, H, W = imgs.shape
    N = yx.shape[1] if yx.ndim == 3 else -1
    _check_yx("patch_gather_batched", yx, (C, N, 2), imgs.device)
    patches = torch.empty(C, N, PATCH, PATCH, dtype=torch.float32,
                          device=imgs.device)
    origins = torch.empty(C, N, 2, dtype=torch.int32, device=imgs.device)
    lib = _build.library()
    _build.count("patch_gather_batched")
    _build.check(lib.mc_patch_gather_batched(
        imgs.data_ptr(), yx.data_ptr(), patches.data_ptr(),
        origins.data_ptr(), C, H, W, N, _build.stream_ptr(imgs.device),
    ), "mc_patch_gather_batched")
    return patches, origins


def circle_weights(device=None) -> torch.Tensor:
    """(2, 39*39) f32 [wx | wy] of the radius-15 IC-angle circle, flat in
    row-major window order: wx = dx, wy = dy inside, 0 outside
    (mcslam_tpu/ops/orb.py _circle_weights)."""
    d = np.arange(PATCH) - PATCH_R
    dy, dx = np.meshgrid(d, d, indexing="ij")
    inside = dx * dx + dy * dy <= CIRCLE_R * CIRCLE_R
    w = np.stack([dx * inside, dy * inside]).reshape(2, PATCH * PATCH)
    return torch.from_numpy(w.astype(np.float32)).to(device)


def patch_gather_oriented_reference(imgs: torch.Tensor, yx: torch.Tensor,
                                    img_idx: torch.Tensor):
    """Plain PyTorch version. imgs (B, H, W) f32, yx (T, 2), img_idx (T,)
    -> (patches (T, 39, 39) bf16, moments (T, 2) f32 [m10, m01], origins
    (T, 2) int32). The moments of the f32 window are summed in the
    kernel's order: 32 lane sums over window elements l, l+32, ..., then
    an xor butterfly over the lanes (offsets 16, 8, 4, 2, 1), every
    product and sum rounded apart."""
    win, org = patch_gather_reference(imgs, yx, img_idx)
    T = win.shape[0]
    n = PATCH * PATCH
    steps = -(-n // 32)
    prods = win.reshape(T, 1, n) * graphs.const(
        "patch.circle_weights", imgs.device, circle_weights)  # (T, 2, n)
    prods = torch.nn.functional.pad(prods, (0, steps * 32 - n))
    prods = prods.reshape(T, 2, steps, 32)
    acc = torch.zeros(T, 2, 32, dtype=torch.float32, device=imgs.device)
    for j in range(steps):
        acc = acc + prods[:, :, j]
    lanes = torch.arange(32, device=imgs.device)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lanes ^ off]
    return win.to(torch.bfloat16), acc[..., 0].contiguous(), org


def patch_gather_oriented(imgs: torch.Tensor, yx: torch.Tensor,
                          img_idx: torch.Tensor):
    """(B, H, W) f32, (T, 2) int32, (T,) int32 -> ((T, 39, 39) bf16
    patches, (T, 2) f32 moments [m10, m01], (T, 2) int32 origins); the
    IC angle is atan2(m01, m10). CUDA tensors launch the kernel; CPU
    tensors take the plain version."""
    if imgs.device.type == "cpu":
        return patch_gather_oriented_reference(imgs, yx, img_idx)
    if imgs.device.type != "cuda":
        raise ValueError(
            f"patch_gather_oriented: unsupported device {imgs.device}")
    B, H, W, T = _check_indexed("patch_gather_oriented", imgs, yx, img_idx)
    patches = torch.empty(T, PATCH, PATCH, dtype=torch.bfloat16,
                          device=imgs.device)
    moments = torch.empty(T, 2, dtype=torch.float32, device=imgs.device)
    origins = torch.empty(T, 2, dtype=torch.int32, device=imgs.device)
    lib = _build.library()
    _build.count("patch_gather_oriented")
    _build.check(lib.mc_patch_gather_oriented(
        imgs.data_ptr(), yx.data_ptr(), img_idx.data_ptr(),
        patches.data_ptr(), moments.data_ptr(), origins.data_ptr(), B, H, W,
        T, _build.stream_ptr(imgs.device),
    ), "mc_patch_gather_oriented")
    return patches, moments, origins
