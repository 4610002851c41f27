"""Indexed patch gather in one CUDA launch (counterpart of
mcslam_tpu/ops/patch_pallas.py extract_patches_indexed_pallas; kernel
source csrc/patch_gather.cu).

`patch_gather` launches the kernel for CUDA tensors and runs
`patch_gather_reference`, the plain PyTorch version, for CPU tensors.
Both are bit-exact copies.
"""

from __future__ import annotations

import torch

from mcslam_tpu_torch import _build

PATCH = 39  # patch window: covers rotated BRIEF offsets (+-13*sqrt(2) < 19)
PATCH_R = PATCH // 2
LAUNCHES = 0  # kernel launches since the last reset


def _origins(yx: torch.Tensor, H: int, W: int) -> torch.Tensor:
    y0 = torch.clamp(yx[:, 0] - PATCH_R, 0, H - PATCH)
    x0 = torch.clamp(yx[:, 1] - PATCH_R, 0, W - PATCH)
    return torch.stack([y0, x0], dim=-1).to(torch.int32)


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
    if (imgs.dtype != torch.float32 or imgs.ndim != 3
            or not imgs.is_contiguous()):
        raise ValueError("patch_gather: imgs must be a contiguous (B, H, W) "
                         "float32 tensor")
    B, H, W = imgs.shape
    if H < PATCH or W < PATCH:
        raise ValueError(f"patch_gather: images smaller than {PATCH}x{PATCH}")
    T = yx.shape[0]
    if (yx.device != imgs.device or yx.dtype != torch.int32
            or yx.shape != (T, 2) or not yx.is_contiguous()):
        raise ValueError("patch_gather: yx must be a contiguous (T, 2) int32 "
                         f"tensor on {imgs.device}")
    if (img_idx.device != imgs.device or img_idx.dtype != torch.int32
            or img_idx.shape != (T,) or not img_idx.is_contiguous()):
        raise ValueError("patch_gather: img_idx must be a contiguous (T,) "
                         f"int32 tensor on {imgs.device}")
    patches = torch.empty(T, PATCH, PATCH, dtype=torch.float32,
                          device=imgs.device)
    origins = torch.empty(T, 2, dtype=torch.int32, device=imgs.device)
    lib = _build.library()
    global LAUNCHES
    LAUNCHES += 1
    _build.check(lib.mc_patch_gather(
        imgs.data_ptr(), yx.data_ptr(), img_idx.data_ptr(),
        patches.data_ptr(), origins.data_ptr(), B, H, W, T,
        _build.stream_ptr(imgs.device),
    ), "mc_patch_gather")
    return patches, origins
