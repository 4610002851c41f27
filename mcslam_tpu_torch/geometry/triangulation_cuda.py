"""Triangulation with its Gauss-Newton refine and gate in one launch, a
CUDA entry (kernel source csrc/tri_refine.cu), the port's counterpart of
the TPU-shaped fused triangulation of the JAX package
(mcslam_tpu/geometry/triangulation.py triangulate_and_refine); no Pallas
kernel corresponds to it.

`tri_refine` launches the kernel for CUDA tensors; the plain version is
geometry/triangulation.triangulate_and_refine_reference, and
geometry/triangulation.triangulate_and_refine dispatches between the two
by device. The kernel repeats the plain version's float32 operations in
their order, so the two agree bit for bit on the card.
"""

from __future__ import annotations

import torch

from mcslam_tpu_torch import _build

MAX_R = 8  # rays per point the kernel is instantiated for


def _flat(x: torch.Tensor, M: int, R: int, tail: tuple, name: str):
    """(..., R, *tail) -> an (M, R, *tail) view (a copy only where the
    batch dims cannot be merged)."""
    if tuple(x.shape[-len(tail) - 1:]) != (R, *tail):
        raise ValueError(f"tri_refine: {name} must end in {(R, *tail)}, got "
                         f"{tuple(x.shape)}")
    return x.reshape(M, R, *tail)


def tri_refine(world_T_cam: torch.Tensor, uv: torch.Tensor,
               fxycxy: torch.Tensor, mask: torch.Tensor,
               sigma: torch.Tensor | float = 1.0, chi2_thresh: float = 5.991,
               min_z: float = 0.1, max_z: float = 40.0,
               gn_iters: int = 5) -> tuple[torch.Tensor, torch.Tensor]:
    """triangulate_and_refine on the card: world_T_cam (..., R, 4, 4), uv
    (..., R, 2), fxycxy (..., R, 4) float32; mask (..., R) bool; sigma a
    number or a float32 tensor that broadcasts to mask -> (X (..., 3), ok
    (...,)). Inputs are read through their strides (an expanded pose
    table is read as its distinct poses)."""
    dev = mask.device
    if dev.type != "cuda":
        raise ValueError(f"tri_refine: CUDA tensors only, got {dev}")
    batch_shape = mask.shape[:-1]
    R = mask.shape[-1]
    M = 1
    for s in batch_shape:
        M *= s
    if not 1 <= R <= MAX_R:
        raise ValueError(f"tri_refine: the kernel takes 1 to {MAX_R} rays "
                         f"per point, got {R}")
    for name, x in (("world_T_cam", world_T_cam), ("uv", uv),
                    ("fxycxy", fxycxy)):
        if x.dtype != torch.float32 or x.device != dev:
            raise ValueError(f"tri_refine: {name} must be float32 on {dev}, "
                             f"got {x.dtype} on {x.device}")
        if tuple(x.shape[:len(batch_shape)]) != tuple(batch_shape):
            raise ValueError(f"tri_refine: {name} {tuple(x.shape)} does not "
                             f"match the mask {tuple(mask.shape)}")
    if mask.dtype != torch.bool:
        raise ValueError(f"tri_refine: mask must be bool, got {mask.dtype}")
    T = _flat(world_T_cam, M, R, (4, 4), "world_T_cam")
    q = _flat(uv, M, R, (2,), "uv")
    f = _flat(fxycxy, M, R, (4,), "fxycxy")
    k = mask.reshape(M, R)
    if isinstance(sigma, torch.Tensor) and sigma.dim() == 0 \
            and sigma.device.type == "cpu":
        sigma = float(sigma)
    if isinstance(sigma, torch.Tensor):
        if sigma.dtype != torch.float32 or sigma.device != dev:
            raise ValueError(f"tri_refine: sigma must be float32 on {dev}, "
                             f"got {sigma.dtype} on {sigma.device}")
        s = torch.broadcast_to(sigma, mask.shape).reshape(M, R)
        s_ptr, s_strides, s_val = s.data_ptr(), s.stride(), 1.0
    else:
        s_ptr, s_strides, s_val = None, (0, 0), float(sigma)
    strides = (*T.stride(), *q.stride(), *f.stride(), *k.stride(), *s_strides)
    if max(abs(v) for v in strides) * max(M, 1) >= 2**31:
        raise ValueError("tri_refine: inputs too large for 32-bit strides")
    X = torch.empty(M, 3, dtype=torch.float32, device=dev)
    ok = torch.empty(M, dtype=torch.bool, device=dev)
    lib = _build.library()
    _build.count("tri_refine")
    _build.check(lib.mc_tri_refine(
        T.data_ptr(), q.data_ptr(), f.data_ptr(), k.data_ptr(), s_ptr,
        X.data_ptr(), ok.data_ptr(), M, R, *strides, int(gn_iters), s_val,
        float(chi2_thresh), float(min_z), float(max_z),
        _build.stream_ptr(dev),
    ), "mc_tri_refine")
    return X.reshape(*batch_shape, 3), ok.reshape(batch_shape)
