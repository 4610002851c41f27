"""The ORB extraction's TPU-shaped glue as three CUDA entries (kernel
sources csrc/orb_pyramid.cu, csrc/orb_select.cu, csrc/orb_describe.cu):
the port's counterparts of what the JAX package's extract_orb_rig
(mcslam_tpu/ops/orb.py :261) runs around its FAST and patch kernels and
XLA fuses on the TPU; no Pallas kernel corresponds to them.

- `orb_pyramid`: the pyramid (jax.image.resize, mcslam_tpu/ops/image.py
  :106 / :120) and the edge-padded level stack (orb.py :306-314), each
  level resized from the one before in a fixed tap order, straight into
  the (L * B, H, W) stack fast_select reads.
- `orb_select`: from fast_select's per-cell candidates, the stable top
  maxb per image (orb.py :219), the undo of the rank bonus, the level
  quota, the EDGE margin and the slot metadata (:420-451), the merge into
  level-major slots and the cross-level compaction to n_out per camera
  (:473-494).
- `orb_describe`: the intensity-centroid angle (patch_orientation, the
  MXU product of orb.py :114) and steered BRIEF-256
  (compute_descriptors_patch, the bf16 MXU matmul of :161).

CUDA tensors launch the kernels; CPU tensors run `<name>_reference`, the
plain PyTorch versions. Each kernel repeats its plain version's float32
operations in their order, so the two agree bit for bit on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mcslam_tpu_torch import _build
from mcslam_tpu_torch.ops import image as image_ops, orb
from mcslam_tpu_torch.utils import graphs

SELECT_CAP = 4096  # slots one orb_select block sorts (csrc/orb_select.cu)


def _check(name, x, dtype, dev, shape=None):
    if x.dtype != dtype or x.device != dev or not x.is_contiguous() or (
            shape is not None and tuple(x.shape) != tuple(shape)):
        raise ValueError(
            f"{name}: the kernel takes a contiguous {dtype} tensor"
            f"{'' if shape is None else f' of shape {tuple(shape)}'} on "
            f"{dev}, got {x.dtype} {tuple(x.shape)} on {x.device}, "
            f"contiguous {x.is_contiguous()}")


def _device(x: torch.Tensor, name: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.device.type


# -- the pyramid ---------------------------------------------------------


def orb_pyramid_reference(imgs: torch.Tensor, num_levels: int,
                          scale: float = 1.2) -> torch.Tensor:
    """Plain PyTorch version of orb_pyramid: the levels by
    image.resize_bilinear, each from the one before, stacked by
    orb.stack_levels."""
    H, W = imgs.shape[-2:]
    levels = [imgs]
    for lh, lw in image_ops.pyramid_shapes(H, W, num_levels, scale)[1:]:
        levels.append(image_ops.resize_bilinear(levels[-1], (lh, lw)))
    return orb.stack_levels(levels)


def orb_pyramid(imgs: torch.Tensor, num_levels: int,
                scale: float = 1.2) -> torch.Tensor:
    """(B, H, W) float32 images -> the (num_levels * B, H, W) stack of
    their pyramid: level l (image.pyramid_shapes) in rows [l B, (l + 1) B),
    its (h_l, w_l) image at the top left, edge-replicated to (H, W).
    CUDA tensors launch the kernel (num_levels - 1 launches, one when
    num_levels is 1); CPU tensors take orb_pyramid_reference."""
    if imgs.dim() != 3:
        raise ValueError(f"orb_pyramid: imgs must be (B, H, W), got "
                         f"{tuple(imgs.shape)}")
    if _device(imgs, "orb_pyramid") == "cpu":
        return orb_pyramid_reference(imgs, num_levels, scale)
    dev = imgs.device
    _check("orb_pyramid: imgs", imgs, torch.float32, dev)
    B, H, W = imgs.shape
    shapes = image_ops.pyramid_shapes(H, W, num_levels, scale)
    out = torch.empty(num_levels * B, H, W, dtype=torch.float32, device=dev)
    # per level >= 1: the vertical and horizontal tap tables (a pass that
    # keeps its size is K = 0: a copy), in the host arrays the launcher reads
    ptrs = (ctypes.c_void_p * max(4 * (num_levels - 1), 1))()
    dims = (ctypes.c_int * max(4 * num_levels, 1))()
    for l, (lh, lw) in enumerate(shapes):
        dims[4 * l:4 * l + 2] = [lh, lw]
        if l == 0:
            continue
        ph, pw = shapes[l - 1]
        for k, (n_in, n_out) in enumerate(((ph, lh), (pw, lw))):
            if n_in == n_out:
                dims[4 * l + 2 + k] = 0
                continue
            taps, first = image_ops.resize_tables(n_in, n_out, dev)
            dims[4 * l + 2 + k] = taps.shape[1]
            ptrs[4 * (l - 1) + 2 * k] = taps.data_ptr()
            ptrs[4 * (l - 1) + 2 * k + 1] = first.data_ptr()
    lib = _build.library()
    _build.count("orb_pyramid")
    _build.check(lib.mc_orb_pyramid(
        imgs.data_ptr(), out.data_ptr(), ptrs, dims, B, H, W, num_levels,
        _build.stream_ptr(dev)), "mc_orb_pyramid")
    return out


# -- selection, quota, margin, metadata and compaction ---------------------


def orb_select_reference(cand_v, cand_rid, h_l, w_l, *, C: int,
                         budgets: tuple, n_out: int, scale: float,
                         ncx: int, cell: int = 16, per_cell: int = 4):
    """Plain PyTorch version of orb_select: the selection chain of the
    production route (orb._select_from_cells, orb._slot_fields,
    orb._compaction) as extract_orb_levels ran it."""
    LC = cand_v.shape[0]
    L = LC // C
    maxb = max(budgets)
    yx, resp, valid = orb._select_from_cells(
        cand_v, cand_rid, maxb, per_cell=per_cell, cell=cell, ncx=ncx)
    fields = orb._slot_fields(yx, resp, valid, h_l, w_l, L=L, C=C,
                              budgets=budgets, scale=scale)
    return orb._merge_compact(*fields, L=L, C=C, n_out=n_out)


def orb_select(cand_v: torch.Tensor, cand_rid: torch.Tensor,
               h_l: torch.Tensor, w_l: torch.Tensor, *, C: int,
               budgets: tuple, n_out: int, scale: float, ncx: int,
               cell: int = 16, per_cell: int = 4):
    """fast_select's candidates (cand_v (L C, G, 4) float32, cand_rid
    (L C, G, 4) int32; cell raster-major, round-minor, ncx cells a row),
    the images' true level heights and widths h_l, w_l ((L C,) int32) and
    the per-level budgets -> (xy (C, n_out, 2) float32, response,
    octave int32, sigma2, valid bool, each (C, n_out); flat_yx (C n_out,
    2) int32 and flat_img (C n_out,) int32, patch_gather's inputs).
    CUDA tensors launch the kernel (two launches: the selection per
    image, then the merge and compaction per camera); CPU tensors take
    orb_select_reference."""
    kw = dict(C=C, budgets=budgets, n_out=n_out, scale=scale, ncx=ncx,
              cell=cell, per_cell=per_cell)
    if cand_v.dim() != 3 or cand_v.shape[-1] != per_cell:
        raise ValueError(f"orb_select: cand_v must be (LC, G, {per_cell}), "
                         f"got {tuple(cand_v.shape)}")
    if _device(cand_v, "orb_select") == "cpu":
        return orb_select_reference(cand_v, cand_rid, h_l, w_l, **kw)
    dev = cand_v.device
    LC, G, _ = cand_v.shape
    L = len(budgets)
    maxb = max(budgets)
    if LC != L * C:
        raise ValueError(f"orb_select: {LC} images are not {L} levels x "
                         f"{C} cameras")
    _check("orb_select: cand_v", cand_v, torch.float32, dev)
    _check("orb_select: cand_rid", cand_rid, torch.int32, dev,
           cand_v.shape)
    for name, x in (("h_l", h_l), ("w_l", w_l)):
        _check(f"orb_select: {name}", x, torch.int32, dev, (LC,))
    n = min(maxb, G * per_cell)
    M = L * maxb
    if max(n, min(n_out, M)) > SELECT_CAP or n_out > M:
        raise ValueError(f"orb_select: the kernel sorts at most {SELECT_CAP} "
                         f"slots and takes n_out <= L maxb, got maxb {maxb}, "
                         f"n_out {n_out}, L maxb {M}")
    # per-level budgets and scales, made once per device
    budget_t = graphs.values(tuple(budgets), torch.int32, dev)
    s_lvl = graphs.values(tuple(scale**lvl for lvl in range(L)),
                          torch.float32, dev)
    scratch = torch.empty(C * M * 4, dtype=torch.int32, device=dev)
    xy = torch.empty(C, n_out, 2, dtype=torch.float32, device=dev)
    resp = torch.empty(C, n_out, dtype=torch.float32, device=dev)
    octave = torch.empty(C, n_out, dtype=torch.int32, device=dev)
    sigma2 = torch.empty(C, n_out, dtype=torch.float32, device=dev)
    valid = torch.empty(C, n_out, dtype=torch.bool, device=dev)
    flat_yx = torch.empty(C * n_out, 2, dtype=torch.int32, device=dev)
    flat_img = torch.empty(C * n_out, dtype=torch.int32, device=dev)
    lib = _build.library()
    _build.count("orb_select")
    _build.check(lib.mc_orb_select(
        cand_v.data_ptr(), cand_rid.data_ptr(), h_l.data_ptr(),
        w_l.data_ptr(), budget_t.data_ptr(), s_lvl.data_ptr(),
        scratch.data_ptr(), xy.data_ptr(), resp.data_ptr(),
        octave.data_ptr(), sigma2.data_ptr(), valid.data_ptr(),
        flat_yx.data_ptr(), flat_img.data_ptr(), L, C, G * per_cell, maxb,
        n_out, ncx, cell, per_cell, orb.EDGE, _build.stream_ptr(dev)),
        "mc_orb_select")
    return xy, resp, octave, sigma2, valid, flat_yx, flat_img


# -- orientation and steered BRIEF -----------------------------------------


def orb_describe_reference(patches: torch.Tensor,
                           angle_bins: int = orb.ANGLE_BINS):
    """Plain PyTorch version of orb_describe: orb.patch_orientation, then
    orb.compute_descriptors_patch."""
    angle = orb.patch_orientation(patches)
    return angle, orb.compute_descriptors_patch(patches, angle, angle_bins)


def orb_describe(patches: torch.Tensor, angle_bins: int = orb.ANGLE_BINS):
    """(T, 39, 39) float32 patches -> (angle (T,) float32, desc (T, 8)
    int32): the intensity-centroid angle atan2(m01, m10) of the circular
    moments summed in a fixed halving tree, and steered BRIEF-256 over
    the bf16-rounded patch in the angle's bin. CUDA tensors launch the
    kernel (one launch); CPU tensors take orb_describe_reference."""
    if patches.dim() != 3 or tuple(patches.shape[1:]) != (orb.PATCH,
                                                           orb.PATCH):
        raise ValueError(f"orb_describe: patches must be (T, {orb.PATCH}, "
                         f"{orb.PATCH}), got {tuple(patches.shape)}")
    if _device(patches, "orb_describe") == "cpu":
        return orb_describe_reference(patches, angle_bins)
    dev = patches.device
    _check("orb_describe: patches", patches, torch.float32, dev)
    T = patches.shape[0]
    index = graphs.const(("orb.steered_index_i16", angle_bins), dev,
                         lambda: orb._steered_sample_index(angle_bins)
                         .astype(np.int16))
    angle = torch.empty(T, dtype=torch.float32, device=dev)
    desc = torch.empty(T, 8, dtype=torch.int32, device=dev)
    lib = _build.library()
    _build.count("orb_describe")
    _build.check(lib.mc_orb_describe(
        patches.data_ptr(), index.data_ptr(), angle.data_ptr(),
        desc.data_ptr(), T, int(angle_bins), float(np.float32(2.0 * np.pi)),
        _build.stream_ptr(dev)), "mc_orb_describe")
    return angle, desc
