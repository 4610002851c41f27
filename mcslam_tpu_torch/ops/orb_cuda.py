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
import functools

import numpy as np
import torch

from mcslam_tpu_torch import _build
from mcslam_tpu_torch.ops import image as image_ops, orb
from mcslam_tpu_torch.utils import graphs

SELECT_CAP = 4096  # slots one orb_select block ranks (csrc/orb_select.cu)

# orb_select's per-camera arrival counters on a device (graphs.counters),
# enough for the most cameras the wrapper takes
SELECT_CAMERAS = 65535


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


PYRAMID_THREADS = 512  # threads of an orb_pyramid block (csrc/orb_pyramid.cu)
PYRAMID_SMEM = 100 * 1024  # shared bytes a launch's blocks may take (two a SM)
PYRAMID_MAX_LEVELS = 8  # levels one launch computes (csrc/orb_pyramid.cu)


def _ranges(rs) -> list:
    """Inclusive index ranges, sorted and merged where they overlap or
    touch, then the two closest merged until two are left."""
    rs = sorted((a, b) for a, b in rs if a <= b)
    out = []
    for a, b in rs:
        if out and a <= out[-1][1] + 1:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    while len(out) > 2:
        k = min(range(len(out) - 1), key=lambda i: out[i + 1][0] - out[i][1])
        out[k:k + 2] = [(out[k][0], out[k + 1][1])]
    return out


def _axis_plan(sizes, P, T, taps, la, lb, align4):
    """One axis of a pyramid launch over levels la..lb (level la - 1 its
    source): (lb - la + 2, T, 8) int32 entries (a0, a1, b0, b1, t0, t1,
    r0, r1) per level and tile: the inclusive ranges A = [a0, a1] and B =
    [b0, b1] (b1 < b0: none) of the level's indices that the tile
    computes (the source level's: stages), the true indices [t0, t1) it
    writes and the edge-replicated ones [r0, r1) it writes as copies of
    index size - 1. The true indices of a level >= 1 are cut in T equal
    parts, its replicated ones [size, P) too; the tile needs its part,
    the edge index where it writes copies, and the taps of what the next
    level needs (taps[l] = (first, K) from level l - 1 to l, K = 0 a
    copy). Level 0 (written where la == 1) is cut at multiples of 4 when
    align4, for 16-byte stores."""
    def cut(n, i):
        return (i * n) // T

    def own(l, i):
        s = sizes[l]
        if l == 0:
            t0, t1 = cut(P, i), cut(P, i + 1)
            if align4:
                t0 = t0 - t0 % 4 if i > 0 else 0
                t1 = t1 - t1 % 4 if i + 1 < T else P
            return t0, t1, 0, 0
        return cut(s, i), cut(s, i + 1), s + cut(P - s, i), s + cut(P - s, i + 1)

    def support(l, rs):
        first, K = taps[l]
        if K == 0:
            return rs
        return [(int(first[a]), int(first[b]) + K - 1) for a, b in rs]

    out = np.zeros((lb - la + 2, T, 8), np.int32)
    for i in range(T):
        need = []
        for l in range(lb, la - 2, -1):
            if l == la - 1:
                t0, t1, r0, r1 = own(l, i) if l == 0 else (0, 0, 0, 0)
            else:
                t0, t1, r0, r1 = own(l, i)
            rs = [(t0, t1 - 1)] + ([(sizes[l] - 1,) * 2] if r1 > r0 else [])
            if l < lb:
                rs += support(l + 1, need)
            need = _ranges(rs)
            (a0, a1), (b0, b1) = (need + [(0, -1)])[:2]
            out[l - la + 1, i] = (a0, a1, b0, b1, t0, t1, r0, r1)
    return out


def _tile_counts(H, W, B, sizes, sms):
    """Tiles per image (TY, TX): at most two blocks a multiprocessor (what
    stays resident at once, so the launch runs in one wave), each tile at
    least 4 rows and columns of every level."""
    tiles = max(1, 2 * sms // B)
    ty = max(1, min(round((tiles * H / W) ** 0.5), min(h for h, _ in sizes) // 4))
    tx = max(1, min(tiles // ty, min(w for _, w in sizes) // 4))
    return ty, tx


def _span(e) -> int:
    """Indices an (a0, a1, b0, b1, ...) entry covers."""
    return int(e[1] - e[0] + 1 + max(0, e[3] - e[2] + 1))


def pyramid_levels(H: int, W: int, num_levels: int, scale: float):
    """The pyramid's levels as the kernel takes them: a (num_levels, 6)
    int32 array, per level (h, w, kv, kh, vt, ht): its true size, the taps
    of its vertical and horizontal pass from the level before (0: the
    axis keeps its size, a copy; level 0 has none) and the offsets of
    those passes' tap tables in the pyramid's one table; and that table,
    int32: per level >= 1 its vertical table (h rows of kv + 1 ints: the
    first tap's index in the level before, then the kv weights' float32
    bits; none where kv = 0), then its horizontal one (w rows of kh + 1)."""
    shapes = image_ops.pyramid_shapes(H, W, num_levels, scale)
    dims = np.zeros((num_levels, 6), np.int32)
    dims[:, :2] = shapes
    blocks, n = [], 0
    for l in range(1, num_levels):
        for k, (n_in, n_out) in enumerate(zip(shapes[l - 1], shapes[l])):
            dims[l, 4 + k] = n
            if n_in == n_out:
                continue
            taps, first = image_ops.resize_taps(n_in, n_out)
            dims[l, 2 + k] = taps.shape[1]
            blocks.append(np.concatenate(
                [first[:, None], taps.view(np.int32)], 1).ravel())
            n += blocks[-1].size
    table = np.concatenate(blocks) if blocks else np.zeros(1, np.int32)
    return dims, table


def _segment_smem(rows, cols, ks) -> tuple:
    """(bytes, buffer A floats, buffer B floats, vertical pass floats,
    the widest region's columns) of one launch (ks: per level >= 1 of it
    its (kv, kh)): its levels' regions alternate between two buffers (the
    source level in A), one buffer holds a level's vertical pass (its
    rows by the previous region's columns), then every level's two plan
    entries and the tile's tap tables (the rows of the pyramid's table
    that its computed rows and columns take, per level and axis)."""
    nr = [max(_span(e) for e in rows[k]) for k in range(len(rows))]
    nc = [max(_span(e) for e in cols[k]) for k in range(len(cols))]
    area = [r * c for r, c in zip(nr, nc)]
    buf_a = max(area[0::2])
    buf_b = max(area[1::2], default=0)
    vbuf = max((nr[k] * nc[k - 1] for k in range(1, len(nr))), default=0)
    tabs = sum(n * (K + 1) for k, (kv, kh) in enumerate(ks, 1)
               for n, K in ((nr[k], kv), (nc[k], kh)) if K)
    floats = buf_a + buf_b + vbuf + 16 * len(rows) + tabs
    return (4 * floats, buf_a, buf_b, vbuf, max(nc))


@functools.lru_cache(maxsize=None)
def pyramid_plan(H: int, W: int, num_levels: int, scale: float, B: int,
                 sms: int, smem: int = PYRAMID_SMEM):
    """The launches of orb_pyramid for B images of (H, W): a list of
    (la, lb, TY, TX, rows, cols, sizes) per launch, which computes levels
    la..lb (<= PYRAMID_MAX_LEVELS of them) from level la - 1 (the input
    where la == 1, then also writing level 0) in TY x TX tiles per image;
    rows / cols are _axis_plan's entries, sizes _segment_smem's. A launch
    takes as many levels as fit in smem bytes of shared memory with every
    region at most PYRAMID_THREADS columns wide (a thread a column in the
    horizontal pass); where not even one does, the tiles are halved."""
    shapes = image_ops.pyramid_shapes(H, W, num_levels, scale)
    hs, ws = [h for h, _ in shapes], [w for _, w in shapes]
    vt, ht = [None], [None]
    for l in range(1, num_levels):
        for n_in, n_out, t in ((hs[l - 1], hs[l], vt), (ws[l - 1], ws[l], ht)):
            if n_in == n_out:
                t.append((None, 0))
            else:
                taps, first = image_ops.resize_taps(n_in, n_out)
                t.append((first, taps.shape[1]))
    ty, tx = _tile_counts(H, W, B, shapes, sms)
    while True:
        segs, la, ok = [], 1, True
        while la < num_levels or (la == 1 and not segs):
            lb, best = la - 1, None
            while lb + 1 < num_levels and lb + 1 - la < PYRAMID_MAX_LEVELS:
                plan = _segment(hs, ws, H, W, ty, tx, vt, ht, la, lb + 1)
                if not _fits(plan[2], smem):
                    break
                lb, best = lb + 1, plan
            if best is None:
                best = _segment(hs, ws, H, W, ty, tx, vt, ht, la, lb)
                if not _fits(best[2], smem) or lb < la and num_levels > 1:
                    ok = False
                    break
            segs.append((la, lb, ty, tx) + best)
            la = lb + 1
            if num_levels == 1:
                break
        if ok:
            return segs
        if ty >= min(hs) // 2 and tx >= min(ws) // 2:
            raise ValueError(f"orb_pyramid: no tiling of {H}x{W} with "
                             f"{num_levels} levels fits {smem} bytes")
        ty, tx = min(2 * ty, max(1, min(hs) // 2)), min(2 * tx, max(1, min(ws) // 2))


def _fits(sizes, smem) -> bool:
    return sizes[0] <= smem and sizes[-1] <= PYRAMID_THREADS


def _segment(hs, ws, H, W, ty, tx, vt, ht, la, lb):
    rows = _axis_plan(hs, H, ty, vt, la, lb, False)
    cols = _axis_plan(ws, W, tx, ht, la, lb, W % 4 == 0 and W // tx >= 8)
    ks = [(vt[l][1], ht[l][1]) for l in range(la, lb + 1)]
    return rows, cols, _segment_smem(rows, cols, ks)


@functools.lru_cache(maxsize=None)
def _pyramid_args(H, W, num_levels, scale, B, smem, dev):
    """orb_pyramid's launch arguments for B images of (H, W) on dev, made
    once: the tap table on the card, and the host arrays the launcher
    reads (pyramid_levels' dims; per launch la, lb, TY, TX, shared bytes
    and the buffers' floats (A, B, the vertical pass); per launch its
    plan's device pointer: row entries, then column entries)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    key = (H, W, num_levels, scale)
    segs = pyramid_plan(*key, B, sms, smem)
    levels, table = pyramid_levels(*key)
    taps = graphs.const(("orb_cuda.pyramid_taps",) + key, dev, lambda: table)
    dims = (ctypes.c_int * levels.size)(*levels.ravel().tolist())
    nseg = len(segs)
    segi = (ctypes.c_int * (8 * nseg))()
    plans = (ctypes.c_void_p * nseg)()
    for k, (la, lb, ty, tx, rows, cols, sizes) in enumerate(segs):
        segi[8 * k:8 * (k + 1)] = [la, lb, ty, tx, *sizes[:4]]
        plans[k] = graphs.const(
            ("orb_cuda.pyramid_plan",) + key + (B, sms, smem, k), dev,
            lambda rows=rows, cols=cols: np.concatenate(
                [rows.ravel(), cols.ravel()])).data_ptr()
    return taps, dims, plans, segi, nseg


def orb_pyramid(imgs: torch.Tensor, num_levels: int,
                scale: float = 1.2) -> torch.Tensor:
    """(B, H, W) float32 images -> the (num_levels * B, H, W) stack of
    their pyramid: level l (image.pyramid_shapes) in rows [l B, (l + 1) B),
    its (h_l, w_l) image at the top left, edge-replicated to (H, W).
    CUDA tensors launch the kernel (one launch per pyramid_plan segment:
    one at the bench shape); CPU tensors take orb_pyramid_reference."""
    if imgs.dim() != 3:
        raise ValueError(f"orb_pyramid: imgs must be (B, H, W), got "
                         f"{tuple(imgs.shape)}")
    if _device(imgs, "orb_pyramid") == "cpu":
        return orb_pyramid_reference(imgs, num_levels, scale)
    dev = imgs.device
    _check("orb_pyramid: imgs", imgs, torch.float32, dev)
    B, H, W = imgs.shape
    if B > 65535:
        raise ValueError(f"orb_pyramid: at most 65535 images, got {B}")
    out = torch.empty(num_levels * B, H, W, dtype=torch.float32, device=dev)
    if B == 0:
        return out
    taps, dims, plans, segi, nseg = _pyramid_args(
        H, W, num_levels, float(scale), B, PYRAMID_SMEM, dev)
    lib = _build.library()
    _build.count("orb_pyramid")
    _build.check(lib.mc_orb_pyramid(
        imgs.data_ptr(), out.data_ptr(), taps.data_ptr(), dims, plans, segi,
        nseg, B, H, W, num_levels, _build.stream_ptr(dev)), "mc_orb_pyramid")
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
    CUDA tensors launch the kernel (one launch: a block per image, the
    camera's last block doing the merge and compaction); CPU tensors take
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
    if LC != L * C or C > SELECT_CAMERAS:
        raise ValueError(f"orb_select: {LC} images are not {L} levels x "
                         f"{C} cameras, or more than {SELECT_CAMERAS} "
                         f"cameras")
    _check("orb_select: cand_v", cand_v, torch.float32, dev)
    _check("orb_select: cand_rid", cand_rid, torch.int32, dev,
           cand_v.shape)
    for name, x in (("h_l", h_l), ("w_l", w_l)):
        _check(f"orb_select: {name}", x, torch.int32, dev, (LC,))
    n = min(maxb, G * per_cell)
    M = L * maxb
    if max(n, min(n_out, M)) > SELECT_CAP or n_out > M:
        raise ValueError(f"orb_select: the kernel ranks at most {SELECT_CAP} "
                         f"slots and takes n_out <= L maxb, got maxb {maxb}, "
                         f"n_out {n_out}, L maxb {M}")
    counters = graphs.counters("orb_select", SELECT_CAMERAS, dev)
    # per-level budgets and scales, made once per device
    budget_t = graphs.values(tuple(budgets), torch.int32, dev)
    s_lvl = graphs.values(tuple(scale**lvl for lvl in range(L)),
                          torch.float32, dev)
    # per slot its fields (4 int32), then per slot a sorted prio key (int64)
    scratch = torch.empty(C * M * 6, dtype=torch.int32, device=dev)
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
        scratch.data_ptr(), counters.data_ptr(), xy.data_ptr(),
        resp.data_ptr(),
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
