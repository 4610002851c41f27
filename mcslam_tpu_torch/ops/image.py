"""Dense image ops: separable Gaussian blur, the reflect-padded separable
convolution, antialiased bilinear resize, pyramids (counterpart of
mcslam_tpu/ops/image.py). Images are
(..., H, W) float32 in [0, 1], batched over leading dims.

The resize reproduces jax.image.resize(method="bilinear") — which
antialiases when downsampling (a triangle filter widened by the scale) —
with the weights built in numpy the way jax/_src/image/scale.py builds
them, applied as a vertical then a horizontal pass over each output's
few nonzero taps in a fixed order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mcslam_tpu_torch.utils import graphs


def _np_gaussian_taps(ksize: int, sigma: float) -> tuple:
    r = (ksize - 1) / 2
    x = np.arange(ksize, dtype=np.float64) - r
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    k = k / k.sum()
    return tuple(float(v) for v in k)


def gaussian_kernel(ksize: int, sigma: float,
                    device="cuda") -> torch.Tensor:
    """(ksize,) f32 normalized Gaussian taps, computed in float32 as the
    JAX package's gaussian_kernel does."""
    x = torch.arange(ksize, dtype=torch.float32, device=device) - (
        ksize - 1) / 2
    k = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / torch.sum(k)


def gaussian_blur(img: torch.Tensor, ksize: int = 7,
                  sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur with reflect padding (vertical pass, then
    horizontal)."""
    return _sep_conv(img, graphs.values(_np_gaussian_taps(ksize, sigma),
                                        torch.float32, img.device))


def _sep_conv(img: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Separable 2D convolution with reflect padding, batched over leading
    dims: the vertical pass, then the horizontal, each summing the taps in
    order (the convolution path of the JAX package's _sep_conv, whose
    banded-matmul branch serves the TPU only). k: (ksize,) f32 taps."""
    ksize = k.shape[0]
    pad = ksize // 2
    h, w = img.shape[-2:]
    x = img.reshape(-1, 1, h, w)
    x = torch.nn.functional.pad(x, (pad, pad, pad, pad), mode="reflect")
    acc = None
    for t in range(ksize):
        term = x[:, :, t:t + h, :] * k[t]
        acc = term if acc is None else acc + term
    out = None
    for t in range(ksize):
        term = acc[:, :, :, t:t + w] * k[t]
        out = term if out is None else out + term
    return out.reshape(img.shape)


@functools.lru_cache(maxsize=None)
def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) f32 antialiased-linear weights as jax.image's
    compute_weight_mat gives them inside a jitted resize (scale = out/in,
    translation 0, triangle kernel). The compiled program contracts the
    sample position (i + 0.5) * inv_scale - 0.5 into one FMA and divides
    by multiplying with reciprocals, so that is how they are computed
    here (to within 1-2 f32 ulp of JAX's)."""
    f32 = np.float32
    scale = n_out / n_in
    inv_scale = f32(1.0 / scale)
    kernel_scale = max(inv_scale, f32(1.0))
    s = np.arange(n_out, dtype=f32) + f32(0.5)
    sample_f = (s.astype(np.float64) * np.float64(inv_scale) - 0.5).astype(f32)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        * (f32(1.0) / kernel_scale)
    weights = np.maximum(f32(0.0), f32(1.0) - x).astype(f32)
    total = np.sum(weights, axis=0, keepdims=True, dtype=f32)
    ok = np.abs(total) > f32(1000.0 * float(np.finfo(np.float32).eps))
    inv_total = f32(1.0) / np.where(total != 0, total, f32(1.0))
    weights = np.where(ok, weights * inv_total, f32(0.0)).astype(f32)
    inside = (sample_f >= f32(-0.5)) & (sample_f <= f32(n_in - 0.5))
    weights = np.where(inside[None, :], weights, f32(0.0)).astype(f32)
    return np.ascontiguousarray(weights.T)


MAX_TAPS = 8  # taps per output the pyramid kernel takes (csrc/orb_pyramid.cu)


@functools.lru_cache(maxsize=None)
def resize_taps(n_in: int, n_out: int) -> tuple[np.ndarray, np.ndarray]:
    """The nonzero taps of _resize_matrix(n_in, n_out): (n_out, K) f32
    weights and the (n_out,) int32 input index of each output's first
    tap, taps in ascending input index, K the widest support found (a
    narrower one padded with zero weights; the window shifted left to
    stay inside the input). At the pyramid's scale 1.2 the triangle's
    support is under +-1.2 input pixels, so K <= 3."""
    W = _resize_matrix(n_in, n_out)
    nz = W != 0
    lo = np.where(nz.any(1), nz.argmax(1), 0)
    hi = np.where(nz.any(1), n_in - 1 - nz[:, ::-1].argmax(1), 0)
    K = int(max(1, (hi - lo + 1).max()))
    assert K <= min(n_in, MAX_TAPS), (n_in, n_out, K)
    first = np.minimum(lo, n_in - K)
    idx = first[:, None] + np.arange(K)[None, :]
    taps = np.take_along_axis(W, idx, axis=1).astype(np.float32)
    assert np.array_equal(W[np.arange(n_out)[:, None], idx], taps) and \
        np.count_nonzero(W) == np.count_nonzero(taps)
    return np.ascontiguousarray(taps), first.astype(np.int32)


def _resize_pass(x: torch.Tensor, taps: torch.Tensor, first: torch.Tensor,
                 dim: int) -> torch.Tensor:
    """One pass of the resize along dim (-2 or -1): output o is
    w0 x[f + 0] + w1 x[f + 1] + ... added left to right, each product and
    sum rounded to f32 (the order csrc/orb_pyramid.cu repeats)."""
    acc = None
    for k in range(taps.shape[1]):
        src = torch.index_select(x, dim, (first + k).long())
        w = taps[:, k][:, None] if dim == -2 else taps[:, k]
        term = src * w
        acc = term if acc is None else acc + term
    return acc


def resize_bilinear(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Antialiased bilinear resize of (..., H, W) to (..., h, w): the
    vertical pass, then the horizontal, each over its few nonzero taps
    (resize_taps) in a fixed order, every product and sum an f32
    elementwise op, so that every device and every batch size gives the
    same bits (the camera-sharded frame build, parallel/sharded_frame)."""
    h, w = img.shape[-2:]
    oh, ow = out_hw
    x = img
    for n_in, n_out, dim in ((h, oh, -2), (w, ow, -1)):
        if n_in != n_out:
            taps, first = resize_tables(n_in, n_out, img.device)
            x = _resize_pass(x, taps, first, dim)
    return x


def resize_tables(n_in: int, n_out: int, device):
    """resize_taps(n_in, n_out) on `device` (made once per device)."""
    return (graphs.const(("image.resize_taps", n_in, n_out), device,
                         lambda: resize_taps(n_in, n_out)[0]),
            graphs.const(("image.resize_first", n_in, n_out), device,
                         lambda: resize_taps(n_in, n_out)[1]))


@functools.lru_cache(maxsize=None)
def pyramid_shapes(h: int, w: int, num_levels: int, scale: float) -> tuple:
    out = []
    for lvl in range(num_levels):
        s = scale**lvl
        out.append((max(8, int(round(h / s))), max(8, int(round(w / s)))))
    return tuple(out)


def build_pyramid(img: torch.Tensor, num_levels: int = 8,
                  scale: float = 1.2) -> list[torch.Tensor]:
    """List of (..., h_l, w_l) images, level 0 = input; each level is
    resized from the previous one. The levels are views of one stacked
    buffer (ops/orb_cuda.orb_pyramid: its kernel for CUDA tensors)."""
    from mcslam_tpu_torch.ops import orb_cuda

    *lead, h, w = img.shape
    flat = img.reshape(-1, h, w)
    B = flat.shape[0]
    stacked = orb_cuda.orb_pyramid(flat, num_levels, scale)
    return [stacked[l * B:(l + 1) * B, :lh, :lw].reshape(*lead, lh, lw)
            for l, (lh, lw) in enumerate(pyramid_shapes(h, w, num_levels,
                                                        scale))]


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) -> (..., H, W) with the BT.601 weights (as
    cv2.cvtColor)."""
    w = graphs.values((0.299, 0.587, 0.114), img.dtype, img.device)
    return torch.einsum("...c,c->...", img, w)


def clahe_like(img: torch.Tensor, grid: int = 8,
               clip: float = 0.02) -> torch.Tensor:
    """Cheap contrast normalization standing in for the reference's CLAHE
    preprocessing (FrontEnd.h:196-257): local mean / std normalization
    with a box filter (_sep_conv's reflect padding), squashed back to
    [0, 1] by a sigmoid."""
    h, w = img.shape[-2:]
    k = max(h, w) // grid | 1
    k = min(k, 63) | 1
    box = torch.full((k,), 1.0 / k, dtype=torch.float32)
    mean = _sep_conv(img, box)
    sq = _sep_conv(img * img, box)
    std = torch.sqrt(torch.clamp(sq - mean * mean, min=1e-6))
    return torch.sigmoid((img - mean) / torch.clamp(std, min=clip))
