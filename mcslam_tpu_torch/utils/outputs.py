"""A kernel wrapper's outputs carved from one allocation: contiguous
views of one float32 buffer, each starting at a multiple of ALIGN bytes
(where an allocation of its own would start), so that a call pays one
allocator round trip where it would pay one per output. The views keep
the shapes, strides and dtypes the consumers read; a bool view starts
at an ALIGN-byte boundary like any other."""

from __future__ import annotations

import math

import torch

ALIGN = 512  # bytes: where each carved output view starts


def layout(shapes, dtypes):
    """((shape, stride, offset, dtype), ...) of contiguous views of one
    float32 buffer, each starting at a multiple of ALIGN bytes (the offset
    in elements of its dtype), and the buffer's length in floats."""
    views, off = [], 0
    for shape, dt in zip(shapes, dtypes):
        stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
        views.append((shape, stride, off // dt.itemsize, dt))
        off += -(-math.prod(shape) * dt.itemsize // ALIGN) * ALIGN
    return tuple(views), max(off // 4, 1)


def carve(lay, dev) -> list:
    """The views of a layout, carved from one buffer allocated on dev."""
    views, n = lay
    buf = torch.empty(n, dtype=torch.float32, device=dev)
    s0 = buf.storage_offset()  # in floats: 0 but for a view handed out
    bases = {torch.float32: buf}
    out = []
    for shape, stride, off, dt in views:
        b = bases.get(dt)
        if b is None:
            b = bases[dt] = buf.view(dt)
        out.append(b.as_strided(shape, stride, s0 * 4 // dt.itemsize + off))
    return out
