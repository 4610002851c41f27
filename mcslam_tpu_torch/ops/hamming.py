"""Binary descriptors as packed 32-bit words (counterpart of
mcslam_tpu/ops/hamming.py).

The JAX package stores BRIEF-256 descriptors as (N, 8) uint32; the port
stores the same bits as (N, 8) int32 (torch's uint32 coverage is thin).
Bit b of word w is descriptor bit 32*w + b (LSB-first), in both.
"""

from __future__ import annotations

import numpy as np
import torch

from mcslam_tpu_torch.utils import graphs

BITS = 256
WORDS = BITS // 32

_SHIFTS = tuple(range(32))


def desc_to_torch(desc_u32, device="cuda") -> torch.Tensor:
    """(..., 8) uint32 array (e.g. np.asarray of a JAX descriptor array)
    -> (..., 8) int32 tensor with identical bits."""
    arr = np.ascontiguousarray(np.asarray(desc_u32, np.uint32))
    return torch.from_numpy(arr.view(np.int32).copy()).to(device)


def desc_to_numpy_u32(desc: torch.Tensor) -> np.ndarray:
    """(..., 8) int32 tensor -> (..., 8) uint32 array, identical bits."""
    return desc.detach().cpu().contiguous().numpy().view(np.uint32)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 words -> (N, 256) int8 in {0, 1} (LSB-first)."""
    shifts = graphs.values(_SHIFTS, torch.int32, packed.device)
    bits = (packed[..., :, None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], BITS).to(torch.int8)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, 256) {0, 1} -> (N, 8) int32 words (LSB-first)."""
    b = bits.reshape(*bits.shape[:-1], WORDS, 32).to(torch.int64)
    shifts = graphs.values(_SHIFTS, torch.int64, bits.device)
    words = torch.sum(b << shifts, dim=-1)  # in [0, 2^32)
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)


def to_planes(packed: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(N, 8) words -> (N, 256) +-1 planes."""
    return (2 * unpack_bits(packed).to(torch.int32) - 1).to(dtype)


def hamming_from_planes(a_planes: torch.Tensor,
                        b_planes: torch.Tensor) -> torch.Tensor:
    """(..., N, 256) x (..., M, 256) +-1 f32 planes -> (..., N, M) int32.
    The f32 product of +-1 values is exact (|dot| <= 256); TF32 is off."""
    dot = a_planes @ b_planes.transpose(-1, -2)
    return ((BITS - dot) * 0.5).to(torch.int32)


def hamming_matrix(a_packed: torch.Tensor,
                   b_packed: torch.Tensor) -> torch.Tensor:
    """(N, 8) x (M, 8) words -> (N, M) int32 Hamming distances."""
    return hamming_from_planes(to_planes(a_packed), to_planes(b_packed))


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (its uint32 bit pattern) -> int32."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def hamming_pairwise(a_packed: torch.Tensor,
                     b_packed: torch.Tensor) -> torch.Tensor:
    """Distance of aligned descriptor arrays: (..., 8) words -> (...,)
    int32."""
    return torch.sum(popcount32(torch.bitwise_xor(a_packed, b_packed)),
                     dim=-1, dtype=torch.int32)
