"""4-path semi-global aggregation of a stereo cost volume, a CUDA entry
(kernel source csrc/sgm_scan.cu), the port's counterpart of the lax.scan
inside the JAX package's jitted disparity (mcslam_tpu/ops/stereo.py
_sgm_pass and sgm_aggregate); no Pallas kernel corresponds to it.

`sgm_aggregate` launches the kernel for CUDA tensors and runs
`sgm_aggregate_reference`, the plain PyTorch version, for CPU tensors.
Both compute the same adds and minima in the same order, so they agree
bit for bit. ops/stereo.sgm_aggregate is the public name; this module
imports nothing of ops/stereo.
"""

from __future__ import annotations

import torch

from mcslam_tpu_torch import _build

MAX_D = 128  # the kernel holds up to 4 x 32 disparities per line in registers


def _sgm_pass(cv_seq: torch.Tensor, p1: float, p2: float) -> torch.Tensor:
    """One SGM path-aggregation direction.

    cv_seq: (S, D, N) - S scan steps along the path, N independent lines,
    D disparities. Returns the aggregated volume, same shape. Classic SGM
    recursion (Hirschmueller): each step's path cost is the step's cost
    plus the best transition from the previous step's (D, N) front (stay,
    +-1 disparity at p1, any jump at p2 over the per-line minimum), less
    that minimum. The steps write into one preallocated (S, D + 2, N)
    buffer whose first and last disparity rows hold the 1e9 border, so
    the +-1 shifts are views; a step is 8 device ops."""
    S, D, N = cv_seq.shape
    buf = torch.full((S, D + 2, N), 1e9, dtype=cv_seq.dtype,
                     device=cv_seq.device)
    buf[0, 1:D + 1] = cv_seq[0]
    for s in range(1, S):
        prev_pad = buf[s - 1]
        prev = prev_pad[1:D + 1]
        m = torch.amin(prev, dim=0, keepdim=True)  # (1, N)
        best = torch.minimum(
            torch.minimum(prev, m + p2),
            torch.minimum(prev_pad[2:], prev_pad[:D]) + p1,
        )
        torch.sub(cv_seq[s] + best, m, out=buf[s, 1:D + 1])
    return buf[:, 1:D + 1]


def sgm_aggregate_reference(cv: torch.Tensor, p1: float = 0.03,
                            p2: float = 0.2) -> torch.Tensor:
    """Plain PyTorch version: 4-path semi-global aggregation of a (D, H,
    W) cost volume (left/right/up/down). The reference's SGBM MODE_HH
    runs 8 paths; 4 axis-aligned paths capture most of the regularization
    at half the scans. The two opposite directions of an axis are
    independent recursions over the same lines, so they run as one pass
    over twice the lines (the reversed sequence beside the forward one):
    two passes of W - 1 and H - 1 steps in all."""
    def both_ways(seq):  # (S, D, N) -> forward, backward aggregates
        N = seq.shape[-1]
        out = _sgm_pass(torch.cat([seq, torch.flip(seq, (0,))], dim=-1),
                        p1, p2)
        return out[..., :N], torch.flip(out[..., N:], (0,))

    # horizontal: scan over W, lines = H
    a, b = both_ways(cv.permute(2, 0, 1))  # (W, D, H)
    # vertical: scan over H, lines = W
    c, d = both_ways(cv.permute(1, 0, 2))  # (H, D, W)
    return (a.permute(1, 2, 0) + b.permute(1, 2, 0) + c.permute(1, 0, 2)
            + d.permute(1, 0, 2))


def scratch_floats(D: int, H: int, W: int) -> int:
    """Floats of the kernel's scratch: one volume (the vertical paths'
    first parts) and the four paths' fronts, 2 D (H + W) (csrc/sgm_scan.cu)."""
    return D * H * W + 2 * D * (H + W)


def sgm_aggregate(cv: torch.Tensor, p1: float = 0.03,
                  p2: float = 0.2) -> torch.Tensor:
    """(D, H, W) floating cost volume -> its 4-path aggregate, same shape
    and dtype. CUDA tensors launch the kernel (a contiguous float32
    volume with D <= MAX_D only); CPU tensors take the plain version."""
    if not cv.is_floating_point() or cv.ndim != 3 or min(cv.shape) < 1:
        raise ValueError(f"sgm_aggregate: cv must be a non-empty (D, H, W) "
                         f"floating tensor, got {cv.dtype} "
                         f"{tuple(cv.shape)}")
    if cv.device.type == "cpu":
        return sgm_aggregate_reference(cv, p1, p2)
    if cv.device.type != "cuda":
        raise ValueError(f"sgm_aggregate: unsupported device {cv.device}")
    D, H, W = cv.shape
    if cv.dtype != torch.float32 or D > MAX_D or not cv.is_contiguous():
        raise ValueError(f"sgm_aggregate: the kernel takes a contiguous "
                         f"float32 volume with D <= {MAX_D}, got {cv.dtype} "
                         f"{(D, H, W)}, contiguous {cv.is_contiguous()}")
    out = torch.empty_like(cv)
    scratch = torch.empty(scratch_floats(D, H, W), dtype=torch.float32,
                          device=cv.device)
    lib = _build.library()
    _build.count("sgm_scan")
    _build.check(lib.mc_sgm_scan(
        cv.data_ptr(), out.data_ptr(), scratch.data_ptr(), D, H, W,
        float(p1), float(p2),
        _build.stream_ptr(cv.device),
    ), "mc_sgm_scan")
    return out
