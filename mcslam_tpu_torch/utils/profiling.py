"""Named span timers with running averages (counterpart of
StageTimers in mcslam_tpu/utils/profiling.py).

A span measures host wall time. PyTorch returns before the card finishes,
so a span that should include the device work it queued passes `fence`,
a device (or a tensor on it): the span then ends in
`torch.cuda.synchronize(device)`. A CPU fence is a no-op."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class StageTimers:
    """Named span timers with running averages (per-stage stats)."""

    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)
        self.last = {}

    @contextlib.contextmanager
    def span(self, name: str, fence=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if fence is not None:
                dev = fence.device if isinstance(fence, torch.Tensor) \
                    else torch.device(fence)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            self.total[name] += dt
            self.count[name] += 1
            self.last[name] = dt

    def mean_ms(self, name: str) -> float:
        c = self.count.get(name, 0)
        return 1e3 * self.total[name] / c if c else 0.0

    def report(self) -> str:
        return "\n".join(
            f"{name}: mean {self.mean_ms(name):.2f} ms over "
            f"{self.count[name]} calls (last {self.last[name]*1e3:.2f} ms)"
            for name in sorted(self.total))
