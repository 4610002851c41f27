"""Named span timers with running averages, a device fence and a
profiler trace (counterpart of mcslam_tpu/utils/profiling.py).

A span measures host wall time. PyTorch returns before the card finishes,
so a span that should include the device work it queued passes `fence`,
a device (or a tensor on it): the span then ends in
`torch.cuda.synchronize(device)`. A CPU fence is a no-op."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


def sync(x) -> None:
    """Device fence: wait for the CUDA work queued on the device of x (a
    tensor, or the first tensor found in a nested list / tuple / dict);
    a no-op for CPU tensors and for no tensor."""
    stack = [x]
    while stack:
        v = stack.pop(0)
        if isinstance(v, torch.Tensor):
            if v.device.type == "cuda":
                torch.cuda.synchronize(v.device)
            return
        if isinstance(v, dict):
            stack.extend(v.values())
        elif isinstance(v, (list, tuple)):
            stack.extend(v)


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


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a torch.profiler trace of the block (CPU and, where there
    is a card, CUDA activity) and write it into `logdir` as a Chrome
    trace (`trace.json`; open in chrome://tracing or Perfetto)."""
    import os

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
