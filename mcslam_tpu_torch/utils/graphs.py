"""The port's program cache: device programs captured once as CUDA graphs
and replayed (the port's counterpart of jax.jit on the main path; the JAX
package's persistent XLA cache, utils/compile_cache.py, has none).

A `ProgramCache` keys a captured `torch.cuda.CUDAGraph` on what the
caller names static (arguments and input shapes), as jax.jit keys a trace.
The first call for a key warms the function up on a side stream (the
generator's state is put back after it), captures it, then replays it;
every later call copies its inputs into the graph's static inputs and
replays. A replay returns the graph's static outputs, which the next
replay overwrites: a caller clones what it keeps. Each program has its own
memory pool. A failed capture raises; nothing falls back to eager. CUDA
only: CPU tensors take the eager functions (the callers decide).

`cond` is the device-side branch inside a program (the port's
jax.lax.cond): outside a capture both sides run and the result is
selected on the device with torch.where (no host read); in a capture the
body becomes a conditional node (csrc/graph_cond.cu) that runs on replay
only where the predicate holds. Random draws belong before the branch:
the body is captured as a graph of its own, with no generator.

`_build.LAUNCHES` counts the launches the kernel wrappers make: the
warm-up's, which `Program.warmup` also records. A capture launches
nothing (the wrappers count no launch under a capture, `_build.count`)
and a replay runs no wrapper: the kernels a replay runs are counted on
the device, from a profiler trace (chip_smoke.py).

`const` caches the small host-made constants of the captured functions
on their device: a CUDA copy of a host value is a pageable upload, which
a capturing stream refuses, so a function makes its constants during the
warm-up and finds them in the cache when it is captured. `derived` does
the same for values computed from tensors the caller owns (a rig's
calibration): they are made again when a tensor is another object or
was changed in place.
"""

from __future__ import annotations

import collections
import ctypes
import time
import weakref

import torch

from mcslam_tpu_torch import _build

_CONSTS: dict = {}
_DERIVED: dict = {}


def const(key, device, make) -> torch.Tensor:
    """The tensor make() gives (a tensor, a numpy array or a number),
    on `device`, made at the first call for (key, device) and cached: a
    constant that callers only read."""
    device = torch.device(device)
    t = _CONSTS.get((key, device))
    if t is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"graphs.const: {key!r} first made under a "
                               f"capture (the warm-up must make it)")
        v = make()
        t = (v if isinstance(v, torch.Tensor) else torch.as_tensor(v)).to(
            device)
        _CONSTS[(key, device)] = t
    return t


def counters(name: str, n: int, device) -> torch.Tensor:
    """The n int32 arrival counters of kernel `name` on `device`: a const,
    so zeroed when made at the first call, which must not be under a
    capture (a capture replays no zeroing); each launch of the kernel
    leaves them at zero, so calls and graph replays share them."""
    return const(("counters", name, n), device,
                 lambda: torch.zeros(n, dtype=torch.int32))


def values(vals, dtype, device) -> torch.Tensor:
    """const of a number or a tuple of numbers as a `dtype` tensor."""
    return const(("values", vals, dtype), device,
                 lambda: torch.tensor(vals, dtype=dtype))


def derived(key, tensors, make):
    """make()'s value for `tensors` (its inputs, on one device), made at
    the first call and cached by `key`, the tensors' identities and their
    in-place versions (`_version`): another tensor object, or an in-place
    edit of one, makes it again; no host read. Like const, never made
    under a capture (the warm-up makes it); a program captured earlier
    keeps the value it was captured with. The entry goes with the first
    of its tensors to be freed."""
    ident = (key, tuple(id(t) for t in tensors))
    versions = tuple(t._version for t in tensors)
    hit = _DERIVED.get(ident)
    if hit is not None and hit[0] == versions:
        return hit[1]
    dev = tensors[0].device
    if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"graphs.derived: {key!r} made under a capture "
                           f"(the warm-up must make it)")
    value = make()
    if hit is None:
        for t in tensors:
            weakref.finalize(t, _DERIVED.pop, ident, None)
    _DERIVED[ident] = (versions, value)
    return value


class _Prep:
    """The program being prepared: warming up (bodies captured as their
    `cond` calls run) or capturing (each `cond` call, in the same order,
    inserts its body's conditional node)."""

    def __init__(self):
        self.capturing = False
        self.bodies: list = []
        self.n_cond = 0


_PREP: _Prep | None = None


class Program:
    """One captured graph: static inputs, static outputs, the capture's
    host ms, the warm-up's launches and the replay count."""

    def __init__(self, graph, static_in, static_out, capture_ms, warmup,
                 bodies=()):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.capture_ms = capture_ms
        self.warmup = warmup
        self.bodies = list(bodies)  # kept alive: the graph uses their memory
        self.replays = 0

    def pool_bytes(self) -> int:
        """Device memory the graph's pool holds now, and its bodies'."""
        pools = {tuple(p.graph.pool()) for p in (self, *self.bodies)}
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) in pools)

    def __call__(self, *inputs):
        """Copy `inputs` into the static inputs (host tensors through
        pinned memory, non-blocking), replay on the current stream and
        return the static outputs."""
        for s, x in zip(self.static_in, inputs):
            s.copy_(_pinned(x), non_blocking=True)
        self.graph.replay()
        self.replays += 1
        return self.static_out


def _pinned(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu" and not x.is_pinned():
        return x.pin_memory()
    return x


def _capture_body(fn, args) -> Program:
    """A cond body as a graph of its own (kept as a cudaGraph_t, never
    replayed alone), just after it ran eagerly on the same inputs."""
    global _PREP
    prep, _PREP = _PREP, None
    try:
        static_in = [a.clone() for a in args]
        g = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        with torch.cuda.graph(g, capture_error_mode="thread_local"):
            static_out = tuple(fn(*static_in))
        capture_ms = (time.perf_counter() - t0) * 1e3
    finally:
        _PREP = prep
    return Program(g, static_in, static_out, capture_ms,
                   collections.Counter())


def cond(pred: torch.Tensor, body, args, otherwise):
    """body(*args) where the 0-d bool `pred` holds, else `otherwise` (a
    tuple of tensors shaped as body's outputs) -> a tuple of tensors."""
    if pred.dtype != torch.bool or pred.dim() != 0:
        raise ValueError(f"graphs.cond: the predicate must be a 0-d bool "
                         f"tensor, got {pred.dtype} {tuple(pred.shape)}")
    prep = _PREP
    if prep is not None and prep.capturing:
        sub = prep.bodies[prep.n_cond]
        prep.n_cond += 1
        for s, a in zip(sub.static_in, args):
            s.copy_(a)
        _build.check(_build.library().mc_graph_add_if(
            pred.data_ptr(),
            ctypes.c_void_p(sub.graph.raw_cuda_graph()),
            _build.stream_ptr(pred.device)), "mc_graph_add_if")
        out = sub.static_out
    else:
        out = tuple(body(*args))
        if prep is not None:
            prep.bodies.append(_capture_body(body, args))
    return tuple(torch.where(pred, o, e) for o, e in zip(out, otherwise))


def capture(fn, inputs, device, generator=None) -> Program:
    """Warm fn(*inputs) up on a side stream, capture it on `device` (a
    CUDA device; host inputs are copied there) and return the Program
    (not yet replayed). The generator, if any, is registered with the
    graph and its state put back after the warm-up."""
    global _PREP
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"graphs.capture: a CUDA device only, got {dev}")
    cur = torch.cuda.current_stream(dev)
    static_in = [torch.empty(x.shape, dtype=x.dtype, device=dev)
                 for x in inputs]
    for s, x in zip(static_in, inputs):
        s.copy_(_pinned(x), non_blocking=True)
    side = torch.cuda.Stream(dev)
    side.wait_stream(cur)
    state = generator.get_state() if generator is not None else None
    before = collections.Counter(_build.LAUNCHES)
    prep = _PREP = _Prep()
    try:
        with torch.cuda.stream(side):
            fn(*static_in)
        cur.wait_stream(side)
        warmup = _build.LAUNCHES - before
        if generator is not None:
            generator.set_state(state)
        g = torch.cuda.CUDAGraph()
        if generator is not None:
            g.register_generator_state(generator)
        # the default stream cannot capture: a side stream does, and the
        # graph replays on the caller's stream
        cap = side if cur == torch.cuda.default_stream(dev) else cur
        prep.capturing = True
        t0 = time.perf_counter()
        with torch.cuda.graph(g, stream=cap, capture_error_mode="thread_local"):
            static_out = fn(*static_in)
        capture_ms = (time.perf_counter() - t0) * 1e3
        if prep.n_cond != len(prep.bodies):
            raise RuntimeError(f"graphs.capture: {len(prep.bodies)} cond "
                               f"bodies warmed up, {prep.n_cond} captured")
    finally:
        _PREP = None
    return Program(g, static_in, static_out, capture_ms, warmup, prep.bodies)


class ProgramCache:
    """Captured programs by key on one CUDA device, with the generator
    (if any) their random draws take."""

    def __init__(self, device, generator=None):
        self.device = torch.device(device)
        self.generator = generator
        self.programs: dict = {}

    def __call__(self, key, fn, inputs):
        """-> (fn's outputs replayed for `inputs`, the Program). The key
        names everything fn depends on besides the inputs' values."""
        prog = self.programs.get(key)
        if prog is None:
            prog = capture(fn, inputs, self.device, self.generator)
            self.programs[key] = prog
        return prog(*inputs), prog
