"""Memory and determinism guard of the frame build's kernels tri_refine
(csrc/tri_refine.cu), intra_pairs (csrc/intra_match.cu), the intra
match's glue (intra_gate, intra_groups, tri_gather: csrc/intra_glue.cu),
the ORB
extraction's orb_pyramid, orb_select and orb_describe (csrc/orb_*.cu),
the tracking's pose_lm (csrc/pose_lm.cu) and its glue (track_gate,
track_epilogue, localmap_gate, localmap_epilogue: csrc/track_glue.cu),
on one CUDA card.

Runs each kernel at chip_smoke.py phase 2's shapes: tri_refine at bench
frame 0's M = 2048 groups of R = 4 rays (the pose table expanded, as the
frame build passes it), at M = 2048, R = 2, at M = 37, R = 5 and at M =
2048, R = 8; intra_pairs at bench frame 0's C = 4 x N = 768 descriptors
and Sampson gate, eagerly and through a captured CUDA graph, and at
random C = 2, 3 and 5; the intra glue's three kernels at bench frame 0's
calls (not --quick; through a captured CUDA graph too) and at random
problems (C = 2, N = 333, M = 500; C = 3, N = 129, M = 2048; C = 5, N =
1000, M = 2048; with --quick also C = 4, N = 768 through graph replays;
the designs' edges at C = 3, N = 200: the gate on NaN pixels with the
threshold on a cell's quotient, the groups with every feature a root and
with most features of two cameras on one root; tri_gather at M = 31, 33,
2049, 100 and 40 groups of C = 1, 3, 4, 5 and 33 cameras with groups of
no, one and every ray, eagerly and through graph replays); the three ORB
kernels at bench frame 0's inputs (orb_pyramid and orb_select also
through a captured CUDA graph) and at
random ones (the pyramid at 1 x 97 x 133 with 8 levels, 5 x 120 x 160
with 4 and 2 x 240 x 320 with 10 in two launches, the selection on
plateau-tied candidates with and without padding, the descriptors of 777
noise patches at 32 bins); pose_lm at B = 1 and 2 candidates of M = 2048
observations and at B = 3, M = 333; the RANSAC kernels (ransac_score,
kabsch_hyp, pnp_hyp) at the calls of bench frame 1's step with its
portfolio forced (the score at K = 1, 512, 256 and 3, also through a
captured CUDA graph) and at random problems (K = 257, M = 37; the score
at K = 1 and 512, M = 2048, and at K = 3, 33 and 513, M = 2049, which end
one past a tile); the tracking glue's four kernels at the calls of bench
frame 1's fast-path step (not --quick; each also through a captured
CUDA graph) and at random problems (C = 4, M = N = 2048, L = 4096,
through graph replays with --quick; C = 3, M = 2049, N = 2047, L =
4097; C = 1, M = 37, N = 33, L = 45), each also at C = 2, M = 33, N =
40, L = 65,
at C = 4, M = 161, N = 200, L = 191 with every row a match with a
landmark, at C = 3, M = N = 2048, L = 4096 with none with a landmark, at
C = 4, M = N = 2048, L = 4096 with no previous feature with a landmark
and at C = 3, M = 97, N = 130, L = 50 with the map rows behind the
cameras, each eagerly and through graph replays, track_epilogue's
packed vector a buffer of its own; vio_factors (csrc/vio_factors.cu) at
chip_smoke.py phase 2's problems (three at stage D, one at K = 12, one
with 60 IMU slots, which reads the factors' blocks from the scratch and
loads each entry's start when it places it), with GPS factors only and
with no factor table,
each eagerly and through graph replays, its records guarded too. Every buffer a wrapper allocates (its
outputs and its scratch, ransac_score's bit rows too) is placed inside
a slab of canary bytes, PAD bytes on each side, the canary alternating from launch to
launch (fixed in a graph, whose capture holds the slabs' filling), and
so are intra_pairs', orb_select's, ransac_score's and track_epilogue's
per-device buffers of arrival counters (ransac_score's K count
accumulators and track_epilogue's 64-bit counter of its two counts).
After every launch it checks that no canary byte changed (a write out
of bounds), that the counters are back at zero, that no input changed
(a write into an input), and that the outputs equal the first launch's
and, but for pose_lm's, the RANSAC kernels' and vio_factors', which round in another
order, the plain version's bit for bit (a race or an unwritten output
shows as a difference). Run from the repository's
root on a machine with a card and nvcc:

    python3 scripts/kernel_guard.py [--reps 50] [--quick] [--sanitize]
        [--groups frame intra_glue orb pose ransac track vio]

--quick leaves out the bench scene (random problems only, R = 4 with an
expanded pose table too, and the graph replays of intra_pairs at a
random C = 4 x N = 768 and of orb_select on random candidates). --sanitize then runs this script with --quick
--reps 2 under compute-sanitizer's memcheck, racecheck and synccheck
tools, where the toolkit has it, and prints each tool's exit code and
report, or that the tool did not run (it refuses a device it cannot
attach to). Exits with
a code other than 0 if a check fails or a tool that ran reports an
error.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import os
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PAD = 1 << 20  # canary bytes on each side of a wrapper's buffer
CANARIES = (0xA5, 0x5A)
MAX_REPORT = 400  # lines of a sanitizer's report printed
INT_OF_SIZE = {1: "uint8", 2: "int16", 4: "int32", 8: "int64"}


@contextlib.contextmanager
def guarded_empty(slabs: list, canary: int):
    """torch.empty -> a view into the middle of a canary-filled slab (the
    wrappers allocate their outputs and scratch by torch.empty)."""
    import torch

    real = torch.empty

    def empty(*size, dtype=None, device=None, **kw):
        if len(size) == 1 and isinstance(size[0], (tuple, list, torch.Size)):
            size = tuple(size[0])
        dtype = dtype or torch.get_default_dtype()
        nbytes = math.prod(size) * real((), dtype=dtype).element_size()
        slab = real(2 * PAD + nbytes, dtype=torch.uint8, device=device)
        slab.fill_(canary)
        slabs.append((slab, nbytes))
        return slab[PAD:PAD + nbytes].view(dtype).view(size)

    torch.empty = empty
    try:
        yield
    finally:
        torch.empty = real


@contextlib.contextmanager
def guarded_counters(fn, dev, canary: int, found: list, args=()):
    """The arrival counters of `dev` that fn(*args)'s kernel uses
    (intra_pairs', orb_select's, ransac_score's K count accumulators and
    its counter; none for the others) -> a zeroed view into the middle of
    a canary-filled slab, for as long as the context lasts; the slab goes
    to `found` as (slab, bytes, canary)."""
    import torch

    from mcslam_tpu_torch.frontend import intra_cuda, ransac_cuda
    from mcslam_tpu_torch.ops import orb_cuda
    from mcslam_tpu_torch.utils import graphs

    name, count = {intra_cuda.intra_pairs: ("intra_pairs", intra_cuda.COUNTERS),
                   orb_cuda.orb_select: ("orb_select",
                                         orb_cuda.SELECT_CAMERAS),
                   ransac_cuda.score: ("ransac_score",
                                       args[0].shape[0] + 1 if args else 1),
                   track_epilogue: ("track_epilogue", 2),
                   }.get(fn, (None, 0))
    if name is None:
        yield
        return
    # graphs.counters' entry of (name, count) on dev
    key = (("counters", name, count), torch.device(dev))
    saved = graphs._CONSTS.get(key)
    n = count * 4
    slab = torch.empty(2 * PAD + n, dtype=torch.uint8, device=dev)
    slab.fill_(canary)
    slab[PAD:PAD + n].zero_()
    graphs._CONSTS[key] = slab[PAD:PAD + n].view(torch.int32)
    found.append((slab, n, canary))
    try:
        yield
    finally:
        if saved is None:
            graphs._CONSTS.pop(key)
        else:
            graphs._CONSTS[key] = saved


def persistent_fails(name, rep, found) -> list[str]:
    """Canary bytes changed around, and counters not back at zero in, the
    guarded counter slabs."""
    fails = []
    for slab, n, canary in found:
        bad = int((slab[:PAD] != canary).sum()) \
            + int((slab[PAD + n:] != canary).sum())
        if bad:
            fails.append(f"{name}: launch {rep}, the counters' slab: {bad} "
                         f"canary bytes overwritten")
        if int(slab[PAD:PAD + n].ne(0).sum()):
            fails.append(f"{name}: launch {rep}: counters not back at zero")
    return fails


def bits(x):
    """x reinterpreted as integers of its element size (NaN payloads and
    signed zeros compare as bits)."""
    import torch

    return x.view(getattr(torch, INT_OF_SIZE[x.element_size()]))


def same_values(a, b) -> bool:
    """Equal values, NaN where the other has NaN (chip_smoke.same_bits)."""
    import torch

    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


def tensors(obj):
    import torch

    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in tensors(o)]
    if isinstance(obj, dict):
        return [t for o in obj.values() for t in tensors(o)]
    return []


def guard(name, fn, args, kw, plain, reps) -> list[str]:
    """Launch fn(*args, **kw) reps times with guarded buffers (and, for
    intra_pairs and orb_select, guarded arrival counters); the failures
    found."""
    import torch

    inputs = tensors(args) + tensors(kw)
    before = [bits(t).clone() for t in inputs]
    ref = None if plain is None else tensors(plain(*args, **kw))
    fails, first, found = [], None, []
    with contextlib.ExitStack() as stack:
        stack.enter_context(guarded_counters(fn, inputs[0].device,
                                             CANARIES[0], found, args))
        for rep in range(reps):
            slabs = []
            canary = CANARIES[rep % 2]
            with guarded_empty(slabs, canary):
                out = tensors(fn(*args, **kw))
            torch.cuda.synchronize()
            fails += persistent_fails(name, rep, found)
            fails += launch_fails(name, rep, slabs, canary, out, ref, first)
            if first is None:
                first = [t.clone() for t in out]
    fails += input_fails(name, inputs, before)
    print(f"# guard {name}: {reps} launches, {len(slabs)} guarded buffers "
          f"each{' and the counters' if found else ''}, {PAD} canary bytes "
          f"a side: {'clean' if not fails else f'{len(fails)} failures'}",
          flush=True)
    return fails


def launch_fails(name, rep, slabs, canary, out, ref, first) -> list[str]:
    """Canary bytes changed around a launch's buffers; outputs unequal to
    the plain version's (first launch) or to the first launch's."""
    import torch

    fails = []
    for k, (slab, n) in enumerate(slabs):
        bad = int((slab[:PAD] != canary).sum()) \
            + int((slab[PAD + n:] != canary).sum())
        if bad:
            fails.append(f"{name}: launch {rep}, buffer {k} "
                         f"({n} B): {bad} canary bytes overwritten")
    if first is None:
        for k, (o, r) in enumerate(zip(out, ref or ())):
            if not same_values(o, r):
                fails.append(f"{name}: output {k} differs from the plain "
                             f"version")
    elif not all(torch.equal(bits(o), bits(f)) for o, f in zip(out, first)):
        fails.append(f"{name}: launch {rep} differs from launch 0")
    return fails


def input_fails(name, inputs, before) -> list[str]:
    import torch

    return [f"{name}: input {k} changed"
            for k, (t, b) in enumerate(zip(inputs, before))
            if not torch.equal(bits(t), b)]


def guard_graph(name, fn, args, kw, plain, reps) -> list[str]:
    """fn captured in a CUDA graph (its buffers allocated in canary slabs
    during the capture, the slabs' filling captured ahead of the launch;
    intra_pairs' and orb_select's counters guarded too), replayed reps
    times: the same checks as guard()."""
    import torch

    dev = args[0].device
    inputs = tensors(args) + tensors(kw)
    before = [bits(t).clone() for t in inputs]
    ref = None if plain is None else tensors(plain(*args, **kw))
    fails, first, found, slabs = [], None, [], []
    with contextlib.ExitStack() as stack:
        stack.enter_context(guarded_counters(fn, dev, CANARIES[0], found,
                                             args))
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(*args, **kw)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph), guarded_empty(slabs, CANARIES[1]):
            out = tensors(fn(*args, **kw))
        for rep in range(reps):
            for o in out:
                o.fill_(-1)
            graph.replay()
            torch.cuda.synchronize()
            fails += persistent_fails(name, rep, found)
            fails += launch_fails(name, rep, slabs, CANARIES[1], out, ref,
                                  first)
            if first is None:
                first = [t.clone() for t in out]
        del graph
    fails += input_fails(name, inputs, before)
    print(f"# guard {name}: {reps} graph replays, {len(slabs)} guarded "
          f"buffers{' and the counters' if found else ''}, {PAD} canary "
          f"bytes a side: {'clean' if not fails else f'{len(fails)} failures'}",
          flush=True)
    return fails


def orb_cases(quick: bool, dev, rng, seen):
    """The ORB kernels' cases: bench frame 0's recorded calls (seen) and
    random ones."""
    import torch

    import chip_smoke as cs
    from mcslam_tpu_torch.ops import orb, orb_cuda

    pyr, sel, desc = (orb_cuda.orb_pyramid, orb_cuda.orb_select,
                      orb_cuda.orb_describe)
    out = []
    if seen is not None:
        for n, fn, plain in (
                ("orb_pyramid", pyr, orb_cuda.orb_pyramid_reference),
                ("orb_select", sel, orb_cuda.orb_select_reference),
                ("orb_describe", desc, orb_cuda.orb_describe_reference)):
            a, kw = seen[n]
            out.append((f"{n} (bench frame 0)", fn, a, kw, plain, False))
        a, kw = seen["orb_select"]
        out.append(("orb_select (bench frame 0, graph replays)", sel, a, kw,
                    orb_cuda.orb_select_reference, True))
        a, kw = seen["orb_pyramid"]
        out.append(("orb_pyramid (bench frame 0, graph replays)", pyr, a, kw,
                    orb_cuda.orb_pyramid_reference, True))
    gen = torch.Generator(device=dev).manual_seed(3)
    for B, H, W, L in ((1, 97, 133, 8), (5, 120, 160, 4), (2, 240, 320, 10)):
        out.append((f"orb_pyramid {B}x{H}x{W} L={L} (random)", pyr,
                    (torch.rand(B, H, W, generator=gen, device=dev), L), {},
                    orb_cuda.orb_pyramid_reference, False))
    for C, L, G in ((3, 4, 1200), (2, 4, 24)):
        budgets = orb._level_budget(768, L, 1.2)
        kw = dict(C=C, budgets=budgets, n_out=min(768, L * max(budgets)),
                  scale=1.2, ncx=16)
        a = cs.plateau_candidates(rng, C, L, G, 16, dev)
        out.append((f"orb_select C={C} L={L} G={G} (plateau ties)", sel, a,
                    kw, orb_cuda.orb_select_reference, False))
        if quick and G > 24:
            out.append((f"orb_select C={C} L={L} G={G} (plateau ties, graph "
                        f"replays)", sel, a, kw,
                        orb_cuda.orb_select_reference, True))
    p = torch.rand(777, orb.PATCH, orb.PATCH, generator=gen, device=dev)
    out.append(("orb_describe T=777 bins=32 (uniform noise)", desc, (p, 32),
                {}, orb_cuda.orb_describe_reference, False))
    return out


GROUPS = ("frame", "intra_glue", "orb", "pose", "ransac", "track", "vio")


def cases(quick: bool, dev, groups=GROUPS):
    """(name, kernel, args, kwargs, plain, through a graph) at phase 2's
    shapes, of the kernel groups named."""
    import numpy as np

    rng = np.random.RandomState(0)
    out = frame_cases(quick, dev, rng, "orb" in groups) \
        if "frame" in groups or "orb" in groups else ([], None)
    out, orb_seen = out
    if "frame" not in groups:
        out = []
    for name, make in (("intra_glue", lambda: intra_glue_cases(quick, dev,
                                                                rng)),
                       ("orb", lambda: orb_cases(quick, dev, rng, orb_seen)),
                       ("pose", lambda: pose_cases(dev, rng)),
                       ("ransac", lambda: ransac_cases(quick, dev, rng)),
                       ("track", lambda: track_cases(quick, dev, rng)),
                       ("vio", lambda: vio_cases(dev))):
        if name in groups:
            out += make()
    return out


def frame_cases(quick: bool, dev, rng, orb: bool):
    """tri_refine's and intra_pairs' cases, and bench frame 0's recorded
    ORB calls (not --quick, where `orb`) -> (cases, the ORB calls)."""
    import chip_smoke as cs

    import chip_smoke as cs
    from mcslam_tpu_torch.frontend import frame, intra_cuda
    from mcslam_tpu_torch.geometry import triangulation, triangulation_cuda
    from mcslam_tpu_torch.ops import orb_cuda

    tri = triangulation_cuda.tri_refine
    tri_plain = triangulation.triangulate_and_refine_reference
    intra = intra_cuda.intra_pairs
    intra_plain = intra_cuda.intra_pairs_reference
    ik = dict(max_dist=cs.STEP["max_dist"], ratio=cs.STEP["ratio"])
    out, orb_seen = [], None
    if quick:
        a, s = cs.tri_problem(rng, 2048, cs.C, dev)
        poses = a[0][:1].expand(2048, -1, -1, -1)
        out.append(("tri_refine M=2048 R=4 (random, expanded poses)", tri,
                    (poses, *a[1:]), dict(sigma=s), tri_plain, False))
    else:
        scene = cs.Scene(dev, frames=1)
        seen = cs.capture_calls(lambda: frame.build_frame(
            scene.imgs[0], scene.rig, **scene.frame_kwargs()))
        if orb:
            orb_seen = cs.capture_calls(lambda: frame.build_frame(
                scene.imgs[0], scene.rig, **scene.frame_kwargs()), {
                    n: (orb_cuda, n) for n in cs.ORB_KERNELS})
        a, kw = seen["tri_refine"]
        cs.check(a[0].stride(0) == 0, "the frame's pose table is not expanded")
        out.append(("tri_refine M=2048 R=4 (bench frame 0, expanded poses)",
                    tri, a, kw, tri_plain, False))
        a, kw = seen["intra_pairs"]
        out.append(("intra_pairs C=4 N=768 (bench frame 0)", intra, a, kw,
                    intra_plain, False))
        out.append(("intra_pairs C=4 N=768 (bench frame 0, graph replays)",
                    intra, a, kw, intra_plain, True))
    a, s = cs.tri_problem(rng, 2048, 2, dev)
    out.append(("tri_refine M=2048 R=2 (random)", tri, a,
                dict(sigma=s, min_z=0.1, max_z=100.0), tri_plain, False))
    a, s = cs.tri_problem(rng, 37, 5, dev)
    out.append(("tri_refine M=37 R=5 (random)", tri, a, dict(sigma=s),
                tri_plain, False))
    a, s = cs.tri_problem(rng, 2048, 8, dev)
    out.append(("tri_refine M=2048 R=8 (random)", tri, a, dict(sigma=s),
                tri_plain, False))
    shapes = ((4, 768),) if quick else ()
    for c, n in shapes + ((2, 333), (3, 768), (5, 500)):
        out.append((f"intra_pairs C={c} N={n} (random)", intra,
                    cs.intra_problem(rng, c, n, dev), ik, intra_plain, False))
    if quick:
        out.append(("intra_pairs C=4 N=768 (random, graph replays)", intra,
                    out[-4][2], ik, intra_plain, True))
    return out, orb_seen


def intra_glue_cases(quick: bool, dev, rng):
    """The intra match's glue kernels: the calls of bench frame 0's build
    (not --quick) and random ones; held to their plain versions bit for
    bit."""
    import chip_smoke as cs
    from mcslam_tpu_torch.frontend import frame, intra_cuda

    def kernel(n):
        return getattr(intra_cuda, n), getattr(intra_cuda, f"{n}_reference")

    out = []
    if not quick:
        scene = cs.Scene(dev, frames=1)
        seen = cs.capture_calls(lambda: frame.build_frame(
            scene.imgs[0], scene.rig, **scene.frame_kwargs()),
            {n: (intra_cuda, n) for n in cs.INTRA_GLUE})
        for n in cs.INTRA_GLUE:
            a, kw = seen[n]
            out.append((f"{n} (bench frame 0)", *kernel(n), a, kw, False))
            out.append((f"{n} (bench frame 0, graph replays)", *kernel(n), a,
                        kw, True))
    shapes = ((4, 768, 2048),) if quick else ()
    for C, N, M in shapes + ((2, 333, 500), (3, 129, 2048), (5, 1000, 2048)):
        calls = cs.intra_glue_problem(rng, C, N, M, dev)
        for n in cs.INTRA_GLUE:
            out.append((f"{n} C={C} N={N} M={M} (random)", *kernel(n),
                        calls[n], {}, False))
            if quick and N == 768:
                out.append((f"{n} C={C} N={N} M={M} (random, graph replays)",
                            *kernel(n), calls[n], {}, True))
    for name, n, a in intra_glue_edges(cs.intra_glue_problem(rng, 3, 200, 700,
                                                             dev)):
        out.append((f"{n} C=3 N=200 ({name})", *kernel(n), a, {}, False))
    # the lane-per-ray tri_gather at group counts no multiple of a block's
    # or a warp's groups, C not dividing 32 and above 32
    for C, N, M in ((1, 50, 31), (3, 129, 33), (4, 97, 2049), (5, 60, 100),
                    (33, 20, 40)):
        a = cs.tri_gather_problem(rng, C, N, M, dev)
        for graphed in (False, True):
            out.append((f"tri_gather C={C} N={N} M={M} (random"
                        f"{', graph replays' if graphed else ''})",
                        *kernel("tri_gather"), a, {}, graphed))
    return [(name, fn, a, kw, plain, graphed)
            for name, fn, plain, a, kw, graphed in out]


def intra_glue_edges(calls):
    """(name, kernel, args) of the gate's and the groups' edge cases from
    a chip_smoke.intra_glue_problem: NaN pixels with the threshold on the
    quotient of a cell (the cells the gate divides); every feature a root;
    most features of cameras 1 and 2 on one root each."""
    import torch

    from mcslam_tpu_torch.frontend import intra_cuda

    xy, f, E, _ = calls["intra_gate"]
    xy = xy.clone()
    xy[0, :3, 0] = float("nan")
    xy[1, 5:8, 1] = float("nan")
    C = xy.shape[0]
    xn = intra_cuda.normalized(xy, f)
    pi, pj = intra_cuda.camera_pairs(C)
    num, den = intra_cuda.sampson_terms(xn[pi], xn[pj], E)
    q = (num / den).flatten()
    q = torch.sort(q[torch.isfinite(q) & (q > 0)]).values
    thr2 = q[q.numel() // 10].reshape(()).clone()
    parent, valid, response, desc, M = calls["intra_groups"]
    roots = torch.arange(parent.numel(), dtype=torch.int32,
                         device=parent.device).reshape(parent.shape)
    shared = parent.clone()
    shared[1, ::2] = 3
    shared[2, ::3] = xy.shape[1] + 7
    return [("NaN pixels, threshold on a cell", "intra_gate",
             (xy, f, E, thr2)),
            ("every feature a root", "intra_groups",
             (roots, torch.ones_like(valid), response, desc, M)),
            ("one root for most of two cameras", "intra_groups",
             (shared, valid, response, desc, M))]


def track_epilogue(*args, **kw):
    """track_epilogue into a packed vector of its own (a guarded buffer):
    its outputs and the packed slots it writes."""
    import chip_smoke as cs
    from mcslam_tpu_torch.frontend import track_cuda

    return cs.track_outputs("track_epilogue", track_cuda.track_epilogue,
                            args, kw)


def track_epilogue_reference(*args, **kw):
    import chip_smoke as cs
    from mcslam_tpu_torch.frontend import track_cuda

    return cs.track_outputs("track_epilogue",
                            track_cuda.track_epilogue_reference, args, kw)


def track_cases(quick: bool, dev, rng):
    """The tracking glue's kernels: the calls of bench frame 1's fast-path
    step (not --quick) and random ones; held to their plain versions bit
    for bit."""
    import torch

    import chip_smoke as cs
    from mcslam_tpu_torch import tracking_kernels as tk
    from mcslam_tpu_torch.frontend import frame, track_cuda

    def kernel(n):
        if n == "track_epilogue":
            return track_epilogue, track_epilogue_reference
        return (getattr(track_cuda, n),
                getattr(track_cuda, f"{n}_reference"))

    out = []
    if not quick:
        scene = cs.Scene(dev, frames=2)
        ff0 = frame.build_frame(scene.imgs[0], scene.rig,
                                **scene.frame_kwargs())
        mapstate, _ = cs.seed_map(ff0, dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        seen = cs.capture_calls(lambda: tk._build_and_track_step(
            gen, scene.imgs[1], scene.rig, ff0.im_desc, ff0.im_valid,
            *mapstate, torch.eye(4, device=dev),
            **scene.step_kwargs(cs.FASTPATH_FRAC)),
            {n: (track_cuda, n) for n in cs.TRACK_KERNELS})
        for n in cs.TRACK_KERNELS:
            a, kw = seen[n]
            out.append((f"{n} (bench frame 1)", *kernel(n), a, kw, False))
        for n in cs.TRACK_REDESIGNED:
            a, kw = seen[n]
            out.append((f"{n} (bench frame 1, graph replays)", *kernel(n),
                        a, kw, True))
    for C, M, N, L in ((4, 2048, 2048, 4096), (3, 2049, 2047, 4097),
                       (1, 37, 33, 45)):
        calls = cs.track_calls(cs.track_problem(rng, C, M, N, L, 4096, dev))
        for n in cs.TRACK_KERNELS:
            a, kw = calls[n]
            out.append((f"{n} C={C} M={M} N={N} L={L} (random)", *kernel(n),
                        a, kw, False))
            if quick and M == 2048:
                out.append((f"{n} C={C} M={M} N={N} L={L} (random, graph "
                            f"replays)", *kernel(n), a, kw, True))
    # the redesigned four (32-row and 32-column blocks) at shapes no
    # multiple of their blocks, at the counts' extremes (M and M, M and 0),
    # with no previous landmark and with the map behind the cameras,
    # eagerly and through graph replays
    for C, M, N, L, case in ((2, 33, 40, 65, "random"),
                             (4, 161, 200, 191, "all_ok"),
                             (3, 2048, 2048, 4096, "none_with"),
                             (4, 2048, 2048, 4096, "no_lm"),
                             (3, 97, 130, 50, "behind")):
        calls = cs.track_calls(cs.track_problem(rng, C, M, N, L, 4096, dev,
                                                case))
        for n in cs.TRACK_REDESIGNED:
            a, kw = calls[n]
            for graphed in (False, True):
                out.append((f"{n} C={C} M={M} N={N} L={L} ({case}"
                            f"{', graph replays' if graphed else ''})",
                            *kernel(n), a, kw, graphed))
    return [(name, fn, a, kw, plain, graphed)
            for name, fn, plain, a, kw, graphed in out]


def ransac_problem(rng, M, dev):
    """A random tracking problem for the RANSAC kernels: landmarks 4-16 m
    ahead, four cameras with lever arms, pixels with noise -> (X, uv,
    cam_T_ref, fxycxy, mask) on dev."""
    import numpy as np
    import torch

    X = (rng.uniform(-6, 6, (M, 3)) + [0, 0, 10]).astype(np.float32)
    cam = np.tile(np.eye(4, dtype=np.float32), (M, 1, 1))
    cam[:, 0, 3] = 0.1 * rng.randint(0, 4, M)
    f = np.tile(np.float32([400, 400, 320, 240]), (M, 1))
    p = X + cam[:, :3, 3]
    uv = (p[:, :2] / p[:, 2:] * 400 + [320, 240]
          + rng.normal(0, 0.5, (M, 2))).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in
                 (X, uv, cam, f, rng.rand(M) > 0.05))


def ransac_cases(quick: bool, dev, rng):
    """The RANSAC kernels: the calls of bench frame 1's step with its
    portfolio forced (not --quick) and random ones. Held to their first
    launch (they round otherwise than their plain versions)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from mcslam_tpu_torch.frontend import ransac_cuda

    score, kab, pnp = (ransac_cuda.score, ransac_cuda.kabsch_hyp,
                       ransac_cuda.pnp_hyp)
    out = []
    if not quick:
        seen = cs.portfolio_calls(cs.Scene(dev, frames=2), dev)
        for a, kw in seen["score"]:
            out.append((f"ransac_score K={a[0].shape[0]} (bench frame 1)",
                        score, a, kw, None, False))
        a, kw = seen["score"][1]
        out.append(("ransac_score K=512 (bench frame 1, graph replays)", score,
                    a, kw, None, True))
        for n, fn in (("kabsch_hyp", kab), ("pnp_hyp", pnp)):
            a, kw = seen[n][0]
            out.append((f"{n} K={a[0].shape[0]} (bench frame 1)", fn, a, kw,
                        None, False))
    for M in (37, 2048, 2049):
        obs = ransac_problem(rng, M, dev)
        for K in {37: (257,), 2048: (1, 512), 2049: (3, 33, 513)}[M]:
            w = rng.normal(0, 0.02, (K, 3))
            hyp = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
            hyp[:, :3, 3] = w
            hyp = torch.from_numpy(hyp).to(dev)
            out.append((f"ransac_score K={K} M={M} (random)", score,
                        (hyp, *obs, 5.0), {}, None, quick and K == 512))
        idx = torch.from_numpy(rng.randint(0, M, (257, 6))).to(dev)
        out.append((f"kabsch_hyp K=257 M={M} (random)", kab,
                    (idx[:, :3].contiguous(), obs[0], obs[0]), {}, None,
                    False))
        out.append((f"pnp_hyp K=257 M={M} (random)", pnp,
                    (idx, *obs[:4]), {}, None, False))
    return out


def vio_factors_call(poses, vels, biases, E_T_V, Hpp, gp, cost, problem):
    """vio_factors on a VioFactors prepared in the call (so that its
    scratch is a guarded allocation) -> (H, g, cost, the factors'
    records)."""
    from mcslam_tpu_torch.backend import vio_cuda

    prep = vio_cuda.VioFactors(problem)
    out = prep(poses, vels, biases, E_T_V, Hpp, gp, cost)
    return (*out, vio_cuda.record_views(prep.scratch, prep.counts))


def vio_cases(dev):
    """vio_factors at phase 2's problems (chip_smoke.VIO_FACTOR_CASES:
    the stage D windows, K = 12, 60 IMU slots with the factors' blocks
    read from the scratch), with only GPS factors, and with no factor
    table (the vision block and the prior placed alone); each eagerly
    and through graph replays. No plain
    version to hold it to bit for bit (chip_smoke.py phase 2 holds it to
    its criteria): the launches must equal the first."""
    import chip_smoke as cs
    from mcslam_tpu_torch.backend import ba, ba_vio

    probs = [(case, cs.vio_factors_problem(dev, case))
             for case in cs.VIO_FACTOR_CASES]
    stage_d = dict(probs)
    probs += [("gps only", stage_d["imu+gps"]._replace(imu=None)),
              ("no tables", stage_d["imu"]._replace(imu=None))]
    out = []
    for case, p in probs:
        sys_ = ba._blocked_system(ba_vio._vision_problem(p), 2.5)
        (Hpp, gp, *_), cost, _ = sys_((p.poses, p.landmarks), p.obs.valid)
        a = (p.poses, p.vels, p.biases, p.E_T_V, Hpp, gp, cost)
        for graphed in (False, True):
            out.append((f"vio_factors {case}"
                        f"{' (graph replays)' if graphed else ''}",
                        vio_factors_call, a, dict(problem=p), None, graphed))
    return out


def pose_cases(dev, rng):
    """pose_lm at phase 2's B = 1 and 2 candidates of M = 2048
    observations and at B = 3, M = 333 (a short last slice). No plain
    version to hold it to bit for bit (the kernel sums in its cluster's
    order; chip_smoke.py phase 2 holds it to 2e-3): the launches must
    equal the first."""
    import chip_smoke as cs
    from mcslam_tpu_torch.frontend import pose_opt_cuda

    out = []
    for B, M in ((1, cs.MAXI), (2, cs.MAXI), (3, 333)):
        a = (*cs._pose_problem(rng, B, M, dev), (8, 8))
        out.append((f"pose_lm B={B} M={M} (random)", pose_opt_cuda.pose_lm,
                    a, {}, None, False))
    return out


def sanitize() -> int:
    """This script --quick --reps 2 under compute-sanitizer's tools."""
    exe = shutil.which("compute-sanitizer") \
        or "/usr/local/cuda/bin/compute-sanitizer"
    if not os.path.exists(exe):
        print("# compute-sanitizer: not found", flush=True)
        return 0
    worst = 0
    for tool in ("memcheck", "racecheck", "synccheck"):
        cmd = [exe, "--tool", tool, "--error-exitcode", "9",
               sys.executable, str(pathlib.Path(__file__).resolve()),
               "--quick", "--reps", "2"]
        t0 = time.perf_counter()
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=600)
            rc, text = r.returncode, r.stdout + r.stderr
        except subprocess.TimeoutExpired as e:
            rc = "timeout after 600 s"
            text = (e.stdout or b"").decode() + (e.stderr or b"").decode()
        lines = [ln for ln in text.splitlines() if ln.strip()]
        # the tool's own lines (each error with its kernel or API call and
        # its host stack) and the guard's
        report = [ln for ln in lines if ln.startswith(("=========", "# "))]
        refused = next((ln for ln in report if "Device not supported" in ln),
                       None)
        if refused is not None:  # the tool found no device it can attach to
            print(f"# compute-sanitizer --tool {tool}: did not run "
                  f"({refused.strip('= ')})", flush=True)
            continue
        print(f"# compute-sanitizer --tool {tool}: rc {rc}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for ln in (report or lines[-12:])[:MAX_REPORT]:
            print(f"#   {ln}", flush=True)
        if rc == 9:
            worst = 1
    return worst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--sanitize", action="store_true")
    ap.add_argument("--groups", nargs="+", choices=GROUPS, default=GROUPS,
                    help="the kernel groups to guard (default: all)")
    opt = ap.parse_args()

    import torch

    from mcslam_tpu_torch import _build

    if not torch.cuda.is_available():
        print("kernel_guard: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    _build.library()
    fails = []
    for name, fn, args, kw, plain, graphed in cases(opt.quick, dev,
                                                    opt.groups):
        if graphed:
            fails += guard_graph(name, fn, args, kw, plain, opt.reps)
        else:
            fails += guard(name, fn, args, kw, plain, opt.reps)
    for f in fails:
        print(f"# FAIL {f}", flush=True)
    rc = 1 if fails else 0
    if opt.sanitize:
        rc = max(rc, sanitize())
    print(f"# kernel_guard: {'clean' if rc == 0 else 'FAILED'}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
