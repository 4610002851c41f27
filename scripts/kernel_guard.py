"""Memory and determinism guard of the frame build's two kernels,
tri_refine (csrc/tri_refine.cu) and intra_pairs (csrc/intra_match.cu),
on one CUDA card.

Runs each kernel at chip_smoke.py phase 2's shapes: tri_refine at bench
frame 0's M = 2048 groups of R = 4 rays (the pose table expanded, as the
frame build passes it), at M = 2048, R = 2 and at M = 37, R = 5;
intra_pairs at bench frame 0's C = 4 x N = 768 descriptors and Sampson
gate and at random C = 2, 3 and 5. Every buffer a wrapper allocates (its
outputs and its scratch) is placed inside a slab of canary bytes, PAD
bytes on each side, the canary alternating from launch to launch. After
every launch it checks that no canary byte changed (a write out of
bounds), that no input changed (a write into an input), and that the
outputs equal the first launch's and the plain version's bit for bit (a
race or an unwritten output shows as a difference). Run from the
repository's root on a machine with a card and nvcc:

    python3 scripts/kernel_guard.py [--reps 50] [--quick] [--sanitize]

--quick leaves out the bench scene (random problems only, R = 4 with an
expanded pose table too). --sanitize then runs this script with --quick
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
    """Launch fn(*args, **kw) reps times with guarded buffers; the
    failures found."""
    import torch

    inputs = tensors(args) + tensors(kw)
    before = [bits(t).clone() for t in inputs]
    ref = tensors(plain(*args, **kw))
    fails, first = [], None
    for rep in range(reps):
        slabs = []
        canary = CANARIES[rep % 2]
        with guarded_empty(slabs, canary):
            out = tensors(fn(*args, **kw))
        torch.cuda.synchronize()
        for k, (slab, n) in enumerate(slabs):
            bad = int((slab[:PAD] != canary).sum()) \
                + int((slab[PAD + n:] != canary).sum())
            if bad:
                fails.append(f"{name}: launch {rep}, buffer {k} "
                             f"({n} B): {bad} canary bytes overwritten")
        out = [t.clone() for t in out]
        if first is None:
            first = out
            for k, (o, r) in enumerate(zip(out, ref)):
                if not same_values(o, r):
                    fails.append(f"{name}: output {k} differs from the plain "
                                 f"version")
        elif not all(torch.equal(bits(o), bits(f))
                     for o, f in zip(out, first)):
            fails.append(f"{name}: launch {rep} differs from launch 0")
    for k, (t, b) in enumerate(zip(inputs, before)):
        if not torch.equal(bits(t), b):
            fails.append(f"{name}: input {k} changed")
    print(f"# guard {name}: {reps} launches, {len(slabs)} guarded buffers "
          f"each, {PAD} canary bytes a side: "
          f"{'clean' if not fails else f'{len(fails)} failures'}",
          flush=True)
    return fails


def cases(quick: bool, dev):
    """(name, kernel, args, kwargs, plain) at phase 2's shapes."""
    import numpy as np

    import chip_smoke as cs
    from mcslam_tpu_torch.frontend import frame, intra_cuda
    from mcslam_tpu_torch.geometry import triangulation, triangulation_cuda

    tri = triangulation_cuda.tri_refine
    tri_plain = triangulation.triangulate_and_refine_reference
    intra = intra_cuda.intra_pairs
    intra_plain = intra_cuda.intra_pairs_reference
    ik = dict(max_dist=cs.STEP["max_dist"], ratio=cs.STEP["ratio"])
    rng = np.random.RandomState(0)
    out = []
    if quick:
        a, s = cs.tri_problem(rng, 2048, cs.C, dev)
        poses = a[0][:1].expand(2048, -1, -1, -1)
        out.append(("tri_refine M=2048 R=4 (random, expanded poses)", tri,
                    (poses, *a[1:]), dict(sigma=s), tri_plain))
    else:
        scene = cs.Scene(dev, frames=1)
        seen = cs.capture_calls(lambda: frame.build_frame(
            scene.imgs[0], scene.rig, **scene.frame_kwargs()))
        a, kw = seen["tri_refine"]
        cs.check(a[0].stride(0) == 0, "the frame's pose table is not expanded")
        out.append(("tri_refine M=2048 R=4 (bench frame 0, expanded poses)",
                    tri, a, kw, tri_plain))
        a, kw = seen["intra_pairs"]
        out.append(("intra_pairs C=4 N=768 (bench frame 0)", intra, a, kw,
                    intra_plain))
    a, s = cs.tri_problem(rng, 2048, 2, dev)
    out.append(("tri_refine M=2048 R=2 (random)", tri, a,
                dict(sigma=s, min_z=0.1, max_z=100.0), tri_plain))
    a, s = cs.tri_problem(rng, 37, 5, dev)
    out.append(("tri_refine M=37 R=5 (random)", tri, a, dict(sigma=s),
                tri_plain))
    shapes = ((4, 768),) if quick else ()
    for c, n in shapes + ((2, 333), (3, 768), (5, 500)):
        out.append((f"intra_pairs C={c} N={n} (random)", intra,
                    cs.intra_problem(rng, c, n, dev), ik, intra_plain))
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
    opt = ap.parse_args()

    import torch

    from mcslam_tpu_torch import _build

    if not torch.cuda.is_available():
        print("kernel_guard: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    _build.library()
    fails = []
    for name, fn, args, kw, plain in cases(opt.quick, dev):
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
