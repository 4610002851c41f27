#!/usr/bin/env python3
"""Split the time of the ORB extraction's orb_select and orb_pyramid
kernels (csrc/orb_select.cu, csrc/orb_pyramid.cu) on one CUDA card by
%globaltimer stamps and by variants of their sources.

    python3 scripts/orb_variants.py [--rounds 3] [--only VARIANT ...]

Run from the repository's root. Builds each source as it stands and with
the edits of each variant below (one nvcc per variant, all started
together, into mcslam_tpu_torch/_build/variants/), prints each build's
registers, shared memory and spills, checks that each source as it
stands equals its plain version bit for bit at bench frame 0's recorded
inputs (4 cameras, VGA, 4 levels, 768 points), then prints:
- per launch of each kernel, its device time and the gap before the
  next launch of the same call, from a torch.profiler trace of 20 calls;
- the stamps variant's phases (thread 0 of each block, right after a
  barrier: the earliest block start and the latest end of each phase,
  mean over 20 calls);
- each variant's device time per call (the variants of a kernel taking
  turns within each round, reversed every other round; median over the
  rounds).
The edits are keyed by the design the source holds (its marker line),
so the probe splits the design before a redesign and the one after it.
Their outputs are not the function's, except full's. The anchors are
exact source lines; an edit whose anchor is not found as often as
listed fails the run. Needs one CUDA card.

Variants of orb_select.cu, the design of two launches (marker
"orb_compact_kernel"):
  full    the source as it stands;
  stamps  select launch: start, the 8 radix passes, the gather, the
          bitonic sort, the slot fields; compaction launch: start, its
          radix passes, gather, sort and outputs.
Variants of orb_select.cu, the design of one launch (marker
"orb_select_one_kernel"):
  full    the source as it stands;
  stamps  start, each value radix pass (histogram, digit), the tie
          scan and gather, the rank placement, the slot fields and
          level sort, the arrival; the last block's compaction (stage,
          ranks, outputs);
  nocompact  every block returns after its arrival (no compaction).
Variants of orb_pyramid.cu, the design of L - 1 launches (marker
"pyramid_level_kernel"):
  full      the source as it stands;
  noedge    an edge-replicated pixel writes 0 instead of recomputing
            its edge pixel (the edge share);
  notables  the weights 0.3 and the first tap at the output's own row
            and column: no loads of the tap tables (their share).
Variants of orb_pyramid.cu, the design of staged tiles (marker
"pyramid_tile_kernel"):
  full      the source as it stands;
  stamps    start, the staged loads, each level's passes and stores;
  nostore   no stores of levels >= 1 (the stores' share; the level
            values kept live).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CSRC = ROOT / "mcslam_tpu_torch" / "csrc"
OUT = ROOT / "mcslam_tpu_torch" / "_build" / "variants"
NSTAMPS = 16

STAMP_DEFS = """
__device__ unsigned long long g_stamps[16];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void stamp(int k) {
  if (k == 0 || k == 8) atomicMin(&g_stamps[k], gtime());
  else atomicMax(&g_stamps[k], gtime());
}
"""
STAMP_GETTER = """
extern "C" int mc_orb_stamps(unsigned long long* host, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));
  if (e != cudaSuccess || !reset) return static_cast<int>(e);
  unsigned long long init[16] = {~0ull, 0, 0, 0, 0, 0, 0, 0,
                                 ~0ull, 0, 0, 0, 0, 0, 0, 0};
  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, init, sizeof(init)));
}
"""


def t0(k):
    """A stamp by thread 0 of the block."""
    return f"  if (threadIdx.x == 0) stamp({k});\n"


# -- orb_select, the design of two launches ---------------------------------
S17_TOP = "template <typename KeyFn>\n__device__ void select_top(const KeyFn& key, int N, int n, Smem& s) {\n  const int tid = threadIdx.x;\n"
S17_NTH = "  const u64 nth = s.prefix;\n"
S17_PAD = "  for (int i = n + tid; i < P; i += THREADS) s.keys[i] = 0;\n  __syncthreads();\n"
S17_SORTED = "      __syncthreads();\n    }\n  }\n}\n\n// Per image"
S17_CALL = "    }, M, n_out, s);\n"
S17_SEL_END = "        make_int4(y, x, __float_as_int(resp), ok ? 1 : 0);\n  }\n}\n"
S17_CMP_END = "    flat_img[o] = l * C + c;\n  }\n}\n"
ENTRY_SELECT = 'extern "C" int mc_orb_select('
NS_TOP = "namespace {\n"
SELECT17 = {
    "full": [],
    "stamps": [
        (NS_TOP, NS_TOP + STAMP_DEFS, 1),
        (S17_TOP, S17_TOP.replace("Smem& s)", "Smem& s, int st = 0)")
         + "  if (tid == 0) stamp(st);\n", 1),
        (S17_NTH, "  if (tid == 0) stamp(st + 1);\n" + S17_NTH, 1),
        (S17_PAD, S17_PAD + "  if (tid == 0) stamp(st + 2);\n", 1),
        (S17_SORTED, S17_SORTED.replace(
            "    }\n  }\n}\n", "    }\n  }\n  if (tid == 0) stamp(st + 3);\n}\n"),
         1),
        (S17_CALL, "    }, M, n_out, s, 8);\n", 1),
        (S17_SEL_END, S17_SEL_END.replace(
            "  }\n}\n", "  }\n  __syncthreads();\n" + t0(4) + "}\n"), 1),
        (S17_CMP_END, S17_CMP_END.replace(
            "  }\n}\n", "  }\n  __syncthreads();\n" + t0(12) + "}\n"), 1),
        (ENTRY_SELECT, STAMP_GETTER + ENTRY_SELECT, 1)],
}
SELECT17_PHASES = (("select start -> radix done", 0, 1),
                   ("radix done -> gather done", 1, 2),
                   ("gather done -> sort done", 2, 3),
                   ("sort done -> slot fields done", 3, 4),
                   ("select end -> compaction start (launch gap)", 4, 8),
                   ("compaction start -> radix done", 8, 9),
                   ("radix done -> gather done", 9, 10),
                   ("gather done -> sort done", 10, 11),
                   ("sort done -> outputs done", 11, 12),
                   ("select start -> compaction end", 0, 12))

# -- orb_pyramid, the design of L - 1 launches ------------------------------
P17_CLAMP = "  const int yc = min(y, lv.h - 1), xc = min(x, lv.w - 1);\n"
PYRAMID17 = {
    "full": [],
    "noedge": [(P17_CLAMP, P17_CLAMP
                + "  if (y >= lv.h || x >= lv.w) return 0.0f;\n", 1)],
    "notables": [("__ldg(lv.fv + yc)", "yc", 1), ("__ldg(lv.fh + xc)", "xc", 1),
                 ("__ldg(w)", "0.3f", 2), ("__ldg(w + k)", "0.3f", 1),
                 ("__ldg(w + j)", "0.3f", 1)],
}

# -- orb_select, the design of one launch -----------------------------------
S18_START = "  const int i0 = tid * kpt, i1 = min(N, i0 + kpt);\n"
S18_HIST = "    __syncthreads();\n    unsigned* other = rs.hist[(p + 1) & 1];\n"
S18_FIND = "    __syncthreads();\n    // every thread: the warp W"
S18_COUNTS = "  __syncthreads();  // also: every thread's radix reads are done\n"
S18_GATHER = "  __syncthreads();\n\n  // 3. each chosen key's slot"
S18_FIELDS = "  if (!compact) return;\n  __syncthreads();\n"
S18_ARRIVE = "  // 5. arrival; the camera's last block ranks all its slots\n  __syncthreads();\n"
S18_LAST = "  if (!s_last) return;\n"
S18_STAGED = "    runs = st;\n  }\n"
S18_END = "  if (tid == 0) counters[c] = 0;\n}\n"
SELECT18 = {
    "full": [],
    "stamps": [
        (NS_TOP, NS_TOP + STAMP_DEFS, 1),
        (S18_START, S18_START + t0(0), 1),
        (S18_HIST, S18_HIST.replace("();\n", "();\n    if (threadIdx.x == 0) "
                                    "stamp(5 + p);\n", 1), 1),
        (S18_FIND, S18_FIND.replace("();\n", "();\n    if (threadIdx.x == 0) "
                                    "stamp(11 + p);\n", 1), 1),
        (S18_COUNTS, S18_COUNTS + t0(1), 1),
        (S18_GATHER, S18_GATHER.replace("();\n", "();\n" + t0(2), 1), 1),
        (S18_FIELDS, S18_FIELDS + t0(3), 1),
        (S18_ARRIVE, S18_ARRIVE + t0(4), 1),
        (S18_LAST, S18_LAST + t0(8), 1),
        (S18_STAGED, S18_STAGED + t0(9), 1),
        (S18_END, "  __syncthreads();\n" + t0(10) + S18_END, 1),
        (ENTRY_SELECT, STAMP_GETTER + ENTRY_SELECT, 1)],
    "nocompact": [(S18_LAST, "  if (s_last && tid == 0) counters[c] = 0;\n"
                   "  return;\n", 1)],
}
SELECT18_PHASES = (("start -> pass 1's histogram", 0, 5),
                   ("-> pass 1's digit", 5, 11),
                   ("-> pass 2's histogram", 11, 6),
                   ("-> pass 2's digit", 6, 12),
                   ("-> pass 3's histogram (negative: no third pass)", 12, 7),
                   ("-> pass 3's digit", 7, 13),
                   ("start -> radix passes and tie counts done", 0, 1),
                   ("-> chosen keys placed", 1, 2),
                   ("-> ranks and slot fields done", 2, 3),
                   ("-> level prio order written (arrival)", 3, 4),
                   ("last arrival -> first tail start", 4, 8),
                   ("tail start -> sorted keys staged", 8, 9),
                   ("staged -> tail ranks and outputs done", 9, 10),
                   ("start -> end", 0, 10))

# -- orb_pyramid, the design of staged tiles --------------------------------
P18_STAGED = "  __syncthreads();\n  if (seg.la == 1) {"
P18_LEVEL = "    __syncthreads();\n    // this level's part"
P18_END = "    }\n  }\n}\n\n}  // namespace"
P18_STORE = "        o[x] = row[ec.loc(min(x, lv.w - 1))];\n"
PYRAMID18 = {
    "full": [],
    "stamps": [
        (NS_TOP, NS_TOP + STAMP_DEFS, 1),
        ("  const long long plane = (long long)H * W;\n",
         "  const long long plane = (long long)H * W;\n" + t0(0), 1),
        (P18_STAGED, P18_STAGED.replace("();\n", "();\n" + t0(1)), 1),
        (P18_LEVEL, P18_LEVEL.replace(
            "();\n", "();\n    if (threadIdx.x == 0 && k < 7) stamp(1 + k);\n"),
         1),
        (P18_END, "    }\n  }\n  __syncthreads();\n" + t0(12)
         + "}\n\n}  // namespace", 1),
        ('extern "C" int mc_orb_pyramid(', STAMP_GETTER
         + 'extern "C" int mc_orb_pyramid(', 1)],
    "nostore": [(P18_STORE, "        const float t = row[ec.loc(min(x, lv.w - "
                 "1))];\n        if (t == 1234.5f) o[x] = t;\n", 1)],
}
PYRAMID18_PHASES = (("start -> source region staged", 0, 1),
                    ("-> level 1 computed", 1, 2),
                    ("-> level 2 computed", 2, 3),
                    ("-> level 3 computed", 3, 4),
                    ("-> last stores issued (block end)", 4, 12),
                    ("start -> end", 0, 12))

DESIGNS = {
    "orb_select": [("orb_compact_kernel", SELECT17, SELECT17_PHASES),
                   ("orb_select_one_kernel", SELECT18, SELECT18_PHASES)],
    "orb_pyramid": [("pyramid_level_kernel", PYRAMID17, None),
                    ("pyramid_tile_kernel", PYRAMID18, PYRAMID18_PHASES)],
}


def design(kernel: str):
    """(marker, edits, stamp phases) of the design csrc/<kernel>.cu holds."""
    src = (CSRC / f"{kernel}.cu").read_text()
    for marker, edits, phases in DESIGNS[kernel]:
        if marker in src:
            return marker, edits, phases
    raise RuntimeError(f"orb_variants: no known design in {kernel}.cu")


def variant_source(kernel: str, name: str) -> str:
    s = (CSRC / f"{kernel}.cu").read_text()
    edits = design(kernel)[1]
    for part in name.split("+"):
        for anchor, new, count in edits[part]:
            if s.count(anchor) != count:
                raise RuntimeError(
                    f"orb_variants: the anchor of {part} occurs "
                    f"{s.count(anchor)} times (not {count}) in {kernel}.cu: "
                    f"{anchor!r}")
            s = s.replace(anchor, new)
    return s


def build_all(jobs) -> dict:
    """{(kernel, variant): ctypes library}, one nvcc per variant, started
    together; the ptxas report of each printed."""
    from mcslam_tpu_torch import _build

    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for kernel, name in jobs:
        stem = f"{kernel}_{name.replace('+', '_')}"
        cu = OUT / f"{stem}.cu"
        cu.write_text(variant_source(kernel, name))
        cmd = [nvcc, *_build.ARCH_FLAGS, *_build.NVCC_FLAGS,
               *_build.SOURCE_FLAGS.get(kernel, []), "-Xptxas", "-v", "-I",
               str(CSRC), "-shared", "-o", str(OUT / f"{stem}.so"), str(cu)]
        procs[(kernel, name)] = (stem, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (kernel, name), (stem, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {kernel} {name}:\n{log}")
        for entry in re.findall(r"Compiling entry function '([^']+)'.*?"
                                r"(\d+ bytes stack frame, \d+ bytes spill "
                                r"stores).*?Used (\d+) registers[^\n]*", log,
                                re.S):
            print(f"# build {kernel} {name}: {entry[0][:60]}: {entry[2]} "
                  f"registers, {entry[1]}", flush=True)
        lib = ctypes.CDLL(str(OUT / f"{stem}.so"))
        fn = f"mc_{kernel}"
        getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
        libs[(kernel, name)] = lib
    return libs


class Using:
    """The wrappers' library replaced by one variant for a call (the
    wrappers reach their kernels through _build.library())."""

    def __init__(self, lib):
        self.lib = lib

    def __enter__(self):
        from mcslam_tpu_torch import _build

        self.saved = _build._LIB
        _build._LIB = self.lib

    def __exit__(self, *exc):
        from mcslam_tpu_torch import _build

        _build._LIB = self.saved


def caller(kernel, lib, a, kw):
    from mcslam_tpu_torch.ops import orb_cuda

    fn = getattr(orb_cuda, kernel)

    def call():
        with Using(lib):
            return fn(*a, **kw)
    return call


def launch_split(call, reps=20):
    """Per launch k of a call: (mean device us, mean gap us to launch k +
    1), from one profiler trace of reps calls."""
    import numpy as np

    import chip_smoke as cs

    for _ in range(5):
        _, evs, kept = cs.device_events(lambda: [call() for _ in range(reps)])
        kern = sorted((e for e in evs if "orb" in e.name or "pyramid" in
                       e.name), key=lambda e: e.time_range.start)
        if kept and kern and len(kern) % reps == 0:
            break
    cs.check(kern and len(kern) % reps == 0, "orb_variants: the trace lost "
             "launches in five tries")
    per = len(kern) // reps
    dur = np.array([e.time_range.elapsed_us() for e in kern],
                   np.float64).reshape(reps, per)
    start = np.array([e.time_range.start for e in kern],
                     np.float64).reshape(reps, per)
    end = np.array([e.time_range.end for e in kern],
                   np.float64).reshape(reps, per)
    gaps = start[:, 1:] - end[:, :-1]
    names = [kern[k].name for k in range(per)]
    return names, dur.mean(0), gaps.mean(0) if per > 1 else np.zeros(0)


def stamp_split(kernel, lib, call, phases, smi, reps=20) -> None:
    import numpy as np
    import torch

    lib.mc_orb_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mc_orb_stamps.restype = ctypes.c_int
    host = (ctypes.c_ulonglong * NSTAMPS)()
    rows = []
    for _ in range(reps + 2):
        torch.cuda.synchronize()
        assert lib.mc_orb_stamps(host, 1) == 0
        call()
        torch.cuda.synchronize()
        assert lib.mc_orb_stamps(host, 0) == 0
        t = [int(x) for x in host]
        rows.append([t[b] - t[a] for _, a, b in phases])
    m = np.mean(np.array(rows[2:], dtype=np.float64), axis=0) / 1e3
    print(f"# {kernel} stamps (us, mean of {reps} calls, %globaltimer; "
          f"{smi}):", flush=True)
    for (label, _, _), v in zip(phases, m):
        print(f"#   {label}: {v:.2f}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--only", nargs="*", default=None,
                    help="kernel:variant pairs (default: all)")
    opt = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from mcslam_tpu_torch.frontend import frame
    from mcslam_tpu_torch.ops import orb_cuda

    if not torch.cuda.is_available():
        print("orb_variants: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    jobs = []
    for kernel in ("orb_select", "orb_pyramid"):
        marker, edits, _ = design(kernel)
        print(f"# {kernel}: design of {marker}", flush=True)
        jobs += [(kernel, v) for v in edits
                 if opt.only is None or f"{kernel}:{v}" in opt.only]
    libs = build_all(jobs)
    scene = cs.Scene(dev, frames=1)
    seen = cs.capture_calls(lambda: frame.build_frame(
        scene.imgs[0], scene.rig, **scene.frame_kwargs()), {
            "orb_pyramid": (orb_cuda, "orb_pyramid"),
            "orb_select": (orb_cuda, "orb_select")})
    calls = {(k, v): caller(k, libs[(k, v)], *seen[k])
             for k, v in jobs}
    for kernel in ("orb_select", "orb_pyramid"):
        if (kernel, "full") not in calls:
            continue
        a, kw = seen[kernel]
        got = calls[(kernel, "full")]()
        ref = getattr(orb_cuda, f"{kernel}_reference")(*a, **kw)
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        torch.cuda.synchronize()
        cs.check(all(torch.equal(x, y) for x, y in zip(got, ref)),
                 f"orb_variants: {kernel} full differs from the plain version")
        names, dur, gaps = launch_split(calls[(kernel, "full")])
        print(f"# {kernel} full: bitwise equal to the plain version; per "
              f"launch (us, mean of 20 calls; {smi}): " + "; ".join(
                  f"{n[:40]} {d:.2f}" + (f", gap {gaps[k]:.2f}"
                                         if k < len(gaps) else "")
                  for k, (n, d) in enumerate(zip(names, dur))), flush=True)
        if (kernel, "stamps") in calls:
            stamp_split(kernel, libs[(kernel, "stamps")],
                        calls[(kernel, "stamps")], design(kernel)[2], smi)
    for kernel in ("orb_select", "orb_pyramid"):
        names = [v for k, v in jobs if k == kernel and v != "stamps"]
        times = {v: [] for v in names}
        for r in range(opt.rounds):
            for v in (names if r % 2 == 0 else names[::-1]):
                ms, ops, _ = cs.device_profile(calls[(kernel, v)], reps=20)
                times[v].append((ms, ops))
        for v in names:
            ms = [t for t, _ in times[v]]
            print(f"# {kernel} variant {v}: {float(np.median(ms)):.4f} ms "
                  f"device time per call, {times[v][0][1]:.0f} device ops "
                  f"(median of {opt.rounds} rounds: "
                  f"{', '.join(f'{t:.4f}' for t in ms)}) ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    # flushed, then os._exit: after torch.profiler's CUDA traces the
    # interpreter's native finalization can hang (scripts/frame_stage_split.py)
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
