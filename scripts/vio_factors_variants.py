#!/usr/bin/env python3
"""Split the time of the VIO factor kernel vio_factors
(csrc/vio_factors.cu) on one CUDA card by variants of its source, and
time an earlier design of the source against the current one in turns.

    git show <commit>:mcslam_tpu_torch/csrc/vio_factors.cu > mcslam_tpu_torch/_build/earlier_vio_factors.cu
    python3 scripts/vio_factors_variants.py [--rounds 5] [--only VARIANT ...]
        [--earlier mcslam_tpu_torch/_build/earlier_vio_factors.cu]

Run from the repository's root. Builds csrc/vio_factors.cu as it stands
(and with --earlier that file, which includes the current
csrc/vio_dual.cuh and must hold a design listed in DESIGNS) with the
edits of each variant below (one nvcc per variant, all started
together, into mcslam_tpu_torch/_build/vio_variants/), prints each
build's registers, stack, spills and SASS instructions (cuobjdump),
checks every source's full variant bit for bit against the package's
kernel on chip_smoke.py phase 2's three stage D problems (those of
chip_smoke.VIO_FACTOR_CASES at K = 6), prints the stamps variant's phases per call (mean of
20 calls), then each variant's time per launch on each problem: 20
launches captured in a CUDA graph, its replays timed by CUDA events
(the launch gaps of a graph included), the variants of both sources
taking turns within each round, reversed every other round; median over
the rounds. The variants' outputs are not the function's, except full's.
The anchors are exact source lines of the design the source holds (its
marker line); an edit whose anchor is not found as often as listed
fails the run. Needs one CUDA card.

The design of a warp per factor (one a block) and a last block that
starts H and g row by row and scatters each table's factors into a table
sum (marker "constexpr int COLS_AHEAD = 4;"):
  full      the source as it stands;
  stamps    %globaltimer stamps (PHASES): the first block's start, the
            slowest IMU residual, the factors done, the last block's
            arrival, its loads split by barriers of their own (the
            factors' blocks and weights, the records' copies issued, H
            and g started, the copies landed), the tables' sums, H and g
            out, the cost;
  noplace   no table's sums (H and g the vision and prior terms);
  nofactor  no residual: every factor's duals are 0 (the records, the
            blocks and the placement as before);
  launch    both;
  nocopy    the records read from L2, not copied to shared memory;
  noprior   H started without its prior term (no prior_H load);
  noinline_lie  mm, mv, so3_exp, so3_left_jacobian and retract of
            csrc/vio_dual.cuh not inlined (a copy of the header beside
            the variant): each a function its callers share.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
OUT = ROOT / "mcslam_tpu_torch" / "_build" / "vio_variants"
REPS = 20  # launches a timed graph replays

# %globaltimer stamps (a variant's source edits)
STAMP_PRELUDE = """
__device__ unsigned long long g_stamps[12];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(k) if (threadIdx.x == 0) atomicMax(&g_stamps[k], gtime())
extern "C" int mc_vio_stamps(void* host, int reset) {
  if (reset) {
    unsigned long long z[12] = {~0ull};
    return (int)cudaMemcpyToSymbol(g_stamps, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));
}
"""
STAMPS = [
    ('#include "vio_dual.cuh"\n', '#include "vio_dual.cuh"\n' + STAMP_PRELUDE,
     1),
    ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
     "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
     "  if (tid == 0) atomicMin(&g_stamps[0], gtime());\n", 1),
    ("  vio::imu_residual<double>(in, a.g_norm, lane, r);\n",
     "  vio::imu_residual<double>(in, a.g_norm, lane, r);\n  STAMP(7);\n", 1),
    ("  __syncthreads();  // the block's records written\n",
     "  __syncthreads();  // the block's records written\n  STAMP(1);\n", 1),
    ("  if (!s_last) return;\n", "  if (!s_last) return;\n  STAMP(2);\n", 1),
    ("  // a table's factor f: its (w J)^T J at blk0[t]",
     "  __syncthreads();\n  STAMP(8);\n"
     "  // a table's factor f: its (w J)^T J at blk0[t]", 1),
    ("  const int K6 = 6 * K;\n",
     "  __syncthreads();\n  STAMP(9);\n  const int K6 = 6 * K;\n", 1),
    ("  cp_async_wait_all();\n",
     "  __syncthreads();\n  STAMP(10);\n  cp_async_wait_all();\n", 1),
    ("  __syncthreads();  // meta, acc, part, touched and the staged "
     "records\n",
     "  __syncthreads();  // meta, acc, part, touched and the staged "
     "records\n  STAMP(3);\n", 1),
    ("  // 4. H, g and the cost out\n", "  __syncthreads();\n  STAMP(4);\n",
     1),
    ("  if (tid == 0) {\n    float c = __ldg(a.vcost);\n",
     "  __syncthreads();\n  STAMP(5);\n"
     "  if (tid == 0) {\n    float c = __ldg(a.vcost);\n", 1),
    ("  // end of the last block\n", "  STAMP(6);\n", 1),
]
PHASES = (("to the last block's factors done", 0, 1),
          ("to the slowest IMU residual", 0, 7), ("arrival", 1, 2),
          ("blocks, weights, records and acc loaded", 2, 3),
          ("of the loads: blocks and weights", 2, 8),
          ("the records' copies issued", 8, 9), ("H and g started", 9, 10),
          ("the copies landed", 10, 3), ("the tables' sums", 3, 4),
          ("H and g out", 4, 5), ("cost", 5, 6), ("start to end", 0, 6))
RESIDUALS = (
    ("  vio::imu_residual<double>(in, a.g_norm, lane, r);",
     "  for (int k = 0; k < 15; ++k) r[k] = {0.0, 0.0};"),
    ("  vio::gps_residual<double>(in, lane, r);",
     "  for (int k = 0; k < 3; ++k) r[k] = {0.0, 0.0};"),
    ("  vio::between_residual<double>(in, lane, r);",
     "  for (int k = 0; k < 6; ++k) r[k] = {0.0, 0.0};"),
)
TABLES_LOOP = ("    const int n = ncols(t), h = t == 0 ? D : 6, "
               "q0 = first_of(a, t);\n    bool any = false;\n")
NO_TABLES = (TABLES_LOOP, TABLES_LOOP.replace(
    "bool any = false;", "bool any = false;\n    continue;"), 1)
# variants that also edit csrc/vio_dual.cuh (a copy beside the variant):
# {variant: [(anchor, replacement, times found)]}
NOINLINE = ("VIO_HD M3<S> mm(", "VIO_HD V3<S> mv(", "VIO_HD M3<S> so3_exp(",
            "VIO_HD M3<S> so3_left_jacobian(", "VIO_HD Pose<S> retract(")
HEADER_EDITS = {
    "noinline_lie": [(a, a.replace("VIO_HD", "__device__ __noinline__"), 1)
                     for a in NOINLINE],
}
# design marker -> {variant: [(anchor, replacement, times found)]}
DESIGNS = {
    "constexpr int COLS_AHEAD = 4;": {
        "full": [],
        "stamps": STAMPS,
        "noplace": [NO_TABLES],
        "nofactor": [(a, b, 1) for a, b in RESIDUALS],
        "launch": [NO_TABLES] + [(a, b, 1) for a, b in RESIDUALS],
        "nocopy": [("  a.staged = smem + recs <= SMEM_MAX;",
                    "  a.staged = 0;", 1)],
        "noprior": [("                      __ldg(a.prior_H + r * N + c);",
                     "                      0.f;", 1)],
        "noinline_lie": [],
    },
}


def design(text: str) -> str:
    """The newest design whose marker the source holds."""
    for marker in reversed(list(DESIGNS)):
        if marker in text:
            return marker
    raise RuntimeError("vio_factors_variants: no known design in the source")


def variant_source(text: str, name: str) -> str:
    for anchor, new, times in DESIGNS[design(text)][name]:
        found = text.count(anchor)
        if found != times:
            raise RuntimeError(f"variant {name}: anchor found {found} times, "
                               f"not {times}: {anchor!r}")
        text = text.replace(anchor, new)
    return text


def build_all(jobs) -> dict:
    """{(source tag, variant): ctypes library} for jobs [(tag, source
    text, variant)], one nvcc per variant, started together."""
    from mcslam_tpu_torch import _build

    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for tag, text, name in jobs:
        stem = f"vio_factors_{tag}_{name}"
        cu = OUT / f"{stem}.cu"
        cu.write_text(variant_source(text, name))
        inc = []
        if name in HEADER_EDITS:
            head = (_build.CSRC / "vio_dual.cuh").read_text()
            for anchor, new, times in HEADER_EDITS[name]:
                if head.count(anchor) != times:
                    raise RuntimeError(f"variant {name}: header anchor "
                                       f"{anchor!r} not found {times} times")
                head = head.replace(anchor, new)
            (OUT / f"{stem}_inc").mkdir(exist_ok=True)
            (OUT / f"{stem}_inc" / "vio_dual.cuh").write_text(head)
            inc = ["-I", str(OUT / f"{stem}_inc")]
        cmd = [nvcc, *_build.ARCH_FLAGS, *_build.NVCC_FLAGS,
               *_build.SOURCE_FLAGS["vio_factors"], "-Xptxas", "-v", *inc,
               "-I", str(_build.CSRC), "-shared", "-o",
               str(OUT / f"{stem}.so"), str(cu)]
        procs[(tag, name)] = (stem, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (tag, name), (stem, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {tag} {name}:\n{log}")
        for entry in re.findall(r"Compiling entry function '([^']+)'.*?"
                                r"(\d+ bytes stack frame, \d+ bytes spill "
                                r"stores, \d+ bytes spill loads).*?Used (\d+) "
                                r"registers([^\n]*)", log, re.S):
            print(f"# build {tag} {name}: {entry[2]} registers{entry[3]}, "
                  f"{entry[1]}", flush=True)
        print(f"# build {tag} {name}: {sass_size(OUT / f'{stem}.so')}",
              flush=True)
        lib = ctypes.CDLL(str(OUT / f"{stem}.so"))
        lib.mc_vio_factors.argtypes = _build.SIGNATURES["mc_vio_factors"]
        lib.mc_vio_factors.restype = ctypes.c_int
        libs[(tag, name)] = lib
    return libs


def sass_size(so) -> str:
    """The SASS instructions of each function in a library (cuobjdump),
    or why they were not counted."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(exe).exists():
        return "SASS not measured (no cuobjdump)"
    out = subprocess.run([exe, "-sass", str(so)], capture_output=True,
                         text=True)
    if out.returncode != 0:
        return f"SASS not measured (cuobjdump rc {out.returncode})"
    sizes, name = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            sizes[name] = 0
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", line):
            sizes[name] += 1
    return "SASS instructions " + ", ".join(
        f"{n[:48]} {c}" for n, c in sizes.items())


@contextlib.contextmanager
def launching(lib):
    """vio_cuda's launches go to `lib` while the context lasts."""
    from mcslam_tpu_torch.backend import vio_cuda

    real = vio_cuda._build.library
    vio_cuda._build.library = lambda *a, **kw: lib
    try:
        yield
    finally:
        vio_cuda._build.library = real


def stamp_split(label, lib, phases, prep, args, smi, reps=20) -> None:
    """The stamps variant's phases (us, mean of reps calls)."""
    import numpy as np
    import torch

    lib.mc_vio_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mc_vio_stamps.restype = ctypes.c_int
    host = (ctypes.c_ulonglong * 12)()
    rows = []
    for _ in range(reps + 2):
        torch.cuda.synchronize()
        assert lib.mc_vio_stamps(host, 1) == 0
        with launching(lib):
            prep(*args)
        torch.cuda.synchronize()
        assert lib.mc_vio_stamps(host, 0) == 0
        t = [int(x) for x in host]
        rows.append([t[b] - t[a] for _, a, b in phases])
    m = np.mean(np.array(rows[2:], dtype=np.float64), axis=0) / 1e3
    print(f"# {label} stamps (us, mean of {reps} calls, %globaltimer; "
          f"{smi}): " + "; ".join(f"{name} {v:.2f}"
                                  for (name, _, _), v in zip(phases, m)),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--only", nargs="*", default=None,
                    help="variants (default: all of the design)")
    ap.add_argument("--earlier", default=None,
                    help="an earlier vio_factors.cu to time in turns")
    opt = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from mcslam_tpu_torch import _build
    from mcslam_tpu_torch.backend import ba, ba_vio, vio_cuda

    if not torch.cuda.is_available():
        print("vio_factors_variants: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    sources = {"current": (_build.CSRC / "vio_factors.cu").read_text()}
    if opt.earlier:
        sources["earlier"] = pathlib.Path(opt.earlier).read_text()
    jobs = [(tag, text, name) for tag, text in sources.items()
            for name in DESIGNS[design(text)]
            if opt.only is None or name in opt.only or name == "full"]
    libs = build_all(jobs)
    _build.library()

    calls = {}
    # the stage D problems (K = 6, K - 1 IMU slots)
    for case, (K, _, slots, _) in cs.VIO_FACTOR_CASES.items():
        if K != 6 or slots is not None:
            continue
        p = cs.vio_factors_problem(dev, case)
        sys_ = ba._blocked_system(ba_vio._vision_problem(p), 2.5)
        (Hpp, gp, *_), cost, _ = sys_((p.poses, p.landmarks), p.obs.valid)
        prep = vio_cuda.VioFactors(p)
        args = (p.poses, p.vels, p.biases, p.E_T_V, Hpp, gp, cost)
        ref = prep(*args)
        for tag in sources:
            with launching(libs[(tag, "full")]):
                out = prep(*args)
            torch.cuda.synchronize()
            same = all(cs.same_bits(a, b) for a, b in zip(out, ref))
            print(f"# {case}: the {tag} source's full variant "
                  f"{'bit-equal to' if same else 'DIFFERS from'} the "
                  f"package's kernel", flush=True)
            cs.check(same or tag == "earlier",
                     f"{case}: the current source differs from the package")
        calls[case] = (prep, args)

    # each variant's launches captured in a CUDA graph per problem (REPS
    # launches back to back), the replays timed by CUDA events in turns
    graphs = {}
    for key, lib in libs.items():
        for case, (prep, args) in calls.items():
            with launching(lib):
                side = torch.cuda.Stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    prep(*args)
                torch.cuda.current_stream(dev).wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    for _ in range(REPS):
                        prep(*args)
            graphs[(key, case)] = graph
    times = {key: {case: [] for case in calls} for key in libs}
    order = list(libs)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    for rnd in range(opt.rounds):
        for key in (order if rnd % 2 == 0 else order[::-1]):
            for case in calls:
                graphs[(key, case)].replay()  # warm
                t0.record()
                graphs[(key, case)].replay()
                t1.record()
                torch.cuda.synchronize()
                times[key][case].append(t0.elapsed_time(t1) / REPS)
    for (tag, name), lib in libs.items():
        if name == "stamps":
            for case, (prep, args) in calls.items():
                stamp_split(f"{tag} {case}", lib, PHASES, prep, args, smi)
    for (tag, name), by_case in times.items():
        print(f"# {tag} {name}: ms per launch in a graph of {REPS} (median "
              f"of {opt.rounds} rounds) "
              + ", ".join(f"{case} {np.median(v):.5f}"
                          for case, v in by_case.items())
              + f" ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
