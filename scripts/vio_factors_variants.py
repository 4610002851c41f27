#!/usr/bin/env python3
"""Split the time of the VIO factor kernel vio_factors
(csrc/vio_factors.cu, its residuals in csrc/vio_dual.cuh) on one CUDA
card by variants of its sources, and time an earlier design against the
current one in turns.

    git show <commit>:mcslam_tpu_torch/csrc/vio_factors.cu \\
        > mcslam_tpu_torch/_build/earlier_vio/vio_factors.cu
    git show <commit>:mcslam_tpu_torch/csrc/vio_dual.cuh \\
        > mcslam_tpu_torch/_build/earlier_vio/vio_dual.cuh
    python3 scripts/vio_factors_variants.py [--rounds 5] [--only VARIANT ...]
        [--earlier mcslam_tpu_torch/_build/earlier_vio]

Run from the repository's root. --earlier takes a directory holding an
earlier vio_factors.cu and its vio_dual.cuh, a vio_factors.cu alone
(built against the vio_dual.cuh beside it, else the current one), or a
git revision where the checkout has its history; its design must be
listed in DESIGNS. Builds each source as it stands and with the edits of
each variant below (one nvcc per variant, all started together, into
mcslam_tpu_torch/_build/vio_variants/), prints each build's registers,
stack, spills and SASS instructions (cuobjdump) and, for each source's
full variant, the source lines of its local-memory instructions (a
-lineinfo cubin through nvdisasm), checks the current
source's full variant bit for bit against the package's kernel, and
with --earlier holds the two designs' full variants to each other on
every problem of chip_smoke.VIO_FACTOR_CASES: H, g and the cost bit for
bit, or else every J and r entry of the factors' records equal or 1
float32 ulp apart, or within chip_smoke.VIO_J_FLOOR of its table's
largest |J| (it prints which, and the largest ulps). Then it prints the
stamps variants' phases per call (mean of 20 calls) and each variant's
time per launch on the three stage D problems (K = 6: without GPS, with
GPS, with GPS and between factors): 20 launches captured in a CUDA
graph, its replays timed by CUDA events (the launch gaps of a graph
included), the variants of both sources taking turns within each round,
reversed every other round; median over the rounds. The variants'
outputs are not the function's, except those of full and of the
residual variants (fmad, sincos, tangent0, all3), which change only the
float64 roundings of J and r. The anchors are exact source lines of
the design the source holds (its marker line); an edit whose anchor is
not found as often as listed fails the run. Needs one CUDA card.

The arrival-counter design: a warp per factor (one a block) and a last
block (the last to arrive at a counter) that starts H and g row by row
and scatters each table's factors into a table sum (marker "constexpr
int COLS_AHEAD = 4;"):
  full      the source as it stands;
  stamps    %globaltimer stamps (ARRIVAL_PHASES): the first block's start,
            the slowest IMU residual, the factors done, the last block's
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
            csrc/vio_dual.cuh not inlined: each a function its callers
            share;
  fmad      the residual's float64 multiply-adds contracted (built
            without -fmad=false; the records' float32 sums written with
            __fadd_rn, so they keep their separate roundings);
  sincos    each angle's sine and cosine by one sincos call shared by
            the value and the derivative, and a dual division by one
            reciprocal of the divisor;
  tangent0  the retraction at tangent 0 written out exactly: R = T.R
            with derivative T.R hat(e_w), t = T.t with derivative
            T.R e_v (no so3_exp or left Jacobian of the zero tangent);
  all3      fmad, sincos and tangent0 together.

The cluster design: one thread-block cluster, factor q on block q mod C,
each block starting its band of rows of H and g under the residuals and
placing it after the cluster barrier (marker "constexpr int CLUSTER =
8;"):
  full      the source as it stands;
  stamps    %globaltimer stamps (CLUSTER_PHASES): the first block's
            start, the inputs staged, the slowest IMU residual and
            record, the factors done and the bands started (each block
            at its cluster barrier), the barrier passed, the blocks
            copied, the cost, the bands placed, the end;
  noplace   no factor added to the bands (H and g the vision and prior
            terms);
  nofactor  no residual: every factor's duals are 0;
  launch    both;
  nostage   each factor's inputs read from device memory by the
            residual, not staged in shared memory first;
  nofmad    the residual built with -fmad=false (the arrival-counter design's
            roundings);
  cluster16 a 16-block cluster (non-portable; where the card's
            occupancy query says it fits);
  unroll1   the record's (w J)^T J rows one at a time, not two;
  qloop     the factor loop carried by the factor's index alone;
  noinline  the three factor functions not inlined (ptxas then reports
            each one's registers, stack and spills apart).
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
SOURCE = "mcslam_tpu_torch/csrc/vio_factors.cu"
HEADER = "mcslam_tpu_torch/csrc/vio_dual.cuh"
REPS = 20  # launches a timed graph replays
STAMP_SLOTS = 12  # g_stamps' entries

# %globaltimer stamps (a variant's source edits)
STAMP_PRELUDE = """
__device__ unsigned long long g_stamps[12];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(k) if (threadIdx.x == 0) atomicMax(&g_stamps[k], gtime())
#define LANE_STAMP(k) if ((threadIdx.x & 31) == 0) atomicMax(&g_stamps[k], gtime())
extern "C" int mc_vio_stamps(void* host, int reset) {
  if (reset) {
    unsigned long long z[12] = {~0ull};
    return (int)cudaMemcpyToSymbol(g_stamps, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));
}
"""
PRELUDE = ("cu", '#include "vio_dual.cuh"\n',
           '#include "vio_dual.cuh"\n' + STAMP_PRELUDE, 1)


def cu(edits):
    """(anchor, replacement, times) edits of the .cu source."""
    return [("cu", a, b, n) for a, b, n in edits]


# ---- the arrival-counter design ---------------------------------------------------------
ARRIVAL = "constexpr int COLS_AHEAD = 4;"
ARRIVAL_STAMPS = [PRELUDE] + cu([
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
])
ARRIVAL_PHASES = (("to the last block's factors done", 0, 1),
               ("to the slowest IMU residual", 0, 7), ("arrival", 1, 2),
               ("blocks, weights, records and acc loaded", 2, 3),
               ("of the loads: blocks and weights", 2, 8),
               ("the records' copies issued", 8, 9),
               ("H and g started", 9, 10), ("the copies landed", 10, 3),
               ("the tables' sums", 3, 4), ("H and g out", 4, 5),
               ("cost", 5, 6), ("start to end", 0, 6))
ARRIVAL_RESIDUALS = cu([
    ("  vio::imu_residual<double>(in, a.g_norm, lane, r);",
     "  for (int k = 0; k < 15; ++k) r[k] = {0.0, 0.0};", 1),
    ("  vio::gps_residual<double>(in, lane, r);",
     "  for (int k = 0; k < 3; ++k) r[k] = {0.0, 0.0};", 1),
    ("  vio::between_residual<double>(in, lane, r);",
     "  for (int k = 0; k < 6; ++k) r[k] = {0.0, 0.0};", 1),
])
ARRIVAL_LOOP = ("    const int n = ncols(t), h = t == 0 ? D : 6, "
             "q0 = first_of(a, t);\n    bool any = false;\n")
ARRIVAL_NO_TABLES = cu([(ARRIVAL_LOOP, ARRIVAL_LOOP.replace(
    "bool any = false;", "bool any = false;\n    continue;"), 1)])
ARRIVAL_NOINLINE = [
    ("cuh", a, a.replace("VIO_HD", "__device__ __noinline__"), 1)
    for a in ("VIO_HD M3<S> mm(", "VIO_HD V3<S> mv(", "VIO_HD M3<S> so3_exp(",
              "VIO_HD M3<S> so3_left_jacobian(", "VIO_HD Pose<S> retract(")]
# the record products' float32 sums never contracted into FMAs
ARRIVAL_F32_SUMS = cu([
    ("      for (int k = 1; k < R; ++k) acc = acc + (w * sJ[k][s]) * Jt[k];",
     "      for (int k = 1; k < R; ++k) acc = __fadd_rn(acc, (w * sJ[k][s]) "
     "* Jt[k]);", 1),
    ("    for (int k = 1; k < R; ++k) ga = ga + (w * Jt[k]) * sr[k];",
     "    for (int k = 1; k < R; ++k) ga = __fadd_rn(ga, (w * Jt[k]) * "
     "sr[k]);", 1),
    ("    for (int k = 1; k < R; ++k) c = c + rv[k] * rv[k];",
     "    for (int k = 1; k < R; ++k) c = __fadd_rn(c, rv[k] * rv[k]);", 1),
])
# that design's csrc/vio_dual.cuh: sin and cos by one sincos, a dual division by
# one reciprocal
DSINCOS = """// sin and cos of one angle by one sincos call, their derivatives as
// dsin's and dcos'
template <class S>
VIO_HD void dsincos(Dual<S> a, Dual<S>* s, Dual<S>* c) {
  S sv, cv;
  sincos(a.v, &sv, &cv);
  *s = {sv, a.d * cv};
  *c = {cv, a.d * -sv};
}
"""
ARRIVAL_SINCOS = [
    ("cuh", "// 1.0 / a as torch evaluates it: reciprocal(a) * 1.0\n",
     DSINCOS + "// 1.0 / a as torch evaluates it: reciprocal(a) * 1.0\n", 1),
    ("cuh", "  const S q = a.v / b.v;\n  return {q, (a.d - b.d * q) / b.v};\n",
     "  const S rb = S(1) / b.v;\n  const S q = a.v * rb;\n"
     "  return {q, (a.d - b.d * q) * rb};\n", 1),
    ("cuh", """  const Dual<S> a =
      t.small ? (S(1) - t2 / S(6)) + (t2 * t2) / S(120) : dsin(th) / th;
  const Dual<S> b = t.small ? (S(0.5) - t2 / S(24)) + (t2 * t2) / S(720)
                            : (S(1) - dcos(th)) / (th * th);
""", """  Dual<S> a, b;
  if (t.small) {
    a = (S(1) - t2 / S(6)) + (t2 * t2) / S(120);
    b = (S(0.5) - t2 / S(24)) + (t2 * t2) / S(720);
  } else {
    Dual<S> sn, cs;
    dsincos(th, &sn, &cs);
    a = sn / th;
    b = (S(1) - cs) / (th * th);
  }
""", 1),
    ("cuh", """  const Dual<S> b =
      t.small ? S(0.5) - t2 / S(24) : (S(1) - dcos(th)) / (th * th);
  const Dual<S> c = t.small ? S(1.0 / 6.0) - t2 / S(120)
                            : (th - dsin(th)) / ((th * th) * th);
""", """  Dual<S> b, c;
  if (t.small) {
    b = S(0.5) - t2 / S(24);
    c = S(1.0 / 6.0) - t2 / S(120);
  } else {
    Dual<S> sn, cs;
    dsincos(th, &sn, &cs);
    b = (S(1) - cs) / (th * th);
    c = (th - sn) / ((th * th) * th);
  }
""", 1),
    ("cuh", """    const Dual<S> s = dsin(th);
    const Dual<S> safe = fabs(s.v) < S(1e-12) ? cst<S>(S(1)) : s;
    coeff = drecip(th * th) * S(1) - (S(1) + dcos(th)) / ((S(2) * th) * safe);
""", """    Dual<S> s, cs;
    dsincos(th, &s, &cs);
    const Dual<S> safe = fabs(s.v) < S(1e-12) ? cst<S>(S(1)) : s;
    coeff = drecip(th * th) * S(1) - (S(1) + cs) / ((S(2) * th) * safe);
""", 1),
]
# that design's csrc/vio_dual.cuh: the retraction at tangent 0 written out
RETRACT0 = """  // at tangent 0 exactly: R = T.R, its derivative T.R hat(e_w); t = T.t,
  // its derivative T.R e_v (e the lane's basis vector)
  S e[6];
  for (int k = 0; k < 6; ++k) e[k] = S(dir == off + k ? 1 : 0);
  const S h[9] = {S(0), -e[2], e[1], e[2], S(0), -e[0], -e[1], e[0], S(0)};
  Pose<S> P;
  for (int i = 0; i < 3; ++i) {
    const S a0 = T.R.m[3 * i].v, a1 = T.R.m[3 * i + 1].v,
            a2 = T.R.m[3 * i + 2].v;
    for (int j = 0; j < 3; ++j)
      P.R.m[3 * i + j] = {T.R.m[3 * i + j].v,
                          (a0 * h[j] + a1 * h[3 + j]) + a2 * h[6 + j]};
    P.t.x[i] = {T.t.x[i].v, (a0 * e[3] + a1 * e[4]) + a2 * e[5]};
  }
  return P;
"""
ARRIVAL_TANGENT0 = [
    ("cuh", """  const V3<S> w = {{basis<S>(off, dir), basis<S>(off + 1, dir),
                    basis<S>(off + 2, dir)}};
  const V3<S> v = {{basis<S>(off + 3, dir), basis<S>(off + 4, dir),
                    basis<S>(off + 5, dir)}};
  const M3<S> R = so3_exp(w);
  const V3<S> t = mv(so3_left_jacobian(w), v);
  return {mm(T.R, R), vadd(mv(T.R, t), T.t)};
""", RETRACT0, 1)]


class V:
    """A variant: its source edits [(file "cu" / "cuh", anchor,
    replacement, times found)], its nvcc -fmad setting (None: the
    source's), and the phases its stamps measure."""

    def __init__(self, edits=(), fmad=None, phases=None):
        self.edits, self.fmad, self.phases = list(edits), fmad, phases


# ---- the cluster design -----------------------------------------------------
CLUSTER_STAMPS = [PRELUDE] + cu([
    ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
     "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
     "  if (tid == 0) atomicMin(&g_stamps[0], gtime());\n", 1),
    ("  __syncwarp();  // the factor's inputs staged\n",
     "  __syncwarp();  // the factor's inputs staged\n  LANE_STAMP(1);\n", 1),
    ("  vio::imu_residual<double>(in, a.g_norm, lane, r);\n",
     "  vio::imu_residual<double>(in, a.g_norm, lane, r);\n"
     "  LANE_STAMP(2);\n", 1),
    ("      imu_factor(a, f, lane, s_w[warp], rec, blk_s);\n",
     "      { imu_factor(a, f, lane, s_w[warp], rec, blk_s); "
     "LANE_STAMP(9); }\n", 1),
    ("  // the block's factors and its band's start done\n",
     "  __syncthreads();\n  STAMP(3);\n", 1),
    ("  cluster_wait();  // every factor's record written\n",
     "  cluster_wait();  // every factor's record written\n  STAMP(4);\n",
     1),
    ("  __syncthreads();   // the copies\n",
     "  __syncthreads();   // the copies\n  STAMP(8);\n", 1),
    ("  // the cost written\n", "  __syncthreads();\n  STAMP(5);\n", 1),
    ("  // the band placed\n", "  __syncthreads();\n  STAMP(6);\n", 1),
    ("  // end of the kernel\n", "  STAMP(7);\n", 1),
])
CLUSTER_PHASES = (("to the inputs staged", 0, 1),
                  ("to the slowest IMU residual", 0, 2),
                  ("to the slowest IMU record", 0, 9),
                  ("to the factors done and bands started", 0, 3),
                  ("the cluster barrier", 3, 4), ("the copies", 4, 8),
                  ("the cost", 8, 5), ("the bands placed", 5, 6),
                  ("to the end", 6, 7), ("start to end", 0, 7))
CLUSTER_RESIDUALS = cu([
    ("  vio::imu_residual<double>(in, a.g_norm, lane, r);",
     "  for (int k = 0; k < 15; ++k) r[k] = {0.0, 0.0};", 1),
    ("  vio::gps_residual<double>(in, lane, r);",
     "  for (int k = 0; k < 3; ++k) r[k] = {0.0, 0.0};", 1),
    ("  vio::between_residual<double>(in, lane, r);",
     "  for (int k = 0; k < 6; ++k) r[k] = {0.0, 0.0};", 1),
])
CLUSTER_NOPLACE = cu([("const int4 m = l.meta[q];",
                       "const int4 m = make_int4(-1, -1, 0, 0);", 1)])

# design marker -> {variant: V}
DESIGNS = {
    ARRIVAL: {
        "full": V(),
        "stamps": V(ARRIVAL_STAMPS, phases=ARRIVAL_PHASES),
        "noplace": V(ARRIVAL_NO_TABLES),
        "nofactor": V(ARRIVAL_RESIDUALS),
        "launch": V(ARRIVAL_NO_TABLES + ARRIVAL_RESIDUALS),
        "nocopy": V(cu([("  a.staged = smem + recs <= SMEM_MAX;",
                         "  a.staged = 0;", 1)])),
        "noprior": V(cu([("                      __ldg(a.prior_H + r * N + "
                          "c);", "                      0.f;", 1)])),
        "noinline_lie": V(ARRIVAL_NOINLINE),
        "fmad": V(ARRIVAL_F32_SUMS, fmad=True),
        "sincos": V(ARRIVAL_SINCOS),
        "tangent0": V(ARRIVAL_TANGENT0),
        "all3": V(ARRIVAL_F32_SUMS + ARRIVAL_SINCOS + ARRIVAL_TANGENT0, fmad=True),
    },
    "constexpr int CLUSTER = 8;": {
        "full": V(),
        "stamps": V(CLUSTER_STAMPS, phases=CLUSTER_PHASES),
        "noplace": V(CLUSTER_NOPLACE),
        "nofactor": V(CLUSTER_RESIDUALS),
        "launch": V(CLUSTER_NOPLACE + CLUSTER_RESIDUALS),
        "nostage": V(cu([("constexpr bool STAGE_INPUTS = true;",
                          "constexpr bool STAGE_INPUTS = false;", 1)])),
        "nofmad": V(fmad=False),
        "cluster16": V(cu([("constexpr int CLUSTER = 8;",
                            "constexpr int CLUSTER = 16;", 1)])),
        "unroll1": V(cu([("#pragma unroll 2\n    for (int s = 0; s < N; ++s) {",
                          "#pragma unroll 1\n    for (int s = 0; s < N; ++s) {",
                          1)])),
        "qloop": V(cu([("  for (int u = warp; u < nloc; u += WARPS) {\n"
                        "    const int q = block_rank() + CLUSTER * u;\n",
                        "  for (int q = block_rank() + CLUSTER * warp; q < nf;"
                        "\n       q += CLUSTER * WARPS) {\n"
                        "    const int u = q / CLUSTER;\n", 1)])),
        "noinline": V(cu([(f"__device__ __forceinline__ void {n}(",
                           f"__device__ __noinline__ void {n}(", 1)
                          for n in ("imu_factor", "gps_factor",
                                    "between_factor")])),
    },
}
RESIDUAL_VARIANTS = ("fmad", "sincos", "tangent0", "all3", "nofmad",
                     "nostage", "cluster16")


def design(text: str) -> str:
    """The newest design whose marker the source holds."""
    for marker in reversed(list(DESIGNS)):
        if marker in text:
            return marker
    raise RuntimeError("vio_factors_variants: no known design in the source")


def variant_sources(src: dict, name: str) -> dict:
    """{"cu": text, "cuh": text} of variant `name` of the design src
    holds."""
    out = dict(src)
    for where, anchor, new, times in DESIGNS[design(src["cu"])][name].edits:
        found = out[where].count(anchor)
        if found != times:
            raise RuntimeError(f"variant {name}: anchor found {found} times "
                               f"in the {where}, not {times}: {anchor!r}")
        out[where] = out[where].replace(anchor, new)
    return out


def read_sources(spec) -> dict:
    """{"cu", "cuh"} of the current sources (spec None), or of --earlier:
    a directory, a vio_factors.cu, or a git revision."""
    from mcslam_tpu_torch import _build

    current = (_build.CSRC / "vio_dual.cuh").read_text()
    if spec is None:
        return {"cu": (_build.CSRC / "vio_factors.cu").read_text(),
                "cuh": current}
    path = pathlib.Path(spec)
    if path.is_dir():
        return {"cu": (path / "vio_factors.cu").read_text(),
                "cuh": (path / "vio_dual.cuh").read_text()}
    if path.exists():
        head = path.with_name("vio_dual.cuh")
        return {"cu": path.read_text(),
                "cuh": head.read_text() if head.exists() else current}

    def show(rel):
        return subprocess.run(["git", "show", f"{spec}:{rel}"], cwd=ROOT,
                              check=True, capture_output=True,
                              text=True).stdout

    return {"cu": show(SOURCE), "cuh": show(HEADER)}


# a design's -fmad setting where its variant names none (None: the
# package's flags for vio_factors)
DESIGN_FMAD = {ARRIVAL: False}


def nvcc_flags(marker, fmad) -> list:
    from mcslam_tpu_torch import _build

    flags = list(_build.SOURCE_FLAGS.get("vio_factors", []))
    fmad = DESIGN_FMAD.get(marker) if fmad is None else fmad
    if fmad is not None:
        flags = [f for f in flags if not f.startswith("-fmad")]
        flags.append(f"-fmad={'true' if fmad else 'false'}")
    return flags


def build_all(jobs) -> dict:
    """{(source tag, variant): ctypes library} for jobs [(tag, sources,
    variant)], one nvcc per variant, started together; each variant's
    header beside its source."""
    from mcslam_tpu_torch import _build

    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for tag, src, name in jobs:
        stem = f"vio_factors_{tag}_{name}"
        text = variant_sources(src, name)
        inc = OUT / f"{stem}_inc"
        inc.mkdir(exist_ok=True)
        (inc / "vio_factors.cu").write_text(text["cu"])
        (inc / "vio_dual.cuh").write_text(text["cuh"])
        marker = design(src["cu"])
        var = DESIGNS[marker][name]
        cmd = [nvcc, *_build.ARCH_FLAGS, *_build.NVCC_FLAGS,
               *nvcc_flags(marker, var.fmad), "-Xptxas", "-v", "-I", str(inc),
               "-shared", "-o", str(OUT / f"{stem}.so"),
               str(inc / "vio_factors.cu")]
        procs[(tag, name)] = (stem, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        if name == "full":  # and a cubin with line information
            cub = [c for c in cmd if c not in ("-Xptxas", "-v", "-shared")]
            cub[cub.index("-o") + 1] = str(OUT / f"{stem}.cubin")
            procs[(tag, "lines")] = (stem, subprocess.Popen(
                [*cub[:1], "-cubin", "-lineinfo", *cub[1:]],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (tag, name), (stem, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {tag} {name}:\n{log}")
        if name == "lines":
            print(f"# build {tag} full: "
                  f"{local_lines(OUT / f'{stem}.cubin')}", flush=True)
            continue
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


def local_lines(cubin) -> str:
    """The source lines of the local-memory instructions (spills and
    local arrays: STL / LDL) of a -lineinfo cubin (nvdisasm), or why they
    were not found."""
    exe = shutil.which("nvdisasm") or "/usr/local/cuda/bin/nvdisasm"
    if not pathlib.Path(exe).exists():
        return "local memory lines not found (no nvdisasm)"
    out = subprocess.run([exe, "--print-line-info", str(cubin)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        return f"local memory lines not found (nvdisasm rc {out.returncode})"
    where, count = None, {}
    for line in out.stdout.splitlines():
        m = re.search(r'File "([^"]+)", line (\d+)', line)
        if m:
            where = f"{pathlib.Path(m.group(1)).name}:{m.group(2)}"
        elif re.search(r"\b(STL|LDL)(\.\S+)?\s", line):
            op = "store" if "STL" in line else "load"
            count[(where, op)] = count.get((where, op), 0) + 1
    return "local memory instructions by source line: " + (", ".join(
        f"{w} {op} x{n}" for (w, op), n in sorted(
            count.items(), key=lambda kv: -kv[1])[:24]) or "none")


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


class CounterABI:
    """The arrival-counter design's entry on the current wrapper's pointer
    table: its table
    had one more pointer, an arrival counter (one int, zero between
    launches), and its scratch room for the last block's accumulators
    behind the records (scratch_floats then: the records + 2 NN +
    (NN + 3) / 4 floats); `scratch` is its scratch slab."""

    def __init__(self, lib, dev):
        import torch

        self.lib, self.dev, self.scratch = lib, dev, None
        self.counter = torch.zeros(1, dtype=torch.int32, device=dev)
        self.slabs = {}

    def mc_vio_factors(self, ptrs, K, F, G, B, g_norm, stream):
        import torch

        from mcslam_tpu_torch.backend import vio_cuda

        N = 15 * K + 6
        NN = N * N + N
        n = (F * vio_cuda.rec_floats("imu") + G * vio_cuda.rec_floats("gps")
             + B * vio_cuda.rec_floats("between") + 2 * NN + (NN + 3) // 4)
        if n not in self.slabs:
            self.slabs[n] = torch.empty(n, dtype=torch.float32,
                                        device=self.dev)
        self.scratch = self.slabs[n]
        k = vio_cuda._OUT_SLOT
        table = list(ptrs)[:k + 3] + [self.scratch.data_ptr(),
                                      self.counter.data_ptr()]
        arr = (ctypes.c_void_p * len(table))(*table)
        return self.lib.mc_vio_factors(arr, K, F, G, B, g_norm, stream)


def adapt(lib, src, dev):
    """The library as the current wrapper calls it."""
    if design(src["cu"]) == ARRIVAL:
        return CounterABI(lib, dev)
    return lib


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


def records(prep, lib):
    """record_views of the launch just made through lib."""
    from mcslam_tpu_torch.backend import vio_cuda

    scratch = lib.scratch if isinstance(lib, CounterABI) else prep.scratch
    return vio_cuda.record_views(scratch, prep.counts)


def compare(case, a, b, cs, strict=True) -> None:
    """Prints how launch `a` (H, g, cost, records) stands to launch `b`;
    past the criteria it fails (strict) or says so."""
    same = all(cs.same_bits(x, y) for x, y in zip(a[:3], b[:3]))
    worst, floor = 0, 0
    for name, rec in b[3].items():
        scale = float(rec[0].abs().max())
        for x, y in zip(a[3][name][:2], rec[:2]):
            u = cs.f32_ulps(x, y)
            diff = (x.double() - y.double()).abs()
            bad = (u > 1) & (diff > cs.VIO_J_FLOOR * scale)
            msg = (f"{case} {name}: {int(bad.sum())} J or r entries more "
                   f"than 1 ulp and the floor apart")
            cs.check(not strict or not bool(bad.any()), msg)
            if bool(bad.any()):
                print(f"# {msg}: BEYOND the criteria", flush=True)
            worst = max(worst, int(u.max()))
            floor += int(((u > 1) & ~bad).sum())
    print(f"# {case}: H, g, cost "
          f"{'bit-equal' if same else 'not bit-equal'}; J and r at most "
          f"{worst} ulp apart, {floor} entries more than 1 ulp but under "
          f"the floor", flush=True)


def stamp_split(label, lib, phases, prep, args, smi, reps=20) -> None:
    """The stamps variant's phases (us, mean of reps calls)."""
    import numpy as np
    import torch

    raw = lib.lib if isinstance(lib, CounterABI) else lib
    raw.mc_vio_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    raw.mc_vio_stamps.restype = ctypes.c_int
    host = (ctypes.c_ulonglong * STAMP_SLOTS)()
    rows = []
    for _ in range(reps + 2):
        torch.cuda.synchronize()
        assert raw.mc_vio_stamps(host, 1) == 0
        with launching(lib):
            prep(*args)
        torch.cuda.synchronize()
        assert raw.mc_vio_stamps(host, 0) == 0
        t = [int(x) for x in host]
        rows.append([t[b] - t[a] for _, a, b in phases])
    m = np.mean(np.array(rows[2:], dtype=np.float64), axis=0) / 1e3
    print(f"# {label} stamps (us, mean of {reps} calls, %globaltimer; "
          f"{smi}): " + "; ".join(f"{name} {v:.2f}"
                                  for (name, _, _), v in zip(phases, m)),
          flush=True)


def problem(cs, dev, case):
    """(VioFactors, its call's args) of chip_smoke's problem `case`."""
    from mcslam_tpu_torch.backend import ba, ba_vio, vio_cuda

    p = cs.vio_factors_problem(dev, case)
    sys_ = ba._blocked_system(ba_vio._vision_problem(p), 2.5)
    (Hpp, gp, *_), cost, _ = sys_((p.poses, p.landmarks), p.obs.valid)
    return vio_cuda.VioFactors(p), (p.poses, p.vels, p.biases, p.E_T_V, Hpp,
                                    gp, cost)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--only", nargs="*", default=None,
                    help="variants (default: all of each design)")
    ap.add_argument("--earlier", default=None,
                    help="an earlier design: a directory, a vio_factors.cu "
                         "or a git revision")
    opt = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from mcslam_tpu_torch import _build

    if not torch.cuda.is_available():
        print("vio_factors_variants: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    sources = {"current": read_sources(None)}
    if opt.earlier:
        sources["earlier"] = read_sources(opt.earlier)
    jobs = [(tag, src, name) for tag, src in sources.items()
            for name in DESIGNS[design(src["cu"])]
            if opt.only is None or name in opt.only or name == "full"]
    libs = {(tag, name): adapt(lib, sources[tag], dev)
            for (tag, name), lib in build_all(jobs).items()}
    _build.library()

    calls = {}
    for case, (K, _, slots, _) in cs.VIO_FACTOR_CASES.items():
        prep, args = problem(cs, dev, case)
        ref = prep(*args)
        torch.cuda.synchronize()
        ref = (*ref, records(prep, None))
        with launching(libs[("current", "full")]):
            out = prep(*args)
        torch.cuda.synchronize()
        same = all(cs.same_bits(a, b) for a, b in zip(out, ref))
        print(f"# {case}: the current source's full variant "
              f"{'bit-equal to' if same else 'DIFFERS from'} the package's "
              f"kernel", flush=True)
        cs.check(same, f"{case}: the current source differs from the package")
        for tag, name in list(libs):
            if name not in RESIDUAL_VARIANTS and not (
                    tag == "earlier" and name == "full"):
                continue
            lib = libs[(tag, name)]
            try:
                with launching(lib):
                    out = prep(*args)
                torch.cuda.synchronize()
            except RuntimeError as e:  # a variant the card refuses
                print(f"# {tag} {name}: not run ({e})", flush=True)
                del libs[(tag, name)]
                continue
            out = (*[x.clone() for x in out], records(prep, lib))
            if tag == "earlier" and name == "full":
                compare(f"{case}: current against earlier", ref, out, cs)
            else:
                compare(f"{case}: {tag} {name} against the package's",
                        out, ref, cs, strict=False)
        if K == 6 and slots is None:  # the stage D problems are timed
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
        phases = DESIGNS[design(sources[tag]["cu"])][name].phases
        if phases:
            for case, (prep, args) in calls.items():
                stamp_split(f"{tag} {case}", lib, phases, prep, args, smi)
    for (tag, name), by_case in times.items():
        print(f"# {tag} {name}: ms per launch in a graph of {REPS} (median "
              f"of {opt.rounds} rounds) "
              + ", ".join(f"{case} {np.median(v):.5f}"
                          for case, v in by_case.items())
              + f" ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
