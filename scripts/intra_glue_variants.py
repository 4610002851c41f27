#!/usr/bin/env python3
"""Split the time of the frame build's glue kernels intra_gate,
intra_groups and tri_gather (csrc/intra_glue.cu) on one CUDA card by
%globaltimer stamps and by variants of the source, and time an earlier
design of the source against the current one in turns.

    git show <commit>:mcslam_tpu_torch/csrc/intra_glue.cu \\
        > mcslam_tpu_torch/_build/earlier_intra_glue.cu
    python3 scripts/intra_glue_variants.py \\
        [--earlier mcslam_tpu_torch/_build/earlier_intra_glue.cu]
        [--rounds 3] [--only SOURCE:VARIANT ...] [--kernels NAME ...]

Run from the repository's root (--earlier also takes a git revision where
the checkout has its history). Builds the source as it stands and the
earlier one, each as it is and with the edits of each variant below (one
nvcc per variant, all started together, into mcslam_tpu_torch/_build/
variants/; only the variants of the kernels named by --kernels, all
three by default), prints each build's registers, shared memory and
spills, and at bench frame 0's recorded calls of the kernels (chip_smoke.
capture_calls on frame.build_frame: C = 4 cameras, N = 768 features,
max_out 2048, so tri_gather's M = 2048 groups) checks each source's full
variant against the plain version bit for bit, then prints:
- each design's stamps variant's phases per call (the earliest start and
  the latest end of each phase over the blocks, stamped by thread 0 right
  after a barrier or by lane 0 of each warp; mean over 20 calls);
- each variant's device time per call (the variants of a kernel, of both
  designs, taking turns within each round, reversed every other round;
  20 calls a round, median over the rounds);
- beside the groups, torch.sort(stable=True, descending=True) of the
  frame's C N priorities: a yardstick for a sort phase, not the function;
- each kernel's wrapper in frontend/intra_cuda as the tree holds it (its
  checks, allocations and launch) by CUDA events: 20 calls between two
  events, after 3 warm-up calls, median over the rounds; where the tree
  carves tri_gather's outputs from one buffer (intra_cuda.
  tri_gather_outputs), that wrapper in turns with itself allocating the
  eight outputs by one torch.empty each (tri_gather_outputs patched),
  and the host time of the two allocations alone, in turns: 200 calls
  by the host clock, median over the rounds.
The edits are keyed by the design the source holds (its markers, the
newest design whose markers it holds); each design binds its own C
entries. The variants' outputs are not the function's, except full's.
An edit whose anchor is not found as often as listed fails the run.
Needs one CUDA card.

PR 22's design (16 rows a gate block, one groups block; markers
"GATE_ROWS = 16;", "int* __restrict__ table,"):
  full     the source as it stands;
  stamps   intra_gate: start, the column prologue (8 IEEE divisions a
           thread), the row loop (64 __fdiv_rn a thread) and its stores;
           intra_groups: start, the parents loaded and the global table
           filled with -1, the 8 hops, the atomicMax into global memory,
           the keys (4 __ldcg reads a root), the bitonic stages, the
           outputs;
  nodiv    intra_gate compares t^2 < thr2 den (the division's share);
  nosort   intra_groups sorts nothing (the bitonic stages' share).
PR 23's design (markers "GATE_RPT", "GROUP_SLICE"; its tri_gather is
PR 22's, a thread per group):
  full     the source as it stands;
  stamps   intra_gate: start, the block's column and row terms, the cells
           and their stores; intra_groups: start, the parents loaded, the
           roots, the masks and the slice's ray table, the keys, the
           partial ranks, their sum, the outputs and the padding;
           tri_gather: start, the group's row of ray_idx counted, the
           rays' gathers and stores issued, the anchor's second gather
           round and its stores, the group outputs;
  div      intra_gate takes the IEEE division in every cell (the new
           layout alone);
  nostore  intra_gate stores no gate (the stores' share);
  nocells  intra_gate computes no cell: the prologue and the stores;
  rpt3, rpt8  intra_gate with 3 or 8 rows a thread (48 or 128 rows a
           block, not 96);
  lanes32, lanes8  intra_gate in blocks of 32 or 8 row lanes (256 or 64
           threads, not 128);
  norank   intra_groups counts no rank (every key to slot 0);
  threads512  intra_groups in blocks of 512 threads;
  tri_noanchor  tri_gather without the anchor's second gather round
           (uv_ref and anchor_sigma2 written from the anchor's index);
  tri_nostore  tri_gather without the (M, C) outputs' gathers and stores.
PR 25's design (markers "GATE_RPT", "GROUP_SLICE", "GATHER_WARPS":
tri_gather with a lane per ray, the count and anchor by ballots, the
anchor's values by shuffles):
  the variants of PR 23's design but tri_noanchor (no second round left),
           tri_gather's stamps now: start, the group's rays counted, the
           rays' gathers and stores issued, the group outputs;
  tri_nostore  tri_gather without the (M, C) stores (its gathers stay:
           the anchor's values come from them).
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
SOURCE = "mcslam_tpu_torch/csrc/intra_glue.cu"
NSTAMPS = 16
KERNELS = ("intra_gate", "intra_groups", "tri_gather")

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
extern "C" int mc_glue_stamps(unsigned long long* host, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));
  if (e != cudaSuccess || !reset) return static_cast<int>(e);
  unsigned long long init[16];
  for (int k = 0; k < 16; ++k) init[k] = (k == 0 || k == 8) ? ~0ull : 0ull;
  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, init, sizeof(init)));
}
"""
NS_TOP = "namespace {\n"
ENTRY = 'extern "C" int mc_intra_gate('
SYNC = "  __syncthreads();\n"


def t0(k):
    """A stamp by thread 0 of the block."""
    return f"  if (threadIdx.x == 0) stamp({k});\n"


def w0(k, *regs):
    """A stamp by lane 0 of each warp still running, once the registers
    `regs` ("f" or "r" constraint, expression) hold their values."""
    need = ", ".join(f'"{c}"({x})' for c, x in regs)
    wait = f'  asm volatile("" :: {need});\n' if regs else ""
    return wait + f"  if ((threadIdx.x & 31) == 0) stamp({k});\n"


STAMP_COMMON = [(NS_TOP, NS_TOP + STAMP_DEFS, 1),
                (ENTRY, STAMP_GETTER + ENTRY, 1)]

# -- PR 22's design: 16 rows a gate block, one groups block -----------------
E_GATE_START = "  const int p = blockIdx.y, tid = threadIdx.x;\n"
E_GATE_PRO = ("      pre[q] = b0[q] * b0[q] + b1[q] * b1[q];\n    }\n")
E_GATE_ROWS = ("          row[q] = (uint8_t)((word >> (8 * q)) & 1u);\n"
               "      }\n    }\n")
E_GROUPS_START = "  const int K = C * N, T = blockDim.x, tid = threadIdx.x;\n"
E_GROUPS_FILL = ("  for (int t = tid; t < C * K; t += T) table[t] = -1;\n"
                 "  __syncthreads();\n")
E_GROUPS_HOPS = "    roots[f] = x;\n  }\n  __syncthreads();\n"
E_GROUPS_ATOM = "    flag[f] = (r == f) && v;\n  }\n  __syncthreads();\n"
E_GROUPS_KEYS = "      keys[r] = ~0ull;\n    }\n  }\n  __syncthreads();\n"
E_GROUPS_SORT = "      __syncthreads();\n    }\n  }\n"
E_GROUPS_END = ("      out_valid[m] = false;\n    }\n  }\n}\n")
E_DIV = "__fdiv_rn(t * t, den) < thr2"
EARLIER = {
    "full": [],
    "stamps": STAMP_COMMON + [
        (E_GATE_START, E_GATE_START + t0(0), 1),
        (E_GATE_PRO, E_GATE_PRO + w0(1), 1),
        (E_GATE_ROWS, E_GATE_ROWS + w0(2), 1),
        (E_GROUPS_START, E_GROUPS_START + t0(8), 1),
        (E_GROUPS_FILL, E_GROUPS_FILL + t0(9), 1),
        (E_GROUPS_HOPS, E_GROUPS_HOPS + t0(10), 1),
        (E_GROUPS_ATOM, E_GROUPS_ATOM + t0(11), 1),
        (E_GROUPS_KEYS, E_GROUPS_KEYS + t0(12), 1),
        (E_GROUPS_SORT, E_GROUPS_SORT + t0(13), 1),
        (E_GROUPS_END, "      out_valid[m] = false;\n    }\n  }\n" + SYNC
         + t0(14) + "}\n", 1)],
    "nodiv": [(E_DIV, "t * t < thr2 * den", 1)],
    "nosort": [("for (int size = 2; size <= Kp; size <<= 1)",
                "for (int size = 2 * Kp; size <= Kp; size <<= 1)", 1)],
}
EARLIER_PHASES = {
    "intra_gate": (("start -> the column prologue (latest warp)", 0, 1),
                   ("-> the row loop and its stores", 1, 2),
                   ("start -> end", 0, 2)),
    "intra_groups": (("start -> parents loaded, global table filled", 8, 9),
                     ("-> the 8 hops", 9, 10),
                     ("-> atomicMax into global memory", 10, 11),
                     ("-> the keys (__ldcg)", 11, 12),
                     ("-> the bitonic stages", 12, 13),
                     ("-> the outputs", 13, 14),
                     ("start -> end", 8, 14)),
}

# -- PR 23's design: gate tiles of 32 x 96, groups by slices ----------------
C_GATE_START = "  const int p = blockIdx.z, tid = threadIdx.x;\n"
C_GATE_PRO = "  __syncthreads();  // the block's column and row terms made\n"
C_GATE_END = "  // end of the gate block\n"
C_DECIDE = "      const bool below = a < tlo * d, above = a >= thi * d;\n"
C_STORE = "    if (words) {\n      *reinterpret_cast<uint32_t*>(row) = word;"
C_GROUPS_START = ("  const int K = C * N, T = GROUP_THREADS, tid = "
                  "threadIdx.x;\n")
C_LOADED = "  __syncthreads();  // the parents loaded\n"
C_ROOTS = "  __syncthreads();  // the roots made\n"
C_MASKS = "  __syncthreads();  // the masks and the slice's ray table made\n"
C_KEYS = "  __syncthreads();  // the keys made\n"
C_RANKED = "  __syncthreads();  // the partial ranks counted\n"
C_SLOTS = "  __syncthreads();  // the slice's slots known\n"
C_GROUPS_END = "  // end of the groups block\n"
C_RANK = ("  part[warp * GROUP_SLICE + lane] =\n      j1 <= s0 ")
# tri_gather as PR 22 wrote it (a thread per group)
B_TRI_START = "  const int m = blockIdx.x * GATHER_THREADS + threadIdx.x;\n"
B_TRI_COUNT = "      if (anchor < 0) anchor = c;\n    }\n  }\n"
B_TRI_RAYS = "    mask[m * C + c] = idx >= 0 && multi;\n  }\n"
B_TRI_ANCHOR = "  anchor_sigma2[m] = sigma2[kp];\n"
B_TRI_END = "  multi_valid[m] = multi && gvalid[m];\n}\n"
B_TRI_KP = "  const int kp = a * N + clampi(row[a], 0, N - 1);\n"
B_TRI_REF = ("  uv_ref[2 * m] = xy[2 * kp];\n  uv_ref[2 * m + 1] = xy[2 * kp + 1];\n"
             "  anchor_sigma2[m] = sigma2[kp];\n")
B_TRI_STORES = ("    uv[2 * (m * C + c)] = xy[2 * kp];\n"
                "    uv[2 * (m * C + c) + 1] = xy[2 * kp + 1];\n"
                "    sigma[m * C + c] = __fsqrt_rn(sigma2[kp]);\n"
                "    mask[m * C + c] = idx >= 0 && multi;\n")
B_TRI_STAMPS = [
    (B_TRI_START, B_TRI_START + t0(0), 1),
    (B_TRI_COUNT, B_TRI_COUNT + w0(1, ("r", "n"), ("r", "anchor")), 1),
    (B_TRI_RAYS, B_TRI_RAYS + w0(2), 1),
    (B_TRI_ANCHOR, B_TRI_ANCHOR + w0(3), 1),
    (B_TRI_END, B_TRI_END[:-2] + w0(4) + "}\n", 1)]
TRI_PHASES = (("start -> the group's row counted (latest warp)", 0, 1),
              ("-> the rays' gathers and stores issued", 1, 2),
              ("-> the anchor's gather round and stores", 2, 3),
              ("-> the group outputs issued", 3, 4),
              ("start -> end", 0, 4))
GATE_GROUPS_STAMPS = STAMP_COMMON + [
        (C_GATE_START, C_GATE_START + t0(0), 1),
        (C_GATE_PRO, C_GATE_PRO + t0(1), 1),
        (C_GATE_END, w0(2), 1),
        (C_GROUPS_START, C_GROUPS_START + t0(8), 1),
        (C_LOADED, C_LOADED + t0(9), 1),
        (C_ROOTS, C_ROOTS + t0(10), 1),
        (C_MASKS, C_MASKS + t0(11), 1),
        (C_KEYS, C_KEYS + t0(12), 1),
        (C_RANKED, C_RANKED + t0(13), 1),
        (C_SLOTS, C_SLOTS + t0(14), 1),
        (C_GROUPS_END, SYNC + t0(15), 1)]
CURRENT = {
    "full": [],
    "stamps": GATE_GROUPS_STAMPS + B_TRI_STAMPS,
    "div": [(C_DECIDE, "      const bool below = false, above = false;\n",
             1)],
    "nostore": [(C_STORE, C_STORE.replace("if (words)",
                                          "if (word == (uint32_t)N)"), 1),
                ("    } else {\n      for (int q = 0; q < 4 && col + q < N; "
                 "++q)\n", "    } else if (word == (uint32_t)N) {\n      for "
                 "(int q = 0; q < 4 && col + q < N; ++q)\n", 1)],
    "nocells": [("    const float4 x = s_row[lane + GATE_LANES * s];\n",
                 "    const float4 x = make_float4(0.f, 0.f, 0.f, 0.f);\n"
                 "    if (N > 0) { *reinterpret_cast<uint32_t*>(out + s * "
                 "step) = (uint32_t)s + b0[0]; continue; }\n", 1)],
    "rpt3": [("constexpr int GATE_RPT = 6;", "constexpr int GATE_RPT = 3;",
              1)],
    "lanes32": [("constexpr int GATE_LANES = 16;",
                 "constexpr int GATE_LANES = 32;", 1)],
    "lanes8": [("constexpr int GATE_LANES = 16;",
                "constexpr int GATE_LANES = 8;", 1)],
    "rpt8": [("constexpr int GATE_RPT = 6;", "constexpr int GATE_RPT = 8;",
              1)],
    "norank": [(C_RANK, "  part[warp * GROUP_SLICE + lane] = 0 * (int)bi "
                "+ 0 * j1;\n  if (0) part[0] =\n      j1 <= s0 ", 1)],
    "threads512": [("constexpr int GROUP_THREADS = 1024;",
                    "constexpr int GROUP_THREADS = 512;", 1)],
    "tri_noanchor": [(B_TRI_KP, "  const int kp = a;\n", 1),
                     (B_TRI_REF, "  uv_ref[2 * m] = (float)kp;\n"
                      "  uv_ref[2 * m + 1] = (float)kp;\n"
                      "  anchor_sigma2[m] = (float)kp;\n", 1)],
    "tri_nostore": [(B_TRI_STORES, "    if (M < 0) {\n" + B_TRI_STORES
                     + "    }\n", 1)],
}
CURRENT_PHASES = {
    "intra_gate": (("start -> the block's column and row terms", 0, 1),
                   ("-> the cells and their stores (latest warp)", 1, 2),
                   ("start -> end", 0, 2)),
    "intra_groups": (("start -> parents loaded", 8, 9),
                     ("-> the roots (8 hops)", 9, 10),
                     ("-> masks and the slice's ray table", 10, 11),
                     ("-> the keys", 11, 12),
                     ("-> the partial ranks", 12, 13),
                     ("-> their sum", 13, 14),
                     ("-> the outputs and the padding", 14, 15),
                     ("start -> end", 8, 15)),
    "tri_gather": TRI_PHASES,
}

# -- PR 25's design: tri_gather with a lane per ray ---------------------------
N_TRI_START = "  // the gather block starts\n"
N_TRI_COUNT = "  // the group's rays counted\n"
N_TRI_STORES = "  // the rays' stores issued\n"
N_TRI_END = "  // the gather block ends\n"
N_TRI_RAY_STORES = ("      reinterpret_cast<float2*>(uv)[t] = make_float2(x, y);\n"
                    "      sigma[t] = __fsqrt_rn(s2);\n"
                    "      mask[t] = idx >= 0 && multi;\n")
NEWEST = {k: v for k, v in CURRENT.items() if not k.startswith("tri_")}
NEWEST.update({
    "stamps": GATE_GROUPS_STAMPS + [
        (N_TRI_START, N_TRI_START + t0(0), 1),
        (N_TRI_COUNT, N_TRI_COUNT + w0(1, ("r", "n"), ("r", "a")), 1),
        (N_TRI_STORES, N_TRI_STORES + w0(2), 1),
        (N_TRI_END, N_TRI_END + w0(3), 1)],
    "tri_nostore": [(N_TRI_RAY_STORES, "      if (M < 0) {\n"
                     + N_TRI_RAY_STORES + "      }\n", 1)]})
NEWEST_PHASES = dict(CURRENT_PHASES, tri_gather=(
    ("start -> the group's rays counted (latest warp)", 0, 1),
    ("-> the rays' gathers and stores issued", 1, 2),
    ("-> the group outputs issued", 2, 3),
    ("start -> end", 0, 3)))
# (markers, edits, stamp phases, name), the newest design first: a source
# holds the first design whose markers it holds all
DESIGNS = [(("GATE_RPT", "GROUP_SLICE", "GATHER_WARPS"), NEWEST,
            NEWEST_PHASES, "PR 25's"),
           (("GATE_RPT", "GROUP_SLICE"), CURRENT, CURRENT_PHASES, "PR 23's"),
           (("GATE_ROWS = 16;", "int* __restrict__ table,"), EARLIER,
            EARLIER_PHASES, "PR 22's")]
# variants that concern one kernel only
ONLY = {"nodiv": "intra_gate", "nosort": "intra_groups",
        "div": "intra_gate", "nostore": "intra_gate", "rpt3": "intra_gate",
        "nocells": "intra_gate", "lanes32": "intra_gate",
        "lanes8": "intra_gate", "rpt8": "intra_gate",
        "norank": "intra_groups", "threads512": "intra_groups",
        "tri_noanchor": "tri_gather", "tri_nostore": "tri_gather"}
P, I = ctypes.c_void_p, ctypes.c_int
# the C entries' types by design: PR 22's groups take a global scratch
ENTRY_TYPES = {"mc_intra_gate": [P] * 5 + [I, I, P],
               "mc_intra_groups": [P] * 7 + [I] * 3 + [P],
               "mc_tri_gather": [P] * 12 + [I] * 3 + [P]}
SCRATCH_DESIGN = "PR 22's"


def design(src: str):
    for d in DESIGNS:
        if all(m in src for m in d[0]):
            return d
    raise RuntimeError("intra_glue_variants: no known design in the source")


def variant_source(src: str, name: str) -> str:
    for anchor, new, count in design(src)[1][name]:
        if src.count(anchor) != count:
            raise RuntimeError(
                f"intra_glue_variants: the anchor of {name} occurs "
                f"{src.count(anchor)} times (not {count}): {anchor!r}")
        src = src.replace(anchor, new)
    return src


def read_earlier(spec: str) -> str:
    path = pathlib.Path(spec)
    if path.exists():
        return path.read_text()
    return subprocess.run(["git", "show", f"{spec}:{SOURCE}"], cwd=ROOT,
                          check=True, capture_output=True,
                          text=True).stdout


def build_all(sources: dict, jobs) -> dict:
    """{(tag, variant): ctypes library}, one nvcc per variant, started
    together; the ptxas report of each printed."""
    from mcslam_tpu_torch import _build

    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for tag, name in jobs:
        stem = f"intra_glue_{tag}_{name}"
        cu = OUT / f"{stem}.cu"
        cu.write_text(variant_source(sources[tag], name))
        cmd = [nvcc, *_build.ARCH_FLAGS, *_build.NVCC_FLAGS,
               *_build.SOURCE_FLAGS["intra_glue"], "-Xptxas", "-v",
               "-shared", "-o", str(OUT / f"{stem}.so"), str(cu)]
        procs[(tag, name)] = (stem, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (tag, name), (stem, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {tag} {name}:\n{log}")
        for entry in re.findall(r"Compiling entry function '([^']+)'.*?"
                                r"(\d+ bytes stack frame, \d+ bytes spill "
                                r"stores).*?Used (\d+) registers([^\n]*)",
                                log, re.S):
            if any(k in entry[0] for k in KERNELS):
                print(f"# build {tag} {name}: {entry[0][:40]}: {entry[2]} "
                      f"registers{entry[3]}, {entry[1]}", flush=True)
        lib = ctypes.CDLL(str(OUT / f"{stem}.so"))
        entries = dict(ENTRY_TYPES)
        if design(sources[tag])[3] == SCRATCH_DESIGN:
            entries["mc_intra_groups"] = [P] * 8 + [I] * 3 + [P]
        for fn, types in entries.items():
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = ctypes.c_int
        libs[(tag, name)] = lib
    return libs


def caller(lib, scratch_design, kernel, a):
    """A call of the C entry on the recorded args (intra_groups with PR
    22's global scratch where scratch_design)."""
    import torch

    from mcslam_tpu_torch import _build

    if kernel == "tri_gather":
        ray_idx, gvalid, xy, sigma2 = a
        M, C = ray_idx.shape
        N, dev, f32 = xy.shape[1], ray_idx.device, torch.float32
        outs = (torch.empty(M, C, 2, dtype=f32, device=dev),
                torch.empty(M, C, dtype=f32, device=dev),
                torch.empty(M, C, dtype=torch.bool, device=dev),
                torch.empty(M, dtype=torch.int32, device=dev),
                torch.empty(M, 2, dtype=f32, device=dev),
                torch.empty(M, dtype=f32, device=dev),
                torch.empty(M, dtype=torch.int32, device=dev),
                torch.empty(M, dtype=torch.bool, device=dev))

        def call():
            _build.check(lib.mc_tri_gather(
                ray_idx.data_ptr(), gvalid.data_ptr(), xy.data_ptr(),
                sigma2.data_ptr(), *(o.data_ptr() for o in outs), M, C, N,
                _build.stream_ptr(dev)), "mc_tri_gather")
            return outs
        return call
    if kernel == "intra_gate":
        xy, f, E, thr2 = a
        C, N = xy.shape[:2]
        P = C * (C - 1) // 2

        def call():
            gate = torch.empty(P, N, N, dtype=torch.bool, device=xy.device)
            _build.check(lib.mc_intra_gate(
                xy.data_ptr(), f.data_ptr(), E.data_ptr(), thr2.data_ptr(),
                gate.data_ptr(), C, N, _build.stream_ptr(xy.device)),
                "mc_intra_gate")
            return gate
        return call
    parent, valid, response, desc, max_out = a
    C, N = valid.shape
    dev = valid.device
    # PR 22's ray table, a global scratch of C x C N ints
    scratch = ([torch.empty(C * C * N, dtype=torch.int32, device=dev)]
               if scratch_design else [])

    def call():
        outs = (torch.empty(max_out, C, dtype=torch.int32, device=dev),
                torch.empty(max_out, 8, dtype=torch.int32, device=dev),
                torch.empty(max_out, dtype=torch.bool, device=dev))
        _build.check(lib.mc_intra_groups(
            parent.data_ptr(), valid.data_ptr(), response.data_ptr(),
            desc.data_ptr(), *(x.data_ptr() for x in scratch),
            *(o.data_ptr() for o in outs), C, N,
            int(max_out), _build.stream_ptr(dev)), "mc_intra_groups")
        return outs
    return call


def stamp_split(label, lib, call, phases, smi, reps=20) -> None:
    import numpy as np
    import torch

    lib.mc_glue_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mc_glue_stamps.restype = ctypes.c_int
    host = (ctypes.c_ulonglong * NSTAMPS)()
    rows = []
    for _ in range(reps + 2):
        torch.cuda.synchronize()
        assert lib.mc_glue_stamps(host, 1) == 0
        call()
        torch.cuda.synchronize()
        assert lib.mc_glue_stamps(host, 0) == 0
        t = [int(x) for x in host]
        rows.append([t[b] - t[a] for _, a, b in phases])
    m = np.mean(np.array(rows[2:], dtype=np.float64), axis=0) / 1e3
    print(f"# {label} stamps (us, mean of {reps} calls, %globaltimer; "
          f"{smi}): " + "; ".join(f"{name} {v:.2f}"
                                  for (name, _, _), v in zip(phases, m)),
          flush=True)


def priorities(parent, valid, response):
    """The groups' C N priorities, as intra_groups_reference makes them."""
    import torch

    C, N = valid.shape
    fp = parent.reshape(C * N).long()
    for _ in range(3):
        fp = fp[fp]
    fv = valid.reshape(C * N)
    is_root = (fp == torch.arange(C * N, device=fp.device)) & fv
    feat = torch.arange(N, device=fp.device)[None, :].expand(C, N)
    ray = torch.full((C, C * N), -1, dtype=torch.int64, device=fp.device)
    ray = ray.scatter_reduce(1, fp.reshape(C, N), torch.where(valid, feat, -1),
                             reduce="amax")
    n_rays = torch.sum(ray >= 0, dim=0)
    return torch.where(is_root,
                       n_rays.to(torch.float32) * 1e3 + response.reshape(-1),
                       torch.full((C * N,), -1.0, device=fp.device))


def wrapper_ms(fn, a, reps=20) -> float:
    import torch

    for _ in range(3):
        fn(*a)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn(*a)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def eight_outputs(M, C, dev):
    """tri_gather's outputs by one torch.empty each."""
    import torch

    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    return (torch.empty(M, C, 2, dtype=f32, device=dev),
            torch.empty(M, C, dtype=f32, device=dev),
            torch.empty(M, C, dtype=b8, device=dev),
            torch.empty(M, dtype=i32, device=dev),
            torch.empty(M, 2, dtype=f32, device=dev),
            torch.empty(M, dtype=f32, device=dev),
            torch.empty(M, dtype=i32, device=dev),
            torch.empty(M, dtype=b8, device=dev))


def carved_split(a, rounds, smi, reps=200):
    """tri_gather's wrapper with its outputs carved from one buffer
    against the same wrapper allocating them one by one (CUDA events),
    and the two allocations alone (host clock), in turns."""
    import time

    import numpy as np

    from mcslam_tpu_torch.frontend import intra_cuda

    carve = intra_cuda.tri_gather_outputs
    M, C = a[0].shape
    dev = a[0].device
    wrap = {"carved": [], "eight torch.empty": []}
    host = {"carved": [], "eight torch.empty": []}
    alloc = {"carved": lambda: carve(M, C, dev),
             "eight torch.empty": lambda: eight_outputs(M, C, dev)}
    try:
        for r in range(rounds):
            for k in (list(wrap) if r % 2 == 0 else list(wrap)[::-1]):
                intra_cuda.tri_gather_outputs = (
                    carve if k == "carved" else eight_outputs)
                wrap[k].append(wrapper_ms(intra_cuda.tri_gather, a))
                for _ in range(20):
                    alloc[k]()
                t = time.perf_counter()
                for _ in range(reps):
                    alloc[k]()
                host[k].append((time.perf_counter() - t) / reps * 1e6)
    finally:
        intra_cuda.tri_gather_outputs = carve
    for k in wrap:
        print(f"# tri_gather wrapper, outputs {k}: "
              f"{float(np.median(wrap[k])):.4f} ms per call by CUDA events "
              f"(median of {rounds} rounds of 20: "
              f"{', '.join(f'{x:.4f}' for x in wrap[k])}); the allocation "
              f"alone {float(np.median(host[k])):.2f} us per call on the "
              f"host (median of {rounds} rounds of {reps}: "
              f"{', '.join(f'{x:.2f}' for x in host[k])}) ({smi})",
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--earlier", default=None,
                    help="an earlier intra_glue.cu, or a git revision")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--only", nargs="*", default=None,
                    help="source:variant pairs (sources earlier, current)")
    ap.add_argument("--kernels", nargs="*", default=list(KERNELS),
                    choices=KERNELS, help="the kernels to split and time")
    opt = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from mcslam_tpu_torch.frontend import frame, intra_cuda

    if not torch.cuda.is_available():
        print("intra_glue_variants: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    sources = {"current": (CSRC / "intra_glue.cu").read_text()}
    if opt.earlier:
        sources["earlier"] = read_earlier(opt.earlier)
    jobs = []
    for tag, src in sources.items():
        d = design(src)
        print(f"# {tag} source: the {d[3]} design ({d[0]})", flush=True)
        jobs += [(tag, v) for v in d[1]
                 if (opt.only is None or f"{tag}:{v}" in opt.only)
                 and ONLY.get(v, opt.kernels[0]) in opt.kernels]
    libs = build_all(sources, jobs)
    scene = cs.Scene(dev, frames=1)
    seen = cs.capture_calls(lambda: frame.build_frame(
        scene.imgs[0], scene.rig, **scene.frame_kwargs()),
        {n: (intra_cuda, n) for n in KERNELS})
    bad = 0
    for kernel in opt.kernels:
        a, kw = seen[kernel]
        a = (*a, *kw.values())  # intra_match passes max_out by position
        ref = getattr(intra_cuda, f"{kernel}_reference")(*a)
        ref = ref if isinstance(ref, tuple) else (ref,)
        calls = {(t, v): caller(libs[(t, v)],
                                design(sources[t])[3] == SCRATCH_DESIGN,
                                kernel, a)
                 for t, v in jobs if ONLY.get(v, kernel) == kernel}
        if kernel == "intra_gate":
            label = f"{kernel} C={a[0].shape[0]} N={a[0].shape[1]}"
        elif kernel == "intra_groups":
            label = (f"{kernel} C={a[1].shape[0]} N={a[1].shape[1]} "
                     f"max_out={a[4]}")
        else:
            label = (f"{kernel} C={a[0].shape[1]} M={a[0].shape[0]} "
                     f"N={a[2].shape[1]}")
        for (t, v), call in calls.items():
            if v != "full":
                continue
            out = call()
            out = out if isinstance(out, tuple) else (out,)
            torch.cuda.synchronize()
            same = len(out) == len(ref) and all(
                o.dtype == r.dtype and torch.equal(o, r)
                for o, r in zip(out, ref))
            bad += not same
            print(f"# {label} {t} full: "
                  f"{'equal to' if same else 'DIFFERS from'} the plain "
                  f"version bit for bit", flush=True)
        for (t, v), call in calls.items():
            if v == "stamps":
                stamp_split(f"{label} {t}", libs[(t, v)], call,
                            design(sources[t])[2][kernel], smi)
        names = [tv for tv in calls if tv[1] != "stamps"]
        times = {tv: [] for tv in names}
        for r in range(opt.rounds):
            for tv in (names if r % 2 == 0 else names[::-1]):
                ms, ops, _ = cs.device_profile(calls[tv], reps=20)
                times[tv].append((ms, ops))
        for t, v in names:
            ms = [x for x, _ in times[(t, v)]]
            print(f"# {label} {t} variant {v}: {float(np.median(ms)):.5f} ms "
                  f"device time per call, {times[(t, v)][0][1]:.0f} device "
                  f"ops (median of {opt.rounds} rounds: "
                  f"{', '.join(f'{x:.5f}' for x in ms)}) ({smi})", flush=True)
        if kernel == "intra_groups":
            prio = priorities(*a[:3])
            ms, ops, _ = cs.device_profile(
                lambda: torch.sort(prio, stable=True, descending=True),
                reps=20)
            print(f"# {label} yardstick torch.sort(stable, descending) of "
                  f"the {prio.numel()} priorities: {ms:.4f} ms device time "
                  f"per call, {ops:.0f} device ops ({smi})", flush=True)
        wms = [wrapper_ms(getattr(intra_cuda, kernel), a)
               for _ in range(opt.rounds)]
        print(f"# {label} wrapper intra_cuda.{kernel}: "
              f"{float(np.median(wms)):.4f} ms per call by CUDA events "
              f"(median of {opt.rounds} rounds of 20: "
              f"{', '.join(f'{x:.4f}' for x in wms)}) ({smi})", flush=True)
        if kernel == "tri_gather" and hasattr(intra_cuda, "tri_gather_outputs"):
            carved_split(a, opt.rounds, smi)
    print(f"# intra_glue_variants: "
          f"{'every full variant equals the plain version' if not bad else f'{bad} full variants differ'}",
          flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    # flushed, then os._exit: after torch.profiler's CUDA traces the
    # interpreter's native finalization can hang (scripts/orb_variants.py)
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
