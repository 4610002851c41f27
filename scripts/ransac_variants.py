#!/usr/bin/env python3
"""Split the time of the RANSAC kernels ransac_score, pnp_hyp and
kabsch_hyp (csrc/ransac_score.cu, csrc/pnp_hyp.cu, csrc/kabsch_hyp.cu)
on one CUDA card by %globaltimer stamps and by variants of their
sources, and time an earlier design of the sources against the current
one in turns.

    git archive <commit> mcslam_tpu_torch/csrc | tar -x -C mcslam_tpu_torch/_build/earlier
    python3 scripts/ransac_variants.py [--rounds 3] [--only KERNEL:VARIANT ...]
        [--kernels NAME ...] [--csrc DIR]
        [--earlier mcslam_tpu_torch/_build/earlier/mcslam_tpu_torch/csrc]

Run from the repository's root. Builds each source as it stands (or as it
stands in DIR, e.g. the csrc/ of a `git archive` of an earlier commit),
and with --earlier also the sources of that directory, each with the
edits of each variant below (one nvcc per variant, all started together,
into mcslam_tpu_torch/_build/variants/; only the kernels named by
--kernels, all three by default), prints each build's registers, shared
memory and spills, and at the calls that bench frame 1's step with its
portfolio forced makes (chip_smoke.portfolio_calls: the score at K = 1,
512, 256 and 3 over M = 2048 correspondences, pnp_hyp at K = 256,
kabsch_hyp at K = 512) checks each source's full variant against its
plain version under chip_smoke's criteria (check_score,
check_hypotheses) and, with --earlier, the current kabsch_hyp against
the earlier one bit for bit, then prints:
- the stamps variant's phases per call (the earliest start and the
  latest end of each phase over the blocks, or the warps of pnp_hyp and
  kabsch_hyp, stamped right after a barrier or once the phase's values
  are in registers; mean over 20 calls);
- each variant's device time per call (the variants of a kernel, of both
  sources, taking turns within each round, reversed every other round;
  20 calls a round, median over the rounds);
- for kabsch_hyp, the Newton steps each hypothesis takes to its first
  bitwise fixed point (geometry/alignment's arithmetic on the CPU).
The edits are keyed by the design the source holds (its marker line),
so the probe splits the design before a redesign and the one after it;
each design binds its own C entry. The variants' outputs are not the
function's, except full's. The anchors are exact source lines; an edit
whose anchor is not found as often as listed fails the run. Needs one
CUDA card.

ransac_score, the design of 4 hypotheses a block (marker "HB = 4;"):
  full     the source as it stands;
  stamps   start, poses inverted, the walk over M, the counts reduced
           and the arrival, the last block's argmax, its second walk;
  nowalk   no walk over M (every count 0);
  nowalk2  the last block writes no inlier mask (no second walk);
  notail   the last block puts the counter back and returns.
ransac_score, the design of tiles and bit rows (marker "HT_MAX"):
  full     the source as it stands;
  stamps   start, the tile staged and the poses inverted, the walk
           (ballots, bit rows and count atomics), the arrival, the last
           block's counts and argmax, the mask's expansion;
  nomask   the last block writes no inlier mask;
  notail   the last block resets the counters and returns;
  nodiv    the projection multiplies by z where it divides (the two
           divisions' share of the walk);
  norows   no bit-row words and no count atomics (their share);
  blocks512, blocks2048  the plan aims at 512 or 2048 blocks, not 1024
           (larger K: more or fewer hypotheses a tile).
pnp_hyp, the design of a warp per hypothesis with solves by division
(marker "chol_solve"):
  full     the source as it stands;
  stamps   per warp: start, the lever scan, A, G, the factor, the 5
           solves of v, the 5 of w, the pose;
  nolever  no lever scan (the flag set: the bench rig has lever arms);
  nosolve  no inverse-iteration steps.
pnp_hyp, the design of registers and reciprocal pivots (marker
"solve_recip"):
  full, stamps (the same phases, the lever flag from the samples first),
  nolever, nosolve as above.
kabsch_hyp, the design of a thread per hypothesis (marker "mul4("):
  full     the source as it stands;
  stamps   per warp: start, the samples in, B and the Davenport matrix,
           a3..a0, the 12 Newton steps, the 16 cofactors, the stores;
  newton0  no Newton steps;
  newton_exit  each thread stops at lambda's first bitwise fixed point.
kabsch_hyp, the design of a quad of lanes per hypothesis (marker
"KH_LANES"):
  full, stamps (the same phases) as above;
  vote     Newton stops once every hypothesis of the warp is at its
           fixed point (a vote each step);
  allloads every lane of a quad loads the three samples (no shuffles;
           not lane j < 3 loading sample j);
  threads32, threads128  32 or 128 threads a block (not 64).
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
KERNELS = ("ransac_score", "pnp_hyp", "kabsch_hyp")

STAMP_DEFS = """
__device__ unsigned long long g_stamps[16];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void stamp(int k) {
  if (k == 0) atomicMin(&g_stamps[k], gtime());
  else atomicMax(&g_stamps[k], gtime());
}
"""
STAMP_GETTER = """
extern "C" int mc_ransac_stamps(unsigned long long* host, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));
  if (e != cudaSuccess || !reset) return static_cast<int>(e);
  unsigned long long init[16] = {~0ull};
  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, init, sizeof(init)));
}
"""
NS_TOP = "namespace {\n"


def t0(k):
    """A stamp by thread 0 of the block."""
    return f"  if (threadIdx.x == 0) stamp({k});\n"


def w0(k, indent="  ", regs=()):
    """A stamp by lane 0 of each warp, once the registers `regs` ("f" or
    "r" constraint, expression) hold their values."""
    need = ", ".join(f'"{c}"({x})' for c, x in regs)
    wait = f'{indent}asm volatile("" :: {need});\n' if regs else ""
    return wait + f"{indent}if ((threadIdx.x & 31) == 0) stamp({k});\n"


# -- ransac_score, 4 hypotheses a block (the first design) -------------------
HB_K0 = "  const int k0 = blockIdx.x * HB;\n"
HB_INV = ("  if (tid < HB && k0 + tid < K) invert(hyp + 16 * (k0 + tid), "
           "s_pose[tid]);\n  __syncthreads();\n")
HB_WALKED = ("#pragma unroll\n  for (int h = 0; h < HB; ++h) {\n"
              "    const int c = __reduce_add_sync")
HB_ARRIVED = ("  if (tid == 0) s_last = add_acq_rel(counter) == gridDim.x - "
               "1;\n  __syncthreads();\n")
HB_ARGMAX = "    s_key[0] = b;\n    *counter = 0;\n  }\n  __syncthreads();\n"
HB_WALK2 = ("  for (int m = tid; m < M; m += THREADS)\n    best_inl[m] = "
             "inlier(s_pose[0], load_obs(X, uv, cTr, f, mask, m), px2);\n")
HB_WALK = ("  for (int m = tid; m < M; m += THREADS) {\n    const Obs o = "
            "load_obs(X, uv, cTr, f, mask, m);\n")
HB_LAST = "  if (!s_last) return;\n"
ENTRY_SCORE = 'extern "C" int mc_ransac_score('
SCORE_HB4 = {
    "full": [],
    "stamps": [
        (NS_TOP, NS_TOP + STAMP_DEFS, 1),
        (HB_K0, HB_K0 + t0(0), 1),
        (HB_INV, HB_INV + t0(1), 1),
        (HB_WALKED, "  __syncthreads();\n" + t0(2) + HB_WALKED, 1),
        (HB_ARRIVED, HB_ARRIVED + t0(3), 1),
        (HB_ARGMAX, HB_ARGMAX + t0(4), 1),
        (HB_WALK2, HB_WALK2 + "  __syncthreads();\n" + t0(5), 1),
        (ENTRY_SCORE, STAMP_GETTER + ENTRY_SCORE, 1)],
    "nowalk": [(HB_WALK, HB_WALK.replace("m < M", "m < 0"), 1)],
    "nowalk2": [(HB_WALK2, "", 1)],
    "notail": [(HB_LAST, "  if (s_last && tid == 0) *counter = 0;\n"
                "  return;\n", 1)],
}
SCORE_HB4_PHASES = (("start -> poses inverted", 0, 1),
                  ("-> walk over M done (latest block)", 1, 2),
                  ("-> counts reduced, last arrival", 2, 3),
                  ("-> the last block's argmax", 3, 4),
                  ("-> its second walk (the mask)", 4, 5),
                  ("start -> end", 0, 5))

# -- ransac_score, tiles and bit rows -----------------------------------------
TL_START = ("  const int tid = threadIdx.x, lane = tid & 31, "
             "warp = tid >> 5;\n")
TL_STAGED = "  __syncthreads();  // the tile and the poses staged\n"
TL_WALKED = "  __syncthreads();  // the block's rows and counts issued\n"
TL_ARRIVED = "  if (!s_last) return;\n"
TL_ARGMAX = "  __syncthreads();  // the winner known\n"
TL_MASK = "  for (int q = tid; 16 * q < M; q += THREADS) {\n"
TL_END = "  // end of the last block\n"
TL_TARGET = "constexpr int TARGET_BLOCKS = 1024;"
TL_ROWS = ("      rows[static_cast<long long>(k) * W + word] = mine;\n"
            "      if (mine) atomicAdd(acc + k, __popc(mine));\n")
SCORE_TILES = {
    "full": [],
    "stamps": [
        (NS_TOP, NS_TOP + STAMP_DEFS, 1),
        (TL_START, TL_START + t0(0), 1),
        (TL_STAGED, TL_STAGED + t0(1), 1),
        (TL_WALKED, TL_WALKED + t0(2), 1),
        (TL_ARRIVED, TL_ARRIVED + t0(3), 1),
        (TL_ARGMAX, TL_ARGMAX + t0(4), 1),
        (TL_END, "  __syncthreads();\n" + t0(5), 1),
        (ENTRY_SCORE, STAMP_GETTER + ENTRY_SCORE, 1)],
    "nomask": [(TL_MASK, TL_MASK.replace("q < M", "q < 0"), 1)],
    "nodiv": [("__fdiv_rn(pc[0], zs)", "__fmul_rn(pc[0], zs)", 1),
              ("__fdiv_rn(pc[1], zs)", "__fmul_rn(pc[1], zs)", 1)],
    "norows": [(TL_ROWS, "      if (mine == 0x12345u) rows[k] = mine;\n", 1)],
    "blocks512": [(TL_TARGET, TL_TARGET.replace("1024", "512"), 1)],
    "blocks2048": [(TL_TARGET, TL_TARGET.replace("1024", "2048"), 1)],
    "notail": [(TL_ARRIVED, "  if (!s_last) return;\n  for (int k = tid; "
                "k <= K; k += THREADS) acc[k] = 0;\n  return;\n", 1)],
}
SCORE_TILES_PHASES = (("start -> tile staged, poses inverted", 0, 1),
                  ("-> walk, bit rows, count atomics (latest block)", 1, 2),
                  ("-> last arrival", 2, 3),
                  ("-> the last block's counts and argmax", 3, 4),
                  ("-> the mask expanded", 4, 5),
                  ("start -> end", 0, 5))

# -- pnp_hyp, a warp per hypothesis, solves by division (the first design) --
DV_START = "  const int lane = tid & 31, warp = tid >> 5;\n"
DV_LEVER = "  const bool noncentral = __syncthreads_or(lever);\n"
DV_SCAN = ("  for (int m = tid; m < M; m += THREADS) {\n    const float t0 = "
            "cTr[16 * m + 3]")
DV_A = "  bad = __any_sync(FULL, bad);\n  __syncwarp();\n"
DV_G = "    L[i * LD + j] = g;\n  }\n  __syncwarp();\n"
DV_FACTOR = ("    if (lane > j && lane < N) L[lane * LD + j] = s / d;\n"
              "    __syncwarp();\n  }\n")
DV_V = ("  for (int it = 0; it < ITERS; ++it) v = normalize(chol_solve(L, v, "
         "N, lane));\n")
DV_W = "    if (!(na > 0.3f)) v = w;\n  }\n"
DV_END = "    T[15] = 1.0f;\n  }\n}\n"
ENTRY_PNP = 'extern "C" int mc_pnp_hyp('
PNP_DIV = {
    "full": [],
    "stamps": [
        (NS_TOP, NS_TOP + STAMP_DEFS, 1),
        (DV_START, DV_START + w0(0), 1),
        (DV_LEVER, DV_LEVER + w0(1), 1),
        (DV_A, DV_A + w0(2), 1),
        (DV_G, DV_G + w0(3), 1),
        (DV_FACTOR, DV_FACTOR + w0(4), 1),
        (DV_V, DV_V + w0(5), 1),
        (DV_W, DV_W + w0(6), 1),
        (DV_END, "    T[15] = 1.0f;\n  }\n" + w0(7) + "}\n", 1),
        (ENTRY_PNP, STAMP_GETTER + ENTRY_PNP, 1)],
    "nolever": [(DV_SCAN, DV_SCAN.replace("m < M", "m < 0"), 1),
                (DV_LEVER, "  const bool noncentral = __syncthreads_or(true);"
                 "\n", 1)],
    "nosolve": [("constexpr int ITERS = 5;\n", "constexpr int ITERS = 0;\n",
                 1)],
}
PNP_PHASES = (("start -> lever flag", 0, 1),
              ("-> rows of A", 1, 2),
              ("-> G", 2, 3),
              ("-> the factor", 3, 4),
              ("-> 5 solve pairs of v", 4, 5),
              ("-> 5 solve pairs of w (generalized form)", 5, 6),
              ("-> the pose stored", 6, 7),
              ("start -> end", 0, 7))

# -- pnp_hyp, registers and reciprocal pivots --------------------------------
RC_START = "  const int lane = threadIdx.x & 31;\n"
RC_LEVER = "  if (k >= K) return;\n"
RC_SCAN = "  if (__syncthreads_or(lever)) return true;\n"
RC_A = "  // end of A\n"
RC_G = "  // end of G\n"
RC_FACTOR = "  // end of the factor\n"
RC_V = "  // end of v's steps\n"
RC_W = "  // end of w's steps\n"
RC_END = "  // end of the pose\n"
PNP_RECIP = {
    "full": [],
    "stamps": [
        (NS_TOP, NS_TOP + STAMP_DEFS, 1),
        (RC_START, RC_START + w0(0), 1),
        (RC_LEVER, w0(1) + RC_LEVER, 1),
        (RC_A, RC_A + w0(2), 1),
        (RC_G, RC_G + w0(3), 1),
        (RC_FACTOR, RC_FACTOR + w0(4), 1),
        (RC_V, RC_V + w0(5), 1),
        (RC_W, RC_W + w0(6), 1),
        (RC_END, RC_END + w0(7), 1),
        (ENTRY_PNP, STAMP_GETTER + ENTRY_PNP, 1)],
    "nolever": [(RC_SCAN, "  return true;\n", 1)],
    "nosolve": [("constexpr int ITERS = 5;\n", "constexpr int ITERS = 0;\n",
                 1)],
}

# -- kabsch_hyp, a thread per hypothesis (the first design) -----------------
KT_START = "  if (k >= K) return;\n  float s[3][3], d[3][3];\n"
KT_SAMPLES = "  float* T = out + 16 * k;\n"
KT_FL = "  // 3. Faddeev-LeVerrier\n"
KT_NEWTON = "  // 4. the largest eigenvalue by Newton from the Frobenius bound\n"
KT_ADJ = "  // 5. the adjugate of K - lambda I: cof[r][c] = (-1)^(r + c) det(minor);\n"
KT_COF = "  float best_norm = 0.0f;\n"
KT_END = "  T[15] = 1.0f;\n}\n\n}  // namespace\n"
KT_LOOP = "  for (int it = 0; it < 12; ++it) {\n"
KT_STEP = "    lam = lam - p / dp;\n  }\n"
ENTRY_KABSCH = 'extern "C" int mc_kabsch_hyp('
KABSCH_THREAD = {
    "full": [],
    "stamps": [
        (NS_TOP, NS_TOP + STAMP_DEFS, 1),
        (KT_START, KT_START.replace("  float s", w0(0) + "  float s"), 1),
        (KT_SAMPLES, w0(1, regs=(("f", "s[0][0]"), ("f", "d[2][2]"),
                                 ("r", "(int)in_range"))) + KT_SAMPLES, 1),
        (KT_FL, w0(2, regs=(("f", "Kd[0][0]"), ("f", "Kd[3][3]"))) + KT_FL,
         1),
        (KT_NEWTON, w0(3, regs=(("f", "a0"),)) + KT_NEWTON, 1),
        (KT_ADJ, w0(4, regs=(("f", "lam"),)) + KT_ADJ, 1),
        (KT_COF, w0(5, regs=(("f", "cof[0][0]"), ("f", "cof[3][3]")))
         + KT_COF, 1),
        (KT_END, "  T[15] = 1.0f;\n" + w0(6) + "}\n\n}  // namespace\n", 1),
        (ENTRY_KABSCH, STAMP_GETTER + ENTRY_KABSCH, 1)],
    "newton0": [(KT_LOOP, KT_LOOP.replace("it < 12", "it < 0"), 1)],
    "newton_exit": [(KT_STEP, "    const float next = lam - p / dp;\n"
                     "    if (__float_as_uint(next) == __float_as_uint(lam)) "
                     "break;\n    lam = next;\n  }\n", 1)],
}
KABSCH_PHASES = (("start -> samples in (latest warp)", 0, 1),
                 ("-> B and the Davenport matrix", 1, 2),
                 ("-> a3..a0 (Faddeev-LeVerrier)", 2, 3),
                 ("-> Newton", 3, 4),
                 ("-> the 16 cofactors", 4, 5),
                 ("-> the quaternion, the pose, the stores", 5, 6),
                 ("start -> end", 0, 6))

# -- kabsch_hyp, a quad of lanes per hypothesis ------------------------------
KQ_START = "  // the hypothesis block starts\n"
KQ_SAMPLES = "  // the samples in\n"
KQ_DAV = "  // B and the Davenport matrix made\n"
KQ_FL = "  // a3..a0 made\n"
KQ_NEWTON = "  // Newton done\n"
KQ_COF = "  // the cofactors made\n"
KQ_END = "  // the hypothesis block ends\n"
KQ_STEP = "    lam = lam - p / dp;\n  }\n  // Newton done\n"
KQ_LOADS = """  // lane j < 3 loads sample j's index and rows, shuffles give the quad
  // the three points
  long long i = 0;
  if (live && j < 3) i = idx[3 * k + j];
  const bool fits = i >= 0 && i < M;
  const long long r = fits ? i : 0;
  float sr[3], dr[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    sr[c] = X_rig[3 * r + c];
    dr[c] = X_world[3 * r + c];
  }
  const unsigned quad = (0xfu << base);
  const bool in_range = (__ballot_sync(FULL, fits) & quad) == quad;
  float s[3][3], d[3][3];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      s[p][c] = __shfl_sync(FULL, sr[c], base + p);
      d[p][c] = __shfl_sync(FULL, dr[c], base + p);
    }
  }
"""
KQ_ALLLOADS = """  // every lane of the quad loads the three samples (the same addresses)
  const int kk = live ? k : 0;
  float s[3][3], d[3][3];
  bool in_range = true;
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const long long i = idx[3 * kk + p];
    in_range = in_range && i >= 0 && i < M;
    const long long r = (i >= 0 && i < M) ? i : 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      s[p][c] = X_rig[3 * r + c];
      d[p][c] = X_world[3 * r + c];
    }
  }
"""
KQ_THREADS = "constexpr int KH_THREADS = 64;"
KABSCH_QUAD = {
    "full": [],
    "stamps": [
        (NS_TOP, NS_TOP + STAMP_DEFS, 1),
        (KQ_START, KQ_START + w0(0), 1),
        (KQ_SAMPLES, KQ_SAMPLES + w0(1, regs=(("f", "s[0][0]"),
                                               ("f", "d[2][2]"))), 1),
        (KQ_DAV, KQ_DAV + w0(2, regs=(("f", "Kd[0][0]"), ("f", "Kd[3][3]"))),
         1),
        (KQ_FL, KQ_FL + w0(3, regs=(("f", "a0"),)), 1),
        (KQ_NEWTON, KQ_NEWTON + w0(4, regs=(("f", "lam"),)), 1),
        (KQ_COF, KQ_COF + w0(5, regs=(("f", "cof[0]"), ("f", "cof[3]"))), 1),
        (KQ_END, KQ_END + w0(6), 1),
        (ENTRY_KABSCH, STAMP_GETTER + ENTRY_KABSCH, 1)],
    "vote": [(KQ_STEP, "    const float next = lam - p / dp;\n"
              "    const bool done = __float_as_uint(next) == "
              "__float_as_uint(lam) || !in_range || !live;\n"
              "    lam = next;\n    if (__all_sync(FULL, done)) break;\n"
              "  }\n  // Newton done\n", 1)],
    "allloads": [(KQ_LOADS, KQ_ALLLOADS, 1)],
    "threads32": [(KQ_THREADS, KQ_THREADS.replace("64", "32"), 1)],
    "threads128": [(KQ_THREADS, KQ_THREADS.replace("64", "128"), 1)],
}

DESIGNS = {
    "ransac_score": [("HB = 4;", SCORE_HB4, SCORE_HB4_PHASES, "hb4"),
                     ("HT_MAX", SCORE_TILES, SCORE_TILES_PHASES, "tiles")],
    "pnp_hyp": [("chol_solve", PNP_DIV, PNP_PHASES, "div"),
                ("solve_recip", PNP_RECIP, PNP_PHASES, "recip")],
    "kabsch_hyp": [("mul4(", KABSCH_THREAD, KABSCH_PHASES, "thread"),
                   ("KH_LANES", KABSCH_QUAD, KABSCH_PHASES, "quad")],
}
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C entries' argument types by design
ENTRY_TYPES = {
    ("ransac_score", "hb4"): [P] * 12 + [I, I, F, P],
    ("ransac_score", "tiles"): [P] * 13 + [I, I, F, P],
    ("pnp_hyp", "div"): [P] * 7 + [I, I, I, P],
    ("pnp_hyp", "recip"): [P] * 7 + [I, I, I, P],
    ("kabsch_hyp", "thread"): [P] * 4 + [I, I, P],
    ("kabsch_hyp", "quad"): [P] * 4 + [I, I, P],
}


def design(csrc: pathlib.Path, kernel: str):
    """(marker, edits, stamp phases, entry tag) of the design that
    csrc/<kernel>.cu holds."""
    src = (csrc / f"{kernel}.cu").read_text()
    for d in DESIGNS[kernel]:
        if d[0] in src:
            return d
    raise RuntimeError(f"ransac_variants: no known design in {kernel}.cu")


def variant_source(csrc: pathlib.Path, kernel: str, name: str) -> str:
    s = (csrc / f"{kernel}.cu").read_text()
    for anchor, new, count in design(csrc, kernel)[1][name]:
        if s.count(anchor) != count:
            raise RuntimeError(
                f"ransac_variants: the anchor of {name} occurs "
                f"{s.count(anchor)} times (not {count}) in {kernel}.cu: "
                f"{anchor!r}")
        s = s.replace(anchor, new)
    return s


def build_all(sources, jobs) -> dict:
    """{(source, kernel, variant): ctypes library}, one nvcc per variant,
    started together; the ptxas report of each printed. sources: {source
    tag: csrc directory}."""
    from mcslam_tpu_torch import _build

    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for tag, kernel, name in jobs:
        csrc = sources[tag]
        stem = f"{kernel}_{tag}_{design(csrc, kernel)[3]}_{name}"
        cu = OUT / f"{stem}.cu"
        cu.write_text(variant_source(csrc, kernel, name))
        cmd = [nvcc, *_build.ARCH_FLAGS, *_build.NVCC_FLAGS,
               *_build.SOURCE_FLAGS.get(kernel, []), "-Xptxas", "-v", "-I",
               str(csrc), "-shared", "-o", str(OUT / f"{stem}.so"), str(cu)]
        procs[(tag, kernel, name)] = (stem, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (tag, kernel, name), (stem, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {tag} {kernel} {name}:\n{log}")
        for entry in re.findall(r"Compiling entry function '([^']+)'.*?"
                                r"(\d+ bytes stack frame, \d+ bytes spill "
                                r"stores).*?Used (\d+) registers([^\n]*)",
                                log, re.S):
            print(f"# build {tag} {kernel} {name}: {entry[0][:60]}: "
                  f"{entry[2]} registers{entry[3]}, {entry[1]}", flush=True)
        lib = ctypes.CDLL(str(OUT / f"{stem}.so"))
        fn = getattr(lib, f"mc_{kernel}")
        fn.argtypes = ENTRY_TYPES[(kernel, design(sources[tag], kernel)[3])]
        fn.restype = ctypes.c_int
        libs[(tag, kernel, name)] = lib
    return libs


def score_caller(lib, tag, args):
    """A call of the score entry of design `tag` on args (hyp, X, uv, cam,
    f, mask, px) -> (counts, best, pose, count, inliers)."""
    import torch

    from mcslam_tpu_torch import _build

    hyp, X, uv, cam, f, mask, px = args
    K, M, dev = hyp.shape[0], X.shape[0], hyp.device
    counters = torch.zeros(K + 1 if tag == "tiles" else 1, dtype=torch.int32,
                           device=dev)
    rows = torch.empty(K, (M + 31) // 32, dtype=torch.int32, device=dev)

    def call():
        counts = torch.empty(K, dtype=torch.int64, device=dev)
        best = torch.empty(1, dtype=torch.int64, device=dev)
        pose = torch.empty(4, 4, dtype=torch.float32, device=dev)
        n = torch.empty(1, dtype=torch.int32, device=dev)
        inl = torch.empty(M, dtype=torch.bool, device=dev)
        ptrs = [t.data_ptr() for t in (hyp, X, uv, cam, f, mask, counts, best,
                                       pose, n, inl)]
        if tag == "tiles":
            ptrs.append(rows.data_ptr())
        _build.check(lib.mc_ransac_score(
            *ptrs, counters.data_ptr(), K, M, float(px) ** 2,
            _build.stream_ptr(dev)), "mc_ransac_score")
        return counts, best, pose, n[0], inl
    return call


def pnp_caller(lib, args):
    import torch

    from mcslam_tpu_torch import _build
    from mcslam_tpu_torch.frontend import ransac_cuda

    idx, X, uv, cam, f = args
    K, S, M, dev = idx.shape[0], idx.shape[1], X.shape[0], idx.device
    starts = ransac_cuda._pnp_starts(dev)

    def call():
        out = torch.empty(K, 4, 4, dtype=torch.float32, device=dev)
        _build.check(lib.mc_pnp_hyp(
            idx.data_ptr(), X.data_ptr(), uv.data_ptr(), cam.data_ptr(),
            f.data_ptr(), starts.data_ptr(), out.data_ptr(), K, S, M,
            _build.stream_ptr(dev)), "mc_pnp_hyp")
        return out
    return call


def kabsch_caller(lib, args):
    import torch

    from mcslam_tpu_torch import _build

    idx, X_rig, X_world = args
    K, M, dev = idx.shape[0], X_rig.shape[0], idx.device

    def call():
        out = torch.empty(K, 4, 4, dtype=torch.float32, device=dev)
        _build.check(lib.mc_kabsch_hyp(
            idx.data_ptr(), X_rig.data_ptr(), X_world.data_ptr(),
            out.data_ptr(), K, M, _build.stream_ptr(dev)), "mc_kabsch_hyp")
        return out
    return call


def newton_steps(idx, X_rig, X_world) -> str:
    """The Newton steps each hypothesis takes to lambda's first bitwise
    fixed point (and the one step that finds it), by geometry/alignment's
    arithmetic on the CPU, and the steps each warp of 8 quads runs."""
    import numpy as np

    from mcslam_tpu_torch.geometry import alignment

    if not hasattr(alignment, "newton_fixed_steps"):
        return "not measured (no alignment.newton_fixed_steps in this tree)"
    i = idx.cpu()
    K_, _, _ = alignment.davenport(X_rig.cpu()[i], X_world.cpu()[i])
    steps = alignment.newton_fixed_steps(K_).numpy()
    pad = -len(steps) % 8
    warps = np.concatenate([steps, np.zeros(pad, steps.dtype)]).reshape(
        -1, 8).max(axis=1)
    return (f"mean {steps.mean():.2f}, max {steps.max()}, "
            f"{np.bincount(steps, minlength=13).tolist()} hypotheses by "
            f"steps 0-12; a warp's (8 hypotheses) mean {warps.mean():.2f}")


def stamp_split(label, lib, call, phases, smi, reps=20) -> None:
    import numpy as np
    import torch

    lib.mc_ransac_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mc_ransac_stamps.restype = ctypes.c_int
    host = (ctypes.c_ulonglong * NSTAMPS)()
    rows = []
    for _ in range(reps + 2):
        torch.cuda.synchronize()
        assert lib.mc_ransac_stamps(host, 1) == 0
        call()
        torch.cuda.synchronize()
        assert lib.mc_ransac_stamps(host, 0) == 0
        t = [int(x) for x in host]
        rows.append([t[b] - t[a] for _, a, b in phases])
    m = np.mean(np.array(rows[2:], dtype=np.float64), axis=0) / 1e3
    print(f"# {label} stamps (us, mean of {reps} calls, %globaltimer; "
          f"{smi}): " + "; ".join(f"{name} {v:.2f}"
                                  for (name, _, _), v in zip(phases, m)),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--only", nargs="*", default=None,
                    help="kernel:variant pairs (default: all), or "
                    "earlier:kernel:variant for the earlier sources")
    ap.add_argument("--kernels", nargs="*", default=list(KERNELS),
                    choices=KERNELS, help="the kernels to split and time")
    ap.add_argument("--csrc", default=str(CSRC),
                    help="the directory of the sources to split")
    ap.add_argument("--earlier", default=None,
                    help="the csrc directory of an earlier tree, timed "
                    "against --csrc in turns")
    opt = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from mcslam_tpu_torch.frontend import ransac

    if not torch.cuda.is_available():
        print("ransac_variants: no CUDA card", file=sys.stderr)
        return 2
    sources = {"current": pathlib.Path(opt.csrc).resolve()}
    if opt.earlier:
        sources["earlier"] = pathlib.Path(opt.earlier).resolve()
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    jobs = []
    for tag, csrc in sources.items():
        for kernel in opt.kernels:
            d = design(csrc, kernel)
            print(f"# {tag} {kernel}: the design of {d[0]!r} ({d[3]}) in "
                  f"{csrc}", flush=True)
            pre = "" if tag == "current" else f"{tag}:"
            jobs += [(tag, kernel, v) for v in d[1]
                     if opt.only is None or f"{pre}{kernel}:{v}" in opt.only]
    libs = build_all(sources, jobs)
    seen = cs.portfolio_calls(cs.Scene(dev, frames=2), dev)
    cases = []  # (label, kernel, {(tag, variant): call}, check)
    bad = 0

    def calls_of(kernel, make):
        return {(t, v): make(libs[(t, k, v)], design(sources[t], k)[3])
                for t, k, v in jobs if k == kernel}

    if "ransac_score" in opt.kernels:
        for a, kw in seen["score"]:
            K = a[0].shape[0]

            def check(call, a=a, K=K):
                k = call()
                counts, flags = ransac._score_reprojection(*a)
                st = cs.check_score(f"ransac_score K={K}", k, counts, flags,
                                    cs.score_edges(*a[:5], a[6]))
                return (f"{st['counts_differ']} counts and "
                        f"{st['flags_differ']} winner flags differ, winner "
                        f"{st['winner']} (plain {st['plain_winner']})")
            cases.append((f"ransac_score K={K} M={a[1].shape[0]}",
                          "ransac_score", calls_of(
                              "ransac_score", lambda lib, tag, a=a:
                              score_caller(lib, tag, a)), check))
    obs = seen["score"][2][0][1:]
    if "pnp_hyp" in opt.kernels:
        a, kw = seen["pnp_hyp"][0]

        def check_pnp(call, a=a):
            hk = call()
            hp = ransac.pnp_hypotheses(*a)
            h64 = ransac.pnp_hypotheses(a[0], *(x.double() for x in a[1:]))
            st = cs.check_hypotheses(
                "pnp_hyp", hk, hp, h64,
                ransac._score_reprojection(hk, *obs)[0],
                ransac._score_reprojection(hp, *obs)[0])
            return (f"{st['good']} good hypotheses, {st['rounding']} at a "
                    f"float32 solve's rounding, the rest within "
                    f"{st['max_abs_err']:.3g}; best {st['best']} (plain "
                    f"{st['plain_best']})")
        cases.append((f"pnp_hyp K={a[0].shape[0]} S={a[0].shape[1]}",
                      "pnp_hyp", calls_of("pnp_hyp", lambda lib, tag, a=a:
                                          pnp_caller(lib, a)), check_pnp))
    if "kabsch_hyp" in opt.kernels:
        a, kw = seen["kabsch_hyp"][0]
        obs_k = seen["score"][1][0][1:]

        def check_kabsch(call, a=a):
            hk = call()
            hp = ransac.kabsch_hypotheses(*a)
            h64 = ransac.kabsch_hypotheses(a[0], *(x.double() for x in a[1:]))
            st = cs.check_hypotheses(
                "kabsch_hyp", hk, hp, h64,
                ransac._score_reprojection(hk, *obs_k)[0],
                ransac._score_reprojection(hp, *obs_k)[0])
            return (f"{st['good']} good hypotheses, {st['rounding']} at a "
                    f"float32 solve's rounding, the rest within "
                    f"{st['max_abs_err']:.3g}; best {st['best']} (plain "
                    f"{st['plain_best']}); {st['nan']} NaN")
        label = f"kabsch_hyp K={a[0].shape[0]} M={a[1].shape[0]}"
        cases.append((label, "kabsch_hyp", calls_of(
            "kabsch_hyp", lambda lib, tag, a=a: kabsch_caller(lib, a)),
            check_kabsch))
        print(f"# {label}: Newton steps to the fixed point: "
              f"{newton_steps(*a)}", flush=True)

    for label, kernel, calls, check in cases:
        for tag in sources:
            if (tag, "full") in calls:
                print(f"# {label} {tag} full: {check(calls[(tag, 'full')])}",
                      flush=True)
        if kernel == "kabsch_hyp" and {("current", "full"),
                                       ("earlier", "full")} <= set(calls):
            same = cs.same_bits(calls[("current", "full")](),
                                calls[("earlier", "full")]())
            bad += not same
            print(f"# {label}: the current design "
                  f"{'equals' if same else 'DIFFERS from'} the earlier one "
                  f"bit for bit", flush=True)
        for tag in sources:
            if (tag, "stamps") in calls:
                stamp_split(f"{label} {tag}", libs[(tag, kernel, "stamps")],
                            calls[(tag, "stamps")],
                            design(sources[tag], kernel)[2], smi)
        names = [tv for tv in calls if tv[1] != "stamps"]
        times = {tv: [] for tv in names}
        for r in range(opt.rounds):
            for tv in (names if r % 2 == 0 else names[::-1]):
                ms, ops, _ = cs.device_profile(calls[tv], reps=20)
                times[tv].append((ms, ops))
        for tv in names:
            ms = [t for t, _ in times[tv]]
            print(f"# {label} {tv[0]} variant {tv[1]}: "
                  f"{float(np.median(ms)):.5f} ms device time per call, "
                  f"{times[tv][0][1]:.0f} device ops (median of {opt.rounds} "
                  f"rounds: {', '.join(f'{t:.5f}' for t in ms)}) ({smi})",
                  flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    # flushed, then os._exit: after torch.profiler's CUDA traces the
    # interpreter's native finalization can hang (scripts/orb_variants.py)
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
