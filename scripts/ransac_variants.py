#!/usr/bin/env python3
"""Split the time of the RANSAC kernels ransac_score and pnp_hyp
(csrc/ransac_score.cu, csrc/pnp_hyp.cu) on one CUDA card by %globaltimer
stamps and by variants of their sources.

    python3 scripts/ransac_variants.py [--rounds 3] [--only KERNEL:VARIANT ...]
        [--csrc DIR]

Run from the repository's root. Builds each source as it stands (or as it
stands in DIR, e.g. the csrc/ of a `git archive` of an earlier commit)
and with the edits of each variant below (one nvcc per variant, all
started together, into mcslam_tpu_torch/_build/variants/), prints each
build's registers, shared memory and spills, and at the calls that bench
frame 1's step with its portfolio forced makes (chip_smoke.portfolio_calls:
the score at K = 1, 512, 256 and 3 over M = 2048 correspondences,
pnp_hyp at K = 256) checks each source as it stands against its plain
version under chip_smoke's criteria (check_score, check_hypotheses),
then prints:
- the stamps variant's phases per call (the earliest start and the
  latest end of each phase over the blocks, or the warps of pnp_hyp,
  stamped right after a barrier; mean over 20 calls);
- each variant's device time per call (the variants of a kernel taking
  turns within each round, reversed every other round; 20 calls a
  round, median over the rounds).
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
KERNELS = ("ransac_score", "pnp_hyp")

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


def w0(k, indent="  "):
    """A stamp by lane 0 of each warp."""
    return f"{indent}if ((threadIdx.x & 31) == 0) stamp({k});\n"


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

DESIGNS = {
    "ransac_score": [("HB = 4;", SCORE_HB4, SCORE_HB4_PHASES, "hb4"),
                     ("HT_MAX", SCORE_TILES, SCORE_TILES_PHASES, "tiles")],
    "pnp_hyp": [("chol_solve", PNP_DIV, PNP_PHASES, "div"),
                ("solve_recip", PNP_RECIP, PNP_PHASES, "recip")],
}
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C entries' argument types by design
ENTRY_TYPES = {
    ("ransac_score", "hb4"): [P] * 12 + [I, I, F, P],
    ("ransac_score", "tiles"): [P] * 13 + [I, I, F, P],
    ("pnp_hyp", "div"): [P] * 7 + [I, I, I, P],
    ("pnp_hyp", "recip"): [P] * 7 + [I, I, I, P],
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


def build_all(csrc, jobs) -> dict:
    """{(kernel, variant): ctypes library}, one nvcc per variant, started
    together; the ptxas report of each printed."""
    from mcslam_tpu_torch import _build

    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for kernel, name in jobs:
        stem = f"{kernel}_{design(csrc, kernel)[3]}_{name}"
        cu = OUT / f"{stem}.cu"
        cu.write_text(variant_source(csrc, kernel, name))
        cmd = [nvcc, *_build.ARCH_FLAGS, *_build.NVCC_FLAGS,
               *_build.SOURCE_FLAGS.get(kernel, []), "-Xptxas", "-v", "-I",
               str(csrc), "-shared", "-o", str(OUT / f"{stem}.so"), str(cu)]
        procs[(kernel, name)] = (stem, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (kernel, name), (stem, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {kernel} {name}:\n{log}")
        for entry in re.findall(r"Compiling entry function '([^']+)'.*?"
                                r"(\d+ bytes stack frame, \d+ bytes spill "
                                r"stores).*?Used (\d+) registers([^\n]*)",
                                log, re.S):
            print(f"# build {kernel} {name}: {entry[0][:60]}: {entry[2]} "
                  f"registers{entry[3]}, {entry[1]}", flush=True)
        lib = ctypes.CDLL(str(OUT / f"{stem}.so"))
        fn = getattr(lib, f"mc_{kernel}")
        fn.argtypes = ENTRY_TYPES[(kernel, design(csrc, kernel)[3])]
        fn.restype = ctypes.c_int
        libs[(kernel, name)] = lib
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
                    help="kernel:variant pairs (default: all)")
    ap.add_argument("--csrc", default=str(CSRC),
                    help="the directory of the sources to split")
    opt = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from mcslam_tpu_torch.frontend import ransac

    if not torch.cuda.is_available():
        print("ransac_variants: no CUDA card", file=sys.stderr)
        return 2
    csrc = pathlib.Path(opt.csrc).resolve()
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    jobs = []
    for kernel in KERNELS:
        d = design(csrc, kernel)
        print(f"# {kernel}: the design of {d[0]!r} ({d[3]}) in {csrc}",
              flush=True)
        jobs += [(kernel, v) for v in d[1]
                 if opt.only is None or f"{kernel}:{v}" in opt.only]
    libs = build_all(csrc, jobs)
    seen = cs.portfolio_calls(cs.Scene(dev, frames=2), dev)
    cases = []  # (label, kernel, {variant: call}, check)
    for a, kw in seen["score"]:
        K = a[0].shape[0]
        tag = design(csrc, "ransac_score")[3]
        calls = {v: score_caller(libs[(k, v)], tag, a) for k, v in jobs
                 if k == "ransac_score"}

        def check(call, a=a, K=K):
            k = call()
            counts, flags = ransac._score_reprojection(*a)
            st = cs.check_score(f"ransac_score K={K}", k, counts, flags,
                                cs.score_edges(*a[:5], a[6]))
            return (f"{st['counts_differ']} counts and {st['flags_differ']} "
                    f"winner flags differ, winner {st['winner']} (plain "
                    f"{st['plain_winner']})")
        cases.append((f"ransac_score K={K} M={a[1].shape[0]}", "ransac_score",
                      calls, check))
    a, kw = seen["pnp_hyp"][0]
    calls = {v: pnp_caller(libs[(k, v)], a) for k, v in jobs if k == "pnp_hyp"}

    def check_pnp(call, a=a):
        hk = call()
        hp = ransac.pnp_hypotheses(*a)
        h64 = ransac.pnp_hypotheses(a[0], *(x.double() for x in a[1:]))
        obs = seen["score"][2][0][1:]
        st = cs.check_hypotheses(
            "pnp_hyp", hk, hp, h64, ransac._score_reprojection(hk, *obs)[0],
            ransac._score_reprojection(hp, *obs)[0])
        return (f"{st['good']} good hypotheses, {st['rounding']} at a float32 "
                f"solve's rounding, the rest within {st['max_abs_err']:.3g}; "
                f"best {st['best']} (plain {st['plain_best']})")
    cases.append((f"pnp_hyp K={a[0].shape[0]} S={a[0].shape[1]}", "pnp_hyp",
                  calls, check_pnp))

    for label, kernel, calls, check in cases:
        if "full" in calls:
            print(f"# {label} full: {check(calls['full'])}", flush=True)
        if "stamps" in calls:
            stamp_split(label, libs[(kernel, "stamps")], calls["stamps"],
                        design(csrc, kernel)[2], smi)
        names = [v for v in calls if v != "stamps"]
        times = {v: [] for v in names}
        for r in range(opt.rounds):
            for v in (names if r % 2 == 0 else names[::-1]):
                ms, ops, _ = cs.device_profile(calls[v], reps=20)
                times[v].append((ms, ops))
        for v in names:
            ms = [t for t, _ in times[v]]
            print(f"# {label} variant {v}: {float(np.median(ms)):.4f} ms "
                  f"device time per call, {times[v][0][1]:.0f} device ops "
                  f"(median of {opt.rounds} rounds: "
                  f"{', '.join(f'{t:.4f}' for t in ms)}) ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    # flushed, then os._exit: after torch.profiler's CUDA traces the
    # interpreter's native finalization can hang (scripts/orb_variants.py)
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
