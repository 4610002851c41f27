#!/usr/bin/env python3
"""Time variants of the SGM scan kernel's design on one CUDA card.

    python3 scripts/sgm_variants.py [--rounds 6] [--reps 40]
        [--only VARIANT ...] [--shape D H W ...]

Run from the repository's root. Builds the SGM scan kernel's earlier
design (scripts/sgm_scan_inplace.cu) and mcslam_tpu_torch/csrc/sgm_scan.cu
as it stands and with the edits of each variant below (one nvcc per
variant, all started together, into mcslam_tpu_torch/_build/variants/),
prints
each build's registers, static shared memory, stack and spills and the
dynamic shared memory of each launch, checks that every variant that
computes the aggregate equals the plain version bit for bit, then times,
by CUDA events around `reps` calls of mc_sgm_scan on preallocated
buffers, the cost volume of chip_smoke.py's bench pair (cameras 0 and 1
of frame 0, 640x480, D = 64), a uniform random volume of that shape and
one of each --shape. The variants take turns within each round, in
reverse order every other round; the median over the rounds is printed,
with the volume passes each moves at that time; then each launch's device
time from a profiler trace (all inputs but the random VGA one).

Variants (edits of the source joined by "+"; --only picks some, also
combinations not listed here, and "keep"):
  inplace    one warp per line reading the volume in place, each path into
             its own volume, then a sum pass (2 launches, 13 passes);
  tiles      the source as it stands (8 x 8 tiles of all D staged through
             shared memory by 16-byte cp.async, a ring of 2, the sum fused;
             3 launches, 11 passes);
  scalar     the 4-byte copies of the ragged path for every shape;
  sd65       a disparity plane of a tile at a stride of 65 words (32
             distinct banks a step; the 4-byte copies only);
  butterfly  the line's minimum by five xor-shuffles in place of redux;
  nohint     no L2 128-byte fetch hint on the copies;
  stages3    a ring of 3 tiles (two in flight);
  bulk       TMA 1-d bulk copies, one per 32-byte segment and array, on an
             mbarrier per stage, in place of the 16-byte cp.async;
  keep       the costs' copies under an L2 evict-last policy;
  copy       the tiles loaded, summed and stored, no recursion: the memory
             time of the design (it does not compute the aggregate);
  nostore    no global store (with copy: the loads' time alone);
  noload     no global load (with copy: the stores' time alone);
  chain      the recursion and the ring's barriers with no global load or
             store but the fronts, on the 4-byte path: the time of the
             dependent chain.
The last line is a JSON record {variant: {input: ms}}.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SRC = ROOT / "mcslam_tpu_torch" / "csrc" / "sgm_scan.cu"
INPLACE = ROOT / "scripts" / "sgm_scan_inplace.cu"
OUT = ROOT / "mcslam_tpu_torch" / "_build" / "variants"

_REDUX = ('''  const int nan_key = static_cast<int>(0x80000000u);
  const int bits = __float_as_int(m);
  const int key = isnan(m) ? nan_key : bits ^ ((bits >> 31) & 0x7fffffff);
  const int km = __reduce_min_sync(FULL, key);
  return km == nan_key ? __int_as_float(0x7fffffff)
                       : __int_as_float(km ^ ((km >> 31) & 0x7fffffff));
''', 1)
_BUTTERFLY = '''#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = tmin(m, __shfl_xor_sync(FULL, m, off));
  return m;
'''
_WHERE = ("    if (!where(first + dj * i, g)) return;\n", 2)
_LOAD = ("  auto load = [&](int i) {  // the role's i-th tile into stage "
         "i % STAGES\n", 1)
_VEC = ("  const bool vec = W % 4 == 0 &&", 1)
_STORE = ("  auto store = [&](int i, const float* t) {\n", 1)

# The aligned path by the TMA engine's 1-d bulk copies, one per 32-byte
# segment and array, completing on an mbarrier per stage of the ring (the
# scan's shared-memory writes fenced before the copies that overwrite
# them), in place of the 16-byte cp.async copies.
_BULK_HELPERS = (("// m: the line's minimum", 1), '''__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_copy(float* s, const float* g,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\\n" ::"r"(smem_addr(s)),
      "l"(g), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\\n" ::"r"(
                   smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\\n .reg .pred done;\\n"
      "WAIT_%=:\\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\\n"
      " @!done bra WAIT_%=;\\n}\\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// m: the line's minimum''')
_BULK_LOAD = (('''    size_t g;
    if (!where(first + dj * i, g)) return;
    float* const s = smem + (i % STAGES) * arrays * tile_f + e;
''', 1), '''    uint64_t* const bars =
        reinterpret_cast<uint64_t*>(smem + STAGES * arrays * tile_f);
    if (vec) {
      const int j = first + dj * i;
      float* const s = smem + (i % STAGES) * arrays * tile_f;
      const int y0 = horiz ? l0 : j * STEPS, x0 = horiz ? j * STEPS : l0;
      const int rows = min(LINES, H - y0), run = min(8, W - x0);
      if (tid == 0)
        mbar_expect(&bars[i % STAGES],
                    static_cast<unsigned>(arrays * D * rows * run * 4));
      for (int q = tid; q < D * rows; q += THREADS) {
        const int d = q / rows, r = q - d * rows;
        const size_t gd = d * plane + static_cast<size_t>(y0 + r) * W + x0;
        for (int a = 0; a < arrays; ++a)
          bulk_copy(s + a * tile_f + d * SD + r * 8, src(a) + gd, run * 4,
                    &bars[i % STAGES]);
      }
      return;
    }
    size_t g;
    if (!where(first + dj * i, g)) return;
    float* const s = smem + (i % STAGES) * arrays * tile_f + e;
''')
_BULK_RING = (('''#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < count) load(i);''', 1), '''  uint64_t* const bars =
      reinterpret_cast<uint64_t*>(smem + STAGES * arrays * tile_f);
  if (vec && tid == 0) {
    for (int st = 0; st < STAGES; ++st)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\\n" ::"r"(
                       smem_addr(&bars[st]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < count) load(i);''')
_BULK_WAIT = (('''    cp_async_wait_ring();  // tile i has landed (this thread's copies)
    __syncthreads();''', 1), '''    if (vec)
      mbar_wait(&bars[i % STAGES], (i / STAGES) & 1);
    else
      cp_async_wait_ring();
    asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
    __syncthreads();''')
_BULK_SMEM = (("(1 + launch) * D * SD * sizeof(float);", 1),
              "(1 + launch) * D * SD * sizeof(float) + 64;")

# the costs' 16-byte copies under an L2 evict-last policy (the costs are
# read four times; out and scratch stay at the normal priority)
_KEEP_FN = (("__device__ __forceinline__ void cp_async4(", 1),
            '''__device__ __forceinline__ void cp_async16_keep(float* s,
                                                const float* g) {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\\n"
               : "=l"(pol));
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint.L2::128B [%0], [%1], 16, "
      "%2;\\n" ::"r"((unsigned)__cvta_generic_to_shared(s)),
      "l"(g), "l"(pol));
}

__device__ __forceinline__ void cp_async4(''')
_KEEP_USE = (("          cp_async16(to, from);", 1),
             "          a == 0 ? cp_async16_keep(to, from) : "
             "cp_async16(to, from);")

# edit -> [((anchor, occurrences), replacement)]
EDITS = {
    "keep": [_KEEP_FN, _KEEP_USE],
    "scalar": [(_VEC, "  const bool vec = false &&")],
    "sd65": [(("constexpr int SD = LINES * STEPS + 4;", 1),
              "constexpr int SD = LINES * STEPS + 1;")],
    "butterfly": [(_REDUX, _BUTTERFLY)],
    "nohint": [((".L2::128B", 2), "")],
    "stages3": [(("constexpr int STAGES = 2;", 1), "constexpr int STAGES = 3;")],
    "bulk": [_BULK_HELPERS, _BULK_LOAD, _BULK_RING, _BULK_WAIT, _BULK_SMEM],
    "copy": [(("    if (live) {  // the recursion over this tile's steps", 1),
              "    if (false) {")],
    "noload": [(_LOAD, _LOAD[0] + "    if (i >= 0) return;\n")],
    "nostore": [(_STORE, _STORE[0] + "    if (i >= 0) return;\n")],
    "chain": [(_LOAD, _LOAD[0] + "    if (i >= 0) return;\n"),
              (_WHERE, "    g = 0;\n    if (g == 0) return;\n"),
              (_VEC, "  const bool vec = false &&")],
}
# variants: "inplace" (the earlier design), "tiles" (the source as it stands),
# else edits joined by "+"
VARIANTS = ("inplace", "tiles", "scalar", "scalar+sd65", "butterfly", "nohint",
            "stages3", "bulk", "copy", "copy+scalar", "copy+bulk",
            "copy+nostore", "copy+noload", "chain", "chain+sd65")
EXACT = tuple(v for v in VARIANTS if not any(
    e in v.split("+") for e in ("copy", "chain", "noload", "nostore")))
KERNELS = {**{f"sgm_tile_kernel<{k}>": f"sgm_tile_kernelILi{k}E"
              for k in (1, 2, 3, 4)},
           "sgm_path_kernel<2>": "sgm_path_kernelILi2E",
           "sgm_sum_kernel": "sgm_sum_kernel"}


def passes(name: str) -> int:
    """Volume passes a variant moves: the earlier design's 13, the
    chain's none, the loads' 7 and the stores' 4, else 11."""
    edits = name.split("+")
    return (13 if name == "inplace" else 0 if "chain" in edits
            else 7 if "nostore" in edits else 4 if "noload" in edits else 11)


def variant_source(name: str) -> str:
    if name == "inplace":
        return INPLACE.read_text()
    s = SRC.read_text()
    edits = [] if name == "tiles" else [
        x for e in name.split("+") for x in EDITS[e]]
    for (anchor, count), new in edits:
        cs.check(s.count(anchor) == count,
                 f"sgm_variants: an edit's anchor occurs {s.count(anchor)} "
                 f"times in {SRC.name}, not {count}: {anchor[:60]!r}")
        s = s.replace(anchor, new)
    return s


def stages(name: str) -> int:
    return 3 if "stages3" in name.split("+") else 2


def sd(name: str) -> int:
    """Words per disparity plane of a staged tile."""
    return 65 if "sd65" in name.split("+") else 68


def build_all(only=None) -> dict:
    """{variant: loaded library} of the variants (those in `only` where
    given), all nvcc processes started together."""
    from mcslam_tpu_torch import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in (VARIANTS if only is None else only):
        cu = OUT / f"sgm_{name.replace('+', '_')}.cu"
        cu.write_text(variant_source(name))
        cmd = [_build._nvcc(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS,
               "-Xptxas", "-v", "-shared", "-o", str(cu.with_suffix(".so")),
               str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        cs.check(proc.returncode == 0, f"nvcc failed for {name}:\n{log}")
        for k, r in cs.ptxas_report(log, KERNELS).items():
            print(f"# ptxas {name} {k}: {r}")
        if name != "inplace":
            print(f"# smem {name}: dynamic shared memory per block at D = "
                  f"64, launches 1 / 2 / 3: " + " / ".join(
                      f"{stages(name) * (1 + n) * 64 * sd(name) * 4} B"
                      for n in range(3)))
        lib = ctypes.CDLL(str(OUT / f"sgm_{name.replace('+', '_')}.so"))
        lib.mc_sgm_scan.argtypes = _build.SIGNATURES["mc_sgm_scan"]
        lib.mc_sgm_scan.restype = ctypes.c_int
        libs[name] = lib
    return libs


def caller(name, lib, cv):
    """A no-argument call of variant `name` on cv into buffers of its
    own; returns the output tensor it writes."""
    import torch

    from mcslam_tpu_torch import _build
    from mcslam_tpu_torch.ops import sgm_cuda

    D, H, W = cv.shape
    out = torch.empty_like(cv)
    n = 3 * cv.numel() if name == "inplace" else sgm_cuda.scratch_floats(
        D, H, W)
    scratch = torch.empty(n, dtype=torch.float32, device=cv.device)
    stream = _build.stream_ptr(cv.device)

    def call():
        _build.check(lib.mc_sgm_scan(cv.data_ptr(), out.data_ptr(),
                                     scratch.data_ptr(), D, H, W, 0.03, 0.2,
                                     stream), f"mc_sgm_scan ({name})")
        return out
    return call


def launch_split(fn, name, reps=10) -> list:
    """Device ms of each launch of one call (the kernel's launches in
    order: 2 for the earlier design, 3 otherwise), from a profiler trace
    of reps calls."""
    per = 2 if name == "inplace" else 3
    for _ in range(5):
        _, evs, kept = cs.device_events(lambda: [fn() for _ in range(reps)])
        evs = sorted((e for e in evs if "sgm_" in e.name),
                     key=lambda e: e.time_range.start)
        if kept and len(evs) == per * reps:
            break
    cs.check(len(evs) == per * reps, f"{name}: the trace kept {len(evs)} "
             f"of {per * reps} launches")
    return [sum(e.time_range.elapsed_us() for e in evs[i::per]) / reps / 1e3
            for i in range(per)]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--only", nargs="*", default=None,
                    help="time these variants only (default: all)")
    ap.add_argument("--shape", nargs=3, type=int, action="append",
                    default=[], metavar=("D", "H", "W"),
                    help="also time a uniform random volume of this shape")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sgm_variants: no CUDA card", file=sys.stderr)
        return 2
    from mcslam_tpu_torch.ops import sgm_cuda, stereo

    smi = cs.nvidia_smi_line()
    print(f"# {smi}")
    dev = torch.device("cuda", 0)
    libs = build_all(args.only)
    imgs = cs.Scene(dev, 1).imgs[0]
    bench = stereo.cost_volume(imgs[0], imgs[1], cs.STEREO_D).contiguous()
    noise = torch.rand(bench.shape, generator=torch.Generator(
        device=dev).manual_seed(5), device=dev)
    inputs = {"bench": bench, "noise": noise}
    for i, (d, h, w) in enumerate(args.shape):
        inputs[f"{d}x{h}x{w}"] = torch.rand(
            (d, h, w), generator=torch.Generator(device=dev).manual_seed(6 + i),
            device=dev)
    plain = {k: sgm_cuda.sgm_aggregate_reference(v) for k, v in inputs.items()}
    calls = {n: {k: caller(n, lib, v) for k, v in inputs.items()}
             for n, lib in libs.items()}
    for name in (n for n in EXACT if n in libs):
        for k, fn in calls[name].items():
            got = fn()
            torch.cuda.synchronize()
            cs.check(torch.equal(got, plain[k]),
                     f"{name} {k}: differs from the plain version")
        print(f"# check {name}: bitwise equal to the plain version on "
              f"{sorted(inputs)}")
    print(f"# not checked: {', '.join(n for n in libs if n not in EXACT)}"
          f" (they do not compute the aggregate)")
    times = {n: {k: [] for k in inputs} for n in libs}
    order = list(libs)
    for rnd in range(args.rounds):
        for name in (order if rnd % 2 == 0 else order[::-1]):
            for k, fn in calls[name].items():
                times[name][k].append(cs.cuda_ms(fn, reps=args.reps))
    med = {n: {k: float(sorted(t)[len(t) // 2]) for k, t in ts.items()}
           for n, ts in times.items()}
    vols = {k: v.nbytes for k, v in inputs.items()}
    vol = bench.nbytes
    print(f"# bound: 2 x {vol / 1e6:.1f} MB / 3.35 TB/s = "
          f"{2 * vol / cs.HBM_BYTES_PER_S * 1e3:.4f} ms")
    for name, ts in med.items():
        p = passes(name)
        rate = "".join(
            f", {k} {p * vols[k] / (ms * 1e-3) / 1e12:.2f} TB/s" for k, ms in
            ts.items()) if p else ""
        print(f"# time {name:8s} " + ", ".join(
            f"{k} {ms:.4f} ms" for k, ms in ts.items())
            + f" ({p} volume passes{rate}; median of {args.rounds} rounds of "
            f"{args.reps} calls; {smi})")
    for k in inputs:
        if k == "noise":
            continue
        for name in libs:
            ms = launch_split(calls[name][k], name)
            print(f"# device time {name:12s} {k} per launch: "
                  + " / ".join(f"{x:.4f}" for x in ms)
                  + f" ms (profiler, 10 calls; {smi})")
    print(json.dumps(med))
    return 0


if __name__ == "__main__":
    sys.exit(main())
