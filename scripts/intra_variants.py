#!/usr/bin/env python3
"""Split the time of the intra_pairs kernel (csrc/intra_match.cu) on one
CUDA card by variants of its source.

    python3 scripts/intra_variants.py [--rounds 3] [--only VARIANT ...]

Run from the repository's root. Builds csrc/intra_match.cu as it stands
and with the edits of each variant below (one nvcc per variant, all
started together, into mcslam_tpu_torch/_build/variants/), prints each
build's registers, shared memory and spills, checks that the source as
it stands equals the plain version bit for bit, then times each variant
at bench frame 0's recorded C = 4 x N = 768 descriptors and Sampson gate:
the kernel's device time per call from a torch.profiler trace of 20
calls, the variants taking turns within each round (reverse order every
other round), the median over the rounds printed.

Variants (edits of the source joined by "+"):
  full      the source as it stands;
  notail    every block returns after writing its partials: no arrival,
            link or parent (the staging, products and epilogue);
  noparent  the last block of each pair returns after its link: no
            camera arrival, no parent;
  nokeys    the epilogue cut to a sum of the products (with notail only:
            the link would read rows named by unwritten keys);
  nogate    no gate copies (the tile left as it is);
  unroll4   the n8 tiles of a warp unrolled by 4, not 2;
  fenced    each arrival thread 0's __threadfence before and after a
            plain atomicAdd, in place of one atom.add.acq_rel.gpu;
  stamps    %globaltimer stamps of the phases (first block's start, the
            blocks' arrivals, the links' and the parent writes' starts
            and ends), printed as the mean split of 20 calls.
Their outputs are not the function's, except full's. The anchors are
exact source lines; an edit whose anchor is not found fails the run.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SRC = ROOT / "mcslam_tpu_torch" / "csrc" / "intra_match.cu"
OUT = ROOT / "mcslam_tpu_torch" / "_build" / "variants"
VARIANTS = ("full", "notail", "noparent", "nokeys+notail", "nogate",
            "unroll4", "fenced", "stamps")

ARRIVAL = "  // arrival: the last of the pair's S x S blocks merges the pair. The\n"
PARENT = "  // the last of the pairs ending in camera cj writes its parents\n"
DOT = "    pm1::tile_dot(s_bp, jt, g, t, af, dot);\n"
GATE = "    asm volatile(\"cp.async.commit_group;\\n\" ::: \"memory\");\n"
LOOP = "#pragma unroll 2\n  for (int jt = 0; jt < TILE / 8; ++jt) {\n"
COPY = ("        cp_async16(s_gate + gate_off(r, c),\n"
        "                   gp + static_cast<size_t>(row0 + r) * N + col0 + c);\n")
ARRIVE1 = "  if (tid == 0) s_last = add_acq_rel(&counters[p]) == S * S - 1;\n"
ARRIVE2 = ("    counters[p] = 0;\n"
           "    s_last = add_acq_rel(&counters[P + cj]) == cj - 1;\n")
# the stamps variant: %globaltimer (ns) at the first block's start, each
# block's arrival (latest and earliest), each link's start and end, each
# parent write's start and end (latest of each), kept in a __device__
# array that mc_intra_stamps reads and resets
STAMP_DEFS = """
__device__ unsigned long long g_stamps[8];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
"""
STAMP_GETTER = """
extern "C" int mc_intra_stamps(unsigned long long* host, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));
  if (e != cudaSuccess || !reset) return static_cast<int>(e);
  unsigned long long init[8] = {~0ull, 0, 0, 0, 0, 0, ~0ull, 0};
  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, init, sizeof(init)));
}
"""
LAST = "  __shared__ int s_last;\n"
GONE = "  if (!s_last) return;\n"
LINK_AT = GONE + "\n  // the link."
PARENT_AT = GONE + "  for (int b0 = 0; b0 < N; b0 += LINK * THREADS) {\n    int v[LINK];"
END = "  if (tid == 0) counters[P + cj] = 0;\n}\n"
ENTRY = 'extern "C" int mc_intra_pairs('
EDITS = {
    "full": [],
    "notail": [(ARRIVAL, "  return;\n" + ARRIVAL)],
    "noparent": [(PARENT, PARENT + "  if (tid == 0) counters[p] = 0;\n"
                  "  return;\n")],
    "unroll4": [(LOOP, LOOP.replace("unroll 2", "unroll 4"))],
    "stamps": [
        ("namespace {\n\nconstexpr int TILE",
         "namespace {\n" + STAMP_DEFS + "\nconstexpr int TILE"),
        (LAST, LAST + "  if (threadIdx.x == 0) atomicMin(&g_stamps[0], "
         "gtime());\n"),
        (ARRIVE1, "  if (tid == 0) {\n    atomicMax(&g_stamps[1], gtime());\n"
         "    atomicMin(&g_stamps[6], gtime());\n"
         "    s_last = add_acq_rel(&counters[p]) == S * S - 1;\n  }\n"),
        (LINK_AT, GONE + "  if (tid == 0) atomicMax(&g_stamps[2], gtime());"
         "\n\n  // the link."),
        (ARRIVE2, "    atomicMax(&g_stamps[3], gtime());\n" + ARRIVE2),
        (PARENT_AT, PARENT_AT.replace(GONE, GONE + "  if (tid == 0) "
                                      "atomicMax(&g_stamps[4], gtime());\n")),
        (END, "  __syncthreads();\n  if (tid == 0) atomicMax(&g_stamps[5], "
         "gtime());\n" + END),
        (ENTRY, STAMP_GETTER + ENTRY)],
    # thread 0's __threadfence before and after a plain atomicAdd
    "fenced": [
        (ARRIVE1, "  if (tid == 0) {\n    __threadfence();\n"
         "    s_last = atomicAdd(&counters[p], 1) == S * S - 1;\n"
         "    if (s_last) __threadfence();\n  }\n"),
        (ARRIVE2, "    __threadfence();\n    counters[p] = 0;\n"
         "    s_last = atomicAdd(&counters[P + cj], 1) == cj - 1;\n"
         "    if (s_last) __threadfence();\n")],
    "nokeys": [(DOT, DOT + "    bk_g += dot[0] + dot[1] + dot[2] + dot[3];\n"
                "    continue;\n")],
    "nogate": [(COPY, "        (void)0;\n"), (GATE, "")],
}


def variant_source(name: str) -> str:
    s = SRC.read_text()
    for part in name.split("+"):
        for anchor, new in EDITS[part]:
            if s.count(anchor) != 1:
                raise RuntimeError(f"intra_variants: the anchor of {part} "
                                   f"occurs {s.count(anchor)} times in "
                                   f"{SRC.name}: {anchor!r}")
            s = s.replace(anchor, new)
    return s


def build_all(names) -> dict:
    """{name: ctypes library}, one nvcc per variant, started together; the
    ptxas report of each printed."""
    from mcslam_tpu_torch import _build

    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name in names:
        stem = name.replace("+", "_")
        cu = OUT / f"intra_{stem}.cu"
        cu.write_text(variant_source(name))
        cmd = [nvcc, *_build.ARCH_FLAGS, *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-I", str(SRC.parent), "-shared", "-o",
               str(OUT / f"intra_{stem}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        used = re.findall(r"Used (\d+) registers.*", log)
        spill = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill "
                           r"stores", log)
        print(f"# build {name}: {used[-1] if used else '?'} registers, "
              f"stack / spill stores {spill[-1] if spill else '?'}",
              flush=True)
        lib = ctypes.CDLL(str(OUT / f"intra_{name.replace('+', '_')}.so"))
        lib.mc_intra_pairs.argtypes = _build.SIGNATURES["mc_intra_pairs"]
        lib.mc_intra_pairs.restype = ctypes.c_int
        libs[name] = lib
    return libs


def caller(lib, desc, valid, gate, max_dist, ratio):
    """A call of one variant on buffers made once (counters its own)."""
    import torch

    from mcslam_tpu_torch import _build
    from mcslam_tpu_torch.frontend import intra_cuda

    C, N = desc.shape[:2]
    dev = desc.device
    parent = torch.empty(C, N, dtype=torch.int32, device=dev)
    scratch = torch.empty(intra_cuda.scratch_ints(C, N), dtype=torch.int32,
                          device=dev)
    cnt = torch.zeros(intra_cuda.COUNTERS, dtype=torch.int32, device=dev)

    def call():
        _build.check(lib.mc_intra_pairs(
            desc.data_ptr(), valid.data_ptr(), gate.data_ptr(),
            parent.data_ptr(), scratch.data_ptr(), cnt.data_ptr(), C, N,
            intra_cuda.tiles(N), scratch.numel(), cnt.numel(), int(max_dist),
            float(ratio), _build.stream_ptr(dev)), "mc_intra_pairs")
        return parent
    return call


def stamp_split(lib, call, smi, reps=20) -> None:
    """The stamps variant's phases, mean microseconds over reps calls."""
    import numpy as np
    import torch

    lib.mc_intra_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mc_intra_stamps.restype = ctypes.c_int
    host = (ctypes.c_ulonglong * 8)()
    rows = []
    for _ in range(reps + 2):
        torch.cuda.synchronize()
        assert lib.mc_intra_stamps(host, 1) == 0
        call()
        torch.cuda.synchronize()
        assert lib.mc_intra_stamps(host, 0) == 0
        t = [int(x) for x in host]
        rows.append([t[6] - t[0], t[1] - t[0], t[2] - t[1], t[3] - t[2],
                     t[4] - t[3], t[5] - t[4], t[5] - t[0]])
    m = np.mean(np.array(rows[2:], dtype=np.float64), axis=0) / 1e3
    print(f"# stamps (us, mean of {reps} calls, %globaltimer): first block "
          f"start -> first arrival {m[0]:.2f}, -> last arrival {m[1]:.2f}; "
          f"last arrival -> last link start {m[2]:.2f}; link start -> end "
          f"{m[3]:.2f}; -> last parent start {m[4]:.2f}; parent start -> "
          f"end {m[5]:.2f}; first start -> end {m[6]:.2f} ({smi})",
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--only", nargs="*", default=None)
    opt = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from mcslam_tpu_torch.frontend import frame, intra_cuda

    if not torch.cuda.is_available():
        print("intra_variants: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    names = opt.only or list(VARIANTS)
    libs = build_all(names)
    scene = cs.Scene(dev, frames=1)
    seen = cs.capture_calls(lambda: frame.build_frame(
        scene.imgs[0], scene.rig, **scene.frame_kwargs()))
    a, kw = seen["intra_pairs"]
    calls = {n: caller(libs[n], *a, **kw) for n in names}
    if "full" in calls:
        got = calls["full"]().clone()
        ref = intra_cuda.intra_pairs_reference(*a, **kw)
        torch.cuda.synchronize()
        cs.check(torch.equal(got, ref), "intra_variants: full differs from "
                 "the plain version")
        print("# full: parent bitwise equal to the plain version", flush=True)
    for n in names:
        if "stamps" in n.split("+"):
            print(f"# {n}:", flush=True)
            stamp_split(libs[n], calls[n], smi)
    times = {n: [] for n in names}
    for r in range(opt.rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            _, _, ms = cs.device_profile(calls[n], reps=20,
                                         names=("intra_pairs_kernel",))
            times[n].append(ms)
    for n in names:
        print(f"# variant {n}: {float(np.median(times[n])):.4f} ms device "
              f"time per call (median of {opt.rounds} rounds: "
              f"{', '.join(f'{t:.4f}' for t in times[n])}) ({smi})",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
