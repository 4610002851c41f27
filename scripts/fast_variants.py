#!/usr/bin/env python3
"""Time variants of the FAST kernels' design on one CUDA card.

    python3 scripts/fast_variants.py [--rounds 6] [--reps 40]

Run from the repository's root. Builds mcslam_tpu_torch/csrc/fast_select.cu
as it stands and with the edits of each variant below (one nvcc per
variant, all started together, into mcslam_tpu_torch/_build/variants/),
prints each build's registers, shared memory, stack and spills, checks
that every variant's outputs equal the plain versions bit for bit, then
times, by CUDA events around `reps` wrapper calls, `fast_select` on
chip_smoke.py's bench stack (frame 0 of the 4-camera VGA scene, 4 pyramid
levels) and on uniform noise of that shape, and `fast_corners` in mode
hskip with the blur and mode full without, as chip_smoke.py calls them.
The variants take turns within each round, in reverse order every other
round; the median over the rounds is printed.

Variants of how the arc trees meet the compass pre-test:
  queue_split    the source as it stands;
  queue_both     the same queue, but every queued pixel runs both trees;
  inplace_both   no queue: the column walk of the pre-test runs both trees
                 on its own pixel, skipped by a warp none of whose lanes
                 passes (__any_sync), and the trees' barrier goes;
  inplace_split  the same, with one tree where only one polarity passes.
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

SRC = ROOT / "mcslam_tpu_torch" / "csrc" / "fast_select.cu"
OUT = ROOT / "mcslam_tpu_torch" / "_build" / "variants"

_QUEUE_CALL = ('''    s_score[(i0 + r) * ZCOLS + j] = 0.f;
    push(br, dk, (i0 + r) * ZCOLS + j, seg, n1, n2);
''', 1)
# lanes past the edge pixels repeat pixel (0, 0) or (0, 129), writing 0
# there before the queued trees; in place they would race with the lane
# that scores it, so they go to the unused score column 130
_IDLE_EDGE = (
    ("const int ie = act ? t >> 1 : 0, je = (t & 1) ? CHUNK + 1 : 0;", 1),
    "const int ie = act ? t >> 1 : 0,\n"
    "              je = !act ? CHUNK + 2 : (t & 1) ? CHUNK + 1 : 0;")
_TREES = ('''  tree_tile(s_img, s_score, s_q, s_cnt, min_thr);
  __syncthreads();
''', 2)


def _inplace(tree: str) -> str:
    return f'''    float sc = 0.f;
    if (__any_sync(0xffffffffu, br || dk)) {{
      const float v = {tree};
      sc = (br || dk) ? v : 0.f;
    }}
    s_score[(i0 + r) * ZCOLS + j] = sc;
'''


# variant -> [((anchor, occurrences), replacement)]
VARIANTS = {
    "queue_split": [],
    "queue_both": [((
        "s_score[off] = score_one(s_img + (i + 3) * SCOLS + j + 3,\n"
        "                             (e & 0x8000) ? -1.f : 1.f, thr);", 1),
        "s_score[off] = score_both(s_img + (i + 3) * SCOLS + j + 3, thr);")],
    "inplace_both": [(_QUEUE_CALL, _inplace("score_both(p, thr)")),
                     (_TREES, ""), _IDLE_EDGE],
    "inplace_split": [(_QUEUE_CALL, _inplace(
        "(br && dk) ? score_both(p, thr) : score_one(p, dk ? -1.f : 1.f, "
        "thr)")), (_TREES, ""), _IDLE_EDGE],
}
KERNELS = {"fast_select_kernel": "fast_select_kernel",
           "fast_corners_kernel<true>": "fast_corners_kernelILb1E",
           "fast_corners_kernel<false>": "fast_corners_kernelILb0E"}


def variant_source(edits) -> str:
    s = SRC.read_text()
    for (anchor, count), new in edits:
        cs.check(s.count(anchor) == count,
                 f"fast_variants: an edit's anchor occurs {s.count(anchor)} "
                 f"times in {SRC.name}, not {count}: {anchor[:60]!r}")
        s = s.replace(anchor, new)
    return s


def build_all() -> dict:
    """{variant: loaded library}, all nvcc processes started together."""
    from mcslam_tpu_torch import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(variant_source(edits))
        cmd = [_build._nvcc(), *_build.ARCH_FLAGS, *_build.NVCC_FLAGS,
               "-Xptxas", "-v", "-shared", "-o", str(OUT / f"{name}.so"),
               str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        cs.check(proc.returncode == 0, f"nvcc failed for {name}:\n{log}")
        for k, r in cs.ptxas_report(log, KERNELS).items():
            print(f"# ptxas {name} {k}: {r}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        for fn in ("mc_fast_select", "mc_fast_corners"):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--reps", type=int, default=40)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fast_variants: no CUDA card", file=sys.stderr)
        return 2
    from mcslam_tpu_torch import _build
    from mcslam_tpu_torch.ops import fast_cuda

    smi = cs.nvidia_smi_line()
    print(f"# {smi}")
    dev = torch.device("cuda", 0)
    libs = build_all()
    stacked, h_l, w_l, taps = cs.stacked_pyramid(cs.Scene(dev, 1).imgs[0], dev)
    noise = torch.rand(stacked.shape, generator=torch.Generator(
        device=dev).manual_seed(5), device=dev)
    thr, fthr = cs.MIN_THR, cs.FAST_THR
    sel, sel_ref = fast_cuda.fast_select, fast_cuda.fast_select_reference
    calls = {
        "select bench": (sel, sel_ref, (stacked, thr, fthr, h_l, w_l, taps)),
        "select noise": (sel, sel_ref, (noise, thr, fthr, h_l, w_l, taps)),
        "hskip bench": (fast_cuda.fast_corners,
                        fast_cuda.fast_corners_reference,
                        (stacked, thr, h_l, taps)),
        "full bench": (fast_cuda.fast_corners,
                       fast_cuda.fast_corners_reference, (stacked, thr)),
    }
    plain = {c: ref(*a) for c, (_, ref, a) in calls.items()}
    for name, lib in libs.items():
        _build._LIB = lib
        for c, (fn, _, a) in calls.items():
            got, want = fn(*a), plain[c]
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            cs.check(all(torch.equal(x, y) for x, y in zip(got, want)),
                     f"{name} {c}: differs from the plain version")
        print(f"# check {name}: outputs equal the plain versions bit for bit "
              f"on {sorted(calls)}")
    times = {n: {c: [] for c in calls} for n in libs}
    order = list(libs)
    for rnd in range(args.rounds):
        for name in (order if rnd % 2 == 0 else order[::-1]):
            _build._LIB = libs[name]
            for c, (fn, _, a) in calls.items():
                times[name][c].append(cs.cuda_ms(lambda: fn(*a),
                                                 reps=args.reps))
    _build._LIB = None
    med = {n: {c: float(sorted(t)[len(t) // 2]) for c, t in ts.items()}
           for n, ts in times.items()}
    for name, ts in med.items():
        print(f"# time {name:14s} " + ", ".join(
            f"{c} {ms:.4f} ms" for c, ms in ts.items())
            + f" (median of {args.rounds} rounds of {args.reps} calls; {smi})")
    print(json.dumps(med))
    return 0


if __name__ == "__main__":
    sys.exit(main())
