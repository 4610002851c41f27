"""Times the frame build's two kernels, tri_refine and intra_pairs,
against an earlier design of each on one CUDA card, in turns (earlier,
current, current, earlier), at the main path's shapes.

    mkdir -p mcslam_tpu_torch/_build/earlier
    git archive <commit> mcslam_tpu_torch/csrc/tri_refine.cu \\
        mcslam_tpu_torch/csrc/intra_match.cu \\
        | tar -x -C mcslam_tpu_torch/_build/earlier
    python3 scripts/frame_kernels_ab.py \\
        --earlier mcslam_tpu_torch/_build/earlier/mcslam_tpu_torch/csrc

The earlier sources are those of the first design: tri_refine with one
thread per point and intra_pairs in two launches (intra_rows_kernel,
intra_link_kernel), whose C entries this script binds as they were. It
builds them into a library of their own with _build's flags, and the
current sources through _build. Cases: tri_refine at bench frame 0's
recorded inputs (M = 2048, R = 4, the pose table expanded) and at random
M = 2048 problems with R = 2 (keyframe pairs) and R = 8; intra_pairs at
bench frame 0's recorded C = 4 x N = 768 descriptors and Sampson gate.
For each, both versions' outputs must equal the plain version's bit for
bit; then per version and turn the mean ms per call by CUDA events over
REPS calls, and from a torch.profiler trace of 20 calls the kernels'
device ms and the device ops per call. Prints one line per case and
version, with the card's name and power limit. Exits with a code other
than 0 if an output differs.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

REPS = 200
TURNS = ("earlier", "current", "current", "earlier")


def build_earlier(src: pathlib.Path) -> ctypes.CDLL:
    """The earlier tri_refine.cu and intra_match.cu in one library."""
    from mcslam_tpu_torch import _build

    files = [src / "tri_refine.cu", src / "intra_match.cu"]
    h = hashlib.sha256(b"".join(f.read_bytes() for f in files)).hexdigest()
    out = _build.BUILD_DIR / f"libearlier_{h[:16]}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _build._nvcc()
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
            procs, objs = [], []
            for f in files:
                obj = str(pathlib.Path(tmp) / f"{f.stem}.o")
                objs.append(obj)
                procs.append(subprocess.Popen(
                    [nvcc, *_build.ARCH_FLAGS, *_build.NVCC_FLAGS,
                     *_build.SOURCE_FLAGS.get(f.stem, []), "-c", "-o", obj,
                     str(f)]))
            if any(p.wait() != 0 for p in procs):
                raise RuntimeError("nvcc failed on the earlier sources")
            subprocess.run([nvcc, *_build.ARCH_FLAGS, "-shared", "-o",
                            str(out), *objs], check=True)
    lib = ctypes.CDLL(str(out))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mc_tri_refine.argtypes = _build.SIGNATURES["mc_tri_refine"]
    # desc, valid, gate, parent, rows (3 P N ints), colpart (P T N int64),
    # C, N, T, max_dist, ratio, stream
    lib.mc_intra_pairs.argtypes = [P] * 6 + [I] * 4 + [F, P]
    for fn in (lib.mc_tri_refine, lib.mc_intra_pairs):
        fn.restype = ctypes.c_int
    return lib


def earlier_intra(lib, desc, valid, gate, max_dist=60, ratio=0.85):
    """intra_pairs through the earlier two-launch entry (row tiles of 32)."""
    import torch

    from mcslam_tpu_torch import _build

    C, N = desc.shape[:2]
    P, T, dev = C * (C - 1) // 2, -(-N // 32), desc.device
    parent = torch.empty(C, N, dtype=torch.int32, device=dev)
    rows = torch.empty(3, P, N, dtype=torch.int32, device=dev)
    colpart = torch.empty(P, T, N, dtype=torch.int64, device=dev)
    _build.check(lib.mc_intra_pairs(
        desc.data_ptr(), valid.data_ptr(), gate.data_ptr(), parent.data_ptr(),
        rows.data_ptr(), colpart.data_ptr(), C, N, T, int(max_dist),
        float(ratio), _build.stream_ptr(dev)), "earlier mc_intra_pairs")
    return parent


def earlier_tri(lib, *args, **kw):
    """tri_refine through the earlier entry (the same C signature)."""
    from mcslam_tpu_torch import _build
    from mcslam_tpu_torch.geometry import triangulation_cuda

    saved = _build._LIB
    _build._LIB = lib
    try:
        return triangulation_cuda.tri_refine(*args, **kw)
    finally:
        _build._LIB = saved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--earlier", required=True, type=pathlib.Path,
                    help="directory of the earlier tri_refine.cu and "
                         "intra_match.cu")
    opt = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from mcslam_tpu_torch import _build
    from mcslam_tpu_torch.frontend import frame, intra_cuda
    from mcslam_tpu_torch.geometry import triangulation, triangulation_cuda

    if not torch.cuda.is_available():
        print("frame_kernels_ab: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    _build.library()
    lib = build_earlier(opt.earlier)
    scene = cs.Scene(dev, frames=1)
    seen = cs.capture_calls(lambda: frame.build_frame(
        scene.imgs[0], scene.rig, **scene.frame_kwargs()))
    rng = np.random.RandomState(0)
    ta, tkw = seen["tri_refine"]
    r2, s2 = cs.tri_problem(rng, 2048, 2, dev)
    r8, s8 = cs.tri_problem(rng, 2048, 8, dev)
    ia, ikw = seen["intra_pairs"]
    tri_plain = triangulation.triangulate_and_refine_reference
    cases = [(f"tri_refine M=2048 R={cs.C} (bench frame 0)", ta, tkw,
              ("tri_refine_kernel",), ("tri_refine_kernel",)),
             ("tri_refine M=2048 R=2 (random)", r2,
              dict(sigma=s2, min_z=0.1, max_z=100.0),
              ("tri_refine_kernel",), ("tri_refine_kernel",)),
             ("tri_refine M=2048 R=8 (random)", r8, dict(sigma=s8),
              ("tri_refine_kernel",), ("tri_refine_kernel",)),
             (f"intra_pairs C={cs.C} N={ia[0].shape[1]} (bench frame 0)",
              ia, ikw, ("intra_rows_kernel", "intra_link_kernel"),
              ("intra_pairs_kernel",))]
    bad = 0
    for name, args, kw, old_syms, new_syms in cases:
        if name.startswith("tri_refine"):
            fns = {"earlier": lambda a=args, k=kw: earlier_tri(lib, *a, **k),
                   "current": lambda a=args, k=kw:
                       triangulation_cuda.tri_refine(*a, **k)}
            ref = tri_plain(*args, **kw)
        else:
            fns = {"earlier": lambda a=args, k=kw: earlier_intra(lib, *a, **k),
                   "current": lambda a=args, k=kw:
                       intra_cuda.intra_pairs(*a, **k)}
            ref = intra_cuda.intra_pairs_reference(*args, **kw)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for v, fn in fns.items():
            out = fn()
            out = out if isinstance(out, tuple) else (out,)
            torch.cuda.synchronize()
            if not all(cs.same_bits(o.float(), r.float())
                       for o, r in zip(out, ref)):
                print(f"# ab {name} {v}: differs from the plain version")
                bad += 1
        events = {"earlier": [], "current": []}
        device = {"earlier": [], "current": []}
        for v in TURNS:
            events[v].append(cs.cuda_ms(fns[v], reps=REPS, warmup=10))
            syms = old_syms if v == "earlier" else new_syms
            _, n_ops, kern = cs.device_profile(fns[v], reps=20, names=syms)
            device[v].append((kern, n_ops))
        for v in ("earlier", "current"):
            print(f"# ab {name} {v}: device "
                  f"{' / '.join(f'{k:.4f}' for k, _ in device[v])} ms per "
                  f"call in {device[v][0][1]:.0f} device ops; by CUDA events "
                  f"{' / '.join(f'{e:.4f}' for e in events[v])} ms per call "
                  f"({REPS} calls a turn; turns {', '.join(TURNS)}) ({smi})",
                  flush=True)
    print(f"# frame_kernels_ab: {'all outputs equal the plain versions' if not bad else f'{bad} outputs differ'}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
