"""Build and bind the port's CUDA kernels.

All sources under `csrc/` are compiled at first use, one nvcc process per
source, all started together:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC [SOURCE_FLAGS] -c -o <obj>/<name>.o csrc/<name>.cu

then linked into ONE shared library with a plain C interface
(`nvcc -shared -o _build/libmcslam_<hash>.so <obj>/*.o`) and loaded with
ctypes. The file name carries a hash of the sources and
flags, so editing a source rebuilds it. Nothing here runs at import time:
`library()` is called by a kernel wrapper right before its first launch.
Every exported function takes its pointers and the CUDA stream as
`void*` and returns the `cudaError_t` of its launch (0 = success).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

import torch

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
# flags of one source only: ba_linearize and tri_refine round every
# multiply and add on their own, as their plain versions do (no
# contraction into FMAs)
SOURCE_FLAGS = {"ba_linearize": ["-fmad=false"],
                "tri_refine": ["-fmad=false"]}

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

# C signature of every exported launcher: (argtypes); restype is int.
SIGNATURES = {
    # img, heights, widths, blur, cand_v, cand_rid, LC, H, W, min_thr,
    # fast_thr, taps[7] (by value), stream
    "mc_fast_select": [P] * 6 + [I] * 3 + [F] * 2 + [F] * 7 + [P],
    # img, heights (NULL: mode full), score, blur (NULL: no blur), LC, H, W,
    # min_thr, taps[7] (by value; not read without the blur), stream
    "mc_fast_corners": [P] * 4 + [I] * 3 + [F] + [F] * 7 + [P],
    # imgs, yx, img_idx, patches, origins, B, H, W, T, stream
    "mc_patch_gather": [P, P, P, P, P, I, I, I, I, P],
    # imgs, yx, patches, origins, C, H, W, N, stream
    "mc_patch_gather_batched": [P, P, P, P, I, I, I, I, P],
    # imgs, yx, img_idx, patches (bf16), moments, origins, B, H, W, T, stream
    "mc_patch_gather_oriented": [P, P, P, P, P, P, I, I, I, I, P],
    # a, b, ahat, bhat, row_best, row_second, row_idx, col_idx (NULL: no
    # column argmin), fscratch, iscratch, M, N, DG, thr2, stream
    "mc_hamming_argmin2": [P] * 10 + [I, I, I, F, P],
    # M, N -> floats / ints of the scratch a call needs
    "mc_hamming_scratch_floats": [I, I],
    "mc_hamming_scratch_ints": [I, I],
    # T_init, data, mask, T_out, chi2, B, M, n_rounds, sched[4] (by
    # value), huber, chi2_thresh, lm_lambda, stream
    "mc_pose_lm": [P] * 5 + [I] * 7 + [F, F, F, P],
    # M -> dynamic shared memory bytes of a launch, -1 if it cannot fit
    "mc_pose_lm_smem": [I],
    # -> CTAs per candidate (the cluster size)
    "mc_pose_lm_cluster": [],
    # rTw12, lm_pos, obs_lm, obs_cam, uv, sigma2, validf, Rc9, tc, f4,
    # payload, r, w, Hpp, gp, K, Ok, L, C, huber, stream
    "mc_ba_linearize": [P] * 15 + [I, I, I, I, F, P],
    # -> CTAs per keyframe (the cluster size)
    "mc_ba_linearize_cluster": [],
    # pred (device bool), body (cudaGraph_t), the capturing stream: an IF
    # node running a copy of body where *pred, appended to the capture
    "mc_graph_add_if": [P, P, P],
    # cv, out, scratch (a volume and the fronts), D, H, W, p1, p2, stream
    "mc_sgm_scan": [P, P, P, I, I, I, F, F, P],
    # wTc, uv, f, mask, sigma (NULL: the scalar), X, ok, M, R, element
    # strides (wTc 4, uv 3, f 3, mask 2, sigma 2), gn_iters, sigma scalar,
    # chi2_thresh, min_z, max_z, stream
    "mc_tri_refine": [P] * 7 + [I] * 2 + [I] * 14 + [I] + [F] * 4 + [P],
    # desc, valid, gate, parent, rows (3 P N ints), colpart (P T N int64),
    # C, N, T, max_dist, ratio, stream
    "mc_intra_pairs": [P] * 6 + [I] * 4 + [F, P],
}

# Kernel launches by kernel name since the last reset: each wrapper adds
# one right before it launches its kernel (count; plain-version calls add
# none).
LAUNCHES: collections.Counter = collections.Counter()


def count(name: str) -> None:
    """One launch of kernel `name` on the current stream. Under a CUDA
    graph capture the launch is recorded into the graph, not made, and is
    not counted (a replay runs no wrapper)."""
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES[name] += 1

_LIB = None
BUILD_SECONDS = None  # wall time of the nvcc run of this process, if any
BUILD_LOG = ""  # nvcc's output of the library's build (ptxas info when verbose)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (pathlib.Path(cand) / "bin" / "nvcc").exists():
            return str(pathlib.Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, /usr/local/cuda, PATH): "
            "the CUDA kernels of mcslam_tpu_torch cannot be built"
        )
    return found


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(extra: list[str]) -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS + extra).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> pathlib.Path:
    """Compile csrc/*.cu into the hashed library unless it exists; return
    its path. verbose=True adds `-Xptxas -v` (registers, shared memory,
    spills per kernel). nvcc's output is kept beside the library
    (`<name>.log`) and in BUILD_LOG, also when an earlier process built
    it."""
    global BUILD_SECONDS, BUILD_LOG
    extra = ["-Xptxas", "-v"] if verbose else []
    out = BUILD_DIR / f"libmcslam_{_digest(extra)}.so"
    log = out.with_suffix(".log")
    if out.exists():
        if log.exists():
            BUILD_LOG = log.read_text()
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = pathlib.Path(tmp) / f"{src.stem}.o"
            cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS,
                   *SOURCE_FLAGS.get(src.stem, []), *extra, "-c", "-o",
                   str(obj), str(src)]
            objs.append(str(obj))
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for cmd, proc in procs:
            logs.append(proc.communicate()[0])
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{logs[-1]}")
        tmp_so = pathlib.Path(tmp) / out.name
        if not failed:
            cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_so), *objs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            logs.append(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(f"nvcc link failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{logs[-1]}")
        BUILD_SECONDS = time.perf_counter() - t0
        BUILD_LOG = "".join(logs)
        if failed:
            raise RuntimeError("\n".join(failed))
        log.write_text(BUILD_LOG)
        os.replace(tmp_so, out)
    return out


def library(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build(verbose)))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def stream_ptr(device) -> int:
    """The current CUDA stream of `device`, as an integer handle."""
    return torch.cuda.current_stream(device).cuda_stream
