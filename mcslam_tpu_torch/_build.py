"""Build and bind the port's CUDA kernels.

All sources under `csrc/` are compiled at first use, one nvcc process per
source, all started together:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c -o <obj>/<name>.o csrc/<name>.cu

then linked into ONE shared library with a plain C interface
(`nvcc -shared -o _build/libmcslam_<hash>.so <obj>/*.o`) and loaded with
ctypes. The file name carries a hash of the sources and
flags, so editing a source rebuilds it. Nothing here runs at import time:
`library()` is called by a kernel wrapper right before its first launch.
Every exported function takes its pointers and the CUDA stream as
`void*` and returns the `cudaError_t` of its launch (0 = success).
"""

from __future__ import annotations

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

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

# C signature of every exported launcher: (argtypes); restype is int.
SIGNATURES = {
    # img, heights, widths, taps[7], blur, cand_v, cand_rid,
    # LC, H, W, min_thr, fast_thr, stream
    "mc_fast_select": [P, P, P, P, P, P, P, I, I, I, F, F, P],
    # imgs, yx, img_idx, patches, origins, B, H, W, T, stream
    "mc_patch_gather": [P, P, P, P, P, I, I, I, I, P],
    # a, b, ahat, bhat, row_best, row_second, row_idx, col_key,
    # M, N, DG, thr2, want_cols, stream
    "mc_hamming_argmin2": [P, P, P, P, P, P, P, P, I, I, I, F, I, P],
    # T_init, data, mask, sched, T_out, chi2, B, M, n_rounds, huber,
    # chi2_thresh, lm_lambda, stream
    "mc_pose_lm": [P, P, P, P, P, P, I, I, I, F, F, F, P],
    # rTw12, lm_pos, obs_lm, obs_cam, uv, sigma2, validf, Rc9, tc, f4,
    # payload, r, w, Hpp, gp, partials, K, Ok, L, C, huber, stream
    "mc_ba_linearize": [P] * 16 + [I, I, I, I, F, P],
}

_LIB = None
BUILD_SECONDS = None  # wall time of the nvcc run of this process, if any
BUILD_LOG = ""  # nvcc's output of that run (ptxas info when verbose)


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
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> pathlib.Path:
    """Compile csrc/*.cu into the hashed library unless it exists; return
    its path. verbose=True adds `-Xptxas -v` (registers, shared memory,
    spills per kernel) and keeps nvcc's output in BUILD_LOG."""
    global BUILD_SECONDS, BUILD_LOG
    extra = ["-Xptxas", "-v"] if verbose else []
    out = BUILD_DIR / f"libmcslam_{_digest(extra)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = pathlib.Path(tmp) / f"{src.stem}.o"
            cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, *extra, "-c", "-o",
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
