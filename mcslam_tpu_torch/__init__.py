"""mcslam_tpu_torch — the PyTorch + CUDA port of mcslam_tpu.

The vision-only path of the JAX package (frame build: ORB extraction by
any of its routes, intra-rig matching, rig triangulation; tracking:
projection-gated matching, the pose-candidate portfolio, robust
motion-only LM and local-map tracking; keyframes and window bundle
adjustment) rebuilt on torch tensors. Every Pallas kernel of the JAX
package is a CUDA C++ kernel for Hopper (`csrc/`, built at first use by
`_build.py`); every kernel wrapper also carries a plain PyTorch version
of the same function, which is what runs for tensors on the CPU. The
entry points put their tensors on the card unless the caller passes
device="cpu".

Modules keep the JAX package's paths and names, so `mcslam_tpu.X.Y` has
its counterpart at `mcslam_tpu_torch.X.Y`.
"""

import torch as _torch

# Geometry (poses, triangulation, the LM normal equations) and the
# projection-gate factors (PASS_BIAS = 1e13 validity terms) need true f32
# products; TF32 keeps ~3 decimal digits. The JAX package forces f32
# matmuls for the same reason (mcslam_tpu/__init__.py).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
# cuSOLVER / cuBLAS for every factorization and solve on the card (the
# window solve's solve_ex, RANSAC's cholesky_ex): torch's heuristic may
# pick MAGMA, whose host-side calls a CUDA graph capture refuses, and the
# eager and the captured programs must take the same backend.
if _torch.backends.cuda.is_built():
    _torch.backends.cuda.preferred_linalg_library("cusolver")

__version__ = "0.1.0"

# Lazy top-level re-exports of the main user entry points (PEP 562), as
# mcslam_tpu/__init__.py has them, each resolved to its port module:
# `import mcslam_tpu_torch` stays cheap for tools that only need config
# parsing or IO.
_EXPORTS = {
    "MultiCameraSLAM": "mcslam_tpu_torch.slam",
    "SlamConfig": "mcslam_tpu_torch.slam",
    "build_frame": "mcslam_tpu_torch.frontend.frame",
    "CameraRig": "mcslam_tpu_torch.geometry.camera",
    "load_kalibr": "mcslam_tpu_torch.data.calib",
    "load_euroc_rig": "mcslam_tpu_torch.data.euroc",
    "ate_rmse": "mcslam_tpu_torch.utils.metrics",
}


def __getattr__(name):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(
            f"module 'mcslam_tpu_torch' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(target), name)


def __dir__():
    return sorted(list(globals()) + list(_EXPORTS))
