"""mcslam_tpu_torch — the PyTorch + CUDA port of mcslam_tpu.

The per-frame tracking path of the JAX package (frame build: ORB
extraction, intra-rig matching, rig triangulation; tracking: projection-
gated matching, the pose-candidate portfolio, robust motion-only LM and
local-map tracking) rebuilt on torch tensors. The four Pallas kernels of
that path are CUDA C++ kernels for Hopper (`csrc/`, built at first use by
`_build.py`); every kernel wrapper also carries a plain PyTorch version
of the same function, which is what runs for tensors on the CPU.

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

__version__ = "0.1.0"
