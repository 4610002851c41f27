#!/usr/bin/env python3
"""Calibration of chip_smoke.py phase 6's bootstrap gates, on the CPU.

    python3 scripts/bootstrap_calibration.py [--seeds 8]

Runs chip_smoke.mono_session and chip_smoke.far_session (the latter at
the 150-300 m depths of tests/test_seventeen.py and at chip_smoke's
FAR_DEPTH) with the plain PyTorch versions on the CPU, once per RANSAC
seed of MultiCameraSLAM, and prints per run: the initializing frame,
keyframes, tracking failures, the Sim(3)-aligned ATE (mono: from the
init frame on) and, for the 17-point scene, init_17pt and the path
length over the true one's; then the range over the seeds. The card
draws other random numbers than the CPU, so the gates sit against this
spread, not against one run. Imports no JAX.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=8)
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import torch

    import chip_smoke as cs
    from mcslam_tpu_torch.utils import metrics

    dev = torch.device("cpu")
    rows = {"mono": [], "far 150-300 m": [], f"far {cs.FAR_DEPTH[0]:.0f}-"
            f"{cs.FAR_DEPTH[1]:.0f} m": []}
    for seed in range(args.seeds):
        slam, poses, init_at, _ = cs.mono_session(dev, seed=seed)
        _, est = slam.trajectory_arrays()
        ate = (metrics.ate_rmse(est[init_at:], poses[init_at:],
                                with_scale=True)
               if init_at is not None else float("nan"))
        rows["mono"].append((ate, None))
        print(f"mono seed {seed}: init frame {init_at}, keyframes "
              f"{slam.stats['keyframes']}, failures {slam.stats['failures']}, "
              f"Sim(3) ATE from the init frame {ate:.4f} m", flush=True)
        for name, depth in (("far 150-300 m", (150.0, 300.0)),
                            (list(rows)[2], cs.FAR_DEPTH)):
            slam, poses, init_at, _ = cs.far_session(dev, depth, seed=seed)
            _, est = slam.trajectory_arrays()
            ate = metrics.ate_rmse(est, poses, with_scale=True)
            ratio = cs.path_ratio(est, poses)
            rows[name].append((ate, ratio))
            print(f"{name} seed {seed}: init frame {init_at}, init_17pt "
                  f"{slam.stats.get('init_17pt', 0)}, keyframes "
                  f"{slam.stats['keyframes']}, failures "
                  f"{slam.stats['failures']}, Sim(3) ATE {ate:.4f} m, path "
                  f"length {ratio:.3f} x the truth", flush=True)
    for name, vals in rows.items():
        ate = np.array([a for a, _ in vals])
        line = (f"{name} over {args.seeds} seeds: Sim(3) ATE "
                f"{np.nanmin(ate):.4f}-{np.nanmax(ate):.4f} m")
        if vals[0][1] is not None:
            ratio = np.array([r for _, r in vals])
            line += f", path length {ratio.min():.3f}-{ratio.max():.3f} x"
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
