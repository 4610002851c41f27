"""Trajectory evaluation CLI: ATE/RPE and drift between two TUM files
(counterpart of scripts/evaluate_trajectory.py, on the port's metrics).

Parity (WHAT): the reference's evaluation workflow (evaluation.md +
scripts/python/compute_drift.py, parse_plot_lfslam_log.py), which shells
out to the external `evo` toolkit; this is self-contained.

Usage:
  python -m mcslam_tpu_torch.apps.evaluate_trajectory est.txt gt.txt
      [--scale] [--max_dt 0.02] [--rpe_delta 1] [--plot out.png]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("estimate")
    ap.add_argument("groundtruth")
    ap.add_argument("--scale", action="store_true",
                    help="Sim(3) alignment (monocular)")
    ap.add_argument("--max_dt", type=float, default=0.02)
    ap.add_argument("--rpe_delta", type=int, default=1)
    ap.add_argument("--plot", default=None,
                    help="PNG path: both trajectories in 3D")
    args = ap.parse_args(argv)

    from mcslam_tpu_torch.utils import metrics, tum

    ts_e, p_e = tum.read_tum(args.estimate)
    ts_g, p_g = tum.read_tum(args.groundtruth)
    ie, ig = metrics.associate(ts_e, ts_g, args.max_dt)
    if len(ie) < 2:
        print("no timestamp associations", file=sys.stderr)
        return 1
    pe, pg = p_e[ie], p_g[ig]
    ate = metrics.ate_rmse(pe, pg, with_scale=args.scale)
    t_rpe, r_rpe = metrics.rpe(pe, pg, delta=args.rpe_delta)
    length = float(
        np.sum(np.linalg.norm(np.diff(pg[:, :3, 3], axis=0), axis=1))
    )
    print(f"associated poses: {len(ie)}")
    print(f"trajectory length [m]: {length:.3f}")
    print(f"ATE RMSE [m]: {ate:.4f}  ({100*ate/max(length,1e-9):.2f}% of length)")
    print(f"RPE trans [m/step]: {t_rpe:.4f}  RPE rot [rad/step]: {r_rpe:.5f}")
    # the reference's two published accuracy metrics (README.md:239-240):
    # segment-averaged drift
    t_drift, r_drift = metrics.drift(pe, pg)
    print(f"translation drift [%]: {t_drift:.3f}  "
          f"rotation error [rad/m]: {r_drift:.6f}")
    if args.plot:
        from mcslam_tpu_torch.viz import viewer

        viewer.render_map(
            args.plot, [], None, pe[:, :3, 3], pg[:, :3, 3],
            title=f"ATE {ate:.3f} m",
        )
        print(f"plot -> {args.plot}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
