"""One-command EuRoC evaluation: raw ASL sequence -> TUM trajectory ->
ATE/RPE vs the shipped ground truth (counterpart of scripts/run_euroc.py,
on the port).

Parity (WHAT): the reference's evaluation workflow (evaluation.md:1-27 —
TUM export + evo alignment/APE/RPE), self-contained
(apps/evaluate_trajectory.py replaces evo).

Usage:
  python -m mcslam_tpu_torch.apps.run_euroc <seq_dir> [--use_imu]
      [--cams cam0,cam1] [--max_frames N] [--out_dir D]
      [--num_points 768] [--num_levels 8] [--device {cuda,cpu}]
<seq_dir> is the sequence root (containing mav0/) or mav0 itself. The
session runs on --device: the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("seq_dir")
    ap.add_argument("--cams", default=None,
                    help="comma-separated camera dirs (default: all cam*)")
    ap.add_argument("--use_imu", action="store_true")
    ap.add_argument("--max_frames", type=int, default=None)
    ap.add_argument("--out_dir", default=None)
    ap.add_argument("--num_points", type=int, default=768)
    ap.add_argument("--num_levels", type=int, default=8)
    ap.add_argument("--scale", action="store_true",
                    help="Sim(3) alignment for the final ATE (monocular)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the session runs (default: the card)")
    args = ap.parse_args(argv)

    from mcslam_tpu_torch.apps.evaluate_trajectory import main as evaluate
    from mcslam_tpu_torch.data import euroc
    from mcslam_tpu_torch.data.readers import (ImageFolderReader, ImuStream,
                                               Prefetcher)
    from mcslam_tpu_torch.frontend.frame import build_frame
    from mcslam_tpu_torch.slam import MultiCameraSLAM, SlamConfig

    mav0 = euroc.find_mav0(args.seq_dir)
    cam_dirs = args.cams.split(",") if args.cams else None
    rig, imu_params, cam_dirs = euroc.load_euroc_rig(mav0, cam_dirs,
                                                     device=args.device)
    print(f"[run_euroc] {len(cam_dirs)} cameras {cam_dirs}, "
          f"image {rig.image_size}, imu={'yes' if imu_params else 'no'}, "
          f"device {rig.device}", file=sys.stderr)

    out = Path(args.out_dir) if args.out_dir else mav0.parent / "mcslam_out"
    out.mkdir(parents=True, exist_ok=True)

    use_imu = args.use_imu and imu_params is not None
    slam = MultiCameraSLAM(rig, SlamConfig(),
                           imu_params=imu_params if use_imu else None)
    imu_stream = None
    if use_imu:
        imu_stream = ImuStream.from_csv(mav0 / "imu0" / "data.csv")

    reader = ImageFolderReader(mav0, cam_dirs=cam_dirs)
    n_total = len(reader)
    if args.max_frames:
        n_total = min(n_total, args.max_frames)
    t0 = time.time()
    n = 0
    for imgs, ts in Prefetcher(reader):
        ff = build_frame(
            torch.from_numpy(imgs).to(rig.device), rig,
            num_points=args.num_points, num_levels=args.num_levels,
        )
        if imu_stream is not None:
            slam.process_frame(ff, ts, imu=imu_stream.until(ts))
        else:
            slam.process_frame(ff, ts)
        n += 1
        if n % 50 == 0:
            print(f"[run_euroc] {n}/{n_total} state={slam.state} "
                  f"kfs={slam.stats['keyframes']} "
                  f"{n / (time.time() - t0):.1f} fps", file=sys.stderr)
        if args.max_frames and n >= args.max_frames:
            break

    est_path = out / "trajectory_tum.txt"
    slam.write_trajectory(est_path)
    gt_path = out / "groundtruth_tum.txt"
    try:
        n_gt = euroc.write_groundtruth_tum(mav0, gt_path)
    except FileNotFoundError as e:
        print(f"[run_euroc] no ground truth ({e}); wrote {est_path}",
              file=sys.stderr)
        return 0
    print(f"[run_euroc] {n} frames in {time.time() - t0:.1f}s; "
          f"estimate -> {est_path}, GT ({n_gt} poses) -> {gt_path}",
          file=sys.stderr)

    ev_args = [str(est_path), str(gt_path), "--max_dt", "0.02"]
    if args.scale or rig.num_cams == 1:
        ev_args.append("--scale")
    return evaluate(ev_args)


if __name__ == "__main__":
    sys.exit(main())
