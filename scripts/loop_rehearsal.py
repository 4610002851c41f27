#!/usr/bin/env python3
"""CPU rehearsal of chip_smoke.py phase 9 (loop closure and
relocalization), at its full sizes, with the plain PyTorch versions.

    python3 scripts/loop_rehearsal.py [--seeds 2] [--parts bcde]

(b) the full-width loop session (chip_smoke.loop_session) once per RANSAC
seed of MultiCameraSLAM: state, keyframes, failures, loops, PGO bends,
global BA runs and the ATE that phase 9's LOOP_MAX_ATE sits against;
(c) the drift scene with and without loop closure (ATE of each, and
how far each keyframe's own landmarks reproject from its observations:
the range over keyframes of the per-keyframe median, in px);
(d) the retrieval corpus' precision, recall and false fires; (e)
relocalization and fast-tracking errors against (c)'s saved map. The
card draws other random numbers than the CPU, so the gates sit against
this spread, not against one run. Imports no JAX.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import tempfile
import time


def reprojection_medians(slam):
    """Per keyframe, the median pixel distance between its anchor
    observations and the projections of the landmarks it references."""
    import numpy as np

    cTr = slam.rig.cam_T_ref.cpu().numpy()
    f = slam.rig.fxycxy.cpu().numpy()
    out = []
    for kf in slam.keyframes:
        s = np.flatnonzero((kf.lm_id >= 0)
                           & slam.map.valid[np.maximum(kf.lm_id, 0)])
        if not len(s):
            continue
        rTw = np.linalg.inv(kf.world_T_ref)
        c = kf.im_anchor_cam[s]
        X = slam.map.pos[kf.lm_id[s]] @ rTw[:3, :3].T + rTw[:3, 3]
        p = np.einsum("nij,nj->ni", cTr[c, :3, :3], X) + cTr[c, :3, 3]
        uv = p[:, :2] / p[:, 2:] * f[c, :2] + f[c, 2:]
        out.append(float(np.median(np.linalg.norm(uv - kf.im_uv[s],
                                                  axis=-1))))
    return min(out), max(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--parts", default="bcde")
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import torch

    import chip_smoke as cs
    from mcslam_tpu_torch.utils import metrics

    dev = torch.device("cpu")
    if "b" in args.parts:
        for seed in range(args.seeds):
            t0 = time.perf_counter()
            slam, poses, _, _ = cs.loop_session(dev, seed=seed)
            _, est = slam.trajectory_arrays()
            st = slam.stats
            print(f"(b) loop session seed {seed}: state {slam.state}, "
                  f"keyframes {st['keyframes']}, failures {st['failures']}, "
                  f"loops {st['loops']}, PGO bends {st.get('pgo', 0)}, "
                  f"global BA {st.get('global_ba', 0)}, ATE "
                  f"{metrics.ate_rmse(est, poses):.4f} m "
                  f"({time.perf_counter() - t0:.0f} s)", flush=True)
    if "c" in args.parts or "e" in args.parts:
        loop, vo, poses, rig, ffs, vocab, _ = cs.drift_runs(dev)
        print(f"(c) drift scene: loops {loop.stats['loops']}, PGO bends "
              f"{loop.stats.get('pgo', 0)}, failures "
              f"{loop.stats['failures']}, ATE with loop closure "
              f"{metrics.ate_rmse(loop.trajectory_arrays()[1], poses):.4f} "
              f"m, VO only "
              f"{metrics.ate_rmse(vo.trajectory_arrays()[1], poses):.4f} m;"
              f" per-keyframe reprojection medians {reprojection_medians(loop)}"
              f" px with loop closure, {reprojection_medians(vo)} px VO only",
              flush=True)
        if "e" in args.parts:
            with tempfile.TemporaryDirectory() as tmp:
                *_, err_r, err_t = cs.reloc_checks(dev, loop, vocab, rig, ffs,
                                                   poses, tmp)
            print(f"(e) relocalization error {err_r:.4f} m, fast-tracking "
                  f"error {err_t:.4f} m", flush=True)
    if "d" in args.parts:
        t0 = time.perf_counter()
        corpus = cs.retrieval_corpus(dev)
        p, r, ff, fires = cs.retrieval_gates(dev, corpus)
        print(f"(d) retrieval corpus: fires {fires}, precision {p:.3f}, "
              f"recall {r:.3f}, false fires {ff} "
              f"({time.perf_counter() - t0:.0f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
