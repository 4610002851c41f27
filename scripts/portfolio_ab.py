"""Times the frame step with its pose portfolio forced, the fast-path
frame and one RANSAC-PnP of a loop verification, for two trees of the
port on one CUDA card, in turns (parent, this tree, this tree, parent).

    mkdir -p mcslam_tpu_torch/_build/parent
    git archive <parent commit> | tar -x -C mcslam_tpu_torch/_build/parent
    python3 scripts/portfolio_ab.py --parent mcslam_tpu_torch/_build/parent

Each turn is a process of its own that imports `mcslam_tpu_torch` and
`chip_smoke` from its tree (each tree builds its own kernels into its own
`mcslam_tpu_torch/_build/`). On chip_smoke.py's bench scene (4 cameras,
VGA) with frame 0's map, per tree:
- the eager `_build_and_track_step` of frames 1-2 at the production
  fastpath_frac (the fast path) and at 2.0 (the portfolio forced): host
  ms per frame ending in a synchronize (chip_smoke._frame_ms, 6 frames),
  and device ms and device ops per frame from a torch.profiler trace;
- `ransac.ransac_pnp` as a loop verification calls it (K = 256, S = 6)
  on the correspondences that frame 1's forced-portfolio step hands its
  PnP RANSAC, ending in the host read of (ok, count) as
  `loop/reloc.verify_pnp` does: host ms (median of 20), device ms and
  device ops;
- the graphed fast-path frame (frame 1 through a captured program of the
  step with the branch on the device, utils/graphs.ProgramCache, ending
  in the packed fetch): host ms (chip_smoke._median_ms), device ms and
  device ops;
- the RANSAC kernels at the calls of frame 1's forced-portfolio step
  (`ransac_cuda.score` at K = 1, 512, 256 and 3, `ransac_cuda.pnp_hyp`
  at K = 256): the kernel's device ms per call (profiler, 20 calls, the
  kernel's own events) and the wrapper's ms per call (CUDA events, 20
  calls), as host ms and device ms of the line.
Prints one line per turn and measure, with the card's name and power
limit, and the means of the two turns of each tree.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
TURNS = ("parent", "this", "this", "parent")


def measure(root: str) -> dict:
    """The measures of the tree at root (run in a process of its own)."""
    t_start = time.perf_counter()
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from mcslam_tpu_torch import tracking_kernels as tk
    from mcslam_tpu_torch.frontend import frame, ransac, ransac_cuda
    from mcslam_tpu_torch.utils import graphs

    check_root = pathlib.Path(cs.__file__).resolve().parent
    cs.check(check_root == pathlib.Path(root).resolve(),
             f"chip_smoke came from {check_root}, not {root}")
    dev = torch.device("cuda", 0)
    scene = cs.Scene(dev, frames=3)
    ff0 = frame.build_frame(scene.imgs[0], scene.rig, **scene.frame_kwargs())
    mapstate, _ = cs.seed_map(ff0, dev)
    out = {"smi": cs.nvidia_smi_line()}
    for name, frac in (("fast-path frame", cs.FASTPATH_FRAC),
                       ("forced-portfolio frame", 2.0)):
        ms = cs._frame_ms(scene, ff0, mapstate, frac)
        dev_ms, n_ops, _ = cs.device_profile(lambda: cs._frame_ms(
            scene, ff0, mapstate, frac, n=1, warm=False))
        out[name] = dict(host_ms=ms, device_ms=dev_ms, device_ops=n_ops)

    # the graphed fast-path frame
    eye = torch.eye(4, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    cache = graphs.ProgramCache(dev, gen)

    def step(imgs, pred):
        return tk._build_and_track_step(
            gen, imgs, scene.rig, ff0.im_desc, ff0.im_valid, *mapstate, pred,
            branch="device", **scene.step_kwargs(cs.FASTPATH_FRAC))

    _, prog = cache(cs.FASTPATH_FRAC, step, (scene.imgs[1], eye))

    def graphed():
        return prog(scene.imgs[1], eye)[-1].cpu()

    ms = cs._median_ms(graphed)
    dev_ms, n_ops, _ = cs.device_profile(graphed)
    out["graphed fast-path frame"] = dict(host_ms=ms, device_ms=dev_ms,
                                          device_ops=n_ops)

    # the RANSAC inputs in frame 1's forced-portfolio step
    gen = torch.Generator(device=dev).manual_seed(0)
    seen = cs.capture_all(lambda: tk._build_and_track_step(
        gen, scene.imgs[1], scene.rig, ff0.im_desc, ff0.im_valid, *mapstate,
        eye, **scene.step_kwargs(2.0)), {
            "ransac_pnp": (ransac, "ransac_pnp"),
            "score": (ransac_cuda, "score"),
            "pnp_hyp": (ransac_cuda, "pnp_hyp")})
    for name, sym in (("score", "ransac_score_kernel"),
                      ("pnp_hyp", "pnp_hyp_kernel")):
        fn = getattr(ransac_cuda, name)
        for a, kw in seen[name]:
            def call(a=a, kw=kw, fn=fn):
                return fn(*a, **kw)
            _, n_ops, k_ms = cs.device_profile(call, reps=20, names=(sym,))
            out[f"{sym} K={a[0].shape[0]} (wrapper as host ms)"] = dict(
                host_ms=cs.cuda_ms(call), device_ms=k_ms, device_ops=n_ops)
    a, kw = seen["ransac_pnp"][0]
    args = a[1:6]  # X_world, uv, cam_T_ref, fxycxy, mask
    gen = torch.Generator(device=dev).manual_seed(0)

    def verify():
        rr = ransac.ransac_pnp(gen, *args, num_hyp=256, px_thresh=5.0,
                               min_inliers=10)
        return torch.stack([rr.ok.to(torch.int32), rr.num_inliers]).cpu()

    for _ in range(3):
        verify()
    ms = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        verify()
        ms.append((time.perf_counter() - t0) * 1e3)
    dev_ms, n_ops, _ = cs.device_profile(verify)
    out["ransac_pnp (loop verification)"] = dict(
        host_ms=float(np.median(ms)), device_ms=dev_ms, device_ops=n_ops,
        M=int(args[0].shape[0]))
    out["seconds"] = time.perf_counter() - t_start
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True,
                    help="root of the parent tree (a git archive)")
    ap.add_argument("--measure", help=argparse.SUPPRESS)
    opt = ap.parse_args()
    if opt.measure:
        print(json.dumps(measure(opt.measure)), flush=True)
        # flushed, then os._exit: after torch.profiler's CUDA traces the
        # interpreter's native finalization can hang (a turn of this tree
        # did, on an NVIDIA H100 under torch 2.11; scripts/orb_variants.py)
        os._exit(0)
    roots = {"parent": str(pathlib.Path(opt.parent).resolve()),
             "this": str(ROOT)}
    got = {t: [] for t in roots}
    for turn in TURNS:
        r = subprocess.run(
            [sys.executable, str(pathlib.Path(__file__).resolve()),
             "--parent", opt.parent, "--measure", roots[turn]],
            capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            print(r.stdout[-4000:] + r.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(r.stdout.strip().splitlines()[-1])
        got[turn].append(res)
        print(f"# {turn} tree's turn: {res.pop('seconds'):.1f} s",
              flush=True)
        for name, m in res.items():
            if name != "smi":
                print(f"# {turn} tree, {name}: host {m['host_ms']:.4f} ms, "
                      f"device {m['device_ms']:.4f} ms in "
                      f"{m['device_ops']:.0f} ops ({res['smi']})", flush=True)
    for turn, runs in got.items():
        for name in runs[0]:
            if name == "smi":
                continue
            med = {k: sum(r[name][k] for r in runs) / len(runs)
                   for k in ("host_ms", "device_ms", "device_ops")}
            print(f"# {turn} tree, {name}, mean of two turns: host "
                  f"{med['host_ms']:.4f} ms, device {med['device_ms']:.4f} ms "
                  f"in {med['device_ops']:.1f} ops ({runs[0]['smi']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
