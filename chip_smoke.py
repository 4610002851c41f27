#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mcslam_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on failure:
  1. build: compile the five CUDA kernels from mcslam_tpu_torch/csrc
     (one nvcc per source, in parallel, sm_90a) and print the build time
     and ptxas' resource report;
  2. kernels: call every kernel on the card at the shapes the 4-camera
     VGA frame and the window BA give it and hold it against its plain
     PyTorch version on the same inputs (stated tolerances), printing
     each maximum error; ba_linearize also bitwise equal across two runs;
     track one frame of a small 2-camera scene on the kernels (CUDA) and
     on the plain versions (CPU) and hold the two poses to 1e-3; solve a
     stage-C-shaped window (K=6, Ok=1365, L=2048, C=4) with the warm
     (1 x 2) and the cold (8 x 2) LM budget on the card, under
     torch.cuda.set_sync_debug_mode("error") (the solve must queue with no
     host sync), and hold its poses to the plain solve on the CPU (1e-3);
  3. slice: render the bench.py scene (4 cameras, 640x480, 3000 blob
     landmarks at 4-15 m, 0.02 rad per frame), build frame 0 with
     build_frame, seed the map mirror from its triangulated points, and
     track frames 1-7 with _build_and_track_step against that frame
     under the constant-velocity prediction - once with the production
     fast path and once with the portfolio forced (fastpath_frac=2.0).
     Every frame must pass the driver's acceptance gates and stay within
     0.1 m / 0.02 rad of ground truth; each of the four frame kernels'
     launch counters must be > 0 after this phase (counters are reset
     right before it);
  4. session: all 24 frames of the scene through
     MultiCameraSLAM(rig, SlamConfig(), device=cuda).process_image with
     bench.py's extraction settings (the vision-only driver: rig-depth
     bootstrap, fused frame program, keyframes, window BA on every
     keyframe with deferred write-back). It must end INITIALIZED with no
     failure, >= 7 keyframes and ATE <= 0.1 m after finalize(), and all
     five launch counters must be > 0 (reset right before it);
  5. timing: CUDA-event times of each kernel and of its plain version at
     the same shapes, the warm and cold window solves (CUDA events, plus
     device time and device-op count from one torch.profiler run each),
     the per-frame build+track time on both paths, and the per-frame
     process_image wall time of a second session, keyframe frames and
     the others apart.
The last three lines are the card's name and power limit (nvidia-smi),
the kernels JSON record and {"ok": true, "device": {...}}.
Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# production shape (bench.py) and SlamConfig defaults of the tracking step
C, W, H = 4, 640, 480
NPTS, NLVL, MAXI, BINS = 768, 4, 2048, 16
MAP_CAP, LML = 65536, 4096
STEP = dict(num_hyp=512, px=5.0, max_dist=64, ratio=0.85, lm_radius=18.0,
            lm_max_dist=60, gate_px=100.0, fastpath_min=30)
FASTPATH_FRAC = 0.6
N_FRAMES = 8
MAX_T_ERR, MAX_R_ERR = 0.1, 0.02  # metres, radians vs ground truth
SESSION_FRAMES = 24
MIN_KEYFRAMES, MAX_ATE = 7, 0.1  # the session's gates (keyframes, metres)
BA_ITERS = (("warm", 1), ("cold", 8))  # SlamConfig ba_iters / _cold


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20, warmup=3):
    """Mean milliseconds of fn() on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def rot_err(Ra, Rb) -> float:
    c = (np.trace(Ra.T @ Rb) - 1.0) * 0.5
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


class Scene:
    """The bench.py scene rendered with the port's generator."""

    def __init__(self, dev):
        import torch

        from mcslam_tpu_torch.data import synthetic

        self.rig = synthetic.make_synthetic_rig(
            synthetic.SyntheticRigSpec(num_cams=C, image_size=(W, H)),
            device=dev)
        self.poses = synthetic.smooth_trajectory(SESSION_FRAMES,
                                                 step_angle=0.02)
        lms = synthetic.make_landmarks(3000, depth_range=(4.0, 15.0))
        imgs = synthetic.render_blob_images(self.rig, self.poses, lms)
        self.imgs = [torch.from_numpy(imgs[k]).to(dev)
                     for k in range(SESSION_FRAMES)]
        self.dev = dev

    def frame_kwargs(self):
        return dict(num_points=NPTS, num_levels=NLVL, max_intra=MAXI,
                    angle_bins=BINS)

    def step_kwargs(self, frac):
        return dict(num_points=NPTS, num_levels=NLVL,
                    fast_threshold=20.0 / 255.0, min_threshold=7.0 / 255.0,
                    max_intra=MAXI, min_z=0.5, max_z=40.0, angle_bins=BINS,
                    image_wh=self.rig.image_size, fastpath_frac=frac, **STEP)


def seed_map(ff0, dev):
    """Map mirror seeded from frame 0 as bench.py does (world = frame 0's
    reference frame); viewing normals point from the rig centre to the
    point, the driver's convention (slam.py)."""
    import torch

    M = ff0.im_valid.shape[0]
    valid0 = (ff0.im_valid & ff0.im_has_depth).cpu().numpy()
    prev_lm = torch.from_numpy(
        np.where(valid0, np.arange(M, dtype=np.int32), -1)).to(dev)
    pos = torch.zeros(MAP_CAP, 3, device=dev)
    pos[:M] = ff0.im_point3d
    mvalid = torch.zeros(MAP_CAP, dtype=torch.bool, device=dev)
    mvalid[:M] = torch.from_numpy(valid0).to(dev)
    mdesc = torch.zeros(MAP_CAP, 8, dtype=torch.int32, device=dev)
    mdesc[:M] = ff0.im_desc
    nrm = torch.zeros(MAP_CAP, 3, device=dev)
    nrm[:M] = ff0.im_point3d / torch.clamp(
        torch.linalg.vector_norm(ff0.im_point3d, dim=1, keepdim=True),
        min=1e-6)
    cand = np.flatnonzero(mvalid.cpu().numpy())[:LML]
    cand_pad = np.zeros(LML, np.int32)
    cand_pad[:len(cand)] = cand
    cand_ids = torch.from_numpy(cand_pad).to(dev)
    cand_valid = torch.from_numpy(np.arange(LML) < len(cand)).to(dev)
    return (prev_lm, pos, mvalid, mdesc, nrm, cand_ids, cand_valid), int(
        valid0.sum())


def parse_packed(v: np.ndarray, M: int) -> dict:
    """Driver-side gates of slam._track_frame_fused."""
    n_inl, n_matches, n_lm, rr_ok, fast = v[16:21]
    off = 21 + 3 * M
    ok = not (int(n_matches) < 60 or int(n_lm) < 10 or rr_ok < 0.5
              or int(n_inl) < 10)
    return dict(ok=ok, pose=v[off:off + 16].reshape(4, 4), n_inl=int(n_inl),
                n_matches=int(n_matches), n_lm=int(n_lm), fast=fast > 0.5,
                lm_inliers=int((v[off + 16 + M:] > 0.5).sum()))


def drive(scene, ff0, mapstate, frac, gen_seed=0):
    """Track frames 1..N-1 against frame 0; returns per-frame records."""
    import torch

    from mcslam_tpu_torch import tracking_kernels as tk

    dev = scene.dev
    gen = torch.Generator(device=dev).manual_seed(gen_seed)
    M = ff0.im_valid.shape[0]
    gt0_inv = np.linalg.inv(scene.poses[0])
    last = cur = np.eye(4, dtype=np.float32)
    out = []
    for k in range(1, N_FRAMES):
        pred = (cur @ (np.linalg.inv(last) @ cur)).astype(np.float32)
        *_, packed = tk._build_and_track_step(
            gen, scene.imgs[k], scene.rig, ff0.im_desc, ff0.im_valid,
            *mapstate, torch.from_numpy(pred).to(dev),
            **scene.step_kwargs(frac))
        v = packed.cpu().numpy()
        check(v.shape == (21 + 3 * M + 16 + 2 * M,) and np.all(np.isfinite(v)),
              f"frame {k}: packed buffer malformed or non-finite")
        rec = parse_packed(v, M)
        gt = (gt0_inv @ scene.poses[k]).astype(np.float64)
        rec["t_err"] = float(np.linalg.norm(rec["pose"][:3, 3] - gt[:3, 3]))
        rec["r_err"] = rot_err(rec["pose"][:3, :3].astype(np.float64),
                               gt[:3, :3])
        out.append(rec)
        if rec["ok"]:
            last, cur = cur, rec["pose"].astype(np.float32)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    import mcslam_tpu_torch  # noqa: F401  (sets the f32 matmul policy)
    from mcslam_tpu_torch import _build
    from mcslam_tpu_torch.backend import ba
    from mcslam_tpu_torch.data import synthetic
    from mcslam_tpu_torch.frontend import frame, pose_opt_cuda
    from mcslam_tpu_torch.ops import (ba_cuda, fast_cuda, image as image_ops,
                                      match_cuda, patch_cuda)

    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} ({smi})")
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 must be off")

    # ---- phase 1: build ----
    t0 = time.perf_counter()
    _build.library(verbose=True)
    nvcc_s = _build.BUILD_SECONDS or 0.0
    print(f"# build: nvcc {nvcc_s:.2f} s, build + load "
          f"{time.perf_counter() - t0:.2f} s")
    for line in _build.BUILD_LOG.splitlines():
        if "Used" in line or "Compiling entry" in line or "spill" in line:
            print("#   " + line.strip())

    from mcslam_tpu_torch.slam import INITIALIZED
    from mcslam_tpu_torch.utils import metrics

    scene = Scene(dev)
    rng = np.random.RandomState(0)
    kernels = {}

    # ---- phase 2: kernels against their plain versions ----
    levels = image_ops.build_pyramid(scene.imgs[0], NLVL, 1.2)
    hw = [(lv.shape[-2], lv.shape[-1]) for lv in levels]
    stacked = torch.cat([torch.nn.functional.pad(
        lv[None], (0, W - w, 0, H - h), mode="replicate")[0]
        for lv, (h, w) in zip(levels, hw)]).contiguous()
    h_l = torch.tensor([h for h, _ in hw], dtype=torch.int32,
                       device=dev).repeat_interleave(C)
    w_l = torch.tensor([w for _, w in hw], dtype=torch.int32,
                       device=dev).repeat_interleave(C)
    taps = image_ops._np_gaussian_taps(7, 2.0)
    fs_args = (stacked, 7.0 / 255.0, 20.0 / 255.0, h_l, w_l, taps)
    kb, kv, kr = fast_cuda.fast_select(*fs_args)
    pb, pv, pr = fast_cuda.fast_select_reference(*fs_args)
    torch.cuda.synchronize()
    err_blur = float((kb - pb).abs().max())
    check(torch.equal(kv, pv) and torch.equal(kr, pr),
          "fast_select: candidates differ from the plain version")
    check(err_blur <= 1e-6, f"fast_select: blur error {err_blur} > 1e-6")
    print(f"# kernel fast_select {tuple(stacked.shape)}: candidates exact "
          f"({kv.shape[1]} cells x 4), blur max abs err {err_blur:.3g}")
    kernels["fast_select"] = dict(
        route="cuda", source="mcslam_tpu_torch/csrc/fast_select.cu",
        replaces="mcslam_tpu/ops/fast_pallas.py:283", max_abs_err=err_blur,
        fn=lambda: fast_cuda.fast_select(*fs_args),
        plain=lambda: fast_cuda.fast_select_reference(*fs_args))

    T = C * NPTS
    yx = torch.from_numpy(np.stack([rng.randint(0, H, T), rng.randint(0, W, T)],
                                   -1).astype(np.int32)).to(dev)
    idx = torch.from_numpy(rng.randint(0, NLVL * C, T).astype(np.int32)).to(dev)
    pg_args = (kb, yx, idx)
    kp, ko = patch_cuda.patch_gather(*pg_args)
    pp, po = patch_cuda.patch_gather_reference(*pg_args)
    check(torch.equal(kp, pp) and torch.equal(ko, po),
          "patch_gather: patches or origins differ from the plain version")
    print(f"# kernel patch_gather T={T}: patches and origins exact")
    kernels["patch_gather"] = dict(
        route="cuda", source="mcslam_tpu_torch/csrc/patch_gather.cu",
        replaces="mcslam_tpu/ops/patch_pallas.py:282", max_abs_err=0.0,
        fn=lambda: patch_cuda.patch_gather(*pg_args),
        plain=lambda: patch_cuda.patch_gather_reference(*pg_args))

    ham_errs, ham_calls = [], []
    for (M, N, thr, want_cols) in ((MAXI, MAXI, 100.0, True),
                                   (MAXI, LML, 18.0, False)):
        args = _match_problem(rng, M, N, thr, want_cols, dev)
        kout = match_cuda.hamming_argmin2(*args)
        pout = match_cuda.hamming_argmin2_reference(*args)
        rows, cols = _near_gate(args[2], args[3], thr * thr)
        err = _compare_match(kout, pout, rows, cols, want_cols)
        ham_errs.append(err)
        ham_calls.append(args)
        print(f"# kernel hamming_argmin2 {M}x{N} want_cols={want_cols}: "
              f"indices and distances exact on {int((~rows).sum())}/{M} rows "
              f"away from the gate boundary, max abs err {err:.3g}")
    kernels["hamming_argmin2"] = dict(
        route="cuda", source="mcslam_tpu_torch/csrc/hamming_argmin2.cu",
        replaces="mcslam_tpu/ops/match_pallas.py:121",
        max_abs_err=max(ham_errs),
        fn=lambda: [match_cuda.hamming_argmin2(*a) for a in ham_calls],
        plain=lambda: [match_cuda.hamming_argmin2_reference(*a)
                       for a in ham_calls])

    T_init, data, mask = _pose_problem(rng, 2, MAXI, dev)
    kT, kc = pose_opt_cuda.pose_lm(T_init, data, mask, (8, 8))
    pT, pc = pose_opt_cuda.pose_lm_reference(T_init, data, mask, (8, 8))
    err_pose = float((kT - pT).abs().max())
    inl_k = (mask > 0.5) & (kc < pose_opt_cuda.CHI2_2DOF)
    inl_p = (mask > 0.5) & (pc < pose_opt_cuda.CHI2_2DOF)
    edge = (pc - pose_opt_cuda.CHI2_2DOF).abs() < 1e-3
    check(err_pose <= 2e-3, f"pose_lm: pose error {err_pose} > 2e-3")
    check(bool(torch.all((inl_k == inl_p) | edge)),
          "pose_lm: inlier sets differ away from the chi2 threshold")
    print(f"# kernel pose_lm B=2 M={MAXI}: pose max abs err {err_pose:.3g}, "
          f"inliers equal away from the chi2 edge")
    kernels["pose_lm"] = dict(
        route="cuda", source="mcslam_tpu_torch/csrc/pose_lm.cu",
        replaces="mcslam_tpu/frontend/pose_opt_pallas.py:262",
        max_abs_err=err_pose,
        fn=lambda: pose_opt_cuda.pose_lm(T_init, data, mask, (8, 8)),
        plain=lambda: pose_opt_cuda.pose_lm_reference(T_init, data, mask,
                                                      (8, 8)))

    lin_args = ba.linearize_inputs(ba.problem_from_numpy(
        **synthetic.random_window_ba_problem(scene.rig.to("cpu")),
        device=dev))
    klin = ba_cuda.ba_linearize(*lin_args)
    klin2 = ba_cuda.ba_linearize(*lin_args)
    plin = ba_cuda.ba_linearize_reference(*lin_args)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(klin, klin2)),
          "ba_linearize: two runs of the kernel differ")
    rel = {n: float((klin[i] - plin[i]).abs().max() / plin[i].abs().max())
           for i, n in ((0, "payload"), (3, "Hpp"), (4, "gp"))}
    check(max(rel.values()) <= 1e-5, f"ba_linearize: relative errors {rel}")
    H36 = klin[3].reshape(-1, 6, 6)
    check(torch.equal(H36, H36.transpose(1, 2)), "ba_linearize: Hpp asymmetric")
    check(bool(((klin[1] - plin[1]).abs()
                <= 1e-4 + 1e-6 * plin[1].abs()).all()),
          "ba_linearize: residuals off by more than 1e-4 + 1e-6 |r|")
    err_w = float((klin[2] - plin[2]).abs().max())
    check(err_w <= 1e-5, f"ba_linearize: weight error {err_w} > 1e-5")
    abs_errs = {n: (float((a - b).abs().max()), float(b.abs().max()))
                for n, a, b in zip(("payload", "r", "w", "Hpp", "gp"), klin,
                                   plin)}
    err_lin = max(e for e, _ in abs_errs.values())
    print(f"# kernel ba_linearize K=6 Ok=1365 L=2048 C=4: bitwise equal "
          f"across two runs; max abs err (largest magnitude) per output: "
          + ", ".join(f"{n} {e:.3g} ({m:.3g})"
                      for n, (e, m) in abs_errs.items()))
    kernels["ba_linearize"] = dict(
        route="cuda", source="mcslam_tpu_torch/csrc/ba_linearize.cu",
        replaces="mcslam_tpu/ops/ba_pallas.py:136", max_abs_err=err_lin,
        fn=lambda: ba_cuda.ba_linearize(*lin_args),
        plain=lambda: ba_cuda.ba_linearize_reference(*lin_args))

    solve_problem = _window_solves(scene, dev)

    err_small = _small_scene_cpu_vs_cuda(dev)
    print(f"# reference check, 2-camera 192x144 frame on the kernels (CUDA) "
          f"vs the plain versions (CPU): pose max abs err {err_small:.3g}")

    # ---- phase 3: the slice, launches counted ----
    mods = {"fast_select": fast_cuda, "patch_gather": patch_cuda,
            "hamming_argmin2": match_cuda, "pose_lm": pose_opt_cuda}
    for m in mods.values():
        m.LAUNCHES = 0
    ff0 = frame.build_frame(scene.imgs[0], scene.rig, **scene.frame_kwargs())
    mapstate, n_seed = seed_map(ff0, dev)
    check(n_seed >= 200, f"frame 0 seeded only {n_seed} landmarks")
    print(f"# slice: frame 0 keypoints {int(ff0.kp_valid.sum())}, intra "
          f"groups {int(ff0.im_valid.sum())}, seeded landmarks {n_seed}")
    results = {}
    for name, frac in (("fast", FASTPATH_FRAC), ("portfolio", 2.0)):
        recs = drive(scene, ff0, mapstate, frac)
        results[name] = recs
        for k, r in enumerate(recs, start=1):
            print(f"#   {name} frame {k}: tracked={r['ok']} fastpath={r['fast']} "
                  f"matches={r['n_matches']} with_lm={r['n_lm']} "
                  f"inliers={r['n_inl']} localmap_inliers={r['lm_inliers']} "
                  f"t_err={r['t_err']:.4f} m r_err={r['r_err']:.5f} rad")
            check(r["ok"], f"{name} frame {k}: not tracked")
            check(r["t_err"] <= MAX_T_ERR and r["r_err"] <= MAX_R_ERR,
                  f"{name} frame {k}: pose error {r['t_err']:.4f} m / "
                  f"{r['r_err']:.5f} rad over {MAX_T_ERR} / {MAX_R_ERR}")
    check(not any(r["fast"] for r in results["portfolio"]),
          "forced-portfolio drive took the fast path")
    launches = {n: m.LAUNCHES for n, m in mods.items()}
    print(f"# launches during the slice: {launches}")
    for n, c in launches.items():
        check(c > 0, f"kernel {n} was not launched on the slice's path")

    # ---- phase 4: the vision-only session, launches counted ----
    mods["ba_linearize"] = ba_cuda
    for m in mods.values():
        m.LAUNCHES = 0
    slam, _ = run_session(scene, dev)
    launches = {n: m.LAUNCHES for n, m in mods.items()}
    _, est = slam.trajectory_arrays()
    ate = metrics.ate_rmse(est, scene.poses)
    print(f"# session: {SESSION_FRAMES} frames, state {slam.state}, "
          f"keyframes {slam.stats['keyframes']}, failures "
          f"{slam.stats['failures']}, window solves "
          f"{slam.stats.get('window_ba', 0)}, fast-path frames "
          f"{slam.stats.get('track_fastpath', 0)}/"
          f"{slam.stats.get('track_dispatch', 0)}, ATE {ate:.4f} m")
    for line in slam.timers.report().splitlines():
        print("#   " + line)
    print(f"# launches during the session: {launches}")
    check(slam.state == INITIALIZED, "session: not INITIALIZED at the end")
    check(slam.stats["failures"] == 0,
          f"session: {slam.stats['failures']} tracking failures")
    check(slam.stats["keyframes"] >= MIN_KEYFRAMES,
          f"session: {slam.stats['keyframes']} keyframes < {MIN_KEYFRAMES}")
    check(np.all(np.isfinite(est)) and est.shape == (SESSION_FRAMES, 4, 4),
          "session: trajectory malformed or non-finite")
    check(ate <= MAX_ATE, f"session: ATE {ate:.4f} m > {MAX_ATE}")
    for n, c in launches.items():
        check(c > 0, f"kernel {n} was not launched on the main path")
        kernels[n]["launches"] = c

    # ---- phase 5: timing ----
    for n, k in kernels.items():
        fn = k.pop("fn")
        k["ms"] = cuda_ms(fn)
        k["plain_ms"] = cuda_ms(k.pop("plain"), reps=5, warmup=1)
        dev_ms, n_ops = device_profile(fn)
        print(f"# time {n}: kernel {k['ms']:.4f} ms, plain {k['plain_ms']:.4f}"
              f" ms by CUDA events; profiler: the wrapper's call is "
              f"{dev_ms:.4f} ms of device time in {n_ops} device ops ({smi})")
    for name, iters in BA_ITERS:
        def solve():
            return ba.ba_solve(solve_problem, iters=iters, gate_rounds=2)
        ms = cuda_ms(solve, reps=5, warmup=1)
        dev_ms, n_ops = device_profile(solve)
        print(f"# time ba_solve {name} ({iters} x 2): {ms:.3f} ms by CUDA "
              f"events; profiler: {dev_ms:.3f} ms device time in {n_ops} "
              f"device ops ({smi})")
    for name, frac in (("fast path", FASTPATH_FRAC), ("full path", 2.0)):
        ms = _frame_ms(scene, ff0, mapstate, frac)
        print(f"# per-frame build+track, {name}: {ms:.3f} ms ({smi})")
    _, times = run_session(scene, dev)
    wall_ms = sum(t for t, _ in times) * 1e3
    dev_ms, n_ops = device_profile(lambda: run_session(scene, dev))
    print(f"# session of {SESSION_FRAMES} frames: {wall_ms:.1f} ms wall; a "
          f"profiled repeat: {dev_ms:.1f} ms device time in {n_ops} device "
          f"ops, device busy {100 * dev_ms / wall_ms:.1f} % of the "
          f"unprofiled wall time ({smi})")
    for name, sel in (("init frame", [0]),
                      ("keyframe frames", [k for k, (_, kf) in
                                           enumerate(times) if kf]),
                      ("other frames", [k for k, (_, kf) in
                                        enumerate(times) if k and not kf])):
        ms = [times[k][0] * 1e3 for k in sel]
        print(f"# per-frame process_image wall, {name} (n={len(ms)}): mean "
              f"{np.mean(ms):.3f} ms, median {np.median(ms):.3f} ms, max "
              f"{np.max(ms):.3f} ms ({smi})")

    print(smi)
    print(json.dumps({"kernels": [dict(name=n, **k)
                                  for n, k in kernels.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_session(scene, dev):
    """All SESSION_FRAMES frames through the driver's entry point ->
    (slam, [(wall seconds, keyframe?) per frame]); finalize()d."""
    from mcslam_tpu_torch.slam import MultiCameraSLAM, SlamConfig

    slam = MultiCameraSLAM(scene.rig, SlamConfig(), device=dev)
    times = []
    for k in range(SESSION_FRAMES):
        t0 = time.perf_counter()
        info = slam.process_image(scene.imgs[k], k / 20.0,
                                  extract_cfg=scene.frame_kwargs())
        times.append((time.perf_counter() - t0, info["keyframe"]))
    slam.finalize()
    return slam, times


def _window_solves(scene, dev):
    """A consistent window problem at the stage C shape (K=6, Ok=1365,
    L=2048, C=4; 0.5 px noise, 5 % outliers, perturbed poses) solved with
    the warm and the cold budget on the card - with host syncs turned into
    errors - and by the plain path on the CPU: poses within 1e-3.
    Returns the problem on the card."""
    import torch

    from mcslam_tpu_torch.backend import ba
    from mcslam_tpu_torch.data import synthetic

    f = synthetic.random_window_ba_problem(scene.rig.to("cpu"), px_noise=0.5)
    p_cpu = ba.problem_from_numpy(**f)
    p_dev = ba.problem_from_numpy(**f, device=dev)
    for name, iters in BA_ITERS:
        ref = ba.ba_solve(p_cpu, iters=iters, gate_rounds=2)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            res = ba.ba_solve(p_dev, iters=iters, gate_rounds=2)
            enqueue_ms = (time.perf_counter() - t0) * 1e3
        finally:
            torch.cuda.set_sync_debug_mode(0)
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        wait_ms = (time.perf_counter() - t0) * 1e3
        poses = res.poses.cpu()
        check(bool(torch.isfinite(poses).all()), f"ba_solve {name}: non-finite")
        err = float((poses - ref.poses).abs().max())
        moved = float((ref.poses - p_cpu.poses).abs().max())
        check(err <= 1e-3, f"ba_solve {name}: card vs CPU pose error {err}")
        print(f"# ba_solve {name} ({iters} x 2) K=6 Ok=1365 L=2048: queued "
              f"with no host sync in {enqueue_ms:.2f} ms, then {wait_ms:.2f} "
              f"ms to finish; poses vs the CPU plain solve max abs err "
              f"{err:.3g} (the solve moved them {moved:.3g}); inliers "
              f"{int(res.num_inliers)} card, {int(ref.num_inliers)} CPU")
    return p_dev


def device_profile(fn):
    """(device ms, device ops) of one fn() from a torch.profiler CUDA
    trace: the summed duration and count of the device-side events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in evs) / 1e3, len(evs)


def _match_problem(rng, M, N, thr, want_cols, dev, C_=4):
    """Random descriptors (with duplicate targets for ties) and gate
    factors from random projections, as tests/test_match_pallas.py."""
    import torch

    from mcslam_tpu_torch import tracking_kernels as tk
    from mcslam_tpu_torch.ops import hamming

    a = rng.randint(0, 2**32, (M, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.randint(0, 2**32, (N, 8), dtype=np.uint64).astype(np.uint32)
    b[N // 2] = a[0]
    b[N // 2 + 1] = a[0]
    uv = rng.rand(M, 2).astype(np.float32) * 600.0
    anchor = rng.randint(0, C_, M).astype(np.int32)
    proj = rng.rand(C_, N, 2).astype(np.float32) * 600.0
    proj[:, : N // 2] = uv[rng.randint(0, M, N // 2)][None] + rng.randn(
        C_, N // 2, 2).astype(np.float32) * thr * 0.5
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    ahat, bhat = tk._gate_factors(
        t(uv), t(anchor), t(proj), t(rng.rand(C_, N) < 0.1),
        t(rng.rand(M) < 0.1), t(rng.rand(N) < 0.1),
        col_pass=t(rng.rand(N) < 0.3) if want_cols else None)
    return (hamming.desc_to_torch(a, dev), hamming.desc_to_torch(b, dev),
            ahat, bhat, thr * thr, want_cols)


def _near_gate(ahat, bhat, thr2, rel=1e-3):
    """Rows / columns with a pair whose gate distance (in f64) lies within
    rel * thr2 of the threshold: there the two f32 summation orders may
    gate differently."""
    d2 = ahat.double() @ bhat.double()
    near = (d2 - thr2).abs() < rel * thr2
    return near.any(dim=1), near.any(dim=0)


def _compare_match(kout, pout, rows, cols, want_cols) -> float:
    import torch

    kb, ks, ki, kc = kout
    pb, ps, pi, pc = pout
    keep = ~rows
    check(torch.equal(ki[keep], pi[keep]), "hamming_argmin2: row argmin differs")
    check(torch.equal(kb[keep], pb[keep]) and torch.equal(ks[keep], ps[keep]),
          "hamming_argmin2: row best/second differ")
    if want_cols:
        check(torch.equal(kc[~cols], pc[~cols]),
              "hamming_argmin2: column argmin differs")
    return float(torch.maximum((kb - pb)[keep].abs().max(),
                               (ks - ps)[keep].abs().max()))


def _pose_problem(rng, B, M, dev):
    """Two initial poses against one noisy 4-camera resectioning problem
    with outliers (as tests/test_pose_opt_pallas.py builds it)."""
    import torch

    from mcslam_tpu_torch.frontend import pose_opt_cuda
    from mcslam_tpu_torch.geometry import lie

    X = (rng.uniform(-6, 6, (M, 3)) + [0, 0, 10]).astype(np.float32)
    xi = torch.tensor([0.03, -0.05, 0.02, 0.2, -0.1, 0.15])
    T_true = lie.se3_exp(xi).numpy()
    cam = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    cam[:, 0, 3] = 0.1 * np.arange(C)
    anchor = rng.randint(0, C, M)
    f = np.array([400.0, 400.0, 320.0, 240.0], np.float32)
    rTw = np.linalg.inv(T_true)
    q = X @ rTw[:3, :3].T + rTw[:3, 3]
    p = np.einsum("mij,mj->mi", cam[anchor, :3, :3], q) + cam[anchor, :3, 3]
    uv = (p[:, :2] / p[:, 2:] * f[:2] + f[2:]).astype(np.float32)
    uv += rng.normal(0, 0.3, (M, 2)).astype(np.float32)
    out = rng.rand(M) < 0.15
    uv[out] += rng.uniform(-60, 60, (out.sum(), 2)).astype(np.float32)
    sig2 = ((1.2 ** rng.randint(0, 4, M)) ** 2).astype(np.float32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa
    data = pose_opt_cuda._pack_obs(t(X), t(uv), t(cam[anchor]),
                                   t(np.tile(f, (M, 1))), t(1.0 / sig2))
    T_init = t(np.stack([np.eye(4, dtype=np.float32)] * B))
    mask = np.ones((B, M), np.float32)
    mask[1, ::2] = 0.0
    return T_init, data, t(mask)


def _small_scene_cpu_vs_cuda(dev) -> float:
    """One frame of a small 2-camera scene (1 pyramid level, so both
    devices see the same image) tracked on the kernels' path (CUDA) and on
    the plain path (CPU): packed poses within 1e-3, counts within 2 %."""
    import torch

    from mcslam_tpu_torch import tracking_kernels as tk
    from mcslam_tpu_torch.data import synthetic
    from mcslam_tpu_torch.frontend import frame

    rig = synthetic.make_synthetic_rig(synthetic.SyntheticRigSpec(
        num_cams=2, image_size=(192, 144), focal=130.0))
    poses = synthetic.smooth_trajectory(2, step_angle=0.02)
    imgs = synthetic.render_blob_images(
        rig, poses, synthetic.make_landmarks(600, depth_range=(4.0, 15.0)))
    kw = dict(num_points=128, num_levels=1, max_intra=256, angle_bins=16)
    out = []
    for d in (torch.device("cpu"), dev):
        r = rig.to(d)
        ff0 = frame.build_frame(torch.from_numpy(imgs[0]).to(d), r, **kw)
        v0 = ff0.im_valid & ff0.im_has_depth
        ids = torch.arange(v0.shape[0], dtype=torch.int32, device=d)
        cand = torch.nonzero(v0)[:, 0].to(torch.int32)
        cand_ids = torch.zeros(256, dtype=torch.int32, device=d)
        cand_ids[:len(cand)] = cand
        nrm = ff0.im_point3d / torch.clamp(
            ff0.im_point3d.norm(dim=1, keepdim=True), min=1e-6)
        *_, p = tk._build_and_track_step(
            torch.Generator(device=d).manual_seed(0),
            torch.from_numpy(imgs[1]).to(d), r, ff0.im_desc, ff0.im_valid,
            torch.where(v0, ids, torch.full_like(ids, -1)), ff0.im_point3d,
            v0, ff0.im_desc, nrm, cand_ids,
            torch.arange(256, device=d) < len(cand), torch.eye(4, device=d),
            fast_threshold=20.0 / 255.0, min_threshold=7.0 / 255.0,
            min_z=0.5, max_z=40.0, image_wh=rig.image_size,
            fastpath_frac=FASTPATH_FRAC, **dict(STEP, num_hyp=64), **kw)
        out.append(p.cpu().numpy())
    cpu, gpu = out
    M = kw["max_intra"]
    off = 21 + 3 * M
    err = float(max(np.abs(gpu[:16] - cpu[:16]).max(),
                    np.abs(gpu[off:off + 16] - cpu[off:off + 16]).max()))
    check(err <= 1e-3, f"small scene: CUDA vs CPU pose error {err} > 1e-3")
    check(np.all(np.abs(gpu[16:19] - cpu[16:19]) <= 0.02 * cpu[16:19]),
          f"small scene: counts differ {gpu[16:19]} vs {cpu[16:19]}")
    return err


def _frame_ms(scene, ff0, mapstate, frac, n=6) -> float:
    """Host-clock ms per frame of _build_and_track_step (warm), ending in
    a synchronize; frames cycle through the drive."""
    import torch

    from mcslam_tpu_torch import tracking_kernels as tk

    gen = torch.Generator(device=scene.dev).manual_seed(1)
    eye = torch.eye(4, device=scene.dev)

    def one(k):
        *_, packed = tk._build_and_track_step(
            gen, scene.imgs[k], scene.rig, ff0.im_desc, ff0.im_valid,
            *mapstate, eye, **scene.step_kwargs(frac))
        return packed

    one(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        one(1 + i % 2)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


if __name__ == "__main__":
    sys.exit(main())
