#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mcslam_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on failure:
  1. build: compile the nine CUDA kernels' five sources from
     mcslam_tpu_torch/csrc (one nvcc per source, in parallel, sm_90a) and
     print the build time and ptxas' resource report, then registers,
     shared memory, stack and spills of the redesigned kernels (the pose
     LM's cluster kernel, the three FAST kernels, ba_linearize's cluster
     kernel and the oriented patch gather must use no local memory and
     spill nothing) and the cluster sizes of the pose LM (per candidate)
     and of ba_linearize (per keyframe), each more than one CTA;
  2. kernels: call every kernel on the card at the shapes the 4-camera
     VGA frame and the window BA give it and hold it against its plain
     PyTorch version on the same inputs (stated tolerances), printing
     each maximum error: fast_select (on the bench stack and on uniform
     noise, with the share of pixels that pass the compass pre-test) and
     fast_corners in its four modes
     ({hskip, full} x {blur, no blur}; scores and blur exact, the blur
     also equal to fast_select's), the three patch gathers (patches and
     origins exact; oriented: bf16 patches, moments and origins bitwise
     equal, also across two runs), the gated matcher, the pose LM at B = 1
     and B = 2, and ba_linearize through the solve's prepared call (these
     three also bitwise equal across two runs); track one frame of a
     small 2-camera scene on the kernels
     (CUDA) and on the plain versions (CPU) and hold the two poses to
     1e-3; solve a stage-C-shaped window (K=6, Ok=1365, L=2048, C=4) with
     the warm (1 x 2) and the cold (8 x 2) LM budget on the card, under
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
  4. routes: the same 8-frame drive on the fast path under the two other
     extraction routes (ops.orb.OrbRoute): route A (score map with blur,
     selection outside the kernel, late compaction: fast_corners in mode
     hskip and patch_gather_batched) and route B (standalone blur, score
     map without the skip, oriented gather: fast_corners in mode full and
     patch_gather_oriented), counters reset before each; both must track
     7/7 frames within the same gates and launch their kernels, and not
     fast_select. Frame 0 under route A must have the default route's
     keypoints and descriptors (a descriptor may differ only at a
     keypoint within 1e-4 rad of a steering-bin boundary); under route B
     also where its BRIEF samples reach the stacked image's 3-px border
     (the standalone blur reflects there, the fused one clamps rows and
     wraps columns as the TPU kernel's lane roll does); the counts are
     printed;
  5. sessions: all 24 frames of the scene through
     MultiCameraSLAM(rig, SlamConfig()).process_image (the rig, and so
     the session, on the card by default) with bench.py's extraction
     settings (the vision-only driver: rig-depth bootstrap, fused frame
     program, keyframes, window BA on every keyframe with deferred
     write-back). It must end INITIALIZED with no failure, >= 7 keyframes
     and ATE <= 0.1 m after finalize(), and all five default-route launch
     counters must be > 0 (reset right before it); then 12 frames under
     route B: INITIALIZED, no failure, ATE <= 0.1 m;
  6. bootstraps: (a) 2 blank frames, then 12 bench frames through
     process_image: NOT_INITIALIZED on the blank frames (pending 17-point
     anchors), INITIALIZED on frame 2, no failure, ATE <= 0.1 m; (b) a
     1-camera 640x480 session of 16 frames through process_image: the
     monocular bootstrap, >= 3 keyframes, Sim(3) ATE from the init frame
     <= 0.15 m (calibrated on the CPU); (c) a distant 4-camera scene at
     VGA (the rig of tests/test_seventeen.py, landmarks at 100-200 m)
     through build_frame_from_keypoints + process_frame: init_17pt >= 1,
     no failure, and that test's gates: Sim(3) ATE < 0.40 m, path length
     within 0.2-5x the truth; each with its launch counters reset
     right before it (ba_linearize, the matcher and the pose LM launched in
     all three, the extraction kernels in (a) and (b)), printing the
     host-clock time of the frames up to the init;
  7. timing: for each kernel the CUDA-event time of its wrapper call, of
     its plain version and, where one exists, of the one PyTorch call
     that computes the same function (the advanced-indexing gather for
     the two plain patch gathers); its device time and the wrapper's
     from torch.profiler (a trace that misses the kernel fails the run);
     and the least time the card could take for the work (bytes at 3.35
     TB/s or operations, the larger: at 67 TFLOP/s, or for the FAST rows
     by instruction class, counting the arc trees only where this run's
     data passes the compass pre-test),
     the pose LM at B = 2 and at B = 1 (the record's "at_b1"), fast_select
     on uniform noise (the record's "on_noise"), ba_linearize's wrapper the
     solve's prepared call (one device op per call, checked);
     the warm and cold window solves (CUDA events, plus device time and
     device-op count from one torch.profiler run each), the per-frame
     build+track time on both paths and both routes, and the per-frame
     process_image wall time of a second session, keyframe frames and the
     others apart.
The last three lines are the card's name and power limit (nvidia-smi),
the kernels JSON record and {"ok": true, "device": {...}}.
Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np

# production shape (bench.py) and SlamConfig defaults of the tracking step
C, W, H = 4, 640, 480
NPTS, NLVL, MAXI, BINS = 768, 4, 2048, 16
MIN_THR, FAST_THR = 7.0 / 255.0, 20.0 / 255.0
MAP_CAP, LML = 65536, 4096
STEP = dict(num_hyp=512, px=5.0, max_dist=64, ratio=0.85, lm_radius=18.0,
            lm_max_dist=60, gate_px=100.0, fastpath_min=30)
FASTPATH_FRAC = 0.6
N_FRAMES = 8
MAX_T_ERR, MAX_R_ERR = 0.1, 0.02  # metres, radians vs ground truth
SESSION_FRAMES, ROUTE_B_FRAMES = 24, 12
MIN_KEYFRAMES, MAX_ATE = 7, 0.1  # the session's gates (keyframes, metres)
BA_ITERS = (("warm", 1), ("cold", 8))  # SlamConfig ba_iters / _cold
# the bootstrap phase: (a) blank frames before the bench frames; (b) a
# 1-camera VGA session (mono_session), its Sim(3)-aligned ATE from the
# initializing frame on held to MONO_MAX_ATE; (c) a distant 4-camera
# scene (far_session) at FAR_DEPTH metres, where rig depth at max_z 60 m
# stays below 30 points, held to tests/test_seventeen.py's gates (Sim(3)
# ATE < 0.40 m, path length 0.2-5x the truth). At the JAX test's
# 150-300 m the metric scale is observed so weakly at this size that the
# spread over RANSAC draws comes close to or past those gates.
# scripts/bootstrap_calibration.py runs (b) and (c) over RANSAC seeds on
# the CPU and prints the spread the gates are set against (PERF.md).
BLANK_FRAMES, BOOT_FRAMES = 2, 12
MONO_FRAMES, MONO_MIN_KEYFRAMES, MONO_MAX_ATE = 16, 3, 0.15
FAR_FRAMES, FAR_MAX_ATE, FAR_DEPTH = 8, 0.40, (100.0, 200.0)
PATCH_PX = 39 * 39

# The least time of a kernel's work: bytes over the H100 SXM's 3.35 TB/s,
# and the time of its operations. The six rows other than FAST count
# operations at 67 TFLOP/s float32 outside the tensor cores (each scalar
# operation counted as one; the published peak counts an FMA as two), so
# they compare with earlier runs.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# The FAST rows count by instruction class, at the throughputs of the CUDA
# C++ Programming Guide's table "Throughput of Native Arithmetic
# Instructions" for compute capability 9.0, x 132 SMs x 1.98 GHz: 128
# results per SM per clock for f32 add / multiply, which is also the SM's
# issue rate (4 schedulers x 32 lanes), and 64 for compare / minimum /
# maximum (select counted with them). The two classes run on different
# pipes that overlap, so the operations take the longer of all of them at
# the issue rate and the compare class alone at its own rate.
SMS, SM_CLOCK_HZ = 132, 1.98e9
ISSUE_OPS_PER_S = SMS * 128 * SM_CLOCK_HZ  # ~33.5e12
CMP_OPS_PER_S = SMS * 64 * SM_CLOCK_HZ  # ~16.7e12
# (add / multiply, compare / min / max / select) operations per pixel of
# the 16-row bands a FAST kernel computes, counted from the algorithm:
FAST_PRETEST_OPS = (4, 12)  # 4 compass differences; 8 compares + the
#                             two-of-four tests
# the arc trees, only where the pre-test passes: the other 12 differences;
# the doubling tree m2 -> m4 -> m8 -> m9 (64) and a 16-way max (15) per
# polarity, threshold and select; with one possible polarity one tree, with
# both two and a final max (a negated operand is an instruction's modifier,
# not an operation)
FAST_OPS = {"one": (12, 81), "both": (12, 161)}
NMS_OPS = (0, 11)  # 8 max + 2 compares + select
BLUR_OPS = (26, 0)  # 2 passes x (7 multiplies + 6 adds)
SEL_OPS = (0, 12)  # true-bounds mask + rank bonus + 4 argmax rounds
HAMMING_OPS = 29  # per pair: 8 xor + 8 popcount + 7 adds + 6 compare/select,
#                   plus 2 per gate factor (the gate's dot product)
POSE_OPS = 260  # per observation and LM iteration: projection through rig
#                 and camera, residual, Huber weight, 2x6 Jacobian, the
#                 JtJ / Jtr sums, and the trial step's cost
BA_OPS = 300  # per observation: projection, 2x6 and 2x3 Jacobians, weight,
#               the 30 payload channels and 27 Hpp / gp sums


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


# kernels redesigned for Hopper whose ptxas report phase 1 prints: name ->
# a piece of the mangled symbol (the tile kernel at production's DG = 14)
REDESIGNED = {"pose_lm_cluster_kernel": "pose_lm_cluster_kernel",
              "hamming_tile_kernel<14>": "hamming_tile_kernelILi14E",
              "hamming_merge_kernel": "hamming_merge_kernel",
              "fast_select_kernel": "fast_select_kernel",
              "fast_corners_kernel<true>": "fast_corners_kernelILb1E",
              "fast_corners_kernel<false>": "fast_corners_kernelILb0E",
              "linearize_kernel": "linearize_kernel",
              "patch_oriented_kernel": "patch_oriented_kernel"}
# of those, the ones that must use no local memory and spill nothing
NO_LOCAL = ("pose_lm_cluster_kernel", "fast_select_kernel",
            "fast_corners_kernel<true>", "fast_corners_kernel<false>",
            "linearize_kernel", "patch_oriented_kernel")


def ptxas_report(log: str, names: dict) -> dict:
    """{name: registers, smem, stack, spill stores / loads (bytes)} of the
    kernels whose mangled symbol contains names[name], from `ptxas -v`."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = next((n for n, piece in names.items()
                        if piece in m.group(1)), None)
            if cur is not None:
                out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[cur].update(stack=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            out[cur].update(registers=int(m.group(1)),
                            smem=int(smem.group(1)) if smem else 0)
            cur = None
    return out


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


def bound(nbytes: float, ops_s: float):
    """(bound_ms, bound_by) of work that moves nbytes and whose operations
    take ops_s seconds at the card's peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_bytes, ops_s) * 1e3,
            "bytes" if t_bytes >= ops_s else "operations")


def f32_ops_s(nops: float) -> float:
    """Seconds of nops f32 operations at 67 TFLOP/s (the non-FAST rows)."""
    return nops / F32_OPS_PER_S


def class_ops_s(add_ops: float, cmp_ops: float) -> float:
    """Seconds of add_ops f32 add / multiply and cmp_ops compare-class
    operations: the issue of both against the compare pipe alone."""
    return max((add_ops + cmp_ops) / ISSUE_OPS_PER_S, cmp_ops / CMP_OPS_PER_S)


def live_pixels(heights, skip_offset=0) -> int:
    """Pixels of the (LC, H, W) stack in the 16-row bands a kernel with
    the height skip computes (bands starting below height - offset)."""
    rows = [min(H, 16 * -(-max(int(h) - skip_offset, 0) // 16))
            for h in heights]
    return sum(rows) * W


def compass_pixels(stack, thr: float, skip_from) -> dict:
    """Pixels of the 16-row bands starting below skip_from[c] that pass
    the FAST kernels' compass pre-test (interior, and two of the compass
    differences, circle points 0, 4, 8, 12, > thr or two < -thr), by the
    trees they need: {"one": one polarity passes, "both": both do}."""
    import torch

    t = torch.tensor(thr, dtype=torch.float32, device=stack.device)
    ctr = stack[:, 3:H - 3, 3:W - 3]
    ds = [stack[:, 3 + dy:H - 3 + dy, 3 + dx:W - 3 + dx] - ctr
          for dy, dx in ((-3, 0), (0, 3), (3, 0), (0, -3))]
    br = sum((d > t).int() for d in ds) >= 2
    dk = sum((d < -t).int() for d in ds) >= 2
    band = torch.arange(3, H - 3, device=stack.device) // 16 * 16
    live = (band[None, :] < torch.as_tensor(
        skip_from, device=stack.device)[:, None])[:, :, None]
    return {"one": int(((br ^ dk) & live).sum()),
            "both": int((br & dk & live).sum())}


def fast_ops_s(live: int, passing: dict, *per_pixel) -> float:
    """Seconds of a FAST kernel's operations (class_ops_s): the pre-test
    and the per_pixel counts on its live pixels, the trees on the pixels
    that pass the pre-test (passing: compass_pixels)."""
    return class_ops_s(*(
        live * (FAST_PRETEST_OPS[i] + sum(p[i] for p in per_pixel))
        + sum(n * FAST_OPS[k][i] for k, n in passing.items())
        for i in (0, 1)))


def pass_share(passing: dict, live: int) -> float:
    return sum(passing.values()) / live


def rot_err(Ra, Rb) -> float:
    c = (np.trace(Ra.T @ Rb) - 1.0) * 0.5
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def bin_edge_distance(angle, bins=BINS):
    """Radians from each angle to the nearest steering-bin boundary."""
    import torch

    x = (torch.remainder(angle, 2 * np.pi) / (2 * np.pi)) * bins
    return (x - torch.floor(x) - 0.5).abs() * (2 * np.pi / bins)


def near_stack_border(ff):
    """Keypoints whose BRIEF samples (up to 18 px from the keypoint) can
    reach the 3-px border of the (H, W) stacked image, in level pixels."""
    import torch

    s = 1.2 ** ff.kp_octave.to(torch.float32)
    x = torch.round(ff.kp_xy[..., 0] / s)
    y = torch.round(ff.kp_xy[..., 1] / s)
    m = 18 + 3
    return (x < m) | (y < m) | (x >= W - m) | (y >= H - m)


def angle_diff(a, b):
    import torch

    return torch.remainder(a - b + np.pi, 2 * np.pi) - np.pi


class Scene:
    """The bench.py scene rendered with the port's generator; the rig is
    built with the port's default device (the card)."""

    def __init__(self, dev, frames=SESSION_FRAMES):
        import torch

        from mcslam_tpu_torch.data import synthetic

        self.rig = synthetic.make_synthetic_rig(
            synthetic.SyntheticRigSpec(num_cams=C, image_size=(W, H)))
        check(self.rig.device.type == "cuda", "the rig is not on the card")
        self.poses = synthetic.smooth_trajectory(frames, step_angle=0.02)
        lms = synthetic.make_landmarks(3000, depth_range=(4.0, 15.0))
        imgs = synthetic.render_blob_images(self.rig, self.poses, lms)
        self.imgs = [torch.from_numpy(imgs[k]).to(dev) for k in range(frames)]
        self.dev = dev

    def frame_kwargs(self, route=None):
        kw = dict(num_points=NPTS, num_levels=NLVL, max_intra=MAXI,
                  angle_bins=BINS)
        if route is not None:
            kw["route"] = route
        return kw

    def step_kwargs(self, frac, route=None):
        kw = dict(num_points=NPTS, num_levels=NLVL,
                  fast_threshold=FAST_THR, min_threshold=MIN_THR,
                  max_intra=MAXI, min_z=0.5, max_z=40.0, angle_bins=BINS,
                  image_wh=self.rig.image_size, fastpath_frac=frac, **STEP)
        if route is not None:
            kw["route"] = route
        return kw


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


def drive(scene, ff0, mapstate, frac, gen_seed=0, route=None):
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
            **scene.step_kwargs(frac, route))
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


def check_drive(name, recs):
    """Every frame of a drive tracked within the pose gates."""
    for k, r in enumerate(recs, start=1):
        print(f"#   {name} frame {k}: tracked={r['ok']} fastpath={r['fast']} "
              f"matches={r['n_matches']} with_lm={r['n_lm']} "
              f"inliers={r['n_inl']} localmap_inliers={r['lm_inliers']} "
              f"t_err={r['t_err']:.4f} m r_err={r['r_err']:.5f} rad")
        check(r["ok"], f"{name} frame {k}: not tracked")
        check(r["t_err"] <= MAX_T_ERR and r["r_err"] <= MAX_R_ERR,
              f"{name} frame {k}: pose error {r['t_err']:.4f} m / "
              f"{r['r_err']:.5f} rad over {MAX_T_ERR} / {MAX_R_ERR}")


def window_pixels(imgs, org, img_idx) -> int:
    """Distinct pixels of imgs that the 39x39 windows at (T, 2) origins of
    images img_idx cover: what a patch gather must read."""
    import torch

    mask = torch.zeros(imgs.shape, dtype=torch.bool, device=imgs.device)
    ar = torch.arange(39, device=imgs.device)
    org = org.long()
    mask[img_idx.long()[:, None, None], (org[:, 0, None] + ar)[:, :, None],
         (org[:, 1, None] + ar)[:, None, :]] = True
    return int(mask.sum())


def index_gather(imgs, org, img_idx):
    """The one PyTorch call that computes a patch gather: advanced indexing
    with the window indices built beforehand (not timed)."""
    import torch

    ar = torch.arange(39, device=imgs.device)
    org = org.long()
    b = img_idx.long()[:, None, None]
    rows = (org[:, 0, None] + ar)[:, :, None]
    cols = (org[:, 1, None] + ar)[:, None, :]
    return lambda: imgs[b, rows, cols]


def stacked_pyramid(img, dev):
    """The FAST kernels' input for the (C, H, W) frame img: its pyramid's
    levels edge-padded to (H, W) and stacked level-major, (NLVL * C, H, W),
    with the levels' true heights and widths ((NLVL * C,) int32) and the
    7 blur taps, as ops/orb.py builds them."""
    import torch

    from mcslam_tpu_torch.ops import image as image_ops

    levels = image_ops.build_pyramid(img, NLVL, 1.2)
    hw = [(lv.shape[-2], lv.shape[-1]) for lv in levels]
    stacked = torch.cat([torch.nn.functional.pad(
        lv[None], (0, W - w, 0, H - h), mode="replicate")[0]
        for lv, (h, w) in zip(levels, hw)]).contiguous()
    h_l = torch.tensor([h for h, _ in hw], dtype=torch.int32,
                       device=dev).repeat_interleave(C)
    w_l = torch.tensor([w for _, w in hw], dtype=torch.int32,
                       device=dev).repeat_interleave(C)
    return stacked, h_l, w_l, image_ops._np_gaussian_taps(7, 2.0)


def frame_kernels(scene, rng, dev, kernels):
    """Phase 2, the six frame-build kernels at the 4-camera VGA shapes.
    Returns the stacked pyramid batch's blur (the patch gathers' input)."""
    import torch

    from mcslam_tpu_torch.ops import fast_cuda, orb, patch_cuda

    stacked, h_l, w_l, taps = stacked_pyramid(scene.imgs[0], dev)
    heights = h_l.tolist()
    LC = NLVL * C
    npix = LC * H * W
    fs_args = (stacked, MIN_THR, FAST_THR, h_l, w_l, taps)
    kb, kv, kr = fast_cuda.fast_select(*fs_args)
    pb, pv, pr = fast_cuda.fast_select_reference(*fs_args)
    torch.cuda.synchronize()
    err_blur = float((kb - pb).abs().max())
    check(torch.equal(kv, pv) and torch.equal(kr, pr),
          "fast_select: candidates differ from the plain version")
    check(err_blur <= 1e-6, f"fast_select: blur error {err_blur} > 1e-6")
    live = live_pixels(heights)
    passing = compass_pixels(stacked, MIN_THR, heights)
    print(f"# kernel fast_select {tuple(stacked.shape)}: candidates exact "
          f"({kv.shape[1]} cells x 4), blur max abs err {err_blur:.3g}; "
          f"of {live} live pixels {passing['one']} pass the compass "
          f"pre-test for one polarity, {passing['both']} for both "
          f"({100 * pass_share(passing, live):.2f} %)")
    kernels["fast_select"] = dict(
        route="cuda", source="mcslam_tpu_torch/csrc/fast_select.cu",
        replaces="mcslam_tpu/ops/fast_pallas.py:283", max_abs_err=err_blur,
        pretest_pass=pass_share(passing, live),
        fn=lambda: fast_cuda.fast_select(*fs_args),
        plain=lambda: fast_cuda.fast_select_reference(*fs_args),
        symbols=("fast_select_kernel",),
        nbytes=4 * live + 4 * npix + 8 * kv.numel() + 8 * LC,
        ops_s=fast_ops_s(live, passing, NMS_OPS, BLUR_OPS, SEL_OPS))
    # the same call on uniform noise, where every warp runs the trees
    noise = torch.rand(stacked.shape, generator=torch.Generator(
        device=dev).manual_seed(5), device=dev)
    nz_args = (noise,) + fs_args[1:]
    kb_n, kv_n, kr_n = fast_cuda.fast_select(*nz_args)
    pb_n, pv_n, pr_n = fast_cuda.fast_select_reference(*nz_args)
    torch.cuda.synchronize()
    err_n = float((kb_n - pb_n).abs().max())
    check(torch.equal(kv_n, pv_n) and torch.equal(kr_n, pr_n),
          "fast_select on noise: candidates differ from the plain version")
    check(err_n <= 1e-6, f"fast_select on noise: blur error {err_n} > 1e-6")
    passing_n = compass_pixels(noise, MIN_THR, heights)
    print(f"# kernel fast_select on uniform noise: candidates exact, blur max "
          f"abs err {err_n:.3g}; {100 * pass_share(passing_n, live):.2f} % "
          f"of the live pixels pass the compass pre-test "
          f"({passing_n['both']} for both polarities)")
    kernels["fast_select"]["on_noise"] = dict(
        max_abs_err=err_n, pretest_pass=pass_share(passing_n, live),
        fn=lambda: fast_cuda.fast_select(*nz_args),
        plain=lambda: fast_cuda.fast_select_reference(*nz_args),
        symbols=("fast_select_kernel",),
        nbytes=4 * live + 4 * npix + 8 * kv.numel() + 8 * LC,
        ops_s=fast_ops_s(live, passing_n, NMS_OPS, BLUR_OPS, SEL_OPS))

    errs = {}
    for hskip in (True, False):
        for blur in (True, False):
            args = (stacked, MIN_THR, h_l if hskip else None,
                    taps if blur else None)
            kout = fast_cuda.fast_corners(*args)
            pout = fast_cuda.fast_corners_reference(*args)
            if not blur:
                kout, pout = (kout,), (pout,)
            torch.cuda.synchronize()
            mode = ("hskip" if hskip else "full") + ("+blur" if blur else "")
            check(all(torch.equal(a, b) for a, b in zip(kout, pout)),
                  f"fast_corners {mode}: differs from the plain version")
            if hskip and blur:
                check(torch.equal(kout[1], kb),
                      "fast_corners hskip+blur: blur differs from "
                      "fast_select's")
            errs[mode] = max(float((a - b).abs().max())
                             for a, b in zip(kout, pout))
    print(f"# kernel fast_corners {tuple(stacked.shape)}, modes "
          f"{sorted(errs)}: score maps and blurs exact (max abs err "
          f"{max(errs.values()):.3g}); the blur equals fast_select's bit "
          f"for bit")
    live_b = live_pixels(heights)
    passing_b = compass_pixels(stacked, MIN_THR, heights)
    passing_f = compass_pixels(stacked, MIN_THR, [H] * LC)
    kernels["fast_corners_hskip"] = dict(
        route="cuda", source="mcslam_tpu_torch/csrc/fast_select.cu",
        replaces="mcslam_tpu/ops/fast_pallas.py:422",
        max_abs_err=max(errs["hskip+blur"], errs["hskip"]),
        fn=lambda: fast_cuda.fast_corners(stacked, MIN_THR, h_l, taps),
        plain=lambda: fast_cuda.fast_corners_reference(stacked, MIN_THR,
                                                       h_l, taps),
        symbols=("fast_corners_kernel",),
        pretest_pass=pass_share(passing_b, live_b),
        nbytes=4 * live_b + 8 * npix + 4 * LC,
        ops_s=fast_ops_s(live_b, passing_b, NMS_OPS, BLUR_OPS))
    kernels["fast_corners_full"] = dict(
        route="cuda", source="mcslam_tpu_torch/csrc/fast_select.cu",
        replaces="mcslam_tpu/ops/fast_pallas.py:398",
        max_abs_err=max(errs["full+blur"], errs["full"]),
        fn=lambda: fast_cuda.fast_corners(stacked, MIN_THR),
        plain=lambda: fast_cuda.fast_corners_reference(stacked, MIN_THR),
        symbols=("fast_corners_kernel",),
        pretest_pass=pass_share(passing_f, npix),
        nbytes=8 * npix, ops_s=fast_ops_s(npix, passing_f, NMS_OPS))

    T = C * NPTS
    yx = torch.from_numpy(np.stack([rng.randint(0, H, T), rng.randint(0, W, T)],
                                   -1).astype(np.int32)).to(dev)
    idx = torch.from_numpy(rng.randint(0, LC, T).astype(np.int32)).to(dev)
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
        plain=lambda: patch_cuda.patch_gather_reference(*pg_args),
        library=index_gather(kb, ko, idx), symbols=("patch_gather_kernel",),
        nbytes=4 * window_pixels(kb, ko, idx) + 12 * T
        + T * (4 * PATCH_PX + 8), ops_s=0.0)

    maxb = max(orb._level_budget(NPTS, NLVL, 1.2))
    yxb = torch.from_numpy(np.stack([rng.randint(0, H, (LC, maxb)),
                                     rng.randint(0, W, (LC, maxb))], -1)
                           .astype(np.int32)).to(dev)
    kp, ko = patch_cuda.patch_gather_batched(kb, yxb)
    pp, po = patch_cuda.patch_gather_batched_reference(kb, yxb)
    check(torch.equal(kp, pp) and torch.equal(ko, po),
          "patch_gather_batched: patches or origins differ from the plain "
          "version")
    print(f"# kernel patch_gather_batched C={LC} N={maxb}: patches and "
          f"origins exact")
    Tb = LC * maxb
    img_b = torch.arange(LC, device=dev).repeat_interleave(maxb)
    org_b = ko.reshape(Tb, 2)
    kernels["patch_gather_batched"] = dict(
        route="cuda", source="mcslam_tpu_torch/csrc/patch_gather.cu",
        replaces="mcslam_tpu/ops/patch_pallas.py:65", max_abs_err=0.0,
        fn=lambda: patch_cuda.patch_gather_batched(kb, yxb),
        plain=lambda: patch_cuda.patch_gather_batched_reference(kb, yxb),
        library=index_gather(kb, org_b, img_b),
        symbols=("patch_gather_kernel",),
        nbytes=4 * window_pixels(kb, org_b, img_b) + 8 * Tb
        + Tb * (4 * PATCH_PX + 8), ops_s=0.0)

    kp, km, ko = patch_cuda.patch_gather_oriented(*pg_args)
    pp, pm, po = patch_cuda.patch_gather_oriented_reference(*pg_args)
    torch.cuda.synchronize()
    check(kp.dtype == torch.bfloat16 and torch.equal(kp, pp)
          and torch.equal(ko, po),
          "patch_gather_oriented: bf16 patches or origins differ from the "
          "plain version")
    kp2, km2, ko2 = patch_cuda.patch_gather_oriented(*pg_args)
    torch.cuda.synchronize()
    check(torch.equal(km, pm), "patch_gather_oriented: moments differ from "
          "the plain version's (summed in the same fixed order)")
    check(torch.equal(kp, kp2) and torch.equal(km, km2)
          and torch.equal(ko, ko2),
          "patch_gather_oriented: two runs of the kernel differ")
    print(f"# kernel patch_gather_oriented T={T}: bf16 patches, moments and "
          f"origins bitwise equal to the plain version and across two runs")
    kernels["patch_gather_oriented"] = dict(
        route="cuda", source="mcslam_tpu_torch/csrc/patch_gather.cu",
        replaces="mcslam_tpu/ops/patch_pallas.py:208",
        max_abs_err=float((km - pm).abs().max()),
        fn=lambda: patch_cuda.patch_gather_oriented(*pg_args),
        plain=lambda: patch_cuda.patch_gather_oriented_reference(*pg_args),
        symbols=("patch_oriented_kernel",),
        nbytes=4 * window_pixels(kb, ko, idx) + 12 * T
        + T * (2 * PATCH_PX + 16),
        ops_s=f32_ops_s(4 * PATCH_PX * T))


def solver_kernels(scene, rng, dev, kernels):
    """Phase 2, the matcher, pose LM and BA linearization kernels."""
    import torch

    from mcslam_tpu_torch.backend import ba
    from mcslam_tpu_torch.data import synthetic
    from mcslam_tpu_torch.frontend import pose_opt_cuda
    from mcslam_tpu_torch.ops import ba_cuda, match_cuda

    ham_errs, ham_calls = [], []
    ham_bytes = ham_ops = 0
    for (M, N, thr, want_cols) in ((MAXI, MAXI, 100.0, True),
                                   (MAXI, LML, 18.0, False)):
        args = _match_problem(rng, M, N, thr, want_cols, dev)
        kout = match_cuda.hamming_argmin2(*args)
        again = match_cuda.hamming_argmin2(*args)
        pout = match_cuda.hamming_argmin2_reference(*args)
        torch.cuda.synchronize()
        check(all((x is None and y is None) or torch.equal(x, y)
                  for x, y in zip(kout, again)),
              "hamming_argmin2: two runs of the kernel differ")
        rows, cols = _near_gate(args[2], args[3], thr * thr)
        err = _compare_match(kout, pout, rows, cols, want_cols)
        ham_errs.append(err)
        ham_calls.append(args)
        ham_bytes += sum(a.nbytes for a in args[:4]) + 12 * M + (
            8 * N if want_cols else 0)
        ham_ops += M * N * (HAMMING_OPS + 2 * args[2].shape[1])
        print(f"# kernel hamming_argmin2 {M}x{N} want_cols={want_cols}: "
              f"indices and distances exact on {int((~rows).sum())}/{M} rows "
              f"away from the gate boundary, max abs err {err:.3g}; bitwise "
              f"equal across two runs")
    kernels["hamming_argmin2"] = dict(
        route="cuda", source="mcslam_tpu_torch/csrc/hamming_argmin2.cu",
        replaces="mcslam_tpu/ops/match_pallas.py:121",
        max_abs_err=max(ham_errs),
        fn=lambda: [match_cuda.hamming_argmin2(*a) for a in ham_calls],
        plain=lambda: [match_cuda.hamming_argmin2_reference(*a)
                       for a in ham_calls],
        symbols=("hamming_tile_kernel", "hamming_merge_kernel"),
        nbytes=ham_bytes, ops_s=f32_ops_s(ham_ops))

    # B = 2 (the portfolio's refine, the shape timed first) is the table's
    # entry; B = 1 (the fast path's two refines per frame) rides along
    sched = (8, 8)
    pose = {}
    for B in (1, 2):
        T_init, data, mask = _pose_problem(rng, B, MAXI, dev)
        kT, kc = pose_opt_cuda.pose_lm(T_init, data, mask, sched)
        kT2, kc2 = pose_opt_cuda.pose_lm(T_init, data, mask, sched)
        pT, pc = pose_opt_cuda.pose_lm_reference(T_init, data, mask, sched)
        torch.cuda.synchronize()
        check(torch.equal(kT, kT2) and torch.equal(kc, kc2),
              f"pose_lm B={B}: two runs of the kernel differ")
        err_pose = float((kT - pT).abs().max())
        inl_k = (mask > 0.5) & (kc < pose_opt_cuda.CHI2_2DOF)
        inl_p = (mask > 0.5) & (pc < pose_opt_cuda.CHI2_2DOF)
        edge = (pc - pose_opt_cuda.CHI2_2DOF).abs() < 1e-3
        check(err_pose <= 2e-3, f"pose_lm B={B}: pose error {err_pose} > 2e-3")
        check(bool(torch.all((inl_k == inl_p) | edge)),
              f"pose_lm B={B}: inlier sets differ away from the chi2 threshold")
        print(f"# kernel pose_lm B={B} M={MAXI}: pose max abs err "
              f"{err_pose:.3g}, inliers equal away from the chi2 edge, "
              f"bitwise equal across two runs")
        args = (T_init, data, mask, sched)
        pose[B] = dict(
            max_abs_err=err_pose,
            fn=lambda a=args: pose_opt_cuda.pose_lm(*a),
            plain=lambda a=args: pose_opt_cuda.pose_lm_reference(*a),
            symbols=("pose_lm_cluster_kernel",),
            nbytes=T_init.nbytes + data.nbytes + mask.nbytes + kT.nbytes
            + kc.nbytes,
            ops_s=f32_ops_s(mask.numel() * sum(sched) * POSE_OPS))
    kernels["pose_lm"] = dict(
        route="cuda", source="mcslam_tpu_torch/csrc/pose_lm.cu",
        replaces="mcslam_tpu/frontend/pose_opt_pallas.py:262",
        at_b1=pose[1], **pose[2])

    lin_args = ba.linearize_inputs(ba.problem_from_numpy(
        **synthetic.random_window_ba_problem(scene.rig)))
    check(lin_args[0].device.type == "cuda",
          "random_window_ba_problem did not follow the rig to the card")
    # the solve's call: the constant tables checked once (Linearizer),
    # then per call the pose rows, the landmarks and the validity
    lin = ba_cuda.Linearizer(*lin_args[2:6], *lin_args[7:],
                             lin_args[0].shape[0], lin_args[1].shape[0])
    lin_call = (lin_args[0], lin_args[1], lin_args[6])
    klin = ba_cuda.ba_linearize(*lin_args)
    klin2 = lin(*lin_call)
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
    exact = [n for n, a, b in zip(("payload", "r", "w"), klin, plin)
             if torch.equal(a, b)]
    print(f"# kernel ba_linearize K=6 Ok=1365 L=2048 C=4: bitwise equal "
          f"across two runs (one-shot and prepared call); bitwise equal to "
          f"the plain version: {exact or 'none'}; max abs err (largest "
          f"magnitude) per output: "
          + ", ".join(f"{n} {e:.3g} ({m:.3g})"
                      for n, (e, m) in abs_errs.items()))
    kernels["ba_linearize"] = dict(
        route="cuda", source="mcslam_tpu_torch/csrc/ba_linearize.cu",
        replaces="mcslam_tpu/ops/ba_pallas.py:136", max_abs_err=err_lin,
        fn=lambda: lin(*lin_call),
        plain=lambda: ba_cuda.ba_linearize_reference(*lin_args),
        symbols=("linearize_kernel",), device_ops=1,
        nbytes=sum(a.nbytes for a in lin_args) + sum(o.nbytes for o in klin),
        ops_s=f32_ops_s(lin_args[2].numel() * BA_OPS))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    import mcslam_tpu_torch  # noqa: F401  (sets the f32 matmul policy)
    from mcslam_tpu_torch import _build
    from mcslam_tpu_torch.backend import ba
    from mcslam_tpu_torch.frontend import frame
    from mcslam_tpu_torch.ops import orb

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
    report = ptxas_report(_build.BUILD_LOG, REDESIGNED)
    for name in REDESIGNED:
        check(name in report, f"ptxas reported nothing for {name}")
        print(f"# ptxas {name}: {report[name]}")
    for name in NO_LOCAL:
        r = report[name]
        check(r["stack"] == 0 and r["spill_stores"] == 0
              and r["spill_loads"] == 0,
              f"{name} uses local memory or spills: {r}")
    cluster = _build.library().mc_pose_lm_cluster()
    check(cluster > 1, f"pose_lm runs {cluster} block(s) per candidate")
    print(f"# pose_lm: a cluster of {cluster} CTAs per candidate (grid = B x "
          f"{cluster})")
    cluster = _build.library().mc_ba_linearize_cluster()
    check(cluster > 1, f"ba_linearize runs {cluster} block(s) per keyframe")
    print(f"# ba_linearize: one launch, a cluster of {cluster} CTAs per "
          f"keyframe (grid = K x {cluster})")

    from mcslam_tpu_torch.slam import INITIALIZED
    from mcslam_tpu_torch.utils import metrics

    scene = Scene(dev)
    rng = np.random.RandomState(0)
    kernels = {}

    # ---- phase 2: kernels against their plain versions ----
    frame_kernels(scene, rng, dev, kernels)
    solver_kernels(scene, rng, dev, kernels)
    solve_problem = _window_solves(scene, dev)
    err_small = _small_scene_cpu_vs_cuda(dev)
    print(f"# reference check, 2-camera 192x144 frame on the kernels (CUDA) "
          f"vs the plain versions (CPU): pose max abs err {err_small:.3g}")

    # ---- phase 3: the slice, launches counted ----
    _build.LAUNCHES.clear()
    ff0 = frame.build_frame(scene.imgs[0], scene.rig, **scene.frame_kwargs())
    mapstate, n_seed = seed_map(ff0, dev)
    check(n_seed >= 200, f"frame 0 seeded only {n_seed} landmarks")
    print(f"# slice: frame 0 keypoints {int(ff0.kp_valid.sum())}, intra "
          f"groups {int(ff0.im_valid.sum())}, seeded landmarks {n_seed}")
    results = {}
    for name, frac in (("fast", FASTPATH_FRAC), ("portfolio", 2.0)):
        results[name] = drive(scene, ff0, mapstate, frac)
        check_drive(name, results[name])
    check(not any(r["fast"] for r in results["portfolio"]),
          "forced-portfolio drive took the fast path")
    launches = dict(_build.LAUNCHES)
    print(f"# launches during the slice: {launches}")
    for n in ("fast_select", "patch_gather", "hamming_argmin2", "pose_lm"):
        check(launches.get(n, 0) > 0,
              f"kernel {n} was not launched on the slice's path")

    # ---- phase 4: the other extraction routes, launches counted ----
    routes = {
        "A": (orb.OrbRoute(select_in_kernel=False, late_compact=True),
              ("fast_corners_hskip", "patch_gather_batched")),
        "B": (orb.OrbRoute(fused_blur=False, hskip=False, fused_orient=True),
              ("fast_corners_full", "patch_gather_oriented")),
    }
    route_state = {}
    for rname, (route, names) in routes.items():
        _build.LAUNCHES.clear()
        ffr = frame.build_frame(scene.imgs[0], scene.rig,
                                **scene.frame_kwargs(route))
        mstate, n_seed_r = seed_map(ffr, dev)
        recs = drive(scene, ffr, mstate, FASTPATH_FRAC, route=route)
        launches = dict(_build.LAUNCHES)
        print(f"# route {rname} ({route}): frame 0 keypoints "
              f"{int(ffr.kp_valid.sum())}, seeded landmarks {n_seed_r}")
        check_drive(f"route {rname}", recs)
        print(f"# launches during the route {rname} drive ({N_FRAMES} frame "
              f"builds): {launches}")
        for n in names:
            check(launches.get(n, 0) > 0,
                  f"kernel {n} was not launched on route {rname}")
            kernels[n]["launches"] = launches.get(n, 0)
        check(launches.get("fast_select", 0) == 0,
              f"route {rname} launched fast_select")
        route_state[rname] = (route, ffr, mstate)
        # frame 0 against the default route
        for f in ("kp_xy", "kp_valid", "kp_response", "kp_octave"):
            check(torch.equal(getattr(ffr, f), getattr(ff0, f)),
                  f"route {rname}: frame 0 {f} differs from the default "
                  f"route's")
        differ = ~torch.all(ffr.kp_desc == ff0.kp_desc, dim=-1) & ff0.kp_valid
        near = ((bin_edge_distance(ff0.kp_angle) < 1e-4)
                | (bin_edge_distance(ffr.kp_angle) < 1e-4))
        border = near_stack_border(ff0)
        n_diff, n_near = int(differ.sum()), int((differ & near).sum())
        n_border = int((differ & ~near & border).sum())
        d_ang = float(angle_diff(ffr.kp_angle, ff0.kp_angle)[
            ff0.kp_valid].abs().max())
        print(f"# frame 0, route {rname} vs the default route: the same "
              f"{int(ff0.kp_valid.sum())} keypoints; {n_diff} descriptors "
              f"differ: {n_near} at a keypoint within 1e-4 rad of a "
              f"steering-bin boundary (the orientation moments are summed "
              f"in another order), {n_border} with BRIEF samples within 3 px "
              f"of the stacked image's border (route B's standalone blur "
              f"reflects there, the fused blur clamps rows and wraps "
              f"columns), {n_diff - n_near - n_border} elsewhere; max angle "
              f"difference {d_ang:.3g} rad")
        check(n_diff == n_near + (n_border if rname == "B" else 0),
              f"route {rname}: descriptors differ from the default route's "
              f"for another reason")

    # ---- phase 5: the sessions, launches counted ----
    _build.LAUNCHES.clear()
    slam, _ = run_session(scene)
    launches = dict(_build.LAUNCHES)
    _, est = slam.trajectory_arrays()
    ate = metrics.ate_rmse(est, scene.poses)
    print(f"# session: {SESSION_FRAMES} frames on {slam.device}, state "
          f"{slam.state}, keyframes {slam.stats['keyframes']}, failures "
          f"{slam.stats['failures']}, window solves "
          f"{slam.stats.get('window_ba', 0)}, fast-path frames "
          f"{slam.stats.get('track_fastpath', 0)}/"
          f"{slam.stats.get('track_dispatch', 0)}, ATE {ate:.4f} m")
    for line in slam.timers.report().splitlines():
        print("#   " + line)
    print(f"# launches during the session: {launches}")
    check(slam.device.type == "cuda", "session: the driver is not on the card")
    check(slam.state == INITIALIZED, "session: not INITIALIZED at the end")
    check(slam.stats["failures"] == 0,
          f"session: {slam.stats['failures']} tracking failures")
    check(slam.stats["keyframes"] >= MIN_KEYFRAMES,
          f"session: {slam.stats['keyframes']} keyframes < {MIN_KEYFRAMES}")
    check(np.all(np.isfinite(est)) and est.shape == (SESSION_FRAMES, 4, 4),
          "session: trajectory malformed or non-finite")
    check(ate <= MAX_ATE, f"session: ATE {ate:.4f} m > {MAX_ATE}")
    for n in ("fast_select", "patch_gather", "hamming_argmin2", "pose_lm",
              "ba_linearize"):
        check(launches.get(n, 0) > 0,
              f"kernel {n} was not launched on the main path")
        kernels[n]["launches"] = launches.get(n, 0)

    _build.LAUNCHES.clear()
    slam_b, _ = run_session(scene, ROUTE_B_FRAMES, routes["B"][0])
    launches = dict(_build.LAUNCHES)
    _, est_b = slam_b.trajectory_arrays()
    ate_b = metrics.ate_rmse(est_b, scene.poses[:ROUTE_B_FRAMES])
    print(f"# route B session: {ROUTE_B_FRAMES} frames, state "
          f"{slam_b.state}, keyframes {slam_b.stats['keyframes']}, failures "
          f"{slam_b.stats['failures']}, ATE {ate_b:.4f} m; launches "
          f"{launches}")
    check(slam_b.state == INITIALIZED, "route B session: not INITIALIZED")
    check(slam_b.stats["failures"] == 0,
          f"route B session: {slam_b.stats['failures']} tracking failures")
    check(np.all(np.isfinite(est_b)), "route B session: non-finite poses")
    check(ate_b <= MAX_ATE, f"route B session: ATE {ate_b:.4f} m > {MAX_ATE}")
    for n in routes["B"][1]:
        check(launches.get(n, 0) > 0,
              f"kernel {n} was not launched in the route B session")

    # ---- phase 6: the vision-only bootstraps, launches counted ----
    bootstrap_phase(scene, dev, kernels)

    # ---- phase 7: timing ----
    for n, k in kernels.items():
        time_kernel(n, k, smi)
        if "at_b1" in k:
            time_kernel(f"{n} B=1", k["at_b1"], smi)
        if "on_noise" in k:
            time_kernel(f"{n} on uniform noise", k["on_noise"], smi)
    for name, iters in BA_ITERS:
        def solve():
            return ba.ba_solve(solve_problem, iters=iters, gate_rounds=2)
        ms = cuda_ms(solve, reps=5, warmup=1)
        dev_ms, n_ops, _ = device_profile(solve)
        print(f"# time ba_solve {name} ({iters} x 2): {ms:.3f} ms by CUDA "
              f"events; profiler: {dev_ms:.3f} ms device time in "
              f"{n_ops:.0f} device ops ({smi})")
    route_state["default"] = (None, ff0, mapstate)
    for rname, frac in (("default", FASTPATH_FRAC), ("default", 2.0),
                        ("A", FASTPATH_FRAC), ("B", FASTPATH_FRAC)):
        route, ffr, mstate = route_state[rname]
        ms = _frame_ms(scene, ffr, mstate, frac, route)
        dev_ms, n_ops, _ = device_profile(lambda: _frame_ms(
            scene, ffr, mstate, frac, route, n=1, warm=False))
        path = "fast path" if frac < 1.0 else "full path"
        print(f"# per-frame build+track, route {rname}, {path}: {ms:.3f} ms; "
              f"profiler: {dev_ms:.3f} ms device time in {n_ops:.0f} device "
              f"ops per frame ({smi})")
    _, times = run_session(scene)
    wall_ms = sum(t for t, _ in times) * 1e3
    dev_ms, n_ops, _ = device_profile(lambda: run_session(scene))
    print(f"# session of {SESSION_FRAMES} frames: {wall_ms:.1f} ms wall; a "
          f"profiled repeat: {dev_ms:.1f} ms device time in {n_ops:.0f} "
          f"device ops, device busy {100 * dev_ms / wall_ms:.1f} % of the "
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


def run_frames(slam, inputs, step):
    """step(slam, k, x) over the inputs, then finalize() -> (index of the
    initializing frame, host ms of each frame before the first tracked
    one, each ending in a synchronize on the card)."""
    import torch

    from mcslam_tpu_torch.slam import INITIALIZED

    init_at, boot_ms = None, []
    for k, x in enumerate(inputs):
        was = slam.state
        t0 = time.perf_counter()
        info = step(slam, k, x)
        if was != INITIALIZED:
            if slam.device.type == "cuda":
                torch.cuda.synchronize()
            boot_ms.append((time.perf_counter() - t0) * 1e3)
        if info.get("initialized") and init_at is None:
            init_at = k
    slam.finalize()
    return init_at, boot_ms


def mono_session(dev, seed=0):
    """Bootstrap (b): MONO_FRAMES frames of a 1-camera VGA blob scene
    (6000 landmarks at 4-15 m, 0.03 rad per frame) through process_image
    with bench.py's extraction settings -> (slam, true poses, init frame,
    host ms up to the init)."""
    import torch

    from mcslam_tpu_torch.data import synthetic
    from mcslam_tpu_torch.slam import MultiCameraSLAM, SlamConfig

    rig = synthetic.make_synthetic_rig(synthetic.SyntheticRigSpec(
        num_cams=1, image_size=(W, H)), device=dev)
    poses = synthetic.smooth_trajectory(MONO_FRAMES, step_angle=0.03)
    imgs = synthetic.render_blob_images(
        rig, poses, synthetic.make_landmarks(6000, depth_range=(4.0, 15.0)))
    imgs = [torch.from_numpy(im).to(dev) for im in imgs]
    slam = MultiCameraSLAM(rig, SlamConfig(), seed=seed)
    ecfg = dict(num_points=NPTS, num_levels=NLVL, max_intra=MAXI,
                angle_bins=BINS)
    init_at, boot_ms = run_frames(slam, imgs, lambda s, k, img: (
        s.process_image(img, k / 20.0, extract_cfg=ecfg)))
    return slam, poses, init_at, boot_ms


def far_session(dev, depth=FAR_DEPTH, seed=0):
    """Bootstrap (c): FAR_FRAMES feature-level frames of a 4-camera VGA
    rig with 0.3 m camera spacing (the rig of tests/test_seventeen.py) and
    3000 landmarks at `depth` metres, NPTS features per camera, 0.03 rad
    per frame, through build_frame_from_keypoints + process_frame ->
    (slam, true poses, init frame, host ms up to the init)."""
    import torch

    from mcslam_tpu_torch.data import synthetic
    from mcslam_tpu_torch.frontend import frame
    from mcslam_tpu_torch.ops import hamming
    from mcslam_tpu_torch.slam import MultiCameraSLAM, SlamConfig

    rig = synthetic.make_synthetic_rig(synthetic.SyntheticRigSpec(
        num_cams=C, image_size=(W, H), baseline=0.3), device=dev)
    poses = synthetic.smooth_trajectory(FAR_FRAMES, radius=5.0,
                                        step_angle=0.03)
    lms = synthetic.make_landmarks(3000, seed=5, depth_range=depth,
                                   spread=(120.0, 60.0))
    feats = synthetic.render_feature_frames(
        rig, poses, lms, synthetic.make_descriptors(3000, seed=6),
        kps_per_cam=NPTS, px_noise=0.3, desc_bit_noise=4, seed=7)
    slam = MultiCameraSLAM(rig, SlamConfig(max_z=60.0), seed=seed)

    def step(s, k, f):
        ff = frame.build_frame_from_keypoints(
            torch.from_numpy(f.uv).to(dev), hamming.desc_to_torch(f.desc, dev),
            torch.from_numpy(f.valid).to(dev), rig, max_intra=MAXI,
            max_z=60.0)
        return s.process_frame(ff, f.timestamp)

    init_at, boot_ms = run_frames(slam, feats, step)
    return slam, poses, init_at, boot_ms


def path_ratio(est, poses) -> float:
    """Length of the estimated path over the true one's."""
    def length(p):
        return sum(np.linalg.norm(p[i + 1][:3, 3] - p[i][:3, 3])
                   for i in range(len(p) - 1))

    return float(length(est) / length(poses))


def bootstrap_phase(scene, dev, kernels):
    """Phase 6: the driver on frames with too little rig depth, each path
    with the launch counters reset right before it and read right after.
    (a) BLANK_FRAMES blank frames, then BOOT_FRAMES bench frames through
    process_image: pending 17-point anchors, then the rig-depth bootstrap
    on the first bench frame; (b) mono_session: the monocular bootstrap
    and its two-view BA; (c) far_session: the 17-point bootstrap. Prints
    each gate and the host-clock time of the frames up to the init."""
    import torch

    from mcslam_tpu_torch import _build
    from mcslam_tpu_torch.slam import (
        INITIALIZED, NOT_INITIALIZED, MultiCameraSLAM, SlamConfig)
    from mcslam_tpu_torch.utils import metrics

    def counted(name, expect, fn):
        _build.LAUNCHES.clear()
        out = fn()
        launches = dict(_build.LAUNCHES)
        print(f"# launches during bootstrap {name}: {launches}")
        for n in expect:
            check(launches.get(n, 0) > 0,
                  f"bootstrap {name}: kernel {n} was not launched")
        return out

    ecfg = scene.frame_kwargs()
    main_path = ("fast_select", "patch_gather", "hamming_argmin2", "pose_lm",
                 "ba_linearize")

    # (a) blank frames, then the bench frames
    blank = torch.zeros_like(scene.imgs[0])
    imgs = [blank] * BLANK_FRAMES + scene.imgs[:BOOT_FRAMES]
    slam = MultiCameraSLAM(scene.rig, SlamConfig())
    states = []

    def step_a(s, k, img):
        info = s.process_image(img, k / 20.0, extract_cfg=ecfg)
        states.append(s.state)
        return info

    init_at, boot_ms = counted("(a) blank frames", main_path,
                               lambda: run_frames(slam, imgs, step_a))
    _, est = slam.trajectory_arrays()
    ate = metrics.ate_rmse(est[BLANK_FRAMES:], scene.poses[:BOOT_FRAMES])
    print(f"# bootstrap (a) {BLANK_FRAMES} blank + {BOOT_FRAMES} bench "
          f"frames: states {states[:BLANK_FRAMES + 1]}..., initialized on "
          f"frame {init_at}, state {slam.state}, keyframes "
          f"{slam.stats['keyframes']}, failures {slam.stats['failures']}, "
          f"ATE {ate:.4f} m; host ms of the frames up to the init "
          f"{[round(m, 3) for m in boot_ms]}")
    check(all(st == NOT_INITIALIZED for st in states[:BLANK_FRAMES]),
          "bootstrap (a): a blank frame changed the state")
    check(init_at == BLANK_FRAMES, f"bootstrap (a): initialized on frame "
          f"{init_at}, not {BLANK_FRAMES}")
    check(slam.state == INITIALIZED and slam.stats["failures"] == 0,
          "bootstrap (a): not INITIALIZED at the end, or failures")
    check(np.all(np.isfinite(est)) and ate <= MAX_ATE,
          f"bootstrap (a): ATE {ate:.4f} m > {MAX_ATE}")

    # (b) the monocular bootstrap through process_image
    slam, poses1, init_at, boot_ms = counted("(b) mono", main_path,
                                             lambda: mono_session(dev))
    _, est = slam.trajectory_arrays()
    check(init_at is not None, "bootstrap (b): the mono session never "
          "initialized")
    ate = metrics.ate_rmse(est[init_at:], poses1[init_at:], with_scale=True)
    print(f"# bootstrap (b) 1-camera {W}x{H}, {MONO_FRAMES} frames: "
          f"initialized on frame {init_at}, state {slam.state}, keyframes "
          f"{slam.stats['keyframes']}, window solves "
          f"{slam.stats.get('window_ba', 0)}, failures "
          f"{slam.stats['failures']}, Sim(3) ATE from the init frame "
          f"{ate:.4f} m; host ms of the frames up to the init "
          f"{[round(m, 3) for m in boot_ms]}")
    check(slam.state == INITIALIZED, "bootstrap (b): not INITIALIZED")
    check(slam.stats["keyframes"] >= MONO_MIN_KEYFRAMES,
          f"bootstrap (b): {slam.stats['keyframes']} keyframes")
    check(np.all(np.isfinite(est)) and ate <= MONO_MAX_ATE,
          f"bootstrap (b): Sim(3) ATE {ate:.4f} m > {MONO_MAX_ATE}")

    # (c) the 17-point bootstrap on the distant scene, feature level
    slam, poses4, init_at, boot_ms = counted(
        "(c) 17-point", ("hamming_argmin2", "pose_lm", "ba_linearize"),
        lambda: far_session(dev))
    _, est = slam.trajectory_arrays()
    ate_s = metrics.ate_rmse(est, poses4, with_scale=True)
    ratio = path_ratio(est, poses4)
    print(f"# bootstrap (c) distant 4-camera scene, {FAR_FRAMES} frames: "
          f"initialized on frame {init_at}, init_17pt "
          f"{slam.stats.get('init_17pt', 0)}, state {slam.state}, keyframes "
          f"{slam.stats['keyframes']}, failures {slam.stats['failures']}, "
          f"Sim(3) ATE {ate_s:.4f} m, path length {ratio:.3f} x the truth; "
          f"host ms of the frames up to the init "
          f"{[round(m, 3) for m in boot_ms]}")
    check(slam.state == INITIALIZED, "bootstrap (c): not INITIALIZED")
    check(slam.stats.get("init_17pt", 0) >= 1,
          "bootstrap (c): the 17-point bootstrap did not run")
    check(slam.stats["failures"] == 0, "bootstrap (c): tracking failures")
    check(np.all(np.isfinite(est)) and ate_s < FAR_MAX_ATE,
          f"bootstrap (c): Sim(3) ATE {ate_s:.4f} m >= {FAR_MAX_ATE}")
    check(0.2 < ratio < 5.0, f"bootstrap (c): path length {ratio:.3f} x the "
          f"truth, outside (0.2, 5)")


def time_kernel(n, k, smi):
    """Phase 6 for one kernel record: replaces its callables and counts in
    k by the times and the bound, and prints them."""
    fn, plain = k.pop("fn"), k.pop("plain")
    library = k.pop("library", None)
    names = k.pop("symbols")
    k["bound_ms"], k["bound_by"] = bound(k.pop("nbytes"), k.pop("ops_s"))
    k["ms"] = cuda_ms(fn)
    k["plain_ms"] = cuda_ms(plain, reps=5, warmup=1)
    k["library_ms"] = cuda_ms(library) if library is not None else None
    want_ops = k.pop("device_ops", None)
    wrap_ms, n_ops, kern_ms = device_profile(fn, reps=10, names=names)
    k["device_ms"] = kern_ms
    check(want_ops is None or n_ops == want_ops,
          f"{n}: the wrapper's call is {n_ops} device ops, not {want_ops}")
    lib = (f", library call {k['library_ms']:.4f} ms"
           if library is not None else "")
    print(f"# time {n}: wrapper {k['ms']:.4f} ms, plain "
          f"{k['plain_ms']:.4f} ms{lib} by CUDA events; profiler: the "
          f"kernel {kern_ms:.4f} ms of device time, the wrapper's call "
          f"{wrap_ms:.4f} ms in {n_ops:.1f} device ops; bound "
          f"{k['bound_ms']:.4f} ms ({k['bound_by']}) ({smi})")


def run_session(scene, frames=SESSION_FRAMES, route=None):
    """The first `frames` frames through the driver's entry point, on the
    rig's device -> (slam, [(wall seconds, keyframe?) per frame]);
    finalize()d."""
    from mcslam_tpu_torch.slam import MultiCameraSLAM, SlamConfig

    slam = MultiCameraSLAM(scene.rig, SlamConfig())
    times = []
    for k in range(frames):
        t0 = time.perf_counter()
        info = slam.process_image(scene.imgs[k], k / 20.0,
                                  extract_cfg=scene.frame_kwargs(route))
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

    f = synthetic.random_window_ba_problem(scene.rig, px_noise=0.5)
    p_cpu = ba.problem_from_numpy(**dict(f, device="cpu"))
    p_dev = ba.problem_from_numpy(**f)
    check(p_dev.poses.device == dev, "the window problem is not on the card")
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


def device_profile(fn, reps=1, names=()):
    """(device ms, device ops, device ms of the kernels named) per fn()
    call, over `reps` calls, from a torch.profiler CUDA trace: the summed
    duration and count of the device-side events, and the summed duration
    of those whose name contains one of `names`. A trace that caught no
    device-side event, or none of the kernels named (the CUDA trace now
    and then comes back empty), is taken again, up to five times; then
    the run fails rather than report a time it did not measure."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        named = [e for e in evs if any(n in e.name for n in names)]
        us = sum(e.time_range.elapsed_us() for e in evs)
        named_us = sum(e.time_range.elapsed_us() for e in named)
        if us > 0 and (named_us > 0 or not names):
            break
    check(us > 0, "the profiler caught no device-side event in five traces")
    check(named_us > 0 or not names,
          f"the profiler caught no launch of {names} in five traces")
    return us / 1e3 / reps, len(evs) / reps, named_us / 1e3 / reps


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
    """B initial poses against one noisy 4-camera resectioning problem
    with outliers (as tests/test_pose_opt_pallas.py builds it); every
    candidate after the first sees half of the observations."""
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
    mask[1:, ::2] = 0.0
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


def _frame_ms(scene, ff0, mapstate, frac, route=None, n=6,
              warm=True) -> float:
    """Host-clock ms per frame of _build_and_track_step (after one warm-up
    frame unless warm=False), ending in a synchronize; frames cycle
    through the drive."""
    import torch

    from mcslam_tpu_torch import tracking_kernels as tk

    gen = torch.Generator(device=scene.dev).manual_seed(1)
    eye = torch.eye(4, device=scene.dev)

    def one(k):
        *_, packed = tk._build_and_track_step(
            gen, scene.imgs[k], scene.rig, ff0.im_desc, ff0.im_valid,
            *mapstate, eye, **scene.step_kwargs(frac, route))
        return packed

    if warm:
        one(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        one(1 + i % 2)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


if __name__ == "__main__":
    sys.exit(main())
