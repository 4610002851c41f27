#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mcslam_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on failure:
  1. build: compile the CUDA sources of mcslam_tpu_torch/csrc (the nine
     kernels' five, the graphs' branch, the SGM scan, tri_refine,
     intra_pairs, the ORB glue's orb_pyramid, orb_select and
     orb_describe, the RANSAC portfolio's ransac_score, kabsch_hyp
     and pnp_hyp, the tracking glue's track_gate, track_epilogue,
     localmap_gate and localmap_epilogue, and the intra match's glue
     intra_gate, intra_groups and tri_gather; one nvcc per source, in
     parallel, sm_90a) and
     print the build time and ptxas' resource report, then registers,
     shared memory, stack and spills of the redesigned kernels (the pose
     LM's cluster kernel, the three FAST kernels, ba_linearize's cluster
     kernel, the oriented patch gather, the SGM tile kernel at D = 64,
     tri_refine at R = 2, 4 and 8, intra_pairs' one kernel, the ORB
     glue's three kernels, the three RANSAC kernels, the four
     tracking glue kernels and the three intra glue kernels must use no
     local memory and spill nothing) and the cluster sizes of the pose
     LM (per candidate) and of ba_linearize (per keyframe), each more
     than one CTA;
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
     three also bitwise equal across two runs), the SGM scan on the bench
     pair's cost volume at VGA, D = 64, and on random ones at D = 48, 37 x
     53, D = 128, 96 x 64 and D = 33, 128 x 72 (bitwise equal to its plain
     version and across two runs), tri_refine at the bench frame's
     recorded groups (M = 2048, R = 4, the pose table expanded), at a
     random keyframe-pair problem (M = 2048, R = 2), at M = 37, R = 5 and
     at M = 2048, R = 8, and intra_pairs at the bench frame's recorded
     descriptors and Sampson gate (C = 4, N = 768) and at random C = 2, 3
     and 5 ones (bitwise equal to their plain versions and across two
     runs; the bench frame's call also captured in a CUDA graph and
     replayed twice, its arrival counters back at zero after each), and
     the intra match's glue kernels (intra_gate, intra_groups,
     tri_gather) at the bench frame's recorded calls and at random C = 2,
     3 and 5 ones (N = 333, 129, 1000), each twice and against its plain
     version, bitwise equal, the three bench calls also captured in one
     CUDA graph and replayed twice; the
     ORB glue's kernels (orb_kernels) at bench frame 0's recorded inputs
     and at random shapes (the pyramid at 1 x 97 x 133 with 8 levels,
     C = 2, 3, 5 and 2 x 240 x 320 with 10 levels in two launches; the
     selection on plateau-tied candidates at C = 1, 2,
     3, 5, with and without compaction and padding; the descriptors of
     noise patches at 32 and 16 bins), bitwise equal to their plain
     versions and across two runs (orb_select also through two graph
     replays; the pyramid within 1e-6 of its earlier GEMM form, the
     angle equal to torch.atan2 of the plain moments), then the bench
     frame's extraction card against CPU (level 0 exactly, the level >= 1
     keypoint share printed, >= 95 %); the RANSAC kernels (ransac_kernels)
     at the inputs bench frame 1's step gives them with its portfolio
     forced (the score at K = 1, 512, 256 and 3 against M = 2048
     correspondences, kabsch_hyp at K = 512, pnp_hyp at K = 256), each
     twice (bitwise equal) and against its plain version under the
     criteria of check_score and check_hypotheses (RANSAC_*); the
     tracking glue's kernels (track_kernels) at the calls bench frame 1's
     fast-path step makes (C = 4, M = N = 2048, L = 4096) and at a random
     odd shape (C = 3, M = 2049, N = 2047, L = 4097), each twice and
     against its plain version on the card, bitwise equal; track
     one frame of a
     small 2-camera scene on the kernels
     (CUDA) and on the plain versions (CPU) and hold the two poses to
     1e-3; run tests/test_torch_kernels.py's session scene (3 cameras,
     320x240, one level, 8 frames) on the card and on the CPU and print
     the position gap per frame against SESSION_GAP; solve a stage-C-shaped window (K=6, Ok=1365, L=2048, C=4) with
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
     0.1 m / 0.02 rad of ground truth; each of the nineteen frame
     kernels' launch counters (the four of the nine, the three ORB glue
     kernels, tri_refine, intra_pairs, the three intra glue kernels, the
     three RANSAC kernels and the four tracking glue kernels) must be > 0
     after this phase (counters are reset right before it); the RANSAC
     kernels' launches of each drive are printed: the forced-portfolio
     drive scores 4 times and makes each hypothesis batch once per frame
     (kabsch_hyp's and pnp_hyp's launches in the kernels line), the
     fast-path drive scores once per fast-path frame;
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
     write-back; on the card the fused frame step and the window solve
     replay CUDA graphs, utils/graphs). First the same session eager
     (cuda_graphs=False), the reference; then the session runs under a
     device trace with the launch counters reset right before it. A
     replay runs no wrapper, so the default-route kernels' launches
     are counted in the trace (main_path_session): each > 0 and equal
     to the reference's plus the graph warm-ups' (the kernels line's
     launches), and each wrapper counter > 0 (the warm-ups and the
     eager frames). It must end INITIALIZED with no failure, >= 7
     keyframes and ATE <= 0.1 m after finalize(); then 12 frames under
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
  7. visual-inertial and GPS path: preintegrate and predict on CUDA
     tensors against the CPU (1e-5); (a) the stage D window solve
     (ba_vio.vio_solve, K=6, Ok=1365, L=2048, C=4, 5 IMU factors of 40
     samples over 0.2 s; synthetic.random_vio_problem) without GPS and
     with 6 GPS factors (4 valid), warm (1 x 2) and cold (8 x 2), on the
     card under set_sync_debug_mode("error") against the CPU (VIO_TOL),
     ba_linearize launched inside it; (b) a 24-frame VIO + GPS session
     through process_image on the scene's rig and landmarks along
     analytic_circle_imu's circle (200 Hz IMU, a fix per frame,
     imu_init_samples=40, otherwise SlamConfig defaults), first eagerly
     (the reference, its launches counted), then graphed under a device
     trace: IMU and state initialized, no failure, >= 1 VIO solve, >= 1
     fix attached, ATE from the init frame <= 0.13 m, the five
     default-route kernels launched, each kernel's count in the trace
     (graph replays included) equal to the eager session's plus the
     graphs' warm-ups', the one cold VIO solve eager and every warm one a
     replay; its VIO program keys (capture ms, pool, replays) beside the
     count of the warm solves' index patterns;
     (c) tests/test_slam_vio.py's low-rate GPS dummy-keyframe drive at the
     feature level: dummy keyframes at non-vision timestamps, each with a
     fix; each with its launch counters reset right before it;
  9. loop closure and relocalization (run after phase 7, before the
     timing), each part with its launch counters reset right before it:
     (a) the global solve (ba_solve, 10 x 2) at tests/test_global_ba.py's
     shape (K=64, Ok=256, L=2048) on the card under
     set_sync_debug_mode("error") against the plain solve on the CPU
     (1e-3), and at the SlamConfig cap (K=64, Ok=512, L=8192) on the card
     alone: the cost falls, poses finite, peak memory printed;
     ba_linearize launched; (b) a 40-frame loop session at the bench
     configuration plus final_global_ba through process_image
     (loop_trajectory around ring landmarks, textured blob images, a
     vocabulary trained on the first frames, tests/test_image_e2e.py's
     LoopConfig): INITIALIZED, no failure, loops >= 1, global BA >= 1,
     ATE <= LOOP_MAX_ATE, the default-route kernels launched; then
     the driver's _run_global_ba dispatches a deferred global solve under
     set_sync_debug_mode("error") and _finish_pending_gba lands it; (c)
     tests/test_loop_pipeline.py's 60-frame drift scene at the feature
     level with and without loop closure: a closure with a PGO bend, and
     the loop ATE below the VO ATE; (d) tests/test_hard_synthetic.py's
     retrieval corpus (104 database entries, 30 revisit queries, 20
     different-world negatives, 256x192, one camera) through the port's
     ORB, LoopCloser.retrieve_topn and the test's verification: precision
     >= 0.95, recall >= 0.85, no false fire; (e) (c)'s map and BoW
     database saved: the Relocalizer relocalizes a seen frame within
     0.1 m and the FastTracker refines a perturbed prediction within
     0.05 m, pose_lm, hamming_argmin2, pnp_hyp and ransac_score launched;
  10. the loop path's timing: detection per keyframe (span, BoW
     transform, one verification with its launches), _close_loop, the
     global solve at both shapes (CUDA events, device time and ops),
     relocalize and fast-track per frame with their launches;
  11. the app and data path (after phase 10), each part with its launch
     counters reset right before it: (a) phase 5's 24 frames written as
     8-bit PGM folders with 19-digit ns names, a Kalibr camchain of the
     bench rig, frontend / backend YAML (bench.py's nFeatures / nLevels),
     a vocabulary trained on the first 6 frames and a cfg with map,
     database, graph log, calc_depth and a dense cloud, through
     apps.mc_slam_app.main with its default device (the card; so is
     the EuRoC runner's below): rc 0, 24 TUM rows, >= 7
     keyframes, ATE <= APP_MAX_ATE (from the CPU rehearsal,
     `python3 chip_smoke.py --rehearse-app`), a finite depth map per
     keyframe that tracking inserted, a non-empty cloud, map and database
     written, the default-route kernels launched; then a map-reuse
     run of 8 frames with relocalization and fast tracking: rc 0, 8 rows,
     ATE <= 0.25 m; (b) the same drive in EuRoC's ASL layout through
     apps.run_euroc: rc 0, every frame associated, ATE <= APP_MAX_ATE;
     then the reader's decode time per frame, the app's per-frame wall
     time (keyframe frames and the others apart) and the session's device
     busy share; (c) depth_from_rig_pair box and SGM at VGA with D = 64
     on the bench pair and on a pair whose camera 1 is yawed by 3 degrees
     (the rectifying remap), card against CPU: >= 99 % equal integer
     winners, depth within 1e-4 relative where they agree; each call's
     time (CUDA events, device ms and ops), sgm_scan launched once per SGM
     call and never by box, the rectifier rebuild's host time, and
     DenseFuser.add_keyframe on 3 keyframes (one sgm_scan launch each);
     the app's run of (a) must launch sgm_scan (its dense cloud's fuser),
     and that count is the kernels line's;
  12. the generic BA layout, replay, the mesh and the entry (after phase
     11): (a) ba_solve's default generic layout on the stage C problem,
     warm and cold, on the card under sync-debug "error", twice
     (bit-equal), against the CPU's generic solve and the card's
     kf-blocked one (poses 1e-3), with its time, device time, ops and
     peak memory beside the kf-blocked solve's; (b) the graph logs that
     phase 5's session and phase 7's VIO + GPS session wrote, replayed on
     the card (replay_graph_logs at 65536 slots: the cost falls, two
     replays bit-equal, n_obs and cost_in as the CPU's; the VIO replay
     with tests/test_replay_and_utils.py's gates); (c) a 4-shard mesh
     (distinct cards where the machine has four, else all shards on
     cuda:0; printed): the observation-sharded solve at the stage C shape
     (5e-4) and the landmark-sharded one at the global test shape (5e-3)
     against one device under sync-debug "error", and at the SlamConfig
     cap with its peak memory; sharded_hamming_match exactly the
     single-device match; sharded_build_frame of bench frame 0 bit-equal
     to build_frame with fast_select and patch_gather launched once per
     shard; a 24-frame session with mesh= (INITIALIZED, ATE <= 0.1 m,
     the four frame kernels launched) beside phase 8's session; (d)
     entry()'s forward and dryrun_multichip(4) on the card;
  13. the native loader, MCRAW replay, the live viewer and the dataset
     tools (after phase 12), each part with its launch counters reset
     right before it: (a) a probe that builds nothing prints g++'s path
     and version, whether png.h and jpeglib.h are on its include path
     and matplotlib's version; a part that needs what the probe found
     missing prints `not run: ...` (decided by the probe only); (b)
     phase 11 (a)'s 24 PGM frames in an MCRAW container: written by
     apps.convert_to_mcraw where the library builds (and then equal,
     byte for byte, to the container written by numpy in
     native/loader.cpp's layout), else written by numpy in that layout;
     McrawReader (no library) gives the uint8 frames / 255 bit for bit,
     NativePrefetchReader (the library) the PGM rasters times
     float32(1 / 255) bit for bit (within 6e-8 of ImageFolderReader's);
     each reader's decode time per 4-camera frame; (c) apps.mc_slam_app
     on the card with mcraw_path, and --live_view where matplotlib is
     present: rc 0, 24 TUM rows, ATE <= APP_MAX_ATE, the five
     default-route kernels launched; with the viewer, the PNG decodes,
     the HTML page exists, the viewer rendered during the session; its
     per-frame wall time and busy share beside phase 11 (a)'s run from
     the PGM folders; (d) apps.evaluate_trajectory --plot
     writes a PNG that decodes; (e) apps.train_vocabulary on the card:
     fast_select and patch_gather launched, the vocabulary has its
     words; extract_orb on bench frame 0, card against CPU (level 0
     exact, levels >= 1 shared at >= 95 %, descriptors >= 99.5 %); (f)
     utils/profiling.device_trace writes a trace naming
     fast_select_kernel, sync returns;
  8. timing: for each kernel the CUDA-event time of its wrapper call, of
     its plain version and, where one exists, of the one PyTorch call
     that computes the same function (the advanced-indexing gather for
     the two plain patch gathers); its device time and the wrapper's
     from torch.profiler (a trace that misses the kernel fails the run);
     and the least time the card could take for the work (bytes at 3.35
     TB/s or operations, the larger: at 67 TFLOP/s, or for the FAST rows
     by instruction class, counting the arc trees only where this run's
     data passes the compass pre-test, and for the two Hamming rows the
     +-1 product at the int8 tensor-core rate against the epilogue by
     class),
     the pose LM at B = 2 and at B = 1, tri_refine at M = 2048 with R = 2
     and R = 8 (each record's "at", by shape), fast_select
     on uniform noise (the record's "on_noise"), ba_linearize's wrapper the
     solve's prepared call (one device op per call, checked);
     the warm and cold window solves (CUDA events, plus device time and
     device-op count from one torch.profiler run each), the per-frame
     build+track time on both paths and both routes, the per-frame
     process_image wall time of a second session, keyframe frames and the
     others apart, the stage D VIO solves warm and cold with and without
     GPS (as the window solves), eager and replayed through phase 14's
     programs, and the per-frame process_image wall time of a VIO + GPS
     session graphed (a third, untraced) and eager (phase 7 (b)'s
     reference) by kind (keyframe, other and capture frames) and in all.
  14. the graphed frame step and window solve (after phase 5): (a)
     frames 1 and 2 of the phase 3 drive, each from the same inputs and
     generator state through the eager _build_and_track_step (host
     branch) and through a captured program (utils/graphs, the portfolio
     a conditional node on the device), one per fastpath_frac: the
     fast-path program replayed with its predicted pose flipping the
     branch (identity, a yaw of YAWS that leaves the fast path,
     identity), the forced-portfolio one once: all 18 outputs bit-equal,
     the flags as planned, each replay's launches in its device trace
     equal to the eager frame's; the fast-path frame's wall, device
     time, device ops and host-issued launches, graphed and eager, and
     the device time of the IF node's condition kernel beside its bytes
     bound (COND_BYTES), and beside the frame before the intra match's
     glue kernels (FRAME_BEFORE; the frame build's stages and the tracking
     half's parts apart: scripts/frame_stage_split.py); the stage C
     window solve warm and
     cold, eager and through the session's graphed solve
     (driver_window._replay_solve) on its side stream:
     bit-equal, wall and device time of both; the stage D VIO solve
     (phase 7 (a)'s problems) warm and cold, without and with GPS, eager
     and through driver_window._replay_vio_solve, then a window with its
     IMU pairs and GPS fixes rolled through the same program: bit-equal,
     each program's capture ms and pool; (b) phase 5's session
     eager (its reference run) and graphed, host syncs counted per
     frame (sync debug mode "warn"): both INITIALIZED, no failure, >= 7
     keyframes, ATE <= 0.1 m; one frame-program replay per fused frame;
     exactly one host sync (the packed fetch) on every steady frame (no
     keyframe, no solve landing, no capture); (c) each session's
     per-frame wall by kind (other / keyframe / capture frames) beside
     PERF.md §2's 50 / 100 ms limits, every program's capture ms, pool
     bytes and replays, and each session's device busy share;
The last lines are the script's time from start to end, the card's
name and power limit (nvidia-smi), the kernels JSON record and {"ok":
true, "device": {...}}.
Needs one CUDA card; exits non-zero without one.
`python3 chip_smoke.py --rehearse-app [SEEDS]` runs phase 11 (a) and (b)
on the CPU with the plain versions instead, once per driver RANSAC seed,
and prints the ATEs that APP_MAX_ATE is set against, then phase 13
(b)-(d) on the CPU (no smoke result); with `--as-probed
g++,png.h,jpeglib.h,matplotlib` (any of them) last, phase 13 runs as
where the probe found those missing.
`python3 chip_smoke.py --rehearse-mesh` runs phase 12 (b)-(d) on the CPU
with the plain versions (the replays at 16384 slots), every gate, no
timing (no smoke result).
"""

from __future__ import annotations

import collections
import faulthandler
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

# Tear CUPTI down at the end of every profiler trace. Left initialized
# from one trace to the next (this torch's default), it crashed the
# process: on an NVIDIA H100 under torch 2.11, phase 8's trace of the
# graphed cold VIO solve with GPS (27943 nodes, none of them tri_refine
# or intra_pairs) hit a segmentation fault on the host in the graph's
# replay, in every run with tri_refine and intra_pairs as first written
# (one thread per point; two launches); with the teardown every run
# passes. With their redesigns, and then with the ORB glue's kernels,
# four runs without the teardown passed, the cause still unknown, so it
# stays. scripts/kernel_guard.py finds no write of those kernels outside
# their buffers;
# scripts/segv_backtrace.c prints the native frames of such a crash. Set
# before torch loads its profiler.
os.environ.setdefault("TEARDOWN_CUPTI", "1")


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
# the visual-inertial phase: (a) the stage D window solve (bench.py:209-251:
# K=6, Ok=1365, L=2048, C=4, 5 IMU factors of 40 samples over 0.2 s) on
# synthetic.random_vio_problem, without GPS and with VIO_GPS GPS factors
# (4 valid), on the card against the CPU within VIO_TOL (card and CPU
# solve the damped step in float64; the vision sums differ in order; at
# most 2.8e-6 measured on an NVIDIA H100 80GB HBM3 at 700 W);
# (b) a VIO + GPS session of VIO_FRAMES frames through process_image on
# the scene's rig and landmarks along analytic_circle_imu's circle, held to
# VIO_MAX_ATE after its init (the single-run ceiling named by
# tests/test_slam_vio.py); (c) tests/test_slam_vio.py's low-rate GPS
# dummy-keyframe drive at the feature level (DUMMY_FRAMES frames, vision
# every 3rd).
VIO_GPS, VIO_FRAMES, VIO_MAX_ATE, DUMMY_FRAMES = 6, 24, 0.13, 30
VIO_TOL = dict(poses=1e-4, vels=1e-4, biases=1e-4, E_T_V=1e-4)
VIO_IMU = dict(accel_noise=2e-3, gyro_noise=2e-4)
VIO_BIAS = dict(accel_bias=(0.02, -0.01, 0.015),
                gyro_bias=(0.001, -0.0005, 0.002))
LLA0 = (42.36, -71.06, 10.0)
# the VIO factor kernel (phase 2, vio_factor_kernels): case -> (K, GPS
# factors, IMU slots or None for K - 1, a between table): the stage D
# problem of phase 7 (a) without GPS, with VIO_GPS GPS factors, and with
# them and a between table (a random constraint, one at so3_log's small
# branch, one joining a keyframe to itself, one invalid); at K = 12 with
# 11 IMU and 12 GPS factors (N = 186: three factors a block of the
# cluster, 24 rows a band); and with 60 IMU slots, 55 of them padding
# (nine factors a block, so a warp takes two; the copies of every
# factor's blocks would exceed a block's shared memory, so they are read
# from the scratch, L2, and each entry's start is loaded when it is
# placed, as in a window too large for shared memory). check_vio_factors
# holds each to the
# plain version: J and r of every factor equal or 1 float32 ulp apart, or
# within VIO_J_FLOOR of the table's largest |J| (a float64 rounding
# residue cast to float32); every entry of the factors' records and of
# H, g and the cost within vio_sum_bounds' bound of its own terms, and
# the largest error of H, g and the cost within VIO_FACTOR_TOL of the
# largest entry of their factor parts
VIO_FACTOR_CASES = {
    "imu": (6, 0, None, False),
    "imu+gps": (6, VIO_GPS, None, False),
    "imu+gps+between": (6, VIO_GPS, None, True),
    "K=12 imu+gps": (12, 12, None, False),
    "60 IMU slots+gps": (6, VIO_GPS, 60, False),
}
VIO_KERNELS = ("vio_factors",)  # on the VIO path only (phase 7)
VIO_FACTOR_TOL, VIO_J_FLOOR = 1e-6, 2.0 ** -40
# float32 roundings of one term of a record's or H's sum besides the
# sum's own: fl(w J_a), its product with J_b (or r), the merge of a
# keyframe's own columns into J_a and J_b, and w (GPS: 1 / sigma^2)
VIO_TERM_ROUNDINGS = 5
# float64 operations (+ - * / sqrt sin cos atan2 sincos, one each) of one
# lane, one tangent direction, of csrc/vio_dual.cuh's residuals at generic
# states (tests/test_torch_vio_kernels.py counts them with its host build);
# a factor takes one lane per tangent column (30 IMU, 12 GPS / between)
VIO_DUAL_OPS = dict(imu=1555, gps=234, between=1036)
# and the lane's critical path: (the depth of its deepest output, each
# result one deeper than its deepest input; the long-latency operations
# / sqrt sin cos atan2 sincos on that chain), counted by the same build
VIO_DUAL_DEPTH = dict(imu=(50, 4), gps=(14, 0), between=(45, 3))
# float64 at 34 TFLOP/s without the tensor cores (NVIDIA's H100 SXM data
# sheet), each operation counted as one
F64_OPS_PER_S = 34e12
# the loop-closure phase: (a) the global solve (10 x 2 LM steps, the
# driver's global_ba_iters) at tests/test_global_ba.py's shape (64
# keyframes, global_ba_lm_capacity 2048, global_ba_obs_per_kf 256) and at
# the SlamConfig cap (global_ba_max_kfs 64, global_ba_lm_capacity 8192,
# global_ba_obs_per_kf 512), as (K, L, O); (b) a LOOP_FRAMES-frame loop
# session at the bench configuration (LOOP_REVISIT frames revisit the
# start; LOOP_LMS ring landmarks; a vocabulary from LOOP_TRAIN frames;
# tests/test_image_e2e.py's LoopConfig), its ATE gate set from the CPU
# rehearsal of scripts/loop_rehearsal.py (PERF.md); (c)
# tests/test_loop_pipeline.py's DRIFT_FRAMES-frame drift scene; (d)
# tests/test_hard_synthetic.py's retrieval corpus; (e) relocalization of
# frame RELOC_FRAME of (c) against its saved map: a revisit frame, where
# the closed map is consistent (older keyframes reproject their own
# landmarks at up to tens of px in both packages, ROADMAP Queue 3).
GBA_ITERS = 10
GBA_STEP = 0.002  # rad per keyframe: the slab stays ahead of all 64
GBA_TEST, GBA_CAP = (64, 2048, 64 * 256), (64, 8192, 64 * 512)
# phase 12: the mesh's shard count; the sharded match's map rows (not a
# multiple of the 4 x 8 padding) and queries; the sharded solves' pose
# bounds against one device (tests/test_parallel.py: observation-sharded
# 5e-4, landmark-sharded 5e-3) and the generic layout's against the
# kf-blocked one (tests/test_backend.py, 1e-3); the replay's observation
# capacity (the JAX package's default; the CPU rehearsal takes the JAX
# tests' 16384)
MESH_SHARDS = 4
MESH_MATCH = (4093, 2048)
MESH_TOL = dict(obs=5e-4, lm=5e-3, generic=1e-3)
REPLAY_CAPACITY = 65536
LOOP_FRAMES, LOOP_REVISIT, LOOP_LMS, LOOP_TRAIN = 40, 8, 1200, 6
LOOP_CFG = dict(dislocal=8, k_consistency=1, min_nss=0.01, alpha=0.1,
                min_matches=12, min_inliers=10)
# the bench session's own ATE gate (MAX_ATE), 2.2x the worst of the CPU
# rehearsal's two RANSAC seeds (0.0444 / 0.0422 m, PERF.md)
LOOP_MAX_ATE = 0.1
DRIFT_FRAMES, RELOC_FRAME = 60, 53
RET_W, RET_H, RET_F = 256, 192, 210.0
RET_DB, RET_Q, RET_NEG = 104, 30, 20
# the app and data phase: (a) the session's APP_FRAMES frames as 8-bit PGM
# folders at APP_FPS through mc_slam_app (a vocabulary from the first
# APP_VOCAB frames), its ATE gate set from the CPU rehearsal
# (`python3 chip_smoke.py --rehearse-app`, PERF.md), then a map-reuse run
# of REUSE_FRAMES frames held to tests/test_app_cli.py's 0.25 m; (b) the
# same drive through the EuRoC runner; (c) depth_from_rig_pair at VGA with
# D = STEREO_D on the bench pair and on a pair yawed by STEREO_YAW degrees,
# card against CPU (STEREO_SHARE equal winners, STEREO_REL relative
# depth where they agree), and DenseFuser on the frames FUSE_KFS. The
# rehearsal read 0.0539 m for the app and the runner at both driver RANSAC
# seeds 0 and 1 (the same trajectory), so APP_MAX_ATE is the session's
# own gate, 1.9x that.
APP_FRAMES, APP_FPS, APP_VOCAB, APP_MAX_ATE = SESSION_FRAMES, 20.0, 6, MAX_ATE
REUSE_FRAMES, REUSE_MAX_ATE = 8, 0.25
STEREO_D, STEREO_YAW, STEREO_SHARE, STEREO_REL = 64, 3.0, 0.99, 1e-4
FUSE_KFS = (0, 8, 16)

# The least time of a kernel's work: bytes over the H100 SXM's 3.35 TB/s,
# and the time of its operations. The rows other than FAST, SGM and the
# two Hamming rows count operations at 67 TFLOP/s float32 outside the
# tensor cores (each scalar operation counted as one; the published peak
# counts an FMA as two), so they compare with earlier runs.
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
# The two Hamming rows (hamming_argmin2, intra_pairs) count by instruction
# class too: the distance is an exact +-1 product of the descriptors' bit
# planes, PM1_OPS int8 operations per pair (256 multiply-adds) at the
# dense int8 tensor-core rate; the rest is the epilogue, in integer
# operations at the compare-class rate and, for the matcher's gate, f32
# multiply-adds at the issue rate. The tensor cores and the other pipes
# overlap, so a row takes the longer of the two (pm1_ops_s).
INT8_OPS_PER_S = 1979e12
PM1_OPS = 2 * 256
# hamming_argmin2 per pair: the distance from the product (subtract,
# shift), the gate's compare and the code's select, the row's key and its
# best / second (or, min, max, min); with the column argmin the column's
# key and minimum (2 more); and one f32 multiply-add per gate factor
HAMMING_INT_OPS = (8, 2)
POSE_OPS = 260  # per observation and LM iteration: projection through rig
#                 and camera, residual, Huber weight, 2x6 Jacobian, the
#                 JtJ / Jtr sums, and the trial step's cost
BA_OPS = 300  # per observation: projection, 2x6 and 2x3 Jacobians, weight,
#               the 30 payload channels and 27 Hpp / gp sums
# (add, compare / min) operations per cost-volume element of the SGM scan:
# per path 3 adds ((c + best) - m, + p1) and 4 minima (3 in best, about 1
# of the line's minimum), then the 3 adds of the four paths' sum
SGM_OPS = (4 * 3 + 3, 4 * 4)
# operations of tri_refine per ray and per point, counted from the
# algorithm (csrc/tri_refine.cu): per ray the unit ray and its share of
# the normal equations (~80), of each of the 5 Gauss-Newton steps
# (projection, residual, Jacobian, JtJ / Jtr: ~100) and of the gate (~30);
# per point the 6 cofactor solves (~60 each)
TRI_OPS = (80 + 5 * 100 + 30, 6 * 60)
# intra_pairs per (pair, row, column) cell: the distance from the product
# (2), the gate and the two validities and the code's select (3), the row's
# key and its best / second (4), the column's key and minimum (2)
INTRA_INT_OPS = 11
TRI_INTRA = ("tri_refine", "intra_pairs")
# the frame build's glue around them (frontend/intra_cuda): the Sampson
# gate, the groups with their stable top-k, the triangulation's gathers
INTRA_GLUE = ("intra_gate", "intra_groups", "tri_gather")
# operations of the gate per (pair, row, column) cell (the dot t 4, t^2,
# the denominator 2, the clamp, the division, the compare)
GATE_OPS = 10
# the ORB extraction's glue kernels (ops/orb_cuda.py), on the default route
ORB_KERNELS = ("orb_pyramid", "orb_select", "orb_describe")
# the RANSAC kernels (frontend/ransac_cuda.py): the score runs on every
# frame, the two hypothesis kernels only off the fast path (the portfolio)
RANSAC_KERNELS = ("ransac_score", "kabsch_hyp", "pnp_hyp")
PORTFOLIO = ("kabsch_hyp", "pnp_hyp")
# the tracking step's glue kernels (frontend/track_cuda.py): both matches'
# gate prologues and epilogues, each once a frame
TRACK_KERNELS = ("track_gate", "track_epilogue", "localmap_gate",
                 "localmap_epilogue")
# the graphed fast-path frame before the intra match's glue kernels, its
# device ops and device ms (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke
# phase 14 on the tree before them)
FRAME_BEFORE = (266, 0.760)
# bytes the graphs' condition kernel moves: it reads the 1-byte predicate
# and the 8-byte conditional handle and writes the 4-byte condition
COND_BYTES = 1 + 8 + 4
# the SGM kernel's odd shape of phase 2 (D, H, W), beside VGA at STEREO_D,
# and two small aligned ones (D = 128 and D = 33 across the tiles' edges)
SGM_ODD = (48, 37, 53)
SGM_SMALL = ((128, 64, 96), (33, 72, 128))
# the RANSAC kernels (frontend/ransac_cuda) against their plain versions:
# a score's inlier flag may differ only where |err2 - px^2| <= RANSAC_EDGE
# px^2 (err2 recomputed in float64), a count by at most its number of such
# flags, the winner only where its margin is within them; hypotheses
# scoring RANSAC_GOOD of the best within RANSAC_POSE of the plain
# version's, unless one of the two float32 solves is itself RANSAC_POSE
# from the float64 solve (check_hypotheses), the winners' counts within
# RANSAC_COUNT; a factorization that fails on one side only for at most
# RANSAC_ONE_SIDED of the hypotheses
RANSAC_EDGE, RANSAC_POSE, RANSAC_GOOD, RANSAC_COUNT = 1e-5, 2e-2, 0.8, 0.02
RANSAC_ONE_SIDED = 0.02
# operations per hypothesis and correspondence of the score (two 3 x 3
# transforms with translation 24, the projection 8, the error and the
# gate 6), and per hypothesis of the solvers (csrc/kabsch_hyp.cu: the
# covariance 50, Faddeev-LeVerrier 3 x 112, 12 Newton steps x 16, 16
# determinants x 14 and the rotation 60; csrc/pnp_hyp.cu: G over R rows
# N (N + 1) R, the factor N^3 / 3, each solve 2 N^2 and its norm 2 N)
SCORE_OPS = 38
KABSCH_OPS = 50 + 3 * 112 + 12 * 16 + 16 * 14 + 60
NEWTON_OPS = 16  # of KABSCH_OPS, a Newton step's


def kabsch_ops(idx, X_rig, X_world) -> float:
    """Operations of kabsch_hyp on these samples: KABSCH_OPS a hypothesis
    but for the Newton steps, of which each counts those it needs to its
    first bitwise fixed point (alignment.newton_fixed_steps: the plain
    arithmetic; the kernel's warp runs them to its slowest quad's)."""
    from mcslam_tpu_torch.geometry import alignment

    K_ = alignment.davenport(X_rig[idx], X_world[idx])[0]
    steps = int(alignment.newton_fixed_steps(K_).sum())
    return idx.shape[0] * (KABSCH_OPS - 12 * NEWTON_OPS) + steps * NEWTON_OPS


def pnp_ops(K: int, S: int, noncentral: bool) -> float:
    """Operations of K pnp_hyp hypotheses: the first K // 2 central (12
    columns, 2 S rows, 5 solves), the rest generalized where noncentral
    (13 columns, 3 S rows, 10 solves, 5 deflations)."""
    def one(N, R, solves):
        return N * (N + 1) * R + N ** 3 / 3 + solves * (2 * N * N + 2 * N) \
            + 400
    kc = K // 2
    gen = one(13, 3 * S, 10) + 5 * 4 * 13 if noncentral else one(12, 2 * S, 5)
    return kc * one(12, 2 * S, 5) + (K - kc) * gen


def score_edges(hyp, X, uv, cam, f, px):
    """(K, M) |err2 - px^2| <= RANSAC_EDGE px^2 of the plain score's
    projections, recomputed in float64: where a flag may differ."""
    import torch

    X, uv, cam, f, T = (a.double() for a in (X, uv, cam, f, hyp))
    R, t = T[:, :3, :3], T[:, :3, 3]
    q = torch.einsum("kji,kmj->kmi", R, X[None] - t[:, None])
    p = torch.einsum("mij,kmj->kmi", cam[:, :3, :3], q) + cam[None, :, :3, 3]
    z = torch.where(p[..., 2] > 0.05, p[..., 2], torch.ones_like(p[..., 2]))
    pred = p[..., :2] / z[..., None] * f[None, :, :2] + f[None, :, 2:]
    err2 = ((pred - uv[None]) ** 2).sum(-1)
    return (err2 - px * px).abs() <= RANSAC_EDGE * px * px


def check_score(name, k, counts, flags, edges) -> dict:
    """The score kernel's outputs k (counts, best, pose, count, inliers)
    against the plain version's counts and (K, M) flags, under the
    criteria; -> the flags and counts that differ and the edge flags."""
    import torch

    n_edge = edges.sum(-1)
    check(bool(torch.all((k[0] - counts).abs() <= n_edge)),
          f"{name}: a count differs by more than its edge flags")
    b = int(k[1])
    check(int(k[3]) == int(k[0][b]) == int(k[4].sum()),
          f"{name}: the winner's count and mask disagree")
    check(bool(torch.all((k[4] == flags[b]) | edges[b])),
          f"{name}: the winner's inlier flags differ away from the edge")
    top = torch.sort(counts, descending=True).values
    margin = int(top[0] - top[1]) if counts.numel() > 1 else 1 << 30
    if margin > 2 * int(n_edge.max()):
        check(b == int(torch.argmax(counts)),
              f"{name}: winner {b}, the plain version's "
              f"{int(torch.argmax(counts))}")
    return dict(counts_differ=int((k[0] != counts).sum()),
                flags_differ=int((k[4] != flags[b]).sum()),
                edge_flags=int(n_edge.sum()), winner=b,
                plain_winner=int(torch.argmax(counts)))


def check_hypotheses(name, hk, hp, h64, ck, cp, structural=()) -> dict:
    """Hypotheses of a kernel hk against its plain version's hp (h64: the
    plain version in float64; ck, cp: their counts) under the criteria;
    `structural` hypotheses must be NaN in both -> what was compared."""
    import torch

    nk = torch.isnan(hk).any(dim=(1, 2))
    np_ = torch.isnan(hp).any(dim=(1, 2))
    for k in structural:
        check(bool(nk[k]) and bool(np_[k]),
              f"{name}: hypothesis {k} is not NaN in both")
    one_sided = int((nk != np_).sum())
    check(one_sided <= 1 + RANSAC_ONE_SIDED * hk.shape[0],
          f"{name}: {one_sided} factorizations fail on one side only")
    check(bool(torch.all(ck[nk] == 0)) and bool(torch.all(cp[np_] == 0)),
          f"{name}: a NaN hypothesis scored inliers")
    good = (cp >= RANSAC_GOOD * cp.max()) & ~nk & ~np_

    def dist(a, b):
        return (a.double() - b.double()).abs().amax(dim=(1, 2))

    dk, dp, dkp = dist(hk, h64), dist(hp, h64), dist(hk, hp)
    rounding = good & ((dk > RANSAC_POSE) | (dp > RANSAC_POSE))
    apart = good & (dkp > RANSAC_POSE)
    check(bool(torch.all(rounding[apart])),
          f"{name}: {int((apart & ~rounding).sum())} hypotheses apart by "
          f"more than {RANSAC_POSE} where both float32 solves are within it "
          f"of the float64 one")
    n_k, n_p = int((good & (dk > RANSAC_POSE)).sum()), \
        int((good & (dp > RANSAC_POSE)).sum())
    check(n_k <= n_p + max(2, 0.05 * int(good.sum())),
          f"{name}: {n_k} good hypotheses of the kernel {RANSAC_POSE} from "
          f"the float64 solve, of the plain version {n_p}")
    best_k, best_p = int(ck.max()), int(cp.max())
    check(abs(best_k - best_p) <= RANSAC_COUNT * best_p,
          f"{name}: best count {best_k}, the plain version's {best_p}")
    within = good & ~rounding
    return dict(good=int(good.sum()), rounding=int(rounding.sum()),
                max_abs_err=float(dkp[within].max()) if within.any() else 0.0,
                one_sided=one_sided, best=best_k, plain_best=best_p,
                nan=int(nk.sum()))


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
              "patch_oriented_kernel": "patch_oriented_kernel",
              "sgm_tile_kernel<2>": "sgm_tile_kernelILi2E",
              "tri_refine_kernel<2>": "tri_refine_kernelILi2E",
              "tri_refine_kernel<4>": "tri_refine_kernelILi4E",
              "tri_refine_kernel<8>": "tri_refine_kernelILi8E",
              "intra_pairs_kernel": "intra_pairs_kernel",
              "pyramid_tile_kernel": "pyramid_tile_kernel",
              "orb_select_one_kernel": "orb_select_one_kernel",
              "orb_describe_kernel": "orb_describe_kernel",
              "ransac_score_kernel": "ransac_score_kernel",
              "kabsch_hyp_kernel": "kabsch_hyp_kernel",
              "pnp_hyp_kernel": "pnp_hyp_kernel",
              **{f"{n}_kernel": f"{n}_kernel" for n in TRACK_KERNELS},
              **{f"{n}_kernel": f"{n}_kernel" for n in INTRA_GLUE},
              "vio_factors_kernel": "vio_factors_kernel"}
# of those, the ones that must use no local memory and spill nothing
NO_LOCAL = ("pose_lm_cluster_kernel", "fast_select_kernel",
            "fast_corners_kernel<true>", "fast_corners_kernel<false>",
            "linearize_kernel", "patch_oriented_kernel", "sgm_tile_kernel<2>",
            "tri_refine_kernel<2>", "tri_refine_kernel<4>",
            "tri_refine_kernel<8>", "intra_pairs_kernel",
            "pyramid_tile_kernel", "orb_select_one_kernel",
            "orb_describe_kernel", "ransac_score_kernel", "kabsch_hyp_kernel",
            "pnp_hyp_kernel", *(f"{n}_kernel" for n in TRACK_KERNELS),
            *(f"{n}_kernel" for n in INTRA_GLUE))


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


def pm1_ops_s(cells: float, add_ops: float, int_ops: float) -> float:
    """Seconds of a Hamming kernel's operations: the +-1 products of
    `cells` pairs on the tensor cores against the epilogue's add_ops f32
    and int_ops integer operations (class_ops_s)."""
    return max(cells * PM1_OPS / INT8_OPS_PER_S, class_ops_s(add_ops, int_ops))


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

        spec = synthetic.SyntheticRigSpec(num_cams=C, image_size=(W, H))
        if dev.type == "cuda":
            self.rig = synthetic.make_synthetic_rig(spec)
            check(self.rig.device.type == "cuda", "the rig is not on the card")
        else:  # a CPU rehearsal
            self.rig = synthetic.make_synthetic_rig(spec, device=dev)
        self.poses = synthetic.smooth_trajectory(frames, step_angle=0.02)
        self.lms = synthetic.make_landmarks(3000, depth_range=(4.0, 15.0))
        imgs = synthetic.render_blob_images(self.rig, self.poses, self.lms)
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
    ham_bytes = ham_pairs = ham_add = ham_int = 0
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
        ham_pairs += M * N
        ham_add += M * N * args[2].shape[1]
        ham_int += M * N * (HAMMING_INT_OPS[0]
                            + (HAMMING_INT_OPS[1] if want_cols else 0))
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
        nbytes=ham_bytes, ops_s=pm1_ops_s(ham_pairs, ham_add, ham_int))

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
        at={"B=1": pose[1]}, **pose[2])

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


def stereo_kernels(scene, rng, dev, kernels):
    """Phase 2, the SGM scan: the cost volume of the bench pair (cameras
    0 and 1 of frame 0) at D = STEREO_D and random ones at SGM_ODD and
    SGM_SMALL, each through the kernel twice and the plain version: all
    equal bit for bit."""
    import torch

    from mcslam_tpu_torch.ops import sgm_cuda, stereo

    cv = stereo.cost_volume(scene.imgs[0][0], scene.imgs[0][1], STEREO_D)
    volumes = [(f"{W}x{H} D={STEREO_D} (bench pair)", cv)] + [
        (f"{w}x{h} D={d} (random)",
         torch.from_numpy(rng.rand(d, h, w).astype(np.float32)).to(dev))
        for d, h, w in (SGM_ODD,) + SGM_SMALL]
    for name, v in volumes:
        k1, k2 = sgm_cuda.sgm_aggregate(v), sgm_cuda.sgm_aggregate(v)
        ref = sgm_cuda.sgm_aggregate_reference(v)
        torch.cuda.synchronize()
        check(torch.equal(k1, k2), f"sgm_scan {name}: two runs differ")
        check(torch.equal(k1, ref), f"sgm_scan {name}: differs from the "
              f"plain version by {float((k1 - ref).abs().max()):.3g}")
        print(f"# kernel sgm_scan {name}: bitwise equal to the plain version "
              f"and across two runs")
    n = cv.numel()
    kernels["sgm_scan"] = dict(
        route="cuda", source="mcslam_tpu_torch/csrc/sgm_scan.cu",
        replaces="mcslam_tpu/ops/stereo.py:69", max_abs_err=0.0,
        fn=lambda: sgm_cuda.sgm_aggregate(cv),
        plain=lambda: sgm_cuda.sgm_aggregate_reference(cv),
        symbols=("sgm_tile_kernel",), device_ops=3,
        nbytes=2 * cv.nbytes, ops_s=class_ops_s(SGM_OPS[0] * n,
                                                 SGM_OPS[1] * n))


def capture_calls(build, targets=None) -> dict:
    """{name: (args, kwargs)} of the first call of each module function
    of `targets` ({name: (module, attribute)}; by default the frame
    build's tri_refine and intra_pairs calls, the two kernels' inputs on
    its path) that build() makes; the calls go through unchanged."""
    from mcslam_tpu_torch.frontend import intra_cuda
    from mcslam_tpu_torch.geometry import triangulation

    if targets is None:
        targets = {"tri_refine": (triangulation, "triangulate_and_refine"),
                   "intra_pairs": (intra_cuda, "intra_pairs")}
    seen = {}
    saved = {n: getattr(m, a) for n, (m, a) in targets.items()}

    def record(name, fn):
        def wrapped(*a, **kw):
            seen.setdefault(name, (a, kw))
            return fn(*a, **kw)
        return wrapped

    for n, (m, a) in targets.items():
        setattr(m, a, record(n, saved[n]))
    try:
        build()
    finally:
        for n, (m, a) in targets.items():
            setattr(m, a, saved[n])
    check(set(seen) == set(targets),
          f"the frame build made no call of {set(targets) - set(seen)}")
    return seen


def tri_problem(rng, M, R, dev):
    """Per-point views (keyframe pairs at R = 2): world_T_cam (M, R, 4, 4)
    contiguous, R cameras 0.3 m apart with small yaws about a per-point
    offset; points 1-30 m ahead (a tenth behind the cameras, a tenth past
    40 m); pixels with 0.5 px noise, a tenth of the rays masked; sigma
    1.2^octave."""
    import torch

    poses = np.tile(np.eye(4, dtype=np.float32), (M, R, 1, 1))
    for r in range(R):
        a = 0.02 * (r - R / 2)
        poses[:, r, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                               [-np.sin(a), 0, np.cos(a)]]
        poses[:, r, 0, 3] = 0.3 * r
    poses[..., :3, 3] += rng.uniform(-2, 2, (M, 1, 3))
    X = np.stack([rng.uniform(-8, 8, M), rng.uniform(-4, 4, M),
                  rng.uniform(1, 30, M)], 1)
    kind = rng.randint(0, 10, M)
    X[kind == 0, 2] *= -1.0
    X[kind == 1, 2] += 40.0
    X = X + poses[:, 0, :3, 3]
    f = np.broadcast_to(np.array([400, 400, 320, 240], np.float32),
                        (M, R, 4)).copy()
    p = np.einsum("mrji,mrj->mri", poses[..., :3, :3],
                  X[:, None, :] - poses[..., :3, 3])
    uv = p[..., :2] / p[..., 2:] * f[..., :2] + f[..., 2:]
    uv = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
    mask = rng.rand(M, R) < 0.9
    sig = (1.2 ** rng.randint(0, 4, (M, R))).astype(np.float32)
    return (tuple(torch.from_numpy(np.array(a)).to(dev)
                  for a in (poses, uv, f, mask)),
            torch.from_numpy(sig).to(dev))


def intra_problem(rng, C, N, dev):
    """Descriptors drawn from 8 words (ties in every row and column), a
    tenth of the features invalid, a random gate: desc, valid, gate."""
    import torch

    from mcslam_tpu_torch.ops import hamming

    words = rng.randint(0, 2**32, (8, 8), dtype=np.uint64).astype(np.uint32)
    desc = words[rng.randint(0, 8, (C, N))]
    desc[..., 0] ^= rng.randint(0, 16, (C, N)).astype(np.uint32)
    P = C * (C - 1) // 2
    return (hamming.desc_to_torch(desc, dev),
            torch.from_numpy(rng.rand(C, N) < 0.9).to(dev),
            torch.from_numpy(rng.rand(P, N, N) < 0.4).to(dev))


def same_bits(a, b) -> bool:
    """torch.equal up to NaN payloads: the same NaN positions."""
    import torch

    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


def geometry_kernels(scene, rng, dev, kernels):
    """Phase 2, the frame build's triangulation (tri_refine) and intra
    pair match (intra_pairs): each at the bench frame's inputs (frame 0,
    recorded on the frame build's path: M = MAXI groups of R = C rays
    with the expanded pose table; the C = 4 x N = NPTS descriptors and
    the Sampson gate) and at random problems (tri_refine at a keyframe
    pair's M = 2048, R = 2 and at M = 37, R = 5; intra_pairs at C = 2, 3
    and 5), through the kernel twice and the plain version: equal bit
    for bit (X up to NaN payloads)."""
    import torch

    from mcslam_tpu_torch.frontend import frame, intra_cuda
    from mcslam_tpu_torch.geometry import triangulation, triangulation_cuda

    seen = capture_all(lambda: frame.build_frame(
        scene.imgs[0], scene.rig, **scene.frame_kwargs()),
        {"tri_refine": (triangulation, "triangulate_and_refine"),
         **{n: (intra_cuda, n) for n in ("intra_pairs", *INTRA_GLUE)}})
    check(all(len(v) == 1 for v in seen.values()),
          f"the frame build made {({k: len(v) for k, v in seen.items()})} "
          f"calls, not one of each")
    intra_glue_kernels(seen, rng, dev, kernels)
    seen = {k: v[0] for k, v in seen.items()}
    a, kw = seen["tri_refine"]
    check(a[0].stride(0) == 0 and a[0].shape[1:] == (C, 4, 4),
          f"tri_refine: the frame's pose table is not an expand of C poses "
          f"({tuple(a[0].shape)}, strides {a[0].stride()})")
    frame_tri = (a, kw)
    pair = tri_problem(rng, 2048, 2, dev)
    odd = tri_problem(rng, 37, 5, dev)
    wide = tri_problem(rng, 2048, 8, dev)
    cases = [(f"M={a[3].shape[0]} R={C} (bench frame 0, expanded poses)",
              a, kw),
             ("M=2048 R=2 (keyframe pairs, random)", pair[0],
              dict(sigma=pair[1], min_z=0.1, max_z=100.0)),
             ("M=37 R=5 (random)", odd[0], dict(sigma=odd[1])),
             ("M=2048 R=8 (random)", wide[0], dict(sigma=wide[1]))]
    for name, a, kw in cases:
        k1 = triangulation_cuda.tri_refine(*a, **kw)
        k2 = triangulation_cuda.tri_refine(*a, **kw)
        ref = triangulation.triangulate_and_refine_reference(*a, **kw)
        torch.cuda.synchronize()
        check(same_bits(k1[0], k2[0]) and torch.equal(k1[1], k2[1]),
              f"tri_refine {name}: two runs differ")
        n_x = int((~((k1[0] == ref[0]) | (torch.isnan(k1[0])
                                          & torch.isnan(ref[0])))).sum())
        n_ok = int((k1[1] != ref[1]).sum())
        check(n_x == 0 and n_ok == 0, f"tri_refine {name}: {n_x} coordinates "
              f"and {n_ok} ok flags differ from the plain version")
        print(f"# kernel tri_refine {name}: X and ok bitwise equal to the "
              f"plain version and across two runs ({int(ref[1].sum())} "
              f"points ok)")
    def tri_record(a, kw, distinct_poses):
        M, R = a[3].shape
        return dict(
            fn=lambda a=a, kw=kw: triangulation_cuda.tri_refine(*a, **kw),
            plain=lambda a=a, kw=kw:
                triangulation.triangulate_and_refine_reference(*a, **kw),
            symbols=("tri_refine_kernel",), device_ops=1,
            # the distinct poses and intrinsics, pixels, mask and sigma
            # read once; X and ok written once
            nbytes=distinct_poses * (64 + 16) + M * R * (8 + 1 + 4)
            + M * (12 + 1),
            ops_s=f32_ops_s(M * (R * TRI_OPS[0] + TRI_OPS[1])))

    a, kw = frame_tri
    # the frame's row, and the keyframe pairs' R = 2 and the widest R = 8
    # (per-point poses) timed beside it
    kernels["tri_refine"] = dict(
        route="cuda", source="mcslam_tpu_torch/csrc/tri_refine.cu",
        replaces="mcslam_tpu/geometry/triangulation.py:194", max_abs_err=0.0,
        at={"M=2048 R=2": tri_record(*cases[1][1:], 2 * 2048),
            "M=2048 R=8": tri_record(*cases[3][1:], 8 * 2048)},
        **tri_record(a, kw, C))

    a, kw = seen["intra_pairs"]
    desc, valid, gate = a[:3]
    ik = dict(max_dist=a[3], ratio=a[4]) if len(a) == 5 else kw
    cases = [(f"C={C} N={desc.shape[1]} (bench frame 0)", (desc, valid, gate))]
    cases += [(f"C={c} N={n} (random)", intra_problem(rng, c, n, dev))
              for c, n in ((2, 333), (3, 768), (5, 500))]
    for name, args in cases:
        k1 = intra_cuda.intra_pairs(*args, **ik)
        k2 = intra_cuda.intra_pairs(*args, **ik)
        ref = intra_cuda.intra_pairs_reference(*args, **ik)
        torch.cuda.synchronize()
        check(torch.equal(k1, k2), f"intra_pairs {name}: two runs differ")
        check(torch.equal(k1, ref), f"intra_pairs {name}: "
              f"{int((k1 != ref).sum())} parents differ from the plain "
              f"version")
        n = args[0].shape[1]
        linked = int((ref != torch.arange(ref.numel(), device=dev).reshape(
            ref.shape)).sum())
        print(f"# kernel intra_pairs {name}: parent bitwise equal to the "
              f"plain version and across two runs ({linked} of "
              f"{ref.numel()} features linked to a lower camera's)")
    # the one launch captured in a CUDA graph: two replays equal to the
    # plain version, the arrival counters back at zero after each
    ref = intra_cuda.intra_pairs_reference(desc, valid, gate, **ik)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        intra_cuda.intra_pairs(desc, valid, gate, **ik)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = intra_cuda.intra_pairs(desc, valid, gate, **ik)
    for k in range(2):
        out.fill_(-1)
        graph.replay()
        torch.cuda.synchronize()
        check(torch.equal(out, ref), f"intra_pairs: graph replay {k} differs "
              f"from the plain version")
        check(int(intra_cuda.counters(dev).abs().sum()) == 0,
              f"intra_pairs: counters not zero after graph replay {k}")
    print("# kernel intra_pairs bench frame 0 in a CUDA graph: two replays "
          "bitwise equal to the plain version, the arrival counters back at "
          "zero after each")
    del graph

    N = desc.shape[1]
    P = C * (C - 1) // 2
    cells = P * N * N
    kernels["intra_pairs"] = dict(
        route="cuda", source="mcslam_tpu_torch/csrc/intra_match.cu",
        replaces="mcslam_tpu/frontend/intra.py:110", max_abs_err=0.0,
        fn=lambda: intra_cuda.intra_pairs(desc, valid, gate, **ik),
        plain=lambda: intra_cuda.intra_pairs_reference(desc, valid, gate,
                                                       **ik),
        symbols=("intra_pairs_kernel",), device_ops=1,
        # the gate, descriptors and validity read once; parent written once
        nbytes=cells + C * N * (32 + 1) + C * N * 4,
        ops_s=pm1_ops_s(cells, 0, INTRA_INT_OPS * cells))


def intra_glue_problem(rng, C, N, M, dev) -> dict:
    """Random inputs of the three intra glue kernels: pixels over VGA (the
    rig's pair constants for the gate); a parent table (each feature
    itself or a random feature of a lower camera), validity, responses on
    four levels (ties) and descriptors; ray_idx with holes (rows of 0, 1
    and more rays), group validity and sigma2 = 1.2^octave."""
    import torch

    from mcslam_tpu_torch.data import synthetic
    from mcslam_tpu_torch.frontend import intra

    rig = synthetic.make_synthetic_rig(
        synthetic.SyntheticRigSpec(num_cams=C), device=dev)
    pc = intra.pair_constants(rig)
    xy = np.stack([rng.uniform(0, 640, (C, N)), rng.uniform(0, 480, (C, N))],
                  -1).astype(np.float32)
    parent = np.arange(C * N).reshape(C, N)
    for c in range(1, C):
        linked = rng.rand(N) < 0.6
        parent[c, linked] = rng.randint(0, c * N, int(linked.sum()))
    ray_idx = rng.randint(0, N, (M, C))
    ray_idx[rng.rand(M, C) < 0.5] = -1
    ray_idx[:3] = -1

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    xy_t = t(xy)
    return {
        "intra_gate": (xy_t, rig.fxycxy, pc.E, pc.thr2),
        "intra_groups": (t(parent.astype(np.int32)), t(rng.rand(C, N) < 0.85),
                         t((rng.randint(0, 4, (C, N)) * 0.25).astype(
                             np.float32)),
                         t(rng.randint(-2**31, 2**31 - 1, (C, N, 8)).astype(
                             np.int32)), M),
        "tri_gather": (t(ray_idx.astype(np.int32)), t(rng.rand(M) < 0.8), xy_t,
                       t((1.2 ** rng.randint(0, 8, (C, N))).astype(
                           np.float32)))}


def tri_gather_problem(rng, C, N, M, dev) -> tuple:
    """tri_gather's inputs (ray_idx, valid, xy, sigma2) with the groups'
    rows cycling through five patterns: no ray, every ray, one ray at
    camera (m // 5) mod C, one ray at the last camera, random holes."""
    import torch

    full = rng.randint(0, N, (M, C))
    holes = np.where(rng.rand(M, C) < 0.5, -1, full)
    m = np.arange(M)
    one = np.full((M, C), -1)
    one[m, (m // 5) % C] = full[m, (m // 5) % C]
    last = np.full((M, C), -1)
    last[:, C - 1] = full[:, C - 1]
    k = (m % 5)[:, None]
    ray_idx = np.where(k == 0, -1, np.where(k == 1, full, np.where(
        k == 2, one, np.where(k == 3, last, holes))))
    arrays = (ray_idx.astype(np.int32), rng.rand(M) < 0.8,
              rng.uniform(0, 640, (C, N, 2)).astype(np.float32),
              (1.2 ** rng.randint(0, 8, (C, N))).astype(np.float32))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in arrays)


# tri_gather's lane-per-ray design at the groups (C, M) that phase 2 also
# holds it to: counts no multiple of a block's or a warp's groups, C that
# does not divide 32 and C above 32
TRI_EDGES = tuple((C, M) for M in (1, 31, 33, 2049) for C in (1, 2, 3, 4)) \
    + ((5, 100), (33, 40))


def intra_glue_bytes_ops(name, args) -> tuple:
    """(bytes each input read once and each output written once, float32
    operations) of one call of an intra glue kernel."""
    if name == "intra_gate":
        C, N = args[0].shape[:2]
        P = C * (C - 1) // 2
        return (C * N * 8 + C * 16 + P * 36 + 4 + P * N * N,
                GATE_OPS * P * N * N)
    if name == "intra_groups":
        C, N = args[1].shape
        K, M = C * N, args[4]
        # parent, valid, response, desc; ray_idx, desc, valid. The
        # function's work, whatever ranks the keys: 8 hops, the ray table
        # and the key a feature (~16 operations), and the K log2 K compares
        # that a comparison sort of the keys needs
        return (K * (4 + 1 + 4 + 32) + M * (4 * C + 32 + 1),
                16 * K + K * max(K - 1, 1).bit_length())
    M, C = args[0].shape
    N = args[2].shape[1]
    # ray_idx, valid, pixels and sigma2; uv, sigma, mask, anchor, uv_ref,
    # anchor sigma2, n_rays, multi & valid; a root per ray
    return (M * C * 4 + M + C * N * 12 + M * C * 13 + M * 21, M * C)


def intra_glue_kernels(seen, rng, dev, kernels):
    """Phase 2, the intra match's glue kernels (frontend/intra_cuda:
    intra_gate, intra_groups, tri_gather) at the bench frame's recorded
    calls (C = 4, N = NPTS, M = MAXI) and at random odd shapes, each twice
    and against its plain version on the card, bitwise equal; then the
    three bench calls captured in one CUDA graph and replayed twice, equal
    to the plain versions."""
    import torch

    from mcslam_tpu_torch.frontend import intra_cuda

    def outputs(x):
        return list(x) if isinstance(x, tuple) else [x]

    bench = {n: seen[n][0] for n in INTRA_GLUE}
    odd = [intra_glue_problem(rng, c, n, m, dev)
           for c, n, m in ((2, 333, 500), (3, 129, 2048), (5, 1000, 2048))]
    for n in INTRA_GLUE:
        fn = getattr(intra_cuda, n)
        plain = getattr(intra_cuda, f"{n}_reference")
        cases = [("bench frame 0", bench[n])] + [
            (f"random C={p['intra_gate'][0].shape[0]} "
             f"N={p['intra_gate'][0].shape[1]}", (p[n], {})) for p in odd]
        for what, (a, kw) in cases:
            k1 = outputs(fn(*a, **kw))
            k2 = outputs(fn(*a, **kw))
            pl = outputs(plain(*a, **kw))
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(k1, k2)),
                  f"{n} ({what}): two runs differ")
            differ = [i for i, (x, y) in enumerate(zip(k1, pl))
                      if x.dtype != y.dtype or not torch.equal(x, y)]
            check(len(k1) == len(pl) and not differ,
                  f"{n} ({what}): outputs {differ} differ from the plain "
                  f"version's")
            shapes = ", ".join(f"{tuple(x.shape)}" for x in k1)
            print(f"# kernel {n} ({what}): {len(k1)} outputs ({shapes}) "
                  f"bitwise equal to the plain version's and across two runs")
        if n == "tri_gather":
            for C, M in TRI_EDGES:
                a = tri_gather_problem(np.random.RandomState(C * 10000 + M),
                                       C, 97, M, dev)
                k1, k2, pl = fn(*a), fn(*a), plain(*a)
                torch.cuda.synchronize()
                check(all(torch.equal(x, y) for x, y in zip(k1, k2))
                      and all(x.dtype == y.dtype and torch.equal(x, y)
                              for x, y in zip(k1, pl)),
                      f"tri_gather (C={C} M={M}): differs from the plain "
                      f"version or across two runs")
            print(f"# kernel tri_gather at {len(TRI_EDGES)} edge shapes (C, "
                  f"M: {TRI_EDGES}; N = 97, groups of no, one and every "
                  f"ray): bitwise equal to the plain version's and across "
                  f"two runs")
        a, kw = bench[n]
        nbytes, ops = intra_glue_bytes_ops(n, a)
        kernels[n] = dict(
            route="cuda", source="mcslam_tpu_torch/csrc/intra_glue.cu",
            replaces={"intra_gate": "mcslam_tpu/frontend/intra.py:47",
                      "intra_groups": "mcslam_tpu/frontend/intra.py:150",
                      "tri_gather": "mcslam_tpu/frontend/frame.py:91"}[n],
            max_abs_err=0.0,
            fn=lambda fn=fn, a=a, kw=kw: fn(*a, **kw),
            plain=lambda p=plain, a=a, kw=kw: p(*a, **kw),
            symbols=(f"{n}_kernel",), device_ops=1, nbytes=nbytes,
            ops_s=f32_ops_s(ops))
    # the three bench calls in one CUDA graph: two replays
    ref = [o for n in INTRA_GLUE for o in outputs(
        getattr(intra_cuda, f"{n}_reference")(*bench[n][0], **bench[n][1]))]

    def step():
        return [o for n in INTRA_GLUE for o in outputs(
            getattr(intra_cuda, n)(*bench[n][0], **bench[n][1]))]

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    for k in range(2):
        for o in out:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(out, ref)),
              f"intra glue kernels: graph replay {k} differs from the plain "
              f"versions")
    print(f"# kernels {', '.join(INTRA_GLUE)} bench frame 0 in one CUDA "
          f"graph: two replays bitwise equal to the plain versions")
    del graph


def capture_all(build, targets) -> dict:
    """{name: [(args, kwargs), ...]} of every call of each module function
    of `targets` ({name: (module, attribute)}) that build() makes; the
    calls go through unchanged."""
    seen = {n: [] for n in targets}
    saved = {n: getattr(m, a) for n, (m, a) in targets.items()}

    def record(name, fn):
        def wrapped(*a, **kw):
            seen[name].append((a, kw))
            return fn(*a, **kw)
        return wrapped

    for n, (m, a) in targets.items():
        setattr(m, a, record(n, saved[n]))
    try:
        build()
    finally:
        for n, (m, a) in targets.items():
            setattr(m, a, saved[n])
    return seen


def portfolio_calls(scene, dev) -> dict:
    """{"score": 4, "kabsch_hyp": 1, "pnp_hyp": 1 [(args, kwargs)]} of the
    RANSAC kernels' wrapper calls (frontend/ransac_cuda) that bench frame
    1's step, its portfolio forced (fastpath_frac 2.0), makes against
    frame 0's map: the score at K = 1 (the motion candidate), 512
    (Kabsch), 256 (PnP) and 3 (the re-score)."""
    import torch

    from mcslam_tpu_torch import tracking_kernels as tk
    from mcslam_tpu_torch.frontend import frame, ransac_cuda

    ff0 = frame.build_frame(scene.imgs[0], scene.rig, **scene.frame_kwargs())
    mapstate, _ = seed_map(ff0, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    targets = {n: (ransac_cuda, n) for n in ("score", "kabsch_hyp", "pnp_hyp")}
    seen = capture_all(lambda: tk._build_and_track_step(
        gen, scene.imgs[1], scene.rig, ff0.im_desc, ff0.im_valid, *mapstate,
        torch.eye(4, device=dev), **scene.step_kwargs(2.0)), targets)
    check([len(seen[n]) for n in targets] == [4, 1, 1],
          f"the forced-portfolio step made {[len(v) for v in seen.values()]} "
          f"score / kabsch_hyp / pnp_hyp calls, not 4 / 1 / 1")
    return seen


def ransac_kernels(scene, dev, kernels):
    """Phase 2, the RANSAC portfolio's kernels (frontend/ransac_cuda) at
    the inputs that bench frame 1's step, its portfolio forced
    (fastpath_frac 2.0), gives them against frame 0's map: the score at K
    = 1 (the motion candidate), 512 (Kabsch), 256 (PnP) and 3 (the
    re-score), kabsch_hyp at K = 512 and pnp_hyp at K = 256 (the
    generalized form on the second half: the bench rig has lever arms);
    each kernel twice (bitwise equal) and its plain version, under the
    criteria of check_score / check_hypotheses."""
    import torch

    from mcslam_tpu_torch.frontend import ransac, ransac_cuda

    seen = portfolio_calls(scene, dev)
    recs, errs = {}, []
    for args, kw in seen["score"]:
        hyp, X, uv, cam, f, mask, px = args
        K, M = hyp.shape[0], X.shape[0]
        k1 = ransac_cuda.score(*args, **kw)
        k2 = ransac_cuda.score(*args, **kw)
        counts, flags = ransac._score_reprojection(*args, **kw)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(k1, k2)),
              f"ransac_score K={K}: two runs differ")
        check(torch.equal(k1[2], hyp[int(k1[1])]),
              f"ransac_score K={K}: the pose is not the winner's")
        st = check_score(f"ransac_score K={K}", k1, counts, flags,
                         score_edges(hyp, X, uv, cam, f, px))
        errs.append(st["counts_differ"])
        print(f"# kernel ransac_score K={K} M={M}: {st['counts_differ']} "
              f"counts and {st['flags_differ']} of the winner's flags differ "
              f"from the plain version ({st['edge_flags']} flags within "
              f"{RANSAC_EDGE} px^2 of the gate), winner {st['winner']} (plain "
              f"{st['plain_winner']}, {int(counts.max())} inliers); bitwise "
              f"equal across two runs")
        recs[K] = dict(
            fn=lambda a=args: ransac_cuda.score(*a),
            plain=lambda a=args: ransac_cuda.score_reference(*a),
            symbols=("ransac_score_kernel",), device_ops=1,
            # hypotheses and correspondences read once, counts and the
            # winner's pose, index, count and mask written once
            nbytes=K * 64 + M * (12 + 8 + 64 + 16 + 1) + K * 8 + 8 + 64 + 4
            + M, ops_s=f32_ops_s(K * M * SCORE_OPS))
        if K in (512, 256):
            recs[K]["obs"] = (X, uv, cam, f, mask, px)
    kernels["ransac_score"] = dict(
        route="cuda", source="mcslam_tpu_torch/csrc/ransac_score.cu",
        replaces="mcslam_tpu/frontend/ransac.py:150",
        max_abs_err=float(max(errs)),
        at={f"K={K}": {k: v for k, v in recs[K].items() if k != "obs"}
            for K in (1, 256, 3)},
        **{k: v for k, v in recs[512].items() if k != "obs"})

    for name, (args, kw), K, obs in (
            ("kabsch_hyp", seen["kabsch_hyp"][0], 512, recs[512]["obs"]),
            ("pnp_hyp", seen["pnp_hyp"][0], 256, recs[256]["obs"])):
        fn = getattr(ransac_cuda, name)
        plain = (ransac.kabsch_hypotheses if name == "kabsch_hyp"
                 else ransac.pnp_hypotheses)
        idx = args[0]
        hk, hk2 = fn(*args), fn(*args)
        hp = plain(*args)
        h64 = plain(idx, *(a.double() for a in args[1:]))
        torch.cuda.synchronize()
        check(same_bits(hk, hk2), f"{name}: two runs differ")
        ck = ransac._score_reprojection(hk, *obs)[0]
        cp = ransac._score_reprojection(hp, *obs)[0]
        st = check_hypotheses(name, hk, hp, h64, ck, cp)
        print(f"# kernel {name} K={K} S={idx.shape[1]}: {st['good']} "
              f"hypotheses score {RANSAC_GOOD} of the best, {st['rounding']} "
              f"of them with a float32 solve {RANSAC_POSE} from the float64 "
              f"one; the rest within {st['max_abs_err']:.3g} of the plain "
              f"version's; best count {st['best']} (plain "
              f"{st['plain_best']}); {st['nan']} NaN, {st['one_sided']} on one "
              f"side only; bitwise equal across two runs")
        M = args[1].shape[0]
        S = idx.shape[1]
        if name == "kabsch_hyp":
            nbytes = K * 3 * (8 + 2 * 12) + K * 64
            ops_s = f32_ops_s(kabsch_ops(*args))
        else:
            lever = bool((args[3][:, :3, 3].norm(dim=-1) > 1e-6).any())
            # samples' indices and rows, the translations' lever scan, the
            # start vectors, the poses
            nbytes = K * S * (8 + 12 + 8 + 64 + 16) + M * 12 + 26 * 4 + K * 64
            ops_s = f32_ops_s(pnp_ops(K, S, lever))
        kernels[name] = dict(
            route="cuda", source=f"mcslam_tpu_torch/csrc/{name}.cu",
            replaces=("mcslam_tpu/frontend/ransac.py:176" if name ==
                      "kabsch_hyp" else "mcslam_tpu/frontend/ransac.py:293"),
            max_abs_err=st["max_abs_err"],
            fn=lambda a=args, fn=fn: fn(*a),
            plain=lambda a=args, p=plain: p(*a),
            symbols=(f"{name}_kernel",), device_ops=1, nbytes=nbytes,
            ops_s=ops_s)


def track_problem(rng, C, M, N, L, cap, dev, case="random") -> dict:
    """Inputs of the tracking glue's kernels on dev: a rig of C cameras, a
    predicted pose, a map mirror of cap rows (some invalid, some without a
    normal, the first six at, behind or just in front of the cameras'
    plane: z <= 0.05), M current features, N previous ones (some without
    a landmark), L candidates, and the matcher's row / column outputs
    (some rows gated out: best = 2^20). case "identity": identity poses
    and map rows 6-11 projecting exactly onto the frustum's edges (u = 0,
    u = W, v = 0, v = H at VGA) and into a cone exactly at 0.5 and one
    inside it; "no_valid": no valid current feature and no previous one
    with a landmark; "all_ok" (N >= M): every current feature valid and
    mutually matched within the distance and the ratio to a previous one
    with a landmark, every map row valid (the epilogue counts M and M);
    "none_with": as "all_ok" but no previous feature with a landmark (M
    and 0); "no_lm": as "random" but no previous feature with a landmark
    (every prev_lm_id -1); "behind": as "random" but every map row at,
    behind or just in front of camera 0's plane (its depth uniform in [-3,
    0.05], the first nine rows at 0.05 and just above it, 1e-6 and just
    below it, 0, -0, -1e-7, 1e-7 and 0.04), so that the depth clamp at
    1e-6 and the penalty at 0.05 decide most columns."""
    import torch

    def pose(rot, trans):
        w = rng.normal(0, rot, 3) + 1e-9
        th = np.linalg.norm(w)
        k = w / th
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        T = np.eye(4)
        T[:3, :3] = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
        T[:3, 3] = rng.normal(0, trans, 3)
        return T

    f32, i32 = np.float32, np.int32
    if case == "identity":
        cam, pred = np.tile(np.eye(4), (C, 1, 1)), np.eye(4)
        f = np.tile([256.0, 256.0, 320.0, 240.0], (C, 1))
    else:
        cam = np.stack([pose(0.4, 0.1) for _ in range(C)])
        pred = pose(0.05, 0.2)
        f = np.float32([400, 410, 320, 240]) + rng.normal(0, 5, (C, 4))
    map_pos = rng.uniform(-8, 8, (cap, 3)) + [0, 0, 6]
    map_pos[:6] = [[0, 0, 0.01], [0, 0, -3], [1, 1, 0.05], [0, 0, 1e-7],
                   [3, 0, 0.0], [0.5, -0.5, 0.03]]
    if case == "behind":
        z = rng.uniform(-3, 0.05, cap)
        z[:9] = [0.05, np.nextafter(np.float32(0.05), np.float32(1)), 1e-6,
                 np.nextafter(np.float32(1e-6), np.float32(0)), 0.0, -0.0,
                 -1e-7, 1e-7, 0.04][:min(cap, 9)]
        p_c0 = np.stack([rng.uniform(-2, 2, cap), rng.uniform(-2, 2, cap), z,
                         np.ones(cap)], 1)
        # camera 0's frame -> the world: (cam[0] se3_inverse(pred))^-1
        map_pos = (np.linalg.inv(cam[0] @ np.linalg.inv(pred))
                   @ p_c0.T).T[:, :3]
    nrm = rng.normal(0, 1, (cap, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm[rng.rand(cap) < 0.2] = 0
    if case == "identity":  # x / z = -+1.25, y / z = -+0.9375 at z = 2
        map_pos[6:12] = [[-2.5, 0, 2], [2.5, 0, 2], [0, -1.875, 2],
                         [0, 1.875, 2], [0, 0, 2], [0, 0, 2]]
        nrm[6:12] = [[0, 0, 1]] * 4 + [[0, 0.75, 0.5], [0, 0.5, 0.75]]
    cur_valid = rng.rand(M) > 0.1
    prev_lm = rng.randint(0, cap, N)
    prev_lm[rng.rand(N) < 0.3] = -1
    prev_lm[:min(N, 12)] = np.arange(min(N, 12))
    cand = rng.randint(0, cap, L)
    cand[:min(L, 12)] = np.arange(min(L, 12))
    if case == "no_valid":
        cur_valid[:] = False
        prev_lm[:] = -1
    if case == "no_lm":
        prev_lm[:] = -1
    best = rng.randint(0, 100, M).astype(f32)
    best[rng.rand(M) < 0.1] = float(1 << 20)
    idx = rng.randint(0, N, M)
    col = rng.randint(0, max(M, 1), N)
    col[idx[:M // 2]] = np.arange(M // 2)
    P = dict(uv=rng.uniform(-10, 650, (M, 2)).astype(f32),
             anchor=rng.randint(0, C, M).astype(i32), cur_valid=cur_valid,
             prev_lm=prev_lm.astype(i32), prev_valid=rng.rand(N) > 0.1,
             map_pos=map_pos.astype(f32), map_valid=rng.rand(cap) > 0.2,
             map_desc=rng.randint(-2**31, 2**31 - 1, (cap, 8)).astype(i32),
             nrm=nrm.astype(f32), cam=cam.astype(f32), f=f.astype(f32),
             pred=pred.astype(f32), cand=cand.astype(i32),
             cand_valid=rng.rand(L) > 0.15,
             sigma2=rng.uniform(0.5, 3, M).astype(f32),
             has_depth=rng.rand(M) > 0.3, best=best,
             second=best + rng.randint(0, 40, M).astype(f32),
             idx=idx.astype(i32), col=col.astype(i32),
             lidx=rng.randint(0, max(L, 1), M).astype(i32))
    if case in ("all_ok", "none_with"):
        P["cur_valid"][:] = True
        P["map_valid"][:] = True
        P["idx"] = rng.permutation(N)[:M].astype(i32)
        P["col"][P["idx"]] = np.arange(M, dtype=i32)
        P["best"] = rng.randint(0, STEP["max_dist"] + 1, M).astype(f32)
        P["second"] = P["best"] + f32(200)
        P["prev_lm"] = (rng.randint(0, cap, N) if case == "all_ok"
                        else np.full(N, -1)).astype(i32)
    return {k: torch.from_numpy(v).to(dev) for k, v in P.items()}


def track_calls(P, image_wh=(W, H)) -> dict:
    """{kernel: (args, kwargs)} of the four tracking glue wrappers on a
    track_problem's inputs (the local-map epilogue on rows made by the
    plain inter-frame epilogue and on the candidates' positions as the
    gate writes them)."""
    import torch

    from mcslam_tpu_torch.frontend import track_cuda

    M = P["uv"].shape[0]
    packed = torch.empty(track_cuda.HEAD + 3 * M, device=P["uv"].device)
    obs = track_cuda.track_epilogue_reference(
        P["best"], P["second"], P["idx"], P["col"], P["cur_valid"],
        P["has_depth"], P["uv"], P["anchor"], P["sigma2"], P["prev_lm"],
        P["map_valid"], P["map_pos"], P["cam"], P["f"], STEP["max_dist"],
        STEP["ratio"], packed)
    return {
        "track_gate": ((P["uv"], P["anchor"], P["cur_valid"], P["prev_lm"],
                        P["prev_valid"], P["map_pos"], P["map_valid"],
                        P["cam"], P["f"], P["pred"]), {}),
        "track_epilogue": ((P["best"], P["second"], P["idx"], P["col"],
                            P["cur_valid"], P["has_depth"], P["uv"],
                            P["anchor"], P["sigma2"], P["prev_lm"],
                            P["map_valid"], P["map_pos"], P["cam"], P["f"],
                            STEP["max_dist"], STEP["ratio"], packed), {}),
        "localmap_gate": ((P["pred"], P["cand"], P["cand_valid"],
                           P["map_pos"], P["map_desc"], P["nrm"], P["uv"],
                           P["anchor"], P["cur_valid"], P["cam"], P["f"],
                           image_wh), {}),
        "localmap_epilogue": ((P["best"], P["second"], P["lidx"],
                               P["cur_valid"], P["cand"],
                               track_cuda.candidate_positions(
                                   P["cand"], P["map_pos"]),
                               P["map_pos"], obs.rows, STEP["lm_max_dist"]),
                              {})}


def track_outputs(name, fn, args, kw):
    """fn(*args, **kw)'s outputs as a list; track_epilogue into a fresh
    packed vector, of which the slots it writes are outputs too."""
    import torch

    if name != "track_epilogue":
        return list(fn(*args, **kw))
    M = args[0].shape[0]
    packed = torch.empty(args[-1].shape[0], dtype=torch.float32,
                         device=args[0].device)
    out = list(fn(*args[:-1], packed, **kw))
    return out + [packed[17:19], packed[21:21 + 3 * M]]


def track_bytes_ops(name, args) -> tuple:
    """(bytes each input read once and each output written once,
    float32 operations) of one call of a tracking glue kernel."""
    if name in ("track_gate", "localmap_gate"):
        uv, cam = args[6 if name == "localmap_gate" else 0], args[
            9 if name == "localmap_gate" else 7]
        C, M = cam.shape[0], uv.shape[0]
        cols = args[3 if name == "track_gate" else 1].shape[0]
        DG = 3 * C + 2
        # rows: uv, anchor, valid; columns: id, valid, the map row (track:
        # position, validity; local: position, descriptor, normal); the
        # rig; ahat, bhat (and the candidates' descriptors and positions)
        per_col = 4 + 1 + (13 if name == "track_gate" else 56 + 32 + 12)
        nbytes = M * 13 + cols * per_col + C * 80 + 64 + 4 * DG * (M + cols)
        # a column's camera transform (15) or two (30) and per camera the
        # projection, clamps and P2 (~12); the cone (~25); a row's 3 C + 4
        ops = cols * (C * (15 + 12) + (40 if name == "localmap_gate" else 0))
        return nbytes, ops + M * (3 * C + 4)
    M = args[0].shape[0]
    if name == "track_epilogue":
        # best, second, idx, col_idx, prev_lm_id and map rows gathered,
        # valid, depth, uv, anchor, sigma2; X, cTr, f, the rows, four
        # masks, the packed slots
        nbytes = M * (4 * 5 + 2 + 8 + 4 + 4 + 13) + M * (12 + 64 + 16 + 88
                                                          + 2 + 8 + 12) + 8
        return nbytes, M * 10
    # best, second, idx, valid, cand_ids and the gate's positions
    # gathered, the inter-frame rows 3-21; the rows, mask, lm
    return M * (13 + 4 + 12 + 76) + M * (88 + 4 + 4), M * 5


# the tracking glue's redesigned kernels (track_gate's and localmap_gate's
# four lanes a column, 32 columns a block; track_epilogue's and
# localmap_epilogue's 32-row blocks), which phase 2 holds also at these
# problems (C, M, N, L, track_problem's case): shapes no multiple of their
# blocks, C = 1-4, the counts' extremes, no previous feature with a
# landmark, map rows behind the cameras
TRACK_REDESIGNED = TRACK_KERNELS
TRACK_EDGES = ((1, 31, 7, 63, "random"), (2, 33, 40, 65, "random"),
               (4, 161, 200, 191, "all_ok"), (4, 2048, 2048, 4096, "none_with"),
               (4, 2048, 2048, 4096, "no_lm"), (3, 97, 130, 50, "behind"))


def track_kernels(scene, dev, kernels):
    """Phase 2, the tracking glue's kernels (frontend/track_cuda) at the
    calls that bench frame 1's eager fast-path step makes against frame
    0's map (C = 4, M = N = 2048, L = 4096) and at a random problem of odd
    shape (C = 3, M = 2049, N = 2047, L = 4097): each kernel twice and its
    plain version on the card, all bitwise equal; all four (each
    redesigned) also at TRACK_EDGES and, at bench frame 1's calls, through
    three replays of one CUDA graph."""
    import torch

    from mcslam_tpu_torch import tracking_kernels as tk
    from mcslam_tpu_torch.frontend import frame, track_cuda

    ff0 = frame.build_frame(scene.imgs[0], scene.rig, **scene.frame_kwargs())
    mapstate, _ = seed_map(ff0, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    seen = capture_all(lambda: tk._build_and_track_step(
        gen, scene.imgs[1], scene.rig, ff0.im_desc, ff0.im_valid, *mapstate,
        torch.eye(4, device=dev), **scene.step_kwargs(FASTPATH_FRAC)),
        {n: (track_cuda, n) for n in TRACK_KERNELS})
    check([len(seen[n]) for n in TRACK_KERNELS] == [1] * 4,
          f"bench frame 1's step made {[len(seen[n]) for n in TRACK_KERNELS]}"
          f" calls of {TRACK_KERNELS}, not one each")
    odd = track_calls(track_problem(np.random.RandomState(21), 3, 2049, 2047,
                                    4097, MAP_CAP, dev))
    for n in TRACK_KERNELS:
        fn = getattr(track_cuda, n)
        plain = getattr(track_cuda, f"{n}_reference")
        for what, (a, kw) in (("bench frame 1", seen[n][0]),
                              ("odd shape", odd[n])):
            k1 = track_outputs(n, fn, a, kw)
            k2 = track_outputs(n, fn, a, kw)
            pl = track_outputs(n, plain, a, kw)
            torch.cuda.synchronize()
            check(all(same_bits(x, y) for x, y in zip(k1, k2)),
                  f"{n} ({what}): two runs differ")
            differ = [i for i, (x, y) in enumerate(zip(k1, pl))
                      if x.dtype != y.dtype or x.shape != y.shape
                      or not same_bits(x, y)]
            check(not differ, f"{n} ({what}): outputs {differ} differ from "
                  f"the plain version's")
            shapes = ", ".join(f"{tuple(x.shape)}" for x in k1)
            print(f"# kernel {n} ({what}): {len(k1)} outputs ({shapes}) "
                  f"bitwise equal to the plain version's and across two "
                  f"runs")
        if n in TRACK_REDESIGNED:
            for C, M, N, L, case in TRACK_EDGES:
                a, kw = track_calls(track_problem(
                    np.random.RandomState(M), C, M, N, L, MAP_CAP, dev,
                    case))[n]
                k1 = track_outputs(n, fn, a, kw)
                k2 = track_outputs(n, fn, a, kw)
                pl = track_outputs(n, plain, a, kw)
                torch.cuda.synchronize()
                check(all(same_bits(x, y) for x, y in zip(k1, k2))
                      and all(x.shape == y.shape and same_bits(x, y)
                              for x, y in zip(k1, pl)),
                      f"{n} (C={C} M={M} N={N} L={L} {case}): differs from "
                      f"the plain version or across two runs")
            print(f"# kernel {n} at {len(TRACK_EDGES)} edge problems (C, "
                  f"M, N, L, case: {TRACK_EDGES}): bitwise equal to the "
                  f"plain version's and across two runs")
        a, kw = seen[n][0]
        nbytes, ops = track_bytes_ops(n, a)
        kernels[n] = dict(
            route="cuda", source="mcslam_tpu_torch/csrc/track_glue.cu",
            replaces={"track_gate": "mcslam_tpu/tracking_kernels.py:162",
                      "track_epilogue": "mcslam_tpu/tracking_kernels.py:196",
                      "localmap_gate": "mcslam_tpu/tracking_kernels.py:479",
                      "localmap_epilogue":
                          "mcslam_tpu/tracking_kernels.py:349"}[n],
            max_abs_err=0.0,
            fn=lambda n=n, fn=fn, a=a, kw=kw: track_outputs(n, fn, a, kw),
            plain=lambda n=n, p=plain, a=a, kw=kw: track_outputs(n, p, a, kw),
            symbols=(f"{n}_kernel",), device_ops=1, nbytes=nbytes,
            ops_s=f32_ops_s(ops))
    # the redesigned four at bench frame 1's calls in one CUDA graph: three
    # replays bitwise equal to the plain versions, the epilogue's counter
    # back at zero after each
    from mcslam_tpu_torch.utils import graphs

    ref = [o for n in TRACK_REDESIGNED for o in track_outputs(
        n, getattr(track_cuda, f"{n}_reference"), *seen[n][0])]

    def step():
        return [o for n in TRACK_REDESIGNED for o in track_outputs(
            n, getattr(track_cuda, n), *seen[n][0])]

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    for k in range(3):
        for o in out:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        check(all(same_bits(x, y) for x, y in zip(out, ref)),
              f"{TRACK_REDESIGNED}: graph replay {k} differs from the plain "
              f"versions")
        check(int(graphs.counters("track_epilogue", 2, dev).abs().sum())
              == 0, f"track_epilogue: counter not zero after replay {k}")
    print(f"# kernels {', '.join(TRACK_REDESIGNED)} bench frame 1 in one "
          f"CUDA graph: three replays bitwise equal to the plain versions, "
          f"the counter back at zero after each")
    del graph


def vio_factors_problem(dev, case):
    """phase 2's VIO factor problem `case` (VIO_FACTOR_CASES: K, GPS
    factors, IMU slots, between) on dev: synthetic.random_vio_problem's
    window (K - 1 IMU factors; GPS factors on keyframes 0, 1, ..., every
    third invalid); IMU slots past K - 1 are copies of the first factor
    made invalid; the between table is (0, 5) a random constraint, (2, 3)
    the poses' own (so3_log's small branch), (4, 4) a keyframe to itself
    (the columns added) and (1, 3) invalid."""
    import torch

    from mcslam_tpu_torch.backend import ba_vio
    from mcslam_tpu_torch.data import synthetic
    from mcslam_tpu_torch.geometry import lie

    K, num_gps, slots, between = VIO_FACTOR_CASES[case]
    rig = synthetic.make_synthetic_rig(
        synthetic.SyntheticRigSpec(num_cams=C, image_size=(W, H)),
        device=dev)
    f = synthetic.random_vio_problem(rig, num_kfs=K, num_gps=num_gps)
    p = ba_vio.problem_from_numpy(**dict(f, device=dev))
    if slots is not None:
        imu, pad = p.imu, slots - (K - 1)
        fields = {n: torch.cat([v, v[:1].expand(pad, *v.shape[1:])])
                  for n, v in imu._asdict().items()}
        fields["valid"] = torch.cat([imu.valid, torch.zeros_like(
            imu.valid[:1]).expand(pad)])
        p = p._replace(imu=type(imu)(**fields))
    if not between:
        return p
    T = p.poses.double().cpu()
    rng = np.random.RandomState(3)
    pairs = ((0, 5), (2, 3), (4, 4), (1, 3))
    rel = torch.stack([torch.linalg.inv(T[i]) @ T[j] for i, j in pairs])
    noise = lie.se3_exp(torch.from_numpy(rng.randn(4, 6) * 0.02))
    rel[[0, 2, 3]] = rel[[0, 2, 3]] @ noise[[0, 2, 3]]
    return p._replace(between=ba_vio.factor_table(
        ba_vio.BetweenFactors, dev, i=np.array([i for i, _ in pairs]),
        j=np.array([j for _, j in pairs]), rel=rel.float().numpy(),
        sigma_rot=np.full(4, 0.01), sigma_trans=np.full(4, 0.05),
        valid=np.array([True, True, True, False])))


def f32_ulps(a, b):
    """|a - b| in float32 units in the last place (the distance between
    their ordered bit patterns), elementwise, as int64."""
    import torch

    def ordered(x):
        i = x.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return (ordered(a) - ordered(b)).abs()


def vio_products(J, r, w, sel, per_factor=False):
    """float64 w J^T J, w J^T r and w |r|^2 of a table's factors (J (F, R,
    n), r (F, R), w (F,)) with J's columns mapped by sel (F, n, M): summed
    over the factors (sel placing each at the system's columns, M = N) or
    per factor (M = n)."""
    import torch

    J = J.double() @ sel.double()
    r, w, f = r.double(), w.double(), "f" if per_factor else ""
    return (torch.einsum(f"f,fri,frj->{f}ij", w, J, J),
            torch.einsum(f"f,fri,fr->{f}i", w, J, r),
            torch.einsum(f"f,fr,fr->{f}", w, r, r))


def vio_sum_bounds(pairs, per_factor=False, base=None):
    """The bound on |kernel - plain| of each entry of the sums w J^T J,
    w J^T r and w |r|^2 that the two make of the same factors, pairs =
    [((J, r) kernel, (J, r) plain, w, sel)] (vio_products), plus base =
    [terms of H, of g, of the cost] added as they are (the vision block's
    and the prior's entries). Each side adds the entry's m nonzero terms
    in its own order, each term rounded at most VIO_TERM_ROUNDINGS times
    besides, so each lies within (m - 1 + VIO_TERM_ROUNDINGS) eps / 2 S
    of the exact sum of its own J and r, S the sum of the terms'
    magnitudes: the two differ by at most (m + VIO_TERM_ROUNDINGS) eps S
    plus the exact difference that their J and r make (float32 eps)."""
    import torch

    # [kernel, plain, magnitude, count] x [w J^T J, w J^T r, w |r|^2]
    acc = [[0.0] * 3 for _ in range(4)]
    for (Jk, rk), (Jp, rp), w, sel in pairs:
        Ja = torch.maximum(Jk.abs(), Jp.abs())
        ra = torch.maximum(rk.abs(), rp.abs())
        for j, part in enumerate((
                vio_products(Jk, rk, w, sel, per_factor),
                vio_products(Jp, rp, w, sel, per_factor),
                vio_products(Ja, ra, w.abs(), sel, per_factor),
                vio_products(Ja != 0, ra != 0, w != 0, sel != 0,
                             per_factor))):
            acc[j] = [x + y for x, y in zip(acc[j], part)]
    for i, terms in enumerate(base or ()):
        for t in terms:
            acc[2][i] = acc[2][i] + t.double().abs()
            acc[3][i] = acc[3][i] + (t != 0).double()
    eps = torch.finfo(torch.float32).eps
    return [(m + VIO_TERM_ROUNDINGS) * eps * S + (k - q).abs()
            for k, q, S, m in zip(*acc)]


def vio_within(lab, got, want, bound) -> float:
    """Checks got (the kernel's) against want (the plain version's): the
    same shape, finite, every entry within its bound -> the largest
    share of its bound an entry takes."""
    import torch

    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"vio_factors {lab}: shape {tuple(got.shape)} or non-finite")
    err = (got.double() - want.double()).abs()
    bad = err > bound
    if bool(bad.any()):
        i = int(torch.where(bad, err, -1.0).argmax())
        check(False, f"vio_factors {lab}: {int(bad.sum())} entries beyond "
              f"their bound; entry {i}: {float(err.flatten()[i]):.3g} "
              f"against {float(bound.flatten()[i]):.3g}")
    share = torch.where(bound > 0, err / bound.clamp(min=1e-300), 0.0)
    return float(share.max())


def own_columns(sel):
    """(F, n, n) 0/1: the record's columns of each factor, its tangent
    columns as they are, or where both halves reach the same state
    columns (a keyframe joined to itself) column c + n/2 added to column
    c and columns n/2.. zero (as the kernel forms its products)."""
    import torch

    F, n, _ = sel.shape
    h = n // 2
    own = (sel[:, :h] == sel[:, h:]).flatten(1).all(1)
    M = torch.eye(n, device=sel.device).repeat(F, 1, 1)
    M[own, h:, :h] = torch.eye(h, device=sel.device)
    M[own, h:, h:] = 0.0
    return M


def check_vio_factors(p, repeats=2, graph_replays=0) -> dict:
    """vio_factors (one prepared VioFactors, `repeats` launches) on the
    problem's vision block (ba_linearize's kf-blocked system) against
    vio_factors_reference on the same inputs: the launches bit-equal,
    records included; every J and r entry equal or 1 ulp apart or within
    VIO_J_FLOOR of its table's largest |J|; every entry of each factor's
    record ((w J)^T J, (w J)^T r, w |r|^2) against the plain version's
    float32 products of its J and r, and every entry of H, g and the cost
    against the plain version's, within vio_sum_bounds' bound of that
    entry's own terms; and `graph_replays` replays of a CUDA graph of the
    call bit-equal to the launches -> a report (errors, shares of the
    bounds, counts, the launches' outputs `out` (H, g, cost, records),
    and fn / plain / nbytes / ops_s for phase 8)."""
    import torch

    from mcslam_tpu_torch import _build
    from mcslam_tpu_torch.backend import ba, ba_vio, vio_cuda

    dev = p.poses.device
    K = p.poses.shape[0]
    sys_ = ba._blocked_system(ba_vio._vision_problem(p), 2.5)
    (Hpp, gp, *_), vcost, _ = sys_((p.poses, p.landmarks), p.obs.valid)
    state = (p.poses, p.vels, p.biases, p.E_T_V)
    args = (*state, Hpp, gp, vcost)
    prep = vio_cuda.VioFactors(p)
    before = _build.LAUNCHES.get("vio_factors", 0)
    outs = []
    for _ in range(repeats):
        out = prep(*args)
        outs.append((*out, vio_cuda.record_views(prep.scratch, prep.counts)))
        torch.cuda.synchronize()
    launches = _build.LAUNCHES.get("vio_factors", 0) - before

    def flat(o):
        return [*o[:3], *(t for rec in o[3].values() for t in rec)]

    k = outs[0]
    for o in outs[1:]:
        check(all(same_bits(a, b) for a, b in zip(flat(k), flat(o))),
              "vio_factors: two launches differ")
    ref = vio_cuda.vio_factors_reference(p, *args)
    plain = vio_cuda.factors_reference(p, *state)
    rep = dict(launches=launches, tables={}, used={})
    check(list(plain) == list(k[3]), f"vio_factors: tables {list(k[3])}, "
          f"the plain version's {list(plain)}")
    pairs = []
    for name, (J, r, w, sel) in plain.items():
        Jk, rk, *rec = k[3][name]
        scale = float(J.abs().max())
        row = {}
        for lab, a, b in (("J", Jk, J), ("r", rk, r)):
            u = f32_ulps(a, b)
            diff = (a.double() - b.double()).abs()
            bad = (u > 1) & (diff > VIO_J_FLOOR * scale)
            row[lab] = dict(n=u.numel(), equal=int((u == 0).sum()),
                            one_ulp=int((u == 1).sum()),
                            floor=int(((u > 1) & ~bad).sum()),
                            max_abs=float(diff.max()))
            check(not bool(bad.any()), f"vio_factors {name} {lab}: "
                  f"{int(bad.sum())} entries more than 1 ulp and "
                  f"{VIO_J_FLOOR} x {scale:.3g} from the plain version's")
        # the records against the plain version's float32 products of
        # its own J and r in the record's columns
        M = own_columns(sel)
        Jm = J @ M
        Jw = Jm * w[:, None, None]
        want = (torch.einsum("fri,frj->fij", Jw, Jm),
                torch.einsum("fri,fr->fi", Jw, r),
                w * torch.sum(r * r, dim=-1))
        bounds = vio_sum_bounds([((Jk, rk), (J, r), w, M)], per_factor=True)
        row["records"] = {
            lab: vio_within(f"{name} {lab}", a, b, t)
            for lab, a, b, t in zip(("(wJ)^T J", "(wJ)^T r", "w |r|^2"),
                                    rec, want, bounds)}
        rep["tables"][name] = row
        pairs.append(((Jk, rk), (J, r), w, sel))
    E = vio_cuda.embedding(K, dev)
    base = [(E @ Hpp @ E.T, p.prior_H), (E @ gp, p.prior_b), (vcost,)]
    bounds = vio_sum_bounds(pairs, base=base)
    rep["max_abs_err"], rep["rel"] = 0.0, {}
    for lab, a, b, b0, t in zip(("H", "g", "cost"), k[:3], ref, base,
                                bounds):
        rep["used"][lab] = vio_within(lab, a, b, t)
        # and the whole within VIO_FACTOR_TOL of the factor part
        scale = float((b - sum(b0)).abs().max())
        err = float((a.double() - b.double()).abs().max())
        rep["rel"][lab] = err / max(scale, 1e-30)
        rep["max_abs_err"] = max(rep["max_abs_err"], err)
        check(err <= VIO_FACTOR_TOL * scale, f"vio_factors {lab}: max abs "
              f"err {err:.3g} > {VIO_FACTOR_TOL} x {scale:.3g}")
    if graph_replays:
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            prep(*args)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            g_out = prep(*args)
        g_out += (vio_cuda.record_views(prep.scratch, prep.counts),)
        for _ in range(graph_replays):
            graph.replay()
            torch.cuda.synchronize()
            check(all(same_bits(a, b) for a, b in zip(flat(g_out), flat(k))),
                  "vio_factors: a graph replay differs from the launch")
        rep["graph_replays"] = graph_replays
    tables = [t for t in (p.imu, p.gps, p.between) if t is not None]
    n_f64 = n_f32 = 0
    for name in plain:
        n, R = vio_cuda.SHAPES[name]
        F = getattr(p, name).valid.shape[0]
        # a lane per tangent column; per factor fl(w J), the product-sums
        # of (w J)^T J and (w J)^T r, and w |r|^2
        n_f64 += F * n * VIO_DUAL_OPS[name]
        n_f32 += F * (3 * R * n * n + 3 * R * n + 2 * R + 1)
    # every entry of H and g placed: two adds a term at most
    N = K * vio_cuda.D + 6
    n_f32 += 2 * (N * N + N)
    rep.update(
        out=k, fn=lambda: prep(*args),
        plain=lambda: vio_cuda.vio_factors_reference(p, *args),
        symbols=("vio_factors_kernel",), device_ops=1,
        nbytes=sum(t.nbytes for t in (*args, p.prior_H, p.prior_b))
        + sum(f.nbytes for t in tables for f in t) + sum(
            t.nbytes for t in k[:3]),
        ops_s=n_f64 / F64_OPS_PER_S + f32_ops_s(n_f32),
        f64_ops=n_f64, f32_ops=n_f32)
    return rep


def vio_factor_kernels(dev, kernels):
    """Phase 2, the VIO factor kernel: check_vio_factors on each of
    VIO_FACTOR_CASES, with graph replays (the stage D problem with GPS
    the table's entry, the others beside it)."""
    recs = {}
    for case in VIO_FACTOR_CASES:
        rep = check_vio_factors(vio_factors_problem(dev, case),
                                graph_replays=5)
        tabs = "; ".join(
            f"{name}: " + ", ".join(
                f"{lab} {v['equal']}/{v['n']} equal, {v['one_ulp']} 1 ulp "
                f"apart, {v['floor']} under the floor"
                for lab, v in row.items() if lab in ("J", "r"))
            + ", records " + ", ".join(
                f"{lab} {v:.3g}" for lab, v in row["records"].items())
            for name, row in rep["tables"].items())
        print(f"# kernel vio_factors {case}: bitwise equal across two "
              f"launches and {rep['graph_replays']} graph replays, records "
              f"included; vs the plain version {tabs}; "
              f"H, g, cost "
              + ", ".join(f"{lab} {v:.3g}" for lab, v in rep["used"].items())
              + f" (records and H, g, cost: the largest share of an "
              f"entry's bound); max abs err / largest factor-part entry "
              + ", ".join(f"{lab} {v:.3g}" for lab, v in rep["rel"].items())
              + "; "
              f"float64 ops {rep['f64_ops']:.0f}, float32 ops "
              f"{rep['f32_ops']:.0f}")
        recs[case] = {key: rep[key] for key in (
            "max_abs_err", "fn", "plain", "symbols", "device_ops", "nbytes",
            "ops_s")}
    main = recs.pop("imu+gps")
    kernels["vio_factors"] = dict(
        route="cuda", source="mcslam_tpu_torch/csrc/vio_factors.cu",
        replaces="mcslam_tpu/backend/ba_vio.py:257-258,298-299,339-340",
        at=recs, **main)

def plateau_candidates(rng, C, L, G, ncx, dev):
    """fast_select-shaped candidates with few distinct values (ties
    everywhere, values with and without the rank bonus, zeros and -0.0),
    random raster offsets and level sizes (a level's true size at least
    half the plane's): cand_v, cand_rid (L C, G, 4), h_l, w_l (L C,)."""
    import torch

    vals = np.array([0.0, -0.0, 0.05, 0.05, 0.3, 1.05, 1.3, 1.3], np.float32)
    v = vals[rng.randint(0, len(vals), (L * C, G, 4))]
    r = rng.randint(0, 256, (L * C, G, 4)).astype(np.int32)
    Hp, Wp = -(-G // ncx) * 16, ncx * 16
    h_l = np.repeat(rng.randint(Hp // 2, Hp + 1, L), C).astype(np.int32)
    w_l = np.repeat(rng.randint(Wp // 2, Wp + 1, L), C).astype(np.int32)
    return tuple(torch.from_numpy(a).to(dev) for a in (v, r, h_l, w_l))


def gemm_pyramid(imgs, levels):
    """The pyramid and stack as the port built them before orb_pyramid:
    per image and level two float32 GEMMs with the (n_out, n_in)
    resize matrices, then a replicate pad of each level and one cat (the
    pyramid row's earlier implementation, timed beside the kernel)."""
    import torch
    import torch.nn.functional as F

    from mcslam_tpu_torch.ops import image as image_ops

    B, H0, W0 = imgs.shape
    out, x = [imgs], imgs
    for h, w in image_ops.pyramid_shapes(H0, W0, levels, 1.2)[1:]:
        Wh = gemm_pyramid.mats.setdefault(
            (x.shape[1], h, imgs.device), torch.from_numpy(
                image_ops._resize_matrix(x.shape[1], h)).to(imgs.device))
        Ww = gemm_pyramid.mats.setdefault(
            (x.shape[2], w, imgs.device), torch.from_numpy(
                image_ops._resize_matrix(x.shape[2], w)).to(imgs.device)).T
        x = torch.stack([(Wh @ im) @ Ww for im in x])
        out.append(x)
    return torch.cat([F.pad(lv[None], (0, W0 - lv.shape[-1], 0,
                                       H0 - lv.shape[-2]),
                            mode="replicate")[0] for lv in out]).contiguous()


gemm_pyramid.mats = {}


def select_in_graph(a, kw, dev):
    """orb_select on the arguments a, kw captured in a CUDA graph: two
    replays bitwise equal to the plain version."""
    import torch

    from mcslam_tpu_torch.ops import orb_cuda

    ref = orb_cuda.orb_select_reference(*a, **kw)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        orb_cuda.orb_select(*a, **kw)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = orb_cuda.orb_select(*a, **kw)
    for k in range(2):
        for x in out:
            x.zero_()
        graph.replay()
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(out, ref)),
              f"orb_select: graph replay {k} differs from the plain version")
    print("# kernel orb_select bench frame 0 in a CUDA graph: two replays "
          "bitwise equal to the plain version")


def orb_kernels(scene, rng, dev, kernels):
    """Phase 2, the ORB extraction's glue kernels (ops/orb_cuda): each at
    the bench frame's inputs (frame 0, recorded on the frame build's
    path: the (C, H, W) images, fast_select's candidates, the 3072
    patches) and at random shapes (the pyramid at 1 x 97 x 133 with 8
    levels, C = 2, 3 and 5; the selection on plateau-tied candidates at
    C = 1, 2, 3 and 5, with and without the compaction and with fewer
    candidates than the level quota; the descriptors of 777 patches at 32
    bins and of 5), through the kernel twice and the plain version:
    equal bit for bit; orb_select also through a CUDA graph replayed
    twice. Then the bench frame's extraction on the card against the
    CPU: the keypoints of every level and the descriptors."""
    import torch

    from mcslam_tpu_torch.frontend import frame
    from mcslam_tpu_torch.ops import orb, orb_cuda

    seen = capture_calls(lambda: frame.build_frame(
        scene.imgs[0], scene.rig, **scene.frame_kwargs()), {
            "orb_pyramid": (orb_cuda, "orb_pyramid"),
            "orb_select": (orb_cuda, "orb_select"),
            "orb_describe": (orb_cuda, "orb_describe")})

    def same(a, b):
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        return len(a) == len(b) and all(
            x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))

    def hold(name, label, fn, plain):
        k1, k2, ref = fn(), fn(), plain()
        torch.cuda.synchronize()
        check(same(k1, k2), f"{name} {label}: two runs differ")
        check(same(k1, ref), f"{name} {label}: differs from the plain "
              f"version")
        print(f"# kernel {name} {label}: bitwise equal to the plain version "
              f"and across two runs")
        return ref

    # the pyramid
    (imgs, L), pkw = seen["orb_pyramid"][0], seen["orb_pyramid"][1]
    cases = [(f"C={C} {H}x{W} L={L} (bench frame 0)", imgs, L)]
    for B, Hs, Ws, Ls in ((1, 97, 133, 8), (2, 144, 192, 3),
                          (3, 37, 53, 4), (5, 120, 160, 4),
                          (2, 240, 320, 10)):
        cases.append((f"C={B} {Hs}x{Ws} L={Ls} (random)",
                      torch.rand(B, Hs, Ws, generator=torch.Generator(
                          device=dev).manual_seed(Hs), device=dev), Ls))
    for label, im, lv in cases:
        hold("orb_pyramid", label, lambda im=im, lv=lv: orb_cuda.orb_pyramid(
            im, lv, **pkw), lambda im=im, lv=lv: orb_cuda.orb_pyramid_reference(
                im, lv, **pkw))
    gemm = gemm_pyramid(imgs, L)
    err_gemm = float((gemm - orb_cuda.orb_pyramid(imgs, L)).abs().max())
    print(f"# kernel orb_pyramid bench frame 0: max abs difference from the "
          f"earlier GEMM form {err_gemm:.3g}")
    check(err_gemm <= 1e-6, f"orb_pyramid: {err_gemm} from the GEMM form")
    shapes = orb.image_ops.pyramid_shapes(H, W, L, 1.2)
    launches = len(orb_cuda.pyramid_plan(
        H, W, L, 1.2, C, torch.cuda.get_device_properties(
            dev).multi_processor_count, orb_cuda.PYRAMID_SMEM))
    out_px = sum(h * w for h, w in shapes[1:]) * C
    mid_px = sum(h * pw for h, (_, pw) in zip(
        [s[0] for s in shapes[1:]], shapes[:-1])) * C
    kernels["orb_pyramid"] = dict(
        route="cuda", source="mcslam_tpu_torch/csrc/orb_pyramid.cu",
        replaces="mcslam_tpu/ops/image.py:106", max_abs_err=0.0,
        fn=lambda: orb_cuda.orb_pyramid(imgs, L, **pkw),
        plain=lambda: orb_cuda.orb_pyramid_reference(imgs, L, **pkw),
        also={"gemm_ms": lambda: gemm_pyramid(imgs, L)},
        symbols=("pyramid_tile_kernel",), device_ops=launches,
        # level 0 read once, the stack written once; 3 multiplies and 2
        # adds per output of each pass (K = 3 taps)
        nbytes=4 * imgs.numel() + 4 * L * imgs.numel(),
        ops_s=f32_ops_s(5 * (mid_px + out_px)))

    # the selection
    a, skw = seen["orb_select"]
    cv = a[0]
    LC = cv.shape[0]
    cases = [(f"C={C} L={L} (bench frame 0)", a, skw)]
    for Cr, Lr, Gr, npts in ((1, 4, 112, 768), (2, 8, 112, 512),
                             (3, 4, 1200, 768), (5, 1, 1200, 300),
                             (2, 4, 24, 768)):
        budgets = orb._level_budget(npts, Lr, 1.2)
        kw = dict(C=Cr, budgets=budgets,
                  n_out=min(npts, Lr * max(budgets)), scale=1.2, ncx=16)
        cases.append((f"C={Cr} L={Lr} G={Gr} n_out={kw['n_out']} of "
                      f"{Lr * max(budgets)} (plateau ties)",
                      plateau_candidates(rng, Cr, Lr, Gr, 16, dev), kw))
    for label, args, kw in cases:
        hold("orb_select", label,
             lambda args=args, kw=kw: orb_cuda.orb_select(*args, **kw),
             lambda args=args, kw=kw: orb_cuda.orb_select_reference(*args,
                                                                    **kw))
    select_in_graph(a, skw, dev)
    n_out = skw["n_out"]
    M = L * max(skw["budgets"])
    kernels["orb_select"] = dict(
        route="cuda", source="mcslam_tpu_torch/csrc/orb_select.cu",
        replaces="mcslam_tpu/ops/orb.py:219", max_abs_err=0.0,
        fn=lambda: orb_cuda.orb_select(*a, **skw),
        plain=lambda: orb_cuda.orb_select_reference(*a, **skw),
        symbols=("orb_select_one_kernel",), device_ops=1,
        # the candidates and level sizes read once; the 7 outputs written
        # once (8 + 4 + 4 + 4 + 1 + 8 + 4 bytes a slot)
        nbytes=8 * cv.numel() + 8 * LC + 33 * C * n_out,
        # a compare per candidate key and per slot key, and the slot
        # fields (~12 operations a slot)
        ops_s=f32_ops_s(cv.numel() + C * M + 12 * (LC * max(skw["budgets"])
                                                   + C * n_out)))

    # orientation and descriptors
    (patches, bins), dkw = seen["orb_describe"][0], seen["orb_describe"][1]
    T = patches.shape[0]
    rnd = torch.rand(777, orb.PATCH, orb.PATCH, generator=torch.Generator(
        device=dev).manual_seed(7), device=dev)
    cases = [(f"T={T} bins={bins} (bench frame 0)", patches, bins),
             ("T=777 bins=32 (uniform noise)", rnd, 32),
             ("T=5 bins=16 (uniform noise)", rnd[:5].contiguous(), 16)]
    for label, p, b in cases:
        hold("orb_describe", label,
             lambda p=p, b=b: orb_cuda.orb_describe(p, b),
             lambda p=p, b=b: orb_cuda.orb_describe_reference(p, b))
    m = orb.patch_moments(patches)
    check(torch.equal(orb_cuda.orb_describe(patches, bins)[0],
                      torch.atan2(m[:, 1], m[:, 0])),
          "orb_describe: the kernel's atan2f differs from torch.atan2")
    print("# kernel orb_describe: the angle equals torch.atan2 of the plain "
          "moments bit for bit")
    kernels["orb_describe"] = dict(
        route="cuda", source="mcslam_tpu_torch/csrc/orb_describe.cu",
        replaces="mcslam_tpu/ops/orb.py:114", max_abs_err=0.0,
        fn=lambda: orb_cuda.orb_describe(patches, bins),
        plain=lambda: orb_cuda.orb_describe_reference(patches, bins),
        symbols=("orb_describe_kernel",), device_ops=1,
        # the patches read once, angle and descriptor written once
        nbytes=T * (4 * PATCH_PX + 4 + 32),
        # 2 products and 2 adds per pixel for the moments, per bit two
        # roundings and a subtract
        ops_s=f32_ops_s(T * (4 * PATCH_PX + 3 * 256)))

    # the bench frame's extraction on the card against the CPU
    kw = dict(num_points=NPTS, num_levels=NLVL, angle_bins=BINS)
    kd = orb.extract_orb_rig(scene.imgs[0], **kw)
    kc = orb.extract_orb_rig(scene.imgs[0].cpu(), **kw)
    lvl0 = (kc.octave == 0) & kc.valid
    per = {f: bool(torch.equal(getattr(kd, f).cpu(), getattr(kc, f)))
           for f in orb.Keypoints._fields}

    def keyset(k, upper):
        v = (k.valid & ((k.octave > 0) == upper)).cpu()
        return {tuple(p) for p in k.xy.cpu()[v].tolist()}

    hd, hc = keyset(kd, True), keyset(kc, True)
    share = len(hd & hc) / max(len(hd), len(hc), 1)
    print(f"# extract_orb_rig bench frame 0, card vs CPU: level 0 "
          f"{int(lvl0.sum())} keypoints, levels >= 1 share {share:.4f} of "
          f"{len(hd)} / {len(hc)}; fields equal: {per}")
    check(keyset(kd, False) == keyset(kc, False),
          "extract_orb_rig: level-0 keypoints differ between card and CPU")
    check(share >= 0.95, f"extract_orb_rig: levels >= 1 share {share:.4f}")


def main() -> int:
    import tempfile
    from pathlib import Path

    import torch

    t_start = time.perf_counter()
    faulthandler.enable()  # a crash in native code prints the Python stack
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
    cluster = _build.library().mc_vio_factors_cluster()
    check(cluster > 1, f"vio_factors runs {cluster} block(s)")
    print(f"# vio_factors: one launch, one cluster of {cluster} CTAs")

    from mcslam_tpu_torch.slam import INITIALIZED
    from mcslam_tpu_torch.utils import metrics

    scene = Scene(dev)
    rng = np.random.RandomState(0)
    kernels = {}

    # ---- phase 2: kernels against their plain versions ----
    frame_kernels(scene, rng, dev, kernels)
    solver_kernels(scene, rng, dev, kernels)
    stereo_kernels(scene, rng, dev, kernels)
    geometry_kernels(scene, rng, dev, kernels)
    orb_kernels(scene, rng, dev, kernels)
    ransac_kernels(scene, dev, kernels)
    track_kernels(scene, dev, kernels)
    vio_factor_kernels(dev, kernels)
    solve_problem = _window_solves(scene, dev)
    err_small = _small_scene_cpu_vs_cuda(dev)
    print(f"# reference check, 2-camera 192x144 frame on the kernels (CUDA) "
          f"vs the plain versions (CPU): pose max abs err {err_small:.3g}")
    session_gap_phase(dev, smi)

    # ---- phase 3: the slice, launches counted ----
    _build.LAUNCHES.clear()
    ff0 = frame.build_frame(scene.imgs[0], scene.rig, **scene.frame_kwargs())
    mapstate, n_seed = seed_map(ff0, dev)
    check(n_seed >= 200, f"frame 0 seeded only {n_seed} landmarks")
    print(f"# slice: frame 0 keypoints {int(ff0.kp_valid.sum())}, intra "
          f"groups {int(ff0.im_valid.sum())}, seeded landmarks {n_seed}")
    results, by_drive = {}, {}
    for name, frac in (("fast", FASTPATH_FRAC), ("portfolio", 2.0)):
        before = collections.Counter(_build.LAUNCHES)
        results[name] = drive(scene, ff0, mapstate, frac)
        by_drive[name] = {n: (_build.LAUNCHES - before).get(n, 0)
                          for n in RANSAC_KERNELS}
        check_drive(name, results[name])
    check(not any(r["fast"] for r in results["portfolio"]),
          "forced-portfolio drive took the fast path")
    launches = dict(_build.LAUNCHES)
    print(f"# launches during the slice: {launches}")
    for n in ("fast_select", "patch_gather", *ORB_KERNELS, "hamming_argmin2",
              "pose_lm", *TRI_INTRA, *INTRA_GLUE, *RANSAC_KERNELS,
              *TRACK_KERNELS):
        check(launches.get(n, 0) > 0,
              f"kernel {n} was not launched on the slice's path")
    n_off = sum(not r["fast"] for r in results["fast"])
    nf = N_FRAMES - 1
    print(f"# the RANSAC kernels' launches: fast-path drive {by_drive['fast']} "
          f"({n_off} of {nf} frames off the fast path), forced-portfolio "
          f"drive {by_drive['portfolio']} ({nf} frames)")
    check(by_drive["portfolio"] == dict(ransac_score=4 * nf, kabsch_hyp=nf,
                                        pnp_hyp=nf),
          "the forced-portfolio drive did not score 4 times and make the two "
          "hypothesis batches once per frame")
    check(by_drive["fast"] == dict(ransac_score=nf + 3 * n_off,
                                   kabsch_hyp=n_off, pnp_hyp=n_off),
          "the fast-path drive's RANSAC launches do not follow its frames")
    for n in PORTFOLIO:
        kernels[n]["launches"] = by_drive["portfolio"][n]

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
    # (its graph log and phase 7's are replayed in phase 12)
    logs = tempfile.TemporaryDirectory()
    log_paths = (Path(logs.name) / "session.log", Path(logs.name) / "vio.log")
    slam, wrapper, launches, eager_ref = main_path_session(scene, log_paths[0])
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
    print(f"# launches during the session, in its device trace: {launches} "
          f"(the eager reference's plus the warm-ups' "
          f"{dict(graph_warmups(slam))}); counted by the wrappers (the "
          f"warm-ups and the eager frames): {wrapper}")
    print(f"# session graphs: {len(slam._frame_programs.programs)} frame "
          f"program(s) replayed {sum(p.replays for p in slam._frame_programs.programs.values())} "
          f"times, {len(slam._solve_programs.programs)} window-solve "
          f"programs")
    check(slam.device.type == "cuda", "session: the driver is not on the card")
    check(slam.state == INITIALIZED, "session: not INITIALIZED at the end")
    check(slam.stats["failures"] == 0,
          f"session: {slam.stats['failures']} tracking failures")
    check(slam.stats["keyframes"] >= MIN_KEYFRAMES,
          f"session: {slam.stats['keyframes']} keyframes < {MIN_KEYFRAMES}")
    check(np.all(np.isfinite(est)) and est.shape == (SESSION_FRAMES, 4, 4),
          "session: trajectory malformed or non-finite")
    check(ate <= MAX_ATE, f"session: ATE {ate:.4f} m > {MAX_ATE}")
    for n in PATH:
        # their launches: phase 3's forced-portfolio drive, phase 7's VIO
        # session
        if n in PORTFOLIO or n in VIO_KERNELS:
            continue
        check(launches[n] > 0 and wrapper.get(n, 0) > 0,
              f"kernel {n} was not launched on the main path")
        kernels[n]["launches"] = launches[n]

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

    # ---- phase 14: the graphed frame step, window and VIO solves ----
    vio_graphs = graphs_phase(scene, ff0, mapstate, solve_problem, dev, smi,
                              eager_ref)

    # ---- phase 6: the vision-only bootstraps, launches counted ----
    bootstrap_phase(scene, dev, kernels)

    # ---- phase 7: the visual-inertial and GPS path, launches counted ----
    vio_problems, vio_eager = vio_phase(scene, dev, kernels,
                                         log_path=log_paths[1])

    # ---- phase 9: loop closure and relocalization, launches counted ----
    loop_state = loop_phase(dev)

    # ---- phase 8: timing ----
    for n, k in kernels.items():
        time_kernel(n, k, smi)
        for label, rec in k.get("at", {}).items():
            time_kernel(f"{n} {label}", rec, smi)
        if "on_noise" in k:
            time_kernel(f"{n} on uniform noise", k["on_noise"], smi)
    for name, iters in BA_ITERS:
        def solve():
            return ba.ba_solve(solve_problem, iters=iters, gate_rounds=2,
                               kf_blocked=True)
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
    vio_timing(scene, vio_problems, smi, vio_graphs, vio_eager)

    # ---- phase 10: the loop path's timing ----
    loop_timing(loop_state, smi)

    # ---- phase 11: the app and data path, launches counted ----
    app_res = app_phase(scene, dev, smi)
    kernels["sgm_scan"]["launches"] = app_res["launches"].get("sgm_scan", 0)

    # ---- phase 12: the generic layout, replay, the mesh, the entry ----
    generic_phase(solve_problem, dev, smi)
    replay_phase(scene, dev, smi, log_paths)
    logs.cleanup()
    mesh_phase(scene, solve_problem, dev, smi, plain_times=times)

    # ---- phase 13: the native loader, MCRAW replay, the live viewer and
    # the dataset tools, launches counted ----
    tools_phase(scene, dev, smi, app_res)

    print(f"# chip_smoke: {time.perf_counter() - t_start:.1f} s from start to "
          f"end, the build included")
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


def counted(name, expect, fn):
    """fn() with the launch counters reset right before it and read right
    after; each kernel named in `expect` must have launched -> (fn's
    result, {kernel: launches})."""
    from mcslam_tpu_torch import _build

    _build.LAUNCHES.clear()
    out = fn()
    launches = dict(_build.LAUNCHES)
    print(f"# launches during {name}: {launches}")
    for n in expect:
        check(launches.get(n, 0) > 0, f"{name}: kernel {n} was not launched")
    return out, launches


def bootstrap_phase(scene, dev, kernels):
    """Phase 6: the driver on frames with too little rig depth, each path
    with the launch counters reset right before it and read right after.
    (a) BLANK_FRAMES blank frames, then BOOT_FRAMES bench frames through
    process_image: pending 17-point anchors, then the rig-depth bootstrap
    on the first bench frame; (b) mono_session: the monocular bootstrap
    and its two-view BA; (c) far_session: the 17-point bootstrap. Prints
    each gate and the host-clock time of the frames up to the init."""
    import torch

    from mcslam_tpu_torch.slam import (
        INITIALIZED, NOT_INITIALIZED, MultiCameraSLAM, SlamConfig)
    from mcslam_tpu_torch.utils import metrics

    ecfg = scene.frame_kwargs()
    main_path = ("fast_select", "patch_gather", *ORB_KERNELS,
                 "hamming_argmin2", "pose_lm", "ba_linearize", "ransac_score")

    # (a) blank frames, then the bench frames
    blank = torch.zeros_like(scene.imgs[0])
    imgs = [blank] * BLANK_FRAMES + scene.imgs[:BOOT_FRAMES]
    slam = MultiCameraSLAM(scene.rig, SlamConfig())
    states = []

    def step_a(s, k, img):
        info = s.process_image(img, k / 20.0, extract_cfg=ecfg)
        states.append(s.state)
        return info

    init_at, boot_ms = counted("bootstrap (a) blank frames", main_path,
                               lambda: run_frames(slam, imgs, step_a))[0]
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
    slam, poses1, init_at, boot_ms = counted(
        "bootstrap (b) mono", main_path, lambda: mono_session(dev))[0]
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
        "bootstrap (c) 17-point",
        ("hamming_argmin2", "pose_lm", "ba_linearize"),
        lambda: far_session(dev))[0]
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


def _lla(p):
    """Geodetic fix of an ENU position (the small-offset inverse of
    tests/test_slam_vio.py)."""
    lat = LLA0[0] + p[1] / 110_900.0
    lon = LLA0[1] + p[0] / (110_900.0 * np.cos(np.radians(LLA0[0])))
    return lat, lon, LLA0[2] + p[2]


def _no_transform(*a, **kw):
    raise AssertionError("a torch.func transform on the card's VIO path")


def _imu_span(ts, t_prev, t):
    return (ts > t_prev) & (ts <= t)


def vio_phase(scene, dev, kernels, log_path=None):
    """Phase 7: (a) the stage D solve on the card under sync-debug
    "error" against the CPU, with and without GPS, warm and cold, with
    ba_linearize and vio_factors launched once per linearization inside
    it and no torch.func transform; (b) the VIO + GPS session through
    process_image (its graph log written to log_path if given); (c) the
    low-rate GPS dummy-keyframe drive. Each with the launch counters reset
    right before it and read right after; (b) runs eagerly first, and its
    graphed run's launches are counted in a device trace too. Returns the
    stage D problems on the card by GPS factor count and the eager
    session's frame records, and sets the kernels' VIO_KERNELS launches
    to (b)'s, counted in its device trace."""
    import torch

    from mcslam_tpu_torch import _build
    from mcslam_tpu_torch.backend import ba_vio
    from mcslam_tpu_torch.backend import imu as imu_mod
    from mcslam_tpu_torch.data import synthetic
    from mcslam_tpu_torch.slam import INITIALIZED
    from mcslam_tpu_torch.utils import metrics

    # the IMU math on CUDA tensors against the CPU (the driver hands it
    # CPU tensors; this shows the module runs on the card)
    _, ts, gyro, acc = synthetic.analytic_circle_imu(
        5, radius=4.0, omega=0.35, seed=3, **VIO_IMU, **VIO_BIAS)
    sel = ts <= 0.2
    args = [torch.from_numpy(np.asarray(a, np.float32)) for a in (
        np.diff(ts[sel], prepend=0.0), gyro[sel], acc[sel])]
    args += [torch.ones(int(sel.sum()), dtype=torch.bool),
             torch.full((6,), 1e-3)]
    pre = [imu_mod.preintegrate(*(a.to(d) for a in args))
           for d in ("cpu", dev)]
    st = [imu_mod.ImuState(torch.eye(4, device=d), torch.ones(3, device=d),
                           torch.zeros(6, device=d)) for d in ("cpu", dev)]
    pred = [imu_mod.predict(s, p) for s, p in zip(st, pre)]
    err_imu = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        (*pre[1][:10], *pred[1]), (*pre[0][:10], *pred[0])))
    check(err_imu <= 1e-5, f"imu on the card vs the CPU: {err_imu}")
    print(f"# imu: preintegrate ({int(sel.sum())} samples) and predict on "
          f"the card vs the CPU, max abs err {err_imu:.3g}")

    # (a) the stage D solve
    problems = {}
    for num_gps in (0, VIO_GPS):
        f = synthetic.random_vio_problem(scene.rig, num_gps=num_gps)
        p_dev = ba_vio.problem_from_numpy(**f)
        p_cpu = ba_vio.problem_from_numpy(**dict(f, device="cpu"))
        check(p_dev.poses.device == dev, "the VIO problem is not on the card")
        problems[num_gps] = p_dev
        for name, iters in BA_ITERS:
            ref = ba_vio.vio_solve(p_cpu, iters=iters, kf_blocked=True)
            torch.cuda.synchronize()
            _build.LAUNCHES.clear()
            torch.cuda.set_sync_debug_mode("error")
            # on the card the factors take no torch.func transform
            transforms = (torch.func.vmap, torch.func.jacfwd)
            torch.func.vmap = torch.func.jacfwd = _no_transform
            try:
                t0 = time.perf_counter()
                res = ba_vio.vio_solve(p_dev, iters=iters, kf_blocked=True)
                enqueue_ms = (time.perf_counter() - t0) * 1e3
            finally:
                torch.cuda.set_sync_debug_mode(0)
                torch.func.vmap, torch.func.jacfwd = transforms
            t0 = time.perf_counter()
            torch.cuda.synchronize()
            wait_ms = (time.perf_counter() - t0) * 1e3
            n_lin = _build.LAUNCHES.get("ba_linearize", 0)
            n_vf = _build.LAUNCHES.get("vio_factors", 0)
            # ba.lm_schedule: one linearization, then one per step
            check(n_lin == n_vf == 1 + 2 * iters,
                  f"vio_solve {name}: ba_linearize launched {n_lin} and "
                  f"vio_factors {n_vf} times, not once per linearization "
                  f"({1 + 2 * iters})")
            err = {k: float((getattr(res, k).cpu() - getattr(ref, k)).abs()
                            .max()) for k in VIO_TOL}
            moved = float((ref.poses - p_cpu.poses).abs().max())
            check(all(np.isfinite(list(err.values()))),
                  f"vio_solve {name}: non-finite")
            print(f"# vio_solve {name} ({iters} x 2) K=6 Ok=1365 L=2048 C=4, "
                  f"{num_gps} GPS factors: queued with no host sync in "
                  f"{enqueue_ms:.2f} ms, then {wait_ms:.2f} ms to finish; "
                  f"ba_linearize and vio_factors launched {n_lin} times "
                  f"each; card vs CPU max abs "
                  f"err {err} (the solve moved the poses {moved:.3g}); cost "
                  f"{float(res.cost):.6g} card, {float(ref.cost):.6g} CPU")
            for k, tol in VIO_TOL.items():
                check(err[k] <= tol, f"vio_solve {name}: {k} card vs CPU "
                      f"{err[k]} > {tol}")

    # (b) the VIO + GPS session: eagerly on the card (the reference), then
    # graphed under a device trace, whose counts of the path's kernels
    # (graph replays included, which no wrapper counts) must equal the
    # eager session's plus the graphs' warm-ups'
    _build.LAUNCHES.clear()
    eager = vio_session(scene, cuda_graphs=False)
    launches_e = {n: _build.LAUNCHES.get(n, 0) for n in PATH}
    print(f"# launches during the eager VIO + GPS session (cuda_graphs="
          f"False): {launches_e}")

    def session():
        _build.LAUNCHES.clear()
        patterns = []
        out = vio_session(scene, log_path=log_path, patterns=patterns)
        return out, patterns, dict(_build.LAUNCHES)

    def expect(res):
        warm = graph_warmups(res[0][0])
        return {n: launches_e[n] + warm.get(n, 0) for n in PATH}

    ((slam, poses, times, init_at), patterns, launches), traced = (
        traced_launches(session, expect))
    _, est = slam.trajectory_arrays()
    ate = metrics.ate_rmse(est[init_at:], poses[init_at:])
    fails = slam.stats["failures"]
    print(f"# VIO + GPS session: {VIO_FRAMES} frames, IMU and vision "
          f"initialized on frame {init_at}, state {slam.state}, keyframes "
          f"{slam.stats['keyframes']}, VIO solves "
          f"{slam.stats.get('window_ba_vio', 0)}, fixes attached "
          f"{len(slam.kf_gps)}, GPS initialized {slam.gps_initialized}, "
          f"failures {fails}, bias {np.round(slam.bias, 5).tolist()}, ATE "
          f"from the init frame {ate:.4f} m; launches in the device trace "
          f"{traced}, counted by the wrappers {launches}")
    for line in slam.timers.report().splitlines():
        print("#   " + line)
    check(slam.imu_initialized and slam.state == INITIALIZED,
          "VIO session: IMU not initialized or not INITIALIZED at the end")
    check(fails == 0, f"VIO session: {fails} tracking failures")
    check(slam.stats.get("window_ba_vio", 0) > 0, "VIO session: no VIO solve")
    check(len(slam.kf_gps) >= 1, "VIO session: no fix attached")
    check(np.all(np.isfinite(est)) and ate <= VIO_MAX_ATE,
          f"VIO session: ATE {ate:.4f} m > {VIO_MAX_ATE}")
    for n in PATH:
        check(n in PORTFOLIO or (traced[n] > 0 and launches.get(n, 0) > 0),
              f"kernel {n} was not launched in the VIO session")
    for n in VIO_KERNELS:
        kernels[n]["launches"] = traced[n]
    progs = vio_programs(slam)
    n_solves = slam.stats["window_ba_vio"]
    n_cold = n_solves - len(patterns)
    warm_up = sum(p.warmup.get("ba_linearize", 0) for p in progs.values())
    print(f"# ba_linearize in the VIO session: {traced['ba_linearize']} "
          f"launches in the device trace = {launches_e['ba_linearize']} of "
          f"the eager session + {graph_warmups(slam)['ba_linearize']} of "
          f"the graphs' warm-ups ({warm_up} of the VIO programs'); "
          f"{n_solves} VIO solves: {n_cold} cold, eager, {len(patterns)} "
          f"warm, replayed")
    print(f"# VIO + GPS session graphs: {len(progs)} VIO program keys for "
          f"{len(patterns)} warm solves (keying on the factor tables' index "
          f"columns too would make {len(set(patterns))})")
    for key, prog in progs.items():
        print(f"#   VIO program (iters {key[1]}, tables {key[4]}, K "
              f"{key[5][0][0][0]}): capture {prog.capture_ms:.1f} ms, pool "
              f"{prog.pool_bytes() / 2**20:.1f} MiB, replays {prog.replays}")
    check(slam.cuda_graphs and progs, "VIO session: no graphed VIO solve")
    check(n_cold == 1 and all(p[0] == slam.cfg.ba_iters for p in patterns),
          f"VIO session: {n_cold} eager VIO solves, not the one cold "
          f"solve; graphed iters {[p[0] for p in patterns]}")
    check(sum(p.replays for p in progs.values()) == len(patterns),
          f"VIO session: {len(patterns)} graphed VIO solves, replays "
          f"{[p.replays for p in progs.values()]}")

    # (c) the low-rate GPS dummy-keyframe drive
    _build.LAUNCHES.clear()
    slam = dummy_drive(dev)
    launches = dict(_build.LAUNCHES)
    dummies = [k for k in slam.keyframes if k.is_dummy]
    vision_ts = {k.timestamp for k in slam.keyframes if not k.is_dummy}
    print(f"# GPS dummy drive: {DUMMY_FRAMES // 3} vision frames, state "
          f"{slam.state}, dummy keyframes {slam.stats.get('gps_dummy_kfs', 0)} "
          f"({len(dummies)} in the list), VIO solves "
          f"{slam.stats.get('window_ba_vio', 0)}; launches {launches}")
    check(slam.state == INITIALIZED, "GPS dummy drive: not INITIALIZED")
    check(slam.stats.get("gps_dummy_kfs", 0) >= 1 and dummies,
          "GPS dummy drive: no dummy keyframe")
    check(all(d.timestamp not in vision_ts and d.kf_id in slam.kf_gps
              for d in dummies),
          "GPS dummy drive: a dummy at a vision timestamp or without a fix")
    check(launches.get("ba_linearize", 0) > 0,
          "GPS dummy drive: ba_linearize not launched")
    return problems, eager[2]


def vio_programs(slam) -> dict:
    """The session's captured VIO solve programs by key."""
    return {k: p for k, p in slam._solve_programs.programs.items()
            if k[0] == "vio"}


def index_pattern(problem, iters) -> tuple:
    """iters and the VIO problem's factor-table index columns: what a
    graphed solve keyed on them would tell apart."""
    return (iters,) + tuple(
        None if t is None else tuple(
            tuple(getattr(t, f).tolist()) for f in t._fields
            if f in ("i", "j", "kf"))
        for t in (problem.imu, problem.gps, problem.between))


def vio_session(scene, frames=VIO_FRAMES, log_path=None, cuda_graphs=None,
                patterns=None):
    """frames blob frames of the scene's rig and landmarks along
    analytic_circle_imu's circle (0.35 rad/s, 0.3 s stationary, 0.3 s
    ramp, tests/test_slam_vio.py's noise and biases), 200 Hz IMU and a GPS
    fix per frame through process_image with bench.py's extraction ->
    (slam, true poses, [(wall s, keyframe?, capture?)], the frame the session
    initialized on); finalize()d; each frame's record also says whether
    it captured a program. cuda_graphs=False runs the session
    eagerly on the card; a `patterns` list gets each graphed VIO solve's
    index_pattern."""
    import torch

    from mcslam_tpu_torch.backend.imu import ImuParams
    from mcslam_tpu_torch.data import synthetic
    from mcslam_tpu_torch.slam import MultiCameraSLAM, SlamConfig

    poses, imu_ts, gyro, accel = synthetic.analytic_circle_imu(
        frames, fps=20.0, radius=4.0, omega=0.35, stationary_s=0.3,
        ramp_s=0.3, seed=0, **VIO_IMU, **VIO_BIAS)
    imgs = synthetic.render_blob_images(scene.rig, poses, scene.lms)
    slam = MultiCameraSLAM(scene.rig, SlamConfig(imu_init_samples=40),
                           imu_params=ImuParams(**VIO_IMU),
                           gps_lever_arm=np.zeros(3))
    if cuda_graphs is not None:
        slam.cuda_graphs = cuda_graphs
    if patterns is not None:
        replay = slam._replay_vio_solve

        def recorded(problem, iters, **kw):
            patterns.append(index_pattern(problem, iters))
            return replay(problem, iters, **kw)

        slam._replay_vio_solve = recorded
    if log_path is not None:
        from mcslam_tpu_torch.utils import mapio

        slam.attach_graph_log(mapio.GraphLogWriter(log_path))
    times, init_at = [], None
    progs = (slam._frame_programs.programs, slam._solve_programs.programs)
    for k in range(frames):
        t, t_prev = k / 20.0, (k - 1) / 20.0 if k else -1.0
        sel = _imu_span(imu_ts, t_prev, t)
        img = torch.from_numpy(imgs[k]).to(scene.dev)
        n_prog = sum(map(len, progs))
        t0 = time.perf_counter()
        info = slam.process_image(
            img, t, imu=(imu_ts[sel], gyro[sel], accel[sel]),
            gps=(np.array([t]), np.array([_lla(poses[k][:3, 3])])),
            extract_cfg=scene.frame_kwargs())
        times.append((time.perf_counter() - t0, info["keyframe"],
                      sum(map(len, progs)) > n_prog))
        if info.get("initialized") and init_at is None:
            init_at = k
    slam.finalize()
    if log_path is not None:
        dump_graph(slam, log_path)
    check(init_at is not None, "VIO session: never initialized")
    return slam, poses, times, init_at


def dummy_drive(dev, seed=7):
    """tests/test_slam_vio.py's GPS dummy-keyframe session on the card: a
    3-camera VGA rig, feature-level frames with 1.6 px noise, vision every
    3rd of DUMMY_FRAMES frames, IMU at 200 Hz and GPS fixes at 1/3 and 2/3
    of every frame gap (gps_sigma 0.1, gps_min_move 0.02)."""
    import torch

    from mcslam_tpu_torch.backend.imu import ImuParams
    from mcslam_tpu_torch.data import synthetic
    from mcslam_tpu_torch.frontend import frame
    from mcslam_tpu_torch.ops import hamming
    from mcslam_tpu_torch.slam import MultiCameraSLAM, SlamConfig

    fps = 20.0
    rig = synthetic.make_synthetic_rig(
        synthetic.SyntheticRigSpec(num_cams=3, baseline=0.2), device=dev)
    poses, imu_ts, gyro, accel = synthetic.analytic_circle_imu(
        DUMMY_FRAMES, fps=fps, radius=4.0, omega=0.35, stationary_s=0.3,
        ramp_s=0.3, seed=seed, **VIO_IMU, **VIO_BIAS)
    feats = synthetic.render_feature_frames(
        rig, poses, synthetic.make_landmarks(900, seed=seed + 1,
                                             depth_range=(5.0, 16.0)),
        synthetic.make_descriptors(900, seed=seed + 2), kps_per_cam=320,
        px_noise=1.6, desc_bit_noise=5, fps=fps, seed=seed + 3)
    fixes_t, fixes_lla = [], []
    for k in range(DUMMY_FRAMES - 1):
        for frac in (1.0 / 3.0, 2.0 / 3.0):
            fixes_t.append((k + frac) / fps)
            fixes_lla.append(_lla((1 - frac) * poses[k][:3, 3]
                                  + frac * poses[k + 1][:3, 3]))
    gps_t, gps_lla = np.array(fixes_t), np.array(fixes_lla)
    cfg = SlamConfig(window_size=4, ba_obs_capacity=8192, ba_lm_capacity=1024,
                     local_map_landmarks=1024, kf_translation=0.1,
                     kf_rotation=0.08, imu_init_samples=40, gps_sigma=0.1,
                     gps_min_move=0.02)
    slam = MultiCameraSLAM(rig, cfg, imu_params=ImuParams(**VIO_IMU),
                           gps_lever_arm=np.zeros(3))
    t_prev = -1.0
    for k in range(0, DUMMY_FRAMES, 3):
        f, t = feats[k], k / fps
        sel, gsel = _imu_span(imu_ts, t_prev, t), _imu_span(gps_t, t_prev, t)
        ff = frame.build_frame_from_keypoints(
            torch.from_numpy(f.uv).to(dev), hamming.desc_to_torch(f.desc, dev),
            torch.from_numpy(f.valid).to(dev), rig, max_intra=1024)
        slam.process_frame(ff, f.timestamp,
                           imu=(imu_ts[sel], gyro[sel], accel[sel]),
                           gps=(gps_t[gsel], gps_lla[gsel]))
        t_prev = t
    slam.finalize()
    return slam


# -- phase 9: loop closure and relocalization ---------------------------------


def global_ba_phase(dev):
    """Phase 9 (a): the global solve (ba_solve, kf-blocked, the driver's
    global_ba_iters 10 x 2 gate rounds) at tests/test_global_ba.py's shape
    (GBA_TEST) on the card under sync-debug "error" against the plain
    solve on the CPU (poses within 1e-3), then at the SlamConfig cap
    (GBA_CAP) on the card alone: the cost falls, the poses stay finite;
    peak device memory printed. ba_linearize must launch. -> the two
    problems on the card, by name."""
    import torch

    from mcslam_tpu_torch import _build
    from mcslam_tpu_torch.backend import ba
    from mcslam_tpu_torch.data import synthetic

    rig = synthetic.make_synthetic_rig(
        synthetic.SyntheticRigSpec(num_cams=C, image_size=(W, H)),
        device=dev)
    problems = {}
    for name, (K, L, O) in (("test shape", GBA_TEST), ("cap", GBA_CAP)):
        f = synthetic.random_window_ba_problem(
            rig, num_kfs=K, num_lms=L, obs_capacity=O, px_noise=0.5,
            step_angle=GBA_STEP)
        p = ba.problem_from_numpy(**f)
        problems[name] = p
        cost0 = float(ba._total_cost(p, 2.5))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        _build.LAUNCHES.clear()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            res = ba.ba_solve(p, iters=GBA_ITERS, kf_blocked=True)
            enqueue_ms = (time.perf_counter() - t0) * 1e3
        finally:
            torch.cuda.set_sync_debug_mode(0)
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        wait_ms = (time.perf_counter() - t0) * 1e3
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
        n_lin = _build.LAUNCHES.get("ba_linearize", 0)
        poses = res.poses.cpu()
        cost = float(res.cost)
        line = (f"# global ba_solve {name} K={K} Ok={O // K} L={L} C={C} "
                f"({GBA_ITERS} x 2): queued with no host sync in "
                f"{enqueue_ms:.2f} ms, then {wait_ms:.2f} ms to finish; "
                f"ba_linearize launched {n_lin} times; cost {cost0:.6g} -> "
                f"{cost:.6g}; peak device memory {peak:.3f} GiB above the "
                f"{base / 2**30:.3f} GiB held before")
        check(n_lin > 0, f"global ba_solve {name}: ba_linearize not launched")
        check(bool(torch.isfinite(poses).all()),
              f"global ba_solve {name}: non-finite poses")
        check(cost < cost0, f"global ba_solve {name}: the cost did not fall")
        if name == "test shape":
            ref = ba.ba_solve(ba.problem_from_numpy(**dict(f, device="cpu")),
                              iters=GBA_ITERS, kf_blocked=True)
            err = float((poses - ref.poses).abs().max())
            line += f"; poses vs the CPU plain solve max abs err {err:.3g}"
            check(err <= 1e-3, f"global ba_solve: card vs CPU pose error "
                  f"{err}")
        print(line)
        del res
    return problems


def loop_session(dev, frames=LOOP_FRAMES, seed=0):
    """Phase 9 (b): the bench configuration (C cameras, W x H, NPTS
    keypoints per camera, NLVL levels, SlamConfig defaults) plus
    final_global_ba, on `frames` frames of loop_trajectory (radius 4 m,
    the last LOOP_REVISIT frames revisit the start) around
    make_ring_landmarks (LOOP_LMS at 9 m), rendered by
    render_blob_images(textured=True), through process_image, with a
    vocabulary trained on the descriptors of the first LOOP_TRAIN frames
    and tests/test_image_e2e.py's LoopConfig; `seed` seeds the driver's
    RANSAC -> (slam, true poses, vocabulary, [(wall s, keyframe?)]);
    finalize()d."""
    import torch

    from mcslam_tpu_torch.data import synthetic
    from mcslam_tpu_torch.frontend import frame
    from mcslam_tpu_torch.loop import vocab as vocab_mod
    from mcslam_tpu_torch.loop.detector import LoopConfig
    from mcslam_tpu_torch.ops import hamming
    from mcslam_tpu_torch.slam import MultiCameraSLAM, SlamConfig

    rig = synthetic.make_synthetic_rig(
        synthetic.SyntheticRigSpec(num_cams=C, image_size=(W, H)),
        device=dev)
    poses = synthetic.loop_trajectory(frames, radius=4.0,
                                      revisit_frames=LOOP_REVISIT, seed=0)
    lms = synthetic.make_ring_landmarks(LOOP_LMS, radius=9.0, seed=1)
    imgs = synthetic.render_blob_images(rig, poses, lms, seed=2,
                                        textured=True)
    imgs = [torch.from_numpy(imgs[k]).to(dev) for k in range(frames)]
    ecfg = dict(num_points=NPTS, num_levels=NLVL, max_intra=MAXI,
                angle_bins=BINS)
    train = []
    for k in range(LOOP_TRAIN):
        ff = frame.build_frame(imgs[k], rig, **ecfg)
        train.append(hamming.desc_to_numpy_u32(ff.kp_desc[ff.kp_valid]))
    vocab = vocab_mod.Vocabulary.train(np.concatenate(train), k=6, depth=3,
                                       iters=4)
    slam = MultiCameraSLAM(rig, SlamConfig(final_global_ba=True), seed=seed,
                           vocab=vocab, loop_config=LoopConfig(**LOOP_CFG))
    times = []
    for k in range(frames):
        t0 = time.perf_counter()
        info = slam.process_image(imgs[k], k / 20.0, extract_cfg=ecfg)
        times.append((time.perf_counter() - t0, info["keyframe"]))
    slam.finalize()
    return slam, poses, vocab, times


def drift_scene(dev, num_frames=DRIFT_FRAMES, revisit=8, seed=0):
    """Phase 9 (c): tests/test_loop_pipeline.py's scene on the given
    device: a 3-camera rig (the synthetic default, 640x480) on a 5 m loop
    around 1400 ring landmarks with a 9 m sensing range, feature-level
    frames clean at the start and the revisit and 1.8 px noisy through the
    middle -> (rig, true poses, FrameFeatures per frame, the landmarks'
    descriptors)."""
    import torch

    from mcslam_tpu_torch.data import synthetic
    from mcslam_tpu_torch.frontend import frame
    from mcslam_tpu_torch.ops import hamming

    rig = synthetic.make_synthetic_rig(
        synthetic.SyntheticRigSpec(num_cams=3, baseline=0.2), device=dev)
    poses = synthetic.loop_trajectory(num_frames, radius=5.0,
                                      revisit_frames=revisit, seed=seed)
    lms = synthetic.make_ring_landmarks(1400, radius=11.0, seed=seed + 1)
    descs = synthetic.make_descriptors(1400, seed=seed + 2)
    kw = dict(kps_per_cam=320, desc_bit_noise=4, seed=seed + 3,
              max_depth=9.0)
    clean = synthetic.render_feature_frames(rig, poses, lms, descs,
                                            px_noise=0.4, **kw)
    noisy = synthetic.render_feature_frames(rig, poses, lms, descs,
                                            px_noise=1.8, **kw)
    lo, hi = 10, num_frames - revisit - 4
    ffs = []
    for i in range(num_frames):
        f = noisy[i] if lo <= i < hi else clean[i]
        ffs.append(frame.build_frame_from_keypoints(
            torch.from_numpy(f.uv).to(dev),
            hamming.desc_to_torch(f.desc, dev),
            torch.from_numpy(f.valid).to(dev), rig, max_intra=1024))
    return rig, poses, ffs, descs


def drift_runs(dev):
    """Phase 9 (c): the drift scene through process_frame with and
    without loop closure (tests/test_loop_pipeline.py's SlamConfig,
    vocabulary and LoopConfig) -> (loop slam, VO slam, true poses, rig,
    frames, vocabulary, [loop-run wall s per frame])."""
    from mcslam_tpu_torch.loop import vocab as vocab_mod
    from mcslam_tpu_torch.loop.detector import LoopConfig
    from mcslam_tpu_torch.slam import MultiCameraSLAM, SlamConfig

    rig, poses, ffs, descs = drift_scene(dev)
    cfg = SlamConfig(window_size=4, ba_obs_capacity=8192,
                     ba_lm_capacity=1024, local_map_landmarks=2048,
                     kf_translation=0.3, kf_rotation=0.2)
    vocab = vocab_mod.Vocabulary.train(descs, k=6, depth=3, iters=3)
    runs, wall = [], []
    for v in (vocab, None):
        slam = MultiCameraSLAM(rig, cfg, vocab=v, loop_config=LoopConfig(
            dislocal=12, k_consistency=2, min_nss=0.02, alpha=0.15,
            min_matches=15, min_inliers=10) if v is not None else None)
        for k, ff in enumerate(ffs):
            t0 = time.perf_counter()
            slam.process_frame(ff, k / 20.0)
            if v is not None:
                wall.append(time.perf_counter() - t0)
        slam.finalize()
        runs.append(slam)
    return runs[0], runs[1], poses, rig, ffs, vocab, wall


def retrieval_corpus(dev):
    """Phase 9 (d): tests/test_hard_synthetic.py's retrieval corpus, one
    camera at RET_W x RET_H: RET_DB database entries and RET_Q revisit
    queries of the textured world along a 4 m loop (harsher photometric
    corruption on the queries), RET_NEG queries of a different texture
    world; ORB (384 points, 3 levels) by the port on `dev` in batches of 8
    -> (rig, poses, vocabulary, BoWs (host), descriptors, validity and
    undistorted keypoints per image, on `dev`)."""
    import torch

    from mcslam_tpu_torch.data import synthetic
    from mcslam_tpu_torch.loop import vocab as vocab_mod
    from mcslam_tpu_torch.ops import hamming, orb

    rig = synthetic.make_synthetic_rig(synthetic.SyntheticRigSpec(
        num_cams=1, image_size=(RET_W, RET_H), focal=RET_F), device=dev)
    poses = synthetic.loop_trajectory(RET_DB + RET_Q, radius=4.0,
                                      revisit_frames=RET_Q, seed=0)
    tex = synthetic.make_procedural_texture(seed=11)
    imgs = synthetic.render_textured_world(rig, poses, radius=10.0, tex=tex,
                                           seed=11)
    tex_neg = synthetic.make_procedural_texture(seed=77)
    imgs_neg = synthetic.render_textured_world(
        rig, poses[:RET_NEG], radius=10.0, tex=tex_neg, seed=77)
    harsh = dict(exposure_flicker=0.3, pixel_noise=0.025, motion_blur_px=3)
    allimgs = np.concatenate([
        synthetic.apply_photometric(imgs[:RET_DB], seed=1,
                                    exposure_flicker=0.15,
                                    pixel_noise=0.015),
        synthetic.apply_photometric(imgs[RET_DB:], seed=2, **harsh),
        synthetic.apply_photometric(imgs_neg, seed=3, **harsh)])[:, 0]
    B = 8  # extraction batch, as the JAX test
    descs, valids, xys = [], [], []
    for i in range(0, len(allimgs), B):
        batch = allimgs[i:i + B]
        batch = np.concatenate([batch, np.zeros(
            (B - len(batch), RET_H, RET_W), np.float32)])
        kp = orb.extract_orb_rig(torch.from_numpy(batch).to(dev),
                                 num_points=384, num_levels=3)
        n = min(B, len(allimgs) - i)
        descs += list(kp.desc[:n])
        valids += list(kp.valid[:n])
        xys += list(kp.xy[:n])
    train = np.concatenate([hamming.desc_to_numpy_u32(descs[i][valids[i]])
                            for i in range(0, RET_DB, 4)])
    vocab = vocab_mod.Vocabulary.train(train, k=6, depth=3, iters=4)
    bows = np.stack([vocab.transform(d, v).cpu().numpy()
                     for d, v in zip(descs, valids)])
    return rig, poses, vocab, bows, descs, valids, xys


def retrieval_gates(dev, corpus):
    """Phase 9 (d): tests/test_hard_synthetic.py's measurement with the
    port's LoopCloser.retrieve_topn (3 candidates) and its verification
    (the union of global and direct-index mutual matching, then the
    central essential RANSAC, 256 hypotheses, >= 20 matches and >= 25
    inliers; its RANSAC stream fixed per pair, as the test's key) ->
    (precision, recall, false fires, fires)."""
    import torch

    from mcslam_tpu_torch.frontend import ransac
    from mcslam_tpu_torch.loop.detector import LoopCloser, LoopConfig
    from mcslam_tpu_torch.ops import hamming, match as match_ops

    rig, poses, vocab, bows, descs, valids, xys = corpus
    nids = [vocab.node_ids(d, 2) for d in descs]
    c = torch.tensor([RET_W / 2, RET_H / 2], device=dev)

    def verified(qi, ri):
        dm = hamming.hamming_matrix(descs[qi], descs[ri])
        kw = dict(row_mask=valids[qi], col_mask=valids[ri], max_dist=64,
                  ratio=0.85)
        g = match_ops.match_mutual(dm, **kw)
        b = match_ops.match_mutual(
            dm, pair_mask=nids[qi][:, None] == nids[ri][None, :], **kw)
        ok = g.ok | b.ok
        idx = torch.where(g.ok, g.idx, b.idx).long()
        er = ransac.ransac_essential(
            torch.Generator(device=dev).manual_seed(0),
            (xys[qi] - c) / RET_F, (xys[ri][idx] - c) / RET_F, ok,
            num_hyp=256, thresh_n=2.0 / RET_F, min_inliers=25)
        n = torch.stack([ok.sum(), er.num_inliers.to(torch.int64)]).cpu()
        return int(n[0]) >= 20 and int(n[1]) >= 25

    cfg = LoopConfig(dislocal=0, min_nss=0.01, alpha=0.3, k_consistency=2)
    lc = LoopCloser(vocab, rig, cfg)
    for i in range(RET_DB):
        lc.add_keyframe(i, bows[i])
    fires = correct = 0
    for q in range(RET_Q):
        for r in lc.retrieve_topn(bows[RET_DB + q], 3):
            if verified(RET_DB + q, r):
                fires += 1
                d = np.linalg.norm(poses[r][:3, 3] - poses[RET_DB + q][:3, 3])
                correct += int(d < 1.0)
                break
    # the negatives: the same database, fresh temporal state
    lc_neg = LoopCloser(vocab, rig, cfg)
    lc_neg.bows, lc_neg.kf_ids = lc.bows[:RET_DB], lc.kf_ids[:RET_DB]
    false_fires = 0
    for q in range(RET_NEG):
        for r in lc_neg.retrieve_topn(bows[RET_DB + RET_Q + q], 3):
            if verified(RET_DB + RET_Q + q, r):
                false_fires += 1
                break
    precision = correct / max(fires + false_fires, 1)
    return precision, correct / RET_Q, false_fires, fires


def reloc_checks(dev, slam, vocab, rig, ffs, poses, tmp):
    """Phase 9 (e): save the drift run's map and BoW database under tmp;
    a Relocalizer of them relocalizes frame RELOC_FRAME, and a FastTracker
    refines frame RELOC_FRAME + 1 from that frame's keyframe pose moved by
    (0.05, -0.03, 0.04) m. Errors are taken against the saved map's own
    keyframe poses (the frame relocalization works in), and printed
    against the truth too -> (relocalizer, tracker, prediction,
    relocalize error m, fast-track error m)."""
    from mcslam_tpu_torch.loop.reloc import Relocalizer
    from mcslam_tpu_torch.loop.tracking import FastTracker
    from mcslam_tpu_torch.utils import mapio

    mapio.save_map_json(f"{tmp}/map.json", slam.keyframes, slam.map)
    slam.looper.save_database(f"{tmp}/db.npz")
    reloc = Relocalizer(vocab, rig, f"{tmp}/map.json", f"{tmp}/db.npz")
    k = RELOC_FRAME
    kf_pose = {round(kf.timestamp * 20): kf.world_T_ref
               for kf in slam.keyframes}
    check(k in kf_pose and k + 1 in kf_pose,
          f"frames {k} and {k + 1} are not both keyframes of the map")

    def truth(i):  # the session's world is its first keyframe's frame
        return np.linalg.inv(poses[0]) @ poses[i]

    pose = reloc.relocalize(ffs[k])
    check(pose is not None, f"relocalization of frame {k} failed")
    err_r = float(np.linalg.norm(pose[:3, 3] - kf_pose[k][:3, 3]))
    tracker = FastTracker(reloc)
    pred = kf_pose[k + 1].astype(np.float32).copy()
    pred[:3, 3] += np.array([0.05, -0.03, 0.04], np.float32)
    refined = tracker.track(ffs[k + 1], pred)
    check(refined is not None, f"fast tracking of frame {k + 1} failed")
    err_t = float(np.linalg.norm(refined[:3, 3] - kf_pose[k + 1][:3, 3]))
    print(f"# relocalization against the truth: frame {k} "
          f"{np.linalg.norm(pose[:3, 3] - truth(k)[:3, 3]):.4f} m, frame "
          f"{k + 1} fast-tracked "
          f"{np.linalg.norm(refined[:3, 3] - truth(k + 1)[:3, 3]):.4f} m "
          f"(the map's own keyframes are {np.linalg.norm(kf_pose[k][:3, 3] - truth(k)[:3, 3]):.4f}"
          f" / {np.linalg.norm(kf_pose[k + 1][:3, 3] - truth(k + 1)[:3, 3]):.4f}"
          f" m off the truth)")
    return reloc, tracker, pred, err_r, err_t


def loop_phase(dev):
    """Phase 9: (a) global_ba_phase; (b) loop_session; (c) drift_runs;
    (d) retrieval_corpus + retrieval_gates; (e) reloc_checks on (c)'s
    saved map. Each with the launch counters reset right before it and
    read right after. -> what phase 10 times."""
    import tempfile

    import torch

    from mcslam_tpu_torch.slam import INITIALIZED
    from mcslam_tpu_torch.utils import metrics

    # (a) the global solve (launches checked inside)
    gba_problems = global_ba_phase(dev)

    # (b) the full-width loop session
    main_path = ("fast_select", "patch_gather", *ORB_KERNELS,
                 "hamming_argmin2", "pose_lm", "ba_linearize", "ransac_score")
    (slam, poses, vocab, times), launches = counted(
        "the loop session", main_path, lambda: loop_session(dev))
    _, est = slam.trajectory_arrays()
    ate = metrics.ate_rmse(est, poses)
    st = slam.stats
    print(f"# loop session: {LOOP_FRAMES} frames, {C} cameras {W}x{H}, state "
          f"{slam.state}, keyframes {st['keyframes']}, failures "
          f"{st['failures']}, loops {st['loops']}, PGO bends "
          f"{st.get('pgo', 0)}, global BA {st.get('global_ba', 0)}, window "
          f"solves {st.get('window_ba', 0)}, ATE {ate:.4f} m (gate "
          f"{LOOP_MAX_ATE}); ba_linearize {launches.get('ba_linearize', 0)} "
          f"launches, pose_lm {launches.get('pose_lm', 0)}, pnp_hyp "
          f"{launches.get('pnp_hyp', 0)} (loop verifications and frames off "
          f"the fast path), ransac_score {launches.get('ransac_score', 0)}")
    for line in slam.timers.report().splitlines():
        print("#   " + line)
    check(slam.state == INITIALIZED and st["failures"] == 0,
          "loop session: not INITIALIZED at the end, or failures")
    check(st["loops"] >= 1, "loop session: no loop closed")
    check(st.get("global_ba", 0) >= 1, "loop session: no global BA")
    check(np.all(np.isfinite(est)) and est.shape == (LOOP_FRAMES, 4, 4),
          "loop session: trajectory malformed or non-finite")
    check(ate <= LOOP_MAX_ATE, f"loop session: ATE {ate:.4f} m > "
          f"{LOOP_MAX_ATE}")
    # the driver dispatches a deferred global solve with no host sync
    n_gba = st["global_ba"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        slam._run_global_ba()
        dispatch_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(slam._pending_gba is not None, "the global solve was not deferred")
    slam._finish_pending_gba()
    check(st["global_ba"] == n_gba + 1, "the deferred global solve did not "
          "land")
    print(f"# loop session: _run_global_ba dispatched its deferred solve "
          f"with no host sync in {dispatch_ms:.2f} ms (problem assembly, "
          f"upload and the queued solve), landed by _finish_pending_gba")

    # (c) the drift scene with and without loop closure
    (loop, vo, dposes, drig, dffs, dvocab, dwall), launches = counted(
        "the drift scene", ("hamming_argmin2", "pose_lm", "ba_linearize"),
        lambda: drift_runs(dev))
    ate_loop = metrics.ate_rmse(loop.trajectory_arrays()[1], dposes)
    ate_vo = metrics.ate_rmse(vo.trajectory_arrays()[1], dposes)
    print(f"# drift scene, {DRIFT_FRAMES} feature-level frames: with loop "
          f"closure loops {loop.stats['loops']}, PGO bends "
          f"{loop.stats.get('pgo', 0)}, global BA "
          f"{loop.stats.get('global_ba', 0)}, failures "
          f"{loop.stats['failures']}, ATE {ate_loop:.4f} m; VO only ATE "
          f"{ate_vo:.4f} m")
    check(loop.state == INITIALIZED and vo.state == INITIALIZED,
          "drift scene: a run is not INITIALIZED")
    check(loop.stats["loops"] >= 1 and loop.stats.get("pgo", 0) >= 1,
          "drift scene: no closure with a PGO bend")
    check(ate_loop < ate_vo, f"drift scene: loop ATE {ate_loop:.4f} m not "
          f"below the VO ATE {ate_vo:.4f} m")

    # (d) the retrieval corpus
    corpus, _ = counted("the retrieval corpus extraction",
                        ("fast_select", "patch_gather"),
                        lambda: retrieval_corpus(dev))
    precision, recall, false_fires, fires = retrieval_gates(dev, corpus)
    print(f"# retrieval corpus: {RET_DB} database entries, {RET_Q} revisit "
          f"queries, {RET_NEG} different-world negatives at {RET_W}x{RET_H}: "
          f"fires {fires}, precision {precision:.3f}, recall {recall:.3f}, "
          f"false fires {false_fires}")
    check(precision >= 0.95, f"retrieval: precision {precision:.3f} < 0.95")
    check(recall >= 0.85, f"retrieval: recall {recall:.3f} < 0.85")
    check(false_fires == 0, f"retrieval: {false_fires} false fires")

    # (e) relocalization and fast tracking against (c)'s saved map
    with tempfile.TemporaryDirectory() as tmp:
        (reloc, tracker, pred, err_r, err_t), _ = counted(
            "relocalization", ("hamming_argmin2", "pose_lm", "pnp_hyp",
                               "ransac_score"),
            lambda: reloc_checks(dev, loop, dvocab, drig, dffs, dposes, tmp))
    print(f"# relocalization against the saved drift-scene map: frame "
          f"{RELOC_FRAME} relocalized within {err_r:.4f} m of its keyframe "
          f"(gate 0.1), frame {RELOC_FRAME + 1} fast-tracked within "
          f"{err_t:.4f} m (gate 0.05)")
    check(err_r < 0.1, f"relocalization error {err_r:.4f} m >= 0.1")
    check(err_t < 0.05, f"fast-tracking error {err_t:.4f} m >= 0.05")
    return dict(gba=gba_problems, slam=slam, times=times, vocab=vocab,
                loop=loop, dwall=dwall, reloc=reloc, tracker=tracker,
                pred=pred, dffs=dffs)


def loop_timing(state, smi):
    """Phase 10: the loop path's times. Detection per keyframe (the loop
    session's loop_detect span; the BoW transform of one keyframe by CUDA
    events; retrieval and one verification by the host clock),
    _close_loop (its span),
    the global solve at both shapes (CUDA events, device time and device
    ops), relocalize and fast-track per frame (host clock, each ending in
    its host read)."""
    import copy

    import torch

    from mcslam_tpu_torch import _build
    from mcslam_tpu_torch.backend import ba

    slam, vocab = state["slam"], state["vocab"]
    tm = slam.timers
    for span in ("loop_detect", "close_loop"):
        n = tm.count.get(span, 0)
        if n:
            print(f"# loop session {span} span: mean "
                  f"{1e3 * tm.total[span] / n:.3f} ms over {n} calls "
                  f"(host clock, ending in its host reads) ({smi})")
    dl = state["loop"].timers
    if dl.count.get("close_loop", 0):
        print(f"# drift scene close_loop span: mean "
              f"{1e3 * dl.total['close_loop'] / dl.count['close_loop']:.3f} "
              f"ms over {dl.count['close_loop']} calls ({smi})")
    kf = slam.keyframes[-1]
    d, v = kf.device_desc()
    ms = cuda_ms(lambda: vocab.transform(d, v))
    print(f"# BoW transform of a keyframe ({int(v.sum())} of {v.shape[0]} "
          f"intra slots valid, {vocab.num_words} words): {ms:.3f} ms by CUDA "
          f"events ({smi})")
    bow = slam.looper.compute_bow(d, v)
    t0 = time.perf_counter()
    for _ in range(100):  # on shallow copies: retrieval reassigns its state
        copy.copy(slam.looper).retrieve_topn(bow, 3)
    print(f"# retrieval (nss gate, scores over {slam.looper._n_bows} "
          f"entries, islands, consistency) on the host: "
          f"{(time.perf_counter() - t0) / 100 * 1e3:.3f} ms ({smi})")
    old = slam.keyframes[0]
    before = collections.Counter(_build.LAUNCHES)
    t0 = time.perf_counter()
    for _ in range(3):
        det = slam.looper._verify(kf, old, slam.map)
    ms = (time.perf_counter() - t0) / 3 * 1e3
    per = {n: v / 3 for n, v in (_build.LAUNCHES - before).items()}
    print(f"# one verification (match, RANSAC-PnP, pose LM, host reads) of "
          f"the last keyframe against the first: {ms:.3f} ms, detected "
          f"{det.detected}; launches per verification {per} ({smi})")
    for name, p in state["gba"].items():
        def solve():
            return ba.ba_solve(p, iters=GBA_ITERS, kf_blocked=True)
        ms = cuda_ms(solve, reps=3, warmup=1)
        dev_ms, n_ops, _ = device_profile(solve)
        print(f"# time global ba_solve {name} ({GBA_ITERS} x 2): {ms:.3f} ms "
              f"by CUDA events; profiler: {dev_ms:.3f} ms device time in "
              f"{n_ops:.0f} device ops ({smi})")
    ffs, k = state["dffs"], RELOC_FRAME
    for name, fn in (("relocalize", lambda: state["reloc"].relocalize(
            ffs[k])), ("fast-track", lambda: state["tracker"].track(
                ffs[k + 1], state["pred"]))):
        fn()
        torch.cuda.synchronize()
        before = collections.Counter(_build.LAUNCHES)
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        ms = (time.perf_counter() - t0) / 5 * 1e3
        per = {n: v / 5 for n, v in (_build.LAUNCHES - before).items()}
        print(f"# {name} per frame: {ms:.3f} ms (host clock, ending in its "
              f"host reads); launches per frame {per} ({smi})")


def vio_timing(scene, problems, smi, graphed, eager_times):
    """Phase 8's visual-inertial rows: the stage D solve warm and cold,
    with and without GPS, eager and replayed through `graphed` (phase 14's
    slam, whose VIO programs these shapes hit) (CUDA events; device time
    and device ops from one profiled solve), and the per-frame
    process_image wall time of a VIO + GPS session, graphed (run here,
    untraced) and eager (phase 7 (b)'s records, `eager_times`), keyframe,
    other and capture frames apart, and the session's total."""
    from mcslam_tpu_torch.backend import ba_vio

    n_progs = len(vio_programs(graphed))
    for num_gps, p in problems.items():
        for name, iters in BA_ITERS:
            for how, solve in (
                    ("eager", lambda p=p, iters=iters: ba_vio.vio_solve(
                        p, iters=iters, kf_blocked=True)),
                    ("graphed", lambda p=p, iters=iters:
                     graphed._replay_vio_solve(p, iters))):
                ms = cuda_ms(solve, reps=5, warmup=1)
                dev_ms, n_ops, vf_ms = device_profile(
                    solve, names=("vio_factors_kernel",))
                # one ba_linearize and one vio_factors a linearization
                n_lin = 1 + 2 * iters
                _, got = traced_launches(solve, lambda _, n_lin=n_lin: {
                    n: n_lin if n in ("ba_linearize", "vio_factors") else 0
                    for n in PATH})
                print(f"# time vio_solve {name} ({iters} x 2), {num_gps} GPS "
                      f"factors, {how}: {ms:.3f} ms by CUDA events; "
                      f"profiler: {dev_ms:.3f} ms device time in {n_ops:.0f} "
                      f"device ops, vio_factors {got['vio_factors']} launches "
                      f"in the trace ({vf_ms:.4f} ms of device time), "
                      f"ba_linearize {got['ba_linearize']} ({smi})")
    check(len(vio_programs(graphed)) == n_progs,
          "phase 8's stage D problems captured new VIO programs")
    _, _, times, init_at = vio_session(scene)
    for how, times in (("graphed", times), ("eager", eager_times)):
        for name, sel in (
                ("keyframe frames", [k for k, (_, kf, cap) in
                                     enumerate(times) if kf and not cap]),
                ("other tracked frames", [
                    k for k, (_, kf, cap) in enumerate(times)
                    if k > init_at and not (kf or cap)]),
                ("capture frames", [k for k, (_, _, cap) in
                                    enumerate(times) if cap])):
            ms = [times[k][0] * 1e3 for k in sel]
            if not ms:
                continue
            lim = LIMIT_MS.get("other frames" if name == "other tracked "
                               "frames" else name)
            print(f"# VIO + GPS session ({how}), per-frame process_image "
                  f"wall, {name} (n={len(ms)}): mean {np.mean(ms):.3f} ms, "
                  f"median {np.median(ms):.3f} ms, max {np.max(ms):.3f} ms"
                  + (f" (PERF.md §2 limit {lim:.0f} ms)" if lim else "")
                  + f" ({smi})")
        print(f"# VIO + GPS session ({how}): {len(times)} frames in "
              f"{sum(t for t, _, _ in times) * 1e3:.3f} ms of process_image "
              f"wall in all, captures included ({smi})")


def time_kernel(n, k, smi):
    """Phase 8 for one kernel record: replaces its callables and counts in
    k by the times and the bound, and prints them."""
    fn, plain = k.pop("fn"), k.pop("plain")
    library = k.pop("library", None)
    also = k.pop("also", {})
    names = k.pop("symbols")
    k["bound_ms"], k["bound_by"] = bound(k.pop("nbytes"), k.pop("ops_s"))
    k["ms"] = cuda_ms(fn)
    k["plain_ms"] = cuda_ms(plain, reps=5, warmup=1)
    k["library_ms"] = cuda_ms(library) if library is not None else None
    for key, f in also.items():
        k[key] = cuda_ms(f, reps=5, warmup=1)
    want_ops = k.pop("device_ops", None)
    wrap_ms, n_ops, kern_ms = device_profile(fn, reps=10, names=names)
    k["device_ms"] = kern_ms
    check(want_ops is None or n_ops == want_ops,
          f"{n}: the wrapper's call is {n_ops} device ops, not {want_ops}")
    lib = (f", library call {k['library_ms']:.4f} ms"
           if library is not None else "")
    lib += "".join(f", {key} {k[key]:.4f}" for key in also)
    print(f"# time {n}: wrapper {k['ms']:.4f} ms, plain "
          f"{k['plain_ms']:.4f} ms{lib} by CUDA events; profiler: the "
          f"kernel {kern_ms:.4f} ms of device time, the wrapper's call "
          f"{wrap_ms:.4f} ms in {n_ops:.1f} device ops; bound "
          f"{k['bound_ms']:.4f} ms ({k['bound_by']}) ({smi})")


def dump_graph(slam, path):
    """The session's end-of-run x / l / e graph-log records (as the app
    writes them: one edge per keyframe landmark, its anchor camera) after
    the records streamed during the run; closes the writer."""
    log = slam.graph_log
    for kf in slam.keyframes:
        log.pose(kf.kf_id, kf.world_T_ref, kf.timestamp)
        for m in np.nonzero(kf.lm_id >= 0)[0]:
            log.edge(kf.kf_id, int(kf.im_anchor_cam[m]), int(kf.lm_id[m]),
                     float(kf.im_uv[m, 0]), float(kf.im_uv[m, 1]))
    for lid in np.nonzero(slam.map.valid)[0]:
        log.landmark(int(lid), slam.map.pos[lid])
    log.close()


def main_path_session(scene, log_path=None):
    """Phase 5's session through process_image, which replays CUDA graphs
    on the card: their launches no wrapper sees, so the session runs
    under a device trace with the launch counters reset right before it,
    and the kernels of PATH that ran on the device are counted there and
    held to those of an eager session (cuda_graphs=False, the reference,
    run first, its host syncs counted for phase 14) plus the graphs'
    warm-ups' -> (slam, the wrappers' launches (the warm-ups' and the
    eager frames'), the traced launches, (the eager slam, its frame
    records, its launches))."""
    from mcslam_tpu_torch import _build

    _build.LAUNCHES.clear()
    slam_e, recs_e = graph_session(scene, cuda_graphs=False, syncs=True)
    launches_e = {n: _build.LAUNCHES.get(n, 0) for n in PATH}
    print(f"# launches during the eager reference session (cuda_graphs="
          f"False): {launches_e}")

    def session():
        _build.LAUNCHES.clear()
        slam, _ = run_session(scene, log_path=log_path)
        return slam, dict(_build.LAUNCHES)

    def expect(out):
        warm = graph_warmups(out[0])
        return {n: launches_e[n] + warm.get(n, 0) for n in PATH}

    (slam, wrapper), launches = traced_launches(session, expect)
    return slam, wrapper, launches, (slam_e, recs_e, launches_e)


def run_session(scene, frames=SESSION_FRAMES, route=None, mesh=None,
                log_path=None):
    """The first `frames` frames through the driver's entry point, on the
    rig's device (the window and global solves over `mesh` if given) ->
    (slam, [(wall seconds, keyframe?) per frame]); finalize()d. With
    log_path, the session's graph log is written there."""
    from mcslam_tpu_torch.slam import MultiCameraSLAM, SlamConfig
    from mcslam_tpu_torch.utils import mapio

    slam = MultiCameraSLAM(scene.rig, SlamConfig(), mesh=mesh)
    if log_path is not None:
        slam.attach_graph_log(mapio.GraphLogWriter(log_path))
    times = []
    for k in range(frames):
        t0 = time.perf_counter()
        info = slam.process_image(scene.imgs[k], k / 20.0,
                                  extract_cfg=scene.frame_kwargs(route))
        times.append((time.perf_counter() - t0, info["keyframe"]))
    slam.finalize()
    if log_path is not None:
        dump_graph(slam, log_path)
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
        ref = ba.ba_solve(p_cpu, iters=iters, gate_rounds=2,
                          kf_blocked=True)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            res = ba.ba_solve(p_dev, iters=iters, gate_rounds=2,
                              kf_blocked=True)
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


SENTINELS = 64  # spin kernels that open every device trace (device_events)
SENTINEL = "spin_kernel"


def device_events(run):
    """run() under a torch.profiler CPU + CUDA trace -> (run's result, the
    trace's device-side events less the sentinels, whether it kept one of
    the sentinels). The CUDA trace loses events, the first ones of a
    trace most often, and more of them the more large traces the process
    took before (on an NVIDIA H100 under torch 2.11, after phase 14's
    traces, phase 8's trace of ten fast_select calls kept four in five
    tries): SENTINELS spin kernels open each trace, run() after they
    finish, so that such losses fall on them. Callers take again a trace
    that kept none of them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(SENTINELS):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        out = run()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kept = [e for e in evs if SENTINEL in e.name]
    return out, [e for e in evs if SENTINEL not in e.name], bool(kept)


def device_profile(fn, reps=1, names=()):
    """(device ms, device ops, device ms of the kernels named) per fn()
    call, over `reps` calls, from a torch.profiler CUDA trace: the summed
    duration and count of the device-side events, and the summed duration
    of those whose name contains one of `names`. A trace that caught no
    device-side event, or none of the kernels named (the CUDA trace now
    and then comes back empty), or that lost some of them (it kept none
    of its sentinels, or the count of device-side events, or of the
    kernels named, is not a whole number per call), is taken again, up
    to five times; then the run fails rather than report a time or a
    count it did not measure."""
    def run():
        for _ in range(reps):
            fn()

    for _ in range(5):
        _, evs, kept = device_events(run)
        named = [e for e in evs if any(n in e.name for n in names)]
        us = sum(e.time_range.elapsed_us() for e in evs)
        named_us = sum(e.time_range.elapsed_us() for e in named)
        whole = kept and len(evs) % reps == 0 and len(named) % reps == 0
        if us > 0 and (named_us > 0 or not names) and whole:
            break
    check(us > 0, "the profiler caught no device-side event in five traces")
    check(named_us > 0 or not names,
          f"the profiler caught no launch of {names} in five traces")
    check(whole, f"the profiler caught {len(evs)} device-side events, "
          f"{len(named)} of {names}, for {reps} calls (sentinels kept: "
          f"{kept}) in each of five traces")
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


SESSION_GAP = 0.005  # m, tests/test_torch_kernels.py's card-vs-CPU bound


def session_gap_phase(dev, smi):
    """Phase 2's session check: tests/test_torch_kernels.py::
    test_session_on_cuda_matches_cpu's scene (3 cameras, 320x240, one
    pyramid level, 8 frames) through MultiCameraSLAM.process_image on the
    card (the kernels) and on the CPU (the plain versions): both
    initialized without failures, keyframes within one; the position gap
    per frame printed against SESSION_GAP (the gpu test's bound, which
    the session does not hold yet: the pose LM kernel sums in its cluster
    order, the CPU's plain version in torch.sum's, and frame 7 of the
    scene is a near tie; ROADMAP.md Queue 3)."""
    from mcslam_tpu_torch.data import synthetic
    from mcslam_tpu_torch.slam import INITIALIZED, MultiCameraSLAM, SlamConfig

    rig = synthetic.make_synthetic_rig(synthetic.SyntheticRigSpec(
        num_cams=3, baseline=0.2, image_size=(320, 240), focal=260.0),
        device="cpu")
    poses = synthetic.smooth_trajectory(8, radius=5.0, step_angle=0.03)
    imgs = synthetic.render_blob_images(rig, poses, synthetic.make_landmarks(
        700, seed=1, depth_range=(4.0, 12.0)), seed=2)
    cfg = SlamConfig(window_size=4, ba_obs_capacity=8192, ba_lm_capacity=1024,
                     local_map_landmarks=1024, kf_translation=0.2,
                     kf_rotation=0.1, min_inter_matches=40)
    runs = []
    for d in ("cpu", dev):
        slam = MultiCameraSLAM(rig, cfg, device=d)
        pos = []
        for k in range(len(poses)):
            slam.process_image(imgs[k], k / 20.0, extract_cfg=dict(
                num_points=512, num_levels=1, max_intra=768))
            pos.append(slam.trajectory_arrays()[1][-1][:3, 3].copy())
        check(slam.state == INITIALIZED and slam.stats["failures"] == 0,
              f"session-gap scene on {d}: not initialized or failures")
        runs.append((np.array(pos), slam.stats["keyframes"]))
    gap = np.linalg.norm(runs[1][0] - runs[0][0], axis=-1)
    print(f"# session-gap scene (3 cameras, 320x240, 1 level, 8 frames), "
          f"card vs CPU: keyframes {runs[1][1]} / {runs[0][1]}; position gap "
          f"per frame (m) {', '.join(f'{g:.3g}' for g in gap)}; max "
          f"{gap.max():.3g}, {'within' if gap.max() <= SESSION_GAP else 'over'} "
          f"the test's {SESSION_GAP} ({smi})")
    check(abs(runs[1][1] - runs[0][1]) <= 1,
          f"session-gap scene: keyframes {runs[1][1]} on the card, "
          f"{runs[0][1]} on the CPU")


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


# -- phase 11: the app and data path -----------------------------------------

def write_pgm(path, img: np.ndarray) -> None:
    """(H, W) uint8 -> binary 8-bit PGM."""
    h, w = img.shape
    path.write_bytes(b"P5\n%d %d\n255\n" % (w, h)
                     + np.ascontiguousarray(img, np.uint8).tobytes())


def frames_u8(imgs) -> np.ndarray:
    """(C, H, W) float images in [0, 1] (tensors or numpy) per frame ->
    (F, C, H, W) uint8, as an 8-bit camera delivers them."""
    return np.stack([(np.clip(np.asarray(
        x.cpu() if hasattr(x, "cpu") else x), 0.0, 1.0) * 255).astype(
            np.uint8) for x in imgs])


def stamp_ns(k: int) -> int:
    """Frame k's EuRoC-style 19-digit nanosecond stamp (APP_FPS)."""
    return 10**18 + int(k / APP_FPS * 1e9)


def _yaml_rows(T) -> str:
    return ", ".join("[" + ", ".join(f"{v:.9f}" for v in r) + "]" for r in T)


def write_app_dataset(root, rig, u8, device):
    """Phase 11 (a)'s inputs under `root`: images/cam<c>/data/<ns>.pgm, a
    Kalibr camchain of `rig` (the T_cn_cnm1 chain), frontend / backend
    YAML with bench.py's ORBextractor.nFeatures / nLevels, a vocabulary
    trained on the first APP_VOCAB frames' descriptors (as phase 9 trains
    one) and the cfgs: app.cfg (calc_depth, dense cloud, map, database,
    graph log; outputs in out/), profiled.cfg (the same, outputs in
    out_profiled/) and reuse.cfg (relocalization and fast tracking on
    out/'s map and database) -> {cfg name: path}."""
    import torch

    from mcslam_tpu_torch.frontend import frame
    from mcslam_tpu_torch.loop import vocab as vocab_mod
    from mcslam_tpu_torch.ops import hamming

    F_, C_ = u8.shape[:2]
    for c in range(C_):
        d = root / "images" / f"cam{c}" / "data"
        d.mkdir(parents=True)
        for k in range(F_):
            write_pgm(d / f"{stamp_ns(k)}.pgm", u8[k, c])
    fx = rig.fxycxy.cpu().numpy()
    cam_T_ref = rig.cam_T_ref.cpu().numpy().astype(np.float64)
    w, h = rig.image_size
    lines = []
    for c in range(C_):
        lines += [f"cam{c}:",
                  f"  intrinsics: [{', '.join(f'{v:.6f}' for v in fx[c])}]",
                  "  distortion_coeffs: [0.0, 0.0, 0.0, 0.0]",
                  "  distortion_model: none",
                  f"  resolution: [{w}, {h}]"]
        if c:
            T = cam_T_ref[c] @ np.linalg.inv(cam_T_ref[c - 1])
            lines.append("  T_cn_cnm1:")
            lines += ["    - [" + ", ".join(f"{v:.9f}" for v in r) + "]"
                      for r in T]
    (root / "camchain.yaml").write_text("\n".join(lines) + "\n")
    (root / "frontend.yaml").write_text(
        f"%YAML:1.0\n---\nORBextractor.nFeatures: {NPTS}\n"
        f"ORBextractor.nLevels: {NLVL}\n")
    (root / "backend.yaml").write_text("%YAML:1.0\n---\nWindowBad: 6\n")
    ecfg = dict(num_points=NPTS, num_levels=NLVL)
    train = []
    for k in range(APP_VOCAB):
        x = torch.from_numpy(u8[k]).to(device).float() / 255.0
        ff = frame.build_frame(x, rig, **ecfg)
        train.append(hamming.desc_to_numpy_u32(ff.kp_desc[ff.kp_valid]))
    vocab_mod.Vocabulary.train(np.concatenate(train), k=6, depth=3,
                               iters=4).save(root / "vocab.npz")
    head = (f"data_path={root}\nimages_path=images\n"
            "calib_file_path=camchain.yaml\n"
            "frontend_params_file=frontend.yaml\n"
            "backend_params_file=backend.yaml\nkalibr=true\n"
            f"num_cams={C_}\nvocabulary=vocab.npz\n")
    cfgs = {}
    for name, out in (("app", "out"), ("profiled", "out_profiled")):
        (root / out).mkdir()
        cfgs[name] = root / f"{name}.cfg"
        cfgs[name].write_text(
            head + f"traj_file={out}/traj.txt\nmap_path={out}/map.json\n"
            f"database_path={out}/db.npz\nlog_file={out}/graph.log\n"
            f"calc_depth=true\ndepth_dir={out}/depth\n"
            f"dense_cloud_path={root / out}/cloud.ply\n")
    cfgs["reuse"] = root / "reuse.cfg"
    cfgs["reuse"].write_text(
        head + "traj_file=out/traj_reuse.txt\nmap_path=out/map.json\n"
        "database_path=out/db.npz\nrelocalization=true\nfast_tracking=true\n")
    return cfgs


def write_euroc_sequence(root, rig, u8, poses):
    """Phase 11 (b)'s sequence in EuRoC's ASL layout under root/mav0:
    cam<c>/sensor.yaml (T_BS = inv(cam_T_ref): body = camera 0) with
    cam<c>/data/<ns>.pgm, and state_groundtruth_estimate0/data.csv (the
    true poses, quaternion w x y z)."""
    import torch

    from mcslam_tpu_torch.geometry import lie

    mav0 = root / "mav0"
    fx = rig.fxycxy.cpu().numpy()
    cam_T_ref = rig.cam_T_ref.cpu().numpy().astype(np.float64)
    w, h = rig.image_size
    for c in range(u8.shape[1]):
        d = mav0 / f"cam{c}" / "data"
        d.mkdir(parents=True)
        for k in range(u8.shape[0]):
            write_pgm(d / f"{stamp_ns(k)}.pgm", u8[k, c])
        (mav0 / f"cam{c}" / "sensor.yaml").write_text(
            "sensor_type: camera\nT_BS:\n  rows: 4\n  cols: 4\n"
            f"  data: [{_yaml_rows(np.linalg.inv(cam_T_ref[c]))}]\n"
            f"rate_hz: {APP_FPS:g}\nresolution: [{w}, {h}]\n"
            "camera_model: pinhole\n"
            f"intrinsics: [{', '.join(f'{v:.6f}' for v in fx[c])}]\n"
            "distortion_model: radial-tangential\n"
            "distortion_coefficients: [0.0, 0.0, 0.0, 0.0]\n")
    q = lie.quat_from_rot(torch.as_tensor(poses[:, :3, :3])).numpy()
    gt = mav0 / "state_groundtruth_estimate0"
    gt.mkdir()
    rows = ["#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z"]
    for k in range(len(poses)):
        p = poses[k, :3, 3]
        rows.append(f"{stamp_ns(k)},{p[0]:.9f},{p[1]:.9f},{p[2]:.9f},"
                    f"{q[k, 3]:.9f},{q[k, 0]:.9f},{q[k, 1]:.9f},"
                    f"{q[k, 2]:.9f}")
    (gt / "data.csv").write_text("\n".join(rows) + "\n")
    return root


def device_args(device) -> list:
    """The apps' arguments for `device`: none for the card, which is
    their default (so phase 11 runs them as a user would)."""
    return [] if device == "cuda" else ["--device", device]


def app_run(cfg, device, *extra):
    """mc_slam_app.main on `cfg` -> (rc, wall s of the call, [(host s at
    the end of each frame, keyframe?)]): each frame's stamp is taken after
    its dense products, behind a synchronize of the current stream (a
    deferred window solve on the side stream may still overlap the next
    frame, as in phase 5's per-frame times)."""
    import torch

    from mcslam_tpu_torch.apps import mc_slam_app

    stamps = []
    post = mc_slam_app._postprocess_frame

    def timed(info, *a):
        post(info, *a)
        if device == "cuda":
            torch.cuda.current_stream().synchronize()
        stamps.append((time.perf_counter(), bool(info.get("keyframe"))))

    mc_slam_app._postprocess_frame = timed
    try:
        t0 = time.perf_counter()
        rc = mc_slam_app.main(["--config_file", str(cfg), *extra]
                              + device_args(device))
        wall = time.perf_counter() - t0
    finally:
        mc_slam_app._postprocess_frame = post
    return rc, wall, stamps


def app_sessions(root, rig, u8, poses, device, count, max_ate):
    """Phase 11 (a) and (b) on `device` under `root`: the app on the
    dataset (gates: rc 0, one TUM row per frame, >= MIN_KEYFRAMES
    keyframes, ATE <= max_ate, a finite depth map per keyframe that
    tracking inserted, a non-empty cloud, map and database written), the
    map-reuse run of its first REUSE_FRAMES frames (rc 0, a row per frame,
    ATE <= REUSE_MAX_ATE) and the EuRoC runner on the same drive in ASL
    layout (rc 0, every frame associated, ATE <= max_ate); `count(name,
    expect, fn)` runs each part (with the launch counters on the card).
    -> the numbers phase 11's timing and the rehearsal read."""
    import json

    from mcslam_tpu_torch.apps import run_euroc
    from mcslam_tpu_torch.utils import metrics, tum

    main_path = ("fast_select", "patch_gather", *ORB_KERNELS,
                 "hamming_argmin2", "pose_lm", "ba_linearize", "ransac_score")
    cfgs = write_app_dataset(root, rig, u8, device)
    # the dense cloud's DenseFuser aggregates by SGM on every keyframe
    (rc, wall, stamps), launches = count(
        "the app", main_path + ("sgm_scan",),
        lambda: app_run(cfgs["app"], device))
    out = root / "out"
    ts, est = tum.read_tum(out / "traj.txt")
    ate = metrics.ate_rmse(est, poses)
    kfs = json.loads((out / "map.json").read_text())["keyframes"]
    depth = sorted((out / "depth").glob("depth_*.npy"))
    finite = all(np.isfinite(np.load(p)).all() for p in depth)
    n_cloud = int((out / "cloud.ply").read_text().split(
        "element vertex ")[1].split()[0])
    print(f"# app on {device}: rc {rc}, {len(ts)} frames, {len(kfs)} "
          f"keyframes, ATE {ate:.4f} m (gate {max_ate}), {len(depth)} depth "
          f"maps (finite {finite}), dense cloud {n_cloud} voxels; map "
          f"{(out / 'map.json').exists()}, database "
          f"{(out / 'db.npz').exists()}")
    check(rc == 0, f"app: rc {rc}")
    check(len(ts) == len(poses) and np.isfinite(est).all(),
          f"app: {len(ts)} trajectory rows for {len(poses)} frames")
    check(len(kfs) >= MIN_KEYFRAMES, f"app: {len(kfs)} keyframes")
    check(ate <= max_ate, f"app: ATE {ate:.4f} m > {max_ate}")
    check(len(depth) == sum(kf for _, kf in stamps) >= MIN_KEYFRAMES - 1
          and finite, f"app: {len(depth)} depth maps for "
          f"{sum(kf for _, kf in stamps)} tracked keyframes (finite {finite})")
    check(n_cloud > 0, "app: empty dense cloud")
    check((out / "db.npz").exists(), "app: no database written")

    (rc_r, _, _), _ = count(
        "the map-reuse app run", ("hamming_argmin2", "pose_lm"),
        lambda: app_run(cfgs["reuse"], device, "--max_frames",
                        str(REUSE_FRAMES)))
    ts_r, est_r = tum.read_tum(out / "traj_reuse.txt")
    ate_r = metrics.ate_rmse(est_r, poses[:REUSE_FRAMES])
    print(f"# map-reuse app run (relocalization, fast tracking) on {device}: "
          f"rc {rc_r}, {len(ts_r)} frames, ATE {ate_r:.4f} m (gate "
          f"{REUSE_MAX_ATE})")
    check(rc_r == 0 and len(ts_r) == REUSE_FRAMES,
          f"map-reuse run: rc {rc_r}, {len(ts_r)} rows")
    check(ate_r <= REUSE_MAX_ATE, f"map-reuse run: ATE {ate_r:.4f} m")

    seq = write_euroc_sequence(root / "euroc", rig, u8, poses)
    rc_e, _ = count("the EuRoC runner", main_path, lambda: run_euroc.main([
        str(seq), "--out_dir", str(root / "euroc_out"), "--num_points",
        str(NPTS), "--num_levels", str(NLVL)] + device_args(device)))
    ts_e, est_e = tum.read_tum(root / "euroc_out" / "trajectory_tum.txt")
    ts_g, gt = tum.read_tum(root / "euroc_out" / "groundtruth_tum.txt")
    ie, ig = metrics.associate(ts_e, ts_g, 0.02)
    ate_e = metrics.ate_rmse(est_e[ie], gt[ig])
    print(f"# EuRoC runner on {device}: rc {rc_e}, {len(ie)} of {len(ts_e)} "
          f"frames associated with {len(ts_g)} ground-truth rows, ATE "
          f"{ate_e:.4f} m (gate {max_ate})")
    check(rc_e == 0 and len(ie) == len(ts_e) == len(poses),
          f"EuRoC runner: rc {rc_e}, {len(ie)} associated")
    check(ate_e <= max_ate, f"EuRoC runner: ATE {ate_e:.4f} m > {max_ate}")
    return dict(cfgs=cfgs, wall=wall, stamps=stamps, ate=ate, est=est,
                ate_r=ate_r, ate_e=ate_e, launches=launches)


def yawed_pair(rig, deg=STEREO_YAW):
    """Cameras 0 and 1 of `rig` (on the CPU) with camera 1 yawed by `deg`
    degrees about its own y axis."""
    from mcslam_tpu_torch.geometry import camera

    a = np.radians(deg)
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]], np.float32)
    cam_T_ref = rig.cam_T_ref[:2].cpu().numpy().copy()
    cam_T_ref[1, :3] = R.T @ cam_T_ref[1, :3]
    return camera.make_rig(rig.fxycxy[:2].cpu().numpy(), None, cam_T_ref,
                           image_size=rig.image_size, device="cpu")


def stereo_winners(imgs, rig, algo):
    """The integer disparity winners of depth_from_rig_pair's search on
    cameras 0 and 1 (rectified first where the pair is not parallel)."""
    from mcslam_tpu_torch.ops import rectify, stereo

    rr = rectify.RigRectifier(rig)
    la, lb = ((imgs[0], imgs[1]) if rr.is_identity
              else (rr.rectify(imgs[0]), rr.rectify_b(imgs[1])))
    cv = stereo.cost_volume(la, lb, STEREO_D)
    if algo == "sgm":
        cv = stereo.sgm_aggregate(cv)
    return cv.argmin(dim=0)


def stereo_phase(scene, dev, smi):
    """Phase 11 (c): depth_from_rig_pair, box and SGM at VGA with D =
    STEREO_D, on the bench pair (cameras 0 and 1: parallel, no remap)
    and on yawed_pair (the remap path), card against CPU: equal integer
    winners on >= STEREO_SHARE of the pixels, depth within STEREO_REL
    relative where they agree; then each call's time (CUDA events; device
    ms and device ops from the profiler) and the host time of the
    rectifier rebuild that every call without a cached rectifier pays;
    then DenseFuser.add_keyframe on FUSE_KFS keyframes."""
    import torch

    from mcslam_tpu_torch import _build
    from mcslam_tpu_torch.data import synthetic
    from mcslam_tpu_torch.mapping.dense_fusion import DenseFuser
    from mcslam_tpu_torch.ops import rectify, stereo

    yaw = yawed_pair(scene.rig)
    yaw_imgs = synthetic.render_blob_images(yaw, scene.poses[:1],
                                            scene.lms)[0]
    pairs = {"bench pair": (scene.rig, scene.imgs[0]),
             f"pair yawed {STEREO_YAW:g} deg": (
                 yaw.to(dev), torch.from_numpy(yaw_imgs).to(dev))}
    for name, (rig, imgs) in pairs.items():
        rig_c, imgs_c = rig.to("cpu"), imgs.cpu()
        rr = rectify.RigRectifier(rig)
        check(rr.is_identity == (name == "bench pair"),
              f"{name}: is_identity {rr.is_identity}")
        for algo in ("box", "sgm"):
            before = _build.LAUNCHES["sgm_scan"]
            z, v = stereo.depth_from_rig_pair(imgs, rig, max_disp=STEREO_D,
                                              algo=algo)
            n_sgm = _build.LAUNCHES["sgm_scan"] - before
            check(n_sgm == (algo == "sgm"), f"{name} {algo}: sgm_scan "
                  f"launched {n_sgm} times in one call")
            z_c, v_c = stereo.depth_from_rig_pair(imgs_c, rig_c,
                                                  max_disp=STEREO_D,
                                                  algo=algo)
            same = (stereo_winners(imgs, rig, algo).cpu()
                    == stereo_winners(imgs_c, rig_c, algo))
            share = float(same.float().mean())
            rel = ((z.cpu() - z_c).abs() / z_c)[same]
            rel_max = float(rel.max())
            v_same = float((v.cpu() == v_c)[same].float().mean())
            print(f"# depth_from_rig_pair {algo}, {name}, {W}x{H} D="
                  f"{STEREO_D}: card vs CPU equal winners {100 * share:.3f} "
                  f"%, depth where they agree max rel err {rel_max:.3g}, "
                  f"valid masks equal there on {100 * v_same:.3f} %, valid "
                  f"{100 * float(v.float().mean()):.1f} % (card); sgm_scan "
                  f"launches in the card's call: {n_sgm}")
            check(bool(torch.isfinite(z).all()), f"{name} {algo}: non-finite")
            check(share >= STEREO_SHARE,
                  f"{name} {algo}: equal winners {share:.4f}")
            check(rel_max <= STEREO_REL,
                  f"{name} {algo}: depth rel err {rel_max:.3g}")

            def call():
                return stereo.depth_from_rig_pair(imgs, rig,
                                                  max_disp=STEREO_D,
                                                  algo=algo)
            ms = cuda_ms(call, reps=3, warmup=1)
            dev_ms, n_ops, _ = device_profile(call)
            print(f"# time depth_from_rig_pair {algo}, {name}: {ms:.3f} ms "
                  f"by CUDA events; profiler: {dev_ms:.3f} ms device time in "
                  f"{n_ops:.0f} device ops ({smi})")
        t0 = time.perf_counter()
        for _ in range(3):
            rectify.RigRectifier(rig)
        print(f"# RigRectifier rebuild ({name}; maps on the host, then "
              f"uploaded): {(time.perf_counter() - t0) / 3 * 1e3:.3f} ms "
              f"host clock ({smi})")
    fuser = DenseFuser(scene.rig, max_disp=STEREO_D)
    times, voxels = [], []
    before = _build.LAUNCHES["sgm_scan"]
    for k in FUSE_KFS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        voxels.append(fuser.add_keyframe(scene.imgs[k], scene.poses[k]))
        times.append(time.perf_counter() - t0)
    n_sgm = _build.LAUNCHES["sgm_scan"] - before
    pts, _, cnt = fuser.finalize()
    print(f"# DenseFuser.add_keyframe (sgm, D={STEREO_D}) on frames "
          f"{FUSE_KFS}: {[round(t * 1e3, 3) for t in times]} ms (host clock, "
          f"ending in its host reads), voxels {voxels}, fused "
          f"{len(pts)} ({int((cnt > 1).sum())} seen twice or more); sgm_scan "
          f"launches {n_sgm} ({smi})")
    check(n_sgm == len(FUSE_KFS), f"DenseFuser: sgm_scan launched {n_sgm} "
          f"times for {len(FUSE_KFS)} keyframes")
    check(min(voxels) > 0 and np.isfinite(pts).all(),
          "DenseFuser: a keyframe contributed nothing, or non-finite points")


def app_phase(scene, dev, smi):
    """Phase 11: app_sessions on the card (with the launch counters), the
    reader's decode time, the app's per-frame wall time and the session's
    device busy share, then stereo_phase."""
    import tempfile
    from pathlib import Path

    from mcslam_tpu_torch.data import readers

    u8 = frames_u8(scene.imgs[:APP_FRAMES])
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        res = app_sessions(root, scene.rig, u8, scene.poses[:APP_FRAMES],
                           "cuda", counted, APP_MAX_ATE)
        reader = readers.ImageFolderReader(root / "images")
        dt = []
        while True:
            t0 = time.perf_counter()
            if reader.get_next() is None:
                break
            dt.append(time.perf_counter() - t0)
        print(f"# reader decode ({len(reader.cam_dirs)} PGM images of "
              f"{W}x{H} per frame, host): median {np.median(dt) * 1e3:.3f} "
              f"ms per frame over {len(dt)} frames ({smi})")
        for name, ms in frame_walls(res["stamps"]).items():
            print(f"# app per-frame wall (read, upload, process_image, depth "
                  f"map and fusion on keyframes), {name} (n={len(ms)}): "
                  f"median {np.median(ms):.3f} ms, mean {np.mean(ms):.3f} "
                  f"ms ({smi})")
        dev_ms, n_ops, _ = device_profile(
            lambda: app_run(res["cfgs"]["profiled"], "cuda"))
        wall_ms = res["wall"] * 1e3
        print(f"# app session of {APP_FRAMES} frames: {wall_ms:.1f} ms wall "
              f"(setup and outputs included); a profiled repeat: "
              f"{dev_ms:.1f} ms device time in {n_ops:.0f} device ops, "
              f"device busy {100 * dev_ms / wall_ms:.1f} % of the unprofiled "
              f"wall time ({smi})")
    stereo_phase(scene, dev, smi)
    return dict(est=res["est"], per_frame=frame_walls(res["stamps"]),
                busy=dev_ms / wall_ms, launches=res["launches"])


def frame_walls(stamps) -> dict:
    """app_run's frame stamps -> {"keyframe frames": [ms], "other
    frames": [ms]} (the first frame has no predecessor)."""
    per = [(stamps[k][0] - stamps[k - 1][0], stamps[k][1])
           for k in range(1, len(stamps))]
    return {name: [t * 1e3 for t, kf in per if kf == sel]
            for name, sel in (("keyframe frames", True),
                              ("other frames", False))}


def _same(a, b) -> bool:
    """Every tensor field of two results (or frames) equal, bit for bit."""
    import torch

    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


def _card_time(fn, dev, smi, what, reps=5):
    """Print fn()'s time by CUDA events and its device time and ops by the
    profiler (on the card only) -> (ms, device ms, device ops)."""
    if dev.type != "cuda":
        return None
    ms = cuda_ms(fn, reps=reps, warmup=1)
    dev_ms, n_ops, _ = device_profile(fn)
    print(f"# time {what}: {ms:.3f} ms by CUDA events; profiler: "
          f"{dev_ms:.3f} ms device time in {n_ops:.0f} device ops ({smi})")
    return ms, dev_ms, n_ops


def _peak_gib(fn, dev):
    """Peak device memory of fn() above what was held before, GiB (the
    card only)."""
    import torch

    if dev.type != "cuda":
        return float("nan")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    out = fn()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
    del out
    return peak


def _queued(dev) -> str:
    """How phase 12 describes a solve it ran under _no_sync."""
    return ("queued with no host sync" if dev.type == "cuda"
            else "on the CPU")


def _no_sync(fn, dev):
    """fn() with host syncs turned into errors on the card."""
    import torch

    if dev.type != "cuda":
        return fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def generic_phase(p_dev, dev, smi):
    """Phase 12 (a): ba_solve's generic layout (the default,
    kf_blocked=False) on the stage C problem, warm and cold, on the card
    under sync-debug "error", twice (bit-equal), against the generic solve
    on the CPU and the card's kf-blocked solve (poses within
    MESH_TOL["generic"]); its time, device time, ops and peak memory
    beside the kf-blocked solve's."""
    from mcslam_tpu_torch.backend import ba

    p_cpu = ba.problem_from_numpy(*p_dev, device="cpu")
    for name, iters in BA_ITERS:
        def solve(blocked=False):
            return ba.ba_solve(p_dev, iters=iters, gate_rounds=2,
                               kf_blocked=blocked)

        res = _no_sync(solve, dev)
        res2 = _no_sync(solve, dev)
        ref = ba.ba_solve(p_cpu, iters=iters, gate_rounds=2)
        blk = solve(True)
        poses = res.poses.cpu()
        check(bool(poses.isfinite().all()), f"generic {name}: non-finite")
        err_cpu = float((poses - ref.poses).abs().max())
        err_blk = float((poses - blk.poses.cpu()).abs().max())
        same = _same(res, res2)
        print(f"# generic ba_solve {name} ({iters} x 2) K=6 Ok=1365 L=2048 "
              f"on {p_dev.poses.device}: {_queued(dev)}; poses vs "
              f"the CPU generic solve max abs err {err_cpu:.3g}, vs the "
              f"kf-blocked solve {err_blk:.3g}; inliers "
              f"{int(res.num_inliers)} (kf-blocked {int(blk.num_inliers)}, "
              f"CPU {int(ref.num_inliers)}); two runs bit-equal: {same}; "
              f"peak memory {_peak_gib(solve, dev):.3f} GiB (kf-blocked "
              f"{_peak_gib(lambda: solve(True), dev):.3f})")
        check(err_cpu <= MESH_TOL["generic"],
              f"generic {name}: card vs CPU pose error {err_cpu}")
        check(err_blk <= MESH_TOL["generic"],
              f"generic {name}: generic vs kf-blocked pose error {err_blk}")
        check(same, f"generic {name}: two runs differ")
        _card_time(solve, dev, smi, f"generic ba_solve {name} ({iters} x 2)")
        _card_time(lambda: solve(True), dev, smi,
                   f"kf-blocked ba_solve {name} ({iters} x 2), same call")


def replay_phase(scene, dev, smi, logs, capacity=REPLAY_CAPACITY):
    """Phase 12 (b): the graph log of phase 5's session (logs[0]) replayed
    (replay_graph_logs) on `dev` twice: cost_out <= 1.05 cost_in,
    bit-equal, the same n_obs and cost_in (1e-4) as the CPU's replay of
    the file with no LM step; then phase 7's VIO + GPS session's log
    (logs[1]) through replay_graph_logs_vio with
    tests/test_replay_and_utils.py's gates (IMU factors >= keyframes - 4,
    >= 1 GPS factor, > 200 observations, cost_out <= 1.05 cost_in, poses
    within 0.5 m of the logged ones, bit-equal reruns)."""
    from mcslam_tpu_torch.backend.imu import ImuParams
    from mcslam_tpu_torch.utils import replay

    rig = scene.rig
    cTr, f = rig.cam_T_ref.cpu().numpy(), rig.fxycxy.cpu().numpy()
    path, vpath = logs

    def rep():
        return replay.replay_graph_logs(path, cTr, f, obs_capacity=capacity,
                                        device=dev)

    t0 = time.perf_counter()
    out = rep()
    wall = (time.perf_counter() - t0) * 1e3
    out2 = rep()
    cpu = replay.replay_graph_logs(path, cTr, f, iters=0,
                                   obs_capacity=capacity, device="cpu")
    K, L = len(out["kf_ids"]), len(out["lm_ids"])
    same = (np.array_equal(out["poses_out"], out2["poses_out"])
            and np.array_equal(out["lms_out"], out2["lms_out"]))
    print(f"# replay of the {SESSION_FRAMES}-frame session's log on {dev}: "
          f"K={K} L={L} n_obs {out['n_obs']} (CPU {cpu['n_obs']}) of "
          f"{capacity} slots; cost {out['cost_in']:.6g} -> "
          f"{out['cost_out']:.6g} (CPU cost_in {cpu['cost_in']:.6g}); "
          f"inliers {out['inliers']}; wall {wall:.1f} ms (parse, upload, "
          f"15 x 2 solve, fetch); two replays bit-equal: {same}; peak "
          f"memory {_peak_gib(rep, dev):.3f} GiB")
    check(out["n_obs"] == cpu["n_obs"] > 200, "replay: n_obs differs")
    check(abs(out["cost_in"] - cpu["cost_in"]) <= 1e-4 * cpu["cost_in"],
          "replay: cost_in differs from the CPU's")
    check(out["cost_out"] <= 1.05 * out["cost_in"], "replay: the cost rose")
    check(same, "replay: two replays differ")
    _card_time(rep, dev, smi, "replay_graph_logs (whole call)", reps=2)

    btc = rig.body_T_cam.cpu().numpy()
    ctb = np.linalg.inv(btc).astype(np.float32)

    def rep_vio():
        return replay.replay_graph_logs_vio(
            vpath, ctb, f, body_T_cam0=btc[0],
            imu_params=ImuParams(**VIO_IMU), obs_capacity=capacity,
            device=dev)

    t0 = time.perf_counter()
    vo = rep_vio()
    wall = (time.perf_counter() - t0) * 1e3
    vo2 = rep_vio()
    dt = np.linalg.norm(vo["poses_out"][:, :3, 3] - vo["poses_in"][:, :3, 3],
                        axis=-1)
    same = np.array_equal(vo["poses_out"], vo2["poses_out"])
    prof = ""
    if dev.type == "cuda":
        dev_ms, n_ops, _ = device_profile(rep_vio)
        prof = (f"; profiler: {dev_ms:.3f} ms device time in {n_ops:.0f} "
                f"device ops")
    print(f"# VIO replay on {dev}: K={len(vo['kf_ids'])} n_obs {vo['n_obs']},"
          f" IMU factors {vo['n_imu']}, GPS {vo['n_gps']}, loops "
          f"{vo['n_loop']}; cost {vo['cost_in']:.6g} -> {vo['cost_out']:.6g};"
          f" max pose move {dt.max():.4f} m; wall {wall:.1f} ms (host "
          f"clock, ending in the fetch){prof}; two replays bit-equal: "
          f"{same} ({smi})")
    check(vo["n_imu"] >= len(vo["kf_ids"]) - 4, "VIO replay: IMU factors")
    check(vo["n_gps"] >= 1 and vo["n_obs"] > 200, "VIO replay: factors")
    check(vo["cost_out"] <= 1.05 * vo["cost_in"], "VIO replay: the cost rose")
    check(dt.max() < 0.5, f"VIO replay: a pose moved {dt.max()} m")
    check(same, "VIO replay: two replays differ")


def _mesh_match(mesh, dev, smi):
    """sharded_hamming_match of MESH_MATCH queries against map rows over
    the mesh, exactly the single-device brute force."""
    import torch

    from mcslam_tpu_torch.ops import hamming
    from mcslam_tpu_torch.parallel import sharded_match

    N, Q = MESH_MATCH
    rng = np.random.RandomState(3)
    mdesc = rng.randint(0, 2**32, (N, 8), dtype=np.uint64).astype(np.uint32)
    mvalid = rng.rand(N) > 0.1
    q = mdesc[rng.randint(0, N, Q)].copy()
    flip = rng.randint(0, 2**32, (Q, 8), dtype=np.uint64).astype(np.uint32)
    q = np.where(rng.rand(Q, 8) > 0.06, q, q ^ flip)
    q[:Q // 4] = rng.randint(0, 2**32, (Q // 4, 8),
                             dtype=np.uint64).astype(np.uint32)
    qd = hamming.desc_to_torch(q, dev)
    qv = torch.ones(Q, dtype=torch.bool, device=dev)
    d_sh, v_sh, Np = sharded_match.shard_map_desc(mesh, mdesc, mvalid)

    def sharded():
        return sharded_match.sharded_hamming_match(mesh, qd, qv, d_sh, v_sh)

    md = hamming.desc_to_torch(mdesc, dev)
    mv = torch.from_numpy(mvalid).to(dev)

    def single():
        d = torch.where(mv[None], hamming.hamming_matrix(qd, md), 1 << 20)
        d1, i1 = torch.min(d, dim=1)
        d2 = torch.min(d.scatter(1, i1[:, None], 1 << 20), dim=1).values
        ok = qv & (d1 <= 64) & (d1.float() <= 0.85 * d2.float())
        return i1.to(torch.int32), ok, d1.to(torch.int32)

    got, ref = sharded(), single()
    same = _same(got, ref)
    print(f"# sharded_hamming_match: {Q} queries x {N} map rows (padded to "
          f"{Np}) over {mesh.size} shards: idx / ok / distance equal to the "
          f"single-device brute force: {same} ({int(got[1].sum())} pass the "
          f"gates)")
    check(same, "sharded_hamming_match differs from the single device")
    _card_time(sharded, dev, smi, f"sharded_hamming_match ({mesh.size} "
               f"shards)")
    _card_time(single, dev, smi, "single-device brute-force match")


def _mesh_frame(scene, mesh, dev, smi):
    """sharded_build_frame of bench frame 0, one camera per shard, bit-equal
    to build_frame; fast_select and patch_gather launched once per
    shard."""
    from mcslam_tpu_torch import _build
    from mcslam_tpu_torch.frontend import frame
    from mcslam_tpu_torch.parallel import mesh as mesh_mod
    from mcslam_tpu_torch.parallel import sharded_frame

    cam_mesh = mesh_mod.Mesh(mesh.devices, sharded_frame.AXIS)
    kw = scene.frame_kwargs()
    ref = frame.build_frame(scene.imgs[0], scene.rig, **kw)
    _build.LAUNCHES.clear()
    got = sharded_frame.sharded_build_frame(cam_mesh, scene.imgs[0],
                                            scene.rig, **kw)
    launches = dict(_build.LAUNCHES)
    same = [n for n in ref._fields
            if not _same([getattr(got, n)], [getattr(ref, n)])]
    print(f"# sharded_build_frame of bench frame 0 ({C} cameras over "
          f"{mesh.size} shards): fields that differ from build_frame: "
          f"{same or 'none'}; launches {launches}")
    check(not same, f"sharded_build_frame: {same} differ from build_frame")
    if dev.type == "cuda":
        for n in ("fast_select", "patch_gather", *ORB_KERNELS):
            check(launches.get(n, 0) == mesh.size,
                  f"sharded_build_frame: {n} launched {launches.get(n, 0)} "
                  f"times, not once per shard")
    _card_time(lambda: sharded_frame.sharded_build_frame(
        cam_mesh, scene.imgs[0], scene.rig, **kw), dev, smi,
        f"sharded_build_frame ({mesh.size} shards)")
    _card_time(lambda: frame.build_frame(scene.imgs[0], scene.rig, **kw),
               dev, smi, "build_frame, same call")


def _mesh_solves(scene, mesh, p_dev, dev, smi):
    """The observation-sharded solve at the stage C shape and the
    landmark-sharded one at the global solve's test shape against one
    device's ba_solve (MESH_TOL), under sync-debug "error"; the
    landmark-sharded one at the SlamConfig cap with its peak memory."""
    from mcslam_tpu_torch.backend import ba
    from mcslam_tpu_torch.data import synthetic
    from mcslam_tpu_torch.parallel import sharded_ba

    for name, iters in BA_ITERS:
        def solve():
            return sharded_ba.sharded_ba_solve(mesh, *p_dev[:3],
                                               p_dev.kf_valid, p_dev.obs,
                                               *p_dev[4:8], iters=iters)

        out = _no_sync(solve, dev)
        ref = ba.ba_solve(p_dev, iters=iters)
        err = float((out[0] - ref.poses).abs().max())
        print(f"# sharded_ba_solve {name} ({iters} x 2) stage C over "
              f"{mesh.size} shards: {_queued(dev)}; poses vs "
              f"ba_solve max abs err {err:.3g}; inliers {int(out[4])} "
              f"(single {int(ref.num_inliers)})")
        check(err <= MESH_TOL["obs"], f"sharded_ba_solve {name}: {err}")
        _card_time(solve, dev, smi, f"sharded_ba_solve {name} ({iters} x 2, "
                   f"{mesh.size} shards)")
    rig = synthetic.make_synthetic_rig(
        synthetic.SyntheticRigSpec(num_cams=C, image_size=(W, H)),
        device=dev)
    for name, (K, L, O) in (("test shape", GBA_TEST), ("cap", GBA_CAP)):
        f = synthetic.random_window_ba_problem(
            rig, num_kfs=K, num_lms=L, obs_capacity=O, px_noise=0.5,
            step_angle=GBA_STEP)
        p = ba.problem_from_numpy(**f)  # on the rig's device, dev
        grouped = sharded_ba.shard_by_landmark(f["obs"], L, mesh.size)
        pg = ba.problem_from_numpy(**dict(f, obs=grouped))

        def solve():
            return sharded_ba.sharded_ba_solve_lm(
                mesh, *pg[:3], pg.kf_valid, pg.obs, *pg[4:8],
                iters=GBA_ITERS)

        cost0 = float(ba._total_cost(p, 2.5))
        out = _no_sync(solve, dev)
        line = (f"# sharded_ba_solve_lm {name} K={K} Ok={O // K} L={L} over "
                f"{mesh.size} shards ({grouped.kf.shape[0]} grouped rows): "
                f"{_queued(dev)}; cost {cost0:.6g} -> "
                f"{float(out[3]):.6g}; peak memory "
                f"{_peak_gib(solve, dev):.3f} GiB")
        check(bool(out[0].isfinite().all()) and float(out[3]) < cost0,
              f"sharded_ba_solve_lm {name}: no descent")
        if name == "test shape":
            ref = ba.ba_solve(p, iters=GBA_ITERS, kf_blocked=True)
            err = float((out[0] - ref.poses).abs().max())
            line += f"; poses vs ba_solve max abs err {err:.3g}"
            check(err <= MESH_TOL["lm"], f"sharded_ba_solve_lm: {err}")
        print(line)
        _card_time(solve, dev, smi, f"sharded_ba_solve_lm {name}", reps=1)


def mesh_phase(scene, p_dev, dev, smi, plain_times=None):
    """Phase 12 (c) and (d): a MESH_SHARDS-shard mesh (distinct cards where
    the machine has them, else all shards on `dev`): the sharded solves,
    the sharded match, the camera-sharded frame build, a
    SESSION_FRAMES-frame session with mesh= (launches counted) beside
    plain_times, phase 8's session (a plain session is run when it is
    None), then entry()'s forward and dryrun_multichip."""
    import torch

    from mcslam_tpu_torch import _build, entry
    from mcslam_tpu_torch.parallel import mesh as mesh_mod
    from mcslam_tpu_torch.utils import metrics
    from mcslam_tpu_torch.slam import INITIALIZED

    mesh = mesh_mod.spread_mesh(MESH_SHARDS, dev)
    kind = "distinct cards" if mesh.distinct else "all shards on one device"
    print(f"# mesh: {mesh} ({kind}; {torch.cuda.device_count()} CUDA "
          f"device(s))")
    _mesh_solves(scene, mesh, p_dev, dev, smi)
    _mesh_match(mesh, dev, smi)
    _mesh_frame(scene, mesh, dev, smi)

    plain = plain_times if plain_times is not None else run_session(scene)[1]
    _build.LAUNCHES.clear()
    slam, times = run_session(scene, mesh=mesh)
    launches = dict(_build.LAUNCHES)
    ate = metrics.ate_rmse(slam.trajectory_arrays()[1], scene.poses)
    print(f"# mesh session: {SESSION_FRAMES} frames, state {slam.state}, "
          f"keyframes {slam.stats['keyframes']}, failures "
          f"{slam.stats['failures']}, window solves "
          f"{slam.stats.get('window_ba', 0)} (observation-sharded), ATE "
          f"{ate:.4f} m; launches {launches}")
    for label, tt in (("mesh", times), ("single device", plain)):
        for name, kf in (("keyframe frames", True), ("other frames", False)):
            ms = [t * 1e3 for k, (t, is_kf) in enumerate(tt)
                  if k and is_kf == kf]
            print(f"# per-frame process_image wall, {label} session, {name} "
                  f"(n={len(ms)}): median {np.median(ms):.3f} ms, mean "
                  f"{np.mean(ms):.3f} ms ({smi})")
    check(slam.state == INITIALIZED, "mesh session: not INITIALIZED")
    check(slam.stats.get("window_ba", 0) >= 1, "mesh session: no solve")
    check(ate <= MAX_ATE, f"mesh session: ATE {ate:.4f} m > {MAX_ATE}")
    if dev.type == "cuda":
        for n in ("fast_select", "patch_gather", *ORB_KERNELS,
                  "hamming_argmin2", "pose_lm"):
            check(launches.get(n, 0) > 0,
                  f"mesh session: kernel {n} was not launched")

    fn, (example,) = entry.entry(device=dev)
    X, desc, valid = fn(example)
    check(X.shape == (2048, 3) and bool(X.isfinite().all()),
          "entry(): malformed or non-finite output")
    print(f"# entry(): the fused 4-camera VGA frame build on {X.device}, "
          f"{int(valid.sum())} valid intra groups")
    _card_time(lambda: fn(example), dev, smi, "entry() forward")
    t0 = time.perf_counter()
    entry.dryrun_multichip(MESH_SHARDS, device=dev)
    print(f"# dryrun_multichip({MESH_SHARDS}) on {dev}: passed in "
          f"{time.perf_counter() - t0:.1f} s")


# -- phase 13: the native loader, MCRAW replay, the live viewer, the tools ---

def tools_probe(absent=()) -> dict:
    """Phase 13 (a): what the parts need, probed without building
    anything: g++ (path, version), png.h and jpeglib.h on its include
    path, matplotlib -> {what: [missing]} for "library" (mcraw_write,
    so convert_to_mcraw, and NativePrefetchReader), "viewer" (the live
    viewer of (c)) and "d" ((e) and (f), McrawReader and the app's
    replay need none of it). `absent` names what to treat as missing
    though found (a CPU rehearsal of another host)."""
    from mcslam_tpu_torch.data import native_loader

    tc = native_loader.toolchain()
    try:
        import matplotlib
        mpl = matplotlib.__version__
    except ImportError:
        mpl = None
    print(f"# phase 13 probe: g++ {tc['g++']} (version {tc['version']}), "
          f"png.h {tc['png.h']}, jpeglib.h {tc['jpeglib.h']} on its include "
          f"path; matplotlib {mpl}" + (f"; treated as missing: "
                                       f"{', '.join(absent)}" if absent
                                       else ""))
    native = [k for k in ("g++", "png.h", "jpeglib.h")
              if not tc[k] or k in absent]
    viewer = ["matplotlib"] if not mpl or "matplotlib" in absent else []
    return {"library": native, "viewer": viewer, "d": viewer}


OUT_KEYS = ("traj_file", "map_path", "database_path", "log_file",
            "depth_dir", "dense_cloud_path")


def retarget(cfg_text, root, out) -> str:
    """An app cfg's text with every output moved into the directory
    root/out (created)."""
    from pathlib import Path

    (root / out).mkdir()
    lines = []
    for line in cfg_text.splitlines():
        k, _, v = line.partition("=")
        if k in OUT_KEYS:
            p = Path(v)
            line = f"{k}={p.parent.with_name(out) / p.name}"
        lines.append(line)
    return "\n".join(lines) + "\n"


def not_run(part, missing) -> bool:
    """Print the probe's verdict on a part -> whether it is skipped."""
    if missing:
        print(f"# phase 13 ({part}): not run: {', '.join(missing)} missing "
              f"(probe)")
    return bool(missing)


def mcraw_bytes(u8) -> bytes:
    """An MCRAW container of (F, C, H, W) uint8 frames in
    native/loader.cpp's layout: the 32-byte McrawHeader {"MCRW", u32
    version 1, n_frames, n_cams, height, width, u64 0}, then the frames."""
    return (b"MCRW" + np.array([1, *u8.shape], "<u4").tobytes()
            + bytes(8) + np.ascontiguousarray(u8).tobytes())


def mcraw_part(root, u8, smi, missing):
    """Phase 13 (b): the PGM folders under root/images in an MCRAW
    container with the folder's stamps in its sidecar: converted by
    apps.convert_to_mcraw where the probe finds the library's needs
    (and then equal, byte for byte, to mcraw_bytes), else written by
    mcraw_bytes. McrawReader's frames equal the uint8 frames / 255 and
    ImageFolderReader's bit for bit, with the folder's stamps;
    NativePrefetchReader's (folder_reader, where the library builds)
    equal the PGM rasters times the C++ decoders' scale float32(1 / 255)
    bit for bit and ImageFolderReader's u8 / 255 within 6e-8 (one ulp at
    126 of the 256 levels); then each reader's decode time per frame
    (host clock, median) -> the container's path."""
    from mcslam_tpu_torch.data import native_loader, readers

    seq = root / "seq.mcraw"
    folder = readers.ImageFolderReader(root / "images")
    native = not not_run("b: convert_to_mcraw, NativePrefetchReader",
                         missing)
    if native:
        from mcslam_tpu_torch.apps import convert_to_mcraw

        t0 = time.perf_counter()
        rc = convert_to_mcraw.main([str(root / "images"), str(seq)])
        print(f"# convert_to_mcraw: rc {rc}, {time.perf_counter() - t0:.3f}"
              f" s (library {native_loader.build().name})")
        check(rc == 0 and seq.exists(), f"convert_to_mcraw: rc {rc}")
        check(seq.read_bytes() == mcraw_bytes(u8),
              "convert_to_mcraw: the container is not the layout's bytes")
    else:
        seq.write_bytes(mcraw_bytes(u8))
        np.save(str(seq) + ".ts.npy", np.array([t for t, _ in folder.rows]))
        print("# phase 13 (b): the container written by numpy in "
              "native/loader.cpp's layout")
    mr = native_loader.McrawReader(seq)
    nat = native_loader.folder_reader(root / "images") if native else None
    check(len(mr) == len(folder) == len(u8)
          and (nat is None or len(nat) == len(u8)),
          f"readers: {len(mr)} / {len(folder)} frames")
    worst = 0.0
    for k, (t, files) in enumerate(folder.rows):
        m, tm = mr.get_next()
        b, tb = folder.get_next()
        check(np.array_equal(m, u8[k].astype(np.float32) / 255.0)
              and np.array_equal(m, b) and tm == t == tb,
              f"MCRAW frame {k} differs from the uint8 frame / 255")
        if nat is None:
            continue
        a, ta = nat.get_next()
        raster = np.stack([readers._read_pgm(f) for f in files])
        check(ta == t and np.array_equal(a, raster.astype(np.float32)
                                         * np.float32(1.0 / 255.0)),
              f"native frame {k} differs from the PGM raster's decode")
        worst = max(worst, float(np.abs(a - b).max()))
    check(worst <= 6e-8, f"native vs ImageFolderReader: {worst:.3g}")
    mr.close()
    print(f"# readers on {len(u8)} frames: MCRAW == uint8 / 255 bit for bit, "
          f"== ImageFolderReader" + ("" if nat is None else
                                     f"; NativePrefetchReader == PGM raster "
                                     f"* float32(1/255) bit for bit, max "
                                     f"|native - ImageFolderReader| "
                                     f"{worst:.3g}"))
    timed = [("MCRAW (mmap, u8 -> f32)", lambda: native_loader.McrawReader(
        seq)), ("ImageFolderReader (PGM by numpy)",
                lambda: readers.ImageFolderReader(root / "images"))]
    if nat is not None:
        nat.close()
        timed.insert(1, (
            "NativePrefetchReader (PGM, 2 decode threads, depth 4)",
            lambda: native_loader.folder_reader(root / "images")))
    for name, make in timed:
        reader, dt = make(), []
        while True:
            t0 = time.perf_counter()
            if reader.get_next() is None:
                break
            dt.append(time.perf_counter() - t0)
        print(f"# decode {name}: median {np.median(dt) * 1e3:.3f} ms per "
              f"{u8.shape[1]}-camera {W}x{H} frame over {len(dt)} frames "
              f"(host clock) ({smi})")
    return seq


def live_app_part(root, cfgs, seq, poses, device, count, smi, viewer_missing,
                  base=None):
    """Phase 13 (c): the app on `device` with mcraw_path=seq (phase 11
    (a)'s cfg otherwise), with --live_view unless the probe found the
    viewer's needs missing. Gates: rc 0, a TUM row per frame, ATE <=
    APP_MAX_ATE, the default-route kernels launched (`count`); with
    the viewer, the PNG decodes, the HTML page exists, the viewer
    rendered during the session. Prints the per-frame wall time beside
    `base`'s (phase 11 (a)'s run from the PGM folders on the card; in a
    CPU rehearsal with the viewer, the same replay without it) and, on
    the card, the busy share -> (trajectory file, its poses)."""
    from mcslam_tpu_torch.utils import metrics, tum

    live = root / "out13" / "live.png"
    cfg = root / "live.cfg"
    cfg.write_text(retarget(cfgs["app"].read_text(), root, "out13")
                   + f"mcraw_path={seq}\n")
    with_view = not not_run("c: --live_view", viewer_missing)
    extra = ("--live_view", str(live)) if with_view else ()
    what = "mcraw_path" + (" and --live_view" if with_view else "")
    renders = []
    if with_view:
        from mcslam_tpu_torch.viz import viewer

        base_cls = viewer.LiveViewer

        class Recorded(base_cls):
            def stop(self, final_render=True):
                renders.append(self._frames_rendered)
                super().stop(final_render)
                renders.append(self._frames_rendered)

        viewer.LiveViewer = Recorded
    try:
        main_path = ("fast_select", "patch_gather", *ORB_KERNELS,
                     "hamming_argmin2", "pose_lm", "ba_linearize")
        (rc, wall, stamps), launches = count(
            f"the app ({what})", main_path if device == "cuda" else (),
            lambda: app_run(cfg, device, *extra))
    finally:
        if with_view:
            viewer.LiveViewer = base_cls
    ts, est = tum.read_tum(root / "out13" / "traj.txt")
    ate = metrics.ate_rmse(est, poses)
    print(f"# app with {what} on {device}: rc {rc}, {len(ts)} frames, ATE "
          f"{ate:.4f} m (gate {APP_MAX_ATE})")
    check(rc == 0, f"app with {what}: rc {rc}")
    check(len(ts) == len(poses) and np.isfinite(est).all(),
          f"app with {what}: {len(ts)} TUM rows for {len(poses)} frames")
    check(ate <= APP_MAX_ATE,
          f"app with {what}: ATE {ate:.4f} m > {APP_MAX_ATE}")
    if with_view:
        import matplotlib.image

        png = matplotlib.image.imread(live)
        html = live.with_suffix(".html")
        print(f"# live viewer: renders during the session "
              f"{renders[0] if renders else 0}, with the final one "
              f"{renders[-1] if renders else 0}; PNG {png.shape}, HTML "
              f"{html.exists()}")
        check(png.ndim == 3 and png.size > 0,
              "live app: the PNG does not decode")
        check(html.exists() and live.name in html.read_text(),
              "live app: no HTML page")
        check(renders and renders[0] >= 1,
              f"live app: the viewer rendered {renders} times in the session")
    per = frame_walls(stamps)
    if base is None and with_view:  # a CPU rehearsal: replay without it
        cfg_b = root / "noview.cfg"
        cfg_b.write_text(retarget(cfg.read_text(), root, "out13b"))
        base = dict(per_frame=frame_walls(app_run(cfg_b, device)[2]),
                    what="the same MCRAW replay without the viewer")
    elif base is not None:
        print(f"# app with {what} vs phase 11 (a)'s PGM run on the card: "
              f"max |pose difference| {np.abs(est - base['est']).max():.3g}")
    for name, ms in per.items():
        ref = ("" if base is None else
               f"; {base.get('what', 'phase 11 (a) (PGM folders, no viewer)')}"
               f" (n={len(base['per_frame'][name])}): median "
               f"{np.median(base['per_frame'][name]):.3f} ms, mean "
               f"{np.mean(base['per_frame'][name]):.3f} ms")
        print(f"# app per-frame wall with {what} on {device}, {name} "
              f"(n={len(ms)}): median {np.median(ms):.3f} ms, mean "
              f"{np.mean(ms):.3f} ms{ref} ({smi})")
    if device == "cuda":
        prof = root / "live_profiled.cfg"
        prof.write_text(retarget(cfg.read_text(), root, "out13p"))
        extra_p = (("--live_view", str(root / "out13p" / "live.png"))
                   if with_view else ())
        dev_ms, n_ops, _ = device_profile(
            lambda: app_run(prof, device, *extra_p))
        print(f"# app with {what}: {wall * 1e3:.1f} ms wall; a profiled "
              f"repeat {dev_ms:.1f} ms device time in {n_ops:.0f} device "
              f"ops, device busy {100 * dev_ms / (wall * 1e3):.1f} % "
              f"(phase 11 (a): {100 * base['busy']:.1f} %) ({smi})")
    return root / "out13" / "traj.txt", est


def plot_part(root, traj, poses):
    """Phase 13 (d): evaluate_trajectory --plot on (c)'s trajectory
    against the true poses: rc 0, the PNG decodes."""
    import matplotlib.image

    from mcslam_tpu_torch.apps import evaluate_trajectory
    from mcslam_tpu_torch.utils import tum

    gt = root / "gt.txt"
    tum.write_tum(gt, np.array([stamp_ns(k) * 1e-9
                                for k in range(len(poses))]), poses)
    out = root / "eval.png"
    rc = evaluate_trajectory.main([str(traj), str(gt), "--plot", str(out)])
    png = matplotlib.image.imread(out)
    print(f"# evaluate_trajectory --plot: rc {rc}, PNG {png.shape}")
    check(rc == 0 and png.ndim == 3 and png.size > 0,
          f"evaluate_trajectory --plot: rc {rc}")


def vocab_part(root, scene, device, count, smi):
    """Phase 13 (e): apps.train_vocabulary on the PGM folders (its
    default device, the card; APP_VOCAB frames, k 6, depth 3 as phase
    11's vocabulary): fast_select and patch_gather launched, the
    vocabulary has its words; then extract_orb on bench frame 0's camera
    0, the card against the CPU: the level-0 keypoints (position,
    response) exactly, the keypoint set of levels >= 1 shared at >= 95 %
    and descriptors of shared keypoints equal on >= 99.5 %
    (tests/test_torch_ops.py's bounds)."""
    from mcslam_tpu_torch.apps import train_vocabulary
    from mcslam_tpu_torch.loop.vocab import Vocabulary
    from mcslam_tpu_torch.ops import hamming, orb

    out = root / "trained_vocab.npz"
    t0 = time.perf_counter()
    rc, _ = count("train_vocabulary", ("fast_select", "patch_gather")
                  if device == "cuda" else (),
                  lambda: train_vocabulary.main(
                      [str(root / "images"), str(out), "--k", "6", "--depth",
                       "3", "--max_frames", str(APP_VOCAB), "--num_points",
                       str(NPTS), "--num_levels", str(NLVL)]
                      + device_args(device)))
    voc = Vocabulary.load(out)
    print(f"# train_vocabulary on {device}: rc {rc}, {voc.num_words} words, "
          f"{time.perf_counter() - t0:.2f} s ({smi})")
    check(rc == 0 and voc.num_words > 6 ** 2, f"train_vocabulary: rc {rc}, "
          f"{voc.num_words} words")
    img = scene.imgs[0][0]
    kw = dict(num_points=NPTS, num_levels=NLVL)
    kd = orb.extract_orb(img, **kw)
    kc = orb.extract_orb(img.cpu(), **kw)

    def keyed(k, lvl0):
        v = k.valid.cpu().numpy() & ((k.octave.cpu().numpy() == 0) == lvl0)
        xy = k.xy.cpu().numpy()[v]
        d = hamming.desc_to_numpy_u32(k.desc)[v]
        r = k.response.cpu().numpy()[v]
        return {tuple(p): (dd, rr) for p, dd, rr in zip(xy, d, r)}

    l0d, l0c = keyed(kd, True), keyed(kc, True)
    check(l0d.keys() == l0c.keys() and all(
        l0d[p][1] == l0c[p][1] for p in l0d),
        "extract_orb: level-0 keypoints differ between card and CPU")
    hd, hc = keyed(kd, False), keyed(kc, False)
    share = len(hd.keys() & hc.keys()) / max(len(hd), len(hc), 1)
    both = {**l0d, **hd}.keys() & {**l0c, **hc}.keys()
    alld, allc = {**l0d, **hd}, {**l0c, **hc}
    desc_eq = np.mean([np.array_equal(alld[p][0], allc[p][0]) for p in both])
    print(f"# extract_orb card vs CPU on bench frame 0 camera 0: level 0 "
          f"{len(l0d)} keypoints equal; levels >= 1 share {share:.4f} of "
          f"{len(hd)} / {len(hc)}; descriptors equal on {desc_eq:.4f} of "
          f"{len(both)} shared")
    check(share >= 0.95, f"extract_orb: levels >= 1 share {share:.4f}")
    check(desc_eq >= 0.995, f"extract_orb: descriptors equal {desc_eq:.4f}")


def profiling_part(scene, dev):
    """Phase 13 (f): utils/profiling.device_trace around an extraction
    writes a Chrome trace that names fast_select_kernel (mc_fast_select's
    kernel; an empty CUDA trace is taken again, up to five times, as
    device_profile does); sync returns."""
    import tempfile
    from pathlib import Path

    from mcslam_tpu_torch.ops import orb
    from mcslam_tpu_torch.utils import profiling

    found = False
    for attempt in range(5):
        with tempfile.TemporaryDirectory() as tmp:
            with profiling.device_trace(tmp):
                kps = orb.extract_orb(scene.imgs[0][0], num_points=NPTS,
                                      num_levels=NLVL)
            text = (Path(tmp) / "trace.json").read_text()
        found = "fast_select_kernel" in text
        if found:
            break
    check(profiling.sync(kps) is None, "sync returned a value")
    print(f"# device_trace: Chrome trace of {len(text)} bytes names "
          f"fast_select_kernel {found} (attempt {attempt + 1}); sync returned")
    check(found, "device_trace: no fast_select_kernel in five traces")


def tools_parts(root, rig, u8, poses, device, count, smi, missing,
                base=None):
    """Phase 13 (b)-(d) on `device` under `root` (the PGM folders, cfgs
    and vocabulary of write_app_dataset), each part or piece of one as
    the probe allows."""
    cfgs = write_app_dataset(root, rig, u8, device)
    seq = mcraw_part(root, u8, smi, missing["library"])
    traj, _ = live_app_part(root, cfgs, seq, poses, device, count, smi,
                            missing["viewer"], base)
    if not not_run("d", missing["d"]):
        plot_part(root, traj, poses)


def tools_phase(scene, dev, smi, base):
    """Phase 13: (a) tools_probe, (b)-(d) tools_parts on the card with
    the launch counters (phase 11 (a)'s numbers beside (c)'s), (e)
    vocab_part, (f) profiling_part."""
    import tempfile
    from pathlib import Path

    missing = tools_probe()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        tools_parts(root, scene.rig, frames_u8(scene.imgs[:APP_FRAMES]),
                    scene.poses[:APP_FRAMES], "cuda", counted, smi, missing,
                    base)
        vocab_part(root, scene, "cuda", counted, smi)
    profiling_part(scene, dev)


# -- phase 14: the graphed frame step and window solve ------------------------

SYNC_WARNING = "called a synchronizing CUDA operation"
GRAPH_REPS = 10  # frames / solves per timing
LIMIT_MS = {"other frames": 50.0, "keyframe frames": 100.0}  # PERF.md §2
API_LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch",
                "cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset")
# the main path's kernels by wrapper, each with the device-side kernel that
# its wrapper launches exactly once per call (hamming_argmin2 launches a
# tile and a merge kernel; orb_pyramid one tile kernel per launch of its
# plan, one at the main path's shapes; patch_gather_kernel is also the
# batched entry's, which only route A calls)
TRACE_NAMES = {"fast_select": "fast_select_kernel",
               "patch_gather": "patch_gather_kernel",
               "orb_pyramid": "pyramid_tile_kernel",
               "orb_select": "orb_select_one_kernel",
               "orb_describe": "orb_describe_kernel",
               "hamming_argmin2": "hamming_merge_kernel",
               "pose_lm": "pose_lm_cluster_kernel",
               "ba_linearize": "linearize_kernel",
               "tri_refine": "tri_refine_kernel",
               "intra_pairs": "intra_pairs_kernel",
               "ransac_score": "ransac_score_kernel",
               "kabsch_hyp": "kabsch_hyp_kernel",
               "pnp_hyp": "pnp_hyp_kernel",
               **{n: f"{n}_kernel" for n in TRACK_KERNELS},
               **{n: f"{n}_kernel" for n in INTRA_GLUE},
               **{n: f"{n}_kernel" for n in VIO_KERNELS}}
PATH = tuple(TRACE_NAMES)
# degrees of yaw tried, in order, for a prediction off the fast path (on
# an NVIDIA H100 the first that takes frame 2 off it is 18)
YAWS = tuple(float(d) for d in range(10, 31))


def trace_counts(events) -> dict:
    """{wrapper: events of its kernel} among a trace's device-side events
    (TRACE_NAMES)."""
    out = dict.fromkeys(TRACE_NAMES, 0)
    for e in events:
        for n, sym in TRACE_NAMES.items():
            out[n] += sym in e.name
    return out


def traced_launches(fn, expect):
    """fn() under a torch.profiler CUDA trace -> (its result, the launches
    of each kernel of PATH that ran on the device, counted in the trace:
    graph replays and conditional bodies included, which no wrapper
    counts). They must equal expect(result). A trace that lost events
    (device_events: it kept none of its sentinels, or it is short of them
    with none over) is taken again, fn run again, up to five times; then
    the run fails."""
    for _ in range(5):
        out, evs, kept = device_events(fn)
        got, want = trace_counts(evs), expect(out)
        if kept and (got == want or any(got[n] > want[n] for n in PATH)):
            break
        print(f"# a trace short of the launches {want}: {got}; taken again")
    check(got == want, f"launches in the device trace {got} != {want}")
    return out, got


def graph_warmups(slam) -> collections.Counter:
    """The launches of the warm-ups of a session's captured programs."""
    warm = collections.Counter()
    for p in (*slam._frame_programs.programs.values(),
              *slam._solve_programs.programs.values()):
        warm.update(p.warmup)
    return warm


def count_syncs(fn):
    """fn() under torch.cuda.set_sync_debug_mode("warn") -> (its result,
    the host syncs it made: torch warns once per synchronizing call)."""
    import warnings

    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, sum(SYNC_WARNING in str(w.message) for w in caught)


def host_api_launches(fn) -> int:
    """The host-side CUDA API calls that enqueue device work (kernel and
    graph launches, copies, memsets) during one fn(), from a torch.profiler
    trace's CPU events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CPU
               and e.name.startswith(API_LAUNCHES))


def _leaves(x):
    """The tensors of a nest of tuples (NamedTuples included)."""
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    return [] if x is None else [x]


def _median_ms(fn, reps=GRAPH_REPS) -> float:
    """Median host ms of fn() ending in a synchronize."""
    import torch

    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms))


def yawed(deg, dev):
    """A (4, 4) float32 rotation by `deg` degrees about the y axis."""
    import torch

    a = np.deg2rad(deg)
    T = np.eye(4, dtype=np.float32)
    T[0, 0] = T[2, 2] = np.cos(a)
    T[0, 2], T[2, 0] = np.sin(a), -np.sin(a)
    return torch.from_numpy(T).to(dev)


def graph_frames(scene, ff0, mapstate, dev, smi):
    """Phase 14 (a), frames: frames 1 and 2 of the phase 3 drive through
    the eager _build_and_track_step (the host branch) and through one
    captured program per fastpath_frac (utils/graphs, the branch on the
    device), each pair from the same inputs and generator state. After
    its capturing call, the fast-path program is replayed with the
    predicted pose (an input of the step) flipping its branch: identity
    (fast path), a pose yawed off the fast path (the portfolio body
    runs), identity again; the forced-portfolio program once. Every
    output bit-equal to the eager frame's, the fast-path flags as
    planned, and each replay's kernel launches, counted in its device
    trace, equal to the eager frame's. Then the fast-path frame's wall,
    device time, device ops and host-issued launches, graphed and
    eager."""
    import collections

    import torch

    from mcslam_tpu_torch import _build
    from mcslam_tpu_torch import tracking_kernels as tk
    from mcslam_tpu_torch.utils import graphs

    eye = torch.eye(4, device=dev)
    M = ff0.im_valid.shape[0]

    def eager(k, pred, frac, gen):
        return tk._build_and_track_step(
            gen, scene.imgs[k], scene.rig, ff0.im_desc, ff0.im_valid,
            *mapstate, pred, **scene.step_kwargs(frac))

    # the predicted pose off the fast path: the least yaw of YAWS that
    # takes frame 2 off it in the eager step
    off = None
    for deg in YAWS:
        gen = torch.Generator(device=dev).manual_seed(0)
        v = eager(2, yawed(deg, dev), FASTPATH_FRAC, gen)[-1].cpu().numpy()
        if v[20] < 0.5:
            off = deg
            break
    check(off is not None, f"graph: no yaw of {YAWS[0]}-{YAWS[-1]} degrees "
          f"takes frame 2 off the fast path")
    print(f"# graph: a {off} degree yaw of the prediction takes frame 2 off "
          f"the fast path (eager: {v[16]:.0f} inliers of {v[18]:.0f} "
          f"landmark matches, rr_ok {v[19]:.0f})")
    poses = {"identity": eye, f"yaw {off}": yawed(off, dev)}
    plans = (("fast path", FASTPATH_FRAC, ("identity", f"yaw {off}",
                                           "identity"), (1, 0, 1)),
             ("forced portfolio", 2.0, ("identity",), (0,)))
    res = {}
    for name, frac, seq, want_flags in plans:
        gen = torch.Generator(device=dev).manual_seed(0)
        cache = graphs.ProgramCache(dev, gen)

        def step(imgs, pred, frac=frac, gen=gen):
            return tk._build_and_track_step(
                gen, imgs, scene.rig, ff0.im_desc, ff0.im_valid, *mapstate,
                pred, branch="device", **scene.step_kwargs(frac))

        # the capturing call: frame 1 on identity
        state = gen.get_state()
        e_out = eager(1, eye, frac, gen)
        gen.set_state(state)
        g_out, prog = cache(frac, step, (scene.imgs[1], eye))
        n_diff = sum(not torch.equal(a, b)
                     for a, b in zip(_leaves(e_out), _leaves(g_out)))
        print(f"# graph {name} frame 1, identity, the capturing call: "
              f"{n_diff} of {len(_leaves(g_out))} outputs differ from the "
              f"eager frame's; warm-up launches {dict(prog.warmup)}, capture "
              f"{prog.capture_ms:.1f} ms, pools (program and body) "
              f"{prog.pool_bytes() / 2**20:.1f} MiB")
        check(n_diff == 0, f"graph {name} frame 1: the graphed outputs "
              f"differ from the eager ones")
        flags = []
        for pname in seq:
            pred = poses[pname]
            state = gen.get_state()
            before = collections.Counter(_build.LAUNCHES)
            e_out = eager(2, pred, frac, gen)
            e_launch = _build.LAUNCHES - before
            e_launch = {n: e_launch.get(n, 0) for n in PATH}
            # frame 2 comes from host memory, as an app's frames may
            img = scene.imgs[2].cpu()

            def replay(pred=pred, state=state):
                gen.set_state(state)
                return cache(frac, step, (img, pred))[0]

            g_out, traced = traced_launches(replay, lambda _: e_launch)
            v = g_out[-1].cpu().numpy()
            ev, gv = _leaves(e_out), _leaves(g_out)
            n_diff = sum(not torch.equal(a, b) for a, b in zip(ev, gv))
            flags.append(int(v[20] > 0.5))
            print(f"# graph {name} frame 2, {pname}: fastpath={v[20] > 0.5}, "
                  f"inliers {v[16]:.0f}, {n_diff} of {len(gv)} outputs "
                  f"differ from the eager frame's; launches in the replay's "
                  f"trace {traced}, the eager frame's {e_launch}")
            check(len(ev) == len(gv) and n_diff == 0,
                  f"graph {name} frame 2 ({pname}): the graphed outputs "
                  f"differ from the eager ones")
            check(v.shape == (21 + 3 * M + 16 + 2 * M,),
                  f"graph {name}: packed buffer malformed")
        check(tuple(flags) == want_flags, f"graph {name}: fast-path flags "
              f"{flags} over {seq}, want {want_flags}")
        res[name] = (prog, frac, gen)

    prog, frac, gen = res["fast path"]
    imgs1 = scene.imgs[1]

    def graphed_frame():
        return prog(imgs1, eye)[-1].cpu()

    def eager_frame():
        return eager(1, eye, frac, gen)[-1].cpu()

    times = {}
    for name, fn in (("eager", eager_frame), ("graphed", graphed_frame),
                     ("graphed", graphed_frame), ("eager", eager_frame)):
        times.setdefault(name, []).append(_median_ms(fn))
    for name, fn in (("graphed", graphed_frame), ("eager", eager_frame)):
        cond = ("mc_set_cond_kernel",) if name == "graphed" else ()
        dev_ms, n_ops, cond_ms = device_profile(fn, names=cond)
        n_api = host_api_launches(fn)
        print(f"# graph fast-path frame, {name}: wall {min(times[name]):.3f} "
              f"ms (median of {GRAPH_REPS}, best of 2 turns, build + track + "
              f"packed fetch); profiler: {dev_ms:.3f} ms device time in "
              f"{n_ops:.0f} device ops; {n_api} host-issued launches / "
              f"copies"
              + (f"; the IF node's condition kernel (graph_cond.cu) "
                 f"{cond_ms:.4f} ms of device time, bound "
                 f"{bound(COND_BYTES, 0.0)[0]:.2g} ms (bytes: its 1-byte "
                 f"predicate and 8-byte handle read, the 4-byte condition "
                 f"written)" if cond else "")
              + (f"; before the intra match's glue kernels "
                 f"{FRAME_BEFORE[0]} device ops, {FRAME_BEFORE[1]:.3f} ms "
                 f"(NVIDIA H100 80GB HBM3, 700.00 W)" if cond else "")
              + f" ({smi})")
    print(f"# graph capture of the fused frame step: {prog.capture_ms:.1f} ms "
          f"host; warm-up launches {dict(prog.warmup)}")


def graph_solves(p_dev, scene, dev, smi):
    """Phase 14 (a), the window solve: the stage C problem solved warm and
    cold by ba_solve on the side stream, eager and through the session's
    graphed solve (driver_window._replay_solve): every result field
    bit-equal; then each one's wall from dispatch to synchronize, device
    time and ops."""
    import torch

    from mcslam_tpu_torch.backend import ba
    from mcslam_tpu_torch.slam import MultiCameraSLAM, SlamConfig

    slam = MultiCameraSLAM(scene.rig, SlamConfig())
    stream = slam._ba_side_stream()

    def on_side(fn):
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            out = fn()
        torch.cuda.current_stream(dev).wait_stream(stream)
        return out

    for name, iters in BA_ITERS:
        def eager(iters=iters):
            return on_side(lambda: ba.ba_solve(
                p_dev, iters=iters, gate_rounds=2, kf_blocked=True))

        def graphed(iters=iters):
            return on_side(lambda: slam._replay_solve(p_dev, iters))

        e_res, g_res = eager(), graphed()
        n_diff = sum(not torch.equal(a, b) for a, b in zip(e_res, g_res))
        prog = slam._solve_programs.programs[
            (6, p_dev.obs.kf.shape[0] // 6, p_dev.landmarks.shape[0],
             p_dev.cam_T_ref.shape[0], iters, 2)]
        print(f"# graph window solve {name} ({iters} x 2): {n_diff} of "
              f"{len(g_res)} result fields differ from the eager solve's; "
              f"capture {prog.capture_ms:.1f} ms, pool "
              f"{prog.pool_bytes() / 2**20:.1f} MiB")
        check(n_diff == 0, f"graph window solve {name}: the graphed result "
              f"differs from the eager one")
        times = {}
        for tname, fn in (("eager", eager), ("graphed", graphed),
                          ("graphed", graphed), ("eager", eager)):
            times.setdefault(tname, []).append(_median_ms(fn, reps=5))
        for tname, fn in (("graphed", graphed), ("eager", eager)):
            dev_ms, n_ops, _ = device_profile(fn)
            print(f"# graph window solve {name}, {tname}: wall "
                  f"{min(times[tname]):.3f} ms from dispatch to synchronize "
                  f"(median of 5, best of 2 turns); profiler: {dev_ms:.3f} ms "
                  f"device time in {n_ops:.0f} device ops ({smi})")


def graph_session(scene, cuda_graphs=True, syncs=False):
    """The phase 5 session through process_image with or without the
    graphs -> (slam, one record per frame: wall s, keyframe, a deferred
    solve landed, host syncs (with syncs=True), a capture happened)."""
    from mcslam_tpu_torch.slam import INITIALIZED, MultiCameraSLAM, SlamConfig

    slam = MultiCameraSLAM(scene.rig, SlamConfig())
    slam.cuda_graphs = cuda_graphs
    progs = (slam._frame_programs.programs, slam._solve_programs.programs)
    recs = []
    for k in range(SESSION_FRAMES):
        pending = getattr(slam, "_pending_ba", None)
        n_prog = sum(map(len, progs))
        fused = slam.state == INITIALIZED

        def frame(k=k):
            return slam.process_image(scene.imgs[k], k / 20.0,
                                      extract_cfg=scene.frame_kwargs())

        t0 = time.perf_counter()
        info, n_sync = count_syncs(frame) if syncs else (frame(), None)
        recs.append(dict(
            wall=time.perf_counter() - t0, kf=info["keyframe"],
            fused=fused and k > 0, syncs=n_sync,
            landed=(pending is not None
                    and getattr(slam, "_pending_ba", None) is not pending),
            captured=sum(map(len, progs)) > n_prog))
    slam.finalize()
    return slam, recs


def _session_gates(name, slam, scene):
    from mcslam_tpu_torch.slam import INITIALIZED
    from mcslam_tpu_torch.utils import metrics

    _, est = slam.trajectory_arrays()
    ate = metrics.ate_rmse(est, scene.poses)
    print(f"# graph session ({name}): state {slam.state}, keyframes "
          f"{slam.stats['keyframes']}, failures {slam.stats['failures']}, "
          f"fast-path frames {slam.stats.get('track_fastpath', 0)}/"
          f"{slam.stats.get('track_dispatch', 0)}, window solves "
          f"{slam.stats.get('window_ba', 0)}, ATE {ate:.4f} m")
    check(slam.state == INITIALIZED, f"graph session ({name}): not "
          f"INITIALIZED")
    check(slam.stats["failures"] == 0,
          f"graph session ({name}): {slam.stats['failures']} failures")
    check(slam.stats["keyframes"] >= MIN_KEYFRAMES,
          f"graph session ({name}): {slam.stats['keyframes']} keyframes")
    check(np.all(np.isfinite(est)) and ate <= MAX_ATE,
          f"graph session ({name}): ATE {ate:.4f} m")
    return ate


def _walls(recs) -> dict:
    """Per-frame wall ms by kind: the frames that captured a graph apart."""
    out = {"other frames": [], "keyframe frames": [], "capture frames": []}
    for r in recs[1:]:
        kind = ("capture frames" if r["captured"] else
                "keyframe frames" if r["kf"] else "other frames")
        out[kind].append(r["wall"] * 1e3)
    return out


def graph_sessions(scene, dev, smi, eager_ref):
    """Phase 14 (b) and (c): phase 5's session eager (cuda_graphs=False;
    `eager_ref`, phase 5's reference run: slam, records, launches) and
    graphed: both held to phase 5's gates; the graphed one replays its
    frame program on every fused frame and its steady frames (no
    keyframe, no landing, no capture) make exactly one host sync (the
    packed fetch). Its launches are phase 5's, counted in the device
    trace against the eager session's. Then the wall of a frame by kind,
    the device busy share of each session, and the captures' ms, keys
    and pool bytes."""
    import torch

    slam_e, recs_e, launches_e = eager_ref
    _session_gates("eager", slam_e, scene)
    slam_g, recs_g = graph_session(scene, syncs=True)
    _session_gates("graphed", slam_g, scene)
    print(f"# graph session launches: the eager session's {launches_e} "
          f"(an eager session before the graphs read 24 / 24 / 46 / 46 / "
          f"47); the graphed session's in phase 5, from its device trace")
    n_fused = sum(r["fused"] for r in recs_g)
    frame_progs = list(slam_g._frame_programs.programs.values())
    n_replays = sum(p.replays for p in frame_progs)
    print(f"# graph session: {len(frame_progs)} frame program(s), "
          f"{n_replays} replays for {n_fused} fused frames; "
          f"{len(slam_g._solve_programs.programs)} window-solve programs "
          f"replayed {sum(p.replays for p in slam_g._solve_programs.programs.values())} "
          f"times for {slam_g.stats.get('window_ba', 0)} solves")
    check(n_replays == n_fused and len(frame_progs) == 1,
          "graph session: not one frame-program replay per fused frame")
    for name, recs in (("graphed", recs_g), ("eager", recs_e)):
        by = collections.defaultdict(list)
        for r in recs[1:]:
            kind = ("steady" if r["fused"] and not (r["kf"] or r["landed"]
                                                     or r["captured"])
                    else "keyframe / landing / capture")
            by[kind].append(r["syncs"])
        print(f"# graph session host syncs per frame ({name}): "
              + "; ".join(f"{k}: {v}" for k, v in sorted(by.items())))
    steady = [r["syncs"] for r in recs_g[1:] if r["fused"] and not (
        r["kf"] or r["landed"] or r["captured"])]
    check(steady and all(n == 1 for n in steady),
          f"graph session: steady frames' host syncs {steady} (1 each)")

    # (c) times: sessions without the sync counting
    for name, graphs_on in (("eager", False), ("graphed", True),
                            ("graphed", True), ("eager", False)):
        slam, recs = graph_session(scene, cuda_graphs=graphs_on)
        wall_ms = sum(r["wall"] for r in recs) * 1e3
        for kind, ms in _walls(recs).items():
            if ms:
                lim = LIMIT_MS.get(kind)
                print(f"# graph session wall ({name}), {kind} (n={len(ms)}): "
                      f"median {np.median(ms):.3f} ms, mean {np.mean(ms):.3f} "
                      f"ms, max {np.max(ms):.3f} ms"
                      + (f" (PERF.md §2 limit {lim:.0f} ms)" if lim else "")
                      + f" ({smi})")
        if graphs_on:
            for key, p in {**slam._frame_programs.programs,
                           **slam._solve_programs.programs}.items():
                print(f"#   program {str(key)[:80]}: capture "
                      f"{p.capture_ms:.1f} ms, pool (with its body's) "
                      f"{p.pool_bytes() / 2**20:.1f} MiB, replays "
                      f"{p.replays}")
        print(f"# graph session ({name}): {wall_ms:.1f} ms wall for "
              f"{SESSION_FRAMES} frames")
    for name, graphs_on in (("graphed", True), ("eager", False)):
        box = {}

        def run(graphs_on=graphs_on, box=box):
            box["recs"] = graph_session(scene, cuda_graphs=graphs_on)[1]

        dev_ms, n_ops, _ = device_profile(run)
        wall_ms = sum(r["wall"] for r in box["recs"]) * 1e3
        print(f"# graph session device busy ({name}): {dev_ms:.1f} ms device "
              f"time in {n_ops:.0f} device ops over {wall_ms:.1f} ms of "
              f"profiled wall: {100 * dev_ms / wall_ms:.1f} % ({smi})")
    torch.cuda.synchronize()


def graph_vio_solves(scene, dev, smi):
    """Phase 14 (a), the VIO solve: the stage D problems of phase 7 (a)
    (synthetic.random_vio_problem, without GPS and with VIO_GPS factors)
    solved warm and cold by vio_solve and through a session's graphed VIO
    solve (driver_window._replay_vio_solve) on the current stream, then a
    window of the same shapes with other index columns (the IMU pairs and
    GPS fixes rolled) through the same program: every result field
    bit-equal to the eager solve's; each program's capture ms and pool.
    -> the session (its programs serve phase 8's timing)."""
    import torch

    from mcslam_tpu_torch.backend import ba_vio
    from mcslam_tpu_torch.data import synthetic
    from mcslam_tpu_torch.slam import MultiCameraSLAM, SlamConfig

    slam = MultiCameraSLAM(scene.rig, SlamConfig())
    for num_gps in (0, VIO_GPS):
        p = ba_vio.problem_from_numpy(**synthetic.random_vio_problem(
            scene.rig, num_gps=num_gps))
        imu = p.imu._replace(i=torch.roll(p.imu.i, 1),
                             j=torch.roll(p.imu.j, 1))
        other = p._replace(imu=imu, gps=None if p.gps is None else
                           p.gps._replace(kf=torch.roll(p.gps.kf, 1)))
        for name, iters in BA_ITERS:
            n_diff = []
            for q in (p, other):
                e_res = ba_vio.vio_solve(q, iters=iters, kf_blocked=True)
                g_res = slam._replay_vio_solve(q, iters)
                n_diff.append(sum(not torch.equal(a, b)
                                  for a, b in zip(e_res, g_res)))
            progs = vio_programs(slam)
            prog = next(pr for k, pr in progs.items()
                        if k[1] == iters and k[4][1] == (num_gps > 0))
            print(f"# graph VIO solve {name} ({iters} x 2), {num_gps} GPS "
                  f"factors: {n_diff[0]} of {len(g_res)} result fields differ "
                  f"from the eager solve's, {n_diff[1]} for the window with "
                  f"rolled index columns (the same program, replays "
                  f"{prog.replays}); capture {prog.capture_ms:.1f} ms, pool "
                  f"{prog.pool_bytes() / 2**20:.1f} MiB; warm-up launches "
                  f"{dict(prog.warmup)} ({smi})")
            check(n_diff == [0, 0], f"graph VIO solve {name}, {num_gps} GPS: "
                  f"the graphed result differs from the eager one")
            check(prog.replays == 2, f"graph VIO solve {name}: the rolled "
                  f"window did not replay the same program")
    check(len(vio_programs(slam)) == 2 * len(BA_ITERS),
          f"graph VIO solves: {len(vio_programs(slam))} programs")
    return slam


def graphs_phase(scene, ff0, mapstate, p_dev, dev, smi, eager_ref):
    """Phase 14: the graphed frame step, window solve and VIO solve;
    `eager_ref` is phase 5's eager session (slam, records, launches) ->
    the session whose VIO programs phase 8 times."""
    graph_frames(scene, ff0, mapstate, dev, smi)
    graph_solves(p_dev, scene, dev, smi)
    vio_slam = graph_vio_solves(scene, dev, smi)
    graph_sessions(scene, dev, smi, eager_ref)
    return vio_slam


def rehearse_mesh():
    """CPU rehearsal of phase 12 (b)-(d) with the plain versions and
    device="cpu" (the replays at the JAX tests' 16384 observation slots):
    every gate of the phases, no timing."""
    import torch

    from mcslam_tpu_torch.backend import ba
    from mcslam_tpu_torch.data import synthetic

    import tempfile
    from pathlib import Path

    cpu = torch.device("cpu")
    scene = Scene(cpu)
    p = ba.problem_from_numpy(**dict(synthetic.random_window_ba_problem(
        scene.rig, px_noise=0.5), device="cpu"))
    with tempfile.TemporaryDirectory() as tmp:
        logs = (Path(tmp) / "session.log", Path(tmp) / "vio.log")
        run_session(scene, log_path=logs[0])
        vio_session(scene, log_path=logs[1])
        replay_phase(scene, cpu, "cpu rehearsal", logs, capacity=16384)
    mesh_phase(scene, p, cpu, "cpu rehearsal")
    print("# phase 12 rehearsal (b)-(d) on the CPU: passed")


def rehearse_app(seeds, absent=()):
    """CPU rehearsal of phase 11 (a) and (b) with the plain versions: the
    bench scene, rendered as Scene renders it, through app_sessions on
    the CPU once per driver RANSAC seed (MultiCameraSLAM's `seed`), with
    no ATE gate; prints each run's ATEs, which APP_MAX_ATE sits against.
    Then phase 13 (b)-(d) on the CPU (tools_parts, every gate), with
    `absent` treated as missing by the probe."""
    import tempfile
    from pathlib import Path

    from mcslam_tpu_torch import slam as slam_mod
    from mcslam_tpu_torch.data import synthetic

    rig = synthetic.make_synthetic_rig(
        synthetic.SyntheticRigSpec(num_cams=C, image_size=(W, H)),
        device="cpu")
    poses = synthetic.smooth_trajectory(SESSION_FRAMES, step_angle=0.02)
    lms = synthetic.make_landmarks(3000, depth_range=(4.0, 15.0))
    u8 = frames_u8(synthetic.render_blob_images(rig, poses, lms))
    base = slam_mod.MultiCameraSLAM

    def no_count(name, expect, fn):
        return fn(), {}

    for seed in range(seeds):
        class Seeded(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, seed=seed, **kw)

        slam_mod.MultiCameraSLAM = Seeded
        try:
            with tempfile.TemporaryDirectory() as tmp:
                res = app_sessions(Path(tmp), rig, u8, poses, "cpu",
                                   no_count, float("inf"))
        finally:
            slam_mod.MultiCameraSLAM = base
        print(f"# rehearsal seed {seed}: app ATE {res['ate']:.4f} m, "
              f"map-reuse ATE {res['ate_r']:.4f} m, EuRoC runner ATE "
              f"{res['ate_e']:.4f} m")
    missing = tools_probe(absent)
    with tempfile.TemporaryDirectory() as tmp:
        tools_parts(Path(tmp), rig, u8, poses, "cpu", no_count,
                    "cpu rehearsal", missing)
    print("# phase 13 (b)-(d) rehearsal on the CPU: passed")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rehearse-app"]:
        rest = sys.argv[2:]
        absent = ()
        if rest[-2:-1] == ["--as-probed"]:
            absent, rest = tuple(rest[-1].split(",")), rest[:-2]
        rehearse_app(int(rest[0]) if rest else 2, absent)
        sys.exit(0)
    if sys.argv[1:2] == ["--rehearse-mesh"]:
        rehearse_mesh()
        sys.exit(0)
    sys.exit(main())
