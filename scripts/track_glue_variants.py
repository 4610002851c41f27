#!/usr/bin/env python3
"""Split the time of the tracking glue's kernels track_gate,
track_epilogue, localmap_gate and localmap_epilogue (csrc/track_glue.cu)
on one CUDA card
by %globaltimer stamps and by variants of the source, and time an
earlier design of the source against the current one in turns.

    git show <commit>:mcslam_tpu_torch/csrc/track_glue.cu \\
        > mcslam_tpu_torch/_build/earlier_track_glue.cu
    python3 scripts/track_glue_variants.py \\
        [--earlier mcslam_tpu_torch/_build/earlier_track_glue.cu]
        [--rounds 5] [--only SOURCE:VARIANT ...] [--kernels NAME ...]

Run from the repository's root (--earlier also takes a git revision where
the checkout has its history). Builds the source as it stands and the
earlier one, each as it is and with the edits of each variant below (one
nvcc per variant, all started together, into mcslam_tpu_torch/_build/
variants/; only the variants of the kernels named by --kernels, all
four by default), prints each build's registers, shared memory and
spills, and at bench frame 1's recorded calls of the kernels (chip_smoke.
capture_calls on the eager fast-path step against frame 0's map: C = 4
cameras, M = N = 2048 features, L = 4096 candidates) checks each
source's full variant against the plain version bit for bit, then
prints:
- each design's stamps variant's phases per call (the earliest start and
  the latest end of each phase over the blocks, stamped by thread 0 or by
  lane 0 of each warp once the values of the phase are in registers;
  mean over 20 calls);
- each variant's device time per call (the variants of a kernel, of both
  designs, taking turns within each round, reversed every other round;
  20 calls a round, median over the rounds);
- each kernel's wrapper in frontend/track_cuda as the tree holds it
  (its checks, allocations and launch) by CUDA events: 20 calls between
  two events, after 3 warm-up calls, median over the rounds;
- where the tree carves the wrappers' outputs from one buffer
  (track_cuda.epilogue_outputs, localmap_gate_outputs and
  localmap_epilogue_outputs), the host time of that against one
  torch.empty per output (eight, three or four, three), in turns: 200
  calls by the host clock, median over the rounds.
The edits are keyed by the design the source holds (its markers, the
newest design whose markers it holds); every design binds the same C
entries. The variants' outputs are not the function's, except full's.
An edit whose anchor is not found as often as listed fails the run.
Needs one CUDA card.

PR 21's design (a thread per row or column, 128 a block, the counts'
last block by an acq_rel arrival; markers "add_acq_rel(counters + 2)",
"se3_inverse12(T_wr, s_inv);"):
  full     the source as it stands;
  stamps   track_epilogue: start, the chain's loads in (idx, then col_idx
           and prev_lm_id, then the map row), the stores issued, the
           block's counts summed, the last block's tail, the end of every
           block; localmap_gate: start, the pose barrier passed, the map
           rows in, the projections made, the column stores issued, the
           row blocks' ahat stored;
  nocount  track_epilogue without the counts' atomics and tail;
  nocam    track_epilogue without the cam_out and f_out stores;
  noindep  track_epilogue without any store that the match does not
           decide (cam_out, f_out, the rows 3-21);
  nodiv    localmap_gate multiplies where it divides;
  nodesc   localmap_gate without the descriptors' copy.
PR 24's design (markers "EPI_ROWS", "LM_LANES"; its track_gate is PR
21's: a thread per row or column, the cameras' world poses per block in
shared memory behind a barrier):
  full, stamps, nocount, noindep, nodiv, nodesc as above (stamps:
           track_epilogue: start, the chain's loads in, its stores
           issued, the match-independent stores issued, the end;
           localmap_gate: start, the candidates' map rows in, the pose in,
           the projections made, the column stores issued, the row
           blocks' ahat stored; track_gate: start, the pose barrier
           passed, prev_lm_id in, the map row in, the projections made,
           the column stores issued, the row blocks' ahat stored);
  rows16   track_epilogue with 16 rows a block;
  lanes1   localmap_gate with one lane a column (all its cameras and
           divisions in one thread), 64 threads a block;
  lanes2   localmap_gate with two lanes a column (cameras 0, 2 and 1, 3);
  threads64  localmap_gate with 64 threads a block (not 128);
  tg_nodiv track_gate multiplies where it divides;
  tg_norows  track_gate without its ahat row blocks' work (they launch
           and return).
PR 25's design (markers "TG_LANES", "EPI_ROWS", "LM_LANES": track_gate
with four lanes a column, one camera each, the landmark id and map row
loaded before the pose, no barrier):
  the variants of PR 24's design, track_gate's stamps now: start, the map
           row in, the lane's camera pose made, the projections made, the
           column stores issued, the row blocks' ahat stored;
  localmap_epilogue (a thread per row): stamps (start, round 1
           in: best, second, im_valid, idx; cand_ids in; the map row in;
           the rows' stores issued; mask and lm issued);
  nocopy   without the copy of rows 3-21;
  nochain  the map row at idx, with no cand_ids round.
The lm_pos design (marker "LE_ROWS" beside the three above:
localmap_gate writes the candidates' positions lm_pos, localmap_epilogue
reads them in 32-row blocks, a chain warp and three copying warps):
  the variants of the design above but nochain; localmap_epilogue's stamps
           now: start, round 1 in (best, second, im_valid, idx,
           map_pos[0]), round 2 in (cand_ids, lm_pos), the chain's stores
           issued, the copy issued, the end;
  nocopy   without the copy of rows 3-21;
  scalar   the copy by 4-byte loads and stores only.
The recorded calls are the tree's: with --earlier a design without lm_pos
is called without it (the gate's three outputs against the plain
version's first three).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CSRC = ROOT / "mcslam_tpu_torch" / "csrc"
OUT = ROOT / "mcslam_tpu_torch" / "_build" / "variants"
SOURCE = "mcslam_tpu_torch/csrc/track_glue.cu"
NSTAMPS = 16
KERNELS = ("track_gate", "track_epilogue", "localmap_gate",
           "localmap_epilogue")

STAMP_DEFS = """
__device__ unsigned long long g_stamps[16];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) :: "memory");
  return t;
}
__device__ __forceinline__ void stamp(int k) {
  if (k == 0 || k == 8) atomicMin(&g_stamps[k], gtime());
  else atomicMax(&g_stamps[k], gtime());
}
"""
STAMP_GETTER = """
extern "C" int mc_glue_stamps(unsigned long long* host, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));
  if (e != cudaSuccess || !reset) return static_cast<int>(e);
  unsigned long long init[16];
  for (int k = 0; k < 16; ++k) init[k] = (k == 0 || k == 8) ? ~0ull : 0ull;
  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, init, sizeof(init)));
}
"""
NS_TOP = "namespace {\n"
ENTRY = 'extern "C" int mc_track_gate('


def t0(k):
    """A stamp by thread 0 of the block."""
    return f"  if (threadIdx.x == 0) stamp({k});\n"


def w0(k, *regs):
    """A stamp by lane 0 of each warp that gets here, once the registers
    `regs` ("f" or "r" constraint, expression) hold their values."""
    need = ", ".join(f'"{c}"({x})' for c, x in regs)
    wait = f'  asm volatile("" :: {need});\n' if regs else ""
    return wait + f"  if ((threadIdx.x & 31) == 0) stamp({k});\n"


STAMP_COMMON = [(NS_TOP, NS_TOP + STAMP_DEFS, 1),
                (ENTRY, STAMP_GETTER + ENTRY, 1)]

# -- PR 21's design ------------------------------------------------------------
E_EPI_START = ("  __shared__ int s_ok[WARPS], s_with[WARPS];\n"
               "  const int tid = threadIdx.x;\n")
E_EPI_IDX = "    const int j = clampi(j_raw, 0, N - 1);\n"
E_EPI_LM = "    const int safe = clampi(lm0, 0, cap - 1);\n"
E_EPI_X = ("                X2 = map_pos[3 * safe + 2];\n"
           "    const int a = clampi(anchor[m], 0, C - 1);\n")
E_EPI_STORED = ("    packed[21 + 2 * Ml + m] = static_cast<float>(with ? lm0 "
                ": -1);\n  }\n")
E_EPI_SUMMED = ("  __syncthreads();\n  if (tid == 0) {\n"
                "    int n_ok = 0, n_with = 0;\n")
E_EPI_TAIL = "      atomicExch(counters + 2, 0);\n    }\n"
E_EPI_ATOM = ("    if (n_ok) atomicAdd(counters, n_ok);\n"
              "    if (n_with) atomicAdd(counters + 1, n_with);\n")
E_EPI_LAST = ("    if (add_acq_rel(counters + 2) == static_cast<int>(gridDim.x)"
              " - 1) {\n")
E_CAM = "    for (int k = 0; k < 16; ++k) cam_out[16 * m + k] = T[k];\n"
E_F = "    for (int k = 0; k < 4; ++k) f_out[4 * m + k] = f[k];\n"
E_ROWS = ("    obs[3 * Ml + m] = uv[2 * m];\n"
          "    obs[4 * Ml + m] = uv[2 * m + 1];\n")
E_ROWS_T = ("      for (int k = 0; k < 3; ++k) obs[(5 + 3 * i + k) * Ml + m] ="
            " T[4 * i + k];\n      obs[(14 + i) * Ml + m] = T[4 * i + 3];\n")
E_ROWS_F = ("    for (int k = 0; k < 4; ++k) obs[(17 + k) * Ml + m] = f[k];\n"
            "    obs[21 * Ml + m] = 1.0f / sigma2[m];\n")
E_LM_START = "  __shared__ float s_inv[12];\n"
E_LM_ROWS = ("    write_ahat(uv, anchor, im_valid, M, C, blockIdx.x * THREADS,"
             " ahat, s_a);\n")
E_LM_POSE = ("    for (int k = 0; k < 4; ++k) s_f[tid][k] = fxy[4 * tid + k];\n"
             "  }\n  __syncthreads();\n  const int l =")
E_LM_MAP = "              n2 = map_normal[3 * id + 2];\n"
E_LM_BHAT = ("  write_bhat_col(bhat, L, C, l, pu, pv, pen,\n"
             "                 2e13f * (cand_valid[l] ? 0.0f : 1.0f));\n")
E_DESC = ("  for (int k = 0; k < 8; ++k) lm_desc[8 * l + k] = "
          "map_desc[8 * id + k];\n")
E_DIV_UV = ("      const float u = p0 / zs * s_f[c][0] + s_f[c][2];\n"
            "      const float v = p1 / zs * s_f[c][1] + s_f[c][3];\n")
E_DIV_VIEW = "  v0 = v0 / vn;\n  v1 = v1 / vn;\n  v2 = v2 / vn;\n"
PROJ_REGS = [("f", f"{x}[{c}]") for x in ("pu", "pv", "pen")
             for c in range(4)]
EARLIER = {
    "full": [],
    "stamps": STAMP_COMMON + [
        (E_EPI_START, E_EPI_START + t0(0), 1),
        (E_EPI_IDX, E_EPI_IDX + w0(1, ("r", "j")), 1),
        (E_EPI_LM, E_EPI_LM + w0(2, ("r", "safe")), 1),
        (E_EPI_X, E_EPI_X + w0(3, ("f", "X0"), ("f", "X1"), ("f", "X2"),
                               ("r", "(int)m3")), 1),
        (E_EPI_STORED, E_EPI_STORED + w0(4), 1),
        (E_EPI_SUMMED, "  __syncthreads();\n" + t0(5) + E_EPI_SUMMED[19:],
         1),
        (E_EPI_TAIL, "      atomicExch(counters + 2, 0);\n      stamp(6);\n"
         "    }\n    stamp(7);\n", 1),
        (E_LM_START, E_LM_START + t0(8), 1),
        (E_LM_ROWS, E_LM_ROWS + w0(14), 1),
        (E_LM_POSE, E_LM_POSE.replace("  const int l =", t0(9)
                                      + "  const int l ="), 1),
        (E_LM_MAP, E_LM_MAP + w0(10, ("f", "X0"), ("f", "X2"), ("f", "n0"),
                                 ("f", "n2")), 1),
        (E_LM_BHAT, w0(11, *PROJ_REGS) + E_LM_BHAT + w0(12), 1)],
    "nocount": [(E_EPI_ATOM, "", 1), (E_EPI_LAST, "    if (false) {\n", 1)],
    "nocam": [(E_CAM, "", 1), (E_F, "", 1)],
    "noindep": [(E_CAM, "", 1), (E_F, "", 1), (E_ROWS, "", 1),
                (E_ROWS_T, "", 1), (E_ROWS_F, "", 1)],
    "nodiv": [(E_DIV_UV, E_DIV_UV.replace(" / zs", " * zs"), 1),
              (E_DIV_VIEW, E_DIV_VIEW.replace(" / vn", " * vn"), 1)],
    "nodesc": [(E_DESC, "", 1)],
}
EARLIER_PHASES = {
    "track_epilogue": (("start -> idx in (latest warp)", 0, 1),
                       ("-> col_idx, prev_lm_id in", 1, 2),
                       ("-> the map row in", 2, 3),
                       ("-> the stores issued", 3, 4),
                       ("-> the block's counts summed", 4, 5),
                       ("-> the last block's tail", 5, 6),
                       ("start -> end of the latest block", 0, 7)),
    "localmap_gate": (("start -> the pose barrier (latest block)", 8, 9),
                      ("-> the map rows in (latest warp)", 9, 10),
                      ("-> the projections made", 10, 11),
                      ("-> the column stores issued", 11, 12),
                      ("start -> the row blocks' ahat stored", 8, 14),
                      ("start -> end", 8, 12)),
}

# -- PR 24's design ------------------------------------------------------------
C_EPI_START = "  // the epilogue block starts\n"
C_EPI_CHAIN = "    // the chain's values in\n"
C_EPI_CHAIN_STORED = "    // the chain's stores issued\n"
C_EPI_INDEP = "    // the match-independent stores issued\n"
C_EPI_END = "  // the epilogue block ends\n"
C_EPI_COUNT = "      // the block's counts\n"
C_LM_START = "  // the gate block starts\n"
C_LM_ROWS = "    // the ahat rows stored\n"
C_LM_MAP = "  // the candidate's map row in\n"
C_LM_POSE = "  // the pose in\n"
C_LM_PROJ = "  // the projections made\n"
C_LM_END = "  // the gate block ends\n"
C_DIV_UV = ("      const float u = p0 / zs * f.x + f.z;\n"
            "      const float v = p1 / zs * f.y + f.w;\n")
C_DIV_VIEW = "    vd[k] = (comp == 0 ? w0 : (comp == 1 ? w1 : w2)) / vn;\n"
C_DESC = "  // the descriptors' copy\n"
# track_gate as PR 21 wrote it (a thread per column behind the block's
# pose barrier)
B_TG_START = ("  const int tid = threadIdx.x;\n  if (static_cast<int>(blockIdx.x) "
              "< row_blocks) {\n")
B_TG_ROWS = ("    write_ahat<THREADS>(uv, anchor, cur_valid, M, C, blockIdx.x * "
             "THREADS,\n                        ahat, s_a);\n")
B_TG_POSE = ("  __syncthreads();\n  const int n = (static_cast<int>(blockIdx.x) - "
             "row_blocks) * THREADS + tid;\n")
B_TG_ID = "  const int id = prev_lm_id[n];\n"
B_TG_MAP = ("              X2 = map_pos[3 * safe + 2];\n"
            "  float pu[MAX_C], pv[MAX_C], pen[MAX_C];\n")
B_TG_PROJ = "  const float ci = prev_valid[n] ? 0.0f : 1.0f;\n"
B_TG_BHAT = "                 2e13f * ci - PASS_BIAS * cp);\n"
B_TG_DIV = ("      pu[c] = clampf(p0 / zc * s_f[c][0] + s_f[c][2], -1e5f, 1e5f);\n"
            "      pv[c] = clampf(p1 / zc * s_f[c][1] + s_f[c][3], -1e5f, 1e5f);\n")
B_TG_STAMPS = [
    (B_TG_START, B_TG_START.replace("  if (", t0(0) + "  if ("), 1),
    (B_TG_ROWS, B_TG_ROWS + w0(6), 1),
    (B_TG_POSE, B_TG_POSE.replace("  const int n", t0(1) + "  const int n"),
     1),
    (B_TG_ID, B_TG_ID + w0(2, ("r", "id")), 1),
    (B_TG_MAP, B_TG_MAP.replace("  float pu", w0(3, ("f", "X0"), ("f", "X2"),
                                                ("r", "(int)has"))
                                + "  float pu"), 1),
    (B_TG_PROJ, w0(4, *PROJ_REGS) + B_TG_PROJ, 1),
    (B_TG_BHAT, B_TG_BHAT + w0(5), 1)]
TG_PHASES = (("start -> the pose barrier passed (latest block)", 0, 1),
             ("-> prev_lm_id in (latest warp)", 1, 2),
             ("-> the map row in", 2, 3),
             ("-> the projections made", 3, 4),
             ("-> the column stores issued", 4, 5),
             ("start -> the row blocks' ahat stored", 0, 6),
             ("start -> the latest column stores", 0, 5))
EPI_LM_STAMPS = STAMP_COMMON + [
        (C_EPI_START, C_EPI_START + t0(0), 1),
        (C_EPI_CHAIN, C_EPI_CHAIN + w0(1, ("f", "X0"), ("f", "X2"),
                                       ("r", "(int)with")), 1),
        (C_EPI_CHAIN_STORED, C_EPI_CHAIN_STORED + w0(2), 1),
        (C_EPI_INDEP, C_EPI_INDEP + w0(3), 1),
        (C_EPI_END, C_EPI_END + w0(7), 1),
        (C_LM_START, C_LM_START + t0(8), 1),
        (C_LM_ROWS, C_LM_ROWS + w0(14), 1),
        (C_LM_MAP, C_LM_MAP + w0(9, ("f", "X0"), ("f", "X2"), ("f", "n0"),
                                 ("f", "n2")), 1),
        (C_LM_POSE, C_LM_POSE + w0(10, ("f", "rTw[0]"), ("f", "rTw[11]")),
         1),
        (C_LM_PROJ, C_LM_PROJ + w0(11, ("f", "pu[0]"), ("f", "pv[0]"),
                                   ("f", "pen[0]")), 1),
        (C_LM_END, C_LM_END + w0(12), 1)]
CURRENT = {
    "full": [],
    "stamps": EPI_LM_STAMPS + B_TG_STAMPS,
    "nocount": [(C_EPI_COUNT, "      if (M < 0)\n", 1)],
    "noindep": [(C_EPI_INDEP.replace("issued", "begin"),
                 "    if (M < 0)\n", 1)],
    "nodiv": [(C_DIV_UV, C_DIV_UV.replace(" / zs", " * zs"), 1),
              (C_DIV_VIEW, C_DIV_VIEW.replace(" / vn", " * vn"), 1)],
    "nodesc": [(C_DESC, "  if (M < 0)\n", 1)],
    "rows16": [("constexpr int EPI_ROWS = 32;",
                "constexpr int EPI_ROWS = 16;", 1)],
    "lanes1": [("constexpr int LM_LANES = 4;", "constexpr int LM_LANES = 1;",
                1), ("constexpr int LM_THREADS = 128;",
                     "constexpr int LM_THREADS = 64;", 1)],
    "lanes2": [("constexpr int LM_LANES = 4;", "constexpr int LM_LANES = 2;",
                1)],
    "threads64": [("constexpr int LM_THREADS = 128;",
                   "constexpr int LM_THREADS = 64;", 1)],
    "tg_nodiv": [(B_TG_DIV, B_TG_DIV.replace(" / zc", " * zc"), 1)],
    "tg_norows": [(B_TG_ROWS, "    if (M < 0)\n" + B_TG_ROWS, 1)],
}
CURRENT_PHASES = {
    "track_epilogue": (("start -> the chain's values in (latest warp)", 0,
                        1),
                       ("-> the chain's stores issued", 1, 2),
                       ("start -> the independent stores issued", 0, 3),
                       ("start -> end of the latest warp", 0, 7)),
    "localmap_gate": (("start -> the map rows in (latest warp)", 8, 9),
                      ("-> the pose in", 9, 10),
                      ("-> the projections made", 10, 11),
                      ("-> the column stores issued", 11, 12),
                      ("start -> the row blocks' ahat stored", 8, 14),
                      ("start -> end", 8, 12)),
    "track_gate": TG_PHASES,
}

# -- PR 25's design: track_gate with four lanes a column ----------------------
N_TG_START = "  // the track gate block starts\n"
N_TG_ROWS = "    // the track gate's ahat rows stored\n"
N_TG_MAP = "  // the column's map row in\n"
N_TG_POSE = "  // the camera's pose made\n"
N_TG_PROJ = "  // the column's projection made\n"
N_TG_END = "  // the track gate block ends\n"
N_TG_DIV = ("  const float pu = clampf(p0 / zc * f.x + f.z, -1e5f, 1e5f);\n"
            "  const float pv = clampf(p1 / zc * f.y + f.w, -1e5f, 1e5f);\n")
N_TG_AHAT = "    write_ahat<TG_THREADS>(uv, anchor, cur_valid, M, C,\n"
NEWEST = {k: v for k, v in CURRENT.items() if not k.startswith("tg_")}
NEWEST.update({
    "stamps": EPI_LM_STAMPS + [
        (N_TG_START, N_TG_START + t0(0), 1),
        (N_TG_ROWS, N_TG_ROWS + w0(6), 1),
        (N_TG_MAP, N_TG_MAP + w0(1, ("f", "X0"), ("f", "X2"),
                                 ("r", "(int)has")), 1),
        (N_TG_POSE, N_TG_POSE + w0(2, ("f", "w[0]"), ("f", "w[11]")), 1),
        (N_TG_PROJ, N_TG_PROJ + w0(3, ("f", "pu"), ("f", "pv"),
                                   ("f", "pen")), 1),
        (N_TG_END, N_TG_END + w0(4), 1)],
    "tg_nodiv": [(N_TG_DIV, N_TG_DIV.replace(" / zc", " * zc"), 1)],
    "tg_norows": [(N_TG_AHAT, "    if (M < 0)\n" + N_TG_AHAT, 1)]})
NEWEST_PHASES = dict(CURRENT_PHASES, track_gate=(
    ("start -> the map row in (latest warp)", 0, 1),
    ("-> the camera's pose made", 1, 2),
    ("-> the projections made", 2, 3),
    ("-> the column stores issued", 3, 4),
    ("start -> the row blocks' ahat stored", 0, 6),
    ("start -> the latest column stores", 0, 4)))
# localmap_epilogue as a thread per row, 128 a block (every design before
# lm_pos): its body, the stamped body, the copy of rows 3-21, the chain
E_LE_BODY = """  const int m = blockIdx.x * THREADS + threadIdx.x;
  if (m >= M) return;
  const float b = best[m];
  const bool ok = b <= max_dist && b <= second[m] && im_valid[m];
  const int lm = ok ? cand_ids[clampi(idx[m], 0, L - 1)] : -1;
  const int safe = clampi(lm, 0, cap - 1);
  const long long Ml = M;
  obs[m] = map_pos[3 * safe];
  obs[Ml + m] = map_pos[3 * safe + 1];
  obs[2 * Ml + m] = map_pos[3 * safe + 2];
#pragma unroll
  for (int r = 3; r < OBS_ROWS; ++r) obs[r * Ml + m] = obs_in[r * Ml + m];
  mask_f[m] = lm >= 0 ? 1.0f : 0.0f;
  lm_out[m] = lm;
}
"""
E_LE_STAMPED = (t0(0) + """  const int m = blockIdx.x * THREADS + threadIdx.x;
  if (m >= M) return;
  const float b = best[m], s = second[m];
  const bool v = im_valid[m];
  const int j = idx[m];
""" + w0(1, ("f", "b"), ("f", "s"), ("r", "(int)v"), ("r", "j")) + """\
  const bool ok = b <= max_dist && b <= s && v;
  const int lm = ok ? cand_ids[clampi(j, 0, L - 1)] : -1;
""" + w0(2, ("r", "lm")) + """\
  const int safe = clampi(lm, 0, cap - 1);
  const long long Ml = M;
  const float X0 = map_pos[3 * safe], X1 = map_pos[3 * safe + 1],
              X2 = map_pos[3 * safe + 2];
""" + w0(3, ("f", "X0"), ("f", "X1"), ("f", "X2")) + """\
  obs[m] = X0;
  obs[Ml + m] = X1;
  obs[2 * Ml + m] = X2;
#pragma unroll
  for (int r = 3; r < OBS_ROWS; ++r) obs[r * Ml + m] = obs_in[r * Ml + m];
""" + w0(4) + """\
  mask_f[m] = lm >= 0 ? 1.0f : 0.0f;
  lm_out[m] = lm;
""" + w0(5) + "}\n")
E_LE_COPY = ("#pragma unroll\n  for (int r = 3; r < OBS_ROWS; ++r) obs[r * Ml + m] "
             "= obs_in[r * Ml + m];\n")
E_LE_CHAIN = "  const int lm = ok ? cand_ids[clampi(idx[m], 0, L - 1)] : -1;\n"
LE_PR21 = {"stamps": [(E_LE_BODY, E_LE_STAMPED, 1)],
           "nocopy": [(E_LE_COPY, "", 1)],
           "nochain": [(E_LE_CHAIN, E_LE_CHAIN.replace(
               "cand_ids[clampi(idx[m], 0, L - 1)]", "clampi(idx[m], 0, L - 1)"),
               1)]}
NEWEST["stamps"] = NEWEST["stamps"] + LE_PR21["stamps"]
NEWEST.update(nocopy=LE_PR21["nocopy"], nochain=LE_PR21["nochain"])
LE_PR21_PHASES = (("start -> round 1 in (best, second, im_valid, idx; "
                   "latest warp)", 0, 1),
                  ("-> cand_ids in", 1, 2),
                  ("-> the map row in", 2, 3),
                  ("-> the rows' stores issued (X, rows 3-21)", 3, 4),
                  ("-> mask and lm issued", 4, 5),
                  ("start -> end", 0, 5))
NEWEST_PHASES["localmap_epilogue"] = LE_PR21_PHASES

# -- the lm_pos design: localmap_epilogue in 32-row blocks, two load rounds
# (the map row from localmap_gate's lm_pos output)
L_LE_START = "  // the local epilogue block starts\n"
L_LE_R1 = "    // round 1 in\n"
L_LE_R2 = "    // round 2 in\n"
L_LE_CHAIN = "    // the local chain's stores issued\n"
L_LE_COPY = "    // the copy issued\n"
L_LE_END = "  // the local epilogue block ends\n"
L_LE_COPYING = "    // the copy of rows 3-21\n"
L_LE_VEC = "      const bool vec = (M & 3) == 0 &&\n"
LATEST = dict(NEWEST)
LATEST.update({
    "stamps": EPI_LM_STAMPS + [
        (N_TG_START, N_TG_START + t0(0), 1),
        (N_TG_ROWS, N_TG_ROWS + w0(6), 1),
        (N_TG_MAP, N_TG_MAP + w0(1, ("f", "X0"), ("f", "X2"),
                                 ("r", "(int)has")), 1),
        (N_TG_POSE, N_TG_POSE + w0(2, ("f", "w[0]"), ("f", "w[11]")), 1),
        (N_TG_PROJ, N_TG_PROJ + w0(3, ("f", "pu"), ("f", "pv"),
                                   ("f", "pen")), 1),
        (N_TG_END, N_TG_END + w0(4), 1),
        (L_LE_START, L_LE_START + t0(0), 1),
        (L_LE_R1, L_LE_R1 + w0(1, ("f", "b"), ("f", "s"), ("r", "j"),
                               ("f", "Z0")), 1),
        (L_LE_R2, L_LE_R2 + w0(2, ("r", "id"), ("f", "P0"), ("f", "P2")), 1),
        (L_LE_CHAIN, L_LE_CHAIN + w0(3), 1),
        (L_LE_COPY, L_LE_COPY + w0(4), 1),
        (L_LE_END, L_LE_END + w0(5), 1)],
    "nocopy": [(L_LE_COPYING, "    if (M < 0)\n", 1)],
    "scalar": [(L_LE_VEC, "      const bool vec = false &&\n", 1)]})
del LATEST["nochain"]
LATEST_PHASES = dict(NEWEST_PHASES, localmap_epilogue=(
    ("start -> round 1 in (best, second, im_valid, idx, map_pos[0]; "
     "latest warp)", 0, 1),
    ("-> round 2 in (cand_ids, lm_pos)", 1, 2),
    ("-> the chain's stores issued", 2, 3),
    ("start -> the copy of rows 3-21 issued", 0, 4),
    ("start -> end", 0, 5)))
# (markers, edits, stamp phases, name), the newest design first: a source
# holds the first design whose markers it holds all
DESIGNS = [(("LE_ROWS", "TG_LANES", "EPI_ROWS", "LM_LANES"), LATEST,
            LATEST_PHASES, "lm_pos"),
           (("TG_LANES", "EPI_ROWS", "LM_LANES"), NEWEST, NEWEST_PHASES,
            "PR 25's"),
           (("EPI_ROWS", "LM_LANES"), CURRENT, CURRENT_PHASES, "PR 24's"),
           (("add_acq_rel(counters + 2)", "se3_inverse12(T_wr, s_inv);"),
            EARLIER, EARLIER_PHASES, "PR 21's")]
# variants that concern one kernel only
ONLY = {"nocount": "track_epilogue", "nocam": "track_epilogue",
        "noindep": "track_epilogue", "rows16": "track_epilogue", "nodiv": "localmap_gate",
        "nodesc": "localmap_gate", "lanes1": "localmap_gate",
        "lanes2": "localmap_gate", "threads64": "localmap_gate",
        "tg_nodiv": "track_gate", "tg_norows": "track_gate",
        "nocopy": "localmap_epilogue", "nochain": "localmap_epilogue",
        "scalar": "localmap_epilogue"}
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C entries' argument types: the lm_pos design's localmap_gate writes
# lm_pos too, its localmap_epilogue reads it (and takes no cap)
ENTRY_TYPES = {"mc_track_gate": [P] * 12 + [I] * 4 + [P],
               "mc_track_epilogue": [P] * 24 + [I] * 4 + [F, F, P],
               "mc_localmap_gate": [P] * 14 + [I] * 4 + [F] * 3 + [P],
               "mc_localmap_epilogue": [P] * 10 + [I] * 3 + [F, P]}
ENTRY_TYPES_LM_POS = dict(
    ENTRY_TYPES, mc_localmap_gate=[P] * 15 + [I] * 4 + [F] * 3 + [P],
    mc_localmap_epilogue=[P] * 11 + [I] * 2 + [F, P])


def lm_pos_entries(src: str) -> bool:
    """Whether the source's localmap_gate writes lm_pos and its
    localmap_epilogue reads it (the lm_pos design)."""
    return design(src)[3] == "lm_pos"


def design(src: str):
    for d in DESIGNS:
        if all(m in src for m in d[0]):
            return d
    raise RuntimeError("track_glue_variants: no known design in the source")


def variant_source(src: str, name: str) -> str:
    for anchor, new, count in design(src)[1][name]:
        if src.count(anchor) != count:
            raise RuntimeError(
                f"track_glue_variants: the anchor of {name} occurs "
                f"{src.count(anchor)} times (not {count}): {anchor!r}")
        src = src.replace(anchor, new)
    return src


def read_earlier(spec: str) -> str:
    path = pathlib.Path(spec)
    if path.exists():
        return path.read_text()
    return subprocess.run(["git", "show", f"{spec}:{SOURCE}"], cwd=ROOT,
                          check=True, capture_output=True,
                          text=True).stdout


def build_all(sources: dict, jobs) -> dict:
    """{(source, variant): ctypes library}, one nvcc per variant, started
    together; the ptxas report of each printed."""
    from mcslam_tpu_torch import _build

    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for tag, name in jobs:
        stem = f"track_glue_{tag}_{name}"
        cu = OUT / f"{stem}.cu"
        cu.write_text(variant_source(sources[tag], name))
        cmd = [nvcc, *_build.ARCH_FLAGS, *_build.NVCC_FLAGS,
               *_build.SOURCE_FLAGS["track_glue"], "-Xptxas", "-v",
               "-shared", "-o", str(OUT / f"{stem}.so"), str(cu)]
        procs[(tag, name)] = (stem, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (tag, name), (stem, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {tag} {name}:\n{log}")
        for entry in re.findall(r"Compiling entry function '([^']+)'.*?"
                                r"(\d+ bytes stack frame, \d+ bytes spill "
                                r"stores).*?Used (\d+) registers([^\n]*)",
                                log, re.S):
            if any(k in entry[0] for k in KERNELS):
                print(f"# build {tag} {name}: {entry[0][:40]}: {entry[2]} "
                      f"registers{entry[3]}, {entry[1]}", flush=True)
        lib = ctypes.CDLL(str(OUT / f"{stem}.so"))
        types = (ENTRY_TYPES_LM_POS if lm_pos_entries(sources[tag])
                 else ENTRY_TYPES)
        for fn, argtypes in types.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[(tag, name)] = lib
    return libs


def caller(lib, kernel, a, kw, lm_pos: bool):
    """A call of the C entry on the recorded args -> its outputs (one set
    of buffers per caller, written again by every call); lm_pos: the
    entries of the lm_pos design (localmap_gate writes the candidates'
    positions, localmap_epilogue reads them). The recorded args are the
    tree's: localmap_epilogue's hold lm_pos (its sixth)."""
    import torch

    from mcslam_tpu_torch import _build
    from mcslam_tpu_torch.frontend import track_cuda

    f32, b8 = torch.float32, torch.bool
    if kernel == "track_gate":
        dev = a[0].device
        M, N, cap, C = a[0].shape[0], a[3].shape[0], a[5].shape[0], \
            a[7].shape[0]
        DG = 3 * C + 2
        outs = (torch.empty(M, DG, dtype=f32, device=dev),
                torch.empty(DG, N, dtype=f32, device=dev))

        def call():
            _build.check(lib.mc_track_gate(
                *(x.data_ptr() for x in a), *(o.data_ptr() for o in outs),
                M, N, C, cap, _build.stream_ptr(dev)), "mc_track_gate")
            return list(outs)
        return call
    if kernel == "track_epilogue":
        ins, (max_dist, ratio, _) = a[:14], a[14:]
        dev = ins[0].device
        M, N, cap = ins[0].shape[0], ins[3].shape[0], ins[11].shape[0]
        C = ins[12].shape[0]
        outs = (torch.empty(M, 3, dtype=f32, device=dev),
                torch.empty(M, 4, 4, dtype=f32, device=dev),
                torch.empty(M, 4, dtype=f32, device=dev),
                torch.empty(track_cuda.OBS_ROWS, M, dtype=f32, device=dev),
                torch.empty(M, dtype=b8, device=dev),
                torch.empty(M, dtype=b8, device=dev),
                torch.empty(M, dtype=f32, device=dev),
                torch.empty(M, dtype=f32, device=dev))
        packed = torch.zeros(track_cuda.HEAD + 3 * M, dtype=f32, device=dev)
        counters = torch.zeros(4, dtype=torch.int32, device=dev)

        def call():
            _build.check(lib.mc_track_epilogue(
                *(x.data_ptr() for x in ins), *(o.data_ptr() for o in outs),
                packed.data_ptr(), counters.data_ptr(), M, N, C, cap,
                float(max_dist), float(ratio), _build.stream_ptr(dev)),
                "mc_track_epilogue")
            return [*outs, packed[17:19], packed[21:21 + 3 * M]]
        return call
    if kernel == "localmap_epilogue":
        if len(a) == 8:  # a tree whose epilogue takes no lm_pos
            best, second, idx, im_valid, cand_ids, map_pos, obs_in, \
                max_dist = a
            lm_pos_in = None
        else:
            best, second, idx, im_valid, cand_ids, lm_pos_in, map_pos, \
                obs_in, max_dist = a
        dev = best.device
        M, L, cap = best.shape[0], cand_ids.shape[0], map_pos.shape[0]
        outs = (torch.empty(track_cuda.OBS_ROWS, M, dtype=f32, device=dev),
                torch.empty(M, dtype=f32, device=dev),
                torch.empty(M, dtype=torch.int32, device=dev))
        ins = ((best, second, idx, im_valid, cand_ids, lm_pos_in, map_pos,
                obs_in) if lm_pos else
               (best, second, idx, im_valid, cand_ids, map_pos, obs_in))
        sizes = (M, L) if lm_pos else (M, L, cap)

        def call():
            _build.check(lib.mc_localmap_epilogue(
                *(x.data_ptr() for x in ins), *(o.data_ptr() for o in outs),
                *sizes, float(max_dist), _build.stream_ptr(dev)),
                "mc_localmap_epilogue")
            return list(outs)
        return call
    (T_wr, cand_ids, cand_valid, map_pos, map_desc, map_normal, uv, anchor,
     im_valid, cam, f, image_wh) = a[:12]
    min_cos = a[12] if len(a) > 12 else kw.get("min_view_cos", 0.5)
    dev = uv.device
    M, L, cap, C = uv.shape[0], cand_ids.shape[0], map_pos.shape[0], \
        cam.shape[0]
    DG = 3 * C + 2
    outs = (torch.empty(L, 8, dtype=torch.int32, device=dev),
            torch.empty(M, DG, dtype=f32, device=dev),
            torch.empty(DG, L, dtype=f32, device=dev))
    if lm_pos:
        outs += (torch.empty(L, 3, dtype=f32, device=dev),)
    w, h = image_wh

    def call():
        _build.check(lib.mc_localmap_gate(
            uv.data_ptr(), anchor.data_ptr(), im_valid.data_ptr(),
            cand_ids.data_ptr(), cand_valid.data_ptr(), map_pos.data_ptr(),
            map_desc.data_ptr(), map_normal.data_ptr(), cam.data_ptr(),
            f.data_ptr(), T_wr.data_ptr(), *(o.data_ptr() for o in outs), M,
            L, C, cap, float(w), float(h), float(min_cos),
            _build.stream_ptr(dev)), "mc_localmap_gate")
        return list(outs)
    return call


def reference(kernel, a, kw):
    import torch

    import chip_smoke as cs
    from mcslam_tpu_torch.frontend import track_cuda

    fn = getattr(track_cuda, f"{kernel}_reference")
    if kernel == "track_epilogue":
        packed = torch.zeros_like(a[-1])
        return cs.track_outputs(kernel, fn, (*a[:-1], packed), kw)
    return list(fn(*a, **kw))


def wrapper_ms(fn, a, kw, reps=20) -> float:
    import torch

    for _ in range(3):
        fn(*a, **kw)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn(*a, **kw)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def allocation_split(dev, rounds, smi, M=2048, L=4096, C=4, reps=200):
    """Host us per call of the carved outputs against one torch.empty per
    output, at the frame's shapes, in turns."""
    import time

    import numpy as np
    import torch

    from mcslam_tpu_torch.frontend import track_cuda

    f32, b8, i32 = torch.float32, torch.bool, torch.int32
    DG = 3 * C + 2
    # the lm_pos design's gate writes the candidates' positions too
    gate = ((L, 8), i32), ((M, DG), f32), ((DG, L), f32)
    if hasattr(track_cuda, "localmap_epilogue_outputs"):
        gate += (((L, 3), f32),)
    n = len(gate)
    ways = {
        "track_epilogue, eight torch.empty": lambda: [
            torch.empty(*sh, dtype=dt, device=dev) for sh, dt in (
                ((M, 3), f32), ((M, 4, 4), f32), ((M, 4), f32),
                ((track_cuda.OBS_ROWS, M), f32), ((M,), b8), ((M,), b8),
                ((M,), f32), ((M,), f32))],
        "track_epilogue, epilogue_outputs": lambda:
            track_cuda.epilogue_outputs(M, dev),
        f"localmap_gate, {n} torch.empty": lambda: [
            torch.empty(*sh, dtype=dt, device=dev) for sh, dt in gate],
        "localmap_gate, localmap_gate_outputs": lambda:
            track_cuda.localmap_gate_outputs(M, L, C, dev)}
    if hasattr(track_cuda, "localmap_epilogue_outputs"):
        ways.update({
            "localmap_epilogue, three torch.empty": lambda: [
                torch.empty(*sh, dtype=dt, device=dev) for sh, dt in (
                    ((track_cuda.OBS_ROWS, M), f32), ((M,), f32),
                    ((M,), i32))],
            "localmap_epilogue, localmap_epilogue_outputs": lambda:
                track_cuda.localmap_epilogue_outputs(M, dev)})
    times = {k: [] for k in ways}
    for r in range(rounds):
        for k in (list(ways) if r % 2 == 0 else list(ways)[::-1]):
            for _ in range(20):
                ways[k]()
            t = time.perf_counter()
            for _ in range(reps):
                ways[k]()
            times[k].append((time.perf_counter() - t) / reps * 1e6)
    for k, v in times.items():
        print(f"# allocation {k}: {float(np.median(v)):.2f} us per call on "
              f"the host (median of {rounds} rounds of {reps}: "
              f"{', '.join(f'{x:.2f}' for x in v)}) ({smi})", flush=True)


def stamp_split(label, lib, call, phases, smi, reps=20) -> None:
    import numpy as np
    import torch

    lib.mc_glue_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mc_glue_stamps.restype = ctypes.c_int
    host = (ctypes.c_ulonglong * NSTAMPS)()
    rows = []
    for _ in range(reps + 2):
        torch.cuda.synchronize()
        assert lib.mc_glue_stamps(host, 1) == 0
        call()
        torch.cuda.synchronize()
        assert lib.mc_glue_stamps(host, 0) == 0
        t = [int(x) for x in host]
        rows.append([t[b] - t[a] for _, a, b in phases])
    m = np.mean(np.array(rows[2:], dtype=np.float64), axis=0) / 1e3
    print(f"# {label} stamps (us, mean of {reps} calls, %globaltimer; "
          f"{smi}): " + "; ".join(f"{name} {v:.2f}"
                                  for (name, _, _), v in zip(phases, m)),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--earlier", default=None,
                    help="an earlier track_glue.cu, or a git revision")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--only", nargs="*", default=None,
                    help="source:variant pairs (sources earlier, current)")
    ap.add_argument("--kernels", nargs="*", default=list(KERNELS),
                    choices=KERNELS, help="the kernels to split and time")
    opt = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from mcslam_tpu_torch import tracking_kernels as tk
    from mcslam_tpu_torch.frontend import frame, track_cuda

    if not torch.cuda.is_available():
        print("track_glue_variants: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    sources = {"current": (CSRC / "track_glue.cu").read_text()}
    if opt.earlier:
        sources["earlier"] = read_earlier(opt.earlier)
    jobs = []
    for tag, src in sources.items():
        d = design(src)
        print(f"# {tag} source: the {d[3]} design ({d[0]})", flush=True)
        jobs += [(tag, v) for v in d[1]
                 if (opt.only is None or f"{tag}:{v}" in opt.only)
                 and ONLY.get(v, opt.kernels[0]) in opt.kernels]
    libs = build_all(sources, jobs)
    scene = cs.Scene(dev, frames=2)
    ff0 = frame.build_frame(scene.imgs[0], scene.rig, **scene.frame_kwargs())
    mapstate, _ = cs.seed_map(ff0, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    seen = cs.capture_calls(lambda: tk._build_and_track_step(
        gen, scene.imgs[1], scene.rig, ff0.im_desc, ff0.im_valid, *mapstate,
        torch.eye(4, device=dev), **scene.step_kwargs(cs.FASTPATH_FRAC)),
        {n: (track_cuda, n) for n in KERNELS})
    bad = 0
    for kernel in opt.kernels:
        a, kw = seen[kernel]
        ref = reference(kernel, a, kw)
        calls = {(t, v): caller(libs[(t, v)], kernel, a, kw,
                                lm_pos_entries(sources[t]))
                 for t, v in jobs if ONLY.get(v, kernel) == kernel}
        if kernel == "track_gate":
            label = (f"{kernel} C={a[7].shape[0]} M={a[0].shape[0]} "
                     f"N={a[3].shape[0]}")
        elif kernel == "track_epilogue":
            label = (f"{kernel} C={a[12].shape[0]} M={a[0].shape[0]} "
                     f"N={a[3].shape[0]}")
        elif kernel == "localmap_epilogue":
            label = (f"{kernel} M={a[0].shape[0]} L={a[4].shape[0]}")
        else:
            label = (f"{kernel} C={a[9].shape[0]} M={a[6].shape[0]} "
                     f"L={a[1].shape[0]}")
        for (t, v), call in calls.items():
            if v != "full":
                continue
            out = call()
            torch.cuda.synchronize()
            # a design without the gate's lm_pos output: its three outputs
            want = ref[:len(out)] if kernel == "localmap_gate" else ref
            same = len(out) == len(want) and all(
                cs.same_bits(o, r) for o, r in zip(out, want))
            bad += not same
            print(f"# {label} {t} full: "
                  f"{'equal to' if same else 'DIFFERS from'} the plain "
                  f"version bit for bit", flush=True)
        for (t, v), call in calls.items():
            if v == "stamps" and kernel in design(sources[t])[2]:
                stamp_split(f"{label} {t}", libs[(t, v)], call,
                            design(sources[t])[2][kernel], smi)
        names = [tv for tv in calls if tv[1] != "stamps"]
        times = {tv: [] for tv in names}
        for r in range(opt.rounds):
            for tv in (names if r % 2 == 0 else names[::-1]):
                ms, ops, _ = cs.device_profile(calls[tv], reps=20)
                times[tv].append((ms, ops))
        for t, v in names:
            ms = [x for x, _ in times[(t, v)]]
            print(f"# {label} {t} variant {v}: {float(np.median(ms)):.5f} ms "
                  f"device time per call, {times[(t, v)][0][1]:.0f} device "
                  f"ops (median of {opt.rounds} rounds: "
                  f"{', '.join(f'{x:.5f}' for x in ms)}) ({smi})", flush=True)
        wms = [wrapper_ms(getattr(track_cuda, kernel), a, kw)
               for _ in range(opt.rounds)]
        print(f"# {label} wrapper track_cuda.{kernel}: "
              f"{float(np.median(wms)):.4f} ms per call by CUDA events "
              f"(median of {opt.rounds} rounds of 20: "
              f"{', '.join(f'{x:.4f}' for x in wms)}) ({smi})", flush=True)
    if hasattr(track_cuda, "epilogue_outputs") and ({
            "track_epilogue", "localmap_gate", "localmap_epilogue"}
            & set(opt.kernels)):
        allocation_split(dev, opt.rounds, smi)
    print(f"# track_glue_variants: "
          f"{'every full variant equals the plain version' if not bad else f'{bad} full variants differ'}",
          flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    # flushed, then os._exit: after torch.profiler's CUDA traces the
    # interpreter's native finalization can hang (scripts/orb_variants.py)
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
