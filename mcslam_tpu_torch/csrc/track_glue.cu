// The per-frame tracking glue of the frame step, around its two gated
// matches, as four kernels of one launch each: the inter-frame match's
// gate prologue (track_gate) and epilogue (track_epilogue), the local-map
// match's gate prologue (localmap_gate) and epilogue (localmap_epilogue).
//
// Replaces: the TPU-shaped code that XLA fuses around the Pallas matcher
// inside the JAX package's jitted frame step, mcslam_tpu/tracking_kernels.py
// _track_core (:137; the projection prologue :160-186 with _gate_factors
// :94, the mutual / ratio epilogue and the landmark lookups :196-219) and
// _localmap_core (:333; its gathers :341-343 and lookups :349-353) with
// _project_and_match_local (:469; the projection, frustum and viewing-cone
// prologue :479-510 and the epilogue :516). No Pallas kernel corresponds
// to them. In the port their plain versions are frontend/track_cuda.
// *_reference, ~170 tensor ops a frame op by op; these are four launches.
//
// Computes what the plain versions compute, in their order of operations:
//  - track_gate: camera c's world pose cam_T_w = cam_T_ref[c] se3_inverse(
//    pred) (R^T, -(R^T t), then R_c R^T and R_c t' + t_c, each entry a
//    sum of three products added left to right), by the lane of camera c;
//    for each previous feature n its landmark prev_lm_id[n] (-1: none)
//    looked up in the map mirror, p = R_cw X + t_cw, u = clamp(p_x /
//    max(p_z, 1e-6) fx + cx, +-1e5) (v likewise), pen = p_z <= 0.05; the
//    gate factors of ops/match_cuda.hamming_argmin2 (DG = 3 C + 2):
//      ahat (M, DG): -2 oh_c u, -2 oh_c v (c-major), oh_c, u^2 + v^2 +
//        4 PB row_invalid, 1;
//      bhat (DG, N): u_c, v_c, u_c^2 + v_c^2 + 1e12 pen_c, 1,
//        2 PB col_invalid - PB col_pass (PB = 1e13, col_pass: no landmark);
//  - track_epilogue: ok = col_idx[idx] == row & best <= max_dist & best <=
//    ratio second & valid; the landmark lm = prev_lm_id[idx] (-1 where not
//    ok), with_lm = lm >= 0 & map_valid[lm]; X_world = map_pos[max(lm, 0)],
//    cam_T_ref[anchor], fxycxy[anchor], mask3d = with_lm & has_depth; the
//    (22, M) rows pose_lm reads (frontend/pose_opt_cuda._pack_obs: X, uv,
//    R row-major, t, fx fy cx cy, 1 / sigma^2), with_lm and mask3d as
//    bytes and floats; into the packed vector of the frame step the
//    counts of ok and with_lm (slots 17, 18; integer fields of one 64-bit
//    counter, exact, which the last block to arrive reads, writes and
//    leaves at zero) and ok, idx, lm as floats (slots 21 ..);
//  - localmap_gate: the candidates' map rows (position, descriptor words,
//    normal) by id; rTw = se3_inverse(T_wr) by each thread, p_ref = rTw
//    X, p_c = cam_T_ref[c] p_ref, z_s = z > 0.05 ? z : 1, the projection
//    p / z_s f + c, visible where z > 0.05 and inside [0, W) x [0, H) and
//    the viewing cone holds (view = (X - t_wr) / max(|X - t_wr|, 1e-9),
//    cos = view . n > min_cos, or |n| <= 1e-6); the gate factors as
//    above with pen = not visible, the projections clamped to +-1e5 and
//    no pass row; and the candidates' positions lm_pos = map_pos[clamp(
//    cand_ids, 0, cap - 1)], which it holds anyway, for the epilogue;
//  - localmap_epilogue: ok = best <= max_dist & best <= second & valid,
//    lm = ok ? cand_ids[idx] : -1, X_world = map_pos[max(lm, 0)], pose_lm's
//    rows (X, then rows 3-21 of the inter-frame rows: the same features,
//    anchors and sigmas) and its mask lm >= 0. X_world is read as ok ?
//    lm_pos[idx] : map_pos[0], the same value bit for bit: where ok,
//    lm_pos[idx] = map_pos[clamp(cand_ids[idx], 0, cap - 1)], which is
//    map_pos[max(lm, 0)] for every id in [-1, cap) (an id of -1 gives row
//    0 on both sides); where not ok, lm = -1 and both give row 0. So the
//    map row is one load round nearer: idx, then cand_ids and lm_pos side
//    by side.
//
// Bit for bit: built with -fmad=false (_build.SOURCE_FLAGS), so every
// product and sum rounds on its own, as torch's elementwise kernels round
// them; divisions and roots are IEEE (x / y, __fsqrt_rn), as torch's; the
// plain versions write the 3-term rotations, the 4x4 products and the
// norms out as explicit adds in the order above (no einsum or matmul,
// whose order cannot be repeated); clamps let a NaN through, as
// torch.clamp does. So each output equals its plain version's on the card.
// A map or candidate id past the map, an index past the columns or an
// anchor past the cameras is clamped into range here (the plain version
// raises on it).
//
// Bound on the card: launch latency. At the frame's shape (C = 4, M = N =
// 2048, L = 4096) track_gate moves ~0.3 MB, track_epilogue ~0.5 MB,
// localmap_gate ~0.75 MB and localmap_epilogue ~0.4 MB: 0.09-0.22 us at
// 3.35 TB/s; their float32 operations (~30 a column and camera) take
// below 0.01 us at 67 TFLOP/s; each kernel takes 2-5 us on an H100, so
// what counts is the chain of dependent loads a thread waits on and how
// many SMs share the stores. localmap_epilogue spreads its rows over
// 32-row blocks (64 at M = 2048) as track_epilogue does: a chain warp, a
// lane per row, loads idx (and map_pos[0], one broadcast), then cand_ids
// and lm_pos side by side, and writes rows 0-2, the mask and lm, while
// three other warps copy rows 3-21 (19 of a row's 24 stores), which wait
// on no match, as 16-byte runs where M % 4 == 0 and both row arrays are
// 16-byte aligned. track_gate gives a previous-feature column four lanes, lane c
// projecting into camera c (two IEEE divisions a lane, the camera index
// as data on one code path), in 128-thread blocks (64 column blocks and
// 16 ahat row blocks at the frame's shape, one grid): a column loads its
// landmark id with the pose's inputs (pred, cam_T_ref[c], the intrinsics)
// in flight beside it, then its map row, and each lane composes its own
// camera's cam_T_w in registers, in the order above, while the map row is
// in flight, with no block barrier; ahat's rows are
// staged in shared memory so that a block's rows go out as one contiguous
// run (write_ahat, shared with localmap_gate). track_epilogue spreads its
// rows over 32-row blocks
// (64 at M = 2048): a chain warp per block walks idx -> col_idx,
// prev_lm_id -> the map row while three other warps write the rows'
// match-independent outputs (cam_out, f_out, rows 3-21, about 40 of a
// row's ~55 stores) as contiguous runs; the counts cost one atomic round
// trip a warp, no serial tail. localmap_gate gives a candidate column four
// lanes, each projecting into one camera and taking one of the viewing
// ray's three divisions (a thread's chain of dependent work a third of a
// whole column's), in 128-thread blocks (144 at the frame's shape); each
// column loads its candidate, map row and descriptor before it needs the
// pose, and the descriptors go out as 16-byte runs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_C = 4;               // (match_cuda.DG_MAX - 2) / 3
constexpr int MAX_DG = 3 * MAX_C + 2;  // gate factors at MAX_C cameras
constexpr int OBS_ROWS = 22;           // pose_lm's observation rows
constexpr float PASS_BIAS = 1e13f;     // ops/match_cuda.PASS_BIAS
constexpr float GATE_BIG = 1e12f;      // tracking_kernels._GATE_BIG
constexpr unsigned FULL = 0xffffffffu;
// track_epilogue: rows a block, its threads: a chain warp (warp 0) and
// EPI_OTHER threads of other warps, each warp a lane per row
constexpr int EPI_ROWS = 32;
constexpr int EPI_THREADS = 128;
constexpr int EPI_OTHER = EPI_THREADS - 32;
static_assert(EPI_ROWS <= 32 && EPI_OTHER % 32 == 0,
              "a lane per row in every warp of track_epilogue");
// localmap_gate: threads a block (a row each in the row blocks), lanes a
// candidate column (1, 2 or 4)
constexpr int LM_THREADS = 128;
constexpr int LM_LANES = 4;
// track_gate: threads a block (a row each in the row blocks), lanes a
// previous-feature column, one a camera
constexpr int TG_THREADS = 128;
constexpr int TG_LANES = MAX_C;
// localmap_epilogue: rows a block, its threads: a chain warp (warp 0) and
// LE_OTHER threads copying rows 3-21, each warp over the block's rows
constexpr int LE_ROWS = 32;
constexpr int LE_THREADS = 128;
constexpr int LE_OTHER = LE_THREADS - 32;
static_assert(LE_ROWS == 32 && LE_OTHER % 32 == 0,
              "a lane per row in the chain warp of localmap_epilogue");

// a barrier of track_epilogue's other warps alone (its chain warp never
// waits on it)
__device__ __forceinline__ void others_sync() {
  asm volatile("bar.sync 1, %0;" ::"r"(EPI_OTHER) : "memory");
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// torch.clamp: a NaN passes
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return (a0 * b0 + a1 * b1) + a2 * b2;
}

// se3_inverse of the row-major 4x4 P: inv[0..8] = R^T, inv[9..11] =
// -(R^T t), each component (R[0][j] t0 + R[1][j] t1) + R[2][j] t2
__device__ __forceinline__ void se3_inverse12(const float* P, float* inv) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) inv[3 * i + j] = P[4 * j + i];
  }
#pragma unroll
  for (int j = 0; j < 3; ++j)
    inv[9 + j] = -dot3(P[j], P[4 + j], P[8 + j], P[3], P[7], P[11]);
}

// the rows of ahat (M, DG) of rows [m0, m0 + ROWS), a thread each: -2 oh
// u, -2 oh v per camera, oh, u^2 + v^2 + 4 PB row_invalid, 1; staged in
// shared memory, then written as one contiguous run
template <int ROWS>
__device__ void write_ahat(const float* __restrict__ uv,
                           const int* __restrict__ anchor,
                           const bool* __restrict__ valid, int M, int C,
                           int m0, float* __restrict__ ahat, float* s_a) {
  const int DG = 3 * C + 2;
  const int tid = threadIdx.x;
  const int m = m0 + tid;
  if (m < M) {
    const int a = anchor[m];
    const float u = uv[2 * m], v = uv[2 * m + 1];
    const float ri = valid[m] ? 0.0f : 1.0f;
    float* r = s_a + tid * DG;
#pragma unroll
    for (int c = 0; c < MAX_C; ++c) {
      if (c < C) {
        const float oh = a == c ? 1.0f : 0.0f;
        r[2 * c] = -2.0f * (oh * u);
        r[2 * c + 1] = -2.0f * (oh * v);
        r[2 * C + c] = oh;
      }
    }
    r[3 * C] = (u * u + v * v) + 4e13f * ri;
    r[3 * C + 1] = 1.0f;
  }
  __syncthreads();
  const int n = min(ROWS, M - m0) * DG;
  float* out = ahat + static_cast<long long>(m0) * DG;
  for (int k = tid; k < n; k += ROWS) out[k] = s_a[k];
}

// TG_LANES lanes per previous-feature column (lane c projects into camera
// c; lanes c >= C return at once), TG_THREADS a block; the column blocks
// first in the grid, then the row blocks of ahat (TG_THREADS rows each).
// A column's lanes load its landmark id, then the pose's inputs, then its
// map row, and compose their cameras' poses while the map row is in
// flight: no block barrier waits on pred, which the frame step has just
// written
__global__ void __launch_bounds__(TG_THREADS) track_gate_kernel(
    const float* __restrict__ uv, const int* __restrict__ anchor,
    const bool* __restrict__ cur_valid, const int* __restrict__ prev_lm_id,
    const bool* __restrict__ prev_valid, const float* __restrict__ map_pos,
    const bool* __restrict__ map_valid, const float* __restrict__ cam,
    const float* __restrict__ fxy, const float* __restrict__ pred, int M,
    int N, int C, int cap, int col_blocks, float* __restrict__ ahat,
    float* __restrict__ bhat) {
  constexpr int COLS = TG_THREADS / TG_LANES;  // columns a block
  __shared__ float s_a[TG_THREADS * MAX_DG];
  // the track gate block starts
  const int tid = threadIdx.x, c = tid % TG_LANES;
  if (static_cast<int>(blockIdx.x) >= col_blocks) {
    write_ahat<TG_THREADS>(uv, anchor, cur_valid, M, C,
                           (blockIdx.x - col_blocks) * TG_THREADS, ahat,
                           s_a);
    // the track gate's ahat rows stored
    return;
  }
  const int n = blockIdx.x * COLS + tid / TG_LANES;
  if (n >= N || c >= C) return;
  const int id = prev_lm_id[n];
  const bool pvalid = prev_valid[n];
  // the pose's inputs in flight beside the id: pred's and the camera's
  // rows 0-2, its intrinsics
  float P[12], T[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    P[k] = pred[k];
    T[k] = cam[16 * c + k];
  }
  const float4 f = make_float4(fxy[4 * c], fxy[4 * c + 1], fxy[4 * c + 2],
                               fxy[4 * c + 3]);
  const int safe = clampi(id, 0, cap - 1);
  const bool has = id >= 0 && map_valid[safe];
  const float X0 = map_pos[3 * safe], X1 = map_pos[3 * safe + 1],
              X2 = map_pos[3 * safe + 2];
  // the column's map row in
  // camera c's world pose cam_T_w = cam_T_ref[c] @ se3_inverse(pred), rows
  // 0-2 (w[3 i + j] the rotation, w[9 + i] the translation)
  float inv[12], w[12];
  se3_inverse12(P, inv);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      w[3 * i + j] = dot3(T[4 * i], T[4 * i + 1], T[4 * i + 2], inv[j],
                          inv[3 + j], inv[6 + j]);
    w[9 + i] = dot3(T[4 * i], T[4 * i + 1], T[4 * i + 2], inv[9], inv[10],
                    inv[11]) + T[4 * i + 3];
  }
  // the camera's pose made
  const float p0 = dot3(w[0], w[1], w[2], X0, X1, X2) + w[9];
  const float p1 = dot3(w[3], w[4], w[5], X0, X1, X2) + w[10];
  const float p2 = dot3(w[6], w[7], w[8], X0, X1, X2) + w[11];
  const float zc = p2 < 1e-6f ? 1e-6f : p2;
  const float pu = clampf(p0 / zc * f.x + f.z, -1e5f, 1e5f);
  const float pv = clampf(p1 / zc * f.y + f.w, -1e5f, 1e5f);
  const float pen = p2 <= 0.05f ? 1.0f : 0.0f;
  // the column's projection made
  bhat[static_cast<long long>(2 * c) * N + n] = pu;
  bhat[static_cast<long long>(2 * c + 1) * N + n] = pv;
  bhat[static_cast<long long>(2 * C + c) * N + n] =
      (pu * pu + pv * pv) + GATE_BIG * pen;
  if (c == 0) {
    const float ci = pvalid ? 0.0f : 1.0f;
    const float cp = has ? 0.0f : 1.0f;
    bhat[static_cast<long long>(3 * C) * N + n] = 1.0f;
    bhat[static_cast<long long>(3 * C + 1) * N + n] =
        2e13f * ci - PASS_BIAS * cp;
  }
  // the track gate block ends
}

// LM_LANES lanes per candidate column (lane q projects into the cameras
// c = q mod LM_LANES and divides the viewing ray's components k = q mod
// LM_LANES, each on the same code path as its neighbours), LM_THREADS a
// block; the column blocks first in the grid, then
// the row blocks of ahat (LM_THREADS rows each). A column issues its loads
// (the candidate, then its map row and descriptor) ahead of the pose,
// which each thread inverts itself: no block barrier waits on T_wr, which
// the tracking half has just written. Lane q of a column writes the
// components k = q mod LM_LANES of its position to lm_pos (at four lanes,
// a warp's 24 floats one run)
__global__ void __launch_bounds__(LM_THREADS) localmap_gate_kernel(
    const float* __restrict__ uv, const int* __restrict__ anchor,
    const bool* __restrict__ im_valid, const int* __restrict__ cand_ids,
    const bool* __restrict__ cand_valid, const float* __restrict__ map_pos,
    const int* __restrict__ map_desc, const float* __restrict__ map_normal,
    const float* __restrict__ cam, const float* __restrict__ fxy,
    const float* __restrict__ T_wr, int M, int L, int C, int cap,
    float width, float height, float min_cos, int col_blocks,
    int* __restrict__ lm_desc, float* __restrict__ ahat,
    float* __restrict__ bhat, float* __restrict__ lm_pos) {
  constexpr int COLS = LM_THREADS / LM_LANES;  // columns a block
  constexpr int VK = (3 + LM_LANES - 1) / LM_LANES;  // components a lane
  constexpr int WCOLS = 32 / LM_LANES;         // columns a warp
  __shared__ float s_a[LM_THREADS * MAX_DG];
  // the gate block starts
  const int tid = threadIdx.x, lane = tid & 31, q = tid % LM_LANES;
  if (static_cast<int>(blockIdx.x) >= col_blocks) {
    write_ahat<LM_THREADS>(uv, anchor, im_valid, M, C,
                           (blockIdx.x - col_blocks) * LM_THREADS, ahat,
                           s_a);
    // the ahat rows stored
    return;
  }
  const int l = blockIdx.x * COLS + tid / LM_LANES;
  const bool live = l < L;
  int id = 0;
  bool cvalid = false;
  if (live) {
    id = clampi(cand_ids[l], 0, cap - 1);
    cvalid = cand_valid[l];
  }
  const float X0 = map_pos[3 * id], X1 = map_pos[3 * id + 1],
              X2 = map_pos[3 * id + 2];
  const float n0 = map_normal[3 * id], n1 = map_normal[3 * id + 1],
              n2 = map_normal[3 * id + 2];
  // the descriptors' copy
  {
    // the warp's columns' words as 16-byte runs: int4 e of the warp's
    // run is column e / 2's half e % 2, read by 16 bytes where map_desc
    // is aligned to them
    const int c0 = l - lane / LM_LANES;  // the warp's first column
    const bool vec = (reinterpret_cast<uintptr_t>(map_desc) & 15) == 0;
#pragma unroll
    for (int k = 0; k < (2 * WCOLS + 31) / 32; ++k) {
      const int e = 32 * k + lane;
      const int src = __shfl_sync(FULL, id, ((e >> 1) * LM_LANES) & 31);
      const int col = c0 + (e >> 1);
      if (e < 2 * WCOLS && col < L) {
        const int* d = map_desc + 8 * src + 4 * (e & 1);
        const int4 v = vec ? *reinterpret_cast<const int4*>(d)
                           : make_int4(d[0], d[1], d[2], d[3]);
        reinterpret_cast<int4*>(lm_desc)[2 * col + (e & 1)] = v;
      }
    }
  }
  // the candidate's map row in
  if (!live) return;  // a column's lanes return together
#pragma unroll
  for (int k = 0; k < VK; ++k) {
    const int comp = q + LM_LANES * k;
    if (comp < 3) lm_pos[3 * l + comp] = comp == 0 ? X0 : (comp == 1 ? X1 : X2);
  }
  // rTw = se3_inverse(T_wr), by each thread
  float rTw[12];
  se3_inverse12(T_wr, rTw);
  // the pose in
  // the viewing cone: the ray's components divided by the column's lanes
  // (component k by lane k mod LM_LANES), gathered by shuffles
  const float w0 = X0 - T_wr[3], w1 = X1 - T_wr[7], w2 = X2 - T_wr[11];
  float vn = __fsqrt_rn(dot3(w0, w1, w2, w0, w1, w2));
  vn = vn < 1e-9f ? 1e-9f : vn;
  float vd[VK];
#pragma unroll
  for (int k = 0; k < VK; ++k) {
    const int comp = q + LM_LANES * k;
    vd[k] = (comp == 0 ? w0 : (comp == 1 ? w1 : w2)) / vn;
  }
  float v[3];
  if constexpr (LM_LANES == 1) {
    v[0] = vd[0];
    v[1] = vd[1];
    v[2] = vd[2];
  } else {
    const int base = lane - q;  // the column's first lane
    const unsigned cmask = (0xffffffffu >> (32 - LM_LANES)) << base;
#pragma unroll
    for (int i = 0; i < 3; ++i)
      v[i] = __shfl_sync(cmask, vd[i / LM_LANES], base + i % LM_LANES);
  }
  const bool has_n = __fsqrt_rn(dot3(n0, n1, n2, n0, n1, n2)) > 1e-6f;
  const bool cone = dot3(v[0], v[1], v[2], n0, n1, n2) > min_cos || !has_n;
  // the reference frame, then the lane's cameras c = q + LM_LANES k
  const float* r = rTw;
  const float q0 = dot3(r[0], r[1], r[2], X0, X1, X2) + r[9];
  const float q1 = dot3(r[3], r[4], r[5], X0, X1, X2) + r[10];
  const float q2 = dot3(r[6], r[7], r[8], X0, X1, X2) + r[11];
  constexpr int CK = MAX_C / LM_LANES;  // cameras a lane
  float pu[CK], pv[CK], pen[CK];
#pragma unroll
  for (int k = 0; k < CK; ++k) {
    const int c = q + LM_LANES * k;
    if (c < C) {
      const float* w = cam + 16 * c;
      const float4 f = make_float4(fxy[4 * c], fxy[4 * c + 1],
                                   fxy[4 * c + 2], fxy[4 * c + 3]);
      const float p0 = dot3(w[0], w[1], w[2], q0, q1, q2) + w[3];
      const float p1 = dot3(w[4], w[5], w[6], q0, q1, q2) + w[7];
      const float z = dot3(w[8], w[9], w[10], q0, q1, q2) + w[11];
      const float zs = z > 0.05f ? z : 1.0f;
      const float u = p0 / zs * f.x + f.z;
      const float v = p1 / zs * f.y + f.w;
      const bool vis = z > 0.05f && u >= 0.0f && u < width && v >= 0.0f &&
                       v < height && cone;
      pu[k] = clampf(u, -1e5f, 1e5f);
      pv[k] = clampf(v, -1e5f, 1e5f);
      pen[k] = vis ? 0.0f : 1.0f;
    }
  }
  // the projections made
#pragma unroll
  for (int k = 0; k < CK; ++k) {
    const int c = q + LM_LANES * k;
    if (c < C) {
      bhat[static_cast<long long>(2 * c) * L + l] = pu[k];
      bhat[static_cast<long long>(2 * c + 1) * L + l] = pv[k];
      bhat[static_cast<long long>(2 * C + c) * L + l] =
          (pu[k] * pu[k] + pv[k] * pv[k]) + GATE_BIG * pen[k];
    }
  }
  if (q == 0) {
    bhat[static_cast<long long>(3 * C) * L + l] = 1.0f;
    bhat[static_cast<long long>(3 * C + 1) * L + l] =
        2e13f * (cvalid ? 0.0f : 1.0f);
  }
  // the gate block ends
}

// EPI_ROWS rows a block of EPI_THREADS threads. The chain warp (a lane
// per row) loads idx, then col_idx and prev_lm_id, then the map row, and
// writes what the match decides: X (as contiguous runs through shuffles),
// rows 0-2, the masks, the packed slots, and the counts by one 64-bit
// atomic a block; the other warps meanwhile write what the frame build
// decided alone: cam_out and f_out as 16-byte runs, rows 3-21. The
// counter packs the count of ok (bits 0-21), of with_lm (22-43) and the
// blocks arrived (44-63): the last block to arrive reads both totals from
// its one atomic, writes them and leaves the counter at zero
__global__ void __launch_bounds__(EPI_THREADS) track_epilogue_kernel(
    const float* __restrict__ best, const float* __restrict__ second,
    const int* __restrict__ idx, const int* __restrict__ col_idx,
    const bool* __restrict__ cur_valid, const bool* __restrict__ has_depth,
    const float* __restrict__ uv, const int* __restrict__ anchor,
    const float* __restrict__ sigma2, const int* __restrict__ prev_lm_id,
    const bool* __restrict__ map_valid, const float* __restrict__ map_pos,
    const float* __restrict__ cam, const float* __restrict__ fxy, int M,
    int N, int C, int cap, float max_dist, float ratio,
    float* __restrict__ X_out, float* __restrict__ cam_out,
    float* __restrict__ f_out, float* __restrict__ obs,
    bool* __restrict__ with_out, bool* __restrict__ mask3d_out,
    float* __restrict__ with_f, float* __restrict__ mask3d_f,
    float* __restrict__ packed,
    unsigned long long* __restrict__ counter) {
  __shared__ __align__(16) float s_cam[MAX_C * 16];
  __shared__ __align__(16) float s_f[MAX_C * 4];
  // the epilogue block starts
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * EPI_ROWS;
  const int nr = min(EPI_ROWS, M - m0);
  const long long Ml = M;
  if (warp == 0) {
    const int m = m0 + lane;
    const bool live = lane < nr;
    bool ok = false, with = false, m3 = false;
    int j_raw = 0, lm = -1;
    float X0 = 0.0f, X1 = 0.0f, X2 = 0.0f;
    if (live) {
      j_raw = idx[m];
      const float b = best[m], s = second[m];
      const bool valid = cur_valid[m], depth = has_depth[m];
      const int j = clampi(j_raw, 0, N - 1);
      const int col = col_idx[j], prev = prev_lm_id[j];
      ok = col == m && b <= max_dist && b <= ratio * s && valid;
      const int lm0 = ok ? prev : -1;
      const int safe = clampi(lm0, 0, cap - 1);
      with = lm0 >= 0 && map_valid[safe];
      X0 = map_pos[3 * safe];
      X1 = map_pos[3 * safe + 1];
      X2 = map_pos[3 * safe + 2];
      m3 = with && depth;
      lm = with ? lm0 : -1;
    }
    // the chain's values in
    // X_out's 3 nr floats of the block's rows in three contiguous runs
    float* xo = X_out + 3ll * m0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int e = 32 * k + lane;
      const int src = e / 3, comp = e - 3 * src;
      const float x0 = __shfl_sync(FULL, X0, src);
      const float x1 = __shfl_sync(FULL, X1, src);
      const float x2 = __shfl_sync(FULL, X2, src);
      if (e < 3 * nr) xo[e] = comp == 0 ? x0 : (comp == 1 ? x1 : x2);
    }
    if (live) {
      obs[m] = X0;
      obs[Ml + m] = X1;
      obs[2 * Ml + m] = X2;
      with_out[m] = with;
      mask3d_out[m] = m3;
      with_f[m] = with ? 1.0f : 0.0f;
      mask3d_f[m] = m3 ? 1.0f : 0.0f;
      packed[21 + m] = ok ? 1.0f : 0.0f;
      packed[21 + Ml + m] = static_cast<float>(j_raw);
      packed[21 + 2 * Ml + m] = static_cast<float>(lm);
    }
    // the chain's stores issued
    const unsigned b_ok = __ballot_sync(FULL, ok);
    const unsigned b_with = __ballot_sync(FULL, with);
    if (lane == 0) {
      // the block's counts
      {
        const unsigned long long mine =
            (1ull << 44) | (static_cast<unsigned long long>(__popc(b_with))
                            << 22) | static_cast<unsigned long long>(__popc(b_ok));
        const unsigned long long now = atomicAdd(counter, mine) + mine;
        if ((now >> 44) == gridDim.x) {
          packed[17] = static_cast<float>(now & 0x3fffffu);
          packed[18] = static_cast<float>((now >> 22) & 0x3fffffu);
          *counter = 0ull;
        }
      }
    }
  } else {
    // the other warps: a lane per row (every such warp loads the rows'
    // anchor, uv and sigma^2), the rig's cameras into shared memory, then
    // their stores; no load waits on another
    const int t = tid - 32, w = t >> 5;
    const int i = lane, m = m0 + i;
    const bool live = i < nr;
    int a = 0;
    float u = 0.0f, v = 0.0f, s2 = 1.0f;
    if (live) {
      a = clampi(anchor[m], 0, C - 1);
      u = uv[2 * m];
      v = uv[2 * m + 1];
      s2 = sigma2[m];
    }
    for (int k = t; k < 20 * C; k += EPI_OTHER) {
      if (k < 16 * C) s_cam[k] = cam[k];
      else s_f[k - 16 * C] = fxy[k - 16 * C];
    }
    others_sync();
    // the match-independent stores begin
    {
      // cam_out's and f_out's rows as 16-byte runs: float4 e < 4 nr is
      // row e / 4's quarter e % 4 of cam_out, 4 nr <= e < 5 nr row e - 4 nr
      // of f_out; the row's anchor from its lane
      float4* co = reinterpret_cast<float4*>(cam_out) + 4ll * m0;
      float4* fo = reinterpret_cast<float4*>(f_out) + m0;
#pragma unroll
      for (int k = 0; k < (5 * EPI_ROWS + EPI_OTHER - 1) / EPI_OTHER; ++k) {
        const int e = t + EPI_OTHER * k;
        const int row = e < 4 * EPI_ROWS ? e >> 2 : e - 4 * EPI_ROWS;
        const int ar = __shfl_sync(FULL, a, row & 31);
        if (e < 4 * nr) {
          co[e] = *reinterpret_cast<const float4*>(s_cam + 16 * ar +
                                                   4 * (e & 3));
        } else if (e >= 4 * EPI_ROWS && row < nr) {
          fo[row] = *reinterpret_cast<const float4*>(s_f + 4 * ar);
        }
      }
      // rows 3-21 (uv, R row-major, t, f, 1 / sigma^2): warp w of the
      // others writes the rows 3 + w, 3 + w + EPI_OTHER / 32, ...
      if (live) {
        const float* T = s_cam + 16 * a;
        const float* f = s_f + 4 * a;
#pragma unroll
        for (int row = 3; row < OBS_ROWS; ++row) {
          if ((row - 3) % (EPI_OTHER / 32) != w) continue;
          float val;
          if (row == 3) val = u;
          else if (row == 4) val = v;
          else if (row < 14) val = T[4 * ((row - 5) / 3) + (row - 5) % 3];
          else if (row < 17) val = T[4 * (row - 14) + 3];
          else if (row < 21) val = f[row - 17];
          else val = 1.0f / s2;
          obs[row * Ml + m] = val;
        }
      }
    }
    // the match-independent stores issued
  }
  // the epilogue block ends
}

// LE_ROWS rows a block of LE_THREADS threads. The chain warp (a lane per
// row) loads best, second, im_valid, idx and map_pos[0] (round 1), then
// cand_ids[idx] and lm_pos[idx] side by side (round 2), and writes rows
// 0-2, the mask and lm; the other warps meanwhile copy rows 3-21 of the
// block's rows, which no match decides, as 16-byte runs where they can
__global__ void __launch_bounds__(LE_THREADS) localmap_epilogue_kernel(
    const float* __restrict__ best, const float* __restrict__ second,
    const int* __restrict__ idx, const bool* __restrict__ im_valid,
    const int* __restrict__ cand_ids, const float* __restrict__ lm_pos,
    const float* __restrict__ map_pos, const float* __restrict__ obs_in,
    int M, int L, float max_dist, float* __restrict__ obs,
    float* __restrict__ mask_f, int* __restrict__ lm_out) {
  // the local epilogue block starts
  const int tid = threadIdx.x, lane = tid & 31;
  const int m0 = blockIdx.x * LE_ROWS;
  const int nr = min(LE_ROWS, M - m0);
  const long long Ml = M;
  if (tid < 32) {
    if (lane >= nr) return;
    const int m = m0 + lane;
    const float b = best[m], s = second[m];
    const bool valid = im_valid[m];
    const int j = clampi(idx[m], 0, L - 1);
    const float Z0 = map_pos[0], Z1 = map_pos[1], Z2 = map_pos[2];
    // round 1 in
    const int id = cand_ids[j];
    const float P0 = lm_pos[3 * j], P1 = lm_pos[3 * j + 1],
                P2 = lm_pos[3 * j + 2];
    // round 2 in
    const bool ok = b <= max_dist && b <= s && valid;
    const int lm = ok ? id : -1;
    obs[m] = ok ? P0 : Z0;
    obs[Ml + m] = ok ? P1 : Z1;
    obs[2 * Ml + m] = ok ? P2 : Z2;
    mask_f[m] = lm >= 0 ? 1.0f : 0.0f;
    lm_out[m] = lm;
    // the local chain's stores issued
  } else {
    // the copy of rows 3-21
    {
      const int t = tid - 32;
      const bool vec = (M & 3) == 0 &&
                       ((reinterpret_cast<uintptr_t>(obs) |
                         reinterpret_cast<uintptr_t>(obs_in)) & 15) == 0;
      if (vec) {
        // float4 e: row 3 + e / (LE_ROWS / 4), its quarter-run e % (LE_ROWS
        // / 4) of the block's rows (nr a multiple of 4 here)
        constexpr int Q = LE_ROWS / 4;
        constexpr int N4 = (OBS_ROWS - 3) * Q;
#pragma unroll
        for (int k = 0; k < (N4 + LE_OTHER - 1) / LE_OTHER; ++k) {
          const int e = t + LE_OTHER * k;
          const int row = 3 + e / Q, i = 4 * (e % Q);
          if (e < N4 && i < nr) {
            const long long at = row * Ml + m0 + i;
            *reinterpret_cast<float4*>(obs + at) =
                *reinterpret_cast<const float4*>(obs_in + at);
          }
        }
      } else {
        constexpr int N1 = (OBS_ROWS - 3) * LE_ROWS;
#pragma unroll
        for (int k = 0; k < (N1 + LE_OTHER - 1) / LE_OTHER; ++k) {
          const int e = t + LE_OTHER * k;
          const int row = 3 + e / LE_ROWS, i = e % LE_ROWS;
          if (e < N1 && i < nr) {
            const long long at = row * Ml + m0 + i;
            obs[at] = obs_in[at];
          }
        }
      }
    }
    // the copy issued
  }
  // the local epilogue block ends
}

}  // namespace

// uv, anchor, cur_valid, prev_lm_id, prev_valid, map_pos, map_valid,
// cam_T_ref, fxycxy, pred_T_wr, ahat, bhat, M, N, C, cap, stream
extern "C" int mc_track_gate(const void* uv, const void* anchor,
                             const void* cur_valid, const void* prev_lm_id,
                             const void* prev_valid, const void* map_pos,
                             const void* map_valid, const void* cam,
                             const void* fxy, const void* pred, void* ahat,
                             void* bhat, int M, int N, int C, int cap,
                             void* stream) {
  if (M < 0 || N < 0 || C < 1 || C > MAX_C || cap < 1)
    return cudaErrorInvalidValue;
  const int cols = TG_THREADS / TG_LANES;
  const int cb = (N + cols - 1) / cols;
  const int grid = cb + (M + TG_THREADS - 1) / TG_THREADS;
  if (grid == 0) return 0;
  track_gate_kernel<<<grid, TG_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(uv), static_cast<const int*>(anchor),
      static_cast<const bool*>(cur_valid),
      static_cast<const int*>(prev_lm_id),
      static_cast<const bool*>(prev_valid),
      static_cast<const float*>(map_pos), static_cast<const bool*>(map_valid),
      static_cast<const float*>(cam), static_cast<const float*>(fxy),
      static_cast<const float*>(pred), M, N, C, cap, cb,
      static_cast<float*>(ahat), static_cast<float*>(bhat));
  return static_cast<int>(cudaGetLastError());
}

// best, second, idx, col_idx, cur_valid, has_depth, uv, anchor, sigma2,
// prev_lm_id, map_valid, map_pos, cam_T_ref, fxycxy, X_world, cTr, f, obs
// rows, with_lm, mask3d, with_lm float, mask3d float, packed, counters (2
// ints, zero, read as one 8-byte aligned 64-bit counter), M, N, C, cap,
// max_dist, ratio, stream. cTr and f must be 16-byte aligned; M < 2^22
// (the counter's fields), C <= MAX_C (the cameras' table in shared
// memory). M = 0 launches one block, which writes the two
// counts as zeros
extern "C" int mc_track_epilogue(
    const void* best, const void* second, const void* idx,
    const void* col_idx, const void* cur_valid, const void* has_depth,
    const void* uv, const void* anchor, const void* sigma2,
    const void* prev_lm_id, const void* map_valid, const void* map_pos,
    const void* cam, const void* fxy, void* X_out, void* cam_out,
    void* f_out, void* obs, void* with_out, void* mask3d_out, void* with_f,
    void* mask3d_f, void* packed, void* counters, int M, int N, int C,
    int cap, float max_dist, float ratio, void* stream) {
  if (M < 0 || M >= (1 << 22) || N < 1 || C < 1 || C > MAX_C || cap < 1)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(cam_out) & 15) ||
      (reinterpret_cast<uintptr_t>(f_out) & 15) ||
      (reinterpret_cast<uintptr_t>(counters) & 7))
    return cudaErrorMisalignedAddress;
  const int grid = M == 0 ? 1 : (M + EPI_ROWS - 1) / EPI_ROWS;
  track_epilogue_kernel<<<grid, EPI_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(best), static_cast<const float*>(second),
      static_cast<const int*>(idx), static_cast<const int*>(col_idx),
      static_cast<const bool*>(cur_valid),
      static_cast<const bool*>(has_depth), static_cast<const float*>(uv),
      static_cast<const int*>(anchor), static_cast<const float*>(sigma2),
      static_cast<const int*>(prev_lm_id),
      static_cast<const bool*>(map_valid),
      static_cast<const float*>(map_pos), static_cast<const float*>(cam),
      static_cast<const float*>(fxy), M, N, C, cap, max_dist, ratio,
      static_cast<float*>(X_out), static_cast<float*>(cam_out),
      static_cast<float*>(f_out), static_cast<float*>(obs),
      static_cast<bool*>(with_out), static_cast<bool*>(mask3d_out),
      static_cast<float*>(with_f), static_cast<float*>(mask3d_f),
      static_cast<float*>(packed),
      static_cast<unsigned long long*>(counters));
  return static_cast<int>(cudaGetLastError());
}

// uv, anchor, im_valid, cand_ids, cand_valid, map_pos, map_desc,
// map_normal, cam_T_ref, fxycxy, T_wr, lm_desc (16-byte aligned), ahat,
// bhat, lm_pos, M, L, C, cap, width, height, min_cos, stream
extern "C" int mc_localmap_gate(const void* uv, const void* anchor,
                                const void* im_valid, const void* cand_ids,
                                const void* cand_valid, const void* map_pos,
                                const void* map_desc, const void* map_normal,
                                const void* cam, const void* fxy,
                                const void* T_wr, void* lm_desc, void* ahat,
                                void* bhat, void* lm_pos, int M, int L, int C,
                                int cap, float width, float height,
                                float min_cos, void* stream) {
  if (M < 0 || L < 0 || C < 1 || C > MAX_C || cap < 1)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(lm_desc) & 15)
    return cudaErrorMisalignedAddress;
  const int cols = LM_THREADS / LM_LANES;
  const int cb = (L + cols - 1) / cols;
  const int grid = cb + (M + LM_THREADS - 1) / LM_THREADS;
  if (grid == 0) return 0;
  localmap_gate_kernel<<<grid, LM_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(uv), static_cast<const int*>(anchor),
      static_cast<const bool*>(im_valid), static_cast<const int*>(cand_ids),
      static_cast<const bool*>(cand_valid),
      static_cast<const float*>(map_pos), static_cast<const int*>(map_desc),
      static_cast<const float*>(map_normal), static_cast<const float*>(cam),
      static_cast<const float*>(fxy), static_cast<const float*>(T_wr), M, L,
      C, cap, width, height, min_cos, cb, static_cast<int*>(lm_desc),
      static_cast<float*>(ahat), static_cast<float*>(bhat),
      static_cast<float*>(lm_pos));
  return static_cast<int>(cudaGetLastError());
}

// best, second, idx, im_valid, cand_ids, lm_pos (localmap_gate's), map_pos,
// inter-frame obs rows, obs rows, mask, lm, M, L, max_dist, stream
extern "C" int mc_localmap_epilogue(const void* best, const void* second,
                                    const void* idx, const void* im_valid,
                                    const void* cand_ids, const void* lm_pos,
                                    const void* map_pos, const void* obs_in,
                                    void* obs, void* mask_f, void* lm_out,
                                    int M, int L, float max_dist,
                                    void* stream) {
  if (M < 0 || L < 1) return cudaErrorInvalidValue;
  if (M == 0) return 0;
  localmap_epilogue_kernel<<<(M + LE_ROWS - 1) / LE_ROWS, LE_THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(best), static_cast<const float*>(second),
      static_cast<const int*>(idx), static_cast<const bool*>(im_valid),
      static_cast<const int*>(cand_ids), static_cast<const float*>(lm_pos),
      static_cast<const float*>(map_pos), static_cast<const float*>(obs_in),
      M, L, max_dist, static_cast<float*>(obs), static_cast<float*>(mask_f),
      static_cast<int*>(lm_out));
  return static_cast<int>(cudaGetLastError());
}
