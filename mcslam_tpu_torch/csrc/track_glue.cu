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
//    sum of three products added left to right), once per block; for
//    each previous feature n its landmark prev_lm_id[n] (-1: none) looked
//    up in the map mirror, p = R_cw X + t_cw, u = clamp(p_x / max(p_z,
//    1e-6) fx + cx, +-1e5) (v likewise), pen = p_z <= 0.05; the gate
//    factors of ops/match_cuda.hamming_argmin2 (DG = 3 C + 2):
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
//    counts of ok and with_lm (slots 17, 18; integer atomics, exact, then
//    the last block to arrive writes them and leaves its three counters
//    at zero) and ok, idx, lm as floats (slots 21 ..);
//  - localmap_gate: the candidates' map rows (position, descriptor words,
//    normal) by id; rTw = se3_inverse(T_wr) once per block, p_ref = rTw
//    X, p_c = cam_T_ref[c] p_ref, z_s = z > 0.05 ? z : 1, the projection
//    p / z_s f + c, visible where z > 0.05 and inside [0, W) x [0, H) and
//    the viewing cone holds (view = (X - t_wr) / max(|X - t_wr|, 1e-9),
//    cos = view . n > min_cos, or |n| <= 1e-6); the gate factors as
//    above with pen = not visible, the projections clamped to +-1e5 and
//    no pass row;
//  - localmap_epilogue: ok = best <= max_dist & best <= second & valid,
//    lm = ok ? cand_ids[idx] : -1, X_world = map_pos[max(lm, 0)], pose_lm's
//    rows (X, then rows 3-21 of the inter-frame rows: the same features,
//    anchors and sigmas) and its mask lm >= 0.
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
// below 0.01 us at 67 TFLOP/s; each kernel takes 2-5 us on an H100. So each kernel is one thread per row or
// column, 128 a block, the gates' row blocks and column blocks in one
// grid; the per-block poses in shared memory; ahat staged in shared memory
// so that a block's rows go out as one contiguous run.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_C = 4;               // (match_cuda.DG_MAX - 2) / 3
constexpr int MAX_DG = 3 * MAX_C + 2;  // gate factors at MAX_C cameras
constexpr int OBS_ROWS = 22;           // pose_lm's observation rows
constexpr float PASS_BIAS = 1e13f;     // ops/match_cuda.PASS_BIAS
constexpr float GATE_BIG = 1e12f;      // tracking_kernels._GATE_BIG
constexpr unsigned FULL = 0xffffffffu;

// atomicAdd of 1 with release and acquire semantics at device scope (as in
// ransac_score.cu): a block's count atomics, issued before it, are seen by
// the last block after its own
__device__ __forceinline__ int add_acq_rel(int* p) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
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

// the rows of ahat (M, DG) of rows [m0, m0 + THREADS): -2 oh u, -2 oh v
// per camera, oh, u^2 + v^2 + 4 PB row_invalid, 1; staged in shared
// memory, then written as one contiguous run
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
  const int n = min(THREADS, M - m0) * DG;
  float* out = ahat + static_cast<long long>(m0) * DG;
  for (int k = tid; k < n; k += THREADS) out[k] = s_a[k];
}

// one column's gate factors: rows 2c, 2c + 1 the projection, 2C + c its
// squared norm with the penalty, 3C a one, 3C + 1 the column's bias
__device__ __forceinline__ void write_bhat_col(float* __restrict__ bhat,
                                               int N, int C, int n,
                                               const float* pu,
                                               const float* pv,
                                               const float* pen,
                                               float bias) {
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) {
    if (c < C) {
      bhat[static_cast<long long>(2 * c) * N + n] = pu[c];
      bhat[static_cast<long long>(2 * c + 1) * N + n] = pv[c];
      bhat[static_cast<long long>(2 * C + c) * N + n] =
          (pu[c] * pu[c] + pv[c] * pv[c]) + GATE_BIG * pen[c];
    }
  }
  bhat[static_cast<long long>(3 * C) * N + n] = 1.0f;
  bhat[static_cast<long long>(3 * C + 1) * N + n] = bias;
}

// blocks [0, row_blocks) write ahat's rows, the rest bhat's columns
__global__ void __launch_bounds__(THREADS) track_gate_kernel(
    const float* __restrict__ uv, const int* __restrict__ anchor,
    const bool* __restrict__ cur_valid, const int* __restrict__ prev_lm_id,
    const bool* __restrict__ prev_valid, const float* __restrict__ map_pos,
    const bool* __restrict__ map_valid, const float* __restrict__ cam,
    const float* __restrict__ fxy, const float* __restrict__ pred, int M,
    int N, int C, int cap, int row_blocks, float* __restrict__ ahat,
    float* __restrict__ bhat) {
  __shared__ float s_a[THREADS * MAX_DG];
  __shared__ float s_cw[MAX_C][12];
  __shared__ float s_f[MAX_C][4];
  const int tid = threadIdx.x;
  if (static_cast<int>(blockIdx.x) < row_blocks) {
    write_ahat(uv, anchor, cur_valid, M, C, blockIdx.x * THREADS, ahat, s_a);
    return;
  }
  if (tid < C) {
    // cam_T_w = cam_T_ref[c] @ se3_inverse(pred), rows 0-2
    float inv[12];
    se3_inverse12(pred, inv);
    const float* T = cam + 16 * tid;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        s_cw[tid][3 * i + j] = dot3(T[4 * i], T[4 * i + 1], T[4 * i + 2],
                                    inv[j], inv[3 + j], inv[6 + j]);
      s_cw[tid][9 + i] = dot3(T[4 * i], T[4 * i + 1], T[4 * i + 2], inv[9],
                              inv[10], inv[11]) + T[4 * i + 3];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) s_f[tid][k] = fxy[4 * tid + k];
  }
  __syncthreads();
  const int n = (static_cast<int>(blockIdx.x) - row_blocks) * THREADS + tid;
  if (n >= N) return;
  const int id = prev_lm_id[n];
  const int safe = clampi(id, 0, cap - 1);
  const bool has = id >= 0 && map_valid[safe];
  const float X0 = map_pos[3 * safe], X1 = map_pos[3 * safe + 1],
              X2 = map_pos[3 * safe + 2];
  float pu[MAX_C], pv[MAX_C], pen[MAX_C];
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) {
    if (c < C) {
      const float* w = s_cw[c];
      const float p0 = dot3(w[0], w[1], w[2], X0, X1, X2) + w[9];
      const float p1 = dot3(w[3], w[4], w[5], X0, X1, X2) + w[10];
      const float p2 = dot3(w[6], w[7], w[8], X0, X1, X2) + w[11];
      const float zc = p2 < 1e-6f ? 1e-6f : p2;
      pu[c] = clampf(p0 / zc * s_f[c][0] + s_f[c][2], -1e5f, 1e5f);
      pv[c] = clampf(p1 / zc * s_f[c][1] + s_f[c][3], -1e5f, 1e5f);
      pen[c] = p2 <= 0.05f ? 1.0f : 0.0f;
    }
  }
  const float ci = prev_valid[n] ? 0.0f : 1.0f;
  const float cp = has ? 0.0f : 1.0f;
  write_bhat_col(bhat, N, C, n, pu, pv, pen,
                 2e13f * ci - PASS_BIAS * cp);
}

__global__ void __launch_bounds__(THREADS) localmap_gate_kernel(
    const float* __restrict__ uv, const int* __restrict__ anchor,
    const bool* __restrict__ im_valid, const int* __restrict__ cand_ids,
    const bool* __restrict__ cand_valid, const float* __restrict__ map_pos,
    const int* __restrict__ map_desc, const float* __restrict__ map_normal,
    const float* __restrict__ cam, const float* __restrict__ fxy,
    const float* __restrict__ T_wr, int M, int L, int C, int cap,
    float width, float height, float min_cos, int row_blocks,
    int* __restrict__ lm_desc, float* __restrict__ ahat,
    float* __restrict__ bhat) {
  __shared__ float s_a[THREADS * MAX_DG];
  __shared__ float s_inv[12];
  __shared__ float s_t[3];
  __shared__ float s_cam[MAX_C][12];
  __shared__ float s_f[MAX_C][4];
  const int tid = threadIdx.x;
  if (static_cast<int>(blockIdx.x) < row_blocks) {
    write_ahat(uv, anchor, im_valid, M, C, blockIdx.x * THREADS, ahat, s_a);
    return;
  }
  if (tid == 0) {
    se3_inverse12(T_wr, s_inv);
    s_t[0] = T_wr[3];
    s_t[1] = T_wr[7];
    s_t[2] = T_wr[11];
  }
  if (tid < C) {
    const float* T = cam + 16 * tid;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int k = 0; k < 3; ++k) s_cam[tid][3 * i + k] = T[4 * i + k];
      s_cam[tid][9 + i] = T[4 * i + 3];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) s_f[tid][k] = fxy[4 * tid + k];
  }
  __syncthreads();
  const int l = (static_cast<int>(blockIdx.x) - row_blocks) * THREADS + tid;
  if (l >= L) return;
  const int id = clampi(cand_ids[l], 0, cap - 1);
#pragma unroll
  for (int k = 0; k < 8; ++k) lm_desc[8 * l + k] = map_desc[8 * id + k];
  const float X0 = map_pos[3 * id], X1 = map_pos[3 * id + 1],
              X2 = map_pos[3 * id + 2];
  const float n0 = map_normal[3 * id], n1 = map_normal[3 * id + 1],
              n2 = map_normal[3 * id + 2];
  // the viewing cone
  float v0 = X0 - s_t[0], v1 = X1 - s_t[1], v2 = X2 - s_t[2];
  float vn = __fsqrt_rn(dot3(v0, v1, v2, v0, v1, v2));
  vn = vn < 1e-9f ? 1e-9f : vn;
  v0 = v0 / vn;
  v1 = v1 / vn;
  v2 = v2 / vn;
  const bool has_n = __fsqrt_rn(dot3(n0, n1, n2, n0, n1, n2)) > 1e-6f;
  const bool cone = dot3(v0, v1, v2, n0, n1, n2) > min_cos || !has_n;
  // the reference frame, then each camera
  const float* r = s_inv;
  const float q0 = dot3(r[0], r[1], r[2], X0, X1, X2) + r[9];
  const float q1 = dot3(r[3], r[4], r[5], X0, X1, X2) + r[10];
  const float q2 = dot3(r[6], r[7], r[8], X0, X1, X2) + r[11];
  float pu[MAX_C], pv[MAX_C], pen[MAX_C];
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) {
    if (c < C) {
      const float* w = s_cam[c];
      const float p0 = dot3(w[0], w[1], w[2], q0, q1, q2) + w[9];
      const float p1 = dot3(w[3], w[4], w[5], q0, q1, q2) + w[10];
      const float z = dot3(w[6], w[7], w[8], q0, q1, q2) + w[11];
      const float zs = z > 0.05f ? z : 1.0f;
      const float u = p0 / zs * s_f[c][0] + s_f[c][2];
      const float v = p1 / zs * s_f[c][1] + s_f[c][3];
      const bool vis = z > 0.05f && u >= 0.0f && u < width && v >= 0.0f &&
                       v < height && cone;
      pu[c] = clampf(u, -1e5f, 1e5f);
      pv[c] = clampf(v, -1e5f, 1e5f);
      pen[c] = vis ? 0.0f : 1.0f;
    }
  }
  write_bhat_col(bhat, L, C, l, pu, pv, pen,
                 2e13f * (cand_valid[l] ? 0.0f : 1.0f));
}

__global__ void __launch_bounds__(THREADS) track_epilogue_kernel(
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
    float* __restrict__ packed, int* __restrict__ counters) {
  __shared__ int s_ok[WARPS], s_with[WARPS];
  const int tid = threadIdx.x;
  const int m = blockIdx.x * THREADS + tid;
  bool ok = false, with = false;
  if (m < M) {
    const int j_raw = idx[m];
    const int j = clampi(j_raw, 0, N - 1);
    const float b = best[m];
    ok = col_idx[j] == m && b <= max_dist && b <= ratio * second[m] &&
         cur_valid[m];
    const int lm0 = ok ? prev_lm_id[j] : -1;
    const int safe = clampi(lm0, 0, cap - 1);
    with = lm0 >= 0 && map_valid[safe];
    const bool m3 = with && has_depth[m];
    const float X0 = map_pos[3 * safe], X1 = map_pos[3 * safe + 1],
                X2 = map_pos[3 * safe + 2];
    const int a = clampi(anchor[m], 0, C - 1);
    const float* T = cam + 16 * a;
    const float* f = fxy + 4 * a;
    X_out[3 * m] = X0;
    X_out[3 * m + 1] = X1;
    X_out[3 * m + 2] = X2;
#pragma unroll
    for (int k = 0; k < 16; ++k) cam_out[16 * m + k] = T[k];
#pragma unroll
    for (int k = 0; k < 4; ++k) f_out[4 * m + k] = f[k];
    // pose_lm's rows: X, uv, R (row-major), t, f, 1 / sigma^2
    const long long Ml = M;
    obs[0 * Ml + m] = X0;
    obs[1 * Ml + m] = X1;
    obs[2 * Ml + m] = X2;
    obs[3 * Ml + m] = uv[2 * m];
    obs[4 * Ml + m] = uv[2 * m + 1];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int k = 0; k < 3; ++k) obs[(5 + 3 * i + k) * Ml + m] = T[4 * i + k];
      obs[(14 + i) * Ml + m] = T[4 * i + 3];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) obs[(17 + k) * Ml + m] = f[k];
    obs[21 * Ml + m] = 1.0f / sigma2[m];
    with_out[m] = with;
    mask3d_out[m] = m3;
    with_f[m] = with ? 1.0f : 0.0f;
    mask3d_f[m] = m3 ? 1.0f : 0.0f;
    packed[21 + m] = ok ? 1.0f : 0.0f;
    packed[21 + Ml + m] = static_cast<float>(j_raw);
    packed[21 + 2 * Ml + m] = static_cast<float>(with ? lm0 : -1);
  }
  // the counts: a ballot per warp, the block's sum, one atomic each
  const unsigned b_ok = __ballot_sync(FULL, ok);
  const unsigned b_with = __ballot_sync(FULL, with);
  if ((tid & 31) == 0) {
    s_ok[tid >> 5] = __popc(b_ok);
    s_with[tid >> 5] = __popc(b_with);
  }
  __syncthreads();
  if (tid == 0) {
    int n_ok = 0, n_with = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      n_ok += s_ok[w];
      n_with += s_with[w];
    }
    if (n_ok) atomicAdd(counters, n_ok);
    if (n_with) atomicAdd(counters + 1, n_with);
    if (add_acq_rel(counters + 2) == static_cast<int>(gridDim.x) - 1) {
      // the last block to arrive: every count is in; both written as
      // floats, and the three counters left at zero for the next launch
      packed[17] = static_cast<float>(atomicExch(counters, 0));
      packed[18] = static_cast<float>(atomicExch(counters + 1, 0));
      atomicExch(counters + 2, 0);
    }
  }
}

__global__ void __launch_bounds__(THREADS) localmap_epilogue_kernel(
    const float* __restrict__ best, const float* __restrict__ second,
    const int* __restrict__ idx, const bool* __restrict__ im_valid,
    const int* __restrict__ cand_ids, const float* __restrict__ map_pos,
    const float* __restrict__ obs_in, int M, int L, int cap, float max_dist,
    float* __restrict__ obs, float* __restrict__ mask_f,
    int* __restrict__ lm_out) {
  const int m = blockIdx.x * THREADS + threadIdx.x;
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

inline int blocks(int n) { return (n + THREADS - 1) / THREADS; }

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
  const int rb = blocks(M), grid = rb + blocks(N);
  if (grid == 0) return 0;
  track_gate_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(uv), static_cast<const int*>(anchor),
      static_cast<const bool*>(cur_valid),
      static_cast<const int*>(prev_lm_id),
      static_cast<const bool*>(prev_valid),
      static_cast<const float*>(map_pos), static_cast<const bool*>(map_valid),
      static_cast<const float*>(cam), static_cast<const float*>(fxy),
      static_cast<const float*>(pred), M, N, C, cap, rb,
      static_cast<float*>(ahat), static_cast<float*>(bhat));
  return static_cast<int>(cudaGetLastError());
}

// best, second, idx, col_idx, cur_valid, has_depth, uv, anchor, sigma2,
// prev_lm_id, map_valid, map_pos, cam_T_ref, fxycxy, X_world, cTr, f, obs
// rows, with_lm, mask3d, with_lm float, mask3d float, packed, counters (3
// ints, zero), M, N, C, cap, max_dist, ratio, stream
extern "C" int mc_track_epilogue(
    const void* best, const void* second, const void* idx,
    const void* col_idx, const void* cur_valid, const void* has_depth,
    const void* uv, const void* anchor, const void* sigma2,
    const void* prev_lm_id, const void* map_valid, const void* map_pos,
    const void* cam, const void* fxy, void* X_out, void* cam_out,
    void* f_out, void* obs, void* with_out, void* mask3d_out, void* with_f,
    void* mask3d_f, void* packed, void* counters, int M, int N, int C,
    int cap, float max_dist, float ratio, void* stream) {
  if (M < 0 || N < 1 || C < 1 || cap < 1) return cudaErrorInvalidValue;
  if (M == 0) return 0;
  track_epilogue_kernel<<<blocks(M), THREADS, 0,
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
      static_cast<float*>(packed), static_cast<int*>(counters));
  return static_cast<int>(cudaGetLastError());
}

// uv, anchor, im_valid, cand_ids, cand_valid, map_pos, map_desc,
// map_normal, cam_T_ref, fxycxy, T_wr, lm_desc, ahat, bhat, M, L, C, cap,
// width, height, min_cos, stream
extern "C" int mc_localmap_gate(const void* uv, const void* anchor,
                                const void* im_valid, const void* cand_ids,
                                const void* cand_valid, const void* map_pos,
                                const void* map_desc, const void* map_normal,
                                const void* cam, const void* fxy,
                                const void* T_wr, void* lm_desc, void* ahat,
                                void* bhat, int M, int L, int C, int cap,
                                float width, float height, float min_cos,
                                void* stream) {
  if (M < 0 || L < 0 || C < 1 || C > MAX_C || cap < 1)
    return cudaErrorInvalidValue;
  const int rb = blocks(M), grid = rb + blocks(L);
  if (grid == 0) return 0;
  localmap_gate_kernel<<<grid, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(uv), static_cast<const int*>(anchor),
      static_cast<const bool*>(im_valid), static_cast<const int*>(cand_ids),
      static_cast<const bool*>(cand_valid),
      static_cast<const float*>(map_pos), static_cast<const int*>(map_desc),
      static_cast<const float*>(map_normal), static_cast<const float*>(cam),
      static_cast<const float*>(fxy), static_cast<const float*>(T_wr), M, L,
      C, cap, width, height, min_cos, rb, static_cast<int*>(lm_desc),
      static_cast<float*>(ahat), static_cast<float*>(bhat));
  return static_cast<int>(cudaGetLastError());
}

// best, second, idx, im_valid, cand_ids, map_pos, inter-frame obs rows,
// obs rows, mask, lm, M, L, cap, max_dist, stream
extern "C" int mc_localmap_epilogue(const void* best, const void* second,
                                    const void* idx, const void* im_valid,
                                    const void* cand_ids, const void* map_pos,
                                    const void* obs_in, void* obs,
                                    void* mask_f, void* lm_out, int M, int L,
                                    int cap, float max_dist, void* stream) {
  if (M < 0 || L < 1 || cap < 1) return cudaErrorInvalidValue;
  if (M == 0) return 0;
  localmap_epilogue_kernel<<<blocks(M), THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(best), static_cast<const float*>(second),
      static_cast<const int*>(idx), static_cast<const bool*>(im_valid),
      static_cast<const int*>(cand_ids), static_cast<const float*>(map_pos),
      static_cast<const float*>(obs_in), M, L, cap, max_dist,
      static_cast<float*>(obs), static_cast<float*>(mask_f),
      static_cast<int*>(lm_out));
  return static_cast<int>(cudaGetLastError());
}
