// Window-BA linearization of a keyframe-blocked observation table.
//
// Replaces: mcslam_tpu/ops/ba_pallas.py linearize_payload_pallas
// (_linpay_kernel), the math of backend/ba.py
// _residuals_and_jacobians_blocked plus the payload / Hpp / gp assembly of
// _assemble(kf_blocked=True).
//
// Computes, for every observation o = k * Ok + i of keyframe k: the
// reprojection residual r (2) of landmark lm_pos[obs_lm[o]] seen by rig
// camera obs_cam[o] from keyframe pose ref_T_world = rTw12[k] (z clamped
// at 1e-3), the analytic pose Jacobian Jp (2x6, right retraction:
// dq/domega = hat(q), dq/dv = -I) and landmark Jacobian Jl (2x3), the
// weight w = huber(|r|) / max(sigma2, 1e-6) * validf, the 30-channel
// payload [W = w Jp^T Jl (6x3 row-major) | Hll = w Jl^T Jl (3x3) |
// gl = w Jl^T r (3)] written channel-major as (K, 30, Ok), and per
// keyframe the sums Hpp = sum w Jp^T Jp (the 21 upper-triangle entries,
// mirrored, so it is exactly symmetric) and gp = sum w Jp^T r.
//
// Bound on the card: launch and latency. At the stage C shape (K = 6,
// Ok = 1365, C = 4) the kernel reads ~50 B and writes ~130 B per
// observation, ~1.5 MB in all: a few microseconds of HBM time, and
// ~1 MFLOP. Design: one thread per observation, grid (ceil(Ok/128), K),
// so the whole table is one wave on 132 SMs. Each thread gathers its own
// landmark row and reads its camera row from a shared-memory copy of the
// rig tables (the TPU kernel took pre-gathered per-observation rows
// because its row gathers lower poorly; a gather equals the one-hot row
// product exactly). The payload is written straight to the layout the
// landmark one-hot product consumes, consecutive threads on consecutive
// observations (coalesced). The per-keyframe sums are a fixed-order
// warp-shuffle + shared-memory reduction into per-block partials, which a
// second small kernel adds up in block order: no float atomics, so the
// result is bitwise the same from run to run and the LM's accept/reject
// on costs stays reproducible. The ragged tail (o >= Ok) is a bounds
// check in place of the TPU's lane padding.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int MAXC = 8;    // rig cameras held in shared memory
constexpr int NPAY = 30;   // payload channels
constexpr int NSUM = 27;   // 21 Hpp upper triangle + 6 gp

__global__ void __launch_bounds__(THREADS)
linearize_kernel(const float* __restrict__ rTw12, const float* __restrict__ lm_pos,
                 const int* __restrict__ obs_lm, const int* __restrict__ obs_cam,
                 const float* __restrict__ uv, const float* __restrict__ sigma2,
                 const float* __restrict__ validf, const float* __restrict__ Rc9,
                 const float* __restrict__ tc3, const float* __restrict__ f4,
                 float* __restrict__ payload, float* __restrict__ r_out,
                 float* __restrict__ w_out, float* __restrict__ partials,
                 int Ok, int L, int C, float huber) {
  __shared__ float s_pose[12];
  __shared__ float s_Rc[MAXC * 9];
  __shared__ float s_tc[MAXC * 3];
  __shared__ float s_f[MAXC * 4];
  __shared__ float s_red[NWARPS][NSUM];

  const int tid = threadIdx.x;
  const int k = blockIdx.y;
  const int nblk = gridDim.x;
  if (tid < 12) s_pose[tid] = rTw12[k * 12 + tid];
  for (int i = tid; i < C * 9; i += THREADS) s_Rc[i] = Rc9[i];
  for (int i = tid; i < C * 3; i += THREADS) s_tc[i] = tc3[i];
  for (int i = tid; i < C * 4; i += THREADS) s_f[i] = f4[i];
  __syncthreads();

  float acc[NSUM];
#pragma unroll
  for (int v = 0; v < NSUM; ++v) acc[v] = 0.0f;

  const int i_loc = blockIdx.x * THREADS + tid;
  if (i_loc < Ok) {
    const size_t o = (size_t)k * Ok + i_loc;
    const int l = min(max(obs_lm[o], 0), L - 1);
    const int c = min(max(obs_cam[o], 0), C - 1);
    const float* R = s_pose;  // ref_T_world rotation, row-major
    const float X0 = lm_pos[3 * (size_t)l + 0];
    const float X1 = lm_pos[3 * (size_t)l + 1];
    const float X2 = lm_pos[3 * (size_t)l + 2];
    float q[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      q[a] = R[3 * a] * X0 + R[3 * a + 1] * X1 + R[3 * a + 2] * X2 + s_pose[9 + a];
    const float* Rc = s_Rc + 9 * c;
    float p[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      p[a] = Rc[3 * a] * q[0] + Rc[3 * a + 1] * q[1] + Rc[3 * a + 2] * q[2] + s_tc[3 * c + a];
    const float fx = s_f[4 * c], fy = s_f[4 * c + 1];
    const float cx = s_f[4 * c + 2], cy = s_f[4 * c + 3];
    const float inv_z = 1.0f / fmaxf(p[2], 1e-3f);
    const float r0 = p[0] * inv_z * fx + cx - uv[2 * o];
    const float r1 = p[1] * inv_z * fy + cy - uv[2 * o + 1];

    // A = Jproj Rc (2x3)
    const float jp00 = fx * inv_z, jp02 = -fx * p[0] * inv_z * inv_z;
    const float jp11 = fy * inv_z, jp12 = -fy * p[1] * inv_z * inv_z;
    float A[2][3];
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      A[0][b] = jp00 * Rc[b] + jp02 * Rc[6 + b];
      A[1][b] = jp11 * Rc[3 + b] + jp12 * Rc[6 + b];
    }
    // Jp = [A hat(q) | -A], Jl = A R
    float Jp[2][6], Jl[2][3];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      Jp[a][0] = A[a][1] * q[2] - A[a][2] * q[1];
      Jp[a][1] = -A[a][0] * q[2] + A[a][2] * q[0];
      Jp[a][2] = A[a][0] * q[1] - A[a][1] * q[0];
      Jp[a][3] = -A[a][0];
      Jp[a][4] = -A[a][1];
      Jp[a][5] = -A[a][2];
#pragma unroll
      for (int cc = 0; cc < 3; ++cc)
        Jl[a][cc] = A[a][0] * R[cc] + A[a][1] * R[3 + cc] + A[a][2] * R[6 + cc];
    }
    const float rn = sqrtf(r0 * r0 + r1 * r1);
    const float wh = rn <= huber ? 1.0f : huber / fmaxf(rn, 1e-9f);
    const float w = wh / fmaxf(sigma2[o], 1e-6f) * validf[o];

    float* pay = payload + (size_t)k * NPAY * Ok + i_loc;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float a0 = w * Jp[0][i], a1 = w * Jp[1][i];
#pragma unroll
      for (int j = 0; j < 3; ++j) pay[(size_t)(3 * i + j) * Ok] = a0 * Jl[0][j] + a1 * Jl[1][j];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float a0 = w * Jl[0][i], a1 = w * Jl[1][i];
#pragma unroll
      for (int j = 0; j < 3; ++j) pay[(size_t)(18 + 3 * i + j) * Ok] = a0 * Jl[0][j] + a1 * Jl[1][j];
    }
    const float wr0 = w * r0, wr1 = w * r1;
#pragma unroll
    for (int i = 0; i < 3; ++i) pay[(size_t)(27 + i) * Ok] = wr0 * Jl[0][i] + wr1 * Jl[1][i];
    r_out[2 * o] = r0;
    r_out[2 * o + 1] = r1;
    w_out[o] = w;

    int v = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float a0 = w * Jp[0][i], a1 = w * Jp[1][i];
#pragma unroll
      for (int j = i; j < 6; ++j) acc[v++] = a0 * Jp[0][j] + a1 * Jp[1][j];
      acc[21 + i] = a0 * r0 + a1 * r1;
    }
  }

  // fixed-order block reduction: butterfly within each warp, then warps
  // in index order
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int v = 0; v < NSUM; ++v) {
    float s = acc[v];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) s_red[warp][v] = s;
  }
  __syncthreads();
  if (tid < NSUM) {
    float s = s_red[0][tid];
#pragma unroll
    for (int wi = 1; wi < NWARPS; ++wi) s += s_red[wi][tid];
    partials[((size_t)k * nblk + blockIdx.x) * NSUM + tid] = s;
  }
}

// Sums the per-block partials of each keyframe in block order and writes
// Hpp (36, upper triangle mirrored) and gp (6).
__global__ void finish_kernel(const float* __restrict__ partials, int nblk,
                              float* __restrict__ Hpp, float* __restrict__ gp) {
  const int k = blockIdx.x;
  const int v = threadIdx.x;
  if (v >= NSUM) return;
  float s = 0.0f;
  for (int b = 0; b < nblk; ++b) s += partials[((size_t)k * nblk + b) * NSUM + v];
  if (v >= 21) {
    gp[k * 6 + (v - 21)] = s;
    return;
  }
  int i = 0, rem = v;
  while (rem >= 6 - i) {
    rem -= 6 - i;
    ++i;
  }
  const int j = i + rem;
  Hpp[k * 36 + 6 * i + j] = s;
  Hpp[k * 36 + 6 * j + i] = s;
}

}  // namespace

extern "C" int mc_ba_linearize(const float* rTw12, const float* lm_pos,
                               const int* obs_lm, const int* obs_cam,
                               const float* uv, const float* sigma2,
                               const float* validf, const float* Rc9,
                               const float* tc3, const float* f4,
                               float* payload, float* r, float* w, float* Hpp,
                               float* gp, float* partials, int K, int Ok,
                               int L, int C, float huber, void* stream) {
  if (K == 0) return 0;
  if (C < 1 || C > MAXC || L < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nblk = Ok > 0 ? (Ok + THREADS - 1) / THREADS : 1;
  linearize_kernel<<<dim3(nblk, K), THREADS, 0, s>>>(
      rTw12, lm_pos, obs_lm, obs_cam, uv, sigma2, validf, Rc9, tc3, f4,
      payload, r, w, partials, Ok, L, C, huber);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finish_kernel<<<K, 32, 0, s>>>(partials, nblk, Hpp, gp);
  return (int)cudaGetLastError();
}
