// Whole-schedule robust motion-only LM refine, one launch for a batch of
// initial poses.
//
// Replaces: mcslam_tpu/frontend/pose_opt_pallas.py optimize_pose_pallas
// (_pose_kernel, _linearize, _chol_solve6_s, _retract_s, _so3_exp_s).
//
// Computes, per candidate b, the deferred-accept LM schedule
// sched[0..n_rounds): each round linearizes at the current pose
// (Huber-weighted reprojection residuals of the active observations into
// the 21 lower-triangle entries of the 6x6 H, the 6 of g and the cost),
// then runs sched[round] steps of: damped unrolled Cholesky solve, right
// retraction on SE(3) (Rodrigues + left Jacobian with the same small-angle
// series), a linearization at the trial pose, accept if its cost is lower
// (lambda x 0.5) else keep the carried system (lambda x 4). After each
// round the active set becomes mask & (chi2 < chi2_thresh) at the accepted
// pose. Outputs the final pose and the per-observation chi2 at that pose.
//
// Bound on the card: latency. At the production shape (M = 2048, sched
// (8, 8)) the work is 18 dependent linearizations over 2048 observations
// of ~150 flops each (~6 MFLOP per candidate, 0.0003 ms at the f32 peak),
// each joined by a reduction of 28 sums and a scalar 6x6 solve; the floor
// is ~18 x (one observation's arithmetic + reduction + cluster barrier +
// solve), ~2 us each on an H100. Design:
//  - one thread-block cluster of CLUSTER CTAs per candidate (grid =
//    B x CLUSTER); each CTA owns a contiguous slice of ceil(M / CLUSTER)
//    observations, staged once into dynamic shared memory (22 SoA rows,
//    the mask and the active set) for the whole schedule: at M = 2048 one
//    observation per thread. Each thread only reads the slots it staged
//    itself, so staging needs no barrier;
//  - each pass: per-thread sums of the 28 entries, a warp reduce-scatter
//    (31 shuffles: lane k ends with the warp's sum of entry k), a
//    fixed-order sum over the CTA's warps, which the CTA stores into slot
//    [its rank] of every CTA's partials through distributed shared memory
//    (double-buffered by pass parity), ONE cluster barrier, and then each
//    CTA sums the slots in rank order from its own shared memory, so every
//    CTA holds bit-identical totals. (Storing before the barrier keeps
//    the remote latency off the path after it.);
//  - warp 0 of every CTA then runs the Cholesky, the retraction and the
//    accept/reject itself, in registers, on those identical totals, and
//    hands the trial pose to its CTA's other warps through shared memory:
//    no pose crosses CTAs, and there is no second cluster barrier. Square
//    roots and divisions of the solve and of the projection are the fast
//    rsqrtf / __fdividef (a few ulp; the plain version's float tolerance
//    absorbs them); sine and cosine are the precise sincospif, not the
//    fast intrinsics, as the plain version's are precise. No local memory;
//  - a first cluster barrier, split around the staging, makes sure every
//    CTA runs before a peer stores into its shared memory; after the last
//    pass's barrier no CTA touches a peer's, so CTAs exit freely.
// The sums run in a fixed order, so two runs give bitwise equal outputs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;  // CTAs per candidate (the portable cluster size)
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int NACC = 28;  // 21 H (lower triangle, row-major) + 6 g + cost
constexpr int MAX_ROUNDS = 4;
constexpr int SMEM_LIMIT = 232448;  // bytes a block may use on sm_90
constexpr float EPS_SMALL = 1e-8f;
constexpr float INV_PI = 0.318309886183790672f;

// data rows (see ops pack in frontend/pose_opt_cuda.py); the staged slice
// also holds the mask (row MASK) and the active set (row ACT)
enum {
  X0, X1, X2, U, V, C00, C01, C02, C10, C11, C12, C20, C21, C22,
  CT0, CT1, CT2, FX, FY, CX, CY, ISIG2, NROWS, MASK = NROWS, ACT, SROWS
};

struct Obs {
  float r0, r1;
  float j0[6], j1[6];
};

// residual (and Jacobian) of staged observation i at pose P (R row-major
// 9, t 3); d is the CTA's slice, S its row stride
__device__ __forceinline__ void residual_jac(const float* d, int S, int i,
                                             const float* P, Obs& o,
                                             bool want_jac) {
  const float* R = P;
  const float* t = P + 9;
  const float e0 = d[X0 * S + i] - t[0];
  const float e1 = d[X1 * S + i] - t[1];
  const float e2 = d[X2 * S + i] - t[2];
  const float q0 = R[0] * e0 + R[3] * e1 + R[6] * e2;
  const float q1 = R[1] * e0 + R[4] * e1 + R[7] * e2;
  const float q2 = R[2] * e0 + R[5] * e1 + R[8] * e2;
  const float c00 = d[C00 * S + i], c01 = d[C01 * S + i], c02 = d[C02 * S + i];
  const float c10 = d[C10 * S + i], c11 = d[C11 * S + i], c12 = d[C12 * S + i];
  const float c20 = d[C20 * S + i], c21 = d[C21 * S + i], c22 = d[C22 * S + i];
  const float p0 = c00 * q0 + c01 * q1 + c02 * q2 + d[CT0 * S + i];
  const float p1 = c10 * q0 + c11 * q1 + c12 * q2 + d[CT1 * S + i];
  const float p2 = c20 * q0 + c21 * q1 + c22 * q2 + d[CT2 * S + i];
  const float z = fmaxf(p2, 1e-3f);
  const float iz = __fdividef(1.0f, z);
  const float fx = d[FX * S + i], fy = d[FY * S + i];
  o.r0 = p0 * iz * fx + d[CX * S + i] - d[U * S + i];
  o.r1 = p1 * iz * fy + d[CY * S + i] - d[V * S + i];
  if (!want_jac) return;
  const float jp00 = fx * iz, jp02 = -fx * p0 * iz * iz;
  const float jp11 = fy * iz, jp12 = -fy * p1 * iz * iz;
  const float a00 = jp00 * c00 + jp02 * c20;
  const float a01 = jp00 * c01 + jp02 * c21;
  const float a02 = jp00 * c02 + jp02 * c22;
  const float a10 = jp11 * c10 + jp12 * c20;
  const float a11 = jp11 * c11 + jp12 * c21;
  const float a12 = jp11 * c12 + jp12 * c22;
  o.j0[0] = a01 * q2 - a02 * q1;
  o.j0[1] = -a00 * q2 + a02 * q0;
  o.j0[2] = a00 * q1 - a01 * q0;
  o.j0[3] = -a00;
  o.j0[4] = -a01;
  o.j0[5] = -a02;
  o.j1[0] = a11 * q2 - a12 * q1;
  o.j1[1] = -a10 * q2 + a12 * q0;
  o.j1[2] = a10 * q1 - a11 * q0;
  o.j1[3] = -a10;
  o.j1[4] = -a11;
  o.j1[5] = -a12;
}

// One stage of a warp reduce-scatter over v[0, 2 OFF): the lane with bit
// OFF set keeps the upper half, its partner the lower, each adding the
// other's copy; the kept half lands in v[0, OFF).
template <int OFF>
__device__ __forceinline__ void reduce_scatter_stage(float (&v)[32]) {
  const bool up = (threadIdx.x & OFF) != 0;
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const float send = up ? v[i] : v[i + OFF];
    const float keep = up ? v[i + OFF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

// Warp reduce-scatter of 32 per-lane values in 31 shuffles: lane l returns
// the warp's sum of v[l]. (Stages as template instances, so that every
// index is a constant and v stays in registers.)
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[32]) {
  reduce_scatter_stage<16>(v);
  reduce_scatter_stage<8>(v);
  reduce_scatter_stage<4>(v);
  reduce_scatter_stage<2>(v);
  reduce_scatter_stage<1>(v);
  return v[0];
}

// Cluster-wide linearization at pose P over the candidate's observations:
// warp 0 of every CTA returns the same 28 totals in out (the other warps
// return nothing). s_part holds [2 parities][CLUSTER ranks][32].
__device__ __forceinline__ void linearize(cg::cluster_group& cluster,
                                          const float* d, int S, int cnt,
                                          const float* P, float huber,
                                          float (*s_warp)[32], float* s_part,
                                          int& pass, float (&out)[NACC]) {
  float acc[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) acc[k] = 0.f;
  for (int i = threadIdx.x; i < cnt; i += THREADS) {
    Obs o;
    residual_jac(d, S, i, P, o, true);
    const float rr = fmaxf(o.r0 * o.r0 + o.r1 * o.r1, 1e-18f);
    const float irn = rsqrtf(rr);
    const float wh = rr * irn <= huber ? 1.0f : huber * irn;
    const float w = wh * d[ISIG2 * S + i] * d[ACT * S + i];
    int k = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
      for (int b = 0; b <= a; ++b)
        acc[k++] += w * (o.j0[a] * o.j0[b] + o.j1[a] * o.j1[b]);
#pragma unroll
    for (int a = 0; a < 6; ++a) acc[21 + a] += w * (o.j0[a] * o.r0 + o.j1[a] * o.r1);
    acc[27] += w * (o.r0 * o.r0 + o.r1 * o.r1);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float ws = warp_reduce_scatter(acc);
  if (lane < NACC) s_warp[warp][lane] = ws;
  __syncthreads();
  float* part = s_part + (pass & 1) * CLUSTER * 32;
  if (threadIdx.x < NACC) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) v += s_warp[w][threadIdx.x];
    float* slot = part + cluster.block_rank() * 32 + threadIdx.x;
#pragma unroll
    for (int q = 0; q < CLUSTER; ++q) *cluster.map_shared_rank(slot, q) = v;
  }
  ++pass;
  // the one barrier of the pass: every CTA's partials have landed in every
  // CTA (the other parity's slots are still read only by passes that every
  // CTA has left behind)
  cluster.sync();
  if (warp != 0) return;
  float tot = 0.f;
  if (lane < NACC) {
#pragma unroll
    for (int q = 0; q < CLUSTER; ++q) tot += part[q * 32 + lane];
  }
#pragma unroll
  for (int k = 0; k < NACC; ++k) out[k] = __shfl_sync(0xffffffffu, tot, k);
}

// The rotation angle of w, its reciprocal and its sine and cosine, shared
// by the exponential and the left Jacobian. sincospif(th / pi) is precise
// (not a fast intrinsic) and reduces its argument exactly; sinf / cosf
// would bring a Payne-Hanek slow path (|x| > 105615) with an array in
// local memory.
struct Angle {
  float t2, th, ith, sn, cs;
  bool small;
};

__device__ __forceinline__ Angle angle_of(float w0, float w1, float w2) {
  Angle r;
  r.t2 = w0 * w0 + w1 * w1 + w2 * w2;
  r.small = r.t2 < EPS_SMALL;
  const float tt = r.small ? 1.0f : r.t2;
  r.ith = rsqrtf(tt);
  r.th = tt * r.ith;
  sincospif(r.th * INV_PI, &r.sn, &r.cs);
  return r;
}

__device__ __forceinline__ void so3_exp_s(float w0, float w1, float w2,
                                          const Angle& an, float* E) {
  const float t2 = an.t2, ith = an.ith;
  const bool small = an.small;
  const float a = small ? 1.0f - t2 * (1.0f / 6.0f) + t2 * t2 * (1.0f / 120.0f)
                        : an.sn * ith;
  const float b = small ? 0.5f - t2 * (1.0f / 24.0f) + t2 * t2 * (1.0f / 720.0f)
                        : (1.0f - an.cs) * (ith * ith);
  const float ww0 = w0 * w0, ww1 = w1 * w1, ww2 = w2 * w2;
  E[0] = 1.0f + b * (-(ww1 + ww2));
  E[4] = 1.0f + b * (-(ww0 + ww2));
  E[8] = 1.0f + b * (-(ww0 + ww1));
  E[1] = -a * w2 + b * (w0 * w1);
  E[3] = a * w2 + b * (w0 * w1);
  E[2] = a * w1 + b * (w0 * w2);
  E[6] = -a * w1 + b * (w0 * w2);
  E[5] = -a * w0 + b * (w1 * w2);
  E[7] = a * w0 + b * (w1 * w2);
}

__device__ __forceinline__ void so3_left_jac_s(float w0, float w1, float w2,
                                               const Angle& an, float* J) {
  const float t2 = an.t2, ith = an.ith;
  const bool small = an.small;
  const float b = small ? 0.5f - t2 * (1.0f / 24.0f) : (1.0f - an.cs) * (ith * ith);
  const float c = small ? 1.0f / 6.0f - t2 * (1.0f / 120.0f)
                        : (an.th - an.sn) * (ith * ith * ith);
  const float ww0 = w0 * w0, ww1 = w1 * w1, ww2 = w2 * w2;
  J[0] = 1.0f + c * (-(ww1 + ww2));
  J[4] = 1.0f + c * (-(ww0 + ww2));
  J[8] = 1.0f + c * (-(ww0 + ww1));
  J[1] = -b * w2 + c * (w0 * w1);
  J[3] = b * w2 + c * (w0 * w1);
  J[2] = b * w1 + c * (w0 * w2);
  J[6] = -b * w1 + c * (w0 * w2);
  J[5] = -b * w0 + c * (w1 * w2);
  J[7] = b * w0 + c * (w1 * w2);
}

// trial = P retracted by xi = -(H + lam I)^-1 g (unrolled Cholesky)
__device__ __forceinline__ void lm_trial(const float* P, const float* H,
                                         const float* g, float lam,
                                         float* trial) {
  float L[6][6], inv[6];  // inv[i] = 1 / L[i][i]
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = H[i * (i + 1) / 2 + j] + (i == j ? lam : 0.0f);
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      if (i == j) {
        const float sc = fmaxf(s, 1e-12f);
        inv[i] = rsqrtf(sc);
        L[i][i] = sc * inv[i];
      } else {
        L[i][j] = s * inv[j];
      }
    }
  }
  float y[6], x[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s * inv[i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s = s - L[k][i] * x[k];
    x[i] = s * inv[i];
  }
  const float w0 = -x[0], w1 = -x[1], w2 = -x[2];
  const float v0 = -x[3], v1 = -x[4], v2 = -x[5];
  float E[9], J[9];
  const Angle an = angle_of(w0, w1, w2);
  so3_exp_s(w0, w1, w2, an, E);
  so3_left_jac_s(w0, w1, w2, an, J);
  const float te0 = J[0] * v0 + J[1] * v1 + J[2] * v2;
  const float te1 = J[3] * v0 + J[4] * v1 + J[5] * v2;
  const float te2 = J[6] * v0 + J[7] * v1 + J[8] * v2;
  const float* R = P;
  const float* t = P + 9;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      trial[3 * i + j] = R[3 * i + 0] * E[0 * 3 + j] +
                         R[3 * i + 1] * E[1 * 3 + j] +
                         R[3 * i + 2] * E[2 * 3 + j];
    trial[9 + i] = R[3 * i + 0] * te0 + R[3 * i + 1] * te1 +
                   R[3 * i + 2] * te2 + t[i];
  }
}

__device__ __forceinline__ float chi2_at(const float* d, int S, int i,
                                         const float* P) {
  Obs o;
  residual_jac(d, S, i, P, o, false);
  return (o.r0 * o.r0 + o.r1 * o.r1) * d[ISIG2 * S + i];
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
pose_lm_cluster_kernel(const float* __restrict__ T_init,
                       const float* __restrict__ data,
                       const float* __restrict__ mask,
                       float* __restrict__ T_out, float* __restrict__ chi2_out,
                       int M, int S, int n_rounds, int s0, int s1, int s2,
                       int s3, float huber, float chi2_thresh,
                       float lm_lambda) {
  extern __shared__ float s_obs[];  // SROWS x S
  __shared__ float s_warp[NWARPS][32];
  __shared__ float s_part[2 * CLUSTER * 32];  // [parity][rank][entry]
  __shared__ float s_pose[12];  // warp 0's pose for the CTA's other warps
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / CLUSTER;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int base = rank * S;
  const int cnt = max(0, min(S, M - base));

  // peers store into this CTA's shared memory from the first pass on:
  // arrive now, wait once the slice is staged
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  // stage this CTA's slice once; thread tid reads only the slots it writes
  for (int i = tid; i < cnt; i += THREADS) {
#pragma unroll
    for (int r = 0; r < NROWS; ++r) s_obs[r * S + i] = data[(size_t)r * M + base + i];
    const float m = mask[(size_t)b * M + base + i];
    s_obs[MASK * S + i] = m;
    s_obs[ACT * S + i] = m;
  }
  float P[12];
  {
    const float* T = T_init + (size_t)b * 16;
#pragma unroll
    for (int k = 0; k < 9; ++k) P[k] = T[4 * (k / 3) + k % 3];
#pragma unroll
    for (int k = 0; k < 3; ++k) P[9 + k] = T[4 * k + 3];
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");

  // warp 0 carries the system, the damping and the accepted pose; the
  // other warps only linearize at the poses it hands them
  int pass = 0;
  float Hc[NACC];  // the carried system: H (21), g (6), cost
  float lin[NACC];
  float trial[12];
  for (int round = 0; round < n_rounds; ++round) {
    linearize(cluster, s_obs, S, cnt, P, huber, s_warp, s_part, pass, Hc);
    float lam = lm_lambda;
    const int n_iters = round == 0 ? s0 : round == 1 ? s1 : round == 2 ? s2 : s3;
    for (int it = 0; it < n_iters; ++it) {
      if (warp == 0) {
        lm_trial(P, Hc, Hc + 21, lam, trial);
        if (tid == 0) {
#pragma unroll
          for (int k = 0; k < 12; ++k) s_pose[k] = trial[k];
        }
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < 12; ++k) trial[k] = s_pose[k];
      linearize(cluster, s_obs, S, cnt, trial, huber, s_warp, s_part, pass,
                lin);
      if (warp == 0) {
        const bool improved = lin[27] < Hc[27];
        if (improved) {
#pragma unroll
          for (int k = 0; k < 12; ++k) P[k] = trial[k];
#pragma unroll
          for (int k = 0; k < NACC; ++k) Hc[k] = lin[k];
        }
        lam = improved ? lam * 0.5f : lam * 4.0f;
      }
    }
    if (tid == 0) {
#pragma unroll
      for (int k = 0; k < 12; ++k) s_pose[k] = P[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 12; ++k) P[k] = s_pose[k];
    // chi2 re-gate at the accepted pose
    for (int i = tid; i < cnt; i += THREADS)
      s_obs[ACT * S + i] = s_obs[MASK * S + i] *
                           (chi2_at(s_obs, S, i, P) < chi2_thresh ? 1.0f : 0.0f);
  }
  for (int i = tid; i < cnt; i += THREADS)
    chi2_out[(size_t)b * M + base + i] = chi2_at(s_obs, S, i, P);
  if (rank == 0 && tid < 16) {
    const int i = tid / 4, j = tid % 4;
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < 12; ++k) {  // select without indexing P at run time
      const int ki = k < 9 ? k / 3 : k - 9, kj = k < 9 ? k % 3 : 3;
      if (i == ki && j == kj) v = P[k];
    }
    if (i == 3) v = j == 3 ? 1.0f : 0.0f;
    T_out[(size_t)b * 16 + tid] = v;
  }
}

}  // namespace

extern "C" int mc_pose_lm_cluster() { return CLUSTER; }

// Dynamic shared memory of a launch at M observations (bytes), or -1 when
// the slice does not fit in one block's shared memory.
extern "C" int mc_pose_lm_smem(int M) {
  const int S = (M + CLUSTER - 1) / CLUSTER;
  const long bytes = (long)SROWS * S * (long)sizeof(float);
  const long fixed = (NWARPS + 2 * CLUSTER) * 32 * (long)sizeof(float) + 12 * 4;
  return bytes + fixed > SMEM_LIMIT ? -1 : (int)bytes;
}

extern "C" int mc_pose_lm(const float* T_init, const float* data,
                          const float* mask, float* T_out, float* chi2, int B,
                          int M, int n_rounds, int s0, int s1, int s2, int s3,
                          float huber, float chi2_thresh, float lm_lambda,
                          void* stream) {
  if (B == 0) return 0;
  const int smem = mc_pose_lm_smem(M);
  if (smem < 0 || n_rounds < 0 || n_rounds > MAX_ROUNDS)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pose_lm_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int S = (M + CLUSTER - 1) / CLUSTER;
  pose_lm_cluster_kernel<<<B * CLUSTER, THREADS, smem, (cudaStream_t)stream>>>(
      T_init, data, mask, T_out, chi2, M, S, n_rounds, s0, s1, s2, s3, huber,
      chi2_thresh, lm_lambda);
  return (int)cudaGetLastError();
}
