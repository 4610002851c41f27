// Whole-schedule robust motion-only LM refine, one launch for a batch of
// initial poses.
//
// Replaces: mcslam_tpu/frontend/pose_opt_pallas.py optimize_pose_pallas
// (_pose_kernel, _linearize, _chol_solve6_s, _retract_s, _so3_exp_s).
//
// Computes, per candidate b (one block each), the deferred-accept LM
// schedule sched[0..n_rounds): each round linearizes at the current pose
// (Huber-weighted reprojection residuals of the active observations into
// the 21 lower-triangle entries of the 6x6 H, the 6 of g and the cost),
// then runs sched[round] steps of: damped unrolled Cholesky solve,
// right retraction on SE(3) (Rodrigues + left Jacobian with the same
// small-angle series), a linearization at the trial pose, accept if its
// cost is lower (lambda x 0.5) else keep the carried system (lambda x 4).
// After each round the active set becomes mask & (chi2 < chi2_thresh) at
// the accepted pose. Outputs the final pose and the per-observation chi2
// at that pose.
//
// Bound on the card: latency. At the production shape (M = 2048, sched
// (8, 8)) the work is ~19 passes over 2048 observations of ~150 flops
// each (~6 MFLOP per candidate) joined by block-wide reductions and a
// scalar 6x6 solve; no pass has enough work to fill the card. Design: the
// whole schedule runs inside one block per candidate, so a batch of
// candidates costs one launch; every pass is a strided loop over the
// observations (SoA rows, coalesced) with 28 per-thread partial sums,
// a warp-shuffle + shared-memory block reduction, and one thread doing
// the Cholesky, retract and accept/reject, sharing the result through
// shared memory. The active mask lives in the chi2 output row (each
// thread only touches its own observations) until the final pass.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int NACC = 28;  // 21 H (lower triangle, row-major) + 6 g + cost
constexpr float EPS_SMALL = 1e-8f;

// data rows (see ops pack in frontend/pose_opt_cuda.py)
enum {
  X0, X1, X2, U, V, C00, C01, C02, C10, C11, C12, C20, C21, C22,
  CT0, CT1, CT2, FX, FY, CX, CY, ISIG2, NROWS
};

struct Obs {
  float r0, r1;
  float j0[6], j1[6];
};

__device__ __forceinline__ void residual_jac(const float* __restrict__ d,
                                             int M, int m, const float* P,
                                             Obs& o, bool want_jac) {
  const float* R = P;  // 9 row-major
  const float* t = P + 9;
  const float e0 = d[X0 * M + m] - t[0];
  const float e1 = d[X1 * M + m] - t[1];
  const float e2 = d[X2 * M + m] - t[2];
  const float q0 = R[0] * e0 + R[3] * e1 + R[6] * e2;
  const float q1 = R[1] * e0 + R[4] * e1 + R[7] * e2;
  const float q2 = R[2] * e0 + R[5] * e1 + R[8] * e2;
  const float c00 = d[C00 * M + m], c01 = d[C01 * M + m], c02 = d[C02 * M + m];
  const float c10 = d[C10 * M + m], c11 = d[C11 * M + m], c12 = d[C12 * M + m];
  const float c20 = d[C20 * M + m], c21 = d[C21 * M + m], c22 = d[C22 * M + m];
  const float p0 = c00 * q0 + c01 * q1 + c02 * q2 + d[CT0 * M + m];
  const float p1 = c10 * q0 + c11 * q1 + c12 * q2 + d[CT1 * M + m];
  const float p2 = c20 * q0 + c21 * q1 + c22 * q2 + d[CT2 * M + m];
  const float z = fmaxf(p2, 1e-3f);
  const float iz = 1.0f / z;
  const float fx = d[FX * M + m], fy = d[FY * M + m];
  o.r0 = p0 * iz * fx + d[CX * M + m] - d[U * M + m];
  o.r1 = p1 * iz * fy + d[CY * M + m] - d[V * M + m];
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

// Block-wide linearization at pose P: the result lands in s_out[NACC]
// (valid for every thread after the trailing barrier).
__device__ void linearize(const float* __restrict__ d,
                          const float* __restrict__ active, int M,
                          const float* P, float huber,
                          float (*s_warp)[NACC], float* s_out) {
  float acc[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) acc[k] = 0.f;
  for (int m = threadIdx.x; m < M; m += THREADS) {
    Obs o;
    residual_jac(d, M, m, P, o, true);
    const float rn = sqrtf(o.r0 * o.r0 + o.r1 * o.r1);
    const float wh = rn <= huber ? 1.0f : huber / fmaxf(rn, 1e-9f);
    const float w = wh * d[ISIG2 * M + m] * active[m];
    int k = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j)
        acc[k++] += w * (o.j0[i] * o.j0[j] + o.j1[i] * o.j1[j]);
#pragma unroll
    for (int i = 0; i < 6; ++i) acc[21 + i] += w * (o.j0[i] * o.r0 + o.j1[i] * o.r1);
    acc[27] += w * (o.r0 * o.r0 + o.r1 * o.r1);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < NACC; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) s_warp[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < NACC) {
    float v = 0.f;
    for (int w = 0; w < NWARPS; ++w) v += s_warp[w][threadIdx.x];
    s_out[threadIdx.x] = v;
  }
  __syncthreads();
}

__device__ void so3_exp_s(float w0, float w1, float w2, float* E) {
  const float t2 = w0 * w0 + w1 * w1 + w2 * w2;
  const bool small = t2 < EPS_SMALL;
  const float th = sqrtf(small ? 1.0f : t2);
  const float a = small ? 1.0f - t2 / 6.0f + t2 * t2 / 120.0f : sinf(th) / th;
  const float b = small ? 0.5f - t2 / 24.0f + t2 * t2 / 720.0f
                        : (1.0f - cosf(th)) / (th * th);
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

__device__ void so3_left_jac_s(float w0, float w1, float w2, float* J) {
  const float t2 = w0 * w0 + w1 * w1 + w2 * w2;
  const bool small = t2 < EPS_SMALL;
  const float th = sqrtf(small ? 1.0f : t2);
  const float b = small ? 0.5f - t2 / 24.0f : (1.0f - cosf(th)) / (th * th);
  const float c = small ? 1.0f / 6.0f - t2 / 120.0f
                        : (th - sinf(th)) / (th * th * th);
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
__device__ void lm_trial(const float* P, const float* H, const float* g,
                         float lam, float* trial) {
  float L[6][6];
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j <= i; ++j) {
      float s = H[i * (i + 1) / 2 + j] + (i == j ? lam : 0.0f);
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      if (i == j) {
        L[i][i] = sqrtf(fmaxf(s, 1e-12f));
      } else {
        L[i][j] = s / L[j][j];
      }
    }
  }
  float y[6], x[6];
  for (int i = 0; i < 6; ++i) {
    float s = g[i];
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < 6; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
  const float w0 = -x[0], w1 = -x[1], w2 = -x[2];
  const float v0 = -x[3], v1 = -x[4], v2 = -x[5];
  float E[9], J[9];
  so3_exp_s(w0, w1, w2, E);
  so3_left_jac_s(w0, w1, w2, J);
  const float te0 = J[0] * v0 + J[1] * v1 + J[2] * v2;
  const float te1 = J[3] * v0 + J[4] * v1 + J[5] * v2;
  const float te2 = J[6] * v0 + J[7] * v1 + J[8] * v2;
  const float* R = P;
  const float* t = P + 9;
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j)
      trial[3 * i + j] = R[3 * i + 0] * E[0 * 3 + j] +
                         R[3 * i + 1] * E[1 * 3 + j] +
                         R[3 * i + 2] * E[2 * 3 + j];
    trial[9 + i] = R[3 * i + 0] * te0 + R[3 * i + 1] * te1 +
                   R[3 * i + 2] * te2 + t[i];
  }
}

__global__ void __launch_bounds__(THREADS) pose_lm_kernel(
    const float* __restrict__ T_init, const float* __restrict__ data,
    const float* __restrict__ mask, const int* __restrict__ sched,
    float* __restrict__ T_out, float* __restrict__ chi2_out, int M,
    int n_rounds, float huber, float chi2_thresh, float lm_lambda) {
  __shared__ float s_warp[NWARPS][NACC];
  __shared__ float s_lin[NACC];
  __shared__ float s_pose[12];  // accepted pose: R (9, row-major), t (3)
  __shared__ float s_trial[12];
  const int bidx = blockIdx.x;
  const int tid = threadIdx.x;
  const float* msk = mask + (size_t)bidx * M;
  float* active = chi2_out + (size_t)bidx * M;  // scratch until the end

  for (int m = tid; m < M; m += THREADS) active[m] = msk[m];
  if (tid < 12) {
    const float* T = T_init + (size_t)bidx * 16;
    s_pose[tid] = tid < 9 ? T[4 * (tid / 3) + tid % 3] : T[4 * (tid - 9) + 3];
  }
  __syncthreads();

  // the carried system (thread 0 only): H (21), g (6), cost
  float Hc[21], gc[6], cost = 0.f, lam = 0.f;
  for (int round = 0; round < n_rounds; ++round) {
    linearize(data, active, M, s_pose, huber, s_warp, s_lin);
    if (tid == 0) {
      for (int k = 0; k < 21; ++k) Hc[k] = s_lin[k];
      for (int k = 0; k < 6; ++k) gc[k] = s_lin[21 + k];
      cost = s_lin[27];
      lam = lm_lambda;
    }
    const int n_iters = sched[round];
    for (int it = 0; it < n_iters; ++it) {
      if (tid == 0) lm_trial(s_pose, Hc, gc, lam, s_trial);
      __syncthreads();
      linearize(data, active, M, s_trial, huber, s_warp, s_lin);
      if (tid == 0) {
        const bool improved = s_lin[27] < cost;
        if (improved) {
          for (int k = 0; k < 12; ++k) s_pose[k] = s_trial[k];
          for (int k = 0; k < 21; ++k) Hc[k] = s_lin[k];
          for (int k = 0; k < 6; ++k) gc[k] = s_lin[21 + k];
          cost = s_lin[27];
        }
        lam = improved ? lam * 0.5f : lam * 4.0f;
      }
      __syncthreads();
    }
    // chi2 re-gate at the accepted pose
    for (int m = tid; m < M; m += THREADS) {
      Obs o;
      residual_jac(data, M, m, s_pose, o, false);
      const float chi2 = (o.r0 * o.r0 + o.r1 * o.r1) * data[ISIG2 * M + m];
      active[m] = msk[m] * (chi2 < chi2_thresh ? 1.0f : 0.0f);
    }
    __syncthreads();
  }
  for (int m = tid; m < M; m += THREADS) {
    Obs o;
    residual_jac(data, M, m, s_pose, o, false);
    chi2_out[(size_t)bidx * M + m] =
        (o.r0 * o.r0 + o.r1 * o.r1) * data[ISIG2 * M + m];
  }
  if (tid < 16) {
    float v;
    const int i = tid / 4, j = tid % 4;
    if (i == 3) {
      v = j == 3 ? 1.0f : 0.0f;
    } else {
      v = j == 3 ? s_pose[9 + i] : s_pose[3 * i + j];
    }
    T_out[(size_t)bidx * 16 + tid] = v;
  }
}

}  // namespace

extern "C" int mc_pose_lm(const float* T_init, const float* data,
                          const float* mask, const int* sched, float* T_out,
                          float* chi2, int B, int M, int n_rounds,
                          float huber, float chi2_thresh, float lm_lambda,
                          void* stream) {
  if (B == 0) return 0;
  pose_lm_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      T_init, data, mask, sched, T_out, chi2, M, n_rounds, huber,
      chi2_thresh, lm_lambda);
  return (int)cudaGetLastError();
}
