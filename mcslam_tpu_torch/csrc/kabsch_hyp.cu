// 3-point absolute-orientation hypotheses of the Kabsch RANSAC (Horn's
// quaternion method), a quad of lanes per hypothesis, in one launch.
//
// Replaces: the TPU-shaped hypothesis stage of the JAX package's Kabsch
// RANSAC, mcslam_tpu/frontend/ransac.py ransac_kabsch (:176) through
// mcslam_tpu/geometry/alignment.py kabsch_quat (:59) and
// _dominant_eigvec4 (:141), which avoid a batched SVD or eigensolver as
// "scalar-bound on TPU" and write the 4x4 eigenproblem as batched matrix
// products and a fixed Newton loop. No Pallas kernel corresponds to them.
// In the port the plain version is frontend/ransac.kabsch_hypotheses
// (alignment.kabsch_quat: ~150 tensor ops on (K, ...) arrays).
//
// Computes, for each of K samples idx (K, 3) of rig points X_rig (M, 3)
// and landmarks X_world (M, 3), what the plain version computes:
//  1. the centroids mu_s, mu_d ((a + b + c) / 3) and the cross-covariance
//     B = sum_m (s_m - mu_s)(d_m - mu_d)^T;
//  2. Davenport's K = [[tr B, z^T], [z, B + B^T - tr B I]], z = (B12 - B21,
//     B20 - B02, B01 - B10);
//  3. its characteristic polynomial by Faddeev-LeVerrier (M1 = K, a3 =
//     -tr M1, M_i+1 = K (M_i + a I), a = -tr M_i+1 / (i + 1));
//  4. lambda from 12 Newton steps on it from ||K||_F + 1e-9 (a derivative
//     under 1e-12 in magnitude taken as 1e-12);
//  5. the adjugate of K - lambda I by 3x3 cofactors, its column of the
//     largest norm (the first such; a NaN norm wins, as in torch.argmax),
//     normalized (norm clamped at 1e-12): the quaternion (w, x, y, z);
//  6. R from the quaternion (normalized again), t = mu_d - R mu_s, and
//     world_T_ref = [R t; 0 0 0 1].
// Built with -fmad=false (_build.SOURCE_FLAGS): every product and sum is
// rounded on its own, as torch's elementwise kernels round them; the
// matrix products of the plain version (the einsum of step 1, K M_i and R
// mu_s, cuBLAS on the card) are written as sums in index order, so the
// poses agree with the plain version's to float32 rounding, not bit for
// bit (chip_smoke.py phase 2 holds them to 2e-2 where a hypothesis scores
// 0.8 of the best, tests/test_torch_pose.py's bound against the JAX
// package). A sample index outside [0, M) gives a NaN pose (the plain
// version would fault).
//
// Bound on the card: latency. At K = 512 the samples read 3 x 2 x 12 B
// and the poses written 64 B a hypothesis, 0.07 MB (0.02 us at 3.35
// TB/s); ~1200 float32 operations a hypothesis (the three 4x4 products,
// up to 12 Newton steps, 16 3x3 determinants) are 0.6 M, 0.01 us at 67
// TFLOP/s. What counts is a hypothesis's chain of dependent operations,
// which this design shortens, every value keeping its own operations
// (the same bits as a thread per hypothesis):
//  - a quad of lanes per hypothesis (KH_LANES), KH_THREADS a block (32
//    blocks at K = 512; 32 or 128 were no faster): lane j < 3 loads
//    sample j's index and rows, shuffles give every lane the three
//    points (every lane loading all three was 0.7 us slower:
//    scripts/ransac_variants.py, variant allloads); every lane makes B
//    and K;
//  - lane j makes column j of each product K (M_i + a I) (K is symmetric,
//    so its column j is its row j), four independent 4-term sums; the
//    traces are the four lanes' diagonal entries, shuffled and summed in
//    trace4's order;
//  - Newton runs its 12 steps in every lane. Stopping at lambda's first
//    bitwise fixed point would be exact (a step depends on lambda and the
//    coefficients alone; alignment.newton_fixed_steps), but a warp can
//    leave only with its slowest quad, and at the portfolio's samples
//    one hypothesis in three takes all 12: a warp's 8 run 11.9 on
//    average, and the vote each step cost more than it saved (variant
//    vote);
//  - lane r makes cofactor row r (the adjugate's column r) and its norm;
//    the four norms go to every lane and the first maximum (a NaN
//    winning) is taken in column order; the winning row is shuffled out;
//  - lane i < 3 makes row i of R and t_i, lane 3 the row (0, 0, 0, 1);
//    each stores its row as one float4, a quad's 64 bytes one run.
// The 4x4 matrices, the cofactors and every selection by lane live in
// registers, indexed by constants after unrolling (no local memory).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int KH_THREADS = 64;
constexpr int KH_LANES = 4;  // a quad of lanes per hypothesis
constexpr int NEWTON_STEPS = 12;
constexpr unsigned FULL = 0xffffffffu;
static_assert(KH_THREADS % 32 == 0, "whole warps: the shuffles");

__device__ __forceinline__ float det3(float a, float b, float c, float d,
                                      float e, float f, float g, float h,
                                      float i) {
  // linalg3.det3: a (e i - f h) - b (d i - f g) + c (d h - e g)
  return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g);
}

__device__ __forceinline__ float trace4(const float (&X)[4][4]) {
  return ((X[0][0] + X[1][1]) + X[2][2]) + X[3][3];
}

// v[j] for a lane index j in [0, 4), by selects (no local memory)
__device__ __forceinline__ float pick4(const float (&v)[4], int j) {
  return j == 0 ? v[0] : (j == 1 ? v[1] : (j == 2 ? v[2] : v[3]));
}

// Column j of M_next = K (X + a I), X's column j in col (lane j of the
// quad), each entry's sum in index order k = 0..3; then -trace(M_next) /
// div from the quad's four diagonal entries in trace4's order
__device__ __forceinline__ float fl_step(const float (&K)[4][4], float (&col)[4],
                                         float a, int j, int base,
                                         float div) {
  float x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = col[i] + (i == j ? a : 0.0f);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float s = K[i][0] * x[0];
#pragma unroll
    for (int k = 1; k < 4; ++k) s = s + K[i][k] * x[k];
    col[i] = s;
  }
  const float dj = pick4(col, j);
  const float d0 = __shfl_sync(FULL, dj, base);
  const float d1 = __shfl_sync(FULL, dj, base + 1);
  const float d2 = __shfl_sync(FULL, dj, base + 2);
  const float d3 = __shfl_sync(FULL, dj, base + 3);
  return -(((d0 + d1) + d2) + d3) / div;
}

__global__ void __launch_bounds__(KH_THREADS)
    kabsch_hyp_kernel(const long long* __restrict__ idx,
                      const float* __restrict__ X_rig,
                      const float* __restrict__ X_world, int K, int M,
                      float* __restrict__ out) {
  // the hypothesis block starts
  const int t = blockIdx.x * KH_THREADS + threadIdx.x;
  // a warp past the last hypothesis leaves whole; in the last warp, the
  // lanes of hypotheses past K run along (on row 0) for the shuffles and
  // store nothing
  if ((t & ~31) / KH_LANES >= K) return;
  const int k = t / KH_LANES, j = t % KH_LANES;
  const int lane = threadIdx.x & 31, base = lane & ~(KH_LANES - 1);
  const bool live = k < K;
  // lane j < 3 loads sample j's index and rows, shuffles give the quad
  // the three points
  long long i = 0;
  if (live && j < 3) i = idx[3 * k + j];
  const bool fits = i >= 0 && i < M;
  const long long r = fits ? i : 0;
  float sr[3], dr[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    sr[c] = X_rig[3 * r + c];
    dr[c] = X_world[3 * r + c];
  }
  const unsigned quad = (0xfu << base);
  const bool in_range = (__ballot_sync(FULL, fits) & quad) == quad;
  float s[3][3], d[3][3];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      s[p][c] = __shfl_sync(FULL, sr[c], base + p);
      d[p][c] = __shfl_sync(FULL, dr[c], base + p);
    }
  }
  // the samples in

  // 1. centroids (weights 1, wsum 3) and the cross-covariance
  float mu_s[3], mu_d[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    mu_s[c] = ((s[0][c] + s[1][c]) + s[2][c]) / 3.0f;
    mu_d[c] = ((d[0][c] + d[1][c]) + d[2][c]) / 3.0f;
  }
  float xs[3][3], xd[3][3];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      xs[p][c] = s[p][c] - mu_s[c];
      xd[p][c] = d[p][c] - mu_d[c];
    }
  }
  float B[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b)
      B[a][b] = (xs[0][a] * xd[0][b] + xs[1][a] * xd[1][b]) +
                xs[2][a] * xd[2][b];
  }

  // 2. the Davenport matrix (symmetric bit for bit: B + B^T's entries are
  // the same sums in either order)
  const float tr = (B[0][0] + B[1][1]) + B[2][2];
  const float z[3] = {B[1][2] - B[2][1], B[2][0] - B[0][2],
                      B[0][1] - B[1][0]};
  float Kd[4][4];
  Kd[0][0] = tr;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    Kd[0][a + 1] = z[a];
    Kd[a + 1][0] = z[a];
#pragma unroll
    for (int b = 0; b < 3; ++b)
      Kd[a + 1][b + 1] = (B[a][b] + B[b][a]) - (a == b ? tr : 0.0f);
  }
  // B and the Davenport matrix made

  // 3. Faddeev-LeVerrier, lane j column j of each M_i (K's column j is
  // its row j)
  float col[4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
    col[a] = j == 0 ? Kd[0][a] : (j == 1 ? Kd[1][a]
                                         : (j == 2 ? Kd[2][a] : Kd[3][a]));
  const float a3 = -trace4(Kd);
  const float a2 = fl_step(Kd, col, a3, j, base, 2.0f);
  const float a1 = fl_step(Kd, col, a2, j, base, 3.0f);
  const float a0 = fl_step(Kd, col, a1, j, base, 4.0f);
  // a3..a0 made

  // 4. the largest eigenvalue by Newton from the Frobenius bound, to its
  // first bitwise fixed point
  float fro = 0.0f;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) fro = fro + Kd[a][b] * Kd[a][b];
  }
  float lam = sqrtf(fro) + 1e-9f;
#pragma unroll 1
  for (int it = 0; it < NEWTON_STEPS; ++it) {
    const float p = (((lam + a3) * lam + a2) * lam + a1) * lam + a0;
    float dp = ((4.0f * lam + 3.0f * a3) * lam + 2.0f * a2) * lam + a1;
    dp = fabsf(dp) < 1e-12f ? 1e-12f : dp;
    lam = lam - p / dp;
  }
  // Newton done

  // 5. the adjugate of K - lambda I: lane j makes cofactor row j, cof[c] =
  // (-1)^(j + c) det(the minor without row j and column c), which is the
  // adjugate's column j
  float A[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) A[a][b] = Kd[a][b] - (a == b ? lam : 0.0f);
  }
  // the minor's rows: A's rows but j
  float R0[4], R1[4], R2[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    R0[b] = j == 0 ? A[1][b] : A[0][b];
    R1[b] = j <= 1 ? A[2][b] : A[1][b];
    R2[b] = j <= 2 ? A[3][b] : A[2][b];
  }
  float cof[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int j0 = c == 0 ? 1 : 0, j1 = c <= 1 ? 2 : 1, j2 = c <= 2 ? 3 : 2;
    const float det = det3(R0[j0], R0[j1], R0[j2], R1[j0], R1[j1], R1[j2],
                           R2[j0], R2[j1], R2[j2]);
    cof[c] = ((j + c) & 1) ? -det : det;
  }
  // the cofactors made
  const float n2 = ((cof[0] * cof[0] + cof[1] * cof[1]) + cof[2] * cof[2]) +
                   cof[3] * cof[3];
  int win = 0;
  float best_norm = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float nc = __shfl_sync(FULL, n2, base + c);
    // torch.argmax: the first maximum, a NaN above every number
    const bool take = c == 0 || (!isnan(best_norm) &&
                                 (nc > best_norm || isnan(nc)));
    if (take) {
      best_norm = nc;
      win = c;
    }
  }
  float q[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) q[c] = __shfl_sync(FULL, cof[c], base + win);
  {
    const float qn = sqrtf(((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]) +
                           q[3] * q[3]);
    const float den = isnan(qn) ? qn : fmaxf(qn, 1e-12f);  // torch.clamp
#pragma unroll
    for (int c = 0; c < 4; ++c) q[c] = q[c] / den;
  }

  // 6. R from (x, y, z, w) = (q1, q2, q3, q0), normalized again; lane j < 3
  // row j of R and t_j, lane 3 the row (0, 0, 0, 1)
  const float qn = sqrtf(((q[1] * q[1] + q[2] * q[2]) + q[3] * q[3]) +
                         q[0] * q[0]);
  const float x = q[1] / qn, y = q[2] / qn, zq = q[3] / qn, w = q[0] / qn;
  const float xx = x * x, yy = y * y, zz = zq * zq;
  const float xy = x * y, xz = x * zq, yz = y * zq;
  const float wx = w * x, wy = w * y, wz = w * zq;
  float R[3][3];
  R[0][0] = 1.0f - 2.0f * (yy + zz);
  R[0][1] = 2.0f * (xy - wz);
  R[0][2] = 2.0f * (xz + wy);
  R[1][0] = 2.0f * (xy + wz);
  R[1][1] = 1.0f - 2.0f * (xx + zz);
  R[1][2] = 2.0f * (yz - wx);
  R[2][0] = 2.0f * (xz - wy);
  R[2][1] = 2.0f * (yz + wx);
  R[2][2] = 1.0f - 2.0f * (xx + yy);
  float row[3];
#pragma unroll
  for (int b = 0; b < 3; ++b)
    row[b] = j == 0 ? R[0][b] : (j == 1 ? R[1][b] : R[2][b]);
  const float md = j == 0 ? mu_d[0] : (j == 1 ? mu_d[1] : mu_d[2]);
  const float Rm = (row[0] * mu_s[0] + row[1] * mu_s[1]) + row[2] * mu_s[2];
  const float nan = __int_as_float(0x7fc00000);
  float4 v;
  if (j == 3) v = make_float4(0.0f, 0.0f, 0.0f, 1.0f);
  else if (!in_range) v = make_float4(nan, nan, nan, nan);
  else v = make_float4(row[0], row[1], row[2], md - Rm);
  if (live) reinterpret_cast<float4*>(out)[static_cast<long long>(4) * k + j] = v;
  // the hypothesis block ends
}

}  // namespace

// idx (K, 3) int64, X_rig (M, 3), X_world (M, 3) float32, contiguous ->
// out (K, 4, 4) float32 world_T_ref hypotheses (16-byte aligned).
extern "C" int mc_kabsch_hyp(const void* idx, const void* X_rig,
                             const void* X_world, void* out, int K, int M,
                             void* stream) {
  if (K < 0 || M < 1 || K > (1 << 28)) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(out) & 15) return cudaErrorMisalignedAddress;
  if (K == 0) return 0;
  const long long threads = static_cast<long long>(K) * KH_LANES;
  kabsch_hyp_kernel<<<(threads + KH_THREADS - 1) / KH_THREADS, KH_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(idx), static_cast<const float*>(X_rig),
      static_cast<const float*>(X_world), K, M, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
