// 3-point absolute-orientation hypotheses of the Kabsch RANSAC (Horn's
// quaternion method), one thread per hypothesis, in one launch.
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
// 12 Newton steps, 16 3x3 determinants) are 0.6 M, 0.01 us at 67
// TFLOP/s. Each hypothesis is a chain of ~300 dependent operations. One
// thread per hypothesis, 64 threads a block (8 blocks at K = 512, on 8
// SMs); the 4x4 matrices and the cofactors live in registers, indexed by
// constants after unrolling (no local memory).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;

__device__ __forceinline__ float det3(float a, float b, float c, float d,
                                      float e, float f, float g, float h,
                                      float i) {
  // linalg3.det3: a (e i - f h) - b (d i - f g) + c (d h - e g)
  return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g);
}

// Y = K X for symmetric 4x4 K, X (row-major, sums in index order)
__device__ __forceinline__ void mul4(const float (&K)[4][4],
                                     const float (&X)[4][4],
                                     float (&Y)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s = K[i][0] * X[0][j];
#pragma unroll
      for (int k = 1; k < 4; ++k) s = s + K[i][k] * X[k][j];
      Y[i][j] = s;
    }
  }
}

__device__ __forceinline__ float trace4(const float (&X)[4][4]) {
  return ((X[0][0] + X[1][1]) + X[2][2]) + X[3][3];
}

__global__ void __launch_bounds__(THREADS)
    kabsch_hyp_kernel(const long long* __restrict__ idx,
                      const float* __restrict__ X_rig,
                      const float* __restrict__ X_world, int K, int M,
                      float* __restrict__ out) {
  const int k = blockIdx.x * THREADS + threadIdx.x;
  if (k >= K) return;
  float s[3][3], d[3][3];
  bool in_range = true;
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const long long i = idx[3 * k + p];
    in_range = in_range && i >= 0 && i < M;
    const long long r = (i >= 0 && i < M) ? i : 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      s[p][c] = X_rig[3 * r + c];
      d[p][c] = X_world[3 * r + c];
    }
  }
  float* T = out + 16 * k;
  if (!in_range) {
#pragma unroll
    for (int e = 0; e < 12; ++e) T[e] = __int_as_float(0x7fc00000);
    T[12] = 0.0f;
    T[13] = 0.0f;
    T[14] = 0.0f;
    T[15] = 1.0f;
    return;
  }

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
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      B[i][j] = (xs[0][i] * xd[0][j] + xs[1][i] * xd[1][j]) +
                xs[2][i] * xd[2][j];
  }

  // 2. the Davenport matrix
  const float tr = (B[0][0] + B[1][1]) + B[2][2];
  const float z[3] = {B[1][2] - B[2][1], B[2][0] - B[0][2],
                      B[0][1] - B[1][0]};
  float Kd[4][4];
  Kd[0][0] = tr;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    Kd[0][i + 1] = z[i];
    Kd[i + 1][0] = z[i];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Kd[i + 1][j + 1] = (B[i][j] + B[j][i]) - (i == j ? tr : 0.0f);
  }

  // 3. Faddeev-LeVerrier
  float Mi[4][4], Y[4][4];
  const float a3 = -trace4(Kd);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) Y[i][j] = Kd[i][j] + (i == j ? a3 : 0.0f);
  }
  mul4(Kd, Y, Mi);
  const float a2 = -trace4(Mi) / 2.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) Y[i][j] = Mi[i][j] + (i == j ? a2 : 0.0f);
  }
  mul4(Kd, Y, Mi);
  const float a1 = -trace4(Mi) / 3.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) Y[i][j] = Mi[i][j] + (i == j ? a1 : 0.0f);
  }
  mul4(Kd, Y, Mi);
  const float a0 = -trace4(Mi) / 4.0f;

  // 4. the largest eigenvalue by Newton from the Frobenius bound
  float fro = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) fro = fro + Kd[i][j] * Kd[i][j];
  }
  float lam = sqrtf(fro) + 1e-9f;
#pragma unroll 1
  for (int it = 0; it < 12; ++it) {
    const float p = (((lam + a3) * lam + a2) * lam + a1) * lam + a0;
    float dp = ((4.0f * lam + 3.0f * a3) * lam + 2.0f * a2) * lam + a1;
    dp = fabsf(dp) < 1e-12f ? 1e-12f : dp;
    lam = lam - p / dp;
  }

  // 5. the adjugate of K - lambda I: cof[r][c] = (-1)^(r + c) det(minor);
  // the adjugate's column c is cof's row c
  float A[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) A[i][j] = Kd[i][j] - (i == j ? lam : 0.0f);
  }
  float cof[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      // the minor's rows and columns: those of A but r and c
      const int i0 = r == 0 ? 1 : 0, i1 = r <= 1 ? 2 : 1, i2 = r <= 2 ? 3 : 2;
      const int j0 = c == 0 ? 1 : 0, j1 = c <= 1 ? 2 : 1, j2 = c <= 2 ? 3 : 2;
      const float det = det3(A[i0][j0], A[i0][j1], A[i0][j2], A[i1][j0],
                             A[i1][j1], A[i1][j2], A[i2][j0], A[i2][j1],
                             A[i2][j2]);
      cof[r][c] = ((r + c) & 1) ? -det : det;
    }
  }
  float best_norm = 0.0f;
  float q[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float n2 = ((cof[c][0] * cof[c][0] + cof[c][1] * cof[c][1]) +
                      cof[c][2] * cof[c][2]) +
                     cof[c][3] * cof[c][3];
    // torch.argmax: the first maximum, a NaN above every number
    const bool take = c == 0 || (!isnan(best_norm) &&
                                 (n2 > best_norm || isnan(n2)));
    if (take) {
      best_norm = n2;
#pragma unroll
      for (int i = 0; i < 4; ++i) q[i] = cof[c][i];
    }
  }
  {
    const float qn = sqrtf(((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]) +
                           q[3] * q[3]);
    const float den = isnan(qn) ? qn : fmaxf(qn, 1e-12f);  // torch.clamp
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = q[i] / den;
  }

  // 6. R from (x, y, z, w) = (q1, q2, q3, q0), normalized again
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
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float Rm = (R[i][0] * mu_s[0] + R[i][1] * mu_s[1]) +
                     R[i][2] * mu_s[2];
#pragma unroll
    for (int j = 0; j < 3; ++j) T[4 * i + j] = R[i][j];
    T[4 * i + 3] = mu_d[i] - Rm;
  }
  T[12] = 0.0f;
  T[13] = 0.0f;
  T[14] = 0.0f;
  T[15] = 1.0f;
}

}  // namespace

// idx (K, 3) int64, X_rig (M, 3), X_world (M, 3) float32, contiguous ->
// out (K, 4, 4) float32 world_T_ref hypotheses.
extern "C" int mc_kabsch_hyp(const void* idx, const void* X_rig,
                             const void* X_world, void* out, int K, int M,
                             void* stream) {
  if (K < 0 || M < 1) return cudaErrorInvalidValue;
  if (K == 0) return 0;
  kabsch_hyp_kernel<<<(K + THREADS - 1) / THREADS, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(idx), static_cast<const float*>(X_rig),
      static_cast<const float*>(X_world), K, M, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
