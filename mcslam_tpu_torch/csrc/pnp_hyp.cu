// 6-point linear PnP hypotheses of the PnP RANSAC, central and
// generalized (non-central) DLT, one warp per hypothesis, in one launch.
//
// Replaces: the TPU-shaped hypothesis stage of the JAX package's PnP
// RANSAC, mcslam_tpu/frontend/ransac.py ransac_pnp (:293) through
// _dlt_pnp (:263), _dlt_gpnp (:209), _nullspace_vecs (:78) and
// _project_so3 (:134), which avoid a batched SVD as "scalar-bound on TPU"
// (inverse iteration on the shifted normal matrix, one batched Cholesky;
// a Newton-Schulz polar step for the rotation). No Pallas kernel
// corresponds to them. In the port the plain version is
// frontend/ransac.pnp_hypotheses (~330 tensor ops, both DLT forms
// computed for the second half and one chosen by torch.where).
//
// Computes, for K samples idx (K, S) (6 <= S <= 10) of landmarks X_world
// (M, 3), pixels uv (M, 2) and the observing cameras' cam_T_ref (M, 4, 4)
// and fx fy cx cy (M, 4), what the plain version computes:
//  1. per sample the ray r = ((u - cx) / fx, (v - cy) / fy, 1) in its
//     camera; hypotheses k < K / 2 are central DLTs in the reference
//     camera (the ray rotated by R_cr^T, xn = r_ref[:2] / max(r_ref[2],
//     1e-6); 2 S rows of 12: [X 1, 0, -u (X 1)] and [0, X 1, -v (X 1)]);
//     the rest are generalized DLTs (3 S rows of 13: [d]x R_cr (R X + t)
//     + [d]x t_cr = 0 in theta = (vec R, t, 1)) where any observation's
//     lever arm |t_cr| exceeds 1e-6 (read on the card: a block holding a
//     hypothesis of the second half takes it from its own samples, or
//     else scans the M translations up to the first lever arm), else
//     central DLTs too; only the form taken is computed;
//  2. G = A^T A, eps = tr G / N 1e-7 + 1e-12, the Cholesky factor of G +
//     eps I (a pivot that is not positive, or NaN, fails it: the pose is
//     then NaN, as cholesky_ex's info makes the plain version's);
//  3. 5 steps of inverse iteration v <- normalize(G^-1 v) from v_i =
//     cos(1.7 i + 0.3) (normalize: v rsqrt(max(|v|^2, 1e-30))); for the
//     generalized form 5 more from w_i = sin(2.3 i + 1.1), deflated
//     against v each step, and v replaced by w where |v[:12]| <= 0.3;
//  4. central: P = v as 3 x 4, divided by max(|P[2, :3]|, 1e-12), negated
//     where the samples' mean depth P[2] . (X 1) is negative, R =
//     polar(P[:, :3]), t = P[:, 3]; generalized: theta = v[:12] / v[12]
//     (|v[12]| clamped at 1e-8 keeping its sign), R = polar(theta[:9]), t
//     = theta[9:] / max(sqrt(|theta[:9]|^2 / 3), 1e-9);
//  5. polar(X): X negated where det X < 0, scaled by sqrt(3) / |X|_F, then
//     6 Newton-Schulz steps X <- (0.5 X)(3 I - X^T X);
//  6. the hypothesis world_T_ref = [R^T, -R^T t; 0 0 0 1].
// Built with -fmad=false (_build.SOURCE_FLAGS): products and sums are
// rounded on their own but for G's sums, the factor's updates and the
// solves' updates, which are fused multiply-adds as in a BLAS; these run
// in another order than the plain version's cuSOLVER / cuBLAS calls, and
// the factor and the solves multiply by reciprocal pivots where the plain
// version divides, so the poses agree to float32 rounding, not bit for bit
// (chip_smoke.py phase 2 holds them to 2e-2 where a hypothesis scores 0.8
// of the best, the bound tests/test_torch_pose.py holds the port to
// against the JAX package; tests/test_torch_ransac_kernels.py holds a
// float32 model of this order of operations to the same criteria). A
// sample index outside [0, M) gives a NaN pose (the plain version would
// fault).
//
// Bound on the card: latency. At K = 256 the samples read 6 x 100 B and
// the poses written 64 B a hypothesis, 0.17 MB with the lever scan (0.05
// us at 3.35 TB/s); ~12,000 float32 operations a generalized hypothesis
// (G ~3000, the factor ~800, 20 triangular solves ~7000), 2.4 M in all,
// 0.04 us at 67 TFLOP/s. Each hypothesis is a chain of dependent steps.
// Design: one warp per hypothesis, 4 a block (64 blocks at K = 256), the
// chain kept short:
//  - lanes s < S load sample s (and test its lever arm) and build its
//    rows of A in shared memory;
//  - G = A^T A by rows: lane i < N holds row i in N registers, N
//    independent accumulators summed over A's rows in order;
//  - the Cholesky factor right-looking in those registers: per column j
//    lane j's pivot is broadcast by a shuffle, every lane takes 1 / L_jj
//    = 1 / sqrt(pivot) once (lane j keeps it), lanes i > j multiply by it,
//    and each later column c takes L_cj by a shuffle and one fused
//    multiply-add (per entry in the order of a left-looking factor);
//  - each lane then holds its row of L and its column of L^T scaled by
//    1 / L_ii, so that every step of both triangular sweeps is a shuffle
//    and a fused multiply-add (no division in the chain); norms and dots
//    are warp butterflies;
//  - steps 4-6 run on every lane from the broadcast vector (13 registers),
//    lane 0 stores the pose. No local memory: the per-lane arrays are
//    indexed by constants after unrolling (the form is a template
//    argument: N = 12 or 13), A and the factor's transpose are in shared
//    memory, and the start vectors come in as an input (computed on the
//    card by torch, as the plain version computes them: a cosf / sinf in
//    the kernel would bring the Payne-Hanek reduction's local array).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;  // hypotheses a block
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_S = 10;  // samples: 3 S rows of the generalized form <= 32
constexpr int NMAX = 13;
constexpr int LD = 13;  // row stride of A and of the factor in shared memory
constexpr int ITERS = 5;
constexpr int SCAN_UNROLL = 8;  // translations a thread loads at once
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = x + __shfl_xor_sync(FULL, x, off);
  return x;
}

// torch.clamp(x, min=lo): a NaN stays NaN (fmaxf would drop it)
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float det3(const float (&X)[9]) {
  // linalg3.det3: a (e i - f h) - b (d i - f g) + c (d h - e g)
  return X[0] * (X[4] * X[8] - X[5] * X[7]) -
         X[1] * (X[3] * X[8] - X[5] * X[6]) +
         X[2] * (X[3] * X[7] - X[4] * X[6]);
}

// _project_so3: the sign flip, the scale, 6 Newton-Schulz steps (in place)
__device__ __forceinline__ void project_so3(float (&X)[9]) {
  const float sgn = det3(X) < 0.0f ? -1.0f : 1.0f;
  float fro = 0.0f;
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    X[e] = X[e] * sgn;
    fro = fro + X[e] * X[e];
  }
  const float sc = 1.7320508f / sqrtf(clamp_min(fro, 1e-30f));
#pragma unroll
  for (int e = 0; e < 9; ++e) X[e] = X[e] * sc;
#pragma unroll 1
  for (int it = 0; it < 6; ++it) {
    float Y[9], H[9];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float xtx = (X[i] * X[j] + X[3 + i] * X[3 + j]) +
                          X[6 + i] * X[6 + j];
        Y[3 * i + j] = (i == j ? 3.0f : 0.0f) - xtx;
      }
    }
#pragma unroll
    for (int e = 0; e < 9; ++e) H[e] = 0.5f * X[e];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        X[3 * i + j] = (H[3 * i] * Y[j] + H[3 * i + 1] * Y[3 + j]) +
                       H[3 * i + 2] * Y[6 + j];
    }
  }
}

// a central sample's two rows: [X 1, 0, -u (X 1)] and [0, X 1, -v (X 1)]
__device__ __forceinline__ void central_rows(float* r1, float* r2, float X0,
                                             float X1, float X2, float u,
                                             float v) {
  r1[0] = X0;
  r1[1] = X1;
  r1[2] = X2;
  r1[3] = 1.0f;
  r2[4] = X0;
  r2[5] = X1;
  r2[6] = X2;
  r2[7] = 1.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    r1[4 + c] = 0.0f;
    r2[c] = 0.0f;
  }
  r1[8] = -u * X0;
  r1[9] = -u * X1;
  r1[10] = -u * X2;
  r1[11] = -u;
  r2[8] = -v * X0;
  r2[9] = -v * X1;
  r2[10] = -v * X2;
  r2[11] = -v;
}

// a generalized sample's row for the row (d0, d1, d2) of [d]x: B = (d0,
// d1, d2) R_cr, [B0 X, B1 X, B2 X, B, (d0, d1, d2) t_cr] (T = cam_T_ref)
__device__ __forceinline__ void gen_row(float* row, float d0, float d1,
                                        float d2, const float* T, float X0,
                                        float X1, float X2) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float b = (d0 * T[j] + d1 * T[4 + j]) + d2 * T[8 + j];
    row[3 * j] = b * X0;
    row[3 * j + 1] = b * X1;
    row[3 * j + 2] = b * X2;
    row[9 + j] = b;
  }
  row[12] = (d0 * T[3] + d1 * T[7]) + d2 * T[11];
}

// the rig's lever flag, any |t_cr| > 1e-6 among the M observations (every
// thread of the block calls it): a lever arm among the block's own samples
// settles it; else the M translations are scanned in chunks of
// THREADS x SCAN_UNROLL, up to the first lever arm
__device__ bool lever_flag(bool lever, const float* __restrict__ cTr,
                           int M) {
  if (__syncthreads_or(lever)) return true;
  for (int base = 0; base < M; base += THREADS * SCAN_UNROLL) {
    bool any = false;
#pragma unroll
    for (int u = 0; u < SCAN_UNROLL; ++u) {
      const int m = base + u * THREADS + static_cast<int>(threadIdx.x);
      if (m < M) {
        const float* T = cTr + 16LL * m;
        const float t0 = __ldg(T + 3), t1 = __ldg(T + 7), t2 = __ldg(T + 11);
        any = any | (sqrtf((t0 * t0 + t1 * t1) + t2 * t2) > 1e-6f);
      }
    }
    if (__syncthreads_or(any)) return true;
  }
  return false;
}

// x <- (L L^T)^-1 x. Lane i holds x_i, r = 1 / L_ii, its row of L and its
// column of L^T scaled by r (lrow[c] = L_ic r, c < i; lcol[j] = L_ji r,
// j > i): y_i = x_i r - sum_{j < i} lrow[j] y_j, then z_i = y_i r -
// sum_{j > i} lcol[j] z_j, a shuffle and a fused multiply-add a step
// (lanes >= N hold r = 0 and x = 0 and keep them)
template <int N>
__device__ __forceinline__ float solve_recip(const float (&lrow)[N],
                                             const float (&lcol)[N], float r,
                                             float x, int lane) {
  x = x * r;
#pragma unroll
  for (int j = 0; j < N - 1; ++j) {  // L y = x
    const float yj = __shfl_sync(FULL, x, j);
    if (lane > j && lane < N) x = __fmaf_rn(-lrow[j], yj, x);
  }
  x = x * r;
#pragma unroll
  for (int j = N - 1; j > 0; --j) {  // L^T z = y
    const float zj = __shfl_sync(FULL, x, j);
    if (lane < j) x = __fmaf_rn(-lcol[j], zj, x);
  }
  return x;
}

__device__ __forceinline__ float normalize(float x) {
  return x * rsqrtf(clamp_min(warp_sum(x * x), 1e-30f));
}

// One hypothesis in one warp: the central form (N = 12, 2 S rows) or the
// generalized one (N = 13, 3 S rows). T: lane s < S's sample camera (its
// cam_T_ref), Xs its landmark, (r0, r1) its ray; the pose to out.
template <int N>
__device__ __forceinline__ void hypothesis(
    float* A, float* L, const float* __restrict__ T, float Xs0, float Xs1,
    float Xs2, float r0, float r1, int S, int lane, bool bad,
    const float* __restrict__ starts, float* __restrict__ out) {
  constexpr bool central = N == 12;
  const int rows = central ? 2 * S : 3 * S;

  // 1. the sample's rows of A
  if (lane < S) {
    if (central) {
      // R_cr^T r (r2 = 1)
      const float q0 = (T[0] * r0 + T[4] * r1) + T[8];
      const float q1 = (T[1] * r0 + T[5] * r1) + T[9];
      const float q2 = (T[2] * r0 + T[6] * r1) + T[10];
      const float den = clamp_min(q2, 1e-6f);
      central_rows(A + lane * LD, A + (S + lane) * LD, Xs0, Xs1, Xs2,
                   q0 / den, q1 / den);
    } else {
      // the rows of [d]x (R_cr (R X + t) + t_cr), d = (r0, r1, 1)
      float* row = A + 3 * lane * LD;
      gen_row(row, 0.0f, -1.0f, r1, T, Xs0, Xs1, Xs2);
      gen_row(row + LD, 1.0f, 0.0f, -r0, T, Xs0, Xs1, Xs2);
      gen_row(row + 2 * LD, -r1, r0, 0.0f, T, Xs0, Xs1, Xs2);
    }
  }
  __syncwarp();
  // end of A

  // 2. G = A^T A, lane i < N its row i (the sums over the rows in order)
  float a[N];
#pragma unroll
  for (int c = 0; c < N; ++c) a[c] = 0.0f;
  if (lane < N) {
    for (int r = 0; r < rows; ++r) {
      const float ai = A[r * LD + lane];
#pragma unroll
      for (int c = 0; c < N; ++c) a[c] = __fmaf_rn(ai, A[r * LD + c], a[c]);
    }
  }
  // end of G
  float dg = 0.0f;
#pragma unroll
  for (int c = 0; c < N; ++c) dg = c == lane ? a[c] : dg;
  float tr = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) tr = tr + __shfl_sync(FULL, dg, i);
  const float eps = tr / static_cast<float>(N) * 1e-7f + 1e-12f;
#pragma unroll
  for (int c = 0; c < N; ++c) a[c] = c == lane ? a[c] + eps : a[c];

  // the shift's Cholesky factor, right-looking: a[c] of lane i becomes L_ic
  bool fail = false;
  float r = 0.0f;  // 1 / L_ii
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float piv = __shfl_sync(FULL, a[j], j);
    fail = fail || !(piv > 0.0f);
    const float d = sqrtf(piv);
    const float rj = 1.0f / d;
    const float lij = lane == j ? d : a[j] * rj;
    a[j] = lij;
    if (lane == j) r = rj;
#pragma unroll
    for (int c = j + 1; c < N; ++c)
      a[c] = __fmaf_rn(-lij, __shfl_sync(FULL, lij, c), a[c]);
  }
  // the row of L and the column of L^T scaled by 1 / L_ii
  if (lane < N) {
#pragma unroll
    for (int c = 0; c < N; ++c) L[lane * LD + c] = a[c];
  }
  __syncwarp();
  float lrow[N], lcol[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    lrow[j] = a[j] * r;
    lcol[j] = (lane < N ? L[j * LD + lane] : 0.0f) * r;
  }
  // end of the factor

  // 3. inverse iteration (lane i holds entry i)
  float v = lane < N ? starts[lane] : 0.0f;
  for (int it = 0; it < ITERS; ++it)
    v = normalize(solve_recip<N>(lrow, lcol, r, v, lane));
  // end of v's steps
  if (!central) {
    float w = lane < N ? starts[NMAX + lane] : 0.0f;
    for (int it = 0; it < ITERS; ++it) {
      w = solve_recip<N>(lrow, lcol, r, w, lane);
      w = w - warp_sum(w * v) * v;
      w = normalize(w);
    }
    const float na = sqrtf(warp_sum(lane < 12 ? v * v : 0.0f));
    if (!(na > 0.3f)) v = w;
  }
  // end of w's steps

  // 4-6. the pose from the null vector, on every lane
  float p[NMAX];
#pragma unroll
  for (int i = 0; i < NMAX; ++i) p[i] = __shfl_sync(FULL, v, i);
  float Rm[9], t[3];
  if (central) {
    const float n2 = sqrtf((p[8] * p[8] + p[9] * p[9]) + p[10] * p[10]);
    const float den = clamp_min(n2, 1e-12f);
#pragma unroll
    for (int i = 0; i < 12; ++i) p[i] = p[i] / den;
    const float z = lane < S ? ((Xs0 * p[8] + Xs1 * p[9]) + Xs2 * p[10]) +
                                   p[11]
                             : 0.0f;
    const float zmean = warp_sum(z) / static_cast<float>(S);
    const float sg = zmean < 0.0f ? -1.0f : 1.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) Rm[3 * i + j] = p[4 * i + j] * sg;
      t[i] = p[4 * i + 3] * sg;
    }
    project_so3(Rm);
  } else {
    const float hom = p[12];
    const float h = fabsf(hom) > 1e-8f ? hom : (hom < 0.0f ? -1e-8f : 1e-8f);
    float th[12];
#pragma unroll
    for (int i = 0; i < 12; ++i) th[i] = p[i] / h;
    float n2 = 0.0f;
#pragma unroll
    for (int e = 0; e < 9; ++e) {
      Rm[e] = th[e];
      n2 = n2 + th[e] * th[e];
    }
    const float sc = clamp_min(sqrtf(n2 / 3.0f), 1e-9f);
    project_so3(Rm);
#pragma unroll
    for (int i = 0; i < 3; ++i) t[i] = th[9 + i] / sc;
  }
  if (lane == 0) {
    const float nan = __int_as_float(0x7fc00000);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      // world_T_ref = (R^T, -(R^T t))
      const float rt = (Rm[i] * t[0] + Rm[3 + i] * t[1]) + Rm[6 + i] * t[2];
#pragma unroll
      for (int j = 0; j < 3; ++j)
        out[4 * i + j] = fail || bad ? nan : Rm[3 * j + i];
      out[4 * i + 3] = fail || bad ? nan : -rt;
    }
    out[12] = 0.0f;
    out[13] = 0.0f;
    out[14] = 0.0f;
    out[15] = 1.0f;
  }
  // end of the pose
}

__global__ void __launch_bounds__(THREADS)
    pnp_hyp_kernel(const long long* __restrict__ idx,
                   const float* __restrict__ Xw,
                   const float* __restrict__ uv,
                   const float* __restrict__ cTr,
                   const float* __restrict__ f,
                   const float* __restrict__ starts, int K, int S, int M,
                   float* __restrict__ out) {
  __shared__ float s_A[WARPS][3 * MAX_S * LD];
  __shared__ float s_L[WARPS][NMAX * LD];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = blockIdx.x * WARPS + warp;

  // lane s < S's sample: its landmark, its ray, its camera's lever arm
  float Xs0 = 0.0f, Xs1 = 0.0f, Xs2 = 0.0f, r0 = 0.0f, r1 = 0.0f;
  const float* T = cTr;
  bool bad = false, lever = false;
  if (k < K && lane < S) {
    const long long i = idx[static_cast<long long>(k) * S + lane];
    bad = i < 0 || i >= M;
    const long long m = bad ? 0 : i;
    Xs0 = Xw[3 * m];
    Xs1 = Xw[3 * m + 1];
    Xs2 = Xw[3 * m + 2];
    T = cTr + 16 * m;
    const float fx = f[4 * m], fy = f[4 * m + 1], cx = f[4 * m + 2],
                cy = f[4 * m + 3];
    r0 = (uv[2 * m] - cx) / fx;
    r1 = (uv[2 * m + 1] - cy) / fy;
    lever = sqrtf((T[3] * T[3] + T[7] * T[7]) + T[11] * T[11]) > 1e-6f;
  }
  // the rig's lever flag, where the block holds a hypothesis k >= K / 2
  bool noncentral = false;
  if ((blockIdx.x + 1) * WARPS > K / 2)
    noncentral = lever_flag(lever, cTr, M);
  if (k >= K) return;
  bad = __any_sync(FULL, bad);
  float* o = out + 16 * static_cast<long long>(k);
  if (k < K / 2 || !noncentral)
    hypothesis<12>(s_A[warp], s_L[warp], T, Xs0, Xs1, Xs2, r0, r1, S, lane,
                   bad, starts, o);
  else
    hypothesis<13>(s_A[warp], s_L[warp], T, Xs0, Xs1, Xs2, r0, r1, S, lane,
                   bad, starts, o);
}

}  // namespace

// idx (K, S) int64, X_world (M, 3), uv (M, 2), cam_T_ref (M, 4, 4),
// fxycxy (M, 4) float32, starts (26,) float32 (cos(1.7 i + 0.3), then
// sin(2.3 i + 1.1), i < 13), contiguous -> out (K, 4, 4) float32 world_T_ref
// hypotheses (the first K / 2 central, the rest generalized where the rig
// has a lever arm).
extern "C" int mc_pnp_hyp(const void* idx, const void* X_world,
                          const void* uv, const void* cTr, const void* f,
                          const void* starts, void* out, int K, int S, int M,
                          void* stream) {
  if (K < 0 || S < 6 || S > MAX_S || M < 1) return cudaErrorInvalidValue;
  if (K == 0) return 0;
  pnp_hyp_kernel<<<(K + WARPS - 1) / WARPS, THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(idx), static_cast<const float*>(X_world),
      static_cast<const float*>(uv), static_cast<const float*>(cTr),
      static_cast<const float*>(f), static_cast<const float*>(starts), K, S,
      M, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
