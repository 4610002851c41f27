// Multi-view triangulation with its Gauss-Newton refine and gate, one
// thread per point.
//
// Replaces: the TPU-shaped fused triangulation of the frame build,
// mcslam_tpu/geometry/triangulation.py triangulate_and_refine (:194; the
// transposed component form written for the TPU's (8, 128) vector
// registers, which XLA fuses into a few loops there). No Pallas kernel
// corresponds to it. In the port its plain version,
// geometry/triangulation.triangulate_and_refine_reference, is ~1160 tensor
// ops on (R, M) and (M,) arrays; this kernel is one launch.
//
// Computes, for M points of R rays each (mask per ray), what the plain
// version computes, in its order of operations:
//  1. the unit world ray of each ray: xn = (u - cx) / fx, yn likewise,
//     inv_n = rsqrtf((xn xn + yn yn) + 1), d = T[:3,:3] (xn, yn, 1) inv_n;
//  2. the midpoint normal equations A = sum m (I - d d^T), b = sum m
//     (I - d d^T) o, o = T[:3, 3];
//  3. the cofactor 3x3 solve with 1e-6 added to A's diagonal and the
//     sign-keeping safe_det guard (|det| < 1e-20 -> +-1e-20);
//  4. ok0 = (>= 2 rays) & (det > 1e-9) & X0 finite;
//  5. gn_iters Gauss-Newton steps on the reprojection error (z clamped at
//     1e-3, 1e-3 on H's diagonal), X -= H^-1 g;
//  6. X0 where a coordinate of X is not finite;
//  7. per ray chi2 = |r|^2 / sigma^2 < chi2_thresh and min_z < z < max_z
//     (z clamped at 1e-6 in the projection), ok = ok0 & (>= 2 rays pass).
//
// Bit for bit: built with -fmad=false (_build.SOURCE_FLAGS) and written
// with __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn in the plain
// version's order, rsqrtf where it calls torch.rsqrt, and clamps that let
// a NaN through as torch.clamp does. Every sum over the rays is added in
// the order of torch.sum(dim=0) on the contiguous (R, M) component arrays
// the plain version makes: on the card (scripts/tri_sum_order.py) that
// reduction keeps four accumulators per output, ray r going into r % 4,
// each started as 0 + x, and folds them as ((a0 + a1) + a2) + a3 (the
// unused ones are 0). So X and ok equal the plain version's on the card.
//
// Bound on the card: launch and latency. At the frame's shape (M = 2048,
// R = 4) a call reads ~M R (2 + 1 + 1) floats and bytes plus the C poses
// and intrinsics, and writes M (12 + 1) bytes, ~0.1 MB: tens of
// nanoseconds of HBM time; its ~5.7 M float32 operations (~2800 a point)
// are ~0.09 us at 67 TFLOP/s. What a call costs is one thread's chain of
// dependent steps (seven passes over its rays, a solve per pass but the
// last), so the design runs that chain once per point, in registers:
//  - one thread per point, 64 threads a block, so the frame's 2048 points
//    spread over 32 SMs with one warp on each;
//  - no shared memory, no atomics, no second pass: the sums over the rays
//    are a thread's own, streamed ray by ray into the four accumulators;
//  - each input is read through its element strides, so the frame's
//    world_T_cam, an expand of C poses to (M, C, 4, 4), is read as the C
//    poses (stride 0 over the points) with no copy; the pose and
//    intrinsics of a ray are re-read from the cache in every pass; up to
//    R = 4 the rays are unrolled, beyond a loop takes one at a time (no
//    local memory at any R).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;
constexpr int MAX_R = 8;

struct Args {
  const float* wTc;  // (M, R, 4, 4) through strides
  const float* uv;   // (M, R, 2)
  const float* f;    // (M, R, 4): fx, fy, cx, cy
  const uint8_t* mask;  // (M, R) bool
  const float* sigma;   // (M, R), or null: sigma_scalar
  float* X;          // (M, 3) contiguous
  uint8_t* ok;       // (M,) bool
  int M;
  long long t_m, t_r, t_i, t_j;
  long long uv_m, uv_r, uv_k;
  long long f_m, f_r, f_k;
  long long k_m, k_r;
  long long s_m, s_r;
  float sigma_scalar, chi2_thresh, min_z, max_z;
  int gn_iters;
};

__device__ __forceinline__ float ldf(const float* p) { return __ldg(p); }

__device__ __forceinline__ bool ldb(const uint8_t* p) { return __ldg(p) != 0; }

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// torch.clamp(x, min=lo): a NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// torch.sum(x, dim=0) over a contiguous (R, M) float32 array on the card:
// ray r into accumulator r % 4 (first as 0 + x), then ((a0 + a1) + a2) + a3
struct RaySum {
  float a[4];
  __device__ __forceinline__ RaySum() { a[0] = a[1] = a[2] = a[3] = 0.0f; }
  // k = r % 4; a constant in the unrolled bodies of R <= 4, a select of
  // the four registers in the loop of R > 4 (no indexed local array)
  __device__ __forceinline__ void put(int k, float x) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i == k) a[i] = add(a[i], x);
  }
  __device__ __forceinline__ float total() const {
    return add(add(add(a[0], a[1]), a[2]), a[3]);
  }
};

// f(r, r % 4) for the rays r = 0..R-1 in order. Up to 4 rays the body is
// unrolled (the rays' loads and arithmetic overlap); beyond, a loop that is
// not unrolled takes one ray at a time, so R = 5-8 hold one ray in
// registers (fully unrolled, the compiler issued every ray's loads first
// and R >= 5 spilled at 255 registers)
template <int R, typename F>
__device__ __forceinline__ void for_rays(F&& f) {
  if constexpr (R <= 4) {
#pragma unroll
    for (int r = 0; r < R; ++r) f(r, r);
  } else {
#pragma unroll 1
    for (int r = 0; r < R; ++r) f(r, r & 3);
  }
}

// One ray's pose (rows 0-2 of world_T_cam), pixel, intrinsics and mask.
struct Ray {
  float T[3][4];
  float u, v, fx, fy, cx, cy, m;
};

__device__ __forceinline__ void load_ray(const Args& a, int p, int r,
                                         Ray& ray) {
  const float* t = a.wTc + p * a.t_m + r * a.t_r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ray.T[i][j] = ldf(t + i * a.t_i + j * a.t_j);
  const float* q = a.uv + p * a.uv_m + r * a.uv_r;
  ray.u = ldf(q);
  ray.v = ldf(q + a.uv_k);
  const float* f = a.f + p * a.f_m + r * a.f_r;
  ray.fx = ldf(f);
  ray.fy = ldf(f + a.f_k);
  ray.cx = ldf(f + 2 * a.f_k);
  ray.cy = ldf(f + 3 * a.f_k);
  ray.m = ldb(a.mask + p * a.k_m + r * a.k_r) ? 1.0f : 0.0f;
}

// linalg3.safe_det with eps = 1e-20: |det| < eps -> sign(det) eps, 0 -> eps
__device__ __forceinline__ float safe_det(float det) {
  const float eps = 1e-20f;
  if (fabsf(det) < eps) {
    const float sgn = det > 0.0f ? 1.0f : (det < 0.0f ? -1.0f : 0.0f);
    return add(mul(sgn, eps), mul(det == 0.0f ? 1.0f : 0.0f, eps));
  }
  return det;
}

// _solve3_elem: cofactor solve of a symmetric system given by its upper
// triangle (s00, s01, s02, s11, s12, s22), `damping` added to the diagonal
__device__ __forceinline__ float solve3(const float (&s)[6],
                                        const float (&b)[3], float damping,
                                        float (&x)[3]) {
  const float a00 = add(s[0], damping), a01 = s[1], a02 = s[2];
  const float a10 = s[1], a11 = add(s[3], damping), a12 = s[4];
  const float a20 = s[2], a21 = s[4], a22 = add(s[5], damping);
  const float c00 = sub(mul(a11, a22), mul(a12, a21));
  const float c01 = sub(mul(a12, a20), mul(a10, a22));
  const float c02 = sub(mul(a10, a21), mul(a11, a20));
  const float det = add(add(mul(a00, c00), mul(a01, c01)), mul(a02, c02));
  const float inv_det = __fdiv_rn(1.0f, safe_det(det));
  const float c10 = sub(mul(a02, a21), mul(a01, a22));
  const float c11 = sub(mul(a00, a22), mul(a02, a20));
  const float c12 = sub(mul(a01, a20), mul(a00, a21));
  const float c20 = sub(mul(a01, a12), mul(a02, a11));
  const float c21 = sub(mul(a02, a10), mul(a00, a12));
  const float c22 = sub(mul(a00, a11), mul(a01, a10));
  x[0] = mul(add(add(mul(c00, b[0]), mul(c10, b[1])), mul(c20, b[2])), inv_det);
  x[1] = mul(add(add(mul(c01, b[0]), mul(c11, b[1])), mul(c21, b[2])), inv_det);
  x[2] = mul(add(add(mul(c02, b[0]), mul(c12, b[1])), mul(c22, b[2])), inv_det);
  return det;
}

// p = Rcw X + tcw, Rcw[i][j] = T[j][i], tcw_i = -(sum_j T[j][i] T[j][3])
__device__ __forceinline__ void project(const Ray& ray, const float (&X)[3],
                                        float (&p)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float tcw = -add(add(mul(ray.T[0][i], ray.T[0][3]),
                               mul(ray.T[1][i], ray.T[1][3])),
                           mul(ray.T[2][i], ray.T[2][3]));
    p[i] = add(add(add(mul(ray.T[0][i], X[0]), mul(ray.T[1][i], X[1])),
                   mul(ray.T[2][i], X[2])),
               tcw);
  }
}

// entry e = 0..5 of the upper triangle of a symmetric 3x3, row by row:
// (0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)
__device__ constexpr int ui(int e) { return e < 3 ? 0 : (e < 5 ? 1 : 2); }
__device__ constexpr int uj(int e) { return e < 3 ? e : (e < 5 ? e - 2 : 2); }

template <int R>
__global__ void __launch_bounds__(THREADS) tri_refine_kernel(const Args a) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= a.M) return;

  // 1-4: midpoint initialization
  RaySum As[6], bs[3];
  int n_valid = 0;
  for_rays<R>([&](int r, int k) {
    Ray ray;
    load_ray(a, p, r, ray);
    n_valid += ray.m != 0.0f;
    const float xn = __fdiv_rn(sub(ray.u, ray.cx), ray.fx);
    const float yn = __fdiv_rn(sub(ray.v, ray.cy), ray.fy);
    const float inv_n = rsqrtf(add(add(mul(xn, xn), mul(yn, yn)), 1.0f));
    const float dc[3] = {mul(xn, inv_n), mul(yn, inv_n), inv_n};
    float d[3], o[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      d[i] = add(add(mul(ray.T[i][0], dc[0]), mul(ray.T[i][1], dc[1])),
                 mul(ray.T[i][2], dc[2]));
      o[i] = ray.T[i][3];
    }
    // m (eye - d_i d_j): d_i d_j == d_j d_i, so A is symmetric exactly
    float P[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        P[i][j] = mul(ray.m, sub(i == j ? 1.0f : 0.0f, mul(d[i], d[j])));
#pragma unroll
    for (int e = 0; e < 6; ++e) As[e].put(k, P[ui(e)][uj(e)]);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      bs[i].put(k, add(add(add(0.0f, mul(P[i][0], o[0])), mul(P[i][1], o[1])),
                       mul(P[i][2], o[2])));
  });
  float A[6], b[3], X0[3];
#pragma unroll
  for (int e = 0; e < 6; ++e) A[e] = As[e].total();
#pragma unroll
  for (int i = 0; i < 3; ++i) b[i] = bs[i].total();
  const float det = solve3(A, b, 1e-6f, X0);
  const bool ok0 = n_valid >= 2 && det > 1e-9f && isfinite(X0[0]) &&
                   isfinite(X0[1]) && isfinite(X0[2]);

  // 5: Gauss-Newton
  float X[3] = {X0[0], X0[1], X0[2]};
#pragma unroll 1
  for (int it = 0; it < a.gn_iters; ++it) {
    RaySum Hs[6], gs[3];
    for_rays<R>([&](int r, int k) {
      Ray ray;
      load_ray(a, p, r, ray);
      float q[3];
      project(ray, X, q);
      const float inv_z = __fdiv_rn(1.0f, clamp_min(q[2], 1e-3f));
      const float ru = mul(sub(add(mul(mul(q[0], inv_z), ray.fx), ray.cx),
                               ray.u), ray.m);
      const float rv = mul(sub(add(mul(mul(q[1], inv_z), ray.fy), ray.cy),
                               ray.v), ray.m);
      const float gx = mul(ray.fx, inv_z);
      const float gy = mul(ray.fy, inv_z);
      const float hx = mul(mul(-gx, q[0]), inv_z);
      const float hy = mul(mul(-gy, q[1]), inv_z);
      float J0[3], J1[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        J0[i] = mul(add(mul(gx, ray.T[i][0]), mul(hx, ray.T[i][2])), ray.m);
        J1[i] = mul(add(mul(gy, ray.T[i][1]), mul(hy, ray.T[i][2])), ray.m);
      }
#pragma unroll
      for (int e = 0; e < 6; ++e) {
        const int i = ui(e), j = uj(e);
        Hs[e].put(k, add(mul(J0[i], J0[j]), mul(J1[i], J1[j])));
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) gs[i].put(k, add(mul(J0[i], ru), mul(J1[i], rv)));
    });
    float H[6], g[3], dX[3];
#pragma unroll
    for (int e = 0; e < 6; ++e) H[e] = Hs[e].total();
#pragma unroll
    for (int i = 0; i < 3; ++i) g[i] = gs[i].total();
    solve3(H, g, 1e-3f, dX);
#pragma unroll
    for (int i = 0; i < 3; ++i) X[i] = sub(X[i], dX[i]);
  }

  // 6: fall back to X0 where the refine diverged
  if (!(isfinite(X[0]) && isfinite(X[1]) && isfinite(X[2]))) {
#pragma unroll
    for (int i = 0; i < 3; ++i) X[i] = X0[i];
  }

  // 7: chi2 / cheirality gate
  int n_pass = 0;
  for_rays<R>([&](int r, int) {
    Ray ray;
    load_ray(a, p, r, ray);
    float q[3];
    project(ray, X, q);
    const float zs = clamp_min(q[2], 1e-6f);
    const float ru = sub(add(mul(__fdiv_rn(q[0], zs), ray.fx), ray.cx), ray.u);
    const float rv = sub(add(mul(__fdiv_rn(q[1], zs), ray.fy), ray.cy), ray.v);
    const float sig = a.sigma ? ldf(a.sigma + p * a.s_m + r * a.s_r)
                              : a.sigma_scalar;
    const float chi2 = __fdiv_rn(add(mul(ru, ru), mul(rv, rv)), mul(sig, sig));
    n_pass += ray.m > 0.5f && chi2 < a.chi2_thresh && q[2] > a.min_z &&
              q[2] < a.max_z;
  });
  a.X[3 * p + 0] = X[0];
  a.X[3 * p + 1] = X[1];
  a.X[3 * p + 2] = X[2];
  a.ok[p] = ok0 && n_pass >= 2;
}

template <int R>
int launch(const Args& a, cudaStream_t s) {
  tri_refine_kernel<R><<<(a.M + THREADS - 1) / THREADS, THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// wTc, uv, f, mask, sigma (null: sigma_scalar), X, ok, M, R, then the
// element strides (t_m, t_r, t_i, t_j, uv_m, uv_r, uv_k, f_m, f_r, f_k,
// k_m, k_r, s_m, s_r), gn_iters, sigma_scalar, chi2_thresh, min_z, max_z
extern "C" int mc_tri_refine(const void* wTc, const void* uv, const void* f,
                             const void* mask, const void* sigma, void* X,
                             void* ok, int M, int R, int t_m, int t_r,
                             int t_i, int t_j, int uv_m, int uv_r, int uv_k,
                             int f_m, int f_r, int f_k, int k_m, int k_r,
                             int s_m, int s_r, int gn_iters,
                             float sigma_scalar, float chi2_thresh,
                             float min_z, float max_z, void* stream) {
  if (M < 0 || R < 1 || R > MAX_R || gn_iters < 0) return cudaErrorInvalidValue;
  if (M == 0) return 0;
  Args a;
  a.wTc = static_cast<const float*>(wTc);
  a.uv = static_cast<const float*>(uv);
  a.f = static_cast<const float*>(f);
  a.mask = static_cast<const uint8_t*>(mask);
  a.sigma = static_cast<const float*>(sigma);
  a.X = static_cast<float*>(X);
  a.ok = static_cast<uint8_t*>(ok);
  a.M = M;
  a.t_m = t_m; a.t_r = t_r; a.t_i = t_i; a.t_j = t_j;
  a.uv_m = uv_m; a.uv_r = uv_r; a.uv_k = uv_k;
  a.f_m = f_m; a.f_r = f_r; a.f_k = f_k;
  a.k_m = k_m; a.k_r = k_r;
  a.s_m = s_m; a.s_r = s_r;
  a.sigma_scalar = sigma_scalar;
  a.chi2_thresh = chi2_thresh;
  a.min_z = min_z;
  a.max_z = max_z;
  a.gn_iters = gn_iters;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (R) {
    case 1: return launch<1>(a, s);
    case 2: return launch<2>(a, s);
    case 3: return launch<3>(a, s);
    case 4: return launch<4>(a, s);
    case 5: return launch<5>(a, s);
    case 6: return launch<6>(a, s);
    case 7: return launch<7>(a, s);
    default: return launch<8>(a, s);
  }
}
