// The frame build's glue around the intra pair match and before the
// triangulation, as three kernels of one launch each: the Sampson gate of
// every camera pair (intra_gate), the feature groups from the parent table
// with their stable top-k (intra_groups) and the triangulation's gathers
// (tri_gather).
//
// Replaces: the TPU-shaped code that XLA fuses around the intra match and
// the triangulation inside the JAX package's jitted frame build,
// mcslam_tpu/frontend/intra.py intra_match (:68; the normalized coordinates
// :82-86, sampson_gate :47-65 per pair, the pointer jumping :150-152, the
// roots :155-156, the dense group table :163-172, the priority and
// lax.top_k :175-181, the ray table and the padding :183-199) and
// mcslam_tpu/frontend/frame.py _triangulate_stage (:91-122: the pixel and
// sigma gathers, the anchor, the ray counts). No Pallas kernel corresponds
// to them. In the port their plain versions are frontend/intra_cuda.
// *_reference, ~180 tensor ops a frame op by op; these are three launches.
//
// Computes what the plain versions compute, in their order of operations:
//  - intra_gate: for the P = C (C - 1) / 2 pairs (i, j), i < j, in the
//    order (0, 1), (0, 2), ..., (C - 2, C - 1), the normalized coordinates
//    x = (xy - c) / f (IEEE division) of both cameras, and under the pair's
//    essential matrix E (row-major) per column b the epipolar line
//    Exj_k = (E[k][0] xj0 + E[k][1] xj1) + E[k][2], per row a
//    Ethi_k = (xi0 E[0][k] + xi1 E[1][k]) + E[2][k], and per cell
//    t = (xi0 Exj_0 + xi1 Exj_1) + Exj_2, den = ((Exj_0^2 + Exj_1^2) +
//    Ethi_0^2) + Ethi_1^2 clamped below at 1e-12 (a NaN passes, as
//    torch.clamp lets it), gate = t^2 / den < thr^2 (IEEE division);
//  - intra_groups: each feature's root, the parent table applied 8 times
//    (three pointer jumps, 2^3 >= C hops); is_root = root == self & valid;
//    the ray table table[c][r] = the largest feature index of camera c
//    whose root is r among the valid ones, else -1; n_rays[r] = the cameras
//    with a ray; priority = is_root ? float(n_rays) 1e3 + response : -1;
//    the k = min(max_out, C N) largest priorities, ties to the lowest index
//    (torch.sort stable and descending, lax.top_k's rule; -0 equal to 0 and
//    NaN above everything, as torch orders them); out_valid = priority > 0,
//    ray_idx = out_valid ? table[:, index] : -1, desc = desc[index]; slots
//    k .. max_out - 1 padded with -1, 0 and false;
//  - tri_gather: per group m and camera c, ray_valid = ray_idx >= 0, the
//    pixel xy[c][max(idx, 0)] and sigma = sqrt(sigma2[c][max(idx, 0)])
//    correctly rounded (__fsqrt_rn); multi = (rays >= 2); mask = ray_valid &
//    multi; the anchor camera, the first with a ray (0 without one), its
//    pixel and sigma2; n_rays; multi & valid.
//
// Bit for bit: built with -fmad=false (_build.SOURCE_FLAGS), so every
// product and sum rounds on its own, as torch's elementwise kernels round
// them; the plain gate writes its three-term dots out in the order above
// (no `@`, whose order on cuBLAS and CPU BLAS cannot be repeated); the
// groups and gathers are integers, selects and copies; so each output
// equals its plain version's on the card. A parent outside the table or
// a ray index past the features is clamped into range here (the plain
// version raises on it).
//
// Bound on the card: intra_gate by bytes, the (P, N, N) gate it writes
// (3.54 MB at C = 4, N = 768: 1.1 us at 3.35 TB/s; ~10 float32 operations
// a cell take 0.5 us at 67 TFLOP/s); intra_groups by latency: one block
// sorts the C N keys (3072 at the frame's shape, ~0.3 MB of traffic);
// tri_gather by launch latency (~0.2 MB). Design:
//  - intra_gate: a block per (16 rows, pair) of 256 threads, each thread 4
//    adjacent columns (one 32-bit store per row where N % 4 == 0): the
//    rows' coordinates and Ethi^2 in shared memory, the columns' Exj and
//    the den prefix Exj_0^2 + Exj_1^2 in registers, computed once per
//    column;
//  - intra_groups: one block of 1024 threads, all in shared memory but the
//    ray table (global scratch, C x C N ints: integer atomicMax on L2, read
//    back past L1): the parents, the roots by 8 hops each, the table, the
//    keys (~ordered(priority) << 32 | index, unique, so any exact sort gives
//    the stable order), a bitonic sort of the keys padded to a power of
//    two, and the outputs read off the sorted keys;
//  - tri_gather: a thread per group, 128 a block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GATE_THREADS = 256;
constexpr int GATE_ROWS = 16;      // rows of a gate block
constexpr int GROUP_THREADS = 1024;
constexpr int MAX_KEYS = 16384;    // C N the groups block sorts (intra_cuda)
constexpr int GATHER_THREADS = 128;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// pair p of camera_pairs(C) -> (i, j)
__device__ __forceinline__ void pair_of(int p, int C, int& i, int& j) {
  i = 0;
  while (p >= C - 1 - i) {
    p -= C - 1 - i;
    ++i;
  }
  j = i + 1 + p;
}

__global__ void __launch_bounds__(GATE_THREADS)
    intra_gate_kernel(const float* __restrict__ xy,
                      const float* __restrict__ fxy,
                      const float* __restrict__ E,
                      const float* __restrict__ thr2p, int C, int N,
                      uint8_t* __restrict__ gate) {
  __shared__ float s_x0[GATE_ROWS], s_x1[GATE_ROWS];
  __shared__ float s_a0[GATE_ROWS], s_a1[GATE_ROWS];
  const int p = blockIdx.y, tid = threadIdx.x;
  int ci, cj;
  pair_of(p, C, ci, cj);
  const float* e = E + 9 * p;
  const int r0 = blockIdx.x * GATE_ROWS;
  const int nr = min(GATE_ROWS, N - r0);
  if (tid < nr) {
    const int n = ci * N + r0 + tid;
    const float x0 = __fdiv_rn(xy[2 * n] - fxy[4 * ci + 2], fxy[4 * ci]);
    const float x1 = __fdiv_rn(xy[2 * n + 1] - fxy[4 * ci + 3],
                               fxy[4 * ci + 1]);
    const float a0 = (x0 * e[0] + x1 * e[3]) + e[6];
    const float a1 = (x0 * e[1] + x1 * e[4]) + e[7];
    s_x0[tid] = x0;
    s_x1[tid] = x1;
    s_a0[tid] = a0 * a0;
    s_a1[tid] = a1 * a1;
  }
  __syncthreads();
  const float thr2 = *thr2p;
  const float fx = fxy[4 * cj], fy = fxy[4 * cj + 1];
  const float cx = fxy[4 * cj + 2], cy = fxy[4 * cj + 3];
  uint8_t* out = gate + (size_t)p * N * N + (size_t)r0 * N;
  const bool words = (N & 3) == 0;
  for (int c0 = 4 * tid; c0 < N; c0 += 4 * GATE_THREADS) {
    float b0[4], b1[4], b2[4], pre[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = cj * N + min(c0 + q, N - 1);
      const float y0 = __fdiv_rn(xy[2 * n] - cx, fx);
      const float y1 = __fdiv_rn(xy[2 * n + 1] - cy, fy);
      b0[q] = (e[0] * y0 + e[1] * y1) + e[2];
      b1[q] = (e[3] * y0 + e[4] * y1) + e[5];
      b2[q] = (e[6] * y0 + e[7] * y1) + e[8];
      pre[q] = b0[q] * b0[q] + b1[q] * b1[q];
    }
    for (int rr = 0; rr < nr; ++rr) {
      const float x0 = s_x0[rr], x1 = s_x1[rr];
      const float a0 = s_a0[rr], a1 = s_a1[rr];
      uint32_t word = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float t = (x0 * b0[q] + x1 * b1[q]) + b2[q];
        float den = (pre[q] + a0) + a1;
        den = den < 1e-12f ? 1e-12f : den;
        word |= (uint32_t)(__fdiv_rn(t * t, den) < thr2) << (8 * q);
      }
      uint8_t* row = out + (size_t)rr * N + c0;
      if (words) {
        *reinterpret_cast<uint32_t*>(row) = word;
      } else {
        for (int q = 0; q < 4 && c0 + q < N; ++q)
          row[q] = (uint8_t)((word >> (8 * q)) & 1u);
      }
    }
  }
}

// an ascending sort key of the priority's descending order: -0 as 0, every
// NaN as the one NaN above +inf (torch.sort's order)
__device__ __forceinline__ uint32_t descending_bits(float v) {
  uint32_t u = v != v ? 0x7fc00000u : __float_as_uint(v == 0.0f ? 0.0f : v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // ascending in v
  return ~u;
}

__device__ __forceinline__ float priority_of(uint32_t hi) {
  const uint32_t o = ~hi;
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__global__ void __launch_bounds__(GROUP_THREADS, 1)
    intra_groups_kernel(const int* __restrict__ parent,
                        const bool* __restrict__ valid,
                        const float* __restrict__ response,
                        const int* __restrict__ desc, int C, int N, int Kp,
                        int k, int max_out, int* __restrict__ table,
                        int* __restrict__ ray_idx, int* __restrict__ out_desc,
                        bool* __restrict__ out_valid) {
  // keys: Kp sort keys; their first K ints hold the roots before the keys
  // are made. flag: K ints, the parents, then is_root.
  extern __shared__ unsigned long long keys[];
  int* roots = reinterpret_cast<int*>(keys);
  int* flag = reinterpret_cast<int*>(keys + Kp);
  const int K = C * N, T = blockDim.x, tid = threadIdx.x;
  for (int f = tid; f < K; f += T) flag[f] = clampi(parent[f], 0, K - 1);
  for (int t = tid; t < C * K; t += T) table[t] = -1;
  __syncthreads();
  for (int f = tid; f < K; f += T) {
    int x = f;
#pragma unroll
    for (int h = 0; h < 8; ++h) x = flag[x];
    roots[f] = x;
  }
  __syncthreads();
  for (int f = tid; f < K; f += T) {
    const int r = roots[f];
    const bool v = valid[f];
    if (v) atomicMax(&table[(f / N) * K + r], f % N);
    flag[f] = (r == f) && v;
  }
  __syncthreads();
  for (int r = tid; r < Kp; r += T) {
    if (r < K) {
      int n = 0;
      for (int c = 0; c < C; ++c) n += __ldcg(&table[c * K + r]) >= 0;
      const float prio = flag[r] ? (float)n * 1e3f + response[r] : -1.0f;
      keys[r] = ((unsigned long long)descending_bits(prio) << 32) |
                (unsigned)r;
    } else {
      keys[r] = ~0ull;
    }
  }
  __syncthreads();
  for (int size = 2; size <= Kp; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < Kp / 2; t += T) {
        const int i = 2 * t - (t & (stride - 1));
        const unsigned long long a = keys[i], b = keys[i + stride];
        if ((a > b) == ((i & size) == 0)) {
          keys[i] = b;
          keys[i + stride] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int m = tid; m < max_out; m += T) {
    if (m < k) {
      const unsigned long long key = keys[m];
      const int idx = (int)(key & 0xffffffffull);
      const bool ov = priority_of((uint32_t)(key >> 32)) > 0.0f;
      for (int c = 0; c < C; ++c)
        ray_idx[m * C + c] = ov ? __ldcg(&table[c * K + idx]) : -1;
#pragma unroll
      for (int w = 0; w < 8; ++w) out_desc[8 * m + w] = desc[8 * idx + w];
      out_valid[m] = ov;
    } else {
      for (int c = 0; c < C; ++c) ray_idx[m * C + c] = -1;
#pragma unroll
      for (int w = 0; w < 8; ++w) out_desc[8 * m + w] = 0;
      out_valid[m] = false;
    }
  }
}

__global__ void __launch_bounds__(GATHER_THREADS)
    tri_gather_kernel(const int* __restrict__ ray_idx,
                      const bool* __restrict__ gvalid,
                      const float* __restrict__ xy,
                      const float* __restrict__ sigma2, int M, int C, int N,
                      float* __restrict__ uv, float* __restrict__ sigma,
                      bool* __restrict__ mask, int* __restrict__ anchor_cam,
                      float* __restrict__ uv_ref,
                      float* __restrict__ anchor_sigma2,
                      int* __restrict__ n_rays,
                      bool* __restrict__ multi_valid) {
  const int m = blockIdx.x * GATHER_THREADS + threadIdx.x;
  if (m >= M) return;
  const int* row = ray_idx + m * C;
  int n = 0, anchor = -1;
  for (int c = 0; c < C; ++c) {
    if (row[c] >= 0) {
      ++n;
      if (anchor < 0) anchor = c;
    }
  }
  const bool multi = n >= 2;
  for (int c = 0; c < C; ++c) {
    const int idx = row[c];
    const int kp = c * N + clampi(idx, 0, N - 1);
    uv[2 * (m * C + c)] = xy[2 * kp];
    uv[2 * (m * C + c) + 1] = xy[2 * kp + 1];
    sigma[m * C + c] = __fsqrt_rn(sigma2[kp]);
    mask[m * C + c] = idx >= 0 && multi;
  }
  const int a = anchor < 0 ? 0 : anchor;
  const int kp = a * N + clampi(row[a], 0, N - 1);
  anchor_cam[m] = a;
  uv_ref[2 * m] = xy[2 * kp];
  uv_ref[2 * m + 1] = xy[2 * kp + 1];
  anchor_sigma2[m] = sigma2[kp];
  n_rays[m] = n;
  multi_valid[m] = multi && gvalid[m];
}

}  // namespace

// xy (C, N, 2), fxycxy (C, 4), E (P, 3, 3), thr^2 (one float), gate
// (P, N, N) bool, C, N, stream
extern "C" int mc_intra_gate(const void* xy, const void* fxy, const void* E,
                             const void* thr2, void* gate, int C, int N,
                             void* stream) {
  if (C < 2 || N < 1) return cudaErrorInvalidValue;
  const dim3 grid((N + GATE_ROWS - 1) / GATE_ROWS, C * (C - 1) / 2);
  intra_gate_kernel<<<grid, GATE_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xy), static_cast<const float*>(fxy),
      static_cast<const float*>(E), static_cast<const float*>(thr2), C, N,
      static_cast<uint8_t*>(gate));
  return static_cast<int>(cudaGetLastError());
}

// parent (C, N) int32, valid (C, N) bool, response (C, N) float32, desc
// (C, N, 8) int32, table (C x C N ints of scratch), ray_idx (max_out, C),
// desc out (max_out, 8), valid out (max_out,), C, N, max_out, stream
extern "C" int mc_intra_groups(const void* parent, const void* valid,
                               const void* response, const void* desc,
                               void* table, void* ray_idx, void* out_desc,
                               void* out_valid, int C, int N, int max_out,
                               void* stream) {
  const int K = C * N;
  if (C < 1 || N < 1 || max_out < 1 || K > MAX_KEYS)
    return cudaErrorInvalidValue;
  int Kp = 1;
  while (Kp < K) Kp <<= 1;
  const int smem = Kp * 8 + K * 4;  // the keys, then the parents / flags
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        intra_groups_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
  }
  intra_groups_kernel<<<1, GROUP_THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(parent), static_cast<const bool*>(valid),
      static_cast<const float*>(response), static_cast<const int*>(desc), C,
      N, Kp, K < max_out ? K : max_out, max_out, static_cast<int*>(table),
      static_cast<int*>(ray_idx), static_cast<int*>(out_desc),
      static_cast<bool*>(out_valid));
  return static_cast<int>(cudaGetLastError());
}

// ray_idx (M, C) int32, valid (M,) bool, xy (C, N, 2), sigma2 (C, N), uv
// (M, C, 2), sigma (M, C), mask (M, C), anchor_cam (M,), uv_ref (M, 2),
// anchor_sigma2 (M,), n_rays (M,), multi & valid (M,), M, C, N, stream
extern "C" int mc_tri_gather(const void* ray_idx, const void* gvalid,
                             const void* xy, const void* sigma2, void* uv,
                             void* sigma, void* mask, void* anchor_cam,
                             void* uv_ref, void* anchor_sigma2, void* n_rays,
                             void* multi_valid, int M, int C, int N,
                             void* stream) {
  if (M < 0 || C < 1 || N < 1) return cudaErrorInvalidValue;
  if (M == 0) return 0;
  tri_gather_kernel<<<(M + GATHER_THREADS - 1) / GATHER_THREADS,
                      GATHER_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ray_idx), static_cast<const bool*>(gvalid),
      static_cast<const float*>(xy), static_cast<const float*>(sigma2), M, C,
      N, static_cast<float*>(uv), static_cast<float*>(sigma),
      static_cast<bool*>(mask), static_cast<int*>(anchor_cam),
      static_cast<float*>(uv_ref), static_cast<float*>(anchor_sigma2),
      static_cast<int*>(n_rays), static_cast<bool*>(multi_valid));
  return static_cast<int>(cudaGetLastError());
}
