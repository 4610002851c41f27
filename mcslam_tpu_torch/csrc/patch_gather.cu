// 39x39 patch gathers, three entries sharing one warp-per-keypoint walk.
//
// mc_patch_gather — flat keypoint list, each keypoint names its image.
// Replaces: mcslam_tpu/ops/patch_pallas.py extract_patches_indexed_pallas
// (_patch_kernel_indexed).
// mc_patch_gather_batched — (C, N) keypoints, keypoint (c, n) in image c.
// Replaces: mcslam_tpu/ops/patch_pallas.py extract_patches_pallas
// (_patch_kernel).
// mc_patch_gather_oriented — the indexed gather plus the intensity-centroid
// moments [m10, m01] of each f32 window, patches written as bf16.
// Replaces: mcslam_tpu/ops/patch_pallas.py extract_patches_oriented_pallas
// (_patch_kernel_oriented).
//
// Computes, per keypoint t: the patch origin (clip(y - 19, 0, H - 39),
// clip(x - 19, 0, W - 39)) in its image (img_idx[t] clamped to [0, B-1],
// like dynamic_slice; t / N for the batched entry), and the 39x39 window
// of that image: a bit-exact f32 copy, or in the oriented entry its
// round-to-nearest-even bf16 copy and m10 = sum(win * wx), m01 =
// sum(win * wy) over the f32 window, with wx = dx, wy = dy inside the
// radius-15 circle (dx^2 + dy^2 <= 225) and 0 outside (orb._circle_weights).
// Every entry also writes the origins.
//
// The moments are summed in one fixed order, which the plain version in
// ops/patch_cuda.py repeats: lane l of the keypoint's warp adds the
// products of window elements l, l+32, l+64, ... in turn, then a butterfly
// of xor-shuffles (16, 8, 4, 2, 1) adds the 32 lane sums; every multiply
// and add is rounded on its own (__fmul_rn / __fadd_rn, no FMA).
//
// Bound on the card: memory. The production shapes: the indexed gather at
// T = 3072 writes 18.7 MB of patches and reads about as much, scattered over
// the 19.7 MB pyramid batch (~37 MB, ~11 us at 3.35 TB/s); the batched
// gather at C = 16, N = 247 writes 24.0 MB and reads as much (~48 MB,
// ~14 us); the oriented gather at T = 3072 reads 18.7 MB and writes 9.3 MB
// of bf16 patches (~28 MB, ~8 us). The moments are 2 multiply-adds per
// pixel. Design of the two f32 gathers: one warp per keypoint, eight
// keypoints per block; the warp walks the patch in row-major order, so its
// reads are runs of consecutive pixels of one image row and its writes are
// contiguous. The oriented gather stages its windows in shared memory
// (its own note below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int PATCH = 39;
constexpr int PATCH_R = 19;
constexpr int WARPS = 8;

enum Mode { INDEXED, BATCHED };

// The keypoint's clamped origin and the start of its window in imgs.
__device__ __forceinline__ const float* window(
    const float* __restrict__ imgs, const int* __restrict__ yx, int b, int t,
    int H, int W, int* __restrict__ origins, int lane) {
  const int y0 = min(max(yx[2 * t] - PATCH_R, 0), H - PATCH);
  const int x0 = min(max(yx[2 * t + 1] - PATCH_R, 0), W - PATCH);
  if (lane == 0) {
    origins[2 * t] = y0;
    origins[2 * t + 1] = x0;
  }
  return imgs + ((size_t)b * H + y0) * W + x0;
}

template <Mode MODE>
__global__ void __launch_bounds__(WARPS * 32) patch_gather_kernel(
    const float* __restrict__ imgs, const int* __restrict__ yx,
    const int* __restrict__ img_idx, float* __restrict__ patches,
    int* __restrict__ origins, int B, int H, int W, int T, int N) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x * WARPS + warp;
  if (t >= T) return;
  const int b = MODE == BATCHED ? t / N : min(max(img_idx[t], 0), B - 1);
  const float* src = window(imgs, yx, b, t, H, W, origins, lane);
  float* dst = patches + (size_t)t * PATCH * PATCH;
  for (int i = lane; i < PATCH * PATCH; i += 32) {
    const int r = i / PATCH, c = i - r * PATCH;
    dst[i] = src[(size_t)r * W + c];
  }
}

// ---- the oriented gather -------------------------------------------------
//
// Bound on the card: memory, and in the first design the latency of it: a
// warp walked its window 32 elements at a time, each step a 4-byte load
// per lane straddling two window rows, so too few bytes were in flight per
// SM. This design stages each keypoint's whole 39-row window in shared
// memory with every row in flight at once (cp.async: 16-byte chunks of the
// row's 16-byte-aligned span when W % 4 == 0 and the image batch is
// 16-byte aligned, else 4-byte copies of the 39 elements), double-buffered:
// a warp serves OR_KPW keypoints and stages the next one's window while it
// sums the current one. From shared memory:
//  - the moments in the first design's lane order (lane l adds elements l,
//    l+32, ...; row and column advance by increments, the circle test is
//    dx^2 + dy^2 <= 225), then the xor butterfly: bit for bit the
//    moments of patch_gather_oriented_reference;
//  - the bf16 patch as 32-bit words holding two elements, aligned to the
//    patch's place in the output (1521 elements per patch, so an odd t
//    starts in the upper half of a word): the one element that shares a
//    word with the neighbouring patch (the first when t * 1521 is odd,
//    else the last) is a 2-byte store. A warp's words are 128
//    consecutive bytes.
constexpr int OR_WARPS = 4;        // warps (keypoint streams) per block
constexpr int OR_KPW = 2;          // keypoints per warp
constexpr int OR_STRIDE = 44;      // floats per staged row: an aligned span
constexpr int OR_BUF = PATCH * OR_STRIDE;  // floats per staged window
constexpr int OR_SMEM = OR_WARPS * 2 * OR_BUF * 4;  // bytes per block
static_assert(OR_SMEM > 48 * 1024, "the opt-in below assumes > 48 KB");

__device__ __forceinline__ void cp_async16(float* s, const float* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(s)),
               "l"(g));
}

__device__ __forceinline__ void cp_async4(float* s, const float* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(s)),
               "l"(g));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Issue the copies of keypoint t's window into buf and write its origin;
// returns the column of the window's first element within a staged row.
__device__ __forceinline__ int stage_window(
    const float* __restrict__ imgs, const int* __restrict__ yx,
    const int* __restrict__ img_idx, int* __restrict__ origins, float* buf,
    int t, int B, int H, int W, bool vec, int lane) {
  const int b = min(max(img_idx[t], 0), B - 1);
  const int x0 = min(max(yx[2 * t + 1] - PATCH_R, 0), W - PATCH);
  const float* src = window(imgs, yx, b, t, H, W, origins, lane);
  if (vec) {
    const int lead = x0 & 3;
    const float* a0 = src - lead;  // 16-byte aligned: W % 4 == 0
    const int nch = (lead + PATCH + 3) >> 2;  // chunks in the row, 10 or 11
    for (int i = lane; i < PATCH * 11; i += 32) {
      const int r = i / 11, q = i - r * 11;
      if (q < nch) cp_async16(buf + r * OR_STRIDE + 4 * q, a0 + (size_t)r * W + 4 * q);
    }
    return lead;
  }
  for (int r = 0; r < PATCH; ++r)
    for (int c = lane; c < PATCH; c += 32)
      cp_async4(buf + r * OR_STRIDE + c, src + (size_t)r * W + c);
  return 0;
}

__global__ void __launch_bounds__(OR_WARPS * 32) patch_oriented_kernel(
    const float* __restrict__ imgs, const int* __restrict__ yx,
    const int* __restrict__ img_idx, __nv_bfloat16* __restrict__ patches,
    float* __restrict__ moments, int* __restrict__ origins, int B, int H,
    int W, int T, bool vec) {
  extern __shared__ __align__(16) float s_win[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* const bufs = s_win + 2 * warp * OR_BUF;  // this warp's two windows
  const int stride = gridDim.x * OR_WARPS;
  int t = blockIdx.x * OR_WARPS + warp;
  if (t >= T) return;  // whole warps only: the shuffles below see 32 lanes
  int off = stage_window(imgs, yx, img_idx, origins, bufs, t, B, H, W, vec,
                         lane);
  cp_async_commit();
  for (int cur = 0; t < T; cur ^= 1) {
    const int tn = t + stride;
    int off_n = 0;
    if (tn < T)
      off_n = stage_window(imgs, yx, img_idx, origins, bufs + (cur ^ 1) * OR_BUF,
                           tn, B, H, W, vec, lane);
    cp_async_commit();  // possibly empty: keeps "all but the newest" exact
    cp_async_wait_prior();
    __syncwarp();
    const float* win = bufs + cur * OR_BUF + off;

    float m10 = 0.f, m01 = 0.f;
    int r = 0, c = lane;  // element lane of the row-major window
    for (int i = lane; i < PATCH * PATCH; i += 32) {
      const float v = win[r * OR_STRIDE + c];
      const int dx = c - PATCH_R, dy = r - PATCH_R;
      const bool in = dx * dx + dy * dy <= 225;
      m10 = __fadd_rn(m10, __fmul_rn(v, in ? (float)dx : 0.f));
      m01 = __fadd_rn(m01, __fmul_rn(v, in ? (float)dy : 0.f));
      c += 32;
      if (c >= PATCH) {
        c -= PATCH;
        ++r;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      m10 = __fadd_rn(m10, __shfl_xor_sync(0xffffffffu, m10, o));
      m01 = __fadd_rn(m01, __shfl_xor_sync(0xffffffffu, m01, o));
    }
    if (lane == 0) {
      moments[2 * t] = m10;
      moments[2 * t + 1] = m01;
    }

    // bf16 words: element e of the patch is element t * 1521 + e of the
    // output; pairs (e, e + 1) with that index even are one 32-bit word
    const size_t g0 = (size_t)t * PATCH * PATCH;
    const int head = (int)(g0 & 1);
    __nv_bfloat16* dst = patches + g0;
    const int npairs = (PATCH * PATCH - head) >> 1;  // 760 either way
    int e = head + 2 * lane;  // < 64: in row 0 or 1
    r = e >= PATCH;
    c = e - r * PATCH;
    for (int p = lane; p < npairs; p += 32) {
      const float v0 = win[r * OR_STRIDE + c];
      const float v1 = c + 1 < PATCH ? win[r * OR_STRIDE + c + 1]
                                     : win[(r + 1) * OR_STRIDE];
      *reinterpret_cast<__nv_bfloat162*>(dst + e) =
          __halves2bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
      e += 64;
      c += 64 - PATCH;  // 64 = 39 + 25
      ++r;
      if (c >= PATCH) {
        c -= PATCH;
        ++r;
      }
    }
    if (lane == 0) {  // the element that shares a word with a neighbour
      if (head)
        dst[0] = __float2bfloat16_rn(win[0]);
      else
        dst[PATCH * PATCH - 1] =
            __float2bfloat16_rn(win[(PATCH - 1) * OR_STRIDE + PATCH - 1]);
    }
    __syncwarp();  // the next iteration stages into this buffer
    t = tn;
    off = off_n;
  }
}

std::atomic<uint64_t> oriented_smem_set{0};

// Opt the oriented kernel into OR_SMEM bytes of dynamic shared memory and
// the largest carveout, once per device (the attributes persist).
cudaError_t allow_oriented_smem() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = 1ull << (dev & 63);
  if (oriented_smem_set.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(patch_oriented_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, OR_SMEM);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(patch_oriented_kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) oriented_smem_set.fetch_or(bit, std::memory_order_release);
  return e;
}

}  // namespace

extern "C" int mc_patch_gather(const float* imgs, const int* yx,
                               const int* img_idx, float* patches,
                               int* origins, int B, int H, int W, int T,
                               void* stream) {
  if (T == 0) return 0;
  const int blocks = (T + WARPS - 1) / WARPS;
  patch_gather_kernel<INDEXED><<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      imgs, yx, img_idx, patches, origins, B, H, W, T, 1);
  return (int)cudaGetLastError();
}

extern "C" int mc_patch_gather_batched(const float* imgs, const int* yx,
                                       float* patches, int* origins, int C,
                                       int H, int W, int N, void* stream) {
  const int T = C * N;
  if (T == 0) return 0;
  const int blocks = (T + WARPS - 1) / WARPS;
  patch_gather_kernel<BATCHED><<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      imgs, yx, nullptr, patches, origins, C, H, W, T, N);
  return (int)cudaGetLastError();
}

extern "C" int mc_patch_gather_oriented(const float* imgs, const int* yx,
                                        const int* img_idx, void* patches,
                                        float* moments, int* origins, int B,
                                        int H, int W, int T, void* stream) {
  if (T == 0) return 0;
  const cudaError_t e = allow_oriented_smem();
  if (e != cudaSuccess) return (int)e;
  const bool vec =
      W % 4 == 0 && (reinterpret_cast<uintptr_t>(imgs) & 15) == 0;
  const int per_block = OR_WARPS * OR_KPW;
  const int blocks = (T + per_block - 1) / per_block;
  patch_oriented_kernel<<<blocks, OR_WARPS * 32, OR_SMEM, (cudaStream_t)stream>>>(
      imgs, yx, img_idx, (__nv_bfloat16*)patches, moments, origins, B, H, W, T,
      vec);
  return (int)cudaGetLastError();
}
