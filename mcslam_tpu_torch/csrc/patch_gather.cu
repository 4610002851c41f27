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
// pixel. Design: one warp per keypoint, eight keypoints per block; the
// warp walks the patch in row-major order, so its reads are runs of
// consecutive pixels of one image row and its writes are contiguous. The
// circle is a 39-entry table of per-row half-widths in constant memory (a
// warp's 32 consecutive elements span at most two rows, so at most two
// distinct table entries per access).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int PATCH = 39;
constexpr int PATCH_R = 19;
constexpr int WARPS = 8;

// Per patch row r (dy = r - 19): the circle covers |dx| <= kHalfWidth[r];
// -1: the row lies outside the circle.
__constant__ int kHalfWidth[PATCH] = {
    -1, -1, -1, -1, 0, 5, 7, 9, 10, 11, 12, 12, 13, 13, 14, 14, 14, 14, 14,
    15, 14, 14, 14, 14, 14, 13, 13, 12, 12, 11, 10, 9, 7, 5, 0, -1, -1, -1,
    -1};

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

__global__ void __launch_bounds__(WARPS * 32) patch_oriented_kernel(
    const float* __restrict__ imgs, const int* __restrict__ yx,
    const int* __restrict__ img_idx, __nv_bfloat16* __restrict__ patches,
    float* __restrict__ moments, int* __restrict__ origins, int B, int H,
    int W, int T) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x * WARPS + warp;
  if (t >= T) return;  // whole warps only: the shuffles below see 32 lanes
  const int b = min(max(img_idx[t], 0), B - 1);
  const float* src = window(imgs, yx, b, t, H, W, origins, lane);
  __nv_bfloat16* dst = patches + (size_t)t * PATCH * PATCH;
  float m10 = 0.f, m01 = 0.f;
  for (int i = lane; i < PATCH * PATCH; i += 32) {
    const int r = i / PATCH, c = i - r * PATCH;
    const float v = src[(size_t)r * W + c];
    dst[i] = __float2bfloat16_rn(v);
    const int dx = c - PATCH_R, dy = r - PATCH_R;
    const bool in = abs(dx) <= kHalfWidth[r];
    m10 = __fadd_rn(m10, __fmul_rn(v, in ? (float)dx : 0.f));
    m01 = __fadd_rn(m01, __fmul_rn(v, in ? (float)dy : 0.f));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m10 = __fadd_rn(m10, __shfl_xor_sync(0xffffffffu, m10, off));
    m01 = __fadd_rn(m01, __shfl_xor_sync(0xffffffffu, m01, off));
  }
  if (lane == 0) {
    moments[2 * t] = m10;
    moments[2 * t + 1] = m01;
  }
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
  const int blocks = (T + WARPS - 1) / WARPS;
  patch_oriented_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      imgs, yx, img_idx, (__nv_bfloat16*)patches, moments, origins, B, H, W,
      T);
  return (int)cudaGetLastError();
}
