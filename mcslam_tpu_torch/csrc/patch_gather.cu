// Indexed 39x39 patch gather.
//
// Replaces: mcslam_tpu/ops/patch_pallas.py extract_patches_indexed_pallas
// (_patch_kernel_indexed).
//
// Computes, per keypoint t of a flat list: the patch origin
// (clip(y - 19, 0, H - 39), clip(x - 19, 0, W - 39)) in its own image
// img_idx[t] (clamped to [0, B-1], like dynamic_slice), and the 39x39
// window of that image. Bit-exact copy; also writes the origins.
//
// Bound on the card: memory. At the production shape (T = 3072) the
// kernel writes 18.7 MB of patches and reads about as much, scattered
// over the 19.7 MB pyramid batch. Design: one warp per keypoint, eight
// keypoints per block; the warp walks the patch in row-major order, so a
// warp's reads are runs of consecutive pixels of one image row and its
// writes are fully contiguous.

#include <cuda_runtime.h>

namespace {

constexpr int PATCH = 39;
constexpr int PATCH_R = 19;
constexpr int WARPS = 8;

__global__ void __launch_bounds__(WARPS * 32) patch_gather_kernel(
    const float* __restrict__ imgs, const int* __restrict__ yx,
    const int* __restrict__ img_idx, float* __restrict__ patches,
    int* __restrict__ origins, int B, int H, int W, int T) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x * WARPS + warp;
  if (t >= T) return;
  const int y0 = min(max(yx[2 * t] - PATCH_R, 0), H - PATCH);
  const int x0 = min(max(yx[2 * t + 1] - PATCH_R, 0), W - PATCH);
  const int b = min(max(img_idx[t], 0), B - 1);
  if (lane == 0) {
    origins[2 * t] = y0;
    origins[2 * t + 1] = x0;
  }
  const float* src = imgs + ((size_t)b * H + y0) * W + x0;
  float* dst = patches + (size_t)t * PATCH * PATCH;
  for (int i = lane; i < PATCH * PATCH; i += 32) {
    const int r = i / PATCH, c = i - r * PATCH;
    dst[i] = src[(size_t)r * W + c];
  }
}

}  // namespace

extern "C" int mc_patch_gather(const float* imgs, const int* yx,
                               const int* img_idx, float* patches,
                               int* origins, int B, int H, int W, int T,
                               void* stream) {
  if (T == 0) return 0;
  const int blocks = (T + WARPS - 1) / WARPS;
  patch_gather_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      imgs, yx, img_idx, patches, origins, B, H, W, T);
  return (int)cudaGetLastError();
}
