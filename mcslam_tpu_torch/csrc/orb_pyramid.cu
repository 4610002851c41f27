// The ORB pyramid, written straight into the stacked level batch that
// fast_select reads, each level resized from the one before in a fixed
// tap order.
//
// Replaces: the pyramid and the level stack of the JAX package's ORB
// extraction, mcslam_tpu/ops/image.py resize_bilinear (:106, an
// antialiased jax.image.resize) and build_pyramid (:120), and the edge
// padding and stacking of mcslam_tpu/ops/orb.py :306-314, which XLA fuses
// on the TPU. No Pallas kernel corresponds to them. In the port its plain
// version is ops/orb_cuda.orb_pyramid_reference (image.resize_bilinear per
// level, then a replicate pad of every level and one cat).
//
// Computes, for B images of (H, W) and L levels of true sizes (h_l, w_l)
// (image.pyramid_shapes): out[l B + b] is level l of image b at the top
// left of an (H, W) plane, edge-replicated beyond (h_l, w_l); level 0 is
// the input, level l >= 1 the resize of level l - 1. The resize of one
// axis from n_in to n_out samples is, per output o, the K taps of
// image.resize_taps (the nonzero weights of jax.image's triangle matrix,
// ascending input index from first[o]): w0 x[f] + w1 x[f + 1] + ...,
// added left to right, each product and sum rounded to float32 (built
// with -fmad=false, and written with __fmul_rn / __fadd_rn). The vertical
// pass comes first: the value at output row y, input column c is the
// vertical taps' sum; the horizontal pass sums those values over its taps.
// A pass whose axis keeps its size is a copy (K = 0). This is the plain
// version's order, so the two agree bit for bit; every output depends on
// its image alone, so a batch of any size gives the same bits.
//
// Bound on the card: bytes. At the bench shape (16 planes of 480 x 640
// out of 4 images, 4 levels) the input is 4.9 MB and the stack 19.7 MB,
// ~7.3 us at 3.35 TB/s; each output needs K^2 <= 9 multiplies and adds.
// Design: one thread per output pixel (a 32 x 8 block over x, y, a grid
// z per image), L - 1 launches: the first also copies level 0 into the
// stack and resizes level 1 from the input, the others resize level l
// from level l - 1 in the stack (which the launch before wrote). An
// edge-replicated pixel recomputes its edge pixel's value from the same
// inputs in the same order. A thread reads its K x K window (L1 / L2
// hits: the neighbours read the same rows), keeps the vertical sums of
// its K columns in registers and writes one float; the weight tables
// are read through the read-only cache. No shared memory, no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BX = 32, BY = 8;
constexpr int MAX_TAPS = 8;  // image.MAX_TAPS

struct Level {
  const float* tv;  // (h, kv) vertical taps
  const int* fv;    // (h,) first input row
  const float* th;  // (w, kh) horizontal taps
  const int* fh;    // (w,) first input column
  int kv, kh;       // taps per output, 0: the axis keeps its size
  int h, w;         // the level's true size
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// The vertical pass at output row yc, input column c of the source plane
// (row stride W).
__device__ __forceinline__ float vertical(const float* src, int W,
                                          const Level& lv, int yc, int c) {
  if (lv.kv == 0) return __ldg(src + (long long)yc * W + c);
  const float* col = src + (long long)__ldg(lv.fv + yc) * W + c;
  const float* w = lv.tv + yc * lv.kv;
  float t = mul(__ldg(w), __ldg(col));
#pragma unroll
  for (int k = 1; k < MAX_TAPS; ++k)
    if (k < lv.kv) t = add(t, mul(__ldg(w + k), __ldg(col + (long long)k * W)));
  return t;
}

// Level lv at pixel (y, x) of the (H, W) plane, edge-replicated, from the
// previous level's plane src (row stride W).
__device__ __forceinline__ float resize_at(const float* src, int W,
                                           const Level& lv, int y, int x) {
  const int yc = min(y, lv.h - 1), xc = min(x, lv.w - 1);
  if (lv.kh == 0) return vertical(src, W, lv, yc, xc);
  const int f = __ldg(lv.fh + xc);
  const float* w = lv.th + xc * lv.kh;
  float out = mul(__ldg(w), vertical(src, W, lv, yc, f));
#pragma unroll
  for (int j = 1; j < MAX_TAPS; ++j)
    if (j < lv.kh) out = add(out, mul(__ldg(w + j), vertical(src, W, lv, yc, f + j)));
  return out;
}

// Level 0 copied into the stack and, when the pyramid has two levels or
// more, level 1 resized from the input.
__global__ void __launch_bounds__(BX * BY)
pyramid_base_kernel(const float* __restrict__ img, float* __restrict__ out0,
                    float* __restrict__ out1, Level lv, int H, int W,
                    int level1) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= W || y >= H) return;
  const long long plane = (long long)blockIdx.z * H * W;
  const float* src = img + plane;
  const long long at = plane + (long long)y * W + x;
  out0[at] = __ldg(src + (long long)y * W + x);
  if (level1) out1[at] = resize_at(src, W, lv, y, x);
}

// Level l >= 2 resized from level l - 1 of the stack.
__global__ void __launch_bounds__(BX * BY)
pyramid_level_kernel(const float* __restrict__ prev, float* __restrict__ out,
                     Level lv, int H, int W) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= W || y >= H) return;
  const long long plane = (long long)blockIdx.z * H * W;
  out[plane + (long long)y * W + x] = resize_at(prev + plane, W, lv, y, x);
}

}  // namespace

// img (B, H, W) float32, out (L B, H, W) float32; tables: a host array of
// 4 (L - 1) device pointers (per level >= 1: vertical taps, first rows,
// horizontal taps, first columns); dims: a host array of 4 L ints (per
// level: h, w, vertical K, horizontal K). L - 1 launches (one at L = 1).
extern "C" int mc_orb_pyramid(const void* img, void* out,
                              const void* const* tables, const int* dims,
                              int B, int H, int W, int L, void* stream) {
  if (B < 0 || H < 1 || W < 1 || L < 1 || B > 65535) return cudaErrorInvalidValue;
  if (B == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 block(BX, BY);
  const dim3 grid((W + BX - 1) / BX, (H + BY - 1) / BY, B);
  const long long plane = (long long)B * H * W;
  float* o = static_cast<float*>(out);
  Level lv[2];
  auto level = [&](int l) {
    Level v;
    v.tv = static_cast<const float*>(tables[4 * (l - 1)]);
    v.fv = static_cast<const int*>(tables[4 * (l - 1) + 1]);
    v.th = static_cast<const float*>(tables[4 * (l - 1) + 2]);
    v.fh = static_cast<const int*>(tables[4 * (l - 1) + 3]);
    v.h = dims[4 * l];
    v.w = dims[4 * l + 1];
    v.kv = dims[4 * l + 2];
    v.kh = dims[4 * l + 3];
    return v;
  };
  for (int l = 1; l < L; ++l) {
    const Level v = level(l);
    if (v.kv < 0 || v.kv > MAX_TAPS || v.kh < 0 || v.kh > MAX_TAPS ||
        v.h < 1 || v.h > H || v.w < 1 || v.w > W)
      return cudaErrorInvalidValue;
  }
  lv[0] = L > 1 ? level(1) : Level{};
  pyramid_base_kernel<<<grid, block, 0, s>>>(
      static_cast<const float*>(img), o, o + plane, lv[0], H, W, L > 1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  for (int l = 2; l < L; ++l) {
    lv[1] = level(l);
    pyramid_level_kernel<<<grid, block, 0, s>>>(o + (l - 1) * plane,
                                                o + l * plane, lv[1], H, W);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return 0;
}
