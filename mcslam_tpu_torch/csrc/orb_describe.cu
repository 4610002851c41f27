// ORB orientation and steered BRIEF-256 in one launch: the
// intensity-centroid angle of each patch and its descriptor in the
// angle's steering bin.
//
// Replaces: the TPU-shaped descriptor stage of the JAX package's ORB
// extraction, mcslam_tpu/ops/orb.py patch_orientation (:114, the moments
// as one (N, 39^2) @ (39^2, 2) MXU product) and compute_descriptors_patch
// (:161, every bin's bits as one bf16 (N, 39^2) x (39^2, bins 256) MXU
// matmul, then the bin's slice and the packing). No Pallas kernel
// corresponds to them. In the port the plain version is
// ops/orb_cuda.orb_describe_reference (orb.patch_orientation's halving
// tree, torch.atan2, orb.compute_descriptors_patch: ~60 tensor ops).
//
// Computes, per patch (39 x 39 float32, p = 39 row + column):
//  1. m10 and m01: the products patch[p] * kx[p] and patch[p] * ky[p] (kx,
//     ky the circular moment weights: the column / row offset from the
//     centre inside radius 15, else 0), zero at p >= 1521, summed over
//     the 2048 slots by the halving tree x[i] + x[i + n] for n = 1024,
//     512, ..., 1 (orb.patch_orientation's order, every add rounded);
//  2. angle = atan2f(m01, m10);
//  3. the steering bin: r = fmod(angle, 2 pi), plus 2 pi where r < 0
//     (torch.remainder), b = rint((r / 2 pi) * bins) % bins (a true
//     division, round half to even);
//  4. bit s of the descriptor = q - p > 0 for the bf16-rounded patch
//     values at the bin's sample pair s (orb._steered_sample_index), the
//     bits packed LSB-first into 8 words (hamming.pack_bits).
// The products and sums are __fmul_rn / __fadd_rn (never contracted), in
// the plain version's order, so the moments equal its bits on every
// device; atan2f is the function torch.atan2 calls on the card, compiled
// with the same default flags as torch's kernels.
//
// Bound on the card: bytes. The patches are read once: 3072 x 1521 x 4 B
// = 18.7 MB at the bench frame, ~5.6 us at 3.35 TB/s; the writes are 36 B
// a patch. Design: one warp per patch, 8 patches a block. Lane l reads the
// slots l + 32 k (k < 64; coalesced rows of 128 B), so the first six
// halvings of the tree (n = 1024 .. 32) pair slots of the same lane: the
// lane evaluates its 64 leaves' subtree depth first (a template
// recursion on the slot's low bits, 7 live values), and the last five
// (n = 16 .. 1) are __shfl_down_sync steps across the lanes, lane 0's
// value the sum. Every lane takes the angle from lane 0, computes the bin
// and, for word w, its bit 32 w + l from two gathered reads of the patch
// (L1 hits: the warp has just read it); __ballot_sync packs each word.
// No shared memory, no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PATCH = 39;
constexpr int PATCH_R = 19;
constexpr int CIRCLE_R2 = 15 * 15;
constexpr int PX = PATCH * PATCH;  // 1521
constexpr int WARPS = 8;

struct Moments {
  float x, y;
};

// slot p's products with the two moment weights
__device__ __forceinline__ Moments leaf(const float* patch, int p) {
  if (p >= PX) return {0.0f, 0.0f};
  const float v = __ldg(patch + p);
  const int dy = p / PATCH - PATCH_R, dx = p % PATCH - PATCH_R;
  const bool in = dx * dx + dy * dy <= CIRCLE_R2;
  return {__fmul_rn(v, in ? (float)dx : 0.0f),
          __fmul_rn(v, in ? (float)dy : 0.0f)};
}

// The value at index K of the lane's 64 leaves (slots lane + 32 k) after
// the halvings down to SIZE values: f(K, 64) = leaf K; f(K, n) = f(K, 2n)
// + f(K + n, 2n).
template <int K, int SIZE>
struct Tree {
  __device__ __forceinline__ static Moments eval(const float* patch, int lane) {
    const Moments a = Tree<K, SIZE * 2>::eval(patch, lane);
    const Moments b = Tree<K + SIZE, SIZE * 2>::eval(patch, lane);
    return {__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y)};
  }
};

template <int K>
struct Tree<K, 64> {
  __device__ __forceinline__ static Moments eval(const float* patch, int lane) {
    return leaf(patch, lane + 32 * K);
  }
};

__global__ void __launch_bounds__(32 * WARPS)
orb_describe_kernel(const float* __restrict__ patches,
                    const int16_t* __restrict__ index,
                    float* __restrict__ angle, int* __restrict__ desc, int T,
                    int bins, float two_pi) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (t >= T) return;
  const float* patch = patches + (long long)t * PX;
  Moments m = Tree<0, 1>::eval(patch, lane);
#pragma unroll
  for (int n = 16; n >= 1; n >>= 1) {
    m.x = __fadd_rn(m.x, __shfl_down_sync(0xffffffffu, m.x, n));
    m.y = __fadd_rn(m.y, __shfl_down_sync(0xffffffffu, m.y, n));
  }
  const float a = __shfl_sync(0xffffffffu, atan2f(m.y, m.x), 0);
  float r = fmodf(a, two_pi);
  if (r != 0.0f && r < 0.0f) r = __fadd_rn(r, two_pi);
  int b = (int)rintf(__fmul_rn(__fdiv_rn(r, two_pi), (float)bins));
  b %= bins;
  const int16_t* pairs = index + (long long)b * 256 * 2;
  unsigned word = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const int s = 32 * w + lane;
    const float p = __bfloat162float(__float2bfloat16_rn(__ldg(patch + pairs[2 * s])));
    const float q = __bfloat162float(__float2bfloat16_rn(__ldg(patch + pairs[2 * s + 1])));
    const unsigned bits = __ballot_sync(0xffffffffu, __fsub_rn(q, p) > 0.0f);
    if (lane == w) word = bits;
  }
  if (lane < 8) desc[(long long)t * 8 + lane] = (int)word;
  if (lane == 0) angle[t] = a;
}

}  // namespace

// patches (T, 39, 39) float32, index (bins, 256, 2) int16 flat patch
// positions of the steered (p, q) samples, angle (T,) float32, desc (T, 8)
// int32; two_pi = float32(2 pi). One launch.
extern "C" int mc_orb_describe(const void* patches, const void* index,
                               void* angle, void* desc, int T, int bins,
                               float two_pi, void* stream) {
  if (T < 0 || bins < 1) return cudaErrorInvalidValue;
  if (T == 0) return 0;
  orb_describe_kernel<<<(T + WARPS - 1) / WARPS, 32 * WARPS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(patches), static_cast<const int16_t*>(index),
      static_cast<float*>(angle), static_cast<int*>(desc), T, bins, two_pi);
  return cudaGetLastError();
}
