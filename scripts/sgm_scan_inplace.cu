// The SGM scan kernel's earlier design (one warp per line reading the
// volume in place, three scratch volumes and a sum pass), kept as the
// baseline of scripts/sgm_variants.py; the package builds csrc/sgm_scan.cu.
//
// 4-path semi-global aggregation of a (D, H, W) float32 cost volume.
//
// mc_sgm_scan — the port's counterpart of the lax.scan of the jitted
// disparity's SGM (mcslam_tpu/ops/stereo.py _sgm_pass, scanned at :69 and
// summed by sgm_aggregate at :73); no Pallas kernel of the JAX package
// corresponds to it.
//
// Computes, for each of the four paths (0: along +x, 1: along -x, 2: along
// +y, 3: along -y), Hirschmueller's recursion over the path's lines, as
// ops/sgm_cuda.sgm_aggregate_reference writes it: the first step is the
// cost itself; step s from the previous step's front prev (D values):
//   m    = min_d prev[d]
//   best = min(min(prev[d], m + p2), min(prev[d + 1], prev[d - 1]) + p1)
//   out  = (cost[d] + best) - m
// with 1e9 past either end of the disparities; then the sum of the four
// paths in the plain order ((a + b) + c) + d. Every add is rounded on its
// own (__fadd_rn / __fsub_rn); there is no multiply, and the minima follow
// torch.minimum / torch.amin (a NaN wins), so the result equals the plain
// version's bit for bit.
//
// Design: one warp per line, eight adjacent lines per 256-thread block,
// all four paths in one launch (blockIdx.y is the path). Lane l holds the
// disparities d = 32 k + l (k < K = ceil(D / 32) <= 4) in registers; the
// per-line minimum is a butterfly of xor-shuffles and the +-1 neighbours
// one rotating shuffle each. The volume is read in place, not staged: a
// vertical path's eight columns share each 32-byte sector (one block,
// one L1), a horizontal path's line reads the same sectors over eight
// consecutive steps; the next step's costs are loaded before the current
// step is computed. Path 0 writes `out`, paths 1-3 their own volume of
// `scratch` (3 x D x H x W floats), and a second launch adds them in place
// in the plain order.
//
// Bound on the card: the inputs read once and the sum written once, 2 x
// 4 D H W bytes (157 MB at VGA, D = 64: ~47 us at 3.35 TB/s); the work is
// a chain of H or W dependent steps per line over only 2 (H + W) lines,
// so the kernel is bound by that chain's latency, not by bytes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 8;  // lines per block
constexpr unsigned FULL = 0xffffffffu;
constexpr float BIG = 1e9f;  // the disparity border of the plain version

// torch.minimum: a NaN operand wins, else the smaller
__device__ __forceinline__ float tmin(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

template <int K>
__global__ void __launch_bounds__(WARPS * 32)
sgm_path_kernel(const float* __restrict__ cv, float* __restrict__ out,
                float* __restrict__ scratch, int D, int H, int W, float p1,
                float p2) {
  const int path = blockIdx.y;
  const bool horizontal = path < 2;
  const bool forward = (path & 1) == 0;
  const int lines = horizontal ? H : W;
  const int line = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (line >= lines) return;  // whole warps only: no barrier follows
  const int lane = threadIdx.x & 31;
  const int S = horizontal ? W : H;
  const size_t plane = static_cast<size_t>(H) * W;
  // element (d, step s) of this line: base + d * plane + pos(s) * stride
  const size_t base = horizontal ? static_cast<size_t>(line) * W : line;
  const size_t stride = horizontal ? 1 : W;
  float* __restrict__ dst = path == 0 ? out : scratch + (path - 1) * D * plane;

  bool active[K];
  size_t dofs[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = 32 * k + lane;
    active[k] = d < D;
    dofs[k] = static_cast<size_t>(active[k] ? d : 0) * plane + base;
  }
  auto pos = [&](int s) -> size_t {
    return static_cast<size_t>(forward ? s : S - 1 - s) * stride;
  };

  float prev[K], nxt[K];
  {
    const size_t p = pos(0);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      prev[k] = active[k] ? cv[dofs[k] + p] : BIG;
      if (active[k]) dst[dofs[k] + p] = prev[k];
    }
  }
  if (S > 1) {
    const size_t p = pos(1);
#pragma unroll
    for (int k = 0; k < K; ++k) nxt[k] = active[k] ? cv[dofs[k] + p] : BIG;
  }
  const int dn_src = (lane + 31) & 31;  // lane - 1, lane 0 reads lane 31
  const int up_src = (lane + 1) & 31;   // lane + 1, lane 31 reads lane 0
  for (int s = 1; s < S; ++s) {
    float c[K];
#pragma unroll
    for (int k = 0; k < K; ++k) c[k] = nxt[k];
    if (s + 1 < S) {  // the next step's costs, in flight during this one
      const size_t p = pos(s + 1);
#pragma unroll
      for (int k = 0; k < K; ++k) nxt[k] = active[k] ? cv[dofs[k] + p] : BIG;
    }
    // m: the line's minimum over its D disparities
    float m = active[0] ? prev[0] : INFINITY;
#pragma unroll
    for (int k = 1; k < K; ++k)
      if (active[k]) m = tmin(m, prev[k]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = tmin(m, __shfl_xor_sync(FULL, m, off));
    const float mp2 = __fadd_rn(m, p2);
    float dn[K], up[K];  // prev[d - 1], prev[d + 1]
#pragma unroll
    for (int k = 0; k < K; ++k) {
      // lane 31 hands lane 0 the slot below (d - 1 = 32 k - 1), lane 0
      // hands lane 31 the slot above (d + 1 = 32 (k + 1))
      const float below = lane == 31 ? (k > 0 ? prev[k - 1] : BIG) : prev[k];
      const float above = lane == 0 ? (k + 1 < K ? prev[k + 1] : BIG) : prev[k];
      dn[k] = __shfl_sync(FULL, below, dn_src);
      up[k] = __shfl_sync(FULL, above, up_src);
    }
    if (lane == 0) dn[0] = BIG;
    const size_t p = pos(s);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!active[k]) continue;  // stays BIG: the border of d = D - 1
      const float best =
          tmin(tmin(prev[k], mp2), __fadd_rn(tmin(up[k], dn[k]), p1));
      const float o = __fsub_rn(__fadd_rn(c[k], best), m);
      dst[dofs[k] + p] = o;
      prev[k] = o;
    }
  }
}

// out = ((out + s0) + s1) + s2 elementwise: paths a, b, c, d in the plain
// order; four floats per thread where n and the pointers allow
__global__ void sgm_sum_kernel(float* __restrict__ out,
                               const float* __restrict__ s0,
                               const float* __restrict__ s1,
                               const float* __restrict__ s2, size_t n,
                               bool vec4) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (vec4) {
    if (i >= n / 4) return;
    float4 a = reinterpret_cast<float4*>(out)[i];
    const float4 b = reinterpret_cast<const float4*>(s0)[i];
    const float4 c = reinterpret_cast<const float4*>(s1)[i];
    const float4 d = reinterpret_cast<const float4*>(s2)[i];
    a.x = __fadd_rn(__fadd_rn(__fadd_rn(a.x, b.x), c.x), d.x);
    a.y = __fadd_rn(__fadd_rn(__fadd_rn(a.y, b.y), c.y), d.y);
    a.z = __fadd_rn(__fadd_rn(__fadd_rn(a.z, b.z), c.z), d.z);
    a.w = __fadd_rn(__fadd_rn(__fadd_rn(a.w, b.w), c.w), d.w);
    reinterpret_cast<float4*>(out)[i] = a;
  } else if (i < n) {
    out[i] = __fadd_rn(__fadd_rn(__fadd_rn(out[i], s0[i]), s1[i]), s2[i]);
  }
}

}  // namespace

// cv (D, H, W) f32 contiguous; out (D, H, W) f32; scratch (3, D, H, W) f32;
// 1 <= D <= 128. Two launches on `stream`: the four paths, then the sum.
extern "C" int mc_sgm_scan(const void* cv, void* out, void* scratch, int D,
                           int H, int W, float p1, float p2, void* stream) {
  if (D < 1 || D > 128 || H < 1 || W < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((max(H, W) + WARPS - 1) / WARPS, 4);
  const float* c = static_cast<const float*>(cv);
  float* o = static_cast<float*>(out);
  float* t = static_cast<float*>(scratch);
  switch ((D + 31) / 32) {
    case 1: sgm_path_kernel<1><<<grid, WARPS * 32, 0, s>>>(c, o, t, D, H, W, p1, p2); break;
    case 2: sgm_path_kernel<2><<<grid, WARPS * 32, 0, s>>>(c, o, t, D, H, W, p1, p2); break;
    case 3: sgm_path_kernel<3><<<grid, WARPS * 32, 0, s>>>(c, o, t, D, H, W, p1, p2); break;
    default: sgm_path_kernel<4><<<grid, WARPS * 32, 0, s>>>(c, o, t, D, H, W, p1, p2); break;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t n = static_cast<size_t>(D) * H * W;
  const bool vec4 =
      n % 4 == 0 && reinterpret_cast<uintptr_t>(o) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(t) % 16 == 0;  // n % 4: each volume too
  const size_t items = vec4 ? n / 4 : n;
  const unsigned blocks = static_cast<unsigned>((items + 255) / 256);
  sgm_sum_kernel<<<blocks, 256, 0, s>>>(o, t, t + n, t + 2 * n, n, vec4);
  return cudaGetLastError();
}
