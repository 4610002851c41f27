// 4-path semi-global aggregation of a (D, H, W) float32 cost volume.
//
// mc_sgm_scan — the port's counterpart of the lax.scan of the jitted
// disparity's SGM (mcslam_tpu/ops/stereo.py _sgm_pass, scanned at :69 and
// summed by sgm_aggregate at :73); no Pallas kernel of the JAX package
// corresponds to it.
//
// Computes, for each of the four paths (+x, -x, +y, -y), Hirschmueller's
// recursion over the path's lines, as ops/sgm_cuda.sgm_aggregate_reference
// writes it: the first step is the cost itself; step s from the previous
// step's front prev (D values):
//   m    = min_d prev[d]
//   best = min(min(prev[d], m + p2), min(prev[d + 1], prev[d - 1]) + p1)
//   out  = (cost[d] + best) - m
// with 1e9 past either end of the disparities; then the sum of the four
// paths (a: +x, b: -x, c: +y, d: -y) in the plain order ((a + b) + c) + d.
// Every add is rounded on its own (__fadd_rn / __fsub_rn); there is no
// multiply, and the minima let a NaN win as torch.minimum / torch.amin do,
// so the result equals the plain version's bit for bit.
//
// Bound on the card: the inputs read once and the sum written once, 2 x
// 4 D H W bytes (157 MB at VGA, D = 64: ~47 us at 3.35 TB/s).
//
// Design for Hopper (the variants behind each choice, and their times, are
// scripts/sgm_variants.py's):
// * Tiles in whole sectors. A block owns LINES = 8 lines of one path (8
//   rows of a horizontal path, 8 columns of a vertical one) and walks them
//   in tiles of STEPS = 8 steps. In the volume a tile is D x 8 segments of
//   8 contiguous floats, one 32-byte sector each (8 steps along x of a
//   row, or the block's 8 columns of a row y). The tile, and the operands
//   its outputs are added to, are staged in shared memory by cp.async:
//   16-byte copies (cp.async.cg) where W % 4 == 0 and the pointers are
//   16-byte aligned, else 4-byte ones (the ragged path, W % 4 != 0); a
//   warp-wide copy moves whole sectors either way, and asks the L2 for the
//   whole 128-byte line (the block's next tiles or its neighbours read the
//   rest). The next tile is in flight while the current one is scanned (a
//   ring of STAGES = 2). A step's outputs are written over its costs in
//   shared memory, and the block stores the tile, the operands added, in
//   whole sectors too.
// * The scan: a warp per line. Lane l holds the disparities d = 32 k + l
//   (k < K = ceil(D / 32) <= 4) in registers. The line's minimum is the
//   lane's minimum, then one redux.sync over order-preserving integer keys
//   (a NaN takes the least key); the +-1 neighbours are one shuffle each.
//   A staged tile keeps each disparity's 64 floats at a stride of SD = 68
//   words (16-byte aligned), so the 32 lanes of a step fall on 8 banks, 4
//   to a bank, not all 32 on one.
// * The sum, fused, and the split. A path's lines are cut at their middle
//   tile, h = n / 2 of n tiles: the first part runs in one launch and
//   saves its front (the D values of its last step), the second continues
//   from that front in a later launch. Three launches on the stream:
//     1. +x on tiles [0, h) and -x on [h, n) write a and b into out;
//        +y on [0, h) and -y on [h, n) write c and d into scratch;
//     2. +x on [h, n): out = b + a;  -x on [0, h): out = a + b;
//     3. +y on [h, n): out = (ab + c) + d, d from scratch;
//        -y on [0, h): out = (ab + scratch's c) + d.
//   Float addition is commutative, so every output is ((a + b) + c) + d,
//   the plain order. That is 11 volume passes (the costs read 4 times;
//   out written 3 times and read twice; scratch written and read once)
//   and no sum pass over four volumes. scratch is one volume followed by
//   the fronts, 2 D (H + W) floats. Shared memory per block: STAGES x (1 +
//   launch) x D x SD floats (34.8 / 69.6 / 104.4 KB at D = 64, 208.9 KB
//   at most, launch 3 at D = 128).

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int LINES = 8;               // lines per block, a warp each
constexpr int STEPS = 8;               // steps per tile
constexpr int SD = LINES * STEPS + 4;  // words per disparity in a tile
constexpr int STAGES = 2;              // tiles in the ring
constexpr int MAX_OPS = 2;             // operand tiles beside the costs
constexpr int THREADS = LINES * 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float BIG = 1e9f;  // the disparity border of the plain version

// What a block stores at each output position (o: its path's value).
enum Mode : int {
  PUT_OUT,        // out = o
  PUT_SCRATCH,    // scratch = o
  ADD_OUT,        // out = out + o
  ADD_OUT_O_SCR,  // out = (out + o) + scratch
  ADD_OUT_SCR_O,  // out = (out + scratch) + o
};

// torch.minimum: a NaN operand wins, else the smaller
__device__ __forceinline__ float tmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// 16 and 4 bytes global -> shared; the L2 fetches the whole 128-byte line,
// whose other sectors the block's next tiles or its neighbours read
__device__ __forceinline__ void cp_async16(float* s, const float* g) {
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(s)),
               "l"(g));
}

__device__ __forceinline__ void cp_async4(float* s, const float* g) {
  asm volatile("cp.async.ca.shared.global.L2::128B [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(s)),
               "l"(g));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the STAGES - 2 newest groups of this thread have landed
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
}

// m: the line's minimum over its D disparities. The lane's minimum, then
// one redux.sync over integer keys in the floats' order (a negative
// float's magnitude bits flipped); a NaN takes the least key, so it wins.
template <int K>
__device__ __forceinline__ float line_min(const float (&prev)[K],
                                          const bool (&active)[K]) {
  float m = active[0] ? prev[0] : INFINITY;
#pragma unroll
  for (int k = 1; k < K; ++k)
    if (active[k]) m = tmin(m, prev[k]);
  const int nan_key = static_cast<int>(0x80000000u);
  const int bits = __float_as_int(m);
  const int key = isnan(m) ? nan_key : bits ^ ((bits >> 31) & 0x7fffffff);
  const int km = __reduce_min_sync(FULL, key);
  return km == nan_key ? __int_as_float(0x7fffffff)
                       : __int_as_float(km ^ ((km >> 31) & 0x7fffffff));
}

// One step of the recursion from prev; the step's costs, disparity 32 k +
// lane at at[32 k SD], are overwritten by its values, which become prev.
template <int K>
__device__ __forceinline__ void step(float (&prev)[K], const bool (&active)[K],
                                     float* at, int lane, float p1, float p2) {
  float c[K];
#pragma unroll
  for (int k = 0; k < K; ++k) c[k] = active[k] ? at[32 * k * SD] : 0.f;
  const float m = line_min<K>(prev, active);
  const float mp2 = __fadd_rn(m, p2);
  const int dn_src = (lane + 31) & 31;  // lane - 1, lane 0 reads lane 31
  const int up_src = (lane + 1) & 31;   // lane + 1, lane 31 reads lane 0
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
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (!active[k]) continue;  // stays BIG: the border of d = D - 1
    const float best =
        tmin(tmin(prev[k], mp2), __fadd_rn(tmin(up[k], dn[k]), p1));
    const float o = __fsub_rn(__fadd_rn(c[k], best), m);
    at[32 * k * SD] = o;
    prev[k] = o;
  }
}

// launch 0: the first parts of all four paths; 1: the second parts of the
// horizontal paths; 2: those of the vertical paths (see the note above).
// Blocks: launch 0 [+x | -x | +y | -y], 1 [+x | -x], 2 [+y | -y], each
// group ceil(lines / LINES) blocks. Dynamic shared memory: STAGES x (1 +
// launch) tiles of D x SD floats.
template <int K>
__global__ void __launch_bounds__(THREADS)
sgm_tile_kernel(const float* __restrict__ cv, float* __restrict__ out,
                float* __restrict__ scratch, int D, int H, int W, float p1,
                float p2, int launch, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int nbH = (H + LINES - 1) / LINES, nbV = (W + LINES - 1) / LINES;
  int b = blockIdx.x;
  const bool horiz = launch == 1 || (launch == 0 && b < 2 * nbH);
  if (launch == 0 && !horiz) b -= 2 * nbH;
  const int nb = horiz ? nbH : nbV;
  const bool fwd = b < nb;
  const int l0 = (fwd ? b : b - nb) * LINES;
  const int lines = horiz ? H : W, S = horiz ? W : H;
  const int n = (S + STEPS - 1) / STEPS, h = n / 2;
  // this block's tiles, walked in its path's direction: first and count
  const int first = launch == 0 ? (fwd ? 0 : n - 1) : (fwd ? h : h - 1);
  const int count = launch == 0 ? (fwd ? h : n - h) : (fwd ? n - h : h);
  if (count == 0) return;  // the whole block: no barrier is pending
  const int dj = fwd ? 1 : -1;
  const bool start = first == (fwd ? 0 : n - 1);  // it starts the lines
  const int mode = launch == 0 ? (horiz ? PUT_OUT : PUT_SCRATCH)
                   : launch == 1 ? ADD_OUT
                   : fwd         ? ADD_OUT_O_SCR
                                 : ADD_OUT_SCR_O;
  const int arrays = 1 + launch;  // the costs, then out, then scratch
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t tile_f = static_cast<size_t>(D) * SD;
  float* const fronts = scratch + D * plane +
                        (horiz ? 0 : 2 * static_cast<size_t>(D) * H) +
                        (fwd ? 0 : static_cast<size_t>(D) * lines);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int line = l0 + warp;
  const bool live = line < lines;  // whole warps
  // the words this thread copies and stores in each disparity plane of a
  // tile (64 words: segment e / 8, word e % 8): with 16-byte copies the 4
  // from e = 4 (tid % 16) for the disparities tid / 16 + 16 i, else word
  // e = tid % 64 for the disparities tid / 64 + 4 i
  const int per_plane = vec ? 16 : 64;
  const int e = (tid & (per_plane - 1)) * (vec ? 4 : 1);
  const int seg = e >> 3, col = e & 7;
  const int d0 = tid / per_plane, dd = THREADS / per_plane;
  // position of (disparity 0, word e) of tile j in the volume; false past
  // the volume's edge (a chunk of 4 lies wholly inside: W % 4 == 0)
  auto where = [&](int j, size_t& g) {
    const int y = horiz ? l0 + seg : j * STEPS + seg;
    const int x = horiz ? j * STEPS + col : l0 + col;
    g = static_cast<size_t>(y) * W + x;
    return y < H && x < W;
  };
  auto src = [&](int a) { return a == 0 ? cv : a == 1 ? out : scratch; };
  auto load = [&](int i) {  // the role's i-th tile into stage i % STAGES
    size_t g;
    if (!where(first + dj * i, g)) return;
    float* const s = smem + (i % STAGES) * arrays * tile_f + e;
    for (int d = d0; d < D; d += dd)
      for (int a = 0; a < arrays; ++a) {
        float* const to = s + a * tile_f + d * SD;
        const float* const from = src(a) + d * plane + g;
        if (vec)
          cp_async16(to, from);
        else
          cp_async4(to, from);
      }
  };
  // the value stored at a word: o its path's value, o[tile_f] out's and
  // o[2 tile_f] scratch's, staged beside it
  auto combine = [&](const float* o) -> float {
    switch (mode) {
      case ADD_OUT: return __fadd_rn(o[tile_f], o[0]);
      case ADD_OUT_O_SCR:
        return __fadd_rn(__fadd_rn(o[tile_f], o[0]), o[2 * tile_f]);
      case ADD_OUT_SCR_O:
        return __fadd_rn(__fadd_rn(o[tile_f], o[2 * tile_f]), o[0]);
      default: return o[0];  // PUT_OUT, PUT_SCRATCH
    }
  };
  auto store = [&](int i, const float* t) {
    size_t g;
    if (!where(first + dj * i, g)) return;
    float* const dst = (mode == PUT_SCRATCH ? scratch : out) + g;
    for (int d = d0; d < D; d += dd) {
      const float* o = t + d * SD + e;
      if (vec) {
        const float4 r = {combine(o), combine(o + 1), combine(o + 2),
                          combine(o + 3)};
        *reinterpret_cast<float4*>(dst + d * plane) = r;
      } else {
        dst[d * plane] = combine(o);
      }
    }
  };

  bool active[K];
  float prev[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = 32 * k + lane;
    active[k] = d < D;
    prev[k] = BIG;
    if (!start && live && active[k])
      prev[k] = fronts[static_cast<size_t>(d) * lines + line];
  }

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < count) load(i);
    cp_async_commit();  // possibly empty: keeps the ring's count exact
  }
  for (int i = 0; i < count; ++i) {
    cp_async_wait_ring();  // tile i has landed (this thread's copies)
    __syncthreads();       // everyone's; tile i - 1's stage is stored
    if (i + STAGES - 1 < count) load(i + STAGES - 1);
    cp_async_commit();
    float* const t = smem + (i % STAGES) * arrays * tile_f;
    if (live) {  // the recursion over this tile's steps
      const int j = first + dj * i;
      const int steps = min(STEPS, S - j * STEPS);
      float* const at = t + lane * SD + (horiz ? warp * STEPS : warp);
      const int per_step = horiz ? 1 : LINES;  // words between steps
      for (int u = 0; u < steps; ++u) {
        float* const p = at + (fwd ? u : steps - 1 - u) * per_step;
        if (start && i == 0 && u == 0) {  // the first step: the cost itself
#pragma unroll
          for (int k = 0; k < K; ++k)
            if (active[k]) prev[k] = p[32 * k * SD];
        } else {
          step<K>(prev, active, p, lane, p1, p2);
        }
      }
    }
    __syncthreads();  // the tile's values are all written
    store(i, t);
  }
  if (launch == 0 && live) {  // the front the second part starts from
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (active[k])
        fronts[static_cast<size_t>(32 * k + lane) * lines + line] = prev[k];
  }
}

size_t smem_bytes(int D, int launch) {
  return static_cast<size_t>(STAGES) * (1 + launch) * D * SD * sizeof(float);
}

std::atomic<uint64_t> smem_set[4];

// Opt kernel K into the shared memory of its largest launch (D = 32 K,
// launch 2) and the largest carveout, once per device.
template <int K>
cudaError_t allow_smem() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = 1ull << (dev & 63);
  if (smem_set[K - 1].load(std::memory_order_acquire) & bit) return cudaSuccess;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  const size_t want = smem_bytes(32 * K, MAX_OPS);
  e = cudaFuncSetAttribute(sgm_tile_kernel<K>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(want < static_cast<size_t>(optin)
                                                ? want : optin));
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(sgm_tile_kernel<K>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) smem_set[K - 1].fetch_or(bit, std::memory_order_release);
  return e;
}

template <int K>
cudaError_t run(const float* cv, float* out, float* scratch, int D, int H,
                int W, float p1, float p2, cudaStream_t s) {
  cudaError_t e = allow_smem<K>();
  if (e != cudaSuccess) return e;
  const unsigned nbH = (H + LINES - 1) / LINES, nbV = (W + LINES - 1) / LINES;
  const unsigned grid[3] = {2 * (nbH + nbV), 2 * nbH, 2 * nbV};
  const bool vec = W % 4 == 0 && (reinterpret_cast<uintptr_t>(cv) |
                                  reinterpret_cast<uintptr_t>(out) |
                                  reinterpret_cast<uintptr_t>(scratch)) %
                                         16 == 0;
  for (int launch = 0; launch < 3; ++launch) {
    sgm_tile_kernel<K><<<grid[launch], THREADS, smem_bytes(D, launch), s>>>(
        cv, out, scratch, D, H, W, p1, p2, launch, vec);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// cv (D, H, W) f32 contiguous; out (D, H, W) f32; scratch D H W + 2 D (H +
// W) f32 (a volume, then the paths' fronts); 1 <= D <= 128. Three
// launches on `stream`.
extern "C" int mc_sgm_scan(const void* cv, void* out, void* scratch, int D,
                           int H, int W, float p1, float p2, void* stream) {
  if (D < 1 || D > 128 || H < 1 || W < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(cv);
  float* o = static_cast<float*>(out);
  float* t = static_cast<float*>(scratch);
  switch ((D + 31) / 32) {
    case 1: return run<1>(c, o, t, D, H, W, p1, p2, s);
    case 2: return run<2>(c, o, t, D, H, W, p1, p2, s);
    case 3: return run<3>(c, o, t, D, H, W, p1, p2, s);
    default: return run<4>(c, o, t, D, H, W, p1, p2, s);
  }
}
