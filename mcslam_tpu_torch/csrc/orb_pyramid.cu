// The ORB pyramid, written straight into the stacked level batch that
// fast_select reads, each level resized from the one before in a fixed
// tap order, all levels of a tile in one launch.
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
// version's order, so the two agree bit for bit; every value depends on
// its image alone and is computed in the same order wherever it is
// computed, so any tiling and any batch size give the same bits.
//
// Bound on the card: bytes. At the bench shape (16 planes of 480 x 640
// out of 4 images, 4 levels) the input is 4.9 MB and the stack 19.7 MB,
// ~7.3 us at 3.35 TB/s; each output needs K^2 <= 9 multiplies and adds.
// Design (pyramid_tile_kernel; the tiling is ops/orb_cuda.pyramid_plan):
//  - one launch computes levels la..lb from level la - 1 (the input, or
//    the stack a launch before wrote): at the bench shape all levels in
//    one launch, of at most two blocks a multiprocessor (one wave; the
//    shared-memory carveout set to its maximum, at most 64 registers a
//    thread). A block (512 threads) owns tile (ty, tx) of image b in
//    every level: of each level's true rows and columns the ty-th and
//    tx-th of TY x TX equal parts, and as well the ty-th and tx-th parts
//    of its edge-replicated rows [h_l, H) and columns [w_l, W), which it
//    writes as copies of the edge row and column. So every pixel of the
//    stack is written by one block, and the replicated two thirds of the
//    deepest levels are spread over all blocks;
//  - what a block computes at each level is a region of at most two row
//    ranges by two column ranges: its part, the edge index where it
//    writes copies, and the taps' support of what the next level needs
//    (halo values are computed by several blocks, in the same order,
//    hence with the same bits). The region of the source level is staged
//    once into shared memory (a flat walk of loads, batches of eight a
//    thread, all issued before any is stored), after the tile's plan
//    entries of every level; with it, a warp per level and axis stages
//    that level's tap table for the tile: the rows of the pyramid's one
//    table (ops/orb_cuda.pyramid_levels: per output index its first tap's
//    index in the level before and its weights) that its computed rows or
//    columns take, so no level waits on a global load. A first tap's
//    index becomes local to the previous region by that level's plan
//    entry (Entry::loc). Each level's
//    region is then computed in shared memory from the one before in two
//    steps of one barrier each, both latency-bound chains of shared loads
//    and float32 operations, so each thread keeps several outputs in
//    flight: the vertical pass, a warp per output row with the row's
//    weights in registers and four columns a lane at a time, into a
//    buffer of the level's rows by the previous region's columns; then
//    the horizontal pass, a thread per output column with its weights in
//    registers, down the rows. The regions alternate between two
//    buffers, and both passes are compiled for K = 2 and 3 taps (the
//    pyramid's 1.2 scale gives K <= 3) besides any K <= MAX_TAPS;
//  - after its barrier a level's part is stored (a warp per row, lanes
//    across the columns, level 0 by 16-byte stores where W % 4 == 0)
//    while the next level is computed.
// Nothing carries over between calls: the call can be captured in a CUDA
// graph and replayed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;  // orb_cuda.PYRAMID_THREADS
constexpr int NWARPS = THREADS / 32;
constexpr int MAX_TAPS = 8;    // image.MAX_TAPS
constexpr int MAX_LEVELS = 8;  // orb_cuda.PYRAMID_MAX_LEVELS
constexpr int ENTRY = 8;       // ints of a plan entry (orb_cuda._axis_plan)
constexpr int SEG_INTS = 8;    // a launch's ints in segs
constexpr int DIMS = 6;        // a level's ints in dims
constexpr int SMEM_LIMIT = 232448;  // bytes a block may use on sm_90
constexpr int LOADS = 8;  // global loads a thread keeps in flight while staging

struct Level {
  int h, w;    // the level's true size
  int kv, kh;  // taps per output, 0: the axis keeps its size
  int vt, ht;  // offsets of its two passes' tap tables in the taps array
};

struct Seg {
  Level lv[MAX_LEVELS];  // levels la..lb
  // row entries (nlev, TY, ENTRY), then column entries (nlev, TX, ENTRY)
  const int* plan;
  // the pyramid's tap tables, per output index (first tap, K weights)
  const int* taps;
  int la, lb, TY, TX;
  int buf_a, buf_b, vbuf;  // floats of the shared buffers
};

// A plan entry: the computed ranges [a0, a1] and [b0, b1] (b1 < b0: none),
// the true part [t0, t1) and the replicated part [r0, r1) written.
struct Entry {
  int a0, a1, b0, b1, t0, t1, r0, r1;
  __device__ __forceinline__ int span() const {
    return a1 - a0 + 1 + max(0, b1 - b0 + 1);
  }
  __device__ __forceinline__ int loc(int y) const {  // index -> local
    return y <= a1 ? y - a0 : a1 - a0 + 1 + y - b0;
  }
  __device__ __forceinline__ int at(int r) const {  // local -> index
    const int na = a1 - a0 + 1;
    return r < na ? a0 + r : b0 + r - na;
  }
  __device__ __forceinline__ int owned() const { return t1 - t0 + r1 - r0; }
  __device__ __forceinline__ int own(int k) const {  // k-th written index
    return k < t1 - t0 ? t0 + k : r0 + k - (t1 - t0);
  }
};

__device__ __forceinline__ Entry shared_entry(const int* p) {
  return Entry{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7]};
}

// seg.lv[q] into registers, selected without indexing the parameter at
// run time (which would copy it to local memory)
__device__ __forceinline__ Level level_of(const Seg& seg, int q) {
  Level v = seg.lv[0];
#pragma unroll
  for (int k = 1; k < MAX_LEVELS; ++k)
    if (k == q) v = seg.lv[k];
  return v;
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// K taps' sum, w[0] x[0] + w[1] x[s] + ..., left to right (KC > 0: K ==
// KC known at compile time; else K <= MAX_TAPS at run time)
template <int KC>
__device__ __forceinline__ float taps(const float (&w)[MAX_TAPS], int K,
                                      const float* x, int s) {
  float t = mul(w[0], x[0]);
#pragma unroll
  for (int q = 1; q < (KC > 0 ? KC : MAX_TAPS); ++q)
    if (KC > 0 || q < K) t = add(t, mul(w[q], x[q * s]));
  return t;
}

// The vertical pass of output row r: v[c] for c < ncp from the source
// rows s0, s0 + ncp, ... (K taps, weights w)
template <int KC>
__device__ __forceinline__ void vertical_row(float* v, const float* s0,
                                             const float (&w)[MAX_TAPS],
                                             int K, int ncp, int lane) {
#pragma unroll 4
  for (int c = lane; c < ncp; c += 32) v[c] = taps<KC>(w, K, s0 + c, ncp);
}

// The horizontal pass of one column down the rows r0, r0 + rs, ...
template <int KC>
__device__ __forceinline__ void horizontal_col(float* D, const float* vb,
                                               const float (&w)[MAX_TAPS],
                                               int K, int f, int x, int nc,
                                               int ncp, int nr, int r0,
                                               int rs) {
#pragma unroll 4
  for (int r = r0; r < nr; r += rs)
    D[r * nc + x] = taps<KC>(w, K, vb + r * ncp + f, 1);
}

__global__ void __launch_bounds__(THREADS, 2)
pyramid_tile_kernel(const float* __restrict__ img, float* __restrict__ out,
                    const Seg seg, int B, int H, int W) {
  extern __shared__ __align__(16) float smem[];
  const int tx = blockIdx.x, ty = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nlev = seg.lb - seg.la + 2;
  const int TY = seg.TY, TX = seg.TX;
  const int* prow = seg.plan;
  const int* pcol = seg.plan + (long long)nlev * TY * ENTRY;
  float* const buf_a = smem;  // the source level, then every other level
  float* const buf_b = smem + seg.buf_a;
  float* const vb = buf_b + seg.buf_b;  // a level's vertical pass
  // every level's row and column plan entries, then the tile's tap tables
  // (per level >= 1 its rows', then its columns': per computed index its
  // first tap's index in the level before, then its weights)
  int* const sent = reinterpret_cast<int*>(vb + seg.vbuf);
  int* const itab = sent + 2 * ENTRY * nlev;
  const long long plane = (long long)H * W;

  for (int t = tid; t < 2 * ENTRY * nlev; t += THREADS) {
    const int k = t / (2 * ENTRY), q = t % (2 * ENTRY);
    sent[t] = __ldg(q < ENTRY ? prow + (k * TY + ty) * ENTRY + q
                              : pcol + (k * TX + tx) * ENTRY + q - ENTRY);
  }
  __syncthreads();
  Entry er = shared_entry(sent), ec = shared_entry(sent + ENTRY);
  // warp j < 2 (nlev - 1) stages the tap table of level 1 + j / 2, rows
  // (j even) or columns (j odd), after the tables of the warps before it
  if (warp < 2 * (nlev - 1)) {
    int off = 0, n = 0, k1 = 1;
    const int* g = seg.taps;
    Entry e = er;
    for (int j = 0; j <= warp; ++j) {
      const Level lv = level_of(seg, j >> 1);
      const int K = j & 1 ? lv.kh : lv.kv;
      const Entry ej = shared_entry(sent + ENTRY * (2 + j));
      const int nj = K ? ej.span() * (K + 1) : 0;
      if (j < warp) {
        off += nj;
      } else {
        n = nj;
        e = ej;
        k1 = K + 1;
        g += j & 1 ? lv.ht : lv.vt;
      }
    }
    for (int i0 = lane; i0 < n; i0 += LOADS * 32) {
      int v[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int i = i0 + 32 * u, r = i / k1;
        v[u] = i < n ? __ldg(g + e.at(r) * k1 + (i - r * k1)) : 0;
      }
#pragma unroll
      for (int u = 0; u < LOADS; ++u)
        if (i0 + 32 * u < n) itab[off + i0 + 32 * u] = v[u];
    }
  }
  // the source level's region, eight loads in flight a thread
  {
    const float* src = seg.la == 1
        ? img + b * plane
        : out + ((long long)(seg.la - 1) * B + b) * plane;
    const int nc = ec.span(), n = er.span() * nc;
    // each thread's loads in batches of LOADS, all issued before any is
    // stored (a store waits for its load; loads behind it would wait too)
    for (int e0 = tid; e0 < n; e0 += LOADS * THREADS) {
      float v[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int e = e0 + u * THREADS, r = e / nc;
        v[u] = e < n ? __ldg(src + (long long)er.at(r) * W +
                             ec.at(e - r * nc))
                     : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < LOADS; ++u)
        if (e0 + u * THREADS < n) buf_a[e0 + u * THREADS] = v[u];
    }
  }
  __syncthreads();
  if (seg.la == 1) {  // level 0, a copy of its part (16-byte stores if aligned)
    float* dst = out + b * plane;
    const int nc = ec.span();
    const int n = ec.t1 - ec.t0;
    const bool quad = W % 4 == 0 && ec.t0 % 4 == 0 && n % 4 == 0 &&
                      (reinterpret_cast<uintptr_t>(out) & 15) == 0;
    for (int y = er.t0 + warp; y < er.t1; y += NWARPS) {
      const float* row = buf_a + er.loc(y) * nc + ec.loc(ec.t0);
      float* o = dst + (long long)y * W + ec.t0;
      if (quad) {
        for (int c = 4 * lane; c < n; c += 128)
          *reinterpret_cast<float4*>(o + c) =
              make_float4(row[c], row[c + 1], row[c + 2], row[c + 3]);
      } else {
#pragma unroll 4
        for (int c = lane; c < n; c += 32) o[c] = row[c];
      }
    }
  }

  const int* tv = itab;  // this level's row table in the tile's tables
  for (int k = 1; k < nlev; ++k) {
    const Level lv = level_of(seg, k - 1);
    const Entry pr = er, pc = ec;  // the previous region
    const int ncp = pc.span();
    er = shared_entry(sent + 2 * ENTRY * k);
    ec = shared_entry(sent + 2 * ENTRY * k + ENTRY);
    const bool odd = k & 1;
    const float* S = odd ? buf_a : buf_b;
    float* D = odd ? buf_b : buf_a;
    const int nr = er.span(), nc = ec.span();
    const int kv = lv.kv, kh = lv.kh;
    const int* th = tv + (kv ? nr * (kv + 1) : 0);  // its column table
    float w[MAX_TAPS];
    // the vertical pass: a warp per output row, the row's weights in
    // registers, over every column of the previous region
    for (int r = warp; r < nr; r += NWARPS) {
      const int* tr = tv + r * (kv + 1);
      float* v = vb + r * ncp;
      if (kv == 0) {
        const float* s0 = S + pr.loc(er.at(r)) * ncp;
#pragma unroll 4
        for (int c = lane; c < ncp; c += 32) v[c] = s0[c];
      } else {
        const float* s0 = S + pr.loc(tr[0]) * ncp;
#pragma unroll
        for (int q = 0; q < MAX_TAPS; ++q)
          w[q] = q < kv ? __int_as_float(tr[1 + q]) : 0.0f;
        if (kv == 3) vertical_row<3>(v, s0, w, kv, ncp, lane);
        else if (kv == 2) vertical_row<2>(v, s0, w, kv, ncp, lane);
        else vertical_row<0>(v, s0, w, kv, ncp, lane);
      }
    }
    __syncthreads();
    // the horizontal pass: a thread per output column, its weights in
    // registers, down the rows
    {
      const int x = tid % nc, r0 = tid / nc, rs = THREADS / nc;
      if (r0 < rs) {
        const int* tc = th + x * (kh + 1);
        if (kh == 0) {
          const int f = pc.loc(ec.at(x));
#pragma unroll 4
          for (int r = r0; r < nr; r += rs) D[r * nc + x] = vb[r * ncp + f];
        } else {
          const int f = pc.loc(tc[0]);
#pragma unroll
          for (int q = 0; q < MAX_TAPS; ++q)
            w[q] = q < kh ? __int_as_float(tc[1 + q]) : 0.0f;
          if (kh == 3) horizontal_col<3>(D, vb, w, kh, f, x, nc, ncp, nr, r0, rs);
          else if (kh == 2) horizontal_col<2>(D, vb, w, kh, f, x, nc, ncp, nr, r0, rs);
          else horizontal_col<0>(D, vb, w, kh, f, x, nc, ncp, nr, r0, rs);
        }
      }
    }
    tv = th + (kh ? nc * (kh + 1) : 0);
    __syncthreads();
    // this level's part: its true part and its share of the replicated
    // rows and columns (copies of the edge row and column)
    const int l = seg.la + k - 1;
    float* dst = out + ((long long)l * B + b) * plane;
    const int nrow = er.owned(), ncol = ec.owned();
    for (int q = warp; q < nrow; q += NWARPS) {
      const int y = er.own(q);
      const float* row = D + er.loc(min(y, lv.h - 1)) * nc;
      float* o = dst + (long long)y * W;
#pragma unroll 4
      for (int c = lane; c < ncol; c += 32) {
        const int x = ec.own(c);
        o[x] = row[ec.loc(min(x, lv.w - 1))];
      }
    }
  }
}

}  // namespace

// img (B, H, W) float32, out (L B, H, W) float32; taps: the pyramid's tap
// tables (device ints, orb_cuda.pyramid_levels); dims: a host array of
// DIMS L ints (per level: h, w, vertical K, horizontal K, and the offsets
// of its two tables in taps); plans: a host array of nseg device pointers
// (each launch's plan entries, orb_cuda.pyramid_plan); segs: a host array
// of SEG_INTS nseg ints (per launch: la, lb, TY, TX, shared bytes, the
// floats of buffer A, buffer B and the vertical pass). nseg launches.
extern "C" int mc_orb_pyramid(const void* img, void* out, const void* taps,
                              const int* dims, const void* const* plans,
                              const int* segs, int nseg, int B, int H, int W,
                              int L, void* stream) {
  if (B < 0 || H < 1 || W < 1 || L < 1 || B > 65535 || nseg < 1)
    return cudaErrorInvalidValue;
  if (B == 0) return 0;
  for (int l = 1; l < L; ++l) {
    const int* d = dims + DIMS * l;
    if (d[2] < 0 || d[2] > MAX_TAPS || d[3] < 0 || d[3] > MAX_TAPS ||
        d[0] < 1 || d[0] > H || d[1] < 1 || d[1] > W || d[4] < 0 || d[5] < 0)
      return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  for (int k = 0; k < nseg; ++k) {
    const int* g = segs + SEG_INTS * k;
    Seg seg{};
    seg.la = g[0];
    seg.lb = g[1];
    seg.TY = g[2];
    seg.TX = g[3];
    const int smem = g[4];
    seg.buf_a = g[5];
    seg.buf_b = g[6];
    seg.vbuf = g[7];
    seg.plan = static_cast<const int*>(plans[k]);
    seg.taps = static_cast<const int*>(taps);
    if (seg.la < 1 || seg.lb >= L || seg.lb - seg.la + 1 > MAX_LEVELS ||
        seg.lb < seg.la - 1 || seg.TY < 1 || seg.TX < 1 || seg.TY > 65535 ||
        seg.TX > 65535 || smem < 0 || smem > SMEM_LIMIT)
      return cudaErrorInvalidValue;
    for (int l = seg.la; l <= seg.lb; ++l) {
      const int* d = dims + DIMS * l;
      seg.lv[l - seg.la] = Level{d[0], d[1], d[2], d[3], d[4], d[5]};
    }
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          pyramid_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (e != cudaSuccess) return e;
    }
    // all of the unified L1 / shared memory as shared, so that two blocks
    // fit a multiprocessor and the plan's blocks run in one wave
    const cudaError_t e = cudaFuncSetAttribute(
        pyramid_tile_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    pyramid_tile_kernel<<<dim3(seg.TX, seg.TY, B), THREADS, smem, s>>>(
        static_cast<const float*>(img), static_cast<float*>(out), seg, B, H,
        W);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return 0;
}
