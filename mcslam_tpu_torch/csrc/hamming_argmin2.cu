// Gated Hamming matching: row best / second best / first argmin and the
// column first argmin; a tile launch and a small merge launch.
//
// Replaces: mcslam_tpu/ops/match_pallas.py hamming_argmin2 (_kernel).
//
// Computes, for query rows i < M and target columns j < N:
//   dist  = popcount(a_i XOR b_j) over the 256 descriptor bits, taken as
//           (256 - A.B^T) / 2 on +-1 bit planes, as the TPU kernel does;
//   d2    = sum_k ahat[i, k] * bhat[k, j], a plain f32 FMA loop over
//           DG <= 16 gate factors (never TF32: the validity terms are
//           +-1e13 biases that only work in true f32);
//   gated = d2 < thr2 ? dist : 2^20;
//   per row: the min, the first column attaining it, and the second best
//           (min over every other column);
//   per column (col_idx given): the first row attaining the min over rows.
// Ragged edges are masked in the kernel; no padding.
//
// Bound on the card: operations, not memory. At the production shapes
// (2048 x 2048 and 2048 x 4096) the inputs are < 0.5 MB, while the pair
// work is 12.6 M pairs of a 256-bit distance plus ~22 f32 gate and compare
// instructions. Design:
//  - the distances run on the tensor cores: mma.sync m16n8k32 s8 x s8 ->
//    s32 on +-1 planes, exact (sums of 256 terms of +-1). A block takes
//    128 rows (8 warps x 16) by 128 columns; its columns' planes are
//    unpacked once into shared memory (32 KB, chunk-swizzled so that the
//    fragment loads are free of bank conflicts) and shared by the 8 warps;
//    each warp unpacks its own rows' planes straight into A-fragment
//    registers (taller blocks unpack each column for more rows). The
//    descriptor bit behind each k slot is the same for A and B (thread
//    t of a quad holds words 2t, 2t+1; step s their byte s), which is all
//    the product needs (the planes and fragments: pm1_mma.cuh, shared
//    with intra_match.cu);
//  - every global load of a block is issued first (half a staged column
//    per thread, the thread's two rows), then the planes are unpacked;
//  - the epilogue works on the accumulator registers: the gate as an f32
//    FMA chain over the factors in order (DG rounded up to 8, 12, 14 or
//    16 by template; padding factors are zero on both sides: exact), read
//    from shared memory as float4 per column pair; the pair's value as an
//    integer code (distance, or 257 when gated); and then only integer
//    min / max on 32-bit keys whose low bits name the index, so that the
//    smallest key is the min and, among equal values, the first index: a
//    row's (best key, second key) over the thread's columns, merged across
//    the quad by shuffles; a column's key (code << 22 | row) over the
//    warp's 16 rows by shuffles, then over the block's 8 warps;
//  - the grid covers column splits x row tiles (256 blocks at 2048 x
//    2048, 512 at 2048 x 4096, two per SM); each block writes its per-row
//    partials for its split and its per-column keys for its row tile to
//    scratch, and the merge launch (one warp per row or column, lanes over
//    the partials, then a butterfly) combines them. Every merge is a min
//    with the first-index tie rule of ops/match.best_two, whose result
//    does not depend on the order. No atomics: two runs give equal
//    outputs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pm1_mma.cuh"

namespace {

constexpr int TM = 128;  // rows per block
constexpr int TN = 128;  // columns per block (one column split)
constexpr int WARPS = TM / 16;
constexpr int THREADS = 32 * WARPS;
constexpr int PER = THREADS / TN;  // threads staging one column
static_assert(PER * TN == THREADS, "whole columns per thread group");
constexpr int DGMAX = 16;
constexpr float BIGF = 1048576.f;  // ops/match.BIG
constexpr int NOIDX = 0x7fffffff;
constexpr int MERGE_THREADS = 256;
constexpr uint32_t GATED = 257;  // the code of a gated pair (BIGF)
constexpr uint32_t NOKEY = 0xFFFFFFFFu;  // a key past every pair's
constexpr int COL_BITS = 7;  // row keys hold the local column (< TN)
constexpr uint32_t COL_MASK = (1u << COL_BITS) - 1;
constexpr int ROW_BITS = 22;  // column keys hold the row in the low bits
constexpr uint32_t ROW_MASK = (1u << ROW_BITS) - 1;
static_assert(TN <= (1 << COL_BITS), "row keys must name every column");
constexpr int BH_STRIDE = 2 * DGMAX + 4;  // floats per column pair

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ bool lex_less(float v1, int i1, float v2, int i2) {
  return (v1 < v2) || (v1 == v2 && i1 < i2);
}

// merge of two (best, idx, second) states; first index wins ties
__device__ __forceinline__ void row_merge(float ov, int oi, float os,
                                          float& best, int& idx,
                                          float& second) {
  if (lex_less(ov, oi, best, idx)) {
    second = fminf(os, best);
    best = ov;
    idx = oi;
  } else {
    second = fminf(second, ov);
  }
}

// A pair's value as an integer code: the distance (0..256) or GATED. The
// tile kernel works on keys (code << bits | index): the smallest key holds
// the min and, among equal values, the first index. A row's running state
// is (best key, second key): push k -> second = min(second, max(best, k)),
// best = min(best, k); the second's code is the second best value.
__device__ __forceinline__ void key_push(uint32_t k, uint32_t& best,
                                         uint32_t& second) {
  second = min(second, max(best, k));
  best = min(best, k);
}

__device__ __forceinline__ float code_value(uint32_t code) {
  return code >= GATED ? BIGF : (float)code;
}

template <int DGP>
__global__ void __launch_bounds__(THREADS) hamming_tile_kernel(
    const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
    const float* __restrict__ ahat, const float* __restrict__ bhat,
    float* __restrict__ fs, int* __restrict__ is, int M, int N, int DG,
    float thr2, int want_cols) {
  __shared__ __align__(16) unsigned char s_bp[TN * 256];
  // gate factors by column pair: [pair][k][column of the pair], padded so
  // that the quad's four pairs fall in different banks
  __shared__ __align__(16) float s_bh[TN / 2][BH_STRIDE];
  __shared__ uint32_t s_ck[WARPS][TN];

  const int split = blockIdx.x, tile = blockIdx.y;
  const int S = gridDim.x, R = gridDim.y;
  const int col0 = split * TN, row0 = tile * TM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = row0 + 16 * warp + g, rg8 = rg + 8;
  const bool ok_g = rg < M, ok_g8 = rg8 < M;
  const int cs = tid % TN, part = tid / TN;  // column staged, its part
  const int jc = col0 + cs;

  // every global load first, into registers: the block's columns (each
  // split over PER threads: descriptor words and gate factors) and this
  // thread's two rows (rows g and g + 8 of the warp's 16: words 2t, 2t + 1
  // and gate factors)
  uint32_t w[8 / PER];  // words [part * 8 / PER, ...) of the column
#pragma unroll
  for (int i = 0; i < 8 / PER; ++i)
    w[i] = jc < N ? b[(size_t)jc * 8 + part * (8 / PER) + i] : 0u;
  float bc[DGP / PER];  // factors k = PER * i + part
#pragma unroll
  for (int i = 0; i < DGP / PER; ++i) {
    const int k = PER * i + part;
    bc[i] = (k < DG && jc < N) ? bhat[(size_t)k * N + jc] : 0.f;
  }
  uint2 xg = make_uint2(0u, 0u), x8 = make_uint2(0u, 0u);
  if (ok_g) xg = *reinterpret_cast<const uint2*>(a + (size_t)rg * 8 + 2 * t);
  if (ok_g8) x8 = *reinterpret_cast<const uint2*>(a + (size_t)rg8 * 8 + 2 * t);
  float ahg[DGP], ah8[DGP];
#pragma unroll
  for (int k = 0; k < DGP; ++k) {
    ahg[k] = (ok_g && k < DG) ? ahat[(size_t)rg * DG + k] : 0.f;
    ah8[k] = (ok_g8 && k < DG) ? ahat[(size_t)rg8 * DG + k] : 0.f;
  }

  // the column's +-1 planes and gate factors into shared memory
  {
    pm1::stage_column(s_bp, cs, part, w);
#pragma unroll
    for (int i = 0; i < DGP / PER; ++i)
      s_bh[cs >> 1][2 * (PER * i + part) + (cs & 1)] = bc[i];
  }
  // the rows' A fragments
  uint32_t af[8][4];
  pm1::a_fragments(xg, x8, af);
  __syncthreads();

  // row keys: code << COL_BITS | local column; column keys: code <<
  // ROW_BITS | row, all ones for a row past M
  const uint32_t rb_g = ok_g ? (uint32_t)rg : NOKEY;
  const uint32_t rb_8 = ok_g8 ? (uint32_t)rg8 : NOKEY;
  uint32_t bk_g = NOKEY, sk_g = NOKEY, bk_8 = NOKEY, sk_8 = NOKEY;
#pragma unroll 2
  for (int jt = 0; jt < TN / 8; ++jt) {
    // +-1 products of rows (g, g + 8) x columns (2t, 2t + 1) of this n8
    // tile
    int dot[4];
    pm1::tile_dot(s_bp, jt, g, t, af, dot);
    // the gate: an f32 FMA chain per pair, factors in order (the padding
    // factors are zero on both sides: exact)
    const float4* bh = reinterpret_cast<const float4*>(&s_bh[jt * 4 + t][0]);
    float d00 = 0.f, d01 = 0.f, d10 = 0.f, d11 = 0.f;
#pragma unroll
    for (int k2 = 0; k2 < DGP / 2; ++k2) {
      const float4 f = bh[k2];  // (k, col 2t), (k, 2t+1), (k+1, 2t), (k+1, 2t+1)
      d00 = fmaf(ahg[2 * k2], f.x, d00);
      d01 = fmaf(ahg[2 * k2], f.y, d01);
      d10 = fmaf(ah8[2 * k2], f.x, d10);
      d11 = fmaf(ah8[2 * k2], f.y, d11);
      d00 = fmaf(ahg[2 * k2 + 1], f.z, d00);
      d01 = fmaf(ahg[2 * k2 + 1], f.w, d01);
      d10 = fmaf(ah8[2 * k2 + 1], f.z, d10);
      d11 = fmaf(ah8[2 * k2 + 1], f.w, d11);
    }
    const uint32_t jl = jt * 8 + 2 * t;  // local column of acc[0] / acc[2]
    const bool ok0 = col0 + (int)jl < N, ok1 = col0 + (int)jl + 1 < N;
    const uint32_t v00 = d00 < thr2 ? (256 - dot[0]) >> 1 : GATED;
    const uint32_t v01 = d01 < thr2 ? (256 - dot[1]) >> 1 : GATED;
    const uint32_t v10 = d10 < thr2 ? (256 - dot[2]) >> 1 : GATED;
    const uint32_t v11 = d11 < thr2 ? (256 - dot[3]) >> 1 : GATED;
    key_push(ok0 ? v00 << COL_BITS | jl : NOKEY, bk_g, sk_g);
    key_push(ok1 ? v01 << COL_BITS | (jl + 1) : NOKEY, bk_g, sk_g);
    key_push(ok0 ? v10 << COL_BITS | jl : NOKEY, bk_8, sk_8);
    key_push(ok1 ? v11 << COL_BITS | (jl + 1) : NOKEY, bk_8, sk_8);
    if (want_cols) {
      // columns jl and jl + 1: the min key over the warp's 16 rows
      uint32_t k0 = min(v00 << ROW_BITS | rb_g, v10 << ROW_BITS | rb_8);
      uint32_t k1 = min(v01 << ROW_BITS | rb_g, v11 << ROW_BITS | rb_8);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        k0 = min(k0, __shfl_xor_sync(0xffffffffu, k0, off));
        k1 = min(k1, __shfl_xor_sync(0xffffffffu, k1, off));
      }
      if (g == 0) {
        s_ck[warp][jl] = k0;
        s_ck[warp][jl + 1] = k1;
      }
    }
  }

  // rows: merge the quad's four column subsets, write this split's partials
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const uint32_t ob = __shfl_xor_sync(0xffffffffu, bk_g, off);
    const uint32_t os = __shfl_xor_sync(0xffffffffu, sk_g, off);
    const uint32_t ob8 = __shfl_xor_sync(0xffffffffu, bk_8, off);
    const uint32_t os8 = __shfl_xor_sync(0xffffffffu, sk_8, off);
    sk_g = min(min(sk_g, os), max(bk_g, ob));
    bk_g = min(bk_g, ob);
    sk_8 = min(min(sk_8, os8), max(bk_8, ob8));
    bk_8 = min(bk_8, ob8);
  }
  float* r_best = fs;
  float* r_sec = fs + (size_t)M * S;
  int* r_idx = is;
  if (t == 0) {
    if (ok_g) {
      r_best[(size_t)rg * S + split] = code_value(bk_g >> COL_BITS);
      r_sec[(size_t)rg * S + split] = code_value(sk_g >> COL_BITS);
      r_idx[(size_t)rg * S + split] = col0 + (int)(bk_g & COL_MASK);
    }
    if (ok_g8) {
      r_best[(size_t)rg8 * S + split] = code_value(bk_8 >> COL_BITS);
      r_sec[(size_t)rg8 * S + split] = code_value(sk_8 >> COL_BITS);
      r_idx[(size_t)rg8 * S + split] = col0 + (int)(bk_8 & COL_MASK);
    }
  }
  if (!want_cols) return;
  // columns: the min key over the block's warps, this tile's partials
  __syncthreads();
  uint32_t* c_key = reinterpret_cast<uint32_t*>(is + (size_t)M * S);
  if (part == 0 && jc < N) {
    uint32_t k = s_ck[0][cs];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) k = min(k, s_ck[w][cs]);
    c_key[(size_t)jc * R + tile] = k;
  }
}

// One warp per output: warps [0, M) merge a row's S column-split partials,
// warps [M, M + N) a column's R row-tile keys, lanes over the partials and
// then a butterfly. Every merge is a min with a first-index tie rule, so
// the result does not depend on the order.
__global__ void __launch_bounds__(MERGE_THREADS) hamming_merge_kernel(
    const float* __restrict__ fs, const int* __restrict__ is,
    float* __restrict__ row_best, float* __restrict__ row_second,
    int* __restrict__ row_idx, int* __restrict__ col_idx, int M, int N,
    int S, int R) {
  const int o = blockIdx.x * (MERGE_THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (o < M) {
    float best = inf_f(), second = BIGF;
    int idx = NOIDX;
    for (int s = lane; s < S; s += 32) {
      const size_t p = (size_t)o * S + s;
      row_merge(fs[p], is[p], fs[(size_t)M * S + p], best, idx, second);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
      const float os = __shfl_xor_sync(0xffffffffu, second, off);
      row_merge(ob, oi, os, best, idx, second);
    }
    if (lane == 0) {
      row_best[o] = best;
      row_second[o] = second;
      row_idx[o] = idx;
    }
  } else if (col_idx != nullptr && o < M + N) {
    const int j = o - M;
    const uint32_t* c_key = reinterpret_cast<const uint32_t*>(is + (size_t)M * S);
    uint32_t k = 0xFFFFFFFFu;
    for (int r = lane; r < R; r += 32) k = min(k, c_key[(size_t)j * R + r]);
    k = __reduce_min_sync(0xffffffffu, k);
    if (lane == 0) col_idx[j] = (int)(k & ROW_MASK);
  }
}

int n_splits(int N) { return (N + TN - 1) / TN; }
int n_tiles(int M) { return (M + TM - 1) / TM; }

}  // namespace

// scratch of one call: per-row (best, second) for each column split and
// per-column min for each row tile (floats); per-row index and per-column
// row (ints)
extern "C" int mc_hamming_scratch_floats(int M, int N) {
  return 2 * n_splits(N) * M;
}

extern "C" int mc_hamming_scratch_ints(int M, int N) {
  return n_splits(N) * M + n_tiles(M) * N;
}

extern "C" int mc_hamming_argmin2(const uint32_t* a, const uint32_t* b,
                                  const float* ahat, const float* bhat,
                                  float* row_best, float* row_second,
                                  int* row_idx, int* col_idx, float* fscratch,
                                  int* iscratch, int M, int N, int DG,
                                  float thr2, void* stream) {
  if (M == 0) return 0;
  if (N <= 0 || DG < 1 || DG > DGMAX || M > (int)ROW_MASK)
    return (int)cudaErrorInvalidValue;
  const int S = n_splits(N), R = n_tiles(M);
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(S, R);
  const int cols = col_idx != nullptr;
  // the gate loop runs over DG rounded up to a multiple of 2 in {8, 12,
  // 14, 16}: production's DG = 14 (4 cameras) takes no padding factor
  if (DG <= 8)
    hamming_tile_kernel<8><<<grid, THREADS, 0, st>>>(
        a, b, ahat, bhat, fscratch, iscratch, M, N, DG, thr2, cols);
  else if (DG <= 12)
    hamming_tile_kernel<12><<<grid, THREADS, 0, st>>>(
        a, b, ahat, bhat, fscratch, iscratch, M, N, DG, thr2, cols);
  else if (DG <= 14)
    hamming_tile_kernel<14><<<grid, THREADS, 0, st>>>(
        a, b, ahat, bhat, fscratch, iscratch, M, N, DG, thr2, cols);
  else
    hamming_tile_kernel<16><<<grid, THREADS, 0, st>>>(
        a, b, ahat, bhat, fscratch, iscratch, M, N, DG, thr2, cols);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int warps = M + (cols ? N : 0);
  constexpr int per_block = MERGE_THREADS / 32;
  hamming_merge_kernel<<<(warps + per_block - 1) / per_block, MERGE_THREADS,
                         0, st>>>(
      fscratch, iscratch, row_best, row_second, row_idx, col_idx, M, N, S, R);
  return (int)cudaGetLastError();
}
