// Intra-rig pair match: every camera pair's gated mutual-best Hamming
// match, merged into the parent table of the rig's feature groups, in one
// launch.
//
// Replaces: the TPU-shaped pair stage of the frame build's intra match,
// mcslam_tpu/frontend/intra.py intra_match (:110-147: all pairs through
// one vmapped matcher, and the row-to-column inversion as a dense
// equality + first-true reduce instead of a scatter-min, written so for
// the TPU). No Pallas kernel corresponds to it. In the port its plain
// version, frontend/intra_cuda.intra_pairs_reference, is the Hamming GEMM,
// match_mutual per pair, the per-pair candidates and the parent merge,
// ~180 tensor ops at four cameras; this is one launch.
//
// Computes, for the P = C (C - 1) / 2 pairs (i, j), i < j, in the order
// (0, 1), (0, 2), ..., (C - 2, C - 1), and N features per camera:
//  1. d[a][b] = popcount(desc_i[a] ^ desc_j[b]) over the 256 bits, taken
//     as (256 - A.B^T) / 2 on +-1 bit planes (hamming_from_planes' exact
//     +-1 product);
//  2. d = BIG = 1 << 20 where the Sampson gate gate[p][a][b], valid_i[a] or
//     valid_j[b] is false (match._apply_masks);
//  3. per row a: the argmin (first index on ties), the best, and the
//     second as the minimum over the row with the argmin's cell set to BIG
//     (match.best_two: a duplicate of the best gives second == best);
//  4. per column b: the argmin over the rows (first index on ties; a
//     column of BIG cells gives 0);
//  5. ok[a] = (column argmin of the row's argmin == a) & best <= max_dist
//     & float(best) <= ratio * float(second) (one float32 product, as
//     torch rounds it) & valid_i[a];
//  6-7. parent[j][b] = the least flat index i N + a over the pairs ending in
//     camera j of an ok row a pointing at b, else j N + b.
// Every output is an integer: parent equals the plain version's bit for
// bit, from run to run.
//
// Bound on the card: the integer epilogue. At C = 4, N = 768 the P N^2 =
// 3.5 M cells need 512 int8 operations each on the tensor cores (0.9 us at
// 1,979 TOP/s) and ~11 integer operations each (mask, select, the row's
// best / second keys, the column's minimum: 2.3 us at the compare-class
// rate); the gate, P N^2 bytes, is ~1.1 us from HBM. What a call takes
// is latency (scripts/intra_variants.py, its %globaltimer stamps, NVIDIA
// H100 80GB HBM3 at 700 W: ~16 us in all): the blocks' staging, products
// and epilogue end 6-11 us in (84 of the 132 SMs run two blocks; ~4 us of
// it is the epilogue's integer work), then each stage of the tail waits
// on the last block before it: the pair's arrival ~0.7 us, its link ~2.4
// us on one block, the camera's arrival ~0.6 us, parent ~0.7 us.
//
// Design for Hopper, one launch, 256 threads a block:
//  - the grid is (column split, row tile, pair) of 128 x 128 cells: 216
//    blocks at C = 4, N = 768, two resident per SM (53,376 B of dynamic
//    shared memory each), one wave on 132 SMs;
//  - staging: the block's 128 x 128 gate bytes go to shared memory by
//    cp.async (16-byte copies in chunks swizzled by row, so that the
//    epilogue's 2-byte reads are free of bank conflicts; byte loads where
//    N % 16 != 0 or the gate is not 16-byte aligned), issued before
//    anything else; then the descriptor loads; then the columns' +-1
//    planes are unpacked into shared memory and each warp's 16 rows into
//    A fragments (pm1_mma.cuh, shared with hamming_argmin2.cu);
//  - distances on the tensor cores: mma.sync m16n8k32 s8 x s8 -> s32, 16
//    n8 tiles per warp; the epilogue works on the accumulator registers
//    with 32-bit keys (code << 22 | index, code the distance or 257 when
//    gated): the smallest key holds the minimum and, among equal values,
//    the first index. A row keeps (best key, second key) over its columns
//    (merged across the quad by shuffles), a column the minimum key over
//    the warp's rows (shuffles), then over the block's warps;
//  - each block writes its per-row (best, second) for its column split and
//    its per-column key for its row tile to scratch, and counts itself on
//    its pair's arrival counter (a barrier, then thread 0's atomicAdd with
//    release and acquire semantics). The last block of a pair links the
//    pair: per
//    column b the minimum key over the row tiles names the row a; row a's
//    keys over the column splits give its argmin, best and second; the
//    tests of step 5 make the pair's candidate for b (i N + a, or none).
//    Mutual-best means only row a = argmin of column b can point at b, so
//    the candidate is gathered by column, with no scatter. The rows' keys
//    are merged first, in order, into shared memory (N <= SMEM_ROWS), and
//    a thread links LINK columns at once, each stage's loads issued
//    together (two dependent rounds of L2 reads). Then it counts the pair
//    on its second camera's counter; the last pair ending in camera j
//    writes parent[j] from the self index and the candidates of those
//    pairs, after each of them is written: no order of blocks changes what
//    it reads. Camera 0 ends no pair: pair 0's first row tile writes its
//    self index. Every merge is a minimum, which no order changes, so two
//    runs give equal outputs;
//  - the counters (P + C ints: pairs, then cameras) are the caller's, zero
//    at the start of a launch; the blocks that read them last put them
//    back to zero, so the next launch and every replay of a captured graph
//    find them at zero. Launches that share counters must not overlap in
//    time (one stream).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "pm1_mma.cuh"

namespace {

constexpr int TILE = 128;  // rows and columns of a block's tile
constexpr int WARPS = TILE / 16;
constexpr int THREADS = 32 * WARPS;
constexpr int PER = THREADS / TILE;  // threads staging one column
static_assert(PER * TILE == THREADS, "whole columns per thread group");
constexpr int NW = 8 / PER;  // descriptor words a staging thread holds
constexpr int BIG = 1 << 20;
constexpr uint32_t GATED = 257;  // the code of a gated cell (BIG)
constexpr uint32_t NOKEY = 0xFFFFFFFFu;  // a key past every cell's
constexpr int IDX_BITS = 22;  // keys hold the row or column index here
constexpr uint32_t IDX_MASK = (1u << IDX_BITS) - 1;
constexpr int NONE = 0x7fffffff;  // no candidate
constexpr int LINK = 3;  // columns a thread links at a time (768 = 3 x 256)
constexpr int CH = 6;  // tiles, splits or pairs whose loads are issued at
                       // once (even: a uint4 holds two splits' keys)
// dynamic shared memory: column planes, gate tile, column keys per warp,
// column validity
constexpr int SMEM_BP = TILE * 256;
constexpr int SMEM_GATE = TILE * TILE;
constexpr int SMEM_CK = WARPS * TILE * 4;
constexpr int SMEM = SMEM_BP + SMEM_GATE + SMEM_CK + TILE;
// rows whose merged keys and validity the link stages in shared memory
constexpr int SMEM_ROWS = SMEM / (sizeof(uint2) + 1);

__device__ __forceinline__ void pair_cams(int p, int C, int& i, int& j) {
  i = 0;
  while (p >= C - 1 - i) {
    p -= C - 1 - i;
    ++i;
  }
  j = i + 1 + p;
}

// atomicAdd of 1 with release and acquire semantics at device scope: the
// writes ordered before it (the block's, through a barrier) are seen by a
// thread that reads the count after it and then synchronizes with its
// block (one atom.add.acq_rel.gpu: a __threadfence on either side cost
// ~0.4 us more an arrival on NVIDIA H100 80GB HBM3 at 700 W,
// scripts/intra_variants.py)
__device__ __forceinline__ int add_acq_rel(int* p) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
}

__device__ __forceinline__ int pair_index(int i, int j, int C) {
  return i * (2 * C - i - 1) / 2 + (j - i - 1);
}

// a key's code as the distance of the plain version (GATED and past: BIG)
__device__ __forceinline__ int code_value(uint32_t key) {
  const uint32_t code = key >> IDX_BITS;
  return code >= GATED ? BIG : static_cast<int>(code);
}

// byte offset of gate cell (r, c) of the tile: 16-byte chunk c / 16 of row
// r stored at chunk (c / 16) ^ (r % 8)
__device__ __forceinline__ int gate_off(int r, int c) {
  return r * TILE + ((((c >> 4) ^ (r & 7))) << 4) + (c & 15);
}

__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(s)),
               "l"(g));
}

// (best key, second key) of a row: push k -> the two least keys
__device__ __forceinline__ void key_push(uint32_t k, uint32_t& best,
                                         uint32_t& second) {
  second = min(second, max(best, k));
  best = min(best, k);
}

__device__ __forceinline__ void key_merge(uint32_t ob, uint32_t os,
                                          uint32_t& best, uint32_t& second) {
  second = min(min(second, os), max(best, ob));
  best = min(best, ob);
}

__global__ void __launch_bounds__(THREADS, 2)
intra_pairs_kernel(const int* __restrict__ desc,
                   const uint8_t* __restrict__ valid,
                   const uint8_t* __restrict__ gate, int* __restrict__ parent,
                   int* __restrict__ scratch, int* __restrict__ counters,
                   int C, int N, int max_dist, float ratio, int gate16) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* s_bp = smem;
  unsigned char* s_gate = smem + SMEM_BP;
  uint32_t* s_ck = reinterpret_cast<uint32_t*>(smem + SMEM_BP + SMEM_GATE);
  unsigned char* s_vj = smem + SMEM_BP + SMEM_GATE + SMEM_CK;
  __shared__ int s_last;

  const int P = C * (C - 1) / 2;
  const int split = blockIdx.x, tile = blockIdx.y, p = blockIdx.z;
  const int S = gridDim.x;  // column splits = row tiles
  const int col0 = split * TILE, row0 = tile * TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  int ci, cj;
  pair_cams(p, C, ci, cj);
  const size_t PN = static_cast<size_t>(P) * N;
  // partials: a row's keys over the column splits side by side (SP = S
  // rounded up to even: 16-byte loads), read for the rows the link names;
  // the column keys by (pair, tile, column), read for consecutive columns
  const int SP = S + (S & 1);
  uint2* rowpart = reinterpret_cast<uint2*>(scratch);          // (P, N, SP)
  uint32_t* colpart = reinterpret_cast<uint32_t*>(scratch) + 2 * PN * SP;
  int* cand = scratch + 2 * PN * SP + PN * S;                   // (P, N)

  // the gate tile first: its copies are in flight while the rest loads
  const uint8_t* gp = gate + static_cast<size_t>(p) * N * N;
  if (gate16) {
    for (int q = tid; q < TILE * TILE / 16; q += THREADS) {
      const int r = q >> 3, c = (q & 7) << 4;
      if (row0 + r < N && col0 + c < N)
        cp_async16(s_gate + gate_off(r, c),
                   gp + static_cast<size_t>(row0 + r) * N + col0 + c);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // the descriptor words: half a staged column per thread (columns past N
  // are zero planes, never read as a result), the thread's two rows
  const int cs = tid % TILE, part = tid / TILE;
  const int jc = col0 + cs;
  // (4-byte loads: desc need not be more than 4-byte aligned)
  uint32_t w[NW];
  const int* dc = desc + (static_cast<size_t>(cj) * N + jc) * 8 + part * NW;
#pragma unroll
  for (int i = 0; i < NW; ++i) w[i] = jc < N ? static_cast<uint32_t>(dc[i]) : 0u;
  const int rg = row0 + 16 * warp + g, rg8 = rg + 8;
  const bool in_g = rg < N, in_8 = rg8 < N;
  const int* dg = desc + (static_cast<size_t>(ci) * N + rg) * 8 + 2 * t;
  const int* d8 = dg + 64;  // row rg + 8
  const uint2 xg = in_g ? make_uint2(dg[0], dg[1]) : make_uint2(0u, 0u);
  const uint2 x8 = in_8 ? make_uint2(d8[0], d8[1]) : make_uint2(0u, 0u);
  const bool vi_g = in_g && valid[ci * N + rg] != 0;
  const bool vi_8 = in_8 && valid[ci * N + rg8] != 0;
  if (part == 0) s_vj[cs] = jc < N ? valid[cj * N + jc] : 0;
  // camera 0's features are their own parents (no pair ends there)
  if (p == 0 && tile == 0 && part == 0 && jc < N) parent[jc] = jc;
  if (!gate16) {  // ragged or unaligned gate: byte loads
    for (int q = tid; q < TILE * TILE; q += THREADS) {
      const int r = q / TILE, c = q % TILE;
      if (row0 + r < N && col0 + c < N)
        s_gate[gate_off(r, c)] = gp[static_cast<size_t>(row0 + r) * N + col0 + c];
    }
  }

  pm1::stage_column(s_bp, cs, part, w);
  uint32_t af[8][4];
  pm1::a_fragments(xg, x8, af);
  if (gate16) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // row keys: code << IDX_BITS | column; column keys: code << IDX_BITS |
  // row, all ones for a row past N
  const uint32_t rb_g = in_g ? static_cast<uint32_t>(rg) : NOKEY;
  const uint32_t rb_8 = in_8 ? static_cast<uint32_t>(rg8) : NOKEY;
  const int lr = 16 * warp + g;  // local rows lr and lr + 8
  uint32_t bk_g = NOKEY, sk_g = NOKEY, bk_8 = NOKEY, sk_8 = NOKEY;
#pragma unroll 2
  for (int jt = 0; jt < TILE / 8; ++jt) {
    int dot[4];
    pm1::tile_dot(s_bp, jt, g, t, af, dot);
    const int jl = jt * 8 + 2 * t;  // local columns jl, jl + 1
    const uint32_t gg = *reinterpret_cast<const uint16_t*>(s_gate + gate_off(lr, jl));
    const uint32_t g8 = *reinterpret_cast<const uint16_t*>(s_gate + gate_off(lr + 8, jl));
    const uint32_t vj = *reinterpret_cast<const uint16_t*>(s_vj + jl);
    const bool vj0 = (vj & 0xFFu) != 0, vj1 = (vj >> 8) != 0;
    const uint32_t v00 = vi_g && vj0 && (gg & 0xFFu) ? (256 - dot[0]) >> 1 : GATED;
    const uint32_t v01 = vi_g && vj1 && (gg >> 8) ? (256 - dot[1]) >> 1 : GATED;
    const uint32_t v10 = vi_8 && vj0 && (g8 & 0xFFu) ? (256 - dot[2]) >> 1 : GATED;
    const uint32_t v11 = vi_8 && vj1 && (g8 >> 8) ? (256 - dot[3]) >> 1 : GATED;
    const uint32_t b0 = static_cast<uint32_t>(col0 + jl);
    const bool in0 = col0 + jl < N, in1 = col0 + jl + 1 < N;
    key_push(in0 ? v00 << IDX_BITS | b0 : NOKEY, bk_g, sk_g);
    key_push(in1 ? v01 << IDX_BITS | (b0 + 1) : NOKEY, bk_g, sk_g);
    key_push(in0 ? v10 << IDX_BITS | b0 : NOKEY, bk_8, sk_8);
    key_push(in1 ? v11 << IDX_BITS | (b0 + 1) : NOKEY, bk_8, sk_8);
    // columns jl and jl + 1: the least key over the warp's 16 rows
    uint32_t k0 = min(v00 << IDX_BITS | rb_g, v10 << IDX_BITS | rb_8);
    uint32_t k1 = min(v01 << IDX_BITS | rb_g, v11 << IDX_BITS | rb_8);
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      k0 = min(k0, __shfl_xor_sync(0xffffffffu, k0, off));
      k1 = min(k1, __shfl_xor_sync(0xffffffffu, k1, off));
    }
    if (g == 0) {
      s_ck[warp * TILE + jl] = k0;
      s_ck[warp * TILE + jl + 1] = k1;
    }
  }

  // rows: merge the quad's four column subsets, write this split's keys
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const uint32_t ob = __shfl_xor_sync(0xffffffffu, bk_g, off);
    const uint32_t os = __shfl_xor_sync(0xffffffffu, sk_g, off);
    const uint32_t ob8 = __shfl_xor_sync(0xffffffffu, bk_8, off);
    const uint32_t os8 = __shfl_xor_sync(0xffffffffu, sk_8, off);
    key_merge(ob, os, bk_g, sk_g);
    key_merge(ob8, os8, bk_8, sk_8);
  }
  if (t == 0) {
    uint2* rp = rowpart + static_cast<size_t>(p) * N * SP + split;
    if (in_g) rp[static_cast<size_t>(rg) * SP] = make_uint2(bk_g, sk_g);
    if (in_8) rp[static_cast<size_t>(rg8) * SP] = make_uint2(bk_8, sk_8);
  }
  __syncthreads();
  // columns: the least key over the block's warps, this tile's key
  if (tid < TILE && col0 + tid < N) {
    uint32_t k = s_ck[tid];
#pragma unroll
    for (int w8 = 1; w8 < WARPS; ++w8) k = min(k, s_ck[w8 * TILE + tid]);
    colpart[(static_cast<size_t>(p) * S + tile) * N + col0 + tid] = k;
  }

  // arrival: the last of the pair's S x S blocks merges the pair. The
  // barrier orders the block's writes before thread 0's count, which
  // releases them and, in the last block, acquires the other blocks'
  __syncthreads();
  if (tid == 0) s_last = add_acq_rel(&counters[p]) == S * S - 1;
  __syncthreads();
  if (!s_last) return;

  // the link. A warp issues in order and stalls at the first use of a
  // load, so each stage issues all its loads (CH tiles or splits at a
  // time) before it uses any: a loop of load-then-minimum made one L2
  // round trip per tile, ~8 us for the link. (A) Where the pair's rows fit
  // in shared memory (N <= SMEM_ROWS), every row's keys over the column
  // splits are merged there first, read in order (coalesced), with the
  // rows' validity. (B) LINK columns a thread at a time: the columns' keys
  // over the row tiles name the rows; the rows' merged keys (from shared
  // memory, else gathered from scratch) make the candidates.
  const bool rows_staged = N <= SMEM_ROWS;
  uint2* s_row = reinterpret_cast<uint2*>(smem);  // (best, second) a row
  unsigned char* s_va = smem + SMEM_ROWS * sizeof(uint2);
  if (rows_staged) {
    for (int a0 = 0; a0 < N; a0 += LINK * THREADS) {
      uint32_t bk[LINK], sk[LINK];
      bool va[LINK];
#pragma unroll
      for (int k = 0; k < LINK; ++k) {
        const int a = a0 + k * THREADS + tid;
        bk[k] = sk[k] = NOKEY;
        va[k] = a < N && valid[ci * N + a] != 0;
      }
      for (int s0 = 0; s0 < S; s0 += CH) {
        uint4 v[LINK][CH / 2];
#pragma unroll
        for (int k = 0; k < LINK; ++k) {
          const int a = a0 + k * THREADS + tid;
          const uint2* rp = rowpart + (static_cast<size_t>(p) * N + a) * SP;
#pragma unroll
          for (int q = 0; q < CH / 2; ++q)
            v[k][q] = a < N && s0 + 2 * q < S
                          ? __ldcg(reinterpret_cast<const uint4*>(rp + s0 + 2 * q))
                          : make_uint4(NOKEY, NOKEY, NOKEY, NOKEY);
        }
#pragma unroll
        for (int k = 0; k < LINK; ++k)
#pragma unroll
          for (int q = 0; q < CH / 2; ++q) {
            key_merge(v[k][q].x, v[k][q].y, bk[k], sk[k]);
            if (s0 + 2 * q + 1 < S) key_merge(v[k][q].z, v[k][q].w, bk[k], sk[k]);
          }
      }
#pragma unroll
      for (int k = 0; k < LINK; ++k) {
        const int a = a0 + k * THREADS + tid;
        if (a < N) {
          s_row[a] = make_uint2(bk[k], sk[k]);
          s_va[a] = va[k];
        }
      }
    }
    __syncthreads();
  }
  for (int b0 = 0; b0 < N; b0 += LINK * THREADS) {
    uint32_t ck[LINK];
#pragma unroll
    for (int k = 0; k < LINK; ++k) ck[k] = NOKEY;
    for (int r0 = 0; r0 < S; r0 += CH) {
      uint32_t v[LINK][CH];
#pragma unroll
      for (int k = 0; k < LINK; ++k) {
        const int b = b0 + k * THREADS + tid;
#pragma unroll
        for (int q = 0; q < CH; ++q)
          v[k][q] = b < N && r0 + q < S
                        ? __ldcg(colpart + (static_cast<size_t>(p) * S + r0 + q) * N + b)
                        : NOKEY;
      }
#pragma unroll
      for (int k = 0; k < LINK; ++k)
#pragma unroll
        for (int q = 0; q < CH; ++q) ck[k] = min(ck[k], v[k][q]);
    }
    // the row a of every column b < N (every column has a key of a row)
    int a[LINK];
    uint32_t bk[LINK], sk[LINK];
    bool va[LINK];
#pragma unroll
    for (int k = 0; k < LINK; ++k) {
      const int b = b0 + k * THREADS + tid;
      a[k] = static_cast<int>(ck[k] & IDX_MASK);
      bk[k] = sk[k] = NOKEY;
      va[k] = false;
      if (rows_staged && b < N) {
        const uint2 r = s_row[a[k]];
        bk[k] = r.x;
        sk[k] = r.y;
        va[k] = s_va[a[k]] != 0;
      }
    }
    if (!rows_staged) {
#pragma unroll
      for (int k = 0; k < LINK; ++k) {
        const int b = b0 + k * THREADS + tid;
        va[k] = b < N && valid[ci * N + a[k]] != 0;
      }
      for (int s0 = 0; s0 < S; s0 += CH) {
        uint4 v[LINK][CH / 2];
#pragma unroll
        for (int k = 0; k < LINK; ++k) {
          const int b = b0 + k * THREADS + tid;
          const uint2* rp = rowpart + (static_cast<size_t>(p) * N + a[k]) * SP;
#pragma unroll
          for (int q = 0; q < CH / 2; ++q)
            v[k][q] = b < N && s0 + 2 * q < S
                          ? __ldcg(reinterpret_cast<const uint4*>(rp + s0 + 2 * q))
                          : make_uint4(NOKEY, NOKEY, NOKEY, NOKEY);
        }
#pragma unroll
        for (int k = 0; k < LINK; ++k)
#pragma unroll
          for (int q = 0; q < CH / 2; ++q) {
            key_merge(v[k][q].x, v[k][q].y, bk[k], sk[k]);
            if (s0 + 2 * q + 1 < S) key_merge(v[k][q].z, v[k][q].w, bk[k], sk[k]);
          }
      }
    }
#pragma unroll
    for (int k = 0; k < LINK; ++k) {
      const int b = b0 + k * THREADS + tid;
      if (b >= N) continue;
      const int best = code_value(bk[k]), second = code_value(sk[k]);
      const bool ok = static_cast<int>(bk[k] & IDX_MASK) == b &&
                      best <= max_dist &&
                      static_cast<float>(best) <=
                          __fmul_rn(ratio, static_cast<float>(second)) &&
                      va[k];
      cand[p * static_cast<size_t>(N) + b] = ok ? ci * N + a[k] : NONE;
    }
  }

  // the last of the pairs ending in camera cj writes its parents
  __syncthreads();
  if (tid == 0) {
    counters[p] = 0;
    s_last = add_acq_rel(&counters[P + cj]) == cj - 1;
  }
  __syncthreads();
  if (!s_last) return;
  for (int b0 = 0; b0 < N; b0 += LINK * THREADS) {
    int v[LINK];
#pragma unroll
    for (int k = 0; k < LINK; ++k) v[k] = cj * N + b0 + k * THREADS + tid;
    for (int i0 = 0; i0 < cj; i0 += CH) {
      int w[LINK][CH];
#pragma unroll
      for (int k = 0; k < LINK; ++k)
#pragma unroll
        for (int q = 0; q < CH; ++q)
          w[k][q] = b0 + k * THREADS + tid < N && i0 + q < cj
                        ? __ldcg(cand + pair_index(i0 + q, cj, C) * static_cast<size_t>(N) + b0 + k * THREADS + tid)
                        : NONE;
#pragma unroll
      for (int k = 0; k < LINK; ++k)
#pragma unroll
        for (int q = 0; q < CH; ++q) v[k] = min(v[k], w[k][q]);
    }
#pragma unroll
    for (int k = 0; k < LINK; ++k) {
      const int b = b0 + k * THREADS + tid;
      if (b < N) parent[cj * N + b] = v[k];
    }
  }
  if (tid == 0) counters[P + cj] = 0;
}

// the dynamic shared-memory opt-in and the largest shared-memory carveout
// (two blocks per SM), once per device: the attributes persist, so
// `smem_set` keeps a bit per device already set
std::atomic<uint64_t> smem_set{0};

cudaError_t allow_smem() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = 1ull << (dev & 63);
  if (smem_set.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(intra_pairs_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(intra_pairs_kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) smem_set.fetch_or(bit, std::memory_order_release);
  return e;
}

}  // namespace

// desc (C, N, 8) int32, valid (C, N) bool, gate (P, N, N) bool -> parent
// (C, N) int32. scratch: scratch_ints >= P N (2 TP + T + 1) ints, T =
// ceil(N / 128) tiles, TP = T rounded up to even (checked); counters: counter_ints >= P + C ints, zero at the
// call, zero again after it.
extern "C" int mc_intra_pairs(const void* desc, const void* valid,
                              const void* gate, void* parent, void* scratch,
                              void* counters, int C, int N, int T,
                              long long scratch_ints, int counter_ints,
                              int max_dist, float ratio, void* stream) {
  if (C < 2 || N < 0 || N > static_cast<int>(IDX_MASK) ||
      T != (N + TILE - 1) / TILE)
    return cudaErrorInvalidValue;
  const int P = C * (C - 1) / 2;
  if (scratch_ints < static_cast<long long>(P) * N * (2 * (T + (T & 1)) + T + 1) ||
      counter_ints < P + C || T > 65535 || P > 65535)
    return cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaError_t e = allow_smem();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int gate16 = N % 16 == 0 &&
                     (reinterpret_cast<uintptr_t>(gate) & 15) == 0;
  intra_pairs_kernel<<<dim3(T, T, P), THREADS, SMEM,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(desc), static_cast<const uint8_t*>(valid),
      static_cast<const uint8_t*>(gate), static_cast<int*>(parent),
      static_cast<int*>(scratch), static_cast<int*>(counters), C, N, max_dist,
      ratio, gate16);
  return static_cast<int>(cudaGetLastError());
}
