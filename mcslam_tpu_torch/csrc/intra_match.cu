// Intra-rig pair match: every camera pair's gated mutual-best Hamming
// match, merged into the parent table of the rig's feature groups.
//
// Replaces: the TPU-shaped pair stage of the frame build's intra match,
// mcslam_tpu/frontend/intra.py intra_match (:110-147: all pairs through
// one vmapped matcher, and the row-to-column inversion as a dense
// equality + first-true reduce instead of a scatter-min, written so for
// the TPU). No Pallas kernel corresponds to it. In the port its plain
// version, frontend/intra_cuda.intra_pairs_reference, is the Hamming GEMM,
// match_mutual per pair, the per-pair candidates and the parent merge,
// ~180 tensor ops at four cameras; this is two launches.
//
// Computes, for the P = C (C - 1) / 2 pairs (i, j), i < j, in the order
// (0, 1), (0, 2), ..., (C - 2, C - 1), and N features per camera:
//  1. d[a][b] = popcount(desc_i[a] ^ desc_j[b]) over the 8 words (equal to
//     hamming_from_planes' exact +-1 product);
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
//     camera j of an ok row a pointing at b, else j N + b (the parent
//     table starts as the flat self index and every ok row lowers its
//     target by atomicMin: i N + a < j N <= j N + b, and a minimum is the
//     same in any order, so the table is the plain version's exactly).
// Every output is an integer: parent equals the plain version's bit for
// bit, from run to run.
//
// Bound on the card: the gate, P N^2 bytes (3.5 MB at C = 4, N = 768:
// ~1 us at 3.35 TB/s), read once, and the P N^2 distances of 8 xor +
// popcount each (~28 M integer operations, ~1 us). The plain version
// materializes the (P, N, N) distances and masks several times.
//
// Design for Hopper, two launches:
//  - intra_rows_kernel, one block per (pair, tile of RT = 32 rows), 8
//    warps of 4 rows each. The pair's column descriptors are staged in
//    shared memory in chunks of CH = 768 columns (24 KB), word-major so
//    the 32 lanes of a warp read 32 consecutive words (no bank conflict);
//    a warp's 4 rows are in registers, broadcast to its lanes. Lanes walk
//    the columns (consecutive lanes, consecutive columns: the gate's bytes
//    are read coalesced), each keeping its rows' best / argmin / second;
//    a butterfly of shuffles merges them per row at the end. The column
//    argmin of the tile is the minimum of (d << 32 | a) keys, a lane's 4
//    rows in registers and the 8 warps by shared-memory atomicMin, written
//    as one partial per (pair, tile, column). The blocks of pair 0 also
//    write the parent table's starting value.
//  - intra_link_kernel, one thread per (pair, row): the column argmin of
//    the row's argmin is the least of the T = N / RT tiles' keys; the
//    tests of step 5; an atomicMin into parent.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WORDS = 8;    // 256-bit descriptors
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int ROWS_PER_WARP = 4;
constexpr int RT = NWARPS * ROWS_PER_WARP;  // rows of a block's tile
constexpr int CH = 768;     // columns staged in shared memory at a time
constexpr int BIG = 1 << 20;
constexpr int LINK_THREADS = 256;

__device__ __forceinline__ void pair_cams(int p, int C, int& i, int& j) {
  i = 0;
  while (p >= C - 1 - i) {
    p -= C - 1 - i;
    ++i;
  }
  j = i + 1 + p;
}

// merge (best, idx, second) of another lane: the argmin with the first
// index on ties; the second is the least of both seconds and the losing
// best
__device__ __forceinline__ void merge(int& best, int& idx, int& second,
                                      int ob, int oi, int os) {
  const bool take = ob < best || (ob == best && oi < idx);
  const int loser = take ? best : ob;
  second = min(min(second, os), loser);
  if (take) {
    best = ob;
    idx = oi;
  }
}

__global__ void __launch_bounds__(THREADS)
intra_rows_kernel(const int* __restrict__ desc, const uint8_t* __restrict__ valid,
                  const uint8_t* __restrict__ gate, int* __restrict__ parent,
                  int* __restrict__ rows, unsigned long long* __restrict__ colpart,
                  int C, int N) {
  __shared__ int sd[WORDS][CH + 1];  // + 1: the staging stores spread over the banks
  __shared__ uint8_t sv[CH];
  __shared__ unsigned long long colmin[CH];

  const int P = C * (C - 1) / 2;
  const int p = blockIdx.y;
  const int tile = blockIdx.x;
  const int T = gridDim.x;
  int ci, cj;
  pair_cams(p, C, ci, cj);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int a0 = tile * RT + warp * ROWS_PER_WARP;

  if (p == 0) {  // the parent table starts as the flat self index
    for (int t = threadIdx.x; t < RT * C; t += THREADS) {
      const int a = tile * RT + t % RT;
      const int c = t / RT;
      if (a < N) parent[c * N + a] = c * N + a;
    }
  }

  unsigned rw[ROWS_PER_WARP][WORDS];
  bool rv[ROWS_PER_WARP];
  int best[ROWS_PER_WARP], idx[ROWS_PER_WARP], second[ROWS_PER_WARP];
#pragma unroll
  for (int k = 0; k < ROWS_PER_WARP; ++k) {
    const int a = a0 + k;
    const bool in = a < N;
#pragma unroll
    for (int w = 0; w < WORDS; ++w)
      rw[k][w] = in ? static_cast<unsigned>(desc[(ci * N + a) * WORDS + w]) : 0u;
    rv[k] = in && valid[ci * N + a];
    best[k] = 0x7fffffff;
    idx[k] = 0x7fffffff;
    second[k] = BIG;
  }
  const uint8_t* gp = gate + static_cast<size_t>(p) * N * N;

  for (int c0 = 0; c0 < N; c0 += CH) {
    const int nc = min(CH, N - c0);
    for (int t = threadIdx.x; t < nc * WORDS; t += THREADS) {
      const int b = t / WORDS, w = t % WORDS;
      sd[w][b] = desc[(cj * N + c0 + b) * WORDS + w];
    }
    for (int t = threadIdx.x; t < nc; t += THREADS) {
      sv[t] = valid[cj * N + c0 + t];
      colmin[t] = ~0ull;
    }
    __syncthreads();
    for (int bl = lane; bl < nc; bl += 32) {
      const int b = c0 + bl;
      unsigned cw[WORDS];
#pragma unroll
      for (int w = 0; w < WORDS; ++w) cw[w] = static_cast<unsigned>(sd[w][bl]);
      const bool cvalid = sv[bl] != 0;
      unsigned long long key = ~0ull;
#pragma unroll
      for (int k = 0; k < ROWS_PER_WARP; ++k) {
        const int a = a0 + k;
        if (a >= N) break;
        int d = 0;
#pragma unroll
        for (int w = 0; w < WORDS; ++w) d += __popc(rw[k][w] ^ cw[w]);
        if (!(rv[k] && cvalid && gp[static_cast<size_t>(a) * N + b])) d = BIG;
        // row: the lane's columns come in increasing order
        if (d < best[k]) {
          second[k] = min(second[k], best[k]);
          best[k] = d;
          idx[k] = b;
        } else {
          second[k] = min(second[k], d);
        }
        // column: the warp's rows come in increasing order
        const unsigned long long kk =
            (static_cast<unsigned long long>(d) << 32) | static_cast<unsigned>(a);
        key = kk < key ? kk : key;
      }
      if (key != ~0ull) atomicMin(&colmin[bl], key);
    }
    __syncthreads();
    unsigned long long* out =
        colpart + (static_cast<size_t>(p) * T + tile) * N + c0;
    for (int t = threadIdx.x; t < nc; t += THREADS) out[t] = colmin[t];
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < ROWS_PER_WARP; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int ob = __shfl_xor_sync(0xffffffffu, best[k], off);
      const int oi = __shfl_xor_sync(0xffffffffu, idx[k], off);
      const int os = __shfl_xor_sync(0xffffffffu, second[k], off);
      merge(best[k], idx[k], second[k], ob, oi, os);
    }
    const int a = a0 + k;
    if (lane == 0 && a < N) {
      rows[(0 * P + p) * N + a] = idx[k];
      rows[(1 * P + p) * N + a] = best[k];
      rows[(2 * P + p) * N + a] = second[k];
    }
  }
}

__global__ void __launch_bounds__(LINK_THREADS)
intra_link_kernel(const uint8_t* __restrict__ valid, const int* __restrict__ rows,
                  const unsigned long long* __restrict__ colpart,
                  int* __restrict__ parent, int C, int N, int T, int max_dist,
                  float ratio) {
  const int P = C * (C - 1) / 2;
  const int p = blockIdx.y;
  const int a = blockIdx.x * LINK_THREADS + threadIdx.x;
  if (a >= N) return;
  int ci, cj;
  pair_cams(p, C, ci, cj);
  const int b = rows[(0 * P + p) * N + a];
  const int best = rows[(1 * P + p) * N + a];
  const int second = rows[(2 * P + p) * N + a];
  const unsigned long long* cp = colpart + static_cast<size_t>(p) * T * N + b;
  unsigned long long key = ~0ull;
  for (int t = 0; t < T; ++t) {
    const unsigned long long k = cp[static_cast<size_t>(t) * N];
    key = k < key ? k : key;
  }
  const bool mutual = static_cast<int>(key & 0xffffffffu) == a;
  const bool ok = mutual && best <= max_dist &&
                  static_cast<float>(best) <=
                      __fmul_rn(ratio, static_cast<float>(second)) &&
                  valid[ci * N + a] != 0;
  if (ok) atomicMin(&parent[cj * N + b], ci * N + a);
}

}  // namespace

// desc (C, N, 8) int32, valid (C, N) bool, gate (P, N, N) bool -> parent
// (C, N) int32; rows (3, P, N) int32 and colpart (P, T, N) uint64 are the
// caller's scratch, T = ceil(N / RT) row tiles (checked)
extern "C" int mc_intra_pairs(const void* desc, const void* valid,
                              const void* gate, void* parent, void* rows,
                              void* colpart, int C, int N, int T,
                              int max_dist, float ratio, void* stream) {
  if (C < 2 || N < 0 || T != (N + RT - 1) / RT) return cudaErrorInvalidValue;
  if (N == 0) return 0;
  const int P = C * (C - 1) / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  intra_rows_kernel<<<dim3(T, P), THREADS, 0, s>>>(
      static_cast<const int*>(desc), static_cast<const uint8_t*>(valid),
      static_cast<const uint8_t*>(gate), static_cast<int*>(parent),
      static_cast<int*>(rows), static_cast<unsigned long long*>(colpart), C, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  intra_link_kernel<<<dim3((N + LINK_THREADS - 1) / LINK_THREADS, P),
                      LINK_THREADS, 0, s>>>(
      static_cast<const uint8_t*>(valid), static_cast<const int*>(rows),
      static_cast<const unsigned long long*>(colpart), static_cast<int*>(parent),
      C, N, T, max_dist, ratio);
  return static_cast<int>(cudaGetLastError());
}
