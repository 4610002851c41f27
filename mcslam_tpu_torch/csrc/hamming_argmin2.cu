// Gated Hamming matching: row best / second best / first argmin and the
// column first argmin, one launch.
//
// Replaces: mcslam_tpu/ops/match_pallas.py hamming_argmin2 (_kernel).
//
// Computes, for query rows i < M and target columns j < N:
//   dist  = popcount(a_i XOR b_j) over the 8 packed 32-bit words
//           (the same integers as (256 - A.B^T) / 2 on +-1 bit planes);
//   d2    = sum_k ahat[i, k] * bhat[k, j], a plain f32 FMA loop over
//           DG <= 16 gate factors (never TF32: the validity terms are
//           +-1e13 biases that only work in true f32);
//   gated = d2 < thr2 ? dist : 2^20;
//   per row: the min, the first column attaining it, and the second best
//           (min over every other column);
//   per column (want_cols): the min over rows and the first row attaining
//           it, through a 64-bit atomicMin on (float_bits(value) << 32 |
//           row) — values are >= 0, so the smallest value wins and, among
//           equal values, the lowest row: the TPU kernel's cross-tile rule
//           (earlier tile wins ties) in one pass.
// Ragged edges are masked in the kernel; no padding.
//
// Bound on the card: integer/FMA throughput, not memory. At the production
// shapes (2048 x 2048 and 2048 x 4096) the inputs are < 0.5 MB, while the
// pair loop runs 4-8 M pairs x (8 XOR+POPC, 14 FMA, compares). Design:
// 16 rows per block x 16 column subsets per row (256 threads), so the
// 2048-row problems launch 128 blocks; each thread keeps its row's
// descriptor and gate factors in registers, column tiles (descriptors +
// gate factors, 24 KB) are staged in shared memory and read as
// half-warp broadcasts; the per-row partial top-2 of the 16 subsets is
// merged in shared memory; the column argmin is reduced over the block's
// 16 rows by shuffles before one atomic per column per block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 16;  // rows per block
constexpr int NSUB = 16;  // column subsets (threads per row)
constexpr int THREADS = TM * NSUB;
constexpr int TN = 256;  // columns per staged tile
constexpr int DGMAX = 16;
constexpr float BIGF = 1048576.f;  // ops/match.BIG

__device__ __forceinline__ bool lex_less(float v1, int i1, float v2, int i2) {
  return (v1 < v2) || (v1 == v2 && i1 < i2);
}

__global__ void __launch_bounds__(THREADS) hamming_argmin2_kernel(
    const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
    const float* __restrict__ ahat, const float* __restrict__ bhat,
    float* __restrict__ row_best, float* __restrict__ row_second,
    int* __restrict__ row_idx, unsigned long long* __restrict__ col_key,
    int M, int N, int DG, float thr2, int want_cols) {
  __shared__ uint32_t s_b[TN][8];
  __shared__ float s_bh[DGMAX][TN];
  __shared__ float s_best[NSUB][TM];
  __shared__ float s_sec[NSUB][TM];
  __shared__ int s_idx[NSUB][TM];

  const int tid = threadIdx.x;
  const int r = tid % TM;
  const int sub = tid / TM;
  const int row = blockIdx.x * TM + r;
  const bool row_ok = row < M;

  uint32_t aw[8];
  float ah[DGMAX];
#pragma unroll
  for (int w = 0; w < 8; ++w) aw[w] = row_ok ? a[(size_t)row * 8 + w] : 0u;
#pragma unroll
  for (int k = 0; k < DGMAX; ++k)
    ah[k] = (row_ok && k < DG) ? ahat[(size_t)row * DG + k] : 0.f;

  float best = __int_as_float(0x7f800000);  // +inf
  float second = BIGF;
  int idx = 0x7fffffff;

  for (int j0 = 0; j0 < N; j0 += TN) {
    __syncthreads();
    for (int i = tid; i < TN * 8; i += THREADS) {
      const int jj = i / 8, w = i % 8;
      const int j = j0 + jj;
      s_b[jj][w] = j < N ? b[(size_t)j * 8 + w] : 0u;
    }
    for (int i = tid; i < DGMAX * TN; i += THREADS) {
      const int k = i / TN, jj = i % TN;
      const int j = j0 + jj;
      s_bh[k][jj] = (k < DG && j < N) ? bhat[(size_t)k * N + j] : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int q = 0; q < TN / NSUB; ++q) {
      const int jj = sub + NSUB * q;
      const int j = j0 + jj;
      float g = __int_as_float(0x7f800000);
      if (row_ok && j < N) {
        int pc = 0;
#pragma unroll
        for (int w = 0; w < 8; ++w) pc += __popc(aw[w] ^ s_b[jj][w]);
        float d2 = 0.f;
#pragma unroll
        for (int k = 0; k < DGMAX; ++k)
          if (k < DG) d2 = fmaf(ah[k], s_bh[k][jj], d2);
        g = d2 < thr2 ? (float)pc : BIGF;
        if (g < best) {
          second = fminf(second, best);
          best = g;
          idx = j;
        } else {
          second = fminf(second, g);
        }
      }
      if (want_cols) {
        // min over the block's 16 rows of column j (one half-warp holds
        // rows 0..15 of one column); lowest row wins ties
        float cv = g;
        int cr = row_ok ? row : 0x7fffffff;
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, cv, off);
          const int orr = __shfl_xor_sync(0xffffffffu, cr, off);
          if (lex_less(ov, orr, cv, cr)) {
            cv = ov;
            cr = orr;
          }
        }
        if (r == 0 && j < N && cr != 0x7fffffff) {
          const unsigned long long key =
              ((unsigned long long)__float_as_uint(cv) << 32) |
              (unsigned long long)(unsigned)cr;
          atomicMin(&col_key[j], key);
        }
      }
    }
  }

  s_best[sub][r] = best;
  s_sec[sub][r] = second;
  s_idx[sub][r] = idx;
  __syncthreads();
  if (sub == 0 && row_ok) {
    float bv = s_best[0][r], sv = s_sec[0][r];
    int bi = s_idx[0][r];
    for (int s = 1; s < NSUB; ++s) {
      const float ov = s_best[s][r], os = s_sec[s][r];
      const int oi = s_idx[s][r];
      if (lex_less(ov, oi, bv, bi)) {
        sv = fminf(os, bv);
        bv = ov;
        bi = oi;
      } else {
        sv = fminf(sv, ov);
      }
    }
    row_best[row] = bv;
    row_second[row] = sv;
    row_idx[row] = bi;
  }
}

}  // namespace

extern "C" int mc_hamming_argmin2(const uint32_t* a, const uint32_t* b,
                                  const float* ahat, const float* bhat,
                                  float* row_best, float* row_second,
                                  int* row_idx, unsigned long long* col_key,
                                  int M, int N, int DG, float thr2,
                                  int want_cols, void* stream) {
  if (M == 0) return 0;
  const int blocks = (M + TM - 1) / TM;
  hamming_argmin2_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      a, b, ahat, bhat, row_best, row_second, row_idx, col_key, M, N, DG,
      thr2, want_cols);
  return (int)cudaGetLastError();
}
