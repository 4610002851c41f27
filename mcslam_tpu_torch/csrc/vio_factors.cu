// The factor half of a VIO window linearization in one launch: every IMU,
// GPS and between factor's whitened residual and its Jacobian on the
// factor's tangent at 0, by forward-mode duals in float64, their
// w J^T J, w J^T r and w |r|^2, and the dense pose-side system H (N, N),
// g (N,) and the cost with the vision block and the prior placed in.
//
// Replaces: the factor Jacobians of the JAX package's VIO assembly,
// mcslam_tpu/backend/ba_vio.py _assemble_vio (:161), jax.vmap(jax.jacfwd)
// of the IMU (:257-258), GPS (:298-299) and between (:339-340) residuals
// and their scatter-adds, which XLA fuses into vio_solve's one compiled
// program. No Pallas kernel corresponds to them. In the port the plain
// version is backend/vio_cuda.vio_factors_reference: per factor table a
// torch.func.vmap(torch.func.jacfwd) in float64, a product with a 0/1
// selection matrix and two einsums, and the vision block embedded by two
// products with a 0/1 matrix E (~890 host-issued ops a linearization).
//
// Computes what the plain version computes:
//  - J_f (R, n), r_f (R,): the whitened residual and its Jacobian at
//    tangent 0 in float64 (csrc/vio_dual.cuh), cast to float32. IMU
//    factors: R = 15 on n = 30 (both keyframes' 15 dofs), GPS: 3 on 12
//    (the keyframe's pose and E_T_V), between: 6 on 12 (two poses). The
//    weight w_f: valid for IMU and between factors, valid /
//    clamp(sigma, 1e-3)^2 for GPS, in float32;
//  - a factor whose two column blocks land on the same keyframe (i == j,
//    as a padded factor's 0, 0) has its two halves' columns added, as
//    J @ sel adds them;
//  - per factor (w J)^T J (entry (s, t) = sum_r fl(w J[r][s]) J[r][t]),
//    (w J)^T r and w (sum_r r^2), sums over r in index order (built with
//    -fmad=false, _build.SOURCE_FLAGS: every product and sum is rounded
//    on its own, as torch's elementwise kernels round them);
//  - H = E Hpp E^T + prior_H + H_imu + H_gps + H_between, each table's
//    term the sum over its factors in index order, added to the entry in
//    that order; g and the cost likewise. E is 0/1, so the vision block
//    is copied: Hpp's 6 x 6 block (k, l) to rows k D .. k D + 5 and
//    columns l D .. l D + 5.
// A factor of weight 0 (a padded or invalid one) adds nothing. An index
// outside [0, K) reads keyframe 0 or K - 1 and adds nothing (the plain
// version faults). The plain version's einsums sum over (f, r) in an
// order that cannot be repeated, so H, g and the cost agree with it to
// float32 rounding (chip_smoke.py phase 2: 1e-6 of the largest entry of
// the factor part), and J_f and r_f to float64 rounding before the cast.
//
// Bound on the card: latency. At the stage D shape (K = 6, N = 96, 5 IMU
// and 6 GPS factors) the inputs and outputs are ~0.09 MB (0.03 us at 3.35
// TB/s) and the float64 operations ~0.59 M (chip_smoke.VIO_DUAL_OPS, a
// lane's operations times its factor's n lanes: 0.02 us at 34 TFLOP/s).
// What counts is one factor's chain of dependent float64 operations and
// the launch itself. Design, a single launch of 256-thread blocks:
//  - a warp per factor, lane t < n the tangent direction e_t: it carries
//    (primal, derivative) pairs through the residual (every lane computes
//    the primal too; no lane waits for another), IMU factors first, then
//    GPS, then between factors, one a block (FACTOR_WARPS), spread over
//    the SMs; the block's other warps only arrive;
//  - the float32 J columns go to shared memory; lane t makes column t of
//    (w J)^T J and entry t of (w J)^T r, lane 0 the cost; each factor's
//    J, r and blocks are written to its record in the scratch slab;
//  - the last block to arrive (an arrival counter, graphs.counters,
//    atom.add.acq_rel after the block's barrier; put back to 0 by that
//    block, so calls and graph replays share it) loads every factor's
//    keyframe blocks and weight at once, a thread a factor, copies the
//    records' (w J)^T J, (w J)^T r and w |r|^2 into shared memory by
//    cp.async, and starts every entry of H and g at its vision and prior
//    terms, all loads in flight together; then, table by table, it adds
//    each factor of nonzero weight, in index order, into a table sum at
//    its states' entries (a factor's entries are distinct: a thread an
//    entry, a barrier between factors), and adds the table sum to the
//    entries the table touched. The accumulators (82 KB at N = 96) and
//    the records (22 KB) sit in shared memory where they fit (SMEM_MAX),
//    else in the scratch. An entry's terms come in the fixed order above:
//    no float atomics, so launches and graph replays are bit-equal. Two
//    earlier designs placed each entry of H from lists of the factors
//    touching its row, a thread an entry (0.07 ms) and a warp a tile of
//    rows (0.055 ms): scripts/vio_factors_variants.py, PERF.md.
// Launches that share the counter must not overlap in time (one stream).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

#include "vio_dual.cuh"

namespace {

using vio::Dual;

constexpr int THREADS = 256;
// factors a block: one (eight a block measured 1.8 us slower, PERF.md)
constexpr int FACTOR_WARPS = 1;
// the last block starts H and g in batches of LOAD_AHEAD rows (a warp)
// x COLS_AHEAD columns (a lane), all their loads in flight together
constexpr int LOAD_AHEAD = 4;
constexpr int COLS_AHEAD = 4;
constexpr int WARPS = THREADS / 32;
// entries of a factor a thread of the last block adds at a time
constexpr int SCATTER = 4;
constexpr int D = vio::D;
constexpr int RMAX = 15;  // residual rows of a factor at most
constexpr int NTAB = 3;   // imu, gps, between
// dynamic shared memory at most (opted into once per device): the
// factors' blocks and weights, the entries' accumulators and, where they
// fit, the records' blocks
constexpr size_t SMEM_MAX = 200 * 1024;

// a factor's record in the scratch: J (R, n) and r (R,) as float32, then
// (w J)^T J (n, n), (w J)^T r (n,) and w |r|^2
__host__ __device__ constexpr int rec_floats(int n, int R) {
  return R * n + R + n * n + n + 1;
}
// table t's tangent columns n and residual rows R
__host__ __device__ constexpr int ncols(int t) { return t == 0 ? 2 * D : 12; }
__host__ __device__ constexpr int nrows(int t) {
  return t == 0 ? D : (t == 1 ? 3 : 6);
}
__host__ __device__ constexpr int rec_of(int t) {
  return rec_floats(ncols(t), nrows(t));
}

struct Args {
  const float *poses, *vels, *biases, *ETV, *Hpp, *gp, *vcost, *prior_H,
      *prior_b;
  // IMU factors
  const int *ii, *ij;
  const float *dR, *dv, *dp, *dt, *dR_dbg, *dv_dbg, *dv_dba, *dp_dbg,
      *dp_dba, *bias_hat, *sqrt_info;
  const uint8_t* iv;
  // GPS factors
  const int* gk;
  const float *enu, *t_bg, *sigma;
  const uint8_t* gv;
  // between factors
  const int *bi, *bj;
  const float *rel, *sig_r, *sig_t;
  const uint8_t* bv;
  float *H, *g, *cost, *scratch;
  int* counter;
  int K, F, G, B;
  int staged;       // the records' blocks go to shared memory (they fit)
  int acc_in_smem;  // so do the entries' accumulators
  double g_norm;
};
constexpr int N_PTRS = 39;  // the pointers above, in this order
static_assert(offsetof(Args, K) == N_PTRS * sizeof(void*),
              "Args: N_PTRS pointers, then the sizes");

// atomicAdd of 1 with release and acquire semantics at device scope (as in
// ransac_score.cu): the block's records, written before a barrier, are
// seen by the last block after its barrier
__device__ __forceinline__ int add_acq_rel(int* p) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
}

// 4 bytes global -> shared without a register round trip: all of a
// thread's copies in flight at once (ransac_score.cu)
__device__ __forceinline__ void cp_async4(void* s, const void* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(s)),
               "l"(g));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// a record's value, staged in shared memory or written by another block
// (read from L2: this SM's L1 may hold an earlier launch's line)
__device__ __forceinline__ float load_rec(const float* p, bool in_smem) {
  return in_smem ? *p : __ldcg(p);
}

__device__ __forceinline__ int clampk(int k, int K) {
  return k < 0 ? 0 : (k >= K ? K - 1 : k);
}

__device__ __forceinline__ float gps_weight(uint8_t valid, float sigma) {
  const float s = sigma < 1e-3f ? 1e-3f : sigma;  // clamp, NaN kept
  return static_cast<float>(valid != 0) / (s * s);
}

// The warp's factor from its duals r (R per lane, lane t < N the tangent
// direction t): its record, with the columns of a same-keyframe factor
// added. sJ: the warp's (RMAX, 32) staging, sr: its R residuals.
template <int N, int R>
__device__ __forceinline__ void factor_record(const Dual<double>* r, float w, bool merge,
                              float* rec, float (*sJ)[32], float* sr,
                              int lane) {
  float J[R], rv[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    J[k] = static_cast<float>(r[k].d);  // J.float(), r.float()
    rv[k] = static_cast<float>(r[k].v);
  }
  if (lane < N) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      rec[k * N + lane] = J[k];
      sJ[k][lane] = J[k];
    }
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (lane == k) rec[R * N + k] = rv[k];
    if (lane == 0) sr[k] = rv[k];
  }
  __syncwarp();
  if (merge) {  // J @ sel: column c + n/2 added to column c
    constexpr int h = N / 2;
    float other[R];
#pragma unroll
    for (int k = 0; k < R; ++k) other[k] = lane < h ? sJ[k][lane + h] : 0.f;
    __syncwarp();
    if (lane < h) {
#pragma unroll
      for (int k = 0; k < R; ++k) sJ[k][lane] = sJ[k][lane] + other[k];
    } else if (lane < N) {
#pragma unroll
      for (int k = 0; k < R; ++k) sJ[k][lane] = 0.f;
    }
    __syncwarp();
  }
  float* blk = rec + R * N + R;
  if (lane < N) {
    float Jt[R];
#pragma unroll
    for (int k = 0; k < R; ++k) Jt[k] = sJ[k][lane];
#pragma unroll 6
    for (int s = 0; s < N; ++s) {
      float acc = (w * sJ[0][s]) * Jt[0];
#pragma unroll
      for (int k = 1; k < R; ++k) acc = acc + (w * sJ[k][s]) * Jt[k];
      blk[s * N + lane] = acc;
    }
    float ga = (w * Jt[0]) * sr[0];
#pragma unroll
    for (int k = 1; k < R; ++k) ga = ga + (w * Jt[k]) * sr[k];
    blk[N * N + lane] = ga;
  }
  if (lane == 0) {
    float c = rv[0] * rv[0];
#pragma unroll
    for (int k = 1; k < R; ++k) c = c + rv[k] * rv[k];
    blk[N * N + N] = w * c;
  }
  __syncwarp();
}

__device__ __forceinline__ void imu_factor(const Args& a, int f, int lane, float* rec,
                           float (*sJ)[32], float* sr) {
  const int i0 = a.ii[f], j0 = a.ij[f];
  const int i = clampk(i0, a.K), j = clampk(j0, a.K);
  vio::ImuInputs in;
  in.Ti = a.poses + 16 * i;
  in.vi = a.vels + 3 * i;
  in.bi = a.biases + 6 * i;
  in.Tj = a.poses + 16 * j;
  in.vj = a.vels + 3 * j;
  in.bj = a.biases + 6 * j;
  in.dR = a.dR + 9 * f;
  in.dv = a.dv + 3 * f;
  in.dp = a.dp + 3 * f;
  in.dt = a.dt + f;
  in.dR_dbg = a.dR_dbg + 9 * f;
  in.dv_dbg = a.dv_dbg + 9 * f;
  in.dv_dba = a.dv_dba + 9 * f;
  in.dp_dbg = a.dp_dbg + 9 * f;
  in.dp_dba = a.dp_dba + 9 * f;
  in.bias_hat = a.bias_hat + 6 * f;
  in.sqrt_info = a.sqrt_info + 225 * f;
  Dual<double> r[15];
  vio::imu_residual<double>(in, a.g_norm, lane, r);
  factor_record<2 * D, D>(r, a.iv[f] ? 1.f : 0.f, i0 == j0, rec, sJ, sr,
                          lane);
}

__device__ __forceinline__ void gps_factor(const Args& a, int f, int lane, float* rec,
                           float (*sJ)[32], float* sr) {
  vio::GpsInputs in;
  in.pose = a.poses + 16 * clampk(a.gk[f], a.K);
  in.ETV = a.ETV;
  in.enu = a.enu + 3 * f;
  in.t_bg = a.t_bg;
  Dual<double> r[3];
  vio::gps_residual<double>(in, lane, r);
  factor_record<12, 3>(r, gps_weight(a.gv[f], a.sigma[f]), false, rec, sJ, sr,
                       lane);
}

__device__ __forceinline__ void between_factor(const Args& a, int f, int lane, float* rec,
                               float (*sJ)[32], float* sr) {
  const int i0 = a.bi[f], j0 = a.bj[f];
  vio::BetweenInputs in;
  in.Ti = a.poses + 16 * clampk(i0, a.K);
  in.Tj = a.poses + 16 * clampk(j0, a.K);
  in.rel = a.rel + 16 * f;
  in.sigma_rot = a.sig_r + f;
  in.sigma_trans = a.sig_t + f;
  Dual<double> r[6];
  vio::between_residual<double>(in, lane, r);
  factor_record<12, 6>(r, a.bv[f] ? 1.f : 0.f, i0 == j0, rec, sJ, sr, lane);
}

// the index of table t's first factor among all
__device__ __forceinline__ int first_of(const Args& a, int t) {
  return t == 0 ? 0 : (t == 1 ? a.F : a.F + a.G);
}

__device__ __forceinline__ bool weighted(const Args& a, int t, int f) {
  if (t == 0) return a.iv[f] != 0;
  if (t == 1) return gps_weight(a.gv[f], a.sigma[f]) != 0.f;
  return a.bv[f] != 0;
}

// table t's factor f touches blocks (b0, b1) (b1 = -1: only b0)
__device__ __forceinline__ void blocks_of(const Args& a, int t, int f,
                                          int* b0, int* b1) {
  int x, y;
  if (t == 0) {
    x = a.ii[f];
    y = a.ij[f];
  } else if (t == 1) {
    x = a.gk[f];
    y = a.K;
  } else {
    x = a.bi[f];
    y = a.bj[f];
  }
  const int lim = t == 1 ? a.K + 1 : a.K;
  *b0 = x >= 0 && x < a.K ? x : -1;
  *b1 = y >= 0 && y < lim && y != x ? y : -1;
}

__global__ void __launch_bounds__(THREADS)
    vio_factors_kernel(const Args a) {
  extern __shared__ int4 s_dyn[];  // 16-byte aligned
  __shared__ float s_J[FACTOR_WARPS][RMAX][32];
  __shared__ float s_r[FACTOR_WARPS][RMAX];
  __shared__ int s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_tab[NTAB] = {a.F, a.G, a.B};
  long long base[NTAB];
  base[0] = 0;
  base[1] = static_cast<long long>(a.F) * rec_of(0);
  base[2] = base[1] + static_cast<long long>(a.G) * rec_of(1);

  // 1. a warp per factor: IMU, then GPS, then between factors
  const int f = warp < FACTOR_WARPS ? blockIdx.x * FACTOR_WARPS + warp
                                    : a.F + a.G + a.B;
  if (f < a.F) {
    imu_factor(a, f, lane, a.scratch + f * rec_of(0),
               s_J[warp], s_r[warp]);
  } else if (f < a.F + a.G) {
    const int q = f - a.F;
    gps_factor(a, q, lane, a.scratch + base[1] + q * rec_of(1),
               s_J[warp], s_r[warp]);
  } else if (f < a.F + a.G + a.B) {
    const int q = f - a.F - a.G;
    between_factor(a, q, lane,
                   a.scratch + base[2] + q * rec_of(2),
                   s_J[warp], s_r[warp]);
  }
  __syncthreads();  // the block's records written
  if (tid == 0) s_last = add_acq_rel(a.counter) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;

  // 2. the last block. All threads at once: each factor's keyframe
  // blocks and weight to shared memory, its record's blocks copied there
  // by cp.async where they fit, and every entry of H and g started at its
  // vision and prior terms (acc), with a table's sums (part) and their
  // flags (touched) at 0; acc, part and touched live in shared memory
  // where they fit, else in the scratch behind the records
  const int K = a.K, N = K * D + 6, NN = N * N + N, nf = a.F + a.G + a.B;
  int4* meta = s_dyn;  // b0, b1 (-1: none), weighted
  float* dyn = reinterpret_cast<float*>(s_dyn + nf);
  float* acc = a.acc_in_smem ? dyn : a.scratch + base[2] + a.B * rec_of(2);
  float* part = acc + NN;
  unsigned char* touched = reinterpret_cast<unsigned char*>(part + NN);
  float* staged = a.acc_in_smem ? part + NN + (NN + 3) / 4 : dyn;
  for (int q = tid; q < nf; q += THREADS) {
    const int t = q < a.F ? 0 : (q < a.F + a.G ? 1 : 2);
    const int f = q - first_of(a, t);
    int b0, b1;
    blocks_of(a, t, f, &b0, &b1);
    meta[q] = make_int4(b0, b1, weighted(a, t, f), 0);
  }
  // a table's factor f: its (w J)^T J at blk0[t] + f * stride[t], then
  // (w J)^T r and w |r|^2
  const float* blk0[NTAB];
  int stride[NTAB];
  {
    int off = 0;
#pragma unroll
    for (int t = 0; t < NTAB; ++t) {
      const int n = ncols(t), len = n * n + n + 1;
      const float* g0 = a.scratch + base[t] + nrows(t) * (n + 1);
      if (a.staged) {
        for (int f = 0; f < n_tab[t]; ++f)
          for (int i = tid; i < len; i += THREADS)
            cp_async4(staged + off + f * len + i, g0 + f * rec_of(t) + i);
      }
      blk0[t] = a.staged ? staged + off : g0;
      stride[t] = a.staged ? len : rec_of(t);
      off += n_tab[t] * len;
    }
  }
  const int K6 = 6 * K;
  unsigned* touched4 = reinterpret_cast<unsigned*>(touched);
  for (int w = tid; w < (NN + 3) / 4; w += THREADS) touched4[w] = 0;
  // rows of H, and g as row N: a warp LOAD_AHEAD rows at a time, a lane
  // every 32nd column of each, the loads of a batch ahead of its stores
  // (no division by N: an entry's keyframe block from its row and column)
  for (int r0 = warp * LOAD_AHEAD; r0 <= N; r0 += WARPS * LOAD_AHEAD) {
    for (int c0 = lane; c0 < N; c0 += 32 * COLS_AHEAD) {
      float v[LOAD_AHEAD][COLS_AHEAD];
#pragma unroll
      for (int i = 0; i < LOAD_AHEAD; ++i) {
        const int r = r0 + i;
        const int A = r < K * D ? r / D : K, oa = r - A * D;
#pragma unroll
        for (int u = 0; u < COLS_AHEAD; ++u) {
          const int c = c0 + 32 * u;
          const int B = c < K * D ? c / D : K, ob = c - B * D;
          v[i][u] = 0.f;
          if (r < N && c < N) {
            v[i][u] = (A < K && B < K && oa < 6 && ob < 6
                           ? __ldg(a.Hpp + (6 * A + oa) * K6 + 6 * B + ob)
                           : 0.f) +
                      __ldg(a.prior_H + r * N + c);
          } else if (r == N && c < N) {  // g
            const int Bg = c < K * D ? c / D : K, og = c - Bg * D;
            v[i][u] = (Bg < K && og < 6 ? __ldg(a.gp + 6 * Bg + og) : 0.f) +
                      __ldg(a.prior_b + c);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < LOAD_AHEAD; ++i) {
#pragma unroll
        for (int u = 0; u < COLS_AHEAD; ++u) {
          const int r = r0 + i, c = c0 + 32 * u;
          if (r <= N && c < N) {
            acc[r * N + c] = v[i][u];
            part[r * N + c] = 0.f;
          }
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();  // meta, acc, part, touched and the staged records

  // 3. each table's sum: its factors of nonzero weight in index order, a
  // factor's (w J)^T J and (w J)^T r added to part at its states' entries
  // by all threads (one entry a thread: a factor's entries are distinct),
  // a barrier between factors; then acc += part where the table touched
  // the entry. So an entry's terms come in the plain version's order:
  // the vision term, the prior, then the tables in order, each the sum
  // over its factors in index order (no float atomics)
#pragma unroll
  for (int t = 0; t < NTAB; ++t) {
    const int n = ncols(t), h = t == 0 ? D : 6, q0 = first_of(a, t);
    bool any = false;
    for (int f = 0; f < n_tab[t]; ++f) {
      const int4 m = meta[q0 + f];
      if (!m.z) continue;
      any = true;
      const float* blk = blk0[t] + f * stride[t];
      for (int e0 = tid; e0 < n * n + n; e0 += THREADS * SCATTER) {
        int pos[SCATTER];
        float v[SCATTER], p[SCATTER];
#pragma unroll
        for (int u = 0; u < SCATTER; ++u) {
          const int e = e0 + u * THREADS;
          const bool is_g = e >= n * n;
          const int s = is_g ? e - n * n : e / n, s2 = is_g ? 0 : e - s * n;
          const int row = s < h ? (m.x >= 0 ? m.x * D + s : -1)
                                : (m.y >= 0 ? m.y * D + s - h : -1);
          const int col = s2 < h ? (m.x >= 0 ? m.x * D + s2 : -1)
                                 : (m.y >= 0 ? m.y * D + s2 - h : -1);
          pos[u] = e >= n * n + n || row < 0 || (!is_g && col < 0)
                       ? -1
                       : (is_g ? N * N + row : row * N + col);
          v[u] = pos[u] >= 0 ? load_rec(blk + e, a.staged) : 0.f;
        }
        // a factor's entries are distinct: its reads, then its writes
#pragma unroll
        for (int u = 0; u < SCATTER; ++u)
          p[u] = pos[u] >= 0 ? part[pos[u]] : 0.f;
#pragma unroll
        for (int u = 0; u < SCATTER; ++u) {
          if (pos[u] >= 0) {
            part[pos[u]] = p[u] + v[u];
            touched[pos[u]] = 1;
          }
        }
      }
      __syncthreads();  // the factor's entries added
    }
    if (!any) continue;  // the same in every thread
    for (int w = tid; w < (NN + 3) / 4; w += THREADS) {
      const unsigned word = touched4[w];
      if (!word) continue;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int e = 4 * w + b;
        if ((word >> (8 * b)) & 0xffu) {
          acc[e] = acc[e] + part[e];
          part[e] = 0.f;
        }
      }
      touched4[w] = 0;
    }
    __syncthreads();  // the table's sums added
  }

  // 4. H, g and the cost out
  for (int e = tid; e < N * N; e += THREADS) a.H[e] = acc[e];
  for (int e = tid; e < N; e += THREADS) a.g[e] = acc[N * N + e];
  if (tid == 0) {
    float c = __ldg(a.vcost);
#pragma unroll
    for (int t = 0; t < NTAB; ++t) {
      const int n = ncols(t), q0 = first_of(a, t);
      float sum = 0.f;
      bool any = false;
      for (int f = 0; f < n_tab[t]; ++f) {
        if (!meta[q0 + f].z) continue;
        sum = sum + load_rec(blk0[t] + f * stride[t] + n * n + n, a.staged);
        any = true;
      }
      if (any) c = c + sum;
    }
    *a.cost = c;
    *a.counter = 0;
  }
  // end of the last block
}

}  // namespace

// the opt-in to SMEM_MAX bytes of dynamic shared memory, once per device
static cudaError_t allow_smem() {
  static std::atomic<uint64_t> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(vio_factors_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(SMEM_MAX));
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

// p: N_PTRS device pointers in Args' order (poses (K, 4, 4), vels (K, 3),
// biases (K, 6), E_T_V (4, 4), Hpp (6K, 6K), gp (6K,), the vision cost
// (), prior_H (N, N), prior_b (N,) float32; the IMU table's 14 fields, the
// GPS table's 5, the between table's 6 (index columns int32, valid as
// bytes, the rest float32, each contiguous; an absent table's pointers
// are not read: F, G or B = 0); H (N, N), g (N,), cost (), the scratch
// (vio_cuda.scratch_floats: the records, then room for the entries'
// accumulators) and the arrival counter (one int, zero
// at the call, zero again after it)), a host array. N = 15 K + 6.
extern "C" int mc_vio_factors(const void* const* p, int K, int F, int G,
                              int B, double g_norm, void* stream) {
  if (K < 1 || F < 0 || G < 0 || B < 0) return cudaErrorInvalidValue;
  Args a;
  const void** slot = reinterpret_cast<const void**>(&a);
  for (int k = 0; k < N_PTRS; ++k) slot[k] = p[k];
  a.K = K;
  a.F = F;
  a.G = G;
  a.B = B;
  a.g_norm = g_norm;
  const int nf = F + G + B;
  const int blocks = nf > 0 ? (nf + FACTOR_WARPS - 1) / FACTOR_WARPS : 1;
  const size_t N = 15 * static_cast<size_t>(K) + 6, NN = N * N + N;
  const size_t meta = sizeof(int4) * nf;
  const size_t accs = sizeof(float) * (2 * NN + (NN + 3) / 4);
  size_t recs = 0;
  for (int t = 0; t < NTAB; ++t)
    recs += sizeof(float) * (t == 0 ? F : (t == 1 ? G : B)) *
            (ncols(t) * ncols(t) + ncols(t) + 1);
  a.acc_in_smem = meta + accs <= SMEM_MAX;
  size_t smem = meta + (a.acc_in_smem ? accs : 0);
  a.staged = smem + recs <= SMEM_MAX;
  smem += a.staged ? recs : 0;
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  const cudaError_t e = allow_smem();
  if (e != cudaSuccess) return e;
  vio_factors_kernel<<<blocks, THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

