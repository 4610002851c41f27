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
//    (w J)^T r and w (sum_r r^2), sums over r in index order, every
//    float32 product and sum rounded on its own (__fmul_rn / __fadd_rn,
//    never contracted into an FMA), as torch's elementwise kernels round
//    them;
//  - H = E Hpp E^T + prior_H + H_imu + H_gps + H_between, each table's
//    term the sum over its factors in index order, added to the entry in
//    that order; g and the cost likewise. E is 0/1, so the vision block
//    is copied: Hpp's 6 x 6 block (k, l) to rows k D .. k D + 5 and
//    columns l D .. l D + 5.
// A factor of weight 0 (a padded or invalid one) adds nothing. An index
// outside [0, K) reads keyframe 0 or K - 1 and adds nothing (the plain
// version faults). The plain version's einsums sum over (f, r) in an
// order that cannot be repeated, so H, g and the cost agree with it to
// float32 rounding (chip_smoke.py phase 2), and J_f and r_f to float64
// rounding before the cast.
//
// Bound on the card: latency. At the stage D shape (K = 6, N = 96, 5 IMU
// and 6 GPS factors) the inputs and outputs are ~0.09 MB (0.03 us at 3.35
// TB/s) and the float64 operations ~0.4 M (chip_smoke.VIO_DUAL_OPS, a
// lane's operations times its factor's n lanes: ~0.01 us at 34 TFLOP/s).
// A lane's deepest chain of dependent float64 operations is a few dozen
// long (chip_smoke.VIO_DUAL_DEPTH), so neither sets the pace: one warp's
// issue of its residual's instructions and the loads and barriers do.
// Design, ONE thread-block cluster of CLUSTER blocks of 256 threads
// (launched with a cluster dimension, captured into CUDA graphs as any
// launch):
//  - factor q (IMU factors first, then GPS, then between) runs on block
//    q mod CLUSTER, in warp (q / CLUSTER) mod 8: lane t < n the tangent
//    direction e_t, carrying (primal, derivative) pairs through the
//    residual (every lane computes the primal too). At stage D that is
//    one or two factor warps a block;
//  - the factor warp first stages its factor's inputs (poses, states,
//    preintegrated deltas, sqrt_info) in its shared memory, all loads in
//    flight together, so the residual reads them without a round trip to
//    device memory;
//  - the float32 J columns go to shared memory, and fl(w J) once by
//    tangent column; lane t makes column t of (w J)^T J (four rows of
//    fl(w J) a float4 load) and entry t of (w J)^T r, lane 0 the cost;
//    each factor's J, r and blocks go to its record in the scratch slab,
//    and its blocks also stay in its block's shared memory;
//  - meanwhile the block's other warps load every factor's keyframe
//    blocks and weight, make for each state block a bit mask of the
//    weighted factors touching it, and start the block's band of rows of
//    [H; g] (about (N + 1) / CLUSTER rows) at its vision and prior terms
//    in shared memory;
//  - one cluster barrier (release / acquire) replaces an arrival counter;
//    after it each block copies the blocks of the factors its band needs
//    from their blocks' shared memory (distributed shared memory), eight
//    loads in flight a thread, and arrives at a second cluster barrier,
//    whose wait it passes only before it exits (so no block leaves while
//    another still reads its shared memory);
//  - each block places its band, a thread an entry: its start, then
//    table by table the sum of the factors in both its row's and its
//    column's state-block masks (its column's for g), in index order from
//    0, added where the table touched the entry; one warp of the last
//    block sums the cost in the same order. No float atomics: launches
//    and graph replays are bit-equal, and H, g and the cost equal the
//    earlier design's (one block placing every entry after an arrival
//    counter) for equal records.
// Where the band's start and the copies of every factor's blocks do not
// fit in the shared memory a block may use (SMEM_MAX; e.g. 60 IMU slots
// at K = 6), the blocks are read from the scratch (L2) and each start is
// loaded when it is placed.
// Earlier designs and their times: scripts/vio_factors_variants.py,
// PERF.md.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

#include "vio_dual.cuh"

namespace cg = cooperative_groups;

namespace {

using vio::Dual;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CLUSTER = 8;  // blocks of the one cluster (portable size)
// each factor's inputs staged in its warp's shared memory before the
// residual reads them
constexpr bool STAGE_INPUTS = true;
constexpr int D = vio::D;
constexpr int RMAX = 15;  // residual rows of a factor at most
constexpr int NTAB = 3;   // imu, gps, between
// dynamic shared memory a block may use at most (opted into once per
// device; the warps' static buffers take another 32 KB): the factors'
// meta and state-block masks, the band's start, the block's factors'
// blocks and the copies of the blocks its band needs
constexpr size_t SMEM_MAX = 160 * 1024;

// a factor's record in the scratch: J (R, n) and r (R,) as float32, then
// (w J)^T J (n, n), (w J)^T r (n,) and w |r|^2 (its blocks)
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
// a factor's blocks: (w J)^T J, (w J)^T r, w |r|^2
__host__ __device__ constexpr int blk_of(int t) {
  return ncols(t) * ncols(t) + ncols(t) + 1;
}
// a factor's blocks in its block's shared memory: slots of the largest
// (IMU), padded to 16 bytes
constexpr int BLK_STRIDE = (blk_of(0) + 3) / 4 * 4;
// a warp's shared memory (floats): its factor's staged inputs (IMU: 342)
// overlaid by its J columns (RMAX x 32) and residuals (RMAX); then
// fl(w J) by tangent column, RMAX padded to 16 (32 x 16)
constexpr int WJ_OFF = (RMAX * 33 + 3) / 4 * 4;
constexpr int WARP_FLOATS = WJ_OFF + 32 * 16;
static_assert(16 + 3 + 6 + 16 + 3 + 6 + 9 + 3 + 3 + 1 + 5 * 9 + 6 + 225 <=
                  WJ_OFF,
              "an IMU factor's inputs fit below fl(w J)");

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
  int K, F, G, B;
  int in_smem;  // the band's start and the factors' blocks in shared memory
  int band;     // rows of a band at most
  double g_norm;
};
constexpr int N_PTRS = 38;  // the pointers above, in this order
static_assert(offsetof(Args, K) == N_PTRS * sizeof(void*),
              "Args: N_PTRS pointers, then the sizes");

// the dynamic shared memory of a block, in this order: every factor's
// meta (b0, b1, weighted, the band needs it); for each state block and
// 32 factors a mask of the weighted ones touching it; and where in_smem:
// the band's start, the block's own factors' blocks, and the copies of
// every factor's blocks the band needs (table by table, the factors in
// order: loc_of)
struct Layout {
  int4* meta;
  unsigned* mask;
  float *band, *blk, *loc;
  int W;  // mask words a state block
};

__host__ __device__ constexpr int mask_words(int nf) { return (nf + 31) / 32; }
__host__ __device__ constexpr int own_slots(int nf) {
  return (nf + CLUSTER - 1) / CLUSTER;
}
__host__ __device__ constexpr long long all_blks(int F, int G, int B) {
  return static_cast<long long>(F) * blk_of(0) +
         static_cast<long long>(G + B) * blk_of(1);
}

__device__ __forceinline__ Layout layout(const Args& a, int4* dyn) {
  const int nf = a.F + a.G + a.B, N = a.K * D + 6;
  Layout l;
  l.W = mask_words(nf);
  l.meta = dyn;
  l.mask = reinterpret_cast<unsigned*>(dyn + nf);
  l.band = reinterpret_cast<float*>(l.mask + ((a.K + 1) * l.W + 3) / 4 * 4);
  l.blk = l.band + a.band * N;
  l.loc = l.blk + own_slots(nf) * BLK_STRIDE;
  return l;
}

__device__ __forceinline__ int block_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}

// the cluster barrier split in two: arrive (release: this thread's
// memory operations before it are seen by the threads after their wait)
// and wait (acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ int clampk(int k, int K) {
  return k < 0 ? 0 : (k >= K ? K - 1 : k);
}

__device__ __forceinline__ float gps_weight(uint8_t valid, float sigma) {
  const float s = sigma < 1e-3f ? 1e-3f : sigma;  // clamp, NaN kept
  return __fdiv_rn(static_cast<float>(valid != 0), __fmul_rn(s, s));
}

// table t's factors, its first factor among all, its first record's
// offset in the scratch, and its first factor's blocks' among the copies
__device__ __forceinline__ int count_of(const Args& a, int t) {
  return t == 0 ? a.F : (t == 1 ? a.G : a.B);
}
__device__ __forceinline__ int first_of(const Args& a, int t) {
  return t == 0 ? 0 : (t == 1 ? a.F : a.F + a.G);
}
__device__ __forceinline__ long long rec_base(const Args& a, int t) {
  return t == 0 ? 0
                : static_cast<long long>(a.F) * rec_of(0) +
                      (t == 2 ? static_cast<long long>(a.G) * rec_of(1) : 0);
}
__device__ __forceinline__ int loc_of(const Args& a, int t, int f) {
  return t == 0 ? f * blk_of(0)
                : a.F * blk_of(0) + (t == 2 ? a.G * blk_of(1) : 0) +
                      f * blk_of(1);
}
// table t's factor f's blocks in the scratch
__device__ __forceinline__ const float* blk_in_scratch(const Args& a, int t,
                                                       int f) {
  return a.scratch + rec_base(a, t) + static_cast<long long>(f) * rec_of(t) +
         nrows(t) * (ncols(t) + 1);
}

// a segment of a factor's inputs: n <= 32 floats at p
struct Seg {
  const float* p;
  int n;
};

// the warp's factor's inputs to its shared memory dst, segment after
// segment: every lane's loads in flight before its stores
template <int S>
__device__ __forceinline__ void stage(float* dst, const Seg (&seg)[S],
                                      int lane) {
  float v[S];
#pragma unroll
  for (int s = 0; s < S; ++s)
    v[s] = lane < seg[s].n ? __ldg(seg[s].p + lane) : 0.f;
  int off = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (lane < seg[s].n) dst[off + lane] = v[s];
    off += seg[s].n;
  }
  __syncwarp();  // the factor's inputs staged
}

// The warp's factor from its duals r (R per lane, lane t < N the tangent
// direction t): its record rec in the scratch, its blocks also to blk_s
// (shared memory; nullptr: not kept), with the columns of a same-keyframe
// factor added. ws: the warp's shared memory.
template <int N, int R>
__device__ __forceinline__ void factor_record(const Dual<double>* r, float w,
                                              bool merge, float* rec,
                                              float* blk_s, float* ws,
                                              int lane) {
  float(*sJ)[32] = reinterpret_cast<float(*)[32]>(ws);
  float* sr = ws + RMAX * 32;
  float4(*wJ)[4] = reinterpret_cast<float4(*)[4]>(ws + WJ_OFF);
  float J[R], rv[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    J[k] = static_cast<float>(r[k].d);  // J.float(), r.float()
    rv[k] = static_cast<float>(r[k].v);
  }
  __syncwarp();  // every lane done with the staged inputs
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
      for (int k = 0; k < R; ++k)
        sJ[k][lane] = __fadd_rn(sJ[k][lane], other[k]);
    } else if (lane < N) {
#pragma unroll
      for (int k = 0; k < R; ++k) sJ[k][lane] = 0.f;
    }
    __syncwarp();
  }
  // lane t: column t of J and of fl(w J), the latter to shared memory by
  // tangent column, four rows a float4
  float Jt[R], wJt[(R + 3) / 4 * 4];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    Jt[k] = sJ[k][lane];
    wJt[k] = __fmul_rn(w, Jt[k]);
  }
#pragma unroll
  for (int k = R; k < (R + 3) / 4 * 4; ++k) wJt[k] = 0.f;
  if (lane < N) {
#pragma unroll
    for (int k = 0; k < (R + 3) / 4; ++k)
      wJ[lane][k] = make_float4(wJt[4 * k], wJt[4 * k + 1], wJt[4 * k + 2],
                                wJt[4 * k + 3]);
  }
  __syncwarp();
  float* blk = rec + R * N + R;
  if (lane < N) {
#pragma unroll 2
    for (int s = 0; s < N; ++s) {
      float x[(R + 3) / 4 * 4];
#pragma unroll
      for (int k = 0; k < (R + 3) / 4; ++k) {
        const float4 v = wJ[s][k];
        x[4 * k] = v.x;
        x[4 * k + 1] = v.y;
        x[4 * k + 2] = v.z;
        x[4 * k + 3] = v.w;
      }
      float acc = __fmul_rn(x[0], Jt[0]);
#pragma unroll
      for (int k = 1; k < R; ++k) acc = __fadd_rn(acc, __fmul_rn(x[k], Jt[k]));
      blk[s * N + lane] = acc;
      if (blk_s) blk_s[s * N + lane] = acc;
    }
    float ga = __fmul_rn(wJt[0], sr[0]);
#pragma unroll
    for (int k = 1; k < R; ++k) ga = __fadd_rn(ga, __fmul_rn(wJt[k], sr[k]));
    blk[N * N + lane] = ga;
    if (blk_s) blk_s[N * N + lane] = ga;
  }
  if (lane == 0) {
    float c = __fmul_rn(rv[0], rv[0]);
#pragma unroll
    for (int k = 1; k < R; ++k) c = __fadd_rn(c, __fmul_rn(rv[k], rv[k]));
    blk[N * N + N] = __fmul_rn(w, c);
    if (blk_s) blk_s[N * N + N] = __fmul_rn(w, c);
  }
  __syncwarp();
}

__device__ __forceinline__ void imu_factor(const Args& a, int f, int lane,
                                           float* ws, float* rec,
                                           float* blk_s) {
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
  if (STAGE_INPUTS) {
    const Seg seg[] = {
        {in.Ti, 16}, {in.vi, 3}, {in.bi, 6}, {in.Tj, 16}, {in.vj, 3},
        {in.bj, 6}, {in.dR, 9}, {in.dv, 3}, {in.dp, 3}, {in.dt, 1},
        {in.dR_dbg, 9}, {in.dv_dbg, 9}, {in.dv_dba, 9}, {in.dp_dbg, 9},
        {in.dp_dba, 9}, {in.bias_hat, 6}, {in.sqrt_info, 32},
        {in.sqrt_info + 32, 32}, {in.sqrt_info + 64, 32},
        {in.sqrt_info + 96, 32}, {in.sqrt_info + 128, 32},
        {in.sqrt_info + 160, 32}, {in.sqrt_info + 192, 32},
        {in.sqrt_info + 224, 1}};
    stage(ws, seg, lane);
    const float* p = ws;
    in.Ti = p;
    in.vi = p += 16;
    in.bi = p += 3;
    in.Tj = p += 6;
    in.vj = p += 16;
    in.bj = p += 3;
    in.dR = p += 6;
    in.dv = p += 9;
    in.dp = p += 3;
    in.dt = p += 3;
    in.dR_dbg = p += 1;
    in.dv_dbg = p += 9;
    in.dv_dba = p += 9;
    in.dp_dbg = p += 9;
    in.dp_dba = p += 9;
    in.bias_hat = p += 9;
    in.sqrt_info = p += 6;
  }
  Dual<double> r[15];
  vio::imu_residual<double>(in, a.g_norm, lane, r);
  factor_record<2 * D, D>(r, a.iv[f] ? 1.f : 0.f, i0 == j0, rec, blk_s, ws,
                          lane);
}

__device__ __forceinline__ void gps_factor(const Args& a, int f, int lane,
                                           float* ws, float* rec,
                                           float* blk_s) {
  vio::GpsInputs in;
  in.pose = a.poses + 16 * clampk(a.gk[f], a.K);
  in.ETV = a.ETV;
  in.enu = a.enu + 3 * f;
  in.t_bg = a.t_bg;
  if (STAGE_INPUTS) {
    const Seg seg[] = {{in.pose, 16}, {in.ETV, 16}, {in.enu, 3},
                       {in.t_bg, 3}};
    stage(ws, seg, lane);
    in = {ws, ws + 16, ws + 32, ws + 35};
  }
  Dual<double> r[3];
  vio::gps_residual<double>(in, lane, r);
  factor_record<12, 3>(r, gps_weight(a.gv[f], a.sigma[f]), false, rec, blk_s,
                       ws, lane);
}

__device__ __forceinline__ void between_factor(const Args& a, int f,
                                               int lane, float* ws,
                                               float* rec, float* blk_s) {
  const int i0 = a.bi[f], j0 = a.bj[f];
  vio::BetweenInputs in;
  in.Ti = a.poses + 16 * clampk(i0, a.K);
  in.Tj = a.poses + 16 * clampk(j0, a.K);
  in.rel = a.rel + 16 * f;
  in.sigma_rot = a.sig_r + f;
  in.sigma_trans = a.sig_t + f;
  if (STAGE_INPUTS) {
    const Seg seg[] = {{in.Ti, 16}, {in.Tj, 16}, {in.rel, 16},
                       {in.sigma_rot, 1}, {in.sigma_trans, 1}};
    stage(ws, seg, lane);
    in = {ws, ws + 16, ws + 32, ws + 48, ws + 49};
  }
  Dual<double> r[6];
  vio::between_residual<double>(in, lane, r);
  factor_record<12, 6>(r, a.bv[f] ? 1.f : 0.f, i0 == j0, rec, blk_s, ws,
                       lane);
}

// the table of factor q among all (IMU, then GPS, then between) and its
// index in the table
__device__ __forceinline__ int table_of(const Args& a, int q, int* f) {
  const int t = q < a.F ? 0 : (q < a.F + a.G ? 1 : 2);
  *f = q - first_of(a, t);
  return t;
}

// table t's factor f touches state blocks (b0, b1) (-1: none; block K is
// E_T_V's) and has weight != 0
__device__ __forceinline__ int4 meta_of(const Args& a, int t, int f) {
  int x, y, wz;
  if (t == 0) {
    x = a.ii[f];
    y = a.ij[f];
    wz = a.iv[f] != 0;
  } else if (t == 1) {
    x = a.gk[f];
    y = a.K;
    wz = gps_weight(a.gv[f], a.sigma[f]) != 0.f;
  } else {
    x = a.bi[f];
    y = a.bj[f];
    wz = a.bv[f] != 0;
  }
  const int lim = t == 1 ? a.K + 1 : a.K;
  return make_int4(x >= 0 && x < a.K ? x : -1,
                   y >= 0 && y < lim && y != x ? y : -1, wz, 0);
}

// the state block of row (or column) r < N, block K the E_T_V rows, and
// its offset in the block
__device__ __forceinline__ int2 state_block(int r, int K) {
  const int A = r < K * D ? r / D : K;
  return make_int2(A, r - A * D);
}

// the vision and prior start of entry (r, c) of [H; g] (row N: g)
__device__ __forceinline__ float start_of(const Args& a, int r, int c,
                                          int N) {
  const int K = a.K;
  const int2 cb = state_block(c, K);
  if (r == N)
    return __fadd_rn(cb.x < K && cb.y < 6 ? __ldg(a.gp + 6 * cb.x + cb.y)
                                          : 0.f,
                     __ldg(a.prior_b + c));
  const int2 rb = state_block(r, K);
  return __fadd_rn(rb.x < K && cb.x < K && rb.y < 6 && cb.y < 6
                       ? __ldg(a.Hpp + (6 * rb.x + rb.y) * (6 * K) +
                               6 * cb.x + cb.y)
                       : 0.f,
                   __ldg(a.prior_H + r * N + c));
}

// the slot (in the factor's n tangent columns) of state row / column in
// block (A, o), for a factor on blocks (b0, b1) with h columns a block;
// -1: the factor does not touch it
__device__ __forceinline__ int slot_of(int2 Ao, int b0, int b1, int h) {
  if (Ao.y >= h) return -1;
  return Ao.x == b0 ? Ao.y : (Ao.x == b1 ? h + Ao.y : -1);
}

// the bits of mask word w that are table t's factors
__device__ __forceinline__ unsigned table_bits(const Args& a, int t, int w) {
  const int lo = first_of(a, t) - 32 * w, hi = lo + count_of(a, t);
  const int l = lo < 0 ? 0 : lo, h = hi > 32 ? 32 : hi;
  if (h <= l) return 0u;
  return (h - l == 32 ? ~0u : ((1u << (h - l)) - 1u)) << l;
}

__global__ void __launch_bounds__(THREADS) vio_factors_kernel(const Args a) {
  extern __shared__ int4 s_dyn[];  // 16-byte aligned
  __shared__ __align__(16) float s_w[WARPS][WARP_FLOATS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nf = a.F + a.G + a.B;
  // the block's factors: q = rank + CLUSTER u, u < nloc, on warp u % WARPS
  const int nloc = nf > block_rank()
                       ? (nf - block_rank() + CLUSTER - 1) / CLUSTER
                       : 0;
  const int fw = nloc < WARPS ? nloc : WARPS;

  // 1. the factors, a warp each
  for (int u = warp; u < nloc; u += WARPS) {
    const int q = block_rank() + CLUSTER * u;
    int f;
    const int t = table_of(a, q, &f);
    float* rec =
        a.scratch + rec_base(a, t) + static_cast<long long>(f) * rec_of(t);
    float* blk_s =
        a.in_smem ? layout(a, s_dyn).blk + u * BLK_STRIDE : nullptr;
    if (t == 0)
      imu_factor(a, f, lane, s_w[warp], rec, blk_s);
    else if (t == 1)
      gps_factor(a, f, lane, s_w[warp], rec, blk_s);
    else
      between_factor(a, f, lane, s_w[warp], rec, blk_s);
  }

  const int b = block_rank(), K = a.K, N = K * D + 6;
  const Layout l = layout(a, s_dyn);
  // the block's band of rows of [H; g], row N being g
  const int r0 = b * (N + 1) / CLUSTER, r1 = (b + 1) * (N + 1) / CLUSTER;
  // 2. meanwhile the other warps (all, where every warp has a factor,
  // after theirs): every factor's meta and the state blocks' masks, and
  // the band's start
  if (warp >= fw || fw == WARPS) {
    const int lw = fw == WARPS ? tid : tid - 32 * fw;
    const int nt = fw == WARPS ? THREADS : THREADS - 32 * fw;
    const int2 lo = state_block(r0, K);
    const int2 hi = state_block(r1 - 1 < N ? r1 - 1 : N - 1, K);
    const bool has_g = r1 == N + 1;
    for (int q = lw; q < nf; q += nt) {
      int f;
      const int t = table_of(a, q, &f);
      int4 m = meta_of(a, t, f);
      m.w = m.z && (has_g || (m.x >= lo.x && m.x <= hi.x) ||
                    (m.y >= lo.x && m.y <= hi.x));
      l.meta[q] = m;
    }
    if (a.in_smem) {
      // a warp a row, a lane every 32nd column, four columns' loads in
      // flight before their stores
      const int lwarp = lw >> 5, nwarps = nt >> 5;
      for (int r = r0 + lwarp; r < r1; r += nwarps) {
        for (int c0 = lane; c0 < N; c0 += 128) {
          float v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            v[k] = c0 + 32 * k < N ? start_of(a, r, c0 + 32 * k, N) : 0.f;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (c0 + 32 * k < N) l.band[(r - r0) * N + c0 + 32 * k] = v[k];
        }
      }
    }
    asm volatile("bar.sync 1, %0;" ::"r"(nt) : "memory");  // the meta
    // mask word w of state block A: bit j set where factor 32 w + j has
    // weight != 0 and touches A
    for (int i = lw; i < (K + 1) * l.W; i += nt) {
      const int A = i / l.W, w = i - A * l.W;
      unsigned bits = 0;
      for (int j = 0; j < 32 && 32 * w + j < nf; ++j) {
        const int4 m = l.meta[32 * w + j];
        bits |= static_cast<unsigned>(m.z && (m.x == A || m.y == A)) << j;
      }
      l.mask[i] = bits;
    }
  }
  // the block's factors and its band's start done
  cluster_arrive();
  cluster_wait();  // every factor's record written

  // 3. where in_smem, the blocks of every factor the band needs copied
  // from their blocks' shared memory (distributed shared memory), eight
  // loads in flight a thread; then this block reads no other's
  if (a.in_smem) {
    cg::cluster_group cluster = cg::this_cluster();
    const int T = static_cast<int>(all_blks(a.F, a.G, a.B));
    const int FB = a.F * blk_of(0), GB = FB + a.G * blk_of(1);
    for (int i0 = tid; i0 < T; i0 += 8 * THREADS) {
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int i = i0 + k * THREADS;
        const int t = i < FB ? 0 : (i < GB ? 1 : 2);
        const int j = i - (t == 0 ? 0 : (t == 1 ? FB : GB));
        const int f = j / blk_of(t), off = j - f * blk_of(t);
        const int q = first_of(a, t) + f;
        v[k] = 0.f;
        if (i < T && l.meta[q].w)
          v[k] = *cluster.map_shared_rank(
              l.blk + (q / CLUSTER) * BLK_STRIDE + off, q % CLUSTER);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (i0 + k * THREADS < T) l.loc[i0 + k * THREADS] = v[k];
    }
  }
  cluster_arrive();  // this block's reads of the others' done
  __syncthreads();   // the copies

  // 4. the cost: one warp of the last block, the factors' w |r|^2 loaded
  // 32 at a time and summed in index order
  if (b == CLUSTER - 1 && warp == WARPS - 1) {
    float c = __ldg(a.vcost);
#pragma unroll
    for (int t = 0; t < NTAB; ++t) {
      const int n = ncols(t), nt = count_of(a, t), q0 = first_of(a, t);
      float sum = 0.f;
      bool any = false;
      for (int f0 = 0; f0 < nt; f0 += 32) {
        const int f = f0 + lane;
        const bool w = f < nt && l.meta[q0 + f].z;
        float v = 0.f;
        if (w)
          v = a.in_smem ? l.loc[loc_of(a, t, f) + n * n + n]
                        : __ldcg(blk_in_scratch(a, t, f) + n * n + n);
        const unsigned mask = __ballot_sync(0xffffffffu, w);
        const int cnt = nt - f0 < 32 ? nt - f0 : 32;
        for (int j = 0; j < cnt; ++j) {
          const float vj = __shfl_sync(0xffffffffu, v, j);
          if ((mask >> j) & 1u) {
            sum = __fadd_rn(sum, vj);
            any = true;
          }
        }
      }
      if (any) c = __fadd_rn(c, sum);
    }
    if (lane == 0) *a.cost = c;
  }
  // the cost written

  // 5. the band, a thread an entry: its start, then each table's sum of
  // the factors of nonzero weight touching it (those in both its row's
  // and its column's state-block masks, or its column's for g), in index
  // order from 0, added where the table touched the entry
  const int nE = (r1 - r0) * N;
  for (int e = tid; e < nE; e += THREADS) {
    const int rr = e / N, r = r0 + rr, c = e - rr * N;
    const bool g_row = r == N;
    const int2 cb = state_block(c, K);
    const int2 rb = g_row ? make_int2(0, 0) : state_block(r, K);
    float acc = a.in_smem ? l.band[e] : start_of(a, r, c, N);
#pragma unroll
    for (int t = 0; t < NTAB; ++t) {
      const int n = ncols(t), h = t == 0 ? D : 6, q0 = first_of(a, t);
      float s = 0.f;
      bool hit = false;
      for (int w = 0; w < l.W; ++w) {
        unsigned bits = l.mask[cb.x * l.W + w] & table_bits(a, t, w);
        if (!g_row) bits &= l.mask[rb.x * l.W + w];
        while (bits) {
          const int q = 32 * w + __ffs(bits) - 1;
          bits &= bits - 1;
          const int4 m = l.meta[q];
          const int sc = slot_of(cb, m.x, m.y, h);
          const int sr = g_row ? n : slot_of(rb, m.x, m.y, h);
          if (sc >= 0 && sr >= 0) {
            const int f = q - q0, idx = sr * n + sc;
            s = __fadd_rn(s, a.in_smem ? l.loc[loc_of(a, t, f) + idx]
                                       : __ldcg(blk_in_scratch(a, t, f) +
                                                idx));
            hit = true;
          }
        }
      }
      if (hit) acc = __fadd_rn(acc, s);
    }
    if (g_row)
      a.g[c] = acc;
    else
      a.H[r * N + c] = acc;
  }
  // the band placed
  cluster_wait();  // no block reads this one's shared memory any more
  // end of the kernel
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
  if (e == cudaSuccess && CLUSTER > 8)
    e = cudaFuncSetAttribute(vio_factors_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

// the blocks of the kernel's one cluster
extern "C" int mc_vio_factors_cluster() { return CLUSTER; }

// p: N_PTRS device pointers in Args' order (poses (K, 4, 4), vels (K, 3),
// biases (K, 6), E_T_V (4, 4), Hpp (6K, 6K), gp (6K,), the vision cost
// (), prior_H (N, N), prior_b (N,) float32; the IMU table's 14 fields, the
// GPS table's 5, the between table's 6 (index columns int32, valid as
// bytes, the rest float32, each contiguous; an absent table's pointers
// are not read: F, G or B = 0); H (N, N), g (N,), cost (), the scratch
// (vio_cuda.scratch_floats: the factors' records)), a host array.
// N = 15 K + 6.
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
  const size_t N = 15 * static_cast<size_t>(K) + 6;
  a.band = static_cast<int>((N + 1 + CLUSTER - 1) / CLUSTER);
  const size_t need =
      sizeof(int4) * nf +
      sizeof(unsigned) * (((K + 1) * mask_words(nf) + 3) / 4 * 4);
  const size_t rest =
      sizeof(float) *
      (a.band * N +
       static_cast<size_t>(BLK_STRIDE) * own_slots(nf) +
       static_cast<size_t>(all_blks(F, G, B)));
  a.in_smem = need + rest <= SMEM_MAX;
  const size_t smem = need + (a.in_smem ? rest : 0);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem();
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (CLUSTER > 8) {  // a non-portable cluster: launch only where it fits
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, vio_factors_kernel, &cfg);
    if (e != cudaSuccess) return e;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
  }
  e = cudaLaunchKernelEx(&cfg, vio_factors_kernel, a);
  if (e != cudaSuccess) return e;
  return static_cast<int>(cudaGetLastError());
}
