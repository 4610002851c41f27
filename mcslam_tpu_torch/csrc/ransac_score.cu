// Inlier counts of RANSAC pose hypotheses by generalized reprojection,
// the first hypothesis of the most inliers, and its pose, count and
// inlier mask, in one launch.
//
// Replaces: the TPU-shaped scoring of the JAX package's RANSAC,
// mcslam_tpu/frontend/ransac.py _score_reprojection (:150; the (K, M)
// projections and masked counts as one XLA fusion) and the argmax and
// gathers that follow it in ransac_kabsch / ransac_pnp, and in the
// tracking step's motion-candidate score and portfolio re-score
// (mcslam_tpu/tracking_kernels.py). No Pallas kernel corresponds to them.
// In the port the plain version is frontend/ransac_cuda.score_reference
// (ransac._score_reprojection, torch.argmax, index_select: ~35 tensor
// ops, with a (K, M) mask in device memory).
//
// Computes, for K hypotheses world_T_ref (K, 4, 4) and M correspondences
// (X_world (M, 3), uv (M, 2), the observing camera's cam_T_ref (M, 4, 4)
// and fx fy cx cy (M, 4), mask (M,)), what the plain version computes, in
// its order of operations:
//  1. ref_T_world = (R^T, -(R^T t)) (lie.se3_inverse);
//  2. p_ref = R^T X + t', p_cam = R_c p_ref + t_c: each 3-vector product
//     a matmul in the plain version (cuBLAS on the card), here the chain
//     fma(a2, b2, fma(a1, b1, a0 b0)), then the translation added;
//  3. good = z > 0.05, zs = z where good else 1, u = (x / zs) fx + cx,
//     v likewise, err2 = (u - u_obs)^2 + (v - v_obs)^2, every operation
//     rounded on its own (built with -fmad=false, _build.SOURCE_FLAGS);
//  4. inlier = good & err2 < px^2 & mask; counts[k] = the inliers of k;
//  5. best = the first k of the largest count (torch.argmax); the pose
//     world_T_ref[best] copied, its count as int32, and its inlier mask.
// The counts are integers, so no order of reduction shows in them; a
// flag may differ from the plain version's only where the matmul's order
// of rounding differs from the chain of step 2 and err2 lies that close
// to px^2 (chip_smoke.py phase 2 counts the flags that differ and where).
//
// Bound on the card: bytes at K = 1 and 3 (the correspondences, 85 B
// each with the mask, read once: ~0.17 MB at M = 2048, 0.05 us at 3.35
// TB/s), operations at K = 256 and 512 (~40 float32 operations per
// hypothesis and correspondence: 42 M at K = 512, 0.6 us at 67 TFLOP/s).
// Design, 128 threads (4 warps) a block, a 2-D grid of tiles of MT
// correspondences x HT hypotheses (plan(): at K = 1 tiles of 128 x 1, 16
// blocks at M = 2048; at K = 3 64 x 2, 64 blocks; at K = 256 and 512 32
// x 16 and 32 x 32, 1024 blocks, about 8 a multiprocessor):
//  - the block stages its tile once into shared memory by cp.async (all
//    of a thread's copies in flight at once): the cameras' poses and
//    intrinsics as coalesced 16-byte copies, the points and pixels as
//    coalesced words (the mask bytes by plain loads), and inverts its HT
//    poses meanwhile;
//  - warp w takes the tile's 32-correspondence group w % GW (GW = MT /
//    32) and the hypotheses h = w / GW + i (4 / GW), lane l one
//    correspondence: its flags of one hypothesis are one __ballot_sync, a
//    32-bit word of that hypothesis' bit row, kept by lane i for the
//    warp's i-th hypothesis; after its J hypotheses the warp writes the J
//    words to the (K, ceil(M / 32)) scratch and adds their popcounts to
//    the hypotheses' counts, one store and one integer atomic per lane
//    (the counts are integers: no order of reduction shows);
//  - the counts accumulate in K ints that are zero between launches, the
//    arrival counter after them (graphs.counters, K + 1 ints per K);
//    thread 0 adds one to the counter with release and acquire semantics
//    (atom.add.acq_rel.gpu) after the block's barrier;
//  - the last block of the grid to arrive takes each count (atomicExch:
//    read and put back to zero), writes the counts, takes the largest,
//    first index on ties, as a 64-bit key (count << 32 | ~index) reduced
//    by warp shuffles, writes the winner's index, pose and count, puts
//    the arrival counter back to zero and expands the winner's bit row
//    into its inlier mask, 16 flags a thread and one 16-byte store: no
//    second pass over the correspondences;
//  - no local memory: the pose and the correspondence live in registers
//    and shared memory.
// Launches that share the counters must not overlap in time (one stream).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MT_MAX = 32 * WARPS;  // correspondences of a tile at most
constexpr int HT_MAX = 64;          // hypotheses of a tile at most
constexpr int TARGET_BLOCKS = 1024;  // ~8 blocks on each of 132 SMs
constexpr unsigned FULL = 0xffffffffu;

// atomicAdd of 1 with release and acquire semantics at device scope (as in
// intra_match.cu): the block's rows and count atomics, issued before a
// barrier, are seen by the last block after its barrier
__device__ __forceinline__ int add_acq_rel(int* p) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
}

// 16 and 4 bytes global -> shared, without a register round trip: a
// thread's copies are all in flight at once (sgm_scan.cu)
__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(s)),
               "l"(g));
}

__device__ __forceinline__ void cp_async4(void* s, const void* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(s)),
               "l"(g));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the low 4 bits of b as 4 bytes of 0 / 1 (little-endian: bit 0 first)
__device__ __forceinline__ unsigned expand4(unsigned b) {
  return (b & 1u) | ((b >> 1 & 1u) << 8) | ((b >> 2 & 1u) << 16) |
         ((b >> 3 & 1u) << 24);
}

// a0 b0 + a1 b1 + a2 b2 as a float32 GEMM's chain of fused multiply-adds
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return __fmaf_rn(a2, b2, __fmaf_rn(a1, b1, __fmul_rn(a0, b0)));
}

// ref_T_world of a row-major world_T_ref: P[0..8] = R^T (row-major),
// P[9..11] = -(R^T t)
__device__ void invert(const float* __restrict__ T, float* P) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) P[3 * i + j] = T[4 * j + i];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    P[9 + i] = -dot3(T[i], T[4 + i], T[8 + i], T[3], T[7], T[11]);
}

struct Obs {
  float X0, X1, X2, u, v, fx, fy, cx, cy;
  float R[9], t[3];
  bool valid;
};

// the plain version's inlier flag of one correspondence under ref_T_world P
__device__ __forceinline__ bool inlier(const float* P, const Obs& o,
                                       float px2) {
  float pr[3], pc[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    pr[i] = __fadd_rn(dot3(P[3 * i], P[3 * i + 1], P[3 * i + 2], o.X0, o.X1,
                           o.X2),
                      P[9 + i]);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    pc[i] = __fadd_rn(dot3(o.R[3 * i], o.R[3 * i + 1], o.R[3 * i + 2], pr[0],
                           pr[1], pr[2]),
                      o.t[i]);
  const bool good = pc[2] > 0.05f;
  const float zs = good ? pc[2] : 1.0f;
  const float u = __fadd_rn(__fmul_rn(__fdiv_rn(pc[0], zs), o.fx), o.cx);
  const float v = __fadd_rn(__fmul_rn(__fdiv_rn(pc[1], zs), o.fy), o.cy);
  const float du = __fsub_rn(u, o.u);
  const float dv = __fsub_rn(v, o.v);
  const float e2 = __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv));
  return good && e2 < px2 && o.valid;
}

// The tiles of a launch: GW warps across 32-correspondence groups (MT = 32
// GW), 4 / GW hypotheses at a time, J of them a warp (HT = 4 / GW J).
struct Plan {
  int gw, j, mt, ht, nmt, nkt;
};

Plan plan(int K, int M) {
  Plan p;
  const int hl = K >= 4 ? 4 : (K >= 2 ? 2 : 1);
  p.gw = WARPS / hl;
  p.mt = 32 * p.gw;
  p.nmt = M > 0 ? (M + p.mt - 1) / p.mt : 1;
  const long long want = static_cast<long long>(hl) * TARGET_BLOCKS;
  long long j = (static_cast<long long>(K) * p.nmt + want - 1) / want;
  j = j < 1 ? 1 : j;
  j = j > HT_MAX / hl ? HT_MAX / hl : j;
  j = j > (K + hl - 1) / hl ? (K + hl - 1) / hl : j;
  p.j = static_cast<int>(j);
  p.ht = hl * p.j;
  p.nkt = (K + p.ht - 1) / p.ht;
  return p;
}

__global__ void __launch_bounds__(THREADS)
    ransac_score_kernel(const float* __restrict__ hyp,
                        const float* __restrict__ X,
                        const float* __restrict__ uv,
                        const float* __restrict__ cTr,
                        const float* __restrict__ f,
                        const uint8_t* __restrict__ mask, int K, int M,
                        int gw, int j, float px2,
                        long long* __restrict__ counts,
                        long long* __restrict__ best_idx,
                        float* __restrict__ best_pose,
                        int* __restrict__ best_n,
                        uint8_t* __restrict__ best_inl,
                        unsigned* __restrict__ rows, int* __restrict__ acc) {
  __shared__ float4 s_T[MT_MAX * 4];
  __shared__ float4 s_f[MT_MAX];
  __shared__ float s_X[MT_MAX * 3];
  __shared__ float s_uv[MT_MAX * 2];
  __shared__ uint8_t s_mask[MT_MAX];
  __shared__ __align__(16) float s_pose[HT_MAX][12];
  __shared__ unsigned long long s_key[WARPS];
  __shared__ int s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hl = WARPS / gw, mt = 32 * gw, ht = hl * j;
  const int m0 = blockIdx.x * mt, k0 = blockIdx.y * ht;
  const int W = (M + 31) >> 5;  // words of a bit row
  const int n = min(mt, M - m0);  // correspondences of the tile

  // 1. stage the tile (coalesced copies; cTr and f 16-byte aligned) and
  // the poses
  const float4* T4 = reinterpret_cast<const float4*>(cTr) + 4LL * m0;
  const float4* f4 = reinterpret_cast<const float4*>(f) + m0;
  for (int e = tid; e < 4 * n; e += THREADS) cp_async16(s_T + e, T4 + e);
  for (int e = tid; e < n; e += THREADS) cp_async16(s_f + e, f4 + e);
  for (int e = tid; e < 3 * n; e += THREADS)
    cp_async4(s_X + e, X + 3LL * m0 + e);
  for (int e = tid; e < 2 * n; e += THREADS)
    cp_async4(s_uv + e, uv + 2LL * m0 + e);
  if (tid < n) s_mask[tid] = __ldg(mask + m0 + tid);
  if (tid < ht && k0 + tid < K) invert(hyp + 16LL * (k0 + tid), s_pose[tid]);
  cp_async_wait_all();
  __syncthreads();  // the tile and the poses staged

  // 2. lane l scores correspondence m against the warp's hypotheses
  const int g = warp % gw, h = warp / gw;
  const int ml = 32 * g + lane;
  const int word = (m0 >> 5) + g;
  Obs o;
  {
    const float4 r0 = s_T[4 * ml], r1 = s_T[4 * ml + 1], r2 = s_T[4 * ml + 2];
    const float4 fv = s_f[ml];
    o.R[0] = r0.x; o.R[1] = r0.y; o.R[2] = r0.z; o.t[0] = r0.w;
    o.R[3] = r1.x; o.R[4] = r1.y; o.R[5] = r1.z; o.t[1] = r1.w;
    o.R[6] = r2.x; o.R[7] = r2.y; o.R[8] = r2.z; o.t[2] = r2.w;
    o.fx = fv.x; o.fy = fv.y; o.cx = fv.z; o.cy = fv.w;
    o.X0 = s_X[3 * ml];
    o.X1 = s_X[3 * ml + 1];
    o.X2 = s_X[3 * ml + 2];
    o.u = s_uv[2 * ml];
    o.v = s_uv[2 * ml + 1];
    o.valid = ml < n && s_mask[ml] != 0;  // past M: never an inlier
  }
  if (word < W) {
    // lane i keeps the word of the warp's i-th hypothesis (j <= 16), and
    // the J words and counts go out in one store and one atomic each
    unsigned mine = 0;
    int n_h = 0;
    for (int i = 0; i < j; ++i) {
      const int hh = h + i * hl;
      if (k0 + hh >= K) break;
      // the pose by three 16-byte shared loads
      const float4* q = reinterpret_cast<const float4*>(s_pose[hh]);
      const float4 q0 = q[0], q1 = q[1], q2 = q[2];
      const float P[12] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y,
                           q1.z, q1.w, q2.x, q2.y, q2.z, q2.w};
      const unsigned b = __ballot_sync(FULL, inlier(P, o, px2));
      mine = lane == i ? b : mine;
      n_h = i + 1;
    }
    if (lane < n_h) {
      const int k = k0 + h + lane * hl;
      rows[static_cast<long long>(k) * W + word] = mine;
      if (mine) atomicAdd(acc + k, __popc(mine));
    }
  }
  __syncthreads();  // the block's rows and counts issued
  const int blocks = static_cast<int>(gridDim.x * gridDim.y);
  if (tid == 0) s_last = add_acq_rel(acc + K) == blocks - 1;
  __syncthreads();
  if (!s_last) return;

  // 3. the last block: the counts, the first index of the largest
  unsigned long long key = 0;
  for (int k0 = tid; k0 < K; k0 += 4 * THREADS) {
    int c[4];  // four reads in flight (each also puts its count back to 0)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      c[u] = k0 + u * THREADS < K ? atomicExch(acc + k0 + u * THREADS, 0) : 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + u * THREADS;
      if (k < K) {
        counts[k] = c[u];
        const unsigned long long kk =
            (static_cast<unsigned long long>(c[u]) << 32) | (0xffffffffu - k);
        key = kk > key ? kk : key;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long v = __shfl_xor_sync(FULL, key, off);
    key = v > key ? v : key;
  }
  if (lane == 0) s_key[warp] = key;
  __syncthreads();
  if (tid == 0) {
    unsigned long long best = s_key[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) best = s_key[w] > best ? s_key[w] : best;
    const int b = static_cast<int>(0xffffffffu - (best & 0xffffffffu));
    *best_idx = b;
    *best_n = static_cast<int>(best >> 32);
    s_key[0] = b;
    acc[K] = 0;
  }
  __syncthreads();  // the winner known
  const int b = static_cast<int>(s_key[0]);
  if (tid < 16) best_pose[tid] = hyp[16LL * b + tid];
  // the winner's row: 16 flags a thread, one 16-byte store where aligned
  const unsigned* row = rows + static_cast<long long>(b) * W;
  const bool vec = (reinterpret_cast<uintptr_t>(best_inl) & 15) == 0;
  for (int q = tid; 16 * q < M; q += THREADS) {
    const unsigned bits = __ldcg(row + (q >> 1)) >> (16 * (q & 1));
    const int m = 16 * q;
    if (vec && m + 16 <= M) {
      *reinterpret_cast<uint4*>(best_inl + m) =
          make_uint4(expand4(bits), expand4(bits >> 4), expand4(bits >> 8),
                     expand4(bits >> 12));
    } else {
      for (int e = 0; e < 16 && m + e < M; ++e)
        best_inl[m + e] = bits >> e & 1u;
    }
  }
  // end of the last block
}

}  // namespace

// hyp (K, 4, 4), X (M, 3), uv (M, 2), cTr (M, 4, 4), f (M, 4) float32,
// mask (M,) bool, all contiguous (cTr and f 16-byte aligned) -> counts (K,)
// int64, best_idx (1,) int64, best_pose (4, 4) float32, best_n (1,) int32,
// best_inl (M,) bool. rows: (K, ceil(M / 32)) uint32 scratch, the bit rows.
// acc: K + 1 ints (the counts, then the arrival counter), zero at the call,
// zero again after it.
extern "C" int mc_ransac_score(const void* hyp, const void* X, const void* uv,
                               const void* cTr, const void* f,
                               const void* mask, void* counts, void* best_idx,
                               void* best_pose, void* best_n, void* best_inl,
                               void* rows, void* acc, int K, int M, float px2,
                               void* stream) {
  if (K < 1 || M < 0 || (reinterpret_cast<uintptr_t>(cTr) & 15) ||
      (reinterpret_cast<uintptr_t>(f) & 15))
    return cudaErrorInvalidValue;
  const Plan p = plan(K, M);
  if (p.nkt > 65535) return cudaErrorInvalidValue;
  ransac_score_kernel<<<dim3(p.nmt, p.nkt), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hyp), static_cast<const float*>(X),
      static_cast<const float*>(uv), static_cast<const float*>(cTr),
      static_cast<const float*>(f), static_cast<const uint8_t*>(mask), K, M,
      p.gw, p.j, px2, static_cast<long long*>(counts),
      static_cast<long long*>(best_idx), static_cast<float*>(best_pose),
      static_cast<int*>(best_n), static_cast<uint8_t*>(best_inl),
      static_cast<unsigned*>(rows), static_cast<int*>(acc));
  return static_cast<int>(cudaGetLastError());
}
