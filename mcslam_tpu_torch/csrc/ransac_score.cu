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
// Design, 256 threads a block, HB = 4 hypotheses a block:
//  - threads 0-3 invert the block's poses into shared memory; then each
//    thread walks the correspondences m = tid + 256 i, reads each once
//    (21 floats and the mask byte) and scores it against the block's HB
//    hypotheses, keeping HB counts in registers: the correspondences are
//    read K / HB times from L2 in all (128 blocks at K = 512);
//  - the counts are summed by __reduce_add_sync and one shared slot per
//    warp, then written; thread 0 adds one to the arrival counter with
//    release and acquire semantics (atom.add.acq_rel.gpu);
//  - the last block to arrive reads the K counts through L2 (__ldcg),
//    takes the largest, first index on ties, as a 64-bit key (count <<
//    32 | ~index) reduced by warp shuffles, writes the winner's index,
//    pose and count, recomputes the winner's inlier flags with the same
//    code (the same bits as its count), and puts the counter back to
//    zero, so that calls and CUDA graph replays share it;
//  - no local memory: the HB counts and the pose live in registers and
//    shared memory, indexed by constants after unrolling.
// Launches that share the counter must not overlap in time (one stream).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int HB = 4;  // hypotheses a block

// atomicAdd of 1 with release and acquire semantics at device scope (as in
// intra_match.cu): the block's counts, written before a barrier, are seen
// by the last block after its barrier
__device__ __forceinline__ int add_acq_rel(int* p) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
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

__device__ __forceinline__ Obs load_obs(const float* __restrict__ X,
                                        const float* __restrict__ uv,
                                        const float* __restrict__ cTr,
                                        const float* __restrict__ f,
                                        const uint8_t* __restrict__ mask,
                                        int m) {
  Obs o;
  o.X0 = __ldg(X + 3 * m);
  o.X1 = __ldg(X + 3 * m + 1);
  o.X2 = __ldg(X + 3 * m + 2);
  o.u = __ldg(uv + 2 * m);
  o.v = __ldg(uv + 2 * m + 1);
  const float4 fv = __ldg(reinterpret_cast<const float4*>(f) + m);
  o.fx = fv.x;
  o.fy = fv.y;
  o.cx = fv.z;
  o.cy = fv.w;
  const float4* T = reinterpret_cast<const float4*>(cTr) + 4 * m;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float4 row = __ldg(T + i);
    o.R[3 * i] = row.x;
    o.R[3 * i + 1] = row.y;
    o.R[3 * i + 2] = row.z;
    o.t[i] = row.w;
  }
  o.valid = __ldg(mask + m) != 0;
  return o;
}

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

__global__ void __launch_bounds__(THREADS)
    ransac_score_kernel(const float* __restrict__ hyp,
                        const float* __restrict__ X,
                        const float* __restrict__ uv,
                        const float* __restrict__ cTr,
                        const float* __restrict__ f,
                        const uint8_t* __restrict__ mask, int K, int M,
                        float px2, long long* __restrict__ counts,
                        long long* __restrict__ best_idx,
                        float* __restrict__ best_pose,
                        int* __restrict__ best_n,
                        uint8_t* __restrict__ best_inl,
                        int* __restrict__ counter) {
  __shared__ float s_pose[HB][12];
  __shared__ int s_cnt[HB][WARPS];
  __shared__ unsigned long long s_key[WARPS];
  __shared__ int s_last;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.x * HB;
  if (tid < HB && k0 + tid < K) invert(hyp + 16 * (k0 + tid), s_pose[tid]);
  __syncthreads();

  int cnt[HB];
#pragma unroll
  for (int h = 0; h < HB; ++h) cnt[h] = 0;
  for (int m = tid; m < M; m += THREADS) {
    const Obs o = load_obs(X, uv, cTr, f, mask, m);
#pragma unroll
    for (int h = 0; h < HB; ++h)
      if (k0 + h < K) cnt[h] += inlier(s_pose[h], o, px2);
  }
#pragma unroll
  for (int h = 0; h < HB; ++h) {
    const int c = __reduce_add_sync(0xffffffffu, cnt[h]);
    if (lane == 0) s_cnt[h][warp] = c;
  }
  __syncthreads();
  if (tid < HB && k0 + tid < K) {
    int c = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) c += s_cnt[tid][w];
    __stcg(counts + k0 + tid, static_cast<long long>(c));
  }
  __syncthreads();
  if (tid == 0) s_last = add_acq_rel(counter) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;

  // the last block: the first index of the largest count
  unsigned long long key = 0;
  for (int k = tid; k < K; k += THREADS) {
    const unsigned long long c = static_cast<unsigned long long>(
        __ldcg(counts + k));
    const unsigned long long kk = (c << 32) | (0xffffffffu - k);
    key = kk > key ? kk : key;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, key, off);
    key = o > key ? o : key;
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
    invert(hyp + 16 * b, s_pose[0]);
    s_key[0] = b;
    *counter = 0;
  }
  __syncthreads();
  const int b = static_cast<int>(s_key[0]);
  if (tid < 16) best_pose[tid] = hyp[16 * b + tid];
  for (int m = tid; m < M; m += THREADS)
    best_inl[m] = inlier(s_pose[0], load_obs(X, uv, cTr, f, mask, m), px2);
}

}  // namespace

// hyp (K, 4, 4), X (M, 3), uv (M, 2), cTr (M, 4, 4), f (M, 4) float32,
// mask (M,) bool, all contiguous (cTr and f 16-byte aligned) -> counts (K,)
// int64, best_idx (1,) int64, best_pose (4, 4) float32, best_n (1,) int32,
// best_inl (M,) bool. counter: one int, zero at the call, zero again after
// it.
extern "C" int mc_ransac_score(const void* hyp, const void* X, const void* uv,
                               const void* cTr, const void* f,
                               const void* mask, void* counts, void* best_idx,
                               void* best_pose, void* best_n, void* best_inl,
                               void* counter, int K, int M, float px2,
                               void* stream) {
  if (K < 1 || M < 0 || (reinterpret_cast<uintptr_t>(cTr) & 15) ||
      (reinterpret_cast<uintptr_t>(f) & 15))
    return cudaErrorInvalidValue;
  const int blocks = (K + HB - 1) / HB;
  ransac_score_kernel<<<blocks, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hyp), static_cast<const float*>(X),
      static_cast<const float*>(uv), static_cast<const float*>(cTr),
      static_cast<const float*>(f), static_cast<const uint8_t*>(mask), K, M,
      px2, static_cast<long long*>(counts), static_cast<long long*>(best_idx),
      static_cast<float*>(best_pose), static_cast<int*>(best_n),
      static_cast<uint8_t*>(best_inl), static_cast<int*>(counter));
  return static_cast<int>(cudaGetLastError());
}
