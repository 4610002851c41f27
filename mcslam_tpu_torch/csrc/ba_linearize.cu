// Window-BA linearization of a keyframe-blocked observation table.
//
// Replaces: mcslam_tpu/ops/ba_pallas.py linearize_payload_pallas
// (_linpay_kernel), the math of backend/ba.py
// _residuals_and_jacobians_blocked plus the payload / Hpp / gp assembly of
// _assemble(kf_blocked=True).
//
// Computes, for every observation o = k * Ok + i of keyframe k: the
// reprojection residual r (2) of landmark lm_pos[obs_lm[o]] seen by rig
// camera obs_cam[o] from keyframe pose ref_T_world = rTw12[k] (z clamped
// at 1e-3), the analytic pose Jacobian Jp (2x6, right retraction:
// dq/domega = hat(q), dq/dv = -I) and landmark Jacobian Jl (2x3), the
// weight w = huber(|r|) / max(sigma2, 1e-6) * validf, the 30-channel
// payload [W = w Jp^T Jl (6x3 row-major) | Hll = w Jl^T Jl (3x3) |
// gl = w Jl^T r (3)] written channel-major as (K, 30, Ok), and per
// keyframe the sums Hpp = sum w Jp^T Jp (the 21 upper-triangle entries,
// mirrored, so it is exactly symmetric) and gp = sum w Jp^T r.
//
// Bound on the card: launch and latency. At the stage C shape (K = 6,
// Ok = 1365, C = 4) the kernel reads ~50 B and writes ~130 B per
// observation, ~1.5 MB in all, a fraction of a microsecond of HBM time,
// and ~1 MFLOP: below the latency of one launch. What a call costs is the
// chain of dependent steps of one observation (obs_lm -> lm_pos ->
// arithmetic -> stores) plus the reduction of the 27 per-keyframe sums,
// so the design keeps that chain short and runs it once:
//  - ONE launch per linearization: one thread-block cluster of CLUSTER
//    CTAs per keyframe (grid = K x CLUSTER), THREADS threads each. The
//    keyframe's observations are strided over the cluster's
//    CLUSTER x THREADS threads (2048: the stage C keyframe is one
//    observation per thread; the two-view init pair's 8192 four), so
//    every Ok is served by the same launch.
//  - Each thread reads its camera row and the keyframe pose from the
//    small rig tables in global memory (cached; no shared-memory fill or
//    barrier delays the observation loads) and gathers its own landmark
//    row; the payload goes straight to the layout the landmark one-hot
//    product consumes, consecutive threads on consecutive observations
//    (coalesced).
//  - The 27 sums: per thread over its observations in order, a
//    reduce-scatter in each warp (31 shuffles where a butterfly of the 27
//    values takes 135), the warps in index order, and each CTA's vector
//    written into rank 0's shared memory through distributed shared
//    memory; after the one cluster.sync() rank 0 adds them in rank order
//    and writes Hpp (mirrored) and gp, and the other CTAs are done. No
//    partials buffer, no second kernel and no float atomics: the result
//    is bitwise the same from run to run, which the LM's accept/reject on
//    costs depends on.
//  - Built with -fmad=false (_build.SOURCE_FLAGS): every multiply and add
//    is rounded on its own, in the order of the plain version
//    (ops/ba_cuda.ba_linearize_reference), so the per-observation outputs
//    do not move by contraction into FMAs, which the Jacobians' cancelling
//    differences would amplify.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;  // CTAs per keyframe (the portable cluster size)
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int NPAY = 30;   // payload channels
constexpr int NSUM = 27;   // 21 Hpp upper triangle + 6 gp

// One level of the warp reduce-scatter: the lane keeps v[j + H] (its lane
// bit H set) or v[j], and adds its partner's copy of the same value.
template <int H>
__device__ __forceinline__ void scatter_level(float (&v)[32], int lane) {
  const bool up = lane & H;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float send = up ? v[j] : v[j + H];
    const float keep = up ? v[j + H] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
linearize_kernel(const float* __restrict__ rTw12, const float* __restrict__ lm_pos,
                 const int* __restrict__ obs_lm, const int* __restrict__ obs_cam,
                 const float* __restrict__ uv, const float* __restrict__ sigma2,
                 const float* __restrict__ validf, const float* __restrict__ Rc9,
                 const float* __restrict__ tc3, const float* __restrict__ f4,
                 float* __restrict__ payload, float* __restrict__ r_out,
                 float* __restrict__ w_out, float* __restrict__ Hpp,
                 float* __restrict__ gp, int Ok, int L, int C, float huber) {
  __shared__ float s_red[NWARPS][NSUM];
  __shared__ float s_cta[CLUSTER][NSUM];  // rank 0's: every CTA's sums

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  // a cluster barrier split around the work: every CTA of the cluster has
  // started (so rank 0's shared memory exists) before any writes into it
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  const int tid = threadIdx.x;
  const int k = blockIdx.x / CLUSTER;

  float acc[NSUM];
#pragma unroll
  for (int v = 0; v < NSUM; ++v) acc[v] = 0.0f;

  // the pose and rig rows straight from global memory (a few hundred
  // bytes, cached): no shared-memory fill and barrier ahead of the
  // observation loads
  const float* __restrict__ pose = rTw12 + 12 * k;  // ref_T_world [R | t]
  const float* __restrict__ R = pose;
  for (int i_loc = rank * THREADS + tid; i_loc < Ok; i_loc += CLUSTER * THREADS) {
    const size_t o = (size_t)k * Ok + i_loc;
    const int l = min(max(obs_lm[o], 0), L - 1);
    const int c = min(max(obs_cam[o], 0), C - 1);
    const float X0 = lm_pos[3 * (size_t)l + 0];
    const float X1 = lm_pos[3 * (size_t)l + 1];
    const float X2 = lm_pos[3 * (size_t)l + 2];
    float q[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      q[a] = R[3 * a] * X0 + R[3 * a + 1] * X1 + R[3 * a + 2] * X2 + pose[9 + a];
    const float* __restrict__ Rc = Rc9 + 9 * c;
    float p[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      p[a] = Rc[3 * a] * q[0] + Rc[3 * a + 1] * q[1] + Rc[3 * a + 2] * q[2] + tc3[3 * c + a];
    const float fx = f4[4 * c], fy = f4[4 * c + 1];
    const float cx = f4[4 * c + 2], cy = f4[4 * c + 3];
    const float inv_z = 1.0f / fmaxf(p[2], 1e-3f);
    const float r0 = p[0] * inv_z * fx + cx - uv[2 * o];
    const float r1 = p[1] * inv_z * fy + cy - uv[2 * o + 1];

    // A = Jproj Rc (2x3)
    const float jp00 = fx * inv_z, jp02 = -fx * p[0] * inv_z * inv_z;
    const float jp11 = fy * inv_z, jp12 = -fy * p[1] * inv_z * inv_z;
    float A[2][3];
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      A[0][b] = jp00 * Rc[b] + jp02 * Rc[6 + b];
      A[1][b] = jp11 * Rc[3 + b] + jp12 * Rc[6 + b];
    }
    // Jp = [A hat(q) | -A], Jl = A R
    float Jp[2][6], Jl[2][3];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      Jp[a][0] = A[a][1] * q[2] - A[a][2] * q[1];
      Jp[a][1] = -A[a][0] * q[2] + A[a][2] * q[0];
      Jp[a][2] = A[a][0] * q[1] - A[a][1] * q[0];
      Jp[a][3] = -A[a][0];
      Jp[a][4] = -A[a][1];
      Jp[a][5] = -A[a][2];
#pragma unroll
      for (int cc = 0; cc < 3; ++cc)
        Jl[a][cc] = A[a][0] * R[cc] + A[a][1] * R[3 + cc] + A[a][2] * R[6 + cc];
    }
    const float rn = sqrtf(r0 * r0 + r1 * r1);
    // huber * (1 / x): the plain version's `huber / tensor` rounds so
    const float wh = rn <= huber ? 1.0f : huber * (1.0f / fmaxf(rn, 1e-9f));
    const float w = wh / fmaxf(sigma2[o], 1e-6f) * validf[o];

    float* pay = payload + (size_t)k * NPAY * Ok + i_loc;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float a0 = w * Jp[0][i], a1 = w * Jp[1][i];
#pragma unroll
      for (int j = 0; j < 3; ++j) pay[(size_t)(3 * i + j) * Ok] = a0 * Jl[0][j] + a1 * Jl[1][j];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float a0 = w * Jl[0][i], a1 = w * Jl[1][i];
#pragma unroll
      for (int j = 0; j < 3; ++j) pay[(size_t)(18 + 3 * i + j) * Ok] = a0 * Jl[0][j] + a1 * Jl[1][j];
    }
    const float wr0 = w * r0, wr1 = w * r1;
#pragma unroll
    for (int i = 0; i < 3; ++i) pay[(size_t)(27 + i) * Ok] = wr0 * Jl[0][i] + wr1 * Jl[1][i];
    r_out[2 * o] = r0;
    r_out[2 * o + 1] = r1;
    w_out[o] = w;

    int v = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float a0 = w * Jp[0][i], a1 = w * Jp[1][i];
#pragma unroll
      for (int j = i; j < 6; ++j) acc[v++] += a0 * Jp[0][j] + a1 * Jp[1][j];
      acc[21 + i] += a0 * r0 + a1 * r1;
    }
  }

  // fixed-order CTA reduction. In each warp a reduce-scatter over the 27
  // sums (padded to 32): at each xor offset a lane keeps the half of its
  // values that its lane bit selects and sends the other half, so after
  // 16 + 8 + 4 + 2 + 1 shuffles lane l holds the warp's sum of value l.
  const int lane = tid & 31, warp = tid >> 5;
  float v[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) v[j] = j < NSUM ? acc[j] : 0.0f;
  // one level per offset, written out: a `h >>= 1` loop leaves v in
  // local memory
  scatter_level<16>(v, lane);
  scatter_level<8>(v, lane);
  scatter_level<4>(v, lane);
  scatter_level<2>(v, lane);
  scatter_level<1>(v, lane);
  if (lane < NSUM) s_red[warp][lane] = v[0];
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  // the warps in index order, and each CTA's vector pushed into rank 0's
  // shared memory (slot = rank) before the one cluster barrier
  if (tid < NSUM) {
    float sum = s_red[0][tid];
#pragma unroll
    for (int wi = 1; wi < NWARPS; ++wi) sum += s_red[wi][tid];
    *cluster.map_shared_rank(&s_cta[rank][tid], 0) = sum;
  }
  cluster.sync();
  if (rank != 0 || tid >= NSUM) return;
  float sum = s_cta[0][tid];
#pragma unroll
  for (int q = 1; q < CLUSTER; ++q) sum += s_cta[q][tid];
  if (tid >= 21) {
    gp[k * 6 + (tid - 21)] = sum;
    return;
  }
  int i = 0, rem = tid;
  while (rem >= 6 - i) {
    rem -= 6 - i;
    ++i;
  }
  const int j = i + rem;
  Hpp[k * 36 + 6 * i + j] = sum;
  Hpp[k * 36 + 6 * j + i] = sum;
}

}  // namespace

extern "C" int mc_ba_linearize_cluster() { return CLUSTER; }

extern "C" int mc_ba_linearize(const float* rTw12, const float* lm_pos,
                               const int* obs_lm, const int* obs_cam,
                               const float* uv, const float* sigma2,
                               const float* validf, const float* Rc9,
                               const float* tc3, const float* f4,
                               float* payload, float* r, float* w, float* Hpp,
                               float* gp, int K, int Ok, int L, int C,
                               float huber, void* stream) {
  if (K == 0) return 0;
  if (C < 1 || L < 1 || Ok < 0) return (int)cudaErrorInvalidValue;
  linearize_kernel<<<K * CLUSTER, THREADS, 0, (cudaStream_t)stream>>>(
      rTw12, lm_pos, obs_lm, obs_cam, uv, sigma2, validf, Rc9, tc3, f4,
      payload, r, w, Hpp, gp, Ok, L, C, huber);
  return (int)cudaGetLastError();
}
