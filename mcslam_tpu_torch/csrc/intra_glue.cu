// The frame build's glue around the intra pair match and before the
// triangulation, as three kernels of one launch each: the Sampson gate of
// every camera pair (intra_gate), the feature groups from the parent table
// with their stable top-k (intra_groups) and the triangulation's gathers
// (tri_gather).
//
// Replaces: the TPU-shaped code that XLA fuses around the intra match and
// the triangulation inside the JAX package's jitted frame build,
// mcslam_tpu/frontend/intra.py intra_match (:68; the normalized coordinates
// :82-86, sampson_gate :47-65 per pair, the pointer jumping :150-152, the
// roots :155-156, the dense group table :163-172, the priority and
// lax.top_k :175-181, the ray table and the padding :183-199) and
// mcslam_tpu/frontend/frame.py _triangulate_stage (:91-122: the pixel and
// sigma gathers, the anchor, the ray counts). No Pallas kernel corresponds
// to them. In the port their plain versions are frontend/intra_cuda.
// *_reference, ~180 tensor ops a frame op by op; these are three launches.
//
// Computes what the plain versions compute, in their order of operations:
//  - intra_gate: for the P = C (C - 1) / 2 pairs (i, j), i < j, in the
//    order (0, 1), (0, 2), ..., (C - 2, C - 1), the normalized coordinates
//    x = (xy - c) / f (IEEE division) of both cameras, and under the pair's
//    essential matrix E (row-major) per column b the epipolar line
//    Exj_k = (E[k][0] xj0 + E[k][1] xj1) + E[k][2], per row a
//    Ethi_k = (xi0 E[0][k] + xi1 E[1][k]) + E[2][k], and per cell
//    t = (xi0 Exj_0 + xi1 Exj_1) + Exj_2, den = ((Exj_0^2 + Exj_1^2) +
//    Ethi_0^2) + Ethi_1^2 clamped below at 1e-12 (a NaN passes, as
//    torch.clamp lets it), gate = t^2 / den < thr^2 (IEEE division);
//  - intra_groups: each feature's root, the parent table applied 8 times
//    (three pointer jumps, 2^3 >= C hops); is_root = root == self & valid;
//    the ray table table[c][r] = the largest feature index of camera c
//    whose root is r among the valid ones, else -1; n_rays[r] = the cameras
//    with a ray; priority = is_root ? float(n_rays) 1e3 + response : -1;
//    the k = min(max_out, C N) largest priorities, ties to the lowest index
//    (torch.sort stable and descending, lax.top_k's rule; -0 equal to 0 and
//    NaN above everything, as torch orders them); out_valid = priority > 0,
//    ray_idx = out_valid ? table[:, index] : -1, desc = desc[index]; slots
//    k .. max_out - 1 padded with -1, 0 and false;
//  - tri_gather: per group m and camera c, ray_valid = ray_idx >= 0, the
//    pixel xy[c][max(idx, 0)] and sigma = sqrt(sigma2[c][max(idx, 0)])
//    correctly rounded (__fsqrt_rn); multi = (rays >= 2); mask = ray_valid &
//    multi; the anchor camera, the first with a ray (0 without one), its
//    pixel and sigma2; n_rays; multi & valid.
//
// Bit for bit: built with -fmad=false (_build.SOURCE_FLAGS), so every
// product and sum rounds on its own, as torch's elementwise kernels round
// them; the plain gate writes its three-term dots out in the order above
// (no `@`, whose order on cuBLAS and CPU BLAS cannot be repeated); the
// groups and gathers are integers, selects and copies; so each output
// equals its plain version's on the card. A parent outside the table or
// a ray index past the features is clamped into range here (the plain
// version raises on it).
//
// Bound on the card: intra_gate by bytes, the (P, N, N) gate it writes
// (3.54 MB at C = 4, N = 768: 1.1 us at 3.35 TB/s; ~15 float32 operations
// a cell take 0.8 us at 67 TFLOP/s); intra_groups by latency: C N = 3072
// features at the frame's shape, ~0.3 MB of traffic; tri_gather by launch
// latency (~0.2 MB). Split by scripts/intra_glue_variants.py. Design:
//  - intra_gate: a block per (32 columns, 96 rows, pair) of 128 threads,
//    8 column quads x 16 row lanes, each thread 4 adjacent columns of 6
//    rows (a warp stores 4 rows of 32 bytes, one 32-bit store per row where
//    N % 4 == 0): the block's column terms (Exj, Exj_0^2 + Exj_1^2) and row
//    terms (xi, Ethi^2) made once each, by one thread each, into shared
//    memory. No division in a cell: RN(a / b) < thr2 is decided by a <
//    RN(tlo b) (true) or a >= RN(thi b) (false), tlo, thi = RN(thr2 (1 -+
//    2^-20)); each of those roundings errs by at most 2^-24 relative, so a
//    decided cell has a / b more than 2^-21 thr2 below pred(thr2) or above
//    thr2, where RN, monotone, keeps the division's answer (for thr2
//    in [2^-60, 2^60], so that tlo b and thi b, b >= 1e-12, are normal or
//    overflow: an overflowed bound is inf, which only an infinite a meets,
//    and then a / b is inf or NaN: false, as decided). A row of four cells
//    with one left undecided (within that margin, NaN, or every cell for
//    another thr2) takes the IEEE division, __fdiv_rn(a, b) < thr2;
//  - intra_groups: a block of 1024 threads per slice of 32 keys (96 blocks
//    at the frame's shape), each block all in shared memory and none
//    waiting for another: it loads the parents, the validity and the
//    responses, makes every feature's root by 8 hops (four chains a thread
//    side by side), a camera bitmask per root (shared atomicOr: n_rays is
//    its popcount) and the ray table of its slice's roots only (shared
//    atomicMax), the keys of all C N features (the descending priority's
//    32 bits; with the index, ~ordered(priority) << 32 | index, they are
//    unique), then ranks its 32 keys against all of them (a lane a key,
//    each warp a 1/32 of the others: the count of keys before a key is its
//    slot, with the ties by index) and writes the slots below k; slots k ..
//    max_out - 1 are padded by all blocks, strided;
//  - tri_gather: a lane per ray (group m, camera c), 128 threads a block:
//    a warp holds G = 32 / min(C, 32) whole groups of min(C, 32) lanes
//    (64 blocks at C = 4, M = 2048), lane q of a group the cameras q, q +
//    32, ... (one for C <= 32), so its loads of ray_idx and its stores of
//    uv (8 bytes a lane), sigma and mask are contiguous runs across the
//    warp. The group's ray count is the popcount of a ballot masked to its
//    lanes, its anchor the ballot's first lane; the anchor's pixel and
//    sigma^2 come by a shuffle from that lane, the values of its own
//    gather (the same loads the plain version's second gather reads), so
//    no second gather round; the group's outputs go out from its first
//    lane, a warp's in one run each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GATE_QUADS = 8;   // column quads of a gate block
constexpr int GATE_LANES = 16;  // row lanes of a gate block
constexpr int GATE_RPT = 6;     // rows of a gate thread
constexpr int GATE_THREADS = GATE_QUADS * GATE_LANES;
constexpr int GATE_COLS = 4 * GATE_QUADS;         // columns of a gate block
constexpr int GATE_ROWS = GATE_LANES * GATE_RPT;  // rows of a gate block
constexpr int GROUP_THREADS = 1024;
constexpr int GROUP_WARPS = GROUP_THREADS / 32;
constexpr int GROUP_SLICE = 32;  // keys a groups block ranks: a lane each
constexpr int MAX_KEYS = 16384;  // C N of intra_groups (intra_cuda)
constexpr int MAX_CAMERAS = 32;  // C of intra_groups: a bitmask per root
constexpr int GATHER_THREADS = 128;
constexpr int GATHER_WARPS = GATHER_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// pair p of camera_pairs(C) -> (i, j)
__device__ __forceinline__ void pair_of(int p, int C, int& i, int& j) {
  i = 0;
  while (p >= C - 1 - i) {
    p -= C - 1 - i;
    ++i;
  }
  j = i + 1 + p;
}

__global__ void __launch_bounds__(GATE_THREADS)
    intra_gate_kernel(const float* __restrict__ xy,
                      const float* __restrict__ fxy,
                      const float* __restrict__ E,
                      const float* __restrict__ thr2p, int C, int N,
                      uint8_t* __restrict__ gate) {
  // per column: Exj_0, Exj_1, Exj_2, Exj_0^2 + Exj_1^2; per row: xi_0,
  // xi_1, Ethi_0^2, Ethi_1^2
  __shared__ float4 s_col[GATE_COLS];
  __shared__ float4 s_row[GATE_ROWS];
  const int p = blockIdx.z, tid = threadIdx.x;
  int ci, cj;
  pair_of(p, C, ci, cj);
  const float* e = E + 9 * p;
  const int c0 = blockIdx.x * GATE_COLS, r0 = blockIdx.y * GATE_ROWS;
  for (int u = tid; u < GATE_COLS + GATE_ROWS; u += GATE_THREADS) {
    if (u < GATE_COLS) {
      const int n = cj * N + min(c0 + u, N - 1);
      const float y0 = __fdiv_rn(xy[2 * n] - fxy[4 * cj + 2], fxy[4 * cj]);
      const float y1 = __fdiv_rn(xy[2 * n + 1] - fxy[4 * cj + 3],
                                 fxy[4 * cj + 1]);
      const float b0 = (e[0] * y0 + e[1] * y1) + e[2];
      const float b1 = (e[3] * y0 + e[4] * y1) + e[5];
      const float b2 = (e[6] * y0 + e[7] * y1) + e[8];
      s_col[u] = make_float4(b0, b1, b2, b0 * b0 + b1 * b1);
    } else {
      const int n = ci * N + min(r0 + u - GATE_COLS, N - 1);
      const float x0 = __fdiv_rn(xy[2 * n] - fxy[4 * ci + 2], fxy[4 * ci]);
      const float x1 = __fdiv_rn(xy[2 * n + 1] - fxy[4 * ci + 3],
                                 fxy[4 * ci + 1]);
      const float a0 = (x0 * e[0] + x1 * e[3]) + e[6];
      const float a1 = (x0 * e[1] + x1 * e[4]) + e[7];
      s_row[u - GATE_COLS] = make_float4(x0, x1, a0 * a0, a1 * a1);
    }
  }
  __syncthreads();  // the block's column and row terms made
  const int quad = tid % GATE_QUADS, lane = tid / GATE_QUADS;
  const int col = c0 + 4 * quad;
  if (col >= N) return;
  float b0[4], b1[4], b2[4], pre[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 v = s_col[4 * quad + q];
    b0[q] = v.x;
    b1[q] = v.y;
    b2[q] = v.z;
    pre[q] = v.w;
  }
  // the margins of the decided cells (see the header)
  const float thr2 = *thr2p;
  const bool margins = thr2 >= 0x1p-60f && thr2 <= 0x1p60f;
  const float tlo = margins ? thr2 * (1.0f - 0x1p-20f) : -1.0f;
  const float thi = margins ? thr2 * (1.0f + 0x1p-20f) : __int_as_float(
                                                              0x7f800000);
  const int rl = r0 + lane;  // the thread's first row
  uint8_t* out = gate + ((size_t)p * N + rl) * N + col;
  const size_t step = (size_t)GATE_LANES * N;
  const bool words = (N & 3) == 0;
#pragma unroll
  for (int s = 0; s < GATE_RPT; ++s) {
    if (rl + GATE_LANES * s >= N) break;
    const float4 x = s_row[lane + GATE_LANES * s];
    float num[4], den[4];
    uint32_t word = 0;
    bool slow = false;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float t = (x.x * b0[q] + x.y * b1[q]) + b2[q];
      float d = (pre[q] + x.z) + x.w;
      d = d < 1e-12f ? 1e-12f : d;
      const float a = t * t;
      const bool below = a < tlo * d, above = a >= thi * d;
      if (below) word |= 1u << (8 * q);
      slow |= !(below || above);
      num[q] = a;
      den[q] = d;
    }
    if (slow) {  // a cell within the margins: the row's four by division
      word = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        word |= (uint32_t)(__fdiv_rn(num[q], den[q]) < thr2) << (8 * q);
    }
    uint8_t* row = out + s * step;
    if (words) {
      *reinterpret_cast<uint32_t*>(row) = word;
    } else {
      for (int q = 0; q < 4 && col + q < N; ++q)
        row[q] = (uint8_t)((word >> (8 * q)) & 1u);
    }
  }
  // end of the gate block
}

// an ascending sort key of the priority's descending order: -0 as 0, every
// NaN as the one NaN above +inf (torch.sort's order)
__device__ __forceinline__ uint32_t descending_bits(float v) {
  uint32_t u = v != v ? 0x7fc00000u : __float_as_uint(v == 0.0f ? 0.0f : v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // ascending in v
  return ~u;
}

__device__ __forceinline__ float priority_of(uint32_t hi) {
  const uint32_t o = ~hi;
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// rank part of a lane's key bi (index i) against keys [j0, j1) of key:
// the keys before it, those below it and, of index below i, those equal
// (MODE 0: every j < i, 1: every j > i, 2: either)
template <int MODE>
__device__ __forceinline__ int rank_part(const uint32_t* __restrict__ key,
                                         int j0, int j1, uint32_t bi,
                                         int i) {
  int n = 0;
  for (int j = j0; j < j1; j += 4) {
    const uint4 b = *reinterpret_cast<const uint4*>(key + j);
    const uint32_t v[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t t = MODE == 0 ? bi + 1u
                         : MODE == 1 ? bi
                                     : (j + q < i ? bi + 1u : bi);
      n += v[q] < t;
    }
  }
  return n;
}

__global__ void __launch_bounds__(GROUP_THREADS, 1)
    intra_groups_kernel(const int* __restrict__ parent,
                        const bool* __restrict__ valid,
                        const float* __restrict__ response,
                        const int* __restrict__ desc, int C, int N, int Kp,
                        int k, int max_out, int* __restrict__ ray_idx,
                        int* __restrict__ out_desc,
                        bool* __restrict__ out_valid) {
  // key: Kp words, the parents, then the camera masks, then the sort keys
  // (past C N: ~0, after every key); root: Kp ints; resp: Kp responses;
  // table: the slice's ray table, GROUP_SLICE x C; part: GROUP_WARPS x
  // GROUP_SLICE partial ranks; rank: GROUP_SLICE slots; flag: Kp valid
  // flags
  extern __shared__ uint4 smem[];
  uint32_t* key = reinterpret_cast<uint32_t*>(smem);
  int* root = reinterpret_cast<int*>(key + Kp);
  float* resp = reinterpret_cast<float*>(root + Kp);
  int* table = reinterpret_cast<int*>(resp + Kp);
  int* part = table + GROUP_SLICE * C;
  int* rank = part + GROUP_WARPS * GROUP_SLICE;
  uint8_t* flag = reinterpret_cast<uint8_t*>(rank + GROUP_SLICE);
  const int K = C * N, T = GROUP_THREADS, tid = threadIdx.x;
  const int s0 = blockIdx.x * GROUP_SLICE;
  for (int f = tid; f < K; f += T) {
    key[f] = (uint32_t)clampi(parent[f], 0, K - 1);
    flag[f] = valid[f];
    resp[f] = response[f];
  }
  for (int t = tid; t < GROUP_SLICE * C; t += T) table[t] = -1;
  __syncthreads();  // the parents loaded
  for (int f0 = tid; f0 < K; f0 += 4 * T) {  // four chains side by side
    int x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) x[u] = min(f0 + u * T, K - 1);
#pragma unroll
    for (int h = 0; h < 8; ++h) {
#pragma unroll
      for (int u = 0; u < 4; ++u) x[u] = (int)key[x[u]];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (f0 + u * T < K) root[f0 + u * T] = x[u];
  }
  __syncthreads();  // the roots made
  for (int f = tid; f < Kp; f += T) key[f] = 0u;
  __syncthreads();
  for (int f = tid; f < K; f += T) {
    if (!flag[f]) continue;
    const int cam = f / N, r = root[f];
    atomicOr(&key[r], 1u << cam);
    if ((unsigned)(r - s0) < (unsigned)GROUP_SLICE)
      atomicMax(&table[(r - s0) * C + cam], f - cam * N);
  }
  __syncthreads();  // the masks and the slice's ray table made
  for (int r = tid; r < Kp; r += T) {
    uint32_t b = ~0u;
    if (r < K) {
      const float prio = root[r] == r && flag[r]
                             ? (float)__popc(key[r]) * 1e3f + resp[r]
                             : -1.0f;
      b = descending_bits(prio);
    }
    key[r] = b;
  }
  __syncthreads();  // the keys made
  const int lane = tid & 31, warp = tid >> 5;
  const int i = s0 + lane;
  const uint32_t bi = key[min(i, Kp - 1)];
  const int chunk = Kp / GROUP_WARPS;
  const int j0 = warp * chunk, j1 = j0 + chunk;
  part[warp * GROUP_SLICE + lane] =
      j1 <= s0                 ? rank_part<0>(key, j0, j1, bi, i)
      : j0 >= s0 + GROUP_SLICE ? rank_part<1>(key, j0, j1, bi, i)
                               : rank_part<2>(key, j0, j1, bi, i);
  __syncthreads();  // the partial ranks counted
  if (tid < GROUP_SLICE) {
    int n = 0;
    for (int w = 0; w < GROUP_WARPS; ++w) n += part[w * GROUP_SLICE + tid];
    rank[tid] = n;
  }
  __syncthreads();  // the slice's slots known
  for (int t = tid; t < GROUP_SLICE * 8; t += T) {
    const int l = t >> 3, f = s0 + l, m = rank[l];
    if (f < K && m < k) out_desc[8 * m + (t & 7)] = desc[8 * f + (t & 7)];
  }
  for (int t = tid; t < GROUP_SLICE * C; t += T) {
    const int l = t / C, c = t - l * C, f = s0 + l, m = rank[l];
    if (f < K && m < k) {
      const bool ov = priority_of(key[f]) > 0.0f;
      ray_idx[m * C + c] = ov ? table[l * C + c] : -1;
      if (c == 0) out_valid[m] = ov;
    }
  }
  for (int m = k + blockIdx.x * T + tid; m < max_out; m += gridDim.x * T) {
    for (int c = 0; c < C; ++c) ray_idx[m * C + c] = -1;
#pragma unroll
    for (int w = 0; w < 8; ++w) out_desc[8 * m + w] = 0;
    out_valid[m] = false;
  }
  // end of the groups block
}

// a lane per ray: warp w holds the groups [w G, (w + 1) G), G = 32 / CL
// groups of CL = min(C, 32) lanes, lane q of group g the cameras q, q +
// CL, ... (rounds = ceil(C / 32); lanes 32 / CL * CL .. 31 idle)
__global__ void __launch_bounds__(GATHER_THREADS)
    tri_gather_kernel(const int* __restrict__ ray_idx,
                      const bool* __restrict__ gvalid,
                      const float* __restrict__ xy,
                      const float* __restrict__ sigma2, int M, int C, int N,
                      float* __restrict__ uv, float* __restrict__ sigma,
                      bool* __restrict__ mask, int* __restrict__ anchor_cam,
                      float* __restrict__ uv_ref,
                      float* __restrict__ anchor_sigma2,
                      int* __restrict__ n_rays,
                      bool* __restrict__ multi_valid) {
  // the gather block starts
  const int lane = threadIdx.x & 31;
  const int CL = C < 32 ? C : 32, G = 32 / CL, rounds = (C + 31) / 32;
  const int g = lane / CL, q = lane - g * CL, base = g * CL;
  const unsigned gmask = CL == 32 ? FULL : ((1u << CL) - 1u) << base;
  const int m = (blockIdx.x * GATHER_WARPS + (threadIdx.x >> 5)) * G + g;
  const bool live = g < G && m < M;
  const long long r0 = static_cast<long long>(m) * C;
  bool gv = false;
  if (live && q == 0) gv = gvalid[m];
  // the rays: the count and the first camera by ballots over the group's
  // lanes
  int idx0 = -1, n = 0, a = -1;
  for (int r = 0; r < rounds; ++r) {
    const int c = q + r * CL;
    const int idx = live && c < C ? ray_idx[r0 + c] : -1;
    if (r == 0) idx0 = idx;
    const unsigned b = __ballot_sync(FULL, idx >= 0) & gmask;
    if (a < 0 && b) a = r * CL + (__ffs(b) - 1 - base);
    n += __popc(b);
  }
  // the group's rays counted
  const bool multi = n >= 2;
  const int anc = a < 0 ? 0 : a;
  float ax = 0.0f, ay = 0.0f, as2 = 0.0f;
  for (int r = 0; r < rounds; ++r) {
    const int c = q + r * CL;
    float x = 0.0f, y = 0.0f, s2 = 0.0f;
    if (live && c < C) {
      const int idx = r == 0 ? idx0 : ray_idx[r0 + c];
      const long long kp = static_cast<long long>(c) * N +
                           clampi(idx, 0, N - 1);
      x = xy[2 * kp];
      y = xy[2 * kp + 1];
      s2 = sigma2[kp];
      const long long t = r0 + c;
      reinterpret_cast<float2*>(uv)[t] = make_float2(x, y);
      sigma[t] = __fsqrt_rn(s2);
      mask[t] = idx >= 0 && multi;
    }
    // the anchor's pixel and sigma^2 from its own lane's gather
    const int k = anc - r * CL;
    const int src = base + (k < 0 ? 0 : (k >= CL ? CL - 1 : k));
    const float sx = __shfl_sync(FULL, x, src & 31);
    const float sy = __shfl_sync(FULL, y, src & 31);
    const float ss = __shfl_sync(FULL, s2, src & 31);
    if (k >= 0 && k < CL) {
      ax = sx;
      ay = sy;
      as2 = ss;
    }
  }
  // the rays' stores issued
  if (live && q == 0) {
    anchor_cam[m] = anc;
    reinterpret_cast<float2*>(uv_ref)[m] = make_float2(ax, ay);
    anchor_sigma2[m] = as2;
    n_rays[m] = n;
    multi_valid[m] = multi && gv;
  }
  // the gather block ends
}

}  // namespace

// xy (C, N, 2), fxycxy (C, 4), E (P, 3, 3), thr^2 (one float), gate
// (P, N, N) bool, C, N, stream
extern "C" int mc_intra_gate(const void* xy, const void* fxy, const void* E,
                             const void* thr2, void* gate, int C, int N,
                             void* stream) {
  if (C < 2 || N < 1) return cudaErrorInvalidValue;
  const dim3 grid((N + GATE_COLS - 1) / GATE_COLS,
                  (N + GATE_ROWS - 1) / GATE_ROWS, C * (C - 1) / 2);
  intra_gate_kernel<<<grid, GATE_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xy), static_cast<const float*>(fxy),
      static_cast<const float*>(E), static_cast<const float*>(thr2), C, N,
      static_cast<uint8_t*>(gate));
  return static_cast<int>(cudaGetLastError());
}

// parent (C, N) int32, valid (C, N) bool, response (C, N) float32, desc
// (C, N, 8) int32, ray_idx (max_out, C), desc out (max_out, 8), valid out
// (max_out,), C, N, max_out, stream
extern "C" int mc_intra_groups(const void* parent, const void* valid,
                               const void* response, const void* desc,
                               void* ray_idx, void* out_desc, void* out_valid,
                               int C, int N, int max_out, void* stream) {
  const int K = C * N;
  if (C < 1 || C > MAX_CAMERAS || N < 1 || max_out < 1 || K > MAX_KEYS)
    return cudaErrorInvalidValue;
  // the keys padded to whole uint4s of every warp's share
  const int Kp = (K + 4 * GROUP_WARPS - 1) / (4 * GROUP_WARPS) * 4 *
                 GROUP_WARPS;
  const int smem = Kp * 12 + (GROUP_SLICE * C + GROUP_WARPS * GROUP_SLICE +
                              GROUP_SLICE) * 4 + Kp;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        intra_groups_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
  }
  intra_groups_kernel<<<(K + GROUP_SLICE - 1) / GROUP_SLICE, GROUP_THREADS,
                        smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(parent), static_cast<const bool*>(valid),
      static_cast<const float*>(response), static_cast<const int*>(desc), C,
      N, Kp, K < max_out ? K : max_out, max_out, static_cast<int*>(ray_idx),
      static_cast<int*>(out_desc), static_cast<bool*>(out_valid));
  return static_cast<int>(cudaGetLastError());
}

// ray_idx (M, C) int32, valid (M,) bool, xy (C, N, 2), sigma2 (C, N), uv
// (M, C, 2), sigma (M, C), mask (M, C), anchor_cam (M,), uv_ref (M, 2),
// anchor_sigma2 (M,), n_rays (M,), multi & valid (M,), M, C, N, stream;
// uv and uv_ref 8-byte aligned
extern "C" int mc_tri_gather(const void* ray_idx, const void* gvalid,
                             const void* xy, const void* sigma2, void* uv,
                             void* sigma, void* mask, void* anchor_cam,
                             void* uv_ref, void* anchor_sigma2, void* n_rays,
                             void* multi_valid, int M, int C, int N,
                             void* stream) {
  if (M < 0 || C < 1 || N < 1) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(uv) & 7) ||
      (reinterpret_cast<uintptr_t>(uv_ref) & 7))
    return cudaErrorMisalignedAddress;
  if (M == 0) return 0;
  // groups a block: GATHER_WARPS warps of 32 / min(C, 32) groups
  const long long per_block = GATHER_WARPS * (32 / (C < 32 ? C : 32));
  tri_gather_kernel<<<static_cast<unsigned>((M + per_block - 1) / per_block),
                      GATHER_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ray_idx), static_cast<const bool*>(gvalid),
      static_cast<const float*>(xy), static_cast<const float*>(sigma2), M, C,
      N, static_cast<float*>(uv), static_cast<float*>(sigma),
      static_cast<bool*>(mask), static_cast<int*>(anchor_cam),
      static_cast<float*>(uv_ref), static_cast<float*>(anchor_sigma2),
      static_cast<int*>(n_rays), static_cast<bool*>(multi_valid));
  return static_cast<int>(cudaGetLastError());
}
