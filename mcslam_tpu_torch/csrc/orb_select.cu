// The ORB extraction's global selection: per image the stable top maxb of
// fast_select's per-cell candidates with the slot fields, then per camera
// the merge into level-major slots and the cross-level compaction.
//
// Replaces: the TPU-shaped selection chain of the JAX package's ORB
// extraction, mcslam_tpu/ops/orb.py _select_from_cells (:219, a top_k over
// the candidates), the undo of the rank bonus, the level quota, the EDGE
// margin and the slot metadata (:420-451), the merge and the cross-level
// top_k compaction (:473-494), which XLA fuses on the TPU. No Pallas
// kernel corresponds to them. In the port its plain version is
// ops/orb_cuda.orb_select_reference (two stable sorts, ~60 elementwise,
// merge and gather ops).
//
// Computes, for LC = L C images (level-major: image i = l C + c) of N =
// G * per_cell candidates each (cell raster-major, round-minor):
//  1. per image, the n = min(maxb, N) largest candidates by value, ties to
//     the lowest index (a stable descending sort's first n: topk_stable);
//  2. per slot s < maxb of image i: from candidate k (g = k / per_cell its
//     cell), valid = v > 0, y = (g / ncx) cell + rid / cell and x = (g %
//     ncx) cell + rid % cell where valid, else (0, 0); resp = v - 1 where v
//     > 1 (the rank bonus undone, one float32 subtract), else v; then valid
//     &= s < budget[l] and EDGE <= y < h_l - EDGE and EDGE <= x < w_l -
//     EDGE; slots s >= n are (0, 0), 0, invalid. These go to scratch in
//     camera c's level-major slot j = l maxb + s;
//  3. per camera, over the M = L maxb slots, where M > n_out, the n_out
//     largest prio = valid ? resp + 1000 : -1 (one float32 add), ties to
//     the lower slot; else the slots in order. Output k of camera c is
//     slot j of level l = j / maxb: xy = (x s_l, y s_l) (float32
//     products), the response, octave l, sigma2 = s_l s_l, valid, and
//     patch_gather's flat yx and image index l C + c.
// Keys (value, index) are unique: the value's order-preserving 32 bits
// (-0 as +0, as a sort compares values), then the complemented index. Any
// exact selection of them gives the plain version's result bit for bit.
//
// Bound on the card: latency. The candidates are 0.6 MB at the bench
// shape (16 images x 4800), the outputs ~0.1 MB: well under a microsecond
// of HBM time; what a call costs is the chain of block-wide steps.
// Design, two launches (the selection per image, then the compaction per
// camera), 1024 threads a block, 33 KB of static shared memory:
//  - a block selects its top n by a radix select over the 64-bit keys, 8
//    passes of 8 bits from the top: a shared-memory histogram of the
//    keys that match the digits found so far, then warp 0 scans the 256
//    bins from the top (8 a lane, a shuffle prefix over the lanes) for the
//    digit where the n-th key lies. The keys are recomputed from the
//    inputs in every pass (L1 hits), so no N is too large;
//  - the n keys at or above the n-th are gathered into shared memory
//    (a shared counter) and sorted by a bitonic network over the next
//    power of two (<= 4096, zero keys padding the tail);
//  - the compaction block reads its camera's slots from the scratch the
//    selection launch wrote (the stream orders the two launches).
// Nothing carries over between calls: the call can be captured in a CUDA
// graph and replayed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int CAP = 4096;  // orb_cuda.SELECT_CAP
constexpr int SLOT_INTS = 4;  // y, x, resp bits, valid

typedef unsigned long long u64;

struct Smem {
  u64 keys[CAP];
  unsigned hist[256];
  u64 prefix;
  unsigned remaining;
  unsigned count;
};

// order-preserving bits of a float32 value (-0 as +0)
__device__ __forceinline__ unsigned ordered(float v) {
  unsigned u = v == 0.0f ? 0u : __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ u64 make_key(float v, int i) {
  return ((u64)ordered(v) << 32) | (u64)(0xFFFFFFFFu - (unsigned)i);
}

__device__ __forceinline__ int key_index(u64 k) {
  return (int)(0xFFFFFFFFu - (unsigned)(k & 0xFFFFFFFFu));
}

// The n largest of the N keys key(i) into s.keys[0, n), descending.
template <typename KeyFn>
__device__ void select_top(const KeyFn& key, int N, int n, Smem& s) {
  const int tid = threadIdx.x;
  u64 known = 0;  // the bits of the n-th key found so far
  if (tid == 0) {
    s.prefix = 0;
    s.remaining = (unsigned)n;
    s.count = 0;
  }
  for (int shift = 56; shift >= 0; shift -= 8) {
    if (tid < 256) s.hist[tid] = 0;
    __syncthreads();
    const u64 prefix = s.prefix;
    for (int i = tid; i < N; i += THREADS) {
      const u64 k = key(i);
      if ((k & known) == prefix) atomicAdd(&s.hist[(k >> shift) & 255], 1u);
    }
    __syncthreads();
    if (tid < 32) {
      // lane l holds digits 255 - 8 l - j, j = 0..7, from the top
      unsigned h[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        h[j] = s.hist[255 - 8 * tid - j];
        sum += h[j];
      }
      unsigned incl = sum;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned o = __shfl_up_sync(0xffffffffu, incl, d);
        if (tid >= d) incl += o;
      }
      unsigned cum = incl - sum;
      const unsigned rem = s.remaining;
      int found = -1;
      unsigned left = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (found < 0 && cum < rem && rem <= cum + h[j]) {
          found = 255 - 8 * tid - j;
          left = rem - cum;
        }
        cum += h[j];
      }
      __syncwarp();
      if (found >= 0) {
        s.prefix = prefix | ((u64)found << shift);
        s.remaining = left;
      }
    }
    known |= (u64)255 << shift;
    __syncthreads();
  }
  const u64 nth = s.prefix;
  for (int i = tid; i < N; i += THREADS) {
    const u64 k = key(i);
    if (k >= nth) s.keys[atomicAdd(&s.count, 1u)] = k;
  }
  int P = 1;
  while (P < n) P <<= 1;
  __syncthreads();
  for (int i = n + tid; i < P; i += THREADS) s.keys[i] = 0;
  __syncthreads();
  // bitonic network, descending
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < (P >> 1); t += THREADS) {
        const int lo = 2 * stride * (t / stride) + (t % stride);
        const int hi = lo + stride;
        const u64 a = s.keys[lo], b = s.keys[hi];
        if (((lo & size) == 0) == (a < b)) {
          s.keys[lo] = b;
          s.keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// Per image i = blockIdx.x: its top n candidates and their slot fields,
// into scratch at camera c's slots l maxb + s.
__global__ void __launch_bounds__(THREADS)
orb_select_kernel(const float* __restrict__ cand_v,
                  const int* __restrict__ cand_rid,
                  const int* __restrict__ h_l, const int* __restrict__ w_l,
                  const int* __restrict__ budget, int* __restrict__ scratch,
                  int C, int N, int maxb, int ncx, int cell, int per_cell,
                  int edge) {
  __shared__ Smem s;
  const int img = blockIdx.x;
  const int l = img / C, c = img % C;
  const float* v = cand_v + (long long)img * N;
  const int* rid = cand_rid + (long long)img * N;
  const int n = min(maxb, N);
  select_top([&](int i) { return make_key(__ldg(v + i), i); }, N, n, s);
  const int h = __ldg(h_l + img), w = __ldg(w_l + img);
  const int quota = __ldg(budget + l);
  const int M = (int)(gridDim.x / C) * maxb;
  int* out = scratch + ((long long)c * M + (long long)l * maxb) * SLOT_INTS;
  for (int slot = threadIdx.x; slot < maxb; slot += THREADS) {
    int y = 0, x = 0;
    float resp = 0.0f;
    bool ok = false;
    if (slot < n) {
      const int k = key_index(s.keys[slot]);
      const float val = __ldg(v + k);
      if (val > 0.0f) {
        const int g = k / per_cell, r = __ldg(rid + k);
        y = (g / ncx) * cell + r / cell;
        x = (g % ncx) * cell + r % cell;
        ok = slot < quota && y >= edge && y < h - edge && x >= edge &&
             x < w - edge;
      }
      resp = val > 1.0f ? __fsub_rn(val, 1.0f) : val;
    }
    reinterpret_cast<int4*>(out)[slot] =
        make_int4(y, x, __float_as_int(resp), ok ? 1 : 0);
  }
}

// Per camera c = blockIdx.x: the n_out best of its M slots (or all, in
// order, when M == n_out) and their outputs.
__global__ void __launch_bounds__(THREADS)
orb_compact_kernel(const int* __restrict__ scratch,
                   const float* __restrict__ s_lvl, float* __restrict__ xy,
                   float* __restrict__ response, int* __restrict__ octave,
                   float* __restrict__ sigma2, uint8_t* __restrict__ valid,
                   int* __restrict__ flat_yx, int* __restrict__ flat_img,
                   int C, int M, int maxb, int n_out) {
  __shared__ Smem s;
  const int c = blockIdx.x;
  const int4* slots = reinterpret_cast<const int4*>(scratch) + (long long)c * M;
  const bool compact = M > n_out;
  if (compact) {
    select_top([&](int j) {
      const int4 r = slots[j];
      return make_key(r.w ? __fadd_rn(__int_as_float(r.z), 1000.0f) : -1.0f, j);
    }, M, n_out, s);
  }
  for (int k = threadIdx.x; k < n_out; k += THREADS) {
    const int j = compact ? key_index(s.keys[k]) : k;
    const int4 r = slots[j];  // (y, x, resp bits, valid)
    const int l = j / maxb;
    const float sc = __ldg(s_lvl + l);
    const long long o = (long long)c * n_out + k;
    xy[2 * o] = __fmul_rn((float)r.y, sc);
    xy[2 * o + 1] = __fmul_rn((float)r.x, sc);
    response[o] = __int_as_float(r.z);
    octave[o] = l;
    sigma2[o] = __fmul_rn(sc, sc);
    valid[o] = r.w ? 1 : 0;
    flat_yx[2 * o] = r.x;
    flat_yx[2 * o + 1] = r.y;
    flat_img[o] = l * C + c;
  }
}

}  // namespace

// cand_v (L C, N) float32, cand_rid (L C, N) int32, h_l / w_l (L C,)
// int32, budget (L,) int32, s_lvl (L,) float32, scratch (C L maxb 4)
// int32; outputs xy (C, n_out, 2), response, octave, sigma2, valid (C,
// n_out), flat_yx (C n_out, 2), flat_img (C n_out,). Two launches.
extern "C" int mc_orb_select(const void* cand_v, const void* cand_rid,
                             const void* h_l, const void* w_l,
                             const void* budget, const void* s_lvl,
                             void* scratch, void* xy, void* response,
                             void* octave, void* sigma2, void* valid,
                             void* flat_yx, void* flat_img, int L, int C,
                             int N, int maxb, int n_out, int ncx, int cell,
                             int per_cell, int edge, void* stream) {
  const int M = L * maxb;
  if (L < 1 || C < 1 || N < 1 || maxb < 1 || n_out < 1 || n_out > M ||
      min(maxb, N) > CAP || (M > n_out && n_out > CAP) || ncx < 1 ||
      cell < 1 || per_cell < 1)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  orb_select_kernel<<<L * C, THREADS, 0, s>>>(
      static_cast<const float*>(cand_v), static_cast<const int*>(cand_rid),
      static_cast<const int*>(h_l), static_cast<const int*>(w_l),
      static_cast<const int*>(budget), static_cast<int*>(scratch), C, N, maxb,
      ncx, cell, per_cell, edge);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  orb_compact_kernel<<<C, THREADS, 0, s>>>(
      static_cast<const int*>(scratch), static_cast<const float*>(s_lvl),
      static_cast<float*>(xy), static_cast<float*>(response),
      static_cast<int*>(octave), static_cast<float*>(sigma2),
      static_cast<uint8_t*>(valid), static_cast<int*>(flat_yx),
      static_cast<int*>(flat_img), C, M, maxb, n_out);
  return cudaGetLastError();
}
