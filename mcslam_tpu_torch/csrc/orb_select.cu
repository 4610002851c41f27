// The ORB extraction's global selection in one launch: per image the
// stable top maxb of fast_select's per-cell candidates with the slot
// fields, then per camera the merge into level-major slots and the
// cross-level compaction, done by the camera's last block to finish.
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
//     EDGE; slots s >= n are (0, 0), 0, invalid. They are camera c's
//     level-major slots j = l maxb + s;
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
// of HBM time; what a call costs is the chain of block-wide steps, so the
// design (orb_select_one_kernel, 1024 threads a block, one block per
// image) keeps that chain short:
//  - the n-th largest value by a radix select over the 32 value bits in
//    at most three passes of 11, 11 and 10 bits, two barriers each: a
//    shared histogram of the live values' digits (warp-aggregated
//    atomics: __match_any_sync), then every thread finds the digit of the
//    n-th from the top by itself (a scan of bin pairs, the 32 warp
//    totals, a ballot within the warp that holds it), so no barrier hands
//    the digit around. A pass whose bucket of the n-th key is taken whole
//    ends the select: the chosen keys are then those at or above the
//    bucket (at the bench frame most images stop after two passes). A
//    thread owns a contiguous run of ceil(N / 1024) candidates and reads
//    them from global memory in every pass (L1 hits), so no N is too
//    large;
//  - the ties at the n-th value go to the lowest indices: one block scan
//    of (above, equal) counts in index order places the n chosen keys in
//    shared memory (one barrier);
//  - no sorting network: a chosen key's slot is the number of chosen keys
//    above it (n compares, split over four threads a key), and a slot's
//    place in its level's prio order likewise (maxb compares);
//  - each block writes its slots' fields and its level's prio keys in
//    prio order to scratch, then thread 0 arrives at its camera's counter
//    (one atom.add.acq_rel.gpu after a barrier); the camera's last block
//    ranks every slot of the camera: its place in its own level's order
//    plus, per other level, a binary search in that level's sorted keys
//    (staged in shared memory where M * 8 bytes fit; four levels searched
//    side by side, the slot's fields loaded meanwhile), and writes the
//    outputs of ranks below n_out. It sets the counter back to zero, so
//    every call leaves the per-device counters at zero and the call can be
//    captured in a CUDA graph and replayed. Where M == n_out each block
//    writes its own slots' outputs and no block arrives.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int NWARPS = THREADS / 32;
constexpr int CAP = 4096;  // orb_cuda.SELECT_CAP
constexpr int NB = 2048;   // bins of a radix pass (11 bits)
constexpr int PASSES = 3;  // digits: bits 31-21, 20-10, 9-0
constexpr int STAGE_MAX = 8192;  // slots whose sorted keys the tail stages
constexpr int SMEM_LIMIT = 232448;  // bytes a block may use on sm_90
constexpr unsigned FULL = 0xffffffffu;

typedef unsigned long long u64;

// order-preserving bits of a float32 value (-0 as +0)
__device__ __forceinline__ unsigned ordered(float v) {
  unsigned u = v == 0.0f ? 0u : __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ u64 make_key(unsigned u, int i) {
  return ((u64)u << 32) | (u64)(0xFFFFFFFFu - (unsigned)i);
}

__device__ __forceinline__ int key_index(u64 k) {
  return (int)(0xFFFFFFFFu - (unsigned)(k & 0xFFFFFFFFu));
}

__device__ __forceinline__ int add_acq_rel(int* p) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(p)
               : "memory");
  return old;
}

// Dynamic shared memory: the radix histograms and scans, then (aliased,
// once the radix passes are done) the chosen keys; the level's prio keys;
// the tail's staged sorted keys (aliased with all of it).
struct Radix {
  unsigned hist[2][NB];
  unsigned incl[THREADS];
};

__device__ __forceinline__ unsigned warp_incl(unsigned v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned o = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += o;
  }
  return v;
}

// Over the L runs of maxb keys (each descending) but run le, the number
// of keys above key: a binary search per run of `steps` halvings, four
// runs side by side.
__device__ __forceinline__ int count_above(const u64* runs, int L, int maxb,
                                           int le, u64 key, int steps) {
  int rank = 0;
  for (int g = 0; g < L; g += 4) {
    int lo[4], hi[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      lo[q] = 0;
      hi[q] = g + q < L && g + q != le ? maxb : 0;
    }
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (lo[q] < hi[q]) {
          const int mid = (lo[q] + hi[q]) >> 1;
          if (runs[(long long)(g + q) * maxb + mid] > key) lo[q] = mid + 1;
          else hi[q] = mid;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) rank += lo[q];
  }
  return rank;
}

struct Out {
  const float* s_lvl;
  float* xy;
  float* response;
  int* octave;
  float* sigma2;
  uint8_t* valid;
  int* flat_yx;
  int* flat_img;
};

// Output k of camera c from slot j's fields r = (y, x, resp bits, valid).
__device__ __forceinline__ void write_out(const Out& o, int c, int C,
                                          int n_out, int maxb, int k, int j,
                                          int4 r) {
  const int l = j / maxb;
  const float sc = __ldg(o.s_lvl + l);
  const long long at = (long long)c * n_out + k;
  o.xy[2 * at] = __fmul_rn((float)r.y, sc);
  o.xy[2 * at + 1] = __fmul_rn((float)r.x, sc);
  o.response[at] = __int_as_float(r.z);
  o.octave[at] = l;
  o.sigma2[at] = __fmul_rn(sc, sc);
  o.valid[at] = r.w ? 1 : 0;
  o.flat_yx[2 * at] = r.x;
  o.flat_yx[2 * at + 1] = r.y;
  o.flat_img[at] = l * C + c;
}

// Per image i = blockIdx.x: the selection and the slot fields; the last
// block of camera c to arrive, the compaction.
__global__ void __launch_bounds__(THREADS)
orb_select_one_kernel(const float* __restrict__ cand_v,
                      const int* __restrict__ cand_rid,
                      const int* __restrict__ h_l, const int* __restrict__ w_l,
                      const int* __restrict__ budget, int4* __restrict__ fields,
                      u64* __restrict__ sorted, int* __restrict__ counters,
                      Out o, int L, int C, int N, int maxb, int n_out, int ncx,
                      int cell, int per_cell, int edge) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = min(maxb, N);
  Radix& rs = *reinterpret_cast<Radix*>(smem);
  u64* s_keys = reinterpret_cast<u64*>(smem);  // after the radix passes
  const int head = (int)max(sizeof(Radix), (size_t)n * sizeof(u64));
  u64* s_prio = reinterpret_cast<u64*>(smem + ((head + 15) & ~15));
  __shared__ unsigned s_wsum[NWARPS], s_gsum[NWARPS], s_esum[NWARPS];
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int img = blockIdx.x;
  const int l = img / C, c = img % C;
  const int M = L * maxb;
  const float* v = cand_v + (long long)img * N;
  const int* rid = cand_rid + (long long)img * N;
  const int kpt = (N + THREADS - 1) / THREADS;
  const int i0 = tid * kpt, i1 = min(N, i0 + kpt);

  // 1. the n-th largest value T (all 32 bits) and how many of the values
  // equal to it are taken (rem), by three radix passes from the top
  rs.hist[0][tid] = 0;
  rs.hist[0][tid + THREADS] = 0;
  __syncthreads();
  unsigned prefix = 0, known = 0, rem = (unsigned)n;
  bool whole = false;  // the n-th key's bucket is taken whole
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int sh = p == 0 ? 21 : p == 1 ? 10 : 0;
    const unsigned dmask = p == PASSES - 1 ? 1023u : NB - 1u;
    unsigned* hist = rs.hist[p & 1];
    for (int k = 0; k < kpt; ++k) {
      const int i = i0 + k;
      const unsigned u = i < i1 ? ordered(__ldg(v + i)) : 0u;
      const bool live = i < i1 && (u & known) == prefix;
      const unsigned digit = (u >> sh) & dmask;
      const unsigned act = __ballot_sync(FULL, live);
      if (live) {
        const unsigned peers = __match_any_sync(act, digit);
        if (lane == __ffs(peers) - 1) atomicAdd(&hist[digit], __popc(peers));
      }
    }
    __syncthreads();
    unsigned* other = rs.hist[(p + 1) & 1];
    other[tid] = 0;
    other[tid + THREADS] = 0;
    // thread t holds bins NB - 1 - 2t and NB - 2 - 2t: the bins from the top
    const unsigned h0 = hist[NB - 1 - 2 * tid], h1 = hist[NB - 2 - 2 * tid];
    const unsigned incl = warp_incl(h0 + h1, lane);
    rs.incl[tid] = incl;
    if (lane == 31) s_wsum[warp] = incl;
    __syncthreads();
    // every thread: the warp W, the thread T = 32 W + L and the bin of the
    // rem-th value from the top
    const unsigned wincl = warp_incl(s_wsum[lane], lane);
    const int W = __ffs(__ballot_sync(FULL, wincl >= rem)) - 1;
    const unsigned wbase = W > 0 ? __shfl_sync(FULL, wincl, W - 1) : 0u;
    const unsigned ti = rs.incl[32 * W + lane];
    const int Lx = __ffs(__ballot_sync(FULL, wbase + ti >= rem)) - 1;
    const unsigned tprev = __shfl_sync(FULL, ti, (Lx + 31) & 31);
    const unsigned before = wbase + (Lx > 0 ? tprev : 0u);
    const int T = 32 * W + Lx;
    const unsigned hT = hist[NB - 1 - 2 * T];
    unsigned digit, hd;
    if (before + hT >= rem) {
      digit = NB - 1 - 2 * T;
      rem -= before;
      hd = hT;
    } else {
      digit = NB - 2 - 2 * T;
      rem -= before + hT;
      hd = hist[NB - 2 - 2 * T];
    }
    prefix |= digit << sh;
    known |= dmask << sh;
    if (hd == rem) {  // every thread finds the same: a uniform exit
      whole = true;
      break;
    }
  }

  // 2. the n chosen keys into shared memory in index order: the values
  // above T, and the first rem of those equal to T (or, where the n-th
  // key's bucket is taken whole, the values at or above the bucket)
  unsigned ng = 0, ne = 0;
  for (int i = i0; i < i1; ++i) {
    const unsigned u = ordered(__ldg(v + i));
    ng += whole ? u >= prefix : u > prefix;
    ne += !whole && u == prefix;
  }
  const unsigned gi = warp_incl(ng, lane), ei = warp_incl(ne, lane);
  if (lane == 31) {
    s_gsum[warp] = gi;
    s_esum[warp] = ei;
  }
  __syncthreads();  // also: every thread's radix reads are done
  {
    const unsigned gw = warp_incl(s_gsum[lane], lane);
    const unsigned ew = warp_incl(s_esum[lane], lane);
    unsigned g = (warp > 0 ? __shfl_sync(FULL, gw, (warp + 31) & 31) : 0u)
                 + gi - ng;
    unsigned e = (warp > 0 ? __shfl_sync(FULL, ew, (warp + 31) & 31) : 0u)
                 + ei - ne;
    for (int i = i0; i < i1; ++i) {
      const unsigned u = ordered(__ldg(v + i));
      if (whole ? u >= prefix : u > prefix) {
        s_keys[g + min(e, rem)] = make_key(u, i);
        ++g;
      } else if (u == prefix) {
        if (e < rem) s_keys[g + e] = make_key(u, i);
        ++e;
      }
    }
  }
  __syncthreads();

  // 3. each chosen key's slot (the chosen keys above it), then its slot's
  // fields and prio key; the padding slots s >= n
  const int h = __ldg(h_l + img), w = __ldg(w_l + img);
  const int quota = __ldg(budget + l);
  const bool compact = M > n_out;
  const int q4 = tid & 3;
  for (int q0 = 0; q0 < n; q0 += THREADS / 4) {
    const int q = q0 + (tid >> 2);
    const u64 key = q < n ? s_keys[q] : 0;
    // the candidate's loads, in flight during the compares
    const int k = q < n ? key_index(key) : 0;
    const float val = q < n ? __ldg(v + k) : 0.0f;
    const int rk = q < n ? __ldg(rid + k) : 0;
    int above = 0;
    if (q < n)
      for (int p = q4; p < n; p += 4) above += s_keys[p] > key;
    above += __shfl_xor_sync(FULL, above, 1);
    above += __shfl_xor_sync(FULL, above, 2);
    if (q >= n || q4 != 0) continue;
    const int slot = above;
    int y = 0, x = 0;
    bool ok = false;
    if (val > 0.0f) {
      const int g = k / per_cell, r = rk;
      y = (g / ncx) * cell + r / cell;
      x = (g % ncx) * cell + r % cell;
      ok = slot < quota && y >= edge && y < h - edge && x >= edge &&
           x < w - edge;
    }
    const float resp = val > 1.0f ? __fsub_rn(val, 1.0f) : val;
    const int4 f = make_int4(y, x, __float_as_int(resp), ok ? 1 : 0);
    const int j = l * maxb + slot;
    if (compact) {
      fields[(long long)c * M + j] = f;
      s_prio[slot] = make_key(ordered(ok ? __fadd_rn(resp, 1000.0f) : -1.0f), j);
    } else {
      write_out(o, c, C, n_out, maxb, j, j, f);
    }
  }
  for (int slot = n + tid; slot < maxb; slot += THREADS) {
    const int j = l * maxb + slot;
    const int4 f = make_int4(0, 0, 0, 0);
    if (compact) {
      fields[(long long)c * M + j] = f;
      s_prio[slot] = make_key(ordered(-1.0f), j);
    } else {
      write_out(o, c, C, n_out, maxb, j, j, f);
    }
  }
  if (!compact) return;
  __syncthreads();

  // 4. the level's prio keys in order, into the camera's sorted runs
  u64* run = sorted + (long long)c * M + (long long)l * maxb;
  for (int q0 = 0; q0 < maxb; q0 += THREADS / 4) {
    const int q = q0 + (tid >> 2);
    const u64 key = q < maxb ? s_prio[q] : 0;
    int above = 0;
    if (q < maxb)
      for (int p = q4; p < maxb; p += 4) above += s_prio[p] > key;
    above += __shfl_xor_sync(FULL, above, 1);
    above += __shfl_xor_sync(FULL, above, 2);
    if (q < maxb && q4 == 0) run[above] = key;
  }

  // 5. arrival; the camera's last block ranks all its slots
  __syncthreads();
  if (tid == 0) s_last = add_acq_rel(&counters[c]) == L - 1;
  __syncthreads();
  if (!s_last) return;
  const u64* cam = sorted + (long long)c * M;
  const u64* runs = cam;
  if (M <= STAGE_MAX) {
    u64* st = reinterpret_cast<u64*>(smem);
    for (int e = tid; e < M; e += THREADS) st[e] = __ldcg(cam + e);
    __syncthreads();
    runs = st;
  }
  const int steps = 32 - __clz(maxb);  // halvings of [0, maxb)
  for (int e = tid; e < M; e += THREADS) {
    const int le = e / maxb;
    const u64 key = runs[e];
    const int j = key_index(key);
    const int4 f = __ldcg(fields + (long long)c * M + j);
    const int rank = e - le * maxb + count_above(runs, L, maxb, le, key, steps);
    if (rank < n_out) write_out(o, c, C, n_out, maxb, rank, j, f);
  }
  if (tid == 0) counters[c] = 0;
}

// Dynamic shared memory of a launch (bytes).
int select_smem(int N, int maxb, int L, int n_out) {
  const int n = min(maxb, N);
  const long head = ((long)(sizeof(Radix) > (size_t)n * 8 ? sizeof(Radix)
                                                         : (size_t)n * 8) + 15) & ~15L;
  long bytes = head + 8L * maxb;
  const long M = (long)L * maxb;
  if (M > n_out && M <= STAGE_MAX && 8 * M > bytes) bytes = 8 * M;
  return (int)bytes;
}

}  // namespace

// cand_v (L C, N) float32, cand_rid (L C, N) int32, h_l / w_l (L C,)
// int32, budget (L,) int32, s_lvl (L,) float32, scratch (C L maxb int4
// fields, then C L maxb u64 sorted keys), counters (C int32, zero; left
// at zero); outputs xy (C, n_out, 2), response, octave, sigma2, valid (C,
// n_out), flat_yx (C n_out, 2), flat_img (C n_out,). One launch.
extern "C" int mc_orb_select(const void* cand_v, const void* cand_rid,
                             const void* h_l, const void* w_l,
                             const void* budget, const void* s_lvl,
                             void* scratch, void* counters, void* xy,
                             void* response, void* octave, void* sigma2,
                             void* valid, void* flat_yx, void* flat_img,
                             int L, int C, int N, int maxb, int n_out, int ncx,
                             int cell, int per_cell, int edge, void* stream) {
  const int M = L * maxb;
  const int smem = select_smem(N, maxb, L, n_out);
  if (L < 1 || C < 1 || N < 1 || maxb < 1 || min(maxb, N) > CAP ||
      n_out < 1 || n_out > M || ncx < 1 || cell < 1 || per_cell < 1 ||
      smem > SMEM_LIMIT)
    return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        orb_select_one_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
  }
  int4* fields = static_cast<int4*>(scratch);
  u64* sorted = reinterpret_cast<u64*>(fields + (long long)C * M);
  Out o{static_cast<const float*>(s_lvl), static_cast<float*>(xy),
        static_cast<float*>(response), static_cast<int*>(octave),
        static_cast<float*>(sigma2), static_cast<uint8_t*>(valid),
        static_cast<int*>(flat_yx), static_cast<int*>(flat_img)};
  orb_select_one_kernel<<<L * C, THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cand_v), static_cast<const int*>(cand_rid),
      static_cast<const int*>(h_l), static_cast<const int*>(w_l),
      static_cast<const int*>(budget), fields, sorted,
      static_cast<int*>(counters), o, L, C, N, maxb, n_out, ncx, cell,
      per_cell, edge);
  return cudaGetLastError();
}
