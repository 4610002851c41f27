// FAST-9/16 + 3x3 NMS + 7-tap blur over 32-row blocks: two entries.
//
// mc_fast_select — score, NMS, blur and per-cell top-4 selection in one
// launch. Replaces: mcslam_tpu/ops/fast_pallas.py fast_select_pallas (body
// _fast_kernel_select / _fast_tile_score / _blur_band / _cell_topk_band).
//
// mc_fast_corners — the NMS'd score map itself, optionally with the blur.
// Replaces: mcslam_tpu/ops/fast_pallas.py fast_corners_pallas, both of its
// pallas_calls: the `heights` branch (_fast_kernel_hskip[_blur], mode
// "hskip") and the `heights=None` branch (_fast_kernel[_blur], mode
// "full").
//
// Computes, for every image of the stacked (LC, H, W) pyramid batch:
//   * the FAST-9/16 arc score at min_thr (max over 16 starts of the min
//     signed difference along 9 contiguous circle pixels, bright and
//     dark), zeroed outside [3, H-3) x [3, W-3), then 3x3 NMS;
//   * mc_fast_select only: the per-image true-bounds mask (rows < h-3,
//     cols < w-3) and the +1 rank bonus above fast_thr, then the exact
//     top-4 per 16x16 cell, ordered (value desc, raster rid asc), written
//     straight into the (LC, G, 4) cell-raster-major, round-minor layout
//     that orb._select_from_cells reads (G = ceil(H/16) * ncx,
//     ncx = ceil128(W) / 16);
//   * the separable 7-tap blur (vertical pass, then horizontal, taps in
//     order, separate f32 multiply and add: bit-identical to the plain
//     PyTorch versions in ops/fast_cuda.py).
// Boundary rule, shared with the plain versions: rows clamp to [0, H-1];
// columns wrap modulo Wp = ceil128(W), then clamp to W-1 (the TPU
// kernel's edge padding + lane roll). Band skip rule, per 16-row band:
// mc_fast_select and mc_fast_corners in mode hskip with the blur write
// zeros for a band starting at or beyond the image's true height h; mode
// hskip without the blur already from h - 3 (the caller masks those score
// rows, and no blur row is needed); mode full never skips.
//
// Bound on the card, counted by instruction class at the production shape
// (16 x 480 x 640; mc_fast_select computes 3.85 M pixels in the bands its
// skip keeps):
//   compare / min / max / select (64 per SM per clock on sm_90,
//     ~16.7e12/s): the compass pre-test ~12 per pixel; the arc trees 81
//     for one polarity, 161 for both (m2 -> m4 -> m8 -> m9: 64 per
//     polarity, a 16-way reduction: 15, the final max, threshold and
//     select); NMS ~11; mask + rank bonus + selection ~12;
//   f32 add / multiply (128 per SM per clock, ~33.5e12/s, also the SM's
//     issue rate): 4 compass differences, 12 more where the trees run
//     (a negation is an operand modifier), blur 26 (2 passes x (7
//     multiplies + 6 adds)).
// The two classes' pipes overlap: the operations take the longer of all
// of them at the issue rate and the compare class at its own. Were the
// trees run for both polarities at every pixel, that would be ~0.042 ms
// for mc_fast_select; on the bench scene 18 % of the pixels pass the
// pre-test, and the operations bound falls to ~0.012 ms. Memory is
// ~35-59 MB per call, 0.010-0.018 ms at 3.35 TB/s.
// Design:
//   * an exact compass pre-test: any 9 contiguous circle positions hold
//     two of the compass points {0, 4, 8, 12}, so a pixel's bright score
//     can exceed min_thr only if two compass differences are > min_thr,
//     its dark score only if two are < -min_thr (the same f32 values and
//     comparisons as the trees). Passing pixels are queued per warp in
//     shared memory (a ballot per warp row, skipped by a warp none of
//     whose lanes passes; no atomics), and after a barrier the trees run
//     on the queue, 32 passing pixels to a warp;
//   * the doubling trees of the TPU kernel (_fast_tile_score) and a
//     pairwise max over the starts; a pixel for which the pre-test allows
//     one polarity runs one tree on sgn * d (the other polarity scores
//     <= min_thr, so the score is that tree's, if > min_thr), one that
//     allows both runs the bright tree on d and the dark one on -d. Min,
//     max and the sign flip are exact, so the scores equal the plain
//     version's bit for bit;
//   * one block of 256 threads per (image, 32-row block, 128-column
//     chunk): the staged halo is 40 x 136 for 32 x 128 outputs (1.33x),
//     the scored rows 34 for 32 (1.06x). A block whose second 16-row band
//     is skipped (or lies beyond H) computes 16 rows;
//   * staging with cp.async: 16-byte copies when W % 128 == 0 (Wp == W,
//     every 4-aligned column group of the halo wraps onto a 4-aligned
//     group of the row) and the image is 16-byte aligned, else 4-byte
//     copies; the column wrap is a compare-and-add (x0 - 4 + c lies in
//     (-Wp, 2Wp)), and no inner loop divides by a runtime value;
//   * each thread owns a column run, lanes on neighbouring columns: the
//     pre-test walks 17 (or 9) rows keeping its column in registers (the
//     vertical compass differences serve two rows each), the vertical
//     blur and the NMS keep a window of rows, so each new row costs three
//     (pre-test), one (blur) or three (NMS) shared loads;
//   * the per-cell top-4 by warp reductions (__reduce_max_sync of the
//     value bits, __reduce_min_sync of the rids holding the maximum), the
//     block's two cells of a warp interleaved;
//   * dynamic shared memory: 21,760 B staged image + 17,952 B scores +
//     9,248 B queue + 64 B counts + 17,408 B vertical blur = 66,432 B
//     with the blur, 3 blocks per SM (the selection's tile reuses the
//     staged image's space); 49,024 B without;
//   * the taps come by value, in the kernel's parameter space.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int CELL = 16;  // cell size and height of a skip band
constexpr int KSEL = 4;
constexpr int CHUNK = 128;  // columns per block
constexpr int BAND = 2 * CELL;  // rows per block
constexpr int HALO = 4;
constexpr int BORDER = 3;
constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 3;  // blocks per SM the launch bounds ask for
constexpr int SROWS = BAND + 2 * HALO;  // 40 staged rows: y0-4 .. y0+35
constexpr int SCOLS = CHUNK + 2 * HALO;  // 136 staged columns: x0-4 .. x0+131
constexpr int ZROWS = BAND + 2;  // score rows y0-1 .. y0+32
constexpr int ZCOLS = CHUNK + 4;  // score columns x0-1 .. x0+128 (130 used)
constexpr int BCOLS = CHUNK + 8;  // vertical blur x0-3 .. x0+130 (134 used)
constexpr int SEL_STRIDE = CHUNK + 16;  // a cell's two half-warp rows: other banks
constexpr int NWARPS = THREADS / 32;
// pre-test queue: one segment per warp, for its (ZROWS / 2 + 1) warp rows,
// and a slot that the lanes with nothing to queue write to
constexpr int SEG = (ZROWS / 2 + 1) * 32;
constexpr int SEG_STRIDE = SEG + 2;
// Dynamic shared memory, in floats: staged image | scores | pre-test
// queue (NWARPS segments of SEG_STRIDE 16-bit entries) | the segments'
// counts (NWARPS single, NWARPS both) | vertical blur.
constexpr int IMG_FLOATS = SROWS * SCOLS;
constexpr int SCORE_FLOATS = ZROWS * ZCOLS;
constexpr int Q_FLOATS = NWARPS * SEG_STRIDE / 2;
constexpr int VB_FLOATS = BAND * BCOLS;
constexpr int OFF_SCORE = IMG_FLOATS;
constexpr int OFF_Q = OFF_SCORE + SCORE_FLOATS;
constexpr int OFF_CNT = OFF_Q + Q_FLOATS;
constexpr int OFF_VB = OFF_CNT + 2 * NWARPS;
constexpr int SMEM_NOBLUR = OFF_VB * (int)sizeof(float);
constexpr int SMEM_BLUR = SMEM_NOBLUR + VB_FLOATS * (int)sizeof(float);
static_assert(BAND * SEL_STRIDE <= IMG_FLOATS, "the selection tile reuses s_img");
static_assert((SCOLS * sizeof(float)) % 16 == 0, "16-byte staged rows");
static_assert(ZROWS * ZCOLS < 0x8000, "queue entries hold a score offset");
static_assert(SEG_STRIDE % 2 == 0, "segments of whole floats");
static_assert(SMEM_NOBLUR <= 48 * 1024, "no opt-in without the blur");

struct Taps {
  float t[7];
};

// Offset of circle pixel s (dy * SCOLS + dx) in the staged tile; the order
// of ops/fast.CIRCLE. Folded to a constant in the unrolled loops.
__device__ __forceinline__ constexpr int circle(int s) {
  // (dy, dx): (-3,0) (-3,1) (-2,2) (-1,3) (0,3) (1,3) (2,2) (3,1)
  //           (3,0) (3,-1) (2,-2) (1,-3) (0,-3) (-1,-3) (-2,-2) (-3,-1)
  return s == 0    ? -3 * SCOLS
         : s == 1  ? -3 * SCOLS + 1
         : s == 2  ? -2 * SCOLS + 2
         : s == 3  ? -SCOLS + 3
         : s == 4  ? 3
         : s == 5  ? SCOLS + 3
         : s == 6  ? 2 * SCOLS + 2
         : s == 7  ? 3 * SCOLS + 1
         : s == 8  ? 3 * SCOLS
         : s == 9  ? 3 * SCOLS - 1
         : s == 10 ? 2 * SCOLS - 2
         : s == 11 ? SCOLS - 3
         : s == 12 ? -3
         : s == 13 ? -SCOLS - 3
         : s == 14 ? -2 * SCOLS - 2
                   : -3 * SCOLS - 1;
}

__device__ __forceinline__ void cp_async16(float* s, const float* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(s)),
               "l"(g));
}

__device__ __forceinline__ void cp_async4(float* s, const float* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(s)),
               "l"(g));
}

// Rows of the block at y0 that it computes: 0 (both bands skipped), 16
// (the second band is skipped or starts at or beyond H) or 32.
__device__ __forceinline__ int live_rows(int y0, int skip_from, int H) {
  if (y0 >= skip_from) return 0;
  return (y0 + CELL >= skip_from || y0 + CELL >= H) ? CELL : BAND;
}

// Stage image rows y0-4 .. y0-4+nrows-1, columns x0-4 .. x0+131 (rows
// clamped, columns wrapped modulo Wp and clamped to W-1), then barrier.
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      float* s_img, int y0, int x0,
                                      int nrows, int H, int W, int Wp,
                                      bool vec) {
  if (vec) {  // Wp == W: each 4-aligned group wraps onto a 4-aligned group
    constexpr int G = SCOLS / 4;
    for (int i = threadIdx.x; i < nrows * G; i += THREADS) {
      const int r = i / G, g = i - r * G;
      const int y = min(max(y0 - HALO + r, 0), H - 1);
      int x = x0 - HALO + 4 * g;
      x += x < 0 ? W : (x >= W ? -W : 0);
      cp_async16(s_img + r * SCOLS + 4 * g, src + (size_t)y * W + x);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * SCOLS; i += THREADS) {
      const int r = i / SCOLS, c = i - r * SCOLS;
      const int y = min(max(y0 - HALO + r, 0), H - 1);
      int x = x0 - HALO + c;
      x += x < 0 ? Wp : (x >= Wp ? -Wp : 0);
      cp_async4(s_img + r * SCOLS + c, src + (size_t)y * W + min(x, W - 1));
    }
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// lo[s] = max(lo[s], lo[s + W]) for s < W.
template <int W>
__device__ __forceinline__ void max_step(float* lo) {
#pragma unroll
  for (int s = 0; s < W; ++s) lo[s] = fmaxf(lo[s], lo[s + W]);
}

// The bright arc score of differences e: max over the 16 starts of the
// min over 9 contiguous entries, by the doubling tree m2 -> m4 -> m8 ->
// m9 and a pairwise max (constant strides keep every array in registers).
__device__ __forceinline__ float arc_score(const float* e) {
  float lo[16], lo2[16];
#pragma unroll
  for (int s = 0; s < 16; ++s) lo[s] = fminf(e[s], e[(s + 1) & 15]);
#pragma unroll
  for (int s = 0; s < 16; ++s) lo2[s] = fminf(lo[s], lo[(s + 2) & 15]);
#pragma unroll
  for (int s = 0; s < 16; ++s)
    lo[s] = fminf(fminf(lo2[s], lo2[(s + 4) & 15]), e[(s + 8) & 15]);
  max_step<8>(lo);
  max_step<4>(lo);
  max_step<2>(lo);
  max_step<1>(lo);
  return lo[0];
}

// The compass pre-test. Any 9 contiguous circle positions hold two of the
// compass points {0, 4, 8, 12}, so a pixel's bright arc score can exceed
// thr only if two compass differences are > thr, its dark one only if two
// are < -thr. two_of_four: at least two of a, b, c, e.
__device__ __forceinline__ bool two_of_four(bool a, bool b, bool c, bool e) {
  return (a && b) || (c && e) || ((a || b) && (c || e));
}

// Score of a pixel of one possible polarity (the other's arc score is
// <= thr): the arc score of sgn * (circle - centre), sgn = -1 for dark
// (the sign flip is exact), if > thr.
__device__ __forceinline__ float score_one(const float* p, float sgn,
                                           float thr) {
  const float ctr = p[0];
  float e[16];
#pragma unroll
  for (int s = 0; s < 16; ++s) e[s] = __fmul_rn(p[circle(s)] - ctr, sgn);
  const float v = arc_score(e);
  return v > thr ? v : 0.f;
}

// Score of a pixel of both possible polarities: the larger of the arc
// scores of d (bright) and -d (dark), if > thr.
__device__ __forceinline__ float score_both(const float* p, float thr) {
  const float ctr = p[0];
  float d[16], n[16];
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    d[s] = p[circle(s)] - ctr;
    n[s] = -d[s];
  }
  const float v = fmaxf(arc_score(d), arc_score(n));
  return v > thr ? v : 0.f;
}

// Queue the pixels of a warp row that pass the pre-test in the warp's
// segment of s_q: score-tile offsets i * ZCOLS + j (< 2^15), single-
// polarity ones from the front (bit 15 set for dark), both-polarity ones
// from the back. n1 / n2 count them; they are warp-uniform, so no atomic.
__device__ __forceinline__ void push(bool br, bool dk, int off,
                                     unsigned short* seg, int& n1, int& n2) {
  const bool one = br != dk, two = br && dk;
  const unsigned m1 = __ballot_sync(0xffffffffu, one);
  const unsigned m2 = __ballot_sync(0xffffffffu, two);
  if ((m1 | m2) == 0) return;  // the whole warp
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
  const int pos = one   ? n1 + __popc(m1 & below)
                  : two ? SEG - 1 - (n2 + __popc(m2 & below))
                        : SEG;
  seg[pos] = off | (dk && !br ? 0x8000 : 0);
  n1 += __popc(m1);
  n2 += __popc(m2);
}

// Pre-test of score rows i0 .. i0+RUN-1 at score column j (staged column
// j + 3): scores 0 and passing pixels queued. The lane keeps its staged
// column's rows i0 .. i0+RUN+5 and the vertical differences u[k] = v[k] -
// v[k+3] in registers: u[r] is row i0+r's upper compass difference and
// -u[r+3] its lower one (exact: a - b = -(b - a)).
template <int RUN>
__device__ __forceinline__ void pretest_run(const float* s_img,
                                            float* s_score,
                                            unsigned short* seg, int& n1,
                                            int& n2, int i0, int j, bool xin,
                                            int y0, int H, float thr) {
  const float* col = s_img + i0 * SCOLS + j + 3;
  float v[RUN + 6], u[RUN + 3];
#pragma unroll
  for (int k = 0; k < RUN + 6; ++k) v[k] = col[k * SCOLS];
#pragma unroll
  for (int k = 0; k < RUN + 3; ++k) u[k] = v[k] - v[k + 3];
#pragma unroll
  for (int r = 0; r < RUN; ++r) {
    const float* p = col + (r + 3) * SCOLS;
    const float right = p[3] - v[r + 3], left = p[-3] - v[r + 3];
    const int y = y0 - 1 + i0 + r;
    const bool in = xin && y >= BORDER && y < H - BORDER;
    const bool br = in && two_of_four(u[r] > thr, right > thr,
                                      u[r + 3] < -thr, left > thr);
    const bool dk = in && two_of_four(u[r] < -thr, right < -thr,
                                      u[r + 3] > thr, left < -thr);
    s_score[(i0 + r) * ZCOLS + j] = 0.f;
    push(br, dk, (i0 + r) * ZCOLS + j, seg, n1, n2);
  }
}

// Pre-test of rows y0-1 .. y0+live and columns x0-1 .. x0+128: warp w
// walks score column 1 + 32 (w % 4) + lane down half of the rows; the two
// edge columns (x0-1, x0+128) go to the first warps, one pixel per lane
// (the lanes past them repeat pixel (0, 0) or (0, 129) with nothing to
// queue).
// Warp w's queue counts go to s_cnt[w] (single) and s_cnt[NWARPS + w]
// (both).
__device__ __forceinline__ void pretest_tile(const float* s_img,
                                             float* s_score,
                                             unsigned short* s_q, int* s_cnt,
                                             int y0, int x0, int live, int H,
                                             int W, float thr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned short* seg = s_q + warp * SEG_STRIDE;
  const int j = 1 + 32 * (warp & 3) + lane;
  const int x = x0 - 1 + j;
  const bool xin = x >= BORDER && x < W - BORDER;
  int n1 = 0, n2 = 0;
  if (live == BAND)
    pretest_run<BAND / 2 + 1>(s_img, s_score, seg, n1, n2,
                              (warp >> 2) * (BAND / 2 + 1), j, xin, y0, H,
                              thr);
  else
    pretest_run<CELL / 2 + 1>(s_img, s_score, seg, n1, n2,
                              (warp >> 2) * (CELL / 2 + 1), j, xin, y0, H,
                              thr);
  const int n_edge = 2 * (live + 2);
  if (warp * 32 < n_edge) {  // whole warps
    const int t = threadIdx.x;
    const bool act = t < n_edge;
    const int ie = act ? t >> 1 : 0, je = (t & 1) ? CHUNK + 1 : 0;
    const int xe = x0 - 1 + je;
    pretest_run<1>(s_img, s_score, seg, n1, n2, ie, je,
                   act && xe >= BORDER && xe < W - BORDER, y0, H, thr);
  }
  if (lane == 0) {
    s_cnt[warp] = n1;
    s_cnt[NWARPS + warp] = n2;
  }
}

// Segment of queue index q: the warp w with pre[w] <= q <
// pre[w + 1] (pre: NWARPS + 1 inclusive prefix counts).
__device__ __forceinline__ int seg_of(const int* pre, int q) {
  int w = 0;
#pragma unroll
  for (int k = 1; k < NWARPS; ++k) w += q >= pre[k];
  return w;
}

// The arc trees of the queued pixels, 32 to a warp (queue index q of the
// segments laid end to end): scores into s_score.
__device__ __forceinline__ void tree_tile(const float* s_img, float* s_score,
                                          const unsigned short* s_q,
                                          const int* s_cnt, float thr) {
  int pre1[NWARPS + 1], pre2[NWARPS + 1];
  pre1[0] = pre2[0] = 0;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) {
    pre1[w + 1] = pre1[w] + s_cnt[w];
    pre2[w + 1] = pre2[w] + s_cnt[NWARPS + w];
  }
  for (int q = threadIdx.x; q < pre1[NWARPS]; q += THREADS) {
    const int w = seg_of(pre1, q);
    int base = 0;
#pragma unroll
    for (int k = 1; k < NWARPS; ++k) base = w == k ? pre1[k] : base;
    const int e = s_q[w * SEG_STRIDE + q - base], off = e & 0x7fff;
    const int i = off / ZCOLS, j = off - i * ZCOLS;
    s_score[off] = score_one(s_img + (i + 3) * SCOLS + j + 3,
                             (e & 0x8000) ? -1.f : 1.f, thr);
  }
  for (int q = threadIdx.x; q < pre2[NWARPS]; q += THREADS) {
    const int w = seg_of(pre2, q);
    int base = 0;
#pragma unroll
    for (int k = 1; k < NWARPS; ++k) base = w == k ? pre2[k] : base;
    const int off = s_q[w * SEG_STRIDE + SEG - 1 - (q - base)];
    const int i = off / ZCOLS, j = off - i * ZCOLS;
    s_score[off] = score_both(s_img + (i + 3) * SCOLS + j + 3, thr);
  }
}

// Vertical blur of rows r0 .. r0+RUN-1 at blur column j (image column
// x0-3+j, staged column j+1), from a window of RUN + 6 staged rows.
template <int RUN>
__device__ __forceinline__ void vblur_run(const float* s_img, float* s_vb,
                                          int r0, int j, const Taps& tp) {
  float v[RUN + 6];
#pragma unroll
  for (int k = 0; k < RUN + 6; ++k) v[k] = s_img[(r0 + 1 + k) * SCOLS + j + 1];
#pragma unroll
  for (int r = 0; r < RUN; ++r) {
    float acc = __fmul_rn(v[r], tp.t[0]);
#pragma unroll
    for (int t = 1; t < 7; ++t) acc = __fadd_rn(acc, __fmul_rn(v[r + t], tp.t[t]));
    s_vb[(r0 + r) * BCOLS + j] = acc;
  }
}

// Vertical blur of the block's 2 * RUN rows, columns x0-3 .. x0+130: a
// thread per (column, half) for the chunk's 128 columns; the last warp's
// first 12 lanes also take the six edge columns.
template <int RUN>
__device__ __forceinline__ void vblur_tile(const float* s_img, float* s_vb,
                                           const Taps& tp) {
  const int t = threadIdx.x;
  vblur_run<RUN>(s_img, s_vb, (t >> 7) * RUN, 3 + (t & (CHUNK - 1)), tp);
  const int e = t - (THREADS - 32);
  if (e >= 0 && e < 12) {
    const int k = e % 6;
    vblur_run<RUN>(s_img, s_vb, (e / 6) * RUN, k < 3 ? k : CHUNK + k, tp);
  }
}

// Horizontal blur at block column c of a vertical-blur row.
__device__ __forceinline__ float hblur_at(const float* vb_row, int c,
                                          const Taps& tp) {
  float out = __fmul_rn(vb_row[c], tp.t[0]);
#pragma unroll
  for (int t = 1; t < 7; ++t) out = __fadd_rn(out, __fmul_rn(vb_row[c + t], tp.t[t]));
  return out;
}

// NMS (3x3: the score if >= all 8 neighbours and > 0, else 0) and the
// horizontal blur of the block's 2 * RUN rows: warp w walks block column
// 32 (w % 4) + lane down RUN rows, keeping the running row maxima.
// SEL: the masked, bonused value goes to s_sel; else the NMS'd score to
// dscore. BLUR: the blur to dblur.
template <int RUN, bool SEL, bool BLUR>
__device__ __forceinline__ void out_tile(const float* s_score,
                                         const float* s_vb, float* s_sel,
                                         float* dscore, float* dblur, int y0,
                                         int x0, int H, int W, int h_img,
                                         int w_img, float fast_thr,
                                         const Taps& tp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = 32 * (warp & 3) + lane;
  const int r0 = (warp >> 2) * RUN;
  const int x = x0 + c;
  const float* z = s_score + c;  // columns c, c+1, c+2: x-1, x, x+1
  float m1 = z[r0 * ZCOLS + 1];
  float h0 = fmaxf(fmaxf(z[r0 * ZCOLS], m1), z[r0 * ZCOLS + 2]);
  m1 = z[(r0 + 1) * ZCOLS + 1];
  float h1 = fmaxf(fmaxf(z[(r0 + 1) * ZCOLS], m1), z[(r0 + 1) * ZCOLS + 2]);
#pragma unroll 4
  for (int r = 0; r < RUN; ++r) {
    const int rr = r0 + r;  // block row; score rows rr .. rr+2
    const float* zr = z + (rr + 2) * ZCOLS;
    const float m2 = zr[1];
    const float h2 = fmaxf(fmaxf(zr[0], m2), zr[2]);
    const float pooled = fmaxf(fmaxf(h0, h1), h2);
    float v = (m1 >= pooled && m1 > 0.f) ? m1 : 0.f;
    h0 = h1;
    h1 = h2;
    m1 = m2;
    const int y = y0 + rr;
    if constexpr (SEL) {
      if (!(y < h_img - BORDER && x < w_img - BORDER)) v = 0.f;
      if (v > fast_thr) v = v + 1.0f;
      s_sel[rr * SEL_STRIDE + c] = v;
    }
    if (y < H && x < W) {
      if constexpr (!SEL) dscore[(size_t)y * W + x] = v;
      if constexpr (BLUR) dblur[(size_t)y * W + x] = hblur_at(s_vb + rr * BCOLS, c, tp);
    }
  }
}

// Zero rows ya .. ya+n-1 (clipped to H) of an output map's chunk.
__device__ __forceinline__ void zero_rows(float* dst, int ya, int n, int x0,
                                          int H, int W) {
  for (int i = threadIdx.x; i < n * CHUNK; i += THREADS) {
    const int y = ya + (i >> 7), x = x0 + (i & (CHUNK - 1));
    if (y < H && x < W) dst[(size_t)y * W + x] = 0.f;
  }
}

// Top-4 of NC 16x16 cells of s_sel (cell c: rows 16 c .., columns cx0 ..)
// by one warp, interleaved; cell c's go to cand_v / cand_rid[cbase + c *
// cstride ..], ordered (value desc, rid asc). Lane l holds rids l, l+32,
// ..., l+224 (raster offset rid = row * 16 + col). The values are >= 0, so
// their bits + 1 order them as unsigned keys (0: knocked out): a warp max
// of the keys, then a warp min of the rids that hold it.
template <int NC>
__device__ __forceinline__ void select_cells(const float* s_sel, int cx0,
                                             float* cand_v, int* cand_rid,
                                             size_t cbase, size_t cstride) {
  const int lane = threadIdx.x & 31;
  unsigned key[NC][8];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int rid = lane + 32 * j;
      key[c][j] = __float_as_uint(s_sel[(c * CELL + (rid >> 4)) * SEL_STRIDE +
                                        cx0 + (rid & 15)]) + 1u;
    }
#pragma unroll
  for (int round = 0; round < KSEL; ++round) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      unsigned bk = key[c][0];
      int br = lane;
#pragma unroll
      for (int j = 1; j < 8; ++j) {
        if (key[c][j] > bk) {  // strict: the lowest rid of equal keys stays
          bk = key[c][j];
          br = lane + 32 * j;
        }
      }
      const unsigned top = __reduce_max_sync(0xffffffffu, bk);
      const int rid = (int)__reduce_min_sync(
          0xffffffffu, bk == top ? (unsigned)br : 256u);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (rid == lane + 32 * j) key[c][j] = 0u;  // knocked out
      if (lane == 0) {
        cand_v[cbase + c * cstride + round] = __uint_as_float(top - 1u);
        cand_rid[cbase + c * cstride + round] = rid;
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) fast_select_kernel(
    const float* __restrict__ img, const int* __restrict__ heights,
    const int* __restrict__ widths, float* __restrict__ blur,
    float* __restrict__ cand_v, int* __restrict__ cand_rid, int H, int W,
    int Wp, int ncx, int nbands, float min_thr, float fast_thr, Taps tp,
    bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int chunk = blockIdx.x;
  const int x0 = chunk * CHUNK, y0 = blockIdx.y * BAND;
  const int im = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int h_img = heights[im];
  const int w_img = widths[im];
  const float* src = img + (size_t)im * H * W;
  float* dst = blur + (size_t)im * H * W;
  const int band0 = 2 * blockIdx.y;  // the block's first cell row
  auto cbase = [&](int b, int cell) {
    return (((size_t)im * nbands + band0 + b) * ncx + (size_t)chunk * 8 +
            cell) * KSEL;
  };

  const int live = live_rows(y0, h_img, H);
  zero_rows(dst, y0 + live, BAND - live, x0, H, W);
  for (int b = live / CELL; b < 2; ++b) {  // skipped cell rows: zeros
    if (band0 + b < nbands && tid < 8 * KSEL) {
      cand_v[cbase(b, 0) + tid] = 0.f;
      cand_rid[cbase(b, 0) + tid] = 0;
    }
  }
  if (live == 0) return;

  float* s_img = smem;
  float* s_score = smem + OFF_SCORE;
  unsigned short* s_q = reinterpret_cast<unsigned short*>(smem + OFF_Q);
  int* s_cnt = reinterpret_cast<int*>(smem + OFF_CNT);
  float* s_vb = smem + OFF_VB;
  float* s_sel = smem;  // after the third barrier s_img is dead
  stage(src, s_img, y0, x0, live + 2 * HALO, H, W, Wp, vec);
  pretest_tile(s_img, s_score, s_q, s_cnt, y0, x0, live, H, W, min_thr);
  if (live == BAND)
    vblur_tile<CELL>(s_img, s_vb, tp);
  else
    vblur_tile<CELL / 2>(s_img, s_vb, tp);
  __syncthreads();
  tree_tile(s_img, s_score, s_q, s_cnt, min_thr);
  __syncthreads();
  if (live == BAND)
    out_tile<CELL, true, true>(s_score, s_vb, s_sel, nullptr, dst, y0, x0, H,
                               W, h_img, w_img, fast_thr, tp);
  else
    out_tile<CELL / 2, true, true>(s_score, s_vb, s_sel, nullptr, dst, y0,
                                   x0, H, W, h_img, w_img, fast_thr, tp);
  __syncthreads();
  // warp w selects cell w of each computed cell row
  if (live == BAND)
    select_cells<2>(s_sel, warp * CELL, cand_v, cand_rid, cbase(0, warp),
                    (size_t)ncx * KSEL);
  else
    select_cells<1>(s_sel, warp * CELL, cand_v, cand_rid, cbase(0, warp), 0);
}

// heights == nullptr: mode full (no band skipped). BLUR: also write the
// blur (and skip from h instead of h - 3 in mode hskip).
template <bool BLUR>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) fast_corners_kernel(
    const float* __restrict__ img, const int* __restrict__ heights,
    float* __restrict__ score, float* __restrict__ blur, int H, int W,
    int Wp, float min_thr, Taps tp, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int x0 = blockIdx.x * CHUNK, y0 = blockIdx.y * BAND;
  const int im = blockIdx.z;
  const float* src = img + (size_t)im * H * W;
  float* dscore = score + (size_t)im * H * W;
  float* dblur = BLUR ? blur + (size_t)im * H * W : nullptr;
  const int skip_from =
      heights == nullptr ? H : (BLUR ? heights[im] : heights[im] - BORDER);

  const int live = live_rows(y0, skip_from, H);
  zero_rows(dscore, y0 + live, BAND - live, x0, H, W);
  if (BLUR) zero_rows(dblur, y0 + live, BAND - live, x0, H, W);
  if (live == 0) return;

  float* s_img = smem;
  float* s_score = smem + OFF_SCORE;
  unsigned short* s_q = reinterpret_cast<unsigned short*>(smem + OFF_Q);
  int* s_cnt = reinterpret_cast<int*>(smem + OFF_CNT);
  float* s_vb = smem + OFF_VB;
  stage(src, s_img, y0, x0, live + 2 * HALO, H, W, Wp, vec);
  pretest_tile(s_img, s_score, s_q, s_cnt, y0, x0, live, H, W, min_thr);
  if constexpr (BLUR) {
    if (live == BAND)
      vblur_tile<CELL>(s_img, s_vb, tp);
    else
      vblur_tile<CELL / 2>(s_img, s_vb, tp);
  }
  __syncthreads();
  tree_tile(s_img, s_score, s_q, s_cnt, min_thr);
  __syncthreads();
  if (live == BAND)
    out_tile<CELL, false, BLUR>(s_score, s_vb, nullptr, dscore, dblur, y0, x0,
                                H, W, 0, 0, 0.f, tp);
  else
    out_tile<CELL / 2, false, BLUR>(s_score, s_vb, nullptr, dscore, dblur, y0,
                                    x0, H, W, 0, 0, 0.f, tp);
}

// 16-byte staging: Wp == W and the image (so every row) 16-byte aligned.
bool vector_staging(const float* img, int W) {
  return W % CHUNK == 0 && (reinterpret_cast<uintptr_t>(img) & 15) == 0;
}

// Opt a kernel into SMEM_BLUR bytes of dynamic shared memory and the
// largest shared-memory carveout (3 such blocks per SM), once per device:
// the attributes persist, so `done` keeps a bit per device already set.
template <typename K>
cudaError_t allow_blur_smem(K kernel, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_BLUR);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

std::atomic<uint64_t> select_smem_set{0}, corners_smem_set{0};

}  // namespace

extern "C" int mc_fast_select(const float* img, const int* heights,
                              const int* widths, float* blur, float* cand_v,
                              int* cand_rid, int LC, int H, int W,
                              float min_thr, float fast_thr, float t0,
                              float t1, float t2, float t3, float t4,
                              float t5, float t6, void* stream) {
  const int Wp = (W + CHUNK - 1) / CHUNK * CHUNK;
  const int ncx = Wp / CELL;
  const int nbands = (H + CELL - 1) / CELL;
  const Taps tp = {{t0, t1, t2, t3, t4, t5, t6}};
  const cudaError_t e = allow_blur_smem(fast_select_kernel, select_smem_set);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(Wp / CHUNK, (H + BAND - 1) / BAND, LC);
  fast_select_kernel<<<grid, THREADS, SMEM_BLUR, (cudaStream_t)stream>>>(
      img, heights, widths, blur, cand_v, cand_rid, H, W, Wp, ncx, nbands,
      min_thr, fast_thr, tp, vector_staging(img, W));
  return (int)cudaGetLastError();
}

// heights == nullptr selects mode full, otherwise mode hskip; blur ==
// nullptr leaves the blur out (the taps are then not read).
extern "C" int mc_fast_corners(const float* img, const int* heights,
                               float* score, float* blur, int LC, int H,
                               int W, float min_thr, float t0, float t1,
                               float t2, float t3, float t4, float t5,
                               float t6, void* stream) {
  const int Wp = (W + CHUNK - 1) / CHUNK * CHUNK;
  const Taps tp = {{t0, t1, t2, t3, t4, t5, t6}};
  const bool vec = vector_staging(img, W);
  dim3 grid(Wp / CHUNK, (H + BAND - 1) / BAND, LC);
  if (blur != nullptr) {
    const cudaError_t e =
        allow_blur_smem(fast_corners_kernel<true>, corners_smem_set);
    if (e != cudaSuccess) return (int)e;
    fast_corners_kernel<true><<<grid, THREADS, SMEM_BLUR,
                                (cudaStream_t)stream>>>(
        img, heights, score, blur, H, W, Wp, min_thr, tp, vec);
  } else {
    fast_corners_kernel<false><<<grid, THREADS, SMEM_NOBLUR,
                                 (cudaStream_t)stream>>>(
        img, heights, score, blur, H, W, Wp, min_thr, tp, vec);
  }
  return (int)cudaGetLastError();
}
