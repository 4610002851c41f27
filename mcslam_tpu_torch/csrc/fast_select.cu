// FAST-9/16 + 3x3 NMS + 7-tap blur over 16-row bands: two entries.
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
// kernel's edge padding + lane roll). Band skip rule: mc_fast_select and
// mc_fast_corners in mode hskip with the blur write zeros for a 16-row band
// starting at or beyond the image's true height h; mode hskip without the
// blur already from h - 3 (the caller masks those score rows, and no blur
// row is needed); mode full never skips.
//
// Bound on the card: memory. At the production shape (16 x 480 x 640)
// mc_fast_select reads the 19.7 MB image once and writes the 19.7 MB blur
// plus ~0.6 MB of candidates; mc_fast_corners reads the image and writes
// the 19.7 MB score map, plus the 19.7 MB blur when asked: ~59 MB, so
// ~18 us at 3.35 TB/s (~39 MB, ~12 us without the blur). The arithmetic
// (~300 ops/pixel for the two arc trees) stays far below the ALU roof.
// Design: one block per (image, 16-row band, 128-column chunk) stages the
// band plus a 4-pixel halo (24 x 136 floats, 13 KB) in shared memory once;
// score, NMS, blur and the selection all read that tile, so each pixel is
// loaded from device memory ~1.5 times and in mc_fast_select the dense
// score map never leaves shared memory. The selection is one warp per
// cell: 4 rounds of a warp-shuffle argmax on (value desc, rid asc) with
// the winner knocked out.

#include <cuda_runtime.h>

namespace {

constexpr int CELL = 16;
constexpr int KSEL = 4;
constexpr int CHUNK = 128;
constexpr int HALO = 4;
constexpr int BORDER = 3;
constexpr int SROWS = CELL + 2 * HALO;  // 24 staged rows
constexpr int SCOLS = CHUNK + 2 * HALO;  // 136 staged columns
constexpr int ZROWS = CELL + 2;  // score rows: band +- 1 (NMS halo)
constexpr int ZCOLS = CHUNK + 2;
constexpr int BCOLS = CHUNK + 6;  // vertical-blur columns: chunk +- 3
constexpr int THREADS = 256;
constexpr int CELLS_PER_BLOCK = CHUNK / CELL;  // 8 = one per warp

__constant__ int kDY[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                            3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kDX[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                            0, -1, -2, -3, -3, -3, -2, -1};

__device__ __forceinline__ bool better(float v2, int r2, float v1, int r1) {
  return (v2 > v1) || (v2 == v1 && r2 < r1);
}

// The band's rows y0-4 .. y0+19 and columns x0-4 .. x0+131 of image src.
__device__ __forceinline__ void stage_band(const float* __restrict__ src,
                                           float (*s_img)[SCOLS], int y0,
                                           int x0, int H, int W, int Wp) {
  for (int i = threadIdx.x; i < SROWS * SCOLS; i += THREADS) {
    const int r = i / SCOLS, c = i % SCOLS;
    const int y = min(max(y0 - HALO + r, 0), H - 1);
    int x = (x0 - HALO + c) % Wp;
    if (x < 0) x += Wp;
    x = min(x, W - 1);
    s_img[r][c] = src[(size_t)y * W + x];
  }
}

// FAST score for rows y0-1 .. y0+16 and columns x0-1 .. x0+128. An interior
// pixel's circle lies inside the image, so it reads true pixels only;
// everything else is zero.
__device__ __forceinline__ void score_tile(float (*s_img)[SCOLS],
                                           float (*s_score)[ZCOLS], int y0,
                                           int x0, int H, int W,
                                           float min_thr) {
  for (int i = threadIdx.x; i < ZROWS * ZCOLS; i += THREADS) {
    const int r = i / ZCOLS, c = i % ZCOLS;
    const int y = y0 - 1 + r, x = x0 - 1 + c;
    float sc = 0.f;
    if (y >= BORDER && y < H - BORDER && x >= BORDER && x < W - BORDER) {
      const int sr = r - 1 + HALO, scn = c - 1 + HALO;
      const float ctr = s_img[sr][scn];
      float d[16];
#pragma unroll
      for (int s = 0; s < 16; ++s) d[s] = s_img[sr + kDY[s]][scn + kDX[s]] - ctr;
      float bright = __int_as_float(0xff800000), dark = bright;
#pragma unroll
      for (int s = 0; s < 16; ++s) {
        float mb = d[s], md = -d[s];
#pragma unroll
        for (int j = 1; j < 9; ++j) {
          mb = fminf(mb, d[(s + j) & 15]);
          md = fminf(md, -d[(s + j) & 15]);
        }
        bright = fmaxf(bright, mb);
        dark = fmaxf(dark, md);
      }
      const float v = fmaxf(bright, dark);
      sc = v > min_thr ? v : 0.f;
    }
    s_score[r][c] = sc;
  }
}

// Vertical blur pass for columns x0-3 .. x0+130 (staged column c + 1).
__device__ __forceinline__ void vblur_tile(float (*s_img)[SCOLS],
                                           float (*s_vb)[BCOLS],
                                           const float* s_taps) {
  for (int i = threadIdx.x; i < CELL * BCOLS; i += THREADS) {
    const int r = i / BCOLS, c = i % BCOLS;
    float acc = __fmul_rn(s_img[r + HALO - 3][c + 1], s_taps[0]);
#pragma unroll
    for (int t = 1; t < 7; ++t)
      acc = __fadd_rn(acc, __fmul_rn(s_img[r + HALO - 3 + t][c + 1], s_taps[t]));
    s_vb[r][c] = acc;
  }
}

// 3x3 NMS of band pixel (r, c): the score if it is >= all 8 neighbours
// and > 0, else 0.
__device__ __forceinline__ float nms_at(float (*s_score)[ZCOLS], int r,
                                        int c) {
  const float mid = s_score[r + 1][c + 1];
  float pooled = mid;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx)
      pooled = fmaxf(pooled, s_score[r + 1 + dy][c + 1 + dx]);
  return (mid >= pooled && mid > 0.f) ? mid : 0.f;
}

// Horizontal blur pass at band pixel (r, c).
__device__ __forceinline__ float hblur_at(float (*s_vb)[BCOLS],
                                          const float* s_taps, int r, int c) {
  float out = __fmul_rn(s_vb[r][c], s_taps[0]);
#pragma unroll
  for (int t = 1; t < 7; ++t)
    out = __fadd_rn(out, __fmul_rn(s_vb[r][c + t], s_taps[t]));
  return out;
}

// Zero the band's (y < H, x < W) pixels of an output map.
__device__ __forceinline__ void zero_band(float* dst, int y0, int x0, int H,
                                          int W) {
  for (int i = threadIdx.x; i < CELL * CHUNK; i += THREADS) {
    const int y = y0 + i / CHUNK, x = x0 + i % CHUNK;
    if (y < H && x < W) dst[(size_t)y * W + x] = 0.f;
  }
}

__global__ void __launch_bounds__(THREADS) fast_select_kernel(
    const float* __restrict__ img, const int* __restrict__ heights,
    const int* __restrict__ widths, const float* __restrict__ taps_g,
    float* __restrict__ blur, float* __restrict__ cand_v,
    int* __restrict__ cand_rid, int H, int W, int Wp, int ncx, int nbands,
    float min_thr, float fast_thr) {
  const int chunk = blockIdx.x;
  const int band = blockIdx.y;
  const int im = blockIdx.z;
  const int y0 = band * CELL;
  const int x0 = chunk * CHUNK;
  const int tid = threadIdx.x;
  const int h_img = heights[im];
  const int w_img = widths[im];
  const float* src = img + (size_t)im * H * W;
  float* dst = blur + (size_t)im * H * W;
  const size_t cbase =
      ((size_t)im * nbands * ncx + (size_t)band * ncx +
       (size_t)chunk * CELLS_PER_BLOCK) * KSEL;

  if (y0 >= h_img) {  // band at or beyond the true height: zeros
    zero_band(dst, y0, x0, H, W);
    for (int i = tid; i < CELLS_PER_BLOCK * KSEL; i += THREADS) {
      cand_v[cbase + i] = 0.f;
      cand_rid[cbase + i] = 0;
    }
    return;
  }

  __shared__ float s_img[SROWS][SCOLS];
  __shared__ float s_score[ZROWS][ZCOLS];
  __shared__ float s_sel[CELL][CHUNK];
  __shared__ float s_vb[CELL][BCOLS];
  __shared__ float s_taps[7];

  if (tid < 7) s_taps[tid] = taps_g[tid];
  stage_band(src, s_img, y0, x0, H, W, Wp);
  __syncthreads();
  score_tile(s_img, s_score, y0, x0, H, W, min_thr);
  vblur_tile(s_img, s_vb, s_taps);
  __syncthreads();

  // NMS + true-bounds mask + rank bonus; horizontal blur pass
  for (int i = tid; i < CELL * CHUNK; i += THREADS) {
    const int r = i / CHUNK, c = i % CHUNK;
    float v = nms_at(s_score, r, c);
    const int y = y0 + r, x = x0 + c;
    if (!(y < h_img - BORDER && x < w_img - BORDER)) v = 0.f;
    if (v > fast_thr) v = v + 1.0f;
    s_sel[r][c] = v;
    if (y < H && x < W) dst[(size_t)y * W + x] = hblur_at(s_vb, s_taps, r, c);
  }
  __syncthreads();

  // per-cell top-4: warp w owns cell w of the chunk; lane l holds rids
  // l, l+32, ..., l+224 (raster offset rid = row * 16 + col)
  const int warp = tid >> 5, lane = tid & 31;
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int rid = lane + 32 * j;
    v[j] = s_sel[rid / CELL][warp * CELL + rid % CELL];
  }
  for (int round = 0; round < KSEL; ++round) {
    float bv = v[0];
    int br = lane;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      if (better(v[j], lane + 32 * j, bv, br)) {
        bv = v[j];
        br = lane + 32 * j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int orr = __shfl_xor_sync(0xffffffffu, br, off);
      if (better(ov, orr, bv, br)) {
        bv = ov;
        br = orr;
      }
    }
    if ((br & 31) == lane) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (br == lane + 32 * j) v[j] = -1.0f;  // knocked out
    }
    if (lane == 0) {
      cand_v[cbase + warp * KSEL + round] = bv;
      cand_rid[cbase + warp * KSEL + round] = br;
    }
  }
}

// heights == nullptr: mode full (no band skipped). BLUR: also write the
// blur (and skip from h instead of h - 3 in mode hskip).
template <bool BLUR>
__global__ void __launch_bounds__(THREADS) fast_corners_kernel(
    const float* __restrict__ img, const int* __restrict__ heights,
    const float* __restrict__ taps_g, float* __restrict__ score,
    float* __restrict__ blur, int H, int W, int Wp, float min_thr) {
  const int y0 = blockIdx.y * CELL;
  const int x0 = blockIdx.x * CHUNK;
  const int im = blockIdx.z;
  const int tid = threadIdx.x;
  const float* src = img + (size_t)im * H * W;
  float* dscore = score + (size_t)im * H * W;
  float* dblur = BLUR ? blur + (size_t)im * H * W : nullptr;

  if (heights != nullptr &&
      y0 >= (BLUR ? heights[im] : heights[im] - BORDER)) {
    zero_band(dscore, y0, x0, H, W);
    if (BLUR) zero_band(dblur, y0, x0, H, W);
    return;
  }

  __shared__ float s_img[SROWS][SCOLS];
  __shared__ float s_score[ZROWS][ZCOLS];
  __shared__ float s_vb[BLUR ? CELL : 1][BLUR ? BCOLS : 1];
  __shared__ float s_taps[7];

  if (BLUR && tid < 7) s_taps[tid] = taps_g[tid];
  stage_band(src, s_img, y0, x0, H, W, Wp);
  __syncthreads();
  score_tile(s_img, s_score, y0, x0, H, W, min_thr);
  if constexpr (BLUR) vblur_tile(s_img, s_vb, s_taps);
  __syncthreads();

  for (int i = tid; i < CELL * CHUNK; i += THREADS) {
    const int r = i / CHUNK, c = i % CHUNK;
    const int y = y0 + r, x = x0 + c;
    if (y < H && x < W) {
      dscore[(size_t)y * W + x] = nms_at(s_score, r, c);
      if constexpr (BLUR) dblur[(size_t)y * W + x] = hblur_at(s_vb, s_taps, r, c);
    }
  }
}

}  // namespace

extern "C" int mc_fast_select(const float* img, const int* heights,
                              const int* widths, const float* taps,
                              float* blur, float* cand_v, int* cand_rid,
                              int LC, int H, int W, float min_thr,
                              float fast_thr, void* stream) {
  const int Wp = (W + CHUNK - 1) / CHUNK * CHUNK;
  const int ncx = Wp / CELL;
  const int nbands = (H + CELL - 1) / CELL;
  dim3 grid(Wp / CHUNK, nbands, LC);
  fast_select_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      img, heights, widths, taps, blur, cand_v, cand_rid, H, W, Wp, ncx,
      nbands, min_thr, fast_thr);
  return (int)cudaGetLastError();
}

// heights == nullptr selects mode full, otherwise mode hskip; blur ==
// nullptr leaves the blur out (taps is then not read).
extern "C" int mc_fast_corners(const float* img, const int* heights,
                               const float* taps, float* score, float* blur,
                               int LC, int H, int W, float min_thr,
                               void* stream) {
  const int Wp = (W + CHUNK - 1) / CHUNK * CHUNK;
  dim3 grid(Wp / CHUNK, (H + CELL - 1) / CELL, LC);
  if (blur != nullptr)
    fast_corners_kernel<true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        img, heights, taps, score, blur, H, W, Wp, min_thr);
  else
    fast_corners_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        img, heights, taps, score, blur, H, W, Wp, min_thr);
  return (int)cudaGetLastError();
}
