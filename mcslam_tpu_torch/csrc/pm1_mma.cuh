// Hamming distances of 256-bit descriptors on the tensor cores: +-1 bit
// planes and int8 mma.sync m16n8k32 (s8 x s8 -> s32), shared by the gated
// matcher (hamming_argmin2.cu) and the intra-rig pair match
// (intra_match.cu).
//
// A descriptor's 256 bits become 256 bytes of +-1 (bit 1 -> +1, 0 -> -1);
// the dot product of two such planes is 256 - 2 popcount(a ^ b), exact in
// int32, so a distance is (256 - dot) / 2.
//
// Layout: a warp computes 16 rows x 8 columns per n8 tile. Thread (g =
// lane / 4, t = lane % 4) holds rows g and g + 8 (the A fragments) and
// columns 2t, 2t + 1 of the tile's result. The descriptor bit behind each
// k slot is the same for A and B (thread t of a quad holds words 2t,
// 2t + 1; k step s their byte s), which is all the product needs. Column
// planes are staged in shared memory, 256 bytes a column, in 16-byte
// chunks swizzled so that the fragment loads are free of bank conflicts.

#pragma once

#include <stdint.h>

namespace pm1 {

// 4 descriptor bits -> 4 bytes of +-1 (bit i -> byte i: 1 -> +1, 0 -> -1)
__device__ __forceinline__ uint32_t expand(uint32_t nib) {
  const uint32_t ones = (nib * 0x00204081u) & 0x01010101u;
  return ~(ones * 0xFEu);
}

// byte offset of 16-byte chunk q (0..15) of column c's 256-byte plane
__device__ __forceinline__ int chunk_off(int c, int q) {
  return c * 256 + ((q ^ (((q >> 3) & 1) << 1) ^ (c & 1)) << 4);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Words [part * NW, part * NW + NW) of column c (NW = 8 / threads per
// column) as +-1 planes into s_bp: chunk part * 2 NW + i holds the 16 bits
// of half word i.
template <int NW>
__device__ __forceinline__ void stage_column(unsigned char* s_bp, int c,
                                             int part,
                                             const uint32_t (&w)[NW]) {
#pragma unroll
  for (int i = 0; i < 2 * NW; ++i) {
    const uint32_t x = (w[i >> 1] >> (16 * (i & 1))) & 0xFFFFu;
    *reinterpret_cast<uint4*>(s_bp + chunk_off(c, part * 2 * NW + i)) =
        make_uint4(expand(x & 0xF), expand((x >> 4) & 0xF),
                   expand((x >> 8) & 0xF), expand(x >> 12));
  }
}

// The A fragments of a warp's rows g and g + 8 from their words 2t, 2t + 1
__device__ __forceinline__ void a_fragments(uint2 xg, uint2 x8,
                                            uint32_t (&af)[8][4]) {
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const uint32_t bg = ((s < 4 ? xg.x : xg.y) >> (8 * (s & 3))) & 0xFFu;
    const uint32_t b8 = ((s < 4 ? x8.x : x8.y) >> (8 * (s & 3))) & 0xFFu;
    af[s][0] = expand(bg & 0xF);
    af[s][1] = expand(b8 & 0xF);
    af[s][2] = expand(bg >> 4);
    af[s][3] = expand(b8 >> 4);
  }
}

// The +-1 dot products of rows (g, g + 8) x local columns (8 jt + 2t,
// 8 jt + 2t + 1): dot[0] (g, 2t), dot[1] (g, 2t + 1), dot[2] (g + 8, 2t),
// dot[3] (g + 8, 2t + 1). Two accumulator chains (even and odd k steps),
// summed exactly.
__device__ __forceinline__ void tile_dot(const unsigned char* s_bp, int jt,
                                         int g, int t,
                                         const uint32_t (&af)[8][4],
                                         int (&dot)[4]) {
  int acc0[4] = {0, 0, 0, 0}, acc1[4] = {0, 0, 0, 0};
  const int cB = jt * 8 + g;
#pragma unroll
  for (int sp = 0; sp < 4; ++sp) {
    const uint4 v =
        *reinterpret_cast<const uint4*>(s_bp + chunk_off(cB, 4 * t + sp));
    mma_s8(acc0, af[2 * sp], v.x, v.y);
    mma_s8(acc1, af[2 * sp + 1], v.z, v.w);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) dot[k] = acc0[k] + acc1[k];
}

}  // namespace pm1
