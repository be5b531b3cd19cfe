// B11's decode gemv on the tensor cores' warp product (mma.sync): the
// k-step machinery of qmatmul.cuh's gemv_w8_kernel.
//
// A few rows of x (a decode batch) times an INT8 weight W [K, N] (N
// contiguous) that is read once: the weights are the product's A operand
// (16 output columns by 16 k) and x its B operand (8 rows of x),
// transposed from the usual roles, so that M <= 8 rows fill one n-tile
// of 8 and the weight, not x, fills the 16 rows of the instruction.
//
// A warp's k-step is 16 rows of W by 128 columns, one 2 KB slot of the
// warp's ring in shared memory, filled by the tensor memory accelerator
// (TMA: a 128-byte box of 16 rows, 128-byte swizzled, 256-byte L2
// promotion) under an mbarrier a slot; lane 0 issues the copy, every lane
// waits on the barrier. TMA copies hold none of the SM's load slots, so a
// warp keeps a whole ring of k-steps in flight (with 16-byte cp.async a
// lane the SM's outstanding loads capped the stream near 1.7 TB/s). Lane
// (g = lane / 4, c = lane % 4) multiplies the 16 columns 16 g .. 16 g +
// 15 of the k-step's rows 2c, 2c + 1, 2c + 8, 2c + 9, read back from the
// swizzled box (`chunk`: no bank conflict). Its 16 columns are 8 products
// of two columns each (product j: columns 2j and 2j + 1 as the
// instruction's rows g and g + 8), so its accumulators hold
//   acc[j] = {(col 16g+2j, x row 2c), (col 16g+2j, x row 2c+1),
//             (col 16g+2j+1, x row 2c), (col 16g+2j+1, x row 2c+1)}.
//
// The A operand: the pairs of consecutive k of a column come from two
// rows; each byte, made offset-binary, is the low byte of the f32 2^23 + u
// (prmt), 2^23 + 128 is subtracted (exact) and the two upper halves make
// the bf16 pair (prmt): exact. x is staged in shared memory as [plane][k
// pair][R rows] bf16 pairs, R a power of two up to 16: the lane's B operand
// is x row (8 t + g) & (R - 1) of n-tile t, so rows past the batch read a
// staged row again and feed only outputs that are never stored. f32 x is
// three bf16 planes that sum to it exactly (three products).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace mgv {

constexpr int kCols = 128;             // columns of a k-step, and a tile
constexpr int kStep = 16;              // rows of a k-step
constexpr int kBytes = kStep * kCols;  // a k-step's slot

// The lane's row i (0..3) of a k-step.
__device__ __forceinline__ int step_row(int i, int c) {
  return 2 * c + (i & 1) + (i >> 1) * 8;
}

// Lane 0: one k-step into `slot` (1024-byte aligned), counted on `bar`:
// the box of 128 columns by 16 rows of the tensor map at (col, row).
__device__ __forceinline__ void fill_step(uint8_t* slot, uint64_t* bar,
                                          const void* map, int col,
                                          int row) {
  hop::mbar_arrive_tx(bar, kBytes);
  hop::tma_load_2d(slot, map, col, row, bar);
}

// The lane's 16 bytes of its row i of a k-step's slot, as the 128-byte
// swizzle lays the box out (chunk q of row r at q ^ (r % 8)).
__device__ __forceinline__ uint4 chunk(const uint8_t* slot, int i) {
  const int lane = threadIdx.x % 32;
  return *reinterpret_cast<const uint4*>(
      slot + hop::swz(step_row(i, lane % 4), lane / 4));
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The products of one k-step: the slot's weights times x's stage at pair
// kp0 (the k-step's first), planes `plane` words apart, into acc [NT
// n-tiles][8 products][4].
template <int NT, int P>
__device__ __forceinline__ void step_products(const uint8_t* slot,
                                              const uint32_t* stage, int kp0,
                                              int plane, int R,
                                              float (&acc)[NT][8][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
  uint4 r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = chunk(slot, i);
  uint32_t b[NT][P][2];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int row = (8 * t + g) & (R - 1);
      b[t][p][0] = stage[(p * plane + kp0 + c) * R + row];
      b[t][p][1] = stage[(p * plane + kp0 + c + 4) * R + row];
    }
  constexpr float kBias = 8388736.0f;  // 2^23 + 128
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float f[4][4];  // [row][column 4q + e]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t u = word(r[i], q) ^ 0x80808080u;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f[i][e] =
            __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + e)) - kBias;
    }
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int ca = 2 * h2, cb = 2 * h2 + 1;
      const uint32_t A[4] = {hop::i8pair_bf16(f[0][ca], f[1][ca]),
                             hop::i8pair_bf16(f[0][cb], f[1][cb]),
                             hop::i8pair_bf16(f[2][ca], f[3][ca]),
                             hop::i8pair_bf16(f[2][cb], f[3][cb])};
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int p = 0; p < P; ++p)
          hop::mma_16816(acc[t][2 * q + h2], A, b[t][p]);
    }
  }
}

// The warps' sums of a tile of 128 columns: each warp's acc go through
// `red` ([WARPS][4 rows][128] floats) four x rows a round and are added in
// warp order, then out(m, n, v) runs for x rows m < rows and columns n <
// 128. Local column 16 g + i of the tile sits at i * 8 + g of a row, so
// the lanes of one product meet no bank twice.
template <int WARPS, int NT, typename F>
__device__ __forceinline__ void reduce_warps(const float (&acc)[NT][8][4],
                                             float* red, int rows, F&& out) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, c = lane % 4;
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r0 = 8 * t + 4 * half;  // the round's first x row
      if (r0 >= rows) continue;         // uniform
      __syncthreads();
      if (c / 2 == half) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rr = 2 * c - 4 * half + (e & 1);
            const int i = 2 * j + (e >> 1);
            red[(warp * 4 + rr) * kCols + i * 8 + g] = acc[t][j][e];
          }
      }
      __syncthreads();
      for (int o = threadIdx.x; o < 4 * kCols; o += 32 * WARPS) {
        const int rr = o / kCols, phys = o % kCols, m = r0 + rr;
        if (m >= rows) continue;
        const float* p = red + rr * kCols + phys;
        float v = p[0];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) v += p[w * 4 * kCols];
        out(m, 16 * (phys % 8) + phys / 8, v);
      }
    }
}

}  // namespace mgv
