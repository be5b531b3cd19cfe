// Quantized-weight matrix products for Hopper, shared by int8_matmul.cu
// (B10 int8_matmul, B11 w8_matmul) and int4_matmul.cu (B12 w4_matmul);
// B10's multi-row product (M > 16) is the INT8 tensor-core kernel of
// imma.cuh, which shares this file's epilogue, and B11's with bf16 x is
// int8_matmul.cu's w8_wgmma_kernel.
//
//   out[M, N] = act(epilogue(x[M, K] @ W[K, N]) + bias[N])
//
// Three kinds of operands:
//   kI8A8  x int8 (per-row scale), W int8 [K, N]: s8 x s8 summed in s32,
//          then (float)acc * x_scale[m] * w_scale[n]          (B10)
//   kW8    x f32/bf16, W int8 [K, N]: f32 sums of x * (float)q, then
//          acc * w_scale[n]                                    (B11)
//   kW4    x f32/bf16, W int4 in the block-local nibble carrier [K, N/2]
//          (quant/tensor.py::pack_int4 for block width bn), group-wise
//          scales [K/group, N]: f32 sums of x * (q * scale)     (B12)
// W keeps the JAX package's layout (N contiguous), so no weight is ever
// transposed or repacked for the card.
//
// The epilogue follows the JAX kernels' order: acc -> f32, * x_scale,
// * w_scale + bias, the activation, one rounding to the output type. Each
// step rounds on its own (__fmul_rn and __fadd_rn are never contracted)
// except `* w_scale + bias`, which is one fused multiply-add (__fmaf_rn),
// as XLA compiles the JAX epilogue. For kI8A8 the s32 sums are exact
// whatever the order, and
// the int -> f32 conversion happens once, on the final s32 sum; so the
// kernel and its plain version agree bit for bit. Split-K partial sums of
// kI8A8 are s32 too, never f32.
//
// What bounds them on the H100: decode (M <= 16) is a matrix-vector
// product that reads every weight byte once per call, so bytes bound it
// (qkv of Llama-3-8B: 25 MB of INT8, 7.5 us at 3.35 TB/s). Prefill
// (M = 256 and up) is bound by operations at the tensor cores' rates and
// by the weight stream: kI8A8 takes imma.cuh's wgmma kernel there, kW8
// with bf16 x int8_matmul.cu's w8_wgmma_kernel, kW4 with bf16 x
// int4_matmul.cu's w4_wgmma_kernel; kW8 and kW4 with f32 x (the tensor
// cores have no exact f32 product) take the CUDA-core tiled_kernel below.
//
// Three kernels here: gemv_kernel for kI8A8 and kW8, gemv_w4_kernel for
// kW4, tiled_kernel for kW8 and kW4.
//
// gemv_kernel (M <= 16, aligned shapes): each block owns 128 output
// columns and 4 rows of x; its 256 threads are 8 column chunks of 16
// columns times 32 k-lanes, each k-lane taking 4 consecutive rows of W
// per step with one 16-byte load per row (8 bytes for int4: 8 carrier
// bytes are 16 columns), so a warp reads 4 whole 128-byte lines per step.
// kI8A8 transposes the 4x16 bytes in registers (__byte_perm) into
// column words of 4 consecutive k and sums them with __dp4a; kW8 widens
// weights with the exponent trick (2^23 + byte, then a subtraction)
// instead of the slow I2F conversion. The k-lanes reduce by
// warp shuffles and shared memory in a fixed order. Where the column
// blocks alone cannot fill the 132 SMs, grid.y splits K: each split
// writes its partial sums to a workspace, and the last block of a column
// block to finish (a per-tile counter, reset by that block) adds the
// splits in order and runs the epilogue: deterministic, and exact for
// kI8A8.
//
// gemv_w4_kernel (kW4, M <= 16): at half a byte a weight, instruction
// issue, not bytes, runs out first on the CUDA cores (a conversion and a
// multiply by the scale per weight, then M FMAs), so the products go to
// the tensor cores (mma.sync m16n8k16, bf16 in, f32 sums), transposed: the
// weights are the A operand, x the B operand (its 8 columns: 8 rows of x a
// block). A block owns a run of 128 carrier columns (256 outputs) and 8
// rows of x; each lane reads 16 carrier bytes (32 columns) of 4 rows a
// k-step of 16 rows, and builds each A pair of consecutive k from the same
// byte of two rows (prmt, lop3 under the bf16 128, a bf16x2 subtraction:
// exact). The weights come through a ring of kW4Ring k-steps a warp in
// shared memory, by cp.async (three k-steps in flight beyond the one
// being multiplied, no register held for them).
// x's rows for the block's K range are staged in shared memory once, as
// bf16 pairs: bf16 x as it is, f32 x as three bf16 that sum to it exactly
// (three products, so f32 x loses nothing either). The K range is cut
// into units of U rows inside one K-group (w4_unit: 64, or the group);
// warp w takes units w, w + 8, ..., and each unit's f32 sums, times the
// group's scales (one multiply-add a unit and output, not a multiply a
// weight), go into the lane's running sums. The warps' sums meet in shared
// memory in warp order; K splits and their last-block merge in split order
// are gemv_kernel's.
//
// tiled_kernel (kW8 and kW4, any M, K, N): a plain shared-memory tiled
// product, 64x64 outputs per block, k-tiles of 32, 4x4 outputs per
// thread, f32 FMA, with every edge masked: the route of f32 x past 16
// rows (on no path of the card) and of layouts no other kernel takes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "hopper.cuh"

namespace qmm {

enum Kind { kI8A8 = 0, kW8 = 1, kW4 = 2 };
enum Act { kNone = 0, kRelu = 1, kGelu = 2, kSilu = 3 };
enum DType { kF32 = 0, kBF16 = 1 };

constexpr int kThreads = 256;
// gemv_kernel
constexpr int kRows = 4;                        // rows of x per block
constexpr int kChunks = 8;                      // column chunks per block
constexpr int kChunkCols = 16;                  // columns per chunk
constexpr int kBlockCols = kChunks * kChunkCols;  // 128
constexpr int kKLanes = kThreads / kChunks;     // 32
constexpr int kQuad = 4;                        // rows per k-lane step
constexpr int kWarps = kThreads / 32;
// gemv_w4_kernel: K rows of x staged a block, times its planes (64 KB);
// k-steps of weights in flight a warp (a ring of 2 KB slots in shared
// memory); its dynamic shared memory
constexpr int kW4Stage = 4096;
constexpr int kW4Ring = 4;
constexpr int kW4Smem = kW4Stage * 8 * 2 + kWarps * kW4Ring * 2048;
// tiled_kernel
constexpr int kTileM = 64, kTileN = 64, kTileK = 32, kPad = 4;

// gemv_w4_kernel's unit of K rows for a K-group of `group` rows (the host
// needs unit % 16 == 0 and unit <= kW4Stage)
__host__ __device__ inline int w4_unit(int group) {
  return group % 64 == 0 ? 64 : group;
}

struct Args {
  const void* x;          // [M, K]: int8 (kI8A8), f32 or bf16
  const float* x_scale;   // [M] (kI8A8)
  const void* w;          // int8 [K, N], or the int4 carrier [K, N/2]
  const float* w_scale;   // [N] (int8), or [K/group, N] (int4)
  const float* bias;      // [N] f32, or null
  void* out;              // [M, N] f32 or bf16
  void* partials;         // [splits, M, N] accumulator type (splits > 1)
  int* counters;          // one zeroed int per (column block, row tile)
  int M, K, N;
  int splits, k_per_split;  // k_per_split % 4 == 0
  int group, bn;            // kW4
  int act;
};

template <int KIND>
struct AccT {
  using type = float;
};
template <>
struct AccT<kI8A8> {
  using type = int;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The activations of ops/common.py::activation_fn, written as PyTorch's
// own CUDA kernels write them (ActivationGeluKernel.cu with
// approximate="tanh", ActivationSiluKernel.cu), so the kernel's epilogue
// and the plain version's round alike.
__device__ __forceinline__ float activate(float x, int act) {
  if (act == kRelu) return isnan(x) ? x : (x > 0.0f ? x : 0.0f);
  if (act == kGelu) {
    constexpr float kBeta = M_SQRT2 * M_2_SQRTPI * 0.5;
    constexpr float kKappa = 0.044715;
    const float x_cube = x * x * x;
    const float inner = kBeta * (x + kKappa * x_cube);
    return 0.5f * x * (1.0f + tanhf(inner));
  }
  if (act == kSilu) return x / (1.0f + expf(-x));
  return x;
}

template <typename OT>
__device__ __forceinline__ void store(void* out, long long i, float y) {
  if constexpr (std::is_same<OT, float>::value) {
    static_cast<float*>(out)[i] = y;
  } else {
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(y);
  }
}

template <int KIND, typename OT>
__device__ __forceinline__ void finish(const Args& a,
                                       typename AccT<KIND>::type acc, int m,
                                       int n) {
  float y;
  if constexpr (KIND == kW4) {
    y = a.bias != nullptr ? __fadd_rn(acc, a.bias[n]) : acc;
  } else {
    float s;
    if constexpr (KIND == kI8A8) {
      s = __fmul_rn(__int2float_rn(acc), a.x_scale[m]);
    } else {
      s = acc;
    }
    y = a.bias != nullptr ? __fmaf_rn(s, a.w_scale[n], a.bias[n])
                          : __fmul_rn(s, a.w_scale[n]);
  }
  store<OT>(a.out, static_cast<long long>(m) * a.N + n, activate(y, a.act));
}

// Four int8 in a word -> four floats, exactly: the byte, made offset-binary
// (q + 128), becomes the low mantissa bits of 2^23.
__device__ __forceinline__ void s8x4_to_f32(uint32_t u, float* f) {
  const uint32_t v = u ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7440 + i)) -
           8388736.0f;  // 2^23 + 128
}

// The int4 carrier byte of weight (k, n) and its value q in [-8, 7].
__device__ __forceinline__ int int4_at(const Args& a, int k, int n) {
  const int half = a.bn / 2;
  const int j = n / a.bn, t = n - j * a.bn;
  const int8_t* row = static_cast<const int8_t*>(a.w) +
                      static_cast<long long>(k) * (a.N / 2) + j * half;
  if (t < half) return (row[t] & 0xF) - 8;       // offset-binary low nibble
  return row[t - half] >> 4;                     // signed high nibble
}

template <int KIND, typename XT>
__device__ __forceinline__ float load_x(const Args& a, int m, int k) {
  return to_f32(static_cast<const XT*>(a.x)[static_cast<long long>(m) * a.K +
                                            k]);
}

template <int KIND>
__device__ __forceinline__ typename AccT<KIND>::type load_w(const Args& a,
                                                            int k, int n) {
  if constexpr (KIND == kW4) {
    return static_cast<float>(int4_at(a, k, n)) *
           a.w_scale[static_cast<long long>(k / a.group) * a.N + n];
  } else {
    const int q = static_cast<const int8_t*>(
        a.w)[static_cast<long long>(k) * a.N + n];
    return static_cast<typename AccT<KIND>::type>(q);
  }
}

// Output column of local column lc (0..127) of column block cb, or -1.
__device__ __forceinline__ int column_of(const Args& a, int cb, int lc) {
  const int n = cb * kBlockCols + lc;
  return n < a.N ? n : -1;
}

// ---------------------------------------------------------------------------
// gemv_kernel: grid (ceil(N / 128), splits, ceil(M / 4)).
// Needs: N % 16 == 0 with W 16-byte aligned, kI8A8 also K % 4 == 0 and x
// 4-byte aligned. The wrapper checks.
template <int KIND, typename XT, typename OT>
__global__ void __launch_bounds__(kThreads) gemv_kernel(Args a) {
  static_assert(KIND != kW4, "kW4 takes gemv_w4_kernel");
  using Acc = typename AccT<KIND>::type;
  __shared__ Acc red[kWarps][kRows][kBlockCols];
  __shared__ int is_last;
  const int c = threadIdx.x % kChunks, kl = threadIdx.x / kChunks;
  const int warp = threadIdx.x / 32;
  const int m0 = blockIdx.z * kRows;
  const int chunk = blockIdx.x * kChunks + c;
  const int k_begin = blockIdx.y * a.k_per_split;
  const int k_end = min(a.K, k_begin + a.k_per_split);

  Acc acc[kRows][kChunkCols];
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int i = 0; i < kChunkCols; ++i) acc[m][i] = Acc(0);

  const int n0 = chunk * kChunkCols;
  const bool valid = n0 < a.N;
  const long long wstride = a.N;
  const uint8_t* wbase = static_cast<const uint8_t*>(a.w) + n0;

  if (valid) {
    for (int k = k_begin + kl * kQuad; k < k_end; k += kKLanes * kQuad) {
      if constexpr (KIND == kI8A8) {
        // K % 4 == 0 and k_per_split % 4 == 0: the quad lies inside
        uint4 w[kQuad];
#pragma unroll
        for (int r = 0; r < kQuad; ++r)
          w[r] = __ldg(reinterpret_cast<const uint4*>(
              wbase + static_cast<long long>(k + r) * wstride));
        int xq[kRows];
#pragma unroll
        for (int m = 0; m < kRows; ++m)
          xq[m] = m0 + m < a.M
                      ? __ldg(reinterpret_cast<const int*>(
                            static_cast<const int8_t*>(a.x) +
                            static_cast<long long>(m0 + m) * a.K + k))
                      : 0;
        const uint32_t words[kQuad][4] = {{w[0].x, w[0].y, w[0].z, w[0].w},
                                          {w[1].x, w[1].y, w[1].z, w[1].w},
                                          {w[2].x, w[2].y, w[2].z, w[2].w},
                                          {w[3].x, w[3].y, w[3].z, w[3].w}};
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          // rows k..k+3 of columns 4g..4g+3 -> one word of 4 k per column
          const uint32_t t0 = __byte_perm(words[0][g], words[1][g], 0x5140);
          const uint32_t t1 = __byte_perm(words[0][g], words[1][g], 0x7362);
          const uint32_t t2 = __byte_perm(words[2][g], words[3][g], 0x5140);
          const uint32_t t3 = __byte_perm(words[2][g], words[3][g], 0x7362);
          const int col[4] = {static_cast<int>(__byte_perm(t0, t2, 0x5410)),
                              static_cast<int>(__byte_perm(t0, t2, 0x7632)),
                              static_cast<int>(__byte_perm(t1, t3, 0x5410)),
                              static_cast<int>(__byte_perm(t1, t3, 0x7632))};
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int m = 0; m < kRows; ++m)
              acc[m][4 * g + j] = __dp4a(col[j], xq[m], acc[m][4 * g + j]);
        }
      } else {  // kW8
        uint4 w[kQuad];
#pragma unroll
        for (int r = 0; r < kQuad; ++r)
          w[r] = k + r < k_end
                     ? __ldg(reinterpret_cast<const uint4*>(
                           wbase + static_cast<long long>(k + r) * wstride))
                     : make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int r = 0; r < kQuad; ++r) {
          if (k + r >= k_end) break;
          float xf[kRows];
#pragma unroll
          for (int m = 0; m < kRows; ++m)
            xf[m] = m0 + m < a.M ? load_x<KIND, XT>(a, m0 + m, k + r) : 0.0f;
          float wf[kChunkCols];
          s8x4_to_f32(w[r].x, wf);
          s8x4_to_f32(w[r].y, wf + 4);
          s8x4_to_f32(w[r].z, wf + 8);
          s8x4_to_f32(w[r].w, wf + 12);
#pragma unroll
          for (int i = 0; i < kChunkCols; ++i)
#pragma unroll
            for (int m = 0; m < kRows; ++m)
              acc[m][i] = fmaf(xf[m], wf[i], acc[m][i]);
        }
      }
    }
  }

  // the 4 k-lanes of a warp that share a chunk are lanes c, c+8, c+16, c+24
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int i = 0; i < kChunkCols; ++i) {
      Acc v = acc[m][i];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][i] = v;
    }
  if (threadIdx.x % 32 < kChunks) {
#pragma unroll
    for (int m = 0; m < kRows; ++m)
#pragma unroll
      for (int i = 0; i < kChunkCols; ++i)
        red[warp][m][c * kChunkCols + i] = acc[m][i];
  }
  __syncthreads();

  Acc* partials = static_cast<Acc*>(a.partials);
  for (int o = threadIdx.x; o < kRows * kBlockCols; o += kThreads) {
    const int mm = o / kBlockCols, lc = o % kBlockCols;
    const int m = m0 + mm, n = column_of(a, blockIdx.x, lc);
    if (m >= a.M || n < 0) continue;
    Acc v = red[0][mm][lc];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += red[w][mm][lc];
    if (a.splits == 1) {
      finish<KIND, OT>(a, v, m, n);
    } else {
      partials[(static_cast<long long>(blockIdx.y) * a.M + m) * a.N + n] = v;
    }
  }
  if (a.splits == 1) return;

  // split-K: the last block of this column block and row tile to arrive
  // adds the splits' partial sums in order and runs the epilogue
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.z * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0)
    is_last = atomicAdd(&a.counters[tile], 1) == a.splits - 1;
  __syncthreads();
  if (!is_last) return;
  for (int o = threadIdx.x; o < kRows * kBlockCols; o += kThreads) {
    const int mm = o / kBlockCols, lc = o % kBlockCols;
    const int m = m0 + mm, n = column_of(a, blockIdx.x, lc);
    if (m >= a.M || n < 0) continue;
    Acc v = Acc(0);
    for (int s = 0; s < a.splits; ++s)
      v += __ldcg(&partials[(static_cast<long long>(s) * a.M + m) * a.N + n]);
    finish<KIND, OT>(a, v, m, n);
  }
  if (threadIdx.x == 0) a.counters[tile] = 0;
}

// ---------------------------------------------------------------------------
// gemv_w4_kernel: grid (ceil(N / 256), splits, ceil(M / 8)). Needs (bn / 2)
// % 16 == 0, x, the carrier and the scales 16-byte aligned, the unit U =
// w4_unit(group) a multiple of 16, and k_per_split a multiple of U with
// W4Planes<XT>::P * k_per_split <= kW4Stage. The wrapper checks.
template <typename XT>
struct W4Planes {
  static constexpr int P = 1;  // bf16 x: itself
};
template <>
struct W4Planes<float> {
  static constexpr int P = 3;  // f32 x: three bf16 that sum to it exactly
};

// Four f32 values of x as three planes of bf16 pairs whose sums are the
// values exactly: x1 = bf16(x), x2 = bf16(x - x1), x3 = x - x1 - x2 (f32's
// 24 significant bits in three bf16 of 8; each difference exact).
__device__ __forceinline__ void f32_planes(const uint4& raw,
                                           uint32_t (&w)[3][2]) {
  const float f[4] = {__uint_as_float(raw.x), __uint_as_float(raw.y),
                      __uint_as_float(raw.z), __uint_as_float(raw.w)};
  uint32_t h[3][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float r = f[e];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const __nv_bfloat16 v = __float2bfloat16_rn(r);
      h[p][e] = __bfloat16_as_ushort(v);
      r -= __bfloat162float(v);
    }
  }
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    w[p][0] = h[p][0] | h[p][1] << 16;
    w[p][1] = h[p][2] | h[p][3] << 16;
  }
}

template <typename XT, typename OT>
__global__ void __launch_bounds__(kThreads, 1) gemv_w4_kernel(Args a) {
  constexpr int P = W4Planes<XT>::P;
  constexpr int kM = 8;              // x rows a block: the product's n
  constexpr int kLocal = 256;        // output columns a block
  // x rows m0..m0+7 of the block's K range as P planes of bf16 pairs,
  // [p][k / 2][row] (after the main loop the warps' sums, [warp][4 rows]
  // [256 local columns], four x rows a round); then each warp's ring of
  // kW4Ring k-steps of weights, [slot][4 rows][32 lanes] of 16 bytes
  extern __shared__ __align__(16) uint8_t smem_dyn[];
  uint32_t* const stage = reinterpret_cast<uint32_t*>(smem_dyn);
  __shared__ int is_last;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, c = lane % 4;
  const int m0 = blockIdx.z * kM;
  const int k_begin = blockIdx.y * a.k_per_split;
  const int k_end = min(a.K, k_begin + a.k_per_split);
  const int nkp = (k_end - k_begin) / 2;
  const int U = w4_unit(a.group), units = (k_end - k_begin) / U;

  // The lane's 16 carrier bytes of a row: byte j holds the columns n_lo + j
  // (low nibble) and n_hi + j (high nibble). A k-step of 16 rows reads the
  // lane's rows 2c, 2c + 1, 2c + 8, 2c + 9 (a warp: 16 rows x 128 bytes),
  // and byte j of them is the product's A operand for columns n_lo + j and
  // n_hi + j of lanes g (its rows g and g + 8), k pairs formed across
  // the rows; B is x (its column g: x row m0 + g).
  const int half = a.bn / 2, cc0 = blockIdx.x * 128 + 16 * g;
  const bool valid = cc0 < a.N / 2;
  const int jb = cc0 / half;
  const int n_lo = jb * a.bn + (cc0 - jb * half), n_hi = n_lo + half;
  const uint8_t* wcol = static_cast<const uint8_t*>(a.w) + cc0;
  const long long wstride = a.N / 2;
  const int spu = U / 16;  // k-steps a unit
  const int nsteps = warp < units ? (units - warp + kWarps - 1) / kWarps * spu
                                  : 0;
  // The warp's k-steps: units warp, warp + 8, ..., spu k-steps each. The
  // next k-step to copy (its unit's first row, its step there, its count)
  // goes by cp.async into ring slot count % kW4Ring: its 4 rows of this
  // lane, which this lane alone reads back.
  uint4* const ring = reinterpret_cast<uint4*>(smem_dyn + kW4Stage * kM * 2) +
                      warp * kW4Ring * 128;
  int cp_k = k_begin + warp * U, cp_st = 0, cp_s = 0;
  auto issue = [&]() {
    const int k0 = cp_k + 16 * cp_st;
    uint4* slot = ring + (cp_s % kW4Ring) * 128;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = k0 + 2 * c + (i & 1) + (i >> 1) * 8;
      hop::cp_async16(slot + i * 32 + lane,
                      valid ? wcol + static_cast<long long>(row) * wstride
                            : a.w,
                      valid);
    }
    if (++cp_st == spu) {
      cp_st = 0;
      cp_k += kWarps * U;
    }
    ++cp_s;
  };
  // d = {lo column, rows 2c, 2c + 1; hi column, rows 2c, 2c + 1} of x
  float tot[16][4], part[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) tot[j][e] = 0.0f;
  // the products of a k-step on the 4 rows in r, x's pairs from kp0
  auto products = [&](const uint4 (&r)[4], int kp0) {
    uint32_t b[P][2];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      b[p][0] = stage[(p * nkp + kp0 + c) * kM + g];
      b[p][1] = stage[(p * nkp + kp0 + c + 4) * kM + g];
    }
    const uint32_t wv[4][4] = {{r[0].x, r[0].y, r[0].z, r[0].w},
                               {r[1].x, r[1].y, r[1].z, r[1].w},
                               {r[2].x, r[2].y, r[2].z, r[2].w},
                               {r[3].x, r[3].y, r[3].z, r[3].w}};
#pragma unroll
    for (int q = 0; q < 4; ++q) {      // the lane's carrier word q
      const uint32_t s0 = wv[0][q] >> 4, s1 = wv[1][q] >> 4;
      const uint32_t s2 = wv[2][q] >> 4, s3 = wv[3][q] >> 4;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {  // byte bb of each row's word
        const uint32_t sel = bb | (4 + bb) << 8;
        const uint32_t A[4] = {
            hop::nibble_pair(
                (__byte_perm(wv[0][q], wv[1][q], sel) & 0x000F000Fu) |
                0x43004300u),
            hop::nibble_pair((__byte_perm(s0, s1, sel) & 0x000F000Fu) ^
                             0x43084308u),
            hop::nibble_pair(
                (__byte_perm(wv[2][q], wv[3][q], sel) & 0x000F000Fu) |
                0x43004300u),
            hop::nibble_pair((__byte_perm(s2, s3, sel) & 0x000F000Fu) ^
                             0x43084308u)};
#pragma unroll
        for (int p = 0; p < P; ++p) hop::mma_16816(part[4 * q + bb], A, b[p]);
      }
    }
  };
  // kW4Ring - 1 k-steps of weights in flight beyond the one being
  // multiplied (a group of copies a k-step, empty past the last)
#pragma unroll
  for (int s = 0; s < kW4Ring - 1; ++s) {
    if (s < nsteps) issue();
    hop::cp_async_commit();
  }
  // x's rows of the block, while the first weights are on their way
  // (16-byte loads, all issued before they are used); a row past M is
  // left as it is: it only feeds outputs of that row, which are never
  // stored
  const int rows = min(kM, a.M - m0);
  constexpr int VE = 16 / sizeof(XT);  // values a load
  const int vpr = (k_end - k_begin) / VE;
  const uint4* xv = reinterpret_cast<const uint4*>(
      static_cast<const XT*>(a.x) + static_cast<long long>(m0) * a.K +
      k_begin);
#pragma unroll 4
  for (int i = threadIdx.x; i < rows * vpr; i += kThreads) {
    const int m = i / vpr, v = i - m * vpr, kp = v * VE / 2;
    const uint4 raw = __ldg(xv + static_cast<long long>(m) * (a.K / VE) + v);
    if constexpr (P == 1) {
      stage[kp * kM + m] = raw.x;
      stage[(kp + 1) * kM + m] = raw.y;
      stage[(kp + 2) * kM + m] = raw.z;
      stage[(kp + 3) * kM + m] = raw.w;
    } else {
      uint32_t w[3][2];
      f32_planes(raw, w);
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        stage[(p * nkp + kp) * kM + m] = w[p][0];
        stage[(p * nkp + kp + 1) * kM + m] = w[p][1];
      }
    }
  }
  __syncthreads();

  int s = 0;
  for (int ku = k_begin + warp * U; ku < k_end; ku += kWarps * U) {
    // the unit's K-group scales, on their way while its k-steps run
    float4 sc[8];
    const float* srow =
        a.w_scale + static_cast<long long>(ku / a.group) * a.N;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      sc[v] = valid ? __ldg(reinterpret_cast<const float4*>(srow + n_lo +
                                                            4 * v))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      sc[4 + v] = valid ? __ldg(reinterpret_cast<const float4*>(
                              srow + n_hi + 4 * v))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.0f;
    for (int st = 0; st < spu; ++st, ++s) {
      if (s + kW4Ring - 1 < nsteps) issue();
      hop::cp_async_commit();
      hop::cp_async_wait<kW4Ring - 1>();  // k-step s's copies have landed
      const uint4* slot = ring + (s % kW4Ring) * 128;
      const uint4 r[4] = {slot[lane], slot[32 + lane], slot[64 + lane],
                          slot[96 + lane]};
      products(r, (ku - k_begin) / 2 + 8 * st);
    }
    // the unit's sums times its K-group's scales
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float slo[4] = {sc[v].x, sc[v].y, sc[v].z, sc[v].w};
      const float shi[4] = {sc[4 + v].x, sc[4 + v].y, sc[4 + v].z,
                            sc[4 + v].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float* t = tot[4 * v + e];
        const float* p = part[4 * v + e];
        t[0] = fmaf(p[0], slo[e], t[0]);
        t[1] = fmaf(p[1], slo[e], t[1]);
        t[2] = fmaf(p[2], shi[e], t[2]);
        t[3] = fmaf(p[3], shi[e], t[3]);
      }
    }
  }
  hop::cp_async_wait<0>();

  // The warps' sums through shared memory (over the x rows, read by now),
  // four x rows a round, added in warp order. Local column 8 i + g of the
  // block: chunk g's column n_lo + i (i < 16) or n_hi + i - 16.
  float* red = reinterpret_cast<float*>(stage);
  auto column = [&](int lc) {
    const int gc = lc % 8, i = lc / 8;
    const int cc = blockIdx.x * 128 + 16 * gc;
    if (cc >= a.N / 2) return -1;
    const int jc = cc / half;
    const int nl = jc * a.bn + (cc - jc * half);
    return i < 16 ? nl + i : nl + half + i - 16;
  };
  float* partials = static_cast<float*>(a.partials);
  for (int r = 0; r < (rows + 3) / 4; ++r) {
    __syncthreads();
    if (c / 2 == r) {  // the lane's x rows 2c, 2c + 1 are in this round
      float* dst = red + (warp * 4 + 2 * c - 4 * r) * kLocal + g;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        dst[8 * j] = tot[j][0];
        dst[kLocal + 8 * j] = tot[j][1];
        dst[8 * (16 + j)] = tot[j][2];
        dst[kLocal + 8 * (16 + j)] = tot[j][3];
      }
    }
    __syncthreads();
    for (int o = threadIdx.x; o < 4 * kLocal; o += kThreads) {
      const int mm = o / kLocal, lc = o % kLocal;
      const int m = m0 + 4 * r + mm, n = column(lc);
      if (m >= a.M || n < 0) continue;
      float v = red[mm * kLocal + lc];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) v += red[(w * 4 + mm) * kLocal + lc];
      if (a.splits == 1) {
        finish<kW4, OT>(a, v, m, n);
      } else {
        partials[(static_cast<long long>(blockIdx.y) * a.M + m) * a.N + n] =
            v;
      }
    }
  }
  if (a.splits == 1) return;

  // split-K: the last block of this column block and row tile to arrive
  // adds the splits' partial sums in order and runs the epilogue
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.z * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0)
    is_last = atomicAdd(&a.counters[tile], 1) == a.splits - 1;
  __syncthreads();
  if (!is_last) return;
  // each thread its outputs o = tid + k * threads; split by split, all of
  // their partials' loads issued together
  constexpr int PER = kM * kLocal / kThreads;
  long long at[PER];
  float v[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int o = threadIdx.x + k * kThreads;
    const int m = m0 + o / kLocal, n = column(o % kLocal);
    at[k] = m < a.M && n >= 0 ? static_cast<long long>(m) * a.N + n : -1;
    v[k] = 0.0f;
  }
  for (int s = 0; s < a.splits; ++s) {
    const float* src = partials + static_cast<long long>(s) * a.M * a.N;
#pragma unroll
    for (int k = 0; k < PER; ++k)
      if (at[k] >= 0) v[k] += __ldcg(src + at[k]);
  }
#pragma unroll
  for (int k = 0; k < PER; ++k)
    if (at[k] >= 0)
      finish<kW4, OT>(a, v[k], static_cast<int>(at[k] / a.N),
                      static_cast<int>(at[k] % a.N));
  if (threadIdx.x == 0) a.counters[tile] = 0;
}

// ---------------------------------------------------------------------------
// tiled_kernel: grid (ceil(N / 64), ceil(M / 64)); any M, K, N.
template <int KIND, typename XT, typename OT>
__global__ void __launch_bounds__(kThreads) tiled_kernel(Args a) {
  static_assert(KIND != kI8A8, "kI8A8 takes imma.cuh's kernel");
  using Acc = typename AccT<KIND>::type;
  __shared__ __align__(16) Acc xs[kTileK][kTileM + kPad];  // x tile, k-major
  __shared__ __align__(16) Acc ws[kTileK][kTileN + kPad];
  const int m0 = blockIdx.y * kTileM, n0 = blockIdx.x * kTileN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  Acc acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = Acc(0);

  for (int k0 = 0; k0 < a.K; k0 += kTileK) {
#pragma unroll
    for (int r = 0; r < kTileM * kTileK / kThreads; ++r) {
      const int idx = threadIdx.x + r * kThreads;
      const int mm = idx / kTileK, kk = idx % kTileK;
      const int m = m0 + mm, k = k0 + kk;
      xs[kk][mm] = m < a.M && k < a.K ? load_x<KIND, XT>(a, m, k) : Acc(0);
    }
#pragma unroll
    for (int r = 0; r < kTileK * kTileN / kThreads; ++r) {
      const int idx = threadIdx.x + r * kThreads;
      const int kk = idx / kTileN, nn = idx % kTileN;
      const int k = k0 + kk, n = n0 + nn;
      ws[kk][nn] = k < a.K && n < a.N ? load_w<KIND>(a, k, n) : Acc(0);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTileK; ++kk) {
      Acc xa[4], wb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xa[i] = xs[kk][ty * 4 + i];
        wb[i] = ws[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += xa[i] * wb[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
      if (m < a.M && n < a.N) finish<KIND, OT>(a, acc[i][j], m, n);
    }
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

template <int KIND, typename XT, typename OT>
int launch_gemv(const Args& a, cudaStream_t stream) {
  if constexpr (KIND == kW4) {
    auto kernel = gemv_w4_kernel<XT, OT>;
    // the shared-memory limit, set once per device (as B11's)
    static std::atomic<uint64_t> allowed{0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const uint64_t bit = uint64_t(1) << (dev % 64);
    if (!(allowed.load() & bit)) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kW4Smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      allowed.fetch_or(bit);
    }
    const dim3 grid(cdiv(a.N / 2, kChunks * 16), a.splits, cdiv(a.M, 8));
    kernel<<<grid, kThreads, kW4Smem, stream>>>(a);
  } else {
    const dim3 grid(cdiv(a.N, kBlockCols), a.splits, cdiv(a.M, kRows));
    gemv_kernel<KIND, XT, OT><<<grid, kThreads, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int KIND, typename XT, typename OT>
int launch(const Args& a, int gemv, cudaStream_t stream) {
  if (gemv) {
    return launch_gemv<KIND, XT, OT>(a, stream);
  } else {
    const dim3 grid(cdiv(a.N, kTileN), cdiv(a.M, kTileM));
    tiled_kernel<KIND, XT, OT><<<grid, kThreads, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Instantiates the kernels of KIND (kW8 or kW4) for the x and output
// types the wrapper names (DType codes).
template <int KIND>
int dispatch(const Args& a, int gemv, int x_dtype, int out_dtype,
             cudaStream_t stream) {
  if (x_dtype == kBF16) {
    return out_dtype == kBF16
               ? launch<KIND, __nv_bfloat16, __nv_bfloat16>(a, gemv, stream)
               : launch<KIND, __nv_bfloat16, float>(a, gemv, stream);
  }
  return out_dtype == kBF16 ? launch<KIND, float, __nv_bfloat16>(a, gemv, stream)
                            : launch<KIND, float, float>(a, gemv, stream);
}

}  // namespace qmm
