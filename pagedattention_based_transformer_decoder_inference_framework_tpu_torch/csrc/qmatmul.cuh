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
// with bf16 x int8_matmul.cu's w8_wgmma_kernel; kW4, and kW8 with f32 x
// (the tensor cores have no exact f32 product), still take the
// CUDA-core tiled_kernel below.
//
// Two kernels here: gemv_kernel for every kind, tiled_kernel for kW8 and
// kW4.
//
// gemv_kernel (M <= 16, aligned shapes): each block owns 128 output
// columns and 4 rows of x; its 256 threads are 8 column chunks of 16
// columns times 32 k-lanes, each k-lane taking 4 consecutive rows of W
// per step with one 16-byte load per row (8 bytes for int4: 8 carrier
// bytes are 16 columns), so a warp reads 4 whole 128-byte lines per step.
// kI8A8 transposes the 4x16 bytes in registers (__byte_perm) into
// column words of 4 consecutive k and sums them with __dp4a; the float
// kinds widen weights with the exponent trick (2^23 + byte, then a
// subtraction) instead of the slow I2F conversion. The k-lanes reduce by
// warp shuffles and shared memory in a fixed order. Where the column
// blocks alone cannot fill the 132 SMs, grid.y splits K: each split
// writes its partial sums to a workspace, and the last block of a column
// block to finish (a per-tile counter, reset by that block) adds the
// splits in order and runs the epilogue: deterministic, and exact for
// kI8A8.
//
// tiled_kernel (kW8 and kW4, any M, K, N): a plain shared-memory tiled
// product, 64x64 outputs per block, k-tiles of 32, 4x4 outputs per
// thread, f32 FMA, with every edge masked. Right and simple; B12's
// tensor-core version is later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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
// tiled_kernel
constexpr int kTileM = 64, kTileN = 64, kTileK = 32, kPad = 4;

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

// Four bytes holding q + 8 (q an int4 in [-8, 7]) -> four floats q.
__device__ __forceinline__ void u4x4_to_f32(uint32_t v, float* f) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7440 + i)) -
           8388616.0f;  // 2^23 + 8
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
template <int KIND>
__device__ __forceinline__ int column_of(const Args& a, int cb, int lc) {
  if constexpr (KIND == kW4) {
    const int half = a.bn / 2;
    const int cc0 = (cb * kChunks + lc / kChunkCols) * 8;  // carrier column
    if (cc0 >= a.N / 2) return -1;
    const int j = cc0 / half, t0 = cc0 - j * half, i = lc % kChunkCols;
    return j * a.bn + t0 + (i < 8 ? i : half + i - 8);
  } else {
    const int n = cb * kBlockCols + lc;
    return n < a.N ? n : -1;
  }
}

// ---------------------------------------------------------------------------
// gemv_kernel: grid (ceil(N / 128), splits, ceil(M / 4)).
// Needs: kI8A8 and kW8 N % 16 == 0 with W 16-byte aligned, kI8A8 also
// K % 4 == 0 and x 4-byte aligned; kW4 (bn / 2) % 8 == 0, the carrier
// 8-byte and the scales 16-byte aligned. The wrapper checks.
template <int KIND, typename XT, typename OT>
__global__ void __launch_bounds__(kThreads) gemv_kernel(Args a) {
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

  const uint8_t* wbase;
  long long wstride;
  bool valid;
  int n_lo = 0, n_hi = 0;  // kW4: first columns of the two 8-column runs
  if constexpr (KIND == kW4) {
    const int half = a.bn / 2, cc0 = chunk * 8;
    valid = cc0 < a.N / 2;
    wstride = a.N / 2;
    wbase = static_cast<const uint8_t*>(a.w) + cc0;
    const int j = cc0 / half;
    n_lo = j * a.bn + (cc0 - j * half);
    n_hi = n_lo + half;
  } else {
    const int n0 = chunk * kChunkCols;
    valid = n0 < a.N;
    wstride = a.N;
    wbase = static_cast<const uint8_t*>(a.w) + n0;
  }

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
      } else if constexpr (KIND == kW8) {
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
      } else {  // kW4
        uint2 w[kQuad];
#pragma unroll
        for (int r = 0; r < kQuad; ++r)
          w[r] = k + r < k_end
                     ? __ldg(reinterpret_cast<const uint2*>(
                           wbase + static_cast<long long>(k + r) * wstride))
                     : make_uint2(0, 0);
        // the 16 columns' scales, reloaded only where the K-group changes
        float s[kChunkCols];
        int group_loaded = -1;
#pragma unroll
        for (int r = 0; r < kQuad; ++r) {
          if (k + r >= k_end) break;
          const int g = (k + r) / a.group;
          if (g != group_loaded) {
            const float* srow = a.w_scale + static_cast<long long>(g) * a.N;
            const float4 s0 =
                __ldg(reinterpret_cast<const float4*>(srow + n_lo));
            const float4 s1 =
                __ldg(reinterpret_cast<const float4*>(srow + n_lo + 4));
            const float4 s2 =
                __ldg(reinterpret_cast<const float4*>(srow + n_hi));
            const float4 s3 =
                __ldg(reinterpret_cast<const float4*>(srow + n_hi + 4));
            s[0] = s0.x; s[1] = s0.y; s[2] = s0.z; s[3] = s0.w;
            s[4] = s1.x; s[5] = s1.y; s[6] = s1.z; s[7] = s1.w;
            s[8] = s2.x; s[9] = s2.y; s[10] = s2.z; s[11] = s2.w;
            s[12] = s3.x; s[13] = s3.y; s[14] = s3.z; s[15] = s3.w;
            group_loaded = g;
          }
          float xf[kRows];
#pragma unroll
          for (int m = 0; m < kRows; ++m)
            xf[m] = m0 + m < a.M ? load_x<KIND, XT>(a, m0 + m, k + r) : 0.0f;
          // carrier bytes 0..7: columns n_lo + i (low nibbles, q + 8) and
          // n_hi + i (high nibbles, two's complement; ^ 8 makes them q + 8)
          float q[kChunkCols];
          u4x4_to_f32(w[r].x & 0x0F0F0F0Fu, q);
          u4x4_to_f32(w[r].y & 0x0F0F0F0Fu, q + 4);
          u4x4_to_f32(((w[r].x >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, q + 8);
          u4x4_to_f32(((w[r].y >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, q + 12);
#pragma unroll
          for (int i = 0; i < kChunkCols; ++i) {
            const float wf = __fmul_rn(q[i], s[i]);
#pragma unroll
            for (int m = 0; m < kRows; ++m)
              acc[m][i] = fmaf(xf[m], wf, acc[m][i]);
          }
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
    const int m = m0 + mm, n = column_of<KIND>(a, blockIdx.x, lc);
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
    const int m = m0 + mm, n = column_of<KIND>(a, blockIdx.x, lc);
    if (m >= a.M || n < 0) continue;
    Acc v = Acc(0);
    for (int s = 0; s < a.splits; ++s)
      v += __ldcg(&partials[(static_cast<long long>(s) * a.M + m) * a.N + n]);
    finish<KIND, OT>(a, v, m, n);
  }
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
  const dim3 grid(cdiv(a.N, kBlockCols), a.splits, cdiv(a.M, kRows));
  gemv_kernel<KIND, XT, OT><<<grid, kThreads, 0, stream>>>(a);
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
