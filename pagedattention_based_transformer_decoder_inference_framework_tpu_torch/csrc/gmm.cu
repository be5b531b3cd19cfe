// Grouped matrix product over expert-sorted rows, for Hopper.
//
//   pbt_grouped_matmul  <- ops/gmm.py::grouped_matmul (_kernel, gmm.py:35,
//                          65), B13: the Mixture-of-Experts dispatch's three
//                          expert products (fused gate|up, or gate and up,
//                          then down) at prefill.
//
//   y[r, :] = (x[r, :] @ widen(w[e])) * scales[e, :],  e = gob[r / bm]
//
// x [Npad, K] bf16 or f32, rows sorted by expert with each expert's range
// padded to a multiple of bm, so a row block of bm rows belongs to one
// expert; w [E, K, N] int8 (with f32 scales [E, N]), bf16 or f32 (no
// scales: the product is not multiplied); y [Npad, N] in x's type. The
// weight is cast to x's type first, as the JAX kernel's astype does (int8
// and bf16 widen exactly; an f32 weight under bf16 x rounds to nearest
// even), the products sum over the whole of K in f32, the scales multiply
// once after the sum, and the result rounds once. The TPU kernel's K and N
// padding to its blocks adds zeros; here the ragged edges are masked.
//
// What bounds it on the H100, at Mixtral-8x7B's prefill (bench.py's 4 x
// 256-token chunk: 2048 routed rows, Npad = 4096): a layer's two calls
// (we_gu K 4096 N 28672, we_down K 14336 N 4096) are 2 * 4096 * (4096 *
// 28672 + 14336 * 4096) = 1,443 GFLOP over Npad rows, 1.46 ms at the
// tensor cores' 989 TFLOP/s in bf16 (0.73 ms over the 2048 routed rows
// alone), against 1.83 GB of x, INT8 weights and y, 0.55 ms at 3.35 TB/s:
// operations bound it, so the bf16 path runs on the tensor cores.
//
// Design. The TPU walks a (row block, N block, K block) grid with K
// innermost, carrying an f32 accumulator in VMEM, and reads each block's
// expert id from a scalar-prefetched table. Here each CUDA block owns one
// output tile, reads its own expert id from gob in device memory, and
// loops over K itself; tiles never straddle two experts because their row
// count (128, or 64 where bm is no multiple of 128) divides bm.
//
//   tc_kernel (bf16 x): 128 x 128 output tiles, k-tiles of 32, 8 warps of
//     64 x 32 (or 32 x 32) each, bf16 WMMA 16x16x16 fragments (mma.sync on
//     the tensor cores) accumulating in f32. The weight tile is widened (or
//     rounded) to bf16 as it is staged into shared memory; the next k-tile
//     is loaded into registers while the current one is multiplied, with
//     two shared-memory buffers so a k-tile costs one barrier. The
//     epilogue goes through a per-warp 16 x 16 scratch: scales, one
//     rounding, 16-byte stores where the row allows.
//   f32_kernel (f32 x): a CUDA-core tiled product, 64 x 64 tiles, k-tiles
//     of 16, 4 x 4 f32 FMA outputs a thread; not on the main path.
//
// Padding blocks (rows past every expert's range, all zeros) are computed
// like the others, as on the TPU. A group id outside [0, E) gives a tile
// of zeros instead of a read out of bounds. Later work: wgmma with TMA
// staging, and skipping the padding blocks.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace gmm {

using namespace nvcuda;

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

constexpr int kThreads = 256;
// tc_kernel
constexpr int kBN = 128, kBK = 32;
constexpr int kLdA = kBK + 8;   // smem row pitches (bf16 elements): 16-byte
constexpr int kLdB = kBN + 8;   // rows, and fragments stay 32-byte aligned
// f32_kernel
constexpr int kFM = 64, kFN = 64, kFK = 16;

struct Args {
  const void* x;       // [Npad, K] bf16 or f32
  const void* w;       // [E, K, N] int8, bf16 or f32
  const float* scales; // [E, N] or null (dense w)
  const int* gob;      // [Npad / bm]
  void* out;           // [Npad, N], x's type
  int Npad, K, N, E, bm;
  bool vec_x, vec_w, vec_out;
};

// Eight consecutive weights of one row, as loaded.
template <typename WT>
struct Raw8;
template <>
struct Raw8<int8_t> {
  uint2 v;
};
template <>
struct Raw8<__nv_bfloat16> {
  uint4 v;
};
template <>
struct Raw8<float> {
  float4 v[2];
};

template <typename WT>
__device__ __forceinline__ void load8(Raw8<WT>& r, const WT* row, int n,
                                      int N, bool in_k, bool vec) {
  r = Raw8<WT>{};
  if (!in_k) return;
  if (vec && n + 8 <= N) {
    if constexpr (sizeof(WT) == 4) {
      r.v[0] = *reinterpret_cast<const float4*>(row + n);
      r.v[1] = *reinterpret_cast<const float4*>(row + n + 4);
    } else {
      r.v = *reinterpret_cast<const decltype(r.v)*>(row + n);
    }
    return;
  }
  WT* p = reinterpret_cast<WT*>(&r);
  for (int t = 0; t < 8 && n + t < N; ++t) p[t] = row[n + t];
}

// Eight weights -> eight bf16 (x's type): int8 and bf16 exactly, f32
// rounded to nearest even.
__device__ __forceinline__ uint4 to_bf16x8(const Raw8<int8_t>& r) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&r.v);
  uint4 o;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    p[i] = __floats2bfloat162_rn(static_cast<float>(b[2 * i]),
                                 static_cast<float>(b[2 * i + 1]));
  return o;
}
__device__ __forceinline__ uint4 to_bf16x8(const Raw8<__nv_bfloat16>& r) {
  return r.v;
}
__device__ __forceinline__ uint4 to_bf16x8(const Raw8<float>& r) {
  const float* f = reinterpret_cast<const float*>(r.v);
  uint4 o;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    p[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return o;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The expert of the tile at rows m0.., or -1 if its id is out of range.
__device__ __forceinline__ int group_of(const Args& a, int m0) {
  const int g = a.gob[m0 / a.bm];
  return (g >= 0 && g < a.E) ? g : -1;
}

template <int BM, typename WT>
__global__ void __launch_bounds__(kThreads) tc_kernel(const Args a) {
  constexpr int WM = BM / 2;                    // warp rows (2 x 4 warps)
  constexpr int MI = WM / 16;                   // fragments down a warp
  constexpr int ACH = BM * kBK / 8 / kThreads;  // x chunks a thread
  constexpr int BCH = kBK * kBN / 8 / kThreads; // w chunks a thread (2)
  __shared__ __align__(128) uint16_t As[2][BM * kLdA];
  __shared__ __align__(128) uint16_t Bs[2][kBK * kLdB];
  __shared__ __align__(128) float scratch[kThreads / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kBN;
  const int K = a.K, N = a.N;
  const int g = group_of(a, m0);
  const int nk = g < 0 ? 0 : (K + kBK - 1) / kBK;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const WT* w = static_cast<const WT*>(a.w) +
                (g < 0 ? 0 : static_cast<long long>(g) * K * N);

  uint4 araw[ACH];
  Raw8<WT> braw[BCH];
  auto load_tile = [&](int kt) {
#pragma unroll
    for (int i = 0; i < ACH; ++i) {
      const int c = tid + i * kThreads;
      const int row = c / (kBK / 8), k = kt * kBK + (c % (kBK / 8)) * 8;
      const __nv_bfloat16* src = x + static_cast<long long>(m0 + row) * K;
      if (a.vec_x && k + 8 <= K) {
        araw[i] = *reinterpret_cast<const uint4*>(src + k);
      } else {
        araw[i] = make_uint4(0, 0, 0, 0);
        __nv_bfloat16* p = reinterpret_cast<__nv_bfloat16*>(&araw[i]);
        for (int t = 0; t < 8 && k + t < K; ++t) p[t] = src[k + t];
      }
    }
#pragma unroll
    for (int i = 0; i < BCH; ++i) {
      const int c = tid + i * kThreads;
      const int k = kt * kBK + c / (kBN / 8), n = n0 + (c % (kBN / 8)) * 8;
      load8<WT>(braw[i], w + static_cast<long long>(k) * N, n, N, k < K,
                a.vec_w);
    }
  };
  auto store_tile = [&](int buf) {
#pragma unroll
    for (int i = 0; i < ACH; ++i) {
      const int c = tid + i * kThreads;
      *reinterpret_cast<uint4*>(
          &As[buf][(c / (kBK / 8)) * kLdA + (c % (kBK / 8)) * 8]) = araw[i];
    }
#pragma unroll
    for (int i = 0; i < BCH; ++i) {
      const int c = tid + i * kThreads;
      *reinterpret_cast<uint4*>(
          &Bs[buf][(c / (kBN / 8)) * kLdB + (c % (kBN / 8)) * 8]) =
          to_bf16x8(braw[i]);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MI][2];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  if (nk > 0) {
    load_tile(0);
    store_tile(0);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load_tile(kt + 1);
    const __nv_bfloat16* as =
        reinterpret_cast<const __nv_bfloat16*>(As[buf]) + wm * WM * kLdA;
    const __nv_bfloat16* bs =
        reinterpret_cast<const __nv_bfloat16*>(Bs[buf]) + wn * 32;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          af[MI];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          bf[2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        wmma::load_matrix_sync(af[i], as + i * 16 * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], bs + kk * kLdB + j * 16, kLdB);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    if (kt + 1 < nk) store_tile(buf ^ 1);
    __syncthreads();
  }

  // epilogue: each 16 x 16 fragment through the warp's scratch; a lane
  // takes 8 consecutive columns of one row
  float* scr = scratch[warp];
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
  const int r = lane / 2, c0 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(scr, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const long long m = m0 + wm * WM + i * 16 + r;
      const int nb = n0 + wn * 32 + j * 16 + c0;
      uint4 packed;
      __nv_bfloat16* pv = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        float v = scr[r * 16 + c0 + t];
        if (a.scales != nullptr && g >= 0 && nb + t < N)
          v = __fmul_rn(v, a.scales[static_cast<long long>(g) * N + nb + t]);
        pv[t] = __float2bfloat16_rn(v);
      }
      if (a.vec_out && nb + 8 <= N) {
        *reinterpret_cast<uint4*>(out + m * N + nb) = packed;
      } else {
        for (int t = 0; t < 8 && nb + t < N; ++t) out[m * N + nb + t] = pv[t];
      }
      __syncwarp();
    }
  }
}

template <typename WT>
__global__ void __launch_bounds__(kThreads) f32_kernel(const Args a) {
  __shared__ float As[kFK][kFM + 4];  // [k][m]
  __shared__ float Bs[kFK][kFN + 4];  // [k][n]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * kFM, n0 = blockIdx.y * kFN;
  const int K = a.K, N = a.N;
  const int g = group_of(a, m0);
  const float* x = static_cast<const float*>(a.x);
  const WT* w = static_cast<const WT*>(a.w) +
                (g < 0 ? 0 : static_cast<long long>(g) * K * N);
  float acc[4][4] = {};
  for (int k0 = 0; g >= 0 && k0 < K; k0 += kFK) {
    for (int e = tid; e < kFM * kFK; e += kThreads) {
      const int row = e / kFK, k = e % kFK;
      As[k][row] = k0 + k < K
                       ? x[static_cast<long long>(m0 + row) * K + k0 + k]
                       : 0.0f;
    }
    for (int e = tid; e < kFK * kFN; e += kThreads) {
      const int k = e / kFN, n = e % kFN;
      Bs[k][n] = (k0 + k < K && n0 + n < N)
                     ? to_f32(w[static_cast<long long>(k0 + k) * N + n0 + n])
                     : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      float v = acc[i][j];
      if (a.scales != nullptr && g >= 0)
        v = __fmul_rn(v, a.scales[static_cast<long long>(g) * N + n]);
      out[m * N + n] = v;
    }
  }
}

template <typename WT>
void launch_tc(const Args& a, cudaStream_t st) {
  const dim3 block(kThreads);
  if (a.bm % 128 == 0) {
    tc_kernel<128, WT><<<dim3(a.Npad / 128, (a.N + kBN - 1) / kBN), block, 0,
                         st>>>(a);
  } else {
    tc_kernel<64, WT><<<dim3(a.Npad / 64, (a.N + kBN - 1) / kBN), block, 0,
                        st>>>(a);
  }
}

template <typename WT>
void launch_f32(const Args& a, cudaStream_t st) {
  f32_kernel<WT><<<dim3(a.Npad / kFM, (a.N + kFN - 1) / kFN), kThreads, 0,
                   st>>>(a);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace gmm

extern "C" int pbt_grouped_matmul(const void* x, const void* w,
                                  const float* scales, const int* gob,
                                  void* out, int Npad, int K, int N, int E,
                                  int bm, int x_dtype, int w_dtype,
                                  void* stream) {
  using namespace gmm;
  if (bm <= 0 || bm % kFM != 0 || Npad % bm != 0) return cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.w = w;
  a.scales = scales;
  a.gob = gob;
  a.out = out;
  a.Npad = Npad;
  a.K = K;
  a.N = N;
  a.E = E;
  a.bm = bm;
  a.vec_x = K % 8 == 0 && aligned16(x);
  a.vec_w = N % 8 == 0 && aligned16(w);
  a.vec_out = N % 8 == 0 && aligned16(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == kBF16) {
    if (w_dtype == kI8) {
      launch_tc<int8_t>(a, st);
    } else if (w_dtype == kBF16) {
      launch_tc<__nv_bfloat16>(a, st);
    } else if (w_dtype == kF32) {
      launch_tc<float>(a, st);
    } else {
      return cudaErrorInvalidValue;
    }
  } else if (x_dtype == kF32) {
    if (w_dtype == kI8) {
      launch_f32<int8_t>(a, st);
    } else if (w_dtype == kBF16) {
      launch_f32<__nv_bfloat16>(a, st);
    } else if (w_dtype == kF32) {
      launch_f32<float>(a, st);
    } else {
      return cudaErrorInvalidValue;
    }
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
