// Grouped matrix product over expert-sorted rows, for Hopper.
//
//   pbt_grouped_matmul  <- ops/gmm.py::grouped_matmul (_kernel, gmm.py:35,
//                          65; pallas_call :90), B13: the Mixture-of-Experts
//                          dispatch's expert products (fused gate|up, then
//                          down) at prefill. wgmma_kernel for bf16 x (INT8
//                          or bf16 experts, 16-byte rows: the wrapper pads
//                          ragged K and N with zeros and rounds f32 experts
//                          to bf16); f32_kernel for f32 x, which no path
//                          of chip_smoke.py runs.
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
// once after the sum, and the result rounds once: those are the rounding
// points, the same in both kernels here. The TPU kernel's K and N padding
// to its blocks adds zeros; here the wrapper's padding to 16-byte rows
// does (wgmma_kernel, whose tensor maps fill the tile edges with zeros),
// or the ragged edges are masked (f32_kernel).
//
// block_rows [Npad / bm] (optional): the routed rows at the front of each
// row block. Rows at or past block_rows[r] of block r come out as zeros,
// which is what the JAX kernel returns on the dispatch's zero rows; a row
// tile with no routed row writes its zeros and computes nothing. Without
// it every row is computed. A group id outside [0, E) gives zeros.
//
// What bounds it on the H100, at Mixtral-8x7B's prefill (bench.py's 4 x
// 256-token chunk: 2048 routed rows, Npad = 4096): a layer's two calls
// (we_gu K 4096 N 28672, we_down K 14336 N 4096) do 2 * 2048 * (4096 *
// 28672 + 14336 * 4096) = 722 GFLOP over the routed rows, 0.73 ms at the
// tensor cores' 989 TFLOP/s in bf16, against 1.2 GB of x, INT8 weights
// and y, 0.36 ms at 3.35 TB/s: operations bound it. About 2,600 of the
// 4,096 rows lie in 128-row tiles that hold a routed row.
//
// wgmma_kernel's design. Each block owns one output tile of BM = 128 rows
// (64 where bm is no multiple of 128; a tile never straddles two row
// blocks) by 256 columns and runs widen_gemm.cuh's mainloop over the whole
// of K (shared with B11's w8_wgmma_kernel): TMA loads of x and of the raw
// weight tile [64 k, 256 n] through a 3-D map over [E, K, N] (so a ragged
// K reads zeros, not the next expert), the INT8 tile widened to bf16 in
// shared memory and read with wgmma's transpose bit, m64n256k16 products
// with f32 accumulators. Blocks run row tiles fastest, so the row tiles of
// one expert that share a weight column tile run together and the second
// read of that tile comes from the 50 MB L2. The epilogue multiplies the
// scales and rounds once, straight from the accumulator registers.
//
// f32_kernel: a CUDA-core tiled product, 64 x 64 tiles.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "widen_gemm.cuh"

namespace gmm {

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

// f32_kernel
constexpr int kThreads = 256;
constexpr int kFM = 64, kFN = 64, kFK = 16;

struct Args {
  const void* x;       // [Npad, K] bf16 or f32
  const void* w;       // [E, K, N] int8, bf16 or f32
  const float* scales; // [E, N] or null (dense w)
  const int* gob;      // [Npad / bm]
  const int* block_rows;  // [Npad / bm] or null (every row computed)
  void* out;           // [Npad, N], x's type
  int Npad, K, N, E, bm;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The expert of the tile at rows m0.., or -1 if its id is out of range.
__device__ __forceinline__ int group_of(const int* gob, int E, int bm,
                                        int m0) {
  const int g = gob[m0 / bm];
  return (g >= 0 && g < E) ? g : -1;
}

// The rows of the tile at m0 (of `rows`) that come out as products: 0 for
// an out-of-range group, else all or, with block_rows, those before the
// block's routed-row count.
__device__ __forceinline__ int live_rows(const int* gob,
                                         const int* block_rows, int E,
                                         int bm, int m0, int rows) {
  if (group_of(gob, E, bm, m0) < 0) return 0;
  if (block_rows == nullptr) return rows;
  return min(max(block_rows[m0 / bm] - m0 % bm, 0), rows);
}

template <typename WT>
__global__ void __launch_bounds__(kThreads) f32_kernel(const Args a) {
  __shared__ float As[kFK][kFM + 4];  // [k][m]
  __shared__ float Bs[kFK][kFN + 4];  // [k][n]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * kFM, n0 = blockIdx.y * kFN;
  const int K = a.K, N = a.N;
  const int g = group_of(a.gob, a.E, a.bm, m0);
  const int live = live_rows(a.gob, a.block_rows, a.E, a.bm, m0, kFM);
  const float* x = static_cast<const float*>(a.x);
  const WT* w = static_cast<const WT*>(a.w) +
                (g < 0 ? 0 : static_cast<long long>(g) * K * N);
  float acc[4][4] = {};
  for (int k0 = 0; live > 0 && k0 < K; k0 += kFK) {
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
      float v = ty * 4 + i < live ? acc[i][j] : 0.0f;
      if (a.scales != nullptr && g >= 0)
        v = __fmul_rn(v, a.scales[static_cast<long long>(g) * N + n]);
      out[m * N + n] = v;
    }
  }
}

template <typename WT>
void launch_f32(const Args& a, cudaStream_t st) {
  f32_kernel<WT><<<dim3(a.Npad / kFM, (a.N + kFN - 1) / kFN), kThreads, 0,
                   st>>>(a);
}

// -- wgmma_kernel ---------------------------------------------------------

struct WArgs {
  const float* scales;    // [E, N] or null (bf16 experts)
  const int* gob;         // [Npad / bm]
  const int* block_rows;  // [Npad / bm] or null
  __nv_bfloat16* out;     // [Npad, N]
  int Npad, K, N, E, bm;
};

template <int NC, typename WT>
__global__ void __launch_bounds__(wgemm::WLayout<NC, WT>::THREADS, 1)
    wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap, const WArgs a) {
  using Lay = wgemm::WLayout<NC, WT>;
  constexpr int BM = Lay::BM, kWN = wgemm::kWN;
  extern __shared__ uint8_t smem_dyn[];
  uint8_t* smem = wgemm::aligned_smem(smem_dyn);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kWN;
  const int N = a.N;
  const int live = live_rows(a.gob, a.block_rows, a.E, a.bm, m0, BM);
  if (live == 0) {  // no routed row: zeros, no product
    for (int i = tid; i < BM * (kWN / 8); i += blockDim.x) {
      const int n = n0 + (i % (kWN / 8)) * 8;
      if (n < N)
        *reinterpret_cast<uint4*>(
            a.out + static_cast<long long>(m0 + i / (kWN / 8)) * N + n) =
            make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const int g = a.gob[m0 / a.bm];
  const int nk = (a.K + wgemm::kWK - 1) / wgemm::kWK;
  float acc[128];
  if (!wgemm::mainloop<NC, WT>(
          smem, &xmap, m0, 0, nk,
          [&](void* dst, int kt, uint64_t* bar) {
            hop::tma_load_3d(dst, &wmap, n0, kt * wgemm::kWK, g, bar);
          },
          acc))
    return;

  // epilogue: scales, one rounding, zeros past the routed rows
  const int wg = hop::warpgroup();
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int rl = 64 * wg + 16 * warp + lane / 4;
  const float* sc =
      a.scales == nullptr ? nullptr : a.scales + static_cast<long long>(g) * N;
#pragma unroll
  for (int i = 0; i < kWN / 8; ++i) {
    const int n = n0 + 8 * i + 2 * (lane % 4);
    if (n >= N) continue;
    const float s0 = sc == nullptr ? 1.0f : sc[n];
    const float s1 = sc == nullptr ? 1.0f : sc[n + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rl + 8 * h;
      float v0 = 0.0f, v1 = 0.0f;
      if (r < live) {
        v0 = acc[4 * i + 2 * h];
        v1 = acc[4 * i + 2 * h + 1];
        if (sc != nullptr) {
          v0 = __fmul_rn(v0, s0);
          v1 = __fmul_rn(v1, s1);
        }
      }
      *reinterpret_cast<uint32_t*>(
          a.out + static_cast<long long>(m0 + r) * N + n) =
          hop::pack_bf16(v0, v1);
    }
  }
}

template <int NC, typename WT>
cudaError_t launch_wgmma(const void* x, const void* w, const WArgs& a,
                         cudaStream_t st) {
  using Lay = wgemm::WLayout<NC, WT>;
  const hop::EncodeTiled encode = hop::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  constexpr cuuint64_t es = sizeof(WT);
  CUtensorMap xmap, wmap;
  if (!wgemm::encode_x(&xmap, x, a.K, a.Npad, Lay::BM))
    return cudaErrorInvalidValue;
  const cuuint64_t wdim[3] = {static_cast<cuuint64_t>(a.N),
                              static_cast<cuuint64_t>(a.K),
                              static_cast<cuuint64_t>(a.E)};
  const cuuint64_t wstride[2] = {static_cast<cuuint64_t>(a.N) * es,
                                 static_cast<cuuint64_t>(a.K) * a.N * es};
  const cuuint32_t wbox[3] = {wgemm::kWN, wgemm::kWK, 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  if (encode(&wmap,
             sizeof(WT) == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                             : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             3, const_cast<void*>(w), wdim, wstride, wbox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  auto kernel = wgmma_kernel<NC, WT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.Npad / Lay::BM, (a.N + wgemm::kWN - 1) / wgemm::kWN),
           Lay::THREADS, Lay::BYTES, st>>>(xmap, wmap, a);
  return cudaGetLastError();
}

template <typename WT>
cudaError_t run_wgmma(const void* x, const void* w, const WArgs& a,
                      cudaStream_t st) {
  return a.bm % 128 == 0 ? launch_wgmma<2, WT>(x, w, a, st)
                         : launch_wgmma<1, WT>(x, w, a, st);
}

}  // namespace gmm

// B13: x [Npad, K] bf16 (x_dtype 1) or f32 (0); experts [E, K, N] INT8
// (w_dtype 2, with scales), bf16 (1) or f32 (0). bf16 x takes wgmma_kernel,
// which needs INT8 or bf16 experts, K a multiple of 8, N of 16 (INT8) or 8
// (bf16) and x, w and out 16-byte aligned (ops/gmm.py pads and copies to
// meet it); f32 x takes f32_kernel at any shape. K must be positive: with
// no k-tile, wgmma_kernel's consumers would wait for a load never issued.
extern "C" int pbt_grouped_matmul(const void* x, const void* w,
                                  const float* scales, const int* gob,
                                  const int* block_rows, void* out,
                                  int Npad, int K, int N, int E, int bm,
                                  int x_dtype, int w_dtype, void* stream) {
  using namespace gmm;
  if (bm <= 0 || bm % 64 != 0 || Npad % bm != 0 || K <= 0)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == kBF16) {
    if (K % 8 != 0 || !hop::aligned16(x) || !hop::aligned16(w) ||
        !hop::aligned16(out))
      return cudaErrorInvalidValue;
    const WArgs a{scales, gob, block_rows, static_cast<__nv_bfloat16*>(out),
                  Npad, K, N, E, bm};
    if (w_dtype == kI8 && N % 16 == 0) return run_wgmma<int8_t>(x, w, a, st);
    if (w_dtype == kBF16 && N % 8 == 0)
      return run_wgmma<__nv_bfloat16>(x, w, a, st);
    return cudaErrorInvalidValue;
  }
  if (x_dtype != kF32) return cudaErrorInvalidValue;
  const Args a{x, w, scales, gob, block_rows, out, Npad, K, N, E, bm};
  if (w_dtype == kI8) {
    launch_f32<int8_t>(a, st);
  } else if (w_dtype == kBF16) {
    launch_f32<__nv_bfloat16>(a, st);
  } else if (w_dtype == kF32) {
    launch_f32<float>(a, st);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
