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
// blocks) by 256 columns and loops over K in k-tiles of 64: two consumer
// warpgroups (64 rows each; one where BM = 64) and one producer warp. The
// producer keeps the loads in flight with TMA, each into a ring of stages
// under full / empty mbarriers: the x tile through a tensor map with the
// 128-byte swizzle that wgmma reads (K-major A), the raw weight tile [64
// k, 256 n] through a 3-D map over [E, K, N] (so a ragged K reads zeros,
// not the next expert). The consumers widen each raw tile once to bf16
// (INT8 exactly) into the swizzled MN-major layout, which they read as B
// with wgmma's transpose bit: a k-tile's four m64n256k16 products (f32
// accumulators in registers, 128 a thread) are issued, then the next raw
// tile is widened into another of three buffers while they run, so the
// widening (256 threads, 16 INT8 values a load) hides under the tensor
// cores' work, and the products of two k-tiles stay in flight. (The
// alternative, the swapped product y^T = W^T . x^T with the widened
// weight as the A operand in registers, would read each weight byte in a
// strided, bank-conflicting pattern; with the transpose bit one 16-byte
// load of 16 INT8 values gives two 16-byte swizzled stores.) Each widened
// weight tile serves the tile's 128 rows. Blocks run row tiles fastest,
// so the row tiles of one expert that share a weight column tile run
// together and the second read of that tile comes from the 50 MB L2. The
// epilogue multiplies the scales and rounds once, straight from the
// accumulator registers.
//
// f32_kernel: a CUDA-core tiled product, 64 x 64 tiles.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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

constexpr int kWK = 64;   // k-tile: one 128-byte swizzled row
constexpr int kWN = 256;  // n-tile: one m64n256k16 product

// Stage counts: x stages and raw weight stages (the widened weight has
// three buffers: the products of two k-tiles in flight, one being
// widened).
template <typename WT>
struct Ring;
template <>
struct Ring<int8_t> {
  static constexpr int S = 4, R = 4;
};
template <>
struct Ring<__nv_bfloat16> {
  static constexpr int S = 4, R = 2;
};

template <int NC, typename WT>
struct WLayout {
  static constexpr int BM = 64 * NC;
  static constexpr int THREADS = 128 * NC + 32;  // consumers + producer warp
  static constexpr int S = Ring<WT>::S, R = Ring<WT>::R;
  static constexpr int X_BYTES = BM * 128;           // [BM, 64] bf16
  static constexpr int B_BYTES = kWN * 128;          // 4 x [64 k, 64 n]
  static constexpr int RAW_BYTES = kWK * kWN * static_cast<int>(sizeof(WT));
  static constexpr int X_OFF = 0;
  static constexpr int B_OFF = X_OFF + S * X_BYTES;
  static constexpr int RAW_OFF = B_OFF + 3 * B_BYTES;
  static constexpr int BAR_OFF = RAW_OFF + R * RAW_BYTES;
  // the barriers, and room to align the dynamic buffer to 1024 bytes
  static constexpr int BYTES = BAR_OFF + 8 * (2 * S + 2 * R) + 1024;
};

struct WArgs {
  const float* scales;    // [E, N] or null (bf16 experts)
  const int* gob;         // [Npad / bm]
  const int* block_rows;  // [Npad / bm] or null
  __nv_bfloat16* out;     // [Npad, N]
  int Npad, K, N, E, bm;
};

// The consumers widen raw tile `raw` [64 k][256 n] into the four swizzled
// 64-column blocks [64 k][64 n] at `wb`, 16 raw bytes a step (INT8: two
// chunks of 8 n; bf16: one).
template <int NC, typename WT>
__device__ __forceinline__ void widen_tile(const uint8_t* raw, uint8_t* wb,
                                           int ct) {
  constexpr int PER_ROW = kWN * static_cast<int>(sizeof(WT)) / 16;
  constexpr int UNITS = kWK * PER_ROW;
#pragma unroll
  for (int u = ct; u < UNITS; u += 128 * NC) {
    const int k = u / PER_ROW, v = u % PER_ROW;
    const uint4 in = *reinterpret_cast<const uint4*>(raw + u * 16);
    if constexpr (sizeof(WT) == 1) {
      const int cn = 2 * v;  // chunks cn, cn + 1 of 32, in one 64-n block
      uint8_t* dst = wb + (cn / 8) * (kWK * 128);
      *reinterpret_cast<uint4*>(dst + hop::swz(k, cn % 8)) =
          hop::widen8(make_uint2(in.x, in.y));
      *reinterpret_cast<uint4*>(dst + hop::swz(k, cn % 8 + 1)) =
          hop::widen8(make_uint2(in.z, in.w));
    } else {
      *reinterpret_cast<uint4*>(wb + (v / 8) * (kWK * 128) +
                                hop::swz(k, v % 8)) = in;
    }
  }
}

template <int NC, typename WT>
__global__ void __launch_bounds__(WLayout<NC, WT>::THREADS, 1)
    wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap, const WArgs a) {
  using Lay = WLayout<NC, WT>;
  constexpr int BM = Lay::BM, S = Lay::S, R = Lay::R;
  constexpr int NT = 128 * NC;  // consumer threads
  extern __shared__ uint8_t smem_dyn[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_dyn) + 1023) & ~uintptr_t(1023));
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
  uint64_t* xfull = reinterpret_cast<uint64_t*>(smem + Lay::BAR_OFF);
  uint64_t* xempty = xfull + S;
  uint64_t* rawfull = xempty + S;
  uint64_t* rawempty = rawfull + R;
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      hop::mbar_init(&xfull[i], 1);
      hop::mbar_init(&xempty[i], NT);
    }
    for (int i = 0; i < R; ++i) {
      hop::mbar_init(&rawfull[i], 1);
      hop::mbar_init(&rawempty[i], NT);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();
  const int nk = (a.K + kWK - 1) / kWK;
  const int wg = hop::warpgroup();
  uint8_t* const raw0 = smem + Lay::RAW_OFF;
  uint8_t* const wb0 = smem + Lay::B_OFF;

  if (wg == NC) {
    // the producer warp: TMA loads, x into its ring, raw weights into
    // theirs, each stage reused once its readers release it
    if (tid == NT) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % S, r = kt % R;
        if (kt >= S) hop::mbar_wait(&xempty[s], (kt / S - 1) & 1);
        hop::mbar_arrive_tx(&xfull[s], Lay::X_BYTES);
        hop::tma_load_2d(smem + Lay::X_OFF + s * Lay::X_BYTES, &xmap,
                         kt * kWK, m0, &xfull[s]);
        if (kt >= R) hop::mbar_wait(&rawempty[r], (kt / R - 1) & 1);
        hop::mbar_arrive_tx(&rawfull[r], Lay::RAW_BYTES);
        hop::tma_load_3d(raw0 + r * Lay::RAW_BYTES, &wmap, n0, kt * kWK, g,
                         &rawfull[r]);
      }
    }
    return;
  }

  // consumer warpgroup wg: rows m0 + 64 wg .. + 63. Each k-tile: issue the
  // products on the widened tile kt, widen tile kt + 1 into another of the
  // three buffers while they run, wait for the products of tile kt - 1
  // (those of kt stay in flight), release x's stage of kt - 1, and meet the
  // other consumers (every half of tile kt + 1 widened, tile kt - 1's
  // buffer read, so tile kt + 2 may overwrite it).
  const int ct = tid;
  hop::mbar_wait(&rawfull[0], 0);
  widen_tile<NC, WT>(raw0, wb0, ct);
  hop::fence_async_smem();
  hop::mbar_arrive(&rawempty[0]);
  hop::named_sync(1, NT);

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  hop::fence_regs(acc);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % S;
    hop::mbar_wait(&xfull[s], (kt / S) & 1);
    const uint8_t* xs = smem + Lay::X_OFF + s * Lay::X_BYTES + wg * 64 * 128;
    const uint8_t* wb = wb0 + (kt % 3) * Lay::B_BYTES;
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWK / 16; ++kk)
      hop::mma_ss_n256<1>(acc, hop::desc(xs + kk * 32, 16, 1024),
                          hop::desc(wb + kk * 2048, kWK * 128, 1024), 1);
    hop::wgmma_commit();
    if (kt + 1 < nk) {
      const int r = (kt + 1) % R;
      hop::mbar_wait(&rawfull[r], ((kt + 1) / R) & 1);
      widen_tile<NC, WT>(raw0 + r * Lay::RAW_BYTES,
                         wb0 + ((kt + 1) % 3) * Lay::B_BYTES, ct);
      hop::fence_async_smem();
      hop::mbar_arrive(&rawempty[r]);
    }
    hop::wgmma_wait<1>();
    if (kt > 0) hop::mbar_arrive(&xempty[(kt - 1) % S]);
    hop::named_sync(1, NT);
  }
  hop::wgmma_wait<0>();
  hop::fence_regs(acc);

  // epilogue: scales, one rounding, zeros past the routed rows
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
  using Lay = WLayout<NC, WT>;
  const hop::EncodeTiled encode = hop::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  constexpr cuuint64_t es = sizeof(WT);
  CUtensorMap xmap, wmap;
  const cuuint64_t xdim[2] = {static_cast<cuuint64_t>(a.K),
                              static_cast<cuuint64_t>(a.Npad)};
  const cuuint64_t xstride[1] = {static_cast<cuuint64_t>(a.K) * 2};
  const cuuint32_t xbox[2] = {kWK, static_cast<cuuint32_t>(Lay::BM)};
  const cuuint32_t ones[3] = {1, 1, 1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(x), xdim, xstride, xbox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const cuuint64_t wdim[3] = {static_cast<cuuint64_t>(a.N),
                              static_cast<cuuint64_t>(a.K),
                              static_cast<cuuint64_t>(a.E)};
  const cuuint64_t wstride[2] = {static_cast<cuuint64_t>(a.N) * es,
                                 static_cast<cuuint64_t>(a.K) * a.N * es};
  const cuuint32_t wbox[3] = {kWN, kWK, 1};
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
  kernel<<<dim3(a.Npad / Lay::BM, (a.N + kWN - 1) / kWN), Lay::THREADS,
           Lay::BYTES, st>>>(xmap, wmap, a);
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
