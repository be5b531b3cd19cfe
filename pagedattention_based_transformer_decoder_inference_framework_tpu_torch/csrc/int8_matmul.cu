// INT8-weight matrix products for Hopper (kernels in qmatmul.cuh, imma.cuh
// and, for B11 past 16 rows, below on widen_gemm.cuh's mainloop).
//
//   pbt_int8_matmul  <- ops/int8_matmul.py::int8_matmul (_kernel :30,
//                       pallas_call :162), B10: act((xq @ wq) * x_scale *
//                       w_scale + bias), s8 x s8 summed in s32 (w8a8:
//                       every projection under quant="int8").
//   pbt_w8_matmul    <- ops/int8_matmul.py::w8_matmul (_w8_kernel :54,
//                       pallas_call :107), B11: act((x @ widen(wq)) *
//                       w_scale + bias), f32 sums (the LM head under w8a8,
//                       every projection under quant="int8-weight").
//
// The TPU kernels run one (bm, bn) block per program with the K axis as
// the sequential grid dimension, carrying the accumulator in VMEM. Here a
// block owns its outputs and loops over K itself. Small M (decode, M <=
// 16) streams every weight byte once a call, so bytes bound it: B10 takes
// qmatmul.cuh's gemv_kernel (16-byte loads, __dp4a; K split across blocks
// where the columns alone cannot fill the card), B11 gemv_w8_kernel (the
// weights widened exactly to bf16 as the A operand of mma.sync, streamed
// through a cp.async ring per warp that runs on across the block's tiles,
// x staged once in shared memory, at most one block an SM; Mixtral-8x7B's
// expert gate|up at M = 4 is 117 MB, 35 us at 3.35 TB/s). Larger M takes,
// for B10, the INT8 tensor-core kernel (imma.cuh: TMA, the weight tile
// transposed on chip, wgmma s8 x s8 -> s32), with K split where its
// output tiles fall short of the SMs; for B11 with bf16 x,
// w8_wgmma_kernel below; for B11 with f32 x, the CUDA-core tiled_kernel
// (the tensor cores have no exact f32 product, and no path of the card
// runs f32 x past 16 rows).
//
// w8_wgmma_kernel (B11, bf16 x, M > 16). What bounds it on the H100: a
// Llama-3-8B layer's four products at M = 256 do 2 * 256 * 4096 * 53,248 =
// 112 GFLOP, 0.113 ms at the tensor cores' 989 TFLOP/s in bf16, against
// 218 MB of INT8 weights (0.065 ms at 3.35 TB/s); the LM head (N =
// 128,256) at M = 256 269 GFLOP (0.272 ms): operations bound them. At a
// verify chunk (M = 36) the head's 525 MB of weights do (0.157 ms). The
// design: B13's mainloop (widen_gemm.cuh: TMA into rings under mbarriers,
// the INT8 tile widened to bf16 in shared memory once and read with
// wgmma's transpose bit, m64n256k16 products with f32 accumulators, the
// next tile widened while the products run) with a 2-D map over [K, N].
// Row tiles of 64 rows where M <= 64 (one consumer warpgroup), else 128
// (two). Where the output tiles fall short of one wave of blocks, the
// host splits K into as many ranges of whole k-tiles as still fit one
// wave (at most 16): each split writes its f32 sums to its slot of a
// workspace [splits, tiles, BM x 256], and the last block of a tile to
// arrive (a counter per tile, reset by that block) adds the splits in
// split order, so the output is the same from run to run. The epilogue
// stages the tile's f32 sums in shared memory (over the x and widened
// rings, free by then) and writes whole rows of 16-byte chunks, each
// thread on fixed columns with its scales and bias loaded once:
// fma(acc, w_scale, bias) in one rounding (as XLA compiles the JAX
// epilogue), the activation, one rounding to the output type, which are
// the plain version's rounding points. The sums are f32 over exact bf16
// products in the tensor cores' order, so they differ from the plain
// version's f32 product by the order of the sums only. The host needs K %
// 8 == 0 and N % 16 == 0 (TMA's 16-byte strides; the wrapper zero-pads)
// and 16-byte aligned x and W; TMA fills the tile edges past M, K and N
// with zeros and the stores are masked. Both tensor maps are encoded per
// call.
//
// Each entry point returns cudaGetLastError() after its launch.

#include <atomic>

#include "imma.cuh"
#include "qmatmul.cuh"
#include "widen_gemm.cuh"

namespace w8 {

// floats a row of the epilogue's staged f32 tile: 8 past the 256 columns,
// so the accumulators' 8-byte stores (rows lane / 4, columns 2 (lane %
// 4)) meet no bank twice in a half-warp
constexpr int kLd = wgemm::kWN + 8;

struct Args {
  const float* w_scale;  // [N]
  const float* bias;     // [N] or null
  void* out;             // [M, N] f32 or bf16
  float* partials;       // [splits, tiles, BM * 256] (splits > 1)
  int* counters;         // one zeroed int per output tile (splits > 1)
  int M, K, N;
  int splits, kt_per_split;  // k-tiles of 64 a split
  int act;
};

template <int NC, typename OT>
__global__ void __launch_bounds__(wgemm::WLayout<NC, int8_t>::THREADS, 1)
    w8_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap, const Args a) {
  using Lay = wgemm::WLayout<NC, int8_t>;
  constexpr int BM = Lay::BM, NT = Lay::NT, BN = wgemm::kWN;
  // the staged tile fits over the x ring and the widened buffers
  static_assert(BM * kLd * 4 <= Lay::RAW_OFF, "the tile overlaps the ring");
  extern __shared__ uint8_t smem_dyn[];
  __shared__ int is_last;
  uint8_t* smem = wgemm::aligned_smem(smem_dyn);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kt0 = blockIdx.z * a.kt_per_split;
  const int nk = min((a.K + wgemm::kWK - 1) / wgemm::kWK - kt0,
                     a.kt_per_split);
  float acc[128];
  if (!wgemm::mainloop<NC, int8_t>(
          smem, &xmap, m0, kt0, nk,
          [&](void* dst, int kt, uint64_t* bar) {
            hop::tma_load_2d(dst, &wmap, n0, kt * wgemm::kWK, bar);
          },
          acc))
    return;

  // The tile's f32 sums into shared memory over the x ring and the
  // widened buffers (every product done and every stage read once the
  // consumers meet; no load in flight), rows of kLd floats. Thread tid
  // holds, for each 8-column group i, rows rl and rl + 8 at columns
  // 8 i + cl + 0..1.
  hop::named_sync(1, NT);
  float* tile = reinterpret_cast<float*>(smem);
  {
    const int wg = hop::warpgroup();
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int rl = 64 * wg + 16 * warp + lane / 4, cl = 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(tile + (rl + 8 * h) * kLd + 8 * i + cl) =
            make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
  }
  hop::named_sync(1, NT);
  // Chunk c = tid + k NT (k < PER) of 4 columns: row c / 64, columns
  // 4 (c % 64) ..; every chunk of a thread has the same columns.
  constexpr int PER = BM * (BN / 4) / NT;
  const int chunks = min(BM, a.M - m0) * (BN / 4), q = tid % (BN / 4);
  auto at = [&](int c) {
    return reinterpret_cast<float4*>(tile + (c / (BN / 4)) * kLd +
                                     4 * (c % (BN / 4)));
  };
  if (a.splits > 1) {
    // each split's sums to its slot of the workspace; the last block of
    // the tile to arrive adds all the splits' in split order (whichever
    // block it is, the same sums in the same order) and runs the epilogue
    const int tile_id = blockIdx.y * gridDim.x + blockIdx.x;
    const long long slot = static_cast<long long>(BM) * BN / 4;
    const long long tiles = static_cast<long long>(gridDim.x) * gridDim.y;
    float4* part = reinterpret_cast<float4*>(a.partials) + tile_id * slot;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int c = tid + k * NT;
      if (c < chunks) part[blockIdx.z * tiles * slot + c] = *at(c);
    }
    __threadfence();
    hop::named_sync(1, NT);
    if (tid == 0)
      is_last = atomicAdd(&a.counters[tile_id], 1) == a.splits - 1;
    hop::named_sync(1, NT);
    if (!is_last) return;
    float4 v[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp = 0; sp < a.splits; ++sp) {
      const float4* src = part + sp * tiles * slot;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int c = tid + k * NT;
        if (c >= chunks) continue;
        const float4 p = __ldcg(src + c);
        v[k].x += p.x;
        v[k].y += p.y;
        v[k].z += p.z;
        v[k].w += p.w;
      }
    }
#pragma unroll
    for (int k = 0; k < PER; ++k)
      if (tid + k * NT < chunks) *at(tid + k * NT) = v[k];
    if (tid == 0) a.counters[tile_id] = 0;
    hop::named_sync(1, NT);
  }
  const int n = n0 + 4 * q;
  if (n >= a.N) return;
  const bool has_bias = a.bias != nullptr;
  float ws[4], bs[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    ws[e] = __ldg(a.w_scale + n + e);
    bs[e] = has_bias ? __ldg(a.bias + n + e) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int c = tid + k * NT;
    if (c >= chunks) break;
    const float4 v = *at(c);
    const float s[4] = {v.x, v.y, v.z, v.w};
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      y[e] = qmm::activate(
          has_bias ? __fmaf_rn(s[e], ws[e], bs[e]) : __fmul_rn(s[e], ws[e]),
          a.act);
    imma::store4<OT>(a.out,
                     static_cast<long long>(m0 + c / (BN / 4)) * a.N + n, y);
  }
}

template <int NC, typename OT>
cudaError_t launch(const CUtensorMap& xmap, const CUtensorMap& wmap,
                   const Args& a, cudaStream_t st) {
  using Lay = wgemm::WLayout<NC, int8_t>;
  auto kernel = w8_wgmma_kernel<NC, OT>;
  // the shared-memory limit, set once per device (the attribute belongs
  // to the kernel in that device's context)
  static std::atomic<uint64_t> allowed{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = uint64_t(1) << (dev % 64);
  if (!(allowed.load() & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::BYTES);
    if (err != cudaSuccess) return err;
    allowed.fetch_or(bit);
  }
  kernel<<<dim3((a.M + Lay::BM - 1) / Lay::BM,
                (a.N + wgemm::kWN - 1) / wgemm::kWN, a.splits),
           Lay::THREADS, Lay::BYTES, st>>>(xmap, wmap, a);
  return cudaGetLastError();
}

// x [M, K] bf16, W [K, N] int8; out in out_dtype (qmm::kF32 or kBF16).
int run(const void* x, const void* w, const Args& a, int out_dtype,
        cudaStream_t st) {
  const int nk = (a.K + wgemm::kWK - 1) / wgemm::kWK;
  if (a.M <= 0 || a.K <= 0 || a.N <= 0 || a.K % 8 != 0 || a.N % 16 != 0 ||
      !hop::aligned16(x) || !hop::aligned16(w) || !hop::aligned16(a.out) ||
      a.splits < 1 || a.kt_per_split < 1 || a.splits * a.kt_per_split < nk ||
      (a.splits - 1) * a.kt_per_split >= nk ||
      (a.splits > 1 && (a.partials == nullptr || a.counters == nullptr)))
    return cudaErrorInvalidValue;
  const int nc = a.M <= 64 ? 1 : 2;
  const hop::EncodeTiled encode = hop::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap xmap, wmap;
  const cuuint64_t wdim[2] = {static_cast<cuuint64_t>(a.N),
                              static_cast<cuuint64_t>(a.K)};
  const cuuint64_t wstride[1] = {static_cast<cuuint64_t>(a.N)};
  const cuuint32_t wbox[2] = {wgemm::kWN, wgemm::kWK};
  const cuuint32_t ones[2] = {1, 1};
  if (!wgemm::encode_x(&xmap, x, a.K, a.M, 64 * nc) ||
      encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w),
             wdim, wstride, wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const bool bf = out_dtype == qmm::kBF16;
  if (nc == 1)
    return bf ? launch<1, __nv_bfloat16>(xmap, wmap, a, st)
              : launch<1, float>(xmap, wmap, a, st);
  return bf ? launch<2, __nv_bfloat16>(xmap, wmap, a, st)
            : launch<2, float>(xmap, wmap, a, st);
}

}  // namespace w8

namespace {

qmm::Args make_args(const void* x, const float* x_scale, const void* w,
                    const float* w_scale, const float* bias, void* out,
                    void* partials, int* counters, int M, int K, int N,
                    int splits, int k_per_split, int act) {
  qmm::Args a;
  a.x = x;
  a.x_scale = x_scale;
  a.w = w;
  a.w_scale = w_scale;
  a.bias = bias;
  a.out = out;
  a.partials = partials;
  a.counters = counters;
  a.M = M;
  a.K = K;
  a.N = N;
  a.splits = splits;
  a.k_per_split = k_per_split;
  a.group = 0;
  a.bn = 0;
  a.act = act;
  return a;
}

}  // namespace

// gemv 1: the matrix-vector kernel gemv_kernel (N % 16 == 0, K % 4 == 0, W
// 16-byte and x 4-byte aligned; k_per_split rows a split, a multiple of
// 4). gemv
// 0: the tensor-core kernel (K % 16 == 0, N % 16 == 0, x and W 16-byte
// aligned; k_per_split rows a split, a multiple of 128). The wrapper
// zero-pads and aligns the operands for both.
extern "C" int pbt_int8_matmul(const void* xq, const float* x_scale,
                               const void* wq, const float* w_scale,
                               const float* bias, void* out, void* partials,
                               int* counters, int M, int K, int N, int splits,
                               int k_per_split, int gemv, int act,
                               int out_dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gemv) {
    const qmm::Args a = make_args(xq, x_scale, wq, w_scale, bias, out,
                                  partials, counters, M, K, N, splits,
                                  k_per_split, act);
    return out_dtype == qmm::kBF16
               ? qmm::launch_gemv<qmm::kI8A8, float, __nv_bfloat16>(a, st)
               : qmm::launch_gemv<qmm::kI8A8, float, float>(a, st);
  }
  if (N % 16 != 0 || k_per_split % imma::kBK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  imma::Args a{};
  a.x_scale = x_scale;
  a.w_scale = w_scale;
  a.bias = bias;
  a.out = out;
  a.partials = static_cast<int*>(partials);
  a.counters = counters;
  a.M = M;
  a.K = K;
  a.N = N;
  a.splits = splits;
  a.kt_per_split = k_per_split / imma::kBK;
  a.act = act;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(K)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(N)};
  return imma::run<imma::kMatrix>(xq, wq, 2, dims, strides, a, out_dtype,
                                  st);
}

// route 1: the matrix-vector kernel gemv_w8_kernel (M <= 16, K % 16 == 0,
// N % 16 == 0, x and W 16-byte aligned; k_per_split rows a split, a
// multiple of 16 whose rows of x fit its stage); route 2: w8_wgmma_kernel
// (bf16 x, K % 8 == 0, N % 16 == 0, x, W and out 16-byte aligned;
// k_per_split rows a split, a multiple of 64); route 0: the CUDA-core
// tiled kernel (any shape; f32 x past 16 rows).
extern "C" int pbt_w8_matmul(const void* x, const void* wq,
                             const float* w_scale, const float* bias,
                             void* out, void* partials, int* counters, int M,
                             int K, int N, int splits, int k_per_split,
                             int route, int act, int x_dtype, int out_dtype,
                             void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 2) {
    if (x_dtype != qmm::kBF16 || k_per_split % wgemm::kWK != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    w8::Args a{};
    a.w_scale = w_scale;
    a.bias = bias;
    a.out = out;
    a.partials = static_cast<float*>(partials);
    a.counters = counters;
    a.M = M;
    a.K = K;
    a.N = N;
    a.splits = splits;
    a.kt_per_split = k_per_split / wgemm::kWK;
    a.act = act;
    return w8::run(x, wq, a, out_dtype, st);
  }
  if (route == 1) {
    const int planes = x_dtype == qmm::kBF16 ? 1 : 3;
    if (M < 1 || M > 16 || K % 16 != 0 || N % 16 != 0 ||
        !hop::aligned16(x) || !hop::aligned16(wq) || k_per_split < 16 ||
        k_per_split % 16 != 0 ||
        planes * k_per_split * qmm::w8_rows(M) > 2 * qmm::kW8Stage ||
        splits < 1 || splits * k_per_split < K ||
        (splits - 1) * k_per_split >= K ||
        (splits > 1 && (partials == nullptr || counters == nullptr)))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const qmm::Args a = make_args(x, nullptr, wq, w_scale, bias, out, partials,
                                counters, M, K, N, splits, k_per_split, act);
  return qmm::dispatch<qmm::kW8>(a, route == 1, x_dtype, out_dtype, st);
}
