// INT4-weight matrix product for Hopper (kernels in qmatmul.cuh and, past
// 16 rows with bf16 x, below on widen_gemm.cuh's INT4 mainloop).
//
//   pbt_w4_matmul  <- ops/int4_matmul.py::w4_matmul (_w4_kernel :41,
//                     pallas_call :146), B12: act(x @ dequant_int4(packed,
//                     scales) + bias), f32 sums (every projection and the
//                     LM head under quant="int4").
//
// The carrier keeps the JAX package's block-local layout for block width
// bn (quant/tensor.py::pack_int4): carrier column j*bn/2 + t holds weight
// column j*bn + t in its low nibble (offset-binary, q + 8) and column
// j*bn + bn/2 + t in its high nibble (two's complement). The quantizer
// picks bn per weight (2048 for Llama-3-8B's projections, 768 for its
// 128256-column LM head), so the kernels take it as an argument; no weight
// is repacked. The scale applies per (K-group of `group` rows, column).
//
// Three routes (ops/int4_matmul.py::w4_plan):
// * M <= 16: qmatmul.cuh's gemv_w4_kernel. Bytes bound it (half a byte a
//   weight plus one f32 scale per 128 weights) once the products leave the
//   CUDA cores: mma.sync with the weights as the A operand (pairs of k
//   built from two carrier rows), 16 carrier bytes (32 columns) a lane a
//   row, x staged in shared memory once (f32 x as three bf16 planes), the
//   scale applied once a unit of K rows on the unit's sums.
// * M > 16, bf16 x, bn/2 % 128 == 0, group % 64 == 0: w4_wgmma_kernel
//   below. What bounds it: a Llama-3-8B layer's four products at M = 256
//   do 112 GFLOP (0.113 ms at 989 TFLOP/s in bf16) against 88 MB of
//   carrier (0.026 ms at 3.35 TB/s), the LM head 269 GFLOP (0.272 ms):
//   operations. The design is B11's (widen_gemm.cuh: TMA rings, the weight
//   widened to bf16 in shared memory while the previous k-tile's
//   m64n128k16 products run, a one-wave K split merged in split order by
//   the last block of a tile, the epilogue staged in shared memory) with
//   mainloop_w4: a raw tile of 64 k x 128 carrier columns feeds the low
//   and the high nibbles' 128-column runs, one consumer warpgroup each,
//   over the same 64 rows of x; each K-group's f32 partial sums are
//   folded into the tile's with that group's scales (no scale rounds a
//   weight). Where the output tiles fall short of one wave of blocks, K is
//   split into ranges of whole k-tiles (at most 16), each split's sums
//   into an f32 workspace [splits, tiles, 64 x 256], the last block of a
//   tile to arrive adding them in split order. The epilogue: + bias in
//   one rounding, the activation, one rounding to the output type (the
//   plain version's points). Its sums differ from the plain version's
//   f32 product (sum of x * fl(q * s)) by the order of the sums and the
//   place of the scale only. Needs K % 64 == 0, N % 256 == 0 (as bn/2 %
//   128 == 0 implies), and 16-byte aligned x, carrier, scales and out;
//   TMA fills the rows past M with zeros and the stores are masked. The
//   three tensor maps are encoded per call.
// * otherwise (f32 x past 16 rows, other layouts): qmatmul.cuh's CUDA-core
//   tiled_kernel, with each widened weight times its scale.
//
// The entry point returns cudaGetLastError() after its launch.

#include <atomic>

#include "imma.cuh"
#include "qmatmul.cuh"
#include "widen_gemm.cuh"

namespace w4 {

// floats a row of the epilogue's staged f32 tile (as B11's)
constexpr int kLd = wgemm::kWN + 8;
constexpr int kBM = 64;  // rows of an output tile

struct Args {
  const float* bias;  // [N] or null
  void* out;          // [M, N] f32 or bf16
  float* partials;    // [splits, tiles, 64 * 256] (splits > 1)
  int* counters;      // one zeroed int per output tile (splits > 1)
  int M, K, N;
  int splits, kt_per_split;  // k-tiles of 64 a split
  int tpg;                   // k-tiles a K-group
  int half;                  // bn / 2
  int act;
};

// grid (ceil(M / 64), N / 256, splits): blockIdx.y takes carrier columns
// 128 y .. 128 y + 127, the output columns nlo .. nlo + 127 (low nibbles)
// and nlo + bn/2 .. (high nibbles).
template <typename OT>
__global__ void __launch_bounds__(wgemm::W4Layout::THREADS, 1)
    w4_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap,
                    const __grid_constant__ CUtensorMap smap, const Args a) {
  using Lay = wgemm::W4Layout;
  constexpr int BM = kBM, NT = Lay::NT, BN = wgemm::kWN;
  // the staged tile fits over the x ring and the widened buffers
  static_assert(BM * kLd * 4 <= Lay::SC_OFF, "the tile overlaps the ring");
  extern __shared__ uint8_t smem_dyn[];
  __shared__ int is_last;
  uint8_t* smem = wgemm::aligned_smem(smem_dyn);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, c0 = blockIdx.y * wgemm::kW4C;
  const int j = c0 / a.half;
  const int nlo = j * 2 * a.half + (c0 - j * a.half), nhi = nlo + a.half;
  const int kt0 = blockIdx.z * a.kt_per_split;
  const int nk = min(a.K / wgemm::kWK - kt0, a.kt_per_split);
  float acc[64];
  if (!wgemm::mainloop_w4(
          smem, &xmap, m0, kt0, nk, a.tpg,
          [&](uint8_t* dst, int kt, uint64_t* bar) {
            const int g = kt / a.tpg;
            hop::tma_load_2d(dst, &wmap, c0, kt * wgemm::kWK, bar);
            hop::tma_load_2d(dst + Lay::RAW_BYTES, &smap, nlo, g, bar);
            hop::tma_load_2d(dst + Lay::RAW_BYTES + wgemm::kW4C * 4, &smap,
                             nhi, g, bar);
          },
          acc))
    return;

  // The tile's f32 sums into shared memory over the x ring and the
  // widened buffers (every product done and every stage read once the
  // consumers meet), rows of kLd floats: the low run in columns 0..127,
  // the high run in 128..255. Thread tid holds, for each 8-column group i
  // of its run, rows rl and rl + 8 at columns 8 i + cl + 0..1.
  hop::named_sync(1, NT);
  float* tile = reinterpret_cast<float*>(smem);
  {
    const int wg = hop::warpgroup();
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int rl = 16 * warp + lane / 4, cl = 128 * wg + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < 16; ++i)
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
    // the tile to arrive adds all the splits' in split order and runs the
    // epilogue
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
  const int lc = 4 * q;  // the chunk's first column in the tile
  const int n = (lc < wgemm::kW4C ? nlo : nhi) + lc % wgemm::kW4C;
  const bool has_bias = a.bias != nullptr;
  float bs[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) bs[e] = has_bias ? __ldg(a.bias + n + e) : 0.f;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int c = tid + k * NT;
    if (c >= chunks) break;
    const float4 v = *at(c);
    const float s[4] = {v.x, v.y, v.z, v.w};
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      y[e] = qmm::activate(has_bias ? __fadd_rn(s[e], bs[e]) : s[e], a.act);
    imma::store4<OT>(a.out,
                     static_cast<long long>(m0 + c / (BN / 4)) * a.N + n, y);
  }
}

template <typename OT>
cudaError_t launch(const CUtensorMap& xmap, const CUtensorMap& wmap,
                   const CUtensorMap& smap, const Args& a, cudaStream_t st) {
  using Lay = wgemm::W4Layout;
  auto kernel = w4_wgmma_kernel<OT>;
  // the shared-memory limit, set once per device (as B11's)
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
  kernel<<<dim3((a.M + kBM - 1) / kBM, a.N / wgemm::kWN, a.splits),
           Lay::THREADS, Lay::BYTES, st>>>(xmap, wmap, smap, a);
  return cudaGetLastError();
}

// x [M, K] bf16, the carrier [K, N/2] int8, scales [K / group, N] f32; out
// in out_dtype (qmm::kF32 or kBF16).
int run(const void* x, const void* w, const float* scales, int group,
        const Args& a, int out_dtype, cudaStream_t st) {
  using wgemm::kWK;
  const int nk = a.K / kWK;
  if (a.M <= 0 || a.K <= 0 || a.K % kWK != 0 || group % kWK != 0 ||
      a.K % group != 0 || a.half % wgemm::kW4C != 0 ||
      a.N % (2 * a.half) != 0 || a.tpg != group / kWK ||
      !hop::aligned16(x) || !hop::aligned16(w) || !hop::aligned16(scales) ||
      !hop::aligned16(a.out) || a.splits < 1 || a.kt_per_split < 1 ||
      a.splits * a.kt_per_split < nk ||
      (a.splits - 1) * a.kt_per_split >= nk ||
      (a.splits > 1 && (a.partials == nullptr || a.counters == nullptr)))
    return cudaErrorInvalidValue;
  const hop::EncodeTiled encode = hop::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap xmap, wmap, smap;
  const cuuint32_t ones[2] = {1, 1};
  const cuuint64_t wdim[2] = {static_cast<cuuint64_t>(a.N / 2),
                              static_cast<cuuint64_t>(a.K)};
  const cuuint64_t wstride[1] = {static_cast<cuuint64_t>(a.N / 2)};
  const cuuint32_t wbox[2] = {wgemm::kW4C, kWK};
  const cuuint64_t sdim[2] = {static_cast<cuuint64_t>(a.N),
                              static_cast<cuuint64_t>(a.K / group)};
  const cuuint64_t sstride[1] = {static_cast<cuuint64_t>(a.N) * 4};
  const cuuint32_t sbox[2] = {wgemm::kW4C, 1};
  if (!wgemm::encode_x(&xmap, x, a.K, a.M, kBM) ||
      encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w),
             wdim, wstride, wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&smap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<float*>(scales), sdim, sstride, sbox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return out_dtype == qmm::kBF16
             ? launch<__nv_bfloat16>(xmap, wmap, smap, a, st)
             : launch<float>(xmap, wmap, smap, a, st);
}

}  // namespace w4

// route 1: gemv_w4_kernel ((bn / 2) % 16 == 0, x, the carrier and the
// scales 16-byte aligned, k_per_split a multiple of the unit of K rows, times x's
// planes at most qmm::kW4Stage); route 2: w4_wgmma_kernel (bf16 x; see run; k_per_split
// rows a split, a multiple of 64); route 0: the CUDA-core tiled kernel
// (any shape the quantizer makes).
extern "C" int pbt_w4_matmul(const void* x, const void* packed,
                             const float* scales, const float* bias,
                             void* out, void* partials, int* counters, int M,
                             int K, int N, int group, int bn, int splits,
                             int k_per_split, int route, int act, int x_dtype,
                             int out_dtype, void* stream) {
  if (group <= 0 || bn <= 0 || bn % 2 != 0 || N % bn != 0 || K % group != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 2) {
    if (x_dtype != qmm::kBF16 || k_per_split % wgemm::kWK != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    w4::Args a{};
    a.bias = bias;
    a.out = out;
    a.partials = static_cast<float*>(partials);
    a.counters = counters;
    a.M = M;
    a.K = K;
    a.N = N;
    a.splits = splits;
    a.kt_per_split = k_per_split / wgemm::kWK;
    a.tpg = group / wgemm::kWK;
    a.half = bn / 2;
    a.act = act;
    return w4::run(x, packed, scales, group, a, out_dtype, st);
  }
  qmm::Args a;
  a.x = x;
  a.x_scale = nullptr;
  a.w = packed;
  a.w_scale = scales;
  a.bias = bias;
  a.out = out;
  a.partials = partials;
  a.counters = counters;
  a.M = M;
  a.K = K;
  a.N = N;
  a.splits = splits;
  a.k_per_split = k_per_split;
  a.group = group;
  a.bn = bn;
  a.act = act;
  const int unit = qmm::w4_unit(group);
  const int planes = x_dtype == qmm::kBF16 ? 1 : 3;  // gemv_w4_kernel's
  if (route == 1 &&
      ((bn / 2) % 16 != 0 || unit % 16 != 0 || k_per_split % unit != 0 ||
       planes * k_per_split > qmm::kW4Stage || !hop::aligned16(x)))
    return static_cast<int>(cudaErrorInvalidValue);
  return qmm::dispatch<qmm::kW4>(a, route == 1, x_dtype, out_dtype, st);
}
