// The INT8 tensor-core product of B10 and B15 for Hopper (sm_90a):
//
//   out[m, n] = act(fma(f32(sum_k x[m, k] * W[k, n]) * x_scale[m],
//                       w_scale[n], bias[n]))
//
// x int8 [M, K] (quantized per row outside the kernel), W int8 in one of
// two layouts, both N-contiguous as the port stores them:
//   kMatrix  W [K, N] (int8_matmul.cu, B10 for M > 16);
//   kPacked  the chain blocks [G, bk, bn] (chain_linear.cu, B15 under
//            w8a8): op block (n, k) at g0 + n * KB + k, bk and bn
//            multiples of 128.
// The s8 x s8 products are summed in s32, exactly whatever the order
// (127^2 * K < 2^31 for K < 133,000); the epilogue is qmatmul.cuh's
// finish (one __int2float_rn on the final sum, __fmul_rn by x_scale,
// __fmaf_rn with w_scale and the bias, or __fmul_rn without one, the
// activation, one rounding), so the kernel agrees with the plain versions
// bit for bit at every M, K, N and split.
//
// What bounds it on the H100: a Llama-3-8B layer's four products at M =
// 256 move 218 MB of weights (0.065 ms at 3.35 TB/s) and do 112 G integer
// operations (0.056 ms at 1,979 TOPS), so both the weight stream and the
// tensor cores do; at M = 36 (a verify chunk) the weight bytes alone.
//
// The design. wgmma's s8 product has no transpose bit: both operands are
// read K-major from shared memory, while every weight of the port is
// N-contiguous (and B14 and the gemv read it so). Each block owns an
// output tile of BM = 128 rows (two consumer warpgroups of 64; BM = 64
// and one warpgroup where M <= 64) by 128 columns, and loops over its
// share of K in k-tiles of 128. A producer warp keeps TMA loads in
// flight, each into a ring of stages under full / empty mbarriers: the x
// tile [BM, 128 k] with the 128-byte swizzle (already K-major, wgmma's A),
// and the raw weight tile [128 k, 128 n] with the same swizzle (a 2-D map
// over [K, N], or a 3-D map over [G, bk, bn] so that a tile never leaves
// its block). The consumers byte-transpose each raw tile once into the
// K-major swizzled tile [128 n, 128 k] (wgmma's B), into one of three
// buffers while the products of the previous k-tile run (B13's overlap),
// so the tensor cores are not left idle while it happens: a k-tile is
// four m64n128k32 products a warpgroup, s32 accumulators in registers
// (64 a thread). Each thread of the transpose reads 16 rows of k at 4
// columns (one 4-byte word a row: a warp reads whole 128-byte rows, no
// bank conflict), turns each 4 x 4 byte block into column words with
// __byte_perm (as the gemv does in registers) and writes four 16-byte
// chunks, one per column; it takes its 4 columns in an order rotated by
// its lane so that the eight lanes of each store phase write eight
// different chunk positions (the swizzle then spreads them over all 32
// banks). (The alternative, y^T = W^T x^T with the transposed weight as a
// register A operand, needs the transpose across lanes by shuffles, 4
// bytes of k a register, and then reads x as B through the same
// K-major-only rule; the shared-memory round trip is the simpler of the
// two, and it hides under the products.)
//
// Blocks run row tiles fastest, so the row tiles that share a weight
// tile run together and its second read comes from the 50 MB L2. The
// epilogue stages the tile's s32 sums in shared memory (over the rings,
// free by then) and writes whole rows of 16-byte chunks, its scales
// loaded once: written straight from the accumulator registers, 8 rows of
// 4 bytes an instruction with a scale load behind each store, the outputs
// and partial sums took longer than the products. Where the output tiles
// fall short of the 132 SMs, the host splits K into as many ranges of
// whole k-tiles (kt_per_split a block) as still fit one wave of blocks:
// each split writes its s32 tile to its slot of a workspace [splits,
// tiles, BM x 128], and the last block of a tile to arrive (a counter per
// tile, reset by that block) adds the others' to its own and runs the
// epilogue: exact, so the order does not matter, and deterministic. Tile
// edges come from TMA's zero fill (rows past M, k past K, columns past N)
// and masked stores. The host needs K % 16 == 0, 16-byte aligned x and
// W, and for kMatrix N % 16 == 0 (TMA's 16-byte strides; the wrappers
// zero-pad). Both tensor maps are encoded per call, as B13's are.
//
// What bounds it as built (tensor_core_phases.py's cuts, PERF.md): the
// tiles' trip from L2 into shared memory. At M = 256 the loads, barriers
// and epilogue alone take three quarters of the kernel's time, the
// transpose and the products the last quarter. Cluster multicast of the
// tiles that several blocks read is the next step.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "hopper.cuh"
#include "qmatmul.cuh"

namespace imma {

enum WMode { kMatrix = 0, kPacked = 1 };

constexpr int kBK = 128;  // k-tile: one 128-byte swizzled row of INT8
constexpr int kBN = 128;  // columns of a block: one m64n128k32 product
// x stages: at least 3, since the producer issues x's load of tile kt + 1
// (which waits for the release of tile kt + 1 - kS, at iteration kt + 2 -
// kS) before the raw load of tile kt + 1 that iteration kt waits for; a
// fourth keeps x's loads a tile further ahead of that wait
constexpr int kS = 4;
constexpr int kR = 2;     // raw weight stages
constexpr int kT = 3;     // transposed buffers: 2 k-tiles in flight, 1 filling
// ints a row of the epilogue's s32 tile: 8 past the 128 columns, so the
// accumulators' 8-byte stores (rows lane / 4, columns 2 (lane % 4)) meet
// no bank twice in a half-warp
constexpr int kLd = kBN + 8;

template <int NC>
struct Layout {
  static constexpr int BM = 64 * NC;
  static constexpr int NT = 128 * NC;      // consumer threads
  static constexpr int THREADS = NT + 32;  // + the producer warp
  static constexpr int X_BYTES = BM * kBK;
  static constexpr int W_BYTES = kBN * kBK;  // a raw or transposed tile
  static constexpr int X_OFF = 0;
  static constexpr int RAW_OFF = X_OFF + kS * X_BYTES;
  static constexpr int T_OFF = RAW_OFF + kR * W_BYTES;
  static constexpr int BAR_OFF = T_OFF + kT * W_BYTES;
  // the barriers, and room to align the dynamic buffer to 1024 bytes
  static constexpr int BYTES = BAR_OFF + 8 * (2 * kS + 2 * kR) + 1024;
  // the epilogue's s32 tile fits over the x and raw rings, its row
  // scales in the transposed buffers
  static_assert(BM * kLd * 4 <= T_OFF, "the epilogue tile overlaps T");
};

struct Args {
  const float* x_scale;  // [M]
  const float* w_scale;  // [N]
  const float* bias;     // [N] or null
  void* out;             // [M, N] f32 or bf16
  int* partials;         // [splits, tiles, BM * 128] s32 (splits > 1)
  int* counters;         // one zeroed int per output tile (splits > 1)
  int M, K, N;
  int splits, kt_per_split;  // k-tiles of a split
  int act;
  int g0, KB, bk, bn;        // kPacked: the run's first block and geometry
};

// The raw weight tile at global k-tile kt and columns n0.. into `dst`.
template <int MODE>
__device__ __forceinline__ void load_w(void* dst, const CUtensorMap* wmap,
                                       const Args& a, int n0, int kt,
                                       uint64_t* bar) {
  if constexpr (MODE == kMatrix) {
    hop::tma_load_2d(dst, wmap, n0, kt * kBK, bar);
  } else {
    const int k = kt * kBK, kb = k / a.bk, nb = n0 / a.bn;
    hop::tma_load_3d(dst, wmap, n0 - nb * a.bn, k - kb * a.bk,
                     a.g0 + nb * a.KB + kb, bar);
  }
}

// The raw tile [128 k][128 n] (row k's 16-byte chunk c at c ^ (k % 8))
// into the K-major tile [128 n][128 k] with the same swizzle. Unit (kc,
// ng), one a thread where NT = 256: rows 16 kc .. + 15 at columns
// 4 ng .. + 3 (a warp shares kc, so each of its 16 loads reads one whole
// row); out, column 4 ng + j's chunk kc, taken in the order j = s + rot.
template <int NT>
__device__ __forceinline__ void transpose_tile(const uint8_t* raw,
                                               uint8_t* t, int ct) {
#pragma unroll
  for (int u = ct; u < 256; u += NT) {
    const int kc = u / 32, ng = u % 32;
    const int c = ng >> 2, wo = (ng & 3) << 2;
    uint32_t w[16];
#pragma unroll
    for (int r = 0; r < 16; ++r)  // (16 kc + r) % 8 == r % 8
      w[r] = *reinterpret_cast<const uint32_t*>(
          raw + (16 * kc + r) * 128 + ((c ^ (r & 7)) << 4) + wo);
    const int rot = (ng >> 1) & 3;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int j = (s + rot) & 3;
      const uint32_t sel = j | ((j + 4) << 4);  // byte j of each of two
      uint32_t q[4];
#pragma unroll
      for (int b = 0; b < 4; ++b)  // k 16 kc + 4 b .. + 3 of column j
        q[b] = __byte_perm(__byte_perm(w[4 * b], w[4 * b + 1], sel),
                           __byte_perm(w[4 * b + 2], w[4 * b + 3], sel),
                           0x5410);
      const int n = 4 * ng + j;
      *reinterpret_cast<uint4*>(t + n * 128 + ((kc ^ (n & 7)) << 4)) =
          make_uint4(q[0], q[1], q[2], q[3]);
    }
  }
}

// The epilogue of one output (qmatmul.cuh's finish for kI8A8), on scales
// and a bias already in registers.
__device__ __forceinline__ float finish(int acc, float xs, float ws, float b,
                                        bool has_bias, int act) {
  const float s = __fmul_rn(__int2float_rn(acc), xs);
  return qmm::activate(has_bias ? __fmaf_rn(s, ws, b) : __fmul_rn(s, ws),
                       act);
}

// Four outputs at out[i..i+3] (i a multiple of 4), one rounding each.
template <typename OT>
__device__ __forceinline__ void store4(void* out, long long i,
                                       const float (&y)[4]) {
  if constexpr (std::is_same<OT, float>::value) {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + i) =
        make_float4(y[0], y[1], y[2], y[3]);
  } else {
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + i) =
        make_uint2(hop::pack_bf16(y[0], y[1]), hop::pack_bf16(y[2], y[3]));
  }
}

template <int MODE, int NC, typename OT>
__global__ void __launch_bounds__(Layout<NC>::THREADS, 1)
    wgmma_s8_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap, const Args a) {
  using Lay = Layout<NC>;
  constexpr int NT = Lay::NT;
  extern __shared__ uint8_t smem_dyn[];
  __shared__ int is_last;
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_dyn) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * Lay::BM, n0 = blockIdx.y * kBN;
  const int kt0 = blockIdx.z * a.kt_per_split;
  const int nk = min((a.K + kBK - 1) / kBK - kt0, a.kt_per_split);
  uint64_t* xfull = reinterpret_cast<uint64_t*>(smem + Lay::BAR_OFF);
  uint64_t* xempty = xfull + kS;
  uint64_t* rawfull = xempty + kS;
  uint64_t* rawempty = rawfull + kR;
  if (tid == 0) {
    for (int i = 0; i < kS; ++i) {
      hop::mbar_init(&xfull[i], 1);
      hop::mbar_init(&xempty[i], NT);
    }
    for (int i = 0; i < kR; ++i) {
      hop::mbar_init(&rawfull[i], 1);
      hop::mbar_init(&rawempty[i], NT);
    }
    hop::mbar_fence_init();
  }
  __syncthreads();
  const int wg = hop::warpgroup();
  uint8_t* const x0 = smem + Lay::X_OFF;
  uint8_t* const raw0 = smem + Lay::RAW_OFF;
  uint8_t* const t0 = smem + Lay::T_OFF;

  if (wg == NC) {
    // the producer warp: x and raw weight tiles into their rings, each
    // stage reused once its readers release it
    if (tid == NT) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kS, r = kt % kR;
        if (kt >= kS) hop::mbar_wait(&xempty[s], (kt / kS - 1) & 1);
        hop::mbar_arrive_tx(&xfull[s], Lay::X_BYTES);
        hop::tma_load_2d(x0 + s * Lay::X_BYTES, &xmap, (kt0 + kt) * kBK, m0,
                         &xfull[s]);
        if (kt >= kR) hop::mbar_wait(&rawempty[r], (kt / kR - 1) & 1);
        hop::mbar_arrive_tx(&rawfull[r], Lay::W_BYTES);
        load_w<MODE>(raw0 + r * Lay::W_BYTES, &wmap, a, n0, kt0 + kt,
                     &rawfull[r]);
      }
    }
    return;
  }

  // consumer warpgroup wg: rows m0 + 64 wg .. + 63. Each k-tile: issue the
  // products on the transposed tile kt, transpose tile kt + 1 into another
  // of the three buffers while they run, wait for the products of tile
  // kt - 1 (those of kt stay in flight), release x's stage of kt - 1, and
  // meet the other consumers (tile kt + 1 whole, tile kt - 1's buffer
  // read, so tile kt + 2 may overwrite it).
  hop::mbar_wait(&rawfull[0], 0);
  transpose_tile<NT>(raw0, t0, tid);
  hop::fence_async_smem();
  hop::mbar_arrive(&rawempty[0]);
  hop::named_sync(1, NT);

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  hop::fence_regs(acc);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kS;
    hop::mbar_wait(&xfull[s], (kt / kS) & 1);
    const uint8_t* xs = x0 + s * Lay::X_BYTES + wg * 64 * kBK;
    const uint8_t* tb = t0 + (kt % kT) * Lay::W_BYTES;
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)
      hop::mma_s8_n128(acc, hop::desc(xs + kk * 32, 16, 1024),
                       hop::desc(tb + kk * 32, 16, 1024), 1);
    hop::wgmma_commit();
    if (kt + 1 < nk) {
      const int r = (kt + 1) % kR;
      hop::mbar_wait(&rawfull[r], ((kt + 1) / kR) & 1);
      transpose_tile<NT>(raw0 + r * Lay::W_BYTES,
                         t0 + ((kt + 1) % kT) * Lay::W_BYTES, tid);
      hop::fence_async_smem();
      hop::mbar_arrive(&rawempty[r]);
    }
    hop::wgmma_wait<1>();
    if (kt > 0) hop::mbar_arrive(&xempty[(kt - 1) % kS]);
    hop::named_sync(1, NT);
  }
  hop::wgmma_wait<0>();
  hop::fence_regs(acc);

  // The epilogue goes through shared memory, so that every global access
  // is a whole row's run of 16-byte chunks: the tile's s32 sums over the x
  // and raw rings (every stage read, no load in flight, the other
  // warpgroup's products done after the first meeting), rows of kLd ints.
  // Thread tid holds, for each 8-column group i, rows rl and rl + 8 at
  // columns 8 i + cl + 0..1.
  hop::named_sync(1, NT);
  int* tile = reinterpret_cast<int*>(smem + Lay::X_OFF);
  float* row_scale = reinterpret_cast<float*>(smem + Lay::T_OFF);
  {
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int rl = 64 * wg + 16 * warp + lane / 4, cl = 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<int2*>(tile + (rl + 8 * h) * kLd + 8 * i + cl) =
            make_int2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
  }
  for (int r = tid; r < Lay::BM; r += NT)
    row_scale[r] = m0 + r < a.M ? __ldg(a.x_scale + m0 + r) : 0.0f;
  hop::named_sync(1, NT);
  // Chunk c = tid + k NT (k < PER) of 4 columns: row c / 32, columns
  // 4 (c % 32) ..; every chunk of a thread has the same columns.
  constexpr int PER = Lay::BM * 32 / NT;
  const int chunks = min(Lay::BM, a.M - m0) * 32, q = tid % 32;
  auto at = [&](int c) {
    return reinterpret_cast<int4*>(tile + (c / 32) * kLd + 4 * (c % 32));
  };
  if (a.splits > 1) {
    // each split's sums to its slot of the workspace; the last block of
    // the tile to arrive adds the others' to its own (s32: exact, in any
    // order) and runs the epilogue
    const int tile_id = blockIdx.y * gridDim.x + blockIdx.x;
    const long long slot = static_cast<long long>(Lay::BM) * kBN / 4;
    const long long tiles = static_cast<long long>(gridDim.x) * gridDim.y;
    int4* part = reinterpret_cast<int4*>(a.partials) + tile_id * slot;
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
    int4 v[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int c = tid + k * NT;
      v[k] = c < chunks ? *at(c) : make_int4(0, 0, 0, 0);
    }
    for (int sp = 0; sp < a.splits; ++sp) {
      if (sp == static_cast<int>(blockIdx.z)) continue;
      const int4* other = part + sp * tiles * slot;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int c = tid + k * NT;
        if (c >= chunks) continue;
        const int4 p = __ldcg(other + c);
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
    ws[e] = n + e < a.N ? __ldg(a.w_scale + n + e) : 0.0f;
    bs[e] = has_bias && n + e < a.N ? __ldg(a.bias + n + e) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int c = tid + k * NT;
    if (c >= chunks) break;
    const int4 v = *at(c);
    const int s[4] = {v.x, v.y, v.z, v.w};
    const float xs = row_scale[c / 32];
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      y[e] = finish(s[e], xs, ws[e], bs[e], has_bias, a.act);
    const long long o = static_cast<long long>(m0 + c / 32) * a.N + n;
    if (a.N % 4 == 0) {
      store4<OT>(a.out, o, y);
    } else {
      for (int e = 0; e < 4 && n + e < a.N; ++e)
        qmm::store<OT>(a.out, o + e, y[e]);
    }
  }
}

// -- host ------------------------------------------------------------------

// An INT8 tensor map of `rank` (2 or 3) dims (innermost first) with the
// 128-byte swizzle and boxes of 128 bytes by `rows` rows (by 1 in a third
// dim); zeros past the edges.
inline bool encode_u8(CUtensorMap* map, const void* p, int rank,
                      const cuuint64_t* dims, const cuuint64_t* strides,
                      cuuint32_t rows) {
  const hop::EncodeTiled encode = hop::encode_tiled();
  const cuuint32_t box[3] = {kBK, rows, 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank,
                const_cast<void*>(p), dims, strides, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MODE, int NC, typename OT>
cudaError_t launch(const CUtensorMap& xmap, const CUtensorMap& wmap,
                   const Args& a, cudaStream_t st) {
  using Lay = Layout<NC>;
  auto kernel = wgmma_s8_kernel<MODE, NC, OT>;
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
  kernel<<<dim3((a.M + Lay::BM - 1) / Lay::BM, (a.N + kBN - 1) / kBN,
                a.splits),
           Lay::THREADS, Lay::BYTES, st>>>(xmap, wmap, a);
  return cudaGetLastError();
}

// x [M, K] int8; the weight `w` as a tensor of `w_rank` dims `w_dims`
// (innermost first; kMatrix {N, K}, kPacked {bn, bk, G}) and byte strides
// `w_strides`; out in out_dtype (qmm::kF32 or kBF16).
template <int MODE>
int run(const void* x, const void* w, int w_rank, const cuuint64_t* w_dims,
        const cuuint64_t* w_strides, const Args& a, int out_dtype,
        cudaStream_t st) {
  const int nk = (a.K + kBK - 1) / kBK;
  if (a.M <= 0 || a.K <= 0 || a.N <= 0 || a.K % 16 != 0 ||
      !hop::aligned16(x) || !hop::aligned16(w) || a.splits < 1 ||
      a.kt_per_split < 1 || a.splits * a.kt_per_split < nk ||
      (a.splits - 1) * a.kt_per_split >= nk ||
      (a.splits > 1 && (a.partials == nullptr || a.counters == nullptr)))
    return cudaErrorInvalidValue;
  const int nc = a.M <= 64 ? 1 : 2;
  CUtensorMap xmap, wmap;
  const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(a.K),
                                static_cast<cuuint64_t>(a.M)};
  const cuuint64_t x_strides[1] = {static_cast<cuuint64_t>(a.K)};
  if (!encode_u8(&xmap, x, 2, x_dims, x_strides, 64 * nc) ||
      !encode_u8(&wmap, w, w_rank, w_dims, w_strides, kBK))
    return cudaErrorInvalidValue;
  const bool bf = out_dtype == qmm::kBF16;
  if (nc == 1)
    return bf ? launch<MODE, 1, __nv_bfloat16>(xmap, wmap, a, st)
              : launch<MODE, 1, float>(xmap, wmap, a, st);
  return bf ? launch<MODE, 2, __nv_bfloat16>(xmap, wmap, a, st)
            : launch<MODE, 2, float>(xmap, wmap, a, st);
}

}  // namespace imma
