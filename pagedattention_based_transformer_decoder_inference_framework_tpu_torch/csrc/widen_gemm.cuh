// The mainloop of the bf16 x INT8 (or bf16) tensor-core products for
// Hopper (sm_90a), shared by gmm.cu (B13's wgmma_kernel, one expert's
// weight a row block) and int8_matmul.cu (B11's w8_wgmma_kernel, w8_matmul
// past 16 rows with bf16 x):
//
//   acc[m, n] = sum_k x[m, k] * widen(W[k, n])   (f32 sums)
//
// for one output tile of BM = 64 NC rows by kWN = 256 columns over a run of
// k-tiles of kWK = 64. A producer warp keeps TMA loads in flight, each into
// a ring of stages under full / empty mbarriers: the x tile [BM, 64 k]
// through a tensor map with the 128-byte swizzle that wgmma reads (K-major
// A), and the raw weight tile [64 k, 256 n] through the caller's map (its
// `load_w`: a 3-D map over [E, K, N] for B13, so a ragged K reads zeros,
// not the next expert; a 2-D map over [K, N] for B11). The NC consumer
// warpgroups (64 rows each) widen each raw tile once to bf16 (INT8
// exactly; a bf16 tile as it is) into the swizzled MN-major layout, which
// they read as B with wgmma's transpose bit: a k-tile's four m64n256k16
// products (f32 accumulators in registers, 128 a thread) are issued, then
// the next raw tile is widened into another of three buffers while they
// run, so the widening (16 INT8 values a load, two 16-byte swizzled
// stores) hides under the tensor cores' work, and the products of two
// k-tiles stay in flight. (The alternative, the swapped product y^T = W^T
// x^T with the widened weight as the A operand in registers, would read
// each weight byte in a strided, bank-conflicting pattern.) Each widened
// weight tile serves the tile's BM rows; the callers run row tiles
// fastest, so the row tiles that share a weight tile run together and its
// second read comes from the 50 MB L2. The epilogues are the callers'.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace wgemm {

constexpr int kWK = 64;   // k-tile: one 128-byte swizzled row of bf16
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
  static constexpr int NT = 128 * NC;            // consumer threads
  static constexpr int THREADS = NT + 32;        // + the producer warp
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

// The dynamic shared memory of a block, aligned to 1024 bytes (the
// swizzled tiles' boundary).
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* dyn) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(dyn) + 1023) & ~uintptr_t(1023));
}

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

// One output tile's products: x rows m0 .. m0 + BM - 1 through `xmap`,
// k-tiles kt0 .. kt0 + nk - 1 (nk >= 1), the raw weight tile of global
// k-tile kt brought by load_w(dst, kt, bar). Every thread of the block
// calls it (it initialises the barriers and meets the block once).
// Returns false in the producer warp, whose work is then done, and true
// in the consumer threads, whose `acc` then holds the tile's f32 sums in
// wgmma's accumulator layout (hopper.cuh) with every product finished;
// the rings are still in use by the other consumers until they meet.
template <int NC, typename WT, typename LoadW>
__device__ __forceinline__ bool mainloop(uint8_t* smem,
                                         const CUtensorMap* xmap, int m0,
                                         int kt0, int nk, LoadW load_w,
                                         float (&acc)[128]) {
  using Lay = WLayout<NC, WT>;
  constexpr int S = Lay::S, R = Lay::R, NT = Lay::NT;
  const int tid = threadIdx.x;
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
        hop::tma_load_2d(smem + Lay::X_OFF + s * Lay::X_BYTES, xmap,
                         (kt0 + kt) * kWK, m0, &xfull[s]);
        if (kt >= R) hop::mbar_wait(&rawempty[r], (kt / R - 1) & 1);
        hop::mbar_arrive_tx(&rawfull[r], Lay::RAW_BYTES);
        load_w(raw0 + r * Lay::RAW_BYTES, kt0 + kt, &rawfull[r]);
      }
    }
    return false;
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
  return true;
}

// The host's tensor map of bf16 x [rows, K] (K % 8 == 0, 16-byte aligned):
// boxes of 64 k by `box_rows` rows with the 128-byte swizzle, zeros past
// the edges.
inline bool encode_x(CUtensorMap* map, const void* x, int K, int rows,
                     int box_rows) {
  const hop::EncodeTiled encode = hop::encode_tiled();
  const cuuint64_t dim[2] = {static_cast<cuuint64_t>(K),
                             static_cast<cuuint64_t>(rows)};
  const cuuint64_t stride[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t box[2] = {kWK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t ones[2] = {1, 1};
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(x), dim, stride, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace wgemm
