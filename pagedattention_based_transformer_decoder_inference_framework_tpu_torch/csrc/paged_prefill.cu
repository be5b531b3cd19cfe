// Paged attention of a chunk of bf16 queries on the tensor cores, for
// Hopper.
//
//   pbt_paged_attention_wgmma <- ops/paged_attention.py::paged_attention
//                                (paged_attention.py:219; its page step
//                                _attend, :104-131), B1: a T >= 1 query
//                                chunk (chunked prefill, the speculative
//                                verify chunk, score_nll), causal by
//                                absolute position, GQA rows t*G+g, for
//                                bf16 queries over an INT8 or bf16 pool at
//                                a head dim that is a multiple of 16 up to
//                                256 (ops/paged_attention.py::prefill_route;
//                                f32 queries and other head dims take
//                                paged_attention.cu's kernel).
//
// What it computes, in the reference's fold order (paged_attention.cuh):
// per key, s = (q . k) in f32 from bf16 products that are exact, times
// `scale`, times the key's INT8 K scale; tanh softcap; -1e30 where the key
// is not visible (key <= q_pos, key < seq_len, key > q_pos - window);
// online softmax (m, l in f32); p times the key's INT8 V scale; acc = acc *
// alpha + p . v; out = acc / l with the l == 0 -> 1 guard, so a row that
// sees no key comes out as zeros. The scores are not pre-scaled: q enters
// the product as loaded, so no rounding is added there.
//
// Rounding points: the sums of q . k and p . v (f32, in the tensor cores'
// order), and the one new point, p rounded to bf16 for the p . v product
// (wgmma takes bf16 operands). Its relative error is at most 2^-9 per p,
// so the output moves by at most 2^-9 * sum_j p_j |v_j| / l <= 2^-9 *
// max|v| (times the V scale): within the card's 2e-2 of max|out|.
//
// What bounds it on the H100: at path (i)'s last chunk (Llama-3.1-8B, 256
// queries x 4 heads of a KV head over 32,768 keys, dh 128, 32 query heads)
// the products are 4 * 128 * 256 * 32,640 * 32 = 1.37e11 operations, 0.138
// ms at 989 TFLOP/s in bf16, against 69 MB of K/V and scales (0.021 ms at
// 3.35 TB/s): operations bound it, so the products run on wgmma. At the
// slice's shape (4 x 64 queries, <= 128 keys) the work is tiny and the
// launch dominates.
//
// Design. One block per (sequence, KV head, 64 query rows t*G+g): the 64
// rows are one wgmma M, so every K/V tile staged serves 64 rows. Two
// warpgroups: a consumer that issues the products and runs the fold in
// registers, and a converter whose first thread also issues the copies.
// It reads the block table itself and brings each tile of 64 keys with
// cp.async.bulk (a page of `page` rows x dh is one contiguous run per K or
// V in the [L, 2, KH, P, page, D] pool; a page of 64 or more gives one run
// per tile, a smaller one 64 / page runs), with its K and V scales beside
// it, into a ring of raw stages under mbarriers (full by the bytes landed;
// reused once every converter is done with it). The converters widen each
// raw tile to bf16 (INT8 exactly, 16 values a load; bf16 as it is) into
// the 128-byte swizzled layout, a ring of two converted stages under full
// / empty mbarriers; the stages start as zeros, so the columns past dh and
// the rows of keys never loaded hold finite values that the mask (scores)
// and p = 0 (values) drop.
//
// The consumer holds its 64 Q rows in the same layout; per tile, S = Q .
// K^T is 4 x (dh / 64) wgmma m64n64k16 over the padded head dim (Q and K
// K-major; the zero columns add nothing); the fold runs on S's
// accumulator registers, one uniform pass per step (a tile that every row
// sees whole skips the mask); P is packed to bf16 in the register layout
// wgmma takes for A (the accumulator's own); and O += P . V is 4 x (dh /
// 64) wgmma m64n64k16 with V MN-major (transpose bit). The next tile's S
// and this tile's P . V are issued together, and no register of a product
// is touched while it is in flight (else the compiler serializes every
// wgmma). The causal, seq_len and window limits bound the tile range of
// the block, as the page loop's break / continue do in the SIMT kernel.
// At path (i)'s long chunks the conversion (16K INT8 values a tile) and
// the copies of the pages, which all 16 row blocks of a KV head read again
// from L2, take most of the time; the products and the fold hide under
// them, so a second consumer warpgroup gains little.
//
// The per-page score export (return_scores; JAX paged_attention.py:142-160,
// 197-206, 331-343, 369-374) is the same kernel with SCORES set and one more
// output: for every page of the block table, the largest masked logit of
// the block's live rows (row < T*G; the padded rows of the last 64-row block
// hold zeros and do not count) over the page's keys, in the units the fold
// holds (scale * q . k, times the K scale, softcapped, -1e30 where not
// visible: the natural-log units of the softmax, before any exp). Each
// consumer thread reduces its two rows a key, the warp its 16 rows by
// shuffles, and the four warps meet in a double-buffered [4][64] shared
// array behind one named barrier a tile; warp 0 then folds the keys of
// each page (a page below 64 keys is a run of lanes; one of 64 or more takes
// the tile's maximum, several tiles combined by max). The block writes its
// own row of the partial output [B * KH, cdiv(T * G, 64), mp]: -1e30 for
// every page first, then the pages of its tile range, so pages it skips (the
// causal, seq_len and window limits) read -1e30; the wrapper reduces the
// rows by max, as the JAX package reduces its row blocks outside its
// kernel. Partial rows, not an atomic max into [B, mp]: no fill pass, no
// ordered-int encoding, and the same bits run after run. With SCORES unset
// the kernel is the one it was, instruction for instruction.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "paged_attention.cuh"

namespace {

constexpr int kKT = 64;           // keys a tile
constexpr int kRows = 64;         // query rows a block: one m64 wgmma tile
constexpr int kS = 2;             // converted stages (the consumer's ring)
constexpr int kSmemMax = 232448;  // a block's shared memory on the H100

// Offsets (bytes) into the block's dynamic shared memory, aligned to 1024
// where wgmma reads a swizzled tile. DC = 64-column blocks of the head dim.
struct Lay {
  int DC, R;
  int tile;      // one swizzled [64, 64 * DC] bf16 tile: DC * 8192
  int raw_kv;    // one raw [64, D] tile of the pool's type
  int q_off, k_off, v_off, raw_off, sc_off, rsc_off, bar_off, pm_off, bytes;
};

// scores: room for the export's [2][4][64] f32 page maxima
Lay make_lay(int D, int es, int R, bool scores) {
  constexpr int S = kS;
  Lay l;
  l.DC = (D + 63) / 64;
  l.R = R;
  l.tile = l.DC * 8192;
  l.raw_kv = kKT * D * es;
  l.q_off = 0;
  l.k_off = l.q_off + l.tile;
  l.v_off = l.k_off + S * l.tile;
  l.raw_off = l.v_off + S * l.tile;
  l.sc_off = l.raw_off + R * 2 * l.raw_kv;     // [S][2][64] f32
  l.rsc_off = l.sc_off + S * 2 * kKT * 4;      // [R][2][64] f32
  l.bar_off = l.rsc_off + R * 2 * kKT * 4;
  l.pm_off = (l.bar_off + 8 * (2 * S + R) + 15) / 16 * 16;
  l.bytes = (scores ? l.pm_off + 2 * 4 * kKT * 4
                    : l.bar_off + 8 * (2 * S + R)) + 1024;
  return l;
}

// The deepest raw ring that fits beside the two converted stages: four
// raw stages at dh <= 128 over INT8, one at dh 256.
Lay choose_lay(int D, int es, bool scores) {
  for (int R = 4; R > 1; --R) {
    const Lay l = make_lay(D, es, R, scores);
    if (l.bytes <= kSmemMax) return l;
  }
  return make_lay(D, es, 1, scores);
}

// grid (B * KH, cdiv(T * G, 64)); block 256: warpgroup 0 consumes,
// warpgroup 1 converts (its first thread also issues the copies). DC: the
// head dim's 64-column blocks. SCORES: the per-page score export into
// score_part [B * KH, gridDim.y, mp] (the header's note).
template <typename TKV, int DC, bool SCORES>
__global__ void __launch_bounds__(256, 1)
    attention_wgmma_kernel(Args a, Lay lay,
                           const __nv_bfloat16* __restrict__ q,
                           __nv_bfloat16* __restrict__ out,
                           const int* __restrict__ seq_lens,
                           const int* __restrict__ q_offsets, int T, int H,
                           float scale, float* __restrict__ score_part) {
  extern __shared__ uint8_t smem_dyn[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_dyn) + 1023) & ~uintptr_t(1023));
  constexpr int es = sizeof(TKV);
  const int tid = threadIdx.x;
  const int b = blockIdx.x / a.KH, h = blockIdx.x % a.KH;
  const int G = H / a.KH, D = a.D, TG = T * G;
  const int r0 = blockIdx.y * kRows;
  const int nrows = min(64, TG - r0);
  const int seq_len = seq_lens[b], qo = q_offsets[b];
  const int qmin = qo + r0 / G, qmax = qo + (r0 + nrows - 1) / G;
  // keys that exist (the reference's key < mp * page and key < seq_len),
  // and the keys of the pages that hold them, which the producer loads
  const int table = a.mp * a.page;
  const int limit = min(seq_len, table);
  const int loaded = min((limit + a.page - 1) / a.page * a.page, table);
  const int kend = min(qmax, limit - 1);
  const int kbeg = a.window > 0 ? max(0, qmin - a.window + 1) : 0;
  const int t0 = kbeg / kKT;
  const int ntiles = kend >= kbeg ? kend / kKT - t0 + 1 : 0;
  constexpr int S = kS;
  const int R = lay.R;
  const bool quant = a.scales != nullptr;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
  uint64_t* empty = full + S;
  uint64_t* rawfull = empty + S;
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      hop::mbar_init(&full[i], 128);
      hop::mbar_init(&empty[i], 128);
    }
    for (int i = 0; i < R; ++i) hop::mbar_init(&rawfull[i], 1);
    hop::mbar_fence_init();
  }
  __syncthreads();

  if (hop::warpgroup() == 1) {
    // the converter warpgroup. Its first thread reads the block table and
    // brings tile `it`'s K and V runs and their scales into raw stage it %
    // R: the first R tiles at once, each later one as soon as every
    // converter is done with the stage it reuses.
    const int ci = tid - 128;
    auto issue = [&](int it) {
      const int r = it % R;
      const int run = min(a.page, kKT);   // keys a bulk copy
      const int key0 = (t0 + it) * kKT;
      const int nk = min(kKT, loaded - key0);   // a multiple of run
      uint8_t* rk = smem + lay.raw_off + r * 2 * lay.raw_kv;
      float* rsc = reinterpret_cast<float*>(smem + lay.rsc_off) + r * 2 * kKT;
      hop::mbar_arrive_tx(&rawfull[r], 2 * nk * (D * es + (quant ? 4 : 0)));
      for (int j = 0; j < nk; j += run) {
        const int key = key0 + j;
        const int pid =
            a.block_tables[static_cast<long long>(b) * a.mp + key / a.page];
        const int off = key % a.page;
        for (int kv = 0; kv < 2; ++kv) {
          hop::bulk_load(rk + kv * lay.raw_kv + j * D * es,
                         a.pool + (page_offset(a, kv, h, pid) +
                                   static_cast<size_t>(off) * D) * es,
                         run * D * es, &rawfull[r]);
          if (quant)
            hop::bulk_load(
                rsc + kv * kKT + j,
                a.scales +
                    ((static_cast<long long>(a.layer) * 2 + kv) * a.KH + h) *
                        a.scale_stride +
                    static_cast<long long>(pid) * a.page + off,
                run * 4, &rawfull[r]);
        }
      }
    };
    if (ci == 0)
      for (int it = 0; it < min(R, ntiles); ++it) issue(it);
    // the stages start as zeros (the columns past dh and the rows of keys
    // never loaded stay finite); then each raw tile is widened into the
    // swizzled K and V tiles of a stage, 16 raw bytes a step
    for (int i = ci; i < (2 * S * lay.tile) / 16; i += 128)
      reinterpret_cast<uint4*>(smem + lay.k_off)[i] = make_uint4(0, 0, 0, 0);
    for (int i = ci; i < S * 2 * kKT; i += 128)
      reinterpret_cast<float*>(smem + lay.sc_off)[i] = 0.0f;
    hop::named_sync(2, 128);   // every zero is written before any tile
    const int pr = D * es / 16;   // 16-byte units of a raw row
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % S, r = it % R;
      hop::mbar_wait(&rawfull[r], (it / R) & 1);
      if (it >= S) hop::mbar_wait(&empty[s], (it / S - 1) & 1);
      const int nk = min(kKT, loaded - (t0 + it) * kKT);
      const uint8_t* rk = smem + lay.raw_off + r * 2 * lay.raw_kv;
      uint8_t* kdst = smem + lay.k_off + s * lay.tile;
      uint8_t* vdst = smem + lay.v_off + s * lay.tile;
      // unit (j, v): 16 raw bytes of row j at 16 * v, as bf16 columns
      auto unit = [&](const uint8_t* raw, uint8_t* dst, int j, int v) {
        const uint4 in =
            *reinterpret_cast<const uint4*>(raw + (j * pr + v) * 16);
        if constexpr (es == 1) {
          const int c = v / 4, c8 = (v % 4) * 2;   // 16 columns from 16 v
          *reinterpret_cast<uint4*>(dst + c * 8192 + hop::swz(j, c8)) =
              hop::widen8(make_uint2(in.x, in.y));
          *reinterpret_cast<uint4*>(dst + c * 8192 + hop::swz(j, c8 + 1)) =
              hop::widen8(make_uint2(in.z, in.w));
        } else {
          *reinterpret_cast<uint4*>(dst + (v / 8) * 8192 +
                                    hop::swz(j, v % 8)) = in;
        }
      };
      if (128 % pr == 0) {
        // a row's units divide the warpgroup: each thread keeps its column
        const int v = ci % pr, step = 128 / pr;
#pragma unroll 4
        for (int j = ci / pr; j < nk; j += step) {
          unit(rk, kdst, j, v);
          unit(rk + lay.raw_kv, vdst, j, v);
        }
      } else {
        const int units = nk * pr;
#pragma unroll 4
        for (int u = ci; u < 2 * units; u += 128) {
          const int kv = u >= units;
          const int w = u - kv * units;
          const int j = w / pr;
          unit(rk + kv * lay.raw_kv, kv ? vdst : kdst, j, w - j * pr);
        }
      }
      if (quant && ci % kKT < nk) {
        const float* rsc =
            reinterpret_cast<const float*>(smem + lay.rsc_off) + r * 2 * kKT;
        reinterpret_cast<float*>(smem + lay.sc_off)[s * 2 * kKT + ci] =
            rsc[ci];
      }
      hop::fence_async_smem();
      hop::mbar_arrive(&full[s]);
      hop::named_sync(2, 128);   // raw stage r is read by every converter
      if (ci == 0 && it + R < ntiles) issue(it + R);
    }
    return;
  }

  // consumer warpgroup: its row of the score export set to -1e30 (before
  // the barrier below, so warp 0's later stores come after it)
  float* srow = nullptr;
  if constexpr (SCORES) {
    srow = score_part +
           (static_cast<size_t>(blockIdx.x) * gridDim.y + blockIdx.y) * a.mp;
    for (int i = tid; i < a.mp; i += 128) srow[i] = kNegBig;
  }
  // its 64 query rows, swizzled, as loaded
  uint8_t* qs = smem + lay.q_off;
  for (int u = tid; u < kKT * DC * 8; u += 128) {
    const int j = u / (DC * 8), c = (u / 8) % DC, c8 = u % 8;
    const int d0 = c * 64 + c8 * 8, row = r0 + j;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row < TG && d0 < D) {
      const int t = row / G, g = row - t * G;
      v = *reinterpret_cast<const uint4*>(
          q + ((static_cast<size_t>(b) * T + t) * H + h * G + g) * D + d0);
    }
    *reinterpret_cast<uint4*>(qs + c * 8192 + hop::swz(j, c8)) = v;
  }
  hop::fence_async_smem();
  hop::named_sync(1, 128);

  const int warp = tid / 32, lane = tid % 32;
  const int row0 = r0 + 16 * warp + lane / 4;   // this thread's rows: +0, +8
  int qp[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) qp[e] = qo + min(row0 + 8 * e, TG - 1) / G;
  float m[2] = {kNegBig, kNegBig}, lsum[2] = {0.f, 0.f};
  float o[DC][32];
#pragma unroll
  for (int c = 0; c < DC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;

  // S = Q . K^T of tile `it` into `sacc` (issued and committed, not
  // waited; the first step overwrites the accumulator). It runs over all
  // 64 * DC columns: past dh, Q and K hold zeros, which add nothing.
  auto issue_s = [&](float (&sacc)[32], int it) {
    const uint8_t* kt = smem + lay.k_off + (it % S) * lay.tile;
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * DC; ++kk) {
      const int off = (kk / 4) * 8192 + (kk % 4) * 32;
      hop::mma_ss_n64<0>(sacc, hop::desc(qs + off, 16, 1024),
                         hop::desc(kt + off, 16, 1024), kk > 0);
    }
    hop::wgmma_commit();
  };

  // The score export of tile `it` from its masked logits `sacc` (the
  // header's note): each key's maximum over this thread's live rows, then
  // over the warp's 16 rows (lanes with the same lane % 4 hold the same
  // keys), into pm[warp][key]; after the barrier warp 0 folds the four
  // warps and each page's keys and stores the page's maximum.
  auto export_scores = [&](const float (&sacc)[32], int it) {
    float* pm = reinterpret_cast<float*>(smem + lay.pm_off) + (it % 2) * 4 * kKT;
    const bool live0 = row0 < TG, live1 = row0 + 8 < TG;
#pragma unroll
    for (int kg = 0; kg < 8; ++kg) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        float v = fmaxf(live0 ? sacc[4 * kg + x] : kNegBig,
                        live1 ? sacc[4 * kg + 2 + x] : kNegBig);
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
        if (lane < 4) pm[warp * kKT + 8 * kg + 2 * lane + x] = v;
      }
    }
    hop::named_sync(3, 128);
    if (warp == 0) {
      const int key0 = (t0 + it) * kKT, pg = a.page;
      float lo = fmaxf(fmaxf(pm[lane], pm[kKT + lane]),
                       fmaxf(pm[2 * kKT + lane], pm[3 * kKT + lane]));
      float hi = fmaxf(fmaxf(pm[32 + lane], pm[kKT + 32 + lane]),
                       fmaxf(pm[2 * kKT + 32 + lane], pm[3 * kKT + 32 + lane]));
      if (pg >= kKT) {
        // the tile lies in one page, which earlier tiles may have begun
        float v = fmaxf(lo, hi);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
        if (lane == 0) srow[key0 / pg] = fmaxf(srow[key0 / pg], v);
      } else {
        // 64 / pg whole pages, each a run of pg lanes in lo or in hi
        for (int o = 1; o < pg; o <<= 1) {
          lo = fmaxf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
          hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
        }
        const int p0 = (key0 + lane) / pg, p1 = (key0 + 32 + lane) / pg;
        if (lane % pg == 0 && p0 < a.mp) srow[p0] = lo;
        if (lane % pg == 0 && p1 < a.mp) srow[p1] = hi;
      }
    }
  };

  // The fold of tile `it` on its complete scores `sacc`, up to the
  // probabilities (left in `sacc`) and the rows' alpha. sacc[4i + 2e + x]
  // is row row0 + 8e, key key0 + 8i + 2 (lane % 4) + x. A tile every key
  // of which every row of the block sees skips the mask.
  auto fold = [&](float (&sacc)[32], float (&alpha)[2], int it) {
    const int s = it % S;
    const int key0 = (t0 + it) * kKT;
    const float* sc = reinterpret_cast<const float*>(smem + lay.sc_off) +
                      s * 2 * kKT + 2 * (lane % 4);
    const bool all_vis = key0 + kKT - 1 <= qmin && key0 + kKT <= limit &&
                         (a.window <= 0 || key0 > qmax - a.window);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 ks = quant ? *reinterpret_cast<const float2*>(sc + 8 * i)
                              : make_float2(1.f, 1.f);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sacc[4 * i + j] *= scale;
        if (quant) sacc[4 * i + j] *= j % 2 ? ks.y : ks.x;
      }
    }
    if (a.softcap > 0.f) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        sacc[i] = a.softcap * tanhf(sacc[i] / a.softcap);
    }
    if (!all_vis) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int e = (i / 2) % 2;
        const int key = key0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        bool vis = key <= qp[e] && key < limit;
        if (a.window > 0) vis = vis && key > qp[e] - a.window;
        sacc[i] = vis ? sacc[i] : kNegBig;
      }
    }
    if constexpr (SCORES) export_scores(sacc, it);
    float mblk[2] = {kNegBig, kNegBig};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mblk[(i / 2) % 2] = fmaxf(mblk[(i / 2) % 2], sacc[i]);
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mblk[e] = fmaxf(mblk[e], __shfl_xor_sync(0xffffffffu, mblk[e], 1));
      mblk[e] = fmaxf(mblk[e], __shfl_xor_sync(0xffffffffu, mblk[e], 2));
      const float mnew = fmaxf(m[e], mblk[e]);
      alpha[e] = __expf(m[e] - mnew);
      m[e] = mnew;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i)
      sacc[i] = __expf(sacc[i] - m[(i / 2) % 2]);
    if (!all_vis) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int e = (i / 2) % 2;
        const int key = key0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        bool vis = key <= qp[e] && key < limit;
        if (a.window > 0) vis = vis && key > qp[e] - a.window;
        sacc[i] = vis ? sacc[i] : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) sum[(i / 2) % 2] += sacc[i];
    if (quant) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 vs = *reinterpret_cast<const float2*>(sc + kKT + 8 * i);
#pragma unroll
        for (int j = 0; j < 4; ++j) sacc[4 * i + j] *= j % 2 ? vs.y : vs.x;
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sum[e] += __shfl_xor_sync(0xffffffffu, sum[e], 1);
      sum[e] += __shfl_xor_sync(0xffffffffu, sum[e], 2);
      lsum[e] = alpha[e] * lsum[e] + sum[e];
    }
  };

  // P (bf16) into the A-operand registers of the four 16-key steps
  auto pack = [&](const float (&sacc)[32], uint32_t (&pa)[4][4]) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        pa[ks][x] = hop::pack_bf16(sacc[8 * ks + 2 * x],
                                   sacc[8 * ks + 2 * x + 1]);
  };

  // Per tile, with P and alpha of tile it in hand and nothing in flight:
  // issue S of tile it + 1, rescale O, issue O += P . V of tile it (V
  // MN-major), so the two products run together on the tensor cores; wait
  // for both, release tile it's stage, then fold tile it + 1 and pack its
  // P on the CUDA cores. No register of a product is read or written while
  // it is in flight, so the compiler keeps the products asynchronous.
  float sacc[32], alpha[2];
  uint32_t pa[4][4];
  if (ntiles > 0) {
    hop::mbar_wait(&full[0], 0);
    issue_s(sacc, 0);
    hop::wgmma_wait<0>();
    hop::fence_regs(sacc);
    fold(sacc, alpha, 0);
    pack(sacc, pa);
  }
  for (int it = 0; it < ntiles; ++it) {
    const bool next = it + 1 < ntiles;
    if (next) {
      hop::mbar_wait(&full[(it + 1) % S], ((it + 1) / S) & 1);
      issue_s(sacc, it + 1);
    }
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i / 2) % 2];
#pragma unroll
    for (int c = 0; c < DC; ++c) hop::fence_regs(o[c]);
    const uint8_t* vt = smem + lay.v_off + (it % S) * lay.tile;
    hop::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int c = 0; c < DC; ++c)
        hop::mma_rs_n64<1>(o[c], pa[ks],
                           hop::desc(vt + c * 8192 + ks * 2048, 8192, 1024));
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < DC; ++c) hop::fence_regs(o[c]);
    hop::keep_live(pa);
    hop::mbar_arrive(&empty[it % S]);
    if (next) {
      hop::fence_regs(sacc);
      fold(sacc, alpha, it + 1);
      pack(sacc, pa);
    }
  }

  // finalize: / l (l == 0 -> 1), one rounding to bf16
  float inv[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) inv[e] = 1.f / (lsum[e] == 0.f ? 1.f : lsum[e]);
#pragma unroll
  for (int c = 0; c < DC; ++c) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int d = c * 64 + 8 * i + 2 * (lane % 4);
      if (d >= D) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = row0 + 8 * e;
        if (row >= TG) continue;
        const int t = row / G, g = row - t * G;
        *reinterpret_cast<uint32_t*>(
            out + ((static_cast<size_t>(b) * T + t) * H + h * G + g) * D +
            d) = hop::pack_bf16(o[c][4 * i + 2 * e] * inv[e],
                                o[c][4 * i + 2 * e + 1] * inv[e]);
      }
    }
  }
}

template <typename TKV, int DC, bool SCORES>
cudaError_t launch_wgmma(const Args& a, const void* q, void* out,
                         const int* seq_lens, const int* q_offsets,
                         float* score_part, int B, int T, int H, float scale,
                         cudaStream_t stream) {
  const Lay lay = choose_lay(a.D, sizeof(TKV), SCORES);
  auto kernel = attention_wgmma_kernel<TKV, DC, SCORES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
  if (err != cudaSuccess) return err;
  const int G = H / a.KH;
  kernel<<<dim3(B * a.KH, (T * G + kRows - 1) / kRows), 256, lay.bytes,
               stream>>>(
      a, lay, static_cast<const __nv_bfloat16*>(q),
      static_cast<__nv_bfloat16*>(out), seq_lens, q_offsets, T, H, scale,
      score_part);
  return cudaGetLastError();
}

template <typename TKV, int DC>
cudaError_t launch_scores(const Args& a, const void* q, void* out,
                          const int* seq_lens, const int* q_offsets,
                          float* score_part, int B, int T, int H,
                          float scale, cudaStream_t stream) {
  if (score_part != nullptr)
    return launch_wgmma<TKV, DC, true>(a, q, out, seq_lens, q_offsets,
                                       score_part, B, T, H, scale, stream);
  return launch_wgmma<TKV, DC, false>(a, q, out, seq_lens, q_offsets,
                                      nullptr, B, T, H, scale, stream);
}

template <typename TKV>
cudaError_t launch_by_dh(const Args& a, const void* q, void* out,
                         const int* seq_lens, const int* q_offsets,
                         float* score_part, int B, int T, int H, float scale,
                         cudaStream_t stream) {
  if (a.D <= 64)
    return launch_scores<TKV, 1>(a, q, out, seq_lens, q_offsets, score_part,
                                 B, T, H, scale, stream);
  if (a.D <= 128)
    return launch_scores<TKV, 2>(a, q, out, seq_lens, q_offsets, score_part,
                                 B, T, H, scale, stream);
  return launch_scores<TKV, 4>(a, q, out, seq_lens, q_offsets, score_part, B,
                               T, H, scale, stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Query rows a block of B1 on wgmma takes: the per-page score export's
// partial rows are cdiv(T * H / KH, this) a (sequence, KV head).
extern "C" int pbt_paged_attention_wgmma_block_rows() { return kRows; }

// B1 on wgmma: bf16 q (q_dtype 1) over an INT8 (kv_dtype 2, with scales) or
// bf16 (1) pool; D a multiple of 16 up to 256; a page of 64 or a multiple
// of it, or a divisor of 64 that is a multiple of 4; every pointer 16-byte
// aligned (ops/paged_attention.py::prefill_route). score_part: null, or the
// per-page score export's partial rows [B * KH, score_blocks, mp],
// score_blocks = cdiv(T * H / KH, kRows) (else the launch is refused).
extern "C" int pbt_paged_attention_wgmma(
    const void* q, void* out, const void* pool, const float* scales,
    const int* block_tables, const int* seq_lens, const int* q_offsets,
    float* score_part, int score_blocks,
    int B, int T, int H, int KH, int D, int P, int page, int mp, int layer,
    long long scale_stride, float scale, float softcap, int window,
    int q_dtype, int kv_dtype, void* stream) {
  const bool page_ok =
      page > 0 && (page % kKT == 0 || (kKT % page == 0 && page % 4 == 0));
  if (q_dtype != 1 || (kv_dtype != 1 && kv_dtype != 2) || D % 16 != 0 ||
      D > 256 || KH <= 0 || H % KH != 0 || !page_ok || !aligned16(q) ||
      !aligned16(out) || !aligned16(pool) ||
      (scales != nullptr && !aligned16(scales)) ||
      (kv_dtype == 2) != (scales != nullptr) ||
      (score_part != nullptr &&
       score_blocks != (T * (H / KH) + kRows - 1) / kRows))
    return cudaErrorInvalidValue;
  if (B == 0 || T == 0) return cudaSuccess;
  const Args a{static_cast<const uint8_t*>(pool), scales, block_tables, KH,
               D, P, page, mp, layer, scale_stride, softcap, window};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      kv_dtype == 2
          ? launch_by_dh<int8_t>(a, q, out, seq_lens, q_offsets, score_part,
                                 B, T, H, scale, st)
          : launch_by_dh<__nv_bfloat16>(a, q, out, seq_lens, q_offsets,
                                        score_part, B, T, H, scale, st);
  return static_cast<int>(err);
}
