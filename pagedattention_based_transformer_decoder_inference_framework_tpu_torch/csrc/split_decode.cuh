// Split-KV decode attention for Hopper: the device body that B2
// (paged_attention.cu's decode_split_kernel), B6 and B7 (paged_decode.cu's
// decode_grouped_split_kernel and decode_batched_split_kernel) share. Each
// entry point is its own __global__ (so a profile tells the three apart);
// what differs between them is only how the work is cut into parts:
//
//   B2  grid (sequence x KV head, split): split s takes the pages [s * pps,
//       s * pps + pps) of the block table (the shapes alone fix the
//       splits, ops/paged_attention.py::decode_split_plan);
//   B6  grid (sequence x KV head, split): split s takes the pages [first +
//       s * pps, ..) counted from the window's first visible page, pps a
//       multiple of group_pages (decode_grouped_plan), so a window wastes
//       no split;
//   B7  grid (blocks): the batch's visible (sequence, KV head, page) units
//       in one flat order, each block an equal contiguous run of them,
//       which may end one (sequence, KV head) and start the next
//       (decode_batched_partition).
//
// A part is a run of pages of one (sequence, KV head) for the G <= ROWS
// query heads of that KV head. What bounds it on the H100: bytes and
// latency (each visible K/V row is read once, 4 * D operations per query
// head and key), so the body spends the card on overlap instead of tensor
// cores (with G <= 8 rows a 64-row wgmma would be 88-98% padding):
// * Pages by bulk copy. A copy warp brings each page's K and V (one
//   contiguous [page, D] run each in the pool) and an aligned run of their
//   INT8 scales with cp.async.bulk into a ring of up to four stages under
//   full / empty mbarriers, so page i + 1 lands while page i is computed.
//   Where a page of one KV head is not a multiple of 16 bytes (some pages
//   of a head dim like 18), the copy warp's 32 lanes copy it with
//   ordinary loads instead and each arrives on the stage's barrier.
// * No block-wide barrier per page. Each of the four compute warps takes
//   16 keys of every 64 with its own online softmax (m, l) and P.V
//   accumulator in registers: eight lanes a key, each lane a chunk of the
//   K row (16 bytes where a row is a multiple of 16 bytes, else a pair of
//   values) against q rows kept in shared memory in the same lane order;
//   shuffles sum the eight parts; the probabilities go through a per-warp
//   buffer to P.V, where each lane owns PV (4, or 2 at D <= 64 and for
//   other head dims) values of d a run of 32 * PV. The warps' results
//   merge once, at the end of the part.
// * One launch. Each part writes its partial (m, l, acc) to an f32
//   workspace; the last part of a (sequence, KV head) to finish (a counter
//   it resets itself, keyed by device and stream on the host) merges them
//   in part order, in the same launch: the same output from run to run. A
//   part with no visible page writes (m = -1e30, l = 0, acc = 0) and counts
//   toward the merge; a (sequence, KV head) with a single part writes its
//   output directly.
// The fold order is the reference's per key (the K scale, the softcap, the
// mask, then m, l, and the V scale on p); only the grouping of the online
// softmax (16 keys a step, then warps, then parts) differs, which moves the
// sums' order and nothing else.
//
// The head dim is a template argument (DT) with its lane layout fixed at
// compile time; DT = 0 is the generic instance for any other even head dim
// up to 256 (pairs of values a lane, loops bounded by 256).

#pragma once

#include <type_traits>

#include "hopper.cuh"
#include "paged_attention.cuh"

namespace {

constexpr int kSplitWarps = 4;                    // compute warps
constexpr int kSplitThreads = 32 * kSplitWarps + 32;  // + the copy warp
constexpr int kMaxStages = 4;                     // pages in flight at most
constexpr int kMaxSplits = 64;                    // splits of B2's and B6's
constexpr int kKeyBlock = 16;  // keys a warp takes a step: 4 groups x 4
// a block's shared memory less 1 KB for the static is_last and the
// system's per-block reserve
constexpr int kSplitSmem = 232448 - 1024;

// The lane layout of head dim DT (0: any even head dim) over TKV rows.
template <typename TKV, int DT>
struct Lanes {
  static constexpr int es = sizeof(TKV);
  // 16-byte chunks of K a lane where a row is a multiple of 16 bytes
  static constexpr bool kVec = DT > 0 && (DT * es) % 16 == 0;
  static constexpr int W = kVec ? 16 : 2 * es;  // bytes of a chunk
  static constexpr int E = W / es;              // values of a chunk
  static constexpr int GV = kVec ? 4 : 2;       // q values read at once
  static constexpr int F = E / GV;              // such groups a chunk
  static constexpr int PV = (DT > 64 && DT % 4 == 0) ? 4 : 2;  // P.V
  static constexpr int RUN = 32 * PV;           // values of d a warp step
  static constexpr int DMAX = DT > 0 ? DT : 256;
  static constexpr int CIM = (DMAX / E + 7) / 8;   // chunks a lane, at most
  static constexpr int DCM = (DMAX + RUN - 1) / RUN;  // P.V runs, at most
  // floats of a q row in shared memory: whole groups of 8 chunks
  __host__ __device__ static int qrow(int D) {
    return (D / E + 7) / 8 * 8 * E;
  }
};

template <int W> struct RawT;
template <> struct RawT<16> { using T = uint4; };
template <> struct RawT<8> { using T = uint2; };
template <> struct RawT<4> { using T = uint32_t; };
template <> struct RawT<2> { using T = uint16_t; };

// Shared memory of the body (the host sizes it with the same function):
// q rows (f32, pre-scaled, in the lane order the scores read), each warp's
// probabilities of its key block, the page ring (K, V and their INT8
// scales a stage; the warps' partial results over it at the end of a
// part), the merge's part weights, and the ring's barriers.
struct SplitLay {
  int kv_bytes, sc_bytes, stage_bytes;
  int q_off, p_off, stage_off, w_off, bar_off, bytes;
};

__host__ __device__ inline SplitLay split_lay(int D, int qrow, int es,
                                              int page, bool quant, int rows,
                                              int stages, int max_parts) {
  SplitLay l;
  l.kv_bytes = static_cast<int>(align16(static_cast<size_t>(page) * D * es));
  // an aligned run of the pool's scales that holds the page's: at most
  // 3 floats before it and 3 after
  l.sc_bytes = quant ? static_cast<int>(align16((page + 8) * 4)) : 0;
  l.stage_bytes = 2 * l.kv_bytes + 2 * l.sc_bytes;
  l.q_off = 0;
  l.p_off = l.q_off + rows * qrow * 4;
  l.stage_off = l.p_off + kSplitWarps * kKeyBlock * rows * 4;
  const int combine = kSplitWarps * rows * (D + 2) * 4;
  const int ring = stages * l.stage_bytes;
  l.w_off = l.stage_off + (ring > combine ? ring : combine);
  l.bar_off = l.w_off + static_cast<int>(align16((max_parts + 1) * rows * 4));
  l.bytes = l.bar_off + 2 * kMaxStages * 8;
  return l;
}

// The deepest ring (at most kMaxStages pages, no more than `most`) whose
// layout, plus `extra` bytes, fits a block's shared memory; 0 if none.
__host__ inline int split_stages(int D, int qrow, int es, int page,
                                 bool quant, int rows, int most,
                                 int max_parts, int extra) {
  int stages = most < kMaxStages ? (most < 1 ? 1 : most) : kMaxStages;
  for (; stages >= 1; --stages)
    if (split_lay(D, qrow, es, page, quant, rows, stages, max_parts).bytes +
            extra <=
        kSplitSmem)
      return stages;
  return 0;
}

// Four values of a 16-byte chunk of K or V (group f of 16 / sizeof(T) / 4)
// as f32, exactly: INT8 by the exponent trick (2^23 + the offset-binary
// byte, then a subtraction), bf16 by a shift.
template <typename T>
__device__ __forceinline__ void chunk4(const uint4& v, int f, float (&o)[4]);
template <>
__device__ __forceinline__ void chunk4<int8_t>(const uint4& v, int f,
                                               float (&o)[4]) {
  const uint32_t w = (f == 0 ? v.x : f == 1 ? v.y : f == 2 ? v.z : v.w) ^
                     0x80808080u;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    o[e] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 + e)) -
           8388736.0f;  // 2^23 + 128
}
template <>
__device__ __forceinline__ void chunk4<__nv_bfloat16>(const uint4& v, int f,
                                                      float (&o)[4]) {
  const uint32_t w0 = f == 0 ? v.x : v.z, w1 = f == 0 ? v.y : v.w;
  o[0] = __uint_as_float(w0 << 16);
  o[1] = __uint_as_float(w0 & 0xFFFF0000u);
  o[2] = __uint_as_float(w1 << 16);
  o[3] = __uint_as_float(w1 & 0xFFFF0000u);
}
template <>
__device__ __forceinline__ void chunk4<float>(const uint4& v, int,
                                              float (&o)[4]) {
  o[0] = __uint_as_float(v.x);
  o[1] = __uint_as_float(v.y);
  o[2] = __uint_as_float(v.z);
  o[3] = __uint_as_float(v.w);
}

// Group f (GV values) of a chunk of W bytes of K as f32.
template <typename T, int W, int GV>
__device__ __forceinline__ void kgroup(const typename RawT<W>::T& v, int f,
                                       float (&o)[GV]) {
  if constexpr (W == 16) {
    chunk4<T>(v, f, o);
  } else if constexpr (sizeof(T) == 1) {            // an INT8 pair
    o[0] = static_cast<float>(static_cast<int8_t>(v & 0xFF));
    o[1] = static_cast<float>(static_cast<int8_t>(v >> 8));
  } else if constexpr (sizeof(T) == 2) {            // a bf16 pair
    o[0] = __uint_as_float(static_cast<uint32_t>(v) << 16);
    o[1] = __uint_as_float(static_cast<uint32_t>(v) & 0xFFFF0000u);
  } else {                                          // an f32 pair
    o[0] = __uint_as_float(v.x);
    o[1] = __uint_as_float(v.y);
  }
}

// N (4 or 2) consecutive values of a row of T as f32.
template <typename T, int N>
__device__ __forceinline__ void loadv(const uint8_t* p, float (&o)[N]) {
  if constexpr (N == 4) {
    if constexpr (sizeof(T) == 1) {
      chunk4<int8_t>(
          make_uint4(*reinterpret_cast<const uint32_t*>(p), 0, 0, 0), 0, o);
    } else if constexpr (sizeof(T) == 2) {
      const uint2 w = *reinterpret_cast<const uint2*>(p);
      chunk4<__nv_bfloat16>(make_uint4(w.x, w.y, 0, 0), 0, o);
    } else {
      chunk4<float>(*reinterpret_cast<const uint4*>(p), 0, o);
    }
  } else if constexpr (sizeof(T) == 1) {
    kgroup<T, 2, 2>(*reinterpret_cast<const uint16_t*>(p), 0, o);
  } else if constexpr (sizeof(T) == 2) {
    kgroup<T, 4, 2>(*reinterpret_cast<const uint32_t*>(p), 0, o);
  } else {
    kgroup<T, 8, 2>(*reinterpret_cast<const uint2*>(p), 0, o);
  }
}

// q and out are f32 or bf16: TQ, or with TQ void the runtime flag qbf
// (B6's instances; in B2's case at the slice the flag cost 0.2-0.3 us a
// call, so B2 and B7 instantiate TQ).
template <typename TQ>
__device__ __forceinline__ float load_q(const void* q, bool qbf, size_t i) {
  if constexpr (std::is_void_v<TQ>)
    return qbf ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i])
               : static_cast<const float*>(q)[i];
  else
    return to_f32(static_cast<const TQ*>(q)[i]);
}
template <typename TQ>
__device__ __forceinline__ void store_out(void* out, bool qbf, size_t i,
                                          float v) {
  if constexpr (std::is_void_v<TQ>) {
    if (qbf)
      static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
    else
      static_cast<float*>(out)[i] = v;
  } else {
    static_cast<TQ*>(out)[i] = from_f32<TQ>(v);
  }
}

// `bytes` (even) from global to shared memory by the copy warp's 32 lanes,
// 4 bytes a load where the run allows it, else 2.
__device__ __forceinline__ void copy_plain(uint8_t* dst, const uint8_t* src,
                                           int bytes, int lane) {
  if ((bytes & 3) == 0) {
    for (int i = lane; i < bytes / 4; i += 32)
      reinterpret_cast<uint32_t*>(dst)[i] =
          reinterpret_cast<const uint32_t*>(src)[i];
  } else {
    for (int i = lane; i < bytes / 2; i += 32)
      reinterpret_cast<uint16_t*>(dst)[i] =
          reinterpret_cast<const uint16_t*>(src)[i];
  }
}

// The ring's barriers, by thread 0 before the first part (visible after
// the part's first __syncthreads): a full barrier takes the copy warp's one
// arrival with the bulk copies' bytes, or its 32 lanes' arrivals after
// plain copies; an empty barrier the compute warps' 128.
__device__ __forceinline__ void ring_init(uint8_t* smem, const SplitLay& lay,
                                          int stages, bool bulk) {
  if (threadIdx.x == 0) {
    uint64_t* const full = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
    for (int s = 0; s < stages; ++s) {
      hop::mbar_init(&full[s], bulk ? 1 : 32);
      hop::mbar_init(&full[kMaxStages + s], 32 * kSplitWarps);
    }
    hop::mbar_fence_init();
  }
}

// One part: the pages [i0, i0 + n) of sequence b's block table, KV head h.
struct Part {
  int b, h, i0, n;
  int part, parts;  // its place among (b, h)'s parts, and their count
  long long base;   // the workspace slot of (b, h)'s part 0
};

// The body, run by all kSplitThreads threads of the block for each of its
// parts in turn (uniformly). `it0` counts the pages the block's ring took
// before this part (its stages and phases run on across parts; every part
// after the first has pages before it);
// `is_last` is the block's static shared flag. The partials of slot s are
// part_acc [s, G, D] and part_ml [s, G, 2]; counters [B * KH].
template <typename TQ, typename TKV, int DT, int ROWS>
__device__ __forceinline__ void split_part(
    const Args& a, uint8_t* smem, const SplitLay& lay, int& is_last,
    const void* q, void* out, bool qbf, const Part& w, int seq_len, int H,
    int stages, int it0, bool bulk, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int* __restrict__ counters, float scale) {
  using L = Lanes<TKV, DT>;
  constexpr int es = L::es, W = L::W, E = L::E, GV = L::GV, F = L::F;
  constexpr int PV = L::PV, RUN = L::RUN, CIM = L::CIM, DCM = L::DCM;
  using Raw = typename RawT<W>::T;
  const int D = DT > 0 ? DT : a.D;
  const int NCH = D / E;                  // chunks of a K row
  const int DQ = L::qrow(D);
  const int DC = DT > 0 ? DCM : (D + RUN - 1) / RUN;
  const int G = H / a.KH, page = a.page;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool quant = a.scales != nullptr;
  float* const qs = reinterpret_cast<float*>(smem + lay.q_off);
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
  uint64_t* const empty = full + kMaxStages;
  const int b = w.b, h = w.h, i0 = w.i0, n = w.n;
  const int* bt = a.block_tables + static_cast<long long>(b) * a.mp;
  const size_t row0 = static_cast<size_t>(b) * H + h * G;  // q / out row

  if (it0 > 0) {
    // a previous part of the block: its reads and writes of the ring (its
    // warps' merge) and of the q rows done, and ordered before this
    // part's bulk copies into the ring
    if (warp < kSplitWarps) hop::fence_async_smem();
    __syncthreads();
  }
  // the G query rows, times the scale, in the order the scores read them:
  // value d of chunk c = d / E sits at group (c / 8 * F + d % E / GV) * 8 +
  // c % 8, so the 8 lanes of a key read 8 consecutive groups; the padding
  // of a row past its last chunk (DQ > D) is zero
  for (int idx = tid; idx < G * D; idx += kSplitThreads) {
    const int r = idx / D, d = idx - r * D;
    const int c = d / E, e = d % E;
    qs[r * DQ + ((c / 8 * F + e / GV) * 8 + c % 8) * GV + e % GV] =
        load_q<TQ>(q, qbf, row0 * D + idx) * scale;
  }
  if (DQ > D) {
    for (int idx = tid; idx < G * (DQ - D); idx += kSplitThreads) {
      const int r = idx / (DQ - D), c = NCH + (idx - r * (DQ - D)) / E;
      const int e = idx % E;
      qs[r * DQ + ((c / 8 * F + e / GV) * 8 + c % 8) * GV + e % GV] = 0.f;
    }
  }
  __syncthreads();

  if (warp == kSplitWarps) {
    // the copy warp: page i0 + it's K and V runs (contiguous [page, D] in
    // the pool) and an aligned run of each one's scales into stage (it0 +
    // it) % stages, the first `stages` pages at once, each later one when
    // the compute warps release the stage it reuses; by bulk copy (lane 0)
    // or by the 32 lanes' plain copies
    if (bulk && lane != 0) return;
    const int row = page * D * es;
    for (int it = 0; it < n; ++it) {
      const int g = it0 + it, st = g % stages;
      if (g >= stages) hop::mbar_wait(&empty[st], (g / stages - 1) & 1);
      const int pid = bt[i0 + it];
      uint8_t* dst = smem + lay.stage_off + st * lay.stage_bytes;
      const long long s0 = static_cast<long long>(pid) * page;
      const long long a0 = s0 & ~3LL;
      const int nsc = static_cast<int>(((s0 + page + 3) & ~3LL) - a0);
      const float* sc[2];
#pragma unroll
      for (int kv = 0; kv < 2; ++kv)
        sc[kv] = quant ? a.scales +
                             ((static_cast<long long>(a.layer) * 2 + kv) *
                                  a.KH + h) * a.scale_stride + a0
                       : nullptr;
      if (bulk) {
        hop::mbar_arrive_tx(&full[st], 2 * row + (quant ? 8 * nsc : 0));
        for (int kv = 0; kv < 2; ++kv) {
          hop::bulk_load(dst + kv * lay.kv_bytes,
                         a.pool + page_offset(a, kv, h, pid) * es, row,
                         &full[st]);
          if (quant)
            hop::bulk_load(dst + 2 * lay.kv_bytes + kv * lay.sc_bytes,
                           sc[kv], 4 * nsc, &full[st]);
        }
      } else {
        for (int kv = 0; kv < 2; ++kv) {
          copy_plain(dst + kv * lay.kv_bytes,
                     a.pool + page_offset(a, kv, h, pid) * es, row, lane);
          if (quant)
            copy_plain(dst + 2 * lay.kv_bytes + kv * lay.sc_bytes,
                       reinterpret_cast<const uint8_t*>(sc[kv]), 4 * nsc,
                       lane);
        }
        hop::mbar_arrive(&full[st]);
      }
    }
    return;
  }

  // Compute warp `warp`: in every page, the keys jb + 4 u + kg (u < 4) of
  // each block of 16 at jb = 16 warp + 64 t, key group kg = lane / 8 of 8
  // lanes; its own online softmax (m the same in every lane, l a partial
  // of the lane's key group) and P.V accumulator (lane: values RUN c + PV
  // lane .. + PV - 1 of d), merged with the other warps' at the end.
  const int kg = lane / 8, l8 = lane % 8;
  float* const pw = reinterpret_cast<float*>(smem + lay.p_off) +
                    warp * kKeyBlock * ROWS;
  float m[ROWS], l[ROWS], acc[ROWS][PV * DCM];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = kNegBig;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < PV * DCM; ++c) acc[r][c] = 0.f;
  }
  const int last = seq_len - 1;  // the query's position
  for (int it = 0; it < n; ++it) {
    const int g = it0 + it, st = g % stages, i = i0 + it;
    hop::mbar_wait(&full[st], (g / stages) & 1);
    const uint8_t* kp = smem + lay.stage_off + st * lay.stage_bytes;
    const uint8_t* vp = kp + lay.kv_bytes;
    const int off = static_cast<int>(
        (static_cast<long long>(bt[i]) * page) & 3);
    const float* sck =
        reinterpret_cast<const float*>(kp + 2 * lay.kv_bytes) + off;
    const float* scv = sck + lay.sc_bytes / 4;
    for (int jb = kKeyBlock * warp; jb < page;
         jb += kKeyBlock * kSplitWarps) {
      // scores s = (q * scale) . k of the lane's four keys
      float s[4][ROWS];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int r = 0; r < ROWS; ++r) s[u][r] = 0.f;
#pragma unroll
      for (int ci = 0; ci < CIM; ++ci) {
        if (DT == 0 && 8 * ci >= NCH) break;
        const int c = l8 + 8 * ci;
        const bool cv = (DT > 0 && (DT / E) % 8 == 0) || c < NCH;
        Raw raw[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = jb + 4 * u + kg;
          raw[u] = j < page && cv ? *reinterpret_cast<const Raw*>(
                                        kp + j * D * es + c * W)
                                  : Raw{};
        }
#pragma unroll
        for (int f = 0; f < F; ++f) {
          float kf[4][GV];
#pragma unroll
          for (int u = 0; u < 4; ++u) kgroup<TKV, W, GV>(raw[u], f, kf[u]);
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            if (r < G) {
              const float* qp = qs + r * DQ + ((ci * F + f) * 8 + l8) * GV;
              float qv[GV];
              if constexpr (GV == 4) {
                const float4 q4 = *reinterpret_cast<const float4*>(qp);
                qv[0] = q4.x;
                qv[1] = q4.y;
                qv[2] = q4.z;
                qv[3] = q4.w;
              } else {
                const float2 q2 = *reinterpret_cast<const float2*>(qp);
                qv[0] = q2.x;
                qv[1] = q2.y;
              }
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                float v = s[u][r];
#pragma unroll
                for (int e = 0; e < GV; ++e) v = fmaf(qv[e], kf[u][e], v);
                s[u][r] = v;
              }
            }
          }
        }
      }
      // the key group's lanes sum their parts; the K scale, the softcap
      // and the mask (the reference's fold order)
      bool vis[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = jb + 4 * u + kg, key = i * page + j;
        vis[u] = j < page && key <= last &&
                 (a.window <= 0 || key > last - a.window);
        const float ks = quant && j < page ? sck[j] : 1.f;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          float v = s[u][r];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          if (quant) v *= ks;
          if (a.softcap > 0.f) v = a.softcap * tanhf(v / a.softcap);
          s[u][r] = vis[u] ? v : kNegBig;
        }
      }
      // online softmax over the block's 16 keys: the max over the key
      // groups, alpha, the probabilities (zero where masked) into l, then
      // times the V scale for P.V
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float mb = fmaxf(fmaxf(s[0][r], s[1][r]), fmaxf(s[2][r], s[3][r]));
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 8));
        mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 16));
        const float mn = fmaxf(m[r], mb);
        const float alpha = expf(m[r] - mn);
        m[r] = mn;
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float p = vis[u] ? expf(s[u][r] - mn) : 0.f;
          sum += p;
          s[u][r] = p;
        }
        l[r] = alpha * l[r] + sum;
#pragma unroll
        for (int c = 0; c < PV * DCM; ++c) acc[r][c] *= alpha;
      }
      if (quant) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = jb + 4 * u + kg;
          const float vs = j < page ? scv[j] : 0.f;
#pragma unroll
          for (int r = 0; r < ROWS; ++r) s[u][r] *= vs;
        }
      }
      // P . V over the block's keys: the probabilities through the warp's
      // buffer (key k = 4 u + kg, its ROWS values), then each lane its
      // values of d
      if (l8 == 0) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float* pk = pw + (4 * u + kg) * ROWS;
          if constexpr (ROWS % 4 == 0) {
#pragma unroll
            for (int r4 = 0; r4 < ROWS / 4; ++r4)
              *reinterpret_cast<float4*>(pk + 4 * r4) =
                  make_float4(s[u][4 * r4], s[u][4 * r4 + 1],
                              s[u][4 * r4 + 2], s[u][4 * r4 + 3]);
          } else {
#pragma unroll
            for (int r = 0; r < ROWS; ++r) pk[r] = s[u][r];
          }
        }
      }
      __syncwarp();
      const int nk = min(kKeyBlock, page - jb);
      for (int k = 0; k < nk; ++k) {
        float p[ROWS];
        const float* pk = pw + k * ROWS;
        if constexpr (ROWS % 4 == 0) {
#pragma unroll
          for (int r4 = 0; r4 < ROWS / 4; ++r4) {
            const float4 v = *reinterpret_cast<const float4*>(pk + 4 * r4);
            p[4 * r4] = v.x;
            p[4 * r4 + 1] = v.y;
            p[4 * r4 + 2] = v.z;
            p[4 * r4 + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int r = 0; r < ROWS; ++r) p[r] = pk[r];
        }
        const uint8_t* vr = vp + (jb + k) * D * es;
#pragma unroll
        for (int c = 0; c < DCM; ++c) {
          if (DT == 0 && c >= DC) break;
          const int d0 = RUN * c + PV * lane;
          if ((DT > 0 && DT % RUN == 0) || d0 < D) {
            float vv[PV];
            loadv<TKV, PV>(vr + d0 * es, vv);
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
#pragma unroll
              for (int e = 0; e < PV; ++e)
                acc[r][PV * c + e] = fmaf(p[r], vv[e], acc[r][PV * c + e]);
          }
        }
      }
      __syncwarp();  // the buffer is read before the next block writes it
    }
    hop::mbar_arrive(&empty[st]);
  }

  // The warps' results, merged in warp order over the ring (every stage
  // read once all compute warps meet): m_w, l_w (the key groups' partials
  // summed) and acc_w, weighted by e^(m_w - M).
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 8);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 16);
  }
  constexpr int NT = 32 * kSplitWarps;
  hop::named_sync(1, NT);
  float* const cacc = reinterpret_cast<float*>(smem + lay.stage_off);
  float* const cml = cacc + kSplitWarps * ROWS * D;  // [warp][r][m, l]
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int c = 0; c < DCM; ++c) {
      if (DT == 0 && c >= DC) break;
      const int d0 = RUN * c + PV * lane;
      float* dst = cacc + (warp * ROWS + r) * D + d0;
      if constexpr (PV == 4) {
        if ((DT > 0 && DT % RUN == 0) || d0 < D)
          *reinterpret_cast<float4*>(dst) =
              make_float4(acc[r][4 * c], acc[r][4 * c + 1],
                          acc[r][4 * c + 2], acc[r][4 * c + 3]);
      } else {
        if ((DT > 0 && DT % RUN == 0) || d0 < D)
          *reinterpret_cast<float2*>(dst) =
              make_float2(acc[r][2 * c], acc[r][2 * c + 1]);
      }
    }
    if (lane == 0) {
      cml[(warp * ROWS + r) * 2] = m[r];
      cml[(warp * ROWS + r) * 2 + 1] = l[r];
    }
  }
  hop::named_sync(1, NT);
  const long long slot = w.base + w.part;
  const size_t orow = row0 * D;
  for (int r = 0; r < G; ++r) {
    float mx = kNegBig;
#pragma unroll
    for (int v = 0; v < kSplitWarps; ++v)
      mx = fmaxf(mx, cml[(v * ROWS + r) * 2]);
    float wt[kSplitWarps], lsum = 0.f;
#pragma unroll
    for (int v = 0; v < kSplitWarps; ++v) {
      wt[v] = expf(cml[(v * ROWS + r) * 2] - mx);
      lsum = fmaf(cml[(v * ROWS + r) * 2 + 1], wt[v], lsum);
    }
    const float inv = 1.f / (lsum == 0.f ? 1.f : lsum);
    for (int d = tid; d < D; d += NT) {
      float v = 0.f;
#pragma unroll
      for (int u = 0; u < kSplitWarps; ++u)
        v = fmaf(cacc[(u * ROWS + r) * D + d], wt[u], v);
      if (w.parts == 1)
        store_out<TQ>(out, qbf, orow + r * D + d, v * inv);
      else
        part_acc[(slot * G + r) * D + d] = v;
    }
    if (w.parts > 1 && tid == 0) {
      part_ml[(slot * G + r) * 2] = mx;
      part_ml[(slot * G + r) * 2 + 1] = lsum;
    }
  }
  if (w.parts == 1) return;

  // The last part of (b, h) to finish (a counter it resets itself) merges
  // every part's partial in part order: M = max m_s, w_s = e^(m_s - M),
  // out = sum acc_s w_s / sum l_s w_s (l == 0 -> 1). An empty part left
  // m = -1e30, l = 0, acc = 0, so it weighs nothing unless every part is
  // empty, and then the output is zeros.
  const int bh = b * a.KH + h;
  __threadfence();
  hop::named_sync(1, NT);
  if (tid == 0) is_last = atomicAdd(&counters[bh], 1) == w.parts - 1;
  hop::named_sync(1, NT);
  if (!is_last) return;
  float* const wts = reinterpret_cast<float*>(smem + lay.w_off);  // [s][r]
  float* const invs = wts + (lay.bar_off - lay.w_off) / 4 - ROWS;
  const long long p0 = w.base;
  if (tid < G) {
    const int r = tid;
    float mx = kNegBig;
    for (int s = 0; s < w.parts; ++s)
      mx = fmaxf(mx, __ldcg(part_ml + ((p0 + s) * G + r) * 2));
    float lsum = 0.f;
    for (int s = 0; s < w.parts; ++s) {
      const float wv = expf(__ldcg(part_ml + ((p0 + s) * G + r) * 2) - mx);
      wts[s * ROWS + r] = wv;
      lsum = fmaf(__ldcg(part_ml + ((p0 + s) * G + r) * 2 + 1), wv, lsum);
    }
    invs[r] = 1.f / (lsum == 0.f ? 1.f : lsum);
  }
  hop::named_sync(1, NT);
  for (int r = 0; r < G; ++r) {
    for (int d = tid; d < D; d += NT) {
      float v = 0.f;
      for (int s = 0; s < w.parts; ++s)
        v = fmaf(__ldcg(part_acc + ((p0 + s) * G + r) * D + d),
                 wts[s * ROWS + r], v);
      store_out<TQ>(out, qbf, orow + r * D + d, v * invs[r]);
    }
  }
  if (tid == 0) counters[bh] = 0;
}

}  // namespace
