// In-place KV appends into the [L, 2, KH, P, page, D] pool, for Hopper.
//
// Three kernels, one per Pallas kernel of the JAX package they replace:
//
//   pbt_kv_append_decode   <- ops/kv_append.py::_append_tokens_rmw_batch
//                             (_rmw_batch_kernel): T = 1, one row per
//                             sequence.
//   pbt_kv_append_prefill  <- ops/kv_append.py::_append_pages_pallas
//                             (_prefill_kernel + the scales scan): a
//                             page-aligned chunk, T % page == 0.
//   pbt_kv_append_tokens   <- ops/kv_append.py::_append_tokens_rmw
//                             (_rmw_kernel): any T > 1 chunk of
//                             consecutive positions, such as the
//                             speculative verify chunk (T = spec_k + 1),
//                             which starts anywhere in a page and may
//                             cross into the next.
//
// All write token t of sequence b (position pos = positions[b, t]) to
// slot pos % page of page block_tables[b, pos / page]: its D values at
// [layer, kv, h, page_id, slot, :] and, for an INT8 pool, its f32 scale at
// flat slot page_id * page + slot of the scales leaf [L, 2, KH, R, 128]
// (row slot // 128, lane slot % 128). Tokens with pos < 0 (prompt padding)
// are not written at all, and neither are tokens whose page lies past the
// block table (pos / page >= max_pages) or whose table entry names no page
// of the pool (the plain version raises on a position past the table).
// Valid positions follow the semantics of the JAX package's
// kvcache/pool.py::append_to_pages_at_layer. The TPU prefill kernel
// instead writes whole pages, because its DMA is tile-granular: slots
// past a prompt's end there hold padding rows, and chunk pages wholly past
// the prompt go to the dump page. The attention mask never reads those
// slots, so the two agree on everything attention sees, and the port's
// pool equals append_to_pages_at_layer's on every slot.
//
// B3 and B5 quantize as they append. They take the rows as the model
// produces them: k_new and v_new [B, T, KH, D] in the compute dtype (bf16
// or f32), D contiguous and B, T and KH at any strides, so a view of the
// fused qkv output is read in place. On the TPU the stacking and the
// quantization (kvcache/pool.py::stack_new_kv) sit in the jit'd kv_append
// around the Pallas call, fused by XLA; here in PyTorch they were ten
// kernels of their own before the copy, so one launch a layer now does
// what eleven did. For an INT8 pool each (token, K/V, head) row is
// quantized as kvcache/pool.py::quantize_kv does it, bit for bit
// (kv_quant.cuh); a bf16 or f32 pool takes the rounding cast. B4 still
// takes pool-dtype rows from stack_new_kv and copies their bytes.
//
// What bounds them on the H100: bytes, and at the slice's shapes very few
// of them (decode: 4 sequences x 2 x 8 heads x 256 B of bf16 rows in and
// 128 B of INT8 values plus 4 B scales out per layer; a verify chunk nine
// times that), so latency is the whole cost. B3 and B5 share one body
// (append_row): a warp a row, block (b, y) taking `warps` rows of sequence
// b in (K/V, token, head) order (the wrapper's plan,
// ops/kv_append.py::append_rows_plan). Each warp issues three loads before
// it uses any: its token's position (lane 0), the first 32 entries of the
// sequence's block table (a lane each; the page of any position below 32
// pages, 2,048 tokens at page 64, is among them) and its row (VPL
// consecutive values a lane: 8 bytes at bf16 dh 128). The parent's chain
// (position, then entry, then row, then store) is one round trip and the
// store: the entry is picked from the table's lanes by a shuffle once the
// position is shared, and only a page past the first 32 costs the
// dependent load. Meanwhile the warp takes the row's absmax (one redux)
// and quantizes (kv_quant.cuh), then stores the INT8 row as one store a
// lane of VPL bytes, and lane 0 the scale. Blocks of 8 warps, one row a
// warp, measured fastest on the H100: more rows a warp in flight, a block
// a sequence, or the positions and entries read once a block into shared
// memory behind a barrier were slower (PERF.md, slice 14). A token past a
// page boundary takes its own table entry. dh 64, 96, 128 and 256 have
// instances of their own (2, 3, 4 and 8 values a lane, the loads and
// stores in the widest units the row allows); any other dh, or rows whose
// pointers or strides do not sit on those units, take a generic instance
// (a value a lane at a time, the row read twice: once for the absmax,
// once to store). The TPU kernels move tile-sized slabs through VMEM and
// patch them (hence the slab-overlap rules of _rmw_kernel); here each
// token's row and scale are stored directly, so tokens of one chunk that
// share a page or a scales row need no care.
//
// B4 (a chunk of whole chunk pages, ~1 MB a layer at the slice) issues all
// of a block's loads before any store waits: a warp walking its slots one
// after another paid two dependent round trips a slot (~16 a warp). Its
// block, one a (chunk page, K/V, KV head), first loads its first units of
// the chunk page's rows (16-byte units where the row allows, a few a
// thread), then reads each slot's position and pool page once (one slot a
// thread) into shared memory, storing the slot's scale at once (one 4-byte
// store a thread); then every thread stores its units independently, and
// loads and stores the rest in batches. Where the chunk page is one pool
// page from slot 0 with consecutive positions, its [page, D] run is
// contiguous in `news` and in the pool, and the copy is one straight run;
// every other case (an off-grid chunk, padding, a position past the table)
// keeps the skip rules above, slot by slot.
//
// Every entry point returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for arguments no instance takes.

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "kv_quant.cuh"

namespace {

constexpr int kThreads = 128;

struct Pool {
  uint8_t* vals;         // [L, 2, KH, P, page, row_bytes]
  float* scales;         // [L, 2, KH, scale_stride] or null
  int KH, P, page, row_bytes, layer;
  long long scale_stride;
};

__device__ __forceinline__ long long pool_row(const Pool& p, int kv, int h,
                                              int pid, int slot) {
  return (((static_cast<long long>(p.layer) * 2 + kv) * p.KH + h) * p.P +
          pid) * p.page + slot;
}

// The pool page of position `pos` of sequence `b`, or -1 where the
// position lies past the block table or the entry names no pool page.
__device__ __forceinline__ int page_of(const Pool& p, const int* block_tables,
                                       int b, int pos, int mp) {
  const int col = pos / p.page;
  if (col >= mp) return -1;
  const int pid = block_tables[static_cast<long long>(b) * mp + col];
  return pid < p.P ? pid : -1;
}

__device__ __forceinline__ float* scale_at(const Pool& p, int kv, int h,
                                           int pid, int slot) {
  return p.scales +
         ((static_cast<long long>(p.layer) * 2 + kv) * p.KH + h) *
             p.scale_stride +
         static_cast<long long>(pid) * p.page + slot;
}

// -- B3 and B5: quantize-and-append of the model's rows ---------------------

// k_new / v_new [B, T, KH, D]: strides over B, T and KH in elements, D
// contiguous (named fields: an array indexed by K/V would put the
// parameters in local memory)
struct Rows {
  const void* k;
  const void* v;
  long long kb, kt, kh, vb, vt, vh;
};

// Row `row` of sequence b, in (K/V, token, head) order: its K/V half, its
// token and its head.
struct RowAt {
  int kv, t, h;
};

__device__ __forceinline__ RowAt row_at(int row, int T, int KH) {
  const int kv = row / (T * KH), rest = row % (T * KH);
  return {kv, rest / KH, rest % KH};
}

template <typename In>
__device__ __forceinline__ const In* row_src(const Rows& r, int b,
                                             const RowAt& a) {
  return a.kv ? static_cast<const In*>(r.v) + b * r.vb + a.t * r.vt +
                    a.h * r.vh
              : static_cast<const In*>(r.k) + b * r.kb + a.t * r.kt +
                    a.h * r.kh;
}

// table entries a warp reads beside its token's position, one a lane
constexpr int kTableLanes = 32;

// The warp's row: its place, its token's position (lane 0) and the first
// kTableLanes entries of the sequence's block table (entry j on lane j, 0
// past the table), both loads issued before either is used.
struct RowStart {
  RowAt a;
  int pos, entry;
};

__device__ __forceinline__ RowStart row_start(const int* block_tables,
                                              const int* positions, int b,
                                              int row, int T, int KH, int mp,
                                              int lane) {
  RowStart s{row_at(row, T, KH), 0, 0};
  if (lane == 0) s.pos = positions[static_cast<long long>(b) * T + s.a.t];
  if (lane < mp)
    s.entry = block_tables[static_cast<long long>(b) * mp + lane];
  return s;
}

// The row's flat pool slot (page id * page + slot), the same on every
// lane, or -1 where it is not written. A page past the first kTableLanes
// columns takes one more, dependent, load.
__device__ __forceinline__ int row_slot(const Pool& p,
                                        const int* block_tables,
                                        const RowStart& s, int b, int mp) {
  const int pos = __shfl_sync(0xffffffffu, s.pos, 0);
  const int col = pos / p.page;
  if (pos < 0 || col >= mp) return -1;
  const int pid =
      col < kTableLanes
          ? __shfl_sync(0xffffffffu, s.entry, col)
          : block_tables[static_cast<long long>(b) * mp + col];
  return pid < p.P ? pid * p.page + pos % p.page : -1;
}

// The row's place in the pool at flat slot `flat` (page id * page + slot)
template <typename Out>
__device__ __forceinline__ Out* pool_at(const Pool& p, const RowAt& a,
                                        int flat) {
  return reinterpret_cast<Out*>(p.vals + pool_row(p, a.kv, a.h, 0, flat) *
                                             p.row_bytes);
}

// Warp threadIdx.x / 32 of block (b = blockIdx.x, blockIdx.y): one row of
// the header's design, VPL values a lane (D = 32 * VPL).
template <typename In, typename Out, int VPL>
__device__ __forceinline__ void append_row(const Pool& p, const Rows& r,
                                           const int* block_tables,
                                           const int* positions, int T,
                                           int mp) {
  const int b = blockIdx.x, lane = threadIdx.x % 32;
  const int row = blockIdx.y * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= 2 * T * p.KH) return;                 // the whole warp
  const RowStart s = row_start(block_tables, positions, b, row, T, p.KH, mp,
                               lane);
  float x[VPL];
  kvq::load_row<In, VPL>(row_src<In>(r, b, s.a) + lane * VPL, x);
  const int flat = row_slot(p, block_tables, s, b, mp);
  Out y[VPL];
  const float scale = kvq::convert_row<Out, VPL>(x, y);
  if (flat < 0) return;
  kvq::store_row<Out, VPL>(pool_at<Out>(p, s.a, flat) + lane * VPL, y);
  if (sizeof(Out) == 1 && lane == 0)
    *scale_at(p, s.a.kv, s.a.h, 0, flat) = scale;
}

// The same for any D, a value a lane at a time: the absmax while the slot
// is found, then the row read again and stored.
template <typename In, typename Out>
__device__ __forceinline__ void append_row_any(const Pool& p, const Rows& r,
                                               const int* block_tables,
                                               const int* positions, int T,
                                               int mp) {
  const int b = blockIdx.x, lane = threadIdx.x % 32;
  const int row = blockIdx.y * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= 2 * T * p.KH) return;
  const int D = p.row_bytes / static_cast<int>(sizeof(Out));
  const RowStart s = row_start(block_tables, positions, b, row, T, p.KH, mp,
                               lane);
  const In* src = row_src<In>(r, b, s.a);
  float scale = 0.f;
  if (sizeof(Out) == 1) {
    float m = 0.f;
    for (int d = lane; d < D; d += 32)
      m = fmaxf(m, fabsf(kvq::to_f32(src[d])));
    scale = kvq::row_scale(kvq::warp_max(m));
  }
  const int flat = row_slot(p, block_tables, s, b, mp);
  if (flat < 0) return;
  Out* dst = pool_at<Out>(p, s.a, flat);
  for (int d = lane; d < D; d += 32) {
    const float v = kvq::to_f32(src[d]);
    dst[d] = kvq::Store<Out>::from(
        sizeof(Out) == 1 ? kvq::quantize(v, scale) : v);
  }
  if (sizeof(Out) == 1 && lane == 0)
    *scale_at(p, s.a.kv, s.a.h, 0, flat) = scale;
}

template <typename In, typename Out, int VPL>
__device__ __forceinline__ void append_body(const Pool& p, const Rows& r,
                                            const int* block_tables,
                                            const int* positions, int T,
                                            int mp) {
  if constexpr (VPL == 0)
    append_row_any<In, Out>(p, r, block_tables, positions, T, mp);
  else
    append_row<In, Out, VPL>(p, r, block_tables, positions, T, mp);
}

// B3: grid (B, blocks a sequence), T = 1
template <typename In, typename Out, int VPL>
__global__ void __launch_bounds__(1024)
append_decode_kernel(Pool p, Rows r, const int* __restrict__ block_tables,
                     const int* __restrict__ positions, int mp) {
  append_body<In, Out, VPL>(p, r, block_tables, positions, 1, mp);
}

// B5: grid (B, blocks a sequence), any T. Positions are consecutive in
// the engine's verify chunk, but nothing here needs them to be: every
// token is addressed by its own position.
template <typename In, typename Out, int VPL>
__global__ void __launch_bounds__(1024)
append_tokens_kernel(Pool p, Rows r, const int* __restrict__ block_tables,
                     const int* __restrict__ positions, int T, int mp) {
  append_body<In, Out, VPL>(p, r, block_tables, positions, T, mp);
}

struct RowsLaunch {
  Pool p;
  Rows r;
  const int* block_tables;
  const int* positions;
  int B, T, D, mp, warps;
  cudaStream_t stream;
};

template <bool kDecode, typename In, typename Out, int VPL>
void launch_rows(const RowsLaunch& a) {
  const dim3 grid(a.B, (2 * a.T * a.p.KH + a.warps - 1) / a.warps);
  if constexpr (kDecode)
    append_decode_kernel<In, Out, VPL><<<grid, a.warps * 32, 0, a.stream>>>(
        a.p, a.r, a.block_tables, a.positions, a.mp);
  else
    append_tokens_kernel<In, Out, VPL><<<grid, a.warps * 32, 0, a.stream>>>(
        a.p, a.r, a.block_tables, a.positions, a.T, a.mp);
}

// A vector instance (VPL values a lane) where D = 32 * VPL and both rows'
// pointers and strides sit on its load unit; else the generic one.
template <typename In>
bool rows_on_unit(const Rows& r, int vpl) {
  const long long unit = kvq::unit_of(vpl * static_cast<int>(sizeof(In)));
  const long long es = sizeof(In);
  for (long long x : {static_cast<long long>(reinterpret_cast<uintptr_t>(
                          r.k)),
                      static_cast<long long>(reinterpret_cast<uintptr_t>(
                          r.v)),
                      r.kb * es, r.kt * es, r.kh * es, r.vb * es, r.vt * es,
                      r.vh * es})
    if (x % unit != 0) return false;
  return true;
}

template <bool kDecode, typename In, typename Out>
void launch_by_dh(const RowsLaunch& a) {
  const int vpl = a.D % 32 == 0 ? a.D / 32 : 0;
  const bool vec = vpl > 0 && rows_on_unit<In>(a.r, vpl);
  if (vec && vpl == 2)
    launch_rows<kDecode, In, Out, 2>(a);
  else if (vec && vpl == 3)
    launch_rows<kDecode, In, Out, 3>(a);
  else if (vec && vpl == 4)
    launch_rows<kDecode, In, Out, 4>(a);
  else if (vec && vpl == 8)
    launch_rows<kDecode, In, Out, 8>(a);
  else
    launch_rows<kDecode, In, Out, 0>(a);
}

// in_code / out_code: 0 f32, 1 bf16, 2 INT8 (utils/platform.py's
// DTYPE_CODES); an INT8 pool needs its scales, no other pool has any
template <bool kDecode>
int append_rows_entry(void* pool, float* scales, const void* k, const void* v,
                      const int* block_tables, const int* positions,
                      long long kb, long long kt, long long kh, long long vb,
                      long long vt, long long vh, int in_code, int out_code,
                      int B, int T, int KH, int P, int page, int D, int mp,
                      int layer, long long scale_stride, int warps,
                      void* stream) {
  if ((kDecode && T != 1) || T < 1 || warps < 1 || warps > 32 ||
      (out_code == 2) != (scales != nullptr) || in_code < 0 || in_code > 1 ||
      out_code < 0 || out_code > 2 ||
      static_cast<long long>(P) * page >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int out_size = out_code == 0 ? 4 : out_code == 1 ? 2 : 1;
  const RowsLaunch a{
      Pool{static_cast<uint8_t*>(pool), scales, KH, P, page, D * out_size,
           layer, scale_stride},
      Rows{k, v, kb, kt, kh, vb, vt, vh},
      block_tables, positions, B, T, D, mp, warps,
      static_cast<cudaStream_t>(stream)};
  auto by_out = [&](auto in) {
    using In = decltype(in);
    if (out_code == 0)
      launch_by_dh<kDecode, In, float>(a);
    else if (out_code == 1)
      launch_by_dh<kDecode, In, uint16_t>(a);
    else
      launch_by_dh<kDecode, In, int8_t>(a);
  };
  if (in_code == 0)
    by_out(float{});
  else
    by_out(uint16_t{});
  return static_cast<int>(cudaGetLastError());
}

// -- B4: a page-aligned chunk of pool-dtype rows ------------------------------

// units a thread loads before it stores them: all of a 16-byte-unit chunk
// page's at dh 128 INT8 (4) and at Phi-3's bf16 dh 96 (6)
constexpr int kBatch = 8;

// grid (B * T / page, 2, KH); dynamic shared memory page * 8 bytes. Block
// (b, chunk page c, kv, h) writes tokens c * page .. c * page + page - 1
// of sequence b for (kv, h) in units of W bytes (W divides row_bytes).
template <int W>
__global__ void __launch_bounds__(kThreads)
append_prefill_kernel(Pool p, const uint8_t* __restrict__ news,
                      const float* __restrict__ new_scales,
                      const int* __restrict__ block_tables,
                      const int* __restrict__ positions, int T, int mp) {
  using U = typename kvq::Unit<W>::T;
  extern __shared__ long long dst_row[];  // [page]: a slot's pool row, or -1
  const int n_chunk = T / p.page;
  const int b = blockIdx.x / n_chunk, c = blockIdx.x % n_chunk;
  const int kv = blockIdx.y, h = blockIdx.z, tid = threadIdx.x;
  const long long src0 =
      ((static_cast<long long>(b) * 2 + kv) * p.KH + h) * T + c * p.page;
  const U* src = reinterpret_cast<const U*>(news + src0 * p.row_bytes);
  const int units = p.row_bytes / W, total = p.page * units;
  const int* pos_c = positions + static_cast<long long>(b) * T + c * p.page;
  const int pos0 = pos_c[0];
  // slot tid's position (the head of the dependent chain) and new scale
  const int pos_t = tid < p.page ? pos_c[tid] : -1;
  const float sc_t =
      p.scales != nullptr && tid < p.page ? new_scales[src0 + tid] : 0.f;

  // the first batch of units, in flight while the positions are read
  U v[kBatch];
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    const int i = tid + k * kThreads;
    if (i < total) v[k] = src[i];
  }
  // each slot's position and pool row, once; its scale stored at once
  bool run = pos0 >= 0 && pos0 % p.page == 0;
  for (int s = tid; s < p.page; s += kThreads) {
    const int pos = s == tid ? pos_t : pos_c[s];
    const int pid = pos < 0 ? -1 : page_of(p, block_tables, b, pos, mp);
    const int slot = pos % p.page;
    dst_row[s] = pid < 0 ? -1 : pool_row(p, kv, h, pid, slot);
    run = run && pid >= 0 && pos == pos0 + s;
    if (pid >= 0 && p.scales != nullptr)
      *scale_at(p, kv, h, pid, slot) =
          s == tid ? sc_t : new_scales[src0 + s];
  }
  // a contiguous run: one pool page from slot 0 (the same table entry)
  run = __syncthreads_and(run);
  U* const pool = reinterpret_cast<U*>(p.vals);
  const long long run0 = run ? dst_row[0] * units : 0;
  for (int i0 = tid;; i0 += kBatch * kThreads) {
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * kThreads;
      if (i >= total) continue;
      if (run) {
        pool[run0 + i] = v[k];
      } else {
        const int s = i / units;
        const long long row = dst_row[s];
        if (row >= 0) pool[row * units + i - s * units] = v[k];
      }
    }
    if (i0 + kBatch * kThreads >= total) break;
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + (kBatch + k) * kThreads;
      if (i < total) v[k] = src[i];
    }
  }
}

}  // namespace

extern "C" int pbt_kv_append_decode(
    void* pool, float* scales, const void* k, const void* v,
    const int* block_tables, const int* positions, long long kb,
    long long kt, long long kh, long long vb, long long vt, long long vh,
    int in_code, int out_code, int B, int T, int KH, int P, int page, int D,
    int mp, int layer, long long scale_stride, int warps, void* stream) {
  return append_rows_entry<true>(pool, scales, k, v, block_tables, positions,
                                 kb, kt, kh, vb, vt, vh, in_code, out_code,
                                 B, T, KH, P, page, D, mp, layer,
                                 scale_stride, warps, stream);
}

extern "C" int pbt_kv_append_tokens(
    void* pool, float* scales, const void* k, const void* v,
    const int* block_tables, const int* positions, long long kb,
    long long kt, long long kh, long long vb, long long vt, long long vh,
    int in_code, int out_code, int B, int T, int KH, int P, int page, int D,
    int mp, int layer, long long scale_stride, int warps, void* stream) {
  return append_rows_entry<false>(pool, scales, k, v, block_tables, positions,
                                  kb, kt, kh, vb, vt, vh, in_code, out_code,
                                  B, T, KH, P, page, D, mp, layer,
                                  scale_stride, warps, stream);
}

extern "C" int pbt_kv_append_prefill(void* pool, float* scales,
                                     const void* news,
                                     const float* new_scales,
                                     const int* block_tables,
                                     const int* positions, int B, int T,
                                     int KH, int P, int page, int row_bytes,
                                     int mp, int layer,
                                     long long scale_stride, void* stream) {
  if (T % page != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Pool p{static_cast<uint8_t*>(pool), scales, KH, P, page, row_bytes,
               layer, scale_stride};
  const dim3 grid(B * (T / page), 2, KH);
  const size_t smem = static_cast<size_t>(page) * sizeof(long long);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  auto run = [&](auto kernel) {
    kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        p, static_cast<const uint8_t*>(news), new_scales, block_tables,
        positions, T, mp);
  };
  if (row_bytes % 16 == 0)
    run(append_prefill_kernel<16>);
  else if (row_bytes % 8 == 0)
    run(append_prefill_kernel<8>);
  else if (row_bytes % 4 == 0)
    run(append_prefill_kernel<4>);
  else if (row_bytes % 2 == 0)
    run(append_prefill_kernel<2>);
  else
    run(append_prefill_kernel<1>);
  return static_cast<int>(cudaGetLastError());
}
