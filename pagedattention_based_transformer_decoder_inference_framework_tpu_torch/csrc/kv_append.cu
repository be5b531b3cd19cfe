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
// The values arrive already in the pool's dtype (INT8 quantization runs
// in plain PyTorch before the kernel, kvcache/pool.py::stack_new_kv), so
// the kernels copy bytes.
//
// What bounds them on the H100: bytes, and at the slice's shapes very few
// of them (decode: 4 sequences x 2 x 8 heads x 128 B of INT8 values plus
// 4 B scales per layer; a verify chunk nine times that), so latency is the
// whole cost. B3 and B5: one block per (sequence, K/V, KV head), a warp a
// token (append_token: its position, then its table entry, then its row
// copied, then its scale), 16-byte vector copies where the row allows,
// plain byte copies otherwise; no read-modify-write, since a row is a whole
// number of bytes and each scale its own 4-byte store. The TPU kernels
// move tile-sized slabs through VMEM and patch them (hence the slab-overlap
// rules of _rmw_kernel); here each token's row and scale are stored
// directly, so tokens of one chunk that share a page or a scales row need
// no care.
//
// B4 (a chunk of whole chunk pages, ~1 MB a layer at the slice) issues all
// of a block's loads before any store waits: a warp walking its slots one
// after another through append_token paid two dependent round trips a slot
// (~16 a warp). Its block, one a (chunk page, K/V, KV head), first loads
// its first units of the chunk page's rows (16-byte units where the row
// allows, a few a thread), then reads each slot's position and pool page
// once (one slot a thread) into shared memory, storing the slot's scale at
// once (one 4-byte store a thread); then every thread stores its units
// independently, and loads and stores the rest in batches. Where the chunk
// page is one pool page from slot 0 with consecutive positions, its [page,
// D] run is contiguous in `news` and in the pool, and the copy is one
// straight run; every other case (an off-grid chunk, padding, a position
// past the table) keeps the skip rules above, slot by slot.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

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

// Copies `n` bytes with threads [first, first + count) of the block.
__device__ __forceinline__ void copy_row(uint8_t* dst, const uint8_t* src,
                                         int n, int first, int count) {
  if ((n & 15) == 0) {
    uint4* d = reinterpret_cast<uint4*>(dst);
    const uint4* s = reinterpret_cast<const uint4*>(src);
    for (int i = first; i < n / 16; i += count) d[i] = s[i];
  } else {
    for (int i = first; i < n; i += count) dst[i] = src[i];
  }
}

// grid (B, 2, KH); news [B, 2, KH, 1, row_bytes], new scales [B, 2, KH, 1]
__global__ void __launch_bounds__(kThreads)
append_decode_kernel(Pool p, const uint8_t* __restrict__ news,
                     const float* __restrict__ new_scales,
                     const int* __restrict__ block_tables,
                     const int* __restrict__ positions, int mp) {
  const int b = blockIdx.x, kv = blockIdx.y, h = blockIdx.z;
  const int pos = positions[b];
  if (pos < 0) return;
  const int pid = page_of(p, block_tables, b, pos, mp);
  if (pid < 0) return;
  const int slot = pos % p.page;
  const long long src_row = (static_cast<long long>(b) * 2 + kv) * p.KH + h;
  copy_row(p.vals + pool_row(p, kv, h, pid, slot) * p.row_bytes,
           news + src_row * p.row_bytes, p.row_bytes, threadIdx.x, kThreads);
  if (p.scales != nullptr && threadIdx.x == 0)
    *scale_at(p, kv, h, pid, slot) = new_scales[src_row];
}

// One warp writes token t of sequence b's chunk (news [B, 2, KH, T,
// row_bytes], new scales [B, 2, KH, T]) for (kv, h), skipping it as the
// header says.
__device__ __forceinline__ void append_token(
    const Pool& p, const uint8_t* news, const float* new_scales,
    const int* block_tables, const int* positions, int b, int kv, int h,
    int t, int T, int mp, int lane) {
  const int pos = positions[static_cast<long long>(b) * T + t];
  if (pos < 0) return;
  const int pid = page_of(p, block_tables, b, pos, mp);
  if (pid < 0) return;
  const int slot = pos % p.page;
  const long long src_row =
      ((static_cast<long long>(b) * 2 + kv) * p.KH + h) * T + t;
  copy_row(p.vals + pool_row(p, kv, h, pid, slot) * p.row_bytes,
           news + src_row * p.row_bytes, p.row_bytes, lane, 32);
  if (p.scales != nullptr && lane == 0)
    *scale_at(p, kv, h, pid, slot) = new_scales[src_row];
}

template <int W> struct Unit;
template <> struct Unit<16> { using T = uint4; };
template <> struct Unit<8> { using T = uint2; };
template <> struct Unit<4> { using T = uint32_t; };
template <> struct Unit<2> { using T = uint16_t; };
template <> struct Unit<1> { using T = uint8_t; };

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
  using U = typename Unit<W>::T;
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

// grid (B, 2, KH): block (b, kv, h) writes all T tokens of sequence b's
// chunk for (kv, h), one token row per warp at a time. Positions are
// consecutive in the engine's verify chunk, but nothing here needs them
// to be: every token is addressed by its own position.
__global__ void __launch_bounds__(kThreads)
append_tokens_kernel(Pool p, const uint8_t* __restrict__ news,
                     const float* __restrict__ new_scales,
                     const int* __restrict__ block_tables,
                     const int* __restrict__ positions, int T, int mp) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = warp; t < T; t += kThreads / 32)
    append_token(p, news, new_scales, block_tables, positions, blockIdx.x,
                 blockIdx.y, blockIdx.z, t, T, mp, lane);
}

}  // namespace

extern "C" int pbt_kv_append_decode(void* pool, float* scales,
                                    const void* news, const float* new_scales,
                                    const int* block_tables,
                                    const int* positions, int B, int KH,
                                    int P, int page, int row_bytes, int mp,
                                    int layer, long long scale_stride,
                                    void* stream) {
  const Pool p{static_cast<uint8_t*>(pool), scales, KH, P, page, row_bytes,
               layer, scale_stride};
  append_decode_kernel<<<dim3(B, 2, KH), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const uint8_t*>(news), new_scales, block_tables,
      positions, mp);
  return static_cast<int>(cudaGetLastError());
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

extern "C" int pbt_kv_append_tokens(void* pool, float* scales,
                                    const void* news, const float* new_scales,
                                    const int* block_tables,
                                    const int* positions, int B, int T,
                                    int KH, int P, int page, int row_bytes,
                                    int mp, int layer,
                                    long long scale_stride, void* stream) {
  const Pool p{static_cast<uint8_t*>(pool), scales, KH, P, page, row_bytes,
               layer, scale_stride};
  append_tokens_kernel<<<dim3(B, 2, KH), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const uint8_t*>(news), new_scales, block_tables,
      positions, T, mp);
  return static_cast<int>(cudaGetLastError());
}
