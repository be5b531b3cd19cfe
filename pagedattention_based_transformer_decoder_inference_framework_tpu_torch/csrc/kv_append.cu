// In-place KV appends into the [L, 2, KH, P, page, D] pool, for Hopper.
//
// Two kernels, one per Pallas kernel of the JAX package they replace:
//
//   pbt_kv_append_decode   <- ops/kv_append.py::_append_tokens_rmw_batch
//                             (_rmw_batch_kernel): T = 1, one row per
//                             sequence.
//   pbt_kv_append_prefill  <- ops/kv_append.py::_append_pages_pallas
//                             (_prefill_kernel + the scales scan): a
//                             page-aligned chunk, T % page == 0.
//
// Both write token t of sequence b (position pos = positions[b, t]) to
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
// 4 B scales per layer), so launch latency is the whole cost. Design: one
// block per (sequence or chunk page, K/V, KV head), 16-byte vector copies
// where the row allows, plain byte copies otherwise; no read-modify-write,
// since a row is a whole number of bytes.
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

// grid (B * T / page, 2, KH); news [B, 2, KH, T, row_bytes], new scales
// [B, 2, KH, T]. Block (b, chunk page c) writes tokens c*page .. c*page +
// page - 1 of sequence b; each warp copies one token row at a time.
__global__ void __launch_bounds__(kThreads)
append_prefill_kernel(Pool p, const uint8_t* __restrict__ news,
                      const float* __restrict__ new_scales,
                      const int* __restrict__ block_tables,
                      const int* __restrict__ positions, int T, int mp) {
  const int n_chunk = T / p.page;
  const int b = blockIdx.x / n_chunk, c = blockIdx.x % n_chunk;
  const int kv = blockIdx.y, h = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long src_head = ((static_cast<long long>(b) * 2 + kv) * p.KH + h);
  for (int s = warp; s < p.page; s += kThreads / 32) {
    const int t = c * p.page + s;
    const int pos = positions[static_cast<long long>(b) * T + t];
    if (pos < 0) continue;
    const int pid = page_of(p, block_tables, b, pos, mp);
    if (pid < 0) continue;
    const int slot = pos % p.page;
    const long long src_row = src_head * T + t;
    copy_row(p.vals + pool_row(p, kv, h, pid, slot) * p.row_bytes,
             news + src_row * p.row_bytes, p.row_bytes, lane, 32);
    if (p.scales != nullptr && lane == 0)
      *scale_at(p, kv, h, pid, slot) = new_scales[src_row];
  }
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
  append_prefill_kernel<<<dim3(B * (T / page), 2, KH), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const uint8_t*>(news), new_scales, block_tables,
      positions, T, mp);
  return static_cast<int>(cudaGetLastError());
}
