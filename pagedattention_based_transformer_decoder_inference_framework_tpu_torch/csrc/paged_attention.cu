// Paged attention over the [L, 2, KH, P, page, D] KV pool, for Hopper.
//
// Three kernels, one per Pallas kernel of the JAX package they replace:
//
//   pbt_paged_attention         <- ops/paged_attention.py::paged_attention
//                                  (_kernel / _attend): a T >= 1 query chunk
//                                  (chunked prefill, the speculative verify
//                                  chunk), causal by absolute position.
//   pbt_paged_attention_decode  <- ops/paged_attention.py::
//                                  paged_attention_decode (_decode_kernel,
//                                  pallas_call :750): T = 1, mask key <
//                                  seq_len (+ window), dh 128 or 256.
//   pbt_paged_attention_decode_append
//                               <- ops/paged_attention.py::
//                                  paged_attention_decode_append
//                                  (_decode_append_kernel): T = 1 with the
//                                  KV append fused in, one launch per layer
//                                  in place of the append's and B2's.
//
// What they compute, in the reference's fold order, and the page step
// they share with paged_decode.cu's kernels are in paged_attention.cuh.
//
// What bounds them on the H100: at the slice's shapes (page 64, dh 128,
// INT8 pool, <= 2 pages per sequence) both are tiny. Prefill does
// 2*64*64*128 f32 multiply-adds per row tile, below the CUDA cores' rate;
// its kernel here (paged_attention_kernel) serves f32 queries and head
// dims the tensor-core kernel (paged_prefill.cu) does not take. One block
// of 128 threads per (sequence, KV head, tile of query rows t*G+g) loops
// over its sequence's block table (the TPU's sequential page grid axis)
// and stops at the causal / seq_len / window limit. Each page's K and V
// rows are staged in shared memory with a 4-byte row pad, so the score
// loop (one thread per (row, key) pair, reading a K row across d) hits
// distinct banks; the page's K and V scales ride along. The P.V product
// keeps the accumulator in registers, one thread per output lane d.
//
// B2 (decode_split_kernel) reads each sequence's visible K/V rows once
// (~33 KB per (sequence, KV head) at the slice, ~2 MB at 32k tokens) and
// does 4 * D operations per (query head, key): bytes and latency bound
// it, never arithmetic. It is split-KV in one launch on the body it shares
// with B6 and B7 (split_decode.cuh: a copy warp bringing pages by bulk
// copy into a ring, four compute warps without a block barrier per page,
// the last part of a (sequence, KV head) merging the parts in order). Its
// grid is (sequence, KV head, split of the block table): the wrapper picks
// the splits from B, KH and the table width so the grid fills about two
// waves of 132 SMs, at least one page a split
// (ops/paged_attention.py::decode_split_plan). A split with no visible page
// still writes (m = -1e30, l = 0, acc = 0) and counts toward the merge.
//
// The fused decode append (paged_attention_decode_append_kernel) is one
// block of 128 threads per (sequence, KV head) walking its pages with the
// shared page step (attend_page, B2's design before its split-KV
// redesign), then one more online-softmax step for the new token, whose K/V row comes from the new rows (never read
// back from the pool) and is stored by the same block after its page
// reads. Its bound is B2's bytes plus B3's; what it saves is one launch
// per layer, which is the cost that matters while decode is host-bound.
// The TPU kernel's tail-slab read-modify-write and its scales-slab
// patching for every sequence (paged_attention.py:1318-1347) have no
// counterpart: each row and each scale is a plain store of its own.
//
// Every entry point returns cudaGetLastError() after its launch.

#include "hopper.cuh"
#include "paged_attention.cuh"
#include "split_decode.cuh"

namespace {

// grid (B * KH, cdiv(T * G, kPrefillRows)); block kThreads
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(Args a, const TQ* __restrict__ q, TQ* __restrict__ out,
                       const int* __restrict__ seq_lens,
                       const int* __restrict__ q_offsets, int T, int H,
                       float scale) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int ROWS = kPrefillRows;
  const int b = blockIdx.x / a.KH, h = blockIdx.x % a.KH;
  const int G = H / a.KH;
  const int r0 = blockIdx.y * ROWS;
  const int nrows = min(ROWS, T * G - r0);
  Tile<TKV, ROWS> t(smem, a.D, a.page);
  load_rows<TQ, TKV, ROWS>(t, q, b, h, r0, nrows, T, H, G, a.D, scale);

  const int seq_len = seq_lens[b];
  const int qo = q_offsets[b];
  int qpos[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) qpos[r] = qo + (r0 + r) / G;
  const int qmin = qpos[0];
  const int qmax = qo + (r0 + nrows - 1) / G;

  float acc[ROWS][kMaxDPerThread] = {};
  const int n_pages = min((seq_len + a.page - 1) / a.page, a.mp);
  for (int i = 0; i < n_pages; ++i) {
    const int start = i * a.page;
    if (start > qmax) break;                                  // causal
    if (a.window > 0 && start + a.page <= qmin - a.window + 1) continue;
    attend_page<TKV, ROWS>(a, t, qpos, nrows, b, h, i, seq_len, acc);
  }
  store_rows<TQ, TKV, ROWS>(t, out, b, h, r0, nrows, T, H, G, a.D, acc);
}

// -- B2: split-KV decode (the body is split_decode.cuh's) ----------------

// grid (B * KH, splits); block kSplitThreads; rows = the G <= ROWS query
// heads of KV head h; split blockIdx.y takes the pages [split * pps,
// split * pps + pps) of the block table that hold visible keys. Partials:
// acc [B * KH, splits, G, D], (m, l) [.., G, 2]; counters one a
// (sequence, KV head).
template <typename TQ, typename TKV, int D, int ROWS>
__global__ void __launch_bounds__(kSplitThreads)
decode_split_kernel(Args a, const TQ* __restrict__ q, TQ* __restrict__ out,
                    const int* __restrict__ seq_lens,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int* __restrict__ counters, int H, int pps, int stages,
                    float scale) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int is_last;
  const SplitLay lay =
      split_lay(D, Lanes<TKV, D>::qrow(D), sizeof(TKV), a.page,
                a.scales != nullptr, ROWS, stages, kMaxSplits);
  ring_init(smem, lay, stages, true);
  const int bh = blockIdx.x, b = bh / a.KH, split = blockIdx.y;
  const int seq_len = seq_lens[b];
  const int i0 = max(split * pps, first_decode_page(a, seq_len));
  const int n = max(min(split * pps + pps, decode_pages(a, seq_len)) - i0, 0);
  const Part w{b, bh % a.KH, i0, n, split, static_cast<int>(gridDim.y),
               static_cast<long long>(bh) * gridDim.y};
  split_part<TQ, TKV, D, ROWS>(a, smem, lay, is_last, q, out, false, w,
                               seq_len, H, stages, 0, true, part_acc,
                               part_ml, counters, scale);
}

// grid (B * KH); block kThreads; rows = the G query heads of KV head h.
// The page loop over the keys already cached (key < seq_len - 1, read from
// the pool), then the new token folded in from `news` (its row in the
// pool's dtype, [B, 2, KH, 1, D], and for INT8 its scales [B, 2, KH]),
// then that row and its scales stored at `positions[b]`. The block is the
// only one that reads or writes (b, h)'s K and V rows, and it stores only
// after its last page read (attend_page ends in __syncthreads), so the
// tail page it reads is never torn.
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
paged_attention_decode_append_kernel(Args a, const TQ* __restrict__ q,
                                     TQ* __restrict__ out,
                                     const int* __restrict__ seq_lens,
                                     const int* __restrict__ positions,
                                     const TKV* __restrict__ news,
                                     const float* __restrict__ new_scales,
                                     int H, float scale) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int ROWS = kDecodeRows;
  const int b = blockIdx.x / a.KH, h = blockIdx.x % a.KH;
  const int G = H / a.KH, D = a.D;
  Tile<TKV, ROWS> t(smem, D, a.page);
  load_rows<TQ, TKV, ROWS>(t, q, b, h, 0, G, 1, H, G, D, scale);

  const int seq_len = seq_lens[b];        // after the append
  const int old = seq_len - 1;            // keys already in the pool
  int qpos[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) qpos[r] = seq_len - 1;
  const int first =
      a.window > 0 ? max(seq_len - a.window, 0) / a.page : 0;
  const int n_pages = min((old + a.page - 1) / a.page, a.mp);
  float acc[ROWS][kMaxDPerThread] = {};
  for (int i = first; i < n_pages; ++i)
    attend_page<TKV, ROWS>(a, t, qpos, G, b, h, i, old, acc);

  // the new token's score and value from the row the pool will hold, its
  // scale folded in before the dot (paged_attention.py:1295-1314); it is
  // always visible (key == q_pos)
  const bool quantized = a.scales != nullptr;
  const long long nk = (static_cast<long long>(b) * 2 + 0) * a.KH + h;
  const long long nv = (static_cast<long long>(b) * 2 + 1) * a.KH + h;
  const float sk = quantized ? new_scales[nk] : 1.f;
  const float sv = quantized ? new_scales[nv] : 1.f;
  const TKV* kn = news + nk * D;
  const TKV* vn = news + nv * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < G; r += kWarps) {
    const float* qr = t.q + r * D;
    float s = 0.f;
    for (int d = lane; d < D; d += 32)
      s = fmaf(qr[d], to_f32(kn[d]) * sk, s);
    for (int o = 16; o > 0; o >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, o);
    if (a.softcap > 0.f) s = a.softcap * tanhf(s / a.softcap);
    if (lane == 0) {
      const float mprev = t.m[r];
      const float mnew = fmaxf(mprev, s);
      const float al = expf(mprev - mnew);
      const float pn = expf(s - mnew);
      t.alpha[r] = al;
      t.p[r] = pn;
      t.l[r] = al * t.l[r] + pn;
      t.m[r] = mnew;
    }
  }
  __syncthreads();
  float vv[kMaxDPerThread];
#pragma unroll
  for (int c = 0; c < kMaxDPerThread; ++c) {
    const int d = threadIdx.x + c * kThreads;
    vv[c] = d < D ? to_f32(vn[d]) * sv : 0.f;
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r < G) {
      const float al = t.alpha[r], pn = t.p[r];
#pragma unroll
      for (int c = 0; c < kMaxDPerThread; ++c)
        acc[r][c] = fmaf(pn, vv[c], acc[r][c] * al);
    }
  }
  store_rows<TQ, TKV, ROWS>(t, out, b, h, 0, G, 1, H, G, D, acc);

  // the append (B3's skip rules): pos < 0, a page past the block table or
  // a table entry outside the pool is not written
  const int pos = positions[b];
  if (pos < 0 || pos / a.page >= a.mp) return;
  const int pid = a.block_tables[static_cast<long long>(b) * a.mp +
                                 pos / a.page];
  if (pid >= a.P) return;
  const int slot = pos % a.page;
  const int words = D * static_cast<int>(sizeof(TKV)) / 4;
  uint8_t* pool = const_cast<uint8_t*>(a.pool);
  for (int kv = 0; kv < 2; ++kv) {
    const size_t row =
        (((static_cast<size_t>(a.layer) * 2 + kv) * a.KH + h) * a.P + pid) *
            a.page + slot;
    uint32_t* dst =
        reinterpret_cast<uint32_t*>(pool + row * D * sizeof(TKV));
    const uint32_t* src =
        reinterpret_cast<const uint32_t*>(kv == 0 ? kn : vn);
    for (int w = threadIdx.x; w < words; w += kThreads) dst[w] = src[w];
  }
  if (quantized && threadIdx.x < 2) {
    float* sc = const_cast<float*>(a.scales) +
                ((static_cast<long long>(a.layer) * 2 + threadIdx.x) * a.KH +
                 h) * a.scale_stride +
                static_cast<long long>(pid) * a.page + slot;
    *sc = threadIdx.x == 0 ? sk : sv;
  }
}

template <typename TQ, typename TKV>
cudaError_t launch_prefill(const Args& a, const void* q, void* out,
                           const int* seq_lens, const int* q_offsets, int B,
                           int T, int H, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<TKV, kPrefillRows>(a.D, a.page);
  auto kernel = paged_attention_kernel<TQ, TKV>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const int G = H / a.KH;
  dim3 grid(B * a.KH, (T * G + kPrefillRows - 1) / kPrefillRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      a, static_cast<const TQ*>(q), static_cast<TQ*>(out), seq_lens,
      q_offsets, T, H, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int D, int ROWS>
cudaError_t launch_split(const Args& a, const void* q, void* out,
                         const int* seq_lens, float* part_acc,
                         float* part_ml, int* counters, int B, int H,
                         int splits, int pps, float scale,
                         cudaStream_t stream) {
  // the deepest ring (at most kMaxStages pages, no more than a split
  // holds) that fits the block's shared memory
  const int es = sizeof(TKV), qrow = Lanes<TKV, D>::qrow(D);
  const bool quant = a.scales != nullptr;
  const int stages = split_stages(D, qrow, es, a.page, quant, ROWS, pps,
                                  kMaxSplits, 0);
  if (stages == 0) return cudaErrorInvalidValue;
  const SplitLay lay =
      split_lay(D, qrow, es, a.page, quant, ROWS, stages, kMaxSplits);
  auto kernel = decode_split_kernel<TQ, TKV, D, ROWS>;
  cudaError_t err = prepare(kernel, lay.bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B * a.KH, splits), kSplitThreads, lay.bytes, stream>>>(
      a, static_cast<const TQ*>(q), static_cast<TQ*>(out), seq_lens,
      part_acc, part_ml, counters, H, pps, stages, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_decode(const Args& a, const void* q, void* out,
                          const int* seq_lens, float* part_acc,
                          float* part_ml, int* counters, int B, int H,
                          int splits, int pps, float scale,
                          cudaStream_t stream) {
  const bool narrow = H / a.KH <= 4;
  if (a.D == 128)
    return narrow ? launch_split<TQ, TKV, 128, 4>(
                        a, q, out, seq_lens, part_acc, part_ml, counters,
                        B, H, splits, pps, scale, stream)
                  : launch_split<TQ, TKV, 128, 8>(
                        a, q, out, seq_lens, part_acc, part_ml, counters,
                        B, H, splits, pps, scale, stream);
  if (a.D == 256)
    return narrow ? launch_split<TQ, TKV, 256, 4>(
                        a, q, out, seq_lens, part_acc, part_ml, counters,
                        B, H, splits, pps, scale, stream)
                  : launch_split<TQ, TKV, 256, 8>(
                        a, q, out, seq_lens, part_acc, part_ml, counters,
                        B, H, splits, pps, scale, stream);
  return cudaErrorInvalidValue;
}

template <typename TQ, typename TKV>
cudaError_t launch_decode_append(const Args& a, const void* q, void* out,
                                 const int* seq_lens, const int* positions,
                                 const void* news, const float* new_scales,
                                 int B, int H, float scale,
                                 cudaStream_t stream) {
  const size_t smem = smem_bytes<TKV, kDecodeRows>(a.D, a.page);
  auto kernel = paged_attention_decode_append_kernel<TQ, TKV>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * a.KH, kThreads, smem, stream>>>(
      a, static_cast<const TQ*>(q), static_cast<TQ*>(out), seq_lens,
      positions, static_cast<const TKV*>(news), new_scales, H, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pbt_paged_attention(
    const void* q, void* out, const void* pool, const float* scales,
    const int* block_tables, const int* seq_lens, const int* q_offsets,
    int B, int T, int H, int KH, int D, int P, int page, int mp, int layer,
    long long scale_stride, float scale, float softcap, int window,
    int q_dtype, int kv_dtype, void* stream) {
  if (D > kThreads * kMaxDPerThread || H % KH != 0) return cudaErrorInvalidValue;
  const Args a{static_cast<const uint8_t*>(pool), scales, block_tables, KH,
               D, P, page, mp, layer, scale_stride, softcap, window};
  auto run = [&]() -> cudaError_t {
    PBT_DISPATCH(launch_prefill, a, q, out, seq_lens, q_offsets, B, T, H,
                 scale, static_cast<cudaStream_t>(stream));
  };
  return static_cast<int>(run());
}

// B2: D 128 or 256, G = H / KH <= 8; the key range of each (sequence, KV
// head) split into `splits` runs of `pps` pages of the block table
// (splits * pps >= mp > (splits - 1) * pps, splits <= 64), with the
// workspace part_acc [B * KH, splits, G, D] and part_ml [.., G, 2] and
// B * KH zeroed counters where splits > 1; the pool and the scales
// 16-byte aligned (bulk copies).
extern "C" int pbt_paged_attention_decode(
    const void* q, void* out, const void* pool, const float* scales,
    const int* block_tables, const int* seq_lens, float* part_acc,
    float* part_ml, int* counters, int B, int H, int KH, int D, int P,
    int page, int mp, int layer, long long scale_stride, int splits,
    int pps, float scale, float softcap, int window, int q_dtype,
    int kv_dtype, void* stream) {
  if ((D != 128 && D != 256) || H % KH != 0 || H / KH > kDecodeRows ||
      page < 1 || splits < 1 || splits > kMaxSplits || pps < 1 ||
      splits * pps < mp || (splits > 1 && (splits - 1) * pps >= mp) ||
      !hop::aligned16(pool) || (scales != nullptr && !hop::aligned16(scales)) ||
      (splits > 1 &&
       (part_acc == nullptr || part_ml == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  const Args a{static_cast<const uint8_t*>(pool), scales, block_tables, KH,
               D, P, page, mp, layer, scale_stride, softcap, window};
  auto run = [&]() -> cudaError_t {
    PBT_DISPATCH(launch_decode, a, q, out, seq_lens, part_acc, part_ml,
                 counters, B, H, splits, pps, scale,
                 static_cast<cudaStream_t>(stream));
  };
  return static_cast<int>(run());
}

extern "C" int pbt_paged_attention_decode_append(
    const void* q, void* out, void* pool, float* scales,
    const int* block_tables, const int* seq_lens, const int* positions,
    const void* news, const float* new_scales, int B, int H, int KH, int D,
    int P, int page, int mp, int layer, long long scale_stride, float scale,
    float softcap, int window, int q_dtype, int kv_dtype, void* stream) {
  if (D > kThreads * kMaxDPerThread || H % KH != 0 ||
      H / KH > kDecodeRows)
    return cudaErrorInvalidValue;
  const Args a{static_cast<const uint8_t*>(pool), scales, block_tables, KH,
               D, P, page, mp, layer, scale_stride, softcap, window};
  auto run = [&]() -> cudaError_t {
    PBT_DISPATCH(launch_decode_append, a, q, out, seq_lens, positions, news,
                 new_scales, B, H, scale, static_cast<cudaStream_t>(stream));
  };
  return static_cast<int>(run());
}
