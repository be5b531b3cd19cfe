// Paged attention over the [L, 2, KH, P, page, D] KV pool, for Hopper.
//
// Three kernels, one per Pallas kernel of the JAX package they replace:
//
//   pbt_paged_attention         <- ops/paged_attention.py::paged_attention
//                                  (_kernel / _attend): a T >= 1 query chunk
//                                  (chunked prefill, the speculative verify
//                                  chunk), causal by absolute position, with
//                                  the per-page score export as an option.
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
// with B6-B9 (split_decode.cuh: a copy warp bringing pages by bulk
// copy into a ring, four compute warps without a block barrier per page,
// the last part of a (sequence, KV head) merging the parts in order). Its
// grid is (sequence, KV head, split of the block table): the wrapper picks
// the splits from B, KH and the table width so the grid fills about two
// waves of 132 SMs, at least one page a split
// (ops/paged_attention.py::decode_split_plan). A split with no visible page
// still writes (m = -1e30, l = 0, acc = 0) and counts toward the merge.
//
// B9, the fused decode append (decode_append_split_kernel), is B2 on the
// same body, grid, plan and workspace (split_part with APPEND), in one
// launch per layer in place of B3's and B2's. Its bound is B2's bytes plus
// B3's, so it is as latency-bound as B2, and a single block per (sequence,
// KV head) walking its pages (its earlier design, and B2's before its
// split) took 2-2.5x the two launches it replaces. Three things differ from
// B2: (1) the parts read only the keys already in the pool (key < seq_len
// - 1; the window stays relative to the query at seq_len - 1), since the
// new token's slot holds a stale row until this kernel stores it; (2) the
// new token enters once, in the merge, as one more partial (m = its score,
// l = 1, acc = its V row times its scale) after the parts in part order:
// its score is the staged q rows against its K row (from the wrapper's
// `news`, never read back from the pool, loaded while the q rows are
// staged) with its scale folded in before the dot, then the softcap; (3)
// the merging block's copy warp, idle once its pages are on their way,
// stores the new K/V row and its two scales at positions[b] with B3's skip
// rules. It loads them before its copies and waits at a named barrier for
// the compute warps: they arrive after their page reads where a (sequence,
// KV head) has a single part, else once the counter says every part has
// read its pages, so no part copies a page while its slot is written, and
// the store drains while the parts merge. The TPU kernel's tail-slab
// read-modify-write and its scales-slab patching for every sequence
// (paged_attention.py:1318-1347) have no counterpart: each row and each
// scale is a plain store of its own.
//
// Every entry point returns cudaGetLastError() after its launch.

#include "hopper.cuh"
#include "paged_attention.cuh"
#include "split_decode.cuh"

namespace {

// grid (B * KH, cdiv(T * G, kPrefillRows)); block kThreads. score_part:
// null, or the per-page score export's partial rows [B * KH, gridDim.y, mp]:
// the block's row is -1e30 for every page, then each page it attends
// holds the largest masked score of the block's rows over its keys (the
// page step's softmax_page computes it per row as its m_blk); the wrapper
// reduces the rows by max.
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(Args a, const TQ* __restrict__ q, TQ* __restrict__ out,
                       const int* __restrict__ seq_lens,
                       const int* __restrict__ q_offsets, int T, int H,
                       float scale, float* __restrict__ score_part) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float wmax[kWarps];
  constexpr int ROWS = kPrefillRows;
  const int b = blockIdx.x / a.KH, h = blockIdx.x % a.KH;
  const int G = H / a.KH;
  const int r0 = blockIdx.y * ROWS;
  const int nrows = min(ROWS, T * G - r0);
  float* srow = nullptr;
  if (score_part != nullptr) {   // ordered before its page stores by the
    srow = score_part +          // barrier in load_rows
           (static_cast<size_t>(blockIdx.x) * gridDim.y + blockIdx.y) * a.mp;
    for (int i = threadIdx.x; i < a.mp; i += kThreads) srow[i] = kNegBig;
  }
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
    attend_page<TKV, ROWS>(a, t, qpos, nrows, b, h, i, seq_len, acc, srow,
                           wmax);
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

// -- B9: B2 with the T=1 KV append fused in (split_part's APPEND) -------

// B2's grid and workspace; split blockIdx.y takes the pages of [split *
// pps, split * pps + pps) that hold keys already in the pool (key <
// seq_len - 1, seq_lens being the lengths after the append). The new
// token (nt: its rows [B, 2, KH, 1, D] in the pool's dtype, INT8 scales
// [B, 2, KH], targets positions [B]) enters in the merge, and the merging
// block's copy warp stores it.
template <typename TQ, typename TKV, int D, int ROWS>
__global__ void __launch_bounds__(kSplitThreads)
decode_append_split_kernel(Args a, const TQ* __restrict__ q,
                           TQ* __restrict__ out,
                           const int* __restrict__ seq_lens, NewToken nt,
                           float* __restrict__ part_acc,
                           float* __restrict__ part_ml,
                           int* __restrict__ counters, int H, int pps,
                           int stages, float scale) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int is_last;
  const SplitLay lay =
      split_lay(D, Lanes<TKV, D>::qrow(D), sizeof(TKV), a.page,
                a.scales != nullptr, ROWS, stages, kMaxSplits);
  ring_init(smem, lay, stages, true);
  const int bh = blockIdx.x, b = bh / a.KH, split = blockIdx.y;
  const int seq_len = seq_lens[b];
  const int i0 = max(split * pps, first_decode_page(a, seq_len));
  const int n =
      max(min(split * pps + pps, decode_pages(a, seq_len - 1)) - i0, 0);
  const Part w{b, bh % a.KH, i0, n, split, static_cast<int>(gridDim.y),
               static_cast<long long>(bh) * gridDim.y};
  split_part<TQ, TKV, D, ROWS, true>(a, smem, lay, is_last, q, out, false,
                                     w, seq_len, H, stages, 0, true,
                                     part_acc, part_ml, counters, scale, nt);
}

template <typename TQ, typename TKV>
cudaError_t launch_prefill(const Args& a, const void* q, void* out,
                           const int* seq_lens, const int* q_offsets,
                           float* score_part, int B, int T, int H,
                           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<TKV, kPrefillRows>(a.D, a.page);
  auto kernel = paged_attention_kernel<TQ, TKV>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const int G = H / a.KH;
  dim3 grid(B * a.KH, (T * G + kPrefillRows - 1) / kPrefillRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      a, static_cast<const TQ*>(q), static_cast<TQ*>(out), seq_lens,
      q_offsets, T, H, scale, score_part);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int D, int ROWS, bool APPEND>
cudaError_t launch_split(const Args& a, const void* q, void* out,
                         const int* seq_lens, const NewToken& nt,
                         float* part_acc, float* part_ml, int* counters,
                         int B, int H, int splits, int pps, float scale,
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
  const dim3 grid(B * a.KH, splits);
  cudaError_t err;
  if constexpr (APPEND) {
    auto kernel = decode_append_split_kernel<TQ, TKV, D, ROWS>;
    err = prepare(kernel, lay.bytes);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kSplitThreads, lay.bytes, stream>>>(
        a, static_cast<const TQ*>(q), static_cast<TQ*>(out), seq_lens, nt,
        part_acc, part_ml, counters, H, pps, stages, scale);
  } else {
    auto kernel = decode_split_kernel<TQ, TKV, D, ROWS>;
    err = prepare(kernel, lay.bytes);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kSplitThreads, lay.bytes, stream>>>(
        a, static_cast<const TQ*>(q), static_cast<TQ*>(out), seq_lens,
        part_acc, part_ml, counters, H, pps, stages, scale);
  }
  return cudaGetLastError();
}

// B2's instances (APPEND false) or B9's: dh 128 or 256, rows 4 or 8
template <typename TQ, typename TKV, bool APPEND>
cudaError_t launch_split_d(const Args& a, const void* q, void* out,
                           const int* seq_lens, const NewToken& nt,
                           float* part_acc, float* part_ml, int* counters,
                           int B, int H, int splits, int pps, float scale,
                           cudaStream_t stream) {
  const bool narrow = H / a.KH <= 4;
#define PBT_SPLIT(D_, R_)                                                   \
  launch_split<TQ, TKV, D_, R_, APPEND>(a, q, out, seq_lens, nt, part_acc, \
                                        part_ml, counters, B, H, splits,   \
                                        pps, scale, stream)
  if (a.D == 128) return narrow ? PBT_SPLIT(128, 4) : PBT_SPLIT(128, 8);
  if (a.D == 256) return narrow ? PBT_SPLIT(256, 4) : PBT_SPLIT(256, 8);
#undef PBT_SPLIT
  return cudaErrorInvalidValue;
}

template <typename TQ, typename TKV>
cudaError_t launch_decode(const Args& a, const void* q, void* out,
                          const int* seq_lens, float* part_acc,
                          float* part_ml, int* counters, int B, int H,
                          int splits, int pps, float scale,
                          cudaStream_t stream) {
  return launch_split_d<TQ, TKV, false>(a, q, out, seq_lens, NewToken{},
                                        part_acc, part_ml, counters, B, H,
                                        splits, pps, scale, stream);
}

template <typename TQ, typename TKV>
cudaError_t launch_decode_append(const Args& a, const void* q, void* out,
                                 const int* seq_lens, const NewToken& nt,
                                 float* part_acc, float* part_ml,
                                 int* counters, int B, int H, int splits,
                                 int pps, float scale, cudaStream_t stream) {
  return launch_split_d<TQ, TKV, true>(a, q, out, seq_lens, nt, part_acc,
                                       part_ml, counters, B, H, splits, pps,
                                       scale, stream);
}

}  // namespace

// Query rows a block of B1 on the CUDA cores takes: the per-page score
// export's partial rows are cdiv(T * H / KH, this) a (sequence, KV head).
extern "C" int pbt_paged_attention_block_rows() { return kPrefillRows; }

// B1 on the CUDA cores; score_part: null, or the per-page score export's
// partial rows [B * KH, score_blocks, mp], score_blocks = cdiv(T * H / KH,
// kPrefillRows) (else the launch is refused).
extern "C" int pbt_paged_attention(
    const void* q, void* out, const void* pool, const float* scales,
    const int* block_tables, const int* seq_lens, const int* q_offsets,
    float* score_part, int score_blocks, int B, int T, int H, int KH, int D,
    int P, int page, int mp, int layer,
    long long scale_stride, float scale, float softcap, int window,
    int q_dtype, int kv_dtype, void* stream) {
  if (D > kThreads * kMaxDPerThread || KH <= 0 || H % KH != 0)
    return cudaErrorInvalidValue;
  if (score_part != nullptr &&
      score_blocks != (T * (H / KH) + kPrefillRows - 1) / kPrefillRows)
    return cudaErrorInvalidValue;
  const Args a{static_cast<const uint8_t*>(pool), scales, block_tables, KH,
               D, P, page, mp, layer, scale_stride, softcap, window};
  auto run = [&]() -> cudaError_t {
    PBT_DISPATCH(launch_prefill, a, q, out, seq_lens, q_offsets, score_part,
                 B, T, H, scale, static_cast<cudaStream_t>(stream));
  };
  return static_cast<int>(run());
}

// B2: D 128 or 256, G = H / KH <= 8; the key range of each (sequence, KV
// head) split into `splits` runs of `pps` pages of the block table
// (splits * pps >= mp > (splits - 1) * pps, splits <= 64), with the
// workspace part_acc [B * KH, splits, G, D] and part_ml [.., G, 2] and
// B * KH zeroed counters where splits > 1; the pool and the scales
// 16-byte aligned (bulk copies).
static bool split_args_ok(const void* pool, const float* scales,
                          const float* part_acc, const float* part_ml,
                          const int* counters, int H, int KH, int D,
                          int page, int mp, int splits, int pps) {
  return (D == 128 || D == 256) && H % KH == 0 && H / KH <= kDecodeRows &&
         page >= 1 && splits >= 1 && splits <= kMaxSplits && pps >= 1 &&
         splits * pps >= mp && (splits == 1 || (splits - 1) * pps < mp) &&
         hop::aligned16(pool) &&
         (scales == nullptr || hop::aligned16(scales)) &&
         (splits == 1 ||
          (part_acc != nullptr && part_ml != nullptr && counters != nullptr));
}

extern "C" int pbt_paged_attention_decode(
    const void* q, void* out, const void* pool, const float* scales,
    const int* block_tables, const int* seq_lens, float* part_acc,
    float* part_ml, int* counters, int B, int H, int KH, int D, int P,
    int page, int mp, int layer, long long scale_stride, int splits,
    int pps, float scale, float softcap, int window, int q_dtype,
    int kv_dtype, void* stream) {
  if (!split_args_ok(pool, scales, part_acc, part_ml, counters, H, KH, D,
                     page, mp, splits, pps))
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

// B9: B2's arguments and cut, with the new token's rows `news` [B, 2, KH,
// 1, D] in the pool's dtype (16-byte aligned), their INT8 scales
// new_scales [B, 2, KH] (null for other pools) and the targets positions
// [B]; the pool and the scales are written in place.
extern "C" int pbt_paged_attention_decode_append(
    const void* q, void* out, void* pool, float* scales,
    const int* block_tables, const int* seq_lens, const int* positions,
    const void* news, const float* new_scales, float* part_acc,
    float* part_ml, int* counters, int B, int H, int KH, int D, int P,
    int page, int mp, int layer, long long scale_stride, int splits,
    int pps, float scale, float softcap, int window, int q_dtype,
    int kv_dtype, void* stream) {
  if (!split_args_ok(pool, scales, part_acc, part_ml, counters, H, KH, D,
                     page, mp, splits, pps) ||
      !hop::aligned16(news) || (scales != nullptr) != (new_scales != nullptr))
    return cudaErrorInvalidValue;
  const Args a{static_cast<const uint8_t*>(pool), scales, block_tables, KH,
               D, P, page, mp, layer, scale_stride, softcap, window};
  const NewToken nt{static_cast<const uint8_t*>(news), new_scales,
                    positions};
  auto run = [&]() -> cudaError_t {
    PBT_DISPATCH(launch_decode_append, a, q, out, seq_lens, nt, part_acc,
                 part_ml, counters, B, H, splits, pps, scale,
                 static_cast<cudaStream_t>(stream));
  };
  return static_cast<int>(run());
}
