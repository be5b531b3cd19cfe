// T = 1 decode attention over an unpadded pool, for Hopper: B8, computing
// B2's function (the lone query of each sequence at position seq_len - 1,
// keys key < seq_len and, with a window, key > seq_len - 1 - window).
//
//   pbt_paged_attention_decode_packed
//       <- ops/paged_attention.py::paged_attention_decode_packed
//          (_decode_packed_kernel): the route for an unpadded pool of head
//          dim 16, 32 or 64 (TinyLlama's 64).
//
// A source of its own, beside paged_decode.cu's B6 and B7 on the same
// split-KV body, so that the two build side by side.
//
// What bounds it on the H100: bytes, as B6's (paged_decode.cu); at
// TinyLlama's shape the fixed cost and the latency.
//
// * Packed (B8, decode_packed_split_kernel) runs the same body too: the
//   TPU kernel computes in parity classes because a sub-128 head dim fills
//   a fraction of its 128-lane tile; the card has no lane tile and an
//   unpadded [page, D] page is contiguous, so the bulk copies take it as
//   it is. Grid (sequence x KV head, split), each split a run of pps pages
//   from the window's first visible one (ops/paged_attention.py::
//   decode_packed_plan: B6's plan with runs of single pages). At TinyLlama's
//   shape (path (g): 8 sequences x 4 KV heads of 1-2 pages) the time is
//   fixed cost and latency, not bytes (the bound is 0.15 us), so a split
//   past a sequence's visible pages exits at once and only the splits that
//   hold pages take part in the merge. Head dims 16, 32 and 64 are compiled
//   (split_decode.cuh's narrow lane layout: a row of 16, 32 or 64 bytes in
//   eighths, so no lane of a key idles, and P.V's key slices at dh 16 and
//   32, so no lane idles there either); the q dtype is a template
//   argument, as in B2 and B7, and the rows 8 (G <= 8).
//
// Every entry point returns cudaGetLastError() after its launch.

#include "hopper.cuh"
#include "paged_attention.cuh"
#include "split_decode.cuh"

namespace {

// What a launch of B8 takes besides Args.
struct Launch {
  const void* q;
  void* out;
  bool qbf;                 // B6: q and out bf16 (else f32)
  const int* seq_lens;
  float* part_acc;
  float* part_ml;
  int* counters;
  int B, H;
  int splits, pps;          // B6, B8: grid (B * KH, splits); B7: blocks
  int stages;               // B6, B8: ring depth (0: the deepest that fits)
  float scale;
  cudaStream_t stream;
};

// B8: grid (B * KH, splits); block kSplitThreads; rows = the G <= 8 query
// heads of KV head h; split s takes the pages [first + s * pps, .. + pps)
// of the block table (first: the page of the window's first visible key)
// as far as they hold visible keys. A split past them exits at once: the
// (sequence, KV head)'s parts are its splits that hold pages, and with
// none, split 0 writes zeros. Partials: acc [B * KH, splits, G, D], (m, l)
// [.., G, 2]; counters one a (sequence, KV head).
template <typename TQ, typename TKV, int DT>
__global__ void __launch_bounds__(kSplitThreads, 1)
decode_packed_split_kernel(Args a, const TQ* __restrict__ q,
                           TQ* __restrict__ out,
                           const int* __restrict__ seq_lens,
                           float* __restrict__ part_acc,
                           float* __restrict__ part_ml,
                           int* __restrict__ counters, int H, int pps,
                           int stages, float scale) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int is_last;
  const int bh = blockIdx.x, b = bh / a.KH, split = blockIdx.y;
  const int seq_len = seq_lens[b];
  const int first = first_decode_page(a, seq_len);
  const int vis = max(decode_pages(a, seq_len) - first, 0);
  const int parts = max(1, (vis + pps - 1) / pps);
  if (split >= parts) return;
  const SplitLay lay =
      split_lay(DT, Lanes<TKV, DT>::qrow(DT), sizeof(TKV), a.page,
                a.scales != nullptr, kDecodeRows, stages, kMaxSplits);
  ring_init(smem, lay, stages, true);
  const Part w{b, bh % a.KH, first + split * pps,
               max(min(pps, vis - split * pps), 0), split, parts,
               static_cast<long long>(bh) * gridDim.y};
  split_part<TQ, TKV, DT, kDecodeRows>(a, smem, lay, is_last, q, out, false,
                                       w, seq_len, H, stages, 0, true,
                                       part_acc, part_ml, counters, scale);
}

template <typename TQ, typename TKV, int DT>
cudaError_t launch_packed_split(const Args& a, const Launch& l) {
  const int es = sizeof(TKV), qrow = Lanes<TKV, DT>::qrow(DT);
  const bool quant = a.scales != nullptr;
  // the deepest ring that fits (at most a split's pages), or the one asked
  const int stages =
      split_stages(DT, qrow, es, a.page, quant, kDecodeRows,
                   l.stages > 0 ? l.stages : l.pps, kMaxSplits, 0);
  if (stages == 0 || (l.stages > 0 && stages != l.stages))
    return cudaErrorInvalidValue;
  const SplitLay lay =
      split_lay(DT, qrow, es, a.page, quant, kDecodeRows, stages, kMaxSplits);
  auto kernel = decode_packed_split_kernel<TQ, TKV, DT>;
  cudaError_t err = prepare(kernel, lay.bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(l.B * a.KH, l.splits), kSplitThreads, lay.bytes,
           l.stream>>>(a, static_cast<const TQ*>(l.q), static_cast<TQ*>(l.out),
                       l.seq_lens, l.part_acc, l.part_ml, l.counters, l.H,
                       l.pps, stages, l.scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_packed(const Args& a, const Launch& l) {
  switch (a.D) {
    case 16: return launch_packed_split<TQ, TKV, 16>(a, l);
    case 32: return launch_packed_split<TQ, TKV, 32>(a, l);
    case 64: return launch_packed_split<TQ, TKV, 64>(a, l);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// B8: D 16, 32 or 64, G = H / KH <= 8, pages of a multiple of 16 bytes;
// the visible pages of each (sequence, KV head), counted from the window's
// first, split into `splits` runs of `pps` pages (splits * pps >= the most a
// window leaves visible, as B6's; splits <= 64); the workspace part_acc
// [B * KH, splits, G, D], part_ml [.., G, 2] and B * KH zeroed counters
// where splits > 1; `stages` the ring's depth (0: the deepest that fits);
// the pool and the scales 16-byte aligned.
extern "C" int pbt_paged_attention_decode_packed(
    const void* q, void* out, const void* pool, const float* scales,
    const int* block_tables, const int* seq_lens, float* part_acc,
    float* part_ml, int* counters, int B, int H, int KH, int D, int P,
    int page, int mp, int layer, long long scale_stride, int splits,
    int pps, int stages, float scale, float softcap, int window,
    int q_dtype, int kv_dtype, void* stream) {
  const int es = kv_dtype == 0 ? 4 : kv_dtype == 1 ? 2 : 1;
  const int width =
      window > 0 ? min(mp, (window + page - 2) / page + 1) : mp;
  if ((D != 16 && D != 32 && D != 64) || H % KH != 0 ||
      H / KH > kDecodeRows || page < 1 || (page * D * es) % 16 != 0 ||
      splits < 1 || splits > kMaxSplits || pps < 1 ||
      static_cast<long long>(splits) * pps < width || stages < 0 ||
      stages > kMaxStages || !hop::aligned16(pool) ||
      (scales != nullptr && !hop::aligned16(scales)) ||
      (splits > 1 &&
       (part_acc == nullptr || part_ml == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  const Args a{static_cast<const uint8_t*>(pool), scales, block_tables, KH,
               D, P, page, mp, layer, scale_stride, softcap, window};
  const Launch l{q, out, q_dtype == 1, seq_lens, part_acc, part_ml,
                 counters, B, H, splits, pps, stages, scale,
                 static_cast<cudaStream_t>(stream)};
  auto run = [&]() -> cudaError_t {
    PBT_DISPATCH(launch_packed, a, l);
  };
  return static_cast<int>(run());
}

