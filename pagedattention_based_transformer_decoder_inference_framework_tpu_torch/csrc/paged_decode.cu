// T = 1 decode attention beyond B2, for Hopper: two of the three other
// decode kernels of the JAX package (the third, B8, is
// paged_decode_packed.cu, a source of its own so that the two build side
// by side), each computing B2's function (the lone query
// of each sequence at position seq_len - 1, keys key < seq_len and, with a
// window, key > seq_len - 1 - window).
//
//   pbt_paged_attention_decode_grouped
//       <- ops/paged_attention.py::paged_attention_decode_grouped
//          (_decode_grouped_kernel): the engine's route for a head dim that
//          does not divide 128 (Phi-3's 96) and for an INT8 pool whose
//          block table is wider than the TPU kernel's 2 MiB scales budget
//          (a 32k context at Llama-3 geometry).
//   pbt_paged_attention_decode_batched
//       <- ops/paged_attention.py::paged_attention_decode_batched
//          (_decode_batched_kernel): the whole batch in one launch. Neither
//          engine calls it.
//
// What bounds them on the H100: bytes. A decode step reads every visible
// K/V row once (with its INT8 scales), and does 4 * D operations per
// (query head, key); at a 32k context that is ~69 MB a layer at Llama-3
// geometry, 21 us at 3.35 TB/s. The TPU kernels are shaped by its
// sequential grid and 128-lane tiles; here the shape follows the card:
//
// * Grouped (B6) and batched (B7) run B2's split-KV body
//   (split_decode.cuh: pages by bulk copy into a ring, four compute warps
//   each with its own online softmax, the parts of a (sequence, KV head)
//   merged in part order by the last to finish, one launch a call); only
//   their cut of the work differs.
//   - B6 (decode_grouped_split_kernel): grid (sequence x KV head, split).
//     The TPU walks J = group_pages pages a grid step into one accumulator,
//     in sequence over the whole table; here the table's visible pages,
//     counted from the window's first, are split in runs of pps pages, pps
//     a multiple of J, as many splits as bring the grid to about two waves
//     (ops/paged_attention.py::decode_grouped_plan; a window of 2047 keys
//     at page 64 leaves 33 pages to split however wide the table). The
//     lane layout is compiled for head dims 64, 96, 128 and 256 (16-byte
//     chunks of K a lane where a row is a multiple of 16 bytes); every other
//     even head dim up to 256 runs the generic instance of the same kernel
//     (pairs of values a lane; a page that is not a multiple of 16 bytes
//     copied by plain loads). ROWS is 1 for one query head a KV head
//     (Phi-3-mini), 4 up to four, else 8.
//   - B7 (decode_batched_split_kernel): the JAX kernel pays its DMA latency
//     once for the whole batch; the card has no such chain, but B2's splits
//     come from shapes alone, so over ragged lengths the longest sequence's
//     splits set the time. B7 splits by the batch's real lengths: its grid
//     (about two waves of 132 SMs, no more blocks than B * KH * mp) is fixed
//     by the shapes; each block reads seq_lens, forms the prefix of visible
//     pages over (sequence, KV head) and takes an equal contiguous run of the
//     flattened (sequence, KV head, page) units, which may end one (sequence,
//     KV head) and start the next; each block derives (b, h)'s part count
//     from the same partition (ops/paged_attention.py::
//     decode_batched_partition). A (sequence, KV head) with no visible page
//     gets zeros from block (b * KH + h) % blocks.
//
// Every entry point returns cudaGetLastError() after its launch.

#include "hopper.cuh"
#include "paged_attention.cuh"
#include "split_decode.cuh"

// B6's dispatch on the pool's dtype code (0 float32, 1 bfloat16, 2 int8)
#define PBT_KV_DISPATCH(FN, ...)                                         \
  do {                                                                   \
    if (kv_dtype == 0) return FN<float>(__VA_ARGS__);                    \
    if (kv_dtype == 1) return FN<__nv_bfloat16>(__VA_ARGS__);            \
    if (kv_dtype == 2) return FN<int8_t>(__VA_ARGS__);                   \
    return cudaErrorInvalidValue;                                        \
  } while (0)

namespace {

// What a launch of B6 or B7 takes besides Args.
struct Launch {
  const void* q;
  void* out;
  bool qbf;                 // B6: q and out bf16 (else f32)
  const int* seq_lens;
  float* part_acc;
  float* part_ml;
  int* counters;
  int B, H;
  int splits, pps;          // B6: grid (B * KH, splits); B7: blocks
  int stages;               // B6: ring depth (0: the deepest that fits)
  float scale;
  cudaStream_t stream;
};

// B6: grid (B * KH, splits); block kSplitThreads; rows = the G <= ROWS
// query heads of KV head h; split s takes the pages [first + s * pps,
// first + s * pps + pps) of the block table, first the page of the
// window's first visible key, as far as they hold visible keys. Partials:
// acc [B * KH, splits, G, D], (m, l) [.., G, 2]; counters one a (sequence,
// KV head). DT = 0: the head dim a.D. The q dtype is a runtime flag here
// (qbf), not a template argument as in B2 and B7, which halves B6's 39
// instances (4 head dims x 3 rows + the generic, x 3 pool dtypes).
template <typename TKV, int DT, int ROWS>
__global__ void __launch_bounds__(kSplitThreads)
decode_grouped_split_kernel(Args a, const void* __restrict__ q,
                            void* __restrict__ out, bool qbf,
                            const int* __restrict__ seq_lens,
                            float* __restrict__ part_acc,
                            float* __restrict__ part_ml,
                            int* __restrict__ counters, int H, int pps,
                            int stages, float scale) {
  using L = Lanes<TKV, DT>;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int is_last;
  const int D = DT > 0 ? DT : a.D, es = sizeof(TKV);
  const bool bulk = L::kVec || (a.page * D * es) % 16 == 0;
  const SplitLay lay = split_lay(D, L::qrow(D), es, a.page,
                                 a.scales != nullptr, ROWS, stages,
                                 kMaxSplits);
  ring_init(smem, lay, stages, bulk);
  const int bh = blockIdx.x, b = bh / a.KH, split = blockIdx.y;
  const int seq_len = seq_lens[b];
  const int i0 = first_decode_page(a, seq_len) + split * pps;
  const int n = max(min(i0 + pps, decode_pages(a, seq_len)) - i0, 0);
  const Part w{b, bh % a.KH, i0, n, split, static_cast<int>(gridDim.y),
               static_cast<long long>(bh) * gridDim.y};
  split_part<void, TKV, DT, ROWS>(a, smem, lay, is_last, q, out, qbf, w,
                                  seq_len, H, stages, 0, bulk, part_acc,
                                  part_ml, counters, scale);
}

// B7: grid (blocks); block kSplitThreads. The visible pages of (b, h) are
// the units [KH * pre[b] + h * vis_b, .. + vis_b) of the batch's U = KH *
// pre[B] (pre: the prefix of the sequences' visible pages, vis_b); over R =
// min(blocks, U) runs, block k < R takes the units [k U / R, (k + 1) U /
// R) (none empty), and the parts of (b, h) are the blocks k0..k1 whose runs
// hold its first and last unit: part k - k0 of k1 - k0 + 1, workspace slot
// k + b * KH + h (< blocks + B * KH).
template <typename TQ, typename TKV, int D, int ROWS>
__global__ void __launch_bounds__(kSplitThreads)
decode_batched_split_kernel(Args a, const TQ* __restrict__ q,
                            TQ* __restrict__ out,
                            const int* __restrict__ seq_lens,
                            float* __restrict__ part_acc,
                            float* __restrict__ part_ml,
                            int* __restrict__ counters, int B, int H,
                            int stages, float scale) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int is_last;
  const int nb = gridDim.x, k = blockIdx.x, KH = a.KH, G = H / KH;
  const int tid = threadIdx.x, lane = tid % 32;
  const SplitLay lay = split_lay(D, Lanes<TKV, D>::qrow(D), sizeof(TKV),
                                 a.page, a.scales != nullptr, ROWS, stages,
                                 nb);
  int* const pre = reinterpret_cast<int*>(smem + lay.bytes);  // [B + 1]
  ring_init(smem, lay, stages, true);
  for (int i = tid; i < B; i += kSplitThreads) {
    const int sl = seq_lens[i];
    pre[i + 1] = max(decode_pages(a, sl) - first_decode_page(a, sl), 0);
  }
  if (tid == 0) pre[0] = 0;
  __syncthreads();
  if (tid < 32) {  // an inclusive scan, 32 sequences a step
    int carry = 0;
    for (int base = 0; base < B; base += 32) {
      int v = base + lane < B ? pre[base + lane + 1] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += t;
      }
      if (base + lane < B) pre[base + lane + 1] = v + carry;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
  const long long U = static_cast<long long>(KH) * pre[B];
  // a (sequence, KV head) with no visible page: zeros
  for (int j = k; j < B * KH; j += nb)
    if (pre[j / KH + 1] == pre[j / KH])
      for (int idx = tid; idx < G * a.D; idx += kSplitThreads)
        out[static_cast<size_t>(j) * G * a.D + idx] = from_f32<TQ>(0.f);
  // the runs: over min(blocks, U) blocks, so that none is empty
  const long long nr = U < nb ? U : nb;
  const long long u1 = k < nr ? (k + 1) * U / nr : 0;
  int it0 = 0;
  for (long long u = k < nr ? k * U / nr : 0; u < u1;) {
    // the sequence of unit u: the last b with KH * pre[b] <= u (it has
    // visible pages)
    int lo = 0, hi = B - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (static_cast<long long>(KH) * pre[mid] <= u)
        lo = mid;
      else
        hi = mid - 1;
    }
    const int b = lo, vis = pre[b + 1] - pre[b];
    const long long sb = static_cast<long long>(KH) * pre[b];
    const int h = static_cast<int>((u - sb) / vis);
    const long long s0 = sb + static_cast<long long>(h) * vis;
    const long long e0 = s0 + vis;
    const long long k0 = ((s0 + 1) * nr - 1) / U, k1 = (e0 * nr - 1) / U;
    const int n = static_cast<int>((e0 < u1 ? e0 : u1) - u);
    const int seq_len = seq_lens[b];
    const Part w{b, h,
                 first_decode_page(a, seq_len) + static_cast<int>(u - s0), n,
                 static_cast<int>(k - k0), static_cast<int>(k1 - k0 + 1),
                 k0 + b * KH + h};
    split_part<TQ, TKV, D, ROWS>(a, smem, lay, is_last, q, out, false, w,
                                 seq_len, H, stages, it0, true, part_acc,
                                 part_ml, counters, scale);
    it0 += n;
    u += n;
  }
}

template <typename TKV, int DT, int ROWS>
cudaError_t launch_grouped_split(const Args& a, const Launch& l) {
  const int D = DT > 0 ? DT : a.D, es = sizeof(TKV);
  const int qrow = Lanes<TKV, DT>::qrow(D);
  const bool quant = a.scales != nullptr;
  // the deepest ring that fits (at most a split's pages), or the one asked
  const int stages =
      split_stages(D, qrow, es, a.page, quant, ROWS,
                   l.stages > 0 ? l.stages : l.pps, kMaxSplits, 0);
  if (stages == 0 || (l.stages > 0 && stages != l.stages))
    return cudaErrorInvalidValue;
  const SplitLay lay =
      split_lay(D, qrow, es, a.page, quant, ROWS, stages, kMaxSplits);
  auto kernel = decode_grouped_split_kernel<TKV, DT, ROWS>;
  cudaError_t err = prepare(kernel, lay.bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(l.B * a.KH, l.splits), kSplitThreads, lay.bytes,
           l.stream>>>(a, l.q, l.out, l.qbf, l.seq_lens, l.part_acc,
                       l.part_ml, l.counters, l.H, l.pps, stages, l.scale);
  return cudaGetLastError();
}

template <typename TKV, int DT>
cudaError_t grouped_rows(const Args& a, const Launch& l, int rows) {
  if (rows == 1) return launch_grouped_split<TKV, DT, 1>(a, l);
  if (rows == 4) return launch_grouped_split<TKV, DT, 4>(a, l);
  if (rows == 8) return launch_grouped_split<TKV, DT, 8>(a, l);
  return cudaErrorInvalidValue;
}

// B6's instance by head dim and rows (0: 1 for G = 1, 4 up to G = 4, else
// 8); another even head dim takes the generic instance at 8 rows.
template <typename TKV>
cudaError_t launch_grouped(const Args& a, const Launch& l, int rows) {
  const int G = l.H / a.KH;
  if (rows == 0) rows = G == 1 ? 1 : G <= 4 ? 4 : 8;
  if (rows < G) return cudaErrorInvalidValue;
  switch (a.D) {
    case 64: return grouped_rows<TKV, 64>(a, l, rows);
    case 96: return grouped_rows<TKV, 96>(a, l, rows);
    case 128: return grouped_rows<TKV, 128>(a, l, rows);
    case 256: return grouped_rows<TKV, 256>(a, l, rows);
    default: return launch_grouped_split<TKV, 0, 8>(a, l);
  }
}

template <typename TQ, typename TKV, int D, int ROWS>
cudaError_t launch_batched_split(const Args& a, const Launch& l) {
  const int es = sizeof(TKV), qrow = Lanes<TKV, D>::qrow(D);
  const bool quant = a.scales != nullptr;
  const int extra = static_cast<int>(align16(4 * (l.B + 1)));  // pre
  const int stages = split_stages(D, qrow, es, a.page, quant, ROWS,
                                  kMaxStages, l.splits, extra);
  if (stages == 0) return cudaErrorInvalidValue;
  const int smem =
      split_lay(D, qrow, es, a.page, quant, ROWS, stages, l.splits).bytes +
      extra;
  auto kernel = decode_batched_split_kernel<TQ, TKV, D, ROWS>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<l.splits, kSplitThreads, smem, l.stream>>>(
      a, static_cast<const TQ*>(l.q), static_cast<TQ*>(l.out), l.seq_lens,
      l.part_acc, l.part_ml, l.counters, l.B, l.H, stages, l.scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_batched(const Args& a, const Launch& l) {
  const bool narrow = l.H / a.KH <= 4;
  if (a.D == 128)
    return narrow ? launch_batched_split<TQ, TKV, 128, 4>(a, l)
                  : launch_batched_split<TQ, TKV, 128, 8>(a, l);
  if (a.D == 256)
    return narrow ? launch_batched_split<TQ, TKV, 256, 4>(a, l)
                  : launch_batched_split<TQ, TKV, 256, 8>(a, l);
  return cudaErrorInvalidValue;
}

}  // namespace

// B6: an even head dim D <= 256, G = H / KH <= 8; the visible pages of
// each (sequence, KV head), counted from the window's first, split into
// `splits` runs of `pps` pages (splits * pps >= the most a window leaves
// visible: mp, or with a window cdiv(window - 1, page) + 1 pages if fewer;
// splits <= 64); the workspace part_acc [B * KH, splits, G, D], part_ml
// [.., G, 2] and B * KH zeroed counters where splits > 1; `stages` the
// ring's depth (0: the deepest that fits), `rows` the instance's rows (0:
// by G; ignored by the generic instance); the pool and the scales 16-byte
// aligned.
extern "C" int pbt_paged_attention_decode_grouped(
    const void* q, void* out, const void* pool, const float* scales,
    const int* block_tables, const int* seq_lens, float* part_acc,
    float* part_ml, int* counters, int B, int H, int KH, int D, int P,
    int page, int mp, int layer, long long scale_stride, int splits,
    int pps, int stages, int rows, float scale, float softcap, int window,
    int q_dtype, int kv_dtype, void* stream) {
  const int width =
      window > 0 ? min(mp, (window + page - 2) / page + 1) : mp;
  if (D < 2 || D > 256 || D % 2 != 0 || H % KH != 0 ||
      H / KH > kDecodeRows || (q_dtype != 0 && q_dtype != 1) || page < 1 ||
      splits < 1 || splits > kMaxSplits || pps < 1 ||
      static_cast<long long>(splits) * pps < width || stages < 0 ||
      stages > kMaxStages || rows < 0 || !hop::aligned16(pool) ||
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
    PBT_KV_DISPATCH(launch_grouped, a, l, rows);
  };
  return static_cast<int>(run());
}

// B7: D 128 or 256, G = H / KH <= 8; `blocks` blocks (at most B * KH * mp
// make sense), the workspace part_acc [blocks + B * KH, G, D], part_ml
// [.., G, 2] and B * KH zeroed counters; the pool and the scales 16-byte
// aligned.
extern "C" int pbt_paged_attention_decode_batched(
    const void* q, void* out, const void* pool, const float* scales,
    const int* block_tables, const int* seq_lens, float* part_acc,
    float* part_ml, int* counters, int B, int H, int KH, int D, int P,
    int page, int mp, int layer, long long scale_stride, int blocks,
    float scale, float softcap, int window, int q_dtype, int kv_dtype,
    void* stream) {
  if ((D != 128 && D != 256) || H % KH != 0 || H / KH > kDecodeRows ||
      page < 1 || B < 1 || blocks < 1 ||
      part_acc == nullptr || part_ml == nullptr || counters == nullptr ||
      !hop::aligned16(pool) || (scales != nullptr && !hop::aligned16(scales)))
    return cudaErrorInvalidValue;
  const Args a{static_cast<const uint8_t*>(pool), scales, block_tables, KH,
               D, P, page, mp, layer, scale_stride, softcap, window};
  const Launch l{q, out, q_dtype == 1, seq_lens, part_acc, part_ml,
                 counters, B, H, blocks, 0, 0, scale,
                 static_cast<cudaStream_t>(stream)};
  auto run = [&]() -> cudaError_t {
    PBT_DISPATCH(launch_batched, a, l);
  };
  return static_cast<int>(run());
}
