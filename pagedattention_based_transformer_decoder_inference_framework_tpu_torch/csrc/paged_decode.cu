// T = 1 decode attention beyond B2, for Hopper: the three other decode
// kernels of the JAX package, each computing B2's function (the lone query
// of each sequence at position seq_len - 1, keys key < seq_len and, with a
// window, key > seq_len - 1 - window) in the fold order of
// paged_attention.cuh.
//
//   pbt_paged_attention_decode_grouped
//       <- ops/paged_attention.py::paged_attention_decode_grouped
//          (_decode_grouped_kernel): the engine's route for a head dim that
//          does not divide 128 (Phi-3's 96) and for an INT8 pool whose
//          block table is wider than the TPU kernel's 2 MiB scales budget
//          (a 32k context at Llama-3 geometry).
//   pbt_paged_attention_decode_packed
//       <- ops/paged_attention.py::paged_attention_decode_packed
//          (_decode_packed_kernel): the route for an unpadded pool of head
//          dim 16, 32 or 64 (TinyLlama's 64).
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
// * Grouped (B6) is split-KV ("flash-decoding"). The TPU walks J pages
//   per grid program into one accumulator, in sequence over the whole
//   table. Here the table itself is split: a block per (sequence, KV head,
//   group of J pages) runs B2's page step (stage a page in shared memory,
//   a thread per (query head, key) for the scores, a warp per row for the
//   online softmax, a thread per output lane for P.V) over its J pages and
//   writes its partial (m, l, acc) for the G query heads to an f32
//   workspace; a second kernel in the same call, a block per (sequence,
//   query head), rescales and sums the partials, its warps splitting the
//   groups. Groups wholly before the window or past seq_len exit at once.
//   At J = 4 a 516-page table at batch 1 and KH 8 is 8 x 129 blocks,
//   enough to fill 132 SMs where B2 runs 8 blocks that each walk 513
//   pages in turn.
// * Packed (B8): the TPU kernel computes in parity classes because a
//   sub-128 head dim fills a fraction of its 128-lane tile. The card has
//   no lane tile and an unpadded [page, D] page is already contiguous, so
//   the design is about keeping threads busy at small D: the K rows are
//   read straight from the pool with one 16-byte load per lane, so at
//   D = 64 INT8 a warp's 512-byte load covers 8 keys, each key's D-long
//   dot split over its 4 lanes and reduced by shuffles; the V page is
//   copied to shared memory by 16-byte loads and P.V runs a thread
//   per (query head, lane of D) output, all 128 threads busy where B2's
//   thread per lane of D would leave half idle. The online softmax stays
//   per page.
// * Batched (B7) is persistent: at most one block per SM, each pulling
//   (sequence, KV head) work items from a counter and running B2's page
//   loop on each. The TPU kernel issues every page DMA of the batch before
//   any wait, to pay its DMA latency chain once; the card has no such
//   chain, so this only saves the blocks' launch and retire.
//
// No tensor cores, no TMA and no async copies yet (wgmma / TMA are later
// work). Every entry point returns cudaGetLastError() after its launches.

#include "paged_attention.cuh"

namespace {

constexpr int kMaxOut = 4;      // B8: outputs (g, d) per thread, G * D <= 512

// The pages [i0, i1) of group g of J pages that hold visible keys.
__device__ __forceinline__ void group_pages(const Args& a, int seq_len, int g,
                                            int J, int& i0, int& i1) {
  i0 = max(g * J, first_decode_page(a, seq_len));
  i1 = min(g * J + J, decode_pages(a, seq_len));
}

// grid (B * KH, n_groups); block kThreads; rows = the G query heads of KV
// head h. Partials: acc [B * KH, n_groups, G, D], (m, l) [.., G, 2].
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
decode_grouped_kernel(Args a, const TQ* __restrict__ q,
                      float* __restrict__ part_acc,
                      float* __restrict__ part_ml,
                      const int* __restrict__ seq_lens, int H, int J,
                      float scale) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int ROWS = kDecodeRows;
  const int b = blockIdx.x / a.KH, h = blockIdx.x % a.KH;
  const int G = H / a.KH;
  const int seq_len = seq_lens[b];
  int i0, i1;
  group_pages(a, seq_len, blockIdx.y, J, i0, i1);
  if (i0 >= i1) return;           // the combine skips this group too
  Tile<TKV, ROWS> t(smem, a.D, a.page);
  load_rows<TQ, TKV, ROWS>(t, q, b, h, 0, G, 1, H, G, a.D, scale);
  int qpos[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) qpos[r] = seq_len - 1;
  float acc[ROWS][kMaxDPerThread] = {};
  for (int i = i0; i < i1; ++i)
    attend_page<TKV, ROWS>(a, t, qpos, G, b, h, i, seq_len, acc);

  const size_t part = static_cast<size_t>(blockIdx.x) * gridDim.y + blockIdx.y;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r < G) {
#pragma unroll
      for (int c = 0; c < kMaxDPerThread; ++c) {
        const int d = threadIdx.x + c * kThreads;
        if (d < a.D) part_acc[(part * G + r) * a.D + d] = acc[r][c];
      }
    }
  }
  if (threadIdx.x < G) {
    part_ml[(part * G + threadIdx.x) * 2] = t.m[threadIdx.x];
    part_ml[(part * G + threadIdx.x) * 2 + 1] = t.l[threadIdx.x];
  }
}

// grid (B * KH, G); block kThreads; query head r = blockIdx.y of KV head
// h. Its output from the live groups' partials: M = max m_g (threads over
// groups), w_g = e^(m_g - M), out = sum acc_g w_g / sum l_g w_g (l == 0 ->
// 1, so a row with no visible key is zeros); each warp sums a quarter of
// the groups over all of D, then the warps' sums add in warp order.
template <typename TQ>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(Args a, const float* __restrict__ part_acc,
                      const float* __restrict__ part_ml,
                      TQ* __restrict__ out, const int* __restrict__ seq_lens,
                      int H, int J, int n_groups) {
  constexpr int kMaxD = kThreads * kMaxDPerThread;
  __shared__ float sums[kWarps][kMaxD];
  __shared__ float wmax[kWarps], wl[kWarps];
  const int b = blockIdx.x / a.KH, h = blockIdx.x % a.KH, r = blockIdx.y;
  const int G = H / a.KH, D = a.D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int seq_len = seq_lens[b];
  const int first = first_decode_page(a, seq_len);
  const int n_pages = decode_pages(a, seq_len);
  // the live groups, [g0, g1): every group from the window's first page
  // to the last page holds a visible key
  const int g0 = first / J;
  const int g1 = first < n_pages ? (n_pages + J - 1) / J : g0;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * n_groups * G + r;
  const float* ml = part_ml + row0 * 2;       // group g: ml[g * G * 2]

  float mx = kNegBig;
  for (int g = g0 + threadIdx.x; g < g1; g += kThreads)
    mx = fmaxf(mx, ml[static_cast<size_t>(g) * G * 2]);
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (lane == 0) wmax[warp] = mx;
  __syncthreads();
  mx = wmax[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, wmax[w]);

  float acc[kMaxD / 32] = {}, l = 0.f;
  for (int g = g0 + warp; g < g1; g += kWarps) {
    const float wg = expf(ml[static_cast<size_t>(g) * G * 2] - mx);
    l = fmaf(ml[static_cast<size_t>(g) * G * 2 + 1], wg, l);
    const float* pa = part_acc + (row0 + static_cast<size_t>(g) * G) * D;
#pragma unroll
    for (int c = 0; c < kMaxD / 32; ++c) {
      const int d = lane + c * 32;
      if (d < D) acc[c] = fmaf(pa[d], wg, acc[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxD / 32; ++c) sums[warp][lane + c * 32] = acc[c];
  if (lane == 0) wl[warp] = l;
  __syncthreads();
  float lsum = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) lsum += wl[w];
  const float inv = 1.f / (lsum == 0.f ? 1.f : lsum);
  const size_t base = (static_cast<size_t>(b) * H + h * G + r) * D;
#pragma unroll
  for (int c = 0; c < kMaxDPerThread; ++c) {
    const int d = threadIdx.x + c * kThreads;
    if (d < D) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += sums[w][d];
      out[base + d] = from_f32<TQ>(v * inv);
    }
  }
}

// grid min(SMs, B * KH): at most one block per SM; block kThreads. Each
// block takes (sequence, KV head) items from `next` (zeroed before the
// launch) until none is left, and runs B2's page loop on each.
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
decode_batched_kernel(Args a, const TQ* __restrict__ q, TQ* __restrict__ out,
                      const int* __restrict__ seq_lens, int* next, int B,
                      int H, float scale) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int item;
  constexpr int ROWS = kDecodeRows;
  const int G = H / a.KH;
  Tile<TKV, ROWS> t(smem, a.D, a.page);
  for (;;) {
    if (threadIdx.x == 0) item = atomicAdd(next, 1);
    __syncthreads();
    const int bh = item;
    if (bh >= B * a.KH) return;
    const int b = bh / a.KH, h = bh % a.KH;
    load_rows<TQ, TKV, ROWS>(t, q, b, h, 0, G, 1, H, G, a.D, scale);
    const int seq_len = seq_lens[b];
    int qpos[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) qpos[r] = seq_len - 1;
    float acc[ROWS][kMaxDPerThread] = {};
    const int n_pages = decode_pages(a, seq_len);
    for (int i = first_decode_page(a, seq_len); i < n_pages; ++i)
      attend_page<TKV, ROWS>(a, t, qpos, G, b, h, i, seq_len, acc);
    store_rows<TQ, TKV, ROWS>(t, out, b, h, 0, G, 1, H, G, a.D, acc);
    __syncthreads();    // store_rows reads t.l; the next item resets it
  }
}

// B8's shared memory: q rows [8, D] f32 (pre-scaled), probabilities
// [8, page], K and V scales [page], m, l, alpha [8], the V page [page, D].
template <typename TKV>
__host__ __device__ size_t packed_smem_bytes(int D, int page) {
  return align16(sizeof(float) * kDecodeRows * D) +
         align16(sizeof(float) * kDecodeRows * page) +
         align16(sizeof(float) * page) * 2 +
         align16(sizeof(float) * kDecodeRows) * 3 +
         align16(sizeof(TKV) * static_cast<size_t>(page) * D);
}

// grid (B * KH); block kThreads; rows = the G query heads of KV head h.
// D * sizeof(TKV) is a multiple of 16 and at most 512 (16 lanes a key).
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
decode_packed_kernel(Args a, const TQ* __restrict__ q, TQ* __restrict__ out,
                     const int* __restrict__ seq_lens, int H, float scale) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int E = 16 / sizeof(TKV);       // values per 16-byte load
  constexpr int ROWS = kDecodeRows;
  const int D = a.D, page = a.page;
  const int b = blockIdx.x / a.KH, h = blockIdx.x % a.KH;
  const int G = H / a.KH;
  uint8_t* base = smem;
  float* sq = reinterpret_cast<float*>(base);
  base += align16(sizeof(float) * ROWS * D);
  float* sp = reinterpret_cast<float*>(base);
  base += align16(sizeof(float) * ROWS * page);
  float* sck = reinterpret_cast<float*>(base);
  base += align16(sizeof(float) * page);
  float* scv = reinterpret_cast<float*>(base);
  base += align16(sizeof(float) * page);
  float* sm = reinterpret_cast<float*>(base);
  base += align16(sizeof(float) * ROWS);
  float* sl = reinterpret_cast<float*>(base);
  base += align16(sizeof(float) * ROWS);
  float* salpha = reinterpret_cast<float*>(base);
  base += align16(sizeof(float) * ROWS);
  TKV* sv = reinterpret_cast<TKV*>(base);

  for (int idx = threadIdx.x; idx < G * D; idx += kThreads)
    sq[idx] = to_f32(q[(static_cast<size_t>(b) * H + h * G) * D + idx]) *
              scale;
  for (int r = threadIdx.x; r < ROWS; r += kThreads) {
    sm[r] = kNegBig;
    sl[r] = 0.f;
  }
  __syncthreads();

  const int seq_len = seq_lens[b];
  int qpos[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) qpos[r] = seq_len - 1;
  const int lanes = D / E;                  // lanes per key: 1, 2, 4, ... 16
  const int keys = 32 / lanes;              // keys per warp step
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane % lanes;             // this lane's E values of a row
  const int row_vecs = page * D / E;        // 16-byte vectors of a page
  float acc[kMaxOut] = {};
  const int n_pages = decode_pages(a, seq_len);
  for (int i = first_decode_page(a, seq_len); i < n_pages; ++i) {
    const int pid = a.block_tables[static_cast<long long>(b) * a.mp + i];
    const TKV* kp = reinterpret_cast<const TKV*>(a.pool) +
                    page_offset(a, 0, h, pid);
    const uint4* vp = reinterpret_cast<const uint4*>(
        reinterpret_cast<const TKV*>(a.pool) + page_offset(a, 1, h, pid));
    for (int w = threadIdx.x; w < row_vecs; w += kThreads)
      reinterpret_cast<uint4*>(sv)[w] = vp[w];
    if (a.scales != nullptr) stage_scales(a, h, pid, sck, scv);

    // scores: `keys` keys per warp step, a key's dot over its lanes
    for (int j0 = warp * keys; j0 < page; j0 += kWarps * keys) {
      const int j = j0 + lane / lanes;
      float kv[E];
      if (j < page) {
        const uint4 raw =
            reinterpret_cast<const uint4*>(kp + static_cast<size_t>(j) * D)
                [sub];
        const TKV* vals = reinterpret_cast<const TKV*>(&raw);
#pragma unroll
        for (int e = 0; e < E; ++e) kv[e] = to_f32(vals[e]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kv[e] = 0.f;
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < G) {                        // G is uniform: no divergence
          const float* qr = sq + r * D + sub * E;
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) s = fmaf(qr[e], kv[e], s);
          for (int o = lanes / 2; o > 0; o >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, o);
          if (j < page && sub == 0) sp[r * page + j] = s;
        }
      }
    }
    __syncthreads();
    softmax_page(a, sp, sck, scv, sm, sl, salpha, qpos, G, i * page,
                 seq_len);
    __syncthreads();

    // acc = acc * alpha + p . v, a thread per (query head, lane of D)
#pragma unroll
    for (int k = 0; k < kMaxOut; ++k) {
      const int o = threadIdx.x + k * kThreads;
      if (o < G * D) {
        const int g = o / D, d = o - g * D;
        const float* pg = sp + g * page;
        float s = acc[k] * salpha[g];
        for (int j = 0; j < page; ++j)
          s = fmaf(pg[j], to_f32(sv[j * D + d]), s);
        acc[k] = s;
      }
    }
    __syncthreads();    // the next page overwrites sv and sp
  }
#pragma unroll
  for (int k = 0; k < kMaxOut; ++k) {
    const int o = threadIdx.x + k * kThreads;
    if (o < G * D) {
      const float l = sl[o / D];
      out[(static_cast<size_t>(b) * H + h * G) * D + o] =
          from_f32<TQ>(acc[k] / (l == 0.f ? 1.f : l));
    }
  }
}

template <typename TQ, typename TKV>
cudaError_t launch_grouped(const Args& a, const void* q, void* out,
                           float* part_acc, float* part_ml,
                           const int* seq_lens, int B, int H, int J,
                           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<TKV, kDecodeRows>(a.D, a.page);
  auto kernel = decode_grouped_kernel<TQ, TKV>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const int n_groups = (a.mp + J - 1) / J;
  kernel<<<dim3(B * a.KH, n_groups), kThreads, smem, stream>>>(
      a, static_cast<const TQ*>(q), part_acc, part_ml, seq_lens, H, J, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<TQ><<<dim3(B * a.KH, H / a.KH), kThreads, 0, stream>>>(
      a, part_acc, part_ml, static_cast<TQ*>(out), seq_lens, H, J, n_groups);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_packed(const Args& a, const void* q, void* out,
                          const int* seq_lens, int B, int H, float scale,
                          cudaStream_t stream) {
  const size_t smem = packed_smem_bytes<TKV>(a.D, a.page);
  auto kernel = decode_packed_kernel<TQ, TKV>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * a.KH, kThreads, smem, stream>>>(
      a, static_cast<const TQ*>(q), static_cast<TQ*>(out), seq_lens, H,
      scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t launch_batched(const Args& a, const void* q, void* out,
                           const int* seq_lens, int* next, int B, int H,
                           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<TKV, kDecodeRows>(a.D, a.page);
  auto kernel = decode_batched_kernel<TQ, TKV>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(next, 0, sizeof(int), stream);
  if (err != cudaSuccess) return err;
  const int blocks = sms < B * a.KH ? sms : B * a.KH;
  kernel<<<blocks, kThreads, smem, stream>>>(
      a, static_cast<const TQ*>(q), static_cast<TQ*>(out), seq_lens, next, B,
      H, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pbt_paged_attention_decode_grouped(
    const void* q, void* out, const void* pool, const float* scales,
    const int* block_tables, const int* seq_lens, float* part_acc,
    float* part_ml, int B, int H, int KH, int D, int P, int page, int mp,
    int layer, long long scale_stride, int J, float scale, float softcap,
    int window, int q_dtype, int kv_dtype, void* stream) {
  if (D > kThreads * kMaxDPerThread || H % KH != 0 ||
      H / KH > kDecodeRows || J < 1)
    return cudaErrorInvalidValue;
  const Args a{static_cast<const uint8_t*>(pool), scales, block_tables, KH,
               D, P, page, mp, layer, scale_stride, softcap, window};
  auto run = [&]() -> cudaError_t {
    PBT_DISPATCH(launch_grouped, a, q, out, part_acc, part_ml, seq_lens, B,
                 H, J, scale, static_cast<cudaStream_t>(stream));
  };
  return static_cast<int>(run());
}

extern "C" int pbt_paged_attention_decode_packed(
    const void* q, void* out, const void* pool, const float* scales,
    const int* block_tables, const int* seq_lens, int B, int H, int KH,
    int D, int P, int page, int mp, int layer, long long scale_stride,
    float scale, float softcap, int window, int q_dtype, int kv_dtype,
    void* stream) {
  const int row = D * (kv_dtype == 0 ? 4 : kv_dtype == 1 ? 2 : 1);
  const int lanes = row / 16;       // a power of two: shuffles stay in a key
  if (row % 16 != 0 || row > 512 || (lanes & (lanes - 1)) != 0 ||
      H % KH != 0 || H / KH > kDecodeRows || (H / KH) * D > kMaxOut * kThreads)
    return cudaErrorInvalidValue;
  const Args a{static_cast<const uint8_t*>(pool), scales, block_tables, KH,
               D, P, page, mp, layer, scale_stride, softcap, window};
  auto run = [&]() -> cudaError_t {
    PBT_DISPATCH(launch_packed, a, q, out, seq_lens, B, H, scale,
                 static_cast<cudaStream_t>(stream));
  };
  return static_cast<int>(run());
}

extern "C" int pbt_paged_attention_decode_batched(
    const void* q, void* out, const void* pool, const float* scales,
    const int* block_tables, const int* seq_lens, int* next, int B, int H,
    int KH, int D, int P, int page, int mp, int layer,
    long long scale_stride, float scale, float softcap, int window,
    int q_dtype, int kv_dtype, void* stream) {
  if (D > kThreads * kMaxDPerThread || H % KH != 0 ||
      H / KH > kDecodeRows)
    return cudaErrorInvalidValue;
  const Args a{static_cast<const uint8_t*>(pool), scales, block_tables, KH,
               D, P, page, mp, layer, scale_stride, softcap, window};
  auto run = [&]() -> cudaError_t {
    PBT_DISPATCH(launch_batched, a, q, out, seq_lens, next, B, H, scale,
                 static_cast<cudaStream_t>(stream));
  };
  return static_cast<int>(run());
}
