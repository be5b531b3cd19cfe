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
// it, never arithmetic. With G <= 8 query rows a KV head, a 64-row wgmma
// would be 88-98% padding, so the design spends the card on parallelism
// and overlap instead of tensor cores:
// * Split-KV. The grid is (sequence, KV head, split of the block table):
//   the wrapper picks the splits from B, KH and the table width so the
//   grid fills about two waves of 132 SMs, at least one page a split
//   (ops/paged_attention.py::decode_split_plan). Each split writes its
//   partial (m, l, acc) for the G rows to an f32 workspace; the last
//   block of a (sequence, KV head) to finish (a counter it resets
//   itself, keyed by device and stream on the host as B10's are) merges
//   them in split order, in the same launch: one launch per layer, and
//   the same output from run to run. A split with no visible page still
//   writes (m = -1e30, l = 0, acc = 0) and counts toward the merge.
// * Pages by bulk copy. A copy warp brings each page's K and V (one
//   contiguous [page, D] run each in the pool) and an aligned run of
//   their INT8 scales with cp.async.bulk into a ring of up to four stages
//   under full / empty mbarriers, so page i + 1 lands while page i is
//   computed.
// * No block-wide barrier per page. Each of the four compute warps takes
//   16 keys of every 64 with its own online softmax (m, l) and P.V
//   accumulator in registers: eight lanes a key, each lane a 16-byte
//   chunk of the K row (a quarter-warp reads one whole row, no bank
//   conflict) against q rows kept in shared memory in the same lane
//   order; shuffles sum the eight parts; the probabilities go through a
//   per-warp buffer to P.V, where each lane owns four values of d a run
//   of 128. The warps' results merge once, at the end of the split.
// The fold order is the reference's per key (the K scale, the softcap,
// the mask, then m, l, and the V scale on p); only the grouping of the
// online softmax (16 keys a step, then warps, then splits) differs, which
// moves the sums' order and nothing else.
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

// -- B2: split-KV decode ----------------------------------------------------

constexpr int kSplitWarps = 4;                    // compute warps
constexpr int kSplitThreads = 32 * kSplitWarps + 32;  // + the copy warp
constexpr int kMaxStages = 4;                     // pages in flight at most
constexpr int kMaxSplits = 64;                    // splits of a key range
constexpr int kKeyBlock = 16;  // keys a warp takes a step: 4 groups x 4
// a block's shared memory less 1 KB for the static is_last and the
// system's per-block reserve
constexpr int kSplitSmem = 232448 - 1024;

// Shared memory of decode_split_kernel (the host sizes it with the same
// function): q rows (f32, pre-scaled, in the lane order the scores read),
// each warp's probabilities of its key block, the page ring (K, V and
// their INT8 scales a stage; the warps' partial results over it at the
// end), the combine's split weights, and the ring's barriers.
struct SplitLay {
  int kv_bytes, sc_bytes, stage_bytes;
  int q_off, p_off, stage_off, w_off, bar_off, bytes;
};

__host__ __device__ inline SplitLay split_lay(int D, int es, int page,
                                              bool quant, int rows,
                                              int stages) {
  SplitLay l;
  l.kv_bytes = static_cast<int>(align16(static_cast<size_t>(page) * D * es));
  // an aligned run of the pool's scales that holds the page's: at most
  // 3 floats before it and 3 after
  l.sc_bytes = quant ? static_cast<int>(align16((page + 8) * 4)) : 0;
  l.stage_bytes = 2 * l.kv_bytes + 2 * l.sc_bytes;
  l.q_off = 0;
  l.p_off = l.q_off + rows * D * 4;
  l.stage_off = l.p_off + kSplitWarps * kKeyBlock * rows * 4;
  const int combine = kSplitWarps * rows * (D + 2) * 4;
  const int ring = stages * l.stage_bytes;
  l.w_off = l.stage_off + (ring > combine ? ring : combine);
  l.bar_off = l.w_off + static_cast<int>(align16((kMaxSplits + 1) * rows * 4));
  l.bytes = l.bar_off + 2 * kMaxStages * 8;
  return l;
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

// Four consecutive values of a row of T as f32.
template <typename T>
__device__ __forceinline__ void load4(const uint8_t* p, float (&o)[4]) {
  if constexpr (sizeof(T) == 1) {
    chunk4<int8_t>(make_uint4(*reinterpret_cast<const uint32_t*>(p), 0, 0, 0),
                   0, o);
  } else if constexpr (sizeof(T) == 2) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    chunk4<__nv_bfloat16>(make_uint4(w.x, w.y, 0, 0), 0, o);
  } else {
    chunk4<float>(*reinterpret_cast<const uint4*>(p), 0, o);
  }
}

// grid (B * KH, splits); block kSplitThreads; rows = the G <= ROWS query
// heads of KV head h; split blockIdx.y takes the pages [split * pps,
// split * pps + pps) of the sequence's visible ones. Partials: acc [B * KH,
// splits, G, D], (m, l) [.., G, 2]; counters one a (sequence, KV head).
template <typename TQ, typename TKV, int D, int ROWS>
__global__ void __launch_bounds__(kSplitThreads)
decode_split_kernel(Args a, const TQ* __restrict__ q, TQ* __restrict__ out,
                    const int* __restrict__ seq_lens,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int* __restrict__ counters, int H, int pps, int stages,
                    float scale) {
  constexpr int es = sizeof(TKV);
  constexpr int E = 16 / es;   // values a 16-byte chunk
  constexpr int F = E / 4;     // groups of four a chunk
  constexpr int CI = D / E / 8;  // chunks of a K row a lane (8 lanes a key)
  constexpr int DC = D / 128;  // runs of 128 values of d (P.V: 4 a lane)
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int is_last;
  const int bh = blockIdx.x, b = bh / a.KH, h = bh % a.KH;
  const int split = blockIdx.y, splits = gridDim.y;
  const int G = H / a.KH, page = a.page;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool quant = a.scales != nullptr;
  const SplitLay lay = split_lay(D, es, page, quant, ROWS, stages);
  float* const qs = reinterpret_cast<float*>(smem + lay.q_off);
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
  uint64_t* const empty = full + kMaxStages;
  const int seq_len = seq_lens[b];
  const int i0 = max(split * pps, first_decode_page(a, seq_len));
  const int n = max(min(split * pps + pps, decode_pages(a, seq_len)) - i0, 0);
  const int* bt = a.block_tables + static_cast<long long>(b) * a.mp;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 32 * kSplitWarps);
    }
    hop::mbar_fence_init();
  }
  // the G query rows, times the scale, in the order the scores read them:
  // value d of chunk c = d / E sits at float4 (c / 8 * F + d % E / 4) * 8 +
  // c % 8, so the 8 lanes of a key read 128 contiguous bytes
  for (int idx = tid; idx < G * D; idx += kSplitThreads) {
    const int r = idx / D, d = idx - r * D;
    const int c = d / E, e = d % E;
    qs[r * D + ((c / 8 * F + e / 4) * 8 + c % 8) * 4 + e % 4] =
        to_f32(q[(static_cast<size_t>(b) * H + h * G + r) * D + d]) * scale;
  }
  __syncthreads();

  if (warp == kSplitWarps) {
    // the copy warp: page i0 + it's K and V runs (contiguous [page, D] in
    // the pool) and an aligned run of each one's scales into stage it %
    // stages, the first `stages` pages at once, each later one when the
    // compute warps release the stage it reuses
    if (lane == 0) {
      for (int it = 0; it < n; ++it) {
        const int st = it % stages;
        if (it >= stages) hop::mbar_wait(&empty[st], (it / stages - 1) & 1);
        const int pid = bt[i0 + it];
        uint8_t* dst = smem + lay.stage_off + st * lay.stage_bytes;
        const long long s0 = static_cast<long long>(pid) * page;
        const long long a0 = s0 & ~3LL;
        const int nsc = static_cast<int>(((s0 + page + 3) & ~3LL) - a0);
        const uint32_t row = page * D * es;
        hop::mbar_arrive_tx(&full[st], 2 * row + (quant ? 8 * nsc : 0));
        for (int kv = 0; kv < 2; ++kv) {
          hop::bulk_load(dst + kv * lay.kv_bytes,
                         a.pool + page_offset(a, kv, h, pid) * es, row,
                         &full[st]);
          if (quant)
            hop::bulk_load(
                dst + 2 * lay.kv_bytes + kv * lay.sc_bytes,
                a.scales +
                    ((static_cast<long long>(a.layer) * 2 + kv) * a.KH + h) *
                        a.scale_stride + a0,
                4 * nsc, &full[st]);
        }
      }
    }
    return;
  }

  // Compute warp `warp`: in every page, the keys jb + 4 u + kg (u < 4) of
  // each block of 16 at jb = 16 warp + 64 t, key group kg = lane / 8 of 8
  // lanes; its own online softmax (m the same in every lane, l a partial
  // of the lane's key group) and P.V accumulator (lane: values 128 c + 4
  // lane .. + 3 of d), merged with the other warps' at the end.
  const int kg = lane / 8, l8 = lane % 8;
  float* const pw = reinterpret_cast<float*>(smem + lay.p_off) +
                    warp * kKeyBlock * ROWS;
  float m[ROWS], l[ROWS], acc[ROWS][4 * DC];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = kNegBig;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * DC; ++c) acc[r][c] = 0.f;
  }
  const int last = seq_len - 1;  // the query's position
  for (int it = 0; it < n; ++it) {
    const int st = it % stages, i = i0 + it;
    hop::mbar_wait(&full[st], (it / stages) & 1);
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
      for (int ci = 0; ci < CI; ++ci) {
        uint4 raw[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = jb + 4 * u + kg;
          raw[u] = j < page ? *reinterpret_cast<const uint4*>(
                                  kp + j * D * es + (l8 + 8 * ci) * 16)
                            : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int f = 0; f < F; ++f) {
          float kf[4][4];
#pragma unroll
          for (int u = 0; u < 4; ++u) chunk4<TKV>(raw[u], f, kf[u]);
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            if (r < G) {
              const float4 q4 = *reinterpret_cast<const float4*>(
                  qs + r * D + ((ci * F + f) * 8 + l8) * 4);
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                float v = s[u][r];
                v = fmaf(q4.x, kf[u][0], v);
                v = fmaf(q4.y, kf[u][1], v);
                v = fmaf(q4.z, kf[u][2], v);
                v = fmaf(q4.w, kf[u][3], v);
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
        for (int c = 0; c < 4 * DC; ++c) acc[r][c] *= alpha;
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
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int r4 = 0; r4 < ROWS / 4; ++r4)
            *reinterpret_cast<float4*>(pw + (4 * u + kg) * ROWS + 4 * r4) =
                make_float4(s[u][4 * r4], s[u][4 * r4 + 1],
                            s[u][4 * r4 + 2], s[u][4 * r4 + 3]);
      }
      __syncwarp();
      const int nk = min(kKeyBlock, page - jb);
      for (int k = 0; k < nk; ++k) {
        float p[ROWS];
#pragma unroll
        for (int r4 = 0; r4 < ROWS / 4; ++r4) {
          const float4 v = *reinterpret_cast<const float4*>(
              pw + k * ROWS + 4 * r4);
          p[4 * r4] = v.x;
          p[4 * r4 + 1] = v.y;
          p[4 * r4 + 2] = v.z;
          p[4 * r4 + 3] = v.w;
        }
        const uint8_t* vr = vp + (jb + k) * D * es;
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          float vv[4];
          load4<TKV>(vr + (128 * c + 4 * lane) * es, vv);
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[r][4 * c + e] = fmaf(p[r], vv[e], acc[r][4 * c + e]);
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
    for (int c = 0; c < DC; ++c)
      *reinterpret_cast<float4*>(cacc + (warp * ROWS + r) * D + 128 * c +
                                 4 * lane) =
          make_float4(acc[r][4 * c], acc[r][4 * c + 1], acc[r][4 * c + 2],
                      acc[r][4 * c + 3]);
    if (lane == 0) {
      cml[(warp * ROWS + r) * 2] = m[r];
      cml[(warp * ROWS + r) * 2 + 1] = l[r];
    }
  }
  hop::named_sync(1, NT);
  const size_t part = static_cast<size_t>(bh) * splits + split;
  TQ* const orow = out + (static_cast<size_t>(b) * H + h * G) * D;
  for (int r = 0; r < G; ++r) {
    float mx = kNegBig;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w)
      mx = fmaxf(mx, cml[(w * ROWS + r) * 2]);
    float wt[kSplitWarps], lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      wt[w] = expf(cml[(w * ROWS + r) * 2] - mx);
      lsum = fmaf(cml[(w * ROWS + r) * 2 + 1], wt[w], lsum);
    }
    const float inv = 1.f / (lsum == 0.f ? 1.f : lsum);
    for (int d = tid; d < D; d += NT) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kSplitWarps; ++w)
        v = fmaf(cacc[(w * ROWS + r) * D + d], wt[w], v);
      if (splits == 1)
        orow[r * D + d] = from_f32<TQ>(v * inv);
      else
        part_acc[(part * G + r) * D + d] = v;
    }
    if (splits > 1 && tid == 0) {
      part_ml[(part * G + r) * 2] = mx;
      part_ml[(part * G + r) * 2 + 1] = lsum;
    }
  }
  if (splits == 1) return;

  // The last split of (b, h) to finish (a counter it resets itself) merges
  // every split's partial in split order: M = max m_s, w_s = e^(m_s - M),
  // out = sum acc_s w_s / sum l_s w_s (l == 0 -> 1). An empty split (its
  // pages all before the window or past seq_len) left m = -1e30, l = 0,
  // acc = 0, so it weighs nothing unless every split is empty, and then the
  // output is zeros.
  __threadfence();
  hop::named_sync(1, NT);
  if (tid == 0) is_last = atomicAdd(&counters[bh], 1) == splits - 1;
  hop::named_sync(1, NT);
  if (!is_last) return;
  float* const wts = reinterpret_cast<float*>(smem + lay.w_off);  // [s][r]
  float* const invs = wts + kMaxSplits * ROWS;
  const size_t p0 = static_cast<size_t>(bh) * splits;
  if (tid < G) {
    const int r = tid;
    float mx = kNegBig;
    for (int s = 0; s < splits; ++s)
      mx = fmaxf(mx, __ldcg(part_ml + ((p0 + s) * G + r) * 2));
    float lsum = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float w = expf(__ldcg(part_ml + ((p0 + s) * G + r) * 2) - mx);
      wts[s * ROWS + r] = w;
      lsum = fmaf(__ldcg(part_ml + ((p0 + s) * G + r) * 2 + 1), w, lsum);
    }
    invs[r] = 1.f / (lsum == 0.f ? 1.f : lsum);
  }
  hop::named_sync(1, NT);
  for (int r = 0; r < G; ++r) {
    for (int d = tid; d < D; d += NT) {
      float v = 0.f;
      for (int s = 0; s < splits; ++s)
        v = fmaf(__ldcg(part_acc + ((p0 + s) * G + r) * D + d),
                 wts[s * ROWS + r], v);
      orow[r * D + d] = from_f32<TQ>(v * invs[r]);
    }
  }
  if (tid == 0) counters[bh] = 0;
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
  const bool quant = a.scales != nullptr;
  int stages = pps < kMaxStages ? pps : kMaxStages;
  while (stages > 1 &&
         split_lay(D, sizeof(TKV), a.page, quant, ROWS, stages).bytes >
             kSplitSmem)
    --stages;
  const SplitLay lay =
      split_lay(D, sizeof(TKV), a.page, quant, ROWS, stages);
  if (lay.bytes > kSplitSmem) return cudaErrorInvalidValue;
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
                        a, q, out, seq_lens, part_acc, part_ml, counters, B,
                        H, splits, pps, scale, stream)
                  : launch_split<TQ, TKV, 128, 8>(
                        a, q, out, seq_lens, part_acc, part_ml, counters, B,
                        H, splits, pps, scale, stream);
  if (a.D == 256)
    return narrow ? launch_split<TQ, TKV, 256, 4>(
                        a, q, out, seq_lens, part_acc, part_ml, counters, B,
                        H, splits, pps, scale, stream)
                  : launch_split<TQ, TKV, 256, 8>(
                        a, q, out, seq_lens, part_acc, part_ml, counters, B,
                        H, splits, pps, scale, stream);
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
