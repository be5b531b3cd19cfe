// Paged attention over the [L, 2, KH, P, page, D] KV pool, for Hopper.
//
// Three kernels, one per Pallas kernel of the JAX package they replace:
//
//   pbt_paged_attention         <- ops/paged_attention.py::paged_attention
//                                  (_kernel / _attend): a T >= 1 query chunk
//                                  (chunked prefill, the speculative verify
//                                  chunk), causal by absolute position.
//   pbt_paged_attention_decode  <- ops/paged_attention.py::
//                                  paged_attention_decode (_decode_kernel):
//                                  T = 1, mask key < seq_len.
//   pbt_paged_attention_decode_append
//                               <- ops/paged_attention.py::
//                                  paged_attention_decode_append
//                                  (_decode_append_kernel): T = 1 with the
//                                  KV append fused in, one launch per layer
//                                  in place of the append's and B2's.
//
// What they compute (the order of paged_attention.py:104-131, kept so the
// result matches the reference to f32 rounding): per page, scores
// s = (q * scale) . k in f32; times the page's INT8 K scale; tanh softcap;
// mask with -1e30 (key <= q_pos, key < seq_len, key > q_pos - window);
// online softmax updates m and l; only then the INT8 V scale multiplies
// p, and acc = acc * alpha + p . v. Finalize divides by l with the
// l == 0 -> 1 guard, so query rows that see no key come out as zeros.
//
// What bounds them on the H100: at the slice's shapes (page 64, dh 128,
// INT8 pool, <= 2 pages per sequence) both are tiny. Decode reads each
// sequence's K/V pages once (~33 KB per (sequence, KV head)), far below
// what keeps 3.35 TB/s busy, so launch latency and the serial page loop
// dominate; prefill does 2*64*64*128 f32 multiply-adds per row tile, below
// the CUDA cores' rate. Design: no tensor cores and no async copies yet
// (wgmma/TMA are for a later change). One block of 128 threads per
// (sequence, KV head, tile of query rows t*G+g); the block loops over its
// sequence's block table (the TPU's sequential page grid axis) and stops
// at the causal / seq_len / window limit. Each page's K and V rows are
// staged in shared memory with a 4-byte row pad, so the score loop (one
// thread per (row, key) pair, reading a K row across d) hits distinct
// banks; the page's K and V scales ride along. The P.V product keeps the
// accumulator in registers, one thread per output lane d.
//
// The fused decode append is B2's block with one more online-softmax step
// for the new token, whose K/V row comes from the new rows (never read
// back from the pool) and is stored by the same block after its page
// reads. Its bound is B2's bytes plus B3's; what it saves is one launch
// per layer, which is the cost that matters while decode is host-bound.
// The TPU kernel's tail-slab read-modify-write and its scales-slab
// patching for every sequence (paged_attention.py:1318-1347) have no
// counterpart: each row and each scale is a plain store of its own.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDPerThread = 2;       // head dim D <= 256
constexpr int kPrefillRows = 16;        // query rows (t*G+g) per block
constexpr int kDecodeRows = 8;          // decode: the G <= 8 heads of a group
constexpr float kNegBig = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// Bytes of one staged K (or V) row: D elements plus a 4-byte pad.
template <typename TKV>
__host__ __device__ __forceinline__ int kv_stride(int D) {
  return D * static_cast<int>(sizeof(TKV)) + 4;
}

// Dynamic shared memory of one block, in the order the kernels carve it.
template <typename TKV, int ROWS>
__host__ __device__ size_t smem_bytes(int D, int page) {
  size_t n = 0;
  n += align16(sizeof(float) * ROWS * D);         // q rows, pre-scaled
  n += align16(sizeof(float) * ROWS * page);      // scores, then probs
  n += align16(sizeof(float) * page) * 2;         // K and V scales
  n += align16(sizeof(float) * ROWS) * 3;         // m, l, alpha
  n += align16(static_cast<size_t>(kv_stride<TKV>(D)) * page) * 2;  // K, V
  return n;
}

template <typename TKV, int ROWS>
struct Tile {
  float* q;      // [ROWS, D]
  float* p;      // [ROWS, page]
  float* sck;    // [page]
  float* scv;    // [page]
  float* m;      // [ROWS]
  float* l;      // [ROWS]
  float* alpha;  // [ROWS]
  uint8_t* k;    // [page, kv_stride]
  uint8_t* v;    // [page, kv_stride]

  __device__ Tile(uint8_t* base, int D, int page) {
    q = reinterpret_cast<float*>(base);
    base += align16(sizeof(float) * ROWS * D);
    p = reinterpret_cast<float*>(base);
    base += align16(sizeof(float) * ROWS * page);
    sck = reinterpret_cast<float*>(base);
    base += align16(sizeof(float) * page);
    scv = reinterpret_cast<float*>(base);
    base += align16(sizeof(float) * page);
    m = reinterpret_cast<float*>(base);
    base += align16(sizeof(float) * ROWS);
    l = reinterpret_cast<float*>(base);
    base += align16(sizeof(float) * ROWS);
    alpha = reinterpret_cast<float*>(base);
    base += align16(sizeof(float) * ROWS);
    k = base;
    base += align16(static_cast<size_t>(kv_stride<TKV>(D)) * page);
    v = base;
  }
};

// Copies one page ([page, D] contiguous in the pool) into a padded
// shared-memory tile, 4 bytes per thread per step (D * sizeof(TKV) is a
// multiple of 4, checked on the host).
template <typename TKV>
__device__ void stage_page(uint8_t* dst, const uint8_t* src, int D,
                           int page) {
  const int words = D * static_cast<int>(sizeof(TKV)) / 4;
  const int stride = kv_stride<TKV>(D) / 4;
  const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
  uint32_t* d = reinterpret_cast<uint32_t*>(dst);
  for (int w = threadIdx.x; w < page * words; w += kThreads) {
    const int j = w / words;
    const int c = w - j * words;
    d[j * stride + c] = s[w];
  }
}

// Geometry and options shared by both kernels.
struct Args {
  const uint8_t* pool;   // [L, 2, KH, P, page, D] of TKV
  const float* scales;   // [L, 2, KH, scale_stride] or null (not INT8)
  const int* block_tables;  // [B, mp]
  int KH, D, P, page, mp, layer;
  long long scale_stride;
  float softcap;
  int window;
};

// One online-softmax step of `nrows` query rows over page `i` of
// sequence `b`, KV head `h`. Row r sits at absolute position qpos[r].
template <typename TKV, int ROWS>
__device__ void attend_page(const Args& a, Tile<TKV, ROWS>& t,
                            const int* qpos, int nrows, int b, int h, int i,
                            int seq_len, float (&acc)[ROWS][kMaxDPerThread]) {
  const int D = a.D, page = a.page;
  const int pid = a.block_tables[static_cast<long long>(b) * a.mp + i];
  const size_t page_elems = static_cast<size_t>(page) * D;
  const size_t k_off =
      ((((static_cast<size_t>(a.layer) * 2 + 0) * a.KH + h) * a.P) + pid) *
      page_elems;
  const size_t v_off =
      ((((static_cast<size_t>(a.layer) * 2 + 1) * a.KH + h) * a.P) + pid) *
      page_elems;
  stage_page<TKV>(t.k, a.pool + k_off * sizeof(TKV), D, page);
  stage_page<TKV>(t.v, a.pool + v_off * sizeof(TKV), D, page);
  const bool quantized = a.scales != nullptr;
  if (quantized) {
    const long long slot0 = static_cast<long long>(pid) * page;
    const float* sk =
        a.scales + ((static_cast<long long>(a.layer) * 2 + 0) * a.KH + h) *
                       a.scale_stride + slot0;
    const float* sv =
        a.scales + ((static_cast<long long>(a.layer) * 2 + 1) * a.KH + h) *
                       a.scale_stride + slot0;
    for (int j = threadIdx.x; j < page; j += kThreads) {
      t.sck[j] = sk[j];
      t.scv[j] = sv[j];
    }
  }
  __syncthreads();

  // scores: one thread per (row, key)
  const int kst = kv_stride<TKV>(D);
  for (int idx = threadIdx.x; idx < nrows * page; idx += kThreads) {
    const int r = idx / page;
    const int j = idx - r * page;
    const float* qr = t.q + r * D;
    const TKV* kr = reinterpret_cast<const TKV*>(t.k + j * kst);
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(qr[d], to_f32(kr[d]), s);
    t.p[r * page + j] = s;
  }
  __syncthreads();

  // online softmax: one warp per row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int start = i * page;
  for (int r = warp; r < nrows; r += kWarps) {
    const int qp = qpos[r];
    float* pr = t.p + r * page;
    float mblk = kNegBig;
    for (int j = lane; j < page; j += 32) {
      float s = pr[j];
      if (quantized) s *= t.sck[j];
      if (a.softcap > 0.f) s = a.softcap * tanhf(s / a.softcap);
      const int key = start + j;
      bool vis = key <= qp && key < seq_len;
      if (a.window > 0) vis = vis && key > qp - a.window;
      s = vis ? s : kNegBig;
      pr[j] = s;
      mblk = fmaxf(mblk, s);
    }
    for (int o = 16; o > 0; o >>= 1)
      mblk = fmaxf(mblk, __shfl_xor_sync(0xffffffffu, mblk, o));
    const float mprev = t.m[r];
    const float mnew = fmaxf(mprev, mblk);
    float sum = 0.f;
    for (int j = lane; j < page; j += 32) {
      const int key = start + j;
      bool vis = key <= qp && key < seq_len;
      if (a.window > 0) vis = vis && key > qp - a.window;
      float pj = vis ? expf(pr[j] - mnew) : 0.f;
      sum += pj;
      if (quantized) pj *= t.scv[j];
      pr[j] = pj;
    }
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      const float al = expf(mprev - mnew);
      t.alpha[r] = al;
      t.l[r] = al * t.l[r] + sum;
      t.m[r] = mnew;
    }
  }
  __syncthreads();

  // acc = acc * alpha + p . v, one thread per output lane d
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r < nrows) {
      const float al = t.alpha[r];
#pragma unroll
      for (int c = 0; c < kMaxDPerThread; ++c) acc[r][c] *= al;
    }
  }
  for (int j = 0; j < page; ++j) {
    const TKV* vr = reinterpret_cast<const TKV*>(t.v + j * kst);
    float vv[kMaxDPerThread];
#pragma unroll
    for (int c = 0; c < kMaxDPerThread; ++c) {
      const int d = threadIdx.x + c * kThreads;
      vv[c] = d < D ? to_f32(vr[d]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r < nrows) {
        const float pj = t.p[r * page + j];
#pragma unroll
        for (int c = 0; c < kMaxDPerThread; ++c)
          acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
      }
    }
  }
  __syncthreads();  // the next page overwrites the tiles
}

// Loads the block's query rows (pre-scaled, f32) and resets m and l.
// Row r of the block is q row r0 + r = t*G + g, i.e. q[b, t, h*G + g].
template <typename TQ, typename TKV, int ROWS>
__device__ void load_rows(Tile<TKV, ROWS>& t, const TQ* q, int b, int h,
                          int r0, int nrows, int T, int H, int G, int D,
                          float scale) {
  for (int idx = threadIdx.x; idx < nrows * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int rg = r0 + r;
    const int tok = rg / G, g = rg - tok * G;
    const size_t off =
        ((static_cast<size_t>(b) * T + tok) * H + h * G + g) * D + d;
    t.q[r * D + d] = to_f32(q[off]) * scale;
  }
  for (int r = threadIdx.x; r < ROWS; r += kThreads) {
    t.m[r] = kNegBig;
    t.l[r] = 0.f;
  }
  __syncthreads();
}

template <typename TQ, typename TKV, int ROWS>
__device__ void store_rows(const Tile<TKV, ROWS>& t, TQ* out, int b, int h,
                           int r0, int nrows, int T, int H, int G, int D,
                           const float (&acc)[ROWS][kMaxDPerThread]) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r < nrows) {
      const float l = t.l[r];
      const float inv = 1.f / (l == 0.f ? 1.f : l);
      const int rg = r0 + r;
      const int tok = rg / G, g = rg - tok * G;
      const size_t base =
          ((static_cast<size_t>(b) * T + tok) * H + h * G + g) * D;
#pragma unroll
      for (int c = 0; c < kMaxDPerThread; ++c) {
        const int d = threadIdx.x + c * kThreads;
        if (d < D) out[base + d] = from_f32<TQ>(acc[r][c] * inv);
      }
    }
  }
}

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

// grid (B * KH); block kThreads; rows = the G query heads of KV head h
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
paged_attention_decode_kernel(Args a, const TQ* __restrict__ q,
                              TQ* __restrict__ out,
                              const int* __restrict__ seq_lens, int H,
                              float scale) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int ROWS = kDecodeRows;
  const int b = blockIdx.x / a.KH, h = blockIdx.x % a.KH;
  const int G = H / a.KH;
  Tile<TKV, ROWS> t(smem, a.D, a.page);
  load_rows<TQ, TKV, ROWS>(t, q, b, h, 0, G, 1, H, G, a.D, scale);

  const int seq_len = seq_lens[b];
  int qpos[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) qpos[r] = seq_len - 1;
  const int first =
      a.window > 0 ? max(seq_len - a.window, 0) / a.page : 0;
  const int n_pages = min((seq_len + a.page - 1) / a.page, a.mp);

  float acc[ROWS][kMaxDPerThread] = {};
  for (int i = first; i < n_pages; ++i)
    attend_page<TKV, ROWS>(a, t, qpos, G, b, h, i, seq_len, acc);
  store_rows<TQ, TKV, ROWS>(t, out, b, h, 0, G, 1, H, G, a.D, acc);
}

// grid (B * KH); block kThreads; rows = the G query heads of KV head h.
// B2's kernel over the keys already cached (key < seq_len - 1, read from
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

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  if (smem > 232448) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
  return cudaSuccess;
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

template <typename TQ, typename TKV>
cudaError_t launch_decode(const Args& a, const void* q, void* out,
                          const int* seq_lens, int B, int H, float scale,
                          cudaStream_t stream) {
  const size_t smem = smem_bytes<TKV, kDecodeRows>(a.D, a.page);
  auto kernel = paged_attention_decode_kernel<TQ, TKV>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * a.KH, kThreads, smem, stream>>>(
      a, static_cast<const TQ*>(q), static_cast<TQ*>(out), seq_lens, H,
      scale);
  return cudaGetLastError();
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

// dtype codes shared with the Python wrappers: 0 float32, 1 bfloat16, 2 int8
#define PBT_DISPATCH(FN, ...)                                              \
  do {                                                                     \
    if (q_dtype == 0 && kv_dtype == 0) return FN<float, float>(__VA_ARGS__); \
    if (q_dtype == 0 && kv_dtype == 1)                                     \
      return FN<float, __nv_bfloat16>(__VA_ARGS__);                        \
    if (q_dtype == 0 && kv_dtype == 2) return FN<float, int8_t>(__VA_ARGS__); \
    if (q_dtype == 1 && kv_dtype == 0)                                     \
      return FN<__nv_bfloat16, float>(__VA_ARGS__);                        \
    if (q_dtype == 1 && kv_dtype == 1)                                     \
      return FN<__nv_bfloat16, __nv_bfloat16>(__VA_ARGS__);                \
    if (q_dtype == 1 && kv_dtype == 2)                                     \
      return FN<__nv_bfloat16, int8_t>(__VA_ARGS__);                       \
    return cudaErrorInvalidValue;                                          \
  } while (0)

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

extern "C" int pbt_paged_attention_decode(
    const void* q, void* out, const void* pool, const float* scales,
    const int* block_tables, const int* seq_lens, int B, int H, int KH,
    int D, int P, int page, int mp, int layer, long long scale_stride,
    float scale, float softcap, int window, int q_dtype, int kv_dtype,
    void* stream) {
  if (D > kThreads * kMaxDPerThread || H % KH != 0 ||
      H / KH > kDecodeRows)
    return cudaErrorInvalidValue;
  const Args a{static_cast<const uint8_t*>(pool), scales, block_tables, KH,
               D, P, page, mp, layer, scale_stride, softcap, window};
  auto run = [&]() -> cudaError_t {
    PBT_DISPATCH(launch_decode, a, q, out, seq_lens, B, H, scale,
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
