// Building blocks of the paged-attention kernels over the
// [L, 2, KH, P, page, D] KV pool: the geometry (Args) and the decode page
// range every kernel uses, and the page step of B1's SIMT kernel and B9
// (paged_attention.cu) and B8 (paged_decode.cu). B2, B6 and B7 run the
// split-KV body of split_decode.cuh.
//
// The fold order is the JAX reference's (paged_attention.py:104-131): per
// page, scores s = (q * scale) . k in f32; times the page's INT8 K scale;
// tanh softcap; mask with -1e30 (key <= q_pos, key < seq_len, key > q_pos -
// window); online softmax updates m and l; only then the INT8 V scale
// multiplies p, and acc = acc * alpha + p . v. Finalize divides by l with
// the l == 0 -> 1 guard, so query rows that see no key come out as zeros.

#pragma once

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
  const int stride = kv_stride<TKV>(D);
  const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
  uint32_t* d = reinterpret_cast<uint32_t*>(dst);
  for (int w = threadIdx.x; w < page * words; w += kThreads) {
    const int j = w / words;
    d[j * (stride / 4) + w - j * words] = s[w];
  }
}

// Geometry and options shared by the kernels.
struct Args {
  const uint8_t* pool;   // [L, 2, KH, P, page, D] of TKV
  const float* scales;   // [L, 2, KH, scale_stride] or null (not INT8)
  const int* block_tables;  // [B, mp]
  int KH, D, P, page, mp, layer;
  long long scale_stride;
  float softcap;
  int window;
};

// Element offset of page `pid` of K (kv = 0) or V (kv = 1), KV head h.
__device__ __forceinline__ size_t page_offset(const Args& a, int kv, int h,
                                              int pid) {
  return ((((static_cast<size_t>(a.layer) * 2 + kv) * a.KH + h) * a.P) +
          pid) * static_cast<size_t>(a.page) * a.D;
}

// Copies page `pid`'s K and V scales of KV head h into sck / scv.
__device__ __forceinline__ void stage_scales(const Args& a, int h, int pid,
                                             float* sck, float* scv) {
  const long long slot0 = static_cast<long long>(pid) * a.page;
  const float* sk = a.scales +
      ((static_cast<long long>(a.layer) * 2 + 0) * a.KH + h) *
          a.scale_stride + slot0;
  const float* sv = a.scales +
      ((static_cast<long long>(a.layer) * 2 + 1) * a.KH + h) *
          a.scale_stride + slot0;
  for (int j = threadIdx.x; j < a.page; j += kThreads) {
    sck[j] = sk[j];
    scv[j] = sv[j];
  }
}

// The online-softmax step over one page's scores p [nrows, page] (keys
// start .. start + page - 1), one warp per row: K scale, softcap and mask
// on the scores, m and l updated, alpha = exp(m_old - m_new) for the
// accumulator, and p turned into probabilities times the V scale.
__device__ void softmax_page(const Args& a, float* p, const float* sck,
                             const float* scv, float* m, float* l,
                             float* alpha, const int* qpos, int nrows,
                             int start, int seq_len) {
  const bool quantized = a.scales != nullptr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < nrows; r += kWarps) {
    const int qp = qpos[r];
    float* pr = p + r * a.page;
    float mblk = kNegBig;
    for (int j = lane; j < a.page; j += 32) {
      float s = pr[j];
      if (quantized) s *= sck[j];
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
    const float mprev = m[r];
    const float mnew = fmaxf(mprev, mblk);
    float sum = 0.f;
    for (int j = lane; j < a.page; j += 32) {
      const int key = start + j;
      bool vis = key <= qp && key < seq_len;
      if (a.window > 0) vis = vis && key > qp - a.window;
      float pj = vis ? expf(pr[j] - mnew) : 0.f;
      sum += pj;
      if (quantized) pj *= scv[j];
      pr[j] = pj;
    }
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      const float al = expf(mprev - mnew);
      alpha[r] = al;
      l[r] = al * l[r] + sum;
      m[r] = mnew;
    }
  }
}

// One online-softmax step of `nrows` query rows over page `i` of
// sequence `b`, KV head `h`. Row r sits at absolute position qpos[r].
template <typename TKV, int ROWS>
__device__ void attend_page(const Args& a, Tile<TKV, ROWS>& t,
                            const int* qpos, int nrows, int b, int h, int i,
                            int seq_len, float (&acc)[ROWS][kMaxDPerThread]) {
  const int D = a.D, page = a.page;
  const int pid = a.block_tables[static_cast<long long>(b) * a.mp + i];
  stage_page<TKV>(t.k, a.pool + page_offset(a, 0, h, pid) * sizeof(TKV), D,
                  page);
  stage_page<TKV>(t.v, a.pool + page_offset(a, 1, h, pid) * sizeof(TKV), D,
                  page);
  if (a.scales != nullptr) stage_scales(a, h, pid, t.sck, t.scv);
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
  softmax_page(a, t.p, t.sck, t.scv, t.m, t.l, t.alpha, qpos, nrows,
               i * page, seq_len);
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

// The decode pages of a sequence: [first, n_pages), where first is the
// page of the window's first visible key (key > seq_len - 1 - window).
__device__ __forceinline__ int first_decode_page(const Args& a, int seq_len) {
  return a.window > 0 ? max(seq_len - a.window, 0) / a.page : 0;
}
__device__ __forceinline__ int decode_pages(const Args& a, int seq_len) {
  return min((seq_len + a.page - 1) / a.page, a.mp);
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

}  // namespace

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
