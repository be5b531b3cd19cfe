// The chained decode megakernel for Hopper: B14 and B15.
//
//   pbt_chain_decode   <- ops/chain_linear.py::chain_decode (_chain_kernel,
//                         _chain_kernel_w8a8), B14: one decoder layer's
//                         post-attention chain for a decode batch,
//                           O -> +residual -> norm -> G|U -> act -> D
//                           -> +residual [-> norm -> T (next layer's qkv)]
//                         in ONE launch.
//   pbt_packed_linear  <- ops/chain_linear.py::packed_linear
//                         (_packed_mm_kernel, _packed_mm_w8a8_kernel), B15:
//                         act(x @ W_op + b) for one op (or the column run
//                         (G, U)) served from the packed blocks, for the
//                         multi-token forwards once the per-op weight
//                         copies are dropped.
//
// The packing (ops/chain_linear.py::pack_chain, the JAX package's bit for
// bit) is read as it is: blocks [G, bk, bn], row-major with leading
// dimension bn, op `op`'s block (n, k) at g0 + n * KB + k; per-column
// scales and biases in sb [2, totN] (op columns from sb0 * bn); the two
// norms in ln [4, Wd]. Weights are int8 (w8a8 or widened), bf16 or f32.
//
// B14. The TPU runs grid=(G,) in order on one core and carries the
// activations in VMEM from block to block. Here one cooperative launch
// (cudaLaunchCooperativeKernel: every block resident, or the launch is
// refused) runs the chain as phases separated by grid-wide barriers:
//
//   rows:   residual <- x (f32); attention input (w8a8: quantized per row)
//   O:      tasks over (column tile, K split, row group); residual += y
//   rows:   norm after O -> h (rounded to the activation type, or
//           quantized per row)
//   G, U:   tasks; raw f32 gate and up
//   rows:   activation (SwiGLU (g * sigmoid(g)) * u, GELU or ReLU, zero
//           past I) -> act (rounded, or quantized per row)
//   D:      tasks; residual += y, x_out = residual rounded once
//   rows:   norm after D -> h                               (with a tail)
//   T:      tasks; tail = y rounded                         (with a tail)
//
// A task is 128 output columns by 4 batch rows over S rows of K (S divides
// bk and is a multiple of 128; the wrapper splits K only until a phase has
// a task per SM). Its 256 threads are 8 column
// chunks of 16 columns times 32 k-lanes, each k-lane reading 4 rows of
// the block per step with one 16-byte load per row per 16 bytes of
// weights (qmatmul.cuh's gemv: __byte_perm + __dp4a for s8 x s8, the
// exponent trick to widen int8, bf16 as its high half). The k-lanes reduce
// by shuffles and shared memory in a fixed order. Where K is split, each
// task writes its partial sums (s32 under w8a8, so they stay exact) to the
// workspace, and the last task of a column tile to arrive (a counter per
// tile, reset by that task) adds the splits in order and runs the
// epilogue: deterministic. The row phases (norms, row quantization, the
// activation) need whole rows: one block per batch row, 4 columns a
// thread a step, block reductions in a fixed order. The residual, h, gate, up and act rows (L2-sized:
// 4 x 14336 f32 is 229 KB) live in a workspace the wrapper allocates;
// everything the kernel writes is read back through L2 (__ldcg), never a
// stale L1 line.
//
// Rounding points are the chain's: the residual stays f32 from entry to
// x_out; h and act are rounded to the activation type (or re-quantized per
// row: absmax * (1/127), x / scale rounded half to even, clamped to 127);
// the epilogue is (f32(acc) * x_scale) then one fused multiply-add with
// the column scale and bias (for dense weights the scale is 1, so it is
// acc + bias). Norms use correctly rounded division and square roots.
//
// What bounds B14 on the H100: its weight bytes, read once (Llama-3-8B
// w8a8: 218 MB a layer, 0.065 ms at 3.35 TB/s). The barriers and the row
// phases between the matmul phases are the overhead this simple version
// carries; the TPU kernel's point (no drain of the weight stream between
// ops) is kept within each phase only.
//
// B15 under w8a8 (every chain a card path packs) is imma.cuh's INT8
// tensor-core kernel reading the packed blocks through a 3-D tensor map
// over [G, bk, bn] (a 128 x 128 weight tile never straddles a block,
// since bk and bn are multiples of 128): each raw tile is transposed on
// chip to the K-major layout wgmma's s8 product reads, with K split where
// the output tiles fall short of the SMs. At prefill (M = 256) a
// Llama-3-8B layer's four calls are bound by the weight stream and the
// tensor cores alike (218 MB, 112 G integer operations). Chains of
// int8-weight, bf16 or f32 blocks (no card path runs them) take
// packed_kernel, a plain shared-memory tiled product (64 x 64 outputs a
// block, k-tiles of 32 rows, f32 FMA on CUDA cores).
//
// Each entry point returns cudaGetLastError() after its launch.

#include "imma.cuh"
#include "qmatmul.cuh"

namespace chain {

enum WCode { kWF32 = 0, kWBF16 = 1, kWI8 = 2 };
enum ActKind { kSwiglu = 0, kGeluAct = 1, kReluAct = 2 };
enum NormKind { kRms = 0, kLayer = 1 };
enum OpId { kO = 0, kG = 1, kU = 2, kD = 3, kT = 4 };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = 128;        // columns of a task
constexpr int kRows = 4;           // batch rows of a task
constexpr int kChunks = 8;         // column chunks of a task
constexpr int kChunkCols = 16;     // columns of a chunk
constexpr int kKLanes = kThreads / kChunks;  // 32
constexpr int kQuad = 4;           // rows of a k-lane step
constexpr int kMaxS = 1024;        // rows of K a task stages at most
constexpr int kMaxOps = 5;
constexpr int kRegions = 8;

struct Op {
  int id, g0, KB, NB, K, N, sb0, S;
  int tiles, splits, tasks;
  long long part;  // element offset of its split-K partials
  int ctr;         // its first tile counter
};

struct Args {
  const void* ain;   // [B, K0] activation type
  const void* x;     // [B, D] activation type
  const void* w;     // [G, bk, bn]
  const float* sb;   // [2, totN]
  const float* ln;   // [4, Wd]
  void* x_out;       // [B, D]
  void* tail;        // [B, N3]
  float* xres;       // [Bp, Wd] f32 residual
  void* src_o;       // [Bp, K0p] attention input: f32, or int8 (w8a8)
  void* h;           // [Bp, Wd] normed hidden: f32, or int8
  float* gate;       // [Bp, Wi]
  float* up;         // [Bp, Wi]
  void* act;         // [Bp, Wi] activated mid: f32, or int8
  float* rs;         // [3, Bp] row scales of src_o, h, act (w8a8)
  void* part;        // split-K partials
  unsigned* bar;     // the grid barrier word
  int* ctr;          // tile counters
  int B, Bp, RG, D, I, K0, N3, bk, bn, Wd, Wi, K0p, totN;
  int n_ops;
  Op ops[kMaxOps];
  float eps;
  int act_kind, norm_kind, has_tail;
};

struct __align__(16) Smem {
  union {
    int i[kWarps][kRows][kTileN];
    float f[kWarps][kRows][kTileN];
  } red;
  union {
    float f[kRows][kMaxS];
    int8_t q[kRows][kMaxS];
  } x;
  float warp_part[kWarps];
  float total;
  int is_last;
};

using qmm::store;
using qmm::to_f32;

// f32 value as the activation type holds it
template <typename XT>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (std::is_same<XT, float>::value) {
    return v;
  } else {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
}

// Grid-wide barrier (cooperative groups' scheme): block 0 adds
// 2^31 - (blocks - 1), every other block 1, so the word's top bit flips
// exactly when the last block arrives and its low bits return to their
// value; each block waits for the flip. Safe because the cooperative
// launch makes every block resident.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned nb =
        blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned old = atomicAdd(bar, nb);
    while (((old ^ *static_cast<volatile unsigned*>(bar)) & 0x80000000u) ==
           0) {
      __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// Block-wide sum (max with MAX) in a fixed order: shuffles in a warp,
// then the warps in order. Every thread gets the result.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, Smem& sm) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? fmaxf(v, u) : __fadd_rn(v, u);
  }
  __syncthreads();
  if (threadIdx.x % 32 == 0) sm.warp_part[threadIdx.x / 32] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = sm.warp_part[0];
    for (int w = 1; w < kWarps; ++w)
      t = MAX ? fmaxf(t, sm.warp_part[w]) : __fadd_rn(t, sm.warp_part[w]);
    sm.total = t;
  }
  __syncthreads();
  return sm.total;
}

// Per-row INT8 quantization scale (quant/tensor.py's, as XLA compiles it:
// absmax times the f32 reciprocal of 127) and one value's code.
__device__ __forceinline__ float quant_scale(float absmax) {
  return __fmul_rn(fmaxf(absmax, 1e-8f), 1.0f / 127.0f);
}
__device__ __forceinline__ int8_t quant(float v, float scale) {
  const float q = rintf(__fdiv_rn(v, scale));
  return static_cast<int8_t>(fminf(fmaxf(q, -127.0f), 127.0f));
}

// -- row phases --------------------------------------------------------------
//
// One block a batch row; each thread takes 4 consecutive columns a step
// (row buffers are 16-byte aligned and their widths multiples of 128), so
// its loads are independent and in flight together.

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st_q4(int8_t* p, const float (&v)[4],
                                      float scale) {
  *reinterpret_cast<char4*>(p) = make_char4(
      quant(v[0], scale), quant(v[1], scale), quant(v[2], scale),
      quant(v[3], scale));
}
__device__ __forceinline__ float amax4(float m, const float (&v)[4]) {
  return fmaxf(fmaxf(m, fmaxf(fabsf(v[0]), fabsf(v[1]))),
               fmaxf(fabsf(v[2]), fabsf(v[3])));
}

// residual <- x; attention input -> src_o (f32, or quantized per row)
template <typename XT, bool A8>
__device__ void init_rows(const Args& a, Smem& sm) {
  const XT* x = static_cast<const XT*>(a.x);
  const XT* ain = static_cast<const XT*>(a.ain);
  for (int m = blockIdx.x; m < a.Bp; m += gridDim.x) {
    const bool live = m < a.B;
    const long long rx = static_cast<long long>(m) * a.D;
    const long long ra = static_cast<long long>(m) * a.K0;
    for (int n = 4 * threadIdx.x; n < a.Wd; n += 4 * kThreads) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = live && n + j < a.D ? to_f32(x[rx + n + j]) : 0.0f;
      st4(a.xres + static_cast<long long>(m) * a.Wd + n, v);
    }
    auto ain4 = [&](int n, float (&v)[4]) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = live && n + j < a.K0 ? to_f32(ain[ra + n + j]) : 0.0f;
    };
    const long long ro = static_cast<long long>(m) * a.K0p;
    if constexpr (A8) {
      float amax = 0.0f;
      for (int n = 4 * threadIdx.x; n < a.K0p; n += 4 * kThreads) {
        float v[4];
        ain4(n, v);
        amax = amax4(amax, v);
      }
      const float s = quant_scale(block_reduce<true>(amax, sm));
      for (int n = 4 * threadIdx.x; n < a.K0p; n += 4 * kThreads) {
        float v[4];
        ain4(n, v);
        st_q4(static_cast<int8_t*>(a.src_o) + ro + n, v, s);
      }
      if (threadIdx.x == 0) a.rs[m] = s;
    } else {
      for (int n = 4 * threadIdx.x; n < a.K0p; n += 4 * kThreads) {
        float v[4];
        ain4(n, v);
        st4(static_cast<float*>(a.src_o) + ro + n, v);
      }
    }
  }
}

// The norm of ln rows (which, which + 1) over the residual -> h.
template <typename XT, bool A8>
__device__ void norm_rows(const Args& a, int which, Smem& sm) {
  const float* scale = a.ln + static_cast<long long>(which) * a.Wd;
  const float* bias = scale + a.Wd;
  const float d = static_cast<float>(a.D);
  for (int m = blockIdx.x; m < a.Bp; m += gridDim.x) {
    const float* xr = a.xres + static_cast<long long>(m) * a.Wd;
    const bool live = m < a.B;
    float mean = 0.0f, inv;
    // the residual's columns past D are zero
    if (a.norm_kind == kRms) {
      float ss = 0.0f;
      for (int n = 4 * threadIdx.x; n < a.Wd; n += 4 * kThreads) {
        const float4 v = ld4(xr + n);
        ss = __fmaf_rn(v.x, v.x, ss);
        ss = __fmaf_rn(v.y, v.y, ss);
        ss = __fmaf_rn(v.z, v.z, ss);
        ss = __fmaf_rn(v.w, v.w, ss);
      }
      const float ms = __fdiv_rn(block_reduce<false>(ss, sm), d);
      inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(ms, a.eps)));
    } else {
      float s = 0.0f;
      for (int n = 4 * threadIdx.x; n < a.Wd; n += 4 * kThreads) {
        const float4 v = ld4(xr + n);
        s = __fadd_rn(__fadd_rn(s, v.x), __fadd_rn(v.y, __fadd_rn(v.z, v.w)));
      }
      mean = __fdiv_rn(block_reduce<false>(s, sm), d);
      float ss = 0.0f;
      for (int n = 4 * threadIdx.x; n < a.Wd; n += 4 * kThreads) {
        const float4 v = ld4(xr + n);
        const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float c = n + j < a.D ? __fsub_rn(e[j], mean) : 0.0f;
          ss = __fmaf_rn(c, c, ss);
        }
      }
      const float var = __fdiv_rn(block_reduce<false>(ss, sm), d);
      inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, a.eps)));
    }
    // h = x * inv * scale (+ bias), each product rounded; 0 past D
    auto h4 = [&](int n, float (&h)[4]) {
      const float4 v = ld4(xr + n);
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n + j;
        if (!live || c >= a.D) {
          h[j] = 0.0f;
        } else if (a.norm_kind == kRms) {
          h[j] = __fmul_rn(__fmul_rn(e[j], inv), scale[c]);
        } else {
          h[j] = __fadd_rn(
              __fmul_rn(__fmul_rn(__fsub_rn(e[j], mean), inv), scale[c]),
              bias[c]);
        }
      }
    };
    const long long r = static_cast<long long>(m) * a.Wd;
    if constexpr (A8) {
      float amax = 0.0f;
      for (int n = 4 * threadIdx.x; n < a.Wd; n += 4 * kThreads) {
        float h[4];
        h4(n, h);
        amax = amax4(amax, h);
      }
      const float s = quant_scale(block_reduce<true>(amax, sm));
      for (int n = 4 * threadIdx.x; n < a.Wd; n += 4 * kThreads) {
        float h[4];
        h4(n, h);
        st_q4(static_cast<int8_t*>(a.h) + r + n, h, s);
      }
      if (threadIdx.x == 0) a.rs[a.Bp + m] = s;
    } else {
      for (int n = 4 * threadIdx.x; n < a.Wd; n += 4 * kThreads) {
        float h[4];
        h4(n, h);
#pragma unroll
        for (int j = 0; j < 4; ++j) h[j] = round_to<XT>(h[j]);
        st4(static_cast<float*>(a.h) + r + n, h);
      }
    }
  }
}

// The activation of gate/up -> act (zero past I and in the pad rows; the
// gate/up columns past I are never written, so they are not read as
// values).
template <typename XT, bool A8>
__device__ void act_rows(const Args& a, Smem& sm) {
  const bool swiglu = a.act_kind == kSwiglu;
  const int act = a.act_kind == kGeluAct ? qmm::kGelu : qmm::kRelu;
  for (int m = blockIdx.x; m < a.Bp; m += gridDim.x) {
    const long long r = static_cast<long long>(m) * a.Wi;
    const bool live = m < a.B;
    float amax = 0.0f;
    for (int n = 4 * threadIdx.x; n < a.Wi; n += 4 * kThreads) {
      const float4 u4 = ld4(a.up + r + n);
      const float4 g4 = swiglu ? ld4(a.gate + r + n)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float u[4] = {u4.x, u4.y, u4.z, u4.w};
      const float g[4] = {g4.x, g4.y, g4.z, g4.w};
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!live || n + j >= a.I) {
          v[j] = 0.0f;
        } else if (swiglu) {
          const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-g[j])));
          v[j] = __fmul_rn(__fmul_rn(g[j], sig), u[j]);
        } else {
          v[j] = qmm::activate(u[j], act);
        }
      }
      if constexpr (A8) {
        // the f32 values go to `gate` (each thread its own columns),
        // then are quantized with the row's scale
        st4(a.gate + r + n, v);
        amax = amax4(amax, v);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = round_to<XT>(v[j]);
        st4(static_cast<float*>(a.act) + r + n, v);
      }
    }
    if constexpr (A8) {
      const float s = quant_scale(block_reduce<true>(amax, sm));
      for (int n = 4 * threadIdx.x; n < a.Wi; n += 4 * kThreads) {
        const float4 v4 = ld4(a.gate + r + n);
        const float v[4] = {v4.x, v4.y, v4.z, v4.w};
        st_q4(static_cast<int8_t*>(a.act) + r + n, v, s);
      }
      if (threadIdx.x == 0) a.rs[2 * a.Bp + m] = s;
    }
  }
}

// -- matmul phases -----------------------------------------------------------

// 16 weights of one row (16 consecutive columns) as floats.
template <typename WT>
__device__ __forceinline__ void widen16(const WT* p, float* f) {
  if constexpr (std::is_same<WT, int8_t>::value) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    qmm::s8x4_to_f32(u.x, f);
    qmm::s8x4_to_f32(u.y, f + 4);
    qmm::s8x4_to_f32(u.z, f + 8);
    qmm::s8x4_to_f32(u.w, f + 12);
  } else if constexpr (std::is_same<WT, __nv_bfloat16>::value) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + h);
      const uint32_t w4[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        f[8 * h + 2 * i] = __uint_as_float(w4[i] << 16);
        f[8 * h + 2 * i + 1] = __uint_as_float(w4[i] & 0xffff0000u);
      }
    }
  } else {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(p) + h);
      f[4 * h] = u.x;
      f[4 * h + 1] = u.y;
      f[4 * h + 2] = u.z;
      f[4 * h + 3] = u.w;
    }
  }
}

template <bool A8>
using Acc = typename std::conditional<A8, int, float>::type;

// The epilogue of column n (of the op's padded columns) of row m.
template <typename XT, bool A8>
__device__ __forceinline__ void finish(const Args& a, const Op& op, int m,
                                       int n, Acc<A8> acc) {
  if (m >= a.B || n >= op.N) return;
  const int c = op.sb0 * a.bn + n;
  float y;
  if constexpr (A8) {
    const int src = op.id == kO ? 0 : (op.id == kD ? 2 : 1);
    const float s =
        __fmul_rn(__int2float_rn(acc), __ldcg(a.rs + src * a.Bp + m));
    y = __fmaf_rn(s, a.sb[c], a.sb[a.totN + c]);
  } else {
    y = __fmaf_rn(acc, a.sb[c], a.sb[a.totN + c]);
  }
  const long long rd = static_cast<long long>(m) * a.Wd + n;
  const long long ri = static_cast<long long>(m) * a.Wi + n;
  switch (op.id) {
    case kO:
      a.xres[rd] = __fadd_rn(__ldcg(a.xres + rd), y);
      break;
    case kG:
      a.gate[ri] = y;
      break;
    case kU:
      a.up[ri] = y;
      break;
    case kD: {
      const float v = __fadd_rn(__ldcg(a.xres + rd), y);
      a.xres[rd] = v;
      store<XT>(a.x_out, static_cast<long long>(m) * a.D + n, v);
      break;
    }
    default:
      store<XT>(a.tail, static_cast<long long>(m) * a.N3 + n, y);
  }
}

// One task: column tile `tile`, K split `split`, row group `rg` of `op`,
// whose source rows are `src` (width src_w; f32, or int8 under w8a8).
template <typename WT, typename XT, bool A8>
__device__ void run_task(const Args& a, const Op& op, int tile, int split,
                         int rg, const void* src, int src_w, Smem& sm) {
  using AccT = Acc<A8>;
  const int c = threadIdx.x % kChunks, kl = threadIdx.x / kChunks;
  const int warp = threadIdx.x / 32;
  const int S = op.S;
  const int kr0 = split * S, kb = kr0 / a.bk, r0 = kr0 - kb * a.bk;
  const int n0 = tile * kTileN, nb = n0 / a.bn, c0 = n0 - nb * a.bn;
  const int m0 = rg * kRows;
  const WT* wbase = static_cast<const WT*>(a.w) +
                    (static_cast<long long>(op.g0 + nb * op.KB + kb) * a.bk +
                     r0) * a.bn +
                    c0 + c * kChunkCols;

  // stage the task's x rows in shared memory
  if constexpr (A8) {
    const int words = S / 4;
    for (int i = threadIdx.x; i < kRows * words; i += kThreads) {
      const int mm = i / words, k = (i - mm * words) * 4;
      *reinterpret_cast<int*>(&sm.x.q[mm][k]) = __ldcg(
          reinterpret_cast<const int*>(static_cast<const int8_t*>(src) +
                                       static_cast<long long>(m0 + mm) * src_w +
                                       kr0 + k));
    }
  } else {
    const int vecs = S / 4;
    for (int i = threadIdx.x; i < kRows * vecs; i += kThreads) {
      const int mm = i / vecs, k = (i - mm * vecs) * 4;
      *reinterpret_cast<float4*>(&sm.x.f[mm][k]) = __ldcg(
          reinterpret_cast<const float4*>(static_cast<const float*>(src) +
                                          static_cast<long long>(m0 + mm) *
                                              src_w +
                                          kr0 + k));
    }
  }
  __syncthreads();

  AccT acc[kRows][kChunkCols];
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int i = 0; i < kChunkCols; ++i) acc[m][i] = AccT(0);

  for (int k = kl * kQuad; k < S; k += kKLanes * kQuad) {
    if constexpr (A8) {
      uint4 w[kQuad];
#pragma unroll
      for (int r = 0; r < kQuad; ++r)
        w[r] = __ldg(reinterpret_cast<const uint4*>(
            wbase + static_cast<long long>(k + r) * a.bn));
      int xq[kRows];
#pragma unroll
      for (int m = 0; m < kRows; ++m)
        xq[m] = *reinterpret_cast<const int*>(&sm.x.q[m][k]);
      const uint32_t words[kQuad][4] = {{w[0].x, w[0].y, w[0].z, w[0].w},
                                        {w[1].x, w[1].y, w[1].z, w[1].w},
                                        {w[2].x, w[2].y, w[2].z, w[2].w},
                                        {w[3].x, w[3].y, w[3].z, w[3].w}};
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const uint32_t t0 = __byte_perm(words[0][g], words[1][g], 0x5140);
        const uint32_t t1 = __byte_perm(words[0][g], words[1][g], 0x7362);
        const uint32_t t2 = __byte_perm(words[2][g], words[3][g], 0x5140);
        const uint32_t t3 = __byte_perm(words[2][g], words[3][g], 0x7362);
        const int col[4] = {static_cast<int>(__byte_perm(t0, t2, 0x5410)),
                            static_cast<int>(__byte_perm(t0, t2, 0x7632)),
                            static_cast<int>(__byte_perm(t1, t3, 0x5410)),
                            static_cast<int>(__byte_perm(t1, t3, 0x7632))};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int m = 0; m < kRows; ++m)
            acc[m][4 * g + j] = __dp4a(col[j], xq[m], acc[m][4 * g + j]);
      }
    } else {
#pragma unroll
      for (int r = 0; r < kQuad; ++r) {
        float wf[kChunkCols];
        widen16<WT>(wbase + static_cast<long long>(k + r) * a.bn, wf);
#pragma unroll
        for (int m = 0; m < kRows; ++m) {
          const float xv = sm.x.f[m][k + r];
#pragma unroll
          for (int i = 0; i < kChunkCols; ++i)
            acc[m][i] = fmaf(xv, wf[i], acc[m][i]);
        }
      }
    }
  }

  // the 4 k-lanes of a warp that share a chunk are lanes c, c+8, c+16, c+24
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int i = 0; i < kChunkCols; ++i) {
      AccT v = acc[m][i];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][i] = v;
    }
  auto* red = reinterpret_cast<AccT(*)[kRows][kTileN]>(&sm.red);
  if (threadIdx.x % 32 < kChunks) {
#pragma unroll
    for (int m = 0; m < kRows; ++m)
#pragma unroll
      for (int i = 0; i < kChunkCols; ++i)
        red[warp][m][c * kChunkCols + i] = acc[m][i];
  }
  __syncthreads();

  const int Np = op.NB * a.bn;
  AccT* part = static_cast<AccT*>(a.part) + op.part;
  for (int o = threadIdx.x; o < kRows * kTileN; o += kThreads) {
    const int mm = o / kTileN, lc = o - mm * kTileN;
    AccT v = red[0][mm][lc];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += red[w][mm][lc];
    if (op.splits == 1) {
      finish<XT, A8>(a, op, m0 + mm, n0 + lc, v);
    } else {
      part[(static_cast<long long>(split) * a.Bp + m0 + mm) * Np + n0 + lc] =
          v;
    }
  }
  if (op.splits == 1) {
    __syncthreads();
    return;
  }

  // split K: the last task of this column tile and row group to arrive
  // adds the splits' partial sums in order and runs the epilogue
  __threadfence();
  __syncthreads();
  const int ctr = op.ctr + tile * a.RG + rg;
  if (threadIdx.x == 0)
    sm.is_last = atomicAdd(&a.ctr[ctr], 1) == op.splits - 1;
  __syncthreads();
  if (sm.is_last) {
    for (int o = threadIdx.x; o < kRows * kTileN; o += kThreads) {
      const int mm = o / kTileN, lc = o - mm * kTileN;
      AccT v = AccT(0);
      for (int s = 0; s < op.splits; ++s)
        v += __ldcg(&part[(static_cast<long long>(s) * a.Bp + m0 + mm) * Np +
                          n0 + lc]);
      finish<XT, A8>(a, op, m0 + mm, n0 + lc, v);
    }
    if (threadIdx.x == 0) a.ctr[ctr] = 0;
  }
  __syncthreads();
}

// Every task of ops[first .. first + count), spread over the grid.
template <typename WT, typename XT, bool A8>
__device__ void run_phase(const Args& a, int first, int count,
                          const void* src, int src_w, Smem& sm) {
  int total = 0;
  for (int i = first; i < first + count; ++i) total += a.ops[i].tasks;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    int i = first, local = t;
    while (local >= a.ops[i].tasks) local -= a.ops[i++].tasks;
    const Op& op = a.ops[i];
    const int rg = local % a.RG;
    local /= a.RG;
    const int tile = local % op.tiles;
    run_task<WT, XT, A8>(a, op, tile, local / op.tiles, rg, src, src_w, sm);
  }
}

template <typename WT, typename XT, bool A8>
__global__ void __launch_bounds__(kThreads, 2) chain_kernel(Args a) {
  __shared__ Smem sm;
  const int n_mlp = a.act_kind == kSwiglu ? 2 : 1;  // (G, U) or U
  init_rows<XT, A8>(a, sm);
  grid_sync(a.bar);
  run_phase<WT, XT, A8>(a, 0, 1, a.src_o, a.K0p, sm);
  grid_sync(a.bar);
  norm_rows<XT, A8>(a, 0, sm);
  grid_sync(a.bar);
  run_phase<WT, XT, A8>(a, 1, n_mlp, a.h, a.Wd, sm);
  grid_sync(a.bar);
  act_rows<XT, A8>(a, sm);
  grid_sync(a.bar);
  run_phase<WT, XT, A8>(a, 1 + n_mlp, 1, a.act, a.Wi, sm);
  if (!a.has_tail) return;
  grid_sync(a.bar);
  norm_rows<XT, A8>(a, 2, sm);
  grid_sync(a.bar);
  run_phase<WT, XT, A8>(a, 2 + n_mlp, 1, a.h, a.Wd, sm);
}

template <typename WT, typename XT, bool A8>
int launch_chain(Args& a, cudaStream_t stream) {
  auto kern = chain_kernel<WT, XT, A8>;
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, 0);
  if (!coop || per_sm < 1) return static_cast<int>(cudaErrorNotSupported);
  void* params[] = {&a};
  cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern),
                              dim3(per_sm * sms), dim3(kThreads), params, 0,
                              stream);
  return static_cast<int>(cudaGetLastError());
}

// -- B15: the tiled product over the packed blocks (blocks not w8a8) --------

constexpr int kTM = 64, kTN = 64, kTK = 32, kPad = 4;

struct PArgs {
  const void* x;       // [M, K] f32 or bf16
  const void* w;       // the packed blocks
  const float* scale;  // the run's column scales (sb row 0 from sb0 * bn)
  const float* bias;   // its biases (sb row 1)
  void* out;           // [M, N]
  int M, K, N, g0, KB, bk, bn, act;
};

template <typename WT, typename XT, typename OT>
__global__ void __launch_bounds__(kThreads) packed_kernel(PArgs a) {
  __shared__ __align__(16) float xs[kTK][kTM + kPad];
  __shared__ __align__(16) float ws[kTK][kTN + kPad];
  const int m0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  // the 64 columns lie in one block column (bn % 64 == 0)
  const int nb = n0 / a.bn, c0 = n0 - nb * a.bn;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < a.K; k0 += kTK) {
    const int kb = k0 / a.bk;
    const WT* wt = static_cast<const WT*>(a.w) +
                   (static_cast<long long>(a.g0 + nb * a.KB + kb) * a.bk +
                    (k0 - kb * a.bk)) * a.bn +
                   c0;
#pragma unroll
    for (int r = 0; r < kTM * kTK / kThreads; ++r) {
      const int idx = threadIdx.x + r * kThreads;
      const int mm = idx / kTK, kk = idx % kTK;
      const int m = m0 + mm, k = k0 + kk;
      xs[kk][mm] = m < a.M && k < a.K
                       ? to_f32(static_cast<const XT*>(
                             a.x)[static_cast<long long>(m) * a.K + k])
                       : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < kTK * kTN / kThreads; ++r) {
      const int idx = threadIdx.x + r * kThreads;
      const int kk = idx / kTN, nn = idx % kTN;
      float v = 0.0f;
      if (k0 + kk < a.K && n0 + nn < a.N) {
        const WT q = wt[static_cast<long long>(kk) * a.bn + nn];
        if constexpr (std::is_same<WT, int8_t>::value) {
          v = static_cast<float>(q);
        } else {
          v = to_f32(q);
        }
      }
      ws[kk][nn] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTK; ++kk) {
      float xa[4], wb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        xa[i] = xs[kk][ty * 4 + i];
        wb[i] = ws[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xa[i], wb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
      if (m >= a.M || n >= a.N) continue;
      store<OT>(a.out, static_cast<long long>(m) * a.N + n,
                qmm::activate(__fmaf_rn(acc[i][j], a.scale[n], a.bias[n]),
                              a.act));
    }
}

template <typename WT, typename XT, typename OT>
int launch_packed(const PArgs& a, cudaStream_t stream) {
  const dim3 grid((a.N + kTN - 1) / kTN, (a.M + kTM - 1) / kTM);
  packed_kernel<WT, XT, OT><<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }
inline int gcd(int x, int y) { return y == 0 ? x : gcd(y, x % y); }

}  // namespace chain

// table: [n_ops, n_ops x (op id, g0, KB, NB, K, N, sb0, S), 8 region byte
// offsets (residual, attention input, h, gate, up, act, row scales,
// partials)]; read on the host. sync: the barrier word, then the tile
// counters (zero, and left zero).
extern "C" int pbt_chain_decode(const void* ain, const void* x, const void* w,
                                const float* sb, const float* ln, void* x_out,
                                void* tail, void* work, int* sync,
                                const int* table, long long work_bytes, int B,
                                int D, int I, int K0, int N3, int bk, int bn,
                                int w_code, float eps, int x_code, int w8a8,
                                int act_kind, int norm_kind, void* stream) {
  using namespace chain;
  Args a{};
  a.ain = ain;
  a.x = x;
  a.w = w;
  a.sb = sb;
  a.ln = ln;
  a.x_out = x_out;
  a.tail = tail;
  a.B = B;
  a.Bp = round_up(B, kRows);
  a.RG = a.Bp / kRows;
  a.D = D;
  a.I = I;
  a.K0 = K0;
  a.N3 = N3;
  a.bk = bk;
  a.bn = bn;
  const int lcm = bk / gcd(bk, bn) * bn;
  a.Wd = round_up(D, lcm);
  a.Wi = round_up(I, lcm);
  a.K0p = round_up(K0, bk);
  a.eps = eps;
  a.act_kind = act_kind;
  a.norm_kind = norm_kind;
  a.n_ops = table[0];
  if (a.n_ops < 3 || a.n_ops > kMaxOps || bk % 128 || bn % 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* off = table + 1 + 8 * a.n_ops;
  for (int r = 0; r < kRegions; ++r)
    if (off[r] < 0 || off[r] >= work_bytes)
      return static_cast<int>(cudaErrorInvalidValue);
  char* base = static_cast<char*>(work);
  a.xres = reinterpret_cast<float*>(base + off[0]);
  a.src_o = base + off[1];
  a.h = base + off[2];
  a.gate = reinterpret_cast<float*>(base + off[3]);
  a.up = reinterpret_cast<float*>(base + off[4]);
  a.act = base + off[5];
  a.rs = reinterpret_cast<float*>(base + off[6]);
  a.part = base + off[7];
  a.bar = reinterpret_cast<unsigned*>(sync);
  a.ctr = sync + 1;
  int ctr = 0, last_phase = -1;
  long long part = 0;
  a.totN = 0;
  a.has_tail = 0;
  for (int i = 0; i < a.n_ops; ++i) {
    const int* t = table + 1 + 8 * i;
    Op& op = a.ops[i];
    op.id = t[0];
    op.g0 = t[1];
    op.KB = t[2];
    op.NB = t[3];
    op.K = t[4];
    op.N = t[5];
    op.sb0 = t[6];
    op.S = t[7];
    if (op.S % 128 || op.S > kMaxS || bk % op.S)
      return static_cast<int>(cudaErrorInvalidValue);
    op.tiles = op.NB * bn / kTileN;
    op.splits = op.KB * bk / op.S;
    op.tasks = op.tiles * op.splits * a.RG;
    const int phase = op.id == kO ? 0 : op.id == kD ? 2 : op.id == kT ? 3 : 1;
    if (phase != last_phase) part = 0;
    last_phase = phase;
    op.part = part;
    if (op.splits > 1)
      part += static_cast<long long>(op.splits) * a.Bp * op.NB * bn;
    op.ctr = ctr;
    ctr += op.tiles * a.RG;
    a.totN = (op.sb0 + op.NB) * bn;
    if (op.id == kT) a.has_tail = 1;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf = x_code == qmm::kBF16;
  if (w8a8)
    return bf ? launch_chain<int8_t, __nv_bfloat16, true>(a, st)
              : launch_chain<int8_t, float, true>(a, st);
  if (w_code == kWI8)
    return bf ? launch_chain<int8_t, __nv_bfloat16, false>(a, st)
              : launch_chain<int8_t, float, false>(a, st);
  if (w_code == kWBF16)
    return bf ? launch_chain<__nv_bfloat16, __nv_bfloat16, false>(a, st)
              : launch_chain<__nv_bfloat16, float, false>(a, st);
  if (bf) return static_cast<int>(cudaErrorInvalidValue);
  return launch_chain<float, float, false>(a, st);
}

// B15. Under w8a8: x int8 [M, K] (K % 16 == 0, 16-byte aligned) with
// row scales, the blocks [G, bk, bn] (16-byte aligned), K split into
// `splits` ranges of k_per_split rows (a multiple of 128) with s32
// partials (imma.cuh's workspace) and one zeroed counter per output tile;
// x_code names the output type. Otherwise x f32 or bf16 (x_code), the
// output in x's type, no split.
extern "C" int pbt_packed_linear(const void* x, const float* x_scale,
                                 const void* w, const float* scale,
                                 const float* bias, void* out, void* partials,
                                 int* counters, int M, int K, int N, int g0,
                                 int KB, int G, int bk, int bn, int splits,
                                 int k_per_split, int w_code, int w8a8,
                                 int act, int x_code, void* stream) {
  using namespace chain;
  if (bk % imma::kBK || bn % imma::kBN)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf = x_code == qmm::kBF16;
  if (w8a8) {
    if (k_per_split % imma::kBK)
      return static_cast<int>(cudaErrorInvalidValue);
    imma::Args a{};
    a.x_scale = x_scale;
    a.w_scale = scale;
    a.bias = bias;
    a.out = out;
    a.partials = static_cast<int*>(partials);
    a.counters = counters;
    a.M = M;
    a.K = K;
    a.N = N;
    a.splits = splits;
    a.kt_per_split = k_per_split / imma::kBK;
    a.act = act;
    a.g0 = g0;
    a.KB = KB;
    a.bk = bk;
    a.bn = bn;
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(bn),
                                static_cast<cuuint64_t>(bk),
                                static_cast<cuuint64_t>(G)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(bn),
                                   static_cast<cuuint64_t>(bk) * bn};
    return imma::run<imma::kPacked>(x, w, 3, dims, strides, a, x_code, st);
  }
  const PArgs a{x, w, scale, bias, out, M, K, N, g0, KB, bk, bn, act};
  if (w_code == kWI8)
    return bf ? launch_packed<int8_t, __nv_bfloat16, __nv_bfloat16>(a, st)
              : launch_packed<int8_t, float, float>(a, st);
  if (w_code == kWBF16)
    return bf ? launch_packed<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(
                    a, st)
              : launch_packed<__nv_bfloat16, float, float>(a, st);
  if (bf) return static_cast<int>(cudaErrorInvalidValue);
  return launch_packed<float, float, float>(a, st);
}
