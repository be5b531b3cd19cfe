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
// a task per SM). Its source rows are staged in shared memory, and its
// products run on the tensor cores' warp product (mma.sync, the weights
// the A operand as in mma_gemv.cuh: s8 x s8 -> s32 m16n8k32 under w8a8,
// else bf16 m16n8k16 with int8 blocks widened exactly, bf16 blocks as
// they are and f32 blocks or activations as three bf16 planes, f32 sums).
// Each warp takes the task's k-steps (16 rows, 32 under w8a8, by the 128
// columns) in turn from its ring of kRingBytes in shared memory, which
// TMA fills (128-byte swizzled boxes of a 3-D map over [G, bk, bn], an
// mbarrier a slot); the ring's copy cursor walks the block's k-steps over
// the whole launch, so a task's, a phase's and (across the row phases and
// barriers, the weights depending on no activation) the next phase's
// first weights are in flight while a block finishes a task, waits or
// works on rows. The warps' sums meet in shared memory in warp order.
// Where K is split, each task writes its partial sums (s32 under w8a8,
// so they stay exact) to the workspace, and the last task of a column tile
// to arrive (a counter per tile, reset by that task) adds the splits in
// order and runs the epilogue: deterministic. The row phases (norms, row
// quantization, the activation) need whole rows: one block per batch row,
// 4 columns a thread a step, block reductions in a fixed order. The
// residual, h, gate, up and act rows (L2-sized: 4 x 14336 f32 is 229 KB)
// live in a workspace the wrapper allocates; everything the kernel writes
// is read back through L2 (__ldcg), never a stale L1 line.
//
// Rounding points are the chain's: the residual stays f32 from entry to
// x_out; h and act are rounded to the activation type (or re-quantized per
// row: absmax * (1/127), x / scale rounded half to even, clamped to 127);
// the epilogue is (f32(acc) * x_scale) then one fused multiply-add with
// the column scale and bias (for dense weights the scale is 1, so it is
// acc + bias). Norms use correctly rounded division and square roots.
//
// What bounds B14 on the H100: its weight bytes, read once (Llama-3-8B
// w8a8: 218 MB a layer, 0.065 ms at 3.35 TB/s), and the seven barriers
// and the row phases between the matmul phases. Folding the row phases
// into every block (each computing the norms' statistics and staging its
// own rows from the residual) measured slower than the barriers it saves:
// every block then reads the same rows in dependent rounds.
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

#include <atomic>

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
constexpr int kMaxS = 1024;        // rows of K a task stages at most
constexpr int kMaxOps = 5;
constexpr int kRegions = 8;
// a warp's ring of weight k-steps, x's stage (4-byte words: kMaxS rows of
// 4 batch rows as three bf16 planes at most) and the warps' sums; the
// dynamic shared memory (1024 bytes to align the ring, as the swizzled
// boxes need), two blocks an SM
constexpr int kRingBytes = 8192;
constexpr int kStageWords = 3 * kMaxS * kRows / 2;
constexpr int kRedWords = kWarps * kRows * kTileN;
constexpr int kSmem = 1024 + kWarps * kRingBytes + 4 * (kStageWords + kRedWords);

struct Op {
  int id, g0, KB, NB, K, N, sb0, S;
  int tiles, splits, tasks;
  long long part;  // element offset of its split-K partials
  int ctr;         // its first tile counter
};

struct Args {
  CUtensorMap wmap;  // the blocks [G, bk, bn]: boxes of 128 bytes x a k-step
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

struct Smem {
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

// f32 -> three bf16 (as their bits) that sum to it exactly
__device__ __forceinline__ void planes3(float v, uint32_t (&h)[3]) {
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const __nv_bfloat16 b = __float2bfloat16_rn(v);
    h[p] = __bfloat16_as_ushort(b);
    v -= __bfloat162float(b);
  }
}

// The products (the weights the A operand of mma.sync, as in mma_gemv.cuh;
// here for every kind of block): a warp's k-step is KS rows of a block by
// the task's 128 columns, CH 128-byte boxes by TMA; lane (g, c) multiplies
// the 16 columns 16 g .. 16 g + 15 of its ROWS rows (Step::row). int8
// blocks widened exactly to bf16 pairs (B11's widening), bf16 ones paired
// by one prmt, f32 ones as three bf16 planes; under w8a8 s8 x s8 -> s32
// (m16n8k32, four k of a column by a 4 x 4 byte transpose). x's rows are
// staged as [plane][k pair][4 rows] bf16 pairs ([k quad][4 rows] int8
// under w8a8); the n-tile's rows 4..7 read rows 0..3 again and feed no
// stored output.
template <typename WT, bool A8>
struct Step {
  static constexpr int KS = 16, ROWS = 4, CH = sizeof(WT);
  static constexpr int BYTES = KS * 128 * CH;
  __device__ static int row(int i, int c) {
    return 2 * c + (i & 1) + (i >> 1) * 8;
  }
};
template <>
struct Step<int8_t, true> {
  static constexpr int KS = 32, ROWS = 8, CH = 1;
  static constexpr int BYTES = KS * 128;
  __device__ static int row(int i, int c) {
    return 4 * c + (i & 3) + (i >> 2) * 16;
  }
};

// Lane 0: one k-step into `slot` (1024-byte aligned), counted on `bar`: its
// CH boxes at column col, row row of block z.
template <typename WT, bool A8>
__device__ __forceinline__ void fill_step(uint8_t* slot, uint64_t* bar,
                                          const CUtensorMap* map, int col,
                                          int row, int z) {
  using S = Step<WT, A8>;
  constexpr int BOX = 128 / static_cast<int>(sizeof(WT));
  hop::mbar_arrive_tx(bar, S::BYTES);
#pragma unroll
  for (int b = 0; b < S::CH; ++b)
    hop::tma_load_3d(slot + b * S::KS * 128, map, col + b * BOX, row, z, bar);
}

// The lane's 16-byte chunk h of its row i, as the 128-byte swizzle lays
// the boxes out.
template <typename WT, bool A8>
__device__ __forceinline__ uint4 chunk(const uint8_t* slot, int i, int h) {
  using S = Step<WT, A8>;
  const int lane = threadIdx.x % 32, c = lane % 4;
  const int r = S::row(i, c), byte = 16 * ((lane / 4) * S::CH + h);
  return *reinterpret_cast<const uint4*>(slot + (byte >> 7) * (S::KS * 128) +
                                         hop::swz(r, (byte >> 4) & 7));
}

template <bool A8>
using Acc = typename std::conditional<A8, int, float>::type;

// The products of one k-step (its first k unit ku0 of the stage, planes
// `plane` words apart) into acc[8 products][4].
template <typename WT, bool A8, int P>
__device__ __forceinline__ void step_products(const uint8_t* slot,
                                              const uint32_t* stage, int ku0,
                                              int plane,
                                              Acc<A8> (&acc)[8][4]) {
  using S = Step<WT, A8>;
  const int lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
  uint4 r[S::ROWS][S::CH];
#pragma unroll
  for (int i = 0; i < S::ROWS; ++i)
#pragma unroll
    for (int h = 0; h < S::CH; ++h) r[i][h] = chunk<WT, A8>(slot, i, h);
  uint32_t b[P][2];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    b[p][0] = stage[(p * plane + ku0 + c) * kRows + (g & 3)];
    b[p][1] = stage[(p * plane + ku0 + c + 4) * kRows + (g & 3)];
  }
  if constexpr (A8) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t col[2][4];
#pragma unroll
      for (int hk = 0; hk < 2; ++hk) {
        const uint32_t w0 = mgv::word(r[4 * hk][0], q);
        const uint32_t w1 = mgv::word(r[4 * hk + 1][0], q);
        const uint32_t w2 = mgv::word(r[4 * hk + 2][0], q);
        const uint32_t w3 = mgv::word(r[4 * hk + 3][0], q);
        const uint32_t t0 = __byte_perm(w0, w1, 0x5140);
        const uint32_t t1 = __byte_perm(w0, w1, 0x7362);
        const uint32_t t2 = __byte_perm(w2, w3, 0x5140);
        const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
        col[hk][0] = __byte_perm(t0, t2, 0x5410);
        col[hk][1] = __byte_perm(t0, t2, 0x7632);
        col[hk][2] = __byte_perm(t1, t3, 0x5410);
        col[hk][3] = __byte_perm(t1, t3, 0x7632);
      }
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const uint32_t A[4] = {col[0][2 * h2], col[0][2 * h2 + 1],
                               col[1][2 * h2], col[1][2 * h2 + 1]};
        hop::mma_16832_s8(acc[2 * q + h2], A, b[0]);
      }
    }
  } else if constexpr (std::is_same<WT, int8_t>::value) {
    constexpr float kBias = 8388736.0f;  // 2^23 + 128
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float f[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t u = mgv::word(r[i][0], q) ^ 0x80808080u;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          f[i][e] =
              __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + e)) - kBias;
      }
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int ca = 2 * h2, cb = 2 * h2 + 1;
        const uint32_t A[4] = {hop::i8pair_bf16(f[0][ca], f[1][ca]),
                               hop::i8pair_bf16(f[0][cb], f[1][cb]),
                               hop::i8pair_bf16(f[2][ca], f[3][ca]),
                               hop::i8pair_bf16(f[2][cb], f[3][cb])};
#pragma unroll
        for (int p = 0; p < P; ++p) hop::mma_16816(acc[2 * q + h2], A, b[p]);
      }
    }
  } else if constexpr (std::is_same<WT, __nv_bfloat16>::value) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // word j of a row: columns 2j, 2j + 1
      const uint32_t w0 = mgv::word(r[0][j / 4], j % 4);
      const uint32_t w1 = mgv::word(r[1][j / 4], j % 4);
      const uint32_t w2 = mgv::word(r[2][j / 4], j % 4);
      const uint32_t w3 = mgv::word(r[3][j / 4], j % 4);
      const uint32_t A[4] = {__byte_perm(w0, w1, 0x5410),
                             __byte_perm(w0, w1, 0x7632),
                             __byte_perm(w2, w3, 0x5410),
                             __byte_perm(w2, w3, 0x7632)};
#pragma unroll
      for (int p = 0; p < P; ++p) hop::mma_16816(acc[j], A, b[p]);
    }
  } else {  // f32 blocks: column j is word j % 4 of chunk j / 4
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t h[4][2][3];  // [row][column 2j + e][plane]
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          planes3(__uint_as_float(
                      mgv::word(r[i][(2 * j + e) / 4], (2 * j + e) % 4)),
                  h[i][e]);
#pragma unroll
      for (int pa = 0; pa < 3; ++pa) {
        const uint32_t A[4] = {h[0][0][pa] | h[1][0][pa] << 16,
                               h[0][1][pa] | h[1][1][pa] << 16,
                               h[2][0][pa] | h[3][0][pa] << 16,
                               h[2][1][pa] | h[3][1][pa] << 16};
#pragma unroll
        for (int p = 0; p < P; ++p) hop::mma_16816(acc[j], A, b[p]);
      }
    }
  }
}

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

// The ring's copy cursor of one warp over the launch's matmul phases:
// phase p (its ops first .. first + count, as run_phase enumerates their
// tasks), task t (blockIdx.x, + gridDim.x, ...), k-step st (warp, warp +
// 8, ...) of the task's `steps`; the task's column within its block
// column, first row and the first block of its block column; `issued`
// k-steps so far. Weights depend on no activation, so the cursor copies
// on across the row phases and the barriers.
struct Cursor {
  int p, t, st, steps, c0, k0, g, issued;
};

// The matmul phases' ops: O; G and U (or U); D; T (with a tail).
__device__ __forceinline__ void phase_ops(const Args& a, int p, int& first,
                                          int& count) {
  const int n_mlp = a.act_kind == kSwiglu ? 2 : 1;
  first = p == 0 ? 0 : p == 1 ? 1 : p == 2 ? 1 + n_mlp : 2 + n_mlp;
  count = p == 1 ? n_mlp : 1;
}

// Moves the cursor from task (p, t) to the first one with a k-step for
// this warp, and takes its coordinates.
template <int KS>
__device__ __forceinline__ void settle(const Args& a, Cursor& cu) {
  const int warp = threadIdx.x / 32;
  const int phases = a.has_tail ? 4 : 3;
  for (; cu.p < phases; ++cu.p, cu.t = blockIdx.x) {
    int first, count;
    phase_ops(a, cu.p, first, count);
    for (;; cu.t += gridDim.x) {
      int i = first, local = cu.t;
      while (i < first + count && local >= a.ops[i].tasks)
        local -= a.ops[i++].tasks;
      if (i == first + count) break;  // past the phase's tasks
      const Op& op = a.ops[i];
      if (warp >= op.S / KS) continue;
      local /= a.RG;
      const int tile = local % op.tiles, split = local / op.tiles;
      const int n0 = tile * kTileN, nb = n0 / a.bn;
      cu.steps = op.S / KS;
      cu.c0 = n0 - nb * a.bn;
      cu.k0 = split * op.S;
      cu.g = op.g0 + nb * op.KB;
      cu.st = warp;
      return;
    }
  }
}

// Lane 0 fills the next ring slot with the cursor's k-step; every lane
// moves the cursor on (nothing past the launch's last k-step).
template <typename WT, bool A8, int RING>
__device__ __forceinline__ void issue(const Args& a, Cursor& cu,
                                      uint8_t* ring, uint64_t* bar) {
  using S = Step<WT, A8>;
  if (cu.p >= (a.has_tail ? 4 : 3)) return;
  if (threadIdx.x % 32 == 0) {
    const int kr = cu.k0 + cu.st * S::KS, kb = kr / a.bk;
    fill_step<WT, A8>(ring + (cu.issued % RING) * S::BYTES,
                      &bar[cu.issued % RING], &a.wmap, cu.c0,
                      kr - kb * a.bk, cu.g + kb);
  }
  ++cu.issued;
  cu.st += kWarps;
  if (cu.st >= cu.steps) {
    cu.t += gridDim.x;
    settle<S::KS>(a, cu);
  }
}

// Per-block state of the matmul phases.
struct Block {
  Cursor cu;
  int s;  // k-steps consumed
  uint8_t* ring;
  uint64_t* bar;
  uint32_t* stage;
  void* red;
};

// One task: column tile `tile`, K split `split`, row group `rg` of `op`,
// whose source rows are `src` (width src_w; f32, or int8 under w8a8).
template <typename WT, typename XT, bool A8>
__device__ void run_task(const Args& a, const Op& op, int tile, int split,
                         int rg, const void* src, int src_w, Smem& sm,
                         Block& bk) {
  using AccT = Acc<A8>;
  using S = Step<WT, A8>;
  constexpr int RING = kRingBytes / S::BYTES;
  constexpr int P = !A8 && std::is_same<XT, float>::value ? 3 : 1;
  const int warp = threadIdx.x / 32;
  const int Sr = op.S, kr0 = split * Sr;
  const int n0 = tile * kTileN, m0 = rg * kRows;

  // the task's x rows into the stage as the products read them (under
  // w8a8 [S / 4][4 rows] words of four int8, else [P][S / 2][4 rows] bf16
  // pairs of the f32 rows, which hold values of the activation type, or
  // three planes for f32 activations); four columns an item
  __syncthreads();  // the last task's stage is read
  const int nq = Sr / 4;
  for (int o = threadIdx.x; o < kRows * nq; o += kThreads) {
    const int mm = o / nq, kq = o - mm * nq;
    const long long at = static_cast<long long>(m0 + mm) * src_w + kr0 + 4 * kq;
    if constexpr (A8) {
      bk.stage[kq * kRows + mm] = static_cast<uint32_t>(__ldcg(
          reinterpret_cast<const int*>(static_cast<const int8_t*>(src) + at)));
    } else {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(
          static_cast<const float*>(src) + at));
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t lo[3], hi[3];
        planes3(e[2 * h], lo);
        planes3(e[2 * h + 1], hi);
#pragma unroll
        for (int p = 0; p < P; ++p)
          bk.stage[(p * (Sr / 2) + 2 * kq + h) * kRows + mm] =
              lo[p] | hi[p] << 16;
      }
    }
  }
  __syncthreads();

  AccT acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = AccT(0);
  const int plane = A8 ? Sr / 4 : Sr / 2;
  for (int st = warp; st < Sr / S::KS; st += kWarps, ++bk.s) {
    hop::mbar_wait(&bk.bar[bk.s % RING], (bk.s / RING) & 1);
    step_products<WT, A8, P>(bk.ring + (bk.s % RING) * S::BYTES, bk.stage,
                             st * S::KS / (A8 ? 4 : 2), plane, acc);
    __syncwarp();  // the slot is read: it takes the ring's next k-step
    issue<WT, A8, RING>(a, bk.cu, bk.ring, bk.bar);
  }

  // The warps' sums in shared memory: lane (g, c) holds columns 16 g + 2j
  // + e / 2 of rows 2c + e % 2 (rows 0..3: lanes c < 2); column 16 g + i
  // at i * 8 + g of a row, then added in warp order.
  AccT* red = static_cast<AccT*>(bk.red);
  {
    const int lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
    if (c < 2) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[(warp * kRows + 2 * c + (e & 1)) * kTileN +
              (2 * j + (e >> 1)) * 8 + g] = acc[j][e];
    }
  }
  __syncthreads();

  const int Np = op.NB * a.bn;
  AccT* part = static_cast<AccT*>(a.part) + op.part;
  for (int o = threadIdx.x; o < kRows * kTileN; o += kThreads) {
    const int mm = o / kTileN, phys = o - mm * kTileN;
    const int lc = 16 * (phys % 8) + phys / 8;
    AccT v = red[mm * kTileN + phys];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += red[(w * kRows + mm) * kTileN + phys];
    if (op.splits == 1) {
      finish<XT, A8>(a, op, m0 + mm, n0 + lc, v);
    } else {
      part[(static_cast<long long>(split) * a.Bp + m0 + mm) * Np + n0 + lc] =
          v;
    }
  }
  if (op.splits == 1) return;

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
}

// Every task of ops[first .. first + count), spread over the grid.
template <typename WT, typename XT, bool A8>
__device__ void run_phase(const Args& a, int first, int count,
                          const void* src, int src_w, Smem& sm, Block& bk) {
  int total = 0;
  for (int i = first; i < first + count; ++i) total += a.ops[i].tasks;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    int i = first, local = t;
    while (local >= a.ops[i].tasks) local -= a.ops[i++].tasks;
    const Op& op = a.ops[i];
    const int rg = local % a.RG;
    local /= a.RG;
    const int tile = local % op.tiles;
    run_task<WT, XT, A8>(a, op, tile, local / op.tiles, rg, src, src_w, sm,
                         bk);
  }
}

template <typename WT, typename XT, bool A8>
__global__ void __launch_bounds__(kThreads, 2)
    chain_kernel(const __grid_constant__ Args a) {
  using S = Step<WT, A8>;
  constexpr int RING = kRingBytes / S::BYTES;
  extern __shared__ __align__(16) uint8_t smem_dyn[];
  __shared__ Smem sm;
  __shared__ uint64_t bars[kWarps][RING];
  const int warp = threadIdx.x / 32;
  uint8_t* const base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_dyn) + 1023) & ~uintptr_t(1023));
  Block bk;
  bk.ring = base + warp * kRingBytes;
  bk.bar = bars[warp];
  bk.stage = reinterpret_cast<uint32_t*>(base + kWarps * kRingBytes);
  bk.red = bk.stage + kStageWords;
  bk.s = 0;
  if (threadIdx.x % 32 == 0) {
    for (int i = 0; i < RING; ++i) hop::mbar_init(&bk.bar[i], 1);
    hop::mbar_fence_init();
  }
  __syncwarp();
  bk.cu = Cursor{0, static_cast<int>(blockIdx.x), warp, 0, 0, 0, 0, 0};
  settle<S::KS>(a, bk.cu);
  // the first weights in flight while the rows are set up
#pragma unroll
  for (int i = 0; i < RING; ++i) issue<WT, A8, RING>(a, bk.cu, bk.ring, bk.bar);
  const int n_mlp = a.act_kind == kSwiglu ? 2 : 1;  // (G, U) or U
  init_rows<XT, A8>(a, sm);
  grid_sync(a.bar);
  run_phase<WT, XT, A8>(a, 0, 1, a.src_o, a.K0p, sm, bk);
  grid_sync(a.bar);
  norm_rows<XT, A8>(a, 0, sm);
  grid_sync(a.bar);
  run_phase<WT, XT, A8>(a, 1, n_mlp, a.h, a.Wd, sm, bk);
  grid_sync(a.bar);
  act_rows<XT, A8>(a, sm);
  grid_sync(a.bar);
  run_phase<WT, XT, A8>(a, 1 + n_mlp, 1, a.act, a.Wi, sm, bk);
  if (!a.has_tail) return;
  grid_sync(a.bar);
  norm_rows<XT, A8>(a, 2, sm);
  grid_sync(a.bar);
  run_phase<WT, XT, A8>(a, 2 + n_mlp, 1, a.h, a.Wd, sm, bk);
}

template <typename WT, typename XT, bool A8>
int launch_chain(Args& a, cudaStream_t stream) {
  static std::atomic<uint64_t> allowed{0};
  auto kern = chain_kernel<WT, XT, A8>;
  const int err = qmm::allow_smem(kern, kSmem, allowed);
  if (err) return err;
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                kSmem);
  if (!coop || per_sm < 1) return static_cast<int>(cudaErrorNotSupported);
  void* params[] = {&a};
  cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern),
                              dim3(per_sm * sms), dim3(kThreads), params,
                              kSmem, stream);
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
  // the blocks as boxes of 128 bytes by a k-step's rows (32 under w8a8,
  // else 16), one block deep
  int G = 0;
  for (int i = 0; i < a.n_ops; ++i)
    G = max(G, a.ops[i].g0 + a.ops[i].KB * a.ops[i].NB);
  const int es = w8a8 || w_code == kWI8 ? 1 : w_code == kWBF16 ? 2 : 4;
  const hop::EncodeTiled encode = hop::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(bn),
                              static_cast<cuuint64_t>(bk),
                              static_cast<cuuint64_t>(G)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(bn) * es,
                                 static_cast<cuuint64_t>(bk) * bn * es};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(128 / es),
                             static_cast<cuuint32_t>(w8a8 ? 32 : 16), 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUtensorMapDataType type =
      es == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
              : es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (!hop::aligned16(w) ||
      encode(&a.wmap, type, 3, const_cast<void*>(w), dims, strides, box,
             ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
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
