// INT4-weight matrix product for Hopper (kernels in qmatmul.cuh).
//
//   pbt_w4_matmul  <- ops/int4_matmul.py::w4_matmul (_w4_kernel), B12:
//                     act(x @ dequant_int4(packed, scales) + bias), f32
//                     sums (every projection and the LM head under
//                     quant="int4").
//
// The carrier keeps the JAX package's block-local layout for block width
// bn (quant/tensor.py::pack_int4): carrier column j*bn/2 + t holds weight
// column j*bn + t in its low nibble (offset-binary, q + 8) and column
// j*bn + bn/2 + t in its high nibble (two's complement). The quantizer
// picks bn per weight (2048 for Llama-3-8B's projections, 768 for its
// 128256-column LM head), so the kernel takes it as an argument. The scale
// applies per (K-group of `group` rows, column), and the kernel multiplies
// each widened weight by it: the plain function, not the TPU kernel's
// per-group row-sum rewrite, which exists for the TPU's vector unit.
//
// Bytes bound decode (half a byte per weight plus the f32 scales, one per
// 128 weights); gemv_kernel reads 8 carrier bytes (16 columns) per row and
// thread. Prefill takes the tiled kernel.
//
// The entry point returns cudaGetLastError() after its launch.

#include "qmatmul.cuh"

extern "C" int pbt_w4_matmul(const void* x, const void* packed,
                             const float* scales, const float* bias,
                             void* out, void* partials, int* counters, int M,
                             int K, int N, int group, int bn, int splits,
                             int k_per_split, int gemv, int act, int x_dtype,
                             int out_dtype, void* stream) {
  if (group <= 0 || bn <= 0 || bn % 2 != 0 || N % bn != 0 || K % group != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  qmm::Args a;
  a.x = x;
  a.x_scale = nullptr;
  a.w = packed;
  a.w_scale = scales;
  a.bias = bias;
  a.out = out;
  a.partials = partials;
  a.counters = counters;
  a.M = M;
  a.K = K;
  a.N = N;
  a.splits = splits;
  a.k_per_split = k_per_split;
  a.group = group;
  a.bn = bn;
  a.act = act;
  return qmm::dispatch<qmm::kW4>(a, gemv, x_dtype, out_dtype,
                                 static_cast<cudaStream_t>(stream));
}
