// INT8-weight matrix products for Hopper (kernels in qmatmul.cuh).
//
//   pbt_int8_matmul  <- ops/int8_matmul.py::int8_matmul (_kernel), B10:
//                       act((xq @ wq) * x_scale * w_scale + bias), s8 x s8
//                       summed in s32 (w8a8: every projection under
//                       quant="int8").
//   pbt_w8_matmul    <- ops/int8_matmul.py::w8_matmul (_w8_kernel), B11:
//                       act((x @ widen(wq)) * w_scale + bias), f32 sums
//                       (the LM head under w8a8, every projection under
//                       quant="int8-weight").
//
// The TPU kernels run one (bm, bn) block per program with the K axis as
// the sequential grid dimension, carrying the accumulator in VMEM. Here a
// block owns its outputs and loops over K itself; small M (decode) takes
// the bandwidth-shaped gemv_kernel, with K split across blocks where the
// columns alone cannot fill the card, everything else the tiled kernel.
// Bytes bound decode: at M = 4 every call streams its whole weight once.
//
// Each entry point returns cudaGetLastError() after its launch.

#include "qmatmul.cuh"

namespace {

qmm::Args make_args(const void* x, const float* x_scale, const void* w,
                    const float* w_scale, const float* bias, void* out,
                    void* partials, int* counters, int M, int K, int N,
                    int splits, int k_per_split, int act) {
  qmm::Args a;
  a.x = x;
  a.x_scale = x_scale;
  a.w = w;
  a.w_scale = w_scale;
  a.bias = bias;
  a.out = out;
  a.partials = partials;
  a.counters = counters;
  a.M = M;
  a.K = K;
  a.N = N;
  a.splits = splits;
  a.k_per_split = k_per_split;
  a.group = 0;
  a.bn = 0;
  a.act = act;
  return a;
}

}  // namespace

extern "C" int pbt_int8_matmul(const void* xq, const float* x_scale,
                               const void* wq, const float* w_scale,
                               const float* bias, void* out, void* partials,
                               int* counters, int M, int K, int N, int splits,
                               int k_per_split, int gemv, int act,
                               int out_dtype, void* stream) {
  const qmm::Args a = make_args(xq, x_scale, wq, w_scale, bias, out, partials,
                                counters, M, K, N, splits, k_per_split, act);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_dtype == qmm::kBF16
             ? qmm::launch<qmm::kI8A8, float, __nv_bfloat16>(a, gemv, st)
             : qmm::launch<qmm::kI8A8, float, float>(a, gemv, st);
}

extern "C" int pbt_w8_matmul(const void* x, const void* wq,
                             const float* w_scale, const float* bias,
                             void* out, void* partials, int* counters, int M,
                             int K, int N, int splits, int k_per_split,
                             int gemv, int act, int x_dtype, int out_dtype,
                             void* stream) {
  const qmm::Args a = make_args(x, nullptr, wq, w_scale, bias, out, partials,
                                counters, M, K, N, splits, k_per_split, act);
  return qmm::dispatch<qmm::kW8>(a, gemv, x_dtype, out_dtype,
                                 static_cast<cudaStream_t>(stream));
}
