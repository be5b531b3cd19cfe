// INT8-weight matrix products for Hopper (kernels in qmatmul.cuh and
// imma.cuh).
//
//   pbt_int8_matmul  <- ops/int8_matmul.py::int8_matmul (_kernel :30,
//                       pallas_call :162), B10: act((xq @ wq) * x_scale *
//                       w_scale + bias), s8 x s8 summed in s32 (w8a8:
//                       every projection under quant="int8").
//   pbt_w8_matmul    <- ops/int8_matmul.py::w8_matmul (_w8_kernel), B11:
//                       act((x @ widen(wq)) * w_scale + bias), f32 sums
//                       (the LM head under w8a8, every projection under
//                       quant="int8-weight").
//
// The TPU kernels run one (bm, bn) block per program with the K axis as
// the sequential grid dimension, carrying the accumulator in VMEM. Here a
// block owns its outputs and loops over K itself. Small M (decode, M <=
// 16) takes the bandwidth-shaped gemv_kernel, with K split across blocks
// where the columns alone cannot fill the card: bytes bound it, every
// call streams its whole weight once. Larger M takes, for B10, the INT8
// tensor-core kernel (imma.cuh: TMA, the weight tile transposed on chip,
// wgmma s8 x s8 -> s32), with K split where its output tiles fall short
// of the SMs; for B11, the CUDA-core tiled kernel.
//
// Each entry point returns cudaGetLastError() after its launch.

#include "imma.cuh"
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

// gemv 1: the matrix-vector kernel (N % 16 == 0, K % 4 == 0, W 16-byte
// and x 4-byte aligned; k_per_split rows a split, a multiple of 4). gemv
// 0: the tensor-core kernel (K % 16 == 0, N % 16 == 0, x and W 16-byte
// aligned; k_per_split rows a split, a multiple of 128). The wrapper
// zero-pads and aligns the operands for both.
extern "C" int pbt_int8_matmul(const void* xq, const float* x_scale,
                               const void* wq, const float* w_scale,
                               const float* bias, void* out, void* partials,
                               int* counters, int M, int K, int N, int splits,
                               int k_per_split, int gemv, int act,
                               int out_dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gemv) {
    const qmm::Args a = make_args(xq, x_scale, wq, w_scale, bias, out,
                                  partials, counters, M, K, N, splits,
                                  k_per_split, act);
    return out_dtype == qmm::kBF16
               ? qmm::launch_gemv<qmm::kI8A8, float, __nv_bfloat16>(a, st)
               : qmm::launch_gemv<qmm::kI8A8, float, float>(a, st);
  }
  if (N % 16 != 0 || k_per_split % imma::kBK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  imma::Args a{};
  a.x_scale = x_scale;
  a.w_scale = w_scale;
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
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(K)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(N)};
  return imma::run<imma::kMatrix>(xq, wq, 2, dims, strides, a, out_dtype,
                                  st);
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
