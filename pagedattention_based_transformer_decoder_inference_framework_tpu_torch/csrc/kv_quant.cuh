// Warp-wide conversion of one K/V row into the pool's dtype, for Hopper.
//
// A warp holds one row of D values, VPL consecutive values a lane (lane l
// holds values [l * VPL, l * VPL + VPL)), as floats. For an INT8 pool the
// row is quantized as kvcache/pool.py::quantize_kv does it, bit for bit:
//
//   absmax = max |x| over D                    (f32; max is exact)
//   scale  = max(absmax, 1e-8) * inv127        (two f32 operations)
//   q      = clamp(rint(x / scale), -127, 127) (IEEE division, ties to even)
//
// where 1e-8 and inv127 are the f32 values PyTorch's CUDA kernels take
// for the Python scalars 1e-8 and 1.0 / 127.0 (a double scalar is cast to
// the f32 operand type). The quotient is the IEEE one (__fdiv_rn): a
// reciprocal multiply moves some codes by one. The absmax is one warp
// reduction of the values' bits (redux.sync), which orders non-negative
// floats as it orders unsigned ints. bf16 and f32 pools take the
// round-to-nearest-even cast of `.to(pool.dtype)`.
//
// Storage types: a bf16 value travels as its 16 bits (uint16_t), so no
// class type appears in the loads, the stores or the unions.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kvq {

// PyTorch's f32 operands for `clamp_min(absmax, 1e-8) * (1.0 / 127.0)`
constexpr float kMinAbsmax = static_cast<float>(1e-8);
constexpr float kInv127 = static_cast<float>(1.0 / 127.0);

template <int W> struct Unit;
template <> struct Unit<16> { using T = uint4; };
template <> struct Unit<8> { using T = uint2; };
template <> struct Unit<4> { using T = uint32_t; };
template <> struct Unit<2> { using T = uint16_t; };
template <> struct Unit<1> { using T = uint8_t; };

// the widest power-of-two unit (at most 16 bytes) that divides `bytes`
__host__ __device__ constexpr int unit_of(int bytes) {
  return bytes % 16 == 0 ? 16 : bytes % 8 == 0 ? 8 : bytes % 4 == 0 ? 4
         : bytes % 2 == 0 ? 2 : 1;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(uint16_t bf16_bits) {
  return __uint_as_float(static_cast<uint32_t>(bf16_bits) << 16);
}

// f32 -> bf16 bits, rounded to nearest even as PyTorch's cast rounds
__device__ __forceinline__ uint16_t to_bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

template <typename Out> struct Store;
template <> struct Store<int8_t> {
  __device__ static int8_t from(float q) {
    return static_cast<int8_t>(static_cast<int>(q));
  }
};
template <> struct Store<uint16_t> {
  __device__ static uint16_t from(float x) { return to_bf16_bits(x); }
};
template <> struct Store<float> {
  __device__ static float from(float x) { return x; }
};

// the largest of the warp's non-negative `v`
__device__ __forceinline__ float warp_max(float v) {
  return __uint_as_float(__reduce_max_sync(0xffffffffu, __float_as_uint(v)));
}

__device__ __forceinline__ float row_scale(float absmax) {
  return fmaxf(absmax, kMinAbsmax) * kInv127;
}

// One value's INT8 code, as a float holding an integer in [-127, 127]
__device__ __forceinline__ float quantize(float x, float scale) {
  const float q = rintf(__fdiv_rn(x, scale));
  return fminf(fmaxf(q, -127.f), 127.f);
}

// Loads N consecutive values of type In from `src` into floats, in the
// widest units the row's bytes allow (the caller guarantees `src` is
// aligned to unit_of(N * sizeof(In))).
template <typename In, int N>
__device__ __forceinline__ void load_row(const In* src, float (&x)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(In));
  constexpr int kUnit = unit_of(kBytes);
  using U = typename Unit<kUnit>::T;
  union {
    U u[kBytes / kUnit];
    In v[N];
  } raw;
  const U* s = reinterpret_cast<const U*>(src);
#pragma unroll
  for (int i = 0; i < kBytes / kUnit; ++i) raw.u[i] = s[i];
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = to_f32(raw.v[i]);
}

// Stores N values of type Out at `dst` in the widest units their bytes
// allow (the pool's rows are aligned to them).
template <typename Out, int N>
__device__ __forceinline__ void store_row(Out* dst, const Out (&y)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(Out));
  constexpr int kUnit = unit_of(kBytes);
  using U = typename Unit<kUnit>::T;
  union {
    U u[kBytes / kUnit];
    Out v[N];
  } raw;
#pragma unroll
  for (int i = 0; i < N; ++i) raw.v[i] = y[i];
  U* d = reinterpret_cast<U*>(dst);
#pragma unroll
  for (int i = 0; i < kBytes / kUnit; ++i) d[i] = raw.u[i];
}

// The warp's row `x` (VPL values a lane) in the pool's dtype `y`; for an
// INT8 pool returns the row's scale (every lane), else 0.
template <typename Out, int VPL>
__device__ __forceinline__ float convert_row(const float (&x)[VPL],
                                             Out (&y)[VPL]) {
  if constexpr (sizeof(Out) == 1) {
    float m = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) m = fmaxf(m, fabsf(x[i]));
    const float scale = row_scale(warp_max(m));
#pragma unroll
    for (int i = 0; i < VPL; ++i)
      y[i] = Store<Out>::from(quantize(x[i], scale));
    return scale;
  } else {
#pragma unroll
    for (int i = 0; i < VPL; ++i) y[i] = Store<Out>::from(x[i]);
    return 0.f;
  }
}

}  // namespace kvq
