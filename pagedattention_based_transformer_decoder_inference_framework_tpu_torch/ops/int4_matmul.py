"""INT4-weight matrix product: a hand-written CUDA kernel
(``csrc/int4_matmul.cu``, on ``csrc/qmatmul.cuh``) in place of the JAX
package's Pallas ``w4_matmul`` (``ops/int4_matmul.py``, ``_w4_kernel``),
B12: ``act(x @ dequant_int4(packed, scales) + bias)`` with f32 sums.

The carrier keeps the JAX package's block-local nibble layout for the
block width ``bn`` the quantizer picked (``quant/tensor.py``), and the
kernel takes ``group`` and ``bn`` as arguments, so any weight the
quantizer makes goes through as it is. The wrapper runs the plain
version (:func:`w4_matmul_plain`) for CPU tensors only; for CUDA tensors
it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..quant.tensor import Q4Tensor, dequantize_int4
from ..utils.platform import CudaKernel, I, P, ptr, stream_handle
from .int8_matmul import (act_code, bias_f32, epilogue, out_code, plan,
                          same_device, scratch, x_code)

W4_MATMUL = CudaKernel(
    "w4_matmul", "int4_matmul.cu", "pbt_w4_matmul",
    [P] * 7 + [I] * 11 + [P], "ops/int4_matmul.py:110")


def _check(x, packed, scales, group, bn):
    if x.dim() != 2:
        raise ValueError("x must be [M, K]")
    M, K = x.shape
    if packed.dtype != torch.int8 or packed.dim() != 2 or \
            packed.shape[0] != K:
        raise ValueError(f"packed must be the int8 carrier [K={K}, N/2]")
    N = packed.shape[1] * 2
    if bn <= 0 or bn % 2 or N % bn or group <= 0 or K % group:
        raise ValueError(f"bn={bn} must be even and divide N={N}, and "
                         f"group={group} divide K={K}")
    if scales.dtype != torch.float32 or tuple(scales.shape) != (
            K // group, N):
        raise ValueError(f"scales must be f32 [{K // group}, {N}]")
    return M, K, N


def w4_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                    scales: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, *, group: int,
                    bn: int, act: Optional[str] = None,
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of :func:`w4_matmul` (same signature): the f32
    dequantized weight, an f32 product, bias, activation."""
    w = dequantize_int4(Q4Tensor(packed, scales, group, bn))
    return epilogue(torch.matmul(x.float(), w), bias, act, out_dtype)


def w4_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
              bias: Optional[torch.Tensor] = None, *, group: int, bn: int,
              act: Optional[str] = None,
              out_dtype=torch.bfloat16) -> torch.Tensor:
    """B12: ``act((x @ dequant_int4(packed, scales)) + bias)``.

    x ``[M, K]`` bf16/f32; packed ``[K, N/2]`` int8 in
    :func:`~..quant.tensor.pack_int4`'s layout for ``bn``; scales
    ``[K/group, N]`` f32. Returns ``[M, N]`` in ``out_dtype``."""
    M, K, N = _check(x, packed, scales, group, bn)
    same_device(x, packed, scales, bias)
    if not x.is_cuda:
        return w4_matmul_plain(x, packed, scales, bias, group=group, bn=bn,
                               act=act, out_dtype=out_dtype)
    codes = act_code(act), x_code(x), out_code(out_dtype)
    x, packed, scales = x.contiguous(), packed.contiguous(), \
        scales.contiguous()
    b = bias_f32(bias, N)
    gemv, splits, kps = plan(M, K, N, (bn // 2) % 8 == 0
                             and packed.data_ptr() % 8 == 0
                             and scales.data_ptr() % 16 == 0)
    part, counters = scratch(x.device, M, N, splits, torch.float32)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    W4_MATMUL.launch(ptr(x), ptr(packed), ptr(scales), ptr(b), ptr(out),
                     ptr(part), ptr(counters), M, K, N, group, bn, splits,
                     kps, int(gemv), *codes, stream_handle(x))
    return out
