"""Linear layers: ``y = act(x @ w + bias)``, dispatched on the weight
(the JAX package's ``ops/linear.py``).

* :class:`Q4Tensor` -> :func:`~.int4_matmul.w4_matmul` (B12);
* :class:`QTensor` with ``w8a8`` -> per-row INT8 quantization of ``x``,
  then :func:`~.int8_matmul.int8_matmul` (B10);
* :class:`QTensor` without ``w8a8`` -> :func:`~.int8_matmul.w8_matmul`
  (B11, weight-only);
* a dense weight -> ``torch.matmul`` (cuBLAS on the card), a plain large
  matrix product, as the JAX package leaves it to XLA.

Leading dims of ``x`` are flattened to ``[M, K]`` and restored. The
quantized products run their hand-written kernels on CUDA tensors
whatever the configuration: there is no switch to another route.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..quant.tensor import Q4Tensor, QTensor, quantize_per_row
from . import int4_matmul as _int4
from . import int8_matmul as _int8
from .common import activation_fn


def _dense(x: torch.Tensor, w: torch.Tensor, bias, act) -> torch.Tensor:
    """The dense product as JAX computes it: f32 accumulation, bias and
    activation in f32, one rounding to ``x``'s dtype. Without bias or
    activation the product in ``x``'s dtype is that already (one GEMM,
    f32 accumulation, rounded once); with them, the product stays f32
    until the end: on the card one bf16 GEMM with an f32 output, on the
    CPU (which has no such GEMM) the f32 product of the same operands."""
    w = w.to(x.dtype)
    if bias is None and act is None:
        return torch.matmul(x, w)
    if x.dtype == torch.float32:
        y = torch.matmul(x, w)
    elif x.is_cuda:
        lead = x.shape[:-1]
        y = torch.mm(x.reshape(-1, x.shape[-1]), w,
                     out_dtype=torch.float32).reshape(*lead, w.shape[-1])
    else:
        y = torch.matmul(x.float(), w.float())
    if bias is not None:
        y = y + bias.float()
    if act is not None:
        y = activation_fn(act)(y)
    return y.to(x.dtype)


def linear(x: torch.Tensor, w, bias: Optional[torch.Tensor] = None,
           act: Optional[str] = None, w8a8: bool = False) -> torch.Tensor:
    """``y = act(x @ w + bias)`` with ``w [in, out]`` dense, a
    :class:`QTensor` (scales ``[1, out]``) or a :class:`Q4Tensor`;
    ``x [..., in]`` in bf16/f32. Returns ``x``'s dtype."""
    if isinstance(w, torch.Tensor):
        return _dense(x, w, bias, act)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if isinstance(w, Q4Tensor):
        y = _int4.w4_matmul(x2, w.packed, w.scales, bias, group=w.group,
                            bn=w.bn, act=act, out_dtype=x.dtype)
    elif isinstance(w, QTensor) and w8a8:
        xq = quantize_per_row(x2)
        y = _int8.int8_matmul(xq.values, xq.scales, w.values,
                              w.scales.reshape(1, -1), bias, act=act,
                              out_dtype=x.dtype)
    elif isinstance(w, QTensor):
        y = _int8.w8_matmul(x2, w.values, w.scales.reshape(1, -1), bias,
                            act=act, out_dtype=x.dtype)
    else:
        raise TypeError(f"linear over {type(w).__name__}")
    return y.reshape(*lead, y.shape[-1])
