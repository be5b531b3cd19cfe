"""Grouped matrix product for the exact Mixture-of-Experts dispatch: a
hand-written CUDA kernel (``csrc/gmm.cu``) in place of the JAX package's
Pallas ``grouped_matmul`` (``ops/gmm.py``, ``_kernel``), B13:

    y[r] = (x[r] @ widen(w[e])) * scales[e],   e = group_of_block[r // bm]

over rows pre-sorted by expert, each expert's range padded to a multiple
of ``bm`` (the layout ``models/model.py::DecoderModel._moe_dispatch``
builds), so every row block belongs to one expert. The sum runs over the
whole of K in f32; the scales multiply once, after it; the result is
rounded once to ``x``'s dtype. ``w`` is dense ``[E, K, N]`` (cast to
``x``'s dtype, as the JAX kernel's ``astype`` does: INT8 and bf16 values
widen exactly) or an INT8 :class:`QTensor` (``values [E, K, N]``,
``scales [E, 1, N]``; a dense weight has scales of 1).

The JAX wrapper zero-pads K and N to its blocks; the kernel masks the
ragged edge instead (the padding adds zeros). The wrapper runs the plain
version (:func:`grouped_matmul_plain`) for CPU tensors only; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Union

import torch

from ..quant.tensor import QTensor
from ..utils.platform import DTYPE_CODES, CudaKernel, I, P, ptr, \
    stream_handle
from .int8_matmul import same_device

GROUPED_MATMUL = CudaKernel(
    "grouped_matmul", "gmm.cu", "pbt_grouped_matmul",
    [P] * 5 + [I] * 7 + [P], "ops/gmm.py:65")

#: the kernel's row tiles (128 rows on the tensor cores, 64 on the CUDA
#: cores) must not straddle two row blocks, so ``bm`` is a multiple of 64
ROW_TILE = 64


def _check(x: torch.Tensor, w, group_of_block: torch.Tensor, bm: int):
    wv = w.values if isinstance(w, QTensor) else w
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("x must be [Npad, K] in float32 or bfloat16")
    if wv.dim() != 3 or wv.shape[1] != x.shape[1]:
        raise ValueError(f"w must be [E, K={x.shape[1]}, N], got "
                         f"{tuple(wv.shape)}")
    E, K, N = wv.shape
    if isinstance(w, QTensor):
        if wv.dtype != torch.int8 or w.scales.numel() != E * N:
            raise ValueError(f"a QTensor w needs int8 values and [E={E}, "
                             f"1, N={N}] scales")
    elif wv.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dense w must be float32 or bfloat16, got "
                         f"{wv.dtype}")
    Npad = x.shape[0]
    if bm <= 0 or Npad % bm:
        raise ValueError(f"bm={bm} must divide the row count {Npad}")
    if group_of_block.dim() != 1 or group_of_block.numel() != Npad // bm:
        raise ValueError(f"group_of_block must hold {Npad // bm} ids")
    return E, K, N


def grouped_matmul_plain(x: torch.Tensor, w: Union[torch.Tensor, QTensor],
                         group_of_block: torch.Tensor, *,
                         bm: int = 256) -> torch.Tensor:
    """Plain version of :func:`grouped_matmul` (same signature): per row
    block, an f32 product with its expert's weight cast to ``x``'s dtype,
    then the expert's scales, then one rounding."""
    E, K, N = _check(x, w, group_of_block, bm)
    quantized = isinstance(w, QTensor)
    wv = w.values if quantized else w
    gb = group_of_block.long()
    out = torch.empty((x.shape[0], N), dtype=x.dtype, device=x.device)
    for r in range(x.shape[0] // bm):
        e = gb[r:r + 1]                  # a device index: no host sync
        we = wv.index_select(0, e)[0].to(x.dtype).float()
        y = torch.matmul(x[r * bm:(r + 1) * bm].float(), we)
        if quantized:
            y = y * w.scales.reshape(E, N).index_select(0, e)
        out[r * bm:(r + 1) * bm] = y.to(x.dtype)
    return out


def grouped_matmul(x: torch.Tensor, w: Union[torch.Tensor, QTensor],
                   group_of_block: torch.Tensor, *,
                   bm: int = 256) -> torch.Tensor:
    """B13: ``x [Npad, K]`` (rows grouped, ranges ``bm``-aligned) times
    the expert ``group_of_block[r // bm]`` of ``w [E, K, N]`` (dense or an
    INT8 :class:`QTensor`); ``group_of_block [Npad // bm]`` int32 in
    ``[0, E)``. Returns ``[Npad, N]`` in ``x``'s dtype."""
    E, K, N = _check(x, w, group_of_block, bm)
    quantized = isinstance(w, QTensor)
    wv = w.values if quantized else w
    same_device(x, wv, group_of_block, w.scales if quantized else None)
    if not x.is_cuda:
        return grouped_matmul_plain(x, w, group_of_block, bm=bm)
    if bm % ROW_TILE:
        raise ValueError(f"the kernel takes bm a multiple of {ROW_TILE}, "
                         f"got {bm}")
    x, wv = x.contiguous(), wv.contiguous()
    gb = group_of_block.to(torch.int32).contiguous()
    scales = (w.scales.reshape(E, N).float().contiguous() if quantized
              else None)
    out = torch.empty((x.shape[0], N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    GROUPED_MATMUL.launch(ptr(x), ptr(wv), ptr(scales), ptr(gb), ptr(out),
                          x.shape[0], K, N, E, bm, DTYPE_CODES[x.dtype],
                          DTYPE_CODES[wv.dtype], stream_handle(x))
    return out
