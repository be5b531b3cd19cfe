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

``block_rows [Npad // bm]`` (optional, int32): the routed rows at the
front of each row block (``models/model.py::dispatch_block_rows``). Rows
at or past ``block_rows[r]`` of block ``r`` come out as zeros, in the
kernel and the plain version alike: what the JAX kernel returns on the
dispatch's zero rows, so the MoE output is unchanged; the kernel computes
no product for a row tile that holds no routed row. Without it every row
is computed.

One entry point, ``GROUPED_MATMUL``, over two CUDA kernels chosen by
``x``'s dtype alone: bf16 ``x`` takes ``wgmma_kernel`` (TMA loads, the
weights widened to bf16 in shared memory, ``wgmma``), f32 ``x`` a
CUDA-core tiled product. The tensor-core kernel reads whole 16-byte rows
of INT8 or bf16 experts, so :func:`wgmma_operands` rounds f32 experts to
bf16 (the cast the kernel would make) and zero-pads a ragged K and N, as
the JAX wrapper zero-pads them to its blocks (the padding adds zeros);
every card path's widths already fit. The wrapper runs the plain version
(:func:`grouped_matmul_plain`) for CPU tensors only; for CUDA tensors it
launches a kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from ..quant.tensor import QTensor
from ..utils.platform import DTYPE_CODES, CudaKernel, I, P, aligned16, \
    ptr, stream_handle
from .int8_matmul import same_device

GROUPED_MATMUL = CudaKernel(
    "grouped_matmul", "gmm.cu", "pbt_grouped_matmul",
    [P] * 6 + [I] * 7 + [P], "ops/gmm.py:65")

#: the kernels' row tiles (128 rows, or 64 where ``bm`` is no multiple of
#: 128) must not straddle two row blocks, so ``bm`` is a multiple of 64
ROW_TILE = 64


def wgmma_operands(x: torch.Tensor, wv: torch.Tensor,
                   scales: Optional[torch.Tensor]):
    """bf16 ``x [Npad, K]``, expert values ``wv [E, K, N]`` and their
    scales ``[E, N]`` (or None) as the tensor-core kernel reads them:
    f32 experts rounded to bf16 (to nearest even, the cast the product
    makes anyway); K zero-padded to a multiple of 8 and N to 16 (INT8) or
    8 (bf16), so that every row is whole 16-byte units; each operand
    16-byte aligned. Returns ``(x, wv, scales, padded N)``; the columns
    past N are the caller's to drop."""
    if wv.dtype == torch.float32:
        wv = wv.to(torch.bfloat16)
    K, N = wv.shape[1], wv.shape[2]
    unit = 16 if wv.dtype == torch.int8 else 8
    dk, dn = -K % 8, -N % unit
    if dk:
        x = F.pad(x, (0, dk))
    if dk or dn:
        wv = F.pad(wv, (0, dn, 0, dk))
    if dn and scales is not None:
        scales = F.pad(scales, (0, dn))
    return aligned16(x), aligned16(wv), scales, N + dn


def _check(x: torch.Tensor, w, group_of_block: torch.Tensor, bm: int,
           block_rows: Optional[torch.Tensor] = None):
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
    if K == 0:
        raise ValueError("K must be positive")
    Npad = x.shape[0]
    if bm <= 0 or Npad % bm:
        raise ValueError(f"bm={bm} must divide the row count {Npad}")
    if group_of_block.dim() != 1 or group_of_block.numel() != Npad // bm:
        raise ValueError(f"group_of_block must hold {Npad // bm} ids")
    if block_rows is not None and (block_rows.dim() != 1
                                   or block_rows.numel() != Npad // bm):
        raise ValueError(f"block_rows must hold {Npad // bm} counts")
    return E, K, N


def grouped_matmul_plain(x: torch.Tensor, w: Union[torch.Tensor, QTensor],
                         group_of_block: torch.Tensor, *, bm: int = 256,
                         block_rows: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Plain version of :func:`grouped_matmul` (same signature): per row
    block, an f32 product with its expert's weight cast to ``x``'s dtype,
    then the expert's scales, then one rounding; rows at or past
    ``block_rows`` zeros."""
    E, K, N = _check(x, w, group_of_block, bm, block_rows)
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
    if block_rows is not None:
        live = (torch.arange(bm, device=x.device)[None, :]
                < block_rows.to(x.device)[:, None]).reshape(-1, 1)
        out = torch.where(live, out, torch.zeros((), dtype=out.dtype,
                                                  device=out.device))
    return out


def grouped_matmul(x: torch.Tensor, w: Union[torch.Tensor, QTensor],
                   group_of_block: torch.Tensor, *, bm: int = 256,
                   block_rows: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """B13: ``x [Npad, K]`` (rows grouped, ranges ``bm``-aligned) times
    the expert ``group_of_block[r // bm]`` of ``w [E, K, N]`` (dense or an
    INT8 :class:`QTensor`); ``group_of_block [Npad // bm]`` int32 in
    ``[0, E)``; ``block_rows`` as the module says. Returns ``[Npad, N]``
    in ``x``'s dtype."""
    E, K, N = _check(x, w, group_of_block, bm, block_rows)
    quantized = isinstance(w, QTensor)
    wv = w.values if quantized else w
    same_device(x, wv, group_of_block, w.scales if quantized else None,
                block_rows)
    if not x.is_cuda:
        return grouped_matmul_plain(x, w, group_of_block, bm=bm,
                                    block_rows=block_rows)
    if bm % ROW_TILE:
        raise ValueError(f"the kernels take bm a multiple of {ROW_TILE}, "
                         f"got {bm}")
    x, wv = x.contiguous(), wv.contiguous()
    gb = group_of_block.to(torch.int32).contiguous()
    rows = (None if block_rows is None
            else block_rows.to(torch.int32).contiguous())
    scales = (w.scales.reshape(E, N).float().contiguous() if quantized
              else None)
    n_out = N
    if x.dtype == torch.bfloat16:
        x, wv, scales, n_out = wgmma_operands(x, wv, scales)
    out = torch.empty((x.shape[0], n_out), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out[:, :N]
    GROUPED_MATMUL.launch(ptr(x), ptr(wv), ptr(scales), ptr(gb), ptr(rows),
                          ptr(out), x.shape[0], x.shape[1], n_out, E, bm,
                          DTYPE_CODES[x.dtype], DTYPE_CODES[wv.dtype],
                          stream_handle(x))
    return out if n_out == N else out[:, :N].contiguous()
