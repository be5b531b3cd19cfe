"""INT4-weight matrix product: hand-written CUDA kernels
(``csrc/int4_matmul.cu``, on ``csrc/qmatmul.cuh`` and
``csrc/widen_gemm.cuh``) in place of the JAX package's Pallas
``w4_matmul`` (``ops/int4_matmul.py``, ``_w4_kernel``), B12:
``act(x @ dequant_int4(packed, scales) + bias)`` with f32 sums.

The carrier keeps the JAX package's block-local nibble layout for the
block width ``bn`` the quantizer picked (``quant/tensor.py``), and the
kernels take ``group`` and ``bn`` as arguments, so any weight the
quantizer makes goes through as it is. Three kernels, by :func:`w4_plan`:
the decode gemv (``M <= 16``), the bf16 tensor-core kernel past 16 rows
(bf16 x, ``bn/2 % 128 == 0``, ``group % 64 == 0``: every Llama-3 shape),
and the CUDA-core tiles for the rest; one launch count for all three.
:func:`w4_wgmma_emulation` is the tensor-core kernel's order of work in
plain PyTorch, for tests. The wrapper runs the plain version
(:func:`w4_matmul_plain`) for CPU tensors only; for CUDA tensors it
launches a kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..quant.tensor import Q4Tensor, dequantize_int4
from ..utils.common import cdiv, round_up
from ..utils.platform import (SMS, CudaKernel, I, P, aligned16, ptr,
                              split_counters, stream_handle)
from .int8_matmul import (GEMV_MAX_M, W8_K, act_code, bias_f32, epilogue,
                          out_code, same_device, scratch, x_code)

W4_MATMUL = CudaKernel(
    "w4_matmul", "int4_matmul.cu", "pbt_w4_matmul",
    [P] * 7 + [I] * 11 + [P], "ops/int4_matmul.py:110")

#: B12's kernels by route code (``pbt_w4_matmul``'s ``route``)
W4_ROUTES = {"tiles": 0, "gemv": 1, "wgmma": 2}
#: the tensor-core kernel's carrier columns a raw tile (two runs of 128
#: output columns), rows of an output tile and k-tile rows
#: (``csrc/widen_gemm.cuh``'s ``kW4C``, ``int4_matmul.cu``'s ``kBM``)
W4_CARRIER, W4_ROWS, W4_K = 128, 64, W8_K
#: the gemv's carrier bytes a block (8 lanes of 16) and the most K rows a
#: block stages times x's bf16 planes (``csrc/qmatmul.cuh``'s ``kW4Stage``)
W4_GEMV_CARRIER, W4_GEMV_STAGE = 128, 4096
#: the gemv's warps a block (``csrc/qmatmul.cuh``'s ``kWarps``)
W4_GEMV_WARPS = 8


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


def w4_unit(group: int) -> int:
    """The gemv's unit of K rows inside one K-group (``csrc/qmatmul.cuh``'s
    ``w4_unit``): 64, or the group where it is no multiple of 64."""
    return 64 if group % 64 == 0 else group


def w4_gemv_plan(M: int, K: int, N: int, group: int, bn: int, x_dtype
                 ) -> Optional[Tuple[int, int]]:
    """The decode gemv's ``(splits, k_per_split)``, or None where its
    layout does not fit (``bn/2 % 16``, a unit of K rows that is no
    multiple of 16 or more than a block stages). The K range of a block is
    whole units (whole rounds of its 8 warps where K allows), with as many
    splits as bring the grid (256 columns and 8 rows of x a block) to at
    most one wave of the SMs (one block an SM holds: its lanes keep 2 x 64
    sums each; a second wave, or a split, adds a block's fixed cost) and
    no block staging more than :data:`W4_GEMV_STAGE` rows of x times its
    planes (three for f32 x, one for bf16)."""
    U = w4_unit(group)
    stage = W4_GEMV_STAGE // (1 if x_dtype == torch.bfloat16 else 3)
    if (bn // 2) % 16 or U % 16 or U > stage or K % U:
        return None
    units = K // U
    base = cdiv(N // 2, W4_GEMV_CARRIER) * cdiv(M, 8)
    ups = round_up(cdiv(units, max(1, SMS // base)), W4_GEMV_WARPS)
    ups = max(1, min(ups, stage // U, units))
    return cdiv(units, ups), ups * U


def w4_plan(M: int, K: int, N: int, group: int, bn: int, x_dtype,
            aligned: bool = True) -> Tuple[str, int, int]:
    """B12's ``(route, splits, k_per_split)``: ``"gemv"`` through 16 rows
    where :func:`w4_gemv_plan` takes the layout; past 16 rows
    ``"wgmma"`` for bf16 x with ``bn/2 % 128 == 0`` and ``group % 64 ==
    0`` (K split by :func:`~.int8_matmul.wgmma_plan`'s rule over the
    kernel's 64 x 256 output tiles and k-tiles of 64); ``"tiles"`` (the
    CUDA-core kernel, whole K) for the rest: f32 x past 16 rows, other
    layouts. ``aligned``: the carrier and the scales start on 16 bytes
    (both fast routes read them 16 bytes at a time)."""
    if M <= GEMV_MAX_M:
        gemv = w4_gemv_plan(M, K, N, group, bn, x_dtype) if aligned \
            else None
        return ("gemv",) + gemv if gemv else ("tiles", 1, K)
    if x_dtype == torch.bfloat16 and aligned and (bn // 2) % W4_CARRIER == 0 \
            and group % W4_K == 0:
        nk = K // W4_K
        tiles = cdiv(M, W4_ROWS) * (N // (2 * W4_CARRIER))
        want = max(1, min(SMS // tiles, nk, 16))
        per = cdiv(nk, want)
        return "wgmma", cdiv(nk, per), per * W4_K
    return "tiles", 1, K


def w4_scratch(device, M: int, N: int, splits: int):
    """The tensor-core kernel's split-K workspace (None for one split): an
    f32 slot of ``64 x 256`` per split and output tile, and the tiles'
    counters."""
    if splits == 1:
        return None, None
    tiles = cdiv(M, W4_ROWS) * (N // (2 * W4_CARRIER))
    return (torch.empty((splits, tiles, W4_ROWS * 2 * W4_CARRIER),
                        dtype=torch.float32, device=device),
            split_counters(device, tiles))


def w4_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                    scales: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, *, group: int,
                    bn: int, act: Optional[str] = None,
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of :func:`w4_matmul` (same signature): the f32
    dequantized weight, an f32 product, bias, activation."""
    w = dequantize_int4(Q4Tensor(packed, scales, group, bn))
    return epilogue(torch.matmul(x.float(), w), bias, act, out_dtype)


def w4_wgmma_emulation(x: torch.Tensor, packed: torch.Tensor,
                       scales: torch.Tensor,
                       bias: Optional[torch.Tensor] = None, *, group: int,
                       bn: int, act: Optional[str] = None,
                       out_dtype=torch.bfloat16,
                       splits: Optional[int] = None) -> torch.Tensor:
    """The tensor-core kernel's order of work in plain PyTorch (f32), for
    tests: each raw tile, a run of 128 carrier columns inside a ``bn``
    block, unpacked from the carrier as the kernel widens it (low nibbles
    ``q + 8``, high nibbles two's complement) into the two runs of 128
    output columns it feeds; each K-group's product of x and those exact
    values summed on its own, and folded into the tile's sums with that
    group's scales in group order (a group cut by a split's end folded
    there); the splits (:func:`w4_plan`'s by default) added in split
    order; then the epilogue. Same inputs and output as
    :func:`w4_matmul_plain`, which it equals up to the order of the sums
    and the place of the scale."""
    M, K, N = _check(x, packed, scales, group, bn)
    half = bn // 2
    if half % W4_CARRIER or group % W4_K:
        raise ValueError("the tensor-core layout needs bn/2 % 128 == 0 and "
                         "group % 64 == 0")
    if splits is None:
        splits = w4_plan(max(M, GEMV_MAX_M + 1), K, N, group, bn,
                         torch.bfloat16)[1]
    per = cdiv(K // W4_K, splits) * W4_K       # rows a split
    xf = x.float()
    p = packed.to(torch.int32) & 0xFF
    out = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    for c0 in range(0, N // 2, W4_CARRIER):
        j, t0 = divmod(c0, half)
        cols = {"lo": j * bn + t0, "hi": j * bn + half + t0}
        run = p[:, c0:c0 + W4_CARRIER]
        vals = {"lo": ((run & 0xF) - 8).float(),
                "hi": ((((run >> 4) & 0xF) ^ 8) - 8).float()}
        for name, n0 in cols.items():
            tile = torch.zeros((M, W4_CARRIER), device=x.device)
            for k0 in range(0, K, per):
                total = torch.zeros_like(tile)
                k1 = min(K, k0 + per)
                g0 = k0
                while g0 < k1:
                    g1 = min(k1, (g0 // group + 1) * group)
                    part = xf[:, g0:g1] @ vals[name][g0:g1]
                    total = total + part * scales[g0 // group,
                                                  n0:n0 + W4_CARRIER]
                    g0 = g1
                tile = tile + total
            out[:, n0:n0 + W4_CARRIER] = tile
    return epilogue(out, bias, act, out_dtype)


def w4_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
              bias: Optional[torch.Tensor] = None, *, group: int, bn: int,
              act: Optional[str] = None,
              out_dtype=torch.bfloat16) -> torch.Tensor:
    """B12: ``act((x @ dequant_int4(packed, scales)) + bias)``.

    x ``[M, K]`` bf16/f32; packed ``[K, N/2]`` int8 in
    :func:`~..quant.tensor.pack_int4`'s layout for ``bn``; scales
    ``[K/group, N]`` f32. Returns ``[M, N]`` in ``out_dtype``. The kernel
    by :func:`w4_plan`."""
    M, K, N = _check(x, packed, scales, group, bn)
    same_device(x, packed, scales, bias)
    if not x.is_cuda:
        return w4_matmul_plain(x, packed, scales, bias, group=group, bn=bn,
                               act=act, out_dtype=out_dtype)
    codes = act_code(act), x_code(x), out_code(out_dtype)
    x, packed, scales = x.contiguous(), packed.contiguous(), \
        scales.contiguous()
    b = bias_f32(bias, N)
    route, splits, kps = w4_plan(
        M, K, N, group, bn, x.dtype,
        packed.data_ptr() % 16 == 0 and scales.data_ptr() % 16 == 0)
    if route != "tiles":          # both fast routes read x 16 bytes a time
        x = aligned16(x)
    if route == "wgmma":
        part, counters = w4_scratch(x.device, M, N, splits)
    else:
        part, counters = scratch(x.device, M, N, splits, torch.float32)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    W4_MATMUL.launch(ptr(x), ptr(packed), ptr(scales), ptr(b), ptr(out),
                     ptr(part), ptr(counters), M, K, N, group, bn, splits,
                     kps, W4_ROUTES[route], *codes, stream_handle(x))
    return out
