"""INT8-weight matrix products: two hand-written CUDA kernels
(``csrc/int8_matmul.cu``, on ``csrc/qmatmul.cuh``), one per Pallas
kernel of the JAX package's ``ops/int8_matmul.py``:

* :func:`int8_matmul` (B10) replaces ``int8_matmul`` (``_kernel``):
  ``act((xq @ wq) * x_scale * w_scale + bias)``, s8 x s8 summed in s32,
  then an f32 epilogue in that order and one rounding. Exact sums, so
  the kernel, :func:`int8_matmul_plain` and the JAX kernel agree bit for
  bit.
* :func:`w8_matmul` (B11) replaces ``w8_matmul`` (``_w8_kernel``):
  ``act((x @ widen(wq)) * w_scale + bias)`` with f32 sums.

Both take any ``M >= 1``, ``K`` and ``N``: no padding to the TPU's
blocks, so the block-size arguments of the JAX wrappers are gone. The
wrapper runs the plain version for CPU tensors only; for CUDA tensors it
launches the kernel or raises. The kernel's launch shape (a matrix-vector
kernel with K split across blocks for decode, a tiled one otherwise) is
chosen here by :func:`plan`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils.common import cdiv, round_up
from ..utils.platform import (DTYPE_CODES, CudaKernel, I, P, ptr,
                              stream_handle)
from .common import activation_fn

#: activation codes of csrc/qmatmul.cuh (``ops/common.py`` names)
ACT_CODES = {None: 0, "relu": 1, "gelu": 2, "silu": 3, "swiglu": 3}
#: streaming multiprocessors of the H100; decode grids aim at 2 blocks each
SMS = 132
#: rows up to which the matrix-vector kernel serves (4 rows per block)
GEMV_MAX_M = 16
#: columns of one matrix-vector block
GEMV_COLS = 128
#: K rows per exact f32 partial product in :func:`exact_int_matmul`:
#: 128 * 128 * 1024 = 2^24, so every partial sum is an exact f32 integer
_EXACT_K = 1024

INT8_MATMUL = CudaKernel(
    "int8_matmul", "int8_matmul.cu", "pbt_int8_matmul",
    [P] * 8 + [I] * 8 + [P], "ops/int8_matmul.py:131")
W8_MATMUL = CudaKernel(
    "w8_matmul", "int8_matmul.cu", "pbt_w8_matmul",
    [P] * 7 + [I] * 9 + [P], "ops/int8_matmul.py:82")

#: split-K tile counters by (device, stream): launches on one stream run
#: in order, so no two launches in flight share a counter
_COUNTERS = {}


def plan(M: int, K: int, N: int, gemv_ok: bool) -> Tuple[bool, int, int]:
    """``(gemv, splits, k_per_split)`` for a launch: the matrix-vector
    kernel for ``M <= 16`` where the shapes allow it, with K split
    across blocks until the grid has about two blocks per SM (each split
    at least 128 rows, a multiple of 4); else the tiled kernel."""
    if not gemv_ok or M > GEMV_MAX_M:
        return False, 1, K
    base = cdiv(N, GEMV_COLS) * cdiv(M, 4)
    splits = max(1, min(cdiv(2 * SMS, base), cdiv(K, 128)))
    kps = round_up(cdiv(K, splits), 4)
    return True, cdiv(K, kps), kps


def act_code(act: Optional[str]) -> int:
    if act not in ACT_CODES:
        raise ValueError(f"unknown activation {act!r}")
    return ACT_CODES[act]


def out_code(out_dtype) -> int:
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype {out_dtype} not supported "
                         "(float32 or bfloat16)")
    return DTYPE_CODES[out_dtype]


def x_code(x: torch.Tensor) -> int:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x dtype {x.dtype} not supported "
                         "(float32 or bfloat16)")
    return DTYPE_CODES[x.dtype]


def same_device(*ts) -> None:
    dev = ts[0].device
    if any(t is not None and t.device != dev for t in ts):
        raise ValueError("all operands must share one device")


def bias_f32(bias: Optional[torch.Tensor], N: int):
    if bias is None:
        return None
    if bias.numel() != N:
        raise ValueError(f"bias has {bias.numel()} elements, expected {N}")
    return bias.reshape(N).float().contiguous()


def scratch(device, M: int, N: int, splits: int, dtype):
    """The split-K workspace ``[splits, M, N]`` (None for one split) and
    the per-tile counters of the current stream (zeroed once per device
    and stream; the kernel's last block of each tile resets its
    counter)."""
    if splits == 1:
        return None, None
    need = cdiv(N, GEMV_COLS) * cdiv(M, 4)
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    counters = _COUNTERS.get(key)
    if counters is None or counters.numel() < need:
        counters = _COUNTERS[key] = torch.zeros(
            max(need, 4096), dtype=torch.int32, device=device)
    return torch.empty((splits, M, N), dtype=dtype, device=device), counters


def epilogue(y: torch.Tensor, bias, act, out_dtype,
             scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``act(y * scale + bias)`` in f32 on ``y`` (f32), then one
    rounding. With a scale and a bias the two are one fused multiply-add,
    as XLA compiles the JAX epilogue (``y * w_scale + b``); the f32
    product is exact in f64, so the f64 sum rounded to f32 is that FMA
    (up to a double-rounding tie, which needs 29 trailing bits of the sum
    to line up)."""
    if scale is not None and bias is not None:
        y = (y.double() * scale.double() + bias.double()).float()
    elif scale is not None:
        y = y * scale.float()
    elif bias is not None:
        y = y + bias.float()
    if act is not None:
        y = activation_fn(act)(y)
    return y.to(out_dtype)


def exact_int_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """``xq [M, K] @ wq [K, N]`` of int8 operands, exactly, as int32:
    f32 products over K-chunks whose sums stay exact integers, added in
    int32 (no device has an int8 matmul for every M)."""
    K = xq.shape[1]
    acc = torch.zeros((xq.shape[0], wq.shape[1]), dtype=torch.int32,
                      device=xq.device)
    for k0 in range(0, K, _EXACT_K):
        k1 = min(k0 + _EXACT_K, K)
        acc += torch.matmul(xq[:, k0:k1].float(),
                            wq[k0:k1].float()).to(torch.int32)
    return acc


def int8_matmul_plain(xq: torch.Tensor, x_scale: torch.Tensor,
                      wq: torch.Tensor, w_scale: torch.Tensor,
                      bias: Optional[torch.Tensor] = None, *,
                      act: Optional[str] = None,
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of :func:`int8_matmul` (same signature)."""
    y = exact_int_matmul(xq, wq).float() * x_scale.float().reshape(-1, 1)
    return epilogue(y, bias, act, out_dtype, w_scale.reshape(1, -1))


def w8_matmul_plain(x: torch.Tensor, wq: torch.Tensor,
                    w_scale: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, *,
                    act: Optional[str] = None,
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of :func:`w8_matmul` (same signature): an f32
    product (bf16 x int8 products are exact in f32), then the scales."""
    return epilogue(torch.matmul(x.float(), wq.float()), bias, act,
                    out_dtype, w_scale.reshape(1, -1))


def _check_weight(wq: torch.Tensor, w_scale: torch.Tensor, K: int) -> int:
    if wq.dtype != torch.int8 or wq.dim() != 2 or wq.shape[0] != K:
        raise ValueError(f"wq must be int8 [K={K}, N], got {wq.dtype} "
                         f"{tuple(wq.shape)}")
    N = wq.shape[1]
    if w_scale.numel() != N:
        raise ValueError(f"w_scale has {w_scale.numel()} elements, "
                         f"expected {N}")
    return N


def int8_matmul(xq: torch.Tensor, x_scale: torch.Tensor, wq: torch.Tensor,
                w_scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
                *, act: Optional[str] = None,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """B10: ``act((xq @ wq) * x_scale * w_scale + bias)``.

    xq ``[M, K]`` int8, x_scale ``[M, 1]`` f32 (per row); wq ``[K, N]``
    int8, w_scale ``[1, N]`` f32 (per output channel). Returns ``[M, N]``
    in ``out_dtype`` (bf16 or f32)."""
    if xq.dtype != torch.int8 or xq.dim() != 2:
        raise ValueError("xq must be int8 [M, K]")
    M, K = xq.shape
    N = _check_weight(wq, w_scale, K)
    if x_scale.numel() != M:
        raise ValueError(f"x_scale has {x_scale.numel()} elements, "
                         f"expected {M}")
    same_device(xq, x_scale, wq, w_scale, bias)
    if not xq.is_cuda:
        return int8_matmul_plain(xq, x_scale, wq, w_scale, bias, act=act,
                                 out_dtype=out_dtype)
    codes = act_code(act), out_code(out_dtype)
    xq, wq = xq.contiguous(), wq.contiguous()
    xs = x_scale.reshape(M).float().contiguous()
    ws = w_scale.reshape(N).float().contiguous()
    b = bias_f32(bias, N)
    gemv, splits, kps = plan(M, K, N, N % 16 == 0 and K % 4 == 0
                             and wq.data_ptr() % 16 == 0
                             and xq.data_ptr() % 4 == 0)
    part, counters = scratch(xq.device, M, N, splits, torch.int32)
    out = torch.empty((M, N), dtype=out_dtype, device=xq.device)
    INT8_MATMUL.launch(ptr(xq), ptr(xs), ptr(wq), ptr(ws), ptr(b), ptr(out),
                       ptr(part), ptr(counters), M, K, N, splits, kps,
                       int(gemv), *codes, stream_handle(xq))
    return out


def w8_matmul(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
              bias: Optional[torch.Tensor] = None, *,
              act: Optional[str] = None,
              out_dtype=torch.bfloat16) -> torch.Tensor:
    """B11, weight-only INT8: ``act((x @ widen(wq)) * w_scale + bias)``.

    x ``[M, K]`` bf16/f32; wq ``[K, N]`` int8; w_scale ``[1, N]`` f32.
    Returns ``[M, N]`` in ``out_dtype`` (bf16 or f32)."""
    if x.dim() != 2:
        raise ValueError("x must be [M, K]")
    M, K = x.shape
    N = _check_weight(wq, w_scale, K)
    same_device(x, wq, w_scale, bias)
    if not x.is_cuda:
        return w8_matmul_plain(x, wq, w_scale, bias, act=act,
                               out_dtype=out_dtype)
    codes = act_code(act), x_code(x), out_code(out_dtype)
    x, wq = x.contiguous(), wq.contiguous()
    ws = w_scale.reshape(N).float().contiguous()
    b = bias_f32(bias, N)
    gemv, splits, kps = plan(M, K, N, N % 16 == 0
                             and wq.data_ptr() % 16 == 0)
    part, counters = scratch(x.device, M, N, splits, torch.float32)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    W8_MATMUL.launch(ptr(x), ptr(wq), ptr(ws), ptr(b), ptr(out), ptr(part),
                     ptr(counters), M, K, N, splits, kps, int(gemv), *codes,
                     stream_handle(x))
    return out
