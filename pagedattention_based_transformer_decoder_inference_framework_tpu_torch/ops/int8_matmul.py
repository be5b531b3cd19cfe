"""INT8-weight matrix products: hand-written CUDA kernels
(``csrc/int8_matmul.cu``, on ``csrc/qmatmul.cuh``, ``csrc/imma.cuh`` and
``csrc/widen_gemm.cuh``), one entry per Pallas kernel of the JAX
package's ``ops/int8_matmul.py``:

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
launches the kernel or raises. The kernel and its launch shape are
chosen here: decode (``M <= 16``) takes, for B10, a matrix-vector kernel
with K split across blocks (:func:`plan`), and for B11 the tensor-core
matrix-vector kernel (``gemv_w8_kernel``: INT8 weights widened to bf16
as the A operand of ``mma.sync``, streamed through a ring in shared
memory, x staged once; :func:`w8_gemv_plan`); larger ``M`` takes, for
B10, the INT8 tensor-core kernel (``csrc/imma.cuh``: ``wgmma`` s8 x s8 ->
s32 on weight tiles transposed on chip), and for B11 with bf16 ``x`` the
bf16 tensor-core kernel (``w8_wgmma_kernel``: the INT8 weight widened to
bf16 in shared memory, ``wgmma`` with f32 sums), each with K split only
where its output tiles fall short of the SMs (:func:`wgmma_plan`); B11
with f32 ``x`` past 16 rows takes a CUDA-core tiled kernel
(:func:`w8_plan`). The tensor-core kernels read whole 16-byte rows, so
:func:`int8_operands`, :func:`w8_operands` and
:func:`w8_gemv_operands` zero-pad a ragged K (and N where the kernel
needs it) and copy a view at an odd offset: the shapes never pick the
kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.common import cdiv, round_up
from ..utils.platform import (DTYPE_CODES, SMS, CudaKernel, I, P, aligned16,
                              ptr, split_counters, stream_handle)
from .common import activation_fn

#: activation codes of csrc/qmatmul.cuh (``ops/common.py`` names)
ACT_CODES = {None: 0, "relu": 1, "gelu": 2, "silu": 3, "swiglu": 3}
#: rows up to which the matrix-vector kernel serves (4 rows per block)
GEMV_MAX_M = 16
#: columns of one matrix-vector block
GEMV_COLS = 128
#: the tensor-core kernel's output columns a block and k-tile rows
#: (csrc/imma.cuh); its row tiles are 64 rows where M <= 64, else 128
WGMMA_COLS, WGMMA_K = 128, 128
#: B11's tensor-core kernel's output columns a block and k-tile rows
#: (``csrc/widen_gemm.cuh``); its row tiles are :func:`wgmma_rows`'
W8_COLS, W8_K = 256, 64
#: B11's kernels by route code (``pbt_w8_matmul``'s ``route``)
W8_ROUTES = {"tiles": 0, "gemv": 1, "wgmma": 2}
#: B11's matrix-vector kernel (``csrc/qmatmul.cuh``'s ``gemv_w8_kernel``):
#: columns of a tile, rows of a k-step, warps a block (each taking the
#: tile's k-steps in turn), and the 4-byte words of x's stage
W8_GEMV_COLS, W8_GEMV_K, W8_GEMV_WARPS, W8_GEMV_STAGE = 128, 16, 8, 16384
#: K splits the tensor-core planner weighs at most
_MAX_SPLITS = 16
#: K rows per exact f32 partial product in :func:`exact_int_matmul`:
#: 128 * 128 * 1024 = 2^24, so every partial sum is an exact f32 integer
_EXACT_K = 1024

INT8_MATMUL = CudaKernel(
    "int8_matmul", "int8_matmul.cu", "pbt_int8_matmul",
    [P] * 8 + [I] * 8 + [P], "ops/int8_matmul.py:131")
W8_MATMUL = CudaKernel(
    "w8_matmul", "int8_matmul.cu", "pbt_w8_matmul",
    [P] * 7 + [I] * 9 + [P], "ops/int8_matmul.py:82")

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


def wgmma_rows(M: int) -> int:
    """Rows of the tensor-core kernel's output tile for ``M`` rows."""
    return 64 if M <= 64 else 128


def wgmma_tiles(M: int, N: int, cols: int = WGMMA_COLS) -> int:
    return cdiv(M, wgmma_rows(M)) * cdiv(N, cols)


def wgmma_plan(M: int, K: int, N: int, cols: int = WGMMA_COLS,
               k_tile: int = WGMMA_K) -> Tuple[int, int]:
    """``(splits, k_per_split)`` of a tensor-core kernel with output
    tiles of ``cols`` columns and k-tiles of ``k_tile`` (B10 at M > 16
    and B15 under w8a8 with the defaults; B11 with :data:`W8_COLS` and
    :data:`W8_K`): one block per output tile over the whole of K where
    the tiles fill the SMs; else K split into ranges of whole k-tiles, as
    many as still fit the blocks in one wave (at most ``_MAX_SPLITS``):
    past one wave a split adds a round of blocks and its partial sums'
    traffic for no more parallel work."""
    nk = cdiv(K, k_tile)
    want = max(1, min(SMS // wgmma_tiles(M, N, cols), nk, _MAX_SPLITS))
    per = cdiv(nk, want)
    return cdiv(nk, per), per * k_tile


def int8_plan(M: int, K: int, N: int) -> Tuple[bool, int, int]:
    """B10's ``(gemv, splits, k_per_split)`` for operands as
    :func:`int8_operands` leaves them: the matrix-vector kernel for ``M <=
    16`` (:func:`plan`), the tensor-core kernel past it."""
    if M <= GEMV_MAX_M:
        return plan(M, K, N, True)
    return (False,) + wgmma_plan(M, K, N)


def w8_gemv_rows(M: int) -> int:
    """Rows of x that B11's matrix-vector kernel stages for ``M`` rows (a
    power of two; 16, two n-tiles of 8, past 8 rows)."""
    return 16 if M > 8 else 8 if M > 4 else 4 if M > 2 else M


def w8_gemv_plan(M: int, K: int, N: int, x_dtype) -> Tuple[int, int]:
    """``(splits, k_per_split)`` of B11's matrix-vector kernel for ``M <=
    16`` and ``K % 16 == 0`` (:func:`w8_gemv_operands` pads K): a tile is
    128 columns over one K split; the grid is at most one block an SM,
    each walking tiles ``b, b + grid, ...``, so no split is needed where
    the column tiles reach the SMs. K is split where a split's rows of x
    (times x's bf16 planes: three for f32 x) would not fit the stage, and
    further where the column tiles alone fall short of the SMs: into as
    many splits as still fit one wave of tiles (each at least one k-step
    a warp). Each split is a whole number of 16-row k-steps; the last may
    be shorter."""
    planes = 1 if x_dtype == torch.bfloat16 else 3
    kmax = 2 * W8_GEMV_STAGE // (planes * w8_gemv_rows(M)) \
        // W8_GEMV_K * W8_GEMV_K
    steps = cdiv(K, W8_GEMV_K)
    tiles = cdiv(N, W8_GEMV_COLS)
    splits = cdiv(K, kmax)
    if tiles * splits < SMS:
        splits = max(splits, min(SMS // tiles, cdiv(steps, W8_GEMV_WARPS)))
    kps = cdiv(steps, splits) * W8_GEMV_K
    return cdiv(K, kps), kps


def w8_plan(M: int, K: int, N: int, x_dtype,
            gemv_ok: bool = True) -> Tuple[str, int, int]:
    """B11's ``(route, splits, k_per_split)``, by M and x's dtype, for
    operands as the wrapper leaves them (:func:`w8_gemv_operands` on the
    matrix-vector route, :func:`w8_operands` on the tensor-core route):
    ``"gemv"`` through 16 rows where the weight allows it (``gemv_ok``: N
    a multiple of 16, the weight on 16 bytes; :func:`w8_gemv_plan`),
    ``"wgmma"`` past 16 rows for bf16 x (K split by :func:`wgmma_plan`
    over 256-column tiles and k-tiles of 64), and ``"tiles"`` (the
    CUDA-core kernel, whole K) for the rest: f32 x past 16 rows (the
    tensor cores have no exact f32 product) or a ragged N at decode."""
    if M <= GEMV_MAX_M:
        if not gemv_ok:
            return "tiles", 1, K
        return ("gemv",) + w8_gemv_plan(M, K, N, x_dtype)
    if x_dtype == torch.bfloat16:
        return ("wgmma",) + wgmma_plan(M, K, N, W8_COLS, W8_K)
    return "tiles", 1, K


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
    """The matrix-vector kernel's split-K workspace ``[splits, M, N]``
    (None for one split) and its tile counters."""
    if splits == 1:
        return None, None
    return (torch.empty((splits, M, N), dtype=dtype, device=device),
            split_counters(device, cdiv(N, GEMV_COLS) * cdiv(M, 4)))


def wgmma_scratch(device, M: int, N: int, splits: int):
    """The tensor-core kernel's split-K workspace (None for one split):
    an s32 slot of ``rows x 128`` per split and output tile, and the
    tiles' counters."""
    if splits == 1:
        return None, None
    tiles = wgmma_tiles(M, N)
    return (torch.empty((splits, tiles, wgmma_rows(M) * WGMMA_COLS),
                        dtype=torch.int32, device=device),
            split_counters(device, tiles))


def w8_scratch(device, M: int, N: int, splits: int):
    """B11's tensor-core split-K workspace (None for one split): an f32
    slot of ``rows x 256`` per split and output tile, and the tiles'
    counters."""
    if splits == 1:
        return None, None
    tiles = wgmma_tiles(M, N, W8_COLS)
    return (torch.empty((splits, tiles, wgmma_rows(M) * W8_COLS),
                        dtype=torch.float32, device=device),
            split_counters(device, tiles))


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


def x_planes(x: torch.Tensor) -> list:
    """x as the bf16 planes B11's matrix-vector kernel stages (as f32
    tensors): bf16 x itself; f32 x as three bf16 that sum to it exactly
    (``x1 = bf16(x)``, ``x2 = bf16(x - x1)``, ``x3 = x - x1 - x2``: each
    difference exact, f32's 24 significant bits in three of 8)."""
    if x.dtype == torch.bfloat16:
        return [x.float()]
    planes, r = [], x.float()
    for _ in range(3):
        p = r.to(torch.bfloat16).float()
        planes.append(p)
        r = r - p
    return planes


def w8_gemv_emulation(x: torch.Tensor, wq: torch.Tensor,
                      w_scale: torch.Tensor,
                      bias: Optional[torch.Tensor] = None, *,
                      act: Optional[str] = None, out_dtype=torch.bfloat16,
                      splits: Optional[int] = None) -> torch.Tensor:
    """B11's matrix-vector kernel's order of work in plain PyTorch (f32),
    for tests: K zero-padded to 16; each split of K (:func:`w8_gemv_plan`'s
    by default) summed on its own: each of the block's warps over its
    16-row k-steps w, w + 8, ... (x's planes of :func:`x_planes` times the
    exact INT8 values), the warps added in warp order; the splits added
    in split order; then the epilogue. Same inputs and output as
    :func:`w8_matmul_plain`, which it equals up to the order of the
    sums."""
    M, K = x.shape
    dk = -K % W8_GEMV_K
    xs = [F.pad(p, (0, dk)) for p in x_planes(x)]
    w = F.pad(wq, (0, 0, 0, dk)).float()
    Kp = K + dk
    if splits is None:
        splits = w8_gemv_plan(M, Kp, wq.shape[1], x.dtype)[0]
    kps = cdiv(Kp // W8_GEMV_K, splits) * W8_GEMV_K
    total = None
    for k0 in range(0, Kp, kps):
        k1 = min(Kp, k0 + kps)
        part = None
        for warp in range(W8_GEMV_WARPS):
            acc = torch.zeros((M, wq.shape[1]), device=x.device)
            for ks in range(k0 + warp * W8_GEMV_K, k1,
                            W8_GEMV_WARPS * W8_GEMV_K):
                for p in xs:
                    acc = acc + p[:, ks:ks + W8_GEMV_K] @ \
                        w[ks:ks + W8_GEMV_K]
            part = acc if part is None else part + acc
        total = part if total is None else total + part
    return epilogue(total, bias, act, out_dtype, w_scale.reshape(1, -1))


def _check_weight(wq: torch.Tensor, w_scale: torch.Tensor, K: int) -> int:
    if wq.dtype != torch.int8 or wq.dim() != 2 or wq.shape[0] != K:
        raise ValueError(f"wq must be int8 [K={K}, N], got {wq.dtype} "
                         f"{tuple(wq.shape)}")
    N = wq.shape[1]
    if w_scale.numel() != N:
        raise ValueError(f"w_scale has {w_scale.numel()} elements, "
                         f"expected {N}")
    return N


def int8_operands(xq: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                  bias: Optional[torch.Tensor]):
    """B10's operands as its kernels read them: K zero-padded to a
    multiple of 16 in ``xq [M, K]`` and ``wq [K, N]``, N to 16 in ``wq``,
    ``w_scale [N]`` and ``bias [N]`` (f32, or None), ``xq`` and ``wq``
    16-byte aligned. Returns ``(xq, wq, w_scale, bias, padded N)``; the
    columns past N are the caller's to drop. A ragged weight is copied on
    every call, decode's too: every preset's projections have K and N in
    multiples of 16 (``tests/test_torch_int8_matmul.py`` pins this), so
    no model path pays that copy."""
    K, N = wq.shape
    dk, dn = -K % 16, -N % 16
    if dk:
        xq, wq = F.pad(xq, (0, dk)), F.pad(wq, (0, 0, 0, dk))
    if dn:
        wq, w_scale = F.pad(wq, (0, dn)), F.pad(w_scale, (0, dn))
        bias = None if bias is None else F.pad(bias, (0, dn))
    return aligned16(xq), aligned16(wq), w_scale, bias, N + dn


def w8_operands(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor]):
    """B11's operands as its tensor-core kernel reads them: K zero-padded
    to a multiple of 8 in ``x [M, K]`` (bf16 rows of 16 bytes) and ``wq
    [K, N]``, N to 16 in ``wq`` (INT8 rows of 16 bytes), ``w_scale [N]``
    and ``bias [N]`` (f32, or None), ``x`` and ``wq`` 16-byte aligned.
    Returns ``(x, wq, w_scale, bias, padded N)``; the columns past N are
    the caller's to drop. Every preset's projections need no copy, and
    so does every vocabulary but GPT-2's: its 50,257-column head is
    padded to 50,272, so that weight is copied on every B11 call past 16
    rows (``tests/test_torch_int8_matmul.py`` pins both)."""
    K, N = wq.shape
    dk, dn = -K % 8, -N % 16
    if dk:
        x, wq = F.pad(x, (0, dk)), F.pad(wq, (0, 0, 0, dk))
    if dn:
        wq, w_scale = F.pad(wq, (0, dn)), F.pad(w_scale, (0, dn))
        bias = None if bias is None else F.pad(bias, (0, dn))
    return aligned16(x), aligned16(wq), w_scale, bias, N + dn


def w8_gemv_operands(x: torch.Tensor, wq: torch.Tensor):
    """B11's operands as its matrix-vector kernel reads them: K
    zero-padded to a multiple of 16 (its k-step) in ``x [M, K]`` and ``wq
    [K, N]``, ``x`` 16-byte aligned (``wq`` is, or the wrapper takes the
    tiles). Every preset's products need no copy
    (``tests/test_torch_int8_matmul.py`` pins this)."""
    dk = -wq.shape[0] % W8_GEMV_K
    if dk:
        x, wq = F.pad(x, (0, dk)), F.pad(wq, (0, 0, 0, dk))
    return aligned16(x), wq


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
    xs = x_scale.reshape(M).float().contiguous()
    xq, wq, ws, b, n_pad = int8_operands(
        xq.contiguous(), wq.contiguous(),
        w_scale.reshape(N).float().contiguous(), bias_f32(bias, N))
    Kp = xq.shape[1]
    gemv, splits, kps = int8_plan(M, Kp, n_pad)
    part, counters = (scratch(xq.device, M, n_pad, splits, torch.int32)
                      if gemv else wgmma_scratch(xq.device, M, n_pad, splits))
    out = torch.empty((M, n_pad), dtype=out_dtype, device=xq.device)
    INT8_MATMUL.launch(ptr(xq), ptr(xs), ptr(wq), ptr(ws), ptr(b), ptr(out),
                       ptr(part), ptr(counters), M, Kp, n_pad, splits, kps,
                       int(gemv), *codes, stream_handle(xq))
    return out if n_pad == N else out[:, :N].contiguous()


def w8_matmul(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
              bias: Optional[torch.Tensor] = None, *,
              act: Optional[str] = None,
              out_dtype=torch.bfloat16) -> torch.Tensor:
    """B11, weight-only INT8: ``act((x @ widen(wq)) * w_scale + bias)``.

    x ``[M, K]`` bf16/f32; wq ``[K, N]`` int8; w_scale ``[1, N]`` f32.
    Returns ``[M, N]`` in ``out_dtype`` (bf16 or f32). The kernel by
    :func:`w8_plan`: the tensor-core matrix-vector kernel through 16 rows,
    the bf16 tensor-core kernel past them for bf16 x, the CUDA-core tiles
    for f32 x past them or a ragged N; one launch count for all three."""
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
    n_pad = N
    route = w8_plan(M, K, N, x.dtype,
                    N % 16 == 0 and wq.data_ptr() % 16 == 0)[0]
    if route == "wgmma":
        x, wq, ws, b, n_pad = w8_operands(x, wq, ws, b)
    elif route == "gemv":
        x, wq = w8_gemv_operands(x, wq)
    route, splits, kps = w8_plan(M, x.shape[1], n_pad, x.dtype,
                                 route != "tiles")
    part, counters = (w8_scratch(x.device, M, n_pad, splits)
                      if route == "wgmma" else
                      scratch(x.device, M, n_pad, splits, torch.float32))
    out = torch.empty((M, n_pad), dtype=out_dtype, device=x.device)
    W8_MATMUL.launch(ptr(x), ptr(wq), ptr(ws), ptr(b), ptr(out), ptr(part),
                     ptr(counters), M, x.shape[1], n_pad, splits, kps,
                     W8_ROUTES[route], *codes, stream_handle(x))
    return out if n_pad == N else out[:, :N].contiguous()
