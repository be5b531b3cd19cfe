"""KV append into the page pool, in place.

Three hand-written CUDA kernels (``csrc/kv_append.cu``), one per Pallas
kernel of the JAX package's ``ops/kv_append.py``:

* :func:`append_decode` (B3) replaces ``_append_tokens_rmw_batch``
  (``_rmw_batch_kernel``): the T=1 decode append of every sequence's K/V
  row and INT8 scale.
* :func:`append_prefill` (B4) replaces ``_append_pages_pallas``
  (``_prefill_kernel`` + its scales scan): the page-aligned prefill
  chunk append.
* :func:`append_tokens` (B5) replaces ``_append_tokens_rmw``
  (``_rmw_kernel``): any other T>1 chunk, the speculative verify chunk.

B3 and B5 take the model's rows, ``k_new / v_new [B, T, KH, D]`` in the
compute dtype (bf16 or f32; the last dim contiguous, any strides over B,
T and KH, so a view of the fused qkv output is read in place), and
quantize as they append: one launch where ``stack_new_kv`` and the copy
took eleven (``csrc/kv_quant.cuh`` reproduces ``quantize_kv`` bit for
bit). B4 takes pool-dtype rows from ``stack_new_kv``. All write only
valid positions (``pos >= 0``), as the JAX package's
``append_to_pages_at_layer`` does; the TPU prefill kernel writes whole
pages instead (see the note in ``csrc/kv_append.cu``). Bytes bound them
on the H100, and at the engine's shapes so few bytes that launch latency
is their cost. Each wrapper runs its plain version
(:func:`append_decode_plain` and :func:`append_tokens_plain`:
:func:`append_rows_plain`, ``stack_new_kv`` then the scatter;
:func:`append_prefill_plain`: :func:`append_plain`, the ``index_put_``
scatter of ``kvcache/pool.py``) for CPU tensors only; for CUDA tensors it
launches the kernel or raises. No wrapper syncs with the host.
"""

from __future__ import annotations

import torch

from ..kvcache.pool import flat_slots, stack_new_kv, write_news
from ..utils.platform import (DTYPE_CODES, CudaKernel, I, LL, P, ptr,
                              stream_handle)

#: B4: pool, scales, news, new scales, block tables, positions; B, T, KH,
#: P, page, row bytes, table width, layer; the scales' stride; the stream
_PREFILL_ARGS = [P] * 6 + [I] * 8 + [LL, P]
#: B3 / B5: pool, scales, k, v, block tables, positions; k's and v's
#: strides over B, T and KH; the rows' and the pool's dtype codes; B, T,
#: KH, P, page, D, table width, layer; the scales' stride; warps a block;
#: the stream
_ROWS_ARGS = [P] * 6 + [LL] * 6 + [I] * 10 + [LL, I, P]

APPEND_DECODE = CudaKernel(
    "kv_append_decode", "kv_append.cu", "pbt_kv_append_decode",
    _ROWS_ARGS, "ops/kv_append.py:340")
APPEND_PREFILL = CudaKernel(
    "kv_append_prefill", "kv_append.cu", "pbt_kv_append_prefill",
    _PREFILL_ARGS, "ops/kv_append.py:62")
APPEND_TOKENS = CudaKernel(
    "kv_append_tokens", "kv_append.cu", "pbt_kv_append_tokens",
    _ROWS_ARGS, "ops/kv_append.py:391")

#: the rows' dtypes B3 and B5 read
ROW_DTYPES = (torch.float32, torch.bfloat16)
#: warps (rows) a block of B3 and B5
ROWS_WARPS = 8


def _check_pool(kv, positions, block_tables, others):
    pool = kv[0]
    if pool.dim() != 6 or not pool.is_contiguous():
        raise ValueError("pool must be a contiguous [L, 2, KH, P, page, D]")
    if pool.dtype not in DTYPE_CODES:
        raise ValueError(f"pool dtype {pool.dtype} not supported")
    if len(kv) == 2:
        sc = kv[1]
        if (sc.dtype != torch.float32 or sc.dim() != 5
                or sc.shape[-1] != 128 or not sc.is_contiguous()
                or sc.shape[:3] != pool.shape[:3]
                or sc.shape[3] * 128 < pool.shape[3] * pool.shape[4]):
            raise ValueError("INT8 scales must be the pool's contiguous f32 "
                             "[L, 2, KH, R, 128] leaf")
    for t in (positions, block_tables) + tuple(others) + tuple(kv):
        if t.device != pool.device:
            raise ValueError("pool, rows, positions and block tables must "
                             "share one device")
    if positions.dtype != torch.int32 or block_tables.dtype != torch.int32:
        raise ValueError("positions and block tables must be int32")
    if positions.dim() != 2:
        raise ValueError("positions must be [B, T]")
    if (block_tables.dim() != 2
            or block_tables.shape[0] != positions.shape[0]):
        raise ValueError("block tables must be [B, max_pages]")
    if pool.data_ptr() % 16:
        raise ValueError("the pool must be 16-byte aligned")


def _check(kv, news, positions, block_tables):
    """The checks of an append of pool-dtype ``news`` (from
    :func:`stack_new_kv`): B4's, and B9's in ``ops/paged_attention.py``."""
    _check_pool(kv, positions, block_tables, news)
    # the kernels copy the news' bytes into the pool's rows
    B, T = positions.shape
    _, _, KH, _, _, D = kv[0].shape
    if (news[0].dtype != kv[0].dtype
            or tuple(news[0].shape) != (B, 2, KH, T, D)
            or len(news) != len(kv)
            or (len(news) == 2 and (news[1].dtype != torch.float32
                                    or tuple(news[1].shape)
                                    != (B, 2, KH, T, 1)))):
        raise ValueError("news must come from stack_new_kv for this pool "
                         "and these positions")


def _check_rows(kv, k_new, v_new, positions, block_tables):
    """The checks of B3's and B5's rows ``k_new / v_new [B, T, KH, D]``."""
    _check_pool(kv, positions, block_tables, (k_new, v_new))
    B, T = positions.shape
    _, _, KH, _, _, D = kv[0].shape
    for x in (k_new, v_new):
        if x.dtype not in ROW_DTYPES:
            raise ValueError(f"rows must be one of {ROW_DTYPES}, not "
                             f"{x.dtype}")
        if tuple(x.shape) != (B, T, KH, D):
            raise ValueError(f"rows must be [B, T, KH, D] = {(B, T, KH, D)}"
                             f" for this pool and these positions, not "
                             f"{tuple(x.shape)}")
        if x.stride(-1) != 1:
            raise ValueError("the rows' last dim must be contiguous")
    if k_new.dtype != v_new.dtype:
        raise ValueError("k_new and v_new must share one dtype")


def append_rows_plan(T: int, KH: int) -> int:
    """B3's and B5's cut of one sequence's ``2 * T * KH`` rows: warps a
    block, one row a warp (:data:`ROWS_WARPS`, fewer where the sequence
    has fewer rows)."""
    return min(ROWS_WARPS, 2 * T * KH)


def append_rows_launch(kernel: CudaKernel, kv, k_new, v_new, layer: int,
                       positions, block_tables, warps: int) -> None:
    """Launches B3 or B5 (``kernel``) on CUDA tensors with ``warps`` rows
    a block (the wrappers take :func:`append_rows_plan`'s): the entry of
    sweeps and checks."""
    pool = kv[0]
    L, _, KH, Pn, page, D = pool.shape
    scales = kv[1] if len(kv) == 2 else None
    B, T = positions.shape
    # every tensor whose pointer the kernel gets stays bound to a local
    # until the launch is enqueued
    bt = block_tables.contiguous()
    pos = positions.contiguous()
    # a dim of size 1 is never stepped over: its stride (any value a view
    # leaves) must not keep the rows off the kernel's vector loads
    strides = [0 if n == 1 else s for x in (k_new, v_new)
               for n, s in zip(x.shape[:3], x.stride()[:3])]
    kernel.launch(
        ptr(pool), ptr(scales), ptr(k_new), ptr(v_new), ptr(bt), ptr(pos),
        *strides, DTYPE_CODES[k_new.dtype], DTYPE_CODES[pool.dtype], B, T,
        KH, Pn, page, D, block_tables.shape[1], int(layer),
        0 if scales is None else scales.shape[3] * 128, warps,
        stream_handle(pool))


def _launch_rows(kernel: CudaKernel, kv, k_new, v_new, layer, positions,
                 block_tables):
    append_rows_launch(kernel, kv, k_new, v_new, layer, positions,
                       block_tables,
                       append_rows_plan(positions.shape[1], kv[0].shape[2]))


def _launch(kernel: CudaKernel, kv, news, layer: int, positions,
            block_tables, *dims):
    pool = kv[0]
    L, _, KH, Pn, page, D = pool.shape
    scales = kv[1] if len(kv) == 2 else None
    # every tensor whose pointer the kernel gets stays bound to a local
    # until the launch is enqueued
    vals = news[0].contiguous()
    if vals.data_ptr() % 16:
        vals = vals.clone()
    new_sc = news[1].contiguous() if scales is not None else None
    bt = block_tables.contiguous()
    pos = positions.contiguous()
    kernel.launch(
        ptr(pool), ptr(scales), ptr(vals), ptr(new_sc), ptr(bt), ptr(pos),
        *dims, KH, Pn, page, D * pool.element_size(),
        block_tables.shape[1], int(layer),
        0 if scales is None else scales.shape[3] * 128,
        stream_handle(pool))


def append_plain(kv, news, layer: int, positions: torch.Tensor,
                 block_tables: torch.Tensor):
    """Plain version of :func:`append_prefill` (same signature): the
    ``index_put_`` scatter of valid positions of pool-dtype ``news``."""
    page = kv[0].shape[4]
    return write_news(kv, news, layer,
                      flat_slots(positions, block_tables, page))


append_prefill_plain = append_plain


def append_rows_plain(kv, k_new: torch.Tensor, v_new: torch.Tensor,
                      layer: int, positions: torch.Tensor,
                      block_tables: torch.Tensor):
    """Plain version of :func:`append_decode` and :func:`append_tokens`
    (same signature): ``stack_new_kv`` (INT8 pools quantize there), then
    the scatter of :func:`append_plain`."""
    return append_plain(kv, stack_new_kv(kv, k_new, v_new), layer,
                        positions, block_tables)


append_decode_plain = append_tokens_plain = append_rows_plain


def append_decode(kv, k_new: torch.Tensor, v_new: torch.Tensor, layer: int,
                  positions: torch.Tensor, block_tables: torch.Tensor):
    """B3: quantize (INT8 pool) or cast each sequence's single new row
    ``k_new / v_new [B, 1, KH, D]`` and write it (+ its INT8 scale) at
    ``positions [B, 1]`` into ``kv`` at ``layer``, in place, in one
    launch. The kernel skips a position past the block table or a table
    entry outside the pool. Returns ``kv``."""
    _check_rows(kv, k_new, v_new, positions, block_tables)
    if positions.shape[1] != 1:
        raise ValueError("append_decode takes T=1")
    if not kv[0].is_cuda:
        return append_decode_plain(kv, k_new, v_new, layer, positions,
                                   block_tables)
    _launch_rows(APPEND_DECODE, kv, k_new, v_new, layer, positions,
                 block_tables)
    return kv


def append_prefill(kv, news, layer: int, positions: torch.Tensor,
                   block_tables: torch.Tensor):
    """B4: write a page-aligned chunk ``news [B, 2, KH, T, D]`` (``T %
    page == 0``; + INT8 scales) at ``positions [B, T]`` into ``kv`` at
    ``layer``, in place; positions ``< 0`` are skipped, and the kernel
    skips out-of-table ones as :func:`append_decode` does. Returns
    ``kv``."""
    _check(kv, news, positions, block_tables)
    B, T = positions.shape
    if T % kv[0].shape[4] != 0:
        raise ValueError("append_prefill takes page-aligned chunks")
    if not kv[0].is_cuda:
        return append_prefill_plain(kv, news, layer, positions,
                                    block_tables)
    _launch(APPEND_PREFILL, kv, news, layer, positions, block_tables, B, T)
    return kv


def append_tokens(kv, k_new: torch.Tensor, v_new: torch.Tensor,
                  layer: int, positions: torch.Tensor,
                  block_tables: torch.Tensor):
    """B5: quantize (INT8 pool) or cast a chunk ``k_new / v_new [B, T,
    KH, D]`` and write it (+ its INT8 scales) at ``positions [B, T]``
    into ``kv`` at ``layer``, in place, in one launch, each token at its
    own position wherever the chunk starts; positions ``< 0`` are
    skipped, and the kernel skips out-of-table ones as
    :func:`append_decode` does. Returns ``kv``."""
    _check_rows(kv, k_new, v_new, positions, block_tables)
    if not kv[0].is_cuda:
        return append_tokens_plain(kv, k_new, v_new, layer, positions,
                                   block_tables)
    _launch_rows(APPEND_TOKENS, kv, k_new, v_new, layer, positions,
                 block_tables)
    return kv


def kv_append(kv, k_new: torch.Tensor, v_new: torch.Tensor, layer: int,
              positions: torch.Tensor, block_tables: torch.Tensor, *,
              page_size: int):
    """Write ``k_new/v_new [B, T, KH, dh]`` at ``positions [B, T]`` into
    the pool (leaves ``[L, 2, KH, P, page, d]``) at ``layer``, in place.
    The JAX package's dispatch: T=1 goes to B3, ``T % page == 0`` to B4
    (which, unlike the TPU's whole-page B4, is right for a chunk that
    starts off a page boundary too), any other T (the speculative verify
    chunk) to B5. B3 and B5 take the rows as they are and quantize an
    INT8 pool's in the kernel; B4 takes them from ``stack_new_kv``. Rows
    of another float dtype (f16) are widened to f32 first, which changes
    no value. Returns ``kv``."""
    if kv[0].shape[4] != page_size:
        raise ValueError("page_size does not match the pool")
    positions = positions.to(torch.int32)
    block_tables = block_tables.to(torch.int32)
    T = positions.shape[1]
    if T % page_size == 0 and T > 1:
        return append_prefill(kv, stack_new_kv(kv, k_new, v_new), layer,
                              positions, block_tables)
    if k_new.dtype not in ROW_DTYPES or v_new.dtype != k_new.dtype:
        k_new, v_new = k_new.float(), v_new.float()
    if T == 1:
        return append_decode(kv, k_new, v_new, layer, positions,
                             block_tables)
    return append_tokens(kv, k_new, v_new, layer, positions, block_tables)
