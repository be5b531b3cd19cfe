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

All write only valid positions (``pos >= 0``), as the JAX package's
``append_to_pages_at_layer`` does; the TPU prefill kernel writes whole
pages instead (see the note in ``csrc/kv_append.cu``). Bytes bound them
on the H100, and at the engine's shapes so few bytes that launch latency
is their cost. Each wrapper runs its plain version
(:func:`append_decode_plain`, :func:`append_prefill_plain`,
:func:`append_tokens_plain`: all are :func:`append_plain`, the
``index_put_`` scatter of ``kvcache/pool.py``) for CPU tensors only; for
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..kvcache.pool import flat_slots, stack_new_kv, write_news
from ..utils.platform import (DTYPE_CODES, CudaKernel, I, LL, P, ptr,
                              stream_handle)

_APPEND_ARGS = [P, P, P, P, P, P]      # pool, scales, news, new scales,
# block tables, positions

APPEND_DECODE = CudaKernel(
    "kv_append_decode", "kv_append.cu", "pbt_kv_append_decode",
    _APPEND_ARGS + [I, I, I, I, I, I, I, LL, P],
    "ops/kv_append.py:340")
APPEND_PREFILL = CudaKernel(
    "kv_append_prefill", "kv_append.cu", "pbt_kv_append_prefill",
    _APPEND_ARGS + [I, I, I, I, I, I, I, I, LL, P],
    "ops/kv_append.py:62")
APPEND_TOKENS = CudaKernel(
    "kv_append_tokens", "kv_append.cu", "pbt_kv_append_tokens",
    _APPEND_ARGS + [I, I, I, I, I, I, I, I, LL, P],
    "ops/kv_append.py:391")


def _check(kv, news, positions, block_tables):
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
    for t in (positions, block_tables) + tuple(news) + tuple(kv):
        if t.device != pool.device:
            raise ValueError("pool, news, positions and block tables must "
                             "share one device")
    if positions.dtype != torch.int32 or block_tables.dtype != torch.int32:
        raise ValueError("positions and block tables must be int32")
    # the kernels copy the news' bytes into the pool's rows
    B, T = positions.shape
    _, _, KH, _, _, D = pool.shape
    if (news[0].dtype != pool.dtype
            or tuple(news[0].shape) != (B, 2, KH, T, D)
            or len(news) != len(kv)
            or (len(news) == 2 and (news[1].dtype != torch.float32
                                    or tuple(news[1].shape)
                                    != (B, 2, KH, T, 1)))):
        raise ValueError("news must come from stack_new_kv for this pool "
                         "and these positions")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError("block tables must be [B, max_pages]")
    if pool.data_ptr() % 16:
        raise ValueError("the pool must be 16-byte aligned")


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
    """Plain version of :func:`append_decode`, :func:`append_prefill`
    and :func:`append_tokens` (same signature): the ``index_put_``
    scatter of valid positions."""
    page = kv[0].shape[4]
    return write_news(kv, news, layer,
                      flat_slots(positions, block_tables, page))


append_decode_plain = append_prefill_plain = append_tokens_plain = \
    append_plain


def append_decode(kv, news, layer: int, positions: torch.Tensor,
                  block_tables: torch.Tensor):
    """B3: write each sequence's single new row ``news [B, 2, KH, 1, D]``
    (+ INT8 scales ``[B, 2, KH, 1, 1]``) at ``positions [B, 1]`` into
    ``kv`` at ``layer``, in place. The kernel skips a position past the
    block table or a table entry outside the pool. Returns ``kv``."""
    _check(kv, news, positions, block_tables)
    if positions.shape[1] != 1:
        raise ValueError("append_decode takes T=1")
    if not kv[0].is_cuda:
        return append_decode_plain(kv, news, layer, positions, block_tables)
    _launch(APPEND_DECODE, kv, news, layer, positions, block_tables,
            positions.shape[0])
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


def append_tokens(kv, news, layer: int, positions: torch.Tensor,
                  block_tables: torch.Tensor):
    """B5: write a chunk ``news [B, 2, KH, T, D]`` (+ INT8 scales) at
    ``positions [B, T]`` into ``kv`` at ``layer``, in place, each token
    at its own position wherever the chunk starts; positions ``< 0`` are
    skipped, and the kernel skips out-of-table ones as
    :func:`append_decode` does. Returns ``kv``."""
    _check(kv, news, positions, block_tables)
    if not kv[0].is_cuda:
        return append_tokens_plain(kv, news, layer, positions, block_tables)
    _launch(APPEND_TOKENS, kv, news, layer, positions, block_tables,
            *positions.shape)
    return kv


def kv_append(kv, k_new: torch.Tensor, v_new: torch.Tensor, layer: int,
              positions: torch.Tensor, block_tables: torch.Tensor, *,
              page_size: int):
    """Write ``k_new/v_new [B, T, KH, dh]`` at ``positions [B, T]`` into
    the pool (leaves ``[L, 2, KH, P, page, d]``) at ``layer``, in place.
    INT8 pools quantize here (plain PyTorch) and the scales ride along.
    The JAX package's dispatch: T=1 goes to B3, ``T % page == 0`` to B4
    (which, unlike the TPU's whole-page B4, is right for a chunk that
    starts off a page boundary too), any other T (the speculative verify
    chunk) to B5. Returns ``kv``."""
    if kv[0].shape[4] != page_size:
        raise ValueError("page_size does not match the pool")
    news = stack_new_kv(kv, k_new, v_new)
    positions = positions.to(torch.int32)
    block_tables = block_tables.to(torch.int32)
    T = positions.shape[1]
    if T == 1:
        return append_decode(kv, news, layer, positions, block_tables)
    if T % page_size == 0:
        return append_prefill(kv, news, layer, positions, block_tables)
    return append_tokens(kv, news, layer, positions, block_tables)
