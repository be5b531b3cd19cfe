"""Paged attention over the page pool (prefill chunks and decode).

Three hand-written CUDA kernels (``csrc/paged_attention.cu``), one per
Pallas kernel of the JAX package's ``ops/paged_attention.py``:

* :func:`paged_attention` (B1) replaces ``paged_attention``
  (``_kernel`` / ``_attend``): a T>=1 chunk, GQA rows ``t*G+g``, causal
  by absolute position (``q_offsets``), ``key < seq_len``, optional
  sliding window and tanh softcap, INT8 scales folded into the scores
  (K) and the probabilities (V).
* :func:`paged_attention_decode` (B2) replaces ``paged_attention_decode``
  (``_decode_kernel``): T=1, mask ``key < seq_len`` (+ window).
* :func:`paged_attention_decode_append` (B9) replaces
  ``paged_attention_decode_append`` (``_decode_append_kernel``): B2 with
  the T=1 KV append fused in; :func:`decode_append_supported` gates it.

What bounds them on the H100 and what the design does about it is in
the source's header note. The plain versions
(:func:`paged_attention_plain`, :func:`paged_attention_decode_plain`)
gather each sequence's pages through the block table and run a masked
f32 softmax with the same fold order;
:func:`paged_attention_decode_append_plain` is the append's plain
version followed by B2's. The wrappers take them for CPU tensors only
and launch the kernel (or raise) for CUDA tensors.

The grouped / packed / batched decode variants of the JAX package
(B6-B8) and the per-page score export (``return_scores``, the beam
slice) are not ported yet and raise.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..kvcache.pool import stack_new_kv
from ..utils.platform import (DTYPE_CODES, CudaKernel, F, I, LL, P, ptr,
                              stream_handle)
from .kv_append import append_plain
from .kv_append import _check as _check_append

_ATTN_ARGS = [P, P, P, P, P, P]        # q, out, pool, scales, bt, seq_lens
ATTENTION = CudaKernel(
    "paged_attention", "paged_attention.cu", "pbt_paged_attention",
    _ATTN_ARGS + [P] + [I] * 9 + [LL, F, F, I, I, I, P],
    "ops/paged_attention.py:219")
ATTENTION_DECODE = CudaKernel(
    "paged_attention_decode", "paged_attention.cu",
    "pbt_paged_attention_decode",
    _ATTN_ARGS + [I] * 8 + [LL, F, F, I, I, I, P],
    "ops/paged_attention.py:671")
ATTENTION_DECODE_APPEND = CudaKernel(
    "paged_attention_decode_append", "paged_attention.cu",
    "pbt_paged_attention_decode_append",
    _ATTN_ARGS + [P, P, P] + [I] * 8 + [LL, F, F, I, I, I, P],
    "ops/paged_attention.py:1380")


def _pooled(kv_pages, kv_scales, layer):
    """Accept the full pool ``[L, 2, KH, P, page, D]`` with ``layer`` or
    one layer's ``[2, KH, P, page, D]``; return the 6-D form + layer."""
    if kv_pages.dim() == 5:
        kv_pages = kv_pages.unsqueeze(0)
        if kv_scales is not None:
            kv_scales = kv_scales.unsqueeze(0)
        layer = 0
    if kv_pages.dim() != 6 or layer is None:
        raise ValueError("pool must be [L, 2, KH, P, page, D] with a layer "
                         "index, or [2, KH, P, page, D]")
    if kv_scales is not None and (
            kv_scales.dim() != 5 or kv_scales.shape[-1] != 128
            or kv_scales.dtype != torch.float32
            or kv_scales.shape[:3] != kv_pages.shape[:3]
            or kv_scales.shape[3] * 128 < kv_pages.shape[3] * kv_pages.shape[4]):
        raise ValueError("INT8 scales must be the pool's flat f32 "
                         "[L, 2, KH, R, 128] leaf")
    return kv_pages, kv_scales, int(layer)


def _attend_plain(q, pool, scales, layer, block_tables, seq_lens, q_pos,
                  window, softcap, scale):
    """Masked f32 softmax of ``q [B, T, H, D]`` (rows at absolute
    positions ``q_pos [B, T]``) over the sequences' gathered pages."""
    B, T, H, D = q.shape
    KH, page = pool.shape[2], pool.shape[4]
    G = H // KH
    mp = block_tables.shape[1]
    bt = block_tables.long()
    g = pool[layer][:, :, bt].reshape(2, KH, B, mp * page, D).float()
    k, v = g[0], g[1]                                     # [KH, B, S, D]
    qf = q.float().reshape(B, T, KH, G, D) * scale
    s = torch.einsum("btkgd,kbsd->bktgs", qf, k)          # [B, KH, T, G, S]
    if scales is not None:
        slots = (bt[:, :, None] * page
                 + torch.arange(page, device=q.device)).reshape(B, -1)
        sc = scales[layer].reshape(2, KH, -1)[:, :, slots]   # [2, KH, B, S]
        sc = sc.permute(0, 2, 1, 3)[:, :, :, None, None, :]  # [2, B, KH,..]
        s = s * sc[0]
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    key = torch.arange(mp * page, device=q.device)
    vis = (key <= q_pos[:, :, None]) & (key < seq_lens[:, None, None])
    if window > 0:
        vis &= key > q_pos[:, :, None] - window
    vis = vis[:, None, :, None, :]                        # [B, 1, T, 1, S]
    s = torch.where(vis, s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(vis, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    if scales is not None:
        p = p * sc[1]
    out = torch.einsum("bktgs,kbsd->bktgd", p, v)
    out = out / torch.where(l == 0, torch.ones_like(l), l)
    return out.permute(0, 2, 1, 3, 4).reshape(B, T, H, D).to(q.dtype)


def _check(q, pool, block_tables, seq_lens, num_q_heads, page_size):
    B, T, H, D = q.shape
    if pool.shape[4] != page_size or H != num_q_heads:
        raise ValueError("page_size / num_q_heads do not match the inputs")
    if H % pool.shape[2] or pool.shape[5] != D:
        raise ValueError(f"q {tuple(q.shape)} does not fit pool "
                         f"{tuple(pool.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B or tuple(
            seq_lens.shape) != (B,):
        raise ValueError("block tables must be [B, max_pages] and seq_lens "
                         "[B]")
    for t in (pool, block_tables, seq_lens):
        if t.device != q.device:
            raise ValueError("q, pool, block tables and seq_lens must share "
                             "one device")


def _launch_args(q, pool, scales):
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q dtype {q.dtype} not supported")
    if pool.dtype not in DTYPE_CODES or not pool.is_contiguous():
        raise ValueError("pool must be contiguous f32/bf16/int8")
    if (pool.shape[5] * pool.element_size()) % 4 or pool.shape[5] > 256:
        raise ValueError("kernel needs D * itemsize % 4 == 0 and D <= 256")
    if scales is not None and not scales.is_contiguous():
        raise ValueError("scales must be contiguous")
    return (DTYPE_CODES[q.dtype], DTYPE_CODES[pool.dtype],
            0 if scales is None else scales.shape[3] * 128)


def paged_attention_plain(q, kv_pages, block_tables, seq_lens, q_offsets,
                          kv_scales=None, layer=None, *, page_size: int,
                          num_q_heads: int, window: int = 0,
                          softcap: float = 0.0,
                          scale: Optional[float] = None,
                          return_scores: bool = False):
    """Plain version of :func:`paged_attention` (same signature)."""
    if return_scores:
        raise NotImplementedError(
            "return_scores (per-page score export): the beam slice, "
            "ROADMAP queue A item 6")
    pool, scales, layer = _pooled(kv_pages, kv_scales, layer)
    _check(q, pool, block_tables, seq_lens, num_q_heads, page_size)
    B, T = q.shape[:2]
    scale = 1.0 / math.sqrt(q.shape[3]) if scale is None else scale
    q_pos = q_offsets.long()[:, None] + torch.arange(T, device=q.device)
    return _attend_plain(q, pool, scales, layer, block_tables, seq_lens,
                         q_pos, window, softcap, scale)


def paged_attention(q: torch.Tensor, kv_pages: torch.Tensor,
                    block_tables: torch.Tensor, seq_lens: torch.Tensor,
                    q_offsets: torch.Tensor,
                    kv_scales: Optional[torch.Tensor] = None,
                    layer: Optional[int] = None, *, page_size: int,
                    num_q_heads: int, window: int = 0, softcap: float = 0.0,
                    scale: Optional[float] = None,
                    return_scores: bool = False) -> torch.Tensor:
    """B1: paged attention of a chunk of queries over the pool.

    q ``[B, T, H, dh]`` (bf16/f32); kv_pages ``[L, 2, KH, P, page, dh]``
    with ``layer`` (or one layer's ``[2, KH, P, page, dh]``), int8 /
    bf16 / f32; block_tables ``[B, max_pages]`` int32; seq_lens ``[B]``
    valid tokens including this chunk; q_offsets ``[B]`` absolute
    position of q token 0; kv_scales the flat INT8 scales leaf. Returns
    ``[B, T, H, dh]`` in q's dtype."""
    if return_scores or not q.is_cuda:
        return paged_attention_plain(
            q, kv_pages, block_tables, seq_lens, q_offsets, kv_scales, layer,
            page_size=page_size, num_q_heads=num_q_heads, window=window,
            softcap=softcap, scale=scale, return_scores=return_scores)
    pool, scales, layer = _pooled(kv_pages, kv_scales, layer)
    _check(q, pool, block_tables, seq_lens, num_q_heads, page_size)
    qd, kd, sstride = _launch_args(q, pool, scales)
    B, T, H, D = q.shape
    if tuple(q_offsets.shape) != (B,) or q_offsets.device != q.device:
        raise ValueError("q_offsets must be [B] on q's device")
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    q = q.contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    sl = seq_lens.to(torch.int32).contiguous()
    qo = q_offsets.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    ATTENTION.launch(
        ptr(q), ptr(out), ptr(pool), ptr(scales), ptr(bt), ptr(sl), ptr(qo),
        B, T, H, pool.shape[2], D, pool.shape[3], page_size, bt.shape[1],
        layer, sstride, float(scale), float(softcap), int(window), qd, kd,
        stream_handle(q))
    return out


def paged_attention_decode_plain(q, kv_pages, block_tables, seq_lens,
                                 kv_scales=None, layer=None, *,
                                 page_size: int, num_q_heads: int,
                                 window: int = 0, softcap: float = 0.0,
                                 scale: Optional[float] = None):
    """Plain version of :func:`paged_attention_decode` (same
    signature): the lone query sits at position ``seq_len - 1``."""
    pool, scales, layer = _pooled(kv_pages, kv_scales, layer)
    _check(q, pool, block_tables, seq_lens, num_q_heads, page_size)
    if q.shape[1] != 1:
        raise ValueError("decode attention takes T=1")
    scale = 1.0 / math.sqrt(q.shape[3]) if scale is None else scale
    q_pos = seq_lens.long()[:, None] - 1
    return _attend_plain(q, pool, scales, layer, block_tables, seq_lens,
                         q_pos, window, softcap, scale)


def paged_attention_decode(q: torch.Tensor, kv_pages: torch.Tensor,
                           block_tables: torch.Tensor,
                           seq_lens: torch.Tensor,
                           kv_scales: Optional[torch.Tensor] = None,
                           layer: Optional[int] = None, *, page_size: int,
                           num_q_heads: int, window: int = 0,
                           softcap: float = 0.0,
                           scale: Optional[float] = None) -> torch.Tensor:
    """B2: T=1 decode attention (q ``[B, 1, H, dh]``, ``dh % 128 == 0``
    as in the JAX package; at most 8 query heads per KV head). Mask
    ``key < seq_len`` (+ window). Returns ``[B, 1, H, dh]``."""
    if q.shape[3] % 128:
        raise NotImplementedError(
            "decode over a sub-128 unpadded pool (grouped / packed decode "
            "kernels): ROADMAP queue B items B6/B8")
    if not q.is_cuda:
        return paged_attention_decode_plain(
            q, kv_pages, block_tables, seq_lens, kv_scales, layer,
            page_size=page_size, num_q_heads=num_q_heads, window=window,
            softcap=softcap, scale=scale)
    pool, scales, layer = _pooled(kv_pages, kv_scales, layer)
    _check(q, pool, block_tables, seq_lens, num_q_heads, page_size)
    qd, kd, sstride = _launch_args(q, pool, scales)
    B, T, H, D = q.shape
    if T != 1 or H // pool.shape[2] > 8:
        raise ValueError("decode kernel takes T=1 and at most 8 query "
                         "heads per KV head")
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    q = q.contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    sl = seq_lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    ATTENTION_DECODE.launch(
        ptr(q), ptr(out), ptr(pool), ptr(scales), ptr(bt), ptr(sl),
        B, H, pool.shape[2], D, pool.shape[3], page_size, bt.shape[1],
        layer, sstride, float(scale), float(softcap), int(window), qd, kd,
        stream_handle(q))
    return out


def decode_append_supported(kv, dh: int) -> bool:
    """Gate of :func:`paged_attention_decode_append` for a pool ``kv``
    whose head dim is ``dh``: what B2's kernel reads (a layer-pooled
    ``[L, 2, KH, P, page, dh]`` pool of int8/bf16/f32 with ``dh % 128 ==
    0`` and ``dh <= 256``, INT8 scales as the flat ``[L, 2, KH, R, 128]``
    leaf). The JAX gate's other conditions are TPU facts and are dropped:
    the whole context window in 4 MiB of VMEM, a page divisible by the
    dtype's sublane tile, and 8-row slabs of the scales leaf (``R % 8``)."""
    pool = kv[0]
    if dh % 128 or dh > 256 or pool.dim() != 6 or pool.shape[5] != dh:
        return False
    if pool.dtype not in DTYPE_CODES:
        return False
    return len(kv) == 1 or kv[1].shape[-1] == 128


def paged_attention_decode_append_plain(q, kv, k_new, v_new, block_tables,
                                        seq_lens, positions, layer: int, *,
                                        page_size: int, num_q_heads: int,
                                        window: int = 0,
                                        softcap: float = 0.0,
                                        scale: Optional[float] = None):
    """Plain version of :func:`paged_attention_decode_append` (same
    signature): the append's plain version, then B2's over the updated
    pool, which is what the JAX wrapper runs in interpret mode."""
    append_plain(kv, stack_new_kv(kv, k_new, v_new), layer, positions,
                 block_tables)
    out = paged_attention_decode_plain(
        q, kv[0], block_tables, seq_lens, kv[1] if len(kv) == 2 else None,
        layer, page_size=page_size, num_q_heads=num_q_heads, window=window,
        softcap=softcap, scale=scale)
    return out, kv


def paged_attention_decode_append(q: torch.Tensor, kv, k_new: torch.Tensor,
                                  v_new: torch.Tensor,
                                  block_tables: torch.Tensor,
                                  seq_lens: torch.Tensor,
                                  positions: torch.Tensor, layer: int, *,
                                  page_size: int, num_q_heads: int,
                                  window: int = 0, softcap: float = 0.0,
                                  scale: Optional[float] = None):
    """B9: T=1 decode attention with the KV append fused in. ``q [B, 1,
    H, dh]``; ``kv`` the full pool (``(vals,)`` or INT8 ``(vals,
    scales)``); ``k_new/v_new [B, 1, KH, dh]`` the new token's rows
    (quantized here for an INT8 pool, as ``kv_append`` does);
    ``seq_lens`` the lengths after the append; ``positions [B, 1]`` the
    append targets (``< 0``: not written). Returns ``(out [B, 1, H,
    dh], kv)``, the pool updated in place.

    A lane with ``positions < 0`` (a frozen lane) writes nothing, and
    its output is undefined: the kernel folds in the new row as the
    JAX kernel does, the plain version reads key ``seq_len - 1`` from
    the pool; the engine discards such a lane's output."""
    if not q.is_cuda:
        return paged_attention_decode_append_plain(
            q, kv, k_new, v_new, block_tables, seq_lens, positions, layer,
            page_size=page_size, num_q_heads=num_q_heads, window=window,
            softcap=softcap, scale=scale)
    B, T, H, D = q.shape
    if not decode_append_supported(kv, D):
        raise ValueError("decode_append_supported(kv, dh) is False for "
                         "this pool")
    pool, scales, layer = _pooled(kv[0], kv[1] if len(kv) == 2 else None,
                                  layer)
    _check(q, pool, block_tables, seq_lens, num_q_heads, page_size)
    qd, kd, sstride = _launch_args(q, pool, scales)
    if T != 1 or H // pool.shape[2] > 8:
        raise ValueError("decode kernel takes T=1 and at most 8 query "
                         "heads per KV head")
    news = stack_new_kv(kv, k_new, v_new)
    pos = positions.to(torch.int32).contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    _check_append(kv, news, pos, bt)
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    q = q.contiguous()
    sl = seq_lens.to(torch.int32).contiguous()
    new_sc = news[1] if scales is not None else None
    out = torch.empty_like(q)
    ATTENTION_DECODE_APPEND.launch(
        ptr(q), ptr(out), ptr(pool), ptr(scales), ptr(bt), ptr(sl),
        ptr(pos), ptr(news[0]), ptr(new_sc), B, H, pool.shape[2], D,
        pool.shape[3], page_size, bt.shape[1], layer, sstride,
        float(scale), float(softcap), int(window), qd, kd,
        stream_handle(q))
    return out, kv
