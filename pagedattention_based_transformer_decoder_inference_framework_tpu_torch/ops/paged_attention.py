"""Paged attention over the page pool (prefill chunks and decode).

Hand-written CUDA kernels for the Pallas kernels of the JAX package's
``ops/paged_attention.py``; ``csrc/paged_prefill.cu`` holds B1's
tensor-core kernel, ``csrc/paged_attention.cu`` B1's SIMT kernel, B2 and
B9, ``csrc/paged_decode.cu`` B6, B7 and B8:

* :func:`paged_attention` (B1) replaces ``paged_attention``
  (``_kernel`` / ``_attend``): a T>=1 chunk, GQA rows ``t*G+g``, causal
  by absolute position (``q_offsets``), ``key < seq_len``, optional
  sliding window and tanh softcap, INT8 scales folded into the scores
  (K) and the probabilities (V). Two kernels, by :func:`prefill_route`:
  ``ATTENTION_WGMMA`` (wgmma, bulk copies; bf16 queries, the one new
  rounding P to bf16) for every bf16 chunk of the card paths, and
  ``ATTENTION`` (f32 on the CUDA cores) for f32 queries and other head
  dims or pages.
* :func:`paged_attention_decode` (B2) replaces ``paged_attention_decode``
  (``_decode_kernel``): T=1, mask ``key < seq_len`` (+ window),
  ``dh % 128 == 0``.
* :func:`paged_attention_decode_grouped` (B6) replaces
  ``paged_attention_decode_grouped`` (``_decode_grouped_kernel``): B2's
  function for any even head dim, split over the block table in groups
  of ``group_pages`` pages.
* :func:`paged_attention_decode_packed` (B8) replaces
  ``paged_attention_decode_packed`` (``_decode_packed_kernel``): B2's
  function over an unpadded sub-128 pool (:func:`packable_decode`).
* :func:`paged_attention_decode_batched` (B7) replaces
  ``paged_attention_decode_batched`` (``_decode_batched_kernel``): B2's
  function, the whole batch in one persistent launch. Neither engine
  calls it.
* :func:`paged_attention_decode_append` (B9) replaces
  ``paged_attention_decode_append`` (``_decode_append_kernel``): B2 with
  the T=1 KV append fused in; :func:`decode_append_supported` gates it.

:func:`decode_route` is the JAX backend's choice between B2, B8 and B6
for a T=1 call. What bounds the kernels on the H100 and what the designs
do about it is in the sources' header notes. The plain versions
(:func:`paged_attention_plain`, :func:`paged_attention_decode_plain`, on
which the B6-B8 twins are built) gather each sequence's pages through
the block table and run a masked f32 softmax with the same fold order;
:func:`paged_attention_decode_append_plain` is the append's plain
version followed by B2's. The wrappers take them for CPU tensors only
and launch the kernel (or raise) for CUDA tensors.

The per-page score export (``return_scores``, the beam slice) is not
ported yet and raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..kvcache.pool import stack_new_kv
from ..utils.platform import (DTYPE_CODES, CudaKernel, F, I, LL, P,
                              aligned16, ptr, stream_handle)
from .kv_append import append_plain
from .kv_append import _check as _check_append

_ATTN_ARGS = [P, P, P, P, P, P]        # q, out, pool, scales, bt, seq_lens
ATTENTION = CudaKernel(
    "paged_attention", "paged_attention.cu", "pbt_paged_attention",
    _ATTN_ARGS + [P] + [I] * 9 + [LL, F, F, I, I, I, P],
    "ops/paged_attention.py:219")
ATTENTION_WGMMA = CudaKernel(
    "paged_attention_wgmma", "paged_prefill.cu", "pbt_paged_attention_wgmma",
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
ATTENTION_DECODE_GROUPED = CudaKernel(
    "paged_attention_decode_grouped", "paged_decode.cu",
    "pbt_paged_attention_decode_grouped",
    _ATTN_ARGS + [P, P] + [I] * 8 + [LL, I, F, F, I, I, I, P],
    "ops/paged_attention.py:442")
ATTENTION_DECODE_PACKED = CudaKernel(
    "paged_attention_decode_packed", "paged_decode.cu",
    "pbt_paged_attention_decode_packed",
    _ATTN_ARGS + [I] * 8 + [LL, F, F, I, I, I, P],
    "ops/paged_attention.py:1083")
ATTENTION_DECODE_BATCHED = CudaKernel(
    "paged_attention_decode_batched", "paged_decode.cu",
    "pbt_paged_attention_decode_batched",
    _ATTN_ARGS + [P] + [I] * 8 + [LL, F, F, I, I, I, P],
    "ops/paged_attention.py:874")

#: the JAX dispatch's budget for the INT8 scales of a whole block-table
#: width, which its B2 gathers into one VMEM block
#: (``engine/paged_backend.py:156-158``)
DECODE_SCALES_BUDGET = 2 << 20
#: the JAX whole-batch kernel's VMEM budget for every page of the batch
_BATCHED_DECODE_VMEM = 8 * 1024 * 1024


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


def _launch_args(q, pool, scales, row_multiple: int = 4):
    """The dtype codes and the scales' row stride of a launch; a K/V
    row's bytes (``D * itemsize``) must be a multiple of
    ``row_multiple``."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q dtype {q.dtype} not supported")
    if pool.dtype not in DTYPE_CODES or not pool.is_contiguous():
        raise ValueError("pool must be contiguous f32/bf16/int8")
    if (pool.shape[5] * pool.element_size()) % row_multiple or \
            pool.shape[5] > 256:
        raise ValueError(f"kernel needs D * itemsize % {row_multiple} == 0 "
                         "and D <= 256")
    if scales is not None and not scales.is_contiguous():
        raise ValueError("scales must be contiguous")
    return (DTYPE_CODES[q.dtype], DTYPE_CODES[pool.dtype],
            0 if scales is None else scales.shape[3] * 128)


def prefill_route(q_dtype: torch.dtype, pool_dtype: torch.dtype,
                  head_dim: int, page_size: int) -> str:
    """B1's kernel for a chunk, by dtype and shape alone: ``"wgmma"``
    (``ATTENTION_WGMMA``, the tensor cores) for bf16 queries over an INT8
    or bf16 pool at a head dim that is a multiple of 16 up to 256, with
    pages of 64 keys or a multiple of 64, or a divisor of 64 that is a
    multiple of 4 (whole pages or whole 64-key tiles per bulk copy,
    scales in 16-byte runs); ``"simt"`` (``ATTENTION``, f32 on the CUDA
    cores) otherwise: f32 queries, an f32 pool, head dims such as 24.
    The bulk copies read 16-byte units, so :func:`paged_attention` hands
    the tensor-core kernel a 16-byte-aligned copy of an operand that is
    a view at an odd offset."""
    page_ok = page_size > 0 and (
        page_size % 64 == 0 or (64 % page_size == 0 and page_size % 4 == 0))
    if (q_dtype == torch.bfloat16
            and pool_dtype in (torch.int8, torch.bfloat16)
            and head_dim % 16 == 0 and head_dim <= 256 and page_ok):
        return "wgmma"
    return "simt"


def paged_attention_plain(q, kv_pages, block_tables, seq_lens, q_offsets,
                          kv_scales=None, layer=None, *, page_size: int,
                          num_q_heads: int, window: int = 0,
                          softcap: float = 0.0,
                          scale: Optional[float] = None,
                          return_scores: bool = False):
    """Plain version of :func:`paged_attention` (same signature)."""
    if return_scores:
        raise NotImplementedError(
            "return_scores (per-page score export): ROADMAP queue A, "
            "beam search")
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
    ``[B, T, H, dh]`` in q's dtype. On CUDA tensors :func:`prefill_route`
    picks the kernel: the tensor-core one for bf16 queries over an INT8
    or bf16 pool at a head dim that is a multiple of 16 (it rounds the
    probabilities to bf16 for the P.V product), the f32 one otherwise;
    each counts its own launches."""
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
    kernel = ATTENTION
    if prefill_route(q.dtype, pool.dtype, D, page_size) == "wgmma":
        kernel = ATTENTION_WGMMA
        q, pool, scales = aligned16(q), aligned16(pool), aligned16(scales)
    out = torch.empty_like(q)
    kernel.launch(
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


def _decode_inputs(q, kv_pages, block_tables, seq_lens, kv_scales, layer,
                   page_size, num_q_heads, row_multiple=4):
    """The checks every decode kernel needs (T=1, at most 8 query heads
    per KV head, B1's input checks) and its launch inputs: the 6-D pool,
    scales and layer, the dtype codes and scales stride, and contiguous
    q, int32 block tables and seq_lens."""
    pool, scales, layer = _pooled(kv_pages, kv_scales, layer)
    _check(q, pool, block_tables, seq_lens, num_q_heads, page_size)
    codes = _launch_args(q, pool, scales, row_multiple)
    if q.shape[1] != 1 or q.shape[2] // pool.shape[2] > 8:
        raise ValueError("decode kernels take T=1 and at most 8 query "
                         "heads per KV head")
    return (pool, scales, layer) + codes + (
        q.contiguous(), block_tables.to(torch.int32).contiguous(),
        seq_lens.to(torch.int32).contiguous())


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
        raise ValueError(
            "paged_attention_decode (B2) takes dh % 128 == 0; a sub-128 "
            "unpadded pool goes to the B6/B8 kernels "
            "(paged_attention_decode_grouped / _packed, see decode_route)")
    if not q.is_cuda:
        return paged_attention_decode_plain(
            q, kv_pages, block_tables, seq_lens, kv_scales, layer,
            page_size=page_size, num_q_heads=num_q_heads, window=window,
            softcap=softcap, scale=scale)
    pool, scales, layer, qd, kd, sstride, q, bt, sl = _decode_inputs(
        q, kv_pages, block_tables, seq_lens, kv_scales, layer, page_size,
        num_q_heads)
    B, _, H, D = q.shape
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    out = torch.empty_like(q)
    ATTENTION_DECODE.launch(
        ptr(q), ptr(out), ptr(pool), ptr(scales), ptr(bt), ptr(sl),
        B, H, pool.shape[2], D, pool.shape[3], page_size, bt.shape[1],
        layer, sstride, float(scale), float(softcap), int(window), qd, kd,
        stream_handle(q))
    return out


def packable_decode(page_size: int, dh: int) -> bool:
    """Sub-128 head dims the packed decode kernel covers: ``dh`` must
    divide the 128-lane row and a page must fill whole packed rows (the
    JAX package's gate, kept as it is so both route alike)."""
    return dh < 128 and 128 % dh == 0 and (page_size * dh) % 128 == 0


def batchable_decode(B: int, mp: int, KH: int, page_size: int,
                     dh_pool: int, itemsize: int) -> bool:
    """True when every sequence's pages fit the JAX whole-batch decode
    kernel's VMEM budget (small models / serving windows). The port's B7
    has no such budget; neither engine consults this gate."""
    return (dh_pool % 128 == 0
            and B * mp * 2 * KH * page_size * dh_pool * itemsize
            <= _BATCHED_DECODE_VMEM)


def decode_route(mp: int, num_kv_heads: int, page_size: int, dh: int,
                 quantized: bool) -> str:
    """The T=1 decode kernel the JAX backend picks
    (``engine/paged_backend.py:156-182``) for a block table ``mp`` pages
    wide over a pool of head dim ``dh``: B2 (``"paged_attention_decode"``)
    for a lane-aligned head dim whose INT8 scales of the whole table
    width fit :data:`DECODE_SCALES_BUDGET`, else B8
    (``"paged_attention_decode_packed"``) for a packable sub-128 pool
    within that budget, else B6 (``"paged_attention_decode_grouped"``):
    other head dims, and every INT8 table wider than the budget (past
    512 pages at Llama-3's 8 KV heads and page 64, a 32k context)."""
    mp_ok = (not quantized or mp * 2 * num_kv_heads * page_size * 4
             <= DECODE_SCALES_BUDGET)
    if dh % 128 == 0 and mp_ok:
        return "paged_attention_decode"
    if packable_decode(page_size, dh) and mp_ok:
        return "paged_attention_decode_packed"
    return "paged_attention_decode_grouped"


def paged_attention_decode_grouped_plain(q, kv_pages, block_tables,
                                         seq_lens, kv_scales=None,
                                         layer=None, *, page_size: int,
                                         num_q_heads: int, window: int = 0,
                                         softcap: float = 0.0,
                                         scale: Optional[float] = None,
                                         group_pages: int = 4):
    """Plain version of :func:`paged_attention_decode_grouped` (same
    signature): B2's, since grouping pages changes only the order of the
    sums."""
    return paged_attention_decode_plain(
        q, kv_pages, block_tables, seq_lens, kv_scales, layer,
        page_size=page_size, num_q_heads=num_q_heads, window=window,
        softcap=softcap, scale=scale)


#: plain versions of B8 and B7 (same signature): B2's
paged_attention_decode_packed_plain = paged_attention_decode_plain
paged_attention_decode_batched_plain = paged_attention_decode_plain


def paged_attention_decode_grouped(q: torch.Tensor, kv_pages: torch.Tensor,
                                   block_tables: torch.Tensor,
                                   seq_lens: torch.Tensor,
                                   kv_scales: Optional[torch.Tensor] = None,
                                   layer: Optional[int] = None, *,
                                   page_size: int, num_q_heads: int,
                                   window: int = 0, softcap: float = 0.0,
                                   scale: Optional[float] = None,
                                   group_pages: int = 4) -> torch.Tensor:
    """B6: T=1 decode attention for any even head dim up to 256 (at most
    8 query heads per KV head), the block table split into groups of
    ``group_pages`` pages: a block per (sequence, KV head, group) writes
    its partial softmax state, a second kernel of the same call combines
    them. Same inputs and output as :func:`paged_attention_decode`."""
    if not q.is_cuda:
        return paged_attention_decode_grouped_plain(
            q, kv_pages, block_tables, seq_lens, kv_scales, layer,
            page_size=page_size, num_q_heads=num_q_heads, window=window,
            softcap=softcap, scale=scale, group_pages=group_pages)
    pool, scales, layer, qd, kd, sstride, q, bt, sl = _decode_inputs(
        q, kv_pages, block_tables, seq_lens, kv_scales, layer, page_size,
        num_q_heads, row_multiple=2)
    B, _, H, D = q.shape
    mp = bt.shape[1]
    J = max(1, min(group_pages, mp))
    n_groups = -(-mp // J)
    G = H // pool.shape[2]
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    part_acc = torch.empty((B * pool.shape[2], n_groups, G, D),
                           dtype=torch.float32, device=q.device)
    part_ml = torch.empty((B * pool.shape[2], n_groups, G, 2),
                          dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    ATTENTION_DECODE_GROUPED.launch(
        ptr(q), ptr(out), ptr(pool), ptr(scales), ptr(bt), ptr(sl),
        ptr(part_acc), ptr(part_ml), B, H, pool.shape[2], D, pool.shape[3],
        page_size, mp, layer, sstride, J, float(scale), float(softcap),
        int(window), qd, kd, stream_handle(q))
    return out


def paged_attention_decode_packed(q: torch.Tensor, kv_pages: torch.Tensor,
                                  block_tables: torch.Tensor,
                                  seq_lens: torch.Tensor,
                                  kv_scales: Optional[torch.Tensor] = None,
                                  layer: Optional[int] = None, *,
                                  page_size: int, num_q_heads: int,
                                  window: int = 0, softcap: float = 0.0,
                                  scale: Optional[float] = None
                                  ) -> torch.Tensor:
    """B8: T=1 decode attention over an unpadded sub-128 pool
    (:func:`packable_decode`: dh 16, 32 or 64 at the engine's pages); the
    kernel reads K rows with 16-byte loads, so it also needs ``dh *
    itemsize % 16 == 0``. Same inputs and output as
    :func:`paged_attention_decode`."""
    if not packable_decode(page_size, q.shape[3]):
        raise ValueError(f"packable_decode({page_size}, {q.shape[3]}) is "
                         "False: the packed decode kernel does not cover "
                         "this pool")
    if not q.is_cuda:
        return paged_attention_decode_packed_plain(
            q, kv_pages, block_tables, seq_lens, kv_scales, layer,
            page_size=page_size, num_q_heads=num_q_heads, window=window,
            softcap=softcap, scale=scale)
    pool, scales, layer, qd, kd, sstride, q, bt, sl = _decode_inputs(
        q, kv_pages, block_tables, seq_lens, kv_scales, layer, page_size,
        num_q_heads, row_multiple=16)
    if pool.data_ptr() % 16:
        raise ValueError("the pool must be 16-byte aligned")
    B, _, H, D = q.shape
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    out = torch.empty_like(q)
    ATTENTION_DECODE_PACKED.launch(
        ptr(q), ptr(out), ptr(pool), ptr(scales), ptr(bt), ptr(sl),
        B, H, pool.shape[2], D, pool.shape[3], page_size, bt.shape[1],
        layer, sstride, float(scale), float(softcap), int(window), qd, kd,
        stream_handle(q))
    return out


def paged_attention_decode_batched(q: torch.Tensor, kv_pages: torch.Tensor,
                                   block_tables: torch.Tensor,
                                   seq_lens: torch.Tensor,
                                   kv_scales: Optional[torch.Tensor] = None,
                                   layer: Optional[int] = None, *,
                                   page_size: int, num_q_heads: int,
                                   window: int = 0, softcap: float = 0.0,
                                   scale: Optional[float] = None
                                   ) -> torch.Tensor:
    """B7: B2's function (``dh % 128 == 0``, as in the JAX package) with
    the whole batch in one launch: a persistent kernel, at most one block
    per SM, each block taking (sequence, KV head) items from a counter.
    Same inputs and output as :func:`paged_attention_decode`."""
    if q.shape[3] % 128:
        raise ValueError("paged_attention_decode_batched (B7) takes "
                         "dh % 128 == 0")
    if not q.is_cuda:
        return paged_attention_decode_batched_plain(
            q, kv_pages, block_tables, seq_lens, kv_scales, layer,
            page_size=page_size, num_q_heads=num_q_heads, window=window,
            softcap=softcap, scale=scale)
    pool, scales, layer, qd, kd, sstride, q, bt, sl = _decode_inputs(
        q, kv_pages, block_tables, seq_lens, kv_scales, layer, page_size,
        num_q_heads)
    B, _, H, D = q.shape
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    next_item = torch.empty((1,), dtype=torch.int32, device=q.device)
    out = torch.empty_like(q)
    ATTENTION_DECODE_BATCHED.launch(
        ptr(q), ptr(out), ptr(pool), ptr(scales), ptr(bt), ptr(sl),
        ptr(next_item), B, H, pool.shape[2], D, pool.shape[3], page_size,
        bt.shape[1], layer, sstride, float(scale), float(softcap),
        int(window), qd, kd, stream_handle(q))
    return out


def decode_append_supported(kv, dh: int, mp: int) -> bool:
    """Gate of :func:`paged_attention_decode_append` for a pool ``kv``
    whose head dim is ``dh`` under a block table ``mp`` pages wide: what
    B2's kernel reads (a layer-pooled ``[L, 2, KH, P, page, dh]`` pool of
    int8/bf16/f32 with ``dh <= 256``, INT8 scales as the flat ``[L, 2,
    KH, R, 128]`` leaf) where the T=1 route is B2's (:func:`decode_route`),
    as in the JAX package, whose route there is B3 + B6 or B8. The JAX
    gate's other conditions are TPU facts and are dropped: the whole
    context window in 4 MiB of VMEM, a page divisible by the dtype's
    sublane tile, and 8-row slabs of the scales leaf (``R % 8``)."""
    pool = kv[0]
    if dh > 256 or pool.dim() != 6 or pool.shape[5] != dh:
        return False
    if pool.dtype not in DTYPE_CODES:
        return False
    if len(kv) == 2 and kv[1].shape[-1] != 128:
        return False
    return decode_route(mp, pool.shape[2], pool.shape[4], dh,
                        len(kv) == 2) == "paged_attention_decode"


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
    if not decode_append_supported(kv, D, block_tables.shape[1]):
        raise ValueError("decode_append_supported(kv, dh, mp) is False for "
                         "this pool and block table")
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
