"""Paged attention over the page pool (prefill chunks and decode).

Hand-written CUDA kernels for the Pallas kernels of the JAX package's
``ops/paged_attention.py``; ``csrc/paged_prefill.cu`` holds B1's
tensor-core kernel, ``csrc/paged_attention.cu`` B1's SIMT kernel, B2 and
B9, ``csrc/paged_decode.cu`` B6 and B7, ``csrc/paged_decode_packed.cu`` B8:

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
  ``dh % 128 == 0``. Split-KV in one launch: :func:`decode_split_plan`
  splits each sequence's block table into runs of pages, a block per
  (sequence, KV head, run) writes its partial softmax state, and the last
  block of a (sequence, KV head) merges them in split order
  (:func:`decode_split_emulation` is that computation in plain PyTorch).
* :func:`paged_attention_decode_grouped` (B6) replaces
  ``paged_attention_decode_grouped`` (``_decode_grouped_kernel``): B2's
  function for any even head dim on B2's split-KV body, one launch: the
  visible pages (counted from the window's first) split by
  :func:`decode_grouped_plan` into runs of a multiple of ``group_pages``
  (:func:`decode_grouped_emulation` in plain PyTorch).
* :func:`paged_attention_decode_packed` (B8) replaces
  ``paged_attention_decode_packed`` (``_decode_packed_kernel``): B2's
  function over an unpadded sub-128 pool (:func:`packable_decode`) on
  B2's split-KV body, one launch: the visible pages split by
  :func:`decode_packed_plan` into runs of single pages, only the runs
  that hold pages merged (:func:`decode_packed_emulation` in plain
  PyTorch).
* :func:`paged_attention_decode_batched` (B7) replaces
  ``paged_attention_decode_batched`` (``_decode_batched_kernel``): B2's
  function, the whole batch in one launch on B2's split-KV body, split by
  the batch's real lengths: each block an equal run of the visible
  (sequence, KV head, page) units (:func:`decode_batched_partition`;
  :func:`decode_batched_emulation` in plain PyTorch). Neither engine
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
from ..utils.common import cdiv
from ..utils.platform import (DTYPE_CODES, SMS, CudaKernel, F, I, LL, P,
                              aligned16, ptr, split_counters, stream_handle)
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
    _ATTN_ARGS + [P, P, P] + [I] * 8 + [LL, I, I, F, F, I, I, I, P],
    "ops/paged_attention.py:671")
ATTENTION_DECODE_APPEND = CudaKernel(
    "paged_attention_decode_append", "paged_attention.cu",
    "pbt_paged_attention_decode_append",
    _ATTN_ARGS + [P, P, P] + [I] * 8 + [LL, F, F, I, I, I, P],
    "ops/paged_attention.py:1380")
ATTENTION_DECODE_GROUPED = CudaKernel(
    "paged_attention_decode_grouped", "paged_decode.cu",
    "pbt_paged_attention_decode_grouped",
    _ATTN_ARGS + [P, P, P] + [I] * 8 + [LL, I, I, I, I, F, F, I, I, I, P],
    "ops/paged_attention.py:442")
ATTENTION_DECODE_PACKED = CudaKernel(
    "paged_attention_decode_packed", "paged_decode_packed.cu",
    "pbt_paged_attention_decode_packed",
    _ATTN_ARGS + [P, P, P] + [I] * 8 + [LL, I, I, I, F, F, I, I, I, P],
    "ops/paged_attention.py:1083")
ATTENTION_DECODE_BATCHED = CudaKernel(
    "paged_attention_decode_batched", "paged_decode.cu",
    "pbt_paged_attention_decode_batched",
    _ATTN_ARGS + [P, P, P] + [I] * 8 + [LL, I, F, F, I, I, I, P],
    "ops/paged_attention.py:874")

#: the JAX dispatch's budget for the INT8 scales of a whole block-table
#: width, which its B2 gathers into one VMEM block
#: (``engine/paged_backend.py:156-158``)
DECODE_SCALES_BUDGET = 2 << 20
#: the JAX whole-batch kernel's VMEM budget for every page of the batch
_BATCHED_DECODE_VMEM = 8 * 1024 * 1024
#: most splits of B2's and B6's key range (``csrc/split_decode.cuh``'s
#: ``kMaxSplits``: the merge keeps a weight per split and row in shared
#: memory)
DECODE_MAX_SPLITS = 64


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


def _fold(q, pool, scales, layer, block_tables, seq_lens, q_pos, window,
          softcap, scale):
    """The reference's fold up to the softmax, for ``q [B, T, H, D]``
    (rows at absolute positions ``q_pos [B, T]``) over the sequences'
    gathered pages: the masked f32 scores ``[B, KH, T, G, S]`` (-1e30
    where not visible), the visibility ``[B, 1, T, 1, S]``, the gathered
    values ``[KH, B, S, D]`` and the V scales (or None)."""
    B, T, H, D = q.shape
    KH, page = pool.shape[2], pool.shape[4]
    G = H // KH
    mp = block_tables.shape[1]
    bt = block_tables.long()
    g = pool[layer][:, :, bt].reshape(2, KH, B, mp * page, D).float()
    k, v = g[0], g[1]                                     # [KH, B, S, D]
    qf = q.float().reshape(B, T, KH, G, D) * scale
    s = torch.einsum("btkgd,kbsd->bktgs", qf, k)          # [B, KH, T, G, S]
    vscale = None
    if scales is not None:
        slots = (bt[:, :, None] * page
                 + torch.arange(page, device=q.device)).reshape(B, -1)
        sc = scales[layer].reshape(2, KH, -1)[:, :, slots]   # [2, KH, B, S]
        sc = sc.permute(0, 2, 1, 3)[:, :, :, None, None, :]  # [2, B, KH,..]
        s = s * sc[0]
        vscale = sc[1]
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    key = torch.arange(mp * page, device=q.device)
    vis = (key <= q_pos[:, :, None]) & (key < seq_lens[:, None, None])
    if window > 0:
        vis &= key > q_pos[:, :, None] - window
    vis = vis[:, None, :, None, :]                        # [B, 1, T, 1, S]
    s = torch.where(vis, s, torch.full_like(s, -1e30))
    return s, vis, v, vscale


def _attend_plain(q, pool, scales, layer, block_tables, seq_lens, q_pos,
                  window, softcap, scale):
    """Masked f32 softmax of ``q [B, T, H, D]`` (rows at absolute
    positions ``q_pos [B, T]``) over the sequences' gathered pages."""
    B, T, H, D = q.shape
    s, vis, v, vscale = _fold(q, pool, scales, layer, block_tables,
                              seq_lens, q_pos, window, softcap, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(vis, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    if vscale is not None:
        p = p * vscale
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


def decode_split_plan(batch: int, kv_heads: int, mp: int):
    """B2's ``(splits, pages_per_split)`` for ``batch`` sequences of
    ``kv_heads`` KV heads over a block table ``mp`` pages wide, from the
    shapes alone (the lengths stay on the device): as many splits as
    bring the grid to about two waves of the SMs (``2 * SMS`` blocks), at
    most one a page and :data:`DECODE_MAX_SPLITS`, each a run of whole
    pages (the last may be shorter)."""
    want = max(1, min(mp, cdiv(2 * SMS, batch * kv_heads),
                      DECODE_MAX_SPLITS))
    pps = max(1, cdiv(mp, want))
    return max(1, cdiv(mp, pps)), pps


def _merge_parts(s, vis, v, vscale, masks):
    """The split-KV computation over the reference's fold (:func:`_fold`)
    in plain PyTorch (f32): each part, a bool key mask broadcastable to
    ``s`` (``[B or 1, KH or 1, 1, 1, S]``), folds its keys into a partial
    ``(m, l, acc)`` (a part with no visible key gives ``m = -1e30, l = 0,
    acc = 0``), and the partials merge in the list's order: ``M = max
    m``, ``w = e^(m - M)``, ``out = sum acc w / sum l w`` with the ``l ==
    0 -> 1`` guard. Returns ``[B, KH, T, G, D]``."""
    parts = []
    for mask in masks:
        ss = torch.where(mask, s, torch.full_like(s, -1e30))
        m = ss.amax(dim=-1, keepdim=True)
        p = torch.where(vis & mask, torch.exp(ss - m), torch.zeros_like(ss))
        l = p.sum(dim=-1, keepdim=True)
        if vscale is not None:
            p = p * vscale
        parts.append((m, l, torch.einsum("bktgs,kbsd->bktgd", p, v)))
    mx = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    acc = torch.zeros_like(parts[0][2])
    lsum = torch.zeros_like(parts[0][1])
    for m, l, a in parts:
        w = torch.exp(m - mx)
        acc = acc + a * w
        lsum = lsum + l * w
    return acc / torch.where(lsum == 0, torch.ones_like(lsum), lsum)


def _emulation_fold(q, kv_pages, block_tables, seq_lens, kv_scales, layer,
                    page_size, num_q_heads, window, softcap, scale):
    """The decode emulations' common inputs: the checked pool and the
    reference's fold (:func:`_fold`) of the lone query at ``seq_len -
    1``."""
    pool, scales, layer = _pooled(kv_pages, kv_scales, layer)
    _check(q, pool, block_tables, seq_lens, num_q_heads, page_size)
    if q.shape[1] != 1:
        raise ValueError("decode attention takes T=1")
    scale = 1.0 / math.sqrt(q.shape[3]) if scale is None else scale
    return pool, _fold(q, pool, scales, layer, block_tables, seq_lens,
                       seq_lens.long()[:, None] - 1, window, softcap, scale)


def _emulation_out(q, acc):
    B, _, H, D = q.shape
    return acc.permute(0, 2, 1, 3, 4).reshape(B, 1, H, D).to(q.dtype)


def decode_split_emulation(q, kv_pages, block_tables, seq_lens,
                           kv_scales=None, layer=None, *, page_size: int,
                           num_q_heads: int, window: int = 0,
                           softcap: float = 0.0,
                           scale: Optional[float] = None,
                           pages_per_split: Optional[int] = None,
                           order=None):
    """B2's split-KV computation in plain PyTorch (f32), for tests and
    checks: each run of ``pages_per_split`` pages of the block table
    (:func:`decode_split_plan`'s by default) folds its keys into a
    partial ``(m, l, acc)`` (a run with no visible key gives ``m =
    -1e30, l = 0, acc = 0``), and the partials merge in ``order`` (split
    order by default): ``M = max m``, ``w = e^(m - M)``, ``out = sum acc
    w / sum l w`` with the ``l == 0 -> 1`` guard. Same inputs and output
    as :func:`paged_attention_decode_plain`, which it equals up to the
    order of the sums."""
    pool, (s, vis, v, vscale) = _emulation_fold(
        q, kv_pages, block_tables, seq_lens, kv_scales, layer, page_size,
        num_q_heads, window, softcap, scale)
    mp = block_tables.shape[1]
    pps = (decode_split_plan(q.shape[0], pool.shape[2], mp)[1]
           if pages_per_split is None else pages_per_split)
    page = torch.arange(mp * page_size, device=q.device) // page_size
    masks = [(page >= lo) & (page < lo + pps) for lo in range(0, mp, pps)]
    order = range(len(masks)) if order is None else order
    return _emulation_out(q, _merge_parts(s, vis, v, vscale,
                                          [masks[i] for i in order]))


def _visible_pages(seq_lens, page_size: int, mp: int, window: int):
    """Each sequence's visible pages ``[first, n_pages)`` of its block
    table at a T=1 query (``csrc/paged_attention.cuh``'s
    ``first_decode_page`` / ``decode_pages``), as tensors."""
    sl = seq_lens.long()
    n_pages = torch.clamp((sl + page_size - 1) // page_size, max=mp)
    first = (torch.clamp(sl - window, min=0) // page_size if window > 0
             else torch.zeros_like(sl))
    return first, n_pages


def decode_grouped_plan(batch: int, kv_heads: int, mp: int, page_size: int,
                        window: int = 0, group_pages: int = 4):
    """B6's ``(splits, pages_per_split)``, from the shapes alone (the
    lengths stay on the device): the most pages a sequence can have
    visible (the table width ``mp``, or with a window the pages ``window``
    keys can span, ``cdiv(window - 1, page) + 1``, if fewer) split in runs
    of a multiple of ``group_pages`` (the JAX kernel's pages a grid step,
    clamped to ``mp``), as many as bring the grid to about two waves of
    the SMs (:func:`decode_split_plan`'s rule), at most
    :data:`DECODE_MAX_SPLITS`. Split ``s`` of a sequence takes the pages
    ``first + s * pps ..`` counted from its window's first visible page."""
    J = max(1, min(group_pages, mp))
    width = mp if window <= 0 else min(mp, cdiv(window - 1, page_size) + 1)
    want = max(1, min(width, cdiv(2 * SMS, batch * kv_heads),
                      DECODE_MAX_SPLITS))
    pps = cdiv(cdiv(width, want), J) * J
    return max(1, cdiv(width, pps)), pps


def _runs_from_first(q, kv_pages, block_tables, seq_lens, kv_scales, layer,
                     page_size, num_q_heads, window, softcap, scale, plan,
                     order, skip_empty):
    """B6's and B8's split-KV computation in plain PyTorch (f32): runs of
    ``pps`` pages counted from each sequence's first visible page (``plan
    (KH, mp) -> (splits, pps)``), merged in ``order`` (split order by
    default) as :func:`decode_split_emulation` merges B2's. With
    ``skip_empty`` a run past a sequence's visible pages takes no part in
    its merge (B8's early exit; such a run would add exact zeros)."""
    pool, (s, vis, v, vscale) = _emulation_fold(
        q, kv_pages, block_tables, seq_lens, kv_scales, layer, page_size,
        num_q_heads, window, softcap, scale)
    mp = block_tables.shape[1]
    splits, pps = plan(pool.shape[2], mp)
    first, n_pages = _visible_pages(seq_lens, page_size, mp, window)
    page = torch.arange(mp * page_size, device=q.device) // page_size
    rel = (page - first[:, None])[:, None, None, None, :]   # [B, 1,1,1, S]
    order = range(splits) if order is None else order
    if not skip_empty:
        masks = [(rel >= i * pps) & (rel < i * pps + pps) for i in order]
        return _emulation_out(q, _merge_parts(s, vis, v, vscale, masks))
    # each sequence merges only its runs that hold pages (at least run 0)
    parts = torch.clamp((n_pages - first + pps - 1) // pps, min=1)
    outs = []
    for b in range(q.shape[0]):
        masks = [(rel[b:b + 1] >= i * pps) & (rel[b:b + 1] < i * pps + pps)
                 for i in order if i < int(parts[b])]
        outs.append(_merge_parts(
            s[b:b + 1], vis[b:b + 1], v[:, b:b + 1],
            None if vscale is None else vscale[b:b + 1], masks))
    return _emulation_out(q, torch.cat(outs))


def decode_grouped_emulation(q, kv_pages, block_tables, seq_lens,
                             kv_scales=None, layer=None, *, page_size: int,
                             num_q_heads: int, window: int = 0,
                             softcap: float = 0.0,
                             scale: Optional[float] = None,
                             group_pages: int = 4, order=None):
    """B6's split-KV computation in plain PyTorch (f32), for tests and
    checks: :func:`decode_grouped_plan`'s runs of pages, counted from each
    sequence's first visible page, merged in ``order`` (split order by
    default) as :func:`decode_split_emulation` merges B2's. Same inputs
    and output as :func:`paged_attention_decode_grouped_plain`."""
    return _runs_from_first(
        q, kv_pages, block_tables, seq_lens, kv_scales, layer, page_size,
        num_q_heads, window, softcap, scale,
        lambda kh, mp: decode_grouped_plan(q.shape[0], kh, mp, page_size,
                                           window, group_pages),
        order, skip_empty=False)


def decode_packed_plan(batch: int, kv_heads: int, mp: int, page_size: int,
                       window: int = 0):
    """B8's ``(splits, pages_per_split)``, from the shapes alone:
    :func:`decode_grouped_plan` with runs of single pages (B8 has no page
    grouping to keep), so a table of a few pages a sequence (TinyLlama's
    1-3 on path (g)) gets a split a page, up to about two waves of the
    SMs. A split past a sequence's visible pages exits at once."""
    return decode_grouped_plan(batch, kv_heads, mp, page_size, window,
                               group_pages=1)


def decode_packed_emulation(q, kv_pages, block_tables, seq_lens,
                            kv_scales=None, layer=None, *, page_size: int,
                            num_q_heads: int, window: int = 0,
                            softcap: float = 0.0,
                            scale: Optional[float] = None, order=None):
    """B8's split-KV computation in plain PyTorch (f32), for tests and
    checks: :func:`decode_packed_plan`'s runs of pages from each
    sequence's first visible one, only the runs that hold pages merged, in
    ``order`` (split order by default). Same inputs and output as
    :func:`paged_attention_decode_packed_plain`."""
    return _runs_from_first(
        q, kv_pages, block_tables, seq_lens, kv_scales, layer, page_size,
        num_q_heads, window, softcap, scale,
        lambda kh, mp: decode_packed_plan(q.shape[0], kh, mp, page_size,
                                          window),
        order, skip_empty=True)


def decode_batched_blocks(batch: int, kv_heads: int, mp: int) -> int:
    """B7's grid, from the shapes alone: about two waves of the SMs, no
    more blocks than the batch has (sequence, KV head, page) units."""
    return max(1, min(2 * SMS, batch * kv_heads * mp))


def decode_batched_partition(seq_lens, kv_heads: int, page_size: int,
                             mp: int, window: int = 0,
                             blocks: Optional[int] = None):
    """B7's cut of the work, as its kernel computes it
    (``csrc/paged_decode.cu``'s ``decode_batched_split_kernel``), from
    the lengths ``seq_lens`` (a list): the visible pages of (sequence b,
    KV head h) are the units ``[KH * pre[b] + h * vis_b, .. + vis_b)`` of
    the batch's ``U`` (``pre`` the prefix of the sequences' visible page
    counts ``vis_b``), and block ``k`` of ``blocks``
    (:func:`decode_batched_blocks`'s by default) takes the units ``[k U
    // R, (k + 1) U // R)`` of ``R = min(blocks, U)`` runs (a block past
    them none), so that no run is empty. Returns, for each block, its parts
    in order as ``(j, first_page, pages, part, parts)``: ``j = b * KH +
    h``, the block-table pages ``[first_page, first_page + pages)``, and
    the part's index among ``j``'s ``parts`` (the blocks whose runs hold
    ``j``'s first and last unit, each block deriving them alone)."""
    B, KH = len(seq_lens), kv_heads
    blocks = decode_batched_blocks(B, KH, mp) if blocks is None else blocks
    firsts, vis, pre = [], [], [0]
    for n in seq_lens:
        first = max(n - window, 0) // page_size if window > 0 else 0
        firsts.append(first)
        vis.append(max(min(cdiv(n, page_size), mp) - first, 0))
        pre.append(pre[-1] + vis[-1])
    U = KH * pre[-1]
    runs = min(blocks, U)       # so that no run is empty
    out = []
    for k in range(blocks):
        parts = []
        u, u1 = (k * U // runs, (k + 1) * U // runs) if k < runs else (0, 0)
        while u < u1:
            b = max(i for i in range(B) if KH * pre[i] <= u)
            h = (u - KH * pre[b]) // vis[b]
            s0 = KH * pre[b] + h * vis[b]
            e0 = s0 + vis[b]
            k0, k1 = ((s0 + 1) * runs - 1) // U, (e0 * runs - 1) // U
            n = min(e0, u1) - u
            parts.append((b * KH + h, firsts[b] + u - s0, n, k - k0,
                          k1 - k0 + 1))
            u += n
        out.append(parts)
    return out


def decode_batched_emulation(q, kv_pages, block_tables, seq_lens,
                             kv_scales=None, layer=None, *, page_size: int,
                             num_q_heads: int, window: int = 0,
                             softcap: float = 0.0,
                             scale: Optional[float] = None,
                             blocks: Optional[int] = None,
                             reverse: bool = False):
    """B7's computation in plain PyTorch (f32), for tests and checks:
    :func:`decode_batched_partition`'s parts of each (sequence, KV head),
    merged in part order (or in reverse) as :func:`decode_split_emulation`
    merges B2's splits; a (sequence, KV head) with no visible page gives
    zeros. Same inputs and output as
    :func:`paged_attention_decode_batched_plain`."""
    pool, (s, vis, v, vscale) = _emulation_fold(
        q, kv_pages, block_tables, seq_lens, kv_scales, layer, page_size,
        num_q_heads, window, softcap, scale)
    B, KH, mp = q.shape[0], pool.shape[2], block_tables.shape[1]
    by_head = [[] for _ in range(B * KH)]
    for parts in decode_batched_partition(
            [int(n) for n in seq_lens.tolist()], KH, page_size, mp, window,
            blocks):
        for j, first, n, part, _ in parts:
            by_head[j].append((part, first, n))
    page = torch.arange(mp * page_size, device=q.device) // page_size
    masks = torch.zeros((max(1, max(map(len, by_head))), B * KH,
                         mp * page_size), dtype=torch.bool, device=q.device)
    for j, parts in enumerate(by_head):
        parts.sort(reverse=reverse)
        for i, (_, first, n) in enumerate(parts):
            masks[i, j] = (page >= first) & (page < first + n)
    masks = masks.reshape(-1, B, KH, 1, 1, mp * page_size)
    return _emulation_out(q, _merge_parts(s, vis, v, vscale, list(masks)))


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
    """B2: T=1 decode attention (q ``[B, 1, H, dh]``, ``dh`` 128 or 256
    (``dh % 128 == 0`` as in the JAX package); at most 8 query heads per
    KV head). Mask ``key < seq_len`` (+ window). Returns ``[B, 1, H,
    dh]``. One launch: the key range split by :func:`decode_split_plan`,
    the splits merged in split order by the last block of each
    (sequence, KV head)."""
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
    pool, scales = aligned16(pool), aligned16(scales)
    B, _, H, D = q.shape
    KH, mp = pool.shape[2], bt.shape[1]
    G = H // KH
    splits, pps = decode_split_plan(B, KH, mp)
    part_acc = part_ml = counters = None
    if splits > 1:
        part_acc = torch.empty((B * KH, splits, G, D), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((B * KH, splits, G, 2), dtype=torch.float32,
                              device=q.device)
        counters = split_counters(q.device, B * KH)
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    out = torch.empty_like(q)
    ATTENTION_DECODE.launch(
        ptr(q), ptr(out), ptr(pool), ptr(scales), ptr(bt), ptr(sl),
        ptr(part_acc), ptr(part_ml), ptr(counters), B, H, KH, D,
        pool.shape[3], page_size, mp, layer, sstride, splits, pps,
        float(scale), float(softcap), int(window), qd, kd, stream_handle(q))
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
    8 query heads per KV head). One launch of B2's split-KV body: the
    visible pages of each (sequence, KV head), counted from the window's
    first, split by :func:`decode_grouped_plan` into runs of a multiple
    of ``group_pages`` pages, the runs merged in order by the last to
    finish. Same inputs and output as :func:`paged_attention_decode`."""
    if not q.is_cuda:
        return paged_attention_decode_grouped_plain(
            q, kv_pages, block_tables, seq_lens, kv_scales, layer,
            page_size=page_size, num_q_heads=num_q_heads, window=window,
            softcap=softcap, scale=scale, group_pages=group_pages)
    splits, pps = decode_grouped_plan(
        q.shape[0], kv_pages.shape[-4], block_tables.shape[1], page_size,
        window, group_pages)
    return decode_grouped_launch(
        q, kv_pages, block_tables, seq_lens, kv_scales, layer,
        page_size=page_size, num_q_heads=num_q_heads, window=window,
        softcap=softcap, scale=scale, splits=splits, pages_per_split=pps)


def decode_grouped_launch(q, kv_pages, block_tables, seq_lens,
                          kv_scales=None, layer=None, *, page_size: int,
                          num_q_heads: int, window: int = 0,
                          softcap: float = 0.0,
                          scale: Optional[float] = None, splits: int,
                          pages_per_split: int, stages: int = 0,
                          rows: int = 0) -> torch.Tensor:
    """B6's launch at a given cut: ``splits`` runs of ``pages_per_split``
    pages from each sequence's first visible one (``splits *
    pages_per_split`` must cover what a window leaves visible), a ring of
    ``stages`` pages and an instance of ``rows`` query rows (0: the
    kernel's choice of each). :func:`paged_attention_decode_grouped` calls
    it with :func:`decode_grouped_plan`'s cut; a sweep calls it with
    others."""
    pool, scales, layer, qd, kd, sstride, q, bt, sl = _decode_inputs(
        q, kv_pages, block_tables, seq_lens, kv_scales, layer, page_size,
        num_q_heads, row_multiple=2)
    pool, scales = aligned16(pool), aligned16(scales)
    B, _, H, D = q.shape
    KH, mp = pool.shape[2], bt.shape[1]
    G = H // KH
    part_acc = part_ml = counters = None
    if splits > 1:
        part_acc = torch.empty((B * KH, splits, G, D), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((B * KH, splits, G, 2), dtype=torch.float32,
                              device=q.device)
        counters = split_counters(q.device, B * KH)
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    out = torch.empty_like(q)
    ATTENTION_DECODE_GROUPED.launch(
        ptr(q), ptr(out), ptr(pool), ptr(scales), ptr(bt), ptr(sl),
        ptr(part_acc), ptr(part_ml), ptr(counters), B, H, KH, D,
        pool.shape[3], page_size, mp, layer, sstride, splits,
        pages_per_split, stages, rows, float(scale), float(softcap),
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
    (:func:`packable_decode`: dh 16, 32 or 64 at the engine's pages; the
    kernel is compiled for those three). One launch of B2's split-KV body:
    the visible pages of each (sequence, KV head), counted from the
    window's first, split by :func:`decode_packed_plan`, the splits that
    hold pages merged in order by the last to finish. Same inputs and
    output as :func:`paged_attention_decode`."""
    if not packable_decode(page_size, q.shape[3]):
        raise ValueError(f"packable_decode({page_size}, {q.shape[3]}) is "
                         "False: the packed decode kernel does not cover "
                         "this pool")
    if not q.is_cuda:
        return paged_attention_decode_packed_plain(
            q, kv_pages, block_tables, seq_lens, kv_scales, layer,
            page_size=page_size, num_q_heads=num_q_heads, window=window,
            softcap=softcap, scale=scale)
    splits, pps = decode_packed_plan(q.shape[0], kv_pages.shape[-4],
                                     block_tables.shape[1], page_size,
                                     window)
    return decode_packed_launch(
        q, kv_pages, block_tables, seq_lens, kv_scales, layer,
        page_size=page_size, num_q_heads=num_q_heads, window=window,
        softcap=softcap, scale=scale, splits=splits, pages_per_split=pps)


def decode_packed_launch(q, kv_pages, block_tables, seq_lens,
                         kv_scales=None, layer=None, *, page_size: int,
                         num_q_heads: int, window: int = 0,
                         softcap: float = 0.0,
                         scale: Optional[float] = None, splits: int,
                         pages_per_split: int,
                         stages: int = 0) -> torch.Tensor:
    """B8's launch at a given cut (as :func:`decode_grouped_launch` takes
    B6's): ``splits`` runs of ``pages_per_split`` pages from each
    sequence's first visible one and a ring of ``stages`` pages (0: the
    kernel's choice). :func:`paged_attention_decode_packed` calls it with
    :func:`decode_packed_plan`'s cut; a sweep calls it with others."""
    pool, scales, layer, qd, kd, sstride, q, bt, sl = _decode_inputs(
        q, kv_pages, block_tables, seq_lens, kv_scales, layer, page_size,
        num_q_heads, row_multiple=16)
    pool, scales = aligned16(pool), aligned16(scales)
    B, _, H, D = q.shape
    KH, mp = pool.shape[2], bt.shape[1]
    G = H // KH
    part_acc = part_ml = counters = None
    if splits > 1:
        part_acc = torch.empty((B * KH, splits, G, D), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((B * KH, splits, G, 2), dtype=torch.float32,
                              device=q.device)
        counters = split_counters(q.device, B * KH)
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    out = torch.empty_like(q)
    ATTENTION_DECODE_PACKED.launch(
        ptr(q), ptr(out), ptr(pool), ptr(scales), ptr(bt), ptr(sl),
        ptr(part_acc), ptr(part_ml), ptr(counters), B, H, KH, D,
        pool.shape[3], page_size, mp, layer, sstride, splits,
        pages_per_split, stages, float(scale), float(softcap), int(window),
        qd, kd, stream_handle(q))
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
    the whole batch in one launch of B2's split-KV body, split by the
    batch's real lengths: :func:`decode_batched_blocks` blocks, each an
    equal run of the visible (sequence, KV head, page) units
    (:func:`decode_batched_partition`), the parts of a (sequence, KV head)
    merged in order by the last to finish. Same inputs and output as
    :func:`paged_attention_decode`."""
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
    pool, scales = aligned16(pool), aligned16(scales)
    B, _, H, D = q.shape
    KH, mp = pool.shape[2], bt.shape[1]
    G = H // KH
    blocks = decode_batched_blocks(B, KH, mp)
    part_acc = torch.empty((blocks + B * KH, G, D), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((blocks + B * KH, G, 2), dtype=torch.float32,
                          device=q.device)
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    out = torch.empty_like(q)
    ATTENTION_DECODE_BATCHED.launch(
        ptr(q), ptr(out), ptr(pool), ptr(scales), ptr(bt), ptr(sl),
        ptr(part_acc), ptr(part_ml), ptr(split_counters(q.device, B * KH)),
        B, H, KH, D, pool.shape[3], page_size, mp, layer, sstride, blocks,
        float(scale), float(softcap), int(window), qd, kd, stream_handle(q))
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
