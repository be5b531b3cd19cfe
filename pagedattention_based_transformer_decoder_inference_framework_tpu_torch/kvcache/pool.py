"""Device-side paged KV pool.

The layout is the JAX package's (``kvcache/pool.py``), so the two pools
compare element by element: K and V live in ONE tensor
``[L, 2, KH, P, page, dh_pool]`` (axis 1 = K/V); INT8 pools add a flat
f32 scales tensor ``[L, 2, KH, R, 128]`` (``R = ceil(P*page/128)``),
where flat slot ``p*page + s`` lives at row ``slot//128``, lane
``slot%128`` — i.e. at linear index ``slot`` of the trailing
``[R*128]``. Page 0 is the dump page (``PageAllocator.DUMP_PAGE``);
block tables are zero-padded.

Unlike the JAX package, which threads the pool through its functions
and gets a new one back, the port updates the pool tensors IN PLACE:
``append_to_pages_at_layer`` and ``ops.kv_append.kv_append`` write into
the tensors they are given and return the same tuple.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..config import CacheConfig, ModelConfig
from ..utils.common import cdiv, torch_dtype

PAGES_AXIS = -3          # pages axis of every values pool leaf


@dataclasses.dataclass(frozen=True)
class PagePool:
    """Factory/descriptor for paged KV state."""

    cfg: ModelConfig
    cache: CacheConfig

    @property
    def page_size(self) -> int:
        return self.cache.page_size

    @property
    def num_pages(self) -> int:
        return self.cache.num_pages

    @property
    def pool_head_dim(self) -> int:
        """Stored head dim: sub-128 dims pad to the next 128 multiple by
        default (``CacheConfig.pad_head_dim``); the padding lanes are
        zeros and cancel in every dot."""
        dh = self.cfg.head_dim
        if self.cache.pads(dh):
            return cdiv(dh, 128) * 128
        return dh

    def init(self, device) -> Tuple[torch.Tensor, ...]:
        """Return the zeroed KV state on ``device``: bf16/f32
        ``(kv_pool,)``; int8 ``(kv_pool, kv_scales)``."""
        c, cc = self.cfg, self.cache
        shape = (c.num_layers, 2, c.num_kv_heads, cc.num_pages,
                 cc.page_size, self.pool_head_dim)
        if cc.kv_dtype == "int8":
            R = cdiv(cc.num_pages * cc.page_size, 128)
            return (torch.zeros(shape, dtype=torch.int8, device=device),
                    torch.zeros(shape[:3] + (R, 128), dtype=torch.float32,
                                device=device))
        return (torch.zeros(shape, dtype=torch_dtype(cc.kv_dtype),
                            device=device),)


def resize_pool(kv, new_num_pages: int):
    """Grow (or shrink) the pool's pages axis, keeping page contents.
    Growing pads zero pages after the existing ones (page ids stay
    valid); shrinking truncates the tail (the caller guarantees no live
    page id >= ``new_num_pages``). The flat INT8 scales resize at row
    granularity, ``R_new = cdiv(new_num_pages * page, 128)``. Returns NEW
    tensors (the old ones are not referenced, so they are freed once the
    caller drops them); a leaf already at its size is returned as it
    is."""
    page_size = kv[0].shape[4]

    def one(leaf):
        if leaf.ndim == 5 and leaf.shape[-1] == 128:
            n_new, n = cdiv(new_num_pages * page_size, 128), leaf.shape[3]
        else:
            n_new, n = new_num_pages, leaf.shape[PAGES_AXIS]
        if n_new == n:
            return leaf
        shape = list(leaf.shape)
        shape[3] = n_new
        out = torch.zeros(shape, dtype=leaf.dtype, device=leaf.device)
        keep = min(n, n_new)
        out[:, :, :, :keep] = leaf[:, :, :, :keep]
        return out

    return tuple(one(leaf) for leaf in kv)


#: the JAX package's ``absmax / 127.0`` compiles (under ``jit``, as its
#: engine runs it) to a multiply by the f32 reciprocal of 127; a Python
#: scalar times an f32 tensor multiplies in f32 by that same value
_INV_127 = 1.0 / 127.0


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) absmax INT8 quantization of ``[..., D]``.
    ``torch.round`` rounds half to even, like ``jnp.round``, and the
    scale is taken as the JAX package's compiled code takes it, so
    values and scales match it bit for bit."""
    x32 = x.float()
    absmax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(absmax, 1e-8) * _INV_127
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def stack_new_kv(kv, k_new: torch.Tensor, v_new: torch.Tensor):
    """Stack ``k/v [B, T, KH, dh]`` into pool-shaped updates.

    Returns pool-dtype news: ``(vals [B, 2, KH, T, dh],)`` or for INT8
    ``(vals int8, scales [B, 2, KH, T, 1])``.
    """
    new = torch.stack([k_new, v_new], dim=1).transpose(2, 3)
    if len(kv) == 2:
        q, s = quantize_kv(new)
        return (q.contiguous(), s.contiguous())
    return (new.to(kv[0].dtype).contiguous(),)


def flat_slots(positions: torch.Tensor, block_tables: torch.Tensor,
               page_size: int) -> torch.Tensor:
    """``[B, T]`` flat pool slot ``page_id * page + pos % page`` of each
    token, ``-1`` where ``positions < 0`` (not written)."""
    pos = positions.clamp_min(0).long()
    page_id = torch.gather(block_tables.long(), 1, pos // page_size)
    flat = page_id * page_size + pos % page_size
    return torch.where(positions >= 0, flat, torch.full_like(flat, -1))


def write_news(kv, news, layer: int, flat: torch.Tensor):
    """Scatter pool-dtype ``news`` (from :func:`stack_new_kv`) to the
    flat slots ``flat [B, T]`` of ``layer``, skipping ``flat < 0``. In
    place; returns ``kv``. The plain version of every append kernel."""
    pool = kv[0]
    L, _, KH, P, page, D = pool.shape
    valid = (flat >= 0).reshape(-1)
    idx = flat.reshape(-1)[valid]
    vals = news[0].permute(1, 2, 0, 3, 4).reshape(2, KH, -1, D)[:, :, valid]
    pool.view(L, 2, KH, P * page, D)[layer][:, :, idx] = vals.to(pool.dtype)
    if len(kv) == 2:
        sc = kv[1]
        new_sc = news[1][..., 0].permute(1, 2, 0, 3).reshape(2, KH, -1)
        sc.view(L, 2, KH, -1)[layer][:, :, idx] = new_sc[:, :, valid]
    return kv


def append_to_pages_at_layer(kv, k_new: torch.Tensor, v_new: torch.Tensor,
                             layer: int, positions: torch.Tensor,
                             block_tables: torch.Tensor):
    """Scatter append of ``k_new/v_new [B, T, KH, D]`` at ``positions
    [B, T]`` into the pool at ``layer``, in place. Positions ``< 0`` are
    dropped. Returns ``kv``."""
    page = kv[0].shape[4]
    return write_news(kv, stack_new_kv(kv, k_new, v_new), layer,
                      flat_slots(positions, block_tables, page))


def copy_pages_tree(kv, src: torch.Tensor, dst: torch.Tensor):
    """Copy pool pages ``src[i] -> dst[i]`` on every leaf, in place (the
    beam search's copy-on-write); returns ``kv``. Values move whole pages
    along the pages axis; the flat INT8 scales move slot by slot
    (``kvcache/swap.py``'s arithmetic), so a page below 128 keys leaves the
    other lanes of its 128-lane row as they were. Every page is read
    before any is written (the destinations are fresh pages, never
    sources); dump-page self-copies (``0 -> 0``) pad the lists and change
    nothing. ``src`` / ``dst``: int tensors ``[n]`` on the pool's device
    (no host read)."""
    from .swap import _flat, _is_scales, _slots

    page_size = kv[0].shape[4]
    src, dst = src.long(), dst.long()
    for leaf in kv:
        if _is_scales(leaf):
            flat = _flat(leaf)
            flat.index_copy_(3, _slots(dst, page_size),
                             flat.index_select(3, _slots(src, page_size)))
        else:
            leaf.index_copy_(3, dst, leaf.index_select(3, src))
    return kv


def gather_kv_dense(kv_layer, block_tables: torch.Tensor, max_len: int):
    """Oracle helper: dense ``[B, max_len, KH, D]`` K/V (dequantized f32
    for INT8) from one layer's pages ``[2, KH, P, page, d]`` (+ its flat
    scales ``[2, KH, R, 128]``). Not a hot path."""
    vals = kv_layer[0]
    _, KH, P, page, D = vals.shape
    if len(kv_layer) == 2:
        sc = kv_layer[1].reshape(2, KH, -1)[:, :, :P * page]
        kv = vals.float() * sc.reshape(2, KH, P, page, 1)
    else:
        kv = vals
    n_pages = cdiv(max_len, page)
    bt = block_tables[:, :n_pages].long()
    B = bt.shape[0]
    g = kv[:, :, bt].reshape(2, KH, B, n_pages * page, D)[:, :, :, :max_len]
    g = g.permute(0, 2, 3, 1, 4)                       # [2, B, S, KH, D]
    return g[0], g[1]
