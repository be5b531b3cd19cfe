"""Paged KV attention backend: page pool + block tables + the kernels.

The model's ``attn_fn`` appends the new K/V rows into their block-table
slots (``ops/kv_append.py``, B3/B4/B5) and attends over the page pool
(``ops/paged_attention.py``), with the JAX package's
``engine/paged_backend.py`` dispatch: T>1 takes the general kernel (B1);
T=1 takes the decode kernel that ``decode_route`` names for the pool's
head dim and the block table's width: B2 for a lane-aligned head dim,
B8 for an unpadded dh 16/32/64 pool, B6 otherwise and for every INT8
table too wide for the JAX B2's scales budget (a 32k context at Llama-3
geometry). With ``PBT_FUSED_APPEND=1`` in the environment (the JAX
package's switch, off by default) T=1 takes the fused append + decode
kernel (B9) where its gate allows, which is where the route is B2. With
a ``score_sink`` every call, T=1 included, takes B1 with its per-page
score export, as the JAX backend routes it.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from ..config import CacheConfig, ModelConfig
from ..kvcache.pool import PagePool
from ..ops.kv_append import kv_append
from ..ops.paged_attention import (decode_append_supported, decode_route,
                                   paged_attention, paged_attention_decode,
                                   paged_attention_decode_append,
                                   paged_attention_decode_grouped,
                                   paged_attention_decode_packed)

#: the backend's wrapper attribute for each T=1 route of ``decode_route``
_DECODE_ATTR = {"paged_attention_decode": "attend_decode",
                "paged_attention_decode_grouped": "attend_decode_grouped",
                "paged_attention_decode_packed": "attend_decode_packed"}


class PagedKVBackend:
    """The kernels' wrappers choose their route by the tensors' device:
    the CUDA kernel on CUDA tensors, the plain PyTorch version on CPU
    tensors."""

    append = staticmethod(kv_append)
    attend = staticmethod(paged_attention)
    attend_decode = staticmethod(paged_attention_decode)
    attend_decode_grouped = staticmethod(paged_attention_decode_grouped)
    attend_decode_packed = staticmethod(paged_attention_decode_packed)
    attend_decode_append = staticmethod(paged_attention_decode_append)

    def __init__(self, cfg: ModelConfig, cache: CacheConfig):
        self.cfg = cfg
        self.cache = cache
        self.pool = PagePool(cfg, cache)

    def init_cache(self, device):
        return self.pool.init(device)

    def make_attn_fn(self, block_tables: torch.Tensor,
                     seq_lens: torch.Tensor, q_offsets: torch.Tensor,
                     score_sink=None, gather_axis=None):
        """Bind this step's batch plan. ``seq_lens`` already include the
        tokens appended in this call; ``q_offsets[b]`` is the absolute
        position of the first q token. ``score_sink``: a list to which
        every call appends B1's per-page scores ``[B, max_pages]`` (one
        array a layer, in layer order); every call then takes B1, T=1
        included."""
        if gather_axis is not None:
            raise NotImplementedError(
                "gather_axis (sequence-parallel prefill): ROADMAP queue A, "
                "parallelism")
        page = self.cache.page_size
        mp = block_tables.shape[1]
        block_tables = block_tables.to(torch.int32)
        seq_lens = seq_lens.to(torch.int32)
        q_offsets = q_offsets.to(torch.int32)

        def attn_fn(q, k, v, kv, layer: int, positions):
            # sub-128 head dims: the pool stores lanes padded to 128
            # (PagePool.pool_head_dim); the zero lanes cancel in QK and
            # give zeros in AV, and the scale stays 1/sqrt(real dh)
            dh = q.shape[3]
            dh_pool = self.pool.pool_head_dim
            if dh_pool != dh:
                pad = (0, dh_pool - dh)
                q, k, v = F.pad(q, pad), F.pad(k, pad), F.pad(v, pad)
            common = dict(page_size=page, num_q_heads=q.shape[2],
                          window=self.cfg.window_for_layer(layer),
                          softcap=self.cfg.attn_logit_softcap,
                          scale=self.cfg.attn_scale)
            if (q.shape[1] == 1 and score_sink is None
                    and os.environ.get("PBT_FUSED_APPEND") == "1"
                    and decode_append_supported(kv, dh_pool, mp)):
                out, kv = self.attend_decode_append(
                    q, kv, k, v, block_tables, seq_lens, positions, layer,
                    **common)
                return out[..., :dh], kv
            kv = self.append(kv, k, v, layer, positions, block_tables,
                             page_size=page)
            scales = kv[1] if len(kv) == 2 else None
            if score_sink is not None:
                out, scores = self.attend(
                    q, kv[0], block_tables, seq_lens, q_offsets, scales,
                    layer, return_scores=True, **common)
                score_sink.append(scores)
            elif q.shape[1] == 1:
                attend = getattr(self, _DECODE_ATTR[decode_route(
                    mp, kv[0].shape[2], page, dh_pool, scales is not None)])
                out = attend(q, kv[0], block_tables, seq_lens, scales, layer,
                             **common)
            else:
                out = self.attend(q, kv[0], block_tables, seq_lens,
                                  q_offsets, scales, layer, **common)
            return out[..., :dh], kv

        return attn_fn

