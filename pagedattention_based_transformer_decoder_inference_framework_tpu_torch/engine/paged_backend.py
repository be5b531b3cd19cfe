"""Paged KV attention backend: page pool + block tables + the kernels.

The model's ``attn_fn`` appends the new K/V rows into their block-table
slots (``ops/kv_append.py``, B3/B4) and attends over the page pool
(``ops/paged_attention.py``, B1/B2), with the JAX package's
``engine/paged_backend.py`` dispatch: T=1 takes the decode kernel,
everything else the general one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import CacheConfig, ModelConfig
from ..kvcache.pool import PagePool
from ..ops.kv_append import kv_append
from ..ops.paged_attention import paged_attention, paged_attention_decode


class PagedKVBackend:
    """The kernels' wrappers choose their route by the tensors' device:
    the CUDA kernel on CUDA tensors, the plain PyTorch version on CPU
    tensors."""

    append = staticmethod(kv_append)
    attend = staticmethod(paged_attention)
    attend_decode = staticmethod(paged_attention_decode)

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
        position of the first q token."""
        if score_sink is not None:
            raise NotImplementedError(
                "score_sink (per-page score export): the beam slice, "
                "ROADMAP queue A item 10")
        if gather_axis is not None:
            raise NotImplementedError(
                "gather_axis (sequence-parallel prefill): ROADMAP queue A "
                "item 14")
        page = self.cache.page_size
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
            kv = self.append(kv, k, v, layer, positions, block_tables,
                             page_size=page)
            scales = kv[1] if len(kv) == 2 else None
            if q.shape[1] == 1:
                out = self.attend_decode(q, kv[0], block_tables, seq_lens,
                                         scales, layer, **common)
            else:
                out = self.attend(q, kv[0], block_tables, seq_lens,
                                  q_offsets, scales, layer, **common)
            return out[..., :dh], kv

        return attn_fn

