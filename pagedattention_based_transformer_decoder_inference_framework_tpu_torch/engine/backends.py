"""Dense KV backend: a contiguous per-sequence cache, plain PyTorch.

The correctness oracle the paged backend is held against
(``engine/paged_backend.py``). The cache is updated in place.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig
from ..ops.attention_ref import dense_attention, update_dense_cache
from ..utils.common import torch_dtype


class DenseKVBackend:
    """Dense KV cache ``[L, B, S_max, KH, D]`` with scatter-append."""

    def __init__(self, cfg: ModelConfig, kv_dtype: str = "bfloat16"):
        self.cfg = cfg
        self.kv_dtype = kv_dtype

    def init_cache(self, batch: int, max_seq: int | None = None,
                   device="cpu"):
        cfg = self.cfg
        shape = (cfg.num_layers, batch, max_seq or cfg.max_seq_len,
                 cfg.num_kv_heads, cfg.head_dim)
        dt = torch_dtype(self.kv_dtype)
        return (torch.zeros(shape, dtype=dt, device=device),
                torch.zeros(shape, dtype=dt, device=device))

    def attn_fn(self, q, k, v, kv, layer: int, positions):
        k_full, v_full = kv
        update_dense_cache(k_full[layer], v_full[layer], k, v, positions)
        kv_lens = positions[:, -1] + 1
        out = dense_attention(q, k_full[layer], v_full[layer], positions,
                              kv_lens, self.cfg.attn_scale,
                              window=self.cfg.window_for_layer(layer),
                              softcap=self.cfg.attn_logit_softcap)
        return out, kv
