"""Dense (non-paged) cached attention — the correctness oracle.

The same function as the JAX package's ``ops/attention_ref.py``: causal
attention of new-token queries against a dense per-sequence KV cache,
GQA, f32 accumulation.
"""

from __future__ import annotations

from typing import Tuple

import torch


def update_dense_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                       k_new: torch.Tensor, v_new: torch.Tensor,
                       positions: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter new K/V rows into a dense cache, in place.

    k_cache/v_cache: ``[B, S_max, KH, D]``; k_new/v_new: ``[B, T, KH, D]``;
    positions: ``[B, T]`` absolute token positions.
    """
    rows = torch.arange(k_cache.shape[0], device=k_cache.device)[:, None]
    k_cache[rows, positions] = k_new.to(k_cache.dtype)
    v_cache[rows, positions] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


def dense_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, positions: torch.Tensor,
                    kv_lens: torch.Tensor, scale: float, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """Causal attention of ``q [B, T, H, D]`` (at ``positions [B, T]``)
    against ``k_cache/v_cache [B, S_max, KH, D]`` that already hold the
    new rows. Key j is visible to a query at position p iff ``j <= p``,
    ``j < kv_len`` and, with ``window > 0``, ``j > p - window``.
    ``softcap > 0`` tanh-caps the scaled logits before the mask.
    Returns ``[B, T, H, D]`` in q's dtype."""
    B, T, H, D = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    qg = q.reshape(B, T, KH, G, D).float()
    scores = torch.einsum("btkgd,bskd->bktgs", qg, k_cache.float()) * scale
    if softcap > 0:
        scores = softcap * torch.tanh(scores / softcap)
    key = torch.arange(S, device=q.device)[None, None, :]
    visible = (key <= positions[:, :, None]) & (key < kv_lens[:, None, None])
    if window > 0:
        visible &= key > positions[:, :, None] - window
    scores = scores.masked_fill(~visible[:, None, :, None, :], float("-inf"))
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bktgs,bskd->btkgd", weights, v_cache.float())
    return out.reshape(B, T, H, D).to(q.dtype)
