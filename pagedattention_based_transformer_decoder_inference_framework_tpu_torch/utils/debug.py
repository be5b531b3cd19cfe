"""Debug introspection: attention-weight and logit export (the JAX
package's ``utils/debug.py``).

A dense replay of the model, layer by layer over
``engine/backends.py::DenseKVBackend``, that returns each layer's
attention probability maps beside the logits, for inspection and
regression triage. Plain PyTorch; no kernel runs. Not a hot path.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..models.model import DecoderModel, Params, unstack_layers


@torch.inference_mode()
def attention_maps(model: DecoderModel, params: Params,
                   tokens: Sequence[int]
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Run ``tokens`` through the model capturing attention.

    Returns ``(attn [L, H, T, T], logits [T, V])`` — softmax attention
    probabilities per layer and head under the exact causal mask, on the
    params' device, as numpy.
    """
    from ..engine.backends import DenseKVBackend

    cfg = model.cfg
    device = params["embedding"].device
    toks = torch.as_tensor(list(tokens), dtype=torch.long,
                           device=device)[None, :]
    T = toks.shape[1]
    positions = torch.arange(T, device=device)[None, :]
    dense = DenseKVBackend(cfg, kv_dtype="float32")
    captured: List[torch.Tensor] = []
    base_attn = dense.attn_fn
    scale = 1.0 / math.sqrt(cfg.head_dim)

    def capturing_attn(q, k, v, kv, layer, pos):
        out, kv = base_attn(q, k, v, kv, layer, pos)
        # recompute the probability map densely for capture
        G = q.shape[2] // k.shape[2]
        kk = torch.repeat_interleave(k, G, dim=2)
        s = torch.einsum("bthd,bshd->bhts", q.float(), kk.float()) * scale
        causal = pos[:, None, :, None] >= pos[:, None, None, :]
        s = torch.where(causal, s, torch.full_like(s, -1e30))
        captured.append(torch.softmax(s, dim=-1)[0])
        return out, kv

    # the layer loop unrolled; params may be the canonical stacked dict
    # or the engine's unstacked tuple of per-layer dicts
    x = model.embed(params, toks, positions)
    rope_cs = model.rope(device)
    kv = dense.init_cache(1, T, device=device)
    for l, lp in enumerate(unstack_layers(params)["layers"]):
        x, kv = model._block(lp, x, kv, l, positions, capturing_attn,
                             rope_cs)
    x = model._norm(x, params["final_norm_scale"],
                    params.get("final_norm_bias"))
    logits = model.logits(params, x)
    attn = np.stack([a.cpu().numpy() for a in captured])
    return attn, logits[0].cpu().numpy()
