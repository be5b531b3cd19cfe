"""Decoder-only transformer (plain PyTorch functions over a params dict).

The JAX package's ``models/model.py`` for the dense families: pre-norm
-> q/k/v projections -> RoPE -> paged KV append + attention (the
injected ``attn_fn``) -> O projection -> residual -> pre-norm -> MLP ->
residual, then the final norm and the LM head. Params keep the JAX
package's keys and shapes (``[in, out]`` weights), so
:func:`params_from_jax` converts its pytree leaf by leaf and both
packages compute the same function. Layers are either stacked
(``params["layers"]`` a dict of ``[L, ...]`` tensors, the canonical
layout) or unrolled (a tuple of per-layer dicts, the engine's layout,
optionally with fused ``w_qkv`` / ``w_gu``); the forward loops over
layers in Python either way.

Mixture-of-Experts, quantized weights, the chained megakernel and
tensor parallelism are later slices (ROADMAP queue A items 12-14).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..ops.common import activation_fn, layernorm, rmsnorm
from ..ops.linear import linear
from ..ops.rope import apply_rope, rope_table
from ..utils.common import torch_dtype

Params = Dict[str, Any]

# attn_fn(q[B,T,H,D], k[B,T,KH,D], v[B,T,KH,D], kv_state, layer, positions)
#   -> (out[B,T,H,D], kv_state); kv_state is the full multi-layer cache
AttentionFn = Callable[..., Tuple[torch.Tensor, Any]]


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random-init parameters (stacked layers) on ``device`` from
    ``generator`` (which must live on that device). Weights are
    ``0.02 * N(0, 1)`` drawn in f32 one layer at a time and cast to
    ``cfg.dtype``, so the f32 transient is one layer's tensor."""
    if cfg.num_experts > 0:
        raise NotImplementedError("MoE: ROADMAP queue A item 12")
    device = torch.device(device or generator.device)
    dt = torch_dtype(cfg.dtype)
    D, H, KH, dh, I_ = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim, cfg.intermediate_size)
    L = cfg.num_layers

    def w(*shape, scale=0.02, stacked=True):
        out = torch.empty(shape, dtype=dt, device=device)
        for part in (out if stacked else (out,)):
            tmp = torch.empty(part.shape, dtype=torch.float32, device=device)
            tmp.normal_(generator=generator)
            part.copy_(tmp.mul_(scale))
        return out

    def const(value, *shape):
        return torch.full(shape, value, dtype=dt, device=device)

    layers: Params = {
        "ln1_scale": const(1.0, L, D),
        "ln2_scale": const(1.0, L, D),
        "wq": w(L, D, H * dh),
        "wk": w(L, D, KH * dh),
        "wv": w(L, D, KH * dh),
        "wo": w(L, H * dh, D),
    }
    if cfg.norm == "layernorm":
        layers["ln1_bias"] = const(0.0, L, D)
        layers["ln2_bias"] = const(0.0, L, D)
    if cfg.use_qkv_bias:
        layers["bq"] = const(0.0, L, H * dh)
        layers["bk"] = const(0.0, L, KH * dh)
        layers["bv"] = const(0.0, L, KH * dh)
        layers["bo"] = const(0.0, L, D)
    if cfg.post_norms:
        layers["post_attn_scale"] = const(1.0, L, D)
        layers["post_mlp_scale"] = const(1.0, L, D)
    if cfg.qk_norm:
        layers["q_norm_scale"] = const(1.0 - cfg.rms_offset, L, dh)
        layers["k_norm_scale"] = const(1.0 - cfg.rms_offset, L, dh)
    if cfg.is_glu:
        layers["w_gate"] = w(L, D, I_)
        layers["w_up"] = w(L, D, I_)
        layers["w_down"] = w(L, I_, D)
    else:
        layers["w_up"] = w(L, D, I_)
        layers["w_down"] = w(L, I_, D)
        if cfg.use_mlp_bias:
            layers["b_up"] = const(0.0, L, I_)
            layers["b_down"] = const(0.0, L, D)
    params: Params = {
        "embedding": w(cfg.vocab_size, D, stacked=False),
        "final_norm_scale": const(1.0, D),
        "layers": layers,
    }
    if cfg.norm == "layernorm":
        params["final_norm_bias"] = const(0.0, D)
    if cfg.position == "learned":
        params["pos_embedding"] = w(cfg.max_seq_len, D, scale=0.01,
                                    stacked=False)
    if not cfg.tie_embeddings:
        params["lm_head"] = w(D, cfg.vocab_size, stacked=False)
    return params


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes bfloat16 from JAX
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_jax(np_params: Params, cfg: ModelConfig,
                    device="cpu") -> Params:
    """The weight bridge: the JAX package's ``init_params`` pytree, as
    numpy arrays (stacked layers), to the port's stacked params on
    ``device``. Only dense weights are bridged; quantized leaves raise."""
    if cfg.num_experts > 0:
        raise NotImplementedError("MoE: ROADMAP queue A item 12")

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if not hasattr(x, "dtype"):
            raise NotImplementedError(
                f"{type(x).__name__} leaves (quantized weights): ROADMAP "
                "queue B items B10-B12")
        return _to_tensor(x, device)

    return conv(np_params)


def unstack_layers(params: Params) -> Params:
    """Stacked ``[L, ...]`` layer weights -> a tuple of per-layer dicts
    (views; no copy)."""
    if isinstance(params["layers"], (tuple, list)):
        return params
    layers = params["layers"]
    L = next(iter(layers.values())).shape[0]
    out = dict(params)
    out["layers"] = tuple({k: v[l] for k, v in layers.items()}
                          for l in range(L))
    return out


def fuse_projections(params: Params) -> Params:
    """Fuse q/k/v into one ``w_qkv`` and the GLU gate/up into one
    ``w_gu`` (output-dim concatenation); unrolled layers only. The model
    splits the fused outputs by the H : KH : KH head ratio."""
    if not isinstance(params["layers"], (tuple, list)):
        raise ValueError("fuse_projections requires unstacked layers")
    out_layers = []
    for lp in params["layers"]:
        lp = dict(lp)
        if "wq" in lp:
            lp["w_qkv"] = torch.cat([lp.pop("wq"), lp.pop("wk"),
                                     lp.pop("wv")], dim=-1)
        if "bq" in lp:
            lp["b_qkv"] = torch.cat([lp.pop("bq"), lp.pop("bk"),
                                     lp.pop("bv")], dim=-1)
        if "w_gate" in lp:
            lp["w_gu"] = torch.cat([lp.pop("w_gate"), lp.pop("w_up")],
                                   dim=-1)
        out_layers.append(lp)
    out = dict(params)
    out["layers"] = tuple(out_layers)
    return out


class DecoderModel:
    """Stateless model: ``forward(params, tokens, positions, kv, attn_fn)``.

    ``rope_len`` caps the RoPE table (the engine passes its serveable
    length, pages x page size). The table is built once per device."""

    def __init__(self, cfg: ModelConfig, rope_len: Optional[int] = None):
        if cfg.num_experts > 0:
            raise NotImplementedError("MoE: ROADMAP queue A item 12")
        if cfg.rope_local_theta > 0:
            raise NotImplementedError(
                "dual-theta RoPE (Gemma-3): ROADMAP queue A item 12")
        self.cfg = cfg
        self.rope_len = rope_len
        self._rope: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def rope(self, device) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        if self.cfg.position != "rope":
            return None
        device = torch.device(device)
        if device not in self._rope:
            length = min(self.rope_len or self.cfg.max_seq_len,
                         self.cfg.max_seq_len)
            self._rope[device] = rope_table(
                length, self.cfg.head_dim, self.cfg.rope_theta,
                scaling=self.cfg.rope_scaling, device=device)
        return self._rope[device]

    def embed(self, params: Params, tokens: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
        x = params["embedding"][tokens]
        if self.cfg.position == "learned":
            x = x + params["pos_embedding"][positions]
        dt = torch_dtype(self.cfg.dtype)
        if self.cfg.scale_embeddings:
            # Gemma scales by sqrt(D) rounded to the compute dtype
            x = x * torch.tensor(self.cfg.hidden_size ** 0.5, dtype=dt)
        return x.to(dt)

    def _norm(self, x, scale, bias):
        if self.cfg.norm == "rmsnorm":
            return rmsnorm(x, scale, self.cfg.norm_eps,
                           offset=self.cfg.rms_offset)
        return layernorm(x, scale, bias, self.cfg.norm_eps)

    def _split_fused_qkv(self, qkv: torch.Tensor):
        cfg = self.cfg
        qw = qkv.shape[-1] * cfg.num_heads // (
            cfg.num_heads + 2 * cfg.num_kv_heads)
        kw = (qkv.shape[-1] - qw) // 2
        return qkv[..., :qw], qkv[..., qw:qw + kw], qkv[..., qw + kw:]

    def _heads(self, q, k, v, B, T, positions, rope_cs, qk_scales=None):
        dh = self.cfg.head_dim
        q = q.reshape(B, T, -1, dh)
        k = k.reshape(B, T, -1, dh)
        v = v.reshape(B, T, -1, dh)
        if qk_scales is not None:
            qs, ks = qk_scales
            q = rmsnorm(q, qs, self.cfg.norm_eps, offset=self.cfg.rms_offset)
            k = rmsnorm(k, ks, self.cfg.norm_eps, offset=self.cfg.rms_offset)
        if rope_cs is not None:
            cos, sin = rope_cs
            q = apply_rope(q, positions, cos, sin)
            k = apply_rope(k, positions, cos, sin)
        return q, k, v

    def _block(self, lp: Params, x: torch.Tensor, kv: Any, layer: int,
               positions: torch.Tensor, attn_fn: AttentionFn, rope_cs):
        cfg = self.cfg
        B, T, _ = x.shape
        h = self._norm(x, lp["ln1_scale"], lp.get("ln1_bias"))
        if "w_qkv" in lp:
            q, k, v = self._split_fused_qkv(
                linear(h, lp["w_qkv"], lp.get("b_qkv")))
        else:
            q = linear(h, lp["wq"], lp.get("bq"))
            k = linear(h, lp["wk"], lp.get("bk"))
            v = linear(h, lp["wv"], lp.get("bv"))
        q, k, v = self._heads(
            q, k, v, B, T, positions, rope_cs,
            qk_scales=((lp["q_norm_scale"], lp["k_norm_scale"])
                       if cfg.qk_norm else None))
        attn_out, kv = attn_fn(q, k, v, kv, layer, positions)
        attn_proj = linear(attn_out.reshape(B, T, -1), lp["wo"])
        if "bo" in lp:
            attn_proj = attn_proj + lp["bo"].to(attn_proj.dtype)
        if cfg.post_norms:
            attn_proj = self._norm(attn_proj, lp["post_attn_scale"], None)
        x = x + attn_proj

        h2 = self._norm(x, lp["ln2_scale"], lp.get("ln2_bias"))
        if cfg.is_glu:
            gact = cfg.glu_gate_act
            if "w_gu" in lp:
                gate, up = linear(h2, lp["w_gu"]).chunk(2, dim=-1)
                gate = activation_fn(gact)(gate.float()).to(up.dtype)
            else:
                gate = linear(h2, lp["w_gate"], act=gact)
                up = linear(h2, lp["w_up"])
            mlp = linear(gate * up, lp["w_down"])
        else:
            mid = linear(h2, lp["w_up"], lp.get("b_up"), act=cfg.activation)
            mlp = linear(mid, lp["w_down"])
            if "b_down" in lp:
                mlp = mlp + lp["b_down"].to(mlp.dtype)
        if cfg.post_norms:
            mlp = self._norm(mlp, lp["post_mlp_scale"], None)
        return x + mlp, kv

    def forward(self, params: Params, tokens: torch.Tensor,
                positions: torch.Tensor, kv_caches: Any,
                attn_fn: AttentionFn, return_hidden: bool = False):
        """Run the decoder over ``tokens/positions [B, T]``. ``kv_caches``
        is the full multi-layer cache, updated in place by ``attn_fn``.
        Returns ``(logits [B, T, V] f32, kv_caches)``."""
        x = self.embed(params, tokens, positions)
        rope_cs = self.rope(x.device)
        layers = params["layers"]
        if isinstance(layers, dict):                 # stacked
            L = next(iter(layers.values())).shape[0]
            layers = [{k: v[l] for k, v in layers.items()} for l in range(L)]
        kv = kv_caches
        for l, lp in enumerate(layers):
            x, kv = self._block(lp, x, kv, l, positions, attn_fn, rope_cs)
        x = self._norm(x, params["final_norm_scale"],
                       params.get("final_norm_bias"))
        if return_hidden:
            return x, kv
        return self.logits(params, x), kv

    def logits(self, params: Params, hidden: torch.Tensor) -> torch.Tensor:
        """LM head, f32 logits. A tied head contracts the stored operands
        with f32 accumulation; an untied head rounds to the activation
        dtype first, as the JAX package's ``linear`` does."""
        if self.cfg.tie_embeddings:
            out = torch.matmul(hidden.float(),
                               params["embedding"].float().t())
        else:
            out = linear(hidden, params["lm_head"]).float()
        cap = self.cfg.final_logit_softcap
        if cap > 0:
            out = cap * torch.tanh(out / cap)
        return out
