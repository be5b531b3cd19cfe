"""Weight import from HuggingFace state dicts (the JAX package's
``models/hf_import.py``).

Each converter takes a state dict of torch tensors or numpy arrays (an
HF model's ``state_dict()``, all of it resident) and returns the port's
params tree with stacked ``[L, ...]`` layers and ``[in, out]`` weights,
the layout :func:`~.model.params_from_jax` fixes, every leaf in
``dtype`` (default ``cfg.dtype``). :mod:`.hf_stream` is the streaming
importer, one tensor at a time, for checkpoints on disk.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..config import ModelConfig
from ..utils.common import torch_dtype
from .model import Params


def _np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().float().numpy()  # a torch tensor


def _stack(sd: Mapping[str, Any], fmt: str, L: int,
           transpose=False) -> np.ndarray:
    mats = [_np(sd[fmt.format(i=i)]) for i in range(L)]
    if transpose:
        mats = [m.T for m in mats]
    return np.stack(mats)


def params_from_hf_gpt2(state_dict: Mapping[str, Any], cfg: ModelConfig,
                        dtype=None, device="cpu") -> Params:
    """An HF ``GPT2LMHeadModel`` state dict. GPT-2's Conv1D weights are
    ``[in, out]`` already, so nothing is transposed."""
    sd = {k.removeprefix("transformer."): v for k, v in state_dict.items()}
    L, D = cfg.num_layers, cfg.hidden_size

    c_attn_w = _stack(sd, "h.{i}.attn.c_attn.weight", L)   # [L, D, 3D]
    c_attn_b = _stack(sd, "h.{i}.attn.c_attn.bias", L)     # [L, 3D]
    layers = {
        "ln1_scale": _stack(sd, "h.{i}.ln_1.weight", L),
        "ln1_bias": _stack(sd, "h.{i}.ln_1.bias", L),
        "ln2_scale": _stack(sd, "h.{i}.ln_2.weight", L),
        "ln2_bias": _stack(sd, "h.{i}.ln_2.bias", L),
        "wq": c_attn_w[:, :, :D],
        "wk": c_attn_w[:, :, D:2 * D],
        "wv": c_attn_w[:, :, 2 * D:],
        "bq": c_attn_b[:, :D],
        "bk": c_attn_b[:, D:2 * D],
        "bv": c_attn_b[:, 2 * D:],
        "wo": _stack(sd, "h.{i}.attn.c_proj.weight", L),
        "bo": _stack(sd, "h.{i}.attn.c_proj.bias", L),
        "w_up": _stack(sd, "h.{i}.mlp.c_fc.weight", L),
        "b_up": _stack(sd, "h.{i}.mlp.c_fc.bias", L),
        "w_down": _stack(sd, "h.{i}.mlp.c_proj.weight", L),
        "b_down": _stack(sd, "h.{i}.mlp.c_proj.bias", L),
    }
    params: Params = {
        "embedding": _np(sd["wte.weight"]),
        "pos_embedding": _np(sd["wpe.weight"]),
        "final_norm_scale": _np(sd["ln_f.weight"]),
        "final_norm_bias": _np(sd["ln_f.bias"]),
        "layers": layers,
    }
    return _to_torch(params, dtype or torch_dtype(cfg.dtype), device)


def params_from_hf_llama(state_dict: Mapping[str, Any], cfg: ModelConfig,
                         dtype=None, device="cpu") -> Params:
    """An HF ``LlamaForCausalLM`` state dict (Mistral and Qwen2 too; torch
    Linear ``[out, in]`` transposed to ``[in, out]``)."""
    sd = dict(state_dict)
    L = cfg.num_layers
    layers = {
        "ln1_scale": _stack(sd, "model.layers.{i}.input_layernorm.weight", L),
        "ln2_scale": _stack(
            sd, "model.layers.{i}.post_attention_layernorm.weight", L),
        "wq": _stack(sd, "model.layers.{i}.self_attn.q_proj.weight", L,
                     transpose=True),
        "wk": _stack(sd, "model.layers.{i}.self_attn.k_proj.weight", L,
                     transpose=True),
        "wv": _stack(sd, "model.layers.{i}.self_attn.v_proj.weight", L,
                     transpose=True),
        "wo": _stack(sd, "model.layers.{i}.self_attn.o_proj.weight", L,
                     transpose=True),
        "w_gate": _stack(sd, "model.layers.{i}.mlp.gate_proj.weight", L,
                         transpose=True),
        "w_up": _stack(sd, "model.layers.{i}.mlp.up_proj.weight", L,
                       transpose=True),
        "w_down": _stack(sd, "model.layers.{i}.mlp.down_proj.weight", L,
                         transpose=True),
    }
    if cfg.use_qkv_bias:            # Qwen2-style attention biases
        for ours, hf in (("bq", "q_proj"), ("bk", "k_proj"),
                         ("bv", "v_proj")):
            layers[ours] = _stack(
                sd, "model.layers.{i}.self_attn.%s.bias" % hf, L)
        layers["bo"] = np.zeros_like(layers["ln1_scale"])
    params: Params = {
        "embedding": _np(sd["model.embed_tokens.weight"]),
        "final_norm_scale": _np(sd["model.norm.weight"]),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        key = "lm_head.weight"
        head = (_np(sd[key]) if key in sd
                else _np(sd["model.embed_tokens.weight"]))
        params["lm_head"] = head.T
    return _to_torch(params, dtype or torch_dtype(cfg.dtype), device)


def params_from_hf_gemma2(state_dict: Mapping[str, Any], cfg: ModelConfig,
                          dtype=None, device="cpu") -> Params:
    """An HF ``Gemma2ForCausalLM`` state dict.

    Llama's projection layout; the four sandwich norms map as
    ``input_layernorm -> ln1``, ``post_attention_layernorm ->
    post_attn``, ``pre_feedforward_layernorm -> ln2``,
    ``post_feedforward_layernorm -> post_mlp`` (HF's "post_attention"
    norm is applied to the attention output). Gemma's norm weights are
    stored zero-centred (``cfg.rms_offset = 1``). Also converts
    ``Gemma3ForCausalLM`` (the same layout with per-head ``q_norm`` /
    ``k_norm`` under ``cfg.qk_norm``): :func:`params_from_hf_gemma3`."""
    sd = dict(state_dict)
    L = cfg.num_layers
    layers = {
        "ln1_scale": _stack(sd, "model.layers.{i}.input_layernorm.weight", L),
        "post_attn_scale": _stack(
            sd, "model.layers.{i}.post_attention_layernorm.weight", L),
        "ln2_scale": _stack(
            sd, "model.layers.{i}.pre_feedforward_layernorm.weight", L),
        "post_mlp_scale": _stack(
            sd, "model.layers.{i}.post_feedforward_layernorm.weight", L),
        "wq": _stack(sd, "model.layers.{i}.self_attn.q_proj.weight", L,
                     transpose=True),
        "wk": _stack(sd, "model.layers.{i}.self_attn.k_proj.weight", L,
                     transpose=True),
        "wv": _stack(sd, "model.layers.{i}.self_attn.v_proj.weight", L,
                     transpose=True),
        "wo": _stack(sd, "model.layers.{i}.self_attn.o_proj.weight", L,
                     transpose=True),
        "w_gate": _stack(sd, "model.layers.{i}.mlp.gate_proj.weight", L,
                         transpose=True),
        "w_up": _stack(sd, "model.layers.{i}.mlp.up_proj.weight", L,
                       transpose=True),
        "w_down": _stack(sd, "model.layers.{i}.mlp.down_proj.weight", L,
                         transpose=True),
    }
    if cfg.qk_norm:
        layers["q_norm_scale"] = _stack(
            sd, "model.layers.{i}.self_attn.q_norm.weight", L)
        layers["k_norm_scale"] = _stack(
            sd, "model.layers.{i}.self_attn.k_norm.weight", L)
    params: Params = {
        "embedding": _np(sd["model.embed_tokens.weight"]),
        "final_norm_scale": _np(sd["model.norm.weight"]),
        "layers": layers,
    }
    return _to_torch(params, dtype or torch_dtype(cfg.dtype), device)


params_from_hf_gemma3 = params_from_hf_gemma2


def params_from_hf_phi3(state_dict: Mapping[str, Any], cfg: ModelConfig,
                        dtype=None, device="cpu") -> Params:
    """An HF ``Phi3ForCausalLM`` state dict: the Llama family with
    pre-fused projections (``self_attn.qkv_proj.weight`` ``[(H+2*KH)*dh,
    D]``, q|k|v rows; ``mlp.gate_up_proj.weight`` ``[2I, D]``, gate|up
    rows), split back into per-projection keys (the engine fuses them
    again)."""
    sd = dict(state_dict)
    L = cfg.num_layers
    nq = cfg.num_heads * cfg.head_dim
    nkv = cfg.num_kv_heads * cfg.head_dim
    qkv = _stack(sd, "model.layers.{i}.self_attn.qkv_proj.weight", L,
                 transpose=True)                       # [L, D, nq+2nkv]
    gu = _stack(sd, "model.layers.{i}.mlp.gate_up_proj.weight", L,
                transpose=True)                        # [L, D, 2I]
    half = cfg.intermediate_size
    layers = {
        "ln1_scale": _stack(sd, "model.layers.{i}.input_layernorm.weight", L),
        "ln2_scale": _stack(
            sd, "model.layers.{i}.post_attention_layernorm.weight", L),
        "wq": qkv[:, :, :nq],
        "wk": qkv[:, :, nq:nq + nkv],
        "wv": qkv[:, :, nq + nkv:],
        "wo": _stack(sd, "model.layers.{i}.self_attn.o_proj.weight", L,
                     transpose=True),
        "w_gate": gu[:, :, :half],
        "w_up": gu[:, :, half:],
        "w_down": _stack(sd, "model.layers.{i}.mlp.down_proj.weight", L,
                         transpose=True),
    }
    params: Params = {
        "embedding": _np(sd["model.embed_tokens.weight"]),
        "final_norm_scale": _np(sd["model.norm.weight"]),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        key = "lm_head.weight"
        head = (_np(sd[key]) if key in sd
                else _np(sd["model.embed_tokens.weight"]))
        params["lm_head"] = head.T
    return _to_torch(params, dtype or torch_dtype(cfg.dtype), device)


def _to_torch(tree: Dict[str, Any], dt, device) -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _to_torch(v, dt, device)
        else:
            out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(
                device=device, dtype=dt)
    return out
