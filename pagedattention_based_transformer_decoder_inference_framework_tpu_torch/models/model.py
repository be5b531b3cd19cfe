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

Weights may be INT8 (:class:`QTensor`, per-output-channel scales) or
INT4 (:class:`Q4Tensor`, group-wise scales) as the JAX package makes
them: :func:`init_params_quantized`, :func:`quantize_params` and
:func:`quantize_params_int4`. With ``"chains"`` in the params
(:func:`~.chained.build_decode_chains`) a decode step runs one B14
``chain_decode`` per layer, and with the per-op copies dropped every
multi-token forward serves its matmuls from the packed blocks (B15
``packed_linear``).

Mixture-of-Experts (Mixtral: ``router [D, E]`` and SwiGLU experts
``we_gate``/``we_up [E, D, I]``, ``we_down [E, I, D]``, fused to ``we_gu``
in the engine's layout, INT8 in every quantized mode, INT4 included)
routes each token to its top-k experts. Decode, w8a8 and small chunks
take a masked loop over the experts (every expert sees every token,
gated); a prefill chunk whose routed slots reach ``S = B*T*k >= E*256``
(and is not w8a8) takes the exact sorted dispatch through the grouped
matmul (B13 ``grouped_matmul``), as the JAX package's ``_moe`` does, on
one device. Gemma-3's dual-theta RoPE rotates the sliding-window layers
with a second, never scaled table at ``rope_local_theta``
(:meth:`DecoderModel.rope_local`). Tensor and expert parallelism
(ROADMAP queue A, parallelism) are a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..ops import chain_linear as cl
from ..ops import gmm
from ..ops.common import activation_fn, layernorm, rmsnorm
from ..ops.linear import linear
from ..ops.rope import apply_rope, rope_table
from ..quant.tensor import (Q4Tensor, QTensor, dequantize,
                            quantize_int4_groupwise, quantize_per_channel)
from ..utils.common import round_up, torch_dtype

Params = Dict[str, Any]

# attn_fn(q[B,T,H,D], k[B,T,KH,D], v[B,T,KH,D], kv_state, layer, positions)
#   -> (out[B,T,H,D], kv_state); kv_state is the full multi-layer cache
AttentionFn = Callable[..., Tuple[torch.Tensor, Any]]


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None, quantize: bool = False,
                unrolled: bool = False) -> Params:
    """Random-init parameters (stacked layers) on ``device`` from
    ``generator`` (which must live on that device). Weights are
    ``0.02 * N(0, 1)`` drawn in f32 one matrix at a time (a layer's, or
    one expert's of a layer) and cast to ``cfg.dtype``, so the f32
    transient is one matrix; with ``quantize`` the matmul weights, the
    experts and the LM head are quantized to INT8 per output channel
    instead of cast (:func:`init_params_quantized`); the MoE router stays
    in ``cfg.dtype``. ``unrolled`` gives the same values as a tuple of
    per-layer dicts whose weights own their storage
    (:func:`unstack_layers` gives views of the stacked tensors), so a
    per-layer weight that is dropped is freed."""
    device = torch.device(device or generator.device)
    dt = torch_dtype(cfg.dtype)
    D, H, KH, dh, I_ = (cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim, cfg.intermediate_size)
    L = cfg.num_layers

    def w(*shape, scale=0.02, stacked=True, quant=False):
        if stacked and unrolled:            # the same draws, layer by layer
            return [w(*shape[1:], scale=scale, stacked=False, quant=quant)
                    for _ in range(shape[0])]
        K, N = shape[-2:]
        if quant and quantize:
            vals = torch.empty(shape, dtype=torch.int8, device=device)
            scales = torch.empty(shape[:-2] + (1, N), dtype=torch.float32,
                                 device=device)
            parts = zip(vals.view(-1, K, N), scales.view(-1, 1, N))
        else:
            out = torch.empty(shape, dtype=dt, device=device)
            parts = ((p, None) for p in out.view(-1, K, N))
        for part, part_scales in parts:
            tmp = torch.empty(part.shape, dtype=torch.float32, device=device)
            tmp.normal_(generator=generator).mul_(scale)
            if part_scales is None:
                part.copy_(tmp)
            else:
                q = quantize_per_channel(tmp)
                part.copy_(q.values)
                part_scales.copy_(q.scales)
        return QTensor(vals, scales) if quant and quantize else out

    def const(value, *shape):
        return torch.full(shape, value, dtype=dt, device=device)

    layers: Params = {
        "ln1_scale": const(1.0, L, D),
        "ln2_scale": const(1.0, L, D),
        "wq": w(L, D, H * dh, quant=True),
        "wk": w(L, D, KH * dh, quant=True),
        "wv": w(L, D, KH * dh, quant=True),
        "wo": w(L, H * dh, D, quant=True),
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
    if cfg.num_experts > 0:
        E = cfg.num_experts
        layers["router"] = w(L, D, E)
        layers["we_gate"] = w(L, E, D, I_, quant=True)
        layers["we_up"] = w(L, E, D, I_, quant=True)
        layers["we_down"] = w(L, E, I_, D, quant=True)
    elif cfg.is_glu:
        layers["w_gate"] = w(L, D, I_, quant=True)
        layers["w_up"] = w(L, D, I_, quant=True)
        layers["w_down"] = w(L, I_, D, quant=True)
    else:
        layers["w_up"] = w(L, D, I_, quant=True)
        layers["w_down"] = w(L, I_, D, quant=True)
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
        params["lm_head"] = w(D, cfg.vocab_size, stacked=False,
                                  quant=True)
    if unrolled:
        params["layers"] = tuple({k: v[l] for k, v in layers.items()}
                                 for l in range(L))
    return params


def init_params_quantized(cfg: ModelConfig, generator: torch.Generator,
                          device=None, unrolled: bool = False) -> Params:
    """Random init straight into INT8 :class:`QTensor` matmul weights (the
    JAX package's ``init_params_quantized``): each layer's weight is
    drawn in f32, quantized per output channel and stored, so the f32
    transient is one layer's tensor and an INT8 Llama-3-8B never exists
    in bf16. Norms, biases and the embedding stay in ``cfg.dtype``."""
    return init_params(cfg, generator, device, quantize=True,
                       unrolled=unrolled)


def _to_tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):       # a checkpoint's leaves
        return a.to(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes bfloat16 from JAX
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def params_from_jax(np_params: Params, cfg: ModelConfig,
                    device="cpu") -> Params:
    """The weight bridge: the JAX package's params pytree with numpy
    leaves (``jax.tree_util.tree_map(np.asarray, params)``) to the port's
    params on ``device``: stacked layers from ``init_params``, or the JAX
    engine's unstacked, fused tuple of layer dicts; tensor leaves (as
    ``models/checkpoint.py`` reads them) are moved as they are. Quantized
    leaves are recognised by their attributes (the port cannot import the JAX
    classes): ``packed``/``scales``/``group``/``bn`` make a
    :class:`Q4Tensor`, ``values``/``scales`` a :class:`QTensor`, and
    ``w``/``sb``/``meta``/``ln``/``ops_geom`` a
    :class:`~..ops.chain_linear.PackedChain` (a JAX megakernel engine's
    ``"chains"``). MoE experts are such leaves too (``[E, K, N]``, or
    ``[L, E, K, N]`` stacked)."""

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if all(hasattr(x, a) for a in ("w", "sb", "meta", "ln", "ops_geom")):
            static = {f.name: getattr(x, f.name)
                      for f in dataclasses.fields(cl.PackedChain)
                      if f.name not in ("w", "sb", "meta", "ln")}
            static["ops_geom"] = tuple(tuple(int(v) for v in g)
                                       for g in static["ops_geom"])
            return cl.PackedChain(
                w=_to_tensor(x.w, device), sb=_to_tensor(x.sb, device),
                meta=_to_tensor(x.meta, device),
                ln=_to_tensor(x.ln, device), **static)
        if hasattr(x, "packed"):
            return Q4Tensor(_to_tensor(x.packed, device),
                            _to_tensor(x.scales, device), int(x.group),
                            int(x.bn))
        if hasattr(x, "values") and hasattr(x, "scales"):
            return QTensor(_to_tensor(x.values, device),
                           _to_tensor(x.scales, device))
        if isinstance(x, (tuple, list)):
            return tuple(conv(v) for v in x)
        return _to_tensor(x, device)

    return conv(np_params)


def unstack_layers(params: Params) -> Params:
    """Stacked ``[L, ...]`` layer weights (dense or :class:`QTensor`, MoE
    experts' ``[L, E, K, N]`` too) -> a tuple of per-layer dicts (views;
    no copy)."""
    if isinstance(params["layers"], (tuple, list)):
        return params

    def layer(v, l):
        if isinstance(v, QTensor):
            return QTensor(v.values[l], v.scales[l])
        return v[l]

    layers = params["layers"]
    L = next(iter(layers.values())).shape[0]
    out = dict(params)
    out["layers"] = tuple({k: layer(v, l) for k, v in layers.items()}
                          for l in range(L))
    return out


def _cat_cols(ws):
    """Concatenate along the output dim; a :class:`QTensor`'s values and
    per-column scales both concatenate."""
    if isinstance(ws[0], QTensor):
        return QTensor(torch.cat([w.values for w in ws], dim=-1),
                       torch.cat([w.scales for w in ws], dim=-1))
    return torch.cat(ws, dim=-1)


def fuse_projections(params: Params) -> Params:
    """Fuse q/k/v into one ``w_qkv``, the GLU gate/up into one ``w_gu``
    and each expert's gate/up into ``we_gu [E, D, 2I]`` (output-dim
    concatenation); unrolled layers only. The model splits the fused
    outputs by the H : KH : KH head ratio. The layer dicts are rewritten
    in place, as :func:`quantize_params_int4` does, so each layer's
    unfused weights are freed as soon as its fused ones exist unless the
    caller holds them elsewhere (Mixtral-8x7B's fused INT8 experts are 30
    GB, which would otherwise sit on top of the unfused ones)."""
    if not isinstance(params["layers"], (tuple, list)):
        raise ValueError("fuse_projections requires unstacked layers")
    out_layers = []
    for lp in params["layers"]:
        if "wq" in lp:
            lp["w_qkv"] = _cat_cols([lp.pop("wq"), lp.pop("wk"),
                                     lp.pop("wv")])
        if "bq" in lp:
            lp["b_qkv"] = _cat_cols([lp.pop("bq"), lp.pop("bk"),
                                     lp.pop("bv")])
        if "w_gate" in lp:
            lp["w_gu"] = _cat_cols([lp.pop("w_gate"), lp.pop("w_up")])
        if "we_gate" in lp:
            lp["we_gu"] = _cat_cols([lp.pop("we_gate"), lp.pop("we_up")])
        out_layers.append(lp)
    out = dict(params)
    out["layers"] = tuple(out_layers)
    return out


#: the matmul weights both quantizers convert (norms, biases, the
#: embedding and the MoE router stay in float)
_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
               "w_qkv", "w_gu")
#: the MoE experts, which only the INT8 quantizer converts: under INT4
#: they stay INT8, as in the JAX package
_EXPERT_KEYS = ("we_gate", "we_up", "we_down", "we_gu")
#: grouped-matmul row block (``ops/gmm.py``): the MoE dispatch path is
#: taken when the routed slots average at least one block per expert
_GMM_BM = 256


def quantize_params(params: Params) -> Params:
    """INT8 per-output-channel conversion of every matmul weight, expert
    (per expert and output channel) and the LM head that is not quantized
    yet, in the stacked or the unstacked / fused layout."""

    def quant_dict(layers: Params) -> Params:
        layers = dict(layers)
        for k in _QUANT_KEYS + _EXPERT_KEYS:
            if isinstance(layers.get(k), torch.Tensor):
                layers[k] = quantize_per_channel(layers[k])
        return layers

    out = dict(params)
    if isinstance(params["layers"], (tuple, list)):
        out["layers"] = tuple(quant_dict(lp) for lp in params["layers"])
    else:
        out["layers"] = quant_dict(params["layers"])
    if isinstance(params.get("lm_head"), torch.Tensor):
        out["lm_head"] = quantize_per_channel(params["lm_head"])
    return out


def quantize_params_int4(params: Params) -> Params:
    """Nibble-packed INT4 with the quantizer's group-wise scales (groups of
    128 rows) for every matmul weight (and the LM head), on the unstacked
    / fused layout, one weight at a time and in place, so each original
    frees as soon as its INT4 replacement exists. INT8 weights are
    dequantized first (the double rounding costs little against INT4's
    step). MoE experts keep INT8, as in the JAX package. One device only:
    the tensor-parallel splits of the JAX package wait for ROADMAP queue
    A, parallelism."""
    if not isinstance(params["layers"], (tuple, list)):
        raise ValueError("INT4 conversion runs after unstack_layers")

    def to4(w):
        if isinstance(w, Q4Tensor):
            return w
        if isinstance(w, QTensor):
            w = dequantize(w)
        return quantize_int4_groupwise(w)

    for lp in params["layers"]:
        for k in _QUANT_KEYS:
            if k in lp:
                lp[k] = to4(lp.pop(k))
    if "lm_head" in params:
        params["lm_head"] = to4(params.pop("lm_head"))
    return params


def _dispatch(topi: torch.Tensor, num_experts: int, bm: int):
    """:func:`dispatch_layout`'s three outputs, then
    :func:`dispatch_block_rows`'s."""
    te = topi.reshape(-1)
    S, dev = te.numel(), te.device
    order = torch.argsort(te, stable=True)
    se = te[order]
    counts = (te[:, None] == torch.arange(num_experts, device=dev)).sum(0)
    padded = (counts + bm - 1) // bm * bm
    starts = torch.cumsum(padded, 0) - padded
    cum = torch.cumsum(counts, 0) - counts
    dest = starts[se] + torch.arange(S, device=dev) - cum[se]
    npad = round_up(S, bm) + num_experts * bm
    block0 = torch.arange(npad // bm, device=dev) * bm
    gb = torch.searchsorted(starts, block0, right=True) - 1
    rows = (starts[gb] + counts[gb] - block0).clamp(0, bm)
    return order, dest, gb.to(torch.int32), rows.to(torch.int32)


def dispatch_layout(topi: torch.Tensor, num_experts: int,
                    bm: int = _GMM_BM):
    """The sorted MoE dispatch's layout of the routed slots ``topi [...,
    k]`` (flattened, slot ``i`` of token ``i // k``), the JAX package's
    exactly: ``order``, the slots stable-sorted by expert; ``dest``, the
    row of each sorted slot, each expert's range padded to a multiple of
    ``bm`` rows; ``group_of_block [Npad // bm]`` int32, with the static
    ``Npad = round_up(S, bm) + E*bm``. An expert with no slot has an
    empty range whose start it shares with the next, and
    ``searchsorted(..., right=True)`` gives the block there to the expert
    that has rows; the blocks past the last range go to the last expert
    and multiply zeros. Built on the device, without a host sync."""
    return _dispatch(topi, num_experts, bm)[:3]


def dispatch_block_rows(topi: torch.Tensor, num_experts: int,
                        bm: int = _GMM_BM) -> torch.Tensor:
    """The routed rows in each row block of :func:`dispatch_layout`'s
    layout, ``[Npad // bm]`` int32: each expert's rows sit at the front of
    its range, so a block holds ``clamp(start + count - block start, 0,
    bm)`` of its expert's; 0 for the padding blocks inside a range and
    for the blocks past every range. B13's ``block_rows``: on the device,
    without a host sync."""
    return _dispatch(topi, num_experts, bm)[3]


def _leaf(w) -> torch.Tensor:
    """The values of a weight, dense or :class:`QTensor`."""
    return w.values if isinstance(w, QTensor) else w


def _expert(w, e: int):
    """Expert ``e`` of ``[E, K, N]`` experts (a view)."""
    if isinstance(w, QTensor):
        return QTensor(w.values[e], w.scales[e])
    return w[e]


class DecoderModel:
    """Stateless model: ``forward(params, tokens, positions, kv, attn_fn)``.

    ``rope_len`` caps the RoPE tables (the engine passes its serveable
    length, pages x page size). Each table is built once per device."""

    def __init__(self, cfg: ModelConfig, rope_len: Optional[int] = None):
        self.cfg = cfg
        self.rope_len = rope_len
        self._rope: Dict[Tuple[str, torch.device],
                         Tuple[torch.Tensor, torch.Tensor]] = {}

    def _table(self, kind: str, device, theta: float, scaling):
        key = (kind, torch.device(device))
        if key not in self._rope:
            length = min(self.rope_len or self.cfg.max_seq_len,
                         self.cfg.max_seq_len)
            self._rope[key] = rope_table(length, self.cfg.head_dim, theta,
                                         scaling=scaling, device=key[1])
        return self._rope[key]

    def rope(self, device) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        if self.cfg.position != "rope":
            return None
        return self._table("global", device, self.cfg.rope_theta,
                           self.cfg.rope_scaling)

    def rope_local(self, device) -> Optional[Tuple[torch.Tensor,
                                                   torch.Tensor]]:
        """Gemma-3 dual RoPE: the table the sliding-window layers rotate
        with (``rope_local_theta``, never scaled); None when the model
        uses one theta everywhere."""
        if self.cfg.position != "rope" or self.cfg.rope_local_theta <= 0:
            return None
        return self._table("local", device, self.cfg.rope_local_theta, None)

    def _rope_for_layer(self, layer: int, rope_cs, rope_loc):
        if rope_loc is not None and self.cfg.window_for_layer(layer) > 0:
            return rope_loc
        return rope_cs

    def embed(self, params: Params, tokens: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
        dt = torch_dtype(self.cfg.dtype)
        # in the wider of the table's and the compute dtype until the end,
        # as the compiled JAX model computes: a bf16 table under an f32
        # config adds its positions and scales in f32
        x = params["embedding"][tokens]
        x = x.to(torch.promote_types(x.dtype, dt))
        if self.cfg.position == "learned":
            x = x + params["pos_embedding"][positions].to(x.dtype)
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
               positions: torch.Tensor, attn_fn: AttentionFn, rope_cs,
               chain: Optional[cl.PackedChain] = None,
               qkv_chain: Optional[cl.PackedChain] = None):
        """One layer. ``chain``/``qkv_chain`` serve its matmuls out of the
        megakernel's packed blocks (B15) when the per-op copies were
        dropped; ``qkv_chain`` is the PREVIOUS layer's chain, which
        carries this layer's qkv projection as its tail op."""
        cfg = self.cfg
        B, T, _ = x.shape
        w8a8 = cfg.quant == "int8"
        h = self._norm(x, lp["ln1_scale"], lp.get("ln1_bias"))
        if qkv_chain is not None:
            q, k, v = self._split_fused_qkv(
                cl.packed_linear(qkv_chain, (cl.OP_T,), h))
        elif "w_qkv" in lp:
            q, k, v = self._split_fused_qkv(
                linear(h, lp["w_qkv"], lp.get("b_qkv"), w8a8=w8a8))
        else:
            q = linear(h, lp["wq"], lp.get("bq"), w8a8=w8a8)
            k = linear(h, lp["wk"], lp.get("bk"), w8a8=w8a8)
            v = linear(h, lp["wv"], lp.get("bv"), w8a8=w8a8)
        q, k, v = self._heads(
            q, k, v, B, T, positions, rope_cs,
            qk_scales=((lp["q_norm_scale"], lp["k_norm_scale"])
                       if cfg.qk_norm else None))
        attn_out, kv = attn_fn(q, k, v, kv, layer, positions)
        if chain is not None:
            return self._packed_rest(lp, chain, x,
                                     attn_out.reshape(B, T, -1)), kv
        attn_proj = linear(attn_out.reshape(B, T, -1), lp["wo"],
                           w8a8=w8a8)
        if "bo" in lp:
            attn_proj = attn_proj + lp["bo"].to(attn_proj.dtype)
        if cfg.post_norms:
            attn_proj = self._norm(attn_proj, lp["post_attn_scale"], None)
        x = x + attn_proj

        h2 = self._norm(x, lp["ln2_scale"], lp.get("ln2_bias"))
        if cfg.num_experts > 0:
            return x + self._moe(lp, h2, w8a8), kv
        if cfg.is_glu:
            gact = cfg.glu_gate_act
            if "w_gu" in lp:
                gate, up = linear(h2, lp["w_gu"],
                                  w8a8=w8a8).chunk(2, dim=-1)
                gate = activation_fn(gact)(gate.float()).to(up.dtype)
            else:
                gate = linear(h2, lp["w_gate"], act=gact, w8a8=w8a8)
                up = linear(h2, lp["w_up"], w8a8=w8a8)
            mlp = linear(gate * up, lp["w_down"], w8a8=w8a8)
        else:
            mid = linear(h2, lp["w_up"], lp.get("b_up"), act=cfg.activation,
                         w8a8=w8a8)
            mlp = linear(mid, lp["w_down"], w8a8=w8a8)
            if "b_down" in lp:
                mlp = mlp + lp["b_down"].to(mlp.dtype)
        if cfg.post_norms:
            mlp = self._norm(mlp, lp["post_mlp_scale"], None)
        return x + mlp, kv

    def _route(self, lp: Params, h2: torch.Tensor):
        """The router: logits from a dense ``linear`` in the activation
        dtype, then f32; each token's top-k experts ``[B, T, k]`` and the
        softmax of their logits. ``jax.lax.top_k`` puts the lower index
        first among equal logits and ``torch.topk`` promises no order for
        ties (which logits rounded to bf16 make common), so the top k are
        the head of a stable descending sort."""
        r = linear(h2, lp["router"]).float()                   # [B, T, E]
        topv, topi = torch.sort(r, dim=-1, descending=True, stable=True)
        k = self.cfg.experts_per_tok
        return topi[..., :k], torch.softmax(topv[..., :k], dim=-1)

    def _moe(self, lp: Params, h2: torch.Tensor, w8a8: bool) -> torch.Tensor:
        """Mixture-of-Experts MLP (Mixtral): top-k routing, SwiGLU experts.
        A chunk whose routed slots reach one grouped-matmul row block per
        expert (``S >= E * _GMM_BM``), unless under w8a8, takes the sorted
        dispatch (:meth:`_moe_dispatch`, B13); everything else, decode
        included, the masked loop (:meth:`_moe_masked`)."""
        topi, gates = self._route(lp, h2)
        E = _leaf(lp["we_down"]).shape[0]
        S = h2.shape[0] * h2.shape[1] * self.cfg.experts_per_tok
        if self.cfg.quant != "int8" and S >= E * _GMM_BM:
            return self._moe_dispatch(lp, h2, topi, gates)
        return self._moe_masked(lp, h2, topi, gates, w8a8)

    def _moe_masked(self, lp: Params, h2: torch.Tensor, topi: torch.Tensor,
                    gates: torch.Tensor, w8a8: bool) -> torch.Tensor:
        """Every expert over every token, its output scaled by the token's
        gate for it (0 where not routed) and added in expert order: each
        step of the decode loop streams each expert's weights once."""
        E, _, D = _leaf(lp["we_down"]).shape
        mlp = torch.zeros(h2.shape[:-1] + (D,), dtype=h2.dtype,
                          device=h2.device)
        for e in range(E):
            ge = torch.where(topi == e, gates, 0.0).sum(-1)       # [B, T]
            if "we_gu" in lp:
                gate, up = linear(h2, _expert(lp["we_gu"], e),
                                  w8a8=w8a8).chunk(2, dim=-1)
                gate = activation_fn("silu")(gate.float()).to(up.dtype)
            else:
                gate = linear(h2, _expert(lp["we_gate"], e), act="silu",
                              w8a8=w8a8)
                up = linear(h2, _expert(lp["we_up"], e), w8a8=w8a8)
            ye = linear(gate * up, _expert(lp["we_down"], e), w8a8=w8a8)
            mlp = mlp + ge[..., None].to(ye.dtype) * ye
        return mlp

    def _moe_dispatch(self, lp: Params, h2: torch.Tensor, topi: torch.Tensor,
                      gates: torch.Tensor) -> torch.Tensor:
        """The exact sorted dispatch: the ``B*T*k`` (token, expert) slots
        laid out by expert (:func:`dispatch_layout`), the expert products
        as grouped matmuls (B13, told each block's routed rows so that the
        kernel skips the padding tiles; the padding rows are zeros either
        way), and each slot's row, times its gate, added back to its
        token."""
        B, T, D = h2.shape
        k, bm = self.cfg.experts_per_tok, _GMM_BM
        order, dest, gb, block_rows = _dispatch(
            topi, _leaf(lp["we_down"]).shape[0], bm)
        st, sg = order // k, gates.reshape(-1)[order]
        xp = h2.new_zeros((gb.numel() * bm, D))
        xp[dest] = h2.reshape(B * T, D)[st]
        if "we_gu" in lp:
            gate, up = gmm.grouped_matmul(
                xp, lp["we_gu"], gb, bm=bm,
                block_rows=block_rows).chunk(2, dim=-1)
        else:
            gate = gmm.grouped_matmul(xp, lp["we_gate"], gb, bm=bm,
                                      block_rows=block_rows)
            up = gmm.grouped_matmul(xp, lp["we_up"], gb, bm=bm,
                                    block_rows=block_rows)
        gate = activation_fn("silu")(gate.float()).to(up.dtype)
        y = gmm.grouped_matmul(gate * up, lp["we_down"], gb, bm=bm,
                               block_rows=block_rows)
        rows = y[dest] * sg[:, None].to(y.dtype)
        # k = 2 rows a token, added into zeros: 0 + a is exact and a + b
        # equals b + a, so the CUDA index_add_'s atomic order (any order)
        # gives the JAX scatter-add's sum; from k = 3 on the order could
        # round differently
        out = torch.zeros((B * T, y.shape[-1]), dtype=h2.dtype,
                          device=h2.device)
        out.index_add_(0, st, rows.to(h2.dtype))
        return out.reshape(B, T, -1)

    def _packed_rest(self, lp: Params, chain: cl.PackedChain,
                     x: torch.Tensor, ao: torch.Tensor) -> torch.Tensor:
        """The layer after attention out of the packed blocks (the ops
        carry their biases in the chain's ``sb`` table)."""
        x = x + cl.packed_linear(chain, (cl.OP_O,), ao)
        h2 = self._norm(x, lp["ln2_scale"], lp.get("ln2_bias"))
        if self.cfg.activation == "swiglu":
            if chain.I % chain.bn == 0:
                # gate|up contiguous in the packing == the fused w_gu
                gate, up = cl.packed_linear(
                    chain, (cl.OP_G, cl.OP_U), h2).chunk(2, dim=-1)
            else:
                # gate's packed N is bn-padded: serve the two apart
                gate = cl.packed_linear(chain, (cl.OP_G,), h2)
                up = cl.packed_linear(chain, (cl.OP_U,), h2)
            mid = activation_fn("silu")(gate.float()).to(up.dtype) * up
        else:
            mid = cl.packed_linear(chain, (cl.OP_U,), h2,
                                   act=self.cfg.activation)
        return x + cl.packed_linear(chain, (cl.OP_D,), mid)

    def forward(self, params: Params, tokens: torch.Tensor,
                positions: torch.Tensor, kv_caches: Any,
                attn_fn: AttentionFn, return_hidden: bool = False):
        """Run the decoder over ``tokens/positions [B, T]``. ``kv_caches``
        is the full multi-layer cache, updated in place by ``attn_fn``.
        Returns ``(logits [B, T, V] f32, kv_caches)``. With ``"chains"``
        in the params a decode step (T=1) runs :meth:`_forward_chained`;
        with the per-op copies dropped a multi-token forward serves every
        matmul but layer 0's qkv from the packed blocks."""
        if "chains" in params and tokens.shape[1] == 1:
            return self._forward_chained(params, tokens, positions,
                                         kv_caches, attn_fn, return_hidden)
        x = self.embed(params, tokens, positions)
        rope_cs = self.rope(x.device)
        rope_loc = self.rope_local(x.device)
        if rope_loc is not None and isinstance(params["layers"], dict):
            # the JAX package scans stacked layers, where the table cannot
            # be chosen per layer; the same config raises here too
            raise ValueError(
                "rope_local_theta needs the unrolled layer loop "
                "(RuntimeConfig.scan_layers=False): the per-layer "
                "RoPE table choice is static")
        layers = unstack_layers(params)["layers"]
        chains = params.get("chains")
        dropped = chains is not None and "wo" not in layers[0]
        kv = kv_caches
        for l, lp in enumerate(layers):
            x, kv = self._block(
                lp, x, kv, l, positions, attn_fn,
                self._rope_for_layer(l, rope_cs, rope_loc),
                chain=chains[l] if dropped else None,
                qkv_chain=chains[l - 1] if dropped and l > 0 else None)
        x = self._norm(x, params["final_norm_scale"],
                       params.get("final_norm_bias"))
        if return_hidden:
            return x, kv
        return self.logits(params, x), kv

    def _forward_chained(self, params: Params, tokens: torch.Tensor,
                         positions: torch.Tensor, kv_caches: Any,
                         attn_fn: AttentionFn, return_hidden: bool = False):
        """Decode (T=1) through the chained megakernel: layer 0's qkv as
        a per-op ``linear`` (B10 under w8a8), then per layer attention and
        one B14 :func:`~..ops.chain_linear.chain_decode` (o-proj, norm,
        the MLP and the NEXT layer's qkv, the residual stream in f32
        inside), then the final norm and the LM head. Every quant mode
        the chains hold runs here, w8a8 included (its chains re-quantize
        the activations themselves)."""
        cfg = self.cfg
        x = self.embed(params, tokens, positions)           # [B, 1, D]
        rope_cs = self.rope(x.device)
        rope_loc = self.rope_local(x.device)
        layers, chains = params["layers"], params["chains"]
        B = x.shape[0]
        lp0 = layers[0]
        h = self._norm(x, lp0["ln1_scale"], lp0.get("ln1_bias"))
        qkv = linear(h, lp0["w_qkv"], lp0.get("b_qkv"),
                     w8a8=cfg.quant == "int8")
        kv = kv_caches
        for l, lp in enumerate(layers):
            q, k, v = self._heads(
                *self._split_fused_qkv(qkv), B, 1, positions,
                self._rope_for_layer(l, rope_cs, rope_loc),
                qk_scales=((lp["q_norm_scale"], lp["k_norm_scale"])
                           if cfg.qk_norm else None))
            attn_out, kv = attn_fn(q, k, v, kv, l, positions)
            x2, tail = cl.chain_decode(chains[l], attn_out.reshape(B, -1),
                                       x.reshape(B, -1))
            x = x2[:, None, :]
            if tail is not None:
                qkv = tail[:, None, :]
        x = self._norm(x, params["final_norm_scale"],
                       params.get("final_norm_bias"))
        if return_hidden:
            return x, kv
        return self.logits(params, x), kv

    def logits(self, params: Params, hidden: torch.Tensor) -> torch.Tensor:
        """LM head, f32 logits. A tied head widens the embedding table to
        f32 on every call and multiplies in f32: the same logits as the
        JAX model, which contracts the stored table with f32 accumulation
        and makes no such copy (ROADMAP C). An untied head rounds to the
        activation dtype first, as the JAX package's ``linear`` does. A
        quantized head is weight-only INT8 (or INT4) even under w8a8: the
        JAX model never quantizes the final hidden state."""
        if self.cfg.tie_embeddings:
            out = torch.matmul(hidden.float(),
                               params["embedding"].float().t())
        else:
            out = linear(hidden, params["lm_head"]).float()
        cap = self.cfg.final_logit_softcap
        if cap > 0:
            out = cap * torch.tanh(out / cap)
        return out
