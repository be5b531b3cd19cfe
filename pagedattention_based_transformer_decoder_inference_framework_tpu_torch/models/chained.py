"""Builds each layer's :class:`~..ops.chain_linear.PackedChain` for the
decode megakernel (the JAX package's ``models/chained.py``).

Layer ``l``'s chain covers its post-attention matmuls *plus layer
``l+1``'s qkv projection* (the next weight stream in program order), so
a decode step becomes::

    qkv_0 (one linear)
    for l in layers:  attention_l  ->  chain_l   (ONE B14 launch)
    final_norm -> lm head

With ``drop=True`` (``RuntimeConfig.megakernel_drop_weights``) the per-op
copies are freed as each chain is packed, and every multi-token forward
serves its matmuls from the packed blocks (B15, ``packed_linear``).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

from ..config import ModelConfig
from ..ops.chain_linear import OP_D, OP_G, OP_O, OP_T, OP_U, pack_chain
from ..quant.tensor import QTensor
from ..utils.common import round_up, torch_dtype

Params = Dict[str, Any]

#: per-op weight keys that live inside the packed chain blocks
_PACKED_KEYS = ("wo", "bo", "w_gu", "w_gate", "w_up", "w_down",
                "b_up", "b_down")


def _split_cols(w, n: int):
    """Split ``[K, 2n] -> ([K, :n], [K, n:])`` (gate|up fused columns)."""
    if isinstance(w, QTensor):
        return (QTensor(w.values[:, :n], w.scales[:, :n]),
                QTensor(w.values[:, n:], w.scales[:, n:]))
    return w[:, :n], w[:, n:]


def chains_supported(cfg: ModelConfig, params: Params) -> bool:
    """The megakernel covers the unrolled-layer, fused-projection dense
    decoder in every quant mode but INT4; MoE, the Gemma-family norms and
    stacked layers run the per-op path (one device: the port has no
    tensor parallelism)."""
    layers = params.get("layers")
    return (cfg.num_experts == 0
            and cfg.activation in ("swiglu", "gelu", "relu")
            and cfg.rms_offset == 0.0 and not cfg.post_norms
            and isinstance(layers, (tuple, list))
            and len(layers) > 0
            and all("w_qkv" in lp and "wo" in lp for lp in layers))


def chain_blocks(D: int, I: int, bk: int = 1024,
                 bn: int = 2048) -> Tuple[int, int]:
    """The packing's ``(bk, bn)`` for hidden size ``D`` and intermediate
    size ``I``: the requested blocks clamped to the model's dims, or
    square blocks on ``round_up(D, 128)`` (up to 4096) where ``D`` is no
    multiple of them, which keeps the o/down padding small."""
    bn = min(bn, round_up(D, 128), round_up(I, 128))
    bk = min(bk, round_up(D, 128), round_up(I, 128))
    if D % bk or D % bn:
        b = round_up(D, 128)
        if b <= 4096:
            bk = bn = b
    return bk, bn


def build_decode_chains(params: Params, cfg: ModelConfig, *,
                        bk: int = 1024, bn: int = 2048,
                        drop: bool = False) -> Params:
    """Pack every layer's decode chain (on the weights' device, once at
    engine build) and return params with ``"chains"`` added. Block sizes
    clamp to the model's dims, as in the JAX package.

    ``drop=True`` frees each per-op weight copy as soon as its chain is
    packed — layer ``l``'s o/MLP weights after chain ``l``, layer
    ``l+1``'s qkv after chain ``l`` (it rides that chain's tail) — so the
    builder holds the model plus ONE chain. Layer 0's qkv is not packed
    and stays; norm params stay. The caller hands over ownership: a
    tensor it still references elsewhere is not freed."""
    layers = [dict(lp) for lp in params["layers"]]
    D, I = cfg.hidden_size, cfg.intermediate_size
    bk, bn = chain_blocks(D, I, bk, bn)
    w_dtype = (None if cfg.quant in ("int8", "int8-weight")
               else torch_dtype(cfg.dtype))

    chains = []
    for l, lp in enumerate(layers):
        ops = [(OP_O, lp["wo"], lp.get("bo"))]
        if cfg.activation == "swiglu":
            if "w_gu" in lp:
                gate, up = _split_cols(lp["w_gu"], I)
            else:
                gate, up = lp["w_gate"], lp["w_up"]
            ops += [(OP_G, gate, None), (OP_U, up, None)]
        else:
            ops += [(OP_U, lp["w_up"], lp.get("b_up"))]
        ops += [(OP_D, lp["w_down"], lp.get("b_down"))]
        nxt = layers[l + 1] if l + 1 < len(layers) else None
        ln_after_down = None
        if nxt is not None:
            ops += [(OP_T, nxt["w_qkv"], nxt.get("b_qkv"))]
            ln_after_down = (nxt["ln1_scale"], nxt.get("ln1_bias"))
        chains.append(pack_chain(
            ops, D=D, I=I,
            ln_after_o=(lp["ln2_scale"], lp.get("ln2_bias")),
            ln_after_down=ln_after_down,
            act_kind=cfg.activation, norm_kind=cfg.norm,
            eps=cfg.norm_eps, bk=bk, bn=bn, w_dtype=w_dtype,
            w8a8=cfg.quant == "int8"))
        if drop:
            ops = gate = up = None            # they held tensor refs
            for key in _PACKED_KEYS:
                lp.pop(key, None)
            if nxt is not None:
                nxt.pop("w_qkv", None)
                nxt.pop("b_qkv", None)
    out = dict(params)
    out["layers"] = tuple(layers)
    out["chains"] = tuple(chains)
    return out
