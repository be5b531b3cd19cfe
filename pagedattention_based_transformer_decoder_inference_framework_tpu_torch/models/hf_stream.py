"""Streaming HF-checkpoint import: safetensors shards -> per-layer INT8
quantization -> the native checkpoint layout, one tensor resident at a
time (the JAX package's ``models/hf_stream.py``).

:class:`ShardReader` reads the safetensors format itself (an 8-byte
little-endian header length, a JSON header of ``dtype`` / ``shape`` /
``data_offsets`` per tensor, then the raw bytes, read through
``numpy.memmap``), so neither the ``safetensors`` package nor
``ml_dtypes`` is needed: BF16 is read as its uint16 bits and widened or
viewed as ``torch.bfloat16``. :func:`config_from_hf` derives the
:class:`ModelConfig` from ``config.json``; :func:`import_hf_streaming`
writes every tensor straight into pre-allocated stacked INT8 / bf16
tensors under the flat keys of ``models/checkpoint.py`` (quantized per
output channel by :func:`_quant_np`, the JAX importer's eager numpy
quantizer, so that codes and scales are the JAX import's bit for bit);
:func:`load_flat_params` rebuilds the params tree on a device.

    python -m pagedattention_based_transformer_decoder_inference_framework_tpu_torch.models.hf_stream \\
        --hf-dir ./gemma-3-1b --output gemma3-1b-int8.npz --quant int8
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig

#: weight keys that get INT8-quantized (the model's ``_QUANT_KEYS`` and
#: ``_EXPERT_KEYS`` in their per-projection form)
QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
              "we_gate", "we_up", "we_down")

#: safetensors dtype -> the little-endian numpy dtype of its stored bits
#: (BF16 as its uint16 bits)
_ST_DTYPES = {"BOOL": np.dtype("bool"), "U8": np.dtype("u1"),
              "I8": np.dtype("i1"), "I16": np.dtype("<i2"),
              "U16": np.dtype("<u2"), "I32": np.dtype("<i4"),
              "I64": np.dtype("<i8"), "F16": np.dtype("<f2"),
              "BF16": np.dtype("<u2"), "F32": np.dtype("<f4"),
              "F64": np.dtype("<f8")}


def read_safetensors_header(path: str) -> Tuple[Dict, int]:
    """The JSON header of a ``.safetensors`` file (``__metadata__``
    dropped) and the byte offset where its data begins."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


class ShardReader:
    """Random access to tensors across a safetensors shard set.

    Handles both single-file ``model.safetensors`` and sharded
    ``model.safetensors.index.json`` checkpoints; each file is mapped on
    first use and tensors are read one at a time."""

    def __init__(self, hf_dir: str):
        self.dir = hf_dir
        index = os.path.join(hf_dir, "model.safetensors.index.json")
        single = os.path.join(hf_dir, "model.safetensors")
        self._map: Dict[str, str] = {}
        if os.path.exists(index):
            with open(index) as f:
                self._map = dict(json.load(f)["weight_map"])
        elif os.path.exists(single):
            header, _ = read_safetensors_header(single)
            self._map = dict.fromkeys(header, "model.safetensors")
        else:
            raise FileNotFoundError(
                f"no model.safetensors[.index.json] under {hf_dir}")
        self._open: Dict[str, Tuple[Dict, np.memmap]] = {}

    def keys(self):
        return self._map.keys()

    def __contains__(self, name: str) -> bool:
        return name in self._map

    def get_tensor(self, name: str) -> torch.Tensor:
        """``name`` as a CPU tensor of its stored dtype (a copy out of the
        mapped file)."""
        fname = self._map[name]
        if fname not in self._open:
            path = os.path.join(self.dir, fname)
            header, start = read_safetensors_header(path)
            size = os.path.getsize(path) - start
            data = (np.memmap(path, np.uint8, mode="r", offset=start)
                    if size else np.zeros(0, np.uint8))
            self._open[fname] = (header, data)
        header, data = self._open[fname]
        meta = header[name]
        kind = meta["dtype"]
        if kind not in _ST_DTYPES:
            raise ValueError(f"{name}: unsupported safetensors dtype {kind}")
        b, e = meta["data_offsets"]
        arr = data[b:e].view(_ST_DTYPES[kind]).reshape(meta["shape"])
        if kind == "BF16":
            return torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(arr.copy())

    def get(self, name: str) -> np.ndarray:
        """``name`` as an f32 numpy array, as the JAX reader returns every
        tensor (BF16 widened exactly)."""
        return self.get_tensor(name).float().numpy()


def config_from_hf(hf_dir: str, name: Optional[str] = None) -> ModelConfig:
    """A :class:`ModelConfig` from an HF checkpoint's ``config.json``: the
    GPT-2, Llama, Mistral, Mixtral, Qwen2, Phi-3 and Gemma-2 / Gemma-3
    families, field for field as the JAX package derives them."""
    with open(os.path.join(hf_dir, "config.json")) as f:
        d = json.load(f)
    mt = d.get("model_type", "llama")
    if mt == "gpt2":
        D = d["n_embd"]
        return ModelConfig(
            name=name or "gpt2-hf",
            vocab_size=d["vocab_size"], hidden_size=D,
            num_layers=d["n_layer"], num_heads=d["n_head"],
            num_kv_heads=d["n_head"], head_dim=D // d["n_head"],
            intermediate_size=d.get("n_inner") or 4 * D,
            max_seq_len=d.get("n_positions", 1024),
            norm="layernorm", norm_eps=d.get("layer_norm_epsilon", 1e-5),
            activation="gelu", position="learned",
            tie_embeddings=True).validate()
    if mt in ("gemma2", "gemma3", "gemma3_text"):
        if mt == "gemma3" and "text_config" in d:
            d = d["text_config"]     # multimodal wrapper: the text tower
        gemma3 = mt != "gemma2"
        D = d["hidden_size"]
        H = d["num_attention_heads"]
        rs = d.get("rope_scaling")   # gemma3 from 4B up: linear factor 8
        return ModelConfig(
            name=name or f"{mt}-hf",
            vocab_size=d["vocab_size"], hidden_size=D,
            num_layers=d["num_hidden_layers"], num_heads=H,
            num_kv_heads=d.get("num_key_value_heads", H),
            head_dim=d.get("head_dim") or D // H,
            intermediate_size=d["intermediate_size"],
            max_seq_len=d.get("max_position_embeddings", 8192),
            norm="rmsnorm", norm_eps=d.get("rms_norm_eps", 1e-6),
            activation="geglu", position="rope",
            rope_theta=float(d.get("rope_theta", 10000.0)),
            rope_local_theta=(float(d.get("rope_local_base_freq")
                                    or 10000.0) if gemma3 else 0.0),
            rope_scaling=rs if gemma3 else None,
            use_qkv_bias=d.get("attention_bias", False),
            use_mlp_bias=False,
            sliding_window=int(d.get("sliding_window") or 4096),
            sliding_window_pattern=int(
                d.get("sliding_window_pattern")
                or (6 if gemma3 else 2)),
            tie_embeddings=d.get("tie_word_embeddings", True),
            rms_offset=1.0, post_norms=True, scale_embeddings=True,
            qk_norm=gemma3,
            attn_logit_softcap=float(
                d.get("attn_logit_softcapping") or 0.0),
            final_logit_softcap=float(
                d.get("final_logit_softcapping") or 0.0),
            query_pre_attn_scalar=float(
                d.get("query_pre_attn_scalar") or 0.0),
        ).validate()
    if mt not in ("llama", "mistral", "mixtral", "qwen2", "phi3"):
        raise ValueError(f"unsupported HF model_type: {mt!r}")
    rs = d.get("rope_scaling")
    if rs and rs.get("rope_type", rs.get("type")) not in (
            "default", "linear", "llama3", "longrope"):
        # it rescales the frequencies at every position: importing without
        # it would give wrong logits, so refuse what ops/rope.py lacks
        raise ValueError(f"unsupported rope_scaling: {rs!r}")
    if rs and rs.get("rope_type", rs.get("type")) == "longrope":
        # Phi-3 keeps the switch point and the trained length at the
        # config's root; ops/rope.py reads them from the scaling dict
        rs = dict(rs)
        rs.setdefault("original_max_position_embeddings",
                      d.get("original_max_position_embeddings",
                            d.get("max_position_embeddings", 4096)))
        rs.setdefault("max_position_embeddings",
                      d.get("max_position_embeddings", 4096))
    D = d["hidden_size"]
    H = d["num_attention_heads"]
    sw = 0
    if d.get("sliding_window") and d.get("use_sliding_window", True):
        sw = int(d["sliding_window"])
    return ModelConfig(
        name=name or f"{mt}-hf",
        vocab_size=d["vocab_size"], hidden_size=D,
        num_layers=d["num_hidden_layers"], num_heads=H,
        num_kv_heads=d.get("num_key_value_heads", H),
        head_dim=d.get("head_dim") or D // H,
        intermediate_size=d["intermediate_size"],
        max_seq_len=d.get("max_position_embeddings", 4096),
        norm="rmsnorm", norm_eps=d.get("rms_norm_eps", 1e-6),
        activation="swiglu", position="rope",
        rope_theta=float(d.get("rope_theta", 10000.0)),
        use_qkv_bias=d.get("attention_bias", mt == "qwen2"),
        use_mlp_bias=d.get("mlp_bias", False),
        sliding_window=sw,
        tie_embeddings=d.get("tie_word_embeddings", False),
        num_experts=d.get("num_local_experts", 0),
        experts_per_tok=d.get("num_experts_per_tok", 2),
        rope_scaling=rs,
    ).validate()


def _quant_np(w: np.ndarray):
    """Per-output-channel symmetric absmax INT8 of one ``[in, out]`` f32
    weight, computed eagerly in numpy as the JAX importer does (an
    exact division; a compiled quantizer may multiply by a reciprocal
    and round a code the other way)."""
    absmax = np.abs(w).max(axis=-2, keepdims=True)
    scale = np.maximum(absmax, 1e-8) / 127.0
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def _bf16(w: np.ndarray) -> torch.Tensor:
    """An f32 array rounded to bf16 (to nearest even, as ``ml_dtypes``)."""
    return torch.from_numpy(np.ascontiguousarray(w, np.float32)).to(
        torch.bfloat16)


def _llama_layer_map(i: int, post_norms: bool = False,
                     qk_norm: bool = False) -> Dict[str, tuple]:
    """Our key -> (HF key, transpose); torch's Linear stores ``[out, in]``.

    ``post_norms`` (Gemma's sandwich layout): HF's
    ``post_attention_layernorm`` is the post-attention norm and
    ``pre_feedforward_layernorm`` takes the pre-MLP (our ``ln2``) role."""
    p = f"model.layers.{i}."
    m = {
        "ln1_scale": (p + "input_layernorm.weight", False),
        "wq": (p + "self_attn.q_proj.weight", True),
        "wk": (p + "self_attn.k_proj.weight", True),
        "wv": (p + "self_attn.v_proj.weight", True),
        "wo": (p + "self_attn.o_proj.weight", True),
        "w_gate": (p + "mlp.gate_proj.weight", True),
        "w_up": (p + "mlp.up_proj.weight", True),
        "w_down": (p + "mlp.down_proj.weight", True),
    }
    if post_norms:
        m["ln2_scale"] = (p + "pre_feedforward_layernorm.weight", False)
        m["post_attn_scale"] = (p + "post_attention_layernorm.weight",
                                False)
        m["post_mlp_scale"] = (p + "post_feedforward_layernorm.weight",
                               False)
    else:
        m["ln2_scale"] = (p + "post_attention_layernorm.weight", False)
    if qk_norm:                     # Gemma-3 per-head q/k RMSNorm
        m["q_norm_scale"] = (p + "self_attn.q_norm.weight", False)
        m["k_norm_scale"] = (p + "self_attn.k_norm.weight", False)
    # Qwen2-style attention biases (cfg.use_qkv_bias)
    for ours, hf in (("bq", "self_attn.q_proj.bias"),
                     ("bk", "self_attn.k_proj.bias"),
                     ("bv", "self_attn.v_proj.bias")):
        m[ours] = (p + hf, False)
    return m


def _gpt2_layer_keys(i: int) -> Dict[str, tuple]:
    p = f"h.{i}."
    return {
        "ln1_scale": (p + "ln_1.weight", False),
        "ln1_bias": (p + "ln_1.bias", False),
        "ln2_scale": (p + "ln_2.weight", False),
        "ln2_bias": (p + "ln_2.bias", False),
        "wo": (p + "attn.c_proj.weight", False),
        "bo": (p + "attn.c_proj.bias", False),
        "w_up": (p + "mlp.c_fc.weight", False),
        "b_up": (p + "mlp.c_fc.bias", False),
        "w_down": (p + "mlp.c_proj.weight", False),
        "b_down": (p + "mlp.c_proj.bias", False),
    }


def import_hf_streaming(hf_dir: str, cfg: ModelConfig,
                        quant: Optional[str] = None,
                        out_path: Optional[str] = None
                        ) -> Dict[str, torch.Tensor]:
    """Stream-convert an HF checkpoint directory.

    Returns the flat checkpoint dict of CPU tensors (``checkpoint.py``'s
    key layout: ``layers/wq.qvalues`` etc.); with ``out_path`` it is also
    written as a native ``.npz``. ``quant``: None keeps bf16 weights,
    ``"int8"`` / ``"int8-weight"`` quantizes the matmul weights and an
    untied LM head."""
    r = ShardReader(hf_dir)
    gpt2 = any(k.endswith("wte.weight") for k in r.keys())
    # some exports prefix every key with "transformer."
    prefix = ""
    for k in r.keys():
        if k.startswith("transformer."):
            prefix = "transformer."
            break

    def get(name):
        return r.get(prefix + name if (prefix + name) in r else name)

    def has(name):
        return (prefix + name) in r or name in r

    L = cfg.num_layers
    do_quant = quant in ("int8", "int8-weight")
    flat: Dict[str, torch.Tensor] = {}

    def put(ours: str, idx: tuple, lead: tuple, w: np.ndarray):
        """Write one tensor at ``idx`` of its ``lead``-stacked
        destination, allocated on first touch."""
        if do_quant and ours in QUANT_KEYS:
            q, s = _quant_np(w)
            kv_ = f"layers/{ours}.qvalues"
            ks_ = f"layers/{ours}.qscales"
            if kv_ not in flat:
                flat[kv_] = torch.empty(lead + q.shape, dtype=torch.int8)
                flat[ks_] = torch.empty(lead + s.shape, dtype=torch.float32)
            flat[kv_][idx] = torch.from_numpy(q)
            flat[ks_][idx] = torch.from_numpy(s)
        else:
            key = f"layers/{ours}"
            if key not in flat:
                flat[key] = torch.empty(lead + w.shape, dtype=torch.bfloat16)
            flat[key][idx] = _bf16(w)

    def put_layer_tensor(ours: str, i: int, w: np.ndarray):
        put(ours, (i,), (L,), w)

    def put_expert_tensor(ours: str, i: int, e: int, w: np.ndarray):
        """Expert ``e`` of layer ``i`` into ``[L, E, ...]`` (Mixtral's
        ``block_sparse_moe``)."""
        put(ours, (i, e), (L, cfg.num_experts), w)

    if gpt2:
        D = cfg.hidden_size
        for i in range(L):
            # the fused c_attn [D, 3D] -> wq|wk|wv (and biases); GPT-2's
            # Conv1D weights are [in, out] already
            ca = get(f"h.{i}.attn.c_attn.weight")
            cb = get(f"h.{i}.attn.c_attn.bias")
            for j, ours in enumerate(("wq", "wk", "wv")):
                put_layer_tensor(ours, i, ca[:, j * D:(j + 1) * D])
            for j, ours in enumerate(("bq", "bk", "bv")):
                put_layer_tensor(ours, i, cb[j * D:(j + 1) * D])
            del ca, cb
            for ours, (hf, _) in _gpt2_layer_keys(i).items():
                put_layer_tensor(ours, i, get(hf))
        flat["embedding"] = _bf16(get("wte.weight"))
        flat["pos_embedding"] = _bf16(get("wpe.weight"))
        flat["final_norm_scale"] = _bf16(get("ln_f.weight"))
        flat["final_norm_bias"] = _bf16(get("ln_f.bias"))
    else:
        for i in range(L):
            # Phi-3 stores its projections pre-fused (qkv_proj [(H+2KH)*dh,
            # D], gate_up_proj [2I, D]): split into our per-projection
            # keys, which the engine fuses again
            fq = f"model.layers.{i}.self_attn.qkv_proj.weight"
            if has(fq):
                w = get(fq)
                nq = cfg.num_heads * cfg.head_dim
                nkv = cfg.num_kv_heads * cfg.head_dim
                put_layer_tensor("wq", i, w[:nq].T)
                put_layer_tensor("wk", i, w[nq:nq + nkv].T)
                put_layer_tensor("wv", i, w[nq + nkv:].T)
                del w
            fg = f"model.layers.{i}.mlp.gate_up_proj.weight"
            if has(fg):
                w = get(fg)
                half = cfg.intermediate_size
                put_layer_tensor("w_gate", i, w[:half].T)
                put_layer_tensor("w_up", i, w[half:].T)
                del w
            for ours, (hf, transpose) in _llama_layer_map(
                    i, post_norms=cfg.post_norms,
                    qk_norm=cfg.qk_norm).items():
                if ours.startswith("w_") and cfg.num_experts > 0:
                    continue           # MoE: no dense MLP
                if not has(hf):
                    continue           # optional biases, fused splits
                w = get(hf)
                put_layer_tensor(ours, i, w.T if transpose else w)
            if cfg.num_experts > 0:
                # Mixtral's block_sparse_moe: the router and each expert's
                # w1 (gate) / w3 (up) / w2 (down), torch [out, in]
                pre = f"model.layers.{i}.block_sparse_moe."
                put_layer_tensor("router", i, get(pre + "gate.weight").T)
                for e in range(cfg.num_experts):
                    pe = pre + f"experts.{e}."
                    put_expert_tensor("we_gate", i, e,
                                      get(pe + "w1.weight").T)
                    put_expert_tensor("we_down", i, e,
                                      get(pe + "w2.weight").T)
                    put_expert_tensor("we_up", i, e,
                                      get(pe + "w3.weight").T)
        flat["embedding"] = _bf16(get("model.embed_tokens.weight"))
        flat["final_norm_scale"] = _bf16(get("model.norm.weight"))
        if not cfg.tie_embeddings:
            head = (get("lm_head.weight")
                    if has("lm_head.weight")
                    else get("model.embed_tokens.weight")).T
            if do_quant:
                q, s = _quant_np(head)
                flat["lm_head.qvalues"] = torch.from_numpy(q)
                flat["lm_head.qscales"] = torch.from_numpy(s)
            else:
                flat["lm_head"] = _bf16(head)

    if out_path is not None:
        from .checkpoint import save_flat

        save_flat(flat, out_path)
    return flat


def load_flat_params(flat: Dict[str, torch.Tensor], dtype=None,
                     device="cpu"):
    """The params tree (stacked layers, :class:`QTensor` leaves for the
    quantized keys) of a flat dict on ``device``; float leaves other than
    the scales cast to ``dtype`` if given, as the JAX loader does."""
    from ..quant.tensor import QTensor
    from .checkpoint import _insert

    tree: Dict = {}
    qt: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, v in flat.items():
        if key.endswith(".qvalues") or key.endswith(".qscales"):
            base, kind = key.rsplit(".", 1)
            qt.setdefault(base, {})[kind] = v
            continue
        v = torch.as_tensor(v)
        if dtype is not None and v.is_floating_point():
            v = v.to(dtype)
        _insert(tree, key.split("/"), v.to(device))
    for base, parts in qt.items():
        _insert(tree, base.split("/"),
                QTensor(torch.as_tensor(parts["qvalues"]).to(device),
                        torch.as_tensor(parts["qscales"]).to(device)))
    return tree


def main(argv=None) -> None:
    """The offline import / quantize command."""
    import argparse

    from ..config import preset

    ap = argparse.ArgumentParser()
    ap.add_argument("--hf-dir", required=True)
    ap.add_argument("--model", default=None,
                    help="preset name (default: derive the geometry "
                         "from the checkpoint's config.json)")
    ap.add_argument("--output", required=True, help=".npz checkpoint")
    ap.add_argument("--quant", default="int8-weight",
                    choices=("none", "int8", "int8-weight"))
    args = ap.parse_args(argv)
    cfg = (preset(args.model) if args.model
           else config_from_hf(args.hf_dir))
    q = None if args.quant == "none" else args.quant
    flat = import_hf_streaming(args.hf_dir, cfg, quant=q,
                               out_path=args.output)
    total = sum(v.numel() * v.element_size() for v in flat.values())
    print(f"wrote {args.output}: {len(flat)} tensors, "
          f"{total / 1e9:.2f} GB")


if __name__ == "__main__":
    main()
