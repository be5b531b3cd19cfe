"""Quantization quality harness: perplexity of the float model and of each
quantized mode, and their deltas (the JAX package's ``quant/eval.py``).

Two backends: ``dense``, the exact full-attention oracle over the whole
sequence (small models, tests), and ``paged``, the engine's
teacher-forced paged scorer (:meth:`Engine.score_nll`), which holds one
prefill chunk of logits at a time and scales to real checkpoints. INT4
runs through the engine only, as in the JAX package.

    python -m pagedattention_based_transformer_decoder_inference_framework_tpu_torch.quant.eval \\
        --model llama-tiny --backend paged --device cpu
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..config import ModelConfig
from ..models.model import DecoderModel, Params, quantize_params


def sequence_nll(model: DecoderModel, params: Params,
                 tokens: Sequence[int]) -> float:
    """Mean negative log-likelihood of ``tokens[1:]`` given their
    prefixes: a teacher-forced full forward through the dense attention
    oracle, on the device of ``params``."""
    from ..engine.backends import DenseKVBackend

    device = params["embedding"].device
    toks = torch.tensor(list(tokens), dtype=torch.long, device=device)[None]
    T = toks.shape[1]
    dense = DenseKVBackend(model.cfg, kv_dtype="float32")
    with torch.inference_mode():
        logits, _ = model.forward(
            params, toks, torch.arange(T, device=device)[None],
            dense.init_cache(1, T, device=device), dense.attn_fn)
        logp = torch.log_softmax(logits[0, :-1].float(), dim=-1)
        nll = -logp.gather(-1, toks[0, 1:, None]).mean()
    return float(nll)


def perplexity(model: DecoderModel, params: Params,
               eval_seqs: Sequence[Sequence[int]]) -> float:
    nlls = [sequence_nll(model, params, s) for s in eval_seqs]
    return math.exp(float(np.mean(nlls)))


#: sequences per :meth:`Engine.score_nll` call, and the page size, of
#: :func:`paged_perplexity`
_PPL_BATCH, _PPL_PAGE = 4, 64


def paged_perplexity(cfg: ModelConfig, params: Params,
                     eval_seqs: Sequence[Sequence[int]],
                     device=None) -> float:
    """Token-weighted perplexity through :meth:`Engine.score_nll` (bf16
    paged KV), four sequences at a time, on ``device`` (``None``:
    ``cuda``)."""
    from ..config import CacheConfig, FrameworkConfig, RuntimeConfig
    from ..engine.engine import Engine
    from ..utils.common import cdiv

    batch = _PPL_BATCH
    max_len = max(len(s) for s in eval_seqs)
    pps = cdiv(max_len, _PPL_PAGE)
    fw = FrameworkConfig(
        model=cfg,
        cache=CacheConfig(page_size=_PPL_PAGE, num_pages=pps * batch + 8,
                          max_pages_per_seq=pps, kv_dtype="bfloat16"),
        runtime=RuntimeConfig())
    eng = Engine(fw, params=params, device=device)
    nlls: list = []
    counts: list = []
    for i in range(0, len(eval_seqs), batch):
        group = [list(s) for s in eval_seqs[i:i + batch]]
        nlls.extend(float(x) for x in eng.score_nll(group))
        counts.extend(len(s) - 1 for s in group)
    total = sum(n * c for n, c in zip(nlls, counts))
    return math.exp(total / max(sum(counts), 1))


def ppl_delta_report(cfg: ModelConfig, params: Params,
                     eval_seqs: Sequence[Sequence[int]],
                     modes: Sequence[str] = ("int8", "int8-weight"),
                     backend: str = "dense", device=None
                     ) -> Dict[str, float]:
    """Perplexity of the float model and of each quantized mode, and each
    mode's delta. ``backend="dense"`` runs the oracle on the device of
    ``params``; ``"paged"`` the engine on ``device``."""
    if backend not in ("dense", "paged"):
        raise ValueError(f"backend {backend!r}")

    def _ppl(mcfg: ModelConfig, p: Params) -> float:
        if backend == "paged":
            return paged_perplexity(mcfg, p, eval_seqs, device=device)
        return perplexity(DecoderModel(mcfg), p, eval_seqs)

    report = {"fp": _ppl(dataclasses.replace(cfg, quant="none"), params)}
    qparams = quantize_params(params)
    for mode in modes:
        if mode == "int4" and backend != "paged":
            raise ValueError("int4 runs through the engine (backend="
                             "'paged'): the dense oracle's stacked layers "
                             "have no nibble layout")
        # int4: the engine repacks the INT8 weights group-wise
        report[mode] = _ppl(dataclasses.replace(cfg, quant=mode), qparams)
        report[f"{mode}_delta"] = report[mode] - report["fp"]
    return report


def main(argv: Optional[Sequence[str]] = None) -> None:
    """CLI: perplexity deltas on random or file-provided token sequences
    over a native ``.npz`` checkpoint (``--weights``, e.g. one that
    ``models/hf_stream.py`` wrote) or a random-init model."""
    import argparse
    import json

    from ..config import preset
    from ..models.model import init_params
    from ..utils.platform import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="gpt2-tiny")
    ap.add_argument("--tokens-file", default=None,
                    help="JSONL with {'tokens': [...]} rows")
    ap.add_argument("--text-file", default=None,
                    help="plain text, tokenized with --tokenizer")
    ap.add_argument("--tokenizer", default="byte")
    ap.add_argument("--weights", default=None,
                    help="native .npz checkpoint (e.g. from hf_stream); "
                         "default = random init")
    ap.add_argument("--backend", default="dense",
                    choices=("dense", "paged"))
    ap.add_argument("--num-seqs", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default cuda; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = preset(args.model)
    if args.backend == "dense":
        cfg.dtype = "float32"
    if args.weights:
        from ..models.checkpoint import load_params

        params = load_params(args.weights, device=device)
    else:
        params = init_params(cfg, torch.Generator(
            device=device).manual_seed(args.seed), device)
    if args.tokens_file:
        with open(args.tokens_file) as f:
            seqs = [json.loads(line)["tokens"] for line in f]
    elif args.text_file:
        from ..utils.tokenizer import get_tokenizer

        with open(args.text_file) as f:
            ids = get_tokenizer(args.tokenizer).encode(f.read())
        L = args.seq_len
        seqs = [ids[i:i + L] for i in range(0, len(ids) - 1, L)]
        seqs = [s for s in seqs if len(s) >= 2][:args.num_seqs or None]
    else:
        rng = np.random.default_rng(args.seed)
        seqs = rng.integers(0, cfg.vocab_size,
                            (args.num_seqs, args.seq_len)).tolist()
    modes = ("int8", "int8-weight")
    if args.backend == "paged":
        modes = modes + ("int4",)
    print(json.dumps(ppl_delta_report(cfg, params, seqs, modes=modes,
                                      backend=args.backend, device=device),
                     indent=2))


if __name__ == "__main__":
    main()
