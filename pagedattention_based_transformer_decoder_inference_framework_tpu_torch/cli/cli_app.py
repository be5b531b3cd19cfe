"""Command line of the PyTorch port: ``generate`` and ``stream``.

    python -m pagedattention_based_transformer_decoder_inference_framework_tpu_torch.cli.cli_app \\
        generate --model llama-tiny --prompt "hello" --max-new-tokens 8

Runs on ``cuda`` by default and raises without a card; ``--device cpu``
runs the kernels' plain PyTorch versions. Weights are a random init
from ``--seed`` (checkpoint import is a later slice). The JAX package's
other subcommands (chat, log, batch, rerank, build_jsonl, serve) wait
for the slices that port what they drive.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from ..config import FrameworkConfig, load_config, preset
from ..engine.engine import Engine
from ..engine.sampling import SamplingParams
from ..utils.tokenizer import get_tokenizer


def add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", default=None, help="YAML/JSON config path")
    p.add_argument("--model", default=None, help="model preset name")
    p.add_argument("--tokenizer", default=None,
                   help="'byte' or HF tokenizer path")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch versions of the kernels)")
    p.add_argument("--max-new-tokens", type=int, default=None)
    p.add_argument("--temperature", type=float, default=None)
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--top-p", type=float, default=None)
    p.add_argument("--min-p", type=float, default=None)
    p.add_argument("--repetition-penalty", type=float, default=None)
    p.add_argument("--presence-penalty", type=float, default=None)
    p.add_argument("--frequency-penalty", type=float, default=None)
    p.add_argument("--stop-token-ids", type=int, nargs="*", default=None,
                   help="token ids that end generation like EOS")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--prompt", required=True)


def build_config(args) -> FrameworkConfig:
    cfg = load_config(args.config)
    if args.model:
        cfg.model = preset(args.model)
    if args.tokenizer:
        cfg.tokenizer = args.tokenizer
    for key in ("max_new_tokens", "temperature", "top_k", "top_p",
                "min_p", "repetition_penalty", "presence_penalty",
                "frequency_penalty"):
        v = getattr(args, key, None)
        if v is not None:
            setattr(cfg.runtime, key, v)
    return cfg


def sampling(cfg: FrameworkConfig, tok, stop_token_ids=None) -> SamplingParams:
    r = cfg.runtime
    return SamplingParams(temperature=r.temperature, top_k=r.top_k,
                          top_p=r.top_p, min_p=r.min_p,
                          repetition_penalty=r.repetition_penalty,
                          presence_penalty=r.presence_penalty,
                          frequency_penalty=r.frequency_penalty,
                          stop_token_ids=tuple(stop_token_ids or ()),
                          eos_token_id=tok.eos_token_id,
                          eos_threshold=r.eos_threshold)


def _setup(args):
    cfg = build_config(args)
    tok = get_tokenizer(cfg.tokenizer)
    eng = Engine(cfg, device=args.device, seed=args.seed or 0)
    return cfg, tok, eng


def cmd_generate(args) -> int:
    cfg, tok, eng = _setup(args)
    out = eng.generate(tok.encode(args.prompt), cfg.runtime.max_new_tokens,
                       sampling(cfg, tok, args.stop_token_ids),
                       seed=args.seed)
    print(tok.decode(out))
    return 0


def cmd_stream(args) -> int:
    cfg, tok, eng = _setup(args)
    for t in eng.generate_stream(tok.encode(args.prompt),
                                 cfg.runtime.max_new_tokens,
                                 sampling(cfg, tok, args.stop_token_ids),
                                 seed=args.seed):
        sys.stdout.write(tok.decode_token(t))
        sys.stdout.flush()
    print()
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="pagedattention-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("generate", help="one-shot generation")
    add_common(p)
    p.set_defaults(fn=cmd_generate)
    p = sub.add_parser("stream", help="token-at-a-time streaming")
    add_common(p)
    p.set_defaults(fn=cmd_stream)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
