"""Command line of the PyTorch port: ``generate``, ``stream``, ``chat``,
``log``, ``batch``, ``rerank``, ``build_jsonl`` and ``serve``.

    python -m pagedattention_based_transformer_decoder_inference_framework_tpu_torch.cli.cli_app \\
        generate --model llama-tiny --prompt "hello" --max-new-tokens 8
    python -m ...cli.cli_app chat --model llama-tiny
    python -m ...cli.cli_app log --session chat.jsonl
    python -m ...cli.cli_app batch --input prompts.txt --output out.jsonl \\
        --temperature 0 --spec-k 4
    python -m ...cli.cli_app rerank --context "..." --candidates a b c
    python -m ...cli.cli_app build_jsonl --prompts p.txt --out train.jsonl
    python -m ...cli.cli_app serve --model llama3-8b --config cfg.yaml

Runs on ``cuda`` by default and raises without a card; ``--device cpu``
runs the kernels' plain PyTorch versions. Every subcommand builds its
engine through ``engine/router.py::build_engine``: ``--device`` wins over
``server.backend``, and ``weights_path`` in the config (a native ``.npz``
checkpoint, ``models/checkpoint.py``, or an HF checkpoint directory,
stream-imported) loads the weights, else they are a random init from
``--seed``. ``--model`` takes a preset name or an HF checkpoint
directory: its ``config.json`` gives the model, the directory the weights
and, unless ``--tokenizer`` or the config names one, the tokenizer.
``chat`` is an interactive multi-turn loop (an empty line or end of input
ends it) and ``log`` the same with each turn appended to a JSONL
session file. ``batch`` takes the speculative path
(``Engine.generate_batch_spec``) when ``runtime.spec_k > 0``
(``--spec-k``) and the request is greedy with no penalties or stop ids.
``rerank`` scores each candidate's log-probability given the context
(``reranker.LogProbScorer``; ``--scorer cross-encoder`` reads a local
sequence-classification model instead); ``build_jsonl`` runs beam search
on each prompt of a file and writes every hypothesis as a JSONL row,
labelled 1 for the one the reranker ranks best. ``serve`` starts the REST
and streaming server (FastAPI under uvicorn where both are installed,
else the stdlib ``BasicServer``) over the continuous-batching scheduler;
multi-host serving (``--coordinator``) waits for ROADMAP A7.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

from ..config import FrameworkConfig, load_config, preset
from ..engine.router import build_engine
from ..engine.sampling import SamplingParams
from ..utils.tokenizer import get_tokenizer


def add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", default=None, help="YAML/JSON config path")
    p.add_argument("--model", default=None,
                   help="model preset name or HF checkpoint directory")
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


def build_config(args) -> FrameworkConfig:
    cfg = load_config(args.config)
    if args.model and os.path.isdir(args.model):
        # an HF checkpoint directory: the geometry from its config.json,
        # the weights stream-imported by the engine factory
        from ..models.hf_stream import config_from_hf

        cfg.model = config_from_hf(args.model)
        if not cfg.weights_path:
            cfg.weights_path = args.model
        if args.tokenizer is None and cfg.tokenizer == "byte":
            cfg.tokenizer = args.model   # the checkpoint's tokenizer
    elif args.model:
        cfg.model = preset(args.model)
    if args.tokenizer:
        cfg.tokenizer = args.tokenizer
    for key in ("max_new_tokens", "temperature", "top_k", "top_p",
                "min_p", "repetition_penalty", "presence_penalty",
                "frequency_penalty", "spec_k"):
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


def _engine(cfg: FrameworkConfig, args):
    return build_engine(cfg, device=args.device, seed=args.seed or 0)


def _setup(args):
    cfg = build_config(args)
    tok = get_tokenizer(cfg.tokenizer)
    return cfg, tok, _engine(cfg, args)


def cmd_generate(args) -> int:
    cfg, tok, eng = _setup(args)
    out = eng.generate(tok.encode(args.prompt), cfg.runtime.max_new_tokens,
                       sampling(cfg, tok, args.stop_token_ids),
                       seed=args.seed)
    print(tok.decode(out))
    return 0


def cmd_batch(args) -> int:
    cfg, tok, eng = _setup(args)
    with open(args.input) as f:
        prompts = [line.rstrip("\n") for line in f if line.strip()]
    ids = [tok.encode(p) for p in prompts]
    sp = sampling(cfg, tok, args.stop_token_ids)
    if (cfg.runtime.spec_k > 0 and sp.mode().greedy
            and not (sp.has_penalties or sp.stop_token_ids
                     or sp.logit_bias)):
        # prompt-lookup speculative decoding (greedy-exact, engine/spec.py)
        outs = eng.generate_batch_spec(ids, cfg.runtime.max_new_tokens, sp)
    else:
        outs = eng.generate_batch(ids, cfg.runtime.max_new_tokens, sp,
                                  seed=args.seed)
    with open(args.output, "w") as f:
        for p, o in zip(prompts, outs):
            f.write(json.dumps({"prompt": p, "completion": tok.decode(o)},
                               ensure_ascii=False) + "\n")
    print(f"wrote {len(outs)} completions to {args.output}")
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


def _chat_loop(args, log_path: Optional[str]) -> int:
    cfg, tok, eng = _setup(args)
    messages: List[dict] = []
    log_f = open(log_path, "a") if log_path else None
    print("(interactive chat; empty line or Ctrl-D to exit)")
    try:
        while True:
            try:
                user = input("you> ").strip()
            except EOFError:
                break
            if not user:
                break
            messages.append({"role": "user", "content": user})
            prompt = cfg.chat.render(messages)
            out = eng.generate(tok.encode(prompt),
                               cfg.runtime.max_new_tokens,
                               sampling(cfg, tok, args.stop_token_ids),
                               seed=args.seed)
            reply = tok.decode(out)
            print(f"bot> {reply}")
            messages.append({"role": "assistant", "content": reply})
            if log_f:
                log_f.write(json.dumps(
                    {"ts": time.time(), "user": user, "assistant": reply})
                    + "\n")
                log_f.flush()
    finally:
        if log_f:
            log_f.close()
    return 0


def cmd_chat(args) -> int:
    return _chat_loop(args, None)


def cmd_log(args) -> int:
    """Chat with JSONL session logging."""
    return _chat_loop(args, args.session)


def cmd_rerank(args) -> int:
    from ..reranker import LogProbScorer, Reranker

    cfg = build_config(args)
    tok = get_tokenizer(cfg.tokenizer)
    if args.scorer == "cross-encoder":
        from ..reranker import CrossEncoderScorer

        path = args.reranker_model or cfg.runtime.reranker_model
        if not path:
            print("--reranker-model (or runtime.reranker_model) required "
                  "for --scorer cross-encoder")
            return 2
        rr = Reranker(CrossEncoderScorer(path, id_tokenizer=tok,
                                          device=args.device))
    else:
        rr = Reranker(LogProbScorer(_engine(cfg, args)))
    ctx = tok.encode(args.context)
    cands = [tok.encode(c) for c in args.candidates]
    scores = rr.rerank_scores(ctx, cands)
    best = int(max(range(len(scores)), key=lambda i: scores[i]))
    for i, (c, s) in enumerate(zip(args.candidates, scores)):
        mark = "*" if i == best else " "
        print(f"{mark} [{s:9.4f}] {c}")
    return 0


def cmd_build_jsonl(args) -> int:
    """Beam search -> a labelled reranker dataset: each prompt's
    hypotheses, the best-reranked one labelled 1."""
    from ..engine.beam import BeamSearcher
    from ..reranker import LogProbScorer, Reranker
    from ..reranker.export_jsonl import export_jsonl

    cfg, tok, eng = _setup(args)
    rr = Reranker(LogProbScorer(eng))
    rows = []
    with open(args.prompts) as f:
        prompts = [line.strip() for line in f if line.strip()]
    for prompt in prompts:
        ids = tok.encode(prompt)
        beams = BeamSearcher(eng, beam_width=args.beam_width).search(
            ids, cfg.runtime.max_new_tokens, eos_token_id=tok.eos_token_id)
        cands = [b.tokens for b in beams]
        best = rr.select_best(ids, cands)
        for i, c in enumerate(cands):
            rows.append({"context": prompt, "candidate": tok.decode(c),
                         "label": int(i == best)})
    n = export_jsonl(rows, args.out)
    print(f"wrote {n} rows to {args.out}")
    return 0


def cmd_serve(args) -> int:
    if args.coordinator:
        raise NotImplementedError(
            "multi-host serving (--coordinator) waits for the parallelism "
            "port (ROADMAP A7)")
    from ..server.core import ServerCore

    cfg = build_config(args)
    if args.port is not None:
        cfg.server.port = args.port
    if args.host:
        cfg.server.host = args.host
    core = ServerCore(cfg, engine=_engine(cfg, args))
    try:
        import uvicorn

        from ..server.app import create_app

        app = create_app(cfg, core=core)
    except ImportError:
        from ..server.basic import BasicServer

        srv = BasicServer(cfg, core=core)
        print(f"serving (stdlib) on {cfg.server.host}:{srv.port}",
              flush=True)
        try:
            srv.serve_forever()
        finally:
            srv.shutdown()
        return 0
    try:
        uvicorn.run(app, host=cfg.server.host, port=cfg.server.port)
    finally:
        core.close()
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="pagedattention-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("generate", help="one-shot generation")
    add_common(p)
    p.add_argument("--prompt", required=True)
    p.set_defaults(fn=cmd_generate)
    p = sub.add_parser("stream", help="token-at-a-time streaming")
    add_common(p)
    p.add_argument("--prompt", required=True)
    p.set_defaults(fn=cmd_stream)
    p = sub.add_parser("chat", help="interactive multi-turn chat")
    add_common(p)
    p.set_defaults(fn=cmd_chat)
    p = sub.add_parser("log", help="chat with JSONL session logging")
    add_common(p)
    p.add_argument("--session", default="chat_session.jsonl")
    p.set_defaults(fn=cmd_log)
    p = sub.add_parser("batch", help="file of prompts -> JSONL")
    add_common(p)
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--spec-k", type=int, default=None,
                   help="runtime.spec_k: draft tokens per speculative "
                        "step (0 = plain decode)")
    p.set_defaults(fn=cmd_batch)
    p = sub.add_parser("rerank", help="score candidates for a context")
    add_common(p)
    p.add_argument("--context", required=True)
    p.add_argument("--candidates", nargs="+", required=True)
    p.add_argument("--scorer", default="logprob",
                   choices=("logprob", "cross-encoder"))
    p.add_argument("--reranker-model", default="",
                   help="local cross-encoder path")
    p.set_defaults(fn=cmd_rerank)
    p = sub.add_parser("build_jsonl",
                       help="beam search -> labelled reranker dataset")
    add_common(p)
    p.add_argument("--prompts", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--beam-width", type=int, default=4)
    p.set_defaults(fn=cmd_build_jsonl)
    p = sub.add_parser("serve", help="start the REST/SSE server")
    add_common(p)
    p.add_argument("--host", default=None)
    p.add_argument("--port", type=int, default=None,
                   help="0 picks a free port")
    p.add_argument("--coordinator", default=None,
                   help="multi-host coordinator address host:port (not "
                        "ported: ROADMAP A7)")
    p.set_defaults(fn=cmd_serve)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
