"""Transport-agnostic serving core (the JAX package's
``server/core.py``, on one device).

All endpoint logic of the REST and streaming API lives here; the stdlib
server (``basic.py``) and the FastAPI app (``app.py``) are thin
transports over it.

Streaming framings:

* newline-JSON: one JSON object a line;
* SSE: ``data: {...}\\n\\n`` frames and an ``event: done`` terminator.

Threads: the scheduler's pump thread runs every generation request; a
beam request runs its search and rerank on the transport's handler
thread, beside the pump, on the searcher's private pool and allocator.
``torch.inference_mode`` is per thread, so that thread enters it itself.
Both threads launch on the device's current stream, where kernels run in
issue order, so the split-KV and split-K kernels' counters (one set per
device and stream, ``utils/platform.py::split_counters``) are never used
by two launches at once, and each call's workspace comes from the
caching allocator on that stream.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Iterator, List, Optional

import torch

from ..config import FrameworkConfig
from ..engine.sampling import SamplingParams
from ..utils.logging import log_event, setup_logging
from ..utils.tokenizer import get_tokenizer
from .metrics import Metrics
from .schema import (BatchGenerateRequest, BeamStreamRequest,
                     GenerateRequest, StreamChatRequest)


def sse_frame(data: dict) -> str:
    return f"data: {json.dumps(data)}\n\n"


def ndjson_frame(data: dict) -> str:
    return json.dumps(data) + "\n"


class ServerCore:
    """Serving modes (who turns prompts into tokens): the
    continuous-batching ``Scheduler`` (default; concurrent requests share
    decode bursts), or with ``use_scheduler=False`` a dedicated engine
    stream per request. ``engine``: built from ``config`` by
    ``engine/router.py::build_engine`` when not given (on the card unless
    ``config.server.backend`` is ``"cpu"``). The JAX package's multi-host
    ``pump`` waits for the parallelism port (ROADMAP A7)."""

    def __init__(self, config: Optional[FrameworkConfig] = None,
                 engine=None, reranker=None,
                 use_scheduler: bool = True, pump=None):
        if pump is not None:
            raise NotImplementedError(
                "multi-host serving (a lockstep pump) waits for the "
                "parallelism port (ROADMAP A7)")
        self.config = config or FrameworkConfig()
        setup_logging(self.config.runtime)
        if engine is None:
            from ..engine.router import build_engine

            engine = build_engine(self.config)
        self.engine = engine
        self.tokenizer = get_tokenizer(self.config.tokenizer)
        if reranker is None:
            from ..reranker import LogProbScorer, Reranker

            if self.config.runtime.reranker_model:
                from ..reranker import CrossEncoderScorer

                reranker = Reranker(CrossEncoderScorer(
                    self.config.runtime.reranker_model,
                    id_tokenizer=self.tokenizer, device=engine.device))
            else:
                reranker = Reranker(LogProbScorer(engine))
        self.reranker = reranker
        self.metrics = Metrics()
        self.scheduler = None
        if use_scheduler:
            from ..scheduler import Scheduler

            self.scheduler = Scheduler(engine)
            self.scheduler.start()
        # beam requests run on a private KV pool + allocator concurrent
        # with the scheduler; the lock only serializes beams against
        # each other (bounds transient pool memory to one extra pool)
        self._beam_lock = threading.Lock()
        self._beam_searchers: dict = {}

    def close(self) -> None:
        """Stop the scheduler's pump thread."""
        if self.scheduler is not None:
            self.scheduler.stop()

    # -- helpers -------------------------------------------------------------

    def _sampling(self, req) -> SamplingParams:
        return SamplingParams(
            temperature=req.temperature, top_k=req.top_k, top_p=req.top_p,
            min_p=getattr(req, "min_p", 0.0),
            repetition_penalty=getattr(req, "repetition_penalty", 1.0),
            presence_penalty=getattr(req, "presence_penalty", 0.0),
            frequency_penalty=getattr(req, "frequency_penalty", 0.0),
            stop_token_ids=tuple(getattr(req, "stop_token_ids", ()) or ()),
            logit_bias=tuple(sorted(
                (getattr(req, "logit_bias", {}) or {}).items())),
            eos_token_id=self.tokenizer.eos_token_id,
            eos_threshold=self.config.runtime.eos_threshold)

    def _token_iter(self, prompt_ids: List[int], max_new: int,
                    sampling: SamplingParams, seed: Optional[int]):
        """Token source: the scheduler when enabled, else a dedicated
        engine stream. Returns ``(iterator, request-or-None)``; the
        request handle carries the failure (``error``) the endpoints
        answer with error responses or frames."""
        if self.scheduler is not None:
            req = self.scheduler.submit(prompt_ids, max_new, sampling,
                                        seed=seed)
            return req.stream(), req
        return self.engine.generate_stream(prompt_ids, max_new, sampling,
                                           seed=seed), None

    def _stream(self, prompt_ids: List[int], max_new: int,
                sampling: SamplingParams,
                seed: Optional[int]) -> Iterator[dict]:
        t0 = time.time()
        ttft = None
        n_out = 0
        it, handle = self._token_iter(prompt_ids, max_new, sampling, seed)
        try:
            for tok in it:
                if ttft is None:
                    ttft = time.time() - t0
                n_out += 1
                yield {"token": int(tok),
                       "text": self.tokenizer.decode_token(tok)}
                if self.config.runtime.stream_delay_ms:
                    time.sleep(self.config.runtime.stream_delay_ms / 1000)
        except Exception as e:           # engine-path error mid-stream
            self.metrics.record(tokens_in=len(prompt_ids),
                                tokens_out=n_out, ttft_s=ttft,
                                total_s=time.time() - t0, failed=True)
            yield {"token": None, "finish_reason": "error",
                   "error": str(e)}
            return
        err = handle.error if handle is not None else None
        self.metrics.record(tokens_in=len(prompt_ids), tokens_out=n_out,
                            ttft_s=ttft, total_s=time.time() - t0,
                            failed=err is not None)
        log_event("stream_done", tokens_in=len(prompt_ids),
                  tokens_out=n_out,
                  ttft_ms=round((ttft or 0.0) * 1e3, 1),
                  total_ms=round((time.time() - t0) * 1e3, 1))
        if err is not None:
            yield {"token": None, "finish_reason": "error", "error": err}
        else:
            yield {"token": None,
                   "finish_reason": "eos" if n_out < max_new else "length"}

    @staticmethod
    def frame(gen: Iterator[dict], sse: bool) -> Iterator[str]:
        if sse:
            for item in gen:
                yield sse_frame(item)
            yield "event: done\ndata: {}\n\n"
        else:
            for item in gen:
                yield ndjson_frame(item)

    # -- endpoints -------------------------------------------------------------

    def healthz(self) -> dict:
        return {"status": "ok", "model": self.config.model.name}

    def get_metrics(self) -> dict:
        return self.metrics.snapshot(self.engine)

    def generate(self, req: GenerateRequest) -> dict:
        t0 = time.time()
        ids = self.tokenizer.encode(req.prompt)
        it, handle = self._token_iter(ids, req.max_new_tokens,
                                      self._sampling(req), req.seed)
        out = list(it)
        if handle is not None and handle.error is not None:
            self.metrics.record(tokens_in=len(ids), tokens_out=len(out),
                                ttft_s=None, total_s=time.time() - t0,
                                failed=True)
            raise RuntimeError(handle.error)      # transports map to 500
        reason = ("eos" if out and out[-1] == self.tokenizer.eos_token_id
                  else "length")
        self.metrics.record(tokens_in=len(ids), tokens_out=len(out),
                            ttft_s=None, total_s=time.time() - t0)
        return {"text": self.tokenizer.decode(out), "tokens": out,
                "finish_reason": reason}

    def generate_batch(self, req: BatchGenerateRequest) -> dict:
        t0 = time.time()
        idss = [self.tokenizer.encode(p) for p in req.prompts]
        errors: List[Optional[str]] = [None] * len(idss)
        if self.scheduler is not None:
            rs = [self.scheduler.submit(ids, req.max_new_tokens,
                                        self._sampling(req), seed=req.seed)
                  for ids in idss]
            outs = [list(r.stream()) for r in rs]
            errors = [r.error for r in rs]
        else:
            sp = self._sampling(req)
            if self.config.runtime.spec_k > 0 and sp.mode().greedy:
                # prompt-lookup speculative decoding (greedy-exact)
                outs = self.engine.generate_batch_spec(
                    idss, req.max_new_tokens, sp)
            else:
                outs = self.engine.generate_batch(
                    idss, req.max_new_tokens, sp, seed=req.seed)
        self.metrics.record(tokens_in=sum(map(len, idss)),
                            tokens_out=sum(map(len, outs)), ttft_s=None,
                            total_s=time.time() - t0,
                            failed=any(e is not None for e in errors))
        results = []
        for o, e in zip(outs, errors):
            r = {"text": self.tokenizer.decode(o), "tokens": o}
            if e is not None:
                r["error"] = e                   # per-request isolation
            results.append(r)
        return {"results": results}

    def stream_generate(self, req: GenerateRequest,
                        sse: bool) -> Iterator[str]:
        gen = self._stream(self.tokenizer.encode(req.prompt),
                           req.max_new_tokens, self._sampling(req), req.seed)
        return self.frame(gen, sse)

    def stream_chat(self, req: StreamChatRequest,
                    sse: bool) -> Iterator[str]:
        prompt = self.config.chat.render(
            [m.model_dump() for m in req.messages])
        gen = self._stream(self.tokenizer.encode(prompt),
                           req.max_new_tokens, self._sampling(req), req.seed)
        return self.frame(gen, sse)

    def stream_chat_beam(self, req: BeamStreamRequest,
                         sse: bool) -> Iterator[str]:
        from ..engine.beam import BeamSearcher

        prompt = self.config.chat.render(
            [m.model_dump() for m in req.messages])
        ids = self.tokenizer.encode(prompt)
        t0 = time.time()
        # beams serialize among themselves only; the scheduler keeps
        # pumping concurrently (private pool). This thread is not the
        # pump's, so it enters inference mode itself
        with self._beam_lock, torch.inference_mode():
            searcher = self._beam_searchers.get(req.beam_width)
            if searcher is None:
                searcher = BeamSearcher(self.engine,
                                        beam_width=req.beam_width)
                self._beam_searchers[req.beam_width] = searcher
            beams = searcher.search(
                ids, req.max_new_tokens,
                eos_token_id=self.tokenizer.eos_token_id)
            cands = [b.tokens for b in beams]
            best = (self.reranker.select_best(ids, cands)
                    if req.use_rerank else 0)
        winner = cands[best]
        self.metrics.record(tokens_in=len(ids), tokens_out=len(winner),
                            ttft_s=None, total_s=time.time() - t0)

        def restream():
            for tok in winner:
                yield {"token": int(tok),
                       "text": self.tokenizer.decode_token(tok),
                       "beam": best}
                if self.config.runtime.stream_delay_ms:
                    time.sleep(self.config.runtime.stream_delay_ms / 1000)
            yield {"token": None, "finish_reason": "stop",
                   "num_beams": len(cands)}

        return self.frame(restream(), sse)
