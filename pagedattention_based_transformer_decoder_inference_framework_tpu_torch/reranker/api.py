"""Reranker: score candidate continuations against a context.

The JAX package's ``reranker/api.py``. The default scorer is the decoder
itself: the (length-normalized) log-probability of the candidate tokens
given the context, teacher-forced through the paged KV pool
(``Engine.score_candidates_nll``). A cross-encoder (a local HF
sequence-classification model) plugs in through the same
:class:`RerankScorer` interface.
"""

from __future__ import annotations

import math
from typing import List, Protocol, Sequence

import numpy as np


class RerankScorer(Protocol):
    def score(self, context_ids: Sequence[int],
              candidate_ids: Sequence[int]) -> float:
        ...


class LogProbScorer:
    """Scores candidates by the decoder's log-prob(candidate | context).

    Runs over a private KV pool and page allocator, so scoring can happen
    while a continuous-batching scheduler drives the same engine from
    another thread (no shared mutable host state)."""

    def __init__(self, engine, length_normalize: bool = True):
        from ..kvcache.native import make_allocator

        self.engine = engine
        self.length_normalize = length_normalize
        self._allocator = make_allocator(
            engine.cache.num_pages, native=engine.cache.native_allocator)

    def score(self, context_ids: Sequence[int],
              candidate_ids: Sequence[int]) -> float:
        return self.score_batch(context_ids, [candidate_ids])[0]

    def score_batch(self, context_ids: Sequence[int],
                    candidates: Sequence[Sequence[int]]) -> List[float]:
        """Every candidate in one teacher-forced pass: the context is
        prefilled once and the candidate rows share its pages by refcount
        (``Engine.score_candidates_nll``). An empty candidate scores
        ``-inf``."""
        out = [-math.inf] * len(candidates)
        live = [(i, list(c)) for i, c in enumerate(candidates) if c]
        if not live:
            return out
        nll = self.engine.score_candidates_nll(
            list(context_ids), [c for _, c in live],
            mean=self.length_normalize, allocator=self._allocator)
        for (i, _), v in zip(live, nll):
            out[i] = -float(v)
        return out


class CrossEncoderScorer:
    """An HF sequence-classification cross-encoder read from a local path
    (``transformers``, imported when it is built). ``id_tokenizer`` (the
    framework tokenizer that produced the token ids) makes the id-based
    :class:`RerankScorer` interface work: ids are decoded to text and fed
    to the cross-encoder. ``device``: where the model runs; ``None`` means
    ``cuda``, and raises if there is none (as :class:`Engine`)."""

    def __init__(self, model_path: str, tokenizer=None,
                 id_tokenizer=None, device=None):
        import torch
        from transformers import (AutoModelForSequenceClassification,
                                  AutoTokenizer)

        from ..utils.platform import resolve_device

        self._torch = torch
        self.device = resolve_device(device)
        self.tok = tokenizer or AutoTokenizer.from_pretrained(model_path)
        self.id_tokenizer = id_tokenizer
        self.model = AutoModelForSequenceClassification.from_pretrained(
            model_path).to(self.device)
        self.model.eval()

    def score(self, context_ids: Sequence[int],
              candidate_ids: Sequence[int]) -> float:
        if self.id_tokenizer is None:
            raise ValueError(
                "CrossEncoderScorer.score over token ids needs "
                "id_tokenizer=<framework tokenizer>; or call score_text")
        return self.score_text(
            self.id_tokenizer.decode(list(context_ids)),
            self.id_tokenizer.decode(list(candidate_ids)))

    def score_text(self, context: str, candidate: str) -> float:
        torch = self._torch
        with torch.no_grad():
            enc = self.tok(context, candidate, return_tensors="pt",
                           truncation=True, max_length=512)
            enc = {k: v.to(self.device) for k, v in enc.items()}
            out = self.model(**enc).logits[0].float().cpu()
            if out.numel() == 1:
                return float(out)
            return float(torch.softmax(out, -1)[-1])   # P(positive)


class Reranker:
    """``rerank_scores`` + ``select_best`` over token-id candidates."""

    def __init__(self, scorer: RerankScorer):
        self.scorer = scorer

    def rerank_scores(self, context_ids: Sequence[int],
                      candidates: Sequence[Sequence[int]]) -> List[float]:
        if hasattr(self.scorer, "score_batch"):
            return self.scorer.score_batch(context_ids, candidates)
        return [self.scorer.score(context_ids, c) for c in candidates]

    def select_best(self, context_ids: Sequence[int],
                    candidates: Sequence[Sequence[int]]) -> int:
        scores = self.rerank_scores(context_ids, candidates)
        return int(np.argmax(scores))
