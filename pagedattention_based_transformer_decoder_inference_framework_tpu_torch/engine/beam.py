"""Stepwise beam search with copy-on-write KV pages.

The JAX package's ``engine/beam.py`` for one device:

* the prompt is prefilled **once**; the beam rows share its pages by
  refcount (``PageAllocator.fork``);
* each step scores every beam in one batched forward, keeps the top
  ``beam_width`` (parent, token) pairs by cumulative log-probability and
  rewires the rows' block tables to their parents' pages, sharing full
  pages read-only;
* before a row appends into a page another row also holds, the page goes
  through ``ensure_exclusive`` and is copied on the device
  (``kvcache/pool.py::copy_pages_tree``, copy-on-write), so only partial
  tail pages are ever copied;
* steps run in device bursts (``Engine._decode_beam_burst``):
  selection, copies and the block tables' rewiring stay on the device for
  ``burst`` steps, and the host then replays the same page arithmetic on
  its allocator; the rest run one fused step at a time
  (``Engine._decode_beam``), the copies riding the next step;
* rows that reach EOS are frozen, and the hypotheses can be re-scored by a
  :mod:`..reranker` scorer.

The JAX searcher's unfused route (host selection over ``decode_forced``)
serves meshed engines only; the port has no mesh (ROADMAP queue A, item
7), so every step here is fused.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..kvcache.allocator import OutOfPagesError
from ..kvcache.native import make_allocator
from .engine import Engine, EngineState


@dataclasses.dataclass
class BeamHypothesis:
    tokens: List[int]
    score: float                       # cumulative log-prob

    @property
    def normalized_score(self) -> float:
        return self.score / max(len(self.tokens), 1)


class BeamSearcher:
    """Beam decoding against one :class:`Engine`, over its own KV pool and
    its own page allocator (a private :class:`EngineState`), so beam
    requests run beside a live continuous-batching ``Scheduler`` on the
    same engine with no shared mutable host state.

    ``burst``: beam steps a device burst (default ``runtime.beam_burst``;
    1 runs every step alone); by default a burst may grow to
    ``runtime.beam_burst_max`` when the step budget allows, and an explicit
    ``burst`` pins the length."""

    def __init__(self, engine: Engine, beam_width: int = 4,
                 length_penalty: float = 0.0,
                 burst: Optional[int] = None):
        self.engine = engine
        self.W = beam_width
        self.length_penalty = length_penalty
        self.allocator = make_allocator(
            engine.cache.num_pages, native=engine.cache.native_allocator)
        self._beam_step = engine._decode_beam
        runtime = engine.config.runtime
        self.burst = runtime.beam_burst if burst is None else burst
        self.burst_max = (max(self.burst, runtime.beam_burst_max)
                          if burst is None else self.burst)
        self._beam_burst = (engine._decode_beam_burst
                            if self.burst > 1 else None)

    # -- page bookkeeping ---------------------------------------------------

    def _fork_rows(self, state: EngineState, parents: np.ndarray):
        """Re-wire each beam row to its parent's pages (shared) and make
        its tail page exclusive, since the next append writes it. Returns
        the copy-on-write copies ``(src [W], dst [W])`` the next fused step
        runs first, padded with dump-page self-copies."""
        alloc = self.allocator
        old_pages = state.pages
        new_pages = [alloc.fork(old_pages[int(p)]) for p in parents]
        for ps in old_pages:                  # the old rows' references
            for pg in ps:
                alloc.free(pg)
        copies_src: List[int] = []
        copies_dst: List[int] = []
        for ps in new_pages:
            if not ps:
                continue
            excl, copied = alloc.ensure_exclusive(ps[-1])
            if copied:
                copies_src.append(ps[-1])
                copies_dst.append(excl)
                ps[-1] = excl
        # pad to W so every step takes copies of one length
        while len(copies_src) < len(new_pages):
            copies_src.append(0)
            copies_dst.append(0)
        state.pages = new_pages
        state.block_tables = self.engine._block_tables(new_pages)
        return (np.asarray(copies_src, np.int32),
                np.asarray(copies_dst, np.int32))

    # -- search ---------------------------------------------------------------

    def search(self, prompt: Sequence[int], max_new_tokens: int,
               eos_token_id: int = -1,
               num_return: Optional[int] = None) -> List[BeamHypothesis]:
        """Run beam search; returns hypotheses sorted by normalized score
        (by ``length_penalty``; the cumulative score at 0)."""
        eng, W = self.engine, self.W
        # the prompt is prefilled once (batch 1); the W rows share its pages
        state = eng.prefill([prompt], allocator=self.allocator)
        L = int(state.seq_lens[0])
        state.seq_lens = np.full((W,), L, np.int32)
        state.last_tokens = np.zeros((W,), np.int32)
        state.finished = np.zeros((W,), bool)
        finished: List[BeamHypothesis] = []
        try:
            # 1 row -> W refcount-shared rows; the copies ride the next step
            pending = self._fork_rows(state, np.zeros((W,), np.int32))
            logprobs = _log_softmax(state.prefill_logits[0])
            top = np.argsort(-logprobs)[:W]
            beam_tokens: List[List[int]] = [[int(t)] for t in top]
            beam_scores = np.array([logprobs[t] for t in top], np.float64)
            alive = np.ones((W,), bool)
            if eos_token_id >= 0:
                for i, t in enumerate(top):
                    if int(t) == eos_token_id:
                        finished.append(BeamHypothesis(
                            [int(t)], float(beam_scores[i])))
                        alive[i] = False
            steps = max_new_tokens - 1
            if self._beam_burst is not None and steps > 0 and alive.any():
                (beam_tokens, beam_scores, alive, pending, steps) = \
                    self._search_bursts(state, beam_tokens, beam_scores,
                                        alive, pending, finished,
                                        eos_token_id, steps)
            beam_tokens, beam_scores, alive = self._search_steps(
                state, beam_tokens, beam_scores, alive, pending, finished,
                eos_token_id, steps)
        finally:
            # on any exit, so an error mid-search leaks no page
            eng.free(state)

        for i in range(W):
            if alive[i]:
                finished.append(BeamHypothesis(beam_tokens[i],
                                               float(beam_scores[i])))

        def key(h: BeamHypothesis) -> float:
            if self.length_penalty > 0:
                return h.score / (len(h.tokens) ** self.length_penalty)
            return h.score

        finished.sort(key=key, reverse=True)
        return finished[: num_return or W]

    def _search_bursts(self, state: EngineState, beam_tokens, beam_scores,
                       alive, pending, finished, eos_token_id: int,
                       steps: int):
        """Beam expansion in device bursts: the host uploads once, the
        device runs a burst of selection + copy + rewire steps, one fetch
        brings the traces back, and the host replays the burst's page
        arithmetic on its allocator and rebuilds the hypotheses. A burst is
        the power of two at or above ``min(steps, burst_max)``, halved to
        the page budget (the block tables' width) and on pool pressure.
        Returns the remaining step budget for the per-step path when a
        burst's fresh pages cannot be had."""
        eng, W = self.engine, self.W
        mp = eng.cache.max_pages_per_seq
        page = eng.cache.page_size
        dev = eng.device
        while steps > 0 and alive.any():
            # overshooting the step budget is fine (the extra steps are
            # dropped); overshooting the page budget is not
            page_budget = mp * page - 1 - int(state.seq_lens[0])
            K = 1
            while K < min(self.burst_max, max(steps, 1)):
                K *= 2
            while K > page_budget:
                K //= 2
            fresh_flat = None
            while K >= 1:
                try:
                    fresh_flat = self.allocator.alloc_many(K * W)
                    break
                except OutOfPagesError:
                    K //= 2
            if K < 1 or fresh_flat is None:
                break                      # the per-step path for the rest
            fresh = np.asarray(fresh_flat, np.int32).reshape(K, W)
            # this burst's first append slot (a row's own page when L lands
            # on a page boundary)
            for b in range(W):
                eng._alloc_pages(state, b, int(state.seq_lens[b]) + 1)
            state.block_tables = eng._block_tables(state.pages)
            toks_in = np.asarray([bt[-1] for bt in beam_tokens], np.int32)
            t = eng._t
            pars, toks, vals, alives, _, _, csrc, cdst, state.kv = \
                self._beam_burst(
                    eng.params, t(toks_in), state.kv, t(state.block_tables),
                    t(state.seq_lens), t(beam_scores, torch.float32),
                    t(alive, torch.bool), t(pending[0]), t(pending[1]),
                    t(fresh), torch.tensor(eos_token_id, dtype=torch.int32,
                                           device=dev), num_steps=K)
            # one fetch: every trace as f64 (ids are exact below 2^53)
            host = torch.cat([pars.double(), toks.double(), vals.double(),
                              alives.double(), csrc.double()[None],
                              cdst.double()[None]]).cpu().numpy()
            pars = host[:K].astype(np.int32)
            toks = host[K:2 * K].astype(np.int32)
            vals = host[2 * K:3 * K]
            alives = host[3 * K:4 * K] != 0
            pending = (host[4 * K].astype(np.int32),
                       host[4 * K + 1].astype(np.int32))
            self._replay_burst(state, pars, fresh)
            for k in range(K):
                if steps <= 0 or not alive.any():
                    break                  # overshoot steps are dropped
                beam_tokens = [beam_tokens[int(p)] + [int(tk)]
                               for p, tk in zip(pars[k], toks[k])]
                beam_scores = vals[k]
                if eos_token_id >= 0:
                    for i in range(W):
                        if (vals[k][i] > -1e29
                                and int(toks[k][i]) == eos_token_id):
                            finished.append(BeamHypothesis(
                                beam_tokens[i], float(vals[k][i])))
                alive = alives[k].copy()
                steps -= 1
        return beam_tokens, beam_scores, alive, pending, steps

    def _replay_burst(self, state: EngineState, pars: np.ndarray,
                      fresh: np.ndarray) -> None:
        """Replay a burst's page arithmetic on the allocator: at each step
        every row forks its parent's pages, and the page its next append
        writes becomes the step's fresh page on a page crossing or where
        the row is not its parent's first chooser, the device's rule bit
        for bit, so the host's block tables and refcounts match the
        device's. Unused fresh pages return to the pool."""
        alloc = self.allocator
        page = self.engine.cache.page_size
        pages = state.pages
        sl = int(state.seq_lens[0])
        K, W = pars.shape
        used = set()
        for k in range(K):
            sl += 1
            tidx = sl // page
            crossing = sl % page == 0
            newp = [alloc.fork(pages[int(p)]) for p in pars[k]]
            for ps in pages:
                for pg in ps:
                    alloc.free(pg)
            seen: set = set()
            for w in range(W):
                p = int(pars[k][w])
                taken = p in seen
                seen.add(p)
                f = int(fresh[k][w])
                if crossing:
                    assert len(newp[w]) == tidx
                    newp[w].append(f)
                    used.add(f)
                elif taken:
                    alloc.free(newp[w][tidx])
                    newp[w][tidx] = f
                    used.add(f)
            pages = newp
        for f in fresh.reshape(-1).tolist():
            if int(f) not in used:
                alloc.free(int(f))
        state.pages = pages
        state.seq_lens = np.full((W,), sl, np.int32)
        state.block_tables = self.engine._block_tables(pages)

    def _search_steps(self, state: EngineState, beam_tokens, beam_scores,
                      alive, pending, finished, eos_token_id: int,
                      steps: int):
        """Per-step beam expansion: one fused device step each (the
        pending copies, the forward and a flat top-``2W``; ``3 x 2W``
        values come back), then the host keeps the first ``W`` candidates
        of live parents."""
        eng, W = self.engine, self.W
        t = eng._t
        for _ in range(steps):
            if not alive.any():
                break
            toks = np.asarray([bt[-1] for bt in beam_tokens], np.int32)
            for b in range(W):
                eng._alloc_pages(state, b, int(state.seq_lens[b]) + 1)
            state.block_tables = eng._block_tables(state.pages)
            p2, t2, v2, state.kv = self._beam_step(
                eng.params, t(toks), state.kv, t(state.block_tables),
                t(state.seq_lens), t(beam_scores, torch.float32),
                t(alive, torch.bool), t(pending[0]), t(pending[1]))
            state.seq_lens += 1
            host = torch.stack([p2.double(), t2.double(),
                                v2.double()]).cpu().numpy()
            parents, tokens, scores = [], [], []
            for p, tk, s in zip(host[0].astype(np.int64),
                                host[1].astype(np.int64), host[2]):
                if not alive[p] or s < -1e29:
                    continue
                parents.append(int(p))
                tokens.append(int(tk))
                scores.append(float(s))
                if len(parents) == W:
                    break
            beam_tokens = [beam_tokens[p] + [tk]
                           for p, tk in zip(parents, tokens)]
            beam_scores = np.asarray(scores, np.float64)
            pending = self._fork_rows(state, np.asarray(parents, np.int32))
            state.last_tokens = np.asarray(tokens, np.int32)
            alive = np.ones((W,), bool)
            if eos_token_id >= 0:
                for i, tk in enumerate(tokens):
                    if tk == eos_token_id:
                        finished.append(BeamHypothesis(
                            beam_tokens[i], float(beam_scores[i])))
                        alive[i] = False
        return beam_tokens, beam_scores, alive


def _log_softmax(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float64)
    m = x.max()
    e = np.exp(x - m)
    return x - m - math.log(e.sum())
