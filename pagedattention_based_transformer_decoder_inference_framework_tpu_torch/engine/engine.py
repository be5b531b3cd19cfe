"""Inference engine: chunked prefill + decode steps over the paged KV
pool, streaming and static-batch generation, the whole-batch fused
generation loop and its speculative (prompt-lookup) form.

The JAX package's ``engine/engine.py`` for one device. PyTorch runs
eagerly, so what JAX compiles into one program per step (or, for
:meth:`Engine.generate_batch_fused` and
:meth:`Engine.generate_batch_spec`, one program per request batch) is a
Python loop here with the same semantics; the pool is updated in place.
Sampling stays on the device; the fused loop reads tokens back to the
host once, at its end, and the speculative loop one flag per iteration.

The scheduler's device steps (``scheduler/scheduler.py``) are methods
under the JAX engine's names, so that a test can shadow one on an
instance (fault injection): ``_prefill_fn`` (one chunk),
``_prefill_sample_fn`` (a chunk and its first tokens),
``_scatter_tokens_fn`` / ``_scatter_hist_fn`` (merging those tokens into
the burst's inputs on the device), ``_decode_loop_fn`` (the decode burst)
and ``_decode_spec_loop_fn`` (the speculative burst). None reads the
device from the host: a burst is ``num_steps`` forwards issued back to
back with one fetch after it, by the caller.

Beam search (``engine/beam.py``) and the reranker read
:meth:`Engine.decode_forced`, :meth:`Engine.decode_scored` (B1's per-page
score export), :meth:`Engine.score_candidates_nll`, ``prefill``'s
private ``allocator`` and ``EngineState.prefill_logits``, and the beam
steps :meth:`Engine._decode_beam` (one expansion) and
:meth:`Engine._decode_beam_burst` (``num_steps`` expansions with the
block tables rewired on the device, no host read).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..config import FrameworkConfig
from ..kvcache import pool as kv_pool
from ..kvcache.native import make_allocator
from ..models.chained import build_decode_chains, chains_supported
from ..models.model import (DecoderModel, Params, fuse_projections,
                            init_params, init_params_quantized,
                            quantize_params, quantize_params_int4,
                            unstack_layers)
from ..utils.common import cdiv
from ..utils.platform import resolve_device
from .paged_backend import PagedKVBackend
from .sampling import (SamplingParams, bump_counts, fold_key, hit_stop,
                       prepare_logits, request_key, sample, token_counts)
from .spec import (accept_counts, draft_ngram, gather_rows,
                   stochastic_accept, write_rows)


@dataclasses.dataclass
class EngineState:
    """Host + device state of a running batch of sequences."""

    kv: tuple                       # device page pool (updated in place)
    block_tables: np.ndarray        # [B, max_pages] int32 (host mirror)
    seq_lens: np.ndarray            # [B] int32 — tokens written so far
    pages: List[List[int]]          # per-sequence page ids (host)
    generator: torch.Generator
    last_tokens: np.ndarray         # [B] int32 — last sampled token
    finished: np.ndarray            # [B] bool
    #: [B, V] int32 penalty histogram, or a [B, 1] dummy without penalties
    counts: Optional[torch.Tensor] = None
    #: [B, V] f32 logits at each prompt's last token (host)
    prefill_logits: Optional[np.ndarray] = None
    #: the allocator owning this state's page ids; None = the engine's
    #: own. A private allocator gives a state (a beam search, a scorer) its
    #: own page-id space over its own pool, so it can run beside the
    #: scheduler with no shared host bookkeeping. One device, so one
    #: allocator (data-parallel shards, each with its own: ROADMAP queue
    #: A, item 7)
    allocator: Optional[object] = None

    @property
    def batch(self) -> int:
        return len(self.pages)


class Engine:
    """Construct from config, load (or randomly init) weights, generate.

    ``device``: where the engine runs; ``None`` means ``cuda``, and
    raises if there is none. ``params``: the model's params (stacked or
    unrolled; see ``models/model.py``), else a random init from
    ``seed``. Under ``cfg.quant`` (``int8`` w8a8, ``int8-weight``,
    ``int4``) the matmul weights are INT8-quantized (a random init
    straight into INT8, one layer at a time), unstacked and fused, and
    for ``int4`` then repacked to group-wise INT4 (MoE experts stay
    INT8), as the JAX engine builds them on one device. ``runtime.megakernel`` packs each layer's
    decode chain (``models/chained.py``; B14 at decode) and
    ``runtime.megakernel_drop_weights`` drops the per-op copies (B15 for
    every multi-token forward); INT4 has no chain variant and raises."""

    def __init__(self, config: FrameworkConfig,
                 params: Optional[Params] = None, device=None, seed: int = 0):
        self.config = config
        self.cfg = config.model
        self.cache = config.cache
        self.runtime = config.runtime
        self.device = resolve_device(device)
        quant = self.cfg.quant
        if quant == "int4" and self.runtime.scan_layers:
            raise ValueError("int4 repacking needs unrolled layers "
                             "(scan_layers=False)")
        if quant == "int4" and self.runtime.megakernel:
            raise ValueError("int4 has no chain-megakernel variant")
        rope_len = (None if self.cfg.sliding_window > 0 else
                    self.cache.max_pages_per_seq * self.cache.page_size)
        self.model = DecoderModel(self.cfg, rope_len=rope_len)
        self.backend = PagedKVBackend(self.cfg, self.cache)
        # one device, so one allocator (data-parallel shards, each with
        # its own: ROADMAP queue A, item 7)
        self.allocator = make_allocator(self.cache.num_pages,
                                        native=self.cache.native_allocator)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            init = init_params if quant == "none" else init_params_quantized
            params = init(self.cfg, gen, self.device,
                          unrolled=not self.runtime.scan_layers)
        self.params = _to_device(params, self.device)
        # the engine's tree holds its own dicts (``_to_device`` builds
        # them, and fusing rewrites them in place): with the caller's
        # tree dropped here, each layer's unfused weights are freed as
        # its fused ones are built
        del params
        if quant != "none":
            self.params = quantize_params(self.params)  # no-op if already
        if not self.runtime.scan_layers:
            self.params = unstack_layers(self.params)
            if self.runtime.fuse_projections:
                self.params = fuse_projections(self.params)
        if quant == "int4":
            self.params = quantize_params_int4(self.params)
        if (self.runtime.megakernel and "chains" not in self.params
                and chains_supported(self.cfg, self.params)):
            # params that hold "chains" already are taken as they are;
            # an unsupported config (MoE, Gemma norms, stacked layers)
            # runs the per-op path, as in the JAX engine
            self.params = build_decode_chains(
                self.params, self.cfg,
                drop=self.runtime.megakernel_drop_weights)

    # -- helpers ----------------------------------------------------------

    def _t(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _allocator_of(self, allocator):
        """The allocator of a state or call: ``allocator``, else the
        engine's own."""
        return self.allocator if allocator is None else allocator

    def _alloc_pages(self, state: EngineState, b: int, new_len: int) -> None:
        need = cdiv(new_len, self.cache.page_size) - len(state.pages[b])
        if need > 0:
            state.pages[b].extend(
                self._allocator_of(state.allocator).alloc_many(need))

    def _block_tables(self, pages: List[List[int]]) -> np.ndarray:
        bt = np.zeros((len(pages), self.cache.max_pages_per_seq), np.int32)
        for b, ps in enumerate(pages):
            bt[b, :len(ps)] = ps
        return bt

    def _default_sampling(self) -> SamplingParams:
        r = self.runtime
        return SamplingParams(
            temperature=r.temperature, top_k=r.top_k, top_p=r.top_p,
            min_p=r.min_p, repetition_penalty=r.repetition_penalty,
            presence_penalty=r.presence_penalty,
            frequency_penalty=r.frequency_penalty,
            eos_token_id=self.config.eos_token_id,
            eos_threshold=r.eos_threshold)

    def _mark_finished(self, state: EngineState, toks: np.ndarray,
                       sampling: Optional[SamplingParams]) -> None:
        sp = sampling or self._default_sampling()
        if sp.eos_token_id >= 0:
            state.finished |= toks == sp.eos_token_id
        if sp.stop_token_ids:
            state.finished |= np.isin(
                toks, np.asarray(sp.stop_token_ids, np.int32))

    def _prompt_tokens(self, prompts, max_len: int) -> np.ndarray:
        tokens = np.zeros((len(prompts), max_len), np.int32)
        for b, p in enumerate(prompts):
            tokens[b, :len(p)] = np.asarray(p, np.int32)
        return tokens

    def _prefill_chunks(self, kv, tokens: np.ndarray, lens: np.ndarray,
                        bt: torch.Tensor, chunk: int) -> torch.Tensor:
        """Run the prompt through the model in page-aligned chunks
        (padding positions are -1); return each sequence's logits at
        its last prompt token, ``[B, V]`` f32."""
        B, max_len = tokens.shape
        final = torch.zeros((B, self.cfg.vocab_size), dtype=torch.float32,
                            device=self.device)
        for c0 in range(0, max_len, chunk):
            c1 = min(c0 + chunk, max_len)
            T = c1 - c0
            pos = c0 + np.broadcast_to(np.arange(T), (B, T))
            pos = np.where(pos < lens[:, None], pos, -1)
            attn = self.backend.make_attn_fn(
                bt, self._t(np.clip(lens, 0, c1)),
                self._t(np.full((B,), c0)))
            logits, kv = self.model.forward(
                self.params, self._t(tokens[:, c0:c1], torch.long),
                self._t(pos, torch.long), kv, attn)
            idx = lens - 1 - c0
            inside = (idx >= 0) & (idx < T)
            if inside.any():
                rows = np.nonzero(inside)[0]
                final[rows] = logits[self._t(rows, torch.long),
                                     self._t(idx[rows], torch.long)]
        return final

    def _chunk(self, max_len: int) -> int:
        page = self.cache.page_size
        return min(cdiv(max(self.runtime.prefill_chunk, 1), page) * page,
                   max_len)

    def _init_cache(self):
        """A fresh zeroed page pool on the engine's device."""
        return self.backend.init_cache(self.device)

    # -- the scheduler's device steps --------------------------------------

    def _chunk_logits(self, params, tokens, positions, kv, block_tables,
                      seq_lens, q_offsets, prompt_lens):
        """One prefill chunk at the given positions (``-1``: padding),
        block tables and ``q_offsets``. Returns each row's f32 logits at
        its last prompt token where that falls inside the chunk (else
        zeros), the ``inside`` flags, and the pool."""
        attn = self.backend.make_attn_fn(block_tables, seq_lens, q_offsets)
        logits, kv = self.model.forward(params, tokens.long(),
                                        positions.long(), kv, attn)
        B, T, _ = logits.shape
        idx = prompt_lens - 1 - q_offsets
        inside = (idx >= 0) & (idx < T)
        safe = idx.clamp(0, T - 1).long()
        last = logits[torch.arange(B, device=logits.device), safe,
                      :self.cfg.vocab_size].float()
        return torch.where(inside[:, None], last, 0.0), inside, kv

    @torch.inference_mode()
    def _prefill_fn(self, params, tokens, positions, kv, block_tables,
                    seq_lens, q_offsets, prompt_lens):
        """One prefill chunk; ``(logits [B, V], kv)`` with each row's
        logits at its final prompt token if that falls inside this chunk,
        else zeros."""
        final, _, kv = self._chunk_logits(
            params, tokens, positions, kv, block_tables, seq_lens,
            q_offsets, prompt_lens)
        return final, kv

    @torch.inference_mode()
    def _prefill_sample_fn(self, params, tokens, positions, kv,
                           block_tables, seq_lens, q_offsets, prompt_lens,
                           sample_mask, seeds, samp, counts, *, mode):
        """A prefill chunk and its first-token draws: row ``i`` draws with
        ``request_key(seeds[i], 0)`` where ``sample_mask`` is set and its
        last prompt token is inside the chunk; other rows give ``-1``.
        Returns ``(first [n] int32, kv)``."""
        final, inside, kv = self._chunk_logits(
            params, tokens, positions, kv, block_tables, seq_lens,
            q_offsets, prompt_lens)
        keys = None if mode.greedy else request_key(
            seeds, torch.zeros_like(seeds))
        tok = sample(final, None, row_keys=keys, mode=mode,
                     counts=counts if mode.use_penalties else None, **samp)
        return torch.where(sample_mask & inside, tok, -1), kv

    @torch.inference_mode()
    def _scatter_tokens_fn(self, dec_tokens, first, rows, counts, *,
                           bump: bool):
        """The gang's first tokens ``first [n]`` into the burst's seed
        tokens at ``rows [n]`` (a row >= B is dropped); with ``bump`` also
        counted into the penalty histogram rows. A new seed vector and
        histogram; no host read."""
        B = dec_tokens.shape[0]
        r = rows.long().clamp(0, B)                # row B: the dropped one
        out = torch.cat([dec_tokens, dec_tokens.new_zeros(1)])
        out = out.index_copy(0, r, first.to(out.dtype))[:B]
        if bump:
            pad = torch.cat([counts, counts.new_zeros(1, counts.shape[1])])
            pad.index_put_((r, first.clamp_min(0).long()),
                           (first >= 0).to(pad.dtype), accumulate=True)
            counts = pad[:B]
        return out, counts

    @torch.inference_mode()
    def _scatter_hist_fn(self, hist, cur, first, rows):
        """The spec burst's form of :meth:`_scatter_tokens_fn`: the first
        tokens into the history at each row's pending slot ``cur[row] -
        1`` (a row >= B is dropped)."""
        B = cur.shape[0]
        r = rows.long().clamp(0, B)
        pos = (cur.long() - 1).gather(0, r.clamp(max=B - 1))
        pad = torch.cat([hist, hist.new_zeros(1, hist.shape[1])])
        pad.index_put_((r, pos), first.to(pad.dtype))
        return pad[:B]

    @torch.inference_mode()
    def _decode_loop_fn(self, params, tokens, kv, block_tables, seq_lens,
                        emitted, budgets, seeds, samp, counts, *,
                        num_steps: int, mode):
        """The scheduler's decode burst: ``num_steps`` T=1 forwards issued
        back to back on the device, with no host read.

        ``emitted [B]``: tokens each lane has generated (the prefill's
        first counts); ``budgets [B]``: each lane's ``max_new_tokens``. A
        lane freezes on the device once ``emitted >= budget``, or at its
        EOS or a stop id: it stops advancing ``seq_lens`` (its write lands
        one slot past its live content, or on the dump page) and emits
        ``max(eos, 0)``, which the host discards. Idle lanes enter with
        ``budget = 0``. ``seeds [B]``: token ``i`` of a request draws with
        ``request_key(seed, i)``. Pages for every step must be in
        ``block_tables``. ``counts`` (the ``[B, V]`` penalty histogram, or
        a ``[B, 1]`` dummy) is threaded through. Returns ``(tokens [B,
        num_steps], kv, counts)``."""
        V = self.cfg.vocab_size
        eos = samp["eos_token_id"]
        stops = samp.get("stop_ids")
        finished = emitted >= budgets
        out = []
        for _ in range(num_steps):
            attn = self.backend.make_attn_fn(block_tables, seq_lens + 1,
                                             seq_lens)
            logits, kv = self.model.forward(
                params, tokens.long()[:, None], seq_lens.long()[:, None],
                kv, attn)
            keys = None if mode.greedy else request_key(seeds, emitted)
            nxt = sample(logits[:, 0, :V], None, row_keys=keys, mode=mode,
                         counts=counts if mode.use_penalties else None,
                         **samp)
            nxt = torch.where(finished, eos.clamp_min(0), nxt)
            live = (~finished).to(torch.int32)
            if mode.use_penalties:
                bump_counts(counts, nxt, live)
            emitted = emitted + live
            finished = (finished | hit_stop(nxt, eos, stops)
                        | (emitted >= budgets))
            seq_lens = seq_lens + live
            out.append(nxt)
            tokens = nxt
        return torch.stack(out, dim=1), kv, counts

    @torch.inference_mode()
    def _decode_spec_loop_fn(self, params, hist, kv, block_tables, cur,
                             emitted, budgets, seeds, kv_limits, samp, *,
                             num_iters: int, spec_k: int, ngram: int, mode,
                             stochastic: bool = False):
        """The scheduler's speculative burst: ``num_iters`` draft ->
        verify forwards over the fixed lanes, no host read. Greedy lanes
        accept drafts (up to ``spec_k + 1`` tokens an iteration,
        greedy-exact); sampled lanes draw one token an iteration with
        ``request_key(seed, emitted)``, as the plain burst does, or with
        ``stochastic`` accept drafts by :func:`~.spec.stochastic_accept` on
        keys folded from the same. Lanes freeze at EOS or their budget
        (idle lanes enter with ``budgets == 0``). ``hist [B, M]`` holds
        each lane's tokens (``hist[b, :cur[b]]``, the last one's KV not
        yet written); ``kv_limits [B]`` bounds KV writes to each request's
        page budget (slots past it go to the dump page). Returns ``(hist,
        cur, emitted, kv)``."""
        V = self.cfg.vocab_size
        K = spec_k
        eos = samp["eos_token_id"]
        idxs = torch.arange(K + 1, dtype=torch.int32, device=hist.device)
        B = hist.shape[0]
        samp_rep = {k: v.repeat_interleave(K + 1, dim=0)
                    for k, v in samp.items()}
        greedy_lane = samp["temperature"] <= 0.0
        finished = emitted >= budgets
        for _ in range(num_iters):
            drafts = draft_ngram(hist, cur, k=K, n=ngram)
            inp = torch.cat([gather_rows(hist, cur - 1, 1), drafts], dim=1)
            pos = (cur - 1)[:, None] + idxs[None, :]
            pos = torch.where(finished[:, None], -1, pos)
            pos = torch.where(pos < kv_limits[:, None], pos, -1)
            attn = self.backend.make_attn_fn(block_tables, cur + K, cur - 1)
            logits, kv = self.model.forward(params, inp.long(), pos.long(),
                                            kv, attn)
            flat = logits[..., :V].reshape(B * (K + 1), V)
            base = request_key(seeds[:, None].expand(B, K + 1),
                               emitted[:, None] + idxs[None, :])
            y = sample(flat, None,
                       row_keys=None if mode.greedy else base.reshape(-1),
                       mode=mode, **samp_rep).reshape(B, K + 1)
            a = torch.where(greedy_lane, accept_counts(drafts, y[:, :K]), 0)
            if stochastic and not mode.greedy:
                _, scaled = prepare_logits(flat, mode=mode, **samp_rep)
                a_s, fix = stochastic_accept(
                    scaled.reshape(B, K + 1, V), drafts,
                    keys_u=fold_key(base[:, :K], 1),
                    keys_re=fold_key(base, 2))
                y_s = torch.where(
                    idxs[None, :] < a_s[:, None],
                    torch.cat([drafts, drafts[:, -1:]], dim=1).to(y.dtype),
                    fix[:, None].to(y.dtype))
                a = torch.where(greedy_lane, a, a_s)
                y = torch.where(greedy_lane[:, None], y, y_s)
            ok = idxs[None, :] <= a[:, None]
            ok &= (emitted[:, None] + idxs[None, :]) < budgets[:, None]
            iseos = (eos[:, None] >= 0) & (y == eos[:, None])
            eos_i = iseos.to(torch.int32)
            ok &= ~((torch.cumsum(eos_i, dim=1) - eos_i) > 0)
            ok &= ~finished[:, None]
            cnt = ok.sum(dim=1, dtype=torch.int32)
            hist = write_rows(hist, cur, y)
            emitted = emitted + cnt
            finished = (finished | (emitted >= budgets)
                        | (iseos & ok).any(dim=1))
            cur = cur + cnt
        return hist, cur, emitted, kv

    # -- steps ------------------------------------------------------------

    @torch.inference_mode()
    def prefill(self, prompts: Sequence[Sequence[int]],
                seed: Optional[int] = None,
                sampling: Optional[SamplingParams] = None,
                allocator=None) -> EngineState:
        """Chunked prefill of a batch of prompts; samples the first
        generated token. ``allocator`` gives the returned state a private
        page-id space (:class:`EngineState`)."""
        B = len(prompts)
        lens = np.array([len(p) for p in prompts], np.int32)
        if lens.min() < 1:
            raise ValueError("every prompt needs at least one token")
        alloc = self._allocator_of(allocator)
        page = self.cache.page_size
        max_len = cdiv(int(lens.max()), page) * page
        pages = [alloc.alloc_many(cdiv(int(L), page)) for L in lens]
        bt_np = self._block_tables(pages)
        kv = self.backend.init_cache(self.device)
        tokens = self._prompt_tokens(prompts, max_len)
        final = self._prefill_chunks(kv, tokens, lens, self._t(bt_np),
                                     self._chunk(max_len))

        gen = torch.Generator(device=self.device).manual_seed(
            self.runtime.seed if seed is None else seed)
        sp = sampling or self._default_sampling()
        mode = sp.mode()
        if mode.use_penalties:
            counts = token_counts(self._t(tokens), self._t(lens),
                                  self.cfg.vocab_size)
        else:
            counts = torch.zeros((B, 1), dtype=torch.int32,
                                 device=self.device)
        first = sample(final, gen, mode=mode,
                       counts=counts if mode.use_penalties else None,
                       **sp.as_arrays(B, self.device))
        if mode.use_penalties:
            bump_counts(counts, first, torch.ones_like(first))
        first_np = first.cpu().numpy()
        state = EngineState(
            kv=kv, block_tables=bt_np, seq_lens=lens.copy(), pages=pages,
            generator=gen, last_tokens=first_np,
            finished=np.zeros((B,), bool), counts=counts,
            prefill_logits=final.cpu().numpy(), allocator=allocator)
        self._mark_finished(state, first_np, sampling)
        return state

    def _step_logits(self, state: EngineState, tokens: np.ndarray,
                     score_sink: Optional[list] = None) -> torch.Tensor:
        """Feed one token per sequence; return next-token logits
        ``[B, V]`` (device) and advance the state. ``score_sink``: see
        ``PagedKVBackend.make_attn_fn``."""
        B = state.batch
        for b in range(B):
            self._alloc_pages(state, b, int(state.seq_lens[b]) + 1)
        state.block_tables = self._block_tables(state.pages)
        sl = self._t(state.seq_lens)
        attn = self.backend.make_attn_fn(self._t(state.block_tables),
                                         sl + 1, sl, score_sink=score_sink)
        logits, state.kv = self.model.forward(
            self.params, self._t(tokens, torch.long)[:, None],
            sl.long()[:, None], state.kv, attn)
        state.seq_lens += 1
        state.last_tokens = np.asarray(tokens, np.int32)
        return logits[:, 0]

    @torch.inference_mode()
    def decode_forced(self, state: EngineState,
                      tokens: np.ndarray) -> np.ndarray:
        """Teacher-forced decode step: feed ``tokens [B]``, return the
        next-token logits ``[B, V]`` (f32, host). Advances the state."""
        logits = self._step_logits(state, tokens)
        return logits[:, :self.cfg.vocab_size].float().cpu().numpy()

    @torch.inference_mode()
    def decode_scored(self, state: EngineState, tokens: np.ndarray):
        """Teacher-forced decode step that also returns B1's per-page
        score export: ``(logits [B, V], scores [L, B, max_pages])`` on the
        host, ``scores[l, b, p]`` the largest masked, scaled QK logit of
        page ``p`` at layer ``l`` over every head (``-1e30`` for a dead
        page). Every layer's attention takes B1 (T=1 included), with the
        export riding its pass; the state advances as under
        :meth:`decode_forced`."""
        if self.runtime.scan_layers:
            raise ValueError("score export needs the unrolled layer loop "
                             "(scan_layers=False)")
        sink: list = []
        logits = self._step_logits(state, tokens, score_sink=sink)
        return (logits[:, :self.cfg.vocab_size].float().cpu().numpy(),
                torch.stack(sink).cpu().numpy())

    @torch.inference_mode()
    def _decode_beam(self, params, tokens, kv, block_tables, seq_lens,
                     beam_scores, alive, copies_src, copies_dst):
        """The fused beam-expansion step: runs the previous selection's
        copy-on-write page copies (``copy_pages_tree``; dump-page
        self-copies pad them), one forward of a token a beam row
        (``tokens [W]``), the f32 log-softmax with dead rows at ``-inf``,
        and a flat top-``2W`` of the cumulative scores (``beam_scores [W]``
        f32 plus the log-probs, over ``[W, V]``; :func:`top_k`:
        ``lax.top_k``'s order, ties by index). Returns ``(parents, tokens,
        scores, kv)`` of the ``2W`` candidates, on the device."""
        V = self.cfg.vocab_size
        kv = kv_pool.copy_pages_tree(kv, copies_src, copies_dst)
        attn = self.backend.make_attn_fn(block_tables, seq_lens + 1,
                                         seq_lens)
        logits, kv = self.model.forward(
            params, tokens.long()[:, None], seq_lens.long()[:, None], kv,
            attn)
        lp = torch.log_softmax(logits[:, 0, :V].float(), dim=-1)
        lp = torch.where(alive[:, None], lp, -torch.inf)
        vals, idx = top_k((beam_scores[:, None] + lp).reshape(-1),
                          2 * tokens.shape[0])
        return idx // V, idx % V, vals, kv

    @torch.inference_mode()
    def _decode_beam_burst(self, params, tokens, kv, bt, seq_lens, scores,
                           alive, csrc, cdst, fresh, eos, *,
                           num_steps: int):
        """``num_steps`` beam expansions on the device, from ``tokens
        [W]``, tables ``bt [W, mp]``, ``seq_lens [W]``, ``scores [W]``,
        ``alive [W]``, the pending copies ``csrc, cdst [W]`` and the
        host-allocated ``fresh [num_steps, W]`` pages. Each step applies
        the pending copy-on-write copies, forwards one token a row, takes
        the top ``W`` (parent, token) pairs by cumulative log-probability,
        and rewires the block tables: each row takes its parent's table,
        and the page the next append writes becomes the step's fresh page
        ``fresh[k, w]`` where the rows cross into a new page or the row is
        not its parent's first chooser (then the old tail's data copy rides
        the next step's copies). Nothing is read back to the host inside:
        no ``.item()``, no Python branch on a device value; the host
        replays the same page arithmetic afterwards
        (``BeamSearcher._replay_burst``). Returns the per-step ``(parents,
        tokens, scores, alive)`` traces ``[num_steps, W]``, the last step's
        ``(tokens, scores, csrc, cdst)`` and the pool."""
        V = self.cfg.vocab_size
        page = self.cache.page_size
        W = tokens.shape[0]
        earlier = torch.tril(torch.ones((W, W), dtype=torch.bool,
                                        device=tokens.device), diagonal=-1)
        sl = seq_lens
        traces = []
        for k in range(num_steps):
            kv = kv_pool.copy_pages_tree(kv, csrc, cdst)
            attn = self.backend.make_attn_fn(bt, sl + 1, sl)
            logits, kv = self.model.forward(
                params, tokens.long()[:, None], sl.long()[:, None], kv, attn)
            lp = torch.log_softmax(logits[:, 0, :V].float(), dim=-1)
            lp = torch.where(alive[:, None], lp, -torch.inf)
            vals, idx = top_k((scores[:, None] + lp).reshape(-1), W)
            par = (idx // V).to(torch.int32)
            tok = (idx % V).to(torch.int32)
            new_bt = bt[par.long()]
            sl = sl + 1
            # the table column of the next append, as a [W, 1] index (beam
            # rows are uniform; a 0-d index tensor would be read back to
            # the host)
            tidx = (sl[:1] // page).long().expand(W)[:, None]
            crossing = (sl[:1] % page) == 0
            taken = ((par[:, None] == par[None, :]) & earlier).any(dim=1)
            old_tail = new_bt.gather(1, tidx)[:, 0]
            new_bt.scatter_(1, tidx, torch.where(
                crossing | taken, fresh[k], old_tail)[:, None])
            # a data copy only for copy-on-write: a crossed page starts
            # empty
            cow = taken & ~crossing
            csrc = torch.where(cow, old_tail, 0)
            cdst = torch.where(cow, fresh[k], 0)
            alive = (vals > -1e29) & ~((eos >= 0) & (tok == eos))
            traces.append((par, tok, vals, alive))
            tokens, bt, scores = tok, new_bt, vals
        pars, toks, vals, alives = (torch.stack(t) for t in zip(*traces))
        return pars, toks, vals, alives, tokens, scores, csrc, cdst, kv

    @torch.inference_mode()
    def decode(self, state: EngineState,
               sampling: Optional[SamplingParams] = None) -> np.ndarray:
        """Advance every sequence one token; returns the sampled ``[B]``."""
        B = state.batch
        sp = sampling or self._default_sampling()
        mode = sp.mode()
        if state.counts is None or (mode.use_penalties
                                    and state.counts.shape[1] == 1):
            state.counts = torch.zeros(
                (B, self.cfg.vocab_size if mode.use_penalties else 1),
                dtype=torch.int32, device=self.device)
        logits = self._step_logits(state, state.last_tokens)
        nxt = sample(logits, state.generator, mode=mode,
                     counts=state.counts if mode.use_penalties else None,
                     **sp.as_arrays(B, self.device))
        if mode.use_penalties:
            bump_counts(state.counts, nxt, torch.ones_like(nxt))
        toks = nxt.cpu().numpy()
        state.last_tokens = toks
        self._mark_finished(state, toks, sampling)
        return toks

    def _nll_chunks(self, kv, bt: torch.Tensor, tokens: np.ndarray,
                    lens: np.ndarray, first: np.ndarray, c_from: int,
                    chunk: int):
        """The teacher-forced NLL of ``tokens[b, t + 1]`` at every
        position ``t`` with ``first[b] <= t + 1 < lens[b]``, over the
        page-aligned chunks from ``c_from`` on: ``(sums [B] f64, counts
        [B])``. Only one chunk of logits exists at a time, each reduced on
        the device to a per-sequence sum."""
        B, max_len = tokens.shape
        # targets[t] = token t + 1 (the last column is masked off)
        targets = np.zeros_like(tokens)
        targets[:, :-1] = tokens[:, 1:]
        nll_sum = np.zeros((B,), np.float64)
        cnt = np.zeros((B,), np.int64)
        for c0 in range(c_from, max_len, chunk):
            c1 = min(c0 + chunk, max_len)
            pos = c0 + np.broadcast_to(np.arange(c1 - c0), (B, c1 - c0))
            valid = ((pos + 1 < lens[:, None])
                     & (pos + 1 >= first[:, None]))
            attn = self.backend.make_attn_fn(
                bt, self._t(np.clip(lens, 0, c1)),
                self._t(np.full((B,), c0)))
            logits, kv = self.model.forward(
                self.params, self._t(tokens[:, c0:c1], torch.long),
                self._t(np.where(pos < lens[:, None], pos, -1),
                        torch.long), kv, attn)
            logp = torch.log_softmax(
                logits[..., :self.cfg.vocab_size].float(), dim=-1)
            nll = -logp.gather(-1, self._t(targets[:, c0:c1],
                                           torch.long)[..., None])[..., 0]
            nll = torch.where(self._t(valid, torch.bool), nll, 0.0)
            nll_sum += nll.sum(dim=1).cpu().numpy().astype(np.float64)
            cnt += valid.sum(axis=1)
        return nll_sum, cnt

    @torch.inference_mode()
    def score_nll(self, prompts: Sequence[Sequence[int]],
                  starts: Optional[Sequence[int]] = None,
                  mean: bool = True,
                  allocator=None) -> np.ndarray:
        """Per-sequence NLL of ``tokens[start:]`` given their prefixes,
        teacher-forced through the paged chunked-prefill path (``starts``
        defaults to 1, every target); ``mean=False`` gives the sum. Only
        one page-aligned chunk of logits exists at a time, each reduced
        on the device to a per-sequence sum; pages (from ``allocator``, else
        the engine's) are freed on return."""
        B = len(prompts)
        lens = np.array([len(p) for p in prompts], np.int32)
        start_arr = (np.ones((B,), np.int32) if starts is None
                     else np.asarray(list(starts), np.int32))
        if lens.min() < 2:
            raise ValueError("scoring needs at least 2 tokens per sequence")
        if not ((start_arr >= 1).all() and (start_arr < lens).all()):
            raise ValueError("starts must leave at least one target per "
                             "sequence")
        alloc = self._allocator_of(allocator)
        page = self.cache.page_size
        max_len = cdiv(int(lens.max()), page) * page
        pages = [alloc.alloc_many(cdiv(int(L), page)) for L in lens]
        try:
            nll_sum, cnt = self._nll_chunks(
                self.backend.init_cache(self.device),
                self._t(self._block_tables(pages)),
                self._prompt_tokens(prompts, max_len), lens, start_arr, 0,
                self._chunk(max_len))
        finally:
            for ps in pages:
                for p in ps:
                    alloc.free(p)
        if not mean:
            return nll_sum
        return nll_sum / np.maximum(cnt, 1)

    @torch.inference_mode()
    def score_candidates_nll(self, context_ids: Sequence[int],
                             candidates: Sequence[Sequence[int]],
                             mean: bool = True,
                             allocator=None) -> np.ndarray:
        """NLL of each candidate continuation given ONE shared context.
        The context is prefilled once (batch 1); the candidate rows share
        its pages below the last chunk boundary before its end by refcount
        (``PageAllocator.fork``) and re-run from that chunk into pages of
        their own, which hold the context's tail and the candidate. Every
        page taken is freed on every exit path. ``mean=False`` gives the
        sums (the candidates' log-probabilities, negated)."""
        alloc = self._allocator_of(allocator)
        W, L = len(candidates), len(context_ids)
        if L < 1 or W < 1 or any(len(c) < 1 for c in candidates):
            raise ValueError("a context and candidates of at least one "
                             "token each")
        page = self.cache.page_size
        chunk = cdiv(max(self.runtime.prefill_chunk, 1), page) * page
        lens = np.array([L + len(c) for c in candidates], np.int32)
        max_len = cdiv(int(lens.max()), page) * page
        if cdiv(int(lens.max()), page) > self.cache.max_pages_per_seq:
            raise ValueError("context + candidate exceed max_pages_per_seq")
        state = self.prefill([list(context_ids)], allocator=alloc)
        ctx_pages = state.pages[0]
        c0 = ((L - 1) // chunk) * chunk    # the first chunk scored again
        n_shared = c0 // page              # pages wholly below it
        rows_pages: List[List[int]] = []
        try:
            for c in candidates:
                shared = alloc.fork(ctx_pages[:n_shared])
                try:
                    fresh = alloc.alloc_many(cdiv(L + len(c), page)
                                             - n_shared)
                except Exception:
                    for p in shared:
                        alloc.free(p)
                    raise
                rows_pages.append(shared + fresh)
        except Exception:
            for ps in rows_pages:
                for p in ps:
                    alloc.free(p)
            raise
        finally:
            for p in ctx_pages:            # the context row's references
                alloc.free(p)
        try:
            tokens = self._prompt_tokens(
                [list(context_ids) + list(c) for c in candidates], max_len)
            nll_sum, cnt = self._nll_chunks(
                state.kv, self._t(self._block_tables(rows_pages)), tokens,
                lens, np.full((W,), L), c0, chunk)
        finally:
            for ps in rows_pages:
                for p in ps:
                    alloc.free(p)
        if not mean:
            return nll_sum
        return nll_sum / np.maximum(cnt, 1)

    def free(self, state: EngineState) -> None:
        alloc = self._allocator_of(state.allocator)
        for ps in state.pages:
            for p in ps:
                alloc.free(p)
        state.pages = [[] for _ in state.pages]

    # -- user-facing generation -------------------------------------------

    def generate_stream(self, prompt: Sequence[int],
                        max_new_tokens: Optional[int] = None,
                        sampling: Optional[SamplingParams] = None,
                        seed: Optional[int] = None) -> Iterator[int]:
        """Token-at-a-time streaming generation for one sequence."""
        sampling = sampling or self._default_sampling()
        max_new = max_new_tokens or self.runtime.max_new_tokens
        state = self.prefill([prompt], seed=seed, sampling=sampling)
        try:
            yield int(state.last_tokens[0])
            for _ in range(max_new - 1):
                if state.finished[0]:
                    return
                yield int(self.decode(state, sampling)[0])
        finally:
            self.free(state)

    def generate(self, prompt: Sequence[int],
                 max_new_tokens: Optional[int] = None,
                 sampling: Optional[SamplingParams] = None,
                 seed: Optional[int] = None) -> List[int]:
        return list(self.generate_stream(prompt, max_new_tokens, sampling,
                                         seed=seed))

    @torch.inference_mode()
    def generate_batch_fused(self, prompts: Sequence[Sequence[int]],
                             max_new_tokens: Optional[int] = None,
                             sampling: Optional[SamplingParams] = None,
                             seed: Optional[int] = None) -> List[List[int]]:
        """The whole request batch as one loop with no host round trip:
        pool init, page-aligned chunked prefill, first-token sample, and
        ``max_new_tokens - 1`` decode steps in which a finished lane
        keeps stepping but emits ``max(eos, 0)``; pages are allocated up
        front for the whole horizon. Each row is cut after its EOS /
        stop token."""
        sampling = sampling or self._default_sampling()
        max_new = max_new_tokens or self.runtime.max_new_tokens
        B = len(prompts)
        lens = np.array([len(p) for p in prompts], np.int32)
        if lens.min() < 1:
            raise ValueError("every prompt needs at least one token")
        page = self.cache.page_size
        max_len = cdiv(int(lens.max()), page) * page
        pages = [self.allocator.alloc_many(cdiv(int(L) + max_new, page))
                 for L in lens]
        try:
            toks = self._fused(prompts, lens, pages, max_len, max_new,
                               sampling, seed)
        finally:
            for ps in pages:
                for p in ps:
                    self.allocator.free(p)
        outs: List[List[int]] = []
        stops = set(sampling.stop_token_ids)
        for b in range(B):
            row: List[int] = []
            for t in map(int, toks[b]):
                row.append(t)
                if (t == sampling.eos_token_id >= 0) or t in stops:
                    break
            outs.append(row)
        return outs

    def _fused(self, prompts, lens, pages, max_len, max_new, sampling,
               seed) -> np.ndarray:
        B = len(prompts)
        bt = self._t(self._block_tables(pages))
        kv = self.backend.init_cache(self.device)
        tokens = self._prompt_tokens(prompts, max_len)
        final = self._prefill_chunks(kv, tokens, lens, bt,
                                     self._chunk(max_len))
        gen = torch.Generator(device=self.device).manual_seed(
            self.runtime.seed if seed is None else seed)
        mode = sampling.mode()
        samp = sampling.as_arrays(B, self.device)
        eos = samp["eos_token_id"]
        if mode.use_penalties:
            counts = token_counts(self._t(tokens), self._t(lens),
                                  self.cfg.vocab_size)
        else:
            counts = None
        tok = sample(final, gen, mode=mode, counts=counts, **samp)
        if counts is not None:
            bump_counts(counts, tok, torch.ones_like(tok))
        finished = hit_stop(tok, eos, samp["stop_ids"])
        out = [tok]
        seq_lens = self._t(lens)
        for _ in range(max_new - 1):
            attn = self.backend.make_attn_fn(bt, seq_lens + 1, seq_lens)
            logits, kv = self.model.forward(
                self.params, tok.long()[:, None], seq_lens.long()[:, None],
                kv, attn)
            nxt = sample(logits[:, 0], gen, mode=mode, counts=counts, **samp)
            nxt = torch.where(finished, eos.clamp_min(0), nxt)
            if counts is not None:
                bump_counts(counts, nxt, (~finished).to(torch.int32))
            finished = finished | hit_stop(nxt, eos, samp["stop_ids"])
            out.append(nxt)
            tok = nxt
            seq_lens = seq_lens + 1
        return torch.stack(out, dim=1).cpu().numpy()

    @torch.inference_mode()
    def generate_batch_spec(self, prompts: Sequence[Sequence[int]],
                            max_new_tokens: Optional[int] = None,
                            sampling: Optional[SamplingParams] = None,
                            spec_k: Optional[int] = None,
                            ngram: Optional[int] = None) -> List[List[int]]:
        """Speculative (prompt-lookup) batch generation, greedy-exact:
        token for token :meth:`generate_batch_fused`'s greedy output, in
        fewer forwards whenever the text re-uses its own n-grams. Each
        iteration drafts ``spec_k`` tokens per sequence from its history
        (``engine/spec.py``), verifies them in one ``(spec_k + 1)``-token
        forward, and emits the accepted prefix plus the bonus token; the
        loop ends once every sequence has hit EOS or its budget. Pages
        cover ``prompt + max_new + spec_k`` tokens (the verify chunk
        writes up to ``spec_k`` past the budget) and are freed on
        return."""
        sampling = sampling or self._default_sampling()
        if not sampling.mode().greedy:
            raise ValueError("speculative decoding is greedy-exact only "
                             "(temperature=0)")
        if (sampling.has_penalties or sampling.stop_token_ids
                or sampling.logit_bias):
            raise ValueError(
                "speculative decoding does not support penalties, stop "
                "sets or logit bias (they change the greedy pick per "
                "emitted token); use generate_batch_fused")
        K = spec_k if spec_k is not None else (self.runtime.spec_k or 4)
        n = ngram if ngram is not None else self.runtime.spec_ngram
        if K < 1 or n < 1:
            raise ValueError("spec_k and ngram must be >= 1")
        max_new = max_new_tokens or self.runtime.max_new_tokens
        lens = np.array([len(p) for p in prompts], np.int32)
        if lens.min() < 1:
            raise ValueError("every prompt needs at least one token")
        page = self.cache.page_size
        prompt_pad = cdiv(int(lens.max()), page) * page
        horizon = [cdiv(int(L) + max_new + K, page) for L in lens]
        if max(horizon) > self.cache.max_pages_per_seq:
            raise ValueError(
                f"prompt+max_new+spec_k needs {max(horizon)} pages > "
                f"max_pages_per_seq={self.cache.max_pages_per_seq}")
        pages = [self.allocator.alloc_many(h) for h in horizon]
        try:
            buf, emitted = self._spec(prompts, lens, pages, prompt_pad,
                                      max_new, K, n, sampling)
        finally:
            for ps in pages:
                for p in ps:
                    self.allocator.free(p)
        return [buf[b, lens[b]:lens[b] + emitted[b]].tolist()
                for b in range(len(prompts))]

    def _spec(self, prompts, lens, pages, prompt_pad, max_new, K, n,
              sampling):
        """The draft -> verify loop of :meth:`generate_batch_spec`; JAX's
        ``while_loop`` as a Python loop whose condition reads one flag
        from the device. Returns the history ``[B, M]`` and the emitted
        counts ``[B]`` on the host."""
        B = len(prompts)
        V = self.cfg.vocab_size
        # every lane writes K+1 candidates at cur <= prompt + max_new, so
        # the history must not clamp that window
        M = prompt_pad + max_new + K + 1
        bt = self._t(self._block_tables(pages))
        kv = self.backend.init_cache(self.device)
        tokens = self._prompt_tokens(prompts, M)
        final = self._prefill_chunks(kv, tokens[:, :prompt_pad], lens, bt,
                                     self._chunk(prompt_pad))
        mode = sampling.mode()
        samp = sampling.as_arrays(B, self.device)
        eos = samp["eos_token_id"]
        first = sample(final, None, mode=mode, **samp)
        lens_t = self._t(lens)
        buf = write_rows(self._t(tokens), lens_t, first[:, None])
        cur = lens_t + 1                      # tokens in buf (incl. first)
        emitted = torch.ones_like(cur)
        finished = hit_stop(first, eos, None) | (emitted >= max_new)
        idxs = torch.arange(K + 1, dtype=torch.int32, device=self.device)
        samp_w = {key: v.repeat_interleave(K + 1, dim=0)
                  for key, v in samp.items()}
        it = 0
        while it < max_new and bool((~finished).any()):
            drafts = draft_ngram(buf, cur, k=K, n=n)
            inp = torch.cat([gather_rows(buf, cur - 1, 1), drafts], dim=1)
            # the verify chunk's KV lands at cur-1 .. cur-1+K (slot cur-1
            # holds the last sampled token, written here as a decode step
            # would write it); frozen lanes write nothing (pos = -1)
            pos = (cur - 1)[:, None] + idxs[None, :]
            pos = torch.where(finished[:, None], torch.full_like(pos, -1),
                              pos)
            attn = self.backend.make_attn_fn(bt, cur + K, cur - 1)
            logits, kv = self.model.forward(self.params, inp.long(),
                                            pos.long(), kv, attn)
            y = sample(logits[..., :V].reshape(B * (K + 1), V), None,
                       mode=mode, **samp_w).reshape(B, K + 1)
            a = accept_counts(drafts, y[:, :K])
            # emit the accepted prefix + bonus, capped by the budget, cut
            # at the first EOS; frozen lanes emit none
            ok = idxs[None, :] <= a[:, None]
            ok &= (emitted[:, None] + idxs[None, :]) < max_new
            iseos = (eos[:, None] >= 0) & (y == eos[:, None])
            eos_i = iseos.to(torch.int32)
            ok &= ~((torch.cumsum(eos_i, dim=1) - eos_i) > 0)
            ok &= ~finished[:, None]
            cnt = ok.sum(dim=1, dtype=torch.int32)
            # all K+1 candidates are written; slots past cnt are stale and
            # the next iteration overwrites them before any read
            buf = write_rows(buf, cur, y)
            emitted = emitted + cnt
            finished = (finished | (emitted >= max_new)
                        | (iseos & ok).any(dim=1))
            cur = cur + cnt
            it += 1
        return buf.cpu().numpy(), emitted.cpu().numpy()

    def generate_batch(self, prompts: Sequence[Sequence[int]],
                       max_new_tokens: Optional[int] = None,
                       sampling: Optional[SamplingParams] = None,
                       seed: Optional[int] = None) -> List[List[int]]:
        """Static-batch generation: :meth:`prefill`, then :meth:`decode`
        steps until every row has finished or ``max_new_tokens`` tokens
        (continuous batching is the scheduler's)."""
        sampling = sampling or self._default_sampling()
        max_new = max_new_tokens or self.runtime.max_new_tokens
        state = self.prefill(prompts, seed=seed, sampling=sampling)
        outs: List[List[int]] = [[int(t)] for t in state.last_tokens]
        try:
            for _ in range(max_new - 1):
                if state.finished.all():
                    break
                prev_finished = state.finished.copy()
                toks = self.decode(state, sampling)
                for b, t in enumerate(toks):
                    if not prev_finished[b]:
                        outs[b].append(int(t))
            return outs
        finally:
            self.free(state)


def top_k(x: torch.Tensor, k: int):
    """The ``k`` largest of a flat f32 ``x`` in ``lax.top_k``'s order:
    descending, equal values by index (the lower first). bf16 logits tie
    exactly often enough over a 128k vocabulary, and ``torch.topk`` orders
    (and, at the k-th place, picks) equal values by its own rule, which
    differs between k = W and k = 2W; so each value is made unique by its
    index: its f32 bits in an order-preserving int32 form, times 2^32,
    plus ``2^32 - 1 - index``. Returns ``(values, indices)``."""
    bits = x.contiguous().view(torch.int32)
    key = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).long()
    key = key * (1 << 32) + ((1 << 32) - 1 - torch.arange(
        x.numel(), device=x.device))
    idx = torch.topk(key, k, sorted=True).indices
    return x[idx], idx


def _to_device(params, device):
    if isinstance(params, dict):
        return {k: _to_device(v, device) for k, v in params.items()}
    if isinstance(params, (tuple, list)):
        return type(params)(_to_device(v, device) for v in params)
    return params.to(device)
