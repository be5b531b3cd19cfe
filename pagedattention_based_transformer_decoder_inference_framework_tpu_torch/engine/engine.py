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
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..config import FrameworkConfig
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

    def _alloc_pages(self, state: EngineState, b: int, new_len: int) -> None:
        need = cdiv(new_len, self.cache.page_size) - len(state.pages[b])
        if need > 0:
            state.pages[b].extend(self.allocator.alloc_many(need))

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
                sampling: Optional[SamplingParams] = None) -> EngineState:
        """Chunked prefill of a batch of prompts; samples the first
        generated token."""
        B = len(prompts)
        lens = np.array([len(p) for p in prompts], np.int32)
        if lens.min() < 1:
            raise ValueError("every prompt needs at least one token")
        page = self.cache.page_size
        max_len = cdiv(int(lens.max()), page) * page
        pages = [self.allocator.alloc_many(cdiv(int(L), page)) for L in lens]
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
            finished=np.zeros((B,), bool), counts=counts)
        self._mark_finished(state, first_np, sampling)
        return state

    def _step_logits(self, state: EngineState,
                     tokens: np.ndarray) -> torch.Tensor:
        """Feed one token per sequence; return next-token logits
        ``[B, V]`` (device) and advance the state."""
        B = state.batch
        for b in range(B):
            self._alloc_pages(state, b, int(state.seq_lens[b]) + 1)
        state.block_tables = self._block_tables(state.pages)
        sl = self._t(state.seq_lens)
        attn = self.backend.make_attn_fn(self._t(state.block_tables),
                                         sl + 1, sl)
        logits, state.kv = self.model.forward(
            self.params, self._t(tokens, torch.long)[:, None],
            sl.long()[:, None], state.kv, attn)
        state.seq_lens += 1
        state.last_tokens = np.asarray(tokens, np.int32)
        return logits[:, 0]

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

    @torch.inference_mode()
    def score_nll(self, prompts: Sequence[Sequence[int]],
                  starts: Optional[Sequence[int]] = None,
                  mean: bool = True) -> np.ndarray:
        """Per-sequence NLL of ``tokens[start:]`` given their prefixes,
        teacher-forced through the paged chunked-prefill path (``starts``
        defaults to 1, every target); ``mean=False`` gives the sum. Only
        one page-aligned chunk of logits exists at a time, each reduced
        on the device to a per-sequence sum; pages are freed on
        return."""
        B = len(prompts)
        lens = np.array([len(p) for p in prompts], np.int32)
        start_arr = (np.ones((B,), np.int32) if starts is None
                     else np.asarray(list(starts), np.int32))
        if lens.min() < 2:
            raise ValueError("scoring needs at least 2 tokens per sequence")
        if not ((start_arr >= 1).all() and (start_arr < lens).all()):
            raise ValueError("starts must leave at least one target per "
                             "sequence")
        page = self.cache.page_size
        max_len = cdiv(int(lens.max()), page) * page
        chunk = self._chunk(max_len)
        pages = [self.allocator.alloc_many(cdiv(int(L), page)) for L in lens]
        try:
            bt = self._t(self._block_tables(pages))
            kv = self.backend.init_cache(self.device)
            tokens = self._prompt_tokens(prompts, max_len)
            # targets[t] = token t + 1 (the last column is masked off)
            targets = np.zeros_like(tokens)
            targets[:, :-1] = tokens[:, 1:]
            nll_sum = np.zeros((B,), np.float64)
            cnt = np.zeros((B,), np.int64)
            for c0 in range(0, max_len, chunk):
                c1 = min(c0 + chunk, max_len)
                pos = c0 + np.broadcast_to(np.arange(c1 - c0), (B, c1 - c0))
                valid = ((pos + 1 < lens[:, None])
                         & (pos + 1 >= start_arr[:, None]))
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
        finally:
            for ps in pages:
                for p in ps:
                    self.allocator.free(p)
        if not mean:
            return nll_sum
        return nll_sum / np.maximum(cnt, 1)

    def free(self, state: EngineState) -> None:
        for ps in state.pages:
            for p in ps:
                self.allocator.free(p)
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


def _to_device(params, device):
    if isinstance(params, dict):
        return {k: _to_device(v, device) for k, v in params.items()}
    if isinstance(params, (tuple, list)):
        return type(params)(_to_device(v, device) for v in params)
    return params.to(device)
