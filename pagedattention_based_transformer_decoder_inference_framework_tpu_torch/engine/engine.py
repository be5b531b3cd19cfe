"""Inference engine: chunked prefill + decode steps over the paged KV
pool, streaming generation, and the whole-batch fused generation loop.

The JAX package's ``engine/engine.py`` for one device. PyTorch runs
eagerly, so what JAX compiles into one program per step (or, for
:meth:`Engine.generate_batch_fused`, one program per request batch) is
a Python loop here with the same semantics; the pool is updated in
place. Sampling stays on the device, and the fused loop reads tokens
back to the host once, at its end.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..config import FrameworkConfig
from ..kvcache.allocator import PageAllocator
from ..models.model import (DecoderModel, Params, fuse_projections,
                            init_params, unstack_layers)
from ..utils.common import cdiv
from ..utils.platform import resolve_device
from .paged_backend import PagedKVBackend
from .sampling import SamplingParams, bump_counts, hit_stop, sample, \
    token_counts


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
    ``seed``."""

    def __init__(self, config: FrameworkConfig,
                 params: Optional[Params] = None, device=None, seed: int = 0):
        self.config = config
        self.cfg = config.model
        self.cache = config.cache
        self.runtime = config.runtime
        self.device = resolve_device(device)
        if self.cfg.quant != "none":
            raise NotImplementedError(
                f"quant={self.cfg.quant!r}: quantized weights are ROADMAP "
                "queue B items B10-B12 (w8a8 heads the next slice)")
        rope_len = (None if self.cfg.sliding_window > 0 else
                    self.cache.max_pages_per_seq * self.cache.page_size)
        self.model = DecoderModel(self.cfg, rope_len=rope_len)
        self.backend = PagedKVBackend(self.cfg, self.cache)
        self.allocator = PageAllocator(self.cache.num_pages)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(self.cfg, gen, self.device)
        self.params = _to_device(params, self.device)
        if not self.runtime.scan_layers:
            self.params = unstack_layers(self.params)
            if self.runtime.fuse_projections:
                self.params = fuse_projections(self.params)

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


def _to_device(params, device):
    if isinstance(params, dict):
        return {k: _to_device(v, device) for k, v in params.items()}
    if isinstance(params, (tuple, list)):
        return type(params)(_to_device(v, device) for v in params)
    return params.to(device)
