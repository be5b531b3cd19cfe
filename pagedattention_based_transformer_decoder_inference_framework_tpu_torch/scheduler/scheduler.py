"""Continuous-batching scheduler: the JAX package's
``scheduler/scheduler.py`` on the port's engine, for one device.

* **fixed decode lanes** — decode always runs ``max_batch_size`` rows;
  idle lanes point at the dump page (page 0) and their samples are
  discarded;
* **decode bursts** — each tick runs up to ``runtime.decode_burst``
  decode steps back to back on the device (``Engine._decode_loop_fn``):
  lanes freeze on the device at EOS, a stop id or their token budget,
  and the host reads the burst's tokens once, for delivery and
  admission;
* **interleaved chunked prefill** — admission creates a *prefill job*
  (the prompt bucketed to chunk multiples); each tick runs at most
  ``runtime.prefill_chunks_per_tick`` chunks per lane and then a decode
  burst, so running lanes keep emitting while a long prompt prefills;
  lanes that finish their prefill in a tick take the *fused tick*
  (the final chunk, its first-token draws and the burst with no host
  read between them);
* **paged admission** — a request is admitted when a lane is free and
  the page budget covers its prompt and one decode page;
* **exact eviction** — pages of live requests are never dropped; when
  the pool runs dry the *youngest* running request is preempted: its KV
  swaps to host RAM (``cache.enable_swap``) or the request re-queues and
  its delivered tokens are teacher-forced on re-prefill, so a client
  never sees a token twice;
* **prefix cache** (``cache.enable_prefix_cache``) — a finished request's
  full pages are freed with a tag of the token prefix through them, and
  a later prompt with the same prefix takes them back without
  prefilling them again;
* **failure isolation** — invalid requests fail at submit, a prefill
  error fails only its request, a decode error resets the device state
  (pool reinitialized, prefix cache dropped) while the pump thread and
  every queued request survive; per-request timeouts mark requests
  FAILED;
* single-threaded: the scheduler owns the allocator's use and all
  mutable state; servers pump :meth:`Scheduler.step` from one thread;
* one device: data-parallel lanes (``parallel.dp > 1``, each shard with
  its own allocator) wait for ROADMAP queue A, item 7.

The pool is the scheduler's own (``self.kv``), updated in place by the
kernels; :meth:`Scheduler.resize`, a swap-in and a device reset replace
or write it, and every forward takes ``self.kv`` afresh. The engine's
own ``generate*`` calls and the scheduler draw pages from the same
allocator.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import queue
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import FrameworkConfig
from ..engine.engine import Engine
from ..engine.sampling import (SampleMode, SamplingParams, arrays_to,
                               batch_arrays_np, request_key, sample)
from ..kvcache.allocator import OutOfPagesError
from ..kvcache.pool import resize_pool
from ..kvcache.swap import gather_pages, scatter_pages
from ..utils.common import cdiv
from ..utils.logging import log_event


def _union_mode(samplings) -> SampleMode:
    """Sampler mode = union of a batch's sampling features, shared by
    the decode-burst plan and the batched prefill-finish sampler."""
    ss = list(samplings)
    return SampleMode(
        greedy=all(s.temperature <= 0 for s in ss),
        use_filter=any(s.top_k > 0 or s.top_p < 1.0 for s in ss),
        use_min_p=any(s.min_p > 0.0 for s in ss),
        use_eos_threshold=any(
            s.eos_threshold > 0 and s.eos_token_id >= 0 for s in ss),
        # capped candidate set only if EVERY row's k fits it (the capped
        # filter clips k into [1, cap], which would corrupt rows running
        # without top-k)
        filter_cap=64 if all(0 < s.top_k <= 64 for s in ss) else 0,
        use_penalties=any(s.has_penalties for s in ss),
        use_logit_bias=any(s.logit_bias for s in ss))


class RequestState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"
    FAILED = "failed"


_END = object()


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 64
    sampling: Optional[SamplingParams] = None
    req_id: int = 0
    seed: int = 0                   # per-request sampling seed
    timeout_s: float = 0.0          # 0 = no per-request timeout
    state: RequestState = RequestState.WAITING
    arrived_at: float = dataclasses.field(default_factory=time.time)
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    error: Optional[str] = None
    # host-swapped KV of a preempted request (see Scheduler._swap_out)
    swap: Optional[tuple] = None
    _out: "queue.Queue" = dataclasses.field(default_factory=queue.Queue)

    def stream(self):
        """Blocking iterator over generated tokens. Check :attr:`error` /
        :attr:`state` after exhaustion: a FAILED request's stream ends
        early instead of raising."""
        while True:
            item = self._out.get()
            if item is _END:
                return
            yield item

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.arrived_at


@dataclasses.dataclass
class _PrefillJob:
    """Resumable chunked prefill of one lane's prompt (or, on re-admission
    after a preemption, prompt + already-delivered tokens minus the last
    one, which is teacher-forced so nothing re-delivers)."""

    tokens: np.ndarray              # [1, max_len] int32, chunk-bucketed
    bt: np.ndarray                  # [1, max_pages] block table (host)
    L: int                          # live sequence length
    chunk: int
    max_len: int
    pos: int                        # next chunk offset to run
    final_logits: torch.Tensor      # [1, V] accumulator (device)
    resume_token: Optional[int]     # set => skip sampling, seed decode

    @property
    def done(self) -> bool:
        return self.pos >= self.max_len


@dataclasses.dataclass
class _Lane:
    idx: int = 0                    # lane index == decode batch row
    request: Optional[Request] = None
    pages: List[int] = dataclasses.field(default_factory=list)
    seq_len: int = 0
    last_token: int = 0
    prefill: Optional[_PrefillJob] = None

    @property
    def free(self) -> bool:
        return self.request is None

    @property
    def decoding(self) -> bool:
        return self.request is not None and self.prefill is None


def _pow2_at_least(n: int) -> int:
    out = 1
    while out < n:
        out *= 2
    return out


class Scheduler:
    """Owns a page pool and a fixed set of decode lanes over an engine."""

    def __init__(self, engine: Engine):
        if engine.config.parallel.dp != 1:
            raise NotImplementedError(
                "the scheduler runs on one device (dp=1); data-parallel "
                "lanes wait for the parallelism port (ROADMAP queue A, "
                "item 7)")
        self.engine = engine
        self.alloc = engine.allocator
        self.config: FrameworkConfig = engine.config
        self.B = self.config.runtime.max_batch_size
        self.page = engine.cache.page_size
        self.device = engine.device
        self.lanes = [_Lane(idx=i) for i in range(self.B)]
        self.waiting: "queue.Queue[Request]" = queue.Queue()
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self.kv = engine._init_cache()
        # the pool is new: pages another scheduler on this engine tagged
        # for the prefix cache hold nothing here
        self.alloc.drop_cached()
        self._samp = self._default_sampling()
        # (lane occupancy key) -> (device sampling arrays, SampleMode):
        # they change only when a lane's request changes, so bursts reuse
        # the uploaded arrays across ticks
        self._samp_cache: Optional[tuple] = None
        # uploaded gang sampling batches, keyed on the rows' value keys
        self._gsamp_cache: dict = {}
        self._zero_logits: Optional[torch.Tensor] = None
        # penalty histograms: [B, V] int32, lane rows seeded at admission
        # from prompt (+ resumed tokens); allocated the first time a
        # request with penalties admits. Bursts without penalties take
        # the [B, 1] dummy instead.
        self._counts: Optional[torch.Tensor] = None
        self._dummy_counts = self._zeros_counts(1)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # observability
        self.n_finished = 0
        self.n_failed = 0
        self.n_preempted = 0
        self.n_resets = 0

    # -- host <-> device -------------------------------------------------------

    def _dev(self, a, dtype=None) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device=self.device, dtype=dtype)

    def _zeros_counts(self, width: int) -> torch.Tensor:
        return torch.zeros((self.B, width), dtype=torch.int32,
                           device=self.device)

    # -- public API ------------------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 64,
               sampling: Optional[SamplingParams] = None,
               seed: Optional[int] = None,
               timeout_s: Optional[float] = None) -> Request:
        rid = next(self._ids)
        req = Request(
            prompt=list(prompt), max_new_tokens=max_new_tokens,
            sampling=sampling, req_id=rid,
            seed=(seed if seed is not None
                  else (self.config.runtime.seed + rid * 7919))
            & 0x7FFFFFFF,
            timeout_s=(self.config.runtime.request_timeout_s
                       if timeout_s is None else timeout_s))
        err = self._validate(req)
        if err is not None:
            self._fail_request(req, err)
            return req
        self.waiting.put(req)
        return req

    def step(self) -> int:
        """One scheduler tick: expire -> admit -> prefill chunk(s) ->
        decode burst. Returns the number of occupied lanes. When lanes
        finish their prefill this tick, the tick runs *fused*
        (:meth:`_fused_tick`)."""
        with self._lock, torch.inference_mode():
            self._expire()
            self._admit()
            out = self._fused_tick()
            if out is not None:
                return out
            self._prefill_tick()
            return self._decode_tick()

    def run_until_idle(self, max_steps: int = 100000) -> None:
        for _ in range(max_steps):
            if self.step() == 0 and self.waiting.empty():
                return

    def start(self, poll_interval_s: float = 0.002) -> None:
        """Background pump thread (for servers). A step exception cannot
        kill the pump: it is logged, the affected requests are failed
        inside :meth:`step`'s own handlers, and pumping continues."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    idle = self.step() == 0 and self.waiting.empty()
                except Exception as e:       # pragma: no cover - last resort
                    log_event("scheduler_step_error", error=repr(e))
                    idle = True
                if idle:
                    time.sleep(poll_interval_s)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def resize(self, new_num_pages: int) -> None:
        """Live-resize the page pool: grow to admit more concurrent
        context, or shrink to release device memory. Live pages are never
        dropped (shrink raises if any would be). The pool tensors are
        replaced (``kvcache.pool.resize_pool``)."""
        with self._lock, torch.inference_mode():
            self.alloc.resize(new_num_pages)
            self.kv = resize_pool(self.kv, new_num_pages)
            self.engine.cache.num_pages = new_num_pages

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # -- admission / validation ------------------------------------------------

    def _default_sampling(self) -> SamplingParams:
        r = self.config.runtime
        return SamplingParams(
            temperature=r.temperature, top_k=r.top_k, top_p=r.top_p,
            min_p=r.min_p, repetition_penalty=r.repetition_penalty,
            presence_penalty=r.presence_penalty,
            frequency_penalty=r.frequency_penalty,
            eos_token_id=self.config.eos_token_id,
            eos_threshold=r.eos_threshold)

    def _validate(self, req: Request) -> Optional[str]:
        """Reject requests that could never run: empty prompts and page
        budgets past the block-table width or the pool itself."""
        if len(req.prompt) < 1:
            return "empty prompt"
        if req.max_new_tokens < 1:
            return "max_new_tokens must be >= 1"
        horizon = len(req.prompt) + req.max_new_tokens
        need = cdiv(horizon, self.page)
        cap = self.engine.cache.max_pages_per_seq
        if need > cap:
            return (f"prompt+max_new_tokens={horizon} tokens needs {need} "
                    f"pages > max_pages_per_seq={cap}")
        usable = self.engine.cache.num_pages - 1       # page 0 = dump
        if need > usable:
            return (f"request needs {need} pages > pool capacity "
                    f"{usable}")
        return None

    def _prefill_seq(self, req: Request) -> List[int]:
        """The tokens a (re-)admitted request must prefill: the prompt,
        and after a preemption without swap every delivered token but the
        last (teacher-forced; the last one seeds the next decode step, so
        generation continues where the client left off)."""
        if req.tokens:
            return req.prompt + req.tokens[:-1]
        return list(req.prompt)

    def _pages_needed(self, req: Request) -> int:
        if req.swap is not None:
            return len(req.swap[1]) + 1        # live pages + growth room
        return cdiv(len(self._prefill_seq(req)) + 1, self.page)

    def _prefix_tag(self, tokens: Sequence[int], n_pages: int):
        """Content tag of page ``n_pages - 1``: the whole token prefix
        through that page (attention output depends on all of it)."""
        return hash(tuple(tokens[: n_pages * self.page]))

    def _expire(self) -> None:
        now = time.time()

        def expired(r: Request) -> bool:
            return r.timeout_s > 0 and now - r.arrived_at > r.timeout_s

        for lane in self.lanes:
            if not lane.free and expired(lane.request):
                lane.request.error = (
                    f"timed out after {lane.request.timeout_s:.1f}s")
                self._release(lane, RequestState.FAILED)
        with self.waiting.mutex:
            stale = [r for r in self.waiting.queue if expired(r)]
            for r in stale:
                self.waiting.queue.remove(r)
        # fail outside the queue mutex (_out.put wakes up consumers)
        for r in stale:
            self._fail_request(
                r, f"timed out in queue after {r.timeout_s:.1f}s")

    def _admit(self) -> None:
        while not self.waiting.empty():
            free_lanes = [l for l in self.lanes if l.free]
            if not free_lanes:
                return
            lane = free_lanes[0]
            req = self.waiting.queue[0]
            if self._pages_needed(req) > self.alloc.num_free:
                return                      # page pressure: keep queued
            req = self.waiting.get()
            try:
                if req.swap is not None:
                    self._swap_in(lane, req)
                else:
                    self._start_prefill(lane, req)
            except OutOfPagesError:
                req.state = RequestState.WAITING
                self.waiting.put(req)       # try again later
                return
            except Exception as e:
                self._fail_request(req, f"admission failed: {e!r}")

    def _start_prefill(self, lane: _Lane, req: Request) -> None:
        """Allocate pages and queue a resumable prefill job; its chunks
        run in later ticks, between decode bursts."""
        eng = self.engine
        seq = self._prefill_seq(req)
        L = len(seq)
        n_pages = cdiv(L, self.page)

        # prefix cache: take back freed pages whose content (the whole
        # prefix through the page) matches; their KV is still in the
        # pool, so prefill skips those tokens
        hits: List[int] = []
        if self.config.cache.enable_prefix_cache:
            for j in range(1, n_pages + 1):
                if j * self.page > L:       # partial last page: not cached
                    break
                page = self.alloc.lookup_freed(self._prefix_tag(seq, j))
                if page is None:
                    break
                hits.append(page)
        skip = len(hits) * self.page
        pages = hits + self.alloc.alloc_many(n_pages - len(hits))
        chunk = cdiv(max(self.config.runtime.prefill_chunk, 1),
                     self.page) * self.page
        # the padded length: chunk multiples past one chunk, power-of-two
        # page multiples below it (a short prompt prefills a short chunk)
        if L > chunk:
            max_len = cdiv(L, chunk) * chunk
        else:
            max_len = min(self.page * _pow2_at_least(cdiv(L, self.page)),
                          chunk)

        tokens = np.zeros((1, max_len), np.int32)
        tokens[0, :L] = seq
        bt = np.zeros((1, eng.cache.max_pages_per_seq), np.int32)
        bt[0, :len(pages)] = pages

        # first chunk that must run: the first miss, but never past the
        # chunk holding the last prompt token (its logits seed sampling)
        start = min((skip // chunk) * chunk, ((L - 1) // chunk) * chunk)
        lane.request = req
        lane.pages = pages
        lane.seq_len = 0
        if self._zero_logits is None:
            self._zero_logits = torch.zeros(
                (1, eng.cfg.vocab_size), dtype=torch.float32,
                device=self.device)
        lane.prefill = _PrefillJob(
            tokens=tokens, bt=bt, L=L, chunk=chunk,
            max_len=max_len, pos=start,
            final_logits=self._zero_logits,
            resume_token=req.tokens[-1] if req.tokens else None)
        req.state = RequestState.RUNNING

    def _prefill_tick(self) -> None:
        budget = max(1, self.config.runtime.prefill_chunks_per_tick)
        # gang same-chunk pending jobs into ONE [n, chunk] forward a
        # round: admitting B requests costs one forward a chunk round
        for _ in range(budget):
            pending = [l for l in self.lanes
                       if l.prefill is not None and not l.prefill.done]
            if not pending:
                break
            budget_tok = self.config.runtime.prefill_gang_tokens
            by_chunk: dict = {}
            for lane in pending:
                by_chunk.setdefault(lane.prefill.chunk, []).append(lane)
            for chunk, lanes_ in by_chunk.items():
                # cap each gang by the token budget (everything in a gang
                # waits for the whole gang's work)
                per = max(1, budget_tok // max(chunk, 1))
                groups = [lanes_[i:i + per]
                          for i in range(0, len(lanes_), per)]
                for group in groups:
                    try:
                        if len(group) == 1:
                            self._run_prefill_chunk(group[0],
                                                    group[0].prefill)
                        else:
                            self._run_prefill_gang(group, chunk)
                    except Exception:
                        # isolate the faulty request: the gang mutates
                        # nothing until the forward succeeds, so a retry
                        # lane by lane is safe
                        for lane in group:
                            try:
                                self._run_prefill_chunk(lane, lane.prefill)
                            except Exception as e:
                                lane.request.error = f"prefill failed: {e!r}"
                                self._release(lane, RequestState.FAILED)
        done = [(lane, lane.prefill) for lane in self.lanes
                if lane.prefill is not None and lane.prefill.done]
        if done:
            try:
                self._finish_prefills(done)
            except Exception:
                # isolate: retry each finish alone so one faulty request
                # cannot fail its co-admitted peers
                for lane, job in done:
                    if lane.request is None:
                        continue
                    try:
                        self._finish_prefill(lane, job)
                    except Exception as e:
                        lane.request.error = f"prefill failed: {e!r}"
                        self._release(lane, RequestState.FAILED)

    def _gang_arrays(self, group, chunk: int):
        """Host inputs of one chunk for each lane of ``group`` as one
        ``[n, wc]`` forward: ``n`` the group's size rounded up to a power
        of two (pad rows are wholly invalid: positions -1, the dump page,
        logits discarded), ``wc`` the largest pending slice rounded up to
        a power-of-two page multiple, at most ``chunk``."""
        n = _pow2_at_least(len(group))
        need_w = max(min(chunk, l.prefill.max_len - l.prefill.pos)
                     for l in group)
        wc = min(self.page * _pow2_at_least(cdiv(need_w, self.page)), chunk)
        tokens = np.zeros((n, wc), np.int32)
        pos = np.full((n, wc), -1, np.int32)
        bt = np.zeros((n, self.engine.cache.max_pages_per_seq), np.int32)
        sl = np.ones((n,), np.int32)
        qo = np.full((n,), wc, np.int32)
        plen = np.ones((n,), np.int32)
        for i, lane in enumerate(group):
            job = lane.prefill
            c0 = job.pos
            c1 = min(c0 + wc, job.max_len)
            tokens[i, :c1 - c0] = job.tokens[0, c0:c1]
            p = c0 + np.arange(wc)
            pos[i] = np.where(p < job.L, p, -1)
            bt[i] = job.bt[0]
            sl[i] = min(job.L, c0 + wc)
            qo[i] = c0
            plen[i] = job.L
        return wc, (tokens, pos, bt, sl, qo, plen)

    def _run_prefill_gang(self, group, chunk: int) -> None:
        """One chunk for EVERY lane of ``group`` as one forward."""
        eng = self.engine
        wc, arrays = self._gang_arrays(group, chunk)
        logits, self.kv = eng._prefill_fn(
            eng.params, *(self._dev(a) for a in arrays[:2]), self.kv,
            *(self._dev(a) for a in arrays[2:]))
        for i, lane in enumerate(group):
            job = lane.prefill
            job.final_logits = job.final_logits + logits[i:i + 1]
            job.pos = min(job.pos + wc, job.max_len)

    def _run_prefill_chunk(self, lane: _Lane, job: _PrefillJob) -> None:
        eng = self.engine
        c0 = job.pos
        c1 = min(c0 + job.chunk, job.max_len)
        pos = c0 + np.arange(c1 - c0)[None, :]
        pos = np.where(pos < job.L, pos, -1)
        logits, self.kv = eng._prefill_fn(
            eng.params, self._dev(job.tokens[:, c0:c1]), self._dev(pos),
            self.kv, self._dev(job.bt),
            self._dev(np.asarray([min(job.L, c1)], np.int32)),
            self._dev(np.asarray([c0], np.int32)),
            self._dev(np.asarray([job.L], np.int32)))
        job.final_logits = job.final_logits + logits
        job.pos = c1

    def _finish_prefills(self, pairs) -> None:
        """Finish a tick's completed prefills with ONE batched draw and
        ONE device->host read. Each row draws with ``request_key(seed,
        0)`` whatever other lanes share the batch."""
        sample_pairs = []
        for lane, job in pairs:
            lane.prefill = None
            lane.seq_len = job.L
            if job.resume_token is not None:
                # preemption resume: the next token to append is the last
                # one already delivered; nothing is re-sent
                lane.last_token = job.resume_token
                self._seed_counts(lane)
            else:
                sample_pairs.append((lane, job))
        if not sample_pairs:
            return
        ss = [(l.request.sampling or self._samp) for l, _ in sample_pairs]
        logits = torch.cat([j.final_logits for _, j in sample_pairs], dim=0)
        seeds = self._dev(np.asarray([l.request.seed
                                      for l, _ in sample_pairs], np.int64))
        mode = _union_mode(ss)
        counts = (torch.stack([self._lane_hist(l.request)
                               for l, _ in sample_pairs])
                  if mode.use_penalties else None)
        toks = sample(logits, None, mode=mode, counts=counts,
                      row_keys=request_key(seeds, 0),
                      **arrays_to(batch_arrays_np(ss),
                                  self.device)).cpu().numpy()
        now = time.time()
        for (lane, job), tok in zip(sample_pairs, toks):
            # per-lane isolation: once tokens exist, a fault in one lane's
            # delivery must not trigger the caller's batch-wide retry
            try:
                lane.last_token = int(tok)
                lane.request.first_token_at = now
                self._deliver(lane, int(tok))
                self._seed_counts(lane)
            except Exception as e:
                lane.request.error = f"prefill finish failed: {e!r}"
                self._release(lane, RequestState.FAILED)

    def _finish_prefill(self, lane: _Lane, job: _PrefillJob) -> None:
        req = lane.request
        lane.prefill = None
        lane.seq_len = job.L
        if job.resume_token is not None:
            lane.last_token = job.resume_token
            self._seed_counts(lane)
            return
        samp = req.sampling or self._samp
        mode = samp.mode()
        counts1 = (self._lane_hist(req)[None, :]
                   if mode.use_penalties else None)
        key = request_key(self._dev(np.asarray([req.seed], np.int64)), 0)
        tok = int(sample(job.final_logits, None, mode=mode, counts=counts1,
                         row_keys=key,
                         **samp.as_arrays(1, self.device)).cpu()[0])
        lane.last_token = tok
        req.first_token_at = time.time()
        self._deliver(lane, tok)
        self._seed_counts(lane)

    def _lane_hist_np(self, req: Request) -> np.ndarray:
        """``[V]`` int32 histogram of everything the request has in
        context (prompt + delivered tokens): the penalty seed of a lane
        entering decode (fresh, requeued or swapped in)."""
        V = self.engine.cfg.vocab_size
        ids = np.asarray(req.prompt + req.tokens, np.int64)
        return np.bincount(np.clip(ids, 0, V - 1),
                           minlength=V).astype(np.int32)

    def _lane_hist(self, req: Request) -> torch.Tensor:
        return self._dev(self._lane_hist_np(req))

    def _seed_counts(self, lane: _Lane) -> None:
        """Write the lane's penalty histogram row (nothing to seed when
        the first token already released the lane)."""
        req = lane.request
        if req is None:
            return
        s = req.sampling or self._samp
        if not s.has_penalties:
            return
        if self._counts is None:
            self._counts = self._zeros_counts(self.engine.cfg.vocab_size)
        self._counts[lane.idx] = self._lane_hist(req)

    # -- preemption / swap -----------------------------------------------------

    def _swap_out(self, lane: _Lane) -> None:
        """Preempt by moving the lane's KV pages to host RAM; the request
        resumes through :meth:`_swap_in` with no re-prefill. Only live
        pages move: dump-page placeholders left by sliding-window
        reclamation keep their slots but cost no copy and no pages."""
        req = lane.request
        live_slots = [j for j, p in enumerate(lane.pages) if p != 0]
        blobs = gather_pages(self.kv, [lane.pages[j] for j in live_slots])
        req.swap = (blobs, live_slots, len(lane.pages), lane.seq_len,
                    lane.last_token)
        for p in lane.pages:
            if p != 0:                 # skip dump-page placeholders
                self.alloc.free(p)
        lane.pages = []
        lane.request = None
        lane.seq_len = 0
        req.state = RequestState.WAITING
        self.n_preempted += 1
        self.waiting.put(req)

    def _swap_in(self, lane: _Lane, req: Request) -> None:
        blobs, live_slots, n_slots, seq_len, last_token = req.swap
        fresh = self.alloc.alloc_many(len(live_slots))
        if fresh:
            self.kv = scatter_pages(self.kv, blobs, fresh)
        pages = [0] * n_slots
        for j, p in zip(live_slots, fresh):
            pages[j] = p
        req.swap = None
        lane.request = req
        lane.pages = pages
        lane.seq_len = seq_len
        lane.last_token = last_token
        req.state = RequestState.RUNNING
        self._seed_counts(lane)

    def _preempt(self, lane: _Lane) -> None:
        if lane.prefill is not None or not self.config.cache.enable_swap:
            # re-queue; delivered tokens stay on the request and are
            # teacher-forced on re-admission (no re-delivery)
            self.n_preempted += 1
            self._release(lane, RequestState.WAITING, requeue=True)
        else:
            self._swap_out(lane)

    # -- delivery / release ----------------------------------------------------

    def _deliver(self, lane: _Lane, tok: int) -> None:
        req = lane.request
        req.tokens.append(tok)
        req._out.put(tok)
        samp = req.sampling or self._samp
        done = (len(req.tokens) >= req.max_new_tokens
                or (samp.eos_token_id >= 0 and tok == samp.eos_token_id)
                or tok in samp.stop_token_ids)
        if done:
            self._release(lane, RequestState.FINISHED)

    def _release(self, lane: _Lane, state: RequestState,
                 requeue: bool = False) -> None:
        req = lane.request
        tags = {}
        if (self.config.cache.enable_prefix_cache
                and state == RequestState.FINISHED):
            # tag complete pages with their content prefix so an identical
            # later prompt reuses them without re-prefill
            seq = req.prompt + req.tokens
            for j in range(1, lane.seq_len // self.page + 1):
                if lane.pages[j - 1] != 0:
                    tags[lane.pages[j - 1]] = self._prefix_tag(seq, j)
        for p in lane.pages:
            if p != 0:                 # skip dump-page placeholders
                self.alloc.free(p, tag=tags.get(p))
        lane.pages = []
        lane.request = None
        lane.seq_len = 0
        lane.prefill = None
        if requeue:
            req.state = RequestState.WAITING
            self.waiting.put(req)
            return
        req.state = state
        req.finished_at = time.time()
        if state == RequestState.FINISHED:
            self.n_finished += 1
        elif state == RequestState.FAILED:
            self.n_failed += 1
            log_event("request_failed", req_id=req.req_id, error=req.error)
        req._out.put(_END)

    def _fail_request(self, req: Request, error: str) -> None:
        req.error = error
        req.state = RequestState.FAILED
        req.finished_at = time.time()
        self.n_failed += 1
        log_event("request_failed", req_id=req.req_id, error=error)
        req._out.put(_END)

    # -- decode ----------------------------------------------------------------

    def _reclaim_window_pages(self) -> None:
        """Sliding-window models: free pages wholly below every live
        query's window (a rolling buffer at page granularity); their
        block-table slots point at the dump page."""
        w = self.config.model.sliding_window
        if w <= 0 or self.config.model.sliding_window_pattern != 1:
            # pattern > 1 (Gemma-2): global layers keep every page live
            return
        for lane in self.lanes:
            if not lane.decoding:
                continue
            # the next decode query sits at seq_len; keys <= seq_len - w
            # are out of its (and every later) window
            n_dead = max((lane.seq_len + 1 - w) // self.page, 0)
            for j in range(n_dead):
                if lane.pages[j] != 0:
                    self.alloc.free(lane.pages[j])
                    lane.pages[j] = 0          # dump-page placeholder

    def _grow_lane(self, lane: _Lane, seq_len: int, emitted: int,
                   horizon: int, writeahead: int = 0) -> None:
        """Grow one lane's pages so ``horizon`` more decode steps fit: KV
        rows land at ``seq_len .. seq_len + live_steps - 1``, the live
        steps capped by the request's remaining budget, the total clamped
        to its validated page budget. Raises ``OutOfPagesError``."""
        req = lane.request
        steps = min(horizon, req.max_new_tokens - emitted)
        total = seq_len + max(steps, 1) + writeahead
        total = min(total, len(req.prompt) + req.max_new_tokens)
        need = cdiv(max(total, seq_len + 1), self.page)
        while len(lane.pages) < need:
            lane.pages.extend(self.alloc.alloc_many(1))

    def _grow_pages(self, horizon: int, writeahead: int = 0) -> None:
        """Give every decoding lane pages for its next ``horizon`` tokens
        (and ``writeahead`` slots a spec burst writes past them);
        preempt the youngest request while the pool is dry."""
        self._reclaim_window_pages()
        while True:
            try:
                for lane in self.lanes:
                    if lane.decoding:
                        self._grow_lane(lane, lane.seq_len,
                                        len(lane.request.tokens), horizon,
                                        writeahead)
                return
            except OutOfPagesError:
                victims = [l for l in self.lanes if not l.free]
                if not victims:
                    return
                self._preempt(max(victims,
                                  key=lambda l: l.request.arrived_at))

    def _burst_len(self, rem: int, idle_queue: bool) -> int:
        """Steps of a burst: enough for the longest-remaining lane
        (``rem``), capped at ``decode_burst`` (``decode_burst_max`` when
        nothing waits to be interleaved), rounded up to a power of
        two."""
        rt = self.config.runtime
        burst = max(1, rt.decode_burst)
        if idle_queue:
            burst = max(burst, rt.decode_burst_max)
        return min(_pow2_at_least(min(burst, max(rem, 1))), burst)

    def _burst_steps(self, active: List[_Lane]) -> int:
        # a lane part-way through a chunked prefill keeps the shorter
        # cadence, or its TTFT inflates by burst_max / burst
        idle = self.waiting.empty() and not any(l.prefill is not None
                                                for l in self.lanes)
        rem = max(l.request.max_new_tokens - len(l.request.tokens)
                  for l in active)
        return self._burst_len(rem, idle)

    def _samp_plan(self, active: List[_Lane]):
        """Per-lane sampling arrays (device) and the sampler mode, cached
        on the lanes' sampling values and on which lanes the mode is the
        union over (the fused tick passes decoding + finishing lanes, a
        decode tick decoding ones only)."""
        samp = self._samp
        eff = [(l.request.sampling if l.request and l.request.sampling
                else samp) for l in self.lanes]
        key = (tuple(s.value_key() for s in eff),
               frozenset(l.idx for l in active))
        if self._samp_cache is not None and self._samp_cache[0] == key:
            return self._samp_cache[1], self._samp_cache[2]
        samp_arrays = arrays_to(batch_arrays_np(eff), self.device)
        mode = _union_mode([l.request.sampling or samp for l in active])
        self._samp_cache = (key, samp_arrays, mode)
        return samp_arrays, mode

    def _use_spec(self, lanes) -> bool:
        """The spec burst threads neither penalty histograms nor stop
        sets nor logit bias: such a lane takes the plain burst."""
        return self.config.runtime.spec_k > 0 and not any(
            (s := (l.request.sampling or self._samp)).has_penalties
            or s.stop_token_ids or s.logit_bias for l in lanes)

    def _spec_hist(self, lanes, seq_lens, emitted, budgets, n_iters: int):
        """The spec burst's history (each lane's prompt + delivered
        tokens; a fresh finishing lane's first token lands at ``seq_len``
        on the device), its ``cur`` and the lanes' KV limits; the width
        is bucketed to 256."""
        K = self.config.runtime.spec_k
        max_need = 1
        for lane in lanes:
            i = lane.idx
            max_need = max(max_need, int(seq_lens[i]) + 1
                           + min(n_iters * (K + 1),
                                 int(budgets[i] - emitted[i]))
                           + K + 1)
        M = cdiv(max_need, 256) * 256
        hist = np.zeros((self.B, M), np.int32)
        cur = np.ones((self.B,), np.int32)         # frozen lanes: dummy
        kv_limits = np.zeros((self.B,), np.int32)
        for lane in lanes:
            i, req = lane.idx, lane.request
            seq = req.prompt + req.tokens
            hist[i, :len(seq)] = seq
            cur[i] = seq_lens[i] + 1
            kv_limits[i] = len(req.prompt) + req.max_new_tokens
        return hist, cur, kv_limits

    def _run_spec(self, hist, bt, cur, emitted, budgets, seeds, kv_limits,
                  samp_arrays, mode, n_iters: int):
        eng = self.engine
        rt = self.config.runtime
        hist_out, cur_out, _, self.kv = eng._decode_spec_loop_fn(
            eng.params, hist, self.kv, self._dev(bt), cur,
            self._dev(emitted), self._dev(budgets), self._dev(seeds),
            self._dev(kv_limits), samp_arrays, num_iters=n_iters,
            spec_k=rt.spec_k, ngram=max(1, rt.spec_ngram), mode=mode,
            stochastic=rt.spec_stochastic)
        return hist_out.cpu().numpy(), cur_out.cpu().numpy()

    def _deliver_spec(self, budgets, cur0, hist_np, cur_np) -> None:
        for i, lane in enumerate(self.lanes):
            if budgets[i] == 0:
                continue
            new = int(cur_np[i]) - int(cur0[i])
            lane.seq_len = int(cur_np[i]) - 1
            lane.last_token = int(hist_np[i, int(cur_np[i]) - 1])
            for t in range(new):
                if not lane.decoding:
                    break              # released (EOS / budget) mid-burst
                self._deliver(lane, int(hist_np[i, int(cur0[i]) + t]))

    def _deliver_burst(self, budgets, out_np, n_steps: int) -> None:
        for i, lane in enumerate(self.lanes):
            if budgets[i] == 0:
                continue
            for j in range(n_steps):
                if not lane.decoding:
                    break              # released (EOS / budget) mid-burst
                lane.seq_len += 1
                lane.last_token = int(out_np[i, j])
                self._deliver(lane, lane.last_token)

    def _fused_tick(self) -> Optional[int]:
        """The final prefill chunk(s), their first-token draws and the
        decode burst with no host read between them: the gang's forward
        draws the first tokens itself (``Engine._prefill_sample_fn``), a
        device scatter merges them into the burst's seed tokens, and the
        burst starts from that device tensor; the host reads the first
        tokens after the burst. Applies when lanes finish their prefill
        this tick; more pending lanes than one gang holds run as chained
        gangs. Penalty lanes ride along (the gang draws against
        host-seeded prompt histograms, the scatter counts the drawn
        token). Returns None to fall back to the plain tick."""
        rt = self.config.runtime
        eng = self.engine
        if rt.prefill_chunks_per_tick > 1:
            return None
        pending = [l for l in self.lanes
                   if l.prefill is not None and not l.prefill.done]
        if not pending:
            return None
        if any(l.prefill is not None and l.prefill.done for l in self.lanes):
            return None   # a done-but-unfinished job (left by an error
            # fallback) must go through the plain finish path first
        chunk = pending[0].prefill.chunk
        per = max(1, rt.prefill_gang_tokens // max(chunk, 1))
        finishing = [l for l in pending
                     if l.prefill.pos + chunk >= l.prefill.max_len]
        if not finishing:
            return None                  # nothing draws: plain tick
        groups = [pending[i:i + per] for i in range(0, len(pending), per)]
        decoding = [l for l in self.lanes if l.decoding]
        post = decoding + finishing      # lanes decoding after the chunk
        samp_arrays, mode = self._samp_plan(post)
        fin_idx = {l.idx for l in finishing}
        spec_k = rt.spec_k
        use_spec = self._use_spec(post)

        # burst length: the post-chunk view of _burst_steps
        rem = 0
        for lane in decoding:
            rem = max(rem, lane.request.max_new_tokens
                      - len(lane.request.tokens))
        for lane in finishing:
            rem = max(rem, lane.request.max_new_tokens
                      - len(lane.request.tokens) - 1)
        n_steps = self._burst_len(
            rem, self.waiting.empty() and len(finishing) == len(pending))

        # pages for the whole tick BEFORE any forward; on pool pressure
        # fall back (the plain tick preempts properly). Spec: each
        # iteration may verify spec_k drafts (+1), with spec_k write-ahead
        # KV rows past the emitted tokens
        horizon = n_steps * (spec_k + 1) if use_spec else n_steps
        ahead = spec_k if use_spec else 0
        self._reclaim_window_pages()
        try:
            for lane in decoding:
                self._grow_lane(lane, lane.seq_len,
                                len(lane.request.tokens), horizon, ahead)
            for lane in finishing:
                # fresh rows count their in-forward first token as
                # emitted; resume rows draw nothing
                em = len(lane.request.tokens) + (
                    0 if lane.prefill.resume_token is not None else 1)
                self._grow_lane(lane, lane.prefill.L, em, horizon, ahead)
        except OutOfPagesError:
            return None

        V = eng.cfg.vocab_size

        def build_gang(g):
            wc, arrays = self._gang_arrays(g, chunk)
            n = arrays[0].shape[0]
            smask = np.zeros((n,), bool)
            gseeds = np.zeros((n,), np.int64)
            rows = np.full((n,), self.B, np.int32)  # B = dropped scatter
            gs = []
            for i, lane in enumerate(g):
                gseeds[i] = lane.request.seed
                if lane.idx in fin_idx and lane.prefill.resume_token is None:
                    smask[i] = True
                    rows[i] = lane.idx
                gs.append(lane.request.sampling or self._samp)
            gs += [self._samp] * (n - len(gs))
            gkey = tuple(s.value_key() for s in gs)
            gsamp = self._gsamp_cache.get(gkey)
            if gsamp is None:
                gsamp = arrays_to(batch_arrays_np(gs), self.device)
                if len(self._gsamp_cache) >= 16:
                    self._gsamp_cache.clear()
                self._gsamp_cache[gkey] = gsamp
            gcounts = None
            if mode.use_penalties:
                # prompt histograms seed the in-gang first-token
                # penalties; rows without penalties draw with identity
                # knobs, so their zero rows are inert
                gc = np.zeros((n, V), np.int32)
                for i, lane in enumerate(g):
                    if smask[i] and (lane.request.sampling
                                     or self._samp).has_penalties:
                        gc[i] = self._lane_hist_np(lane.request)
                gcounts = self._dev(gc)
            return arrays, smask, gseeds, gsamp, gcounts, rows

        # burst inputs over all lanes (idle rows frozen by budgets = 0)
        mp = eng.cache.max_pages_per_seq
        bt = np.zeros((self.B, mp), np.int32)
        sl = np.zeros((self.B,), np.int32)
        dec = np.zeros((self.B,), np.int32)
        emitted = np.zeros((self.B,), np.int32)
        budgets = np.zeros((self.B,), np.int32)
        seeds = np.zeros((self.B,), np.int64)
        for lane in decoding:
            i = lane.idx
            bt[i, :len(lane.pages)] = lane.pages
            sl[i] = lane.seq_len
            dec[i] = lane.last_token
            emitted[i] = len(lane.request.tokens)
            budgets[i] = lane.request.max_new_tokens
            seeds[i] = lane.request.seed
        for lane in finishing:
            i = lane.idx
            job = lane.prefill
            bt[i, :len(lane.pages)] = lane.pages
            sl[i] = job.L
            if job.resume_token is not None:
                dec[i] = job.resume_token
                emitted[i] = len(lane.request.tokens)
            else:
                emitted[i] = len(lane.request.tokens) + 1
            budgets[i] = lane.request.max_new_tokens
            seeds[i] = lane.request.seed

        if mode.use_penalties:
            # host-seed the finishing lanes' histogram rows (prompt +
            # delivered tokens; the in-forward first token is counted by
            # the scatter below)
            if self._counts is None:
                self._counts = self._zeros_counts(V)
            for lane in finishing:
                if (lane.request.sampling or self._samp).has_penalties:
                    self._counts[lane.idx] = self._lane_hist(lane.request)
            counts = self._counts
        else:
            counts = self._dummy_counts
        firsts = []                      # (first_dev, rows) per gang
        try:
            for g in groups:
                arrays, smask, gseeds, gsamp, gcounts, rows = build_gang(g)
                first_dev, self.kv = eng._prefill_sample_fn(
                    eng.params, *(self._dev(a) for a in arrays[:2]),
                    self.kv, *(self._dev(a) for a in arrays[2:]),
                    self._dev(smask), self._dev(gseeds), gsamp, gcounts,
                    mode=mode)
                firsts.append((first_dev, self._dev(rows)))
        except Exception as e:
            # the gangs mutate no scheduler state before they succeed
            # (re-running a chunk rewrites the same KV pages): fall back
            # to the plain tick, whose per-lane retry isolates a faulty
            # request
            log_event("fused_tick_gang_fallback", error=repr(e)[:500])
            return None
        # commit the prefill bookkeeping NOW: a burst fault must then see
        # the finishing lanes as DECODING, so the device reset fails them
        # like any decode fault
        deliver = []
        for gidx, g in enumerate(groups):
            for i, lane in enumerate(g):
                job = lane.prefill
                job.pos = min(job.pos + chunk, job.max_len)
                if lane.idx not in fin_idx:
                    continue
                lane.prefill = None
                lane.seq_len = job.L
                if job.resume_token is not None:
                    lane.last_token = job.resume_token
                else:
                    deliver.append((gidx, i, lane))
        out_np = hist_np = cur_np = cur0 = None
        try:
            if use_spec:
                hist, cur0, kv_limits = self._spec_hist(
                    post, sl, emitted, budgets, n_steps)
                hist_dev, cur_dev = self._dev(hist), self._dev(cur0)
                for first_dev, rows in firsts:
                    hist_dev = eng._scatter_hist_fn(hist_dev, cur_dev,
                                                    first_dev, rows)
                hist_np, cur_np = self._run_spec(
                    hist_dev, bt, cur_dev, emitted, budgets, seeds,
                    kv_limits, samp_arrays, mode, n_steps)
            else:
                start = self._dev(dec)
                for first_dev, rows in firsts:
                    start, counts = eng._scatter_tokens_fn(
                        start, first_dev, rows, counts,
                        bump=mode.use_penalties)
                if rem > 0:
                    out_dev, self.kv, counts = eng._decode_loop_fn(
                        eng.params, start, self.kv, self._dev(bt),
                        self._dev(sl), self._dev(emitted),
                        self._dev(budgets), self._dev(seeds), samp_arrays,
                        counts, num_steps=n_steps, mode=mode)
                    out_np = out_dev.cpu().numpy()
            first_nps = [f.cpu().numpy() for f, _ in firsts]
        except Exception as e:
            self._reset_device_state(e)
            return sum(not l.free for l in self.lanes)
        if use_spec:
            pass                        # spec gates out penalty lanes
        elif mode.use_penalties:
            self._counts = counts
        else:
            self._dummy_counts = counts

        now = time.time()
        for gidx, i, lane in deliver:
            # per-lane isolation (as in _finish_prefills)
            try:
                tok = int(first_nps[gidx][i])
                lane.last_token = tok
                lane.request.first_token_at = now
                self._deliver(lane, tok)
            except Exception as e:
                lane.request.error = f"prefill finish failed: {e!r}"
                self._release(lane, RequestState.FAILED)
        if cur_np is not None:
            self._deliver_spec(budgets, cur0, hist_np, cur_np)
        elif out_np is not None:
            self._deliver_burst(budgets, out_np, n_steps)
        return sum(not l.free for l in self.lanes)

    def _lane_arrays(self):
        """Host burst inputs over all lanes; idle lanes have budget 0
        (frozen) and all-zero block tables (the dump page)."""
        mp = self.engine.cache.max_pages_per_seq
        bt = np.zeros((self.B, mp), np.int32)
        emitted = np.zeros((self.B,), np.int32)
        budgets = np.zeros((self.B,), np.int32)   # 0 => frozen idle lane
        seeds = np.zeros((self.B,), np.int64)
        for i, lane in enumerate(self.lanes):
            if not lane.decoding:
                continue
            bt[i, :len(lane.pages)] = lane.pages
            emitted[i] = len(lane.request.tokens)
            budgets[i] = lane.request.max_new_tokens
            seeds[i] = lane.request.seed
        return bt, emitted, budgets, seeds

    def _decode_tick(self) -> int:
        if not any(l.decoding for l in self.lanes):
            return sum(not l.free for l in self.lanes)
        if self._use_spec([l for l in self.lanes if l.decoding]):
            return self._decode_tick_spec()
        n_steps = self._burst_steps([l for l in self.lanes if l.decoding])
        self._grow_pages(n_steps)
        active = [l for l in self.lanes if l.decoding]
        if not active:
            return sum(not l.free for l in self.lanes)

        eng = self.engine
        bt, emitted, budgets, seeds = self._lane_arrays()
        sl = np.zeros((self.B,), np.int32)
        toks = np.zeros((self.B,), np.int32)
        for lane in active:
            sl[lane.idx] = lane.seq_len
            toks[lane.idx] = lane.last_token

        samp_arrays, mode = self._samp_plan(active)
        if mode.use_penalties and self._counts is None:
            self._counts = self._zeros_counts(eng.cfg.vocab_size)
        counts = self._counts if mode.use_penalties else self._dummy_counts

        try:
            out, self.kv, counts = eng._decode_loop_fn(
                eng.params, self._dev(toks), self.kv, self._dev(bt),
                self._dev(sl), self._dev(emitted), self._dev(budgets),
                self._dev(seeds), samp_arrays, counts, num_steps=n_steps,
                mode=mode)
            if mode.use_penalties:
                self._counts = counts
            else:
                self._dummy_counts = counts
            out_np = out.cpu().numpy()
        except Exception as e:
            self._reset_device_state(e)
            return sum(not l.free for l in self.lanes)
        self._deliver_burst(budgets, out_np, n_steps)
        return sum(not l.free for l in self.lanes)

    def _decode_tick_spec(self) -> int:
        """Speculative decode burst (``runtime.spec_k > 0``): each device
        iteration drafts ``spec_k`` tokens a greedy lane from its own
        history and verifies them in one forward (greedy-exact); sampled
        lanes advance one seeded token an iteration, exactly as in the
        plain burst (``Engine._decode_spec_loop_fn``)."""
        K = self.config.runtime.spec_k
        n_iters = self._burst_steps([l for l in self.lanes if l.decoding])
        self._grow_pages(n_iters * (K + 1), writeahead=K)
        active = [l for l in self.lanes if l.decoding]
        if not active:
            return sum(not l.free for l in self.lanes)
        sl = np.zeros((self.B,), np.int32)
        for lane in active:
            assert len(lane.request.prompt) + len(lane.request.tokens) \
                == lane.seq_len + 1
            sl[lane.idx] = lane.seq_len
        bt, emitted, budgets, seeds = self._lane_arrays()
        hist, cur0, kv_limits = self._spec_hist(active, sl, emitted,
                                                budgets, n_iters)
        samp_arrays, mode = self._samp_plan(active)
        try:
            hist_np, cur_np = self._run_spec(
                self._dev(hist), bt, self._dev(cur0), emitted, budgets,
                seeds, kv_limits, samp_arrays, mode, n_iters)
        except Exception as e:
            self._reset_device_state(e)
            return sum(not l.free for l in self.lanes)
        self._deliver_spec(budgets, cur0, hist_np, cur_np)
        return sum(not l.free for l in self.lanes)

    def _reset_device_state(self, error: Exception) -> None:
        """A decode-burst failure cannot be attributed to one lane and
        may have left the pool half-written: fail every decoding request,
        re-queue prefilling ones (their KV is lost either way),
        reinitialize the pool and drop the prefix cache (its pages'
        contents went with the pool). Serving continues."""
        self.n_resets += 1
        log_event("decode_reset", error=repr(error))
        for lane in self.lanes:
            if lane.decoding:
                lane.request.error = f"decode step failed: {error!r}"
                self._release(lane, RequestState.FAILED)
            elif not lane.free:
                self._release(lane, RequestState.WAITING, requeue=True)
        self.alloc.drop_cached()
        self.kv = None                  # free the old pool first
        self.kv = self.engine._init_cache()
        self._counts = None
        self._dummy_counts = self._zeros_counts(1)
        self._samp_cache = None
        self._gsamp_cache.clear()
        self._zero_logits = None
