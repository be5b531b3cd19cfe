"""The port's continuous-batching scheduler (``scheduler/scheduler.py``).

First, case for case, the JAX package's ``tests/test_scheduler.py`` on
the port (llama-tiny, f32, page 8, the same configs; expectations from
the port's own engine, as the JAX tests take them from theirs; a stream
cut by EOS or a stop id is held to the engine's stream up to the first
occurrence of that id, which with the port's random weights is not
always the JAX weights' index 2). Then the port's ``Scheduler`` against
the JAX package's on the same bridged weights and the same submit /
``step`` schedule: greedy streams identical for interleaved arrivals with
preemption by re-prefill and a prefix hit, swap preemption, the spec
burst (``spec_k=3``) and the fused tick with penalties and a logit bias.
Then a lane that ends on a page boundary of a tagged prefix page, and the
per-request draw (``request_key`` + Gumbel-max): its frequencies against
``softmax`` by chi-square, its independence from the row and the batch,
and of consecutive indices, and a seeded request's stream through a
preemption.
"""

import numpy as np
import pytest

from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.config import (
    CacheConfig, FrameworkConfig, RuntimeConfig, preset)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.engine import (
    Engine, SamplingParams)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.scheduler import (
    RequestState, Scheduler)

GREEDY = SamplingParams(temperature=0.0, eos_token_id=-1)


def make_engine(num_pages=64, max_batch=4, **runtime_kw):
    rt = dict(max_new_tokens=8, max_batch_size=max_batch,
              prefill_chunk=16, temperature=0.0, eos_token_id=-1)
    rt.update(runtime_kw)
    # tests that pin decode_burst rely on per-tick token granularity:
    # don't let the idle-queue burst extension change it under them
    if "decode_burst" in rt and "decode_burst_max" not in rt:
        rt["decode_burst_max"] = rt["decode_burst"]
    cfg = FrameworkConfig(
        model=preset("llama-tiny"),
        cache=CacheConfig(page_size=8, num_pages=num_pages,
                          max_pages_per_seq=8, kv_dtype="float32"),
        runtime=RuntimeConfig(**rt),
    )
    cfg.model.dtype = "float32"
    return Engine(cfg, device="cpu")


def test_single_request_matches_engine():
    eng = make_engine()
    sched = Scheduler(eng)
    req = sched.submit([3, 5, 7, 9], max_new_tokens=6, sampling=GREEDY)
    sched.run_until_idle()
    assert req.state == RequestState.FINISHED
    assert req.tokens == eng.generate([3, 5, 7, 9], 6, GREEDY)


def test_interleaved_requests_match_individual_runs():
    """Requests arriving mid-flight must decode exactly as if alone."""
    eng = make_engine()
    expected = {}
    for p in ([1, 2, 3], [9, 8, 7, 6, 5], [4, 4]):
        expected[tuple(p)] = eng.generate(p, 6, GREEDY)

    sched = Scheduler(eng)
    r1 = sched.submit([1, 2, 3], 6, GREEDY)
    sched.step()
    sched.step()
    r2 = sched.submit([9, 8, 7, 6, 5], 6, GREEDY)   # joins mid-decode
    sched.step()
    r3 = sched.submit([4, 4], 6, GREEDY)
    sched.run_until_idle()
    assert r1.tokens == expected[(1, 2, 3)]
    assert r2.tokens == expected[(9, 8, 7, 6, 5)]
    assert r3.tokens == expected[(4, 4)]


def test_more_requests_than_lanes():
    eng = make_engine(max_batch=2)
    sched = Scheduler(eng)
    prompts = [[i + 1, i + 2] for i in range(5)]
    reqs = [sched.submit(p, 4, GREEDY) for p in prompts]
    sched.run_until_idle()
    assert all(r.state == RequestState.FINISHED for r in reqs)
    for p, r in zip(prompts, reqs):
        assert r.tokens == eng.generate(p, 4, GREEDY)


def test_eos_frees_lane_early():
    eng = make_engine()
    probe = eng.generate([6, 6, 6], 6, GREEDY)
    eos = probe[2]
    samp = SamplingParams(temperature=0.0, eos_token_id=eos)
    sched = Scheduler(eng)
    req = sched.submit([6, 6, 6], 6, sampling=samp)
    sched.run_until_idle()
    # the stream ends at the first occurrence of the EOS id
    assert req.tokens == probe[:probe.index(eos) + 1]
    assert all(l.free for l in sched.lanes)
    assert eng.allocator.num_live == 0


def test_preemption_requeues_youngest():
    """Pool too small for both requests at full length: the younger one
    must be preempted and still finish correctly afterwards — and the
    client-visible stream must contain each token exactly once (the
    requeue teacher-forces already-delivered tokens on re-prefill
    instead of re-generating them; ADVICE round 1 high)."""
    eng = make_engine(num_pages=6, max_batch=2)   # 5 usable pages
    sched = Scheduler(eng)
    # each needs 1 page prompt + grows to 3 pages over 16 tokens
    r1 = sched.submit([1] * 8, 16, GREEDY)
    r2 = sched.submit([2] * 8, 16, GREEDY)
    sched.run_until_idle(max_steps=4000)
    assert sched.n_preempted > 0, "pool pressure never preempted"
    assert r1.state == RequestState.FINISHED
    assert r2.state == RequestState.FINISHED
    assert r1.tokens == eng.generate([1] * 8, 16, GREEDY)
    assert r2.tokens == eng.generate([2] * 8, 16, GREEDY)
    # the delivered stream has no duplicated prefix after requeue
    assert list(r1.stream()) == r1.tokens
    assert list(r2.stream()) == r2.tokens
    assert eng.allocator.num_live == 0


def test_streaming_iterator():
    eng = make_engine()
    sched = Scheduler(eng)
    req = sched.submit([5, 6], 5, GREEDY)
    sched.start()
    toks = list(req.stream())
    sched.stop()
    assert toks == req.tokens and len(toks) == 5


def test_page_accounting_clean_after_burst():
    eng = make_engine(max_batch=3)
    sched = Scheduler(eng)
    reqs = [sched.submit([i + 1] * 3, 5, GREEDY) for i in range(7)]
    sched.run_until_idle()
    assert all(r.state == RequestState.FINISHED for r in reqs)
    assert eng.allocator.num_live == 0


def test_prefix_cache_reuses_pages():
    """A repeated prompt must reuse freed prefix pages (no re-prefill of
    cached pages) and produce identical tokens."""
    import dataclasses

    from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.config import (
        CacheConfig as CC)

    eng = make_engine()
    eng.config.cache.enable_prefix_cache = True
    eng.cache.enable_prefix_cache = True
    sched = Scheduler(eng)
    prompt = list(range(1, 20))            # 19 tokens = 2 full pages + tail
    r1 = sched.submit(prompt, 4, GREEDY)
    sched.run_until_idle()
    # the two complete pages should be tagged in the allocator LRU
    lru_before = eng.allocator.num_cached
    assert lru_before >= 2
    r2 = sched.submit(prompt, 4, GREEDY)
    sched.run_until_idle()
    assert r2.tokens == r1.tokens
    # different prompt must not hit the cache
    r3 = sched.submit([7] * 19, 4, GREEDY)
    sched.run_until_idle()
    assert r3.state == RequestState.FINISHED


def test_swap_preemption_resumes_without_reprefill():
    """With enable_swap, a preempted request's KV moves to host RAM and
    the request resumes mid-stream — same tokens as an unpressured run,
    and its token list is never reset."""
    eng = make_engine(num_pages=6, max_batch=2)   # force preemption
    eng.config.cache.enable_swap = True
    sched = Scheduler(eng)
    r1 = sched.submit([1] * 8, 16, GREEDY)
    r2 = sched.submit([2] * 8, 16, GREEDY)
    saw_swap = False
    for _ in range(4000):
        if sched.step() == 0 and sched.waiting.empty():
            break
        saw_swap = saw_swap or any(
            r.swap is not None for r in (r1, r2))
    assert saw_swap, "pool pressure never triggered a swap-out"
    assert r1.state == RequestState.FINISHED
    assert r2.state == RequestState.FINISHED
    assert r1.tokens == eng.generate([1] * 8, 16, GREEDY)
    assert r2.tokens == eng.generate([2] * 8, 16, GREEDY)
    assert eng.allocator.num_live == 0


def test_live_pool_resize_admits_queued_work():
    """Growing the pool mid-run (KVTileCache::resize capability) lets
    queued requests admit without restarting the scheduler."""
    eng = make_engine(num_pages=4, max_batch=2)   # too small for both
    sched = Scheduler(eng)
    r1 = sched.submit([1] * 8, 12, GREEDY)
    r2 = sched.submit([2] * 8, 12, GREEDY)
    for _ in range(3):
        sched.step()
    sched.resize(16)
    sched.run_until_idle(max_steps=4000)
    assert r1.state == RequestState.FINISHED
    assert r2.state == RequestState.FINISHED
    assert r1.tokens == eng.generate([1] * 8, 12, GREEDY)
    assert r2.tokens == eng.generate([2] * 8, 12, GREEDY)


def test_sliding_window_reclaims_pages():
    """A windowed model's scheduler frees pages that fall out of every
    query's window (rolling buffer) and still decodes exactly like the
    engine's own windowed generate."""
    eng = make_engine(num_pages=16, max_batch=1, decode_burst=4)
    eng.config.model.sliding_window = 12     # < final seq_len of 24
    eng.cfg.sliding_window = 12
    sched = Scheduler(eng)
    r = sched.submit([3] * 8, 24, GREEDY)
    peak = 0
    for _ in range(2000):
        if sched.step() == 0 and sched.waiting.empty():
            break
        peak = max(peak, eng.allocator.num_live)
    assert r.state == RequestState.FINISHED
    assert r.tokens == eng.generate([3] * 8, 24, GREEDY)
    assert eng.allocator.num_live == 0
    # 32 final tokens = 4 pages unwindowed; the rolling buffer caps the
    # peak at ceil((window + burst_horizon)/page) + 1 boundary slack =
    # 3 pages — pages ahead of the window are pre-allocated per burst
    assert peak <= 3, peak


def test_scheduler_penalties_match_engine():
    """Penalty histograms persist across decode bursts and admissions:
    scheduler output ≡ the engine's stepwise path, including a
    penalty-free request sharing the batch (its lane must not be
    affected by the histogram carried for its neighbor)."""
    import dataclasses

    eng = make_engine()
    pen = dataclasses.replace(GREEDY, repetition_penalty=1.5,
                              presence_penalty=0.3)
    p1, p2 = [3, 5, 7, 9], [1, 2, 3]
    want_pen = eng.generate(p1, 6, pen)
    want_plain = eng.generate(p2, 6, GREEDY)
    sched = Scheduler(eng)
    r1 = sched.submit(p1, 6, pen)
    r2 = sched.submit(p2, 6, GREEDY)
    sched.run_until_idle()
    assert r1.tokens == want_pen
    assert r2.tokens == want_plain


def test_scheduler_stop_tokens():
    import dataclasses

    eng = make_engine()
    base = eng.generate([3, 5, 7, 9], 6, GREEDY)
    stop = base[2]
    sp = dataclasses.replace(GREEDY, stop_token_ids=(stop,))
    sched = Scheduler(eng)
    req = sched.submit([3, 5, 7, 9], 6, sp)
    sched.run_until_idle()
    assert req.state == RequestState.FINISHED
    # the stream ends at the first occurrence of the stop id
    assert req.tokens == base[:base.index(stop) + 1]


def test_scheduler_logit_bias():
    """Per-request logit bias flows through the fused burst; the biased
    lane is pinned to the boosted token while a plain lane is not."""
    import dataclasses

    eng = make_engine()
    plain = eng.generate([3, 5, 7, 9], 5, GREEDY)
    boosted = dataclasses.replace(GREEDY, logit_bias=((11, 1e9),))
    sched = Scheduler(eng)
    r1 = sched.submit([3, 5, 7, 9], 5, boosted)
    r2 = sched.submit([3, 5, 7, 9], 5, GREEDY)
    sched.run_until_idle()
    assert r1.tokens == [11] * 5
    assert r2.tokens == plain


def test_idle_queue_burst_extension():
    """With an empty admission queue, bursts extend to decode_burst_max
    (fewer host syncs); outputs are identical to the capped schedule."""
    out = {}
    for mx in (2, 16):
        eng = make_engine(decode_burst=2, decode_burst_max=mx)
        sched = Scheduler(eng)
        reqs = [sched.submit([3 + i, 5, 7], max_new_tokens=12,
                             sampling=GREEDY) for i in range(2)]
        steps = 0
        while any(r.state == RequestState.RUNNING for r in reqs) or \
                not sched.waiting.empty():
            sched.step()
            steps += 1
            assert steps < 100
        assert all(r.state == RequestState.FINISHED for r in reqs)
        out[mx] = ([r.tokens for r in reqs], steps)
    assert out[2][0] == out[16][0]          # identical tokens
    assert out[16][1] < out[2][1]           # fewer scheduler ticks


def test_biased_request_joining_mid_decode_keeps_its_bias():
    """ADVICE r4 (high): a biased request whose multi-chunk prefill
    finishes while a greedy lane decodes must NOT inherit the greedy
    lanes' cached sampling mode through the fused tick — the _samp_plan
    cache key must see which lanes the mode unions over, not only each
    lane's (req_id, decoding) state. The stale window: r2 is admitted
    and runs chunk 1 while r1's decode tick caches a greedy-only mode
    under the final lane-state key; next tick r2's finishing chunk goes
    through the fused path, whose _samp_plan call hits that entry."""
    import dataclasses

    eng = make_engine(decode_burst=2)
    boosted = dataclasses.replace(GREEDY, logit_bias=((11, 1e9),))
    prompt2 = list(range(1, 21))          # 20 tokens -> 2 prefill chunks

    sched = Scheduler(eng)
    r1 = sched.submit([3, 5, 7], 30, GREEDY)
    sched.step()                          # r1 prefills (+ first burst)
    sched.step()                          # r1 decoding
    r2 = sched.submit(prompt2, 5, boosted)
    sched.step()                          # chunk 1 + r1 burst: mode cached
    assert r1.state == RequestState.RUNNING   # r1 still decoding
    sched.step()                          # finishing chunk -> fused tick
    sched.run_until_idle()
    assert r2.tokens == [11] * 5          # stale greedy mode drops bias
    assert r1.tokens == eng.generate([3, 5, 7], 30, GREEDY)


def test_fused_tick_multi_gang_chain():
    """More pending lanes than one gang's token budget holds must run
    as CHAINED gang dispatches inside the fused tick (round-4 fell back
    to the legacy 3-dispatch path). prefill_gang_tokens=16 with
    chunk=16 gives a 1-lane gang, so 4 simultaneous admissions need 4
    chained gangs."""
    eng = make_engine(prefill_gang_tokens=16)
    prompts = [[3, 5, 7], [9, 8, 7, 6], [1, 2], [4, 4, 4, 4, 4]]
    want = {tuple(p): eng.generate(p, 6, GREEDY) for p in prompts}

    sched = Scheduler(eng)
    from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.scheduler.scheduler import (
        Scheduler as S)
    fused_ran = []
    orig = S._fused_tick

    def spy(self):
        out = orig(self)
        fused_ran.append(out is not None)
        return out

    S._fused_tick = spy
    try:
        reqs = [sched.submit(p, 6, GREEDY) for p in prompts]
        sched.run_until_idle()
    finally:
        S._fused_tick = orig
    assert any(fused_ran), "fused tick never fired"
    for p, r in zip(prompts, reqs):
        assert r.tokens == want[tuple(p)]


def test_fused_tick_penalties_exact():
    """Penalty-carrying lanes ride the fused tick (gang samples against
    host-seeded prompt histograms; the scatter bumps the sampled first
    token into the counts the burst threads) — output must equal the
    engine's stepwise path exactly."""
    import dataclasses

    eng = make_engine()
    pen = dataclasses.replace(GREEDY, repetition_penalty=1.7,
                              frequency_penalty=0.2)
    p1, p2 = [3, 5, 7, 9], [1, 2, 3]
    want_pen = eng.generate(p1, 6, pen)
    want_plain = eng.generate(p2, 6, GREEDY)

    sched = Scheduler(eng)
    from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.scheduler.scheduler import (
        Scheduler as S)
    fused_ran = []
    orig = S._fused_tick

    def spy(self):
        out = orig(self)
        fused_ran.append(out is not None)
        return out

    S._fused_tick = spy
    try:
        r1 = sched.submit(p1, 6, pen)
        r2 = sched.submit(p2, 6, GREEDY)
        sched.run_until_idle()
    finally:
        S._fused_tick = orig
    assert any(fused_ran), "fused tick never fired (penalties fell back)"
    assert r1.tokens == want_pen
    assert r2.tokens == want_plain


# -- the JAX package's Scheduler on the same weights ------------------------

import dataclasses  # noqa: E402

import torch  # noqa: E402

import jax  # noqa: E402

from pagedattention_based_transformer_decoder_inference_framework_tpu import config as jconfig  # noqa: E402
from pagedattention_based_transformer_decoder_inference_framework_tpu.engine import (  # noqa: E402
    Engine as JaxEngine, SamplingParams as JaxSampling)
from pagedattention_based_transformer_decoder_inference_framework_tpu.models.model import (  # noqa: E402
    init_params as jax_init_params)
from pagedattention_based_transformer_decoder_inference_framework_tpu.scheduler import (  # noqa: E402
    Scheduler as JaxScheduler)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch import config as tconfig  # noqa: E402
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.models import (  # noqa: E402
    params_from_jax)

from test_torch_model import model_cfgs  # noqa: E402


def parity_engines(num_pages, max_batch, cache_kw=(), **runtime_kw):
    """The JAX engine (interpret mode) and the port's on the CPU, with the
    same llama-tiny f32 weights (bridged by ``params_from_jax``) and the
    same configs."""
    rt = dict(max_new_tokens=8, max_batch_size=max_batch, prefill_chunk=16,
              temperature=0.0, eos_token_id=-1)
    rt.update(runtime_kw)
    rt.setdefault("decode_burst_max", rt.get("decode_burst", 64))
    jm, tm = model_cfgs("llama-tiny")
    cfgs = [mod.FrameworkConfig(
        model=m,
        cache=mod.CacheConfig(page_size=8, num_pages=num_pages,
                              max_pages_per_seq=8, kv_dtype="float32",
                              **dict(cache_kw)),
        runtime=mod.RuntimeConfig(**rt))
        for mod, m in ((jconfig, jm), (tconfig, tm))]
    jp = jax_init_params(cfgs[0].model, jax.random.key(0))
    je = JaxEngine(cfgs[0], params=jp, interpret=True)
    te = Engine(cfgs[1], params=params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), cfgs[1].model),
        device="cpu")
    return je, te


def run_schedule(sched, sampling_cls, plan):
    """Submit ``plan``'s requests ``(tick, prompt, max_new, sampling
    knobs)`` before the given ``step`` tick (an entry ``(tick, None,
    pages, None)`` resizes the pool), then run until idle. Returns the
    streams, the preemption count and the prefix-cache hits."""
    alloc = sched.engine.allocator
    hits = []
    lookup = alloc.lookup_freed

    def counted(tag):
        page = lookup(tag)
        hits.append(page is not None)
        return page

    alloc.lookup_freed = counted
    reqs, tick = [], 0
    try:
        while plan[len(reqs):] or sched.step() or not sched.waiting.empty():
            for t, prompt, new, knobs in plan[len(reqs):]:
                if t > tick:
                    break
                if prompt is None:
                    sched.resize(new)
                reqs.append(None if prompt is None else sched.submit(
                    prompt, new, sampling_cls(**{
                        "temperature": 0.0, "eos_token_id": -1, **knobs})))
            if plan[len(reqs):]:
                sched.step()
            tick += 1
            assert tick < 2000
    finally:
        del alloc.lookup_freed
    reqs = [r for r in reqs if r is not None]
    assert all(r.state.value == "finished" for r in reqs)
    return [r.tokens for r in reqs], sched.n_preempted, sum(hits)


def both(plan, num_pages, max_batch, cache_kw=(), **runtime_kw):
    je, te = parity_engines(num_pages, max_batch, cache_kw, **runtime_kw)
    jout = run_schedule(JaxScheduler(je), JaxSampling, plan)
    tout = run_schedule(Scheduler(te), SamplingParams, plan)
    assert te.allocator.num_live == 0
    return jout, tout


SHARED = list(range(3, 19))                  # two full pages at page 8


def test_parity_interleaved_requeue_and_prefix_hit():
    """Arrivals mid-decode on two lanes, a pool that forces the youngest
    request out (re-queued, re-prefilled with its delivered tokens
    teacher-forced), a live resize that grows the pool, and a prompt that
    takes back a finished request's two tagged pages."""
    plan = [(0, SHARED, 10, {}), (0, [2] * 8, 14, {}),
            (3, [7, 1, 7, 1, 9], 6, {}), (3, None, 24, None),
            (10, SHARED + [5, 6, 7], 6, {})]
    jout, tout = both(plan, num_pages=7, max_batch=2,
                      cache_kw={"enable_prefix_cache": True},
                      decode_burst=4)
    assert tout == jout
    assert tout[1] >= 1 and tout[2] == 2, tout[1:]


def test_parity_swap_preemption():
    plan = [(0, [1] * 8, 16, {}), (0, [2] * 8, 16, {})]
    jout, tout = both(plan, num_pages=6, max_batch=2,
                      cache_kw={"enable_swap": True})
    assert tout == jout and tout[1] >= 1


def test_parity_spec_burst():
    motif = [4, 9, 2, 7]
    plan = [(0, motif * 3, 12, {}), (0, [6, 1] * 5, 10, {}),
            (2, motif * 2 + [3], 8, {})]
    jout, tout = both(plan, num_pages=48, max_batch=4, spec_k=3)
    assert tout == jout


def test_parity_fused_tick_penalties_and_bias():
    plan = [(0, [3, 5, 7, 9], 8,
             {"repetition_penalty": 1.7, "frequency_penalty": 0.2}),
            (0, [1, 2, 3], 8, {"logit_bias": ((11, 2.5), (40, -3.0))}),
            (2, list(range(1, 21)), 6, {"presence_penalty": 0.4}),
            (3, [8, 8, 2], 6, {})]
    jout, tout = both(plan, num_pages=48, max_batch=4, decode_burst=2)
    assert tout == jout


# -- frozen lanes' writes against tagged pages -------------------------------

def test_lane_ending_on_a_tagged_page_boundary():
    """A request whose KV ends exactly on a page boundary freezes inside a
    burst that runs on for a longer lane: its frozen writes land at the
    slot one past its content, the first slot of an untagged page (or the
    dump page), never on the full pages it tags at release. A prompt
    equal to its content through those pages takes them back and decodes
    exactly as the engine's own prefill of that prompt."""
    eng = make_engine(decode_burst=16)
    eng.config.cache.enable_prefix_cache = True
    sched = Scheduler(eng)
    # 8 prompt tokens + 9 new: 16 KV rows written = two full pages
    short = sched.submit([5, 1, 4, 1, 5, 9, 2, 6], 9, GREEDY)
    long = sched.submit([2, 7, 1, 8], 24, GREEDY)
    sched.run_until_idle()
    assert short.state == long.state == RequestState.FINISHED
    prompt = (short.prompt + short.tokens)[:16]
    hits = []
    lookup = eng.allocator.lookup_freed
    eng.allocator.lookup_freed = lambda tag: hits.append(lookup(tag)) or \
        hits[-1]
    again = sched.submit(prompt, 6, GREEDY)
    sched.run_until_idle()
    del eng.allocator.lookup_freed
    assert sum(h is not None for h in hits) == 2
    assert again.tokens == eng.generate(prompt, 6, GREEDY)
    assert long.tokens == eng.generate([2, 7, 1, 8], 24, GREEDY)


def test_second_scheduler_takes_no_stale_prefix_pages():
    """A scheduler's pool is its own: pages an earlier scheduler on the
    same engine tagged are not taken as prefix hits (their KV is in the
    other pool). A 40-token prompt that would hit five pages would run
    only its last chunk over a zero pool."""
    eng = make_engine()
    eng.config.cache.enable_prefix_cache = True
    prompt = [(5 * i + 2) % 97 for i in range(40)]
    first = Scheduler(eng)
    r1 = first.submit(prompt, 4, GREEDY)
    first.run_until_idle()
    assert eng.allocator.num_cached == 5
    second = Scheduler(eng)
    r2 = second.submit(prompt, 4, GREEDY)
    second.run_until_idle()
    assert r2.tokens == r1.tokens == eng.generate(prompt, 4, GREEDY)


# -- the per-request draw ----------------------------------------------------

def test_keyed_draw_matches_softmax():
    """Chi-square of 40000 keyed draws from one logits row against
    ``softmax(logits / T)`` (16 classes, p = 0.001)."""
    from scipy import stats

    from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.engine.sampling import (
        request_key, sample)

    V, N, T = 16, 40000, 0.8
    logits = torch.from_numpy(np.random.default_rng(3).normal(
        size=V).astype(np.float32) * 2)
    samp = SamplingParams(temperature=T, eos_token_id=-1)
    toks = sample(logits.expand(N, V).contiguous(), None,
                  row_keys=request_key(11, torch.arange(N)),
                  mode=samp.mode(), **samp.as_arrays(N))
    p = torch.softmax(logits / T, dim=-1).double().numpy()
    obs = np.bincount(toks.numpy(), minlength=V)
    chi2 = ((obs - N * p) ** 2 / (N * p)).sum()
    assert chi2 < stats.chi2.ppf(0.999, V - 1), chi2


def test_keyed_draw_depends_on_seed_and_index_only():
    """The same ``(seed, index)`` gives the same token in any row of any
    batch; other seeds or indices give other draws."""
    from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.engine.sampling import (
        request_key, sample)

    V = 64
    logits = torch.from_numpy(np.random.default_rng(4).normal(
        size=V).astype(np.float32))
    samp = SamplingParams(temperature=1.0, eos_token_id=-1)

    def draw(seeds, index):
        n = len(seeds)
        return sample(logits.expand(n, V).contiguous(), None,
                      row_keys=request_key(torch.tensor(seeds),
                                           torch.tensor(index)),
                      mode=samp.mode(), **samp.as_arrays(n)).tolist()

    seeds = list(range(100, 164))
    index = [i % 7 for i in range(64)]
    full = draw(seeds, index)
    perm = np.random.default_rng(5).permutation(64)
    assert draw([seeds[i] for i in perm], [index[i] for i in perm]) == \
        [full[i] for i in perm]
    assert [draw([s], [i])[0] for s, i in zip(seeds[:8], index[:8])] == \
        full[:8]
    assert draw(seeds, [i + 1 for i in index]) != full


def test_keyed_draws_at_consecutive_indices_are_independent():
    """Pairs of draws at indices ``i`` and ``i + 1`` of one seed: their
    joint frequencies against the product of the marginals (chi-square,
    4 x 4 cells, p = 0.001)."""
    from scipy import stats

    from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.engine.sampling import (
        gumbel_argmax, request_key)

    V, N = 4, 40000
    row = torch.log(torch.tensor([0.4, 0.3, 0.2, 0.1]))
    seeds = torch.arange(N) * 7 + 1
    a = gumbel_argmax(row.expand(N, V), request_key(seeds, 5)).numpy()
    b = gumbel_argmax(row.expand(N, V), request_key(seeds, 6)).numpy()
    joint = np.zeros((V, V))
    np.add.at(joint, (a, b), 1)
    expect = np.outer(joint.sum(1), joint.sum(0)) / N
    chi2 = ((joint - expect) ** 2 / expect).sum()
    assert chi2 < stats.chi2.ppf(0.999, (V - 1) ** 2), chi2


@pytest.mark.parametrize("swap", [False, True], ids=["requeue", "swap"])
def test_seeded_request_reproducible_through_preemption(swap):
    """A seeded sampled request gives the same tokens alone and under a
    pool that preempts it (swap or re-queue with re-prefill)."""
    samp = SamplingParams(temperature=1.0, eos_token_id=-1)
    alone_eng = make_engine()
    s = Scheduler(alone_eng)
    alone = s.submit([2] * 8, 16, samp, seed=321)
    s.run_until_idle()
    eng = make_engine(num_pages=6, max_batch=2)
    eng.config.cache.enable_swap = swap
    s2 = Scheduler(eng)
    other = s2.submit([1] * 8, 16, samp, seed=5)
    again = s2.submit([2] * 8, 16, samp, seed=321)
    s2.run_until_idle(max_steps=4000)
    assert s2.n_preempted > 0
    assert other.state == again.state == RequestState.FINISHED
    assert again.tokens == alone.tokens
