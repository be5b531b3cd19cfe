"""Failure handling, timeouts, prefill/decode interleaving and
per-request seed reproducibility of the port's scheduler: case for case
the JAX package's ``tests/test_scheduler_failures.py`` on the port
(llama-tiny, f32, page 8, the same configs; faults injected by swapping
the engine's ``_prefill_fn``, ``_prefill_sample_fn`` and
``_decode_loop_fn``, which the port names as the JAX engine does)."""

import time

import pytest

from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.config import (
    CacheConfig, FrameworkConfig, RuntimeConfig, preset)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.engine import (
    Engine, SamplingParams)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.scheduler import (
    RequestState, Scheduler)

GREEDY = SamplingParams(temperature=0.0, eos_token_id=-1)


def make_engine(num_pages=64, max_batch=4, max_pages_per_seq=8,
                **runtime_kw):
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
                          max_pages_per_seq=max_pages_per_seq,
                          kv_dtype="float32"),
        runtime=RuntimeConfig(**rt),
    )
    cfg.model.dtype = "float32"
    return Engine(cfg, device="cpu")


# -- submit-time validation ---------------------------------------------------

def test_oversized_request_fails_at_submit():
    """A request whose prompt+max_new_tokens exceeds the block-table
    budget fails immediately instead of raising inside the pump thread
    (ADVICE round 1 medium)."""
    eng = make_engine()          # 8 pages/seq * page 8 = 64 tokens max
    sched = Scheduler(eng)
    req = sched.submit([1] * 8, max_new_tokens=4096, sampling=GREEDY)
    assert req.state == RequestState.FAILED
    assert "max_pages_per_seq" in req.error
    assert list(req.stream()) == []          # stream terminates, no hang
    # serving is unaffected
    ok = sched.submit([1, 2, 3], 4, GREEDY)
    sched.run_until_idle()
    assert ok.state == RequestState.FINISHED and len(ok.tokens) == 4


def test_empty_prompt_fails_at_submit():
    sched = Scheduler(make_engine())
    req = sched.submit([], 4, GREEDY)
    assert req.state == RequestState.FAILED
    assert req.error == "empty prompt"


def test_request_larger_than_pool_fails_at_submit():
    eng = make_engine(num_pages=4, max_pages_per_seq=64)
    sched = Scheduler(eng)
    req = sched.submit([1] * 8, 56, GREEDY)   # needs 8 pages, pool has 3
    assert req.state == RequestState.FAILED
    assert "pool capacity" in req.error


def test_data_parallel_lanes_raise():
    """Lanes over data-parallel shards (``parallel.dp > 1``) are not
    ported: the scheduler refuses them and names the roadmap item."""
    eng = make_engine()
    eng.config.parallel.dp = 2
    with pytest.raises(NotImplementedError, match="queue A, item 7"):
        Scheduler(eng)


# -- runtime failure isolation ------------------------------------------------

def test_prefill_error_fails_only_that_request():
    eng = make_engine()
    sched = Scheduler(eng)

    def boom(*a, **k):
        raise RuntimeError("injected prefill fault")

    # both prefill entry points fault: the fused tick's gang+sample
    # program and the legacy chunk program it falls back to
    eng._prefill_fn = boom
    eng._prefill_sample_fn = boom
    bad = sched.submit([1, 2, 3], 4, GREEDY)
    sched.step()
    assert bad.state == RequestState.FAILED
    assert "injected prefill fault" in bad.error
    assert list(bad.stream()) == []
    assert eng.allocator.num_live == 0       # its pages were freed

    del eng._prefill_fn, eng._prefill_sample_fn   # the methods again
    ok = sched.submit([1, 2, 3], 4, GREEDY)
    sched.run_until_idle()
    assert ok.state == RequestState.FINISHED
    assert ok.tokens == eng.generate([1, 2, 3], 4, GREEDY)


def test_decode_error_resets_and_serving_survives():
    """One decode-burst exception fails the affected requests, resets
    the device pool, and the scheduler keeps serving new requests."""
    eng = make_engine(decode_burst=8)    # pin burst: test needs >1 tick
    sched = Scheduler(eng)
    calls = {"n": 0}

    def boom(*a, **k):
        calls["n"] += 1
        raise RuntimeError("injected decode fault")

    r1 = sched.submit([1, 2, 3], 48, GREEDY)
    sched.step()                 # prefill + first (real) burst
    assert r1.state == RequestState.RUNNING
    eng._decode_loop_fn = boom
    sched.step()
    assert calls["n"] == 1
    assert r1.state == RequestState.FAILED
    assert "decode step failed" in r1.error
    assert sched.n_resets == 1
    assert eng.allocator.num_live == 0

    del eng._decode_loop_fn                  # the method again
    r2 = sched.submit([4, 5, 6], 4, GREEDY)
    sched.run_until_idle()
    assert r2.state == RequestState.FINISHED
    assert r2.tokens == eng.generate([4, 5, 6], 4, GREEDY)


def test_pump_thread_survives_injected_fault():
    eng = make_engine()
    sched = Scheduler(eng)

    def boom(*a, **k):
        raise RuntimeError("injected")

    eng._decode_loop_fn = boom
    sched.start(poll_interval_s=0.001)
    bad = sched.submit([1, 2], 4, GREEDY)
    # stream ends (first token from prefill, then the decode fault)
    # instead of hanging forever on a dead pump thread
    assert list(bad.stream()) == bad.tokens
    assert bad.state == RequestState.FAILED
    del eng._decode_loop_fn                  # the method again
    ok = sched.submit([1, 2], 4, GREEDY)
    toks = list(ok.stream())
    sched.stop()
    assert ok.state == RequestState.FINISHED and len(toks) == 4


# -- timeouts -----------------------------------------------------------------

def test_queued_request_times_out():
    eng = make_engine(max_batch=1)
    sched = Scheduler(eng)
    # lane blocked by a long request; the queued one expires behind it
    long = sched.submit([1] * 8, 56, GREEDY)   # 64 tokens = full budget
    sched.step()
    queued = sched.submit([2, 2], 8, GREEDY, timeout_s=0.01)
    time.sleep(0.05)
    sched.step()
    assert queued.state == RequestState.FAILED
    assert "timed out in queue" in queued.error
    sched.run_until_idle(max_steps=500)
    assert long.state == RequestState.FINISHED


def test_running_request_times_out():
    eng = make_engine(decode_burst=1)
    sched = Scheduler(eng)
    req = sched.submit([1, 2, 3], 48, GREEDY, timeout_s=0.02)
    sched.step()                              # prefill + first tokens
    assert req.state == RequestState.RUNNING
    time.sleep(0.05)
    sched.step()
    assert req.state == RequestState.FAILED
    assert "timed out" in req.error
    assert eng.allocator.num_live == 0
    got = list(req.stream())
    assert got == req.tokens                  # partial output delivered


# -- prefill/decode interleaving ----------------------------------------------

def test_long_prefill_does_not_stall_decode_lanes():
    """VERDICT round 1 Weak #2: running lanes must keep emitting while
    a many-chunk prompt prefills (per-tick prefill chunk budget)."""
    eng = make_engine(num_pages=128, max_pages_per_seq=32,
                      prefill_chunk=16, decode_burst=2)
    sched = Scheduler(eng)
    r1 = sched.submit([1, 2, 3], 64, GREEDY)
    sched.step()
    assert len(r1.tokens) > 0
    # 160-token prompt = 10 chunks of 16
    r2 = sched.submit(list(range(1, 161)), 4, GREEDY)
    ticks_while_prefilling = 0
    for _ in range(20):
        before = len(r1.tokens)
        sched.step()
        lane2 = next((l for l in sched.lanes
                      if l.request is r2), None)
        if lane2 is not None and lane2.prefill is not None:
            ticks_while_prefilling += 1
            # decode lanes advanced during this prefill tick
            assert len(r1.tokens) > before
        if r2.state == RequestState.FINISHED or (
                lane2 is not None and lane2.prefill is None):
            break
    assert ticks_while_prefilling >= 3, (
        "prefill never interleaved with decode")
    sched.run_until_idle(max_steps=500)
    assert r2.state == RequestState.FINISHED
    assert r2.tokens == eng.generate(list(range(1, 161)), 4, GREEDY)


# -- per-request seeds --------------------------------------------------------

def test_seeded_request_reproducible_across_batch_composition():
    """A seeded sampled request yields identical tokens whether it runs
    alone or alongside other lanes, across burst boundaries (per-token
    request_key(seed, i) draws; ADVICE round 1 low)."""
    samp = SamplingParams(temperature=1.0, top_k=0, top_p=1.0,
                          eos_token_id=-1)
    eng = make_engine(decode_burst=4)
    sched = Scheduler(eng)
    alone = sched.submit([5, 6, 7], 12, samp, seed=123)
    sched.run_until_idle()
    assert alone.state == RequestState.FINISHED

    sched2 = Scheduler(make_engine(decode_burst=4))
    a = sched2.submit([5, 6, 7], 12, samp, seed=123)
    b = sched2.submit([9, 9], 12, samp, seed=77)
    sched2.run_until_idle()
    assert a.tokens == alone.tokens
    assert a.tokens != b.tokens
