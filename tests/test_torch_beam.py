"""Beam search of the PyTorch port (``engine/beam.py``) and the engine API
it reads, against the JAX package's on the same bridged weights.

The JAX engine runs its Pallas kernels in interpret mode, the port its
kernels' plain versions (``device="cpu"``). ``BeamSearcher`` is held
against the JAX ``BeamSearcher`` at widths 1 and 4 (the same hypotheses
token for token, cumulative scores within 1e-4), its device bursts
against its per-step path, and the cases of JAX
``tests/test_beam_rerank.py`` one by one; a sentinel run with the
copy-on-write page copies skipped must leave the JAX package's
hypotheses. ``decode_forced``, ``decode_scored`` (logits and B1's
per-page scores ``[L, B, max_pages]``), ``prefill_logits`` and
``prefill(allocator=)`` are held against the JAX engine's within 1e-4
(f32 sums in another order).
"""

import numpy as np
import pytest

import jax
import torch

from pagedattention_based_transformer_decoder_inference_framework_tpu import config as jconfig
from pagedattention_based_transformer_decoder_inference_framework_tpu.engine import (
    Engine as JaxEngine,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu.engine.beam import (
    BeamSearcher as JaxBeamSearcher,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu.models.model import (
    init_params as jax_init_params,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch import config as tconfig
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.engine import (
    BeamSearcher,
    Engine,
    SamplingParams,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.engine.engine import (
    top_k,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.kvcache import (
    pool as kv_pool,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.kvcache.allocator import (
    PageAllocator,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.models import (
    params_from_jax,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.reranker import (
    LogProbScorer,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.scheduler import (
    RequestState,
    Scheduler,
)

from test_torch_model import model_cfgs

GREEDY = SamplingParams(temperature=0.0, eos_token_id=-1)
TOL = dict(atol=1e-4, rtol=1e-4)


def build(name, kv_dtype):
    """A JAX engine and a port engine on the same params: page 8, 256
    pages, 8 pages a sequence (JAX ``tests/test_beam_rerank.py``'s)."""
    jm, tm = model_cfgs(name)
    engines = []
    for mod, m in ((jconfig, jm), (tconfig, tm)):
        engines.append(mod.FrameworkConfig(
            model=m,
            cache=mod.CacheConfig(page_size=8, num_pages=256,
                                  max_pages_per_seq=8, kv_dtype=kv_dtype),
            runtime=mod.RuntimeConfig(max_new_tokens=8)))
    jp = jax_init_params(jm, jax.random.key(0))
    je = JaxEngine(engines[0], params=jp, interpret=True)
    te = Engine(engines[1], params=params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), tm), device="cpu")
    return je, te


@pytest.fixture(scope="module")
def engines():
    return build("llama-tiny", "float32")


@pytest.fixture(scope="module")
def engines_int8():
    return build("narrow-dh128", "int8")


@pytest.fixture(scope="module")
def engine(engines):
    return engines[1]


def assert_same_hypotheses(got, want):
    assert [h.tokens for h in got] == [h.tokens for h in want]
    np.testing.assert_allclose([h.score for h in got],
                               [h.score for h in want], **TOL)


# -- against the JAX package -------------------------------------------------

@pytest.mark.parametrize("burst", [1, None])
@pytest.mark.parametrize("width", [1, 4])
def test_beam_matches_jax(engines, width, burst):
    """The same hypotheses as the JAX searcher, token for token, with
    their cumulative log-probabilities within 1e-4: per step (``burst=1``)
    and with the config's device bursts."""
    je, te = engines
    prompt = [4, 8, 15, 16, 23, 42]
    want = JaxBeamSearcher(je, beam_width=width, burst=burst).search(prompt,
                                                                     10)
    got = BeamSearcher(te, beam_width=width, burst=burst).search(prompt, 10)
    assert_same_hypotheses(got, want)


def test_beam_int8_kv_matches_jax(engines_int8):
    je, te = engines_int8
    prompt = [(11 * i + 5) % 500 for i in range(13)]
    want = JaxBeamSearcher(je, beam_width=4).search(prompt, 9)
    got = BeamSearcher(te, beam_width=4).search(prompt, 9)
    assert_same_hypotheses(got, want)


def test_skipped_copies_leave_jax(engines, monkeypatch):
    """Sentinel: with the copy-on-write copies skipped (a row's private
    tail page keeps what it held), the hypotheses leave the JAX package's,
    so the comparison above sees a copy-on-write fault."""
    je, te = engines
    prompt = [2, 4, 6, 8, 10]
    want = JaxBeamSearcher(je, beam_width=4, burst=1).search(prompt, 12)
    got = BeamSearcher(te, beam_width=4, burst=1).search(prompt, 12)
    assert_same_hypotheses(got, want)
    monkeypatch.setattr(kv_pool, "copy_pages_tree",
                        lambda kv, src, dst: kv)
    for burst in (1, 4):
        bad = BeamSearcher(te, beam_width=4, burst=burst).search(prompt, 12)
        with pytest.raises(AssertionError):
            assert_same_hypotheses(bad, want)


def test_top_k_orders_ties_as_lax():
    """The beam steps' selection equals ``lax.top_k``'s, equal values (bf16
    logits tie exactly) in index order, -inf rows included, at k = W and
    k = 2W alike."""
    rng = np.random.default_rng(3)
    for _ in range(20):
        x = (rng.integers(-6, 6, 4 * 97) * 0.125).astype(np.float32)
        x[rng.integers(0, x.size, 30)] = -np.inf
        for k in (4, 8):
            want_v, want_i = jax.lax.top_k(jax.numpy.asarray(x), k)
            got_v, got_i = top_k(torch.from_numpy(x), k)
            assert got_i.tolist() == np.asarray(want_i).tolist()
            np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("which", ["llama-tiny f32", "narrow-dh128 int8"])
def test_engine_api_matches_jax(engines, engines_int8, which):
    """``prefill_logits``, ``decode_forced`` and ``decode_scored`` (logits
    and B1's per-page scores, ``-1e30`` pages identical) against the JAX
    engine's, two states advanced in step; a private allocator leaves the
    engine's own untouched."""
    je, te = engines if which.startswith("llama") else engines_int8
    prompts = [[(7 * i + 3) % 500 for i in range(11)], [5, 9, 3]]
    free = te.allocator.num_free
    alloc = PageAllocator(te.cache.num_pages)
    tst = te.prefill(prompts, allocator=alloc)
    jst = je.prefill(prompts)
    assert te.allocator.num_free == free and alloc.num_live > 0
    np.testing.assert_allclose(tst.prefill_logits, jst.prefill_logits, **TOL)
    toks = np.asarray([3, 7], np.int32)
    np.testing.assert_allclose(te.decode_forced(tst, toks),
                               je.decode_forced(jst, toks), **TOL)
    for t in ([11, 2], [40, 41], [9, 9]):
        toks = np.asarray(t, np.int32)
        tl, ts = te.decode_scored(tst, toks)
        jl, js = je.decode_scored(jst, toks)
        np.testing.assert_allclose(tl, jl, **TOL)
        assert ts.shape == js.shape == (te.cfg.num_layers, 2,
                                        te.cache.max_pages_per_seq)
        dead = js <= -1e29
        np.testing.assert_array_equal(ts <= -1e29, dead)
        np.testing.assert_allclose(ts[~dead], js[~dead], **TOL)
    assert tst.seq_lens.tolist() == jst.seq_lens.tolist() == [15, 7]
    te.free(tst)
    assert alloc.num_live == 0 and te.allocator.num_free == free


def test_decode_scored_raises_under_scan_layers():
    _, tm = model_cfgs("llama-tiny")
    cfg = tconfig.FrameworkConfig(
        model=tm, cache=tconfig.CacheConfig(page_size=8, num_pages=16,
                                            max_pages_per_seq=4,
                                            kv_dtype="float32"),
        runtime=tconfig.RuntimeConfig(scan_layers=True))
    eng = Engine(cfg, device="cpu")
    st = eng.prefill([[1, 2, 3]])
    with pytest.raises(ValueError, match="unrolled"):
        eng.decode_scored(st, np.asarray([1], np.int32))


# -- JAX tests/test_beam_rerank.py's cases, on the port ----------------------

def test_beam1_equals_greedy(engine):
    prompt = [3, 5, 7, 9]
    greedy = engine.generate(prompt, 6, GREEDY)
    beams = BeamSearcher(engine, beam_width=1).search(prompt, 6)
    assert beams[0].tokens == greedy


def test_beam_width_returns_distinct_scored_candidates(engine):
    prompt = [4, 8, 15]
    beams = BeamSearcher(engine, beam_width=3).search(prompt, 5)
    assert len(beams) == 3
    assert len({tuple(b.tokens) for b in beams}) == 3
    scores = [b.score for b in beams]
    assert scores == sorted(scores, reverse=True)
    greedy = engine.generate(prompt, 5, GREEDY)
    g = LogProbScorer(engine, length_normalize=False).score(prompt, greedy)
    assert beams[0].score >= g - 1e-3


def test_beam_pages_all_freed(engine):
    free_before = engine.allocator.num_free
    searcher = BeamSearcher(engine, beam_width=4)
    searcher.search([1, 2, 3], 6)
    assert searcher.allocator.num_live == 0
    assert engine.allocator.num_free == free_before


def test_beam_prefills_prompt_once(engine, monkeypatch):
    calls = []
    real = engine._prefill_chunks

    def spy(kv, tokens, *a, **k):
        calls.append(tokens.shape)
        return real(kv, tokens, *a, **k)

    monkeypatch.setattr(engine, "_prefill_chunks", spy)
    BeamSearcher(engine, beam_width=4).search([1, 2, 3, 4, 5], 5)
    assert len(calls) == 1 and calls[0][0] == 1, calls


def test_beam_coexists_with_running_scheduler(engine):
    """A beam search beside a pumping scheduler on the same engine: both
    give what they give alone."""
    solo = BeamSearcher(engine, beam_width=2).search([7, 3, 1], 5)
    sched = Scheduler(engine)
    sched.start(poll_interval_s=0.001)
    try:
        req = sched.submit([2, 2, 2], 24, GREEDY)
        beams = BeamSearcher(engine, beam_width=2).search([7, 3, 1], 5)
        toks = list(req.stream())
    finally:
        sched.stop()
    assert req.state == RequestState.FINISHED and len(toks) == 24
    assert [b.tokens for b in beams] == [b.tokens for b in solo]
    assert req.tokens == engine.generate([2, 2, 2], 24, GREEDY)


def test_beam_eos_finishes(engine):
    prompt = [6, 6, 6]
    ref = BeamSearcher(engine, beam_width=2).search(prompt, 5)
    eos = ref[0].tokens[1]
    beams = BeamSearcher(engine, beam_width=2).search(prompt, 5,
                                                      eos_token_id=eos)
    for b in beams:
        assert eos not in b.tokens[:-1]


def test_beam_burst_matches_per_step(engine):
    """Device bursts reproduce the per-step path across page crossings
    (page 8, 12 steps) and partial final bursts."""
    prompt = [2, 4, 6, 8, 10]
    per_step = BeamSearcher(engine, beam_width=3, burst=1).search(prompt, 12)
    for K in (4, 16):
        burst = BeamSearcher(engine, beam_width=3, burst=K).search(prompt, 12)
        assert [b.tokens for b in burst] == [b.tokens for b in per_step]
        np.testing.assert_allclose([b.score for b in burst],
                                   [b.score for b in per_step], rtol=1e-5,
                                   atol=1e-5)


def test_beam_burst_eos_and_pages_freed(engine):
    prompt = [6, 6, 6]
    ref = BeamSearcher(engine, beam_width=2, burst=1).search(prompt, 6)
    eos = ref[0].tokens[1]
    searcher = BeamSearcher(engine, beam_width=2, burst=4)
    beams = searcher.search(prompt, 6, eos_token_id=eos)
    assert searcher.allocator.num_live == 0
    expect = BeamSearcher(engine, beam_width=2, burst=1).search(
        prompt, 6, eos_token_id=eos)
    assert [b.tokens for b in beams] == [b.tokens for b in expect]
    for b in beams:
        assert eos not in b.tokens[:-1]


def test_beam_burst_near_page_capacity(engine):
    """A request sized near ``max_pages_per_seq``: bursts are clamped to
    the page budget, so the block tables never overflow and no page
    leaks."""
    page = engine.cache.page_size
    mp = engine.cache.max_pages_per_seq
    prompt = list(range(1, 41))
    steps = mp * page - len(prompt) - 1
    searcher = BeamSearcher(engine, beam_width=2)
    beams = searcher.search(prompt, steps)
    assert len(beams[0].tokens) == steps
    assert searcher.allocator.num_live == 0


def test_beam_search_frees_pages_on_error(engine):
    searcher = BeamSearcher(engine, beam_width=2)

    def boom(*a, **k):
        raise RuntimeError("injected")

    searcher._search_steps = boom
    with pytest.raises(RuntimeError, match="injected"):
        searcher.search([1, 2, 3], 6)
    assert searcher.allocator.num_live == 0


def test_burst_reads_nothing_back(engine, monkeypatch):
    """Inside a burst nothing comes back to the host through Python:
    ``.item()``, ``.tolist()``, ``.cpu()`` and a tensor taken as a number
    raise there; one fetch follows it. (A read inside an ATen op shows
    only on the card: the smoke runs each burst under
    ``torch.cuda.set_sync_debug_mode("error")``.)"""
    searcher = BeamSearcher(engine, beam_width=3, burst=4)
    real = searcher._beam_burst
    inside = []

    def guarded(*a, **k):
        def refuse(*_a, **_k):
            raise AssertionError("host read inside a burst")

        with monkeypatch.context() as m:
            for name in ("item", "tolist", "cpu", "numpy", "__bool__",
                         "__int__", "__float__", "__index__"):
                m.setattr(torch.Tensor, name, refuse)
            out = real(*a, **k)
        inside.append(k["num_steps"])
        return out

    searcher._beam_burst = guarded
    want = BeamSearcher(engine, beam_width=3, burst=1).search([2, 4, 6], 9)
    got = searcher.search([2, 4, 6], 9)
    assert inside == [4, 4]
    assert [h.tokens for h in got] == [h.tokens for h in want]
