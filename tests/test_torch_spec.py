"""Speculative decoding of the PyTorch port (``engine/spec.py``,
``Engine.generate_batch_spec``, ``Engine.generate_batch`` and the CLI's
``batch``) against the JAX package on the CPU.

The drafting functions take the same seeded numpy buffers as the JAX
package's (``jax.jit``) and must give equal answers, the clamps of
``dynamic_slice`` and the wrap of ``jnp.roll`` included.
``stochastic_accept`` draws from threefry in JAX and from a
``torch.Generator`` here, so both are held by distribution: the first
emitted token's frequencies over 4000 draws within 0.03 of ``p`` (about
3 sigma of the largest cell), as ``tests/test_spec_decode.py`` holds the
JAX one. The engines are ``llama-tiny`` (f32, page 8) with the JAX
engine's params bridged by ``params_from_jax``; the JAX engine runs its
Pallas kernels in interpret mode. Greedy token streams must be equal.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pagedattention_based_transformer_decoder_inference_framework_tpu import config as jconfig
from pagedattention_based_transformer_decoder_inference_framework_tpu.engine import (
    Engine as JaxEngine,
    SamplingParams as JaxSampling,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu.engine import spec as jspec
from pagedattention_based_transformer_decoder_inference_framework_tpu.models.model import (
    init_params as jax_init_params,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch import config as tconfig
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.cli import cli_app
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.engine import (
    Engine,
    SamplingParams,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.engine import spec as tspec
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.models import (
    params_from_jax,
)

from test_torch_model import model_cfgs

# self-repeating, no repeats, longer than a page, a single token (with
# random weights the drafts still miss: the greedy stream repeats no
# n-gram; test_spec_accepted_drafts_match_jax has a model whose drafts hit)
PROMPTS = [[5, 9, 3, 14, 5, 9, 3, 14, 5, 9], [1, 2, 3, 4, 5, 6, 7],
           list(range(20, 44)), [11]]
NEW = 12
GREEDY = SamplingParams(temperature=0.0, eos_token_id=-1)
JGREEDY = JaxSampling(temperature=0.0, eos_token_id=-1)


# -- drafting ---------------------------------------------------------------

# (buf, cur, k, n, drafts): tests/test_spec_decode.py's hand cases
HAND = {
    "most_recent_match": ([[7, 8, 9, 1, 7, 8, 4, 7, 8]], [9], 3, 2,
                          [[4, 7, 8]]),
    "no_match_repeats_last": ([[1, 2, 3, 4, 5, 0, 0, 0]], [5], 2, 2,
                              [[5, 5]]),
    "excludes_trailing_self_match": ([[3, 1, 2, 1, 2, 0]], [5], 2, 2,
                                     [[1, 2]]),
}

_jdraft = jax.jit(jspec.draft_ngram, static_argnames=("k", "n"))


def drafts_both(buf, cur, k, n):
    ref = np.asarray(_jdraft(jnp.asarray(buf, jnp.int32),
                             jnp.asarray(cur, jnp.int32), k=k, n=n))
    out = tspec.draft_ngram(torch.tensor(buf, dtype=torch.int32),
                            torch.tensor(cur, dtype=torch.int32), k=k, n=n)
    return ref, out.numpy()


@pytest.mark.parametrize("case", sorted(HAND))
def test_draft_ngram_hand_cases(case):
    buf, cur, k, n, expect = HAND[case]
    ref, out = drafts_both(buf, cur, k, n)
    assert ref.tolist() == expect
    assert out.tolist() == expect


def test_draft_ngram_matches_jax_on_random_buffers():
    """50 buffers over a 4-6 token vocabulary (n-grams repeat); every
    third batch has ``cur`` within 2 of ``M``, where a match near the end
    runs the draft window past the row and the start clamps."""
    rng = np.random.default_rng(0)
    clamped = 0
    for i in range(50):
        M = int(rng.choice([8, 13, 20]))
        k, n = int(rng.integers(1, 6)), int(rng.integers(1, 4))
        buf = rng.integers(0, rng.integers(4, 7), size=(4, M))
        if i % 3 == 0:
            cur = M - rng.integers(0, 3, size=4)
        else:
            cur = rng.integers(1, M + 1, size=4)
        ref, out = drafts_both(buf, cur, k, n)
        np.testing.assert_array_equal(out, ref, err_msg=f"buffer {i}")
        clamped += int((cur + k > M).sum())
    assert clamped > 0


def test_accept_counts_matches_jax():
    rng = np.random.default_rng(1)
    d = np.asarray([[1, 2, 3], [1, 9, 3], [9, 9, 9]])
    t = np.asarray([[1, 2, 3], [1, 2, 3], [1, 2, 3]])
    assert tspec.accept_counts(torch.tensor(d), torch.tensor(t)).tolist() \
        == [3, 1, 0]
    d = rng.integers(0, 3, size=(40, 6))
    t = rng.integers(0, 3, size=(40, 6))
    ref = np.asarray(jspec.accept_counts(jnp.asarray(d), jnp.asarray(t)))
    out = tspec.accept_counts(torch.tensor(d), torch.tensor(t)).numpy()
    np.testing.assert_array_equal(out, ref)


def test_write_and_gather_rows_match_jax():
    """Starts inside the row and past its end (clamped to the last window
    that fits, as ``dynamic_slice`` / ``dynamic_update_slice`` do)."""
    rng = np.random.default_rng(2)
    buf = rng.integers(0, 100, size=(5, 12)).astype(np.int32)
    vals = rng.integers(100, 200, size=(5, 4)).astype(np.int32)
    starts = np.asarray([0, 3, 8, 10, 30], np.int32)
    jb, js = jnp.asarray(buf), jnp.asarray(starts)
    tb, ts = torch.from_numpy(buf), torch.from_numpy(starts)
    np.testing.assert_array_equal(
        tspec.write_rows(tb, ts, torch.from_numpy(vals)).numpy(),
        np.asarray(jspec.write_rows(jb, js, jnp.asarray(vals))))
    np.testing.assert_array_equal(buf, tb.numpy())      # not in place
    for width in (1, 4):
        np.testing.assert_array_equal(
            tspec.gather_rows(tb, ts, width).numpy(),
            np.asarray(jspec.gather_rows(jb, js, width)))


def test_stochastic_accept_preserves_distribution():
    """The accept / resample rule with a point-mass draft leaves the
    first emitted token distributed as a plain draw from ``p``: the
    port's and the JAX package's frequencies over 4000 draws (one batch
    of 4000 rows each) both within 0.03 of ``p``."""
    V, K, N = 6, 2, 4000
    p = np.asarray([0.35, 0.25, 0.2, 0.1, 0.07, 0.03])
    logits = np.log(p).astype(np.float32)
    scaled = np.broadcast_to(logits, (N, K + 1, V))
    drafts = np.broadcast_to(np.asarray([2, 4], np.int32), (N, K))
    a, fix = tspec.stochastic_accept(
        torch.from_numpy(scaled.copy()), torch.from_numpy(drafts.copy()),
        torch.Generator().manual_seed(0))
    first = torch.where(a >= 1, 2, fix).numpy()
    keys = jax.random.split(jax.random.key(0), N)
    ku = jax.vmap(lambda k: jax.random.split(jax.random.fold_in(k, 1),
                                             K))(keys)
    kr = jax.vmap(lambda k: jax.random.split(jax.random.fold_in(k, 2),
                                             K + 1))(keys)
    ja, jfix = jax.jit(jspec.stochastic_accept)(
        jnp.asarray(scaled), jnp.asarray(drafts), ku, kr)
    jfirst = np.where(np.asarray(ja) >= 1, 2, np.asarray(jfix))
    for f in (first, jfirst):
        emp = np.bincount(f, minlength=V) / N
        np.testing.assert_allclose(emp, p, atol=0.03)
    # the accepted-prefix lengths and the tokens stay in range
    assert a.min() >= 0 and a.max() <= K and fix.max() < V


# -- the engine -------------------------------------------------------------

def frameworks(kv_dtype="float32", quant="none", **runtime):
    jm, tm = model_cfgs("llama-tiny")
    jm.quant = tm.quant = quant
    return [mod.FrameworkConfig(
        model=m,
        cache=mod.CacheConfig(page_size=8, num_pages=256,
                              max_pages_per_seq=16, kv_dtype=kv_dtype),
        runtime=mod.RuntimeConfig(max_new_tokens=16, **runtime))
        for mod, m in ((jconfig, jm), (tconfig, tm))]


def engine_pair(kv_dtype="float32", quant="none"):
    jcfg, tcfg = frameworks(kv_dtype, quant)
    jp = jax_init_params(jcfg.model, jax.random.key(0))
    je = JaxEngine(jcfg, params=jp, interpret=True)
    src = jp if quant == "none" else je.params
    te = Engine(tcfg, params=params_from_jax(
        jax.tree_util.tree_map(np.asarray, src), tcfg.model), device="cpu")
    return je, te


@pytest.fixture(scope="module")
def engines():
    return engine_pair()


@pytest.mark.parametrize("k,n", [(4, 2), (3, 3), (1, 2), (7, 2)])
def test_spec_matches_jax(engines, k, n):
    """k=7 makes the verify chunk one page (T == 8): the port's page-
    aligned append addresses each token by its own position, so a chunk
    that starts off a page boundary lands in its own slots."""
    je, te = engines
    ref = je.generate_batch_spec(PROMPTS, NEW, JGREEDY, spec_k=k, ngram=n)
    out = te.generate_batch_spec(PROMPTS, NEW, GREEDY, spec_k=k, ngram=n)
    assert out == ref
    assert te.allocator.num_free == te.cache.num_pages - 1


def repeating_params(jp):
    """``jp`` (the JAX ``init_params`` tree) made into a model that repeats
    its input token: attention and MLP outputs damped to a tenth and the
    LM head the embedding's transpose, so a token's own embedding scores
    highest. Random weights never repeat an n-gram, so this is the model
    whose drafts are accepted."""
    p = jax.tree_util.tree_map(np.array, jp)
    p["layers"]["wo"] *= 0.1
    p["layers"]["w_down"] *= 0.1
    p["lm_head"] = p["embedding"].T.copy()
    return p


def test_spec_accepted_drafts_match_jax():
    """Multi-token advances: the first verify accepts all ``spec_k``
    drafts (the last token repeated); after it the most recent match of
    the trailing n-gram overlaps the n-gram itself, so the JAX drafting
    proposes the last token and then unwritten history (zeros), and each
    verify emits 2 tokens: 5 + 2 + 2 + 2 after the first token, in 4
    verify forwards."""
    jcfg, tcfg = frameworks()
    p = repeating_params(jax_init_params(jcfg.model, jax.random.key(0)))
    je = JaxEngine(jcfg, params=jax.tree_util.tree_map(jnp.asarray, p),
                   interpret=True)
    te = Engine(tcfg, params=params_from_jax(p, tcfg.model), device="cpu")
    forwards = []
    forward = te.model.forward
    te.model.forward = lambda *a: forwards.append(1) or forward(*a)
    out = te.generate_batch_spec(PROMPTS, NEW, GREEDY, spec_k=4, ngram=2)
    assert len(forwards) == 1 + 4
    assert out == [[q[-1]] * NEW for q in PROMPTS]
    assert out == je.generate_batch_spec(PROMPTS, NEW, JGREEDY, spec_k=4,
                                         ngram=2)
    assert out == te.generate_batch_fused(PROMPTS, NEW, GREEDY)


def test_spec_equals_fused(engines):
    _, te = engines
    ref = te.generate_batch_fused(PROMPTS, NEW, GREEDY)
    for k, n in ((4, 2), (3, 3), (1, 2), (7, 2)):
        assert te.generate_batch_spec(PROMPTS, NEW, GREEDY, spec_k=k,
                                      ngram=n) == ref, (k, n)


def test_spec_int8_weights_matches_jax():
    je, te = engine_pair("int8", "int8")
    ref = je.generate_batch_spec(PROMPTS, NEW, JGREEDY, spec_k=4, ngram=2)
    assert te.generate_batch_spec(PROMPTS, NEW, GREEDY, spec_k=4,
                                  ngram=2) == ref


def test_generate_batch_matches_jax(engines):
    je, te = engines
    ref = je.generate_batch(PROMPTS, NEW, JGREEDY)
    assert te.generate_batch(PROMPTS, NEW, GREEDY) == ref
    assert te.allocator.num_free == te.cache.num_pages - 1


def test_spec_eos_truncation_matches_fused(engines):
    _, te = engines
    prompts = [[5, 9, 3, 14], [2, 4, 6, 8]]
    eos = te.generate_batch_fused(prompts, NEW, GREEDY)[0][3]
    samp = SamplingParams(temperature=0.0, eos_token_id=eos)
    ref = te.generate_batch_fused(prompts, NEW, samp)
    assert te.generate_batch_spec(prompts, NEW, samp, spec_k=4) == ref
    assert any(r[-1] == eos and len(r) < NEW for r in ref)
    assert te.generate_batch(prompts, NEW, samp) == ref


def test_spec_budget_exact(engines):
    _, te = engines
    for max_new in (1, 2, 5):
        out = te.generate_batch_spec([[5, 9, 3, 14, 5, 9, 3, 14]], max_new,
                                     GREEDY, spec_k=4)
        assert len(out[0]) == max_new


def test_spec_runtime_config_default():
    _, tcfg = frameworks(spec_k=4, spec_ngram=2, temperature=0.0,
                         eos_token_id=-1)
    te = Engine(tcfg, device="cpu")
    prompts = [[5, 9, 3, 14, 5, 9, 3, 14]]
    ref = te.generate_batch_fused(prompts, 8, GREEDY)
    assert te.generate_batch_spec(prompts, 8) == ref
    free0 = te.allocator.num_free
    te.generate_batch_spec([[5, 9, 3, 14]], 8, GREEDY, spec_k=4)
    assert te.allocator.num_free == free0


@pytest.mark.parametrize("bad", [
    dict(temperature=0.7), dict(repetition_penalty=1.2),
    dict(stop_token_ids=(3,)), dict(logit_bias=((3, 1.0),))])
def test_spec_refuses_what_is_not_greedy_exact(engines, bad):
    _, te = engines
    samp = SamplingParams(**dict(dict(temperature=0.0, eos_token_id=-1),
                                 **bad))
    with pytest.raises(ValueError):
        te.generate_batch_spec(PROMPTS, NEW, samp, spec_k=4)
    assert te.allocator.num_free == te.cache.num_pages - 1


def test_spec_horizon_covers_the_verify_chunk(engines):
    """The verify chunk writes up to ``spec_k`` positions past ``prompt +
    max_new``: a request that fits ``max_pages_per_seq`` only without
    them is refused (pages freed), in the JAX package too."""
    je, te = engines
    prompt = [list(range(1, 101))]       # 100 + 20 fits 16 pages of 8,
    for eng, samp, err in ((te, GREEDY, ValueError),   # 100 + 20 + 9 not
                           (je, JGREEDY, AssertionError)):
        with pytest.raises(err, match="max_pages_per_seq"):
            eng.generate_batch_spec(prompt, 20, samp, spec_k=9)
    assert te.allocator.num_free == te.cache.num_pages - 1
    assert len(te.generate_batch_spec(prompt, 20, GREEDY, spec_k=8)[0]) == 20


def test_cli_batch_takes_the_spec_path_on_cpu(tmp_path, monkeypatch):
    src = tmp_path / "prompts.txt"
    src.write_text("abc abc abc\n\nxyz\n")
    calls = []
    spec = Engine.generate_batch_spec

    def counting(self, *args, **kw):
        calls.append(args)
        return spec(self, *args, **kw)

    monkeypatch.setattr(Engine, "generate_batch_spec", counting)
    rows = {}
    for k in (3, 0):
        out = tmp_path / f"out{k}.jsonl"
        assert cli_app.main([
            "batch", "--model", "llama-tiny", "--input", str(src),
            "--output", str(out), "--max-new-tokens", "6",
            "--temperature", "0", "--spec-k", str(k),
            "--device", "cpu"]) == 0
        rows[k] = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(calls) == 1                      # --spec-k 3 only
    assert [r["prompt"] for r in rows[3]] == ["abc abc abc", "xyz"]
    assert rows[3] == rows[0]                   # spec == step decode
