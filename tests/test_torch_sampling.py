"""Sampling of the PyTorch port against the JAX package: the masks
(``filter_logits``, the capped filter, min-p, penalties, logit bias)
are exact on the same logits; sampled tokens are held by their
distribution, since ``torch.Generator`` (Philox) and JAX's threefry
draw different streams."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pagedattention_based_transformer_decoder_inference_framework_tpu.engine import sampling as js
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.engine import sampling as ts


def logits_np(B=4, V=300, seed=0):
    return np.random.default_rng(seed).normal(size=(B, V)).astype(
        np.float32) * 3


# (top_k, top_p) as the sampler runs them (the filter is compiled in only
# when top_k > 0 or top_p < 1; at top_p == 1 the nucleus cut would rest
# on the last f32 bits of two different cumsum implementations)
@pytest.mark.parametrize("top_k,top_p", [(0, 0.9), (20, 1.0), (40, 0.5),
                                         (5, 0.95)])
def test_filter_logits_exact(top_k, top_p):
    x = logits_np()
    B = x.shape[0]
    k = np.full((B,), top_k, np.int32)
    p = np.full((B,), top_p, np.float32)
    ref = np.asarray(js.filter_logits(jnp.asarray(x), jnp.asarray(k),
                                      jnp.asarray(p)))
    out = ts.filter_logits(torch.from_numpy(x), torch.from_numpy(k),
                           torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(out, ref)
    if top_k:
        cref = np.asarray(js._filter_logits_capped(
            jnp.asarray(x), jnp.asarray(k), jnp.asarray(p), 64))
        cout = ts._filter_logits_capped(
            torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(p),
            64).numpy()
        np.testing.assert_array_equal(np.isinf(cout), np.isinf(cref))
        np.testing.assert_array_equal(cout, out)


def test_prepare_logits_matches_jax():
    x = logits_np(seed=1)
    B, V = x.shape
    sp = dict(temperature=0.7, top_k=30, top_p=0.8, min_p=0.05,
              repetition_penalty=1.3, presence_penalty=0.5,
              frequency_penalty=0.2, logit_bias=((3, 5.0), (17, -2.0)),
              eos_token_id=-1)
    toks = np.random.default_rng(2).integers(0, V, size=(B, 12))
    lens = np.asarray([12, 5, 1, 9])
    jcounts = js.token_counts(jnp.asarray(toks), jnp.asarray(lens), V)
    tcounts = ts.token_counts(torch.from_numpy(toks), torch.from_numpy(lens),
                              V)
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    jsp, tsp = js.SamplingParams(**sp), ts.SamplingParams(**sp)
    jraw, jmask = js.prepare_logits(jnp.asarray(x), counts=jcounts,
                                    mode=jsp.mode(), **jsp.as_arrays(B))
    traw, tmask = ts.prepare_logits(torch.from_numpy(x), counts=tcounts,
                                    mode=tsp.mode(), **tsp.as_arrays(B))
    np.testing.assert_allclose(traw.numpy(), np.asarray(jraw), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(np.isinf(tmask.numpy()),
                                  np.isinf(np.asarray(jmask)))
    keep = ~np.isinf(np.asarray(jmask))
    np.testing.assert_allclose(tmask.numpy()[keep], np.asarray(jmask)[keep],
                               rtol=1e-6, atol=1e-6)


def test_greedy_and_eos_threshold_match_jax():
    x = logits_np(seed=3)
    B = x.shape[0]
    x[1, 7] = 30.0                   # row 1: EOS probability ~1
    for kw in (dict(temperature=0.0),
               dict(temperature=0.0, eos_token_id=7, eos_threshold=0.5)):
        jsp, tsp = js.SamplingParams(**kw), ts.SamplingParams(**kw)
        ref = js.sample(jnp.asarray(x), jax.random.key(0), mode=jsp.mode(),
                        **jsp.as_arrays(B))
        out = ts.sample(torch.from_numpy(x), None, mode=tsp.mode(),
                        **tsp.as_arrays(B))
        assert out.tolist() == np.asarray(ref).tolist()


def test_hit_stop_and_bump_counts():
    tok = torch.tensor([3, 5, 7, 9], dtype=torch.int32)
    stops = torch.tensor([[5, -1], [-1, -1], [9, 7], [-1, -1]],
                         dtype=torch.int32)
    eos = torch.tensor([3, 3, -1, -1], dtype=torch.int32)
    assert ts.hit_stop(tok, eos, stops).tolist() == [True, False, True,
                                                     False]
    counts = torch.zeros((4, 10), dtype=torch.int32)
    ts.bump_counts(counts, tok, torch.tensor([1, 0, 1, 1]))
    assert counts.sum().item() == 3 and counts[0, 3] == 1


def test_sampled_tokens_follow_the_filtered_distribution():
    """Draws from the port's ``sample`` and from the JAX package's follow
    softmax(masked logits), within 5 sigma of a binomial proportion."""
    V, n = 12, 20000
    x = np.random.default_rng(4).normal(size=(1, V)).astype(np.float32)
    sp = ts.SamplingParams(temperature=0.8, top_k=6, top_p=0.9)
    _, masked = ts.prepare_logits(torch.from_numpy(x), mode=sp.mode(),
                                  **sp.as_arrays(1))
    want = torch.softmax(masked, -1)[0].numpy()
    gen = torch.Generator().manual_seed(0)
    xs = torch.from_numpy(np.repeat(x, n, axis=0))
    toks = ts.sample(xs, gen, mode=sp.mode(), **sp.as_arrays(n)).numpy()
    jsp = js.SamplingParams(temperature=0.8, top_k=6, top_p=0.9)
    jtoks = np.asarray(js.sample(jnp.asarray(xs), jax.random.key(0),
                                 mode=jsp.mode(), **jsp.as_arrays(n)))
    for draws in (toks, jtoks):
        freq = np.bincount(draws, minlength=V) / n
        assert (freq[want == 0] == 0).all()
        np.testing.assert_allclose(freq, want, atol=5 * np.sqrt(0.25 / n))
