"""The port's megakernel engine (``RuntimeConfig.megakernel`` and
``megakernel_drop_weights``) against the JAX package's, greedy: on
``llama-tiny`` (f32, INT8 KV) with params bridged from the JAX megakernel
engine's ``eng.params`` (chains included), ``generate_batch_fused``,
``generate_batch``, ``generate`` and ``generate_batch_spec`` give
identical streams for ``none``, ``int8-weight`` and ``int8`` (w8a8), with
the per-op copies dropped, and for ``none`` and w8a8 also kept (T>1
forwards then run the per-op weights beside the chains); ``score_nll`` within
1e-5 relative (f32 sums in another order). INT4 has no chain variant in
either package; a config the chains do not cover runs per-op in both.
"""

import numpy as np
import pytest

import jax

from pagedattention_based_transformer_decoder_inference_framework_tpu import config as jconfig
from pagedattention_based_transformer_decoder_inference_framework_tpu.engine import (
    Engine as JaxEngine,
    SamplingParams as JaxSampling,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch import config as tconfig
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.engine import (
    Engine,
    SamplingParams,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.models import chained as tchained
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.models import model as tmodel

PROMPTS = [[(7 * i + 3) % 500 for i in range(19)], [5, 9, 3, 14, 2]]
NEW = 6


def frameworks(quant, drop, scan_layers=False):
    out = []
    for mod in (jconfig, tconfig):
        m = mod.preset("llama-tiny")
        m.dtype, m.quant = "float32", quant
        out.append(mod.FrameworkConfig(
            model=m,
            cache=mod.CacheConfig(page_size=8, num_pages=48,
                                  max_pages_per_seq=6, kv_dtype="int8"),
            runtime=mod.RuntimeConfig(max_new_tokens=NEW, prefill_chunk=16,
                                      megakernel=True,
                                      megakernel_drop_weights=drop,
                                      scan_layers=scan_layers)))
    return out


def greedy_pair():
    return (JaxSampling(temperature=0.0, eos_token_id=-1),
            SamplingParams(temperature=0.0, eos_token_id=-1))


@pytest.fixture(scope="module", params=[("none", True), ("int8-weight", True),
                                        ("int8", True), ("none", False),
                                        ("int8", False)],
                ids=lambda p: f"{p[0]}-{'drop' if p[1] else 'keep'}")
def engines(request):
    """The JAX megakernel engine and the port's on its bridged params
    (chains included)."""
    quant, drop = request.param
    jcfg, tcfg = frameworks(quant, drop)
    je = JaxEngine(jcfg, interpret=True, seed=3)
    assert "chains" in je.params
    te = Engine(tcfg, params=tmodel.params_from_jax(
        jax.tree_util.tree_map(np.asarray, je.params), tcfg.model),
        device="cpu")
    assert ("wo" in te.params["layers"][1]) == (not drop)
    return je, te


def test_megakernel_generate_batch_fused_matches_jax(engines):
    je, te = engines
    js, ts = greedy_pair()
    assert te.generate_batch_fused(PROMPTS, NEW, ts) == \
        je.generate_batch_fused(PROMPTS, NEW, js)
    assert te.allocator.num_free == te.cache.num_pages - 1


def test_megakernel_generate_batch_matches_jax(engines):
    je, te = engines
    js, ts = greedy_pair()
    assert te.generate_batch(PROMPTS, NEW, ts) == \
        je.generate_batch(PROMPTS, NEW, js)


def test_megakernel_generate_matches_jax(engines):
    je, te = engines
    js, ts = greedy_pair()
    assert te.generate(PROMPTS[1], NEW, ts) == je.generate(PROMPTS[1], NEW,
                                                           js)


def test_megakernel_spec_matches_jax(engines):
    je, te = engines
    js, ts = greedy_pair()
    assert te.generate_batch_spec(PROMPTS, NEW, ts, spec_k=3) == \
        je.generate_batch_spec(PROMPTS, NEW, js, spec_k=3)


def test_megakernel_score_nll_matches_jax(engines):
    """f32 sums in another order: 1e-5 relative."""
    je, te = engines
    np.testing.assert_allclose(te.score_nll(PROMPTS), je.score_nll(PROMPTS),
                               rtol=1e-5)


def test_megakernel_engine_builds_its_own_chains():
    """From a seed, the port's engine packs and drops as the JAX engine
    does, and the chained decode runs."""
    _, tcfg = frameworks("int8", True)
    te = Engine(tcfg, device="cpu", seed=0)
    assert len(te.params["chains"]) == tcfg.model.num_layers
    assert all("wo" not in lp and "w_gu" not in lp
               for lp in te.params["layers"])
    assert "w_qkv" in te.params["layers"][0]
    _, ts = greedy_pair()
    out = te.generate_batch_fused(PROMPTS, 3, ts)
    assert [len(r) for r in out] == [3, 3]


def test_int4_megakernel_raises():
    jcfg, tcfg = frameworks("int4", False)
    with pytest.raises(ValueError, match="int4"):
        Engine(tcfg, device="cpu")
    with pytest.raises(AssertionError, match="int4"):
        JaxEngine(jcfg, interpret=True)


def test_unsupported_config_runs_per_op():
    """Stacked layers (``scan_layers``): ``chains_supported`` is false, so
    both engines run the per-op path, with equal streams."""
    jcfg, tcfg = frameworks("none", True, scan_layers=True)
    je = JaxEngine(jcfg, interpret=True, seed=3)
    te = Engine(tcfg, params=tmodel.params_from_jax(
        jax.tree_util.tree_map(np.asarray, je.params), tcfg.model),
        device="cpu")
    assert "chains" not in je.params and "chains" not in te.params
    assert not tchained.chains_supported(tcfg.model, te.params)
    js, ts = greedy_pair()
    assert te.generate_batch_fused(PROMPTS, NEW, ts) == \
        je.generate_batch_fused(PROMPTS, NEW, js)
