"""The PyTorch port's ``Engine`` on ``mixtral-tiny`` (E 4, top-2, f32
model dtype) against the JAX package's ``Engine(cfg, interpret=True)``,
greedy, with the weights bridged from the JAX engine's own params
(quantized, unstacked, fused ``we_gu``; INT4 repacks the attention and
the head and keeps the experts INT8): ``generate_batch_fused``,
``generate_batch`` and ``generate`` must give the JAX package's token
streams under ``none``, ``int8-weight``, ``int8`` (w8a8) and ``int4``.
Prompts of 19 and 5 tokens prefill in chunks of 16 (the masked expert
loop); a 300-token prompt beside a short one prefills at chunk 256,
where the routed slots (2 x 256 x 2 = 1024 = E x 256) take the sorted
dispatch through B13's plain version, and at chunk 32, where they do
not (``tests/test_moe.py::test_moe_engine_prefill_uses_dispatch_path``).
A ``megakernel=True`` engine has no chain for MoE and runs per-op, as in
the JAX package.
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
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.models import (
    params_from_jax,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.ops import gmm

PROMPTS = [[(7 * i + 3) % 500 for i in range(19)], [5, 9, 3, 14, 2]]
LONG = [np.random.default_rng(0).integers(0, 512, size=300).tolist(),
        [5, 9, 3]]
NEW = 6
JS = JaxSampling(temperature=0.0, eos_token_id=-1)
TS = SamplingParams(temperature=0.0, eos_token_id=-1)


def frameworks(quant, chunk=16, **runtime):
    out = []
    for mod in (jconfig, tconfig):
        m = mod.preset("mixtral-tiny")
        # 512 positions: the 300-token prompt's RoPE rows exist (past the
        # preset's 256 the JAX table clamps and the port's raises)
        m.dtype, m.quant, m.max_seq_len = "float32", quant, 512
        out.append(mod.FrameworkConfig(
            model=m,
            cache=mod.CacheConfig(page_size=8, num_pages=128,
                                  max_pages_per_seq=48,
                                  kv_dtype="float32" if quant == "none"
                                  else "int8"),
            runtime=mod.RuntimeConfig(max_new_tokens=NEW,
                                      prefill_chunk=chunk, **runtime)))
    return out


def pair(quant, chunk=16, **runtime):
    jcfg, tcfg = frameworks(quant, chunk, **runtime)
    je = JaxEngine(jcfg, interpret=True)
    te = Engine(tcfg, params=params_from_jax(
        jax.tree_util.tree_map(np.asarray, je.params), tcfg.model),
        device="cpu")
    return je, te


@pytest.fixture(scope="module", params=["none", "int8-weight", "int8",
                                        "int4"])
def engines(request):
    return pair(request.param)


def test_generate_batch_fused_matches_jax(engines):
    je, te = engines
    assert te.generate_batch_fused(PROMPTS, NEW, TS) == \
        je.generate_batch_fused(PROMPTS, NEW, JS)
    assert te.allocator.num_free == te.cache.num_pages - 1


def test_generate_batch_matches_jax(engines):
    je, te = engines
    assert te.generate_batch(PROMPTS, NEW, TS) == \
        je.generate_batch(PROMPTS, NEW, JS)


def test_generate_matches_jax(engines):
    je, te = engines
    assert te.generate(PROMPTS[0], NEW, TS) == je.generate(PROMPTS[0], NEW,
                                                           JS)


@pytest.mark.parametrize("quant", ["none", "int8-weight"])
def test_long_prefill_takes_the_dispatch_and_matches_jax(monkeypatch,
                                                         quant):
    """At chunk 256 the 300-token prompt's first chunk takes the sorted
    dispatch (two B13 calls a layer on the fused ``we_gu``, then
    ``we_down``) and its second the masked loop; at chunk 32 no chunk
    dispatches. Both streams equal the JAX engine's at the same chunk,
    and each other's."""
    calls = []
    real = gmm.grouped_matmul

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)
    monkeypatch.setattr(gmm, "grouped_matmul", counted)
    je, te = pair(quant, chunk=256)
    out = te.generate_batch(LONG, NEW, TS)
    assert len(calls) == 2 * te.cfg.num_layers
    assert out == je.generate_batch(LONG, NEW, JS)
    jcfg, tcfg = frameworks(quant, chunk=32)
    te32 = Engine(tcfg, params=te.params, device="cpu")
    calls.clear()
    assert te32.generate_batch(LONG, NEW, TS) == out
    assert calls == []
    assert te.generate_batch_fused(LONG, NEW, TS) == \
        je.generate_batch_fused(LONG, NEW, JS)


def test_megakernel_engine_runs_per_op():
    """MoE has no chain: ``megakernel=True`` packs none and the streams
    are the per-op engine's and the JAX megakernel engine's."""
    je, te = pair("int8-weight", megakernel=True)
    assert "chains" not in te.params
    out = te.generate_batch_fused(PROMPTS, NEW, TS)
    assert out == je.generate_batch_fused(PROMPTS, NEW, JS)
    _, tcfg = frameworks("int8-weight")
    assert Engine(tcfg, params=te.params, device="cpu").generate_batch_fused(
        PROMPTS, NEW, TS) == out
