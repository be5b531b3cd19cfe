"""The PyTorch port's ``Engine`` against the JAX package's
``Engine(cfg, interpret=True)``, greedy: ``generate_batch_fused``,
``generate`` and ``prefill`` + ``decode`` must give identical token
streams, on ``llama-tiny`` and on a narrow dh=128 / G=4 config, with
f32 and INT8 KV, and on the narrow config with quantized weights
(``quant`` = ``int8`` (w8a8), ``int8-weight``, ``int4``). The port runs
with ``device="cpu"`` (the kernels' plain versions); the weights come
through ``params_from_jax``: the JAX ``init_params`` pytree for float
weights, the JAX engine's own quantized, unstacked and fused params for
the quantized modes. ``score_nll`` and the paged ``ppl_delta_report`` are
held to the JAX package's within 1e-5 and 1e-3 relative (f32 sums in
another order; the JAX report quantizes eagerly, the port as compiled).
With ``PBT_FUSED_APPEND=1`` the decode steps take the fused append +
attention (B9) and the streams stay the JAX package's.
"""

import collections

import numpy as np
import pytest

import jax
import torch

from pagedattention_based_transformer_decoder_inference_framework_tpu import config as jconfig
from pagedattention_based_transformer_decoder_inference_framework_tpu.engine import (
    Engine as JaxEngine,
    SamplingParams as JaxSampling,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu.models.model import (
    init_params as jax_init_params,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu.quant import eval as jeval
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch import config as tconfig
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.engine import (
    Engine,
    SamplingParams,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.models import (
    params_from_jax,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.ops import (
    kv_append as ka,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.quant import eval as teval
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.quant.tensor import (
    Q4Tensor,
    QTensor,
)

from test_torch_model import model_cfgs

# a 19-token prompt spans two prefill chunks of 16 (the second one
# page-aligned and padded); the short one ends inside the first chunk
PROMPTS = [[(7 * i + 3) % 500 for i in range(19)], [5, 9, 3, 14, 2]]
NEW = 6


def frameworks(name, kv_dtype, quant="none"):
    jm, tm = model_cfgs(name)
    jm.quant = tm.quant = quant
    out = []
    for mod, m in ((jconfig, jm), (tconfig, tm)):
        out.append(mod.FrameworkConfig(
            model=m,
            cache=mod.CacheConfig(page_size=8, num_pages=48,
                                  max_pages_per_seq=6, kv_dtype=kv_dtype),
            runtime=mod.RuntimeConfig(max_new_tokens=NEW, prefill_chunk=16)))
    return out


@pytest.fixture(scope="module", params=[
    ("llama-tiny", "float32"), ("llama-tiny", "int8"),
    ("narrow-dh128", "float32"), ("narrow-dh128", "int8"),
    ("narrow-dh128", "int8", "int8"), ("narrow-dh128", "int8", "int8-weight"),
    ("narrow-dh128", "int8", "int4")],
    ids=lambda p: "-".join(p))
def engines(request):
    jcfg, tcfg = frameworks(*request.param)
    jp = jax_init_params(jcfg.model, jax.random.key(0))
    je = JaxEngine(jcfg, params=jp, interpret=True)
    # quantized modes take the JAX engine's own params (quantized,
    # unstacked, fused and, for int4, repacked)
    src = jp if jcfg.model.quant == "none" else je.params
    te = Engine(tcfg, params=params_from_jax(
        jax.tree_util.tree_map(np.asarray, src), tcfg.model), device="cpu")
    return je, te


def greedy_pair():
    return (JaxSampling(temperature=0.0, eos_token_id=-1),
            SamplingParams(temperature=0.0, eos_token_id=-1))


def test_generate_batch_fused_matches_jax(engines):
    je, te = engines
    js, ts = greedy_pair()
    ref = je.generate_batch_fused(PROMPTS, NEW, js)
    out = te.generate_batch_fused(PROMPTS, NEW, ts)
    assert out == ref
    assert te.allocator.num_free == te.cache.num_pages - 1


def test_generate_matches_jax(engines):
    je, te = engines
    js, ts = greedy_pair()
    assert te.generate(PROMPTS[0], NEW, ts) == je.generate(PROMPTS[0], NEW,
                                                           js)


def test_prefill_decode_matches_jax(engines, monkeypatch):
    je, te = engines
    js, ts = greedy_pair()
    chunks = []                      # each prefill chunk's [B, T, V] logits
    forward = te.model.forward

    def recording_forward(*args):
        logits, kv = forward(*args)
        chunks.append(logits)
        return logits, kv

    monkeypatch.setattr(te.model, "forward", recording_forward)
    jst, tst = je.prefill(PROMPTS, sampling=js), te.prefill(PROMPTS,
                                                          sampling=ts)
    monkeypatch.undo()
    T = chunks[0].shape[1]
    last = [len(p) - 1 for p in PROMPTS]
    prefill_logits = np.stack([chunks[i // T][b, i % T].numpy()
                               for b, i in enumerate(last)])
    np.testing.assert_allclose(prefill_logits, jst.prefill_logits,
                               atol=5e-3, rtol=5e-2)
    assert tst.last_tokens.tolist() == jst.last_tokens.tolist()
    for _ in range(3):
        assert te.decode(tst, ts).tolist() == je.decode(jst, js).tolist()
    for a, b in zip(tst.kv, jst.kv):                   # the pools agree
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        if te.cfg.quant == "int4" and a.size == tst.kv[0].numel():
            # the JAX INT4 kernel folds the low nibbles' -8 into a row
            # sum, so its K/V differ from the plain product in the last
            # f32 bits, and a rare INT8 rounding of them flips by one
            assert np.abs(a - b).max() <= 1 and (a != b).mean() < 1e-4
        else:
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
    te.free(tst)
    je.free(jst)


@pytest.mark.parametrize("name,kv_dtype", [("llama-tiny", "float32"),
                                           ("narrow-dh128", "int8")])
def test_fused_append_matches_jax(monkeypatch, name, kv_dtype):
    """``PBT_FUSED_APPEND=1``: every layer of every decode step goes
    through B9's wrapper and never through B2's or B3's. The JAX engine is
    a fresh one, since it reads the variable while it traces; on the f32
    pool it takes its own fused kernel, on the INT8 pool at page 8 its
    gate (a page divisible by INT8's 32-row tile) keeps it unfused, and
    the streams are equal either way."""
    monkeypatch.setenv("PBT_FUSED_APPEND", "1")
    jcfg, tcfg = frameworks(name, kv_dtype)
    jp = jax_init_params(jcfg.model, jax.random.key(0))
    je = JaxEngine(jcfg, params=jp, interpret=True)
    te = Engine(tcfg, params=params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), tcfg.model), device="cpu")
    calls = collections.Counter()

    def counted(key, fn):
        def call(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return call

    for key in ("attend_decode_append", "attend_decode"):
        monkeypatch.setattr(te.backend, key,
                            counted(key, getattr(te.backend, key)))
    monkeypatch.setattr(ka, "append_decode",
                        counted("append_decode", ka.append_decode))
    js, ts = greedy_pair()
    assert te.generate_batch_fused(PROMPTS, NEW, ts) == \
        je.generate_batch_fused(PROMPTS, NEW, js)
    assert calls == {"attend_decode_append":
                     tcfg.model.num_layers * (NEW - 1)}


def test_eos_stops_fused_rows(engines):
    _, te = engines
    _, ts = greedy_pair()
    full = te.generate_batch_fused(PROMPTS, NEW, ts)
    eos = full[0][2]
    ts.eos_token_id = eos
    cut = te.generate_batch_fused(PROMPTS, NEW, ts)
    assert cut[0] == full[0][:full[0].index(eos) + 1]
    assert te.generate(PROMPTS[0], NEW, ts) == cut[0]


def test_engine_rejects_unported_quant():
    """Gemma-3's dual-theta RoPE under w8a8, which this engine once
    refused, now agrees with the JAX engine: ``gemma3-tiny`` on an INT8
    pool with the JAX engine's quantized, fused params, a 40-token prompt
    past the 32-token window, greedy streams identical. The same weights
    with every layer on the global table (``rope_local_theta`` 0) give
    other prefill logits, so the local table reaches the windowed
    layers."""
    jcfg, tcfg = frameworks("gemma3-tiny", "int8", quant="int8")
    assert tcfg.model.rope_local_theta > 0
    je = JaxEngine(jcfg, params=jax_init_params(jcfg.model,
                                                jax.random.key(0)),
                   interpret=True)
    te = Engine(tcfg, params=params_from_jax(
        jax.tree_util.tree_map(np.asarray, je.params), tcfg.model),
        device="cpu")
    prompts = [[(11 * i + 5) % 500 for i in range(40)], PROMPTS[1]]
    js, ts = greedy_pair()
    assert te.generate_batch_fused(prompts, NEW, ts) == \
        je.generate_batch_fused(prompts, NEW, js)
    st = te.prefill(prompts, sampling=ts)
    tcfg.model.rope_local_theta = 0.0
    glob = Engine(tcfg, params=te.params, device="cpu")
    sg = glob.prefill(prompts, sampling=ts)
    assert np.abs(st.prefill_logits - sg.prefill_logits).max() > 1e-2


def test_score_nll_matches_jax(engines):
    je, te = engines
    starts = [3, 1]
    for kw in ({}, {"starts": starts, "mean": False}):
        ref = je.score_nll(PROMPTS, **kw)
        out = te.score_nll(PROMPTS, **kw)
        np.testing.assert_allclose(out, ref, rtol=1e-5)
    assert te.allocator.num_free == te.cache.num_pages - 1


@pytest.mark.parametrize("quant", ["int8", "int8-weight", "int4"])
def test_quantized_engine_weights(quant):
    """The engine's own init: INT8 weights drawn layer by layer, unstacked
    and fused, INT4 repacked; the LM head quantized too."""
    _, tcfg = frameworks("narrow-dh128", "int8", quant=quant)
    te = Engine(tcfg, device="cpu", seed=1)
    kind = Q4Tensor if quant == "int4" else QTensor
    lp = te.params["layers"][0]
    assert isinstance(te.params["layers"], tuple)
    for key in ("w_qkv", "wo", "w_gu", "w_down"):
        assert isinstance(lp[key], kind), key
    assert isinstance(te.params["lm_head"], kind)
    assert te.params["embedding"].dtype == torch.float32
    toks = te.generate_batch_fused(PROMPTS, 3, greedy_pair()[1])
    assert [len(r) for r in toks] == [3, 3]


def test_int4_engine_needs_unrolled_layers():
    _, tcfg = frameworks("narrow-dh128", "int8", quant="int4")
    tcfg.runtime.scan_layers = True
    with pytest.raises(ValueError, match="unrolled"):
        Engine(tcfg, device="cpu")


def test_paged_ppl_delta_report_matches_jax():
    jcfg, tcfg = model_cfgs("llama-tiny")
    jp = jax_init_params(jcfg, jax.random.key(1))
    seqs = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                             (2, 24)).tolist()
    modes = ("int8", "int4")
    ref = jeval.ppl_delta_report(jcfg, jp, seqs, modes=modes,
                                 backend="paged")
    out = teval.ppl_delta_report(
        tcfg, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg),
        seqs, modes=modes, backend="paged", device="cpu")
    assert sorted(out) == sorted(ref)
    for key in ("fp",) + modes:
        np.testing.assert_allclose(out[key], ref[key], rtol=1e-3)


def test_dense_ppl_delta_report_matches_jax():
    jcfg, tcfg = model_cfgs("llama-tiny")
    jp = jax_init_params(jcfg, jax.random.key(2))
    seqs = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                             (2, 12)).tolist()
    ref = jeval.ppl_delta_report(jcfg, jp, seqs)
    out = teval.ppl_delta_report(
        tcfg, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg),
        seqs)
    for key in ("fp", "int8", "int8-weight"):
        np.testing.assert_allclose(out[key], ref[key], rtol=1e-3)
    with pytest.raises(ValueError, match="paged"):
        teval.ppl_delta_report(tcfg, params_from_jax(
            jax.tree_util.tree_map(np.asarray, jp), tcfg), seqs,
            modes=("int4",))


def test_engine_without_device_raises_on_cpu_only_host(monkeypatch):
    _, tcfg = frameworks("llama-tiny", "float32")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(tcfg)


@pytest.mark.parametrize("quant", ["int8", "int8-weight", "int4"])
def test_quantized_engine_without_device_raises_on_cpu_only_host(
        monkeypatch, quant):
    _, tcfg = frameworks("llama-tiny", "float32", quant=quant)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(tcfg)
