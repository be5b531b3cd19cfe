"""The PyTorch port's ``Engine`` against the JAX package's
``Engine(cfg, interpret=True)``, greedy: ``generate_batch_fused``,
``generate`` and ``prefill`` + ``decode`` must give identical token
streams, on ``llama-tiny`` and on a narrow dh=128 / G=4 config, with
f32 and INT8 KV. The port runs with ``device="cpu"`` (the kernels' plain
versions); the weights come through ``params_from_jax``.
"""

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
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch import config as tconfig
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.engine import (
    Engine,
    SamplingParams,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.models import (
    params_from_jax,
)

from test_torch_model import model_cfgs

# a 19-token prompt spans two prefill chunks of 16 (the second one
# page-aligned and padded); the short one ends inside the first chunk
PROMPTS = [[(7 * i + 3) % 500 for i in range(19)], [5, 9, 3, 14, 2]]
NEW = 6


def frameworks(name, kv_dtype):
    jm, tm = model_cfgs(name)
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
    ("narrow-dh128", "float32"), ("narrow-dh128", "int8")],
    ids=lambda p: "-".join(p))
def engines(request):
    jcfg, tcfg = frameworks(*request.param)
    jp = jax_init_params(jcfg.model, jax.random.key(0))
    je = JaxEngine(jcfg, params=jp, interpret=True)
    te = Engine(tcfg, params=params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), tcfg.model), device="cpu")
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
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), atol=1e-5,
                                   rtol=1e-5)
    te.free(tst)
    je.free(jst)


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
    _, tcfg = frameworks("llama-tiny", "float32")
    tcfg.model.quant = "int8"
    with pytest.raises(NotImplementedError, match="next slice"):
        Engine(tcfg, device="cpu")


def test_engine_without_device_raises_on_cpu_only_host(monkeypatch):
    _, tcfg = frameworks("llama-tiny", "float32")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(tcfg)
