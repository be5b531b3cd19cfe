"""The model families past Llama in the PyTorch port, against the JAX
package and the HF forward: the port's versions of JAX
``tests/test_gemma.py``, ``tests/test_qwen_mistral.py`` and the
``longrope`` case of ``tests/test_phi3.py``, plus one scheduler parity
plan over ``gemma2-tiny`` and a w8a8 ``gemma3-tiny`` on an INT8 pool.

Tiny HF models are built in code from a seed (the JAX tests' configs)
and converted with the port's ``params_from_hf_*``; the port's forward
through its dense oracle is held to the HF logits within the JAX tests'
``atol=5e-3, rtol=5e-2`` (0.05 for the bf16 streaming import) and to the
JAX forward on the JAX converter's params within 1e-4. Gemma-3's
dual-theta RoPE (the windowed layers on a second, unscaled table) and
Phi-3's ``longrope`` tables (long factors iff the table is longer than
``original_max_position_embeddings``) match the JAX ones on both sides
of the switch.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pagedattention_based_transformer_decoder_inference_framework_tpu import config as jconfig
from pagedattention_based_transformer_decoder_inference_framework_tpu.engine import (
    Engine as JaxEngine, SamplingParams as JaxSampling)
from pagedattention_based_transformer_decoder_inference_framework_tpu.engine.backends import (
    DenseKVBackend as JaxDense)
from pagedattention_based_transformer_decoder_inference_framework_tpu.models import (
    hf_import as jimport, model as jmodel)
from pagedattention_based_transformer_decoder_inference_framework_tpu.ops import rope as jrope
from pagedattention_based_transformer_decoder_inference_framework_tpu.scheduler import (
    Scheduler as JaxScheduler)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch import config as tconfig
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.engine import (
    DenseKVBackend, Engine, PagedKVBackend, SamplingParams)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.models import (
    hf_import as timport, hf_stream as tstream, model as tmodel)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.ops import rope as trope
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.scheduler import (
    Scheduler)

from test_torch_model import model_cfgs
from test_torch_scheduler import run_schedule

transformers = pytest.importorskip("transformers")

HF_TOL = dict(atol=5e-3, rtol=5e-2)
GREEDY = SamplingParams(temperature=0.0, eos_token_id=-1)
JGREEDY = JaxSampling(temperature=0.0, eos_token_id=-1)

#: the JAX tests' tiny geometries (``tests/test_gemma.py``: window 8 < the
#: sequences, ``query_pre_attn_scalar`` != head_dim)
GEMMA2 = dict(
    vocab_size=257, hidden_size=64, num_layers=4, num_heads=4,
    num_kv_heads=2, head_dim=16, intermediate_size=128, max_seq_len=96,
    norm="rmsnorm", norm_eps=1e-6, activation="geglu", position="rope",
    rope_theta=10000.0, use_qkv_bias=False, use_mlp_bias=False,
    tie_embeddings=True, sliding_window=8, sliding_window_pattern=2,
    rms_offset=1.0, post_norms=True, scale_embeddings=True,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    query_pre_attn_scalar=32.0, dtype="float32")
GEMMA3 = dict(GEMMA2, rope_theta=100000.0, rope_local_theta=10000.0,
              attn_logit_softcap=0.0, final_logit_softcap=0.0, qk_norm=True)
LLAMA3 = dict(
    vocab_size=257, hidden_size=64, num_layers=3, num_heads=4,
    num_kv_heads=2, head_dim=16, intermediate_size=128, max_seq_len=96,
    norm="rmsnorm", norm_eps=1e-5, activation="swiglu", position="rope",
    rope_theta=10000.0, use_qkv_bias=False, use_mlp_bias=False,
    tie_embeddings=False, dtype="float32")
SHORT = [1.0 + 0.1 * i for i in range(8)]     # longrope: head_dim/2 = 8
LONG = [2.0 + 0.3 * i for i in range(8)]
LONGROPE = {"rope_type": "longrope", "short_factor": SHORT,
            "long_factor": LONG, "original_max_position_embeddings": 16,
            "max_position_embeddings": 96}


def pair(**kw):
    """The same ModelConfig in both packages."""
    return (jconfig.ModelConfig(name="test", **kw).validate(),
            tconfig.ModelConfig(name="test", **kw).validate())


def hf_gemma2():
    torch.manual_seed(0)
    return transformers.Gemma2ForCausalLM(transformers.Gemma2Config(
        vocab_size=257, hidden_size=64, intermediate_size=128,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, max_position_embeddings=96, rms_norm_eps=1e-6,
        rope_theta=10000.0, attention_bias=False, tie_word_embeddings=True,
        query_pre_attn_scalar=32, sliding_window=8,
        attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
        hidden_activation="gelu_pytorch_tanh",
        attn_implementation="eager")).eval()


def hf_gemma3():
    torch.manual_seed(0)
    return transformers.Gemma3ForCausalLM(transformers.Gemma3TextConfig(
        vocab_size=257, hidden_size=64, intermediate_size=128,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, max_position_embeddings=96, rms_norm_eps=1e-6,
        rope_theta=100000.0, rope_local_base_freq=10000.0,
        attention_bias=False, tie_word_embeddings=True,
        query_pre_attn_scalar=32, sliding_window=8,
        sliding_window_pattern=2, hidden_activation="gelu_pytorch_tanh",
        attn_implementation="eager")).eval()


def hf_qwen2():
    torch.manual_seed(0)
    m = transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
        vocab_size=257, hidden_size=64, intermediate_size=128,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=96, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=False, attn_implementation="eager",
        use_sliding_window=False, pad_token_id=0)).eval()
    with torch.no_grad():          # HF zero-inits biases: make them count
        for layer in m.model.layers:
            for proj in (layer.self_attn.q_proj, layer.self_attn.k_proj,
                         layer.self_attn.v_proj):
                proj.bias.normal_(0.0, 0.5)
    return m


def hf_mistral():
    torch.manual_seed(1)
    return transformers.MistralForCausalLM(transformers.MistralConfig(
        vocab_size=257, hidden_size=64, intermediate_size=128,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=96, rms_norm_eps=1e-5, rope_theta=10000.0,
        sliding_window=8, tie_word_embeddings=False,
        attn_implementation="eager", pad_token_id=0)).eval()


def hf_phi3_longrope():
    torch.manual_seed(0)
    return transformers.Phi3ForCausalLM(transformers.Phi3Config(
        vocab_size=257, hidden_size=64, intermediate_size=128,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4,
        max_position_embeddings=96, original_max_position_embeddings=16,
        rms_norm_eps=1e-5, rope_theta=10000.0, sliding_window=None,
        rope_scaling={"type": "longrope", "short_factor": SHORT,
                      "long_factor": LONG},
        tie_word_embeddings=False, attn_implementation="eager",
        pad_token_id=0)).eval()


def forwards(jc, tc, jp, tp, tokens):
    """Both packages' forwards through their dense oracles (f32 KV)."""
    pos = np.broadcast_to(np.arange(tokens.shape[1]), tokens.shape)
    jd, td = JaxDense(jc, "float32"), DenseKVBackend(tc, "float32")
    jl, _ = jmodel.DecoderModel(jc).forward(
        jp, jnp.asarray(tokens), jnp.asarray(pos),
        jd.init_cache(tokens.shape[0], jc.max_seq_len), jd.attn_fn)
    tl, _ = tmodel.DecoderModel(tc).forward(
        tp, torch.from_numpy(tokens), torch.from_numpy(pos.copy()),
        td.init_cache(tokens.shape[0], tc.max_seq_len), td.attn_fn)
    return np.asarray(jl), tl.numpy()


CASES = {
    # name: (HF model, geometry, converter, sequence length)
    "gemma2": (hf_gemma2, GEMMA2, "gemma2", 17),
    "gemma3": (hf_gemma3, GEMMA3, "gemma3", 17),
    "qwen2": (hf_qwen2, dict(LLAMA3, use_qkv_bias=True), "llama", 17),
    "mistral": (hf_mistral, dict(LLAMA3, sliding_window=8), "llama", 23),
    "phi3-longrope": (hf_phi3_longrope,
                      dict(LLAMA3, num_kv_heads=4, rope_scaling=LONGROPE),
                      "phi3", 20),
}


@pytest.mark.parametrize("name", list(CASES))
def test_parity_vs_hf_and_jax(name):
    """JAX ``test_gemma2_parity_vs_hf``, ``test_gemma3_parity_vs_hf``,
    ``test_qwen2_parity_vs_hf``, ``test_mistral_parity_vs_hf`` (the window
    of 8 inside 23 tokens) and ``test_phi3_longrope_parity`` (20 tokens
    past ``original_max_position_embeddings`` 16, so HF takes the long
    factors too) on the port. Windowed families run unrolled layers,
    as JAX's per-layer windows need."""
    make, geo, conv, T = CASES[name]
    hf = make()
    jc, tc = pair(**geo)
    sd = hf.state_dict()
    jp = getattr(jimport, f"params_from_hf_{conv}")(sd, jc,
                                                     dtype=jnp.float32)
    tp = getattr(timport, f"params_from_hf_{conv}")(sd, tc,
                                                     dtype=torch.float32)
    if jc.sliding_window_pattern > 1:
        jp, tp = jmodel.unstack_layers(jp), tmodel.unstack_layers(tp)
    if conv == "llama" and jc.use_qkv_bias:
        assert float(tp["layers"]["bq"].abs().max()) > 0
    tokens = np.random.default_rng(0).integers(0, 257, size=(2, T))
    with torch.no_grad():
        ref = hf(torch.tensor(tokens)).logits.numpy()
    jl, tl = forwards(jc, tc, jp, tp, tokens)
    np.testing.assert_allclose(tl, ref, **HF_TOL)
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["gemma2", "gemma3"])
def test_gemma_hf_streaming_import(name, tmp_path):
    """JAX ``test_gemma{2,3}_hf_streaming_import``: ``config_from_hf`` and
    the bf16 streamed import reproduce the HF forward (0.05: bf16
    weights)."""
    make = CASES[name][0]
    hf = make()
    hf.save_pretrained(tmp_path / name, safe_serialization=True)
    cfg = tstream.config_from_hf(str(tmp_path / name), name="test")
    assert cfg.activation == "geglu" and cfg.post_norms
    assert cfg.sliding_window == 8 and cfg.sliding_window_pattern == 2
    assert cfg.qk_norm == (name == "gemma3")
    assert cfg.rope_local_theta == (10000.0 if name == "gemma3" else 0.0)
    cfg.dtype = "float32"
    params = tmodel.unstack_layers(tstream.load_flat_params(
        tstream.import_hf_streaming(str(tmp_path / name), cfg),
        dtype=torch.float32))
    tokens = np.random.default_rng(1).integers(0, 257, size=(1, 13))
    with torch.no_grad():
        ref = hf(torch.tensor(tokens)).logits.numpy()
    d = DenseKVBackend(cfg, "float32")
    out, _ = tmodel.DecoderModel(cfg).forward(
        params, torch.from_numpy(tokens), torch.arange(13)[None],
        d.init_cache(1, cfg.max_seq_len), d.attn_fn)
    np.testing.assert_allclose(out.numpy(), ref, atol=0.05, rtol=5e-2)


@pytest.mark.parametrize("side", ["short", "long"])
def test_longrope_tables_match_jax(side):
    """The static long/short choice on the table's length: 16 rows (not
    past ``original_max_position_embeddings``) take the short factors,
    96 the long ones; both scaled by sqrt(1 + log(96/16) / log(16))."""
    n = 16 if side == "short" else 96
    jc, js = jrope.rope_table(n, 16, 10000.0, scaling=LONGROPE)
    tc, ts = trope.rope_table(n, 16, 10000.0, scaling=LONGROPE)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    plain_c, plain_s = trope.rope_table(n, 16, 10000.0)
    mscale = float(np.sqrt(1 + np.log(6.0) / np.log(16.0)))
    assert float(tc[0, 0]) == pytest.approx(mscale, rel=1e-6)
    f = np.asarray(SHORT if side == "short" else LONG, np.float32)
    inv = 1.0 / (10000.0 ** (np.arange(8, dtype=np.float32) / 8)) / f
    np.testing.assert_allclose(tc[5].numpy(), mscale * np.cos(5 * inv),
                               atol=1e-5)
    assert not torch.allclose(tc, plain_c * mscale)


def test_dual_theta_tables_and_stacked_layers():
    """The windowed layers take the ``rope_local_theta`` table, unscaled
    even where the global one is scaled, the global layers the global
    one; stacked layers raise the JAX package's ``ValueError``."""
    jc, tc = pair(**dict(GEMMA3, rope_scaling={"rope_type": "linear",
                                               "factor": 8.0}))
    m = tmodel.DecoderModel(tc, rope_len=64)
    glob, loc = m.rope("cpu"), m.rope_local("cpu")
    jm = jmodel.DecoderModel(jc, rope_len=64)
    for a, b in zip(glob + loc, jm.rope() + jm.rope_local()):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    want_loc = trope.rope_table(64, 16, 10000.0)
    assert all(torch.equal(a, b) for a, b in zip(loc, want_loc))
    for layer in range(4):
        got = m._rope_for_layer(layer, glob, loc)
        assert got is (loc if tc.window_for_layer(layer) else glob)
    assert tmodel.DecoderModel(pair(**GEMMA2)[1]).rope_local("cpu") is None
    tp = tmodel.init_params(tc, torch.Generator().manual_seed(0))
    d = DenseKVBackend(tc, "float32")
    with pytest.raises(ValueError, match="rope_local_theta needs the "
                       "unrolled layer loop"):
        m.forward(tp, torch.zeros((1, 3), dtype=torch.long),
                  torch.arange(3)[None], d.init_cache(1, 8), d.attn_fn)
    jp = jmodel.init_params(jc, jax.random.key(0))
    jd = JaxDense(jc, "float32")
    with pytest.raises(ValueError, match="rope_local_theta needs the "
                       "unrolled layer loop"):
        jm.forward(jp, jnp.zeros((1, 3), jnp.int32), jnp.arange(3)[None],
                   jd.init_cache(1, 8), jd.attn_fn)


def test_gemma2_paged_vs_dense_backend():
    """JAX ``test_gemma2_paged_vs_dense_backend`` on the port: softcap
    and per-layer windows through the paged backend's plain versions
    against the dense oracle, a 41-token prefill past the window of 32,
    then a decode step."""
    cfg = tconfig.preset("gemma2-tiny")
    cfg.dtype = "float32"
    model = tmodel.DecoderModel(cfg)
    params = tmodel.unstack_layers(
        tmodel.init_params(cfg, torch.Generator().manual_seed(0)))
    B, T, n_pages = 2, 41, 8
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, T)))
    pos = torch.arange(T).expand(B, T)
    dense = DenseKVBackend(cfg, "float32")
    dl, dkv = model.forward(params, tokens, pos, dense.init_cache(B, 64),
                            dense.attn_fn)
    paged = PagedKVBackend(cfg, tconfig.CacheConfig(
        page_size=8, num_pages=32, max_pages_per_seq=n_pages,
        kv_dtype="float32"))
    bt = torch.arange(1, B * n_pages + 1, dtype=torch.int32).reshape(
        B, n_pages)
    sl = torch.full((B,), T, dtype=torch.int32)
    pl, pkv = model.forward(params, tokens, pos, paged.init_cache("cpu"),
                            paged.make_attn_fn(bt, sl, torch.zeros_like(sl)))
    torch.testing.assert_close(pl, dl, atol=1e-4, rtol=1e-4)
    tok = pl[:, -1:].argmax(-1)
    pos1 = torch.full((B, 1), T)
    dl2, _ = model.forward(params, tok, pos1, dkv, dense.attn_fn)
    pl2, _ = model.forward(params, tok, pos1, pkv,
                           paged.make_attn_fn(bt, sl + 1, sl))
    torch.testing.assert_close(pl2, dl2, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", ["gemma2-tiny", "gemma3-tiny"])
def test_gemma_engine_generate_matches_jax(name):
    """JAX ``test_gemma{2,3}_engine_generate`` against the JAX engine on
    bridged f32 weights: a prompt past the 32-token window, ``generate``
    equal to the fused loop and to the JAX engine's, every page back."""
    fws = []
    for mod in (jconfig, tconfig):
        fw = mod.FrameworkConfig(
            model=mod.preset(name),
            cache=mod.CacheConfig(page_size=8, num_pages=128,
                                  max_pages_per_seq=16, kv_dtype="float32"),
            runtime=mod.RuntimeConfig(max_new_tokens=8))
        fw.model.dtype = "float32"
        fws.append(fw)
    jp = jmodel.init_params(fws[0].model, jax.random.key(0))
    je = JaxEngine(fws[0], params=jp, interpret=True)
    te = Engine(fws[1], params=tmodel.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), fws[1].model), device="cpu")
    prompt = [(5 * i + 9) % 500 for i in range(40)]
    a = te.generate(prompt, 6, GREEDY)
    assert a == te.generate_batch_fused([prompt], 6, GREEDY)[0]
    assert a == je.generate(prompt, 6, JGREEDY)
    assert te.allocator.num_free == te.cache.num_pages - 1


def test_qwen_mistral_presets_validate():
    q = tconfig.preset("qwen2-7b")
    assert q.use_qkv_bias and q.num_kv_heads == 4
    q.validate()
    m = tconfig.preset("mistral-7b")
    assert m.sliding_window == 4096
    m.validate()
    assert dataclasses.asdict(q) == dataclasses.asdict(
        jconfig.preset("qwen2-7b"))


# -- the scheduler on these families -------------------------------------------

@pytest.mark.parametrize("name,kv_dtype,quant", [
    ("gemma2-tiny", "float32", "none"), ("gemma3-tiny", "int8", "int8")],
    ids=["gemma2-f32", "gemma3-w8a8-int8kv"])
def test_scheduler_parity(name, kv_dtype, quant):
    """The port's ``Scheduler`` against the JAX one on the same weights
    (the JAX engine's own quantized, fused params under w8a8): arrivals
    mid-decode on two lanes, a pool that forces the youngest request out,
    a resize that grows it back, a prompt past the 32-token window and a
    prefix hit; streams, preemptions and hits identical, no page live
    after."""
    rt = dict(max_new_tokens=8, max_batch_size=2, prefill_chunk=16,
              temperature=0.0, eos_token_id=-1, decode_burst=4,
              decode_burst_max=4)
    jm, tm = model_cfgs(name)
    jm.quant = tm.quant = quant
    cfgs = [mod.FrameworkConfig(
        model=m,
        cache=mod.CacheConfig(page_size=8, num_pages=9, max_pages_per_seq=8,
                              kv_dtype=kv_dtype, enable_prefix_cache=True),
        runtime=mod.RuntimeConfig(**rt))
        for mod, m in ((jconfig, jm), (tconfig, tm))]
    jp = jmodel.init_params(cfgs[0].model, jax.random.key(0))
    je = JaxEngine(cfgs[0], params=jp, interpret=True)
    src = jp if quant == "none" else je.params
    te = Engine(cfgs[1], params=tmodel.params_from_jax(
        jax.tree_util.tree_map(np.asarray, src), cfgs[1].model),
        device="cpu")
    shared = list(range(3, 19))
    plan = [(0, list(range(20, 60)), 10, {}), (0, [2] * 8, 14, {}),
            (3, None, 24, None), (4, shared, 4, {}),
            (8, shared + [5, 6, 7], 6, {})]
    jout = run_schedule(JaxScheduler(je), JaxSampling, plan)
    tout = run_schedule(Scheduler(te), SamplingParams, plan)
    assert tout == jout
    assert tout[1] >= 1 and tout[2] >= 1, tout[1:]
    assert te.allocator.num_live == 0
