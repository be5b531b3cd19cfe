"""The PyTorch port's model against the JAX package's, through the weight
bridge (``params_from_jax``): config presets, the numeric building
blocks, and ``DecoderModel.forward`` with the dense and the paged KV
backends, on ``llama-tiny`` (dh=16, stored in a pool padded to 128) and
on a narrow dh=128, G=4, 2-layer config. f32 model dtype. Logits: atol
1e-4 with f32 KV; with INT8 KV atol 5e-3 / rtol 5e-2, the tolerance of
``tests/test_model_parity.py``, since an INT8 rounding flip between the
two frameworks' k values is possible.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pagedattention_based_transformer_decoder_inference_framework_tpu import config as jconfig
from pagedattention_based_transformer_decoder_inference_framework_tpu.engine.backends import (
    DenseKVBackend as JaxDense,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu.engine.paged_backend import (
    PagedKVBackend as JaxPaged,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu.models import model as jmodel
from pagedattention_based_transformer_decoder_inference_framework_tpu.ops import common as jcommon
from pagedattention_based_transformer_decoder_inference_framework_tpu.ops import rope as jrope
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch import config as tconfig
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.engine import (
    DenseKVBackend,
    PagedKVBackend,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.models import model as tmodel
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.ops import common as tcommon
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.ops import rope as trope

PAGE = 8


def narrow_dh128(mod):
    """2-layer Llama-style config at the slice's head geometry (dh=128,
    G=4) and narrow widths."""
    return mod.ModelConfig(
        name="narrow-dh128", vocab_size=512, hidden_size=128, num_layers=2,
        num_heads=8, num_kv_heads=2, head_dim=128, intermediate_size=256,
        max_seq_len=256, norm="rmsnorm", activation="swiglu",
        position="rope", use_qkv_bias=False, use_mlp_bias=False,
        tie_embeddings=False, rope_theta=500000.0, eos_token_id=-1,
        dtype="float32")


def model_cfgs(name):
    if name == "narrow-dh128":
        return narrow_dh128(jconfig), narrow_dh128(tconfig)
    j, t = jconfig.preset(name), tconfig.preset(name)
    j.dtype = t.dtype = "float32"
    return j, t


def test_presets_match_jax():
    assert sorted(tconfig.PRESETS) == sorted(jconfig.PRESETS)
    for name, j in jconfig.PRESETS.items():
        assert dataclasses.asdict(tconfig.PRESETS[name]) == \
            dataclasses.asdict(j), name
    assert dataclasses.asdict(tconfig.FrameworkConfig()) == \
        dataclasses.asdict(jconfig.FrameworkConfig())


def test_norms_and_activations_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    s = rng.normal(size=(64,)).astype(np.float32)
    b = rng.normal(size=(64,)).astype(np.float32)
    tx, ts, tb = map(torch.from_numpy, (x, s, b))
    close = dict(atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        tcommon.rmsnorm(tx, ts, 1e-5, offset=1.0).numpy(),
        np.asarray(jcommon.rmsnorm(jnp.asarray(x), jnp.asarray(s), 1e-5,
                                   offset=1.0)), **close)
    np.testing.assert_allclose(
        tcommon.layernorm(tx, ts, tb).numpy(),
        np.asarray(jcommon.layernorm(jnp.asarray(x), jnp.asarray(s),
                                     jnp.asarray(b))), **close)
    for act in ("relu", "gelu", "silu"):
        np.testing.assert_allclose(
            tcommon.activation_fn(act)(tx).numpy(),
            np.asarray(jcommon.activation_fn(act)(jnp.asarray(x))), **close)
    np.testing.assert_allclose(
        tcommon.stable_softmax(tx).numpy(),
        np.asarray(jcommon.stable_softmax(jnp.asarray(x))), **close)


@pytest.mark.parametrize("scaling", [
    None,
    {"rope_type": "linear", "factor": 8.0},
    {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
     "high_freq_factor": 4.0, "original_max_position_embeddings": 64},
])
def test_rope_matches_jax(scaling):
    jc, js = jrope.rope_table(128, 32, 500000.0, scaling=scaling)
    tc, ts = trope.rope_table(128, 32, 500000.0, scaling=scaling)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 4, 3, 32)).astype(np.float32)
    pos = np.asarray([[0, 5, 127, -1], [3, -1, -1, -1]])   # -1: padding
    out = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           tc, ts)
    ref = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), jc, js)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_init_params_layout_matches_jax():
    jc, tc = model_cfgs("llama-tiny")
    jp = jmodel.init_params(jc, jax.random.key(0))
    tp = tmodel.init_params(tc, torch.Generator().manual_seed(0))
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in jflat:
        keys = [p.key for p in path]
        t = tp
        for k in keys:
            t = t[k]
        assert tuple(t.shape) == leaf.shape and str(t.dtype) == \
            f"torch.{leaf.dtype}", keys
        if keys[-1].endswith("scale"):
            assert torch.all(t == 1)


def bridged(name):
    jc, tc = model_cfgs(name)
    jp = jmodel.init_params(jc, jax.random.key(0))
    tp = tmodel.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tc)
    return jc, tc, jp, tp


def engine_layout(jp, tp):
    return (jmodel.fuse_projections(jmodel.unstack_layers(jp)),
            tmodel.fuse_projections(tmodel.unstack_layers(tp)))


@pytest.mark.parametrize("name", ["llama-tiny", "narrow-dh128"])
def test_forward_dense_backend_matches_jax(name):
    jc, tc, jp, tp = bridged(name)
    rng = np.random.default_rng(2)
    B, T = 2, 7
    tokens = rng.integers(0, jc.vocab_size, size=(B, T))
    pos = np.broadcast_to(np.arange(T), (B, T))
    jd, td = JaxDense(jc, "float32"), DenseKVBackend(tc, "float32")
    jl, _ = jmodel.DecoderModel(jc).forward(
        jp, jnp.asarray(tokens), jnp.asarray(pos), jd.init_cache(B, 32),
        jd.attn_fn)
    tl, _ = tmodel.DecoderModel(tc).forward(
        tp, torch.from_numpy(tokens), torch.from_numpy(pos.copy()),
        td.init_cache(B, 32), td.attn_fn)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
@pytest.mark.parametrize("name", ["llama-tiny", "narrow-dh128"])
def test_forward_paged_backend_matches_jax(name, kv_dtype):
    """A page-aligned prefill chunk with a ragged prompt (-1 padding),
    then two decode steps, through the engine's unrolled + fused layout."""
    jc, tc, jp, tp = bridged(name)
    jp, tp = engine_layout(jp, tp)
    jcache = jconfig.CacheConfig(page_size=PAGE, num_pages=32,
                                 max_pages_per_seq=4, kv_dtype=kv_dtype)
    tcache = tconfig.CacheConfig(page_size=PAGE, num_pages=32,
                                 max_pages_per_seq=4, kv_dtype=kv_dtype)
    jb, tb = JaxPaged(jc, jcache, interpret=True), PagedKVBackend(tc, tcache)
    jm, tm = jmodel.DecoderModel(jc), tmodel.DecoderModel(tc)
    tol = (dict(atol=1e-4, rtol=1e-4) if kv_dtype == "float32"
           else dict(atol=5e-3, rtol=5e-2))
    rng = np.random.default_rng(3)
    B, T = 2, 2 * PAGE
    lens = np.asarray([T, 11], np.int32)
    bt = np.asarray([[3, 7, 1, 9], [5, 2, 8, 4]], np.int32)
    tokens = rng.integers(0, jc.vocab_size, size=(B, T))
    pos = np.broadcast_to(np.arange(T), (B, T))
    pos = np.where(pos < lens[:, None], pos, -1)
    jkv, tkv = jb.init_cache(), tb.init_cache("cpu")
    j_attn = jb.make_attn_fn(jnp.asarray(bt), jnp.asarray(lens),
                             jnp.zeros((B,), jnp.int32))
    t_attn = tb.make_attn_fn(torch.from_numpy(bt), torch.from_numpy(lens),
                             torch.zeros((B,), dtype=torch.int32))
    jl, jkv = jm.forward(jp, jnp.asarray(tokens), jnp.asarray(pos), jkv,
                         j_attn)
    tl, tkv = tm.forward(tp, torch.from_numpy(tokens), torch.from_numpy(pos),
                         tkv, t_attn)
    rows = np.arange(B)
    np.testing.assert_allclose(tl.numpy()[rows, lens - 1],
                               np.asarray(jl)[rows, lens - 1], **tol)
    sl = lens.copy()
    tok = np.asarray(jl)[rows, lens - 1].argmax(-1)
    for _ in range(2):
        j_attn = jb.make_attn_fn(jnp.asarray(bt), jnp.asarray(sl + 1),
                                 jnp.asarray(sl))
        t_attn = tb.make_attn_fn(torch.from_numpy(bt),
                                 torch.from_numpy(sl + 1),
                                 torch.from_numpy(sl))
        jl, jkv = jm.forward(jp, jnp.asarray(tok)[:, None],
                             jnp.asarray(sl)[:, None], jkv, j_attn)
        tl, tkv = tm.forward(tp, torch.from_numpy(tok)[:, None],
                             torch.from_numpy(sl)[:, None], tkv, t_attn)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
        tok = np.asarray(jl)[:, 0].argmax(-1)
        sl = sl + 1


def test_stacked_forward_equals_unrolled_fused():
    _, tc, _, tp = bridged("llama-tiny")
    _, tp_fused = engine_layout(jmodel.init_params(
        model_cfgs("llama-tiny")[0], jax.random.key(0)), tp)
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(0, tc.vocab_size, size=(2, 5)))
    pos = torch.arange(5).expand(2, 5)
    d = DenseKVBackend(tc, "float32")
    m = tmodel.DecoderModel(tc)
    a, _ = m.forward(tp, tokens, pos, d.init_cache(2, 16), d.attn_fn)
    b, _ = m.forward(tp_fused, tokens, pos, d.init_cache(2, 16), d.attn_fn)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
