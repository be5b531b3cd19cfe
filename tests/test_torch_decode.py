"""T=1 decode attention past B2 in the PyTorch port: the grouped (B6),
packed (B8) and batched (B7) kernels' plain versions against the JAX
package's Pallas kernels, the backend's choice between B2, B6 and B8
against the JAX backend's, and greedy engine streams on unpadded pools
(``pad_head_dim=False``) against the JAX engine's.

On the CPU the port's wrappers run their plain versions; the JAX kernels
run in interpret mode, as ``tests/test_paged_attention.py`` runs them.
Inputs come from one numpy seed and go through both. Tolerance: f32
atol/rtol 1e-5, as for B2 (the two sum the same terms in another order);
INT8 and bf16 pools and appends bit-exact. ``tests/test_torch_cuda.py``
holds the CUDA kernels against the plain versions on a card.
"""

import collections
import pathlib
import tomllib

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
from pagedattention_based_transformer_decoder_inference_framework_tpu.engine import (
    paged_backend as jpb,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu.kvcache import pool as jpool
from pagedattention_based_transformer_decoder_inference_framework_tpu.models.model import (
    init_params as jax_init_params,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu.ops import (
    paged_attention as jpa,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu.ops.kv_append import (
    kv_append as jax_kv_append,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch import config as tconfig
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.engine import (
    Engine,
    SamplingParams,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.engine import (
    paged_backend as tpb,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.kvcache import pool as tpool
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.models import (
    params_from_jax,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.ops import (
    kv_append as ka,
    paged_attention as pa,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.utils import platform

PAGE, P, MP, L, LAYER = 8, 32, 6, 2, 1
CLOSE = dict(atol=1e-5, rtol=1e-5)


def make_pool(rng, KH, dh, pool_dtype):
    """Random pool ``[L, 2, KH, P, PAGE, dh]`` (+ flat INT8 scales) as
    numpy, and its JAX and torch forms (``(vals, scales or None)``)."""
    shape = (L, 2, KH, P, PAGE, dh)
    if pool_dtype == "int8":
        vals = rng.integers(-127, 128, size=shape).astype(np.int8)
        sc = (rng.random((L, 2, KH, P * PAGE // 128, 128)) * 0.02
              + 0.005).astype(np.float32)
        return ((jnp.asarray(vals), jnp.asarray(sc)),
                (torch.from_numpy(vals), torch.from_numpy(sc)))
    vals = rng.normal(size=shape).astype(np.float32)
    if pool_dtype == "bfloat16":
        return ((jnp.asarray(vals).astype(jnp.bfloat16), None),
                (torch.from_numpy(vals).to(torch.bfloat16), None))
    return (jnp.asarray(vals), None), (torch.from_numpy(vals), None)


def block_table(rng, B, width=MP):
    return (rng.permutation(P - 1)[:B * width] + 1).reshape(B, width).astype(
        np.int32)


def run_pair(jfn, tfn, rng, KH, G, dh, pool_dtype, seq_lens, **kw):
    """The JAX kernel and the port's wrapper on the same inputs; returns
    both outputs as numpy."""
    B, H = len(seq_lens), KH * G
    (jvals, jsc), (tvals, tsc) = make_pool(rng, KH, dh, pool_dtype)
    bt = block_table(rng, B)
    q = rng.normal(size=(B, 1, H, dh)).astype(np.float32)
    sl = np.asarray(seq_lens, np.int32)
    common = dict(page_size=PAGE, num_q_heads=H, scale=dh ** -0.5, **kw)
    ref = jfn(jnp.asarray(q), jvals, jnp.asarray(bt), jnp.asarray(sl), jsc,
              jnp.int32(LAYER), interpret=True, **common)
    out = tfn(torch.from_numpy(q), tvals, torch.from_numpy(bt),
              torch.from_numpy(sl), tsc, LAYER, **common)
    return out.numpy(), np.asarray(ref)


# (G, window, softcap, seq_lens) at B=3: ragged lengths, a table wider
# than the live pages, and the table's last slot; GQA without options,
# MHA with a window that starts inside a page and a softcap
DECODE_CASES = {
    "gqa": (4, 0, 0.0, [1, 17, MP * PAGE]),
    "mha_window_softcap": (1, 10, 20.0, [5, 30, MP * PAGE - 3]),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
@pytest.mark.parametrize("pool_dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("J", [1, 4])
@pytest.mark.parametrize("dh", [16, 24, 64])
def test_grouped_decode_matches_jax(dh, J, pool_dtype, case):
    G, window, softcap, seq_lens = DECODE_CASES[case]
    out, ref = run_pair(jpa.paged_attention_decode_grouped,
                        pa.paged_attention_decode_grouped,
                        np.random.default_rng(10 + dh), 2, G, dh, pool_dtype,
                        seq_lens, window=window, softcap=softcap,
                        group_pages=J)
    np.testing.assert_allclose(out, ref, **CLOSE)


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
@pytest.mark.parametrize("pool_dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("dh", [16, 32, 64])
def test_packed_decode_matches_jax(dh, pool_dtype, case):
    G, window, softcap, seq_lens = DECODE_CASES[case]
    assert pa.packable_decode(PAGE, dh) == jpa.packable_decode(PAGE, dh)
    out, ref = run_pair(jpa.paged_attention_decode_packed,
                        pa.paged_attention_decode_packed,
                        np.random.default_rng(20 + dh), 2, G, dh, pool_dtype,
                        seq_lens, window=window, softcap=softcap)
    np.testing.assert_allclose(out, ref, **CLOSE)


@pytest.mark.parametrize("pool_dtype", ["float32", "int8"])
@pytest.mark.parametrize("KH,G", [(2, 1), (2, 3)])
def test_batched_decode_matches_jax(KH, G, pool_dtype):
    """The cases of ``tests/test_paged_attention.py``'s
    ``test_decode_batched_matches_general``: a short sequence, four full
    pages, one token."""
    out, ref = run_pair(jpa.paged_attention_decode_batched,
                        pa.paged_attention_decode_batched,
                        np.random.default_rng(61), KH, G, 128, pool_dtype,
                        [13, PAGE * 4, 1])
    np.testing.assert_allclose(out, ref, **CLOSE)


def test_gates_match_jax():
    """``packable_decode`` and ``batchable_decode`` are copies of the JAX
    gates; the wrappers refuse what their kernels do not cover."""
    for page in (1, 4, 8, 16, 64):
        for dh in (8, 16, 24, 32, 48, 64, 96, 128, 256):
            assert pa.packable_decode(page, dh) == \
                jpa.packable_decode(page, dh), (page, dh)
    for args in ((8, 6, 2, 8, 128, 1), (8, 6, 2, 8, 64, 1),
                 (64, 64, 8, 64, 128, 1), (4, 8, 8, 64, 128, 1)):
        assert pa.batchable_decode(*args) == jpa.batchable_decode(*args)
    q = torch.zeros((1, 1, 2, 24))
    kv = torch.zeros((L, 2, 1, 4, PAGE, 24))
    bt = torch.ones((1, 2), dtype=torch.int32)
    sl = torch.ones((1,), dtype=torch.int32)
    common = dict(page_size=PAGE, num_q_heads=2)
    with pytest.raises(ValueError, match="packable"):
        pa.paged_attention_decode_packed(q, kv, bt, sl, None, 0, **common)
    with pytest.raises(ValueError, match="dh % 128"):
        pa.paged_attention_decode_batched(q, kv, bt, sl, None, 0, **common)


# -- the T=1 route --------------------------------------------------------

ROUTE_NAMES = ("paged_attention_decode", "paged_attention_decode_grouped",
               "paged_attention_decode_packed")


def route_cfgs(dh, pad, page, mp, kv_dtype):
    out = []
    for mod in (jconfig, tconfig):
        m = mod.preset("llama-tiny")
        m.head_dim, m.dtype = dh, "float32"
        out.append((m, mod.CacheConfig(page_size=page, num_pages=4,
                                       max_pages_per_seq=mp,
                                       kv_dtype=kv_dtype, pad_head_dim=pad)))
    return out


@pytest.mark.parametrize("kv_dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("page", [8, 64])
@pytest.mark.parametrize("pad", [None, False])
@pytest.mark.parametrize("dh", [16, 24, 64, 96, 128])
def test_decode_route_matches_jax(monkeypatch, dh, pad, page, kv_dtype):
    """For each block-table width (a few pages, the widest inside the
    INT8 scales budget, one page more) the port's ``PagedKVBackend``
    calls the decode kernel the JAX backend calls. The tables are dump
    page entries and both sides' kernels and appends are spies, so a
    table of thousands of pages costs nothing."""
    calls = collections.Counter()

    def spy(side, name, result):
        def call(*args, **kw):
            calls[side, name] += 1
            return result(args)
        return call

    for name in ROUTE_NAMES:
        monkeypatch.setattr(jpb, name,
                            spy("jax", name, lambda a: jnp.zeros_like(a[0])))
    monkeypatch.setattr(jpb, "kv_append", lambda kv, *a, **kw: kv)
    KH, B = 2, 2
    budget = pa.DECODE_SCALES_BUDGET // (2 * KH * page * 4)
    for mp in (4, budget, budget + 1):
        calls.clear()
        (jm, jc), (tm, tc) = route_cfgs(dh, pad, page, mp, kv_dtype)
        jb = jpb.PagedKVBackend(jm, jc, interpret=True)
        tb = tpb.PagedKVBackend(tm, tc)
        for attr, name in tpb._DECODE_ATTR.items():
            monkeypatch.setattr(tb, name, spy("port", attr,
                                              lambda a: torch.zeros_like(
                                                  a[0])))
        monkeypatch.setattr(tb, "append", lambda kv, *a, **kw: kv)
        bt = np.zeros((B, mp), np.int32)
        sl = np.asarray([3, 5], np.int32)
        q = np.zeros((B, 1, 4, dh), np.float32)
        k = np.zeros((B, 1, KH, dh), np.float32)
        pos = (sl - 1)[:, None]
        jfn = jb.make_attn_fn(jnp.asarray(bt), jnp.asarray(sl),
                              jnp.asarray(sl - 1))
        jout, _ = jfn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                      jb.init_cache(), 0, jnp.asarray(pos))
        tfn = tb.make_attn_fn(torch.from_numpy(bt), torch.from_numpy(sl),
                              torch.from_numpy(sl - 1))
        tout, _ = tfn(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(k), tb.init_cache("cpu"), 0,
                      torch.from_numpy(pos))
        assert tout.shape == jout.shape == (B, 1, 4, dh)
        jax_calls = {n for (s, n) in calls if s == "jax"}
        port_calls = {n for (s, n) in calls if s == "port"}
        assert len(jax_calls) == 1 and sum(calls.values()) == 2, calls
        assert port_calls == jax_calls, (mp, calls)
        dh_pool = tb.pool.pool_head_dim
        assert port_calls == {pa.decode_route(mp, KH, page, dh_pool,
                                              kv_dtype == "int8")}


def test_decode_append_gate_follows_the_route():
    """``decode_append_supported`` holds only where the T=1 route is B2:
    a Llama-3.1-8B pool (KH 8, page 64, INT8) under ``bench.py --mode
    longctx --prompt-len 32768``'s 516-page table routes to B6, so
    ``PBT_FUSED_APPEND=1`` keeps B3 + B6 there as the JAX package does;
    512 pages (32k tokens) is the widest table B2 takes."""
    pool = torch.zeros((1, 2, 8, 2, 64, 128), dtype=torch.int8)
    sc = torch.zeros((1, 2, 8, 1, 128))
    for mp, route in ((512, "paged_attention_decode"),
                      (513, "paged_attention_decode_grouped"),
                      (516, "paged_attention_decode_grouped")):
        assert pa.decode_route(mp, 8, 64, 128, True) == route
        assert pa.decode_append_supported((pool, sc), 128, mp) == (
            route == "paged_attention_decode")
    # bf16 pools have no scales budget: B2 at any width
    assert pa.decode_append_supported((pool.bfloat16(),), 128, 516)
    # an unpadded sub-128 pool routes to B8 or B6 at any width
    assert not pa.decode_append_supported((pool[..., :64].bfloat16(),), 64,
                                          4)


# -- the pool and the appends at sub-128 head dims ------------------------

@pytest.mark.parametrize("kv_dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("dh", [64, 96])
def test_unpadded_pool_matches_jax(dh, kv_dtype):
    """``pad_head_dim=False`` keeps the head dim: the JAX pool's leaves,
    shapes and dtypes exactly, and the flat INT8 scales leaf unchanged."""
    (jm, jc), (tm, tc) = route_cfgs(dh, False, 8, 6, kv_dtype)
    jc.num_pages = tc.num_pages = 20
    jkv = jpool.PagePool(jm, jc).init()
    tkv = tpool.PagePool(tm, tc).init("cpu")
    assert tpool.PagePool(tm, tc).pool_head_dim == dh
    assert [tuple(t.shape) for t in tkv] == [tuple(j.shape) for j in jkv]
    assert tkv[0].shape[-1] == dh
    assert [str(t.dtype)[6:] for t in tkv] == [str(j.dtype) for j in jkv]


# (T, positions per lane): B3 (a frozen lane), B4 (a page-aligned chunk
# with a ragged prompt), B5 (a chunk crossing a page)
APPEND_CASES = {
    "decode": (1, [[12], [-1], [33]]),
    "prefill": (PAGE, [list(range(8, 16)), [8, 9, 10, -1, -1, -1, -1, -1],
                       list(range(16, 24))]),
    "tokens": (5, [list(range(6, 11)), [-1] * 5, list(range(21, 26))]),
}


@pytest.mark.parametrize("case", sorted(APPEND_CASES))
@pytest.mark.parametrize("kv_dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("dh", [64, 96])
def test_appends_at_sub128_head_dims_match_jax(dh, kv_dtype, case):
    """B3/B4/B5 (through ``kv_append``'s dispatch) into an unpadded pool,
    bit-exact with the JAX package's ``kv_append``."""
    T, pos = APPEND_CASES[case]
    B, KH, Pn = 3, 2, 16
    rng = np.random.default_rng(dh)
    bt = (rng.permutation(Pn - 1)[:B * 5] + 1).reshape(B, 5).astype(np.int32)
    k = rng.normal(size=(B, T, KH, dh)).astype(np.float32)
    v = rng.normal(size=(B, T, KH, dh)).astype(np.float32)
    pos = np.asarray(pos, np.int32)
    shape = (L, 2, KH, Pn, PAGE, dh)
    if kv_dtype == "int8":
        sc = (L, 2, KH, Pn * PAGE // 128, 128)
        jkv = (jnp.zeros(shape, jnp.int8), jnp.zeros(sc, jnp.float32))
        tkv = (torch.zeros(shape, dtype=torch.int8), torch.zeros(sc))
    else:
        jkv = (jnp.zeros(shape, jnp.bfloat16),)
        tkv = (torch.zeros(shape, dtype=torch.bfloat16),)
    ref = jax_kv_append(jkv, jnp.asarray(k), jnp.asarray(v), jnp.int32(LAYER),
                        jnp.asarray(pos), jnp.asarray(bt), page_size=PAGE,
                        interpret=True)
    out = ka.kv_append(tkv, torch.from_numpy(k), torch.from_numpy(v), LAYER,
                       torch.from_numpy(pos), torch.from_numpy(bt),
                       page_size=PAGE)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.float().numpy(),
                                      np.asarray(r, np.float32))
    assert out[0].float().abs().sum() > 0


# -- engines --------------------------------------------------------------

PROMPTS = [[(7 * i + 3) % 500 for i in range(19)], [5, 9, 3, 14, 2]]
NEW = 6


def engine_cfgs(variant, kv_dtype):
    """``llama-tiny`` (dh 16: B8 at page 8), a dh-24 variant of it (B6),
    and a Phi-3-shaped one (MHA, dh 96, a sliding window of 8: B6), each
    on an unpadded pool."""
    out = []
    for mod in (jconfig, tconfig):
        m = mod.preset("llama-tiny")
        m.dtype = "float32"
        if variant == "dh24":
            m.head_dim = 24
        elif variant == "phi3-shaped":
            m.num_heads = m.num_kv_heads = 2
            m.head_dim, m.hidden_size, m.sliding_window = 96, 96, 8
        out.append(mod.FrameworkConfig(
            model=m,
            cache=mod.CacheConfig(page_size=8, num_pages=48,
                                  max_pages_per_seq=6, kv_dtype=kv_dtype,
                                  pad_head_dim=False),
            runtime=mod.RuntimeConfig(max_new_tokens=NEW, prefill_chunk=16)))
    return out


@pytest.mark.parametrize("kv_dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("variant,route", [
    ("llama-tiny", "attend_decode_packed"), ("dh24", "attend_decode_grouped"),
    ("phi3-shaped", "attend_decode_grouped")])
def test_unpadded_engine_matches_jax(monkeypatch, variant, route, kv_dtype):
    """Greedy ``generate_batch_fused`` streams of the port equal the JAX
    engine's at ``pad_head_dim=False``, weights bridged by
    ``params_from_jax``; every decode layer goes through the route's
    wrapper and through no other decode wrapper."""
    jcfg, tcfg = engine_cfgs(variant, kv_dtype)
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

    for key in tpb._DECODE_ATTR.values():
        monkeypatch.setattr(te.backend, key,
                            counted(key, getattr(te.backend, key)))
    js = JaxSampling(temperature=0.0, eos_token_id=-1)
    ts = SamplingParams(temperature=0.0, eos_token_id=-1)
    assert te.generate_batch_fused(PROMPTS, NEW, ts) == \
        je.generate_batch_fused(PROMPTS, NEW, js)
    assert calls == {route: tcfg.model.num_layers * (NEW - 1)}
    assert te.backend.pool.pool_head_dim == tcfg.model.head_dim
    assert te.allocator.num_free == te.cache.num_pages - 1


def test_package_data_covers_every_include():
    """A non-editable install ships every file a kernel source includes
    (the build digests and compiles ``csrc/*.cu`` with its headers)."""
    repo = pathlib.Path(__file__).resolve().parent.parent
    data = tomllib.loads((repo / "pyproject.toml").read_text())
    pkg = platform.CSRC.parent.name
    globs = data["tool"]["setuptools"]["package-data"][pkg]
    shipped = {p for g in globs for p in platform.CSRC.parent.glob(g)}
    for src in platform.CSRC.glob("*.cu*"):
        assert src in shipped, src
        for line in src.read_text().splitlines():
            if line.startswith('#include "'):
                name = line.split('"')[1]
                assert platform.CSRC / name in shipped, (src, name)
