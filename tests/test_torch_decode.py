"""T=1 decode attention past B2 in the PyTorch port: the grouped (B6),
packed (B8) and batched (B7) kernels' plain versions against the JAX
package's Pallas kernels, the split-KV cuts of B2, B6 and B7 (their
plans, B7's partition, and their computations in plain PyTorch, the
``*_emulation`` functions) against the plain versions and the JAX
kernels, the backend's choice between B2, B6 and B8 against the JAX
backend's, and greedy engine streams on unpadded pools
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


@pytest.mark.parametrize("B,KH,mp,expect", [
    (4, 8, 5, (5, 1)),        # the slice: a split a page, 160 blocks
    (4, 8, 4, (4, 1)),        # path (b)'s table width
    (4, 8, 7, (7, 1)),        # path (k)'s decode (4 x 320 tokens)
    (1, 8, 512, (32, 16)),    # a 32k-token table at batch 1: 256 blocks
    (4, 8, 512, (9, 57)),     # four ragged sequences of up to 512 pages
    (1, 8, 1, (1, 1)),
    (64, 8, 16, (1, 16)),     # the batch alone fills two waves
    (1, 1, 512, (64, 8))])    # at most 64 splits
def test_decode_split_plan(B, KH, mp, expect):
    assert pa.decode_split_plan(B, KH, mp) == expect


@pytest.mark.parametrize("B,KH", [(1, 8), (4, 8), (8, 4), (1, 32), (3, 2)])
def test_decode_split_plan_over_table_widths(B, KH):
    """B2's splits from B, KH and the table width alone, for every width
    from 1 page to 512: whole runs of pages covering the table (none
    empty by construction), at most 64, and a grid of one to two waves
    of blocks where the table is wide enough."""
    for mp in range(1, 513):
        splits, pps = pa.decode_split_plan(B, KH, mp)
        assert 1 <= splits <= pa.DECODE_MAX_SPLITS and pps >= 1
        assert splits * pps >= mp > (splits - 1) * pps
        want = min(mp, -(-2 * platform.SMS // (B * KH)),
                   pa.DECODE_MAX_SPLITS)
        assert splits >= -(-want // 2)
        assert B * KH * splits <= 2 * platform.SMS + B * KH


# (G, window, softcap, seq_lens) at B=3 over a 6-page table of 8-key
# pages: with a window of 10 the longer sequences' first visible key is
# 20 or 38, so their early splits hold no visible key
SPLIT_CASES = {
    "window_softcap": (4, 10, 20.0, [1, 30, MP * PAGE]),
    "gqa": (4, 0, 0.0, [1, 17, MP * PAGE]),
    "mha": (1, 0, 0.0, [9, 40, 44]),
}


@pytest.mark.parametrize("pps", [1, 2, 4])
@pytest.mark.parametrize("pool_dtype", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_decode_emulation_matches_plain_and_jax(case, pool_dtype, pps):
    """B2's split-then-merge, emulated in plain PyTorch
    (``decode_split_emulation``), against its plain version and the JAX
    ``paged_attention_decode`` in interpret mode (f32 1e-5: the same
    terms summed in another order), merged in split order and in reverse
    (the tolerance admits the order); splits wholly before the window
    weigh nothing."""
    G, window, softcap, lens = SPLIT_CASES[case]
    KH, dh = 2, 128
    H = KH * G
    rng = np.random.default_rng(11)
    (jvals, jsc), (tvals, tsc) = make_pool(rng, KH, dh, pool_dtype)
    bt = block_table(rng, len(lens))
    q = rng.normal(size=(len(lens), 1, H, dh)).astype(np.float32)
    sl = np.asarray(lens, np.int32)
    common = dict(page_size=PAGE, num_q_heads=H, window=window,
                  softcap=softcap, scale=dh ** -0.5)
    ref = np.asarray(jpa.paged_attention_decode(
        jnp.asarray(q), jvals, jnp.asarray(bt), jnp.asarray(sl), jsc,
        jnp.int32(LAYER), interpret=True, **common))
    args = (torch.from_numpy(q), tvals, torch.from_numpy(bt),
            torch.from_numpy(sl), tsc, LAYER)
    plain = pa.paged_attention_decode_plain(*args, **common).numpy()
    np.testing.assert_allclose(plain, ref, **CLOSE)
    splits = -(-MP // pps)
    for order in (None, range(splits - 1, -1, -1)):
        out = pa.decode_split_emulation(*args, pages_per_split=pps,
                                        order=order, **common).numpy()
        np.testing.assert_allclose(out, plain, **CLOSE)
        np.testing.assert_allclose(out, ref, **CLOSE)
    if window:
        # the longest sequence's first visible page lies past split 0
        first = (lens[-1] - window) // PAGE
        assert first >= pps


# -- B6's and B7's cuts (the kernels on B2's split-KV body) ---------------

@pytest.mark.parametrize("B,KH,mp,page,window,J,expect", [
    (4, 32, 36, 64, 2047, 4, (3, 12)),   # path (h): 33 pages visible
    (1, 8, 516, 64, 0, 4, (33, 16)),     # path (i): B2's cut at 516 pages
    (4, 8, 5, 64, 0, 4, (2, 4)),         # the dh 64 softcap shape
    (5, 2, 40, 8, 10, 7, (1, 7)),        # a window of 10 keys: 3 pages
    (1, 1, 512, 64, 0, 1, (64, 8)),      # at most 64 splits
    (64, 8, 16, 64, 0, 4, (1, 16)),      # the batch alone fills two waves
    (2, 2, 3, 8, 0, 9, (1, 3))])         # J clamped to the table
def test_decode_grouped_plan(B, KH, mp, page, window, J, expect):
    assert pa.decode_grouped_plan(B, KH, mp, page, window, J) == expect


@pytest.mark.parametrize("J", [1, 4, 7])
@pytest.mark.parametrize("B,KH", [(1, 8), (4, 32), (3, 2)])
def test_decode_grouped_plan_covers_the_window(B, KH, J):
    """Every table width from 1 to 300 pages, with and without windows:
    runs of a multiple of J pages (J clamped to the table), at most 64,
    covering the most pages a sequence can have visible, none empty."""
    for mp in range(1, 301):
        for window in (0, 1, 9, 64, 65, 2047):
            splits, pps = pa.decode_grouped_plan(B, KH, mp, 8, window, J)
            width = mp if window == 0 else min(mp, -(-(window - 1) // 8) + 1)
            most = max(n_vis(sl, 8, mp, window) for sl in range(1, mp * 8 + 1,
                                                                 max(1, mp)))
            assert most <= width
            assert pps % min(J, mp) == 0 and 1 <= splits <= 64
            assert splits * pps >= width > (splits - 1) * pps


def n_vis(seq_len, page, mp, window):
    """Pages of a sequence of ``seq_len`` keys that hold visible keys."""
    first = max(seq_len - window, 0) // page if window else 0
    return max(min(-(-seq_len // page), mp) - first, 0)


# (B, KH, mp, seq_lens, window, blocks): ragged batches with empty
# sequences, a window, one block, fewer units than blocks, a sequence's
# pages over many blocks, and runs that span several (sequence, KV head)s
PARTITIONS = {
    "ragged": (5, 2, 40, [0, 30, 17, 320, 250], 10, None),
    "one_block": (3, 2, 6, [5, 48, 17], 0, 1),
    "few_units": (4, 8, 5, [65, 90, 128, 101], 0, None),
    "all_empty": (3, 4, 6, [0, 0, 0], 0, None),
    "long_and_short": (2, 1, 512, [1, 64 * 512], 0, None),
    "spans": (8, 8, 5, [1, 65, 200, 320, 17, 128, 64, 250], 0, 7),
    "b2_ragged": (4, 8, 512, [1, 64 * 7 + 3, 64 * 200, 64 * 512], 0, None),
    "window_64": (6, 3, 20, [1, 63, 64, 65, 640, 1000], 100, 13),
}


@pytest.mark.parametrize("case", sorted(PARTITIONS))
def test_decode_batched_partition(case):
    """B7's partition, each block deriving its parts alone: every visible
    page of every (sequence, KV head) covered exactly once, runs of equal
    length (within one unit), none empty where there are units enough,
    and every (sequence, KV head)'s parts numbered 0..parts-1 in page
    order by the blocks, which agree on the count."""
    B, KH, mp, lens, window, blocks = PARTITIONS[case]
    page = 64 if max(lens) > 320 else 8
    parts = pa.decode_batched_partition(lens, KH, page, mp, window, blocks)
    nb = pa.decode_batched_blocks(B, KH, mp) if blocks is None else blocks
    assert len(parts) == nb
    seen = collections.defaultdict(list)
    for blk in parts:
        for j, first, n, part, count in blk:
            assert n >= 1
            seen[j].append((part, first, n, count))
    U = sum(KH * n_vis(sl, page, mp, window) for sl in lens)
    runs = [sum(n for _, _, n, _, _ in blk) for blk in parts]
    assert sum(runs) == U
    live = [r for r in runs if r]
    assert len(live) == min(nb, U)
    if live:
        assert max(live) - min(live) <= 1
    for b, sl in enumerate(lens):
        first = max(sl - window, 0) // page if window else 0
        for h in range(KH):
            got = sorted(seen.pop(b * KH + h, []))
            assert [p for p, _, _, _ in got] == list(range(len(got)))
            assert all(c == len(got) for _, _, _, c in got)
            pages = [first + i for i in range(n_vis(sl, page, mp, window))]
            assert [pg for _, f, n, _ in got for pg in range(f, f + n)] == \
                pages
    assert not seen


# (G, window, softcap, seq_lens) at B=5 over a 6-page table of 8-key
# pages: an empty sequence, a window starting inside a page, the table's
# last slot
SPLIT_KV_CASES = {
    "gqa_window": (4, 10, 0.0, [0, 30, 17, MP * PAGE, 41]),
    "mha_softcap": (1, 0, 20.0, [1, 9, MP * PAGE - 3, 0, 24]),
}


@pytest.mark.parametrize("blocks", [None, 1, 3, 7])
@pytest.mark.parametrize("pool_dtype", ["float32", "int8"])
@pytest.mark.parametrize("case", sorted(SPLIT_KV_CASES))
def test_batched_emulation_matches_plain_and_jax(case, pool_dtype, blocks):
    """B7's partition and part-order merge in plain PyTorch
    (``decode_batched_emulation``) against its plain version and the JAX
    ``paged_attention_decode_batched`` in interpret mode (1e-5: the same
    terms summed in another order), in part order and in reverse; with 3
    or 7 blocks runs span two (sequence, KV head)s."""
    G, window, softcap, lens = SPLIT_KV_CASES[case]
    KH, dh = 2, 128
    rng = np.random.default_rng(21)
    (jvals, jsc), (tvals, tsc) = make_pool(rng, KH, dh, pool_dtype)
    bt = block_table(rng, len(lens))
    q = rng.normal(size=(len(lens), 1, KH * G, dh)).astype(np.float32)
    sl = np.asarray(lens, np.int32)
    common = dict(page_size=PAGE, num_q_heads=KH * G, window=window,
                  softcap=softcap, scale=dh ** -0.5)
    ref = np.asarray(jpa.paged_attention_decode_batched(
        jnp.asarray(q), jvals, jnp.asarray(bt), jnp.asarray(sl), jsc,
        jnp.int32(LAYER), interpret=True, **common))
    args = (torch.from_numpy(q), tvals, torch.from_numpy(bt),
            torch.from_numpy(sl), tsc, LAYER)
    plain = pa.paged_attention_decode_batched_plain(*args, **common).numpy()
    np.testing.assert_allclose(plain, ref, **CLOSE)
    if blocks is not None:
        spans = [blk for blk in pa.decode_batched_partition(
            lens, KH, PAGE, MP, window, blocks) if len(blk) > 1]
        assert spans                 # a run holds two (sequence, KV head)s
    for reverse in (False, True):
        out = pa.decode_batched_emulation(*args, blocks=blocks,
                                          reverse=reverse, **common).numpy()
        np.testing.assert_allclose(out, plain, **CLOSE)
        np.testing.assert_allclose(out, ref, **CLOSE)
    assert not out[0 if lens[0] == 0 else 3].any()       # the empty lane


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
@pytest.mark.parametrize("J", [1, 4, 7])
@pytest.mark.parametrize("dh", [24, 64, 96])
def test_grouped_emulation_matches_jax(dh, J, case):
    """B6's cut (``decode_grouped_plan``: runs of a multiple of J pages
    counted from the window's first visible page) and its split-order
    merge in plain PyTorch (``decode_grouped_emulation``) against the JAX
    ``paged_attention_decode_grouped`` in interpret mode at the same J
    (f32 1e-5: the same terms in another order), in split order and in
    reverse, over an INT8 pool."""
    G, window, softcap, seq_lens = DECODE_CASES[case]
    rng = np.random.default_rng(30 + dh)
    KH = 2
    (jvals, jsc), (tvals, tsc) = make_pool(rng, KH, dh, "int8")
    bt = block_table(rng, len(seq_lens))
    q = rng.normal(size=(len(seq_lens), 1, KH * G, dh)).astype(np.float32)
    sl = np.asarray(seq_lens, np.int32)
    common = dict(page_size=PAGE, num_q_heads=KH * G, window=window,
                  softcap=softcap, scale=dh ** -0.5)
    ref = np.asarray(jpa.paged_attention_decode_grouped(
        jnp.asarray(q), jvals, jnp.asarray(bt), jnp.asarray(sl), jsc,
        jnp.int32(LAYER), interpret=True, group_pages=J, **common))
    args = (torch.from_numpy(q), tvals, torch.from_numpy(bt),
            torch.from_numpy(sl), tsc, LAYER)
    splits = pa.decode_grouped_plan(len(seq_lens), KH, MP, PAGE, window,
                                    J)[0]
    for order in (None, range(splits - 1, -1, -1)):
        out = pa.decode_grouped_emulation(*args, group_pages=J, order=order,
                                          **common).numpy()
        np.testing.assert_allclose(out, ref, **CLOSE)
