"""Mixture-of-Experts in the PyTorch port against the JAX package, on
``mixtral-tiny`` (E 4, top-2, f32 model dtype) with weights bridged by
``params_from_jax``: the router and its top-k (ties included), the
masked expert loop and the sorted dispatch through B13's plain version
(``DecoderModel._moe`` against the JAX one, jitted, with its Pallas
grouped matmul in interpret mode), INT8 and fused experts, w8a8, the
dispatch layout with experts that receive no token, and the weights'
init, quantization and fusion, INT4 keeping INT8 experts and the
engine's build freeing the unfused experts as it fuses.

Tolerances: f32 MoE outputs 1e-5 of max|out| against the JAX package
(the same f32 products summed in another order); the dispatch against
the masked loop 2e-4 (``tests/test_moe.py``'s own); w8a8 1e-5 as well,
since both quantize the same activations bit for bit (``jit``'s
reciprocal).
"""

import gc
import weakref

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pagedattention_based_transformer_decoder_inference_framework_tpu import config as jconfig
from pagedattention_based_transformer_decoder_inference_framework_tpu.engine import (
    Engine as JaxEngine,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu.models import model as jmodel
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch import config as tconfig
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.engine import Engine
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.engine import engine as teng
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.models import model as tmodel
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.ops import gmm
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.quant.tensor import (
    Q4Tensor,
    QTensor,
)

D = 64


def cfgs(quant="none", **kw):
    j, t = jconfig.preset("mixtral-tiny"), tconfig.preset("mixtral-tiny")
    for c in (j, t):
        c.dtype = "float32"
        c.quant = quant
        for k, v in kw.items():
            setattr(c, k, v)
    return j, t


def bridge(tree, tcfg):
    return tmodel.params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                                  tcfg)


@pytest.fixture(scope="module")
def stacked():
    """JAX ``init_params`` (f32, stacked) and its bridge."""
    jc, tc = cfgs()
    jp = jmodel.init_params(jc, jax.random.key(0))
    return jp, bridge(jp, tc)


def layer0(params):
    return {k: v[0] for k, v in params["layers"].items()}


def engine_layer(quant):
    """Layer 0 of the JAX engine's layout (quantized, unstacked, fused
    ``we_gu``), in both packages."""
    jc, tc = cfgs(quant)
    jp = jmodel.init_params(jc, jax.random.key(0))
    ep = jmodel.fuse_projections(jmodel.unstack_layers(
        jmodel.quantize_params(jp)))
    return jc, tc, ep["layers"][0], bridge(ep, tc)["layers"][0]


def h2_of(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape + (D,)).astype(
        np.float32)


def jax_moe(jc, jlp, h2, w8a8=False):
    model = jmodel.DecoderModel(jc)
    fn = jax.jit(lambda lp, h: model._moe(lp, h, w8a8=w8a8))
    return np.asarray(fn(jlp, jnp.asarray(h2)))


def port_moe(tc, tlp, h2, w8a8=False):
    return tmodel.DecoderModel(tc)._moe(tlp, torch.from_numpy(h2),
                                        w8a8).numpy()


def assert_close(got, want, frac=1e-5):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=frac * np.abs(want).max())


@pytest.fixture
def gmm_calls(monkeypatch):
    """Counts the grouped-matmul calls and keeps their group ids."""
    calls = []
    real = gmm.grouped_matmul

    def counted(x, w, gb, *, bm=256, block_rows=None):
        calls.append(gb.clone())
        return real(x, w, gb, bm=bm, block_rows=block_rows)
    monkeypatch.setattr(gmm, "grouped_matmul", counted)
    return calls


@pytest.mark.parametrize("shape,path", [((2, 32), "masked"),
                                        ((2, 256), "dispatch")])
def test_moe_matches_jax(stacked, gmm_calls, shape, path):
    """S = B*T*k: 128 < E*256 takes the masked loop, 1024 = E*256 the
    dispatch (the threshold is met with equality)."""
    jp, tp = stacked
    jc, tc = cfgs()
    h2 = h2_of(shape)
    got = port_moe(tc, layer0(tp), h2)
    assert_close(got, jax_moe(jc, layer0(jp), h2))
    assert len(gmm_calls) == (3 if path == "dispatch" else 0)


@pytest.mark.parametrize("shape", [(2, 32), (2, 256)])
def test_moe_int8_fused_gu_matches_jax(gmm_calls, shape):
    """INT8 experts in the engine's fused layout (``we_gu``), weight-only:
    the masked loop on B11's plain version, the dispatch on B13's (two
    calls: fused gate|up, then down)."""
    jc, tc, jlp, tlp = engine_layer("int8-weight")
    assert isinstance(tlp["we_gu"], QTensor) and "we_gate" not in tlp
    h2 = h2_of(shape, seed=2)
    assert_close(port_moe(tc, tlp, h2), jax_moe(jc, jlp, h2))
    assert len(gmm_calls) == (2 if shape[1] == 256 else 0)


def test_moe_w8a8_takes_the_masked_loop_at_any_size(gmm_calls):
    jc, tc, jlp, tlp = engine_layer("int8")
    h2 = h2_of((2, 256), seed=3)
    assert_close(port_moe(tc, tlp, h2, w8a8=True),
                 jax_moe(jc, jlp, h2, w8a8=True))
    assert gmm_calls == []


def test_moe_dispatch_matches_masked_loop(stacked):
    """``tests/test_moe.py::test_moe_dispatch_matches_masked_loop`` on the
    port: the dispatch equals the masked loop on the same inputs."""
    _, tp = stacked
    _, tc = cfgs()
    model, lp = tmodel.DecoderModel(tc), layer0(tp)
    h2 = torch.from_numpy(h2_of((2, 256), seed=2))
    topi, gates = model._route(lp, h2)
    got = model._moe_dispatch(lp, h2, topi, gates).numpy()
    want = model._moe_masked(lp, h2, topi, gates, False).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


def test_moe_dispatch_int8_and_fused_gu(stacked):
    """``tests/test_moe.py::test_moe_dispatch_int8_and_fused_gu`` on the
    port: the fused INT8 dispatch stays close to the float masked loop."""
    _, tp = stacked
    _, tc = cfgs()
    _, tcq = cfgs("int8-weight")
    ep = tmodel.fuse_projections(tmodel.unstack_layers(
        tmodel.quantize_params(tp)))
    h2 = h2_of((1, 512), seed=3)
    got = port_moe(tcq, ep["layers"][0], h2)[:, :32]
    want = port_moe(tc, layer0(tp), h2[:, :32])
    cos = float(np.sum(got * want)
                / (np.linalg.norm(got) * np.linalg.norm(want)))
    assert cos > 0.999, cos


def test_top_k_ties_pick_the_lower_expert(stacked):
    """Exact ties among the router logits: JAX's ``top_k`` puts the lower
    index first, and so must the port (``torch.topk`` promises no order
    for ties). Experts 1, 2 and 3 share one router column, so every
    token's logits for them are equal; where they beat expert 0 the
    picks must be (1, 2), and the MoE outputs must equal JAX's."""
    jp, tp = stacked
    jc, tc = cfgs()
    jlp = layer0(jp)
    router = np.array(jlp["router"])
    router[:, 2] = router[:, 3] = router[:, 1]
    jlp["router"] = jnp.asarray(router)
    tlp = dict(layer0(tp), router=torch.from_numpy(router))
    h2 = h2_of((2, 32), seed=4)
    topi, gates = tmodel.DecoderModel(tc)._route(tlp, torch.from_numpy(h2))
    logits = jnp.asarray(h2) @ jnp.asarray(router)
    _, jtopi = jax.lax.top_k(logits, 2)
    assert np.array_equal(topi.numpy(), np.asarray(jtopi))
    tied = (topi[..., 0] == 1).numpy()
    assert tied.any() and (topi.numpy()[tied] == [1, 2]).all()
    assert float(gates[tied][:, 0].sub(0.5).abs().max()) == 0.0
    assert_close(port_moe(tc, tlp, h2), jax_moe(jc, jlp, h2))


def test_dispatch_with_empty_experts(stacked, gmm_calls):
    """Every token routed to experts 1 and 3: experts 0 and 2 get no row,
    so their ranges are empty and share their start with the next
    expert's. The blocks must go to the expert that has rows there
    (``searchsorted(..., right=True)``; with ``right=False`` an empty
    expert would take the next one's blocks), as in the JAX package."""
    jp, tp = stacked
    jc, tc = cfgs()
    jlp = layer0(jp)
    router = np.zeros((D, 4), np.float32)
    router[0, [1, 3]] = [2.0, 1.0]
    jlp["router"] = jnp.asarray(router)
    tlp = dict(layer0(tp), router=torch.from_numpy(router))
    h2 = h2_of((2, 256), seed=5)
    h2[..., 0] = np.abs(h2[..., 0]) + 1.0
    got = port_moe(tc, tlp, h2)
    assert_close(got, jax_moe(jc, jlp, h2))
    # S = 1024 slots, 512 to each of experts 1 and 3: two blocks each,
    # then E = 4 trailing blocks of padding on the last expert
    assert len(gmm_calls) == 3
    assert gmm_calls[0].tolist() == [1, 1, 3, 3, 3, 3, 3, 3]
    model = tmodel.DecoderModel(tc)
    topi, gates = model._route(tlp, torch.from_numpy(h2))
    assert np.allclose(got, model._moe_masked(
        tlp, torch.from_numpy(h2), topi, gates, False).numpy(), atol=2e-4)


@pytest.mark.parametrize("routing", ["random", "empty-experts"])
def test_block_rows_match_the_jax_layout(stacked, gmm_calls, monkeypatch,
                                         routing):
    """``dispatch_block_rows`` (B13's ``block_rows``) equals the routed
    rows of each block of the JAX package's own dispatch layout on the
    same routing: the nonzero rows of the padded activations its
    ``_moe_dispatch`` hands to its grouped matmul, block by block (the
    JAX grouped matmul is replaced by a spy that records them). The
    random routing leaves padding blocks inside ranges; the other gives
    experts 0 and 2 no slot; both end in blocks past every range. The
    port's dispatch passes the same counts to its grouped matmul."""
    jp, tp = stacked
    jc, tc = cfgs()
    jlp, tlp = layer0(jp), layer0(tp)
    h2 = h2_of((2, 256), seed=7)
    if routing == "empty-experts":
        router = np.zeros((D, 4), np.float32)
        router[0, [1, 3]] = [2.0, 1.0]
        jlp["router"] = jnp.asarray(router)
        tlp = dict(tlp, router=torch.from_numpy(router))
        h2[..., 0] = np.abs(h2[..., 0]) + 1.0
    from pagedattention_based_transformer_decoder_inference_framework_tpu.ops import gmm as jgmm

    seen = []

    def spy(xp, w, gb, *, bm, interpret=None):
        seen.append((np.asarray(xp), np.asarray(gb), bm))
        n = (w.values if hasattr(w, "values") else w).shape[-1]
        return jnp.zeros((xp.shape[0], n), xp.dtype)

    monkeypatch.setattr(jgmm, "grouped_matmul", spy)
    jmodel.DecoderModel(jc)._moe(jlp, jnp.asarray(h2), w8a8=False)
    xp, jgb, bm = seen[0]
    jrows = (np.abs(xp) > 0).any(-1).reshape(-1, bm).sum(-1)
    model = tmodel.DecoderModel(tc)
    topi, _ = model._route(tlp, torch.from_numpy(h2))
    rows = tmodel.dispatch_block_rows(topi, 4, bm)
    assert rows.dtype == torch.int32
    assert rows.tolist() == jrows.tolist()
    assert tmodel.dispatch_layout(topi, 4, bm)[2].tolist() == jgb.tolist()
    assert int(rows.sum()) == 2 * 256 * 2           # every routed slot
    if routing == "empty-experts":
        assert rows.tolist() == [256, 256, 256, 256, 0, 0, 0, 0]
    else:
        assert ((rows > 0) & (rows < bm)).any() and (rows == 0).any()

    captured = []
    real = gmm.grouped_matmul

    def spy_rows(x, w, gb, *, bm=256, block_rows=None):
        captured.append(block_rows.clone())
        return real(x, w, gb, bm=bm, block_rows=block_rows)

    monkeypatch.setattr(gmm, "grouped_matmul", spy_rows)
    model._moe(tlp, torch.from_numpy(h2), False)
    assert len(captured) == 3
    assert all(c.tolist() == rows.tolist() for c in captured)


def leaves(tree):
    """``{path: (kind, shape, dtype)}`` of a params tree of either
    package (QTensor leaves by their values and scales)."""
    out = {}

    def walk(x, path):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{path}/{k}")
        elif hasattr(x, "packed"):
            out[path] = ("q4", tuple(x.packed.shape),
                         tuple(x.scales.shape))
        elif hasattr(x, "values") and hasattr(x, "scales"):
            out[path] = ("q8", tuple(x.values.shape),
                         str(x.values.dtype).replace("torch.", ""),
                         tuple(x.scales.shape))
        elif isinstance(x, (tuple, list)):
            for i, v in enumerate(x):
                walk(v, f"{path}/{i}")
        else:
            out[path] = ("dense", tuple(x.shape),
                         str(x.dtype).replace("torch.", ""))
    walk(tree, "")
    return out


@pytest.mark.parametrize("quantized", [False, True])
def test_init_structure_matches_jax(quantized):
    """``init_params`` / ``init_params_quantized``: the same keys, shapes,
    dtypes and QTensor leaves as the JAX package's (the values differ:
    two generators), the router dense in ``cfg.dtype``."""
    jc, tc = cfgs()
    jc.dtype = tc.dtype = "bfloat16"
    jinit = (jmodel.init_params_quantized if quantized
             else jmodel.init_params)
    jp = jinit(jc, jax.random.key(0))
    tp = tmodel.init_params(tc, torch.Generator().manual_seed(0), "cpu",
                            quantize=quantized)
    assert leaves(tp) == leaves(jp)
    up = tmodel.init_params(tc, torch.Generator().manual_seed(0), "cpu",
                            quantize=quantized, unrolled=True)
    # the unrolled init draws the same values
    for l, lp in enumerate(up["layers"]):
        for k in ("router", "we_gate", "we_down"):
            a, b = lp[k], tp["layers"][k]
            if quantized and k != "router":
                assert torch.equal(a.values, b.values[l])
                assert torch.equal(a.scales, b.scales[l])
            else:
                assert torch.equal(a, b[l])


@pytest.mark.parametrize("quant", ["int8-weight", "int8", "int4"])
def test_engine_weights_match_jax_layout(quant):
    """The engine's own build (init, quantize, unstack, fuse, INT4):
    the layout of the JAX engine's, the experts INT8 in every mode (INT4
    repacks only the attention and the head), and ``params_from_jax``
    bridges the JAX engine's params to the same layout."""
    jc, tc = cfgs(quant)
    mk = lambda mod, m: mod.FrameworkConfig(
        model=m, cache=mod.CacheConfig(page_size=8, num_pages=16,
                                       max_pages_per_seq=4))
    je = JaxEngine(mk(jconfig, jc), interpret=True)
    te = Engine(mk(tconfig, tc), device="cpu")
    assert leaves(te.params) == leaves(je.params)
    assert leaves(bridge(je.params, tc)) == leaves(je.params)
    for lp in te.params["layers"]:
        assert isinstance(lp["we_gu"], QTensor)
        assert isinstance(lp["we_down"], QTensor)
        assert isinstance(lp["w_qkv"], Q4Tensor if quant == "int4"
                          else QTensor)
        assert not isinstance(lp["router"], (QTensor, Q4Tensor))


def test_int4_keeps_int8_experts(stacked):
    """``quantize_params_int4`` on the fused INT8 layout repacks the
    attention projections and the head and leaves the experts' INT8
    values and scales as they were, as the JAX package does."""
    jp, tp = stacked
    ep = tmodel.fuse_projections(tmodel.unstack_layers(
        tmodel.quantize_params(tp)))
    before = [(lp["we_gu"], lp["we_down"]) for lp in ep["layers"]]
    ep4 = tmodel.quantize_params_int4(ep)
    jep4 = jmodel.quantize_params_int4(jmodel.fuse_projections(
        jmodel.unstack_layers(jmodel.quantize_params(jp))))
    assert leaves(ep4) == leaves(jep4)
    for lp, (gu, down) in zip(ep4["layers"], before):
        assert lp["we_gu"] is gu and lp["we_down"] is down
        assert isinstance(lp["wo"], Q4Tensor)


def test_engine_build_frees_unfused_experts(monkeypatch):
    """Fusing ``we_gate``/``we_up`` into ``we_gu`` frees each layer's
    unfused experts as soon as its fused ones exist: while layer l is
    fused only layers l.. still hold theirs (a copy-then-replace pass
    would hold every layer's, Mixtral-8x7B's 30 GB on top of its 46.6),
    and none is referenced once the engine is built."""
    refs = []
    real_init = teng.init_params_quantized

    def init(*args, **kw):
        params = real_init(*args, **kw)
        for lp in params["layers"]:
            refs.append([weakref.ref(lp[k].values)
                         for k in ("we_gate", "we_up")])
        return params

    alive = []
    real_cat = tmodel._cat_cols

    def cat(ws):
        gc.collect()
        if isinstance(ws[0], QTensor) and ws[0].values.dim() == 3:
            alive.append(sum(r() is not None for rs in refs for r in rs))
        return real_cat(ws)

    monkeypatch.setattr(teng, "init_params_quantized", init)
    monkeypatch.setattr(tmodel, "_cat_cols", cat)
    _, tc = cfgs("int8-weight", num_layers=4)
    eng = Engine(tconfig.FrameworkConfig(model=tc), device="cpu")
    gc.collect()
    assert len(refs) == 4
    assert alive == [8, 6, 4, 2]
    assert all(r() is None for rs in refs for r in rs)
    assert all("we_gate" not in lp for lp in eng.params["layers"])
