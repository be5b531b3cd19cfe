"""The PyTorch port's quantizers (``quant/tensor.py``) against ``jax.jit``
of the JAX package's: bit-exact values and scales, since the JAX engine
runs them compiled, where ``absmax / 127.0`` (``/ 7.0``) becomes a
multiply by the f32 reciprocal (an eager JAX call divides, and differs).
Also the INT4 carrier's round trips and block-width choice, the model's
quantized params (``init_params_quantized``, ``quantize_params``,
``quantize_params_int4``) and their bridge from the JAX package.
Inputs come from one numpy seed.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pagedattention_based_transformer_decoder_inference_framework_tpu.models import model as jmodel
from pagedattention_based_transformer_decoder_inference_framework_tpu.quant import tensor as jt
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.models import model as tmodel
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.quant import tensor as tt

from test_torch_model import model_cfgs


def bf16_pair(rng, shape, scale=1.0):
    """The same bf16 values for both frameworks."""
    a = jnp.asarray(rng.normal(size=shape).astype(np.float32) * scale
                    ).astype(jnp.bfloat16)
    return a, torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16)


def assert_same(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("fn", ["quantize_per_row", "quantize_per_channel"])
@pytest.mark.parametrize("shape", [(256, 512), (3, 64, 96)])
def test_int8_quantizers_match_jitted_jax(fn, shape):
    rng = np.random.default_rng(0)
    xj, xt = bf16_pair(rng, shape)
    ref = jax.jit(getattr(jt, fn))(xj)
    out = getattr(tt, fn)(xt)
    assert out.values.dtype == torch.int8 and out.scales.dtype == \
        torch.float32
    assert_same(out.values, ref.values)
    assert_same(out.scales, ref.scales)
    np.testing.assert_array_equal(
        tt.dequantize(out).numpy(), np.asarray(jt.dequantize(ref)))


def test_eager_jax_differs_from_the_compiled_quantizer():
    """Why the port follows ``jit``: eager JAX divides by 127."""
    rng = np.random.default_rng(1)
    xj, xt = bf16_pair(rng, (256, 1024))
    eager = jt.quantize_per_channel(xj).scales
    assert_same(tt.quantize_per_channel(xt).scales,
                jax.jit(jt.quantize_per_channel)(xj).scales)
    assert (np.asarray(eager) != np.asarray(
        jax.jit(jt.quantize_per_channel)(xj).scales)).any()


@pytest.mark.parametrize("K,N,group,cap", [
    (256, 1536, 128, 2048), (384, 2304, 128, 2048), (64, 100, 128, 2048),
    (128, 4096, 64, 1024)])
def test_int4_groupwise_matches_jitted_jax(K, N, group, cap):
    rng = np.random.default_rng(2)
    w = rng.normal(size=(K, N)).astype(np.float32) * 0.02
    ref = jax.jit(jt.quantize_int4_groupwise,
                  static_argnames=("group", "bn", "col_shards"))(
        jnp.asarray(w), group=group, bn=cap)
    out = tt.quantize_int4_groupwise(torch.from_numpy(w), group=group,
                                     bn=cap)
    assert (out.group, out.bn) == (ref.group, ref.bn)
    assert_same(out.packed, ref.packed)
    assert_same(out.scales, ref.scales)
    np.testing.assert_array_equal(
        tt.dequantize_int4(out).numpy(), np.asarray(jt.dequantize_int4(ref)))


@pytest.mark.parametrize("n,bn", [(6144, 2048), (28672, 2048),
                                  (4096, 2048), (128256, 768), (100, 100),
                                  (1536, 1536)])
def test_int4_block_width_choice(n, bn):
    """2048 for Llama-3-8B's projections, 768 for its LM head, the whole
    width where no multiple of 256 divides it."""
    assert tt.int4_block_width(n) == bn
    ref = jt.quantize_int4_groupwise(jnp.zeros((128, n), jnp.float32))
    assert ref.bn == bn


@pytest.mark.parametrize("bn", [2, 8, 768])
def test_pack_unpack_round_trip_matches_jax(bn):
    rng = np.random.default_rng(3)
    q = rng.integers(-8, 8, size=(5, 3 * bn)).astype(np.int8)
    packed = tt.pack_int4(torch.from_numpy(q), bn)
    assert_same(packed, jt.pack_int4(jnp.asarray(q), bn))
    assert_same(tt.unpack_int4(packed, bn), q)
    assert_same(tt.unpack_int4(packed, bn),
                jt.unpack_int4(jnp.asarray(packed.numpy()), bn))


def test_pack_rejects_a_width_that_does_not_divide():
    with pytest.raises(ValueError):
        tt.pack_int4(torch.zeros((2, 12), dtype=torch.int8), 8)


def test_qtensors_move_between_devices():
    q = tt.quantize_per_channel(torch.randn(8, 16))
    moved = q.to("cpu")
    assert isinstance(moved, tt.QTensor) and moved.shape == (8, 16)
    q4 = tt.quantize_int4_groupwise(torch.randn(128, 512))
    m4 = q4.to("cpu")
    assert (m4.group, m4.bn, m4.shape) == (128, 512, (128, 512))


def test_init_params_quantized_layout_matches_jax():
    jc, tc = model_cfgs("llama-tiny")
    jp = jmodel.init_params_quantized(jc, jax.random.key(0))
    tp = tmodel.init_params_quantized(tc, torch.Generator().manual_seed(0))
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in jleaves:
        t = tp
        for p in path:
            t = t[p.key] if hasattr(p, "key") else getattr(t, p.name)
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype) == f"torch.{leaf.dtype}", path
    wq = tp["layers"]["wq"]
    assert wq.values.abs().amax(dim=-2).eq(127).all()   # absmax per column
    assert isinstance(tp["lm_head"], tt.QTensor)


def test_quantize_params_matches_jitted_jax_and_bridges():
    """Stacked dense params -> INT8 per channel, bit-exact with
    ``jax.jit(quantize_params)``; the bridge takes the QTensor leaves."""
    jc, tc = model_cfgs("narrow-dh128")
    jp = jmodel.init_params(jc, jax.random.key(0))
    tp = tmodel.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tc)
    jq = jax.tree_util.tree_map(np.asarray,
                                jax.jit(jmodel.quantize_params)(jp))
    tq = tmodel.quantize_params(tp)
    bridged = tmodel.params_from_jax(jq, tc)
    for key in ("wq", "w_gate", "w_down"):
        for a in (tq["layers"][key], bridged["layers"][key]):
            assert isinstance(a, tt.QTensor)
            assert_same(a.values, jq["layers"][key].values)
            assert_same(a.scales, jq["layers"][key].scales)
    assert_same(tq["lm_head"].values, jq["lm_head"].values)
    assert tq["layers"]["ln1_scale"] is tp["layers"]["ln1_scale"]


def test_engine_layout_int4_bridges_from_the_jax_engine_layout():
    """Unstacked, fused, INT4-repacked params (the JAX engine's layout):
    the bridge rebuilds every Q4Tensor with its group and bn, and the
    port's own repacking of the same INT8 weights picks the same layout
    (the JAX engine repacks eagerly, so its scales may differ from the
    compiled quantizer's by an f32 step)."""
    jc, tc = model_cfgs("narrow-dh128")
    jp = jmodel.fuse_projections(jmodel.unstack_layers(
        jax.jit(jmodel.quantize_params)(jmodel.init_params(
            jc, jax.random.key(0)))))
    tp = tmodel.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tc)
    assert isinstance(tp["layers"], tuple) and len(tp["layers"]) == 2
    j4 = jmodel.quantize_params_int4(dict(jp, layers=tuple(
        dict(lp) for lp in jp["layers"])))
    b4 = tmodel.params_from_jax(jax.tree_util.tree_map(np.asarray, j4), tc)
    t4 = tmodel.quantize_params_int4(tp)
    for key in ("w_qkv", "wo", "w_gu", "w_down"):
        a, b = b4["layers"][0][key], t4["layers"][0][key]
        assert isinstance(a, tt.Q4Tensor) and (a.group, a.bn) == (b.group,
                                                                b.bn)
        assert a.packed.shape == b.packed.shape
    assert isinstance(t4["lm_head"], tt.Q4Tensor)
