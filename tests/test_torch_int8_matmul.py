"""INT8-weight products of the PyTorch port (B10 ``int8_matmul``, B11
``w8_matmul``) and its ``linear`` dispatch, against the JAX package's
Pallas kernels in interpret mode (as ``tests/test_int8_matmul.py`` runs
them) and its ``linear``, on inputs from one numpy seed. On the CPU the
port's wrappers run their plain versions.

Tolerances:

* B10 is bit-exact with no activation and with ``relu`` (s32 sums are
  exact; the epilogue rounds as XLA does, with ``* w_scale + bias`` one
  fused multiply-add). With ``gelu``/``silu`` the activations themselves
  differ (XLA's tanh/exp against PyTorch's): bf16 outputs within one bf16
  step (or 1e-6 of max|output| where GELU's cancellation makes an output
  tiny), f32 outputs within 2^-21 relative and 2^-21 of max|output|
  absolute (the activations' own differences).
* B11 sums f32 products in another order than XLA: bf16 x gives exact
  products, so bf16 outputs within one bf16 step; f32 outputs within
  1e-5 of max|output|.
* The dense ``linear`` in bf16 with bias and activation (the repaired
  rounding): bit-exact on inputs whose sums are exact in any order.

``tests/test_torch_cuda.py`` holds the CUDA kernels against the plain
versions on a card.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pagedattention_based_transformer_decoder_inference_framework_tpu.ops import linear as jlinear
from pagedattention_based_transformer_decoder_inference_framework_tpu.ops.int8_matmul import (
    int8_matmul as jax_int8_matmul,
    w8_matmul as jax_w8_matmul,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu.quant import tensor as jt
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.ops import (
    int8_matmul as i8,
    linear as tlinear,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.config import PRESETS
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.quant import tensor as tt

SHAPES = [(1, 300, 200), (4, 256, 384), (37, 130, 70)]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def t(a):
    """A JAX/numpy array as a torch tensor of the same dtype."""
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def bf16_step(v: np.ndarray) -> np.ndarray:
    """One bf16 step (ulp) at each magnitude of ``v``."""
    mag = np.maximum(np.abs(v), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


def within_bf16_step(out, ref):
    """``|out - ref|`` at most one bf16 step of ``ref``, or 1e-6 of
    max|ref| where the activation's cancellation makes an output tiny."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    tol = np.maximum(bf16_step(ref), 1e-6 * np.abs(ref).max())
    assert (np.abs(out - ref) <= tol).all(), np.abs(out - ref).max()


def assert_close(out, ref, out_dtype, act, exact_acts):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    if act in exact_acts:
        np.testing.assert_array_equal(out, ref)
    elif out_dtype == "bfloat16":
        within_bf16_step(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=2.0 ** -21,
                                   atol=2.0 ** -21 * np.abs(ref).max())


def inputs(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(size=(K, N)).astype(np.float32) * 0.05
    b = rng.normal(size=(N,)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", [None, "relu", "gelu", "silu"])
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_int8_matmul_plain_matches_jax_kernel(M, K, N, act, out_dtype):
    x, w, b = inputs(M, K, N)
    xq = jt.quantize_per_row(jnp.asarray(x))
    wq = jt.quantize_per_channel(jnp.asarray(w))
    for bias in (None, b):
        jb = None if bias is None else jnp.asarray(bias)
        ref = jax_int8_matmul(xq.values, xq.scales, wq.values, wq.scales,
                              jb, act=act, out_dtype=JDT[out_dtype],
                              interpret=True).astype(jnp.float32)
        out = i8.int8_matmul(t(xq.values), t(xq.scales), t(wq.values),
                             t(wq.scales), None if bias is None else
                             torch.from_numpy(bias), act=act,
                             out_dtype=TDT[out_dtype])
        assert out.dtype == TDT[out_dtype] and out.shape == (M, N)
        assert_close(out.float(), ref, out_dtype, act, (None, "relu"))


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", [None, "relu", "silu"])
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_linear_w8a8_matches_jax_linear(M, K, N, act, x_dtype):
    """The port's ``linear`` (per-row quantization, then B10) against the
    JAX package's ``linear(..., w8a8=True)`` under ``jit``, as its
    engine runs it; with a bias."""
    x, w, b = inputs(M, K, N, seed=1)
    xj = jnp.asarray(x).astype(JDT[x_dtype])
    bj = jnp.asarray(b).astype(JDT[x_dtype])
    wq = jt.quantize_per_channel(jnp.asarray(w))
    ref = jax.jit(lambda x_, b_: jlinear.linear(x_, wq, b_, act, w8a8=True)
                  )(xj, bj).astype(jnp.float32)
    out = tlinear.linear(t(xj), tt.QTensor(t(wq.values), t(wq.scales)),
                         t(bj), act, w8a8=True)
    assert out.dtype == TDT[x_dtype]
    assert_close(out.float(), ref, x_dtype, act, (None, "relu"))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_w8_matmul_plain_matches_jax_kernel(M, K, N, x_dtype, out_dtype):
    x, w, b = inputs(M, K, N, seed=2)
    xj = jnp.asarray(x).astype(JDT[x_dtype])
    wq = jt.quantize_per_channel(jnp.asarray(w))
    ref = np.asarray(jax_w8_matmul(xj, wq.values, wq.scales, jnp.asarray(b),
                                   act="gelu", out_dtype=JDT[out_dtype],
                                   interpret=True).astype(jnp.float32))
    out = i8.w8_matmul(t(xj), t(wq.values), t(wq.scales),
                       torch.from_numpy(b), act="gelu",
                       out_dtype=TDT[out_dtype]).float().numpy()
    if out_dtype == "bfloat16":
        within_bf16_step(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def test_linear_weight_only_matches_jax_linear():
    x, w, b = inputs(4, 256, 384, seed=3)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    wq = jt.quantize_per_channel(jnp.asarray(w))
    ref = jax.jit(lambda x_: jlinear.linear(x_, wq))(xj[None])
    out = tlinear.linear(t(xj)[None], tt.QTensor(t(wq.values),
                                                 t(wq.scales)))
    assert out.shape == (1, 4, 384) and out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def exact_sum_inputs(seed=4):
    """bf16 inputs on a grid coarse enough that every product and partial
    sum is an exact f32, so no summation order can move a result."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-64, 65, size=(64, 256)) / 16).astype(np.float32)
    w = (rng.integers(-64, 65, size=(256, 512)) / 64).astype(np.float32)
    b = rng.normal(size=(512,)).astype(np.float32)
    return (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w, b))


def rounded_early(x, w, bias, act):
    """The dense ``linear`` before the repair: the product rounded to
    bf16, then bias and activation."""
    y = torch.matmul(x, w).float()
    if bias is not None:
        y = y + bias.float()
    if act is not None:
        y = tlinear.activation_fn(act)(y)
    return y.to(x.dtype)


@pytest.mark.parametrize("act", [None, "relu", "silu"])
def test_dense_linear_bf16_rounds_once_like_jax(act):
    """With a bias (and an activation) the product stays f32 until one
    final rounding, as in the JAX package; rounding the product first,
    as the port did, moves thousands of outputs by a bf16 step."""
    xj, wj, bj = exact_sum_inputs()
    ref = np.asarray(jax.jit(lambda a, b_, c: jlinear.linear(
        a, b_, c, act))(xj, wj, bj).astype(jnp.float32))
    out = tlinear.linear(t(xj), t(wj), t(bj), act)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), ref)
    early = rounded_early(t(xj), t(wj), t(bj), act).float().numpy()
    assert (early != ref).sum() > 1000


def test_dense_linear_gelu_within_one_bf16_step():
    """XLA's tanh-approximate GELU differs from PyTorch's in f32, so with
    ``gelu`` the dense ``linear`` agrees with JAX's within one bf16
    step (and most outputs exactly)."""
    xj, wj, bj = exact_sum_inputs(seed=5)
    ref = np.asarray(jax.jit(lambda a, b_, c: jlinear.linear(
        a, b_, c, "gelu"))(xj, wj, bj).astype(jnp.float32))
    out = tlinear.linear(t(xj), t(wj), t(bj), "gelu").float().numpy()
    within_bf16_step(out, ref)
    assert (out == ref).mean() > 0.95


def test_dense_linear_without_bias_is_one_gemm():
    xj, wj, _ = exact_sum_inputs(seed=6)
    x, w = t(xj), t(wj)
    assert torch.equal(tlinear.linear(x, w), torch.matmul(x, w))


@pytest.mark.parametrize("M,K,N,gemv,splits", [
    (4, 4096, 6144, True, 6),          # qkv of Llama-3-8B at decode
    (4, 4096, 28672, True, 2),         # gate-up
    (4, 14336, 4096, True, 9),         # down
    (4, 4096, 128256, True, 1),        # the LM head
    (16, 4096, 4096, True, 3),
    (17, 4096, 4096, False, 1),        # past the matrix-vector rows
    (256, 4096, 6144, False, 1),       # prefill
    (1, 130, 96, True, 2)])
def test_launch_plan(M, K, N, gemv, splits):
    g, s, kps = i8.plan(M, K, N, True)
    assert (g, s) == (gemv, splits)
    assert kps % 4 == 0 and s * kps >= K > (s - 1) * kps
    assert i8.plan(M, K, N, False) == (False, 1, K)


def test_wrappers_reject_bad_operands():
    xq = torch.zeros((2, 8), dtype=torch.int8)
    wq = torch.zeros((8, 4), dtype=torch.int8)
    with pytest.raises(ValueError):
        i8.int8_matmul(xq, torch.ones(2, 1), wq.float(), torch.ones(1, 4))
    with pytest.raises(ValueError):
        i8.int8_matmul(xq, torch.ones(2, 1), wq, torch.ones(1, 3))
    with pytest.raises(ValueError):
        i8.w8_matmul(torch.zeros(2, 7), wq, torch.ones(1, 4))
    with pytest.raises(ValueError):
        i8.act_code("tanh")


@pytest.mark.parametrize("M,K,N,gemv,splits", [
    (1, 4096, 6144, True, 6),          # decode rows: the matrix-vector kernel
    (16, 4096, 4096, True, 3),
    (17, 4096, 4096, False, 4),        # past it: the tensor-core kernel
    (36, 4096, 6144, False, 2),        # a verify chunk's qkv: 48 tiles
    (36, 14336, 4096, False, 4),
    (256, 4096, 6144, False, 1),       # prefill qkv: 96 tiles
    (256, 4096, 4096, False, 2),       # o: 64 tiles
    (256, 4096, 28672, False, 1),      # gate-up: 448 tiles fill the SMs
    (256, 14336, 4096, False, 2),      # down
    (300, 4096, 4096, False, 1),
    (17, 300, 208, False, 3)])
def test_int8_route_and_split_plan(M, K, N, gemv, splits):
    """B10's route by M alone (the matrix-vector kernel through 16 rows,
    the tensor-core kernel past it) and the tensor-core kernel's splits:
    whole k-tiles, covering K, none where the tiles fill the SMs, and no
    more than one wave of blocks."""
    g, s, kps = i8.int8_plan(M, K, N)
    assert (g, s) == (gemv, splits)
    assert s * kps >= K > (s - 1) * kps
    if gemv:
        assert (g, s, kps) == i8.plan(M, K, N, True)
        return
    assert kps % i8.WGMMA_K == 0 and s <= i8._MAX_SPLITS
    tiles = i8.wgmma_tiles(M, N)
    if tiles >= i8.SMS:
        assert s == 1
    else:
        assert tiles * s <= i8.SMS


@pytest.mark.parametrize("splits", range(1, 17))
def test_wgmma_plan_reaches_every_split(splits):
    """One output tile over ``splits`` k-tiles is split once a k-tile: the
    shapes by which the card's tests reach every split count."""
    assert i8.wgmma_plan(17, 128 * splits, 16) == (splits, 128)


@pytest.mark.parametrize("M,K,N", [(17, 70, 36), (36, 300, 200),
                                   (5, 1000, 1000), (64, 256, 384)])
def test_int8_operands_padding_keeps_the_product(M, K, N):
    """Zero-padded K and N (the kernels' 16-byte rows) through the plain
    version give the unpadded result bit for bit once the padded columns
    are dropped; aligned shapes pass through untouched."""
    x, w, b = inputs(M, K, N, seed=7)
    xq, wq = tt.quantize_per_row(torch.from_numpy(x)), \
        tt.quantize_per_channel(torch.from_numpy(w))
    bias = torch.from_numpy(b)
    px, pw, ps, pb, n_pad = i8.int8_operands(
        xq.values, wq.values, wq.scales.reshape(N), bias)
    assert n_pad % 16 == 0 and px.shape[1] % 16 == 0
    assert pw.shape == (px.shape[1], n_pad) and ps.shape == pb.shape == (
        n_pad,)
    for act in (None, "silu"):
        ref = i8.int8_matmul_plain(xq.values, xq.scales, wq.values,
                                   wq.scales, bias, act=act)
        out = i8.int8_matmul_plain(px, xq.scales, pw, ps, pb, act=act)
        assert torch.equal(out[:, :N], ref)
    if K % 16 == 0 and N % 16 == 0:
        assert px is xq.values and pw is wq.values


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_preset_projections_need_no_padding(name):
    """Every preset's w8a8 projections (q, k, v, o, gate, up, down, and
    the fused qkv and gate|up) have K and N in multiples of 16, so
    :func:`int8_operands` hands B10 the weight itself, with no copy, on
    every model path."""
    c = PRESETS[name]
    D, q, kv = c.hidden_size, c.num_heads * c.head_dim, \
        c.num_kv_heads * c.head_dim
    I_ = c.intermediate_size
    for K, N in [(D, q), (D, kv), (q, D), (D, I_), (I_, D), (D, q + 2 * kv),
                 (D, 2 * I_)]:
        wq = torch.zeros((K, N), dtype=torch.int8)
        xq = torch.zeros((17, K), dtype=torch.int8)
        px, pw, _, _, n_pad = i8.int8_operands(xq, wq, torch.ones(N), None)
        assert pw is wq and px is xq and n_pad == N, (K, N)


def test_swapped_k_tiles_move_the_plain_output():
    """The control of the card's bit-exact checks: a kernel that read two
    of the weight's 128-row k-tiles in each other's place would give
    another output, so an exact comparison can fail."""
    x, w, _ = inputs(36, 512, 256, seed=8)
    xq, wq = tt.quantize_per_row(torch.from_numpy(x)), \
        tt.quantize_per_channel(torch.from_numpy(w))
    swapped = torch.cat([wq.values[128:256], wq.values[:128],
                         wq.values[256:]])
    ref = i8.int8_matmul_plain(xq.values, xq.scales, wq.values, wq.scales)
    moved = i8.int8_matmul_plain(xq.values, xq.scales, swapped, wq.scales)
    assert (moved != ref).float().mean() > 0.5
