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


@pytest.mark.parametrize("M,x_dtype,gemv_ok,route", [
    (1, torch.bfloat16, True, "gemv"),       # decode: the matrix-vector
    (16, torch.bfloat16, True, "gemv"),
    (16, torch.float32, True, "gemv"),
    (4, torch.bfloat16, False, "tiles"),     # a ragged N at decode
    (17, torch.bfloat16, True, "wgmma"),     # past 16 rows, bf16 x: the
    (36, torch.bfloat16, True, "wgmma"),     # tensor cores
    (256, torch.bfloat16, False, "wgmma"),   # (the wrapper pads N)
    (1024, torch.bfloat16, True, "wgmma"),
    (17, torch.float32, True, "tiles"),      # f32 x: no exact f32 product
    (256, torch.float32, True, "tiles")])    # on the tensor cores
def test_w8_route(M, x_dtype, gemv_ok, route):
    """B11's route as a plain function of M and x's dtype (and, through
    16 rows, whether the matrix-vector kernel takes the shapes)."""
    r, splits, kps = i8.w8_plan(M, 4096, 6144, x_dtype, gemv_ok)
    assert r == route
    if route == "tiles":
        assert (splits, kps) == (1, 4096)
    if route == "gemv":
        assert (splits, kps) == i8.w8_gemv_plan(M, 4096, 6144, x_dtype)


@pytest.mark.parametrize("M,K,N,splits", [
    (256, 4096, 6144, 2),      # Llama-3-8B qkv at prefill: 48 tiles
    (256, 4096, 4096, 4),      # o: 32 tiles
    (256, 4096, 28672, 1),     # gate|up: 224 tiles fill the SMs
    (256, 14336, 4096, 4),     # down
    (256, 4096, 128256, 1),    # the LM head
    (36, 4096, 128256, 1),     # the head at a verify chunk
    (36, 4096, 6144, 5),
    (1024, 4096, 6144, 1),     # Mixtral-8x7B's qkv at (k)'s prefill chunk
    (1024, 4096, 32000, 1),    # its head
    (17, 4096, 256, 16)])      # one tile: as many splits as allowed
def test_w8_split_plan(M, K, N, splits):
    """B11's tensor-core splits: whole k-tiles of 64 covering K, one wave
    of blocks at most, none where the tiles fill the SMs."""
    r, s, kps = i8.w8_plan(M, K, N, torch.bfloat16)
    assert r == "wgmma" and s == splits
    assert kps % i8.W8_K == 0 and s * kps >= K > (s - 1) * kps
    tiles = i8.wgmma_tiles(M, N, i8.W8_COLS)
    assert tiles == -(-M // i8.wgmma_rows(M)) * -(-N // 256)
    if tiles >= i8.SMS:
        assert s == 1
    else:
        assert tiles * s <= i8.SMS and s <= i8._MAX_SPLITS


@pytest.mark.parametrize("splits", range(1, 17))
def test_w8_plan_reaches_every_split(splits):
    """One output tile over ``splits`` k-tiles of 64 is split once a
    k-tile: the shapes by which the card's tests reach every split
    count of B11's tensor-core kernel."""
    assert i8.w8_plan(17, 64 * splits, 16, torch.bfloat16) == (
        "wgmma", splits, 64)


def exact_w8_inputs(M, K, N, seed):
    """bf16 x of small integers and INT8 weights: every product and
    partial sum is an exact f32 integer, so no order of the sums (and no
    zero padding) can move a result."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-8, 9, size=(M, K)).astype(
        np.float32)).to(torch.bfloat16)
    wq = torch.from_numpy(rng.integers(-127, 128, size=(K, N)).astype(
        np.int8))
    scales = torch.from_numpy((rng.random(N) * 1e-3).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=N).astype(np.float32))
    return x, wq, scales, bias


@pytest.mark.parametrize("M,K,N", [(17, 70, 36), (36, 300, 200),
                                   (65, 1000, 1000), (64, 256, 384)])
def test_w8_operands_padding_keeps_the_product(M, K, N):
    """K zero-padded to 8 and N to 16 (the tensor-core kernel's 16-byte
    rows) through the plain version give the unpadded result bit for bit
    once the padded columns are dropped; aligned shapes pass through
    untouched."""
    x, wq, scales, bias = exact_w8_inputs(M, K, N, seed=9)
    px, pw, ps, pb, n_pad = i8.w8_operands(x, wq, scales, bias)
    assert n_pad % 16 == 0 and px.shape[1] % 8 == 0
    assert pw.shape == (px.shape[1], n_pad) and ps.shape == pb.shape == (
        n_pad,)
    for act in (None, "silu"):
        for out_dtype in (torch.float32, torch.bfloat16):
            ref = i8.w8_matmul_plain(x, wq, scales, bias, act=act,
                                     out_dtype=out_dtype)
            out = i8.w8_matmul_plain(px, pw, ps, pb, act=act,
                                     out_dtype=out_dtype)
            assert torch.equal(out[:, :N], ref)
    if K % 8 == 0 and N % 16 == 0:
        assert px is x and pw is wq


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_preset_products_need_no_w8_padding(name):
    """Every preset's weight-only INT8 products (the projections, fused
    and not, and the LM head) have K % 8 == 0 and N % 16 == 0, so
    :func:`w8_operands` hands B11's tensor-core kernel the weight itself;
    the one exception is GPT-2's vocabulary of 50,257, whose head the
    wrapper pads on every call past 16 rows."""
    c = PRESETS[name]
    D, q, kv = c.hidden_size, c.num_heads * c.head_dim, \
        c.num_kv_heads * c.head_dim
    I_ = c.intermediate_size
    x = torch.zeros((17, 8), dtype=torch.bfloat16)
    shapes = [(D, q), (D, kv), (q, D), (D, I_), (I_, D), (D, q + 2 * kv),
              (D, 2 * I_), (D, c.vocab_size)]
    for K, N in shapes:
        wq = torch.zeros((K, N), dtype=torch.int8)
        xk = x.new_zeros((17, K))
        px, pw, _, _, n_pad = i8.w8_operands(xk, wq, torch.ones(N), None)
        padded = not (pw is wq and px is xk and n_pad == N)
        assert padded == (name == "gpt2-124m" and N == c.vocab_size), (K, N)


def test_swapped_w8_tiles_move_the_plain_output():
    """The controls of the card's B11 checks (one bf16 step or 1e-5 of
    max|out|): a kernel that read two of the weight's 64-row k-tiles, or
    two of its 256-column blocks, in each other's place would give an
    output outside that tolerance."""
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.normal(size=(36, 256)).astype(
        np.float32)).to(torch.bfloat16)
    wq = tt.quantize_per_channel(torch.from_numpy(
        rng.normal(size=(256, 768)).astype(np.float32) * 0.05))
    ref = i8.w8_matmul_plain(x, wq.values, wq.scales).float()
    k_swapped = torch.cat([wq.values[64:128], wq.values[:64],
                           wq.values[128:]])
    n_swapped = torch.cat([wq.values[:, 256:512], wq.values[:, :256],
                           wq.values[:, 512:]], dim=1)
    for w in (k_swapped, n_swapped):
        moved = i8.w8_matmul_plain(x, w, wq.scales).float()
        step = torch.exp2(torch.floor(torch.log2(
            ref.abs().clamp_min(2.0 ** -126))) - 7)
        tol = torch.maximum(step, 1e-5 * ref.abs().max())
        assert ((moved - ref).abs() > tol).float().mean() > 0.3


#: B11's decode shapes: Mixtral-8x7B's expert gate|up and down (path (k)),
#: Llama-3-8B's four projections and LM head, and a K that is no multiple
#: of a split's rows
GEMV_SHAPES = [(4096, 28672), (14336, 4096), (4096, 6144), (4096, 4096),
               (4096, 128256), (4112, 1024), (512, 256)]


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M", range(1, 17))
def test_w8_gemv_plan(M, x_dtype):
    """B11's matrix-vector plan at every decode row count: whole 16-row
    k-steps covering K, each split's rows of x (times x's planes) within
    the stage, and no more tiles than one wave of blocks unless the stage
    alone asks for the splits."""
    planes = 1 if x_dtype == torch.bfloat16 else 3
    rows = i8.w8_gemv_rows(M)
    assert rows >= M and rows & (rows - 1) == 0 and rows <= 16
    for K, N in GEMV_SHAPES:
        splits, kps = i8.w8_gemv_plan(M, K, N, x_dtype)
        assert kps % i8.W8_GEMV_K == 0
        assert splits * kps >= K > (splits - 1) * kps
        assert planes * kps * rows <= 2 * i8.W8_GEMV_STAGE
        tiles = -(-N // i8.W8_GEMV_COLS)
        least = -(-K // (2 * i8.W8_GEMV_STAGE // (planes * rows)
                         // 16 * 16))
        if tiles * least >= i8.SMS:
            assert splits == least
        else:
            assert tiles * splits <= i8.SMS
        assert i8.w8_plan(M, K, N, x_dtype) == ("gemv", splits, kps)


@pytest.mark.parametrize("M,K,N,x_dtype,plan", [
    (4, 4096, 28672, torch.bfloat16, (1, 4096)),    # expert gate|up: 224
    (4, 14336, 4096, torch.bfloat16, (4, 3584)),    # expert down: 32 tiles
    (4, 4096, 6144, torch.bfloat16, (2, 2048)),     # qkv: 48 tiles
    (4, 4096, 4096, torch.bfloat16, (4, 1024)),     # o
    (4, 4096, 128256, torch.bfloat16, (1, 4096)),   # the head: 1002 tiles
    (4, 4096, 28672, torch.float32, (2, 2048)),     # three planes: the
    (16, 14336, 4096, torch.bfloat16, (7, 2048)),   # stage splits K
    (1, 256, 512, torch.bfloat16, (2, 128))])       # a k-step a warp
def test_w8_gemv_plan_at_the_paths_shapes(M, K, N, x_dtype, plan):
    assert i8.w8_gemv_plan(M, K, N, x_dtype) == plan


@pytest.mark.parametrize("splits", range(1, 17))
def test_w8_gemv_plan_reaches_every_split(splits):
    """One column tile over ``splits`` rounds of the block's 8 warps'
    k-steps is split once a round: the shapes by which the card's tests
    reach every split count of B11's matrix-vector kernel."""
    K = i8.W8_GEMV_K * i8.W8_GEMV_WARPS * splits
    assert i8.w8_gemv_plan(4, K, 128, torch.bfloat16) == (splits, 128)


def test_x_planes_sum_exactly():
    """f32 x as the kernel stages it: three bf16 planes whose sum is x
    exactly (f32's 24 significant bits in three bf16 of 8), for values
    across f32's range (up to bf16's largest finite value, past which the
    first plane rounds to infinity); bf16 x is one plane, itself."""
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(4, 4096)) * np.exp2(
        rng.integers(-60, 60, size=(4, 4096)))).astype(np.float32)
    x[0, :4] = [np.float32(1 + 2.0 ** -23), -np.float32(3.38e38),
                np.float32(1e-30), 0.0]
    xt = torch.from_numpy(x)
    planes = i8.x_planes(xt)
    assert len(planes) == 3
    assert all(torch.equal(p, p.to(torch.bfloat16).float()) for p in planes)
    assert torch.equal(planes[0] + planes[1] + planes[2], xt)
    assert torch.equal((planes[0].double() + planes[1].double()
                        + planes[2].double()).float(), xt)
    xb = xt.to(torch.bfloat16)
    (only,) = i8.x_planes(xb)
    assert torch.equal(only, xb.float())


@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("M,K,N,splits", [
    (4, 512, 384, None), (13, 1000, 256, None), (1, 256, 128, 1),
    (3, 1024, 128, 8), (16, 4096, 128, 3)])
def test_w8_gemv_emulation_matches_plain_and_jax(M, K, N, splits, x_dtype):
    """The matrix-vector kernel's order of work (splits in split order,
    each over 8 warps' k-steps in warp order, x as its bf16 planes, K
    padded to 16) against the plain version and the JAX kernel: one bf16
    step for bf16 out, 1e-5 of max|out| for f32 out."""
    x, w, b = inputs(M, K, N, seed=12)
    xj = jnp.asarray(x, JDT[x_dtype])
    wj = jt.quantize_per_channel(jnp.asarray(w))
    xt, wq = t(xj), tt.quantize_per_channel(torch.from_numpy(w))
    assert torch.equal(wq.values, t(wj.values))
    for out_dtype, act in (("bfloat16", None), ("float32", "gelu")):
        kw = dict(act=act, out_dtype=TDT[out_dtype])
        emu = i8.w8_gemv_emulation(xt, wq.values, wq.scales,
                                   torch.from_numpy(b), splits=splits, **kw)
        ref = i8.w8_matmul_plain(xt, wq.values, wq.scales,
                                 torch.from_numpy(b), **kw)
        jref = jax_w8_matmul(xj, wj.values, wj.scales, jnp.asarray(b),
                             act=act, out_dtype=JDT[out_dtype],
                             interpret=True)
        for r in (ref.float().numpy(), np.asarray(jref, np.float32)):
            e = emu.float().numpy()
            if out_dtype == "bfloat16":
                within_bf16_step(e, r)
            else:
                np.testing.assert_allclose(e, r, rtol=0,
                                           atol=1e-5 * np.abs(r).max())


@pytest.mark.parametrize("M,K,N", [(4, 1000, 1024), (16, 70, 128),
                                   (1, 4096, 256)])
def test_w8_gemv_operands_padding_keeps_the_product(M, K, N):
    """K zero-padded to 16 (the gemv's k-step) through the plain version
    gives the unpadded result bit for bit; K a multiple of 16 passes
    through untouched."""
    x, wq, scales, bias = exact_w8_inputs(M, K, N, seed=13)
    px, pw = i8.w8_gemv_operands(x, wq)
    assert px.shape == (M, -(-K // 16) * 16) and pw.shape == (px.shape[1],
                                                              N)
    for act in (None, "silu"):
        ref = i8.w8_matmul_plain(x, wq, scales, bias, act=act)
        assert torch.equal(i8.w8_matmul_plain(px, pw, scales, bias,
                                              act=act), ref)
    if K % 16 == 0:
        assert px is x and pw is wq


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_preset_products_need_no_gemv_padding(name):
    """Every preset's weight-only INT8 products have K % 16 == 0, so
    :func:`w8_gemv_operands` hands B11's matrix-vector kernel the weight
    itself at every decode step."""
    c = PRESETS[name]
    q, kv = c.num_heads * c.head_dim, c.num_kv_heads * c.head_dim
    for K in (c.hidden_size, q, c.intermediate_size):
        wq = torch.zeros((K, 16), dtype=torch.int8)
        x = torch.zeros((4, K), dtype=torch.bfloat16)
        px, pw = i8.w8_gemv_operands(x, wq)
        assert px is x and pw is wq, (name, K)
