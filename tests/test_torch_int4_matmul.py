"""INT4-weight product of the PyTorch port (B12 ``w4_matmul``) and its
``linear`` dispatch, against the JAX package's Pallas kernel in interpret
mode (as ``tests/test_int4.py`` runs it), on inputs from one numpy seed.
On the CPU the port's wrapper runs its plain version: the f32 dequantized
weight and an f32 product.

Tolerance: the JAX kernel sums in another order and folds the low
nibble's -8 into a per-group row sum (``(x @ lo_u - 8 * rowsum(x)) *
scale``), which cancels; so outputs agree within 1e-5 of max|output|
(f32 out) or one bf16 step plus that (bf16 out). Above 32 rows the JAX
kernel feeds its matrix unit bf16 operands, so those cases take bf16 x,
which both compute exactly. Greedy token streams of whole engines are
held in ``tests/test_torch_engine.py``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pagedattention_based_transformer_decoder_inference_framework_tpu.ops import linear as jlinear
from pagedattention_based_transformer_decoder_inference_framework_tpu.ops.int4_matmul import (
    w4_matmul as jax_w4_matmul,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu.quant import tensor as jt
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.ops import (
    int4_matmul as i4,
    linear as tlinear,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.quant import tensor as tt

from test_torch_int8_matmul import JDT, TDT, bf16_step, t


def q4_pair(w, group=128):
    """One INT4 weight for both frameworks (quantized by ``jax.jit``)."""
    ref = jax.jit(jt.quantize_int4_groupwise, static_argnames=(
        "group", "bn", "col_shards"))(jnp.asarray(w), group=group)
    return ref, tt.Q4Tensor(t(ref.packed), t(ref.scales), ref.group, ref.bn)


def assert_close(out, ref, out_dtype):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    tol = 1e-5 * np.abs(ref).max()
    if out_dtype == "bfloat16":
        tol = tol + bf16_step(ref)
    assert (np.abs(out - ref) <= tol).all(), np.abs(out - ref).max()


# (M, K, N, group): decode rows, a 768-wide block (the Llama-3-8B LM
# head's), a K of one small group, and 37 rows (the kernel's bf16 path)
CASES = [(1, 256, 512, 128), (4, 384, 2304, 128), (4, 64, 200, 128),
         (37, 256, 768, 64)]


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("M,K,N,group", CASES)
def test_w4_matmul_plain_matches_jax_kernel(M, K, N, group, act, out_dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(size=(K, N)).astype(np.float32) * 0.05
    b = rng.normal(size=(N,)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16 if M > 32 else jnp.float32)
    jq, tq = q4_pair(w, group)
    ref = jax_w4_matmul(xj, jq.packed, jq.scales, jnp.asarray(b),
                        group=jq.group, bn=jq.bn, act=act,
                        out_dtype=JDT[out_dtype], interpret=True)
    out = i4.w4_matmul(t(xj), tq.packed, tq.scales, torch.from_numpy(b),
                       group=tq.group, bn=tq.bn, act=act,
                       out_dtype=TDT[out_dtype])
    assert out.dtype == TDT[out_dtype] and out.shape == (M, N)
    assert_close(out.float(), ref.astype(jnp.float32), out_dtype)


def test_w4_plain_is_the_dequantized_product():
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.normal(size=(256, 1536)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(3, 256)).astype(np.float32))
    q = tt.quantize_int4_groupwise(w)
    out = i4.w4_matmul_plain(x, q.packed, q.scales, group=q.group, bn=q.bn,
                             out_dtype=torch.float32)
    torch.testing.assert_close(out, x @ tt.dequantize_int4(q), rtol=0,
                               atol=0)


def test_linear_int4_matches_jax_linear():
    """The dispatch: a Q4Tensor goes to B12 with its own group and bn,
    leading dims flattened and restored."""
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.normal(size=(2, 3, 384)).astype(np.float32))
    w = rng.normal(size=(384, 2304)).astype(np.float32) * 0.05
    jq, tq = q4_pair(w)
    ref = jax.jit(lambda a: jlinear.linear(a, jq, act="relu"))(x)
    out = tlinear.linear(t(x), tq, act="relu")
    assert out.shape == (2, 3, 2304) and tq.bn == 768
    assert_close(out, ref, "float32")


def test_w4_wrapper_rejects_a_bad_layout():
    q = tt.quantize_int4_groupwise(torch.randn(128, 512))
    x = torch.randn(2, 128)
    with pytest.raises(ValueError):
        i4.w4_matmul(x, q.packed, q.scales, group=q.group, bn=384)
    with pytest.raises(ValueError):
        i4.w4_matmul(x, q.packed, q.scales[:, :8], group=q.group, bn=q.bn)
    with pytest.raises(ValueError):
        i4.w4_matmul(torch.randn(2, 64), q.packed, q.scales, group=q.group,
                     bn=q.bn)


BF16, F32 = torch.bfloat16, torch.float32


# B12's route (ops/int4_matmul.py::w4_plan), by M, x's dtype, bn (from
# N: int4_block_width), group and the carrier's / scales' alignment:
# (M, K, N, group, x dtype, aligned, route)
ROUTES = [
    (4, 4096, 6144, 128, BF16, True, "gemv"),     # a decode projection
    (16, 4096, 128256, 128, F32, True, "gemv"),   # the LM head, bn 768
    (1, 64, 512, 64, BF16, True, "gemv"),         # one group, unit 64
    (4, 96, 512, 96, BF16, True, "gemv"),         # a unit of the group (96)
    (4, 1000, 1024, 1000, BF16, True, "tiles"),   # unit 1000 % 16 != 0
    (4, 256, 200, 128, BF16, True, "tiles"),      # bn/2 = 100 % 16 != 0
    (4, 4096, 6144, 128, BF16, False, "tiles"),   # an unaligned carrier
    (17, 4096, 6144, 128, BF16, True, "wgmma"),
    (256, 4096, 128256, 128, BF16, True, "wgmma"),
    (300, 1024, 1280, 64, BF16, True, "wgmma"),   # bn 1280, groups of 64
    (256, 4096, 6144, 128, F32, True, "tiles"),   # f32 x past 16 rows
    (64, 1024, 320, 128, BF16, True, "tiles"),    # bn/2 = 160 % 128 != 0
    (64, 1024, 2048, 32, BF16, True, "tiles"),    # group 32 % 64 != 0
    (64, 4096, 6144, 128, BF16, False, "tiles"),
]


@pytest.mark.parametrize("M,K,N,group,x_dtype,aligned,route", ROUTES)
def test_w4_plan_routes(M, K, N, group, x_dtype, aligned, route):
    """The route and its K cut: the tensor-core kernel in whole 64-row
    k-tiles, at most 16 splits and no more blocks than one wave where K is
    split; the gemv in whole units of the group (64 rows or the group), no
    block staging more rows of x (times its bf16 planes) than it holds; the
    tiles over the whole of K."""
    bn = tt.int4_block_width(N)
    got, splits, kps = i4.w4_plan(M, K, N, group, bn, x_dtype, aligned)
    assert got == route
    assert splits * kps >= K > (splits - 1) * kps
    if route == "wgmma":
        tiles = -(-M // 64) * (N // 256)
        assert kps % 64 == 0 and 1 <= splits <= 16
        assert splits == 1 or tiles * splits <= 132
    elif route == "gemv":
        planes = 1 if x_dtype == BF16 else 3
        assert kps % i4.w4_unit(group) == 0
        assert kps * planes <= i4.W4_GEMV_STAGE
        assert (group % 64 == 0) == (i4.w4_unit(group) == 64)
    else:
        assert (splits, kps) == (1, K)


# the tensor-core kernel's tile order: (M, K, N, group) with bn 256, 768
# (the LM head's) and 1024, groups of 64 and 128
EMULATION = [(37, 256, 256, 64), (40, 512, 2304, 128), (33, 384, 1024, 64)]


@pytest.mark.parametrize("splits", [None, 3])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,group", EMULATION)
def test_w4_wgmma_emulation_matches_plain_and_jax(M, K, N, group, out_dtype,
                                                  splits):
    """``w4_wgmma_emulation``, the tensor-core kernel's order of work
    (carrier runs of 128 columns feeding a low and a high run of outputs,
    each K-group's exact product folded into the tile with its scales,
    the splits in order; 3 splits cut groups where K allows) with a bias
    and SiLU, against the plain version and the JAX kernel in interpret
    mode, at this file's tolerance."""
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(M, K)).astype(np.float32)).astype(
        jnp.bfloat16)
    w = rng.normal(size=(K, N)).astype(np.float32) * 0.05
    b = rng.normal(size=(N,)).astype(np.float32)
    jq, tq = q4_pair(w, group)
    assert tq.bn // 2 % 128 == 0 and tq.group % 64 == 0
    kw = dict(group=tq.group, bn=tq.bn, act="silu",
              out_dtype=TDT[out_dtype])
    args = (t(x), tq.packed, tq.scales, torch.from_numpy(b))
    out = i4.w4_wgmma_emulation(*args, splits=splits, **kw)
    assert out.dtype == TDT[out_dtype] and out.shape == (M, N)
    assert_close(out.float(), i4.w4_matmul_plain(*args, **kw).float(),
                 out_dtype)
    ref = jax_w4_matmul(x, jq.packed, jq.scales, jnp.asarray(b),
                        group=jq.group, bn=jq.bn, act="silu",
                        out_dtype=JDT[out_dtype], interpret=True)
    assert_close(out.float(), ref.astype(jnp.float32), out_dtype)


def test_w4_swapped_carrier_runs_leave_the_tolerance():
    """The control of the card's B12 checks: two 128-column carrier runs
    (the tensor-core kernel's raw tiles) read in each other's place move
    the plain output past this tolerance (and the card's), so a kernel
    that misread them would fail."""
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.normal(size=(256, 2304)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(40, 256)).astype(np.float32)).to(
        torch.bfloat16)
    q = tt.quantize_int4_groupwise(w * 0.05)
    p = q.packed
    swapped = torch.cat([p[:, 128:256], p[:, :128], p[:, 256:]], dim=1)
    kw = dict(group=q.group, bn=q.bn, out_dtype=torch.float32)
    ref = i4.w4_matmul_plain(x, p, q.scales, **kw)
    off = i4.w4_matmul_plain(x, swapped, q.scales, **kw)
    with pytest.raises(AssertionError):
        assert_close(off, ref, "bfloat16")
    assert_close(i4.w4_wgmma_emulation(x, p, q.scales, **kw), ref,
                 "float32")
