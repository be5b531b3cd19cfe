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
