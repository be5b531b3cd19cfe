"""Paged attention of the PyTorch port (B1 ``paged_attention``, B2
``paged_attention_decode``) against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
kernels run in interpret mode, as ``tests/test_paged_attention.py`` runs
them. Inputs come from one numpy seed and go through both. Tolerance:
f32 atol/rtol 1e-5 (the two sum the same terms in another order).

``tests/test_torch_cuda.py`` holds the hand-written CUDA kernels
against the plain versions on a card.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pagedattention_based_transformer_decoder_inference_framework_tpu.ops.paged_attention import (
    paged_attention as jax_paged_attention,
    paged_attention_decode as jax_paged_attention_decode,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.ops import (
    paged_attention as pa,
)

PAGE, P, MP, L, LAYER, DH = 8, 32, 6, 2, 1, 128


def make_pool(rng, KH, pool_dtype):
    """Random pool ``[L, 2, KH, P, PAGE, DH]`` (+ flat INT8 scales) and a
    block table of distinct non-dump pages, as numpy."""
    shape = (L, 2, KH, P, PAGE, DH)
    if pool_dtype == "int8":
        vals = rng.integers(-127, 128, size=shape).astype(np.int8)
        scales = (rng.random((L, 2, KH, P * PAGE // 128, 128)) * 0.02
                  + 0.005).astype(np.float32)
        return (vals, scales)
    return (rng.normal(size=shape).astype(np.float32),)


def block_table(rng, B):
    return (rng.permutation(P - 1)[:B * MP] + 1).reshape(B, MP).astype(
        np.int32)


def to_jax(kv, pool_dtype):
    vals = jnp.asarray(kv[0])
    if pool_dtype == "bfloat16":
        vals = vals.astype(jnp.bfloat16)
    return vals, (jnp.asarray(kv[1]) if len(kv) == 2 else None)


def to_torch(kv, pool_dtype):
    vals = torch.from_numpy(kv[0])
    if pool_dtype == "bfloat16":
        vals = vals.to(torch.bfloat16)
    return vals, (torch.from_numpy(kv[1]) if len(kv) == 2 else None)


# (seq_lens, q_offsets, window, softcap) for a T=5 chunk and B=3:
# ragged first chunk (padding rows past a short prompt), and a second
# chunk with a sliding window and a tanh softcap
PREFILL_CASES = {
    "first_chunk_ragged": ([5, 3, 1], [0, 0, 0], 0, 0.0),
    "second_chunk_window_softcap": ([13, 40, 9], [8, 35, 4], 6, 20.0),
}


@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("pool_dtype", ["int8", "bfloat16"])
def test_paged_attention_matches_jax(pool_dtype, G, case):
    seq_lens, q_offsets, window, softcap = PREFILL_CASES[case]
    rng = np.random.default_rng(0)
    B, T, KH = 3, 5, 2
    H = KH * G
    kv = make_pool(rng, KH, pool_dtype)
    bt = block_table(rng, B)
    q = rng.normal(size=(B, T, H, DH)).astype(np.float32)
    sl = np.asarray(seq_lens, np.int32)
    qo = np.asarray(q_offsets, np.int32)
    scale = DH ** -0.5
    jvals, jsc = to_jax(kv, pool_dtype)
    ref = jax_paged_attention(
        jnp.asarray(q), jvals, jnp.asarray(bt), jnp.asarray(sl),
        jnp.asarray(qo), jsc, jnp.int32(LAYER), page_size=PAGE,
        num_q_heads=H, window=window, softcap=softcap, scale=scale,
        interpret=True)
    tvals, tsc = to_torch(kv, pool_dtype)
    out = pa.paged_attention(
        torch.from_numpy(q), tvals, torch.from_numpy(bt),
        torch.from_numpy(sl), torch.from_numpy(qo), tsc, LAYER,
        page_size=PAGE, num_q_heads=H, window=window, softcap=softcap,
        scale=scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (10, 20.0)])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("pool_dtype", ["int8", "bfloat16"])
def test_paged_attention_decode_matches_jax(pool_dtype, G, window,
                                            softcap):
    rng = np.random.default_rng(1)
    B, KH = 3, 2
    H = KH * G
    kv = make_pool(rng, KH, pool_dtype)
    bt = block_table(rng, B)
    q = rng.normal(size=(B, 1, H, DH)).astype(np.float32)
    sl = np.asarray([1, 17, MP * PAGE], np.int32)    # ragged, full table
    scale = DH ** -0.5
    jvals, jsc = to_jax(kv, pool_dtype)
    ref = jax_paged_attention_decode(
        jnp.asarray(q), jvals, jnp.asarray(bt), jnp.asarray(sl), jsc,
        jnp.int32(LAYER), page_size=PAGE, num_q_heads=H, window=window,
        softcap=softcap, scale=scale, interpret=True)
    tvals, tsc = to_torch(kv, pool_dtype)
    out = pa.paged_attention_decode(
        torch.from_numpy(q), tvals, torch.from_numpy(bt),
        torch.from_numpy(sl), tsc, LAYER, page_size=PAGE, num_q_heads=H,
        window=window, softcap=softcap, scale=scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_unported_variants_raise():
    q = torch.zeros((1, 1, 2, 64))
    kv = torch.zeros((1, 2, 1, 4, PAGE, 64))
    bt = torch.ones((1, 2), dtype=torch.int32)
    sl = torch.ones((1,), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="B6/B8"):
        pa.paged_attention_decode(q, kv, bt, sl, None, 0, page_size=PAGE,
                                  num_q_heads=2)
    with pytest.raises(NotImplementedError, match="beam"):
        pa.paged_attention(q, kv, bt, sl, sl - 1, None, 0, page_size=PAGE,
                           num_q_heads=2, return_scores=True)


@pytest.mark.parametrize("fault", ["scales_dtype", "scales_heads",
                                   "table_rows", "seq_lens"])
def test_attention_rejects_inputs_the_kernels_cannot_read(fault):
    """The kernels index the pool, scales and tables by raw pointers:
    every shape or type mismatch raises before a launch."""
    rng = np.random.default_rng(7)
    B, KH, H = 3, 2, 4
    vals, sc = to_torch(make_pool(rng, KH, "int8"), "int8")
    bt = torch.from_numpy(block_table(rng, B))
    sl = torch.ones((B,), dtype=torch.int32)
    if fault == "scales_dtype":
        sc = sc.double()
    elif fault == "scales_heads":
        sc = sc[:, :, :1]
    elif fault == "table_rows":
        bt = bt[:1]
    else:
        sl = sl[:1]
    q = torch.zeros((B, 1, H, DH))
    with pytest.raises(ValueError):
        pa.paged_attention_decode(q, vals, bt, sl, sc, LAYER, page_size=PAGE,
                                  num_q_heads=H)
