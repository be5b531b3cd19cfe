"""KV appends and the pool of the PyTorch port (B3 decode append, B4
page-aligned prefill append, B5 token-chunk append, ``quantize_kv``,
``append_to_pages_at_layer``, ``gather_kv_dense``) against the JAX
package.

The same numpy inputs go through the JAX package's
``append_to_pages_at_layer`` and ``kv_append(interpret=True)`` and the
port's ``kv_append``. INT8 values and scales must match bit for bit;
f32 pools exactly. The JAX side runs compiled (``jax.jit``), as its
engine does: XLA turns ``absmax / 127.0`` into a multiply by the
reciprocal, which moves some scales by one f32 step against an eager
run, and the port follows the compiled form. ``tests/test_torch_cuda.py``
holds the CUDA kernels against their plain versions on a card.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pagedattention_based_transformer_decoder_inference_framework_tpu.kvcache import pool as jpool
from pagedattention_based_transformer_decoder_inference_framework_tpu.ops.kv_append import (
    kv_append as jax_kv_append,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.kvcache import pool as tpool
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.ops import (
    kv_append as ka,
)

L, KH, P, PAGE, DH, B = 2, 2, 24, 8, 128, 3


def empty_pools(kv_dtype):
    shape = (L, 2, KH, P, PAGE, DH)
    if kv_dtype == "int8":
        sc_shape = (L, 2, KH, -(-P * PAGE // 128), 128)
        return ((jnp.zeros(shape, jnp.int8), jnp.zeros(sc_shape, jnp.float32)),
                (torch.zeros(shape, dtype=torch.int8),
                 torch.zeros(sc_shape, dtype=torch.float32)))
    return ((jnp.zeros(shape, jnp.float32),),
            (torch.zeros(shape, dtype=torch.float32),))


def positions_for(T, lens, c0):
    pos = c0 + np.broadcast_to(np.arange(T), (B, T))
    return np.where(pos < np.asarray(lens)[:, None], pos, -1).astype(np.int32)


# (T, prompt lens, chunk start): the decode row (T=1; the middle lane
# is invalid, -1), a page-aligned first chunk with ragged prompts, and a
# page-aligned second chunk. The speculative verify chunks have no
# prompt lens and a start per lane (None: a frozen lane, all -1): T=5
# crossing a page (B5), and T=PAGE starting off a page boundary (B4 in
# the port and in the JAX package, whose TPU kernel would write it to
# whole pages; in interpret mode it runs the scatter, as the port does)
CASES = {
    "decode": (1, None, None),
    "prefill_first_chunk": (2 * PAGE, [16, 9, 1], 0),
    "prefill_second_chunk": (2 * PAGE, [30, 17, 20], 2 * PAGE),
    "spec_verify": (5, None, [6, None, 21]),
    "spec_verify_page": (PAGE, None, [3, 13, None]),
}


def verify_positions(T, starts):
    return np.asarray([[-1] * T if s is None else list(range(s, s + T))
                       for s in starts], np.int32)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kv_dtype", ["int8", "float32"])
def test_kv_append_matches_jax(kv_dtype, case):
    T, lens, c0 = CASES[case]
    rng = np.random.default_rng(3)
    bt = (rng.permutation(P - 1)[:B * 5] + 1).reshape(B, 5).astype(np.int32)
    k = rng.normal(size=(B, T, KH, DH)).astype(np.float32)
    v = rng.normal(size=(B, T, KH, DH)).astype(np.float32)
    if T == 1:
        pos = np.asarray([[12], [-1], [33]], np.int32)
    elif lens is None:
        pos = verify_positions(T, c0)
    else:
        pos = positions_for(T, lens, c0)
    jkv, tkv = empty_pools(kv_dtype)
    layer = 1
    ref = jax.jit(jpool.append_to_pages_at_layer)(
        jkv, jnp.asarray(k), jnp.asarray(v), jnp.int32(layer),
        jnp.asarray(pos), jnp.asarray(bt))
    ref2 = jax_kv_append(jkv, jnp.asarray(k), jnp.asarray(v),
                         jnp.int32(layer), jnp.asarray(pos), jnp.asarray(bt),
                         page_size=PAGE, interpret=True)
    out = ka.kv_append(tkv, torch.from_numpy(k), torch.from_numpy(v), layer,
                       torch.from_numpy(pos), torch.from_numpy(bt),
                       page_size=PAGE)
    assert out is tkv                          # updated in place
    for o, r, r2 in zip(out, ref, ref2):
        o, r, r2 = o.numpy(), np.asarray(r), np.asarray(r2)
        if o.shape[-1] == 128 and o.ndim == 5:
            # flat scales: compare the pool's P*PAGE real slots. The JAX
            # scatter sends an invalid token to slot P*PAGE, which lies in
            # the leaf's padding lanes when P*PAGE % 128 != 0 (never
            # read); the port drops it, so its padding stays zero
            o, r, r2 = (x.reshape(L, 2, KH, -1) for x in (o, r, r2))
            assert not o[..., P * PAGE:].any()
            o, r, r2 = (x[..., :P * PAGE] for x in (o, r, r2))
        np.testing.assert_array_equal(o, r)
        np.testing.assert_array_equal(o, r2)
    # something was written, and nothing landed on the dump page
    assert np.abs(out[0].numpy()).sum() > 0
    assert not out[0][:, :, :, 0].any()


def test_quantize_kv_bit_exact_with_ties():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(5, 3, 128)).astype(np.float32)
    # values that land exactly on .5 after scaling: round half to even
    x[0, 0, :4] = np.asarray([127.0, 0.5, 1.5, -2.5], np.float32)
    jq, js = jax.jit(jpool.quantize_kv)(jnp.asarray(x))
    tq, ts = tpool.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_gather_kv_dense_matches_jax():
    rng = np.random.default_rng(5)
    jkv, tkv = empty_pools("int8")
    bt = (rng.permutation(P - 1)[:B * 4] + 1).reshape(B, 4).astype(np.int32)
    T = 4 * PAGE
    k = rng.normal(size=(B, T, KH, DH)).astype(np.float32)
    v = rng.normal(size=(B, T, KH, DH)).astype(np.float32)
    pos = positions_for(T, [T, 20, 3], 0)
    jkv = jax.jit(jpool.append_to_pages_at_layer)(
        jkv, jnp.asarray(k), jnp.asarray(v), jnp.int32(0), jnp.asarray(pos),
        jnp.asarray(bt))
    tpool.append_to_pages_at_layer(tkv, torch.from_numpy(k),
                                   torch.from_numpy(v), 0,
                                   torch.from_numpy(pos),
                                   torch.from_numpy(bt))
    jk, jv = jpool.gather_kv_dense(tuple(x[0] for x in jkv),
                                   jnp.asarray(bt), 29)
    tk, tv = tpool.gather_kv_dense(tuple(x[0] for x in tkv),
                                   torch.from_numpy(bt), 29)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_non_aligned_chunk_raises_on_cuda_only():
    _, tkv = empty_pools("float32")
    k = torch.zeros((1, 3, KH, DH))
    pos = torch.arange(3, dtype=torch.int32)[None]
    bt = torch.ones((1, 2), dtype=torch.int32)
    ka.kv_append(tkv, k, k, 0, pos, bt, page_size=PAGE)   # plain on CPU
    with pytest.raises(ValueError, match="page-aligned"):
        ka.append_prefill(tkv, tpool.stack_new_kv(tkv, k, k), 0, pos, bt)


@pytest.mark.parametrize("fault", ["news_dtype", "news_shape",
                                   "scales_dtype", "table_rows"])
def test_append_rejects_inputs_the_kernels_cannot_copy(fault):
    """The kernels copy raw bytes: every mismatch raises before a launch
    (the wrappers check on the CPU too)."""
    _, tkv = empty_pools("int8")
    k = torch.zeros((B, 1, KH, DH))
    pos = torch.zeros((B, 1), dtype=torch.int32)
    bt = torch.ones((B, 2), dtype=torch.int32)
    news = tpool.stack_new_kv(tkv, k, k)
    if fault == "news_dtype":
        news = (news[0].float(), news[1])
    elif fault == "news_shape":
        news = tuple(x[:, :, :1] for x in news)
    elif fault == "scales_dtype":
        tkv = (tkv[0], tkv[1].double())
    else:
        bt = bt[:1]
    with pytest.raises(ValueError):
        ka.append_decode(tkv, news, 0, pos, bt)
