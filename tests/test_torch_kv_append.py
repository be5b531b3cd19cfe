"""KV appends and the pool of the PyTorch port (B3 decode append, B4
page-aligned prefill append, B5 token-chunk append, ``quantize_kv``,
``append_to_pages_at_layer``, ``gather_kv_dense``) against the JAX
package.

The same numpy inputs go through the JAX package's
``append_to_pages_at_layer`` and ``kv_append(interpret=True)`` and the
port's ``kv_append``. INT8 values and scales must match bit for bit;
f32 and bf16 pools exactly. The JAX side runs compiled (``jax.jit``), as
its engine does: XLA turns ``absmax / 127.0`` into a multiply by the
reciprocal, which moves some scales by one f32 step against an eager
run, and the port follows the compiled form. B3 and B5 take the model's
rows (bf16 or f32, views of a packed qkv tensor too) and quantize in the
kernel; their plain versions (``stack_new_kv`` then the scatter) are held
here against the JAX package with rows that pin the quantization
(``tests/_kv_rows.py``: exact ties, an all-zero row, a negative absmax, a
value where a reciprocal multiply would round to another code).
``tests/test_torch_cuda.py`` holds the CUDA kernels against their plain
versions on a card.
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

from _kv_rows import division_pair, edge_rows, plant_edge_rows, row_scale

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
                                   "scales_dtype", "table_rows",
                                   "rows_stride", "mixed_dtypes",
                                   "prefill_news_dtype",
                                   "prefill_news_shape"])
def test_append_rejects_inputs_the_kernels_cannot_copy(fault):
    """The kernels read the rows raw: every mismatch raises before a
    launch (the wrappers check on the CPU too). The rows' dtype must be
    bf16 or f32, their shape [B, T, KH, D] and their last dim
    contiguous; B4's (and B9's) ``news`` must be what ``stack_new_kv``
    makes for the pool, since those kernels copy its bytes."""
    _, tkv = empty_pools("int8")
    k = torch.zeros((B, 1, KH, DH))
    v = torch.zeros((B, 1, KH, DH))
    pos = torch.zeros((B, 1), dtype=torch.int32)
    bt = torch.ones((B, 2), dtype=torch.int32)
    if fault.startswith("prefill_"):
        rows = torch.zeros((B, PAGE, KH, DH))
        news = tpool.stack_new_kv(tkv, rows, rows)
        if fault == "prefill_news_dtype":
            news = (news[0].float(), news[1])
        else:
            news = tuple(x[:, :, :1] for x in news)
        pos = torch.arange(PAGE, dtype=torch.int32).expand(B, PAGE)
        with pytest.raises(ValueError, match="stack_new_kv"):
            ka.append_prefill(tkv, news, 0, pos, bt)
        return
    if fault == "news_dtype":
        k, v = k.double(), v.double()
    elif fault == "news_shape":
        k, v = k[:, :, :1], v[:, :, :1]
    elif fault == "scales_dtype":
        tkv = (tkv[0], tkv[1].double())
    elif fault == "table_rows":
        bt = bt[:1]
    elif fault == "rows_stride":
        k = torch.zeros((B, 1, KH, 2 * DH))[..., ::2]
    else:
        v = v.bfloat16()
    with pytest.raises(ValueError):
        ka.append_decode(tkv, k, v, 0, pos, bt)


# B3's and B5's rows, as the model hands them over: T=1 (the middle lane
# invalid), a 5-token and a 9-token verify chunk that cross a page (a
# frozen lane each), in bf16 or f32, contiguous or as views of a packed
# [B, T, (H + 2 KH) * D] qkv output
ROW_POSITIONS = {
    1: [[12], [-1], [33]],
    5: verify_positions(5, [6, None, 21]),
    9: verify_positions(9, [3, 13, None]),
}
H = 2 * KH


def model_rows(rng, T, rows_dtype, layout):
    """``k, v [B, T, KH, DH]`` for the port (torch, in ``rows_dtype``;
    ``packed``: views of one qkv tensor) and for the JAX package (the same
    values), with the edge rows planted."""
    qkv = rng.normal(size=(B, T, (H + 2 * KH) * DH)).astype(np.float32)
    k = qkv[..., H * DH:(H + KH) * DH].reshape(B, T, KH, DH)
    v = qkv[..., (H + KH) * DH:].reshape(B, T, KH, DH)
    plant_edge_rows(rng, k, v)
    qkv = qkv if layout == "packed" else None
    dt = getattr(torch, rows_dtype)
    if qkv is None:
        tk = torch.from_numpy(k.copy()).to(dt)
        tv = torch.from_numpy(v.copy()).to(dt)
    else:
        t = torch.from_numpy(qkv).to(dt)
        tk = t[..., H * DH:(H + KH) * DH].view(B, T, KH, DH)
        tv = t[..., (H + KH) * DH:].view(B, T, KH, DH)
        assert not tk.is_contiguous() and tk.stride(-1) == 1
    jdt = getattr(jnp, rows_dtype)
    return tk, tv, jnp.asarray(k).astype(jdt), jnp.asarray(v).astype(jdt)


def pools_for(kv_dtype):
    if kv_dtype != "bfloat16":
        return empty_pools(kv_dtype)
    shape = (L, 2, KH, P, PAGE, DH)
    return ((jnp.zeros(shape, jnp.bfloat16),),
            (torch.zeros(shape, dtype=torch.bfloat16),))


@pytest.mark.parametrize("layout", ["contiguous", "packed"])
@pytest.mark.parametrize("T", sorted(ROW_POSITIONS))
@pytest.mark.parametrize("rows_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_dtype", ["int8", "float32", "bfloat16"])
def test_rows_plain_matches_jax(kv_dtype, rows_dtype, T, layout):
    """B3's and B5's plain versions (the model's rows, quantized or cast
    on the way) and ``kv_append``'s dispatch against the JAX package's
    ``kv_append(interpret=True)`` and its jit'd ``append_to_pages_at_layer``
    (``stack_new_kv`` inside), bit for bit on every slot."""
    rng = np.random.default_rng(T + 7)
    bt = (rng.permutation(P - 1)[:B * 5] + 1).reshape(B, 5).astype(np.int32)
    pos = np.asarray(ROW_POSITIONS[T], np.int32)
    tk, tv, jk, jv = model_rows(rng, T, rows_dtype, layout)
    jkv, tkv = pools_for(kv_dtype)
    layer = 1
    ref = jax_kv_append(jkv, jk, jv, jnp.int32(layer), jnp.asarray(pos),
                        jnp.asarray(bt), page_size=PAGE, interpret=True)
    ref2 = jax.jit(jpool.append_to_pages_at_layer)(
        jkv, jk, jv, jnp.int32(layer), jnp.asarray(pos), jnp.asarray(bt))
    plain = ka.append_decode_plain if T == 1 else ka.append_tokens_plain
    outs = [plain(tkv, tk, tv, layer, torch.from_numpy(pos),
                  torch.from_numpy(bt))]
    _, tkv2 = pools_for(kv_dtype)
    outs.append(ka.kv_append(tkv2, tk, tv, layer, torch.from_numpy(pos),
                             torch.from_numpy(bt), page_size=PAGE))
    for out in outs:
        for o, r, r2 in zip(out, ref, ref2):
            o = o.float().numpy()
            r, r2 = np.asarray(r, np.float32), np.asarray(r2, np.float32)
            if o.ndim == 5 and o.shape[-1] == 128:   # the real slots
                o, r, r2 = (x.reshape(L, 2, KH, -1)[..., :P * PAGE]
                            for x in (o, r, r2))
            np.testing.assert_array_equal(o, r)
            np.testing.assert_array_equal(o, r2)
        assert np.abs(out[0].float().numpy()).sum() > 0
        assert not out[0][:, :, :, 0].any()          # nothing on the dump page


@pytest.mark.parametrize("rows_dtype", ["float32", "bfloat16"])
def test_stack_new_kv_edge_rows_match_jax(rows_dtype):
    """The quantization B3 and B5 reproduce, on the edge rows, against the
    JAX package's jit'd ``stack_new_kv``: ties to even, the all-zero row
    (every code 0, scale 1e-8 / 127), a negative absmax (-127), and the
    value whose code follows the IEEE division, not a multiply by the
    reciprocal."""
    rng = np.random.default_rng(11)
    rows = edge_rows(rng, DH)
    x = np.stack(list(rows.values()))[None, :, None]       # [1, 4, 1, DH]
    jkv, tkv = empty_pools("int8")
    dt, jdt = getattr(torch, rows_dtype), getattr(jnp, rows_dtype)
    tq, ts = tpool.stack_new_kv(tkv, torch.from_numpy(x).to(dt),
                                torch.from_numpy(x).to(dt))
    jq, js = jax.jit(jpool.stack_new_kv)(jkv, jnp.asarray(x).astype(jdt),
                                         jnp.asarray(x).astype(jdt))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    q, sc = tq[0, 0, 0].numpy(), ts[0, 0, 0, :, 0].numpy()
    names = list(rows)
    ties = q[names.index("ties")]
    half = np.abs(rows["ties"][1:]) - 0.5                  # k of k + 0.5
    np.testing.assert_array_equal(np.abs(ties[1:]),
                                  half + (half % 2 == 1))   # to even
    assert not q[names.index("zero")].any()
    assert sc[names.index("zero")] == row_scale(0.0)
    assert q[names.index("negative absmax")].min() == -127
    a, xv = division_pair()
    s = row_scale(a)
    assert sc[names.index("division")] == s
    assert q[names.index("division"), 1] == np.rint(xv / s)
    assert q[names.index("division"), 1] != np.rint(xv * (np.float32(1) / s))


@pytest.mark.parametrize("where", ["past the table", "entry outside the pool"])
def test_rows_plain_raises_out_of_table(where):
    """A position past the block table, or a table entry that names no
    pool page: the plain versions raise (the kernels skip such tokens,
    ``tests/test_torch_cuda.py``)."""
    _, tkv = empty_pools("int8")
    k = torch.ones((B, 1, KH, DH))
    bt = torch.ones((B, 2), dtype=torch.int32)
    pos = torch.zeros((B, 1), dtype=torch.int32)
    if where == "past the table":
        pos[1, 0] = 2 * PAGE
    else:
        bt[1, 0] = P + 3
    with pytest.raises((IndexError, RuntimeError)):
        ka.append_decode(tkv, k, k, 0, pos, bt)
