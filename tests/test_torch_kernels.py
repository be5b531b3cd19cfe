"""Paged attention of the PyTorch port (B1 ``paged_attention`` with and
without its per-page score export, B2 ``paged_attention_decode``, B9
``paged_attention_decode_append``) and the pool's ``copy_pages_tree``
against the JAX package's Pallas kernels and pool function.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
kernels run in interpret mode, as ``tests/test_paged_attention.py`` runs
them. Inputs come from one numpy seed and go through both. Tolerance:
f32 atol/rtol 1e-5 (the two sum the same terms in another order); B9's
output 2e-6 and its pool bit-exact (the JAX wrapper in interpret mode
runs the append's scatter and then B2, as the port's plain version does);
B1's scores within the JAX package's own 2e-5 with the ``-1e30`` pages
identical; ``copy_pages_tree`` bit-exact.

``tests/test_torch_cuda.py`` holds the hand-written CUDA kernels
against the plain versions on a card.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pagedattention_based_transformer_decoder_inference_framework_tpu.kvcache.pool import (
    copy_pages_tree as jax_copy_pages_tree,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu.ops.paged_attention import (
    paged_attention as jax_paged_attention,
    paged_attention_decode as jax_paged_attention_decode,
    paged_attention_decode_append as jax_paged_attention_decode_append,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.kvcache.pool import (
    copy_pages_tree,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.ops import (
    paged_attention as pa,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.utils import platform

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
# ragged first chunk (padding rows past a short prompt), a second chunk
# with a sliding window and a tanh softcap, and a speculative verify
# chunk (T = spec_k + 1 with spec_k=4) at offsets off the page grid,
# seq_lens = q_offsets + T
PREFILL_CASES = {
    "first_chunk_ragged": ([5, 3, 1], [0, 0, 0], 0, 0.0),
    "second_chunk_window_softcap": ([13, 40, 9], [8, 35, 4], 6, 20.0),
    "spec_verify": ([11, 18, 34], [6, 13, 29], 0, 0.0),
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


@pytest.mark.parametrize("KH,G,window,softcap", [
    (2, 1, 0, 0.0), (2, 3, 0, 0.0), (2, 3, 10, 20.0)])
@pytest.mark.parametrize("pool_dtype", ["int8", "float32"])
def test_paged_attention_decode_append_matches_jax(pool_dtype, KH, G,
                                                   window, softcap):
    """B9's plain version: the first token of a sequence (no cached
    keys), a new page's first slot, the table's last slot, and a frozen
    lane (position -1, not written)."""
    rng = np.random.default_rng(3)
    B = 4
    H = KH * G
    kv = make_pool(rng, KH, pool_dtype)
    bt = block_table(rng, B)
    q = rng.normal(size=(B, 1, H, DH)).astype(np.float32)
    k = rng.normal(size=(B, 1, KH, DH)).astype(np.float32)
    v = rng.normal(size=(B, 1, KH, DH)).astype(np.float32)
    sl = np.asarray([1, 17, MP * PAGE, 30], np.int32)   # after the append
    pos = np.asarray([[0], [16], [MP * PAGE - 1], [-1]], np.int32)
    common = dict(page_size=PAGE, num_q_heads=H, window=window,
                  softcap=softcap, scale=DH ** -0.5)
    jvals, jsc = to_jax(kv, pool_dtype)
    jkv = (jvals,) if jsc is None else (jvals, jsc)
    ref, ref_kv = jax_paged_attention_decode_append(
        jnp.asarray(q), jkv, jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(bt), jnp.asarray(sl), jnp.asarray(pos),
        jnp.int32(LAYER), interpret=True, **common)
    tvals, tsc = to_torch(kv, pool_dtype)
    tkv = (tvals,) if tsc is None else (tvals, tsc)
    before = tvals.clone()
    out, out_kv = pa.paged_attention_decode_append(
        torch.from_numpy(q), tkv, torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(bt), torch.from_numpy(sl), torch.from_numpy(pos),
        LAYER, **common)
    assert out_kv is tkv                       # the pool is updated in place
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6,
                               rtol=0)
    for o, r in zip(out_kv, ref_kv):
        # P * PAGE is a multiple of 128: the scales leaf has no padding
        # lanes, so every slot compares
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    assert not torch.equal(out_kv[0], before)             # it appended


def test_decode_append_gate():
    pool = torch.zeros((L, 2, 2, P, PAGE, DH), dtype=torch.int8)
    sc = torch.zeros((L, 2, 2, P * PAGE // 128, 128))
    assert pa.decode_append_supported((pool, sc), DH, MP)
    assert pa.decode_append_supported((pool.float(),), DH, MP)
    assert not pa.decode_append_supported((pool[..., :64],), 64, MP)
    assert not pa.decode_append_supported((pool.double(),), DH, MP)
    assert not pa.decode_append_supported(
        (pool, sc.reshape(L, 2, 2, P, PAGE, 1)), DH, MP)


def test_unported_variants_raise():
    """B2 keeps the JAX kernel's lane-aligned head dim and names the
    kernels of a sub-128 pool."""
    q = torch.zeros((1, 1, 2, 64))
    kv = torch.zeros((1, 2, 1, 4, PAGE, 64))
    bt = torch.ones((1, 2), dtype=torch.int32)
    sl = torch.ones((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="B6/B8"):
        pa.paged_attention_decode(q, kv, bt, sl, None, 0, page_size=PAGE,
                                  num_q_heads=2)


# (page, T, seq_lens, q_offsets, window, softcap) for B=3; the block
# table's last entries are dead past the shortest sequences; T=3 sits off
# the page grid
SCORE_CASES = {
    "decode_p16": (16, 1, [1, 33, 80], [0, 32, 79], 0, 0.0),
    "verify_p16_window_softcap": (16, 3, [20, 51, 90], [17, 48, 87], 24,
                                  30.0),
    "decode_p64": (64, 1, [5, 64, 129], [4, 63, 128], 0, 0.0),
    "verify_p64_softcap": (64, 3, [9, 70, 190], [6, 67, 187], 0, 20.0),
}


@pytest.mark.parametrize("case", sorted(SCORE_CASES))
@pytest.mark.parametrize("pool_dtype", ["int8", "float32"])
def test_paged_attention_scores_match_jax(pool_dtype, case):
    """B1's per-page score export (``return_scores``): the largest masked,
    scaled logit of each page over every head and query row, ``-1e30``
    for a page no row sees; within the JAX package's own 2e-5
    (``tests/test_paged_attention.py``), the dead pages identical, and the
    output unchanged by the export."""
    page, T, seq_lens, q_offsets, window, softcap = SCORE_CASES[case]
    rng = np.random.default_rng(11)
    B, KH, G, mp, P_ = 3, 2, 4, 4, 16
    H = KH * G
    shape = (L, 2, KH, P_, page, DH)
    if pool_dtype == "int8":
        kv = (rng.integers(-127, 128, size=shape).astype(np.int8),
              (rng.random((L, 2, KH, P_ * page // 128, 128)) * 0.02
               + 0.005).astype(np.float32))
    else:
        kv = (rng.normal(size=shape).astype(np.float32),)
    bt = (rng.permutation(P_ - 1)[:B * mp] + 1).reshape(B, mp).astype(
        np.int32)
    bt[0, 1:] = 0                                   # dead entries
    q = rng.normal(size=(B, T, H, DH)).astype(np.float32)
    sl = np.asarray(seq_lens, np.int32)
    qo = np.asarray(q_offsets, np.int32)
    kw = dict(page_size=page, num_q_heads=H, window=window, softcap=softcap,
              scale=DH ** -0.5)
    jvals, jsc = to_jax(kv, pool_dtype)
    ref_out, ref_sc = jax_paged_attention(
        jnp.asarray(q), jvals, jnp.asarray(bt), jnp.asarray(sl),
        jnp.asarray(qo), jsc, jnp.int32(LAYER), return_scores=True,
        interpret=True, **kw)
    ref_sc = np.asarray(ref_sc)
    args = (torch.from_numpy(q), *to_torch(kv, pool_dtype)[:1],
            torch.from_numpy(bt), torch.from_numpy(sl), torch.from_numpy(qo),
            to_torch(kv, pool_dtype)[1], LAYER)
    out, sc = pa.paged_attention(*args, return_scores=True, **kw)
    dead = ref_sc <= -1e29
    assert dead.any() and (~dead).any()
    np.testing.assert_array_equal(sc.numpy() <= -1e29, dead)
    assert (sc.numpy()[dead] == np.float32(-1e30)).all()
    np.testing.assert_allclose(sc.numpy()[~dead], ref_sc[~dead], atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=1e-5,
                               rtol=1e-5)
    assert torch.equal(out, pa.paged_attention(*args, **kw))


@pytest.mark.parametrize("page", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("pool_dtype", ["int8", "float32"])
def test_copy_pages_tree_matches_jax(pool_dtype, page):
    """The beam search's copy-on-write copies, bit for bit with the JAX
    package's on values and flat scales; dump-page self-copies change
    nothing, and a page's neighbour in a shared 128-lane scales row keeps
    its lanes."""
    rng = np.random.default_rng(page)
    P_, KH, D = 8, 2, 16
    shape = (L, 2, KH, P_, page, D)
    if pool_dtype == "int8":
        kv = (rng.integers(-127, 128, size=shape).astype(np.int8),
              rng.random((L, 2, KH, -(-P_ * page // 128), 128)).astype(
                  np.float32))
    else:
        kv = (rng.normal(size=shape).astype(np.float32),)
    src = np.asarray([3, 5, 0, 0], np.int32)
    dst = np.asarray([6, 2, 0, 0], np.int32)
    ref = jax_copy_pages_tree(tuple(jnp.asarray(a) for a in kv),
                              jnp.asarray(src), jnp.asarray(dst))
    got = copy_pages_tree(tuple(torch.from_numpy(a.copy()) for a in kv),
                          torch.from_numpy(src), torch.from_numpy(dst))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    vals = got[0].numpy()
    np.testing.assert_array_equal(vals[:, :, :, 6], kv[0][:, :, :, 3])
    np.testing.assert_array_equal(vals[:, :, :, 2], kv[0][:, :, :, 5])
    keep = [p for p in range(P_) if p not in (2, 6)]
    np.testing.assert_array_equal(vals[:, :, :, keep], kv[0][:, :, :, keep])
    if pool_dtype == "int8":
        flat, old = got[1].reshape(L, 2, KH, -1).numpy(), kv[1].reshape(
            L, 2, KH, -1)
        for s_, d_ in ((3, 6), (5, 2)):
            np.testing.assert_array_equal(
                flat[..., d_ * page:(d_ + 1) * page],
                old[..., s_ * page:(s_ + 1) * page])
        moved = np.zeros(flat.shape[-1], bool)
        moved[2 * page:3 * page] = moved[6 * page:7 * page] = True
        np.testing.assert_array_equal(flat[..., ~moved], old[..., ~moved])


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


# (q dtype, pool dtype, head dim, page) -> B1's kernel
B1_ROUTES = [
    ((torch.bfloat16, torch.int8, 128, 64), "wgmma"),
    ((torch.bfloat16, torch.int8, 96, 64), "wgmma"),
    ((torch.bfloat16, torch.bfloat16, 64, 16), "wgmma"),
    ((torch.bfloat16, torch.int8, 256, 128), "wgmma"),
    ((torch.bfloat16, torch.int8, 128, 8), "wgmma"),
    ((torch.bfloat16, torch.int8, 24, 64), "simt"),
    ((torch.bfloat16, torch.int8, 272, 64), "simt"),
    ((torch.bfloat16, torch.int8, 128, 48), "simt"),
    ((torch.bfloat16, torch.int8, 128, 2), "simt"),
    ((torch.bfloat16, torch.float32, 128, 64), "simt"),
    ((torch.float32, torch.int8, 128, 64), "simt"),
    ((torch.bfloat16, torch.bfloat16, 256, 64), "wgmma"),
]


@pytest.mark.parametrize("args,want", B1_ROUTES)
def test_prefill_route(args, want):
    """B1's tensor-core kernel takes bf16 queries over an INT8 or bf16
    pool at a head dim that is a multiple of 16 up to 256, with pages of
    a multiple of 64 keys or a divisor of 64 that is a multiple of 4;
    everything else (f32 queries, dh 24) the SIMT kernel, whose launches
    count apart. Dtypes and shapes alone decide it."""
    assert pa.prefill_route(*args) == want
    assert pa.ATTENTION_WGMMA is not pa.ATTENTION
    assert pa.ATTENTION_WGMMA.replaces == pa.ATTENTION.replaces


@pytest.mark.parametrize("offset", [0, 2, 8])
def test_aligned16_copies_only_misaligned_views(offset):
    """The tensor-core wrappers' alignment: a tensor whose data starts on
    a 16-byte boundary is passed as it is, a view at another offset as an
    aligned copy of the same values."""
    flat = torch.arange(64, dtype=torch.uint8)
    base = flat.view(torch.bfloat16)
    assert base.data_ptr() % 16 == 0
    t = base[offset // 2:offset // 2 + 16].view(4, 4)
    got = platform.aligned16(t)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, t)
    assert (got.data_ptr() == t.data_ptr()) == (offset % 16 == 0)
    assert platform.aligned16(None) is None
