"""On the card: each hand-written CUDA kernel of the PyTorch port against
its plain PyTorch version (B1/B2 paged attention, B6/B7/B8 decode
attention, B9 fused decode append, B3/B4/B5 KV appends, B10/B11/B12
quantized-weight products, B13 the MoE grouped matmul, B14/B15 the
chained decode megakernel and the product over its packed blocks).

These tests import no JAX, so they run where the card is (the suite's
``conftest.py`` sets JAX up, hence ``--noconftest``):

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

Without a CUDA card every test skips (the kernels have no CPU mode).
Tolerances: f32 queries 1e-4 absolute (the kernel and the plain version
sum the same terms in another order), bf16 queries 2e-2 (one bf16 step
of outputs of magnitude ~1); appends are bit-exact, B9's pool too. B10
is bit-exact (exact s32 sums, the same epilogue), on the matrix-vector
kernel (M <= 16) and on the INT8 tensor-core kernel (M > 16; every split
count the planner chooses, ragged K and N the wrapper zero-pads);
B11/B12 sum f32 in another order (B11's decode gemv on mma.sync, and
past 16 rows with bf16 x on wgmma, in the tensor cores' accumulation
order; f32 x as three exact bf16 planes): f32 outputs within 1e-5 of
max|output|, bf16 outputs within one bf16 step or that (where
cancellation leaves an output tiny); the gemv's K splits merge in split
order, so the same bits from run to run. B2 (split-KV) sums its splits'
partials in a fixed order: the same bits from run to run. B14 against its
plain version, relative to max|output|: 1e-4 with f32 activations (f32
sums in another order, through two norms); 2e-2 with bf16 activations
(h and the activation are rounded to bf16 between the ops, so a sum in
another order can move one value by a bf16 step) and under w8a8 (an
f32 norm sum in another order can move one re-quantized activation by
an INT8 step); the same bits from run to run. B15 as B10 under w8a8 (bit-exact) and as B11 otherwise.
B13 as B11 (f32 sums in another order: bf16 outputs within one bf16
step or 1e-5 of max|output|, f32 outputs 1e-5 of max|output|); B12 past
16 rows with bf16 x on the tensor cores as B11 (its group sums folded
with the scales: the order of the sums and the place of the scale
differ). B6, B7 and B8 run B2's split-KV body: the same tolerances, and
the same bits from run to run.
"""

import numpy as np
import pytest
import torch

from pagedattention_based_transformer_decoder_inference_framework_tpu_torch import config as tconfig
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.engine import (
    Engine,
    SamplingParams,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.kvcache import pool as tpool
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.ops import (
    chain_linear as cl,
    gmm,
    int4_matmul as i4,
    int8_matmul as i8,
    kv_append as ka,
    paged_attention as pa,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.quant import tensor as qt

PAGE, P, MP, L, LAYER, DH = 8, 32, 6, 2, 1, 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def make_pool(rng, KH, pool_dtype, device):
    """Random pool ``[L, 2, KH, P, PAGE, DH]`` (+ flat INT8 scales)."""
    shape = (L, 2, KH, P, PAGE, DH)
    if pool_dtype == "int8":
        vals = torch.from_numpy(rng.integers(-127, 128, size=shape).astype(
            np.int8))
        scales = torch.from_numpy((rng.random(
            (L, 2, KH, P * PAGE // 128, 128)) * 0.02 + 0.005).astype(
                np.float32))
        return vals.to(device), scales.to(device)
    vals = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return vals.to(device, torch.bfloat16), None


def block_table(rng, B, device):
    """Distinct non-dump pages, ``[B, MP]`` int32."""
    return torch.from_numpy((rng.permutation(P - 1)[:B * MP] + 1).reshape(
        B, MP).astype(np.int32)).to(device)


# (seq_lens, q_offsets, window, softcap) for a T=5 chunk and B=3:
# a ragged first chunk, and a second chunk with a window and a softcap
PREFILL_CASES = [([5, 3, 1], [0, 0, 0], 0, 0.0),
                 ([13, 40, 9], [8, 35, 4], 6, 20.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pool_dtype", ["int8", "bfloat16"])
def test_cuda_attention_kernels_match_plain(cuda, pool_dtype, q_dtype):
    rng = np.random.default_rng(2)
    B, T, KH, G = 3, 5, 2, 4
    H = KH * G
    vals, sc = make_pool(rng, KH, pool_dtype, cuda)
    bt = block_table(rng, B, cuda)
    tol = 1e-4 if q_dtype == torch.float32 else 2e-2
    for seq_lens, q_offsets, window, softcap in PREFILL_CASES:
        q = torch.from_numpy(rng.normal(size=(B, T, H, DH)).astype(
            np.float32)).to(cuda, q_dtype)
        args = (q, vals, bt, torch.tensor(seq_lens, device=cuda),
                torch.tensor(q_offsets, device=cuda), sc, LAYER)
        kw = dict(page_size=PAGE, num_q_heads=H, window=window,
                  softcap=softcap)
        out = pa.paged_attention(*args, **kw)
        ref = pa.paged_attention_plain(*args, **kw)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=0)
        q1 = q[:, :1].contiguous()
        sl = torch.tensor([1, 17, MP * PAGE], device=cuda)
        out = pa.paged_attention_decode(q1, vals, bt, sl, sc, LAYER, **kw)
        ref = pa.paged_attention_decode_plain(q1, vals, bt, sl, sc, LAYER,
                                              **kw)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=0)


# (T, prompt lens, chunk start): a decode row whose middle lane is
# invalid, a ragged page-aligned first chunk, and a second chunk
APPEND_CASES = {
    "decode": (1, None, None),
    "prefill_first_chunk": (2 * PAGE, [16, 9, 1], 0),
    "prefill_second_chunk": (2 * PAGE, [30, 17, 20], 2 * PAGE),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["int8", "float32"])
@pytest.mark.parametrize("case", sorted(APPEND_CASES))
def test_cuda_append_kernels_match_plain(cuda, kv_dtype, case):
    T, lens, c0 = APPEND_CASES[case]
    B, KH = 3, 2
    rng = np.random.default_rng(6)
    bt = block_table(rng, B, cuda)
    k = torch.randn((B, T, KH, DH), device=cuda)
    v = torch.randn((B, T, KH, DH), device=cuda)
    if T == 1:
        pos = torch.tensor([[12], [-1], [33]])
    else:
        ar = c0 + torch.arange(T)[None]
        pos = torch.where(ar < torch.tensor(lens)[:, None], ar, -1)
    pos = pos.to(cuda, torch.int32)
    shape = (L, 2, KH, P, PAGE, DH)
    if kv_dtype == "int8":
        kv_k = (torch.zeros(shape, dtype=torch.int8, device=cuda),
                torch.zeros((L, 2, KH, P * PAGE // 128, 128), device=cuda))
    else:
        kv_k = (torch.zeros(shape, device=cuda),)
    kv_p = tuple(x.clone() for x in kv_k)
    news = tpool.stack_new_kv(kv_k, k, v)
    kern = ka.append_decode if T == 1 else ka.append_prefill
    plain = ka.append_decode_plain if T == 1 else ka.append_prefill_plain
    kern(kv_k, news, LAYER, pos, bt)
    plain(kv_p, news, LAYER, pos, bt)
    for a, b in zip(kv_k, kv_p):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["int8", "float32", "bfloat16"])
def test_cuda_append_tokens_matches_plain(cuda, kv_dtype):
    """B5 through ``kv_append``'s dispatch: verify chunks (T = spec_k + 1)
    that start off the page grid and cross a page, with a frozen lane."""
    B, KH = 4, 2
    rng = np.random.default_rng(8)
    bt = block_table(rng, B, cuda)
    shape = (L, 2, KH, P, PAGE, DH)
    if kv_dtype == "int8":
        kv_k = (torch.zeros(shape, dtype=torch.int8, device=cuda),
                torch.zeros((L, 2, KH, P * PAGE // 128, 128), device=cuda))
    else:
        kv_k = (torch.zeros(shape, dtype=getattr(torch, kv_dtype),
                            device=cuda),)
    for T, starts in ((5, [6, -1, 21, 43]), (9, [0, 7, 30, 39])):
        k = torch.randn((B, T, KH, DH), device=cuda)
        v = torch.randn((B, T, KH, DH), device=cuda)
        st = torch.tensor(starts, device=cuda)[:, None]
        pos = torch.where(st >= 0, st + torch.arange(T, device=cuda), -1)
        pos = pos.to(torch.int32)
        kv_p = tuple(x.clone() for x in kv_k)
        ka.APPEND_TOKENS.launches = 0
        ka.kv_append(kv_k, k, v, LAYER, pos, bt, page_size=PAGE)
        assert ka.APPEND_TOKENS.launches == 1
        ka.append_tokens_plain(kv_p, tpool.stack_new_kv(kv_p, k, v), LAYER,
                               pos, bt)
        for a, b in zip(kv_k, kv_p):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("G,window,softcap", [(1, 0, 0.0), (4, 0, 0.0),
                                              (4, 10, 20.0)])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pool_dtype", ["int8", "bfloat16"])
def test_cuda_decode_append_matches_plain(cuda, pool_dtype, q_dtype, G,
                                          window, softcap):
    """B9: the output within B2's tolerance, the pool bit-exact; the
    first token of a sequence, a new page's first slot, the table's last
    slot, a lane mid-page, and a frozen lane (``pos = -1``: nothing
    written, its output undefined and not compared)."""
    rng = np.random.default_rng(9)
    B, KH = 5, 2
    H = KH * G
    vals, sc = make_pool(rng, KH, pool_dtype, cuda)
    bt = block_table(rng, B, cuda)
    kv_k = (vals,) if sc is None else (vals, sc)
    kv_p = tuple(x.clone() for x in kv_k)
    q = torch.randn((B, 1, H, DH), device=cuda).to(q_dtype)
    k = torch.randn((B, 1, KH, DH), device=cuda).to(q_dtype)
    v = torch.randn((B, 1, KH, DH), device=cuda).to(q_dtype)
    sl = torch.tensor([1, 17, MP * PAGE, 30, 40], device=cuda)
    pos = (sl - 1).to(torch.int32)[:, None]
    pos[4] = -1
    kw = dict(page_size=PAGE, num_q_heads=H, window=window, softcap=softcap)
    out, _ = pa.paged_attention_decode_append(q, kv_k, k, v, bt, sl, pos,
                                              LAYER, **kw)
    ref, _ = pa.paged_attention_decode_append_plain(q, kv_p, k, v, bt, sl,
                                                    pos, LAYER, **kw)
    tol = 1e-4 if q_dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out[:4].float(), ref[:4].float(), atol=tol,
                               rtol=0)
    for a, b in zip(kv_k, kv_p):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 5, 2 * PAGE])
def test_cuda_append_kernels_skip_out_of_table(cuda, T):
    """A position past the block table, or a table entry outside the
    pool, is not written; every other token is, as the plain version
    writes it (the plain version itself raises on such positions)."""
    B, KH = 3, 2
    rng = np.random.default_rng(7)
    bt = block_table(rng, B, cuda)
    bt[2, 0] = P + 5                                 # names no pool page
    k = torch.randn((B, T, KH, DH), device=cuda)
    v = torch.randn((B, T, KH, DH), device=cuda)
    # row 0 runs past the table (a chunk from inside its last page, a
    # decode row just past it); row 1 stays inside it; row 2 writes into
    # the bad entry's page
    starts = torch.tensor([[MP * PAGE - (3 if T > 1 else 0)], [PAGE], [0]])
    pos = (starts + torch.arange(T)[None]).to(cuda, torch.int32)
    in_table = (pos < MP * PAGE) & (bt.gather(
        1, (pos // PAGE).clamp_max(MP - 1).long()) < P)
    kv_k = (torch.zeros((L, 2, KH, P, PAGE, DH), dtype=torch.int8,
                        device=cuda),
            torch.zeros((L, 2, KH, P * PAGE // 128, 128), device=cuda))
    kv_p = tuple(x.clone() for x in kv_k)
    news = tpool.stack_new_kv(kv_k, k, v)
    kern = {1: ka.append_decode, 5: ka.append_tokens,
            2 * PAGE: ka.append_prefill}[T]
    kern(kv_k, news, LAYER, pos, bt)
    if T == 1:          # B9 skips the same positions when it appends
        kv_f = tuple(x.clone() for x in kv_p)
        q = torch.randn((B, 1, 2 * KH, DH), device=cuda)
        pa.paged_attention_decode_append(
            q, kv_f, k, v, bt, (pos[:, 0] + 1).clamp_max(MP * PAGE), pos,
            LAYER, page_size=PAGE, num_q_heads=2 * KH)
    ka.append_plain(kv_p, news, LAYER,
                    torch.where(in_table, pos, -1).to(torch.int32),
                    torch.where(bt < P, bt, 0))
    for a, b in zip(kv_k, kv_p):
        assert torch.equal(a, b)
    if T == 1:
        for a, b in zip(kv_f, kv_p):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["int8", "bfloat16"])
def test_cuda_spec_accepted_drafts_equal_fused(cuda, kv_dtype):
    """``generate_batch_spec`` (B1 + B5 verify chunks) against
    ``generate_batch_fused`` (B2 + B3) on the card, on a model that
    repeats its input token (attention and MLP outputs damped to a tenth,
    the LM head the embedding's transpose), so drafts are accepted and
    the verify chunk advances by several tokens: 4 verify forwards for
    11 tokens, as ``tests/test_torch_spec.py`` counts them."""
    cfg = tconfig.FrameworkConfig(
        model=tconfig.preset("llama-tiny"),
        cache=tconfig.CacheConfig(page_size=PAGE, num_pages=64,
                                  max_pages_per_seq=8, kv_dtype=kv_dtype),
        runtime=tconfig.RuntimeConfig(max_new_tokens=12))
    cfg.model.dtype = "float32"
    eng = Engine(cfg, device=cuda, seed=0)
    for lp in eng.params["layers"]:
        lp["wo"].mul_(0.1)
        lp["w_down"].mul_(0.1)
    eng.params["lm_head"] = eng.params["embedding"].t().contiguous()
    prompts = [[5, 9, 3, 14, 5, 9, 3, 14, 5, 9], [1, 2, 3, 4, 5, 6, 7],
               list(range(20, 44)), [11]]
    greedy = SamplingParams(temperature=0.0, eos_token_id=-1)
    forwards = []
    forward = eng.model.forward
    eng.model.forward = lambda *a: forwards.append(1) or forward(*a)
    out = eng.generate_batch_spec(prompts, 12, greedy, spec_k=4, ngram=2)
    assert len(forwards) == 1 + 4
    assert out == [[p[-1]] * 12 for p in prompts]
    assert out == eng.generate_batch_fused(prompts, 12, greedy)


# the decode kernels past B2, each with the head dims it covers: B6 any
# even dh (its compiled lane layouts 64, 96, 128, 256; 18, INT8 rows of
# 2-byte pairs, on the generic instance), B8 dh 16/32/64, B7 dh 128
DECODE_VARIANTS = {
    "grouped": (pa.paged_attention_decode_grouped, (18, 64, 96, 128, 256)),
    "packed": (pa.paged_attention_decode_packed, (16, 32, 64)),
    "batched": (pa.paged_attention_decode_batched, (128,)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("G,window,softcap", [(1, 0, 0.0), (4, 0, 0.0),
                                              (4, 10, 20.0), (8, 0, 0.0)])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pool_dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(DECODE_VARIANTS))
def test_cuda_decode_variants_match_plain(cuda, variant, pool_dtype, q_dtype,
                                          G, window, softcap):
    """B6, B7 and B8 against their plain versions over a 40-page table: a
    frozen lane (seq_len 0, no visible key: zeros), a window whose first
    key lies inside a page, a lane mid-page, the table's last slot and a
    long lane; B6 at several group widths. One launch per call; the parts
    merged in a fixed order, so the same bits from run to run."""
    wrapper, dhs = DECODE_VARIANTS[variant]
    plain = getattr(pa, wrapper.__name__ + "_plain")
    kernel = {"grouped": pa.ATTENTION_DECODE_GROUPED,
              "packed": pa.ATTENTION_DECODE_PACKED,
              "batched": pa.ATTENTION_DECODE_BATCHED}[variant]
    rng = np.random.default_rng(11)
    B, KH, Pn, mp = 5, 2, 208, 40
    H = KH * G
    bt = torch.from_numpy((rng.permutation(Pn - 1)[:B * mp] + 1).reshape(
        B, mp).astype(np.int32)).to(cuda)
    sl = torch.tensor([0, 30, 17, mp * PAGE, 250], device=cuda)
    tol = 1e-4 if q_dtype == torch.float32 else 2e-2
    for dh in dhs:
        shape = (L, 2, KH, Pn, PAGE, dh)
        if pool_dtype == "int8":
            vals = torch.from_numpy(rng.integers(-127, 128, size=shape).astype(
                np.int8)).to(cuda)
            sc = torch.from_numpy((rng.random((L, 2, KH, Pn * PAGE // 128,
                                               128)) * 0.02 + 0.005).astype(
                np.float32)).to(cuda)
        else:
            vals = torch.from_numpy(rng.normal(size=shape).astype(
                np.float32)).to(cuda, torch.bfloat16)
            sc = None
        q = torch.from_numpy(rng.normal(size=(B, 1, H, dh)).astype(
            np.float32)).to(cuda, q_dtype)
        kw = dict(page_size=PAGE, num_q_heads=H, window=window,
                  softcap=softcap)
        ref = plain(q, vals, bt, sl, sc, LAYER, **kw)
        for extra in ([{"group_pages": J} for J in (1, 4, 7)]
                      if variant == "grouped" else [{}]):
            kernel.launches = 0
            out = wrapper(q, vals, bt, sl, sc, LAYER, **kw, **extra)
            assert kernel.launches == 1
            torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                       rtol=0)
            assert not out[0].any()                  # the frozen lane
            assert torch.equal(out, wrapper(q, vals, bt, sl, sc, LAYER,
                                            **kw, **extra))


@pytest.mark.cuda
@pytest.mark.parametrize("pool_dtype,dh,page", [
    ("int8", 96, 8), ("bfloat16", 64, 8), ("int8", 18, 4), ("int8", 18, 1),
    ("bfloat16", 26, 2)])
def test_cuda_decode_grouped_every_cut(cuda, pool_dtype, dh, page):
    """B6 at cuts other than its plan's (``decode_grouped_launch``, as
    chip_smoke.py's sweep calls it): pages a split, ring depths and rows;
    pages that are not a multiple of 16 bytes (dh 18 INT8 at pages of 4
    and 1, dh 26 bf16 at pages of 2) take the copy warp's plain copies.
    Each against the plain version at 1e-4 (f32 queries)."""
    rng = np.random.default_rng(15)
    B, KH, G, mp = 4, 2, 4, 24
    Pn = B * mp + 1
    vals, sc = decode_pool(rng, KH, dh, page, Pn, pool_dtype, cuda)
    bt = torch.from_numpy((rng.permutation(Pn - 1) + 1).reshape(
        B, mp).astype(np.int32)).to(cuda)
    sl = torch.tensor([0, 1, page * mp, page * 7 + 1], device=cuda)
    q = torch.randn((B, 1, KH * G, dh), device=cuda)
    kw = dict(page_size=page, num_q_heads=KH * G, window=page * 5 + 1)
    ref = pa.paged_attention_decode_plain(q, vals, bt, sl, sc, LAYER, **kw)
    for cut in (dict(splits=6, pages_per_split=1), dict(splits=1,
                                                         pages_per_split=6),
                dict(splits=2, pages_per_split=3, stages=1),
                dict(splits=3, pages_per_split=2, stages=4),
                dict(splits=2, pages_per_split=4, rows=8),
                dict(splits=2, pages_per_split=4, rows=4)):
        out = pa.decode_grouped_launch(q, vals, bt, sl, sc, LAYER, **kw,
                                       **cut)
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    with pytest.raises(RuntimeError, match="cudaError"):
        pa.decode_grouped_launch(q, vals, bt, sl, sc, LAYER, **kw,
                                 splits=2, pages_per_split=2)  # too few


@pytest.mark.cuda
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (100, 30.0)])
@pytest.mark.parametrize("pool_dtype", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("page", [16, 64])
@pytest.mark.parametrize("dh", [16, 32, 64])
def test_cuda_decode_packed_pages(cuda, dh, page, pool_dtype, window,
                                  softcap):
    """B8 at pages of 16 and 64 keys, dh 16 / 32 / 64, G 8, over ragged
    lengths (a frozen lane, one key, mid-page, a long lane): against its
    plain version (f32 queries 1e-4, bf16 2e-2), against
    ``decode_packed_emulation`` at 1e-4 (f32 queries), the same bits from
    run to run, one launch; and at other cuts (``decode_packed_launch``:
    one split a sequence, splits of 2 pages, a ring of 1 and 2 stages)."""
    rng = np.random.default_rng(17)
    B, KH, G, mp = 5, 2, 8, 12
    Pn = B * mp + 1
    vals, sc = decode_pool(rng, KH, dh, page, Pn, pool_dtype, cuda)
    bt = torch.from_numpy((rng.permutation(Pn - 1) + 1).reshape(
        B, mp).astype(np.int32)).to(cuda)
    sl = torch.tensor([0, 1, page * 3 + 5, page * mp, page + 1], device=cuda)
    kw = dict(page_size=page, num_q_heads=KH * G, window=window,
              softcap=softcap)
    for q_dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        q = torch.randn((B, 1, KH * G, dh), device=cuda).to(q_dtype)
        ref = pa.paged_attention_decode_plain(q, vals, bt, sl, sc, LAYER,
                                              **kw)
        pa.ATTENTION_DECODE_PACKED.launches = 0
        out = pa.paged_attention_decode_packed(q, vals, bt, sl, sc, LAYER,
                                               **kw)
        assert pa.ATTENTION_DECODE_PACKED.launches == 1
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=0)
        assert not out[0].any()
        assert torch.equal(out, pa.paged_attention_decode_packed(
            q, vals, bt, sl, sc, LAYER, **kw))
        if q_dtype == torch.float32:
            emu = pa.decode_packed_emulation(q, vals, bt, sl, sc, LAYER, **kw)
            torch.testing.assert_close(out, emu, atol=1e-4, rtol=0)
            splits, pps = pa.decode_packed_plan(B, KH, mp, page, window)
            for cut in (dict(splits=1, pages_per_split=splits * pps),
                        dict(splits=-(-splits * pps // 2),
                             pages_per_split=2),
                        dict(splits=splits, pages_per_split=pps, stages=1),
                        dict(splits=splits, pages_per_split=pps, stages=2)):
                got = pa.decode_packed_launch(q, vals, bt, sl, sc, LAYER,
                                              **kw, **cut)
                torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_cuda_decode_packed_misread_page_leaves_the_tolerance(cuda):
    """The control: one page of a sequence's table read in place of its
    neighbour moves B8's plain output past the 1e-4 the kernel is held to
    with f32 queries (path (g)'s shape: dh 64, G 8, page 64)."""
    rng = np.random.default_rng(18)
    B, KH, G, dh, page, mp = 8, 4, 8, 64, 64, 5
    Pn = B * mp + 1
    vals, sc = decode_pool(rng, KH, dh, page, Pn, "int8", cuda)
    bt = torch.from_numpy((rng.permutation(Pn - 1) + 1).reshape(
        B, mp).astype(np.int32)).to(cuda)
    sl = torch.tensor([65, 72, 80, 96, 100, 112, 120, 128], device=cuda)
    q = torch.randn((B, 1, KH * G, dh), device=cuda)
    kw = dict(page_size=page, num_q_heads=KH * G)
    ref = pa.paged_attention_decode_plain(q, vals, bt, sl, sc, LAYER, **kw)
    out = pa.paged_attention_decode_packed(q, vals, bt, sl, sc, LAYER, **kw)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    wrong = bt.clone()
    wrong[0, 0] = bt[0, 1]
    off = pa.paged_attention_decode_plain(q, vals, wrong, sl, sc, LAYER,
                                          **kw)
    assert (off - ref).abs().max() > 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_batched_ragged_512_pages(cuda, q_dtype):
    """B7 over B2's four ragged sequences of 1 to 512 pages (64-key pages,
    8 KV heads, INT8): split by the real lengths, one launch, the same bits
    from run to run, and the parts merged in the order of
    ``decode_batched_emulation`` (1e-4 against it with f32 queries)."""
    KH, G, dh, page, mp = 8, 4, 128, 64, 512
    lens = [1, 64 * 7 + 3, 64 * 200, 64 * 512]
    rng = np.random.default_rng(16)
    B = len(lens)
    Pn = B * mp + 1
    vals, sc = decode_pool(rng, KH, dh, page, Pn, "int8", cuda)
    bt = torch.from_numpy((rng.permutation(Pn - 1) + 1).reshape(
        B, mp).astype(np.int32)).to(cuda)
    sl = torch.tensor(lens, dtype=torch.int32, device=cuda)
    q = torch.randn((B, 1, KH * G, dh), device=cuda).to(q_dtype)
    kw = dict(page_size=page, num_q_heads=KH * G)
    tol = 1e-4 if q_dtype == torch.float32 else 2e-2
    pa.ATTENTION_DECODE_BATCHED.launches = 0
    out = pa.paged_attention_decode_batched(q, vals, bt, sl, sc, LAYER, **kw)
    assert pa.ATTENTION_DECODE_BATCHED.launches == 1
    ref = pa.paged_attention_decode_plain(q, vals, bt, sl, sc, LAYER, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    emu = pa.decode_batched_emulation(q, vals, bt, sl, sc, LAYER, **kw)
    torch.testing.assert_close(out.float(), emu.float(), atol=tol, rtol=0)
    assert torch.equal(out, pa.paged_attention_decode_batched(
        q, vals, bt, sl, sc, LAYER, **kw))


@pytest.mark.cuda
def test_cuda_decode_route_in_the_engine(cuda):
    """A ``pad_head_dim=False`` engine on the card: dh 16 at page 8
    decodes through B8, a dh-24 variant through B6, every decode layer
    one launch."""
    greedy = SamplingParams(temperature=0.0, eos_token_id=-1)
    prompts = [[5, 9, 3, 14, 2], list(range(20, 39))]
    for dh, kernel in ((16, pa.ATTENTION_DECODE_PACKED),
                       (24, pa.ATTENTION_DECODE_GROUPED)):
        cfg = tconfig.FrameworkConfig(
            model=tconfig.preset("llama-tiny"),
            cache=tconfig.CacheConfig(page_size=PAGE, num_pages=64,
                                      max_pages_per_seq=8, kv_dtype="int8",
                                      pad_head_dim=False),
            runtime=tconfig.RuntimeConfig(max_new_tokens=8))
        cfg.model.dtype, cfg.model.head_dim = "float32", dh
        eng = Engine(cfg, device=cuda, seed=0)
        kernel.launches = 0
        out = eng.generate_batch_fused(prompts, 8, greedy)
        assert kernel.launches == cfg.model.num_layers * 7
        assert [len(r) for r in out] == [8, 8]


# (M, K, N): decode rows with K split across blocks, one row, rows past
# the matrix-vector kernel, and K / N that fit no tile
MATMUL_SHAPES = [(4, 512, 384), (1, 1024, 256), (17, 300, 200), (5, 70, 36)]


def matmul_inputs(M, K, N, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((M, K), generator=g)
    w = torch.randn((K, N), generator=g) * 0.05
    b = torch.randn((N,), generator=g)
    return x.to(device), w.to(device), b.to(device)


def within(out, ref, out_dtype):
    d = (out.float() - ref.float()).abs()
    r = ref.float().abs()
    if out_dtype == torch.bfloat16:
        step = torch.exp2(torch.floor(torch.log2(r.clamp_min(2.0 ** -126)))
                          - 7)
        tol = torch.maximum(step, 1e-5 * r.max())
    else:
        tol = 1e-5 * r.max()
    return bool((d <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", [None, "relu", "gelu", "silu"])
@pytest.mark.parametrize("M,K,N", MATMUL_SHAPES)
def test_cuda_int8_matmul_bit_exact(cuda, M, K, N, act, out_dtype):
    x, w, b = matmul_inputs(M, K, N, cuda)
    xq, wq = qt.quantize_per_row(x), qt.quantize_per_channel(w)
    for bias in (None, b):
        args = (xq.values, xq.scales, wq.values, wq.scales, bias)
        out = i8.int8_matmul(*args, act=act, out_dtype=out_dtype)
        ref = i8.int8_matmul_plain(*args, act=act, out_dtype=out_dtype)
        assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", MATMUL_SHAPES)
def test_cuda_w8_matmul_matches_plain(cuda, M, K, N, x_dtype, out_dtype):
    x, w, b = matmul_inputs(M, K, N, cuda, seed=1)
    wq = qt.quantize_per_channel(w)
    x = x.to(x_dtype)
    for bias, act in ((None, None), (b, "gelu")):
        args = (x, wq.values, wq.scales, bias)
        out = i8.w8_matmul(*args, act=act, out_dtype=out_dtype)
        ref = i8.w8_matmul_plain(*args, act=act, out_dtype=out_dtype)
        assert within(out, ref, out_dtype)


# (M, K, N, group): the gemv at M 1, 4 and 16 (bn 768, the LM head's
# width; a K of one group; Llama-3-8B's K at bn 2048); a width whose block
# (100) no vector load fits (the tiles); past 16 rows the tensor-core
# kernel for bf16 x (the tiles for f32 x): bn 1024 with groups of 64, bn
# 768 and 2048 at Llama-3-8B's K of 4096 and 14336, ragged row tiles (17,
# 300)
W4_SHAPES = [(4, 384, 2304, 128), (1, 64, 512, 128), (16, 4096, 4096, 128),
             (3, 256, 100, 128), (17, 256, 1024, 64), (17, 4096, 2304, 128),
             (64, 14336, 4096, 128), (256, 4096, 2304, 128),
             (300, 4096, 4096, 128)]


def w4_route(M, x_dtype, bn, group, packed):
    """The route the wrapper must take (the plan's rule, written out)."""
    if M <= 16:
        return "gemv" if (bn // 2) % 16 == 0 else "tiles"
    return ("wgmma" if x_dtype == torch.bfloat16 and (bn // 2) % 128 == 0
            and group % 64 == 0 else "tiles")


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,group", W4_SHAPES)
def test_cuda_w4_matmul_matches_plain(cuda, M, K, N, group, x_dtype,
                                      out_dtype):
    """B12 on each of its routes (:func:`w4_route`), with a bias and each
    activation: one launch a call."""
    x, w, b = matmul_inputs(M, K, N, cuda, seed=2)
    q = qt.quantize_int4_groupwise(w, group=group)
    x = x.to(x_dtype)
    route = w4_route(M, x_dtype, q.bn, q.group, q.packed)
    assert i4.w4_plan(M, K, N, q.group, q.bn, x_dtype)[0] == route
    for bias, act in ((None, None), (b, "silu"), (b, "gelu"),
                      (None, "relu")):
        kw = dict(group=q.group, bn=q.bn, act=act, out_dtype=out_dtype)
        i4.W4_MATMUL.launches = 0
        out = i4.w4_matmul(x, q.packed, q.scales, bias, **kw)
        assert i4.W4_MATMUL.launches == 1
        ref = i4.w4_matmul_plain(x, q.packed, q.scales, bias, **kw)
        assert within(out, ref, out_dtype), (route, act)


@pytest.mark.cuda
def test_cuda_w4_wgmma_every_split_and_run_to_run(cuda):
    """B12's tensor-core route with K split: 16 splits of one group of
    128 rows each, and 10 splits of three 64-row k-tiles (groups cut at a
    split's end, folded there); the splits merge in a fixed order, so two
    runs give the same bits."""
    for M, K, N in ((17, 128 * 16, 256), (200, 64 * 30, 768)):
        q = qt.quantize_int4_groupwise(
            matmul_inputs(M, K, N, cuda, seed=3)[1], group=128)
        x = matmul_inputs(M, K, N, cuda, seed=3)[0].to(torch.bfloat16)
        route, splits, _ = i4.w4_plan(M, K, N, q.group, q.bn, torch.bfloat16)
        assert route == "wgmma" and splits > 1
        kw = dict(group=q.group, bn=q.bn, act="silu")
        out = i4.w4_matmul(x, q.packed, q.scales, **kw)
        assert torch.equal(out, i4.w4_matmul(x, q.packed, q.scales, **kw))
        assert within(out, i4.w4_matmul_plain(x, q.packed, q.scales, **kw),
                      torch.bfloat16)


@pytest.mark.cuda
def test_cuda_w4_swapped_carrier_run_leaves_the_tolerance(cuda):
    """The control: two 128-column carrier runs (the tensor-core kernel's
    raw tiles) read in each other's place move the plain output past the
    tolerance the kernel is held to."""
    x, w, _ = matmul_inputs(64, 1024, 2304, cuda, seed=4)
    q = qt.quantize_int4_groupwise(w)
    x = x.to(torch.bfloat16)
    p = q.packed
    swapped = torch.cat([p[:, 128:256], p[:, :128], p[:, 256:]], dim=1)
    ref = i4.w4_matmul_plain(x, p, q.scales, group=q.group, bn=q.bn)
    off = i4.w4_matmul_plain(x, swapped, q.scales, group=q.group, bn=q.bn)
    assert within(i4.w4_matmul(x, p, q.scales, group=q.group, bn=q.bn), ref,
                  torch.bfloat16)
    assert not within(off, ref, torch.bfloat16)


@pytest.mark.cuda
def test_cuda_matmul_launches_are_counted(cuda):
    from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.utils import platform

    x, w, _ = matmul_inputs(4, 256, 128, cuda)
    xq, wq = qt.quantize_per_row(x), qt.quantize_per_channel(w)
    platform.reset_launch_counts()
    i8.int8_matmul(xq.values, xq.scales, wq.values, wq.scales)
    i8.int8_matmul_plain(xq.values, xq.scales, wq.values, wq.scales)
    i8.w8_matmul(x, wq.values, wq.scales)
    assert i8.INT8_MATMUL.launches == 1 and i8.W8_MATMUL.launches == 1


@pytest.mark.cuda
def test_cuda_split_k_on_two_streams(cuda):
    """Split-K launches in flight on two streams at once keep separate
    tile counters, so each sums its own partials."""
    x, w, _ = matmul_inputs(4, 4096, 1024, cuda, seed=3)
    wq = qt.quantize_per_channel(w)
    assert i8.w8_gemv_plan(4, 4096, 1024, torch.bfloat16)[0] > 1  # split
    xs = [x, x.flip(0)]
    refs = [i8.w8_matmul_plain(a, wq.values, wq.scales) for a in xs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for s, a, o in zip(streams, xs, outs):
            with torch.cuda.stream(s):
                o.append(i8.w8_matmul(a, wq.values, wq.scales))
    torch.cuda.synchronize()
    for o, ref in zip(outs, refs):
        assert all(within(y, ref, torch.bfloat16) for y in o)


@pytest.mark.cuda
@pytest.mark.parametrize("M", range(1, 17))
def test_cuda_w8_gemv_every_row_count(cuda, M):
    """B11's decode gemv (mma.sync, the INT8 weights widened exactly) at
    every decode row count, bf16 and f32 x, bf16 and f32 out, with and
    without a bias and an activation, K split (512) and not, and a ragged
    K (1000, zero-padded to 16): one launch a call, the same bits from run
    to run."""
    for K, N in ((512, 1024), (1000, 256), (4096, 128)):
        x, w, b = matmul_inputs(M, K, N, cuda, seed=M)
        wq = qt.quantize_per_channel(w)
        for x_dtype in (torch.bfloat16, torch.float32):
            xd = x.to(x_dtype)
            assert i8.w8_plan(M, -(-K // 16) * 16, N, x_dtype)[0] == "gemv"
            for out_dtype in (torch.bfloat16, torch.float32):
                for bias, act in ((None, None), (b, "silu"), (b, "gelu")):
                    args = (xd, wq.values, wq.scales, bias)
                    kw = dict(act=act, out_dtype=out_dtype)
                    i8.W8_MATMUL.launches = 0
                    out = i8.w8_matmul(*args, **kw)
                    assert i8.W8_MATMUL.launches == 1
                    assert torch.equal(out, i8.w8_matmul(*args, **kw))
                    assert within(out, i8.w8_matmul_plain(*args, **kw),
                                  out_dtype), (K, N, x_dtype, act)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", range(1, 17))
def test_cuda_w8_gemv_every_split(cuda, splits):
    """B11's decode gemv over one column tile split into ``splits`` K
    ranges (one round of the 8 warps' k-steps each; the last block merges
    them in split order), M 4 and 12, bf16 and f32 x: the same bits from
    run to run, within the tolerance of the plain version."""
    K = 128 * splits
    for M in (4, 12):
        x, w, b = matmul_inputs(M, K, 128, cuda, seed=splits)
        wq = qt.quantize_per_channel(w)
        for x_dtype in (torch.bfloat16, torch.float32):
            xd = x.to(x_dtype)
            plan = i8.w8_gemv_plan(M, K, 128, x_dtype)
            if x_dtype == torch.bfloat16:
                assert plan == (splits, 128)
            args = (xd, wq.values, wq.scales, b)
            out = i8.w8_matmul(*args, act="silu")
            assert torch.equal(out, i8.w8_matmul(*args, act="silu"))
            assert within(out, i8.w8_matmul_plain(*args, act="silu"),
                          torch.bfloat16)


@pytest.mark.cuda
def test_cuda_w8_gemv_swapped_k_steps_leave_the_tolerance(cuda):
    """The control: two of the gemv's 16-row k-steps read in each other's
    place move the plain output past the tolerance the kernel is held to,
    and the kernel stays within it."""
    x, w, _ = matmul_inputs(4, 1024, 2048, cuda, seed=5)
    wq = qt.quantize_per_channel(w)
    x = x.to(torch.bfloat16)
    v = wq.values
    swapped = torch.cat([v[16:32], v[:16], v[32:]])
    ref = i8.w8_matmul_plain(x, v, wq.scales)
    assert within(i8.w8_matmul(x, v, wq.scales), ref, torch.bfloat16)
    assert not within(i8.w8_matmul_plain(x, swapped, wq.scales), ref,
                      torch.bfloat16)


# B10 past the matrix-vector rows, on the tensor-core kernel: (K, N)
# aligned, ragged in both (the wrapper zero-pads K and N to 16), a width
# under one tile, and Llama-3-8B's qkv
WGMMA_KN = [(256, 384), (1000, 1000), (70, 36), (4096, 6144)]


@pytest.mark.cuda
@pytest.mark.parametrize("act", [None, "relu", "gelu", "silu"])
@pytest.mark.parametrize("K,N", WGMMA_KN)
@pytest.mark.parametrize("M", [17, 36, 64, 256, 300])
def test_cuda_int8_matmul_wgmma_bit_exact(cuda, M, K, N, act):
    x, w, b = matmul_inputs(M, K, N, cuda, seed=4)
    xq, wq = qt.quantize_per_row(x), qt.quantize_per_channel(w)
    assert not i8.int8_plan(M, K, N)[0]
    for out_dtype in (torch.float32, torch.bfloat16):
        for bias in (None, b):
            args = (xq.values, xq.scales, wq.values, wq.scales, bias)
            out = i8.int8_matmul(*args, act=act, out_dtype=out_dtype)
            ref = i8.int8_matmul_plain(*args, act=act, out_dtype=out_dtype)
            assert torch.equal(out, ref), (out_dtype, bias is None)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", range(1, 17))
def test_cuda_int8_matmul_every_split(cuda, splits):
    """Every split count the planner can choose: one and two row tiles,
    whole and ragged last k-tiles, a ragged N."""
    for M, K, N in ((17, 128 * splits, 16), (200, 128 * splits - 48, 40)):
        assert i8.int8_plan(M, K, N)[1] == splits
        x, w, b = matmul_inputs(M, K, N, cuda, seed=splits)
        xq, wq = qt.quantize_per_row(x), qt.quantize_per_channel(w)
        args = (xq.values, xq.scales, wq.values, wq.scales, b)
        assert torch.equal(i8.int8_matmul(*args, act="silu"),
                           i8.int8_matmul_plain(*args, act="silu"))


@pytest.mark.cuda
def test_cuda_wgmma_split_k_on_two_streams(cuda):
    """The tensor-core kernel's split-K launches in flight on two streams
    keep separate tile counters."""
    x, w, _ = matmul_inputs(36, 4096, 1024, cuda, seed=5)
    wq = qt.quantize_per_channel(w)
    assert i8.int8_plan(36, 4096, 1024)[1] > 1
    xqs = [qt.quantize_per_row(a) for a in (x, x.flip(0))]
    refs = [i8.int8_matmul_plain(q.values, q.scales, wq.values, wq.scales)
            for q in xqs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for s, q, o in zip(streams, xqs, outs):
            with torch.cuda.stream(s):
                o.append(i8.int8_matmul(q.values, q.scales, wq.values,
                                        wq.scales))
    torch.cuda.synchronize()
    for o, ref in zip(outs, refs):
        assert all(torch.equal(y, ref) for y in o)


# B11 past the matrix-vector rows: (K, N) aligned, ragged in both (K % 8
# and N % 16: the wrapper zero-pads), a width under one tile, and
# Llama-3-8B's qkv
W8_WGMMA_KN = [(256, 384), (1000, 1000), (70, 36), (4096, 6144)]


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("act", [None, "relu", "gelu", "silu"])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M", [17, 36, 64, 65, 256, 1024])
def test_cuda_w8_matmul_past_16_rows_matches_plain(cuda, M, x_dtype, act,
                                                   bias):
    """B11 past 16 rows: bf16 x on the tensor-core kernel (64- and
    128-row tiles, K split or whole), f32 x on the CUDA-core tiles; both
    output dtypes; one launch a call."""
    for K, N in W8_WGMMA_KN:
        x, w, b = matmul_inputs(M, K, N, cuda, seed=6)
        wq = qt.quantize_per_channel(w)
        x = x.to(x_dtype)
        assert i8.w8_plan(M, K, N, x_dtype)[0] == (
            "wgmma" if x_dtype == torch.bfloat16 else "tiles")
        for out_dtype in (torch.float32, torch.bfloat16):
            args = (x, wq.values, wq.scales, b if bias else None)
            i8.W8_MATMUL.launches = 0
            out = i8.w8_matmul(*args, act=act, out_dtype=out_dtype)
            assert i8.W8_MATMUL.launches == 1
            ref = i8.w8_matmul_plain(*args, act=act, out_dtype=out_dtype)
            assert within(out, ref, out_dtype), (K, N, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", range(1, 17))
def test_cuda_w8_matmul_every_split(cuda, splits):
    """Every split count of B11's tensor-core plan, with one and two row
    tiles and a ragged N; the splits merge in a fixed order, so two runs
    give the same bits."""
    for M, K, N in ((17, 64 * splits, 16), (200, 64 * splits - 24, 40)):
        assert i8.w8_plan(M, K, N, torch.bfloat16)[1] == splits
        x, w, b = matmul_inputs(M, K, N, cuda, seed=splits)
        wq = qt.quantize_per_channel(w)
        args = (x.to(torch.bfloat16), wq.values, wq.scales, b)
        out = i8.w8_matmul(*args, act="silu")
        assert torch.equal(out, i8.w8_matmul(*args, act="silu"))
        assert within(out, i8.w8_matmul_plain(*args, act="silu"),
                      torch.bfloat16)


@pytest.mark.cuda
def test_cuda_w8_wgmma_split_k_on_two_streams(cuda):
    """B11's split-K launches in flight on two streams keep separate tile
    counters."""
    x, w, _ = matmul_inputs(36, 4096, 1024, cuda, seed=7)
    wq = qt.quantize_per_channel(w)
    assert i8.w8_plan(36, 4096, 1024, torch.bfloat16)[1] > 1
    xs = [a.to(torch.bfloat16) for a in (x, x.flip(0))]
    refs = [i8.w8_matmul(a, wq.values, wq.scales) for a in xs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for s, a, o in zip(streams, xs, outs):
            with torch.cuda.stream(s):
                o.append(i8.w8_matmul(a, wq.values, wq.scales))
    torch.cuda.synchronize()
    for o, ref in zip(outs, refs):
        assert all(torch.equal(y, ref) for y in o)


def decode_pool(rng, KH, dh, page, n_pages, pool_dtype, device):
    """A random one-layer-pair pool ``[L, 2, KH, n_pages, page, dh]`` (+
    flat INT8 scales) on ``device``."""
    shape = (L, 2, KH, n_pages, page, dh)
    if pool_dtype == "int8":
        vals = torch.from_numpy(rng.integers(-127, 128, size=shape).astype(
            np.int8))
        sc = torch.from_numpy((rng.random(
            (L, 2, KH, -(-n_pages * page // 128), 128)) * 0.02
            + 0.005).astype(np.float32))
        return vals.to(device), sc.to(device)
    vals = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    dt = torch.bfloat16 if pool_dtype == "bfloat16" else torch.float32
    return vals.to(device, dt), None


@pytest.mark.cuda
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (10, 20.0)])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("dh", [128, 256])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pool_dtype", ["int8", "bfloat16", "float32"])
def test_cuda_paged_attention_decode_matches_plain(cuda, pool_dtype, q_dtype,
                                                   dh, G, window, softcap):
    """B2 (split-KV) against its plain version over a 40-page table of
    8-key pages split 20 ways: a frozen lane (seq_len 0: zeros), seq_len
    1, a window whose first key lies inside a page (the splits before it
    empty), a lane mid-page and the table's last slot. One launch a call,
    the same bits from run to run."""
    rng = np.random.default_rng(12)
    B, KH, Pn, mp = 5, 2, 208, 40
    H = KH * G
    assert pa.decode_split_plan(B, KH, mp) == (20, 2)
    vals, sc = decode_pool(rng, KH, dh, PAGE, Pn, pool_dtype, cuda)
    bt = torch.from_numpy((rng.permutation(Pn - 1)[:B * mp] + 1).reshape(
        B, mp).astype(np.int32)).to(cuda)
    sl = torch.tensor([0, 1, 30, mp * PAGE, 250], device=cuda)
    q = torch.from_numpy(rng.normal(size=(B, 1, H, dh)).astype(
        np.float32)).to(cuda, q_dtype)
    kw = dict(page_size=PAGE, num_q_heads=H, window=window, softcap=softcap)
    tol = 1e-4 if q_dtype == torch.float32 else 2e-2
    pa.ATTENTION_DECODE.launches = 0
    out = pa.paged_attention_decode(q, vals, bt, sl, sc, LAYER, **kw)
    assert pa.ATTENTION_DECODE.launches == 1
    ref = pa.paged_attention_decode_plain(q, vals, bt, sl, sc, LAYER, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    assert not out[0].any()                          # the frozen lane
    assert torch.equal(out, pa.paged_attention_decode(q, vals, bt, sl, sc,
                                                      LAYER, **kw))


@pytest.mark.cuda
def test_cuda_paged_attention_decode_one_split(cuda):
    """A batch whose blocks fill two waves alone runs B2 unsplit (the
    block writes its output, no workspace)."""
    rng = np.random.default_rng(13)
    B, KH, G, Pn, mp = 40, 8, 4, 130, 3
    assert pa.decode_split_plan(B, KH, mp) == (1, 3)
    vals, sc = decode_pool(rng, KH, 128, PAGE, Pn, "int8", cuda)
    bt = torch.from_numpy((rng.permutation(Pn - 1)[:B * mp] + 1).reshape(
        B, mp).astype(np.int32)).to(cuda)
    sl = torch.from_numpy(rng.integers(1, mp * PAGE + 1, size=B).astype(
        np.int32)).to(cuda)
    q = torch.randn((B, 1, KH * G, 128), device=cuda).to(torch.bfloat16)
    kw = dict(page_size=PAGE, num_q_heads=KH * G)
    out = pa.paged_attention_decode(q, vals, bt, sl, sc, LAYER, **kw)
    ref = pa.paged_attention_decode_plain(q, vals, bt, sl, sc, LAYER, **kw)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_cuda_paged_attention_decode_512_pages(cuda, q_dtype):
    """B2 where a 32k-token INT8 table is its route (512 pages of 64 at 8
    KV heads, the scales budget): one sequence of 32,700 keys, and four
    ragged sequences of 1 to 512 pages."""
    KH, G, dh, page, mp = 8, 4, 128, 64, 512
    assert pa.decode_route(mp, KH, page, dh, True) == "paged_attention_decode"
    rng = np.random.default_rng(14)
    tol = 1e-4 if q_dtype == torch.float32 else 2e-2
    for lens in ([32700], [1, 64 * 7 + 3, 64 * 200, 64 * 512]):
        B = len(lens)
        Pn = B * mp + 1
        vals, sc = decode_pool(rng, KH, dh, page, Pn, "int8", cuda)
        bt = torch.from_numpy((rng.permutation(Pn - 1) + 1).reshape(
            B, mp).astype(np.int32)).to(cuda)
        sl = torch.tensor(lens, dtype=torch.int32, device=cuda)
        q = torch.randn((B, 1, KH * G, dh), device=cuda).to(q_dtype)
        kw = dict(page_size=page, num_q_heads=KH * G)
        pa.ATTENTION_DECODE.launches = 0
        out = pa.paged_attention_decode(q, vals, bt, sl, sc, LAYER, **kw)
        assert pa.ATTENTION_DECODE.launches == 1
        ref = pa.paged_attention_decode_plain(q, vals, bt, sl, sc, LAYER,
                                              **kw)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=0)
        del vals, sc, ref
        torch.cuda.empty_cache()


# B14/B15: (D, I, N3, act, norm, bk, bn): Llama-shaped with bk != bn, an
# intermediate size that is no multiple of bn, GPT-2-shaped GELU and
# LayerNorm with biases, and a hidden size no multiple of bk
CHAIN_SHAPES = {"swiglu": (256, 512, 384, "swiglu", "rmsnorm", 128, 256),
                "ragged-I": (256, 320, 192, "swiglu", "rmsnorm", 128, 128),
                "gelu-ln": (192, 768, 576, "gelu", "layernorm", 128, 128),
                "relu-ln": (384, 512, 128, "relu", "layernorm", 256, 128)}
#: (weights, activation dtype) of each variant
CHAIN_KINDS = {"bf16": ("dense", torch.bfloat16),
               "f32": ("dense", torch.float32),
               "int8-weight": ("int8", torch.bfloat16),
               "int8-weight-f32": ("int8", torch.float32),
               "w8a8": ("w8a8", torch.bfloat16),
               "w8a8-f32": ("w8a8", torch.float32)}


def chain_inputs(shape, kind, device, tail=True, seed=0):
    """A random packed chain of ``shape`` and ``kind`` on ``device``."""
    D, I, N3, act, norm, bk, bn = CHAIN_SHAPES[shape]
    weights, dt = CHAIN_KINDS[kind]
    g = torch.Generator(device="cpu").manual_seed(seed)

    def r(*s, scale=0.05):
        return (torch.randn(s, generator=g) * scale).to(device)

    def weight(K, N):
        w = r(K, N)
        return w.to(dt) if weights == "dense" else qt.quantize_per_channel(w)

    biased = norm == "layernorm"
    ops = [(cl.OP_O, weight(D, D), r(D) if biased else None)]
    if act == "swiglu":
        ops += [(cl.OP_G, weight(D, I), None), (cl.OP_U, weight(D, I), None)]
    else:
        ops += [(cl.OP_U, weight(D, I), r(I) if biased else None)]
    ops += [(cl.OP_D, weight(I, D), r(D) if biased else None)]
    if tail:
        ops += [(cl.OP_T, weight(D, N3), r(N3) if biased else None)]

    def ln():
        return (1.0 + r(D, scale=0.1), r(D) if biased else None)

    pc = cl.pack_chain(ops, D=D, I=I, ln_after_o=ln(),
                       ln_after_down=ln() if tail else None, act_kind=act,
                       norm_kind=norm, eps=1e-5, bk=bk, bn=bn,
                       w_dtype=dt if weights == "dense" else None,
                       w8a8=weights == "w8a8")
    return pc, dt


def chain_tol(kind):
    return 1e-4 if kind in ("f32", "int8-weight-f32") else 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("tail", [True, False])
@pytest.mark.parametrize("B", [1, 4, 6])
@pytest.mark.parametrize("kind", sorted(CHAIN_KINDS))
@pytest.mark.parametrize("shape", sorted(CHAIN_SHAPES))
def test_cuda_chain_decode_matches_plain(cuda, shape, kind, B, tail):
    pc, dt = chain_inputs(shape, kind, cuda, tail)
    g = torch.Generator(device="cpu").manual_seed(B)
    ain = torch.randn((B, pc.K0), generator=g).to(cuda, dt)
    x = torch.randn((B, pc.D), generator=g).to(cuda, dt)
    cl.CHAIN_DECODE.launches = 0
    out, t = cl.chain_decode(pc, ain, x)
    ref, rt = cl.chain_decode_plain(pc, ain, x)
    torch.cuda.synchronize()
    assert cl.CHAIN_DECODE.launches == 1
    assert out.dtype == dt and out.shape == (B, pc.D)
    pairs = [(out, ref)] + ([(t, rt)] if tail else [])
    assert (t is None) == (not tail)
    for o, r in pairs:
        scale = r.float().abs().max()
        assert (o.float() - r.float()).abs().max() <= chain_tol(kind) * scale


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(CHAIN_KINDS))
@pytest.mark.parametrize("shape", sorted(CHAIN_SHAPES))
def test_cuda_chain_decode_run_to_run(cuda, shape, kind):
    """B14 gives the same bits from run to run (the splits' partials
    merged in split order, each block's row statistics in a fixed order),
    at B 1, 4 and 13 (two row groups of the tasks)."""
    pc, dt = chain_inputs(shape, kind, cuda)
    for B in (1, 4, 13):
        g = torch.Generator(device="cpu").manual_seed(B)
        ain = torch.randn((B, pc.K0), generator=g).to(cuda, dt)
        x = torch.randn((B, pc.D), generator=g).to(cuda, dt)
        out, t = cl.chain_decode(pc, ain, x)
        out2, t2 = cl.chain_decode(pc, ain, x)
        assert torch.equal(out, out2) and torch.equal(t, t2)
        ref, rt = cl.chain_decode_plain(pc, ain, x)
        for o, r in ((out, ref), (t, rt)):
            scale = r.float().abs().max()
            assert (o.float() - r.float()).abs().max() <= \
                chain_tol(kind) * scale


@pytest.mark.cuda
@pytest.mark.parametrize("M", [4, 36, 70])
@pytest.mark.parametrize("kind", sorted(CHAIN_KINDS))
@pytest.mark.parametrize("shape", sorted(CHAIN_SHAPES))
def test_cuda_packed_linear_matches_plain(cuda, shape, kind, M):
    pc, dt = chain_inputs(shape, kind, cuda)
    g = torch.Generator(device="cpu").manual_seed(M)
    act = None if pc.act_kind == "swiglu" else pc.act_kind
    runs = [((cl.OP_O,), None), ((cl.OP_U,), act), ((cl.OP_D,), None),
            ((cl.OP_T,), None)]
    if pc.act_kind == "swiglu" and pc.I % pc.bn == 0:
        runs.append(((cl.OP_G, cl.OP_U), None))
    for ops, a in runs:
        K = pc.I if ops == (cl.OP_D,) else pc.D
        x = torch.randn((M, K), generator=g).to(cuda, dt)
        out = cl.packed_linear(pc, ops, x, act=a)
        ref = cl.packed_linear_plain(pc, ops, x, act=a)
        if pc.w8a8:
            assert torch.equal(out, ref), ops
        else:
            assert within(out, ref, dt), ops


@pytest.mark.cuda
@pytest.mark.parametrize("M", [17, 256])
def test_cuda_packed_linear_llama3_8b_w8a8_bit_exact(cuda, M):
    """B15 on the tensor-core kernel at each op of a Llama-3-8B-shaped
    w8a8 chain (bk 1024, bn 2048) and at the (gate, up) run."""
    D, I, N3 = 4096, 14336, 6144
    g = torch.Generator(device=cuda).manual_seed(M)

    def weight(K, N):
        return qt.quantize_per_channel(
            torch.randn((K, N), generator=g, device=cuda) * 0.02)

    ops = [(cl.OP_O, weight(D, D), None), (cl.OP_G, weight(D, I), None),
           (cl.OP_U, weight(D, I), None), (cl.OP_D, weight(I, D), None),
           (cl.OP_T, weight(D, N3), None)]
    ones = torch.ones(D, device=cuda)
    pc = cl.pack_chain(ops, D=D, I=I, ln_after_o=(ones, None),
                       ln_after_down=(ones, None), act_kind="swiglu",
                       norm_kind="rmsnorm", eps=1e-5, bk=1024, bn=2048,
                       w8a8=True)
    del ops
    runs = [(cl.OP_O,), (cl.OP_G,), (cl.OP_U,), (cl.OP_G, cl.OP_U),
            (cl.OP_D,), (cl.OP_T,)]
    cl.PACKED_LINEAR.launches = 0
    for run in runs:
        K = I if run == (cl.OP_D,) else D
        x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
        assert torch.equal(cl.packed_linear(pc, run, x),
                           cl.packed_linear_plain(pc, run, x)), run
    assert cl.PACKED_LINEAR.launches == len(runs)


@pytest.mark.cuda
def test_cuda_chain_in_the_engine(cuda):
    """A megakernel engine with the per-op copies dropped runs every decode
    layer through B14 and every prefill matmul but layer 0's qkv through
    B15 (3 + 4 per later layer), and matches the plain path's tokens."""
    cfg = tconfig.FrameworkConfig(
        model=tconfig.preset("llama-tiny"),
        cache=tconfig.CacheConfig(page_size=8, num_pages=64,
                                  max_pages_per_seq=8, kv_dtype="int8"),
        runtime=tconfig.RuntimeConfig(max_new_tokens=6, megakernel=True,
                                      megakernel_drop_weights=True))
    cfg.model.dtype, cfg.model.quant = "float32", "int8"
    eng = Engine(cfg, device=cuda, seed=0)
    assert "chains" in eng.params and "wo" not in eng.params["layers"][1]
    prompts = [[5, 9, 3, 14, 2], [1, 2, 3]]
    greedy = SamplingParams(temperature=0.0, eos_token_id=-1)
    cl.CHAIN_DECODE.launches = cl.PACKED_LINEAR.launches = 0
    out = eng.generate_batch_fused(prompts, 6, greedy)
    L = cfg.model.num_layers
    assert cl.CHAIN_DECODE.launches == L * 5
    assert cl.PACKED_LINEAR.launches == 3 + 4 * (L - 1)
    assert [len(r) for r in out] == [6, 6]


# B13: (label, E, K, N, bm, group_of_block): Mixtral-8x7B's two expert
# products at a 4 x 256-token prefill chunk (Npad 4096: 16 blocks of 256,
# the trailing padding blocks on the last expert), an expert with no
# rows, every block on one expert, K and N no multiple of a tile, and
# row blocks of 128 and 64 (the tensor-core kernel's 64-row tiles)
GMM_MIXTRAL = [0, 0, 1, 2, 2, 3, 4, 4, 5, 6, 7, 7, 7, 7, 7, 7]
GMM_SHAPES = [("we_gu", 8, 4096, 28672, 256, GMM_MIXTRAL),
              ("we_down", 8, 14336, 4096, 256, GMM_MIXTRAL),
              ("empty-expert", 4, 512, 384, 256, [0, 2, 2, 3]),
              ("one-expert", 3, 256, 256, 128, [1, 1, 1, 1]),
              ("ragged-K-N", 3, 200, 300, 64, [0, 1, 1, 2, 2]),
              ("bm64", 4, 128, 136, 64, [3, 0, 2, 1])]
#: (x dtype, weights): INT8 experts, dense bf16 and f32 weights
GMM_KINDS = {"bf16-int8": (torch.bfloat16, "int8"),
             "bf16-bf16": (torch.bfloat16, torch.bfloat16),
             "bf16-f32": (torch.bfloat16, torch.float32),
             "f32-int8": (torch.float32, "int8"),
             "f32-bf16": (torch.float32, torch.bfloat16),
             "f32-f32": (torch.float32, torch.float32)}
#: the kinds Mixtral's shapes run with (the engine's bf16 activations)
GMM_MIXTRAL_KINDS = ("bf16-int8", "bf16-bf16")
GMM_CASES = [(c, k) for c in GMM_SHAPES for k in sorted(GMM_KINDS)
             if not c[0].startswith("we_") or k in GMM_MIXTRAL_KINDS]


def gmm_inputs(case, kind, device, seed=0):
    _, E, K, N, bm, gb = case
    xdt, wkind = GMM_KINDS[kind]
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((len(gb) * bm, K), generator=g).to(device, xdt)
    w = (torch.randn((E, K, N), generator=g) * 0.02).to(device)
    w = qt.quantize_per_channel(w) if wkind == "int8" else w.to(wkind)
    return x, w, torch.tensor(gb, dtype=torch.int32, device=device), bm


@pytest.mark.cuda
@pytest.mark.parametrize("case,kind", GMM_CASES,
                         ids=[f"{c[0]}-{k}" for c, k in GMM_CASES])
def test_cuda_grouped_matmul_matches_plain(cuda, case, kind):
    x, w, gb, bm = gmm_inputs(case, kind, cuda)
    gmm.GROUPED_MATMUL.launches = 0
    out = gmm.grouped_matmul(x, w, gb, bm=bm)
    ref = gmm.grouped_matmul_plain(x, w, gb, bm=bm)
    torch.cuda.synchronize()
    assert gmm.GROUPED_MATMUL.launches == 1
    assert out.dtype == x.dtype and out.shape == ref.shape
    assert bool(torch.isfinite(out).all())
    assert within(out, ref, x.dtype)


@pytest.mark.cuda
def test_cuda_grouped_matmul_follows_the_group_ids(cuda):
    """Two blocks' group ids swapped (experts 0 and 2) move their rows
    past the tolerance and leave the others; an id outside [0, E) gives
    zeros."""
    x, w, gb, bm = gmm_inputs(GMM_SHAPES[2], "bf16-int8", cuda)
    out = gmm.grouped_matmul(x, w, gb, bm=bm)
    moved = gmm.grouped_matmul(x, w, gb[[1, 0, 2, 3]], bm=bm)
    assert torch.equal(moved[2 * bm:], out[2 * bm:])
    for b in (0, 1):
        rows = slice(b * bm, (b + 1) * bm)
        assert not within(moved[rows], out[rows], torch.bfloat16)
    bad = gb.clone()
    bad[3] = 7
    assert bool((gmm.grouped_matmul(x, w, bad, bm=bm)[3 * bm:] == 0).all())


@pytest.mark.cuda
def test_cuda_moe_dispatch_in_the_engine(cuda):
    """mixtral-tiny (f32 activations, INT8 experts) on the card: a
    300-token prompt's first 256-token chunk takes the dispatch (B13
    twice a layer), decode the masked loop (no B13); ``score_nll`` agrees
    with the CPU engine's on the same weights within 1e-4 relative."""
    m = tconfig.preset("mixtral-tiny")
    m.dtype, m.quant, m.max_seq_len = "float32", "int8-weight", 512
    cfg = tconfig.FrameworkConfig(
        model=m,
        cache=tconfig.CacheConfig(page_size=8, num_pages=128,
                                  max_pages_per_seq=48, kv_dtype="int8"),
        runtime=tconfig.RuntimeConfig(max_new_tokens=4, prefill_chunk=256))
    cpu = Engine(cfg, device="cpu", seed=0)
    eng = Engine(cfg, device=cuda, params=cpu.params)
    prompts = [[(7 * i + 3) % 500 for i in range(300)], [5, 9, 3]]
    L = m.num_layers
    # f32 activations take B13's CUDA-core kernel
    gmm.GROUPED_MATMUL.launches = 0
    nll = eng.score_nll(prompts)
    assert gmm.GROUPED_MATMUL.launches == 2 * L
    np.testing.assert_allclose(nll, cpu.score_nll(prompts), rtol=1e-4)
    greedy = SamplingParams(temperature=0.0, eos_token_id=-1)
    gmm.GROUPED_MATMUL.launches = 0
    state = eng.prefill(prompts, sampling=greedy)
    eng.decode(state, greedy)
    assert gmm.GROUPED_MATMUL.launches == 2 * L


# B13 with block_rows: (E, K, N, bm, group ids, routed rows a block); an
# expert with no rows (id 1 never appears), blocks whose routed rows end
# inside a 64-row consumer's or a 128-row tile's rows, padding blocks
# with none, and the trailing blocks past every range
GMM_BLOCK_ROWS = [(4, 512, 384, 128, [0, 0, 2, 3, 3, 3], [128, 70, 1, 128,
                                                          0, 0]),
                  (4, 1024, 512, 256, [0, 2, 2, 3, 3], [200, 256, 64, 0, 0])]


@pytest.mark.cuda
@pytest.mark.parametrize("case", GMM_BLOCK_ROWS, ids=["bm128", "bm256"])
@pytest.mark.parametrize("wkind", ["int8", "bf16"])
def test_cuda_grouped_matmul_block_rows(cuda, case, wkind):
    """The tensor-core kernel with ``block_rows`` against the plain
    version with it, on arbitrary x (rows past a block's count must come
    out as zeros, not as products), and without it on x whose rows past
    the counts are zeros (the dispatch's layout): the same output."""
    E, K, N, bm, ids, rows = case
    g = torch.Generator(device="cpu").manual_seed(3)
    x = torch.randn((len(ids) * bm, K), generator=g).to(cuda, torch.bfloat16)
    w = (torch.randn((E, K, N), generator=g) * 0.02).to(cuda)
    w = qt.quantize_per_channel(w) if wkind == "int8" else w.to(torch.bfloat16)
    gb = torch.tensor(ids, dtype=torch.int32, device=cuda)
    br = torch.tensor(rows, dtype=torch.int32, device=cuda)
    live = (torch.arange(bm, device=cuda)[None, :] < br[:, None]).reshape(-1)
    gmm.GROUPED_MATMUL.launches = 0
    out = gmm.grouped_matmul(x, w, gb, bm=bm, block_rows=br)
    ref = gmm.grouped_matmul_plain(x, w, gb, bm=bm, block_rows=br)
    torch.cuda.synchronize()
    assert gmm.GROUPED_MATMUL.launches == 1
    assert bool((out[~live] == 0).all()) and bool(torch.isfinite(out).all())
    assert within(out, ref, torch.bfloat16)
    xz = x * live[:, None].to(x.dtype)
    full = gmm.grouped_matmul(xz, w, gb, bm=bm)
    assert within(gmm.grouped_matmul(xz, w, gb, bm=bm, block_rows=br), full,
                  torch.bfloat16)
    assert within(full, gmm.grouped_matmul_plain(xz, w, gb, bm=bm),
                  torch.bfloat16)


def wgmma_pool(rng, KH, dh, page, n_pages, pool_dtype, device):
    """Random pool ``[L, 2, KH, n_pages, page, dh]`` (+ flat INT8
    scales)."""
    shape = (L, 2, KH, n_pages, page, dh)
    if pool_dtype == "int8":
        vals = torch.from_numpy(rng.integers(-127, 128, size=shape).astype(
            np.int8))
        R = -(-n_pages * page // 128)
        scales = torch.from_numpy((rng.random((L, 2, KH, R, 128)) * 0.02
                                   + 0.005).astype(np.float32))
        return vals.to(device), scales.to(device)
    vals = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return vals.to(device, torch.bfloat16), None


# B1 on the tensor cores: (T, seq_lens, q_offsets, window, softcap) for
# B = 3 over 160-key tables: a ragged first chunk, a second chunk, a
# window with a softcap, and a verify chunk off the page grid
WGMMA_CASES = [(40, [40, 23, 1], [0, 0, 0], 0, 0.0),
               (40, [120, 75, 41], [80, 35, 1], 0, 0.0),
               (40, [150, 100, 60], [110, 60, 20], 37, 20.0),
               (9, [79, 102, 136], [70, 93, 127], 0, 0.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("page", [16, 64])
@pytest.mark.parametrize("pool_dtype", ["int8", "bfloat16"])
@pytest.mark.parametrize("dh", [64, 96, 128, 256])
def test_cuda_attention_wgmma_matches_plain(cuda, dh, pool_dtype, page):
    """B1's tensor-core kernel (bf16 queries) at every preset head dim,
    INT8 and bf16 pools, pages of 16 (four a 64-key tile) and 64, against
    its plain version at 2e-2 of max|plain|; GQA 4 per KV head."""
    rng = np.random.default_rng(dh + page)
    B, KH, G, MPg = 3, 2, 4, 160 // page
    H = KH * G
    n_pages = B * MPg + 1
    vals, sc = wgmma_pool(rng, KH, dh, page, n_pages, pool_dtype, cuda)
    bt = torch.from_numpy((rng.permutation(n_pages - 1)[:B * MPg] + 1)
                          .reshape(B, MPg).astype(np.int32)).to(cuda)
    assert pa.prefill_route(torch.bfloat16, vals.dtype, dh, page) == "wgmma"
    for T, lens, offs, window, softcap in WGMMA_CASES:
        q = torch.from_numpy(rng.normal(size=(B, T, H, dh)).astype(
            np.float32)).to(cuda, torch.bfloat16)
        args = (q, vals, bt, torch.tensor(lens, device=cuda),
                torch.tensor(offs, device=cuda), sc, LAYER)
        kw = dict(page_size=page, num_q_heads=H, window=window,
                  softcap=softcap)
        pa.ATTENTION_WGMMA.launches = pa.ATTENTION.launches = 0
        out = pa.paged_attention(*args, **kw)
        ref = pa.paged_attention_plain(*args, **kw)
        torch.cuda.synchronize()
        assert pa.ATTENTION_WGMMA.launches == 1 and pa.ATTENTION.launches == 0
        tol = 2e-2 * ref.float().abs().max().item()
        err = (out.float() - ref.float()).abs().max().item()
        assert bool(torch.isfinite(out).all()) and err <= tol, (T, err, tol)


def misaligned(t):
    """``t``'s values in a view whose data starts 2 bytes past a 16-byte
    boundary."""
    flat = torch.empty(t.numel() * t.element_size() + 2, dtype=torch.uint8,
                       device=t.device)
    view = flat[2:].view(t.dtype).view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == 2
    return view


@pytest.mark.cuda
def test_cuda_misaligned_views_take_the_tensor_core_kernels(cuda):
    """Operands that are views at odd offsets go to the same tensor-core
    kernels as fresh ones (the wrappers copy them to aligned buffers):
    B1's queries and B13's activations and experts, each against its
    plain version."""
    rng = np.random.default_rng(11)
    B, KH, G, dh, page, MPg = 2, 2, 4, 128, 64, 3
    H, n_pages = KH * G, B * MPg + 1
    vals, sc = wgmma_pool(rng, KH, dh, page, n_pages, "int8", cuda)
    bt = torch.arange(1, n_pages, dtype=torch.int32, device=cuda).view(B, MPg)
    q = misaligned(torch.from_numpy(rng.normal(size=(B, 40, H, dh)).astype(
        np.float32)).to(cuda, torch.bfloat16))
    args = (q, vals, bt, torch.tensor([150, 40], device=cuda),
            torch.tensor([110, 0], device=cuda), sc, LAYER)
    kw = dict(page_size=page, num_q_heads=H)
    pa.ATTENTION_WGMMA.launches = pa.ATTENTION.launches = 0
    out = pa.paged_attention(*args, **kw)
    ref = pa.paged_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    assert pa.ATTENTION_WGMMA.launches == 1 and pa.ATTENTION.launches == 0
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2e-2 * ref.float().abs().max().item()

    x, w, gb, bm = gmm_inputs(GMM_SHAPES[3], "bf16-bf16", cuda)
    x, w = misaligned(x), misaligned(w)
    gmm.GROUPED_MATMUL.launches = 0
    out = gmm.grouped_matmul(x, w, gb, bm=bm)
    ref = gmm.grouped_matmul_plain(x, w, gb, bm=bm)
    torch.cuda.synchronize()
    assert gmm.GROUPED_MATMUL.launches == 1
    assert within(out, ref, torch.bfloat16)
