"""On the card: each hand-written CUDA kernel of the PyTorch port against
its plain PyTorch version (B1/B2 paged attention, B3/B4 KV appends).

These tests import no JAX, so they run where the card is (the suite's
``conftest.py`` sets JAX up, hence ``--noconftest``):

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

Without a CUDA card every test skips (the kernels have no CPU mode).
Tolerances: f32 queries 1e-4 absolute (the kernel and the plain version
sum the same terms in another order), bf16 queries 2e-2 (one bf16 step
of outputs of magnitude ~1); appends are bit-exact.
"""

import numpy as np
import pytest
import torch

from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.kvcache import pool as tpool
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.ops import (
    kv_append as ka,
    paged_attention as pa,
)

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
@pytest.mark.parametrize("T", [1, 2 * PAGE])
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
    kern = ka.append_decode if T == 1 else ka.append_prefill
    kern(kv_k, news, LAYER, pos, bt)
    ka.append_plain(kv_p, news, LAYER,
                    torch.where(in_table, pos, -1).to(torch.int32),
                    torch.where(bt < P, bt, 0))
    for a, b in zip(kv_k, kv_p):
        assert torch.equal(a, b)
