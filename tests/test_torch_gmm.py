"""B13, the MoE grouped matmul: the port's plain version
(``ops/gmm.py::grouped_matmul_plain``, what the wrapper runs on CPU
tensors) against the JAX package's Pallas ``grouped_matmul`` in
interpret mode, on the same numpy inputs.

Tolerances: f32 activations 1e-5 (relative to max|y|; both sum the same
exact products in f32, in another order); bf16 activations within one
bf16 step of the JAX output, or 1e-5 of max|y| where cancellation leaves
an output tiny (the two f32 sums may round to neighbouring bf16 values).
The edge cases are an expert with no rows, every row on one expert, and
K and N that are no multiple of 128 (the JAX wrapper pads them to its
blocks with zeros; the port takes them as they are). ``block_rows`` and
the choice between the two CUDA kernels (``route``) are held on their
own.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pagedattention_based_transformer_decoder_inference_framework_tpu.ops import gmm as jgmm
from pagedattention_based_transformer_decoder_inference_framework_tpu.quant import tensor as jqt
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.ops import gmm
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.quant import tensor as qt


def within_bf16_step(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    r = np.abs(ref)
    step = np.exp2(np.floor(np.log2(np.maximum(r, 2.0 ** -126))) - 7)
    return bool((np.abs(out - ref) <= np.maximum(step, 1e-5 * r.max())).all())


def to_torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


# (label, E, K, N, bm, group_of_block)
CASES = [
    ("mixed", 4, 256, 384, 64, [0, 0, 1, 2, 2, 2, 3, 3]),
    ("empty-expert", 4, 128, 256, 64, [0, 2, 2, 3, 3, 3]),
    ("one-expert", 3, 128, 128, 64, [1, 1, 1, 1]),
    ("ragged-K-N", 3, 200, 300, 64, [0, 1, 1, 2, 2]),
    ("bm256", 2, 128, 128, 256, [0, 1, 1]),
]
MODES = ["f32-dense", "bf16-dense", "bf16-int8", "f32-int8"]


def inputs(case, seed=0):
    _, E, K, N, bm, gb = case
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(len(gb) * bm, K)).astype(np.float32)
    w = (0.05 * rng.normal(size=(E, K, N))).astype(np.float32)
    return x, w, np.asarray(gb, np.int32), bm


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_grouped_matmul_plain_matches_jax(case, mode):
    x, w, gb, bm = inputs(case)
    xdt = mode.split("-")[0]
    jdt, tdt = ((jnp.float32, torch.float32) if xdt == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    tgb = torch.from_numpy(gb)
    if mode.endswith("int8"):
        jw = jqt.quantize_per_channel(jnp.asarray(w))
        tw = qt.QTensor(torch.from_numpy(np.array(jw.values)),
                        torch.from_numpy(np.array(jw.scales)))
    else:
        jw = jnp.asarray(w, jdt)
        tw = to_torch(w, tdt)
    want = jgmm.grouped_matmul(jnp.asarray(x, jdt), jw, jnp.asarray(gb),
                               bm=bm, interpret=True)
    got = gmm.grouped_matmul(to_torch(x, tdt), tw, tgb, bm=bm)
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    if xdt == "f32":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    else:
        assert within_bf16_step(got, want), np.abs(got - want).max()


def test_grouped_matmul_each_block_uses_its_expert():
    """Against a per-block product written out, with an f32 weight
    under bf16 x rounded to bf16 first (the JAX kernel's astype)."""
    x, w, gb, bm = inputs(CASES[0], seed=3)
    xb = to_torch(x, torch.bfloat16)
    got = gmm.grouped_matmul(xb, torch.from_numpy(w), torch.from_numpy(gb),
                             bm=bm).float()
    for r, e in enumerate(gb):
        rows = slice(r * bm, (r + 1) * bm)
        ref = (xb[rows].float() @ torch.from_numpy(w[e]).to(
            torch.bfloat16).float()).to(torch.bfloat16).float()
        assert torch.equal(got[rows], ref), r
    # two blocks' group ids swapped move their rows
    swapped = gb.copy()
    swapped[[1, 2]] = swapped[[2, 1]]
    moved = gmm.grouped_matmul(xb, torch.from_numpy(w),
                               torch.from_numpy(swapped), bm=bm).float()
    assert not torch.equal(moved[bm:3 * bm], got[bm:3 * bm])


def test_grouped_matmul_cpu_counts_no_launch():
    x, w, gb, bm = inputs(CASES[1])
    before = gmm.GROUPED_MATMUL.launches
    gmm.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(gb), bm=bm,
                       block_rows=torch.full((len(gb),), bm // 2))
    assert gmm.GROUPED_MATMUL.launches == before
    assert gmm.GROUPED_MATMUL.replaces == "ops/gmm.py:65"


@pytest.mark.parametrize("mode", ["f32-dense", "bf16-int8"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_grouped_matmul_plain_block_rows(case, mode):
    """``block_rows``: on the dispatch's x (rows past each block's routed
    count are zeros) the output equals the one without it; on arbitrary
    x the rows past the count are zeros and the others unchanged."""
    x, w, gb, bm = inputs(case, seed=5)
    rng = np.random.default_rng(6)
    rows = rng.integers(0, bm + 1, size=len(gb))
    rows[0], rows[-1] = bm, 0
    live = (np.arange(bm)[None, :] < rows[:, None]).reshape(-1)
    tdt = torch.float32 if mode.startswith("f32") else torch.bfloat16
    tw = (qt.quantize_per_channel(torch.from_numpy(w))
          if mode.endswith("int8") else torch.from_numpy(w))
    tgb, tr = torch.from_numpy(gb), torch.from_numpy(rows.astype(np.int32))
    xs = to_torch(x, tdt)
    full = gmm.grouped_matmul_plain(xs, tw, tgb, bm=bm)
    got = gmm.grouped_matmul_plain(xs, tw, tgb, bm=bm, block_rows=tr)
    assert bool((got[torch.from_numpy(~live)] == 0).all())
    assert torch.equal(got[torch.from_numpy(live)],
                       full[torch.from_numpy(live)])
    xz = to_torch(x * live[:, None], tdt)
    assert torch.equal(
        gmm.grouped_matmul_plain(xz, tw, tgb, bm=bm, block_rows=tr),
        gmm.grouped_matmul_plain(xz, tw, tgb, bm=bm))
    assert torch.equal(gmm.grouped_matmul(xz, tw, tgb, bm=bm, block_rows=tr),
                       gmm.grouped_matmul_plain(xz, tw, tgb, bm=bm))


# (weight dtype, K, N) -> the widths the tensor-core kernel reads
WGMMA_OPERANDS = [
    (torch.int8, 64, 256, 64, 256),
    (torch.bfloat16, 256, 136, 256, 136),
    (torch.int8, 256, 136, 256, 144),
    (torch.int8, 200, 304, 200, 304),
    (torch.int8, 204, 304, 208, 304),
    (torch.bfloat16, 36, 20, 40, 24),
    (torch.float32, 64, 64, 64, 64),
    (torch.float32, 30, 44, 32, 48),
    (torch.int8, 1, 1, 8, 16),
]


@pytest.mark.parametrize("wdt,K,N,Kp,Np", WGMMA_OPERANDS)
def test_wgmma_operands(wdt, K, N, Kp, Np):
    """bf16 x's operands for the tensor-core kernel: f32 experts rounded
    to bf16, K padded to a multiple of 8 and N to 16 (INT8) or 8 (bf16)
    with zeros, fresh 16-byte-aligned copies of misaligned views; the
    plain product of the padded operands, cut back to N, is the
    unpadded one exactly."""
    rng = np.random.default_rng(K * 1000 + N)
    E, bm = 3, 64
    gb = torch.tensor([2, 0, 1, 2], dtype=torch.int32)
    x = to_torch(rng.normal(size=(len(gb) * bm, K)), torch.bfloat16)
    wf = torch.from_numpy(rng.normal(size=(E, K, N)).astype(np.float32))
    if wdt == torch.int8:
        w = qt.quantize_per_channel(wf)
        wv, sc = w.values, w.scales.reshape(E, N)
    else:
        w = wv = wf.to(wdt)
        sc = None
    # a view one element in: its data is not 16-byte aligned
    xs = torch.empty(x.numel() + 1, dtype=x.dtype)[1:].view(x.shape)
    xs.copy_(x)
    assert xs.data_ptr() % 16 and torch.equal(xs, x)
    px, pw, psc, n_out = gmm.wgmma_operands(xs, wv, sc)
    assert n_out == Np and tuple(px.shape) == (len(gb) * bm, Kp)
    assert tuple(pw.shape) == (E, Kp, Np)
    assert pw.dtype == (torch.int8 if wdt == torch.int8 else torch.bfloat16)
    assert px.data_ptr() % 16 == 0 and pw.data_ptr() % 16 == 0
    assert bool((px[:, K:] == 0).all()) and bool((pw[:, K:] == 0).all())
    assert bool((pw[:, :, N:] == 0).all())
    pwq = pw if sc is None else qt.QTensor(pw, psc.reshape(E, 1, Np))
    got = gmm.grouped_matmul_plain(px, pwq, gb, bm=bm)[:, :N]
    assert torch.equal(got, gmm.grouped_matmul_plain(x, w, gb, bm=bm))


@pytest.mark.parametrize("bad", ["rows", "ids", "K", "K0", "w-dtype",
                                 "scales"])
def test_grouped_matmul_rejects_bad_operands(bad):
    x = torch.zeros((128, 32))
    w = torch.zeros((2, 32, 16))
    gb = torch.zeros((2,), dtype=torch.int32)
    args = {"rows": (x[:100], w, gb), "ids": (x, w, gb[:1]),
            "K": (x[:, :31], w, gb), "K0": (x[:, :0], w[:, :0], gb),
            "w-dtype": (x, w.to(torch.int8), gb),
            "scales": (x, qt.QTensor(w.to(torch.int8),
                                     torch.ones((2, 1, 15))), gb)}[bad]
    with pytest.raises(ValueError):
        gmm.grouped_matmul(*args, bm=64)
