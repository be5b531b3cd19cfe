"""The port's chained decode megakernel (``ops/chain_linear.py``,
``models/chained.py``) against the JAX package's, on the same numpy
inputs; the JAX kernels run in interpret mode, as
``tests/test_chain_linear.py`` runs them.

* Packing: ``pack_chain`` / ``build_decode_chains`` equal the JAX
  package's bit for bit (blocks, scales and biases, schedule, norms, op
  geometry, the dropped per-op keys).
* Kernels: ``chain_decode_plain`` and ``packed_linear_plain`` against
  the JAX ``chain_decode`` / ``packed_linear``. Tolerances, of
  max|output|: f32 activations 1e-5 (f32 sums in another order); bf16
  activations 1e-2 (h and the activation are rounded to bf16 between the
  ops, so a sum in another order can move one of them by a bf16 step);
  w8a8 2e-3 with f32 activations (an f32 norm sum in another order can
  move one re-quantized value by an INT8 step). ``packed_linear`` under
  w8a8 without an activation is bit-exact (exact s32 sums, the same
  quantizer and fused epilogue); otherwise (f32 sums in another order, or
  XLA's and PyTorch's GELU differing in the last bits) f32 outputs within
  1e-5 of max|output| and bf16 ones within one bf16 step.
* Model: a T=1 chained forward and a T>1 forward with the per-op copies
  dropped against the JAX ``forward`` on the same (bridged) chains. The
  engines are ``tests/test_torch_chain_engine.py``'s.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pagedattention_based_transformer_decoder_inference_framework_tpu import config as jconfig
from pagedattention_based_transformer_decoder_inference_framework_tpu.engine.backends import (
    DenseKVBackend as JaxDense,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu.models import chained as jchained
from pagedattention_based_transformer_decoder_inference_framework_tpu.models import model as jmodel
from pagedattention_based_transformer_decoder_inference_framework_tpu.ops import chain_linear as jcl
from pagedattention_based_transformer_decoder_inference_framework_tpu.quant.tensor import (
    quantize_per_channel as jax_quantize_per_channel,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch import config as tconfig
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.engine import (
    DenseKVBackend,
)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.models import chained as tchained
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.models import model as tmodel
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.ops import chain_linear as tcl
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.quant.tensor import (
    QTensor,
    quantize_per_channel,
)

from test_torch_model import narrow_dh128

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def to_np(a):
    """A JAX array or a torch tensor as f32 numpy (bf16 widened exactly)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.is_floating_point() else a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def assert_same_chain(jpc, tpc):
    for f in ("w", "sb", "meta", "ln"):
        j, t = getattr(jpc, f), getattr(tpc, f)
        assert str(t.dtype) == f"torch.{jnp.dtype(j.dtype).name}", f
        np.testing.assert_array_equal(to_np(t), to_np(j), err_msg=f)
    for f in dataclasses.fields(tcl.PackedChain):
        if f.name not in ("w", "sb", "meta", "ln"):
            assert getattr(tpc, f.name) == getattr(jpc, f.name), f.name


# -- packing ------------------------------------------------------------------

def model_pair(name, dtype="float32", quant="none", I=None):
    j, t = ((narrow_dh128(jconfig), narrow_dh128(tconfig))
            if name == "narrow-dh128"
            else (jconfig.preset(name), tconfig.preset(name)))
    for m in (j, t):
        m.dtype, m.quant = dtype, quant
        if I is not None:
            m.intermediate_size = I
    return j, t


def engine_params(jc, tc):
    """The JAX engine's layout (unstacked, fused, quantized for the INT8
    modes) and its bridge to the port."""
    jp = jmodel.init_params(jc, jax.random.key(0))
    if jc.quant != "none":
        jp = jax.jit(jmodel.quantize_params)(jp)
    jp = jmodel.fuse_projections(jmodel.unstack_layers(jp))
    return jp, tmodel.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), tc)


# (model, dtype, quant, intermediate size): Llama-shaped square blocks
# (D 64 < 128), bf16, INT8 weights, w8a8, GPT-2 (GELU, LayerNorm, biases),
# an intermediate size no multiple of bn, blocks on D (narrow D 128)
PACK_CASES = [("llama-tiny", "float32", "none", None),
              ("llama-tiny", "bfloat16", "none", None),
              ("llama-tiny", "float32", "int8-weight", None),
              ("llama-tiny", "float32", "int8", None),
              ("gpt2-tiny", "float32", "none", None),
              ("llama-tiny", "float32", "none", 320),
              ("narrow-dh128", "float32", "int8", None)]


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("case", PACK_CASES, ids=lambda c: "-".join(
    str(v) for v in c if v is not None))
def test_build_decode_chains_matches_jax(case, drop):
    name, dtype, quant, I = case
    jc, tc = model_pair(name, dtype, quant, I)
    jp, tp = engine_params(jc, tc)
    assert tchained.chains_supported(tc, tp)
    jout = jchained.build_decode_chains(jp, jc, drop=drop)
    tout = tchained.build_decode_chains(tp, tc, drop=drop)
    assert len(tout["chains"]) == jc.num_layers
    for jpc, tpc in zip(jout["chains"], tout["chains"]):
        assert_same_chain(jpc, tpc)
    assert not tout["chains"][-1].has_tail           # the last layer
    for jl, tl in zip(jout["layers"], tout["layers"]):
        assert sorted(jl) == sorted(tl)
    if drop:
        assert "wo" not in tout["layers"][1] and "w_qkv" not in \
            tout["layers"][1] and "w_qkv" in tout["layers"][0]


# -- the kernels' plain versions ----------------------------------------------

# (D, I, N3, act, norm, bk, bn): Llama-shaped with bk != bn, an
# intermediate size no multiple of bn, GELU / ReLU with LayerNorm and
# biases, a hidden size no multiple of bk
KERNEL_SHAPES = {"swiglu": (256, 512, 384, "swiglu", "rmsnorm", 128, 256),
                 "ragged-I": (256, 320, 192, "swiglu", "rmsnorm", 128, 128),
                 "gelu-ln": (192, 384, 64, "gelu", "layernorm", 128, 128),
                 "relu-ln": (384, 512, 128, "relu", "layernorm", 256, 128)}
#: (weights, activation dtype, tolerance of max|output|)
KERNEL_KINDS = {"f32": ("dense", "float32", 1e-5),
                "bf16": ("dense", "bfloat16", 1e-2),
                "int8-weight": ("int8", "float32", 1e-5),
                "int8-weight-bf16": ("int8", "bfloat16", 1e-2),
                "w8a8": ("w8a8", "float32", 2e-3),
                "w8a8-bf16": ("w8a8", "bfloat16", 1e-2)}


def packed_pair(shape, kind, tail=True, seed=0):
    """The same random chain packed by both packages."""
    D, I, N3, act, norm, bk, bn = KERNEL_SHAPES[shape]
    weights, dtype, _ = KERNEL_KINDS[kind]
    rng = np.random.default_rng(seed)
    r = lambda *s: (rng.normal(size=s) * 0.1).astype(np.float32)
    biased = norm == "layernorm"
    spec = [(tcl.OP_O, D, D, biased)]
    spec += ([(tcl.OP_G, D, I, False), (tcl.OP_U, D, I, False)]
             if act == "swiglu" else [(tcl.OP_U, D, I, biased)])
    spec += [(tcl.OP_D, I, D, biased)]
    if tail:
        spec += [(tcl.OP_T, D, N3, biased)]
    jops, tops = [], []
    for op, K, N, has_b in spec:
        w, b = r(K, N), (r(N) if has_b else None)
        if weights == "dense":
            jw = jnp.asarray(w).astype(dtype)
            tw = torch.from_numpy(to_np(jw).copy()).to(TDT[dtype])
        else:
            jw = jax.jit(jax_quantize_per_channel)(jnp.asarray(w))
            tw = QTensor(torch.from_numpy(np.asarray(jw.values).copy()),
                         torch.from_numpy(np.asarray(jw.scales).copy()))
        jops.append((op, jw, None if b is None else jnp.asarray(b)))
        tops.append((op, tw, None if b is None else torch.from_numpy(b)))
    lns = [(1 + r(D), r(D) if biased else None) for _ in range(2)]
    kw = dict(D=D, I=I, act_kind=act, norm_kind=norm, eps=1e-5, bk=bk,
              bn=bn, w8a8=weights == "w8a8")
    jpc = jcl.pack_chain(
        jops, ln_after_o=tuple(None if a is None else jnp.asarray(a)
                               for a in lns[0]),
        ln_after_down=(tuple(None if a is None else jnp.asarray(a)
                             for a in lns[1]) if tail else None),
        w_dtype=jnp.dtype(dtype) if weights == "dense" else None, **kw)
    tpc = tcl.pack_chain(
        tops, ln_after_o=tuple(None if a is None else torch.from_numpy(a)
                               for a in lns[0]),
        ln_after_down=(tuple(None if a is None else torch.from_numpy(a)
                             for a in lns[1]) if tail else None),
        w_dtype=TDT[dtype] if weights == "dense" else None, **kw)
    return jpc, tpc, dtype


@pytest.mark.parametrize("tail,B", [(True, 3), (False, 1)])
@pytest.mark.parametrize("kind", sorted(KERNEL_KINDS))
@pytest.mark.parametrize("shape", sorted(KERNEL_SHAPES))
def test_chain_decode_plain_matches_jax(shape, kind, tail, B):
    jpc, tpc, dtype = packed_pair(shape, kind, tail)
    assert_same_chain(jpc, tpc)
    rng = np.random.default_rng(B)
    ain = rng.normal(size=(B, tpc.K0)).astype(np.float32)
    x = rng.normal(size=(B, tpc.D)).astype(np.float32)
    jx, jt = jcl.chain_decode(jpc, jnp.asarray(ain).astype(dtype),
                              jnp.asarray(x).astype(dtype), interpret=True)
    tx, tt = tcl.chain_decode(tpc, torch.from_numpy(ain).to(TDT[dtype]),
                              torch.from_numpy(x).to(TDT[dtype]))
    assert tx.dtype == TDT[dtype] and (tt is None) == (not tail)
    tol = KERNEL_KINDS[kind][2]
    for t, j in [(tx, jx)] + ([(tt, jt)] if tail else []):
        j = to_np(j)
        np.testing.assert_allclose(to_np(t), j, rtol=0,
                                   atol=tol * np.abs(j).max())


def within_bf16_step(out, ref):
    step = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126)))
                   - 7)
    return bool((np.abs(out - ref) <= np.maximum(step, 1e-5 *
                                                 np.abs(ref).max())).all())


@pytest.mark.parametrize("kind", sorted(KERNEL_KINDS))
@pytest.mark.parametrize("shape", sorted(KERNEL_SHAPES))
def test_packed_linear_plain_matches_jax(shape, kind):
    jpc, tpc, dtype = packed_pair(shape, kind, seed=1)
    rng = np.random.default_rng(2)
    act = None if tpc.act_kind == "swiglu" else tpc.act_kind
    runs = [((tcl.OP_O,), None, (5,)), ((tcl.OP_U,), act, (2, 3)),
            ((tcl.OP_D,), None, (7,)), ((tcl.OP_T,), None, (4,))]
    if tpc.act_kind == "swiglu":
        runs.append(((tcl.OP_G,), None, (3,)))
        if tpc.I % tpc.bn == 0:
            runs.append(((tcl.OP_G, tcl.OP_U), None, (6,)))
    for ops, a, lead in runs:
        K = tpc.I if ops == (tcl.OP_D,) else tpc.D
        x = rng.normal(size=lead + (K,)).astype(np.float32)
        j = to_np(jcl.packed_linear(jpc, ops, jnp.asarray(x).astype(dtype),
                                    act=a, interpret=True))
        t = tcl.packed_linear(tpc, ops, torch.from_numpy(x).to(TDT[dtype]),
                              act=a)
        assert t.dtype == TDT[dtype] and t.shape == j.shape, ops
        if tpc.w8a8 and a is None:
            np.testing.assert_array_equal(to_np(t), j, err_msg=str(ops))
        elif dtype == "float32":
            np.testing.assert_allclose(to_np(t), j, rtol=0,
                                       atol=1e-5 * np.abs(j).max())
        else:
            assert within_bf16_step(to_np(t), j), ops


def test_packed_ops_must_form_one_run():
    _, tpc, _ = packed_pair("ragged-I", "f32")
    x = torch.zeros((2, tpc.D))
    with pytest.raises(ValueError, match="one column run"):
        tcl.packed_linear(tpc, (tcl.OP_G, tcl.OP_U), x)
    with pytest.raises(ValueError, match="not all in"):
        tcl.packed_linear(tpc, (tcl.OP_O, 7), x)


@pytest.mark.parametrize("M", [3, 40])
def test_packed_rows_padded_for_the_tensor_cores_keep_the_product(M):
    """B15's w8a8 rows zero-padded to a multiple of 16 (the tensor-core
    kernel's 16-byte rows; the blocks hold at least that many rows) give
    every op's output bit for bit, on a chain whose K fit no 16."""
    D, I = 200, 328
    g = torch.Generator().manual_seed(M)
    r = lambda *s: torch.randn(s, generator=g) * 0.1
    ops = [(tcl.OP_O, quantize_per_channel(r(D, D)), None),
           (tcl.OP_G, quantize_per_channel(r(D, I)), None),
           (tcl.OP_U, quantize_per_channel(r(D, I)), None),
           (tcl.OP_D, quantize_per_channel(r(I, D)), None)]
    pc = tcl.pack_chain(ops, D=D, I=I, ln_after_o=(1 + r(D), None),
                        ln_after_down=None, act_kind="swiglu",
                        norm_kind="rmsnorm", eps=1e-5, bk=128, bn=128,
                        w8a8=True)
    for op_id, _, _ in ops:
        _, g0, KB, NB, K, N, sb0 = [t for t in pc.ops_geom
                                    if t[0] == op_id][0]
        xq, xs = tcl._quant_rows(r(M, K))
        xp, Kp = tcl._wgmma_rows(xq)
        assert Kp % 16 == 0 and Kp > K and xp.shape == (M, Kp)
        assert torch.equal(xp[:, :K], xq) and not xp[:, K:].any()
        ref = tcl._product(pc, g0, KB, NB, sb0, xq, xs)
        assert torch.equal(tcl._product(pc, g0, KB, NB, sb0, xp, xs), ref)


# -- the model ----------------------------------------------------------------

@pytest.mark.parametrize("name,quant", [("llama-tiny", "none"),
                                        ("gpt2-tiny", "none"),
                                        ("narrow-dh128", "int8"),
                                        ("llama-tiny", "int8-weight")])
def test_bridged_dropped_chains_forward_matches_jax(name, quant):
    """A JAX ``build_decode_chains(drop=True)`` pytree bridges and runs: a
    T=7 forward served from the packed blocks (B15's plain version), then
    a T=1 chained step (B14's), against the JAX forward on the same
    chains; f32 model, atol 1e-4 (w8a8 5e-3: an f32 sum in another order
    can move a re-quantized activation by an INT8 step)."""
    jc, tc = model_pair(name, quant=quant)
    jp, _ = engine_params(jc, tc)
    jp = jchained.build_decode_chains(jp, jc, drop=True)
    tp = tmodel.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tc)
    assert isinstance(tp["chains"][0], tcl.PackedChain)
    assert "wo" not in tp["layers"][0] and "w_qkv" not in tp["layers"][1]
    tol = dict(atol=5e-3 if quant == "int8" else 1e-4, rtol=1e-4)
    rng = np.random.default_rng(6)
    B, T = 2, 7
    tokens = rng.integers(0, jc.vocab_size, size=(B, T))
    pos = np.broadcast_to(np.arange(T), (B, T))
    jd, td = JaxDense(jc, "float32"), DenseKVBackend(tc, "float32")
    jm, tm = jmodel.DecoderModel(jc), tmodel.DecoderModel(tc)
    jl, jkv = jm.forward(jp, jnp.asarray(tokens), jnp.asarray(pos),
                         jd.init_cache(B, 32), jd.attn_fn)
    tl, tkv = tm.forward(tp, torch.from_numpy(tokens),
                         torch.from_numpy(pos.copy()), td.init_cache(B, 32),
                         td.attn_fn)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    tok = np.asarray(jl)[:, -1].argmax(-1)[:, None]
    step = np.full((B, 1), T)
    jl, _ = jm.forward(jp, jnp.asarray(tok), jnp.asarray(step), jkv,
                       jd.attn_fn)
    tl, _ = tm.forward(tp, torch.from_numpy(tok), torch.from_numpy(step),
                       tkv, td.attn_fn)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)


def chain_geom(D, I, N3, act, bk, bn, tail=True):
    """``ops_geom`` as :func:`pack_chain` lays out a chain of these widths
    (no weights needed)."""
    ids = [tcl.OP_O] + ([tcl.OP_G] if act == "swiglu" else []) + \
        [tcl.OP_U, tcl.OP_D] + ([tcl.OP_T] if tail else [])
    KN = {tcl.OP_O: (D, D), tcl.OP_G: (D, I), tcl.OP_U: (D, I),
          tcl.OP_D: (I, D), tcl.OP_T: (D, N3)}
    geom, g0, sb0 = [], 0, 0
    for op in ids:
        K, N = KN[op]
        KB, NB = -(-K // bk), -(-N // bn)
        geom.append((op, g0, KB, NB, K, N, sb0))
        g0, sb0 = g0 + KB * NB, sb0 + NB
    return tuple(geom)


#: B14's geometries: Llama-3-8B's chain (bk 1024, bn 2048), the card's edge
#: chains (GPT-2, TinyLlama's I % bn != 0, D 1280 in square blocks) and the
#: card tests' small ones
PLAN_GEOMS = {"llama3-8b": (4096, 14336, 6144, "swiglu", 1024, 2048),
              "gpt2": (768, 3072, 2304, "gelu", 768, 768),
              "tinyllama": (2048, 5632, 2560, "swiglu", 1024, 2048),
              "d1280": (1280, 5120, 3840, "swiglu", 1280, 1280),
              "small": (256, 512, 384, "swiglu", 128, 256),
              "relu-ln": (384, 512, 128, "relu", 256, 128)}


@pytest.mark.parametrize("w8a8", [False, True])
@pytest.mark.parametrize("B", [1, 4, 6, 16])
@pytest.mark.parametrize("name", sorted(PLAN_GEOMS))
def test_chain_plan(name, B, w8a8):
    """B14's host table as ``csrc/chain_linear.cu`` checks it: per op a
    task's rows S a multiple of 128 that divides bk, at most 1024, the
    largest that still gives a task an SM (else the smallest); the
    workspace regions (residual, attention input, h, gate, up, act, the
    row scales, the largest phase's split-K partials) in order, aligned and
    as large as the kernel reads them; a counter per column tile and row
    group of four rows."""
    D, I, N3, act, bk, bn = PLAN_GEOMS[name]
    geom = chain_geom(D, I, N3, act, bk, bn)
    table, total, counters = tcl.chain_plan(geom, bk, bn, D, I, D, w8a8, B)
    v = table.tolist()
    assert v[0] == len(geom)
    ops = [v[1 + 8 * i:9 + 8 * i] for i in range(len(geom))]
    off = v[1 + 8 * len(geom):]
    Bp = -(-B // 4) * 4
    rgroups = Bp // 4
    for (op, g0, KB, NB, K, N, sb0, S), g in zip(ops, geom):
        assert (op, g0, KB, NB, K, N, sb0) == g
        assert S % 128 == 0 and bk % S == 0 and S <= 1024
        work = NB * bn // 128 * rgroups * KB
        fits = [s for s in range(128, min(bk, 1024) + 1, 128) if bk % s == 0]
        enough = [s for s in fits if work * (bk // s) >= tcl._TASKS]
        assert S == (max(enough) if enough else fits[0])
    assert counters == 1 + sum(NB * bn // 128 * rgroups
                               for _, _, _, NB, _, _, _ in geom)
    lcm = np.lcm(bk, bn)
    Wd, Wi = -(-D // lcm) * lcm, -(-I // lcm) * lcm
    K0p = -(-D // bk) * bk
    a8 = 1 if w8a8 else 4
    sizes = [4 * Bp * Wd, a8 * Bp * K0p, a8 * Bp * Wd, 4 * Bp * Wi,
             4 * Bp * Wi, a8 * Bp * Wi, 12 * Bp]
    assert len(off) == 8 and off[0] == 0
    assert all(o % 256 == 0 for o in off)
    for r, size in enumerate(sizes):
        assert off[r + 1] - off[r] >= size
    phase = {tcl.OP_O: 0, tcl.OP_G: 1, tcl.OP_U: 1, tcl.OP_D: 2,
             tcl.OP_T: 3}
    need = {}
    for op, _, KB, NB, _, _, _, S in ops:
        if KB * bk // S > 1:
            need[phase[op]] = need.get(phase[op], 0) + \
                4 * (KB * bk // S) * Bp * NB * bn
    assert total - off[7] >= max(need.values(), default=0)


def test_chain_plan_llama3_8b_tasks():
    """At Llama-3-8B's chain and a decode batch of 4, w8a8: the o-projection
    split in 512-row tasks (32 column tiles x 8 = 256 tasks, at least one an
    SM), the rest in whole 1024-row blocks (448, 448, 448 and 192 tasks)."""
    D, I, N3, act, bk, bn = PLAN_GEOMS["llama3-8b"]
    geom = chain_geom(D, I, N3, act, bk, bn)
    table, _, _ = tcl.chain_plan(geom, bk, bn, D, I, D, True, 4)
    v = table.tolist()
    assert [v[8 + 8 * i] for i in range(5)] == [512, 1024, 1024, 1024, 1024]
