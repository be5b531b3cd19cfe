"""The chained decode megakernel: one layer's post-attention matmul chain
in one launch (the JAX package's ``ops/chain_linear.py``).

A decoder layer's weights after attention

    o-proj -> (+residual, norm) -> gate|up / fc1 -> (SwiGLU / GELU / ReLU)
    -> down / fc2 -> (+residual, norm) -> next layer's qkv-proj

are packed once, at engine build, into ONE ``[G, bk, bn]`` block array in
stream order (n-major, k-minor within each op), with per-column scales
and biases (``sb``), the two norms (``ln``) and the op geometry
(``ops_geom``). :func:`pack_chain` builds the JAX package's packing bit for
bit, on the weights' device (reshapes and a permute per op, no host
round trip). Two hand-written CUDA kernels (``csrc/chain_linear.cu``)
read it as it is:

* :func:`chain_decode` (B14) replaces ``chain_decode``
  (``_chain_kernel`` / ``_chain_kernel_w8a8``): the whole chain for a
  decode batch ``[B, D]``, the residual stream kept in f32 from entry to
  ``x_out``. On the TPU a sequential grid over the G blocks carries the
  activations in VMEM; here one cooperative, persistent launch runs the
  ops as phases separated by grid-wide barriers, each matmul phase split
  over column tiles and K so that all SMs stream weight bytes.
* :func:`packed_linear` (B15) replaces ``packed_linear``
  (``_packed_mm_kernel`` / ``_packed_mm_w8a8_kernel``):
  ``act(x @ W_op + b)`` for one op, or the column concat of a contiguous
  ``(OP_G, OP_U)`` run, served from the packed blocks, so the engine can
  drop the per-op weight copies (``RuntimeConfig.megakernel_drop_weights``)
  and still prefill and verify. Under w8a8 it is B10's INT8 tensor-core
  kernel (``csrc/imma.cuh``) reading the blocks through a 3-D tensor map,
  with K split as :func:`int8_matmul.wgmma_plan` says; other chains take
  a CUDA-core tiled product.

Numerics follow the JAX kernels: blocks in the activation dtype (INT8
widened) with f32 sums, or under w8a8 (``pc.w8a8``) s8 x s8 sums in s32
with activations re-quantized per row (:func:`_quant_rows`, the quantizer
of ``quant/tensor.py``) after each norm and after the activation; the
epilogue ``acc * w_scale + bias`` is one fused multiply-add, as XLA
compiles it. The plain versions (:func:`chain_decode_plain`,
:func:`packed_linear_plain`) mirror the chain's rounding points, never
``linear``'s. The wrappers run them for CPU tensors only; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, List, Optional, Sequence, Tuple

import torch

from ..quant.tensor import QTensor, quantize_per_row
from ..utils.common import cdiv, round_up
from ..utils.platform import (DTYPE_CODES, LL, CudaKernel, F, I, P,
                              aligned16, ptr, stream_handle)
from .common import activation_fn
from .int8_matmul import (SMS, act_code, epilogue, exact_int_matmul,
                          wgmma_plan, wgmma_scratch)

# op ids of the metadata table (the JAX package's)
OP_O = 0        # o-projection: attn_in @ Wo -> residual add, then norm
OP_G = 1        # SwiGLU gate: h @ Wgate -> stashed raw (f32)
OP_U = 2        # SwiGLU up / GPT-2 fc1: h @ W -> activation
OP_D = 3        # down / fc2: act @ W -> residual add (then norm if tail)
OP_T = 4        # tail: h @ Wqkv_next -> tail output

CHAIN_DECODE = CudaKernel(
    "chain_decode", "chain_linear.cu", "pbt_chain_decode",
    [P] * 10 + [LL] + [I] * 8 + [F] + [I] * 4 + [P],
    "ops/chain_linear.py:329")
PACKED_LINEAR = CudaKernel(
    "packed_linear", "chain_linear.cu", "pbt_packed_linear",
    [P] * 8 + [I] * 14 + [P], "ops/chain_linear.py:593")

#: act / norm codes of csrc/chain_linear.cu
_ACT_KINDS = {"swiglu": 0, "gelu": 1, "relu": 2}
_NORM_KINDS = {"rmsnorm": 0, "layernorm": 1}
#: weight codes of csrc/chain_linear.cu (DTYPE_CODES' order)
_W_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
#: B14's tile: 128 output columns by 4 batch rows; a task's K range is a
#: multiple of 128 rows that divides bk
_TILE_N, _ROWS, _K_STEP = 128, 4, 128
#: B14 splits K until a matmul phase has this many tasks (one per SM:
#: fewer, larger tasks than two per resident block measured faster, with
#: fewer split-K partials; PERF.md); a task stages at most _MAX_S rows of
#: its source in shared memory
_TASKS, _MAX_S = SMS, 1024
#: byte alignment of the workspace regions
_ALIGN = 256


@dataclasses.dataclass
class PackedChain:
    """Weights of one decode chain, packed in stream order.

    ``w``    — ``[G, bk, bn]`` weight blocks (int8 | bf16 | f32)
    ``sb``   — ``[2, totN]`` f32: row 0 per-column dequant scales
               (ones when unquantized), row 1 biases (zeros when absent)
    ``meta`` — ``int32[G, 6]`` per-block schedule
    ``ln``   — ``[4, Wd]`` f32: norm-after-o scale/bias, norm-after-down
               scale/bias (zero-padded past the true hidden size)
    ``ops_geom`` — ``(op_id, g0, KB, NB, K, N, sb_base)`` per op.
    """

    w: torch.Tensor
    sb: torch.Tensor
    meta: torch.Tensor
    ln: torch.Tensor
    D: int
    I: int
    K0: int
    N3: int
    bk: int
    bn: int
    quantized: bool
    act_kind: str        # "swiglu" | "gelu" | "relu"
    norm_kind: str       # "rmsnorm" | "layernorm"
    has_tail: bool
    eps: float
    ops_geom: tuple = ()
    w8a8: bool = False

    def to(self, device) -> "PackedChain":
        return dataclasses.replace(
            self, w=self.w.to(device), sb=self.sb.to(device),
            meta=self.meta.to(device), ln=self.ln.to(device))


def pack_chain(ops: Sequence[Tuple[int, Any, Optional[torch.Tensor]]],
               *, D: int, I: int,
               ln_after_o: Tuple[Any, Optional[Any]],
               ln_after_down: Optional[Tuple[Any, Optional[Any]]],
               act_kind: str, norm_kind: str, eps: float,
               bk: int = 1024, bn: int = 2048,
               w_dtype=None, w8a8: bool = False) -> PackedChain:
    """Pack one chain. ``ops`` = sequence of ``(op_id, W, bias)`` in
    stream order; ``W`` is ``[K, N]`` dense or a :class:`QTensor` with
    ``[1, N]`` scales. Runs on the weights' device into one preallocated
    block array, one op at a time."""
    quantized = any(isinstance(w, QTensor) for _, w, _ in ops)
    if not all(isinstance(w, QTensor) == quantized for _, w, _ in ops):
        raise ValueError("chain ops must be uniformly quantized or "
                         "uniformly dense")
    lcm = math.lcm(bk, bn)
    Wd = round_up(D, lcm)
    if w_dtype is None:
        w_dtype = torch.int8 if quantized else torch.bfloat16
    first = ops[0][1]
    device = (first.values if quantized else first).device

    geom: List[Tuple[int, ...]] = []
    meta: List[List[int]] = []
    sb_base = g_base = 0
    K0 = N3 = 0
    has_tail = False
    for op_id, w, _ in ops:
        K, N = (w.values if quantized else w).shape
        KB, NB = cdiv(K, bk), cdiv(N, bn)
        if op_id == OP_O:
            K0 = K
        if op_id == OP_T:
            N3, has_tail = N, True
        for n in range(NB):
            for k in range(KB):
                meta.append([op_id, k, n, sb_base + n, int(k == KB - 1),
                             int(n == NB - 1 and k == KB - 1)])
        geom.append((op_id, g_base, KB, NB, K, N, sb_base))
        sb_base += NB
        g_base += NB * KB

    w_packed = torch.empty((g_base, bk, bn), dtype=w_dtype, device=device)
    sb = torch.zeros((2, sb_base * bn), dtype=torch.float32, device=device)
    sb[0] = 1.0
    for (op_id, g0, KB, NB, K, N, sb0), (_, w, bias) in zip(geom, ops):
        vals = w.values if quantized else w
        Kp, Np = KB * bk, NB * bn
        if (Kp, Np) != (K, N):
            padded = torch.zeros((Kp, Np), dtype=vals.dtype, device=device)
            padded[:K, :N] = vals
            vals = padded
        # [KB, bk, NB, bn] -> [NB, KB, bk, bn]
        w_packed[g0:g0 + NB * KB].view(NB, KB, bk, bn).copy_(
            vals.reshape(KB, bk, NB, bn).permute(2, 0, 1, 3))
        c0 = sb0 * bn
        if quantized:
            sb[0, c0:c0 + N] = w.scales.reshape(-1).float()
        if bias is not None:
            sb[1, c0:c0 + N] = bias.reshape(-1).float()

    def ln_rows(pair):
        out = torch.zeros((2, Wd), dtype=torch.float32, device=device)
        if pair is not None:
            scale, bias = pair
            out[0, :D] = scale.reshape(-1).float()
            if bias is not None:
                out[1, :D] = bias.reshape(-1).float()
        return out

    return PackedChain(
        w=w_packed, sb=sb,
        meta=torch.tensor(meta, dtype=torch.int32, device=device),
        ln=torch.cat([ln_rows(ln_after_o), ln_rows(ln_after_down)]),
        D=D, I=I, K0=K0, N3=N3, bk=bk, bn=bn, quantized=quantized,
        act_kind=act_kind, norm_kind=norm_kind, has_tail=has_tail,
        eps=eps, ops_geom=tuple(geom), w8a8=w8a8 and quantized)


# -- plain versions ---------------------------------------------------------

def _quant_rows(x32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric INT8 quantization (``quant/tensor.py``'s, as
    ``jax.jit`` compiles it): ``(q int8, scale [rows, 1] f32)``."""
    q = quantize_per_row(x32)
    return q.values, q.scales


def _blocks(pc: PackedChain, g0: int, KB: int, NB: int) -> torch.Tensor:
    """Packed blocks ``g0 .. g0 + NB*KB`` as the ``[KB*bk, NB*bn]``
    matrix they hold."""
    bk, bn = pc.bk, pc.bn
    return pc.w[g0:g0 + NB * KB].reshape(NB, KB, bk, bn).permute(
        1, 2, 0, 3).reshape(KB * bk, NB * bn)


def _product(pc: PackedChain, g0: int, KB: int, NB: int, sb0: int,
             src: torch.Tensor, src_scale: Optional[torch.Tensor] = None,
             act: Optional[str] = None, out_dtype=torch.float32):
    """``act(src @ W + b)`` over the packed blocks of one op run, all
    ``NB*bn`` columns: s32 sums then ``(acc * x_scale) * w_scale + b``
    under w8a8 (``src`` int8 with row scales ``src_scale``), else f32
    sums of ``src`` times the blocks cast to ``src``'s dtype, then
    ``acc * w_scale + b`` (quantized) or ``acc + b`` (dense)."""
    W = _blocks(pc, g0, KB, NB)[:src.shape[-1]]
    c0, c1 = sb0 * pc.bn, (sb0 + NB) * pc.bn
    scale, bias = pc.sb[0, c0:c1], pc.sb[1, c0:c1]
    if src_scale is not None:
        y = exact_int_matmul(src, W).float() * src_scale
        return epilogue(y, bias, act, out_dtype, scale)
    y = torch.matmul(src.float(), W.to(src.dtype).float())
    return epilogue(y, bias, act, out_dtype,
                    scale if pc.quantized else None)


def _norm_row(x32: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              kind: str, eps: float) -> torch.Tensor:
    """The chain's norm over ``[B, D]`` f32 rows, in the JAX kernel's
    order (``x * rsqrt(..) * scale (+ bias)``)."""
    D = x32.shape[-1]
    if kind == "rmsnorm":
        ms = x32.square().sum(-1, keepdim=True) / D
        return x32 * torch.rsqrt(ms + eps) * scale
    mean = x32.sum(-1, keepdim=True) / D
    cent = x32 - mean
    var = cent.square().sum(-1, keepdim=True) / D
    return cent * torch.rsqrt(var + eps) * scale + bias


def chain_decode_plain(pc: PackedChain, attn_in: torch.Tensor,
                       x: torch.Tensor
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of :func:`chain_decode` (same signature): the chain's
    ops in order over the packed blocks, rounding where the JAX kernel
    rounds (``h`` and the activation to ``x``'s dtype, or re-quantized
    per row under w8a8; the residual in f32 until ``x_out``)."""
    dt = x.dtype
    D, I = pc.D, pc.I

    def op(op_id, src, src_scale):
        g0, KB, NB, _, N, sb0 = _op_run(pc, (op_id,))
        return _product(pc, g0, KB, NB, sb0, src, src_scale)[:, :N]

    def source(v32):                 # an op's input, as the chain keeps it
        return _quant_rows(v32) if pc.w8a8 else (v32.to(dt), None)

    ln = pc.ln[:, :D]
    xres = x.float()
    ain = attn_in.to(dt)
    xres = xres + op(OP_O, *(source(ain.float()) if pc.w8a8
                             else (ain, None)))
    h = source(_norm_row(xres, ln[0], ln[1], pc.norm_kind, pc.eps))
    up = op(OP_U, *h)
    if pc.act_kind == "swiglu":
        g = op(OP_G, *h)
        v = (g * torch.sigmoid(g)) * up
    else:
        v = activation_fn(pc.act_kind)(up)
    xres = xres + op(OP_D, *source(v))
    x_out = xres.to(dt)
    if not pc.has_tail:
        return x_out, None
    h = source(_norm_row(xres, ln[2], ln[3], pc.norm_kind, pc.eps))
    return x_out, op(OP_T, *h).to(dt)


def _op_run(pc: PackedChain, op_ids: Tuple[int, ...]):
    """``(g0, KB, NB, K, N, sb0)`` of a contiguous run of equal-K ops."""
    geoms = [g for g in pc.ops_geom if g[0] in op_ids]
    if len(geoms) != len(op_ids):
        raise ValueError(f"ops {op_ids} not all in {pc.ops_geom}")
    for a, b in zip(geoms, geoms[1:]):
        if not (a[1] + a[3] * a[2] == b[1] and a[4] == b[4]
                and a[5] % pc.bn == 0):
            raise ValueError(f"ops {a} and {b} are not one column run")
    g0, KB, K, sb0 = geoms[0][1], geoms[0][2], geoms[0][4], geoms[0][6]
    return (g0, KB, sum(g[3] for g in geoms), K, sum(g[5] for g in geoms),
            sb0)


def packed_linear_plain(pc: PackedChain, op_ids: Tuple[int, ...],
                        x: torch.Tensor, *,
                        act: Optional[str] = None) -> torch.Tensor:
    """Plain version of :func:`packed_linear` (same signature)."""
    g0, KB, NB, K, N, sb0 = _op_run(pc, op_ids)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K)
    xq, xs = _quant_rows(x2.float()) if pc.w8a8 else (x2, None)
    y = _product(pc, g0, KB, NB, sb0, xq, xs, act, x.dtype)
    return y[:, :N].reshape(*lead, N)


# -- the kernels ------------------------------------------------------------

def _same_device(*ts) -> torch.device:
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError("all operands must share one device")
    return dev


def _check_types(pc: PackedChain, x: torch.Tensor) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"activations must be f32 or bf16, got {x.dtype}")
    if pc.w.dtype not in _W_CODES:
        raise ValueError(f"packed weights of {pc.w.dtype} not supported")
    if pc.w.dtype == torch.float32 and x.dtype != torch.float32:
        raise ValueError("f32 blocks take f32 activations (the JAX kernel "
                         "would round them to the activations' dtype)")
    if pc.w8a8 and pc.w.dtype != torch.int8:
        raise ValueError("w8a8 chains hold int8 blocks")
    if pc.bk % _K_STEP or pc.bn % _TILE_N:
        raise ValueError(f"blocks ({pc.bk}, {pc.bn}) must be multiples "
                         "of 128")


def _split_rows(bk: int, work: int) -> int:
    """Rows of K per B14 task, a multiple of 128 that divides bk, at most
    ``_MAX_S``: the largest that still gives ``_TASKS`` tasks, with
    ``work`` tasks per split of bk rows (else the smallest)."""
    fits = [s for s in range(_K_STEP, min(bk, _MAX_S) + 1, _K_STEP)
            if bk % s == 0]
    enough = [s for s in fits if work * (bk // s) >= _TASKS]
    return max(enough) if enough else fits[0]


#: the barrier word and the split-K tile counters of B14 by (device,
#: stream): launches on one stream run in order, and every launch leaves
#: them as it found them
_SYNC = {}


def _sync_words(device, need: int) -> torch.Tensor:
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    sync = _SYNC.get(key)
    if sync is None or sync.numel() < need:
        sync = _SYNC[key] = torch.zeros(max(need, 4096), dtype=torch.int32,
                                        device=device)
    return sync


@functools.lru_cache(maxsize=64)
def chain_plan(ops_geom: tuple, bk: int, bn: int, D: int, I: int, K0: int,
               w8a8: bool, B: int):
    """B14's launch plan for a chain of this geometry and a batch of ``B``
    rows (computed once per geometry): the host table the C entry point
    reads (the op count; per op its id, g0, KB, NB, K, N, sb_base and
    rows per task; the byte offsets of the workspace regions: residual,
    attention input, h, gate, up, activation, row scales, split-K
    partials), the workspace's size, and the sync words it needs (the
    barrier and one counter per column tile and row group of each op)."""
    lcm = math.lcm(bk, bn)
    Bp = round_up(B, _ROWS)
    Wd, Wi = round_up(D, lcm), round_up(I, lcm)
    K0p = round_up(K0, bk)
    a8 = 1 if w8a8 else 4              # bytes of a matmul source value
    ops, counters, partials = [], 1, {}
    phase_of = {OP_O: 0, OP_G: 1, OP_U: 1, OP_D: 2, OP_T: 3}
    for op_id, g0, KB, NB, K, N, sb0 in ops_geom:
        tiles, rgroups = NB * bn // _TILE_N, Bp // _ROWS
        S = _split_rows(bk, tiles * rgroups * KB)
        splits = KB * bk // S
        ops.append([op_id, g0, KB, NB, K, N, sb0, S])
        counters += tiles * rgroups
        if splits > 1:
            ph = phase_of[op_id]
            partials[ph] = partials.get(ph, 0) + splits * Bp * NB * bn
    sizes = [4 * Bp * Wd, a8 * Bp * K0p, a8 * Bp * Wd, 4 * Bp * Wi,
             4 * Bp * Wi, a8 * Bp * Wi, 4 * 3 * Bp,
             4 * max(partials.values(), default=0)]
    offsets, total = [], 0
    for s in sizes:
        offsets.append(total)
        total += round_up(max(s, 1), _ALIGN)
    table = torch.tensor([len(ops)] + [v for op in ops for v in op]
                         + offsets, dtype=torch.int32)
    return table, total, counters


def chain_decode(pc: PackedChain, attn_in: torch.Tensor, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """B14: run one packed decode chain.

    ``attn_in`` — ``[B, K0]`` attention output (pre-o-projection);
    ``x``       — ``[B, D]`` residual stream entering the chain (bf16 or
    f32; the chain's activation dtype). Returns ``(x_new [B, D],
    tail [B, N3] | None)``; ``tail`` is the next layer's qkv projection
    (after the norm after down) when the chain has one."""
    if x.dim() != 2 or x.shape[1] != pc.D:
        raise ValueError(f"x must be [B, {pc.D}], got {tuple(x.shape)}")
    B = x.shape[0]
    if tuple(attn_in.shape) != (B, pc.K0):
        raise ValueError(f"attn_in must be [{B}, {pc.K0}], got "
                         f"{tuple(attn_in.shape)}")
    _same_device(x, attn_in, pc.w, pc.sb, pc.ln)
    if not x.is_cuda:
        return chain_decode_plain(pc, attn_in, x)
    _check_types(pc, x)
    want = [OP_O] + ([OP_G] if pc.act_kind == "swiglu" else []) + \
        [OP_U, OP_D] + ([OP_T] if pc.has_tail else [])
    if [g[0] for g in pc.ops_geom] != want:
        raise ValueError(f"chain ops {pc.ops_geom} are not {want}")
    table, total, counters = chain_plan(pc.ops_geom, pc.bk, pc.bn, pc.D,
                                        pc.I, pc.K0, pc.w8a8, B)
    x = x.contiguous()
    ain = attn_in.to(x.dtype).contiguous()
    work = torch.empty(total, dtype=torch.uint8, device=x.device)
    sync = _sync_words(x.device, counters)
    x_out = torch.empty_like(x)
    tail = (torch.empty((B, pc.N3), dtype=x.dtype, device=x.device)
            if pc.has_tail else None)
    CHAIN_DECODE.launch(
        ptr(ain), ptr(x), ptr(pc.w), ptr(pc.sb), ptr(pc.ln), ptr(x_out),
        ptr(tail), ptr(work), ptr(sync), ptr(table), total,
        B, pc.D, pc.I, pc.K0, pc.N3, pc.bk, pc.bn, _W_CODES[pc.w.dtype],
        pc.eps, DTYPE_CODES[x.dtype], int(pc.w8a8),
        _ACT_KINDS[pc.act_kind], _NORM_KINDS[pc.norm_kind],
        stream_handle(x))
    return x_out, tail


def _wgmma_rows(xq: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Quantized rows ``[M, K]`` as the tensor-core kernel reads them: K
    zero-padded to a multiple of 16 (the packed blocks hold at least
    that many rows, bk being a multiple of 128), 16-byte aligned.
    Returns ``(rows, padded K)``."""
    dk = -xq.shape[1] % 16
    if dk:
        xq = torch.nn.functional.pad(xq, (0, dk))
    return aligned16(xq), xq.shape[1]


def packed_linear(pc: PackedChain, op_ids: Tuple[int, ...],
                  x: torch.Tensor, *,
                  act: Optional[str] = None) -> torch.Tensor:
    """B15: ``act(x @ W_op + bias_op)`` served out of the packed chain
    blocks, the multi-token (prefill / verify) twin of
    :func:`chain_decode`. ``op_ids`` may name a contiguous run of
    equal-``K`` ops (the SwiGLU ``(OP_G, OP_U)`` pair), which computes
    their column concat. ``x``: ``[..., K]`` bf16/f32; returns
    ``[..., sum N]`` in ``x``'s dtype. Under w8a8 ``x`` is quantized per
    row first, outside the kernel, as the JAX wrapper does."""
    g0, KB, NB, K, N, sb0 = _op_run(pc, tuple(op_ids))
    if x.shape[-1] != K:
        raise ValueError(f"x must be [..., {K}], got {tuple(x.shape)}")
    _same_device(x, pc.w, pc.sb)
    if not x.is_cuda:
        return packed_linear_plain(pc, op_ids, x, act=act)
    _check_types(pc, x)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    xs = part = counters = None
    splits, kps = 1, K
    if pc.w8a8:
        x2, xs = _quant_rows(x2)
        xs = xs.reshape(M).contiguous()
        x2, K = _wgmma_rows(x2)
        splits, kps = wgmma_plan(M, K, N)
        part, counters = wgmma_scratch(x.device, M, N, splits)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    c0 = sb0 * pc.bn
    PACKED_LINEAR.launch(
        ptr(x2), ptr(xs), ptr(pc.w), ptr(pc.sb[0, c0:]),
        ptr(pc.sb[1, c0:]), ptr(out), ptr(part), ptr(counters), M, K, N,
        g0, KB, pc.w.shape[0], pc.bk, pc.bn, splits, kps,
        _W_CODES[pc.w.dtype], int(pc.w8a8), act_code(act),
        DTYPE_CODES[x.dtype], stream_handle(x))
    return out.reshape(*lead, N)
