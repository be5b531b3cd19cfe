#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card (the kernels
build there with ``nvcc`` for ``sm_90a``). It imports the port
(``pagedattention_based_transformer_decoder_inference_framework_tpu_torch``)
and nothing of JAX. Phases:

1. Card and build: the card's name and power limit, then every kernel
   built from ``csrc/`` (one ``nvcc`` per source, in parallel), timed.
2. Each kernel against its plain PyTorch version on the card.
   Attention (B1/B2) and appends (B3/B4) at slice 1's shapes (B=4, KH=8,
   G=4, dh=128, page 64, INT8 pool; prefill T=64, decode seq lens
   65-128) plus edge cases. The quantized-weight products (B10
   ``int8_matmul``, B11 ``w8_matmul``, B12 ``w4_matmul``) at every
   Llama-3-8B projection's shape (qkv, wo, gate-up, down) at decode M=4
   and prefill M=256, at the LM head (N=128256, INT4 block width 768),
   and at edge shapes (M 1 and 17, K and N that fit no tile, bias and
   activation, f32 output). Prints the max difference and its tolerance,
   the kernel's and the plain version's device time, the bound, and a
   library yardstick the port never calls (``scaled_dot_product_attention``
   over a dense gathered copy; ``torch._int_mm``; a bf16 cuBLAS product
   over a pre-widened weight; ``torch._weight_int4pack_mm`` over the same
   INT4 values repacked with bf16 scales).
3. The paths, each ``Engine`` on llama3-8b at full width and full depth
   (32 layers, weights from a seed, INT8 paged KV, page 64, prefill chunk
   256, the pool ``bench.py`` sizes) running ``generate_batch_fused`` on 4
   random 64-token prompts for 64 greedy tokens, with every kernel's
   launch count reset just before and checked just after against the
   exact count the loop implies:
   a. bf16 weights (``quant="none"``, slice 1);
   b. w8a8 INT8 weights (``quant="int8"``, ``bench.py``'s default), the
      main path of slice 2: B10 in every projection, B11 in the LM head;
   c. weight-only INT8 (``quant="int8-weight"``): B11 everywhere;
   d. INT4 (``quant="int4"``): B12 everywhere.
   On every path the same prompts are then teacher-forced through the
   kernels, the plain versions, an SDPA reference (SDPA attention and,
   for quantized weights, products computed another way: B10's and
   B11's library products above, B12 one product per K-group) and a
   lower-precision control (the last three are references this script
   defines; the port has no such option): the kernels and the reference
   must stay within the path's logit limit, the control must not; (a)
   also with f32 weights and activations. For (a) and (b) the fused loop
   at B=4 is held against the step path's tokens and against the plain
   fused loop, and ``generate_stream`` against the fused loop on a lone
   prompt, and one fused run is profiled; (b) also holds
   ``Engine.score_nll`` against the plain path.
4. A ``{"paths": ...}`` summary line, a ``{"kernels": [...]}`` line, the
   card's line, then ``{"ok": true, "device": {...}}`` as the last line.

Exits non-zero with no ok line if any phase fails, if there is no CUDA
card, or if the port's package is not beside this script.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

PKG = "pagedattention_based_transformer_decoder_inference_framework_tpu_torch"
#: the JAX package's directory, where the TPU kernels the port replaces live
TPU_PKG = "pagedattention_based_transformer_decoder_inference_framework_tpu"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
#: peak rate by the type of a kernel's inputs (H100 SXM data sheet,
#: dense): bf16 products of bf16 q and int8/bf16 K/V (or weights) are
#: exact in the tensor cores' f32 accumulation, so the least time is at
#: the bf16 rate; s8 x s8 at the int8 rate; f32 inputs use the rate
#: outside the tensor cores
PEAK_FLOPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
SEED = 0
#: teacher-forced logit limits, as a fraction of max|logit|, by weights
#: and activation dtype: set from the readings of the sdpa reference
#: (which must pass) and of the lower-precision control (which must
#: fail); see PERF.md
TOL = {("none", "bf16"): 0.10, ("none", "f32"): 0.012,
       ("int8", "bf16"): 0.25, ("int8-weight", "bf16"): 0.10,
       ("int4", "bf16"): 0.10}
LOWP_NAME = {"bf16": "fp8-q", "f32": "bf16-attention"}
#: ``score_nll`` of the kernels against the plain path, relative
TOL_SCORE = 1e-2


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


#: failed logit-limit checks; phase 3 runs every path and its readings,
#: then fails with all of them
LIMIT_FAILURES: list = []


def check_limit(cond: bool, msg: str) -> None:
    if not cond:
        print(f"  LIMIT FAILED: {msg}", flush=True)
        LIMIT_FAILURES.append(msg)


def cuda_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Wall time per call on the card's clock (CUDA events around
    ``iters`` back-to-back calls): includes the host's issue cost
    whenever that exceeds the device work."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, match=("",)) -> float:
    """Device time per call from torch.profiler (CUPTI): the summed time
    of the GPU kernels whose name contains one of ``match`` (all kernels
    if empty), over ``iters`` calls. CUPTI now and then hands back a
    trace without the kernels' records; such a trace is taken again, up
    to three times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(
            getattr(e, "self_device_time_total", 0.0)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and any(m in e.key for m in match))
        if total_us > 0:
            return total_us / iters / 1e3
        print(f"  (trace {attempt + 1} held no device time for "
              f"{match[0] or 'the plain version'}; tracing again)",
              flush=True)
    raise PhaseError(f"profiler saw no device time for {match or fn}")


def bound(bytes_moved: float, flops: float, rate: str = "f32"):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[rate] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# -- phase 2: kernels against their plain versions -------------------------

B, KH, G, DH, PAGE, L, NUM_PAGES, MP = 4, 8, 4, 128, 64, 2, 80, 5
H = KH * G
#: each wrapper's CUDA kernels, as the profiler names them
KERNEL_NAMES = {
    "paged_attention": ("paged_attention_kernel<",),
    "paged_attention_decode": ("paged_attention_decode_kernel<",),
    "kv_append_decode": ("append_decode_kernel",),
    "kv_append_prefill": ("append_prefill_kernel",),
    "int8_matmul": ("qmm::gemv_kernel<0,", "qmm::tiled_kernel<0,"),
    "w8_matmul": ("qmm::gemv_kernel<1,", "qmm::tiled_kernel<1,"),
    "w4_matmul": ("qmm::gemv_kernel<2,", "qmm::tiled_kernel<2,")}


def make_pool(torch, gen, dtype, dev):
    """A random pool [L, 2, KH, P, page, dh] (+ flat INT8 scales) and a
    block table of distinct non-dump pages."""
    shape = (L, 2, KH, NUM_PAGES, PAGE, DH)
    if dtype == torch.int8:
        vals = torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)
        R = NUM_PAGES * PAGE // 128
        scales = (torch.rand((L, 2, KH, R, 128), generator=gen, device=dev)
                  * 0.02 + 0.005)
        kv = (vals, scales)
    else:
        kv = (torch.randn(shape, generator=gen, device=dev).to(dtype),)
    perm = torch.randperm(NUM_PAGES - 1, generator=gen, device=dev) + 1
    bt = perm[:B * MP].reshape(B, MP).to(torch.int32)
    return kv, bt


def dense_kv(torch, kv, bt, layer, seq_len_max):
    """Dequantized [B, KH, S, dh] K and V gathered through the table."""
    vals = kv[0][layer].float()
    if len(kv) == 2:
        sc = kv[1][layer].reshape(2, KH, NUM_PAGES, PAGE, 1)
        vals = vals * sc
    g = vals[:, :, bt.long()].reshape(2, KH, B, MP * PAGE, DH)
    g = g[:, :, :, :seq_len_max].permute(0, 2, 1, 3, 4)
    return g[0], g[1]


def attention_checks(torch, F_, dev, results):
    from importlib import import_module

    pa = import_module(f"{PKG}.ops.paged_attention")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    rows = {}
    worst = {"paged_attention": 0.0, "paged_attention_decode": 0.0}
    cases = [
        # name, kernel, q dtype, pool dtype, T, seq_lens, q_offsets, window,
        # softcap, tolerance
        ("prefill slice", "paged_attention", torch.bfloat16, torch.int8, 64,
         [64] * 4, [0] * 4, 0, 0.0, 2e-2),
        ("prefill ragged", "paged_attention", torch.bfloat16, torch.int8,
         64, [64, 57, 1, 40], [0] * 4, 0, 0.0, 2e-2),
        ("prefill 2nd chunk", "paged_attention", torch.bfloat16, torch.int8,
         64, [128, 100, 65, 128], [64] * 4, 0, 0.0, 2e-2),
        ("prefill window+softcap f32", "paged_attention", torch.float32,
         torch.int8, 64, [128, 100, 65, 128], [64] * 4, 48, 30.0, 1e-4),
        ("prefill bf16 pool f32", "paged_attention", torch.float32,
         torch.bfloat16, 64, [64, 57, 1, 40], [0] * 4, 0, 0.0, 1e-4),
        ("decode slice", "paged_attention_decode", torch.bfloat16,
         torch.int8, 1, [65, 90, 128, 101], None, 0, 0.0, 2e-2),
        ("decode f32", "paged_attention_decode", torch.float32, torch.int8,
         1, [65, 90, 128, 101], None, 0, 0.0, 1e-4),
        ("decode window+softcap f32", "paged_attention_decode",
         torch.float32, torch.int8, 1, [65, 90, 128, 300], None, 40, 30.0,
         1e-4),
        ("decode f32 pool", "paged_attention_decode", torch.float32,
         torch.float32, 1, [1, 64, 200, 320], None, 0, 0.0, 1e-4),
    ]
    layer = 1
    for (name, kname, qdt, pdt, T, lens, qo, window, softcap, tol) in cases:
        kv, bt = make_pool(torch, gen, pdt, dev)
        scales = kv[1] if len(kv) == 2 else None
        q = torch.randn((B, T, H, DH), generator=gen, device=dev).to(qdt)
        sl = torch.tensor(lens, dtype=torch.int32, device=dev)
        common = dict(page_size=PAGE, num_q_heads=H, window=window,
                      softcap=softcap, scale=DH ** -0.5)
        if kname == "paged_attention":
            qoff = torch.tensor(qo, dtype=torch.int32, device=dev)
            args = (q, kv[0], bt, sl, qoff, scales, layer)
            kern, plain = pa.paged_attention, pa.paged_attention_plain
        else:
            args = (q, kv[0], bt, sl, scales, layer)
            kern = pa.paged_attention_decode
            plain = pa.paged_attention_decode_plain
        out_k = kern(*args, **common)
        out_p = plain(*args, **common)
        torch.cuda.synchronize()
        err = (out_k.float() - out_p.float()).abs().max().item()
        ok = err <= tol and bool(torch.isfinite(out_k).all())
        print(f"  [{kname}] {name}: max|kernel-plain| = {err:.3e} "
              f"(tol {tol:g}) {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"{kname} {name}: error {err} > {tol}")
        if qdt == torch.bfloat16:
            worst[kname] = max(worst[kname], err)
        if name.endswith("slice"):
            rows[kname] = (args, common, kern, plain, kv, bt, q, lens, qo,
                           T, sl)
    for kname, row in rows.items():
        args, common, kern, plain, kv, bt, q, lens, qo, T, sl = row
        ms = device_ms(lambda: kern(*args, **common),
                       match=KERNEL_NAMES[kname])
        call_ms = cuda_ms(lambda: kern(*args, **common))
        plain_ms = device_ms(lambda: plain(*args, **common))
        # bytes: q in + out, every K/V page and scale the rows can see,
        # the table and lengths; flops: QK and PV over visible pairs
        pairs = 0
        pages = 0
        for b in range(B):
            if qo is None:                          # decode
                pairs += lens[b]
            else:
                for t in range(T):
                    pairs += max(0, min(qo[b] + t + 1, lens[b]))
            pages += -(-lens[b] // PAGE)
        pairs *= KH * G
        kv_bytes = pages * KH * 2 * PAGE * (DH * kv[0].element_size() + 4)
        bytes_moved = 2 * q.numel() * q.element_size() + kv_bytes + 4 * (
            bt.numel() + 2 * B)
        b_ms, b_by = bound(bytes_moved, 4 * DH * pairs,
                           "bf16" if q.dtype == torch.bfloat16 else "f32")
        # library yardstick: SDPA over a dense, dequantized, gathered copy
        smax = max(lens)
        k_d, v_d = dense_kv(torch, kv, bt, args[-1], smax)
        qh = q.transpose(1, 2)
        kd = k_d.to(q.dtype).repeat_interleave(G, dim=1)
        vd = v_d.to(q.dtype).repeat_interleave(G, dim=1)
        key = torch.arange(smax, device=dev)
        if qo is None:
            mask = (key < sl[:, None, None, None].long())
        else:
            qpos = torch.tensor(qo, device=dev)[:, None] + torch.arange(
                T, device=dev)
            mask = ((key[None, None] <= qpos[:, :, None])
                    & (key < sl[:, None, None].long()))[:, None]
        lib_ms = device_ms(lambda: F_.scaled_dot_product_attention(
            qh, kd, vd, attn_mask=mask, scale=DH ** -0.5))
        results[kname].update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                              bound_by=b_by, library_ms=lib_ms,
                              max_abs_err=worst[kname], tol=2e-2)
        print(f"  [{kname}] slice shape, device time: kernel {ms:.4f} ms "
              f"(one wrapper call {call_ms:.4f} ms wall), plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), sdpa "
              f"{lib_ms:.4f} ms", flush=True)


def append_checks(torch, dev, results):
    from importlib import import_module

    ka = import_module(f"{PKG}.ops.kv_append")
    pool_mod = import_module(f"{PKG}.kvcache.pool")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    layer = 1
    cases = [
        # name, kernel, pool dtype, chunk start (None: decode), seq lens
        ("prefill slice", "kv_append_prefill", torch.int8, 0, [64] * 4),
        ("prefill ragged", "kv_append_prefill", torch.int8, 0,
         [64, 57, 1, 40]),
        ("prefill 2nd chunk", "kv_append_prefill", torch.int8, 64,
         [128, 100, 65, 128]),
        ("prefill bf16 pool", "kv_append_prefill", torch.bfloat16, 0,
         [64, 57, 1, 40]),
        ("decode slice", "kv_append_decode", torch.int8, None,
         [65, 90, 128, 101]),
        ("decode invalid lane", "kv_append_decode", torch.int8, None,
         [65, 0, 128, 101]),
        ("decode f32 pool", "kv_append_decode", torch.float32, None,
         [1, 64, 200, 320]),
    ]
    slice_rows = {}
    for name, kname, pdt, c0, lens in cases:
        kv, bt = make_pool(torch, gen, pdt, dev)
        kv = tuple(x.zero_() for x in kv)
        T = 1 if c0 is None else PAGE
        k = torch.randn((B, T, KH, DH), generator=gen, device=dev)
        v = torch.randn((B, T, KH, DH), generator=gen, device=dev)
        if c0 is None:                  # the new token sits at len - 1
            pos = torch.tensor([[n - 1] for n in lens], dtype=torch.int32,
                               device=dev)
        else:                           # prompt padding is -1
            ar = c0 + torch.arange(T, device=dev)[None]
            lim = torch.tensor(lens, device=dev)[:, None]
            pos = torch.where(ar < lim, ar, -1).to(torch.int32)
        news = pool_mod.stack_new_kv(kv, k, v)
        kern = ka.append_decode if T == 1 else ka.append_prefill
        plain = ka.append_decode_plain if T == 1 else ka.append_prefill_plain
        kv_k = tuple(x.clone() for x in kv)
        kv_p = tuple(x.clone() for x in kv)
        kern(kv_k, news, layer, pos, bt)
        plain(kv_p, news, layer, pos, bt)
        torch.cuda.synchronize()
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(kv_k, kv_p))
        ok = err == 0.0
        print(f"  [{kname}] {name}: max|kernel-plain| over the pool = "
              f"{err:.3e} (tol 0, bit-exact) {'ok' if ok else 'FAIL'}",
              flush=True)
        check(ok, f"{kname} {name}: pool differs by {err}")
        if name.endswith("slice"):
            slice_rows[kname] = (kern, plain, kv_k, news, pos, bt)
    for kname, (kern, plain, kv, news, pos, bt) in slice_rows.items():
        ms = device_ms(lambda: kern(kv, news, layer, pos, bt),
                       match=KERNEL_NAMES[kname])
        call_ms = cuda_ms(lambda: kern(kv, news, layer, pos, bt))
        plain_ms = device_ms(lambda: plain(kv, news, layer, pos, bt))
        n_valid = int((pos >= 0).sum().item())
        row = KH * 2 * (DH * kv[0].element_size() + 4)
        b_ms, b_by = bound(2 * n_valid * row + 4 * (pos.numel() + bt.numel()),
                           0)
        results[kname].update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                              bound_by=b_by, library_ms=None,
                              max_abs_err=0.0, tol=0.0)
        print(f"  [{kname}] slice shape, device time: kernel {ms:.4f} ms "
              f"(one wrapper call {call_ms:.4f} ms wall), plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})", flush=True)


#: Llama-3-8B's projections (name, K, N) as the engine fuses them, and
#: its LM head
PROJECTIONS = [("qkv", 4096, 6144), ("wo", 4096, 4096),
               ("gate-up", 4096, 28672), ("down", 14336, 4096)]
LM_HEAD = ("lm-head", 4096, 128256)
#: weight bytes the timing cycles through, so each call finds its weight
#: outside the 50 MB L2, as a decode step does
COLD_BYTES = 160e6


def within_bf16_step(out, ref) -> bool:
    """One bf16 step of ``ref``, or 1e-5 of max|ref| where cancellation
    leaves an output so small that f32 summation order moves it more."""
    import torch

    d = (out.float() - ref.float()).abs()
    r = ref.float().abs()
    step = torch.exp2(torch.floor(torch.log2(r.clamp_min(2.0 ** -126))) - 7)
    return bool((d <= torch.maximum(step, 1e-5 * r.max())).all())


def matmul_close(out, ref) -> bool:
    """B11/B12 against their plain versions (f32 sums in another order):
    1e-5 of max|ref|, and with bf16 out also one bf16 step of ``ref``."""
    import torch

    if out.dtype != ref.dtype or out.shape != ref.shape:
        return False
    if out.dtype == torch.bfloat16:
        return within_bf16_step(out, ref)
    return bool(((out - ref).abs() <= 1e-5 * ref.abs().max()).all())


def int8_matmul_library(xq, x_scale, wq, w_scale, bias=None, *, act=None,
                        out_dtype=None):
    """B10's function with ``torch._int_mm`` (cuBLASLt, which takes
    M >= 17) for the s32 product; a yardstick and a reference for this
    script only, never called by the port."""
    from importlib import import_module

    import torch

    i8 = import_module(f"{PKG}.ops.int8_matmul")
    M = xq.shape[0]
    if M < 17:
        xq = torch.cat([xq, xq.new_zeros((17 - M, xq.shape[1]))])
    acc = torch._int_mm(xq, wq)[:M]
    return i8.epilogue(acc.float() * x_scale.float().reshape(-1, 1), bias,
                       act, out_dtype or torch.bfloat16,
                       w_scale.reshape(1, -1))


def w8_matmul_library(x, wq, w_scale, bias=None, *, act=None,
                      out_dtype=None, widened=None):
    """B11's function as one cuBLAS product over a widened weight (bf16 x:
    a bf16 GEMM with an f32 output; f32 x: an f32 GEMM), then the
    epilogue; a yardstick and a reference for this script only."""
    from importlib import import_module

    import torch

    i8 = import_module(f"{PKG}.ops.int8_matmul")
    w = widened if widened is not None else wq.to(x.dtype)
    y = (torch.mm(x, w, out_dtype=torch.float32)
         if x.dtype == torch.bfloat16 else torch.mm(x, w))
    return i8.epilogue(y, bias, act, out_dtype or torch.bfloat16,
                       w_scale.reshape(1, -1))


def int4pack(q4):
    """The INT4 values of ``q4`` repacked for ``torch._weight_int4pack_mm``
    (tinygemm computes ``(u - 8) * scale + zero`` per group of K rows,
    ``u`` unsigned; the port's value is ``u - 8``), with its scales in
    bf16 and zero 0: the same weight up to the scales' bf16 rounding. For
    the library yardstick and reference only."""
    from importlib import import_module

    import torch

    qt = import_module(f"{PKG}.quant.tensor")
    u = (qt.unpack_int4(q4.packed, q4.bn).to(torch.int32) + 8).t()  # [N, K]
    u8 = ((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8).contiguous()
    packed = torch._convert_weight_to_int4pack(u8, 8)
    sz = torch.stack([q4.scales, torch.zeros_like(q4.scales)], dim=-1)
    return packed, sz.to(torch.bfloat16).contiguous(), q4.group


def w4_matmul_library(x, pack, bias=None, *, act=None, out_dtype=None):
    """B12's function as one ``torch._weight_int4pack_mm`` call (bf16 x)
    over :func:`int4pack`'s ``pack``, then the epilogue; a yardstick and a
    reference for this script only."""
    from importlib import import_module

    import torch

    i8 = import_module(f"{PKG}.ops.int8_matmul")
    check(x.dtype == torch.bfloat16, "the INT4 library product takes bf16 x")
    packed, sz, group = pack
    y = torch._weight_int4pack_mm(x, packed, group, sz)
    return i8.epilogue(y.float(), bias, act, out_dtype or torch.bfloat16)


def w4_matmul_grouped(x, packed, scales, bias=None, *, group, bn,
                      act=None, out_dtype=None):
    """B12's function computed another way, for the path's sound
    reference: one f32 product per K-group over the INT4 values (exact in
    f32), each group's product times its scales, summed over the groups;
    then the epilogue. (tinygemm's bf16 scales make it a lower precision
    than the function, so it serves as the yardstick only.)"""
    from importlib import import_module

    import torch

    i8 = import_module(f"{PKG}.ops.int8_matmul")
    qt = import_module(f"{PKG}.quant.tensor")
    M, K = x.shape
    G = K // group
    q = qt.unpack_int4(packed, bn).float().reshape(G, group, -1)
    xg = x.float().reshape(M, G, group).transpose(0, 1)
    y = (torch.bmm(xg, q) * scales[:, None, :]).sum(0)
    return i8.epilogue(y, bias, act, out_dtype or torch.bfloat16)


def cold_calls(fn_of, weights):
    """A zero-argument callable that calls ``fn_of(w)`` on the next of
    ``weights`` each time."""
    state = {"i": 0}

    def call():
        w = weights[state["i"] % len(weights)]
        state["i"] += 1
        return fn_of(w)
    return call


def matmul_checks(torch, dev, results):
    """B10/B11/B12 against their plain versions at Llama-3-8B's shapes and
    at edge shapes; device times at decode (M=4) and at prefill (M=256),
    each call (the library yardsticks' too) on a weight outside L2."""
    from importlib import import_module

    i8 = import_module(f"{PKG}.ops.int8_matmul")
    i4 = import_module(f"{PKG}.ops.int4_matmul")
    qt = import_module(f"{PKG}.quant.tensor")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    bf16 = torch.bfloat16
    worst = {"int8_matmul": 0.0, "w8_matmul": 0.0, "w4_matmul": 0.0}

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def verify(kname, label, out, ref):
        if kname == "int8_matmul":
            ok = torch.equal(out, ref)
            tol = "0, bit-exact"
        else:
            ok = matmul_close(out, ref)
            tol = ("one bf16 step or 1e-5 of max|out|"
                   if out.dtype == bf16 else "1e-5 of max|out|")
        err = (out.float() - ref.float()).abs().max().item()
        ok = ok and bool(torch.isfinite(out).all())
        print(f"  [{kname}] {label}: max|kernel-plain| = {err:.3e} "
              f"(tol {tol}) {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"{kname} {label}: kernel differs from plain ({err})")
        worst[kname] = max(worst[kname], err)

    rows = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "library_ms": 0.0, "by": set()}
            for k in ("int8_matmul", "w4_matmul")}
    for name, K, N in PROJECTIONS + [LM_HEAD]:
        head = name == "lm-head"
        w = randn(K, N, scale=0.02)
        wq, w4 = qt.quantize_per_channel(w), qt.quantize_int4_groupwise(w)
        del w
        copies = max(1, int(np.ceil(COLD_BYTES / wq.values.numel())))
        wqs = [wq] + [qt.QTensor(wq.values.clone(), wq.scales.clone())
                      for _ in range(copies - 1)]
        w4s = [w4] + [qt.Q4Tensor(w4.packed.clone(), w4.scales.clone(),
                                  w4.group, w4.bn)
                      for _ in range(2 * copies - 1)]
        # the library yardsticks' forms of the same weights: B11's widened
        # to bf16, B12's repacked for tinygemm
        libs = {"int8_matmul": (lambda q: int8_matmul_library(
                    xq.values, xq.scales, q.values, q.scales), wqs),
                "w8_matmul": (lambda wb: w8_matmul_library(
                    x, wq.values, wq.scales, widened=wb),
                    [q.values.to(bf16) for q in wqs]),
                "w4_matmul": (lambda p: w4_matmul_library(x, p),
                              [int4pack(q) for q in w4s])}
        for M in (4, 256):
            x = randn(M, K).to(bf16)
            xq = qt.quantize_per_row(x)
            b10 = lambda q, f=i8.int8_matmul: f(
                xq.values, xq.scales, q.values, q.scales)
            b11 = lambda q, f=i8.w8_matmul: f(x, q.values, q.scales)
            b12 = lambda q, f=i4.w4_matmul: f(
                x, q.packed, q.scales, group=q.group, bn=q.bn)
            cases = [("w8_matmul", b11, wqs, i8.w8_matmul_plain),
                     ("w4_matmul", b12, w4s, i4.w4_matmul_plain)]
            if not head:          # the w8a8 LM head is B11 (weight-only)
                cases.insert(0, ("int8_matmul", b10, wqs,
                                 i8.int8_matmul_plain))
            for kname, fn_of, ws, plain in cases:
                label = f"{name} M={M} (K={K}, N={N}" + (
                    f", bn={w4.bn})" if kname == "w4_matmul" else ")")
                out = fn_of(ws[0])
                ref = {"int8_matmul": lambda: plain(
                    xq.values, xq.scales, wq.values, wq.scales),
                    "w8_matmul": lambda: plain(x, wq.values, wq.scales),
                    "w4_matmul": lambda: plain(
                        x, w4.packed, w4.scales, group=w4.group,
                        bn=w4.bn)}[kname]
                torch.cuda.synchronize()
                expect = ref()
                verify(kname, label, out, expect)
                # device times; decode with a cold weight per call
                ms = device_ms(cold_calls(fn_of, ws),
                               match=KERNEL_NAMES[kname])
                plain_ms = device_ms(ref, iters=5)
                w_bytes = (w4.packed.numel() + 4 * w4.scales.numel()
                           if kname == "w4_matmul"
                           else wq.values.numel() + 4 * N)
                x_bytes = (M * K + 4 * M if kname == "int8_matmul"
                           else 2 * M * K)
                b_ms, b_by = bound(x_bytes + w_bytes + 2 * M * N,
                                   2 * M * K * N,
                                   "int8" if kname == "int8_matmul"
                                   else "bf16")
                # the yardstick computes the same function (B12's with
                # bf16-rounded scales): a loose check that it does
                lib_of, lib_ws = libs[kname]
                lib_err = (lib_of(lib_ws[0]).float()
                           - expect.float()).abs().max().item()
                lib_tol = 1e-2 * expect.float().abs().max().item()
                check(lib_err <= lib_tol, f"{kname} {label}: the library "
                      f"yardstick differs from plain by {lib_err}")
                lib_ms = device_ms(cold_calls(lib_of, lib_ws), iters=5)
                print(f"  [{kname}] {label} device time: kernel {ms:.4f} ms"
                      f", plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms "
                      f"({b_by}, {b_ms / ms:.2f} of it reached), library "
                      f"{lib_ms:.4f} ms (its max|library-plain| "
                      f"{lib_err:.3e}, tol {lib_tol:.3e})", flush=True)
                if M != 4:
                    continue
                if kname == "w8_matmul" and head:
                    results[kname].update(ms=ms, plain_ms=plain_ms,
                                          bound_ms=b_ms, bound_by=b_by,
                                          library_ms=lib_ms)
                elif kname != "w8_matmul" and not head:
                    r = rows[kname]
                    r["ms"] += ms
                    r["plain_ms"] += plain_ms
                    r["bound_ms"] += b_ms
                    r["library_ms"] += lib_ms
                    r["by"].add(b_by)
        del wqs, w4s, libs
        torch.cuda.empty_cache()
    for kname, r in rows.items():
        results[kname].update(ms=r["ms"], plain_ms=r["plain_ms"],
                              bound_ms=r["bound_ms"],
                              bound_by="/".join(sorted(r["by"])),
                              library_ms=r["library_ms"])

    # edge shapes: M 1 and 17, K and N that fit no tile, bias and an
    # activation, f32 activations and outputs
    for M, K, N, act, xdt, odt in [
            (1, 1000, 1000, "gelu", torch.float32, torch.float32),
            (17, 4096, 6144, "silu", bf16, bf16),
            (17, 300, 200, "relu", torch.float32, bf16),
            (1, 4096, 1000, None, bf16, torch.float32),
            (5, 70, 36, "gelu", bf16, bf16)]:
        w, bias = randn(K, N, scale=0.02), randn(N)
        x = randn(M, K).to(xdt)
        wq, xq = qt.quantize_per_channel(w), qt.quantize_per_row(x)
        label = (f"edge M={M} K={K} N={N} act={act} x {str(xdt)[6:]} "
                 f"out {str(odt)[6:]} bias")
        kw = dict(act=act, out_dtype=odt)
        a10 = (xq.values, xq.scales, wq.values, wq.scales, bias)
        verify("int8_matmul", label, i8.int8_matmul(*a10, **kw),
               i8.int8_matmul_plain(*a10, **kw))
        a11 = (x, wq.values, wq.scales, bias)
        verify("w8_matmul", label, i8.w8_matmul(*a11, **kw),
               i8.w8_matmul_plain(*a11, **kw))
        q4 = qt.quantize_int4_groupwise(w, group=64 if K % 64 == 0 else K)
        k4 = dict(kw, group=q4.group, bn=q4.bn)
        verify("w4_matmul", label + f" group={q4.group} bn={q4.bn}",
               i4.w4_matmul(x, q4.packed, q4.scales, bias, **k4),
               i4.w4_matmul_plain(x, q4.packed, q4.scales, bias, **k4))
    for kname, err in worst.items():
        results[kname].update(max_abs_err=err,
                              tol=0.0 if kname == "int8_matmul"
                              else "one bf16 step or 1e-5 of max|out|")


# -- phase 3: the paths ------------------------------------------------------

#: phase 3's paths: (name, quant), each Llama-3-8B at full width and depth
PATHS = [("bf16", "none"), ("w8a8", "int8"), ("int8-weight", "int8-weight"),
         ("int4", "int4")]
#: the path each kernel's launch count in the kernels line comes from:
#: slice 2's main path (w8a8), and for B12 the INT4 path
LAUNCHES_FROM = {"w4_matmul": "int4"}


def path_config(quant="none", dtype="bfloat16"):
    from importlib import import_module

    cfgmod = import_module(f"{PKG}.config")
    batch, steps, prompt_len, page = 4, 64, 64, 64
    cfg = cfgmod.FrameworkConfig()
    cfg.model = cfgmod.preset("llama3-8b")
    cfg.model.quant = quant
    cfg.model.dtype = dtype
    total_len = prompt_len + steps + 1
    cdiv = lambda a, b: -(-a // b)
    # the pool bench.py sizes (bench.py:290-304)
    n_pages = batch * cdiv(total_len, page) + 64
    grain = max(1, 1024 // page)
    cfg.cache = cfgmod.CacheConfig(
        page_size=page, num_pages=cdiv(n_pages, grain) * grain,
        max_pages_per_seq=cdiv(total_len, page) + 2, kv_dtype="int8")
    cfg.runtime.prefill_chunk = 256
    cfg.runtime.max_new_tokens = steps
    return cfg, batch, steps, prompt_len


def expected_launches(quant, n_layers, steps):
    """Exact launch counts of one ``generate_batch_fused`` run: one prefill
    chunk (the 64-token prompts fill one) and ``steps - 1`` decode steps,
    each a forward over ``n_layers`` layers of four projections (fused
    qkv, wo, fused gate-up, down) and then the LM head."""
    decode = n_layers * (steps - 1)
    out = {"paged_attention": n_layers, "kv_append_prefill": n_layers,
           "paged_attention_decode": decode, "kv_append_decode": decode,
           "int8_matmul": 0, "w8_matmul": 0, "w4_matmul": 0}
    if quant == "int8":                   # w8a8; the head is weight-only
        out["int8_matmul"] = 4 * n_layers * steps
        out["w8_matmul"] = steps
    elif quant == "int8-weight":
        out["w8_matmul"] = (4 * n_layers + 1) * steps
    elif quant == "int4":
        out["w4_matmul"] = (4 * n_layers + 1) * steps
    return out


def drive(torch, eng, prompts, greedy, steps, name):
    """The path's timed ``generate_batch_fused``, with every kernel's
    launch count set to 0 just before and checked just after."""
    from importlib import import_module

    plat = import_module(f"{PKG}.utils.platform")
    batch = len(prompts)
    eng.generate_batch_fused(prompts, 4, greedy)           # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate_batch_fused(prompts, 1, greedy)           # prefill only
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0

    plat.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = eng.generate_batch_fused(prompts, steps, greedy)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = {n: k.launches for n, k in plat.KERNELS.items()}
    decode_tps = batch * (steps - 1) / (total_s - prefill_s)
    print(f"  generate_batch_fused: prefill {prefill_s * 1e3:.2f} ms, "
          f"total {total_s * 1e3:.1f} ms, decode {decode_tps:.1f} tok/s "
          f"(B={batch}, {steps} tokens)", flush=True)
    print(f"  launches in that run: {json.dumps(counts)}", flush=True)
    expect = expected_launches(eng.cfg.quant, eng.cfg.num_layers, steps)
    check(counts == expect,
          f"{name}: launches {counts}, expected exactly {expect}")
    arr = np.asarray(toks)
    check(arr.shape == (batch, steps), f"tokens shape {arr.shape}")
    check(((arr >= 0) & (arr < eng.cfg.vocab_size)).all(),
          "token ids out of range")
    # a decode step reads every weight but the embedding table (of which
    # it gathers B rows) once: the end-to-end floor of a step
    stream_bytes = sum(t.numel() * t.element_size()
                       for key, t in _leaves(eng.params)
                       if key != "embedding")
    floor_ms = stream_bytes / HBM_BYTES_PER_S * 1e3
    print(f"  weight stream per decode step {stream_bytes / 1e9:.3f} GB: "
          f"floor {floor_ms:.3f} ms/step = {batch / floor_ms * 1e3:.0f} "
          f"tok/s at B={batch}; measured {decode_tps:.1f} tok/s = "
          f"{batch / decode_tps * 1e3:.2f} ms/step", flush=True)
    return {"decode_tok_s": decode_tps, "prefill_ms": prefill_s * 1e3,
            "total_ms": total_s * 1e3, "weight_stream_gb": stream_bytes / 1e9,
            "weight_stream_floor_ms": floor_ms, "launches": counts}


def build_engine(torch, quant, dtype="bfloat16"):
    from importlib import import_module

    eng_mod = import_module(f"{PKG}.engine")
    cfg, *_ = path_config(quant, dtype)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = eng_mod.Engine(cfg, seed=SEED)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 1e9
    print(f"  engine built (llama3-8b, quant={quant}, {dtype} activations, "
          f"weights from seed {SEED}) in {time.perf_counter() - t0:.1f} s; "
          f"holds {held:.2f} GB on the card (peak while building "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB)", flush=True)
    return eng, held


def run_paths(torch, dev, results):
    from importlib import import_module

    eng_mod = import_module(f"{PKG}.engine")
    cfg, batch, steps, prompt_len = path_config()
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.model.vocab_size,
                           size=(batch, prompt_len)).tolist()
    greedy = eng_mod.SamplingParams(temperature=0.0, eos_token_id=-1)
    refs = reference_backends()
    out = {}
    for (name, quant), letter in zip(PATHS, "abcd"):
        print(f"== phase 3{letter}: {name} (llama3-8b, quant={quant}, "
              "INT8 KV)", flush=True)
        eng, held = build_engine(torch, quant)
        info = drive(torch, eng, prompts, greedy, steps, name)
        info["engine_gb"] = held
        for kname, n in info["launches"].items():
            if LAUNCHES_FROM.get(kname, "w8a8") == name:
                results[kname]["launches"] = n
        tf16 = logit_checks(torch, eng, refs, prompts, greedy, steps,
                            TOL[(quant, "bf16")], "bf16")
        info.update(limit_readings(tf16, "bf16"))
        if quant in ("none", "int8"):
            info.update(full_checks(torch, eng, refs, prompts, greedy,
                                    steps, tf16))
        del eng
        torch.cuda.empty_cache()
        if quant == "none":
            # the same checks with f32 weights and activations (same
            # seed, unrounded)
            eng32, _ = build_engine(torch, quant, "float32")
            tf32 = logit_checks(torch, eng32, refs, prompts, greedy, steps,
                                TOL[(quant, "f32")], "f32")
            del eng32
            torch.cuda.empty_cache()
            info.update(limit_readings(tf32, "f32"))
        out[name] = info
    check(not LIMIT_FAILURES, "; ".join(LIMIT_FAILURES))
    return out


def limit_readings(tf, tag):
    """The readings of :func:`logit_checks` for the paths line."""
    info = {f"{tag}_tol_dlogit": tf["tol"],
            f"{tag}_greedy_agreement": tf["kernels"]["agree"]}
    for ref in ("kernels", "sdpa", "lowp"):
        info[f"{tag}_{ref}_max_dlogit"] = tf[ref]["max"]
    return info


def full_checks(torch, eng, refs, prompts, greedy, steps, tf16):
    """Given the teacher-forced readings ``tf16``: the fused loop at B=4
    against the step path and the plain fused loop, ``generate_stream``
    against the fused loop on a lone prompt, and a profile; for w8a8
    also ``score_nll`` against the plain path."""
    check(all(len(p) == len(prompts[0]) for p in prompts), "ragged prompts")
    info = fused_checks(torch, eng, refs, prompts, greedy, steps,
                        tf16["tokens"], tf16["tol"])
    # the streaming path (prefill + per-token decode, pages allocated as
    # it goes) against the fused loop on the same lone prompt: the same
    # shapes run the same GEMMs and kernels, so the tokens are identical.
    # (Row 0 of the B=4 batch is no reference: another batch size picks
    # other GEMM kernels, and a random model's top logits are near-tied.)
    stream = list(eng.generate_stream(prompts[0], 16, greedy))
    alone = eng.generate_batch_fused(prompts[:1], 16, greedy)[0]
    print(f"  generate_stream: {len(stream)} tokens; generate_batch_fused "
          f"on the same prompt alone: "
          f"{'identical' if stream == alone else 'DIFFERENT'}", flush=True)
    check(stream == alone, f"generate_stream {stream} != fused {alone}")
    if eng.cfg.quant == "int8":
        info.update(score_checks(eng, refs, prompts))
    info.update(profile_fused(torch, eng, prompts, greedy))
    return info


def score_checks(eng, refs, prompts):
    """``Engine.score_nll`` (B1/B4 and the matmul kernels at prefill
    shapes) against the plain path on the same sequences."""
    kern = eng.score_nll(prompts)
    with recording(eng, refs["plain"]):
        plain = eng.score_nll(prompts)
    rel = float(np.abs(kern - plain).max() / np.abs(plain).max())
    print(f"  score_nll: kernels {np.round(kern, 5).tolist()}, plain "
          f"{np.round(plain, 5).tolist()}: max relative difference "
          f"{rel:.3e} (tol {TOL_SCORE:g})", flush=True)
    check(np.isfinite(kern).all() and rel <= TOL_SCORE,
          "score_nll differs from the plain path")
    check(eng.allocator.num_free == eng.cache.num_pages - 1,
          "score_nll kept pages")
    return {"score_nll_rel_diff": rel}


def _leaves(params, key=""):
    """``(name, tensor)`` of every tensor in a params tree, the values and
    scales of quantized weights included."""
    if isinstance(params, dict):
        for k, v in params.items():
            yield from _leaves(v, k)
    elif isinstance(params, (tuple, list)):
        for v in params:
            yield from _leaves(v, key)
    elif dataclasses.is_dataclass(params):          # QTensor, Q4Tensor
        for f in dataclasses.fields(params):
            v = getattr(params, f.name)
            if hasattr(v, "element_size"):
                yield key, v
    else:
        yield key, params


@contextlib.contextmanager
def swapped_matmuls(fns):
    """Inside: ``linear`` reaches ``fns[name]`` in place of the port's
    ``int8_matmul`` / ``w8_matmul`` / ``w4_matmul`` wrappers."""
    from importlib import import_module

    mods = {"int8_matmul": import_module(f"{PKG}.ops.int8_matmul"),
            "w8_matmul": import_module(f"{PKG}.ops.int8_matmul"),
            "w4_matmul": import_module(f"{PKG}.ops.int4_matmul")}
    saved = {n: getattr(mods[n], n) for n in fns}
    for n, f in fns.items():
        setattr(mods[n], n, f)
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(mods[n], n, f)


@contextlib.contextmanager
def recording(eng, ref=None):
    """Inside: ``eng`` runs through the reference ``ref`` (a backend class
    and the matmuls it swaps in) when given, and the last-position logits
    ``[B, V]`` (f32, on the card) of every ``model.forward`` call are
    appended to the list it yields: the prefill's final logits (the
    prompts fill one chunk exactly), then one row per decode step."""
    rows = []
    forward, saved = eng.model.forward, eng.backend

    def recording_forward(*args):
        logits, kv = forward(*args)
        rows.append(logits[:, -1].float())
        return logits, kv

    eng.model.forward = recording_forward
    with contextlib.ExitStack() as stack:
        if ref is not None:
            backend, matmuls = ref
            eng.backend = backend(eng.cfg, eng.cache)
            stack.enter_context(swapped_matmuls(matmuls))
        try:
            yield rows
        finally:
            del eng.model.forward
            eng.backend = saved


def forced_logits(torch, eng, ref, prompts, greedy, steps, feed=None):
    """Prefill + ``steps - 1`` decode steps through the reference ``ref``
    (``None``: the kernels), step ``s`` fed ``feed[:, s]``, else its own
    greedy token. Returns the logits ``[steps, B, V]`` (f32, host) and the
    tokens fed ``[B, steps - 1]``."""
    with recording(eng, ref) as rows, torch.inference_mode():
        state = eng.prefill(prompts, sampling=greedy)
        fed = []
        for s in range(steps - 1):
            tok = (rows[-1].argmax(-1).to(torch.int32).cpu().numpy()
                   if feed is None else feed[:, s])
            fed.append(tok)
            eng._step_logits(state, tok)
        eng.free(state)
        logits = torch.stack(rows).cpu().numpy()
    check(np.isfinite(logits).all(), "non-finite logits")
    return logits, np.stack(fed, axis=1)


def compare(lk, lp):
    """``lk`` against the plain path's ``lp`` (both ``[steps, B, V]``):
    per-step max|dlogit|, greedy agreement, and agreement over the
    (step, row) pairs whose plain top-1 margin exceeds twice their
    max|dlogit| (the decidable ones)."""
    d = np.abs(lk - lp).max(axis=-1)                         # [steps, B]
    same = lk.argmax(-1) == lp.argmax(-1)
    top2 = np.sort(lp, axis=-1)[..., -2:]
    dec = (top2[..., 1] - top2[..., 0]) > 2 * d
    return {"diffs": d.max(axis=1).tolist(), "max": float(d.max()),
            "scale": float(np.abs(lp).max()), "agree": float(same.mean()),
            "decided": int(dec.sum()),
            "decided_agree": (float((same & dec).sum() / dec.sum())
                              if dec.any() else 1.0)}


def logit_checks(torch, eng, refs, prompts, greedy, steps, frac, tag):
    """Teacher-forced logits of the kernel path and of two references,
    each against the plain path fed the same tokens: the SDPA path (a
    sound independent implementation; it must pass) and the
    lower-precision control (it must fail, or the limit could not tell a
    kernel computing at the control's precision from a right one). The
    limit is ``frac`` of max|logit|."""
    lk, fed = forced_logits(torch, eng, None, prompts, greedy, steps)
    lp, _ = forced_logits(torch, eng, refs["plain"], prompts, greedy, steps,
                          fed)
    res = {"kernels": compare(lk, lp)}
    for ref in ("sdpa", "lowp"):
        lr, _ = forced_logits(torch, eng, refs[ref], prompts, greedy, steps,
                              fed)
        res[ref] = compare(lr, lp)
    kern = res["kernels"]
    tol = frac * kern["scale"]
    print(f"  teacher-forced {tag}, kernels vs plain: max|dlogit| per step "
          f"= {json.dumps([round(x, 5) for x in kern['diffs']])}",
          flush=True)
    print(f"  {tag}: limit {tol:.4e} = {frac:g} of max|logit| "
          f"{kern['scale']:.3f}; max|dlogit| vs plain: kernels "
          f"{kern['max']:.4e}, sdpa reference {res['sdpa']['max']:.4e} "
          f"(must pass), {LOWP_NAME[tag]} control {res['lowp']['max']:.4e} "
          f"(must fail); kernels' greedy agreement {kern['agree']:.3f} "
          f"overall, {kern['decided_agree']:.3f} over the "
          f"{kern['decided']} (step, row) pairs whose plain top-1 margin "
          f"exceeds 2x their max|dlogit| (tol == 1)", flush=True)
    where = f"{tag} ({eng.cfg.quant} weights)"
    check_limit(kern["max"] <= tol,
                f"{where} teacher-forced logits beyond the limit")
    check_limit(res["sdpa"]["max"] <= tol,
                f"{where} sdpa reference beyond the limit")
    check_limit(res["lowp"]["max"] > tol,
                f"{where} limit does not flag the {LOWP_NAME[tag]} control")
    check(kern["decided_agree"] == 1.0, f"{tag} decidable greedy tokens differ")
    # the kernel path's greedy tokens: the prefill's, then each step's
    res["tokens"] = lk.argmax(-1).T.astype(np.int32)          # [B, steps]
    res["tol"] = tol
    return res


def fused_checks(torch, eng, refs, prompts, greedy, steps, forced, tol):
    """``generate_batch_fused`` at B=4, through the kernels and through
    the plain versions. Its kernel tokens must equal the teacher-forced
    kernel path's greedy tokens ``forced [B, steps]`` (the fused loop's
    own bookkeeping: pages allocated up front, device-side seq_lens). The
    plain loop's tokens must equal them until a row's first fork, which
    must fall on a step whose plain top-1 margin is at most twice that
    step's max|dlogit|; until then the logits stay within ``tol``."""
    with recording(eng) as rk:
        tk = np.asarray(eng.generate_batch_fused(prompts, steps, greedy))
        lk = torch.stack(rk).cpu().numpy()
    with recording(eng, refs["plain"]) as rp:
        tp = np.asarray(eng.generate_batch_fused(prompts, steps, greedy))
        lp = torch.stack(rp).cpu().numpy()
    n_same = int((tk == forced).sum())
    print(f"  generate_batch_fused B={len(prompts)} kernels vs the "
          f"teacher-forced kernel path: {n_same} of {tk.size} tokens "
          f"equal (tol == all)", flush=True)
    check(n_same == tk.size, "fused loop tokens differ from the step path")
    compared, worst, forks = 0, 0.0, []
    for b in range(tk.shape[0]):
        for s in range(steps):
            d = float(np.abs(lk[s, b] - lp[s, b]).max())
            if tk[b, s] != tp[b, s]:
                top2 = np.sort(lp[s, b])[-2:]
                forks.append((b, s, float(top2[1] - top2[0]), d))
                break
            compared += 1
            worst = max(worst, d)
    shown = [(b, s, round(m, 5), round(d, 5)) for b, s, m, d in forks]
    print(f"  generate_batch_fused kernels vs plain: {compared} (step, row) "
          f"pairs before the rows fork, max|dlogit| {worst:.4e} (limit "
          f"{tol:.4e}); forks (row, step, plain margin, max|dlogit|): "
          f"{json.dumps(shown)} (each margin must be <= 2x its "
          f"max|dlogit|)", flush=True)
    check_limit(worst <= tol, "fused logits beyond the limit before the fork")
    check(all(m <= 2 * d for _, _, m, d in forks),
          "fused loops forked on a decidable token")
    return {"fused_pairs_before_fork": compared,
            "fused_max_dlogit": worst, "fused_forks": len(forks)}


def sdpa_paged(q, kv_pages, block_tables, seq_lens, q_offsets,
               kv_scales=None, layer=None, *, page_size, num_q_heads,
               window=0, softcap=0.0, scale=None):
    """Paged attention as one scaled_dot_product_attention call over a
    dense, dequantized, gathered copy of the pages (f32). A reference
    for this script only; the port never calls it."""
    import torch
    import torch.nn.functional as F_

    assert window == 0 and softcap == 0.0
    B, T, H, D = q.shape
    pool = kv_pages[layer]
    KH, page, mp = pool.shape[1], page_size, block_tables.shape[1]
    bt = block_tables.long()
    g = pool[:, :, bt].reshape(2, KH, B, mp * page, D).float()
    if kv_scales is not None:
        slots = (bt[:, :, None] * page
                 + torch.arange(page, device=q.device)).reshape(B, -1)
        g = g * kv_scales[layer].reshape(2, KH, -1)[:, :, slots][..., None]
    k, v = (x.permute(1, 0, 2, 3).repeat_interleave(H // KH, dim=1)
            for x in (g[0], g[1]))
    qpos = q_offsets.long()[:, None] + torch.arange(T, device=q.device)
    key = torch.arange(mp * page, device=q.device)
    mask = (key <= qpos[:, :, None]) & (key < seq_lens.long()[:, None, None])
    out = F_.scaled_dot_product_attention(
        q.float().transpose(1, 2), k, v, attn_mask=mask[:, None],
        scale=scale)
    return torch.nan_to_num(out).transpose(1, 2).to(q.dtype)


def reference_backends():
    """The references the kernel path is held against, each a
    ``PagedKVBackend`` with its wrappers replaced and the matmul wrappers
    it swaps in (the port never uses them): ``plain``, the kernels' plain
    PyTorch versions; ``sdpa``, plain appends, :func:`sdpa_paged`
    attention and products computed another way (``torch._int_mm`` for
    B10, a bf16 cuBLAS product over a widened weight for B11,
    :func:`w4_matmul_grouped` for B12); ``lowp``, the plain versions with attention at
    a lower precision (``LOWP_NAME``): for f32 queries, q and the output
    rounded to bf16 (attention done in bf16); for bf16 queries, q rounded
    to float8_e4m3 (an FP8 attention's query)."""
    from importlib import import_module

    import torch

    pb = import_module(f"{PKG}.engine.paged_backend")
    pool = import_module(f"{PKG}.kvcache.pool")
    pa = import_module(f"{PKG}.ops.paged_attention")
    i8 = import_module(f"{PKG}.ops.int8_matmul")
    i4 = import_module(f"{PKG}.ops.int4_matmul")
    plain_mm = {"int8_matmul": i8.int8_matmul_plain,
                "w8_matmul": i8.w8_matmul_plain,
                "w4_matmul": i4.w4_matmul_plain}
    library_mm = {"int8_matmul": int8_matmul_library,
                  "w8_matmul": w8_matmul_library,
                  "w4_matmul": w4_matmul_grouped}

    def append_plain(kv, k, v, layer, positions, block_tables, *,
                     page_size):
        return pool.append_to_pages_at_layer(kv, k, v, layer, positions,
                                             block_tables)

    def sdpa_decode(q, pages, bt, seq_lens, scales, layer, **kw):
        return sdpa_paged(q, pages, bt, seq_lens, seq_lens - 1, scales,
                          layer, **kw)

    def lower_precision(attend):
        def lowp(q, *args, **kw):
            if q.dtype == torch.float32:
                return attend(q.to(torch.bfloat16), *args, **kw).float()
            return attend(q.to(torch.float8_e4m3fn).to(q.dtype), *args,
                          **kw)
        return lowp

    class Plain(pb.PagedKVBackend):
        append = staticmethod(append_plain)
        attend = staticmethod(pa.paged_attention_plain)
        attend_decode = staticmethod(pa.paged_attention_decode_plain)

    class Sdpa(Plain):
        attend = staticmethod(sdpa_paged)
        attend_decode = staticmethod(sdpa_decode)

    class LowPrecision(Plain):
        attend = staticmethod(lower_precision(pa.paged_attention_plain))
        attend_decode = staticmethod(
            lower_precision(pa.paged_attention_decode_plain))

    return {"plain": (Plain, plain_mm), "sdpa": (Sdpa, library_mm),
            "lowp": (LowPrecision, plain_mm)}


def profile_fused(torch, eng, prompts, greedy, steps=16):
    """Device busy share and time by kernel over one fused run, from
    ``torch.profiler`` (CUPTI)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate_batch_fused(prompts, steps, greedy)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:      # CPU ops repeat their
            continue                              # kernels' time
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    # the projections and the LM head: cuBLAS's GEMM kernels (dense
    # weights) or the port's quantized-weight kernels
    gemm_us = sum(r[0] for r in rows
                  if any(s in r[2].lower() for s in ("gemm", "nvjet")))
    qmm_us = sum(r[0] for r in rows if "qmm::" in r[2])
    kernels_us = sum(r[0] for r in rows
                     if any(m in r[2] for names in KERNEL_NAMES.values()
                            for m in names))
    print(f"  profile of one fused run ({steps} tokens): wall "
          f"{wall_us / 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms "
          f"({busy_us / wall_us:.3f} of wall), of which cuBLAS GEMMs "
          f"{gemm_us / 1e3:.1f} ms, the port's kernels "
          f"{kernels_us / 1e3:.1f} ms (its quantized products "
          f"{qmm_us / 1e3:.1f} ms); top device time:", flush=True)
    for dev_us, count, key in rows[:12]:
        print(f"    {dev_us / 1e3:9.3f} ms  x{count:<6d} {key[:90]}",
              flush=True)
    return {"profile_wall_ms": wall_us / 1e3,
            "profile_device_busy_ms": busy_us / 1e3,
            "profile_busy_share": busy_us / wall_us,
            "profile_gemm_ms": gemm_us / 1e3,
            "profile_quant_matmul_ms": qmm_us / 1e3,
            "profile_port_kernels_ms": kernels_us / 1e3}


def main() -> int:
    try:
        import torch
        import torch.nn.functional as F_
    except ImportError:
        print("FAILED: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAILED: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, PKG)):
        print(f"FAILED: {PKG} is not beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    try:
        from importlib import import_module

        plat = import_module(f"{PKG}.utils.platform")
        for mod in ("paged_attention", "kv_append", "int8_matmul",
                    "int4_matmul"):
            import_module(f"{PKG}.ops.{mod}")
        check("jax" not in sys.modules, "jax was imported")

        print("== phase 1: card and build", flush=True)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        card = smi.stdout.strip().splitlines()[0] if smi.stdout else ""
        check(smi.returncode == 0 and card, "nvidia-smi failed")
        print(f"  card: {card}", flush=True)
        t0 = time.perf_counter()
        plat.build_kernels(verbose=True)
        print(f"  kernels built in {time.perf_counter() - t0:.1f} s",
              flush=True)

        results = {n: {"name": n, "route": "cuda",
                       "source": f"{PKG}/csrc/{k.source}",
                       "replaces": f"{TPU_PKG}/{k.replaces}"}
                   for n, k in plat.KERNELS.items()}
        print("== phase 2: kernels vs plain versions", flush=True)
        with torch.inference_mode():
            attention_checks(torch, F_, dev, results)
            append_checks(torch, dev, results)
            matmul_checks(torch, dev, results)
        e2e = run_paths(torch, dev, results)
        for name, r in results.items():
            check(r.get("launches", 0) > 0,
                  f"{name} was not launched on its path")
            check(all(r.get(k) is not None for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")),
                f"{name} lacks a measurement")
        check("jax" not in sys.modules, "jax was imported")
    except Exception as exc:  # every phase failure ends the run
        import traceback

        traceback.print_exc()
        print(f"FAILED: {exc}", file=sys.stderr)
        return 1

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "tol")
    print(json.dumps({"paths": e2e}), flush=True)
    print(json.dumps({"kernels": [{k: r.get(k) for k in keys}
                                  for r in results.values()]}), flush=True)
    print(card, flush=True)                 # nvidia-smi's own line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
