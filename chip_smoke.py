#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card (the kernels
build there with ``nvcc`` for ``sm_90a``). It imports the port
(``pagedattention_based_transformer_decoder_inference_framework_tpu_torch``)
and nothing of JAX. Phases:

1. Card and build: the card's name and power limit, then every kernel
   built from ``csrc/`` (one ``nvcc`` per source, in parallel), timed.
2. Each kernel against its plain PyTorch version on the card, at the
   slice's shapes (B=4, KH=8, G=4, dh=128, page 64, INT8 pool; prefill
   T=64, decode seq lens 65-128) plus edge cases (ragged lengths,
   skipped padding / invalid positions, a second prefill chunk, a
   sliding window with a tanh softcap, bf16 and f32 pools). Prints the
   max difference and its tolerance, the kernel's and the plain
   version's time, the bound, and for attention the time of
   ``scaled_dot_product_attention`` over a dense gathered copy (a
   yardstick the port never calls).
3. The slice: ``Engine`` on llama3-8b (bf16 weights from a seed, INT8
   paged KV, page 64, prefill chunk 256, the pool ``bench.py`` sizes)
   runs ``generate_batch_fused`` on 4 random 64-token prompts for 64
   greedy tokens, with every kernel's launch count reset just before
   and read just after. Then the same prompts are teacher-forced
   through the kernels, the plain versions, an SDPA reference and a
   lower-precision control (the last three are backends this script
   defines; the port has no such option), with bf16 and with f32
   weights: the kernels and the SDPA reference must stay within the
   logit limit, the control must not. The fused loop at B=4 is held
   against the step path's tokens and against the plain fused loop, and
   ``generate_stream`` runs once.
4. A ``{"kernels": [...]}`` summary line, then the card's line, then
   ``{"ok": true, "device": {...}}`` as the last line.

Exits non-zero with no ok line if any phase fails, if there is no CUDA
card, or if the port's package is not beside this script.
"""

from __future__ import annotations

import contextlib
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
#: peak rate by the type of a kernel's query input (H100 SXM data sheet,
#: dense): bf16 products of bf16 q and int8/bf16 K/V are exact in the
#: tensor cores' f32 accumulation, so the least time is at the bf16 rate;
#: f32 inputs use the rate outside the tensor cores
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
SEED = 0
#: teacher-forced logit limits, as a fraction of max|logit|: set from the
#: readings of the sdpa reference (which must pass) and of the
#: lower-precision control (which must fail); see PERF.md
TOL_BF16, TOL_F32 = 0.10, 0.012
LOWP_NAME = {"bf16": "fp8-q", "f32": "bf16-attention"}


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


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


def device_ms(fn, iters: int = 20, match: str = "") -> float:
    """Device time per call from torch.profiler (CUPTI): the summed time
    of the GPU kernels whose name contains ``match`` (all kernels if
    empty), over ``iters`` calls. CUPTI now and then hands back a trace
    without the kernels' records; such a trace is taken again, up to
    three times."""
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
            if e.device_type == DeviceType.CUDA and match in e.key)
        if total_us > 0:
            return total_us / iters / 1e3
        print(f"  (trace {attempt + 1} held no device time for "
              f"{match or 'the plain version'}; tracing again)", flush=True)
    raise PhaseError(f"profiler saw no device time for {match or fn}")


def bound(bytes_moved: float, flops: float, rate: str = "f32"):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[rate] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# -- phase 2: kernels against their plain versions -------------------------

B, KH, G, DH, PAGE, L, NUM_PAGES, MP = 4, 8, 4, 128, 64, 2, 80, 5
H = KH * G
#: each wrapper's CUDA kernel, as the profiler names it
KERNEL_NAMES = {"paged_attention": "paged_attention_kernel<",
                "paged_attention_decode": "paged_attention_decode_kernel<",
                "kv_append_decode": "append_decode_kernel",
                "kv_append_prefill": "append_prefill_kernel"}


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


# -- phase 3: the slice ------------------------------------------------------

def slice_config():
    from importlib import import_module

    cfgmod = import_module(f"{PKG}.config")
    batch, steps, prompt_len, page = 4, 64, 64, 64
    cfg = cfgmod.FrameworkConfig()
    cfg.model = cfgmod.preset("llama3-8b")
    cfg.model.quant = "none"
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


def run_slice(torch, dev, results):
    from importlib import import_module

    plat = import_module(f"{PKG}.utils.platform")
    eng_mod = import_module(f"{PKG}.engine")
    cfg, batch, steps, prompt_len = slice_config()
    t0 = time.perf_counter()
    eng = eng_mod.Engine(cfg, seed=SEED)
    torch.cuda.synchronize()
    print(f"  engine built (llama3-8b, bf16 weights from seed {SEED}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.model.vocab_size,
                           size=(batch, prompt_len)).tolist()
    greedy = eng_mod.SamplingParams(temperature=0.0, eos_token_id=-1)

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
    # a decode step reads every weight but the embedding table (of which
    # it gathers B rows) once: the end-to-end floor of a step
    stream_bytes = sum(t.numel() * t.element_size()
                       for key, t in _leaves(eng.params) if key != "embedding")
    floor_ms = stream_bytes / HBM_BYTES_PER_S * 1e3
    print(f"  weight stream per decode step {stream_bytes / 1e9:.3f} GB: "
          f"floor {floor_ms:.3f} ms/step = {batch / floor_ms * 1e3:.0f} "
          f"tok/s at B={batch}", flush=True)
    n_layers = cfg.model.num_layers
    expect = {"paged_attention": n_layers, "kv_append_prefill": n_layers,
              "paged_attention_decode": n_layers * (steps - 1),
              "kv_append_decode": n_layers * (steps - 1)}
    for name, n in expect.items():
        check(counts.get(name, 0) == n,
              f"{name} launched {counts.get(name, 0)} times, expected {n}")
        results[name]["launches"] = counts[name]
    arr = np.asarray(toks)
    check(arr.shape == (batch, steps), f"tokens shape {arr.shape}")
    check(((arr >= 0) & (arr < cfg.model.vocab_size)).all(),
          "token ids out of range")

    refs = reference_backends()
    check(all(len(p) == prompt_len for p in prompts), "ragged prompts")
    tf16 = logit_checks(torch, eng, refs, prompts, greedy, steps, TOL_BF16,
                        "bf16")
    fused = fused_checks(torch, eng, refs, prompts, greedy, steps,
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
    prof = profile_fused(torch, eng, prompts, greedy)
    del eng
    torch.cuda.empty_cache()

    # the same checks with f32 weights (same seed, unrounded)
    cfg32, *_ = slice_config()
    cfg32.model.dtype = "float32"
    eng32 = eng_mod.Engine(cfg32, seed=SEED)
    tf32 = logit_checks(torch, eng32, refs, prompts, greedy, steps, TOL_F32,
                        "f32")
    del eng32
    torch.cuda.empty_cache()
    out = {"decode_tok_s": decode_tps, "prefill_ms": prefill_s * 1e3,
           "total_ms": total_s * 1e3, "weight_stream_gb": stream_bytes / 1e9,
           "weight_stream_floor_ms": floor_ms, **fused, **prof}
    for tag, tf in (("bf16", tf16), ("f32", tf32)):
        out[f"{tag}_tol_dlogit"] = tf["tol"]
        out[f"{tag}_greedy_agreement"] = tf["kernels"]["agree"]
        for ref in ("kernels", "sdpa", "lowp"):
            out[f"{tag}_{ref}_max_dlogit"] = tf[ref]["max"]
    return out


def _leaves(params, key=""):
    """``(name, tensor)`` of every tensor in a params tree."""
    if isinstance(params, dict):
        for k, v in params.items():
            yield from _leaves(v, k)
    elif isinstance(params, (tuple, list)):
        for v in params:
            yield from _leaves(v, key)
    else:
        yield key, params


@contextlib.contextmanager
def recording(eng, backend=None):
    """Inside: ``eng`` attends through ``backend`` (when given), and the
    last-position logits ``[B, V]`` (f32, on the card) of every
    ``model.forward`` call are appended to the list it yields: the
    prefill's final logits (the prompts fill one chunk exactly), then
    one row per decode step."""
    rows = []
    forward, saved = eng.model.forward, eng.backend

    def recording_forward(*args):
        logits, kv = forward(*args)
        rows.append(logits[:, -1].float())
        return logits, kv

    eng.model.forward = recording_forward
    if backend is not None:
        eng.backend = backend
    try:
        yield rows
    finally:
        del eng.model.forward
        eng.backend = saved


def forced_logits(torch, eng, backend, prompts, greedy, steps, feed=None):
    """Prefill + ``steps - 1`` decode steps through ``backend`` (``None``:
    the kernels), step ``s`` fed ``feed[:, s]``, else its own greedy
    token. Returns the logits ``[steps, B, V]`` (f32, host) and the
    tokens fed ``[B, steps - 1]``."""
    with recording(eng, backend) as rows, torch.inference_mode():
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
            "decided_agree": float((same & dec).sum() / max(dec.sum(), 1))}


def logit_checks(torch, eng, refs, prompts, greedy, steps, frac, tag):
    """Teacher-forced logits of the kernel path and of two references,
    each against the plain path fed the same tokens: the SDPA path (a
    sound independent implementation; it must pass) and the
    lower-precision control (it must fail, or the limit could not tell a
    kernel computing at the control's precision from a right one). The
    limit is ``frac`` of max|logit|."""
    mk = lambda name: refs[name](eng.cfg, eng.cache)
    lk, fed = forced_logits(torch, eng, None, prompts, greedy, steps)
    lp, _ = forced_logits(torch, eng, mk("plain"), prompts, greedy, steps,
                          fed)
    res = {"kernels": compare(lk, lp)}
    for ref in ("sdpa", "lowp"):
        lr, _ = forced_logits(torch, eng, mk(ref), prompts, greedy, steps,
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
    check(kern["max"] <= tol, f"{tag} teacher-forced logits beyond the limit")
    check(res["sdpa"]["max"] <= tol, f"{tag} sdpa reference beyond the limit")
    check(res["lowp"]["max"] > tol,
          f"{tag} limit does not flag the {LOWP_NAME[tag]} control")
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
    with recording(eng, refs["plain"](eng.cfg, eng.cache)) as rp:
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
    check(worst <= tol, "fused logits beyond the limit before the fork")
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
    """The backends the kernel path is held against, each a
    ``PagedKVBackend`` with its wrappers replaced (the port never uses
    them): ``plain``, the kernels' plain PyTorch versions; ``sdpa``, plain
    appends and :func:`sdpa_paged` attention; ``lowp``, the plain versions
    at a lower precision (``LOWP_NAME``): for f32 queries, q and the
    output rounded to bf16 (attention done in bf16); for bf16 queries, q
    rounded to float8_e4m3 (an FP8 attention's query)."""
    from importlib import import_module

    import torch

    pb = import_module(f"{PKG}.engine.paged_backend")
    pool = import_module(f"{PKG}.kvcache.pool")
    pa = import_module(f"{PKG}.ops.paged_attention")

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

    return {"plain": Plain, "sdpa": Sdpa, "lowp": LowPrecision}


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
    # cuBLAS's GEMM kernels (the projections and the LM head)
    gemm_us = sum(r[0] for r in rows
                  if any(s in r[2].lower() for s in ("gemm", "nvjet")))
    kernels_us = sum(r[0] for r in rows
                     if any(m in r[2] for m in KERNEL_NAMES.values()))
    print(f"  profile of one fused run ({steps} tokens): wall "
          f"{wall_us / 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms "
          f"({busy_us / wall_us:.3f} of wall), of which cuBLAS GEMMs "
          f"{gemm_us / 1e3:.1f} ms and the port's kernels "
          f"{kernels_us / 1e3:.1f} ms; top device time:", flush=True)
    for dev_us, count, key in rows[:12]:
        print(f"    {dev_us / 1e3:9.3f} ms  x{count:<6d} {key[:90]}",
              flush=True)
    return {"profile_wall_ms": wall_us / 1e3,
            "profile_device_busy_ms": busy_us / 1e3,
            "profile_busy_share": busy_us / wall_us,
            "profile_gemm_ms": gemm_us / 1e3,
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
        import_module(f"{PKG}.ops.paged_attention")
        import_module(f"{PKG}.ops.kv_append")
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
        print("== phase 3: the slice (llama3-8b, bf16 weights, INT8 KV)",
              flush=True)
        e2e = run_slice(torch, dev, results)
        check("jax" not in sys.modules, "jax was imported")
    except Exception as exc:  # every phase failure ends the run
        import traceback

        traceback.print_exc()
        print(f"FAILED: {exc}", file=sys.stderr)
        return 1

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "tol")
    print(json.dumps({"slice": e2e}), flush=True)
    print(json.dumps({"kernels": [{k: r.get(k) for k in keys}
                                  for r in results.values()]}), flush=True)
    print(card, flush=True)                 # nvidia-smi's own line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
