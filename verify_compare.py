"""Path (e)'s verify forward and the redesigned kernels, compared across
checkouts of the repo on one card.

    python3 verify_compare.py [--decode | --kernels | --appends | --phase2]
                              [TREE ...]

Each TREE is the root of a checkout (default: this one); give two
checkouts in the order ``A B B A`` to compare them on the same card.
Each runs in a process of its own, with that checkout's package and
``chip_smoke.py`` imported from it, so an older checkout is measured by
its own code (device time by CUPTI, ``device_ms``, each product on a
weight outside L2):

* B10 ``int8_matmul``, a Llama-3-8B layer's four projections summed at
  M=4 (decode, the gemv), M=36 (a verify chunk of 4 x 9 rows) and M=256
  (a prefill chunk);
* B11 ``w8_matmul`` with bf16 x, the same layer's four projections at
  M=4 (the decode gemv) and M=256, the LM head at M=4, M=36 and M=256,
  and Mixtral-8x7B's expert gate|up and down at M=4 (path (k)'s decode);
* B12 ``w4_matmul`` with bf16 x, the same layer's four projections at
  M=4, 36 and 256 and the LM head at M=4 and 256;
* the split-KV decode kernels, INT8 pool, bf16 queries (``chip_smoke``'s
  ``decode_variant_checks`` shapes): B2 ``paged_attention_decode`` at the
  slice's shape (4 sequences of 65-128 keys), at a 512-page table at
  batch 1 (32,700 keys) and at four ragged sequences of 1-512 pages; B6
  ``paged_attention_decode_grouped`` at path (h)'s shape (phi3-mini, dh
  96, window 2047, B=4) and path (i)'s (516 pages, B=1); B7
  ``paged_attention_decode_batched`` at the slice's shape and the four
  ragged sequences; B8 ``paged_attention_decode_packed`` at path (g)'s
  shape (tinyllama-1.1b, B=8, dh 64); B9 ``paged_attention_decode_append``
  at the slice's shape and at the 512-page table, each beside B3
  ``kv_append`` then B2 on the same inputs (the two launches it
  replaces);
* the appends (``chip_smoke``'s ``append_checks`` shapes): B3
  ``append_decode`` at the slice (4 rows), B4 ``append_prefill`` at the
  slice's chunk (4 x 64 tokens, INT8 dh 128), path (i)'s (1 x 256) and
  path (h)'s (4 x 256, 32 KV heads, bf16 dh 96), B5 ``append_tokens`` at
  the verify chunk (4 x 9 tokens, one lane frozen); B3 and B5 also as the
  whole ``kv_append`` call (every kernel it launches, summed), on bf16
  rows viewed in a fused qkv output;
* the device kernels a decode step of path (b) and a verify iteration of
  path (e) issue (``step_kernels``: (b)'s engine built, two run lengths
  profiled, the difference over the steps between them);
* B13 ``grouped_matmul`` at Mixtral-8x7B's prefill (``chip_smoke``'s
  routing, Npad 4096, ``block_rows``), we_gu and we_down with INT8
  experts, summed;
* B14 ``chain_decode`` at Llama-3-8B's chain with the next layer's qkv,
  B=4, w8a8, int8-weight and bf16 blocks;
* path (e) as ``chip_smoke.py`` runs it (``spec_path``: w8a8
  Llama-3-8B, 32 layers, random weights from seed 0, then the
  token-repeating copy that accepts drafts; each run's launch counts and
  tokens checked), with the wall of a verify forward, i.e. the timed spec
  run's decode time over its verify forwards, and the device time of the
  profiled spec run.

With ``--decode`` only the split-KV decode kernels and B9 are timed
(only their sources are built); with ``--kernels`` every kernel above but
not path (e); with ``--appends`` only the appends above and, at the
slice, B9's whole wrapper call beside ``kv_append`` then B2, every kernel
of each call summed, with its kernel count (``b9_calls``; only
``kv_append.cu`` and ``paged_attention.cu`` are built); with ``--phase2``
the wall time of each check of ``chip_smoke.py``'s phase 2, as that
checkout's ``chip_smoke`` runs them (every kernel built first, not
timed). Prints each checkout's output and results (one JSON line), then a
table. Needs a card; exits 1 without one.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent
TAG = "VERIFY_COMPARE "


def one(tree: pathlib.Path, mode: str) -> dict:
    """The measurements on the checkout at ``tree``, in this process."""
    os.chdir(tree)
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    import chip_smoke as cs
    from importlib import import_module

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    plat = import_module(f"{cs.PKG}.utils.platform")
    i8 = import_module(f"{cs.PKG}.ops.int8_matmul")
    qt = import_module(f"{cs.PKG}.quant.tensor")
    eng_mod = import_module(f"{cs.PKG}.engine")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 3)
    if mode == "decode":
        plat.build_kernels(["paged_attention.cu", "paged_decode.cu",
                            "paged_decode_packed.cu", "kv_append.cu"])
        return {"tree": str(tree), "card": card,
                "decode_ms": decode_times(torch, cs, dev, gen)}
    if mode == "phase2":
        plat.build_kernels()
        return {"tree": str(tree), "card": card,
                "phase2_s": phase2_times(torch, cs, plat, dev)}
    if mode == "appends":
        plat.build_kernels(["paged_attention.cu", "kv_append.cu"])
        return {"tree": str(tree), "card": card,
                "append_ms": append_times(torch, cs, dev, gen),
                "b9_calls": b9_calls(torch, cs, dev, gen)}
    plat.build_kernels()

    layer = {4: 0.0, 36: 0.0, 256: 0.0}
    for _, K, N in cs.PROJECTIONS:
        wq = qt.quantize_per_channel(
            torch.randn((K, N), generator=gen, device=dev) * 0.02)
        copies = max(1, int(np.ceil(cs.COLD_BYTES / wq.values.numel())))
        wqs = [wq] + [qt.QTensor(wq.values.clone(), wq.scales.clone())
                      for _ in range(copies - 1)]
        for M in layer:
            xq = qt.quantize_per_row(
                torch.randn((M, K), generator=gen, device=dev).to(
                    torch.bfloat16))
            b10 = lambda q, xq=xq: i8.int8_matmul(
                xq.values, xq.scales, q.values, q.scales)
            layer[M] += cs.device_ms(cs.cold_calls(b10, wqs),
                                     match=cs.KERNEL_NAMES["int8_matmul"])
        del wq, wqs
    torch.cuda.empty_cache()
    b11 = b11_times(torch, cs, i8, qt, dev, gen)
    b12 = b12_times(torch, cs, qt, dev, gen)
    decode = decode_times(torch, cs, dev, gen)
    b13 = b13_ms(torch, cs, qt, dev, gen)
    b14 = b14_times(torch, cs, dev, gen)
    appends = append_times(torch, cs, dev, gen)
    kernels = {"tree": str(tree), "card": card,
               "b10_layer_ms": {str(m): v for m, v in layer.items()},
               "b11_ms": b11, "b12_ms": b12, "decode_ms": decode,
               "b13_ms": b13, "b14_ms": b14, "append_ms": appends,
               "step_kernels": step_kernels(torch, cs)}
    if mode == "kernels":
        return kernels

    cfg, batch, steps, prompt_len = cs.path_config(
        "int8", spec_k=cs.SPEC_K)
    eng, _ = cs.build_engine(torch, cfg)
    # chip_smoke.py's motif prompts (drawn after its random prompts)
    rng = np.random.default_rng(cs.SEED)
    rng.integers(0, cfg.model.vocab_size, size=(batch, prompt_len))
    motifs = rng.integers(0, cfg.model.vocab_size, (batch, 16)).tolist()
    prompts = [(m * -(-prompt_len // 16))[:prompt_len] for m in motifs]
    greedy = eng_mod.SamplingParams(temperature=0.0, eos_token_id=-1)
    info = cs.spec_path(torch, eng, prompts, greedy, steps, card)

    def run(prefix):
        decode_ms = (info[f"{prefix}spec_total_ms"]
                     - info[f"{prefix}prefill_ms"])
        return {"spec_tok_s": info[f"{prefix}spec_decode_tok_s"],
                "fused_tok_s": info[f"{prefix}fused_decode_tok_s"],
                "spec_over_fused": info[f"{prefix}spec_decode_tok_s"]
                / info[f"{prefix}fused_decode_tok_s"],
                "verify_forwards": info[f"{prefix}verify_forwards"],
                "verify_wall_ms": decode_ms
                / info[f"{prefix}verify_forwards"]}

    return {**kernels, "random": run(""), "repeating": run("repeating_"),
            "profile_wall_ms": info["profile_wall_ms"],
            "profile_device_busy_ms": info["profile_device_busy_ms"],
            "profile_busy_share": info["profile_busy_share"],
            "profile_b10_ms": info["profile_kernel_ms"].get(
                "int8_matmul", 0.0)}


#: Mixtral-8x7B's expert gate|up and down (path (k)'s decode step)
EXPERTS = [("expert gate-up", 4096, 28672), ("expert down", 14336, 4096)]


def b11_times(torch, cs, i8, qt, dev, gen) -> dict:
    """B11 with bf16 x: a layer's four projections at M=4 and M=256, the
    LM head at M=4, 36 and 256, and Mixtral-8x7B's expert gate|up and down
    at M=4, ms by CUPTI."""
    import numpy as np

    out = {"layer M=4": 0.0, "layer M=256": 0.0}
    for name, K, N in cs.PROJECTIONS + [cs.LM_HEAD] + EXPERTS:
        wq = qt.quantize_per_channel(
            torch.randn((K, N), generator=gen, device=dev) * 0.02)
        copies = max(1, int(np.ceil(cs.COLD_BYTES / wq.values.numel())))
        wqs = [wq] + [qt.QTensor(wq.values.clone(), wq.scales.clone())
                      for _ in range(copies - 1)]
        head = name == cs.LM_HEAD[0]
        expert = name.startswith("expert")
        for M in ((4, 36, 256) if head else (4,) if expert else (4, 256)):
            x = torch.randn((M, K), generator=gen, device=dev).to(
                torch.bfloat16)
            ms = cs.device_ms(cs.cold_calls(
                lambda q, x=x: i8.w8_matmul(x, q.values, q.scales), wqs),
                match=cs.KERNEL_NAMES["w8_matmul"])
            if head:
                out[f"head M={M}"] = ms
            elif expert:
                out[name] = ms
            else:
                out[f"layer M={M}"] += ms
        del wq, wqs
        torch.cuda.empty_cache()
    return out


def b14_times(torch, cs, dev, gen) -> dict:
    """B14 at Llama-3-8B's chain with the next layer's qkv, B=4, each
    variant, ms by CUPTI."""
    from importlib import import_module

    cl = import_module(f"{cs.PKG}.ops.chain_linear")
    ops, lns = cs.chain_ops(torch, gen, dev, cs.CHAIN_MAIN)
    out = {}
    for variant in ("w8a8", "int8-weight", "bf16"):
        pc, _ = cs.chain_variant(torch, ops, lns, cs.CHAIN_MAIN, variant)
        ain = torch.randn((4, pc.K0), generator=gen, device=dev).to(
            torch.bfloat16)
        x = torch.randn((4, pc.D), generator=gen, device=dev).to(
            torch.bfloat16)
        out[variant] = cs.device_ms(lambda: cl.chain_decode(pc, ain, x),
                                    match=cs.KERNEL_NAMES["chain_decode"])
        del pc
        torch.cuda.empty_cache()
    return out


def b12_times(torch, cs, qt, dev, gen) -> dict:
    """B12 with bf16 x: a layer's four projections at M=4, 36 and 256 and
    the LM head at M=4 and 256, ms by CUPTI, each call on a weight outside
    L2."""
    import numpy as np
    from importlib import import_module

    i4 = import_module(f"{cs.PKG}.ops.int4_matmul")
    out = {"layer M=4": 0.0, "layer M=36": 0.0, "layer M=256": 0.0}
    for name, K, N in cs.PROJECTIONS + [cs.LM_HEAD]:
        w4 = qt.quantize_int4_groupwise(
            torch.randn((K, N), generator=gen, device=dev) * 0.02)
        copies = max(1, int(np.ceil(2 * cs.COLD_BYTES / w4.packed.numel())))
        w4s = [w4] + [qt.Q4Tensor(w4.packed.clone(), w4.scales.clone(),
                                  w4.group, w4.bn)
                      for _ in range(copies - 1)]
        head = name == cs.LM_HEAD[0]
        for M in ((4, 256) if head else (4, 36, 256)):
            x = torch.randn((M, K), generator=gen, device=dev).to(
                torch.bfloat16)
            ms = cs.device_ms(cs.cold_calls(
                lambda q, x=x: i4.w4_matmul(x, q.packed, q.scales,
                                            group=q.group, bn=q.bn), w4s),
                match=cs.KERNEL_NAMES["w4_matmul"])
            key = f"head M={M}" if head else f"layer M={M}"
            out[key] = ms if head else out[key] + ms
        del w4, w4s
        torch.cuda.empty_cache()
    return out


#: the split-KV decode kernels' shapes: (label, wrapper, batch, KV heads,
#: G, dh, table width, pool pages, seq lens, window)
DECODE_SHAPES = [
    ("B2 slice", "paged_attention_decode", 4, 8, 4, 128, 5, 80,
     [65, 90, 128, 101], 0),
    ("B2 512 pages", "paged_attention_decode", 1, 8, 4, 128, 512, 520,
     [32700], 0),
    ("B2 ragged", "paged_attention_decode", 4, 8, 4, 128, 512, 2060,
     [1, 64 * 7 + 3, 64 * 200, 64 * 512], 0),
    ("B6 (h)", "paged_attention_decode_grouped", 4, 32, 1, 96, 36, 150,
     [2049, 2080, 2100, 2112], 2047),
    ("B6 (i)", "paged_attention_decode_grouped", 1, 8, 4, 128, 516, 520,
     [32832], 0),
    ("B7 slice", "paged_attention_decode_batched", 4, 8, 4, 128, 5, 80,
     [65, 90, 128, 101], 0),
    ("B7 ragged", "paged_attention_decode_batched", 4, 8, 4, 128, 512, 2060,
     [1, 64 * 7 + 3, 64 * 200, 64 * 512], 0),
    ("B8 (g)", "paged_attention_decode_packed", 8, 4, 8, 64, 5, 96,
     [65, 72, 80, 96, 100, 112, 120, 128], 0),
    ("B9 slice", "paged_attention_decode_append", 4, 8, 4, 128, 5, 80,
     [65, 90, 128, 101], 0),
    ("B3+B2 slice", "unfused", 4, 8, 4, 128, 5, 80, [65, 90, 128, 101], 0),
    ("B9 512 pages", "paged_attention_decode_append", 1, 8, 4, 128, 512,
     520, [32700], 0),
    ("B3+B2 512 pages", "unfused", 1, 8, 4, 128, 512, 520, [32700], 0),
]


def decode_times(torch, cs, dev, gen) -> dict:
    """The split-KV decode kernels and B9 at :data:`DECODE_SHAPES`, INT8
    pool, bf16 queries, ms by CUPTI; B9's yardstick ``unfused`` is B3
    (``kv_append``) then B2 on the same inputs, both kernels' time."""
    from importlib import import_module

    pa = import_module(f"{cs.PKG}.ops.paged_attention")
    ka = import_module(f"{cs.PKG}.ops.kv_append")
    out = {}
    for label, kname, batch, kh, g, dh, mp, n_pages, lens, window in \
            DECODE_SHAPES:
        kv, bt = cs.make_pool(torch, gen, torch.int8, dev, batch, kh, dh, mp,
                              n_pages)
        q = torch.randn((batch, 1, kh * g, dh), generator=gen,
                        device=dev).to(torch.bfloat16)
        sl = torch.tensor(lens, dtype=torch.int32, device=dev)
        args = (q, kv[0], bt, sl, kv[1], 1)
        kw = dict(page_size=cs.PAGE, num_q_heads=kh * g, window=window,
                  scale=dh ** -0.5)
        k, v = (torch.randn((batch, 1, kh, dh), generator=gen,
                            device=dev).to(torch.bfloat16) for _ in range(2))
        pos = (sl - 1)[:, None]
        if kname == "paged_attention_decode_append":
            fn = lambda: pa.paged_attention_decode_append(
                q, kv, k, v, bt, sl, pos, 1, **kw)
            match = cs.KERNEL_NAMES[kname]
        elif kname == "unfused":
            def fn():
                ka.kv_append(kv, k, v, 1, pos, bt, page_size=cs.PAGE)
                return pa.paged_attention_decode(*args, **kw)
            match = (cs.KERNEL_NAMES["kv_append_decode"]
                     + cs.KERNEL_NAMES["paged_attention_decode"])
        else:
            fn = lambda: getattr(pa, kname)(*args, **kw)
            match = cs.KERNEL_NAMES[kname]
        out[label] = cs.device_ms(fn, match=match)
        del kv, bt
        torch.cuda.empty_cache()
    return out


#: the appends' shapes: (label, wrapper, batch, KV heads, dh, pool dtype,
#: table width, pool pages, T, first position, frozen lane)
APPEND_SHAPES = [
    ("B3 slice", "append_decode", 4, 8, 128, "int8", 5, 80, 1, 64, False),
    ("B4 slice", "append_prefill", 4, 8, 128, "int8", 5, 80, 64, 0, False),
    ("B4 (i)", "append_prefill", 1, 8, 128, "int8", 516, 520, 256, 16384,
     False),
    ("B4 (h)", "append_prefill", 4, 32, 96, "bfloat16", 36, 150, 256, 768,
     False),
    ("B5 verify", "append_tokens", 4, 8, 128, "int8", 5, 80, 9, 70, True),
]
#: the labels of the whole ``kv_append`` calls timed beside B3 and B5
APPEND_CALLS = ["B3 slice kv_append", "B5 verify kv_append"]


def append_times(torch, cs, dev, gen) -> dict:
    """B3, B4 and B5 at :data:`APPEND_SHAPES`, ms by CUPTI; for B3 and B5
    also the whole ``kv_append`` call (every kernel it launches, summed).
    B3's and B5's rows are bf16 views of a fused qkv output, as the model
    hands them over; a checkout whose B3 / B5 take pool-dtype ``news``
    (before slice 14) gets them from its ``stack_new_kv`` outside the timed
    kernel, and runs it inside its ``kv_append``."""
    import inspect
    from importlib import import_module

    ka = import_module(f"{cs.PKG}.ops.kv_append")
    pool_mod = import_module(f"{cs.PKG}.kvcache.pool")
    out = {}
    for (label, wrapper, batch, kh, dh, pdt, mp, n_pages, T, p0,
         frozen) in APPEND_SHAPES:
        kv, bt = cs.make_pool(torch, gen, getattr(torch, pdt), dev, batch,
                              kh, dh, mp, n_pages)
        pos = (p0 + torch.arange(T, device=dev, dtype=torch.int32)).expand(
            batch, T).contiguous()
        if frozen:
            pos[2] = -1
        fn = getattr(ka, wrapper)
        kname = {"append_decode": "kv_append_decode",
                 "append_prefill": "kv_append_prefill",
                 "append_tokens": "kv_append_tokens"}[wrapper]
        if wrapper == "append_prefill":
            k, v = (torch.randn((batch, T, kh, dh), generator=gen,
                                device=dev) for _ in range(2))
            args = (pool_mod.stack_new_kv(kv, k, v),)
        else:
            heads = 4 * kh
            qkv = torch.randn((batch, T, (heads + 2 * kh) * dh),
                              generator=gen, device=dev).to(torch.bfloat16)
            k = qkv[..., heads * dh:(heads + kh) * dh].view(batch, T, kh, dh)
            v = qkv[..., (heads + kh) * dh:].view(batch, T, kh, dh)
            old = "news" in inspect.signature(fn).parameters
            args = (pool_mod.stack_new_kv(kv, k, v),) if old else (k, v)
            call = lambda: ka.kv_append(kv, k, v, 1, pos, bt,
                                        page_size=cs.PAGE)
            out[f"{label} kv_append"] = cs.device_ms(call, match=("",))
            out[f"{label} kv_append kernels"] = device_kernels(torch, call)
        out[label] = cs.device_ms(lambda: fn(kv, *args, 1, pos, bt),
                                  match=cs.KERNEL_NAMES[kname])
        del kv, args
        torch.cuda.empty_cache()
    return out


#: ``chip_smoke.py``'s phase 2, in its order (a checkout without one of
#: them, an older parent, skips it)
PHASE2 = ("attention_checks", "b1_shape_checks", "b1_score_checks",
          "append_checks", "decode_append_checks", "decode_variant_checks",
          "matmul_checks", "chain_checks", "gmm_checks")


def phase2_times(torch, cs, plat, dev) -> dict:
    """Seconds of wall time each of :data:`PHASE2`'s checks takes, run as
    ``chip_smoke.main`` runs them (the checks' own output printed)."""
    import time

    import torch.nn.functional as F_

    results = {n: {"name": n} for n in plat.KERNELS}
    out = {}
    with torch.inference_mode():
        for name in PHASE2:
            fn = getattr(cs, name, None)
            if fn is None:
                continue
            args = ((torch, F_, dev, results) if "F_" in
                    fn.__code__.co_varnames[:fn.__code__.co_argcount]
                    else (torch, dev, results))
            t0 = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            out[name] = time.perf_counter() - t0
    out["phase 2"] = sum(out.values())
    return out


def b9_calls(torch, cs, dev, gen) -> dict:
    """At the slice's decode shape (INT8 pool, bf16 queries and rows): B9's
    whole wrapper call (``stack_new_kv``'s glue and B9) and the unfused
    step's two calls (``kv_append``, then B2), each as the device time of
    every kernel it launches, summed by CUPTI, and its kernel count."""
    from importlib import import_module

    pa = import_module(f"{cs.PKG}.ops.paged_attention")
    ka = import_module(f"{cs.PKG}.ops.kv_append")
    batch, kh, g, dh, mp, n_pages, lens = 4, 8, 4, 128, 5, 80, [65, 90,
                                                                128, 101]
    kv, bt = cs.make_pool(torch, gen, torch.int8, dev, batch, kh, dh, mp,
                          n_pages)
    q, k, v = (torch.randn((batch, 1, n, dh), generator=gen,
                           device=dev).to(torch.bfloat16)
               for n in (kh * g, kh, kh))
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    pos = (sl - 1)[:, None]
    kw = dict(page_size=cs.PAGE, num_q_heads=kh * g, scale=dh ** -0.5)
    fused = lambda: pa.paged_attention_decode_append(q, kv, k, v, bt, sl,
                                                     pos, 1, **kw)

    def unfused():
        ka.kv_append(kv, k, v, 1, pos, bt, page_size=cs.PAGE)
        return pa.paged_attention_decode(q, kv[0], bt, sl, kv[1], 1, **kw)
    out = {}
    for label, fn in (("B9 call", fused), ("kv_append + B2", unfused)):
        out[label] = cs.device_ms(fn, match=("",))
        out[f"{label} kernels"] = device_kernels(torch, fn)
    del kv, bt
    torch.cuda.empty_cache()
    return out


def device_kernels(torch, fn, warm=True) -> int:
    """The device kernels (and copies) one call of ``fn`` issues (after a
    warm call unless ``warm`` is false), from torch.profiler's device
    records; a trace without them is taken again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    for _ in range(3):       # CUPTI now and then returns no device records
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(1 for e in prof.events()
                if e.device_type == DeviceType.CUDA)
        if n:
            return n
    return 0


def step_kernels(torch, cs) -> dict:
    """Device kernels a decode step of path (b) (``generate_batch_fused``
    of 9 tokens less that of 1, over 8) and a verify iteration of path (e)
    (``generate_batch_spec`` of 10 tokens less that of 2, over the verify
    forwards between them: the verify forward and the loop's own work), on
    (b)'s w8a8 Llama-3-8B engine with random weights from the seed (which
    accept no draft)."""
    import numpy as np
    from importlib import import_module

    eng_mod = import_module(f"{cs.PKG}.engine")
    cfg, batch, _, prompt_len = cs.path_config("int8", spec_k=cs.SPEC_K)
    eng, _ = cs.build_engine(torch, cfg)
    prompts = np.random.default_rng(cs.SEED).integers(
        0, cfg.model.vocab_size, size=(batch, prompt_len)).tolist()
    greedy = eng_mod.SamplingParams(temperature=0.0, eos_token_id=-1)
    fused = {n: device_kernels(
        torch, lambda n=n: eng.generate_batch_fused(prompts, n, greedy))
        for n in (1, 9)}
    spec, verifies = {}, {}
    for n in (2, 10):
        run = lambda n=n: eng.generate_batch_spec(
            prompts, n, greedy, spec_k=cs.SPEC_K, ngram=cs.SPEC_NGRAM)
        run()                                               # warm-up
        with cs.forward_calls(eng, record=False) as calls:
            spec[n] = device_kernels(torch, run, warm=False)
        verifies[n] = len(calls) - 1             # the first is the prefill
    del eng
    torch.cuda.empty_cache()
    return {"decode_step": (fused[9] - fused[1]) / 8,
            "verify": (spec[10] - spec[2]) / (verifies[10] - verifies[2]),
            "verify_forwards": verifies}


def b13_ms(torch, cs, qt, dev, gen) -> float:
    """B13 at Mixtral-8x7B's prefill, we_gu and we_down with INT8 experts
    and the dispatch's ``block_rows``, summed, ms by CUPTI."""
    from importlib import import_module

    gmm = import_module(f"{cs.PKG}.ops.gmm")
    _, dest, gb, rows = cs.moe_routing(torch, gen, dev)
    npad = gb.numel() * 256
    total = 0.0
    for _, K, N in cs.GMM_SHAPES:
        x = torch.zeros((npad, K), dtype=torch.bfloat16, device=dev)
        x[dest] = torch.randn((dest.numel(), K), generator=gen,
                              device=dev).to(torch.bfloat16)
        w = qt.QTensor(torch.randint(-127, 128, (cs.MOE_E, K, N),
                                     generator=gen, device=dev,
                                     dtype=torch.int8),
                       torch.rand((cs.MOE_E, 1, N), generator=gen,
                                  device=dev) * 1e-3)
        total += cs.device_ms(
            lambda: gmm.grouped_matmul(x, w, gb, bm=256, block_rows=rows),
            match=cs.KERNEL_NAMES["grouped_matmul"])
        del x, w
        torch.cuda.empty_cache()
    return total


def main(trees, mode) -> int:
    results = []
    for tree in trees or ["."]:
        path = (pathlib.Path.cwd() / tree).resolve()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "verify_compare.py"), "--one",
             str(path)] + ([f"--{mode}"] if mode != "all" else []),
            capture_output=True, text=True)
        print(f"== {tree}", proc.stdout, proc.stderr[-8000:], sep="\n",
              flush=True)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith(TAG)]
        if proc.returncode != 0 or not lines:
            print(f"{tree}: failed ({proc.returncode})", flush=True)
            return 1
        res = json.loads(lines[-1][len(TAG):])
        res["tree"] = tree
        print(json.dumps(res), flush=True)
        results.append(res)
    if mode == "phase2":
        names = list(PHASE2) + ["phase 2"]
        print("tree | " + " | ".join(f"{n} s" for n in names))
        for r in results:
            print(f"{r['tree']} | " + " | ".join(
                f"{r['phase2_s'][n]:.1f}" for n in names)
                + f" ({r['card']})")
        return 0
    labels = [label for label, *_ in APPEND_SHAPES] + APPEND_CALLS
    if mode == "appends":
        print("tree | " + " | ".join(f"{label} ms" for label in labels)
              + " | device kernels a kv_append call, T=1 / T=9 | B9's "
              "whole call ms (kernels) | kv_append + B2 ms (kernels)")
        for r in results:
            a, c = r["append_ms"], r["b9_calls"]
            print(f"{r['tree']} | " + " | ".join(
                f"{a[label]:.4f}" for label in labels) + " | " + " / ".join(
                str(a[f"{call} kernels"]) for call in APPEND_CALLS) + " | "
                + " | ".join(f"{c[x]:.4f} ({c[x + ' kernels']})"
                             for x in ("B9 call", "kv_append + B2"))
                + f" ({r['card']})")
        return 0
    print("tree | " + " | ".join(f"{label} ms" for label, *_ in DECODE_SHAPES))
    for r in results:
        print(f"{r['tree']} | " + " | ".join(
            f"{r['decode_ms'][label]:.4f}" for label, *_ in DECODE_SHAPES)
            + f" ({r['card']})")
    if mode == "decode":
        return 0
    print("tree | B10 layer M=4 / 36 / 256 ms | B11 layer M=4 / 256, head "
          "M=4 / 36 / 256, expert gate-up / down M=4 ms | B12 layer M=4 / 36 "
          "/ 256, head M=4 / 256 ms | B13 ms | B14 w8a8 / int8-weight / "
          "bf16 ms")
    for r in results:
        b10, b11, b12 = r["b10_layer_ms"], r["b11_ms"], r["b12_ms"]
        b14 = r["b14_ms"]
        print(f"{r['tree']} | {b10['4']:.4f} / {b10['36']:.4f} / "
              f"{b10['256']:.4f} | {b11['layer M=4']:.4f} / "
              f"{b11['layer M=256']:.4f}, {b11['head M=4']:.4f} / "
              f"{b11['head M=36']:.4f} / {b11['head M=256']:.4f}, "
              f"{b11['expert gate-up']:.4f} / {b11['expert down']:.4f} | "
              f"{b12['layer M=4']:.4f} / "
              f"{b12['layer M=36']:.4f} / {b12['layer M=256']:.4f}, "
              f"{b12['head M=4']:.4f} / {b12['head M=256']:.4f} | "
              f"{r['b13_ms']:.4f} | {b14['w8a8']:.4f} / "
              f"{b14['int8-weight']:.4f} / {b14['bf16']:.4f} ({r['card']})")
    print("tree | " + " | ".join(f"{label} ms" for label in labels)
          + " | device kernels a kv_append call, T=1 / T=9 | a (b) decode "
          "step | a (e) verify iteration")
    for r in results:
        n, a = r["step_kernels"], r["append_ms"]
        print(f"{r['tree']} | " + " | ".join(
            f"{a[label]:.4f}" for label in labels)
            + " | " + " / ".join(str(a[f"{c} kernels"]) for c in APPEND_CALLS)
            + f" | {n['decode_step']:.2f} | {n['verify']:.2f} "
            f"({r['card']})")
    if mode == "kernels":
        return 0
    print("tree | B10 layer M=36 ms | M=256 ms | B11 layer M=256 / head "
          "M=36 / head M=256 ms | B13 ms | verify "
          "wall ms (random / repeating) | spec tok/s (random / repeating) | "
          "spec/fused (random / repeating) | profiled spec run: busy ms, "
          "share, B10 ms")
    for r in results:
        a, b = r["random"], r["repeating"]
        b11 = r["b11_ms"]
        print(f"{r['tree']} | {r['b10_layer_ms']['36']:.4f} | "
              f"{r['b10_layer_ms']['256']:.4f} | "
              f"{b11['layer M=256']:.4f} / {b11['head M=36']:.4f} / "
              f"{b11['head M=256']:.4f} | {r['b13_ms']:.4f} | "
              f"{a['verify_wall_ms']:.2f} "
              f"/ {b['verify_wall_ms']:.2f} | {a['spec_tok_s']:.1f} / "
              f"{b['spec_tok_s']:.1f} | {a['spec_over_fused']:.3f} / "
              f"{b['spec_over_fused']:.3f} | "
              f"{r['profile_device_busy_ms']:.1f}, "
              f"{r['profile_busy_share']:.3f}, {r['profile_b10_ms']:.1f} "
              f"({r['card']})")
    return 0


if __name__ == "__main__":
    MODES = ("decode", "kernels", "appends", "phase2")
    MODE = next((m for m in MODES if f"--{m}" in sys.argv[1:]), "all")
    argv = [a for a in sys.argv[1:] if a not in [f"--{m}" for m in MODES]]
    if argv[:1] == ["--one"]:
        print(TAG + json.dumps(one(pathlib.Path(argv[1]), MODE)),
              flush=True)
    else:
        sys.exit(main(argv, MODE))
