"""Path (e)'s verify forward and the redesigned kernels, compared across
checkouts of the repo on one card.

    python3 verify_compare.py [--decode | --kernels] [TREE ...]

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
  shape (tinyllama-1.1b, B=8, dh 64);
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

With ``--decode`` only the split-KV decode kernels are timed (only their
sources are built); with ``--kernels`` every kernel above but not path
(e). Prints each checkout's output and results (one JSON line), then a
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
        plat.build_kernels(["paged_attention.cu", "paged_decode.cu"])
        return {"tree": str(tree), "card": card,
                "decode_ms": decode_times(torch, cs, dev, gen)}
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
    kernels = {"tree": str(tree), "card": card,
               "b10_layer_ms": {str(m): v for m, v in layer.items()},
               "b11_ms": b11, "b12_ms": b12, "decode_ms": decode,
               "b13_ms": b13, "b14_ms": b14}
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
]


def decode_times(torch, cs, dev, gen) -> dict:
    """The split-KV decode kernels at :data:`DECODE_SHAPES`, INT8 pool,
    bf16 queries, ms by CUPTI."""
    from importlib import import_module

    pa = import_module(f"{cs.PKG}.ops.paged_attention")
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
        fn = getattr(pa, kname)
        out[label] = cs.device_ms(lambda: fn(*args, **kw),
                                  match=cs.KERNEL_NAMES[kname])
        del kv, bt
        torch.cuda.empty_cache()
    return out


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
    MODE = ("decode" if "--decode" in sys.argv[1:] else
            "kernels" if "--kernels" in sys.argv[1:] else "all")
    argv = [a for a in sys.argv[1:] if a not in ("--decode", "--kernels")]
    if argv[:1] == ["--one"]:
        print(TAG + json.dumps(one(pathlib.Path(argv[1]), MODE)),
              flush=True)
    else:
        sys.exit(main(argv, MODE))
