"""Path (e)'s verify forward and B10 at a verify chunk, compared across
checkouts of the repo on one card.

    python3 verify_compare.py [TREE ...]

Each TREE is the root of a checkout (default: this one); give two
checkouts in the order ``A B B A`` to compare them on the same card.
Each runs in a process of its own, with that checkout's package and
``chip_smoke.py`` imported from it, so an older checkout is measured by
its own code:

* B10 ``int8_matmul``, a Llama-3-8B layer's four projections summed at
  M=36 (a verify chunk of 4 x 9 rows) and M=256 (a prefill chunk), each
  call on a weight outside L2, device time by CUPTI (``device_ms``);
* path (e) as ``chip_smoke.py`` runs it (``spec_path``: w8a8
  Llama-3-8B, 32 layers, random weights from seed 0, then the
  token-repeating copy that accepts drafts; each run's launch counts and
  tokens checked), with the wall of a verify forward, i.e. the timed spec
  run's decode time over its verify forwards, and the device time of the
  profiled spec run.

Prints each checkout's output and results (one JSON line), then a
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


def one(tree: pathlib.Path) -> dict:
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
    plat.build_kernels()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 3)

    layer = {36: 0.0, 256: 0.0}
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

    return {"tree": str(tree), "card": card,
            "b10_layer_ms": {str(m): v for m, v in layer.items()},
            "random": run(""), "repeating": run("repeating_"),
            "profile_wall_ms": info["profile_wall_ms"],
            "profile_device_busy_ms": info["profile_device_busy_ms"],
            "profile_busy_share": info["profile_busy_share"],
            "profile_b10_ms": info["profile_kernel_ms"].get(
                "int8_matmul", 0.0)}


def main(trees) -> int:
    results = []
    for tree in trees or ["."]:
        path = (pathlib.Path.cwd() / tree).resolve()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "verify_compare.py"), "--one",
             str(path)], capture_output=True, text=True)
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
    print("tree | B10 layer M=36 ms | M=256 ms | verify wall ms (random / "
          "repeating) | spec tok/s (random / repeating) | spec/fused "
          "(random / repeating) | profiled spec run: busy ms, share, B10 ms")
    for r in results:
        a, b = r["random"], r["repeating"]
        print(f"{r['tree']} | {r['b10_layer_ms']['36']:.4f} | "
              f"{r['b10_layer_ms']['256']:.4f} | {a['verify_wall_ms']:.2f} "
              f"/ {b['verify_wall_ms']:.2f} | {a['spec_tok_s']:.1f} / "
              f"{b['spec_tok_s']:.1f} | {a['spec_over_fused']:.3f} / "
              f"{b['spec_over_fused']:.3f} | "
              f"{r['profile_device_busy_ms']:.1f}, "
              f"{r['profile_busy_share']:.3f}, {r['profile_b10_ms']:.1f} "
              f"({r['card']})")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        print(TAG + json.dumps(one(pathlib.Path(sys.argv[2]))), flush=True)
    else:
        sys.exit(main(sys.argv[1:]))
