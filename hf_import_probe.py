"""Where path (o)'s teacher-forced logit gap comes from, on the card.

    python3 hf_import_probe.py

Writes ``chip_smoke.py`` path (o)'s Gemma-3-1B (26 layers, dh 256, one KV
head, a 512-token window on five layers of six) from the seed as a
sharded HF directory, serves it through ``router.build_engine`` (w8a8 at
import, INT8 KV, page 64) and runs (o)'s teacher-forced comparison (one
600-token prompt and three of 64, 32 steps, every run fed the kernels'
greedy tokens) against the plain versions of every kernel, for:

* the kernels, the SDPA reference and the FP8-q control, as (o) does;
* one group of kernels at a time, the others plain: B1 (the prefill
  chunks' attention), B2 (the decode steps' attention), B3 and B4 (the
  appends), B1-B4 together, and B10 (the projections);
* the same INT8 weights served as ``int8-weight`` (activations left in
  bf16, B11 in every projection): the kernels, the attention kernels
  alone, SDPA and FP8-q, so that no rounding of an activation to an INT8
  code can flip.

Each line gives max|dlogit| against the plain run on the same engine,
its fraction of max|logit|, and its ratio to that engine's FP8-q control.
The card's name and power limit come first; the kernels are built from
``csrc/`` into ``_build/`` if they are not there yet.
"""

from __future__ import annotations

import contextlib
import copy
import io
import subprocess
import sys
import tempfile
import time
from importlib import import_module

import numpy as np
import torch

import chip_smoke as c

PKG = c.PKG


def mixed(plain, kern, names):
    """``plain``'s backend with the wrappers ``names`` taken from
    ``kern``'s (the kernels)."""
    return type("Mixed", (plain,),
                {n: staticmethod(getattr(kern, n)) for n in names})


def gaps(eng, plain, runs, prompts, greedy, fed, title):
    """Each ``(label, ref)`` of ``runs`` teacher-forced on ``eng`` with
    ``fed`` against the ``plain`` reference's run; prints max|dlogit|,
    its fraction of max|logit| and its ratio to the run labelled
    ``fp8-q``."""
    lp, _ = c.forced_logits(torch, eng, plain, prompts, greedy, c.HF_STEPS,
                            fed)
    rows = {}
    for label, ref in runs:
        got, _ = c.forced_logits(torch, eng, ref, prompts, greedy,
                                 c.HF_STEPS, fed)
        rows[label] = c.compare(got, lp)
    fp8 = rows["fp8-q"]["max"]
    print(f"{title} (max|logit| {rows['fp8-q']['scale']:.3f}):", flush=True)
    for label, r in rows.items():
        print(f"  {label:<47s} max|dlogit| {r['max']:.4f} "
              f"({r['max'] / r['scale']:.4f} of max|logit|, "
              f"{r['max'] / fp8:.3f} of fp8-q's); greedy agreement "
              f"{r['agree']:.3f}", flush=True)
    return rows


def main() -> int:
    t0 = time.perf_counter()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    plat = import_module(f"{PKG}.utils.platform")
    with contextlib.redirect_stdout(io.StringIO()):
        plat.build_kernels(["paged_attention.cu", "paged_prefill.cu",
                            "kv_append.cu", "int8_matmul.cu"])
    torch.backends.cuda.matmul.allow_tf32 = False
    cfgmod = import_module(f"{PKG}.config")
    eng_mod = import_module(f"{PKG}.engine")
    hs = import_module(f"{PKG}.models.hf_stream")
    router = import_module(f"{PKG}.engine.router")
    pre = cfgmod.preset(c.HF_MODEL)
    with tempfile.TemporaryDirectory(prefix="hf-gemma3-") as hf_dir:
        c.write_hf_checkpoint(hf_dir, c.gemma_tensors(torch, pre),
                              c.hf_config(pre), c.HF_SHARD_BYTES)
        cfg = c.path_config("int8", model=c.HF_MODEL, batch=len(c.HF_LENS),
                            prompt_len=max(c.HF_LENS))[0]
        cfg.model = hs.config_from_hf(hf_dir)
        cfg.model.quant = "int8"
        cfg.weights_path = hf_dir
        eng = router.build_engine(cfg, device="cuda", seed=c.SEED)
    rng = np.random.default_rng(c.SEED)
    prompts = [rng.integers(0, pre.vocab_size, n).tolist()
               for n in c.HF_LENS]
    greedy = eng_mod.SamplingParams(temperature=0.0, eos_token_id=-1)
    refs = c.reference_backends()
    plain, plain_mm = refs["plain"]
    kern = type(eng.backend)
    _, fed = c.forced_logits(torch, eng, None, prompts, greedy, c.HF_STEPS)
    w8a8 = gaps(eng, refs["plain"], [
        ("kernels", None), ("sdpa reference", refs["sdpa"]),
        ("fp8-q", refs["lowp"]),
        ("B1 alone (prefill attention)", (mixed(plain, kern, ["attend"]),
                                          plain_mm)),
        ("B2 alone (decode attention)", (mixed(plain, kern,
                                               ["attend_decode"]),
                                         plain_mm)),
        ("B3 + B4 alone (appends)", (mixed(plain, kern, ["append"]),
                                     plain_mm)),
        ("B1-B4 (attention and appends), products plain", (kern, plain_mm)),
        ("B10 alone (projections)", (plain, {}))],
        prompts, greedy, fed, "w8a8 (int8), against the plain versions")
    wcfg = copy.deepcopy(cfg)
    wcfg.model.quant = "int8-weight"
    wcfg.weights_path = None
    weng = eng_mod.Engine(wcfg, params=eng.params, device="cuda")
    weight = gaps(weng, refs["plain"], [
        ("kernels", None), ("sdpa reference", refs["sdpa"]),
        ("fp8-q", refs["lowp"]),
        ("B1-B4 (attention and appends), products plain", (kern, plain_mm)),
        ("B11 alone (projections)", (plain, {}))],
        prompts, greedy, fed, "the same INT8 weights as int8-weight (bf16 "
        "activations), against the plain versions")
    c.check(all(np.isfinite(r["max"]) for r in (*w8a8.values(),
                                                 *weight.values())),
            "non-finite gaps")
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
