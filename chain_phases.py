#!/usr/bin/env python3
"""Where B14's time goes, on one NVIDIA H100.

    python3 chain_phases.py [NAME=SOURCE ...]

Builds copies of ``csrc/chain_linear.cu`` with parts of the chain kernel
cut out (each cut part returns at once, so its outputs are garbage) and
times each on Llama-3-8B's chain (``chip_smoke.CHAIN_MAIN``: w8a8 and
bf16 blocks, B=4, with the next layer's qkv) by CUPTI device time:

* ``full``: the kernel as it is;
* ``no_matmul``: the matmul tasks cut: the row phases and the barriers;
* ``no_rows``: the row phases cut: the matmul phases and the barriers;
* ``barriers_only``: both cut: the launch and the grid barriers.

``full`` is also timed with the matmul phases split for one task per SM
(the wrapper's choice), for two and for four. Each ``NAME=SOURCE``
argument adds another version of the source to time beside them. A tool
for the kernel's next tuning; it changes nothing in the package.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import chip_smoke as smoke  # noqa: E402
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.ops import chain_linear as cl  # noqa: E402
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.utils import platform as plat  # noqa: E402

#: where each part of the kernel begins (a ``return;`` after it cuts it)
MATMUL = ("                         int rg, const void* src, int src_w, "
          "Smem& sm) {\n")
ROWS = ["__device__ void init_rows(const Args& a, Smem& sm) {\n",
        "__device__ void norm_rows(const Args& a, int which, Smem& sm) {\n",
        "__device__ void act_rows(const Args& a, Smem& sm) {\n"]


def cut(text: str, markers) -> str:
    for m in markers:
        if m not in text:
            raise SystemExit(f"marker not in the source: {m!r}")
        text = text.replace(m, m + "  return;\n", 1)
    return text


def main() -> int:
    if not torch.cuda.is_available():
        print("FAILED: no CUDA device", file=sys.stderr)
        return 1
    src = (plat.CSRC / "chain_linear.cu").read_text()
    variants = {"full": src, "no_matmul": cut(src, [MATMUL]),
                "no_rows": cut(src, ROWS),
                "barriers_only": cut(src, ROWS + [MATMUL])}
    for arg in sys.argv[1:]:
        name, path = arg.split("=", 1)
        variants[name] = pathlib.Path(path).read_text()
    tmp = pathlib.Path(tempfile.mkdtemp())
    for h in plat.CSRC.glob("*.cuh"):
        (tmp / h.name).write_text(h.read_text())
    procs = {}
    for name, text in variants.items():
        (tmp / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [plat.nvcc_path(), *plat.NVCC_FLAGS, "-o",
             str(tmp / f"{name}.so"), str(tmp / f"{name}.cu")])
    for name, proc in procs.items():
        if proc.wait() != 0:
            print(f"FAILED: nvcc {name}", file=sys.stderr)
            return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)
    ops, lns = smoke.chain_ops(torch, gen, dev, smoke.CHAIN_MAIN)
    runs = [(name, cl._TASKS) for name in variants]
    runs += [("full", 2 * cl._TASKS), ("full", 4 * cl._TASKS)]
    for variant in ("w8a8", "bf16"):
        pc, _ = smoke.chain_variant(torch, ops, lns, smoke.CHAIN_MAIN,
                                    variant)
        ain = torch.randn((4, pc.K0), generator=gen, device=dev).to(
            torch.bfloat16)
        x = torch.randn((4, pc.D), generator=gen, device=dev).to(
            torch.bfloat16)
        ref = cl.chain_decode_plain(pc, ain, x)[0]
        for name, tasks in runs:
            fn = ctypes.CDLL(str(tmp / f"{name}.so")).pbt_chain_decode
            fn.argtypes, fn.restype = cl.CHAIN_DECODE.argtypes, ctypes.c_int
            cl.CHAIN_DECODE._fn = fn
            saved, cl._TASKS = cl._TASKS, tasks
            cl.chain_plan.cache_clear()
            try:
                err = (cl.chain_decode(pc, ain, x)[0].float()
                       - ref.float()).abs().max().item()
                ms = smoke.device_ms(lambda: cl.chain_decode(pc, ain, x),
                                     match=smoke.KERNEL_NAMES["chain_decode"])
            finally:
                cl._TASKS = saved
                cl.chain_plan.cache_clear()
            print(f"{variant} {name}, tasks a phase >= {tasks}: {ms:.4f} ms "
                  f"a call (CUPTI); max|x - plain| {err:.3e}", flush=True)
        del pc
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
