#!/usr/bin/env python3
"""Where the tensor-core kernels' time goes (B13, B1, B10/B15), on one
NVIDIA H100.

    python3 tensor_core_phases.py [SOURCE ...]

Builds copies of ``csrc/gmm.cu``, ``csrc/paged_prefill.cu`` and the INT8
kernel of ``csrc/imma.cuh`` (in ``int8_matmul.cu`` and
``chain_linear.cu``) with parts cut out (their outputs are then garbage)
and times each by CUPTI device time beside the kernel as it is (the
sources named on the command line, by default all four):

* B13 ``grouped_matmul`` at Mixtral-8x7B's prefill (``chip_smoke``'s
  routing of 1024 tokens to 2 of 8 experts, Npad 4096, with the
  dispatch's ``block_rows``), we_gu and we_down, INT8 and bf16 experts:
  ``full``; ``no_widen`` (the raw weight tiles are not widened into the
  swizzled bf16 tiles, so the products read stale shared memory);
  ``no_store`` (the epilogue writes nothing).
* B1 ``paged_attention`` (tensor-core kernel) at path (i)'s last chunk
  (256 queries over 32,768 keys, Llama-3.1-8B) and path (h)'s last chunk
  (phi3-mini, window 2047), INT8 pools: ``full``; ``no_convert`` (the
  raw pages are copied in but not widened); ``no_fold`` (no softmax:
  the scores go to P as they are); ``no_mma`` (no wgmma); and
  ``no_convert_no_mma`` (what is left: the copies, the barriers and the
  fold).
* B10 ``int8_matmul`` (tensor-core route) at Llama-3-8B's four
  projections (qkv, o, gate-up, down) at M=256 (a prefill chunk) and
  M=36 (a verify chunk), summed, and B15 ``packed_linear`` at the same
  layer's four calls at M=256 from a w8a8 chain (bk 1024, bn 2048):
  ``full``; ``no_transpose`` (the raw weight tiles are not transposed, so
  the products read stale shared memory); ``no_mma`` (no wgmma);
  ``no_transpose_no_mma`` (what is left: the TMA loads, the barriers,
  the split-K reduction and the epilogue).

A tool for the kernels' next tuning; it changes nothing in the package:
the copies are written and built under the package's git-ignored
``_build/phases/`` (one directory a variant, holding the cut source and
any cut header beside it; ``-I csrc`` for the rest), and each one's entry
point is bound to the wrapper's kernel only while it is timed.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import chip_smoke as smoke  # noqa: E402
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.ops import chain_linear as cl  # noqa: E402
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.ops import gmm  # noqa: E402
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.ops import int8_matmul as i8  # noqa: E402
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.ops import paged_attention as pa  # noqa: E402
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.quant import tensor as qt  # noqa: E402
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.utils import platform as plat  # noqa: E402

GMM_WIDEN = "  for (int u = ct; u < UNITS; u += 128 * NC) {"
GMM_STORE = ("      *reinterpret_cast<uint32_t*>(\n"
             "          a.out + static_cast<long long>(m0 + r) * N + n) =\n")
B1_CONVERT = "        for (int j = ci / pr; j < nk; j += step) {"
B1_FOLD = ("  auto fold = [&](float (&sacc)[32], float (&alpha)[2], "
           "int it) {\n")
B1_S = ("      hop::mma_ss_n64<0>(sacc, hop::desc(qs + off, 16, 1024),\n"
        "                         hop::desc(kt + off, 16, 1024), kk > 0);")
IMMA_TRANSPOSE = "  for (int u = ct; u < 256; u += NT) {"
IMMA_MMA = ("      hop::mma_s8_n128(acc, hop::desc(xs + kk * 32, 16, 1024),\n"
            "                       hop::desc(tb + kk * 32, 16, 1024), 1);")
B1_PV = ("        hop::mma_rs_n64<1>(o[c], pa[ks],\n"
         "                           hop::desc(vt + c * 8192 + ks * 2048, "
         "8192, 1024));")


def sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"marker not in the source: {old[:60]!r}")
    return text.replace(old, new, 1)


def variants():
    """``{source: {label: {file name: text}}}``: each variant's source and,
    for the INT8 kernel, its cut copy of ``imma.cuh``."""
    g = (plat.CSRC / "gmm.cu").read_text()
    p = (plat.CSRC / "paged_prefill.cu").read_text()
    h = (plat.CSRC / "imma.cuh").read_text()
    no_convert = sub(p, B1_CONVERT, B1_CONVERT.replace("j < nk", "j < 0"))
    no_mma = sub(sub(p, B1_S, ""), B1_PV, "")
    no_transpose = sub(h, IMMA_TRANSPOSE,
                       IMMA_TRANSPOSE.replace("u < 256", "u < 0"))
    imma = {"full": h, "no_transpose": no_transpose,
            "no_mma": sub(h, IMMA_MMA, "      ;"),
            "no_transpose_no_mma": sub(no_transpose, IMMA_MMA, "      ;")}
    out = {
        "gmm.cu": {
            "full": g,
            "no_widen": sub(g, GMM_WIDEN, GMM_WIDEN.replace("u < UNITS",
                                                            "u < 0")),
            "no_store": sub(g, GMM_STORE, "      if (v0 == 12345.f)\n"
                            + GMM_STORE),
        },
        "paged_prefill.cu": {
            "full": p,
            "no_convert": no_convert,
            "no_fold": sub(p, B1_FOLD, B1_FOLD
                           + "    alpha[0] = alpha[1] = 1.f;\n    return;\n"),
            "no_mma": no_mma,
            "no_convert_no_mma": sub(no_mma, B1_CONVERT,
                                     B1_CONVERT.replace("j < nk", "j < 0")),
        }}
    out = {src: {label: {src: text} for label, text in vs.items()}
           for src, vs in out.items()}
    for src in ("int8_matmul.cu", "chain_linear.cu"):
        text = (plat.CSRC / src).read_text()
        out[src] = {label: {src: text, "imma.cuh": hdr}
                    for label, hdr in imma.items()}
    return out


def gmm_cases(dev):
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 5)
    _, dest, gb, rows = smoke.moe_routing(torch, gen, dev)
    npad = gb.numel() * 256
    cases = {}
    for name, K, N in smoke.GMM_SHAPES:
        x = torch.zeros((npad, K), dtype=torch.bfloat16, device=dev)
        x[dest] = torch.randn((dest.numel(), K), generator=gen,
                              device=dev).to(torch.bfloat16)
        vals = torch.randint(-127, 128, (smoke.MOE_E, K, N), generator=gen,
                             device=dev, dtype=torch.int8)
        scales = torch.rand((smoke.MOE_E, 1, N), generator=gen,
                            device=dev) * 1e-3
        for kind, w in (("INT8", qt.QTensor(vals, scales)),
                        ("bf16", vals.to(torch.bfloat16))):
            cases[f"{name} {kind}"] = (
                lambda x=x, w=w: gmm.grouped_matmul(x, w, gb, bm=256,
                                                    block_rows=rows))
    return cases


def b1_cases(dev):
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 6)
    cases = {}
    for label, shape in (("(i) chunk 127",
                          dict(smoke.B1_I, offset=256 * 127)),
                         ("(h) last chunk", smoke.B1_H)):
        args, kw = smoke.b1_case(torch, gen, dev, **shape)
        cases[label] = (lambda args=args, kw=kw:
                        pa.paged_attention(*args, **kw))
    return cases


def b10_cases(dev):
    """B10 at Llama-3-8B's four projections, M=256 and M=36 (a call runs
    all four)."""
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 8)
    weights = {name: qt.quantize_per_channel(torch.randn(
        (K, N), generator=gen, device=dev) * 0.02)
        for name, K, N in smoke.PROJECTIONS}
    b10 = {}
    for M in (256, 36):
        calls = []
        for name, K, _ in smoke.PROJECTIONS:
            xq = qt.quantize_per_row(torch.randn((M, K), generator=gen,
                                                 device=dev))
            w = weights[name]
            calls.append(lambda xq=xq, w=w: i8.int8_matmul(
                xq.values, xq.scales, w.values, w.scales))
        b10[f"layer M={M}"] = (lambda calls=calls: [c() for c in calls])
    return b10


def b15_cases(dev):
    """B15 at a w8a8 Llama-3-8B chain's four calls at M=256."""
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 9)
    ops, lns = smoke.chain_ops(torch, gen, dev, smoke.CHAIN_MAIN)
    pc, _ = smoke.chain_variant(torch, ops, lns, smoke.CHAIN_MAIN, "w8a8")
    del ops, lns
    xs = {K: torch.randn((256, K), generator=gen, device=dev).to(
        torch.bfloat16) for K in (pc.D, pc.I)}
    runs = [((cl.OP_O,), pc.D), ((cl.OP_G, cl.OP_U), pc.D),
            ((cl.OP_D,), pc.I), ((cl.OP_T,), pc.D)]
    return {"layer M=256": lambda: [cl.packed_linear(pc, r, xs[K])
                                    for r, K in runs]}


#: each source's wrapper kernel, cases and profiler name
KERNELS = {"gmm.cu": (gmm.GROUPED_MATMUL, gmm_cases, "gmm::"),
           "paged_prefill.cu": (pa.ATTENTION_WGMMA, b1_cases,
                                "attention_wgmma_kernel<"),
           "int8_matmul.cu": (i8.INT8_MATMUL, b10_cases,
                              "imma::wgmma_s8_kernel<0,"),
           "chain_linear.cu": (cl.PACKED_LINEAR, b15_cases,
                               "imma::wgmma_s8_kernel<1,")}


def build_variants(sources):
    """Writes every variant under ``_build/phases/`` (a directory each)
    and compiles them all in parallel (one ``nvcc`` each, as
    ``build_kernels`` does). Returns ``{source: {label: library
    path}}``."""
    out_dir = plat.BUILD_DIR / "phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs, procs = {}, []
    for source, versions in variants().items():
        if source not in sources:
            continue
        for label, files in versions.items():
            where = out_dir / f"{label}_{source.split('.')[0]}"
            where.mkdir(exist_ok=True)
            for name, text in files.items():
                (where / name).write_text(text)
            src = where / source
            lib = src.with_suffix(".so")
            libs.setdefault(source, {})[label] = lib
            procs.append((str(src), subprocess.Popen(
                [plat.nvcc_path(), *plat.NVCC_FLAGS, "-I", str(plat.CSRC),
                 "-o", str(lib), str(src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc {name} failed:\n{log}")
    return libs


def main(sources) -> int:
    if not torch.cuda.is_available():
        print("FAILED: no CUDA device", file=sys.stderr)
        return 1
    unknown = set(sources) - set(KERNELS)
    if unknown:
        print(f"FAILED: no cuts of {sorted(unknown)} (sources: "
              f"{sorted(KERNELS)})", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    for source, libs in build_variants(sources or list(KERNELS)).items():
        kernel, cases_of, match = KERNELS[source]
        cases = cases_of(dev)
        try:
            for label, lib in libs.items():
                fn = getattr(ctypes.CDLL(str(lib)), kernel.symbol)
                fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
                kernel._fn = fn
                times = [f"{case} {smoke.device_ms(call, 10, (match,)):.4f}"
                         for case, call in cases.items()]
                print(f"{kernel.name} {label}: " + ", ".join(times) + " ms",
                      flush=True)
        finally:
            kernel._fn = None
            del cases
            torch.cuda.empty_cache()
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    with torch.inference_mode():
        sys.exit(main(sys.argv[1:]))
