#!/usr/bin/env python3
"""Where the tensor-core kernels' time goes (B13, B1, B10/B15, B11, B12),
and the split-KV decode body's (B6, B8), on one NVIDIA H100.

    python3 tensor_core_phases.py [NAME ...]

Builds copies of ``csrc/gmm.cu``, ``csrc/paged_prefill.cu``, the INT8
kernel of ``csrc/imma.cuh`` (in ``int8_matmul.cu`` and
``chain_linear.cu``) and B11's kernel in ``csrc/int8_matmul.cu`` (on
``csrc/widen_gemm.cuh``, the mainloop it shares with B13) with parts cut
out (their outputs are then garbage) and times each by CUPTI device time
beside the kernel as it is (the names on the command line, by default
all ten: ``gmm.cu``, ``paged_prefill.cu``, ``int8_matmul.cu``,
``chain_linear.cu``, ``w8_matmul``, ``w4_matmul``, ``w4_gemv``,
``paged_decode.cu``, ``packed``, ``w8_gemv``):

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
* B11 ``w8_matmul`` (tensor-core route, bf16 x) at Llama-3-8B's four
  projections at M=256, summed, and its LM head at M=256 and M=36:
  ``full``; ``no_widen`` (as B13's); ``no_mma`` (no wgmma);
  ``no_widen_no_mma`` (what is left: the TMA loads, the barriers, the
  split-K merge and the epilogue); ``no_store`` (the epilogue computes
  but writes nothing).
* B6 ``paged_attention_decode_grouped`` (``csrc/split_decode.cuh``, the
  split-KV body it shares with B2 and B7) at path (h)'s shape (phi3-mini,
  dh 96, G 1, window 2047, B=4) and path (i)'s (516 pages, B=1, G 4)
  with bf16 queries, and the dh 64 shape of ``decode_variant_checks``
  (B=4, G 4, 2-5 pages a sequence, softcap 30) with f32 queries, INT8
  pools: ``full``; ``no_copies`` (the copy warp
  signals each stage without copying, so the compute reads stale
  shared memory); ``no_pv`` (no P.V product); ``no_copies_no_pv`` (what
  is left: the scores, the softmax, the ring's barriers and the merge);
  ``no_pages`` (every part empty: the launch, the q rows, the partials
  and the merge alone).
* B12 ``w4_matmul`` (tensor-core route, bf16 x, ``int4_matmul.cu`` on
  ``widen_gemm.cuh``'s ``mainloop_w4``) at Llama-3-8B's four projections
  at M=256, summed, and its LM head at M=256: ``full``; ``no_widen`` (the
  raw carrier tiles are not widened, so the products read stale shared
  memory); ``no_mma`` (no wgmma); ``no_widen_no_mma``; ``no_store`` (the
  epilogue computes but writes nothing).
* B12's decode gemv (``qmatmul.cuh``'s ``gemv_w4_kernel``, bf16 x) at
  Llama-3-8B's four projections at M=4, summed, and its LM head at M=4,
  each call on a weight outside L2: ``full``; ``no_loads`` (the carrier
  words written to the ring from the row index, so no weight byte is
  read);
  ``no_convert`` (the raw carrier words go to the products as they are);
  ``no_mma`` (the widened words folded into the sums by an add, no
  mma.sync); ``no_steps`` (no k-step at all: the launch, x's staging, the
  warps' merge, the split-K merge and the epilogue alone).
* B11's decode gemv (``qmatmul.cuh``'s ``gemv_w8_kernel`` on
  ``mma_gemv.cuh``, bf16 x) at Llama-3-8B's four projections at M=4,
  summed, its LM head and Mixtral-8x7B's expert gate|up and down at M=4,
  each call on a weight outside L2: ``full``; ``no_loads`` (no TMA copy
  and no wait: the products read the ring's stale slots);
  ``no_widen`` (the INT8 bytes not widened: the raw words go on to the
  bf16 pairs); ``no_mma`` (the pairs folded into the sums by an add, no
  mma.sync); ``no_steps`` (no k-step and no copy at all: the launch, x's
  staging, the warps' merge, the split-K merge and the epilogue).
* B8 ``paged_attention_decode_packed`` (``paged_decode_packed.cu``, on the
  same split-KV body, with B6's cuts) at path (g)'s shape (tinyllama-1.1b: B=8, KH 4, G 8, dh
  64, 1-2 pages a sequence, bf16 queries) and at dh 32 with a window of 40
  keys (f32 queries), INT8 pools: B6's five cuts.

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
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.ops import int4_matmul as i4  # noqa: E402
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.ops import int8_matmul as i8  # noqa: E402
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.ops import paged_attention as pa  # noqa: E402
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.quant import tensor as qt  # noqa: E402
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.utils import platform as plat  # noqa: E402

GMM_WIDEN = "  for (int u = ct; u < UNITS; u += 128 * NC) {"
W8_STORE = "    imma::store4<OT>(a.out,\n"
WIDE_MMA = ("      hop::mma_ss_n256<1>(acc, hop::desc(xs + kk * 32, 16, 1024),\n"
            "                          hop::desc(wb + kk * 2048, kWK * 128, "
            "1024), 1);")
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
SPLIT_COPY = ("        hop::mbar_arrive_tx(&full[st], 2 * row + (quant ? 8 * nsc : 0));\n"
              "        for (int kv = 0; kv < 2; ++kv) {")
SPLIT_PV = "      for (int k = ks; k < nk; k += KS) {"
SPLIT_PAGES = "  const int b = w.b, h = w.h, i0 = w.i0, n = w.n;"
W4_WIDEN = "  for (int u = ct; u < UNITS; u += W4Layout::NT) {"
W4_MMA = ("        hop::mma_ss_n128<1>(part, hop::desc(xs + kk * 32, 16, 1024),\n"
          "                            hop::desc(wb + kk * 2048, kWK * 128, "
          "1024),\n                            kt > kfirst || kk > 0);")
W4_STORE = "    imma::store4<OT>(a.out,\n"
GEMV_LOAD = ("      hop::cp_async16(slot + i * 32 + lane,\n"
             "                      valid ? wcol + static_cast<long long>(row) "
             "* wstride\n                            : a.w,\n"
             "                      valid);")
GEMV_A = "        const uint32_t A[4] = {"
GEMV_UNITS = ("  for (int ku = k_begin + warp * U; ku < k_end; ku += kWarps * U) "
              "{")
GEMV_A_END = "0x43084308u)};\n"
GEMV_MMA = ("        for (int p = 0; p < P; ++p) hop::mma_16816(part[4 * q + bb], "
            "A, b[p]);")
W8_FILL = ("    if (lane == 0)\n"
           "      mgv::fill_step(")
W8_WAIT = "      hop::mbar_wait(&bar[s % kW8Ring], (s / kW8Ring) & 1);\n"
W8_FIRST = "  for (int s = 0; s < kW8Pre; ++s) issue();"
W8_TOPUP = "      for (int i = issued - s; i < kW8Ring; ++i) issue();"
W8_WIDEN = ("        f[i][e] =\n"
            "            __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + e)) - kBias;")
W8_MMA = "          hop::mma_16816(acc[t][2 * q + h2], A, b[t][p]);"
W8_STEPS = "    for (int st = warp; st < n_steps; st += W, ++s) {"
B1_PV = ("        hop::mma_rs_n64<1>(o[c], pa[ks],\n"
         "                           hop::desc(vt + c * 8192 + ks * 2048, "
         "8192, 1024));")


def sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"marker not in the source: {old[:60]!r}")
    return text.replace(old, new, 1)


def variants():
    """``{name: {label: {file name: text}}}``: each variant's source and
    any cut header beside it (``imma.cuh`` for the INT8 kernel,
    ``widen_gemm.cuh`` for the widening of B13 and B11)."""
    g = (plat.CSRC / "gmm.cu").read_text()
    p = (plat.CSRC / "paged_prefill.cu").read_text()
    h = (plat.CSRC / "imma.cuh").read_text()
    w8 = (plat.CSRC / "int8_matmul.cu").read_text()
    wg = (plat.CSRC / "widen_gemm.cuh").read_text()
    w4 = (plat.CSRC / "int4_matmul.cu").read_text()
    qm = (plat.CSRC / "qmatmul.cuh").read_text()
    a0 = qm.index(GEMV_A)
    a1 = qm.index(GEMV_A_END, a0) + len(GEMV_A_END)
    gemv_no_convert = (qm[:a0] + "        const uint32_t A[4] = {wv[0][q], "
                       "s1, wv[2][q], s3};\n" + qm[a1:])
    pd = (plat.CSRC / "paged_decode.cu").read_text()
    sd = (plat.CSRC / "split_decode.cuh").read_text()
    no_copies = sub(sd, SPLIT_COPY, SPLIT_COPY.replace(
        "mbar_arrive_tx(&full[st], 2 * row + (quant ? 8 * nsc : 0))",
        "mbar_arrive(&full[st])").replace("kv < 2", "kv < 0"))
    no_pv = SPLIT_PV.replace("k < nk", "k < 0")
    no_widen = sub(wg, GMM_WIDEN, GMM_WIDEN.replace("u < UNITS", "u < 0"))
    no_widen4 = sub(wg, W4_WIDEN, W4_WIDEN.replace("u < UNITS", "u < 0"))
    no_convert = sub(p, B1_CONVERT, B1_CONVERT.replace("j < nk", "j < 0"))
    no_mma = sub(sub(p, B1_S, ""), B1_PV, "")
    no_transpose = sub(h, IMMA_TRANSPOSE,
                       IMMA_TRANSPOSE.replace("u < 256", "u < 0"))
    imma = {"full": h, "no_transpose": no_transpose,
            "no_mma": sub(h, IMMA_MMA, "      ;"),
            "no_transpose_no_mma": sub(no_transpose, IMMA_MMA, "      ;")}
    out = {
        "gmm.cu": {
            "full": {"gmm.cu": g},
            "no_widen": {"gmm.cu": g, "widen_gemm.cuh": no_widen},
            "no_store": {"gmm.cu": sub(g, GMM_STORE, "      if (v0 == 12345.f)\n"
                                       + GMM_STORE)},
        },
        "paged_prefill.cu": {
            label: {"paged_prefill.cu": text} for label, text in {
                "full": p,
                "no_convert": no_convert,
                "no_fold": sub(p, B1_FOLD, B1_FOLD + "    alpha[0] = "
                               "alpha[1] = 1.f;\n    return;\n"),
                "no_mma": no_mma,
                "no_convert_no_mma": sub(no_mma, B1_CONVERT,
                                         B1_CONVERT.replace("j < nk",
                                                            "j < 0")),
            }.items()},
        "paged_decode.cu": {
            label: {"paged_decode.cu": pd, "split_decode.cuh": text}
            for label, text in {
                "full": sd, "no_copies": no_copies,
                "no_pv": sub(sd, SPLIT_PV, no_pv),
                "no_copies_no_pv": sub(no_copies, SPLIT_PV, no_pv),
                "no_pages": sub(sd, SPLIT_PAGES, SPLIT_PAGES.replace(
                    "n = w.n", "n = 0"))}.items()},
        "w8_matmul": {
            "full": {"int8_matmul.cu": w8},
            "no_widen": {"int8_matmul.cu": w8, "widen_gemm.cuh": no_widen},
            "no_mma": {"int8_matmul.cu": w8,
                       "widen_gemm.cuh": sub(wg, WIDE_MMA, "      ;")},
            "no_widen_no_mma": {"int8_matmul.cu": w8, "widen_gemm.cuh": sub(
                no_widen, WIDE_MMA, "      ;")},
            "no_store": {"int8_matmul.cu": sub(
                w8, W8_STORE, "    if (y[0] == 12345.f)\n" + W8_STORE)},
        },
        "w4_matmul": {
            "full": {"int4_matmul.cu": w4},
            "no_widen": {"int4_matmul.cu": w4, "widen_gemm.cuh": no_widen4},
            "no_mma": {"int4_matmul.cu": w4,
                       "widen_gemm.cuh": sub(wg, W4_MMA, "        ;")},
            "no_widen_no_mma": {"int4_matmul.cu": w4, "widen_gemm.cuh": sub(
                no_widen4, W4_MMA, "        ;")},
            "no_store": {"int4_matmul.cu": sub(
                w4, W4_STORE, "    if (y[0] == 12345.f)\n" + W4_STORE)},
        }}
    pp = (plat.CSRC / "paged_decode_packed.cu").read_text()
    out["packed"] = {label: {"paged_decode_packed.cu": pp,
                             "split_decode.cuh": files["split_decode.cuh"]}
                     for label, files in out["paged_decode.cu"].items()}
    # imma.cuh beside the cut qmatmul.cuh, so that its include of it finds
    # the cut copy and not csrc's (two definitions)
    imma_h = (plat.CSRC / "imma.cuh").read_text()
    out["w4_gemv"] = {label: {"int4_matmul.cu": w4, "qmatmul.cuh": text,
                              "imma.cuh": imma_h}
                      for label, text in {
        "full": qm,
        "no_loads": sub(qm, GEMV_LOAD, "      slot[i * 32 + lane] = make_uint4("
                        "row, row * 3u, row ^ 0x5a5a5a5au, row + 7u);"),
        "no_convert": gemv_no_convert,
        "no_steps": sub(qm, GEMV_UNITS, GEMV_UNITS.replace("ku < k_end",
                                                           "ku < 0")),
        "no_mma": sub(qm, GEMV_MMA, "        for (int p = 0; p < P; ++p) "
                      "part[4 * q + bb][0] += __uint_as_float(\n"
                      "            A[0] ^ A[1] ^ A[2] ^ A[3] ^ b[p][0]);"),
    }.items()}
    # B11's decode gemv: int8_matmul.cu with cut copies of mma_gemv.cuh
    # (the products, shared with B14) or qmatmul.cuh (the kernel), and
    # imma.cuh and qmatmul.cuh copied beside them so that each is included
    # once
    mg = (plat.CSRC / "mma_gemv.cuh").read_text()
    out["w8_gemv"] = {label: dict({"int8_matmul.cu": w8, "qmatmul.cuh": q,
                                   "imma.cuh": imma_h}, **(
                                       {"mma_gemv.cuh": m} if m else {}))
                      for label, q, m in (
        ("full", qm, None),
        ("no_loads", sub(sub(qm, W8_FILL, W8_FILL.replace("lane == 0",
                                                          "false")),
                         W8_WAIT, ""), None),
        ("no_widen", qm, sub(mg, W8_WIDEN, "        f[i][e] = "
                             "__uint_as_float(u ^ e);")),
        ("no_mma", qm, sub(mg, W8_MMA, "          acc[t][2 * q + h2][0] "
                           "+= __uint_as_float(A[0] ^ A[1] ^ A[2] ^ A[3] ^ "
                           "b[t][p][0]);")),
        ("no_steps", sub(sub(sub(qm, W8_STEPS, W8_STEPS.replace(
            "st < n_steps", "st < 0")), W8_FIRST, W8_FIRST.replace(
                "s < kW8Pre", "s < 0")), W8_TOPUP, W8_TOPUP.replace(
                    "i < kW8Ring", "i < 0")), None))}
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


def b11_cases(dev):
    """B11 (bf16 x) at Llama-3-8B's four projections at M=256 (a call runs
    all four) and at its LM head at M=256 and M=36."""
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 10)
    cases, calls = {}, []
    for name, K, N in smoke.PROJECTIONS + [smoke.LM_HEAD]:
        w = qt.quantize_per_channel(torch.randn(
            (K, N), generator=gen, device=dev) * 0.02)
        for M in ((256, 36) if name == "lm-head" else (256,)):
            x = torch.randn((M, K), generator=gen, device=dev).to(
                torch.bfloat16)
            call = (lambda x=x, w=w: i8.w8_matmul(x, w.values, w.scales))
            if name == "lm-head":
                cases[f"head M={M}"] = call
            else:
                calls.append(call)
    cases["layer M=256"] = lambda: [c() for c in calls]
    return cases


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


def b6_cases(dev):
    """B6 at path (h)'s and path (i)'s decode shapes (bf16 queries) and the
    dh 64 shape with its softcap of 30 (f32 queries), ``chip_smoke``'s
    ``decode_variant_checks`` cases, INT8 pools."""
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 11)
    cases = {}
    for label, batch, kh, g, dh, mp, n_pages, lens, window, softcap in (
            ("(h)", 4, 32, 1, 96, 36, 150, [2049, 2080, 2100, 2112], 2047,
             0.0),
            ("(i)", 1, 8, 4, 128, 516, 520, [32832], 0, 0.0),
            ("dh 64 softcap", 4, 8, 4, 64, 5, 80, [65, 90, 128, 300], 0,
             30.0)):
        kv, bt = smoke.make_pool(torch, gen, torch.int8, dev, batch, kh, dh,
                                 mp, n_pages)
        q = torch.randn((batch, 1, kh * g, dh), generator=gen, device=dev)
        if not softcap:
            q = q.to(torch.bfloat16)
        sl = torch.tensor(lens, dtype=torch.int32, device=dev)
        kw = dict(page_size=smoke.PAGE, num_q_heads=kh * g, window=window,
                  softcap=softcap)
        cases[label] = (lambda a=(q, kv[0], bt, sl, kv[1], 1), kw=kw:
                        pa.paged_attention_decode_grouped(*a, **kw))
    return cases


def b12_cases(dev):
    """B12 (bf16 x) at Llama-3-8B's four projections at M=256 (a call runs
    all four) and at its LM head (bn 768) at M=256."""
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 12)
    cases, calls = {}, []
    for name, K, N in smoke.PROJECTIONS + [smoke.LM_HEAD]:
        w = qt.quantize_int4_groupwise(torch.randn(
            (K, N), generator=gen, device=dev) * 0.02)
        x = torch.randn((256, K), generator=gen, device=dev).to(
            torch.bfloat16)
        call = (lambda x=x, w=w: i4.w4_matmul(x, w.packed, w.scales,
                                              group=w.group, bn=w.bn))
        if name == "lm-head":
            cases["head M=256"] = call
        else:
            calls.append(call)
    cases["layer M=256"] = lambda: [c() for c in calls]
    return cases


def b12_gemv_cases(dev):
    """B12's gemv (bf16 x) at Llama-3-8B's four projections at M=4 (a call
    runs all four) and at its LM head at M=4, each call on the next of
    enough weight copies to overflow L2 (``chip_smoke``'s cold weights)."""
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 14)
    cases, calls = {}, []
    for name, K, N in smoke.PROJECTIONS + [smoke.LM_HEAD]:
        w = qt.quantize_int4_groupwise(torch.randn(
            (K, N), generator=gen, device=dev) * 0.02)
        copies = max(1, -(-int(2 * smoke.COLD_BYTES) // w.packed.numel()))
        ws = [w] + [qt.Q4Tensor(w.packed.clone(), w.scales.clone(), w.group,
                                w.bn) for _ in range(copies - 1)]
        x = torch.randn((4, K), generator=gen, device=dev).to(
            torch.bfloat16)
        call = smoke.cold_calls(lambda q, x=x: i4.w4_matmul(
            x, q.packed, q.scales, group=q.group, bn=q.bn), ws)
        if name == "lm-head":
            cases["head M=4"] = call
        else:
            calls.append(call)
    cases["layer M=4"] = lambda: [c() for c in calls]
    return cases


def b11_gemv_cases(dev):
    """B11's decode gemv (bf16 x) at Llama-3-8B's four projections at M=4
    (a call runs all four), its LM head at M=4 and Mixtral-8x7B's expert
    gate|up and down at M=4, each call on the next of enough weight copies
    to overflow L2 (``chip_smoke``'s cold weights)."""
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 15)
    cases, calls = {}, []
    for name, K, N in (smoke.PROJECTIONS + [smoke.LM_HEAD]
                       + smoke.MIXTRAL_EXPERTS):
        w = qt.quantize_per_channel(torch.randn(
            (K, N), generator=gen, device=dev) * 0.02)
        copies = max(1, -(-int(smoke.COLD_BYTES) // w.values.numel()))
        ws = [w] + [qt.QTensor(w.values.clone(), w.scales.clone())
                    for _ in range(copies - 1)]
        x = torch.randn((4, K), generator=gen, device=dev).to(
            torch.bfloat16)
        call = smoke.cold_calls(lambda q, x=x: i8.w8_matmul(
            x, q.values, q.scales), ws)
        if (name, K, N) in smoke.PROJECTIONS:
            calls.append(call)
        else:
            cases[f"{name.replace('lm-head', 'head')} M=4"] = call
    cases["layer M=4"] = lambda: [c() for c in calls]
    return cases


def b8_cases(dev):
    """B8 at path (g)'s decode shape (bf16 queries) and at dh 32 with a
    window of 40 keys (f32 queries), ``chip_smoke``'s
    ``decode_variant_checks`` cases, INT8 pools."""
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 13)
    cases = {}
    for label, dh, lens, window, qdt in (
            ("(g)", 64, [65, 72, 80, 96, 100, 112, 120, 128], 0,
             torch.bfloat16),
            ("dh 32 window 40", 32, [65, 72, 80, 96, 100, 112, 120, 320], 40,
             torch.float32)):
        kv, bt = smoke.make_pool(torch, gen, torch.int8, dev, 8, 4, dh, 5, 96)
        q = torch.randn((8, 1, 32, dh), generator=gen, device=dev).to(qdt)
        sl = torch.tensor(lens, dtype=torch.int32, device=dev)
        kw = dict(page_size=smoke.PAGE, num_q_heads=32, window=window)
        cases[label] = (lambda a=(q, kv[0], bt, sl, kv[1], 1), kw=kw:
                        pa.paged_attention_decode_packed(*a, **kw))
    return cases


#: each name's source, wrapper kernel, cases and profiler name
KERNELS = {"gmm.cu": ("gmm.cu", gmm.GROUPED_MATMUL, gmm_cases, "gmm::"),
           "paged_prefill.cu": ("paged_prefill.cu", pa.ATTENTION_WGMMA,
                                b1_cases, "attention_wgmma_kernel<"),
           "int8_matmul.cu": ("int8_matmul.cu", i8.INT8_MATMUL, b10_cases,
                              "imma::wgmma_s8_kernel<0,"),
           "chain_linear.cu": ("chain_linear.cu", cl.PACKED_LINEAR,
                               b15_cases, "imma::wgmma_s8_kernel<1,"),
           "w8_matmul": ("int8_matmul.cu", i8.W8_MATMUL, b11_cases,
                         "w8::w8_wgmma_kernel<"),
           "paged_decode.cu": ("paged_decode.cu", pa.ATTENTION_DECODE_GROUPED,
                               b6_cases, "decode_grouped_split_kernel<"),
           "w4_matmul": ("int4_matmul.cu", i4.W4_MATMUL, b12_cases,
                         "w4::w4_wgmma_kernel<"),
           "w4_gemv": ("int4_matmul.cu", i4.W4_MATMUL, b12_gemv_cases,
                       "qmm::gemv_w4_kernel<"),
           "packed": ("paged_decode_packed.cu", pa.ATTENTION_DECODE_PACKED,
                      b8_cases, "decode_packed_split_kernel<"),
           "w8_gemv": ("int8_matmul.cu", i8.W8_MATMUL, b11_gemv_cases,
                       "qmm::gemv_w8_kernel<")}


def build_variants(names):
    """Writes every variant under ``_build/phases/`` (a directory each)
    and compiles them all in parallel (one ``nvcc`` each, as
    ``build_kernels`` does). Returns ``{name: {label: library path}}``."""
    out_dir = plat.BUILD_DIR / "phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs, procs, done = {}, [], {}
    for name, versions in variants().items():
        if name not in names:
            continue
        source = KERNELS[name][0]
        for label, files in versions.items():
            key = (label, source, tuple(sorted(files.items())))
            if key in done:              # B8 reuses B6's cut builds
                libs.setdefault(name, {})[label] = done[key]
                continue
            where = out_dir / f"{label}_{name.split('.')[0]}"
            where.mkdir(exist_ok=True)
            for fname, text in files.items():
                (where / fname).write_text(text)
            src = where / source
            lib = src.with_suffix(".so")
            libs.setdefault(name, {})[label] = done[key] = lib
            procs.append((str(src), subprocess.Popen(
                [plat.nvcc_path(), *plat.NVCC_FLAGS, "-I", str(plat.CSRC),
                 "-o", str(lib), str(src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    for src, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc {src} failed:\n{log}")
    return libs


def main(names) -> int:
    if not torch.cuda.is_available():
        print("FAILED: no CUDA device", file=sys.stderr)
        return 1
    unknown = set(names) - set(KERNELS)
    if unknown:
        print(f"FAILED: no cuts of {sorted(unknown)} (names: "
              f"{sorted(KERNELS)})", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    for name, libs in build_variants(names or list(KERNELS)).items():
        _, kernel, cases_of, match = KERNELS[name]
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
