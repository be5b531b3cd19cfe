#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card (the kernels
build there with ``nvcc`` for ``sm_90a``). It imports the port
(``pagedattention_based_transformer_decoder_inference_framework_tpu_torch``)
and nothing of JAX. Phases:

1. Card and build: the card's name and power limit, then every kernel
   built from ``csrc/`` (one ``nvcc`` per source, in parallel), timed;
   for the tensor-core kernels (B13's ``wgmma_kernel``, B1's
   ``attention_wgmma_kernel``, B10's and B15's ``wgmma_s8_kernel``, B11's
   ``w8_wgmma_kernel`` and ``gemv_w8_kernel``, B12's ``w4_wgmma_kernel``
   and ``gemv_w4_kernel``, B14's ``chain_kernel``)
   ptxas's registers, static shared memory and spills, and, where
   ``cuobjdump`` is found, the HGMMA / IGMMA (bf16 / INT8 wgmma),
   UTMALDG (TMA) and UBLKCP (bulk copy) instructions in their SASS; a
   wgmma serialization warning (C7510-C7520) in the build log fails.
2. Each kernel against its plain PyTorch version on the card.
   Attention (B1/B2) and appends (B3/B4) at slice 1's shapes (B=4, KH=8,
   G=4, dh=128, page 64, INT8 pool; prefill T=64, decode seq lens
   65-128) plus edge cases; B1 also at the verify chunk (T=9 from
   offsets off the page grid) and B4 at a page-long chunk off the page
   grid. B5 (``kv_append_tokens``) at the verify chunk (T=9 from
   positions 64-127, one lane frozen; INT8 and bf16 pools) and across
   page ends, bit-exact. B9 (``paged_attention_decode_append``) at B2's
   shapes: output within B2's tolerance, pool bit-exact. The
   quantized-weight products (B10
   ``int8_matmul``, B11 ``w8_matmul``, B12 ``w4_matmul``) at every
   Llama-3-8B projection's shape (qkv, wo, gate-up, down) at decode M=4,
   a verify chunk M=36 (B10) and prefill M=256, each kernel's layer of
   four summed at each M, at the LM head (N=128256, INT4 block width
   768), and at edge shapes (M 1 and 17, K and N that fit no tile, bias
   and activation, f32 output); two 128-row k-tiles of the qkv weight
   swapped must move B10's plain output. Prints the max difference and its tolerance,
   the kernel's and the plain version's device time, the bound, and a
   library yardstick the port never calls (``scaled_dot_product_attention``
   over a dense gathered copy; ``torch._int_mm``; a bf16 cuBLAS product
   over a pre-widened weight; ``torch._weight_int4pack_mm`` over the same
   INT4 values repacked with bf16 scales); B9's yardstick is the calls it
   replaces, ``kv_append`` and B2. The decode kernels past B2
   (slice 4): B8 (``paged_attention_decode_packed``) at path (g)'s shape
   and at dh 32 with a window; B6 (``paged_attention_decode_grouped``) at
   path (h)'s shape and at path (i)'s 516-page shape (B2 timed on the
   same inputs), each with bf16 and with f32 queries, whose 1e-4 must
   flag the output of a table with one group of 4 pages misread, and at
   dh 64 with a softcap; B7
   (``paged_attention_decode_batched``, on no path) at B2's shape with B2
   beside it and at 8 ragged sequences. The chained megakernel (slice
   5): B14 (``chain_decode``) at Llama-3-8B's chain (bk 1024, bn 2048, G
   104 blocks) at B=4 and B=1, with and without the next layer's qkv,
   with bf16, int8-weight and w8a8 blocks, within 2e-2 of max|plain|;
   each variant's plain output must move past that when two blocks are
   swapped; and at GPT-2's widths (GELU, LayerNorm, biases), TinyLlama's
   (I % bn != 0) and a hidden size of 1280 (square blocks); timed beside
   its yardstick, the per-op layer on the same weights (its launches
   counted). B15 (``packed_linear``) on the same chains at M=4, 36 and
   256 for o, gate|up, down and the tail (w8a8 bit-exact), a layer's
   four calls at M=256 timed beside ``torch._int_mm`` over the same
   values. The MoE grouped matmul (slice 6): B13 (``grouped_matmul``)
   at Mixtral-8x7B's two expert products at a 4 x 256-token prefill
   chunk (we_gu K 4096 N 28672, we_down K 14336 N 4096; Npad 4096 rows
   laid out by the model's ``dispatch_layout`` from a routing of random
   router logits), INT8 and dense bf16 experts under bf16 activations,
   within one bf16 step or 1e-5 of max|out| of its plain version, whose
   output two swapped blocks' group ids must move past that; timed
   beside ``torch._grouped_mm`` over bf16 copies of the weights (widened
   beforehand); and at edge shapes (an expert with no rows, one expert
   for every block, K and N that fit no tile, row blocks of 64 and 128,
   f32 activations). Slice 7 (the two kernels redesigned for Hopper):
   B1 routes by ``prefill_route`` (bf16 queries to the tensor-core kernel,
   f32 to the SIMT one, each with its own launch count), and the
   tensor-core kernel is also held at path (h)'s last chunk (phi3-mini:
   dh 96, window 2047, 4 x 256 queries over 2,048 keys) and path (i)'s
   chunks 0, 32, 64 and 127 (Llama-3.1-8B, 516-page table) at 2e-2 of
   max|plain|, timed beside its bound and SDPA; the four give path (i)'s
   B1 time by linear interpolation over 128 chunks x 32 layers, printed
   beside its measured prefill; two page ids of one table swapped must
   move the plain output past the tolerance. B13 runs with and without
   the dispatch's ``block_rows`` (the 128-row tiles it lets the kernel
   skip counted), and the edge shapes with and without ``block_rows``
   (ragged K and N zero-padded by the wrapper, f32 experts rounded to
   bf16 there, f32 activations on the CUDA-core kernel). Slice 8: B10
   past 16 rows and B15 under w8a8 run one INT8 tensor-core kernel
   (``csrc/imma.cuh``'s ``wgmma_s8_kernel``: weight tiles transposed on
   chip, s8 x s8 -> s32 wgmma), bit-exact at every shape above; B15's
   plain output must move when the o-projection's first two blocks are
   swapped. Slice 9 (B11 and B2 redesigned): B11 past 16 rows with bf16
   x runs its tensor-core kernel (``w8_wgmma_kernel`` on B13's mainloop,
   ``csrc/widen_gemm.cuh``: the INT8 weight widened to bf16 on chip,
   ``wgmma`` with f32 sums, a one-wave K split merged in split order),
   held and timed at a layer's four projections and the LM head at M=36
   and M=256 and at Mixtral-8x7B's qkv, o and head at M=1024 (path (k)'s
   prefill chunk), its tolerance checked against two misreads of the
   plain output (two 64-row k-tiles, or two 256-column blocks, of the
   qkv weight swapped); B2 is split-KV in one launch (pages by bulk copy
   into a ring, the splits merged in split order by the last block of a
   sequence and KV head), held and timed at the slice, path (k)'s decode
   shape, a 512-page table at batch 1 (B6 beside) and four ragged
   sequences of 1-512 pages; with f32 queries at 512 pages its splits
   merged in reverse order (plain PyTorch) must stay within 1e-4 and one
   misread page must not. Slice 10 (B6 and B7 on B2's split-KV body,
   ``csrc/split_decode.cuh``, one launch each): B7 also at B2's four
   ragged sequences of 1-512 pages (split by the real lengths), B2 timed
   beside B7 at each of its shapes; with f32 queries B6's and B7's parts
   merged in reverse order must stay within 1e-4 and one misread page
   must not, as B2's; B6's cut (pages a split, ring stages, rows) swept
   at (h)'s and (i)'s shapes; (g)'s and (h)'s profiles give their decode
   kernel's time a layer. Slice 11 (B12 and B8 redesigned): B12 past 16
   rows with bf16 x runs ``int4_matmul.cu``'s ``w4_wgmma_kernel`` on
   ``widen_gemm.cuh``'s INT4 mainloop (a raw carrier tile feeding two
   128-column runs, each K-group's f32 sums folded with its scales), and
   at M <= 16 the tensor-core gemv ``gemv_w4_kernel`` (mma.sync, weights as
   the A operand); B12 is held and timed at a layer's four projections at
   M=4, 36 and 256 and the head at M=4 and 256 beside tinygemm and the
   bound (phase 1 reports its wgmma kernel's registers and HGMMA/UTMALDG
   counts), and two 128-column carrier runs of the qkv weight swapped must
   move its plain output past the tolerance; B8 runs on the split-KV body
   (``decode_packed_split_kernel``), held at (g)'s shape and the dh-32
   cases beside SDPA, with f32 queries its parts merged in reverse order
   within 1e-4 and one misread page past it, and its cut swept at (g)'s
   shape (``b8_sweep``). Slice 12 (B11's decode gemv and B14's matmul
   tasks redesigned):
   B11 at M <= 16 runs ``gemv_w8_kernel`` (``csrc/qmatmul.cuh`` on
   ``csrc/mma_gemv.cuh``: mma.sync with the INT8 weights widened exactly
   to bf16 as the A operand, each warp's k-steps brought by TMA into a
   ring that runs on across a block's tiles, x staged once), held at a
   layer's four projections and the head at M=4 with bf16 and f32 x and
   at Mixtral-8x7B's expert gate|up and down at M=4 (path (k)'s decode
   step), timed with cold weights beside the bound, the widened GEMM and
   (the layer) B10's gemv; two of its 16-row k-steps of the qkv weight
   swapped must move the plain output past one bf16 step. Phase 1's
   report adds the mma.sync kernels (B11's and B12's gemv, B14):
   registers, spills and their HMMA / IMMA, UTMALDG and LDGSTS (cp.async)
   counts. B14's matmul tasks run on mma.sync with the weights through
   TMA rings whose copies run on across the row phases and barriers; it
   is held as before in every variant and edge chain. Slice 13 (B9 and B4
   redesigned): B9 runs on B2's split-KV body (``decode_append_split_kernel``:
   B2's grid and plan over the keys already in the pool, the new token
   folded in the merge, its row stored by the merging block's copy warp),
   held also at a 512-page table at batch 1 and with a stale row planted
   in each new token's slot (f32 queries; the plain version reading that
   slot as a key, at ``seq_len + 1``, must move the output past the
   tolerance), and timed at the slice and at 512 pages beside B2 alone
   and the unfused step (``kv_append`` then B2) on the same inputs, both
   routes as whole calls (every kernel each issues); B4 (``append_prefill_kernel``: a
   slot's position and pool page read once, every row unit copied
   independently) is held and timed at paths (i)'s, (h)'s and (k)'s
   chunks too; B3, B4 and B5 are timed beside their library yardstick,
   ``index_copy_`` of the rows into the flattened pool (and of the INT8
   scales into the flat scales). Phase 1 reports B2's, B9's and B4's
   registers and spills and the split-KV kernels' bulk copies (UBLKCP).
   Slice 14 (B3 and B5 redesigned as quantize-and-append kernels): B3 and
   B5 take the model's rows (bf16 views of a fused qkv output, or f32)
   and quantize in the kernel, a row a warp; each is held bit for bit
   against its plain version (``stack_new_kv`` then the scatter) on
   values, scales and untouched slots, with ``tests/_kv_rows.py``'s edge
   rows planted (exact ties, an all-zero row, a negative absmax, a value
   a reciprocal multiply would round to another code), with f32 rows and
   at dh 64, 96 (KV heads 32) and 256; a T=1 and a T=9 ``kv_append`` on
   the INT8 pool must issue one device kernel each; both are timed alone
   and as the whole ``kv_append`` call, beside their yardstick
   ``stack_new_kv`` then ``index_copy_``; path (b)'s profile gives its
   device kernels a decode step. Slice 16 (B1's per-page score export,
   ``b1_score_checks``): both B1 kernels with ``return_scores`` at the
   decode_scored shape (T=1, seq lens 65-128 over 5-page tables), the
   verify chunk, a window with a softcap (f32 queries, the SIMT kernel)
   and a page-16 pool: scores within 1e-4 of max|score| of the plain
   version's, the dead pages (``-1e30``) identical, the output the same
   bits as the launch without the export; B1 timed with and without it
   beside its bound and SDPA.
3. The paths, each ``Engine`` on llama3-8b at full width and full depth
   (32 layers; (a), (c) and (d) cut to 8; weights from a seed, INT8
   paged KV, page 64, prefill chunk 256, the pool ``bench.py`` sizes, for (b),
   (e) and (f) the one it sizes for ``--mode spec``) running
   ``generate_batch_fused`` on 4
   random 64-token prompts for 32 greedy tokens (``MAIN_STEPS``, half of
   bench's 64, for the script's time since path (o)), with every kernel's
   launch count reset just before and checked just after against the
   exact count the loop implies:
   a. bf16 weights (``quant="none"``, slice 1);
   b. w8a8 INT8 weights (``quant="int8"``, ``bench.py``'s default), the
      main path of slice 2: B10 in every projection, B11 in the LM head;
   c. weight-only INT8 (``quant="int8-weight"``): B11 everywhere;
   d. INT4 (``quant="int4"``): B12 everywhere;
   e. spec (slice 3), on (b)'s engine: ``generate_batch_spec`` as
      ``bench.py --mode spec`` runs it (spec_k 8, n-gram 2, prompts of a
      random 16-token motif tiled, its pool), every verify forward a
      9-token chunk through B5 and B1; launch counts from the counted
      verify forwards; decode tokens/s against ``generate_batch_fused``
      on the same prompts (both timed bare), whose tokens it must follow
      up to each row's first fork, which must fall on an undecidable
      token (in separate, recorded runs). Random weights accept no
      draft, so the same run follows on a copy of the weights that
      repeats its input token (layers damped, the LM head the
      embedding's transpose), where drafts are accepted and a verify
      emits several tokens;
   f. fused-append (slice 3), on (b)'s engine: ``generate_batch_fused``
      with ``PBT_FUSED_APPEND=1``, B9 in every decode layer and B2/B3
      never; tokens held against (b)'s by the same fork rule;
   l. scheduler (slice 15), on (b)'s engine: the continuous-batching
      ``Scheduler`` (four lanes, bursts of 8 steps, 32 with nothing
      queued, gangs of 1024 prefill tokens, prefix cache and swap on):
      eight greedy requests of 40-300 prompt tokens (the two 128-token
      ones sharing the 64-token one's page) and 32-48 new ones, in three
      waves (before ticks 0, 2 and 5), the pool shrunk to 7 pages so the
      first wave's growth swaps the youngest request out, then grown back
      by ``resize``: every request finished, each stream bit for bit
      against its prompt as a row of ``generate_batch_fused`` over four
      prompts (the lanes' row count) and against its ``generate`` alone
      up to a fork, the fork within (b)'s logit limit and the fork rule;
      a sentinel run of the first wave whose swap-ins write one page
      below their pages must fail both; a swap with no chunk forward after the swap-in, a
      prefix-cache hit, the allocator back where it was, every burst run
      under ``torch.cuda.set_sync_debug_mode("error")``, and exact launch
      counts from the forwards it ran (T=1: B3 and B2 a layer; a chunk: B1
      and B4, or B5); wall, tokens/s, TTFT, ticks, bursts, hits, the
      allocator's host time and its calls replayed on both allocators; B2
      at one burst's ragged lengths beside B7 and SDPA, and one burst
      profiled.
      Then the spec burst (``spec_k`` 8) on the token-repeating weights,
      whose streams must equal the plain burst's, with an accepted draft
      and exact launch counts (B5 for each verify), and a seeded sampled
      request (T 0.8) alone and beside three joining mid-decode, whose
      tokens must be identical;
   m. beam (slice 16, ``bench.py --mode beam``), on (b)'s weights (an
      engine with the beam pool, ``beam_burst_max * W`` more pages, built
      on (b)'s params: no second copy, memory printed before and after):
      ``BeamSearcher`` of width 4 on a 64-token prompt, 32 tokens, in
      device bursts (no host read inside, ``.item()`` raising) and per
      step, token for token equal; width 1 against ``generate``; every
      row's cumulative log-prob after each token against the replay of
      its tokens through the same route (the prompt prefilled once and
      copied into the rows, decode steps at batch 4) within 1e-3, for the
      search on the kernels and the same search through the plain
      versions; every token's log-prob against the plain versions'
      teacher-forced one within (b)'s logit limit; a sentinel run with
      the copy-on-write copies skipped must fail the first; each
      hypothesis's cumulative log-prob against ``score_candidates_nll``
      of its tokens through the plain versions, and the kernels' mean
      signed log-prob difference from the plain versions' on both
      searches' tokens, printed; every page back; exact launch counts a beam step (B3 and B2
      32, B10 128, the head's B11 1, B1 0); ``LogProbScorer`` over the
      hypotheses, batch against one at a time; tokens/s, the bursts'
      lengths and one burst's busy share; then 8 ``decode_scored`` steps
      at B=4 (32 B1 score launches a step; logits against
      ``decode_forced`` on a twin state within (b)'s limit; every layer's
      scores against the plain version on the same inputs);
   n. server (slice 17), on (b)'s engine once (l)'s schedulers and (m)'s
      searchers are released: ``BasicServer(core=ServerCore(cfg,
      engine=eng))`` on loopback, driven with ``http.client``: ``GET
      /healthz``; a lone greedy ``POST /generate`` (a 64-byte prompt made
      from the seed, 32 tokens, EOS 257), its tokens bit for bit those of
      the same ids alone on a ``Scheduler`` with the same
      ``SamplingParams``, its device busy time by
      ``utils/profiling.traced_device_s`` above 0 and at most its wall;
      four concurrent ``POST /stream_generate`` (40-192 bytes, one with
      ``?sse=1``) and a ``POST /generate_batch`` of the same four: every
      frame parsed, each stream ended by its ``finish_reason`` frame (SSE
      by ``event: done``), each request against ``generate`` alone by
      (l)'s fork rule within (b)'s limit, and the same check with two
      requests' references swapped failing; ``POST /stream_chat_beam``
      (width 4, 16 tokens, rerank) equal to ``BeamSearcher`` plus
      ``Reranker(LogProbScorer)`` run directly, then again beside the four
      streams with every answer unchanged; 422 for ``max_new_tokens`` 0,
      404 for an unknown path; ``GET /metrics`` counting what the clients
      received, no failure and no live page; exact launch counts from
      the forwards the scheduler ran (the lone request and the concurrent
      ones) and those the beam request ran; tokens/s and TTFT;
   j. megakernel (slice 5, ``bench.py --megakernel``): (b)'s w8a8
      weights handed to an engine with ``megakernel`` and
      ``megakernel_drop_weights``, which packs each layer's chain and
      drops the per-op copies (its memory printed beside (b)'s): B14 in
      every decode layer (with B10 for layer 0's qkv and B11 for the head)
      and B15 for every prefill projection but layer 0's qkv; the checks
      of (b) (teacher-forced logits within (b)'s limit, the fused loop,
      ``generate_stream``, ``score_nll``, a profile) over 32 tokens
      (``MEGAKERNEL_STEPS``), and its tokens against (b)'s run by the
      fork rule;
   and slice 4's decode routes past B2, each at its preset's full width
   and depth ((h) cut to 16 layers since path (o)), random bf16 or w8a8
   weights from the seed, INT8 KV, page
   64, the pool ``bench.py`` sizes for 64 greedy tokens, of which (g) and
   (h) decode 32 (``DECODE_STEPS``):
   g. packed: ``tinyllama-1.1b`` (bf16 weights) on an unpadded pool
      (``pad_head_dim=False``, dh 64): B8 in every decode layer; batch 8,
      64-token random prompts;
   h. grouped-96: ``phi3-mini-4k`` (bf16 weights, dh 96, window 2047) on
      an unpadded pool: B6 in every decode layer; batch 4, 2,048-token
      random prompts (8 prefill chunks), so decode masks the keys before
      the window;
   i. long-context: ``llama3.1-8b`` (w8a8) at ``bench.py --mode longctx
      --prompt-len 32768``'s table (516 pages: past the INT8 scales
      budget of B2's route, so B6); one 32,768-token random prompt (128
      prefill chunks) and 16 greedy tokens (``LONG_STEPS``, a quarter of
      the other paths', for the script's time), prefilled once: the
      references teacher-force the decode steps from a copy of the
      kernels' prefilled pool (the plain run also serves the fork rule),
      and a profile of ``generate_batch_fused`` of 16 tokens resumed from
      that copy gives the busy share and B6's time per layer.
   o. hf-import (slice 18): ``gemma3-1b`` at full width and depth (26
      layers, D 1152, 4 q / 1 KV heads, dh 256, vocabulary 262144, a
      512-token window on five layers of six, dual-theta RoPE, qk-norm,
      GeGLU, a tied head) written from the seed as an HF checkpoint
      directory (``config.json``, two bf16 safetensors shards by this
      script's own writer, their index; weights drawn on the card at
      ``init_params``'s scales, norms zero-centred) and served from it:
      ``config_from_hf`` equal to the preset but for its name and EOS id,
      ``router.build_engine`` with ``weights_path`` the directory (the
      port's stream import, INT8 at import, w8a8), INT8 KV, page 64; one
      600-token prompt (3 chunks of 256, past the window) and three of
      64, 32 greedy tokens; exact launch counts (B1 and B4 26 a chunk, B2
      and B3 26 a decode step, B10 104 a forward, B6-B9 and B11 none: the
      tied head is a dense f32 product over the table widened to f32),
      tokens/s and TTFT p50, a profile of a 16-token fused run;
      teacher-forced logits within the path's limit, the SDPA reference
      passing, the FP8-q control and a second control, the same weights
      with every layer on the global RoPE table, failing. Phase 2 holds
      B1 at its last chunk and B2 at its decode step, each on a local
      and a global layer. ``hf_import_probe.py`` splits the kernels'
      logit gap by kernel and with activations left unquantized.
   and last, once every earlier engine is freed, slice 6's MoE path:
   k. moe: ``mixtral-8x7b`` (``bench.py --model mixtral-8x7b --quant
      int8-weight --batch 4 --prompt-len 256``) at full width, 16 of its
      32 layers and 8 greedy tokens (``MOE_LAYERS``, ``MOE_STEPS``, for
      the script's time),
      INT8 experts: the 256-token prefill chunk routes 4 x 256 x 2 = 2048
      = 8 x 256 slots, so it takes the sorted dispatch (B13 twice a
      layer, on the fused ``we_gu`` and on ``we_down``) and each decode
      step the masked expert loop (B11 sixteen times a layer); exact
      launch counts for the run and for a prefill chunk alone, the
      build's memory and peak, the dispatch held against the masked loop
      on one layer's activations from the real prefill, the (layer,
      token) routing decisions that differ between the kernels' and the
      plain run, and the checks of (b) (score_nll included).
   On paths (a)-(d), (g), (h) and (k) the same prompts are then
   teacher-forced through the
   kernels, the plain versions, an SDPA reference (SDPA attention and,
   for quantized weights, products computed another way: B10's and
   B11's library products above, B12 one product per K-group) and a
   lower-precision control (the last three are references this script
   defines; the port has no such option): the kernels and the reference
   must stay within the path's logit limit, the control must not; (a)
   also with f32 weights and activations, whose kernels' run has exact
   launch counts too (its f32 chunks take B1's SIMT kernel: the count
   in that kernel's row). For (a), (b), (g), (h) and
   (k) the
   fused loop is held against the step path's tokens and against the
   plain fused loop, and ``generate_stream`` against the fused loop on a
   lone prompt, and one fused run is profiled; (b) also holds
   ``Engine.score_nll`` against the plain path.
4. A ``{"paths": ...}`` summary line, a ``{"kernels": [...]}`` line, the
   card's line, then ``{"ok": true, "device": {...}}`` as the last line.

Exits non-zero with no ok line if any phase fails, if there is no CUDA
card, or if the port's package is not beside this script.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

T_START = time.perf_counter()
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
#: fail) at each path's depth; see PERF.md
TOL = {("none", "bf16"): 0.06, ("none", "f32"): 0.005,
       ("int8", "bf16"): 0.25, ("int8-weight", "bf16"): 0.06,
       ("int4", "bf16"): 0.06,
       # slice 4's paths, by name
       ("packed", "bf16"): 0.05, ("grouped-96", "bf16"): 0.10,
       ("long-context", "bf16"): 0.25,
       # slice 6's MoE path (its references follow the kernels' routing)
       ("moe", "bf16"): 0.25,
       # slice 18's imported Gemma-3-1B (w8a8): its kernels read 4.35% of
       # max|logit| and its FP8-q control 5.26%; on this model any
       # rounding is amplified to ~3% (SDPA 3.17%, B2's reordered sums
       # alone 2.93%), B1's bf16 P adds the rest, and an FP8 query clears
       # that floor only just (hf_import_probe.py; PERF.md §6), so the
       # global-table control and phase 2's rows at (o)'s shapes are its
       # discriminating checks
       ("hf-import", "bf16"): 0.048}
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


def phase(title: str) -> None:
    """A phase's header, with the seconds since the script started."""
    print(f"== phase {title} (at {time.perf_counter() - T_START:.1f} s)",
          flush=True)


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
    to three times, as is one with fewer matching kernel records than
    calls, and then the call is timed by CUDA events
    (:func:`cuda_ms`, host issue included), which the output says."""
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
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and any(m in e.key for m in match)]
        total_us = sum(getattr(e, "self_device_time_total", 0.0)
                       for e in rows)
        # every call launches at least one matching kernel: a trace with
        # fewer records than calls lost some
        if total_us > 0 and sum(e.count for e in rows) >= iters:
            return total_us / iters / 1e3
        what = " / ".join(m for m in match if m) or "the call"
        print(f"  (trace {attempt + 1} held no or too few kernel records "
              f"for {what}; tracing again)", flush=True)
    ms = cuda_ms(fn, iters)
    print(f"  (no trace held device time for {what}: {ms:.4f} ms a call "
          "by CUDA events, host issue included)", flush=True)
    return ms


def bound(bytes_moved: float, flops: float, rate: str = "f32"):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[rate] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


#: the tensor-core kernels' sources and symbols: B13, B1, the INT8
#: kernel of B10 (M > 16) and B15 (w8a8), one header built into two
#: sources, B11's (M > 16, bf16 x) on B13's mainloop and B12's (M > 16,
#: bf16 x) on its INT4 variant (all wgmma); and the warp-product (mma.sync)
#: kernels: B11's and B12's decode gemv and B14
TENSOR_CORE_KERNELS = [("gmm.cu", "wgmma_kernel"),
                       ("paged_prefill.cu", "attention_wgmma_kernel"),
                       ("int8_matmul.cu", "wgmma_s8_kernel"),
                       ("chain_linear.cu", "wgmma_s8_kernel"),
                       ("int8_matmul.cu", "w8_wgmma_kernel"),
                       ("int4_matmul.cu", "w4_wgmma_kernel"),
                       ("int8_matmul.cu", "gemv_w8_kernel"),
                       ("int4_matmul.cu", "gemv_w4_kernel"),
                       ("chain_linear.cu", "chain_kernel")]
#: kernels reported beside them that run no tensor-core product: B2's and
#: B9's split-KV kernels (pages by bulk copy: UBLKCP) and B4's
COPY_KERNELS = [("paged_attention.cu", "decode_split_kernel"),
                ("paged_attention.cu", "decode_append_split_kernel"),
                ("kv_append.cu", "append_prefill_kernel")]


def tensor_core_report(log, built):
    """Phase 1's report on the tensor-core kernels: ptxas's registers,
    static shared memory and spills of each instance (from the build's
    ``-Xptxas -v`` log; their shared memory is dynamic, set at launch),
    and, where ``cuobjdump`` is found, the count of wgmma (HGMMA for
    bf16, IGMMA for INT8), TMA (UTMALDG) and bulk-copy (UBLKCP)
    instructions in its SASS, and the warp products (HMMA for bf16, IMMA
    for INT8, from mma.sync) of the gemv kernels and B14; the same for
    :data:`COPY_KERNELS`. Fails on a wgmma serialization warning
    (C7510-C7520) in the build log, where a tensor-core kernel's SASS holds
    no tensor-core product, and where a split-KV kernel's holds no bulk
    copy."""
    import re
    import shutil

    symbols = {sym for _, sym in TENSOR_CORE_KERNELS + COPY_KERNELS}
    serialized = re.findall(r"[^\n]*C75(?:0\d|1\d|20)[^\n]*", log)
    check(not serialized, "ptxas serialized wgmma: " + "; ".join(serialized))
    for m in re.finditer(r"Compiling entry function '([^']+)'.*?"
                         r"(\d+) bytes spill stores, (\d+) bytes spill "
                         r"loads\s*\nptxas info\s*: Used (\d+) registers"
                         r"([^\n]*)", log, re.S):
        name = m.group(1)
        if not any(k in name for k in symbols):
            continue
        smem = re.search(r"(\d+) bytes smem", m.group(5))
        name = name[min(name.find(k) for k in symbols if k in name):]
        print(f"  ptxas {name[:64]}: {m.group(4)} registers, "
              f"{smem.group(1) if smem else 0} bytes static shared "
              f"memory, spills {m.group(2)} / {m.group(3)} bytes "
              "(stores / loads)", flush=True)
    tool = shutil.which("cuobjdump") or (
        "/usr/local/cuda/bin/cuobjdump"
        if os.path.exists("/usr/local/cuda/bin/cuobjdump") else None)
    if tool is None:
        print("  SASS instruction counts: not available (no cuobjdump)",
              flush=True)
        return
    dumps = sass_dumps(tool, built, {src for src, _ in
                                     TENSOR_CORE_KERNELS + COPY_KERNELS})
    for source, symbol in TENSOR_CORE_KERNELS + COPY_KERNELS:
        rc, functions = dumps[source]
        if rc != 0:
            print(f"  SASS of {source}: not available (cuobjdump {rc})",
                  flush=True)
            continue
        for fn in functions:
            name = fn.split("\n", 1)[0].strip()
            if symbol not in name:
                continue
            found = collections.Counter(re.findall(SASS_OPS, fn))
            counts = {op: found[op] for op in ("HGMMA", "IGMMA", "HMMA",
                                               "IMMA", "UTMALDG", "UBLKCP",
                                               "LDGSTS")}
            print(f"  SASS {source} {name[name.find(symbol):][:64]}: "
                  f"{counts}", flush=True)
            if (source, symbol) in COPY_KERNELS:
                check("decode" not in symbol or counts["UBLKCP"] > 0,
                      f"{name}: no bulk copy in its SASS")
                continue
            check(counts["HGMMA"] + counts["IGMMA"] + counts["HMMA"]
                  + counts["IMMA"] > 0,
                  f"{name}: no tensor-core product in its SASS")


#: the SASS instructions the report counts, in one pass over a function
SASS_OPS = r"\b(HGMMA|IGMMA|HMMA|IMMA|UTMALDG|UBLKCP|LDGSTS)\b"


def sass_dumps(tool, built, sources):
    """``{source: (cuobjdump's exit code, the SASS of each function)}``,
    one disassembly a library, all run at once (each into a file of its
    own, so that no pipe holds another back)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for source in sorted(sources):
            out = open(os.path.join(tmp, source + ".sass"), "w")
            procs[source] = (out, subprocess.Popen(
                [tool, "-sass", str(built[source])], stdout=out,
                stderr=subprocess.DEVNULL))
        dumps = {}
        for source, (out, proc) in procs.items():
            rc = proc.wait(timeout=300)
            out.close()
            with open(out.name) as f:
                dumps[source] = (rc, f.read().split("Function : ")[1:])
    return dumps


# -- phase 2: kernels against their plain versions -------------------------

B, KH, G, DH, PAGE, L, NUM_PAGES, MP = 4, 8, 4, 128, 64, 2, 80, 5
H = KH * G
#: the spec path's draft length and n-gram (bench.py --mode spec)
SPEC_K, SPEC_NGRAM = 8, 2
#: each wrapper's CUDA kernels, as the profiler names them
KERNEL_NAMES = {
    "paged_attention": ("paged_attention_kernel<",),
    "paged_attention_wgmma": ("attention_wgmma_kernel<",),
    "paged_attention_decode": ("decode_split_kernel<",),
    "kv_append_decode": ("append_decode_kernel",),
    "kv_append_prefill": ("append_prefill_kernel",),
    "kv_append_tokens": ("append_tokens_kernel",),
    "paged_attention_decode_append": ("decode_append_split_kernel<",),
    "paged_attention_decode_grouped": ("decode_grouped_split_kernel<",),
    "paged_attention_decode_packed": ("decode_packed_split_kernel<",),
    "paged_attention_decode_batched": ("decode_batched_split_kernel<",),
    "int8_matmul": ("qmm::gemv_kernel<0,", "imma::wgmma_s8_kernel<0,"),
    "w8_matmul": ("qmm::gemv_w8_kernel<", "qmm::tiled_kernel<1,",
                  "w8::w8_wgmma_kernel<"),
    "w4_matmul": ("qmm::gemv_w4_kernel<", "qmm::tiled_kernel<2,",
                  "w4::w4_wgmma_kernel<"),
    "chain_decode": ("chain::chain_kernel<",),
    "packed_linear": ("chain::packed_kernel<", "imma::wgmma_s8_kernel<1,"),
    "grouped_matmul": ("gmm::wgmma_kernel<", "gmm::f32_kernel<")}
#: the quantized products among them (B10, B11, B12, B15), whose device
#: time a profile sums as "its quantized products"
QUANT_PRODUCTS = ("int8_matmul", "w8_matmul", "w4_matmul", "packed_linear")


def make_pool(torch, gen, dtype, dev, batch=B, kv_heads=KH, dh=DH, mp=MP,
              num_pages=NUM_PAGES):
    """A random pool [L, 2, KH, P, page, dh] (+ flat INT8 scales) and a
    block table [batch, mp] of distinct non-dump pages."""
    shape = (L, 2, kv_heads, num_pages, PAGE, dh)
    if dtype == torch.int8:
        vals = torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)
        R = -(-num_pages * PAGE // 128)
        scales = (torch.rand((L, 2, kv_heads, R, 128), generator=gen,
                             device=dev) * 0.02 + 0.005)
        kv = (vals, scales)
    else:
        kv = (torch.randn(shape, generator=gen, device=dev).to(dtype),)
    perm = torch.randperm(num_pages - 1, generator=gen, device=dev) + 1
    bt = perm[:batch * mp].reshape(batch, mp).to(torch.int32)
    return kv, bt


def dense_kv(torch, kv, bt, layer, seq_len_max):
    """Dequantized [B, KH, S, dh] K and V gathered through the table."""
    _, _, kh, n_pages, page, dh = kv[0].shape
    vals = kv[0][layer].float()
    if len(kv) == 2:
        sc = kv[1][layer].reshape(2, kh, -1)[:, :, :n_pages * page]
        vals = vals * sc.reshape(2, kh, n_pages, page, 1)
    g = vals[:, :, bt.long()].reshape(2, kh, bt.shape[0], -1, dh)
    g = g[:, :, :, :seq_len_max].permute(0, 2, 1, 3, 4)
    return g[0], g[1]


def attention_checks(torch, F_, dev, results):
    from importlib import import_module

    pa = import_module(f"{PKG}.ops.paged_attention")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    rows = {}
    worst = {"paged_attention": 0.0, "paged_attention_wgmma": 0.0,
             "paged_attention_decode": 0.0}
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
        # the spec path's verify chunk: T = spec_k + 1 from offsets off
        # the page grid, seq_lens = q_offsets + T
        ("verify chunk", "paged_attention", torch.bfloat16, torch.int8,
         SPEC_K + 1, [79, 102, 120, 136], [70, 93, 111, 127], 0, 0.0,
         2e-2),
        ("prefill bf16 pool f32", "paged_attention", torch.float32,
         torch.bfloat16, 64, [64, 57, 1, 40], [0] * 4, 0, 0.0, 1e-4),
        # f32 queries take B1's SIMT kernel (prefill_route): its row in the
        # kernels line
        ("prefill f32 slice", "paged_attention", torch.float32, torch.int8,
         64, [64] * 4, [0] * 4, 0, 0.0, 1e-4),
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
            # B1's two kernels, by the wrapper's own route
            kname = {"wgmma": "paged_attention_wgmma", "simt":
                     "paged_attention"}[pa.prefill_route(qdt, pdt, DH, PAGE)]
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
        if qdt == torch.bfloat16 or kname == "paged_attention":
            worst[kname] = max(worst[kname], err)
        if name.endswith("slice") or name == "verify chunk":
            rows[name] = (kname, args, common, kern, plain, kv, bt, q, lens,
                          qo, T, sl)
    # the slice shapes go to the kernels line; the verify chunk is printed
    for name, row in rows.items():
        kname, args, common, kern, plain, kv, bt, q, lens, qo, T, sl = row
        ms = device_ms(lambda: kern(*args, **common),
                       match=KERNEL_NAMES[kname])
        call_ms = cuda_ms(lambda: kern(*args, **common))
        plain_ms = device_ms(lambda: plain(*args, **common))
        # bytes: q in + out, every K/V row (with its scale) some query
        # can see, the table and lengths; flops: QK and PV over visible
        # pairs
        pairs = 0
        seen = 0
        for b in range(B):
            if qo is None:                          # decode
                pairs += lens[b]
                seen += lens[b]
            else:
                for t in range(T):
                    pairs += max(0, min(qo[b] + t + 1, lens[b]))
                seen += max(0, min(qo[b] + T, lens[b]))
        pairs *= KH * G
        kv_bytes = seen * KH * 2 * (DH * kv[0].element_size()
                                    + 4 * (len(kv) - 1))
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
        if name.endswith("slice"):
            results[kname].update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                  bound_by=b_by, library_ms=lib_ms,
                                  max_abs_err=worst[kname],
                                  tol=1e-4 if q.dtype == torch.float32
                                  else 2e-2)
        print(f"  [{kname}] {name}, device time: kernel {ms:.4f} ms "
              f"(one wrapper call {call_ms:.4f} ms wall), plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), sdpa "
              f"{lib_ms:.4f} ms", flush=True)


#: B1 at path (h)'s last prefill chunk (phi3-mini-4k: 32 KV heads, G 1,
#: dh 96, window 2047; 4 x 256 queries at offset 1792 over 2,048 keys,
#: 34 pages a table) and path (i)'s chunks (llama3.1-8b: 8 KV heads, G 4,
#: dh 128; one sequence of 256 queries at 256 c over 256 (c + 1) keys,
#: 516 pages a table), INT8 pools, page 64
B1_H = dict(batch=4, kv_heads=32, G=1, dh=96, mp=34, T=256, offset=1792,
            window=2047)
B1_I = dict(batch=1, kv_heads=8, G=4, dh=128, mp=516, T=256, window=0)
B1_I_CHUNKS = (0, 32, 64, 127)
#: path (o)'s last prefill chunk (Gemma-3-1B: KH 1, G 4, dh 256): 4 x 256
#: queries at offset 512 over 600 keys (10 pages), on a local layer's
#: 512-token window and on a global layer's full context
B1_O = dict(batch=4, kv_heads=1, G=4, dh=256, mp=10, T=256, offset=512,
            keys=600)
#: path (i)'s B1 time, estimated from the four chunks (filled by
#: :func:`b1_shape_checks`, printed beside the measured prefill)
B1_LONG = {}


def b1_case(torch, gen, dev, batch, kv_heads, G, dh, mp, T, offset, window,
            keys=None):
    """A one-layer INT8 pool [1, 2, KH, batch * mp + 1, 64, dh], its
    tables (distinct random pages) and bf16 queries of a chunk of T at
    ``offset``, every sequence ``keys`` long (default ``offset + T``; a
    shorter one leaves the chunk's last queries past its end, as a
    prompt's last chunk does)."""
    n_pages = batch * mp + 1
    vals = torch.randint(-127, 128, (1, 2, kv_heads, n_pages, PAGE, dh),
                         generator=gen, device=dev, dtype=torch.int8)
    R = -(-n_pages * PAGE // 128)
    scales = (torch.rand((1, 2, kv_heads, R, 128), generator=gen,
                         device=dev) * 0.02 + 0.005)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    bt = perm[:batch * mp].reshape(batch, mp).to(torch.int32)
    q = torch.randn((batch, T, kv_heads * G, dh), generator=gen,
                    device=dev).to(torch.bfloat16)
    sl = torch.full((batch,), offset + T if keys is None else keys,
                    dtype=torch.int32, device=dev)
    qo = torch.full((batch,), offset, dtype=torch.int32, device=dev)
    kw = dict(page_size=PAGE, num_q_heads=kv_heads * G, window=window,
              softcap=0.0, scale=dh ** -0.5)
    return (q, vals, bt, sl, qo, scales, 0), kw


def b1_bound(args, window):
    """B1's least time on these inputs: every visible (query, key) pair's
    two products at the bf16 rate, against q in, out, each key some query
    sees (K and V rows with their scales) and the tables."""
    q, vals, bt, sl, qo = args[:5]
    B, T, H, D = q.shape
    KH = vals.shape[2]
    pairs = seen = 0
    for b in range(B):
        off, n = int(qo[b]), int(sl[b])
        for t in range(T):
            lo = max(0, off + t - window + 1) if window > 0 else 0
            pairs += max(0, min(off + t + 1, n) - lo)
        seen += min(off + T, n) - (max(0, off - window + 1) if window > 0
                                   else 0)
    bytes_moved = (2 * q.numel() * 2 + seen * KH * 2 * (D + 4)
                   + 4 * (bt.numel() + 2 * B))
    return bound(bytes_moved, 4 * D * pairs * H, "bf16")


def sdpa_chunk(torch, F_, args, kw):
    """The chunk as one scaled_dot_product_attention call over a dense,
    dequantized copy of the keys it may see (bf16, heads repeated for
    GQA): the library yardstick, never called by the port."""
    q, vals, bt, sl, qo, scales, layer = args
    B, T, H, D = q.shape
    KH, page = vals.shape[2], vals.shape[4]
    n = int(sl.max())
    g = vals[layer][:, :, bt.long()].reshape(2, KH, B, -1, D)[:, :, :, :n]
    slots = (bt.long()[:, :, None] * page + torch.arange(
        page, device=q.device)).reshape(B, -1)[:, :n]
    sc = scales[layer].reshape(2, KH, -1)[:, :, slots]
    g = (g.float() * sc[..., None]).to(q.dtype)          # [2, KH, B, n, D]
    k, v = (x.permute(1, 0, 2, 3).repeat_interleave(H // KH, dim=1)
            for x in (g[0], g[1]))
    qpos = qo.long()[:, None] + torch.arange(T, device=q.device)
    key = torch.arange(n, device=q.device)
    mask = (key <= qpos[:, :, None]) & (key < sl.long()[:, None, None])
    if kw["window"] > 0:
        mask &= key > qpos[:, :, None] - kw["window"]
    qh = q.transpose(1, 2)
    return lambda: F_.scaled_dot_product_attention(
        qh, k, v, attn_mask=mask[:, None], scale=kw["scale"])


def b1_simt(torch, pa, args, kw):
    """B1's SIMT kernel (the only B1 kernel before the tensor-core one) on
    the same bf16 inputs, launched as the wrapper launches it: the old
    kernel's time beside the new one's in the same run (the wrapper's
    route sends bf16 queries to the tensor-core kernel)."""
    from importlib import import_module

    plat = import_module(f"{PKG}.utils.platform")
    q, pool, bt, sl, qo, scales, layer = args
    B, T, H, D = q.shape
    out = torch.empty_like(q)
    pa.ATTENTION.launch(
        plat.ptr(q), plat.ptr(out), plat.ptr(pool), plat.ptr(scales),
        plat.ptr(bt), plat.ptr(sl), plat.ptr(qo), None, 0, B, T, H,
        pool.shape[2], D, pool.shape[3], pool.shape[4], bt.shape[1], layer,
        scales.shape[3] * 128, kw["scale"], kw["softcap"], kw["window"],
        plat.DTYPE_CODES[q.dtype], plat.DTYPE_CODES[pool.dtype],
        plat.stream_handle(q))
    return out


def b1_shape_checks(torch, F_, dev, results):
    """B1's tensor-core kernel at path (h)'s last chunk, path (i)'s
    chunks 0, 32, 64 and 127 and path (o)'s last chunk (window 512 and
    none), each against its plain version at 2e-2 of max|plain|, with
    device time, bound and SDPA time; path (i)'s B1 time over its 128
    chunks and 32 layers by linear interpolation between the four; and
    the misread control: two page ids of one sequence's table swapped
    must move the plain output past 2e-2 of max|plain| (at (i)'s chunk
    0, where a page is a quarter of the keys, and at each of (o)'s
    chunks, pages 8 and 9 of 10)."""
    from importlib import import_module

    pa = import_module(f"{PKG}.ops.paged_attention")
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    kname = "paged_attention_wgmma"
    shapes = [("(h) last chunk", B1_H)] + [
        (f"(i) chunk {c}", dict(B1_I, offset=256 * c)) for c in B1_I_CHUNKS
    ] + [("(o) last chunk, window 512", dict(B1_O, window=512)),
         ("(o) last chunk, global layer", dict(B1_O, window=0))]
    # the misread controls: two page ids of sequence 0's table swapped
    swaps = {"(i) chunk 0": [0, 3], "(o) last chunk, window 512": [8, 9],
             "(o) last chunk, global layer": [8, 9]}
    times, old_times = {}, {}
    for label, shape in shapes:
        args, kw = b1_case(torch, gen, dev, **shape)
        route = pa.prefill_route(args[0].dtype, args[1].dtype,
                                 args[0].shape[3], PAGE)
        check(route == "wgmma", f"B1 {label}: routed to {route}")
        plat_k = pa.ATTENTION_WGMMA
        before = plat_k.launches
        out = pa.paged_attention(*args, **kw)
        torch.cuda.synchronize()
        check(plat_k.launches == before + 1,
              f"B1 {label}: the tensor-core kernel was not launched")
        ref = pa.paged_attention_plain(*args, **kw)
        err = (out.float() - ref.float()).abs().max().item()
        top = ref.float().abs().max().item()
        tol = 2e-2 * top
        ok = err <= tol and bool(torch.isfinite(out).all())
        print(f"  [{kname}] {label} (B={shape['batch']}, T={shape['T']}, "
              f"KH={shape['kv_heads']}, G={shape['G']}, dh={shape['dh']}, "
              f"{int(args[3][0])} keys): max|kernel-plain| = {err:.3e} "
              f"(tol {tol:.3e} = 2e-2 of max|plain| {top:.3f}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"{kname} {label}: error {err} > {tol}")
        results[kname]["max_abs_err"] = max(
            results[kname].get("max_abs_err") or 0.0, err)
        swap = swaps.get(label)
        if swap:
            moved_bt = args[2].clone()
            moved_bt[0, swap] = args[2][0, swap[::-1]]
            moved = pa.paged_attention_plain(
                *((args[0], args[1], moved_bt) + args[3:]), **kw)
            d = (moved.float() - ref.float()).abs().max().item()
            print(f"  [{kname}] {label}: pages {swap[0]} and {swap[1]} of "
                  f"the table swapped move the plain output by {d:.3e} "
                  f"({'beyond' if d > tol else 'WITHIN'} the tolerance)",
                  flush=True)
            check(d > tol, f"B1 {label}: a misread table stays within "
                  "the tolerance")
            del moved
        del out, ref
        ms = device_ms(lambda: pa.paged_attention(*args, **kw), iters=10,
                       match=KERNEL_NAMES[kname])
        b_ms, b_by = b1_bound(args, kw["window"])
        lib = sdpa_chunk(torch, F_, args, kw)
        lib_ms = device_ms(lib, iters=10)
        del lib
        old = b1_simt(torch, pa, args, kw)
        old_err = (old.float() - pa.paged_attention_plain(
            *args, **kw).float()).abs().max().item()
        check(old_err <= tol, f"B1 {label}: the SIMT kernel differs from "
              f"plain by {old_err}")
        old_ms = device_ms(lambda: b1_simt(torch, pa, args, kw), iters=3,
                           match=KERNEL_NAMES["paged_attention"])
        times[label] = ms
        old_times[label] = old_ms
        print(f"  [{kname}] {label} device time: kernel {ms:.4f} ms, bound "
              f"{b_ms:.5f} ms ({b_by}; {b_ms / ms:.3f} of it reached), sdpa "
              f"{lib_ms:.4f} ms; the SIMT kernel on the same inputs "
              f"{old_ms:.4f} ms (max|SIMT-plain| {old_err:.3e})", flush=True)
        del args
        torch.cuda.empty_cache()
    xs = list(B1_I_CHUNKS)

    def over_prefill(t):
        ys = [t[f"(i) chunk {c}"] for c in xs]
        per_layer = 0.0
        for c in range(128):
            j = min(max(i for i, x in enumerate(xs) if x <= c), len(xs) - 2)
            per_layer += ys[j] + (ys[j + 1] - ys[j]) * (c - xs[j]) / (
                xs[j + 1] - xs[j])
        return per_layer * 32

    B1_LONG["ms"] = over_prefill(times)
    B1_LONG["simt_ms"] = over_prefill(old_times)
    print(f"  [{kname}] path (i)'s prefill: 128 chunks x 32 layers of B1, "
          f"by linear interpolation between chunks {xs}: "
          f"{B1_LONG['ms'] / 1e3:.3f} s (the SIMT kernel: "
          f"{B1_LONG['simt_ms'] / 1e3:.3f} s)", flush=True)


#: B1's per-page score export against its plain version: scores within
#: this fraction of max|score| (f32 sums of the same terms in another
#: order; the dead pages are compared exactly)
TOL_B1_SCORES = 1e-4
#: the shapes: (label, q dtype, page, T, seq_lens, q_offsets, window,
#: softcap); INT8 pools of B=4, KH=8, G=4, dh=128 over 320-key tables
B1_SCORE_CASES = [
    ("decode_scored", "bfloat16", 64, 1, [65, 90, 128, 101],
     [64, 89, 127, 100], 0, 0.0),
    ("verify chunk", "bfloat16", 64, SPEC_K + 1, [79, 102, 120, 136],
     [70, 93, 111, 127], 0, 0.0),
    ("window+softcap f32", "float32", 64, 3, [128, 100, 65, 300],
     [125, 97, 62, 297], 40, 30.0),
    ("page 16", "bfloat16", 16, 1, [65, 90, 128, 101], [64, 89, 127, 100],
     0, 0.0)]


def b1_score_checks(torch, F_, dev, results):
    """B1's per-page score export (``return_scores``) on both of its
    kernels against its plain version: slice 1's decode_scored shape (T=1,
    seq lens 65-128 over 5-page tables, so pages 2-4 are dead), the verify
    chunk (T=9 off the page grid), a window with a softcap on the SIMT
    kernel (f32 queries) and a page-16 pool: the scores within
    ``TOL_B1_SCORES`` of max|score|, the dead pages (``-1e30``) identical,
    the output the same bits as the same launch without the export, one
    score launch each. At the decode_scored shape B1 is timed with and
    without the export beside its bound and SDPA on the same inputs."""
    from importlib import import_module

    pa = import_module(f"{PKG}.ops.paged_attention")
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    layer = 1
    for label, qd, page, T, lens, qo, window, softcap in B1_SCORE_CASES:
        mp = 320 // page
        n_pages = B * mp + 1
        shape = (L, 2, KH, n_pages, page, DH)
        pool = torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)
        scales = torch.rand((L, 2, KH, -(-n_pages * page // 128), 128),
                            generator=gen, device=dev) * 0.02 + 0.005
        bt = (torch.randperm(n_pages - 1, generator=gen, device=dev)[
            :B * mp] + 1).reshape(B, mp).to(torch.int32)
        q = torch.randn((B, T, H, DH), generator=gen, device=dev).to(
            getattr(torch, qd))
        args = (q, pool, bt, torch.tensor(lens, dtype=torch.int32,
                                          device=dev),
                torch.tensor(qo, dtype=torch.int32, device=dev), scales,
                layer)
        kw = dict(page_size=page, num_q_heads=H, window=window,
                  softcap=softcap, scale=DH ** -0.5)
        kname = {"wgmma": "paged_attention_wgmma", "simt": "paged_attention"}[
            pa.prefill_route(q.dtype, pool.dtype, DH, page)]
        kern = pa.ATTENTION_WGMMA if kname.endswith("wgmma") else pa.ATTENTION
        bare = pa.paged_attention(*args, **kw)
        before = (kern.launches, kern.score_launches)
        out, scores = pa.paged_attention(*args, return_scores=True, **kw)
        _, ref = pa.paged_attention_plain(*args, return_scores=True, **kw)
        torch.cuda.synchronize()
        dead = ref <= -1e29
        live = ~dead
        top = ref[live].abs().max().item()
        err = (scores[live] - ref[live]).abs().max().item()
        same = torch.equal(out, bare)
        dead_ok = (torch.equal(scores <= -1e29, dead)
                   and bool((scores[dead] == -1e30).all()))
        ok = (same and dead_ok and err <= TOL_B1_SCORES * top
              and (kern.launches, kern.score_launches) == (before[0] + 1,
                                                          before[1] + 1))
        print(f"  [{kname}] scores, {label} (T={T}, page {page}, "
              f"{int(dead.sum())} of {dead.numel()} pages dead): "
              f"max|kernel-plain| {err:.3e} (tol {TOL_B1_SCORES:g} of "
              f"max|score| {top:.3f}), dead pages "
              f"{'identical' if dead_ok else 'DIFFERENT'}, output "
              f"{'the same bits' if same else 'CHANGED'} without the export "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"{kname} score export, {label}: error {err}, dead pages "
              f"{dead_ok}, output unchanged {same}")
        row = results[kname].setdefault("scores", {"tol": TOL_B1_SCORES})
        row["max_abs_err"] = max(row.get("max_abs_err", 0.0), err)
        if label != "decode_scored":
            continue
        match = KERNEL_NAMES[kname]
        ms = device_ms(lambda: pa.paged_attention(
            *args, return_scores=True, **kw), match=match)
        ms_off = device_ms(lambda: pa.paged_attention(*args, **kw),
                           match=match)
        call_ms = device_ms(lambda: pa.paged_attention(
            *args, return_scores=True, **kw))
        plain_ms = device_ms(lambda: pa.paged_attention_plain(
            *args, return_scores=True, **kw))
        # bytes: q in, out, the visible K/V rows and their scales, the
        # table and lengths, the scores out; operations: QK and PV over
        # the visible pairs
        seen = sum(lens)
        bytes_moved = (2 * q.numel() * q.element_size()
                       + seen * KH * 2 * (DH + 4) + 4 * (bt.numel() + 2 * B)
                       + 4 * scores.numel())
        b_ms, b_by = bound(bytes_moved, 4 * DH * seen * H, "bf16")
        lib = sdpa_chunk(torch, F_, args, kw)
        lib_ms = device_ms(lib)
        row.update(ms=ms, ms_without=ms_off, call_ms=call_ms,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=lib_ms)
        print(f"  [{kname}] scores, {label} device time: kernel with the "
              f"export {ms:.4f} ms, without {ms_off:.4f} ms, the wrapper's "
              f"whole call {call_ms:.4f} ms (the partial rows' max "
              f"included), plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms "
              f"({b_by}), sdpa {lib_ms:.4f} ms", flush=True)


def append_checks(torch, dev, results):
    from importlib import import_module

    ka = import_module(f"{PKG}.ops.kv_append")
    pool_mod = import_module(f"{PKG}.kvcache.pool")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    rng = np.random.default_rng(SEED + 2)
    layer = 1

    def prompt_chunk(c0, lens):         # prompt padding is -1
        ar = c0 + torch.arange(PAGE, device=dev)[None]
        lim = torch.tensor(lens, device=dev)[:, None]
        return torch.where(ar < lim, ar, -1).to(torch.int32)

    def decode_rows(lens):              # the new token sits at len - 1
        return torch.tensor([[n - 1] for n in lens], dtype=torch.int32,
                            device=dev)

    def verify(starts, T=SPEC_K + 1):   # T tokens from each lane's start
        return torch.tensor(            # (None: a frozen lane, all -1)
            [[-1] * T if s is None else list(range(s, s + T))
             for s in starts], dtype=torch.int32, device=dev)

    bf16, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    prefill_cases = [
        # name, pool dtype, positions [B, T]
        ("prefill slice", i8, prompt_chunk(0, [64] * 4)),
        ("prefill ragged", i8, prompt_chunk(0, [64, 57, 1, 40])),
        ("prefill 2nd chunk", i8, prompt_chunk(64, [128, 100, 65, 128])),
        ("prefill bf16 pool", bf16, prompt_chunk(0, [64, 57, 1, 40])),
        # a page-long chunk that starts off the page grid: the TPU's
        # whole-page B4 would write it to the wrong slots (ROADMAP C)
        ("page-long chunk off the page grid", i8,
         verify([5, 70, None, 130], PAGE)),
    ]
    # B3 and B5 take the model's rows: bf16 views of the fused qkv output
    # (the paths' layout), or contiguous f32 rows; every case carries the
    # edge rows (exact ties, an all-zero row, a negative absmax, the value
    # a reciprocal multiply would round to another code)
    row_cases = [
        # name, kernel, pool dtype, positions, rows dtype, packed, KV
        # heads, dh
        ("decode slice", "kv_append_decode", i8,
         decode_rows([65, 90, 128, 101]), bf16, True, KH, DH),
        ("decode invalid lane", "kv_append_decode", i8,
         decode_rows([65, 0, 128, 101]), bf16, True, KH, DH),
        ("decode f32 pool", "kv_append_decode", f32,
         decode_rows([1, 64, 200, 320]), f32, False, KH, DH),
        ("decode f32 rows", "kv_append_decode", i8,
         decode_rows([65, 90, 128, 101]), f32, False, KH, DH),
        ("decode dh 64", "kv_append_decode", i8,
         decode_rows([65, 90, 128, 101]), bf16, True, KH, 64),
        ("decode dh 96, KH 32", "kv_append_decode", i8,
         decode_rows([65, 90, 128, 101]), bf16, True, 32, 96),
        ("decode dh 256", "kv_append_decode", i8,
         decode_rows([65, 90, 128, 101]), bf16, True, KH, 256),
        # the spec path's verify chunk (T = spec_k + 1) from positions
        # 64-127, one lane frozen; and 5-token chunks across page ends
        ("verify slice", "kv_append_tokens", i8,
         verify([70, 93, None, 120]), bf16, True, KH, DH),
        ("verify bf16 pool", "kv_append_tokens", bf16,
         verify([64, 101, 127, None]), bf16, True, KH, DH),
        ("verify crossing pages", "kv_append_tokens", i8,
         verify([62, 127, 190, 255], 5), bf16, True, KH, DH),
        ("verify f32 rows", "kv_append_tokens", i8,
         verify([70, 93, None, 120]), f32, False, KH, DH),
        ("verify dh 64", "kv_append_tokens", i8,
         verify([70, 93, None, 120]), bf16, True, KH, 64),
        ("verify dh 96, KH 32", "kv_append_tokens", i8,
         verify([70, 93, None, 120]), bf16, True, 32, 96),
        ("verify dh 256", "kv_append_tokens", i8,
         verify([70, 93, None, 120]), bf16, True, KH, 256),
    ]
    wrappers = {"kv_append_decode": (ka.append_decode, ka.append_decode_plain),
                "kv_append_prefill": (ka.append_prefill,
                                      ka.append_prefill_plain),
                "kv_append_tokens": (ka.append_tokens,
                                     ka.append_tokens_plain)}
    timed = []
    for name, pdt, pos in prefill_cases:
        kv, bt = make_pool(torch, gen, pdt, dev)
        kv = tuple(x.zero_() for x in kv)
        T = pos.shape[1]
        k = torch.randn((B, T, KH, DH), generator=gen, device=dev)
        v = torch.randn((B, T, KH, DH), generator=gen, device=dev)
        news = pool_mod.stack_new_kv(kv, k, v)
        kv_k = append_case(torch, wrappers["kv_append_prefill"],
                           "kv_append_prefill", name, kv, (news,), layer,
                           pos, bt)
        if name.endswith("slice"):
            timed.append(("kv_append_prefill", "slice", kv_k, (news,), pos,
                          bt))
    edge = edge_rows_module()
    for name, kname, pdt, pos, rdt, packed, kh, dh in row_cases:
        kv, bt = make_pool(torch, gen, pdt, dev, kv_heads=kh, dh=dh)
        rows = model_rows(torch, rng, pos.shape[1], kh, dh, rdt, packed, dev,
                          edge)
        kv_k = append_case(torch, wrappers[kname], kname, name, kv, rows,
                           layer, pos, bt)
        if name.endswith("slice"):
            timed.append((kname, "slice", kv_k, rows, pos, bt))
            n = kernels_in_call(torch, lambda: ka.kv_append(
                kv_k, *rows, layer, pos, bt, page_size=PAGE))
            print(f"  [{kname}] one kv_append call (T={pos.shape[1]}, INT8 "
                  f"pool) issues {n} device kernel(s) (expected 1)",
                  flush=True)
            check(n == 1, f"{kname}: kv_append issued {n} kernels")
    # B4 at the chunks of paths (i), (h) and (k) (one 256-token chunk of a
    # prompt, in each lane), each on its path's table
    for name, batch, kh, dh, pdt, mp, n_pages, c0 in B4_CHUNKS:
        kv, bt = make_pool(torch, gen, getattr(torch, pdt), dev, batch, kh,
                           dh, mp, n_pages)
        k = torch.randn((batch, 256, kh, dh), generator=gen, device=dev)
        v = torch.randn((batch, 256, kh, dh), generator=gen, device=dev)
        news = pool_mod.stack_new_kv(kv, k, v)
        pos = (c0 + torch.arange(256, device=dev, dtype=torch.int32)
               ).expand(batch, 256).contiguous()
        kv_k = append_case(torch, wrappers["kv_append_prefill"],
                           "kv_append_prefill", name, kv, (news,), layer,
                           pos, bt)
        timed.append(("kv_append_prefill", name, kv_k, (news,), pos, bt))
    for kname, name, kv, args, pos, bt in timed:
        kern, plain = wrappers[kname]
        ms = device_ms(lambda: kern(kv, *args, layer, pos, bt),
                       match=KERNEL_NAMES[kname])
        call_ms = cuda_ms(lambda: kern(kv, *args, layer, pos, bt))
        plain_ms = device_ms(lambda: plain(kv, *args, layer, pos, bt),
                             iters=5)
        lib_ms = device_ms(append_library(torch, kv, args, layer, pos, bt))
        n_valid = int((pos >= 0).sum().item())
        row = kv[0].shape[2] * 2 * (kv[0].shape[5] * kv[0].element_size()
                                    + 4 * (len(kv) - 1))
        # bytes: the valid tokens' rows in (B3 / B5: their K and V rows in
        # the rows' dtype; B4: their stacked rows and scales), the same
        # rows and scales out, the positions and the table; operations:
        # B3 / B5 quantizing the valid rows into an INT8 pool (absmax,
        # division, rounding, clamp: 4 a value, f32). A frozen lane's rows
        # are not needed by the function, whatever the kernel loads.
        stacked = kname == "kv_append_prefill"
        values = n_valid * 2 * kv[0].shape[2] * kv[0].shape[5]
        rows_in = (n_valid * row if stacked else
                   values * args[0].element_size())
        quant_ops = 4 * values if not stacked and len(kv) == 2 else 0
        b_ms, b_by = bound(rows_in + n_valid * row
                           + 4 * (pos.numel() + bt.numel()), quant_ops)
        out = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=lib_ms)
        whole = ""
        if not stacked:
            out["call_ms"] = device_ms(lambda: ka.kv_append(
                kv, *args, layer, pos, bt, page_size=PAGE), match=("",))
            whole = (f"; the whole kv_append call {out['call_ms']:.4f} ms "
                     "(every kernel it launches)")
        if name == "slice":
            results[kname].update(max_abs_err=0.0, tol=0.0, **out)
        else:
            results[kname].setdefault("shapes", {})[name] = out
        what = ("index_copy_ of the rows" if stacked else
                "stack_new_kv, then index_copy_ of the valid rows")
        scales = " and of their INT8 scales" if len(kv) == 2 else ""
        print(f"  [{kname}] {name} shape, device time: kernel {ms:.4f} ms "
              f"(one wrapper call {call_ms:.4f} ms wall){whole}, plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}), library "
              f"{lib_ms:.4f} ms ({what} into the flattened pool{scales})",
              flush=True)
        del kv, args
    torch.cuda.empty_cache()


def edge_rows_module():
    """``tests/_kv_rows.py``: the rows that pin the quantization."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_kv_rows", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "tests", "_kv_rows.py"))
    edge = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(edge)
    return edge


def model_rows(torch, rng, T, kh, dh, dtype, packed, dev, edge, batch=B):
    """``k, v [batch, T, kh, dh]`` as the model hands them to the append:
    with ``packed``, views of one fused qkv output ``[batch, T, (H + 2 kh)
    * dh]`` (H = kh * G); else contiguous. Random from ``rng``, with the
    edge rows of ``edge`` (:func:`edge_rows_module`) planted."""
    heads = kh * G
    qkv = rng.normal(size=(batch, T, (heads + 2 * kh) * dh)).astype(
        np.float32)
    k = qkv[..., heads * dh:(heads + kh) * dh].reshape(batch, T, kh, dh)
    v = qkv[..., (heads + kh) * dh:].reshape(batch, T, kh, dh)
    edge.plant_edge_rows(rng, k, v)
    if not packed:
        return (torch.from_numpy(k.copy()).to(dev, dtype),
                torch.from_numpy(v.copy()).to(dev, dtype))
    t = torch.from_numpy(qkv).to(dev, dtype)
    return (t[..., heads * dh:(heads + kh) * dh].view(batch, T, kh, dh),
            t[..., (heads + kh) * dh:].view(batch, T, kh, dh))


def kernels_in_call(torch, fn) -> int:
    """The device kernels (and copies) one call of ``fn`` issues, from
    torch.profiler's device records (after one warm call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
        if n:
            return n
    return 0


#: B4's chunks on the paths past the slice: (name, batch, KV heads, dh,
#: pool dtype, table width, pool pages, chunk start): (i) Llama-3.1-8B's
#: 32k prompt (chunk 64 of 128), (h) Phi-3-mini's 2,048-token prompts
#: (chunk 3 of 8; bf16, dh 96: 192-byte rows) and (k) Mixtral-8x7B's
#: 256-token prompts
B4_CHUNKS = [
    ("(i) chunk: llama3.1-8b, B=1, T=256", 1, 8, 128, "int8", 516, 520,
     16384),
    ("(h) chunk: phi3-mini-4k, B=4, T=256, dh 96 bf16", 4, 32, 96,
     "bfloat16", 36, 150, 768),
    ("(k) chunk: mixtral-8x7b, B=4, T=256", 4, 8, 128, "int8", 7, 40, 0),
]


def append_case(torch, fns, kname, name, kv, args, layer, pos, bt):
    """An append kernel against its plain version on copies of ``kv``
    (``args``: B3's and B5's rows ``(k, v)``, B4's ``(news,)``): the
    pools must be equal bit for bit. Returns the kernel's pool."""
    kern, plain = fns
    kv_k = tuple(x.clone() for x in kv)
    kv_p = tuple(x.clone() for x in kv)
    kern(kv_k, *args, layer, pos, bt)
    plain(kv_p, *args, layer, pos, bt)
    torch.cuda.synchronize()
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(kv_k, kv_p))
    ok = err == 0.0
    print(f"  [{kname}] {name}: max|kernel-plain| over the pool = "
          f"{err:.3e} (tol 0, bit-exact) {'ok' if ok else 'FAIL'}",
          flush=True)
    check(ok, f"{kname} {name}: pool differs by {err}")
    return kv_k


def append_library(torch, kv, args, layer, pos, bt):
    """The library yardstick of an append, what its kernel replaces: for
    B3 and B5 (``args`` the rows) ``stack_new_kv`` and then, as for B4
    (``args`` the stacked news), ``index_copy_`` of the valid tokens' rows
    into the layer's pool flattened to rows, and for an INT8 pool a second
    ``index_copy_`` of their scales into the flat scales (the indices made
    here, outside the timed call; the rows picked by index inside it)."""
    from importlib import import_module

    pool_mod = import_module(f"{PKG}.kvcache.pool")
    _, _, kh, n_pages, page, dh = kv[0].shape
    batch, T = pos.shape
    valid = pos >= 0
    p = pos.clamp_min(0).long()
    flat = bt.long().gather(1, p // page) * page + p % page      # [B, T]
    keep = valid[:, None, :].expand(batch, 2 * kh, T)
    heads = torch.arange(2 * kh, device=pos.device)[None, :, None]
    idx = (heads * n_pages * page + flat[:, None, :])[keep]
    src = torch.arange(keep.numel(), device=pos.device)[keep.reshape(-1)]
    vals = kv[0][layer].view(-1, dh)
    stride = kv[1].shape[3] * 128 if len(kv) == 2 else 0
    sidx = (heads * stride + flat[:, None, :])[keep]
    scales = kv[1][layer].view(-1) if len(kv) == 2 else None
    if len(args) == 1:              # B4: the rows in their order, made here
        news = args[0]
        rows = news[0].reshape(-1, dh)[src]
        srows = news[1].reshape(-1)[src] if scales is not None else None
        if scales is None:
            return lambda: vals.index_copy_(0, idx, rows)
        return lambda: (vals.index_copy_(0, idx, rows),
                        scales.index_copy_(0, sidx, srows))

    def call():
        news = pool_mod.stack_new_kv(kv, *args)
        vals.index_copy_(0, idx, news[0].reshape(-1, dh)[src])
        if scales is not None:
            scales.index_copy_(0, sidx, news[1].reshape(-1)[src])
    return call


def decode_append_checks(torch, dev, results):
    """B9 against its plain version (the append's plain version, then
    B2's) at B2's shapes: the output within B2's tolerance, the pool
    bit-exact; with a stale row planted in each new token's slot (f32
    queries), which the plain version at ``seq_len + 1`` (that slot read
    as a key, the new token one slot on) must move past the tolerance.
    Timed at the slice and at a 512-page table at batch 1 (32,700 keys)
    beside its yardsticks on the same inputs: B2 alone, and ``kv_append``
    then B2 (the unfused decode step), both routes as whole calls."""
    from importlib import import_module

    pa = import_module(f"{PKG}.ops.paged_attention")
    ka = import_module(f"{PKG}.ops.kv_append")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    kname = "paged_attention_decode_append"
    bf16, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    layer, worst = 1, 0.0
    cases = [
        # name, q (and new K/V) dtype, pool dtype, batch, table width,
        # pool pages, seq lens after the append, window, softcap,
        # tolerance, a stale row planted in each new slot
        ("slice", bf16, i8, B, MP, NUM_PAGES, [65, 90, 128, 101], 0, 0.0,
         2e-2, False),
        ("f32", f32, i8, B, MP, NUM_PAGES, [65, 90, 128, 101], 0, 0.0, 1e-4,
         False),
        ("window+softcap f32", f32, i8, B, MP, NUM_PAGES, [65, 90, 128, 300],
         40, 30.0, 1e-4, False),
        ("f32 pool", f32, f32, B, MP, NUM_PAGES, [1, 64, 200, 320], 0, 0.0,
         1e-4, False),
        ("stale slot sentinel, f32", f32, i8, B, MP, NUM_PAGES,
         [65, 90, 128, 1], 0, 0.0, 1e-4, True),
        ("512 pages, B=1", bf16, i8, 1, 512, 520, [32700], 0, 0.0, 2e-2,
         False),
        ("512 pages, B=1, stale slot sentinel, f32", f32, i8, 1, 512, 520,
         [32700], 0, 0.0, 1e-4, True),
    ]
    for (name, qdt, pdt, batch, mp, n_pages, lens, window, softcap, tol,
         stale) in cases:
        kv, bt = make_pool(torch, gen, pdt, dev, batch, KH, DH, mp, n_pages)
        q = torch.randn((batch, 1, H, DH), generator=gen, device=dev).to(qdt)
        k = torch.randn((batch, 1, KH, DH), generator=gen, device=dev).to(qdt)
        v = torch.randn((batch, 1, KH, DH), generator=gen, device=dev).to(qdt)
        sl = torch.tensor(lens, dtype=torch.int32, device=dev)
        pos = (sl - 1)[:, None]
        if stale:
            plant_stale_rows(torch, kv, bt, q, lens, layer)
        common = dict(page_size=PAGE, num_q_heads=H, window=window,
                      softcap=softcap, scale=DH ** -0.5)
        kv_k = tuple(x.clone() for x in kv)
        kv_p = tuple(x.clone() for x in kv)
        out_k, _ = pa.paged_attention_decode_append(q, kv_k, k, v, bt, sl,
                                                    pos, layer, **common)
        out_p, _ = pa.paged_attention_decode_append_plain(
            q, kv_p, k, v, bt, sl, pos, layer, **common)
        torch.cuda.synchronize()
        err = (out_k.float() - out_p.float()).abs().max().item()
        pool_err = max((a.float() - b.float()).abs().max().item()
                       for a, b in zip(kv_k, kv_p))
        ok = (err <= tol and pool_err == 0.0
              and bool(torch.isfinite(out_k).all()))
        print(f"  [{kname}] {name}: max|kernel-plain| = {err:.3e} (tol "
              f"{tol:g}), over the pool {pool_err:.3e} (tol 0, bit-exact) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"{kname} {name}: error {err}, pool {pool_err}")
        if stale:
            # the stale rows read as keys: the plain version one slot on
            moved_kv = tuple(x.clone() for x in kv)
            moved, _ = pa.paged_attention_decode_append_plain(
                q, moved_kv, k, v, bt, sl + 1, pos + 1, layer, **common)
            miss = (moved.float() - out_p.float()).abs().amax(
                dim=(1, 2, 3)).min().item()
            print(f"  [{kname}] {name}: the stale slot read as a key moves "
                  f"every sequence's output by at least {miss:.3e} (tol "
                  f"{tol:g})", flush=True)
            check(miss > tol, f"{kname} {name}: the tolerance does not flag "
                  f"a stale key ({miss})")
            del moved_kv
        if qdt == bf16:
            worst = max(worst, err)
            row = b9_times(torch, pa, ka, q, kv_k, k, v, bt, sl, pos, layer,
                           common, lens)
            if name == "slice":
                results[kname].update(row)
            else:
                results[kname].setdefault("shapes", {})[name] = row
        del kv, kv_k, kv_p
        torch.cuda.empty_cache()
    results[kname].update(max_abs_err=worst, tol=2e-2)


def plant_stale_rows(torch, kv, bt, q, lens, layer):
    """Writes into slot ``seq_len - 1`` of each sequence, every KV head, a
    row that would dominate the output if read as a key: K along the sign
    of the head's mean query, V large (INT8: 127 at scales 0.05 and 0.1).
    In place."""
    vals = kv[0]
    kh = vals.shape[2]
    for b, n in enumerate(lens):
        pid, slot = int(bt[b, (n - 1) // PAGE]), (n - 1) % PAGE
        sign = torch.sign(q[b, 0].float().reshape(kh, -1, DH).mean(1))
        if vals.dtype == torch.int8:
            vals[layer, 0, :, pid, slot] = (sign * 127).to(torch.int8)
            vals[layer, 1, :, pid, slot] = 127
            flat = kv[1][layer].view(2, kh, -1)
            flat[0, :, pid * PAGE + slot] = 0.05
            flat[1, :, pid * PAGE + slot] = 0.1
        else:
            vals[layer, 0, :, pid, slot] = (sign * 4).to(vals.dtype)
            vals[layer, 1, :, pid, slot] = 8


def b9_times(torch, pa, ka, q, kv, k, v, bt, sl, pos, layer, common, lens):
    """B9's device time beside its plain version, its bound and its
    yardsticks on the same inputs: B2 alone, and the whole calls of both
    routes, every kernel each issues (B9's wrapper: ``stack_new_kv``'s
    glue and B9; the unfused step: ``kv_append``, B3 alone since slice
    14, and B2), with their kernel counts and wrappers' wall time, taken
    in turns."""
    kname = "paged_attention_decode_append"
    batch = q.shape[0]
    fused = lambda: pa.paged_attention_decode_append(q, kv, k, v, bt, sl,
                                                     pos, layer, **common)
    plain = lambda: pa.paged_attention_decode_append_plain(
        q, kv, k, v, bt, sl, pos, layer, **common)
    b2 = lambda: pa.paged_attention_decode(q, kv[0], bt, sl, kv[1], layer,
                                           **common)

    def unfused():                      # kv_append then B2, as the step
        ka.kv_append(kv, k, v, layer, pos, bt, page_size=PAGE)
        return b2()
    ms = device_ms(fused, match=KERNEL_NAMES[kname])
    plain_ms = device_ms(plain, iters=5)
    b2_ms = device_ms(b2, match=KERNEL_NAMES["paged_attention_decode"])
    call_ms = device_ms(fused)
    pair_ms = device_ms(unfused)
    n_fused, n_pair = (kernels_in_call(torch, fn) for fn in (fused, unfused))
    walls = {fused: [], unfused: []}
    for fn in (fused, unfused, unfused, fused):
        walls[fn].append(cuda_ms(fn))
    wall_ms, pair_wall_ms = (sum(walls[fn]) / 2 for fn in (fused, unfused))
    # bytes: q in + out, the old rows B9 reads (keys < seq_len - 1) with
    # their scales, the new K/V in, its pool rows and scales out, the
    # table, positions and lengths; flops: QK and PV over every key
    row = KH * 2 * (DH * kv[0].element_size() + 4 * (len(kv) - 1))
    b_ms, b_by = bound(2 * q.numel() * q.element_size()
                       + sum(n - 1 for n in lens) * row
                       + 2 * k.numel() * k.element_size() + batch * row
                       + 4 * (bt.numel() + 2 * batch),
                       4 * DH * H * sum(lens), "bf16")
    print(f"  [{kname}] {batch} x {max(lens)} keys, device time: kernel "
          f"{ms:.4f} ms, its whole wrapper call {call_ms:.4f} ms in "
          f"{n_fused} device kernels ({wall_ms:.4f} ms wall), plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}); on the same "
          f"inputs B2 alone {b2_ms:.4f} ms ({ms / b2_ms:.2f}x of it), "
          f"kv_append + B2 {pair_ms:.4f} ms in {n_pair} device kernels "
          f"({pair_wall_ms:.4f} ms wall for the two wrapper calls); no "
          "library call appends and attends", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, unfused_ms=pair_ms, call_ms=call_ms,
                b2_ms=b2_ms)


def decode_bound(torch, q, kv, bt, lens, window):
    """The least time of a T=1 decode call: bytes are q in and out, every
    K/V row (with its scale) a sequence's lone query sees, the table and
    lengths; operations QK and PV over those keys."""
    batch, _, heads, dh = q.shape
    seen = sum(min(n, window) if window else n for n in lens)
    row = kv[0].shape[2] * 2 * (dh * kv[0].element_size()
                                + 4 * (len(kv) - 1))
    return bound(2 * q.numel() * q.element_size() + seen * row
                 + 4 * (bt.numel() + batch), 4 * dh * heads * seen,
                 "bf16" if q.dtype == torch.bfloat16 else "f32")


def sdpa_decode_call(torch, F_, q, kv, bt, sl, layer, window):
    """The library yardstick of a T=1 decode call: one
    scaled_dot_product_attention over a dense, dequantized, gathered copy
    (made here, outside the timed call)."""
    smax = int(sl.max().item())
    k_d, v_d = dense_kv(torch, kv, bt, layer, smax)
    G_ = q.shape[2] // k_d.shape[1]
    kd = k_d.to(q.dtype).repeat_interleave(G_, dim=1)
    vd = v_d.to(q.dtype).repeat_interleave(G_, dim=1)
    key = torch.arange(smax, device=q.device)
    n = sl.long()[:, None, None, None]
    mask = key < n
    if window:
        mask &= key >= n - window
    return lambda: F_.scaled_dot_product_attention(
        q.transpose(1, 2), kd, vd, attn_mask=mask, scale=q.shape[3] ** -0.5)


def misread_group(bt, lens, window, J=4):
    """``bt`` with sequence 0's group of ``J`` pages in the middle of its
    visible keys pointing at the next group's pages."""
    first = max(lens[0] - window, 0) // PAGE if window else 0
    g0 = (first + -(-lens[0] // PAGE)) // 2 // J * J
    wrong = bt.clone()
    wrong[0, g0:g0 + J] = bt[0, g0 + J:g0 + 2 * J]
    return wrong


#: the split-KV decode kernels on B2's body (csrc/split_decode.cuh), whose
#: every held shape goes to the kernels line's ``shapes``
SPLIT_KV = ("paged_attention_decode", "paged_attention_decode_grouped",
            "paged_attention_decode_batched", "paged_attention_decode_packed")


def reverse_merge(pa, kname, args, common, batch, kv_heads, mp, window):
    """A split-KV kernel's computation (B2, B6, B7 or B8) in plain PyTorch
    with its parts merged in the reverse order, and what those parts
    are."""
    if kname == "paged_attention_decode":
        splits = pa.decode_split_plan(batch, kv_heads, mp)[0]
        return pa.decode_split_emulation(
            *args, order=range(splits - 1, -1, -1), **common), \
            f"{splits} splits"
    if kname == "paged_attention_decode_grouped":
        splits = pa.decode_grouped_plan(batch, kv_heads, mp, PAGE,
                                        window)[0]
        return pa.decode_grouped_emulation(
            *args, order=range(splits - 1, -1, -1), **common), \
            f"{splits} splits"
    if kname == "paged_attention_decode_packed":
        splits = pa.decode_packed_plan(batch, kv_heads, mp, PAGE, window)[0]
        return pa.decode_packed_emulation(
            *args, order=range(splits - 1, -1, -1), **common), \
            f"{splits} splits"
    parts = pa.decode_batched_partition(
        args[3].tolist(), kv_heads, PAGE, mp, window)
    most = max((n for blk in parts for _, _, _, _, n in blk), default=0)
    return pa.decode_batched_emulation(*args, reverse=True, **common), \
        f"{sum(map(len, parts))} parts (at most {most} a KV head)"


def b6_sweep(torch, pa, args, common, name, batch, kv_heads, G, mp, window):
    """B6's cut swept at one shape (device time by CUPTI): the pages a
    split (multiples of 4, from a third of the plan's splits to 64), the
    ring's depth, and the
    instance's rows, one at a time from :func:`decode_grouped_plan`'s cut
    and the kernel's own choice of the others. A launch the kernel refuses
    (a ring that does not fit) is printed as such."""
    splits0, pps0 = pa.decode_grouped_plan(batch, kv_heads, mp, PAGE, window)
    width = mp if window <= 0 else min(mp, -(-(window - 1) // PAGE) + 1)
    cuts = {}
    for pps in (4, 8, 12, 16, 24, 32, 48, 64, 128, 256, 512, pps0):
        splits = -(-width // pps)
        if splits0 // 3 <= splits <= pa.DECODE_MAX_SPLITS \
                and splits not in cuts:
            cuts[splits] = pps
    configs = [dict(splits=s, pages_per_split=p) for s, p in sorted(cuts.items())]
    configs += [dict(splits=splits0, pages_per_split=pps0, stages=st)
                for st in (1, 2, 3, 4)]
    configs += [dict(splits=splits0, pages_per_split=pps0, rows=r)
                for r in ((1, 4) if G == 1 else (4, 8))]
    line = []
    for cfg in configs:
        try:
            ms = device_ms(lambda: pa.decode_grouped_launch(
                *args, **common, **cfg), iters=10,
                match=KERNEL_NAMES["paged_attention_decode_grouped"])
            line.append(f"{cfg} {ms:.4f}")
        except RuntimeError as exc:
            line.append(f"{cfg} refused ({exc})")
    print(f"  [paged_attention_decode_grouped] {name}: sweep (plan "
          f"{splits0} splits x {pps0} pages), ms: " + "; ".join(line),
          flush=True)


def b8_sweep(torch, pa, args, common, name, batch, kv_heads, mp, window):
    """B8's cut at one shape (device time by CUPTI): the plan's (a split a
    page), one split a sequence, splits of two pages, and the plan's with
    rings of 1 to 4 stages."""
    splits0, pps0 = pa.decode_packed_plan(batch, kv_heads, mp, PAGE, window)
    width = splits0 * pps0
    configs = [dict(splits=splits0, pages_per_split=pps0),
               dict(splits=1, pages_per_split=width),
               dict(splits=-(-width // 2), pages_per_split=2)]
    configs += [dict(splits=splits0, pages_per_split=pps0, stages=st)
                for st in (1, 2, 3, 4)]
    line = []
    for cfg in configs:
        try:
            ms = device_ms(lambda: pa.decode_packed_launch(
                *args, **common, **cfg), iters=10,
                match=KERNEL_NAMES["paged_attention_decode_packed"])
            line.append(f"{cfg} {ms:.4f}")
        except RuntimeError as exc:
            line.append(f"{cfg} refused ({exc})")
    print(f"  [paged_attention_decode_packed] {name}: sweep (plan "
          f"{splits0} splits x {pps0} pages), ms: " + "; ".join(line),
          flush=True)


def decode_variant_checks(torch, F_, dev, results):
    """B6, B7 and B8 against their plain versions (B2's tolerances: 2e-2
    with bf16 queries, 1e-4 with f32), each at the shapes its path gives
    it, with device times beside the bound, the plain version and SDPA
    (B6 at paths (h)'s and (i)'s shapes also with f32 queries, whose
    tolerance must flag a table with one group of pages misread); B2
    timed on the same inputs wherever it takes them (dh % 128 == 0: B6 at
    path (i)'s 516-page shape, B7 at each of its shapes). B2 itself past
    the slice: path (k)'s decode shape, a 512-page table at batch 1 (B6
    timed beside) and four ragged sequences of 1-512 pages, which B7
    (split by the real lengths) takes too. The split-KV kernels (B2, B6,
    B7, B8) with f32 queries: their parts merged in reverse order (in
    plain PyTorch) must stay within 1e-4 and one misread page must not.
    B6's cut (splits, ring stages, rows) swept at (h)'s and (i)'s shapes
    (:func:`b6_sweep`), B8's at (g)'s (:func:`b8_sweep`). B2 at path
    (o)'s decode shapes, at 2e-2 of max|plain| with a page misread that
    must leave it (B6 timed beside)."""
    from importlib import import_module

    pa = import_module(f"{PKG}.ops.paged_attention")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    bf16, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    layer = 1
    worst = {}
    cases = [
        # name, kernel, q dtype, pool dtype, batch, KH, G, dh, table
        # width, pool pages, seq lens, window, softcap, tolerance; the
        # first case of each kernel goes to the kernels line
        ("(g) shape: tinyllama-1.1b, B=8", "paged_attention_decode_packed",
         bf16, i8, 8, 4, 8, 64, 5, 96,
         [65, 72, 80, 96, 100, 112, 120, 128], 0, 0.0, 2e-2),
        ("dh 32, window 40, f32", "paged_attention_decode_packed", f32, i8,
         8, 4, 8, 32, 5, 96, [65, 72, 80, 96, 100, 112, 120, 320], 40, 0.0,
         1e-4),
        ("dh 32, window 40, bf16 pool", "paged_attention_decode_packed",
         bf16, bf16, 8, 4, 8, 32, 5, 96, [1, 72, 80, 96, 100, 112, 120,
                                          320], 40, 0.0, 2e-2),
        ("(i) shape: llama3.1-8b, 516 pages, B=1",
         "paged_attention_decode_grouped", bf16, i8, 1, 8, 4, 128, 516, 520,
         [32832], 0, 0.0, 2e-2),
        ("(i) shape, f32", "paged_attention_decode_grouped", f32, i8, 1,
         8, 4, 128, 516, 520, [32832], 0, 0.0, 1e-4),
        ("(h) shape: phi3-mini-4k, window 2047, B=4",
         "paged_attention_decode_grouped", bf16, i8, 4, 32, 1, 96, 36, 150,
         [2049, 2080, 2100, 2112], 2047, 0.0, 2e-2),
        ("(h) shape, f32", "paged_attention_decode_grouped", f32, i8, 4, 32,
         1, 96, 36, 150, [2049, 2080, 2100, 2112], 2047, 0.0, 1e-4),
        ("dh 64, softcap 30, f32", "paged_attention_decode_grouped", f32,
         i8, 4, 8, 4, 64, 5, 80, [65, 90, 128, 300], 0, 30.0, 1e-4),
        ("B2's shape", "paged_attention_decode_batched", bf16, i8, 4, 8, 4,
         128, 5, 80, [65, 90, 128, 101], 0, 0.0, 2e-2),
        ("8 ragged sequences, f32", "paged_attention_decode_batched", f32, i8,
         8, 8, 4, 128, 5, 80, [1, 65, 200, 320, 17, 128, 64, 250], 0, 0.0,
         1e-4),
        # B7 split by the real lengths on B2's ragged inputs (below)
        ("4 ragged sequences of 1-512 pages", "paged_attention_decode_batched",
         bf16, i8, 4, 8, 4, 128, 512, 2060, [1, 64 * 7 + 3, 64 * 200,
                                             64 * 512], 0, 0.0, 2e-2),
        # B2 (split-KV) past the slice, which attention_checks holds: path
        # (k)'s decode (Mixtral-8x7B, 4 x 320 tokens, the table bench.py
        # sizes), a 512-page table at batch 1 (a 32k context, where the
        # INT8 scales budget still routes to B2; B6 timed beside), and
        # four ragged sequences of 1 to 512 pages
        ("(k) shape: mixtral-8x7b, 4 x 320", "paged_attention_decode", bf16,
         i8, 4, 8, 4, 128, 7, 40, [320] * 4, 0, 0.0, 2e-2),
        ("512 pages, B=1", "paged_attention_decode", bf16, i8, 1, 8, 4, 128,
         512, 520, [32700], 0, 0.0, 2e-2),
        ("512 pages, B=1, f32", "paged_attention_decode", f32, i8, 1, 8, 4,
         128, 512, 520, [32700], 0, 0.0, 1e-4),
        ("4 ragged sequences of 1-512 pages", "paged_attention_decode", bf16,
         i8, 4, 8, 4, 128, 512, 2060, [1, 64 * 7 + 3, 64 * 200, 64 * 512],
         0, 0.0, 2e-2),
    ]
    # path (o)'s decode step on B2 (Gemma-3-1B: KH 1, G 4, dh 256; the
    # 600-token prompt at 631 keys over 10 pages beside three of 64), on
    # a local layer (window 512) and a global one: held as B1 is, at 2e-2
    # of max|plain|, which one page misread must leave
    relative = [
        ("(o) shape: gemma3-1b, window 512, B=4", "paged_attention_decode",
         bf16, i8, 4, 1, 4, 256, 10, 48, [631, 72, 88, 95], 512, 0.0, 2e-2),
        ("(o) shape, global layer", "paged_attention_decode", bf16, i8, 4, 1,
         4, 256, 10, 48, [631, 72, 88, 95], 0, 0.0, 2e-2)]
    for (name, kname, qdt, pdt, batch, kh, g, dh, mp, n_pages, lens, window,
         softcap, tol) in cases + relative:
        kv, bt = make_pool(torch, gen, pdt, dev, batch, kh, dh, mp, n_pages)
        scales = kv[1] if len(kv) == 2 else None
        q = torch.randn((batch, 1, kh * g, dh), generator=gen,
                        device=dev).to(qdt)
        sl = torch.tensor(lens, dtype=torch.int32, device=dev)
        args = (q, kv[0], bt, sl, scales, layer)
        common = dict(page_size=PAGE, num_q_heads=kh * g, window=window,
                      softcap=softcap, scale=dh ** -0.5)
        kern = getattr(pa, kname)
        plain = getattr(pa, kname + "_plain")
        out_k = kern(*args, **common)
        out_p = plain(*args, **common)
        torch.cuda.synchronize()
        rel = any(name == c[0] for c in relative)
        if rel:
            tol *= out_p.float().abs().max().item()
        err = (out_k.float() - out_p.float()).abs().max().item()
        ok = err <= tol and bool(torch.isfinite(out_k).all())
        print(f"  [{kname}] {name}: max|kernel-plain| = {err:.3e} "
              f"(tol {tol:g}{' = 2e-2 of max|plain|' if rel else ''}; "
              f"max|plain| {out_p.float().abs().max().item():.3e})"
              f" {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"{kname} {name}: error {err} > {tol}")
        if rel:
            wrong = plain(q, kv[0], misread_group(bt, lens, window, J=1), sl,
                          scales, layer, **common)
            miss = (wrong.float() - out_p.float()).abs().max().item()
            print(f"  [{kname}] {name}: one page misread moves the output "
                  f"by {miss:.3e} (tol {tol:g})", flush=True)
            check(miss > tol, f"{kname} {name}: the tolerance {tol} does not "
                  f"flag a misread page ({miss})")
        if kname == "paged_attention_decode_grouped" and mp >= 8:
            # what a B6 that read one group of 4 pages wrong would give:
            # the plain version with that group's table entries pointing at
            # the next group's pages; f32 queries must tell it apart
            wrong = plain(q, kv[0], misread_group(bt, lens, window), sl,
                          scales, layer, **common)
            miss = (wrong.float() - out_p.float()).abs().max().item()
            print(f"  [{kname}] {name}: one group of 4 pages misread moves "
                  f"the output by {miss:.3e} (tol {tol:g})", flush=True)
            check(qdt == bf16 or miss > tol,
                  f"{kname} {name}: the tolerance {tol} does not flag a "
                  f"misread group ({miss})")
        if qdt == f32:
            # the split-KV kernels' controls (B2, B6, B7, B8): their parts
            # merged in the reverse order (in plain PyTorch) stay within the
            # tolerance, one page of the table misread (read in place of
            # its neighbour) does not
            rev, parts = reverse_merge(pa, kname, args, common, batch, kh,
                                       mp, window)
            rev_err = (rev.float() - out_p.float()).abs().max().item()
            wrong = plain(q, kv[0], misread_group(bt, lens, window, J=1), sl,
                          scales, layer, **common)
            miss = (wrong.float() - out_p.float()).abs().max().item()
            print(f"  [{kname}] {name}: {parts} merged in reverse order "
                  f"differ by {rev_err:.3e}, one page misread moves the "
                  f"output by {miss:.3e} (tol {tol:g})", flush=True)
            check(rev_err <= tol, f"{kname} {name}: a reordered merge "
                  f"leaves the tolerance ({rev_err})")
            check(miss > tol, f"{kname} {name}: the tolerance {tol} does not "
                  f"flag a misread page ({miss})")
        if qdt == bf16:
            worst[kname] = max(worst.get(kname, 0.0), err)
        ms = device_ms(lambda: kern(*args, **common),
                       match=KERNEL_NAMES[kname])
        call_ms = cuda_ms(lambda: kern(*args, **common))
        plain_ms = device_ms(lambda: plain(*args, **common), iters=5)
        b_ms, b_by = decode_bound(torch, q, kv, bt, lens, window)
        lib_ms = (device_ms(sdpa_decode_call(torch, F_, q, kv, bt, sl, layer,
                                             window), iters=5)
                  if softcap == 0 else None)
        b2 = ""
        row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=lib_ms)
        if kname in SPLIT_KV:
            results[kname].setdefault("shapes", {})[name] = row
        if kname == "paged_attention_decode_grouped" and qdt == bf16:
            b6_sweep(torch, pa, args, common, name, batch, kh, g, mp, window)
        if kname == "paged_attention_decode_packed" and name.startswith("(g)"):
            b8_sweep(torch, pa, args, common, name, batch, kh, mp, window)
        if kname == "paged_attention_decode":
            # B6 on the same inputs: the route past the scales budget
            b6_out = pa.paged_attention_decode_grouped(*args, **common)
            b6_err = (b6_out.float() - out_p.float()).abs().max().item()
            check(b6_err <= tol, f"B6 at {name}: error {b6_err}")
            row["b6_ms"] = device_ms(
                lambda: pa.paged_attention_decode_grouped(*args, **common),
                match=KERNEL_NAMES["paged_attention_decode_grouped"])
            b2 = (f"; B6 on the same inputs {row['b6_ms']:.4f} ms "
                  f"(max|B6-plain| {b6_err:.3e})")
        if dh % 128 == 0 and kname != "paged_attention_decode":
            # B2 on the same inputs: B6's yardstick at 516 pages, B7's at
            # B2's shape
            b2_out = pa.paged_attention_decode(*args, **common)
            b2_err = (b2_out.float() - out_p.float()).abs().max().item()
            check(b2_err <= tol, f"B2 at {name}: error {b2_err}")
            row["b2_ms"] = device_ms(
                lambda: pa.paged_attention_decode(*args, **common),
                match=KERNEL_NAMES["paged_attention_decode"])
            b2 = (f"; B2 on the same inputs {row['b2_ms']:.4f} ms "
                  f"(max|B2-plain| {b2_err:.3e}), "
                  f"{row['b2_ms'] / ms:.2f}x the kernel's time")
        print(f"  [{kname}] {name}, device time: kernel {ms:.4f} ms (one "
              f"wrapper call {call_ms:.4f} ms wall), plain {plain_ms:.4f} "
              f"ms, bound {b_ms:.5f} ms ({b_by}, {b_ms / ms:.3f} of it "
              f"reached), sdpa "
              f"{'n/a (softcap)' if lib_ms is None else f'{lib_ms:.4f} ms'}"
              f"{b2}", flush=True)
        if "ms" not in results[kname]:
            results[kname].update(row)
        del kv, bt, out_k, out_p
        torch.cuda.empty_cache()
    for kname, err in worst.items():
        # B2's slice cases (attention_checks) count too
        results[kname].update(
            max_abs_err=max(err, results[kname].get("max_abs_err") or 0.0),
            tol=2e-2)


#: Llama-3-8B's projections (name, K, N) as the engine fuses them, and
#: its LM head
PROJECTIONS = [("qkv", 4096, 6144), ("wo", 4096, 4096),
               ("gate-up", 4096, 28672), ("down", 14336, 4096)]
LM_HEAD = ("lm-head", 4096, 128256)
#: B11 at path (k)'s prefill chunk (4 x 256 rows): Mixtral-8x7B's qkv,
#: o and LM head (vocabulary 32,000), the products its dispatch leaves
#: to B11 under int8-weight
MIXTRAL_B11 = [("mixtral qkv", 4096, 6144), ("mixtral o", 4096, 4096),
               ("mixtral head", 4096, 32000)]
MIXTRAL_M = 1024
#: B11's decode gemv at path (k)'s decode step: Mixtral-8x7B's fused expert
#: gate|up and down, the masked expert loop's two B11 calls an expert and
#: layer (every decode row through every expert, M = 4)
MIXTRAL_EXPERTS = [("expert gate-up", 4096, 28672), ("expert down", 14336, 4096)]
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
    at edge shapes; device times at decode (M=4), at a verify chunk (M=36,
    B10 alone) and at prefill (M=256), each call (the library yardsticks'
    too) on a weight outside L2, and each kernel's layer (the four
    projections) summed at each M. A control: two k-tiles of a weight
    swapped move B10's plain output, so its exact check can fail."""
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

    # a layer's four projections, summed by (kernel, M)
    layers = {}
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
        for M in (4, 36, 256):
            x = randn(M, K).to(bf16)
            xq = qt.quantize_per_row(x)
            b10 = lambda q, f=i8.int8_matmul: f(
                xq.values, xq.scales, q.values, q.scales)
            b11 = lambda q, f=i8.w8_matmul: f(x, q.values, q.scales)
            fn_of_f32 = lambda q, x32: i8.w8_matmul(x32, q.values, q.scales)
            b12 = lambda q, f=i4.w4_matmul: f(
                x, q.packed, q.scales, group=q.group, bn=q.bn)
            cases = [("w8_matmul", b11, wqs, i8.w8_matmul_plain),
                     ("w4_matmul", b12, w4s, i4.w4_matmul_plain)]
            if not head:          # the w8a8 LM head is B11 (weight-only)
                cases.insert(0, ("int8_matmul", b10, wqs,
                                 i8.int8_matmul_plain))
            if M == 36:           # a verify chunk: B10 in the projections,
                # B11 in the w8a8 head (both on their tensor-core routes),
                # B12 in the int4 projections
                cases = [c for c in cases if c[0] in (
                    ("w8_matmul",) if head else ("int8_matmul",
                                                  "w4_matmul"))]
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
                if kname == "int8_matmul" and name == "qkv" and M > 4:
                    # the host's cost a call where a step is host-bound
                    wall = cuda_ms(lambda: fn_of(ws[0]))
                    print(f"  [int8_matmul] qkv M={M}: one wrapper call "
                          f"{wall:.4f} ms wall (CUDA events over back-to-"
                          "back calls, quantized x given)", flush=True)
                print(f"  [{kname}] {label} device time: kernel {ms:.4f} ms"
                      f", plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms "
                      f"({b_by}, {b_ms / ms:.2f} of it reached), library "
                      f"{lib_ms:.4f} ms (its max|library-plain| "
                      f"{lib_err:.3e}, tol {lib_tol:.3e})", flush=True)
                if kname == "w8_matmul" and M == 4:
                    # the gemv with f32 x: three bf16 planes a value
                    x32 = randn(M, K)
                    verify(kname, label.replace("M=4", "M=4 x f32"),
                           fn_of_f32(wqs[0], x32),
                           plain(x32, wq.values, wq.scales))
                if kname == "w8_matmul" and head and M == 4:
                    results[kname].update(ms=ms, plain_ms=plain_ms,
                                          bound_ms=b_ms, bound_by=b_by,
                                          library_ms=lib_ms)
                elif head:          # B11's and B12's heads past decode
                    results[kname].setdefault("shapes", {})[
                        f"lm-head M={M}"] = dict(
                            ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by, library_ms=lib_ms)
                elif not head:
                    r = layers.setdefault((kname, M), {
                        "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                        "library_ms": 0.0, "by": set()})
                    r["ms"] += ms
                    r["plain_ms"] += plain_ms
                    r["bound_ms"] += b_ms
                    r["library_ms"] += lib_ms
                    r["by"].add(b_by)
            if name == "qkv" and M == 4:
                # B11's decode control: two of its gemv's 16-row k-steps
                # read in each other's place
                ref11 = i8.w8_matmul_plain(x, wq.values, wq.scales)
                sw = torch.cat([wq.values[16:32], wq.values[:16],
                                wq.values[32:]])
                off = i8.w8_matmul_plain(x, sw, wq.scales)
                print(f"  [w8_matmul] control, k-steps 0 and 1 of the qkv "
                      f"weight swapped at M=4: max|moved-plain| "
                      f"{(off.float() - ref11.float()).abs().max():.3e}, "
                      f"within the tolerance: {matmul_close(off, ref11)} "
                      "(must be False)", flush=True)
                check(not matmul_close(off, ref11), "B11's tolerance does "
                      "not flag two k-steps misread at decode")
            if name == "qkv" and M == 256:
                # the control: tiles 0 and 1 of K swapped in the weight
                sw = torch.cat([wq.values[128:256], wq.values[:128],
                                wq.values[256:]])
                moved = (i8.int8_matmul_plain(xq.values, xq.scales, sw,
                                              wq.scales)
                         != i8.int8_matmul_plain(xq.values, xq.scales,
                                                 wq.values, wq.scales)
                         ).float().mean().item()
                print(f"  [int8_matmul] control, k-tiles 0 and 1 of the "
                      f"qkv weight swapped: {moved:.3f} of the plain "
                      "outputs move (the exact check needs > 0)",
                      flush=True)
                check(moved > 0, "a misread k-tile leaves B10's plain "
                      "output unchanged")
                # B11's controls: two of its 64-row k-tiles, or two of its
                # 256-column blocks, read in each other's place
                ref11 = i8.w8_matmul_plain(x, wq.values, wq.scales)
                for what, sw in (
                        ("k-tiles 0 and 1", torch.cat([
                            wq.values[64:128], wq.values[:64],
                            wq.values[128:]])),
                        ("256-column blocks 0 and 1", torch.cat([
                            wq.values[:, 256:512], wq.values[:, :256],
                            wq.values[:, 512:]], dim=1))):
                    off = i8.w8_matmul_plain(x, sw, wq.scales)
                    print(f"  [w8_matmul] control, {what} of the qkv weight "
                          f"swapped: max|moved-plain| "
                          f"{(off.float() - ref11.float()).abs().max():.3e}"
                          f", within the tolerance: "
                          f"{matmul_close(off, ref11)} (must be False)",
                          flush=True)
                    check(not matmul_close(off, ref11), f"B11's tolerance "
                          f"does not flag {what} misread")
                # B12's control: two 128-column carrier runs (its
                # tensor-core kernel's raw tiles) read in each other's place
                p4 = w4.packed
                sw4 = torch.cat([p4[:, 128:256], p4[:, :128], p4[:, 256:]],
                                dim=1)
                k4 = dict(group=w4.group, bn=w4.bn)
                ref12 = i4.w4_matmul_plain(x, p4, w4.scales, **k4)
                off = i4.w4_matmul_plain(x, sw4, w4.scales, **k4)
                print(f"  [w4_matmul] control, carrier runs 0 and 1 of the "
                      f"qkv weight swapped: max|moved-plain| "
                      f"{(off.float() - ref12.float()).abs().max():.3e}, "
                      f"within the tolerance: {matmul_close(off, ref12)} "
                      "(must be False)", flush=True)
                check(not matmul_close(off, ref12), "B12's tolerance does "
                      "not flag a misread carrier run")
        del wqs, w4s, libs
        torch.cuda.empty_cache()
    for (kname, M), r in sorted(layers.items()):
        by = "/".join(sorted(r["by"]))
        print(f"  [{kname}] a layer's four projections at M={M}: kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.5f} ms ({by}, {r['bound_ms'] / r['ms']:.2f} "
              f"of it reached), library {r['library_ms']:.4f} ms", flush=True)
        if M == 4 and kname != "w8_matmul":    # B11's row is the head's
            results[kname].update(ms=r["ms"], plain_ms=r["plain_ms"],
                                  bound_ms=r["bound_ms"], bound_by=by,
                                  library_ms=r["library_ms"])
        elif M != 4:
            results[kname].update({
                f"m{M}_ms": r["ms"], f"m{M}_bound_ms": r["bound_ms"],
                f"m{M}_library_ms": r["library_ms"]})

    # B11's decode gemv: a layer at M=4 against B10's gemv, and at path
    # (k)'s expert products (bf16 and f32 x; timed with bf16 x)
    b10_m4 = layers[("int8_matmul", 4)]["ms"]
    b11_m4 = layers[("w8_matmul", 4)]["ms"]
    print(f"  [w8_matmul] a layer's four projections at M=4: gemv "
          f"{b11_m4:.4f} ms, B10's gemv on the same layer {b10_m4:.4f} ms "
          f"({b11_m4 / b10_m4:.3f} of it)", flush=True)
    results["w8_matmul"].setdefault("shapes", {})["layer M=4"] = dict(
        ms=b11_m4, plain_ms=layers[("w8_matmul", 4)]["plain_ms"],
        bound_ms=layers[("w8_matmul", 4)]["bound_ms"], bound_by="bytes",
        library_ms=layers[("w8_matmul", 4)]["library_ms"], b10_ms=b10_m4)
    for name, K, N in MIXTRAL_EXPERTS:
        wq = qt.quantize_per_channel(randn(K, N, scale=0.02))
        copies = max(1, int(np.ceil(COLD_BYTES / wq.values.numel())))
        wqs = [wq] + [qt.QTensor(wq.values.clone(), wq.scales.clone())
                      for _ in range(copies - 1)]
        for xdt in (bf16, torch.float32):
            x = randn(4, K).to(xdt)
            verify("w8_matmul", f"{name} M=4 (K={K}, N={N}) x "
                   f"{str(xdt)[6:]}", i8.w8_matmul(x, wq.values, wq.scales),
                   i8.w8_matmul_plain(x, wq.values, wq.scales))
        fn_of = lambda q, x=x.to(bf16): i8.w8_matmul(x, q.values, q.scales)
        x = x.to(bf16)
        ms = device_ms(cold_calls(fn_of, wqs), match=KERNEL_NAMES["w8_matmul"])
        plain_ms = device_ms(
            lambda: i8.w8_matmul_plain(x, wq.values, wq.scales), iters=5)
        b_ms, b_by = bound(2 * 4 * K + K * N + 4 * N + 2 * 4 * N,
                           2 * 4 * K * N, "bf16")
        widened = [q.values.to(bf16) for q in wqs]
        lib_ms = device_ms(cold_calls(lambda wb, x=x: w8_matmul_library(
            x, wq.values, wq.scales, widened=wb), widened), iters=10)
        print(f"  [w8_matmul] {name} M=4 (K={K}, N={N}) device time: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms "
              f"({b_by}, {b_ms / ms:.2f} of it reached), library (widened "
              f"GEMM) {lib_ms:.4f} ms", flush=True)
        results["w8_matmul"]["shapes"][f"{name} M=4"] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms)
        del wqs, widened
        torch.cuda.empty_cache()

    # B11 at path (k)'s prefill chunk: Mixtral-8x7B's qkv, o and head
    mix = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    for name, K, N in MIXTRAL_B11:
        wq = qt.quantize_per_channel(randn(K, N, scale=0.02))
        copies = max(1, int(np.ceil(COLD_BYTES / wq.values.numel())))
        wqs = [wq] + [qt.QTensor(wq.values.clone(), wq.scales.clone())
                      for _ in range(copies - 1)]
        x = randn(MIXTRAL_M, K).to(bf16)
        fn_of = lambda q, x=x: i8.w8_matmul(x, q.values, q.scales)
        label = f"{name} M={MIXTRAL_M} (K={K}, N={N})"
        expect = i8.w8_matmul_plain(x, wq.values, wq.scales)
        verify("w8_matmul", label, fn_of(wq), expect)
        ms = device_ms(cold_calls(fn_of, wqs),
                       match=KERNEL_NAMES["w8_matmul"])
        plain_ms = device_ms(
            lambda: i8.w8_matmul_plain(x, wq.values, wq.scales), iters=5)
        b_ms, b_by = bound(2 * MIXTRAL_M * K + K * N + 4 * N
                           + 2 * MIXTRAL_M * N, 2 * MIXTRAL_M * K * N,
                           "bf16")
        widened = [q.values.to(bf16) for q in wqs]
        lib_ms = device_ms(cold_calls(lambda wb, x=x: w8_matmul_library(
            x, wq.values, wq.scales, widened=wb), widened), iters=5)
        print(f"  [w8_matmul] {label} device time: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}, "
              f"{b_ms / ms:.2f} of it reached), library {lib_ms:.4f} ms",
              flush=True)
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                     ("library_ms", lib_ms)):
            mix[k] += v
        del wqs, widened
        torch.cuda.empty_cache()
    print(f"  [w8_matmul] Mixtral-8x7B's qkv, o and head at M={MIXTRAL_M}: "
          f"kernel {mix['ms']:.4f} ms, plain {mix['plain_ms']:.4f} ms, bound "
          f"{mix['bound_ms']:.5f} ms ({mix['bound_ms'] / mix['ms']:.2f} of it "
          f"reached), library {mix['library_ms']:.4f} ms", flush=True)
    results["w8_matmul"].setdefault("shapes", {})[
        f"mixtral qkv+o+head M={MIXTRAL_M}"] = dict(mix, bound_by="operations")

    # edge shapes: M 1 and 17, K and N that fit no tile, bias and an
    # activation, f32 activations and outputs
    for M, K, N, act, xdt, odt in [
            (1, 1000, 1000, "gelu", torch.float32, torch.float32),
            (17, 4096, 6144, "silu", bf16, bf16),
            (17, 300, 200, "relu", torch.float32, bf16),
            (65, 1000, 1000, "gelu", bf16, torch.float32),
            (36, 70, 36, None, bf16, bf16),
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


#: B14/B15 at Llama-3-8B's chain (D 4096, I 14336, next qkv 6144; bk
#: 1024, bn 2048) and at edge chains: (label, D, I, N3, activation, norm,
#: biases): GPT-2's widths with GELU, LayerNorm and biases; TinyLlama's
#: (I % bn != 0); a hidden size no multiple of bk (square blocks of 1280)
CHAIN_MAIN = ("llama3-8b", 4096, 14336, 6144, "swiglu", "rmsnorm", False)
CHAIN_EDGES = [("gpt2 gelu+ln", 768, 3072, 2304, "gelu", "layernorm", True),
               ("tinyllama I%bn", 2048, 5632, 2560, "swiglu", "rmsnorm",
                False),
               ("D%bk (D 1280)", 1280, 5120, 3840, "swiglu", "rmsnorm",
                False)]
#: B14 against its plain version, of max|plain|: h and the activation are
#: rounded to bf16 (or re-quantized to INT8) between the ops, so an f32
#: sum in another order can move one of them by a step
CHAIN_TOL = 2e-2
#: the variants: (weights, activations)
CHAIN_VARIANTS = {"bf16": "dense", "int8-weight": "int8", "w8a8": "w8a8"}


def chain_ops(torch, gen, dev, shape, tail=True):
    """Random f32 per-op weights of one chain of ``shape``: ``[(op, W [K,
    N], bias)]`` in stream order and the two norms' (scale, bias)."""
    from importlib import import_module

    cl = import_module(f"{PKG}.ops.chain_linear")
    _, D, I, N3, act, norm, biased = shape

    def r(*s_, scale=0.02):
        return torch.randn(s_, generator=gen, device=dev) * scale

    ops = [(cl.OP_O, r(D, D), r(D) if biased else None)]
    ops += ([(cl.OP_G, r(D, I), None), (cl.OP_U, r(D, I), None)]
            if act == "swiglu" else [(cl.OP_U, r(D, I), r(I) if biased
                                      else None)])
    ops += [(cl.OP_D, r(I, D), r(D) if biased else None)]
    if tail:
        ops += [(cl.OP_T, r(D, N3), r(N3) if biased else None)]
    lns = [(1.0 + r(D, scale=0.1), r(D, scale=0.1) if biased else None)
           for _ in range(2)]
    return ops, lns


def chain_variant(torch, ops, lns, shape, variant, tail=True):
    """``ops`` (f32) as ``variant``'s weights, packed as
    ``build_decode_chains`` packs them; returns the chain and the per-op
    weights it holds."""
    from importlib import import_module

    cl = import_module(f"{PKG}.ops.chain_linear")
    qt = import_module(f"{PKG}.quant.tensor")
    chained = import_module(f"{PKG}.models.chained")
    _, D, I, _, act, norm, _ = shape
    kind = CHAIN_VARIANTS[variant]
    conv = [(op, w.to(torch.bfloat16) if kind == "dense"
             else qt.quantize_per_channel(w), b)
            for op, w, b in ops if tail or op != cl.OP_T]
    bk, bn = chained.chain_blocks(D, I)
    pc = cl.pack_chain(conv, D=D, I=I, ln_after_o=lns[0],
                       ln_after_down=lns[1] if tail else None, act_kind=act,
                       norm_kind=norm, eps=1e-5, bk=bk, bn=bn,
                       w_dtype=torch.bfloat16 if kind == "dense" else None,
                       w8a8=kind == "w8a8")
    return pc, conv


def misread(torch, pc):
    """``pc`` with its first two blocks swapped (the o-projection's first
    two K blocks, each read where the other belongs)."""
    w = pc.w.clone()
    w[[0, 1]] = w[[1, 0]]
    return dataclasses.replace(pc, w=w)


def per_op_layer(torch, conv, lns, shape, w8a8):
    """The per-op path B14 replaces, on the same weights: ``linear`` for
    each projection (gate|up fused) with the norms, SwiGLU / GELU and
    residual adds between them, as ``DecoderModel`` runs a layer and the
    next layer's qkv; the yardstick of B14 (a callable of (attn_in, x))."""
    from importlib import import_module

    lin = import_module(f"{PKG}.ops.linear")
    com = import_module(f"{PKG}.ops.common")
    qt = import_module(f"{PKG}.quant.tensor")
    _, D, I, _, act, norm, _ = shape
    w = {op: (wt, b) for op, wt, b in conv}
    gu = None
    if act == "swiglu":
        g_, u_ = w[1][0], w[2][0]
        gu = (qt.QTensor(torch.cat([g_.values, u_.values], 1),
                         torch.cat([g_.scales, u_.scales], 1))
              if isinstance(g_, qt.QTensor) else torch.cat([g_, u_], 1))

    def nrm(x, pair):
        if norm == "rmsnorm":
            return com.rmsnorm(x, pair[0], 1e-5)
        return com.layernorm(x, pair[0], pair[1], 1e-5)

    def layer(ain, x):
        x = x + lin.linear(ain, w[0][0], w[0][1], w8a8=w8a8)
        h = nrm(x, lns[0])
        if gu is not None:
            g, u = lin.linear(h, gu, w8a8=w8a8).chunk(2, dim=-1)
            mid = com.activation_fn("silu")(g.float()).to(u.dtype) * u
        else:
            mid = lin.linear(h, w[2][0], w[2][1], act=act, w8a8=w8a8)
        x = x + lin.linear(mid, w[3][0], w[3][1], w8a8=w8a8)
        if 4 not in w:
            return x, None
        return x, lin.linear(nrm(x, lns[1]), w[4][0], w[4][1], w8a8=w8a8)
    return layer


def traced_launches(torch, fn, iters=5):
    """Device kernels per call of ``fn`` (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / iters


def chain_checks(torch, dev, results):
    """B14 against its plain version at Llama-3-8B's chain at B=4 and B=1,
    with and without the tail, in bf16 dense, int8-weight and w8a8, and at
    the edge chains; each variant's plain output must move past the
    tolerance when two blocks are swapped. B15 bit-exact under w8a8 (one
    bf16 step or 1e-5 of max|out| otherwise) at M=4, 36 and 256 for the
    o-projection, gate|up, down and the tail. Device times: B14 against
    the per-op layer on the same weights (its yardstick and launch
    count), B15 summed over a layer's four calls against ``torch._int_mm``
    over the same values."""
    from importlib import import_module

    cl = import_module(f"{PKG}.ops.chain_linear")
    qt = import_module(f"{PKG}.quant.tensor")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    bf16 = torch.bfloat16
    worst = {"chain_decode": 0.0, "packed_linear": 0.0}

    def hold(label, pc, B, tail):
        ain = torch.randn((B, pc.K0), generator=gen, device=dev).to(bf16)
        x = torch.randn((B, pc.D), generator=gen, device=dev).to(bf16)
        out, t = cl.chain_decode(pc, ain, x)
        ref, rt = cl.chain_decode_plain(pc, ain, x)
        torch.cuda.synchronize()
        check((t is None) == (not tail), f"{label}: tail {t is not None}")
        ok, errs = True, []
        for o, r in [(out, ref)] + ([(t, rt)] if tail else []):
            scale = r.float().abs().max().item()
            err = (o.float() - r.float()).abs().max().item()
            ok &= (err <= CHAIN_TOL * scale
                   and bool(torch.isfinite(o).all()))
            errs.append((err, scale))
            worst["chain_decode"] = max(worst["chain_decode"], err)
        shown = ", ".join(f"{n} max|kernel-plain| {e:.3e} of max|plain| "
                          f"{m:.3f}" for n, (e, m) in zip(("x", "tail"),
                                                          errs))
        print(f"  [chain_decode] {label} B={B}{'' if tail else ' no tail'}:"
              f" {shown} (tol {CHAIN_TOL:g} of max|plain|) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"chain_decode {label}: kernel differs from plain")
        return ain, x, ref

    def hold_packed(label, pc, M):
        runs = [((cl.OP_O,), None), ((cl.OP_D,), None)]
        if pc.act_kind != "swiglu":
            runs.append(((cl.OP_U,), pc.act_kind))
        elif pc.I % pc.bn == 0:
            runs.append(((cl.OP_G, cl.OP_U), None))
        else:
            runs += [((cl.OP_G,), None), ((cl.OP_U,), None)]
        if pc.has_tail:
            runs.append(((cl.OP_T,), None))
        for ops, act in runs:
            K = pc.I if ops == (cl.OP_D,) else pc.D
            x = torch.randn((M, K), generator=gen, device=dev).to(bf16)
            out = cl.packed_linear(pc, ops, x, act=act)
            ref = cl.packed_linear_plain(pc, ops, x, act=act)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            ok = (torch.equal(out, ref) if pc.w8a8 and act is None
                  else matmul_close(out, ref))
            check(ok and bool(torch.isfinite(out).all()),
                  f"packed_linear {label} ops {ops} M={M}: {err}")
            worst["packed_linear"] = max(worst["packed_linear"], err)
        print(f"  [packed_linear] {label} M={M}: {len(runs)} runs ok "
              f"(w8a8 bit-exact, else one bf16 step or 1e-5 of max|out|)",
              flush=True)

    ops, lns = chain_ops(torch, gen, dev, CHAIN_MAIN)
    for variant in CHAIN_VARIANTS:
        w8a8 = variant == "w8a8"
        label = f"{CHAIN_MAIN[0]} {variant}"
        for tail in (True, False):
            pc, conv = chain_variant(torch, ops, lns, CHAIN_MAIN, variant,
                                     tail)
            for B_ in (4, 1):
                ain, x, ref = hold(label, pc, B_, tail)
                if B_ == 4 and tail:
                    moved = (cl.chain_decode_plain(misread(torch, pc), ain,
                                                   x)[0].float()
                             - ref.float()).abs().max().item()
                    rel = moved / ref.float().abs().max().item()
                    print(f"  [chain_decode] {label} control, two blocks "
                          f"swapped: the plain output moves {rel:.3e} of "
                          f"max|plain| (must exceed {CHAIN_TOL:g})",
                          flush=True)
                    check(rel > CHAIN_TOL, f"{label}: a misread chain "
                          f"stays within the tolerance ({rel})")
                if B_ == 4:
                    timed = (ain, x)
            ain, x = timed
            ms = device_ms(lambda: cl.chain_decode(pc, ain, x),
                           match=KERNEL_NAMES["chain_decode"])
            plain_ms = device_ms(lambda: cl.chain_decode_plain(pc, ain, x),
                                 iters=3)
            layer = per_op_layer(torch, conv, lns, CHAIN_MAIN, w8a8)
            lay_ref = layer(ain, x)
            lay_err = (lay_ref[0].float() - cl.chain_decode_plain(
                pc, ain, x)[0].float()).abs().max().item()
            unfused_ms = device_ms(lambda: layer(ain, x))
            unfused_n = traced_launches(torch, lambda: layer(ain, x))
            io = 2 * (ain.numel() + 2 * x.numel()
                      + (pc.N3 * 4 if tail else 0))
            b_ms, b_by = bound(pc.w.numel() * pc.w.element_size()
                               + 4 * (pc.sb.numel() + pc.ln.numel()) + io,
                               2 * 4 * sum(g[4] * g[5]
                                           for g in pc.ops_geom),
                               "int8" if w8a8 else "bf16")
            print(f"  [chain_decode] {label} B=4{'' if tail else ' no tail'}"
                  f" device time: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                  f"ms, bound {b_ms:.5f} ms ({b_by}, {b_ms / ms:.2f} of it "
                  f"reached; {pc.w.numel() * pc.w.element_size()} weight "
                  f"bytes, G {pc.w.shape[0]}); yardstick the per-op layer "
                  f"on the same weights {unfused_ms:.4f} ms in "
                  f"{unfused_n:.0f} launches (its x within "
                  f"{lay_err:.3e} of the chain's plain version); no "
                  "library call computes a chain", flush=True)
            if w8a8 and tail:
                results["chain_decode"].update(
                    ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=None, unfused_ms=unfused_ms)
            if not tail:
                continue
            # B15 on the same chain
            for M in (4, 36, 256):
                hold_packed(label, pc, M)
            if not w8a8:
                continue
            M = 256
            xs = {K: torch.randn((M, K), generator=gen, device=dev).to(bf16)
                  for K in (pc.D, pc.I)}
            runs = [((cl.OP_O,), pc.D), ((cl.OP_G, cl.OP_U), pc.D),
                    ((cl.OP_D,), pc.I), ((cl.OP_T,), pc.D)]
            o_run = lambda p_: cl.packed_linear_plain(p_, (cl.OP_O,),
                                                      xs[pc.D])
            moved = (o_run(misread(torch, pc)) != o_run(pc)).float().mean(
                ).item()
            print(f"  [packed_linear] {label} control, the o-projection's "
                  f"first two blocks swapped: {moved:.3f} of the plain "
                  "outputs move (the exact check needs > 0)", flush=True)
            check(moved > 0, "a misread block leaves B15's plain output "
                  "unchanged")
            w = {op: wt for op, wt, _ in conv}
            gu = qt.QTensor(torch.cat([w[1].values, w[2].values], 1),
                            torch.cat([w[1].scales, w[2].scales], 1))
            per_op = {(cl.OP_O,): w[0], (cl.OP_G, cl.OP_U): gu,
                      (cl.OP_D,): w[3], (cl.OP_T,): w[4]}
            tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
            by = set()
            for run, K in runs:
                x_ = xs[K]
                kern = lambda r=run, a=x_: cl.packed_linear(pc, r, a)
                ref = cl.packed_linear_plain(pc, run, x_)
                xq = qt.quantize_per_row(x_)
                wq = per_op[run]
                lib = lambda a=xq, q=wq: int8_matmul_library(
                    a.values, a.scales, q.values, q.scales)
                lib_err = (lib().float() - ref.float()).abs().max().item()
                check(lib_err <= 1e-2 * ref.float().abs().max().item(),
                      f"packed_linear {run}: the library yardstick differs "
                      f"from plain by {lib_err}")
                N = ref.shape[-1]
                b_ms, b_by = bound(M * K + 4 * M + wq.values.numel()
                                   + 8 * N + 2 * M * N, 2 * M * K * N,
                                   "int8")
                tot["ms"] += device_ms(kern,
                                       match=KERNEL_NAMES["packed_linear"])
                if run == (cl.OP_O,):
                    print(f"  [packed_linear] o M={M}: one wrapper call "
                          f"{cuda_ms(kern):.4f} ms wall (CUDA events over "
                          "back-to-back calls, the rows' quantization "
                          "included)", flush=True)
                tot["plain_ms"] += device_ms(
                    lambda r=run, a=x_: cl.packed_linear_plain(pc, r, a),
                    iters=3)
                tot["bound_ms"] += b_ms
                tot["library_ms"] += device_ms(lib, iters=5)
                by.add(b_by)
            print(f"  [packed_linear] {label} M={M}, a layer's four calls "
                  f"(o, gate|up, down, next qkv) device time: kernel "
                  f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, "
                  f"bound {tot['bound_ms']:.5f} ms ({'/'.join(sorted(by))}, "
                  f"{tot['bound_ms'] / tot['ms']:.2f} of it reached), "
                  f"library torch._int_mm over the same values "
                  f"{tot['library_ms']:.4f} ms", flush=True)
            results["packed_linear"].update(bound_by="/".join(sorted(by)),
                                            **tot)
            del pc, conv
            torch.cuda.empty_cache()
    del ops, lns

    for shape in CHAIN_EDGES:
        ops, lns = chain_ops(torch, gen, dev, shape)
        for variant in ("bf16", "w8a8"):
            pc, _ = chain_variant(torch, ops, lns, shape, variant)
            label = f"{shape[0]} {variant} (bk {pc.bk}, bn {pc.bn})"
            ain, x, ref = hold(label, pc, 4, True)
            moved = (cl.chain_decode_plain(misread(torch, pc), ain, x)[0]
                     .float() - ref.float()).abs().max().item()
            check(moved > CHAIN_TOL * ref.float().abs().max().item(),
                  f"{label}: a misread chain stays within the tolerance")
            hold_packed(label, pc, 36)
    for kname, err in worst.items():
        results[kname].update(
            max_abs_err=err,
            tol=(f"{CHAIN_TOL:g} of max|plain|" if kname == "chain_decode"
                 else "0 (w8a8), one bf16 step or 1e-5 of max|out|"))


#: B13 at Mixtral-8x7B's prefill: bench.py's 4 x 256-token chunk routes
#: 1024 tokens to their top 2 of 8 experts (2048 slots, Npad 4096 rows)
MOE_TOKENS, MOE_E, MOE_TOPK = 1024, 8, 2
GMM_SHAPES = [("we_gu", 4096, 28672), ("we_down", 14336, 4096)]
#: B13's edge cases: (label, E, K, N, bm, group ids, x dtype, weights)
GMM_EDGES = [
    ("empty expert", 4, 512, 384, 256, [0, 2, 2, 3], "bf16", "int8"),
    ("one expert", 3, 256, 256, 128, [1, 1, 1, 1], "bf16", "bf16"),
    ("ragged K N", 3, 200, 300, 64, [0, 1, 1, 2, 2], "bf16", "int8"),
    ("bm 64 f32 w", 4, 128, 136, 64, [3, 0, 2, 1], "bf16", "f32"),
    ("f32 x", 4, 384, 200, 64, [3, 0, 2, 1], "f32", "int8"),
    ("f32 x f32 w", 2, 256, 130, 128, [0, 1], "f32", "f32")]


def moe_routing(torch, gen, dev, tokens=MOE_TOKENS, experts=MOE_E,
                k=MOE_TOPK):
    """The dispatch layout (``order``, ``dest``, ``group_of_block``, by
    the model's own ``dispatch_layout``, and the routed rows of each block,
    ``dispatch_block_rows``) of ``tokens`` routed to their top ``k`` of
    ``experts`` by random router logits rounded to bf16, as the model
    rounds them."""
    from importlib import import_module

    model = import_module(f"{PKG}.models.model")
    logits = torch.randn((tokens, experts), generator=gen,
                         device=dev).to(torch.bfloat16).float()
    topi = torch.sort(logits, dim=-1, descending=True, stable=True)[1]
    return model.dispatch_layout(topi[:, :k], experts) + (
        model.dispatch_block_rows(topi[:, :k], experts),)


def grouped_matmul_library(x, w, group_of_block, *, bm=256,
                           block_rows=None):
    """B13's function computed another way: for each run of row blocks on
    one expert, one cuBLAS product over the expert's weight cast to x's
    dtype (bf16 x: a bf16 GEMM with an f32 output), then its scales and
    one rounding; rows at or past ``block_rows`` zeros. A reference for
    this script only, never called by the port."""
    from importlib import import_module

    import torch

    qt = import_module(f"{PKG}.quant.tensor")
    quantized = isinstance(w, qt.QTensor)
    wv = w.values if quantized else w
    gb = group_of_block.tolist()
    out = torch.empty((x.shape[0], wv.shape[-1]), dtype=x.dtype,
                      device=x.device)
    r = 0
    while r < len(gb):
        e, r1 = gb[r], r
        while r1 < len(gb) and gb[r1] == e:
            r1 += 1
        rows = slice(r * bm, r1 * bm)
        we = wv[e].to(x.dtype)
        y = (torch.mm(x[rows], we, out_dtype=torch.float32)
             if x.dtype == torch.bfloat16 else torch.mm(x[rows], we))
        if quantized:
            y = y * w.scales[e].reshape(1, -1)
        out[rows] = y.to(x.dtype)
        r = r1
    if block_rows is not None:
        live = (torch.arange(bm, device=x.device)[None, :]
                < block_rows[:, None]).reshape(-1, 1)
        out = torch.where(live, out, torch.zeros((), dtype=out.dtype,
                                                  device=out.device))
    return out


def gmm_checks(torch, dev, results):
    """B13 against its plain version at Mixtral-8x7B's two expert products
    (INT8 and dense bf16 experts, bf16 activations, rows laid out from a
    real routing), with and without the dispatch's ``block_rows`` (the
    tiles it lets the kernel skip counted), and at edge shapes; each
    Mixtral call's plain output must move past the tolerance when two
    blocks' group ids are swapped. Device times beside the plain
    version's, the bound over the routed rows this routing needs, and
    ``torch._grouped_mm`` over bf16 copies of the weights (widened
    beforehand, not timed) as the library yardstick."""
    from importlib import import_module

    gm = import_module(f"{PKG}.ops.gmm")
    qt = import_module(f"{PKG}.quant.tensor")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    bf16 = torch.bfloat16
    worst = 0.0

    def verify(label, out, ref):
        nonlocal worst
        ok = matmul_close(out, ref) and bool(torch.isfinite(out).all())
        err = (out.float() - ref.float()).abs().max().item()
        print(f"  [grouped_matmul] {label}: max|kernel-plain| = {err:.3e} "
              f"(tol one bf16 step or 1e-5 of max|out|) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"grouped_matmul {label}: kernel differs from plain "
              f"({err})")
        worst = max(worst, err)

    _, dest, gb, block_rows = moe_routing(torch, gen, dev)
    bm, E = 256, MOE_E
    npad, routed = gb.numel() * bm, dest.numel()
    # the kernel's 128-row tiles: those with a routed row are computed
    starts = torch.tensor([0, 128], device=dev)
    live_tiles = int((block_rows.view(-1, 1) > starts).sum())
    tiles = npad // 128
    blocks = torch.bincount(gb.long(), minlength=E)
    offs = (blocks.cumsum(0) * bm).to(torch.int32)
    # the experts whose weights the routed rows need (the last one also
    # holds the trailing padding blocks)
    used = int((blocks > 0).sum())
    print(f"  B13 layout: {routed} routed rows of {MOE_TOKENS} tokens "
          f"(top {MOE_TOPK} of {E}) in Npad {npad} rows, blocks per expert "
          f"{blocks.tolist()}, routed rows per block "
          f"{block_rows.tolist()}: {live_tiles} of {tiles} 128-row tiles "
          f"hold a routed row ({live_tiles * 128} rows computed with "
          f"block_rows, {tiles - live_tiles} tiles skipped)", flush=True)
    row = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
           "by": set(), "all_ms": 0.0}
    for name, K, N in GMM_SHAPES:
        x = torch.zeros((npad, K), dtype=bf16, device=dev)
        x[dest] = torch.randn((routed, K), generator=gen, device=dev).to(bf16)
        vals = torch.empty((E, K, N), dtype=torch.int8, device=dev)
        scales = torch.empty((E, 1, N), dtype=torch.float32, device=dev)
        for e in range(E):                  # one expert's f32 at a time
            q = qt.quantize_per_channel(
                torch.randn((K, N), generator=gen, device=dev) * 0.02)
            vals[e].copy_(q.values)
            scales[e].copy_(q.scales)
            del q
        wq = qt.QTensor(vals, scales)
        widened = vals.to(bf16)             # the yardstick's operand
        dense = torch.empty((E, K, N), dtype=bf16, device=dev)
        for e in range(E):
            dense[e].copy_(vals[e].float() * scales[e])
        for kind, w, wb in (("INT8", wq, widened), ("bf16", dense, dense)):
            label = f"{name} {kind} experts (Npad={npad}, K={K}, N={N})"
            call = lambda w=w: gm.grouped_matmul(x, w, gb, bm=bm,
                                                 block_rows=block_rows)
            call_all = lambda w=w: gm.grouped_matmul(x, w, gb, bm=bm)
            plain = lambda w=w, g=gb: gm.grouped_matmul_plain(x, w, g, bm=bm)
            out = call()
            torch.cuda.synchronize()
            ref = plain()
            verify(label + " with block_rows", out, ref)
            verify(label + " without block_rows", call_all(), ref)
            # two blocks of different experts swapped
            j = int((gb != gb[0]).nonzero()[0])
            swapped = gb.clone()
            swapped[[0, j]] = gb[[j, 0]]
            moved = plain(g=swapped)
            check(not within_bf16_step(moved, ref),
                  f"grouped_matmul {label}: swapping blocks 0 and {j} "
                  "stays within the tolerance")
            print(f"  [grouped_matmul] {label}: blocks 0 and {j} swapped "
                  f"move the plain output by "
                  f"{(moved.float() - ref.float()).abs().max().item():.3e} "
                  f"(beyond the tolerance: ok)", flush=True)
            del moved
            ms = device_ms(call, iters=10, match=KERNEL_NAMES["grouped_matmul"])
            ms_all = device_ms(call_all, iters=10,
                               match=KERNEL_NAMES["grouped_matmul"])
            plain_ms = device_ms(plain, iters=3)
            w_bytes = (E * K * N + 4 * E * N if kind == "INT8"
                       else 2 * E * K * N) * used / E
            b_ms, b_by = bound(2 * routed * (K + N) + w_bytes,
                               2 * routed * K * N, "bf16")
            all_ms, _ = bound(2 * npad * (K + N) + w_bytes,
                              2 * npad * K * N, "bf16")
            lib = lambda wb=wb: torch._grouped_mm(x, wb, offs=offs)
            try:
                y = lib().float()
                if kind == "INT8":
                    y = y * scales[gb.long()].repeat_interleave(
                        bm, dim=0).reshape(npad, N)
                lib_err = (y - ref.float()).abs().max().item()
                lib_tol = 1e-2 * ref.float().abs().max().item()
                check(lib_err <= lib_tol, f"grouped_matmul {label}: the "
                      f"library yardstick differs from plain by {lib_err}")
                del y
                lib_ms = device_ms(lib, iters=10)
                lib_note = (f"library {lib_ms:.4f} ms (its max|library-plain|"
                            f" {lib_err:.3e}, tol {lib_tol:.3e})")
            except RuntimeError as exc:         # not on this build
                lib_ms = None
                lib_note = f"library not run ({str(exc).splitlines()[0]})"
            print(f"  [grouped_matmul] {label} device time: kernel "
                  f"{ms:.4f} ms with block_rows ({live_tiles} of {tiles} "
                  f"row tiles), {ms_all:.4f} ms without, plain "
                  f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms "
                  f"({b_by}, {routed} routed rows; {b_ms / ms:.3f} of it "
                  f"reached; {all_ms:.5f} ms over all {npad} rows), "
                  f"{lib_note}", flush=True)
            if kind == "INT8":                  # the main path's experts
                row["ms"] += ms
                row["all_ms"] += ms_all
                row["plain_ms"] += plain_ms
                row["bound_ms"] += b_ms
                row["by"].add(b_by)
                row["library_ms"] = (None if lib_ms is None
                                     or row["library_ms"] is None
                                     else row["library_ms"] + lib_ms)
            del out, ref
        del x, wq, vals, scales, widened, dense
        torch.cuda.empty_cache()
    results["grouped_matmul"].update(
        ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by="/".join(sorted(row["by"])), library_ms=row["library_ms"])
    print(f"  [grouped_matmul] a layer's two INT8 calls: kernel "
          f"{row['ms']:.4f} ms with block_rows ({row['all_ms']:.4f} ms "
          f"without), bound {row['bound_ms']:.5f} ms", flush=True)
    for label, E_, K, N, bm_, ids, xdt, wkind in GMM_EDGES:
        dt = bf16 if xdt == "bf16" else torch.float32
        x = torch.randn((len(ids) * bm_, K), generator=gen, device=dev).to(dt)
        w = torch.randn((E_, K, N), generator=gen, device=dev) * 0.02
        w = qt.quantize_per_channel(w) if wkind == "int8" else (
            w.to(bf16) if wkind == "bf16" else w)
        ids_t = torch.tensor(ids, dtype=torch.int32, device=dev)
        # the routed rows: all of the first block, half of the others
        rows_t = torch.tensor([bm_] + [bm_ // 2] * (len(ids) - 1),
                              dtype=torch.int32, device=dev)
        before = gm.GROUPED_MATMUL.launches
        for rows in (None, rows_t):
            verify(f"edge {label} (E={E_}, K={K}, N={N}, bm={bm_}, x {xdt}, "
                   f"w {wkind}, {'no ' if rows is None else ''}block_rows)",
                   gm.grouped_matmul(x, w, ids_t, bm=bm_, block_rows=rows),
                   gm.grouped_matmul_plain(x, w, ids_t, bm=bm_,
                                           block_rows=rows))
        check(gm.GROUPED_MATMUL.launches == before + 2,
              f"grouped_matmul edge {label}: the kernel not launched")
    results["grouped_matmul"].update(
        max_abs_err=worst, tol="one bf16 step or 1e-5 of max|out|")


# -- phase 3: the paths ------------------------------------------------------

#: phase 3's paths: (name, quant, layers), each Llama-3-8B at full width
#: and depth (layers None) but (a), (c) and (d), whose depth is cut to 8
#: so that the run stays near slice 3's length with paths (e)-(i) in
PATHS = [("bf16", "none", 8), ("w8a8", "int8", None),
         ("int8-weight", "int8-weight", 8), ("int4", "int4", 8)]
#: slice 4's paths (g) and (h): (letter, name, preset, batch, prompt
#: length, the decode kernel every decode layer must launch, layers: None
#: the preset's depth), bf16 weights on an unpadded pool; (h)'s depth cut
#: to 16 of 32 since path (o) came, for the script's time (PERF.md §6);
#: path (i) is :func:`long_context_path`
DECODE_PATHS = [
    ("g", "packed", "tinyllama-1.1b", 8, 64, "paged_attention_decode_packed",
     None),
    ("h", "grouped-96", "phi3-mini-4k", 4, 2048,
     "paged_attention_decode_grouped", 16)]
#: path (i): bench.py --mode longctx --prompt-len 32768 --steps 64
#: --batch 1 on Llama-3.1-8B, w8a8: its 516-page table, 16 of its 64
#: tokens generated (the depth cut that keeps the whole script inside its
#: time limit on a slow host since path (l) came; PERF.md §6)
LONG_MODEL, LONG_PROMPT, LONG_STEPS = "llama3.1-8b", 32768, 16
#: path (k): bench.py --model mixtral-8x7b --quant int8-weight --batch 4
#: --prompt-len 256, whose one 256-token prefill chunk routes 4 * 256 * 2
#: = 2048 = 8 * 256 slots: the dispatch's threshold, met exactly
MOE_MODEL, MOE_BATCH, MOE_PROMPT = "mixtral-8x7b", 4, 256
#: its greedy tokens and depth (each (k) decode step is ~200 ms of host
#: issue at 32 layers, and the script's whole run has 1200 s: 32 tokens
#: since slice 12, 16 since path (m) came, 8 tokens and 16 of its 32
#: layers since path (o) came; PERF.md §6)
MOE_STEPS, MOE_LAYERS = 8, 16
#: paths (a)-(f), (j), (g) and (h): 32 greedy tokens of bench's 64 on
#: bench's pools, their checks on each (the cut that keeps the whole
#: script inside its time limit on a slow host: (j), (g) and (h) since
#: path (m)'s replays came, (a)-(f) since path (o) came; PERF.md §6)
MAIN_STEPS = MEGAKERNEL_STEPS = DECODE_STEPS = 32
#: the path each kernel's launch count in the kernels line comes from:
#: slice 2's main path (w8a8); B12 the INT4 path, B5 the spec path, B9
#: the fused-append path, B8 the packed path, B6 the long-context path,
#: B14 and B15 the megakernel path, B13 the MoE path, B1's SIMT kernel
#: path (a)'s f32 run
LAUNCHES_FROM = {"paged_attention": "f32",
                 "w4_matmul": "int4", "kv_append_tokens": "spec",
                 "paged_attention_decode_append": "fused-append",
                 "paged_attention_decode_packed": "packed",
                 "paged_attention_decode_grouped": "long-context",
                 "chain_decode": "megakernel", "packed_linear": "megakernel",
                 "grouped_matmul": "moe"}
#: kernels no path runs (B7: neither engine calls it); each path checks
#: that they were launched 0 times
OFF_PATH = ("paged_attention_decode_batched",)


def path_config(quant="none", dtype="bfloat16", layers=None, spec_k=0,
                model="llama3-8b", batch=4, prompt_len=64, steps=64,
                pad_head_dim=None):
    """A path's configuration: ``model`` at ``quant``, INT8 KV at page 64,
    prefill chunk 256 and the pool ``bench.py`` sizes (bench.py:290-304)
    for ``batch`` prompts of ``prompt_len`` tokens and ``steps`` new
    ones; with ``spec_k`` the pool ``bench.py --mode spec`` sizes
    (bench.py:314-317), ``cdiv(spec_k, page) + 1`` more pages a sequence
    and ``batch`` times as many more in the pool (the fused loop takes the
    same pages from it as from the smaller one)."""
    from importlib import import_module

    cfgmod = import_module(f"{PKG}.config")
    page = 64
    cfg = cfgmod.FrameworkConfig()
    cfg.model = cfgmod.preset(model)
    if layers is not None:
        cfg.model.num_layers = layers
    cfg.model.quant = quant
    cfg.model.dtype = dtype
    total_len = prompt_len + steps + 1
    cdiv = lambda a, b: -(-a // b)
    n_pages = batch * cdiv(total_len, page) + 64
    grain = max(1, 1024 // page)
    extra = cdiv(spec_k, page) + 1 if spec_k else 0
    cfg.cache = cfgmod.CacheConfig(
        page_size=page, num_pages=cdiv(n_pages, grain) * grain + batch * extra,
        max_pages_per_seq=cdiv(total_len, page) + 2 + extra, kv_dtype="int8",
        pad_head_dim=pad_head_dim)
    cfg.runtime.prefill_chunk = 256
    cfg.runtime.max_new_tokens = steps
    # path (l)'s scheduler settings (only the Scheduler reads them)
    cfg.runtime.max_batch_size = batch
    cfg.runtime.decode_burst, cfg.runtime.decode_burst_max = 8, 32
    cfg.runtime.prefill_gang_tokens = 1024
    cfg.cache.enable_prefix_cache = cfg.cache.enable_swap = True
    return cfg, batch, steps, prompt_len


def b1_kernel(eng):
    """The B1 kernel an engine's chunks take: ``prefill_route`` of
    ``ops.paged_attention`` on its activation dtype, pool dtype, pool
    head dim and page size."""
    from importlib import import_module

    import torch

    pa = import_module(f"{PKG}.ops.paged_attention")
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    pool_dt = {"int8": torch.int8, "bfloat16": torch.bfloat16,
               "float32": torch.float32}[eng.cache.kv_dtype]
    route = pa.prefill_route(dt[eng.cfg.dtype], pool_dt,
                             eng.backend.pool.pool_head_dim,
                             eng.cache.page_size)
    return {"wgmma": "paged_attention_wgmma",
            "simt": "paged_attention"}[route]


def expected_launches(quant, n_layers, steps, fused_append=False, chunks=1,
                      decode="paged_attention_decode", chained=False,
                      experts=0, dispatch_chunks=0,
                      attention="paged_attention_wgmma", head=True):
    """Exact launch counts of one ``generate_batch_fused`` run: ``chunks``
    page-aligned prefill chunks (B1 and B4 in each layer) and ``steps -
    1`` decode steps (B3 and the ``decode`` kernel in each layer), each
    forward over ``n_layers`` layers of four projections (fused qkv, wo,
    fused gate-up, down) and then the LM head; every other kernel 0. With
    ``fused_append`` (``PBT_FUSED_APPEND=1``) each decode layer launches
    B9 in place of B3 and B2. ``chained`` (the w8a8 megakernel with the
    per-op copies dropped): layer 0's qkv (B10) and the LM head (B11) stay
    per-op in every forward; a decode step runs one B14 a layer, a
    prefill chunk its other projections through B15 (o, gate|up and down
    of layer 0, then qkv, o, gate|up and down of each later layer).
    ``experts`` (MoE, INT8 experts weight-only, fused gate|up): every
    forward's qkv, o and the head through B11; the ``dispatch_chunks``
    prefill chunks that reach the dispatch run B13 on we_gu and we_down
    in each layer, every other forward (the decode steps, other chunks)
    the masked loop's two B11 per expert and layer. ``attention``: the B1
    kernel of the chunks (:func:`b1_kernel`); ``head`` False: a tied LM
    head (:func:`matmul_launches`)."""
    from importlib import import_module

    plat = import_module(f"{PKG}.utils.platform")
    out = dict.fromkeys(plat.KERNELS, 0)
    per_step = n_layers * (steps - 1)
    out.update({attention: n_layers * chunks,
                "kv_append_prefill": n_layers * chunks})
    if fused_append:
        out["paged_attention_decode_append"] = per_step
    else:
        out.update({"kv_append_decode": per_step, decode: per_step})
    if experts:
        check(quant == "int8-weight", "the MoE path is int8-weight")
        forwards = chunks + steps - 1
        out.update(w8_matmul=(2 * n_layers + 1) * forwards
                   + 2 * experts * n_layers * (forwards - dispatch_chunks),
                   grouped_matmul=2 * n_layers * dispatch_chunks)
    elif chained:
        check(quant == "int8", "the megakernel path is w8a8")
        out.update(int8_matmul=chunks + steps - 1,
                   w8_matmul=chunks + steps - 1, chain_decode=per_step,
                   packed_linear=(4 * n_layers - 1) * chunks)
    else:
        out.update(matmul_launches(quant, n_layers, chunks + steps - 1,
                                   head))
    return out


def matmul_launches(quant, n_layers, forwards, head=True):
    """B10-B12 launches of ``forwards`` forwards over ``n_layers`` layers
    (four projections each, then the LM head; ``head`` False for a tied
    head, which launches none of them: the port widens the embedding
    table to f32 on every forward and multiplies in f32, where the JAX
    model contracts the stored table with f32 accumulation and makes no
    copy; ROADMAP C)."""
    out = {"int8_matmul": 0, "w8_matmul": 0, "w4_matmul": 0}
    h = forwards if head else 0
    if quant == "int8":                   # w8a8; the head is weight-only
        out["int8_matmul"] = 4 * n_layers * forwards
        out["w8_matmul"] = h
    elif quant == "int8-weight":
        out["w8_matmul"] = 4 * n_layers * forwards + h
    elif quant == "int4":
        out["w4_matmul"] = 4 * n_layers * forwards + h
    return out


def expected_spec_launches(quant, n_layers, verifies,
                           attention="paged_attention_wgmma"):
    """Exact launch counts of one ``generate_batch_spec`` run: the prefill
    chunk, then ``verifies`` verify forwards, each appending its
    ``spec_k + 1``-token chunk with B5 and attending with B1 (the kernel
    ``attention``); every other kernel 0."""
    from importlib import import_module

    plat = import_module(f"{PKG}.utils.platform")
    out = dict.fromkeys(plat.KERNELS, 0)
    out.update({attention: n_layers * (1 + verifies),
                "kv_append_prefill": n_layers,
                "kv_append_tokens": n_layers * verifies})
    out.update(matmul_launches(quant, n_layers, 1 + verifies))
    return out


def drive(torch, eng, prompts, greedy, steps, name, fused_append=False,
          decode="paged_attention_decode"):
    """The path's timed ``generate_batch_fused``, with every kernel's
    launch count set to 0 just before and checked just after (``decode``:
    the T=1 kernel the path's route takes)."""
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
    expect = expected_launches(eng.cfg.quant, eng.cfg.num_layers, steps,
                               fused_append, prefill_chunks(eng, prompts),
                               decode, chained="chains" in eng.params,
                               experts=eng.cfg.num_experts,
                               dispatch_chunks=dispatch_chunks(eng, prompts),
                               attention=b1_kernel(eng),
                               head=not eng.cfg.tie_embeddings)
    check(counts == expect,
          f"{name}: launches {counts}, expected exactly {expect}")
    arr = np.asarray(toks)
    check(arr.shape == (batch, steps), f"tokens shape {arr.shape}")
    check(((arr >= 0) & (arr < eng.cfg.vocab_size)).all(),
          "token ids out of range")
    stream_gb, floor_ms = weight_stream(eng)
    print(f"  weight stream per decode step {stream_gb:.3f} GB: "
          f"floor {floor_ms:.3f} ms/step = {batch / floor_ms * 1e3:.0f} "
          f"tok/s at B={batch}; measured {decode_tps:.1f} tok/s = "
          f"{batch / decode_tps * 1e3:.2f} ms/step", flush=True)
    return {"decode_tok_s": decode_tps, "prefill_ms": prefill_s * 1e3,
            "total_ms": total_s * 1e3, "weight_stream_gb": stream_gb,
            "weight_stream_floor_ms": floor_ms, "launches": counts}


def weight_stream(eng):
    """A decode step reads every weight but the embedding table (of which
    it gathers B rows; a tied LM head reads all of it) once: its bytes
    (GB) and their time at the card's rate, the end-to-end floor of a
    step (ms)."""
    stream_bytes = sum(t.numel() * t.element_size()
                       for key, t in _leaves(eng.params)
                       if key != "embedding" or eng.cfg.tie_embeddings)
    return stream_bytes / 1e9, stream_bytes / HBM_BYTES_PER_S * 1e3


def prefill_chunks(eng, prompts):
    """The page-aligned prefill chunks ``generate_batch_fused`` runs for
    ``prompts``."""
    page = eng.cache.page_size
    max_len = -(-max(len(p) for p in prompts) // page) * page
    return -(-max_len // eng._chunk(max_len))


def dispatch_chunks(eng, prompts):
    """The prefill chunks of ``prompts`` whose routed slots reach the MoE
    dispatch (``S = B * T * k >= E * 256``, not under w8a8)."""
    from importlib import import_module

    model = import_module(f"{PKG}.models.model")
    cfg = eng.cfg
    if not cfg.num_experts or cfg.quant == "int8":
        return 0
    page = eng.cache.page_size
    max_len = -(-max(len(p) for p in prompts) // page) * page
    chunk = eng._chunk(max_len)
    return sum(len(prompts) * min(chunk, max_len - c0) * cfg.experts_per_tok
               >= cfg.num_experts * model._GMM_BM
               for c0 in range(0, max_len, chunk))


def build_engine(torch, cfg):
    from importlib import import_module

    eng_mod = import_module(f"{PKG}.engine")
    quant, dtype = cfg.model.quant, cfg.model.dtype
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = eng_mod.Engine(cfg, seed=SEED)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 1e9
    print(f"  engine built ({cfg.model.name}, {cfg.model.num_layers} layers, "
          f"quant={quant}, {dtype} activations, "
          f"weights from seed {SEED}) in {time.perf_counter() - t0:.1f} s; "
          f"holds {held:.2f} GB on the card (peak while building "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB)", flush=True)
    return eng, held


def run_paths(torch, dev, results, card):
    from importlib import import_module

    eng_mod = import_module(f"{PKG}.engine")
    plat = import_module(f"{PKG}.utils.platform")
    cfg, batch, _, prompt_len = path_config()
    steps = MAIN_STEPS
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.model.vocab_size,
                           size=(batch, prompt_len)).tolist()
    # bench.py --mode spec's prompts (bench.py:408-411): each a random
    # 16-token motif tiled, drawn after the random prompts as there
    motifs = rng.integers(0, cfg.model.vocab_size, (batch, 16)).tolist()
    spec_prompts = [(m * -(-prompt_len // 16))[:prompt_len] for m in motifs]
    greedy = eng_mod.SamplingParams(temperature=0.0, eos_token_id=-1)
    refs = reference_backends()
    out = {}

    def launches_from(name, info):
        for kname, n in info["launches"].items():
            if LAUNCHES_FROM.get(kname, "w8a8") == name:
                results[kname]["launches"] = n

    for (name, quant, layers), letter in zip(PATHS, "abcd"):
        phase(f"3{letter}: {name} (llama3-8b, quant={quant}, INT8 KV)")
        # paths (e) and (f) run on path (b)'s engine, built with the pool
        # bench.py --mode spec sizes
        eng, held = build_engine(torch, path_config(
            quant, layers=layers, spec_k=SPEC_K if quant == "int8" else 0)[0])
        info = drive(torch, eng, prompts, greedy, steps, name)
        info["engine_gb"] = held
        launches_from(name, info)
        tf16 = logit_checks(torch, eng, refs, forced_run(
            torch, eng, prompts, greedy, steps), TOL[(quant, "bf16")], "bf16")
        info.update(limit_readings(tf16, "bf16"))
        if quant in ("none", "int8"):
            checks, base = full_checks(torch, eng, refs, prompts, greedy,
                                       steps, tf16)
            info.update(checks)
        if quant == "int8":
            phase("3e: spec (generate_batch_spec on the w8a8 engine, "
                  f"spec_k={SPEC_K}, n-gram {SPEC_NGRAM})")
            out["spec"] = spec_path(torch, eng, spec_prompts, greedy, steps,
                                    card)
            launches_from("spec", out["spec"])
            phase("3f: fused-append (generate_batch_fused on the w8a8 "
                  "engine with PBT_FUSED_APPEND=1)")
            out["fused-append"] = fused_append_path(torch, eng, prompts,
                                                    greedy, steps, card, base)
            launches_from("fused-append", out["fused-append"])
            phase("3l: scheduler (the continuous-batching Scheduler on the "
                  "w8a8 engine: 8 requests in 3 waves, swap preemption, "
                  "prefix cache, live resize; spec and seeded passes)")
            out["scheduler"] = scheduler_path(
                torch, torch.nn.functional, eng, greedy, spec_prompts, card,
                tf16["tol"])
            phase("3m: beam (bench.py --mode beam: width 4 on (b)'s w8a8 "
                  "weights, a log-prob rerank; decode_scored with B1's "
                  "per-page scores)")
            out["beam"] = beam_path(torch, eng, refs, prompts, greedy, card,
                                    tf16["tol"], results)
            phase("3n: server (BasicServer over ServerCore on the w8a8 "
                  "engine: a lone request, 4 concurrent streams and a "
                  "batch, a beam request, errors, metrics)")
            out["server"] = server_path(torch, eng, greedy, card,
                                        tf16["tol"])
            phase("3j: megakernel (bench.py --megakernel: path (b)'s "
                  "weights packed into chains, per-op copies dropped)")
            holder = {"params": eng.params}
            eng = None                  # (j) takes over (b)'s weights
            out["megakernel"] = megakernel_path(
                torch, holder, held, refs, prompts, greedy,
                MEGAKERNEL_STEPS, card, base)
            launches_from("megakernel", out["megakernel"])
        del eng
        torch.cuda.empty_cache()
        if quant == "none":
            # the same checks with f32 weights and activations (same
            # seed, unrounded); the kernels' run, whose f32 chunks take
            # B1's SIMT kernel, has its launch counts set to 0 just before
            # and checked exactly just after
            eng32, _ = build_engine(torch, path_config(quant, "float32",
                                                       layers)[0])
            counts32 = {}

            def run32(ref, feed, eng32=eng32):
                if ref is None:
                    plat.reset_launch_counts()
                got = forced_logits(torch, eng32, ref, prompts, greedy,
                                    steps, feed)
                if ref is None:
                    counts32.update({n: k.launches
                                     for n, k in plat.KERNELS.items()})
                return got

            tf32 = logit_checks(torch, eng32, refs, run32,
                                TOL[(quant, "f32")], "f32")
            expect = expected_launches(
                quant, eng32.cfg.num_layers, steps,
                chunks=prefill_chunks(eng32, prompts),
                attention=b1_kernel(eng32))
            print(f"  launches in the f32 kernels' run: "
                  f"{json.dumps(counts32)}", flush=True)
            check(counts32 == expect, f"f32: launches {counts32}, expected "
                  f"exactly {expect}")
            check(expect["paged_attention"] > 0,
                  "f32 chunks do not take B1's SIMT kernel")
            launches_from("f32", {"launches": counts32})
            del eng32, run32          # run32 holds eng32 as a default
            torch.cuda.empty_cache()
            info.update(limit_readings(tf32, "f32"))
        out[name] = info
    for letter, name, model, batch_, prompt_len_, decode, layers in \
            DECODE_PATHS:
        phase(f"3{letter}: {name} ({model}, bf16 weights, INT8 KV on an "
              f"unpadded pool, B={batch_}, {prompt_len_}-token prompts: "
              f"{decode} in every decode layer)")
        out[name] = decode_path(torch, refs, greedy, name, model, batch_,
                                prompt_len_, decode, layers)
        launches_from(name, out[name])
    phase(f"3i: long-context ({LONG_MODEL}, w8a8, INT8 KV, one "
          f"{LONG_PROMPT}-token prompt, bench.py --mode longctx's table)")
    out["long-context"] = long_context_path(torch, refs, greedy, card)
    launches_from("long-context", out["long-context"])
    phase(f"3o: hf-import ({HF_MODEL} written as an HF checkpoint "
          "directory and served from it: w8a8 at import, INT8 KV, 600 + "
          "3 x 64-token prompts, dual-theta RoPE)")
    out["hf-import"] = hf_import_path(torch, refs, greedy, card)
    phase(f"3k: moe ({MOE_MODEL}, int8-weight, INT8 KV, B={MOE_BATCH}, "
          f"{MOE_PROMPT}-token prompts: B13 in the prefill chunk, the masked "
          "expert loop at decode)")
    out["moe"] = moe_path(torch, refs, greedy, card)
    launches_from("moe", out["moe"])
    check(not LIMIT_FAILURES, "; ".join(LIMIT_FAILURES))
    return out


def decode_path(torch, refs, greedy, name, model, batch, prompt_len,
                decode, layers=None):
    """Paths (g) and (h): ``model`` with bf16 weights at its full width
    and at ``layers`` of depth (None: the preset's) on an unpadded INT8
    pool (``bench.py``'s for 64 tokens, :data:`DECODE_STEPS` of them
    decoded); the timed run with exact launch counts (``decode`` in every
    decode layer), the teacher-forced logit checks and
    :func:`full_checks`."""
    cfg, batch, _, prompt_len = path_config(
        model=model, layers=layers, batch=batch, prompt_len=prompt_len,
        pad_head_dim=False)
    steps = DECODE_STEPS
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.model.vocab_size, size=(batch, prompt_len)).tolist()
    eng, held = build_engine(torch, cfg)
    check(eng.backend.pool.pool_head_dim == cfg.model.head_dim,
          f"{name}: the pool is padded")
    info = drive(torch, eng, prompts, greedy, steps, name, decode=decode)
    info["engine_gb"] = held
    tf16 = logit_checks(torch, eng, refs, forced_run(
        torch, eng, prompts, greedy, steps), TOL[(name, "bf16")], "bf16")
    info.update(limit_readings(tf16, "bf16"))
    checks, _ = full_checks(torch, eng, refs, prompts, greedy, steps, tf16)
    info.update(checks)
    # the decode kernel per layer in the profiled fused run (16 tokens:
    # 15 decode steps, every layer one launch)
    per_layer = (checks["profile_kernel_ms"].get(decode, 0.0)
                 / (15 * cfg.model.num_layers))
    print(f"  {decode} in the profiled fused run: {per_layer:.4f} ms a "
          f"layer (15 decode steps x {cfg.model.num_layers} layers)",
          flush=True)
    info[f"{decode}_ms_per_layer"] = per_layer
    del eng
    torch.cuda.empty_cache()
    return info


@contextlib.contextmanager
def decode_capture(torch, eng):
    """Inside: ``eng``'s fused loop is watched. At its first T=1 forward
    the card is synchronised and the time taken (the end of the prefill),
    then the pool is copied (``"pool"``, the prefilled pool) and the time
    taken again; the pages it allocates are kept (``"pages"``) and the
    last-position logits of the prefill's last chunk and of every decode
    step (``"rows"``, f32 on the card)."""
    cap = {"rows": [], "pages": [], "prefill_end": None, "pool": None}
    forward, alloc = eng.model.forward, eng.allocator.alloc_many

    def watched_forward(params, tokens, positions, kv, attn):
        if tokens.shape[1] == 1 and cap["pool"] is None:
            torch.cuda.synchronize()
            cap["prefill_end"] = time.perf_counter()
            cap["pool"] = tuple(x.clone() for x in kv)
            torch.cuda.synchronize()
            cap["copy_end"] = time.perf_counter()
        logits, kv = forward(params, tokens, positions, kv, attn)
        if tokens.shape[1] > 1 and cap["rows"]:
            cap["rows"][-1] = logits[:, -1].float()
        else:
            cap["rows"].append(logits[:, -1].float())
        return logits, kv

    def watched_alloc(n):
        cap["pages"].append(alloc(n))
        return cap["pages"][-1]

    eng.model.forward = watched_forward
    eng.allocator.alloc_many = watched_alloc
    try:
        yield cap
    finally:
        del eng.model.forward
        del eng.allocator.alloc_many


def decode_from_pool(torch, eng, ref, pool, bt, prompt_len, feed):
    """Decode steps from a copy of the prefilled ``pool`` (block table
    ``bt``, each sequence ``prompt_len`` tokens) through the reference
    ``ref`` (``None``: the kernels), step ``s`` fed ``feed[:, s]``.
    Returns the logits ``[steps, B, V]`` (f32, host) and the tokens
    fed."""
    batch = bt.shape[0]
    with recording(eng, ref) as rows, torch.inference_mode():
        kv = tuple(x.clone() for x in pool)
        sl = torch.full((batch,), prompt_len, dtype=torch.int32,
                        device=bt.device)
        for s in range(feed.shape[1]):
            tok = feed[:, s]
            attn = eng.backend.make_attn_fn(bt, sl + 1, sl)
            _, kv = eng.model.forward(
                eng.params, torch.as_tensor(tok, device=bt.device).long()[
                    :, None], sl.long()[:, None], kv, attn)
            sl = sl + 1
        del kv
        logits = torch.stack(rows).cpu().numpy()
    check(np.isfinite(logits).all(), "non-finite logits")
    return logits, feed


@contextlib.contextmanager
def from_prefilled(eng, pool, pages, final):
    """Inside: ``eng.generate_batch_fused`` resumes after a prefill it
    does not run: its pages are ``pages`` (one list a sequence, claimed
    from the allocator), its new pool takes a copy of the prefilled
    ``pool`` in place of the prefill's chunks, whose last logits were
    ``final``; the decode loop then runs as after the prefill."""
    rows = iter(pages)

    def claimed(n):
        ps = next(rows)
        check(n == len(ps), f"resumed run asks for {n} pages, not {len(ps)}")
        for p in ps:
            eng.allocator.claim(p)
        return list(ps)

    def prefilled(kv, tokens, lens, bt, chunk):
        for dst, src in zip(kv, pool):
            dst.copy_(src)
        return final.clone()

    eng.allocator.alloc_many = claimed
    eng._prefill_chunks = prefilled
    try:
        yield
    finally:
        del eng.allocator.alloc_many
        del eng._prefill_chunks


def long_context_path(torch, refs, greedy, card):
    """Path (i): Llama-3.1-8B, w8a8, at ``bench.py --mode longctx
    --prompt-len 32768``'s table: one timed ``generate_batch_fused`` of
    :data:`LONG_STEPS` tokens (exact launch counts: B6 in every decode
    layer), its
    prefill and decode timed apart (one synchronise at the first decode
    step) and its prefilled pool copied; the teacher-forced logit checks
    and the fork rule run from that copy (no second 32k prefill); a
    profile of ``generate_batch_fused`` of 16 tokens resumed from it
    (:func:`from_prefilled`) gives the busy share and B6's time per layer
    against its bytes bound."""
    from importlib import import_module

    plat = import_module(f"{PKG}.utils.platform")
    cfg, batch, _, prompt_len = path_config(
        "int8", model=LONG_MODEL, batch=1, prompt_len=LONG_PROMPT)
    steps = LONG_STEPS
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.model.vocab_size, size=(batch, prompt_len)).tolist()
    eng, held = build_engine(torch, cfg)
    eng.generate_batch_fused([p[:256] for p in prompts], 4, greedy)  # warm-up
    with decode_capture(torch, eng) as cap:
        plat.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = np.asarray(eng.generate_batch_fused(prompts, steps, greedy))
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        counts = {n: k.launches for n, k in plat.KERNELS.items()}
    prefill_s = cap["prefill_end"] - t0
    decode_s = t_end - cap["copy_end"]
    decode_tps = batch * (steps - 1) / decode_s
    stream_gb, floor_ms = weight_stream(eng)
    copy_ms = (cap["copy_end"] - cap["prefill_end"]) * 1e3
    print(f"  generate_batch_fused: prefill {prefill_s * 1e3:.1f} ms "
          f"({prompt_len} tokens, {prefill_chunks(eng, prompts)} chunks), "
          f"decode {decode_tps:.2f} tok/s = {decode_s / (steps - 1) * 1e3:.2f}"
          f" ms/step (B={batch}, {steps} tokens; the pool copy at the "
          f"first decode step, {copy_ms:.1f} ms, not counted); weight "
          f"stream floor {floor_ms:.3f} ms/step", flush=True)
    print(f"  launches in that run: {json.dumps(counts)}", flush=True)
    if "ms" in B1_LONG:
        print(f"  B1 in that prefill, estimated from phase 2's chunks: "
              f"{B1_LONG['ms'] / 1e3:.3f} s of the measured "
              f"{prefill_s:.3f} s ({B1_LONG['ms'] / 1e3 / prefill_s:.3f})",
              flush=True)
    expect = expected_launches(
        cfg.model.quant, cfg.model.num_layers, steps,
        chunks=prefill_chunks(eng, prompts),
        decode="paged_attention_decode_grouped", attention=b1_kernel(eng))
    check(counts == expect,
          f"long-context: launches {counts}, expected exactly {expect}")
    check(toks.shape == (batch, steps), f"tokens shape {toks.shape}")
    # the kernels' decode rows: the prefill's last row chose token 0,
    # decode step s (fed token s) chose token s + 1
    lk = torch.stack(cap["rows"]).cpu().numpy()
    check(lk.shape[0] == steps, f"recorded {lk.shape[0]} rows")
    bt = torch.zeros((batch, cfg.cache.max_pages_per_seq), dtype=torch.int32,
                     device=eng.device)
    for b, pages in enumerate(cap["pages"]):
        bt[b, :len(pages)] = torch.tensor(pages)
    pool, fed = cap["pool"], toks[:, :steps - 1]
    plain_run = {}

    def run(ref, feed):
        if ref is None:
            return lk[1:], fed
        out = decode_from_pool(torch, eng, ref, pool, bt, prompt_len, feed)
        if ref is refs["plain"]:
            plain_run["logits"] = out[0]
        return out

    t_refs = time.perf_counter()
    tf16 = logit_checks(torch, eng, refs, run,
                        TOL[("long-context", "bf16")], "bf16")
    print(f"  the three references' teacher-forced runs from the pool took "
          f"{time.perf_counter() - t_refs:.1f} s", flush=True)
    info = {"decode_tok_s": decode_tps, "prefill_ms": prefill_s * 1e3,
            "weight_stream_gb": stream_gb, "weight_stream_floor_ms": floor_ms,
            "engine_gb": held, "launches": counts,
            "b1_prefill_ms_estimate": B1_LONG.get("ms")}
    info.update(limit_readings(tf16, "bf16"))
    # the fork rule: the plain path greedy from the same pool emits, up to
    # each row's first fork, what it emits teacher-forced with the
    # kernels' tokens, so its teacher-forced run stands for it
    lp = plain_run["logits"]
    compared, worst, forks = fork_checks(
        "long-context kernels vs plain, greedy from the prefilled pool",
        toks[:, 1:], lp.argmax(-1).T, lk[1:], lp)
    info.update(pairs_before_fork=compared, max_dlogit=worst,
                forks=len(forks))
    resumed = {}

    def resume(n):
        with from_prefilled(eng, pool, cap["pages"], cap["rows"][0]):
            resumed["tokens"] = np.asarray(
                eng.generate_batch_fused(prompts, n, greedy))

    prof = profile_run(torch, "fused (resumed from the copied prefill)",
                       resume)
    info.update(prof)
    n = resumed["tokens"].shape[1]
    n_same = int((resumed["tokens"] == toks[:, :n]).sum())
    print(f"  the resumed run's tokens equal the timed run's first {n}: "
          f"{n_same} of {resumed['tokens'].size} (tol == all)", flush=True)
    check(n_same == resumed["tokens"].size,
          "the resumed fused run's tokens differ from the timed run's")
    # B6 per layer against its bytes: the profiled decode steps' mean
    # context (prompt_len + 1 .. prompt_len + n - 1 keys)
    b6_ms = (prof["profile_kernel_ms"]["paged_attention_decode_grouped"]
             / ((n - 1) * cfg.model.num_layers))
    keys = prompt_len + n / 2
    b6_bytes = keys * cfg.model.num_kv_heads * 2 * (cfg.model.head_dim + 4)
    b6_bound = b6_bytes / HBM_BYTES_PER_S * 1e3
    print(f"  B6 in the profiled decode: {b6_ms:.4f} ms a layer against its "
          f"bytes bound {b6_bound:.4f} ms ({b6_bytes / 1e6:.1f} MB of K/V "
          f"values and scales at {keys:.1f} keys; {b6_bound / b6_ms:.3f} of "
          f"it reached), {b6_ms * cfg.model.num_layers:.3f} ms a step "
          f"against the weight-stream floor {floor_ms:.3f} ms ({card})",
          flush=True)
    info.update(b6_ms_per_layer=b6_ms, b6_bound_ms_per_layer=b6_bound)
    del eng, pool
    torch.cuda.empty_cache()
    return info


def limit_readings(tf, tag):
    """The readings of :func:`logit_checks` for the paths line."""
    info = {f"{tag}_tol_dlogit": tf["tol"],
            f"{tag}_greedy_agreement": tf["kernels"]["agree"]}
    for ref in ("kernels", "sdpa", "lowp"):
        info[f"{tag}_{ref}_max_dlogit"] = tf[ref]["max"]
    return info


def full_checks(torch, eng, refs, prompts, greedy, steps, tf16,
                around=None):
    """Given the teacher-forced readings ``tf16``: the fused loop at B=4
    against the step path and the plain fused loop, ``generate_stream``
    against the fused loop on a lone prompt, and a profile; for w8a8 and
    MoE also ``score_nll`` against the plain path. ``around(ref)`` (a
    context manager for the kernels' run, ``ref`` None, or a reference's)
    wraps each compared run: path (k)'s :class:`ForcedRouting`. Returns
    the readings and the fused loop's kernel run (tokens and logits, as
    :func:`recording` takes them)."""
    check(all(len(p) == len(prompts[0]) for p in prompts), "ragged prompts")
    info, base = fused_checks(torch, eng, refs, prompts, greedy, steps,
                              tf16["tokens"], tf16["tol"], around)
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
    if eng.cfg.quant == "int8" or eng.cfg.num_experts:
        info.update(score_checks(eng, refs, prompts, around))
    info.update(profile_run(torch, "fused", lambda n: eng.generate_batch_fused(
        prompts, n, greedy)))
    if eng.cfg.quant == "int8":
        # where a prefill chunk's time goes (B10 or B15, the head's B11)
        prof = profile_run(torch, "prefill", lambda n: (
            eng.generate_batch_fused(prompts, n, greedy)), steps=1)
        info.update({f"prefill_{k}": v for k, v in prof.items()})
        # the fused run of 16 tokens is the same prefill and 15 decode steps
        info["decode_step_kernels"] = (
            info["profile_kernels"] - prof["profile_kernels"]) / 15
        print(f"  device kernels a decode step: "
              f"{info['decode_step_kernels']:.2f} ((fused run - prefill "
              f"run) / 15)", flush=True)
    return info, base


def score_checks(eng, refs, prompts, around=None):
    """``Engine.score_nll`` (B1/B4 and the matmul kernels at prefill
    shapes) against the plain path on the same sequences (each run inside
    ``around``, as :func:`full_checks` says)."""
    around = around or (lambda ref: contextlib.nullcontext())
    with around(None):
        kern = eng.score_nll(prompts)
    with around(refs["plain"]), recording(eng, refs["plain"]):
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
    """Inside: ``linear`` and the model reach ``fns[name]`` in place of the
    port's ``int8_matmul`` / ``w8_matmul`` / ``w4_matmul`` /
    ``chain_decode`` / ``packed_linear`` / ``grouped_matmul`` wrappers."""
    from importlib import import_module

    chain = import_module(f"{PKG}.ops.chain_linear")
    mods = {"int8_matmul": import_module(f"{PKG}.ops.int8_matmul"),
            "w8_matmul": import_module(f"{PKG}.ops.int8_matmul"),
            "w4_matmul": import_module(f"{PKG}.ops.int4_matmul"),
            "chain_decode": chain, "packed_linear": chain,
            "grouped_matmul": import_module(f"{PKG}.ops.gmm")}
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
    appended to the list it yields, where a prefill chunk's row replaces
    the row of the chunk before it: the prefill's final logits (the
    prompts fill their chunks exactly), then one row per decode step."""
    rows = []
    forward, saved = eng.model.forward, eng.backend
    state = {"chunk": False}

    def recording_forward(*args):
        logits, kv = forward(*args)
        chunk = args[1].shape[1] > 1
        if chunk and state["chunk"]:
            rows[-1] = logits[:, -1].float()
        else:
            rows.append(logits[:, -1].float())
        state["chunk"] = chunk
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


def forced_run(torch, eng, prompts, greedy, steps):
    """:func:`logit_checks`'s ``run`` for a path whose references prefill
    the prompts themselves: :func:`forced_logits`."""
    return lambda ref, feed: forced_logits(torch, eng, ref, prompts, greedy,
                                           steps, feed)


def forced_logits(torch, eng, ref, prompts, greedy, steps, feed=None):
    """Prefill + ``steps - 1`` decode steps through the reference ``ref``
    (``None``: the kernels), step ``s`` fed ``feed[:, s]``, else its own
    greedy token. The prefill's logits are ``EngineState.prefill_logits``
    (each prompt's last position, whatever its length), then each step's
    from ``_step_logits``. Returns the logits ``[steps, B, V]`` (f32,
    host) and the tokens fed ``[B, steps - 1]``."""
    with recording(eng, ref), torch.inference_mode():
        state = eng.prefill(prompts, sampling=greedy)
        rows = [torch.from_numpy(state.prefill_logits).to(eng.device)]
        fed = []
        for s in range(steps - 1):
            tok = (rows[-1].argmax(-1).to(torch.int32).cpu().numpy()
                   if feed is None else feed[:, s])
            fed.append(tok)
            rows.append(eng._step_logits(state, tok).float())
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


def logit_checks(torch, eng, refs, run, frac, tag, keep=False):
    """Teacher-forced logits of the kernel path and of two references,
    each against the plain path fed the same tokens: the SDPA path (a
    sound independent implementation; it must pass) and the
    lower-precision control (it must fail, or the limit could not tell a
    kernel computing at the control's precision from a right one). The
    limit is ``frac`` of max|logit|. With ``keep`` the readings also hold
    the plain path's logits (``"plain_logits"``) and the tokens fed
    (``"fed"``), for another control. ``run(ref, feed)`` gives the logits
    ``[steps, B, V]`` and the tokens fed of the kernels (``ref`` None,
    fed their own greedy tokens) or of a reference fed ``feed``."""
    lk, fed = run(None, None)
    lp, _ = run(refs["plain"], fed)
    res = {"kernels": compare(lk, lp)}
    for ref in ("sdpa", "lowp"):
        lr, _ = run(refs[ref], fed)
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
    if keep:
        res["plain_logits"], res["fed"] = lp, fed
    return res


def fused_checks(torch, eng, refs, prompts, greedy, steps, forced, tol,
                 around=None):
    """``generate_batch_fused`` at B=4, through the kernels and through
    the plain versions. Its kernel tokens must equal the teacher-forced
    kernel path's greedy tokens ``forced [B, steps]`` (the fused loop's
    own bookkeeping: pages allocated up front, device-side seq_lens). The
    plain loop's tokens must equal them until a row's first fork, which
    must fall on a step whose plain top-1 margin is at most twice that
    step's max|dlogit|; until then the logits stay within ``tol``. Each
    run inside ``around`` (:func:`full_checks`). Returns the readings and
    the kernel run's tokens and logits."""
    around = around or (lambda ref: contextlib.nullcontext())
    with around(None), recording(eng) as rk:
        tk = np.asarray(eng.generate_batch_fused(prompts, steps, greedy))
        lk = torch.stack(rk).cpu().numpy()
    with around(refs["plain"]), recording(eng, refs["plain"]) as rp:
        tp = np.asarray(eng.generate_batch_fused(prompts, steps, greedy))
        lp = torch.stack(rp).cpu().numpy()
    n_same = int((tk == forced).sum())
    print(f"  generate_batch_fused B={len(prompts)} kernels vs the "
          f"teacher-forced kernel path: {n_same} of {tk.size} tokens "
          f"equal (tol == all)", flush=True)
    check(n_same == tk.size, "fused loop tokens differ from the step path")
    compared, worst, forks = fork_checks(
        "generate_batch_fused kernels vs plain", tk, tp, lk, lp, f"limit "
        f"{tol:.4e}")
    check_limit(worst <= tol, "fused logits beyond the limit before the fork")
    return ({"fused_pairs_before_fork": compared,
             "fused_max_dlogit": worst, "fused_forks": len(forks)}, (tk, lk))


def fork_checks(what, tk, tr, lk, lr, note=""):
    """Tokens ``tk`` against the reference run's ``tr`` (``[B, steps]``)
    row by row up to each row's first fork, with the logits that chose
    them (``lk``, ``lr``: ``[steps, B, V]`` f32). Each fork must fall on
    a step whose reference top-1 margin is at most twice the max|dlogit|
    there (a token the two runs' rounding can decide either way).
    Returns the (step, row) pairs compared before the forks, their
    max|dlogit|, and the forks as (row, step, margin, max|dlogit|)."""
    compared, worst, forks = 0, 0.0, []
    for b in range(tk.shape[0]):
        for s in range(tk.shape[1]):
            d = float(np.abs(lk[s, b] - lr[s, b]).max())
            if tk[b, s] != tr[b, s]:
                top2 = np.sort(lr[s, b])[-2:]
                forks.append((b, s, float(top2[1] - top2[0]), d))
                break
            compared += 1
            worst = max(worst, d)
    shown = [(b, s, round(m, 5), round(d, 5)) for b, s, m, d in forks]
    print(f"  {what}: {compared} (step, row) pairs before the rows fork, "
          f"max|dlogit| {worst:.4e}{f' ({note})' if note else ''}; forks "
          f"(row, step, reference margin, max|dlogit|): {json.dumps(shown)}"
          f" (each margin must be <= 2x its max|dlogit|)", flush=True)
    check(all(m <= 2 * d for _, _, m, d in forks),
          f"{what}: forked on a decidable token")
    return compared, worst, forks


@contextlib.contextmanager
def forward_calls(eng, record=True):
    """Inside: one entry per ``model.forward`` call is appended to the
    list it yields: the call's positions (host) and logits (f32, on the
    card) with ``record``, else ``None`` (a count that adds no copy and
    no sync)."""
    calls = []
    forward = eng.model.forward

    def counted_forward(params, tokens, positions, kv, attn):
        logits, kv = forward(params, tokens, positions, kv, attn)
        calls.append((positions.cpu().numpy(), logits.float())
                     if record else None)
        return logits, kv

    eng.model.forward = counted_forward
    try:
        yield calls
    finally:
        del eng.model.forward


@contextlib.contextmanager
def token_repeating(eng, damp=2e-3):
    """Inside: ``eng`` runs a copy of its w8a8 weights that repeats its
    input token, so that drafts are accepted: every layer's attention
    and MLP output scaled by ``damp`` (through the ``wo`` and ``w_down``
    scales; the INT8 values are shared) and the LM head the embedding's
    transpose (weight-only INT8, as the w8a8 head is). At Llama-3-8B's
    width the 32 damped layers leave the final hidden state close to the
    input token's embedding, whose own logit then leads by a wide
    margin."""
    from importlib import import_module

    qt = import_module(f"{PKG}.quant.tensor")
    saved = eng.params
    params = dict(saved)
    params["layers"] = tuple(
        dict(lp, **{k: qt.QTensor(lp[k].values, lp[k].scales * damp)
                    for k in ("wo", "w_down")})
        for lp in saved["layers"])
    params["lm_head"] = qt.quantize_per_channel(saved["embedding"].t())
    eng.params = params
    try:
        yield
    finally:
        eng.params = saved


def spec_path(torch, eng, prompts, greedy, steps, card):
    """Path (e): :func:`spec_run` at ``bench.py --mode spec``'s
    configuration, then on the same engine with token-repeating weights
    (:func:`token_repeating`), where the verify chunk accepts drafts and
    advances by several tokens; a profile of one spec run."""
    info = spec_run(torch, eng, prompts, greedy, steps, card,
                    "random weights")
    with token_repeating(eng):
        rep = spec_run(torch, eng, prompts, greedy, steps, card,
                       "token-repeating weights")
    check(rep["verify_forwards"] < steps - 1,
          "the token-repeating spec run accepted no draft")
    info.update({f"repeating_{k}": v for k, v in rep.items()
                 if k != "launches"})
    info.update(profile_run(torch, "spec", lambda n: eng.generate_batch_spec(
        prompts, n, greedy, spec_k=SPEC_K, ngram=SPEC_NGRAM)))
    return info


def spec_run(torch, eng, prompts, greedy, steps, card, label):
    """``generate_batch_spec`` and ``generate_batch_fused`` on the same
    prompts, each timed bare; the spec run's launch counts checked
    exactly against its counted verify forwards. Then one untimed run
    of each that records the logits behind every token, and the spec
    tokens held against the fused ones by the fork rule."""
    from importlib import import_module

    plat = import_module(f"{PKG}.utils.platform")
    batch, L = len(prompts), len(prompts[0])
    spec = lambda n: eng.generate_batch_spec(prompts, n, greedy,
                                             spec_k=SPEC_K, ngram=SPEC_NGRAM)
    fused = lambda n: eng.generate_batch_fused(prompts, n, greedy)

    def timed(fn, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(n)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    spec(4)                                                  # warm-ups
    fused(4)
    prefill_s = timed(fused, 1)[1]                           # prefill only
    fused_s = timed(fused, steps)[1]
    with forward_calls(eng, record=False) as calls:
        plat.reset_launch_counts()
        toks, spec_s = timed(spec, steps)
        counts = {n: k.launches for n, k in plat.KERNELS.items()}
    check(eng.allocator.num_free == eng.cache.num_pages - 1,
          "generate_batch_spec kept pages")
    verifies = len(calls) - 1                     # the first is the prefill
    print(f"  [{label}] launches in the timed spec run: "
          f"{json.dumps(counts)}", flush=True)
    expect = expected_spec_launches(eng.cfg.quant, eng.cfg.num_layers,
                                    verifies, attention=b1_kernel(eng))
    check(counts == expect,
          f"spec ({label}): launches {counts}, expected exactly {expect}")
    check(all(len(r) == steps for r in toks), "spec rows are not full")
    with recording(eng) as rows:
        tf = np.asarray(fused(steps))
    lf = torch.stack(rows).cpu().numpy()                 # [steps, B, V]
    with forward_calls(eng) as rec:
        ts = np.asarray(spec(steps))
    # the logits that chose each emitted token: the prefill's last
    # position, then each verify position i (at absolute position p,
    # choosing token p + 1); a later verify overwrites the candidates an
    # earlier one did not emit
    ls = torch.empty((steps, batch, eng.cfg.vocab_size),
                     device=rec[0][1].device)
    ls[0] = rec[0][1][:, L - 1]
    for pos, logits in rec[1:]:
        for b in range(batch):
            for i in range(pos.shape[1]):
                e = int(pos[b, i]) + 1 - L
                if pos[b, i] >= 0 and 0 < e < steps:
                    ls[e, b] = logits[b, i]
    compared, worst, forks = fork_checks(
        f"[{label}] generate_batch_spec vs generate_batch_fused", ts, tf,
        ls.cpu().numpy(), lf)
    tokens = batch * (steps - 1)
    spec_tps = tokens / (spec_s - prefill_s)
    fused_tps = tokens / (fused_s - prefill_s)
    print(f"  [{label}] {verifies} verify forwards (T={SPEC_K + 1}) for "
          f"{steps - 1} tokens a sequence after the first: "
          f"{(steps - 1) / verifies:.3f} tokens per verify forward per "
          f"sequence ({tokens / verifies:.2f} for the batch of {batch}; "
          f"the recorded run took {len(rec) - 1})", flush=True)
    print(f"  [{label}] decode tok/s on the motif prompts: spec "
          f"{spec_tps:.1f} (total {spec_s * 1e3:.1f} ms), "
          f"generate_batch_fused {fused_tps:.1f} (total "
          f"{fused_s * 1e3:.1f} ms), prefill {prefill_s * 1e3:.2f} ms; "
          f"spec/fused {spec_tps / fused_tps:.3f} ({card})", flush=True)
    return {"verify_forwards": verifies,
            "tokens_per_verify_per_seq": (steps - 1) / verifies,
            "spec_decode_tok_s": spec_tps, "fused_decode_tok_s": fused_tps,
            "prefill_ms": prefill_s * 1e3, "spec_total_ms": spec_s * 1e3,
            "fused_total_ms": fused_s * 1e3, "launches": counts,
            "spec_pairs_before_fork": compared, "spec_max_dlogit": worst,
            "spec_forks": len(forks)}


def fused_append_path(torch, eng, prompts, greedy, steps, card, base):
    """Path (f): path (b)'s ``generate_batch_fused`` with
    ``PBT_FUSED_APPEND=1`` set around the call, so every decode layer runs
    B9 in place of B3 and B2: exact launch counts, and tokens held by the
    fork rule against path (b)'s recorded kernel run ``base`` (tokens,
    logits) on the same engine and prompts."""
    saved = os.environ.get("PBT_FUSED_APPEND")
    os.environ["PBT_FUSED_APPEND"] = "1"
    try:
        info = drive(torch, eng, prompts, greedy, steps, "fused-append",
                     fused_append=True)
        with recording(eng) as rows:
            tf = np.asarray(eng.generate_batch_fused(prompts, steps, greedy))
        lf = torch.stack(rows).cpu().numpy()
    finally:
        if saved is None:
            del os.environ["PBT_FUSED_APPEND"]
        else:
            os.environ["PBT_FUSED_APPEND"] = saved
    compared, worst, forks = fork_checks(
        "fused append vs path (b)", tf, base[0], lf, base[1])
    print(f"  fused-append decode {info['decode_tok_s']:.1f} tok/s ({card})",
          flush=True)
    info.update(pairs_before_fork=compared, max_dlogit=worst,
                forks=len(forks))
    return info


def megakernel_path(torch, holder, held_b, refs, prompts, greedy, steps,
                    card, base):
    """Path (j), ``bench.py --megakernel``: an engine with ``megakernel``
    and ``megakernel_drop_weights`` built on path (b)'s w8a8 weights
    (``holder["params"]``, handed over, so the per-op copies are freed once
    packed): chains held in place of the per-op weights, exact launch
    counts (B14 a decode layer, B15 at prefill), teacher-forced logits
    within (b)'s limit, :func:`full_checks` (score_nll and a profile
    included), and its tokens against (b)'s recorded run ``base`` by the
    fork rule."""
    from importlib import import_module

    eng_mod = import_module(f"{PKG}.engine")
    cfg = path_config("int8")[0]
    cfg.runtime.megakernel = True
    cfg.runtime.megakernel_drop_weights = True
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = eng_mod.Engine(cfg, params=holder.pop("params"))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 1e9
    print(f"  engine built on path (b)'s weights in "
          f"{time.perf_counter() - t0:.1f} s; holds {held:.2f} GB on the "
          f"card (path (b)'s engine held {held_b:.2f} GB; peak while "
          f"packing {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
          "both layouts)", flush=True)
    layers, chains = eng.params["layers"], eng.params.get("chains", ())
    check(len(chains) == cfg.model.num_layers, "megakernel: no chains")
    check("wo" not in layers[1] and "w_qkv" not in layers[1]
          and "w_gu" not in layers[1] and "w_qkv" in layers[0],
          "megakernel: per-op copies kept")
    info = drive(torch, eng, prompts, greedy, steps, "megakernel")
    info.update(engine_gb=held, engine_gb_per_op=held_b)
    tf16 = logit_checks(torch, eng, refs, forced_run(
        torch, eng, prompts, greedy, steps), TOL[("int8", "bf16")], "bf16")
    info.update(limit_readings(tf16, "bf16"))
    checks, run = full_checks(torch, eng, refs, prompts, greedy, steps,
                              tf16)
    info.update(checks)
    compared, worst, forks = fork_checks("megakernel vs path (b)", run[0],
                                         base[0], run[1], base[1])
    info.update(vs_b_pairs_before_fork=compared, vs_b_max_dlogit=worst,
                vs_b_forks=len(forks))
    per_layer = info["profile_kernel_ms"].get("chain_decode", 0.0) / (
        cfg.model.num_layers * 15)
    print(f"  megakernel decode {info['decode_tok_s']:.1f} tok/s ({card}); "
          f"B14 {per_layer:.4f} ms a layer in the profiled run",
          flush=True)
    info["chain_decode_ms_per_layer"] = per_layer
    del eng
    torch.cuda.empty_cache()
    return info


class Routes:
    """One run's router calls, in order: each call's router logits (f32,
    host, ``[tokens, E]``) and top-k experts (``[tokens, k]``)."""

    def __init__(self):
        self.logits, self.picks = [], []


@contextlib.contextmanager
def routing(eng, record, force=None):
    """Inside: each router call of ``eng``'s model is appended to the
    :class:`Routes` ``record``. With ``force`` (the kernels' run's
    Routes), call ``i`` routes each token to the experts of ``force``'s
    call ``i``, its gates the softmax of its own logits there: a
    reference then follows the kernels' routing, so that a router
    near-tie that rounding decides the other way (which random weights
    amplify into a cascade of other decisions over the layers) does not
    fork it; :func:`routing_flips` holds its own decisions to the fork
    rule."""
    from importlib import import_module

    import torch

    linear = import_module(f"{PKG}.ops.linear").linear
    route = eng.model._route

    def routed(lp, h2):
        topi, gates = route(lp, h2)
        r = linear(h2, lp["router"]).float().reshape(
            -1, lp["router"].shape[-1])
        record.logits.append(r.cpu())
        record.picks.append(topi.reshape(r.shape[0], -1).cpu())
        if force is None:
            return topi, gates
        picks = force.picks[len(record.picks) - 1].to(h2.device)
        check(picks.shape == record.picks[-1].shape,
              "forced routing: the runs' router calls differ")
        gates = torch.softmax(r.gather(-1, picks), dim=-1)
        return picks.reshape(topi.shape), gates.reshape(topi.shape)

    eng.model._route = routed
    try:
        yield record
    finally:
        del eng.model._route


class ForcedRouting:
    """``around`` for :func:`full_checks`: the kernels' run records its
    routes, each reference's run follows them."""

    def __init__(self, eng):
        self.eng, self.kernels = eng, None

    def __call__(self, ref):
        if ref is None:
            self.kernels = Routes()
            return routing(self.eng, self.kernels)
        return routing(self.eng, Routes(), force=self.kernels)


def routing_flips(kern, ref, what):
    """The (layer, token) decisions where a reference run forced to the
    kernels' routing (:func:`routing`) would have picked other experts
    itself, held to the fork rule: at each, the reference's margin (its
    own k-th logit over its logit of the kernels' pick) must be at most
    twice that token's max|router logit difference| from the kernels'.
    Returns (decisions that differ, decisions)."""
    differ = total = 0
    worst = []
    for rk, pk, rr, pr in zip(kern.logits, kern.picks, ref.logits,
                              ref.picks):
        total += pk.shape[0]
        flip = (pr.sort(dim=-1)[0] != pk.sort(dim=-1)[0]).any(-1)
        if not flip.any():
            continue
        differ += int(flip.sum())
        k = pk.shape[-1]
        kth = rr.topk(k, dim=-1)[0][:, -1]
        margin = kth - rr.gather(-1, pk).min(-1)[0]
        dr = (rr - rk).abs().max(-1)[0]
        bad = flip & (margin > 2 * dr)
        worst.extend((float(m), float(d)) for m, d in zip(margin[bad],
                                                          dr[bad]))
    print(f"  routing, {what}: {differ} of {total} (layer, token) decisions "
          f"would differ from the kernels' (each at a margin <= 2x the "
          f"token's max|router dlogit|: "
          f"{'ok' if not worst else f'FAIL, {worst[:5]}'})", flush=True)
    check(not worst, f"{what}: a routing decision differs past its margin")
    return differ, total


def moe_path(torch, refs, greedy, card):
    """Path (k): Mixtral-8x7B with INT8 experts (``int8-weight``) at full
    width and :data:`MOE_LAYERS` of depth, built after every earlier
    engine is freed (the
    memory in use printed first, then the build's and its peak). The
    timed run with exact launch counts, and a prefill chunk alone (B13
    twice a layer, no expert B11); the dispatch held against the masked
    loop on layer 0's activations from the real prefill; the
    teacher-forced logit checks, :func:`full_checks` and ``score_nll``,
    each reference following the kernels' routing (:func:`routing`), with
    the (layer, token) decisions where it would have routed otherwise
    held to the fork rule (:func:`routing_flips`)."""
    import gc
    from importlib import import_module

    plat = import_module(f"{PKG}.utils.platform")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  before the build: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"allocated, {torch.cuda.memory_reserved() / 1e9:.2f} GB reserved",
          flush=True)
    cfg, batch, steps, prompt_len = path_config(
        "int8-weight", model=MOE_MODEL, layers=MOE_LAYERS, batch=MOE_BATCH,
        prompt_len=MOE_PROMPT, steps=MOE_STEPS)
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.model.vocab_size, size=(batch, prompt_len)).tolist()
    eng, held = build_engine(torch, cfg)
    peak = torch.cuda.max_memory_allocated() / 1e9
    L, E = cfg.model.num_layers, cfg.model.num_experts
    layers = eng.params["layers"]
    check(all("we_gate" not in lp and lp["we_gu"].values.dtype == torch.int8
              for lp in layers), "moe: the experts are not fused INT8")
    n_dispatch = dispatch_chunks(eng, prompts)
    check(n_dispatch == 1, f"moe: {n_dispatch} prefill chunks dispatch, "
          "expected the one")
    info = drive(torch, eng, prompts, greedy, steps, "moe")
    info.update(engine_gb=held, build_peak_gb=peak)

    # a prefill chunk alone (the fused loop's first token is the prefill's)
    plat.reset_launch_counts()
    eng.generate_batch_fused(prompts, 1, greedy)
    torch.cuda.synchronize()
    counts = {n: k.launches for n, k in plat.KERNELS.items()}
    expect = expected_launches(cfg.model.quant, L, 1, experts=E,
                               dispatch_chunks=1, attention=b1_kernel(eng))
    print(f"  a prefill chunk alone: B13 {counts['grouped_matmul']}, B11 "
          f"{counts['w8_matmul']} (qkv, o and the head only), B1 "
          f"{counts[b1_kernel(eng)]}, B4 {counts['kv_append_prefill']}",
          flush=True)
    check(counts == expect,
          f"moe prefill chunk: launches {counts}, expected exactly {expect}")

    # the dispatch against the masked loop on layer 0's activations
    captured = {}
    moe = eng.model._moe

    def capture(lp, h2, w8a8):
        if not captured:
            captured.update(lp=lp, h2=h2.clone())
        return moe(lp, h2, w8a8)

    eng.model._moe = capture
    try:
        eng.free(eng.prefill(prompts, sampling=greedy))
    finally:
        del eng.model._moe
    lp, h2 = captured["lp"], captured["h2"]
    topi, gates = eng.model._route(lp, h2)
    got = eng.model._moe_dispatch(lp, h2, topi, gates).float()
    want = eng.model._moe_masked(lp, h2, topi, gates, False).float()
    err = (got - want).abs().max().item()
    # gate and up, each expert's output and the gated sum are rounded to
    # bf16 in both, after f32 sums in another order: a value may move by
    # a bf16 step at each rounding; a misrouted row moves by O(max|out|)
    tol = 2e-2 * want.abs().max().item()
    print(f"  dispatch (B13) vs masked loop (B11) on layer 0's "
          f"{tuple(h2.shape)} activations from the prefill: max|d| "
          f"{err:.4e} (tol {tol:.4e} = 2e-2 of max|out| "
          f"{want.abs().max().item():.4f}) {'ok' if err <= tol else 'FAIL'}",
          flush=True)
    check(err <= tol and bool(torch.isfinite(got).all()),
          "moe: the dispatch differs from the masked loop")
    info.update(dispatch_vs_masked=err, dispatch_vs_masked_tol=tol)
    del captured, lp, h2, got, want

    # teacher-forced logits, each reference following the kernels' routing
    forcing, routes = ForcedRouting(eng), {}
    forced = forced_run(torch, eng, prompts, greedy, steps)

    def run(ref, feed):
        with forcing(ref) as r:
            out = forced(ref, feed)
        routes[next(n for n, v in refs.items() if v is ref)
               if ref is not None else "kernels"] = r
        return out

    tf16 = logit_checks(torch, eng, refs, run, TOL[("moe", "bf16")], "bf16")
    info.update(limit_readings(tf16, "bf16"))
    for name in ("plain", "sdpa"):
        differ, total = routing_flips(
            routes["kernels"], routes[name],
            f"the {name} teacher-forced run ({L} layers, "
            f"{len(routes[name].picks) // L} forwards)")
        info.update({f"routing_differ_{name}": differ,
                     "routing_decisions": total})

    checks, _ = full_checks(torch, eng, refs, prompts, greedy, steps, tf16,
                            around=forcing)
    info.update(checks)
    b13 = info["profile_kernel_ms"].get("grouped_matmul", 0.0) / L
    print(f"  moe decode {info['decode_tok_s']:.1f} tok/s, prefill "
          f"{info['prefill_ms']:.1f} ms; B13 {b13:.4f} ms a layer in the "
          f"profiled run's prefill chunk, {b13 * L:.1f} ms a chunk "
          f"({b13 * L / info['prefill_ms']:.3f} of the timed prefill); "
          f"engine {held:.2f} GB, build peak {peak:.2f} GB ({card})",
          flush=True)
    info["grouped_matmul_ms_per_layer"] = b13
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return info



# -- path (m): beam search and the reranker ---------------------------------

#: path (m): bench.py --mode beam --batch 4 (the beam width) on (b)'s w8a8
#: Llama-3-8B, its 64-token prompt, 32 of bench.py's 64 tokens (the
#: script's time), and 8 decode_scored steps at B=4
BEAM_W, BEAM_STEPS, SCORED_STEPS = 4, 32, 8
#: a search's cumulative log-probs against the replay of its tokens
#: through the same route (:func:`replay_logprobs`): the same arithmetic
#: row by row, so only f32 rounding of sums near 256 (an ulp 1.5e-5) over
#: 32 additions, with margin
TOL_BEAM_SUM = 1e-3


def beam_config():
    """``bench.py --mode beam``'s configuration: (b)'s pool with
    ``beam_burst_max * W`` more pages for the bursts' fresh pages
    (bench.py:318-321)."""
    cfg = path_config("int8")[0]
    cfg.cache.num_pages += cfg.runtime.beam_burst_max * BEAM_W
    return cfg


class BeamWatch:
    """Inside: a searcher's device steps counted and checked. Each burst
    (``_beam_burst``) runs under ``torch.cuda.set_sync_debug_mode
    ("error")``, so a read to the host inside it raises, with every
    launch count set to 0 just before and held after to ``num_steps``
    decode steps' exact counts (B3 and B2 a layer, B10 four a layer, the
    head's B11; no B1); each fused step (``_beam_step``) to one step's.
    ``bursts`` records the lengths, ``burst_args`` the first burst's
    inputs (for a profile) and ``traces`` its first tokens, first scores,
    parents, tokens and scores (host). ``count=False`` (a search through
    the plain versions) records without counting or the sync check."""

    def __init__(self, torch, eng, searcher, count=True):
        self.torch, self.eng, self.searcher = torch, eng, searcher
        self.count = count
        self.bursts, self.steps, self.burst_args = [], 0, None
        self.traces = None

    def expect(self, steps):
        from importlib import import_module

        plat = import_module(f"{PKG}.utils.platform")
        L = self.eng.cfg.num_layers
        out = dict.fromkeys(plat.KERNELS, 0)
        out.update(kv_append_decode=L * steps,
                   paged_attention_decode=L * steps)
        out.update(matmul_launches("int8", L, steps))
        return out

    def counted(self, fn, steps, what):
        from importlib import import_module

        if not self.count:
            return fn()
        torch = self.torch
        plat = import_module(f"{PKG}.utils.platform")
        plat.reset_launch_counts()
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        counts = {n: k.launches for n, k in plat.KERNELS.items()}
        check(counts == self.expect(steps), f"(m) {what}: launches "
              f"{counts}, expected exactly {self.expect(steps)}")
        return out

    def __enter__(self):
        s = self.searcher
        burst, step = self.saved = s._beam_burst, s._beam_step

        def watched_burst(*args, num_steps):
            first = self.burst_args is None
            if first:
                self.burst_args = args
            self.bursts.append(num_steps)
            out = self.counted(lambda: burst(*args, num_steps=num_steps),
                               num_steps, f"a burst of {num_steps} steps")
            if first:
                self.traces = [t.cpu().numpy() for t in (
                    args[1], args[5], out[0], out[1], out[2])]
            return out

        def watched_step(*args):
            self.steps += 1
            return self.counted(lambda: step(*args), 1, "a fused step")

        if burst is not None:
            s._beam_burst = watched_burst
        s._beam_step = watched_step
        return self

    def __exit__(self, *exc):
        self.searcher._beam_burst, self.searcher._beam_step = self.saved


def burst_rows(traces, steps):
    """Each row of a search's one burst, from its traces: its tokens and
    its cumulative log-prob after each (the first from the burst's entry
    scores, then the burst's f32 scores along its parents), over the
    first ``steps`` steps: ``(tokens [W, steps + 1], cum [W, steps + 1])``
    (host)."""
    tok0, score0, pars, toks, vals = traces
    tokens, cums = [], []
    for w in range(pars.shape[1]):
        chain = [w]
        for k in range(steps - 1, 0, -1):
            chain.insert(0, int(pars[k][chain[0]]))
        root = int(pars[0][chain[0]])
        cums.append([float(score0[root])] + [float(vals[k][chain[k]])
                                             for k in range(steps)])
        tokens.append([int(tok0[root])] + [int(toks[k][chain[k]])
                                           for k in range(steps)])
    return np.asarray(tokens, np.int64), np.asarray(cums, np.float64)


def replay_logprobs(torch, eng, ref, prompt, tokens, greedy):
    """The log-prob of each of ``tokens [W, n]`` after ``prompt`` and the
    tokens before it, teacher-forced through ``ref`` (``None``: the
    kernels) the way a beam search computes it: the prompt prefilled once
    (batch 1) and its pages copied into W rows, ``n - 1`` decode steps at
    batch W, the first log-prob in f64 on the host, the others by the
    f32 log-softmax on the card, summed in f32 (``engine/beam.py``). Each
    row is the search's own arithmetic on the same inputs, so a search
    whose copy-on-write pages are right has these cumulative log-probs to
    f32 rounding. Returns ``(lp [W, n], cum [W, n])`` (host)."""
    from importlib import import_module

    kvp = import_module(f"{PKG}.kvcache.pool")
    beam = import_module(f"{PKG}.engine.beam")
    W, n = tokens.shape
    V = eng.cfg.vocab_size

    def ids(a):
        return torch.tensor(a, dtype=torch.int32, device=eng.device)

    with recording(eng, ref) as rows, torch.inference_mode():
        state = eng.prefill([prompt], sampling=greedy)
        src = state.pages[0]
        pages = [eng.allocator.alloc_many(len(src)) for _ in range(W)]
        kvp.copy_pages_tree(state.kv, ids(src * W), ids(sum(pages, [])))
        eng.free(state)
        state.pages = pages
        state.seq_lens = np.full((W,), len(prompt), np.int32)
        state.finished = np.zeros((W,), bool)
        for s in range(n - 1):
            eng.decode_forced(state, tokens[:, s].astype(np.int32))
        eng.free(state)
        lp0 = beam._log_softmax(state.prefill_logits[0])[tokens[:, 0]]
        cum = torch.tensor(lp0, dtype=torch.float32, device=eng.device)
        tok = torch.tensor(tokens, dtype=torch.long, device=eng.device)
        cums = [cum]
        for s in range(1, n):
            lp = torch.log_softmax(rows[s][:, :V], dim=-1)
            cum = cum + lp.gather(1, tok[:, s:s + 1])[:, 0]
            cums.append(cum)
        cum = torch.stack(cums, dim=1).double().cpu().numpy()
    check(np.isfinite(cum).all(), "(m) non-finite replayed log-probs")
    lp = np.diff(cum, axis=1, prepend=0.0)
    lp[:, 0] = lp0
    return lp, cum


def beam_path(torch, eng_b, refs, prompts, greedy, card, tol, results):
    """Path (m), ``bench.py --mode beam``: an engine with the beam pool on
    (b)'s w8a8 weights (no second copy), beam search of width 4 on a
    64-token prompt and a log-prob rerank of its hypotheses; the checks
    (bursts against the per-step search token for token, width 1 against
    ``generate``; every prefix's cumulative log-prob of every beam row
    (from the burst's traces) against the replay of its tokens through
    the same route (:func:`replay_logprobs`) within ``TOL_BEAM_SUM``, for
    the search on the kernels and the same search through the plain
    versions; every token's log-prob against the plain versions'
    teacher-forced one within (b)'s logit limit ``tol``; a sentinel run
    with the copy-on-write copies skipped that must fail the first; every
    page back, no host read inside a burst, exact launch counts,
    ``LogProbScorer`` batch against single). Printed beside them: each
    hypothesis's cumulative score against ``score_candidates_nll`` of its
    tokens through the plain versions, and the kernels' mean signed
    log-prob difference from the plain versions' on each search's tokens
    (selection bias and a bias of the kernels told apart). Then
    ``decode_scored``:
    B1 with the score export in every layer, its logits against
    ``decode_forced`` on a twin state and every layer's scores against the
    plain version on the same inputs."""
    from importlib import import_module

    plat = import_module(f"{PKG}.utils.platform")
    pa = import_module(f"{PKG}.ops.paged_attention")
    eng_mod = import_module(f"{PKG}.engine")
    kvp = import_module(f"{PKG}.kvcache.pool")
    rerank = import_module(f"{PKG}.reranker")
    t0 = time.perf_counter()

    def lap(what):
        print(f"  ({what}: {time.perf_counter() - t0:.1f} s into (m))",
              flush=True)

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    cfg = beam_config()
    eng = eng_mod.Engine(cfg, params=eng_b.params)
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    print(f"  engine on path (b)'s weights: torch.cuda.memory_allocated "
          f"{before / 1e9:.3f} GB before, {after / 1e9:.3f} GB after "
          f"({cfg.cache.num_pages} pages, {cfg.cache.max_pages_per_seq} a "
          f"sequence)", flush=True)
    check(after - before < 1e8, "(m) built a second copy of the weights")
    prompt = prompts[0]
    live0 = eng.allocator.num_live

    def search(burst=None, width=BEAM_W, steps=BEAM_STEPS):
        searcher = eng_mod.BeamSearcher(eng, beam_width=width, burst=burst)
        with BeamWatch(torch, eng, searcher) as watch:
            torch.cuda.synchronize()
            t = time.perf_counter()
            hyps = searcher.search(prompt, steps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        check(searcher.allocator.num_live == 0
              and eng.allocator.num_live == live0,
              "(m) a search kept pages")
        return hyps, wall, watch

    per_step, step_wall, w1 = search(burst=1)
    hyps, wall, watch = search()
    lap("per-step and burst searches")
    tps = BEAM_W * BEAM_STEPS / wall
    same = [h.tokens for h in hyps] == [h.tokens for h in per_step]
    dscore = max(abs(a.score - b.score) for a, b in zip(hyps, per_step))
    print(f"  beam search, width {BEAM_W}, {BEAM_STEPS} tokens: bursts of "
          f"{watch.bursts} steps ({watch.steps} fused steps after): wall "
          f"{wall * 1e3:.1f} ms, {tps:.1f} tokens/s (W rows' tokens over "
          f"the wall, prefill included; {card}); per step ({w1.steps} fused "
          f"steps) {step_wall * 1e3:.1f} ms; hypotheses "
          f"{'identical' if same else 'DIFFERENT'} token for token, "
          f"max|dscore| {dscore:.3e}", flush=True)
    check(same, "(m) the burst search differs from the per-step search")
    check(watch.bursts and w1.steps == BEAM_STEPS - 1,
          "(m) the searches did not take their routes")
    step_counts = {k: v for k, v in watch.expect(1).items() if v}
    print(f"  launches a beam step, exact in every burst and fused step: "
          f"{json.dumps(step_counts)} (B1 0)", flush=True)
    one, _, _ = search(width=1, steps=16)
    alone = eng.generate(prompt, 16, greedy)
    print(f"  width 1 against generate, 16 tokens: "
          f"{'identical' if one[0].tokens == alone else 'DIFFERENT'}",
          flush=True)
    check(one[0].tokens == alone, f"(m) width 1 {one[0].tokens} != "
          f"generate {alone}")

    check(len(watch.bursts) == 1, "(m) the search took more than one burst")

    def replayed(w, route, what):
        """A search's rows (its one burst's traces) against the replay of
        their tokens through ``route`` (``None``: the kernels): every
        prefix's cumulative log-prob, max|d|."""
        toks, cum = burst_rows(w.traces, BEAM_STEPS - 1)
        lp, rcum = replay_logprobs(torch, eng, route, prompt, toks, greedy)
        d = float(np.abs(cum - rcum).max())
        print(f"  {what}: every prefix's cumulative log-prob ({toks.shape[0]}"
              f" rows x {toks.shape[1]}) against the replay of its tokens "
              f"through the {'plain versions' if route else 'kernels'}: "
              f"max|d| {d:.3e} (limit {TOL_BEAM_SUM:g})", flush=True)
        return d, toks, cum, lp, rcum

    # the search against its own route's replay: the beam's copy-on-write
    # pages, log-softmax and f32 sums, to rounding
    d_kern, toks_k, cum_k, _, kk = replayed(watch, None, "hypotheses")
    with recording(eng, refs["plain"]):
        plain_searcher = eng_mod.BeamSearcher(eng, beam_width=BEAM_W)
        with BeamWatch(torch, eng, plain_searcher, count=False) as pw:
            plain_hyps = plain_searcher.search(prompt, BEAM_STEPS)
    check(len(pw.bursts) == 1 and plain_searcher.allocator.num_live == 0,
          "(m) the plain search took more than one burst or kept pages")
    d_plain, toks_p, _, _, pp = replayed(
        pw, refs["plain"], "the same search through the plain versions")
    # the kernels' hypotheses against the plain versions' log-probs
    lp_kp, cum_kp = replay_logprobs(torch, eng, refs["plain"], prompt,
                                    toks_k, greedy)
    d_ok = float(np.abs(np.diff(cum_k, axis=1, prepend=0.0) - lp_kp).max())
    print(f"  hypotheses: every token's log-prob against the plain versions' "
          f"teacher-forced one: max|d| {d_ok:.4f} (limit {tol:.4f}, (b)'s "
          f"logit limit)", flush=True)
    # the cause of the sums' drift: each route's tokens scored by both;
    # selection moves the two signed differences apart, a bias of the
    # kernels moves them together
    _, cum_pk = replay_logprobs(torch, eng, None, prompt, toks_p, greedy)
    n_tok = BEAM_STEPS
    sel_k = float((kk[:, -1] - cum_kp[:, -1]).mean()) / n_tok
    sel_p = float((cum_pk[:, -1] - pp[:, -1]).mean()) / n_tok
    print(f"  kernels minus plain, mean signed log-prob a token: "
          f"{sel_k:+.4f} on the kernels' hypotheses, {sel_p:+.4f} on the "
          f"plain search's; half their sum (the kernels' own bias) "
          f"{(sel_k + sel_p) / 2:+.4f}, half their difference (selection) "
          f"{(sel_k - sel_p) / 2:+.4f}", flush=True)
    hyp_toks = [h.tokens for h in hyps]
    with recording(eng, refs["plain"]):
        plain_nll = eng.score_candidates_nll(prompt, hyp_toks, mean=False)
        plain_nll_p = eng.score_candidates_nll(
            prompt, [h.tokens for h in plain_hyps], mean=False)
    d_sum = max(abs(h.score + v) for h, v in zip(hyps, plain_nll))
    d_sum_p = max(abs(h.score + v) for h, v in zip(plain_hyps, plain_nll_p))
    print(f"  cumulative log-probs against score_candidates_nll of their "
          f"tokens through the plain versions (sums over {BEAM_STEPS} "
          f"tokens): the kernels' search {[round(h.score, 4) for h in hyps]}"
          f" against {[round(-float(v), 4) for v in plain_nll]}, max|d| "
          f"{d_sum:.4f}; the plain search's max|d| {d_sum_p:.4f}", flush=True)
    check(np.isfinite(plain_nll).all() and np.isfinite(plain_nll_p).all(),
          "(m) score_candidates_nll is not finite")
    check(d_kern <= TOL_BEAM_SUM and d_plain <= TOL_BEAM_SUM,
          f"(m) a search's cumulative log-probs are {d_kern} (kernels) / "
          f"{d_plain} (plain) from the replay of its tokens (limit "
          f"{TOL_BEAM_SUM})")
    check(d_ok <= tol, f"(m) a token's log-prob is {d_ok} from the plain "
          f"path's (limit {tol})")
    real_copy = kvp.copy_pages_tree
    kvp.copy_pages_tree = lambda kv, src, dst: kv
    try:
        _, _, bad = search()
    finally:
        kvp.copy_pages_tree = real_copy
    d_bad = replayed(bad, None, "sentinel (copy-on-write copies skipped)")[0]
    check(d_bad > TOL_BEAM_SUM, "(m) the sentinel with no copy-on-write "
          "copies passed the replay check")
    lap("checks against the replays, the plain path and the sentinel")

    scorer = rerank.LogProbScorer(eng)
    toks = [h.tokens for h in hyps]
    torch.cuda.synchronize()
    t = time.perf_counter()
    batch = rerank.Reranker(scorer).rerank_scores(prompt, toks)
    torch.cuda.synchronize()
    rerank_ms = (time.perf_counter() - t) * 1e3
    single = [scorer.score(prompt, c) for c in toks]
    rel = max(abs(a - b) for a, b in zip(batch, single)) / max(
        abs(b) for b in single)
    print(f"  LogProbScorer over the hypotheses: batch {np.round(batch, 5)}"
          f" ({rerank_ms:.1f} ms), one at a time {np.round(single, 5)}: "
          f"max relative difference {rel:.3e} (tol {TOL_SCORE:g})",
          flush=True)
    check(rel <= TOL_SCORE and scorer._allocator.num_live == 0,
          "(m) LogProbScorer's batch differs from its single scores")

    burst_fn = eng._decode_beam_burst
    prof = profile_run(torch, "beam burst", lambda n: burst_fn(
        *watch.burst_args, num_steps=n), steps=8)
    print(f"  one burst of 8 steps: busy share "
          f"{prof['profile_busy_share']:.3f} ({card})", flush=True)
    lap("rerank and the profile")

    # decode_scored: every layer's B1 with the export, held against the
    # plain version on the same inputs
    kname = "paged_attention_wgmma"
    real_attend = eng.backend.attend
    errs = {"max": 0.0, "top": 0.0, "dead_ok": True, "calls": 0}

    def checked_attend(*args, return_scores=False, **kw):
        out = real_attend(*args, return_scores=return_scores, **kw)
        if return_scores:
            _, ref = pa.paged_attention_plain(*args, return_scores=True, **kw)
            dead = ref <= -1e29
            errs["dead_ok"] &= bool(torch.equal(out[1] <= -1e29, dead))
            errs["max"] = max(errs["max"], (out[1][~dead] - ref[~dead]).abs(
            ).max().item())
            errs["top"] = max(errs["top"], ref[~dead].abs().max().item())
            errs["calls"] += 1
        return out

    twin = eng.prefill(prompts, sampling=greedy)
    st = eng.prefill(prompts, sampling=greedy)
    tok = st.last_tokens
    worst = 0.0
    per_step = []
    eng.backend.attend = checked_attend
    try:
        for _ in range(SCORED_STEPS):
            plat.reset_launch_counts()
            logits, scores = eng.decode_scored(st, tok)
            counts = {n: k.launches for n, k in plat.KERNELS.items()}
            per_step.append(plat.KERNELS[kname].score_launches)
            want = dict.fromkeys(plat.KERNELS, 0)
            want.update(kv_append_decode=eng.cfg.num_layers,
                        paged_attention_wgmma=eng.cfg.num_layers)
            want.update(matmul_launches("int8", eng.cfg.num_layers, 1))
            check(counts == want, f"(m) decode_scored: launches {counts}, "
                  f"expected exactly {want}")
            forced = eng.decode_forced(twin, tok)
            worst = max(worst, float(np.abs(logits - forced).max()))
            check(scores.shape == (eng.cfg.num_layers, len(prompts),
                                   cfg.cache.max_pages_per_seq)
                  and np.isfinite(logits).all(), "(m) decode_scored shapes")
            tok = logits.argmax(-1).astype(np.int32)
    finally:
        del eng.backend.attend
    eng.free(st)
    eng.free(twin)
    ok = (errs["dead_ok"] and errs["max"] <= TOL_B1_SCORES * errs["top"]
          and worst <= tol and per_step == [eng.cfg.num_layers] * len(
              per_step))
    print(f"  decode_scored, {SCORED_STEPS} steps at B={len(prompts)}: "
          f"{per_step[0]} B1 score launches a step; logits against "
          f"decode_forced on a twin state max|d| {worst:.4f} (limit "
          f"{tol:.4f}); {errs['calls']} layers' scores against the plain "
          f"version on the same inputs: max|d| {errs['max']:.3e} (tol "
          f"{TOL_B1_SCORES:g} of {errs['top']:.3f}), dead pages "
          f"{'identical' if errs['dead_ok'] else 'DIFFERENT'} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    check(ok, "(m) decode_scored failed its checks")
    row = results[kname].setdefault("scores", {})
    row.update(launches=sum(per_step), launches_per_step=per_step[0],
               path_max_abs_err=errs["max"])
    lap("decode_scored")
    info = {"beam_tok_s": tps, "beam_wall_ms": wall * 1e3,
            "per_step_wall_ms": step_wall * 1e3, "bursts": watch.bursts,
            "burst_vs_step_max_dscore": dscore,
            "vs_replay_max_dcum": d_kern, "plain_vs_replay_max_dcum": d_plain,
            "sentinel_vs_replay_max_dcum": d_bad,
            "vs_plain_max_dlogprob": d_ok,
            "kernels_minus_plain_on_kernel_hyps": sel_k,
            "kernels_minus_plain_on_plain_hyps": sel_p,
            "sum_vs_plain_max_d": d_sum, "plain_sum_vs_plain_max_d": d_sum_p,
            "rerank_ms": rerank_ms,
            "scorer_batch_rel_diff": rel,
            "decode_scored_vs_forced_max_dlogit": worst,
            "decode_scored_score_err": errs["max"],
            "engine_gb": after / 1e9, "engine_gb_before": before / 1e9,
            "seconds": time.perf_counter() - t0}
    info.update({f"burst_{k}": v for k, v in prof.items()})
    del eng
    torch.cuda.empty_cache()
    return info


# -- path (l): the continuous-batching scheduler ------------------------------

#: path (l)'s traffic on (b)'s engine: the prompts' lengths in submit
#: order (the last two share their first page with the 64-token one), the
#: tick before which each wave is submitted, the page count the pool is
#: shrunk to before the run (so that the first wave's growth must preempt
#: the youngest request by swap; grown back to (b)'s once it has), and the
#: seeded pass's seed
SCHED_LENS = (40, 64, 100, 192, 256, 300, 128, 128)
SCHED_WAVES = {0: (0, 1, 2), 2: (3, 4, 5), 5: (6, 7)}
SCHED_SHRINK = 7
SCHED_SEED = 20261018


def scheduler_traffic(vocab):
    """Path (l)'s prompts and ``max_new_tokens`` (32-48), made from
    ``SEED`` with numpy."""
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, vocab, n).tolist() for n in SCHED_LENS]
    for i in (6, 7):
        prompts[i][:64] = prompts[1]
    return prompts, rng.integers(32, 49, len(SCHED_LENS)).tolist()


#: the allocator calls the scheduler makes (timed and recorded by
#: :class:`SchedulerWatch`; ``num_free`` is a read)
ALLOC_CALLS = ("alloc_many", "free", "lookup_freed", "resize",
               "drop_cached")


class SchedulerWatch:
    """Inside (a context manager over an engine and its scheduler): every
    ``model.forward`` call's token count is recorded (the launch counts
    are computed from them), and the logits that chose each generated
    token are collected per request (``logits[req_id][index]``, f32 on the
    host) by shadowing the engine's device steps on the instance: the
    decode burst (its rows are lanes, told apart by their requests'
    seeds; the burst runs inside ``torch.cuda.set_sync_debug_mode
    ("error")``, so a synchronizing call between its first forward and its
    one fetch raises), the fused tick's chunk-and-draw and the spec burst;
    and the plain finish's draw (the scheduler module's ``sample``). Swap
    outs and ins, prefill starts and prefix-cache hits are counted, and
    every allocator call is recorded with its result and timed on the
    host (``alloc_calls``, ``alloc_s``). Each wrapper reads its inputs on
    the host before the call, outside the burst's window."""

    def __init__(self, torch, eng, sched, capture=True):
        self.torch, self.eng, self.sched = torch, eng, sched
        self.capture = capture
        self.forwards = []            # T of each forward
        self.logits = collections.defaultdict(dict)
        self.events = []              # (kind, req_id)
        self.hits = 0
        self.bursts = []              # (seq_lens, block tables, steps)
        self.spec_advance = []        # (max advance of a lane, iterations)
        self.alloc_calls = []         # (method, args, kwargs, result)
        self.alloc_s = 0.0
        self._sink = None

    def _by_seed(self):
        return {r.seed: r for r in [l.request for l in self.sched.lanes]
                if r is not None}

    def __enter__(self):
        torch, eng, sched = self.torch, self.eng, self.sched
        from importlib import import_module

        samp = import_module(f"{PKG}.engine.sampling")
        self.sched_mod = import_module(f"{PKG}.scheduler.scheduler")
        real = {k: getattr(eng, k) for k in (
            "_decode_loop_fn", "_prefill_sample_fn", "_decode_spec_loop_fn")}
        real_sample = self.real_sample = self.sched_mod.sample
        forward = eng.model.forward

        def counted_forward(params, tokens, positions, kv, attn):
            logits, kv = forward(params, tokens, positions, kv, attn)
            self.forwards.append(int(tokens.shape[1]))
            if self._sink is not None:
                self._sink(logits)
            return logits, kv

        eng.model.forward = counted_forward

        def decode_loop(params, tokens, kv, bt, seq_lens, emitted, budgets,
                        seeds, samp_, counts, *, num_steps, mode):
            host = [t.cpu().numpy() for t in (seq_lens, emitted, budgets,
                                               seeds, bt)]
            rows = []
            self._sink = ((lambda lg: rows.append(lg[:, 0].float()))
                          if self.capture else None)
            mode_before = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = real["_decode_loop_fn"](
                    params, tokens, kv, bt, seq_lens, emitted, budgets,
                    seeds, samp_, counts, num_steps=num_steps, mode=mode)
            finally:
                torch.cuda.set_sync_debug_mode(mode_before)
                self._sink = None
            sl, em, bud, sd, bt_h = host
            self.bursts.append((sl, bt_h, num_steps, bud))
            by_seed = self._by_seed()
            for j, lg in enumerate(rows):
                lg = lg.cpu().numpy()
                for b in range(len(sd)):
                    req = by_seed.get(int(sd[b]))
                    if bud[b] > 0 and req is not None and em[b] + j < bud[b]:
                        self.logits[req.req_id][int(em[b]) + j] = lg[b]
            return out

        def prefill_sample(params, tokens, positions, kv, bt, sl, qo, pl,
                           smask, seeds, samp_, counts, *, mode):
            idx = (pl - 1 - qo).cpu().numpy()
            sd, sm = seeds.cpu().numpy(), smask.cpu().numpy()
            rows = []
            T = tokens.shape[1]
            if self.capture:
                pick = torch.as_tensor(np.clip(idx, 0, T - 1),
                                       device=tokens.device)
                self._sink = lambda lg: rows.append(
                    lg[torch.arange(lg.shape[0], device=lg.device),
                       pick].float().cpu().numpy())
            try:
                out = real["_prefill_sample_fn"](
                    params, tokens, positions, kv, bt, sl, qo, pl, smask,
                    seeds, samp_, counts, mode=mode)
            finally:
                self._sink = None
            by_seed = self._by_seed()
            for i in range(len(sd)):
                req = by_seed.get(int(sd[i]))
                if rows and sm[i] and 0 <= idx[i] < T and req is not None:
                    self.logits[req.req_id][0] = rows[0][i]
            return out

        def sample_fn(logits, gen, *, row_keys=None, **kw):
            if row_keys is not None and self.capture:
                keys = row_keys.cpu().numpy()
                by_key = {int(samp.request_key(r.seed, 0)): r
                          for r in self._by_seed().values()}
                lg = logits.float().cpu().numpy()
                for i, k in enumerate(keys):
                    if int(k) in by_key:
                        self.logits[by_key[int(k)].req_id][0] = lg[i]
            return real_sample(logits, gen, row_keys=row_keys, **kw)

        def spec_loop(params, hist, kv, bt, cur, *args, num_iters, **kw):
            cur0 = cur.cpu().numpy()
            out = real["_decode_spec_loop_fn"](params, hist, kv, bt, cur,
                                               *args, num_iters=num_iters,
                                               **kw)
            adv = out[1].cpu().numpy() - cur0
            self.spec_advance.append((int(adv.max()), num_iters))
            return out

        eng._decode_loop_fn = decode_loop
        eng._prefill_sample_fn = prefill_sample
        eng._decode_spec_loop_fn = spec_loop
        self.sched_mod.sample = sample_fn

        for name in ("_swap_out", "_swap_in", "_start_prefill"):
            def wrapped(lane, *rest, fn=getattr(sched, name), name=name):
                req = rest[0] if rest else lane.request
                self.events.append((name.strip("_"), req.req_id))
                return fn(lane, *rest)

            setattr(sched, name, wrapped)
        alloc = eng.allocator
        for name in ALLOC_CALLS:
            def timed(*a, fn=getattr(alloc, name), name=name, **k):
                t = time.perf_counter()
                out = fn(*a, **k)
                self.alloc_s += time.perf_counter() - t
                self.alloc_calls.append((name, a, k, out))
                if name == "lookup_freed":
                    self.hits += out is not None
                return out

            setattr(alloc, name, timed)
        return self

    def __exit__(self, *exc):
        eng = self.eng
        del eng.model.forward
        for k in ("_decode_loop_fn", "_prefill_sample_fn",
                  "_decode_spec_loop_fn"):
            delattr(eng, k)                   # the engine's methods again
        self.sched_mod.sample = self.real_sample
        for name in ALLOC_CALLS:
            delattr(eng.allocator, name)
        for name in ("_swap_out", "_swap_in", "_start_prefill"):
            delattr(self.sched, name)
        return False


def allocator_replay(calls, num_pages, reps=200):
    """Host milliseconds of one replay of a run's allocator ``calls``
    (:class:`SchedulerWatch`'s ``alloc_calls``) on a fresh allocator of
    each kind, ``{"python": ms, "native": ms}`` (the median of ``reps``).
    A first replay maps the run's page ids to the fresh allocator's (the
    same calls and the same results, in that allocator's ids); the timed
    ones then make the mapped calls alone."""
    from importlib import import_module

    native = import_module(f"{PKG}.kvcache.native")
    out = {}
    for kind, opt in (("python", "never"), ("native", "always")):
        alloc = native.make_allocator(num_pages, native=opt)
        ids, plan = {0: 0}, []
        for name, a, k, res in calls:
            if name == "free":
                a = (ids[a[0]],) + a[1:]
            got = getattr(alloc, name)(*a, **k)
            if name == "alloc_many":
                ids.update(zip(res, got))
            elif name == "lookup_freed" and res is not None:
                check(got is not None, f"{kind} allocator: a replayed "
                      "prefix lookup missed")
                ids[res] = got
            plan.append((name, a, k))
        times = []
        for _ in range(reps):
            alloc = native.make_allocator(num_pages, native=opt)
            bound = [(getattr(alloc, name), a, k) for name, a, k in plan]
            t = time.perf_counter()
            for fn, a, k in bound:
                fn(*a, **k)
            times.append(time.perf_counter() - t)
        out[kind] = float(np.median(times)) * 1e3
    return out


def forward_launches(quant, n_layers, page, forwards,
                     attention="paged_attention_wgmma"):
    """Exact launch counts of the forwards a run made (their token counts
    ``forwards``): a T=1 forward runs B3 and B2 in each layer, a chunk B1
    and the append ``kv_append`` routes it to (B4 where ``T % page ==
    0``, else B5); the matmuls as :func:`matmul_launches` counts them;
    every other kernel 0."""
    from importlib import import_module

    plat = import_module(f"{PKG}.utils.platform")
    out = dict.fromkeys(plat.KERNELS, 0)
    steps = sum(t == 1 for t in forwards)
    pages = sum(t > 1 and t % page == 0 for t in forwards)
    tokens = sum(t > 1 and t % page != 0 for t in forwards)
    out.update({"kv_append_decode": n_layers * steps,
                "paged_attention_decode": n_layers * steps,
                attention: n_layers * (pages + tokens),
                "kv_append_prefill": n_layers * pages,
                "kv_append_tokens": n_layers * tokens})
    out.update(matmul_launches(quant, n_layers, len(forwards)))
    return out


def reference_streams(torch, eng, prompts, news, greedy, batch=1):
    """Each prompt through the same engine with the logits that chose
    each token (the final prompt position of the last chunk, then each
    decode step's): alone by ``generate``, or with ``batch`` > 1 as one
    row of ``generate_batch_fused`` over ``batch`` prompts at a time, in
    order (every forward then has the scheduler's lane count of rows; a
    row's work depends on the others' only through the shapes).
    ``[(tokens, logits [n, V])]``."""
    out = []
    for g in range(0, len(prompts), batch):
        group, ns = prompts[g:g + batch], news[g:g + batch]
        rows = [[] for _ in group]
        with forward_calls(eng) as calls:
            if batch == 1:
                toks = [eng.generate(group[0], ns[0], greedy)]
            else:
                group = group + group[-1:] * (batch - len(group))
                toks = eng.generate_batch_fused(group, max(ns), greedy)
        for pos, lg in calls:
            for i, prompt in enumerate(group[:len(ns)]):
                if pos.shape[1] > 1:
                    at = np.nonzero(pos[i] == len(prompt) - 1)[0]
                    if at.size:
                        rows[i] = [lg[i, at[0]].cpu().numpy()]
                else:
                    rows[i].append(lg[i, 0].cpu().numpy())
        out += [(t[:n], np.stack(r[:n])) for t, r, n in zip(toks, rows, ns)]
    return out


def stream_faults(reqs, logits, alone, batched, tol):
    """Path (l)'s stream checks as a list of faults (empty: passed), and
    what they compared. Against ``batched`` (each prompt in a batch of the
    lanes' size, :func:`reference_streams`; ``None`` skips this check)
    every token and every logit
    must be equal bit for bit: a decode step's rows go through the same
    shapes, so only a fault of the scheduler (a wrong page, a stale row, a
    bad swap) can move them. Against ``alone`` (``generate``) the same
    holds up to each request's first fork, and at the fork the step's
    max|dlogit| must be within ``tol`` (path (b)'s logit limit) and the
    reference's top-1 margin at most twice it (the fork rule): a batch of
    one reduces some rows' norms in another order (PERF.md §6)."""
    faults, compared, forks = [], 0, []
    for r, (tr, lr), (tb, lb) in zip(reqs, alone,
                                     batched or [(None, None)] * len(reqs)):
        got = logits[r.req_id]
        if sorted(got) != list(range(len(r.tokens))):
            faults.append(f"request {r.req_id} vs both: logits for "
                          f"{sorted(got)}")
            continue
        lk = np.stack([got[e] for e in range(len(r.tokens))])
        same = [tb is None or (r.tokens[e] == tb[e]
                               and np.array_equal(lk[e], lb[e]))
                for e in range(len(r.tokens))]
        if tb is not None and (len(tb) != len(r.tokens) or not all(same)):
            e = same.index(False) if not all(same) else len(same)
            d = float(np.abs(lk[e] - lb[e]).max()) if e < len(lb) else 0.0
            faults.append(f"request {r.req_id} vs batch: token {e} differs "
                          f"(max|dlogit| {d:.4g})")
        for e in range(min(len(r.tokens), len(tr))):
            d = float(np.abs(lk[e] - lr[e]).max())
            if r.tokens[e] != tr[e]:
                top2 = np.sort(lr[e])[-2:]
                margin = float(top2[1] - top2[0])
                forks.append((r.req_id, e, margin, d))
                if margin > 2 * d or d > tol:
                    faults.append(
                        f"request {r.req_id} vs alone: forks at token {e} "
                        f"(margin {margin:.4g}, max|dlogit| {d:.4g}, limit "
                        f"{tol:.4g})")
                break
            if d != 0:
                faults.append(f"request {r.req_id} vs alone: token {e}'s "
                              f"logits differ by {d:.4g} before any fork")
                break
            compared += 1
        else:
            if len(tr) != len(r.tokens):
                faults.append(f"request {r.req_id} vs alone: {len(r.tokens)}"
                              f" tokens, alone {len(tr)}")
    return faults, compared, forks


def run_scheduler(torch, eng, submit, watch=True, grow_at=None):
    """A scheduler on ``eng`` driven tick by tick: ``submit(sched, tick)``
    submits what arrives before that tick; with ``grow_at`` the pool is
    grown back to that many pages after the first tick that preempted.
    Returns the scheduler, its watch, the requests, the ticks and the
    wall seconds."""
    from importlib import import_module

    sch = import_module(f"{PKG}.scheduler")
    sched = sch.Scheduler(eng)
    reqs, tick, grown = [], 0, False
    with SchedulerWatch(torch, eng, sched, capture=watch) as w:
        if grow_at is not None:
            sched.resize(SCHED_SHRINK)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while True:
            reqs += submit(sched, tick)
            busy = sched.step()
            tick += 1
            if grow_at is not None and sched.n_preempted and not grown:
                sched.resize(grow_at)
                grown = True
            if (busy == 0 and sched.waiting.empty()
                    and tick > max(SCHED_WAVES)):
                break
            check(tick < 400, "the scheduler did not drain")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return sched, w, reqs, tick, wall


def scheduler_path(torch, F_, eng, greedy, spec_prompts, card, tol):
    """Path (l): the JAX package's continuous-batching scheduler, ported,
    on (b)'s w8a8 Llama-3-8B engine (full width and depth, INT8 KV, page
    64, chunk 256, four lanes, bursts of 8 to 32 steps): eight requests in
    three waves, the pool shrunk so the first wave's growth swaps the
    youngest request out, then grown back; checks (the streams by
    :func:`stream_faults` with (b)'s logit limit ``tol``, and a sentinel
    run that must fail them), numbers and B2 at a burst's ragged lengths
    (see the module docstring)."""
    from importlib import import_module

    plat = import_module(f"{PKG}.utils.platform")
    pa = import_module(f"{PKG}.ops.paged_attention")
    sch = import_module(f"{PKG}.scheduler")
    eng_mod = import_module(f"{PKG}.engine")
    sampling = import_module(f"{PKG}.engine.sampling")
    cfg = eng.config
    L, page = eng.cfg.num_layers, eng.cache.page_size
    prompts, news = scheduler_traffic(eng.cfg.vocab_size)
    t0 = time.perf_counter()

    def lap(what):
        print(f"  ({what}: {time.perf_counter() - t0:.1f} s into (l))",
              flush=True)

    live0 = eng.allocator.num_live
    full = eng.cache.num_pages
    # the bursts' sync check can fail: a read to the host inside the mode
    # raises
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.zeros(1, device=eng.device).item()
        raised = False
    except RuntimeError:
        raised = True
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(raised, "set_sync_debug_mode('error') let .item() through")
    print(f"  allocator: {type(eng.allocator).__name__}; pool {full} pages, "
          f"shrunk to {SCHED_SHRINK} for the first wave; prompts "
          f"{list(SCHED_LENS)}, max_new_tokens {news}", flush=True)

    def submit(sched, tick):
        return [sched.submit(prompts[i], news[i], greedy)
                for i in SCHED_WAVES.get(tick, ())]

    plat.reset_launch_counts()
    sched, w, reqs, ticks, wall = run_scheduler(torch, eng, submit,
                                                grow_at=full)
    counts = {n: k.launches for n, k in plat.KERNELS.items()}
    failed = [(r.req_id, r.error) for r in reqs
              if r.state != sch.RequestState.FINISHED]
    check(not failed, f"requests not finished: {failed}")
    check(eng.cache.num_pages == full, "the pool was not grown back")
    expect = forward_launches(eng.cfg.quant, L, page, w.forwards,
                              b1_kernel(eng))
    print(f"  launches in the scheduler run: {json.dumps(counts)}",
          flush=True)
    check(counts == expect,
          f"scheduler: launches {counts}, expected exactly {expect}")
    steps = sum(t == 1 for t in w.forwards)
    chunks = len(w.forwards) - steps
    tokens = sum(len(r.tokens) for r in reqs)
    ttft = sorted(r.ttft_s for r in reqs)
    swapped = {rid for kind, rid in w.events if kind == "swap_out"}
    swapped_in = {rid: i for i, (kind, rid) in enumerate(w.events)
                  if kind == "swap_in"}
    resumed_prefill = [rid for rid in swapped if rid in swapped_in and (
        "start_prefill", rid) in w.events[swapped_in[rid]:]]
    print(f"  scheduler run: wall {wall:.3f} s, {tokens} tokens, "
          f"{tokens / wall:.2f} tok/s, TTFT p50 {np.median(ttft):.3f} s, max "
          f"{ttft[-1]:.3f} s; {ticks} ticks, {len(w.bursts)} bursts "
          f"({steps} decode steps), {chunks} chunk forwards, "
          f"{sched.n_preempted} preemptions (swapped out: "
          f"{sorted(swapped)}), {w.hits} prefix-cache hits; events "
          f"{w.events} ({card})", flush=True)
    check(sched.n_preempted >= 1 and swapped, "no request was swapped out")
    check(swapped <= set(swapped_in), "a swapped request was not swapped in")
    check(not resumed_prefill,
          f"requests {resumed_prefill} were prefilled after their swap-in")
    check(w.hits >= 1, "no prefix-cache hit")
    check(eng.allocator.num_live == live0,
          f"allocator holds {eng.allocator.num_live} pages, had {live0}")
    alloc_ms = allocator_replay(w.alloc_calls, full)
    print(f"  allocator host time in the run: {w.alloc_s * 1e3:.3f} ms over "
          f"{len(w.alloc_calls)} calls ({w.alloc_s * 1e3 / ticks:.4f} ms a "
          f"tick, {w.alloc_s / wall:.2e} of the wall); the same calls "
          f"replayed on fresh allocators: Python {alloc_ms['python']:.4f} "
          f"ms, native {alloc_ms['native']:.4f} ms ({card})", flush=True)
    lap("the scheduler run and its checks")
    refs = reference_streams(torch, eng, prompts, news, greedy)
    batch_refs = reference_streams(torch, eng, prompts, news, greedy,
                                   batch=cfg.runtime.max_batch_size)
    lap("the references")
    faults, compared, forks = stream_faults(reqs, w.logits, refs, batch_refs,
                                            tol)
    in_batch = not any(" vs batch" in f for f in faults)
    print(f"  streams: {len(reqs)} requests equal their batch references "
          f"token for token and logit for logit: {in_batch}; against "
          f"generate alone {compared} tokens bit-identical before "
          f"the forks, forks (request, token, reference margin, "
          f"max|dlogit|) {json.dumps([(q, e, round(m, 5), round(d, 5)) for q, e, m, d in forks])}"
          f" (each margin <= 2x its max|dlogit|, each max|dlogit| <= "
          f"{tol:.4g}); faults {faults}", flush=True)
    check(not faults, f"scheduler streams: {faults}")
    info = {"wall_s": wall, "tokens": tokens, "tok_s": tokens / wall,
            "ttft_p50_s": float(np.median(ttft)), "ttft_max_s": ttft[-1],
            "ticks": ticks, "bursts": len(w.bursts), "decode_steps": steps,
            "chunk_forwards": chunks, "preemptions": sched.n_preempted,
            "prefix_hits": w.hits, "allocator": type(eng.allocator).__name__,
            "allocator_calls": len(w.alloc_calls),
            "allocator_ms": w.alloc_s * 1e3,
            "allocator_replay_python_ms": alloc_ms["python"],
            "allocator_replay_native_ms": alloc_ms["native"],
            "pairs_before_fork": compared, "forks": len(forks),
            "launches": counts}

    # the sentinel: the first wave again (its youngest request is the one
    # swapped) with each swap-in writing the request's pages one page
    # below the ones it was given: it must fail the checks
    sched_mod = import_module(f"{PKG}.scheduler.scheduler")
    scatter = sched_mod.scatter_pages
    sched_mod.scatter_pages = lambda kv, blobs, pages: scatter(
        kv, blobs, [p - 1 for p in pages])
    try:
        _, ws, bad_reqs, _, _ = run_scheduler(
            torch, eng, lambda sched, tick: submit(sched, tick) if tick == 0
            else [], grow_at=full)
    finally:
        sched_mod.scatter_pages = scatter
    bad, _, _ = stream_faults(bad_reqs, ws.logits, refs, batch_refs, tol)
    print(f"  sentinel (each swap-in one page below its pages): faults "
          f"{bad}", flush=True)
    for rid in sorted(swapped):
        for kind in ("batch", "alone"):
            check(any(f.startswith(f"request {rid} vs {kind}:") for f in bad),
                  f"the sentinel's request {rid} passed the check against "
                  f"its {kind} reference")
    check(eng.allocator.num_live == live0, "the sentinel kept pages")
    info["sentinel_faults"] = len(bad)
    lap("the sentinel")

    # B2 at one burst's ragged lengths (the first with the most live
    # lanes), beside B7 and SDPA on the same inputs
    sl, bt, _, _ = max(w.bursts, key=lambda b: int((b[3] > 0).sum()))
    dev = eng.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    kv = sched.kv
    q = torch.randn((len(sl), 1, eng.cfg.num_heads, kv[0].shape[-1]),
                    generator=gen, device=dev).to(torch.bfloat16)
    bt_d = torch.as_tensor(bt, device=dev)
    sl_d = torch.as_tensor(sl + 1, device=dev)
    common = dict(page_size=page, num_q_heads=eng.cfg.num_heads)
    args = (q, kv[0], bt_d, sl_d, kv[1], 0)
    b2 = pa.paged_attention_decode(*args, **common)
    b7 = pa.paged_attention_decode_batched(*args, **common)
    err7 = (b7.float() - b2.float()).abs().max().item()
    b2_ms = device_ms(lambda: pa.paged_attention_decode(*args, **common),
                      match=KERNEL_NAMES["paged_attention_decode"])
    b7_ms = device_ms(lambda: pa.paged_attention_decode_batched(
        *args, **common), match=KERNEL_NAMES["paged_attention_decode_batched"])
    sdpa_ms = device_ms(sdpa_decode_call(torch, F_, q, kv, bt_d, sl_d, 0, 0),
                        iters=5)
    b_ms, b_by = decode_bound(torch, q, kv, bt_d, (sl + 1).tolist(), 0)
    print(f"  B2 at a burst's ragged lengths {(sl + 1).tolist()} (keys a "
          f"lane; layer 0 of the scheduler's pool): {b2_ms:.4f} ms, B7 "
          f"{b7_ms:.4f} ms (max|B7-B2| {err7:.3e}), SDPA {sdpa_ms:.4f} ms, "
          f"bound {b_ms:.5f} ms ({b_by}) ({card})", flush=True)
    check(err7 <= 2e-2, "B7 differs from B2 at the burst's lengths")
    info.update(b2_ragged_lens=(sl + 1).tolist(), b2_ragged_ms=b2_ms,
                b7_ragged_ms=b7_ms, sdpa_ragged_ms=sdpa_ms,
                ragged_bound_ms=b_ms)
    # one burst profiled at those inputs (pages past a lane's content are
    # free now: the writes land on them or on the dump page)
    zeros = torch.zeros(len(sl), dtype=torch.int32, device=dev)
    budgets = torch.full((len(sl),), 1 << 20, dtype=torch.int32, device=dev)
    samp = sampling.arrays_to(sampling.batch_arrays_np([greedy] * len(sl)),
                              dev)
    info.update(profile_run(torch, "scheduler burst", lambda n: (
        eng._decode_loop_fn(eng.params, zeros, kv, bt_d,
                            torch.as_tensor(sl, device=dev), zeros, budgets,
                            zeros, samp, sched._dummy_counts, num_steps=n,
                            mode=greedy.mode())), steps=4))
    del sched, kv, q, b2, b7
    torch.cuda.empty_cache()
    lap("B2 at the ragged lengths, the burst profile")

    # the spec burst on token-repeating weights against the plain burst
    with token_repeating(eng):
        # 48 tokens a request: more than one burst (32 steps) of the
        # plain burst, so a spec lane that accepts drafts finishes in fewer
        def spec_submit(sched, tick):
            return ([sched.submit(p, 48, greedy) for p in spec_prompts]
                    if tick == 0 else [])

        _, _, plain_reqs, _, _ = run_scheduler(torch, eng, spec_submit,
                                               watch=False)
        saved = cfg.runtime.spec_k
        cfg.runtime.spec_k = SPEC_K
        try:
            plat.reset_launch_counts()
            _, ws, spec_reqs, _, spec_wall = run_scheduler(
                torch, eng, spec_submit, watch=False)
            spec_counts = {n: k.launches for n, k in plat.KERNELS.items()}
        finally:
            cfg.runtime.spec_k = saved
    expect = forward_launches(eng.cfg.quant, L, page, ws.forwards,
                              b1_kernel(eng))
    check(spec_counts == expect, f"scheduler spec: launches {spec_counts}, "
          f"expected exactly {expect}")
    same = [a.tokens == b.tokens for a, b in zip(spec_reqs, plain_reqs)]
    accepted = any(adv > it for adv, it in ws.spec_advance)
    verifies = sum(t == SPEC_K + 1 for t in ws.forwards)
    print(f"  spec burst (spec_k={SPEC_K}, token-repeating weights): "
          f"streams equal to the plain burst's: {same}; {verifies} verify "
          f"forwards for {sum(len(r.tokens) for r in spec_reqs)} tokens "
          f"(lane advance a burst, iterations: {ws.spec_advance}); wall "
          f"{spec_wall:.3f} s; launches {json.dumps(spec_counts)}",
          flush=True)
    check(all(same), "the spec burst's streams differ from the plain burst's")
    check(accepted, "the spec burst accepted no draft")
    info.update(spec_verify_forwards=verifies, spec_wall_s=spec_wall,
                spec_launches=spec_counts)
    lap("the spec pass")

    # a seeded sampled request alone, then beside three joining mid-decode
    sampled = eng_mod.SamplingParams(temperature=0.8, eos_token_id=-1)
    runs = []
    for others in (False, True):
        def seeded_submit(sched, tick, others=others):
            if tick == 0:
                return [sched.submit(prompts[0], 48, sampled,
                                     seed=SCHED_SEED)]
            if tick == 1 and others:
                return [sched.submit(prompts[i], 40, sampled, seed=i)
                        for i in (1, 2, 6)]
            return []

        _, _, rs, _, _ = run_scheduler(torch, eng, seeded_submit,
                                       watch=False)
        runs.append(rs)
    same_seeded = runs[0][0].tokens == runs[1][0].tokens
    print(f"  seeded request (T=0.8, seed {SCHED_SEED}) alone and beside "
          f"three joining mid-decode: {'identical' if same_seeded else 'DIFFERENT'}"
          f" ({len(runs[0][0].tokens)} tokens)", flush=True)
    check(same_seeded, "the seeded request's tokens depend on its batch")
    check(eng.allocator.num_live == live0, "the passes kept pages")
    info["seeded_identical"] = same_seeded
    lap("the seeded pass")
    return info


# -- path (n): the frontends --------------------------------------------------

#: path (n)'s traffic on (b)'s engine: the lone greedy request's prompt
#: bytes and new tokens, the concurrent streams' prompt bytes ((l)'s first
#: four lengths), and the beam request's width and new tokens
SERVER_LONE, SERVER_NEW = 64, 32
SERVER_LENS = SCHED_LENS[:4]
SERVER_BEAM_W, SERVER_BEAM_NEW = 4, 16
#: the byte tokenizer's EOS, which the server's requests stop on
SERVER_EOS = 257


def server_texts():
    """Path (n)'s prompts: lower-case ASCII text made from ``SEED`` with
    numpy, one byte a token under the byte tokenizer: the lone request's,
    the four streams', and the beam request's chat message."""
    rng = np.random.default_rng(SEED)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", np.uint8)

    def text(n):
        return bytes(rng.choice(letters, n)).decode()

    return (text(SERVER_LONE), [text(n) for n in SERVER_LENS],
            text(SERVER_LONE))


def http_call(port, method, path, body=None, timeout=600):
    """One request to the server on loopback: ``(status, body bytes)``
    (``http.client`` undoes the chunked framing)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path,
                     body=json.dumps(body) if body is not None else None,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def stream_frames(raw, sse):
    """A streaming answer's frames, each parsed (a frame that does not
    parse raises), and whether it ended as its framing must: SSE in
    ``event: done``, both with a last frame that carries
    ``finish_reason``."""
    text = raw.decode()
    if sse:
        done = "event: done\ndata: {}\n\n"
        ended = text.endswith(done)
        body = text[: -len(done)] if ended else text
        parts = [p for p in body.split("\n\n") if p]
        check(all(p.startswith("data: ") for p in parts),
              f"(n) an SSE frame without 'data: ': {parts[:2]}")
        frames = [json.loads(p[len("data: "):]) for p in parts]
    else:
        ended = True
        frames = [json.loads(line) for line in text.splitlines() if line]
    ended = ended and bool(frames) and frames[-1].get("token") is None \
        and "finish_reason" in frames[-1]
    return frames, ended


def server_path(torch, eng, greedy, card, tol):
    """Path (n): the frontends. ``BasicServer(core=ServerCore(cfg,
    engine=eng))`` on loopback over (b)'s w8a8 engine, its scheduler's
    pump and the beam searcher on the card; driven with ``http.client``
    (see the module docstring for the requests and checks)."""
    import gc
    import threading
    from importlib import import_module

    plat = import_module(f"{PKG}.utils.platform")
    srv_mod = import_module(f"{PKG}.server")
    prof = import_module(f"{PKG}.utils.profiling")
    sch = import_module(f"{PKG}.scheduler")
    eng_mod = import_module(f"{PKG}.engine")
    rerank = import_module(f"{PKG}.reranker")
    tok_mod = import_module(f"{PKG}.utils.tokenizer")
    t0 = time.perf_counter()

    def lap(what):
        print(f"  ({what}: {time.perf_counter() - t0:.1f} s into (n))",
              flush=True)

    # (l)'s schedulers and (m)'s searchers and engine are gone by now
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(f"  before the server: {torch.cuda.memory_allocated() / 1e9:.3f} "
          f"GB held on the card; runtime.spec_k "
          f"{eng.config.runtime.spec_k} (no spec burst unless > 0)",
          flush=True)
    L, page = eng.cfg.num_layers, eng.cache.page_size
    tok = tok_mod.get_tokenizer("byte")
    check(tok.eos_token_id == SERVER_EOS, "the byte tokenizer's EOS moved")
    lone, texts, chat = server_texts()
    live0 = eng.allocator.num_live
    cfg = eng.config
    core = srv_mod.ServerCore(cfg, engine=eng)
    srv = srv_mod.BasicServer(core=core, host="127.0.0.1", port=0)
    server_thread = srv.start_background()
    port = srv.port
    submitted = []
    submit = core.scheduler.submit

    def recorded_submit(*a, **k):
        req = submit(*a, **k)
        submitted.append(req)
        return req

    core.scheduler.submit = recorded_submit
    try:
        code, body = http_call(port, "GET", "/healthz")
        check(code == 200 and json.loads(body) == {
            "status": "ok", "model": cfg.model.name},
            f"(n) /healthz answered {code} {body[:200]}")
        gen = {"temperature": 0.0, "max_new_tokens": SERVER_NEW}
        received = 0                  # tokens the clients received

        # 2 and 3 under one watch: the scheduler's forwards (its launch
        # counts follow from them) and the logits that chose each token
        with SchedulerWatch(torch, eng, core.scheduler) as w:
            torch.cuda.synchronize()
            plat.reset_launch_counts()
            lone_out = {}

            def lone_call():
                lone_out["t0"] = time.perf_counter()
                lone_out["ans"] = http_call(port, "POST", "/generate",
                                            dict(gen, prompt=lone))
                lone_out["wall"] = time.perf_counter() - lone_out["t0"]

            busy_s = prof.traced_device_s(lone_call)
            code, body = lone_out["ans"]
            check(code == 200, f"(n) /generate answered {code} {body[:300]}")
            lone_tokens = json.loads(body)["tokens"]
            received += len(lone_tokens)
            share = (busy_s or 0.0) / lone_out["wall"]
            print(f"  lone /generate: {len(lone_tokens)} tokens in "
                  f"{lone_out['wall'] * 1e3:.1f} ms; device busy "
                  f"{(busy_s or 0.0) * 1e3:.2f} ms by "
                  f"utils/profiling.traced_device_s: busy share "
                  f"{share:.4f} ({card})", flush=True)
            check(busy_s is not None and 0 < busy_s <= lone_out["wall"],
                  f"(n) traced_device_s gave {busy_s} for a "
                  f"{lone_out['wall']:.3f} s request")
            lap("health and the lone request")

            answers = {}

            def post(key, path, payload):
                answers[key] = http_call(port, "POST", path, payload)

            calls = [(("stream", i), "/stream_generate"
                      + ("?sse=1" if i == 1 else ""), dict(gen, prompt=t))
                     for i, t in enumerate(texts)]
            calls.append((("batch", 0), "/generate_batch",
                          dict(gen, prompts=texts)))
            threads = [threading.Thread(target=post, args=c) for c in calls]
            t_conc = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            conc_wall = time.perf_counter() - t_conc
            torch.cuda.synchronize()
        counts = {n: k.launches for n, k in plat.KERNELS.items()}
        sched_forwards = list(w.forwards)
        watched = list(submitted)     # the requests whose logits it holds
        got = {}                      # prompt text -> [token lists]
        for i, t in enumerate(texts):
            code, raw = answers[("stream", i)]
            check(code == 200, f"(n) stream {i} answered {code}")
            frames, ended = stream_frames(raw, sse=i == 1)
            check(ended, f"(n) stream {i} ({'SSE' if i == 1 else 'ndjson'})"
                  f" did not end as its framing must: {raw[-200:]!r}")
            toks = [f["token"] for f in frames[:-1]]
            check(all(isinstance(x, int) for x in toks)
                  and frames[-1]["finish_reason"] in ("eos", "length"),
                  f"(n) stream {i}'s frames: {frames[-3:]}")
            got.setdefault(t, []).append(toks)
        code, body = answers[("batch", 0)]
        check(code == 200, f"(n) /generate_batch answered {code}")
        results = json.loads(body)["results"]
        check(len(results) == len(texts) and not any(
            "error" in r for r in results), f"(n) batch results {results}")
        for t, r in zip(texts, results):
            got[t].append(r["tokens"])
        conc_tokens = sum(len(x) for v in got.values() for x in v)
        received += conc_tokens
        lap("the concurrent streams and the batch")

        # 4: beam search and rerank on the handler's thread, alone
        msgs = [{"role": "user", "content": chat}]
        beam_ids = tok.encode(cfg.chat.render(msgs))
        widths = []
        forward = eng.model.forward

        def counted_forward(params, tokens, *rest, **kw):
            out = forward(params, tokens, *rest, **kw)
            widths.append(int(tokens.shape[1]))
            return out

        eng.model.forward = counted_forward
        try:
            torch.cuda.synchronize()
            plat.reset_launch_counts()
            tb = time.perf_counter()
            code, raw = http_call(port, "POST", "/stream_chat_beam", {
                "messages": msgs, "beam_width": SERVER_BEAM_W,
                "max_new_tokens": SERVER_BEAM_NEW, "use_rerank": True})
            beam_wall = time.perf_counter() - tb
            torch.cuda.synchronize()
            beam_counts = {n: k.launches for n, k in plat.KERNELS.items()}
        finally:
            del eng.model.forward
        check(code == 200, f"(n) /stream_chat_beam answered {code} "
              f"{raw[:300]}")
        frames, ended = stream_frames(raw, sse=False)
        check(ended and frames[-1]["finish_reason"] == "stop",
              f"(n) the beam stream's last frame {frames[-1:]}")
        winner = [f["token"] for f in frames[:-1]]
        beam_idx = {f["beam"] for f in frames[:-1]}
        received += len(winner)
        lap("the beam request")

        # 4b: the beam request again, beside the four streams: the
        # handler's thread and the pump launch on one stream at once
        # (the split counters and workspaces are shared); every answer
        # must equal its earlier one
        answers.clear()
        calls = [(("beam", 0), "/stream_chat_beam", {
            "messages": msgs, "beam_width": SERVER_BEAM_W,
            "max_new_tokens": SERVER_BEAM_NEW, "use_rerank": True})]
        calls += [(("stream", i), "/stream_generate", dict(gen, prompt=t))
                  for i, t in enumerate(texts)]
        threads = [threading.Thread(target=post, args=c) for c in calls]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        code, raw = answers[("beam", 0)]
        again, _ = stream_frames(raw, sse=False)
        same_beam = code == 200 and again == frames
        received += len(again) - 1
        same_streams = []
        for i, t in enumerate(texts):
            code, raw = answers[("stream", i)]
            toks = [f["token"] for f in stream_frames(raw, sse=False)[0][:-1]]
            same_streams.append(code == 200 and toks == got[t][0])
            received += len(toks)
        print(f"  the beam request beside the four streams: beam "
              f"{'identical' if same_beam else 'DIFFERENT'}, streams "
              f"identical to their first answers: {same_streams}",
              flush=True)
        check(same_beam and all(same_streams), "(n) a request beside the "
              "beam search answered otherwise than before")
        lap("the beam beside the streams")

        # 5: errors
        bad_code, bad = http_call(port, "POST", "/generate",
                                  {"prompt": lone, "max_new_tokens": 0})
        miss_code, _ = http_call(port, "GET", "/nope")
        miss_post, _ = http_call(port, "POST", "/nope", {})
        print(f"  max_new_tokens 0: {bad_code} ({bad[:100]!r}); unknown "
              f"paths: GET {miss_code}, POST {miss_post}", flush=True)
        check(bad_code == 422 and miss_code == 404 and miss_post == 404,
              "(n) the error answers are not 422 / 404")

        # 6: metrics
        code, body = http_call(port, "GET", "/metrics")
        check(code == 200, f"(n) /metrics answered {code}")
        metrics = json.loads(body)
    finally:
        del core.scheduler.submit
        srv.shutdown()
    server_thread.join(timeout=30)
    check(not server_thread.is_alive() and core.scheduler._thread is None,
          "(n) the server or its pump thread did not stop")
    # lone, streams, batch, beam, then the beam and the streams again
    n_requests = 1 + len(texts) + 1 + 1 + 1 + len(texts)
    print(f"  /metrics: {json.dumps(metrics)}", flush=True)
    check(metrics["requests_total"] == n_requests
          and metrics["tokens_out"] == received
          and metrics["requests_failed"] == 0
          and metrics["kv_pages"]["live"] == live0,
          f"(n) metrics {metrics}: expected {n_requests} requests, "
          f"{received} tokens out, none failed, {live0} live pages")
    check(eng.allocator.num_live == live0, "(n) the server kept pages")

    # the launches of 2 and 3: exactly what the scheduler's forwards imply
    expect = forward_launches(eng.cfg.quant, L, page, sched_forwards,
                              b1_kernel(eng))
    spec_ran = any(t > 1 and t % page for t in sched_forwards)
    print(f"  launches in the lone request and the concurrent ones: "
          f"{json.dumps(counts)} ({sum(t == 1 for t in sched_forwards)} "
          f"decode steps, {sum(t > 1 for t in sched_forwards)} chunk "
          f"forwards; spec ran: {spec_ran})", flush=True)
    check(counts == expect,
          f"(n) scheduler: launches {counts}, expected exactly {expect}")
    beam_expect = forward_launches(eng.cfg.quant, L, page, widths,
                                   b1_kernel(eng))
    print(f"  launches in the beam request: {json.dumps(beam_counts)} "
          f"(forwards' widths {widths}: the prompt's chunk, "
          f"{sum(t == 1 for t in widths)} beam steps, the rerank's "
          f"chunks)", flush=True)
    check(beam_counts == beam_expect,
          f"(n) beam: launches {beam_counts}, expected exactly "
          f"{beam_expect}")
    check(sum(t == 1 for t in widths) >= SERVER_BEAM_NEW - 1,
          f"(n) the beam request ran {widths}")

    # the references, with the server stopped: the lone request's ids
    # submitted alone to a Scheduler on the same engine with the same
    # SamplingParams; each concurrent request against generate alone
    sp = core._sampling(srv_mod.schema.GenerateRequest(prompt=lone, **gen))
    lone_ids = tok.encode(lone)
    _, _, (ref_req,), _, _ = run_scheduler(
        torch, eng, lambda s, tick: [s.submit(lone_ids, SERVER_NEW, sp)]
        if tick == 0 else [], watch=False)
    print(f"  lone request: {len(lone_tokens)} tokens; alone on a "
          f"Scheduler: {'identical' if lone_tokens == ref_req.tokens else 'DIFFERENT'}",
          flush=True)
    check(ref_req.state == sch.RequestState.FINISHED
          and lone_tokens == ref_req.tokens,
          f"(n) the lone request {lone_tokens} != alone {ref_req.tokens}")
    by_prompt = {tuple(tok.encode(t)): t for t in texts}
    reqs = [r for r in watched if tuple(r.prompt) in by_prompt]
    check(len(reqs) == 2 * len(texts), f"(n) {len(reqs)} concurrent "
          "requests reached the scheduler")
    for t in texts:
        mine = sorted(r.tokens for r in reqs
                      if by_prompt[tuple(r.prompt)] == t)
        check(mine == sorted(got[t]), f"(n) the clients received other "
              f"tokens than the scheduler made for a {len(t)}-byte prompt")
    uniq = [tok.encode(t) for t in texts]
    alone_of = dict(zip(map(tuple, uniq), reference_streams(
        torch, eng, uniq, [SERVER_NEW] * len(uniq), sp)))
    alone = [alone_of[tuple(r.prompt)] for r in reqs]
    faults, compared, forks = stream_faults(reqs, w.logits, alone, None, tol)
    print(f"  concurrent streams: {len(reqs)} requests against generate "
          f"alone: {compared} tokens bit-identical before the forks, forks "
          f"(request, token, reference margin, max|dlogit|) "
          f"{json.dumps([(q, e, round(m, 5), round(d, 5)) for q, e, m, d in forks])}"
          f" (each margin <= 2x its max|dlogit|, each max|dlogit| <= "
          f"{tol:.4g}); faults {faults}", flush=True)
    check(not faults, f"(n) streams: {faults}")
    # 9: the sentinel: the same check with two requests' references
    # swapped must fail
    swapped = list(alone)
    i, j = 0, next(k for k, r in enumerate(reqs)
                   if r.prompt != reqs[0].prompt)
    swapped[i], swapped[j] = swapped[j], swapped[i]
    bad_faults, _, _ = stream_faults(reqs, w.logits, swapped, None, tol)
    print(f"  sentinel (requests {reqs[i].req_id} and {reqs[j].req_id}'s "
          f"references swapped): faults {bad_faults}", flush=True)
    check(any(f.startswith(f"request {reqs[i].req_id} vs alone")
              for f in bad_faults)
          and any(f.startswith(f"request {reqs[j].req_id} vs alone")
                  for f in bad_faults),
          "(n) the sentinel with swapped references passed")
    lap("the references and the sentinel")

    # 4's reference: the same search and rerank run directly
    with torch.inference_mode():
        hyps = eng_mod.BeamSearcher(eng, beam_width=SERVER_BEAM_W).search(
            beam_ids, SERVER_BEAM_NEW, eos_token_id=SERVER_EOS)
        cands = [h.tokens for h in hyps]
        best = rerank.Reranker(rerank.LogProbScorer(eng)).select_best(
            beam_ids, cands)
    print(f"  beam: the server's winner {winner} (beam {sorted(beam_idx)}, "
          f"{frames[-1]['num_beams']} beams, {beam_wall * 1e3:.1f} ms); "
          f"direct search + rerank: beam {best} {cands[best]}", flush=True)
    check(winner == cands[best] and beam_idx == {best}
          and frames[-1]["num_beams"] == SERVER_BEAM_W == len(cands),
          "(n) the server's beam winner differs from the direct search")
    check(eng.allocator.num_live == live0, "(n) the references kept pages")

    # the server's objects hold the engine in reference cycles (the
    # handler class, the pump's closure): freed here, before (j) takes
    # over the weights
    del srv, core, w
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    ttft = metrics["ttft_s"]
    tps = conc_tokens / conc_wall
    print(f"  server: {conc_tokens} tokens to 8 concurrent requests in "
          f"{conc_wall:.3f} s = {tps:.2f} tok/s; TTFT from /metrics p50 "
          f"{ttft['p50']:.4f} s, p99 (the max of its {2 * len(texts)} streams) "
          f"{ttft['p99']:.4f} s; (n) took {wall:.1f} s ({card})", flush=True)
    return {"wall_s": wall, "lone_wall_s": lone_out["wall"],
            "lone_busy_s": busy_s, "lone_busy_share": share,
            "concurrent_wall_s": conc_wall, "concurrent_tokens": conc_tokens,
            "tok_s": tps, "ttft_p50_s": ttft["p50"],
            "ttft_max_s": ttft["p99"], "beam_wall_s": beam_wall,
            "requests_total": metrics["requests_total"],
            "tokens_out": metrics["tokens_out"],
            "pairs_before_fork": compared, "forks": len(forks),
            "sentinel_faults": len(bad_faults), "launches": counts,
            "beam_launches": beam_counts}


# -- path (o): an imported HF checkpoint --------------------------------------

#: path (o): the repo's Gemma-3-1B preset at full width and depth, written
#: as an HF checkpoint directory (``config.json``, shards of at most
#: ``HF_SHARD_BYTES`` and their index) and served from it through
#: ``router.build_engine``: w8a8 (INT8 at import), INT8 KV, page 64; one
#: prompt of 600 tokens (past the 512-token window: 3 chunks of 256) and
#: three of 64, :data:`HF_STEPS` greedy tokens each
HF_MODEL, HF_LENS, HF_STEPS = "gemma3-1b", (600, 64, 64, 64), 32
HF_SHARD_BYTES = 1 << 30
#: prefill-only runs whose median wall is the TTFT
HF_TTFT_REPS = 5


def write_safetensors(path, tensors):
    """Write ``tensors`` (name -> CPU tensor, in order) as one
    ``.safetensors`` file: an 8-byte little-endian header length, the
    JSON header (``dtype``, ``shape``, ``data_offsets`` a tensor; padded
    with spaces to 8 bytes), then the raw bytes. A writer for this script
    only; the port reads the format with its own reader."""
    import struct

    import torch

    names = {torch.bfloat16: "BF16", torch.float16: "F16",
             torch.float32: "F32", torch.float64: "F64", torch.int8: "I8",
             torch.uint8: "U8", torch.int16: "I16", torch.int32: "I32",
             torch.int64: "I64", torch.bool: "BOOL"}
    header, off = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            if t.numel():
                f.write(t.contiguous().reshape(-1).view(torch.uint8)
                        .numpy().data)


def write_hf_checkpoint(directory, tensors, config, shard_bytes):
    """Write ``tensors`` (name -> CPU tensor) into ``directory`` as HF
    writes a sharded checkpoint: ``model-0000i-of-0000n.safetensors`` of
    at most ``shard_bytes`` each (a larger tensor alone in its shard),
    ``model.safetensors.index.json`` and ``config.json``. Returns the
    number of shards."""
    shards, cur, size = [], {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        if cur and size + n > shard_bytes:
            shards.append(cur)
            cur, size = {}, 0
        cur[name] = t
        size += n
    if cur:
        shards.append(cur)
    weight_map = {}
    for i, shard in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        write_safetensors(os.path.join(directory, fname), shard)
        weight_map.update(dict.fromkeys(shard, fname))
    total = sum(t.numel() * t.element_size() for t in tensors.values())
    with open(os.path.join(directory, "model.safetensors.index.json"),
              "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(config, f)
    return len(shards)


def hf_config(m):
    """The HF ``config.json`` of a Gemma-3 text preset ``m``: its values
    under the names of Gemma-3's published configs."""
    return {"architectures": ["Gemma3ForCausalLM"],
            "model_type": "gemma3_text", "vocab_size": m.vocab_size,
            "hidden_size": m.hidden_size, "num_hidden_layers": m.num_layers,
            "num_attention_heads": m.num_heads,
            "num_key_value_heads": m.num_kv_heads, "head_dim": m.head_dim,
            "intermediate_size": m.intermediate_size,
            "max_position_embeddings": m.max_seq_len,
            "rms_norm_eps": m.norm_eps, "rope_theta": m.rope_theta,
            "rope_local_base_freq": m.rope_local_theta,
            "rope_scaling": m.rope_scaling,
            "attention_bias": m.use_qkv_bias,
            "sliding_window": m.sliding_window,
            "sliding_window_pattern": m.sliding_window_pattern,
            "tie_word_embeddings": m.tie_embeddings,
            "query_pre_attn_scalar": m.query_pre_attn_scalar,
            "attn_logit_softcapping": m.attn_logit_softcap or None,
            "final_logit_softcapping": m.final_logit_softcap or None,
            "hidden_activation": "gelu_pytorch_tanh",
            "eos_token_id": m.eos_token_id, "torch_dtype": "bfloat16"}


def gemma_tensors(torch, m, seed=SEED):
    """A Gemma-3 state dict for the preset ``m`` under HF's names and
    layout (``[out, in]`` projections), bf16 on the host: every matmul
    weight and the embedding ``0.02 * N(0, 1)``, drawn in f32 on the card
    from ``seed`` as ``init_params`` draws them; every norm weight 0 (Gemma
    stores its norms zero-centred, so each scales by 1)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def normal(*shape):
        t = torch.empty(shape, dtype=torch.float32, device="cuda")
        t.normal_(generator=gen).mul_(0.02)
        return t.to(torch.bfloat16).cpu()

    def zeros(n):
        return torch.zeros(n, dtype=torch.bfloat16)

    D, dh, I_ = m.hidden_size, m.head_dim, m.intermediate_size
    out = {"model.embed_tokens.weight": normal(m.vocab_size, D)}
    for i in range(m.num_layers):
        p = f"model.layers.{i}."
        out.update({
            p + "input_layernorm.weight": zeros(D),
            p + "post_attention_layernorm.weight": zeros(D),
            p + "pre_feedforward_layernorm.weight": zeros(D),
            p + "post_feedforward_layernorm.weight": zeros(D),
            p + "self_attn.q_proj.weight": normal(m.num_heads * dh, D),
            p + "self_attn.k_proj.weight": normal(m.num_kv_heads * dh, D),
            p + "self_attn.v_proj.weight": normal(m.num_kv_heads * dh, D),
            p + "self_attn.o_proj.weight": normal(D, m.num_heads * dh),
            p + "self_attn.q_norm.weight": zeros(dh),
            p + "self_attn.k_norm.weight": zeros(dh),
            p + "mlp.gate_proj.weight": normal(I_, D),
            p + "mlp.up_proj.weight": normal(I_, D),
            p + "mlp.down_proj.weight": normal(D, I_)})
    out["model.norm.weight"] = zeros(D)
    return out


def hf_import_path(torch, refs, greedy, card):
    """Path (o): :data:`HF_MODEL` written as an HF directory from the
    seed and served from it (``router.build_engine`` with ``weights_path``
    the directory, ``quant="int8"``: the stream import quantizes at
    import and the engine fuses the codes as they are): its
    ``config_from_hf`` against the preset, the timed run with exact
    launch counts, TTFT, teacher-forced logits against the plain versions
    (limit, SDPA reference, FP8-q control) and a second control, the same
    weights served with the local layers rotated by the global table,
    which must fail the limit."""
    import copy
    import tempfile
    from importlib import import_module

    cfgmod = import_module(f"{PKG}.config")
    eng_mod = import_module(f"{PKG}.engine")
    hs = import_module(f"{PKG}.models.hf_stream")
    qt = import_module(f"{PKG}.quant.tensor")
    router = import_module(f"{PKG}.engine.router")
    pre = cfgmod.preset(HF_MODEL)
    t_path = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="hf-gemma3-") as hf_dir:
        t0 = time.perf_counter()
        tensors = gemma_tensors(torch, pre)
        nbytes = sum(t.numel() * t.element_size() for t in tensors.values())
        shards = write_hf_checkpoint(hf_dir, tensors, hf_config(pre),
                                     HF_SHARD_BYTES)
        del tensors
        print(f"  wrote an HF directory: {nbytes / 1e9:.3f} GB of bf16 in "
              f"{shards} shards + index + config.json "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        check(shards >= 2, "(o) the checkpoint is not sharded")
        got = hs.config_from_hf(hf_dir)
        want, have = dataclasses.asdict(pre), dataclasses.asdict(got)
        differ = sorted(k for k in want if have[k] != want[k])
        print(f"  config_from_hf against the {HF_MODEL} preset: differs in "
              f"{differ} (name, and the EOS id config_from_hf leaves at the "
              "config default in both packages)", flush=True)
        check(differ == ["eos_token_id", "name"],
              f"(o) config_from_hf differs from the preset in {differ}")
        cfg, batch, _, _ = path_config("int8", model=HF_MODEL,
                                       batch=len(HF_LENS),
                                       prompt_len=max(HF_LENS))
        got.quant = "int8"
        cfg.model, cfg.weights_path = got, hf_dir
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        eng = router.build_engine(cfg, device="cuda", seed=SEED)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    held = (torch.cuda.memory_allocated() - before) / 1e9
    print(f"  router.build_engine on the directory (stream import, INT8 at "
          f"import, fused on the card) in {build_s:.1f} s; holds "
          f"{held:.2f} GB on the card (peak while building +"
          f"{(torch.cuda.max_memory_allocated() - before) / 1e9:.2f} GB; "
          f"{before / 1e9:.2f} GB held before)", flush=True)
    lp0 = eng.params["layers"][0]
    check(isinstance(lp0["w_qkv"], qt.QTensor) and "wq" not in lp0,
          "(o) the engine did not fuse the imported INT8 projections")
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, pre.vocab_size, n).tolist() for n in HF_LENS]
    check(prefill_chunks(eng, prompts) == 3, "(o) not 3 prefill chunks")
    info = drive(torch, eng, prompts, greedy, HF_STEPS, "hf-import")
    counts = info["launches"]
    off = {k: counts[k] for k in ("paged_attention_decode_grouped",
                                  "paged_attention_decode_batched",
                                  "paged_attention_decode_packed",
                                  "paged_attention_decode_append")}
    print(f"  B6-B9 launches (must be 0): {json.dumps(off)}", flush=True)
    check(not any(off.values()), "(o) B6-B9 were launched")
    ttft = []
    for _ in range(HF_TTFT_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.generate_batch_fused(prompts, 1, greedy)
        torch.cuda.synchronize()
        ttft.append(time.perf_counter() - t0)
    info["ttft_p50_s"] = float(np.median(ttft))
    info.update(profile_run(torch, "fused", lambda n: (
        eng.generate_batch_fused(prompts, n, greedy))))

    tf = logit_checks(torch, eng, refs, forced_run(
        torch, eng, prompts, greedy, HF_STEPS), TOL[("hf-import", "bf16")],
        "bf16", keep=True)
    info.update(limit_readings(tf, "bf16"))
    # the second control: the same weights, every layer rotated by the
    # global table (a model that ignores rope_local_theta)
    ctrl_cfg = copy.deepcopy(cfg)
    ctrl_cfg.model.rope_local_theta = 0.0
    ctrl_cfg.weights_path = None
    ctrl = eng_mod.Engine(ctrl_cfg, params=eng.params, device="cuda")
    lc, _ = forced_logits(torch, ctrl, None, prompts, greedy, HF_STEPS,
                          tf["fed"])
    rope = compare(lc, tf["plain_logits"])
    print(f"  global-table control (local layers rotated at rope_theta "
          f"{pre.rope_theta:g}, not {pre.rope_local_theta:g}): max|dlogit| "
          f"vs plain {rope['max']:.4e} (must fail the limit "
          f"{tf['tol']:.4e}); its greedy agreement {rope['agree']:.3f}",
          flush=True)
    check_limit(rope["max"] > tf["tol"], "(o) the limit does not flag the "
                "local layers rotated by the global table")
    info["rope_control_max_dlogit"] = rope["max"]
    del ctrl
    info.update(engine_gb=held, build_s=build_s, shards=shards,
                checkpoint_gb=nbytes / 1e9,
                wall_s=time.perf_counter() - t_path)
    print(f"  (o): decode {info['decode_tok_s']:.1f} tok/s (B={batch}, "
          f"{HF_STEPS} tokens), TTFT p50 {info['ttft_p50_s'] * 1e3:.2f} ms "
          f"(prefill of prompts of {list(HF_LENS)} tokens, {HF_TTFT_REPS} "
          f"runs); (o) took "
          f"{info['wall_s']:.1f} s ({card})", flush=True)
    del eng
    torch.cuda.empty_cache()
    return info

def sdpa_paged(q, kv_pages, block_tables, seq_lens, q_offsets,
               kv_scales=None, layer=None, *, page_size, num_q_heads,
               window=0, softcap=0.0, scale=None):
    """Paged attention as one scaled_dot_product_attention call over a
    dense, dequantized, gathered copy of the pages (f32), the sliding
    window in its mask. A reference for this script only; the port never
    calls it."""
    import torch
    import torch.nn.functional as F_

    assert softcap == 0.0
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
    if window > 0:
        mask &= key > qpos[:, :, None] - window
    out = F_.scaled_dot_product_attention(
        q.float().transpose(1, 2), k, v, attn_mask=mask[:, None],
        scale=scale)
    return torch.nan_to_num(out).transpose(1, 2).to(q.dtype)


def reference_backends():
    """The references the kernel path is held against, each a
    ``PagedKVBackend`` with its wrappers replaced (every decode route's
    alike) and the matmul wrappers it swaps in (the port never uses
    them): ``plain``, the kernels' plain PyTorch versions; ``sdpa``, plain
    appends, :func:`sdpa_paged` attention and products computed another way (``torch._int_mm`` for
    B10, a bf16 cuBLAS product over a widened weight for B11,
    :func:`w4_matmul_grouped` for B12, :func:`grouped_matmul_library` for
    B13; B14/B15's plain versions, since no
    library call computes a chain); ``lowp``, the plain versions with attention at
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
    cl = import_module(f"{PKG}.ops.chain_linear")
    gm = import_module(f"{PKG}.ops.gmm")
    plain_mm = {"int8_matmul": i8.int8_matmul_plain,
                "w8_matmul": i8.w8_matmul_plain,
                "w4_matmul": i4.w4_matmul_plain,
                "chain_decode": cl.chain_decode_plain,
                "packed_linear": cl.packed_linear_plain,
                "grouped_matmul": gm.grouped_matmul_plain}
    # no library call computes a chain: the chains' plain versions
    library_mm = {"int8_matmul": int8_matmul_library,
                  "w8_matmul": w8_matmul_library,
                  "w4_matmul": w4_matmul_grouped,
                  "chain_decode": cl.chain_decode_plain,
                  "packed_linear": cl.packed_linear_plain,
                  "grouped_matmul": grouped_matmul_library}

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
        attend_decode_grouped = staticmethod(
            pa.paged_attention_decode_grouped_plain)
        attend_decode_packed = staticmethod(
            pa.paged_attention_decode_packed_plain)
        attend_decode_append = staticmethod(
            pa.paged_attention_decode_append_plain)

    class Sdpa(Plain):
        attend = staticmethod(sdpa_paged)
        attend_decode = attend_decode_grouped = attend_decode_packed = \
            staticmethod(sdpa_decode)

    class LowPrecision(Plain):
        attend = staticmethod(lower_precision(pa.paged_attention_plain))
        attend_decode = attend_decode_grouped = attend_decode_packed = \
            staticmethod(lower_precision(pa.paged_attention_decode_plain))

    return {"plain": (Plain, plain_mm), "sdpa": (Sdpa, library_mm),
            "lowp": (LowPrecision, plain_mm)}


def profile_run(torch, label, run, steps=16):
    """Device busy share and time by kernel over one ``run(steps)`` (a
    generation loop), from ``torch.profiler`` (CUPTI); a trace without
    kernel records is taken again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(steps)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        rows = []
        kernels = 0                     # every device kernel and copy
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:  # CPU ops repeat their
                continue                          # kernels' time
            kernels += e.count
            dev_us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
            if dev_us > 0:
                rows.append((dev_us, e.count, e.key))
        if rows:
            break
        print(f"  (trace {attempt + 1} of the {label} run held no device "
              "time; tracing again)", flush=True)
    check(bool(rows), f"profiler saw no device time in the {label} run")
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    # the projections and the LM head: cuBLAS's GEMM kernels (dense
    # weights) or the port's quantized-weight kernels
    gemm_us = sum(r[0] for r in rows
                  if any(s in r[2].lower() for s in ("gemm", "nvjet")))
    by_kernel = {k: sum(r[0] for r in rows if any(m in r[2] for m in names))
                 for k, names in KERNEL_NAMES.items()}
    qmm_us = sum(by_kernel[k] for k in QUANT_PRODUCTS)
    kernels_us = sum(by_kernel.values())
    print(f"  profile of one {label} run ({steps} tokens): wall "
          f"{wall_us / 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms "
          f"({busy_us / wall_us:.3f} of wall), of which cuBLAS GEMMs "
          f"{gemm_us / 1e3:.1f} ms, the port's kernels "
          f"{kernels_us / 1e3:.1f} ms (its quantized products "
          f"{qmm_us / 1e3:.1f} ms); {kernels} device kernels "
          f"({kernels / steps:.1f} a token); top device time:", flush=True)
    for dev_us, count, key in rows[:12]:
        print(f"    {dev_us / 1e3:9.3f} ms  x{count:<6d} {key[:90]}",
              flush=True)
    return {"profile_wall_ms": wall_us / 1e3,
            "profile_device_busy_ms": busy_us / 1e3,
            "profile_busy_share": busy_us / wall_us,
            "profile_gemm_ms": gemm_us / 1e3,
            "profile_quant_matmul_ms": qmm_us / 1e3,
            "profile_port_kernels_ms": kernels_us / 1e3,
            "profile_kernels": kernels,
            "profile_kernel_ms": {k: us / 1e3 for k, us in by_kernel.items()
                                  if us > 0}}


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
                    "int4_matmul", "chain_linear", "gmm"):
            import_module(f"{PKG}.ops.{mod}")
        check("jax" not in sys.modules, "jax was imported")

        phase("1: card and build")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        card = smi.stdout.strip().splitlines()[0] if smi.stdout else ""
        check(smi.returncode == 0 and card, "nvidia-smi failed")
        print(f"  card: {card}", flush=True)
        t0 = time.perf_counter()
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            built = plat.build_kernels(verbose=True)
        print(log.getvalue(), end="", flush=True)
        print(f"  kernels built in {time.perf_counter() - t0:.1f} s",
              flush=True)
        t0 = time.perf_counter()
        tensor_core_report(log.getvalue(), built)
        print(f"  report in {time.perf_counter() - t0:.1f} s", flush=True)

        results = {n: {"name": n, "route": "cuda",
                       "source": f"{PKG}/csrc/{k.source}",
                       "replaces": f"{TPU_PKG}/{k.replaces}"}
                   for n, k in plat.KERNELS.items()}
        phase("2: kernels vs plain versions")
        with torch.inference_mode():
            attention_checks(torch, F_, dev, results)
            b1_shape_checks(torch, F_, dev, results)
            b1_score_checks(torch, F_, dev, results)
            append_checks(torch, dev, results)
            decode_append_checks(torch, dev, results)
            decode_variant_checks(torch, F_, dev, results)
            matmul_checks(torch, dev, results)
            chain_checks(torch, dev, results)
            gmm_checks(torch, dev, results)
        e2e = run_paths(torch, dev, results, card)
        for name, r in results.items():
            if name in OFF_PATH:
                r["launches"] = 0           # each path checked it exactly
                continue
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

    # unfused_ms: the device time of the port's own calls a kernel fuses
    # (B9: kv_append then B2, every kernel they launch), null for a kernel
    # that fuses none; call_ms: the device time of the whole wrapper call
    # (B3, B5: kv_append; B9: its wrapper, stack_new_kv's glue included;
    # every kernel it launches); b2_ms: B2
    # on the same inputs (B6 at path (i)'s 516 pages, B7 at B2's shape);
    # m36_* / m256_*: B10-B12 over a layer's four projections at a verify
    # chunk (B10) and a prefill chunk, beside their bound and library call;
    # shapes: the redesigned kernels' other held shapes (B11's head at
    # M=36 and 256 and Mixtral's products at M=1024; B2 at path (k)'s
    # decode, 512 pages with B6 beside, ragged tables), each with its
    # times, bound and library call
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "unfused_ms", "call_ms", "b2_ms", "tol", "m36_ms",
            "m36_bound_ms",
            "m36_library_ms", "m256_ms", "m256_bound_ms", "m256_library_ms",
            "shapes", "scores")
    phase("4: summary")
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
