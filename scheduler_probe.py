"""Where a request served by the scheduler first leaves the same request
run alone, on the card.

    python3 scheduler_probe.py [--request N]

Runs ``chip_smoke.py`` path (l)'s traffic (eight requests in three
waves, the pool shrunk to force a swap, then grown back) through the
port's ``Scheduler`` on path (b)'s engine (Llama-3-8B, w8a8, 32 layers,
INT8 KV at page 64), recording the burst in which request ``N`` (the
index into path (l)'s prompts; default 4, the 256-token prompt) decodes
its first eight tokens after its prefill. Then the same prompt runs alone
through ``Engine.prefill`` and ``_step_logits``, teacher-forced with the
scheduler's tokens, and the two are compared, the request's lane against
the lone row:

* each step's logits, and per layer the appended K/V rows, q and the
  attention output;
* per step, every ``rmsnorm`` and ``linear`` call of the model in order
  (its input and output), up to the first forty;
* the request's pool rows (values and INT8 scales, every layer) after the
  burst;
* the first call whose input is equal and whose output is not, run again
  on the lane batch and on the request's row alone (three times each);
* for the norm, how often a random row's output and its f32 mean of
  squares differ between a batch of four rows and the row alone.

The card's name and power limit come first. Every kernel the path runs
is built from ``csrc/`` into ``_build/`` if it is not there yet.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import subprocess
import sys
import time
from importlib import import_module

import numpy as np
import torch

import chip_smoke as c

PKG = c.PKG
STEPS = 8            # the decode steps compared after the prefill
OPS = 40             # the norm and linear calls recorded a step


def maxdiff(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def row(t, i):
    return t.reshape(-1, t.shape[-1])[i]


class Recorder:
    """Hooks on one engine: while ``on``, each T=1 forward opens a step
    record (its logits, per layer the appended k/v rows and positions, q,
    the attention output, seq_lens and block tables, and every norm and
    linear call's input and output)."""

    def __init__(self, eng):
        pb = import_module(f"{PKG}.engine.paged_backend")
        model = import_module(f"{PKG}.models.model")
        self.on, self.steps = False, []
        attend, append = pb.PagedKVBackend.attend_decode, eng.backend.append
        forward = eng.model.forward
        self.norm, self.linear = model.rmsnorm, model.linear

        def rec_attend(q, pages, bt, sl, scales, layer, **kw):
            out = attend(q, pages, bt, sl, scales, layer, **kw)
            if self.on:
                self.cur["attn"][layer] = (q.clone(), out.clone(),
                                           sl.clone())
            return out

        def rec_append(kv, k, v, layer, positions, bt, **kw):
            if self.on and k.shape[1] == 1:
                self.cur["kv"][layer] = (k.clone(), v.clone(),
                                         positions.clone())
            return append(kv, k, v, layer, positions, bt, **kw)

        def rec_forward(params, tokens, positions, kv, attn):
            if self.on and tokens.shape[1] == 1:
                self.cur = {"attn": {}, "kv": {}, "ops": []}
                self.steps.append(self.cur)
            logits, kv = forward(params, tokens, positions, kv, attn)
            if self.on and tokens.shape[1] == 1:
                self.cur["logits"] = logits[:, 0].float().clone()
            return logits, kv

        def rec_op(name, fn):
            def call(x, *a, **k):
                y = fn(x, *a, **k)
                if self.on and len(self.cur["ops"]) < OPS:
                    self.cur["ops"].append((name, x.clone(), y.clone(), a,
                                            k))
                return y
            return call

        pb.PagedKVBackend.attend_decode = staticmethod(rec_attend)
        eng.backend.append = rec_append
        eng.model.forward = rec_forward
        model.rmsnorm = rec_op("rmsnorm", self.norm)
        model.linear = rec_op("linear", self.linear)


def scheduler_run(eng, rec, target):
    """Path (l)'s run; returns the requests and, for the burst in which
    request ``target`` decodes from its prefill, the request's lane, block
    table row and a copy of the pool after the burst."""
    sch = import_module(f"{PKG}.scheduler")
    greedy = import_module(f"{PKG}.engine").SamplingParams(
        temperature=0.0, eos_token_id=-1)
    prompts, news = c.scheduler_traffic(eng.cfg.vocab_size)
    sched = sch.Scheduler(eng)
    loop, seen = eng._decode_loop_fn, {}

    def burst(params, tokens, kv, bt, sl, em, bud, seeds, samp, counts, *,
              num_steps, mode):
        lanes = {l.idx: l.request.req_id for l in sched.lanes
                 if l.request is not None}
        sl_h, bt_h = sl.cpu().numpy(), bt.cpu().numpy()
        lane = next((i for i, rid in lanes.items() if rid == target + 1),
                    None)
        print(f"  burst of {num_steps}: lanes {lanes}, seq_lens "
              f"{sl_h.tolist()}, emitted {em.tolist()}, budgets "
              f"{bud.tolist()}", flush=True)
        rec.on = (lane is not None and not seen
                  and sl_h[lane] == len(prompts[target]))
        try:
            out = loop(params, tokens, kv, bt, sl, em, bud, seeds, samp,
                       counts, num_steps=num_steps, mode=mode)
        finally:
            if rec.on:
                seen.update(lane=lane, bt=bt_h[lane].tolist(),
                            snap=tuple(t.clone() for t in out[1]))
            rec.on = False
        return out

    eng._decode_loop_fn = burst
    full = eng.cache.num_pages
    sched.resize(c.SCHED_SHRINK)
    reqs, tick, grown = [], 0, False
    while True:
        reqs += [sched.submit(prompts[i], news[i], greedy)
                 for i in c.SCHED_WAVES.get(tick, ())]
        busy = sched.step()
        tick += 1
        if sched.n_preempted and not grown:
            sched.resize(full)
            grown = True
        if busy == 0 and sched.waiting.empty() and tick > max(c.SCHED_WAVES):
            break
    del eng._decode_loop_fn
    c.check(seen, f"request {target + 1} decoded from its prefill in no "
            "recorded burst")
    return prompts, reqs, seen


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--request", type=int, default=4,
                    help="index of the request in path (l)'s prompts")
    args = ap.parse_args()
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
    eng, _ = c.build_engine(torch, c.path_config("int8",
                                                 spec_k=c.SPEC_K)[0])
    rec = Recorder(eng)
    target = args.request
    prompts, reqs, seen = scheduler_run(eng, rec, target)
    req, lane = reqs[target], seen["lane"]
    sched_steps, rec.steps = rec.steps, []
    print(f"request {req.req_id} ({len(req.prompt)}-token prompt, lane "
          f"{lane}): tokens {req.tokens[:STEPS + 1]}", flush=True)

    with torch.inference_mode():
        state = eng.prefill([prompts[target]], sampling=import_module(
            f"{PKG}.engine").SamplingParams(temperature=0.0,
                                            eos_token_id=-1))
        c.check(int(state.last_tokens[0]) == req.tokens[0],
                "the first token differs from the request's alone")
        rec.on = True
        for t in range(STEPS):
            eng._step_logits(state, np.asarray([req.tokens[t]], np.int32))
        rec.on = False
        ref_steps = rec.steps
        torch.cuda.synchronize()

        culprit = None
        for s, (S, R) in enumerate(zip(sched_steps, ref_steps)):
            layers = []
            for layer in range(eng.cfg.num_layers):
                ks, vs, ps = S["kv"][layer]
                kr, vr, _ = R["kv"][layer]
                qs, os_, _ = S["attn"][layer]
                qr, or_, _ = R["attn"][layer]
                ds = (maxdiff(ks[lane], kr[0]), maxdiff(vs[lane], vr[0]),
                      maxdiff(qs[lane], qr[0]), maxdiff(os_[lane], or_[0]))
                if any(ds):
                    layers.append((layer,) + ds)
            print(f"step {s} (position {int(S['kv'][0][2][lane, 0])}): "
                  f"max|dlogit| {maxdiff(S['logits'][lane], R['logits'][0]):.4g}"
                  f"; layers that differ (layer, dk, dv, dq, dout): "
                  f"{layers[:6]}", flush=True)
            ops = []
            for j, ((name, xs, ys, a, k), (_, xr, yr, _, _)) in enumerate(
                    zip(S["ops"], R["ops"])):
                di = maxdiff(row(xs, lane), row(xr, 0))
                do = maxdiff(row(ys, lane), row(yr, 0))
                ops.append((j, name, di, do))
                if culprit is None and di == 0 and do:
                    culprit = (s, j, name, xs, a, k)
            if any(di or do for _, _, di, do in ops):
                print(f"  its calls (index, op, max|din|, max|dout|): "
                      f"{ops[:20]}", flush=True)

        # the request's pool rows after the burst against the lone run's
        snap, page = seen["snap"], eng.cache.page_size
        sv, rv = snap[0], state.kv[0]
        ss = snap[1].reshape(snap[1].shape[:3] + (-1,))
        rs = state.kv[1].reshape(state.kv[1].shape[:3] + (-1,))
        differ = []
        for p in range(len(req.prompt) + STEPS):
            a_pg, b_pg, sl = (seen["bt"][p // page],
                              state.pages[0][p // page], p % page)
            dv = (sv[:, :, :, a_pg, sl].int()
                  - rv[:, :, :, b_pg, sl].int()).abs().amax(dim=(1, 2, 3))
            dsc = (ss[:, :, :, a_pg * page + sl]
                   - rs[:, :, :, b_pg * page + sl]).abs().amax(dim=(1, 2))
            bad = torch.nonzero((dv > 0) | (dsc > 0)).flatten().tolist()
            if bad:
                differ.append((p, bad[:4]))
        print(f"pool rows that differ (position, first layers): "
              f"{len(differ)} of {len(req.prompt) + STEPS}: {differ[:12]}",
              flush=True)

        if culprit is not None:
            s, j, name, xs, a, k = culprit
            fn = rec.norm if name == "rmsnorm" else rec.linear
            batch = [fn(xs, *a, **k) for _ in range(3)]
            alone = [fn(xs[lane:lane + 1], *a, **k) for _ in range(3)]
            print(f"first call with an equal input and another output: step "
                  f"{s}, call {j} ({name}, input {tuple(xs.shape)}); the "
                  f"lane's row in the batch vs alone: "
                  f"{[maxdiff(row(y4, lane), row(y1, 0)) for y4, y1 in zip(batch, alone)]}"
                  f"; run to run: batch {maxdiff(batch[0], batch[1])}, alone "
                  f"{maxdiff(alone[0], alone[1])}", flush=True)
            if name == "rmsnorm":
                x32 = xs.float()
                m4 = x32.square().mean(dim=-1)[lane].item()
                m1 = x32[lane:lane + 1].square().mean(dim=-1)[0].item()
                print(f"  its f32 mean of squares: in the batch {m4!r}, "
                      f"alone {m1!r}", flush=True)

        gen = torch.Generator(device=eng.device).manual_seed(c.SEED)
        w = eng.params["layers"][1]["ln2_scale"]
        outs = means = 0
        trials = 256
        for _ in range(trials):
            x = (torch.randn((4, 1, eng.cfg.hidden_size), generator=gen,
                             device=eng.device) * 4).to(torch.bfloat16)
            y4 = rec.norm(x, w, eng.cfg.norm_eps)
            m4 = x.float().square().mean(dim=-1)
            for i in range(4):
                outs += not torch.equal(
                    y4[i], rec.norm(x[i:i + 1], w, eng.cfg.norm_eps)[0])
                means += not torch.equal(
                    m4[i], x[i:i + 1].float().square().mean(dim=-1)[0])
        print(f"rmsnorm over {4 * trials} random rows (N(0, 16) in bf16, "
              f"width {eng.cfg.hidden_size}): outputs that differ between a "
              f"batch of 4 and the row alone {outs}; f32 means of squares "
              f"that differ {means}", flush=True)
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
