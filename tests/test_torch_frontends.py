"""The port's checkpoints, engine router, profiling, debug maps and CLI
frontends against the JAX package.

Checkpoints: a file the JAX package saves loads into the port's
``Engine`` with the greedy stream and prefill logits of the JAX engine
loaded from the same file, for every quant mode (float and INT8 leaves;
an INT4 engine's repacked leaves too), and a file the port saves loads in
the JAX package with equal arrays, bf16 bit for bit. The router: the
backends, a weights file, and what raises. Profiling: ``device_busy_s``
against the JAX one on the same spans, each in its own trace format, and
``StepTimer``'s summary. Debug: ``attention_maps`` against the JAX one.
The CLI: JAX ``tests/test_cli_tokenizer.py``'s scripted ``chat`` and
``log`` with ``--device cpu``, and ``serve``.
"""

import gzip
import http.client
import json

import numpy as np
import pytest
import torch

import jax

from pagedattention_based_transformer_decoder_inference_framework_tpu import config as jconfig
from pagedattention_based_transformer_decoder_inference_framework_tpu.engine import (
    Engine as JaxEngine, SamplingParams as JaxSampling)
from pagedattention_based_transformer_decoder_inference_framework_tpu.models import (
    checkpoint as jckpt)
from pagedattention_based_transformer_decoder_inference_framework_tpu.models.model import (
    DecoderModel as JaxModel, init_params as jax_init_params,
    quantize_params as jax_quantize_params)
from pagedattention_based_transformer_decoder_inference_framework_tpu.utils import (
    debug as jdebug, profiling as jprof)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch import config as tconfig
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.cli.cli_app import main
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.engine import (
    Engine, SamplingParams)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.engine import router
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.models import (
    DecoderModel, checkpoint as tckpt, init_params, params_from_jax,
    quantize_params)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.quant.tensor import (
    Q4Tensor, QTensor)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.server import basic
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.utils import (
    debug as tdebug, profiling as tprof)

from test_torch_model import model_cfgs

PROMPT = [3, 5, 7, 9, 11]
TOL = dict(atol=5e-3, rtol=5e-2)     # the engine tests' logit tolerance


def cfg_pair(quant="none"):
    jm, tm = model_cfgs("llama-tiny")
    jm.quant = tm.quant = quant
    return [mod.FrameworkConfig(
        model=m,
        cache=mod.CacheConfig(page_size=8, num_pages=64, max_pages_per_seq=8,
                              kv_dtype="float32"),
        runtime=mod.RuntimeConfig(max_new_tokens=8))
        for mod, m in ((jconfig, jm), (tconfig, tm))]


def stream_and_logits(eng, greedy):
    out = eng.generate(PROMPT, 8, greedy)
    st = eng.prefill([PROMPT], sampling=greedy)
    logits = np.asarray(st.prefill_logits)
    eng.free(st)
    return out, logits


def assert_engines_agree(je, te):
    jt, jl = stream_and_logits(je, JaxSampling(temperature=0.0,
                                               eos_token_id=-1))
    tt, tl = stream_and_logits(te, SamplingParams(temperature=0.0,
                                                  eos_token_id=-1))
    assert tt == jt
    np.testing.assert_allclose(tl, jl, **TOL)


# -- checkpoints ---------------------------------------------------------------

@pytest.mark.parametrize("quant", ["none", "int8", "int8-weight", "int4"])
def test_jax_checkpoint_serves_on_the_port(tmp_path, quant):
    """JAX ``save_params`` -> port ``load_params`` -> ``Engine``: the JAX
    engine's stream and logits, loaded from the same file. INT8 modes
    save INT8 leaves; none and int4 float ones (each engine repacks)."""
    jcfg, tcfg = cfg_pair(quant)
    params = jax_init_params(jcfg.model, jax.random.key(0))
    if quant in ("int8", "int8-weight"):
        params = jax_quantize_params(params)
    path = str(tmp_path / "w.npz")
    jckpt.save_params(params, path)
    loaded = tckpt.load_params(path)
    if quant in ("int8", "int8-weight"):
        assert isinstance(loaded["layers"]["wq"], QTensor)
        assert loaded["layers"]["wq"].values.dtype == torch.int8
    je = JaxEngine(jcfg, params=jckpt.load_params(path), interpret=True)
    te = Engine(tcfg, params=loaded, device="cpu")
    assert_engines_agree(je, te)
    if quant == "int4":
        # the JAX engine's repacked INT4 leaves (unstacked layers, saved
        # under integer keys) serve on the port as they are
        jparams = dict(je.params)
        jparams["layers"] = {str(i): lp
                             for i, lp in enumerate(jparams["layers"])}
        path4 = str(tmp_path / "w4.npz")
        jckpt.save_params(jparams, path4)
        loaded4 = tckpt.load_params(path4)
        assert isinstance(loaded4["layers"], tuple)
        w = loaded4["layers"][0]["w_qkv"]
        assert isinstance(w, Q4Tensor) and (w.group, w.bn) == (
            je.params["layers"][0]["w_qkv"].group,
            je.params["layers"][0]["w_qkv"].bn)
        assert_engines_agree(je, Engine(tcfg, params=loaded4, device="cpu"))


def _leaves(tree, key=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{key}/{k}")
    elif hasattr(tree, "values") and hasattr(tree, "scales"):
        yield key + ".qvalues", tree.values      # either package's QTensor
        yield key + ".qscales", tree.scales
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{key}/{i}")
    else:
        yield key, tree


def _bits(a):
    a = a.detach().cpu() if isinstance(a, torch.Tensor) else np.asarray(a)
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return a.numpy(), str(a.dtype).replace("torch.", "")
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16), "bfloat16"
    return a, a.dtype.name


@pytest.mark.parametrize("quantized", [False, True])
def test_port_checkpoint_loads_in_jax(tmp_path, quantized):
    """Port ``save_params`` -> JAX ``load_params``: equal arrays (bf16 bit
    for bit), INT8 leaves as the JAX ``QTensor``; and back."""
    cfg = tconfig.preset("llama-tiny")           # bf16 weights
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    if quantized:
        params = quantize_params(params)
    path = str(tmp_path / "p.npz")
    tckpt.save_params(params, path)
    jtree = jckpt.load_params(path)
    ours = dict(_leaves(params))
    theirs = dict(_leaves(jtree))
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        a, adt = _bits(ours[k])
        b, bdt = _bits(theirs[k])
        assert adt == bdt and np.array_equal(a, b), k
    assert any(dt == "bfloat16" for dt in (_bits(v)[1] for v in ours.values()))
    if quantized:
        assert type(jtree["layers"]["wq"]).__name__ == "QTensor"
    # and the JAX tree saved again reads back to the port's bits
    path2 = str(tmp_path / "p2.npz")
    jckpt.save_params(jtree, path2)
    back = dict(_leaves(tckpt.load_params(path2)))
    for k in ours:
        assert np.array_equal(_bits(back[k])[0], _bits(ours[k])[0]), k


# -- the router ------------------------------------------------------------------

def test_router_backends(monkeypatch):
    tcfg = cfg_pair()[1]
    tcfg.server.backend = "cpu"
    assert router.build_engine(tcfg).device == torch.device("cpu")
    assert router.resolve_backend("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        router.resolve_backend("gpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in ("auto", "tpu"):
        tcfg.server.backend = mode
        with pytest.raises(RuntimeError, match="no CUDA device"):
            router.build_engine(tcfg)
    # an explicit device wins over the backend
    assert router.build_engine(tcfg, device="cpu").device == torch.device(
        "cpu")


def test_router_loads_a_weights_file(tmp_path):
    jcfg, tcfg = cfg_pair()
    params = jax_init_params(jcfg.model, jax.random.key(3))
    path = str(tmp_path / "w.npz")
    jckpt.save_params(params, path)
    tcfg.weights_path = path
    eng = router.build_engine(tcfg, device="cpu")
    np.testing.assert_array_equal(eng.params["embedding"].numpy(),
                                  np.asarray(params["embedding"]))
    ref = Engine(tcfg, params=tckpt.load_params(path), device="cpu")
    greedy = SamplingParams(temperature=0.0, eos_token_id=-1)
    assert eng.generate(PROMPT, 6, greedy) == ref.generate(PROMPT, 6, greedy)


def test_router_refuses_what_is_not_ported(tmp_path):
    """A directory is taken as an HF checkpoint and stream-imported
    (``tests/test_torch_hf_import.py``): one with no safetensors raises
    ``FileNotFoundError``, as the JAX ``ShardReader`` does. Parallel
    configs still raise, naming A7."""
    tcfg = cfg_pair()[1]
    tcfg.weights_path = str(tmp_path)                 # an empty directory
    with pytest.raises(FileNotFoundError, match="model.safetensors"):
        router.build_engine(tcfg, device="cpu")
    tcfg.weights_path = None
    for axis in ("dp", "tp", "sp"):
        tcfg.parallel = tconfig.ParallelConfig(**{axis: 2})
        with pytest.raises(NotImplementedError, match="A7"):
            router.build_engine(tcfg, device="cpu")


# -- profiling -------------------------------------------------------------------

def synthetic_spans(seed, n=40):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, 5000, n))
    return [(int(t), int(d)) for t, d in zip(ts, rng.integers(1, 400, n))]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_busy_matches_jax(tmp_path, seed):
    """The same device spans (overlapping), with host spans beside them,
    in the JAX trace format (gzip, device pids by process name) and in
    the PyTorch profiler's (device spans by category): the same union."""
    dev = synthetic_spans(seed)
    host = synthetic_spans(seed + 100, 10)
    jdir = tmp_path / "jax" / "plugins" / "profile" / "run"
    jdir.mkdir(parents=True)
    jev = [{"ph": "M", "name": "process_name", "pid": 1,
            "args": {"name": "/device:TPU:0"}},
           {"ph": "M", "name": "process_name", "pid": 2,
            "args": {"name": "/host:CPU"}}]
    jev += [{"ph": "X", "pid": 1, "ts": t, "dur": d} for t, d in dev]
    jev += [{"ph": "X", "pid": 2, "ts": t, "dur": d} for t, d in host]
    with gzip.open(jdir / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": jev}, f)
    cats = ("kernel", "gpu_memcpy", "gpu_memset")
    tev = [{"ph": "X", "cat": cats[i % 3], "ts": t, "dur": d}
           for i, (t, d) in enumerate(dev)]
    tev += [{"ph": "X", "cat": c, "ts": t, "dur": d}
            for c, (t, d) in zip(("cpu_op", "cuda_runtime") * 5, host)]
    tdir = tmp_path / "torch"
    tdir.mkdir()
    with open(tdir / "0-1.pt.trace.json", "w") as f:
        json.dump({"traceEvents": tev}, f)
    want = jprof.device_busy_s(str(tmp_path / "jax"))
    got = tprof.device_busy_s(str(tdir))
    assert want is not None and got == pytest.approx(want, rel=1e-12)
    assert got < sum(d for _, d in dev) / 1e6       # a union, not a sum


def test_trace_on_the_cpu(tmp_path):
    """``trace`` exports a Chrome trace; with no device spans the busy
    time is None, and ``traced_device_s`` never raises."""
    with tprof.trace(str(tmp_path)):
        with tprof.annotate("phase/a"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.load(open(files[0]))["traceEvents"]}
    assert "phase/a" in names
    assert tprof.device_busy_s(str(tmp_path)) is None
    assert tprof.traced_device_s(lambda: torch.ones(3) + 1) is None
    assert tprof.device_busy_s(str(tmp_path / "none")) is None


def test_step_timer_matches_jax(monkeypatch):
    import time

    summaries = []
    for mod in (jprof, tprof):
        clock = iter(np.cumsum([0.0, 0.25, 0.5, 0.125, 1.0, 0.0625, 2.0]))
        monkeypatch.setattr(time, "perf_counter", lambda: float(next(clock)))
        timer = mod.StepTimer()
        for name in ("prefill", "decode", "prefill"):
            with timer.phase(name):
                pass
        summaries.append(timer.summary())
        monkeypatch.undo()
    assert summaries[1] == summaries[0]
    assert summaries[1]["prefill"]["count"] == 2


# -- debug -----------------------------------------------------------------------

def test_attention_maps_match_jax():
    jm, tm = model_cfgs("llama-tiny")
    jp = jax_init_params(jm, jax.random.key(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tm)
    toks = [1, 2, 3, 4, 5, 6, 7]
    ja, jl = jdebug.attention_maps(JaxModel(jm), jp, toks)
    ta, tl = tdebug.attention_maps(DecoderModel(tm), tp, toks)
    assert ta.shape == (tm.num_layers, tm.num_heads, 7, 7)
    np.testing.assert_allclose(ta, ja, atol=1e-5)
    np.testing.assert_allclose(tl, jl, **TOL)
    np.testing.assert_allclose(ta.sum(-1), 1.0, atol=1e-5)
    assert np.triu(ta, 1).max() < 1e-6              # strictly causal


# -- the CLI ---------------------------------------------------------------------

ARGS = ["--model", "gpt2-tiny", "--max-new-tokens", "4",
        "--temperature", "0.0", "--device", "cpu"]


def test_cli_chat_scripted(monkeypatch, capsys):
    inputs = iter(["hello", "again", ""])
    monkeypatch.setattr("builtins.input", lambda *a: next(inputs))
    rc = main(["chat", *ARGS])
    assert rc == 0
    assert capsys.readouterr().out.count("bot>") == 2


def test_cli_log_writes_session(tmp_path, monkeypatch):
    inputs = iter(["hi there", ""])
    monkeypatch.setattr("builtins.input", lambda *a: next(inputs))
    session = tmp_path / "sess.jsonl"
    rc = main(["log", *ARGS, "--session", str(session)])
    assert rc == 0
    rows = [json.loads(l) for l in session.read_text().splitlines()]
    assert len(rows) == 1 and rows[0]["user"] == "hi there"
    assert isinstance(rows[0]["assistant"], str)


def test_cli_serve_answers_and_shuts_down(monkeypatch, capsys):
    """``serve`` on port 0 (the stdlib server: uvicorn is not installed
    here) answers ``/healthz``; the server and its scheduler stop."""
    seen = {}

    def serve_once(self):
        t = self.start_background()
        conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=60)
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        seen["healthz"] = (resp.status, json.loads(resp.read()))
        conn.close()
        seen["thread"] = t
        seen["core"] = self.core

    monkeypatch.setattr(basic.BasicServer, "serve_forever", serve_once)
    rc = main(["serve", *ARGS, "--host", "127.0.0.1", "--port", "0"])
    assert rc == 0
    assert seen["healthz"] == (200, {"status": "ok", "model": "gpt2-tiny"})
    seen["thread"].join(timeout=10)
    assert not seen["thread"].is_alive()
    assert seen["core"].scheduler._thread is None
    assert "serving (stdlib) on 127.0.0.1:" in capsys.readouterr().out


def test_cli_serve_coordinator_raises_naming_a7():
    with pytest.raises(NotImplementedError, match="A7"):
        main(["serve", *ARGS, "--coordinator", "localhost:1234"])
