"""The port's serving frontends (``server/``).

First the port's ``ServerCore`` against the JAX package's on the same
bridged weights (gpt2-tiny, f32, page 8, vocab 512, JAX
``tests/test_server.py``'s config; the JAX engine in interpret mode),
endpoint by endpoint on the same requests, its methods called directly:
greedy ``generate`` and ``generate_batch`` tokens, ``stream_generate``
(newline-JSON and SSE) and ``stream_chat`` frames, ``stream_chat_beam``'s
winner, beam index and ``num_beams``, and the metrics' counts and page
counts. Then the schema: a table of payloads through the JAX package's
pydantic models and the port's dataclasses, which must accept and reject
the same payloads and parse the same values. Then JAX
``tests/test_server.py``'s single-device cases over real HTTP on the
port's ``BasicServer``, and a data-parallel config, which raises.
"""

import dataclasses
import http.client
import json
import threading

import numpy as np
import pytest

import jax

from pagedattention_based_transformer_decoder_inference_framework_tpu import config as jconfig
from pagedattention_based_transformer_decoder_inference_framework_tpu.engine import (
    Engine as JaxEngine)
from pagedattention_based_transformer_decoder_inference_framework_tpu.models.model import (
    init_params as jax_init_params)
from pagedattention_based_transformer_decoder_inference_framework_tpu.server import (
    ServerCore as JaxServerCore)
from pagedattention_based_transformer_decoder_inference_framework_tpu.server import (
    schema as jschema)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch import config as tconfig
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.engine import Engine
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.models import (
    params_from_jax)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.server import (
    BasicServer, ServerCore)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.server import (
    schema as tschema)


def make_cfg(mod):
    cfg = mod.FrameworkConfig(
        model=mod.preset("gpt2-tiny"),
        cache=mod.CacheConfig(page_size=8, num_pages=256, max_pages_per_seq=16,
                              kv_dtype="float32"),
        runtime=mod.RuntimeConfig(max_new_tokens=8, temperature=0.0,
                                  eos_token_id=257, enable_logging=False),
    )
    cfg.model.dtype = "float32"
    cfg.model.vocab_size = 512          # covers byte-tokenizer ids
    return cfg


@pytest.fixture(scope="module")
def cores():
    """The JAX ``ServerCore`` and the port's, each over its own
    scheduler, on the same weights."""
    jcfg, tcfg = make_cfg(jconfig), make_cfg(tconfig)
    jp = jax_init_params(jcfg.model, jax.random.key(0))
    je = JaxEngine(jcfg, params=jp, interpret=True)
    te = Engine(tcfg, params=params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), tcfg.model), device="cpu")
    jcore, tcore = JaxServerCore(jcfg, engine=je), ServerCore(tcfg, engine=te)
    yield jcore, tcore
    jcore.scheduler.stop()
    tcore.close()


def both(cores, method, schema_name, payload, *args):
    """``method`` of both cores on ``payload`` parsed by each package's
    ``schema_name``; streaming results joined into lists of frames."""
    jcore, tcore = cores
    out = []
    for core, schema in ((jcore, jschema), (tcore, tschema)):
        res = getattr(core, method)(getattr(schema, schema_name)(**payload),
                                    *args)
        out.append(res if isinstance(res, dict) else list(res))
    return out


@pytest.mark.parametrize("payload", [
    {"prompt": "hello", "temperature": 0.0, "max_new_tokens": 6},
    {"prompt": "hello", "max_new_tokens": 8, "temperature": 0.0,
     "repetition_penalty": 1.3, "presence_penalty": 0.1, "min_p": 0.05},
    {"prompt": "abc", "temperature": 0.0, "max_new_tokens": 5,
     "logit_bias": {"97": 3.0}, "stop_token_ids": [300]},
], ids=["plain", "penalties", "bias-stop"])
def test_generate_matches_jax(cores, payload):
    j, t = both(cores, "generate", "GenerateRequest", payload)
    assert t == j and 1 <= len(t["tokens"]) <= payload["max_new_tokens"]


def test_generate_batch_matches_jax(cores):
    j, t = both(cores, "generate_batch", "BatchGenerateRequest",
                {"prompts": ["aa", "bb", "cc"], "temperature": 0.0,
                 "max_new_tokens": 4})
    assert t == j and len(t["results"]) == 3


@pytest.mark.parametrize("sse", [False, True], ids=["ndjson", "sse"])
def test_stream_generate_frames_match_jax(cores, sse):
    j, t = both(cores, "stream_generate", "GenerateRequest",
                {"prompt": "xy", "temperature": 0.0, "max_new_tokens": 4},
                sse)
    assert t == j and len(t) >= 2
    if sse:
        assert t[-1] == "event: done\ndata: {}\n\n"
    else:
        assert json.loads(t[-1])["finish_reason"] in ("eos", "length")


def test_stream_chat_frames_match_jax(cores):
    j, t = both(cores, "stream_chat", "StreamChatRequest",
                {"messages": [{"role": "user", "content": "hi there"}],
                 "temperature": 0.0, "max_new_tokens": 3}, False)
    assert t == j
    assert json.loads(t[-1])["token"] is None


@pytest.mark.parametrize("use_rerank", [True, False])
def test_stream_chat_beam_matches_jax(cores, use_rerank):
    j, t = both(cores, "stream_chat_beam", "BeamStreamRequest",
                {"messages": [{"role": "user", "content": "choose"}],
                 "beam_width": 3, "max_new_tokens": 4,
                 "use_rerank": use_rerank}, False)
    jf, tf = ([json.loads(x) for x in f] for f in (j, t))
    assert [f["token"] for f in tf] == [f["token"] for f in jf]
    assert [f.get("beam") for f in tf] == [f.get("beam") for f in jf]
    assert tf[-1]["num_beams"] == jf[-1]["num_beams"] == 3


def test_metrics_match_jax(cores):
    jcore, tcore = cores
    both(cores, "generate", "GenerateRequest",
         {"prompt": "m", "max_new_tokens": 2})
    jm, tm = jcore.get_metrics(), tcore.get_metrics()
    keys = ("requests_total", "requests_failed", "tokens_in", "tokens_out",
            "kv_pages")
    assert {k: tm[k] for k in keys} == {k: jm[k] for k in keys}
    assert tm["kv_pages"]["live"] == 0 and tm["requests_total"] >= 1
    assert set(tm) == set(jm)


# -- the schema against the JAX package's pydantic models ----------------------

MSG = [{"role": "user", "content": "hi"}]

SCHEMA_CASES = [
    ("GenerateRequest", {"prompt": "x"}),                     # defaults
    ("GenerateRequest", {}),                                  # no prompt
    ("GenerateRequest", {"prompt": 5}),                       # not a str
    ("GenerateRequest", {"prompt": "x", "max_new_tokens": 0}),
    ("GenerateRequest", {"prompt": "x", "max_new_tokens": 4096}),
    ("GenerateRequest", {"prompt": "x", "max_new_tokens": 4097}),
    ("GenerateRequest", {"prompt": "x", "max_new_tokens": "7"}),
    ("GenerateRequest", {"prompt": "x", "max_new_tokens": 5.0}),
    ("GenerateRequest", {"prompt": "x", "max_new_tokens": 5.5}),
    ("GenerateRequest", {"prompt": "x", "min_p": 1}),
    ("GenerateRequest", {"prompt": "x", "min_p": 1.01}),
    ("GenerateRequest", {"prompt": "x", "min_p": -0.1}),
    ("GenerateRequest", {"prompt": "x", "repetition_penalty": 0}),
    ("GenerateRequest", {"prompt": "x", "repetition_penalty": 0.5}),
    ("GenerateRequest", {"prompt": "x", "temperature": "0.5",
                         "top_k": True, "top_p": 1}),
    ("GenerateRequest", {"prompt": "x", "temperature": None}),
    ("GenerateRequest", {"prompt": "x", "top_k": "1e3"}),
    ("GenerateRequest", {"prompt": "x", "logit_bias": {"5": 2.0,
                                                       "-1": "1"}}),
    ("GenerateRequest", {"prompt": "x", "logit_bias": {"a": 1}}),
    ("GenerateRequest", {"prompt": "x", "logit_bias": []}),
    ("GenerateRequest", {"prompt": "x", "stop_token_ids": ["1", 2],
                         "seed": "3"}),
    ("GenerateRequest", {"prompt": "x", "stop_token_ids": "12"}),
    ("GenerateRequest", {"prompt": "x", "seed": None, "extra": 1}),
    ("BatchGenerateRequest", {"prompts": ["a", "b"]}),
    ("BatchGenerateRequest", {"prompts": "ab"}),
    ("BatchGenerateRequest", {}),
    ("StreamChatRequest", {"messages": MSG}),
    ("StreamChatRequest", {"messages": [{"content": "a", "role": "x",
                                         "extra": 1}]}),
    ("StreamChatRequest", {"messages": [{"role": "user"}]}),
    ("StreamChatRequest", {"messages": [{"content": 3}]}),
    ("StreamChatRequest", {}),
    ("BeamStreamRequest", {"messages": MSG}),
    ("BeamStreamRequest", {"messages": MSG, "beam_width": 0}),
    ("BeamStreamRequest", {"messages": MSG, "beam_width": 16}),
    ("BeamStreamRequest", {"messages": MSG, "beam_width": 17}),
    ("BeamStreamRequest", {"messages": MSG, "use_rerank": "off"}),
    ("BeamStreamRequest", {"messages": MSG, "use_rerank": 0}),
    ("BeamStreamRequest", {"messages": MSG, "use_rerank": 2}),
    ("BeamStreamRequest", {"messages": MSG, "use_rerank": None}),
    ("BeamStreamRequest", {"messages": MSG, "max_new_tokens": -5}),
]


def parse(schema, name, payload):
    try:
        req = getattr(schema, name)(**payload)
    except Exception as e:
        return ("rejected", type(e).__name__)
    dump = (req.model_dump() if schema is jschema
            else dataclasses.asdict(req))
    return ("accepted", dump)


@pytest.mark.parametrize("name,payload", SCHEMA_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(SCHEMA_CASES)])
def test_schema_matches_pydantic(name, payload):
    j, t = parse(jschema, name, payload), parse(tschema, name, payload)
    assert t[0] == j[0], (j, t)
    if t[0] == "accepted":
        assert t[1] == j[1]
        assert all(type(t[1][k]) is type(j[1][k]) for k in j[1])
    else:
        assert t[1] == "ValidationError"


def test_chat_message_model_dump():
    m = tschema.ChatMessage(content="hi")
    assert m.model_dump() == {"role": "user", "content": "hi"}


# -- JAX tests/test_server.py over HTTP on the port's BasicServer --------------

@pytest.fixture(scope="module")
def server():
    cfg = make_cfg(tconfig)
    engine = Engine(cfg, device="cpu")
    srv = BasicServer(cfg, engine=engine, host="127.0.0.1", port=0)
    srv.start_background()
    yield srv
    srv.shutdown()


def _request(server, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=120)
    payload = json.dumps(body) if body is not None else None
    conn.request(method, path, body=payload,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def test_healthz(server):
    code, data = _request(server, "GET", "/healthz")
    assert code == 200 and json.loads(data) == {"status": "ok",
                                                "model": "gpt2-tiny"}


def test_unknown_path_is_404(server):
    assert _request(server, "GET", "/nope")[0] == 404
    assert _request(server, "POST", "/nope", {})[0] == 404


def test_generate(server):
    code, data = _request(server, "POST", "/generate",
                          {"prompt": "hello", "temperature": 0.0,
                           "max_new_tokens": 6})
    assert code == 200
    body = json.loads(data)
    assert isinstance(body["text"], str)
    assert 1 <= len(body["tokens"]) <= 6
    assert body["finish_reason"] in ("length", "eos")


def test_generate_deterministic_greedy(server):
    req = {"prompt": "abc", "temperature": 0.0, "max_new_tokens": 5}
    a = json.loads(_request(server, "POST", "/generate", req)[1])
    b = json.loads(_request(server, "POST", "/generate", req)[1])
    assert a["tokens"] == b["tokens"]


def test_validation_error_is_422(server):
    code, _ = _request(server, "POST", "/generate",
                       {"prompt": "x", "max_new_tokens": -5})
    assert code == 422
    assert _request(server, "POST", "/stream_chat_beam",
                    {"messages": [{"role": "user"}]})[0] == 422


def test_stream_generate_ndjson_framing(server):
    code, data = _request(server, "POST", "/stream_generate",
                          {"prompt": "xy", "temperature": 0.0,
                           "max_new_tokens": 4})
    assert code == 200
    lines = [json.loads(l) for l in data.decode().splitlines() if l]
    assert lines[-1]["token"] is None
    assert lines[-1]["finish_reason"] in ("eos", "length")
    toks = [l["token"] for l in lines[:-1]]
    assert all(isinstance(t, int) for t in toks) and 1 <= len(toks) <= 4


def test_stream_generate_sse_framing(server):
    code, data = _request(server, "POST", "/stream_generate?sse=1",
                          {"prompt": "xy", "temperature": 0.0,
                           "max_new_tokens": 3})
    raw = data.decode()
    assert raw.count("data: ") >= 2
    assert raw.endswith("event: done\ndata: {}\n\n")


def test_stream_chat(server):
    code, data = _request(server, "POST", "/stream_chat",
                          {"messages": [{"role": "user",
                                         "content": "hi there"}],
                           "temperature": 0.0, "max_new_tokens": 3})
    lines = [json.loads(l) for l in data.decode().splitlines() if l]
    assert code == 200 and lines[-1]["token"] is None


def test_generate_batch(server):
    code, data = _request(server, "POST", "/generate_batch",
                          {"prompts": ["aa", "bb", "cc"],
                           "temperature": 0.0, "max_new_tokens": 4})
    res = json.loads(data)["results"]
    assert code == 200 and len(res) == 3
    assert all(1 <= len(x["tokens"]) <= 4 for x in res)


def test_stream_chat_beam(server):
    code, data = _request(server, "POST", "/stream_chat_beam",
                          {"messages": [{"role": "user",
                                         "content": "choose"}],
                           "beam_width": 2, "max_new_tokens": 4,
                           "use_rerank": True})
    lines = [json.loads(l) for l in data.decode().splitlines() if l]
    assert code == 200 and lines[-1]["token"] is None
    assert lines[-1]["num_beams"] == 2
    assert all("beam" in l for l in lines[:-1])


def test_metrics(server):
    _request(server, "POST", "/generate",
             {"prompt": "m", "max_new_tokens": 2})
    m = json.loads(_request(server, "GET", "/metrics")[1])
    assert m["requests_total"] >= 1
    assert m["tokens_out"] >= 1
    assert "kv_pages" in m and m["kv_pages"]["live"] == 0


def test_generate_accepts_penalty_and_stop_fields(server):
    """The sampling knobs flow HTTP -> schema -> SamplingParams -> the
    scheduler's bursts, and a stop_token_ids hit ends the generation at
    the first occurrence of that id."""
    body = {"prompt": "hello", "max_new_tokens": 8, "temperature": 0.0,
            "repetition_penalty": 1.3, "presence_penalty": 0.1,
            "min_p": 0.05}
    code, data = _request(server, "POST", "/generate", body)
    assert code == 200 and len(json.loads(data)["tokens"]) >= 1
    code, data = _request(server, "POST", "/generate",
                          {"prompt": "hello", "max_new_tokens": 8,
                           "temperature": 0.0})
    plain = json.loads(data)["tokens"]
    assert len(plain) >= 2
    code, data = _request(server, "POST", "/generate",
                          {"prompt": "hello", "max_new_tokens": 8,
                           "temperature": 0.0,
                           "stop_token_ids": [plain[1]]})
    assert code == 200
    cut = plain.index(plain[1]) + 1
    assert json.loads(data)["tokens"] == plain[:cut]


def test_concurrent_beam_beside_streams(server):
    """A beam request on its handler thread beside streaming requests on
    the scheduler's pump: every answer equals the same request alone."""
    beam = {"messages": [{"role": "user", "content": "pick"}],
            "beam_width": 2, "max_new_tokens": 4}
    gens = [{"prompt": p, "temperature": 0.0, "max_new_tokens": 6}
            for p in ("one", "two", "three")]
    alone = ([_request(server, "POST", "/stream_chat_beam", beam)[1]]
             + [_request(server, "POST", "/generate", g)[1] for g in gens])
    got = [None] * 4

    def post(i):
        path, body = (("/stream_chat_beam", beam) if i == 0
                      else ("/generate", gens[i - 1]))
        got[i] = _request(server, "POST", path, body)[1]

    threads = [threading.Thread(target=post, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert got == alone


def test_dp2_config_raises_naming_a7():
    """The JAX package's dp=2 server has no counterpart: a parallel
    config raises, naming the parallelism port."""
    cfg = make_cfg(tconfig)
    cfg.parallel = tconfig.ParallelConfig(dp=2, tp=1)
    with pytest.raises(NotImplementedError, match="A7"):
        BasicServer(cfg, host="127.0.0.1", port=0)
