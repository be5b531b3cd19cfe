"""HF checkpoint import in the PyTorch port against the JAX package's.

Tiny HF models of nine families are built in code from a seed (no hub
download) and saved with ``save_pretrained``: Llama, GPT-2, Gemma-2,
Gemma-3, Phi-3 (pre-fused projections, a window), Phi-3 with
``longrope``, Qwen2 (random q/k/v biases), Mistral (a window) and
Mixtral. On each: ``config_from_hf`` equals the JAX one field for
field; ``import_hf_streaming``'s flat dict equals the JAX one key for
key and bit for bit (bf16 as bits, INT8 codes and f32 scales) for quant
``none``, ``int8`` and ``int8-weight``; the state-dict converters equal
theirs; an engine that ``router.build_engine`` builds on the directory
gives the greedy streams of the JAX engine built the same way, f32
prefill logits within 1e-5, and the HF forward's within the JAX tests'
``atol=5e-3, rtol=5e-2``. The port's safetensors reader and the chip
smoke's writer are held against ``safetensors.safe_open``; the CLI's
``--model <dir>`` and ``quant/eval --weights`` run end to end.
"""

import argparse
import dataclasses
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax

from pagedattention_based_transformer_decoder_inference_framework_tpu import config as jconfig
from pagedattention_based_transformer_decoder_inference_framework_tpu.engine import (
    SamplingParams as JaxSampling)
from pagedattention_based_transformer_decoder_inference_framework_tpu.engine import (
    router as jrouter)
from pagedattention_based_transformer_decoder_inference_framework_tpu.models import (
    hf_import as jimport, hf_stream as jstream)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch import config as tconfig
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.cli import cli_app
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.engine import (
    SamplingParams, router)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.models import (
    checkpoint as tckpt, hf_import as timport, hf_stream as tstream)
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.quant import eval as teval
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.quant.tensor import (
    QTensor)

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

transformers = pytest.importorskip("transformers")

SHORT = [1.0 + 0.1 * i for i in range(8)]     # longrope: head_dim/2 = 8
LONG = [2.0 + 0.3 * i for i in range(8)]


def _llama():
    return transformers.LlamaForCausalLM(transformers.LlamaConfig(
        hidden_size=64, intermediate_size=128, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=2, vocab_size=257,
        max_position_embeddings=96, rms_norm_eps=1e-5, rope_theta=10000.0,
        attention_bias=False, tie_word_embeddings=False))


def _gpt2():
    return transformers.GPT2LMHeadModel(transformers.GPT2Config(
        n_layer=2, n_head=4, n_embd=64, vocab_size=256, n_positions=96,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0))


def _gemma2():
    return transformers.Gemma2ForCausalLM(transformers.Gemma2Config(
        vocab_size=257, hidden_size=64, intermediate_size=128,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, max_position_embeddings=96, rms_norm_eps=1e-6,
        rope_theta=10000.0, attention_bias=False, tie_word_embeddings=True,
        query_pre_attn_scalar=32, sliding_window=8,
        attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
        hidden_activation="gelu_pytorch_tanh", attn_implementation="eager"))


def _gemma3():
    return transformers.Gemma3ForCausalLM(transformers.Gemma3TextConfig(
        vocab_size=257, hidden_size=64, intermediate_size=128,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, max_position_embeddings=96, rms_norm_eps=1e-6,
        rope_theta=100000.0, rope_local_base_freq=10000.0,
        attention_bias=False, tie_word_embeddings=True,
        query_pre_attn_scalar=32, sliding_window=8,
        sliding_window_pattern=2, hidden_activation="gelu_pytorch_tanh",
        attn_implementation="eager"))


def _phi3(**kw):
    args = dict(vocab_size=257, hidden_size=64, intermediate_size=128,
                num_hidden_layers=3, num_attention_heads=4,
                num_key_value_heads=4, max_position_embeddings=96,
                rms_norm_eps=1e-5, rope_theta=10000.0, sliding_window=8,
                tie_word_embeddings=False, attn_implementation="eager",
                pad_token_id=0)
    args.update(kw)
    return transformers.Phi3ForCausalLM(transformers.Phi3Config(**args))


def _phi3_longrope():
    return _phi3(sliding_window=None, original_max_position_embeddings=16,
                 rope_scaling={"type": "longrope", "short_factor": SHORT,
                               "long_factor": LONG})


def _qwen2():
    m = transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
        vocab_size=257, hidden_size=64, intermediate_size=128,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=96, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=False, attn_implementation="eager",
        use_sliding_window=False, pad_token_id=0))
    with torch.no_grad():          # HF zero-inits biases: make them count
        for layer in m.model.layers:
            for proj in (layer.self_attn.q_proj, layer.self_attn.k_proj,
                         layer.self_attn.v_proj):
                proj.bias.normal_(0.0, 0.5)
    return m


def _mistral():
    return transformers.MistralForCausalLM(transformers.MistralConfig(
        vocab_size=257, hidden_size=64, intermediate_size=128,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=96, rms_norm_eps=1e-5, rope_theta=10000.0,
        sliding_window=8, tie_word_embeddings=False,
        attn_implementation="eager", pad_token_id=0))


def _mixtral():
    return transformers.MixtralForCausalLM(transformers.MixtralConfig(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, vocab_size=256,
        num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=96, sliding_window=None))


FAMILIES = {"llama": _llama, "gpt2": _gpt2, "gemma2": _gemma2,
            "gemma3": _gemma3, "phi3": _phi3, "phi3-longrope": _phi3_longrope,
            "qwen2": _qwen2, "mistral": _mistral, "mixtral": _mixtral}
#: each family's state-dict converter (Mixtral has none in either package)
CONVERTERS = {"llama": "llama", "gpt2": "gpt2", "gemma2": "gemma2",
              "gemma3": "gemma3", "phi3": "phi3", "phi3-longrope": "phi3",
              "qwen2": "llama", "mistral": "llama"}


@pytest.fixture(scope="module")
def hf(tmp_path_factory):
    """Each family's HF model (eval mode) and its saved directory; the
    Llama one also sharded (``model.safetensors.index.json``)."""
    root = tmp_path_factory.mktemp("hf")
    out = {}
    for seed, (name, make) in enumerate(FAMILIES.items()):
        torch.manual_seed(seed)
        model = make().eval()
        model.save_pretrained(root / name, safe_serialization=True)
        out[name] = (model, str(root / name))
    out["llama"][0].save_pretrained(root / "llama-sharded",
                                    safe_serialization=True,
                                    max_shard_size="100KB")
    return out


def _bits(x):
    """A flat dict's leaf as comparable numpy bits (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


@pytest.mark.parametrize("family", list(FAMILIES))
def test_config_from_hf_matches_jax(hf, family):
    path = hf[family][1]
    got = tstream.config_from_hf(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jstream.config_from_hf(path))
    if family == "phi3-longrope":
        assert got.rope_scaling["original_max_position_embeddings"] == 16
    if family == "gemma3":
        assert got.rope_local_theta == 10000.0 and got.qk_norm


@pytest.mark.parametrize("quant", ["none", "int8", "int8-weight"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_streamed_import_matches_jax_bit_for_bit(hf, family, quant):
    path = hf[family][1]
    q = None if quant == "none" else quant
    jflat = jstream.import_hf_streaming(path, jstream.config_from_hf(path),
                                        quant=q)
    tflat = tstream.import_hf_streaming(path, tstream.config_from_hf(path),
                                        quant=q)
    assert list(tflat) == list(jflat)
    for k in jflat:
        a, b = _bits(jflat[k]), _bits(tflat[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    if q:
        assert tflat["layers/wq.qvalues"].dtype == torch.int8


def test_sharded_directory_equals_single_file(hf, tmp_path):
    single, sharded = hf["llama"][1], hf["llama"][1] + "-sharded"
    assert (pathlib.Path(sharded) / "model.safetensors.index.json").exists()
    cfg = tstream.config_from_hf(single)
    for q in (None, "int8"):
        a = tstream.import_hf_streaming(single, cfg, quant=q)
        b = tstream.import_hf_streaming(sharded, cfg, quant=q)
        assert list(a) == list(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    # the offline command writes the same dict as a native checkpoint
    out = str(tmp_path / "llama-int8.npz")
    tstream.main(["--hf-dir", sharded, "--output", out, "--quant", "int8"])
    back = tckpt.load_flat(out)
    assert set(back) == set(a)
    for k in a:
        assert torch.equal(back[k], a[k]), k


@pytest.mark.parametrize("family", list(CONVERTERS))
def test_converters_match_jax(hf, family):
    model, path = hf[family]
    sd = model.state_dict()
    name = CONVERTERS[family]
    jcfg, tcfg = jstream.config_from_hf(path), tstream.config_from_hf(path)
    jp = getattr(jimport, f"params_from_hf_{name}")(sd, jcfg)
    tp = getattr(timport, f"params_from_hf_{name}")(sd, tcfg)
    jflat = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    assert len(jflat) == len(jax.tree_util.tree_leaves(tp))
    for kpath, leaf in jflat.items():
        t = tp
        for k in kpath:
            t = t[k.key]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == leaf.shape
        np.testing.assert_array_equal(_bits(t), _bits(np.asarray(leaf)),
                                      err_msg=str(kpath))


def test_reader_matches_safe_open(tmp_path):
    from safetensors import safe_open
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    tensors = {
        "bf16": torch.randn(5, 7, generator=g).to(torch.bfloat16),
        "f16": torch.randn(3, 4, 2, generator=g).to(torch.float16),
        "f32": torch.randn(6, generator=g),
        "i8": torch.randint(-128, 128, (4, 9), generator=g,
                            dtype=torch.int8),
        "i32": torch.randint(-2 ** 31, 2 ** 31 - 1, (3, 3), generator=g,
                             dtype=torch.int32),
        "i64": torch.tensor([-2 ** 62, 3, 2 ** 40 + 1]),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros(0, 4),
    }
    save_file(tensors, str(tmp_path / "model.safetensors"))
    r = tstream.ShardReader(str(tmp_path))
    assert sorted(r.keys()) == sorted(tensors)
    with safe_open(str(tmp_path / "model.safetensors"), framework="pt") as f:
        for name in tensors:
            ref = f.get_tensor(name)
            got = r.get_tensor(name)
            assert got.dtype == ref.dtype and got.shape == ref.shape, name
            assert torch.equal(got, ref), name
            if ref.is_floating_point():
                np.testing.assert_array_equal(r.get(name),
                                              ref.float().numpy())
    with pytest.raises(FileNotFoundError):
        tstream.ShardReader(str(tmp_path / "nowhere"))


def test_smoke_writer_matches_safe_open(tmp_path):
    """``chip_smoke.py``'s writer: one file read back by ``safe_open``,
    and a sharded directory read back by the port's reader."""
    from safetensors import safe_open

    g = torch.Generator().manual_seed(1)
    tensors = {f"t{i}": torch.randn(16, 8 + i, generator=g).to(dt)
               for i, dt in enumerate((torch.bfloat16, torch.float32,
                                       torch.float16, torch.bfloat16))}
    tensors["codes"] = torch.randint(-127, 128, (5, 3), generator=g,
                                     dtype=torch.int8)
    chip_smoke.write_safetensors(str(tmp_path / "one.safetensors"), tensors)
    with safe_open(str(tmp_path / "one.safetensors"), framework="pt") as f:
        assert sorted(f.keys()) == sorted(tensors)
        for name, t in tensors.items():
            assert torch.equal(f.get_tensor(name), t), name
    d = tmp_path / "sharded"
    d.mkdir()
    n = chip_smoke.write_hf_checkpoint(str(d), tensors, {"model_type": "x"},
                                       shard_bytes=600)
    assert n >= 2 and (d / "model.safetensors.index.json").exists()
    assert json.loads((d / "config.json").read_text()) == {
        "model_type": "x"}
    r = tstream.ShardReader(str(d))
    for name, t in tensors.items():
        assert torch.equal(r.get_tensor(name), t), name


def test_smoke_gemma3_directory_gives_the_preset(tmp_path):
    """The HF ``config.json`` the chip smoke writes for a preset derives
    that preset back in both packages, but for its name and EOS id (the
    derivation leaves ``eos_token_id`` at the config default)."""
    pre = tconfig.preset("gemma3-1b")
    (tmp_path / "config.json").write_text(json.dumps(
        chip_smoke.hf_config(pre)))
    for mod in (tstream, jstream):
        got = dataclasses.asdict(mod.config_from_hf(str(tmp_path)))
        want = dataclasses.asdict(pre)
        assert {k for k in want if got[k] != want[k]} == {
            "name", "eos_token_id"}


# -- engines built on the directory ------------------------------------------

PROMPTS = [[(7 * i + 3) % 250 for i in range(19)],
           [(5 * i + 1) % 250 for i in range(17)]]
NEW = 5


def engines_on(path, quant="none", kv_dtype="float32"):
    """The JAX engine (interpret mode) and the port's on the CPU, both
    from ``build_engine`` with ``weights_path`` the HF directory and the
    model ``config_from_hf`` of it at f32 activations."""
    out = []
    for mod, stream, build, kw in (
            (jconfig, jstream, jrouter.build_engine, {}),
            (tconfig, tstream, router.build_engine, {"device": "cpu"})):
        m = stream.config_from_hf(path)
        m.dtype, m.quant = "float32", quant
        fw = mod.FrameworkConfig(
            model=m,
            cache=mod.CacheConfig(page_size=8, num_pages=48,
                                  max_pages_per_seq=6, kv_dtype=kv_dtype),
            runtime=mod.RuntimeConfig(prefill_chunk=16),
            weights_path=path)
        fw.server.backend = "cpu"
        out.append(build(fw, **kw))
    return out


def streams_and_logits(je, te):
    js = JaxSampling(temperature=0.0, eos_token_id=-1)
    ts = SamplingParams(temperature=0.0, eos_token_id=-1)
    jt = je.generate_batch_fused(PROMPTS, NEW, js)
    tt = te.generate_batch_fused(PROMPTS, NEW, ts)
    jst, tst = je.prefill(PROMPTS, sampling=js), te.prefill(PROMPTS,
                                                            sampling=ts)
    jl, tl = np.asarray(jst.prefill_logits), tst.prefill_logits
    je.free(jst)
    te.free(tst)
    return jt, tt, jl, tl


@pytest.mark.parametrize("family", list(FAMILIES))
def test_engine_from_directory_matches_jax_and_hf(hf, family):
    model, path = hf[family]
    je, te = engines_on(path)
    jt, tt, jl, tl = streams_and_logits(je, te)
    assert tt == jt
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=1e-5)
    # the HF forward over each whole prompt, at its last position
    with torch.no_grad():
        ref = np.stack([model(torch.tensor([p])).logits[0, -1].numpy()
                        for p in PROMPTS])
    np.testing.assert_allclose(tl[:, :ref.shape[1]], ref, atol=5e-3,
                               rtol=5e-2)
    # the engine took the per-projection import and fused it
    assert "w_qkv" in te.params["layers"][0]


@pytest.mark.parametrize("family,quant", [
    ("gemma3", "int8"), ("llama", "int8-weight"), ("qwen2", "int8")])
def test_quantized_engine_from_directory_matches_jax(hf, family, quant):
    """INT8 at import (``quant`` from the config), INT8 KV: the port's
    engine fuses the imported codes and scales without quantizing them
    again, and its streams are the JAX engine's."""
    path = hf[family][1]
    je, te = engines_on(path, quant, kv_dtype="int8")
    jt, tt, jl, tl = streams_and_logits(je, te)
    assert tt == jt
    np.testing.assert_allclose(tl, jl, atol=5e-3, rtol=5e-2)
    flat = tstream.import_hf_streaming(path, te.cfg, quant=quant)
    wqkv = te.params["layers"][1]["w_qkv"]
    assert isinstance(wqkv, QTensor)
    nq = te.cfg.num_heads * te.cfg.head_dim
    assert torch.equal(wqkv.values[:, :nq], flat["layers/wq.qvalues"][1])
    assert torch.equal(wqkv.scales.reshape(-1)[:nq],
                       flat["layers/wq.qscales"][1].reshape(-1))


# -- entry points --------------------------------------------------------------

def test_cli_generate_from_a_directory(hf, capsys):
    path = hf["llama"][1]
    cfg = cli_app.build_config(argparse.Namespace(
        config=None, model=path, tokenizer=None))
    assert cfg.weights_path == path and cfg.tokenizer == path
    assert dataclasses.asdict(cfg.model) == dataclasses.asdict(
        tstream.config_from_hf(path))
    rc = cli_app.main(["generate", "--model", path, "--tokenizer", "byte",
                       "--prompt", "hi", "--max-new-tokens", "4",
                       "--temperature", "0", "--device", "cpu"])
    assert rc == 0
    cfg.tokenizer = "byte"
    eng = router.build_engine(cfg, device="cpu")
    want = eng.generate(list(b"hi"), 4, SamplingParams(
        temperature=0.0, eos_token_id=-1))
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == bytes(t for t in want if t < 256).decode(
        "utf-8", errors="replace")


def test_quant_eval_reads_weights(hf, tmp_path, capsys, monkeypatch):
    """``quant/eval --weights``: a native checkpoint that the offline
    importer wrote, evaluated through the dense oracle, equals
    ``ppl_delta_report`` on the same file's params; a random init gives
    another report."""
    path = hf["llama"][1]
    out = str(tmp_path / "llama.npz")
    cfg = tstream.config_from_hf(path)
    tstream.import_hf_streaming(path, cfg, out_path=out)
    rng = np.random.default_rng(0)
    seqs = rng.integers(0, cfg.vocab_size, (2, 12)).tolist()
    (tmp_path / "toks.jsonl").write_text(
        "".join(json.dumps({"tokens": s}) + "\n" for s in seqs))
    argv = ["--model", "llama-tiny", "--tokens-file",
            str(tmp_path / "toks.jsonl"), "--device", "cpu"]
    # the command takes a preset: one with the checkpoint's geometry
    model = dataclasses.replace(cfg, name="llama-tiny", dtype="float32")
    monkeypatch.setitem(tconfig.PRESETS, "llama-tiny", model)
    teval.main(argv + ["--weights", out])
    got = json.loads(capsys.readouterr().out)
    teval.main(argv)
    rand = json.loads(capsys.readouterr().out)
    want = teval.ppl_delta_report(model, tckpt.load_params(out), seqs)
    assert got == pytest.approx(want, rel=1e-6)
    assert got["fp"] != pytest.approx(rand["fp"], rel=1e-3)
