"""The PyTorch port stands alone: it imports no JAX and nothing of the
JAX package, its entry points refuse to fall back to the CPU silently,
and its CLI and kernel sources are in place."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

import pagedattention_based_transformer_decoder_inference_framework_tpu_torch as port
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.cli import cli_app
from pagedattention_based_transformer_decoder_inference_framework_tpu_torch.utils import platform

PORT_DIR = pathlib.Path(port.__file__).parent
REPO = PORT_DIR.parent
JAX_PKG = "pagedattention_based_transformer_decoder_inference_framework_tpu"

MODULES = [
    "config", "utils.common", "utils.platform", "utils.tokenizer",
    "ops.common", "ops.rope", "ops.linear", "ops.attention_ref",
    "ops.kv_append", "ops.paged_attention", "kvcache.allocator",
    "kvcache.pool", "engine.backends", "engine.paged_backend",
    "engine.sampling", "engine.spec", "engine.engine", "models.model",
    "cli.cli_app",
    "quant", "quant.tensor", "quant.eval", "ops.int8_matmul",
    "ops.int4_matmul", "ops.chain_linear", "models.chained", "ops.gmm",
    "utils.logging", "kvcache.swap", "kvcache.native", "kvcache.snapshot",
    "scheduler", "scheduler.scheduler", "engine.beam", "reranker",
    "reranker.api", "reranker.export_jsonl", "reranker.plot_tree",
    "server", "server.metrics", "server.schema", "server.core",
    "server.basic", "server.app", "engine.router", "models.checkpoint",
    "utils.profiling", "utils.debug", "models.hf_stream", "models.hf_import",
]
#: packages the card's machine does not have
ABSENT_ON_THE_CARD = ("pydantic", "fastapi", "uvicorn", "ml_dtypes",
                      "safetensors")


def test_port_imports_without_jax():
    mods = ", ".join(f"{port.__name__}.{m}" for m in MODULES)
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        f"sys.modules['{JAX_PKG}'] = None\n"
        "import importlib\n"
        f"for m in '{mods}'.split(', '):\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') or "
        f"k.startswith('{JAX_PKG}.') for k in sys.modules "
        "if sys.modules[k] is not None)\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_frontends_import_without_optional_packages(tmp_path):
    """As on the card's machine: with pydantic, fastapi, uvicorn,
    ml_dtypes and safetensors (and JAX) blocked, the server, router,
    checkpoint, HF import and CLI modules import, the schema validates, a
    bf16 checkpoint round-trips bit for bit and the port's reader reads a
    bf16 safetensors file that ``chip_smoke.py``'s writer wrote."""
    blocked = ("jax", JAX_PKG) + ABSENT_ON_THE_CARD
    code = (
        "import sys\n"
        f"for m in {blocked!r}:\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        f"from {port.__name__}.server import BasicServer, ServerCore\n"
        f"from {port.__name__}.server import schema\n"
        f"from {port.__name__}.engine.router import build_engine\n"
        f"from {port.__name__}.models import checkpoint\n"
        f"from {port.__name__}.cli import cli_app\n"
        f"from {port.__name__}.models import hf_import, hf_stream\n"
        "import chip_smoke\n"
        "req = schema.GenerateRequest(prompt='x', logit_bias={'5': 2})\n"
        "assert req.logit_bias == {5: 2.0}\n"
        "try:\n"
        "    schema.GenerateRequest(prompt='x', max_new_tokens=0)\n"
        "    raise SystemExit('accepted')\n"
        "except schema.ValidationError:\n"
        "    pass\n"
        "w = torch.randn(4, 6).to(torch.bfloat16)\n"
        f"checkpoint.save_params({{'w': w}}, {str(tmp_path / 'w.npz')!r})\n"
        f"back = checkpoint.load_params({str(tmp_path / 'w.npz')!r})['w']\n"
        "assert back.dtype == torch.bfloat16 and torch.equal(back, w)\n"
        f"chip_smoke.write_safetensors({str(tmp_path / 'model.safetensors')!r}, "
        "{'w': w})\n"
        f"r = hf_stream.ShardReader({str(tmp_path)!r})\n"
        "assert torch.equal(r.get_tensor('w'), w)\n"
        "assert (r.get('w') == w.float().numpy()).all()\n"
        "assert not any(k.split('.')[0] in "
        f"{blocked!r} for k in sys.modules if sys.modules[k] is not None)\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_no_source_mentions_the_jax_package():
    for path in list(PORT_DIR.rglob("*.py")) + [
            REPO / n for n in ("chip_smoke.py", "scheduler_probe.py",
                               "hf_import_probe.py")]:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", JAX_PKG), (path, name)
        assert f"{JAX_PKG}." not in path.read_text(), path


def test_every_kernel_is_registered_with_its_source():
    import pagedattention_based_transformer_decoder_inference_framework_tpu_torch.ops.chain_linear  # noqa: F401
    import pagedattention_based_transformer_decoder_inference_framework_tpu_torch.ops.gmm  # noqa: F401
    import pagedattention_based_transformer_decoder_inference_framework_tpu_torch.ops.int4_matmul  # noqa: F401
    import pagedattention_based_transformer_decoder_inference_framework_tpu_torch.ops.int8_matmul  # noqa: F401
    import pagedattention_based_transformer_decoder_inference_framework_tpu_torch.ops.kv_append  # noqa: F401
    import pagedattention_based_transformer_decoder_inference_framework_tpu_torch.ops.paged_attention  # noqa: F401

    assert sorted(platform.KERNELS) == [
        "chain_decode", "grouped_matmul", "int8_matmul", "kv_append_decode",
        "kv_append_prefill", "kv_append_tokens", "packed_linear",
        "paged_attention", "paged_attention_decode",
        "paged_attention_decode_append", "paged_attention_decode_batched",
        "paged_attention_decode_grouped", "paged_attention_decode_packed",
        "paged_attention_wgmma", "w4_matmul", "w8_matmul"]
    headers = "".join(p.read_text() for p in platform.CSRC.glob("*.cuh"))
    for k in platform.KERNELS.values():
        src = (platform.CSRC / k.source).read_text()
        assert f"extern \"C\" int {k.symbol}(" in src
        assert "cudaGetLastError" in src + headers


def test_a_header_edit_rebuilds_every_source(tmp_path, monkeypatch):
    """The library name digests the shared headers too."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include "h.cuh"')
    (csrc / "h.cuh").write_text("// one")
    monkeypatch.setattr(platform, "CSRC", csrc)
    before = platform.library_path("a.cu")
    (csrc / "h.cuh").write_text("// two")
    assert platform.library_path("a.cu") != before


def test_device_resolution(monkeypatch):
    assert platform.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        platform.resolve_device(None)


def test_cli_generate_and_stream_on_cpu(capsys):
    for cmd in ("generate", "stream"):
        rc = cli_app.main([cmd, "--model", "llama-tiny", "--prompt", "hi",
                           "--max-new-tokens", "4", "--temperature", "0",
                           "--device", "cpu"])
        assert rc == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and out[0] == out[1]


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Run alone, or on a host without CUDA, it prints no ok line."""
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    runs = [(tmp_path, tmp_path / "chip_smoke.py")]
    if not torch.cuda.is_available():
        runs.append((REPO, REPO / "chip_smoke.py"))
    for cwd, script in runs:
        r = subprocess.run([sys.executable, str(script)], cwd=cwd,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0 and '"ok"' not in r.stdout
