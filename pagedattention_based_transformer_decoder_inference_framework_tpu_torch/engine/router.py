"""Backend routing and the engine factory (the JAX package's
``engine/router.py``, on one device).

``server.backend`` names where the engine runs: ``"cpu"`` the kernels'
plain PyTorch versions on the CPU; ``"tpu"`` and ``"auto"`` the card
(``cuda``), which must be present: the port never drops to the CPU
quietly, where the JAX router's ``"auto"`` does.
"""

from __future__ import annotations

import os

import torch

from ..config import FrameworkConfig


def resolve_backend(mode: str) -> torch.device:
    """The device of ``server.backend`` ``mode``; raises for the card
    when there is none."""
    if mode not in ("auto", "tpu", "cpu"):
        raise ValueError(f"unknown backend {mode!r}")
    if mode == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"backend {mode!r} runs on the card and no CUDA device is "
            "available; set server.backend='cpu' (or pass device='cpu') to "
            "run the plain PyTorch versions of the kernels")
    return torch.device("cuda")


def build_engine(config: FrameworkConfig, params=None, device=None,
                 seed: int = 0):
    """Engine factory honouring ``config.server.backend`` (an explicit
    ``device`` wins over it) and ``config.weights_path``: an HF checkpoint
    directory, stream-imported in place (``models/hf_stream.py``; INT8 at
    import when ``config.model.quant`` is ``int8`` or ``int8-weight``, and
    ``config.model`` should be :func:`~..models.hf_stream.config_from_hf`
    of it), or a native ``.npz`` checkpoint (``models/checkpoint.py``,
    either package's), either loaded onto the engine's device. Data,
    tensor and sequence parallelism are not ported yet and raise."""
    from .engine import Engine

    p = config.parallel
    if p.dp != 1 or p.tp != 1 or p.sp != 1:
        raise NotImplementedError(
            f"parallel dp={p.dp} tp={p.tp} sp={p.sp}: the port runs on one "
            "device; meshes wait for the parallelism port (ROADMAP A7)")
    dev = (torch.device(device) if device is not None
           else resolve_backend(config.server.backend))
    if params is None and config.weights_path:
        if os.path.isdir(config.weights_path):
            from ..models.hf_stream import (import_hf_streaming,
                                            load_flat_params)

            q = (config.model.quant
                 if config.model.quant in ("int8", "int8-weight") else None)
            params = load_flat_params(
                import_hf_streaming(config.weights_path, config.model,
                                    quant=q), device=dev)
        else:
            from ..models.checkpoint import load_params

            params = load_params(config.weights_path, device=dev)
    return Engine(config, params=params, device=dev, seed=seed)
