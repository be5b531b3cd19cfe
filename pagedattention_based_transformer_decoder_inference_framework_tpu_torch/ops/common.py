"""Shared numeric building blocks: normalization, activations, softmax.

Plain PyTorch, computed in f32 and cast back to the input dtype, as in
the JAX package's ``ops/common.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Classic LayerNorm with learned gamma/beta, computed in f32."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5,
            offset: float = 0.0) -> torch.Tensor:
    """RMSNorm (Llama family). ``offset=1.0`` gives the Gemma variant
    whose learned scale is stored as ``weight - 1``."""
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return (y * (offset + scale.float())).to(x.dtype)


def activation_fn(name: str):
    if name == "relu":
        return torch.relu
    if name == "gelu":
        # tanh approximation — matches HF GPT-2 "gelu_new"
        return lambda x: F.gelu(x, approximate="tanh")
    if name in ("silu", "swiglu"):
        return F.silu
    raise ValueError(f"unknown activation {name!r}")


def stable_softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Max-subtracted softmax in f32."""
    x32 = x.float()
    e = torch.exp(x32 - x32.amax(dim=dim, keepdim=True))
    return e / e.sum(dim=dim, keepdim=True)
