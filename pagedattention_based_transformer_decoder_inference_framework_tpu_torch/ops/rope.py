"""Rotary position embeddings (HF-Llama "rotate_half" convention).

A precomputed f32 cos/sin table gathered by absolute position. As in the
JAX package, a position of -1 (prefill padding) indexes the table's last
row; the rows it produces are never attended.
"""

from __future__ import annotations

import math

import torch


def rope_table(max_seq_len: int, head_dim: int, theta: float = 10000.0,
               scaling=None, device=None):
    """Return ``(cos, sin)``, each ``[max_seq_len, head_dim//2]`` f32.

    ``scaling``: optional HF-style ``rope_scaling`` dict with
    ``rope_type`` ``"linear"`` (divide every frequency by ``factor``) or
    ``"llama3"`` (Llama-3.1+ wavelength bands: long wavelengths divided
    by ``factor``, short kept, smooth interpolation between the
    ``low_freq_factor``/``high_freq_factor`` bands of
    ``original_max_position_embeddings``) or ``"longrope"`` (Phi-3:
    per-dimension ``short_factor`` / ``long_factor`` frequency divisors
    and a ``sqrt(1 + log(ratio) / log(original))`` scale on cos and sin).
    The long/short choice is static, made here on the table's length:
    long iff ``max_seq_len`` exceeds ``original_max_position_embeddings``
    (HF instead switches on every call on the running sequence length).
    """
    half = head_dim // 2
    mscale = 1.0
    inv_freq = 1.0 / (theta ** (
        torch.arange(0, half, dtype=torch.float32, device=device) / half))
    if scaling:
        kind = scaling.get("rope_type", scaling.get("type", "default"))
        if kind == "linear":
            inv_freq = inv_freq / float(scaling["factor"])
        elif kind == "llama3":
            factor = float(scaling["factor"])
            low = float(scaling["low_freq_factor"])
            high = float(scaling["high_freq_factor"])
            old_len = float(scaling["original_max_position_embeddings"])
            wavelen = 2.0 * math.pi / inv_freq
            scaled = torch.where(wavelen > old_len / low,
                                 inv_freq / factor, inv_freq)
            smooth = (old_len / wavelen - low) / (high - low)
            mid = (1.0 - smooth) / factor * inv_freq + smooth * inv_freq
            in_band = (wavelen >= old_len / high) & (wavelen <= old_len / low)
            inv_freq = torch.where(in_band, mid, scaled)
        elif kind == "longrope":
            omax = float(scaling["original_max_position_embeddings"])
            mmax = float(scaling.get("max_position_embeddings", omax))
            factors = (scaling["long_factor"] if max_seq_len > omax
                       else scaling["short_factor"])
            f = torch.tensor(factors, dtype=torch.float32, device=device)
            if f.shape != (half,):
                raise ValueError(
                    f"longrope factor list must have head_dim/2={half} "
                    f"entries, got {tuple(f.shape)}")
            inv_freq = inv_freq / f
            ratio = mmax / omax
            if ratio > 1.0:
                mscale = math.sqrt(1.0 + math.log(ratio) / math.log(omax))
        elif kind != "default":
            raise ValueError(f"unsupported rope_scaling type: {kind!r}")
    t = torch.arange(max_seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)                       # [S, half]
    return torch.cos(freqs) * mscale, torch.sin(freqs) * mscale


def apply_rope(x: torch.Tensor, positions: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x [..., T, H, D]`` by per-token ``positions [..., T]``."""
    c = cos[positions].unsqueeze(-2)       # [..., T, 1, D/2]
    s = sin[positions].unsqueeze(-2)
    half = x.shape[-1] // 2
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)
