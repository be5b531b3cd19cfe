"""INT8 and INT4 quantization primitives (the JAX package's
``quant/tensor.py``).

Symmetric absmax scales: per output channel for INT8 weights, per row
for dynamic INT8 activations, per (K-group, output column) for INT4
weights. The JAX engine runs these under ``jit``, where XLA compiles
``absmax / 127.0`` (and ``/ 7.0``) into a multiply by the f32
reciprocal; the port takes the scale the same way, so values and scales
match ``jax.jit`` of the JAX functions bit for bit (an eager JAX call
divides, and differs in a few scales in a thousand).

Weights keep the JAX package's layout: ``values [K, N]`` int8 with N
contiguous, and INT4 nibble-packed in its block-local carrier
(:func:`pack_int4`). The kernels read those layouts as they are, so a
weight is never transposed or repacked for the card.
"""

from __future__ import annotations

import dataclasses

import torch

#: a Python scalar times an f32 tensor multiplies in f32 by the f32
#: value of the scalar, which is XLA's f32 reciprocal of the divisor
_INV_127 = 1.0 / 127.0
_INV_7 = 1.0 / 7.0


@dataclasses.dataclass
class QTensor:
    """INT8 values + f32 scales; ``dequant = values * scales``
    (broadcast). Weights: ``values [..., K, N]``, ``scales [..., 1, N]``."""

    values: torch.Tensor     # int8
    scales: torch.Tensor     # f32, broadcastable against values

    @property
    def shape(self):
        return self.values.shape

    def to(self, device) -> "QTensor":
        return QTensor(self.values.to(device), self.scales.to(device))


@dataclasses.dataclass
class Q4Tensor:
    """INT4 weight ``[K, N]``: ``packed [K, N/2]`` int8 carrier in the
    block-local layout :func:`pack_int4` makes for block width ``bn``,
    ``scales [K/group, N]`` f32 (one per K-group and column)."""

    packed: torch.Tensor     # int8 [K, N//2]
    scales: torch.Tensor     # f32 [K//group, N]
    group: int
    bn: int

    @property
    def shape(self):
        K, Nh = self.packed.shape
        return (K, Nh * 2)

    def to(self, device) -> "Q4Tensor":
        return Q4Tensor(self.packed.to(device), self.scales.to(device),
                        self.group, self.bn)


def _absmax_int8(x32: torch.Tensor, dim: int) -> QTensor:
    absmax = x32.abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp_min(absmax, 1e-8) * _INV_127
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return QTensor(q, scale)


def quantize_per_channel(w: torch.Tensor) -> QTensor:
    """Symmetric absmax INT8, reducing over the contraction axis (the
    second to last) only: one scale per output channel (and per layer
    for stacked ``[L, K, N]`` weights)."""
    return _absmax_int8(w.float(), -2)


def quantize_per_row(x: torch.Tensor) -> QTensor:
    """Dynamic activation quantization: one scale per last-axis row."""
    return _absmax_int8(x.float(), -1)


def dequantize(q: QTensor) -> torch.Tensor:
    """The f32 weight of ``q``."""
    return q.values.float() * q.scales


def pack_int4(q4: torch.Tensor, bn: int) -> torch.Tensor:
    """Pack int4 values (int8 in [-8, 7]) ``[K, N]`` into the block-local
    carrier ``[K, N/2]`` for blocks of width ``bn`` (divides N, even):
    carrier column ``j*bn/2 + t`` holds weight column ``j*bn + t`` in its
    low nibble, offset-binary (q + 8), and ``j*bn + bn/2 + t`` in its
    high nibble, two's complement."""
    K, N = q4.shape
    if N % bn or bn % 2:
        raise ValueError(f"bn={bn} must be even and divide N={N}")
    b = q4.reshape(K, N // bn, 2, bn // 2).to(torch.int32)
    lo = (b[:, :, 0] + 8) & 0xF
    hi = b[:, :, 1] & 0xF
    packed = (lo | (hi << 4)).to(torch.uint8).view(torch.int8)
    return packed.reshape(K, N // 2)


def unpack_int4(packed: torch.Tensor, bn: int) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: ``[K, N/2]`` -> int8 ``[K, N]`` in
    [-8, 7]."""
    K, Nh = packed.shape
    N = Nh * 2
    p = packed.to(torch.int32) & 0xFF
    lo = (p & 0xF) - 8
    hi = (((p >> 4) & 0xF) ^ 8) - 8
    b = torch.stack([lo, hi], dim=2)            # [K, N/2, (lo|hi)]
    # carrier order is (block j, col t, half h); weights (j, h, t)
    b = b.reshape(K, N // bn, bn // 2, 2).transpose(2, 3)
    return b.reshape(K, N).to(torch.int8)


def int4_block_width(n: int, cap: int = 2048) -> int:
    """The packing block width :func:`quantize_int4_groupwise` picks for
    ``n`` columns: the largest multiple of 256 that divides ``n``, up to
    ``cap`` (768 for a 128256-column LM head), else ``n`` itself."""
    cands = [d for d in range(256, min(n, cap) + 1, 256) if n % d == 0]
    if cands:
        return max(cands)
    if n % 2:
        raise ValueError(f"INT4 packing needs an even width, got {n}")
    return n


def quantize_int4_groupwise(w: torch.Tensor, group: int = 128,
                            bn: int = 2048) -> Q4Tensor:
    """Symmetric absmax INT4, one scale per (``group`` K-rows, output
    column), packed for the block width :func:`int4_block_width` picks
    under the cap ``bn`` (one device: the JAX package's ``col_shards``
    for tensor parallelism waits for ROADMAP queue A, parallelism)."""
    K, N = w.shape
    group = min(group, K)
    if K % group:
        raise ValueError(f"group {group} must divide K={K}")
    bn = int4_block_width(N, bn)
    w32 = w.float().reshape(K // group, group, N)
    absmax = w32.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp_min(absmax, 1e-8) * _INV_7
    q = torch.clamp(torch.round(w32 / scale), -8, 7)
    q = q.reshape(K, N).to(torch.int8)
    return Q4Tensor(pack_int4(q, bn), scale[:, 0, :].contiguous(), group, bn)


def dequantize_int4(q: Q4Tensor) -> torch.Tensor:
    """The f32 weight of ``q``."""
    vals = unpack_int4(q.packed, q.bn).float()
    return vals * torch.repeat_interleave(q.scales, q.group, dim=0)
