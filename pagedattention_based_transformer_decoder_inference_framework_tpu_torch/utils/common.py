"""Small shared helpers."""

from __future__ import annotations

import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int8": torch.int8,
    "int32": torch.int32,
}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]
