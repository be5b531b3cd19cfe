"""Linear layers: ``y = act(x @ w + bias)`` for dense weights.

A plain large matrix product, so it stays ``torch.matmul`` (cuBLAS on
the card), as the JAX package leaves it to XLA's ``dot_general`` by
default. Quantized weights (INT8 w8a8 / weight-only, INT4) are not on
this slice: :class:`QTensor` and :class:`Q4Tensor` stand for them and
raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from .common import activation_fn


class QTensor:
    """INT8 weight with per-output-channel scales (JAX package
    ``quant/tensor.py``). Not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "INT8 weights (w8a8 int8_matmul, int8-weight w8_matmul): "
            "ROADMAP queue B items B10/B11, the head of the next slice")


class Q4Tensor:
    """Nibble-packed INT4 weight with group-wise scales. Not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "INT4 weights (w4_matmul): ROADMAP queue B item B12")


def linear(x: torch.Tensor, w: torch.Tensor,
           bias: Optional[torch.Tensor] = None,
           act: Optional[str] = None) -> torch.Tensor:
    """``y = act(x @ w + bias)`` with ``w [in, out]``; ``x [..., in]``.
    The product is taken in ``x``'s dtype; bias and activation in f32,
    then cast back to ``x``'s dtype."""
    if not isinstance(w, torch.Tensor):
        raise NotImplementedError(
            f"linear over {type(w).__name__}: only dense weights are ported")
    y = torch.matmul(x, w.to(x.dtype))
    if bias is None and act is None:
        return y
    y = y.float()
    if bias is not None:
        y = y + bias.float()
    if act is not None:
        y = activation_fn(act)(y)
    return y.to(x.dtype)
