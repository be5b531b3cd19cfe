from .common import activation_fn, layernorm, rmsnorm, stable_softmax
from .rope import apply_rope, rope_table

__all__ = [
    "layernorm",
    "rmsnorm",
    "activation_fn",
    "stable_softmax",
    "rope_table",
    "apply_rope",
]
