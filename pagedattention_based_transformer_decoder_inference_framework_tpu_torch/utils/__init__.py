from .common import cdiv, round_up, torch_dtype

__all__ = ["cdiv", "round_up", "torch_dtype"]
