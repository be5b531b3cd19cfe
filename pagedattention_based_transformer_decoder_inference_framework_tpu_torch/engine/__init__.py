from .backends import DenseKVBackend
from .engine import Engine, EngineState
from .paged_backend import PagedKVBackend
from .sampling import SampleMode, SamplingParams, filter_logits, sample

__all__ = [
    "DenseKVBackend",
    "Engine",
    "EngineState",
    "PagedKVBackend",
    "SampleMode",
    "SamplingParams",
    "filter_logits",
    "sample",
]
