from .backends import DenseKVBackend
from .beam import BeamHypothesis, BeamSearcher
from .engine import Engine, EngineState
from .paged_backend import PagedKVBackend
from .sampling import SampleMode, SamplingParams, filter_logits, sample

__all__ = [
    "BeamHypothesis",
    "BeamSearcher",
    "DenseKVBackend",
    "Engine",
    "EngineState",
    "PagedKVBackend",
    "SampleMode",
    "SamplingParams",
    "filter_logits",
    "sample",
]
