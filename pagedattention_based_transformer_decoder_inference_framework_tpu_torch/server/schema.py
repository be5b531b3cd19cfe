"""Request types of the REST API (the JAX package's
``server/schema.py``), as stdlib dataclasses: the port depends on no
validation library.

Each type takes a JSON object's fields as keywords, as the JAX package's
pydantic models do, with the same fields, defaults and bounds, and the
same lax coercions of JSON values: an integral float, a numeric string
or a bool for an ``int``; a number, a numeric string or a bool for a
``float``; ``true``/``false``, 0/1 or words such as ``"yes"`` and
``"off"`` for a ``bool``; object keys (strings in JSON) to ``int`` for
``logit_bias``; a dict for a :class:`ChatMessage`. Unknown fields are
ignored. A missing required field, a value of the wrong type or one out
of bounds raises :class:`ValidationError`, which the transports answer
with 422.
"""

from __future__ import annotations

import dataclasses
import math
import re
import typing
from typing import Any, Dict, List, Optional

_INT_STR = re.compile(r"^\s*([+-]?\d+)(?:\.0*)?\s*$")
_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}


class ValidationError(ValueError):
    """An invalid request payload (the transports map it to 422)."""


def _int(v: Any) -> int:
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, int):
        return v
    if isinstance(v, float):
        if math.isfinite(v) and v.is_integer():
            return int(v)
        raise ValueError("should be a valid integer, got a number with a "
                         "fractional part")
    if isinstance(v, str):
        m = _INT_STR.match(v)
        if m:
            return int(m.group(1))
        raise ValueError("should be a valid integer, unable to parse "
                         "string as an integer")
    raise ValueError("should be a valid integer")


def _float(v: Any) -> float:
    if isinstance(v, (bool, int, float)):
        return float(v)
    if isinstance(v, str):
        try:
            return float(v.strip())
        except ValueError:
            pass
        raise ValueError("should be a valid number, unable to parse string "
                         "as a number")
    raise ValueError("should be a valid number")


def _str(v: Any) -> str:
    if isinstance(v, str):
        return v
    raise ValueError("should be a valid string")


def _bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)) and v in (0, 1):
        return bool(v)
    if isinstance(v, str) and v.lower() in _TRUE | _FALSE:
        return v.lower() in _TRUE
    raise ValueError("should be a valid boolean")


def _coerce(v: Any, tp: Any) -> Any:
    origin, args = typing.get_origin(tp), typing.get_args(tp)
    if origin is typing.Union:                   # Optional[X]
        if v is None:
            return None
        return _coerce(v, next(a for a in args if a is not type(None)))
    if origin in (list, List):
        if not isinstance(v, (list, tuple)):
            raise ValueError("should be a valid list")
        return [_coerce(x, args[0]) for x in v]
    if origin in (dict, Dict):
        if not isinstance(v, dict):
            raise ValueError("should be a valid dictionary")
        return {_coerce(k, args[0]): _coerce(x, args[1])
                for k, x in v.items()}
    if isinstance(tp, type) and issubclass(tp, _Model):
        if isinstance(v, tp):
            return v
        if not isinstance(v, dict):
            raise ValueError(f"should be a valid {tp.__name__}")
        return tp(**v)
    return {int: _int, float: _float, str: _str, bool: _bool}[tp](v)


def _check_bounds(v: Any, meta) -> Optional[str]:
    for key, ok, word in (("ge", lambda b: v >= b, "greater than or equal to"),
                          ("gt", lambda b: v > b, "greater than"),
                          ("le", lambda b: v <= b, "less than or equal to")):
        if key in meta and not ok(meta[key]):
            return f"should be {word} {meta[key]}"
    return None


def _bounded(default, **bounds):
    return dataclasses.field(default=default, metadata=bounds)


class _Model:
    """Keyword construction with coercion and bounds over the dataclass
    fields of a subclass (declared with ``init=False``)."""

    def __init__(self, **data: Any):
        hints = typing.get_type_hints(type(self))
        errors = []
        for f in dataclasses.fields(self):
            if f.name in data:
                try:
                    v = _coerce(data[f.name], hints[f.name])
                except (ValueError, TypeError) as e:
                    errors.append(f"{f.name}: {e}")
                    continue
                bad = _check_bounds(v, f.metadata)
                if bad is not None:
                    errors.append(f"{f.name}: {bad}")
                    continue
            elif f.default is not dataclasses.MISSING:
                v = f.default
            elif f.default_factory is not dataclasses.MISSING:
                v = f.default_factory()
            else:
                errors.append(f"{f.name}: field required")
                continue
            setattr(self, f.name, v)
        if errors:
            raise ValidationError(
                f"{len(errors)} validation error(s) for "
                f"{type(self).__name__}: " + "; ".join(errors))

    def model_dump(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(init=False)
class SamplingFields(_Model):
    """Sampling knobs shared by every generation endpoint (all honoured,
    through the continuous-batching scheduler's bursts too)."""

    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    #: drop tokens with p < min_p * p(best token) (0 disables)
    min_p: float = _bounded(0.0, ge=0.0, le=1.0)
    #: HF-style repetition penalty over prompt+generated tokens
    repetition_penalty: float = _bounded(1.0, gt=0.0)
    #: OpenAI-style additive penalties on seen tokens
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    #: extra token ids that end generation like EOS (at most 4 used)
    stop_token_ids: List[int] = dataclasses.field(default_factory=list)
    #: OpenAI-style additive logit bias {token_id: bias} (at most 8
    #: entries used; applied before temperature)
    logit_bias: Dict[int, float] = dataclasses.field(default_factory=dict)
    seed: Optional[int] = None


@dataclasses.dataclass(init=False)
class GenerateRequest(SamplingFields):
    prompt: str
    max_new_tokens: int = _bounded(64, ge=1, le=4096)


@dataclasses.dataclass(init=False)
class BatchGenerateRequest(SamplingFields):
    prompts: List[str]
    max_new_tokens: int = _bounded(64, ge=1, le=4096)


@dataclasses.dataclass(init=False)
class ChatMessage(_Model):
    role: str = "user"
    content: str


@dataclasses.dataclass(init=False)
class StreamChatRequest(SamplingFields):
    messages: List[ChatMessage]
    max_new_tokens: int = _bounded(64, ge=1, le=4096)


@dataclasses.dataclass(init=False)
class BeamStreamRequest(_Model):
    messages: List[ChatMessage]
    max_new_tokens: int = _bounded(64, ge=1, le=4096)
    beam_width: int = _bounded(4, ge=1, le=16)
    use_rerank: bool = True
