"""Vocab-logit sampling: greedy / temperature / min-p / top-k / top-p /
penalties / logit bias / EOS threshold.

The JAX package's ``engine/sampling.py`` with ``torch.Generator``
draws. The masks (:func:`filter_logits`, :func:`prepare_logits`) are the
same functions of the logits; the draws differ from JAX's threefry
streams, so sampled tokens agree with the JAX package in distribution,
not token by token. Greedy picks are identical.

Per-request draws (the scheduler's bursts; JAX's ``row_keys``): a row's
key is :func:`request_key` ``(seed, index)``, a 32-bit integer that is a
pure function of the request's seed and the index of the token it draws,
so a request's sampled stream does not depend on batch composition,
burst boundaries or preemption. The draw is Gumbel-max on the device in
one pass: column ``j`` of the row gets the uniform of the counter-based
hash of ``(key, j)`` (:func:`key_uniforms`: ``lowbias32`` rounds, 24
bits), and the token is ``argmax(scaled + gumbel)`` over the masked
scaled logits, which draws from ``softmax(scaled)``. No per-row
``torch.Generator`` and no host work a step: a burst's draws are a few
elementwise kernels over ``[B, V]``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

#: stop-token set width: ``stop_token_ids`` pads to this many slots
STOP_SLOTS = 4

#: logit-bias slot width
BIAS_SLOTS = 8


@dataclasses.dataclass(frozen=True)
class SampleMode:
    """Which sampler features run (skips the full-vocab sort and the
    draw for greedy requests)."""

    greedy: bool = False
    use_filter: bool = True
    use_min_p: bool = False
    use_eos_threshold: bool = True
    #: >0: top-k/top-p over the top-``filter_cap`` candidates instead of
    #: a full-vocab sort (exact whenever top_k <= cap)
    filter_cap: int = 0
    use_penalties: bool = False
    use_logit_bias: bool = False


@dataclasses.dataclass
class SamplingParams:
    """Host-side sampling knobs; ``as_arrays`` broadcasts to a batch."""

    temperature: float = 1.0
    top_k: int = 0            # 0 disables
    top_p: float = 1.0        # 1.0 disables
    min_p: float = 0.0        # >0: drop tokens with p < min_p * p_max
    eos_token_id: int = -1    # -1 disables EOS handling
    eos_threshold: float = 0.0
    #: extra token ids that end generation like EOS (padded to STOP_SLOTS)
    stop_token_ids: tuple = ()
    #: HF-style repetition penalty (1.0 disables)
    repetition_penalty: float = 1.0
    #: OpenAI-style additive penalties (0 disables)
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    #: ((token_id, bias), ...), at most BIAS_SLOTS entries, added to the
    #: raw logits before temperature
    logit_bias: tuple = ()

    def as_arrays(self, batch: int, device="cpu"):
        def f(v):
            return torch.full((batch,), v, dtype=torch.float32,
                              device=device)

        def i(v):
            return torch.full((batch,), v, dtype=torch.int32, device=device)

        stops = (tuple(self.stop_token_ids)[:STOP_SLOTS]
                 + (-1,) * (STOP_SLOTS - len(self.stop_token_ids)))
        lb = tuple(self.logit_bias)[:BIAS_SLOTS]
        bias_ids = tuple(t for t, _ in lb) + (-1,) * (BIAS_SLOTS - len(lb))
        bias_vals = (tuple(float(v) for _, v in lb)
                     + (0.0,) * (BIAS_SLOTS - len(lb)))

        def rows(vals, dtype):
            return torch.tensor(vals, dtype=dtype,
                                device=device).expand(batch, -1)

        return {
            "temperature": f(self.temperature),
            "top_k": i(self.top_k),
            "top_p": f(self.top_p),
            "min_p": f(self.min_p),
            "eos_token_id": i(self.eos_token_id),
            "eos_threshold": f(self.eos_threshold),
            "stop_ids": rows(stops, torch.int32),
            "rep_pen": f(self.repetition_penalty),
            "presence_pen": f(self.presence_penalty),
            "freq_pen": f(self.frequency_penalty),
            "bias_ids": rows(bias_ids, torch.int32),
            "bias_vals": rows(bias_vals, torch.float32),
        }

    def value_key(self) -> tuple:
        """Hashable tuple of every knob value: the batched sampling
        arrays are a pure function of the rows' value keys, so callers
        cache uploaded batches on ``tuple(s.value_key() for s in rows)``."""
        return (self.temperature, self.top_k, self.top_p, self.min_p,
                self.eos_token_id, self.eos_threshold,
                tuple(self.stop_token_ids), self.repetition_penalty,
                self.presence_penalty, self.frequency_penalty,
                tuple(self.logit_bias))

    @property
    def has_penalties(self) -> bool:
        return (self.repetition_penalty != 1.0
                or self.presence_penalty != 0.0
                or self.frequency_penalty != 0.0)

    def mode(self) -> SampleMode:
        return SampleMode(
            greedy=self.temperature <= 0.0,
            use_filter=self.top_k > 0 or self.top_p < 1.0,
            use_min_p=self.min_p > 0.0,
            use_eos_threshold=self.eos_threshold > 0.0
            and self.eos_token_id >= 0,
            filter_cap=64 if 0 < self.top_k <= 64 else 0,
            use_penalties=self.has_penalties,
            use_logit_bias=bool(self.logit_bias),
        )


def batch_arrays_np(samplings) -> dict:
    """NumPy layout of per-row sampling knobs for a batch whose rows
    differ: the keys and shapes of :meth:`SamplingParams.as_arrays`, built
    on the host with no device work. Callers upload once per distinct
    ``tuple(s.value_key() for s in samplings)`` and cache."""
    n = len(samplings)
    vals = {k: [] for k in ("temperature", "top_k", "top_p", "min_p",
                            "eos_token_id", "eos_threshold",
                            "rep_pen", "presence_pen", "freq_pen")}
    stop_ids = np.full((n, STOP_SLOTS), -1, np.int32)
    bias_ids = np.full((n, BIAS_SLOTS), -1, np.int32)
    bias_vals = np.zeros((n, BIAS_SLOTS), np.float32)
    for i, s in enumerate(samplings):
        vals["temperature"].append(s.temperature)
        vals["top_k"].append(s.top_k)
        vals["top_p"].append(s.top_p)
        vals["min_p"].append(s.min_p)
        vals["eos_token_id"].append(s.eos_token_id)
        vals["eos_threshold"].append(s.eos_threshold)
        vals["rep_pen"].append(s.repetition_penalty)
        vals["presence_pen"].append(s.presence_penalty)
        vals["freq_pen"].append(s.frequency_penalty)
        sids = tuple(s.stop_token_ids)[:STOP_SLOTS]
        stop_ids[i, :len(sids)] = sids
        lb = tuple(s.logit_bias)[:BIAS_SLOTS]
        if lb:
            bias_ids[i, :len(lb)] = [t for t, _ in lb]
            bias_vals[i, :len(lb)] = [v for _, v in lb]
    ints = {"top_k", "eos_token_id"}
    out = {k: np.asarray(v, np.int32 if k in ints else np.float32)
           for k, v in vals.items()}
    out["stop_ids"] = stop_ids
    out["bias_ids"] = bias_ids
    out["bias_vals"] = bias_vals
    return out


def arrays_to(arrays: dict, device) -> dict:
    """:func:`batch_arrays_np`'s arrays as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


# -- per-request keys -------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """``x * c mod 2**32`` for ``x`` in ``[0, 2**32)`` (an int or an int64
    tensor), in products that stay below ``2**49``."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + ((hi * (c & 0xFFFF)) << 16)) & _M32


def _mix32(x):
    """``lowbias32``: a bijective 32-bit finalizer (ints or int64
    tensors holding 32-bit values)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _as_key_input(v):
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64) & _M32
    return int(v) & _M32


def request_key(seed, index):
    """Sampling key of generated token ``index`` of the request seeded
    ``seed``: a 32-bit integer, a pure function of ``(seed, index)``
    (ints, or int tensors of one shape; returns the same kind, int64)."""
    k = _mix32(_as_key_input(seed) ^ 0x9E3779B9)
    return _mix32(k ^ _mix32((_as_key_input(index) + 0x632BE5AB) & _M32))


def fold_key(key, data: int):
    """A key derived from ``key`` and ``data`` (JAX's ``fold_in``)."""
    return _mix32(_as_key_input(key)
                  ^ _mix32((int(data) * 0x85EBCA6B + 0x27D4EB2F) & _M32))


def key_uniforms(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``[*keys.shape, n]`` f32 uniforms in (0, 1): column ``j`` of a key
    is the 24 high bits of the hash of ``(key, j)``, plus one half."""
    keys = keys.to(torch.int64)
    cols = _mix32((torch.arange(n, device=keys.device, dtype=torch.int64)
                   * 0x9E3779B1 + 0x165667B1) & _M32)
    h = _mix32(_mix32(keys[..., None] ^ cols) ^ (keys[..., None] >> 7))
    return ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def gumbel_argmax(scaled: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """One draw a row from ``softmax(scaled [B, V])`` with the row's key
    (``keys [B]``): ``argmax(scaled - log(-log(u)))``."""
    u = key_uniforms(keys, scaled.shape[-1])
    return torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)


def filter_logits(logits: torch.Tensor, top_k: torch.Tensor,
                  top_p: torch.Tensor) -> torch.Tensor:
    """Mask logits outside top-k / nucleus top-p (``-inf``).

    logits ``[B, V]`` f32; top_k ``[B]`` int (0 = off); top_p ``[B]``.
    Nucleus keeps tokens while the probability of the strictly greater
    ones is ``< top_p`` (always keeps the argmax)."""
    B, V = logits.shape
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    k = torch.where(top_k <= 0, torch.full_like(top_k, V),
                    torch.clamp(top_k, max=V)).long()
    kth = torch.gather(sorted_desc, 1, (k - 1)[:, None])
    keep_k = logits >= kth
    probs_sorted = torch.softmax(sorted_desc, dim=-1)
    cum_before = torch.cumsum(probs_sorted, dim=-1) - probs_sorted
    cutoff = cum_before < top_p[:, None]
    min_kept = torch.where(cutoff, sorted_desc,
                           torch.full_like(sorted_desc, float("inf"))
                           ).amin(dim=-1, keepdim=True)
    keep_p = logits >= min_kept
    return torch.where(keep_k & keep_p, logits,
                       torch.full_like(logits, float("-inf")))


def _filter_logits_capped(logits: torch.Tensor, top_k: torch.Tensor,
                          top_p: torch.Tensor, cap: int) -> torch.Tensor:
    """:func:`filter_logits` restricted to the top-``cap`` candidates
    (requires ``top_k`` in (0, cap])."""
    vals = torch.topk(logits, cap, dim=-1).values
    k = torch.clamp(top_k, 1, cap).long()
    kth = torch.gather(vals, 1, (k - 1)[:, None])
    keep_k = logits >= kth
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    probs = torch.exp(vals - lse)
    cum_before = torch.cumsum(probs, dim=-1) - probs
    cutoff = cum_before < top_p[:, None]
    min_kept = torch.where(cutoff, vals, torch.full_like(vals, float("inf"))
                           ).amin(dim=-1, keepdim=True)
    keep_p = logits >= min_kept
    return torch.where(keep_k & keep_p, logits,
                       torch.full_like(logits, float("-inf")))


def hit_stop(tok: torch.Tensor, eos_token_id: torch.Tensor,
             stop_ids: Optional[torch.Tensor]) -> torch.Tensor:
    """``[B]`` bool: ``tok`` ends its request (EOS or a stop id)."""
    done = (eos_token_id >= 0) & (tok == eos_token_id)
    if stop_ids is not None:
        done = done | ((stop_ids >= 0) & (tok[:, None] == stop_ids)).any(-1)
    return done


def token_counts(tokens: torch.Tensor, lens: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """``[B, V]`` int32 histogram of ``tokens[b, :lens[b]]``."""
    B, T = tokens.shape
    valid = (torch.arange(T, device=tokens.device)[None, :]
             < lens[:, None]).to(torch.int32)
    idx = tokens.clamp(0, vocab - 1).long()
    counts = torch.zeros((B, vocab), dtype=torch.int32, device=tokens.device)
    return counts.scatter_add_(1, idx, valid)


def bump_counts(counts: torch.Tensor, tok: torch.Tensor,
                live: torch.Tensor) -> torch.Tensor:
    """Add ``tok`` to each live row's histogram (in place)."""
    idx = tok.clamp(0, counts.shape[1] - 1).long()[:, None]
    return counts.scatter_add_(1, idx, live.to(torch.int32)[:, None])


def apply_penalties(logits, counts, rep_pen, presence_pen, freq_pen):
    """HF repetition penalty + OpenAI presence/frequency penalties on raw
    logits; ``counts [B, V]`` covers prompt + generated tokens."""
    seen = counts > 0
    rp = torch.clamp_min(rep_pen, 1e-6)[:, None]
    logits = torch.where(seen, torch.where(logits > 0, logits / rp,
                                           logits * rp), logits)
    logits = logits - torch.where(seen, presence_pen[:, None],
                                  torch.zeros_like(logits))
    return logits - freq_pen[:, None] * counts.float()


def prepare_logits(logits: torch.Tensor, *, temperature, top_k, top_p,
                   min_p=None, rep_pen=None, presence_pen=None,
                   freq_pen=None, counts=None, bias_ids=None,
                   bias_vals=None, mode: Optional[SampleMode] = None,
                   **_ignored):
    """Penalties + logit bias on the raw logits, then temperature /
    min-p / top-k / top-p masking. Returns ``(raw, masked)``: the
    post-penalty raw logits (greedy picks and the EOS threshold read
    these) and the masked scaled logits sampling draws from."""
    mode = mode or SampleMode()
    B, V = logits.shape
    logits = logits.float()
    if mode.use_penalties and counts is not None:
        logits = apply_penalties(logits, counts, rep_pen, presence_pen,
                                 freq_pen)
    if mode.use_logit_bias and bias_ids is not None:
        idx = bias_ids.clamp(0, V - 1).long()
        vals = torch.where(bias_ids >= 0, bias_vals,
                           torch.zeros_like(bias_vals))
        logits = logits.scatter_add(1, idx, vals)
    if mode.greedy:
        return logits, logits
    scaled = logits / torch.clamp_min(temperature, 1e-6)[:, None]
    if mode.use_min_p and min_p is not None:
        lmax = scaled.amax(dim=-1, keepdim=True)
        cut = lmax + torch.log(torch.clamp_min(min_p, 1e-10))[:, None]
        drop = (min_p[:, None] > 0.0) & (scaled < cut)
        scaled = scaled.masked_fill(drop, float("-inf"))
    if mode.use_filter and mode.filter_cap:
        scaled = _filter_logits_capped(scaled, top_k, top_p,
                                       min(mode.filter_cap, V))
    elif mode.use_filter:
        scaled = filter_logits(scaled, top_k, top_p)
    return logits, scaled


def sample(logits: torch.Tensor, generator: Optional[torch.Generator], *,
           temperature, top_k, top_p, eos_token_id=None, eos_threshold=None,
           min_p=None, stop_ids=None, rep_pen=None, presence_pen=None,
           freq_pen=None, counts=None, bias_ids=None, bias_vals=None,
           row_keys: Optional[torch.Tensor] = None,
           mode: Optional[SampleMode] = None) -> torch.Tensor:
    """Draw next tokens from ``logits [B, V]``; returns ``[B]`` int32.
    ``temperature <= 0`` rows are greedy. ``row_keys [B]``
    (:func:`request_key`) draws each row with its own key by
    :func:`gumbel_argmax` (the scheduler's per-request seeds; then
    ``generator`` is not read). ``stop_ids`` is accepted so callers can
    splat the whole sampling dict; termination is the caller's job
    (:func:`hit_stop`)."""
    del stop_ids
    mode = mode or SampleMode()
    B, V = logits.shape
    logits, scaled = prepare_logits(
        logits, temperature=temperature, top_k=top_k, top_p=top_p,
        min_p=min_p, rep_pen=rep_pen, presence_pen=presence_pen,
        freq_pen=freq_pen, counts=counts, bias_ids=bias_ids,
        bias_vals=bias_vals, mode=mode)
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    if mode.greedy:
        tok = greedy_tok
    else:
        if row_keys is not None:
            sampled = gumbel_argmax(scaled, row_keys)
        else:
            probs = torch.softmax(scaled, dim=-1)
            sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
        tok = torch.where(temperature <= 0.0, greedy_tok,
                          sampled.to(torch.int32))
    if (mode.use_eos_threshold and eos_token_id is not None
            and eos_threshold is not None):
        probs = torch.softmax(logits, dim=-1)
        eos_id = eos_token_id.clamp(0, V - 1)
        p_eos = torch.gather(probs, 1, eos_id.long()[:, None])[:, 0]
        force = (eos_threshold > 0.0) & (eos_token_id >= 0) & (
            p_eos >= eos_threshold)
        tok = torch.where(force, eos_id.to(torch.int32), tok)
    return tok
