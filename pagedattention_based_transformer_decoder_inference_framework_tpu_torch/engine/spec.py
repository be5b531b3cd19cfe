"""Prompt-lookup speculative decoding: n-gram drafting on the device.

The JAX package's ``engine/spec.py`` as plain tensor functions over the
batch (its ``vmap``s written out). Drafts come from the sequence's own
history: find the most recent earlier occurrence of the trailing
``n``-gram and propose the ``k`` tokens that followed it; a ``(k+1)``-
token verify forward then checks them all at once
(``Engine.generate_batch_spec``). Greedy acceptance is argmax equality,
so greedy outputs are exact.

The per-row dynamic slices follow ``jax.lax.dynamic_slice`` and
``dynamic_update_slice``: a start that would run past the row is clamped
to the last one that fits, so every function gives the JAX package's
answer on any buffer.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .sampling import gumbel_argmax, key_uniforms


def _clamped_starts(starts: torch.Tensor, width: int,
                    M: int) -> torch.Tensor:
    """``[B, width]`` column indices of the ``width``-wide window at each
    row's start, the start clamped to ``[0, M - width]``."""
    s = starts.long().clamp(0, M - width)
    return s[:, None] + torch.arange(width, device=starts.device)


def draft_ngram(buf: torch.Tensor, cur: torch.Tensor, *, k: int,
                n: int) -> torch.Tensor:
    """Draft ``k`` continuation tokens per sequence by n-gram lookup.

    buf: ``[B, M]`` int token history (``buf[b, :cur[b]]`` valid).
    cur: ``[B]`` number of valid tokens.
    Returns ``[B, k]`` drafts in ``buf``'s dtype: the ``k`` tokens after
    the most recent earlier occurrence of the trailing ``n``-gram
    ``buf[cur-n:cur]`` (ending strictly before it), else the last token
    repeated. Context indices clamp to the row and n-gram windows wrap
    around its end, as the JAX version's ``jnp.roll`` does."""
    B, M = buf.shape
    cur = cur.long()
    idx = torch.arange(M, device=buf.device)
    eq = torch.ones((B, M), dtype=torch.bool, device=buf.device)
    for t in range(n):
        ctx = buf.gather(1, (cur - n + t).clamp(0, M - 1)[:, None])
        eq &= torch.roll(buf, -t, dims=1) == ctx
    eq &= (idx + n)[None, :] <= (cur - 1)[:, None]
    j = torch.where(eq, idx, torch.full_like(idx, -1)).amax(dim=1)
    start = torch.where(j >= 0, j + n, torch.zeros_like(j))
    draft = buf.gather(1, _clamped_starts(start, k, M))
    last = buf.gather(1, (cur - 1).clamp(0, M - 1)[:, None])
    return torch.where((j >= 0)[:, None], draft, last.expand(B, k))


def accept_counts(drafts: torch.Tensor, targets: torch.Tensor
                  ) -> torch.Tensor:
    """Longest accepted prefix: ``a[b]`` = number of leading positions
    where ``drafts[b, i] == targets[b, i]`` (greedy acceptance)."""
    match = (drafts == targets).to(torch.int32)
    return torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)


def stochastic_accept(scaled: torch.Tensor, drafts: torch.Tensor,
                      generator: Optional[torch.Generator] = None, *,
                      keys_u: Optional[torch.Tensor] = None,
                      keys_re: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Speculative acceptance for sampled requests (temperature > 0)
    with a deterministic (prompt-lookup) draft: draft ``d_i`` is
    accepted with probability ``p_i(d_i)``, and at the first rejection
    the replacement is drawn from ``p_i`` with ``d_i`` removed and the
    rest renormalized, so each emitted token is distributed exactly as a
    plain draw from ``p``; when every draft is accepted the bonus token
    draws ``p_K``.

    scaled: ``[B, K+1, V]`` masked scaled logits (what ``sample`` draws
    from, ``engine.sampling.prepare_logits``); drafts: ``[B, K]``;
    generator: the draws' source (the JAX version takes threefry keys;
    the two agree in distribution, not draw for draw); or, as the JAX
    version takes them, per-row keys (``engine.sampling.request_key``):
    ``keys_u [B, K]`` for the accept coin at each position and ``keys_re
    [B, K+1]`` for the draw at the emit position (the scheduler's spec
    burst, whose draws must not depend on the batch).
    Returns ``(a [B], fix [B])`` int32: the accepted-prefix length and
    the token emitted at position ``a``."""
    B, K1, V = scaled.shape
    K = K1 - 1
    logp = torch.log_softmax(scaled.float(), dim=-1)
    p_draft = logp[:, :K].gather(2, drafts.long()[..., None])[..., 0]
    if keys_u is not None:
        u = key_uniforms(keys_u, 1)[..., 0]
    else:
        u = torch.rand((B, K), generator=generator, device=scaled.device)
    accept = torch.log(u.clamp_min(1e-30)) < p_draft
    a = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)
    pos = a.clamp(max=K)
    row = scaled.float().gather(
        1, pos.long()[:, None, None].expand(B, 1, V))[:, 0]
    rej = drafts.long().gather(1, pos.clamp(max=K - 1).long()[:, None])
    drop = (pos < K)[:, None] & (torch.arange(V, device=scaled.device)
                                 == rej)
    row = row.masked_fill(drop, float("-inf"))
    if keys_re is not None:
        fix = gumbel_argmax(row, keys_re.gather(1, pos.long()[:, None])[:, 0])
    else:
        fix = torch.multinomial(torch.softmax(row, dim=-1), 1,
                                generator=generator)[:, 0]
    return a.to(torch.int32), fix.to(torch.int32)


def write_rows(buf: torch.Tensor, starts: torch.Tensor,
               vals: torch.Tensor) -> torch.Tensor:
    """Per-row dynamic write: a copy of ``buf`` with ``buf[b,
    starts[b]:starts[b]+W] = vals[b]`` (start clamped so the window fits,
    as ``dynamic_update_slice`` does)."""
    cols = _clamped_starts(starts, vals.shape[1], buf.shape[1])
    return buf.scatter(1, cols, vals.to(buf.dtype))


def gather_rows(buf: torch.Tensor, starts: torch.Tensor,
                width: int) -> torch.Tensor:
    """Per-row dynamic gather: ``buf[b, starts[b]:starts[b]+width]``
    (start clamped so the window fits, as ``dynamic_slice`` does)."""
    return buf.gather(1, _clamped_starts(starts, width, buf.shape[1]))
