"""KV-cache snapshot / restore of a live session.

A snapshot captures an ``EngineState``: the page pool (and an INT8
pool's scales), block tables, sequence lengths, each sequence's page
list, last tokens, finished flags, the penalty histogram when there is
one, and the sampling generator's state (``torch.Generator.get_state``:
the port's counterpart of the JAX package's PRNG key), so a generation
can be suspended to disk and resumed. bf16 leaves are stored as their
16-bit patterns.
"""

from __future__ import annotations

import json
from typing import TYPE_CHECKING

import numpy as np
import torch

if TYPE_CHECKING:
    from ..engine.engine import Engine, EngineState

def _to_np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _from_np(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


def save_kv_state(state: "EngineState", path: str) -> None:
    arrays = {f"kv_{i}": _to_np(x) for i, x in enumerate(state.kv)}
    arrays["block_tables"] = np.asarray(state.block_tables)
    arrays["seq_lens"] = np.asarray(state.seq_lens)
    arrays["last_tokens"] = np.asarray(state.last_tokens)
    arrays["finished"] = np.asarray(state.finished)
    arrays["generator"] = state.generator.get_state().numpy()
    if state.counts is not None:
        arrays["counts"] = _to_np(state.counts)
    meta = json.dumps({
        "pages": state.pages,
        "kv_dtypes": [str(x.dtype).replace("torch.", "") for x in state.kv]})
    np.savez(path, __meta__=np.frombuffer(meta.encode(), np.uint8),
             **arrays)


def load_kv_state(engine: "Engine", path: str) -> "EngineState":
    """Rebuild an ``EngineState`` on ``engine``'s device; claims its
    pages from the engine's allocator."""
    from ..engine.engine import EngineState

    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        kv = tuple(_from_np(data[f"kv_{i}"], dt, engine.device)
                   for i, dt in enumerate(meta["kv_dtypes"]))
        pages = [list(map(int, ps)) for ps in meta["pages"]]
        for ps in pages:
            for p in ps:
                engine.allocator.claim(p)
        gen = torch.Generator(device=engine.device)
        gen.set_state(torch.from_numpy(data["generator"].copy()))
        counts = (torch.from_numpy(data["counts"].copy()).to(engine.device)
                  if "counts" in data else None)
        return EngineState(
            kv=kv, block_tables=data["block_tables"].copy(),
            seq_lens=data["seq_lens"].copy(), pages=pages, generator=gen,
            last_tokens=data["last_tokens"].copy(),
            finished=data["finished"].copy(), counts=counts)
