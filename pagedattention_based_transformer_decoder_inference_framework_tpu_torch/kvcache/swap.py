"""Host-RAM KV page swap: the scheduler's overflow tier.

A preempted request's pages move to host RAM (:func:`gather_pages`) and
come back into fresh pool pages on re-admission (:func:`scatter_pages`),
so preemption under page pressure costs two copies instead of a
re-prefill. Plain ``index_select`` / ``index_copy_``; the host slabs of a
CUDA pool are in pinned memory, and the scatter writes the pool in place.

Values leaves ``[L, 2, KH, P, page, d]`` move as ``[L, 2, KH, n, page,
d]`` slabs. An INT8 pool's flat scales ``[L, 2, KH, R, 128]`` hold a
page's scales in ``page`` consecutive slots of the flattened ``R * 128``
axis (half a row at page 64), so they move slot by slot, as
``[L, 2, KH, n * page]``, never row by row.
"""

from __future__ import annotations

from typing import List, Tuple

import torch


def _slots(pages: torch.Tensor, page_size: int) -> torch.Tensor:
    return (pages[:, None] * page_size
            + torch.arange(page_size, device=pages.device)).reshape(-1)


def _is_scales(leaf: torch.Tensor) -> bool:
    return leaf.ndim == 5 and leaf.shape[-1] == 128


def _flat(leaf: torch.Tensor) -> torch.Tensor:
    return leaf.view(leaf.shape[:3] + (-1,))


def _host(t: torch.Tensor) -> torch.Tensor:
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
    out.copy_(t)
    return out


def gather_pages(kv, pages: List[int]) -> Tuple[torch.Tensor, ...]:
    """Copy the given pool pages to the host: one slab per pool leaf."""
    page_size = kv[0].shape[4]
    idx = torch.as_tensor(list(pages), dtype=torch.long).to(kv[0].device)
    out = []
    for leaf in kv:
        if _is_scales(leaf):
            out.append(_host(_flat(leaf).index_select(
                3, _slots(idx, page_size))))
        else:
            out.append(_host(leaf.index_select(3, idx)))
    return tuple(out)


def scatter_pages(kv, blobs: Tuple[torch.Tensor, ...], pages: List[int]):
    """Write host slabs back into (new) pool pages, in place; returns
    ``kv``."""
    page_size = kv[0].shape[4]
    idx = torch.as_tensor(list(pages), dtype=torch.long).to(kv[0].device)
    for leaf, blob in zip(kv, blobs):
        blob = blob.to(device=leaf.device, dtype=leaf.dtype)
        if _is_scales(leaf):
            _flat(leaf).index_copy_(3, _slots(idx, page_size), blob)
        else:
            leaf.index_copy_(3, idx, blob)
    return kv
