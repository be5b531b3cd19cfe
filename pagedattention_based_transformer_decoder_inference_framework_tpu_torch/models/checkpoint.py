"""Weight checkpoints: save and load the params tree as one ``.npz`` (the
JAX package's native format, ``models/checkpoint.py``).

The file holds the tree's leaves under flat keys joined by ``/``. A
bf16 array is stored as its raw uint16 bits under a ``.bf16`` key suffix
(``.npy`` cannot describe bf16); an INT8 :class:`QTensor` as
``<key>.qvalues`` and ``<key>.qscales``; an INT4 :class:`Q4Tensor` as
``<key>.q4packed``, ``<key>.q4scales`` and ``<key>.q4meta`` (its group
and block width). Files pass between the two packages in both
directions. The bf16 bits are reinterpreted with ``torch``'s ``view``,
so no numpy bf16 type is needed.

The port also writes a tuple of layer dicts (an engine's unstacked
layers) under the keys ``layers/0``, ``layers/1``, ... and reads such
integer keys back as that tuple, so an INT4 engine's repacked weights,
which exist only unstacked, round-trip.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..quant.tensor import Q4Tensor, QTensor
from .model import params_from_jax

_SEP = "/"
_BF16_SUFFIX = ".bf16"
_QUANT_SUFFIXES = (".qvalues", ".qscales", ".q4packed", ".q4scales",
                   ".q4meta")


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(np.uint16)
        return v.numpy()
    return np.asarray(v)


def save_flat(flat: Dict[str, Any], path: str) -> None:
    """Write a flat ``key -> array`` dict as ``.npz`` (bf16-safe)."""
    enc: Dict[str, np.ndarray] = {}
    for k, v in flat.items():
        is_bf16 = (v.dtype == torch.bfloat16 if isinstance(v, torch.Tensor)
                   else np.asarray(v).dtype.name == "bfloat16")
        a = _numpy(v)
        if is_bf16:
            enc[k + _BF16_SUFFIX] = a.view(np.uint16)
        else:
            enc[k] = a
    np.savez(path, **enc)


def load_flat(path: str) -> Dict[str, torch.Tensor]:
    """Read a flat dict written by :func:`save_flat` as CPU tensors."""
    out: Dict[str, torch.Tensor] = {}
    with np.load(path) as data:
        for k in data.files:
            a = data[k]
            if k.endswith(_BF16_SUFFIX):
                out[k[: -len(_BF16_SUFFIX)]] = torch.from_numpy(
                    a.view(np.int16).copy()).view(torch.bfloat16)
            else:
                out[k] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if isinstance(tree, QTensor):
        out[prefix + ".qvalues"] = tree.values
        out[prefix + ".qscales"] = tree.scales
    elif isinstance(tree, Q4Tensor):
        out[prefix + ".q4packed"] = tree.packed
        out[prefix + ".q4scales"] = tree.scales
        out[prefix + ".q4meta"] = np.asarray([tree.group, tree.bn], np.int64)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{_SEP}{k}" if prefix else k))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{_SEP}{i}" if prefix else
                                str(i)))
    elif isinstance(tree, (torch.Tensor, np.ndarray)):
        out[prefix] = tree
    else:
        raise TypeError(f"cannot save the leaf {prefix!r} of type "
                        f"{type(tree).__name__}")
    return out


def save_params(params: Any, path: str) -> None:
    save_flat(_flatten(params), path)


def load_params(path: str, dtype=None, device="cpu") -> Any:
    """The params tree of a checkpoint on ``device`` (float leaves cast to
    ``dtype`` if given), through ``models/model.py::params_from_jax``:
    stacked or unstacked, float or quantized, as the file holds them; an
    ``Engine`` of the matching ``quant`` takes it as ``params``."""
    data = load_flat(path)
    tree: Dict[str, Any] = {}
    qt: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, v in data.items():
        if key.endswith(_QUANT_SUFFIXES):
            base, kind = key.rsplit(".", 1)
            qt.setdefault(base, {})[kind] = v
            continue
        if dtype is not None and v.is_floating_point():
            v = v.to(dtype)
        _insert(tree, key.split(_SEP), v)
    for base, parts in qt.items():
        if "q4packed" in parts:
            group, bn = (int(x) for x in parts["q4meta"])
            leaf = Q4Tensor(parts["q4packed"], parts["q4scales"], group, bn)
        else:
            leaf = QTensor(parts["qvalues"], parts["qscales"])
        _insert(tree, base.split(_SEP), leaf)
    return params_from_jax(_tuples(tree), None, device)


def _insert(tree: Dict[str, Any], keys, value) -> None:
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value


def _tuples(tree: Any) -> Any:
    """Dicts keyed ``"0"`` to ``"n-1"`` back to the tuples they were."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _tuples(v) for k, v in tree.items()}
    if out and sorted(out) == sorted(str(i) for i in range(len(out))):
        return tuple(out[str(i)] for i in range(len(out)))
    return out
