"""K/V rows that pin the INT8 quantization of a row (``quantize_kv``:
the absmax over D in f32, ``scale = max(absmax, 1e-8) * f32(1/127)``,
``q = clamp(rint(x / scale), -127, 127)``), shared by the CPU and the
card tests of the appends.

* ``ties``: the absmax 127 (scale 1), the other values ``k + 0.5``, so
  every quotient is an exact tie (half to even);
* ``zero``: all zeros (scale ``1e-8 / 127``, every code 0);
* ``negative absmax``: the absmax element negative (code -127);
* ``division``: a value whose quotient and whose product with the f32
  reciprocal of the scale round to different codes, so a kernel that
  multiplies by the reciprocal fails. Found with numpy (IEEE f32) among
  bf16-representable values, so the row is the same in bf16 and f32.
"""

import numpy as np

INV_127 = np.float32(1.0 / 127.0)


def row_scale(absmax) -> np.float32:
    return np.float32(max(np.float32(absmax), np.float32(1e-8)) * INV_127)


def _bf16_values(lo_exp: int, hi_exp: int) -> np.ndarray:
    """Every positive bf16 value in [2**lo_exp, 2**hi_exp), as f32."""
    mant = np.arange(128, dtype=np.uint32) << 16
    return np.concatenate([((np.uint32(127 + e) << 23) | mant).view(
        np.float32) for e in range(lo_exp, hi_exp)])


def division_pair():
    """``(absmax, x)``, both bf16-representable, ``x < absmax``, where
    ``rint(x / s) != rint(x * (1 / s))`` in f32 for the row's scale
    ``s``."""
    xs = _bf16_values(-6, 4)
    for a in _bf16_values(0, 4):
        s = row_scale(a)
        r = np.float32(1) / s
        cand = xs[xs < a]
        hit = np.rint(cand / s) != np.rint(cand * r)
        if hit.any():
            return np.float32(a), np.float32(cand[hit][0])
    raise AssertionError("no bf16 pair pins the division")


def edge_rows(rng, D: int) -> dict:
    """The four rows above, ``{name: f32 [D]}`` (D >= 2)."""
    ties = (np.arange(D) % 126 + 0.5).astype(np.float32)
    ties *= np.where(rng.random(D) < 0.5, -1, 1).astype(np.float32)
    ties[0] = 127.0
    neg = rng.normal(size=D).astype(np.float32)
    neg[int(np.argmax(np.abs(neg)))] = -3 * np.abs(neg).max()
    a, x = division_pair()
    div = (rng.uniform(-1, 1, size=D) * a).astype(np.float32)
    div[0], div[1] = a, x
    s = row_scale(a)
    assert np.rint(x / s) != np.rint(x * (np.float32(1) / s))
    return {"ties": ties, "zero": np.zeros(D, np.float32),
            "negative absmax": neg, "division": div}


def plant_edge_rows(rng, k: np.ndarray, v: np.ndarray) -> None:
    """Writes the edge rows into ``k`` and ``v`` ``[B, T, KH, D]`` (in
    place), at rows spread over sequences, tokens and heads."""
    B, T, KH, D = k.shape
    rows = list(edge_rows(rng, D).values())
    for i, row in enumerate(rows + rows):
        dst = k if i < len(rows) else v
        dst[i % B, (i * 3) % T, (i * 5) % KH] = row
