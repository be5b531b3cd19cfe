"""JSONL export of labelled rows (the reranker's training data)."""

from __future__ import annotations

import json
from typing import Iterable, Mapping


def export_jsonl(rows: Iterable[Mapping], path: str) -> int:
    """Write one JSON object a line; returns the number of rows."""
    n = 0
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(dict(row), ensure_ascii=False) + "\n")
            n += 1
    return n
