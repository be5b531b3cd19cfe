"""Serving metrics: counters, latency percentiles and pool occupancy
(the JAX package's ``server/metrics.py``), exported through the
``/metrics`` endpoint.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional


class Metrics:
    def __init__(self, window: int = 1024):
        self._lock = threading.Lock()
        self.requests_total = 0
        self.requests_failed = 0
        self.tokens_in = 0
        self.tokens_out = 0
        self._ttft = deque(maxlen=window)      # seconds
        self._tpot = deque(maxlen=window)      # seconds per output token
        self.started_at = time.time()

    def record(self, *, tokens_in: int, tokens_out: int,
               ttft_s: Optional[float], total_s: float,
               failed: bool = False) -> None:
        with self._lock:
            self.requests_total += 1
            if failed:
                self.requests_failed += 1
                return
            self.tokens_in += tokens_in
            self.tokens_out += tokens_out
            if ttft_s is not None:
                self._ttft.append(ttft_s)
            if tokens_out > 1:
                self._tpot.append(
                    (total_s - (ttft_s or 0.0)) / max(tokens_out - 1, 1))

    @staticmethod
    def _pct(xs, q: float) -> Optional[float]:
        if not xs:
            return None
        s = sorted(xs)
        return s[min(int(q * len(s)), len(s) - 1)]

    def snapshot(self, engine=None) -> Dict:
        with self._lock:
            out = {
                "uptime_s": round(time.time() - self.started_at, 1),
                "requests_total": self.requests_total,
                "requests_failed": self.requests_failed,
                "tokens_in": self.tokens_in,
                "tokens_out": self.tokens_out,
                "ttft_s": {q: self._pct(self._ttft, v)
                           for q, v in (("p50", .5), ("p90", .9),
                                        ("p99", .99))},
                "tpot_s": {q: self._pct(self._tpot, v)
                           for q, v in (("p50", .5), ("p90", .9),
                                        ("p99", .99))},
            }
        if engine is not None:
            # one device, so one allocator (the JAX engine sums its
            # data-parallel shards' allocators)
            out["kv_pages"] = {"free": engine.allocator.num_free,
                               "live": engine.allocator.num_live}
        return out
