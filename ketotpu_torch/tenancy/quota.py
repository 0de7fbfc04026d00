"""Per-tenant quotas: token buckets for inflight units, write rate, and
tuple count.

The buckets sit under the server's admission and brownout plane: the
global limit and priority ladder decide how much work the process accepts
at all; these buckets decide how much of that budget one tenant may
occupy.  A tenant that floods batches exhausts its own inflight bucket
and sheds with 429 (TooManyRequestsError, which the transport layers
already map to Retry-After semantics) while every other tenant's budget
is untouched — the noisy-neighbor isolation the serve_tenants bench leg
gates on.
"""

from __future__ import annotations

import threading
import time
from typing import Optional


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/second up to ``burst``.

    ``rate <= 0`` disables the bucket (every take succeeds).  Thread-safe;
    ``try_take`` never blocks — quota overflow must shed, not queue, or a
    noisy tenant's backlog would still occupy serving threads.
    """

    def __init__(self, rate: float, burst: Optional[float] = None):
        self.rate = float(rate)
        self.burst = float(burst if burst is not None else max(rate, 1.0))
        self._tokens = self.burst
        self._t = time.monotonic()
        self._lock = threading.Lock()

    def try_take(self, n: float = 1.0) -> bool:
        if self.rate <= 0:
            return True
        with self._lock:
            now = time.monotonic()
            self._tokens = min(
                self.burst, self._tokens + (now - self._t) * self.rate
            )
            self._t = now
            if self._tokens < n:
                return False
            self._tokens -= n
            return True

    def level(self) -> float:
        with self._lock:
            now = time.monotonic()
            self._tokens = min(
                self.burst, self._tokens + (now - self._t) * self.rate
            )
            self._t = now
            return self._tokens


class InflightGauge:
    """Counting cap on concurrently in-flight check units for one tenant.

    Non-blocking by design (see TokenBucket): a tenant over its cap is
    shed immediately, so its flood queues nowhere.  ``cap <= 0``
    disables.
    """

    def __init__(self, cap: int):
        self.cap = int(cap)
        self._inflight = 0
        self._lock = threading.Lock()

    def try_acquire(self, n: int = 1) -> bool:
        if self.cap <= 0:
            return True
        with self._lock:
            if self._inflight + n > self.cap:
                return False
            self._inflight += n
            return True

    def release(self, n: int = 1) -> None:
        if self.cap <= 0:
            return
        with self._lock:
            self._inflight = max(0, self._inflight - n)

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight


class TenantQuotas:
    """One tenant's quota state: inflight units, write rate, tuple cap."""

    def __init__(self, *, inflight: int = 0, write_rate: float = 0.0,
                 max_tuples: int = 0):
        self.inflight = InflightGauge(inflight)
        self.writes = TokenBucket(write_rate)
        self.max_tuples = int(max_tuples)

    def stats(self) -> dict:
        return {
            "inflight": self.inflight.inflight,
            "inflight_cap": self.inflight.cap,
            "write_tokens": round(self.writes.level(), 1),
            "write_rate": self.writes.rate,
            "max_tuples": self.max_tuples,
        }
