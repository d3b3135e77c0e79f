"""Token buckets: the per-tenant rate limiter of the CoreEngine switch.

The serving scheduler prices requests against these buckets (paper
Fig. 21). ``CoreEngine`` itself (routing, ledgers, the bytes plane) comes
with a later slice of the port.
"""
from __future__ import annotations

import math
import time
from typing import Dict, Optional


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s, burst up to ``capacity``.

    Tokens are bytes (or request units). ``consume`` returns True if admitted;
    ``wait_time`` reports how long until ``n`` tokens would be available —
    the scheduler uses it for work-conserving backfill.
    """

    def __init__(self, rate: float, capacity: float):
        self.rate = float(rate)
        self.capacity = float(capacity)
        self.tokens = float(capacity)
        self.updated = 0.0

    def _refill(self, now: float):
        if now > self.updated:
            self.tokens = min(self.capacity,
                              self.tokens + (now - self.updated) * self.rate)
            self.updated = now

    def consume(self, n: float, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        self._refill(now)
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def drain(self, n: float, now: Optional[float] = None) -> float:
        """Fluid admission: take up to ``n`` tokens, never going negative.

        Returns the amount actually admitted. CoreEngine enforcement uses
        this (a collective's bytes are a divisible stream, unlike a request,
        which is admitted whole or not at all via ``consume``).
        """
        now = time.monotonic() if now is None else now
        self._refill(now)
        take = min(float(n), max(self.tokens, 0.0))
        self.tokens -= take
        return take

    def wait_time(self, n: float, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        self._refill(now)
        if self.tokens >= n:
            return 0.0
        if self.rate <= 0.0:
            return math.inf          # hard-blocked tenant: never admissible
        return (n - self.tokens) / self.rate

    def set_rate(self, rate: float, burst: Optional[float] = None,
                 now: Optional[float] = None) -> None:
        """Retarget the bucket mid-run, preserving accumulated tokens.

        Settles the balance at the old rate first so a controller pushing
        updates does not retroactively re-price the elapsed interval.
        """
        now = time.monotonic() if now is None else now
        self._refill(now)
        self.rate = float(rate)
        if burst is not None:
            self.capacity = float(burst)
            self.tokens = min(self.tokens, self.capacity)

    # -- migration support -------------------------------------------------
    def snapshot(self, now: Optional[float] = None) -> Dict[str, float]:
        """Return the bucket's transferable state: ``{rate, capacity,
        tokens, updated}`` (units/s, units, units, seconds), settling the
        balance at ``now`` first when given (``None`` keeps the last
        settled level and its timestamp).

        The enforcement-point half of live tenant migration: the level a
        tenant has already burned down travels with it, so moving between
        enforcement points can never reopen a fresh burst.
        """
        if now is not None:
            self._refill(now)
        return {"rate": self.rate, "capacity": self.capacity,
                "tokens": self.tokens, "updated": self.updated}

    @classmethod
    def restore(cls, state: Dict[str, float],
                now: Optional[float] = None) -> "TokenBucket":
        """Rebuild a bucket from ``snapshot()`` output, anchored at ``now``
        so refill resumes from the transfer instant. ``None`` keeps the
        snapshot's own timestamp — the right choice when the caller's
        clock is unknown (virtual-clock replays must NOT be anchored to
        the wall clock, which would freeze refill forever)."""
        b = cls(state["rate"], state["capacity"])
        b.tokens = min(float(state["tokens"]), b.capacity)
        b.updated = float(state.get("updated", 0.0)) if now is None \
            else float(now)
        return b
