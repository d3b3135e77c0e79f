"""Span tracing for the fabric: Chrome trace-event JSON out of any replay.

One module-level tracer (``TRACER``), swapped with ``set_tracer`` /
``trace_to``. The default is a ``NullTracer`` whose every method is a
no-op — instrumentation sites pay one attribute call when tracing is off
(hot sites additionally guard kwarg construction behind
``if TRACER.enabled:``), which the bench-smoke overhead gate keeps honest.

Event model (Chrome trace-event format, loadable in Perfetto /
chrome://tracing):

  * ``span(track, name, start, end)``      -> one "X" complete event
  * ``instant(track, name, ts)``           -> one "i" instant event
  * ``async_begin/async_end(track, name, id, ts)`` -> "b"/"e" pairs, for
    operations that overlap on one track (migration drains keyed by
    tenant).

Tracks are logical timelines ("engine0", "cluster", "controller", …);
each becomes a tid with an "M" thread_name metadata record. Timestamps
are seconds — the replay's virtual clock or ``time.monotonic()`` — and
export as integer microseconds, so a whole scenario browses as a real
timeline. Stdlib only.
"""
from __future__ import annotations

import json
from contextlib import contextmanager
from typing import Dict, List, Optional


class NullTracer:
    """The disabled tracer: every hook is an attribute call + pass."""

    enabled = False

    def span(self, track, name, start, end, **args) -> None:
        pass

    def instant(self, track, name, ts, **args) -> None:
        pass

    def async_begin(self, track, name, event_id, ts, **args) -> None:
        pass

    def async_end(self, track, name, event_id, ts, **args) -> None:
        pass

    def counters(self) -> Dict[str, float]:
        return {}


class Tracer(NullTracer):
    """Recording tracer: accumulates Chrome trace events in memory.

    ``ts`` values are seconds (virtual or wall; the tracer does not care
    which — callers pass whatever ``now`` they run on). Export multiplies
    into integer microseconds as the trace-event format expects.
    """

    enabled = True
    PID = 1

    def __init__(self):
        self.events: List[dict] = []
        self._tids: Dict[str, int] = {}

    # -- recording ----------------------------------------------------------
    def _tid(self, track: str) -> int:
        tid = self._tids.get(track)
        if tid is None:
            tid = self._tids[track] = len(self._tids) + 1
            self.events.append({
                "name": "thread_name", "ph": "M", "pid": self.PID,
                "tid": tid, "args": {"name": track}})
        return tid

    def _emit(self, ph: str, track: str, name: str, ts: float,
              args: dict, **extra) -> None:
        ev = {"name": name, "ph": ph, "pid": self.PID,
              "tid": self._tid(track), "ts": round(float(ts) * 1e6)}
        if args:
            ev["args"] = args
        ev.update(extra)
        self.events.append(ev)

    def span(self, track, name, start, end, **args) -> None:
        dur = round((float(end) - float(start)) * 1e6)
        self._emit("X", track, name, start, args, dur=max(0, dur))

    def instant(self, track, name, ts, **args) -> None:
        self._emit("i", track, name, ts, args, s="t")

    def async_begin(self, track, name, event_id, ts, **args) -> None:
        self._emit("b", track, name, ts, args, cat=track,
                   id=str(event_id))

    def async_end(self, track, name, event_id, ts, **args) -> None:
        self._emit("e", track, name, ts, args, cat=track,
                   id=str(event_id))

    # -- export -------------------------------------------------------------
    def chrome_trace(self) -> dict:
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms"}

    def to_json(self) -> str:
        return json.dumps(self.chrome_trace(), indent=1, sort_keys=True)

    def write(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    def counters(self) -> Dict[str, float]:
        return {"nk_trace_events_total": float(
            sum(1 for e in self.events if e["ph"] != "M"))}


TRACER: NullTracer = NullTracer()


def get_tracer() -> NullTracer:
    return TRACER


def set_tracer(tracer: Optional[NullTracer]) -> NullTracer:
    """Install ``tracer`` (or the null tracer when None); returns the
    previously installed one so callers can restore it."""
    global TRACER
    prev = TRACER
    TRACER = tracer if tracer is not None else NullTracer()
    return prev


@contextmanager
def trace_to(tracer: Optional[Tracer] = None):
    """Install a recording tracer for the duration of a block::

        with trace_to() as tr:
            replay_scenario("migration", ...)
        tr.write("migration.trace.json")
    """
    tr = tracer if tracer is not None else Tracer()
    prev = set_tracer(tr)
    try:
        yield tr
    finally:
        set_tracer(prev)
