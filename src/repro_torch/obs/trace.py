"""Low-overhead tracing with Chrome trace-event / Perfetto JSON export.

Design goals:

- **Thread-safe without hot-path locks.** Each thread records into its own
  fixed-capacity ring buffer; the only lock guards ring *creation* and
  export-time iteration. A thread's lane (``tid``) is its
  ``threading.get_ident()``; a thread that reuses a finished thread's ident
  gets a synthetic lane, so no ring is ever replaced.
- **Zero work when disabled.** The module-level tracer defaults to a shared
  :class:`NullTracer` whose ``span``/``instant``/``counter`` methods do
  nothing and return a shared no-op context manager, so call sites never
  branch on "is tracing on?".
- **Perfetto-compatible export.** ``export()`` emits Chrome trace-event JSON
  (``ph:"X"`` complete spans, ``ph:"i"`` instants, ``ph:"C"`` counter
  tracks, ``ph:"M"`` thread-name metadata) that loads directly in
  https://ui.perfetto.dev or ``chrome://tracing``.

Timestamps come from ``time.perf_counter`` (monotonic), rebased to the
tracer's construction time and expressed in microseconds, which is the unit
the trace-event format expects.

Virtual tracks: ``complete(..., track="req 7")`` and
``instant(..., track=...)`` place events on a named synthetic thread lane
instead of the calling thread's lane.  The server uses this to give every
request its own row of per-token decode spans.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "get_tracer",
    "set_tracer",
    "enable_tracing",
    "disable_tracing",
]

# Synthetic tids for named virtual tracks start here so they never collide
# with real thread idents in practice (and collisions would only merge lanes
# in the viewer, never corrupt data).
_TRACK_TID_BASE = 1_000_000
# Synthetic tids for threads that reuse a finished thread's ident: the first
# thread with an ident keeps it as its tid, later ones get a lane from here.
_REUSED_TID_BASE = 2_000_000

# Event tuple layout: (ts_us, dur_us_or_None, ph, name, tid, args_or_None)
_Event = Tuple[float, Optional[float], str, str, int, Optional[dict]]


class _Ring:
    """Fixed-capacity single-writer ring buffer of trace events."""

    __slots__ = ("cap", "buf", "idx", "total")

    def __init__(self, cap: int):
        self.cap = int(cap)
        self.buf: List[Optional[_Event]] = [None] * self.cap
        self.idx = 0
        self.total = 0

    def append(self, ev: _Event) -> None:
        self.buf[self.idx] = ev
        self.idx += 1
        if self.idx == self.cap:
            self.idx = 0
        self.total += 1

    def events(self) -> List[_Event]:
        if self.total <= self.cap:
            return [e for e in self.buf[: self.total] if e is not None]
        # Oldest event sits at idx (the next overwrite target).
        out = self.buf[self.idx :] + self.buf[: self.idx]
        return [e for e in out if e is not None]

    @property
    def dropped(self) -> int:
        return max(0, self.total - self.cap)


class _Span:
    """Context manager recording a ``ph:"X"`` complete event on exit.

    ``set(**kw)`` attaches late args (values only known mid-span, e.g. extent
    counts after a read returns).
    """

    __slots__ = ("_tracer", "name", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.args = args

    def set(self, **kw: Any) -> None:
        if self.args is None:
            self.args = kw
        else:
            self.args.update(kw)

    def __enter__(self) -> "_Span":
        self._t0 = self._tracer.now()
        return self

    def __exit__(self, *exc: Any) -> bool:
        t1 = self._tracer.now()
        self._tracer._emit(self._t0, t1 - self._t0, "X", self.name, self.args)
        return False


class Tracer:
    """Records spans/instants/counters into per-thread ring buffers."""

    enabled = True

    def __init__(
        self,
        capacity_per_thread: int = 65536,
        clock: Callable[[], float] = time.perf_counter,
    ):
        if capacity_per_thread < 1:
            raise ValueError("capacity_per_thread must be >= 1")
        self.capacity_per_thread = int(capacity_per_thread)
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        # tid -> (ring, thread name at first event); a ring is never replaced
        self._rings: Dict[int, Tuple[_Ring, str]] = {}
        self._n_reused = 0
        self._tracks: Dict[str, int] = {}
        self._local = threading.local()
        self.pid = os.getpid()
        # name -> values kept until taken (`keep` / `take`)
        self._kept: Dict[str, List[Any]] = {}

    # -- clock ---------------------------------------------------------------

    def now(self) -> float:
        """Microseconds since tracer construction (monotonic)."""
        return (self._clock() - self._t0) * 1e6

    # -- recording -----------------------------------------------------------

    def _ring(self) -> _Ring:
        ring = getattr(self._local, "ring", None)
        if ring is None:
            tid = threading.get_ident()
            ring = _Ring(self.capacity_per_thread)
            with self._lock:
                if tid in self._rings:
                    # a finished thread's ident came back: keep its ring
                    # and give this thread a lane of its own
                    tid = _REUSED_TID_BASE + self._n_reused
                    self._n_reused += 1
                self._rings[tid] = (ring, threading.current_thread().name)
            self._local.ring = ring
            self._local.tid = tid
        return ring

    def _emit(
        self,
        ts_us: float,
        dur_us: Optional[float],
        ph: str,
        name: str,
        args: Optional[dict],
        tid: Optional[int] = None,
    ) -> None:
        ring = self._ring()
        if tid is None:
            tid = self._local.tid
        ring.append((ts_us, dur_us, ph, name, tid, args))

    def _track_tid(self, track: str) -> int:
        tid = self._tracks.get(track)
        if tid is None:
            with self._lock:
                tid = self._tracks.setdefault(
                    track, _TRACK_TID_BASE + len(self._tracks)
                )
        return tid

    def span(self, name: str, **args: Any) -> _Span:
        """Context manager timing a block as a complete event."""
        return _Span(self, name, args or None)

    def complete(
        self,
        name: str,
        start_us: float,
        end_us: float,
        track: Optional[str] = None,
        **args: Any,
    ) -> None:
        """Record a retrospective span from explicit ``now()`` timestamps."""
        tid = self._track_tid(track) if track is not None else None
        self._emit(start_us, max(0.0, end_us - start_us), "X", name, args or None, tid=tid)

    def instant(self, name: str, track: Optional[str] = None, **args: Any) -> None:
        tid = self._track_tid(track) if track is not None else None
        self._emit(self.now(), None, "i", name, args or None, tid=tid)

    def counter(self, name: str, **values: float) -> None:
        """Record a point on a counter track (stacked area chart in Perfetto)."""
        self._emit(self.now(), None, "C", name, values)

    def keep(self, name: str, value: Any) -> None:
        """Hold `value` under `name` until `take(name)`: a value the traced
        code has not read yet (a device tensor, read after the step's own
        sync). One thread keeps and takes a name."""
        self._kept.setdefault(name, []).append(value)

    def take(self, name: str) -> List[Any]:
        """The values kept under `name` since the last take, oldest first."""
        return self._kept.pop(name, [])

    # -- introspection -------------------------------------------------------

    @property
    def n_events(self) -> int:
        with self._lock:
            return sum(r.total for r, _ in self._rings.values())

    @property
    def dropped(self) -> int:
        with self._lock:
            return sum(r.dropped for r, _ in self._rings.values())

    # -- export --------------------------------------------------------------

    def events(self) -> List[dict]:
        """All retained events as trace-event dicts, sorted by timestamp.

        Thread-name metadata (``ph:"M"``) rows come first so viewers label
        lanes.  Safe to call while other threads are still recording; events
        appended concurrently may or may not be included.
        """
        with self._lock:
            rings = list(self._rings.items())
            tracks = dict(self._tracks)
        out: List[dict] = []
        for tid, (_, tname) in rings:
            out.append(
                {
                    "ph": "M",
                    "name": "thread_name",
                    "pid": self.pid,
                    "tid": tid,
                    "args": {"name": tname},
                }
            )
        for track, tid in tracks.items():
            out.append(
                {
                    "ph": "M",
                    "name": "thread_name",
                    "pid": self.pid,
                    "tid": tid,
                    "args": {"name": track},
                }
            )
        body: List[dict] = []
        for tid, (ring, _) in rings:
            for ts_us, dur_us, ph, name, ev_tid, args in ring.events():
                ev: dict = {
                    "name": name,
                    "ph": ph,
                    "ts": ts_us,
                    "pid": self.pid,
                    "tid": ev_tid,
                }
                if ph == "X":
                    ev["dur"] = dur_us if dur_us is not None else 0.0
                elif ph == "i":
                    ev["s"] = "t"
                if args:
                    ev["args"] = args
                body.append(ev)
        body.sort(key=lambda e: e["ts"])
        return out + body

    def export(self, path: Optional[str] = None) -> List[dict]:
        """Export events; if ``path`` is given, write Perfetto-loadable JSON."""
        events = self.events()
        if path is not None:
            doc = {
                "traceEvents": events,
                "displayTimeUnit": "ms",
                "otherData": {"producer": "repro_torch.obs", "dropped_events": self.dropped},
            }
            with open(path, "w") as f:
                json.dump(doc, f)
        return events


class _NullSpan:
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def set(self, **kw: Any) -> None:
        pass


_NULL_SPAN = _NullSpan()


class NullTracer:
    """No-op tracer: the default so instrumentation sites never branch."""

    enabled = False
    capacity_per_thread = 0
    pid = 0
    n_events = 0
    dropped = 0

    def now(self) -> float:
        return 0.0

    def span(self, name: str, **args: Any) -> _NullSpan:
        return _NULL_SPAN

    def complete(self, *a: Any, **kw: Any) -> None:
        pass

    def instant(self, *a: Any, **kw: Any) -> None:
        pass

    def counter(self, *a: Any, **kw: Any) -> None:
        pass

    def keep(self, *a: Any, **kw: Any) -> None:
        pass

    def take(self, name: str) -> List[Any]:
        return []

    def events(self) -> List[dict]:
        return []

    def export(self, path: Optional[str] = None) -> List[dict]:
        return []


NULL_TRACER = NullTracer()

_TRACER: Any = NULL_TRACER


def get_tracer() -> Any:
    """The process-global tracer (a :class:`NullTracer` unless enabled)."""
    return _TRACER


def set_tracer(tracer: Optional[Any]) -> Any:
    """Install ``tracer`` globally (None → null tracer); returns the previous one."""
    global _TRACER
    prev = _TRACER
    _TRACER = tracer if tracer is not None else NULL_TRACER
    return prev


def enable_tracing(capacity_per_thread: int = 65536) -> Tracer:
    """Install and return a fresh recording :class:`Tracer`."""
    tracer = Tracer(capacity_per_thread=capacity_per_thread)
    set_tracer(tracer)
    return tracer


def disable_tracing() -> Any:
    """Restore the null tracer; returns the tracer that was active."""
    return set_tracer(NULL_TRACER)
