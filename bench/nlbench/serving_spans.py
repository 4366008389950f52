"""The program's spans on its serving thread, for the readers of host time.

The serving thread is the lane that holds the `step` spans (the one with
the most of them, should another lane hold any). The `req <uid>` lanes
hold copies of `prefill` and `decode` and are left out. A span's time on
the host clock is `view.tracer_base` plus its `ts`; a span is in the
window when it starts in [`view.t0`, `view.t1`]."""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import List


@dataclasses.dataclass
class Span:
    name: str
    a: float          # start, host perf seconds
    b: float          # end
    args: dict

    @property
    def seconds(self) -> float:
        return self.b - self.a


def serving_spans(view) -> List[Span]:
    """Every complete span of the serving thread, sorted by start; empty
    when the run kept no spans."""
    events = [e for e in view.spans or [] if e.get("ph") == "X"]
    lanes = Counter(e["tid"] for e in events if e["name"] == "step")
    if not lanes:
        return []
    tid = lanes.most_common(1)[0][0]
    base = view.tracer_base
    out = [Span(e["name"], base + e["ts"] / 1e6,
                base + (e["ts"] + e["dur"]) / 1e6, e.get("args") or {})
           for e in events if e["tid"] == tid]
    out.sort(key=lambda s: (s.a, -s.b))
    return out


def in_window(view, spans: List[Span], *names: str) -> List[Span]:
    """The spans called one of `names` that start in the window."""
    return [s for s in spans
            if s.name in names and view.t0 <= s.a <= view.t1]
