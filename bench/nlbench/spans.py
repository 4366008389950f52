"""Self time of the program tracer's spans.

A span's self time is its duration less the part of it that spans nested
in it on the same thread cover. The tracer records complete events (`ph`
"X") with `ts` and `dur` in microseconds; spans on one thread nest."""
from __future__ import annotations

from typing import Iterable, List, Optional


def self_seconds(events: List[dict], names: Iterable[str]) -> Optional[float]:
    """Summed self time, in seconds, of the spans called one of `names`;
    None when there is none."""
    names = set(names)
    by_tid = {}
    for e in events:
        if e.get("ph") == "X":
            by_tid.setdefault(e["tid"], []).append(e)
    total, seen = 0.0, False
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: List[list] = []           # [end_us, self_us, name]
        for e in evs:
            end = e["ts"] + e["dur"]
            while stack and stack[-1][0] <= e["ts"]:
                done = stack.pop()
                if done[2] in names:
                    total += done[1]
                    seen = True
            if stack and end <= stack[-1][0]:
                stack[-1][1] -= e["dur"]
            stack.append([end, e["dur"], e["name"]])
        for done in stack:
            if done[2] in names:
                total += done[1]
                seen = True
    return total / 1e6 if seen else None
