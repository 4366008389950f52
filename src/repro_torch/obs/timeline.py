"""Per-request timeline view for SLO debugging.

``request_timeline(handle)`` folds a :class:`RequestHandle`'s lifecycle
stamps (queued/admitted/first-token/finished on the server's monotonic
clock) and per-token stamps into a phase breakdown, and — when a recording
tracer is active — attaches the trace spans tagged with the request's uid.

All phase times are SECONDS RELATIVE TO ``queued_at`` (the handle's clock),
independent of the tracer's microsecond clock; the attached spans keep the
tracer's own timebase so they can be cross-referenced with an exported
trace.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from repro_torch.obs.trace import get_tracer

__all__ = ["request_timeline"]


def request_timeline(handle: Any, tracer: Optional[Any] = None) -> Dict[str, Any]:
    """Build a timeline dict for one request handle.

    Keys: ``uid``, ``finish_reason``, ``phases`` (name -> {start, end,
    seconds}, relative to queued_at), ``ttft``, ``tokens`` (per-token
    {t, gap}), ``itl`` (count/mean/max inter-token gap), ``slo``
    (resolved ttft/itl SLOs + whether each was met), and ``spans`` (trace
    events whose args carry this uid, empty when tracing is disabled).
    """
    tr = tracer if tracer is not None else get_tracer()
    q = handle.queued_at
    rel = lambda t: None if t is None else t - q  # noqa: E731

    phases: Dict[str, Dict[str, Optional[float]]] = {}

    def phase(name: str, start: Optional[float], end: Optional[float]) -> None:
        if start is None:
            return
        phases[name] = {
            "start": rel(start),
            "end": rel(end),
            "seconds": None if end is None else end - start,
        }

    phase("queued", q, handle.admitted_at if handle.admitted_at is not None
          else handle.finished_at)
    if handle.admitted_at is not None:
        phase("prefill", handle.admitted_at, handle.first_token_at)
    if handle.first_token_at is not None:
        phase("decode", handle.first_token_at, handle.finished_at)

    token_times: List[float] = list(handle.token_times)
    tokens = []
    gaps = []
    prev = None
    for t in token_times:
        gap = None if prev is None else t - prev
        if gap is not None:
            gaps.append(gap)
        tokens.append({"t": rel(t), "gap": gap})
        prev = t

    ttft = (handle.first_token_at - q
            if handle.first_token_at is not None else None)
    itl = {
        "count": len(gaps),
        "mean": sum(gaps) / len(gaps) if gaps else None,
        "max": max(gaps) if gaps else None,
    }
    slo = {
        "ttft_slo": handle.ttft_slo,
        "itl_slo": handle.itl_slo,
        "ttft_met": (None if handle.ttft_slo is None or ttft is None
                     else ttft <= handle.ttft_slo),
        "itl_met": (None if handle.itl_slo is None or not gaps
                    else max(gaps) <= handle.itl_slo),
    }

    uid = handle.uid
    spans = [ev for ev in tr.events()
             if ev.get("args", {}).get("uid") == uid]

    return {
        "uid": uid,
        "state": handle.state.value,
        "finish_reason": handle.finish_reason,
        "n_tokens": len(handle.tokens),
        "phases": phases,
        "ttft": ttft,
        "total": rel(handle.finished_at),
        "tokens": tokens,
        "itl": itl,
        "slo": slo,
        "io_seconds": handle.io_seconds,
        "prefill_seconds": handle.prefill_seconds,
        "decode_seconds": handle.decode_seconds,
        "spans": spans,
    }
