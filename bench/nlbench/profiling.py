"""The device profile of a stretch of steps inside a traced run's window.

`torch.profiler` with CUDA activity alone records every kernel, copy and
fill the card ran. Busy time is the union of those intervals; the window
is the host clock from before the first launch to after the closing
synchronise. A one-element fill is launched first, so that its device
timestamp ties the device's clock to the host's. Idle time a little way
from each edge is left on both sides: near an edge the profiler has been
seen to drop launches or count earlier ones.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, List, Optional

EDGE_S = 0.05
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profile_steps(loop, n: int, device) -> tuple:
    """Run `n` steps of `loop` under the profiler. Returns what
    `load_profile` reads once the window has closed (the trace is exported
    and parsed outside the window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    marker = torch.zeros(1, device=device)
    torch.cuda.synchronize(device)
    steps = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(EDGE_S)
        torch.cuda.synchronize(device)
        h0 = time.perf_counter()
        marker.fill_(1.0)
        for _ in range(n):
            steps.append(loop.step_idx)
            loop.pump()
        torch.cuda.synchronize(device)
        h1 = time.perf_counter()
        time.sleep(EDGE_S)
    return prof, h0, h1, steps


def load_profile(raw: tuple):
    """The `Profile` of a `profile_steps` stretch: its device events, busy
    time and the tie between the device's clock and the host's."""
    from nlbench.harness import Profile
    prof, h0, h1, steps = raw
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    ev = sorted(((e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
                 for e in trace.get("traceEvents", [])
                 if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
                key=lambda e: e[1])
    fills = [e for e in ev if "fill" in e[0].lower()]
    to_host = h0 - (fills[0][1] / 1e6 if fills else (ev[0][1] / 1e6 if ev else 0))
    kernels = [e for e in ev if h0 <= to_host + e[1] / 1e6 <= h1]
    return Profile(host_t0=h0, host_t1=h1, steps=steps, kernels=kernels,
                   busy_s=busy_seconds(kernels), window_s=h1 - h0,
                   to_host=to_host)


def merged(kernels: List[tuple]) -> List[List[float]]:
    """Device busy intervals [start_us, end_us], overlaps merged."""
    out: List[List[float]] = []
    for _, ts, dur in sorted(kernels, key=lambda e: e[1]):
        if out and ts <= out[-1][1]:
            out[-1][1] = max(out[-1][1], ts + dur)
        else:
            out.append([ts, ts + dur])
    return out


def busy_seconds(kernels: List[tuple]) -> float:
    return sum(b - a for a, b in merged(kernels)) / 1e6


def _short(name: str) -> str:
    return name if len(name) <= 96 else name[:93] + "..."


def breakdown(prof, spans: Optional[List[dict]], tracer_base: float,
              tid: int) -> Dict:
    """The device ops that took most time, and the idle time by what the
    host was doing (the innermost program span of the serving thread `tid`
    around each gap's middle; "no span" where the program's tracer had none
    open)."""
    by_op: Dict[str, float] = {}
    for name, _, dur in prof.kernels:
        by_op[_short(name)] = by_op.get(_short(name), 0.0) + dur / 1e6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]

    busy = merged(prof.kernels)
    edges = [(prof.host_t0 - prof.to_host) * 1e6] + \
        [x for iv in busy for x in iv] + [(prof.host_t1 - prof.to_host) * 1e6]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    host = []
    for e in spans or []:
        if e.get("ph") == "X" and e["tid"] == tid:
            a = tracer_base + e["ts"] / 1e6
            b = a + e["dur"] / 1e6
            if b >= prof.host_t0 and a <= prof.host_t1:
                host.append((a, b, e["name"]))
    by_span: Dict[str, float] = {}
    for g0, g1 in gaps:
        mid = prof.to_host + (g0 + g1) / 2e6
        inner = [(b - a, n) for a, b, n in host if a <= mid <= b]
        label = min(inner)[1] if inner else "no span"
        by_span[label] = by_span.get(label, 0.0) + (g1 - g0) / 1e6
    idle = sorted(by_span.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in idle]}
