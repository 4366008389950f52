"""I/O–compute pipeline model: double-buffered prefetch across FFN layers.

The paper's online stage (and PowerInfer-2 / LLM-in-a-flash before it) hides
flash latency behind computation: while layer L's FFN is computing, the
predicted neurons of layer L+1 are already being read. This module models that
schedule for the simulated UFS device so the serving engine can report BOTH

  * serial latency      — sum(compute_l + io_l): no overlap, the naive driver;
  * overlapped latency  — the double-buffered schedule below, which in steady
    state costs ~ sum(max(compute_l, io_l)) plus a residual for the first
    read that nothing can hide.

Schedule (prefetch depth 1, one I/O channel, one compute stream):
  * the read for layer l is issued once layer l-1's compute has STARTED
    (its predictor input is available then) and the channel is free;
  * layer l's compute starts when both its read and layer l-1's compute
    have finished.

Invariants (tested): overlapped <= serial, overlapped >= max(sum io,
sum compute), and overlap disabled => overlapped == serial.

MEASURED mode: when the serving engine runs the real prefetch pipeline it
passes per-stage host measurements (`StageMeasurement`) and the per-token
wall clock to `end_token(wall_seconds=...)` — `summary()` then reports the
`measured_*` counterparts next to the analytic model: wall per token, I/O
worker busy time, serving-thread blocked/top-up time, hidden time
(busy − blocked, clamped at 0), and the measured overlap efficiency. The
analytic schedule predicts; the measured columns are what actually happened.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch.obs import get_metrics, get_tracer


@dataclasses.dataclass
class Stage:
    """One pipeline stage: a layer's (read, compute) pair for one token.

    `flops` is the modeled work of the stage; it is only used when the
    caller defers compute timing to `end_token(compute_seconds=...)`, which
    apportions one end-of-token measurement across stages by FLOPs share.
    """
    layer: int
    compute_seconds: float
    io_seconds: float
    flops: float = 0.0


@dataclasses.dataclass
class StageMeasurement:
    """Measured host timings of one pipelined stage (prefetch serving mode).

    `io_host_seconds` is the wall time the background I/O worker spent on the
    stage's begin phase (cache probe + read planning + staging gather);
    `blocked_seconds` is how long the serving thread actually waited for that
    prefetch; `topup_seconds` is the synchronous complete-phase work on the
    serving thread (mis-prediction top-up + admission + attribution).
    """
    io_host_seconds: float = 0.0
    blocked_seconds: float = 0.0
    topup_seconds: float = 0.0


@dataclasses.dataclass
class TokenTiming:
    serial_seconds: float
    overlapped_seconds: float
    n_stages: int
    # total modeled flash I/O across the token's stages; serial_seconds minus
    # this is the token's compute share (the admission predictor's input)
    io_seconds: float = 0.0
    # Measured counterpart (zero unless the caller ran the real prefetch
    # pipeline and passed wall/stage measurements): what actually happened on
    # this host, as opposed to the analytic schedule above.
    measured_wall_seconds: float = 0.0      # real end-to-end token time
    measured_io_busy_seconds: float = 0.0   # worker time spent on I/O stages
    measured_exposed_seconds: float = 0.0   # serving-thread waits + top-ups

    @property
    def hidden_seconds(self) -> float:
        return self.serial_seconds - self.overlapped_seconds

    @property
    def measured_hidden_seconds(self) -> float:
        """I/O host time that did NOT extend the token: worker busy time minus
        the time the serving thread actually spent waiting for it."""
        return max(0.0, self.measured_io_busy_seconds
                   - self.measured_exposed_seconds)

    @property
    def measured_serial_seconds(self) -> float:
        """What this token would have cost with the same work fully serial:
        the measured wall clock plus the I/O host time that was hidden."""
        return self.measured_wall_seconds + self.measured_hidden_seconds


def overlapped_latency(stages: Sequence[Stage]) -> float:
    """End-to-end latency of the double-buffered schedule over `stages`."""
    io_free = 0.0          # when the I/O channel finishes its current read
    compute_end = 0.0      # when the compute stream finishes the current layer
    prev_compute_start = 0.0
    for i, s in enumerate(stages):
        issue_at = 0.0 if i == 0 else prev_compute_start
        io_done = max(io_free, issue_at) + s.io_seconds
        io_free = io_done
        start = max(compute_end, io_done)
        prev_compute_start = start
        compute_end = start + s.compute_seconds
    return compute_end


def serial_latency(stages: Sequence[Stage]) -> float:
    return sum(s.compute_seconds + s.io_seconds for s in stages)


class IOScheduler:
    """Per-token stage recorder + overlap accountant for the serving engine.

    Usage per decode step:
        scheduler.begin_token()
        for each FFN layer: scheduler.record_stage(layer, compute_s, io_s)
        timing = scheduler.end_token()

    `summary()` aggregates over all recorded tokens; with `overlap=False` the
    overlapped latency degenerates to the serial one (the ablation arm of the
    benchmark sweep).
    """

    def __init__(self, overlap: bool = True) -> None:
        self.overlap = overlap
        self.history: List[TokenTiming] = []
        self._stages: List[Stage] = []
        self._measured: List[StageMeasurement] = []

    def begin_token(self) -> None:
        self._stages = []
        self._measured = []

    def record_stage(self, layer: int, compute_seconds: float = 0.0,
                     io_seconds: float = 0.0, flops: float = 0.0,
                     measured: Optional[StageMeasurement] = None) -> None:
        """Record one layer's stage. Callers either pass a measured
        `compute_seconds` directly (legacy per-layer wall clocks, which
        require a host sync per layer), or pass `flops` and defer timing to
        `end_token(compute_seconds=...)` — the sync-free path: XLA dispatch
        runs ahead all token, one end-of-token sync measures the whole token,
        and the measurement is apportioned across stages by FLOPs share.
        The prefetch pipeline additionally passes `measured` host timings so
        `end_token(wall_seconds=...)` can reconcile the analytic schedule
        against what actually happened."""
        self._stages.append(Stage(layer=layer,
                                  compute_seconds=float(compute_seconds),
                                  io_seconds=float(io_seconds),
                                  flops=float(flops)))
        if measured is not None:
            self._measured.append(measured)

    def end_token(self, compute_seconds: Optional[float] = None,
                  wall_seconds: Optional[float] = None) -> TokenTiming:
        if compute_seconds is not None and self._stages:
            total_flops = sum(s.flops for s in self._stages)
            for s in self._stages:
                share = (s.flops / total_flops if total_flops
                         else 1.0 / len(self._stages))
                s.compute_seconds += compute_seconds * share
        serial = serial_latency(self._stages)
        over = overlapped_latency(self._stages) if self.overlap else serial
        timing = TokenTiming(serial_seconds=serial, overlapped_seconds=over,
                             n_stages=len(self._stages),
                             io_seconds=sum(s.io_seconds
                                            for s in self._stages))
        if wall_seconds is not None:
            timing.measured_wall_seconds = float(wall_seconds)
            timing.measured_io_busy_seconds = sum(
                m.io_host_seconds for m in self._measured)
            timing.measured_exposed_seconds = sum(
                m.blocked_seconds + m.topup_seconds for m in self._measured)
        self.history.append(timing)
        self._stages = []
        self._measured = []
        tracer = get_tracer()
        if tracer.enabled:
            # counter tracks in the exported trace, so the Perfetto timeline
            # and BENCH_prefetch.json agree by construction
            tracer.counter("io_model_ms",
                           serial=timing.serial_seconds * 1e3,
                           overlapped=timing.overlapped_seconds * 1e3,
                           io=timing.io_seconds * 1e3)
            if wall_seconds is not None:
                tracer.counter(
                    "io_measured_ms",
                    wall=timing.measured_wall_seconds * 1e3,
                    io_busy=timing.measured_io_busy_seconds * 1e3,
                    exposed=timing.measured_exposed_seconds * 1e3,
                    hidden=timing.measured_hidden_seconds * 1e3)
        return timing

    def predicted_compute_seconds_per_token(self, window: int = 8) -> float:
        """I/O-prediction hook for SLO-aware admission (serving/server.py):
        the compute share of recent tokens — mean (serial − modeled io) over
        the last `window` recorded tokens. The server adds this to the UFS
        model's predicted extent-read seconds for a candidate batch to
        estimate the next step's inter-token latency before admitting into a
        freed slot. Returns 0.0 with no history (cold server: admit freely)."""
        hist = self.history[-window:] if window > 0 else self.history
        if not hist:
            return 0.0
        return sum(t.serial_seconds - t.io_seconds for t in hist) / len(hist)

    def register_metrics(self, registry=None, prefix: str = "scheduler"):
        """Register this scheduler's summary fields as live gauges — the
        measured-mode columns (`wall/busy/exposed/hidden`,
        `overlap_efficiency`) plus the analytic model, all read lazily from
        `summary()` so the registry and the legacy reporting surface cannot
        disagree. Returns the registry used."""
        reg = registry if registry is not None else get_metrics()
        keys = (
            "tokens",
            "overlap_efficiency",
            "serial_seconds_per_token",
            "overlapped_seconds_per_token",
            "hidden_seconds_per_token",
            "measured_wall_seconds_per_token",
            "measured_serial_seconds_per_token",
            "measured_io_busy_seconds_per_token",
            "measured_exposed_seconds_per_token",
            "measured_hidden_seconds_per_token",
            "measured_overlap_efficiency",
        )
        for key in keys:
            reg.register_gauge(f"{prefix}.{key}",
                               lambda k=key: self.summary().get(k, 0.0))
        return reg

    # -- reporting ----------------------------------------------------------
    def summary(self) -> dict:
        n = max(len(self.history), 1)
        serial = sum(t.serial_seconds for t in self.history)
        over = sum(t.overlapped_seconds for t in self.history)
        out = dict(
            tokens=len(self.history),
            overlap_enabled=self.overlap,
            serial_seconds_per_token=serial / n,
            overlapped_seconds_per_token=over / n,
            hidden_seconds_per_token=(serial - over) / n,
            overlap_efficiency=(1.0 - over / serial) if serial > 0 else 0.0,
        )
        wall = sum(t.measured_wall_seconds for t in self.history)
        if wall > 0:           # the real prefetch pipeline ran: report both
            hidden = sum(t.measured_hidden_seconds for t in self.history)
            exposed = sum(t.measured_exposed_seconds for t in self.history)
            busy = sum(t.measured_io_busy_seconds for t in self.history)
            out.update(
                measured_wall_seconds_per_token=wall / n,
                measured_serial_seconds_per_token=(wall + hidden) / n,
                measured_hidden_seconds_per_token=hidden / n,
                measured_exposed_seconds_per_token=exposed / n,
                measured_io_busy_seconds_per_token=busy / n,
                measured_overlap_efficiency=(hidden / (wall + hidden)
                                             if wall + hidden > 0 else 0.0),
            )
        return out

    def reset(self) -> None:
        self.history.clear()
        self._stages = []
        self._measured = []
