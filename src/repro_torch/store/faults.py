"""Deterministic fault injection for the flash-serving path (a copy of the
reference's `store/faults.py`: the same schedules from the same seeds, the
same counters). A `fatal` fault propagates out of the read: on the serving
thread it ends the step; on the prefetch worker it kills the thread, and
the offload runtime's supervision restarts it and serves the lost layer
synchronously.

The paper's premise is that decode latency is dominated by flash I/O on
IOPS-constrained smartphones — exactly the environment where reads are
flaky: UFS latency spikes under thermal throttling, transient EIO under
controller contention, torn sectors on worn flash. This module gives the
repo a reproducible way to make the storage layer misbehave so the
fault-tolerance machinery (retry + CRC verification in `FileNeuronStore`,
prefetch-worker supervision in `serving.engine`, per-request error
isolation in `serving.server`) can be tested and benchmarked under a
*seed-driven, exactly replayable* schedule.

Fault model — five kinds, keyed by (read_index, attempt):

  transient   the read attempt raises `TransientIOError` (errno EIO); the
              store's bounded-backoff retry loop is expected to absorb it.
  latency     the attempt completes but only after `delay_s` of extra wall
              time (a thermal-throttle spike; correctness-neutral).
  short_read  the first `pread` of the attempt returns a truncated chunk,
              forcing the store's short-read continuation loop to make
              follow-up reads (exercises an otherwise OS-dependent branch).
  corrupt     the attempt's payload comes back with deterministically
              flipped bits. Invisible without checksums; with a v2 pack and
              `verify_checksums=True` the per-bundle CRC32 catches it and
              triggers a re-read.
  fatal       the attempt raises `FatalFault` — deliberately a
              `BaseException`, so the prefetch worker's per-job `Exception`
              handler cannot absorb it and the worker THREAD dies. This is
              the chaos suite's worker-death vector; the runtime's
              supervision (restart budget + synchronous fallback) is what
              keeps decode alive.

`read_index` counts logical extent reads per store (one per collapsed
extent, advancing once per read, NOT per retry attempt), so a schedule
addresses "the 7th extent read this store performs" regardless of timing,
threads, or how many retries earlier faults caused. `attempt` is the
retry ordinal within one logical read (0 = first try); an event with
`times=t` affects attempts 0..t-1, so `times=2` means "fail twice, then
succeed" — recoverable by any retry budget >= 2.

Two injection sites share the schedule vocabulary:

  * `FileNeuronStore(..., fault_plan=plan)` injects *below* the retry /
    verification layer — the recoverable path. A transient costs a retry,
    a corrupt extent costs a detection + re-read, and decode output is
    bit-identical to the clean run.
  * `FaultInjectingStore(inner, plan)` wraps ANY store (including the
    in-memory `NeuronStore`) at the `_serve_extents` boundary with NO
    retry layer in between — the unrecoverable path, used to prove that a
    failing request is isolated (`finish_reason="error"`) while the rest
    of the batch keeps decoding.

Every applied event is counted in `FaultPlan.injected`, which is the
ground truth the acceptance tests compare `IOStats.retries` /
`corrupt_extents` against.
"""
from __future__ import annotations

import dataclasses
import errno
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.collapse import Extent
from repro_torch.core.storage import IOStats, NeuronStore


class TransientIOError(OSError):
    """Injected retryable read failure (modeled as errno EIO)."""

    def __init__(self, message: str) -> None:
        super().__init__(errno.EIO, message)


class CorruptExtentError(IOError):
    """A CRC-verified extent read stayed corrupt through every re-read."""


class FatalFault(BaseException):
    """Injected *thread-killing* fault.

    Deliberately NOT an `Exception`: per-job exception handlers (the
    prefetch worker's) let it through, so raising it on the worker thread
    kills the thread — the realistic 'worker died mid-decode' failure the
    supervision machinery must survive.
    """


#: OSError errnos the retry loop treats as transient. Anything else
#: (ENOENT, EBADF, a genuine EOF short read...) propagates immediately —
#: retrying cannot fix a missing file.
RETRYABLE_ERRNOS = frozenset(
    {errno.EIO, errno.EAGAIN, errno.EINTR, errno.ETIMEDOUT})


def is_retryable(exc: BaseException) -> bool:
    """True for OSErrors a bounded retry can plausibly absorb."""
    return isinstance(exc, OSError) and exc.errno in RETRYABLE_ERRNOS


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff for transient extent-read failures.

    `max_retries` counts RE-reads after the first attempt (so a read is
    tried at most `max_retries + 1` times). Backoff for the i-th retry is
    `backoff_s * backoff_mult**i`, capped at `max_backoff_s`; tests set
    `backoff_s=0` to retry instantly.
    """
    max_retries: int = 3
    backoff_s: float = 1e-3
    backoff_mult: float = 2.0
    max_backoff_s: float = 0.05

    def backoff(self, retry_index: int) -> float:
        if self.backoff_s <= 0:
            return 0.0
        return min(self.backoff_s * self.backoff_mult ** retry_index,
                   self.max_backoff_s)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: `kind` applied to the first `times` attempts of
    logical read `read_index` (latency events carry `delay_s`)."""
    read_index: int
    kind: str                    # transient|latency|short_read|corrupt|fatal
    times: int = 1
    delay_s: float = 0.0

    KINDS = ("transient", "latency", "short_read", "corrupt", "fatal")

    def __post_init__(self) -> None:
        if self.kind not in self.KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {self.KINDS})")


class FaultPlan:
    """A reproducible fault schedule plus ground-truth injection counters.

    Thread-safe: the prefetch worker and the serving thread may both drive
    reads against the same plan. `injected[kind]` counts events actually
    APPLIED (a planned event whose read index is never reached counts
    zero), which is what makes `retries == injected['transient'] +
    injected['corrupt']` an exact acceptance criterion rather than an
    upper bound.
    """

    def __init__(self, events: Sequence[FaultEvent] = (), seed: int = 0) -> None:
        self._events: Dict[int, List[FaultEvent]] = {}
        for ev in events:
            self._events.setdefault(ev.read_index, []).append(ev)
        self.seed = seed
        self.injected: Dict[str, int] = {k: 0 for k in FaultEvent.KINDS}
        self._lock = threading.Lock()

    @classmethod
    def seeded(
        cls,
        seed: int,
        n_reads: int,
        *,
        transient_rate: float = 0.0,
        transient_times: int = 1,
        latency_rate: float = 0.0,
        delay_s: float = 2e-3,
        short_read_rate: float = 0.0,
        corrupt_rate: float = 0.0,
        fatal_reads: Sequence[int] = (),
    ) -> "FaultPlan":
        """Draw a schedule over the first `n_reads` logical reads: each read
        independently gets each fault kind at its rate (one uniform draw per
        (read, kind), fixed by `seed` — the same arguments always produce
        the same schedule). `fatal_reads` pins thread-killing faults at
        explicit read indices."""
        rng = np.random.default_rng(seed)
        draws = rng.random((max(int(n_reads), 0), 4))
        events: List[FaultEvent] = []
        for i in range(draws.shape[0]):
            if draws[i, 0] < transient_rate:
                events.append(FaultEvent(i, "transient", times=transient_times))
            if draws[i, 1] < latency_rate:
                events.append(FaultEvent(i, "latency", delay_s=delay_s))
            if draws[i, 2] < short_read_rate:
                events.append(FaultEvent(i, "short_read"))
            if draws[i, 3] < corrupt_rate:
                events.append(FaultEvent(i, "corrupt"))
        for i in fatal_reads:
            events.append(FaultEvent(int(i), "fatal"))
        return cls(events, seed=seed)

    def events_at(self, read_index: int) -> List[FaultEvent]:
        return self._events.get(read_index, [])

    @property
    def n_events(self) -> int:
        return sum(len(v) for v in self._events.values())

    def active(self, read_index: int, attempt: int) -> List[FaultEvent]:
        """Events applying to attempt `attempt` of read `read_index`,
        recorded into `injected` (call once per attempt — the caller then
        MUST apply every returned event)."""
        out = [ev for ev in self.events_at(read_index) if attempt < ev.times]
        if out:
            with self._lock:
                for ev in out:
                    self.injected[ev.kind] += 1
        return out

    def corrupt_payload(self, buf: bytearray, read_index: int) -> None:
        """Flip one bit at each of three deterministic positions of `buf`
        (keyed on (seed, read_index) so re-reads of a *transiently* corrupt
        extent see clean bytes, while tests can replay the exact damage)."""
        if not len(buf):
            return
        rng = np.random.default_rng((self.seed, read_index))
        for pos in rng.integers(0, len(buf), size=3):
            buf[int(pos)] ^= 1 << int(rng.integers(0, 8))


def seeded_layer_plans(seed: int, n_layers: int, n_reads: int,
                       **rates) -> List[FaultPlan]:
    """One independent seeded plan per layer store (layer l draws from
    `seed + l`), the shape `OffloadedFFNRuntime.from_pack(fault_plans=...)`
    expects."""
    return [FaultPlan.seeded(seed + l, n_reads, **rates)
            for l in range(n_layers)]


class FaultInjectingStore(NeuronStore):
    """Wrap ANY `NeuronStore` with a fault schedule at the extent-read
    boundary — with NO retry/verification layer in between, so every
    injected fault surfaces to the caller exactly as a failing device
    would. This is the unrecoverable-path harness: transients here
    propagate out of `read()` (isolation tests), fatals kill whichever
    thread made the read (supervision tests).

    DRAM-side surfaces (`fetch` / `fetch_into` / scales) delegate
    untouched; only `_serve_extents` — the flash-read path — is faulted.
    Corruption applies to the returned payload when one is requested
    (`fetch_payload=True`); payload-free accounting reads have no bytes to
    damage, so corrupt events are only counted when they actually bite.
    """

    def __init__(self, inner: NeuronStore, plan: FaultPlan) -> None:
        # no super().__init__: every NeuronStore attribute mirrors `inner`
        # so engines built over the wrapper plan reads identically.
        self.inner = inner
        self.plan = plan
        self.n_neurons = inner.n_neurons
        self.bundle_width = inner.bundle_width
        self.placement = inner.placement
        self.device = inner.device
        self.reads_per_bundle = inner.reads_per_bundle
        self.bundle_bytes = inner.bundle_bytes
        self.quantized = inner.quantized
        self._read_index = 0
        self._index_lock = threading.Lock()

    # -- delegated payload surface ------------------------------------------
    @property
    def payload_dtype(self) -> np.dtype:
        return self.inner.payload_dtype

    @property
    def stored_dtype(self) -> np.dtype:
        return self.inner.stored_dtype

    def physical_payload(self, dequantize: bool = True) -> np.ndarray:
        return self.inner.physical_payload(dequantize)

    def physical_scales(self) -> Optional[np.ndarray]:
        return self.inner.physical_scales()

    def fetch(self, logical_ids: np.ndarray) -> np.ndarray:
        return self.inner.fetch(logical_ids)

    def fetch_into(self, logical_ids: np.ndarray, out: np.ndarray) -> np.ndarray:
        return self.inner.fetch_into(logical_ids, out)

    def fetch_scales_into(self, logical_ids: np.ndarray,
                          out: np.ndarray) -> np.ndarray:
        return self.inner.fetch_scales_into(logical_ids, out)

    def close(self) -> None:
        self.inner.close()

    # -- faulted flash reads -------------------------------------------------
    def _next_index(self) -> int:
        with self._index_lock:
            i = self._read_index
            self._read_index += 1
            return i

    def _serve_extents(self, extents: List[Extent], phys: np.ndarray,
                       fetch_payload: bool,
                       stats: IOStats) -> Optional[np.ndarray]:
        corrupt_reads: List[int] = []
        for _ in extents:
            idx = self._next_index()
            for ev in self.plan.events_at(idx):
                if ev.kind == "corrupt":
                    if fetch_payload:      # counted below, where it bites
                        corrupt_reads.append(idx)
                    continue
                self.plan.active(idx, 0)   # count exactly what we apply
                if ev.kind == "latency":
                    time.sleep(ev.delay_s)
                elif ev.kind in ("transient", "short_read"):
                    raise TransientIOError(
                        f"injected {ev.kind} fault at read {idx} "
                        f"(no retry layer below this store)")
                elif ev.kind == "fatal":
                    raise FatalFault(f"injected fatal fault at read {idx}")
        data = self.inner._serve_extents(extents, phys, fetch_payload, stats)
        if data is not None and corrupt_reads:
            with self.plan._lock:
                for _ in corrupt_reads:
                    self.plan.injected["corrupt"] += 1
            raw = bytearray(np.ascontiguousarray(data).tobytes())
            for idx in corrupt_reads:
                self.plan.corrupt_payload(raw, idx)
            data = np.frombuffer(bytes(raw), dtype=data.dtype).reshape(
                data.shape)
        return data
