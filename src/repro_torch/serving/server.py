"""InferenceServer — slot-based continuous batching with an explicit request
lifecycle (QUEUED -> PREFILL -> DECODE -> FINISHED), on PyTorch.

  * a fixed pool of `max_slots` KV-cache decode slots, each with its own
    sequence position (decode steps take a per-slot position vector);
  * `submit(request) -> RequestHandle`, valid any time — including while
    other requests are decoding (mid-flight admission);
  * `step()` admits queued requests into free slots (each gets its own dense
    prefill, copied into its slot in place), then runs one batched decode
    iteration over the active slots;
  * retirement on `max_new_tokens` ("length") or a stop token ("stop") frees
    the slot immediately: the retired row is dropped from every subsequent
    activation-mask union, so a finished request stops incurring flash I/O;
  * streaming via `submit(..., on_token=...)` callbacks or `stream(handle)`.

Paged KV (`page_size`/`num_pages`): a shared page arena
(`serving/paging.py`) replaces the per-slot contiguous caches; admission
maps prompt prefixes shared with the registry or a live request,
copy-on-write keeps sharers intact, a page gate defers what the pool cannot
cover, and every retirement path releases the request's pages. Each decode
step sends the page tables to the device once, for all layers.

Offload mode rides the same loop: the [n_slots, n_neurons] mask matrix
(the ReLU oracle, or the runtime's trained predictors with `oracle=False`;
inactive rows zeroed) feeds `OffloadEngine.step_masks`, per-uid I/O
attribution accumulates on each handle (summing exactly to the engines'
merged read time), and each dense FFN runs through the fused segment
kernel. With `prefetch=True` one `PrefetchWorker` stays up across the whole
run: layer k+1's engine begin phase (issued with its lookahead-predicted
mask, or its true mask with `lookahead="oracle"`) runs on the worker while
the serving thread computes layer k, and a top-up read serves what the
lookahead missed.

Overload robustness, copied host logic: a bounded admission queue with
priority shedding, priority + earliest-deadline-first admission, TTFT and
inter-token SLO deadlines on a monotonic clock, the flash-I/O-aware
admission gate (offload mode), a stall watchdog, and per-request error
isolation.

Sampling: greedy is an argmax of the row. Temperature sampling draws from
one `torch.Generator` per request, seeded from (seed, uid), so a request's
tokens do not depend on which batch or slot it landed in. Declared
divergence: the reference samples with `jax.random` keys, whose bits torch
cannot reproduce, so only greedy tokens compare across the two packages.
"""
from __future__ import annotations

import dataclasses
import enum
import math
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Union

import numpy as np
import torch

from repro_torch.core.pipeline import IOScheduler
from repro_torch.core.predictor import PredictorParams, predict_mask
from repro_torch.device import DeviceLike, check_same_device, resolve_device
from repro_torch.models.layers import (apply_norm, embed_tokens,
                                       promoted_matmul, unembed)
from repro_torch.models.model import Model
from repro_torch.models.transformer import stack_decode_step_layerwise
from repro_torch.obs import get_metrics, get_tracer
from repro_torch.obs import request_timeline as _build_request_timeline
from repro_torch.serving.engine import (OffloadedFFNRuntime, Request, Result,
                                        check_pack_path)
from repro_torch.serving.paging import PagePool, cdiv
from repro_torch.utils import logger, stable_hash


class RequestState(enum.Enum):
    """Lifecycle of a request inside the server."""
    QUEUED = "queued"        # submitted, waiting for a free decode slot
    PREFILL = "prefill"      # admitted; its prompt is being prefilled
    DECODE = "decode"        # occupying a slot, generating tokens
    FINISHED = "finished"    # retired; `result` is populated


@dataclasses.dataclass
class RequestHandle:
    """Live view of one submitted request.

    `tokens` grows as the server steps; `result` is set at retirement.
    Timing fields accumulate while the request is in flight:
    `decode_seconds`/`overlapped_seconds` add each decode iteration's wall,
    `io_seconds` adds this request's attributed share of the engines' flash
    reads.
    """
    request: Request
    state: RequestState = RequestState.QUEUED
    tokens: List[int] = dataclasses.field(default_factory=list)
    # "length" | "stop" | "error" | "timeout" | "rejected" once FINISHED
    finish_reason: Optional[str] = None
    result: Optional[Result] = None
    error: Optional[BaseException] = None    # set iff finish_reason=="error"
    slot: Optional[int] = None
    on_token: Optional[Callable[[int, int], None]] = None   # (uid, token)
    prefill_seconds: float = 0.0
    decode_seconds: float = 0.0
    io_seconds: float = 0.0
    overlapped_seconds: float = 0.0
    # lifecycle stamps on the server's MONOTONIC clock
    queued_at: float = 0.0
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    token_times: List[float] = dataclasses.field(default_factory=list)
    # resolved SLOs: request-level value if set, else the server default
    ttft_slo: Optional[float] = None
    itl_slo: Optional[float] = None
    _generator: Optional[torch.Generator] = None   # per-uid sampling stream
    _order: int = 0                                # submission order

    @property
    def uid(self) -> int:
        return self.request.uid

    @property
    def done(self) -> bool:
        return self.state is RequestState.FINISHED

    @property
    def ttft_deadline(self) -> Optional[float]:
        """Monotonic instant this request's first token is due, or None."""
        return None if self.ttft_slo is None else self.queued_at + self.ttft_slo


def _deadline_or_inf(handle: RequestHandle) -> float:
    """TTFT deadline for EDF ordering; no deadline sorts last."""
    d = handle.ttft_deadline
    return math.inf if d is None else d


@dataclasses.dataclass
class ServerStats:
    """Aggregate counters over the server's lifetime."""
    n_slots: int = 0
    prefill_seconds: float = 0.0
    decode_seconds: float = 0.0       # wall of the batched decode iterations
    decode_steps: int = 0
    tokens_emitted: int = 0
    admitted: int = 0
    slot_steps_active: int = 0        # Σ over decode steps of active slots
    retired: int = 0                  # every retirement, any finish_reason
    rejected: int = 0                 # newcomers bounced off a full queue
    shed: int = 0                     # queued requests evicted for higher prio
    timeouts: int = 0                 # TTFT or inter-token deadline blown
    io_deferrals: int = 0             # admissions deferred by the I/O gate
    results_released: int = 0         # finished handles auto-released
    peak_queue_depth: int = 0         # max QUEUED depth ever observed
    # -- paged-KV counters (mirrors of PagePoolStats; zero unless paged) ------
    pages_allocated: int = 0          # page allocations over the run
    pages_shared: int = 0             # pages mapped shared at admission
    prefix_hits: int = 0              # admissions that matched a shared prefix
    cow_copies: int = 0               # copy-on-write page copies
    peak_page_occupancy: int = 0      # max pages simultaneously referenced
    prefix_evictions: int = 0         # registry entries evicted under pressure
    page_deferrals: int = 0           # admissions deferred by the page gate
    preemptions: int = 0              # active requests retired for pages

    @property
    def occupancy(self) -> float:
        """Mean fraction of slots doing useful work per decode step."""
        denom = self.decode_steps * max(self.n_slots, 1)
        return self.slot_steps_active / denom if denom else 0.0


class ServerStalledError(RuntimeError):
    """`step()` made no progress for `stall_limit` consecutive iterations
    while work was pending."""


class InferenceServer:
    """Slot-based continuous-batching front-end over one model, on `device`
    (default cuda; pass device="cpu" to run on the CPU).

    Typical use::

        server = InferenceServer(model, params, max_slots=4, max_len=256)
        h = server.submit(Request(uid=0, prompt=prompt, max_new_tokens=32))
        for tok in server.stream(h):      # pumps server.step() as needed
            ...
        server.close()

    `swa=True` replaces the per-slot contiguous caches with sliding-window
    rings of `cfg.sliding_window` slots (prefill attends the whole prompt,
    decode the last `cfg.sliding_window` positions), resident or offload.

    Paged KV: set BOTH `page_size` and `num_pages` to replace the per-slot
    contiguous caches with a shared page arena (`serving/paging.py`) —
    attention-only decoder stacks, no `swa`. `page_overcommit=False`
    (strict) admits only requests whose worst-case page need is covered, so
    decode growth never runs dry; True gates on the immediate prompt need
    only, trading possible page-pressure preemption for higher admitted
    concurrency. `cfg.kv_quant` selects the int8 cache, paged or not.

    `pack_path` loads the offload runtime from an on-disk NeuronPack
    (`OffloadedFFNRuntime.from_pack`, geometry-validated against the model
    config; `verify_checksums=True` checks every extent read against the
    pack's CRCs) instead of a caller-built `offload=` runtime, and requires
    `mode="offload"`; the server then owns the runtime and `close()` closes
    its layer stores.

    Offload masks come from the exact ReLU oracle, or with `oracle=False`
    from the runtime's trained per-layer `predictors`. `prefetch=True`
    runs offload decode through the layer-ahead prefetch pipeline;
    `lookahead` picks its speculation source as `ServingEngine` does:
    predictor params, None (the runtime's trained lookahead, else depth
    0), or "oracle" (depth 0: each layer's prefetch carries its true mask).
    Speculative lookahead is exact only for relu/relu2 and raises
    ValueError on other activations.
    """

    def __init__(self, model: Model, params: Any, *, max_slots: int = 4,
                 max_len: int = 512, swa: bool = False, mode: str = "resident",
                 offload: Optional[OffloadedFFNRuntime] = None,
                 scheduler: Optional[IOScheduler] = None,
                 oracle: bool = True, prefetch: bool = False,
                 lookahead: Union[str, List[PredictorParams], None] = None,
                 seed: int = 0, decode_fn=None, prefill_fn=None,
                 pack_path: Optional[str] = None,
                 verify_checksums: bool = False,
                 queue_limit: Optional[int] = None,
                 ttft_slo_s: Optional[float] = None,
                 itl_slo_s: Optional[float] = None,
                 io_admission: bool = True, io_headroom: float = 1.0,
                 stall_limit: int = 256,
                 finished_high_water: Optional[int] = None,
                 clock: Optional[Callable[[], float]] = None,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 page_overcommit: bool = False,
                 device: DeviceLike = None):
        if mode not in ("resident", "offload"):
            raise ValueError(f"unknown serving mode {mode!r}")
        if (page_size is None) != (num_pages is None):
            raise ValueError("pass both page_size and num_pages, or neither")
        if page_size is not None and swa:
            raise ValueError("paged KV cache does not combine with swa "
                             "(sliding-window rings are per-slot, not paged)")
        if isinstance(lookahead, str) and lookahead != "oracle":
            raise ValueError(f"unknown lookahead mode {lookahead!r}")
        self.device = resolve_device(device)
        check_same_device(self.device, model.device, "the model")
        cfg = model.cfg
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        if queue_limit is not None and queue_limit < 1:
            raise ValueError("queue_limit must be >= 1 (or None = unbounded)")
        if stall_limit < 1:
            raise ValueError("stall_limit must be >= 1")
        if pack_path is not None:
            check_pack_path(mode, offload)
            offload = OffloadedFFNRuntime.from_pack(
                cfg, pack_path, verify_checksums=verify_checksums,
                device=self.device)
        elif verify_checksums:
            raise ValueError("verify_checksums= applies to pack_path= only")
        if mode == "offload":
            if offload is None:
                raise ValueError("mode='offload' needs an OffloadedFFNRuntime")
            if cfg.family != "dense":
                raise ValueError("offload serving covers dense decoder-only archs")
            check_same_device(self.device, offload.device, "the offload runtime")
        self.model = model
        self.params = params
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_len = max_len
        self.swa = swa
        self.mode = mode
        self.offload = offload
        self._owns_offload = pack_path is not None   # we built it: we close it
        self.prefetch = prefetch
        self.scheduler = scheduler or IOScheduler(overlap=True)
        self.stats = ServerStats(n_slots=max_slots)
        self.queue_limit = queue_limit
        self.default_ttft_slo = ttft_slo_s
        self.default_itl_slo = itl_slo_s
        self.io_admission = io_admission
        self.io_headroom = io_headroom
        self.stall_limit = stall_limit
        self.finished_high_water = finished_high_water
        self.seed = seed
        self._clock = clock or time.monotonic
        self._stall_steps = 0
        self._prefill_fn = prefill_fn or (
            lambda p, toks, c: model.prefill(p, {"tokens": toks}, c))
        self._decode_fn = decode_fn or model.decode_step
        self._queue: List[RequestHandle] = []
        self._handles: Dict[int, RequestHandle] = {}   # queued + in-flight
        self._finished: List[RequestHandle] = []
        self._n_submitted = 0
        # I/O-aware admission state (offload): last step's per-layer true
        # masks + an EMA of per-column activation frequency, the candidate
        # estimate for a not-yet-admitted request
        self._last_masks: List[Optional[np.ndarray]] = (
            [None] * offload.n_layers if mode == "offload" else [])
        self._col_freq: List[Optional[np.ndarray]] = list(self._last_masks)
        # slot pool: per-slot handle / next-decode position / last token
        self._slot_handle: List[Optional[RequestHandle]] = [None] * max_slots
        self._slot_pos = np.zeros(max_slots, dtype=np.int64)
        self._cur = np.zeros(max_slots, dtype=np.int64)
        # paged KV: the pool owns ALL KV memory; per-uid page tables map each
        # request onto exactly the pages it has filled. Otherwise one
        # contiguous cache for all slots, per group {"sub_j": KVCache};
        # admission copies a request's prefilled rows into its slot in place
        self._pool: Optional[PagePool] = None
        self._tables: Dict[int, Any] = {}
        self._cache = None
        if page_size is not None:
            # PagePool/init_paged_stack_cache validate page geometry and
            # reject non-attention (SSM) sublayers with a ValueError — paged
            # serving never silently falls back
            self._pool = PagePool(cfg, num_pages=num_pages,
                                  page_size=page_size, max_len=max_len,
                                  overcommit=page_overcommit,
                                  device=self.device)
        else:
            self._cache = model.init_cache(max_slots, max_len, swa=swa)
        if mode == "offload":
            self._w_ups = _oracle_w_ups(model, params) if oracle else None
            if self._w_ups is not None and len(self._w_ups) != offload.n_layers:
                raise ValueError(
                    f"runtime has {offload.n_layers} layer engines, model has "
                    f"{len(self._w_ups)} dense FFN layers")
            if not oracle and offload.predictors is None:
                raise ValueError("oracle=False needs the runtime's trained "
                                 "predictors")
            # lookahead source resolution, as ServingEngine documents it:
            # params > runtime-trained > "oracle" (depth 0)
            la = lookahead if not isinstance(lookahead, str) else None
            if la is None and lookahead is None:
                la = offload.lookahead
            if la is not None and la is not offload.lookahead:
                offload.lookahead = la
                offload._lookahead_np = None
            self._la_params = la
            self.scheduler.register_metrics()
            if prefetch and la is not None and \
                    cfg.activation not in ("relu", "relu2"):
                # speculative lookahead OVER-predicts by design; both FFN
                # paths (bundles and the fused segment kernel) evaluate the
                # whole SERVED union — speculated neurons included — which is
                # only exact when act(pre <= 0) == 0. Oracle lookahead
                # (la=None, zero speculation depth) stays exact for any
                # activation, on either kernel: the segment path masks
                # covered-but-not-served neurons in-kernel.
                raise ValueError(
                    f"prefetch with speculative lookahead is exact only for "
                    f"relu/relu2 activations, not {cfg.activation!r}; use "
                    f"lookahead='oracle' or serve serially")
        self._register_metrics()

    def _register_metrics(self) -> None:
        """Expose live server state through the global `MetricsRegistry`."""
        reg = get_metrics()
        reg.register_gauge("server.queue_depth", lambda: len(self._queue))
        reg.register_gauge("server.n_active", lambda: self.n_active)
        for field in ("tokens_emitted", "decode_steps", "admitted", "retired",
                      "rejected", "shed", "timeouts", "io_deferrals",
                      "page_deferrals", "preemptions", "prefill_seconds",
                      "decode_seconds"):
            reg.register_gauge(f"server.{field}",
                               lambda f=field: getattr(self.stats, f))
        reg.register_gauge("server.occupancy", lambda: self.stats.occupancy)
        self._step_hist = reg.histogram("server.step_seconds")

    def request_timeline(self, handle: RequestHandle) -> Dict[str, Any]:
        """Per-request timeline for SLO debugging (phase breakdown, gaps,
        SLO verdicts, and trace spans when tracing is enabled)."""
        return _build_request_timeline(handle)

    # -- submission ----------------------------------------------------------
    def submit(self, request: Request,
               on_token: Optional[Callable[[int, int], None]] = None
               ) -> RequestHandle:
        """Queue a request; valid any time, including mid-decode.

        Raises ValueError if the request cannot fit its slot: the prompt plus
        `max_new_tokens` must fit in `max_len` KV-cache positions (and, when
        paged, in the pool's pages).
        Backpressure: with `queue_limit` set and the queue full, either the
        worst STRICTLY-lower-priority queued request is shed in favor of this
        one, or this request is retired immediately with
        `finish_reason="rejected"`.
        """
        T = len(request.prompt)
        if T < 1:
            raise ValueError(f"request {request.uid}: empty prompt")
        if request.max_new_tokens < 1:
            raise ValueError(f"request {request.uid}: max_new_tokens must be >= 1")
        if T + request.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {request.uid}: prompt ({T} tokens) + max_new_tokens "
                f"({request.max_new_tokens}) exceeds the server's max_len "
                f"({self.max_len}); shorten the request or raise max_len")
        if self._pool is not None:
            need = cdiv(T + request.max_new_tokens, self._pool.page_size)
            if need > self._pool.num_pages:
                raise ValueError(
                    f"request {request.uid}: prompt + max_new_tokens needs "
                    f"{need} pages of {self._pool.page_size}, but the pool "
                    f"has only {self._pool.num_pages}; shorten the request "
                    f"or grow the pool")
        if request.uid in self._handles:
            raise ValueError(f"duplicate request uid {request.uid}")
        gen = torch.Generator().manual_seed(
            stable_hash(self.seed, request.uid) & ((1 << 63) - 1))
        handle = RequestHandle(request=request, on_token=on_token,
                               queued_at=self._clock(),
                               ttft_slo=(request.ttft_slo_s
                                         if request.ttft_slo_s is not None
                                         else self.default_ttft_slo),
                               itl_slo=(request.itl_slo_s
                                        if request.itl_slo_s is not None
                                        else self.default_itl_slo),
                               _generator=gen, _order=self._n_submitted)
        self._n_submitted += 1
        self._handles[request.uid] = handle
        if (self.queue_limit is not None
                and len(self._queue) >= self.queue_limit):
            victim = self._shed_victim(request.priority)
            if victim is None:
                logger.warning("queue full (%d): rejecting request %d "
                               "(priority %d)", len(self._queue),
                               request.uid, request.priority)
                get_tracer().instant("reject", uid=request.uid,
                                     priority=request.priority)
                self.stats.rejected += 1
                self._retire(handle, "rejected")
                return handle
            logger.warning("queue full (%d): shedding queued request %d "
                           "(priority %d) for request %d (priority %d)",
                           len(self._queue), victim.uid,
                           victim.request.priority, request.uid,
                           request.priority)
            get_tracer().instant("shed", uid=victim.uid,
                                 for_uid=request.uid)
            self._queue.remove(victim)
            self.stats.shed += 1
            self._retire(victim, "rejected")
        self._queue.append(handle)
        self.stats.peak_queue_depth = max(self.stats.peak_queue_depth,
                                          len(self._queue))
        return handle

    def _shed_victim(self, priority: int) -> Optional[RequestHandle]:
        """The queued request to shed for a priority-`priority` arrival: the
        lowest STRICTLY-lower priority class; within it, the latest TTFT
        deadline, newest submission as the tie-break. None when nothing
        queued is strictly lower priority."""
        cands = [h for h in self._queue if h.request.priority < priority]
        if not cands:
            return None
        return min(cands, key=lambda h: (h.request.priority,
                                         -_deadline_or_inf(h), -h._order))

    # -- introspection -------------------------------------------------------
    @property
    def has_work(self) -> bool:
        return bool(self._queue) or any(h is not None for h in self._slot_handle)

    @property
    def n_active(self) -> int:
        return sum(h is not None for h in self._slot_handle)

    @property
    def n_queued(self) -> int:
        return len(self._queue)

    def results(self) -> List[Result]:
        """Finished results the server still holds, in submission order."""
        return [h.result for h in sorted(self._finished,
                                         key=lambda h: h._order)]

    def release_finished(self) -> int:
        """Drop the server's references to finished requests (their handles
        stay valid for the caller). Returns the number released."""
        n = len(self._finished)
        self._finished.clear()
        return n

    # -- the serving loop ----------------------------------------------------
    def step(self) -> int:
        """Advance the server one iteration: admit queued requests into free
        slots (per-request prefill), then run one batched decode iteration
        over the active slots. Returns the number of tokens emitted.

        An exception out of the shared decode computation retires every
        active request with `finish_reason="error"`, but the server survives.
        Per-request failures (sampling, a raising `on_token` callback, a
        failing prefill) retire only the offending request."""
        retired0, admitted0 = self.stats.retired, self.stats.admitted
        with get_tracer().span("step", queued=len(self._queue),
                               active=self.n_active):
            return self._step_inner(retired0, admitted0)

    def _step_inner(self, retired0: int, admitted0: int) -> int:
        emitted = 0
        now = self._clock()
        self._expire_active(now)
        self._expire_queued(now)
        while self._queue and None in self._slot_handle:
            cand = self._next_admission()
            if cand is None:               # an admission gate said "not yet"
                break
            got = self._admit(cand)
            if got is None:                # pool dry mid-admission: requeued
                break
            emitted += got
        if self._pool is not None:
            # make every active row's next position writable BEFORE the
            # batched decode: page-boundary growth, CoW at divergence points,
            # and — pool dry even after prefix eviction — preemption
            self._grow_page_tables()
        if any(h is not None for h in self._slot_handle):
            try:
                emitted += self._decode_iteration()
            except Exception as e:  # noqa: BLE001 — isolate, don't crash
                logger.warning("decode iteration failed (%r); retiring the "
                               "active batch with finish_reason='error'", e)
                for h in list(self._slot_handle):
                    if h is not None:
                        self._fail_request(h, e)
        if self._pool is not None:
            self._sync_page_stats()
        progress = (emitted + (self.stats.retired - retired0)
                    + (self.stats.admitted - admitted0))
        if progress == 0 and self.has_work:
            self._stall_steps += 1
            if self._stall_steps >= self.stall_limit:
                states = [h.state.value if h is not None else "free"
                          for h in self._slot_handle]
                raise ServerStalledError(
                    f"server made no progress for {self._stall_steps} "
                    f"consecutive step() iterations: {len(self._queue)} "
                    f"queued, {self.n_active} active, slots={states}, "
                    f"io_deferrals={self.stats.io_deferrals}")
        else:
            self._stall_steps = 0
        return emitted

    # -- SLO enforcement ------------------------------------------------------
    def _expire_queued(self, now: float) -> None:
        """Retire queued requests whose TTFT deadline already passed."""
        expired = [h for h in self._queue
                   if h.ttft_deadline is not None and now > h.ttft_deadline]
        for h in expired:
            self._queue.remove(h)
            self.stats.timeouts += 1
            logger.warning("request %d blew its TTFT deadline by %.3fs while "
                           "queued; retiring with finish_reason='timeout'",
                           h.uid, now - h.ttft_deadline)
            self._retire(h, "timeout")

    def _expire_active(self, now: float) -> None:
        """Retire active requests whose inter-token deadline has already
        passed since their last emitted token."""
        for h in list(self._slot_handle):
            if h is None or h.itl_slo is None or not h.token_times:
                continue
            gap = now - h.token_times[-1]
            if gap > h.itl_slo:
                self.stats.timeouts += 1
                logger.warning("request %d blew its inter-token deadline "
                               "(%.3fs > %.3fs SLO) with %d tokens; retiring "
                               "with finish_reason='timeout'", h.uid, gap,
                               h.itl_slo, len(h.tokens))
                self._retire(h, "timeout")

    def _next_admission(self) -> Optional[RequestHandle]:
        """Pop the queued request to admit next (highest priority, earliest
        TTFT deadline, submission order) unless the page gate or the
        flash-I/O admission gate defers it (counted in
        `stats.page_deferrals` / `stats.io_deferrals`)."""
        if not self._queue:
            return None
        best = min(self._queue,
                   key=lambda h: (-h.request.priority, _deadline_or_inf(h),
                                  h._order))
        if self._page_defers(best):
            get_tracer().instant("defer", uid=best.uid, gate="page")
            self.stats.page_deferrals += 1
            return None
        if self._io_defers(best):
            get_tracer().instant("defer", uid=best.uid, gate="io")
            self.stats.io_deferrals += 1
            return None
        self._queue.remove(best)
        return best

    def _page_defers(self, candidate: RequestHandle) -> bool:
        """Page-availability admission gate (paged KV only): True when the
        pool cannot cover the candidate — its worst-case lifetime page need
        in strict mode, its immediate prompt need under `page_overcommit` —
        out of free + registry-evictable pages net of the commitments already
        promised to active requests and of the registry pages the candidate
        itself would pin. Never defers an empty batch: `submit` bounded the
        request to the pool, and with nothing active every non-free page is
        either registry-evictable or a prefix the candidate shares."""
        if self._pool is None:
            return False
        if not any(h is not None for h in self._slot_handle):
            return False
        r = candidate.request
        plan = self._pool.plan_admit(np.asarray(r.prompt, dtype=np.int32),
                                     r.max_new_tokens)
        return not self._pool.can_admit(plan)

    def _io_defers(self, candidate: RequestHandle) -> bool:
        """Flash-I/O-aware admission gate: True when the UFS model predicts
        the next decode step WITH `candidate` admitted would exceed the
        tightest inter-token SLO among the active batch (+ the candidate),
        scaled by `io_headroom`. Never defers an empty batch."""
        if not self.io_admission or self.mode != "offload":
            return False
        if not any(h is not None for h in self._slot_handle):
            return False
        slos = [h.itl_slo for h in self._slot_handle
                if h is not None and h.itl_slo is not None]
        if candidate.itl_slo is not None:
            slos.append(candidate.itl_slo)
        if not slos:
            return False
        predicted = self._predict_step_seconds()
        if predicted is None:
            return False
        return predicted > self.io_headroom * min(slos)

    def _predict_step_seconds(self) -> Optional[float]:
        """Predicted seconds of the next decode step for the grown batch:
        per-layer extent reads priced on the UFS model over the union of the
        active rows' last true masks plus a frequency-EMA estimate for the
        incoming request, plus the scheduler's recent compute per token.
        None until a first decode step has recorded masks."""
        active = self._active_mask()
        unions: List[np.ndarray] = []
        for layer, masks in enumerate(self._last_masks):
            if masks is None:
                return None
            union = (masks & active[:, None]).any(axis=0)
            freq = self._col_freq[layer]
            if freq is not None:      # candidate estimate: typical-row mask
                union = union | (freq >= 0.5)
            unions.append(np.flatnonzero(union))
        io_s = self.offload.predict_step_io_seconds(unions)
        return io_s + self.scheduler.predicted_compute_seconds_per_token()

    def drain(self) -> List[Result]:
        """Step until every submitted request is finished."""
        while self.has_work:
            self.step()
        return self.results()

    def stream(self, handle: RequestHandle) -> Iterator[int]:
        """Yield `handle`'s tokens as they are generated, pumping `step()`
        whenever the caller is ahead of the server."""
        i = 0
        while True:
            while i < len(handle.tokens):
                yield handle.tokens[i]
                i += 1
            if handle.done:
                return
            self.step()

    def abort(self, reason: Union[str, BaseException] = "aborted") -> int:
        """Retire every queued and in-flight request with
        `finish_reason="error"`. Returns the number of requests retired."""
        exc = (reason if isinstance(reason, BaseException)
               else RuntimeError(str(reason)))
        n = 0
        while self._queue:
            self._fail_request(self._queue.pop(0), exc)
            n += 1
        for h in list(self._slot_handle):
            if h is not None:
                self._fail_request(h, exc)
                n += 1
        return n

    def close(self) -> None:
        """Release background resources: the prefetch worker always (its
        thread is joined); the offload runtime's stores too when this server
        built the runtime itself (pack_path=). Idempotent; the server stays
        usable for inspection, and further steps would restart the
        worker."""
        if self.mode == "offload" and self.offload is not None:
            if self._owns_offload:
                self.offload.close()
            else:
                self.offload.stop_prefetch()

    def __enter__(self) -> "InferenceServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- admission / retirement ----------------------------------------------
    def _admit(self, handle: RequestHandle) -> Optional[int]:
        """Prefill one queued request into a free slot. Failure-isolated: an
        exception anywhere in admission retires THIS request with
        `finish_reason="error"`.

        Returns the number of tokens emitted (0 or 1), or None when the page
        pool ran dry mid-admission: the request goes BACK to the queue
        (counted as a page deferral, nothing to unwind — the table is built
        before the prefill), and the caller stops admitting this step."""
        slot = self._slot_handle.index(None)
        r = handle.request
        table = prompt_np = None
        if self._pool is not None:
            prompt_np = np.asarray(r.prompt, dtype=np.int32)
            table, _ = self._pool.admit(prompt_np, r.max_new_tokens,
                                        uid=r.uid)
            if table is None:
                # the gate prices pinned shares, so this should not happen —
                # but a dry pool defers rather than killing the request (the
                # stall watchdog catches a gate that never opens)
                logger.warning("page pool dry while admitting request %d; "
                               "deferring it back to the queue", r.uid)
                self.stats.page_deferrals += 1
                self._queue.append(handle)
                return None
            self._tables[r.uid] = table
        handle.state = RequestState.PREFILL
        handle.slot = slot
        handle.admitted_at = self._clock()
        try:
            T = len(r.prompt)
            prompt = torch.as_tensor(np.asarray(r.prompt, dtype=np.int64)[None],
                                     device=self.device)
            tr = get_tracer()
            t0u = tr.now()
            t0 = time.perf_counter()
            small = self.model.init_cache(1, self.max_len, swa=self.swa)
            with torch.inference_mode():
                logits, small = self._prefill_fn(self.params, prompt, small)
            row = logits[0, -1].float().cpu().numpy()   # forces the sync
            handle.prefill_seconds = time.perf_counter() - t0
            t1u = tr.now()
            tr.complete("prefill", t0u, t1u, uid=r.uid, prompt_len=T,
                        slot=slot)
            tr.complete("prefill", t0u, t1u, track=f"req {r.uid}", uid=r.uid)
            self.stats.prefill_seconds += handle.prefill_seconds
            self.stats.admitted += 1
            if self._pool is not None:
                # the table was registered in _tables before the prefill, so
                # any failure below releases the pages via the _retire path
                self._pool.write_prompt(table, small)
                self._pool.register_prefixes(prompt_np, table)
            else:
                self._write_slot(slot, small)
            self._slot_handle[slot] = handle
            self._slot_pos[slot] = T
            handle.state = RequestState.DECODE
            tok = self._sample_row(handle, row)
            self._cur[slot] = tok
            self._emit(handle, tok)
            t2u = tr.now()
            tr.complete("decode", t1u, t2u, track=f"req {r.uid}", uid=r.uid,
                        tok=tok, n_tokens=1, from_prefill=True)
        except Exception as e:  # noqa: BLE001 — per-request isolation
            self._fail_request(handle, e)
            return 0
        return 1

    def _write_slot(self, slot: int, small_cache: Any) -> None:
        """Copy a freshly prefilled B=1 cache into row `slot` of the pool,
        in place: every leaf of the row, a ring's positions included, so a
        reused slot keeps nothing of its last request. Stale KV beyond the
        new prompt is harmless: decode writes a position's KV before
        attending to it, and causal masking hides everything past the
        current position."""
        for big_g, small_g in zip(self._cache, small_cache):
            for name, big in big_g.items():
                for big_leaf, small_leaf in zip(big, small_g[name]):
                    big_leaf[slot].copy_(small_leaf[0])

    def _emit(self, handle: RequestHandle, tok: int) -> None:
        now = self._clock()
        handle.tokens.append(tok)
        handle.token_times.append(now)
        if handle.first_token_at is None:
            handle.first_token_at = now
        self.stats.tokens_emitted += 1
        if handle.on_token is not None:
            handle.on_token(handle.uid, tok)
        if tok in handle.request.stop_tokens:
            self._retire(handle, "stop")
        elif len(handle.tokens) >= handle.request.max_new_tokens:
            self._retire(handle, "length")
        elif (handle.itl_slo is not None and len(handle.token_times) >= 2
              and now - handle.token_times[-2] > handle.itl_slo):
            self.stats.timeouts += 1
            logger.warning("request %d blew its inter-token deadline "
                           "(%.3fs > %.3fs SLO) at token %d; retiring with "
                           "finish_reason='timeout'", handle.uid,
                           now - handle.token_times[-2], handle.itl_slo,
                           len(handle.tokens))
            self._retire(handle, "timeout")

    def _retire(self, handle: RequestHandle, reason: str,
                error: Optional[BaseException] = None) -> None:
        get_tracer().instant("retire", uid=handle.uid, finish_reason=reason,
                             n_tokens=len(handle.tokens))
        handle.finish_reason = reason
        handle.error = error
        handle.state = RequestState.FINISHED
        handle.result = Result(
            uid=handle.uid, tokens=list(handle.tokens),
            prefill_seconds=handle.prefill_seconds,
            decode_seconds=handle.decode_seconds,
            io_seconds=handle.io_seconds,
            overlapped_seconds=handle.overlapped_seconds,
            finish_reason=reason, error=error)
        handle.finished_at = self._clock()
        if handle.slot is not None:                 # freed rows leave every
            self._slot_handle[handle.slot] = None   # future mask union
            handle.slot = None
        self._handles.pop(handle.uid, None)
        if self._pool is not None:
            # deterministic page reclamation on EVERY retirement path —
            # length/stop/timeout/error/rejected/preempted/abort all land here
            table = self._tables.pop(handle.uid, None)
            if table is not None:
                self._pool.release(table)
        self._finished.append(handle)
        self.stats.retired += 1
        hw = self.finished_high_water
        if hw is not None and len(self._finished) > hw:
            drop = len(self._finished) - hw
            del self._finished[:drop]
            self.stats.results_released += drop

    def _fail_request(self, handle: RequestHandle,
                      exc: BaseException) -> None:
        """Retire one request with `finish_reason="error"`: partial tokens
        stay on the Result, the exception is attached, the slot is freed."""
        if handle.done:
            return
        logger.warning("request %d failed (%r); retiring with "
                       "finish_reason='error'", handle.uid, exc)
        self._retire(handle, "error", error=exc)

    # -- paged-KV growth / preemption -----------------------------------------
    def _grow_page_tables(self) -> None:
        """Pre-decode growth pass: every active row's next write position
        gets a resident, privately-owned page (boundary alloc / CoW). In
        strict admission mode the pool can never be dry here — admission
        reserved every request's worst case. Under `page_overcommit` a dry
        pool preempts: the registry is already drained by the allocator, so
        the lowest-priority active request (latest deadline, newest — the
        `_shed_victim` key) retires with `finish_reason="preempted"`, its
        partial tokens intact and its pages released, and the needer
        retries. The needer can be its own victim."""
        for slot in range(self.max_slots):
            while True:
                h = self._slot_handle[slot]
                if h is None:
                    break
                table = self._tables.get(h.uid)
                if table is None or \
                        self._pool.prepare_append(table,
                                                  int(self._slot_pos[slot])):
                    break
                victim = min(
                    (a for a in self._slot_handle if a is not None),
                    key=lambda a: (a.request.priority, -_deadline_or_inf(a),
                                   -a._order))
                self.stats.preemptions += 1
                get_tracer().instant("preempt", uid=victim.uid,
                                     for_uid=h.uid,
                                     priority=victim.request.priority)
                logger.warning(
                    "page pool dry growing request %d (pos %d): preempting "
                    "request %d (priority %d, %d tokens) with "
                    "finish_reason='preempted'", h.uid,
                    int(self._slot_pos[slot]), victim.uid,
                    victim.request.priority, len(victim.tokens))
                self._retire(victim, "preempted")

    def _page_tables_np(self) -> np.ndarray:
        """[max_slots, max_pages] physical-page array for the decode step;
        free slots (and every unallocated logical page) point at the null
        page, so their garbage writes cannot touch a live page."""
        pool = self._pool
        pt = np.full((self.max_slots, pool.max_pages_per_seq),
                     pool.null_page, dtype=np.int32)
        for slot, h in enumerate(self._slot_handle):
            if h is not None:
                table = self._tables.get(h.uid)
                if table is not None:
                    pool.page_table_row(table, pt[slot])
        return pt

    def _sync_page_stats(self) -> None:
        ps = self._pool.stats
        s = self.stats
        s.pages_allocated = ps.pages_allocated
        s.pages_shared = ps.pages_shared
        s.prefix_hits = ps.prefix_hits
        s.cow_copies = ps.cow_copies
        s.peak_page_occupancy = ps.peak_page_occupancy
        s.prefix_evictions = ps.prefix_evictions

    def page_summary(self) -> Optional[Dict[str, Any]]:
        """Pool configuration + lifetime counters (None when the server is
        not paged)."""
        if self._pool is None:
            return None
        out = self._pool.summary()
        out["page_deferrals"] = self.stats.page_deferrals
        out["preemptions"] = self.stats.preemptions
        return out

    # -- sampling (per-request streams) ---------------------------------------
    def _sample_row(self, handle: RequestHandle, row: np.ndarray) -> int:
        """Greedy: argmax. Temperature: one draw from the request's own
        generator, so the value is independent of batch composition."""
        temp = handle.request.temperature
        if temp <= 0:
            return int(np.argmax(row))
        probs = torch.softmax(torch.from_numpy(row).float() / temp, dim=-1)
        return int(torch.multinomial(probs, 1, generator=handle._generator))

    # -- decode ---------------------------------------------------------------
    def _active_mask(self) -> np.ndarray:
        return np.array([h is not None for h in self._slot_handle], dtype=bool)

    def _decode_iteration(self) -> int:
        active = self._active_mask()
        tr = get_tracer()
        t0u = tr.now()
        with torch.inference_mode():
            if self.mode == "resident":
                logits_rows, token_wall, req_io, over = self._decode_resident()
            else:
                logits_rows, token_wall, req_io, over = self._decode_offload(
                    active)
        t1u = tr.now()
        tr.complete("decode_step", t0u, t1u, batch=int(active.sum()),
                    step=self.stats.decode_steps)
        self._step_hist.observe(token_wall)
        self.stats.decode_seconds += token_wall
        self.stats.decode_steps += 1
        self.stats.slot_steps_active += int(active.sum())
        # conservation: I/O the engine attributed to now-inactive rows is
        # re-billed evenly to the active requests, so Σ per-request io ==
        # Σ engine merged reads
        orphan = float(req_io[~active].sum())
        share = orphan / max(int(active.sum()), 1)
        emitted = 0
        for slot in np.flatnonzero(active):
            handle = self._slot_handle[slot]
            handle.decode_seconds += token_wall
            handle.overlapped_seconds += over
            handle.io_seconds += float(req_io[slot]) + share
            try:
                tok = self._sample_row(handle, logits_rows[slot])
                self._slot_pos[slot] += 1
                self._cur[slot] = tok
                self._emit(handle, tok)             # may free the slot
                emitted += 1
                tr.complete("decode", t0u, t1u, track=f"req {handle.uid}",
                            uid=handle.uid, tok=tok,
                            n_tokens=len(handle.tokens))
            except Exception as e:  # noqa: BLE001
                self._fail_request(handle, e)
        return emitted

    def _step_inputs(self):
        """The decode step's device inputs, sent once per step: last tokens
        [B, 1], positions [B], and (paged) the int32 page tables
        [B, max_pages] that every layer shares (None when not paged)."""
        cur = torch.as_tensor(self._cur[:, None], device=self.device)
        pos = torch.as_tensor(self._slot_pos.copy(), device=self.device)
        pt = (None if self._pool is None else
              torch.as_tensor(self._page_tables_np(), device=self.device))
        return cur, pos, pt

    def _decode_resident(self):
        t0 = time.perf_counter()
        cur, pos, pt = self._step_inputs()
        if self._pool is not None:
            logits, self._pool.cache_groups = self._decode_fn(
                self.params, cur, pos, self._pool.cache_groups, pt)
        else:
            logits, self._cache = self._decode_fn(self.params, cur, pos,
                                                  self._cache)
        rows = logits[:, 0].float().cpu().numpy()        # the per-token sync
        wall = time.perf_counter() - t0
        return rows, wall, np.zeros(self.max_slots), 0.0

    # -- offload decode: masks -> batched engine step -> sparse FFN ----------
    def _true_masks(self, dense_idx: int, h2: torch.Tensor,
                    active: np.ndarray, with_hidden: bool = False):
        """[n_slots, n_neurons] activation masks for one layer: the exact
        ReLU oracle (or the trained predictor with `oracle=False`), with
        retired/free rows zeroed so they leave the union — a finished
        request incurs no further I/O. `with_hidden=True` also returns `h2`
        on the host as float32 (the lookahead predictor's input), fetched
        in the same device-to-host read as the mask."""
        if self._w_ups is not None:
            dev_masks = promoted_matmul(h2, self._w_ups[dense_idx]) > 0
        else:
            dev_masks = predict_mask(self.offload.predictors[dense_idx], h2)
        h_np = None
        if with_hidden:
            both = torch.cat([dev_masks.float(), h2.float()], dim=1)
            both = both.cpu().numpy()
            masks, h_np = both[:, :dev_masks.shape[1]] > 0, \
                both[:, dev_masks.shape[1]:]
        else:
            masks = dev_masks.cpu().numpy()
        masks = masks & active[:, None]
        # feed the admission predictor: this layer's last true masks, plus an
        # EMA of per-column activation frequency over the active rows
        self._last_masks[dense_idx] = masks
        if self.io_admission and active.any():
            col = masks[active].mean(axis=0)
            prev = self._col_freq[dense_idx]
            self._col_freq[dense_idx] = (col if prev is None
                                         else 0.8 * prev + 0.2 * col)
        return (masks, h_np) if with_hidden else masks

    def _decode_offload(self, active: np.ndarray):
        cfg = self.cfg
        runtime = self.offload
        n_slots = self.max_slots
        n_layers = runtime.n_layers
        req_io = np.zeros(n_slots)
        if self.prefetch and not runtime.prefetch_active:
            runtime.start_prefetch()        # one worker for the whole run
        la_params = self._la_params if self.prefetch else None

        def override(dense_idx: int, normed2: torch.Tensor) -> torch.Tensor:
            h2 = normed2[:, 0]
            masks = self._true_masks(dense_idx, h2, active)
            y, res = runtime.ffn_apply_batch(dense_idx, h2, masks)
            flops = (2.0 * n_slots * res.merged.n_activated
                     * runtime.n_mats * cfg.d_model)
            self.scheduler.record_stage(dense_idx,
                                        io_seconds=res.merged.io.seconds,
                                        flops=flops)
            np.add(req_io, res.req_io_seconds, out=req_io)
            return y[:, None]

        # Pipelined path: submit layer k+1's speculated prefetch, then
        # complete layer k against its true mask (top-up for mis-predictions).
        def override_prefetch(dense_idx: int,
                              normed2: torch.Tensor) -> torch.Tensor:
            h2 = normed2[:, 0]
            speculate = la_params is not None and dense_idx + 1 < n_layers
            if speculate:
                masks_true, h_np = self._true_masks(dense_idx, h2, active,
                                                    with_hidden=True)
            else:
                masks_true = self._true_masks(dense_idx, h2, active)
            if dense_idx == 0 or la_params is None:
                runtime.begin_layer(dense_idx, masks_true)   # depth 0
            if speculate:
                spec = runtime.predict_lookahead(dense_idx, h_np)
                runtime.begin_layer(dense_idx + 1, spec & active[:, None])
            y, res, meas = runtime.complete_layer(dense_idx, h2, masks_true)
            flops = (2.0 * n_slots * res.merged.n_activated
                     * runtime.n_mats * cfg.d_model)
            self.scheduler.record_stage(dense_idx,
                                        io_seconds=res.merged.io.seconds,
                                        flops=flops, measured=meas)
            np.add(req_io, res.req_io_seconds, out=req_io)
            return y[:, None]

        t0 = time.perf_counter()
        cur, pos, pt = self._step_inputs()
        x = embed_tokens(self.params["embed"], cur, cfg)
        self.scheduler.begin_token()
        paged = self._pool is not None
        h, cache = stack_decode_step_layerwise(
            self.params["stack"], x, pos,
            self._pool.cache_groups if paged else self._cache, cfg,
            ffn_override=override_prefetch if self.prefetch else override,
            page_tables=pt)
        if paged:
            self._pool.cache_groups = cache
        else:
            self._cache = cache
        h = apply_norm(self.params["final_norm"], h, cfg)
        logits = unembed(self.params["embed"], h, cfg)
        rows = logits[:, 0].float().cpu().numpy()   # the end-of-token sync
        token_wall = time.perf_counter() - t0
        timing = self.scheduler.end_token(
            compute_seconds=token_wall,
            wall_seconds=token_wall if self.prefetch else None)
        over = (timing.measured_wall_seconds if self.prefetch
                else timing.overlapped_seconds)
        return rows, token_wall, req_io, over


def _oracle_w_ups(model: Model, params: Any) -> List[torch.Tensor]:
    """Resident w_up handles per dense layer, in capture order — the exact
    ReLU support oracle. The simulated flash still pays for every neuron
    the mask selects."""
    ffns = model.cfg.ffn_kinds()
    return [group[f"sub_{j}"]["ffn"]["w_up"]
            for group in params["stack"] for j in range(len(group))
            if ffns[j] == "dense"]
