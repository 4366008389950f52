"""Run one cell once: set up, warm up, measure for a fixed window, check
the served tokens against the plain reference, and build the result line.

The system under test is `repro_torch`'s `InferenceServer`; the harness
drives it through `submit` / `step` as a client would and takes its own
host-clock stamps (a callback on every token). In offload cells it also
wraps two calls of the program's objects, without changing what they do:
`OffloadedFFNRuntime.ffn_apply_batch` (to count each layer's activated
neurons) and each `FileNeuronStore`'s `read` (to take the extents and bytes
each read call took from the pack file, as the store's own `IOStats` of
the call count them).

What the model's shape decides (its weights, its reference, the program's
config and parameters, FLOPs and bytes) comes from the architecture module
the configuration names (`bench/arch/<arch>.py`).
"""
from __future__ import annotations

import dataclasses
import gc
import hashlib
import json
import os
import sys
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from nlbench import traffic as traffic_lib
from nlbench.spec import Cell, arch_module, layer_reader
from nlbench.yardstick import ufs40_read_seconds

THREADS = 4            # torch, OpenMP and BLAS threads of the host
TRACE_CAPACITY = 1 << 21
PROFILE_AFTER_STEPS = 4    # window steps before the profiled stretch
PROFILE_STEPS = 12         # steps the profiler records in a traced run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def configure_env(root: Path) -> None:
    """Before torch is imported: the host's thread counts, and every build
    and kernel cache inside the checkout at a fixed path."""
    cache = root / "bench" / ".cache"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(cache / "build")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                "NUMEXPR_NUM_THREADS"):
        os.environ[var] = str(THREADS)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names, among the loaded modules (or `modules`), that are
    JAX's or the JAX package's, compared whole."""
    names = list(sys.modules) if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


# -- records taken by the harness -----------------------------------------------

@dataclasses.dataclass
class Tok:
    t: float
    step: int
    uid: int
    n: int          # 1-based index of the token in its request
    tok: int


class Recorder:
    def __init__(self):
        self.step = 0
        self.tokens: List[Tok] = []
        self.by_uid: Dict[int, List[Tok]] = {}
        self.submit: Dict[int, float] = {}
        self.prompt: Dict[int, np.ndarray] = {}
        self.session: Dict[int, int] = {}
        self.finish: Dict[int, tuple] = {}          # uid -> (t, reason)
        self.steps: List[tuple] = []                 # (step, t_begin, t_end)
        self.ffn: List[tuple] = []     # (t, layer, rows, activated, union)
        self.reads: List[tuple] = []   # (t, extents, bytes) per read call

    def on_token(self, uid: int, tok: int) -> None:
        lst = self.by_uid.setdefault(uid, [])
        rec = Tok(time.perf_counter(), self.step, uid, len(lst) + 1, int(tok))
        lst.append(rec)
        self.tokens.append(rec)


def instrument_offload(runtime, rec: Recorder) -> None:
    """Count, at the runtime and store boundaries, what each call did."""
    apply = runtime.ffn_apply_batch

    def ffn_apply_batch(layer, h, masks=None):
        m = np.asarray(masks)
        rows = m.sum(axis=1)
        rec.ffn.append((time.perf_counter(), layer, int((rows > 0).sum()),
                        int(rows.sum()), int(m.any(axis=0).sum())))
        return apply(layer, h, masks)

    runtime.ffn_apply_batch = ffn_apply_batch
    for eng in runtime.engines:
        def read_w(*a, _read=eng.store.read, **kw):
            data, stats = _read(*a, **kw)
            rec.reads.append((time.perf_counter(), int(stats.measured_ops),
                              int(stats.measured_bytes)))
            return data, stats

        eng.store.read = read_w


# -- the program's side ------------------------------------------------------------

def ensure_pack(model, params, cfg: Dict, key: str, calib_seed: int,
                cache: Path, device, log) -> tuple:
    """The NeuronPack of these weights: built once into the cache (one pack
    per configuration, keyed by its FFN weights and pack settings), served
    from there by every later run; `calib_seed` draws the builder's
    calibration tokens. Returns (path, build seconds or 0)."""
    from repro_torch.store.packer import build_pack
    d = cache / "packs"
    d.mkdir(parents=True, exist_ok=True)
    path, meta = d / f"{cfg['name']}.npack", d / f"{cfg['name']}.json"
    full_key = hashlib.sha256(
        (key + json.dumps(cfg["pack"], sort_keys=True)).encode()).hexdigest()
    if path.exists() and meta.exists() and \
            json.loads(meta.read_text()).get("key") == full_key:
        return path, 0.0
    for p in (path, meta):
        if p.exists():
            p.unlink()
    t0 = time.perf_counter()
    tmp = d / f"{cfg['name']}.npack.partial"
    pk = cfg["pack"]
    rep = build_pack(model, params, tmp, calib_tokens=pk["calib_tokens"],
                     calib_batch=pk["calib_batch"],
                     calib_seqlen=pk["calib_seqlen"],
                     seed=calib_seed, quantize=pk["quantize"],
                     placement_mode=pk["placement_mode"], device=device)
    # on disk before the window opens: the pack's writeback does not run
    # beside the reads it serves
    with open(tmp, "rb") as f:
        os.fsync(f.fileno())
    os.replace(tmp, path)
    meta.write_text(json.dumps({"key": full_key}))
    log({"pack_built": {"seconds": time.perf_counter() - t0,
                        "file_bytes": rep.file_bytes,
                        "search_seconds": rep.search_seconds,
                        "trace_seconds": rep.trace_seconds,
                        "write_seconds": rep.write_seconds}})
    return path, time.perf_counter() - t0


# -- one run ------------------------------------------------------------------------

@dataclasses.dataclass
class Profile:
    host_t0: float
    host_t1: float
    steps: List[int]
    kernels: List[tuple]             # (name, start_us, dur_us) device events
    busy_s: float
    window_s: float
    to_host: float                   # host perf seconds of device ts 0 (us)


@dataclasses.dataclass
class View:
    """What a per-layer reader reads: the harness's records of the traced
    run, the program's counters and spans, and the device profile."""
    cell: Cell
    cfg: Dict
    arch: Any                          # the configuration's bench/arch module
    t0: float
    t1: float
    rec: Recorder
    window_steps: List[int]
    decode_tokens: int
    stats0: Dict
    stats1: Dict
    history: Optional[List[list]]      # per layer: engine TokenStats in window
    spans: Optional[List[dict]]        # program tracer events in the window
    profile: Optional[Profile]
    tracer_base: float = 0.0           # perf seconds of the tracer's ts 0

    def decode_rows(self, steps) -> Dict[int, List[int]]:
        """Per step: the positions each decoded row attends (prompt length
        + index of the token it produces - 1)."""
        steps = set(steps)
        out: Dict[int, List[int]] = {}
        for tk in self.rec.tokens:
            if tk.n >= 2 and tk.step in steps:
                out.setdefault(tk.step, []).append(
                    len(self.rec.prompt[tk.uid]) + tk.n - 1)
        return out

    def prefills(self, steps) -> List[int]:
        """Prompt lengths of the prefills run in these steps."""
        steps = set(steps)
        return [len(self.rec.prompt[tk.uid]) for tk in self.rec.tokens
                if tk.n == 1 and tk.step in steps]


class Loop:
    """The closed loop: each session's next request goes in when its last
    has finished."""

    def __init__(self, server, streams, rec: Recorder):
        from repro_torch.serving.engine import Request
        self.Request = Request
        self.server, self.streams, self.rec = server, streams, rec
        self.next = [0] * len(streams)
        self.handles: List[Any] = [None] * len(streams)
        self.step_idx = 0

    def submit(self, s: int) -> None:
        pr = self.streams[s][self.next[s]]
        self.next[s] += 1
        self.rec.submit[pr.uid] = time.perf_counter()
        self.rec.prompt[pr.uid] = pr.prompt
        self.rec.session[pr.uid] = s
        self.handles[s] = self.server.submit(
            self.Request(uid=pr.uid, prompt=pr.prompt,
                         max_new_tokens=pr.max_new_tokens),
            on_token=self.rec.on_token)

    def pump(self) -> None:
        self.rec.step = self.step_idx
        t = time.perf_counter()
        self.server.step()
        self.rec.steps.append((self.step_idx, t, time.perf_counter()))
        self.step_idx += 1
        for s, h in enumerate(self.handles):
            if h is not None and h.done:
                self.rec.finish[h.uid] = (time.perf_counter(), h.finish_reason)
                self.submit(s)


def stats_dict(server) -> Dict:
    return dataclasses.asdict(server.stats)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=None, control: bool = False,
             fault=None, cache: Optional[Path] = None,
             steps: Optional[int] = None) -> Dict:
    """One run of `cell`; returns the result line's dict (and, with
    `control`, the control's reading under "control"). `fault(server,
    runtime)` breaks the timed path (tests of the check). With `steps`,
    the window is that many server steps in place of `seconds` (tests on
    the CPU, whose clock would make a window's work vary)."""
    import torch
    from repro_torch.configs import base as program_configs
    from repro_torch.models.model import Model
    from repro_torch.serving.server import InferenceServer
    from nlbench import correctness, profiling

    log = log or (lambda obj: print(json.dumps(obj), flush=True))
    cfg, mix = cell.config, cell.traffic
    arch = arch_module(cfg["arch"], cell.bench)
    device = torch.device(device)
    on_card = device.type == "cuda"
    correctness.no_tf32()
    if on_card:
        torch.set_num_threads(THREADS)
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
    cache = cache or Path(__file__).resolve().parent.parent / ".cache"

    phases = {"start": time.perf_counter() - t_start}
    t_ph = time.perf_counter()
    weights, wrep = arch.make_weights(cfg, seed, device)
    if on_card:
        torch.cuda.synchronize(device)
    phases["weights"] = time.perf_counter() - t_ph
    t_ph = time.perf_counter()
    max_len = traffic_lib.max_len(mix)
    mcfg = arch.model_config(cfg, max_len, program_configs)
    model = Model(mcfg, device=device)
    params = arch.program_params(weights)
    page = int(cfg["serving"]["page_size"])
    slots = int(mix["max_slots"])
    num_pages = slots * -(-max_len // page)
    runtime = None
    pack_build_s = 0.0
    if cell.mode == "offload":
        from repro_torch.core.engine import EngineConfig
        from repro_torch.serving.engine import OffloadedFFNRuntime
        pack, pack_build_s = ensure_pack(model, params, cfg,
                                         arch.ffn_fingerprint(weights),
                                         arch.pack_seed(cfg, seed), cache,
                                         device, log)
        runtime = OffloadedFFNRuntime.from_pack(
            mcfg, str(pack), engine_cfg=EngineConfig(**cfg["engine"]),
            device=device)
    server = InferenceServer(
        model, params, max_slots=slots, max_len=max_len, mode=cell.mode,
        offload=runtime, oracle=cfg["offload"]["oracle"],
        prefetch=cfg["offload"]["prefetch"], page_size=page,
        num_pages=num_pages,
        page_overcommit=bool(mix.get("page_overcommit", False)),
        seed=0, device=device)
    phases["server"] = time.perf_counter() - t_ph - pack_build_s
    rec = Recorder()
    if runtime is not None:
        instrument_offload(runtime, rec)
    if fault is not None:
        fault(server, runtime)
    streams = traffic_lib.plan(mix, seed, cfg["vocab_size"])
    loop = Loop(server, streams, rec)

    # warm-up: every session in; the first requests, cut to staggered
    # lengths, finish out of step as the window opens. They go in shortest
    # first, the order in which they would have been sent had each started
    # as many steps before as it has tokens left
    t_ph = time.perf_counter()
    for s in sorted(range(len(streams)),
                    key=lambda s: (streams[s][0].max_new_tokens, s)):
        loop.submit(s)
    while loop.step_idx < mix["warmup"]["min_steps"]:
        loop.pump()
    if on_card:
        torch.cuda.synchronize(device)
    phases["warmup"] = time.perf_counter() - t_ph
    phases["warmup_steps"] = loop.step_idx
    phases["first_step"] = rec.steps[0][2] - rec.steps[0][1]

    tracer = None
    if trace:
        from repro_torch.obs import enable_tracing
        tracer = enable_tracing(TRACE_CAPACITY)
    stats0 = stats_dict(server)
    hist0 = ([len(e.history) for e in runtime.engines]
             if runtime is not None else None)
    prof_raw = prof = None
    prof_at = loop.step_idx + PROFILE_AFTER_STEPS

    t0 = time.perf_counter()
    setup_s = t0 - t_start
    end_step = None if steps is None else loop.step_idx + steps
    while (time.perf_counter() < t0 + seconds if end_step is None
           else loop.step_idx < end_step):
        if trace and on_card and prof_raw is None and loop.step_idx == prof_at:
            prof_raw = profiling.profile_steps(loop, PROFILE_STEPS, device)
        else:
            loop.pump()
    t1 = time.perf_counter()
    window_steps = [s for s, a, b in rec.steps if a >= t0 and b <= t1]
    stats1 = stats_dict(server)
    history = ([e.history[h0:] for e, h0 in zip(runtime.engines, hist0)]
               if runtime is not None else None)
    spans, tracer_base = None, 0.0
    if tracer is not None:
        from repro_torch.obs import disable_tracing
        tracer_base = time.perf_counter() - tracer.now() / 1e6
        if tracer.dropped == 0:
            spans = tracer.events()
        disable_tracing()
    # requests sent in the window get their first token, however late
    sent = [u for u, t in rec.submit.items() if t0 <= t <= t1]
    guard = 0
    while any(u not in rec.by_uid for u in sent) and guard < 100_000:
        loop.pump()
        guard += 1
    t_drain = time.perf_counter()
    if prof_raw is not None:
        prof = profiling.load_profile(prof_raw)
    mem_peak = int(torch.cuda.max_memory_allocated()) if on_card else 0

    in_window = [tk for tk in rec.tokens if t0 <= tk.t <= t1]
    decode_in_window = [tk for tk in in_window if tk.n >= 2]
    view = View(cell=cell, cfg=cfg, arch=arch, t0=t0, t1=t1, rec=rec,
                window_steps=window_steps, decode_tokens=len(decode_in_window),
                stats0=stats0, stats1=stats1, history=history, spans=spans,
                profile=prof, tracer_base=tracer_base)

    # the activation share the served path saw, beside the target
    share = {"target": wrep.get("target"),
             "calibration_per_layer": wrep.get("calib_shares")}
    if rec.ffn:
        f = np.asarray(arch.ffn_neurons(cfg), dtype=np.float64)
        L = len(f)
        act = np.zeros(L)
        rows = np.zeros(L)
        union = np.zeros(L)
        calls = np.zeros(L)
        for t, layer, r, a, u in rec.ffn:
            if t0 <= t <= t1:
                act[layer] += a
                rows[layer] += r
                union[layer] += u
                calls[layer] += 1
        ok = rows > 0
        share["served_per_layer"] = [float(x) for x in
                                     np.where(ok, act / np.maximum(rows, 1) / f, 0)]
        share["served_mean"] = float(act.sum() / max((rows * f).sum(), 1))
        share["union_per_step"] = float(union.sum() / max((calls * f).sum(), 1))
    log({"activation_share": share})

    attempted = len(sent)
    failed = sum(1 for u in sent if u in rec.finish
                 and rec.finish[u][1] not in ("length", "stop"))
    window_s = t1 - t0
    metrics: Dict[str, Dict] = {}
    if not trace:
        e2e = {
            "out_tok_s": lambda: len(in_window) / window_s,
            "flash_ms_per_tok": lambda: flash_ms_per_tok(rec, t0, t1,
                                                         len(decode_in_window)),
            "setup_s": lambda: setup_s,
        }
        for m in cell.end_to_end:
            metrics[m.name] = {"value": float(e2e[m.name]()), "unit": m.unit}
    else:
        # the cell's per-layer metrics, each read by its own reader
        for m in cell.per_layer:
            v = layer_reader(m.name, cell.bench)(view)
            if v is not None:
                metrics[m.name] = {"value": float(v), "unit": m.unit}

    # the check: free the program's state, then run the reference
    sample = correctness.sample_requests(rec, t0, t_drain, seed,
                                         int(mix["check"]["sample_requests"]))
    server.close()
    if runtime is not None:
        runtime.close()
    del server, runtime, model, params, loop
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks, extra = correctness.check(cfg, cell, arch, weights, sample,
                                      device, control=control)
    check_s = time.perf_counter() - t_check

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": int(cell.chips) if on_card else 0,
           "memory_peak_bytes": mem_peak}
    if prof is not None:
        dev["busy_s"] = prof.busy_s
        dev["window_s"] = prof.window_s
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": attempted, "failed": failed, "metrics": metrics,
        "device": dev}
    if prof is not None:
        result["breakdown"] = profiling.breakdown(prof, spans, tracer_base,
                                                  threading.get_ident())
    log({"run": {"cell": cell.name, "seed": seed, "trace": trace,
                 "setup_s": setup_s, "pack_build_s": pack_build_s,
                 "setup_phases": phases,
                 "window_s": window_s, "steps": len(window_steps),
                 "step_ms_by_quarter": step_ms_by_quarter(rec, t0, t1),
                 "tokens": len(in_window), "check_s": check_s,
                 "served_tokens_checked": extra["tokens"],
                 "requests_checked": extra["requests"]}})
    if control:
        result["control"] = extra["control"]
    result["checks"] = checks
    return result


def step_ms_by_quarter(rec: Recorder, t0: float, t1: float) -> List[float]:
    """Mean ms a step in each quarter of the window (steadiness)."""
    q = (t1 - t0) / 4
    out = []
    for i in range(4):
        d = [b - a for s, a, b in rec.steps
             if t0 + i * q <= a and b <= t0 + (i + 1) * q]
        out.append(1e3 * sum(d) / len(d) if d else 0.0)
    return out


def flash_ms_per_tok(rec: Recorder, t0: float, t1: float, tokens: int) -> float:
    """Modeled UFS 4.0 time of the extent reads issued in the window, a
    decode token."""
    s = sum(ufs40_read_seconds(ops, nb) for t, ops, nb in rec.reads
            if t0 <= t <= t1)
    return 1e3 * s / max(tokens, 1)


def itl_gaps_ms(rec: Recorder, t0: float, t1: float) -> List[float]:
    """Gaps between a request's tokens, every gap that ends in [t0, t1]."""
    return [1e3 * (toks[i].t - toks[i - 1].t)
            for toks in rec.by_uid.values() for i in range(1, len(toks))
            if t0 <= toks[i].t <= t1]


def ttfts_ms(rec: Recorder, t0: float, t1: float) -> List[float]:
    """Submit to first token of every request sent in [t0, t1] (each has
    its first token: the harness runs on until it has)."""
    return [1e3 * (rec.by_uid[u][0].t - t) for u, t in rec.submit.items()
            if t0 <= t <= t1 and u in rec.by_uid]
