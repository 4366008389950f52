"""The port's tracer inside the serving step (CPU, port only).

A tiny paged resident server and a tiny offload server over a port-built
NeuronPack run with a recording tracer: every span of the serving step
appears where it belongs (nested in `step`, `prefill` or `decode_step` on
the serving thread), carries the request's uid where it belongs to one,
and counts what the pool and the store did. The offload layer loop has
`masks`, `stage`, `upload` and `ffn` once a layer a step, and the store
one `pread` a read call whose extents and bytes are the engines' measured
I/O. With the null tracer a served run records nothing and builds no
request-lane spans. The tracer keeps a lane for each thread, also for a
thread that reuses a finished thread's ident.
"""
import threading
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.engine import EngineConfig
from repro_torch.models import build_model
from repro_torch.obs.trace import NULL_TRACER, NullTracer, Tracer, set_tracer
from repro_torch.serving.engine import OffloadedFFNRuntime, Request
from repro_torch.serving.server import InferenceServer
from repro_torch.store.packer import build_pack

torch.set_num_threads(1)

SMALL = dict(d_model=64, d_ff=256, n_layers=2, vocab_size=128)
PAGE = 4


@pytest.fixture(scope="module")
def tiny():
    cfg = get_config("opt-350m", reduced=True, **SMALL)
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    return cfg, model, params


@pytest.fixture
def tracer():
    tr = Tracer()
    prev = set_tracer(tr)
    yield tr
    set_tracer(prev)


def _requests(n, lens, new):
    rng = np.random.default_rng(11)
    return [Request(uid=i, prompt=rng.integers(0, SMALL["vocab_size"],
                                               lens[i % len(lens)]
                                               ).astype(np.int32),
                    max_new_tokens=new)
            for i in range(n)]


def _serve(server, reqs):
    handles = [server.submit(r) for r in reqs]
    server.drain()
    return handles


def _spans(tr, tid=None):
    tid = threading.get_ident() if tid is None else tid
    return [e for e in tr.events()
            if e["ph"] == "X" and e["tid"] == tid]


def _inside(child, parents):
    return any(p["ts"] <= child["ts"] and
               child["ts"] + child["dur"] <= p["ts"] + p["dur"]
               for p in parents)


def _paged_server(tiny, num_pages=14):
    cfg, model, params = tiny
    return InferenceServer(model, params, max_slots=2, max_len=32,
                           page_size=PAGE, num_pages=num_pages, device="cpu")


def test_resident_step_spans_nest_and_count(tiny, tracer):
    server = _paged_server(tiny)
    reqs = _requests(8, (9, 12, 7, 10), 4)
    _serve(server, reqs)
    pool = server._pool
    spans = _spans(tracer)
    by = {}
    for e in spans:
        by.setdefault(e["name"], []).append(e)
    new = ("admit_gate", "pool_admit", "evict", "init_cache", "write_prompt",
           "register_prefixes", "grow_tables", "emit", "step_inputs",
           "mixer", "logits_sync")
    for name in new:
        assert by.get(name), f"no {name} span"
    steps = by["step"]
    for name in new + ("prefill", "decode_step"):
        assert all(_inside(e, steps) for e in by[name]), name
    assert all(_inside(e, by["prefill"]) for e in by["init_cache"])
    for name in ("step_inputs", "mixer", "logits_sync"):
        assert all(_inside(e, by["decode_step"]) for e in by[name]), name
    assert all(_inside(e, by["pool_admit"] + by["grow_tables"])
               for e in by["evict"])
    # one request's work carries its uid
    uids = {r.uid for r in reqs}
    for name in ("admit_gate", "pool_admit", "init_cache", "write_prompt",
                 "register_prefixes"):
        assert {e["args"]["uid"] for e in by[name]} <= uids, name
    for name in ("pool_admit", "init_cache", "write_prompt",
                 "register_prefixes"):
        assert sorted(e["args"]["uid"] for e in by[name]) == sorted(uids)
    assert all(e["args"]["deferred"] in (True, False)
               for e in by["admit_gate"])
    # the counts ride as args: at most two copies a cache leaf (the full
    # pages' scatter and a tail); registry entries and evictions add up to
    # the pool's own counters
    leaves = sum(len(arena) for g in pool.cache_groups for arena in g.values())
    for e in by["write_prompt"]:
        assert e["args"]["pages"] > 0
        assert 0 < e["args"]["launches"] <= 2 * leaves
    lens = {r.uid: len(r.prompt) for r in reqs}
    for e in by["pool_admit"]:
        a = e["args"]
        assert a["pages"] == -(-lens[a["uid"]] // PAGE) - a["shared"]
    entries = sum(e["args"]["entries"] for e in by["register_prefixes"])
    assert entries == len(pool._registry) + pool.stats.prefix_evictions
    assert sum(e["args"]["entries"] for e in by["evict"]) == \
        pool.stats.prefix_evictions > 0
    assert all(e["args"]["scanned"] >= e["args"]["entries"]
               for e in by["evict"])
    assert sum(e["args"]["increfs"] for e in by["register_prefixes"]) == \
        sum(len(r.prompt) // PAGE * (len(r.prompt) // PAGE + 1) // 2
            for r in reqs)
    # no per-page instant: pool_admit's pages arg replaces it
    assert not [e for e in tracer.events() if e["name"] == "page_alloc"]
    # the request lanes keep their prefill and a decode span a token
    events = tracer.events()
    lanes = {e["tid"] for e in events if e["ph"] == "M"
             and e["args"]["name"].startswith("req ")}
    assert len(lanes) == len(reqs)
    lane = Counter(e["name"] for e in events
                   if e["ph"] == "X" and e["tid"] in lanes)
    assert lane["prefill"] == len(reqs)
    assert lane["decode"] == sum(len(h) for h in
                                 (r.tokens for r in server.results()))


@pytest.fixture(scope="module")
def pack(tiny, tmp_path_factory):
    cfg, model, params = tiny
    path = tmp_path_factory.mktemp("obs") / "tiny.npack"
    build_pack(model, params, str(path), calib_tokens=128, calib_batch=4,
               calib_seqlen=32, device="cpu")
    return str(path)


@pytest.mark.parametrize("ffn_kernel", ["segments", "bundles"])
def test_offload_layer_spans_and_one_pread_a_read_call(tiny, pack, tracer,
                                                       ffn_kernel):
    cfg, model, params = tiny
    runtime = OffloadedFFNRuntime.from_pack(
        cfg, pack, engine_cfg=EngineConfig(ffn_kernel=ffn_kernel),
        device="cpu")
    assert runtime.ffn_kernel == ffn_kernel
    server = InferenceServer(model, params, max_slots=2, max_len=32,
                             mode="offload", offload=runtime, device="cpu")
    calls = []
    for eng in server.offload.engines:
        read = eng.store.read

        def counted(ids, *a, _read=read, **kw):
            out = _read(ids, *a, **kw)
            if np.asarray(ids).size:
                calls.append((out[1].measured_ops, out[1].measured_bytes))
            return out
        eng.store.read = counted
    _serve(server, _requests(3, (6, 9, 12), 5))
    spans = _spans(tracer)
    steps = [e for e in spans if e["name"] == "decode_step"]
    L = server.offload.n_layers
    assert steps
    for name in ("mixer", "masks", "stage", "upload", "ffn"):
        got = [e for e in spans if e["name"] == name]
        assert len(got) == L * len(steps), name
        assert all(_inside(e, steps) for e in got), name
        for s in steps:
            inner = sorted(e["args"]["layer"] for e in got
                           if _inside(e, [s]))
            assert inner == list(range(L)), name
    preads = [e for e in spans if e["name"] == "pread"]
    assert len(preads) == len(calls) > 0
    assert all(_inside(e, [r for r in spans if r["name"] == "read"])
               for e in preads)
    history = [t.io for eng in server.offload.engines for t in eng.history]
    assert sum(e["args"]["extents"] for e in preads) == \
        sum(io.measured_ops for io in history) == sum(c[0] for c in calls)
    assert sum(e["args"]["bytes"] for e in preads) == \
        sum(io.measured_bytes for io in history) == sum(c[1] for c in calls)
    assert all(_inside(e, steps) for e in spans
               if e["name"] == "logits_sync")
    server.close()
    runtime.close()


class _CountingNull(NullTracer):
    """The null tracer, counting the calls that name a request lane."""

    def __init__(self):
        self.lane_calls = 0

    def complete(self, *a, **kw):
        self.lane_calls += "track" in kw


@pytest.mark.parametrize("mode", ["resident", "offload"])
def test_null_tracer_records_nothing(tiny, pack, mode):
    cfg, model, params = tiny
    kw = (dict(page_size=PAGE, num_pages=14) if mode == "resident" else
          dict(mode="offload", pack_path=pack))
    reqs = _requests(4, (6, 9), 4)
    null = _CountingNull()
    prev = set_tracer(null)
    try:
        server = InferenceServer(model, params, max_slots=2, max_len=32,
                                 device="cpu", **kw)
        quiet = [h.tokens for h in _serve(server, reqs)]
        server.close()
    finally:
        set_tracer(prev)
    assert null.lane_calls == 0
    assert null.events() == [] and null.n_events == 0
    assert NULL_TRACER.events() == [] and NULL_TRACER.n_events == 0
    # tracing on serves the same tokens
    tr = Tracer()
    prev = set_tracer(tr)
    try:
        server = InferenceServer(model, params, max_slots=2, max_len=32,
                                 device="cpu", **kw)
        traced = [h.tokens for h in _serve(server, reqs)]
        server.close()
    finally:
        set_tracer(prev)
    assert traced == quiet and tr.n_events > 0


def test_threads_keep_a_lane_each_when_an_ident_comes_back(monkeypatch):
    tr = Tracer()
    main_tid = threading.get_ident()
    with tr.span("main"):
        pass
    seen = []

    def work(i):
        with tr.span("work", i=i):
            pass
        seen.append(threading.get_ident())

    # every worker reports the same ident, as a thread that reuses a
    # finished thread's ident does
    monkeypatch.setattr(threading, "get_ident", lambda: 4242)
    for i in range(3):
        t = threading.Thread(target=work, args=(i,), name=f"worker-{i}")
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    monkeypatch.undo()
    assert seen == [4242] * 3
    work_ev = [e for e in tr.events() if e["name"] == "work"]
    assert sorted(e["args"]["i"] for e in work_ev) == [0, 1, 2]
    tids = {e["args"]["i"]: e["tid"] for e in work_ev}
    assert tids[0] == 4242                 # the first keeps its ident
    assert len(set(tids.values())) == 3    # the others get lanes of their own
    names = {e["tid"]: e["args"]["name"] for e in tr.events()
             if e["ph"] == "M"}
    assert [names[tids[i]] for i in range(3)] == \
        ["worker-0", "worker-1", "worker-2"]
    main = [e for e in tr.events() if e["name"] == "main"]
    assert main[0]["tid"] == main_tid
    assert tr.n_events == 4


def test_short_lived_threads_keep_their_events():
    tr = Tracer()

    def work(i):
        with tr.span("work", i=i):
            pass

    for i in range(3):
        t = threading.Thread(target=work, args=(i,))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    work_ev = [e for e in tr.events() if e["name"] == "work"]
    assert sorted(e["args"]["i"] for e in work_ev) == [0, 1, 2]
    assert len({e["tid"] for e in work_ev}) == 3
