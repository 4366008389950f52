"""The readers of the serving step's host time, on spans with a known
answer: only the serving thread's spans that start in the window count
(the `req <uid>` lanes' copies of `prefill` and `decode` and another
thread's spans do not), and a program without the spans, such as one
that predates them, gives nothing to read. Then a traced run of the tiny
resident cell reports all three."""
from __future__ import annotations

import types

import pytest

from bench_tiny import BENCH, run_tiny
from nlbench.spec import layer_reader

READERS = ("server.admit_host_ms", "server.prefix_evict_ms_per_step",
           "model.decode_host_ms")
BASE = 100.0
SERVING, LANE, WORKER = 7, 1_000_000, 9


def X(name, ts, dur, tid=SERVING, **args):
    return {"ph": "X", "name": name, "ts": float(ts), "dur": float(dur),
            "tid": tid, "pid": 1, "args": args}


def step_before_window():
    return [X("step", 0, 9000), X("admit_gate", 500, 100, uid=0),
            X("pool_admit", 700, 200, uid=0), X("evict", 750, 50),
            X("prefill", 1000, 3000, uid=0), X("write_prompt", 4100, 100),
            X("decode_step", 5000, 2000), X("logits_sync", 6500, 400)]


def step_b():
    return [X("step", 20000, 30000),
            X("admit_gate", 20100, 200, uid=1, deferred=False),
            X("pool_admit", 20400, 500, uid=1, pages=3, shared=0),
            X("evict", 20500, 100, entries=1, scanned=2),
            X("prefill", 21000, 4000, uid=1),
            X("init_cache", 21100, 300, uid=1),
            X("write_prompt", 25100, 1000, uid=1),
            X("register_prefixes", 26200, 300, uid=1),
            X("admit_gate", 26600, 100, uid=2, deferred=True),
            X("grow_tables", 26800, 300),
            X("evict", 26900, 150, entries=1, scanned=1),
            X("decode_step", 27200, 10000),
            X("step_inputs", 27300, 500),
            X("logits_sync", 35000, 2000),
            X("emit", 37300, 500)]


def step_c():
    return [X("step", 60000, 20000),
            X("admit_gate", 60100, 100, uid=2, deferred=False),
            X("pool_admit", 60300, 200, uid=2),
            X("prefill", 60600, 3000, uid=2),
            X("write_prompt", 63700, 800, uid=2),
            X("register_prefixes", 64600, 200, uid=2),
            X("grow_tables", 64900, 50),
            X("decode_step", 65000, 8000),
            X("logits_sync", 70000, 1000)]


def step_after_window():
    return [X("step", 101000, 9000), X("admit_gate", 101100, 300),
            X("pool_admit", 101500, 900), X("evict", 101600, 500),
            X("prefill", 102500, 3000), X("decode_step", 106000, 2000),
            X("logits_sync", 107000, 100)]


def others():
    """Copies on the request lanes, and another thread's spans."""
    return [X("prefill", 21000, 4000, tid=LANE, uid=1),
            X("decode", 27200, 10000, tid=LANE, uid=1),
            X("prefill", 60600, 3000, tid=LANE + 1, uid=2),
            X("decode_step", 40000, 9000, tid=WORKER),
            X("evict", 41000, 5000, tid=WORKER),
            X("write_prompt", 42000, 5000, tid=WORKER)]


def view(events):
    return types.SimpleNamespace(spans=events, tracer_base=BASE,
                                 t0=BASE + 0.010, t1=BASE + 0.100)


def read(name, events):
    return layer_reader(name, BENCH)(view(events))


ALL = (step_before_window() + step_b() + others() + step_c()
       + step_after_window())


def test_readers_on_spans_with_a_known_answer():
    # two admissions in the window: (0.2 + 0.5 + 1.0 + 0.3 + 0.1) and
    # (0.1 + 0.2 + 0.8 + 0.2) ms
    assert read("server.admit_host_ms", ALL) == pytest.approx(1.7)
    # (0.1 + 0.15) ms of evictions over two decode steps
    assert read("server.prefix_evict_ms_per_step", ALL) == \
        pytest.approx(0.125)
    # decode steps of 10 and 8 ms, less syncs of 2 and 1 ms
    assert read("model.decode_host_ms", ALL) == pytest.approx(7.5)


def test_the_request_lanes_and_other_threads_are_left_out():
    serving = [e for e in ALL if e["tid"] == SERVING]
    for name in READERS:
        assert read(name, ALL) == pytest.approx(read(name, serving)), name
    # the lanes alone hold no step: nothing to read
    for name in READERS:
        assert read(name, others()) is None, name


def test_no_evictions_read_zero():
    spans = [e for e in step_c() + others()]
    assert read("server.prefix_evict_ms_per_step", spans) == 0.0


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_the_spans_gives_nothing_to_read(name):
    old = {"step", "prefill", "decode_step", "read", "probe", "admit",
           "pread"}
    parent = [e for e in ALL if e["name"] in old]
    assert parent and read(name, parent) is None
    assert read(name, None) is None and read(name, []) is None


def test_a_traced_tiny_resident_run_reports_all_three(tmp_path):
    # one host thread: beside other test processes the tiny steps stay a
    # few ms, so the window holds admissions and its sessions never run
    # out of requests
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res, _ = run_tiny("resident", tmp_path, seed=2**31 + 21, trace=True,
                          seconds=1.0)
    finally:
        torch.set_num_threads(threads)
    for name in READERS:
        v = res["metrics"][name]["value"]
        assert isinstance(v, float) and v >= 0.0, name
    assert res["metrics"]["model.decode_host_ms"]["value"] > 0.0
    assert res["metrics"]["server.admit_host_ms"]["value"] > 0.0
