"""The port's overload controls against the reference's, on the CPU.

Reduced opt-350m, the reference's weights converted into the port; for
offload runs both runtimes are calibrated on the same random-token trace
(the same placements). Each scenario of `tests/test_slo.py` is played on
both servers with a fake clock of its own (time moves only when the test
moves it): the options `queue_limit`, `ttft_slo_s`, `itl_slo_s`,
`io_admission`, `io_headroom`, `stall_limit` and `finished_high_water`.
The port must give the reference's finish reasons, tokens and per-uid
`io_seconds` (exactly: the modeled I/O is the same arithmetic on the same
reads) and the same `ServerStats` counters; the order of admissions is
compared by rank (each server stamps its own clock).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.serving import server as jserver
from repro.serving.engine import Request as JRequest
from repro.serving.engine import build_offload_runtime as jbuild_runtime
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import build_model
from repro_torch.serving import server as tserver
from repro_torch.serving.engine import Request, build_offload_runtime

torch.set_num_threads(1)

SMALL = dict(d_model=64, d_ff=256, n_layers=2, vocab_size=128)
COUNTERS = [f.name for f in dataclasses.fields(tserver.ServerStats)
            if f.type in ("int", int)]


class FakeClock:
    """Monotonic time that moves only when the test says so; `tick` > 0
    adds that much on every read (a strictly increasing clock)."""

    def __init__(self, tick: float = 0.0) -> None:
        self.t, self.tick = 0.0, tick

    def __call__(self) -> float:
        self.t += self.tick
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@dataclasses.dataclass
class Side:
    """One implementation: its server module, request type, model, params
    and the keywords its constructors need."""
    name: str
    server: object
    request: type
    model: object
    params: object
    runtime_fn: object
    kw: dict

    def runtime(self, seed):
        return self.runtime_fn(self.model, self.params,
                               rng=np.random.default_rng(seed),
                               calib_batch=(4, 32), **self.kw)

    def make(self, **kw):
        return self.server.InferenceServer(self.model, self.params,
                                           max_len=64, **self.kw, **kw)


@pytest.fixture(scope="module")
def sides():
    jcfg = jget_config("opt-350m", reduced=True, **SMALL)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(20))
    cfg = get_config("opt-350m", reduced=True, **SMALL)
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               cfg, device="cpu")
    return (Side("reference", jserver, JRequest, jmodel, jparams,
                 jbuild_runtime, {}),
            Side("port", tserver, Request, model, params,
                 build_offload_runtime, {"device": "cpu"}))


def _prompt(seed, T=6):
    return np.random.default_rng(seed).integers(
        0, SMALL["vocab_size"], T).astype(np.int32)


def _req(side, uid, new=4, T=6, **kw):
    return side.request(uid=uid, prompt=_prompt(100 + uid, T),
                        max_new_tokens=new, **kw)


def _rank(values):
    return list(np.argsort(np.argsort(values, kind="stable"), kind="stable"))


def _assert_same(runs):
    """runs: {side name: (server, handles)}; the port's against the
    reference's, handle by handle, and the counters."""
    (js, jh), (ts, th) = runs["reference"], runs["port"]
    assert len(jh) == len(th)
    for j, t in zip(jh, th):
        assert t.done == j.done
        assert t.state.value == j.state.value
        if j.done:
            assert t.finish_reason == j.finish_reason
            assert t.result.tokens == j.result.tokens
            assert t.result.io_seconds == j.result.io_seconds
        assert list(t.tokens) == list(j.tokens)
    for name in COUNTERS:
        assert getattr(ts.stats, name) == getattr(js.stats, name), name


def _play(sides, scenario, **kw):
    runs = {}
    for side in sides:
        runs[side.name] = scenario(side, **kw)
    _assert_same(runs)
    return runs


# -- backpressure -------------------------------------------------------------

def _queue_full(side):
    server = side.make(max_slots=1, queue_limit=1)
    h0 = server.submit(_req(side, 0))
    h1 = server.submit(_req(side, 1))    # queue full, same priority: bounced
    assert h1.done and h1.finish_reason == "rejected" and h1.tokens == []
    server.drain()
    return server, [h0, h1]


def test_queue_full_rejects_equal_priority_newcomer(sides):
    runs = _play(sides, _queue_full)
    server, (h0, h1) = runs["port"]
    assert (server.stats.rejected, server.stats.shed) == (1, 0)
    assert server.stats.peak_queue_depth == 1
    assert h0.finish_reason == "length"


def _priority(side):
    server = side.make(max_slots=1, queue_limit=2)
    hs = [server.submit(_req(side, 0, new=2)),
          server.submit(_req(side, 1, new=2))]
    hs.append(server.submit(_req(side, 2, new=2, priority=1)))  # sheds uid 1
    assert hs[1].done and hs[1].finish_reason == "rejected"
    server.drain()
    return server, hs


def test_priority_sheds_lower_class_and_admits_first(sides):
    runs = _play(sides, _priority)
    server, (h0, h1, h2) = runs["port"]
    assert (server.stats.shed, server.stats.rejected) == (1, 0)
    assert h2.admitted_at < h0.admitted_at and server.stats.retired == 3
    jserver_, jh = runs["reference"]
    assert _rank([h.admitted_at for h in (h0, h2)]) == _rank(
        [jh[0].admitted_at, jh[2].admitted_at])


def _edf(side):
    clock = FakeClock(tick=1e-3)
    server = side.make(max_slots=1, clock=clock)
    hs = [server.submit(_req(side, 0, new=2)),                  # no deadline
          server.submit(_req(side, 1, new=2, ttft_slo_s=120.0)),
          server.submit(_req(side, 2, new=2, ttft_slo_s=60.0))]
    server.drain()
    return server, hs


def test_admission_is_earliest_ttft_deadline_first(sides):
    runs = _play(sides, _edf)
    ranks = {name: _rank([h.admitted_at for h in hs])
             for name, (_, hs) in runs.items()}
    assert ranks["port"] == ranks["reference"] == [2, 1, 0]
    assert runs["port"][0].stats.timeouts == 0


# -- deadlines ----------------------------------------------------------------

def _ttft_expiry(side):
    clock = FakeClock()
    server = side.make(max_slots=1, clock=clock)
    h0 = server.submit(_req(side, 0, new=4))
    server.step()                        # h0 takes the only slot
    h1 = server.submit(_req(side, 1, ttft_slo_s=0.5))
    server.step()
    assert h1.state.value == "queued"
    clock.advance(1.0)                   # h1's first token is now impossible
    server.step()
    assert h1.done and h1.finish_reason == "timeout"
    server.drain()
    return server, [h0, h1]


def test_ttft_deadline_expires_queued_request(sides):
    runs = _play(sides, _ttft_expiry)
    server, (h0, h1) = runs["port"]
    assert server.stats.timeouts == 1 and h1.result.tokens == []
    assert h0.finish_reason == "length" and len(h0.result.tokens) == 4


def _itl_expiry(side):
    clock = FakeClock()
    server = side.make(max_slots=2, mode="offload", offload=side.runtime(24),
                       clock=clock)
    h0 = server.submit(_req(side, 0, new=8, T=8, itl_slo_s=0.5))
    h1 = server.submit(_req(side, 1, new=8, T=8))
    for _ in range(3):
        server.step()                    # both decoding, gaps 0 fake-time
    assert not h0.done and not h1.done
    clock.advance(1.0)                   # h0's next gap blows its 0.5 s SLO
    server.step()
    assert h0.done and h0.finish_reason == "timeout"
    server.drain()
    engine_total = sum(t.io.seconds for e in server.offload.engines
                       for t in e.history)
    server.close()
    return server, [h0, h1, engine_total]


def test_itl_deadline_retires_mid_decode_with_io_conserved(sides):
    """Partial tokens, the survivor's tokens and both per-uid io_seconds
    equal the reference's; the attribution sums to the engines' reads."""
    runs = {s.name: _itl_expiry(s) for s in sides}
    totals = {name: hs.pop() for name, (_, hs) in runs.items()}
    _assert_same(runs)
    server, (h0, h1) = runs["port"]
    assert 0 < len(h0.result.tokens) < 8 and h1.finish_reason == "length"
    assert totals["port"] == totals["reference"] > 0
    np.testing.assert_allclose(h0.result.io_seconds + h1.result.io_seconds,
                               totals["port"], rtol=0, atol=1e-9)


def _lifecycle(side):
    clock = FakeClock(tick=1e-3)
    server = side.make(max_slots=1, clock=clock)
    hs = [server.submit(_req(side, 0, new=4)),
          server.submit(_req(side, 1, new=4))]    # queued behind uid 0
    server.drain()
    return server, hs


def test_lifecycle_stamps_are_monotonic(sides):
    runs = _play(sides, _lifecycle)
    for _, hs in runs.values():
        for h in hs:
            assert (h.queued_at <= h.admitted_at <= h.first_token_at
                    <= h.finished_at)
            assert h.first_token_at == h.token_times[0]
            assert h.token_times == sorted(h.token_times)
            assert len(h.token_times) == len(h.tokens)
        assert hs[0].admitted_at < hs[1].admitted_at


# -- watchdog / memory bounds -------------------------------------------------

def _stall(side):
    server = side.make(max_slots=1, stall_limit=5)
    h = server.submit(_req(side, 0))
    real = server._next_admission
    server._next_admission = lambda: None     # a gate that never opens
    for _ in range(4):
        assert server.step() == 0
    with pytest.raises(side.server.ServerStalledError,
                       match="no progress for 5 consecutive.*1 queued, "
                             "0 active"):
        server.step()
    server._next_admission = real             # progress clears the stall
    server.drain()
    assert server._stall_steps == 0
    return server, [h]


def test_stall_watchdog_raises_diagnosable_error(sides):
    runs = _play(sides, _stall)
    assert runs["port"][1][0].finish_reason == "length"


def _high_water(side):
    server = side.make(max_slots=1, finished_high_water=2)
    hs = [server.submit(_req(side, i, new=2)) for i in range(5)]
    server.drain()
    assert [r.uid for r in server.results()] == [3, 4]   # oldest 3 released
    return server, hs


def test_finished_high_water_bounds_server_memory(sides):
    runs = _play(sides, _high_water)
    server, hs = runs["port"]
    assert server.stats.results_released == 3
    assert all(h.done and len(h.result.tokens) == 2 for h in hs)


# -- flash-I/O-aware admission ------------------------------------------------

def _io_gate(side, io_admission=True, io_headroom=1.0):
    clock = FakeClock()       # frozen: the tight SLO only gates, never expires
    server = side.make(max_slots=2, mode="offload", offload=side.runtime(28),
                       clock=clock, io_admission=io_admission,
                       io_headroom=io_headroom)
    h0 = server.submit(_req(side, 0, new=6, T=8, itl_slo_s=1e-9))
    for _ in range(2):
        server.step()                    # record masks + compute history
    h1 = server.submit(_req(side, 1, new=3, T=8))
    server.step()
    state = h1.state.value
    server.drain()
    server.close()
    return server, [h0, h1], state


@pytest.mark.parametrize("io_admission,io_headroom,deferred", [
    (True, 1.0, True),         # the gate holds the newcomer, then admits it
    (True, 1e12, False),       # a huge headroom admits what 1.0 defers
    (False, 1.0, False),       # the gate off: admitted at once
])
def test_io_gate_matches_reference(sides, io_admission, io_headroom,
                                   deferred):
    runs = {s.name: _io_gate(s, io_admission, io_headroom) for s in sides}
    states = {name: r[2] for name, r in runs.items()}
    _assert_same({name: r[:2] for name, r in runs.items()})
    assert states["port"] == states["reference"]
    assert (states["port"] == "queued") is deferred
    server, (h0, h1) = runs["port"][:2]
    assert (server.stats.io_deferrals >= 1) is deferred
    assert h0.done and h1.done and h1.finish_reason == "length"
    assert h1.result.io_seconds > 0
