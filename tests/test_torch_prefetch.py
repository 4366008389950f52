"""The layer-ahead prefetch pipeline of the port against the reference's.

Reduced opt-350m (2 layers, d_model 48, d_ff 192, relu), the reference's
weights converted into the port, both runtimes calibrated on the same
random-token trace (the same placements). Counterparts of the reference's
`tests/test_prefetch.py` and `tests/test_faults.py` prefetch tests, each
run on both packages: the port's pipelined decode must give the serial
decode's tokens, and the reference prefetch server's tokens, per-uid
`io_seconds` and `io_summary()` counters (`worker_restarts`,
`degraded_steps`, retries, ...), exactly. Speculative lookahead params are
the reference's trained ones, converted, so the top-up counts are the
reference's too; the port's own training is held to serial tokens. The
fault tests serve a NeuronPack written by the port's packer. No test may
leave a `ripple-prefetch` thread behind.
"""
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.serving.engine import OffloadedFFNRuntime as JRuntime
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.engine import build_offload_runtime as jbuild_runtime
from repro.serving.server import InferenceServer as JInferenceServer
from repro.store.faults import FatalFault as JFatalFault
from repro.store.faults import FaultEvent as JFaultEvent
from repro.store.faults import FaultPlan as JFaultPlan
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, predictor_params_from_numpy
from repro_torch.core.placement import identity_placement
from repro_torch.core.predictor import PredictorParams
from repro_torch.core.sparse_ffn import FFNWeights, dense_ffn, make_bundles
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.serving.engine import (OffloadedFFNRuntime, Request,
                                        ServingEngine, build_offload_runtime)
from repro_torch.serving.server import InferenceServer
from repro_torch.store import (FatalFault, FaultEvent, FaultPlan, build_pack)

torch.set_num_threads(1)

SMALL = dict(d_model=48, d_ff=192, n_layers=2, vocab_size=128,
             activation="relu")
COUNTERS = ("retries", "corrupt_extents", "degraded_steps",
            "worker_restarts", "io_seconds_per_token", "ops_per_token",
            "cache_hit_rate", "mean_run_length")


@pytest.fixture(scope="module")
def env():
    jcfg = jget_config("opt-350m", reduced=True, **SMALL)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = get_config("opt-350m", reduced=True, **SMALL)
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               cfg, device="cpu")
    return dict(jmodel=jmodel, jparams=jparams, model=model, params=params)


def _requests(request_cls, seed=3, n=3, prompt=10, new=6):
    rng = np.random.default_rng(seed)
    return [request_cls(uid=i, prompt=rng.integers(0, 128, prompt)
                        .astype(np.int32), max_new_tokens=new)
            for i in range(n)]


def _runtimes(env, seed=1, **kw):
    """The reference's and the port's runtime from the same trace."""
    jrt = jbuild_runtime(env["jmodel"], env["jparams"],
                         rng=np.random.default_rng(seed), **kw)
    rt = build_offload_runtime(env["model"], env["params"],
                               rng=np.random.default_rng(seed),
                               device="cpu", **kw)
    for je, te in zip(jrt.engines, rt.engines):
        np.testing.assert_array_equal(te.placement.placement,
                                      je.placement.placement)
    return jrt, rt


def _serve_ref(env, jrt, **kw):
    eng = JServingEngine(env["jmodel"], env["jparams"], max_len=32,
                         mode="offload", offload=jrt, **kw)
    try:
        return eng.serve(_requests(JRequest))
    finally:
        eng.close()


def _serve(env, rt, **kw):
    eng = ServingEngine(env["model"], env["params"], max_len=32,
                        mode="offload", offload=rt, device="cpu", **kw)
    try:
        return eng.serve(_requests(Request))
    finally:
        eng.close()


def _convert(jparams_list):
    return [predictor_params_from_numpy([np.asarray(a) for a in p], "cpu")
            for p in jparams_list]


def _no_worker_threads():
    return not any(t.name.startswith("ripple-prefetch")
                   for t in threading.enumerate())


def _assert_same(results, jresults, rt=None, jrt=None):
    """Tokens, finish reasons and per-uid io_seconds exactly; the runtimes'
    counters too when given."""
    for r, jr in zip(results, jresults):
        assert r.uid == jr.uid
        assert r.tokens == jr.tokens
        assert r.finish_reason == jr.finish_reason == "length"
        assert r.io_seconds == jr.io_seconds
    if rt is not None:
        s, js = rt.io_summary(), jrt.io_summary()
        for key in COUNTERS:
            assert s[key] == js[key], key
        assert rt.topup_total == jrt.topup_total


def test_pipelined_oracle_decode_matches_serial_and_reference(env):
    """`lookahead="oracle"` (depth 0): token-identical to serial with equal
    per-engine stats, the measured overlap recorded, the reference's
    tokens, I/O and counters, and the worker joined after serve."""
    _, rt_serial = _runtimes(env)
    serial = _serve(env, rt_serial)
    jrt, rt = _runtimes(env)
    jres = _serve_ref(env, jrt, prefetch=True, lookahead="oracle")
    eng = ServingEngine(env["model"], env["params"], max_len=32,
                        mode="offload", offload=rt, device="cpu",
                        prefetch=True, lookahead="oracle")
    ops.reset_counts()
    res = eng.serve(_requests(Request))
    ffn = ops.counts["sparse_ffn_segments_fused"]
    assert ffn.launches == 0 and ffn.plain_calls > 0
    _assert_same(res, jres, rt, jrt)
    for a, b in zip(serial, res):
        assert a.tokens == b.tokens
        assert a.io_seconds == b.io_seconds
        assert b.overlapped_seconds > 0          # the measured wall clock
    for es, ep in zip(rt_serial.engines, rt.engines):
        ss, sp = es.summary(), ep.summary()
        for key in ("tokens", "io_seconds_per_token", "ops_per_token",
                    "cache_hit_rate"):
            assert ss[key] == sp[key], key
        assert sum(t.io.bytes_read for t in es.history) == \
            sum(t.io.bytes_read for t in ep.history)
    s = eng.scheduler.summary()
    assert s["measured_wall_seconds_per_token"] > 0
    assert s["measured_io_busy_seconds_per_token"] > 0
    assert rt._worker is None and _no_worker_threads()
    assert rt.topup_total == 0


def test_trained_lookahead_pipelined_decode_matches_serial(env):
    """Real speculation depth with the reference's trained lookahead
    predictors, converted: tokens equal serial, and I/O, top-ups and
    counters equal the reference's; then with the port's own training."""
    _, rt_serial = _runtimes(env, seed=2)
    serial = _serve(env, rt_serial)
    jrt, rt = _runtimes(env, seed=2)
    jrt_la = jbuild_runtime(env["jmodel"], env["jparams"],
                            rng=np.random.default_rng(2),
                            train_lookahead=True)
    assert len(jrt_la.lookahead) == 1
    jres = _serve_ref(env, jrt_la, prefetch=True)
    res = _serve(env, rt, prefetch=True, lookahead=_convert(jrt_la.lookahead))
    _assert_same(res, jres, rt, jrt_la)
    assert rt.topup_total > 0 or rt.io_summary()["io_seconds_per_token"] > \
        rt_serial.io_summary()["io_seconds_per_token"]   # it speculated
    assert [r.tokens for r in res] == [r.tokens for r in serial]
    own = build_offload_runtime(env["model"], env["params"],
                                rng=np.random.default_rng(2),
                                train_lookahead=True, device="cpu")
    assert own.lookahead is not None and len(own.lookahead) == 1
    eng = ServingEngine(env["model"], env["params"], max_len=32,
                        mode="offload", offload=own, device="cpu",
                        prefetch=True)
    res_own = eng.serve(_requests(Request))
    assert [r.tokens for r in res_own] == [r.tokens for r in serial]
    s = eng.scheduler.summary()
    assert s["measured_wall_seconds_per_token"] > 0
    assert s["measured_hidden_seconds_per_token"] >= 0
    assert _no_worker_threads()


def _failing_on_worker(engine, exc_factory, from_call):
    """Patch `engine.begin_step_masks` to raise on the worker's
    `from_call`-th and later calls; the serving thread's reads pass."""
    orig = engine.begin_step_masks
    calls = {"n": 0}

    def failing(masks, fetch_payload=True):
        if threading.current_thread().name.startswith("ripple-prefetch"):
            calls["n"] += 1
            if calls["n"] >= from_call:
                raise exc_factory()
        return orig(masks, fetch_payload)

    engine.begin_step_masks = failing
    return orig


def test_worker_exception_mid_decode_degrades_and_shuts_down_cleanly(env):
    """A layer engine failing inside the worker degrades the layer (served
    synchronously, `degraded_steps` counting each fallback), tokens equal
    serial and the reference's, the counters equal the reference's, the
    worker is joined, and the runtime serves again fault-free."""
    _, rt_serial = _runtimes(env, seed=3)
    serial = _serve(env, rt_serial)
    jrt, rt = _runtimes(env, seed=3)
    boom = lambda: RuntimeError("flash gave up mid-decode")  # noqa: E731
    _failing_on_worker(jrt.engines[1], boom, 3)
    jres = _serve_ref(env, jrt, prefetch=True, lookahead="oracle")
    orig = _failing_on_worker(rt.engines[1], boom, 3)
    before = threading.active_count()
    res = _serve(env, rt, prefetch=True, lookahead="oracle")
    _assert_same(res, jres, rt, jrt)
    assert [r.tokens for r in res] == [r.tokens for r in serial]
    assert rt._worker is None
    assert threading.active_count() == before and _no_worker_threads()
    assert rt.degraded_steps > 0 and rt.worker_restarts == 0
    rt.engines[1].begin_step_masks = orig
    rt.reset_stats()
    again = _serve(env, rt, prefetch=True, lookahead="oracle")
    assert all(len(r.tokens) == 6 for r in again)
    assert rt.degraded_steps == 0


# -- supervision, on a NeuronPack written by the port's packer ---------------

@pytest.fixture(scope="module")
def pack_env(env, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("prefetch") / "m.npack")
    build_pack(env["model"], env["params"], path, calib_tokens=128,
               calib_batch=4, calib_seqlen=32, device="cpu")
    with OffloadedFFNRuntime.from_pack(env["model"].cfg, path,
                                       device="cpu") as rt:
        clean = [r.tokens for r in _serve(env, rt)]
        s = rt.io_summary()
        assert (s["retries"], s["corrupt_extents"], s["degraded_steps"],
                s["worker_restarts"]) == (0, 0, 0, 0)
    return dict(env, path=path, clean=clean)


def _both_from_pack(pack_env, jplans=None, plans=None, **kw):
    jrt = JRuntime.from_pack(pack_env["jmodel"].cfg, pack_env["path"],
                             fault_plans=jplans, **kw)
    rt = OffloadedFFNRuntime.from_pack(pack_env["model"].cfg,
                                       pack_env["path"], fault_plans=plans,
                                       device="cpu", **kw)
    return jrt, rt


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_worker_death_restarts_and_decode_stays_token_identical(pack_env):
    """A FatalFault on a worker-issued read kills the thread; supervision
    restarts it once and serves the lost layer synchronously: the clean
    tokens, and the reference's I/O and counters."""
    jplans = [JFaultPlan([JFaultEvent(4, "fatal")], seed=5),
              JFaultPlan(seed=6)]
    plans = [FaultPlan([FaultEvent(4, "fatal")], seed=5), FaultPlan(seed=6)]
    jrt, rt = _both_from_pack(pack_env, jplans, plans)
    with jrt, rt:
        jres = _serve_ref(pack_env, jrt, prefetch=True, lookahead="oracle")
        res = _serve(pack_env, rt, prefetch=True, lookahead="oracle")
        _assert_same(res, jres, rt, jrt)
    assert plans[0].injected["fatal"] == jplans[0].injected["fatal"] == 1
    assert rt.worker_restarts == 1 and rt.degraded_steps >= 1
    assert [r.tokens for r in res] == pack_env["clean"]
    assert _no_worker_threads()


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_worker_restart_budget_exhausted_falls_back_to_sync(pack_env):
    """Every restarted worker dies too: after `max_worker_restarts` the
    runtime disables prefetch and finishes on the synchronous path —
    the clean tokens, the reference's counters."""
    jrt, rt = _both_from_pack(pack_env, max_worker_restarts=1)
    with jrt, rt:
        _failing_on_worker(jrt.engines[1],
                           lambda: JFatalFault("worker poisoned"), 1)
        _failing_on_worker(rt.engines[1],
                           lambda: FatalFault("worker poisoned"), 1)
        jres = _serve_ref(pack_env, jrt, prefetch=True, lookahead="oracle")
        res = _serve(pack_env, rt, prefetch=True, lookahead="oracle")
        _assert_same(res, jres, rt, jrt)
        assert rt.worker_restarts == 1
        assert rt.io_summary()["degraded_steps"] > 0
    assert [r.tokens for r in res] == pack_env["clean"]
    assert _no_worker_threads()


def test_per_job_failure_degrades_only_that_layer(pack_env):
    """An ordinary Exception inside one prefetch job is absorbed: that
    layer is served synchronously, the worker survives."""
    jrt, rt = _both_from_pack(pack_env)
    with jrt, rt:
        for e, calls in ((jrt.engines[1], {"n": 0}), (rt.engines[1],
                                                       {"n": 0})):
            orig = e.begin_step_masks

            def flaky(masks, fetch_payload=True, orig=orig, calls=calls):
                if threading.current_thread().name.startswith(
                        "ripple-prefetch"):
                    calls["n"] += 1
                    if calls["n"] == 2:
                        raise RuntimeError("one bad stage")
                return orig(masks, fetch_payload)

            e.begin_step_masks = flaky
        jres = _serve_ref(pack_env, jrt, prefetch=True, lookahead="oracle")
        res = _serve(pack_env, rt, prefetch=True, lookahead="oracle")
        _assert_same(res, jres, rt, jrt)
        s = rt.io_summary()
        assert s["worker_restarts"] == 0 and s["degraded_steps"] == 1
    assert [r.tokens for r in res] == pack_env["clean"]


# -- the bundles path (identity layout) -------------------------------------

def _few_neurons_lookahead(d, n, k=10):
    """A lookahead that predicts exactly its first k neurons for any
    hidden (zero weights, biases of +-10): the prefetch stages few rows
    and the top-up most of the union."""
    b2 = np.full(n, -10.0, np.float32)
    b2[:k] = 10.0
    return [np.zeros((d, 4), np.float32), np.zeros(4, np.float32),
            np.zeros((4, n), np.float32), b2]


def test_bundles_path_pipelined_with_growing_ring_slot(env):
    """use_placement=False: the worker stages the bundle rows into ring
    slots, a speculation of 10 neurons leaves the top-up to grow the slot
    past its pad bucket (the staged rows kept), and the FFN from the staged
    rows gives serial tokens and the reference's I/O and top-ups."""
    _, rt_serial = _runtimes(env, seed=4, use_placement=False)
    serial = _serve(env, rt_serial)
    jrt, rt = _runtimes(env, seed=4, use_placement=False)
    assert rt.io_summary()["ffn_kernel"] == "bundles"
    la = _few_neurons_lookahead(48, 192)
    jres = _serve_ref(env, jrt, prefetch=True,
                      lookahead=[tuple(map(jax.numpy.asarray, la))])
    res = _serve(env, rt, prefetch=True,
                 lookahead=[predictor_params_from_numpy(la, "cpu")])
    _assert_same(res, jres, rt, jrt)
    assert [r.tokens for r in res] == [r.tokens for r in serial]
    assert rt.topup_total > rt.PAD_BUCKET
    slot1 = rt._staging[("ring", rt.engines[0].store.bundle_width,
                         rt.engines[0].store.stored_dtype, 1)]
    assert slot1.shape[0] > rt.PAD_BUCKET          # the top-up grew it


def test_complete_layer_tops_up_mispredictions_exactly():
    """A speculated mask with a third of its bits flipped: `complete_layer`
    tops up the missed neurons and the FFN equals the dense FFN."""
    rng = np.random.default_rng(0)
    n, d = 256, 32
    cfg = get_config("granite-3-2b", reduced=True, d_model=d, d_ff=n,
                     activation="relu")
    w = FFNWeights(
        w_up=torch.from_numpy((rng.standard_normal((n, d)) * 0.2)
                              .astype(np.float32)),
        w_down=torch.from_numpy((rng.standard_normal((n, d)) * 0.2)
                                .astype(np.float32)))
    runtime = OffloadedFFNRuntime(cfg, [make_bundles(w)],
                                  [identity_placement(n)], device="cpu")
    h = rng.standard_normal((3, d)).astype(np.float32)
    true = h @ w.w_up.numpy().T > 0
    spec = true.copy()
    spec[:, ::3] = ~spec[:, ::3]
    runtime.start_prefetch()
    try:
        runtime.begin_layer(0, spec)
        y, res, meas = runtime.complete_layer(0, torch.from_numpy(h), true)
    finally:
        runtime.stop_prefetch()
    np.testing.assert_allclose(y.numpy(),
                               dense_ffn(torch.from_numpy(h), w).numpy(),
                               rtol=1e-4, atol=1e-4)
    assert res.topup_ids.size > 0 and meas.io_host_seconds > 0
    assert _no_worker_threads()


# -- bf16 ------------------------------------------------------------------

def test_bf16_prefetch_with_trained_lookahead_matches_serial_bf16(env):
    """The reduced model cast to bf16, served offload with `prefetch=True`
    and lookahead predictors the port trains on the bf16 calibration
    forward (bf16 hiddens meet float32 predictor weights in float32; from
    the first offloaded FFN on the residual, so the lookahead's input, is
    float32): the port's own serial bf16 run's tokens; with
    `lookahead="oracle"` also its per-uid I/O exactly. The speculative run
    reads the speculated neurons too, so its per-uid I/O is not the serial
    run's (as in the reference); it sums to the engines' reads."""
    cfg = get_config("opt-350m", reduced=True, **SMALL,
                     param_dtype="bfloat16", compute_dtype="bfloat16")
    model = build_model(cfg, device="cpu")
    params = jax.tree_util.tree_map(np.asarray, env["jparams"])
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, jax.numpy.bfloat16)
        if a.dtype == np.float32 else a, params)
    params = params_from_numpy(params, cfg, device="cpu")
    assert params["stack"][0]["sub_0"]["ffn"]["w_up"].dtype == torch.bfloat16

    def runtime(**kw):
        return build_offload_runtime(model, params,
                                     rng=np.random.default_rng(5),
                                     device="cpu", **kw)

    def serve(rt, **kw):
        eng = ServingEngine(model, params, max_len=32, mode="offload",
                            offload=rt, device="cpu", **kw)
        try:
            return eng.serve(_requests(Request))
        finally:
            eng.close()

    serial = serve(runtime())
    rt = runtime(train_lookahead=True)
    assert rt.lookahead[0].w1.dtype == torch.float32
    res = serve(rt, prefetch=True)
    oracle = serve(runtime(), prefetch=True, lookahead="oracle")
    for a, b, c in zip(serial, res, oracle):
        assert a.tokens == b.tokens == c.tokens
        assert a.io_seconds == c.io_seconds > 0
    reads = sum(t.io.seconds for e in rt.engines for t in e.history)
    assert abs(sum(r.io_seconds for r in res) - reads) <= 1e-12 * reads
    assert rt.io_summary()["degraded_steps"] == 0
    assert _no_worker_threads()


# -- predictors in the loop (oracle=False) -----------------------------------

def test_predictor_in_the_loop_matches_reference(env):
    """`oracle=False`: per-layer predictors, trained by the reference on
    its calibration hiddens and masks, converted; the port's server
    predicts each layer's mask on the device and gives the reference's
    masks, tokens and per-uid flash I/O."""
    from repro.core.predictor import PredictorConfig as JPredictorConfig
    from repro.core.predictor import train_predictor as jtrain_predictor
    jrt, rt = _runtimes(env, seed=6)
    tokens = np.random.default_rng(6).integers(0, 128, (8, 32))
    out = env["jmodel"].forward(env["jparams"],
                                {"tokens": jax.numpy.asarray(tokens)},
                                capture_activations=True)
    hid = np.asarray(out["ffn_inputs"]).reshape(2, -1, 48)
    msk = np.asarray(out["ffn_pre_act"] > 0).reshape(2, -1, 192)
    pcfg = JPredictorConfig(d_model=48, n_neurons=192, lr=3e-3,
                            pos_weight=4.0)
    jpreds = [jtrain_predictor(pcfg, hid[l], msk[l].astype(np.float32),
                               epochs=4, seed=l)[0] for l in range(2)]
    jrt.predictors = jpreds
    rt.predictors = _convert(jpreds)

    def serve(server_cls, request_cls, model, params, **kw):
        server = server_cls(model, params, max_slots=3, max_len=32,
                            mode="offload", oracle=False, **kw)
        masks = []
        true_masks = server._true_masks

        def recorded(*a, **k):
            out = true_masks(*a, **k)
            masks.append(np.array(out))
            return out
        server._true_masks = recorded
        handles = [server.submit(r) for r in _requests(request_cls)]
        server.drain()
        server.close()
        return [h.result for h in handles], masks

    jres, jmasks = serve(JInferenceServer, JRequest, env["jmodel"],
                         env["jparams"], offload=jrt)
    res, masks = serve(InferenceServer, Request, env["model"], env["params"],
                       offload=rt, device="cpu")
    assert len(masks) == len(jmasks) > 0
    for m, jm in zip(masks, jmasks):
        np.testing.assert_array_equal(m, jm)
    _assert_same(res, jres, rt, jrt)
    with pytest.raises(ValueError, match="predictors"):
        InferenceServer(env["model"], env["params"], mode="offload",
                        offload=_runtimes(env)[1], oracle=False,
                        device="cpu")


def test_ffn_apply_equals_dense_ffn():
    """The single-set interface: the oracle mask's FFN from flash bundles
    equals the dense FFN under relu, and a predictor that fires on every
    neuron (oracle_mask=None) does too."""
    rng = np.random.default_rng(1)
    d, n, L = 32, 256, 2
    cfg = get_config("granite-3-2b", reduced=True, d_model=d,
                     activation="relu")
    ws = [FFNWeights(
        w_up=torch.from_numpy((rng.standard_normal((n, d)) * 0.2)
                              .astype(np.float32)),
        w_down=torch.from_numpy((rng.standard_normal((n, d)) * 0.2)
                                .astype(np.float32))) for _ in range(L)]
    everything = PredictorParams(
        torch.zeros((d, 4)), torch.zeros(4), torch.zeros((4, n)),
        torch.full((n,), 10.0))
    from repro_torch.core.engine import EngineConfig
    runtime = OffloadedFFNRuntime(
        cfg, [make_bundles(w) for w in ws],
        [identity_placement(n) for _ in range(L)],
        predictors=[everything] * L,
        engine_cfg=EngineConfig(cache_ratio=0.2), device="cpu")
    h = torch.from_numpy(rng.standard_normal((3, d)).astype(np.float32))
    for layer in range(L):
        mask = (h @ ws[layer].w_up.T > 0).numpy()
        ref = dense_ffn(h, ws[layer], activation="relu").numpy()
        y, stats = runtime.ffn_apply(layer, h, oracle_mask=mask)
        np.testing.assert_allclose(y.numpy(), ref, rtol=1e-4, atol=1e-4)
        assert stats.n_activated == int(np.any(mask, axis=0).sum())
        y, stats = runtime.ffn_apply(layer, h)       # through the predictor
        np.testing.assert_allclose(y.numpy(), ref, rtol=1e-4, atol=1e-4)
        assert stats.n_activated == n
    summ = runtime.io_summary()
    assert summ["io_seconds_per_token"] > 0 and summ["ops_per_token"] >= 2


def test_speculative_prefetch_on_silu_is_refused(env):
    """The reference's exactness rule: speculative lookahead over-predicts,
    which only relu/relu2 make exact, so `prefetch=True` with lookahead
    params on a silu model raises; `lookahead="oracle"` serves."""
    cfg = get_config("qwen2-7b", reduced=True, d_model=48, d_ff=192,
                     n_layers=2, vocab_size=128)
    assert cfg.activation == "silu"
    model = build_model(cfg, device="cpu")
    params = model.init_params()
    rt = build_offload_runtime(model, params, calib_batch=(2, 16),
                               train_lookahead=True, device="cpu")
    assert rt.lookahead is not None
    with pytest.raises(ValueError, match="exact only for relu/relu2"):
        InferenceServer(model, params, mode="offload", offload=rt,
                        prefetch=True, device="cpu")
    with pytest.raises(ValueError, match="unknown lookahead"):
        InferenceServer(model, params, mode="offload", offload=rt,
                        prefetch=True, lookahead="bogus", device="cpu")
    eng = ServingEngine(model, params, max_len=32, mode="offload",
                        offload=rt, prefetch=True, lookahead="oracle",
                        device="cpu")
    res = eng.serve(_requests(Request, new=3))
    eng.close()
    assert all(len(r.tokens) == 3 for r in res) and _no_worker_threads()
