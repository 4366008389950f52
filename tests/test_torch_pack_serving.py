"""Serving from a NeuronPack in the port against the reference: a pack the
reference built, served by the port's `InferenceServer(pack_path=...)` with
the reference's weights converted, emits the reference server's greedy
tokens and per-uid flash I/O seconds, with and without CRC verification and
under seeded recoverable fault schedules; plus the `pack_path` rules, the
runtime's store lifecycle and the command lines.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.serving.engine import OffloadedFFNRuntime as JRuntime
from repro.serving.engine import Request as JRequest
from repro.serving.server import InferenceServer as JInferenceServer
from repro.store import RetryPolicy as JRetryPolicy
from repro.store import build_pack as jbuild_pack
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.serving.engine import (OffloadedFFNRuntime, Request,
                                        ServingEngine)
from repro_torch.serving.server import InferenceServer
from repro_torch.store import FaultEvent, FaultPlan, RetryPolicy

torch.set_num_threads(1)

SMALL = dict(d_model=64, d_ff=256, n_layers=2, vocab_size=128)
LENS, NEW = (6, 9, 12), (5, 7, 4)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("packs")
    jcfg = jget_config("opt-350m", reduced=True, **SMALL)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = get_config("opt-350m", reduced=True, **SMALL)
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               cfg, device="cpu")
    paths = {}
    for q in ("none", "int8"):
        paths[q] = str(tmp / f"{q}.npack")
        jbuild_pack(jmodel, jparams, paths[q], calib_tokens=128,
                    calib_batch=4, calib_seqlen=32, quantize=q)
    return dict(jcfg=jcfg, jmodel=jmodel, jparams=jparams, cfg=cfg,
                model=model, params=params, paths=paths)


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, SMALL["vocab_size"], T).astype(np.int32)
            for T in LENS]


def _serve(server_cls, request_cls, model, params, **kw):
    server = server_cls(model, params, max_slots=2, max_len=32,
                        mode="offload", **kw)
    handles = [server.submit(request_cls(uid=i, prompt=p, max_new_tokens=n))
               for i, (p, n) in enumerate(zip(_prompts(), NEW))]
    server.drain()
    server.close()
    return handles, server


def _reference(env, quantize, **from_pack):
    rt = JRuntime.from_pack(env["jcfg"], env["paths"][quantize], **from_pack)
    try:
        handles, _ = _serve(JInferenceServer, JRequest, env["jmodel"],
                            env["jparams"], offload=rt)
        return handles, rt.io_summary()
    finally:
        rt.close()


@pytest.mark.parametrize("verify", [False, True], ids=["plain", "crc"])
@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_reference_pack_served_by_port_matches_reference(env, quantize,
                                                         verify):
    jhandles, js = _reference(env, quantize, verify_checksums=verify)
    ops.reset_counts()
    kw = dict(verify_checksums=True) if verify else {}
    handles, server = _serve(InferenceServer, Request, env["model"],
                             env["params"], pack_path=env["paths"][quantize],
                             device="cpu", **kw)
    ffn = ops.counts["sparse_ffn_segments_fused"]
    assert ffn.launches == 0
    assert ffn.plain_calls == server.stats.decode_steps * SMALL["n_layers"]
    for h, jh, n in zip(handles, jhandles, NEW):
        assert h.result.finish_reason == jh.result.finish_reason == "length"
        assert len(h.result.tokens) == n
        assert h.result.tokens == jh.result.tokens
        assert h.result.io_seconds == jh.result.io_seconds > 0
    ts = server.offload.io_summary()
    for key in ("io_seconds_per_token", "cache_hit_rate", "mean_run_length",
                "ops_per_token", "measured_extents_total",
                "measured_bytes_total", "retries", "corrupt_extents"):
        assert ts[key] == js[key], key
    assert ts["ffn_kernel"] == js["ffn_kernel"] == "segments"
    # the server built the runtime, so closing the server closed the stores
    assert all(e.store.closed for e in server.offload.engines)


def test_identity_int8_pack_serves_bundles_with_scales(env, tmp_path):
    """An int8 pack with the identity layout goes the bundles path: the
    staged int8 rows are dequantized with their staged scales on the
    device, and the port gives the reference's tokens and per-uid I/O."""
    path = str(tmp_path / "identity8.npack")
    jbuild_pack(env["jmodel"], env["jparams"], path, calib_tokens=128,
                calib_batch=4, calib_seqlen=32, use_placement=False,
                quantize="int8")
    env = dict(env, paths={"identity8": path})
    jhandles, js = _reference(env, "identity8")
    handles, server = _serve(InferenceServer, Request, env["model"],
                             env["params"], pack_path=path, device="cpu")
    assert server.offload.ffn_kernel == js["ffn_kernel"] == "bundles"
    assert server.offload.engines[0].store.quantized
    for h, jh, n in zip(handles, jhandles, NEW):
        assert h.result.finish_reason == jh.result.finish_reason == "length"
        assert len(h.result.tokens) == n
        assert h.result.tokens == jh.result.tokens
        assert h.result.io_seconds == jh.result.io_seconds > 0


def _chaos_plans(mod, seed):
    return [mod.FaultPlan([mod.FaultEvent(0, "transient"),
                           mod.FaultEvent(1, "latency", delay_s=1e-4),
                           mod.FaultEvent(2, "corrupt"),
                           mod.FaultEvent(3, "short_read"),
                           mod.FaultEvent(5, "transient", times=2)],
                          seed=seed + l) for l in range(SMALL["n_layers"])]


def test_recoverable_chaos_matches_reference(env):
    """Explicit recoverable schedules per layer under CRC verification: the
    port's tokens equal its clean run's and the reference's chaos run's, and
    its counters are the plan's and the reference's."""
    import repro.store as jstore
    import repro_torch.store as tstore
    path = env["paths"]["none"]
    clean, _ = _serve(InferenceServer, Request, env["model"], env["params"],
                      pack_path=path, verify_checksums=True, device="cpu")
    jplans = _chaos_plans(jstore, 11)
    jhandles, js = _reference(env, "none", verify_checksums=True,
                              fault_plans=jplans,
                              retry=JRetryPolicy(backoff_s=0))
    plans = _chaos_plans(tstore, 11)
    rt = OffloadedFFNRuntime.from_pack(env["cfg"], path, verify_checksums=True,
                                       fault_plans=plans,
                                       retry=RetryPolicy(backoff_s=0),
                                       device="cpu")
    with rt:
        handles, _ = _serve(InferenceServer, Request, env["model"],
                            env["params"], offload=rt, device="cpu")
        s = rt.io_summary()
    assert [h.result.tokens for h in handles] == \
        [h.result.tokens for h in clean] == [h.result.tokens for h in jhandles]
    assert [p.injected for p in plans] == [p.injected for p in jplans]
    for p in plans:
        assert p.injected["transient"] == 3 and p.injected["corrupt"] == 1
    assert s["retries"] == js["retries"] == sum(
        p.injected["transient"] + p.injected["corrupt"] for p in plans)
    assert s["corrupt_extents"] == js["corrupt_extents"] == sum(
        p.injected["corrupt"] for p in plans)
    assert all(e.store.closed for e in rt.engines)


def test_from_pack_rejects_geometry_mismatch(env):
    path = env["paths"]["none"]
    for wrong in (dict(SMALL, d_ff=128), dict(SMALL, n_layers=3),
                  dict(SMALL, d_model=32)):
        cfg = get_config("opt-350m", reduced=True, **wrong)
        with pytest.raises(ValueError, match="does not fit"):
            OffloadedFFNRuntime.from_pack(cfg, path, device="cpu")
    gelu = dataclasses.replace(env["cfg"], activation="gelu")
    with pytest.raises(ValueError, match="meta.activation"):
        OffloadedFFNRuntime.from_pack(gelu, path, device="cpu")
    with pytest.raises(ValueError, match="fault_plans covers"):
        OffloadedFFNRuntime.from_pack(env["cfg"], path, device="cpu",
                                      fault_plans=[FaultPlan()])
    # predictors and lookahead are ported: from_pack hands them on
    preds, la = [object(), object()], [object()]
    with OffloadedFFNRuntime.from_pack(
            env["cfg"], path, device="cpu", predictors=preds, lookahead=la,
            lookahead_threshold=0.4, max_worker_restarts=3) as rt:
        assert rt.predictors is preds and rt.lookahead is la
        assert (rt.lookahead_threshold, rt.max_worker_restarts) == (0.4, 3)


def test_pack_path_rules(env):
    model, params, path = env["model"], env["params"], env["paths"]["none"]
    rt = OffloadedFFNRuntime.from_pack(env["cfg"], path, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        InferenceServer(model, params, mode="offload", offload=rt,
                        pack_path=path, device="cpu")
    with pytest.raises(ValueError, match="requires mode='offload'"):
        InferenceServer(model, params, pack_path=path, device="cpu")
    with pytest.raises(ValueError, match="pack_path= only"):
        InferenceServer(model, params, mode="offload", offload=rt,
                        verify_checksums=True, device="cpu")
    with pytest.raises(ValueError, match="requires mode='offload'"):
        ServingEngine(model, params, pack_path=path, device="cpu")
    # a caller's runtime stays open when the server closes
    server = InferenceServer(model, params, mode="offload", offload=rt,
                             device="cpu")
    server.close()
    assert not any(e.store.closed for e in rt.engines)
    rt.close()


def test_runtime_close_releases_every_store(env):
    rt = OffloadedFFNRuntime.from_pack(env["cfg"], env["paths"]["int8"],
                                       device="cpu")
    assert rt.n_layers == SMALL["n_layers"]
    assert not any(e.store.closed for e in rt.engines)
    rt.close()
    assert all(e.store.closed for e in rt.engines)
    rt.close()                                   # idempotent
    with OffloadedFFNRuntime.from_pack(env["cfg"], env["paths"]["none"],
                                       device="cpu") as rt2:
        stores = [e.store for e in rt2.engines]
    assert all(s.closed for s in stores)
    # the one-shot engine owns what it built from pack_path
    reqs = [Request(uid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(_prompts(), NEW))]
    with ServingEngine(env["model"], env["params"], max_len=32,
                       mode="offload", pack_path=env["paths"]["none"],
                       device="cpu") as eng:
        results = eng.serve(reqs)
    assert all(e.store.closed for e in eng.offload.engines)
    assert [len(r.tokens) for r in results] == list(NEW)


def test_fatal_fault_propagates_and_injected_counts(env):
    """With no prefetch worker, a fatal fault surfaces from the read."""
    from repro_torch.store import FatalFault
    plans = [FaultPlan([FaultEvent(0, "fatal")]), None]
    with OffloadedFFNRuntime.from_pack(env["cfg"], env["paths"]["none"],
                                       fault_plans=plans,
                                       device="cpu") as rt:
        with pytest.raises(FatalFault):
            rt.engines[0].store.read(np.arange(4))
    assert plans[0].injected["fatal"] == 1


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_pack_and_serve_clis_on_cpu(tmp_path, quantize):
    from repro_torch.launch import pack, serve
    geom = ["--arch", "qwen2-7b", "--n-layers", "2", "--d-model", "64",
            "--d-ff", "256", "--device", "cpu"]
    out = str(tmp_path / "q.npack")
    report = pack.main(geom + ["--out", out, "--quantize", quantize,
                               "--calib-tokens", "128", "--calib-batch", "4",
                               "--calib-seqlen", "32"])
    assert report.quantized == (quantize == "int8") and report.n_layers == 2
    results = serve.main(geom + ["--mode", "offload", "--pack", out,
                                 "--verify-checksums", "--requests", "3",
                                 "--prompt-len", "8", "--new-tokens", "4"])
    assert [len(r.tokens) for r in results] == [4, 4, 4]
    assert all(r.finish_reason == "length" for r in results)
    # the in-memory offload path and the resident path of the same CLI
    for extra in (["--mode", "offload"], []):
        results = serve.main(geom + extra + ["--requests", "2",
                                             "--prompt-len", "6",
                                             "--new-tokens", "3"])
        assert [len(r.tokens) for r in results] == [3, 3]
    # --prefetch: the in-memory runtime trains its lookahead predictors
    # and serves through the prefetch worker, with the serial CLI's tokens
    serial = serve.main(geom + ["--mode", "offload", "--requests", "3",
                                "--prompt-len", "8", "--new-tokens", "4"])
    piped = serve.main(geom + ["--mode", "offload", "--prefetch",
                               "--requests", "3", "--prompt-len", "8",
                               "--new-tokens", "4"])
    assert [r.tokens for r in piped] == [r.tokens for r in serial]
    assert all(r.finish_reason == "length" for r in piped)
    with pytest.raises(SystemExit, match="requires --mode offload"):
        serve.main(geom + ["--pack", out])
    with pytest.raises(SystemExit, match="does not fit"):
        serve.main(["--arch", "qwen2-7b", "--device", "cpu", "--mode",
                    "offload", "--pack", out])
