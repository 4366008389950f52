"""The whole slice: offload serving in the port against the reference.

Reduced opt-350m, the reference's weights converted into the port, and
both runtimes calibrated on the same random-token trace, which must give
the same placements layer by layer. Three requests of mixed prompt
lengths share two decode slots (admission is staggered, requests retire
mid-flight). The port's offload `InferenceServer` (its dense FFNs through
the fused segment path's plain version, the CPU route of the dispatcher)
must emit the reference's greedy tokens with the same per-uid flash I/O
seconds, and the same tokens as the port's resident server.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.serving.engine import Request as JRequest
from repro.serving.engine import build_offload_runtime as jbuild_runtime
from repro.serving.server import InferenceServer as JInferenceServer
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.serving.engine import (Request, ServingEngine,
                                        build_offload_runtime)
from repro_torch.serving.server import InferenceServer

# tiny shapes: one intra-op thread each, so the parallel test run does not
# oversubscribe the machine's cores
torch.set_num_threads(1)

SMALL = dict(d_model=64, d_ff=256, n_layers=2, vocab_size=128)
LENS, NEW = (6, 9, 12), (5, 7, 4)


@pytest.fixture(scope="module")
def both():
    jcfg = jget_config("opt-350m", reduced=True, **SMALL)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    jruntime = jbuild_runtime(jmodel, jparams, rng=np.random.default_rng(0),
                              calib_batch=(4, 32))
    cfg = get_config("opt-350m", reduced=True, **SMALL)
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               cfg, device="cpu")
    runtime = build_offload_runtime(model, params,
                                    rng=np.random.default_rng(0),
                                    calib_batch=(4, 32), device="cpu")
    return jmodel, jparams, jruntime, model, params, runtime


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, SMALL["vocab_size"], T).astype(np.int32)
            for T in LENS]


def _serve(server_cls, request_cls, model, params, **kw):
    server = server_cls(model, params, max_slots=2, max_len=32, **kw)
    handles = [server.submit(request_cls(uid=i, prompt=p, max_new_tokens=n))
               for i, (p, n) in enumerate(zip(_prompts(), NEW))]
    server.drain()
    server.close()
    return handles, server.stats


def test_same_placements_and_kernel_path(both):
    jmodel, jparams, jruntime, model, params, runtime = both
    assert runtime.n_layers == jruntime.n_layers == SMALL["n_layers"]
    for je, te in zip(jruntime.engines, runtime.engines):
        np.testing.assert_array_equal(te.placement.placement,
                                      je.placement.placement)
        assert te.placement.mode == je.placement.mode != "identity"
    assert runtime.io_summary()["ffn_kernel"] == "segments"
    assert jruntime.io_summary()["ffn_kernel"] == "segments"


def test_offload_server_matches_reference_and_resident(both):
    jmodel, jparams, jruntime, model, params, runtime = both
    jruntime.reset_stats()
    runtime.reset_stats()
    jhandles, _ = _serve(JInferenceServer, JRequest, jmodel, jparams,
                         mode="offload", offload=jruntime)
    ops.counts.reset()
    handles, stats = _serve(InferenceServer, Request, model, params,
                            mode="offload", offload=runtime, device="cpu")
    # every dense FFN of every decode step went through the dispatcher's
    # CPU route (the plain version); nothing launched
    assert ops.counts.launches == 0
    assert ops.counts.plain_calls == stats.decode_steps * runtime.n_layers > 0
    rhandles, _ = _serve(InferenceServer, Request, model, params,
                         device="cpu")
    for h, jh, rh, n in zip(handles, jhandles, rhandles, NEW):
        assert h.result.finish_reason == jh.result.finish_reason == "length"
        assert len(h.result.tokens) == n
        assert h.result.tokens == jh.result.tokens
        assert h.result.tokens == rh.result.tokens
        assert h.result.io_seconds == jh.result.io_seconds > 0
    # per-uid attribution sums to the engines' merged reads
    merged = sum(t.io.seconds for e in runtime.engines for t in e.history)
    np.testing.assert_allclose(sum(h.result.io_seconds for h in handles),
                               merged, rtol=1e-12)
    js, ts = jruntime.io_summary(), runtime.io_summary()
    for key in ("io_seconds_per_token", "cache_hit_rate", "mean_run_length",
                "effective_bandwidth", "ops_per_token"):
        assert ts[key] == js[key], key


def test_serving_engine_one_shot_matches_server(both):
    jmodel, jparams, jruntime, model, params, runtime = both
    reqs = [Request(uid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(_prompts(), NEW))]
    rhandles, _ = _serve(InferenceServer, Request, model, params,
                         device="cpu")
    with ServingEngine(model, params, max_len=32, mode="offload",
                       offload=runtime, device="cpu") as eng:
        results = eng.serve(reqs)
    assert [r.uid for r in results] == [0, 1, 2]
    assert [r.tokens for r in results] == [h.result.tokens for h in rhandles]


@pytest.mark.parametrize("n_mats,activation,int8", [(2, "relu", False),
                                                    (3, "silu", False),
                                                    (2, "relu", True)])
def test_bundles_ffn_matches_reference(n_mats, activation, int8):
    """The bundles FFN (the identity layout's path) on the same payload,
    valid mask and dequant scales; rtol = atol = 1e-5 (f32 matmuls)."""
    import jax.numpy as jnp
    from repro.core.sparse_ffn import sparse_ffn_from_bundles as jffn
    from repro_torch.core.sparse_ffn import sparse_ffn_from_bundles
    rng = np.random.default_rng(n_mats + 2 * int8)
    d, k = 16, 40
    x = rng.standard_normal((3, d)).astype(np.float32)
    if int8:
        bundles = rng.integers(-127, 128, (k, n_mats * d)).astype(np.int8)
        scales = rng.uniform(0.001, 0.01, k).astype(np.float32)
    else:
        bundles = rng.standard_normal((k, n_mats * d)).astype(np.float32)
        scales = None
    valid = np.arange(k) < 33
    j = None if scales is None else jnp.asarray(scales)
    want = np.asarray(jffn(jnp.asarray(x), jnp.asarray(bundles), d, n_mats,
                           activation, valid_mask=jnp.asarray(valid),
                           scales=j))
    t = None if scales is None else torch.from_numpy(scales)
    got = sparse_ffn_from_bundles(torch.from_numpy(x),
                                  torch.from_numpy(bundles), d, n_mats,
                                  activation, valid_mask=torch.from_numpy(valid),
                                  scales=t).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_identity_layout_serves_bundles_like_reference(both):
    """use_placement=False: "auto" resolves to the bundles path on both
    sides; the segment dispatcher is not called; tokens and per-uid I/O
    equal the reference's."""
    jmodel, jparams, _, model, params, _ = both
    jruntime = jbuild_runtime(jmodel, jparams, rng=np.random.default_rng(0),
                              calib_batch=(2, 8), use_placement=False)
    runtime = build_offload_runtime(model, params,
                                    rng=np.random.default_rng(0),
                                    calib_batch=(2, 8), use_placement=False,
                                    device="cpu")
    assert runtime.io_summary()["ffn_kernel"] == "bundles"
    assert jruntime.io_summary()["ffn_kernel"] == "bundles"
    jhandles, _ = _serve(JInferenceServer, JRequest, jmodel, jparams,
                         mode="offload", offload=jruntime)
    ops.counts.reset()
    handles, _ = _serve(InferenceServer, Request, model, params,
                        mode="offload", offload=runtime, device="cpu")
    assert (ops.counts.launches, ops.counts.plain_calls) == (0, 0)
    for h, jh in zip(handles, jhandles):
        assert h.result.tokens == jh.result.tokens
        assert h.result.io_seconds == jh.result.io_seconds > 0
