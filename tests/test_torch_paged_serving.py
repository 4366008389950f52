"""Paged (and int8) KV serving in the port against the reference.

Reduced opt-350m (2 layers, d_model 64, page size 4), the reference's
weights converted into the port. Requests of mixed lengths include an
exact duplicate prompt (a live fork whose first decode write copies the
shared partial page) and an extension of another prompt (a prefix hit).
The port's paged `InferenceServer` must emit the reference's greedy tokens
with identical page-pool counters, resident, offload (identical per-uid
flash I/O seconds too) and with the int8 cache; under temperature sampling
its paged tokens must equal its own contiguous tokens. Page pressure must
preempt the same victim as the reference, abort must release every page,
and the paged options must be validated as the reference validates them.
A bf16 model (bf16 page arena) must give the reference's bf16 paged
server's tokens and counters, the reference run compiled.
"""
import dataclasses

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
from repro_torch.models.transformer import init_paged_stack_cache
from repro_torch.serving.engine import Request, build_offload_runtime
from repro_torch.serving.server import InferenceServer

torch.set_num_threads(1)

SMALL = dict(d_model=64, d_ff=256, n_layers=2, vocab_size=128)
PAGED = dict(page_size=4, num_pages=36)


def _pair(seed=0, **overrides):
    jcfg = jget_config("opt-350m", reduced=True, **SMALL, **overrides)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(seed))
    cfg = get_config("opt-350m", reduced=True, **SMALL, **overrides)
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               cfg, device="cpu")
    return jmodel, jparams, model, params


@pytest.fixture(scope="module")
def f32_pair():
    return _pair()


def _requests(temperature=0.0, seed=3):
    """uid 1 repeats uid 0's prompt (admitted in the same step: a live fork
    of its partial last page), uid 6 extends uid 2's prompt (a prefix hit
    on its full pages); the rest are random, of mixed lengths."""
    rng = np.random.default_rng(seed)
    lens, new = (6, 6, 9, 13, 5, 7), (5, 6, 4, 7, 3, 6)
    prompts = [rng.integers(1, 127, n).tolist() for n in lens]
    prompts[1] = list(prompts[0])
    reqs = [dict(uid=i, prompt=p, max_new_tokens=n, temperature=temperature)
            for i, (p, n) in enumerate(zip(prompts, new))]
    reqs.append(dict(uid=6, prompt=prompts[2] + [9, 9, 9], max_new_tokens=4,
                     temperature=temperature))
    return reqs


def _serve(server_cls, request_cls, model, params, reqs, max_slots=3,
           max_len=48, **kw):
    server = server_cls(model, params, max_slots=max_slots, max_len=max_len,
                        **kw)
    handles = [server.submit(request_cls(**dict(r, prompt=list(r["prompt"]))))
               for r in reqs]
    server.drain()
    server.close()
    return {h.uid: h.result for h in handles}, server


def _assert_same_tokens(a, b):
    assert a.keys() == b.keys()
    for uid in a:
        assert a[uid].tokens == b[uid].tokens, uid
        assert a[uid].finish_reason == b[uid].finish_reason, uid


def _reclaimed(server):
    pool = server._pool
    assert pool.n_live == pool.n_evictable()   # only the registry holds pages
    pool.clear_prefix_cache()
    pool.check()
    assert pool.n_free == pool.num_pages


@pytest.mark.parametrize("mode", ["resident", "offload", "int8"])
def test_paged_server_matches_reference(f32_pair, mode):
    """Greedy tokens, pool counters and (offload) per-uid I/O seconds of the
    port's paged server equal the reference's; every paged attention
    sublayer of every decode step went through the dispatcher."""
    jmodel, jparams, model, params = (_pair(seed=2, kv_quant=True)
                                      if mode == "int8" else f32_pair)
    reqs = _requests()
    kw, jkw = dict(PAGED), dict(PAGED)
    if mode == "offload":
        jkw.update(mode="offload", offload=jbuild_runtime(
            jmodel, jparams, rng=np.random.default_rng(1)))
        kw.update(mode="offload", offload=build_offload_runtime(
            model, params, rng=np.random.default_rng(1), device="cpu"))
    jres, jserver = _serve(JInferenceServer, JRequest, jmodel, jparams, reqs,
                           **jkw)
    ops.reset_counts()
    res, server = _serve(InferenceServer, Request, model, params, reqs,
                         device="cpu", **kw)
    paged = ops.counts["paged_decode"]
    assert (paged.launches, paged.plain_calls) == (
        0, server.stats.decode_steps * SMALL["n_layers"])
    _assert_same_tokens(res, jres)
    assert all(r.finish_reason == "length" for r in res.values())
    assert server.page_summary() == jserver.page_summary()
    assert dataclasses.asdict(server.stats) | dict(
        prefill_seconds=0, decode_seconds=0) == \
        dataclasses.asdict(jserver.stats) | dict(prefill_seconds=0,
                                                 decode_seconds=0)
    assert server.stats.prefix_hits >= 1 and server.stats.cow_copies >= 1
    assert server._pool.quant == (mode == "int8")
    if mode == "offload":
        for uid, r in res.items():
            assert r.io_seconds == jres[uid].io_seconds > 0, uid
    _reclaimed(server)


def test_paged_equals_contiguous_under_temperature(f32_pair):
    """Temperature sampling draws from per-uid generators, so the paged and
    contiguous layouts must give the same sampled tokens (the attention
    math is bitwise the same on the CPU)."""
    _, _, model, params = f32_pair
    reqs = _requests(temperature=0.8, seed=5)
    base, _ = _serve(InferenceServer, Request, model, params, reqs,
                     device="cpu")
    paged, server = _serve(InferenceServer, Request, model, params, reqs,
                           device="cpu", **PAGED)
    _assert_same_tokens(paged, base)
    assert server.stats.prefix_hits >= 1
    assert server.stats.preemptions == 0
    _reclaimed(server)


def _pressure_requests(seed):
    rng = np.random.default_rng(seed)
    return [dict(uid=i, prompt=rng.integers(1, 127, 8).tolist(),
                 max_new_tokens=16, priority=1 if i == 0 else 0)
            for i in range(4)]


@pytest.mark.parametrize("overcommit", [False, True],
                         ids=["strict", "overcommit"])
def test_page_pressure_matches_reference(f32_pair, overcommit):
    """A pool that cannot hold every request at once: strict admission
    defers (and never preempts), overcommit preempts the lowest-priority
    request — the same deferrals, the same victims, the same tokens as the
    reference, and every page reclaimed."""
    jmodel, jparams, model, params = f32_pair
    reqs = _pressure_requests(11)
    kw = dict(max_slots=4, max_len=48, page_size=4, num_pages=10,
              page_overcommit=overcommit)
    jres, jserver = _serve(JInferenceServer, JRequest, jmodel, jparams, reqs,
                           **kw)
    res, server = _serve(InferenceServer, Request, model, params, reqs,
                         device="cpu", **kw)
    _assert_same_tokens(res, jres)
    assert server.page_summary() == jserver.page_summary()
    if overcommit:
        assert res[0].finish_reason == "length"
        preempted = [u for u, r in res.items()
                     if r.finish_reason == "preempted"]
        assert preempted and server.stats.preemptions == len(preempted)
        assert all(len(res[u].tokens) >= 1 for u in preempted)
    else:
        assert all(r.finish_reason == "length" for r in res.values())
        assert server.stats.preemptions == 0
        assert server.stats.page_deferrals >= 1
    _reclaimed(server)


def test_abort_releases_pages(f32_pair):
    _, _, model, params = f32_pair
    rng = np.random.default_rng(6)
    server = InferenceServer(model, params, max_slots=2, max_len=48,
                             page_size=4, num_pages=24, device="cpu")
    for i in range(3):
        server.submit(Request(uid=i, prompt=rng.integers(1, 127, 9).tolist(),
                              max_new_tokens=8))
    server.step()
    assert server._pool.n_live > server._pool.n_evictable()
    assert server.abort() == 3
    assert not server._tables
    _reclaimed(server)


def test_paged_validation_matches_reference(f32_pair):
    """The paged options raise ValueError where the reference's do: one of
    page_size/num_pages alone, paging with swa, an SSM stack, and a request
    larger than the whole pool."""
    _, _, model, params = f32_pair
    with pytest.raises(ValueError, match="both page_size and num_pages"):
        InferenceServer(model, params, max_len=32, page_size=4, device="cpu")
    with pytest.raises(ValueError, match="both page_size and num_pages"):
        InferenceServer(model, params, max_len=32, num_pages=4, device="cpu")
    with pytest.raises(ValueError, match="swa"):
        InferenceServer(model, params, max_len=32, swa=True, page_size=4,
                        num_pages=8, device="cpu")
    with pytest.raises(ValueError, match="attention-only"):
        init_paged_stack_cache(get_config("jamba-1.5-large-398b",
                                          reduced=True), 8, 4, "cpu")
    server = InferenceServer(model, params, max_slots=2, max_len=64,
                             page_size=4, num_pages=8, device="cpu")
    with pytest.raises(ValueError, match="pages"):      # 32 KV positions
        server.submit(Request(uid=0, prompt=list(range(1, 30)),
                              max_new_tokens=10))
    server.submit(Request(uid=1, prompt=list(range(1, 20)),
                          max_new_tokens=10))           # 8 pages: fits


BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")


def test_bf16_paged_server_matches_reference():
    """A bf16 model (bf16 params, compute and page arena) served paged: the
    port's greedy tokens, page-pool summary and server counters equal the
    reference's bf16 paged server's, the reference run compiled (its
    tokens need no `jax.disable_jit()` here), and its tokens equal the
    port's own bf16 contiguous server's; every decode attention went
    through the dispatcher's plain version."""
    jmodel, jparams, model, params = _pair(seed=4, **BF16)
    assert model.cfg.dtype() == torch.bfloat16
    reqs = _requests(seed=9)
    jres, jserver = _serve(JInferenceServer, JRequest, jmodel, jparams, reqs,
                           **PAGED)
    ops.reset_counts()
    res, server = _serve(InferenceServer, Request, model, params, reqs,
                         device="cpu", **PAGED)
    paged = ops.counts["paged_decode"]
    assert (paged.launches, paged.plain_calls) == (
        0, server.stats.decode_steps * SMALL["n_layers"])
    assert server._pool.cache_groups[0]["sub_0"].k.dtype == torch.bfloat16
    _assert_same_tokens(res, jres)
    assert server.page_summary() == jserver.page_summary()
    assert dataclasses.asdict(server.stats) | dict(
        prefill_seconds=0, decode_seconds=0) == \
        dataclasses.asdict(jserver.stats) | dict(prefill_seconds=0,
                                                 decode_seconds=0)
    assert server.stats.prefix_hits >= 1 and server.stats.cow_copies >= 1
    base, _ = _serve(InferenceServer, Request, model, params, reqs,
                     device="cpu")
    _assert_same_tokens(res, base)
    _reclaimed(server)
