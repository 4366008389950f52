"""Sliding-window (`swa=True`) serving in the port against the reference.

Reduced qwen2-7b (GQA, gated silu) and opt-350m (relu), 2 layers, d_model
64, a window of 8 slots, the reference's weights converted into the port.
Prefill and decode logits and the ring's k / v / pos after every step must
match `model.init_cache(swa=True)` of the reference, for prompts shorter
and longer than the window and decode past the wrap. The port's
`InferenceServer(swa=True)` (resident and offload) and `ServingEngine(swa=
True)` must emit the reference's greedy tokens and per-uid flash I/O
seconds, with five requests on four slots (the last admitted into a reused
slot). Every decode attention goes through `ops.swa_decode_attention`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.engine import build_offload_runtime as jbuild_runtime
from repro.serving.server import InferenceServer as JInferenceServer
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models.kvcache import SWACache, attend_swa_cache
from repro_torch.serving.engine import (Request, ServingEngine,
                                        build_offload_runtime)
from repro_torch.serving.server import InferenceServer

torch.set_num_threads(1)

SMALL = dict(d_model=64, d_ff=256, n_layers=2, vocab_size=128,
             sliding_window=8)
# five requests on four slots: prompts longer and shorter than the window,
# uid 4 admitted into the slot uid 2 frees
LENS, NEW = (11, 5, 3, 9, 4), (6, 9, 4, 5, 7)
MAX_LEN = 24


def _pair(arch, seed=0, **overrides):
    jcfg = jget_config(arch, reduced=True, **SMALL, **overrides)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(seed))
    cfg = get_config(arch, reduced=True, **SMALL, **overrides)
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               cfg, device="cpu")
    return jmodel, jparams, model, params


@pytest.fixture(scope="module")
def opt_pair():
    return _pair("opt-350m")


@pytest.fixture(scope="module")
def qwen_pair():
    return _pair("qwen2-7b", seed=1)


def _assert_rings(cache, jcache):
    """Every layer's ring equals the reference's: k / v to float32
    rounding, pos exactly."""
    for g, group in enumerate(cache):
        ring, jring = group["sub_0"], jcache["sub_0"]
        assert isinstance(ring, SWACache)
        np.testing.assert_array_equal(ring.pos.numpy(),
                                      np.asarray(jring.pos)[g])
        for name in ("k", "v"):
            np.testing.assert_allclose(getattr(ring, name).numpy(),
                                       np.asarray(getattr(jring, name))[g],
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["qwen2-7b", "opt-350m"])
@pytest.mark.parametrize("T", [5, 13], ids=["short", "wrapped"])
def test_prefill_decode_and_rings_match_reference(arch, T, opt_pair,
                                                  qwen_pair):
    """Prefill (full causal over the prompt, the ring keeps its last W
    positions) and 12 decode steps with per-row positions, past the wrap:
    logits and rings after every step."""
    jmodel, jparams, model, params = (qwen_pair if arch == "qwen2-7b"
                                      else opt_pair)
    rng = np.random.default_rng(T)
    prompt = rng.integers(0, SMALL["vocab_size"], (2, T)).astype(np.int32)
    jcache = jmodel.init_cache(2, MAX_LEN, swa=True)
    cache = model.init_cache(2, MAX_LEN, swa=True)
    jlog, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                                  jcache)
    log, cache = model.prefill(params, {"tokens": torch.as_tensor(
        prompt, dtype=torch.int64)}, cache)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=1e-4,
                               atol=1e-4)
    _assert_rings(cache, jcache)
    ops.reset_counts()
    for i in range(12):
        tok = np.asarray(jnp.argmax(jlog[:, -1], axis=-1)).astype(np.int32)
        pos = np.full((2,), T + i, np.int32)
        jlog, jcache = jmodel.decode_step(jparams, jnp.asarray(tok[:, None]),
                                          jnp.asarray(pos), jcache)
        log, cache = model.decode_step(
            params, torch.as_tensor(tok[:, None], dtype=torch.int64),
            torch.as_tensor(pos), cache)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=1e-4,
                                   atol=1e-4)
        _assert_rings(cache, jcache)
    assert int(cache[0]["sub_0"].pos.max()) == T + 11 >= SMALL["sliding_window"]
    c = ops.counts["swa_decode"]
    assert (c.launches, c.plain_calls) == (0, 12 * SMALL["n_layers"])


def test_attend_swa_cache_matches_reference():
    """The port's jnp-style ring attention (`attend_swa_cache`) equals the
    reference's on a wrapped ring with per-row query positions."""
    from repro.models import kvcache as jkv
    rng = np.random.default_rng(5)
    B, W, KV, hd, H = 2, 8, 2, 16, 4
    k = rng.standard_normal((B, W, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, W, KV, hd)).astype(np.float32)
    pos = np.array([list(range(8, 16)), [0, 1, 2, 3, 4, -1, -1, -1]],
                   np.int32)                 # row 0 wrapped, row 1 part-full
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    q_pos = np.array([[15], [4]], np.int32)
    want = jkv.attend_swa_cache(jnp.asarray(q), jkv.SWACache(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos)),
        jnp.asarray(q_pos), window=6)
    got = attend_swa_cache(torch.from_numpy(q), SWACache(
        torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(pos)),
        torch.from_numpy(q_pos), window=6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _requests(cls):
    rng = np.random.default_rng(3)
    return [cls(uid=i, prompt=rng.integers(1, 127, n).tolist(),
                max_new_tokens=m)
            for i, (n, m) in enumerate(zip(LENS, NEW))]


def _serve(server_cls, request_cls, model, params, **kw):
    server = server_cls(model, params, max_slots=4, max_len=MAX_LEN,
                        swa=True, **kw)
    handles = [server.submit(r) for r in _requests(request_cls)]
    server.drain()
    server.close()
    return {h.uid: h.result for h in handles}, server


@pytest.mark.parametrize("arch,mode", [("opt-350m", "resident"),
                                       ("opt-350m", "offload"),
                                       ("qwen2-7b", "resident")])
def test_swa_server_matches_reference(arch, mode, opt_pair, qwen_pair):
    """Greedy tokens, finish reasons, server counters and (offload) per-uid
    I/O seconds of the port's swa server equal the reference's; every
    decode attention sublayer went through the dispatcher; the reused slot
    holds its new request's ring only."""
    jmodel, jparams, model, params = (qwen_pair if arch == "qwen2-7b"
                                      else opt_pair)
    jkw, kw = {}, {}
    if mode == "offload":
        jkw = dict(mode="offload", offload=jbuild_runtime(
            jmodel, jparams, rng=np.random.default_rng(1),
            calib_batch=(4, 32)))
        kw = dict(mode="offload", offload=build_offload_runtime(
            model, params, rng=np.random.default_rng(1), calib_batch=(4, 32),
            device="cpu"))
    jres, jserver = _serve(JInferenceServer, JRequest, jmodel, jparams, **jkw)
    ops.reset_counts()
    res, server = _serve(InferenceServer, Request, model, params,
                         device="cpu", **kw)
    c = ops.counts["swa_decode"]
    assert (c.launches, c.plain_calls) == (
        0, server.stats.decode_steps * SMALL["n_layers"])
    assert res.keys() == jres.keys()
    for uid, r in res.items():
        assert r.tokens == jres[uid].tokens, uid
        assert r.finish_reason == jres[uid].finish_reason == "length", uid
        assert r.io_seconds == jres[uid].io_seconds, uid
        if mode == "offload":
            assert r.io_seconds > 0, uid
    secs = dict(prefill_seconds=0, decode_seconds=0)
    assert dataclasses.asdict(server.stats) | secs == \
        dataclasses.asdict(jserver.stats) | secs
    # uid 4 (4 + 7 tokens) took over the slot of uid 2: only its positions
    ring = server._cache[0]["sub_0"].pos
    slot4 = [s for s in range(4) if int(ring[s].max()) == LENS[4] + NEW[4] - 2]
    assert slot4 and sorted(ring[slot4[0]][ring[slot4[0]] >= 0].tolist()) == \
        list(range(LENS[4] + NEW[4] - 1 - 8, LENS[4] + NEW[4] - 1))


def test_serving_engine_swa_matches_reference(opt_pair):
    jmodel, jparams, model, params = opt_pair
    jres = JServingEngine(jmodel, jparams, max_len=MAX_LEN,
                          swa=True).serve(_requests(JRequest))
    ops.reset_counts()
    res = ServingEngine(model, params, max_len=MAX_LEN, swa=True,
                        device="cpu").serve(_requests(Request))
    assert [r.tokens for r in res] == [r.tokens for r in jres]
    assert ops.counts["swa_decode"].plain_calls > 0


def test_swa_option_rules():
    """`swa` with `kv_quant` gives the float ring (swa takes precedence, as
    in the reference); `swa` with `page_size` is a ValueError in both
    packages."""
    jmodel, jparams, model, params = _pair("opt-350m", kv_quant=True)
    jring = jmodel.init_cache(2, 16, swa=True)["sub_0"]
    ring = model.init_cache(2, 16, swa=True)[0]["sub_0"]
    assert type(jring).__name__ == type(ring).__name__ == "SWACache"
    assert ring.k.dtype == torch.float32 and str(jring.k.dtype) == "float32"
    assert tuple(ring.k.shape) == np.asarray(jring.k).shape[1:]
    with pytest.raises(ValueError, match="swa"):
        InferenceServer(model, params, max_len=16, swa=True, page_size=4,
                        num_pages=8, device="cpu")
    with pytest.raises(ValueError, match="swa"):
        JInferenceServer(jmodel, jparams, max_len=16, swa=True, page_size=4,
                         num_pages=8)
