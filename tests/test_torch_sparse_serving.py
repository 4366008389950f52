"""Predictor-driven segment top-k decode (`cfg.serve_sparse`) in the port
against the reference.

The reference's params, predictors (`ffn_pred`) included, are converted
into the port. `sparse_ffn_decode` must select the reference's segments and
give its output within 2e-4, for relu (reduced opt-350m) and gated silu
(reduced qwen2-7b); at `sparse_frac=1.0` it must equal the dense FFN, alone
and in a whole decode step (the exactness tests of
`tests/test_perf_variants.py:33-71`). A `serve_sparse` resident server must
emit the reference server's greedy tokens with every decode FFN through
`ops.sparse_ffn_segments`; in offload mode the flash FFN override wins, as
in the reference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models.layers import ffn_forward as jffn_forward
from repro.models.layers import init_ffn as jinit_ffn
from repro.models.layers import init_ffn_predictor as jinit_ffn_predictor
from repro.models.layers import sparse_ffn_decode as jsparse_ffn_decode
from repro.serving.engine import Request as JRequest
from repro.serving.engine import build_offload_runtime as jbuild_runtime
from repro.serving.server import InferenceServer as JInferenceServer
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models.layers import (ffn_forward, predict_segments,
                                       sparse_ffn_decode)
from repro_torch.serving.engine import Request, build_offload_runtime
from repro_torch.serving.server import InferenceServer

torch.set_num_threads(1)

# 8 segments of 32 neurons, 3 gathered a step
SMALL = dict(d_model=64, d_ff=256, n_layers=2, vocab_size=128,
             serve_sparse=True, sparse_seg=32, sparse_frac=0.4)
LENS, NEW = (7, 5, 3, 9, 4), (6, 8, 4, 5, 6)


def _pair(arch, seed=0, **overrides):
    kw = dict(SMALL, **overrides)
    jcfg = jget_config(arch, reduced=True, **kw)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(seed))
    cfg = get_config(arch, reduced=True, **kw)
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


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _reference_segments(pred, x, cfg):
    """The reference's selection (src/repro/models/layers.py:392-396)."""
    B, T, d = x.shape
    n_seg = cfg.d_ff // cfg.sparse_seg
    k_seg = max(1, int(n_seg * cfg.sparse_frac))
    scores = jax.nn.relu(x.reshape(B * T, d) @ pred["w1"]) @ pred["w2"]
    _, ids = jax.lax.top_k(scores.astype(jnp.float32).sum(axis=0), k_seg)
    return np.asarray(ids)


@pytest.mark.parametrize("arch", ["opt-350m", "qwen2-7b"])
def test_sparse_ffn_decode_matches_reference(arch, opt_pair, qwen_pair):
    """Every layer's converted `ffn` and `ffn_pred`: the same segment set
    and the same output, within 2e-4, through the dispatcher."""
    jmodel, jparams, model, params = (qwen_pair if arch == "qwen2-7b"
                                      else opt_pair)
    cfg, jcfg = model.cfg, jmodel.cfg
    rng = np.random.default_rng(2)
    for g, group in enumerate(params["stack"]):
        sub = group["sub_0"]
        assert set(sub) >= {"ffn", "ffn_pred"}
        jsub = jax.tree_util.tree_map(lambda a: a[g], jparams["stack"]["sub_0"])
        np.testing.assert_array_equal(sub["ffn_pred"]["w2"].numpy(),
                                      np.asarray(jsub["ffn_pred"]["w2"]))
        x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        want_ids = _reference_segments(jsub["ffn_pred"], jnp.asarray(x), jcfg)
        got_ids = predict_segments(sub["ffn_pred"], torch.from_numpy(x), cfg)
        assert len(want_ids) == 3
        assert set(got_ids.tolist()) == set(want_ids.tolist())
        ops.reset_counts()
        got = sparse_ffn_decode(sub["ffn"], sub["ffn_pred"],
                                torch.from_numpy(x), cfg)
        c = ops.counts["sparse_ffn_segments"]
        assert (c.launches, c.plain_calls) == (0, 1)
        want = jsparse_ffn_decode(jsub["ffn"], jsub["ffn_pred"],
                                  jnp.asarray(x), jcfg)
        assert got.shape == x.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                                   atol=2e-4)


def test_sparse_ffn_decode_full_fraction_is_dense():
    """tests/test_perf_variants.py:33-43 on the reference's weights: every
    segment gathered is the dense FFN, and the reference's sparse output."""
    rng = np.random.default_rng(0)
    kw = dict(reduced=True, d_model=64, d_ff=512, serve_sparse=True,
              sparse_seg=64, sparse_frac=1.0)
    jcfg, cfg = jget_config("internlm2-20b", **kw), get_config("internlm2-20b",
                                                                **kw)
    jp = jinit_ffn(jax.random.PRNGKey(0), jcfg)
    jpred = jinit_ffn_predictor(jax.random.PRNGKey(1), jcfg)
    x = rng.standard_normal((3, 1, 64)).astype(np.float32)
    p, pred = _t(jp), _t(jpred)
    dense, _ = ffn_forward(p, torch.from_numpy(x), cfg)
    sparse = sparse_ffn_decode(p, pred, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(dense.numpy(), sparse.numpy(), rtol=1e-4,
                               atol=1e-4)
    jsparse = jsparse_ffn_decode(jp, jpred, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(sparse.numpy(), np.asarray(jsparse),
                               rtol=1e-4, atol=1e-4)
    jdense, _ = jffn_forward(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jdense), rtol=1e-4,
                               atol=1e-4)


def test_sparse_serve_decode_end_to_end():
    """tests/test_perf_variants.py:46-71: a whole decode step with
    serve_sparse at frac 1.0 equals the dense step (prefill is dense in
    both), on the reference's converted params."""
    kw = dict(reduced=True, d_model=128, d_ff=512, vocab_size=128)
    jcfg_s = dataclasses.replace(jget_config("qwen2-7b", **kw),
                                 serve_sparse=True, sparse_seg=64,
                                 sparse_frac=1.0)
    cfg_d = get_config("qwen2-7b", **kw)
    cfg_s = dataclasses.replace(cfg_d, serve_sparse=True, sparse_seg=64,
                                sparse_frac=1.0)
    jparams = jbuild_model(jcfg_s).init_params(jax.random.PRNGKey(5))
    md, ms = build_model(cfg_d, device="cpu"), build_model(cfg_s, device="cpu")
    ps = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), cfg_s,
                           device="cpu")
    pd = dict(ps, stack=[{j: {k: v for k, v in sub.items() if k != "ffn_pred"}
                          for j, sub in group.items()}
                         for group in ps["stack"]])
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.as_tensor(rng.integers(0, 128, (2, 8)))}
    ld, cd = md.prefill(pd, batch, md.init_cache(2, 16))
    ls, cs = ms.prefill(ps, batch, ms.init_cache(2, 16))
    torch.testing.assert_close(ld, ls, rtol=1e-5, atol=1e-5)
    tok = ld[:, -1].argmax(-1)[:, None]
    ops.reset_counts()
    od, _ = md.decode_step(pd, tok, 8, cd)
    assert ops.counts["sparse_ffn_segments"].plain_calls == 0
    os_, _ = ms.decode_step(ps, tok, 8, cs)
    assert ops.counts["sparse_ffn_segments"].plain_calls == cfg_s.n_layers
    torch.testing.assert_close(od, os_, rtol=1e-3, atol=1e-3)


def _requests(cls):
    rng = np.random.default_rng(4)
    return [cls(uid=i, prompt=rng.integers(1, 127, n).tolist(),
                max_new_tokens=m)
            for i, (n, m) in enumerate(zip(LENS, NEW))]


def _serve(server_cls, request_cls, model, params, **kw):
    server = server_cls(model, params, max_slots=4, max_len=24, **kw)
    handles = [server.submit(r) for r in _requests(request_cls)]
    server.drain()
    server.close()
    return {h.uid: h.result for h in handles}, server


@pytest.mark.parametrize("arch", ["opt-350m", "qwen2-7b"])
def test_sparse_resident_server_matches_reference(arch, opt_pair, qwen_pair):
    """A serve_sparse resident server: the reference's greedy tokens, five
    requests on four slots, every decode FFN through the dispatcher."""
    jmodel, jparams, model, params = (qwen_pair if arch == "qwen2-7b"
                                      else opt_pair)
    jres, _ = _serve(JInferenceServer, JRequest, jmodel, jparams)
    ops.reset_counts()
    res, server = _serve(InferenceServer, Request, model, params,
                         device="cpu")
    c = ops.counts["sparse_ffn_segments"]
    assert (c.launches, c.plain_calls) == (
        0, server.stats.decode_steps * SMALL["n_layers"])
    for uid, r in res.items():
        assert r.tokens == jres[uid].tokens, uid
        assert r.finish_reason == jres[uid].finish_reason == "length", uid


def test_offload_override_wins(opt_pair):
    """Offload decode of a serve_sparse model computes every FFN from the
    flash bundles (the fused segment FFN), never the predictor's segments:
    the reference's tokens and per-uid I/O seconds."""
    jmodel, jparams, model, params = opt_pair
    jres, _ = _serve(JInferenceServer, JRequest, jmodel, jparams,
                     mode="offload", offload=jbuild_runtime(
                         jmodel, jparams, rng=np.random.default_rng(1),
                         calib_batch=(4, 32)))
    runtime = build_offload_runtime(model, params, rng=np.random.default_rng(1),
                                    calib_batch=(4, 32), device="cpu")
    ops.reset_counts()
    res, server = _serve(InferenceServer, Request, model, params,
                         mode="offload", offload=runtime, device="cpu")
    assert ops.counts["sparse_ffn_segments"].plain_calls == 0
    assert ops.counts["sparse_ffn_segments_fused"].plain_calls == \
        server.stats.decode_steps * SMALL["n_layers"]
    for uid, r in res.items():
        assert r.tokens == jres[uid].tokens, uid
        assert r.io_seconds == jres[uid].io_seconds > 0, uid
