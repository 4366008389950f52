"""The MoE, SSM and hybrid decoder families in the port against the reference.

granite-moe-1b-a400m (MoE FFNs), xlstm-125m (mLSTM / sLSTM blocks, no FFN)
and jamba-1.5-large-398b (Mamba + attention + MoE), each at reduced
geometry with the reference's weights converted into the port
(`convert.params_from_numpy`). On the CPU:

- decode continues the teacher-forced forward (the counterpart of
  tests/test_decode_consistency.py:28, with a dropless capacity factor);
- forward logits and aux loss, prefill logits and greedy decode logits
  equal the reference's at rtol = atol = 1e-4, with the greedy tokens
  identical;
- the port's `InferenceServer` emits the reference server's greedy tokens:
  granite-moe contiguous, paged, `swa=True`, and on 8 slots with the
  published 32-expert top-8 router, where an expert's capacity (4) is
  below the batch (8 rows) and overflows (the test counts the overflows);
  jamba contiguous and `swa=True`; xlstm contiguous. Requests of mixed
  lengths on fewer slots than requests, so slots are reused and free
  slots feed the MoE capacity their stale tokens, as in the reference;
- a reused slot keeps nothing of its last request (its SSM states are
  copied leaf by leaf);
- offload serving is refused for these families with the reference's
  messages, and `launch.serve --mode resident` serves each of them.
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
from repro.serving.server import InferenceServer as JInferenceServer
from repro_torch.configs import get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.convert import params_from_numpy
from repro_torch.models import build_model
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer
from repro_torch.serving.engine import (Request, ServingEngine,
                                        build_offload_runtime)
from repro_torch.serving.server import InferenceServer

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["granite-moe-1b-a400m", "jamba-1.5-large-398b", "xlstm-125m"]
SMALL = dict(d_model=64, vocab_size=128)
# the published router's shape (32 experts, top-8) at a small expert width:
# 8 decode rows get a capacity of 4 slots an expert
PUBLISHED_ROUTER = dict(moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=32))


def _dropless(arch, **kw):
    cfg = get_config(arch, reduced=True, **kw)
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts) / cfg.moe.top_k
        + 0.1))


def _pair(arch, seed=0, **overrides):
    """Reference model + params, and the port's model on the CPU with the
    same params."""
    jcfg = jget_config(arch, reduced=True, **overrides)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(seed))
    cfg = get_config(arch, reduced=True, **overrides)
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               cfg, device="cpu")
    return jmodel, jparams, model, params


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Prefill + step-by-step decode reproduce the teacher-forced forward
    (MoE dropless: capacity dropping depends on the batch)."""
    cfg = _dropless(arch)
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(2))
    B, S, P = 2, 20, 16
    tokens = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)))
    with torch.inference_mode():
        full = model.forward(params, {"tokens": tokens})["logits"]
        cache = model.init_cache(B, S + 8)
        lg, cache = model.prefill(params, {"tokens": tokens[:, :P]}, cache)
        errs = [float((lg[:, -1] - full[:, P - 1]).abs().max())]
        for i in range(P, S):
            lg, cache = model.decode_step(params, tokens[:, i:i + 1], i, cache)
            errs.append(float((lg[:, 0] - full[:, i]).abs().max()))
    scale = max(float(full.abs().max()), 1.0)
    assert max(errs) < 2e-3 * scale, (arch, errs)


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_reference(arch):
    jmodel, jparams, model, params = _pair(arch, **SMALL)
    cfg = model.cfg
    B, T, n = 2, 10, 6
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, T))
    jout = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
    with torch.inference_mode():
        out = model.forward(params, {"tokens": torch.as_tensor(tokens)})
    np.testing.assert_allclose(out["logits"].numpy(),
                               np.asarray(jout["logits"]), **TOL)
    np.testing.assert_allclose(float(out["aux_loss"]),
                               float(jout["aux_loss"]), **TOL)
    if cfg.moe is not None:
        assert float(out["aux_loss"]) > 0

    # prefill, then greedy decode, each side taking its own argmax
    jcache, cache = jmodel.init_cache(B, T + n), model.init_cache(B, T + n)
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(
        tokens, jnp.int32)}, jcache)
    with torch.inference_mode():
        lg, cache = model.prefill(params, {"tokens": torch.as_tensor(tokens)},
                                  cache)
        for i in range(n):
            np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
            tok = lg[:, -1].argmax(-1)
            np.testing.assert_array_equal(tok.numpy(),
                                          np.asarray(jl[:, -1].argmax(-1)))
            pos = T + i
            jl, jcache = jmodel.decode_step(
                jparams, jnp.asarray(tok.numpy()[:, None], jnp.int32),
                jnp.full((B,), pos, jnp.int32), jcache)
            lg, cache = model.decode_step(params, tok[:, None],
                                          torch.full((B,), pos), cache)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)


LENS, NEW = (5, 9, 7, 12, 6, 10, 8, 11, 4, 9), (6, 4, 7, 5, 8, 3, 6, 5, 7, 4)


def _prompts(vocab, n):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, T).astype(np.int32) for T in LENS[:n]]


def _serve(server_cls, request_cls, model, params, n_requests, **kw):
    server = server_cls(model, params, max_len=32, **kw)
    handles = [server.submit(request_cls(uid=i, prompt=p, max_new_tokens=m))
               for i, (p, m) in enumerate(zip(
                   _prompts(model.cfg.vocab_size, n_requests), NEW))]
    server.drain()
    server.close()
    return [h.result for h in handles]


SERVER_CASES = [
    pytest.param("granite-moe-1b-a400m", {}, dict(max_slots=2), 4,
                 id="granite-contiguous"),
    pytest.param("granite-moe-1b-a400m", {},
                 dict(max_slots=2, page_size=4, num_pages=24), 4,
                 id="granite-paged"),
    pytest.param("granite-moe-1b-a400m", dict(sliding_window=8),
                 dict(max_slots=2, swa=True), 4, id="granite-swa"),
    pytest.param("granite-moe-1b-a400m", PUBLISHED_ROUTER,
                 dict(max_slots=8), 10, id="granite-8-slots-overflow"),
    pytest.param("jamba-1.5-large-398b", {}, dict(max_slots=2), 4,
                 id="jamba-contiguous"),
    pytest.param("jamba-1.5-large-398b", dict(sliding_window=8),
                 dict(max_slots=2, swa=True), 4, id="jamba-swa"),
    pytest.param("xlstm-125m", {}, dict(max_slots=2), 4, id="xlstm"),
]


@pytest.mark.parametrize("arch,overrides,server_kw,n_requests", SERVER_CASES)
def test_server_tokens_match_reference(arch, overrides, server_kw,
                                       n_requests, monkeypatch):
    jmodel, jparams, model, params = _pair(arch, **SMALL, **overrides)
    overflows = []
    real = moe_lib.moe_forward

    def counting(p, x, cfg, *args):
        # an expert given more rows than its capacity overflows
        _, _, sel = moe_lib.route(p, x.reshape(-1, x.shape[-1]), cfg)
        C = moe_lib._capacity(sel.shape[0], cfg.moe)
        counts = torch.bincount(sel.reshape(-1), minlength=cfg.moe.n_experts)
        overflows.append(int((counts > C).sum()))
        return real(p, x, cfg, *args)

    monkeypatch.setattr(transformer.moe_lib, "moe_forward", counting)
    ref = _serve(JInferenceServer, JRequest, jmodel, jparams, n_requests,
                 **server_kw)
    got = _serve(InferenceServer, Request, model, params, n_requests,
                 device="cpu", **server_kw)
    for r, jr in zip(got, ref):
        assert r.finish_reason == jr.finish_reason == "length", (r, jr)
        assert r.tokens == jr.tokens, (r.uid, r.tokens, jr.tokens)
    if server_kw["max_slots"] == 8:
        assert sum(overflows) > 0, "no expert overflowed"


@pytest.mark.parametrize("arch", ARCHS)
def test_reused_slot_keeps_nothing_of_its_last_request(arch):
    """A request served in a slot another request used gives the tokens it
    gives on a fresh server (dropless MoE: rows do not couple), and after
    its admission every leaf of its slot equals its own prefill's."""
    cfg = _dropless(arch, **SMALL)
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(4))
    a, b = _prompts(cfg.vocab_size, 2)
    alone = _serve_one(model, params, [b])[0]

    server = InferenceServer(model, params, max_slots=1, max_len=32,
                             device="cpu")
    written = []
    write = server._write_slot

    def checked(slot, small):
        write(slot, small)
        for big_g, small_g in zip(server._cache, small):
            for name, big in big_g.items():
                for big_leaf, small_leaf in zip(big, small_g[name]):
                    written.append(torch.equal(big_leaf[slot],
                                               small_leaf[0]))
    server._write_slot = checked
    handles = [server.submit(Request(uid=i, prompt=p, max_new_tokens=5))
               for i, p in enumerate((a, b))]
    server.drain()
    server.close()
    assert written and all(written)
    assert handles[1].result.tokens == alone.tokens


def _serve_one(model, params, prompts):
    server = InferenceServer(model, params, max_slots=1, max_len=32,
                             device="cpu")
    handles = [server.submit(Request(uid=i, prompt=p, max_new_tokens=5))
               for i, p in enumerate(prompts)]
    server.drain()
    server.close()
    return [h.result for h in handles]


@pytest.mark.parametrize("arch", ARCHS)
def test_offload_is_refused_and_resident_engine_serves(arch):
    cfg = get_config(arch, reduced=True, **SMALL)
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(5))
    with pytest.raises(ValueError, match="offload serving covers dense "
                                         "decoder-only archs"):
        InferenceServer(model, params, mode="offload", offload=object(),
                        device="cpu")
    with pytest.raises(ValueError, match="offload runtime covers dense "
                                         "decoder-only archs"):
        build_offload_runtime(model, params, device="cpu")
    prompts = _prompts(cfg.vocab_size, 2)
    with ServingEngine(model, params, max_len=32, device="cpu") as engine:
        results = engine.serve([Request(uid=i, prompt=p, max_new_tokens=3)
                                for i, p in enumerate(prompts)])
    assert [len(r.tokens) for r in results] == [3, 3]
    assert all(r.finish_reason == "length" for r in results)


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_resident_and_offload_refusal(arch):
    from repro_torch.launch import serve
    results = serve.main(["--arch", arch, "--reduced", "--mode", "resident",
                          "--requests", "2", "--prompt-len", "6",
                          "--new-tokens", "3", "--device", "cpu"])
    assert [len(r.tokens) for r in results] == [3, 3]
    assert all(r.finish_reason == "length" for r in results)
    with pytest.raises(SystemExit, match="--mode offload is implemented for "
                                         "dense decoder-only archs"):
        serve.main(["--arch", arch, "--mode", "offload", "--device", "cpu"])
