"""Long sequences in the port against the reference: the chunked flash
attention past 2048 positions and the checkpointed SSM time scan.

The same numpy inputs go to both packages. Tolerances: float32 rtol = atol
= 2e-5, the reference's own flash-vs-dense rule (tests/test_attention.py:28);
the triangular form against the port's flash form 1e-5
(tests/test_perf_variants.py:20); bf16 2e-2 (one rounding of scores, P and
the output, taken op by op in both); whole models and the SSM scans
1e-4, the port's model and SSM parity rule (tests/test_torch_model.py,
tests/test_torch_ssm.py: matmuls and recurrences sum in another order
than XLA's over many steps).
  (a) `flash_gqa_attend`: causal or not, windows 0 and 7, chunk pairs
      (8, 8), (17, 13), (48, 48) over T = 50 (not a multiple of a chunk),
      G = 2, `k_valid` with False entries; bf16 under `jax.disable_jit()`.
  (b) `flash_gqa_attend_triangular` against the reference's and against
      the port's flash form.
  (c) `attention_forward` at T = 2050 on a reduced config, default and
      triangular, with a count of the flash route's calls.
  (d) `cross_attention_forward` over S = 2050 memory positions.
  (e) `Model.prefill` of reduced granite-3-2b on a 2100-token prompt: the
      last logits and the KV cache.
  (f) the SSM scans (mamba, mlstm, slstm) at T = 300: outputs, final
      state and every gradient leaf against `jax.grad` of the reference,
      with `SCAN_CHUNK` 128 and 7, and the count of checkpointed chunks.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import build_model, layers, ssm

torch.set_num_threads(1)

F32 = dict(rtol=2e-5, atol=2e-5)
TRI = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
MODEL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128)


def _qkv(seed, B=2, T=50, S=50, H=4, KV=2, hd=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32),
            rng.standard_normal((B, S, KV, hd)).astype(np.float32))


def _pos(B, T):
    return np.broadcast_to(np.arange(T, dtype=np.int32)[None], (B, T)).copy()


def _t(*arrays, dtype=None):
    out = [torch.as_tensor(a) for a in arrays]
    return [o.to(dtype) if dtype is not None and o.is_floating_point() else o
            for o in out]


def _j(*arrays, dtype=None):
    return [jnp.asarray(a, dtype) if a.dtype == np.float32 and dtype
            else jnp.asarray(a) for a in arrays]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 7])
@pytest.mark.parametrize("qc,kc", [(8, 8), (17, 13), (48, 48)])
def test_flash_matches_reference(causal, window, qc, kc):
    q, k, v = _qkv(qc * 100 + kc)
    B, T = q.shape[:2]
    pos = _pos(B, T)
    valid = np.random.default_rng(window).random((B, T)) > 0.2
    valid[:, -1] = True
    kw = dict(causal=causal, window=window, q_chunk=qc, k_chunk=kc)
    ref = jlayers.flash_gqa_attend(*_j(q, k, v, pos, pos, valid), **kw)
    out = layers.flash_gqa_attend(*_t(q, k, v, pos, pos, valid), **kw)
    np.testing.assert_allclose(_np(out), _np(ref), **F32)
    # and the port's plain einsum form on the same inputs
    dense = layers.gqa_attend(*_t(q, k, v, pos, pos, valid), causal=causal,
                              window=window)
    np.testing.assert_allclose(_np(out), _np(dense), **F32)


@pytest.mark.parametrize("causal,window,qc,kc", [(True, 0, 17, 13),
                                                 (False, 7, 48, 13)])
def test_flash_bf16_matches_reference(causal, window, qc, kc):
    q, k, v = _qkv(7)
    pos = _pos(*q.shape[:2])
    kw = dict(causal=causal, window=window, q_chunk=qc, k_chunk=kc)
    with jax.disable_jit():
        ref = jlayers.flash_gqa_attend(*_j(q, k, v, pos, pos,
                                           dtype=jnp.bfloat16), **kw)
    out = layers.flash_gqa_attend(*_t(q, k, v, pos, pos,
                                      dtype=torch.bfloat16), **kw)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(ref), **BF16)


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("chunk", [8, 17, 50])
def test_triangular_matches_reference_and_flash(window, chunk):
    q, k, v = _qkv(chunk + window)
    pos = _pos(*q.shape[:2])
    ref = jlayers.flash_gqa_attend_triangular(*_j(q, k, v, pos),
                                              window=window, chunk=chunk)
    out = layers.flash_gqa_attend_triangular(*_t(q, k, v, pos),
                                             window=window, chunk=chunk)
    np.testing.assert_allclose(_np(out), _np(ref), **F32)
    flash = layers.flash_gqa_attend(*_t(q, k, v, pos, pos), causal=True,
                                    window=window, q_chunk=chunk,
                                    k_chunk=chunk)
    np.testing.assert_allclose(_np(out), _np(flash), **TRI)


def _counting(monkeypatch):
    """Count the calls of the two flash forms (their inner functions)."""
    calls = {"flash": 0, "triangular": 0}

    def wrap(name, real):
        def counted(*args, **kw):
            calls[name] += 1
            return real(*args, **kw)
        return counted
    monkeypatch.setattr(layers, "_flash_gqa_attend",
                        wrap("flash", layers._flash_gqa_attend))
    monkeypatch.setattr(layers, "_flash_gqa_attend_triangular",
                        wrap("triangular",
                             layers._flash_gqa_attend_triangular))
    return calls


def _attn_params(jcfg, cfg, cross=False):
    jp = jlayers.init_attention(jax.random.PRNGKey(0), jcfg, cross=cross)
    return jp, {k: torch.as_tensor(np.array(v)) for k, v in jp.items()}


@pytest.mark.parametrize("triangular", [False, True])
def test_attention_forward_routes_long_sequences_to_flash(monkeypatch,
                                                          triangular):
    kw = dict(SMALL, flash_triangular=triangular, flash_q_chunk=512,
              flash_k_chunk=384, qkv_bias=True)
    jcfg = jget_config("qwen2-7b", reduced=True, **kw)
    cfg = get_config("qwen2-7b", reduced=True, **kw)
    jp, p = _attn_params(jcfg, cfg)
    T = layers.FLASH_SEQ_THRESHOLD + 2
    x = (np.random.default_rng(3).standard_normal((1, T, cfg.d_model))
         * 0.5).astype(np.float32)
    pos = _pos(1, T)
    ref = jax.jit(lambda p_, x_, pos_: jlayers.attention_forward(
        p_, x_, pos_, jcfg, window=100))(jp, jnp.asarray(x), jnp.asarray(pos))
    calls = _counting(monkeypatch)
    with torch.inference_mode():
        out, k, v = layers.attention_forward(p, torch.as_tensor(x),
                                             torch.as_tensor(pos), cfg,
                                             window=100)
    np.testing.assert_allclose(_np(out), _np(ref), **MODEL)
    assert calls == {"flash": int(not triangular),
                     "triangular": int(triangular)}
    assert k.shape == (1, T, cfg.n_kv_heads, cfg.head_dim)
    # at the threshold itself the plain form runs
    with torch.inference_mode():
        layers.attention_forward(p, torch.as_tensor(x[:, :T - 2]),
                                 torch.as_tensor(pos[:, :T - 2]), cfg)
    assert sum(calls.values()) == 1


@pytest.mark.parametrize("T,S", [(5, 2050), (2050, 7)])
def test_cross_attention_routes_long_memory_to_flash(monkeypatch, T, S):
    kw = dict(SMALL, flash_q_chunk=700, flash_k_chunk=600)
    jcfg = jget_config("seamless-m4t-medium", reduced=True, **kw)
    cfg = get_config("seamless-m4t-medium", reduced=True, **kw)
    jp, p = _attn_params(jcfg, cfg, cross=True)
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, T, cfg.d_model)) * 0.5).astype(np.float32)
    mem = (rng.standard_normal((2, S, cfg.d_model)) * 0.5).astype(np.float32)
    jmk, jmv = jlayers.project_memory_kv(jp, jnp.asarray(mem), jcfg)
    ref = jax.jit(lambda p_, x_, k_, v_: jlayers.cross_attention_forward(
        p_, x_, k_, v_, jcfg))(jp, jnp.asarray(x), jmk, jmv)
    calls = _counting(monkeypatch)
    with torch.inference_mode():
        mk, mv = layers.project_memory_kv(p, torch.as_tensor(mem), cfg)
        out = layers.cross_attention_forward(p, torch.as_tensor(x), mk, mv,
                                             cfg)
    np.testing.assert_allclose(_np(out), _np(ref), **MODEL)
    assert calls == {"flash": 1, "triangular": 0}


@pytest.mark.parametrize("triangular", [False, True])
def test_prefill_past_threshold_matches_reference(monkeypatch, triangular):
    kw = dict(SMALL, n_layers=2, flash_triangular=triangular,
              flash_q_chunk=1024, flash_k_chunk=1024)
    jcfg = jget_config("granite-3-2b", reduced=True, **kw)
    cfg = get_config("granite-3-2b", reduced=True, **kw)
    jmodel = jbuild_model(jcfg)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jmodel.init_params(jax.random.PRNGKey(5)))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(tree, cfg, device="cpu")
    T = 2100
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (1, T))
    jlogits, jcache = jax.jit(jmodel.prefill)(
        jparams, {"tokens": jnp.asarray(tokens, jnp.int32)},
        jmodel.init_cache(1, T + 4))
    calls = _counting(monkeypatch)
    with torch.inference_mode():
        logits, cache = model.prefill(params,
                                      {"tokens": torch.as_tensor(tokens)},
                                      model.init_cache(1, T + 4))
    assert sum(calls.values()) == cfg.n_layers
    np.testing.assert_allclose(_np(logits), _np(jlogits), **MODEL)
    for g, group in enumerate(cache):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                _np(getattr(group["sub_0"], name)),
                _np(getattr(jcache["sub_0"], name)[g]), **MODEL,
                err_msg=f"group {g} {name}")


def _ssm_cfgs(kind):
    if kind == "mamba":
        kw = dict(d_model=32, n_heads=2, n_kv_heads=1)
        return (jget_config("jamba-1.5-large-398b", reduced=True, **kw),
                get_config("jamba-1.5-large-398b", reduced=True, **kw))
    kw = dict(d_model=32, n_heads=2, n_kv_heads=2)
    return (jget_config("xlstm-125m", reduced=True, **kw),
            get_config("xlstm-125m", reduced=True, **kw))


def _ssm_loss_weights(y_shape, state, seed):
    """Fixed random weights of the outputs and of each final-state leaf
    (the stabiliser m left out: its gradient is a max's)."""
    rng = np.random.default_rng(seed)
    wy = rng.standard_normal(y_shape).astype(np.float32)
    ws = {name: rng.standard_normal(tuple(leaf.shape)).astype(np.float32)
          for name, leaf in zip(state._fields, state) if name != "m"}
    return wy, ws


@functools.lru_cache(maxsize=None)
def _ssm_reference(kind):
    """(params, x, loss weights, outputs, final state, loss, param grads,
    x grad) of the reference at B = 2, T = 300, as numpy."""
    jcfg, _ = _ssm_cfgs(kind)
    jp = getattr(jssm, f"init_{kind}")(jax.random.PRNGKey(1), jcfg)
    x = (np.random.default_rng(2).standard_normal((2, 300, jcfg.d_model))
         * 0.5).astype(np.float32)
    jforward = getattr(jssm, f"{kind}_forward")
    y0, st0 = jax.jit(lambda p, x_: jforward(p, x_, jcfg, return_state=True)
                      )(jp, jnp.asarray(x))
    wy, ws = _ssm_loss_weights(y0.shape, st0, seed=3)

    def jloss(p, x_):
        y, st = jforward(p, x_, jcfg, return_state=True)
        return (y * wy).sum() + sum((getattr(st, n) * w).sum()
                                    for n, w in ws.items())
    jl, (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jp, jnp.asarray(x))
    to_np = lambda t: jax.tree_util.tree_map(np.array, t)  # noqa: E731
    return (to_np(jp), x, wy, ws, np.array(y0), to_np(st0), float(jl),
            to_np(jgp), np.array(jgx))


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
@pytest.mark.parametrize("chunk", [128, 7])
def test_chunked_scan_grads_match_reference(monkeypatch, kind, chunk):
    _, cfg = _ssm_cfgs(kind)
    jp, x, wy, ws, y0, st0, jl, jgp, jgx = _ssm_reference(kind)
    T = x.shape[1]
    monkeypatch.setattr(ssm, "SCAN_CHUNK", chunk)
    n_chunks = []
    real = torch.utils.checkpoint.checkpoint

    def counted(*args, **kw):
        n_chunks.append(1)
        return real(*args, **kw)
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counted)
    p = {k: torch.tensor(v, requires_grad=True) for k, v in jp.items()}
    xt = torch.tensor(x, requires_grad=True)
    y, st = getattr(ssm, f"{kind}_forward")(p, xt, cfg, return_state=True)
    assert len(n_chunks) == -(-T // chunk)
    np.testing.assert_allclose(_np(y.detach()), _np(y0), **MODEL)
    for name, a, b in zip(st._fields, st, st0):
        np.testing.assert_allclose(_np(a.detach()), _np(b), **MODEL,
                                   err_msg=name)
    loss = (y * torch.as_tensor(wy)).sum() + sum(
        (getattr(st, n) * torch.as_tensor(w)).sum() for n, w in ws.items())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), jl, rtol=1e-4)
    np.testing.assert_allclose(_np(xt.grad), _np(jgx), **MODEL)
    for name, leaf in p.items():
        np.testing.assert_allclose(_np(leaf.grad), _np(jgp[name]), **MODEL,
                                   err_msg=name)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_scan_runs_plain_without_grad(monkeypatch, kind):
    """Under no_grad (serving, prefill) no chunk is checkpointed and the
    outputs equal the checkpointed run's."""
    _, cfg = _ssm_cfgs(kind)
    p = getattr(ssm, f"init_{kind}")(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((2, 40, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1)) * 0.5
    monkeypatch.setattr(ssm, "SCAN_CHUNK", 16)
    n_chunks = []
    real = torch.utils.checkpoint.checkpoint

    def counted(*args, **kw):
        n_chunks.append(1)
        return real(*args, **kw)
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counted)
    forward = getattr(ssm, f"{kind}_forward")
    with torch.no_grad():
        y_plain = forward(p, x, cfg)
    assert n_chunks == []
    p = {k: v.clone().requires_grad_() for k, v in p.items()}
    y_remat = forward(p, x, cfg)
    assert len(n_chunks) == 3
    assert torch.equal(y_plain, y_remat.detach())
