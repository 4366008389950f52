"""The port's model against the reference's, on the reference's weights.

The reference's params (a JAX pytree) are converted with
`repro_torch.convert.params_from_numpy` and both models run the same
numpy token inputs: the full-sequence forward, then prefill + 16 greedy
decode steps, each side sampling its own argmax. Logits agree to
rtol = atol = 1e-4 (float32 on the CPU, sums taken in another order) and
the greedy tokens are identical. Scalar decode positions give the same
result as a [B] position vector. Run at reduced opt-350m (MHA, layernorm,
relu) and reduced qwen2-7b (GQA, qkv bias, rmsnorm, gated silu).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import build_model

# tiny shapes: one intra-op thread each, so the parallel test run does not
# oversubscribe the machine's cores
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
SMALL = dict(d_model=64, d_ff=256, n_layers=2, vocab_size=128)
ARCHS = ["opt-350m", "qwen2-7b"]


def _pair(arch, seed=0):
    """Reference model + numpy params (qkv biases made non-zero so they are
    exercised), and the port's model on the CPU with those params."""
    jcfg = jget_config(arch, reduced=True, **SMALL)
    jmodel = jbuild_model(jcfg)
    tree = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    mixer = tree["stack"]["sub_0"]["mixer"]
    for name in ("bq", "bk", "bv"):
        if name in mixer:
            mixer[name] = (0.1 * rng.standard_normal(mixer[name].shape)
                           ).astype(np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    cfg = get_config(arch, reduced=True, **SMALL)
    model = build_model(cfg, device="cpu")
    return jcfg, jmodel, jparams, cfg, model, params_from_numpy(tree, cfg,
                                                                device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match(arch):
    jcfg, jmodel, jparams, cfg, model, params = _pair(arch)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12))
    jout = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)},
                          capture_activations=True)
    with torch.inference_mode():
        out = model.forward(params, {"tokens": torch.as_tensor(tokens)},
                            capture_activations=True)
    np.testing.assert_allclose(out["logits"].numpy(),
                               np.asarray(jout["logits"]), **TOL)
    np.testing.assert_allclose(out["ffn_pre_act"].numpy(),
                               np.asarray(jout["ffn_pre_act"]), **TOL)


def _greedy(step, prefill, prompt, n):
    """Prefill + n decode steps, argmax each; returns (tokens, logits)."""
    logits = prefill(prompt)
    toks, rows = [], [logits]
    T = prompt.shape[1]
    for i in range(n):
        tok = logits[:, -1].argmax(-1)
        toks.append(tok)
        logits = step(tok[:, None], T + i)
        rows.append(logits)
    return np.stack(toks, 1), np.concatenate(rows, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_match(arch):
    jcfg, jmodel, jparams, cfg, model, params = _pair(arch, seed=2)
    B, T, n = 2, 8, 16
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, T))
    jstate = {"cache": jmodel.init_cache(B, T + n)}
    jprefill_fn, jdecode_fn = jax.jit(jmodel.prefill), jax.jit(jmodel.decode_step)

    def jprefill(p):
        logits, jstate["cache"] = jprefill_fn(
            jparams, {"tokens": jnp.asarray(p, jnp.int32)}, jstate["cache"])
        return np.asarray(logits)

    def jstep(tok, pos):
        logits, jstate["cache"] = jdecode_fn(
            jparams, jnp.asarray(tok, jnp.int32), jnp.int32(pos),
            jstate["cache"])
        return np.asarray(logits)

    def run_port(vector_positions):
        state = {"cache": model.init_cache(B, T + n)}

        def prefill(p):
            logits, state["cache"] = model.prefill(
                params, {"tokens": torch.as_tensor(p)}, state["cache"])
            return logits.numpy()

        def step(tok, pos):
            position = torch.full((B,), pos) if vector_positions else pos
            logits, state["cache"] = model.decode_step(
                params, torch.as_tensor(tok), position, state["cache"])
            return logits.numpy()

        with torch.inference_mode():
            return _greedy(step, prefill, prompt, n)

    jtoks, jlogits = _greedy(jstep, jprefill, prompt, n)
    toks, logits = run_port(vector_positions=False)
    np.testing.assert_array_equal(toks, jtoks)
    np.testing.assert_allclose(logits, jlogits, **TOL)
    vtoks, vlogits = run_port(vector_positions=True)
    np.testing.assert_array_equal(vtoks, toks)
    np.testing.assert_allclose(vlogits, logits, rtol=1e-6, atol=1e-6)


def test_conversion_unstacks_groups_and_rejects_bad_depth():
    jcfg, jmodel, jparams, cfg, model, params = _pair("opt-350m")
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    assert len(params["stack"]) == cfg.n_layers
    for g in range(cfg.n_layers):
        np.testing.assert_array_equal(
            params["stack"][g]["sub_0"]["ffn"]["w_up"].numpy(),
            tree["stack"]["sub_0"]["ffn"]["w_up"][g])
    bad = get_config("opt-350m", reduced=True, **{**SMALL, "n_layers": 3})
    with pytest.raises(ValueError, match="groups"):
        params_from_numpy(tree, bad, device="cpu")
