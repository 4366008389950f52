"""The port's model against the reference's, on the reference's weights.

The reference's params (a JAX pytree) are converted with
`repro_torch.convert.params_from_numpy` and both models run the same
numpy token inputs: the full-sequence forward, then prefill + 16 greedy
decode steps, each side sampling its own argmax. Logits agree to
rtol = atol = 1e-4 (float32 on the CPU, sums taken in another order) and
the greedy tokens are identical. Scalar decode positions give the same
result as a [B] position vector. Run at reduced opt-350m (MHA, layernorm,
relu) and reduced qwen2-7b (GQA, qkv bias, rmsnorm, gated silu), in
float32 and in bfloat16 (bf16 params and compute: the reference's
`ml_dtypes.bfloat16` leaves loaded bit for bit), the latter to the bf16
tolerance of tests/test_kernels.py:10, rtol = atol = 2e-2.

In bf16 the reference runs op by op (`jax.disable_jit()`): compiled, XLA
keeps some intermediates of its fused ops in float32 and skips the bf16
rounding the code writes between them, which moves these logits by up to
0.035 against the same program run op by op. The port rounds where the
code says, as the op-by-op reference does. Greedy tokens in bf16 follow
the margin rule: they are identical, except that a first difference is
accepted where the reference's top-2 logit margin at that step is below
2e-2 (a near tie that bf16 rounding may flip); logits are compared up to
that step.
"""
import contextlib

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
TOLS = {"float32": TOL, "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SMALL = dict(d_model=64, d_ff=256, n_layers=2, vocab_size=128)
ARCHS = ["opt-350m", "qwen2-7b"]
# float32 cases keep their original ids; bf16 cases are "<arch>-bf16"
CASES = ([pytest.param(a, "float32", id=a) for a in ARCHS]
         + [pytest.param(a, "bfloat16", id=f"{a}-bf16") for a in ARCHS])


def _pair(arch, seed=0, dtype="float32"):
    """Reference model + numpy params (qkv biases made non-zero so they are
    exercised), and the port's model on the CPU with those params."""
    dt = dict(param_dtype=dtype, compute_dtype=dtype)
    jcfg = jget_config(arch, reduced=True, **SMALL, **dt)
    jmodel = jbuild_model(jcfg)
    tree = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    mixer = tree["stack"]["sub_0"]["mixer"]
    for name in ("bq", "bk", "bv"):
        if name in mixer:
            mixer[name] = (0.1 * rng.standard_normal(mixer[name].shape)
                           ).astype(np.float32).astype(mixer[name].dtype)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    cfg = get_config(arch, reduced=True, **SMALL, **dt)
    model = build_model(cfg, device="cpu")
    return jcfg, jmodel, jparams, cfg, model, params_from_numpy(tree, cfg,
                                                                device="cpu")


def _reference_mode(dtype):
    """The context the reference runs in: compiled in float32, op by op
    in bf16 (see the module docstring)."""
    return (jax.disable_jit() if dtype == "bfloat16"
            else contextlib.nullcontext())


def _np(x):
    """A torch tensor or a JAX array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("arch,dtype", CASES)
def test_forward_logits_match(arch, dtype):
    jcfg, jmodel, jparams, cfg, model, params = _pair(arch, dtype=dtype)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12))
    with _reference_mode(dtype):
        jout = jmodel.forward(jparams,
                              {"tokens": jnp.asarray(tokens, jnp.int32)},
                              capture_activations=True)
    with torch.inference_mode():
        out = model.forward(params, {"tokens": torch.as_tensor(tokens)},
                            capture_activations=True)
    assert out["logits"].dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(out["logits"]), _np(jout["logits"]),
                               **TOLS[dtype])
    np.testing.assert_allclose(_np(out["ffn_pre_act"]),
                               _np(jout["ffn_pre_act"]), **TOLS[dtype])


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


def _assert_greedy_match(toks, logits, jtoks, jlogits, T, dtype):
    """Tokens equal and logits within TOLS[dtype]; in bf16 a first
    difference at step t is accepted where the reference's top-2 margin
    there is below the bf16 tolerance, and logits are compared up to the
    column that picked token t."""
    tol = TOLS[dtype]
    differ = np.nonzero((toks != jtoks).any(0))[0]
    t = int(differ[0]) if len(differ) else toks.shape[1]
    if t < toks.shape[1]:
        assert dtype == "bfloat16", f"float32 tokens differ at step {t}"
        for b in np.nonzero(toks[:, t] != jtoks[:, t])[0]:
            top2 = np.sort(jlogits[b, T - 1 + t])[-2:]
            assert top2[1] - top2[0] < tol["atol"], (b, t, top2)
    np.testing.assert_array_equal(toks[:, :t], jtoks[:, :t])
    np.testing.assert_allclose(logits[:, :T + t], jlogits[:, :T + t], **tol)


@pytest.mark.parametrize("arch,dtype", CASES)
def test_prefill_and_greedy_decode_match(arch, dtype):
    jcfg, jmodel, jparams, cfg, model, params = _pair(arch, seed=2,
                                                      dtype=dtype)
    B, T, n = 2, 8, 16
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, T))
    jstate = {"cache": jmodel.init_cache(B, T + n)}
    jprefill_fn, jdecode_fn = jax.jit(jmodel.prefill), jax.jit(jmodel.decode_step)

    def jprefill(p):
        logits, jstate["cache"] = jprefill_fn(
            jparams, {"tokens": jnp.asarray(p, jnp.int32)}, jstate["cache"])
        return _np(logits)

    def jstep(tok, pos):
        logits, jstate["cache"] = jdecode_fn(
            jparams, jnp.asarray(tok, jnp.int32), jnp.int32(pos),
            jstate["cache"])
        return _np(logits)

    def run_port(vector_positions):
        state = {"cache": model.init_cache(B, T + n)}

        def prefill(p):
            logits, state["cache"] = model.prefill(
                params, {"tokens": torch.as_tensor(p)}, state["cache"])
            return _np(logits)

        def step(tok, pos):
            position = torch.full((B,), pos) if vector_positions else pos
            logits, state["cache"] = model.decode_step(
                params, torch.as_tensor(tok), position, state["cache"])
            return _np(logits)

        with torch.inference_mode():
            return _greedy(step, prefill, prompt, n)

    with _reference_mode(dtype):
        jtoks, jlogits = _greedy(jstep, jprefill, prompt, n)
    toks, logits = run_port(vector_positions=False)
    _assert_greedy_match(toks, logits, jtoks, jlogits, T, dtype)
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
    # a bf16 leaf (ml_dtypes.bfloat16 in numpy) keeps its dtype and bits
    *_, jparams16, cfg16, _, params16 = _pair("opt-350m", dtype="bfloat16")
    leaf = np.asarray(jparams16["stack"]["sub_0"]["ffn"]["w_up"])
    assert leaf.dtype.name == "bfloat16"
    for g in range(cfg16.n_layers):
        got = params16["stack"][g]["sub_0"]["ffn"]["w_up"]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy().view(np.uint16),
            leaf[g].view(np.uint16))
