"""The port's SSM mixers (`repro_torch.models.ssm`) against the reference's.

Mamba (reduced jamba geometry), mLSTM and sLSTM (reduced xlstm-125m) on
the reference's params, converted to tensors: the sequence forward, its
final state and a decode step from that state equal the reference's at
rtol = atol = 1e-4. The reference scans time in padded chunks whose padded
steps leave the carry unchanged; the port's plain loop gives the same
final state, also with the reference's chunk cut to 7 (T = 50) and for a
prompt shorter than Mamba's conv window (T = 2 < d_conv - 1). Plus the
counterparts of tests/test_ssm.py:27, :51, :66 and :80 on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.models import ssm

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
KINDS = ["mamba", "mlstm", "slstm"]


def _cfgs(kind):
    if kind == "mamba":
        kw = dict(d_model=64, n_heads=2, n_kv_heads=1)
        return (jget_config("jamba-1.5-large-398b", reduced=True, **kw),
                get_config("jamba-1.5-large-398b", reduced=True, **kw))
    kw = dict(d_model=64, n_heads=2, n_kv_heads=2)
    return (jget_config("xlstm-125m", reduced=True, **kw),
            get_config("xlstm-125m", reduced=True, **kw))


def _params(kind, jcfg, seed=0):
    jp = getattr(jssm, f"init_{kind}")(jax.random.PRNGKey(seed), jcfg)
    return jp, {k: torch.as_tensor(np.array(v)) for k, v in jp.items()}


def _x(B=2, T=37, d=64, seed=0):
    return (np.random.default_rng(seed).standard_normal((B, T, d)) * 0.5
            ).astype(np.float32)


def _assert_state(state, jstate):
    assert type(state).__name__ == type(jstate).__name__
    for name, a, b in zip(state._fields, state, jstate):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("T", [2, 37])
def test_forward_state_and_decode_match_reference(kind, T):
    jcfg, cfg = _cfgs(kind)
    jp, p = _params(kind, jcfg)
    x, x_t = _x(T=T), _x(T=1, seed=1)[:, 0]
    jy, jstate = getattr(jssm, f"{kind}_forward")(jp, jnp.asarray(x), jcfg,
                                                  return_state=True)
    y, state = getattr(ssm, f"{kind}_forward")(p, torch.as_tensor(x), cfg,
                                               return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    _assert_state(state, jstate)
    jy_t, jstate = getattr(jssm, f"{kind}_decode_step")(
        jp, jnp.asarray(x_t), jstate, jcfg)
    y_t, state = getattr(ssm, f"{kind}_decode_step")(
        p, torch.as_tensor(x_t), state, cfg)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(jy_t), **TOL)
    _assert_state(state, jstate)


@pytest.mark.parametrize("kind", KINDS)
def test_init_state_matches_reference(kind):
    jcfg, cfg = _cfgs(kind)
    _assert_state(getattr(ssm, f"{kind}_init_state")(3, cfg, "cpu"),
                  getattr(jssm, f"{kind}_init_state")(3, jcfg))


@pytest.mark.parametrize("kind", KINDS)
def test_forward_equals_stepwise_decode(kind):
    jcfg, cfg = _cfgs(kind)
    _, p = _params(kind, jcfg)
    x = torch.as_tensor(_x())
    y_seq, final_state = getattr(ssm, f"{kind}_forward")(p, x, cfg,
                                                         return_state=True)
    st = getattr(ssm, f"{kind}_init_state")(x.shape[0], cfg, "cpu")
    outs = []
    for t in range(x.shape[1]):
        y_t, st = getattr(ssm, f"{kind}_decode_step")(p, x[:, t], st, cfg)
        outs.append(y_t)
    np.testing.assert_allclose(y_seq.numpy(), torch.stack(outs, 1).numpy(),
                               rtol=2e-4, atol=2e-4)
    for a, b in zip(final_state, st):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("kind", KINDS)
def test_reference_chunking_is_the_plain_loop(kind):
    """The reference at a chunk of 7 over T = 50 (padded, carry-identity
    steps) gives the port's outputs and final state."""
    jcfg, cfg = _cfgs(kind)
    jp, p = _params(kind, jcfg, seed=1)
    x = _x(T=50)
    orig = jssm.SCAN_CHUNK
    try:
        jssm.SCAN_CHUNK = 7
        jy, jstate = getattr(jssm, f"{kind}_forward")(
            jp, jnp.asarray(x), jcfg, return_state=True)
    finally:
        jssm.SCAN_CHUNK = orig
    y, state = getattr(ssm, f"{kind}_forward")(p, torch.as_tensor(x), cfg,
                                               return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    _assert_state(state, jstate)


def test_mamba_causality():
    """Output at t must not depend on inputs after t."""
    jcfg, cfg = _cfgs("mamba")
    _, p = _params("mamba", jcfg, seed=2)
    x = torch.as_tensor(_x(T=20))
    y1 = ssm.mamba_forward(p, x, cfg)
    x_mod = x.clone()
    x_mod[:, 15:] = 7.7
    y2 = ssm.mamba_forward(p, x_mod, cfg)
    np.testing.assert_allclose(y1[:, :15].numpy(), y2[:, :15].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert not np.allclose(y1[:, 15:].numpy(), y2[:, 15:].numpy())


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_stability_long_range(kind):
    """Exponential gating with its stabiliser does not overflow on long
    inputs."""
    jcfg, cfg = _cfgs(kind)
    _, p = _params(kind, jcfg, seed=3)
    x = torch.as_tensor(_x(T=256)) * 5.0
    y = getattr(ssm, f"{kind}_forward")(p, x, cfg)
    assert bool(torch.isfinite(y).all())
