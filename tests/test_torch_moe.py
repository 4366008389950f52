"""The port's MoE FFN (`repro_torch.models.moe`) against the reference's.

The reference's params (`init_moe` under a JAX key) are converted to
tensors and both packages run the same numpy inputs. `moe_forward` and its
aux loss equal the reference's at rtol = atol = 1e-4 with and without
capacity drops, and with a uniform router (every expert tied: top-k takes
the lower index in both). The reference's overflow rule is reproduced:
with capacity factor 0.5, 16 tokens routed to experts 0 and 1 (capacity 8)
give outputs for tokens 0 to 6 and exact zeros for tokens 7 to 15, token 7
losing slot C-1 of both experts. Plus the counterparts of
tests/test_moe.py:21, :31, :41 and :54 on the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(n_experts=4, top_k=2, cf=8.0, d=64, dff=32):
    kw = dict(n_experts=n_experts, top_k=top_k, d_ff_expert=dff,
              capacity_factor=cf)
    jbase = jget_config("granite-moe-1b-a400m", reduced=True, d_model=d)
    base = get_config("granite-moe-1b-a400m", reduced=True, d_model=d)
    return (dataclasses.replace(jbase, moe=JMoEConfig(**kw)),
            dataclasses.replace(base, moe=MoEConfig(**kw)))


def _params(jcfg, seed):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    return jp, {k: torch.as_tensor(np.array(v)) for k, v in jp.items()}


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(jp, p, x, jcfg, cfg):
    jy, jaux = jmoe.moe_forward(jp, jnp.asarray(x), jcfg)
    y, aux = moe.moe_forward(p, torch.as_tensor(x), cfg)
    return np.asarray(jy), float(jaux), y.numpy(), float(aux)


@pytest.mark.parametrize("cf", [8.0, 1.25, 0.25])
def test_moe_forward_and_aux_match_reference(cf):
    jcfg, cfg = _cfgs(n_experts=8, top_k=2, cf=cf)
    jp, p = _params(jcfg, 0)
    jy, jaux, y, aux = _both(jp, p, _x((2, 24, 64), 0), jcfg, cfg)
    np.testing.assert_allclose(y, jy, **TOL)
    np.testing.assert_allclose(aux, jaux, **TOL)


def test_uniform_router_ties_take_the_lower_index():
    jcfg, cfg = _cfgs(n_experts=4, top_k=2, cf=0.5)
    jp, p = _params(jcfg, 1)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    p = dict(p, router=torch.zeros_like(p["router"]))
    _, _, sel = moe.route(p, torch.as_tensor(_x((16, 64), 1)), cfg)
    assert (sel == torch.tensor([0, 1])).all()
    jy, jaux, y, aux = _both(jp, p, _x((1, 16, 64), 1), jcfg, cfg)
    np.testing.assert_allclose(y, jy, **TOL)
    np.testing.assert_allclose(aux, jaux, **TOL)


def test_overflow_empties_slot_c_minus_1_as_the_reference():
    """16 tokens all routed to experts 0 and 1, capacity 8: the reference's
    last write at slot C-1 is an overflowing pair's sentinel, so token 7
    loses both experts and tokens 7 to 15 come out as exact zeros."""
    jcfg, cfg = _cfgs(n_experts=4, top_k=2, cf=0.5)
    jp, p = _params(jcfg, 2)
    router = np.zeros((64, 4), np.float32)
    router[0, 0], router[0, 1] = 4.0, 2.0
    x = np.abs(_x((1, 16, 64), 2)) + 1.0          # x[..., 0] > 0
    jp = dict(jp, router=jnp.asarray(router))
    p = dict(p, router=torch.as_tensor(router))
    assert moe._capacity(16, cfg.moe) == 8
    _, _, sel = moe.route(p, torch.as_tensor(x[0]), cfg)
    assert (sel == torch.tensor([0, 1])).all()
    jy, jaux, y, aux = _both(jp, p, x, jcfg, cfg)
    assert np.all(np.abs(jy[0, :7]).max(-1) > 0)
    assert np.all(jy[0, 7:] == 0)
    assert np.all(np.abs(y[0, :7]).max(-1) > 0)
    assert np.all(y[0, 7:] == 0)
    np.testing.assert_allclose(y, jy, **TOL)
    np.testing.assert_allclose(aux, jaux, **TOL)
    # the same bits on a second run (no scatter of duplicate indices)
    y2, _ = moe.moe_forward(p, torch.as_tensor(x), cfg)
    assert torch.equal(y2, torch.as_tensor(y))


def test_dispatch_matches_dense_oracle_when_dropless():
    jcfg, cfg = _cfgs(cf=8.0)
    _, p = _params(jcfg, 0)
    x = torch.as_tensor(_x((2, 16, 64), 0))
    y1, a1 = moe.moe_forward(p, x, cfg)
    y2, a2 = moe.moe_forward_dense_einsum(p, x, cfg)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-5)
    np.testing.assert_allclose(float(a1), float(a2), rtol=1e-6)
    # the oracle is the reference's oracle too
    jp, _ = _params(jcfg, 0)
    jy, ja = jmoe.moe_forward_dense_einsum(jp, jnp.asarray(x.numpy()), jcfg)
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(a2), float(ja), **TOL)


def test_aux_loss_uniform_router_is_one():
    """Perfectly balanced routing gives aux ~= 1 (Switch normalisation)."""
    jcfg, cfg = _cfgs(n_experts=4, top_k=1)
    _, p = _params(jcfg, 1)
    p = dict(p, router=torch.zeros_like(p["router"]))
    # every router logit ties: mean prob 1/E each, all tokens on expert 0
    _, aux = moe.moe_forward(p, torch.as_tensor(_x((2, 32, 64), 1)), cfg)
    assert float(aux) == pytest.approx(1.0, rel=0.05)


def test_capacity_drops_reduce_output_norm():
    jcfg, cfg_big = _cfgs(cf=8.0)
    _, cfg_small = _cfgs(cf=0.25)
    _, p = _params(jcfg, 2)
    x = torch.as_tensor(_x((2, 64, 64), 2))
    y_small, _ = moe.moe_forward(p, x, cfg_small)
    y_big, _ = moe.moe_forward(p, x, cfg_big)
    assert float(torch.linalg.norm(y_small)) < float(torch.linalg.norm(y_big))


@pytest.mark.parametrize("n_tokens", [1, 4, 8, 32, 128, 4000])
def test_capacity_formula(n_tokens):
    for m, jm in ((MoEConfig(8, 2, 32, 1.25), JMoEConfig(8, 2, 32, 1.25)),
                  (MoEConfig(32, 8, 512), JMoEConfig(32, 8, 512))):
        C = moe._capacity(n_tokens, m)
        assert C == jmoe._capacity(n_tokens, jm)
        assert C >= n_tokens * m.top_k * m.capacity_factor / m.n_experts
        assert C % 4 == 0 and C >= 4
