"""The activation predictor of the port against the reference's, on the CPU.

The same numpy inputs go through `repro.core.predictor` and
`repro_torch.core.predictor`; the reference's params are converted with
`convert.predictor_params_from_numpy`. Tolerances:
  * logits within 1e-5 of their scale; masks equal except where a logit
    lies within 1e-5 of the cut (a float32 sum in another order may cross
    it);
  * one Adam step from the same params and batch: every tensor within
    1e-6 of its scale (the gradients come from two autodiffs of the same
    expression; Adam's update is written out as the reference writes it);
  * `_fit` from the reference's own init, 3 epochs of 7 batches: every
    tensor within 1e-5 of its scale (measured on this test's data: at most
    2.6e-7; the rounding differences of each step pass through Adam's
    normalisation), held-out masks equal except within 1e-4 of the cut.
The port's own training (its init draws from a `torch.Generator`) is held
to the reference tests' learnability claims (`tests/test_predictor.py`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import predictor as jpred
from repro.core import sparse_ffn as jsparse
from repro_torch.convert import predictor_params_from_numpy
from repro_torch.core import predictor as tpred
from repro_torch.core import sparse_ffn as tsparse

torch.set_num_threads(1)


def _linear_task(d=32, n=64, T=2000, seed=0):
    """Masks generated by a ground-truth linear rule of the hidden state
    (the reference test's task)."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((d, n)) * 0.7
    h = rng.standard_normal((T, d)).astype(np.float32)
    masks = (h @ W) > 0.8
    return h, masks.astype(np.float32)


def _ref_params(cfg, seed=0):
    jp = jpred.init_predictor(cfg, jax.random.PRNGKey(seed))
    return jp, predictor_params_from_numpy(
        [np.asarray(a) for a in jp], device="cpu")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _masks_agree(got, want, logits, cut, tol=1e-5):
    """Masks equal except where the logit lies within tol of the cut."""
    differ = np.asarray(got) != np.asarray(want)
    scale = max(float(np.abs(logits).max()), 1.0)
    near = np.abs(np.asarray(logits) - cut) <= tol * scale
    assert not (differ & ~near).any(), int((differ & ~near).sum())


@pytest.mark.parametrize("h_dtype", ["float32", "bfloat16"])
def test_logits_and_masks_match_reference(h_dtype):
    cfg = jpred.PredictorConfig(d_model=48, n_neurons=192, d_hidden=64)
    jp, tp = _ref_params(cfg, seed=3)
    h = np.random.default_rng(1).standard_normal((40, 48)).astype(np.float32)
    jh, th = jnp.asarray(h), torch.from_numpy(h)
    if h_dtype == "bfloat16":          # a bf16 hidden meets f32 weights in f32
        jh, th = jh.astype(jnp.bfloat16), th.bfloat16()
    want = np.asarray(jpred.predictor_logits(jp, jh))
    got = tpred.predictor_logits(tp, th)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 1e-5
    for t in (0.5, 0.35):
        cut = float(np.log(t / (1 - t)))
        _masks_agree(tpred.predict_mask(tp, th, t).numpy(),
                     np.asarray(jpred.predict_mask(jp, jh, t)), want, cut)


def test_predict_mask_np_equals_reference():
    cfg = jpred.PredictorConfig(d_model=48, n_neurons=192, d_hidden=64)
    jp, tp = _ref_params(cfg, seed=4)
    h = np.random.default_rng(2).standard_normal((6, 48)).astype(np.float32)
    for t in (0.35, 0.5):
        want = jpred.predict_mask_np(jpred.as_numpy_params(jp), h, t)
        got = tpred.predict_mask_np(tpred.as_numpy_params(tp), h, t)
        np.testing.assert_array_equal(got, want)
    for a, b in zip(tpred.as_numpy_params(tp), jpred.as_numpy_params(jp)):
        np.testing.assert_array_equal(a, b)


def test_one_adam_step_matches_reference():
    h, masks = _linear_task(d=48, n=192, T=256, seed=5)
    cfg = jpred.PredictorConfig(d_model=48, n_neurons=192, d_hidden=64,
                                lr=3e-3, pos_weight=4.0)
    jp, tp = _ref_params(cfg, seed=6)
    # start from nonzero moments and step 4, so the bias corrections count
    rng = np.random.default_rng(7)
    mu_np = [rng.standard_normal(np.shape(a)).astype(np.float32) * 1e-2
             for a in jp]
    nu_np = [rng.random(np.shape(a)).astype(np.float32) * 1e-4 for a in jp]
    jmu = jpred.PredictorParams(*map(jnp.asarray, mu_np))
    jnu = jpred.PredictorParams(*map(jnp.asarray, nu_np))
    jstep = jnp.asarray(3.0, jnp.float32)
    want = jpred._adam_step(jp, jmu, jnu, jstep, jnp.asarray(h),
                            jnp.asarray(masks), cfg.lr, cfg.pos_weight)
    tmu = tpred.PredictorParams(*map(torch.from_numpy, mu_np))
    tnu = tpred.PredictorParams(*map(torch.from_numpy, nu_np))
    got = tpred._adam_step(tp, tmu, tnu, torch.tensor(3.0), torch.from_numpy(h),
                           torch.from_numpy(masks), cfg.lr, cfg.pos_weight)
    for g_tree, w_tree in zip(got[:3], want[:3]):
        for g, w in zip(g_tree, w_tree):
            assert _rel(g.numpy(), w) <= 1e-6
    assert float(got[3]) == float(want[3]) == 4.0
    assert _rel(got[4].numpy(), want[4]) <= 1e-6


def test_fit_from_reference_init_matches_reference():
    h, masks = _linear_task(d=48, n=192, T=1800, seed=8)
    cfg = jpred.PredictorConfig(d_model=48, n_neurons=192, d_hidden=64,
                                lr=3e-3, pos_weight=4.0)
    seed = 2
    want, want_loss = jpred.train_predictor(cfg, h[:1600], masks[:1600],
                                            epochs=3, seed=seed)
    _, tp = _ref_params(cfg, seed=seed)
    tcfg = tpred.PredictorConfig(**vars(cfg))
    got, got_loss = tpred._fit(tp, h[:1600], masks[:1600], tcfg, epochs=3,
                               seed=seed)
    errs = [_rel(g.numpy(), w) for g, w in zip(got, want)]
    assert max(errs) <= 1e-5, errs
    assert abs(got_loss - want_loss) <= 1e-5 * abs(want_loss)
    held = h[1600:]
    logits = np.asarray(jpred.predictor_logits(want, jnp.asarray(held)))
    _masks_agree(tpred.predict_mask(got, torch.from_numpy(held)).numpy(),
                 np.asarray(jpred.predict_mask(want, jnp.asarray(held))),
                 logits, 0.0, tol=1e-4)


def test_lookahead_training_matches_reference_from_its_inits():
    """`train_lookahead_predictors` pairs layer k's hiddens with layer
    k+1's masks and seeds predictor k with seed + k: the port's fits from
    the reference's inits of those seeds give the reference's params."""
    rng = np.random.default_rng(9)
    L, T, d, n = 3, 300, 24, 40
    hid = rng.standard_normal((L, T, d)).astype(np.float32)
    msk = rng.random((L, T, n)) < 0.3
    want = jpred.train_lookahead_predictors(hid, msk, d_hidden=16, epochs=2)
    assert len(want) == L - 1
    for k, w in enumerate(want):
        cfg = jpred.PredictorConfig(d_model=d, n_neurons=n, d_hidden=16,
                                    threshold=0.35, lr=1e-3, pos_weight=4.0)
        _, tp = _ref_params(cfg, seed=k)
        got, _ = tpred._fit(tp, hid[k], msk[k + 1],
                            tpred.PredictorConfig(**vars(cfg)), epochs=2,
                            seed=k)
        assert max(_rel(g.numpy(), a) for g, a in zip(got, w)) <= 1e-5
    own = tpred.train_lookahead_predictors(hid, msk, d_hidden=16, epochs=2,
                                           device="cpu")
    assert len(own) == L - 1
    assert tuple(own[0].w2.shape) == (16, n) and own[0].w1.device.type == "cpu"


# -- the reference tests' claims, on the port's own training ------------------

def test_predictor_learns_linear_rule():
    h, masks = _linear_task()
    cfg = tpred.PredictorConfig(d_model=32, n_neurons=64, d_hidden=64, lr=3e-3)
    params, loss = tpred.train_predictor(cfg, h[:1600], masks[:1600],
                                         epochs=12, seed=0, device="cpu")
    recall, precision = tpred.recall_precision(params, h[1600:], masks[1600:])
    base_rate = masks.mean()
    assert np.isfinite(loss)
    assert recall > 0.8, recall
    assert precision > 0.5 and precision > base_rate + 0.1, (precision,
                                                              base_rate)


def test_pos_weight_trades_precision_for_recall():
    h, masks = _linear_task(seed=1)
    lo = tpred.PredictorConfig(d_model=32, n_neurons=64, pos_weight=1.0,
                               lr=3e-3)
    hi = tpred.PredictorConfig(d_model=32, n_neurons=64, pos_weight=8.0,
                               lr=3e-3)
    p_lo, _ = tpred.train_predictor(lo, h[:1600], masks[:1600], epochs=8,
                                    seed=0, device="cpu")
    p_hi, _ = tpred.train_predictor(hi, h[:1600], masks[:1600], epochs=8,
                                    seed=0, device="cpu")
    r_lo, _ = tpred.recall_precision(p_lo, h[1600:], masks[1600:])
    r_hi, _ = tpred.recall_precision(p_hi, h[1600:], masks[1600:])
    assert r_hi >= r_lo


def test_predict_mask_threshold_monotone():
    h, masks = _linear_task(seed=2)
    cfg = tpred.PredictorConfig(d_model=32, n_neurons=64)
    params, _ = tpred.train_predictor(cfg, h[:500], masks[:500], epochs=2,
                                      seed=0, device="cpu")
    x = torch.from_numpy(h[:100])
    loose = tpred.predict_mask(params, x, threshold=0.2)
    tight = tpred.predict_mask(params, x, threshold=0.8)
    assert int(loose.sum()) >= int(tight.sum())


def test_init_is_seeded_and_float32():
    cfg = tpred.PredictorConfig(d_model=16, n_neurons=24, d_hidden=8)
    a = tpred.init_predictor(cfg, torch.Generator().manual_seed(3))
    b = tpred.init_predictor(cfg, torch.Generator().manual_seed(3))
    for x, y in zip(a, b):
        assert x.dtype == torch.float32 and torch.equal(x, y)
    assert float(a.b1.abs().sum()) == float(a.b2.abs().sum()) == 0.0
    assert abs(float(a.w1.std()) * 4 - 1) < 0.35    # ~N(0, 1/d_model)


# -- core/sparse_ffn's gather helpers ----------------------------------------

@pytest.mark.parametrize("gated", [False, True])
def test_sparse_ffn_gather_and_pre_activation_match_reference(gated):
    rng = np.random.default_rng(10)
    n, d = 96, 32
    mats = [(rng.standard_normal((n, d)) * 0.2).astype(np.float32)
            for _ in range(3)]
    jw = jsparse.FFNWeights(*(jnp.asarray(m) for m in mats[:2]),
                            w_gate=jnp.asarray(mats[2]) if gated else None)
    tw = tsparse.FFNWeights(*(torch.from_numpy(m) for m in mats[:2]),
                            w_gate=torch.from_numpy(mats[2]) if gated
                            else None)
    x = rng.standard_normal((3, d)).astype(np.float32)
    np.testing.assert_allclose(
        tsparse.ffn_pre_activation(torch.from_numpy(x), tw).numpy(),
        np.asarray(jsparse.ffn_pre_activation(jnp.asarray(x), jw)),
        rtol=1e-5, atol=1e-5)
    ids = np.asarray([5, 0, 77, 12, 12, 3], np.int32)
    valid = np.asarray([1, 1, 1, 1, 0, 1], bool)
    act = "silu" if gated else "relu"
    want = np.asarray(jsparse.sparse_ffn_gather(
        jnp.asarray(x), jw, jnp.asarray(ids), activation=act,
        valid_mask=jnp.asarray(valid)))
    got = tsparse.sparse_ffn_gather(
        torch.from_numpy(x), tw, torch.from_numpy(ids).long(),
        activation=act, valid_mask=torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # over every neuron it is the dense FFN
    all_ids = torch.arange(n)
    np.testing.assert_allclose(
        tsparse.sparse_ffn_gather(torch.from_numpy(x), tw, all_ids,
                                  activation=act).numpy(),
        tsparse.dense_ffn(torch.from_numpy(x), tw, activation=act).numpy(),
        rtol=1e-5, atol=1e-5)
