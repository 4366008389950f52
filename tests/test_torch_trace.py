"""Activation traces of the port against the reference: synthetic masks bit
for bit, the same shard files and manifest, each package reading the
other's traces, and relu / top-k masks from the same pre-activations.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import trace as jtrace
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import trace as ttrace
from repro_torch.models import build_model

torch.set_num_threads(1)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(n_neurons=300, n_clusters=7, clusters_per_token=2, seed=3,
         structure_seed=5, popularity_seed=9),
    dict(n_neurons=64, n_clusters=8, member_p=0.5, noise_p=0.05,
         zipf_alpha=1.5, seed=1),
])
def test_synthetic_masks_bit_identical(kw):
    want = jtrace.synthetic_masks(jtrace.SyntheticTraceConfig(**kw), 40)
    got = ttrace.synthetic_masks(ttrace.SyntheticTraceConfig(**kw), 40)
    assert got.dtype == want.dtype == bool
    np.testing.assert_array_equal(got, want)


def _write(mod, root, shards):
    w = mod.ShardedTraceWriter(root, n_layers=2, n_neurons=24)
    for layer, masks in shards:
        w.append(layer, masks)
    return w.finish()


def _shards():
    rng = np.random.default_rng(2)
    return [(0, rng.random((5, 24)) < 0.3), (1, rng.random((3, 24)) < 0.3),
            (0, rng.random((1, 24)) < 0.3), (1, rng.random(24) < 0.3)]


def test_shard_files_and_manifest_identical(tmp_path):
    shards = _shards()
    mj = _write(jtrace, tmp_path / "jax", shards)
    # the port also takes tensors, written as the same bool arrays
    mt = _write(ttrace, tmp_path / "torch",
                [(l, torch.from_numpy(np.asarray(m))) for l, m in shards])
    assert mt == mj
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "torch").iterdir())
    assert "layer000_shard00001.npy" in names
    for name in names:
        assert ((tmp_path / "jax" / name).read_bytes()
                == (tmp_path / "torch" / name).read_bytes()), name
    assert json.loads((tmp_path / "torch" / "manifest.json").read_text()) == mj


@pytest.mark.parametrize("manifest", [True, False], ids=["manifest", "glob"])
def test_each_package_reads_the_others_shards(tmp_path, manifest):
    shards = _shards()
    for writer, reader, name in ((jtrace, ttrace, "jax"),
                                 (ttrace, jtrace, "torch")):
        root = tmp_path / name
        w = writer.ShardedTraceWriter(root, n_layers=2, n_neurons=24)
        for layer, masks in shards:
            w.append(layer, masks)
        if manifest:
            w.finish()
        for layer in (0, 1):
            got = list(reader.iter_trace_shards(root, layer))
            want = [np.atleast_2d(m) for l, m in shards if l == layer]
            assert len(got) == len(want)
            for g, m in zip(got, want):
                np.testing.assert_array_equal(g, m)


def test_writer_rejects_wrong_width(tmp_path):
    w = ttrace.ShardedTraceWriter(tmp_path, n_layers=1, n_neurons=4)
    with pytest.raises(ValueError, match="mask width"):
        w.append(0, np.zeros((2, 5), dtype=bool))


@pytest.mark.parametrize("k", [1, 5, 17])
def test_relu_and_topk_masks_match_reference(k):
    """Tie-free pre-activations (distinct magnitudes): the reference's relu
    and top-k masks exactly. The reference's top-k threshold is negated
    (src/repro/core/trace.py:80-83), so both packages keep every neuron."""
    rng = np.random.default_rng(k)
    pre = (rng.permutation(3 * 4 * 32) + 1).astype(np.float32).reshape(3, 4, 32)
    pre *= rng.choice([-1.0, 1.0], pre.shape).astype(np.float32) / 97
    np.testing.assert_array_equal(
        ttrace.relu_activation_mask(torch.from_numpy(pre)).numpy(),
        np.asarray(jtrace.relu_activation_mask(jnp.asarray(pre))))
    got = ttrace.topk_activation_mask(torch.from_numpy(pre), k).numpy()
    want = np.asarray(jtrace.topk_activation_mask(jnp.asarray(pre), k))
    np.testing.assert_array_equal(got, want)
    assert got.all()


@pytest.mark.parametrize("topk", [None, 40])
def test_trace_model_activations_matches_reference(topk):
    """The same weights (the reference's, converted) and token batches give
    the reference's per-layer masks, except where a pre-activation sits
    within 1e-5 of the threshold (float32 sums in another order). A top-k
    trace is all ones in both packages (see the test above)."""
    small = dict(d_model=32, d_ff=128, n_layers=2, vocab_size=64)
    jcfg = jget_config("opt-350m", reduced=True, **small)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = get_config("opt-350m", reduced=True, **small)
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               cfg, device="cpu")
    rng = np.random.default_rng(4)
    batches = [rng.integers(0, 64, (2, 8)).astype(np.int32) for _ in range(3)]
    got = ttrace.trace_model_activations(model, params, batches,
                                         sparsity_topk=topk)
    pre = np.concatenate([np.asarray(jmodel.forward(
        jparams, {"tokens": jnp.asarray(b)}, capture_activations=True)
        ["ffn_pre_act"]).reshape(2, -1, 128) for b in batches], axis=1)
    want = jtrace.trace_model_activations(
        lambda p, t, capture_activations: jmodel.forward(
            p, {"tokens": t}, capture_activations=capture_activations),
        jparams, batches, sparsity_topk=topk)
    assert len(got) == len(want) == 2
    for l, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (48, 128) and g.dtype == bool
        differ = g != w
        if topk is None:
            assert (np.abs(pre[l][differ]) < 1e-5).all()
        else:
            assert not differ.any() and g.all()
        assert differ.mean() < 0.01
