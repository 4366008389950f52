"""Training in the port against the reference: loss, gradients, AdamW, the
train step, the data pipeline, checkpoints and `launch.train`.

On the CPU, from the reference's params converted into the port and the
same seeded numpy batches:

- `Model.loss_fn` for a dense (opt-350m; a 520-token row, so two CE chunks
  of 512, the second short where the reference pads it), MoE
  (granite-moe, with its aux loss), SSM (xlstm), hybrid (jamba: Mamba,
  attention and MoE layers), encoder-decoder (seamless) and VLM
  (internvl2) model, with a random
  `loss_mask`, equals the reference's to 1e-5 relative;
- the gradient of every leaf equals `jax.grad`'s to 1e-4 of that leaf's
  largest magnitude. A leaf whose largest gradient is below 1e-3 of the
  largest over all leaves is held to 1e-4 of that 1e-3 instead: xlstm's
  mLSTM input-gate bias, whose true gradient cancels in the normaliser
  (both packages give float noise of 1e-8 there);
- `cosine_schedule` at every step, and one `adamw_update` from equal
  gradients (clipping active, decay by the reference's stacked ndim,
  float32 and bf16 moments), equal the reference's;
- `make_train_step` with 1 and 2 microbatches over 3 steps equals the
  reference's (losses 1e-5 relative, grad norms 1e-4, params 1e-4);
  one step in bf16 (params, compute and moments, the dry run's dtypes)
  of a dense, MoE and hybrid model against the reference's run op by op,
  each side also measured against the float32 gradient of the same bf16
  values (`test_bf16_train_step_matches_reference`);
- `synthetic_batches` and `byte_batches` give the reference's tokens;
- the counterparts of tests/test_data_and_train.py;
- checkpoints: each package loads the other's files into its own
  TrainState bit for bit (float32 and bf16), KeyError on a missing tensor
  and ValueError on a shape mismatch, with the reference's messages;
- `launch.train.main` on the CPU, then again with `--resume`: it starts at
  the saved step from the saved state, bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import pipeline as jpipe
from repro.models import build_model as jbuild_model
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro.training import train as jtrain
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.data.pipeline import (DataConfig, SyntheticCorpus,
                                       byte_batches, make_data_iter,
                                       synthetic_batches)
from repro_torch.models import build_model
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            cosine_schedule, init_adamw)
from repro_torch.training.train import (TrainState, grads_of,
                                        init_train_state, make_train_step,
                                        train_loop)
from repro_torch.utils import tree_leaves, tree_map

torch.set_num_threads(1)

# (arch, config overrides, sequence length)
FAMILIES = [
    pytest.param("opt-350m", dict(d_model=64, d_ff=256), 520,
                 id="dense-two-chunks"),
    pytest.param("granite-moe-1b-a400m", dict(d_model=64), 16, id="moe"),
    pytest.param("xlstm-125m", dict(d_model=64), 16, id="ssm"),
    pytest.param("jamba-1.5-large-398b", dict(d_model=64), 16, id="hybrid"),
    pytest.param("seamless-m4t-medium", dict(d_model=64, d_ff=128), 12,
                 id="encdec"),
    pytest.param("internvl2-26b", dict(d_model=64, d_ff=128), 12, id="vlm"),
]
VOCAB = 128


def _batch(cfg, B, S, seed=0, mask=True):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if mask:
        batch["loss_mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
    feats = (B, cfg.n_prefix_tokens, cfg.d_frontend)
    if cfg.family == "vlm":
        batch["patch_feats"] = rng.standard_normal(feats).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(feats).astype(np.float32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _pair(arch, seed=0, **kw):
    jcfg = jget_config(arch, reduced=True, vocab_size=VOCAB, **kw)
    jmodel = jbuild_model(jcfg)
    tree = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(seed)))
    cfg = get_config(arch, reduced=True, vocab_size=VOCAB, **kw)
    return (jmodel, jax.tree_util.tree_map(jnp.asarray, tree),
            build_model(cfg, device="cpu"),
            params_from_numpy(tree, cfg, device="cpu"))


def _flat_ref(tree):
    """The reference tree's leaves with their paths, in jax's order."""
    return [(jax.tree_util.keystr(p), np.asarray(l))
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _assert_grads_close(jgrads, grads):
    want = _flat_ref(jgrads)
    got = jax.tree_util.tree_leaves(params_to_numpy(grads))
    assert len(want) == len(got)
    top = max(float(np.abs(a).max()) for _, a in want)
    for (path, a), b in zip(want, got):
        scale = max(float(np.abs(a).max()), 1e-3 * top)
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4 * scale,
                                   err_msg=path)


@pytest.mark.parametrize("arch,kw,S", FAMILIES)
def test_loss_matches_reference(arch, kw, S):
    jmodel, jparams, model, params = _pair(arch, **kw)
    batch = _batch(model.cfg, 2, S)
    jloss, jaux = jax.jit(jmodel.loss_fn)(jparams, _j(batch))
    loss, aux = model.loss_fn(params, _t(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(aux["ce"]), float(jaux["ce"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux["aux_loss"]),
                               float(jaux["aux_loss"]), rtol=1e-5, atol=1e-7)
    if arch.startswith("granite-moe"):
        assert float(aux["aux_loss"]) > 0


@pytest.mark.parametrize("arch,kw,S", FAMILIES)
def test_gradients_match_reference(arch, kw, S):
    jmodel, jparams, model, params = _pair(arch, seed=1, **kw)
    batch = _batch(model.cfg, 2, S, seed=1)
    jgrads = jax.jit(jax.grad(lambda p, b: jmodel.loss_fn(p, b)[0]))(
        jparams, _j(batch))
    loss, _, grads = grads_of(model, params, _t(batch))
    assert torch.isfinite(loss)
    _assert_grads_close(jgrads, grads)


def test_loss_mask_defaults_to_every_position():
    _, _, model, params = _pair("opt-350m", d_model=64, d_ff=256)
    batch = _batch(model.cfg, 2, 10, mask=False)
    ones = dict(batch, loss_mask=np.ones((2, 10), np.float32))
    a, _ = model.loss_fn(params, _t(batch))
    b, _ = model.loss_fn(params, _t(ones))
    assert float(a) == float(b)


def test_cosine_schedule_matches_reference():
    kw = dict(lr_peak=1e-3, warmup_steps=10, total_steps=100)
    jcfg, cfg = jopt.AdamWConfig(**kw), AdamWConfig(**kw)
    for s in range(0, 121):
        want = np.float32(jopt.cosine_schedule(jcfg, jnp.int32(s)))
        got = cosine_schedule(cfg, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, err_msg=s)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(moments):
    """One update from equal gradients on a granite tree (stacked norms:
    decayed in the reference's layout), with clipping active (the global
    norm is above `grad_clip_norm`) and a warm state (step 5, moments from
    the seed)."""
    jmodel, jparams, model, params = _pair("granite-3-2b", d_model=64)
    kw = dict(lr_peak=1e-2, warmup_steps=2, total_steps=20,
              grad_clip_norm=0.5, moment_dtype=moments)
    jcfg, cfg = jopt.AdamWConfig(**kw), AdamWConfig(**kw)
    rng = np.random.default_rng(0)
    ref = jax.tree_util.tree_map(np.asarray, jparams)
    g = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), ref)
    mdt = jnp.dtype(moments)
    mu = jax.tree_util.tree_map(
        lambda a: (0.1 * rng.standard_normal(a.shape)).astype(mdt), ref)
    nu = jax.tree_util.tree_map(
        lambda a: (0.1 * rng.random(a.shape)).astype(mdt), ref)
    jstate = jopt.AdamWState(step=jnp.int32(5), mu=mu, nu=nu)
    cfg_t = model.cfg
    tg = params_from_numpy(g, cfg_t, device="cpu")
    state = init_adamw(params, cfg)._replace(
        step=torch.tensor(5, dtype=torch.int32),
        mu=params_from_numpy(jax.tree_util.tree_map(np.asarray, mu), cfg_t,
                             device="cpu"),
        nu=params_from_numpy(jax.tree_util.tree_map(np.asarray, nu), cfg_t,
                             device="cpu"))
    jp, js, jm = jopt.adamw_update(
        jax.tree_util.tree_map(jnp.asarray, g), jstate, jparams, jcfg)
    p, s, m = adamw_update(tg, state, params, cfg)
    assert float(jm["grad_norm"]) > kw["grad_clip_norm"]
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    assert float(m["lr"]) == float(jm["lr"])
    assert int(s.step) == int(js.step) == 6
    for want, got in ((jp, p), (js.mu, s.mu), (js.nu, s.nu)):
        for (path, a), b in zip(_flat_ref(want),
                                jax.tree_util.tree_leaves(
                                    params_to_numpy(got))):
            if a.dtype.name == "bfloat16":
                a = a.astype(np.float32)
                b = torch.from_numpy(b.view(np.int16).copy()).view(
                    torch.bfloat16).float().numpy()
                tol = dict(rtol=1e-2, atol=0)   # one bf16 rounding
            else:
                tol = dict(rtol=1e-6, atol=1e-8)
            np.testing.assert_allclose(b, a, err_msg=path, **tol)
    assert (s.mu["stack"][0]["sub_0"]["norm1"]["scale"].dtype
            == getattr(torch, moments))


def test_decay_follows_the_reference_stacked_ndim():
    """With zero gradients only the decay moves a leaf: a layer's norm scale
    (2-D stacked in the reference) moves, the final norm's (1-D) does not."""
    _, _, model, params = _pair("granite-3-2b", d_model=64)
    cfg = AdamWConfig(lr_peak=1e-2, warmup_steps=0, total_steps=10)
    zeros = tree_map(torch.zeros_like, params)
    p, _, _ = adamw_update(zeros, init_adamw(params, cfg), params, cfg)
    assert not torch.equal(p["stack"][0]["sub_0"]["norm1"]["scale"],
                           params["stack"][0]["sub_0"]["norm1"]["scale"])
    assert torch.equal(p["final_norm"]["scale"], params["final_norm"]["scale"])


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    jmodel, jparams, model, params = _pair("granite-3-2b", n_layers=2)
    opt = dict(lr_peak=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jtrain.make_train_step(jmodel, jopt.AdamWConfig(**opt),
                                           microbatches))
    step = make_train_step(model, AdamWConfig(**opt), microbatches)
    jstate = jtrain.TrainState(jparams, jopt.init_adamw(
        jparams, jopt.AdamWConfig(**opt)))
    state = TrainState(params, init_adamw(params, AdamWConfig(**opt)))
    for i in range(3):
        batch = _batch(model.cfg, 4, 32, seed=10 + i, mask=False)
        jstate, jm = jstep(jstate, _j(batch))
        state, m = step(state, _t(batch))
        assert set(m) == set(jm)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    for (path, a), b in zip(_flat_ref(jstate.params),
                            jax.tree_util.tree_leaves(
                                params_to_numpy(state.params))):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4, err_msg=path)


# bf16 train step (the dry run's dtypes): the reference runs op by op under
# `jax.disable_jit()`; its float32 gradient at the same bf16 values is the
# yardstick of how far bf16 rounding alone moves a gradient
BF16_STEP = [
    pytest.param("opt-350m", dict(d_model=64, d_ff=256), 16, id="dense"),
    pytest.param("granite-moe-1b-a400m", dict(d_model=64), 16, id="moe"),
    # 8 positions: the reference's Mamba scan op by op takes 40 s here
    pytest.param("jamba-1.5-large-398b", dict(d_model=64), 8, id="hybrid"),
]
BF16_ULP = 2.0 ** -8          # one bf16 rounding, relative
BF16_LOSS_RTOL = 1e-3         # float32 CE over bf16 logits (seen: 4.5e-5)
BF16_GNORM_RTOL = 1e-2        # a norm over bf16 gradients (seen: 1.8e-3)
BF16_GRAD_L2 = 5e-2           # a leaf's gradient vs the reference's (1.7e-2)
BF16_VS_F32 = 1.5             # port's distance to float32 over the reference's


def _bf16_values(a):
    a = np.asarray(a)
    if a.dtype.kind == "V":       # the port's bf16 leaves as void-2 bits
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).float().numpy()
    return a.astype(np.float32)


@pytest.mark.parametrize("arch,kw,S", BF16_STEP)
def test_bf16_train_step_matches_reference(arch, kw, S):
    """One `make_train_step` step in bf16 (params, compute and AdamW
    moments), as the dry run traces it, against the reference's on the
    same bf16 params and batch. Both round differently in bf16, so each is
    also measured against the float32 gradient of the same bf16 values
    (the reference's, jitted in float32):
      * loss within BF16_LOSS_RTOL, grad norm within BF16_GNORM_RTOL;
      * each first moment, (1 - b1) x the clipped gradient rounded to
        bf16, within BF16_GRAD_L2 of the reference's in relative L2, and
        no farther from the float32 gradient than BF16_VS_F32 x the
        reference's distance plus one bf16 rounding (BF16_ULP);
      * each param within 2 lr plus one bf16 rounding of the reference's:
        AdamW's first update moves an element by lr x g / (|g| + eps),
        +-lr, so a gradient whose sign differs moves it 2 lr apart."""
    dt = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jmodel, jparams, model, params = _pair(arch, seed=2, **kw, **dt)
    opt = dict(lr_peak=1e-3, warmup_steps=1, total_steps=10,
               moment_dtype="bfloat16")
    jcfg, cfg = jopt.AdamWConfig(**opt), AdamWConfig(**opt)
    batch = _batch(model.cfg, 2, S, seed=20)
    with jax.disable_jit():
        jstate, jm = jtrain.make_train_step(jmodel, jcfg)(
            jtrain.TrainState(jparams, jopt.init_adamw(jparams, jcfg)),
            _j(batch))
    state, m = make_train_step(model, cfg)(
        TrainState(params, init_adamw(params, cfg)), _t(batch))
    assert state.params["embed"]["embedding"].dtype == torch.bfloat16
    assert state.opt.mu["embed"]["embedding"].dtype == torch.bfloat16
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=BF16_LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=BF16_GNORM_RTOL)
    lr = float(jm["lr"])
    assert float(m["lr"]) == lr
    # the float32 gradient of the same bf16 values, clipped as the step's
    j32 = jbuild_model(jget_config(arch, reduced=True, vocab_size=VOCAB, **kw))
    g32 = jax.jit(jax.grad(lambda p, b: j32.loss_fn(p, b)[0]))(
        jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jparams),
        _j(batch))
    clip = min(1.0, cfg.grad_clip_norm / (float(jopt.global_norm(g32)) + 1e-9))
    for (path, a), b, (_, t) in zip(
            _flat_ref(jstate.opt.mu),
            jax.tree_util.tree_leaves(params_to_numpy(state.opt.mu)),
            _flat_ref(g32)):
        a, b = _bf16_values(a), _bf16_values(b)
        t = (1 - cfg.b1) * clip * t.astype(np.float32)
        norm = max(float(np.linalg.norm(t)), 1e-30)
        port_ref = float(np.linalg.norm(b - a)) / norm
        port_f32 = float(np.linalg.norm(b - t)) / norm
        ref_f32 = float(np.linalg.norm(a - t)) / norm
        assert port_ref <= BF16_GRAD_L2, (path, port_ref)
        assert port_f32 <= BF16_VS_F32 * ref_f32 + BF16_ULP, (
            path, port_f32, ref_f32)
    for (path, a), b in zip(_flat_ref(jstate.params),
                            jax.tree_util.tree_leaves(
                                params_to_numpy(state.params))):
        a, b = _bf16_values(a), _bf16_values(b)
        np.testing.assert_array_less(np.abs(b - a),
                                     2 * lr + BF16_ULP * np.abs(a) + 1e-30,
                                     err_msg=path)


def test_synthetic_batches_match_reference():
    cfg = dict(vocab_size=100, seq_len=32, batch_size=4, seed=3)
    jit_, it = (jpipe.synthetic_batches(jpipe.DataConfig(**cfg)),
                synthetic_batches(DataConfig(**cfg), device="cpu"))
    for _ in range(3):
        a, b = next(jit_)["tokens"], next(it)["tokens"]
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_byte_batches_match_reference(tmp_path):
    p = tmp_path / "corpus.txt"
    p.write_bytes(bytes(range(256)) * 8 + b"the quick brown fox " * 30)
    for vocab in (256, 100):
        cfg = dict(vocab_size=vocab, seq_len=16, batch_size=3, seed=1,
                   kind="bytes", path=str(p))
        jit_ = jpipe.make_data_iter(jpipe.DataConfig(**cfg))
        it = make_data_iter(DataConfig(**cfg), device="cpu")
        for _ in range(3):
            np.testing.assert_array_equal(next(it)["tokens"].numpy(),
                                          np.asarray(next(jit_)["tokens"]))


# -- counterparts of tests/test_data_and_train.py ------------------------------

def test_synthetic_batches_shapes_and_range():
    it = make_data_iter(DataConfig(vocab_size=100, seq_len=32, batch_size=4),
                        device="cpu")
    b = next(it)
    assert tuple(b["tokens"].shape) == (4, 32)
    assert int(b["tokens"].min()) >= 0 and int(b["tokens"].max()) < 100


def test_synthetic_corpus_is_learnable_structure():
    c = SyntheticCorpus(64, seed=0)
    rng = np.random.default_rng(0)
    seq = c.sample(rng, 2000)
    follows = sum(int(seq[i + 1] in c.successors[seq[i]]) for i in range(1999))
    assert follows / 1999 > 0.5


def test_byte_corpus(tmp_path):
    p = tmp_path / "corpus.txt"
    p.write_bytes(b"hello world, this is a tiny corpus for testing! " * 20)
    it = make_data_iter(DataConfig(vocab_size=256, seq_len=16, batch_size=2,
                                   kind="bytes", path=str(p)), device="cpu")
    assert tuple(next(it)["tokens"].shape) == (2, 16)
    short = tmp_path / "short.txt"
    short.write_bytes(b"tiny")
    with pytest.raises(ValueError, match="shorter than seq_len"):
        byte_batches(DataConfig(vocab_size=256, seq_len=16, batch_size=2,
                                kind="bytes", path=str(short)), device="cpu")


def test_cosine_schedule_shape():
    cfg = AdamWConfig(lr_peak=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(cosine_schedule(cfg, s)) for s in (0, 5, 10, 50, 100)]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(5e-4)
    assert lrs[2] == pytest.approx(1e-3)
    assert lrs[3] < lrs[2]
    assert lrs[4] == pytest.approx(1e-4, rel=0.01)


def test_adamw_decreases_quadratic():
    p = {"w": torch.tensor([5.0, -3.0])}
    cfg = AdamWConfig(lr_peak=0.1, warmup_steps=0, total_steps=1000,
                      weight_decay=0.0)
    st = init_adamw(p, cfg)
    for _ in range(200):
        p, st, _ = adamw_update({"w": 2 * p["w"]}, st, p, cfg)
    assert float(p["w"].abs().max()) < 0.5


def test_grad_accumulation_matches_full_batch():
    cfg = get_config("granite-3-2b", reduced=True, vocab_size=128, n_layers=2)
    model = build_model(cfg, device="cpu")
    opt = AdamWConfig(grad_clip_norm=1e9)   # clipping is nonlinear in the split
    state = init_train_state(model, torch.Generator().manual_seed(0), opt)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, 128, (4, 32)).astype(np.int32))}
    s1, m1 = make_train_step(model, opt, microbatches=1)(state, batch)
    s2, m2 = make_train_step(model, opt, microbatches=2)(state, batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    for a, b in zip(tree_leaves(s1.params), tree_leaves(s2.params)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    with pytest.raises(AssertionError, match="not divisible"):
        make_train_step(model, opt, microbatches=3)(state, batch)


def test_train_loop_reduces_loss():
    cfg = get_config("xlstm-125m", reduced=True, vocab_size=128)
    model = build_model(cfg, device="cpu")
    data = make_data_iter(DataConfig(vocab_size=128, seq_len=32, batch_size=8),
                          device="cpu")
    opt = AdamWConfig(lr_peak=2e-3, warmup_steps=5, total_steps=40)
    _, hist = train_loop(model, data, steps=40, opt_cfg=opt, log_every=39)
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_checkpoint_roundtrip(tmp_path):
    cfg = get_config("qwen2-7b", reduced=True, vocab_size=64, n_layers=2)
    model = build_model(cfg, device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(3),
                             AdamWConfig())
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, state, {"step": 7})
    restored, meta = load_checkpoint(path, state)
    assert meta["step"] == 7
    assert isinstance(restored, TrainState)
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert not list(tmp_path.glob("*.tmp"))


def test_checkpoint_shape_mismatch_raises(tmp_path):
    def params_of(vocab):
        cfg = get_config("qwen2-7b", reduced=True, vocab_size=vocab,
                         n_layers=2)
        return build_model(cfg, device="cpu").init_params()
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, params_of(64))
    with pytest.raises(ValueError, match=r"shape mismatch for "
                       r"'embed/embedding': ckpt \(64, 256\) vs model "
                       r"\(128, 256\)"):
        load_checkpoint(path, params_of(128))


# -- checkpoints across the two packages ---------------------------------------

def _states(dtype, moments="float32"):
    """The reference's TrainState after one step, and the port's holding
    the same values."""
    kw = dict(param_dtype=dtype, compute_dtype=dtype, n_layers=2)
    jmodel, jparams, model, params = _pair("qwen2-7b", **kw)
    ocfg = jopt.AdamWConfig(moment_dtype=moments)
    jstate = jtrain.TrainState(jparams, jopt.init_adamw(jparams, ocfg))
    rng = np.random.default_rng(0)
    grads = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype), jparams)
    p, o, _ = jopt.adamw_update(grads, jstate.opt, jparams, ocfg)
    jstate = jtrain.TrainState(p, o)
    cfg = model.cfg
    conv = lambda t: params_from_numpy(
        jax.tree_util.tree_map(np.asarray, t), cfg, device="cpu")
    state = TrainState(conv(p), init_adamw(params, AdamWConfig())._replace(
        step=torch.tensor(int(o.step), dtype=torch.int32),
        mu=conv(o.mu), nu=conv(o.nu)))
    return jstate, state


def _bits(tree):
    return [np.asarray(a).tobytes()
            for a in jax.tree_util.tree_leaves(tree)]


def _port_bits(state):
    p = params_to_numpy
    return (_bits(p(state.params)) + [state.opt.step.numpy().tobytes()]
            + _bits(p(state.opt.mu)) + _bits(p(state.opt.nu)))


def _ref_bits(jstate):
    return (_bits(jstate.params) + _bits(jstate.opt.step) + _bits(jstate.opt.mu)
            + _bits(jstate.opt.nu))


@pytest.mark.parametrize("dtype,moments", [("float32", "float32"),
                                           ("bfloat16", "bfloat16")])
def test_reference_loads_port_checkpoint(tmp_path, dtype, moments):
    jstate, state = _states(dtype, moments)
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, state, {"step": 1, "arch": "qwen2-7b"})
    like = jax.tree_util.tree_map(jnp.zeros_like, jstate)
    restored, meta = jckpt.load_checkpoint(path, like)
    assert meta == {"step": 1, "arch": "qwen2-7b"}
    assert _ref_bits(restored) == _ref_bits(jstate)
    assert jax.tree_util.tree_leaves(restored)[0].dtype == jnp.dtype(dtype)


@pytest.mark.parametrize("dtype,moments", [("float32", "float32"),
                                           ("bfloat16", "bfloat16")])
def test_port_loads_reference_checkpoint(tmp_path, dtype, moments):
    jstate, state = _states(dtype, moments)
    path = str(tmp_path / "ref.npz")
    jckpt.save_checkpoint(path, jstate, {"step": 1})
    like = tree_map(torch.zeros_like, state.params)
    restored, meta = load_checkpoint(path, TrainState(
        like, init_adamw(like, AdamWConfig(moment_dtype=moments))))
    assert meta == {"step": 1}
    assert _port_bits(restored) == _port_bits(state)
    assert restored.params["embed"]["embedding"].dtype == getattr(torch, dtype)


def test_checkpoint_missing_tensor_raises(tmp_path):
    """The reference's message, for a file of params loaded as a
    TrainState (every key lacks its `params/` prefix)."""
    jstate, state = _states("float32")
    path = str(tmp_path / "params.npz")
    jckpt.save_checkpoint(path, jstate.params)
    with pytest.raises(KeyError, match="checkpoint missing tensor "
                       "'params/embed/embedding'"):
        load_checkpoint(path, state)
    with pytest.raises(KeyError, match="checkpoint missing tensor "
                       "'params/embed/embedding'"):
        jckpt.load_checkpoint(path, jstate)


def test_checkpoint_group_count_mismatch_raises(tmp_path):
    """A stack saved with 2 groups loaded into one of 3: the reference's
    message, with the stacked shapes."""
    _, state = _states("float32")
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, state.params)
    cfg = get_config("qwen2-7b", reduced=True, vocab_size=VOCAB, n_layers=3)
    like = build_model(cfg, device="cpu").init_params()
    with pytest.raises(ValueError, match=r"shape mismatch for "
                       r"'stack/sub_0/norm1/scale': ckpt \(2, 256\) vs "
                       r"model \(3, 256\)"):
        load_checkpoint(path, like)


# -- launch.train --------------------------------------------------------------

def test_launch_train_resumes_from_the_saved_state(tmp_path, monkeypatch):
    from repro_torch.launch import train as launch_train
    ck = str(tmp_path / "ck" / "state.npz")
    argv = ["--arch", "granite-3-2b", "--vocab", "128", "--batch", "4",
            "--seq", "32", "--device", "cpu", "--checkpoint", ck]
    saved, loaded = [], []
    real_save, real_load = (launch_train.save_checkpoint,
                            launch_train.load_checkpoint)

    def save(path, state, meta=None):
        saved.append((meta["step"], [t.clone() for t in tree_leaves(state)]))
        return real_save(path, state, meta)

    def load(path, like):
        state, meta = real_load(path, like)
        loaded.append([t.clone() for t in tree_leaves(state)])
        return state, meta
    monkeypatch.setattr(launch_train, "save_checkpoint", save)
    monkeypatch.setattr(launch_train, "load_checkpoint", load)
    hist = launch_train.main(argv + ["--steps", "4", "--checkpoint-every",
                                     "2"])
    assert [h["step"] for h in hist] == [0, 1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert [s for s, _ in saved] == [2, 4, 4]
    first = saved[-1][1]
    hist2 = launch_train.main(argv + ["--steps", "6", "--resume"])
    assert [h["step"] for h in hist2] == [4, 5]
    assert len(loaded) == 1
    for a, b in zip(first, loaded[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the second call's schedule is over its own --steps, at step 5
    lr = cosine_schedule(AdamWConfig(lr_peak=1e-3, warmup_steps=2,
                                     total_steps=6), 5)
    assert hist2[0]["lr"] == float(lr)
    assert saved[-1][0] == 6


def test_launch_train_runs_with_defaults_on_the_cpu():
    from repro_torch.launch import train as launch_train
    hist = launch_train.main(["--arch", "granite-3-2b", "--steps", "4",
                              "--device", "cpu"])
    assert len(hist) == 4 and all(np.isfinite(h["loss"]) for h in hist)


def test_dataclass_fields_match_reference():
    assert ([f.name for f in dataclasses.fields(AdamWConfig)]
            == [f.name for f in dataclasses.fields(jopt.AdamWConfig)])
    assert AdamWConfig() == AdamWConfig(**dataclasses.asdict(
        jopt.AdamWConfig()))
    assert ([f.name for f in dataclasses.fields(DataConfig)]
            == [f.name for f in dataclasses.fields(jpipe.DataConfig)])
