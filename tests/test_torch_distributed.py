"""Sharded training and the sequence pipeline of the port on a real gloo
world on the CPU, against the reference and the port's unsharded step.

One 8-rank world (a (2, 4) mesh over ("data", "model"), FileStore in
tmp_path, one thread a rank) runs in a subprocess, port only, from inputs
this process writes: the reference's params of `granite-3-2b` reduced to
d_model 256, 4 / 2 heads, vocab 512, d_ff 512 and an 8 x 32 batch (as
tests/test_sharding.py), and the inputs of tests/test_seq_pipeline.py.
Rank 0 writes what it measured; the tests below hold it:
  * the sharded step's loss equals the reference's single-device jitted
    step within 2e-3 relative (that test's own bound) and the port's
    unsharded step within 1e-5;
  * each gathered gradient leaf is within 1e-4 relative L2 of the unsharded
    step's, and the sharded step's params equal AdamW on the gathered
    gradients to 1e-6;
  * `pipelined_mlstm_forward` equals the reference's `ssm.mlstm_forward`
    within 1e-4;
  * a distribute -> gather round trip of the train state is bit-exact.
Then `launch.train.main([... "--model-axis", "2", "--device", "cpu"])` on
4 ranks: its loss history is within 2e-3 of the one-process run's, and its
checkpoint is read by the reference's `load_checkpoint`.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import ssm as jssm
from repro.training import checkpoint as jckpt
from repro.training.optimizer import AdamWConfig as JAdamWConfig
from repro.training.optimizer import init_adamw as jinit_adamw
from repro.training.train import TrainState as JTrainState
from repro.training.train import make_train_step as jmake_train_step

ROOT = Path(__file__).resolve().parents[1]
GRANITE = dict(d_model=256, n_heads=4, n_kv_heads=2, vocab_size=512,
               d_ff=512)
XLSTM = dict(d_model=64, n_heads=2, n_kv_heads=2)
TIMEOUT = 600

_WORLD = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TMP = sys.argv[1]


def unflatten(flat):
    tree = {}
    for key, a in flat.items():
        node = tree
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = a
    return tree


def rank_main(rank, world):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + TMP + "/store",
                            rank=rank, world_size=world)
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.seq_pipeline import pipelined_mlstm_forward
    from repro_torch.launch.train import state_specs
    from repro_torch.models import build_model
    from repro_torch.training.optimizer import AdamWConfig, adamw_update, init_adamw
    from repro_torch.training.train import TrainState, grads_of, make_train_step
    from repro_torch.utils import tree_leaves

    inp = np.load(TMP + "/inputs.npz")
    mesh = sh.make_mesh((2, 4), ("data", "model"), "cpu")
    cfg = get_config("granite-3-2b", reduced=True, d_model=256, n_heads=4,
                     n_kv_heads=2, vocab_size=512, d_ff=512)
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(unflatten(
        {k[len("granite/"):]: inp[k] for k in inp.files
         if k.startswith("granite/")}), cfg, device="cpu")
    tokens = torch.from_numpy(inp["tokens"])
    opt_cfg = AdamWConfig()
    state = TrainState(params, init_adamw(params, opt_cfg))
    specs = state_specs(params, mesh)
    dstate = sh.distribute_tree(state, specs, mesh)
    dbatch = {"tokens": distribute_tensor(tokens, mesh, sh.placements(
        sh.batch_spec(mesh, tokens.shape[0], 2), mesh))}

    # a distribute -> gather round trip
    roundtrip = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(sh.full_tree(dstate)), tree_leaves(state)))
    # gradients, sharded (gathered) and unsharded
    _, _, g_sh = grads_of(model, dstate.params, dbatch)
    g_sh = sh.full_tree(g_sh)
    _, _, g_un = grads_of(model, params, {"tokens": tokens})
    grad_l2 = max(float((a - b).norm() / b.norm())
                  for a, b in zip(tree_leaves(g_sh), tree_leaves(g_un)))
    # the step, sharded and unsharded
    step = make_train_step(model, opt_cfg)
    new_sh, m_sh = step(dstate, dbatch)
    new_un, m_un = step(state, {"tokens": tokens})
    placed = all(a.placements == b.placements for a, b in zip(
        tree_leaves(new_sh), tree_leaves(dstate)))
    new_full = sh.full_tree(new_sh.params)
    redo, _, _ = adamw_update(g_sh, init_adamw(params, opt_cfg), params,
                              opt_cfg)
    param_err = max(float((a - b).abs().max())
                    for a, b in zip(tree_leaves(new_full), tree_leaves(redo)))

    # the sequence pipeline over the model axis
    xcfg = get_config("xlstm-125m", reduced=True, d_model=64, n_heads=2,
                      n_kv_heads=2)
    p = {k[len("mlstm/"):]: torch.from_numpy(inp[k]) for k in inp.files
         if k.startswith("mlstm/")}
    y = pipelined_mlstm_forward(p, torch.from_numpy(inp["x"]), xcfg, mesh)
    y_places = [str(q) for q in y.placements]
    y = y.full_tensor()
    if rank == 0:
        np.save(TMP + "/pipelined.npy", y.numpy())
        with open(TMP + "/world.json", "w") as f:
            json.dump({"loss_sharded": float(m_sh["loss"]),
                       "loss_unsharded": float(m_un["loss"]),
                       "grad_norm_sharded": float(m_sh["grad_norm"]),
                       "grad_max_leaf_l2_rel": grad_l2,
                       "params_vs_adamw_on_gathered": param_err,
                       "state_keeps_placements": placed,
                       "roundtrip_exact": roundtrip,
                       "pipelined_placements": y_places}, f)
    dist.destroy_process_group()


def train_main(rank, world, port, argv):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    from repro_torch.launch import train
    history = train.main(argv)
    if rank == 0:
        with open(TMP + "/train.json", "w") as f:
            json.dump(history, f)


if __name__ == "__main__":
    mp.spawn(rank_main, args=(8,), nprocs=8)
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(train_main, args=(4, port, json.loads(sys.argv[2])), nprocs=4)
    print("WORLD_DONE")
"""

TRAIN_ARGV = ["--arch", "granite-3-2b", "--steps", "4", "--batch", "8",
              "--seq", "32", "--device", "cpu"]


def _flat(tree, prefix):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        out[prefix + key] = np.asarray(leaf)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Run the world once: (its measurements, the reference's step and
    mLSTM output, the temporary directory)."""
    tmp = tmp_path_factory.mktemp("world")
    jcfg = jget_config("granite-3-2b", reduced=True, **GRANITE)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 512, (8, 32)).astype(np.int32)
    jopt = JAdamWConfig()
    _, jmetrics = jax.jit(jmake_train_step(jmodel, jopt))(
        JTrainState(params=jparams, opt=jinit_adamw(jparams, jopt)),
        {"tokens": jnp.asarray(tokens)})

    xcfg = jget_config("xlstm-125m", reduced=True, **XLSTM)
    p = jssm.init_mlstm(jax.random.PRNGKey(0), xcfg)
    x = (np.random.default_rng(0).standard_normal((2, 64, 64)) * 0.5
         ).astype(np.float32)
    mlstm_ref = np.asarray(jssm.mlstm_forward(p, jnp.asarray(x), xcfg))
    np.savez(tmp / "inputs.npz", tokens=tokens, x=x,
             **_flat(jparams, "granite/"), **_flat(p, "mlstm/"))

    script = tmp / "world.py"
    script.write_text(_WORLD)
    ckpt = str(tmp / "ck" / "state.npz")
    argv = TRAIN_ARGV + ["--model-axis", "2", "--checkpoint", ckpt]
    res = subprocess.run(
        [sys.executable, str(script), str(tmp), json.dumps(argv)],
        capture_output=True, text=True, timeout=TIMEOUT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1", "HOME": str(tmp), "TMPDIR": str(tmp)})
    assert "WORLD_DONE" in res.stdout, res.stdout[-4000:] + res.stderr[-8000:]
    with open(tmp / "world.json") as f:
        measured = json.load(f)
    with open(tmp / "train.json") as f:
        measured["train_history"] = json.load(f)
    print("measured:", {k: v for k, v in measured.items()
                        if k != "train_history"})
    return {"measured": measured, "ref_loss": float(jmetrics["loss"]),
            "mlstm_ref": mlstm_ref,
            "pipelined": np.load(tmp / "pipelined.npy"), "ckpt": ckpt}


def test_sharded_loss_matches_reference_and_unsharded(world):
    m = world["measured"]
    ref = world["ref_loss"]
    assert abs(m["loss_sharded"] - ref) < 2e-3 * max(abs(ref), 1.0), (m, ref)
    assert abs(m["loss_sharded"] - m["loss_unsharded"]) <= \
        1e-5 * abs(m["loss_unsharded"]), m


def test_sharded_gradients_and_update(world):
    m = world["measured"]
    assert m["grad_max_leaf_l2_rel"] <= 1e-4, m
    assert m["params_vs_adamw_on_gathered"] <= 1e-6, m
    assert m["state_keeps_placements"], m


def test_distribute_gather_round_trip_is_exact(world):
    assert world["measured"]["roundtrip_exact"]


def test_pipelined_mlstm_matches_reference(world):
    err = float(np.abs(world["pipelined"] - world["mlstm_ref"]).max())
    print("pipelined mLSTM vs reference:", err)
    assert err < 1e-4, err
    # batch over data, sequence over model
    from torch.distributed.tensor import Shard
    assert world["measured"]["pipelined_placements"] == [str(Shard(0)),
                                                         str(Shard(1))]


def test_launch_train_model_axis_matches_one_process(world):
    from repro_torch.launch import train
    sharded = world["measured"]["train_history"]
    single = train.main(TRAIN_ARGV)
    assert [h["step"] for h in sharded] == [h["step"] for h in single]
    for a, b in zip(sharded, single):
        assert abs(a["loss"] - b["loss"]) <= 2e-3, (a, b)


def test_launch_train_checkpoint_reads_in_reference(world):
    jcfg = jget_config("granite-3-2b", reduced=True)
    jparams = jbuild_model(jcfg).init_params(jax.random.PRNGKey(1))
    like = JTrainState(params=jparams, opt=jinit_adamw(jparams,
                                                       JAdamWConfig()))
    state, meta = jckpt.load_checkpoint(world["ckpt"], like)
    assert meta == {"step": 4, "arch": "granite-3-2b"}
    assert int(state.opt.step) == 4
    for a in jax.tree_util.tree_leaves(state):
        assert np.all(np.isfinite(np.asarray(a, np.float32)))
    # the port reads the same file into its one-device state, bit for bit
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training.checkpoint import load_checkpoint
    from repro_torch.training.optimizer import AdamWConfig, init_adamw
    from repro_torch.training.train import TrainState
    from repro_torch.convert import params_to_numpy
    p = build_model(get_config("granite-3-2b", reduced=True),
                    device="cpu").init_params(torch.Generator().manual_seed(5))
    port, _ = load_checkpoint(world["ckpt"], TrainState(
        p, init_adamw(p, AdamWConfig())))
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(port.params)),
                    jax.tree_util.tree_leaves(state.params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert os.path.exists(world["ckpt"] + ".json")
