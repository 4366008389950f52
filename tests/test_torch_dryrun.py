"""The dry run of the port and its shape-only stand-ins, against the
reference's (tests/test_dryrun.py, tests/test_input_specs.py).

  * `launch.specs`: batch, decode-token and cache stand-ins have the
    reference's shapes and dtypes (`jax.ShapeDtypeStruct`s), on the meta
    device, and the same SWA routing;
  * the collective accounting adds output bytes by kind, as the
    reference's HLO parser does, for recorded outputs and for a DTensor
    redistribution on a fake world;
  * `run_case("xlstm-125m", "decode_32k")` on a fake 8-rank (2, 4) world:
    FLOPs and collective bytes above 0, and per-device argument bytes equal
    to the sum over leaves of bytes / shard count under the reference's own
    specs for that mesh, plus the declared stack-axis divergence: on
    (2, 4) xlstm-125m's G = 2 divides the data axis, so the reference
    shards its 12 stacked norm leaves [2, 768] over (data, model) and the
    port's per-layer [768] leaves over model only (384 bytes a leaf more
    a device, named below).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ASSIGNED_CONFIGS, INPUT_SHAPES
from repro.configs import get_config as jget_config
from repro.distributed import sharding as jsh
from repro.launch import specs as jspecs
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun
from repro_torch.launch import specs as specs_lib

_DT = {jnp.dtype(jnp.int32): torch.int32, jnp.dtype(jnp.bfloat16): torch.bfloat16,
       jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.int8): torch.int8}


def _same(sds, t):
    assert isinstance(t, torch.Tensor) and t.device.type == "meta"
    assert tuple(t.shape) == tuple(sds.shape)
    assert t.dtype == _DT[jnp.dtype(sds.dtype)]


@pytest.mark.parametrize("arch", sorted(ASSIGNED_CONFIGS))
def test_batch_and_token_specs_match_reference(arch):
    jcfg = jget_config(arch, param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg = get_config(arch, param_dtype="bfloat16", compute_dtype="bfloat16")
    for name, shape in INPUT_SHAPES.items():
        ref = jspecs.batch_specs(jcfg, shape)
        port = specs_lib.batch_specs(cfg, shape)
        assert set(ref) == set(port)
        for k in ref:
            _same(ref[k], port[k])
        ref_t, port_t = (jspecs.decode_token_specs(shape),
                         specs_lib.decode_token_specs(shape))
        assert set(ref_t) == set(port_t)
        for k in ref_t:
            _same(ref_t[k], port_t[k])
        assert specs_lib.uses_swa_for(cfg, shape) == \
            jspecs.uses_swa_for(jcfg, shape)


@pytest.mark.parametrize("arch", ["internlm2-20b", "jamba-1.5-large-398b",
                                  "xlstm-125m", "seamless-m4t-medium"])
@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
def test_cache_struct_matches_reference(arch, shape_name):
    """The port's per-layer cache leaves stack to the reference's leaves,
    shapes and dtypes, by path."""
    jcfg = jget_config(arch, param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg = get_config(arch, param_dtype="bfloat16", compute_dtype="bfloat16")
    shape = INPUT_SHAPES[shape_name]
    ref = {jsh._leaf_path_str(p): l for p, l in
           jax.tree_util.tree_flatten_with_path(
               jspecs.cache_struct(jcfg, shape, jbuild_model(jcfg)))[0]}
    port = {}
    sh.map_stacked(lambda p, st, l: port.setdefault(p, (st, l)),
                   specs_lib.cache_struct(cfg, shape))
    assert set(ref) == set(port)
    for path, sds in ref.items():
        stack, leaf = port[path]
        assert tuple(stack) + tuple(leaf.shape) == tuple(sds.shape), path
        assert leaf.dtype == _DT[jnp.dtype(sds.dtype)], path
        assert leaf.device.type == "meta"


def test_collective_accounting_adds_output_bytes_by_kind():
    """The reference's parser example (tests/test_dryrun.py), as recorded
    outputs of the functional collectives: an async pair's wait is not
    counted."""
    cost = dryrun.DeviceCost()
    cost.record("all_reduce", torch.empty((128, 256), dtype=torch.float32))
    cost.record("all_gather_into_tensor", torch.empty(64, dtype=torch.bfloat16))
    cost.record("reduce_scatter_tensor_coalesced",
                [torch.empty(32), torch.empty(32)])
    cost.record("all_to_all_single", torch.empty((16, 16)))
    cost.record("send", torch.empty(8, dtype=torch.bfloat16))
    cost.record("wait_tensor", torch.empty(8, dtype=torch.bfloat16))
    out = cost.summary()
    assert out["all-reduce"] == 128 * 256 * 4
    assert out["all-gather"] == 128
    assert out["reduce-scatter"] == 256
    assert out["all-to-all"] == 1024
    assert out["collective-permute"] == 16
    assert out["total"] == sum(v for k, v in out.items() if k != "total")


def test_collective_accounting_sees_dtensor_moves():
    """On a fake (2, 4) world: gathering a [16, 8] float32 DTensor sharded
    over model records one all-gather of its whole bytes (each rank's
    output), and a partial sum's reduction one all-reduce."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor import DTensor, distribute_tensor
    mesh_like = sh.abstract_mesh((2, 4), ("data", "model"))
    with dryrun.fake_world(mesh_like) as mesh:
        t = distribute_tensor(torch.empty((16, 8)), mesh,
                              [Replicate(), Shard(0)])
        cost = dryrun.DeviceCost()
        with cost:
            t.redistribute(mesh, [Replicate(), Replicate()])
        assert cost.summary() == {"all-gather": 16 * 8 * 4,
                                  "total": 16 * 8 * 4}
        part = DTensor.from_local(torch.empty((4, 4)), mesh,
                                  [Replicate(), Partial()])
        cost = dryrun.DeviceCost()
        with cost:
            part.redistribute(mesh, [Replicate(), Replicate()])
        assert cost.summary() == {"all-reduce": 64, "total": 64}


def _ref_arg_bytes(arch, shape_name, sizes, names):
    """(Σ leaf bytes / shard count of the decode step's arguments under the
    reference's specs (params bf16, cache, tokens: the port's decode takes
    its shared position as a host int, not a tensor argument), {path: the
    bytes a device more for each param leaf whose reference spec shards
    its stack axis, where the port's per-layer leaves drop that entry})."""
    jcfg = jget_config(arch, param_dtype="bfloat16", compute_dtype="bfloat16")
    jmodel = jbuild_model(jcfg)
    mesh = jsh.abstract_mesh(sizes, names)
    shape = INPUT_SHAPES[shape_name]
    params = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0))
    cache = jspecs.cache_struct(jcfg, shape, jmodel)
    toks = jspecs.decode_token_specs(shape)
    shape_of = dict(zip(names, sizes))

    def shards(spec):
        return math.prod(shape_of[a] for e in spec if e is not None
                         for a in (e if isinstance(e, tuple) else (e,)))

    def nbytes(leaf):
        return math.prod(leaf.shape) * jnp.dtype(leaf.dtype).itemsize

    pflat = jax.tree_util.tree_flatten_with_path(params)[0]
    pspecs = jax.tree_util.tree_leaves(jsh.param_specs(params, mesh),
                                       is_leaf=lambda x: isinstance(x, JP))
    pairs = [(l, s) for (_, l), s in zip(pflat, pspecs)]
    pairs += list(zip(jax.tree_util.tree_leaves(cache), jax.tree_util.tree_leaves(
        jsh.cache_specs(cache, mesh, shape.global_batch),
        is_leaf=lambda x: isinstance(x, JP))))
    pairs += [(toks["tokens"], jsh.batch_spec(mesh, shape.global_batch, 2))]
    total = 0
    for leaf, spec in pairs:
        assert nbytes(leaf) % shards(spec) == 0
        total += nbytes(leaf) // shards(spec)
    extra = {}
    for (path, leaf), spec in zip(pflat, pspecs):
        path = jsh._leaf_path_str(path)
        if path.startswith("stack/") and spec and spec[0] is not None:
            extra[path] = (nbytes(leaf) // shards(spec[1:])
                           - nbytes(leaf) // shards(spec))
    return total, extra


def test_run_case_xlstm_decode_on_fake_world():
    sizes, names = (2, 4), ("data", "model")
    r = dryrun.run_case("xlstm-125m", "decode_32k", save_dir="",
                        mesh=sh.abstract_mesh(sizes, names))
    assert r["cost_analysis"]["flops"] > 0
    # XLA's "bytes accessed" / optimal_seconds have no counterpart here
    assert set(r["cost_analysis"]) == {"flops"}
    assert r["collective_bytes"]["total"] > 0, \
        "model-parallel decode must communicate"
    assert r["n_devices"] == 8 and r["mesh"] == {"data": 2, "model": 4}
    assert r["position"] == 32_767
    assert set(r) >= {"arch", "shape", "mesh", "param_count",
                      "active_param_count", "swa", "memory_analysis",
                      "cost_analysis", "collective_bytes"}
    total, extra = _ref_arg_bytes("xlstm-125m", "decode_32k", sizes, names)
    assert set(extra) == {f"stack/sub_{j}/norm1/{leaf}" for j in range(6)
                          for leaf in ("scale", "bias")}
    assert set(extra.values()) == {384}
    mem = r["memory_analysis"]
    assert mem["argument_size_in_bytes"] == total + sum(extra.values())
    assert mem["peak_bytes"] >= mem["argument_size_in_bytes"]
    # nothing stays initialised after the case
    import torch.distributed as dist
    assert not dist.is_initialized()


@pytest.mark.parametrize("triangular", [False, True])
def test_run_case_traces_flash_past_the_threshold(monkeypatch, triangular):
    """A reduced granite-3-2b prefill of 2100 positions (past
    `FLASH_SEQ_THRESHOLD`) on a fake (2, 4) world traces the flash form
    the config names, once a layer, and holds less at its peak than one
    layer's plain [T, S] float32 scores alone would."""
    from repro_torch.configs import InputShape
    from repro_torch.models import layers
    T, B = 2100, 4
    monkeypatch.setitem(dryrun.INPUT_SHAPES, "prefill_2k",
                        InputShape("prefill_2k", T, B, "prefill"))
    calls = []
    name = ("_flash_gqa_attend_triangular" if triangular
            else "_flash_gqa_attend")
    real = getattr(layers, name)

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)
    monkeypatch.setattr(layers, name, counted)
    overrides = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                     d_ff=128, vocab_size=128, flash_q_chunk=512,
                     flash_k_chunk=512, flash_triangular=triangular)
    r = dryrun.run_case("granite-3-2b", "prefill_2k", save_dir="",
                        mesh=sh.abstract_mesh((2, 4), ("data", "model")),
                        config_overrides=overrides)
    # each rank attends its own 2 rows and all 4 heads (2 KV heads do not
    # divide the model axis of 4); two layers, in the uncounted warm-up
    # run and in the counted one (`trace_case`)
    assert calls == [(B // 2, T, 4, 16)] * 4
    plain_scores = (B // 2) * 4 * T * T * 4
    assert 0 < r["memory_analysis"]["peak_bytes"] < plain_scores
    assert r["cost_analysis"]["flops"] > 0


# -- the cases repaired for torch 2.11 (the card machine's; ROADMAP §3) -------
# On 2.11 every train case failed in `F.pad` of a DTensor (the CE's padded
# last chunk), the sliding-window decode of long_500k in `index_put_` (the
# ring write: no DTensor strategy) and in the plain swa op's [B, KV, G, hd]
# view of a head-sharded q, and full-width xlstm long_500k / jamba
# prefill_32k in adding a sharded bias to a partial sum. The tests below
# run those cases here on a fake (2, 4) world at the reduced widths of the
# flash test above and check that no such op reaches DTensor.

REDUCED = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
               vocab_size=128, flash_q_chunk=512, flash_k_chunk=512)


def _traced_dtensor_ops(monkeypatch, arch, shape_name, T=None, B=4,
                        **run_kw):
    """run_case on a fake (2, 4) world (train and prefill cut to T x B),
    and the names of the ops dispatched on DTensors."""
    from repro_torch.configs import InputShape
    from torch.distributed.tensor import DTensor
    base = dryrun.INPUT_SHAPES[shape_name]
    monkeypatch.setitem(dryrun.INPUT_SHAPES, shape_name, InputShape(
        shape_name, T or base.seq_len, min(B, base.global_batch), base.kind))
    seen = set()
    real = dryrun.DeviceCost.__torch_dispatch__

    def recording(self, func, types, args=(), kwargs=None):
        if any(t is DTensor for t in types):
            seen.add(str(func))
        return real(self, func, types, args, kwargs)
    monkeypatch.setattr(dryrun.DeviceCost, "__torch_dispatch__", recording)
    r = dryrun.run_case(arch, shape_name, save_dir="",
                        mesh=sh.abstract_mesh((2, 4), ("data", "model")),
                        config_overrides=REDUCED, **run_kw)
    return r, seen


def test_train_case_pads_no_dtensor(monkeypatch):
    """A train step of 600 positions (599 targets: a CE chunk of 512 and
    a short one) traces with no `F.pad` on a DTensor: the short last chunk
    is taken as it is, where the reference pads it with mask-0 positions
    (the same sum: tests/test_torch_train.py's two-chunk loss)."""
    r, seen = _traced_dtensor_ops(monkeypatch, "granite-3-2b", "train_4k",
                                  T=600, microbatches=2)
    assert r["cost_analysis"]["flops"] > 0 and r["microbatches"] == 2
    assert "aten.mm.default" in seen
    assert not {op for op in seen if "pad" in op}, seen


@pytest.mark.parametrize("arch", ["granite-3-2b", "internvl2-26b",
                                  "seamless-m4t-medium"])
def test_long_decode_writes_and_attends_rings_per_shard(monkeypatch, arch):
    """long_500k decode (one row, sliding-window rings; dense, VLM and
    encoder-decoder) traces: the ring write reaches no DTensor as an
    indexed write, and the swa op runs on each rank's rows and KV heads
    (its [B, KV, G, hd] view of 4 heads over a model axis of 4 would be
    uneven: it failed here before)."""
    r, seen = _traced_dtensor_ops(monkeypatch, arch, "long_500k")
    assert r["swa"] and r["position"] == 524_287
    assert r["collective_bytes"]["total"] > 0
    assert not {op for op in seen if "index_put" in op}, seen


@pytest.fixture
def fake_pg():
    """A fake 8-rank process group (rank 0) and its (2, 4) CPU mesh, with
    real tensors: a rank's own local ops compute, collectives move
    nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield sh.make_mesh((2, 4), ("data", "model"), "cpu")
    finally:
        dist.destroy_process_group()


def test_write_rows_writes_each_ranks_shard(fake_pg):
    """`dtensor.write_rows_` into a ring sharded on its rows and on its
    head dim writes rank 0's shard as the plain indexed write does, from a
    replicated source and columns; a ring sharded on the written dim is
    refused."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.distributed.dtensor import write_rows_
    gen = torch.Generator().manual_seed(0)
    ring = torch.randn((4, 6, 8, 2), generator=gen)
    src = torch.randn((4, 2, 8, 2), generator=gen)
    cols = torch.tensor([[0, 5], [1, 2], [3, 4], [5, 0]])
    want = write_rows_(ring.clone(), cols, src)
    placed = distribute_tensor(ring.clone(), fake_pg, [Shard(0), Shard(2)])
    out = write_rows_(placed, cols, src)
    assert out is placed and list(out.placements) == [Shard(0), Shard(2)]
    # rank 0 holds rows 0..1 and heads 0..1
    assert torch.equal(out.to_local(), want[:2, :, :2])
    assert not torch.equal(want[:2, :, :2], ring[:2, :, :2])
    with pytest.raises(ValueError, match="cannot write rows"):
        write_rows_(distribute_tensor(ring.clone(), fake_pg,
                                      [Replicate(), Shard(1)]), cols, src)


def test_reduced_reduces_partials_and_keeps_shards(fake_pg):
    """`dtensor.reduced`: a partial sum becomes replicated on its mesh dim
    (one all-reduce), a shard stays; a plain tensor and a DTensor with no
    partial come back as they are. `apply_norm` of a partial residual
    reduces it first."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    from repro_torch.distributed.dtensor import reduced
    from repro_torch.models.layers import apply_norm, init_norm
    t = DTensor.from_local(torch.ones((2, 4)), fake_pg, [Shard(0), Partial()])
    cost = dryrun.DeviceCost()
    with cost:
        out = reduced(t)
    assert [str(p) for p in out.placements] == ["S(0)", "R"]
    assert cost.summary()["all-reduce"] == 2 * 4 * 4
    kept = DTensor.from_local(torch.ones((2, 4)), fake_pg,
                              [Shard(0), Shard(1)])
    assert reduced(kept) is kept
    plain = torch.ones(3)
    assert reduced(plain) is plain
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = get_config("xlstm-125m", reduced=True, d_model=4)
    with implicit_replication():     # the plain scale and bias replicated
        y = apply_norm(init_norm(cfg, "cpu", 4), t, cfg)
    assert not any(p.is_partial() for p in y.placements)


def test_peak_and_flops_leave_out_dtensor_shape_propagation(monkeypatch):
    """DTensor runs an op on fake tensors of the global shapes the first
    time it meets the op's input specs, to learn its output's shape; the
    counters leave those runs out (`trace_case` runs the step once
    uncounted first). So a case traced in a fresh DTensor cache (a shape
    no other test uses) counts what the same case counts once the cache is
    warm. Uncorrected, a granite-3-2b prefill_32k on (16, 16) counted two
    global [32, 32768, 8192] FFN activations: 49.84 GiB a device."""
    from repro_torch.configs import InputShape
    monkeypatch.setitem(dryrun.INPUT_SHAPES, "prefill_32k",
                        InputShape("prefill_32k", 328, 8, "prefill"))
    overrides = dict(REDUCED, n_layers=1, d_ff=1024)
    runs = [dryrun.run_case("granite-3-2b", "prefill_32k", save_dir="",
                            mesh=sh.abstract_mesh((2, 4), ("data", "model")),
                            config_overrides=overrides) for _ in range(2)]
    first, second = runs
    assert first["memory_analysis"] == second["memory_analysis"]
    assert first["cost_analysis"] == second["cost_analysis"]
