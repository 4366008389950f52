"""Sharding rules of the port against the reference's, with no process group:
specs on abstract (16, 16) and (2, 16, 16) meshes for every assigned arch at
its published widths, `batch_spec`'s fallbacks, `cache_specs`, and
`replicate_below`.

The port holds each scanned stack as a list of per-layer leaves; its spec of
a leaf is the reference's spec of the stacked leaf without the stack
entries. Where the reference puts a mesh axis on the stack axis (ROADMAP §3,
declared divergences) the per-layer leaf cannot carry it: the leaves are
named below, dense FFN leaves keep the reference's shard count, and norm
scales drop the stack entry (replicated over data instead).
"""
import math

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs import ASSIGNED_CONFIGS, get_config as jget_config
from repro.distributed import sharding as jsh
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as sh
from repro_torch.launch.specs import params_struct
from repro_torch.models import build_model

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}

# leaves whose reference spec shards the stack axis [G, ...]: G = 48
# (internlm2-20b, internvl2-26b's backbone) or 32 (granite-moe-3b-a800m)
# divides 16. Dense FFN leaves take the expert rules there (the reference's
# MoE test counts the stack axis), norm scales the generic fallback.
STACK_AXIS_LEAVES = {
    "granite-moe-3b-a800m": {"stack/sub_0/norm1/scale",
                             "stack/sub_0/norm2/scale"},
    "internlm2-20b": {"stack/sub_0/ffn/w_up", "stack/sub_0/ffn/w_gate",
                      "stack/sub_0/ffn/w_down", "stack/sub_0/norm1/scale",
                      "stack/sub_0/norm2/scale"},
    "internvl2-26b": {"stack/sub_0/ffn/w_up", "stack/sub_0/ffn/w_gate",
                      "stack/sub_0/ffn/w_down", "stack/sub_0/norm1/scale",
                      "stack/sub_0/norm2/scale"},
}


def _norm(spec):
    """A spec as a tuple of None / name / tuple of names (1-tuples bare)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1
                 else (tuple(e) if isinstance(e, tuple) else e)
                 for e in spec)


def _ref_flat(tree, specs):
    return {jsh._leaf_path_str(p): (tuple(l.shape), _norm(s))
            for (p, l), s in zip(
                jax.tree_util.tree_flatten_with_path(tree)[0],
                jax.tree_util.tree_leaves(
                    specs, is_leaf=lambda x: isinstance(x, JP)))}


def _port_flat(tree, specs):
    """{path: (stack sizes, per-layer shape, spec)}, one entry a stacked
    key (the leaves of a list share one spec)."""
    shapes, out = {}, {}
    sh.map_stacked(lambda p, st, l: shapes.setdefault(p, (st, tuple(l.shape))),
                   tree)
    sh.map_stacked(lambda p, st, s: out.setdefault(p, _norm(s)), specs)
    return {p: shapes[p] + (out[p],) for p in shapes}


def _shards(spec, sizes):
    return math.prod(sizes[a] for e in spec if e is not None
                     for a in (e if isinstance(e, tuple) else (e,)))


def _ref_params(arch):
    jcfg = jget_config(arch, param_dtype="bfloat16", compute_dtype="bfloat16")
    return jax.eval_shape(jbuild_model(jcfg).init_params,
                          jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch", sorted(ASSIGNED_CONFIGS))
@pytest.mark.parametrize("multi_pod", [False, True])
def test_param_specs_match_reference(arch, multi_pod):
    sizes, names = MESHES[multi_pod]
    jparams = _ref_params(arch)
    ref = _ref_flat(jparams, jsh.param_specs(
        jparams, jsh.abstract_mesh(sizes, names)))
    params = params_struct(get_config(arch, param_dtype="bfloat16",
                                      compute_dtype="bfloat16"))
    mesh = sh.abstract_mesh(sizes, names)
    port = _port_flat(params, sh.param_specs(params, mesh))
    assert set(port) == set(ref)
    stack_axis = set()
    for path, (shape, rspec) in ref.items():
        stack, leaf_shape, spec = port[path]
        assert tuple(stack) + leaf_shape == shape, path
        depth = len(stack)
        if any(rspec[:depth]):
            stack_axis.add(path)
            if "/ffn/" in path:
                # the dense rules on the per-layer leaf: the reference's
                # shard count, every device's share the same
                assert _shards(spec, mesh.shape) == _shards(rspec, mesh.shape)
                assert spec == (("data", "model") if path.endswith(
                    ("w_up", "w_gate")) else ("model", "data")), path
            else:
                assert spec == rspec[depth:], path
        else:
            assert spec == rspec[depth:], (path, rspec, spec)
    assert stack_axis == STACK_AXIS_LEAVES.get(arch, set())


@pytest.mark.parametrize("arch", sorted(STACK_AXIS_LEAVES))
def test_stack_axis_divergence_bytes(arch):
    """What the declared divergence costs a device on (16, 16): FFN leaves
    none (the same share), each norm scale [G, d] the bytes of a replica
    over data, G d 2 (1/16 - 1/256) bytes in bf16."""
    sizes, names = MESHES[False]
    mesh = sh.abstract_mesh(sizes, names)
    jparams = _ref_params(arch)
    ref = _ref_flat(jparams, jsh.param_specs(
        jparams, jsh.abstract_mesh(sizes, names)))
    params = params_struct(get_config(arch, param_dtype="bfloat16",
                                      compute_dtype="bfloat16"))
    port = _port_flat(params, sh.param_specs(params, mesh))
    cfg = get_config(arch)
    extra = {}
    for path in STACK_AXIS_LEAVES[arch]:
        shape, rspec = ref[path]
        stack, leaf_shape, spec = port[path]
        n = math.prod(shape) * 2
        extra[path] = (n // _shards(spec, mesh.shape)
                       - n // _shards(rspec, mesh.shape))
    for path, d in extra.items():
        if "/ffn/" in path:
            assert d == 0, path
        else:
            G = cfg.n_layers
            assert d == G * cfg.d_model * 2 * 15 // 256, (path, d)
            assert d < 64 * 1024


def test_batch_spec_divisibility_fallbacks():
    mesh = sh.abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert sh.batch_spec(mesh, 256, 2) == sh.P(("pod", "data"), None)
    assert sh.batch_spec(mesh, 16, 2) == sh.P("data", None)
    assert sh.batch_spec(mesh, 1, 2) == sh.P(None, None)
    jmesh = jsh.abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    for B in (256, 64, 32, 16, 8, 1):
        for ndim in (1, 2, 3):
            assert _norm(sh.batch_spec(mesh, B, ndim)) == _norm(
                jsh.batch_spec(jmesh, B, ndim)), (B, ndim)
    assert sh.dp_axes(mesh) == jsh.dp_axes(jmesh)


@pytest.mark.parametrize("arch", ["internlm2-20b", "jamba-1.5-large-398b",
                                  "xlstm-125m"])
def test_cache_specs_match_reference(arch):
    """B = 128, S = 1024 on (16, 16): the reference's stacked specs minus
    the stack entry, every sharded dim divisible."""
    B = 128
    jcfg = jget_config(arch, param_dtype="bfloat16", compute_dtype="bfloat16")
    jmodel = jbuild_model(jcfg)
    jcache = jax.eval_shape(lambda: jmodel.init_cache(B, 1024))
    jmesh = jsh.abstract_mesh((16, 16), ("data", "model"))
    ref = _ref_flat(jcache, jsh.cache_specs(jcache, jmesh, B))
    cfg = get_config(arch, param_dtype="bfloat16", compute_dtype="bfloat16")
    cache = build_model(cfg, device="meta").init_cache(B, 1024)
    mesh = sh.abstract_mesh((16, 16), ("data", "model"))
    port = _port_flat(cache, sh.cache_specs(cache, mesh, B))
    assert set(port) == set(ref)
    for path, (shape, rspec) in ref.items():
        stack, leaf_shape, spec = port[path]
        assert tuple(stack) + leaf_shape == shape, path
        assert not any(rspec[:len(stack)])
        assert spec == rspec[len(stack):], (path, rspec, spec)
        for d, e in enumerate(spec):
            if e is not None:
                assert leaf_shape[d] % _shards((e,), mesh.shape) == 0


def test_replicate_below_counts_stacked_elements():
    """A leaf is replicated by its element count in the stacked layout: a
    reduced granite's norm scale ([256] a layer, [2, 256] stacked) is kept
    sharded under a threshold of 300, and every spec equals the
    reference's at several thresholds."""
    kw = dict(d_model=256, n_heads=4, n_kv_heads=2, vocab_size=512,
              d_ff=512)
    jcfg = jget_config("granite-3-2b", reduced=True, **kw)
    jparams = jax.eval_shape(jbuild_model(jcfg).init_params,
                             jax.random.PRNGKey(0))
    params = params_struct(get_config("granite-3-2b", reduced=True, **kw))
    mesh = sh.abstract_mesh((2, 4), ("data", "model"))
    jmesh = jsh.abstract_mesh((2, 4), ("data", "model"))
    for threshold in (0, 300, 600, 70_000, 200_000):
        ref = _ref_flat(jparams, jsh.param_specs(
            jparams, jmesh, replicate_below=threshold))
        port = _port_flat(params, sh.param_specs(
            params, mesh, replicate_below=threshold))
        for path, (shape, rspec) in ref.items():
            stack, _, spec = port[path]
            assert spec == rspec[len(stack):], (threshold, path)
    scale = _port_flat(params, sh.param_specs(params, mesh,
                                              replicate_below=300))
    assert scale["stack/sub_0/norm1/scale"][2] == ("model",)
    scale = _port_flat(params, sh.param_specs(params, mesh,
                                              replicate_below=600))
    assert scale["stack/sub_0/norm1/scale"][2] == (None,)


def test_placements_of_specs():
    """`placements` on a (2, 2, 2) CPU mesh of a fake world: Shard per named
    dim, Replicate elsewhere, ("pod", "data") on one dim in mesh order; a
    spec naming axes out of order or twice raises."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = sh.make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
        assert sh.placements(sh.P(("pod", "data"), None, "model"), mesh) == (
            Shard(0), Shard(0), Shard(2))
        assert sh.placements(sh.P(None, "data"), mesh) == (
            Replicate(), Shard(1), Replicate())
        assert sh.placements(sh.P(), mesh) == (Replicate(),) * 3
        with pytest.raises(ValueError, match="order"):
            sh.placements(sh.P(("data", "pod")), mesh)
        with pytest.raises(ValueError, match="twice"):
            sh.placements(sh.P("data", "data"), mesh)
        with pytest.raises(ValueError, match="lacks"):
            sh.placements(sh.P("expert"), mesh)
    finally:
        dist.destroy_process_group()
    assert np.prod(mesh.shape) == 8
