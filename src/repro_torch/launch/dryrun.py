"""Dry run over a fake world: trace one train, prefill or decode step of the
port for every (arch x input-shape x mesh), sharded by
`distributed.sharding`, with no allocation on any device.

This is the one entry point of the port that needs no card. Each case
opens a fake process group of the mesh's world (`torch.testing`'s
`FakeStore` and the "fake" backend: collectives return at once and move
nothing) in this one CPU process, builds the mesh, and runs the step on
DTensors whose local shards are fake tensors (`FakeTensorMode`: shapes and
dtypes, no storage). For rank 0 of the mesh it records, per device:
  * argument bytes: the sum of the local shards of the step's inputs
    (params or train state, batch or tokens, cache; a decode step's shared
    position is a host int here, the cache's last slot);
  * peak memory: `torch.distributed._tools.mem_tracker.MemTracker` over the
    step, the inputs counted in;
  * FLOPs: the formulas of `torch.utils.flop_counter` applied to each op
    on the local shards (DTensor's own ops decompose into them);
  * collective bytes by kind (all-reduce, all-gather, reduce-scatter,
    all-to-all, collective-permute): the output bytes of each
    `_c10d_functional` collective, as the reference counts the output
    shapes of its HLO collectives.
The reference's XLA cost model also gives "bytes accessed" and
`optimal_seconds`; nothing here measures them, so the results leave them
out (ROADMAP §3, declared divergences). On a CPU mesh DTensor runs an
all-to-all as an all-gather and a chunk, so such moves count as
all-gather.

Run:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
Results are saved under experiments/dryrun/ as JSON, with the reference's
meta keys.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ASSIGNED_CONFIGS, INPUT_SHAPES, get_config
from repro_torch.distributed import sharding
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import make_production_mesh

# functional collectives by the reference's HLO kind
COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv": "collective-permute",
}
NOT_MOVES = ("wait_tensor",)


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


def output_bytes(out) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(out))


class DeviceCost(TorchDispatchMode):
    """Per-device FLOPs and collective output bytes of the ops run under
    it. DTensor ops are let through (NotImplemented) so that their local
    ops and collectives come back here one by one."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.collectives: Dict[str, int] = defaultdict(int)

    def record(self, name: str, out) -> None:
        """Add `out`'s bytes to the kind of collective `name` (an op's
        name in `_c10d_functional` or `c10d`); other names are ignored."""
        if name in NOT_MOVES:
            return
        self.collectives[COLLECTIVE_KINDS.get(name, name)] += \
            output_bytes(out)

    def summary(self) -> Dict[str, int]:
        out = dict(self.collectives)
        out["total"] = sum(out.values())
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(t is DTensor for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if isinstance(func, torch._ops.OpOverload):
            if func.namespace in ("_c10d_functional", "c10d"):
                self.record(func._schema.name.split("::")[-1].rstrip("_"),
                            out)
            formula = self.registry.get(func._overloadpacket)
            if formula is not None:
                self.flops += int(formula(*args, **kwargs, out_val=out))
        return out


@contextlib.contextmanager
def _strided_shard_offsets_on_real_tensors():
    """DTensor computes a `_StridedShard`'s local offsets from a
    `torch.arange` and `.tolist()`, which a fake tensor cannot answer:
    that bookkeeping runs outside the fake mode."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types as pt
    orig = pt._StridedShard.local_shard_size_and_offset

    def on_real(self, *args, **kwargs):
        with unset_fake_temporarily():
            return orig(self, *args, **kwargs)
    pt._StridedShard.local_shard_size_and_offset = on_real
    try:
        yield
    finally:
        pt._StridedShard.local_shard_size_and_offset = orig


@contextlib.contextmanager
def fake_world(mesh_like):
    """A fake process group of `mesh_like`'s world, its `DeviceMesh` (CPU)
    and a `FakeTensorMode`; the group is destroyed on exit."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run opens its own fake process group")
    shape = sharding.mesh_shape(mesh_like)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh_like.size)
    try:
        mesh = sharding.make_mesh(tuple(shape.values()), tuple(shape),
                                  "cpu")
        with FakeTensorMode(), _strided_shard_offsets_on_real_tensors():
            yield mesh
    finally:
        dist.destroy_process_group()


def _fake(t: torch.Tensor) -> torch.Tensor:
    """A meta-device stand-in as a fake CPU tensor of its shape and dtype."""
    return torch.empty(t.shape, dtype=t.dtype)


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    from repro_torch.utils import tree_leaves
    return sum((t.to_local() if isinstance(t, DTensor) else t).numel()
               * t.element_size() for t in tree_leaves(tree))


def _locals(tree) -> list:
    from torch.distributed.tensor import DTensor
    from repro_torch.utils import tree_leaves
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in tree_leaves(tree)]


# per-arch gradient-accumulation defaults for train_4k (activation memory)
TRAIN_MICROBATCHES = defaultdict(lambda: 8)


def _place_batch(batch: Dict[str, torch.Tensor], mesh):
    from torch.distributed.tensor import distribute_tensor
    return {k: distribute_tensor(_fake(v), mesh, sharding.placements(
        sharding.batch_spec(mesh, v.shape[0], v.ndim), mesh))
        for k, v in batch.items()}


def build_step(arch: str, shape_name: str, mesh,
               microbatches: Optional[int] = None,
               config_overrides: Optional[dict] = None):
    """(step, args, meta) for one (arch, shape) case on `mesh` (a device
    mesh of a fake world, inside its fake mode): `step(*args)` runs the
    train, prefill or decode step of `arch` (bf16 params and compute) on
    the placed inputs. `config_overrides`: ModelConfig field overrides
    (e.g. flash_triangular=True), as the reference takes them."""
    from repro_torch.models import build_model
    from repro_torch.training.optimizer import AdamWConfig, init_adamw
    from repro_torch.training.train import TrainState, make_train_step
    cfg = get_config(arch, param_dtype="bfloat16", compute_dtype="bfloat16",
                     **(config_overrides or {}))
    model = build_model(cfg, device="cpu")
    shape = INPUT_SHAPES[shape_name]
    params = model.init_params(torch.Generator().manual_seed(0))
    meta: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": sharding.mesh_shape(mesh),
        "param_count": int(cfg.param_count()),
        "active_param_count": int(cfg.active_param_count()),
    }

    if shape.kind == "train":
        mb = microbatches or TRAIN_MICROBATCHES[arch]
        meta["microbatches"] = mb
        from repro_torch.launch.train import state_specs
        opt_cfg = AdamWConfig(moment_dtype="bfloat16")
        state = TrainState(params, init_adamw(params, opt_cfg))
        state = sharding.distribute_tree(state, state_specs(params, mesh),
                                         mesh)
        batch = _place_batch(specs_lib.batch_specs(cfg, shape), mesh)
        return (make_train_step(model, opt_cfg, microbatches=mb),
                (state, batch), meta)

    dparams = sharding.distribute_tree(
        params, sharding.param_specs(params, mesh), mesh)
    cache = sharding.map_stacked(lambda _, __, t: _fake(t),
                                 specs_lib.cache_struct(cfg, shape))
    cspecs = sharding.cache_specs(cache, mesh, shape.global_batch)
    dcache = sharding.distribute_tree(cache, cspecs, mesh)

    if shape.kind == "prefill":
        batch = _place_batch(specs_lib.batch_specs(cfg, shape), mesh)

        def prefill_fn(params, batch, cache):
            return model.prefill(params, batch, cache)
        return prefill_fn, (dparams, batch, dcache), meta

    swa = specs_lib.uses_swa_for(cfg, shape)
    meta["swa"] = swa
    window = cfg.sliding_window if swa else 0
    toks = specs_lib.decode_token_specs(shape)
    tokens = _place_batch({"tokens": toks["tokens"]}, mesh)["tokens"]
    # the port's contiguous cache takes a shared decode position on the host
    # (`kvcache.kv_write` slices at it), so the step decodes at a concrete
    # one, the cache's last slot, where the reference traces an abstract
    # int32 scalar
    position = shape.seq_len - 1
    meta["position"] = position

    def serve_step(params, tokens, cache):
        return model.decode_step(params, tokens, position, cache,
                                 window=window)
    return serve_step, (dparams, tokens, dcache), meta


def trace_case(step, args) -> Dict[str, Any]:
    """Run `step(*args)` once under the per-device counters: argument
    bytes, peak memory, FLOPs and collective bytes (rank 0's). DTensor
    derives an op's output shape by running the op on fake tensors of the
    global shapes, the first time it meets the op's input specs; the
    counters would take those tensors and FLOPs for the device's (a
    granite-3-2b prefill_32k layer's FFN: [32, 32768, 8192] a tensor on
    (16, 16)). So the step runs once uncounted first, which fills
    DTensor's sharding cache, and the counted run meets no such tensor."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.experimental import implicit_replication
    arg_bytes = _local_bytes(args)
    with implicit_replication():
        step(*args)
    tracker = MemTracker()
    tracker.track_external(*_locals(args))
    cost = DeviceCost()
    with tracker, cost, implicit_replication():
        step(*args)
    peak = sum(v["Total"] for v in tracker.get_tracker_snapshot("peak")
               .values())
    return {"memory": {"argument_size_in_bytes": arg_bytes,
                       "peak_bytes": int(peak)},
            "flops": cost.flops, "collective_bytes": cost.summary()}


def run_case(arch: str, shape_name: str, multi_pod: bool = False,
             microbatches: Optional[int] = None,
             save_dir: str = "experiments/dryrun",
             mesh=None, config_overrides: Optional[dict] = None
             ) -> Dict[str, Any]:
    """Trace one case on a fake world of `mesh`'s shape (an abstract mesh;
    default the production mesh; `config_overrides` as `build_step`) and
    save its JSON under `save_dir`."""
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    with fake_world(mesh) as dmesh:
        t0 = time.perf_counter()
        step, args, meta = build_step(arch, shape_name, dmesh, microbatches,
                                      config_overrides=config_overrides)
        t_build = time.perf_counter() - t0
        t0 = time.perf_counter()
        traced = trace_case(step, args)
        t_trace = time.perf_counter() - t0
    result = {
        **meta,
        "n_devices": int(mesh.size),
        "build_seconds": round(t_build, 2),
        "trace_seconds": round(t_trace, 2),
        "memory_analysis": traced["memory"],
        "cost_analysis": {"flops": float(traced["flops"])},
        "collective_bytes": traced["collective_bytes"],
    }
    mem = traced["memory"]
    print(f"[dryrun] {arch} x {shape_name} x {mesh.size}dev: "
          f"flops={traced['flops']:.3e} "
          f"coll={traced['collective_bytes']['total']:.3e} "
          f"args={mem['argument_size_in_bytes'] / 2**30:.2f}GiB "
          f"peak={mem['peak_bytes'] / 2**30:.2f}GiB "
          f"(build {t_build:.0f}s, trace {t_trace:.0f}s)")
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        tag = f"{arch}_{shape_name}_{'pod2' if multi_pod else 'pod1'}"
        with open(os.path.join(save_dir, tag + ".json"), "w") as f:
            json.dump(result, f, indent=2)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=sorted(ASSIGNED_CONFIGS))
    ap.add_argument("--shape", default=None, choices=sorted(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="all (arch x shape) pairs")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--save-dir", default="experiments/dryrun")
    args = ap.parse_args(argv)

    if args.all:
        archs = sorted(ASSIGNED_CONFIGS)
        shapes = list(INPUT_SHAPES)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        archs, shapes = [args.arch], [args.shape]

    failures = []
    for arch in archs:
        for shape in shapes:
            try:
                run_case(arch, shape, multi_pod=args.multi_pod,
                         microbatches=args.microbatches,
                         save_dir=args.save_dir)
            except Exception as e:  # noqa: BLE001 — report every failing combo
                failures.append((arch, shape, repr(e)[:200]))
                print(f"[dryrun] FAIL {arch} x {shape}: {e!r}")
    if failures:
        raise SystemExit(f"{len(failures)} dry-run failures: {failures}")
    print("[dryrun] all cases traced OK")


if __name__ == "__main__":
    main()
