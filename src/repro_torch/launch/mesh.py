"""Device meshes: the host's mesh over the process group's world, and the
reference's production shapes as abstract meshes.

Functions, so importing this module touches no process group.
"""
from __future__ import annotations

from repro_torch.distributed.sharding import abstract_mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production shapes: 16 x 16 = 256 devices a pod, 2
    pods = 512 multi-pod. An abstract mesh (names and sizes) for specs and
    the dry run; not a claim about any cluster of cards."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return abstract_mesh(shape, axes)


def check_model_axis(model_axis: int, world: int) -> None:
    """Raise ValueError unless `model_axis` divides `world` (the reference
    asserts it)."""
    if model_axis < 1 or world % model_axis:
        raise ValueError(f"--model-axis {model_axis} does not divide the "
                         f"world of {world} rank(s)")


def make_host_mesh(model_axis: int = 1, device_type: str = "cuda"):
    """(world / model_axis, model_axis) over ("data", "model") on the
    initialised process group's ranks; `check_model_axis` first."""
    import torch.distributed as dist
    n = dist.get_world_size() if dist.is_initialized() else 1
    check_model_axis(model_axis, n)
    return make_mesh((n // model_axis, model_axis), ("data", "model"),
                     device_type)
