"""Training command of the port: AdamW on next-token cross-entropy over
synthetic-corpus batches, with optional gradient accumulation and
checkpoints in the reference's format, on one device or sharded over a
device mesh.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
      --reduced --steps 50 --batch 8 --seq 128 [--microbatches 2] \
      [--checkpoint ckpt/state.npz [--checkpoint-every 10] [--resume]] \
      [--device cpu]

  # sharded: one process a card, (world / 2, 2) over ("data", "model")
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch granite-3-2b --model-axis 2

With RANK / WORLD_SIZE / LOCAL_RANK in the environment (torchrun, or a
spawned world with MASTER_ADDR / MASTER_PORT), each rank runs on
cuda:LOCAL_RANK over NCCL (`--device cpu`: the CPU over gloo), the mesh is
`launch.mesh.make_host_mesh(--model-axis)`, and the state and the batch
are DTensors placed by `distributed.sharding` (`param_specs`,
`batch_spec`). Without those variables it runs in one process on one
device, and a `--model-axis` above 1 raises ValueError (it does not divide
a world of 1). Checkpoints are written by rank 0 from whole tensors
gathered from every rank, so either package reads them; `--resume`
places the loaded tensors again.

The flags, the warmup rule (max(steps // 20, 2) steps of a cosine schedule
over `--steps`), the log lines and the checkpoint metadata ({"step",
"arch"}) are the reference's `repro.launch.train`. `--resume` loads the
checkpoint's state and continues from its saved step with a fresh data
iterator, as the reference does. Weights come from the port's seeded init
(`repro_torch.launch`), not the reference's.
"""
import argparse
import os
import time

import torch

from repro_torch.configs import ASSIGNED_CONFIGS, get_config
from repro_torch.data.pipeline import DataConfig, make_data_iter
from repro_torch.distributed import sharding
from repro_torch.launch import seeded_model
from repro_torch.launch.mesh import check_model_axis, make_host_mesh
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.training.optimizer import AdamWConfig, AdamWState, init_adamw
from repro_torch.training.train import TrainState, make_train_step
from repro_torch.utils import (add_verbosity_flag, configure_logging,
                               get_logger, pretty_bytes, tree_size_bytes)

logger = get_logger("launch.train")


def distributed_env():
    """(rank, world size, local rank) from the environment torchrun sets,
    or None when it is not set."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    return (int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
            int(os.environ.get("LOCAL_RANK", "0")))


def _join_world(env, device):
    """Join the process group of `env` (if not joined yet) on its rank's
    device: (device, whether this call opened the group)."""
    import torch.distributed as dist
    rank, world, local_rank = env
    cpu = device is not None and torch.device(device).type == "cpu"
    dev = torch.device("cpu") if cpu else torch.device("cuda", local_rank)
    if not cpu:
        from repro_torch.device import resolve_device
        dev = resolve_device(dev)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev, False
    dist.init_process_group("gloo" if cpu else "nccl", rank=rank,
                            world_size=world,
                            **({} if cpu else {"device_id": dev}))
    return dev, True


def state_specs(params, mesh) -> TrainState:
    """The train state's specs: the params' rules for the params and both
    moments, the step replicated."""
    ps = sharding.param_specs(params, mesh)
    return TrainState(params=ps, opt=AdamWState(step=sharding.P(), mu=ps,
                                                nu=ps))


def main(argv=None):
    """Parse `argv` (default sys.argv) and train; returns the history: one
    dict of float metrics ("step", "loss", "ce", "aux_loss", "grad_norm",
    "lr") per step run."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b",
                    choices=sorted(ASSIGNED_CONFIGS))
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=0,
                    help="override vocab (reduced runs)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run on the "
                         "CPU)")
    add_verbosity_flag(ap)
    args = ap.parse_args(argv)
    configure_logging(args.verbose)
    env = distributed_env()
    if env is None:
        check_model_axis(args.model_axis, 1)
        return _train(args, args.device, None)
    dev, opened = _join_world(env, args.device)
    try:
        return _train(args, dev, make_host_mesh(args.model_axis, dev.type))
    finally:
        if opened:
            import torch.distributed as dist
            dist.destroy_process_group()


def _train(args, device, mesh):
    """The training loop on `device`; sharded over `mesh` unless None."""
    rank0 = mesh is None or mesh.get_rank() == 0
    overrides = {}
    if args.vocab:
        overrides["vocab_size"] = args.vocab
    cfg = get_config(args.arch, reduced=args.reduced, **overrides)
    model, params = seeded_model(cfg, args.seed, device)
    logger.info("device: %s", model.device)
    if mesh is not None:
        logger.info("mesh: %s over %d ranks",
                    sharding.mesh_shape(mesh), mesh.size())

    opt_cfg = AdamWConfig(lr_peak=args.lr,
                          warmup_steps=max(args.steps // 20, 2),
                          total_steps=args.steps)
    state = TrainState(params=params, opt=init_adamw(params, opt_cfg))
    logger.info("params: %s", pretty_bytes(tree_size_bytes(params)))

    start_step = 0
    if args.resume and args.checkpoint and os.path.exists(args.checkpoint):
        state, meta = load_checkpoint(args.checkpoint, state)
        start_step = int(meta.get("step", 0))
        logger.info("resumed from %s at step %d", args.checkpoint, start_step)

    place = lambda batch: batch                              # noqa: E731
    if mesh is not None:
        state = sharding.distribute_tree(state, state_specs(params, mesh),
                                         mesh)
        del params
        from torch.distributed.tensor import distribute_tensor

        def place(batch):
            return {k: distribute_tensor(v, mesh, sharding.placements(
                sharding.batch_spec(mesh, v.shape[0], v.ndim), mesh))
                for k, v in batch.items()}

    def save(step):
        # every rank gathers (a collective); rank 0 writes whole tensors
        whole = sharding.full_tree(state) if mesh is not None else state
        if rank0:
            save_checkpoint(args.checkpoint, whole,
                            {"step": step, "arch": args.arch})

    step_fn = make_train_step(model, opt_cfg, microbatches=args.microbatches)
    data = make_data_iter(DataConfig(vocab_size=cfg.vocab_size,
                                     seq_len=args.seq,
                                     batch_size=args.batch, seed=args.seed),
                          device=model.device)
    history = []
    t0 = time.perf_counter()
    for step in range(start_step, args.steps):
        state, metrics = step_fn(state, place(next(data)))
        m = {k: float(v) for k, v in metrics.items()}
        history.append({"step": step, **m})
        if rank0 and (step % max(args.steps // 20, 1) == 0
                      or step == args.steps - 1):
            logger.info("step %4d  loss=%.4f  grad_norm=%.3f  lr=%.2e",
                        step, m["loss"], m["grad_norm"], m["lr"])
        if (args.checkpoint and args.checkpoint_every
                and (step + 1) % args.checkpoint_every == 0):
            save(step + 1)
    dt = time.perf_counter() - t0
    tokens = (args.steps - start_step) * args.batch * args.seq
    if rank0:
        logger.info("done: %.1fs, %.0f tokens/s", dt,
                    tokens / max(dt, 1e-9))
    if args.checkpoint:
        save(args.steps)
        if rank0:
            logger.info("final checkpoint: %s", args.checkpoint)
    return history


if __name__ == "__main__":
    main()
