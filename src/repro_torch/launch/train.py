"""Training command of the port: AdamW on next-token cross-entropy over
synthetic-corpus batches, on one device, with optional gradient
accumulation and checkpoints in the reference's format.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
      --reduced --steps 50 --batch 8 --seq 128 [--microbatches 2] \
      [--checkpoint ckpt/state.npz [--checkpoint-every 10] [--resume]] \
      [--device cpu]

The flags, the warmup rule (max(steps // 20, 2) steps of a cosine schedule
over `--steps`), the log lines and the checkpoint metadata ({"step",
"arch"}) are the reference's `repro.launch.train`. `--resume` loads the
checkpoint's state and continues from its saved step with a fresh data
iterator, as the reference does. Sharding is not ported yet:
`--model-axis` above 1 exits. Weights come from the port's seeded init
(`repro_torch.launch`), not the reference's.
"""
import argparse
import os
import time

from repro_torch.configs import ASSIGNED_CONFIGS, get_config
from repro_torch.data.pipeline import DataConfig, make_data_iter
from repro_torch.launch import seeded_model
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.training.optimizer import AdamWConfig, init_adamw
from repro_torch.training.train import TrainState, make_train_step
from repro_torch.utils import (add_verbosity_flag, configure_logging,
                               get_logger, pretty_bytes, tree_size_bytes)

logger = get_logger("launch.train")

MODEL_AXIS_UNPORTED = ("--model-axis > 1 shards the model over a device "
                       "mesh: the distributed slice (distributed/*, "
                       "launch/mesh.py) is not ported yet; this trainer "
                       "runs on one device")


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
    if args.model_axis > 1:
        raise SystemExit(MODEL_AXIS_UNPORTED)

    overrides = {}
    if args.vocab:
        overrides["vocab_size"] = args.vocab
    cfg = get_config(args.arch, reduced=args.reduced, **overrides)
    model, params = seeded_model(cfg, args.seed, args.device)
    logger.info("device: %s", model.device)

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

    step_fn = make_train_step(model, opt_cfg, microbatches=args.microbatches)
    data = make_data_iter(DataConfig(vocab_size=cfg.vocab_size,
                                     seq_len=args.seq,
                                     batch_size=args.batch, seed=args.seed),
                          device=model.device)
    history = []
    t0 = time.perf_counter()
    for step in range(start_step, args.steps):
        state, metrics = step_fn(state, next(data))
        m = {k: float(v) for k, v in metrics.items()}
        history.append({"step": step, **m})
        if step % max(args.steps // 20, 1) == 0 or step == args.steps - 1:
            logger.info("step %4d  loss=%.4f  grad_norm=%.3f  lr=%.2e",
                        step, m["loss"], m["grad_norm"], m["lr"])
        if (args.checkpoint and args.checkpoint_every
                and (step + 1) % args.checkpoint_every == 0):
            save_checkpoint(args.checkpoint, state,
                            {"step": step + 1, "arch": args.arch})
    dt = time.perf_counter() - t0
    tokens = (args.steps - start_step) * args.batch * args.seq
    logger.info("done: %.1fs, %.0f tokens/s", dt, tokens / max(dt, 1e-9))
    if args.checkpoint:
        save_checkpoint(args.checkpoint, state,
                        {"step": args.steps, "arch": args.arch})
        logger.info("final checkpoint: %s", args.checkpoint)
    return history


if __name__ == "__main__":
    main()
