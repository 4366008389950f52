"""Offline packing command: run the paper's whole offline stage on the port's
device and write the deployable NeuronPack artifact.

  PYTHONPATH=src python -m repro_torch.launch.pack --arch qwen2-7b --reduced \
      --out model.npack [--calib-tokens 512] [--quantize int8] \
      [--no-placement] [--placement-mode auto|exact|topk] \
      [--d-model N] [--d-ff N] [--n-layers N] [--device cuda|cpu]

The calibration trace runs on the device and the co-activation counts go
through the coact kernel there (`--device cpu`: its plain version); the
placement search runs on the host. Serve the pack with
``repro_torch.launch.serve --mode offload --pack model.npack`` and the SAME
--arch/--seed/geometry flags (weights are deterministic from the seed; load
-time validation rejects geometry mismatches).
"""
import argparse
import time

from repro_torch.configs import ASSIGNED_CONFIGS, get_config
from repro_torch.launch import seeded_model
from repro_torch.store.packer import build_pack
from repro_torch.utils import add_verbosity_flag, configure_logging, get_logger

logger = get_logger("launch.pack")


def main(argv=None):
    """Parse `argv` (default sys.argv), build the pack; returns the
    `PackBuildReport`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b", choices=sorted(ASSIGNED_CONFIGS))
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--out", required=True, help="output NeuronPack path")
    ap.add_argument("--calib-tokens", type=int, default=512,
                    help="random calibration tokens to trace (streamed to "
                         "disk shards, so this can exceed RAM)")
    ap.add_argument("--calib-batch", type=int, default=8)
    ap.add_argument("--calib-seqlen", type=int, default=64)
    ap.add_argument("--quantize", choices=("none", "int8"), default="none",
                    help="int8 = per-neuron symmetric quantized bundles with "
                         "float32 scales")
    ap.add_argument("--no-placement", action="store_true",
                    help="identity layout (LLMFlash-style baseline pack)")
    ap.add_argument("--placement-mode", choices=("auto", "exact", "topk"),
                    default="auto")
    ap.add_argument("--pack-version", type=int, choices=(1, 2), default=2,
                    help="NeuronPack format version: 2 (default) adds the "
                         "header CRC + per-bundle CRC32 tables that "
                         "--verify-checksums serving checks; 1 writes the "
                         "legacy checksum-free layout")
    ap.add_argument("--shard-dir", default=None,
                    help="keep trace shards here (default: temp dir, deleted)")
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--d-ff", type=int, default=None)
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to trace and count on (default cuda; "
                         "'cpu' runs the plain versions)")
    add_verbosity_flag(ap)
    args = ap.parse_args(argv)
    configure_logging(args.verbose)

    overrides = dict(vocab_size=args.vocab, activation="relu")
    for key in ("d_model", "d_ff", "n_layers"):
        val = getattr(args, key)
        if val is not None:
            overrides[key] = val
    cfg = get_config(args.arch, reduced=args.reduced, **overrides)
    if cfg.family != "dense" or cfg.is_encdec:
        raise SystemExit("packing is implemented for dense decoder-only archs")
    model, params = seeded_model(cfg, args.seed, args.device)

    t0 = time.perf_counter()
    report = build_pack(
        model, params, args.out,
        calib_tokens=args.calib_tokens, calib_batch=args.calib_batch,
        calib_seqlen=args.calib_seqlen, seed=args.seed,
        use_placement=not args.no_placement,
        placement_mode=args.placement_mode, quantize=args.quantize,
        shard_dir=args.shard_dir, pack_version=args.pack_version,
        meta=dict(arch=args.arch, seed=args.seed, vocab_size=cfg.vocab_size),
        device=model.device)
    logger.info(
        "packed %d layers x %d neurons x %d floats -> %s (%.1f MB, %s, "
        "%s layout) in %.1fs on %s: traced %d tokens in %.2fs, counts %.2fs, "
        "placement search %.2fs, write %.2fs",
        report.n_layers, report.n_neurons, report.bundle_width, report.path,
        report.file_bytes / 1e6,
        "int8" if report.quantized else "float32", report.placement_mode,
        time.perf_counter() - t0, model.device, report.tokens_traced,
        report.trace_seconds, report.counts_seconds, report.search_seconds,
        report.write_seconds)
    logger.info("serve it: PYTHONPATH=src python -m repro_torch.launch.serve "
                "--arch %s --mode offload --pack %s --seed %d",
                args.arch, report.path, args.seed)
    return report


if __name__ == "__main__":
    main()
