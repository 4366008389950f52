"""Serving command of the port: slot-based continuous batching
(InferenceServer), resident or through the RIPPLE offload runtime (oracle
masks -> batched engine step -> the fused segment FFN kernel), optionally
through the layer-ahead prefetch worker, on the port's device.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b --reduced \
      --requests 8 --prompt-len 32 --new-tokens 16 \
      [--mode offload [--pack model.npack [--verify-checksums]]] \
      [--slots 4] [--arrival-rate 2.0] [--burst 4] \
      [--queue-limit 16] [--ttft-slo 2.0] [--itl-slo 0.25] [--stream] \
      [--prefetch] [--no-overlap] [--no-placement] [--kv-quant] \
      [--page-size 16 --num-pages 256 [--page-overcommit]] [--device cpu]

`--slots N` fixes the decode-slot pool (default: one slot per request — the
one-shot batch). `--arrival-rate R` draws Poisson request arrivals at R req/s
(grouped `--burst` at a time for bursty traffic) and admits them mid-flight
as slots free up; `--stream` prints tokens as they are emitted. The overload
knobs `--queue-limit / --ttft-slo / --itl-slo` arm bounded-queue backpressure
and deadline retirement (finish_reason "rejected" / "timeout") — see the
README "Load testing & SLOs" section. `--prefetch` serves offload decode
through the asynchronous prefetch worker; an in-memory runtime then trains
its cross-layer lookahead predictors on the calibration trace
(`build_offload_runtime(train_lookahead=True)`), a `--pack` runtime
prefetches at depth 0. Weights come from the port's seeded init
(`repro_torch.launch`), not the reference's.
"""
import argparse
import time

import numpy as np

from repro_torch.configs import ASSIGNED_CONFIGS, get_config
from repro_torch.core import EngineConfig, IOScheduler
from repro_torch.launch import seeded_model
from repro_torch.obs import enable_tracing
from repro_torch.serving.engine import (OffloadedFFNRuntime, Request,
                                        build_offload_runtime)
from repro_torch.serving.server import InferenceServer
from repro_torch.utils import add_verbosity_flag, configure_logging, get_logger

logger = get_logger("launch.serve")


def main(argv=None):
    """Parse `argv` (default sys.argv) and serve; returns the requests'
    `Result`s in submission order."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b", choices=sorted(ASSIGNED_CONFIGS))
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--mode", choices=("resident", "offload"), default="resident",
                    help="offload = serve the decode FFNs from simulated flash")
    ap.add_argument("--offload", action="store_true",
                    help="deprecated alias for --mode offload")
    ap.add_argument("--slots", type=int, default=0,
                    help="decode-slot pool size for continuous batching "
                         "(0 = one slot per request)")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="Poisson request arrivals per second; 0 = all "
                         "requests available at t=0")
    ap.add_argument("--burst", type=int, default=1,
                    help="arrival burst size: requests arrive in groups of "
                         "this many sharing one Poisson arrival instant "
                         "(inter-burst gap ~ Exp(burst/rate), so the mean "
                         "rate is unchanged); 1 = plain Poisson")
    ap.add_argument("--queue-limit", type=int, default=0,
                    help="bound the admission queue: a full queue sheds "
                         "lower-priority queued work or rejects the "
                         "newcomer (finish_reason='rejected'); 0 = unbounded")
    ap.add_argument("--ttft-slo", type=float, default=0.0,
                    help="time-to-first-token deadline in seconds (monotonic "
                         "clock, submit -> first token); a queued request "
                         "that blows it is retired with "
                         "finish_reason='timeout'; 0 = none")
    ap.add_argument("--itl-slo", type=float, default=0.0,
                    help="inter-token latency deadline in seconds; an active "
                         "request whose gap between consecutive tokens "
                         "exceeds it is retired with finish_reason='timeout' "
                         "(partial tokens kept); also the budget for the "
                         "flash-I/O-aware admission gate in offload mode; "
                         "0 = none")
    ap.add_argument("--stream", action="store_true",
                    help="print each request's tokens as they are emitted")
    ap.add_argument("--no-overlap", action="store_true",
                    help="disable I/O-compute overlap in the offload scheduler")
    ap.add_argument("--prefetch", action="store_true",
                    help="async layer-ahead prefetch worker driven by "
                         "trained lookahead predictors (offload mode)")
    ap.add_argument("--no-placement", action="store_true",
                    help="identity flash layout (LLMFlash-style baseline)")
    ap.add_argument("--pack", default=None, metavar="PATH",
                    help="serve the decode FFNs from an on-disk NeuronPack "
                         "(built by repro_torch.launch.pack with the same "
                         "--arch/"
                         "--seed/geometry): REAL positional file reads per "
                         "collapsed extent. Mutually exclusive with the "
                         "synthetic in-memory flash (--no-placement)")
    ap.add_argument("--verify-checksums", action="store_true",
                    help="with --pack: verify every extent read against the "
                         "pack's per-bundle CRC32 table (format v2); a "
                         "detected corrupt read is re-read, not served")
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--page-size", type=int, default=0,
                    help="paged KV cache: tokens per page (requires "
                         "--num-pages; 0 = contiguous per-slot caches). All "
                         "KV memory lives in one shared page arena; requests "
                         "map only the pages they fill, matched prompt "
                         "prefixes share pages copy-on-write, and admission "
                         "is gated by free pages instead of slot count")
    ap.add_argument("--num-pages", type=int, default=0,
                    help="paged KV cache: total pages in the pool "
                         "(KV budget = num_pages * page_size positions)")
    ap.add_argument("--page-overcommit", action="store_true",
                    help="gate admission on the immediate prompt need only "
                         "(more concurrency; page pressure may preempt the "
                         "lowest-priority request, finish_reason='preempted') "
                         "instead of the strict worst-case reservation")
    ap.add_argument("--d-model", type=int, default=None,
                    help="geometry override, as repro_torch.launch.pack takes "
                         "it (a pack serves only the geometry it was built "
                         "for)")
    ap.add_argument("--d-ff", type=int, default=None)
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record a Chrome trace-event / Perfetto timeline of "
                         "the whole run (server steps, engine reads, prefetch "
                         "worker, per-request lanes) and write it to PATH; "
                         "open it at https://ui.perfetto.dev")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default cuda; 'cpu' "
                         "runs the kernels' plain versions)")
    add_verbosity_flag(ap)
    args = ap.parse_args(argv)
    configure_logging(args.verbose)
    tracer = enable_tracing() if args.trace_out else None
    if bool(args.page_size) != bool(args.num_pages):
        raise SystemExit("pass both --page-size and --num-pages, or neither")
    mode = "offload" if args.offload else args.mode
    if args.pack is not None:
        if mode != "offload":
            raise SystemExit("--pack requires --mode offload")
        if args.no_placement:
            raise SystemExit("--pack is mutually exclusive with "
                             "--no-placement: the layout is baked into the "
                             "pack (build an identity pack with "
                             "repro_torch.launch.pack --no-placement)")

    overrides = dict(vocab_size=args.vocab, kv_quant=args.kv_quant)
    if mode == "offload":
        overrides["activation"] = "relu"   # ReLU sparsity (paper's setting)
    for key in ("d_model", "d_ff", "n_layers"):
        if getattr(args, key) is not None:
            overrides[key] = getattr(args, key)
    cfg = get_config(args.arch, reduced=args.reduced, **overrides)
    model, params = seeded_model(cfg, args.seed, args.device)
    dev = model.device
    rng = np.random.default_rng(args.seed)

    offload = None
    scheduler = None
    if mode == "offload":
        if cfg.family != "dense" or cfg.is_encdec:
            raise SystemExit("--mode offload is implemented for dense decoder-only archs")
        t0 = time.perf_counter()
        if args.pack is not None:
            try:     # submit-time geometry validation against the model cfg
                offload = OffloadedFFNRuntime.from_pack(
                    cfg, args.pack, engine_cfg=EngineConfig(),
                    verify_checksums=args.verify_checksums, device=dev)
            except ValueError as e:
                raise SystemExit(str(e))
            logger.info("offload runtime loaded from pack %s: %d layer "
                        "engines (real file extents) in %.2fs",
                        args.pack, offload.n_layers, time.perf_counter() - t0)
        else:
            offload = build_offload_runtime(
                model, params, rng=rng, engine_cfg=EngineConfig(),
                use_placement=not args.no_placement,
                train_lookahead=args.prefetch, device=dev)
            logger.info("offload runtime calibrated: %d layer engines in %.2fs",
                        offload.n_layers, time.perf_counter() - t0)
        scheduler = IOScheduler(overlap=not args.no_overlap)

    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab_size, args.prompt_len).astype(np.int32),
                    max_new_tokens=args.new_tokens,
                    temperature=args.temperature)
            for i in range(args.requests)]
    if args.arrival_rate > 0:
        burst = max(args.burst, 1)
        n_bursts = -(-len(reqs) // burst)        # ceil
        burst_times = np.cumsum(
            rng.exponential(burst / args.arrival_rate, n_bursts))
        arrivals = np.repeat(burst_times, burst)[:len(reqs)]
    else:
        arrivals = np.zeros(len(reqs))

    on_token = None
    if args.stream:
        def on_token(uid: int, tok: int) -> None:
            logger.info("  [stream] req %d += token %d", uid, tok)

    server = InferenceServer(
        model, params, max_slots=args.slots or len(reqs),
        max_len=args.prompt_len + args.new_tokens + 8,
        mode=mode, offload=offload, scheduler=scheduler,
        prefetch=args.prefetch, seed=args.seed,
        queue_limit=args.queue_limit or None,
        ttft_slo_s=args.ttft_slo or None,
        itl_slo_s=args.itl_slo or None,
        page_size=args.page_size or None,
        num_pages=args.num_pages or None,
        page_overcommit=args.page_overcommit, device=dev)
    handles = []
    t0 = time.perf_counter()
    try:
        i = 0
        while i < len(reqs) or server.has_work:
            now = time.perf_counter() - t0
            while i < len(reqs) and arrivals[i] <= now:
                handles.append(server.submit(reqs[i], on_token=on_token))
                i += 1
            if server.has_work:
                server.step()
            elif i < len(reqs):                 # idle until the next arrival
                time.sleep(min(arrivals[i] - now, 0.01))
    except KeyboardInterrupt:
        # graceful interrupt: retire every queued/in-flight request with
        # finish_reason="error" (partial tokens preserved), shut the
        # prefetch worker down cleanly, and fall through to the normal
        # result/stat flush instead of a traceback.
        n = server.abort("interrupted (KeyboardInterrupt)")
        logger.warning("interrupted: retired %d queued/in-flight requests; "
                       "flushing partial results", n)
    finally:
        server.close()
    wall = time.perf_counter() - t0
    results = [h.result for h in handles]
    n_tok = sum(len(r.tokens) for r in results)
    n_err = sum(r.finish_reason == "error" for r in results)
    logger.info("served %d requests, %d tokens in %.2fs (%.1f tok/s), "
                "slot occupancy %.0f%% over %d decode steps",
                len(results), n_tok, wall, n_tok / max(wall, 1e-9),
                server.stats.occupancy * 100, server.stats.decode_steps)
    if n_err:
        logger.warning("  %d request(s) finished with "
                       "finish_reason='error'", n_err)
    s = server.stats
    if s.rejected or s.shed or s.timeouts:
        logger.warning("overload: %d rejected, %d shed, %d deadline "
                       "timeouts (peak queue depth %d, %d I/O-gate "
                       "deferrals)", s.rejected, s.shed, s.timeouts,
                       s.peak_queue_depth, s.io_deferrals)
    for r in results[:3]:
        logger.info("  req %d: prefill %.0fms decode %.0fms io %.0fms "
                    "finish=%s -> %s...",
                    r.uid, r.prefill_seconds * 1e3, r.decode_seconds * 1e3,
                    r.io_seconds * 1e3, r.finish_reason, r.tokens[:6])

    pg = server.page_summary()
    if pg is not None:
        logger.info("paged KV: %d pages x %d tokens (%d KV positions, "
                    "quant=%s), peak occupancy %d pages; %d allocated / %d "
                    "freed over the run", pg["num_pages"], pg["page_size"],
                    pg["kv_positions"], pg["quantized"],
                    pg["peak_page_occupancy"], pg["pages_allocated"],
                    pg["pages_freed"])
        logger.info("  prefix sharing: %d hits, %d pages shared, %d CoW "
                    "copies, %d registry entries live (%d evicted); "
                    "pressure: %d page deferrals, %d preemptions",
                    pg["prefix_hits"], pg["pages_shared"], pg["cow_copies"],
                    pg["registry_entries"], pg["prefix_evictions"],
                    pg["page_deferrals"], pg["preemptions"])

    if mode == "offload":
        s = offload.io_summary()
        logger.info("offload I/O: %.2fms/token run_len=%.2f bw=%.0fMB/s hit=%.2f",
                    s["io_seconds_per_token"] * 1e3, s["mean_run_length"],
                    s["effective_bandwidth"] / 1e6, s["cache_hit_rate"])
        if s["retries"] or s["corrupt_extents"] or s["degraded_steps"] \
                or s["worker_restarts"]:
            logger.warning("fault tolerance engaged: %d retried reads, %d "
                           "corrupt extents caught, %d degraded steps, %d "
                           "worker restarts", s["retries"],
                           s["corrupt_extents"], s["degraded_steps"],
                           s["worker_restarts"])
        if "measured_file_seconds_per_token" in s:
            logger.info("pack file I/O MEASURED: %.3fms/token over %d real "
                        "extent reads (%.1f MB; page-cache-warm after the "
                        "first pass — see README caveat)",
                        s["measured_file_seconds_per_token"] * 1e3,
                        s["measured_extents_total"],
                        s["measured_bytes_total"] / 1e6)
        p = server.scheduler.summary()
        logger.info("pipeline (host-measured compute + modeled io): "
                    "serial %.2fms/token overlapped %.2fms/token "
                    "(%.1f%% hidden, overlap=%s)",
                    p["serial_seconds_per_token"] * 1e3,
                    p["overlapped_seconds_per_token"] * 1e3,
                    p["overlap_efficiency"] * 100, p["overlap_enabled"])
        if "measured_wall_seconds_per_token" in p:
            logger.info("prefetch MEASURED: wall %.2fms/token, io-worker busy "
                        "%.2fms, hidden %.2fms, exposed %.2fms (%.1f%% of "
                        "I/O host time off the critical path)",
                        p["measured_wall_seconds_per_token"] * 1e3,
                        p["measured_io_busy_seconds_per_token"] * 1e3,
                        p["measured_hidden_seconds_per_token"] * 1e3,
                        p["measured_exposed_seconds_per_token"] * 1e3,
                        p["measured_overlap_efficiency"] * 100)
    if offload is not None:
        offload.close()     # releases FileNeuronStore fds for --pack runs
    if tracer is not None:
        events = tracer.export(args.trace_out)
        logger.info("trace: %d events (%d dropped) -> %s; open it at "
                    "https://ui.perfetto.dev", len(events), tracer.dropped,
                    args.trace_out)
    return results


if __name__ == "__main__":
    main()
