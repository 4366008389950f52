#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py            # needs one CUDA card

Phases, in order (any failure raises and the script exits non-zero):
  1. device: the card's name and `nvidia-smi` name + power limit.
  2. build: compile every CUDA source of the port with nvcc (sm_90a).
  3. kernel: the fused segment-FFN kernel against its plain PyTorch version
     on the card, f32 / int8 / gated, with padded segment ids; max error,
     kernel and plain times (CUDA events around the Python call, L2 flushed
     between launches, median of 30), the kernels' own device time from
     `torch.profiler` with a cold and a warm L2, and the bound (bytes over
     3.35 TB/s vs fp32 flops over 67 TFLOP/s, the H100 SXM data-sheet
     rates).
  4. slice: full-width opt-350m (24 layers, d_model 1024, d_ff 4096, vocab
     50272, random weights from --seed; no depth cut) served through
     `InferenceServer(mode="offload")` — 4 requests, 32-token prompts, 16
     new tokens — then the same requests resident. Checks: every request
     finishes by length, the resolved FFN path is the segment kernel, the
     kernel launched decode_steps x 24 times and the plain version never ran
     during offload decode, and offload tokens equal resident tokens (a
     difference is accepted only at a resident top-2 logit margin < 1e-4).
  5. breakdown: the slice's requests once more per mode, their decode steps
     under `torch.profiler` and the port's tracer: wall, device time and
     idle share per step, the FFN kernel's device time, the top device
     kernels, and the offload engine's host spans (probe / read / admit).

Prints one JSON line per phase, then `{"kernels": [...]}`, the
`nvidia-smi` name/power line, and last `{"ok": true, "device": {...}}`.
Imports torch, numpy and the port only.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS = 67e12             # H100 SXM data sheet, fp32 outside tensor cores
TOL = 1e-4                     # fp32; the kernel sums in another order
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/sparse_ffn_fused.cu"
KERNEL_REPLACES = "src/repro/kernels/sparse_ffn.py:165"
FFN_KERNELS = ("up_act_kernel", "down_kernel", "sum_segments_kernel")
ITERS = 30                     # timed launches per kernel measurement
# the card run's traffic: 4 requests, 32-token prompts, 16 new tokens
REQUESTS, PROMPT_LEN, NEW_TOKENS = 4, 32, 16


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn, flush, iters: int = ITERS, warmup: int = 5):
    """Median ms of `fn()` with CUDA events, each launch after an L2 flush
    (the serving path meets every layer's weights cold: 24 layers x 33.5 MB
    do not fit the 50 MB L2). The events enclose the whole Python call:
    input checks, allocations, the launches. A CPU rehearsal times nothing:
    None."""
    import torch
    if flush.device.type != "cuda":
        fn()
        return None
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_device_ms(fn, flush, cold: bool, iters: int = ITERS):
    """Mean device ms per call of the fused FFN's three kernels, read from
    `torch.profiler` (CUDA activity): the kernels' own time, without the
    host's enqueue or the gaps between launches. `cold` flushes the L2
    before each call as `time_ms` does; warm leaves the weights in L2 from
    the call before. None on the CPU or when the profiler saw no kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if flush.device.type != "cuda":
        return None
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if cold:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and any(n in e.key for n in FFN_KERNELS))
    return total / 1e3 / iters if total > 0 else None


# -- kernel phase --------------------------------------------------------------

KERNEL_CASES = [
    # name, weight dtype, activation, gated, S, padded ids
    ("main_path_f32_relu_S32", "float32", "relu", False, 32, 0),
    ("f32_relu_S8_pad", "float32", "relu", False, 8, 2),
    ("int8_relu_S32_pad", "int8", "relu", False, 32, 4),
    ("int8_relu_S8_pad", "int8", "relu", False, 8, 3),
    ("f32_silu_gated_S32_pad", "float32", "silu", True, 32, 4),
    ("f32_silu_gated_S8_pad", "float32", "silu", True, 8, 2),
    ("int8_silu_gated_S8_pad", "int8", "silu", True, 8, 2),
    ("f32_gelu_S8_pad", "float32", "gelu", False, 8, 2),
    ("f32_relu2_S8_pad", "float32", "relu2", False, 8, 2),
]


def kernel_inputs(gen, dtype, gated, S, n_pad, B=4, D=1024, N=4096, seg=128,
                  density=0.9375):
    """Decode-shaped inputs on the card. `density` is the live share of a
    segment's neurons: 1 - 0.5**4, what a 4-row batch of random-weight ReLU
    masks covers. Padded rows get random scales too: the kernel must ignore
    them."""
    import torch
    dev = gen.device
    x = torch.randn((B, D), generator=gen, device=dev)
    n_seg = N // seg

    def weights(std):
        if dtype == "int8":
            return torch.randint(-127, 128, (N, D), generator=gen, device=dev,
                                 dtype=torch.int8)
        return torch.randn((N, D), generator=gen, device=dev) * std

    w_up, w_down = weights(D ** -0.5), weights(N ** -0.5)
    w_gate = weights(D ** -0.5) if gated else None
    perm = torch.randperm(n_seg, generator=gen, device=dev)[:S - n_pad]
    seg_ids = torch.cat([perm, torch.full((n_pad,), -1, device=dev,
                                          dtype=perm.dtype)]).to(torch.int32)
    live = torch.rand((S, seg), generator=gen, device=dev) < density
    base = (torch.rand((S, seg), generator=gen, device=dev) * 2e-4 + 3e-4
            if dtype == "int8" else torch.ones((S, seg), device=dev))
    scale_tiles = (base * live).contiguous()
    return x, w_up, w_down, seg_ids, scale_tiles, w_gate


def bound_of(x, w_up, seg_ids, scale_tiles, gated, seg=128):
    """(bound ms, what bounds it) for one call on these inputs: the bytes it
    must move (each live weight row once per matrix, x, ids, scales, out)
    over the HBM rate vs its fp32 flops over the fp32 rate."""
    n_mats = 3 if gated else 2
    B, D = x.shape
    live_rows = int(((seg_ids >= 0)[:, None] & (scale_tiles != 0)).sum())
    nbytes = (live_rows * D * n_mats * w_up.element_size()
              + 2 * x.numel() * 4 + seg_ids.numel() * 4
              + scale_tiles.numel() * 4)
    flops = 2 * B * live_rows * D * n_mats
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(dev, seed: int) -> dict:
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.sparse_ffn import sparse_ffn_segments_fused_plain
    gen = torch.Generator(device=dev).manual_seed(seed)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB
    cases = []
    for name, dtype, act, gated, S, n_pad in KERNEL_CASES:
        x, w_up, w_down, seg_ids, tiles, w_gate = kernel_inputs(
            gen, dtype, gated, S, n_pad)
        kw = dict(seg_size=128, activation=act)
        y_kernel = ops.sparse_ffn_segments_fused(x, w_up, w_down, seg_ids,
                                                 tiles, w_gate, **kw)
        y_plain = sparse_ffn_segments_fused_plain(x, w_up, w_down, seg_ids,
                                                  tiles, w_gate, **kw)
        sync(dev)
        assert y_kernel.shape == y_plain.shape == x.shape, name
        assert bool(torch.isfinite(y_kernel).all()), f"{name}: non-finite"
        err = float((y_kernel - y_plain).abs().max())
        ok = bool(torch.allclose(y_kernel, y_plain, rtol=TOL, atol=TOL))
        def kernel():
            return ops.sparse_ffn_segments_fused(
                x, w_up, w_down, seg_ids, tiles, w_gate, **kw)

        ms = time_ms(kernel, flush)
        device_cold_ms = kernel_device_ms(kernel, flush, cold=True)
        device_warm_ms = kernel_device_ms(kernel, flush, cold=False)
        plain_ms = time_ms(lambda: sparse_ffn_segments_fused_plain(
            x, w_up, w_down, seg_ids, tiles, w_gate, **kw), flush)
        bound_ms, bound_by = bound_of(x, w_up, seg_ids, tiles, gated)
        case = dict(case=name, shape=[x.shape[0], x.shape[1], w_up.shape[0], S],
                    n_pad=n_pad, max_abs_err=err, allclose=ok, ms=ms,
                    device_cold_ms=device_cold_ms,
                    device_warm_ms=device_warm_ms,
                    plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        emit({"kernel_case": case})
        assert ok, f"{name}: kernel disagrees with the plain version ({err})"
        cases.append(case)
    del flush
    return {"cases": cases}


# -- slice phase ---------------------------------------------------------------

def first_divergence(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def slice_phase(dev, seed: int, n_requests: int, prompt_len: int,
                new_tokens: int, reduced: bool) -> dict:
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serving.engine import Request, build_offload_runtime
    from repro_torch.serving.server import InferenceServer

    cfg = get_config("opt-350m", reduced=reduced)
    model = build_model(cfg, device=dev)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed))
    sync(dev)
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    runtime = build_offload_runtime(model, params,
                                    rng=np.random.default_rng(seed),
                                    calib_batch=(8, 64), device=dev)
    sync(dev)
    runtime_s = time.perf_counter() - t0
    summary = runtime.io_summary()
    assert summary["ffn_kernel"] == "segments", summary["ffn_kernel_decision"]
    rng = np.random.default_rng(seed + 1)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, prompt_len)
                    .astype(np.int32), max_new_tokens=new_tokens)
            for i in range(n_requests)]
    max_len = prompt_len + new_tokens

    # warm-up outside the measured runs: cuBLAS handles, allocator, lazy
    # module loading (resident server, a separate uid; the offload runtime's
    # caches and statistics stay untouched)
    warm = InferenceServer(model, params, max_slots=1, max_len=max_len,
                           device=dev)
    warm.submit(Request(uid=10_000, prompt=reqs[0].prompt, max_new_tokens=2))
    warm.drain()

    def serve(mode):
        server = InferenceServer(model, params, max_slots=n_requests,
                                 max_len=max_len, mode=mode,
                                 offload=runtime if mode == "offload" else None,
                                 device=dev)
        handles = [server.submit(r) for r in reqs]
        server.drain()
        sync(dev)
        st = server.stats
        decode_tokens = st.tokens_emitted - st.admitted
        return handles, st, {
            "mode": mode, "requests": n_requests,
            "prefill_s_total": st.prefill_seconds,
            "prefill_s_per_request": st.prefill_seconds / n_requests,
            "decode_steps": st.decode_steps,
            "decode_ms_per_step": 1e3 * st.decode_seconds / st.decode_steps,
            "decode_tokens_per_s": decode_tokens / st.decode_seconds}

    # the main path: counts set to 0 just before, read just after
    ops.counts.reset()
    off_handles, off_stats, off_row = serve("offload")
    launches, plain_calls = ops.counts.launches, ops.counts.plain_calls
    n_dense = runtime.n_layers
    io = runtime.io_summary()
    hist = [t for e in runtime.engines for t in e.history]
    off_row.update(
        kernel_launches=launches, plain_calls=plain_calls,
        expected_launches=off_stats.decode_steps * n_dense,
        ffn_kernel=io["ffn_kernel"],
        mean_union_fraction=float(np.mean([t.n_activated for t in hist])
                                  / cfg.d_ff),
        io_seconds_per_token_modeled=io["io_seconds_per_token"],
        cache_hit_rate=io["cache_hit_rate"])
    emit({"slice": off_row})
    res_handles, _, res_row = serve("resident")
    emit({"slice": res_row})

    for h in off_handles + res_handles:
        assert h.result.finish_reason == "length", (h.uid, h.result)
        assert len(h.result.tokens) == new_tokens
        assert all(0 <= t < cfg.vocab_size for t in h.result.tokens)
    assert io["ffn_kernel"] == "segments"
    # on the card every FFN goes to the kernel; a CPU rehearsal takes the
    # plain version instead
    taken, other = ((launches, plain_calls) if dev.type == "cuda"
                    else (plain_calls, launches))
    assert other == 0, f"launches={launches} plain_calls={plain_calls}"
    assert taken == off_stats.decode_steps * n_dense, (
        f"{taken} FFN calls, expected {off_stats.decode_steps} decode steps "
        f"x {n_dense} layers")

    mismatches = []
    for ho, hr, req in zip(off_handles, res_handles, reqs):
        t = first_divergence(ho.result.tokens, hr.result.tokens)
        if t is None:
            continue
        seq = np.concatenate([req.prompt, np.asarray(hr.result.tokens[:t],
                                                     dtype=np.int32)])
        with torch.inference_mode():
            logits = model.forward(params, {"tokens": torch.as_tensor(
                seq[None], dtype=torch.int64, device=dev)})["logits"][0, -1]
        top2 = torch.topk(logits.float(), 2).values
        margin = float(top2[0] - top2[1])
        mismatches.append({"uid": req.uid, "step": t, "margin": margin})
        emit({"token_mismatch": mismatches[-1]})
        assert margin < 1e-4, (
            f"uid {req.uid}: offload and resident tokens differ at step {t} "
            f"with a resident top-2 margin of {margin}")
    with torch.inference_mode():
        logits = model.forward(params, {"tokens": torch.as_tensor(
            reqs[0].prompt[None], dtype=torch.int64, device=dev)})["logits"]
    assert logits.shape == (1, prompt_len, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    emit({"slice_setup": {"init_params_s": init_s,
                          "build_offload_runtime_s": runtime_s,
                          "mismatches": mismatches}})
    return {"launches": launches, "model": model, "params": params,
            "runtime": runtime, "reqs": reqs, "max_len": max_len,
            "main_ms_per_step": {r["mode"]: r["decode_ms_per_step"]
                                 for r in (off_row, res_row)}}


# -- breakdown phase -------------------------------------------------------------

HOST_SPANS = ("decode_step", "probe", "read", "admit")


def breakdown_phase(dev, model, params, runtime, reqs, max_len,
                    main_ms_per_step) -> None:
    """Where a decode step's time goes, per mode, after the main path ran:
    the same requests (new uids) are admitted with one `step()`, then the
    remaining decode steps run under `torch.profiler` (CUDA activity: the
    card's kernel and copy times) and the port's own tracer (host spans of
    the offload engine). The profiler slows the host, so the idle share it
    gives against its own wall is an upper estimate; the share against the
    main path's unprofiled step time is printed beside it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs import disable_tracing, enable_tracing
    from repro_torch.serving.server import InferenceServer

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    for mode in ("offload", "resident"):
        server = InferenceServer(model, params, max_slots=len(reqs),
                                 max_len=max_len, mode=mode,
                                 offload=runtime if mode == "offload" else None,
                                 device=dev)
        for r in reqs:
            server.submit(dataclasses.replace(r, uid=r.uid + 1000))
        server.step()                 # admissions + the first decode step
        sync(dev)
        steps0 = server.stats.decode_steps
        tracer = enable_tracing()
        try:
            with profile(activities=activities) as prof:
                t0 = time.perf_counter()
                server.drain()
                sync(dev)
                wall = time.perf_counter() - t0
        finally:
            disable_tracing()
        steps = server.stats.decode_steps - steps0
        host = dict.fromkeys(HOST_SPANS, 0.0)
        for ev in tracer.events():
            if ev["ph"] == "X" and ev["name"] in host:
                host[ev["name"]] += ev["dur"] / 1e3 / steps
        device = {e.key: e.self_device_time_total / 1e3 / steps
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0}
        device_ms = sum(device.values())
        wall_ms = 1e3 * wall / steps
        emit({"breakdown": {
            "mode": mode, "decode_steps": steps,
            "wall_ms_per_step": wall_ms,
            "host_span_ms_per_step": host,
            "device_ms_per_step": device_ms if device else None,
            "device_idle_share": 1 - device_ms / wall_ms if device else None,
            "main_path_ms_per_step": main_ms_per_step[mode],
            "device_idle_share_vs_main_path": (
                1 - device_ms / main_ms_per_step[mode] if device else None),
            "ffn_kernel_device_ms_per_step": sum(
                t for k, t in device.items()
                if any(n in k for n in FFN_KERNELS)) if device else None,
            "top_device_ms_per_step": dict(sorted(
                device.items(), key=lambda kv: -kv[1])[:8])}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run the control flow on the CPU with the plain "
                         "versions and reduced opt-350m; exits 3 and prints "
                         "no result (no device numbers come from the CPU)")
    rehearsal_only = (f" (--cpu-rehearsal only; the card run serves "
                      f"{REQUESTS} requests x ({PROMPT_LEN} + {NEW_TOKENS}) "
                      f"tokens)")
    ap.add_argument("--requests", type=int, help="requests" + rehearsal_only)
    ap.add_argument("--prompt-len", type=int, help="prompt length" + rehearsal_only)
    ap.add_argument("--new-tokens", type=int, help="new tokens" + rehearsal_only)
    args = ap.parse_args(argv)
    sizes = (args.requests, args.prompt_len, args.new_tokens)
    if not args.cpu_rehearsal and any(v is not None for v in sizes):
        ap.error("--requests, --prompt-len and --new-tokens apply only with "
                 "--cpu-rehearsal")
    n_requests, prompt_len, new_tokens = (
        d if v is None else v
        for v, d in zip(sizes, (REQUESTS, PROMPT_LEN, NEW_TOKENS)))

    import torch
    if not args.cpu_rehearsal and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found; run from "
              f"a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    if args.cpu_rehearsal:      # plain versions, reduced widths, no timing
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", 0)
        emit({"device": torch.cuda.get_device_name(0),
              "nvidia_smi": nvidia_smi(), "torch": torch.__version__,
              "cuda": torch.version.cuda})
        from repro_torch.kernels import build
        t0 = time.perf_counter()
        libs = build.build_all()
        emit({"build": {"seconds": time.perf_counter() - t0,
                        "libraries": [p.name for p in libs.values()]}})

    kern = kernel_phase(dev, args.seed)
    sl = slice_phase(dev, args.seed, n_requests, prompt_len, new_tokens,
                     reduced=args.cpu_rehearsal)
    breakdown_phase(dev, sl["model"], sl["params"], sl["runtime"],
                    sl["reqs"], sl["max_len"], sl["main_ms_per_step"])
    if args.cpu_rehearsal:
        print("chip_smoke: CPU rehearsal finished (no result)", file=sys.stderr)
        return 3
    main_case = kern["cases"][0]
    emit({"kernels": [{
        "name": "sparse_ffn_segments_fused", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": sl["launches"],
        "max_abs_err": max(c["max_abs_err"] for c in kern["cases"]),
        "ms": main_case["ms"],
        "device_cold_ms": main_case["device_cold_ms"],
        "device_warm_ms": main_case["device_warm_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"], "library_ms": None}]})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
