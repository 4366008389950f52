#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py            # needs one CUDA card

Phases, in order (any failure raises and the script exits non-zero):
  1. device: the card's name and `nvidia-smi` name + power limit.
  2. build: compile every CUDA source of the port with nvcc (sm_90a), one
     process per source, all started together.
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
  6. paged kernel: the paged-decode attention kernel against its plain
     version (rtol = atol = 1e-5 in float32) at opt-350m's head geometry
     (16 x 64) at the serving shape (B=4, page 16, rows at 9..55) and at
     long context (4096 positions, 256 pages a row), and at
     mistral-7b-relu's (32 query / 8 KV heads x 128) at long context,
     float32 and int8, with rows at different positions and a row whose
     table is all null page; max error, event ms, profiler device ms cold
     and warm, plain ms, the byte bound, and SDPA's time on the equivalent
     contiguous K/V as a yardstick (no PyTorch call reads a page table).
  7. paged: the slice's opt-350m and offload runtime served paged
     (page_size 16, 16 pages, 4 slots, four 40-token prompts: a random one,
     the same again (a live fork of its partial page), its first 32 tokens +
     8 others (a prefix hit on two full pages), another random one; 16 new
     tokens), offload and resident in float32 and resident in int8, each
     beside its contiguous run. Checks: every request finishes by length,
     paged tokens equal contiguous tokens (margin rule as in 4), the paged
     kernel launched decode_steps x 24 times and its plain version never
     ran, prefix_hits >= 1, cow_copies >= 1, preemptions == 0, and after
     `clear_prefix_cache()` the pool checks and is wholly free.

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
PAGED_TOL = 1e-5               # fp32; online softmax, rows in another order
PAGED_SOURCE = "src/repro_torch/kernels/csrc/paged_decode.cu"
PAGED_REPLACES = "src/repro/kernels/swa_decode.py:211"
PAGED_KERNELS = ("paged_decode_kernel",)
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


def kernel_device_ms(fn, flush, cold: bool, names=FFN_KERNELS,
                     iters: int = ITERS):
    """Mean device ms per call of the kernels whose names contain one of
    `names` (the fused FFN's three by default), read from `torch.profiler`
    (CUDA activity): the kernels' own time, without the host's enqueue or
    the gaps between launches. `cold` flushes the L2 before each call as
    `time_ms` does; warm leaves the inputs in L2 from the call before. None
    on the CPU or when the profiler saw no kernel."""
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
                and any(n in e.key for n in names))
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
    ops.reset_counts()
    off_handles, off_stats, off_row = serve("offload")
    ffn = ops.counts["sparse_ffn_segments_fused"]
    launches, plain_calls = ffn.launches, ffn.plain_calls
    assert ops.counts["paged_decode"].launches == 0
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

    mismatches = check_tokens(model, params, reqs, off_handles, res_handles,
                              max_len, "offload", "resident")
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


def decode_margin(model, params, prompt, tokens, t: int, max_len: int) -> float:
    """Top-2 logit margin of the token a contiguous B=1 resident decode
    picks at step t, after the prompt and `tokens[:t]`; the model's
    `kv_quant` decides the KV type, so an int8 run is judged on int8
    logits."""
    import torch
    dev = model.device
    with torch.inference_mode():
        cache = model.init_cache(1, max_len)
        logits, cache = model.prefill(params, {"tokens": torch.as_tensor(
            prompt[None], dtype=torch.int64, device=dev)}, cache)
        for i in range(t):
            logits, cache = model.decode_step(
                params, torch.tensor([[tokens[i]]], device=dev),
                torch.tensor([len(prompt) + i], device=dev), cache)
        top2 = torch.topk(logits[0, -1].float(), 2).values
    return float(top2[0] - top2[1])


def check_tokens(model, params, reqs, handles, ref_handles, max_len,
                 what: str, ref: str):
    """Assert `handles` emitted `ref_handles`' tokens, accepting a
    difference only where the reference's choice had a top-2 logit margin
    below 1e-4 (a near tie that another summation order may flip). Returns
    the accepted mismatches."""
    mismatches = []
    for h, hr, req in zip(handles, ref_handles, reqs):
        t = first_divergence(h.result.tokens, hr.result.tokens)
        if t is None:
            continue
        margin = decode_margin(model, params, req.prompt, hr.result.tokens,
                               t, max_len)
        mismatches.append({"uid": req.uid, "step": t, "margin": margin,
                           "run": what, "reference": ref})
        emit({"token_mismatch": mismatches[-1]})
        assert margin < 1e-4, (
            f"uid {req.uid}: {what} and {ref} tokens differ at step {t} "
            f"with a top-2 margin of {margin}")
    return mismatches


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


# -- paged kernel phase ------------------------------------------------------------

NULL = -1          # a `cur` entry's marker for a row whose table is all null page
PAGED_CASES = [
    # name, KV, G, hd, page size, per-row current positions (a row at
    # (NULL, c) has an all-null table and reads c + 1 null-page rows), int8
    ("opt350m_serve_f32", 16, 1, 64, 16, [54, 40, 9, (NULL, 17)], False),
    ("opt350m_serve_int8", 16, 1, 64, 16, [54, 40, 9, (NULL, 17)], True),
    ("opt350m_long_f32", 16, 1, 64, 16, [4095] * 4, False),
    ("opt350m_long_int8", 16, 1, 64, 16, [4095] * 4, True),
    ("mistral7b_long_f32", 8, 4, 128, 16, [4095] * 4, False),
    ("mistral7b_long_int8", 8, 4, 128, 16, [4095] * 4, True),
    ("mistral7b_mixed_f32", 8, 4, 128, 16, [4095, 1500, 7, (NULL, 300)], False),
    ("mistral7b_mixed_int8", 8, 4, 128, 16, [4095, 1500, 7, (NULL, 300)], True),
]
REHEARSAL_LONG = 128    # the CPU rehearsal cuts 4096-position rows to this


def paged_inputs(gen, KV, G, hd, page, rows, int8):
    """A shuffled page arena on the card for rows at `rows` (see
    PAGED_CASES): row b owns pages for slots 0..cur[b] at random physical
    pages, the rest of its table points at the null page (random contents
    too), as do the two spare pages. int8 arenas get bf16 scales around
    1/127."""
    import torch
    dev = gen.device
    cur = [r[1] if isinstance(r, tuple) else r for r in rows]
    owned = [0 if isinstance(r, tuple) else r // page + 1 for r in rows]
    max_pages = max(c // page + 1 for c in cur)
    n_pages = sum(owned) + 2
    perm = torch.randperm(n_pages, generator=gen, device=dev).to(torch.int32)
    table = torch.full((len(rows), max_pages), n_pages, dtype=torch.int32,
                       device=dev)
    i = 0
    for b, n in enumerate(owned):
        table[b, :n] = perm[i:i + n]
        i += n
    shape = (n_pages + 1, page, KV, hd)
    if int8:
        k, v = (torch.randint(-127, 128, shape, generator=gen, device=dev,
                              dtype=torch.int8) for _ in range(2))
        ks, vs = ((torch.rand(shape[:3], generator=gen, device=dev) + 0.5)
                  .div(127).to(torch.bfloat16) for _ in range(2))
    else:
        k, v = (torch.randn(shape, generator=gen, device=dev)
                for _ in range(2))
        ks = vs = None
    q = torch.randn((len(rows), KV * G, hd), generator=gen, device=dev)
    cur_t = torch.tensor(cur, dtype=torch.int32, device=dev)
    return q, k, v, table, cur_t, ks, vs


def paged_bound(q, k, table, cur, page):
    """(bound ms, what bounds it): the K/V rows (and their scales) at slots
    0..cur[b] of every row, the page-table entries that name them, cur, q
    and the output, over the HBM rate; vs 4 flops per (row, query head,
    element) over the fp32 rate."""
    B, H, hd = q.shape
    KV = k.shape[2]
    rows = [int(c) + 1 for c in cur.tolist()]
    row_bytes = KV * hd * k.element_size() + (KV * 2 if k.element_size() == 1
                                              else 0)
    nbytes = (2 * sum(rows) * row_bytes
              + 4 * sum(-(-r // page) for r in rows) + 4 * B
              + 2 * q.numel() * 4)
    flops = 4 * sum(rows) * H * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def sdpa_yardstick(q, k, v, table, cur, ks, vs, flush):
    """ms of one `scaled_dot_product_attention` call on the same rows laid
    out contiguously ([B, KV, S, hd] float32, dequantised, GQA), masked
    causally where rows stop short of S. A yardstick for later PRs only:
    the port never calls it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models.kvcache import gather_pages
    B, H, hd = q.shape
    kc, vc = gather_pages(k, table), gather_pages(v, table)
    if ks is not None:
        kc = kc.float() * gather_pages(ks, table)[..., None].float()
        vc = vc.float() * gather_pages(vs, table)[..., None].float()
    S = kc.shape[1]
    kc = kc.permute(0, 2, 1, 3).contiguous()
    vc = vc.permute(0, 2, 1, 3).contiguous()
    q4 = q[:, :, None]
    mask = None
    if int(cur.min()) + 1 < S:
        mask = (torch.arange(S, device=q.device)[None]
                <= cur.long()[:, None])[:, None, None]
    return time_ms(lambda: F.scaled_dot_product_attention(
        q4, kc, vc, attn_mask=mask, enable_gqa=True), flush)


def paged_kernel_phase(dev, seed: int, reduced: bool) -> dict:
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_decode import paged_decode_attention_plain
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB
    cases = []
    for name, KV, G, hd, page, rows, int8 in PAGED_CASES:
        if reduced:
            rows = [min(r, REHEARSAL_LONG - 1) if isinstance(r, int)
                    else (NULL, min(r[1], REHEARSAL_LONG - 1)) for r in rows]
        q, k, v, table, cur, ks, vs = paged_inputs(gen, KV, G, hd, page,
                                                   rows, int8)
        args = (q, k, v, table, cur, ks, vs)
        out = ops.paged_decode_attention(*args)
        ref = paged_decode_attention_plain(*args)
        sync(dev)
        assert out.shape == ref.shape == q.shape, name
        assert bool(torch.isfinite(out).all()), f"{name}: non-finite"
        err = float((out - ref).abs().max())
        ok = bool(torch.allclose(out, ref, rtol=PAGED_TOL, atol=PAGED_TOL))
        same = bool(torch.equal(out, ops.paged_decode_attention(*args)))

        def kernel():
            return ops.paged_decode_attention(*args)

        bound_ms, bound_by, nbytes = paged_bound(q, k, table, cur, page)
        case = dict(
            case=name, B=q.shape[0], H=q.shape[1], KV=KV, hd=hd, page=page,
            cur=cur.tolist(), null_rows=[b for b, r in enumerate(rows)
                                         if isinstance(r, tuple)],
            arena_dtype=str(k.dtype).replace("torch.", ""),
            max_abs_err=err, allclose=ok, deterministic=same,
            ms=time_ms(kernel, flush),
            device_cold_ms=kernel_device_ms(kernel, flush, cold=True,
                                            names=PAGED_KERNELS),
            device_warm_ms=kernel_device_ms(kernel, flush, cold=False,
                                            names=PAGED_KERNELS),
            plain_ms=time_ms(lambda: paged_decode_attention_plain(*args),
                             flush),
            bound_ms=bound_ms, bound_by=bound_by, bound_bytes=nbytes,
            sdpa_contiguous_ms=(sdpa_yardstick(*args, flush)
                                if dev.type == "cuda" else None))
        emit({"paged_kernel_case": case})
        assert ok, f"{name}: kernel disagrees with the plain version ({err})"
        assert same, f"{name}: two launches gave different bits"
        cases.append(case)
    del flush
    return {"cases": cases}


# -- paged serving phase ------------------------------------------------------------

PAGE_SIZE, NUM_PAGES = 16, 16
PAGED_PROMPT_LEN, PAGED_NEW_TOKENS = 40, 16


def paged_requests(cfg, seed: int):
    """uid 0 random; uid 1 its exact copy (a live fork sharing uid 0's
    partial third page); uid 2 its first 32 tokens + 8 others (a registry
    hit on two full pages); uid 3 random."""
    import numpy as np
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(seed + 2)
    V, T = cfg.vocab_size, PAGED_PROMPT_LEN
    p0 = rng.integers(0, V, T).astype(np.int32)
    p2 = np.concatenate([p0[:32], rng.integers(0, V, T - 32)]).astype(np.int32)
    assert not np.array_equal(p2, p0)
    prompts = [p0, p0.copy(), p2, rng.integers(0, V, T).astype(np.int32)]
    return [Request(uid=i, prompt=p, max_new_tokens=PAGED_NEW_TOKENS)
            for i, p in enumerate(prompts)]


def paged_phase(dev, seed: int, model, params, runtime, reduced: bool) -> dict:
    """Each (mode, KV type) served contiguous, then paged; the paged run
    is the path under test: counts set to 0 just before it, read just
    after."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serving.server import InferenceServer

    cfg = model.cfg
    qmodel = build_model(get_config("opt-350m", reduced=reduced,
                                    kv_quant=True), device=dev)
    reqs = paged_requests(cfg, seed)
    max_len = PAGED_PROMPT_LEN + PAGED_NEW_TOKENS
    n_layers = cfg.n_layers

    def serve(m, mode, paged):
        server = InferenceServer(
            m, params, max_slots=len(reqs), max_len=max_len, mode=mode,
            offload=runtime if mode == "offload" else None, device=dev,
            **(dict(page_size=PAGE_SIZE, num_pages=NUM_PAGES) if paged
               else {}))
        handles = [server.submit(r) for r in reqs]
        server.drain()
        sync(dev)
        return handles, server

    launches = {}
    for mode, m in (("offload", model), ("resident", model),
                    ("resident", qmodel)):
        kv = "int8" if m.cfg.kv_quant else "float32"
        for paged in (False, True):
            ops.reset_counts()
            handles, server = serve(m, mode, paged)
            pc = ops.counts["paged_decode"]
            ffn = ops.counts["sparse_ffn_segments_fused"]
            st = server.stats
            row = {"mode": mode, "kv": kv,
                   "layout": "paged" if paged else "contiguous",
                   "decode_steps": st.decode_steps,
                   "decode_ms_per_step": 1e3 * st.decode_seconds
                   / st.decode_steps,
                   "decode_tokens_per_s": (st.tokens_emitted - st.admitted)
                   / st.decode_seconds,
                   "prefill_s_total": st.prefill_seconds,
                   "paged_launches": pc.launches,
                   "paged_plain_calls": pc.plain_calls,
                   "ffn_launches": ffn.launches,
                   "ffn_plain_calls": ffn.plain_calls}
            for h in handles:
                assert h.result.finish_reason == "length", (h.uid, h.result)
                assert len(h.result.tokens) == PAGED_NEW_TOKENS
            # the route: on the card the kernel, on the CPU the plain version
            taken, other = ((pc.launches, pc.plain_calls)
                            if dev.type == "cuda"
                            else (pc.plain_calls, pc.launches))
            if not paged:
                assert pc.launches == pc.plain_calls == 0, row
                cont = handles
                emit({"paged": row})
                continue
            assert other == 0, row
            assert taken == st.decode_steps * n_layers > 0, row
            pool = server._pool
            row.update(page_summary=server.page_summary())
            assert st.prefix_hits >= 1 and st.cow_copies >= 1, row
            assert st.preemptions == 0, row
            pool.clear_prefix_cache()
            pool.check()
            assert pool.n_free == pool.num_pages, pool.summary()
            row["reclaimed"] = True
            row["mismatches"] = check_tokens(
                m, params, reqs, handles, cont, max_len,
                f"paged {mode} {kv}", f"contiguous {mode} {kv}")
            emit({"paged": row})
            launches[f"{mode}_{kv}"] = taken
    return {"launches": launches}


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
    pkern = paged_kernel_phase(dev, args.seed, reduced=args.cpu_rehearsal)
    pg = paged_phase(dev, args.seed, sl["model"], sl["params"], sl["runtime"],
                     reduced=args.cpu_rehearsal)
    if args.cpu_rehearsal:
        print("chip_smoke: CPU rehearsal finished (no result)", file=sys.stderr)
        return 3
    main_case = kern["cases"][0]
    paged_case = pkern["cases"][0]
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
        "bound_by": main_case["bound_by"], "library_ms": None}, {
        # the serving shape's float32 case; every case's line is above
        "name": "paged_decode", "route": "cuda",
        "source": PAGED_SOURCE, "replaces": PAGED_REPLACES,
        "launches": pg["launches"]["offload_float32"],
        "launches_by_run": pg["launches"],
        "max_abs_err": max(c["max_abs_err"] for c in pkern["cases"]),
        "ms": paged_case["ms"],
        "device_cold_ms": paged_case["device_cold_ms"],
        "device_warm_ms": paged_case["device_warm_ms"],
        "plain_ms": paged_case["plain_ms"],
        "bound_ms": paged_case["bound_ms"],
        "bound_by": paged_case["bound_by"], "library_ms": None}]})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
