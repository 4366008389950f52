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
  8. coact kernel: the co-activation kernel (MᵀM of a [T, N] 0/1 mask)
     against its plain version at (T, N) = (512, 4096), the offline stage's
     shape for opt-350m, (1000, 4100), ragged, and (4096, 14336),
     mistral-7b-relu's d_ff: `torch.equal` in every case (the counts are
     exact), equal to host numpy for the first two, the same bits over two
     launches; event ms, profiler device ms cold / warm, plain ms, the
     bound (bytes over 3.35 TB/s vs int8 operations over 1,979 TOPS), and
     as yardsticks `torch.mm` on float32 masks (TF32 off) and
     `torch._int_mm` on int8 masks where the shape allows.
  9. pack: the offline stage on the slice's model: `build_pack` (512
     calibration tokens as 8 x 64 from the seed, float32, format v2) into a
     temporary directory; its trace / counts / search / write seconds and
     file bytes; 24 coact launches and no plain call; the pack's placements
     equal the slice runtime's. Then the slice's requests served from the
     file (`InferenceServer(pack_path=..., verify_checksums=True)`): tokens
     and per-uid io_seconds equal the slice's in-memory offload run, fused
     FFN launches = decode steps x 24; then again under seeded recoverable
     fault plans per layer (transient, latency, corrupt): the same tokens,
     and the retries and detected corrupt extents the plans imply over the
     reads each store made (a corrupt event behind a transient on the same
     attempt is never read). A run without CRC verification is timed
     beside them.
 10. cli: `repro_torch.launch.pack` then `repro_torch.launch.serve --pack
     --verify-checksums` through `main([...])` on an int8 v2 pack of
     `--arch qwen2-7b --n-layers 4 --d-model 1024 --d-ff 4096`, served on
     the card and on the CPU: equal tokens, or a first difference at a
     top-2 logit margin below 1e-3 (judged on the CPU with the pack's
     dequantised weights).
 11. swa kernel: the sliding-window decode kernel against its plain version
     (rtol = atol = 1e-5 in float32, 2e-2 in bfloat16) on rings of the
     model's window (8192 slots) read in place: opt-350m heads (16 x 64)
     with rows at their own positions (two wrapped rings, a short one, an
     empty one, which must give 0), mistral-7b-relu's (32 query / 8 KV
     heads x 128) in float32 and bfloat16, and the reference's scalar-cur
     form; max error, event ms, profiler device ms cold / warm, plain ms,
     the byte bound (the valid slots' K/V rows and every slot's position),
     and SDPA with a boolean mask on the same rings as a yardstick.
 12. swa: the slice's opt-350m served with `swa=True` (rings of 8192 slots),
     resident then offload: five requests on four slots, prompts of 8300
     tokens (wrapped in prefill), 8180 (wraps in decode) and three of 32
     (the last admitted into a reused slot), 16 new tokens each. Checks:
     every request finishes by length; swa-kernel launches = decode steps x
     24 and no plain call, per mode; at uid 0's last token the kernel
     equals its plain version on layer 0's live rings, whose long rows
     show the wrap; the reused slot holds only its new request's
     positions; the short requests' tokens equal a contiguous-cache run's
     and offload tokens equal resident tokens (margin rule as in 4).
 13. segment kernel: the unfused segment-FFN kernel against its plain
     version (1e-4) with w_up / w_gate as transposed views of [D, N]
     weights: the serve_sparse shape (B=4, D=1024, N=4096, S=4), mistral-
     7b-relu's (D=4096, N=14336, S=16), gated silu, -1 pads with a
     repeated id, and bfloat16 weights; the same columns as 11, the bound
     being the gathered rows' bytes, and `index_select` + `torch.mm` as a
     yardstick (no single PyTorch call computes it).
 14. sparse: the slice's model and requests with `serve_sparse=True` (the
     config's 128-neuron segments and sparse_frac 0.15: 4 of 32 segments,
     seeded predictors), resident. Checks: segment-kernel launches = decode
     steps x 24, no plain call; tokens equal the same decode on the CPU
     (plain versions, same weights) unless the CPU run's top-2 logit margin
     at the first difference is below 1e-3 or its k-th and (k+1)-th
     segment scores lie within 1e-5 relative; with sparse_frac 1.0 the
     tokens equal the dense resident run's (margin rule as in 4).

Prints one JSON line per phase, then `{"kernels": [...]}`, the
`nvidia-smi` name/power line, and last `{"ok": true, "device": {...}}`.
Imports torch, numpy and the port only.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
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
INT8_OPS = 1979e12             # H100 SXM data sheet, int8 tensor cores, dense
COACT_SOURCE = "src/repro_torch/kernels/csrc/coact.cu"
COACT_REPLACES = "src/repro/kernels/coact.py:39"
COACT_KERNELS = ("coact_transpose_kernel", "coact_mma_kernel")
SWA_SOURCE = "src/repro_torch/kernels/csrc/swa_decode.cu"
SWA_REPLACES = "src/repro/kernels/swa_decode.py:103"
SWA_KERNELS = ("swa_split_kernel", "swa_combine_kernel")
SEG_SOURCE = "src/repro_torch/kernels/csrc/sparse_ffn_segments.cu"
SEG_REPLACES = "src/repro/kernels/sparse_ffn.py:203"
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
            "offload_results": [(h.uid, h.result.tokens, h.result.io_seconds)
                                for h in off_handles],
            "main_ms_per_step": {r["mode"]: r["decode_ms_per_step"]
                                 for r in (off_row, res_row)}}


def decode_margin(model, params, prompt, tokens, t: int, max_len: int,
                  swa: bool = False) -> float:
    """Top-2 logit margin of the token a contiguous B=1 resident decode
    picks at step t, after the prompt and `tokens[:t]`; the model's
    `kv_quant` decides the KV type, so an int8 run is judged on int8
    logits, and `swa` a sliding-window run on its rings."""
    import torch
    dev = model.device
    with torch.inference_mode():
        cache = model.init_cache(1, max_len, swa=swa)
        logits, cache = model.prefill(params, {"tokens": torch.as_tensor(
            prompt[None], dtype=torch.int64, device=dev)}, cache)
        for i in range(t):
            logits, cache = model.decode_step(
                params, torch.tensor([[tokens[i]]], device=dev),
                torch.tensor([len(prompt) + i], device=dev), cache)
        top2 = torch.topk(logits[0, -1].float(), 2).values
    return float(top2[0] - top2[1])


def check_tokens(model, params, reqs, handles, ref_handles, max_len,
                 what: str, ref: str, swa: bool = False):
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
                               t, max_len, swa=swa)
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
                    main_ms_per_step, path: str = "slice",
                    kernels=FFN_KERNELS, **server_kw) -> None:
    """Where a decode step's time goes, per mode of `main_ms_per_step`,
    after that path ran: the same requests (new uids) are admitted with one
    `step()`, then the remaining decode steps run under `torch.profiler`
    (CUDA activity: the card's kernel and copy times) and the port's own
    tracer (host spans of the offload engine). The profiler slows the host,
    so the idle share it gives against its own wall is an upper estimate;
    the share against the path's unprofiled step time is printed beside
    it, and the device time of the kernels named in `kernels`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs import disable_tracing, enable_tracing
    from repro_torch.serving.server import InferenceServer

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    for mode in main_ms_per_step:
        server = InferenceServer(model, params, max_slots=len(reqs),
                                 max_len=max_len, mode=mode,
                                 offload=runtime if mode == "offload" else None,
                                 device=dev, **server_kw)
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
            "path": path, "mode": mode, "decode_steps": steps,
            "wall_ms_per_step": wall_ms,
            "host_span_ms_per_step": host,
            "device_ms_per_step": device_ms if device else None,
            "device_idle_share": 1 - device_ms / wall_ms if device else None,
            "main_path_ms_per_step": main_ms_per_step[mode],
            "device_idle_share_vs_main_path": (
                1 - device_ms / main_ms_per_step[mode] if device else None),
            "kernel_device_ms_per_step": sum(
                t for k, t in device.items()
                if any(n in k for n in kernels)) if device else None,
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


# -- coact kernel phase ------------------------------------------------------------

COACT_CASES = [
    # name, T tokens, N neurons, mask density, compare with host numpy
    ("opt350m_pack_512x4096", 512, 4096, 0.5, True),
    ("ragged_1000x4100", 1000, 4100, 0.5, True),
    ("mistral7b_4096x14336", 4096, 14336, 0.5, False),
]
REHEARSAL_COACT = [(64, 128), (100, 130), (256, 512)]


def coact_bound(T, N):
    """(bound ms, what bounds it): the mask bytes read once and the f32
    [N, N] output written once over the HBM rate, vs 2·N²·T int8
    operations over the int8 tensor rate."""
    t_bytes = (T * N + 4 * N * N) / HBM_BYTES_PER_S
    t_ops = 2 * N * N * T / INT8_OPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def library_yardsticks(m, flush):
    """ms of one `torch.mm` on the float32 masks (TF32 off: exact) and of
    one `torch._int_mm` on int8 masks (None where the shape is refused).
    Yardsticks only: the port never calls either."""
    import torch
    mf = m.to(torch.float32)
    mm_ms = time_ms(lambda: torch.mm(mf.T, mf), flush)
    int_mm_ms = None
    if m.device.type == "cuda":
        mi = m.to(torch.int8)
        mit = mi.T.contiguous()
        try:
            torch._int_mm(mit, mi)
            int_mm_ms = time_ms(lambda: torch._int_mm(mit, mi), flush)
        except RuntimeError as e:          # the shape is refused
            int_mm_ms = f"refused: {str(e).splitlines()[0][:120]}"
    return mm_ms, int_mm_ms


def coact_kernel_phase(dev, seed: int, reduced: bool) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.coact import coact_accumulate_plain
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB
    cases = []
    for i, (name, T, N, density, host) in enumerate(COACT_CASES):
        if reduced:
            T, N = REHEARSAL_COACT[i]
        m = torch.rand((T, N), generator=gen, device=dev) < density
        out = ops.coact_accumulate(m)
        ref = coact_accumulate_plain(m)
        sync(dev)
        assert out.dtype == torch.float32 and tuple(out.shape) == (N, N), name
        exact = bool(torch.equal(out, ref))
        same = bool(torch.equal(out, ops.coact_accumulate(m)))
        host_equal = None
        if host:
            mn = m.cpu().numpy().astype(np.float32)
            host_equal = bool(np.array_equal(out.cpu().numpy(), mn.T @ mn))
        err = float((out - ref).abs().max())
        del ref

        def kernel():
            return ops.coact_accumulate(m)

        bound_ms, bound_by = coact_bound(T, N)
        mm_ms, int_mm_ms = library_yardsticks(m, flush)
        case = dict(
            case=name, T=T, N=N, density=density, max_abs_err=err,
            equal=exact, deterministic=same, equal_host_numpy=host_equal,
            ms=time_ms(kernel, flush),
            device_cold_ms=kernel_device_ms(kernel, flush, cold=True,
                                            names=COACT_KERNELS),
            device_warm_ms=kernel_device_ms(kernel, flush, cold=False,
                                            names=COACT_KERNELS),
            plain_ms=time_ms(lambda: coact_accumulate_plain(m), flush),
            bound_ms=bound_ms, bound_by=bound_by,
            library_mm_f32_ms=mm_ms, library_int_mm_ms=int_mm_ms)
        emit({"coact_kernel_case": case})
        assert exact, f"{name}: kernel counts differ from the plain version"
        assert same, f"{name}: two launches gave different bits"
        assert host_equal in (None, True), f"{name}: differs from host numpy"
        cases.append(case)
        del out, m
    del flush
    return {"cases": cases}


# -- swa kernel phase ----------------------------------------------------------------

SWA_TOL = {"float32": 1e-5,        # online softmax, slots in another order
           "bfloat16": 2e-2}       # one bf16 rounding of the output apart
SWA_CASES = [
    # name, KV, G, hd, dtype, scalar cur, per-row current positions for a
    # ring of W slots (-1: an empty row)
    ("opt350m_serve_f32", 16, 1, 64, "float32", False,
     lambda W: [W + 126, W + 3, 46, -1]),
    ("mistral7b_f32", 8, 4, 128, "float32", False,
     lambda W: [W + 126, W + 3, 46, -1]),
    ("mistral7b_bf16", 8, 4, 128, "bfloat16", False,
     lambda W: [W + 126, W + 3, 46, -1]),
    # the reference's form: one scalar cur, every ring full and wrapped
    ("opt350m_scalar_cur_f32", 16, 1, 64, "float32", True,
     lambda W: [W + 1808] * 4),
]
REHEARSAL_SWA_W = 128


def swa_inputs(gen, KV, G, hd, dtype, scalar, curs, W):
    """q and rings on the card; row b's ring holds its last W positions up
    to curs[b] (slot = pos % W), the rest of the ring empty (-1); random
    K/V everywhere, so the kernel must ignore what is not valid. `scalar`
    passes one 0-d cur for the batch."""
    import torch
    dev = gen.device
    B = len(curs)
    pos = torch.full((B, W), -1, dtype=torch.int32)
    for b, c in enumerate(curs):
        p = torch.arange(max(0, c - W + 1), c + 1, dtype=torch.int32)
        pos[b, (p % W).long()] = p
    dt = getattr(torch, dtype)
    k, v = (torch.randn((B, W, KV, hd), generator=gen, device=dev).to(dt)
            for _ in range(2))
    q = torch.randn((B, KV * G, hd), generator=gen, device=dev).to(dt)
    cur = (torch.tensor(curs[0], dtype=torch.int32, device=dev) if scalar
           else torch.tensor([max(c, 0) for c in curs], dtype=torch.int32,
                             device=dev))
    return q, k, v, pos.to(dev), cur


def swa_bound(q, k, pos, cur, window):
    """(bound ms, what bounds it, bytes): the K/V rows of the valid slots,
    every slot's position, cur, q and the output over the HBM rate; vs 4
    flops per (valid slot, query head, element) over the fp32 rate. Also
    the full rings' bytes."""
    B, H, hd = q.shape
    KV = k.shape[2]
    c = cur.long().reshape(-1, 1).expand(B, 1)
    p = pos.long()
    n_valid = int(((p >= 0) & (p > c - window) & (p <= c)).sum())
    row = KV * hd * k.element_size()
    nbytes = (2 * n_valid * row + pos.numel() * 4 + cur.numel() * 4
              + 2 * q.numel() * q.element_size())
    flops = 4 * n_valid * H * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes,
            2 * k.numel() * k.element_size() + pos.numel() * 4)


def swa_sdpa_yardstick(q, k, v, pos, cur, window, flush):
    """ms of one `scaled_dot_product_attention` call on the same rings with
    a boolean mask of the valid slots ([B, KV, W, hd] copies made outside
    the timing). A yardstick only: the port never calls it."""
    import torch
    import torch.nn.functional as F
    B = q.shape[0]
    kt = k.permute(0, 2, 1, 3).contiguous()
    vt = v.permute(0, 2, 1, 3).contiguous()
    c = cur.long().reshape(-1, 1).expand(B, 1)
    p = pos.long()
    mask = ((p >= 0) & (p > c - window) & (p <= c))[:, None, None]
    return time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kt, vt, attn_mask=mask, enable_gqa=True), flush)


def swa_kernel_phase(dev, seed: int, W: int) -> dict:
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.swa_decode import swa_decode_attention_plain
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB
    cases = []
    for name, KV, G, hd, dtype, scalar, cur_fn in SWA_CASES:
        curs = cur_fn(W)
        q, k, v, pos, cur = swa_inputs(gen, KV, G, hd, dtype, scalar, curs,
                                       W)
        args = (q, k, v, pos, cur)
        out = ops.swa_decode_attention(*args, window=W)
        ref = swa_decode_attention_plain(*args, window=W)
        sync(dev)
        assert out.shape == ref.shape == q.shape and out.dtype == q.dtype
        assert bool(torch.isfinite(out).all()), f"{name}: non-finite"
        err = float((out.float() - ref.float()).abs().max())
        tol = SWA_TOL[dtype]
        ok = bool(torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol))
        same = bool(torch.equal(out, ops.swa_decode_attention(*args,
                                                              window=W)))
        empty = [b for b, c in enumerate(curs) if c < 0]
        zero = all(float(out[b].float().abs().max()) == 0.0 for b in empty)

        def kernel():
            return ops.swa_decode_attention(*args, window=W)

        bound_ms, bound_by, nbytes, ring_bytes = swa_bound(q, k, pos, cur, W)
        case = dict(
            case=name, B=q.shape[0], H=q.shape[1], KV=KV, hd=hd, W=W,
            dtype=dtype, cur=cur.tolist(), empty_rows=empty,
            max_abs_err=err, tol=tol, allclose=ok, deterministic=same,
            empty_rows_zero=zero, ms=time_ms(kernel, flush),
            device_cold_ms=kernel_device_ms(kernel, flush, cold=True,
                                            names=SWA_KERNELS),
            device_warm_ms=kernel_device_ms(kernel, flush, cold=False,
                                            names=SWA_KERNELS),
            plain_ms=time_ms(lambda: swa_decode_attention_plain(
                *args, window=W), flush),
            bound_ms=bound_ms, bound_by=bound_by, bound_bytes=nbytes,
            full_ring_bytes=ring_bytes,
            full_ring_bound_ms=ring_bytes / HBM_BYTES_PER_S * 1e3,
            library_sdpa_mask_ms=(swa_sdpa_yardstick(*args, W, flush)
                                  if dev.type == "cuda" else None))
        emit({"swa_kernel_case": case})
        assert ok, f"{name}: kernel disagrees with the plain version ({err})"
        assert same, f"{name}: two launches gave different bits"
        assert zero, f"{name}: an empty row is not 0"
        cases.append(case)
    del flush
    return {"cases": cases}


# -- swa serving phase ------------------------------------------------------------

SWA_NEW_TOKENS = 16
SWA_MARGIN = 1e-4


def swa_requests(cfg, seed: int):
    """Five requests on four slots: a prompt W + 108 tokens long (its ring
    wraps in prefill), one W - 12 long (wraps during decode), three of 32
    (the last admitted into the slot the first frees)."""
    import numpy as np
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(seed + 6)
    W = cfg.sliding_window
    lens = [W + 108, W - 12, 32, 32, 32]
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new_tokens=SWA_NEW_TOKENS)
            for i, n in enumerate(lens)]


def swa_phase(dev, seed: int, model, params, runtime) -> dict:
    """`InferenceServer(swa=True)` resident, then offload: counts set to 0
    just before each run, read just after. At uid 0's last token (every
    slot live, both long rings wrapped) layer 0's ring is copied, and after
    the run the kernel is held against its plain version on that copy."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.swa_decode import swa_decode_attention_plain
    from repro_torch.serving.server import InferenceServer

    cfg = model.cfg
    W = cfg.sliding_window
    reqs = swa_requests(cfg, seed)
    max_len = max(len(r.prompt) for r in reqs) + SWA_NEW_TOKENS
    n_layers = cfg.n_layers
    rows, runs, launches = [], {}, {}
    for mode in ("resident", "offload"):
        server = InferenceServer(
            model, params, max_slots=4, max_len=max_len, swa=True, mode=mode,
            offload=runtime if mode == "offload" else None, device=dev)
        snap = {}

        def on_token(uid, tok, server=server, snap=snap):
            if len(server._handles[uid].tokens) == SWA_NEW_TOKENS:
                ring = server._cache[0]["sub_0"]
                snap.update(k=ring.k.clone(), v=ring.v.clone(),
                            pos=ring.pos.clone())

        handles = [server.submit(r, on_token=on_token if r.uid == 0 else None)
                   for r in reqs]
        ops.reset_counts()
        server.drain()
        sync(dev)
        sc = ops.counts["swa_decode"]
        st = server.stats
        row = {"mode": mode, "requests": len(reqs),
               "prompt_lens": [len(r.prompt) for r in reqs], "window": W,
               "decode_steps": st.decode_steps,
               "decode_ms_per_step": 1e3 * st.decode_seconds / st.decode_steps,
               "prefill_s_total": st.prefill_seconds,
               "swa_launches": sc.launches, "swa_plain_calls": sc.plain_calls,
               "ffn_launches": ops.counts["sparse_ffn_segments_fused"].launches}
        for h in handles:
            assert h.result.finish_reason == "length", (h.uid, h.result)
            assert len(h.result.tokens) == SWA_NEW_TOKENS
        taken, other = ((sc.launches, sc.plain_calls) if dev.type == "cuda"
                        else (sc.plain_calls, sc.launches))
        assert other == 0, row
        assert taken == st.decode_steps * n_layers > 0, row
        # the last step: the live rings, the kernel vs its plain version
        pos = snap["pos"]
        cur = pos.max(dim=1).values
        q = torch.randn((4, cfg.n_heads, cfg.head_dim),
                        generator=torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
        args = (q, snap["k"], snap["v"], pos, cur)
        out = ops.swa_decode_attention(*args, window=W)
        ref = swa_decode_attention_plain(*args, window=W)
        row.update(last_step_cur=cur.tolist(),
                   last_step_max_abs_err=float((out - ref).abs().max()),
                   reused_slot_valid_positions=None)
        assert torch.allclose(out, ref, rtol=SWA_TOL["float32"],
                              atol=SWA_TOL["float32"]), row
        assert int(cur[0]) >= W and int(cur[1]) >= W, row    # both wrapped
        # uid 4 took over uid 0's slot: its ring holds its own positions only
        h4 = handles[4]
        live = server._cache[0]["sub_0"].pos[0]
        valid = sorted(int(p) for p in live[live >= 0].tolist())
        row["reused_slot_valid_positions"] = [valid[0], valid[-1], len(valid)]
        n4 = len(reqs[4].prompt) + SWA_NEW_TOKENS - 1
        assert valid == list(range(n4)), row["reused_slot_valid_positions"]
        del snap, args, out, ref
        emit({"swa": row})
        rows.append(row)
        runs[mode] = handles
        launches[mode] = taken
    # the short requests against a contiguous-cache resident run
    short = [r for r in reqs if len(r.prompt) < W - SWA_NEW_TOKENS]
    cont = InferenceServer(model, params, max_slots=4,
                           max_len=len(short[0].prompt) + SWA_NEW_TOKENS,
                           device=dev)
    cont_handles = [cont.submit(r) for r in short]
    cont.drain()
    by_uid = {h.uid: h for h in runs["resident"]}
    mismatches = check_tokens(model, params, short,
                              [by_uid[r.uid] for r in short], cont_handles,
                              len(short[0].prompt) + SWA_NEW_TOKENS,
                              "swa resident", "contiguous resident")
    mismatches += check_tokens(model, params, reqs, runs["offload"],
                               runs["resident"], max_len, "swa offload",
                               "swa resident", swa=True)
    emit({"swa_checks": {"mismatches": mismatches}})
    breakdown_phase(dev, model, params, runtime, reqs, max_len,
                    {r["mode"]: r["decode_ms_per_step"] for r in rows},
                    path="swa", kernels=SWA_KERNELS, swa=True)
    return {"launches": launches, "rows": rows}


# -- segment kernel phase -----------------------------------------------------------

SEG_TOL = 1e-4     # f32 sums in another order (bf16 weights upcast exactly)
SEG_KERNELS = ("seg_up_partial_kernel", "seg_act_kernel", "seg_down_kernel",
               "seg_sum_kernel")
SEG_CASES = [
    # name, B, D, N, S, dtype, activation, gated, ids (None: random, no pad)
    ("serve_sparse_opt350m_f32", 4, 1024, 4096, 4, "float32", "relu", False,
     None),
    ("mistral7b_f32", 4, 4096, 14336, 16, "float32", "relu", False, None),
    ("gated_silu_f32", 4, 1024, 4096, 4, "float32", "silu", True, None),
    ("pad_and_repeat_f32", 4, 1024, 4096, 4, "float32", "relu", False,
     [7, -1, 7, 30]),
    ("serve_sparse_opt350m_bf16", 4, 1024, 4096, 4, "bfloat16", "relu", False,
     None),
]
REHEARSAL_SEG = dict(D=256, N=512)


def segment_inputs(gen, B, D, N, S, dtype, gated, ids, seg=128):
    """x and weights on the card: w_up / w_gate as transposed views of
    [D, N] storage (the model's layout), w_down [N, D] rows."""
    import torch
    dev = gen.device
    dt = getattr(torch, dtype)
    x = torch.randn((B, D), generator=gen, device=dev)
    w_up = (torch.randn((D, N), generator=gen, device=dev) * D ** -0.5
            ).to(dt).T
    w_gate = ((torch.randn((D, N), generator=gen, device=dev) * D ** -0.5
               ).to(dt).T if gated else None)
    w_down = (torch.randn((N, D), generator=gen, device=dev) * N ** -0.5
              ).to(dt)
    if ids is None:
        ids = torch.randperm(N // seg, generator=gen, device=dev)[:S]
    ids = torch.as_tensor(ids, device=dev).to(torch.int32)
    return x, w_up, w_down, ids, w_gate


def segment_bound(x, w_up, ids, gated, seg=128):
    """(bound ms, what bounds it): the gathered rows' bytes (each live id's
    segment once per matrix; a repeat is read again by the function's
    definition, but the same bytes) + x, ids and the output over the HBM
    rate, vs 2 flops per (row, weight element) over the fp32 rate."""
    n_mats = 3 if gated else 2
    B, D = x.shape
    live = sorted({int(i) for i in ids.tolist() if i >= 0})
    nbytes = (len(live) * seg * D * n_mats * w_up.element_size()
              + 2 * x.numel() * 4 + ids.numel() * 4)
    n_used = sum(1 for i in ids.tolist() if i >= 0)
    flops = 2 * B * n_used * seg * D * n_mats
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def segment_yardstick(x, w_up, w_down, ids, w_gate, activation, seg, flush):
    """ms of `index_select` of the segments' rows + two `torch.mm` (and
    the gate's) for the same function; no single PyTorch call computes it.
    A yardstick only: the port never calls it."""
    import torch
    from repro_torch.models.layers import apply_activation
    live = ids[ids >= 0].long()
    rows = (live[:, None] * seg + torch.arange(seg, device=ids.device)
            ).reshape(-1)

    def f():
        xf = x.to(w_up.dtype)
        a = apply_activation(torch.mm(xf, torch.index_select(w_up, 0, rows).T),
                             activation)
        if w_gate is not None:
            a = a * torch.mm(xf, torch.index_select(w_gate, 0, rows).T)
        return torch.mm(a, torch.index_select(w_down, 0, rows))

    return time_ms(f, flush)


def segment_kernel_phase(dev, seed: int, reduced: bool) -> dict:
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.sparse_ffn import sparse_ffn_segments_plain
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB
    cases = []
    for name, B, D, N, S, dtype, act, gated, ids in SEG_CASES:
        if reduced:
            D, N = REHEARSAL_SEG["D"], REHEARSAL_SEG["N"]
            S = min(S, N // 128)
            ids = None if ids is None else [i % (N // 128) if i >= 0 else i
                                            for i in ids]
        x, w_up, w_down, seg_ids, w_gate = segment_inputs(
            gen, B, D, N, S, dtype, gated, ids)
        kw = dict(seg_size=128, activation=act)
        args = (x, w_up, w_down, seg_ids, w_gate)
        y = ops.sparse_ffn_segments(*args, **kw)
        ref = sparse_ffn_segments_plain(*args, **kw)
        sync(dev)
        assert y.shape == ref.shape == x.shape, name
        assert bool(torch.isfinite(y).all()), f"{name}: non-finite"
        err = float((y - ref).abs().max())
        ok = bool(torch.allclose(y, ref, rtol=SEG_TOL, atol=SEG_TOL))
        same = bool(torch.equal(y, ops.sparse_ffn_segments(*args, **kw)))

        def kernel():
            return ops.sparse_ffn_segments(*args, **kw)

        bound_ms, bound_by, nbytes = segment_bound(x, w_up, seg_ids, gated)
        case = dict(
            case=name, B=B, D=D, N=N, S=S, dtype=dtype, activation=act,
            gated=gated, ids=seg_ids.tolist(), w_up_strides=list(
                w_up.stride()), max_abs_err=err, tol=SEG_TOL, allclose=ok,
            deterministic=same, ms=time_ms(kernel, flush),
            device_cold_ms=kernel_device_ms(kernel, flush, cold=True,
                                            names=SEG_KERNELS),
            device_warm_ms=kernel_device_ms(kernel, flush, cold=False,
                                            names=SEG_KERNELS),
            plain_ms=time_ms(lambda: sparse_ffn_segments_plain(*args, **kw),
                             flush),
            bound_ms=bound_ms, bound_by=bound_by, bound_bytes=nbytes,
            yardstick_index_select_mm_ms=segment_yardstick(
                *args, act, 128, flush))
        emit({"segment_kernel_case": case})
        assert ok, f"{name}: kernel disagrees with the plain version ({err})"
        assert same, f"{name}: two launches gave different bits"
        cases.append(case)
    del flush
    return {"cases": cases}


# -- sparse serving phase -----------------------------------------------------------

SPARSE_MARGIN = 1e-3
SPARSE_GAP = 1e-5


def with_predictors(params, cfg, seed: int, device):
    """`params` plus a seeded `ffn_pred` in every sublayer (all dense; drawn on
    the CPU, so every device gets the same numbers)."""
    import torch
    from repro_torch.models.layers import init_ffn_predictor
    gen = torch.Generator().manual_seed(seed)
    out = {k: v for k, v in params.items() if k != "stack"}
    out["stack"] = [{j: dict(sub, ffn_pred={
        k: v.to(device) for k, v in init_ffn_predictor(gen, cfg).items()})
        for j, sub in group.items()} for group in params["stack"]]
    return out


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def sparse_phase(dev, seed: int, model, params, reqs, max_len) -> dict:
    """`cfg.serve_sparse` resident decode of the slice's model and requests
    (counts set to 0 just before the card run, read just after), the same
    decode on the CPU (plain versions, recording each step's top-2 logit
    margins and each layer's gap between the k-th and (k+1)-th segment
    scores), then `sparse_frac=1.0` against the dense resident run."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, layers
    from repro_torch.serving.server import InferenceServer

    cfg = dataclasses.replace(model.cfg, serve_sparse=True)
    n_seg = cfg.d_ff // cfg.sparse_seg
    k_seg = max(1, int(n_seg * cfg.sparse_frac))
    smodel = build_model(cfg, device=dev)
    sparams = with_predictors(params, cfg, seed + 8, dev)

    def serve(m, p, device, **kw):
        server = InferenceServer(m, p, max_slots=len(reqs), max_len=max_len,
                                 device=device, **kw)
        handles = [server.submit(r) for r in reqs]
        ops.reset_counts()
        server.drain()
        sync(torch.device(device) if isinstance(device, str) else device)
        return handles, server.stats

    handles, st = serve(smodel, sparams, dev)
    sc = ops.counts["sparse_ffn_segments"]
    row = {"k_seg": k_seg, "n_seg": n_seg, "decode_steps": st.decode_steps,
           "decode_ms_per_step": 1e3 * st.decode_seconds / st.decode_steps,
           "segment_launches": sc.launches,
           "segment_plain_calls": sc.plain_calls}
    for h in handles:
        assert h.result.finish_reason == "length", (h.uid, h.result)
    taken, other = ((sc.launches, sc.plain_calls) if dev.type == "cuda"
                    else (sc.plain_calls, sc.launches))
    assert other == 0, row
    assert taken == st.decode_steps * cfg.n_layers > 0, row

    # the same decode on the CPU, recording margins and segment-score gaps
    cpu_model = build_model(cfg, device="cpu")
    cpu_params = to_device(sparams, "cpu")
    margins, gaps = [], []
    real_predict = layers.predict_segments

    def recording_predict(pred, x, c):
        B, T, d = x.shape
        scores = torch.relu(x.reshape(B * T, d) @ pred["w1"]) @ pred["w2"]
        top = torch.topk(scores.float().sum(0), min(k_seg + 1, n_seg)).values
        if len(top) > k_seg:
            gaps[-1] = min(gaps[-1], float((top[k_seg - 1] - top[k_seg]).abs()
                                           / top[k_seg - 1].abs()))
        return real_predict(pred, x, c)

    def recording_decode(p, tok, pos, cache):
        gaps.append(float("inf"))
        logits, cache = cpu_model.decode_step(p, tok, pos, cache)
        top2 = torch.topk(logits[:, 0].float(), 2, dim=-1).values
        margins.append((top2[:, 0] - top2[:, 1]).tolist())
        return logits, cache

    layers.predict_segments = recording_predict
    try:
        cpu_handles, _ = serve(cpu_model, cpu_params, "cpu",
                               decode_fn=recording_decode)
    finally:
        layers.predict_segments = real_predict
    mismatches = []
    for slot, (h, hc) in enumerate(zip(handles, cpu_handles)):
        t = first_divergence(h.result.tokens, hc.result.tokens)
        if t is None:
            continue
        if t == 0:      # the prefill's token: dense in both, margin rule
            margin = decode_margin(cpu_model, cpu_params, reqs[slot].prompt,
                                   hc.result.tokens, 0, max_len)
            gap = None
        else:           # token t comes out of decode step t (all admitted
            margin = margins[t - 1][slot]   # in the first step, uid = slot)
            gap = gaps[t - 1]
        mismatches.append({"uid": h.uid, "step": t, "margin": margin,
                           "segment_gap": gap})
        emit({"token_mismatch": dict(mismatches[-1], run="sparse card",
                                     reference="sparse cpu")})
        assert margin < SPARSE_MARGIN or (gap is not None
                                          and gap < SPARSE_GAP), mismatches
    row["mismatches_vs_cpu"] = mismatches

    # sparse_frac = 1.0 gathers every segment: the dense FFN
    full = build_model(dataclasses.replace(cfg, sparse_frac=1.0), device=dev)
    full_handles, _ = serve(full, sparams, dev)
    row["full_fraction_segment_launches"] = ops.counts[
        "sparse_ffn_segments"].launches
    dense_handles, _ = serve(model, params, dev)
    row["mismatches_full_vs_dense"] = check_tokens(
        model, params, reqs, full_handles, dense_handles, max_len,
        "serve_sparse frac 1.0", "dense resident")
    emit({"sparse": row})
    del cpu_params, cpu_model
    breakdown_phase(dev, smodel, sparams, None, reqs, max_len,
                    {"resident": row["decode_ms_per_step"]}, path="sparse",
                    kernels=SEG_KERNELS)
    return {"launches": taken, "row": row}


# -- pack phase ----------------------------------------------------------------------

# seeded recoverable faults per layer store, over its first reads
FAULT_READS = 8192
FAULT_RATES = dict(transient_rate=0.01, latency_rate=0.005, delay_s=1e-4,
                   corrupt_rate=0.01)


def implied_counters(plan, n_reads: int) -> dict:
    """The retries and detected corrupt extents a recoverable plan implies
    over a store's first `n_reads` logical reads (every event applies to
    the first attempt only): a read with a transient or a corrupt event
    costs one retry; a corrupt event is detected only where no transient
    event on the same attempt raised before its bytes were read."""
    retries = corrupt = 0
    for i in range(n_reads):
        kinds = {ev.kind for ev in plan.events_at(i)}
        retries += bool(kinds & {"transient", "corrupt"})
        corrupt += "corrupt" in kinds and "transient" not in kinds
    return {"retries": retries, "corrupt_extents": corrupt}


def pack_phase(dev, seed: int, sl: dict, tmp: str) -> dict:
    """The offline stage into a NeuronPack, then the slice's requests
    served from it, clean and under recoverable faults. The build and the
    clean pack-served run are the paths under test: counts set to 0 just
    before each, read just after."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import OffloadedFFNRuntime
    from repro_torch.serving.server import InferenceServer
    from repro_torch.store import NeuronPack, build_pack, seeded_layer_plans

    model, params, runtime = sl["model"], sl["params"], sl["runtime"]
    reqs, max_len = sl["reqs"], sl["max_len"]
    n_layers = runtime.n_layers
    path = os.path.join(tmp, "opt-350m.npack")
    ops.reset_counts()
    report = build_pack(model, params, path, calib_tokens=512, calib_batch=8,
                        calib_seqlen=64, seed=seed, device=dev)
    sync(dev)
    coact = ops.counts["coact_accumulate"]
    launches, plain_calls = coact.launches, coact.plain_calls
    pack = NeuronPack(path)
    same_placements = [bool(np.array_equal(pack.placement(l).placement,
                                           e.placement.placement))
                       for l, e in enumerate(runtime.engines)]
    build_row = {
        "file_bytes": report.file_bytes, "n_layers": report.n_layers,
        "n_neurons": report.n_neurons, "bundle_width": report.bundle_width,
        "version": pack.version, "tokens_traced": report.tokens_traced,
        "build_s": report.build_seconds, "trace_s": report.trace_seconds,
        "counts_s": report.counts_seconds, "search_s": report.search_seconds,
        "write_s": report.write_seconds, "coact_launches": launches,
        "coact_plain_calls": plain_calls,
        "placements_equal_runtime": all(same_placements)}
    emit({"pack_build": build_row})
    taken, other = ((launches, plain_calls) if dev.type == "cuda"
                    else (plain_calls, launches))
    assert other == 0 and taken == n_layers, build_row
    assert all(same_placements), same_placements

    def serve(**kw):
        server = InferenceServer(model, params, max_slots=len(reqs),
                                 max_len=max_len, mode="offload", device=dev,
                                 **kw)
        handles = [server.submit(r) for r in reqs]
        server.drain()
        sync(dev)
        io = server.offload.io_summary()
        server.close()
        return handles, server.stats, io

    handles_nv, st_nv, io_nv = serve(pack_path=path)
    ops.reset_counts()
    handles, st, io = serve(pack_path=path, verify_checksums=True)
    ffn = ops.counts["sparse_ffn_segments_fused"]
    row = {"run": "pack_clean", "decode_steps": st.decode_steps,
           "decode_ms_per_step": 1e3 * st.decode_seconds / st.decode_steps,
           "in_memory_decode_ms_per_step": sl["main_ms_per_step"]["offload"],
           "ffn_launches": ffn.launches, "ffn_plain_calls": ffn.plain_calls,
           "coact_launches": ops.counts["coact_accumulate"].launches,
           "io_seconds_per_token_modeled": io["io_seconds_per_token"],
           "measured_file_seconds_per_token":
               io.get("measured_file_seconds_per_token"),
           "measured_extents_total": io.get("measured_extents_total"),
           "measured_bytes_total": io.get("measured_bytes_total"),
           "retries": io["retries"], "corrupt_extents": io["corrupt_extents"],
           "no_verify_decode_ms_per_step":
               1e3 * st_nv.decode_seconds / st_nv.decode_steps,
           "no_verify_measured_file_seconds_per_token":
               io_nv.get("measured_file_seconds_per_token")}
    ffn_taken, ffn_other = ((ffn.launches, ffn.plain_calls)
                            if dev.type == "cuda"
                            else (ffn.plain_calls, ffn.launches))
    emit({"pack_serve": row})
    assert ffn_other == 0 and ffn_taken == st.decode_steps * n_layers > 0, row
    assert io["ffn_kernel"] == "segments", io["ffn_kernel_decision"]
    for run in (handles, handles_nv):
        for h, (uid, tokens, io_s) in zip(run, sl["offload_results"]):
            assert h.uid == uid and h.result.finish_reason == "length"
            assert h.result.tokens == tokens, (uid, h.result.tokens, tokens)
            assert h.result.io_seconds == io_s, (uid, h.result.io_seconds,
                                                 io_s)

    plans = seeded_layer_plans(seed, n_layers, FAULT_READS, **FAULT_RATES)
    rt = OffloadedFFNRuntime.from_pack(model.cfg, path, verify_checksums=True,
                                       fault_plans=plans, device=dev)
    with rt:
        chandles, cst, cio = serve(offload=rt)
        reads = [sum(t.io.measured_ops for t in e.history)
                 for e in rt.engines]
    injected = {k: sum(p.injected[k] for p in plans)
                for k in ("transient", "latency", "corrupt")}
    implied = [implied_counters(p, n) for p, n in zip(plans, reads)]
    crow = {"run": "pack_faults", "decode_steps": cst.decode_steps,
            "decode_ms_per_step": 1e3 * cst.decode_seconds / cst.decode_steps,
            "reads": sum(reads), "injected": injected,
            "retries": cio["retries"], "corrupt_extents": cio["corrupt_extents"],
            "implied": {k: sum(d[k] for d in implied)
                        for k in ("retries", "corrupt_extents")},
            "tokens_equal_clean": [h.result.tokens for h in chandles]
            == [h.result.tokens for h in handles]}
    emit({"pack_serve": crow})
    assert crow["tokens_equal_clean"], crow
    assert max(reads) <= FAULT_READS, crow
    assert injected["transient"] + injected["corrupt"] > 0, crow
    assert cio["retries"] == crow["implied"]["retries"], crow
    assert cio["corrupt_extents"] == crow["implied"]["corrupt_extents"], crow
    del pack
    os.remove(path)
    return {"launches": launches, "build": build_row, "serve": row,
            "faults": crow}


# -- cli phase -------------------------------------------------------------------------

CLI_GEOMETRY = ["--arch", "qwen2-7b", "--n-layers", "4", "--d-model", "1024",
                "--d-ff", "4096"]
REHEARSAL_CLI_GEOMETRY = ["--arch", "qwen2-7b", "--n-layers", "2",
                          "--d-model", "64", "--d-ff", "256"]
CLI_SERVE = ["--requests", "4", "--prompt-len", "16", "--new-tokens", "8"]
CLI_MARGIN = 1e-3


def pack_weights(params, pack, cfg):
    """`params` with every dense FFN's weights replaced by the pack's
    (dequantised) bundles: the weights the offload path computes with."""
    import torch
    from repro_torch.models import transformer
    P = transformer.stack_period(cfg)
    ffns = cfg.ffn_kinds()
    d = cfg.d_model
    out = {k: v for k, v in params.items() if k != "stack"}
    out["stack"] = []
    layer = 0
    for group in params["stack"]:
        group = {k: dict(v) for k, v in group.items()}
        for j in range(P):
            if ffns[j] != "dense":
                continue
            b = torch.from_numpy(pack.logical_bundles(layer))
            ffn = dict(group[f"sub_{j}"]["ffn"])
            mats = b.split(d, dim=1)
            if "w_gate" in ffn:
                ffn["w_gate"] = mats[0].T.contiguous()
                mats = mats[1:]
            ffn["w_up"], ffn["w_down"] = mats[0].T.contiguous(), mats[1]
            group[f"sub_{j}"]["ffn"] = ffn
            layer += 1
        out["stack"].append(group)
    return out


def cli_phase(dev, seed: int, tmp: str, reduced: bool) -> dict:
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import pack as pack_cli
    from repro_torch.launch import seeded_model
    from repro_torch.launch import serve as serve_cli
    from repro_torch.store import NeuronPack

    geom = (REHEARSAL_CLI_GEOMETRY if reduced else CLI_GEOMETRY) + [
        "--seed", str(seed)]
    out = os.path.join(tmp, "qwen2-7b-int8.npack")
    ops.reset_counts()
    t0 = time.perf_counter()
    report = pack_cli.main(geom + ["--out", out, "--quantize", "int8",
                                   "--pack-version", "2", "--device", str(dev)])
    pack_s = time.perf_counter() - t0
    coact = ops.counts["coact_accumulate"]
    args = geom + ["--mode", "offload", "--pack", out, "--verify-checksums"
                   ] + CLI_SERVE
    t0 = time.perf_counter()
    card = serve_cli.main(args + ["--device", str(dev)])
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = serve_cli.main(args + ["--device", "cpu"])
    cpu_s = time.perf_counter() - t0
    row = {"pack": {"file_bytes": report.file_bytes,
                    "quantized": report.quantized, "seconds": pack_s,
                    "trace_s": report.trace_seconds,
                    "counts_s": report.counts_seconds,
                    "search_s": report.search_seconds,
                    "write_s": report.write_seconds,
                    "coact_launches": coact.launches,
                    "coact_plain_calls": coact.plain_calls},
           "serve_seconds": {"device": card_s, "cpu": cpu_s},
           "mismatches": []}
    assert report.quantized and NeuronPack(out).version == 2
    n_layers = int(geom[geom.index("--n-layers") + 1])
    assert (coact.launches if dev.type == "cuda" else coact.plain_calls) \
        == n_layers, row
    for r in card + cpu:
        assert r.finish_reason == "length" and len(r.tokens) == 8, r
    # the serve CLI's prompts: default_rng(seed), one per request, in order
    cfg = get_config("qwen2-7b", reduced=True, vocab_size=512,
                     activation="relu", **{
                         k.lstrip("-").replace("-", "_"): int(v)
                         for k, v in zip(geom[2:6:2], geom[3:7:2])})
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
               for _ in card]
    margin_model = None
    for a, b, prompt in zip(card, cpu, prompts):
        t = first_divergence(a.tokens, b.tokens)
        if t is None:
            continue
        if margin_model is None:
            model, params = seeded_model(cfg, seed, "cpu")
            margin_model = (model, pack_weights(params, NeuronPack(out), cfg))
        margin = decode_margin(*margin_model, prompt, b.tokens, t, 16 + 8 + 8)
        row["mismatches"].append({"uid": a.uid, "step": t, "margin": margin})
        assert margin < CLI_MARGIN, row
    emit({"cli": row})
    os.remove(out)
    return row


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
    ckern = coact_kernel_phase(dev, args.seed, reduced=args.cpu_rehearsal)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as tmp:
        pk = pack_phase(dev, args.seed, sl, tmp)
        cli_phase(dev, args.seed, tmp, reduced=args.cpu_rehearsal)
    skern = swa_kernel_phase(dev, args.seed, W=(
        REHEARSAL_SWA_W if args.cpu_rehearsal
        else sl["model"].cfg.sliding_window))
    sw = swa_phase(dev, args.seed, sl["model"], sl["params"], sl["runtime"])
    gkern = segment_kernel_phase(dev, args.seed, reduced=args.cpu_rehearsal)
    sp = sparse_phase(dev, args.seed, sl["model"], sl["params"], sl["reqs"],
                      sl["max_len"])
    if args.cpu_rehearsal:
        print("chip_smoke: CPU rehearsal finished (no result)", file=sys.stderr)
        return 3
    main_case = kern["cases"][0]
    paged_case = pkern["cases"][0]
    coact_case = ckern["cases"][0]
    swa_case = skern["cases"][0]
    seg_case = gkern["cases"][0]
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
        "bound_by": paged_case["bound_by"], "library_ms": None}, {
        # the offline stage's shape (T = 512, N = 4096); every case above
        "name": "coact_accumulate", "route": "cuda",
        "source": COACT_SOURCE, "replaces": COACT_REPLACES,
        "launches": pk["launches"],
        "max_abs_err": max(c["max_abs_err"] for c in ckern["cases"]),
        "ms": coact_case["ms"],
        "device_cold_ms": coact_case["device_cold_ms"],
        "device_warm_ms": coact_case["device_warm_ms"],
        "plain_ms": coact_case["plain_ms"],
        "bound_ms": coact_case["bound_ms"],
        "bound_by": coact_case["bound_by"],
        "library_ms": coact_case["library_mm_f32_ms"],
        "library_int_mm_ms": coact_case["library_int_mm_ms"]}, {
        # the swa serving shape's float32 case (opt-350m heads, W = 8192,
        # rows wrapped / short / empty); every case's line is above
        "name": "swa_decode", "route": "cuda",
        "source": SWA_SOURCE, "replaces": SWA_REPLACES,
        "launches": sw["launches"]["resident"],
        "launches_by_run": sw["launches"],
        "max_abs_err": max(c["max_abs_err"] for c in skern["cases"]),
        "ms": swa_case["ms"],
        "device_cold_ms": swa_case["device_cold_ms"],
        "device_warm_ms": swa_case["device_warm_ms"],
        "plain_ms": swa_case["plain_ms"],
        "bound_ms": swa_case["bound_ms"],
        "bound_by": swa_case["bound_by"],
        "library_ms": swa_case["library_sdpa_mask_ms"]}, {
        # the serve_sparse shape (B=4, D=1024, N=4096, S=4, w_up a view)
        "name": "sparse_ffn_segments", "route": "cuda",
        "source": SEG_SOURCE, "replaces": SEG_REPLACES,
        "launches": sp["launches"],
        "max_abs_err": max(c["max_abs_err"] for c in gkern["cases"]),
        "ms": seg_case["ms"],
        "device_cold_ms": seg_case["device_cold_ms"],
        "device_warm_ms": seg_case["device_warm_ms"],
        "plain_ms": seg_case["plain_ms"],
        "bound_ms": seg_case["bound_ms"],
        "bound_by": seg_case["bound_by"], "library_ms": None,
        "yardstick_index_select_mm_ms":
            seg_case["yardstick_index_select_mm_ms"]}]})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
