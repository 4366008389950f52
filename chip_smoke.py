#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py            # needs one CUDA card

Phases, in order (any failure raises and the script exits non-zero):
  1. device: the card's name and `nvidia-smi` name + power limit.
  2. build: compile every CUDA source of the port with nvcc (sm_90a), one
     process per source, all started together.
  3. kernel: the fused segment-FFN kernel against its plain PyTorch version
     on the card (rtol = atol = 1e-4, the same bits over two launches), f32
     / int8 / bf16 rows, gated, with padded segment ids, and mistral-7b-
     relu's widths with all 112 segments in bf16; max error, the launch
     plan, kernel and plain times (CUDA events around the Python call, L2
     flushed between launches, median of 30), the kernel's own device time
     from `torch.profiler` with a cold and a warm L2, the bound (bytes over
     3.35 TB/s vs fp32 flops over 67 TFLOP/s, the H100 SXM data-sheet
     rates), and `index_select` + `torch.mm` as a yardstick (not one call).
  4. slice: full-width opt-350m (24 layers, d_model 1024, d_ff 4096, vocab
     50272, random weights from --seed; no depth cut; its runtime also
     trains the lookahead predictors phase 9b uses) served through
     `InferenceServer(mode="offload")` — 4 requests, 32-token prompts, 16
     new tokens — then the same requests resident. Checks: every request
     finishes by length, the resolved FFN path is the segment kernel, the
     kernel launched decode_steps x 24 times and the plain version never ran
     during offload decode, and offload tokens equal resident tokens (a
     difference is accepted only at a resident top-2 logit margin < 1e-4).
     Then the model cast to bf16 (params, compute, flash bundles) served
     offload from its own `build_offload_runtime`: fused launches =
     decode_steps x 24, no plain call, the kernel = its plain version on
     layer 0's last inputs (1e-4), and the tokens of the same bf16 offload
     decode on the CPU (plain versions, same weights and placements) unless
     the CPU run's top-2 logit margin at the first difference is below
     1e-3. (Not against the bf16 resident run: offload makes the residual
     stream float32 after the first FFN, as the reference does.)
  5. breakdown: the slice's requests once more per mode (and the bf16
     offload run), their decode steps
     under `torch.profiler` and the port's tracer: wall, device time and
     idle share per step, the FFN kernel's device time, the top device
     kernels, and the offload engine's host spans (probe / read / admit).
  6. paged kernel: the paged-decode attention kernel against its plain
     version (rtol = atol = 1e-5 in float32 and int8, 2e-2 on bf16
     arenas, the same bits over two launches; bf16 arenas also at 1e-5
     against the plain version's float32 math on the same bf16 values, the
     TPU kernel's arithmetic) at opt-350m's head geometry
     (16 x 64) at the serving shape (B=4, page 16, rows at 9..55) and at
     long context (4096 positions, 256 pages a row), at mistral-7b-relu's
     (32 query / 8 KV heads x 128) at long context and mixed rows, and at
     qwen2-7b's (28 / 4 x 128, G = 7) in bf16, float32, bf16 and int8
     arenas, with rows at different positions and a row whose table is all
     null page; max error, the launch plan and blocks per SM, event ms,
     profiler device ms cold (the L2 flushed by writing) and warm, plain
     ms, the byte bound, and SDPA's time on the equivalent contiguous K/V
     as a yardstick (no PyTorch call reads a page table).
  7. paged: the slice's opt-350m and offload runtime served paged
     (page_size 16, 16 pages, 4 slots, four 40-token prompts: a random one,
     the same again (a live fork of its partial page), its first 32 tokens +
     8 others (a prefix hit on two full pages), another random one; 16 new
     tokens), offload and resident in float32 and resident in int8, each
     beside its contiguous run. Checks: every request finishes by length,
     paged tokens equal contiguous tokens (margin rule as in 4), the paged
     kernel launched decode_steps x 24 times and its plain version never
     ran, prefix_hits >= 1, cow_copies >= 1, preemptions == 0, and after
     `clear_prefix_cache()` the pool checks and is wholly free. Then the
     model cast to bf16 (a bf16 arena) served paged, resident: two
     4000-token prompts and two of 32 on one pool (page 16, room for all
     four), 16 new tokens: paged launches = decode steps x 24, no plain
     call, no preemption, the kernel against its plain version on layer 0's
     live arena at uid 0's last token (2e-2, and 1e-5 against float32
     math on the same bf16 values), and its breakdown.
  8. coact kernel: the co-activation kernel (MᵀM of a [T, N] 0/1 mask)
     against its plain version at (T, N) = (512, 4096), the offline stage's
     shape for opt-350m, (1000, 4100), ragged, and (4096, 14336),
     mistral-7b-relu's d_ff: `torch.equal` in every case (the counts are
     exact), equal to host numpy for the first two, the same bits over two
     launches; the same in accumulate mode (into a matrix of counts: equal
     to it plus the plain product). Event ms, profiler device ms cold /
     warm (the kernels the source's `__global__`s name), plain ms, the
     bound (mask and output bytes over 3.35 TB/s vs the triangle's
     N (N + 1) T int8 operations over 1,979 TOPS), the accumulate mode's
     ms and bound (the output also read) beside a fresh product then
     `+=`, and as yardsticks `torch.mm` on float32 masks (TF32 off) and
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
  9b. prefetch: the slice's model served offload through the layer-ahead
     prefetch worker (`prefetch=True`), each run on a fresh runtime with
     the slice's placements, 15 decode steps: in memory serial, with the
     lookahead predictors the slice's
     `build_offload_runtime(train_lookahead=True)` trained on the card,
     with `lookahead="oracle"` (depth 0), serial again (step times in
     turns); from the pack file serial, oracle, trained, and oracle
     with layer 0's second read fatal (a worker-issued read); the model
     cast to bf16 serial and trained. Checks: fused launches = decode
     steps x 24 and no plain call, per run; oracle runs = the serial run's
     tokens, per-uid io_seconds and `io_summary()` counters; trained runs
     = serial tokens (margin rule as in 4; bf16 below 1e-3 on the serial
     bf16 run's logits), the serial fault counters, per-uid I/O summing to
     the engines' reads (the speculated neurons are read too); the fatal
     run restarts its worker once and gives the clean tokens; no worker
     thread is left. Printed per run: ms a step, the scheduler's measured
     wall / I/O-busy / hidden / exposed seconds a token, the top-ups; and a
     breakdown of the trained run (`path="prefetch"`: idle share, the
     worker's `prefetch` and the serving thread's `prefetch_wait` /
     `topup` spans).
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
     heads x 128) in float32 and bfloat16, the reference's scalar-cur
     form, qwen2-7b's (28 / 4 x 128, G = 7) in bfloat16, a ragged one (W =
     8190, a window of W / 3, valid ranges that start and end inside
     tiles) and hd 36 in bfloat16 on rings 2 bytes off 16-byte alignment
     (the kernel's narrow path); max error, the same bits over two
     launches, the launch plan and blocks per SM, event ms, profiler device
     ms cold / warm, plain ms, the byte bound (the valid slots' K/V rows and
     every slot's position), and SDPA with a boolean mask on the same rings
     as a yardstick.
 12. swa: the slice's opt-350m served with `swa=True` (rings of 8192 slots),
     resident, offload, then resident with its weights cast to bfloat16
     (bf16 params, compute and rings), then the bf16 model of phase 4
     offload (a float32 query over bf16 rings from layer 1 on; fused and
     swa launches = decode steps x 24, the kernel = plain on layer 1's live
     rings with a float32 query scaled by 20 at 2e-2 and nearer it than
     the plain version on the query rounded to bf16, the short requests'
     tokens = the same decode on the CPU unless a top-2 margin < 1e-3):
     five requests
     on four slots, prompts
     of 8300 tokens (wrapped in prefill), 8180 (wraps in decode) and three
     of 32 (the last admitted into a reused slot), 16 new tokens each.
     Checks: every request finishes by length; swa-kernel launches = decode
     steps x 24 and no plain call, per run; at uid 0's last token the
     kernel equals its plain version on layer 0's live rings (1e-5, bf16
     2e-2), whose long rows show the wrap; the reused slot holds only its
     new request's positions; the short requests' tokens equal a
     contiguous-cache run's and offload tokens equal resident tokens
     (margin rule as in 4). Breakdowns of the float32 and the bf16 runs.
 13. segment kernel: the unfused segment-FFN kernel against its plain
     version (1e-4; on bf16 weights plus `activation_tie_slack` capped at
     2e-3, the activation being rounded to bf16) with w_up / w_gate as transposed
     views of [D, N] weights: the serve_sparse shape (B=4, D=1024, N=4096,
     S=4), mistral-7b-relu's (D=4096, N=14336, S=16) in float32 and
     bfloat16, gated silu, -1 pads with a repeated id, and bfloat16
     weights; the launch plan, the same columns as 11 (device time also
     per kernel), the bound being the gathered rows' bytes, and
     `index_select` + `torch.mm` as a yardstick (no single PyTorch call
     computes it).
 14. sparse: the slice's model and requests with `serve_sparse=True` (the
     config's 128-neuron segments and sparse_frac 0.15: 4 of 32 segments,
     seeded predictors), resident. Checks: segment-kernel launches = decode
     steps x 24, no plain call; tokens equal the same decode on the CPU
     (plain versions, same weights) unless the CPU run's top-2 logit margin
     at the first difference is below 1e-3 or its k-th and (k+1)-th
     segment scores lie within 1e-5 relative; the same for the model cast
     to bf16 (the bf16 activation rounding of the segment kernel, against
     a bf16 CPU run; the margin there below 2e-2, as the other bf16
     servers' checks); with sparse_frac 1.0 the tokens equal the
     dense resident run's (margin rule as in 4). Breakdowns of the float32
     and the bf16 runs.

Prints one JSON line per phase, then `{"kernels": [...]}`, the
`nvidia-smi` name/power line, and last `{"ok": true, "device": {...}}`.
Imports torch, numpy and the port only.

    python3 chip_smoke.py --coact-interleaved PARENT_TREE

instead times phase 8's route (fresh, fresh then `+=`, and the accumulate
mode where the tree has it) of another checkout of the repository and of
this one in turns, parent / this / this / parent, a process each.
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
FFN_KERNELS = ("sparse_ffn_fused_kernel",)
PAGED_TOL = {"float32": 1e-5, "int8": 1e-5,   # online softmax, rows in
             "bfloat16": 2e-2}                 # another order; bf16: the
                                  # plain version rounds scores and P to bf16
PAGED_F32_MATH_TOL = 1e-5   # bf16 arenas vs float32 math on the same values
PAGED_SOURCE = "src/repro_torch/kernels/csrc/paged_decode.cu"
PAGED_REPLACES = "src/repro/kernels/swa_decode.py:211"
PAGED_KERNELS = ("paged_split_kernel",)
INT8_OPS = 1979e12             # H100 SXM data sheet, int8 tensor cores, dense
COACT_SOURCE = "src/repro_torch/kernels/csrc/coact.cu"
COACT_REPLACES = "src/repro/kernels/coact.py:39"
SWA_SOURCE = "src/repro_torch/kernels/csrc/swa_decode.cu"
SWA_REPLACES = "src/repro/kernels/swa_decode.py:103"
SWA_KERNELS = ("swa_split_kernel",)
SEG_SOURCE = "src/repro_torch/kernels/csrc/sparse_ffn_segments.cu"
SEG_REPLACES = "src/repro/kernels/sparse_ffn.py:203"
ITERS = 30                     # timed launches per kernel measurement
PROFILE_WINDOWS = 3            # profiler windows tried for a whole record
PROFILE_EDGE_S = 0.05          # idle seconds on each side of a window's edges
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
    `names` (the fused FFN's three by default; each launched once a call),
    read from `torch.profiler` (CUDA activity): the kernels' own time,
    without the host's enqueue or the gaps between launches. `cold` flushes
    the L2 before each call as `time_ms` does; warm leaves the inputs in L2
    from the call before. A warm-up step of 3 calls comes first and is not
    counted. Once the card has served, the profiler's window edges move
    against the kernels' timestamps, so launches next to an edge were
    dropped (27 of 30 recorded) or warm-up launches counted: each edge
    has PROFILE_EDGE_S of idle time on both sides. A window in which a named
    kernel shows other than `iters` launches is measured again, up to
    PROFILE_WINDOWS windows; if none is whole, the mean per recorded
    launch of the window that recorded most is returned and a
    `profiler_lossy` line says so (a run recorded as few as 14 of 30), and
    a named kernel with no record raises. None on the CPU."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    if flush.device.type != "cuda":
        return None
    best = []
    for _ in range(PROFILE_WINDOWS):
        seen = []

        def ready(prof, seen=seen):
            seen.extend(e for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA
                        and any(n in e.key for n in names))
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=ready) as prof:
            for n_calls in (3, iters):      # the warm-up step, the window
                time.sleep(PROFILE_EDGE_S)
                for _ in range(n_calls):
                    if cold:
                        flush.zero_()
                    fn()
                torch.cuda.synchronize()
                time.sleep(PROFILE_EDGE_S)
                prof.step()
        if seen and all(e.count == iters for e in seen):
            return sum(e.self_device_time_total for e in seen) / 1e3 / iters
        if min((e.count for e in seen), default=0) > min(
                (e.count for e in best), default=0):
            best = seen
    recorded = [e.count for e in best]
    if not all(any(n in e.key for e in best) for n in names):
        raise RuntimeError(f"the profiler recorded {recorded} launches of "
                           f"{names}, not {iters} each")
    emit({"profiler_lossy": {"kernels": list(names), "recorded": recorded,
                             "iters": iters, "windows": PROFILE_WINDOWS}})
    return sum(e.self_device_time_total / e.count for e in best) / 1e3


# -- kernel phase --------------------------------------------------------------

KERNEL_CASES = [
    # name, weight dtype, activation, gated, S, padded ids[, D, N]
    ("main_path_f32_relu_S32", "float32", "relu", False, 32, 0),
    ("f32_relu_S8_pad", "float32", "relu", False, 8, 2),
    ("int8_relu_S32_pad", "int8", "relu", False, 32, 4),
    ("int8_relu_S8_pad", "int8", "relu", False, 8, 3),
    ("f32_silu_gated_S32_pad", "float32", "silu", True, 32, 4),
    ("f32_silu_gated_S8_pad", "float32", "silu", True, 8, 2),
    ("int8_silu_gated_S8_pad", "int8", "silu", True, 8, 2),
    ("f32_gelu_S8_pad", "float32", "gelu", False, 8, 2),
    ("f32_relu2_S8_pad", "float32", "relu2", False, 8, 2),
    # the bf16 model's offload path (bf16 rows); mistral-7b-relu's widths
    # with every one of its 112 segments
    ("main_path_bf16_relu_S32", "bfloat16", "relu", False, 32, 0),
    ("bf16_silu_gated_S32_pad", "bfloat16", "silu", True, 32, 4),
    ("mistral7b_bf16_relu_S112", "bfloat16", "relu", False, 112, 0, 4096,
     14336),
]


def kernel_inputs(gen, dtype, gated, S, n_pad, B=4, D=1024, N=4096, seg=128,
                  density=0.9375):
    """Decode-shaped inputs on the card. `density` is the live share of a
    segment's neurons: 1 - 0.5**4, what a 4-row batch of random-weight ReLU
    masks covers. Padded rows get random scales too: the kernel must ignore
    them. bf16 rows come with x in bf16, as the offload path's first layer
    gives it (later layers give float32)."""
    import torch
    dev = gen.device
    x = torch.randn((B, D), generator=gen, device=dev)
    n_seg = N // seg

    def weights(std):
        if dtype == "int8":
            return torch.randint(-127, 128, (N, D), generator=gen, device=dev,
                                 dtype=torch.int8)
        w = torch.randn((N, D), generator=gen, device=dev) * std
        return w.to(getattr(torch, dtype))

    w_up, w_down = weights(D ** -0.5), weights(N ** -0.5)
    w_gate = weights(D ** -0.5) if gated else None
    perm = torch.randperm(n_seg, generator=gen, device=dev)[:S - n_pad]
    seg_ids = torch.cat([perm, torch.full((n_pad,), -1, device=dev,
                                          dtype=perm.dtype)]).to(torch.int32)
    live = torch.rand((S, seg), generator=gen, device=dev) < density
    base = (torch.rand((S, seg), generator=gen, device=dev) * 2e-4 + 3e-4
            if dtype == "int8" else torch.ones((S, seg), device=dev))
    scale_tiles = (base * live).contiguous()
    if dtype == "bfloat16":
        x = x.bfloat16()
    return x, w_up, w_down, seg_ids, scale_tiles, w_gate


def bound_of(x, w_up, seg_ids, scale_tiles, gated, seg=128):
    """(bound ms, what bounds it) for one call on these inputs: the bytes it
    must move (each live weight row once per matrix, x, ids, scales, out)
    over the HBM rate vs its fp32 flops over the fp32 rate."""
    n_mats = 3 if gated else 2
    B, D = x.shape
    live_rows = int(((seg_ids >= 0)[:, None] & (scale_tiles != 0)).sum())
    nbytes = (live_rows * D * n_mats * w_up.element_size()
              + x.numel() * x.element_size() + x.numel() * 4
              + seg_ids.numel() * 4 + scale_tiles.numel() * 4)
    flops = 2 * B * live_rows * D * n_mats
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def fused_yardstick(x, w_up, w_down, seg_ids, tiles, w_gate, activation,
                    flush, seg=128):
    """ms of `index_select` of the live rows + two `torch.mm` (and the
    gate's) for the same function on 0/1 multipliers: float32 with TF32
    off, bf16 rows in bf16. Not one call (no single PyTorch call computes
    it) and a yardstick only: the port never calls it. None for int8 rows,
    which `torch.mm` does not take as they are."""
    import torch
    from repro_torch.models.layers import apply_activation
    if w_up.dtype == torch.int8:
        return None
    assert not torch.backends.cuda.matmul.allow_tf32
    ids = seg_ids.long()
    live = (ids >= 0)[:, None] & (tiles != 0)
    rows = (ids[:, None] * seg + torch.arange(seg, device=ids.device))[live]

    def f():
        xw = x.to(w_up.dtype)
        a = apply_activation(torch.mm(xw, torch.index_select(w_up, 0, rows).T),
                             activation)
        if w_gate is not None:
            a = a * torch.mm(xw, torch.index_select(w_gate, 0, rows).T)
        return torch.mm(a, torch.index_select(w_down, 0, rows))

    return time_ms(f, flush)


def kernel_phase(dev, seed: int, reduced: bool) -> dict:
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.sparse_ffn import (
        launch_plan, sparse_ffn_segments_fused_plain)
    gen = torch.Generator(device=dev).manual_seed(seed)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB
    cases = []
    for name, dtype, act, gated, S, n_pad, *widths in KERNEL_CASES:
        D, N = widths or (1024, 4096)
        if reduced:             # the CPU rehearsal keeps opt-350m's widths
            D, N, S = 1024, 4096, min(S, 32)
        x, w_up, w_down, seg_ids, tiles, w_gate = kernel_inputs(
            gen, dtype, gated, S, n_pad, D=D, N=N)
        kw = dict(seg_size=128, activation=act)
        args = (x, w_up, w_down, seg_ids, tiles, w_gate)
        y_kernel = ops.sparse_ffn_segments_fused(*args, **kw)
        y_plain = sparse_ffn_segments_fused_plain(*args, **kw)
        sync(dev)
        assert y_kernel.shape == y_plain.shape == x.shape, name
        assert bool(torch.isfinite(y_kernel).all()), f"{name}: non-finite"
        err = float((y_kernel - y_plain).abs().max())
        ok = bool(torch.allclose(y_kernel, y_plain, rtol=TOL, atol=TOL))
        same = bool(torch.equal(y_kernel,
                                ops.sparse_ffn_segments_fused(*args, **kw)))

        def kernel():
            return ops.sparse_ffn_segments_fused(*args, **kw)

        ms = time_ms(kernel, flush)
        device_cold_ms = kernel_device_ms(kernel, flush, cold=True)
        device_warm_ms = kernel_device_ms(kernel, flush, cold=False)
        plain_ms = time_ms(lambda: sparse_ffn_segments_fused_plain(
            *args, **kw), flush)
        bound_ms, bound_by = bound_of(x, w_up, seg_ids, tiles, gated)
        case = dict(case=name, shape=[x.shape[0], x.shape[1], w_up.shape[0], S],
                    rows=dtype, n_pad=n_pad, max_abs_err=err, allclose=ok,
                    deterministic=same, ms=ms,
                    device_cold_ms=device_cold_ms,
                    device_warm_ms=device_warm_ms,
                    plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                    yardstick_not_one_call_ms=fused_yardstick(
                        *args, act, flush),
                    plan=(launch_plan(x, w_up, seg_ids, tiles, gated)._asdict()
                          if dev.type == "cuda" else None))
        emit({"kernel_case": case})
        assert ok, f"{name}: kernel disagrees with the plain version ({err})"
        assert same, f"{name}: two launches gave different bits"
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
    # the lookahead predictors are trained on the card here too, for the
    # prefetch phase (serial serving does not read them)
    runtime = build_offload_runtime(model, params,
                                    rng=np.random.default_rng(seed),
                                    calib_batch=(8, 64), train_lookahead=True,
                                    device=dev)
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
    bf16 = slice_bf16_run(dev, seed, model, params, reqs, max_len)
    return {"launches": launches, "model": model, "params": params,
            "bf16": bf16,
            "runtime": runtime, "reqs": reqs, "max_len": max_len,
            "offload_results": [(h.uid, h.result.tokens, h.result.io_seconds)
                                for h in off_handles],
            "main_ms_per_step": {r["mode"]: r["decode_ms_per_step"]
                                 for r in (off_row, res_row)}}


BF16_MARGIN = 1e-3


def slice_bf16_run(dev, seed: int, model, params, reqs, max_len) -> dict:
    """The slice's model cast to bf16 (bf16 params, compute and bundles)
    served offload through `build_offload_runtime` and `InferenceServer`,
    counts set to 0 just before and read just after; the fused kernel
    against its plain version on the inputs of layer 0's last call; then
    the same requests on the CPU (plain versions, the same weights and the
    card runtime's placements), each step's logits recorded, whose tokens
    the card run must give unless the CPU run's top-2 logit margin at the
    first difference is below BF16_MARGIN. The bf16 resident run is no
    reference: offload turns the residual stream float32 after the first
    FFN (the reference's promotion), resident does not."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.sparse_ffn import sparse_ffn_segments_fused_plain
    from repro_torch.models import build_model
    from repro_torch.serving.engine import (OffloadedFFNRuntime,
                                            build_offload_runtime)
    from repro_torch.serving.server import InferenceServer
    from repro_torch.store.packer import extract_dense_ffn_bundles

    bmodel, bparams = bf16_model(model, params)
    cfg = bmodel.cfg
    t0 = time.perf_counter()
    runtime = build_offload_runtime(bmodel, bparams,
                                    rng=np.random.default_rng(seed),
                                    calib_batch=(8, 64), device=dev)
    sync(dev)
    runtime_s = time.perf_counter() - t0
    assert runtime.io_summary()["ffn_kernel"] == "segments"
    w0 = runtime._segment_weights[0][0]
    assert w0.dtype == torch.bfloat16

    def serve(m, p, rt, device, record=None):
        server = InferenceServer(m, p, max_slots=len(reqs), max_len=max_len,
                                 mode="offload", offload=rt, device=device)
        if record is not None:
            decode = server._decode_offload

            def recorded(active):
                out = decode(active)
                record.append(np.asarray(out[0], np.float32))
                return out
            server._decode_offload = recorded
        handles = [server.submit(r) for r in reqs]
        server.drain()
        sync(torch.device(device) if isinstance(device, str) else device)
        return handles, server.stats

    last = {}
    real = ops.sparse_ffn_segments_fused

    def recording(x, w_up, *a, **kw):
        if w_up is w0:          # layer 0's call: keep its inputs
            last.update(args=(x, w_up, *a), kw=kw)
        return real(x, w_up, *a, **kw)

    ops.sparse_ffn_segments_fused = recording
    try:
        ops.reset_counts()
        handles, st = serve(bmodel, bparams, runtime, dev)
        ffn = ops.counts["sparse_ffn_segments_fused"]
        launches, plain_calls = ffn.launches, ffn.plain_calls
    finally:
        ops.sparse_ffn_segments_fused = real
    row = {"mode": "offload", "dtype": "bfloat16",
           "build_offload_runtime_s": runtime_s,
           "decode_steps": st.decode_steps,
           "decode_ms_per_step": 1e3 * st.decode_seconds / st.decode_steps,
           "kernel_launches": launches, "plain_calls": plain_calls,
           "expected_launches": st.decode_steps * runtime.n_layers}
    for h in handles:
        assert h.result.finish_reason == "length", (h.uid, h.result)
    taken, other = ((launches, plain_calls) if dev.type == "cuda"
                    else (plain_calls, launches))
    assert other == 0, row
    assert taken == st.decode_steps * runtime.n_layers > 0, row

    # the kernel against its plain version on layer 0's live rows
    x0 = last["args"][0]
    y_kernel = ops.sparse_ffn_segments_fused(*last["args"], **last["kw"])
    y_plain = sparse_ffn_segments_fused_plain(*last["args"], **last["kw"])
    sync(dev)
    err = float((y_kernel - y_plain).abs().max())
    row.update(layer0_x_dtype=str(x0.dtype).replace("torch.", ""),
               layer0_live_segments=int((last["args"][3] >= 0).sum()),
               layer0_max_abs_err=err)
    assert bool(torch.allclose(y_kernel, y_plain, rtol=TOL, atol=TOL)), row

    # the same decode on the CPU, each step's logits recorded
    cpu_model = build_model(cfg, device="cpu")
    cpu_params = to_device(bparams, "cpu")
    cpu_runtime = OffloadedFFNRuntime(
        cfg, extract_dense_ffn_bundles(cfg, cpu_params),
        [e.placement for e in runtime.engines], device="cpu")
    rows = []
    cpu_handles, _ = serve(cpu_model, cpu_params, cpu_runtime, "cpu", rows)
    mismatches = []
    for slot, (h, hc) in enumerate(zip(handles, cpu_handles)):
        t = first_divergence(h.result.tokens, hc.result.tokens)
        if t is None:
            continue
        if t == 0:      # the prefill's token: dense in both
            margin = decode_margin(cpu_model, cpu_params, reqs[slot].prompt,
                                   hc.result.tokens, 0, max_len)
        else:           # token t comes out of decode step t (uid = slot)
            top2 = np.sort(rows[t - 1][slot])[-2:]
            margin = float(top2[1] - top2[0])
        mismatches.append({"uid": h.uid, "step": t, "margin": margin})
        emit({"token_mismatch": dict(mismatches[-1], run="bf16 offload card",
                                     reference="bf16 offload cpu")})
        assert margin < BF16_MARGIN, mismatches
    row["mismatches_vs_cpu"] = mismatches
    emit({"slice": row})
    del cpu_params, cpu_model, cpu_runtime
    return {"model": bmodel, "params": bparams, "runtime": runtime,
            "launches": taken, "ms_per_step": row["decode_ms_per_step"]}


def decode_margin(model, params, prompt, tokens, t: int, max_len: int,
                  swa: bool = False):
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

HOST_SPANS = ("decode_step", "probe", "read", "admit", "prefetch",
              "prefetch_wait", "topup")


def breakdown_phase(dev, model, params, runtime, reqs, max_len,
                    main_ms_per_step, path: str = "slice",
                    kernels=FFN_KERNELS, **server_kw) -> None:
    """Where a decode step's time goes, per mode of `main_ms_per_step`,
    after that path ran: the same requests (new uids) are admitted with one
    `step()`, then the remaining decode steps run under `torch.profiler`
    (CUDA activity: the card's kernel and copy times) and the port's own
    tracer (host spans of the offload engine and, with `prefetch=True`,
    of the prefetch worker: `prefetch` on its thread, `prefetch_wait` and
    `topup` on the serving thread). The profiler slows the host,
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
            server.close()
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
    # (NULL, c) has an all-null table and reads c + 1 null-page rows), arena
    ("opt350m_serve_f32", 16, 1, 64, 16, [54, 40, 9, (NULL, 17)], "float32"),
    ("opt350m_serve_int8", 16, 1, 64, 16, [54, 40, 9, (NULL, 17)], "int8"),
    ("opt350m_long_f32", 16, 1, 64, 16, [4095] * 4, "float32"),
    ("opt350m_long_int8", 16, 1, 64, 16, [4095] * 4, "int8"),
    ("opt350m_long_bf16", 16, 1, 64, 16, [4095] * 4, "bfloat16"),
    ("mistral7b_long_f32", 8, 4, 128, 16, [4095] * 4, "float32"),
    ("mistral7b_long_int8", 8, 4, 128, 16, [4095] * 4, "int8"),
    ("mistral7b_long_bf16", 8, 4, 128, 16, [4095] * 4, "bfloat16"),
    ("qwen2_7b_long_bf16", 4, 7, 128, 16, [4095] * 4, "bfloat16"),
    ("mistral7b_mixed_f32", 8, 4, 128, 16, [4095, 1500, 7, (NULL, 300)],
     "float32"),
    ("mistral7b_mixed_int8", 8, 4, 128, 16, [4095, 1500, 7, (NULL, 300)],
     "int8"),
]
REHEARSAL_LONG = 128    # the CPU rehearsal cuts 4096-position rows to this


def paged_inputs(gen, KV, G, hd, page, rows, arena):
    """A shuffled page arena on the card for rows at `rows` (see
    PAGED_CASES): row b owns pages for slots 0..cur[b] at random physical
    pages, the rest of its table points at the null page (random contents
    too), as do the two spare pages. int8 arenas get bf16 scales around
    1/127; the query is float32 in every case."""
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
    if arena == "int8":
        k, v = (torch.randint(-127, 128, shape, generator=gen, device=dev,
                              dtype=torch.int8) for _ in range(2))
        ks, vs = ((torch.rand(shape[:3], generator=gen, device=dev) + 0.5)
                  .div(127).to(torch.bfloat16) for _ in range(2))
    else:
        k, v = (torch.randn(shape, generator=gen, device=dev)
                .to(getattr(torch, arena)) for _ in range(2))
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
    out contiguously ([B, KV, S, hd] in the arena's float dtype, int8
    dequantised to float32, GQA), masked causally where rows stop short of
    S. A yardstick for later PRs only: the port never calls it."""
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
    q4 = q[:, :, None].to(kc.dtype)
    mask = None
    if int(cur.min()) + 1 < S:
        mask = (torch.arange(S, device=q.device)[None]
                <= cur.long()[:, None])[:, None, None]
    return time_ms(lambda: F.scaled_dot_product_attention(
        q4, kc, vc, attn_mask=mask, enable_gqa=True), flush)


def f32_math_check(out, q, k, v, table, cur):
    """(max abs error, within PAGED_F32_MATH_TOL) of a bf16 arena's kernel
    output `out` (on the card) against the plain version on the same bf16 values in
    float32 (q rounded to bf16 as the kernel rounds it): the TPU kernel's
    `_paged_core` arithmetic, f32 scores and P."""
    import torch
    from repro_torch.kernels.paged_decode import paged_decode_attention_plain
    ref = paged_decode_attention_plain(q.bfloat16().float(), k.float(),
                                       v.float(), table, cur)
    return (float((out - ref).abs().max()),
            bool(torch.allclose(out, ref, rtol=PAGED_F32_MATH_TOL,
                                atol=PAGED_F32_MATH_TOL)))


def paged_kernel_phase(dev, seed: int, reduced: bool) -> dict:
    """Every PAGED_CASES case through the dispatcher against the plain
    version, at its tolerance and bit for bit over two launches; a bf16
    arena also against the plain version's float32 math on the same bf16
    values (PAGED_F32_MATH_TOL). On the card also the launch plan, blocks
    per SM and the times."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels.paged_decode import paged_decode_attention_plain
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB
    cuda = dev.type == "cuda"
    cases = []
    for name, KV, G, hd, page, rows, arena in PAGED_CASES:
        if reduced:
            rows = [min(r, REHEARSAL_LONG - 1) if isinstance(r, int)
                    else (NULL, min(r[1], REHEARSAL_LONG - 1)) for r in rows]
        q, k, v, table, cur, ks, vs = paged_inputs(gen, KV, G, hd, page,
                                                   rows, arena)
        args = (q, k, v, table, cur, ks, vs)
        out = ops.paged_decode_attention(*args)
        ref = paged_decode_attention_plain(*args)
        sync(dev)
        assert out.shape == ref.shape == q.shape, name
        assert bool(torch.isfinite(out).all()), f"{name}: non-finite"
        err = float((out - ref).abs().max())
        tol = PAGED_TOL[arena]
        ok = bool(torch.allclose(out, ref, rtol=tol, atol=tol))
        same = bool(torch.equal(out, ops.paged_decode_attention(*args)))
        f32_err = f32_ok = None
        if arena == "bfloat16" and cuda:   # on the CPU `out` is the plain
            f32_err, f32_ok = f32_math_check(out, *args[:5])    # version

        def kernel():
            return ops.paged_decode_attention(*args)

        bound_ms, bound_by, nbytes = paged_bound(q, k, table, cur, page)
        case = dict(
            case=name, B=q.shape[0], H=q.shape[1], KV=KV, hd=hd, page=page,
            cur=cur.tolist(), null_rows=[b for b, r in enumerate(rows)
                                         if isinstance(r, tuple)],
            arena_dtype=arena, max_abs_err=err, tol=tol, allclose=ok,
            deterministic=same, f32_math_max_abs_err=f32_err,
            f32_math_tol=PAGED_F32_MATH_TOL if f32_err is not None else None,
            plan=pd._plan_for(q, k, v, table)._asdict() if cuda else None,
            blocks_per_sm=pd.blocks_per_sm(q, k, v, table) if cuda else None,
            ms=time_ms(kernel, flush),
            device_cold_ms=kernel_device_ms(kernel, flush, cold=True,
                                            names=PAGED_KERNELS),
            device_warm_ms=kernel_device_ms(kernel, flush, cold=False,
                                            names=PAGED_KERNELS),
            plain_ms=time_ms(lambda: paged_decode_attention_plain(*args),
                             flush),
            bound_ms=bound_ms, bound_by=bound_by, bound_bytes=nbytes,
            sdpa_contiguous_ms=(sdpa_yardstick(*args, flush)
                                if cuda else None))
        emit({"paged_kernel_case": case})
        assert ok, f"{name}: kernel disagrees with the plain version ({err})"
        assert same, f"{name}: two launches gave different bits"
        assert f32_ok in (None, True), (
            f"{name}: kernel disagrees with float32 math on its bf16 arena "
            f"({f32_err})")
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
    launches["resident_bf16_long"] = paged_long_run(dev, seed, model, params,
                                                    reduced)
    return {"launches": launches}


PAGED_LONG_LENS = (4000, 4000, 32, 32)   # long-context chat on one pool


def paged_long_run(dev, seed: int, model, params, reduced: bool) -> int:
    """The slice's model cast to bf16 (bf16 arena), served paged, resident:
    two 4000-token prompts and two of 32 on one shared pool of page 16 with
    room for all four, 16 new tokens each (the CPU rehearsal cuts the long
    prompts to REHEARSAL_LONG). Counts set to 0 just before the run, read
    just after: paged launches = decode steps x layers, no plain call. At
    uid 0's last token layer 0's arena, page tables and positions are
    copied, and after the run the kernel is held against its plain version
    on that copy (2e-2), and against float32 math on the same bf16 values
    (PAGED_F32_MATH_TOL). Then the breakdown of the same traffic."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_decode import paged_decode_attention_plain
    from repro_torch.serving.engine import Request
    from repro_torch.serving.server import InferenceServer

    model16, params16 = bf16_model(model, params)
    cfg = model16.cfg
    lens = [min(n, REHEARSAL_LONG) if reduced else n for n in PAGED_LONG_LENS]
    rng = np.random.default_rng(seed + 8)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new_tokens=PAGED_NEW_TOKENS)
            for i, n in enumerate(lens)]
    max_len = max(lens) + PAGED_NEW_TOKENS
    paging = dict(page_size=PAGE_SIZE, num_pages=sum(
        -(-(n + PAGED_NEW_TOKENS) // PAGE_SIZE) for n in lens))
    server = InferenceServer(model16, params16, max_slots=len(reqs),
                             max_len=max_len, device=dev, **paging)
    snap = {}

    def on_token(uid, tok):
        if len(server._handles[uid].tokens) == PAGED_NEW_TOKENS:
            arena = server._pool.cache_groups[0]["sub_0"]
            live = [h is not None for h in server._slot_handle]
            snap.update(k=arena.k.clone(), v=arena.v.clone(),
                        table=torch.as_tensor(server._page_tables_np(),
                                              device=dev),
                        cur=torch.as_tensor(
                            np.where(live, server._slot_pos - 1, 0)
                            .astype(np.int32), device=dev))

    handles = [server.submit(r, on_token=on_token if r.uid == 0 else None)
               for r in reqs]
    ops.reset_counts()
    server.drain()
    sync(dev)
    pc = ops.counts["paged_decode"]
    st = server.stats
    row = {"mode": "resident_bf16_long",
           "kv": str(snap["k"].dtype).replace("torch.", ""),
           "prompt_lens": lens, "page_size": PAGE_SIZE,
           "num_pages": paging["num_pages"],
           "decode_steps": st.decode_steps,
           "decode_ms_per_step": 1e3 * st.decode_seconds / st.decode_steps,
           "decode_tokens_per_s": (st.tokens_emitted - st.admitted)
           / st.decode_seconds,
           "prefill_s_total": st.prefill_seconds,
           "paged_launches": pc.launches, "paged_plain_calls": pc.plain_calls,
           "preemptions": st.preemptions}
    for h in handles:
        assert h.result.finish_reason == "length", (h.uid, h.result)
        assert len(h.result.tokens) == PAGED_NEW_TOKENS
    taken, other = ((pc.launches, pc.plain_calls) if dev.type == "cuda"
                    else (pc.plain_calls, pc.launches))
    assert other == 0, row
    assert taken == st.decode_steps * cfg.n_layers > 0, row
    assert st.preemptions == 0, row
    # the last step: the live arena, the kernel vs its plain version
    q = torch.randn((len(reqs), cfg.n_heads, cfg.head_dim),
                    generator=torch.Generator(device=dev).manual_seed(seed),
                    device=dev)
    args = (q, snap["k"], snap["v"], snap["table"], snap["cur"])
    out = ops.paged_decode_attention(*args)
    ref = paged_decode_attention_plain(*args)
    tol = PAGED_TOL["bfloat16"]
    f32_err, f32_ok = (f32_math_check(out, *args) if dev.type == "cuda"
                       else (None, True))      # on the CPU out is the plain
    row.update(last_step_cur=snap["cur"].tolist(),
               last_step_max_abs_err=float((out - ref).abs().max()),
               last_step_f32_math_max_abs_err=f32_err)
    assert snap["k"].dtype == torch.bfloat16, row
    assert torch.allclose(out, ref, rtol=tol, atol=tol), row
    assert f32_ok, row
    assert int(snap["cur"].max()) >= max(lens), row
    del snap, args, out, ref
    emit({"paged": row})
    breakdown_phase(dev, model16, params16, None, reqs, max_len,
                    {"resident": row["decode_ms_per_step"]},
                    path="paged_bf16_long", kernels=PAGED_KERNELS, **paging)
    return taken


# -- coact kernel phase ------------------------------------------------------------

COACT_CASES = [
    # name, T tokens, N neurons, mask density, compare with host numpy
    ("opt350m_pack_512x4096", 512, 4096, 0.5, True),
    ("ragged_1000x4100", 1000, 4100, 0.5, True),
    ("mistral7b_4096x14336", 4096, 14336, 0.5, False),
]
REHEARSAL_COACT = [(64, 128), (100, 130), (256, 512)]
ADD_KERNELS = ("Functor_add",)   # PyTorch's `pair += fresh` on the card


def coact_bound(T, N, accumulate: bool = False):
    """(bound ms, what bounds it) of MᵀM's least work: the mask bytes read
    once and the f32 [N, N] output written once (accumulate mode: also read
    once) over the HBM rate, vs the triangle's N·(N + 1)·T int8 operations
    (the other triangle is the same numbers) over the int8 tensor rate."""
    t_bytes = (T * N + (8 if accumulate else 4) * N * N) / HBM_BYTES_PER_S
    t_ops = N * (N + 1) * T / INT8_OPS
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


def coact_kernel_names(root: Path):
    """The `__global__` functions of `root`'s coact.cu: the kernels whose
    device time a coact call is (a parent's tree names its own)."""
    import re
    src = (root / COACT_SOURCE).read_text()
    return tuple(re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                            r"\([^)]*\)\s+)?(\w+)", src))


def coact_timings(m, flush, names, accumulate: bool) -> dict:
    """Event ms and profiler device ms (cold L2; fresh also warm) of the
    coact route on masks m: a fresh product; the same then `pair += it`
    (two calls, the stats' update before the accumulate mode) and PyTorch's
    add alone; with `accumulate`, the accumulate mode into `pair`. The pair
    matrix's values grow run to run; nothing here checks them."""
    import torch
    from repro_torch.kernels.ops import coact_accumulate as coact
    N = m.shape[1]
    pair = torch.zeros((N, N), dtype=torch.float32, device=m.device)
    prod = coact(m)

    def fresh():
        return coact(m)

    def fresh_plus_add():
        pair.add_(coact(m))

    row = dict(
        ms=time_ms(fresh, flush),
        device_cold_ms=kernel_device_ms(fresh, flush, cold=True, names=names),
        device_cold_ms_by_kernel={n: kernel_device_ms(
            fresh, flush, cold=True, names=(n,)) for n in names},
        device_warm_ms=kernel_device_ms(fresh, flush, cold=False,
                                        names=names),
        fresh_plus_add_ms=time_ms(fresh_plus_add, flush),
        fresh_plus_add_device_cold_ms=kernel_device_ms(
            fresh_plus_add, flush, cold=True, names=names + ADD_KERNELS),
        add_device_cold_ms=kernel_device_ms(
            lambda: pair.add_(prod), flush, cold=True, names=ADD_KERNELS))
    if accumulate:
        def acc():
            return coact(m, accumulate_into=pair)
        row.update(acc_ms=time_ms(acc, flush),
                   acc_device_cold_ms=kernel_device_ms(acc, flush, cold=True,
                                                       names=names))
    return row


def coact_kernel_phase(dev, seed: int, reduced: bool) -> dict:
    """Each case: the kernel against its plain version, fresh and in
    accumulate mode (into a pair matrix that already holds counts), both
    `torch.equal` and the same bits on a second launch; then its times
    beside the bound and the library calls."""
    import numpy as np
    import torch
    from repro_torch.kernels.coact import coact_accumulate_plain
    from repro_torch.kernels.ops import coact_accumulate as coact
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB
    names = coact_kernel_names(ROOT)
    cases = []
    for i, (name, T, N, density, host) in enumerate(COACT_CASES):
        if reduced:
            T, N = REHEARSAL_COACT[i]
        m = torch.rand((T, N), generator=gen, device=dev) < density
        out = coact(m)
        ref = coact_accumulate_plain(m)
        sync(dev)
        assert out.dtype == torch.float32 and tuple(out.shape) == (N, N), name
        exact = bool(torch.equal(out, ref))
        same = bool(torch.equal(out, coact(m)))
        host_equal = None
        if host:
            mn = m.cpu().numpy().astype(np.float32)
            host_equal = bool(np.array_equal(out.cpu().numpy(), mn.T @ mn))
        err = float((out - ref).abs().max())
        del out
        start = torch.randint(0, 1 << 16, (N, N), generator=gen, device=dev,
                              dtype=torch.int32).to(torch.float32)
        acc = coact(m, accumulate_into=start.clone())
        acc_exact = bool(torch.equal(acc, start + ref))
        acc_same = bool(torch.equal(acc, coact(m, accumulate_into=start)))
        del ref, acc, start
        bound_ms, bound_by = coact_bound(T, N)
        acc_bound_ms, acc_bound_by = coact_bound(T, N, accumulate=True)
        mm_ms, int_mm_ms = library_yardsticks(m, flush)
        case = dict(
            case=name, T=T, N=N, density=density, max_abs_err=err,
            equal=exact, deterministic=same, equal_host_numpy=host_equal,
            accumulate_equal=acc_exact, accumulate_deterministic=acc_same,
            **coact_timings(m, flush, names, accumulate=True),
            plain_ms=time_ms(lambda: coact_accumulate_plain(m), flush),
            bound_ms=bound_ms, bound_by=bound_by,
            acc_bound_ms=acc_bound_ms, acc_bound_by=acc_bound_by,
            library_mm_f32_ms=mm_ms, library_int_mm_ms=int_mm_ms)
        emit({"coact_kernel_case": case})
        assert exact, f"{name}: kernel counts differ from the plain version"
        assert same, f"{name}: two launches gave different bits"
        assert host_equal in (None, True), f"{name}: differs from host numpy"
        assert acc_exact, f"{name}: accumulate mode differs from fresh + add"
        assert acc_same, f"{name}: two accumulate launches gave other bits"
        cases.append(case)
        del m
    del flush
    return {"cases": cases}


def coact_tree_times(tree: Path, seed: int) -> None:
    """One tree's coact route timed at every case (its own `repro_torch`
    on the path, the kernels it names): the child process of
    `coact_interleaved`. Prints one `coact_tree` line a case."""
    import inspect
    import torch
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels.ops import coact_accumulate
    dev = torch.device("cuda", 0)
    accumulate = "accumulate_into" in inspect.signature(
        coact_accumulate).parameters
    names = coact_kernel_names(tree)
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    for name, T, N, density, _ in COACT_CASES:
        m = torch.rand((T, N), generator=gen, device=dev) < density
        emit({"coact_tree": {"tree": str(tree), "case": name, "kernels": names,
                             **coact_timings(m, flush, names, accumulate)}})
        del m


def coact_interleaved(parent: Path, seed: int) -> int:
    """The coact route of `parent`'s tree and of this one timed in turns,
    parent / this / this / parent, each a process of its own on the card
    (`--coact-tree`); the parent's accumulate is its fresh product then
    `+=`. Prints the `nvidia-smi` line and each run's lines."""
    print(nvidia_smi(), flush=True)
    for tree in (parent, ROOT, ROOT, parent):
        done = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                               "--seed", str(seed), "--coact-tree",
                               str(tree.resolve())], timeout=900)
        if done.returncode != 0:
            return done.returncode
    return 0


# -- swa kernel phase ----------------------------------------------------------------

SWA_TOL = {"float32": 1e-5,        # online softmax, slots in another order
           "bfloat16": 2e-2}       # one bf16 rounding of the output apart
SWA_CASES = [
    # name, KV, G, hd, dtype, scalar cur, per-row current positions for a
    # ring of W slots (-1: an empty row); optional: W and window from the
    # phase's W, and the rings' offset in elements into their storage
    dict(case="opt350m_serve_f32", KV=16, G=1, hd=64, dtype="float32",
         curs=lambda W: [W + 126, W + 3, 46, -1]),
    dict(case="mistral7b_f32", KV=8, G=4, hd=128, dtype="float32",
         curs=lambda W: [W + 126, W + 3, 46, -1]),
    dict(case="mistral7b_bf16", KV=8, G=4, hd=128, dtype="bfloat16",
         curs=lambda W: [W + 126, W + 3, 46, -1]),
    # the reference's form: one scalar cur, every ring full and wrapped
    dict(case="opt350m_scalar_cur_f32", KV=16, G=1, hd=64, dtype="float32",
         scalar=True, curs=lambda W: [W + 1808] * 4),
    dict(case="qwen2_7b_bf16", KV=4, G=7, hd=128, dtype="bfloat16",
         curs=lambda W: [W + 126, W + 3, 46, -1]),
    # W - 2 slots (no multiple of a tile) and a window of W / 3: the valid
    # ranges start and end inside tiles, one across the ring's wrap
    dict(case="ragged_w8190_bf16", KV=8, G=4, hd=128, dtype="bfloat16",
         W=lambda W: W - 2, window=lambda W: W // 3,
         curs=lambda W: [W + 1000, 5000, 100, 2 * W - 3]),
    # 72-byte rows and a ring 2 bytes off 16-byte alignment: the narrow path
    dict(case="hd36_misaligned_bf16", KV=8, G=4, hd=36, dtype="bfloat16",
         offset=1, curs=lambda W: [W + 126, W + 3, 46, -1]),
]
REHEARSAL_SWA_W = 128


def swa_inputs(gen, KV, G, hd, dtype, scalar, curs, W, offset=0):
    """q and rings on the card; row b's ring holds its last W positions up
    to curs[b] (slot = pos % W), the rest of the ring empty (-1); random
    K/V everywhere, so the kernel must ignore what is not valid. `scalar`
    passes one 0-d cur for the batch; the rings start `offset` elements
    into their storage."""
    import torch
    dev = gen.device
    B = len(curs)
    pos = torch.full((B, W), -1, dtype=torch.int32)
    for b, c in enumerate(curs):
        p = torch.arange(max(0, c - W + 1), c + 1, dtype=torch.int32)
        pos[b, (p % W).long()] = p
    dt = getattr(torch, dtype)

    def ring():
        flat = torch.empty(B * W * KV * hd + offset, dtype=dt, device=dev)
        out = flat[offset:].view(B, W, KV, hd)
        out.copy_(torch.randn((B, W, KV, hd), generator=gen, device=dev))
        return out

    k, v = ring(), ring()
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


def swa_kernel_phase(dev, seed: int, W0: int) -> dict:
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import swa_decode as sd
    from repro_torch.kernels.swa_decode import swa_decode_attention_plain
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB
    cases = []
    for spec in SWA_CASES:
        name, dtype = spec["case"], spec["dtype"]
        W = spec.get("W", lambda w: w)(W0)
        window = spec.get("window", lambda w: w)(W)
        curs = spec["curs"](W)
        q, k, v, pos, cur = swa_inputs(gen, spec["KV"], spec["G"], spec["hd"],
                                       dtype, spec.get("scalar", False), curs,
                                       W, spec.get("offset", 0))
        args = (q, k, v, pos, cur)
        out = ops.swa_decode_attention(*args, window=window)
        ref = swa_decode_attention_plain(*args, window=window)
        sync(dev)
        assert out.shape == ref.shape == q.shape and out.dtype == q.dtype
        assert bool(torch.isfinite(out).all()), f"{name}: non-finite"
        err = float((out.float() - ref.float()).abs().max())
        tol = SWA_TOL[dtype]
        ok = bool(torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol))
        same = bool(torch.equal(out, ops.swa_decode_attention(
            *args, window=window)))
        empty = [b for b, c in enumerate(curs) if c < 0]
        zero = all(float(out[b].float().abs().max()) == 0.0 for b in empty)

        def kernel():
            return ops.swa_decode_attention(*args, window=window)

        bound_ms, bound_by, nbytes, ring_bytes = swa_bound(q, k, pos, cur,
                                                           window)
        cuda = dev.type == "cuda"
        case = dict(
            case=name, B=q.shape[0], H=q.shape[1], KV=spec["KV"],
            hd=spec["hd"], W=W, window=window, dtype=dtype,
            ring_offset_bytes=k.data_ptr() % 16, cur=cur.tolist(),
            empty_rows=empty, max_abs_err=err, tol=tol, allclose=ok,
            deterministic=same, empty_rows_zero=zero,
            plan=sd._plan_for(q, k, v)._asdict() if cuda else None,
            blocks_per_sm=sd.blocks_per_sm(q, k, v) if cuda else None,
            ms=time_ms(kernel, flush),
            device_cold_ms=kernel_device_ms(kernel, flush, cold=True,
                                            names=SWA_KERNELS),
            device_warm_ms=kernel_device_ms(kernel, flush, cold=False,
                                            names=SWA_KERNELS),
            plain_ms=time_ms(lambda: swa_decode_attention_plain(
                *args, window=window), flush),
            bound_ms=bound_ms, bound_by=bound_by, bound_bytes=nbytes,
            full_ring_bytes=ring_bytes,
            full_ring_bound_ms=ring_bytes / HBM_BYTES_PER_S * 1e3,
            library_sdpa_mask_ms=(swa_sdpa_yardstick(*args, window, flush)
                                  if cuda else None))
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


def bf16_model(model, params):
    """The slice's model with bf16 params and compute (so bf16 rings): its
    weights cast to bf16."""
    import torch
    from repro_torch.models import build_model
    cfg = dataclasses.replace(model.cfg, param_dtype="bfloat16",
                              compute_dtype="bfloat16")

    def cast(t):
        if isinstance(t, dict):
            return {k: cast(v) for k, v in t.items()}
        if isinstance(t, list):
            return [cast(v) for v in t]
        return t.to(torch.bfloat16) if t.is_floating_point() else t

    return build_model(cfg, device=model.device), cast(params)


def swa_bf16_offload_run(dev, seed: int, bf16: dict, reqs, max_len) -> dict:
    """The slice's bf16 model and offload runtime served with `swa=True`
    (bf16 rings; from layer 1 on a float32 query, the offloaded FFN's
    promotion), counts set to 0 just before and read just after: swa and
    fused launches = decode steps x 24, no plain call; at uid 0's last
    token layer 1's live rings are copied and the kernel is held against
    its plain version there with a float32 query scaled by 20 (2e-2: P
    rounded to bf16 on the tensor cores), and must be nearer it than the
    plain version on the query rounded to bf16 (the kernel's scores come
    from the unrounded query). The short requests' tokens against the same bf16
    offload swa decode on the CPU (plain versions, the same weights and the
    card runtime's placements; the long prompts' CPU prefill would not fit
    the time limit) unless the CPU run's top-2 logit margin at the first
    difference is below BF16_MARGIN."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.swa_decode import swa_decode_attention_plain
    from repro_torch.models import build_model
    from repro_torch.serving.engine import OffloadedFFNRuntime
    from repro_torch.serving.server import InferenceServer
    from repro_torch.store.packer import extract_dense_ffn_bundles

    model, params, runtime = bf16["model"], bf16["params"], bf16["runtime"]
    cfg = model.cfg
    W = cfg.sliding_window

    def serve(m, p, rt, device, requests, snap=None, record=None):
        server = InferenceServer(m, p, max_slots=4, max_len=max_len,
                                 swa=True, mode="offload", offload=rt,
                                 device=device)
        if record is not None:
            decode = server._decode_offload

            def recorded(active):
                out = decode(active)
                record.append(np.asarray(out[0], np.float32))
                return out
            server._decode_offload = recorded

        def on_token(uid, tok):
            if len(server._handles[uid].tokens) == SWA_NEW_TOKENS:
                ring = server._cache[1]["sub_0"]
                snap.update(k=ring.k.clone(), v=ring.v.clone(),
                            pos=ring.pos.clone())

        handles = [server.submit(r, on_token=on_token if (
            snap is not None and r.uid == 0) else None) for r in requests]
        ops.reset_counts()
        server.drain()
        sync(torch.device(device) if isinstance(device, str) else device)
        return handles, server.stats

    snap = {}
    handles, st = serve(model, params, runtime, dev, reqs, snap=snap)
    sc, fc = ops.counts["swa_decode"], ops.counts["sparse_ffn_segments_fused"]
    row = {"mode": "offload_bf16", "dtype": "bfloat16",
           "requests": len(reqs), "window": W,
           "decode_steps": st.decode_steps,
           "decode_ms_per_step": 1e3 * st.decode_seconds / st.decode_steps,
           "swa_launches": sc.launches, "swa_plain_calls": sc.plain_calls,
           "ffn_launches": fc.launches, "ffn_plain_calls": fc.plain_calls}
    for h in handles:
        assert h.result.finish_reason == "length", (h.uid, h.result)
    on_card = dev.type == "cuda"
    for c in (sc, fc):
        taken, other = ((c.launches, c.plain_calls) if on_card
                        else (c.plain_calls, c.launches))
        assert other == 0, row
        assert taken == st.decode_steps * cfg.n_layers > 0, row
    pos = snap["pos"]
    cur = pos.max(dim=1).values
    q = 20 * torch.randn((4, cfg.n_heads, cfg.head_dim),
                         generator=torch.Generator(device=dev)
                         .manual_seed(seed), device=dev)
    args = (q, snap["k"], snap["v"], pos, cur)
    out = ops.swa_decode_attention(*args, window=W)
    ref = swa_decode_attention_plain(*args, window=W)
    rounded = swa_decode_attention_plain(q.bfloat16().float(), *args[1:],
                                         window=W)
    row.update(ring_dtype=str(snap["k"].dtype), query_dtype=str(q.dtype),
               last_step_cur=cur.tolist(),
               last_step_max_abs_err=float((out - ref).abs().max()),
               last_step_out_scale=float(ref.abs().max()),
               last_step_rounded_q_max_abs_err=float(
                   (rounded - ref).abs().max()))
    tol = SWA_TOL["bfloat16"]
    assert out.dtype == torch.float32, row
    assert torch.allclose(out, ref, rtol=tol, atol=tol), row
    assert (row["last_step_max_abs_err"]
            < row["last_step_rounded_q_max_abs_err"]), row
    assert int(cur[0]) >= W and int(cur[1]) >= W, row    # both wrapped
    del snap, args, out, ref, rounded

    short = [r for r in reqs if len(r.prompt) < W - SWA_NEW_TOKENS]
    cpu_params = to_device(params, "cpu")
    cpu_model = build_model(cfg, device="cpu")
    cpu_runtime = OffloadedFFNRuntime(
        cfg, extract_dense_ffn_bundles(cfg, cpu_params),
        [e.placement for e in runtime.engines], device="cpu")
    rows = []
    cpu_handles, _ = serve(cpu_model, cpu_params, cpu_runtime, "cpu", short,
                           record=rows)
    by_uid = {h.uid: h for h in handles}
    mismatches = []
    for slot, (r, hc) in enumerate(zip(short, cpu_handles)):
        t = first_divergence(by_uid[r.uid].result.tokens, hc.result.tokens)
        if t is None:
            continue
        if t == 0:      # the prefill's token: dense in both
            margin = decode_margin(cpu_model, cpu_params, r.prompt,
                                   hc.result.tokens, 0, max_len, swa=True)
        else:           # token t comes out of decode step t (uid order)
            top2 = np.sort(rows[t - 1][slot])[-2:]
            margin = float(top2[1] - top2[0])
        mismatches.append({"uid": r.uid, "step": t, "margin": margin})
        emit({"token_mismatch": dict(mismatches[-1],
                                     run="swa bf16 offload card",
                                     reference="swa bf16 offload cpu")})
        assert margin < BF16_MARGIN, mismatches
    row["short_mismatches_vs_cpu"] = mismatches
    emit({"swa": row})
    return {"row": row, "launches": row["swa_launches"] if on_card
            else row["swa_plain_calls"]}


def swa_phase(dev, seed: int, model, params, runtime, bf16: dict) -> dict:
    """`InferenceServer(swa=True)` resident, then offload, then resident
    with the weights in bf16 (bf16 rings): counts set to 0 just before each
    run, read just after. At uid 0's last token (every slot live, both long
    rings wrapped) layer 0's ring is copied, and after the run the kernel is
    held against its plain version on that copy. Then the bf16 model
    served offload (`swa_bf16_offload_run`)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.swa_decode import swa_decode_attention_plain
    from repro_torch.serving.server import InferenceServer

    cfg = model.cfg
    W = cfg.sliding_window
    reqs = swa_requests(cfg, seed)
    max_len = max(len(r.prompt) for r in reqs) + SWA_NEW_TOKENS
    n_layers = cfg.n_layers
    model16, params16 = bf16_model(model, params)
    rows, runs, launches = [], {}, {}
    for mode, m, p in (("resident", model, params),
                       ("offload", model, params),
                       ("resident_bf16", model16, params16)):
        server = InferenceServer(
            m, p, max_slots=4, max_len=max_len, swa=True,
            mode="offload" if mode == "offload" else "resident",
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
        row = {"mode": mode, "dtype": str(m.cfg.compute_dtype),
               "requests": len(reqs),
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
                        device=dev).to(snap["k"].dtype)
        args = (q, snap["k"], snap["v"], pos, cur)
        out = ops.swa_decode_attention(*args, window=W).float()
        ref = swa_decode_attention_plain(*args, window=W).float()
        tol = SWA_TOL[str(m.cfg.compute_dtype)]
        row.update(ring_dtype=str(snap["k"].dtype), last_step_cur=cur.tolist(),
                   last_step_max_abs_err=float((out - ref).abs().max()),
                   reused_slot_valid_positions=None)
        assert torch.allclose(out, ref, rtol=tol, atol=tol), row
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
    off16 = swa_bf16_offload_run(dev, seed, bf16, reqs, max_len)
    rows.append(off16["row"])
    launches["offload_bf16"] = off16["launches"]
    ms = {r["mode"]: r["decode_ms_per_step"] for r in rows}
    breakdown_phase(dev, model, params, runtime, reqs, max_len,
                    {k: ms[k] for k in ("resident", "offload")},
                    path="swa", kernels=SWA_KERNELS, swa=True)
    breakdown_phase(dev, model16, params16, None, reqs, max_len,
                    {"resident": ms["resident_bf16"]}, path="swa_bf16",
                    kernels=SWA_KERNELS, swa=True)
    return {"launches": launches, "rows": rows}


# -- segment kernel phase -----------------------------------------------------------

SEG_TOL = 1e-4     # f32 sums in another order (bf16 weights upcast exactly);
# bf16 weights: plus `activation_tie_slack`, an activation within float32
# error of a bf16 rounding tie rounding the other way
SEG_SLACK_MAX = 2e-3   # that slack an output, capped here
SEG_KERNELS = ("sparse_ffn_segments_kernel",)
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
    # a 7B model served in bf16
    ("mistral7b_bf16", 4, 4096, 14336, 16, "bfloat16", "relu", False, None),
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
    """Each case: the kernel against its plain version, the same bits on a
    second launch, the launch plan, times and the bound."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.sparse_ffn import sparse_ffn_segments_plain
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB
    rows = []
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
        slack = torch.zeros_like(ref)
        if w_up.dtype != torch.float32:
            from repro_torch.kernels.sparse_ffn import activation_tie_slack
            slack = activation_tie_slack(*args, **kw).float()
        diff = (y - ref).abs()
        err = float(diff.max())
        ok = bool((diff <= SEG_TOL + SEG_TOL * ref.abs()
                   + slack.clamp(max=SEG_SLACK_MAX)).all())
        same = bool(torch.equal(y, ops.sparse_ffn_segments(*args, **kw)))

        def kernel():
            return ops.sparse_ffn_segments(*args, **kw)

        bound_ms, bound_by, nbytes = segment_bound(x, w_up, seg_ids, gated)
        case = dict(
            case=name, B=B, D=D, N=N, S=S, dtype=dtype, activation=act,
            gated=gated, ids=seg_ids.tolist(), w_up_strides=list(
                w_up.stride()), plan=segment_plan_of(x, w_up, seg_ids, w_gate),
            max_abs_err=err, tol=SEG_TOL, tie_slack_max=float(slack.max()),
            allclose=ok, deterministic=same, ms=time_ms(kernel, flush),
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
        rows.append(case)
    del flush
    return {"cases": rows}


def segment_plan_of(x, w_up, seg_ids, w_gate):
    """The segment kernel's launch plan for these inputs (None on the
    CPU)."""
    from repro_torch.kernels import sparse_ffn
    if x.device.type != "cuda":
        return None
    B, D = x.shape
    waves = sparse_ffn._segments_waves(
        x.device.index or 0, D, 128, sparse_ffn.SEGMENT_DTYPES[w_up.dtype],
        w_gate is not None, sparse_ffn.group_rows(B, D))
    return dict(sparse_ffn.segments_plan(B, D, seg_ids.shape[0], waves)
                ._asdict(), waves=waves)


# -- sparse serving phase -----------------------------------------------------------

SPARSE_MARGIN = 1e-3
SPARSE_BF16_MARGIN = 2e-2   # as the other bf16 servers' checks
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
    (counts set to 0 just before the card run, read just after) against
    the same decode on the CPU (`sparse_vs_cpu`), then the model cast to
    bf16 the same way, then `sparse_frac=1.0` against the dense resident
    run."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serving.server import InferenceServer

    cfg = dataclasses.replace(model.cfg, serve_sparse=True)
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

    rows, launches = {}, {}
    model16, params16 = bf16_model(smodel, sparams)
    for dtype, m, p in (("float32", smodel, sparams),
                        ("bfloat16", model16, params16)):
        handles, st = serve(m, p, dev)
        sc = ops.counts["sparse_ffn_segments"]
        row = {"dtype": dtype, "decode_steps": st.decode_steps,
               "decode_ms_per_step": 1e3 * st.decode_seconds / st.decode_steps,
               "segment_launches": sc.launches,
               "segment_plain_calls": sc.plain_calls}
        for h in handles:
            assert h.result.finish_reason == "length", (h.uid, h.result)
        taken, other = ((sc.launches, sc.plain_calls) if dev.type == "cuda"
                        else (sc.plain_calls, sc.launches))
        assert other == 0, row
        assert taken == st.decode_steps * cfg.n_layers > 0, row
        row["mismatches_vs_cpu"] = sparse_vs_cpu(m.cfg, p, handles, reqs,
                                                 max_len, serve, dtype)
        rows[dtype], launches[dtype] = row, taken

    # sparse_frac = 1.0 gathers every segment: the dense FFN
    row = rows["float32"]
    full = build_model(dataclasses.replace(cfg, sparse_frac=1.0), device=dev)
    full_handles, _ = serve(full, sparams, dev)
    row["full_fraction_segment_launches"] = ops.counts[
        "sparse_ffn_segments"].launches
    dense_handles, _ = serve(model, params, dev)
    row["mismatches_full_vs_dense"] = check_tokens(
        model, params, reqs, full_handles, dense_handles, max_len,
        "serve_sparse frac 1.0", "dense resident")
    emit({"sparse": row})
    emit({"sparse": rows["bfloat16"]})
    breakdown_phase(dev, smodel, sparams, None, reqs, max_len,
                    {"resident": row["decode_ms_per_step"]}, path="sparse",
                    kernels=SEG_KERNELS)
    breakdown_phase(dev, model16, params16, None, reqs, max_len,
                    {"resident": rows["bfloat16"]["decode_ms_per_step"]},
                    path="sparse_bf16", kernels=SEG_KERNELS)
    return {"launches": launches["float32"], "launches_by_run": launches,
            "rows": rows}


def sparse_vs_cpu(cfg, params, handles, reqs, max_len, serve, what: str):
    """The same serve_sparse decode on the CPU (plain versions, the same
    weights), recording each step's top-2 logit margins and each layer's
    gap between the k-th and (k+1)-th segment scores: the card's tokens
    must be the CPU's unless the margin at the first difference is below
    SPARSE_MARGIN (in bf16 SPARSE_BF16_MARGIN) or the gap below
    SPARSE_GAP (relative)."""
    import torch
    from repro_torch.models import build_model, layers
    n_seg = cfg.d_ff // cfg.sparse_seg
    k_seg = max(1, int(n_seg * cfg.sparse_frac))
    cpu_model = build_model(cfg, device="cpu")
    cpu_params = to_device(params, "cpu")
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
        limit = (SPARSE_MARGIN if cfg.compute_dtype == "float32"
                 else SPARSE_BF16_MARGIN)
        mismatches.append({"uid": h.uid, "step": t, "margin": margin,
                           "margin_limit": limit, "segment_gap": gap})
        emit({"token_mismatch": dict(mismatches[-1],
                                     run=f"sparse {what} card",
                                     reference=f"sparse {what} cpu")})
        assert margin < limit or (gap is not None
                                  and gap < SPARSE_GAP), mismatches
    return mismatches


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
    return {"launches": launches, "build": build_row, "serve": row,
            "faults": crow, "path": path}


# -- prefetch phase ------------------------------------------------------------------

PREFETCH_COUNTERS = ("retries", "corrupt_extents", "degraded_steps",
                     "worker_restarts")
PREFETCH_MODEL_IO = ("io_seconds_per_token", "ops_per_token",
                     "cache_hit_rate", "mean_run_length")


def prefetch_phase(dev, seed: int, sl: dict, bf: dict, pack_path: str) -> dict:
    """The slice's opt-350m served offload through the layer-ahead
    prefetch worker. In memory: serial, `prefetch=True,
    lookahead="oracle"`, `prefetch=True` with the lookahead predictors
    that the slice's `build_offload_runtime(train_lookahead=True)` trained
    on the card, serial again (the step times in turns); from the
    pack phase's NeuronPack the same three ways, then a run whose first
    layer's second read is fatal (a worker-issued read: the worker dies and
    is restarted once); then the model cast to bf16, serial and with the
    trained lookahead. Every run starts from a fresh runtime (empty cache)
    with the slice's placements; counts set to 0 just before each run's
    decode, read just after.

    Checks: fused launches = decode steps x 24 and no plain call, per run;
    depth-0 (oracle) runs give the serial run's tokens, per-uid io_seconds
    and `io_summary()` counters exactly; speculative runs give the serial
    tokens (margin rule as in 4; bf16 against the serial bf16 run's own
    logits, below 1e-3), the serial fault counters (all 0), and per-uid
    I/O summing to the engines' reads (the speculated neurons are read
    too, so not the serial I/O); the fatal run restarts its worker exactly
    once and gives the clean tokens; no worker thread is left."""
    import threading

    import numpy as np
    from repro_torch.core.pipeline import IOScheduler
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import OffloadedFFNRuntime
    from repro_torch.serving.server import InferenceServer
    from repro_torch.store import FaultEvent, FaultPlan
    from repro_torch.store.packer import extract_dense_ffn_bundles

    model, params, reqs = sl["model"], sl["params"], sl["reqs"]
    max_len = sl["max_len"]
    placements = [e.placement for e in sl["runtime"].engines]
    n_layers = len(placements)
    bundles = extract_dense_ffn_bundles(model.cfg, params)

    def fresh(m=model, b=bundles, **kw):
        return OffloadedFFNRuntime(m.cfg, b, placements, device=dev, **kw)

    def run(label, rt, m=model, p=params, record=None, **kw):
        server = InferenceServer(m, p, max_slots=len(reqs), max_len=max_len,
                                 mode="offload", offload=rt, device=dev,
                                 scheduler=IOScheduler(overlap=True), **kw)
        if record is not None:
            decode = server._decode_offload

            def recorded(active):
                out = decode(active)
                record.append(np.asarray(out[0], np.float32))
                return out
            server._decode_offload = recorded
        handles = [server.submit(r) for r in reqs]
        ops.reset_counts()
        server.drain()
        sync(dev)
        ffn = ops.counts["sparse_ffn_segments_fused"]
        st = server.stats
        io = rt.io_summary()
        sched = server.scheduler.summary()
        server.close()
        row = {"run": label, "decode_steps": st.decode_steps,
               "decode_ms_per_step": 1e3 * st.decode_seconds / st.decode_steps,
               "ffn_launches": ffn.launches, "ffn_plain_calls": ffn.plain_calls,
               "topups": rt.topup_total,
               "io_seconds_per_token_modeled": io["io_seconds_per_token"],
               "engine_io_seconds": sum(t.io.seconds for e in rt.engines
                                        for t in e.history),
               **{k: io[k] for k in PREFETCH_COUNTERS}}
        if "measured_wall_seconds_per_token" in sched:
            row.update({k: sched[f"measured_{k}_seconds_per_token"]
                        for k in ("wall", "io_busy", "hidden", "exposed")})
        if "measured_file_seconds_per_token" in io:
            row["measured_file_seconds_per_token"] = \
                io["measured_file_seconds_per_token"]
        emit({"prefetch": row})
        taken, other = ((ffn.launches, ffn.plain_calls) if dev.type == "cuda"
                        else (ffn.plain_calls, ffn.launches))
        assert other == 0 and taken == st.decode_steps * n_layers > 0, row
        for h in handles:
            assert h.result.finish_reason == "length", (h.uid, h.result)
        return handles, io, row

    def same_as(run_out, ref_out, exact_io: bool, margin_rows=None):
        (handles, io, row), (ref, ref_io, ref_row) = run_out, ref_out
        what, against = row["run"], ref_row["run"]
        if margin_rows is None:
            check_tokens(model, params, reqs, handles, ref, max_len, what,
                         against)
        else:       # bf16: the serial run's own logits judge a difference
            for h, r in zip(handles, ref):
                t = first_divergence(h.result.tokens, r.result.tokens)
                if t is not None:
                    top2 = np.sort(margin_rows[t - 1][h.uid])[-2:]
                    margin = float(top2[1] - top2[0])
                    emit({"token_mismatch": {"uid": h.uid, "step": t,
                                             "margin": margin, "run": what,
                                             "reference": against}})
                    assert t > 0 and margin < BF16_MARGIN, (what, h.uid, t)
        for k in PREFETCH_COUNTERS:
            assert io[k] == ref_io[k], (what, k, io[k], ref_io[k])
        if exact_io:
            for h, r in zip(handles, ref):
                assert h.result.tokens == r.result.tokens, (what, h.uid)
                assert h.result.io_seconds == r.result.io_seconds, (what,
                                                                     h.uid)
            for k in PREFETCH_MODEL_IO:
                assert io[k] == ref_io[k], (what, k)
        else:
            uid_io = sum(h.result.io_seconds for h in handles)
            reads = row["engine_io_seconds"]
            assert abs(uid_io - reads) <= 1e-9 * reads, (what, uid_io, reads)

    threads_before = threading.active_count()
    # trained on the card by the slice's build_offload_runtime(
    # train_lookahead=True): entry k predicts layer k+1 from layer k
    lookahead = sl["runtime"].lookahead
    assert len(lookahead) == n_layers - 1
    assert lookahead[0].w1.device == dev

    # in memory, the step times in turns: serial / prefetch / prefetch /
    # serial
    serial = run("memory_serial", fresh())
    rt_trained = fresh(lookahead=lookahead)
    trained = run("memory_trained", rt_trained, prefetch=True)
    oracle = run("memory_oracle", fresh(), prefetch=True, lookahead="oracle")
    serial2 = run("memory_serial_2", fresh())
    same_as(serial2, serial, exact_io=True)
    same_as(oracle, serial, exact_io=True)
    same_as(trained, serial, exact_io=False)
    # the trained runtime once more under the profiler: its idle share
    breakdown_phase(dev, model, params, rt_trained, reqs, max_len,
                    {"offload": trained[2]["decode_ms_per_step"]},
                    path="prefetch", prefetch=True)
    del rt_trained

    # from the pack file
    def from_pack(**kw):
        return OffloadedFFNRuntime.from_pack(model.cfg, pack_path, device=dev,
                                             **kw)
    with from_pack() as rt:
        pserial = run("pack_serial", rt)
    with from_pack() as rt:
        poracle = run("pack_oracle", rt, prefetch=True, lookahead="oracle")
    with from_pack(lookahead=lookahead) as rt:
        ptrained = run("pack_trained", rt, prefetch=True)
    plans = [FaultPlan([FaultEvent(1, "fatal")], seed=seed)] + [None] * (
        n_layers - 1)
    with from_pack(fault_plans=plans) as rt:
        pfatal = run("pack_fatal", rt, prefetch=True, lookahead="oracle")
    same_as(poracle, pserial, exact_io=True)
    same_as(ptrained, pserial, exact_io=False)
    assert plans[0].injected["fatal"] == 1, plans[0].injected
    assert pfatal[1]["worker_restarts"] == 1, pfatal[2]
    assert pfatal[1]["degraded_steps"] >= 1, pfatal[2]
    for h, r in zip(pfatal[0], pserial[0]):
        assert h.result.tokens == r.result.tokens, ("pack_fatal", h.uid)
    for h, r in zip(pserial[0], serial[0]):   # the pack serves the slice
        assert h.result.tokens == r.result.tokens
        assert h.result.io_seconds == r.result.io_seconds

    # the model cast to bf16, with the trained lookahead
    m16, p16 = bf["model"], bf["params"]
    b16 = extract_dense_ffn_bundles(m16.cfg, p16)
    placements16 = [e.placement for e in bf["runtime"].engines]

    def fresh16(**kw):
        return OffloadedFFNRuntime(m16.cfg, b16, placements16, device=dev,
                                   **kw)
    rows16 = []
    bserial = run("bf16_serial", fresh16(), m16, p16, record=rows16)
    btrained = run("bf16_trained", fresh16(lookahead=lookahead), m16, p16,
                   prefetch=True)
    same_as(btrained, bserial, exact_io=False, margin_rows=rows16)
    del b16, bundles

    assert not any(t.name == "ripple-prefetch"
                   for t in threading.enumerate())
    assert threading.active_count() == threads_before
    rows = [o[2] for o in (serial, trained, oracle, serial2, pserial,
                           poracle, ptrained, pfatal, bserial, btrained)]
    summary = {
        "ms_per_step_in_turns": {
            k: r["decode_ms_per_step"] for k, r in zip(
                ("serial", "trained", "oracle", "serial_2"), rows[:4])},
        "pack_ms_per_step": {r["run"]: r["decode_ms_per_step"]
                             for r in rows[4:8]},
        "topups": {r["run"]: r["topups"] for r in rows},
        "fatal_worker_restarts": pfatal[1]["worker_restarts"]}
    emit({"prefetch_summary": summary})
    return {"launches_by_run": {r["run"]: r["ffn_launches"] for r in rows
                                if r["run"] != "memory_serial_2"}}


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
    ap.add_argument("--coact-interleaved", metavar="PARENT", type=Path,
                    help="instead of the smoke run: time the coact route "
                         "of the tree PARENT and of this one, parent / this "
                         "/ this / parent, on the card")
    ap.add_argument("--coact-tree", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.coact_tree:               # one turn of --coact-interleaved
        coact_tree_times(args.coact_tree, args.seed)
        return 0
    if args.coact_interleaved:
        return coact_interleaved(args.coact_interleaved, args.seed)
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

    kern = kernel_phase(dev, args.seed, reduced=args.cpu_rehearsal)
    sl = slice_phase(dev, args.seed, n_requests, prompt_len, new_tokens,
                     reduced=args.cpu_rehearsal)
    breakdown_phase(dev, sl["model"], sl["params"], sl["runtime"],
                    sl["reqs"], sl["max_len"], sl["main_ms_per_step"])
    bf = sl.pop("bf16")
    breakdown_phase(dev, bf["model"], bf["params"], bf["runtime"],
                    sl["reqs"], sl["max_len"], {"offload": bf["ms_per_step"]},
                    path="slice_bf16")
    bf16_launches = bf["launches"]
    pkern = paged_kernel_phase(dev, args.seed, reduced=args.cpu_rehearsal)
    pg = paged_phase(dev, args.seed, sl["model"], sl["params"], sl["runtime"],
                     reduced=args.cpu_rehearsal)
    ckern = coact_kernel_phase(dev, args.seed, reduced=args.cpu_rehearsal)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as tmp:
        pk = pack_phase(dev, args.seed, sl, tmp)
        pf = prefetch_phase(dev, args.seed, sl, bf, pk["path"])
        os.remove(pk["path"])
        cli_phase(dev, args.seed, tmp, reduced=args.cpu_rehearsal)
    skern = swa_kernel_phase(dev, args.seed, W0=(
        REHEARSAL_SWA_W if args.cpu_rehearsal
        else sl["model"].cfg.sliding_window))
    sw = swa_phase(dev, args.seed, sl["model"], sl["params"], sl["runtime"],
                   bf)
    del bf
    gkern = segment_kernel_phase(dev, args.seed, reduced=args.cpu_rehearsal)
    sp = sparse_phase(dev, args.seed, sl["model"], sl["params"], sl["reqs"],
                      sl["max_len"])
    if args.cpu_rehearsal:
        print("chip_smoke: CPU rehearsal finished (no result)", file=sys.stderr)
        return 3
    main_case = kern["cases"][0]
    main_bf16 = next(c for c in kern["cases"]
                     if c["case"] == "main_path_bf16_relu_S32")
    paged_case = pkern["cases"][0]
    paged_bf16 = next(c for c in pkern["cases"]
                      if c["case"] == "mistral7b_long_bf16")
    coact_case = ckern["cases"][0]
    coact_mistral = ckern["cases"][-1]
    swa_case = skern["cases"][0]
    swa_bf16 = next(c for c in skern["cases"] if c["case"] == "mistral7b_bf16")
    seg_case = gkern["cases"][0]
    seg_bf16 = next(c for c in gkern["cases"] if c["case"] == "mistral7b_bf16")
    emit({"kernels": [{
        "name": "sparse_ffn_segments_fused", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": sl["launches"],
        "launches_by_run": {"offload_float32": sl["launches"],
                            "offload_bfloat16": bf16_launches,
                            **pf["launches_by_run"]},
        "max_abs_err": max(c["max_abs_err"] for c in kern["cases"]),
        "ms": main_case["ms"],
        "device_cold_ms": main_case["device_cold_ms"],
        "device_warm_ms": main_case["device_warm_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"], "library_ms": None,
        "yardstick_not_one_call_ms": main_case["yardstick_not_one_call_ms"],
        # the bf16 model's offload path (bf16 rows) beside it
        "main_path_bf16_relu_S32": {k: main_bf16[k] for k in (
            "ms", "device_cold_ms", "device_warm_ms", "plain_ms", "bound_ms",
            "bound_by", "yardstick_not_one_call_ms")}}, {
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
        "bound_by": paged_case["bound_by"], "library_ms": None,
        # mistral-7b heads at 4096 positions on a bf16 arena beside it
        "mistral7b_long_bf16": {k: paged_bf16[k] for k in (
            "ms", "device_cold_ms", "device_warm_ms", "plain_ms", "bound_ms",
            "bound_by", "sdpa_contiguous_ms")}}, {
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
        "library_int_mm_ms": coact_case["library_int_mm_ms"],
        # the stats' update (A += MᵀM): accumulate mode vs fresh + `+=`
        "accumulate": {k: coact_case[k] for k in (
            "acc_ms", "acc_device_cold_ms", "acc_bound_ms", "acc_bound_by",
            "fresh_plus_add_ms", "fresh_plus_add_device_cold_ms")},
        # mistral-7b-relu's d_ff at 4096 tokens beside it
        "mistral7b_4096x14336": {k: coact_mistral[k] for k in (
            "ms", "device_cold_ms", "device_warm_ms", "plain_ms", "bound_ms",
            "bound_by", "library_mm_f32_ms", "library_int_mm_ms")}}, {
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
        "library_ms": swa_case["library_sdpa_mask_ms"],
        # mistral-7b heads in bf16 (the tensor-core path) beside it
        "mistral7b_bf16": {k: swa_bf16[k] for k in (
            "ms", "device_cold_ms", "device_warm_ms", "plain_ms", "bound_ms",
            "bound_by", "library_sdpa_mask_ms")}}, {
        # the serve_sparse shape (B=4, D=1024, N=4096, S=4, w_up a view)
        "name": "sparse_ffn_segments", "route": "cuda",
        "source": SEG_SOURCE, "replaces": SEG_REPLACES,
        "launches": sp["launches"],
        "launches_by_run": sp["launches_by_run"],
        "max_abs_err": max(c["max_abs_err"] for c in gkern["cases"]),
        "ms": seg_case["ms"],
        "device_cold_ms": seg_case["device_cold_ms"],
        "device_warm_ms": seg_case["device_warm_ms"],
        "plain_ms": seg_case["plain_ms"],
        "bound_ms": seg_case["bound_ms"],
        "bound_by": seg_case["bound_by"], "library_ms": None,
        "yardstick_index_select_mm_ms":
            seg_case["yardstick_index_select_mm_ms"],
        # a 7B model's widths in bf16 beside it
        "mistral7b_bf16": {k: seg_bf16[k] for k in (
            "ms", "device_cold_ms", "device_warm_ms", "plain_ms", "bound_ms",
            "bound_by", "yardstick_index_select_mm_ms")}}]})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
