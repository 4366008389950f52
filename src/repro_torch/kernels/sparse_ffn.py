"""Segment-gather sparse FFNs: two Hopper kernels' wrappers and their plain
PyTorch versions — the fused one of the offload path (int8 or float rows,
dequant scales and the activated-union mask applied on the device) and the
unfused float one of `serve_sparse` decode (no scales).

Fused:

    y = sum_s act(x @ (W_up[seg_s] * sv_s)^T) [* (x @ (W_gate[seg_s] * sv_s)^T)]
              @ (W_down[seg_s] * sv_s)

The activated neuron set arrives as segment ids (each segment = `seg`
consecutive neurons of the placement-permuted physical layout) plus a
per-neuron multiplier tile `scale_tiles[s, j]` = dequant scale (1.0 for
float payloads) x membership in the served union. Weight rows may be int8
(the NeuronPack storage dtype), bfloat16 (a bf16 model's bundles) or
float32; they are dequantized or upcast and masked on the device, right
before the float32 products, and the result is float32 whatever x's float
dtype. Segment ids of -1 are padding and contribute exactly 0.

`sparse_ffn_segments_fused_cuda` launches the hand-written kernel in
`csrc/sparse_ffn_fused.cu` (see the note there for its bound and design);
`sparse_ffn_segments_fused_plain` is the same math in the same order as the
reference's XLA twin (`ops._sparse_ffn_segments_fused_xla`): gather the raw
[seg, D] tiles, upcast, multiply by the scale column, then the products.
`repro_torch.kernels.ops.sparse_ffn_segments_fused` dispatches between them
by the device of the input.

Unfused (the reference's `sparse_ffn_segments_kernel`):

    y = sum_s rnd(act(x @ W_up[seg_s]^T) [* (x @ W_gate[seg_s]^T)]) @ W_down[seg_s]

with float32 or bfloat16 [N, D] weight operands of any element strides (the
model passes `w_up.T` views of its [d, d_ff] weights), a negative segment id
as the zero padding segment and a repeated id counted twice, in float32.
`rnd` rounds the activation to the weights' dtype before the down product,
as the TPU kernel's `act.astype(down_ref.dtype)` does: bf16 weights meet a
bf16 activation there, float32 ones are unchanged.
`sparse_ffn_segments_cuda` launches `csrc/sparse_ffn_segments.cu`: one
launch of thread-block clusters, a cluster per segment at a time, its
blocks splitting the up (and gate) sums over D and the down rows, the sums
joined through distributed shared memory, the weights streamed by the copy
engine (a 2-D tensor-map box an up stage, a bulk copy a down row;
`segments_plan` cuts it; the note in the source says why). `sparse_ffn_segments_plain` gathers the
segments' rows and does the products; `ops.sparse_ffn_segments`
dispatches, with its own counters (`segments_counts`).
`activation_tie_slack` bounds what the rounding can change between two
orders of summation (a pre-activation within float32 error of a bf16
rounding tie may round either way).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.build import Counts, load_library
from repro_torch.models.layers import apply_activation

ACTIVATIONS = {"relu": 0, "relu2": 1, "gelu": 2, "silu": 3}
WEIGHT_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


SEGMENT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

counts = Counts()            # the fused kernel's launch / plain-call counters
segments_counts = Counts()   # the unfused kernel's


def sparse_ffn_segments_fused_plain(
    x: torch.Tensor,              # [B, D] float
    w_up: torch.Tensor,           # [N, D] raw storage dtype (int8 or float)
    w_down: torch.Tensor,         # [N, D]
    seg_ids: torch.Tensor,        # [S] int32 (-1 = padding)
    scale_tiles: torch.Tensor,    # [S, seg] f32 dequant-scale x mask
    w_gate: Optional[torch.Tensor] = None,
    *,
    seg_size: int = 128,
    activation: str = "relu",
) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel (f32 [B, D] out)."""
    S = seg_ids.shape[0]
    D = x.shape[1]
    tiles = torch.where(seg_ids < 0, 0, seg_ids).long()
    sv = torch.where((seg_ids < 0)[:, None], 0.0,
                     scale_tiles.float()).reshape(S * seg_size, 1)

    def eff(w):
        t = w.reshape(-1, seg_size, D)[tiles].reshape(S * seg_size, D)
        return t.float() * sv

    xf = x.float()
    act = apply_activation(xf @ eff(w_up).T, activation)
    if w_gate is not None:
        act = act * (xf @ eff(w_gate).T)
    return act @ eff(w_down)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"sparse_ffn_segments_fused: {msg}")


def _bind(lib: ctypes.CDLL):
    fn = lib.sparse_ffn_segments_fused_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 11
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


CHUNK = 1024            # a stage row's columns (the .cu's kChunk)
MAX_D = 8 * CHUNK       # widths the kernel's register-held y covers
MAX_RPB = 2048          # flattened rows a block may own
CLUSTER_SIZES = (8, 4, 2)


def group_rows(B: int, D: int) -> int:
    """Batch rows the kernel takes at once at width D (its y and x for
    them live in registers and shared memory): 4 or 8 up to 1024 columns,
    4 up to 4096, 2 up to 8192; a larger B runs the groups in turn."""
    if D <= CHUNK:
        return 4 if B <= 4 else 8
    return 4 if D <= 4 * CHUNK else 2


def tile_rows(nb: int, gated: bool) -> int:
    """Weight rows a tile holds: its up (and gate) dot products for the nb
    batch rows, at most 32 a thread, are reduced together."""
    return min(8, 32 // (nb * (2 if gated else 1)))


class FusedPlan(NamedTuple):
    """How one launch cuts the work (`csrc/sparse_ffn_fused.cu`)."""
    nb: int        # batch rows a group
    groups: int    # groups of batch rows, run in turn
    cluster: int   # blocks a thread-block cluster
    blocks: int    # grid size, a whole number of clusters
    rpb: int       # rows of the flattened [S * seg] tile a block owns


@functools.lru_cache(maxsize=1024)
def plan(B: int, D: int, rows: int, gated: bool, cluster: int,
         clusters_per_wave: int) -> FusedPlan:
    """The launch for `rows` = S * seg candidate rows: one wave of
    clusters (`clusters_per_wave` as CUDA's occupancy reports for this
    instantiation), but no more blocks than tiles of rows, and more waves
    only where a block would own more than MAX_RPB rows."""
    nb = group_rows(B, D)
    tiles = -(-rows // tile_rows(nb, gated))
    n_cl = max(1, min(clusters_per_wave, -(-tiles // cluster)))
    if -(-rows // (n_cl * cluster)) > MAX_RPB:
        n_cl = -(-rows // (MAX_RPB * cluster))
    return FusedPlan(nb=nb, groups=-(-B // nb), cluster=cluster,
                     blocks=n_cl * cluster,
                     rpb=-(-rows // (n_cl * cluster)))


@functools.lru_cache(maxsize=None)
def _wave(index: int, D: int, dtype: int, gated: bool, nb: int) -> tuple:
    """(cluster size, clusters the card holds at once) for the
    instantiation a launch at these widths takes: the largest size among
    CLUSTER_SIZES that keeps at least 90% as many SMs busy as the best one
    (a larger cluster leaves fewer partials for the last block to add)."""
    lib = load_library("sparse_ffn_fused")
    fn = lib.sparse_ffn_segments_fused_max_clusters
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    waves = {}
    with torch.cuda.device(index):
        for c in CLUSTER_SIZES:
            n = ctypes.c_int(0)
            err = fn(D, dtype, int(gated), nb, c, ctypes.byref(n))
            if err != 0:
                raise RuntimeError(f"sparse_ffn_segments_fused: occupancy "
                                   f"query failed with CUDA error {err}")
            waves[c] = n.value
    busy = max(c * n for c, n in waves.items())
    if busy == 0:
        raise RuntimeError("sparse_ffn_segments_fused: no cluster of the "
                           "kernel fits on the card")
    c = max(c for c, n in waves.items() if c * n >= 0.9 * busy)
    return c, waves[c]


def launch_plan(x: torch.Tensor, w_up: torch.Tensor, seg_ids: torch.Tensor,
                scale_tiles: torch.Tensor, gated: bool) -> FusedPlan:
    """The plan `sparse_ffn_segments_fused_cuda` launches these inputs
    with (x on the card)."""
    B, D = x.shape
    nb = group_rows(B, D)
    cluster, per_wave = _wave(x.device.index or 0, D,
                              WEIGHT_DTYPES[w_up.dtype], gated, nb)
    return plan(B, D, seg_ids.shape[0] * scale_tiles.shape[1], gated,
                cluster, per_wave)


Scratch = Tuple[torch.Tensor, torch.Tensor]
_scratch: Dict[Tuple[torch.device, int], Scratch] = {}


def _scratch_for(dev: torch.device, stream: int, n_part: int,
                 n_tickets: int) -> Scratch:
    """The clusters' partial sums (f32) and the slices' tickets (int32,
    zeros that every launch leaves at zero) for launches on `stream`, kept
    per (device, stream) and grown as needed: launches on two streams may
    overlap, so they never share them."""
    part, tickets = _scratch.get((dev, stream), (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=dev)
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(max(n_tickets, 64), dtype=torch.int32,
                              device=dev)
    _scratch[dev, stream] = (part, tickets)
    return part, tickets


def sparse_ffn_segments_fused_cuda(
    x: torch.Tensor,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    seg_ids: torch.Tensor,
    scale_tiles: torch.Tensor,
    w_gate: Optional[torch.Tensor] = None,
    *,
    seg_size: int = 128,
    activation: str = "relu",
) -> torch.Tensor:
    """Launch the Hopper kernel on PyTorch's current stream. Validates
    device, dtype, shape, contiguity and alignment and raises ValueError on
    what the kernel does not take; raises RuntimeError if the launch fails.
    x may be any float dtype (taken as float32); weights are float32,
    bfloat16 or int8, all three alike. The output is allocated here, the
    scratch kept per stream; nothing synchronises."""
    dev = x.device
    tensors = {"x": x, "w_up": w_up, "w_down": w_down, "seg_ids": seg_ids,
               "scale_tiles": scale_tiles}
    if w_gate is not None:
        tensors["w_gate"] = w_gate
    for name, t in tensors.items():
        _check(t.device == dev and dev.type == "cuda",
               f"{name} is on {t.device}, expected the CUDA device {dev}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
        _check(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    _check(activation in ACTIVATIONS, f"unknown activation {activation!r}")
    _check(x.is_floating_point() and x.ndim == 2, "x must be a float [B, D]")
    B, D = x.shape
    _check(w_up.dtype in WEIGHT_DTYPES,
           f"weights must be float32, bfloat16 or int8, got {w_up.dtype}")
    for name in ("w_down", "w_gate"):
        if name in tensors:
            _check(tensors[name].dtype == w_up.dtype and
                   tensors[name].shape == w_up.shape,
                   f"{name} must match w_up's dtype and shape")
    _check(w_up.ndim == 2 and w_up.shape[1] == D, "weights must be [N, D]")
    N = w_up.shape[0]
    _check(N % seg_size == 0, f"N={N} is not a multiple of seg={seg_size}")
    _check(D % 4 == 0, f"D={D} must be a multiple of 4 (4-byte row copies)")
    _check(D <= MAX_D, f"D={D} > {MAX_D}")
    _check(seg_ids.dtype == torch.int32 and seg_ids.ndim == 1,
           "seg_ids must be int32 [S]")
    S = seg_ids.shape[0]
    _check(scale_tiles.dtype == torch.float32 and
           tuple(scale_tiles.shape) == (S, seg_size),
           f"scale_tiles must be f32 [S={S}, seg={seg_size}]")
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    if S == 0 or B == 0:
        return out.zero_()
    xf = x.float()
    p = launch_plan(x, w_up, seg_ids, scale_tiles, w_gate is not None)
    launch = _bind(load_library("sparse_ffn_fused"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        part, tickets = _scratch_for(
            dev, stream, p.groups * (p.blocks // p.cluster) * p.nb * D,
            p.groups * p.cluster)
        err = launch(xf.data_ptr(), w_up.data_ptr(),
                     None if w_gate is None else w_gate.data_ptr(),
                     w_down.data_ptr(), seg_ids.data_ptr(),
                     scale_tiles.data_ptr(), part.data_ptr(),
                     tickets.data_ptr(), out.data_ptr(), B, D, N, S, seg_size,
                     WEIGHT_DTYPES[w_up.dtype], ACTIVATIONS[activation], p.nb,
                     p.blocks, p.cluster, p.rpb, stream)
    if err != 0:
        raise RuntimeError(f"sparse_ffn_segments_fused kernel launch failed "
                           f"with CUDA error {err}")
    counts.launches += 1
    return out


# -- unfused float segment FFN (serve_sparse decode) ---------------------------

def sparse_ffn_segments_plain(
    x: torch.Tensor,              # [B, D] float
    w_up: torch.Tensor,           # [N, D] float (any strides)
    w_down: torch.Tensor,         # [N, D]
    seg_ids: torch.Tensor,        # [S] int (negative = padding)
    w_gate: Optional[torch.Tensor] = None,
    *,
    seg_size: int = 128,
    activation: str = "relu",
) -> torch.Tensor:
    """Plain PyTorch version of the unfused kernel (f32 [B, D] out)."""
    S = seg_ids.shape[0]
    D = x.shape[1]
    ids = seg_ids.long()
    live = (ids >= 0).float()[:, None, None]

    def gathered(w):
        t = w.reshape(-1, seg_size, D)[ids.clamp_min(0)].float() * live
        return t.reshape(S * seg_size, D)

    xf = x.float()
    act = apply_activation(xf @ gathered(w_up).T, activation)
    if w_gate is not None:
        act = act * (xf @ gathered(w_gate).T)
    # the TPU kernel's `act.astype(down_ref.dtype)`: bf16 weights meet a
    # bf16 activation in the down product (a no-op for float32)
    return act.to(w_down.dtype).float() @ gathered(w_down)


# the window of `activation_tie_slack`: two float32 sums of D products of
# O(1) size in two orders differ by about 2^-24 * sqrt(D) (4e-6 at
# D = 4096), well inside it
TIE_REL = 1e-5


def activation_tie_slack(
    x: torch.Tensor,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    seg_ids: torch.Tensor,
    w_gate: Optional[torch.Tensor] = None,
    *,
    seg_size: int = 128,
    activation: str = "relu",
) -> torch.Tensor:
    """[B, D] float64: the most that rounding the activation to the
    weights' dtype can move each output of the unfused segment FFN when
    the activation is summed in another order. An activation whose float64
    value lies within TIE_REL * (|a| + 1) of a tie between two neighbours
    of the weights' dtype may round to either; each such one adds its
    neighbours' spacing times |its down row|. Below |a| of about 2.6e-3 a
    bf16 step is narrower than the window, so every such activation counts,
    each with its step (under 2e-5). Zero for float32 weights (no
    rounding)."""
    B, D = x.shape
    if w_down.dtype == torch.float32:
        return torch.zeros((B, D), dtype=torch.float64, device=x.device)
    ids = seg_ids.long()
    live = ids[ids >= 0]
    rows = (live[:, None] * seg_size
            + torch.arange(seg_size, device=ids.device)).reshape(-1)
    xd = x.double()
    a = apply_activation(xd @ w_up[rows].double().T, activation)
    if w_gate is not None:
        a = a * (xd @ w_gate[rows].double().T)
    ulp = torch.finfo(w_down.dtype).eps * torch.exp2(
        torch.floor(torch.log2(a.abs().clamp_min(1e-30))))
    t = a / ulp
    near = (t - t.floor() - 0.5).abs() * ulp <= TIE_REL * (a.abs() + 1)
    return (near * ulp) @ w_down[rows].double().abs()


def _check_segments(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"sparse_ffn_segments: {msg}")


def _bind_segments(lib: ctypes.CDLL):
    fn = lib.sparse_ffn_segments_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


SEG_CLUSTER_SIZES = (16, 8, 4)
MAX_SEG = 256           # the .cu's kMaxSeg
MAX_LIVE = 1024         # segments a cluster takes at most (kMaxLive)


class SegmentsPlan(NamedTuple):
    """How one launch of `csrc/sparse_ffn_segments.cu` cuts the work."""
    nb: int        # batch rows a group
    groups: int    # groups of batch rows, run in turn
    cluster: int   # blocks a cluster: each takes 1 / cluster of a segment
    clusters: int  # clusters, each taking every clusters-th segment
    blocks: int    # grid size


@functools.lru_cache(maxsize=1024)
def segments_plan(B: int, D: int, S: int, waves: Tuple[Tuple[int, int], ...]
                  ) -> SegmentsPlan:
    """The launch for S segments: for each (cluster size, clusters the card
    holds at once) in `waves`, min(S, clusters) clusters, the busiest
    taking ceil(S / clusters) segments, 1 / size of each a block; the size
    whose busiest block takes the least, the larger size on a tie (fewer
    partials for the last blocks to add)."""
    nb = group_rows(B, D)
    best = None
    for c, n in waves:
        n = min(S, n)
        if n > 0:
            key = (-(-S // n) / c, -c)
            if best is None or key < best[0]:
                best = (key, c, n)
    if best is None:
        raise RuntimeError("sparse_ffn_segments: no cluster of the kernel "
                           "fits on the card")
    _, c, n = best
    return SegmentsPlan(nb=nb, groups=-(-B // nb), cluster=c, clusters=n,
                        blocks=n * c)


@functools.lru_cache(maxsize=None)
def _segments_waves(index: int, D: int, seg: int, dtype: int, gated: bool,
                    nb: int) -> Tuple[Tuple[int, int], ...]:
    """((cluster size, clusters the card holds at once), ...) for the
    instantiation a launch at these widths takes, for each size of
    SEG_CLUSTER_SIZES that divides seg."""
    fn = load_library("sparse_ffn_segments").sparse_ffn_segments_max_clusters
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    waves = []
    with torch.cuda.device(index):
        for c in SEG_CLUSTER_SIZES:
            if seg % c:
                continue
            n = ctypes.c_int(0)
            err = fn(D, seg, dtype, int(gated), nb, c, ctypes.byref(n))
            if err != 0:
                raise RuntimeError(f"sparse_ffn_segments: occupancy query "
                                   f"failed with CUDA error {err}")
            waves.append((c, n.value))
    return tuple(waves)


def _unit_neuron_rows(w: torch.Tensor) -> bool:
    """The copy engine's layout of up and gate (a tensor map): unit stride
    along the neurons (a `.T` view of [D, N] storage), 16-byte aligned
    rows."""
    isz = w.element_size()
    return (w.stride(0) == 1 and w.stride(1) * isz % 16 == 0
            and w.data_ptr() % 16 == 0)


def _whole_rows(w: torch.Tensor) -> bool:
    """The copy engine's layout of down (a bulk copy a row): unit stride
    along D, rows of a 16-byte multiple, 16-byte aligned."""
    isz = w.element_size()
    return (w.stride(1) == 1 and w.stride(0) * isz % 16 == 0
            and w.shape[1] * isz % 16 == 0 and w.data_ptr() % 16 == 0)


def sparse_ffn_segments_cuda(
    x: torch.Tensor,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    seg_ids: torch.Tensor,
    w_gate: Optional[torch.Tensor] = None,
    *,
    seg_size: int = 128,
    activation: str = "relu",
) -> torch.Tensor:
    """Launch the Hopper kernel on PyTorch's current stream. Validates
    device, dtype and shape and raises ValueError on what the kernel does
    not take; raises RuntimeError if the launch fails. Weights are read in
    place through their strides (the model's layouts by the copy engine,
    any other by the kernel's general path); x, float32 or bfloat16, is
    read as it is. The output is allocated here, the scratch kept per stream;
    nothing synchronises. A segment id >= N / seg_size traps on the
    device."""
    dev = x.device
    tensors = {"x": x, "w_up": w_up, "w_down": w_down, "seg_ids": seg_ids}
    if w_gate is not None:
        tensors["w_gate"] = w_gate
    for name, t in tensors.items():
        _check_segments(t.device == dev and dev.type == "cuda",
                        f"{name} is on {t.device}, expected the CUDA device "
                        f"{dev}")
    _check_segments(activation in ACTIVATIONS,
                    f"unknown activation {activation!r}")
    _check_segments(x.ndim == 2 and x.dtype in SEGMENT_DTYPES,
                    "x must be float32 or bfloat16 [B, D]")
    B, D = x.shape
    _check_segments(w_up.dtype in SEGMENT_DTYPES,
                    f"weights must be float32 or bfloat16, got {w_up.dtype}")
    _check_segments(w_up.ndim == 2 and w_up.shape[1] == D,
                    f"weights must be [N, D={D}]")
    for name in ("w_down", "w_gate"):
        if name in tensors:
            _check_segments(tensors[name].dtype == w_up.dtype and
                            tensors[name].shape == w_up.shape,
                            f"{name} must match w_up's dtype and shape")
    N = w_up.shape[0]
    _check_segments(seg_size in (32, 64, 128, MAX_SEG),
                    f"seg_size={seg_size} must be a power-of-two multiple "
                    f"of 32 up to {MAX_SEG}")
    _check_segments(N % seg_size == 0,
                    f"N={N} is not a multiple of seg={seg_size}")
    piece = 16 // w_up.element_size()       # weights a 16-byte piece
    _check_segments(D % piece == 0 and D <= MAX_D,
                    f"D={D} must be a multiple of {piece} up to {MAX_D}")
    _check_segments(seg_ids.dtype == torch.int32 and seg_ids.ndim == 1
                    and seg_ids.is_contiguous(),
                    "seg_ids must be contiguous int32 [S]")
    S = seg_ids.shape[0]
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    if S == 0 or B == 0 or D == 0:
        return out.zero_()
    x = x.contiguous()
    gated = w_gate is not None
    dtype = SEGMENT_DTYPES[w_up.dtype]
    p = segments_plan(B, D, S, _segments_waves(
        dev.index or 0, D, seg_size, dtype, gated, group_rows(B, D)))
    _check_segments(-(-S // p.clusters) <= MAX_LIVE,
                    f"S={S} segments: more than {MAX_LIVE} a cluster")
    up_fast = all(_unit_neuron_rows(w) for w in (w_up, w_gate)
                  if w is not None)
    gate_strides = (0, 0) if w_gate is None else w_gate.stride()
    launch = _bind_segments(load_library("sparse_ffn_segments"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        part, tickets = _scratch_for(dev, stream,
                                     p.groups * p.clusters * p.nb * D,
                                     p.groups * p.cluster)
        err = launch(x.data_ptr(), w_up.data_ptr(),
                     None if w_gate is None else w_gate.data_ptr(),
                     w_down.data_ptr(), seg_ids.data_ptr(), part.data_ptr(),
                     tickets.data_ptr(), out.data_ptr(), B, D, N, S,
                     seg_size, *w_up.stride(), *gate_strides,
                     *w_down.stride(), int(x.dtype == torch.bfloat16), dtype,
                     ACTIVATIONS[activation], int(up_fast),
                     int(_whole_rows(w_down)), p.nb, p.blocks, p.cluster,
                     stream)
    if err != 0:
        raise RuntimeError(f"sparse_ffn_segments kernel launch failed with "
                           f"CUDA error {err}")
    segments_counts.launches += 1
    return out
