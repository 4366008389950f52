"""The port on the card: the Hopper kernels against their plain versions,
and the servers going through them (offload FFNs, paged decode attention,
the offline stage's co-activation counts and serving from its pack).

Every test here needs a CUDA card and the CUDA toolkit (`nvcc` builds the
kernel at first use); on a machine without a card each one skips with
the reason. Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances in float32: rtol = atol = 1e-4 for the FFN kernel, which sums
over D and over a segment's neurons in another order than the plain
version's matmuls; rtol = atol = 1e-5 for the paged-attention kernel,
whose online softmax sums over the rows in another order than the plain
version's softmax and einsum (2e-2 on bf16 arenas, where the plain
version rounds its scores and probabilities to bf16 and the kernel does
not; there also 1e-5 against the plain version's float32 math on the same
bf16 values, which is the TPU kernel's arithmetic).
The co-activation kernel has no tolerance: its counts are exact integers,
compared with `torch.equal`. The sliding-window kernel is held to 1e-5 in
float32 (online softmax, like the paged kernel) and 2e-2 in bfloat16 (one
rounding of the output), also with a float32 query over bf16 rings (the
kernel rounds P to bf16 for P.V, the plain version keeps the oracle's
float32 P); the unfused segment kernel to 1e-4, like the fused one, plus
on bf16 weights `activation_tie_slack`: the activation is rounded to bf16
before the down product, and one within float32 error of a rounding tie
may round either way under another summation order (that slack capped
at 2e-3 an output).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.paged_decode import (paged_decode_attention_cuda,
                                              paged_decode_attention_plain)
from repro_torch.kernels.sparse_ffn import (activation_tie_slack,
                                            sparse_ffn_segments_cuda,
                                            sparse_ffn_segments_fused_cuda,
                                            sparse_ffn_segments_fused_plain,
                                            sparse_ffn_segments_plain)
from repro_torch.kernels.swa_decode import (swa_decode_attention_cuda,
                                            swa_decode_attention_plain)

pytestmark = pytest.mark.cuda
SEG = 128
TOL = dict(rtol=1e-4, atol=1e-4)
TIE_SLACK_MAX = 2e-3    # the bf16 segment checks' slack is capped here


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _inputs(dev, seed, B, D, N, ids, rows, gated):
    """Odd shapes on purpose: B above the kernel's group of 4 or 8 batch
    rows, D not a multiple of its 1024-column chunk, ids out of order with
    padding, and a sparse scale tile. `rows`: "f32", "int8" or "bf16"."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, D)).astype(np.float32)
    if rows == "int8":
        mats = [rng.integers(-127, 128, (N, D)).astype(np.int8)
                for _ in range(3 if gated else 2)]
        base = rng.uniform(0.5, 1.5, (len(ids), SEG)) / 127 * 0.05
    else:
        mats = [(rng.standard_normal((N, D)) * D ** -0.5).astype(np.float32)
                for _ in range(3 if gated else 2)]
        base = np.ones((len(ids), SEG))
    tiles = (base * (rng.random((len(ids), SEG)) < 0.6)).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    w = [t(m).bfloat16() if rows == "bf16" else t(m) for m in mats]
    return (t(x), w[0], w[1], t(np.asarray(ids, np.int32)), t(tiles),
            w[2] if gated else None)


def _check_fused(args, **kw):
    """One launch through the dispatcher against the plain version, and the
    same bits on a second launch (no float atomics)."""
    ops.reset_counts()
    y = ops.sparse_ffn_segments_fused(*args, **kw)
    ffn = ops.counts["sparse_ffn_segments_fused"]
    assert (ffn.launches, ffn.plain_calls) == (1, 0)
    torch.cuda.synchronize()
    ref = sparse_ffn_segments_fused_plain(*args, **kw)
    assert bool(torch.isfinite(y).all())
    torch.testing.assert_close(y, ref, **TOL)
    assert torch.equal(y, ops.sparse_ffn_segments_fused(*args, **kw))
    return y


@pytest.mark.parametrize("activation", ["relu", "relu2", "gelu", "silu"])
@pytest.mark.parametrize("gated", [False, True], ids=["plain", "gated"])
@pytest.mark.parametrize("rows", ["f32", "int8", "bf16"])
def test_kernel_matches_plain_on_card(dev, activation, gated, rows):
    args = _inputs(dev, 7, B=11, D=520, N=6 * SEG, ids=[4, -1, 0, 5, 2, -1],
                   rows=rows, gated=gated)
    _check_fused(args, seg_size=SEG, activation=activation)


@pytest.mark.parametrize("rows", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("B,D,N,S,gated", [
    pytest.param(12, 1024, 4096, 32, False, id="B12_opt350m"),
    pytest.param(4, 1024, 4096, 32, True, id="B4_gated"),
    pytest.param(4, 4096, 14336, 112, False, id="mistral7b_all_segments"),
    pytest.param(3, 3584, 18944, 40, True, id="qwen2_7b_gated"),
    pytest.param(5, 6144, 1024, 8, False, id="D6144_two_groups")])
def test_kernel_at_model_widths_on_card(dev, rows, B, D, N, S, gated):
    """The path's widths: more batch rows than a group (B = 12 runs 8 + 4),
    mistral-7b-relu's every segment, qwen2-7b's gated widths (D = 3584,
    not a whole number of 1024-column chunks), and D = 6144 (2 batch rows
    a group), with a padded id; x in bf16 beside bf16 rows, as the offload
    path's first layer gives it."""
    ids = list(np.random.default_rng(S).permutation(N // SEG)[:S - 1]) + [-1]
    x, *rest = _inputs(dev, S, B=B, D=D, N=N, ids=ids, rows=rows,
                       gated=gated)
    if rows == "bf16":
        x = x.bfloat16()
    _check_fused((x, *rest), seg_size=SEG,
                 activation="silu" if gated else "relu")


@pytest.mark.parametrize("rows", ["f32", "bf16"])
def test_kernel_on_two_streams(dev, rows):
    """Launches on two streams at once give the bits of a launch alone:
    each stream has its own partials and tickets."""
    inputs = [_inputs(dev, seed, B=4, D=1024, N=4096,
                      ids=list(range(31, -1, -1)), rows=rows, gated=False)
              for seed in (5, 6)]
    kw = dict(seg_size=SEG, activation="relu")
    alone = [sparse_ffn_segments_fused_cuda(*a, **kw) for a in inputs]
    streams = [torch.cuda.Stream(dev) for _ in inputs]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for i, (a, s) in enumerate(zip(inputs, streams)):
            with torch.cuda.stream(s):
                outs[i].append(sparse_ffn_segments_fused_cuda(*a, **kw))
    torch.cuda.synchronize()
    for want, got in zip(alone, outs):
        assert all(torch.equal(o, want) for o in got)


def test_kernel_rejects_what_it_does_not_take(dev):
    x, w_up, w_down, ids, tiles, _ = _inputs(dev, 1, B=2, D=64, N=2 * SEG,
                                             ids=[0, 1], rows="f32",
                                             gated=False)
    with pytest.raises(ValueError, match="contiguous"):
        sparse_ffn_segments_fused_cuda(x.T.contiguous().T, w_up, w_down, ids,
                                       tiles)
    with pytest.raises(ValueError, match="int32"):
        sparse_ffn_segments_fused_cuda(x, w_up, w_down, ids.long(), tiles)
    with pytest.raises(ValueError, match="CUDA device"):
        sparse_ffn_segments_fused_cuda(x, w_up.cpu(), w_down, ids, tiles)
    with pytest.raises(ValueError, match="float32, bfloat16 or int8"):
        sparse_ffn_segments_fused_cuda(x, w_up.half(), w_down.half(), ids,
                                       tiles)
    with pytest.raises(ValueError, match="match w_up"):
        sparse_ffn_segments_fused_cuda(x, w_up, w_down.bfloat16(), ids, tiles)
    with pytest.raises(ValueError, match="float"):
        sparse_ffn_segments_fused_cuda(x.int(), w_up, w_down, ids, tiles)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"],
                         ids=["f32", "bf16"])
def test_offload_server_runs_the_kernel_on_card(dev, dtype):
    """A tiny offload server: every dense FFN of every decode step launched
    the fused kernel, the plain version never ran. float32: the resident
    server's tokens. bf16 (params and compute; bf16 bundles): the same
    offload server's tokens on the CPU (plain versions, the same weights),
    a first difference accepted only where the CPU run's top-2 logit
    margin there is below the bf16 tolerance, 2e-2 (offload makes the
    residual stream float32 after the first FFN, resident does not, so the
    two do not compare)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.engine import Request, build_offload_runtime
    from repro_torch.serving.server import InferenceServer
    bf16 = dtype == "bfloat16"
    cfg = get_config("opt-350m", reduced=True, d_model=64, d_ff=256,
                     n_layers=2, vocab_size=128, param_dtype=dtype,
                     compute_dtype=dtype)
    model = build_model(cfg, device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    runtime = build_offload_runtime(model, params, calib_batch=(4, 32),
                                    device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, T).astype(np.int32) for T in (5, 9, 7)]

    def serve(m=model, p=params, device=dev, slots=2, record=None, **kw):
        server = InferenceServer(m, p, max_slots=slots, max_len=32,
                                 device=device, **kw)
        if record is not None:
            decode = server._decode_offload

            def recorded(active):
                out = decode(active)
                record.append(np.asarray(out[0], np.float32))
                return out
            server._decode_offload = recorded
        handles = [server.submit(Request(uid=i, prompt=p, max_new_tokens=6))
                   for i, p in enumerate(prompts)]
        server.drain()
        return handles, server.stats

    slots = 3 if bf16 else 2     # bf16: uid = slot, token t from step t - 1
    ops.reset_counts()
    handles, stats = serve(mode="offload", offload=runtime, slots=slots)
    assert runtime.io_summary()["ffn_kernel"] == "segments"
    ffn = ops.counts["sparse_ffn_segments_fused"]
    assert ffn.plain_calls == 0
    assert ffn.launches == stats.decode_steps * cfg.n_layers > 0
    for h in handles:
        assert h.result.finish_reason == "length"
    if not bf16:
        resident, _ = serve()
        for h, r in zip(handles, resident):
            assert h.result.tokens == r.result.tokens
        return
    assert runtime._segment_weights[0][0].dtype == torch.bfloat16
    cpu_model = build_model(cfg, device="cpu")
    cpu_params = _to(params, "cpu")
    cpu_runtime = build_offload_runtime(cpu_model, cpu_params,
                                        calib_batch=(4, 32), device="cpu")
    rows = []
    cpu, _ = serve(cpu_model, cpu_params, "cpu", slots, rows, mode="offload",
                   offload=cpu_runtime)
    for h, c, prompt in zip(handles, cpu, prompts):
        t = next((i for i, (a, b) in enumerate(zip(h.result.tokens,
                                                     c.result.tokens))
                  if a != b), None)
        if t is None:
            continue
        if t == 0:          # the prefill's token: dense on both sides
            margin = _top2_margin(cpu_model, cpu_params, prompt,
                                  c.result.tokens, 0)
        else:
            top2 = np.sort(rows[t - 1][h.uid])[-2:]
            margin = float(top2[1] - top2[0])
        assert margin < 2e-2, (h.uid, t, margin)


def test_prefetch_offload_server_on_card(dev):
    """`prefetch=True` on the card, its worker thread doing host work only:
    with `lookahead="oracle"` (depth 0) the serial run's tokens and per-uid
    flash I/O exactly; with lookahead predictors trained on the card
    (`build_offload_runtime(train_lookahead=True)`) the serial tokens, and
    per-uid I/O that sums to the engines' reads (the speculated neurons are
    read too, so it is not the serial I/O, as in the reference). Every
    dense FFN launched the fused kernel, the plain version never ran, and
    after `close()` no worker thread is left."""
    import threading
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.engine import Request, build_offload_runtime
    from repro_torch.serving.server import InferenceServer
    cfg = get_config("opt-350m", reduced=True, d_model=64, d_ff=256,
                     n_layers=3, vocab_size=128)
    model = build_model(cfg, device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(1))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 128, T).astype(np.int32) for T in (5, 9, 7)]

    def runtime(**kw):
        return build_offload_runtime(model, params, calib_batch=(4, 32),
                                     rng=np.random.default_rng(0),
                                     device=dev, **kw)

    def serve(rt, **kw):
        server = InferenceServer(model, params, max_slots=3, max_len=32,
                                 device=dev, mode="offload", offload=rt, **kw)
        handles = [server.submit(Request(uid=i, prompt=p, max_new_tokens=6))
                   for i, p in enumerate(prompts)]
        ops.reset_counts()
        server.drain()
        ffn = ops.counts["sparse_ffn_segments_fused"]
        assert ffn.plain_calls == 0
        assert ffn.launches == server.stats.decode_steps * 3 > 0
        server.close()
        return [h.result for h in handles]

    serial = serve(runtime())
    before = threading.active_count()
    oracle = serve(runtime(), prefetch=True, lookahead="oracle")
    rt = runtime(train_lookahead=True)
    assert len(rt.lookahead) == 2
    assert rt.lookahead[0].w1.device == torch.device(dev)
    trained = serve(rt, prefetch=True)
    assert not any(t.name == "ripple-prefetch"
                   for t in threading.enumerate())
    assert threading.active_count() == before
    for s, o, t in zip(serial, oracle, trained):
        assert s.finish_reason == o.finish_reason == t.finish_reason
        assert s.tokens == o.tokens == t.tokens
        assert s.io_seconds == o.io_seconds > 0
    reads = sum(t.io.seconds for e in rt.engines for t in e.history)
    assert abs(sum(t.io_seconds for t in trained) - reads) <= 1e-12 * reads
    summary = rt.io_summary()
    assert (summary["worker_restarts"], summary["degraded_steps"]) == (0, 0)


# -- paged decode attention ------------------------------------------------------

PAGED_TOL = dict(rtol=1e-5, atol=1e-5)
PAGED_BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _f32_math(q, k, v, table, cur, *scales):
    """The plain version on a bf16 arena's values in float32, q rounded to
    bf16 as the kernel rounds it: float32 scores and P, as the TPU kernel
    computes them."""
    return paged_decode_attention_plain(q.bfloat16().float(), k.float(),
                                        v.float(), table, cur)


def _paged_inputs(dev, seed, B, KV, G, hd, page_size, cur, arena,
                  null_rows=()):
    """A shuffled arena (`arena`: "f32", "int8" or "bf16") with ragged
    rows: row b owns cdiv(cur[b] + 1, page_size) pages, the rest of its
    table (and every entry of a row in `null_rows`) points at the null
    page, whose contents are random too."""
    rng = np.random.default_rng(seed)
    max_pages = max(c // page_size + 1 for c in cur) + 1
    owned = [c // page_size + 1 for c in cur]
    n_pages = sum(owned) + 2
    perm = rng.permutation(n_pages)
    table = np.full((B, max_pages), n_pages, np.int32)
    i = 0
    for b, n in enumerate(owned):
        if b not in null_rows:
            table[b, :n] = perm[i:i + n]
        i += n
    shape = (n_pages + 1, page_size, KV, hd)
    if arena == "int8":
        k, v = (rng.integers(-127, 128, shape).astype(np.int8)
                for _ in range(2))
        scales = [torch.from_numpy((rng.uniform(0.5, 1.5, shape[:3]) / 127)
                                   .astype(np.float32)).to(dev).bfloat16()
                  for _ in range(2)]
    else:
        k, v = (rng.standard_normal(shape).astype(np.float32)
                for _ in range(2))
        scales = [None, None]
    q = rng.standard_normal((B, KV * G, hd)).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    k, v = t(k), t(v)
    if arena == "bf16":
        k, v = k.bfloat16(), v.bfloat16()
    return (t(q), k, v, t(table), t(np.asarray(cur, np.int32)), *scales)


@pytest.mark.parametrize("page_size", [1, 7])
@pytest.mark.parametrize("G", [1, 4, 7])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("arena", ["f32", "int8", "bf16"])
def test_paged_kernel_matches_plain_on_card(dev, page_size, G, hd, arena):
    """Odd page sizes, grouped and ungrouped heads (G = 7 as qwen2-7b's),
    both head widths, float32, int8 and bf16 arenas (bf16 at 2e-2: the
    plain version rounds its scores and probabilities to bf16; and at 1e-5
    against float32 math on the same bf16 values), rows at different
    positions: one in its first page, one long enough for many splits, so
    that the splits of the short rows past their last slot see none, and a
    row whose table is all null page."""
    args = _paged_inputs(dev, 3, B=5, KV=3, G=G, hd=hd, page_size=page_size,
                         cur=[0, 6, 40, 1500, 17], arena=arena,
                         null_rows=(4,))
    ops.reset_counts()
    out = ops.paged_decode_attention(*args)
    paged = ops.counts["paged_decode"]
    assert (paged.launches, paged.plain_calls) == (1, 0)
    torch.cuda.synchronize()
    ref = paged_decode_attention_plain(*args)
    assert bool(torch.isfinite(out).all())
    tol = PAGED_BF16_TOL if arena == "bf16" else PAGED_TOL
    torch.testing.assert_close(out, ref, **tol)
    if arena == "bf16":
        torch.testing.assert_close(out, _f32_math(*args), **PAGED_TOL)
    # deterministic: the merge sums in split order, the same bits on a
    # second launch
    assert torch.equal(out, ops.paged_decode_attention(*args))


@pytest.mark.parametrize("arena", ["f32", "int8", "bf16"])
def test_paged_kernel_on_two_streams(dev, arena):
    """Launches on two streams at once, each over rows long enough for
    many splits, give the bits of a launch alone: each stream has its own
    merge tickets."""
    inputs = [_paged_inputs(dev, seed, B=4, KV=4, G=2, hd=64, page_size=16,
                            cur=[3000, 2500, 40, 3500], arena=arena)
              for seed in (5, 6)]
    alone = [paged_decode_attention_cuda(*a) for a in inputs]
    streams = [torch.cuda.Stream(dev) for _ in inputs]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for i, (a, s) in enumerate(zip(inputs, streams)):
            with torch.cuda.stream(s):
                outs[i].append(paged_decode_attention_cuda(*a))
    torch.cuda.synchronize()
    for want, got in zip(alone, outs):
        assert all(torch.equal(o, want) for o in got)


def test_paged_kernel_rejects_what_it_does_not_take(dev):
    q, k, v, table, cur, _, _ = _paged_inputs(dev, 1, B=2, KV=2, G=2, hd=64,
                                              page_size=4, cur=[3, 9],
                                              arena="f32")
    with pytest.raises(ValueError, match="CUDA device"):
        paged_decode_attention_cuda(q, k.cpu(), v, table, cur)
    with pytest.raises(ValueError, match="contiguous"):
        paged_decode_attention_cuda(q.transpose(0, 1).contiguous()
                                    .transpose(0, 1), k, v, table, cur)
    with pytest.raises(ValueError, match="float32 or int8"):
        paged_decode_attention_cuda(q, k.half(), v.half(), table, cur)
    with pytest.raises(ValueError, match="int32"):
        paged_decode_attention_cuda(q, k, v, table.long(), cur)
    with pytest.raises(ValueError, match="int32"):
        paged_decode_attention_cuda(q, k, v, table, cur.long())
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        paged_decode_attention_cuda(q, k, v, table, cur,
                                    k_scale=k[..., 0].bfloat16())
    with pytest.raises(ValueError, match="int8 arenas need"):
        paged_decode_attention_cuda(q, k.to(torch.int8), v.to(torch.int8),
                                    table, cur)
    with pytest.raises(ValueError, match="head_dim"):
        big = torch.zeros((3, 4, 2, 512), device=dev)
        paged_decode_attention_cuda(torch.zeros((2, 4, 512), device=dev),
                                    big, big, table, cur)


@pytest.mark.parametrize("mode", ["resident", "offload", "resident_bf16",
                                  "offload_bf16", "offload_bf16_int8"])
def test_paged_server_runs_the_kernel_on_card(dev, mode):
    """A tiny paged server (a shared prompt included) gives the contiguous
    server's tokens, every attention sublayer of every decode step through
    the paged kernel (and every FFN through the fused kernel offload).
    bf16 (params, compute and arenas; bf16 bundles offload; an int8 arena
    with `kv_quant`): the paged server on the card gives the same server's
    tokens on the CPU (plain versions, the same weights and, offload, the
    card runtime's placements), a first difference accepted only where the
    CPU's top-2 logit margin there is below the bf16 tolerance, 2e-2 (a
    near tie that bf16 rounding in another order may flip): a resident
    run's margin from a B=1 decode, an offload run's from the CPU run's
    own logits (offload makes the residual stream float32 after the first
    FFN, so a resident decode computes another function)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.engine import (OffloadedFFNRuntime, Request,
                                            build_offload_runtime)
    from repro_torch.serving.server import InferenceServer
    from repro_torch.store.packer import extract_dense_ffn_bundles
    bf16 = mode.endswith(("bf16", "int8"))
    offload = mode.startswith("offload")
    dtypes = (dict(param_dtype="bfloat16", compute_dtype="bfloat16") if bf16
              else {})
    cfg = get_config("opt-350m", reduced=True, d_model=64, d_ff=256,
                     n_layers=2, vocab_size=128,
                     kv_quant=mode.endswith("int8"), **dtypes)
    model = build_model(cfg, device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    kw = {}
    if offload:
        runtime = build_offload_runtime(model, params, calib_batch=(4, 32),
                                        device=dev)
        kw = dict(mode="offload", offload=runtime)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, T).astype(np.int32) for T in (5, 9, 7)]
    prompts.append(prompts[1].copy())

    def serve(m=model, p=params, device=dev, rows=None, kw=kw, **paging):
        server = InferenceServer(m, p, max_slots=3, max_len=32,
                                 device=device, **kw, **paging)
        if rows is not None:       # each decode step's logits, by uid
            decode = server._decode_offload

            def recorded(active):
                out = decode(active)
                for slot, h in enumerate(server._slot_handle):
                    if h is not None:
                        rows.setdefault(h.uid, []).append(
                            np.asarray(out[0][slot], np.float32))
                return out
            server._decode_offload = recorded
        handles = [server.submit(Request(uid=i, prompt=q, max_new_tokens=6))
                   for i, q in enumerate(prompts)]
        server.drain()
        return handles, server

    ops.reset_counts()
    handles, server = serve(page_size=4, num_pages=24)
    paged = ops.counts["paged_decode"]
    ffn = ops.counts["sparse_ffn_segments_fused"]
    assert paged.plain_calls == ffn.plain_calls == 0
    assert paged.launches == server.stats.decode_steps * cfg.n_layers > 0
    assert ffn.launches == (paged.launches if offload else 0)
    assert server.stats.prefix_hits >= 1
    if mode.endswith("int8"):
        assert server._pool.cache_groups[0]["sub_0"].k.dtype == torch.int8
    if not bf16:
        contiguous, _ = serve()
        for h, c in zip(handles, contiguous):
            assert h.result.finish_reason == "length"
            assert h.result.tokens == c.result.tokens
        return
    cpu_model = build_model(cfg, device="cpu")
    cpu_params = _to(params, "cpu")
    cpu_kw, rows = {}, None
    if offload:
        cpu_kw = dict(mode="offload", offload=OffloadedFFNRuntime(
            cfg, extract_dense_ffn_bundles(cfg, cpu_params),
            [e.placement for e in runtime.engines], device="cpu"))
        rows = {}
    cpu, _ = serve(cpu_model, cpu_params, "cpu", rows, cpu_kw, page_size=4,
                   num_pages=24)
    for h, c, prompt in zip(handles, cpu, prompts):
        assert h.result.finish_reason == "length"
        t = next((i for i, (a, b) in enumerate(zip(h.result.tokens,
                                                     c.result.tokens))
                  if a != b), None)
        if t is None:
            continue
        if rows is None or t == 0:     # resident, or the dense prefill
            margin = _top2_margin(cpu_model, cpu_params, prompt,
                                  c.result.tokens, t)
        else:
            top2 = np.sort(rows[c.uid][t - 1])[-2:]
            margin = float(top2[1] - top2[0])
        assert margin < 2e-2, (h.uid, t, margin)


def _write_prompt_per_page(pool, table, small):
    """The oracle: one `copy_` a page a cache leaf, each page's rows up to
    the prompt's end, pages a request shares skipped."""
    T, P = table.prompt_len, pool.page_size
    first = 0
    while first < -(-T // P) and pool._refc[table.pages[first]] > 1:
        first += 1
    for i in range(first, -(-T // P)):
        lo, hi = i * P, min(T, (i + 1) * P)
        for group, small_group in zip(pool.cache_groups, small):
            for sub, arena in group.items():
                for leaf, s in zip(arena, small_group[sub]):
                    leaf[table.pages[i], :hi - lo].copy_(s[0, lo:hi])


@pytest.mark.parametrize("small_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32-cast"])
def test_prompt_write_equals_per_page_copies_on_card(dev, small_dtype):
    """opt-1.3b's KV widths (2 of its 24 layers), bf16 arenas at page 16:
    a 1,500-token prompt (93 full pages and a 12-row tail) on pages that
    come back out of order off the free list, behind a registry-shared
    prefix of 4 pages. `PagePool.write_prompt` leaves every arena equal to
    what the per-page loop writes over the same random bytes."""
    from repro_torch.configs import get_config
    from repro_torch.models.kvcache import KVCache
    from repro_torch.serving.paging import PagePool
    cfg = get_config("opt-1.3b", n_layers=2)
    P, T, max_len = 16, 1500, 2048
    pool = PagePool(cfg, num_pages=256, page_size=P, max_len=max_len,
                    dtype=torch.bfloat16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for group in pool.cache_groups:
        for arena in group.values():
            for leaf in arena:
                leaf.copy_(torch.randn(leaf.shape, generator=gen,
                                       device=dev))

    def small_cache():
        shape = (1, max_len, cfg.n_kv_heads, cfg.head_dim)
        return [{sub: KVCache(*(torch.randn(shape, generator=gen, device=dev)
                                .to(small_dtype) for _ in range(2)))
                 for sub in group} for group in pool.cache_groups]

    rng = np.random.default_rng(0)
    head = rng.integers(0, 1000, 64).astype(np.int32)
    held, _ = pool.admit(head, 1, uid=0)          # registered, then retired
    pool.write_prompt(held, small_cache())
    pool.register_prefixes(head, held)
    gone, _ = pool.admit(rng.integers(0, 1000, 200).astype(np.int32), 1,
                         uid=1)
    pool.release(held)
    pool.release(gone)
    prompt = np.concatenate([head, rng.integers(0, 1000, T - 64)]).astype(
        np.int32)
    table, plan = pool.admit(prompt, 16, uid=2)
    assert plan.shared_len == 64 and table.pages != sorted(table.pages)
    small = small_cache()
    leaves = [x for g in pool.cache_groups for a in g.values() for x in a]
    before = [x.clone() for x in leaves]
    pool.write_prompt(table, small)
    got = [x.clone() for x in leaves]
    for x, b in zip(leaves, before):
        x.copy_(b)
    _write_prompt_per_page(pool, table, small)
    for x, g in zip(leaves, got):
        assert torch.equal(x, g)


# -- co-activation counts --------------------------------------------------------

def _coact_masks(dev, T, N, dtype, seed=0):
    rng = np.random.default_rng(seed + T * 7 + N)
    if dtype == "u8_values":       # any byte values: counted as values
        m = rng.integers(0, 256, (T, N)).astype(np.uint8)
    else:
        m = (rng.random((T, N)) < 0.3).astype(
            bool if dtype == "bool" else np.uint8)
    return torch.from_numpy(m).to(dev)


# N = 1; ragged N whose rows the copy engine stores (N % 4 == 0) and N
# whose rows the threads store (N % 4 != 0); tile multiples; one diagonal
# tile (N <= 128); T above the kernel's ring of 3 x 128 tokens, up to 17
# ring stages a tile
COACT_SHAPES = [(1, 1), (17, 50), (64, 128), (100, 300), (256, 256),
                (1000, 4100), (400, 128), (513, 384), (129, 131), (300, 4),
                (2049, 1100), (2100, 259), (2048, 256)]


@pytest.mark.parametrize("T,N", COACT_SHAPES)
@pytest.mark.parametrize("dtype", ["bool", "uint8"])
def test_coact_kernel_equals_plain_on_card(dev, T, N, dtype):
    """Exact: `torch.equal` with the plain version (float32 products of 0/1
    masks, TF32 off), ragged and tile-multiple shapes; the same bits on a
    second launch; the counts' own invariants."""
    from repro_torch.kernels.coact import coact_accumulate_plain
    m = _coact_masks(dev, T, N, dtype)
    ops.reset_counts()
    a = ops.coact_accumulate(m)
    coact = ops.counts["coact_accumulate"]
    assert (coact.launches, coact.plain_calls) == (1, 0)
    torch.cuda.synchronize()
    assert a.dtype == torch.float32 and tuple(a.shape) == (N, N)
    assert torch.equal(a, coact_accumulate_plain(m))
    assert torch.equal(a, ops.coact_accumulate(m))
    assert torch.equal(a, a.T)
    assert torch.equal(torch.diagonal(a), m.to(torch.float32).sum(0))


def test_coact_kernel_takes_views_and_byte_values(dev):
    from repro_torch.kernels.coact import coact_accumulate_plain
    m = _coact_masks(dev, 96, 70, "bool")
    view = m.T.contiguous().T                   # a strided view
    assert not view.is_contiguous()
    assert torch.equal(ops.coact_accumulate(view), coact_accumulate_plain(m))
    sliced = _coact_masks(dev, 80, 300, "uint8")[5:70, 13:250]
    assert torch.equal(ops.coact_accumulate(sliced),
                       coact_accumulate_plain(sliced))
    values = _coact_masks(dev, 64, 96, "u8_values")
    assert torch.equal(ops.coact_accumulate(values),
                       coact_accumulate_plain(values))
    assert torch.equal(ops.coact_accumulate(m[:0]),
                       torch.zeros((70, 70), device=dev))


@pytest.mark.parametrize("T,N", [(17, 50), (513, 384), (129, 131),
                                 (1000, 4100), (2049, 1100), (2100, 259)])
def test_coact_accumulate_mode_on_card(dev, T, N):
    """`accumulate_into`: the kernel adds into a pair matrix that already
    holds counts (stored by the copy engine's reduce-add where N % 4 == 0,
    by the threads elsewhere) and returns it: equal to the fresh product
    plus `+=`, the same bits from the same start twice, one launch."""
    m = _coact_masks(dev, T, N, "bool", seed=3)
    start = torch.from_numpy(np.random.default_rng(T + N).integers(
        0, 5000, (N, N)).astype(np.float32)).to(dev)
    want = start.clone()
    want += ops.coact_accumulate(m)
    pair = start.clone()
    ops.reset_counts()
    got = ops.coact_accumulate(m, accumulate_into=pair)
    coact = ops.counts["coact_accumulate"]
    assert (coact.launches, coact.plain_calls) == (1, 0)
    assert got is pair
    torch.cuda.synchronize()
    assert torch.equal(pair, want)
    again = start.clone()
    ops.coact_accumulate(m, accumulate_into=again)
    assert torch.equal(again, pair)


def test_coact_stats_update_adds_in_place_on_card(dev):
    """`CoActivationStats.update` goes through the accumulate mode: its pair
    matrix stays the same tensor, one launch an update and no plain call,
    and after several blocks (byte values, ragged T) it equals the fresh
    products summed with `+=` and the CPU stats' bits."""
    from repro_torch.core.coactivation import CoActivationStats
    n = 260
    blocks = [_coact_masks(dev, T, n, d, seed=i) for i, (T, d) in enumerate(
        ((300, "bool"), (1, "uint8"), (129, "u8_values"), (64, "bool")))]
    stats = CoActivationStats(n, device=dev)
    cpu = CoActivationStats(n, device="cpu")
    ptr = stats.pair_counts.data_ptr()
    want = torch.zeros((n, n), device=dev)
    ops.reset_counts()
    for b in blocks:
        stats.update(b)
        cpu.update(b.cpu())
        want += ops.coact_accumulate(b)
    coact = ops.counts["coact_accumulate"]
    assert (coact.launches, coact.plain_calls) == (2 * len(blocks),
                                                   len(blocks))
    assert stats.pair_counts.data_ptr() == ptr
    torch.cuda.synchronize()
    assert torch.equal(stats.pair_counts, want)
    assert torch.equal(stats.pair_counts.cpu(), cpu.pair_counts)


def test_coact_byte_values_that_would_overflow_int32(dev):
    """Bytes of 255: the kernel's int32 sums hold T·255² up to T = 33,025
    (then every entry is that count, rounded once to float32); from 33,026
    tokens they could wrap, so the wrapper raises instead of returning a
    wrapped sum. 0/1 uint8 masks at that T still launch."""
    from repro_torch.kernels.coact import (BYTE_VALUE_TOKENS,
                                           coact_accumulate_cuda)
    assert BYTE_VALUE_TOKENS == 33026
    full = torch.full((BYTE_VALUE_TOKENS, 8), 255, dtype=torch.uint8,
                      device=dev)
    with pytest.raises(ValueError, match="int32"):
        coact_accumulate_cuda(full)
    with pytest.raises(ValueError, match="int32"):
        coact_accumulate_cuda(full, accumulate_into=torch.zeros(
            (8, 8), device=dev))
    below = coact_accumulate_cuda(full[1:])
    torch.cuda.synchronize()
    exact = np.float32((BYTE_VALUE_TOKENS - 1) * 255 * 255)
    assert torch.equal(below, torch.full((8, 8), float(exact), device=dev))
    ones = (full > 254).to(torch.uint8)
    assert torch.equal(coact_accumulate_cuda(ones),
                       torch.full((8, 8), float(BYTE_VALUE_TOKENS),
                                  device=dev))


def test_coact_stats_count_integer_values_and_reject_fractions(dev):
    """`CoActivationStats` on the card counts an int32 mask of values 0..3
    by value, as the reference does (its numpy expressions:
    `masks.astype(np.int64).sum(0)` and a float32 `m.T @ m`), exactly, and
    a float mask holding 0.5, a negative value or one above 255 raises
    instead of being binarised."""
    from repro_torch.core.coactivation import CoActivationStats
    m = np.random.default_rng(2).integers(0, 4, (300, 130)).astype(np.int32)
    stats = CoActivationStats(130, device=dev)
    ops.reset_counts()
    stats.update(torch.from_numpy(m).to(dev))
    stats.update(m.astype(np.float32))
    coact = ops.counts["coact_accumulate"]
    assert (coact.launches, coact.plain_calls) == (2, 0)
    f = m.astype(np.float32)
    np.testing.assert_array_equal(stats.counts_numpy(),
                                  2 * m.astype(np.int64).sum(axis=0))
    np.testing.assert_array_equal(stats.pair_counts_numpy(),
                                  (f.T @ f) + (f.T @ f))
    for bad in (0.5, -1.0, 256.0):
        b = np.zeros((4, 130), np.float32)
        b[1, 7] = bad
        with pytest.raises(ValueError, match="0..255"):
            stats.update(b)
    assert stats.n_tokens == 600


def test_coact_kernel_rejects_what_it_does_not_take(dev):
    from repro_torch.kernels.coact import coact_accumulate_cuda
    m = _coact_masks(dev, 8, 16, "bool")
    with pytest.raises(ValueError, match="bool or uint8"):
        coact_accumulate_cuda(m.float())
    with pytest.raises(ValueError, match=r"\[T, N\]"):
        coact_accumulate_cuda(m[None])
    with pytest.raises(ValueError, match="CUDA device"):
        coact_accumulate_cuda(m.cpu())
    for into, match in ((torch.zeros((16, 16), device=dev,
                                     dtype=torch.float64), "float32"),
                        (torch.zeros((16, 15), device=dev), "float32"),
                        (torch.zeros((16, 16)), "is on"),
                        (torch.zeros((16, 32), device=dev)[:, ::2],
                         "contiguous")):
        with pytest.raises(ValueError, match=match):
            coact_accumulate_cuda(m, accumulate_into=into)


def test_pack_built_and_served_on_card(dev, tmp_path):
    """A tiny `build_pack` on the card counts every layer through the
    kernel and makes the in-memory runtime's placements; the server built
    from its file gives that runtime's tokens and per-uid I/O seconds."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.engine import Request, build_offload_runtime
    from repro_torch.serving.server import InferenceServer
    from repro_torch.store import NeuronPack, build_pack
    cfg = get_config("opt-350m", reduced=True, d_model=64, d_ff=256,
                     n_layers=2, vocab_size=128)
    model = build_model(cfg, device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    path = str(tmp_path / "m.npack")
    ops.reset_counts()
    build_pack(model, params, path, calib_tokens=128, calib_batch=4,
               calib_seqlen=32, device=dev)
    coact = ops.counts["coact_accumulate"]
    assert (coact.launches, coact.plain_calls) == (cfg.n_layers, 0)
    runtime = build_offload_runtime(model, params, calib_batch=(4, 32),
                                    device=dev)
    pack = NeuronPack(path)
    for l, e in enumerate(runtime.engines):
        np.testing.assert_array_equal(pack.placement(l).placement,
                                      e.placement.placement)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, T).astype(np.int32) for T in (5, 9, 7)]

    def serve(**kw):
        server = InferenceServer(model, params, max_slots=2, max_len=32,
                                 mode="offload", device=dev, **kw)
        handles = [server.submit(Request(uid=i, prompt=p, max_new_tokens=6))
                   for i, p in enumerate(prompts)]
        server.drain()
        server.close()
        return handles

    memory = serve(offload=runtime)
    ops.reset_counts()
    packed = serve(pack_path=path, verify_checksums=True)
    assert ops.counts["sparse_ffn_segments_fused"].plain_calls == 0
    for h, m in zip(packed, memory):
        assert h.result.tokens == m.result.tokens
        assert h.result.io_seconds == m.result.io_seconds > 0


# -- sliding-window decode kernel (swa) ----------------------------------------

SWA_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
           # one bf16 rounding of the output apart (tests/test_kernels.py)
           "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _swa_inputs(dev, seed, B, H, KV, hd, W, curs, dtype, offset=0):
    """q and rings in `dtype`, each row's ring holding positions up to its
    cur (a cur of -1 leaves the row empty), wrapped where cur >= W. The
    rings start `offset` elements into their storage (1: misaligned)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, W, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, W, KV, hd)).astype(np.float32)
    pos = np.full((B, W), -1, np.int32)
    for b, c in enumerate(curs):
        for p in range(max(0, c - W + 1), c + 1):
            pos[b, p % W] = p
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    dt = getattr(torch, dtype)

    def ring(a):
        flat = torch.empty(a.size + offset, dtype=dt, device=dev)
        out = flat[offset:].view(a.shape)
        out.copy_(t(a))
        return out

    cur = torch.tensor([max(c, 0) for c in curs], dtype=torch.int32,
                       device=dev)
    return t(q).to(dt), ring(k), ring(v), t(pos), cur


def _swa_case(*geometry, curs=None, offset=0, id=None):
    return pytest.param(*geometry, curs, offset,
                        id=id or "-".join(map(str, geometry)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,hd,W,window,curs,offset", [
    _swa_case(1, 4, 1, 64, 512, 256), _swa_case(2, 8, 2, 64, 1024, 512),
    _swa_case(3, 6, 6, 32, 256, 128), _swa_case(4, 16, 16, 64, 2048, 2048),
    _swa_case(2, 32, 8, 128, 1000, 1000), _swa_case(2, 16, 2, 128, 300, 77),
    _swa_case(1, 4, 1, 256, 96, 96),
    # W = 8190 is no multiple of any tile (32 / 64 slots at hd 128)
    _swa_case(2, 16, 2, 128, 8190, 8190, id="W8190-not-a-tile-multiple"),
    # valid ranges that start and end inside tiles, one across the wrap
    _swa_case(4, 8, 2, 64, 1024, 100, curs=[130, 191, 1087, 64],
              id="ranges-straddle-tiles"),
    _swa_case(3, 28, 4, 128, 1000, 700, id="G7-hd128"),
    _swa_case(2, 64, 8, 128, 520, 300, id="G8-hd128"),
    _swa_case(2, 8, 2, 36, 300, 200, id="hd36"),
    _swa_case(2, 16, 4, 128, 600, 400, offset=1, id="ring-misaligned")])
def test_swa_kernel_matches_plain_on_card(dev, dtype, B, H, KV, hd, W,
                                          window, curs, offset):
    """Rows at their own positions: wrapped, short and (row 1) empty; the
    per-row and the scalar cur forms; the same bits on a second launch.
    Rings whose rows are not a multiple of 16 bytes (hd 36 in bf16) or
    whose base is misaligned go through the kernel's narrow path."""
    curs = curs or [W + W // 3, -1, 5, 2 * W - 1][:B]
    q, k, v, pos, cur = _swa_inputs(dev, B * W, B, H, KV, hd, W, curs, dtype,
                                    offset)
    ops.reset_counts()
    out = ops.swa_decode_attention(q, k, v, pos, cur, window=window)
    c = ops.counts["swa_decode"]
    assert (c.launches, c.plain_calls) == (1, 0)
    assert out.dtype == q.dtype and out.shape == q.shape
    torch.cuda.synchronize()
    ref = swa_decode_attention_plain(q, k, v, pos, cur, window=window)
    torch.testing.assert_close(out.float(), ref.float(), **SWA_TOL[dtype])
    for b, cb in enumerate(curs):
        if cb < 0:
            assert float(out[b].float().abs().max()) == 0.0  # an empty row
    assert torch.equal(out, ops.swa_decode_attention(q, k, v, pos, cur,
                                                     window=window))
    scalar = curs[0]
    ref0 = swa_decode_attention_plain(q, k, v, pos, scalar, window=window)
    out0 = ops.swa_decode_attention(q, k, v, pos, scalar, window=window)
    torch.testing.assert_close(out0.float(), ref0.float(), **SWA_TOL[dtype])
    out0t = ops.swa_decode_attention(
        q, k, v, pos, torch.tensor(scalar, dtype=torch.int32, device=dev),
        window=window)
    assert torch.equal(out0, out0t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swa_kernel_on_two_streams(dev, dtype):
    """Launches on two streams at once, each over wrapped 4096-slot rings
    long enough for many splits, give the bits of a launch alone: each
    stream has its own merge tickets."""
    inputs = [_swa_inputs(dev, seed, B=4, H=8, KV=2, hd=64, W=4096,
                          curs=[5000, 3000, 40, 8191], dtype=dtype)
              for seed in (5, 6)]
    alone = [swa_decode_attention_cuda(*a, window=4096) for a in inputs]
    streams = [torch.cuda.Stream(dev) for _ in inputs]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for i, (a, s) in enumerate(zip(inputs, streams)):
            with torch.cuda.stream(s):
                outs[i].append(swa_decode_attention_cuda(*a, window=4096))
    torch.cuda.synchronize()
    for want, got in zip(alone, outs):
        assert all(torch.equal(o, want) for o in got)


@pytest.mark.parametrize("B,H,KV,hd,W,window,curs", [
    pytest.param(4, 16, 16, 64, 8192, 8192, [8300, 8180, 40, -1],
                 id="opt350m-heads"),
    pytest.param(2, 32, 8, 128, 2048, 1000, [3000, 700], id="mistral-heads"),
    pytest.param(2, 8, 2, 36, 300, 200, [400, 100], id="hd36-narrow")])
def test_swa_kernel_f32_query_over_bf16_rings(dev, B, H, KV, hd, W, window,
                                              curs):
    """A bf16 model served offload: a float32 q (its residual stream is
    float32 after the first offloaded FFN) over bf16 rings. The result is
    float32, an empty row gives 0, a second launch the same bits; against
    the plain version at the bf16 tolerance, 2e-2 (the tensor-core path
    rounds P to bf16, the plain version keeps float32 P). q is scaled by
    20, where rounding it to bf16 moves the plain result by a few
    hundredths: the kernel must be nearer the plain result than that (its
    scores come from the unrounded q)."""
    q, k, v, pos, cur = _swa_inputs(dev, 3, B, H, KV, hd, W, curs,
                                    "bfloat16")
    q = 20 * torch.randn(q.shape, generator=torch.Generator(device=dev)
                         .manual_seed(4), device=dev)
    ops.reset_counts()
    out = ops.swa_decode_attention(q, k, v, pos, cur, window=window)
    c = ops.counts["swa_decode"]
    assert (c.launches, c.plain_calls) == (1, 0)
    assert out.dtype == torch.float32 and out.shape == q.shape
    torch.cuda.synchronize()
    ref = swa_decode_attention_plain(q, k, v, pos, cur, window=window)
    torch.testing.assert_close(out, ref, **SWA_TOL["bfloat16"])
    rounded = swa_decode_attention_plain(q.bfloat16().float(), k, v, pos,
                                         cur, window=window)
    assert (out - ref).abs().max() < (rounded - ref).abs().max()
    for b, cb in enumerate(curs):
        if cb < 0:
            assert float(out[b].abs().max()) == 0.0
    assert torch.equal(out, ops.swa_decode_attention(q, k, v, pos, cur,
                                                     window=window))


def test_swa_kernel_rejects_what_it_does_not_take(dev):
    q, k, v, pos, cur = _swa_inputs(dev, 0, 2, 4, 2, 32, 64, [70, 3],
                                    "float32")
    with pytest.raises(ValueError, match="int32"):
        swa_decode_attention_cuda(q, k, v, pos.long(), cur, window=8)
    with pytest.raises(ValueError, match="dtype"):
        swa_decode_attention_cuda(q, k.half(), v, pos, cur, window=8)
    with pytest.raises(ValueError, match="contiguous"):
        swa_decode_attention_cuda(q, k.transpose(1, 2), v, pos, cur, window=8)
    with pytest.raises(ValueError, match="CUDA device"):
        swa_decode_attention_cuda(q, k.cpu(), v, pos, cur, window=8)
    with pytest.raises(ValueError, match="query heads"):
        q16 = torch.zeros((2, 32, 256), device=dev)
        k16 = torch.zeros((2, 64, 2, 256), device=dev)
        swa_decode_attention_cuda(q16, k16, k16, pos, cur, window=8)


# -- unfused segment FFN kernel (serve_sparse) -----------------------------------

def _segment_inputs(dev, seed, B, D, N, gated, dtype, transposed):
    """x, weights [N, D] (w_up / w_gate as transposed views of [D, N]
    storage when `transposed`, as the model passes them)."""
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))

    def mat(std, view):
        w = torch.from_numpy((rng.standard_normal((N, D)) * std)
                             .astype(np.float32)).to(dt)
        return w.T.contiguous().to(dev).T if view else w.to(dev)

    w_up = mat(D ** -0.5, transposed)
    w_down = mat(N ** -0.5, False)
    w_gate = mat(D ** -0.5, transposed) if gated else None
    return x.to(dev), w_up, w_down, w_gate


@pytest.mark.parametrize("activation,gated", [("relu", False), ("relu2", False),
                                              ("gelu", False), ("silu", True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("transposed", [True, False], ids=["views", "rows"])
def test_segments_kernel_matches_plain_on_card(dev, activation, gated, dtype,
                                               transposed):
    """Odd shapes on purpose: B above the kernel's 8-row group, D not a
    multiple of its 1024-column chunk nor of a cluster's share, ids out of
    order with -1 padding and a repeat; the model's layout (views) and
    rows (w_up [N, D] contiguous: the kernel's general path for up)."""
    x, w_up, w_down, w_gate = _segment_inputs(dev, 3, B=11, D=520,
                                              N=6 * SEG, gated=gated,
                                              dtype=dtype,
                                              transposed=transposed)
    ids = torch.tensor([4, -1, 0, 5, 4, -1], dtype=torch.int32, device=dev)
    kw = dict(seg_size=SEG, activation=activation)
    ops.reset_counts()
    y = ops.sparse_ffn_segments(x, w_up, w_down, ids, w_gate, **kw)
    c = ops.counts["sparse_ffn_segments"]
    assert (c.launches, c.plain_calls) == (1, 0)
    torch.cuda.synchronize()
    _assert_segments_close(y, (x, w_up, w_down, ids, w_gate), kw)
    assert torch.equal(y, ops.sparse_ffn_segments(x, w_up, w_down, ids,
                                                  w_gate, **kw))


def _assert_segments_close(y, args, kw):
    """The kernel against the plain version at TOL, plus on bf16 weights
    each output's `activation_tie_slack` (zero in float32) up to
    TIE_SLACK_MAX. Prints the slack's maximum before the cap and the
    largest error (`pytest -s`)."""
    ref = sparse_ffn_segments_plain(*args, **kw)
    slack = activation_tie_slack(*args, **kw).float()
    print("tie_slack_max", os.environ.get("PYTEST_CURRENT_TEST"),
          float(slack.max()), "max_abs_err", float((y - ref).abs().max()))
    slack = slack.clamp(max=TIE_SLACK_MAX)
    bad = (y - ref).abs() > TOL["atol"] + TOL["rtol"] * ref.abs() + slack
    assert not bool(bad.any()), (int(bad.sum()),
                                 float((y - ref).abs().max()))


@pytest.mark.parametrize("B,D,N,seg,S", [(4, 1024, 4096, 128, 4),
                                         (4, 4096, 14336, 128, 16),
                                         (1, 64, 256, 32, 3)])
def test_segments_kernel_at_path_shapes(dev, B, D, N, seg, S):
    """The serve_sparse opt-350m shape, mistral-7b-relu's, and a narrow
    segment; repeating every id doubles the result."""
    x, w_up, w_down, _ = _segment_inputs(dev, 5, B, D, N, False, "float32",
                                         True)
    ids = torch.randperm(N // seg, device=dev)[:S].to(torch.int32)
    kw = dict(seg_size=seg)
    y = ops.sparse_ffn_segments(x, w_up, w_down, ids, **kw)
    torch.testing.assert_close(
        y, sparse_ffn_segments_plain(x, w_up, w_down, ids, **kw), **TOL)
    twice = ops.sparse_ffn_segments(x, w_up, w_down, torch.cat([ids, ids]),
                                    **kw)
    torch.testing.assert_close(twice, 2 * y, **TOL)


@pytest.mark.parametrize("B,D,N,S", [(4, 1024, 4096, 4),
                                     (4, 4096, 14336, 16)],
                         ids=["opt350m", "mistral7b"])
def test_segments_kernel_bf16_at_path_shapes(dev, B, D, N, S):
    """bf16 weights at the serve_sparse opt-350m shape and mistral-7b's (a
    7B model served in bf16), x in bf16 as a bf16 model's decode gives it;
    repeating every id doubles the result."""
    x, w_up, w_down, _ = _segment_inputs(dev, 6, B, D, N, False, "bfloat16",
                                         True)
    x = x.bfloat16()
    ids = torch.randperm(N // SEG, device=dev)[:S].to(torch.int32)
    kw = dict(seg_size=SEG)
    y = ops.sparse_ffn_segments(x, w_up, w_down, ids, **kw)
    _assert_segments_close(y, (x, w_up, w_down, ids), kw)
    twice = ops.sparse_ffn_segments(x, w_up, w_down, torch.cat([ids, ids]),
                                    **kw)
    torch.testing.assert_close(twice, 2 * y, **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segments_kernel_general_layouts_on_card(dev, dtype):
    """Layouts off the copy engine's path (w_up and w_gate as [N, D] rows,
    a column-strided down view, a base 2 elements off 16-byte alignment)
    take the kernel's general path: the fast path's bits exactly (the same
    stages in shared memory, the same sums)."""
    B, D, N = 5, 256, 4 * SEG
    x, w_up, w_down, w_gate = _segment_inputs(dev, 8, B, D, N, True, dtype,
                                              True)
    ids = torch.tensor([3, -1, 1, 3], dtype=torch.int32, device=dev)
    kw = dict(seg_size=SEG, activation="silu")
    fast = ops.sparse_ffn_segments(x, w_up, w_down, ids, w_gate, **kw)
    down_cols = w_down.T.contiguous().T                  # strides (1, N)
    flat = torch.empty(w_up.numel() + 2, dtype=w_up.dtype, device=dev)
    up_off = flat[2:].view(D, N)                         # 8 or 4 bytes off
    up_off.copy_(w_up.T)
    for args in [(x, w_up.contiguous(), w_down, ids, w_gate.contiguous()),
                 (x, w_up, down_cols, ids, w_gate),
                 (x, up_off.T, w_down, ids, w_gate)]:
        y = ops.sparse_ffn_segments(*args, **kw)
        assert torch.equal(y, fast)
    _assert_segments_close(fast, (x, w_up, w_down, ids, w_gate), kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segments_kernel_on_two_streams(dev, dtype):
    """Launches on two streams at once, each with enough segments for many
    clusters (their partials meet through tickets), give the bits of a
    launch alone: each stream has its own scratch and tickets."""
    inputs = []
    for seed in (5, 6):
        x, w_up, w_down, _ = _segment_inputs(dev, seed, 4, 1024, 4096,
                                             False, dtype, True)
        ids = torch.arange(31, -1, -1, dtype=torch.int32, device=dev)
        inputs.append((x, w_up, w_down, ids))
    kw = dict(seg_size=SEG)
    alone = [sparse_ffn_segments_cuda(*a, **kw) for a in inputs]
    streams = [torch.cuda.Stream(dev) for _ in inputs]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for i, (a, s) in enumerate(zip(inputs, streams)):
            with torch.cuda.stream(s):
                outs[i].append(sparse_ffn_segments_cuda(*a, **kw))
    torch.cuda.synchronize()
    for want, got in zip(alone, outs):
        assert all(torch.equal(o, want) for o in got)


def test_segments_kernel_rejects_what_it_does_not_take(dev):
    x, w_up, w_down, _ = _segment_inputs(dev, 1, 2, 64, 2 * SEG, False,
                                         "float32", False)
    ids = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        sparse_ffn_segments_cuda(x, w_up, w_down, ids.long())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        sparse_ffn_segments_cuda(x, w_up.half(), w_down.half(), ids)
    with pytest.raises(ValueError, match="multiple of 32"):
        sparse_ffn_segments_cuda(x, w_up, w_down, ids, seg_size=48)
    with pytest.raises(ValueError, match="CUDA device"):
        sparse_ffn_segments_cuda(x, w_up.cpu(), w_down, ids)
    assert not ops.sparse_ffn_segments(x, w_up, w_down, ids[:0]).any()


# -- the two paths served on the card -------------------------------------------

@pytest.mark.parametrize("mode,dtype", [
    pytest.param("resident", "float32", id="resident"),
    pytest.param("offload", "float32", id="offload"),
    pytest.param("resident", "bfloat16", id="resident-bf16"),
    pytest.param("offload", "bfloat16", id="offload-bf16")])
def test_swa_server_runs_the_kernel_on_card(dev, mode, dtype):
    """A tiny swa server (window 8, prompts past it, a reused slot): every
    decode attention launched the kernel, the plain version never ran, and
    the card's tokens equal the CPU's (the same weights). In bfloat16 (bf16
    weights and rings) a first difference is accepted only where the CPU's
    top-2 logit margin there is below the bf16 tolerance, 2e-2. Offload in
    bf16 attends with a float32 query over the bf16 rings from layer 1 on
    (the offloaded FFN's float32 output makes the residual float32); its
    margin comes from the same offload decode of the prompt alone on the
    CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.engine import Request, build_offload_runtime
    from repro_torch.serving.server import InferenceServer
    cfg = get_config("opt-350m", reduced=True, d_model=64, d_ff=256,
                     n_layers=2, vocab_size=128, sliding_window=8,
                     param_dtype=dtype, compute_dtype=dtype)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 128, T).astype(np.int32)
               for T in (11, 5, 3, 9, 4)]
    cpu_params = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))

    def serve(device, requests, slots=4, runtime=None, logits=None):
        model = build_model(cfg, device=device)
        params = _to(cpu_params, device)
        kw = {}
        if mode == "offload":
            runtime = runtime or build_offload_runtime(
                model, params, calib_batch=(4, 32), device=device)
            kw = dict(mode="offload", offload=runtime)
        server = InferenceServer(model, params, max_slots=slots, max_len=24,
                                 swa=True, device=device, **kw)
        if logits is not None:      # each decode step's first logit row
            decode = server._decode_offload

            def recorded(active):
                out = decode(active)
                logits.append(torch.from_numpy(
                    np.asarray(out[0][0], np.float32)))
                return out

            server._decode_offload = recorded
        handles = [server.submit(r) for r in requests]
        ops.reset_counts()
        server.drain()
        return ([h.result.tokens for h in handles],
                server.stats.decode_steps, runtime)

    requests = [Request(uid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
    cpu_tokens, _, cpu_runtime = serve("cpu", requests)
    tokens, steps, _ = serve(dev, requests)
    c = ops.counts["swa_decode"]
    assert (c.launches, c.plain_calls) == (steps * cfg.n_layers, 0)
    if dtype == "float32":
        assert tokens == cpu_tokens
        return
    model = build_model(cfg, device="cpu")
    for prompt, got, want in zip(prompts, tokens, cpu_tokens):
        t = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                 None)
        assert len(got) == len(want)
        if t is None:
            continue
        if mode == "offload" and t > 0:
            rows = []
            serve("cpu", [Request(uid=0, prompt=prompt, max_new_tokens=t + 1)],
                  slots=1, runtime=cpu_runtime, logits=rows)
            top2 = torch.topk(rows[t - 1], 2).values
            margin = float(top2[0] - top2[1])
        else:       # token 0 comes out of the (dense) prefill
            margin = _top2_margin(model, cpu_params, prompt, want, t,
                                  swa=True)
        assert margin < 2e-2


def _top2_margin(model, params, prompt, tokens, t, swa=False):
    """Top-2 logit margin of a B=1 decode (contiguous cache, or swa rings)
    on the CPU at step t, after the prompt and tokens[:t]."""
    with torch.inference_mode():
        cache = model.init_cache(1, len(prompt) + len(tokens), swa=swa)
        logits, cache = model.prefill(params, {"tokens": torch.as_tensor(
            prompt[None], dtype=torch.int64)}, cache)
        for i in range(t):
            logits, cache = model.decode_step(
                params, torch.tensor([[tokens[i]]]),
                torch.tensor([len(prompt) + i]), cache)
        top2 = torch.topk(logits[0, -1].float(), 2).values
    return float(top2[0] - top2[1])


def test_sparse_server_runs_the_kernel_on_card(dev):
    """A tiny serve_sparse resident server: every decode FFN launched the
    segment kernel, the plain version never ran, the CPU's tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.engine import Request
    from repro_torch.serving.server import InferenceServer
    cfg = get_config("opt-350m", reduced=True, d_model=64, d_ff=256,
                     n_layers=2, vocab_size=128, serve_sparse=True,
                     sparse_seg=32, sparse_frac=0.4)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 128, T).astype(np.int32) for T in (7, 5, 9)]

    def serve(device):
        params = build_model(cfg, device="cpu").init_params(
            torch.Generator().manual_seed(0))
        model = build_model(cfg, device=device)
        params = _to(params, device)
        server = InferenceServer(model, params, max_slots=2, max_len=24,
                                 device=device)
        handles = [server.submit(Request(uid=i, prompt=p, max_new_tokens=6))
                   for i, p in enumerate(prompts)]
        ops.reset_counts()
        server.drain()
        return [h.result.tokens for h in handles], server.stats.decode_steps

    cpu_tokens, _ = serve("cpu")
    tokens, steps = serve(dev)
    c = ops.counts["sparse_ffn_segments"]
    assert (c.launches, c.plain_calls) == (steps * cfg.n_layers, 0)
    assert tokens == cpu_tokens


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


# -- MoE / SSM / hybrid families -------------------------------------------------

@pytest.mark.parametrize("T,N", [(1200, 32), (400, 16), (300, 512)])
def test_coact_at_expert_widths_on_card(dev, T, N):
    """Expert placement's counts: co-routing masks of granite-moe's 32 and
    jamba's 16 experts (narrower than one tile of the kernel) and a
    within-expert neuron mask of width 512, through `CoActivationStats` on
    the card: `torch.equal` with the plain version, one launch an update,
    and the reference's placement from the CPU's counts."""
    from repro_torch.core import expert_placement as ep
    from repro_torch.core.coactivation import CoActivationStats
    from repro_torch.core.trace import SyntheticTraceConfig, synthetic_masks
    from repro_torch.kernels.coact import coact_accumulate_plain
    if N <= 32:
        sel = ep.synthetic_routing(T, N, 8 if N == 32 else 2,
                                   n_groups=max(2, N // 8), seed=11)
        masks = ep.routing_masks(sel, N)
    else:
        masks = synthetic_masks(SyntheticTraceConfig(n_neurons=N, seed=3), T)
    ops.reset_counts()
    stats = CoActivationStats(N, device=dev)
    stats.update(masks)
    coact = ops.counts["coact_accumulate"]
    assert (coact.launches, coact.plain_calls) == (1, 0)
    m = torch.from_numpy(masks).to(dev)
    assert torch.equal(stats.pair_counts, coact_accumulate_plain(m))
    cpu = CoActivationStats(N, device="cpu")
    cpu.update(masks)
    np.testing.assert_array_equal(stats.pair_counts_numpy(),
                                  cpu.pair_counts_numpy())
    if N <= 32:
        pl = ep.search_expert_placement(sel, N, device=dev)
        np.testing.assert_array_equal(
            pl.placement, ep.search_expert_placement(sel, N,
                                                     device="cpu").placement)


@pytest.mark.parametrize("arch,kernel,kw", [
    ("granite-moe-1b-a400m", "paged_decode", dict(page_size=4, num_pages=24)),
    ("jamba-1.5-large-398b", "swa_decode", dict(swa=True)),
    ("xlstm-125m", None, {}),
])
def test_family_server_on_card(dev, arch, kernel, kw):
    """Reduced granite-moe served paged, jamba with `swa=True` and xlstm
    resident on the card give the same server's tokens on the CPU (plain
    versions, the same weights), a first difference accepted only where
    the CPU's top-2 logit margin there is below 1e-3; every attention
    sublayer of every decode step went through the kernel."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.engine import Request
    from repro_torch.serving.server import InferenceServer
    cfg = get_config(arch, reduced=True, d_model=64, vocab_size=128,
                     sliding_window=8)
    n_attn = cfg.layer_kinds().count("attn")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 128, T).astype(np.int32) for T in (7, 12, 5)]
    params_cpu = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))

    def serve(device):
        model = build_model(cfg, device=device)
        server = InferenceServer(model, _to(params_cpu, device), max_slots=2,
                                 max_len=24, device=device, **kw)
        handles = [server.submit(Request(uid=i, prompt=p, max_new_tokens=6))
                   for i, p in enumerate(prompts)]
        ops.reset_counts()
        server.drain()
        return [h.result.tokens for h in handles], server.stats.decode_steps

    cpu_tokens, _ = serve("cpu")
    tokens, steps = serve(dev)
    if kernel is not None:
        c = ops.counts[kernel]
        assert (c.launches, c.plain_calls) == (steps * n_attn, 0)
    cpu_model = build_model(cfg, device="cpu")
    for prompt, got, want in zip(prompts, tokens, cpu_tokens):
        t = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                 None)
        if t is not None:
            assert _top2_margin(cpu_model, params_cpu, prompt, want, t,
                                swa=kw.get("swa", False)) < 1e-3


# -- encoder-decoder, VLM and training ---------------------------------------------

def _greedy(model, params, batch, n_new, swa):
    """Greedy tokens [B, n_new] and each step's top-2 margins [n_new, B]
    through `prefill` / `decode_step` at the shared scalar position."""
    cfg = model.cfg
    B, S = batch["tokens"].shape
    prefix = cfg.n_prefix_tokens if cfg.family == "vlm" else 0
    with torch.inference_mode():
        cache = model.init_cache(B, prefix + S + n_new, swa=swa)
        logits, cache = model.prefill(params, batch, cache)
        rows = [logits[:, -1]]
        for i in range(n_new - 1):
            logits, cache = model.decode_step(
                params, rows[-1].argmax(-1)[:, None], prefix + S + i, cache)
            rows.append(logits[:, 0])
        lg = torch.stack(rows).float().cpu()
    top2 = torch.topk(lg, 2, dim=-1).values
    return lg.argmax(-1).T.numpy(), (top2[..., 0] - top2[..., 1]).numpy()


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "internvl2-26b"])
def test_encdec_vlm_on_card(dev, arch):
    """Reduced seamless-m4t and internvl2 with 8-slot rings (the 12-token
    prompts wrap them): the card's swa decode runs the kernel once an
    attention layer a step (no plain call); its greedy tokens are the CPU's
    swa run's, and the contiguous cache's the CPU's contiguous run's, on
    the same weights, a first difference accepted only where the CPU's
    top-2 margin is below 1e-3."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch, reduced=True, d_model=64, vocab_size=128,
                     sliding_window=8)
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((3, cfg.n_prefix_tokens, cfg.d_frontend),
                                dtype=np.float32)
    batch = {"tokens": torch.from_numpy(rng.integers(0, 128, (3, 12))),
             ("frames" if cfg.is_encdec else "patch_feats"):
                 torch.from_numpy(feats)}
    params_cpu = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    model = build_model(cfg, device=dev)
    params = _to(params_cpu, dev)
    on_card = {k: v.to(dev) for k, v in batch.items()}
    for swa in (False, True):
        want, margins = _greedy(build_model(cfg, device="cpu"), params_cpu,
                                batch, 8, swa=swa)
        ops.reset_counts()
        got, _ = _greedy(model, params, on_card, 8, swa=swa)
        c = ops.counts["swa_decode"]
        assert (c.launches, c.plain_calls) == ((7 * cfg.n_layers, 0) if swa
                                               else (0, 0))
        for b in range(3):
            t = next((i for i, (x, y) in enumerate(zip(got[b], want[b]))
                      if x != y), None)
            assert t is None or margins[t, b] < 1e-3, (swa, b, t)


def test_train_step_on_card(dev, tmp_path):
    """One train step of reduced granite-3-2b with 2 microbatches on the
    card equals the CPU's from the same params (loss 1e-4 relative, every
    gradient leaf 1e-4 of its largest magnitude, grad norm 1e-3), and a
    checkpoint of the card's state loads back bit for bit on the card and
    on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.convert import params_to_numpy
    from repro_torch.models import build_model
    from repro_torch.training import (AdamWConfig, TrainState, init_adamw,
                                      load_checkpoint, make_train_step,
                                      save_checkpoint)
    from repro_torch.training.train import grads_of
    from repro_torch.utils import tree_leaves
    cfg = get_config("granite-3-2b", reduced=True, d_model=64, n_layers=2,
                     vocab_size=128)
    params_cpu = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(
        np.random.default_rng(6).integers(0, 128, (4, 32)))
    opt = AdamWConfig(lr_peak=1e-3, warmup_steps=1, total_steps=10)
    runs = {}
    for device in ("cpu", dev):
        model = build_model(cfg, device=device)
        params = _to(params_cpu, device)
        batch = {"tokens": tokens.to(device)}
        loss, _, grads = grads_of(model, params, batch)
        state, metrics = make_train_step(model, opt, microbatches=2)(
            TrainState(params, init_adamw(params, opt)), batch)
        runs[str(device)] = (float(loss), params_to_numpy(grads), state,
                             {k: float(v) for k, v in metrics.items()})
    (cl, cg, _, cm), (gl, gg, state, gm) = runs["cpu"], runs[str(dev)]
    assert gl == pytest.approx(cl, rel=1e-4)
    assert gm["loss"] == pytest.approx(cm["loss"], rel=1e-4)
    assert gm["grad_norm"] == pytest.approx(cm["grad_norm"], rel=1e-3)
    for a, b in zip(tree_leaves(cg), tree_leaves(gg)):
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-4 * max(np.abs(a).max(), 1e-30))
    path = str(tmp_path / "card.npz")
    save_checkpoint(path, state, {"step": 1})
    for device in (dev, "cpu"):
        like = TrainState(_to(state.params, device),
                          init_adamw(_to(state.params, device), opt))
        restored, meta = load_checkpoint(path, like)
        assert meta == {"step": 1}
        for a, b in zip(tree_leaves(state), tree_leaves(restored)):
            assert b.device.type == torch.device(device).type
            assert a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())


TRAIN_FAMILIES = ["opt-350m", "granite-moe-1b-a400m", "xlstm-125m",
                  "jamba-1.5-large-398b", "seamless-m4t-medium",
                  "internvl2-26b"]


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", TRAIN_FAMILIES,
                         ids=["dense", "moe", "ssm", "hybrid", "encdec",
                              "vlm"])
def test_one_train_step_card_vs_cpu(dev, arch, dtype):
    """One `make_train_step` step of each family (reduced widths, vocab
    128, 2 x 16 tokens and seeded features) on the card against the CPU
    from the same params, by `chip_smoke.one_step_check`'s rule: float32
    as phase 18 holds opt-350m (loss 1e-4, grad norm 1e-3, each leaf's
    clipped gradient 1e-2 in relative L2, the update 1e-6 from AdamW on
    the CPU over the card's moments); bf16 (params, compute and moments,
    as the dry run) by its bf16 rule (loss 1e-3, grad norm 1e-2, each
    leaf 5e-2 from the CPU's and no farther from the float32 gradient
    than 1.5 x the CPU's distance plus one bf16 rounding, the update
    within one bf16 step and 1e-6 of AdamW on the card's moments)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import seeded_model
    from repro_torch.training.optimizer import AdamWConfig
    smoke = _chip_smoke()
    dt = {} if dtype == "float32" else dict(param_dtype=dtype,
                                            compute_dtype=dtype)
    cfg = get_config(arch, reduced=True, vocab_size=128, **dt)
    model, params = seeded_model(cfg, 0, dev)
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, 128, (2, 16)).astype(np.int32))}
    feats = (2, cfg.n_prefix_tokens, cfg.d_frontend)
    if cfg.family in ("vlm", "audio"):
        batch["patch_feats" if cfg.family == "vlm" else "frames"] = \
            torch.from_numpy(rng.standard_normal(feats).astype(np.float32))
    opt = AdamWConfig(lr_peak=smoke.TRAIN_LR, warmup_steps=2,
                      total_steps=smoke.TRAIN_STEPS, moment_dtype=dtype)
    row = smoke.one_step_check(dev, model, params, opt, seed=0, batch=batch)
    print(row)


# -- sharded training across cards -------------------------------------------------

_CARDS_WORLD = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TMP = sys.argv[1]


def rank_main(rank, world):
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method="file://" + TMP + "/store",
                            rank=rank, world_size=world, device_id=dev)
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.train import state_specs
    from repro_torch.models import build_model
    from repro_torch.training.optimizer import AdamWConfig, adamw_update, init_adamw
    from repro_torch.training.train import TrainState, grads_of, make_train_step
    from repro_torch.utils import tree_leaves
    mesh = sh.make_mesh((world // 2, 2), ("data", "model"), "cuda")
    cfg = get_config("granite-3-2b", reduced=True, d_model=256, n_heads=4,
                     n_kv_heads=2, vocab_size=512, d_ff=512)
    model = build_model(cfg, device=dev)
    from repro_torch.launch import seeded_model
    _, params = seeded_model(cfg, 0, dev)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 512, (8, 32)).astype(np.int32)).to(dev)
    opt_cfg = AdamWConfig()
    state = TrainState(params, init_adamw(params, opt_cfg))
    dstate = sh.distribute_tree(state, state_specs(params, mesh), mesh)
    dbatch = {"tokens": distribute_tensor(tokens, mesh, sh.placements(
        sh.batch_spec(mesh, 8, 2), mesh))}
    _, _, g_sh = grads_of(model, dstate.params, dbatch)
    g_sh = sh.full_tree(g_sh)
    _, _, g_un = grads_of(model, params, {"tokens": tokens})
    grad_l2 = max(float((a - b).norm() / b.norm())
                  for a, b in zip(tree_leaves(g_sh), tree_leaves(g_un)))
    step = make_train_step(model, opt_cfg)
    new_sh, m_sh = step(dstate, dbatch)
    _, m_un = step(state, {"tokens": tokens})
    redo, _, _ = adamw_update(g_sh, init_adamw(params, opt_cfg), params,
                              opt_cfg)
    err = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(sh.full_tree(new_sh.params)), tree_leaves(redo)))
    if rank == 0:
        with open(TMP + "/cards.json", "w") as f:
            json.dump({"world": world, "loss_sharded": float(m_sh["loss"]),
                       "loss_unsharded": float(m_un["loss"]),
                       "grad_max_leaf_l2_rel": grad_l2,
                       "params_vs_adamw_on_gathered": err}, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    n = int(sys.argv[2])
    mp.spawn(rank_main, args=(n,), nprocs=n)
    print("CARDS_DONE")
"""


def test_sharded_train_step_on_cards(dev, tmp_path):
    """min(4, cards) NCCL ranks on a (world / 2, 2) mesh train reduced
    granite-3-2b (d_model 256, 4 / 2 heads, vocab 512, d_ff 512) one step
    on an 8 x 32 batch: the sharded loss equals the unsharded card step's
    within 1e-5 relative, each gathered gradient leaf is within 1e-4 in
    relative L2, and the params equal AdamW on the gathered gradients to
    1e-6 (the CPU test's rules, tests/test_torch_distributed.py). Skips
    below 2 cards."""
    import json
    import subprocess
    import sys
    from pathlib import Path
    n = min(4, torch.cuda.device_count())
    if n < 2:
        pytest.skip("needs 2 or more CUDA cards")
    script = tmp_path / "cards.py"
    script.write_text(_CARDS_WORLD)
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    res = subprocess.run([sys.executable, str(script), str(tmp_path), str(n)],
                         capture_output=True, text=True, timeout=600, env=env)
    assert "CARDS_DONE" in res.stdout, res.stdout[-4000:] + res.stderr[-8000:]
    m = json.loads((tmp_path / "cards.json").read_text())
    print(m)
    assert abs(m["loss_sharded"] - m["loss_unsharded"]) <= \
        1e-5 * abs(m["loss_unsharded"]), m
    assert m["grad_max_leaf_l2_rel"] <= 1e-4, m
    assert m["params_vs_adamw_on_gathered"] <= 1e-6, m


SHARDED_ARCHS = ["granite-3-2b", "granite-moe-1b-a400m", "xlstm-125m",
                 "jamba-1.5-large-398b", "seamless-m4t-medium",
                 "internvl2-26b", "qwen2-7b", "internlm2-20b"]


@pytest.mark.parametrize("arch", SHARDED_ARCHS)
def test_sharded_train_step_one_rank_on_card(dev, tmp_path, arch):
    """A one-rank NCCL group and a (1, 1) mesh: the sharded step of each
    family (reduced) on DTensor leaves equals the unsharded card step
    (loss 1e-5 relative, params 1e-5 of their scale) and keeps the state's
    placements. Every leaf goes through DTensor's sharding propagation, as
    on a larger mesh, on the card's torch."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import seeded_model
    from repro_torch.launch.train import state_specs
    from repro_torch.training.optimizer import AdamWConfig, init_adamw
    from repro_torch.training.train import TrainState, make_train_step
    from repro_torch.utils import tree_leaves
    cfg = get_config(arch, reduced=True, vocab_size=128)
    model, params = seeded_model(cfg, 0, dev)
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, 128, (4, 16)).astype(np.int32)).to(dev)}
    feats = (4, cfg.n_prefix_tokens, cfg.d_frontend)
    if cfg.family == "vlm":
        batch["patch_feats"] = torch.from_numpy(
            rng.standard_normal(feats).astype(np.float32)).to(dev)
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(
            rng.standard_normal(feats).astype(np.float32)).to(dev)
    opt = AdamWConfig()
    state = TrainState(params, init_adamw(params, opt))
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1, device_id=dev)
    try:
        mesh = sh.make_mesh((1, 1), ("data", "model"), "cuda")
        dstate = sh.distribute_tree(state, state_specs(params, mesh), mesh)
        dbatch = {k: distribute_tensor(v, mesh, sh.placements(
            sh.batch_spec(mesh, 4, v.ndim), mesh)) for k, v in batch.items()}
        step = make_train_step(model, opt)
        new_sh, m_sh = step(dstate, dbatch)
        new_un, m_un = step(state, batch)
        assert all(a.placements == b.placements for a, b in zip(
            tree_leaves(new_sh), tree_leaves(dstate)))
        full = sh.full_tree(new_sh.params)
    finally:
        dist.destroy_process_group()
    assert float(m_sh["loss"]) == pytest.approx(float(m_un["loss"]),
                                                rel=1e-5)
    for a, b in zip(tree_leaves(full), tree_leaves(new_un.params)):
        scale = max(float(b.abs().max()), 1e-3)
        assert float((a - b).abs().max()) <= 1e-5 * scale


def test_flash_prefill_on_card(dev):
    """Check (a) of chip_smoke's phase 20 at granite-3-2b's heads (32 / 8
    x 64): at T = 4096 the chunked flash form and the plain [T, S] form
    agree on the card within 2e-5 in float32 (the reference's flash rule,
    tests/test_attention.py:28) and within 2e-2 of the output's scale in
    bf16 (P rounded before P.V in one, after the softmax in the other),
    causal and with a window of 1000, and the attention layer routes
    there past 2048 positions."""
    from repro_torch.models import layers
    rng = np.random.default_rng(25)
    T, H, KV, hd = 4096, 32, 8, 64
    q, k, v = (torch.from_numpy(rng.standard_normal((1, T, n, hd))
                                .astype(np.float32)).to(dev)
               for n in (H, KV, KV))
    pos = torch.arange(T, device=dev)[None]
    with torch.inference_mode():
        for window in (0, 1000):
            for dtype in (torch.float32, torch.bfloat16):
                args = (q.to(dtype), k.to(dtype), v.to(dtype), pos, pos)
                a = layers.flash_gqa_attend(*args, window=window)
                b = layers.gqa_attend(*args, window=window)
                assert a.dtype == dtype and bool(torch.isfinite(a).all())
                if dtype == torch.float32:
                    torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)
                else:
                    scale = float(b.float().abs().max())
                    err = float((a.float() - b.float()).abs().max())
                    assert err <= 2e-2 * scale, (window, err, scale)


def test_chunked_scan_grads_on_card(dev):
    """xlstm-125m at its published widths, its first 4 layers (3 mLSTM and
    the sLSTM), B = 2, T = 512, on the card: the loss and every gradient
    leaf with the scans in checkpointed chunks of 128 equal those with
    chunking off (`SCAN_CHUNK` = T) within 1e-6 in relative L2 (the same
    ops; the sums into a leaf may run in another order). A leaf whose
    gradient is 0 in exact arithmetic (below 1e-6 of the whole gradient's
    norm: the input gates' biases, a shift of which scales a block's
    state and its normaliser alike) is rounding noise and is held within
    1e-6 of the whole gradient's norm. The layer group's remat is off:
    recomputing a group reorders the engine's sums into a layer's input,
    which is not what this checks."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, ssm
    from repro_torch.training.train import grads_of
    from repro_torch.utils import tree_leaves
    cfg = get_config("xlstm-125m", n_layers=4, remat=False)
    model = build_model(cfg, device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 512))).to(dev)
    batch = {"tokens": tokens}
    runs = {}
    before = ssm.SCAN_CHUNK
    try:
        for chunk in (128, 512):
            ssm.SCAN_CHUNK = chunk
            loss, _, grads = grads_of(model, params, batch)
            runs[chunk] = (float(loss), tree_leaves(grads))
    finally:
        ssm.SCAN_CHUNK = before
    (l_c, g_c), (l_p, g_p) = runs[128], runs[512]
    assert abs(l_c - l_p) <= 1e-6 * abs(l_p)
    total = float(torch.sqrt(sum((b ** 2).sum() for b in g_p)))
    n_null = 0
    for a, b in zip(g_c, g_p):
        assert bool(torch.isfinite(a).all())
        norm = float(b.norm())
        null = norm < 1e-6 * total
        n_null += null
        assert float((a - b).norm()) <= 1e-6 * (total if null else norm)
    assert n_null <= cfg.n_layers     # the input gates' biases, one a layer


# -- SmallThinker's shapes: G = 7 at width 128, rings of 4,096, pages past 8k,
# -- and the dropless experts' grouped products ------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swa_kernel_at_smallthinker_shape_on_card(dev, dtype):
    """28 query heads over 4 KV heads of 128 (G = 7), rings of 4,096 slots
    at a window of 4,096: rows wrapped once and twice, one just full, one
    a slot short of full, one short, as the doc32 cell's window layers
    hold them."""
    curs = [4096 + 1234, 10239, 4095, 4094, 17, 8191]
    q, k, v, pos, cur = _swa_inputs(dev, 41, len(curs), 28, 4, 128, 4096,
                                    curs, dtype)
    ops.reset_counts()
    out = ops.swa_decode_attention(q, k, v, pos, cur, window=4096)
    assert ops.counts["swa_decode"].launches == 1
    torch.cuda.synchronize()
    ref = swa_decode_attention_plain(q, k, v, pos, cur, window=4096)
    torch.testing.assert_close(out.float(), ref.float(), **SWA_TOL[dtype])
    assert torch.equal(out, ops.swa_decode_attention(q, k, v, pos, cur,
                                                     window=4096))


@pytest.mark.parametrize("arena", ["f32", "bf16"])
def test_paged_kernel_at_smallthinker_shape_on_card(dev, arena):
    """28 query heads over 4 KV heads of 128 (G = 7), page 16, rows past
    8,192 positions up to the cell's 10,240, and a short one."""
    args = _paged_inputs(dev, 43, B=4, KV=4, G=7, hd=128, page_size=16,
                         cur=[8200, 10239, 3, 9000], arena=arena)
    ops.reset_counts()
    out = ops.paged_decode_attention(*args)
    assert ops.counts["paged_decode"].launches == 1
    torch.cuda.synchronize()
    ref = paged_decode_attention_plain(*args)
    tol = PAGED_BF16_TOL if arena == "bf16" else PAGED_TOL
    torch.testing.assert_close(out, ref, **tol)
    if arena == "bf16":
        torch.testing.assert_close(out, _f32_math(*args), **PAGED_TOL)
    assert torch.equal(out, ops.paged_decode_attention(*args))


def test_dropless_experts_on_card_without_host_sync(dev):
    """The dropless MoE at SmallThinker's widths (64 experts of 768, top 6,
    d 2,560) on 32 decode rows in bf16: `torch._grouped_mm` against the
    per-expert loop in float32 on the same bf16 values (2e-2: the grouped
    product rounds its bf16 output once, the loop does not), the same
    bits on a second call, and no host sync anywhere in it (CUDA's sync
    debug mode raises on one)."""
    from repro_torch.configs import smallthinker_21b_a3b as st
    from repro_torch.models import moe as moe_lib
    cfg = dataclasses.replace(st.CONFIG, param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    g = torch.Generator(device=dev).manual_seed(5)
    d, f, E = cfg.d_model, cfg.moe.d_ff_expert, cfg.moe.n_experts
    p = {"router": torch.randn(d, E, generator=g, device=dev) * d ** -0.5,
         "w_gate": torch.randn(E, d, f, generator=g, device=dev) * d ** -0.5,
         "w_up": torch.randn(E, d, f, generator=g, device=dev) * d ** -0.5,
         "w_down": torch.randn(E, f, d, generator=g, device=dev) * f ** -0.5}
    p = {k: t.bfloat16() for k, t in p.items()}
    x = torch.randn(32, 1, d, generator=g, device=dev).bfloat16()
    routing = moe_lib.route(p, x[:, 0], cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, _ = moe_lib.moe_forward(p, x, cfg, routing)
        y2, _ = moe_lib.moe_forward(p, x, cfg, routing)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(y, y2)
    f32 = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    pf = {k: t.float() for k, t in p.items()}
    ref, _ = moe_lib.moe_forward(pf, x.float(), f32, routing)
    torch.testing.assert_close(y.float(), ref, rtol=2e-2, atol=2e-2)
    order, ends = moe_lib.expert_order(routing[2], E)
    xs = x[:, 0][order // cfg.moe.top_k]
    torch.testing.assert_close(
        moe_lib.grouped_mm(xs, p["w_up"], ends).float(),
        moe_lib.grouped_mm_loop(xs.float(), pf["w_up"], ends),
        rtol=2e-2, atol=2e-2)
