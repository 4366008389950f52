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
version's softmax and einsum.
The co-activation kernel has no tolerance: its counts are exact integers,
compared with `torch.equal`. The sliding-window kernel is held to 1e-5 in
float32 (online softmax, like the paged kernel) and 2e-2 in bfloat16 (one
rounding of the output); the unfused segment kernel to 1e-4, like the
fused one.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.paged_decode import (paged_decode_attention_cuda,
                                              paged_decode_attention_plain)
from repro_torch.kernels.sparse_ffn import (sparse_ffn_segments_cuda,
                                            sparse_ffn_segments_fused_cuda,
                                            sparse_ffn_segments_fused_plain,
                                            sparse_ffn_segments_plain)
from repro_torch.kernels.swa_decode import (swa_decode_attention_cuda,
                                            swa_decode_attention_plain)

pytestmark = pytest.mark.cuda
SEG = 128
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _inputs(dev, seed, B, D, N, ids, int8, gated):
    """Odd shapes on purpose: B above the kernel's 8-row register block, D
    not a multiple of its 128-column tile, ids out of order with padding,
    and a sparse scale tile."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, D)).astype(np.float32)
    if int8:
        mats = [rng.integers(-127, 128, (N, D)).astype(np.int8)
                for _ in range(3 if gated else 2)]
        base = rng.uniform(0.5, 1.5, (len(ids), SEG)) / 127 * 0.05
    else:
        mats = [(rng.standard_normal((N, D)) * D ** -0.5).astype(np.float32)
                for _ in range(3 if gated else 2)]
        base = np.ones((len(ids), SEG))
    tiles = (base * (rng.random((len(ids), SEG)) < 0.6)).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return (t(x), t(mats[0]), t(mats[1]), t(np.asarray(ids, np.int32)),
            t(tiles), t(mats[2]) if gated else None)


@pytest.mark.parametrize("activation", ["relu", "relu2", "gelu", "silu"])
@pytest.mark.parametrize("gated", [False, True], ids=["plain", "gated"])
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_kernel_matches_plain_on_card(dev, activation, gated, int8):
    args = _inputs(dev, 7, B=11, D=520, N=6 * SEG, ids=[4, -1, 0, 5, 2, -1],
                   int8=int8, gated=gated)
    kw = dict(seg_size=SEG, activation=activation)
    ops.reset_counts()
    y = ops.sparse_ffn_segments_fused(*args, **kw)
    ffn = ops.counts["sparse_ffn_segments_fused"]
    assert (ffn.launches, ffn.plain_calls) == (1, 0)
    torch.cuda.synchronize()
    ref = sparse_ffn_segments_fused_plain(*args, **kw)
    torch.testing.assert_close(y, ref, **TOL)
    # deterministic: no atomics, the same bits on a second launch
    assert torch.equal(y, ops.sparse_ffn_segments_fused(*args, **kw))


def test_kernel_rejects_what_it_does_not_take(dev):
    x, w_up, w_down, ids, tiles, _ = _inputs(dev, 1, B=2, D=64, N=2 * SEG,
                                             ids=[0, 1], int8=False,
                                             gated=False)
    with pytest.raises(ValueError, match="contiguous"):
        sparse_ffn_segments_fused_cuda(x.T.contiguous().T, w_up, w_down, ids,
                                       tiles)
    with pytest.raises(ValueError, match="int32"):
        sparse_ffn_segments_fused_cuda(x, w_up, w_down, ids.long(), tiles)
    with pytest.raises(ValueError, match="CUDA device"):
        sparse_ffn_segments_fused_cuda(x, w_up.cpu(), w_down, ids, tiles)
    with pytest.raises(ValueError, match="float32 or int8"):
        sparse_ffn_segments_fused_cuda(x, w_up.half(), w_down.half(), ids,
                                       tiles)


def test_offload_server_runs_the_kernel_on_card(dev):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.engine import Request, build_offload_runtime
    from repro_torch.serving.server import InferenceServer
    cfg = get_config("opt-350m", reduced=True, d_model=64, d_ff=256,
                     n_layers=2, vocab_size=128)
    model = build_model(cfg, device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    runtime = build_offload_runtime(model, params, calib_batch=(4, 32),
                                    device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, T).astype(np.int32) for T in (5, 9, 7)]

    def serve(**kw):
        server = InferenceServer(model, params, max_slots=2, max_len=32,
                                 device=dev, **kw)
        handles = [server.submit(Request(uid=i, prompt=p, max_new_tokens=6))
                   for i, p in enumerate(prompts)]
        server.drain()
        return handles, server.stats

    ops.reset_counts()
    handles, stats = serve(mode="offload", offload=runtime)
    assert runtime.io_summary()["ffn_kernel"] == "segments"
    ffn = ops.counts["sparse_ffn_segments_fused"]
    assert ffn.plain_calls == 0
    assert ffn.launches == stats.decode_steps * cfg.n_layers > 0
    resident, _ = serve()
    for h, r in zip(handles, resident):
        assert h.result.finish_reason == "length"
        assert h.result.tokens == r.result.tokens


# -- paged decode attention ------------------------------------------------------

PAGED_TOL = dict(rtol=1e-5, atol=1e-5)


def _paged_inputs(dev, seed, B, KV, G, hd, page_size, cur, int8,
                  null_rows=()):
    """A shuffled arena with ragged rows: row b owns cdiv(cur[b] + 1,
    page_size) pages, the rest of its table (and every entry of a row in
    `null_rows`) points at the null page, whose contents are random too."""
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
    if int8:
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
    return (t(q), t(k), t(v), t(table), t(np.asarray(cur, np.int32)),
            *scales)


@pytest.mark.parametrize("page_size", [1, 7])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_paged_kernel_matches_plain_on_card(dev, page_size, G, hd, int8):
    """Odd page sizes, grouped and ungrouped heads, both head widths, rows
    at different positions (one in its first page) and a row whose table
    is all null page."""
    args = _paged_inputs(dev, 3, B=5, KV=3, G=G, hd=hd, page_size=page_size,
                         cur=[0, 6, 40, 129, 17], int8=int8, null_rows=(4,))
    ops.reset_counts()
    out = ops.paged_decode_attention(*args)
    paged = ops.counts["paged_decode"]
    assert (paged.launches, paged.plain_calls) == (1, 0)
    torch.cuda.synchronize()
    ref = paged_decode_attention_plain(*args)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, ref, **PAGED_TOL)
    # deterministic: no atomics, the same bits on a second launch
    assert torch.equal(out, ops.paged_decode_attention(*args))


def test_paged_kernel_rejects_what_it_does_not_take(dev):
    q, k, v, table, cur, _, _ = _paged_inputs(dev, 1, B=2, KV=2, G=2, hd=64,
                                              page_size=4, cur=[3, 9],
                                              int8=False)
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


@pytest.mark.parametrize("mode", ["resident", "offload"])
def test_paged_server_runs_the_kernel_on_card(dev, mode):
    """A tiny paged server (a shared prompt included) gives the contiguous
    server's tokens, every attention sublayer of every decode step through
    the paged kernel."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.engine import Request, build_offload_runtime
    from repro_torch.serving.server import InferenceServer
    cfg = get_config("opt-350m", reduced=True, d_model=64, d_ff=256,
                     n_layers=2, vocab_size=128)
    model = build_model(cfg, device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    kw = {}
    if mode == "offload":
        kw = dict(mode="offload", offload=build_offload_runtime(
            model, params, calib_batch=(4, 32), device=dev))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, T).astype(np.int32) for T in (5, 9, 7)]
    prompts.append(prompts[1].copy())

    def serve(**paging):
        server = InferenceServer(model, params, max_slots=3, max_len=32,
                                 device=dev, **kw, **paging)
        handles = [server.submit(Request(uid=i, prompt=p, max_new_tokens=6))
                   for i, p in enumerate(prompts)]
        server.drain()
        return handles, server

    ops.reset_counts()
    handles, server = serve(page_size=4, num_pages=24)
    paged = ops.counts["paged_decode"]
    assert paged.plain_calls == 0
    assert paged.launches == server.stats.decode_steps * cfg.n_layers > 0
    assert server.stats.prefix_hits >= 1
    contiguous, _ = serve()
    for h, c in zip(handles, contiguous):
        assert h.result.finish_reason == "length"
        assert h.result.tokens == c.result.tokens


# -- co-activation counts --------------------------------------------------------

def _coact_masks(dev, T, N, dtype, seed=0):
    rng = np.random.default_rng(seed + T * 7 + N)
    if dtype == "u8_values":       # any byte values: counted as values
        m = rng.integers(0, 256, (T, N)).astype(np.uint8)
    else:
        m = (rng.random((T, N)) < 0.3).astype(
            bool if dtype == "bool" else np.uint8)
    return torch.from_numpy(m).to(dev)


@pytest.mark.parametrize("T,N", [(1, 1), (17, 50), (64, 128), (100, 300),
                                 (256, 256), (1000, 4100)])
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


def test_coact_kernel_rejects_what_it_does_not_take(dev):
    from repro_torch.kernels.coact import coact_accumulate_cuda
    m = _coact_masks(dev, 8, 16, "bool")
    with pytest.raises(ValueError, match="bool or uint8"):
        coact_accumulate_cuda(m.float())
    with pytest.raises(ValueError, match=r"\[T, N\]"):
        coact_accumulate_cuda(m[None])
    with pytest.raises(ValueError, match="CUDA device"):
        coact_accumulate_cuda(m.cpu())


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


def _swa_inputs(dev, seed, B, H, KV, hd, W, curs, dtype):
    """q and rings in `dtype`, each row's ring holding positions up to its
    cur (a cur of -1 leaves the row empty), wrapped where cur >= W."""
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
    cur = torch.tensor([max(c, 0) for c in curs], dtype=torch.int32,
                       device=dev)
    return t(q).to(dt), t(k).to(dt), t(v).to(dt), t(pos), cur


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,hd,W,window", [
    (1, 4, 1, 64, 512, 256), (2, 8, 2, 64, 1024, 512), (3, 6, 6, 32, 256, 128),
    (4, 16, 16, 64, 2048, 2048), (2, 32, 8, 128, 1000, 1000),
    (2, 16, 2, 128, 300, 77), (1, 4, 1, 256, 96, 96)])
def test_swa_kernel_matches_plain_on_card(dev, dtype, B, H, KV, hd, W,
                                          window):
    """Rows at their own positions: wrapped, short and (row 1) empty; the
    per-row and the scalar cur forms; the same bits on a second launch."""
    curs = [W + W // 3, -1, 5, 2 * W - 1][:B]
    q, k, v, pos, cur = _swa_inputs(dev, B * W, B, H, KV, hd, W, curs, dtype)
    ops.reset_counts()
    out = ops.swa_decode_attention(q, k, v, pos, cur, window=window)
    c = ops.counts["swa_decode"]
    assert (c.launches, c.plain_calls) == (1, 0)
    assert out.dtype == q.dtype and out.shape == q.shape
    torch.cuda.synchronize()
    ref = swa_decode_attention_plain(q, k, v, pos, cur, window=window)
    torch.testing.assert_close(out.float(), ref.float(), **SWA_TOL[dtype])
    if B > 1:
        assert float(out[1].float().abs().max()) == 0.0     # the empty row
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
    """Odd shapes on purpose: B above the kernel's 8-row register block, D
    not a multiple of its 256-column chunk, ids out of order with -1
    padding and a repeat."""
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
    ref = sparse_ffn_segments_plain(x, w_up, w_down, ids, w_gate, **kw)
    torch.testing.assert_close(y, ref, **TOL)
    assert torch.equal(y, ops.sparse_ffn_segments(x, w_up, w_down, ids,
                                                  w_gate, **kw))


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

@pytest.mark.parametrize("mode", ["resident", "offload"])
def test_swa_server_runs_the_kernel_on_card(dev, mode):
    """A tiny swa server (window 8, prompts past it, a reused slot): every
    decode attention launched the kernel, the plain version never ran, and
    the card's tokens equal the CPU's (the same weights)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.engine import Request, build_offload_runtime
    from repro_torch.serving.server import InferenceServer
    cfg = get_config("opt-350m", reduced=True, d_model=64, d_ff=256,
                     n_layers=2, vocab_size=128, sliding_window=8)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 128, T).astype(np.int32)
               for T in (11, 5, 3, 9, 4)]

    def serve(device):
        params = build_model(cfg, device="cpu").init_params(
            torch.Generator().manual_seed(0))
        model = build_model(cfg, device=device)
        params = _to(params, device)
        kw = {}
        if mode == "offload":
            kw = dict(mode="offload", offload=build_offload_runtime(
                model, params, calib_batch=(4, 32), device=device))
        server = InferenceServer(model, params, max_slots=4, max_len=24,
                                 swa=True, device=device, **kw)
        handles = [server.submit(Request(uid=i, prompt=p, max_new_tokens=6))
                   for i, p in enumerate(prompts)]
        ops.reset_counts()
        server.drain()
        return [h.result.tokens for h in handles], server.stats.decode_steps

    cpu_tokens, _ = serve("cpu")
    tokens, steps = serve(dev)
    c = ops.counts["swa_decode"]
    assert (c.launches, c.plain_calls) == (steps * cfg.n_layers, 0)
    assert tokens == cpu_tokens


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
