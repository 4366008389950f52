"""The port on the card: the Hopper kernels against their plain versions,
and the servers going through them (offload FFNs, paged decode attention).

Every test here needs a CUDA card and the CUDA toolkit (`nvcc` builds the
kernel at first use); on a machine without a card each one skips with
the reason. Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances in float32: rtol = atol = 1e-4 for the FFN kernel, which sums
over D and over a segment's neurons in another order than the plain
version's matmuls; rtol = atol = 1e-5 for the paged-attention kernel,
whose online softmax sums over the rows in another order than the plain
version's softmax and einsum.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.paged_decode import (paged_decode_attention_cuda,
                                              paged_decode_attention_plain)
from repro_torch.kernels.sparse_ffn import (sparse_ffn_segments_fused_cuda,
                                            sparse_ffn_segments_fused_plain)

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
