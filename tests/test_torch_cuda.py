"""The port on the card: the Hopper kernel against its plain version, and
the offload server's FFNs going through it.

Every test here needs a CUDA card and the CUDA toolkit (`nvcc` builds the
kernel at first use); on a machine without a card each one skips with
the reason. Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance rtol = atol = 1e-4 in float32: the kernel sums over D and over a
segment's neurons in another order than the plain version's matmuls.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
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
    ops.counts.reset()
    y = ops.sparse_ffn_segments_fused(*args, **kw)
    assert (ops.counts.launches, ops.counts.plain_calls) == (1, 0)
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

    ops.counts.reset()
    handles, stats = serve(mode="offload", offload=runtime)
    assert runtime.io_summary()["ffn_kernel"] == "segments"
    assert ops.counts.plain_calls == 0
    assert ops.counts.launches == stats.decode_steps * cfg.n_layers > 0
    resident, _ = serve()
    for h, r in zip(handles, resident):
        assert h.result.finish_reason == "length"
        assert h.result.tokens == r.result.tokens
