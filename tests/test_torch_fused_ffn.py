"""The port's fused segment-FFN against the reference's.

The plain PyTorch version of the Hopper kernel
(`repro_torch.kernels.sparse_ffn.sparse_ffn_segments_fused_plain`, which
the dispatcher runs for CPU tensors) is held against the reference's
Pallas kernel run in the Pallas interpreter (`interpret=True`), its XLA
twin (`interpret=None` on the CPU) and the per-segment python oracle
`ref.sparse_ffn_segments_fused_ref`, on the same numpy inputs: 4
activations x gated or not x f32 / int8 weight tiles, with padded segment
ids and over-covering segments. Tolerance rtol = atol = 2e-4, as the
reference's own fused-kernel tests (f32 sums taken in another order).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.kernels import ops
from repro_torch.kernels.sparse_ffn import sparse_ffn_segments_fused_plain

# tiny shapes: one intra-op thread each, so the parallel test run does not
# oversubscribe the machine's cores
torch.set_num_threads(1)

SEG = 128
ACTS = ["relu", "relu2", "gelu", "silu"]
TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(seed, n, d, B, gated, int8, n_ids=60):
    """Raw weight tiles (int8 or f32) + per-neuron scale tiles for a sparse
    random activated set, padded to a multiple of 8 segments with -1."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, d)).astype(np.float32) * 0.5
    if int8:
        mats = [rng.integers(-127, 128, (n, d)).astype(np.int8)
                for _ in range(3 if gated else 2)]
        scales = rng.uniform(0.5, 1.5, n).astype(np.float32) / 127 * 0.1
    else:
        mats = [(rng.standard_normal((n, d)) * 0.1).astype(np.float32)
                for _ in range(3 if gated else 2)]
        scales = np.ones(n, np.float32)
    ids = np.sort(rng.choice(n, size=n_ids, replace=False))
    seg_u = np.unique(ids // SEG)
    padded = -(-seg_u.size // 8) * 8
    seg_ids = np.full(padded, -1, np.int32)
    seg_ids[:seg_u.size] = seg_u
    tiles = np.zeros((padded, SEG), np.float32)
    tiles[np.searchsorted(seg_u, ids // SEG), ids % SEG] = scales[ids]
    tiles[seg_u.size:] = 7.0           # padded rows: must be ignored anyway
    w_up, w_down = mats[0], mats[1]
    w_gate = mats[2] if gated else None
    return x, w_up, w_down, seg_ids, tiles, w_gate


@pytest.mark.parametrize("activation,gated", [("relu", False), ("relu2", False),
                                              ("gelu", False), ("silu", True),
                                              ("relu", True), ("silu", False)])
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_plain_matches_reference_kernel(activation, gated, int8):
    n, d, B = 512, 128, 3
    x, w_up, w_down, seg_ids, tiles, w_gate = _inputs(
        ACTS.index(activation) * 4 + 2 * gated + int8, n, d, B, gated, int8)
    kw = dict(seg_size=SEG, activation=activation)
    t = lambda a: None if a is None else torch.from_numpy(a)   # noqa: E731
    y_port = sparse_ffn_segments_fused_plain(
        t(x), t(w_up), t(w_down), t(seg_ids), t(tiles), t(w_gate), **kw).numpy()
    j = lambda a: None if a is None else jnp.asarray(a)        # noqa: E731
    args = (j(x), j(w_up), j(w_down), j(seg_ids), j(tiles), j(w_gate))
    for interpret in (True, None):
        y_ref = np.asarray(jops.sparse_ffn_segments_fused(
            *args, interpret=interpret, **kw))
        np.testing.assert_allclose(y_port, y_ref, **TOL)
    y_oracle = np.asarray(ref.sparse_ffn_segments_fused_ref(
        j(x), j(w_up), j(w_down), seg_ids, j(tiles), j(w_gate), **kw))
    np.testing.assert_allclose(y_port, y_oracle, **TOL)


def test_dispatcher_routes_cpu_to_plain_and_counts():
    x, w_up, w_down, seg_ids, tiles, _ = _inputs(1, 256, 64, 2, False, False,
                                                 n_ids=20)
    args = [torch.from_numpy(a) for a in (x, w_up, w_down, seg_ids, tiles)]
    ops.counts.reset()
    y = ops.sparse_ffn_segments_fused(*args, seg_size=SEG, activation="relu")
    y2 = ops.sparse_ffn_segments_fused(*args, seg_size=SEG, activation="relu")
    assert (ops.counts.launches, ops.counts.plain_calls) == (0, 2)
    assert torch.equal(y, y2)
    assert y.dtype == torch.float32 and tuple(y.shape) == (2, 64)


def test_pad_segments_and_zero_scales_contribute_nothing():
    """All-padding ids give exactly 0; so do live segments whose scale row
    is all zero, for an activation with act(pre) != 0 at pre != 0."""
    x, w_up, w_down, seg_ids, tiles, _ = _inputs(2, 256, 64, 2, False, False,
                                                 n_ids=20)
    t = torch.from_numpy
    pads = torch.full_like(t(seg_ids), -1)
    y = sparse_ffn_segments_fused_plain(t(x), t(w_up), t(w_down), pads,
                                        t(tiles), seg_size=SEG,
                                        activation="gelu")
    assert torch.count_nonzero(y) == 0
    y0 = sparse_ffn_segments_fused_plain(t(x), t(w_up), t(w_down),
                                         t(seg_ids), torch.zeros_like(t(tiles)),
                                         seg_size=SEG, activation="gelu")
    assert torch.count_nonzero(y0) == 0
