"""The unfused segment FFN's plain version against the reference.

`ops.sparse_ffn_segments` on CPU tensors runs `sparse_ffn_segments_plain`
(what the Hopper kernel is held against on the card). It is compared, on
the same numpy inputs, with the JAX package's oracle
`ref.sparse_ffn_segments_ref` and its Pallas kernel in interpret mode
(`ops.sparse_ffn_segments`, run as `tests/test_kernels.py` runs it): the
sweeps of `tests/test_kernels.py:14-63` (batch, width, dtype; the four
activations, gated; -1 padding; every segment equals the dense FFN), with
their tolerances, plus repeated ids and strided weight views.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels.sparse_ffn import (_unit_neuron_rows, _whole_rows,
                                            activation_tie_slack,
                                            segments_plan,
                                            sparse_ffn_segments_plain)

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# bf16 segment checks: the tie slack an output's tolerance takes is capped
# here, so the tolerance stays within 2e-3 absolute of float32 order's
TIE_SLACK_MAX = 2e-3


def _tol(dtype):
    # tests/test_kernels.py:10-11
    return (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
            else dict(rtol=2e-4, atol=2e-4))


def _inputs(seed, B, D, N, gated=False):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, D)) * 0.5).astype(np.float32)
    wu = (rng.standard_normal((N, D)) * 0.1).astype(np.float32)
    wd = (rng.standard_normal((N, D)) * 0.1).astype(np.float32)
    wg = ((rng.standard_normal((N, D)) * 0.1).astype(np.float32)
          if gated else None)
    return x, wu, wd, wg


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(np.asarray(a)).to(dtype)


def _port(x, wu, wd, ids, wg=None, dtype=torch.float32, **kw):
    ops.reset_counts()
    y = ops.sparse_ffn_segments(_t(x, dtype), _t(wu, dtype), _t(wd, dtype),
                                torch.tensor(ids, dtype=torch.int32),
                                _t(wg, dtype), **kw)
    c = ops.counts["sparse_ffn_segments"]
    assert (c.launches, c.plain_calls) == (0, 1)
    assert y.dtype == torch.float32 and tuple(y.shape) == x.shape
    return y.numpy()


@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shape_dtype_sweep_matches_oracle(B, D, dtype):
    """tests/test_kernels.py:14-29, against the oracle."""
    jdt, tdt = DTYPES[dtype]
    N, seg = 512, 128
    x, wu, wd, _ = _inputs(B * D, B, D, N)
    y = _port(x, wu, wd, [1, 2, 3], dtype=tdt, seg_size=seg)
    yr = jref.sparse_ffn_segments_ref(
        jnp.asarray(x, jdt), jnp.asarray(wu, jdt), jnp.asarray(wd, jdt),
        np.array([1, 2, 3]), seg_size=seg, activation="relu")
    np.testing.assert_allclose(y, np.asarray(yr, np.float32), **_tol(dtype))


@pytest.mark.parametrize("activation,gated", [("relu", False), ("relu2", False),
                                              ("gelu", False), ("silu", True)])
def test_activations_match_oracle_and_pallas_kernel(activation, gated):
    """tests/test_kernels.py:32-45: against the oracle and the Pallas
    kernel interpreted."""
    B, D, N, seg = 4, 128, 512, 128
    x, wu, wd, wg = _inputs(7, B, D, N, gated)
    y = _port(x, wu, wd, [0, 2], wg, seg_size=seg, activation=activation)
    args = [jnp.asarray(a) for a in (x, wu, wd)]
    jwg = None if wg is None else jnp.asarray(wg)
    yr = jref.sparse_ffn_segments_ref(*args, np.array([0, 2]), jwg,
                                      seg_size=seg, activation=activation)
    yk = jops.sparse_ffn_segments(*args, jnp.asarray([0, 2], jnp.int32), jwg,
                                  seg_size=seg, activation=activation)
    np.testing.assert_allclose(y, np.asarray(yr), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(y, np.asarray(yk), rtol=2e-4, atol=2e-4)


def test_padding_ids_contribute_zero():
    """tests/test_kernels.py:48-55: -1 ids are the appended zero segment,
    in the port as in the Pallas kernel."""
    B, D, N, seg = 2, 128, 256, 128
    x, wu, wd, _ = _inputs(8, B, D, N)
    y1 = _port(x, wu, wd, [1], seg_size=seg)
    y2 = _port(x, wu, wd, [1, -1, -1, -1], seg_size=seg)
    np.testing.assert_allclose(y1, y2, rtol=1e-6, atol=1e-6)
    yk = jops.sparse_ffn_segments(*(jnp.asarray(a) for a in (x, wu, wd)),
                                  jnp.asarray([1, -1, -1, -1], jnp.int32),
                                  seg_size=seg)
    np.testing.assert_allclose(y2, np.asarray(yk), rtol=2e-4, atol=2e-4)


def test_all_segments_equal_dense():
    """tests/test_kernels.py:58-68: every segment selected is the dense FFN
    (the paper's exactness property)."""
    B, D, N, seg = 4, 128, 512, 128
    x, wu, wd, _ = _inputs(9, B, D, N)
    y = _port(x, wu, wd, list(range(N // seg)), seg_size=seg)
    dense = np.maximum(x @ wu.T, 0) @ wd
    np.testing.assert_allclose(y, dense, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("gated", [False, True])
def test_repeated_ids_count_twice(gated):
    """The oracle's contract (ref.py:26): a repeated id adds its segment
    again; with -1 pads between them."""
    B, D, N, seg = 3, 128, 384, 128
    x, wu, wd, wg = _inputs(10, B, D, N, gated)
    act = "silu" if gated else "relu"
    once = _port(x, wu, wd, [2], wg, seg_size=seg, activation=act)
    twice = _port(x, wu, wd, [2, -1, 2, 0], wg, seg_size=seg, activation=act)
    zero = _port(x, wu, wd, [0], wg, seg_size=seg, activation=act)
    np.testing.assert_allclose(twice, 2 * once + zero, rtol=1e-5, atol=1e-5)
    yr = jref.sparse_ffn_segments_ref(
        *(jnp.asarray(a) for a in (x, wu, wd)), np.array([2, 2, 0]),
        None if wg is None else jnp.asarray(wg), seg_size=seg, activation=act)
    np.testing.assert_allclose(twice, np.asarray(yr), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("seg", [32, 128])
def test_strided_views_equal_contiguous(seg):
    """`w_up.T` / `w_gate.T` views of [d, N] weights (the model's layout)
    and a sliced down view give the contiguous weights' result exactly."""
    B, D, N = 2, 64, 256
    x, wu, wd, wg = _inputs(11, B, D, N, gated=True)
    ids = torch.tensor([1, -1, 0, 1], dtype=torch.int32)
    kw = dict(seg_size=seg, activation="silu")
    contiguous = sparse_ffn_segments_plain(_t(x), _t(wu), _t(wd), ids, _t(wg),
                                           **kw)
    up_view = _t(wu).T.contiguous().T                    # [N, D], strides (1, N)
    gate_view = _t(wg).T.contiguous().T
    down_view = torch.cat([_t(wd), _t(wd)], dim=1)[:, :D]  # row stride 2D
    assert not (up_view.is_contiguous() or down_view.is_contiguous())
    viewed = ops.sparse_ffn_segments(_t(x), up_view, down_view, ids,
                                     gate_view, **kw)
    torch.testing.assert_close(viewed, contiguous, rtol=0, atol=0)


@pytest.mark.parametrize("activation,gated", [
    ("relu", False), ("relu2", False), ("gelu", False), ("silu", False),
    ("silu", True)])
def test_bf16_rounds_the_activation_as_the_pallas_kernel(activation, gated):
    """bf16 weights: the activation (after the gate product) is rounded to
    bf16 before the down product, as the Pallas kernel's
    `act.astype(down_ref.dtype)` (src/repro/kernels/sparse_ffn.py:77, :91).
    The plain version then matches the kernel interpreted to float32
    summation order: 1e-5 of the output's scale (measured 4.8e-7 at scale
    3.9 for relu; a float32 activation misses by 6.6e-3), plus, where an
    activation lies at a bf16 rounding tie (within float32 error), the
    other rounding's effect (`activation_tie_slack`, capped at
    TIE_SLACK_MAX; the silu case has such activations: JAX's silu and the
    port's differ in the last bit)."""
    B, D, N, seg = 4, 256, 512, 128
    x, wu, wd, wg = _inputs(B * D, B, D, N, gated)
    ids = [1, 2, 3]
    kw = dict(seg_size=seg, activation=activation)
    y = _port(x, wu, wd, ids, wg, dtype=torch.bfloat16, **kw)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (x, wu, wd)]
    jwg = None if wg is None else jnp.asarray(wg, jnp.bfloat16)
    yk = np.asarray(jops.sparse_ffn_segments(
        *jargs, jnp.asarray(ids, jnp.int32), jwg, **kw), np.float32)
    slack = activation_tie_slack(
        _t(x, torch.bfloat16), _t(wu, torch.bfloat16), _t(wd, torch.bfloat16),
        torch.tensor(ids), _t(wg, torch.bfloat16), **kw).numpy()
    scale = float(np.abs(yk).max())
    bad = np.abs(y - yk) > 1e-5 * scale + np.minimum(slack, TIE_SLACK_MAX)
    assert not bad.any(), (int(bad.sum()), float(np.abs(y - yk).max()))


def test_segments_plan_keeps_the_most_blocks_busy():
    """The Hopper launch plan (pure Python): per cluster size, as many
    clusters as segments or as the card holds; the size whose busiest
    block takes the least share of the segments wins, the larger one on a
    tie."""
    # serve_sparse opt-350m: 4 segments, a 16-block cluster each
    p = segments_plan(4, 1024, 4, ((16, 8), (8, 16), (4, 33)))
    assert (p.nb, p.groups, p.cluster, p.clusters, p.blocks) == (
        4, 1, 16, 4, 64)
    # mistral-7b: 16 clusters of 8 (a segment each) beat 7 of 16 (three
    # segments on the busiest, 3 / 16 > 1 / 8) ...
    p = segments_plan(4, 4096, 16, ((16, 7), (8, 16), (4, 33)))
    assert (p.cluster, p.clusters, p.blocks) == (8, 16, 128)
    # ... and 7 of 16 (3 / 16) beat 15 of 8 (two on the busiest, 2 / 8)
    p = segments_plan(4, 4096, 16, ((16, 7), (8, 15), (4, 30)))
    assert (p.cluster, p.clusters, p.blocks) == (16, 7, 112)
    p = segments_plan(4, 4096, 16, ((16, 8), (8, 16)))
    assert (p.cluster, p.clusters) == (16, 8)
    # 11 rows at D = 520 run as groups of 8; a size the card cannot hold
    p = segments_plan(11, 520, 6, ((16, 0), (8, 16), (4, 33)))
    assert (p.nb, p.groups, p.cluster, p.clusters) == (8, 2, 8, 6)
    with pytest.raises(RuntimeError, match="no cluster"):
        segments_plan(4, 1024, 4, ((16, 0),))


def test_model_layouts_take_the_copy_engine_path():
    """The model's `w.T` views of [d, d_ff] up / gate weights and its
    [d_ff, d] down weight take the kernel's copy engine (tensor-map boxes,
    bulk copies); rows, column-strided or misaligned operands its general
    path."""
    for dt in (torch.float32, torch.bfloat16):
        up = torch.zeros(1024, 4096, dtype=dt).T
        down = torch.zeros(4096, 1024, dtype=dt)
        assert _unit_neuron_rows(up) and _whole_rows(down)
        assert not _unit_neuron_rows(up.contiguous())
        assert not _whole_rows(down.T.contiguous().T)
        flat = torch.zeros(4096 * 1024 + 1, dtype=dt)
        assert not _unit_neuron_rows(flat[1:].view(1024, 4096).T)
        assert not _whole_rows(flat[1:].view(4096, 1024))
    assert not _whole_rows(torch.zeros(256, 36, dtype=torch.bfloat16))
