"""Kernel 3 of the port, co-activation counts MᵀM, on the CPU: its plain
version against the reference's Pallas kernel (interpret mode, as
`tests/test_kernels.py` runs it), the reference's oracle and numpy, and the
port's `CoActivationStats` against the reference's.

Tolerance: none. The counts are small integers, so every route must give
the same float32 bits (`assert_array_equal`, `torch.equal`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coactivation as jcoact
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import coactivation as tcoact
from repro_torch.kernels import ops
from repro_torch.kernels.coact import (coact_accumulate_cuda,
                                       coact_accumulate_plain)

torch.set_num_threads(1)

SHAPES = [(64, 128), (100, 300), (256, 256), (17, 50)]
DTYPES = {"bool": bool, "uint8": np.uint8, "float32": np.float32}


def _masks(T, N, dtype, p=0.25):
    rng = np.random.default_rng(T * 1000 + N)
    return (rng.random((T, N)) < p).astype(DTYPES[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("T,N", SHAPES)
def test_plain_equals_pallas_oracle_and_numpy(T, N, dtype):
    m = _masks(T, N, dtype)
    ops.reset_counts()
    got = ops.coact_accumulate(torch.from_numpy(m))
    assert ops.counts["coact_accumulate"].plain_calls == 1
    assert ops.counts["coact_accumulate"].launches == 0
    assert got.dtype == torch.float32 and tuple(got.shape) == (N, N)
    got = got.numpy()
    pallas = np.asarray(jops.coact_accumulate(jnp.asarray(m), tile_n=128,
                                              tile_t=64, interpret=True))
    oracle = np.asarray(jref.coact_accumulate_ref(jnp.asarray(m)))
    mf = m.astype(np.float32)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got, mf.T @ mf)


def test_symmetry_and_diagonal():
    m = _masks(40, 96, "bool", p=0.3)
    a = coact_accumulate_plain(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(a, a.T)
    np.testing.assert_array_equal(np.diag(a), m.sum(0))


def test_transposed_view_and_empty_block():
    """A strided view counts like its contiguous copy; T = 0 gives zeros."""
    m = torch.from_numpy(_masks(50, 30, "uint8"))
    view = m.T.contiguous().T
    assert not view.is_contiguous()
    assert torch.equal(coact_accumulate_plain(view), coact_accumulate_plain(m))
    assert torch.equal(coact_accumulate_plain(m[:0]), torch.zeros((30, 30)))


def test_stats_updates_bit_identical_to_reference():
    """Several updates of mixed dtypes and block sizes, then a merge: the
    port's counts, pair counts and distances equal the reference's bits."""
    device = "cpu"
    rng = np.random.default_rng(5)
    n = 96
    blocks = [rng.random((T, n)) < p for T, p in ((30, 0.2), (1, 0.5),
                                                    (64, 0.1), (17, 0.4))]
    blocks[1] = blocks[1].astype(np.uint8)
    blocks[2] = blocks[2].astype(np.float32)
    js, ts = jcoact.CoActivationStats(n), tcoact.CoActivationStats(n, device)
    for b in blocks:
        js.update(b)
        ts.update(b)
    other_j = jcoact.stats_from_masks(blocks[0])
    other_t = tcoact.stats_from_masks(blocks[0], device=device)
    js.merge(other_j, inplace=True)
    ts.merge(other_t, inplace=True)
    merged_j, merged_t = js.merge(other_j), ts.merge(other_t)
    for j, t in ((js, ts), (merged_j, merged_t)):
        assert t.n_tokens == j.n_tokens
        np.testing.assert_array_equal(t.counts_numpy(), j.counts)
        np.testing.assert_array_equal(t.pair_counts_numpy(), j.pair_counts)
        np.testing.assert_array_equal(t.distance_matrix(), j.distance_matrix())
        np.testing.assert_array_equal(t.p_single(), j.p_single())
        np.testing.assert_array_equal(t.activation_rate(), j.activation_rate())
    # a 1-D mask is one token, as in the reference
    js.update(blocks[0][0])
    ts.update(blocks[0][0])
    np.testing.assert_array_equal(ts.pair_counts_numpy(), js.pair_counts)


def test_stats_from_mask_shards_bit_identical_to_reference():
    rng = np.random.default_rng(8)
    shards = [rng.random((T, 80)) < 0.3 for T in (20, 7, 33)]
    ts = tcoact.stats_from_mask_shards(iter(shards), device="cpu")
    js = jcoact.stats_from_mask_shards(iter(shards))
    np.testing.assert_array_equal(ts.pair_counts_numpy(), js.pair_counts)
    np.testing.assert_array_equal(ts.counts_numpy(), js.counts)
    np.testing.assert_array_equal(ts.distance_matrix(), js.distance_matrix())
    empty = tcoact.stats_from_mask_shards(iter(()), n_neurons=5, device="cpu")
    assert empty.n_tokens == 0 and tuple(empty.pair_counts.shape) == (5, 5)
    with pytest.raises(ValueError, match="n_neurons"):
        tcoact.stats_from_mask_shards(iter(()), device="cpu")


def test_stats_reject_wrong_width_and_device():
    s = tcoact.CoActivationStats(8, device="cpu")
    with pytest.raises(ValueError, match="mask width"):
        s.update(np.zeros((2, 9), dtype=bool))
    with pytest.raises(ValueError, match="meta|device|is on"):
        s.update(torch.zeros((2, 8), dtype=torch.bool, device="meta"))


@pytest.mark.parametrize("bad,match", [
    (torch.zeros((4, 8, 2), dtype=torch.bool), r"\[T, N\]"),
    (torch.zeros((8,), dtype=torch.uint8), r"\[T, N\]"),
    (torch.zeros((4, 8), dtype=torch.float32), "bool or uint8"),
    (torch.zeros((4, 8), dtype=torch.int32), "bool or uint8"),
    (torch.zeros((4, 8), dtype=torch.bool), "CUDA device"),
])
def test_cuda_wrapper_rejects_rank_dtype_and_device(bad, match):
    """The kernel's wrapper checks rank and dtype before anything else, and
    never computes a CPU tensor (no fall-back to the plain version)."""
    with pytest.raises(ValueError, match=match):
        coact_accumulate_cuda(bad)


def test_plain_rejects_bad_rank():
    with pytest.raises(ValueError, match=r"\[T, N\]"):
        ops.coact_accumulate(torch.zeros((3,), dtype=torch.bool))
