"""Kernel 3 of the port, co-activation counts MᵀM, on the CPU: its plain
version against the reference's Pallas kernel (interpret mode, as
`tests/test_kernels.py` runs it), the reference's oracle and numpy, and the
port's `CoActivationStats` against the reference's.

Tolerance: none. The counts are small integers, so every route must give
the same float32 bits (`assert_array_equal`, `torch.equal`), in
accumulate mode too (`A += MᵀM` into a matrix that already holds counts).
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
from repro_torch.kernels.coact import (BYTE_VALUE_TOKENS, INT32_MAX,
                                       coact_accumulate_cuda,
                                       coact_accumulate_plain, int32_sums_fit)

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


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("T,N", SHAPES)
def test_plain_accumulate_mode_equals_pallas_plus_add(T, N, dtype):
    """`accumulate_into=A`: the block's counts are added into A in place and
    A is returned; the bits are those of A plus the Pallas kernel's MᵀM (the
    reference's `pair_counts += m.T @ m`)."""
    m = _masks(T, N, dtype)
    start = np.random.default_rng(T + N).integers(
        0, 1 << 16, (N, N)).astype(np.float32)
    into = torch.from_numpy(start.copy())
    ops.reset_counts()
    got = ops.coact_accumulate(torch.from_numpy(m), accumulate_into=into)
    assert got is into
    assert ops.counts["coact_accumulate"].plain_calls == 1
    pallas = np.asarray(jops.coact_accumulate(jnp.asarray(m), tile_n=128,
                                              tile_t=64, interpret=True))
    want = start.copy()
    want += pallas
    np.testing.assert_array_equal(into.numpy(), want)


def test_plain_accumulate_empty_block_leaves_counts():
    start = torch.arange(36, dtype=torch.float32).reshape(6, 6)
    into = start.clone()
    m = torch.zeros((0, 6), dtype=torch.bool)
    assert coact_accumulate_plain(m, accumulate_into=into) is into
    assert torch.equal(into, start)


@pytest.mark.parametrize("into,match", [
    (torch.zeros((8, 8), dtype=torch.float64), "float32"),
    (torch.zeros((8, 7)), "float32"),
    (torch.zeros((8, 16))[:, ::2], "contiguous"),
])
def test_accumulate_into_is_checked(into, match):
    """A pair matrix of another dtype, shape or layout is refused (the CUDA
    wrapper runs the same check; `tests/test_torch_cuda.py` holds it)."""
    m = torch.zeros((4, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match=match):
        coact_accumulate_plain(m, accumulate_into=into)


def test_accumulate_into_must_share_the_masks_device():
    m = torch.zeros((4, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="is on"):
        coact_accumulate_plain(m, accumulate_into=torch.zeros(
            (8, 8), device="meta"))


@pytest.mark.parametrize("T,vmax,fits", [
    (1, 255, True), (33_025, 255, True), (33_026, 255, False),
    (33_026, 254, True), (BYTE_VALUE_TOKENS, 255, False),
    ((1 << 24) - 1, 1, True), (INT32_MAX, 1, True), (INT32_MAX + 1, 1, False),
    (8_421_504, 16, False), (8_388_607, 16, True), (10, 0, True)])
def test_int32_sums_fit(T, vmax, fits):
    """The kernel's int32 sums hold T·vmax² up to 2^31 − 1: bytes of 255
    from T = 33,026 on could wrap (the wrapper then raises), 0/1 masks
    never below the 2^24-token limit."""
    assert BYTE_VALUE_TOKENS == 33_026
    assert int32_sums_fit(T, vmax) is fits
    assert (T * vmax * vmax <= (1 << 31) - 1) is fits


def test_stats_update_adds_in_place_bit_identical_to_reference():
    """Many updates through the accumulate mode (bool, 0/1 uint8 and byte
    values, an empty block, ragged T): the pair matrix is the same tensor
    throughout and its bits equal the reference's after every update."""
    rng = np.random.default_rng(11)
    n = 70
    js, ts = jcoact.CoActivationStats(n), tcoact.CoActivationStats(n, "cpu")
    pair = ts.pair_counts
    ptr = pair.data_ptr()
    ops.reset_counts()
    for i, T in enumerate((33, 0, 128, 5, 64, 1, 200, 17)):
        if i % 3 == 2:
            b = rng.integers(0, 256, (T, n)).astype(np.uint8)   # values
        else:
            b = rng.random((T, n)) < 0.2 + 0.05 * i
            if i % 3 == 1:
                b = b.astype(np.uint8)
        js.update(b)
        ts.update(b)
        assert ts.pair_counts is pair and pair.data_ptr() == ptr
        np.testing.assert_array_equal(ts.pair_counts_numpy(), js.pair_counts)
        np.testing.assert_array_equal(ts.counts_numpy(), js.counts)
    assert ops.counts["coact_accumulate"].plain_calls == 8
    np.testing.assert_array_equal(ts.distance_matrix(), js.distance_matrix())
    assert ts.n_tokens == js.n_tokens
