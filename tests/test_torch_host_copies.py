"""Host-side copies in the port make the reference's decisions exactly.

`utils`, `core.placement`, `core.coactivation`, `core.cache`,
`core.storage` and `core.engine` are framework-free numpy code that the
port copies (it may not import the reference). On the same inputs both
copies must agree bit for bit: admission sampling, placements, and — on a
randomized decode trace — every cache hit, admission and eviction and every
field of the `step_masks` I/O statistics.
"""
import dataclasses

import numpy as np
import pytest

from repro import utils as jutils
from repro.core import coactivation as jcoact
from repro.core import engine as jengine
from repro.core import placement as jplacement
from repro_torch import utils as tutils
from repro_torch.core import coactivation as tcoact
from repro_torch.core import engine as tengine
from repro_torch.core import placement as tplacement


def test_stable_hash_and_uniform_bit_identical():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 1 << 40, 5000)
    for salt, tick in ((0, 0), (7, 123456), (2 ** 31, 99)):
        np.testing.assert_array_equal(tutils.stable_hash_array(salt, tick, ids),
                                      jutils.stable_hash_array(salt, tick, ids))
        np.testing.assert_array_equal(
            tutils.stable_uniform_array(salt, ids),
            jutils.stable_uniform_array(salt, ids))
    assert tutils.stable_uniform(3, 4) == jutils.stable_uniform(3, 4)


def _clustered_masks(rng, T, n, groups=12):
    """Masks with planted co-activation groups (so placement has links to
    find) plus background noise."""
    members = rng.permutation(n).reshape(groups, -1)
    m = rng.random((T, n)) < 0.03
    for t in range(T):
        for g in rng.choice(groups, size=3, replace=False):
            m[t, members[g]] |= rng.random(members.shape[1]) < 0.8
    return m


@pytest.mark.parametrize("mode", ["exact", "topk", "auto"])
def test_search_placement_bit_identical(mode):
    rng = np.random.default_rng(1)
    masks = _clustered_masks(rng, 200, 384)
    dt = tcoact.stats_from_masks(masks, device="cpu").distance_matrix()
    dj = jcoact.stats_from_masks(masks).distance_matrix()
    np.testing.assert_array_equal(dt, dj)
    pt = tplacement.search_placement(dt, mode=mode)
    pj = jplacement.search_placement(dj, mode=mode)
    np.testing.assert_array_equal(pt.placement, pj.placement)
    np.testing.assert_array_equal(pt.inverse, pj.inverse)
    assert (pt.mode, pt.edges_used) == (pj.mode, pj.edges_used)


def _iostats(io):
    d = dataclasses.asdict(io)
    d.pop("run_lengths")
    return d


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engine_step_masks_identical_on_random_trace(seed):
    """Same bundles, same placement, same [B, n] mask trace: the port's
    OffloadEngine serves it with the reference's exact cache decisions and
    I/O statistics, field by field, step by step."""
    rng = np.random.default_rng(seed)
    n, width = 384, 16
    bundles = rng.standard_normal((n, width)).astype(np.float32)
    trace = _clustered_masks(rng, 120, n)
    pj = jplacement.search_placement(
        jcoact.stats_from_masks(trace[:60]).distance_matrix(), mode="auto")
    pt = tplacement.PlacementResult(**dataclasses.asdict(pj))
    cfg = dict(cache_ratio=float(rng.uniform(0.05, 0.3)),
               segment_admit_p=float(rng.uniform(0, 1)))
    ej = jengine.OffloadEngine(bundles, placement=pj,
                               config=jengine.EngineConfig(**cfg))
    et = tengine.OffloadEngine(bundles, placement=pt,
                               config=tengine.EngineConfig(**cfg))
    for step in range(30):
        B = int(rng.integers(1, 5))
        masks = trace[rng.choice(len(trace), size=B)]
        masks &= rng.random(masks.shape) < 0.9
        rj = ej.step_masks(masks, fetch_payload=False)
        rt = et.step_masks(masks, fetch_payload=False)
        np.testing.assert_array_equal(rt.ids, rj.ids)
        assert _iostats(rt.merged.io) == _iostats(rj.merged.io), step
        np.testing.assert_array_equal(rt.merged.run_lengths,
                                      rj.merged.run_lengths)
        for f in ("req_n_activated", "req_n_misses", "req_io_seconds",
                  "req_bytes_useful"):
            np.testing.assert_array_equal(getattr(rt, f), getattr(rj, f))
        for f in ("hits", "misses", "admitted", "rejected", "evicted",
                  "ghost_promotions"):
            assert getattr(et.cache.stats, f) == getattr(ej.cache.stats, f)
        np.testing.assert_array_equal(et.cache.resident_ids(),
                                      ej.cache.resident_ids())
        assert et.reader.threshold.threshold == ej.reader.threshold.threshold
    assert et.summary() == ej.summary()
