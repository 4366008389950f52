"""Expert-level co-activation linking (MoE RIPPLE) in the port.

`repro_torch.core.expert_placement` against the reference's
`core/expert_placement.py` on the same router selections: the same
co-routing counts, expert placements, within-expert masks, neuron
placements and expected reads per token (the counts are exact, so the
placements are equal). The counts run through `CoActivationStats` on the
CPU here (the coact kernel's plain version); `tests/test_torch_cuda.py`
holds the card's. Plus the counterparts of the six tests of
tests/test_expert_placement.py on the port.
"""
import numpy as np
import pytest

from repro.core import expert_placement as jep
from repro_torch.core import expert_placement as ep
from repro_torch.core.placement import identity_placement

CPU = dict(device="cpu")


def test_routing_masks_shape_and_counts():
    sel = np.array([[0, 2], [1, 3], [0, 1]])
    m = ep.routing_masks(sel, 4)
    assert m.shape == (3, 4)
    assert m.sum() == 6
    assert m[0, 0] and m[0, 2] and not m[0, 1]
    np.testing.assert_array_equal(m, jep.routing_masks(sel, 4))


def test_expert_placement_reduces_reads():
    sel = ep.synthetic_routing(n_tokens=800, n_experts=32, top_k=8,
                               n_groups=4, seed=0)
    pl = ep.search_expert_placement(sel, 32, **CPU)
    ident = identity_placement(32)
    serve = ep.synthetic_routing(n_tokens=300, n_experts=32, top_k=8,
                                 n_groups=4, seed=7)
    r_ident = ep.expected_reads_per_token(serve, 32, ident)
    r_ripple = ep.expected_reads_per_token(serve, 32, pl)
    assert r_ripple < 0.8 * r_ident, (r_ident, r_ripple)
    groups = pl.placement % 4
    assert np.mean(groups[:-1] == groups[1:]) > 0.7


def test_expert_coactivation_symmetric():
    sel = ep.synthetic_routing(200, 16, 2, seed=1)
    stats = ep.expert_coactivation(sel, 16, **CPU)
    pair = stats.pair_counts_numpy()
    np.testing.assert_array_equal(pair, pair.T)
    assert stats.counts_numpy().sum() == 200 * 2


def test_hierarchical_placement_shapes():
    rng = np.random.default_rng(2)
    E, dff = 8, 64
    sel = ep.synthetic_routing(300, E, 2, seed=2)
    neuron_masks = [rng.random((50, dff)) < 0.2 for _ in range(E)]
    expert_pl, neuron_pls = ep.hierarchical_moe_placement(sel, neuron_masks,
                                                          E, **CPU)
    assert sorted(expert_pl.placement.tolist()) == list(range(E))
    assert len(neuron_pls) == E
    for pl in neuron_pls:
        assert sorted(pl.placement.tolist()) == list(range(dff))


def test_hierarchical_placement_handles_missing_masks():
    sel = ep.synthetic_routing(100, 4, 2, seed=3)
    _, neuron_pls = ep.hierarchical_moe_placement(sel, None, 4, **CPU)
    assert all(p is None for p in neuron_pls)


def test_synthetic_routing_topk_distinct_and_equal_to_reference():
    sel = ep.synthetic_routing(100, 16, 4, seed=4)
    for row in sel:
        assert len(set(row.tolist())) == 4
    np.testing.assert_array_equal(sel, jep.synthetic_routing(100, 16, 4,
                                                             seed=4))


@pytest.mark.parametrize("E,k", [(32, 8), (16, 2)])
def test_placements_and_reads_equal_reference(E, k):
    """granite-moe's router (32 experts, top-8) and jamba's (16, top-2),
    drawn as benchmarks/moe_expert_bench.py draws them."""
    calib = ep.synthetic_routing(1200, E, k, n_groups=max(2, E // 8), seed=11)
    serve = ep.synthetic_routing(400, E, k, n_groups=max(2, E // 8), seed=99)
    stats = ep.expert_coactivation(calib, E, **CPU)
    jstats = jep.expert_coactivation(calib, E)
    np.testing.assert_array_equal(stats.pair_counts_numpy(),
                                  jstats.pair_counts)
    np.testing.assert_array_equal(stats.counts_numpy(), jstats.counts)
    pl = ep.search_expert_placement(calib, E, **CPU)
    jpl = jep.search_expert_placement(calib, E)
    np.testing.assert_array_equal(pl.placement, jpl.placement)
    for placement, jplacement in ((pl, jpl), (identity_placement(E),
                                              identity_placement(E))):
        assert ep.expected_reads_per_token(serve, E, placement) == \
            jep.expected_reads_per_token(serve, E, jplacement)


def test_within_expert_placements_equal_reference():
    """Within-expert neuron masks (width 64 here; 512 on the card) and the
    two-level placement equal the reference's."""
    rng = np.random.default_rng(5)
    E, dff = 8, 64
    sel = ep.synthetic_routing(300, E, 2, seed=5)
    token_masks = rng.random((300, dff)) < 0.25
    masks = [ep.within_expert_masks(token_masks, sel, e) for e in range(E)]
    for e, m in enumerate(masks):
        np.testing.assert_array_equal(
            m, jep.within_expert_masks(token_masks, sel, e))
    expert_pl, neuron_pls = ep.hierarchical_moe_placement(sel, masks, E,
                                                          **CPU)
    jexpert_pl, jneuron_pls = jep.hierarchical_moe_placement(sel, masks, E)
    np.testing.assert_array_equal(expert_pl.placement, jexpert_pl.placement)
    for pl, jpl in zip(neuron_pls, jneuron_pls):
        np.testing.assert_array_equal(pl.placement, jpl.placement)
