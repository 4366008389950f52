"""The benchmark's weights: the paper's activation share planted, the same
bits for one seed, and co-activation that linked placement turns into
fewer reads than the identity layout."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import bench_tiny  # noqa: F401  (puts bench/ and src/ on the path)
from bench_tiny import tiny_config
from reference.opt_reference import layer_shares
from weights import group_rates, make_weights


def test_group_rates_mean_is_the_target():
    for target in (0.0949, 0.0409):
        rates = group_rates(target, 64, 1.1, 0.5)
        assert abs(sum(rates) / 64 - target) < 1e-9
        assert max(rates) <= 0.5 and rates == sorted(rates, reverse=True)


@pytest.mark.parametrize("name", ["opt-350m", "opt-1.3b"])
def test_activation_share_lands_on_target(name):
    cfg = tiny_config(name)
    cfg["sparsity"] = dict(cfg["sparsity"], calib_batch=4, calib_seqlen=64)
    w, rep = make_weights(cfg, 2**33 + 17, "cpu")
    target = cfg["sparsity"]["target"]
    for s in rep["calib_shares"]:
        assert abs(s - target) < 0.02 * target
    # fresh tokens: the share is the calibration's up to sampling noise
    gen = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg["vocab_size"], (4, 64), generator=gen)
    for s in layer_shares(w, cfg, toks):
        assert abs(s - target) < 0.35 * target


def test_weights_repeat_bit_for_bit():
    cfg = tiny_config()
    a, _ = make_weights(cfg, 2**31 + 11, "cpu")
    b, _ = make_weights(cfg, 2**31 + 11, "cpu")
    c, _ = make_weights(cfg, 2**31 + 12, "cpu")
    flat = lambda w: [w["embedding"], w["lm_head"]] + [  # noqa: E731
        t for lw in w["layers"] for k, t in lw.items() if torch.is_tensor(t)]
    assert all(torch.equal(x, y) for x, y in zip(flat(a), flat(b)))
    assert not torch.equal(a["layers"][0]["w_up"], c["layers"][0]["w_up"])


def test_linked_placement_reads_fewer_extents_than_identity(capsys):
    """opt-350m's widths (two of its 24 layers), chat4's rows: the masks of
    the prompts' tokens, four sessions' tokens a step, through the port's
    co-activation counts, `search_placement` and `OffloadEngine`
    (EngineConfig defaults): linked placement issues fewer extent reads a
    token than the identity layout."""
    from repro_torch.core.coactivation import CoActivationStats
    from repro_torch.core.engine import EngineConfig, OffloadEngine
    from repro_torch.core.placement import identity_placement, search_placement
    from reference.opt_reference import attention, layer_norm
    import bench_tiny as bt

    cfg = bt.load_json(bt.BENCH / "configs" / "opt-350m.json")
    cfg["n_layers"] = 2
    cfg["sparsity"] = dict(cfg["sparsity"], calib_batch=4, calib_seqlen=64)
    w, _ = make_weights(cfg, 2**32 + 7, "cpu")
    f = cfg["d_ff"]
    gen = torch.Generator().manual_seed(9)

    def masks_of(tokens):
        out = []
        x = w["embedding"].float()[tokens]
        for lw in w["layers"]:
            x = x + attention(layer_norm(x, lw["norm1"]), lw, cfg)
            pre = layer_norm(x, lw["norm2"]) @ lw["w_up"].float()
            out.append((pre > 0).numpy())
            x = x + torch.relu(pre) @ lw["w_down"].float()
        return out

    calib = [masks_of(torch.randint(0, cfg["vocab_size"], (256,),
                                    generator=gen)) for _ in range(4)]
    sessions = [masks_of(torch.randint(0, cfg["vocab_size"], (96,),
                                       generator=gen)) for _ in range(4)]
    reads = {}
    for mode in ("identity", "linked"):
        total, tokens = 0, 0
        for layer in range(cfg["n_layers"]):
            if mode == "linked":
                stats = CoActivationStats(f, device="cpu")
                for c in calib:
                    stats.update(c[layer].astype(np.uint8))
                placement = search_placement(stats.distance_matrix())
            else:
                placement = identity_placement(f)
            eng = OffloadEngine(np.zeros((f, 8), np.float32), placement,
                                config=EngineConfig(), bundle_bytes=2048)
            for t in range(96):
                step = np.stack([s[layer][t] for s in sessions])
                res = eng.step_masks(step, fetch_payload=False)
                total += res.merged.io.n_ops
                tokens += step.shape[0]
        reads[mode] = total / tokens
    with capsys.disabled():
        print(f"\nextent reads a token, a layer: identity {reads['identity']:.3f}"
              f" linked {reads['linked']:.3f}")
    assert reads["linked"] < reads["identity"]
