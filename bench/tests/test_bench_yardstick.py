"""The benchmark's frozen arithmetic against hand-worked cases: the UFS
4.0 price of a read, the paged kernel's roofline and the server's tails."""
from __future__ import annotations

import types

import pytest

import bench_tiny
from nlbench.harness import Profile, Recorder, Tok, flash_ms_per_tok
from nlbench.spec import arch_module, layer_reader
from nlbench.yardstick import p95, ufs40_read_seconds


def test_one_4k_extent_on_ufs40():
    assert ufs40_read_seconds(1, 4096) == pytest.approx(
        40e-6 + 1 / 150_000 + 4096 / 3.6e9, rel=1e-12)
    assert ufs40_read_seconds(0, 0) == 0.0
    assert ufs40_read_seconds(3, 3 * 2048) == pytest.approx(
        40e-6 + 3 / 150_000 + 6144 / 3.6e9, rel=1e-12)


def test_flash_ms_per_token_prices_each_read_call():
    rec = Recorder()
    rec.reads = [(1.0, 1, 4096), (1.5, 2, 8192), (3.0, 5, 10_000)]
    want = 1e3 * (ufs40_read_seconds(1, 4096) + ufs40_read_seconds(2, 8192)) / 4
    assert flash_ms_per_tok(rec, 0.5, 2.0, 4) == pytest.approx(want)


def _view(cfg, mode, traffic, profile, rec):
    cell = types.SimpleNamespace(mode=mode, traffic=traffic)
    from nlbench.harness import View
    return View(cell=cell, cfg=cfg, arch=arch_module("opt"), t0=0.0,
                t1=10.0, rec=rec, window_steps=[0], decode_tokens=0,
                stats0={}, stats1={}, history=None, spans=None,
                profile=profile)


def test_paged_decode_roofline_hand_case():
    """opt-1.3b heads (32 x 64, bf16 arena, page 16), one step, two rows
    attending 100 and 17 positions, 24 launches of 10 us each: the bytes
    are 2 x 117 x 32 x 64 x 2 of K and V, 4 x (7 + 2) of page entries, 4 x
    2 of positions and 2 x 2 x 32 x 64 x 4 of q and out."""
    cfg = bench_tiny.load_json(bench_tiny.BENCH / "configs" / "opt-1.3b.json")
    rec = Recorder()
    rec.prompt = {1: [0] * 90, 2: [0] * 10}
    rec.tokens = [Tok(1.0, 0, 1, 11, 5), Tok(1.0, 0, 2, 8, 5)]
    prof = Profile(host_t0=0.0, host_t1=2.0, steps=[0], busy_s=0, window_s=0,
                   to_host=0.0,
                   kernels=[("void paged_split_kernel<bf16>", 0.0, 10.0)] * 24)
    got = layer_reader("paged_decode_roofline")(
        _view(cfg, "resident", {"max_slots": 2}, prof, rec))
    nbytes = 2 * 117 * 32 * 64 * 2 + 4 * 9 + 4 * 2 + 2 * 2 * 32 * 64 * 4
    assert got == pytest.approx(100 * (nbytes / 3.35e12) / 10e-6)


@pytest.mark.parametrize("mode", ["resident", "offload"])
def test_model_mfu_hand_case(mode):
    """opt-1.3b (d 2,048, 24 layers, d_ff 8,192, vocab 50,272), a window of
    10 s: step 0 decodes two rows attending 100 and 17 positions and
    prefills a prompt of 30; in offload two FFN calls serve unions of 500
    and 300 neurons over 2 and 1 rows. Counted as the reader counted from
    OPT's keys before the architecture module gave the counts."""
    cfg = bench_tiny.load_json(bench_tiny.BENCH / "configs" / "opt-1.3b.json")
    rec = Recorder()
    rec.prompt = {1: [0] * 90, 2: [0] * 10, 3: [0] * 30}
    rec.tokens = [Tok(1.0, 0, 1, 11, 5), Tok(1.0, 0, 2, 8, 5),
                  Tok(1.0, 0, 3, 1, 5)]
    rec.ffn = [(1.0, 0, 2, 700, 500), (1.0, 1, 1, 300, 300),
               (11.0, 2, 1, 5, 5)]
    got = layer_reader("model.mfu")(_view(cfg, mode, {}, None, rec))
    d, f, L, V = 2048, 8192, 24, 50272
    flops = 0.0 + L * (8 * d * d * 2 + 4 * d * 117) + 2 * d * V * 2
    flops += L * 4 * d * f * 2 if mode == "resident" else \
        4 * d * 500 * 2 + 4 * d * 300 * 1
    flops += L * (8 * d * d * 30 + 2 * d * 30 * 30 + 4 * d * f * 30) + 2 * d * V
    assert got == 100.0 * flops / (10.0 * 989e12)


def test_p95_of_a_known_sample():
    assert p95(list(range(101))) == pytest.approx(95.0)


def test_server_tails_read_the_window_only():
    """Two requests: one sent at 1.0 s, first token at 1.5 s, then tokens
    at 2.0 and 4.0 s; one sent at 11.0 s, after the window [0, 10]. The
    gaps in the window are 500 and 2,000 ms, the first-token time 500 ms;
    a window with nothing in it reads nothing."""
    rec = Recorder()
    rec.submit = {1: 1.0, 2: 11.0}
    rec.by_uid = {1: [Tok(t, 0, 1, n, 0) for n, t in
                      enumerate((1.5, 2.0, 4.0), start=1)],
                  2: [Tok(11.2, 9, 2, 1, 0), Tok(11.4, 10, 2, 2, 0)]}
    view = _view({}, "resident", {}, None, rec)
    assert layer_reader("server.itl_p95_ms")(view) == pytest.approx(
        p95([500.0, 2000.0]))
    assert layer_reader("server.ttft_p95_ms")(view) == pytest.approx(500.0)
    view.t0, view.t1 = 20.0, 30.0
    assert layer_reader("server.itl_p95_ms")(view) is None
    assert layer_reader("server.ttft_p95_ms")(view) is None
