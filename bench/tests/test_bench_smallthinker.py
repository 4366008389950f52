"""SmallThinker's architecture module, its plain reference and its cell at a
CPU test's size: the readers' counts against hand sums, the weight recipe,
the reference against the port, and a tiny traced cell through `run_cell`
with the new readers and the faults the check has to catch."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from bench_tiny import BENCH, ROOT, load_json
from nlbench import harness
from nlbench.harness import Profile, run_cell
from nlbench.spec import Cell, _metrics, arch_module, layer_reader

arch = arch_module("smallthinker", BENCH)
CELL = "smallthinker-21b-a3b.resident.doc32"
NEW_READERS = ("moe.host_ms", "moe.expert_roofline", "swa_decode_roofline")
# The limit at this size, on the mean squared gap as the cell's: over 8
# seeds (2**31 + 21 on, 40 steps) sound runs read 0 to 4.6e-6, the control
# 3.8e-4 to 3.2e-3, a ring not cleared 0.064 to 0.28, the last pair dropped
# 8.9e-6 to 2.5e-3 (1.8e-3 at the fault test's seed); 5e-5 lies 11x above
# the sound runs and 7.6x below the control
TINY_LIMITS = {"mean_sq_logit_gap": 5e-5}


def published():
    return load_json(BENCH / "configs" / "smallthinker-21b-a3b.json")


def tiny_config(dtype="bfloat16"):
    cfg = published()
    L = 8
    cfg.update(num_hidden_layers=L, hidden_size=64, num_attention_heads=14,
               num_key_value_heads=2, head_dim=16, moe_num_primary_experts=8,
               moe_num_active_primary_experts=3, moe_ffn_hidden_size=32,
               vocab_size=512, sliding_window_size=12, dtype=dtype,
               rope_layout=cfg["rope_layout"][:L],
               sliding_window_layout=cfg["sliding_window_layout"][:L])
    return cfg


def tiny_cell(limits=None):
    bench = load_json(ROOT / "BENCHMARK.json")
    mix = load_json(BENCH / "traffic" / "doc32.json")
    mix.update(sessions=4, max_slots=4, max_context=64,
               prompt_tokens={"dist": "uniform", "low": 14, "high": 30},
               output_tokens={"dist": "uniform", "low": 8, "high": 16},
               warmup={"min_steps": 4, "stagger": "equilibrium"},
               check={"sample_requests": 4})
    e2e = [m for m in _metrics(bench["end_to_end"], "e2e") if m.applies_to(CELL)]
    per = [m for m in _metrics(bench["per_layer"], "layer") if m.applies_to(CELL)]
    cell = {"mode": "resident", "limits": dict(limits or TINY_LIMITS)}
    return Cell(name=CELL, chips=1, config=tiny_config(), traffic=mix,
                cell=cell, end_to_end=e2e, per_layer=per)


# -- counts --------------------------------------------------------------------------

def test_counts_against_hand_sums():
    cfg = published()
    d, H, KV, hd, E, K, f, V, W = 2560, 28, 4, 128, 64, 6, 768, 151936, 4096
    proj = 2 * d * (H * hd + 2 * KV * hd) + 2 * H * hd * d + 2 * d * E
    for c in (100, 4096, 10000):
        want = 52 * proj + 13 * 4 * H * hd * c + 39 * 4 * H * hd * min(c, W) \
            + 2 * d * V
        assert arch.decode_row_flops(cfg, c) == want
    assert arch.ffn_flops(cfg, 768) == 3 * 2 * d * 768
    assert arch.decode_row_ffn_flops(cfg) == 52 * 6 * 3 * 2 * d * f
    T = 6000
    full = sum(t + 1 for t in range(T))
    win = sum(min(t + 1, W) for t in range(T))
    want = 52 * T * (proj + 6 * d * K * f) + 13 * 4 * H * hd * full \
        + 39 * 4 * H * hd * win + 2 * d * V
    assert arch.prefill_flops(cfg, T) == want
    assert arch.paged_attention(cfg) == {"calls": 13, "heads": 28,
                                         "head_dim": 128, "kv_bytes": 2048}
    assert arch.swa_attention(cfg) == {"calls": 39, "window": 4096,
                                       "heads": 28, "head_dim": 128,
                                       "kv_bytes": 2048, "elem": 2}
    assert arch.expert_bytes(cfg) == 3 * 2560 * 768 * 2
    assert arch.period(cfg) == 4
    # 21.51 B parameters, 43.0 GB in bf16
    n = 2 * V * d + d + 52 * (2 * d + d * E + d * H * hd * 2 + 2 * d * KV * hd
                              + 3 * E * d * f)
    assert round(n / 1e9, 2) == 21.51


def test_model_config_reads_the_published_keys():
    from repro_torch.configs import base
    m = arch.model_config(published(), 10240, base)
    assert (m.n_layers, m.d_model, m.head_dim, m.n_heads, m.n_kv_heads) == \
        (52, 2560, 128, 28, 4)
    assert m.attn_kinds()[:4] == ("nope", "window", "window", "window")
    assert (m.sliding_window, m.rope_theta, m.flash_triangular) == \
        (4096, 1.5e6, True)
    assert m.moe.dropless and m.moe.router_input == "pre_attention"
    assert m.moe.activation == "relu" and m.moe.top_k == 6


# -- the weight recipe and the reference -------------------------------------------------

def test_a_redrawn_layer_equals_the_programs_copy():
    cfg = tiny_config()
    recipe, _ = arch.make_weights(cfg, 2**40 + 5, "cpu")
    params = arch.program_params(recipe)
    for l in (6, 0, 5):                          # any order: a generator a tensor
        sp = params["stack"][l // 4][f"sub_{l % 4}"]
        got = recipe.layer(l)
        assert torch.equal(got["wq"], sp["mixer"]["wq"])
        assert torch.equal(got["w_down"], sp["ffn"]["w_down"])
        assert torch.equal(got["norm2"], sp["norm2"]["scale"])
        assert got["w_gate"].dtype == torch.bfloat16
    assert torch.equal(recipe.tensor("lm_head"), params["embed"]["lm_head"])
    other, _ = arch.make_weights(cfg, 2**40 + 6, "cpu")
    assert not torch.equal(other.layer(0)["wq"], recipe.layer(0)["wq"])


def test_reference_matches_the_port():
    """The port's float32 model on the recipe's weights against the
    reference, on logits (2e-4: float32 both, summation orders alone)."""
    from repro_torch.configs import base
    from repro_torch.models.model import Model
    cfg = tiny_config("float32")
    recipe, _ = arch.make_weights(cfg, 11, "cpu")
    model = Model(arch.model_config(cfg, 64, base), device="cpu")
    params = arch.program_params(recipe)
    toks = torch.randint(0, cfg["vocab_size"], (40,),
                         generator=torch.Generator().manual_seed(1))
    got = model.forward(params, {"tokens": toks[None]})["logits"][0]
    ref = arch.forward_logits(recipe, cfg, toks, range(40))
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-4)
    # the control rounds every matrix through float8: far from both
    from nlbench.correctness import to_fp8
    low = arch.forward_logits(recipe, cfg, toks, range(40), weight_map=to_fp8)
    assert float((low - ref).abs().max()) > 1e-2


# -- the tiny traced cell -----------------------------------------------------------------

def run_tiny(tmp_path, seed, trace=False, fault=None, control=False,
             views=None):
    """A tiny run over 40 steps. With `views`, every reader's view is
    kept there."""
    import time
    if views is not None:
        real = harness.layer_reader

        def keeping(name, bench):
            read = real(name, bench)

            def wrapped(view):
                views.append(view)
                return read(view)
            return wrapped
        harness.layer_reader = keeping
    try:
        return run_cell(tiny_cell(), seed, 1.0, trace, "cpu",
                        time.perf_counter(), log=lambda obj: None,
                        fault=fault, control=control, cache=tmp_path,
                        steps=40)
    finally:
        if views is not None:
            harness.layer_reader = real


def fake_profile(view):
    """A device profile of the window's decode steps, as the card would
    give it: per step one grouped-GEMM kernel a layer and one ring kernel
    a window layer, each starting inside its step's span."""
    from nlbench.serving_spans import serving_spans
    steps = [s for s in serving_spans(view) if s.name == "decode_step"
             and view.t0 <= s.a <= view.t1]
    kernels = []
    for s in steps:
        t = (s.a + s.b) / 2 * 1e6
        kernels += [("cutlass::GemmUniversal<GroupProblemShape<...>>", t, 3.0)] * 8
        kernels += [("void swa_split_kernel<bf16>", t, 2.0)] * 6
    return Profile(host_t0=steps[0].a, host_t1=steps[-1].b,
                   steps=list(view.window_steps), kernels=kernels,
                   busy_s=0.0, window_s=steps[-1].b - steps[0].a, to_host=0.0)


def test_tiny_cell_is_correct_and_its_readers_read(tmp_path):
    views = []
    res = run_tiny(tmp_path, 2**31 + 21, trace=True, control=True,
                   views=views)
    assert res["correct"], res["checks"]
    assert res["control"]["mean_sq_logit_gap"] > \
        TINY_LIMITS["mean_sq_logit_gap"], res
    m = res["metrics"]
    assert m["moe.host_ms"]["value"] > 0
    view = dataclasses.replace(views[0])
    view.profile = fake_profile(view)
    for name in NEW_READERS:
        v = layer_reader(name, BENCH)(view)
        assert v is not None and 0 < v < float("inf"), name
    # the expert reader: distinct experts' bytes over 3.35 TB/s against
    # 8 launches of 3 us a step
    counts = [e["args"]["experts"] for e in view.spans
              if e.get("ph") == "i" and e["name"] == "moe_experts"]
    assert counts and all(len(c) == 8 for c in counts)


def ring_not_cleared(server, runtime):
    """A slot's rings are written at its first admission only: a reused
    slot keeps its last request's ring."""
    write = server._write_slot
    used = set()

    def once(slot, small, rings_only=False):
        if rings_only:
            if slot in used:
                return
            used.add(slot)
        return write(slot, small, rings_only)
    server._write_slot = once


def pair_dropped(monkeypatch):
    """Decode leaves out each row's last routed pair (its gate weight 0,
    the others as they were), as a capacity overflow drops a pair."""
    from repro_torch.models import moe as moe_lib
    real = moe_lib.moe_forward_dropless

    def dropped(p, x, cfg, routing=None):
        if x.shape[1] == 1 and routing is not None:
            probs, w, sel = routing
            routing = (probs, torch.cat([w[:, :-1], 0 * w[:, -1:]], 1), sel)
        return real(p, x, cfg, routing)

    def fault(server, runtime):
        monkeypatch.setattr(moe_lib, "moe_forward_dropless", dropped)
    return fault


@pytest.mark.parametrize("fault", ["ring_not_cleared", "pair_dropped"])
def test_planted_faults_are_not_correct(fault, tmp_path, monkeypatch):
    make = {"ring_not_cleared": lambda: ring_not_cleared,
            "pair_dropped": lambda: pair_dropped(monkeypatch)}
    res = run_tiny(tmp_path, 2**31 + 22, fault=make[fault]())
    assert not res["correct"], res["checks"]
