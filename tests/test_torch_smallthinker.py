"""SmallThinker on the port's normal path, against its plain reference.

`configs/smallthinker_21b_a3b.reduced()` (two periods of the layout: a
full NoPE layer and three RoPE window layers each; 14 query heads of 16 over
2 KV heads, so G = 7 and H x hd = 224 against d_model 64; 8 ReGLU experts,
top 3, routed from the attention's input, none dropped) with the port's
seeded float32 weights, served through `InferenceServer` with paged full
layers and ring window layers, against `bench/reference/smallthinker_reference.py`
(plain float32 torch, no cache) on the same weights.

Tolerance on logits: 2e-4. Both sides compute in float32 and differ only
in summation order: the reference attends over blocks of queries and sums
each expert's rows alone; the port's prefill attends over the whole prompt,
its decode through the paged and ring kernels' plain versions (their own
softmax order), and its expert products as grouped products. Those orders
move a logit of magnitude about 1 by 1e-6 to 1e-5; 2e-4 leaves room for it
and none for a wrong position, a missing RoPE, a stale ring or a dropped
expert, each of which moves logits by 1e-2 or more.
"""
from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import smallthinker_21b_a3b as st
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer
from repro_torch.models.layers import apply_norm, attention_forward
from repro_torch.models.model import Model
from repro_torch.obs import disable_tracing, enable_tracing
from repro_torch.serving.engine import Request
from repro_torch.serving.server import InferenceServer

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "smallthinker_reference",
    ROOT / "bench" / "reference" / "smallthinker_reference.py")
reference = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(reference)

TOL = dict(rtol=2e-4, atol=2e-4)


class ParamsRecipe:
    """The reference's weight interface over the port's parameter tree."""

    def __init__(self, params, cfg):
        self.params, self.P = params, transformer.stack_period(cfg)

    def tensor(self, name):
        p = self.params
        return {"embedding": p["embed"]["embedding"],
                "lm_head": p["embed"]["lm_head"],
                "final_norm": p["final_norm"]["scale"]}[name]

    def layer(self, l):
        sp = self.params["stack"][l // self.P][f"sub_{l % self.P}"]
        return {"norm1": sp["norm1"]["scale"], "norm2": sp["norm2"]["scale"],
                **sp["mixer"], **sp["ffn"]}


def ref_config(cfg):
    """The model's config.json keys, as the reference reads them."""
    window = [int(k == "window") for k in cfg.attn_kinds()]
    return {"num_hidden_layers": cfg.n_layers, "hidden_size": cfg.d_model,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
            "moe_num_primary_experts": cfg.moe.n_experts,
            "moe_num_active_primary_experts": cfg.moe.top_k,
            "moe_ffn_hidden_size": cfg.moe.d_ff_expert,
            "vocab_size": cfg.vocab_size, "rms_norm_eps": 1e-6,
            "rope_theta": cfg.rope_theta,
            "sliding_window_size": cfg.sliding_window,
            "sliding_window_layout": window, "rope_layout": window}


@pytest.fixture(scope="module")
def built():
    cfg = st.reduced()
    model = Model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(7))
    return cfg, model, params


def ref_logits(cfg, params, tokens, positions):
    return reference.forward_logits(
        ParamsRecipe(params, cfg), ref_config(cfg),
        torch.as_tensor(np.asarray(tokens, np.int64)), positions)


def serve(model, params, requests, **server_kw):
    """Serve `requests` [(prompt, n)], recording the logits behind every
    token: {uid: [V] rows in token order}."""
    seen = {}
    box = {}
    by_prompt = {np.asarray(p, np.int64).tobytes(): u
                 for u, (p, _) in enumerate(requests)}

    def prefill_fn(p, toks, c):
        logits, c = model.prefill(p, {"tokens": toks}, c)
        seen.setdefault(by_prompt[toks[0].numpy().tobytes()], []).append(
            logits[0, -1].clone())
        return logits, c

    def decode_fn(p, toks, pos, c, pt=None):
        logits, c = model.decode_step(p, toks, pos, c, page_tables=pt)
        for slot, h in enumerate(box["server"]._slot_handle):
            if h is not None:
                seen[h.uid].append(logits[slot, 0].clone())
        return logits, c

    server = InferenceServer(model, params, prefill_fn=prefill_fn,
                             decode_fn=decode_fn, device="cpu", **server_kw)
    box["server"] = server
    handles = [server.submit(Request(uid=u, prompt=np.asarray(p, np.int32),
                                     max_new_tokens=n))
               for u, (p, n) in enumerate(requests)]
    server.drain()
    out = {h.uid: (h.result.tokens, seen[h.uid]) for h in handles}
    server.close()
    return out, server


def check_against_reference(cfg, params, requests, served):
    for u, (prompt, n) in enumerate(requests):
        tokens, rows = served[u]
        assert len(tokens) == n == len(rows)
        seq = list(prompt) + tokens[:-1]
        T = len(prompt)
        ref = ref_logits(cfg, params, seq, range(T - 1, T - 1 + n))
        torch.testing.assert_close(torch.stack(rows), ref, **TOL)


def prompts(cfg, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, L) for L in lengths]


PAGED = dict(page_size=4, num_pages=64, max_len=64)


def test_paged_and_ring_server_matches_reference(built):
    """Three requests at once, prompts shorter and longer than the window
    (12), decoded past it: logits at every served position."""
    cfg, model, params = built
    reqs = [(p, n) for p, n in zip(prompts(cfg, [5, 13, 30]), [14, 9, 6])]
    served, server = serve(model, params, reqs, max_slots=3, **PAGED)
    kinds = [type(c).__name__ for c in server._pool.cache_groups[0].values()]
    assert server._ringed and sorted(kinds) == ["PagedKVCache"] + ["SWACache"] * 3
    check_against_reference(cfg, params, reqs, served)


def test_a_context_past_the_window(built):
    """One request whose prompt and answer both pass the window: the ring
    wraps in the prefill and again in decode."""
    cfg, model, params = built
    reqs = [(prompts(cfg, [25], seed=1)[0], 20)]
    served, _ = serve(model, params, reqs, max_slots=2, **PAGED)
    check_against_reference(cfg, params, reqs, served)


def test_a_reused_slot_keeps_nothing_of_its_last_request(built):
    """One slot: a long request, then a shorter one in the same slot; its
    ring must hold nothing of the first (positions -1 where empty)."""
    cfg, model, params = built
    reqs = [(p, n) for p, n in zip(prompts(cfg, [28, 4], seed=2), [16, 8])]
    served, server = serve(model, params, reqs, max_slots=1, **PAGED)
    check_against_reference(cfg, params, reqs, served)
    ring = server._pool.cache_groups[0]["sub_1"]
    live = ring.pos[0][ring.pos[0] >= 0]
    assert int(live.max()) == 4 + 8 - 2 and int(live.numel()) == 11


def test_contiguous_server_keeps_rings_for_window_layers(built):
    cfg, model, params = built
    reqs = [(p, n) for p, n in zip(prompts(cfg, [18, 7], seed=3), [10, 12])]
    served, server = serve(model, params, reqs, max_slots=2, max_len=64)
    kinds = {type(c).__name__ for c in server._cache[0].values()}
    assert kinds == {"KVCache", "SWACache"}
    check_against_reference(cfg, params, reqs, served)


def test_every_row_routed_to_the_same_experts_drops_nothing(built):
    """A router of zeros ties every expert: every row takes experts 0, 1
    and 2 (ties to the lower index). Each of them gets every row; the
    capacity path would drop rows past its capacity, the dropless one
    must equal the reference."""
    cfg, model, params = built
    params = {**params, "stack": [
        {j: {**sp, "ffn": {**sp["ffn"],
                           "router": torch.zeros_like(sp["ffn"]["router"])}}
         for j, sp in g.items()} for g in params["stack"]]}
    reqs = [(p, 6) for p in prompts(cfg, [24, 20, 16], seed=4)]
    served, _ = serve(model, params, reqs, max_slots=3, **PAGED)
    check_against_reference(cfg, params, reqs, served)
    # the capacity dispatch of the same layer drops rows
    x = torch.randn(1, 24, cfg.d_model)
    sp = params["stack"][0]["sub_0"]["ffn"]
    cap = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           dropless=False))
    y_free, _ = moe_lib.moe_forward(sp, x, cfg)
    y_cap, _ = moe_lib.moe_forward(sp, x, cap)
    assert moe_lib._capacity(24, cap.moe) < 24
    assert not torch.allclose(y_free, y_cap, atol=1e-3)


def test_nope_layers_ignore_positions_and_window_layers_rope(built):
    """Shifting every position leaves a NoPE layer's keys as they were (no
    rotation) and rotates a window layer's; both outputs keep (RoPE is
    relative)."""
    cfg, model, params = built
    x = torch.randn(1, 10, cfg.d_model)
    pos = torch.arange(10)[None]
    for j, use_rope in ((0, False), (1, True)):
        sp = params["stack"][0][f"sub_{j}"]
        a = apply_norm(sp["norm1"], x, cfg)
        w, rope_on = transformer.layer_attention(cfg, cfg.attn_kinds()[j], 0)
        assert rope_on == use_rope and w == (cfg.sliding_window if j else 0)
        out0, k0, _ = attention_forward(sp["mixer"], a, pos, cfg, window=w,
                                        use_rope=rope_on)
        out1, k1, _ = attention_forward(sp["mixer"], a, pos + 37, cfg,
                                        window=w, use_rope=rope_on)
        torch.testing.assert_close(out0, out1, **TOL)
        assert torch.equal(k0, k1) != use_rope


def test_stack_forward_equals_prefill_and_reference(built):
    cfg, model, params = built
    toks = torch.as_tensor(prompts(cfg, [40], seed=5)[0])[None]
    full = model.forward(params, {"tokens": toks})["logits"][0]
    last, _ = model.prefill(params, {"tokens": toks},
                            model.init_cache(1, 64))
    torch.testing.assert_close(last[0, -1], full[-1], **TOL)
    ref = ref_logits(cfg, params, toks[0], range(40))
    torch.testing.assert_close(full, ref, **TOL)


def test_grouped_products_equal_the_loop():
    """`torch._grouped_mm` (the card's bf16 path; its own fallback here)
    against the per-expert loop, with empty groups."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(11, 16, generator=g)
    w = torch.randn(5, 16, 8, generator=g)
    ends = torch.tensor([3, 3, 7, 7, 11], dtype=torch.int32)
    loop = moe_lib.grouped_mm_loop(x, w, ends)
    torch.testing.assert_close(torch._grouped_mm(x, w, offs=ends), loop,
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(loop[3:7], x[3:7] @ w[2])


def test_decode_step_spans_and_expert_counts(built):
    """A traced paged decode: a `route` span inside each `mixer`, a `moe`
    span a layer, and after the step's logits copy one `moe_experts`
    instant with a count a layer, each the distinct experts routed to."""
    cfg, model, params = built
    tr = enable_tracing(1 << 16)
    try:
        reqs = [(p, 3) for p in prompts(cfg, [9, 14], seed=6)]
        serve(model, params, reqs, max_slots=2, **PAGED)
        events = tr.events()
        assert tr.take("moe_experts") == []
    finally:
        disable_tracing()
    names = [e["name"] for e in events if e.get("ph") == "X"]
    steps = names.count("decode_step")
    assert steps >= 2
    assert names.count("route") == names.count("moe") == cfg.n_layers * steps
    counts = [e["args"]["experts"] for e in events
              if e.get("ph") == "i" and e["name"] == "moe_experts"]
    assert len(counts) == steps
    for c in counts:
        assert len(c) == cfg.n_layers
        assert all(cfg.moe.top_k <= n <= cfg.moe.n_experts for n in c)


def test_windowed_everywhere_cannot_be_paged():
    cfg = st.reduced(attn_layout=("window",))
    with pytest.raises(ValueError, match="not windowed"):
        transformer.init_paged_stack_cache(cfg, 8, 4, "cpu")
    model = Model(st.reduced(), device="cpu")
    with pytest.raises(ValueError, match="swa"):
        InferenceServer(model, {}, swa=True, device="cpu", **PAGED)


def test_published_config():
    c = st.CONFIG
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.head_dim) == \
        (52, 2560, 28, 4, 128)
    assert c.attn_kinds().count("nope") == 13
    assert transformer.stack_period(c) == 4
    assert (c.moe.n_experts, c.moe.top_k, c.moe.d_ff_expert) == (64, 6, 768)
    r = st.reduced()
    assert r.n_heads * r.head_dim != r.d_model
    G = r.n_heads // r.n_kv_heads
    assert G & (G - 1)
    assert round(c.param_count() / 1e9, 2) == 21.51
