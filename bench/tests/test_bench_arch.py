"""A configuration brings its own architecture: the harness, the check and
the readers take the model's shape from the module the configuration names
(`bench/arch/<arch>.py`), so a second architecture enters by new files and
entries alone. The OPT module gives what the harness ran before it, and
the store's own counters give the extents and bytes of each read call."""
from __future__ import annotations

import json
import shutil
import time

import torch

import bench_tiny
from nlbench.spec import arch_module, check_names, load_cell, load_json
from test_bench_check import token_altered
from test_bench_reference import imports_of_the_program

NEW_CELL = "toy-gqa.resident.chat4"

# A decoder unlike OPT's: grouped-query attention (4 query heads over 2 KV
# heads) and RMSNorm without a bias, so the program's parameter tree has
# narrower K and V projections and no norm biases. Its weights are drawn
# plainly from the seed, and its reference is plain float32 torch.
TOY_ARCH = '''"""A toy GQA decoder with RMSNorm and a ReLU FFN: weights, reference
and shape counts."""
from __future__ import annotations

import hashlib
from typing import Dict, List

import torch

EPS = 1e-6


def model_config(cfg: Dict, max_len: int, configs):
    return configs.ModelConfig(
        arch_id=cfg["name"], family="dense", source=cfg["source"],
        n_layers=cfg["n_layers"], d_model=cfg["d_model"],
        n_heads=cfg["n_heads"], n_kv_heads=cfg["n_kv_heads"],
        d_ff=cfg["d_ff"], vocab_size=cfg["vocab_size"], activation="relu",
        norm="rmsnorm", rope_theta=cfg["rope_theta"], max_seq_len=max_len,
        param_dtype=cfg["dtype"], compute_dtype=cfg["dtype"], remat=False)


def make_weights(cfg: Dict, seed: int, device):
    d, f, V = cfg["d_model"], cfg["d_ff"], cfg["vocab_size"]
    H, KV, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    dt = getattr(torch, cfg["dtype"])
    s = hashlib.sha256(f"{cfg['name']}|{int(seed)}".encode()).digest()
    gen = torch.Generator(device=device).manual_seed(
        int.from_bytes(s[:8], "little") >> 1)

    def w(shape, std):
        return torch.randn(shape, generator=gen, device=device).mul_(std).to(dt)

    def norm():
        return {"scale": torch.ones(d, device=device).to(dt)}

    layers = [{"norm1": norm(), "wq": w((d, H * hd), d ** -0.5),
               "wk": w((d, KV * hd), d ** -0.5), "wv": w((d, KV * hd), d ** -0.5),
               "wo": w((H * hd, d), (H * hd) ** -0.5), "norm2": norm(),
               "w_up": w((d, f), d ** -0.5), "w_down": w((f, d), f ** -0.5)}
              for _ in range(cfg["n_layers"])]
    return {"embedding": w((V, d), 1.0), "lm_head": w((d, V), d ** -0.5),
            "final_norm": norm(), "layers": layers}, {}


def program_params(weights: Dict) -> Dict:
    c = lambda t: t.clone()                                     # noqa: E731
    stack = [{"sub_0": {
        "norm1": {"scale": c(lw["norm1"]["scale"])},
        "mixer": {k: c(lw[k]) for k in ("wq", "wk", "wv", "wo")},
        "norm2": {"scale": c(lw["norm2"]["scale"])},
        "ffn": {"w_up": c(lw["w_up"]), "w_down": c(lw["w_down"])}}}
        for lw in weights["layers"]]
    return {"embed": {"embedding": c(weights["embedding"]),
                      "lm_head": c(weights["lm_head"])},
            "stack": stack,
            "final_norm": {"scale": c(weights["final_norm"]["scale"])}}


def rms_norm(x, p):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + EPS) \\
        * p["scale"].float()


def rope(x, theta):
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = torch.arange(x.shape[0], device=x.device).float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def forward_logits(weights, cfg, tokens, positions_out, decode_from=None,
                   decode_ffn=None, weight_map=None):
    wm = weight_map or (lambda t: t.float())
    H, KV, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    x = wm(weights["embedding"])[tokens.long()].float()
    T = x.shape[0]
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    for lw in weights["layers"]:
        h = rms_norm(x, lw["norm1"])
        q = rope((h @ wm(lw["wq"])).view(T, H, hd), cfg["rope_theta"])
        k = rope((h @ wm(lw["wk"])).view(T, KV, hd), cfg["rope_theta"])
        v = (h @ wm(lw["wv"])).view(T, KV, hd)
        k = k.repeat_interleave(H // KV, dim=1)
        v = v.repeat_interleave(H // KV, dim=1)
        s = torch.einsum("thd,shd->hts", q, k) * hd ** -0.5
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        x = x + torch.einsum("hts,shd->thd", p, v).reshape(T, H * hd) \\
            @ wm(lw["wo"])
        h2 = rms_norm(x, lw["norm2"])
        x = x + torch.relu(h2 @ wm(lw["w_up"])) @ wm(lw["w_down"])
    idx = torch.as_tensor(list(positions_out), device=x.device).long()
    return rms_norm(x[idx], weights["final_norm"]) @ wm(weights["lm_head"])


def ffn_neurons(cfg: Dict) -> List[int]:
    return [cfg["d_ff"]] * cfg["n_layers"]


def decode_row_flops(cfg: Dict, c: int) -> int:
    d, H, KV, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    per_layer = 2 * d * (2 * H + 2 * KV) * hd + 4 * H * hd * c
    return cfg["n_layers"] * per_layer + 2 * d * cfg["vocab_size"]


def ffn_flops(cfg: Dict, u: int) -> int:
    return 4 * cfg["d_model"] * u


def decode_row_ffn_flops(cfg: Dict) -> int:
    return cfg["n_layers"] * ffn_flops(cfg, cfg["d_ff"])


def prefill_flops(cfg: Dict, T: int) -> int:
    d, H, KV, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    per_layer = (2 * d * (2 * H + 2 * KV) * hd * T + 2 * H * hd * T * T
                 + 4 * d * cfg["d_ff"] * T)
    return cfg["n_layers"] * per_layer + 2 * d * cfg["vocab_size"]


def paged_attention(cfg: Dict) -> Dict[str, int]:
    elem = {"bfloat16": 2, "float32": 4}[cfg["dtype"]]
    return {"calls": cfg["n_layers"], "heads": cfg["n_heads"],
            "head_dim": cfg["head_dim"],
            "kv_bytes": 2 * cfg["n_kv_heads"] * cfg["head_dim"] * elem}
'''

TOY_CONFIG = {
    "name": "toy-gqa", "source": "a CPU test's toy", "arch": "toy_gqa",
    "n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
    "head_dim": 16, "d_ff": 128, "vocab_size": 512, "rope_theta": 10000.0,
    "dtype": "bfloat16", "serving": {"page_size": 16},
    "offload": {"oracle": False, "prefetch": False}}


def toy_root(tmp_path):
    """A copy of the benchmark with the toy architecture, its configuration
    and a resident cell added as new files and entries; asserts that no
    file that was there changed."""
    root = tmp_path / "root"
    root.mkdir()
    shutil.copy(bench_tiny.ROOT / "BENCHMARK.json", root)
    shutil.copytree(bench_tiny.BENCH, root / "bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file()}
    bench_dir = root / "bench"
    (bench_dir / "arch" / "toy_gqa.py").write_text(TOY_ARCH)
    (bench_dir / "configs" / "toy-gqa.json").write_text(json.dumps(TOY_CONFIG))
    (bench_dir / "cells" / f"{NEW_CELL}.json").write_text(json.dumps(
        {"mode": "resident", "limits": {"logit_gap": 0.06}}))
    bench = load_json(root / "BENCHMARK.json")
    bench["configs"].append({"name": "toy-gqa", "source": "a CPU test's toy",
                             "file": "bench/configs/toy-gqa.json",
                             "reduced": [], "why": "a second architecture"})
    bench["workloads"].append({"name": NEW_CELL, "config": "toy-gqa",
                               "traffic": "chat4", "chips": 1,
                               "why": "GQA and RMSNorm, resident"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("out_tok_s", "model.mfu"):
            m["workloads"].append(NEW_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert check_names(bench) == []
    assert {p: p.read_bytes() for p in before} == before
    return root


def test_a_second_architecture_enters_by_new_files(tmp_path):
    from nlbench.harness import run_cell
    root = toy_root(tmp_path)
    assert imports_of_the_program(root / "bench") == {}
    cell = load_cell(NEW_CELL, root)
    assert cell.bench == root / "bench" and cell.mode == "resident"
    cell.traffic = bench_tiny.tiny_traffic()

    def run(trace=False, fault=None):
        return run_cell(cell, 2**31 + 41, 0.0, trace, "cpu",
                        time.perf_counter(), log=lambda obj: None,
                        fault=fault, cache=tmp_path / "cache", steps=80)

    # the program's tree is the toy's: K and V half as wide, no norm biases
    toy = arch_module("toy_gqa", cell.bench)
    w, _ = toy.make_weights(cell.config, 1, "cpu")
    p = toy.program_params(w)["stack"][0]["sub_0"]
    assert p["mixer"]["wk"].shape == (64, 32) and set(p["norm1"]) == {"scale"}

    res = run()
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["checks"]["logit_gap"]["value"] < 0.06
    bad = run(fault=token_altered)
    assert not bad["correct"], bad["checks"]
    traced = run(trace=True)
    assert traced["correct"] and traced["metrics"]["model.mfu"]["value"] > 0


def parent_program_params(weights):
    """The harness's `program_params` as it was before the architecture
    module took it over."""
    c = lambda t: t.clone()                                     # noqa: E731
    norm = lambda p: {"scale": c(p["scale"]), "bias": c(p["bias"])}  # noqa
    stack = [{"sub_0": {
        "norm1": norm(lw["norm1"]),
        "mixer": {k: c(lw[k]) for k in ("wq", "wk", "wv", "wo")},
        "norm2": norm(lw["norm2"]),
        "ffn": {"w_up": c(lw["w_up"]), "w_down": c(lw["w_down"])}}}
        for lw in weights["layers"]]
    return {"embed": {"embedding": c(weights["embedding"]),
                      "lm_head": c(weights["lm_head"])},
            "stack": stack, "final_norm": norm(weights["final_norm"])}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def test_the_opt_module_gives_what_the_harness_ran_before():
    """The same weights, reference, pack key and seed, and the same
    parameter tree, bit for bit, as the harness built from OPT's keys."""
    import weights as opt_weights
    from reference import opt_reference
    from repro_torch.configs import base
    opt = arch_module("opt")
    assert opt.make_weights is opt_weights.make_weights
    assert opt.forward_logits is opt_reference.forward_logits
    assert opt.ffn_fingerprint is opt_weights.ffn_fingerprint
    cfg = bench_tiny.tiny_config("opt-350m")
    seed = 2**33 + 5
    assert opt.pack_seed(cfg, seed) == opt_weights.seed_for(cfg, seed, 2)
    w, _ = opt.make_weights(cfg, seed, "cpu")
    got = list(_leaves(opt.program_params(w)))
    want = list(_leaves(parent_program_params(w)))
    assert [p for p, _ in got] == [p for p, _ in want]
    assert all(torch.equal(a, b) and a.dtype == b.dtype
               for (_, a), (_, b) in zip(got, want))
    for (up, down), lw in zip(opt.pack_rows(w), w["layers"]):
        up0, down0 = opt_reference.pack_rows_int8(lw["w_up"], lw["w_down"])
        assert torch.equal(up, up0) and torch.equal(down, down0)
    mc = opt.model_config(cfg, 64, base)
    assert (mc.family, mc.n_layers, mc.d_model, mc.n_heads, mc.n_kv_heads,
            mc.d_ff, mc.activation, mc.norm, mc.param_dtype, mc.remat) == \
        ("dense", 2, 64, 4, 4, 256, "relu", "layernorm", "bfloat16", False)
    assert opt.ffn_neurons(cfg) == [256, 256]


def test_extents_are_counted_at_the_stores_own_counters(tmp_path,
                                                        monkeypatch):
    """Read call by read call, what the harness records (the store's
    `IOStats.measured_ops` / `measured_bytes`) is the number of extent reads
    and their bytes, counted here at each store's `_read_extent`."""
    from nlbench import harness
    recs, calls = [], []

    class Recorder(harness.Recorder):
        def __init__(self):
            super().__init__()
            recs.append(self)

    def count(server, runtime):
        for eng in runtime.engines:
            store = eng.store

            def read(*a, _read=store.read, **kw):
                calls.append([0, 0])
                return _read(*a, **kw)

            def read_extent(*a, _extent=store._read_extent, **kw):
                out = _extent(*a, **kw)
                calls[-1][0] += 1
                calls[-1][1] += int(out.nbytes)
                return out
            store.read, store._read_extent = read, read_extent

    monkeypatch.setattr(harness, "Recorder", Recorder)
    res, _ = bench_tiny.run_tiny("offload", tmp_path, seed=2**31 + 43,
                                 fault=count, steps=40)
    assert res["correct"], res["checks"]
    got = [(ops, nbytes) for _, ops, nbytes in recs[0].reads]
    assert got == [tuple(c) for c in calls]
    assert sum(ops for ops, _ in got) > 0 and any(ops > 1 for ops, _ in got)
