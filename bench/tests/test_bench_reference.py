"""The plain reference against the system under test on the CPU, at
reduced widths: the same logits as `repro_torch`'s resident forward, and
the same int8 rows as the port's pack writer. The reference and the
architecture modules import nothing of the program."""
from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import torch

import bench_tiny  # noqa: F401  (puts bench/ and src/ on the path)
from bench_tiny import tiny_config
from nlbench.spec import arch_module

OPT = arch_module("opt")


def test_reference_matches_the_port_forward():
    from repro_torch.configs import base
    from repro_torch.models.model import Model
    cfg = dict(tiny_config("opt-1.3b"), dtype="float32")
    w, _ = OPT.make_weights(cfg, 2**32 + 99, "cpu")
    model = Model(OPT.model_config(cfg, 64, base), device="cpu")
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg["vocab_size"], (3, 40), generator=gen)
    with torch.no_grad():
        got = model.forward(OPT.program_params(w), {"tokens": tokens})["logits"]
    for b in range(3):
        ref = OPT.forward_logits(w, cfg, tokens[b], range(40))
        torch.testing.assert_close(got[b], ref, rtol=1e-4, atol=1e-4)


def test_reference_int8_rows_are_the_pack_writers():
    from repro_torch.core.sparse_ffn import FFNWeights, make_bundles
    from repro_torch.store.format import dequantize_int8, quantize_int8
    cfg = tiny_config("opt-350m")
    w, _ = OPT.make_weights(cfg, 7, "cpu")
    lw = w["layers"][1]
    bundles = make_bundles(FFNWeights(w_up=lw["w_up"].T, w_down=lw["w_down"]))
    vals = torch.from_numpy(bundles.view(np.int16)).view(torch.bfloat16).float()
    deq = torch.from_numpy(dequantize_int8(*quantize_int8(vals.numpy())))
    up, down = OPT.pack_rows(w)[1]
    d = cfg["d_model"]
    torch.testing.assert_close(up, deq[:, :d].T, rtol=0, atol=0)
    torch.testing.assert_close(down, deq[:, d:], rtol=0, atol=0)


def imported_names(path: Path) -> set:
    """Top-level names of every module `path` imports, at any depth."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    return names


def imports_of_the_program(bench: Path) -> dict:
    """Per file under `bench/reference/` and `bench/arch/`, what it imports
    beyond what a plain reference may: torch alone under `reference/`; the
    benchmark's own weights and references besides under `arch/`."""
    plain = {"__future__", "typing", "torch"}
    allowed = {"reference": plain,
               "arch": plain | {"hashlib", "reference", "weights"}}
    out = {}
    for folder, ok in allowed.items():
        for path in sorted((bench / folder).glob("*.py")):
            extra = imported_names(path) - ok
            if extra:
                out[f"{folder}/{path.name}"] = extra
    return out


def test_reference_imports_nothing_of_the_program():
    files = sorted(bench_tiny.BENCH.glob("reference/*.py")) + \
        sorted(bench_tiny.BENCH.glob("arch/*.py"))
    assert any(p.name == "opt_reference.py" for p in files)
    assert any(p.name == "opt.py" for p in files)
    assert imports_of_the_program(bench_tiny.BENCH) == {}
