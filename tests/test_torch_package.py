"""Package rules of the PyTorch port (`repro_torch`).

Importing every module of the port leaves jax out of `sys.modules`; no
file of the port, and not `chip_smoke.py`, imports the reference package
`repro`; and an entry point asked for no device runs on CUDA or raises —
it never carries on quietly on the CPU.
"""
import ast
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    import repro_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_port_imports_without_jax():
    """A fresh interpreter imports every module of the port; jax (and the
    reference package) stay unimported."""
    mods = _port_modules()
    assert "repro_torch.kernels.ops" in mods and len(mods) > 20
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(k for k in sys.modules "
            "if k == 'jax' or k.startswith(('jax.', 'repro.')) or k == 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_reference_or_jax_imports(path):
    roots = set(_imported_roots(path))
    assert not roots & {"repro", "jax", "jaxlib", "flax"}, (path, roots)


@pytest.fixture
def no_cuda(monkeypatch):
    """Behave as on a machine without a card, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny_cfg():
    from repro_torch.configs import get_config
    return get_config("opt-350m", reduced=True, d_model=32, d_ff=128,
                      n_layers=1, vocab_size=64)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    from repro_torch.convert import params_from_numpy
    from repro_torch.models import build_model
    from repro_torch.serving.engine import build_offload_runtime
    from repro_torch.serving.server import InferenceServer
    cfg = _tiny_cfg()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    params = model.init_params()
    numpy_params = {"embed": {k: v.numpy() for k, v in params["embed"].items()},
                    "final_norm": {k: v.numpy()
                                   for k, v in params["final_norm"].items()},
                    "stack": {"sub_0": {
                        blk: {k: v.numpy()[None] for k, v in p.items()}
                        for blk, p in params["stack"][0]["sub_0"].items()}}}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy(numpy_params, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_offload_runtime(model, params, calib_batch=(1, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceServer(model, params)
    # asked for explicitly, the CPU works
    runtime = build_offload_runtime(model, params, calib_batch=(1, 4),
                                    device="cpu")
    InferenceServer(model, params, mode="offload", offload=runtime,
                    device="cpu")


def test_offline_entry_points_default_to_cuda_and_raise_without_it(
        no_cuda, tmp_path):
    """The offline stage and pack serving: stats, `build_pack`,
    `from_pack`, `InferenceServer(pack_path=)` and both command lines run
    on CUDA unless given the CPU, and raise without a card."""
    from repro_torch.core.coactivation import (CoActivationStats,
                                               stats_from_mask_shards)
    from repro_torch.launch import pack, serve
    from repro_torch.models import build_model
    from repro_torch.serving.engine import OffloadedFFNRuntime
    from repro_torch.serving.server import InferenceServer
    from repro_torch.store import build_pack
    cfg = _tiny_cfg()
    for make in (lambda: CoActivationStats(8),
                 lambda: stats_from_mask_shards([np.zeros((2, 8), bool)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    model = build_model(cfg, device="cpu")
    params = model.init_params()
    path = tmp_path / "t.npack"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_pack(model, params, path, calib_tokens=8, calib_batch=1,
                   calib_seqlen=8)
    build_pack(model, params, path, calib_tokens=8, calib_batch=1,
               calib_seqlen=8, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OffloadedFFNRuntime.from_pack(cfg, path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceServer(model, params, mode="offload", pack_path=str(path))
    InferenceServer(model, params, mode="offload", pack_path=str(path),
                    device="cpu").close()
    geom = ["--arch", "qwen2-7b", "--n-layers", "1", "--d-model", "32",
            "--d-ff", "128"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pack.main(geom + ["--out", str(tmp_path / "q.npack")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(geom + ["--requests", "1"])


def test_training_entry_points_default_to_cuda_and_raise_without_it(
        no_cuda, tmp_path):
    """The encoder-decoder and VLM models, the data iterator and
    `launch.train` run on CUDA unless given the CPU, and raise without a
    card."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_data_iter
    from repro_torch.launch import train
    from repro_torch.models import build_model
    for arch in ("seamless-m4t-medium", "internvl2-26b"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(get_config(arch, reduced=True))
    data = DataConfig(vocab_size=16, seq_len=4, batch_size=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_data_iter(data)
    assert next(make_data_iter(data, device="cpu"))["tokens"].device.type \
        == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "granite-3-2b", "--steps", "1"])
    ck = str(tmp_path / "ck.npz")
    hist = train.main(["--arch", "granite-3-2b", "--steps", "1", "--batch",
                       "1", "--seq", "8", "--device", "cpu",
                       "--checkpoint", ck])
    assert len(hist) == 1


def test_kernel_wrapper_never_falls_back():
    """The dispatcher routes only CPU tensors to the plain version; the CUDA
    wrapper rejects a CPU tensor instead of computing it."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_decode import paged_decode_attention_cuda
    from repro_torch.kernels.sparse_ffn import sparse_ffn_segments_fused_cuda
    x = torch.zeros((2, 8))
    w = torch.zeros((128, 8))
    ids = torch.zeros((1,), dtype=torch.int32)
    tiles = torch.zeros((1, 128))
    with pytest.raises(ValueError, match="CUDA device"):
        sparse_ffn_segments_fused_cuda(x, w, w, ids, tiles)
    ops.reset_counts()
    ops.sparse_ffn_segments_fused(x, w, w, ids, tiles)
    ffn = ops.counts["sparse_ffn_segments_fused"]
    assert (ffn.launches, ffn.plain_calls) == (0, 1)
    q = torch.zeros((1, 2, 8))
    arena = torch.zeros((3, 4, 2, 8))
    table = torch.zeros((1, 2), dtype=torch.int32)
    cur = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        paged_decode_attention_cuda(q, arena, arena, table, cur)
    ops.paged_decode_attention(q, arena, arena, table, cur)
    paged = ops.counts["paged_decode"]
    assert (paged.launches, paged.plain_calls) == (0, 1)
    from repro_torch.kernels.coact import coact_accumulate_cuda
    masks = torch.ones((3, 5), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA device"):
        coact_accumulate_cuda(masks)
    ops.coact_accumulate(masks)
    coact = ops.counts["coact_accumulate"]
    assert (coact.launches, coact.plain_calls) == (0, 1)


def test_unported_options_raise():
    """Options of ported slices construct and run (prefetch, trained
    predictors with oracle=False, lookahead training); pack_path keeps its
    rules; what is still refused raises: serving an encoder-decoder or a
    VLM, offload serving of either, and a one-rank `launch.train
    --model-axis 2` (2 does not divide a world of 1)."""
    import dataclasses
    import threading
    from repro_torch.core.predictor import PredictorParams
    from repro_torch.models import build_model
    from repro_torch.serving.engine import Request, build_offload_runtime
    from repro_torch.serving.server import InferenceServer
    cfg = dataclasses.replace(_tiny_cfg(), n_layers=2)
    model = build_model(cfg, device="cpu")
    params = model.init_params()
    runtime = build_offload_runtime(model, params, train_lookahead=True,
                                    calib_batch=(2, 16), device="cpu")
    assert runtime.lookahead is not None and len(runtime.lookahead) == 1
    # a predictor that fires on every neuron: oracle=False serves the dense
    # FFN's support
    runtime.predictors = [PredictorParams(
        torch.zeros((32, 4)), torch.zeros(4), torch.zeros((4, 128)),
        torch.full((128,), 10.0))] * 2
    prompt = np.arange(5, dtype=np.int32)
    for kw in (dict(prefetch=True), dict(oracle=False),
               dict(prefetch=True, oracle=False, lookahead="oracle")):
        server = InferenceServer(model, params, device="cpu", max_len=16,
                                 mode="offload", offload=runtime, **kw)
        h = server.submit(Request(uid=0, prompt=prompt, max_new_tokens=3))
        server.drain()
        server.close()
        assert h.result.finish_reason == "length"
        assert len(h.result.tokens) == 3
    assert not any(t.name == "ripple-prefetch" for t in threading.enumerate())
    # pack_path is ported: it needs offload mode (and no offload= runtime)
    with pytest.raises(ValueError, match="requires mode='offload'"):
        InferenceServer(model, params, device="cpu", pack_path="x.pack")
    # encoder-decoder and VLM models build and load, but the server refuses
    # them (the enc-dec with the reference's message, the VLM when built,
    # where the reference fails at its first prefill), offload serving
    # refuses both, and a model axis must divide the world
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, train
    for arch in ("seamless-m4t-medium", "internvl2-26b"):
        cfg = get_config(arch, reduced=True)
        fam = build_model(cfg, device="cpu")
        fam_params = fam.init_params()
        match = ("InferenceServer covers decoder-only stacks"
                 if cfg.is_encdec else "VLM's prefill needs patch_feats")
        with pytest.raises(ValueError, match=match):
            InferenceServer(fam, fam_params, device="cpu")
        with pytest.raises(SystemExit, match="dense decoder-only archs"):
            serve.main(["--arch", arch, "--mode", "offload", "--requests",
                        "1", "--device", "cpu"])
    with pytest.raises(ValueError, match="does not divide the world of 1"):
        train.main(["--arch", "granite-3-2b", "--model-axis", "2",
                    "--device", "cpu"])


def test_generator_init_is_seeded():
    from repro_torch.models import build_model
    model = build_model(_tiny_cfg(), device="cpu")
    a = model.init_params(torch.Generator().manual_seed(3))
    b = model.init_params(torch.Generator().manual_seed(3))
    wa = a["stack"][0]["sub_0"]["ffn"]["w_up"]
    assert torch.equal(wa, b["stack"][0]["sub_0"]["ffn"]["w_up"])
    assert tuple(wa.shape) == (32, 128)
    np.testing.assert_allclose(float(wa.std()), 32 ** -0.5, rtol=0.2)
