"""The port's NeuronPack store against the reference's: byte-identical
writes, each package reading the other's packs, the same format errors,
the same file-store payloads and I/O statistics over the same reads, the
same fault-plan counters, and `build_pack` from the same weights giving the
reference's pack region for region.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.placement import PlacementResult as JPlacementResult
from repro.models import build_model as jbuild_model
from repro.store import FaultPlan as JFaultPlan
from repro.store import FileNeuronStore as JFileNeuronStore
from repro.store import NeuronPack as JNeuronPack
from repro.store import RetryPolicy as JRetryPolicy
from repro.store import build_pack as jbuild_pack
from repro.store import write_pack as jwrite_pack
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.placement import PlacementResult
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.store import (FaultPlan, FileNeuronStore, NeuronPack,
                               PackFormatError, RetryPolicy, build_pack,
                               seeded_layer_plans, write_pack)
from repro_torch.store.format import dequantize_int8, quantize_int8

torch.set_num_threads(1)

N, W, L = 96, 24, 2


def _inputs(seed=0):
    """Bundles in logical order and permutation placements, both packages'
    PlacementResult with identical fields (search_seconds included)."""
    rng = np.random.default_rng(seed)
    bundles = [rng.standard_normal((N, W)).astype(np.float32) for _ in range(L)]
    bundles[1][5] = 0.0                     # an all-zero row: scale 1.0
    jpl, tpl = [], []
    for l in range(L):
        perm = rng.permutation(N)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(N)
        fields = dict(placement=perm, inverse=inv, edges_used=N - 1 - l,
                      search_seconds=0.125 * (l + 1), mode="exact")
        jpl.append(JPlacementResult(**fields))
        tpl.append(PlacementResult(**fields))
    return bundles, jpl, tpl


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_write_pack_byte_identical(tmp_path, version, quantize):
    bundles, jpl, tpl = _inputs()
    meta = dict(d_model=12, n_mats=2, activation="relu", arch="x")
    mj = jwrite_pack(tmp_path / "j.npack", bundles, jpl, quantize=quantize,
                     meta=meta, version=version)
    mt = write_pack(tmp_path / "t.npack", bundles, tpl, quantize=quantize,
                    meta=meta, version=version)
    assert ((tmp_path / "j.npack").read_bytes()
            == (tmp_path / "t.npack").read_bytes())
    mj.pop("path"), mt.pop("path")
    assert mj == mt


def test_quantize_int8_identical():
    from repro.store.format import dequantize_int8 as jdeq
    from repro.store.format import quantize_int8 as jquant
    rows = np.random.default_rng(3).standard_normal((40, 16)).astype(np.float32)
    rows[7] = 0.0
    (qj, sj), (qt, st) = jquant(rows), quantize_int8(rows)
    np.testing.assert_array_equal(qt, qj)
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(dequantize_int8(qt, st), jdeq(qj, sj))


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_each_package_reads_the_others_pack(tmp_path, version, quantize):
    bundles, jpl, tpl = _inputs(1)
    jwrite_pack(tmp_path / "j.npack", bundles, jpl, quantize=quantize,
                version=version)
    write_pack(tmp_path / "t.npack", bundles, tpl, quantize=quantize,
               version=version)
    for path in ("j.npack", "t.npack"):
        pj, pt = JNeuronPack(tmp_path / path), NeuronPack(tmp_path / path)
        assert (pt.version, pt.n_layers, pt.n_neurons, pt.bundle_width,
                pt.quantized, pt.data_start, pt.meta) == (
            pj.version, pj.n_layers, pj.n_neurons, pj.bundle_width,
            pj.quantized, pj.data_start, pj.meta)
        for l in range(L):
            a, b = pt.placement(l), pj.placement(l)
            np.testing.assert_array_equal(a.placement, b.placement)
            np.testing.assert_array_equal(a.inverse, b.inverse)
            assert (a.mode, a.edges_used, a.search_seconds) == (
                b.mode, b.edges_used, b.search_seconds)
            for fn in ("scales", "row_crcs"):
                x, y = getattr(pt, fn)(l), getattr(pj, fn)(l)
                assert (x is None) == (y is None), fn
                if x is not None:
                    np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(pt.logical_bundles(l),
                                          pj.logical_bundles(l))
            np.testing.assert_array_equal(
                pt.logical_bundles(l, dequantize=False),
                pj.logical_bundles(l, dequantize=False))
            assert pt.verify_bundles(l) and pj.verify_bundles(l)


def _damaged(tmp_path, how):
    bundles, _, tpl = _inputs(2)
    path = tmp_path / f"{how}.npack"
    write_pack(path, bundles, tpl)
    raw = bytearray(path.read_bytes())
    if how == "magic":
        raw[:8] = b"NOTAPACK"
    elif how == "short":
        raw = raw[:10]
    elif how == "truncated_header":
        raw = raw[:40]
    elif how == "truncated_data":
        raw = raw[:len(raw) // 2]
    elif how == "header_crc":
        raw[20] ^= 0x01
    elif how == "version":
        hlen = int(np.frombuffer(bytes(raw[8:16]), "<u8")[0])
        header = json.loads(bytes(raw[16:16 + hlen]))
        header["version"] = 9
        blob = json.dumps(header).encode()
        raw = raw[:8] + np.array(len(blob), "<u8").tobytes() + blob
    path.write_bytes(bytes(raw))
    return path


@pytest.mark.parametrize("how", ["magic", "short", "truncated_header",
                                 "truncated_data", "header_crc", "version"])
def test_format_errors_match_reference(tmp_path, how):
    """The same damaged file fails to open in both packages, and the port's
    message names the path."""
    path = _damaged(tmp_path, how)
    with pytest.raises(PackFormatError, match=str(path.name)):
        NeuronPack(path)
    from repro.store import PackFormatError as JPackFormatError
    with pytest.raises(JPackFormatError):
        JNeuronPack(path)


def test_write_pack_rejects_what_the_reference_rejects(tmp_path):
    bundles, _, tpl = _inputs()
    with pytest.raises(ValueError, match="quantize"):
        write_pack(tmp_path / "x", bundles, tpl, quantize="int4")
    with pytest.raises(ValueError, match="version"):
        write_pack(tmp_path / "x", bundles, tpl, version=3)
    with pytest.raises(ValueError, match="placements"):
        write_pack(tmp_path / "x", bundles, tpl[:1])
    with pytest.raises(ValueError, match="empty"):
        write_pack(tmp_path / "x", [], [])


def _io(stats):
    d = dataclasses.asdict(stats)
    d.pop("measured_seconds")          # wall clock: differs by nature
    d["run_lengths"] = list(np.asarray(d["run_lengths"]).tolist())
    return d


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_file_store_reads_identical_to_reference(tmp_path, quantize):
    """The same extent sequence through both stores: identical payloads,
    modelled I/O statistics and measured ops / bytes."""
    bundles, jpl, tpl = _inputs(4)
    write_pack(tmp_path / "p.npack", bundles, tpl, quantize=quantize)
    rng = np.random.default_rng(6)
    reads = [rng.choice(N, size=int(rng.integers(1, 40)), replace=False)
             for _ in range(12)]
    with FileNeuronStore(tmp_path / "p.npack", 1) as ts, \
            JFileNeuronStore(tmp_path / "p.npack", 1) as js:
        for ids in reads:
            for thr in (0, 3):
                dt, st = ts.read(ids, collapse_threshold=thr)
                dj, sj = js.read(ids, collapse_threshold=thr)
                np.testing.assert_array_equal(dt, dj)
                assert _io(st) == _io(sj)
            assert ts.plan_extents(ids, 2) == js.plan_extents(ids, 2)
            np.testing.assert_array_equal(ts.fetch(ids), js.fetch(ids))
        np.testing.assert_array_equal(ts.physical_payload(False),
                                      js.physical_payload(False))
    assert ts.closed


def test_seeded_fault_plans_replay_with_reference_counters(tmp_path):
    """Seeded recoverable schedules (transient, latency, short read,
    corrupt) under CRC verification: both stores serve clean payloads and
    count the same retries, corrupt extents and injected events."""
    bundles, _, tpl = _inputs(5)
    write_pack(tmp_path / "p.npack", bundles, tpl)
    rates = dict(transient_rate=0.2, latency_rate=0.1, delay_s=1e-4,
                 short_read_rate=0.1, corrupt_rate=0.2)
    plans = seeded_layer_plans(3, L, 60, **rates)
    jplans = [JFaultPlan.seeded(3 + l, 60, **rates) for l in range(L)]
    rng = np.random.default_rng(7)
    reads = [rng.choice(N, size=int(rng.integers(1, 30)), replace=False)
             for _ in range(20)]
    clean = NeuronPack(tmp_path / "p.npack")
    for l in range(L):
        with FileNeuronStore(tmp_path / "p.npack", l, verify_checksums=True,
                             fault_plan=plans[l],
                             retry=RetryPolicy(backoff_s=0)) as ts, \
                JFileNeuronStore(tmp_path / "p.npack", l,
                                 verify_checksums=True, fault_plan=jplans[l],
                                 retry=JRetryPolicy(backoff_s=0)) as js:
            for ids in reads:
                dt, st = ts.read(ids, collapse_threshold=2)
                dj, sj = js.read(ids, collapse_threshold=2)
                np.testing.assert_array_equal(dt, dj)
                np.testing.assert_array_equal(
                    dt, clean.logical_bundles(l)[ids])
                assert _io(st) == _io(sj)
        assert plans[l].injected == jplans[l].injected
    assert sum(p.injected["transient"] + p.injected["corrupt"]
               for p in plans) > 0


SMALL = dict(d_model=64, d_ff=256, n_layers=2, vocab_size=128)


@pytest.fixture(scope="module")
def both_models():
    jcfg = jget_config("opt-350m", reduced=True, **SMALL)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = get_config("opt-350m", reduced=True, **SMALL)
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               cfg, device="cpu")
    return jmodel, jparams, model, params


@pytest.mark.parametrize("quantize,version", [("none", 2), ("int8", 2),
                                              ("none", 1)])
def test_build_pack_matches_reference(tmp_path, both_models, quantize,
                                      version):
    """From the same weights and calibration seed: the reference's
    placements, bundles, scales and CRCs, layer for layer. Header fields
    that time the build (`search_seconds`) differ by nature and are
    excluded by name. Every layer's counts went through the dispatcher
    (the plain version on the CPU)."""
    jmodel, jparams, model, params = both_models
    kw = dict(calib_tokens=128, calib_batch=4, calib_seqlen=32,
              quantize=quantize, pack_version=version, meta=dict(arch="t"))
    jrep = jbuild_pack(jmodel, jparams, tmp_path / "j.npack", **kw)
    ops.reset_counts()
    rep = build_pack(model, params, tmp_path / "t.npack", device="cpu",
                     shard_dir=tmp_path / "shards", **kw)
    coact = ops.counts["coact_accumulate"]
    assert (coact.launches, coact.plain_calls) == (0, SMALL["n_layers"])
    for f in ("n_layers", "n_neurons", "bundle_width", "quantized",
              "file_bytes", "tokens_traced", "placement_mode"):
        assert getattr(rep, f) == getattr(jrep, f), f
    assert rep.build_seconds >= rep.trace_seconds + rep.counts_seconds
    pj, pt = JNeuronPack(tmp_path / "j.npack"), NeuronPack(tmp_path / "t.npack")
    assert pt.meta == pj.meta and pt.version == pj.version == version
    for l in range(SMALL["n_layers"]):
        a, b = pt.placement(l), pj.placement(l)
        np.testing.assert_array_equal(a.placement, b.placement)
        assert (a.mode, a.edges_used) == (b.mode, b.edges_used)
        np.testing.assert_array_equal(np.asarray(pt.bundles_memmap(l)),
                                      np.asarray(pj.bundles_memmap(l)))
        for fn in ("scales", "row_crcs"):
            x, y = getattr(pt, fn)(l), getattr(pj, fn)(l)
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, y)
        lt, lj = dict(pt.header["layers"][l]), dict(pj.header["layers"][l])
        lt.pop("search_seconds"), lj.pop("search_seconds")
        # offsets are relative to data_start: equal whatever the header length
        assert lt == lj
    # the shards stay where asked, in the reference's names
    assert (tmp_path / "shards" / "manifest.json").exists()
    assert sorted(os.listdir(tmp_path / "shards"))[0] == "layer000_shard00000.npy"
