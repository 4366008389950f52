"""bf16 offload serving in the port against the reference.

Reduced opt-350m (relu, 2-matrix bundles) and qwen2-7b (gated silu,
3-matrix bundles) with bf16 params and compute, the reference's weights
converted into the port, both runtimes calibrated on the same random-token
trace. The port's flash bundles hold the reference's bf16 bits (as uint16:
numpy has no bf16), so bytes per neuron, placements and every modeled read
are the reference's. Served offload with three requests on two slots, the
port must give the reference's finish reasons and per-uid flash I/O
seconds, decode logits within 2e-2 of their scale (the bf16 tolerance of
tests/test_kernels.py:10), and its greedy tokens, except where the
reference's top-2 margin at the first difference is below that tolerance.

The fused op returns float32, so from the first offloaded FFN on the
residual stream is float32 and meets bf16 weights (ROADMAP §3): the port
computes those products in the promoted dtype, as `jnp.matmul` does. The
reference runs op by op (`jax.disable_jit()`), as the other bf16 parity
tests do: compiled, XLA skips some of the bf16 roundings its code writes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.serving.engine import Request as JRequest
from repro.serving.engine import build_offload_runtime as jbuild_runtime
from repro.serving.server import InferenceServer as JInferenceServer
from repro.store.packer import \
    extract_dense_ffn_bundles as jextract_dense_ffn_bundles
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models.layers import promoted_matmul
from repro_torch.serving.engine import Request, build_offload_runtime
from repro_torch.serving.server import InferenceServer
from repro_torch.store.packer import extract_dense_ffn_bundles

torch.set_num_threads(1)

SMALL = dict(d_model=64, d_ff=256, n_layers=2, vocab_size=128,
             param_dtype="bfloat16", compute_dtype="bfloat16")
LENS, NEW = (6, 9, 12), (5, 7, 4)
TOL = 2e-2


def _build(arch, seed, use_placement, **extra):
    jcfg = jget_config(arch, reduced=True, **SMALL, **extra)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(seed))
    with jax.disable_jit():
        jruntime = jbuild_runtime(jmodel, jparams,
                                  rng=np.random.default_rng(0),
                                  calib_batch=(4, 32),
                                  use_placement=use_placement)
    cfg = get_config(arch, reduced=True, **SMALL, **extra)
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               cfg, device="cpu")
    runtime = build_offload_runtime(model, params,
                                    rng=np.random.default_rng(0),
                                    calib_batch=(4, 32), device="cpu",
                                    use_placement=use_placement)
    return jmodel, jparams, jruntime, model, params, runtime


@pytest.fixture(scope="module")
def opt_bf16():
    return _build("opt-350m", 0, True)


@pytest.fixture(scope="module")
def qwen_bf16():
    return _build("qwen2-7b", 0, True)


PAIRS = [pytest.param("opt_bf16", id="opt-350m-bf16"),
         pytest.param("qwen_bf16", id="qwen2-7b-bf16")]


@pytest.mark.parametrize("pair", PAIRS)
def test_bundles_bytes_and_placements_match_reference(pair, request):
    """Bundles bit for bit, 2 bytes an element, and the placements. The
    placements come from the calibration masks (pre-activation > 0), which
    in bf16 agree bit for bit except where summation order moves a
    pre-activation within bf16 rounding of 0 (checked here, with the
    calibration's own tokens): such a flip changes the search's input, so
    the placements of a bf16 model are the reference's only where the
    masks are."""
    jmodel, jparams, jruntime, model, params, runtime = \
        request.getfixturevalue(pair)
    tokens = np.random.default_rng(0).integers(0, SMALL["vocab_size"],
                                               (4, 32))
    with jax.disable_jit():
        jpre = np.asarray(jmodel.forward(
            jparams, {"tokens": jnp.asarray(tokens)},
            capture_activations=True)["ffn_pre_act"], np.float32)
    with torch.inference_mode():
        tpre = model.forward(params, {"tokens": torch.as_tensor(tokens)},
                             capture_activations=True)["ffn_pre_act"]
    tpre = tpre.float().numpy()
    scale = float(np.abs(jpre).max())
    np.testing.assert_allclose(tpre, jpre, rtol=TOL, atol=TOL * scale)
    flips = (tpre > 0) != (jpre > 0)
    assert np.all(np.abs(jpre[flips]) <= TOL * scale)
    jb = jextract_dense_ffn_bundles(jmodel.cfg, jparams)
    tb = extract_dense_ffn_bundles(model.cfg, params)
    for a, b in zip(jb, tb):
        assert str(a.dtype) == "bfloat16" and b.dtype == np.uint16
        np.testing.assert_array_equal(b, np.asarray(a).view(np.uint16))
    for je, te in zip(jruntime.engines, runtime.engines):
        assert te.store.bundle_bytes == je.store.bundle_bytes == (
            2 * te.store.bundle_width)
        np.testing.assert_array_equal(te.placement.placement,
                                      je.placement.placement)
    assert runtime.io_summary()["ffn_kernel"] == "segments"
    assert jruntime.io_summary()["ffn_kernel"] == "segments"
    # the segment path's device weights are the bundles' bf16 values
    w_up = runtime._segment_weights[0][0]
    assert w_up.dtype == torch.bfloat16


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, SMALL["vocab_size"], T).astype(np.int32)
            for T in LENS]


def _serve(server_cls, request_cls, model, params, masks=None, **kw):
    """Serve the three requests on two slots; also record every decode
    step's logit rows and active slots, and into `masks` (a list) each
    layer's oracle masks with the pre-activations they come from."""
    server = server_cls(model, params, max_slots=2, max_len=32, **kw)
    steps = []
    decode = server._decode_offload
    if masks is not None:
        true_masks = server._true_masks

        def recorded_masks(dense_idx, h2, active):
            out = true_masks(dense_idx, h2, active)
            w = server._w_ups[dense_idx]
            pre = (promoted_matmul(h2, w).float().numpy()
                   if isinstance(h2, torch.Tensor)
                   else np.asarray(h2 @ w, np.float32))
            masks.append((np.array(out), pre))
            return out

        server._true_masks = recorded_masks

    def recorded(active):
        out = decode(active)
        steps.append((np.array(active, copy=True),
                      np.asarray(out[0], np.float32)))
        return out

    server._decode_offload = recorded
    handles = [server.submit(request_cls(uid=i, prompt=p, max_new_tokens=n))
               for i, (p, n) in enumerate(zip(_prompts(), NEW))]
    server.drain()
    server.close()
    return handles, steps, server.stats


def _assert_logits_then_tokens(steps, jsteps, handles, jhandles):
    """Logits of the active rows within TOL of their scale at every step up
    to the first step whose greedy tokens differ; there the reference's
    top-2 margin must be below TOL (a near tie bf16 may flip). Without such
    a step, the tokens are identical."""
    assert len(steps) == len(jsteps)
    for (active, rows), (jactive, jrows) in zip(steps, jsteps):
        np.testing.assert_array_equal(active, jactive)
        got, want = rows[active], jrows[jactive]
        differ = got.argmax(-1) != want.argmax(-1)
        if differ.any():
            top2 = np.sort(want[differ], axis=-1)[:, -2:]
            assert np.all(top2[:, 1] - top2[:, 0] < TOL)
            return
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)
    for h, jh in zip(handles, jhandles):
        assert h.result.tokens == jh.result.tokens


@pytest.mark.parametrize("pair", PAIRS)
def test_bf16_offload_server_matches_reference(pair, request):
    jmodel, jparams, jruntime, model, params, runtime = \
        request.getfixturevalue(pair)
    jruntime.reset_stats()
    runtime.reset_stats()
    with jax.disable_jit():
        jhandles, jsteps, _ = _serve(JInferenceServer, JRequest, jmodel,
                                     jparams, mode="offload",
                                     offload=jruntime)
    ops.reset_counts()
    handles, steps, stats = _serve(InferenceServer, Request, model, params,
                                   mode="offload", offload=runtime,
                                   device="cpu")
    ffn = ops.counts["sparse_ffn_segments_fused"]
    assert (ffn.launches, ffn.plain_calls) == (
        0, stats.decode_steps * runtime.n_layers)
    for h, jh, n in zip(handles, jhandles, NEW):
        assert h.result.finish_reason == jh.result.finish_reason == "length"
        assert len(h.result.tokens) == n
        assert h.result.io_seconds == jh.result.io_seconds > 0
    _assert_logits_then_tokens(steps, jsteps, handles, jhandles)
    js, ts = jruntime.io_summary(), runtime.io_summary()
    for key in ("io_seconds_per_token", "cache_hit_rate", "mean_run_length",
                "effective_bandwidth", "ops_per_token"):
        assert ts[key] == js[key], key


def test_bf16_offload_swa_server_matches_reference():
    """swa=True (rings of 8 slots, shorter than the 9- and 12-token prompts,
    so rings wrap in prefill and in decode): from layer 1 on the query is
    float32 over the bf16 rings, which the swa op takes (the reference's
    `gqa_attend` promotes). Finish reasons, logits and tokens as in the
    contiguous-cache test; the swa op's plain version ran on every decode
    attention. The swa op computes the TPU kernel's attention, not
    `gqa_attend`'s bf16 roundings (ROADMAP §3), so FFN inputs move
    by bf16 roundings and an oracle mask bit whose pre-activation is that
    close to 0 may flip: every differing bit must be such a near tie (as
    for the calibration masks above), and per-uid I/O seconds are the
    reference's exactly where no bit differs, else within 1%."""
    jmodel, jparams, jruntime, model, params, runtime = _build(
        "opt-350m", 0, True, sliding_window=8)
    jmasks, masks = [], []
    with jax.disable_jit():
        jhandles, jsteps, _ = _serve(JInferenceServer, JRequest, jmodel,
                                     jparams, masks=jmasks, mode="offload",
                                     offload=jruntime, swa=True)
    ops.reset_counts()
    handles, steps, stats = _serve(InferenceServer, Request, model, params,
                                   masks=masks, mode="offload",
                                   offload=runtime, device="cpu", swa=True)
    swa = ops.counts["swa_decode"]
    assert (swa.launches, swa.plain_calls) == (
        0, stats.decode_steps * model.cfg.n_layers)
    assert max(LENS) > model.cfg.sliding_window
    assert len(masks) == len(jmasks) > 0
    flips = 0
    for (m, _), (jm, jpre) in zip(masks, jmasks):
        differ = m != jm
        scale = float(np.abs(jpre).max())
        assert np.all(np.abs(jpre[differ]) <= TOL * scale)
        flips += int(differ.sum())
    for h, jh, n in zip(handles, jhandles, NEW):
        assert h.result.finish_reason == jh.result.finish_reason == "length"
        assert len(h.result.tokens) == n
        assert jh.result.io_seconds > 0
        if flips == 0:
            assert h.result.io_seconds == jh.result.io_seconds
        else:
            np.testing.assert_allclose(h.result.io_seconds,
                                       jh.result.io_seconds, rtol=1e-2)
    _assert_logits_then_tokens(steps, jsteps, handles, jhandles)


def test_bf16_identity_layout_serves_bundles_like_reference():
    """use_placement=False: the bundles path stages the bf16 bits read from
    the store (no promotion there: its FFN stays in bf16, as the
    reference's); the same tokens and per-uid I/O."""
    jmodel, jparams, jruntime, model, params, runtime = _build(
        "qwen2-7b", 0, False)
    assert runtime.io_summary()["ffn_kernel"] == "bundles"
    with jax.disable_jit():
        jhandles, jsteps, _ = _serve(JInferenceServer, JRequest, jmodel,
                                     jparams, mode="offload",
                                     offload=jruntime)
    handles, steps, _ = _serve(InferenceServer, Request, model, params,
                               mode="offload", offload=runtime, device="cpu")
    for h, jh in zip(handles, jhandles):
        assert h.result.finish_reason == jh.result.finish_reason == "length"
        assert h.result.io_seconds == jh.result.io_seconds > 0
    _assert_logits_then_tokens(steps, jsteps, handles, jhandles)


@pytest.mark.parametrize("shape", [(3, 8), (2, 1, 8)])
def test_promoted_matmul_is_jnp_matmul(shape):
    """float32 @ bf16 as jnp.matmul: the bf16 operand upcast exactly, the
    product in float32; equal dtypes are left as they are."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal(shape).astype(np.float32)
    b = np.asarray(rng.standard_normal((8, 5)), dtype=jnp.bfloat16)
    want = np.asarray(jnp.asarray(a) @ jnp.asarray(b))
    tb = torch.from_numpy(b.view(np.int16)).view(torch.bfloat16)
    got = promoted_matmul(torch.from_numpy(a), tb)
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    same = promoted_matmul(tb[:, :3].T.contiguous(), tb)
    assert same.dtype == torch.bfloat16
