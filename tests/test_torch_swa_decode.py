"""The sliding-window decode kernel's plain version against the reference.

`swa_decode_attention_plain` (what the port's dispatcher runs on the CPU,
and what the Hopper kernel is held against on the card) against the JAX
package's Pallas kernel in interpret mode (`ops.swa_decode_attention`, run
as `tests/test_kernels.py` runs it) and its oracle `ref.swa_decode_ref`, on
the same numpy inputs: the shape sweep of the reference's kernel tests in
float32 and bfloat16 with their tolerances, an empty ring, and the port's
per-row `cur_pos` against one reference call per row. Also the Hopper
wrapper's launch `plan` (pure Python, no card): tile, split count and load
width for every geometry the kernel takes.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro_torch.kernels import ops
from repro_torch.kernels import swa_decode
from repro_torch.kernels.swa_decode import plan, swa_decode_attention_plain

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    # tests/test_kernels.py:10-11
    return (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
            else dict(rtol=2e-4, atol=2e-4))


def _ring(B, H, KV, hd, W, cur, seed):
    """q, ring K/V and positions holding the last W positions up to cur
    (the sweep of tests/test_kernels.py:92-99), as numpy float32."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, W, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, W, KV, hd)).astype(np.float32)
    pos = np.full((B, W), -1, np.int32)
    for p in range(max(0, cur - W + 1), cur + 1):
        pos[:, p % W] = p
    return q, k, v, pos


def _torch(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _jax_ref(q, k, v, pos, cur, window, jdt):
    B, H, hd = q.shape
    KV = k.shape[2]
    qj, kj, vj = (jnp.asarray(a, jdt) for a in (q, k, v))
    return jref.swa_decode_ref(qj.reshape(B, KV, H // KV, hd),
                               jnp.swapaxes(kj, 1, 2), jnp.swapaxes(vj, 1, 2),
                               jnp.asarray(pos), cur, window=window
                               ).reshape(B, H, hd)


@pytest.mark.parametrize("B,H,KV,hd,W", [(1, 4, 1, 64, 512), (2, 8, 2, 64, 1024),
                                         (3, 6, 6, 32, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_oracle(B, H, KV, hd, W, dtype):
    """The sweep of tests/test_kernels.py:88-90: the plain version against
    `ref.swa_decode_ref` in the working dtype (scalar cur, window W / 2 over
    a wrapped ring)."""
    jdt, tdt = DTYPES[dtype]
    cur, win = W + W // 3, W // 2
    q, k, v, pos = _ring(B, H, KV, hd, W, cur, seed=B * W)
    got = swa_decode_attention_plain(_torch(q, tdt), _torch(k, tdt),
                                     _torch(v, tdt), _torch(pos, torch.int32),
                                     cur, window=win)
    assert got.dtype == tdt and tuple(got.shape) == (B, H, hd)
    want = np.asarray(_jax_ref(q, k, v, pos, cur, win, jdt), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatcher_matches_pallas_kernel_interpreted(dtype):
    """`ops.swa_decode_attention` on CPU tensors (the plain version, counted
    as a plain call) against the reference's Pallas kernel run in interpret
    mode, small: one shape of the sweep, block_w 128."""
    jdt, tdt = DTYPES[dtype]
    B, H, KV, hd, W = 2, 8, 2, 64, 256
    cur, win = W + W // 3, W // 2
    q, k, v, pos = _ring(B, H, KV, hd, W, cur, seed=7)
    ops.reset_counts()
    got = ops.swa_decode_attention(_torch(q, tdt), _torch(k, tdt),
                                   _torch(v, tdt), _torch(pos, torch.int32),
                                   torch.tensor(cur, dtype=torch.int32),
                                   window=win)
    c = ops.counts["swa_decode"]
    assert (c.launches, c.plain_calls) == (0, 1)
    want = jops.swa_decode_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(pos), jnp.int32(cur), window=win, block_w=128)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dtype))


def test_empty_ring_returns_zeros():
    """tests/test_kernels.py:110-117: no valid slot gives 0, not the
    softmax's uniform average; also an empty row beside a live one."""
    B, H, KV, hd, W = 1, 2, 1, 32, 128
    q = torch.ones((B, H, hd))
    k = torch.ones((B, W, KV, hd))
    pos = torch.full((B, W), -1, dtype=torch.int32)
    out = swa_decode_attention_plain(q, k, k, pos, 0, window=64)
    np.testing.assert_allclose(out.numpy(), 0.0, atol=1e-6)
    want = jops.swa_decode_attention(jnp.ones((B, H, hd)),
                                     jnp.ones((B, W, KV, hd)),
                                     jnp.ones((B, W, KV, hd)),
                                     jnp.full((B, W), -1, jnp.int32),
                                     jnp.int32(0), window=64, block_w=64)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    q2, k2, v2, pos2 = _ring(2, 4, 2, 32, 64, 80, seed=3)
    pos2[1] = -1
    out2 = swa_decode_attention_plain(_torch(q2), _torch(k2), _torch(v2),
                                      _torch(pos2, torch.int32), 80, window=32)
    assert float(out2[1].abs().max()) == 0.0
    assert float(out2[0].abs().max()) > 0.0


@pytest.mark.parametrize("window", [5, 40, 4096])
def test_per_row_cur_matches_reference_per_row(window):
    """The port's [B] `cur_pos` (each row at its own position, rings filled
    to different depths, one wrapped) equals the reference oracle called
    once per row with that row's scalar cur."""
    B, H, KV, hd, W = 3, 4, 2, 32, 64
    rng = np.random.default_rng(window)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, W, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, W, KV, hd)).astype(np.float32)
    curs = [100, 9, 63]
    pos = np.full((B, W), -1, np.int32)
    for b, c in enumerate(curs):
        for p in range(max(0, c - W + 1), c + 1):
            pos[b, p % W] = p
    got = swa_decode_attention_plain(
        _torch(q), _torch(k), _torch(v), _torch(pos, torch.int32),
        torch.tensor(curs, dtype=torch.int32), window=window).numpy()
    for b, c in enumerate(curs):
        want = _jax_ref(q[b:b + 1], k[b:b + 1], v[b:b + 1], pos[b:b + 1], c,
                        window, jnp.float32)
        np.testing.assert_allclose(got[b:b + 1], np.asarray(want),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("B,H,KV,hd,W,window", [(2, 8, 2, 64, 256, 100),
                                                 (3, 16, 16, 64, 128, 128)])
def test_f32_query_over_bf16_rings_matches_gqa_attend(B, H, KV, hd, W,
                                                      window):
    """A bf16 model served offload attends with a float32 query (its
    residual stream is float32 after the first offloaded FFN) over its
    bf16 rings. The plain version takes them and gives float32; the
    reference's model (`attend_swa_cache` -> `gqa_attend`) promotes: float32
    scores from the unrounded query, probabilities rounded to bf16, a bf16
    product. Rows at their own positions, one wrapped; 2e-2, the bf16
    tolerance of tests/test_kernels.py:10 (the reference's two roundings)."""
    rng = np.random.default_rng(B * W)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = np.asarray(rng.standard_normal((B, W, KV, hd)), jnp.bfloat16)
    v = np.asarray(rng.standard_normal((B, W, KV, hd)), jnp.bfloat16)
    curs = [W + W // 3, 40, 2 * W - 1][:B]
    pos = np.full((B, W), -1, np.int32)
    for b, c in enumerate(curs):
        for p in range(max(0, c - W + 1), c + 1):
            pos[b, p % W] = p
    bf = lambda a: torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)  # noqa: E731
    got = swa_decode_attention_plain(
        _torch(q), bf(k), bf(v), _torch(pos, torch.int32),
        torch.tensor(curs, dtype=torch.int32), window=window)
    assert got.dtype == torch.float32
    want = jlayers.gqa_attend(jnp.asarray(q)[:, None], jnp.asarray(k),
                              jnp.asarray(v), jnp.asarray(curs)[:, None],
                              jnp.asarray(pos), k_valid=jnp.asarray(pos >= 0),
                              causal=True, window=window)
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.numpy().reshape(B, H * hd),
                               np.asarray(want, np.float32)[:, 0],
                               rtol=2e-2, atol=2e-2)


# every geometry the kernel takes: hd <= 256, and G <= 4, or G <= 8 with
# hd <= 128, in float32 and bfloat16
TAKEN = [(G, hd) for G in range(1, 9) for hd in (1, 8, 16, 36, 64, 96, 128,
                                                  200, 256)
         if G <= 4 or hd <= 128]


@pytest.mark.parametrize("elt", [4, 2], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned",
                                                        "misaligned"])
def test_plan_takes_every_geometry(elt, aligned):
    """The plan for every geometry the kernel takes, over batch sizes,
    KV heads, ring lengths and SM counts: a tile of whole passes, splits of
    whole tiles of at most MAX_CHUNK slots that cover the ring with no split
    left without slots, and the narrow path exactly where a row is not a
    multiple of 16 bytes or a base is misaligned."""
    for (G, hd), B, KV, W, sms in itertools.product(
            TAKEN, (1, 4, 32), (1, 8), (1, 31, 96, 1000, 8190, 8192, 131072),
            (1, 132)):
        p = plan(B, KV, G, hd, W, elt, sms, aligned=aligned)
        assert p.narrow == (not aligned or (hd * elt) % 16 != 0)
        assert p.tile in (32, 64, 128, 256)
        assert p.tile % (swa_decode.THREADS // 32) == 0
        assert p.chunk % p.tile == 0 and 0 < p.chunk <= swa_decode.MAX_CHUNK
        assert p.splits >= 1
        assert (p.splits - 1) * p.chunk < W <= p.splits * p.chunk, (p, W)


def test_plan_tiles_and_splits_at_the_serving_shapes():
    """The tiles the kernel's geometry gives (16 KB of K per tile on the
    16-byte path), and enough splits for four blocks an SM on 132 SMs."""
    # opt-350m heads f32 (256-byte rows), mistral-7b f32 and bf16, qwen2-7b
    assert plan(4, 16, 1, 64, 8192, 4, 132) == (False, 64, 960, 9)
    assert plan(4, 8, 4, 128, 8192, 4, 132) == (False, 32, 512, 16)
    assert plan(4, 8, 4, 128, 8192, 2, 132) == (False, 64, 512, 16)
    assert plan(4, 4, 7, 128, 8192, 2, 132) == (False, 64, 256, 32)
    # hd 36 in bf16 (72-byte rows): the narrow path, one element a lane
    assert plan(4, 8, 4, 36, 8192, 2, 132).narrow
    # a short ring is one split
    assert plan(1, 1, 4, 64, 96, 4, 132).splits == 1
