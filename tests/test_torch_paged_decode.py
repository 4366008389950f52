"""Paged decode attention and the int8 KV cache in the port against the
reference.

The same numpy arenas go through the reference's `paged_decode_attention`
(its Pallas body in interpret mode, and its CPU route, the XLA gather twin)
and the port's dispatcher, whose CPU route is the kernel's plain version.
Tolerances: the plain version against the Pallas body at atol = rtol =
2e-6, the reference's own bound for that pair (online softmax against one
softmax); against the XLA twin and against the port's own contiguous cache
at 1e-6 and bitwise respectively — the same einsum math in the same order.
int8 quantisation matches the reference bit for bit. On bf16 arenas the
plain version equals the XLA twin bit for bit and the Pallas body within
2e-2 (the body keeps its scores and P in float32, the twin rounds them to
bf16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import paged_decode_attention as jpaged
from repro.models.kvcache import _quantize as j_quantize
from repro_torch.kernels import ops
from repro_torch.models import kvcache
from repro_torch.models.kvcache import (KVCache, PagedKVCache,
                                        PagedQuantKVCache, QuantKVCache,
                                        attend_full_cache, attend_paged_cache)

torch.set_num_threads(1)


def _arena(rng, B, S, KV, hd, P, quant, null_rows=()):
    """A contiguous [B, S, KV, hd] cache and its page-arena twin: row b maps
    its logical pages to a shuffled set of physical pages; rows in
    `null_rows` map every page to the null page (an inactive slot)."""
    MP = S // P
    NP = B * MP
    k_all = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v_all = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    perm = rng.permutation(NP).astype(np.int32)
    pt = perm.reshape(B, MP)

    def to_arena(a):
        arena = np.zeros((NP + 1, P) + a.shape[2:], a.dtype)
        arena[pt.reshape(-1)] = a.reshape((NP, P) + a.shape[2:])
        return arena

    if quant:
        sk = np.maximum(np.abs(k_all).max(-1), 1e-6) / 127.0
        sv = np.maximum(np.abs(v_all).max(-1), 1e-6) / 127.0
        ki = np.clip(np.round(k_all / sk[..., None]), -127, 127).astype(np.int8)
        vi = np.clip(np.round(v_all / sv[..., None]), -127, 127).astype(np.int8)
        # scales are stored in bf16: round them once, in both packages
        sk = np.array(jnp.asarray(sk, jnp.bfloat16).astype(jnp.float32))
        sv = np.array(jnp.asarray(sv, jnp.bfloat16).astype(jnp.float32))
        cont, arena = (ki, vi, sk, sv), tuple(map(to_arena, (ki, vi, sk, sv)))
    else:
        cont, arena = (k_all, v_all), tuple(map(to_arena, (k_all, v_all)))
    pt = pt.copy()
    for b in null_rows:
        pt[b] = NP
    return cont, arena, pt


def _torch_arena(arena, quant):
    t = [torch.from_numpy(a) for a in arena]
    if quant:
        t[2], t[3] = t[2].to(torch.bfloat16), t[3].to(torch.bfloat16)
        return PagedQuantKVCache(*t)
    return PagedKVCache(*t)


def _jax_arena(arena, quant):
    a = [jnp.asarray(x) for x in arena]
    if quant:
        a[2], a[3] = a[2].astype(jnp.bfloat16), a[3].astype(jnp.bfloat16)
        return a
    return a + [None, None]


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("null_rows", [(), (1,)], ids=["live", "null_row"])
def test_plain_matches_reference_kernel_and_twin(quant, G, null_rows):
    rng = np.random.default_rng(3 + G)
    B, KV, hd, P, S = 3, 2, 16, 8, 32
    H = KV * G
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    cur = np.asarray([5, 17, 31], np.int32)
    _, arena, pt = _arena(rng, B, S, KV, hd, P, quant, null_rows)
    ka, va, ksa, vsa = _jax_arena(arena, quant)
    args = (jnp.asarray(q), ka, va, jnp.asarray(pt), jnp.asarray(cur))
    ref_pallas = np.asarray(jpaged(*args, k_scale=ksa, v_scale=vsa,
                                   interpret=True))
    ref_xla = np.asarray(jpaged(*args, k_scale=ksa, v_scale=vsa))
    cache = _torch_arena(arena, quant)
    scales = (dict(k_scale=cache.k_scale, v_scale=cache.v_scale) if quant
              else {})
    ops.reset_counts()
    out = ops.paged_decode_attention(
        torch.from_numpy(q), cache.k, cache.v, torch.from_numpy(pt),
        torch.from_numpy(cur), **scales)
    assert (ops.counts["paged_decode"].plain_calls,
            ops.counts["paged_decode"].launches) == (1, 0)
    assert out.dtype == torch.float32 and tuple(out.shape) == (B, H, hd)
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.numpy(), ref_pallas, atol=2e-6, rtol=2e-6)
    np.testing.assert_allclose(out.numpy(), ref_xla, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_paged_is_bitwise_the_contiguous_cache(quant):
    """The port's paged attention (dispatcher and `attend_paged_cache`)
    equals its own `attend_full_cache` on the equivalent contiguous cache,
    bit for bit, rows at different positions."""
    rng = np.random.default_rng(11)
    B, KV, G, hd, P, S = 3, 2, 2, 16, 8, 32
    H = KV * G
    q = torch.from_numpy(rng.standard_normal((B, 1, H, hd)).astype(np.float32))
    cur = torch.tensor([5, 17, 31], dtype=torch.int32)
    cont, arena, pt = _arena(rng, B, S, KV, hd, P, quant)
    pt = torch.from_numpy(pt)
    paged = _torch_arena(arena, quant)
    if quant:
        c = [torch.from_numpy(a) for a in cont]
        contiguous = QuantKVCache(c[0], c[1], c[2].to(torch.bfloat16),
                                  c[3].to(torch.bfloat16))
    else:
        contiguous = KVCache(*(torch.from_numpy(a) for a in cont))
    ref = attend_full_cache(q, contiguous, cur.long()[:, None])
    scales = ((paged.k_scale, paged.v_scale) if quant else ())
    out = ops.paged_decode_attention(q[:, 0], paged.k, paged.v, pt, cur,
                                     *scales)
    assert torch.equal(out, ref.reshape(B, H, hd))
    assert torch.equal(attend_paged_cache(q, paged, cur.long()[:, None], pt),
                       ref)


def test_lone_scale_raises():
    rng = np.random.default_rng(0)
    _, arena, pt = _arena(rng, 1, 8, 2, 16, 8, True)
    cache = _torch_arena(arena, True)
    q = torch.zeros((1, 4, 16))
    cur = torch.zeros(1, dtype=torch.int32)
    for kw in (dict(k_scale=cache.k_scale), dict(v_scale=cache.v_scale)):
        with pytest.raises(ValueError, match="both k_scale and v_scale"):
            ops.paged_decode_attention(q, cache.k, cache.v,
                                       torch.from_numpy(pt), cur, **kw)


@pytest.mark.parametrize("shape", [(3, 5, 2, 16), (4, 1, 16, 64)])
def test_quantize_is_bit_identical(shape):
    """`torch.round` and `jnp.round` both round half to even: the int8
    values and the scales match the reference exactly, including exact
    halves and an all-zero row (the 1e-6 floor)."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[-1, 0, 0, :3] = (127.0, 2.5, -3.5)    # scale 1.0: exact halves
    jq, js = j_quantize(jnp.asarray(x))
    tq, ts = kvcache._quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32


def test_paged_writes_land_on_their_page_and_offset():
    """Decode writes go to (page_tables[b, pos // P], pos % P); an inactive
    row's write lands on the null page and nowhere else."""
    P, NP, KV, hd = 4, 6, 2, 8
    rng = np.random.default_rng(2)
    pt = torch.tensor([[3, 1, NP], [NP, NP, NP]], dtype=torch.int32)
    pos = torch.tensor([5, 2])
    k = torch.from_numpy(rng.standard_normal((2, 1, KV, hd)).astype(np.float32))
    v = -k
    targets = kvcache.paged_targets(pos, pt, P)
    cache = PagedKVCache(torch.zeros(NP + 1, P, KV, hd),
                         torch.zeros(NP + 1, P, KV, hd))
    kvcache.paged_kv_write_rows(cache, k, v, targets)
    assert torch.equal(cache.k[1, 1], k[0, 0])
    assert torch.equal(cache.v[NP, 2], v[1, 0])
    assert int((cache.k != 0).any(-1).any(-1).sum()) == 2
    qcache = PagedQuantKVCache(
        torch.zeros(NP + 1, P, KV, hd, dtype=torch.int8),
        torch.zeros(NP + 1, P, KV, hd, dtype=torch.int8),
        torch.zeros(NP + 1, P, KV, dtype=torch.bfloat16),
        torch.zeros(NP + 1, P, KV, dtype=torch.bfloat16))
    kvcache.paged_quant_kv_write_rows(qcache, k, v, targets)
    kq, ks = kvcache._quantize(k[:, 0])
    assert torch.equal(qcache.k[1, 1], kq[0])
    assert torch.equal(qcache.k_scale[1, 1], ks[0].to(torch.bfloat16))


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("null_rows", [(), (1,)], ids=["live", "null_row"])
def test_plain_matches_reference_on_bf16_arenas(G, null_rows):
    """bf16 arenas (a bf16 model's paged cache): the plain version equals
    the reference's XLA twin bit for bit and its Pallas body (interpret
    mode, float32 scores and P.V) within the bf16 tolerance of
    tests/test_kernels.py:10, 2e-2; rows at ragged positions, a null row
    among them. The arena's values are bf16 in both packages (rounded
    once, by JAX), q float32."""
    rng = np.random.default_rng(7 + G)
    B, KV, hd, P, S = 3, 2, 16, 8, 32
    H = KV * G
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    cur = np.asarray([5, 17, 31], np.int32)
    _, arena, pt = _arena(rng, B, S, KV, hd, P, False, null_rows)
    ka, va = (jnp.asarray(a, jnp.bfloat16) for a in arena)
    args = (jnp.asarray(q), ka, va, jnp.asarray(pt), jnp.asarray(cur))
    ref_xla = np.asarray(jpaged(*args))
    ref_pallas = np.asarray(jpaged(*args, interpret=True))
    k, v = (torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
            for a in (ka, va))
    ops.reset_counts()
    out = ops.paged_decode_attention(torch.from_numpy(q), k, v,
                                     torch.from_numpy(pt),
                                     torch.from_numpy(cur))
    assert (ops.counts["paged_decode"].plain_calls,
            ops.counts["paged_decode"].launches) == (1, 0)
    assert out.dtype == torch.float32 and tuple(out.shape) == (B, H, hd)
    assert bool(torch.isfinite(out).all())
    np.testing.assert_array_equal(out.numpy(), ref_xla)
    np.testing.assert_allclose(out.numpy(), ref_pallas, atol=2e-2, rtol=2e-2)
