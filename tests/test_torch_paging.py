"""The port's `PagePool` against the reference's, decision for decision.

The same admit / fork / append / retire sequences (hypothesis over seeds,
as the reference's own property test draws them) go to both pools; after
every operation the two must hold identical page tables, free lists,
refcounts, prefix registries and statistics, and the port's allocator
invariants (`check()`) must hold. Another test drives real arenas: the
same prefilled caches written, forked and copied on write in both packages
leave bitwise the same pages.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as jget_config
from repro.serving.paging import PagePool as JPagePool
from repro_torch.configs import get_config
from repro_torch.serving.paging import PagePool, cdiv

torch.set_num_threads(1)

TINY = dict(d_model=16, d_ff=32, n_layers=1, vocab_size=32)


def _pools(num_pages, page_size, max_len, overcommit):
    jpool = JPagePool(jget_config("opt-350m", reduced=True, **TINY),
                      num_pages=num_pages, page_size=page_size,
                      max_len=max_len, overcommit=overcommit)
    tpool = PagePool(get_config("opt-350m", reduced=True, **TINY),
                     num_pages=num_pages, page_size=page_size,
                     max_len=max_len, overcommit=overcommit, device="cpu")
    return jpool, tpool


def _same_state(jpool, tpool, jtables, ttables):
    assert tpool._free == jpool._free
    np.testing.assert_array_equal(tpool._refc, jpool._refc)
    np.testing.assert_array_equal(tpool._registry_refc, jpool._registry_refc)
    assert list(tpool._registry.items()) == list(jpool._registry.items())
    assert dataclasses.asdict(tpool.stats) == dataclasses.asdict(jpool.stats)
    assert tpool.summary() == jpool.summary()
    assert tpool.committed_outstanding() == jpool.committed_outstanding()
    assert tpool.n_evictable() == jpool.n_evictable()
    for jt, tt in zip(jtables, ttables):
        assert (tt.pages, tt.length, tt.budget, tt.allocated, tt.released) == \
            (jt.pages, jt.length, jt.budget, jt.allocated, jt.released)
    tpool.check()


def _same_plan(jplan, tplan):
    fields = ("shared_len", "n_shared", "shared_full", "new_now", "budget",
              "extra_parent", "n_shared_evictable", "shared_pages")
    assert [getattr(tplan, f) for f in fields] == \
        [getattr(jplan, f) for f in fields]
    assert (tplan.parent is None) == (jplan.parent is None)


@given(seed=st.integers(0, 200))
@settings(max_examples=25, deadline=None)
def test_pool_decisions_match_reference_under_random_interleaving(seed):
    """Random admit (fresh or forking) / append / retire sequences, on an
    overcommitted pool so dry allocations, evictions and rollbacks occur:
    both pools decide the same after every operation, and after releasing
    everything and clearing the registry both free lists are full."""
    rng = np.random.default_rng(seed)
    P, NP = 4, 12
    jpool, tpool = _pools(NP, P, 32, overcommit=True)
    live = []          # (jax table, port table)
    prompts = []
    uid = 0
    for _ in range(40):
        op = rng.integers(0, 3)
        if op == 0:                                  # admit (maybe a fork)
            if prompts and rng.random() < 0.4:
                base = prompts[rng.integers(len(prompts))]
                extra = rng.integers(0, 3)
                prompt = np.concatenate(
                    [base, rng.integers(0, 32, extra)]).astype(np.int32)
            else:
                prompt = rng.integers(
                    0, 32, rng.integers(1, 12)).astype(np.int32)
            max_new = int(rng.integers(1, 8))
            if cdiv(len(prompt) + max_new, P) > NP:
                continue
            _same_plan(jpool.plan_admit(prompt, max_new),
                       tpool.plan_admit(prompt, max_new))
            assert tpool.can_admit(tpool.plan_admit(prompt, max_new)) == \
                jpool.can_admit(jpool.plan_admit(prompt, max_new))
            jt, jplan = jpool.admit(prompt, max_new, uid=uid)
            tt, tplan = tpool.admit(prompt, max_new, uid=uid)
            _same_plan(jplan, tplan)
            uid += 1
            assert (tt is None) == (jt is None)
            if tt is not None:
                jpool.register_prefixes(prompt, jt)
                tpool.register_prefixes(prompt, tt)
                live.append((jt, tt))
                prompts.append(prompt)
        elif op == 1 and live:                       # grow one table
            jt, tt = live[rng.integers(len(live))]
            assert tpool.prepare_append(tt, tt.length) == \
                jpool.prepare_append(jt, jt.length)
        elif op == 2 and live:                       # retire one table
            jt, tt = live.pop(rng.integers(len(live)))
            jpool.release(jt)
            tpool.release(tt)
        _same_state(jpool, tpool, *zip(*live) if live else ((), ()))
    for jt, tt in live:
        jpool.release(jt)
        tpool.release(tt)
        _same_state(jpool, tpool, (), ())
    assert tpool.clear_prefix_cache() == jpool.clear_prefix_cache()
    _same_state(jpool, tpool, (), ())
    assert tpool.n_free == NP
    assert tpool.stats.pages_allocated == tpool.stats.pages_freed
    assert tpool.n_evictable() == 0


def _fill_arenas(rng, jpool, tpool):
    """The same random bytes in every arena of both pools, so the rows a
    prompt write must leave alone (past the prompt in its last page, other
    requests' pages, the null page) are checked as left alone. Float values
    are multiples of 1/8, exact in bf16."""
    groups = []
    for jg, tg in zip(jpool.cache_groups, tpool.cache_groups):
        group = {}
        for sub, tarena in tg.items():
            jleaves = []
            for jleaf, tleaf in zip(jg[sub], tarena):
                if tleaf.dtype == torch.int8:
                    a = rng.integers(-128, 128, tleaf.shape).astype(np.int8)
                else:
                    a = (rng.integers(-64, 64, tleaf.shape) / 8).astype(
                        np.float32)
                tleaf.copy_(torch.from_numpy(a))
                jleaves.append(jnp.asarray(a).astype(jleaf.dtype))
            group[sub] = type(jg[sub])(*jleaves)
        groups.append(group)
    jpool.cache_groups = groups


def _same_arena_bytes(jpool, tpool):
    for jg, tg in zip(jpool.cache_groups, tpool.cache_groups):
        for sub, tarena in tg.items():
            for jleaf, tleaf in zip(jg[sub], tarena):
                np.testing.assert_array_equal(
                    tleaf.contiguous().view(torch.uint8).numpy(),
                    np.asarray(jleaf).view(np.uint8))


# (prompt length, or ("fork"|"prefix", source, extra tokens)) a step;
# "release" retires the named earlier request
_WRITE_SCRIPTS = {
    # freed pages come back off the LIFO free list in reverse: [2, 1, 0, 5]
    "lifo": [10, 7, ("release", 0), 13],
    "aligned": [5, ("release", 0), 12],
    "short": [3],
    # the registry shares the first 8 tokens: two pages skipped, then one
    # owned full page and a tail
    "prefix": [10, ("prefix", 0, 5)],
    # a live fork of a 6-token prompt extended by 5: the shared partial
    # page is copied on write at admission, then written whole
    "fork": [6, ("fork", 0, 5)],
}


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("script", list(_WRITE_SCRIPTS))
def test_prompt_writes_match_reference_bytes(script, quant):
    """Prompt writes over arenas filled with random bytes: pages out of
    order, a prompt ending on a page boundary, one shorter than a page, a
    registry-shared prefix (the first owned page past 0) and a live fork of
    a partial page. Every byte of every arena equals the reference's."""
    cfg_kw = dict(TINY, n_layers=2, kv_quant=quant)
    cfg = get_config("opt-350m", reduced=True, **cfg_kw)
    P, NP, max_len = 4, 16, 24
    jpool = JPagePool(jget_config("opt-350m", reduced=True, **cfg_kw),
                      num_pages=NP, page_size=P, max_len=max_len,
                      layout="groups")
    tpool = PagePool(cfg, num_pages=NP, page_size=P, max_len=max_len,
                     device="cpu")
    rng = np.random.default_rng(7)
    _fill_arenas(rng, jpool, tpool)
    prompts, jts, tts = [], [], []
    for step in _WRITE_SCRIPTS[script]:
        if isinstance(step, tuple) and step[0] == "release":
            jpool.release(jts[step[1]])
            tpool.release(tts[step[1]])
            continue
        if isinstance(step, tuple):
            kind, src, extra = step
            base = prompts[src][:8] if kind == "prefix" else prompts[src]
            prompt = np.concatenate(
                [base, rng.integers(0, 32, extra)]).astype(np.int32)
        else:
            prompt = rng.integers(0, 32, step).astype(np.int32)
        uid = len(prompts)
        jt, _ = jpool.admit(prompt, 4, uid=uid)
        tt, _ = tpool.admit(prompt, 4, uid=uid)
        jcache, tcache = _small_caches(rng, cfg, 2, max_len)
        jpool.write_prompt(jt, jcache)
        tpool.write_prompt(tt, tcache)
        if script == "prefix":      # elsewhere released pages come back
            jpool.register_prefixes(prompt, jt)
            tpool.register_prefixes(prompt, tt)
        prompts.append(prompt)
        jts.append(jt)
        tts.append(tt)
    # each script reaches the case it is named after
    last = tts[-1]
    if script in ("lifo", "aligned"):
        assert last.pages != sorted(last.pages)
    assert (last.prompt_len % P == 0) == (script == "aligned")
    assert (last.prompt_len < P) == (script == "short")
    assert (tpool.stats.prefix_hits == 1) == (script in ("prefix", "fork"))
    assert tpool.stats.cow_copies == (script == "fork")
    _same_state(jpool, tpool, jts, tts)
    _same_arena_bytes(jpool, tpool)


@pytest.mark.parametrize("overcommit", [False, True],
                         ids=["strict", "overcommit"])
def test_gate_and_page_tables_match_reference(overcommit):
    """The commitment gate and the page-table rows the decode step reads
    agree with the reference, strict and overcommitted."""
    rng = np.random.default_rng(4)
    jpool, tpool = _pools(10, 4, 40, overcommit)
    jts, tts = [], []
    for uid in range(6):
        prompt = rng.integers(0, 32, int(rng.integers(3, 10))).astype(np.int32)
        jplan, tplan = jpool.plan_admit(prompt, 8), tpool.plan_admit(prompt, 8)
        assert tpool.can_admit(tplan) == jpool.can_admit(jplan)
        if not tpool.can_admit(tplan):
            continue
        jt, _ = jpool.admit(prompt, 8, uid=uid)
        tt, _ = tpool.admit(prompt, 8, uid=uid)
        jts.append(jt)
        tts.append(tt)
        _same_state(jpool, tpool, jts, tts)
    jrow = np.zeros(tpool.max_pages_per_seq, np.int32)
    trow = np.zeros_like(jrow)
    for jt, tt in zip(jts + [None], tts + [None]):
        jpool.page_table_row(jt, jrow)
        tpool.page_table_row(tt, trow)
        np.testing.assert_array_equal(trow, jrow)
    assert trow.tolist() == [tpool.null_page] * len(trow)   # a free slot


def test_pool_rejects_ssm_stacks():
    cfg = get_config("jamba-1.5-large-398b", reduced=True)
    with pytest.raises(ValueError, match="attention-only"):
        PagePool(cfg, num_pages=8, page_size=4, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="num_pages"):
        PagePool(get_config("opt-350m", reduced=True, **TINY), num_pages=0,
                 page_size=4, max_len=32, device="cpu")


def _small_caches(rng, cfg, G, max_len):
    """One B=1 prefilled cache from the same numbers in both packages'
    layouts: the reference's stacked {sub_0: [G, 1, S, ...]} and the port's
    per-group list [{sub_0: [1, S, ...]}]. int8 caches get bf16 scales."""
    from repro.models.kvcache import KVCache as JKV, QuantKVCache as JQKV
    from repro_torch.models.kvcache import KVCache, QuantKVCache
    shape = (G, 1, max_len, cfg.n_kv_heads, cfg.head_dim)
    if cfg.kv_quant:
        rows = [rng.integers(-127, 128, shape).astype(np.int8)
                for _ in range(2)]
        scales = [rng.random(shape[:-1]).astype(np.float32) / 127
                  for _ in range(2)]
        jleaves = ([jnp.asarray(a) for a in rows]
                   + [jnp.asarray(a).astype(jnp.bfloat16) for a in scales])
        tleaves = ([torch.from_numpy(a) for a in rows]
                   + [torch.from_numpy(a).to(torch.bfloat16) for a in scales])
        jcls, tcls = JQKV, QuantKVCache
    else:
        rows = [rng.standard_normal(shape).astype(np.float32)
                for _ in range(2)]
        jleaves = [jnp.asarray(a) for a in rows]
        tleaves = [torch.from_numpy(a) for a in rows]
        jcls, tcls = JKV, KVCache
    return ({"sub_0": jcls(*jleaves)},
            [{"sub_0": tcls(*(t[g] for t in tleaves))} for g in range(G)])


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_prompt_writes_and_cow_leave_reference_pages(quant):
    """The same prefilled caches written into the arenas, a live fork of one
    prompt, and the copy on write its first decode append triggers: every
    page of every layer's arena holds the reference's bytes afterwards."""
    cfg_kw = dict(TINY, n_layers=2, kv_quant=quant)
    cfg = get_config("opt-350m", reduced=True, **cfg_kw)
    P, NP, max_len = 4, 16, 24
    jpool = JPagePool(jget_config("opt-350m", reduced=True, **cfg_kw),
                      num_pages=NP, page_size=P, max_len=max_len,
                      layout="groups")
    tpool = PagePool(cfg, num_pages=NP, page_size=P, max_len=max_len,
                     device="cpu")
    rng = np.random.default_rng(1)
    base = rng.integers(0, 32, 6).astype(np.int32)
    prompts = [base, rng.integers(0, 32, 9).astype(np.int32), base.copy()]
    jts, tts = [], []
    for uid, prompt in enumerate(prompts):
        jt, _ = jpool.admit(prompt, 4, uid=uid)
        tt, _ = tpool.admit(prompt, 4, uid=uid)
        jcache, tcache = _small_caches(rng, cfg, 2, max_len)
        jpool.write_prompt(jt, jcache)
        tpool.write_prompt(tt, tcache)
        jts.append(jt)
        tts.append(tt)
    assert tpool.stats.prefix_hits == jpool.stats.prefix_hits == 1
    # the fork's first append lands in the shared partial page: CoW
    assert tpool.prepare_append(tts[2], 6) and jpool.prepare_append(jts[2], 6)
    assert tpool.stats.cow_copies == jpool.stats.cow_copies == 1
    _same_state(jpool, tpool, jts, tts)
    for jg, tg in zip(jpool.cache_groups, tpool.cache_groups):
        for sub, tarena in tg.items():
            for jleaf, tleaf in zip(jg[sub], tarena):
                np.testing.assert_array_equal(
                    tleaf.float().numpy(),
                    np.asarray(jleaf.astype(jnp.float32)))
