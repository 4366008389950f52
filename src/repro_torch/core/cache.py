"""DRAM neuron cache: S3-FIFO base policy + linking-aligned admission (paper §5.2).

The paper integrates the S3-FIFO cache (Yang et al., SOSP'23) into all baselines
and adds, for RIPPLE, an *admission* layer that distinguishes

  * sporadic neurons — activated with few contiguous neighbours: cached normally;
  * continuous segments — runs of >= `segment_min_len` contiguous (in flash
    layout) activated neurons: admitted with lower probability `segment_admit_p`,
    because caching fragments of a segment punches holes in contiguous flash
    runs (hurting continuity) while whole segments are cheap to re-read anyway.

Only admission changes; eviction/promotion remain S3-FIFO ("we only control the
caching admitting policy, yet leave the other unchanged").

Two implementations of the same policy live here:

  * `LinkingAlignedCache` — the reference oracle: OrderedDict queues, one
    Python iteration per neuron. Easy to audit against the paper, but the
    per-neuron loop dominates the online stage's host time at realistic
    activated-set sizes (thousands of neurons per decode step per layer).
  * `ArrayLinkingAlignedCache` — the array-native hot-path implementation:
    residency/frequency arrays + numpy FIFO queues. `lookup` is one
    fancy-index probe, classification reuses the vectorized run-break logic
    from `collapse`, admission sampling is a single `stable_uniform_array`
    call, and queue maintenance runs as bulk array ops on the (overwhelmingly
    common) no-recycle path, falling back to an exact sequential replay of the
    reference algorithm whenever a batch could hit an order-dependent corner
    (CLOCK recycling in the main queue, ghost overflow racing a ghost hit).
    It is decision-for-decision identical to the reference — same hits,
    misses, admissions, rejections, evictions, and ghost promotions, in the
    same order (tests/test_cache_equivalence.py proves it on random traces).

Admission order is deterministic in both: misses are classified in physical
(flash-layout) order, sporadic neurons are inserted first, then the sampled
segment members — so the two implementations can be compared decision for
decision and reruns are reproducible.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Dict, Iterable, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.collapse import run_bounds_from_sorted
from repro_torch.utils import stable_uniform, stable_uniform_array


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    admitted: int = 0
    rejected: int = 0
    evicted: int = 0
    ghost_promotions: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


@dataclasses.dataclass
class LoopCounters:
    """Per-neuron Python-loop iteration counters.

    The reference implementation bills every per-neuron Python iteration here;
    the array-native implementation must keep all three at zero (its only
    non-vectorized work is the rare exact-replay fallback, counted
    separately per *batch*, and amortized queue maintenance). The CI perf
    smoke asserts the hot-path counters stay zero.
    """
    probe: int = 0        # per-neuron cache-probe iterations (lookup)
    classify: int = 0     # per-neuron run-classification iterations
    sample: int = 0       # per-neuron admission-sampling iterations
    fallback_batches: int = 0   # admit batches replayed sequentially (exactness)
    fallback_inserts: int = 0   # inserts executed inside those replays

    @property
    def per_neuron_total(self) -> int:
        return self.probe + self.classify + self.sample


class S3FIFOCache:
    """S3-FIFO: small FIFO (probation), main FIFO, ghost queue of evicted keys.

    Keys are (layer, neuron) tuples or plain ints; capacity in entries.
    """

    def __init__(self, capacity: int, small_ratio: float = 0.1, ghost_ratio: float = 0.9) -> None:
        self.capacity = max(capacity, 0)
        self.small_cap = max(1, int(self.capacity * small_ratio)) if self.capacity else 0
        self.main_cap = self.capacity - self.small_cap
        self.small: "OrderedDict[object, int]" = OrderedDict()   # key -> freq
        self.main: "OrderedDict[object, int]" = OrderedDict()
        self.ghost: "OrderedDict[object, None]" = OrderedDict()
        self.ghost_cap = max(1, int(self.capacity * ghost_ratio)) if self.capacity else 0
        self.stats = CacheStats()

    def __contains__(self, key: object) -> bool:
        return key in self.small or key in self.main

    def __len__(self) -> int:
        return len(self.small) + len(self.main)

    def access(self, key: object) -> bool:
        """Lookup; bumps frequency on hit. Returns hit?"""
        if key in self.small:
            self.small[key] = min(self.small[key] + 1, 3)
            self.stats.hits += 1
            return True
        if key in self.main:
            self.main[key] = min(self.main[key] + 1, 3)
            self.stats.hits += 1
            return True
        self.stats.misses += 1
        return False

    def insert(self, key: object) -> None:
        if self.capacity == 0 or key in self:
            return
        self.stats.admitted += 1
        if key in self.ghost:
            del self.ghost[key]
            self.main[key] = 0
            self.stats.ghost_promotions += 1
            self._evict_main()
        else:
            self.small[key] = 0
            self._evict_small()

    def _evict_small(self) -> None:
        while len(self.small) > self.small_cap:
            key, freq = self.small.popitem(last=False)
            if freq > 0:                       # seen again while on probation
                self.main[key] = 0
                self._evict_main()
            else:
                self._ghost_insert(key)
                self.stats.evicted += 1

    def _evict_main(self) -> None:
        while len(self.main) > self.main_cap:
            key, freq = self.main.popitem(last=False)
            if freq > 0:
                self.main[key] = freq - 1       # reinsert at tail, decremented
            else:
                self._ghost_insert(key)
                self.stats.evicted += 1

    def _ghost_insert(self, key: object) -> None:
        self.ghost[key] = None
        while len(self.ghost) > self.ghost_cap:
            self.ghost.popitem(last=False)

    def queues(self) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]], List[int]]:
        """(small [(key, freq)], main [(key, freq)], ghost [key]) in FIFO order
        — the full decision state, for equivalence checks against the
        array-native implementation."""
        small = [(int(k), int(f)) for k, f in self.small.items()]
        main = [(int(k), int(f)) for k, f in self.main.items()]
        return small, main, [int(k) for k in self.ghost.keys()]


class LRUCache:
    """Classic LRU — a weaker baseline than S3-FIFO (paper cites S3-FIFO as
    the strong cache it integrates into all systems; LRU is here for the
    cache-policy ablation benchmark)."""

    def __init__(self, capacity: int) -> None:
        self.capacity = max(capacity, 0)
        self.data: "OrderedDict[object, None]" = OrderedDict()
        self.stats = CacheStats()

    def __contains__(self, key: object) -> bool:
        return key in self.data

    def __len__(self) -> int:
        return len(self.data)

    def access(self, key: object) -> bool:
        if key in self.data:
            self.data.move_to_end(key)
            self.stats.hits += 1
            return True
        self.stats.misses += 1
        return False

    def insert(self, key: object) -> None:
        if self.capacity == 0 or key in self.data:
            return
        self.stats.admitted += 1
        self.data[key] = None
        while len(self.data) > self.capacity:
            self.data.popitem(last=False)
            self.stats.evicted += 1


class FIFOCache:
    """Plain FIFO — the weakest baseline."""

    def __init__(self, capacity: int) -> None:
        self.capacity = max(capacity, 0)
        self.queue: deque = deque()
        self.members: Set[object] = set()
        self.stats = CacheStats()

    def __contains__(self, key: object) -> bool:
        return key in self.members

    def __len__(self) -> int:
        return len(self.members)

    def access(self, key: object) -> bool:
        if key in self.members:
            self.stats.hits += 1
            return True
        self.stats.misses += 1
        return False

    def insert(self, key: object) -> None:
        if self.capacity == 0 or key in self.members:
            return
        self.stats.admitted += 1
        self.queue.append(key)
        self.members.add(key)
        while len(self.queue) > self.capacity:
            self.members.discard(self.queue.popleft())
            self.stats.evicted += 1


class LinkingAlignedCache:
    """Reference S3-FIFO + linking-aligned admission (per-neuron Python loops).

    `lookup(ids)` splits activated neuron ids into cache hits and misses;
    `admit(ids, physical_positions)` classifies misses into sporadic neurons vs
    continuous segments and admits segment members with probability
    `segment_admit_p` (deterministic pseudo-random so runs are reproducible).

    Kept as the decision oracle for `ArrayLinkingAlignedCache`; the serving
    engine uses the array-native implementation by default.
    """

    def __init__(
        self,
        capacity: int,
        segment_min_len: int = 4,
        segment_admit_p: float = 0.25,
        linking_aligned: bool = True,
        salt: int = 0,
    ) -> None:
        self.cache = S3FIFOCache(capacity)
        self.segment_min_len = segment_min_len
        self.segment_admit_p = segment_admit_p
        self.linking_aligned = linking_aligned
        self.salt = salt
        self._tick = 0
        self.loop_counters = LoopCounters()

    @property
    def stats(self) -> CacheStats:
        return self.cache.stats

    def lookup_mask(self, ids: np.ndarray) -> np.ndarray:
        """Boolean hit mask over `ids` (in input order); bumps hit frequencies."""
        ids = np.asarray(ids, dtype=np.int64)
        self.loop_counters.probe += int(ids.size)
        return np.fromiter((self.cache.access(int(i)) for i in ids),
                           dtype=bool, count=len(ids))

    def peek_mask(self, ids: np.ndarray) -> np.ndarray:
        """Side-effect-free residency probe: same mask as `lookup_mask` would
        return, but no hit/miss counters, frequencies, or queue state move.
        The admission predictor (serving/server.py) uses this to cost a step
        without perturbing the cache it is predicting."""
        ids = np.asarray(ids, dtype=np.int64)
        return np.fromiter((int(i) in self.cache for i in ids),
                           dtype=bool, count=len(ids))

    def lookup(self, ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.asarray(ids, dtype=np.int64)
        hit_mask = self.lookup_mask(ids)
        return ids[hit_mask], ids[~hit_mask]

    def _classify_ordered(self, miss_ids: np.ndarray,
                          physical: np.ndarray) -> Tuple[List[int], List[int]]:
        """(sporadic, segment_members) as lists in physical-layout order."""
        order = np.argsort(physical)
        phys_sorted = physical[order]
        ids_sorted = np.asarray(miss_ids, dtype=np.int64)[order]
        sporadic: List[int] = []
        segment: List[int] = []
        run: List[int] = []

        def flush(run_ids: List[int]) -> None:
            target = segment if len(run_ids) >= self.segment_min_len else sporadic
            target.extend(run_ids)

        for k in range(len(ids_sorted)):
            self.loop_counters.classify += 1
            if run and phys_sorted[k] != phys_sorted[k - 1] + 1:
                flush(run)
                run = []
            run.append(int(ids_sorted[k]))
        if run:
            flush(run)
        return sporadic, segment

    def classify(self, miss_ids: np.ndarray, physical: np.ndarray) -> Tuple[Set[int], Set[int]]:
        """Split miss ids into (sporadic, segment_members) by run length in flash."""
        sporadic, segment = self._classify_ordered(miss_ids, physical)
        return set(sporadic), set(segment)

    def admit(self, miss_ids: np.ndarray, physical: np.ndarray) -> None:
        miss_ids = np.asarray(miss_ids, dtype=np.int64)
        if miss_ids.size == 0:
            return
        self._tick += 1
        if not self.linking_aligned:
            for i in miss_ids:
                self.cache.insert(int(i))
            return
        sporadic, segment = self._classify_ordered(
            miss_ids, np.asarray(physical, dtype=np.int64))
        for i in sporadic:
            self.cache.insert(i)
        for i in segment:
            self.loop_counters.sample += 1
            if stable_uniform(self.salt, self._tick, i) < self.segment_admit_p:
                self.cache.insert(i)
            else:
                self.cache.stats.rejected += 1

    def resident_ids(self) -> np.ndarray:
        keys = list(self.cache.small.keys()) + list(self.cache.main.keys())
        return np.asarray(sorted(int(k) for k in keys), dtype=np.int64)


# ---------------------------------------------------------------------------
# Array-native implementation
# ---------------------------------------------------------------------------

def _merge_sorted(a_keys: np.ndarray, a_pos: np.ndarray,
                  b_keys: np.ndarray, b_pos: np.ndarray,
                  b_after_ties: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Merge two (keys, sort-position) streams, each already sorted by
    position, into one — O(n) via two searchsorted calls instead of an
    argsort. `b_after_ties` places b-entries after equal-position a-entries.
    Returns (merged_keys, merged_positions)."""
    na, nb = int(a_pos.size), int(b_pos.size)
    if na == 0:
        return b_keys, b_pos
    if nb == 0:
        return a_keys, a_pos
    side_a, side_b = ("left", "right") if b_after_ties else ("right", "left")
    ia = np.arange(na) + np.searchsorted(b_pos, a_pos, side=side_a)
    ib = np.arange(nb) + np.searchsorted(a_pos, b_pos, side=side_b)
    keys = np.empty(na + nb, dtype=a_keys.dtype)
    pos = np.empty(na + nb, dtype=a_pos.dtype)
    keys[ia], keys[ib] = a_keys, b_keys
    pos[ia], pos[ib] = a_pos, b_pos
    return keys, pos


class ArrayS3FIFOCache:
    """S3-FIFO over dense numpy state for an integer key space [0, n_keys).

    State:
      * `where`   int8[n_keys]  — 0 absent, 1 in small FIFO, 2 in main FIFO
      * `freq`    int64[n_keys] — S3-FIFO access frequency (valid while resident)
      * `in_ghost` bool[n_keys] — ghost-queue membership bitmap
      * `_small_q`/`_main_q`/`_ghost_q` — FIFO orders as plain int64 arrays
        (head first), rebuilt by slicing/concatenation once per insert batch.

    `access_batch` is a single fancy-index probe; `insert_batch` applies a
    whole admission batch with bulk array ops and is exact for arbitrary
    interleavings: main-queue CLOCK recycling is simulated by the chunked
    `_drain_main`, and ghost-overflow races against same-batch ghost hits
    are resolved up-front by `_refine_ghost_decisions`. Only inputs the
    admit path never produces (duplicate or already-resident keys) are
    replayed through the reference `S3FIFOCache` (bitwise-identical by
    construction) — counted in `loop_counters.fallback_*`.
    """

    def __init__(self, capacity: int, n_keys: int,
                 small_ratio: float = 0.1, ghost_ratio: float = 0.9) -> None:
        self.capacity = max(capacity, 0)
        self.n_keys = int(n_keys)
        self.small_cap = max(1, int(self.capacity * small_ratio)) if self.capacity else 0
        self.main_cap = self.capacity - self.small_cap
        self.ghost_cap = max(1, int(self.capacity * ghost_ratio)) if self.capacity else 0
        self.stats = CacheStats()
        self.where = np.zeros(self.n_keys, dtype=np.int8)
        self.freq = np.zeros(self.n_keys, dtype=np.int64)
        self.in_ghost = np.zeros(self.n_keys, dtype=bool)
        self._small_q = np.zeros(0, dtype=np.int64)
        self._main_q = np.zeros(0, dtype=np.int64)
        self._ghost_q = np.zeros(0, dtype=np.int64)
        self._ghost_rank = np.zeros(self.n_keys, dtype=np.int64)
        self.bulk_batches = 0
        self.fallback_batches = 0
        self.fallback_inserts = 0

    def __len__(self) -> int:
        return int(self._small_q.size + self._main_q.size)

    def __contains__(self, key: int) -> bool:
        return bool(self.where[int(key)] > 0)

    # -- probe --------------------------------------------------------------
    def access_batch(self, ids: np.ndarray) -> np.ndarray:
        """Vectorized `access` over an id batch; returns the hit mask.

        Decision-identical to calling the reference `access` per id in order:
        residency cannot change mid-batch (no inserts here), so the hit mask
        is the residency bitmap, and hit frequencies rise by the number of
        occurrences, saturating at 3.
        """
        ids = np.asarray(ids, dtype=np.int64)
        if ids.size == 0:
            return np.zeros(0, dtype=bool)
        hit = self.where[ids] > 0
        n_hits = int(np.count_nonzero(hit))
        self.stats.hits += n_hits
        self.stats.misses += int(ids.size) - n_hits
        hit_ids = ids[hit]
        if hit_ids.size:
            if hit_ids.size == 1 or np.all(np.diff(hit_ids) > 0):  # unique fast path
                self.freq[hit_ids] = np.minimum(self.freq[hit_ids] + 1, 3)
            else:
                uniq, counts = np.unique(hit_ids, return_counts=True)
                self.freq[uniq] = np.minimum(self.freq[uniq] + counts, 3)
        return hit

    # -- insert -------------------------------------------------------------
    def insert_batch(self, keys: np.ndarray, assume_unique: bool = False) -> None:
        """Insert `keys` as if `insert` were called per key in order.

        A batch is planned from the ghost-membership decisions as of batch
        start. A provisional decision is wrong only when ghost overflow pops
        a batch key's entry earlier in the same batch than that key's own
        insertion; `_refine_ghost_decisions` resolves exactly those before
        planning, so the plan is exact in one pass.
        """
        keys = np.asarray(keys, dtype=np.int64)
        if self.capacity == 0 or keys.size == 0:
            return
        # the bulk path assumes distinct, non-resident keys (the admit path
        # guarantees this: keys are this step's misses); anything else is an
        # order-dependent corner -> exact sequential replay
        if np.any(self.where[keys] > 0) or (
                not assume_unique and np.unique(keys).size != keys.size):
            return self._insert_batch_seq(keys)
        d = self.in_ghost[keys]                      # provisional ghost decisions
        if np.any(d):
            d = self._refine_ghost_decisions(keys, d)
        self._commit_bulk(keys, d, self._plan_bulk(keys, d))

    def _refine_ghost_decisions(self, keys: np.ndarray,
                                d0: np.ndarray) -> np.ndarray:
        """Resolve the ghost-decision fixed point in one ordered scan.

        A provisional decision is wrong only when ghost overflow pops the
        key's entry earlier in the same batch. Every queue quantity the
        overflow depends on reduces to a COUNT that is a function of (step,
        kept-ghost-hits-so-far): with `f` fresh inserts, the small queue pops
        max(0, f - slack) entries — always the leading slice of (old small ++
        fresh keys), whose promote/ghost split depends on the old entries'
        frequencies only (batch keys enter with freq 0) and is precomputed as
        one cumsum. Main evictions are one per over-cap append regardless of
        CLOCK recycling, so they're a running count too. The scan walks the
        ghost-hit candidates in step order (runs of fresh steps in between
        advance in O(1)), maintaining the ghost pop count and the kept
        entries' rank order; each candidate is kept or flipped exactly as the
        sequential process would. Cost: O(candidates log candidates) plus one
        cumsum — no per-neuron work.
        """
        cand = np.flatnonzero(d0)
        nc = int(cand.size)
        ranks = self._ghost_rank[keys[cand]]
        Ls, Lm = int(self._small_q.size), int(self._main_q.size)
        slack_s = self.small_cap - Ls
        main_over = Lm - self.main_cap
        base = int(self._ghost_q.size) - self.ghost_cap
        # promotions among the first x small pops, for any x (pops beyond the
        # old small queue hit batch keys, which enter with freq 0)
        cs = np.concatenate([np.zeros(1, dtype=np.int64),
                             np.cumsum(self.freq[self._small_q] > 0),
                             np.full(int(keys.size), 0, dtype=np.int64)])
        if self._small_q.size:
            cs[Ls + 1:] = cs[Ls]

        # Ghost pop pressure right after step j's append is
        #   base + small_ghosts(j, kept) + main_evictions(j, kept) - kept,
        # nondecreasing in j at fixed kept, so each candidate needs exactly
        # one evaluation: the endpoint of the run right before it (step - 1),
        # folded into a running max. Decisions must resolve strictly in step
        # order (a later flip can raise pop pressure past the binding max of
        # an earlier candidate but not vice versa), so the scan is scalar;
        # the expensive rank bookkeeping is hoisted out: deleted_ahead under
        # the all-kept assumption is one vectorized triangular count, and the
        # loop only corrects it by the (few) actually-flipped ranks.
        from bisect import bisect_left, insort

        cand_l, ranks_l = cand.tolist(), ranks.tolist()
        cs_l = cs.tolist()
        pops_g, kept = 0, 0
        kept_ranks: List[int] = []
        flip_steps: List[int] = []
        for i, step in enumerate(cand_l):
            if step:
                pops_s = step - kept - slack_s    # small pops through step-1
                if pops_s < 0:
                    pops_s = 0
                promos = cs_l[pops_s]
                ev = main_over + kept + promos    # main evictions
                if ev < 0:
                    ev = 0
                p = base + (pops_s - promos) + ev - kept
                if p > pops_g:
                    pops_g = p
            r = ranks_l[i]
            # effective rank: kept deletions ahead with smaller rank move the
            # entry toward the head
            if r - bisect_left(kept_ranks, r) < pops_g:
                flip_steps.append(step)           # entry already popped
            else:                                 # true ghost hit
                insort(kept_ranks, r)
                kept += 1
        d = d0.copy()
        if flip_steps:
            d[flip_steps] = False                 # -> plain fresh inserts
        return d

    def _plan_bulk(self, keys: np.ndarray, d: np.ndarray) -> dict:
        fresh = keys[~d]
        step_of_fresh = np.flatnonzero(~d)
        step_of_hit = np.flatnonzero(d)

        # -- small FIFO: one pop per over-cap append, pops never recycle into
        # small, so popped == leading slice of (old queue ++ fresh appends)
        S0, Ls, nF = self._small_q, int(self._small_q.size), int(fresh.size)
        n_pop_s = max(0, Ls + nF - self.small_cap)
        small_seq = np.concatenate([S0, fresh]) if nF else S0
        popped = small_seq[:n_pop_s]
        popped_f = self.freq[popped].copy()
        if n_pop_s > Ls:
            popped_f[Ls:] = 0                        # batch keys enter with freq 0
        promote = popped_f > 0
        new_small = small_seq[n_pop_s:]
        # the t-th pop fires at the (t + slack)-th fresh insert
        pop_steps = step_of_fresh[max(0, self.small_cap - Ls):][:n_pop_s]
        promoted = popped[promote]
        small_ghosted = popped[~promote]
        small_ghost_steps = pop_steps[~promote]

        # -- main FIFO appends: ghost hits + small promotions, in step order
        app_keys, app_steps = _merge_sorted(keys[d], step_of_hit,
                                            promoted, pop_steps[promote])

        # -- main FIFO CLOCK drain (exact, chunked — see _drain_main)
        M0, Lm, nA = self._main_q, int(self._main_q.size), int(app_keys.size)
        slack_m = self.main_cap - Lm
        n_evict_m = max(0, Lm + nA - self.main_cap)
        if n_evict_m:
            main_evicted, new_main, recycled = self._drain_main(
                M0, app_keys, n_evict_m, slack_m)
            # the i-th main eviction fires at the (i + main_slack)-th append
            main_ghost_steps = app_steps[slack_m:][:n_evict_m]
        else:
            new_main = np.concatenate([M0, app_keys]) if nA else M0
            main_evicted = new_main[:0]
            recycled = new_main[:0]
            main_ghost_steps = app_steps[:0]

        # -- ghost queue: <=1 append and <=1 deletion per step; deletion
        # precedes the append within a step; overflow pops after each append.
        # The schedule is exact because `_refine_ghost_decisions` already
        # resolved every decision a mid-batch overflow pop could flip.
        g_app, g_steps = _merge_sorted(small_ghosted, small_ghost_steps,
                                       main_evicted, main_ghost_steps)
        n_del, n_app = int(step_of_hit.size), int(g_app.size)
        if n_app:
            # live count right after each event, ignoring pops; the cumulative
            # pop count after any prefix is the running max of (live - cap).
            # Deletions sort before the same step's append (del, then insert).
            ev_delta, _ = _merge_sorted(
                np.full(n_del, -1, dtype=np.int64), step_of_hit,
                np.ones(n_app, dtype=np.int64), g_steps)
            is_append = ev_delta == 1
            live = int(self._ghost_q.size) + np.cumsum(ev_delta)
            pops_run = np.maximum.accumulate(
                np.where(is_append, live - self.ghost_cap, 0))
            n_pop = max(0, int(pops_run[-1]))
        else:
            n_pop = 0
        return dict(fresh=fresh, app_keys=app_keys, new_small=new_small,
                    new_main=new_main, small_ghosted=small_ghosted,
                    main_evicted=main_evicted, recycled=recycled,
                    g_app=g_app, n_pop=n_pop,
                    n_ghost_hits=int(step_of_hit.size))

    def _drain_main(self, M0: np.ndarray, app_keys: np.ndarray, n_evict: int,
                    slack: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Exact CLOCK drain of the main FIFO for one append batch.

        Pops consume arrivals in time order; a popped entry with freq > 0 is
        decremented and recycled to the tail, re-arriving right after the
        append that triggered the in-progress eviction (#slack+e); each
        eviction ends at the next freq-0 pop. Simulated in vectorized chunks:
        a chunk pops up to the first recycle's re-arrival position (all pops
        before it are final regardless of interleaving), then its recycles
        merge back into the pending stream by arrival time. Every chunk
        completes at least one eviction and recycling strictly decreases
        frequency, so a handful of chunks covers any batch (typically one).

        Returns (evicted keys in eviction order, new queue in FIFO order,
        recycled keys — one occurrence per frequency decrement).
        """
        Lm, nA = int(M0.size), int(app_keys.size)
        SUB = np.int64(1) << np.int64(32)
        # arrival-time keys: bucket = append number (0 for old entries),
        # sub-priority orders same-bucket arrivals (append, then recycles)
        pending = np.concatenate([M0, app_keys])
        ptime = np.concatenate([np.arange(Lm, dtype=np.int64),
                                np.arange(1, nA + 1, dtype=np.int64) * SUB])
        pfz = np.concatenate([self.freq[M0], np.zeros(nA, dtype=np.int64)])
        evicted_parts: List[np.ndarray] = []
        recycled_parts: List[np.ndarray] = []
        done, rc = 0, 1
        while done < n_evict:
            zpos = np.flatnonzero(pfz == 0)
            need = n_evict - done
            P = int(zpos[need - 1]) + 1 if zpos.size >= need else int(pending.size)
            nz_first = np.argmax(pfz[:P] > 0) if P else 0
            if P and pfz[nz_first] > 0:
                # a recycle exists: its re-arrival bounds the final prefix
                e_first = done + int(np.count_nonzero(pfz[:nz_first] == 0)) + 1
                t_first = np.int64(slack + e_first) * SUB + np.int64(rc)
                P = min(P, int(np.searchsorted(ptime, t_first)))
            chunk, chunk_f = pending[:P], pfz[:P]
            ev_mask = chunk_f == 0
            evicted_parts.append(chunk[ev_mask])
            nz = np.flatnonzero(~ev_mask)
            done_before = done
            done += int(np.count_nonzero(ev_mask))
            if nz.size:
                recs = chunk[nz]
                recycled_parts.append(recs)
                czero = np.cumsum(ev_mask)
                e_idx = done_before + czero[nz] + 1   # in-progress eviction ids
                rec_time = ((slack + e_idx) * SUB
                            + (rc + np.arange(nz.size, dtype=np.int64)))
                rc += int(nz.size)
                na, nb = int(pending.size) - P, int(nz.size)
                ia = np.arange(na) + np.searchsorted(rec_time, ptime[P:])
                ib = np.arange(nb) + np.searchsorted(ptime[P:], rec_time)
                merged = np.empty(na + nb, dtype=np.int64)
                merged_t = np.empty(na + nb, dtype=np.int64)
                merged_f = np.empty(na + nb, dtype=np.int64)
                merged[ia], merged[ib] = pending[P:], recs
                merged_t[ia], merged_t[ib] = ptime[P:], rec_time
                merged_f[ia], merged_f[ib] = pfz[P:], chunk_f[nz] - 1
                pending, ptime, pfz = merged, merged_t, merged_f
            else:
                pending, ptime, pfz = pending[P:], ptime[P:], pfz[P:]
        evicted = (np.concatenate(evicted_parts) if evicted_parts
                   else pending[:0])
        recycled = (np.concatenate(recycled_parts) if recycled_parts
                    else pending[:0])
        return evicted, pending, recycled

    def _commit_bulk(self, keys: np.ndarray, d: np.ndarray, plan: dict) -> None:
        self.in_ghost[keys[d]] = False               # ghost hits leave the queue
        old_live = self._ghost_q[self.in_ghost[self._ghost_q]] \
            if plan["n_ghost_hits"] else self._ghost_q
        ghost_seq = np.concatenate([old_live, plan["g_app"]])
        n_pop = plan["n_pop"]
        new_ghost = ghost_seq[n_pop:]
        # popped first, survivors last: a flipped key re-ghosted in the same
        # batch appears twice in ghost_seq (popped old entry + new append) and
        # must end up live in the bitmap
        if n_pop:
            self.in_ghost[ghost_seq[:n_pop]] = False
        self.in_ghost[new_ghost] = True

        self.where[plan["fresh"]] = 1
        self.where[plan["app_keys"]] = 2
        self.where[plan["small_ghosted"]] = 0
        self.where[plan["main_evicted"]] = 0
        self.freq[keys] = 0
        self.freq[plan["app_keys"]] = 0
        if plan["recycled"].size:
            # a key may be recycled more than once across drain chunks
            np.subtract.at(self.freq, plan["recycled"], 1)
        self._small_q = plan["new_small"]
        self._main_q = plan["new_main"]
        self._ghost_q = new_ghost
        self._ghost_rank[new_ghost] = np.arange(new_ghost.size)
        self.stats.admitted += int(keys.size)
        self.stats.ghost_promotions += plan["n_ghost_hits"]
        self.stats.evicted += (int(plan["small_ghosted"].size)
                               + int(plan["main_evicted"].size))
        self.bulk_batches += 1

    def _insert_batch_seq(self, keys: np.ndarray) -> None:
        """Exact order-dependent corner: replay through the reference S3-FIFO
        (shares this cache's stats object) and rebuild the array state."""
        self.fallback_batches += 1
        self.fallback_inserts += int(keys.size)
        ref = S3FIFOCache.__new__(S3FIFOCache)
        ref.capacity, ref.small_cap = self.capacity, self.small_cap
        ref.main_cap, ref.ghost_cap = self.main_cap, self.ghost_cap
        ref.small = OrderedDict((int(k), int(self.freq[k])) for k in self._small_q)
        ref.main = OrderedDict((int(k), int(self.freq[k])) for k in self._main_q)
        ref.ghost = OrderedDict((int(k), None) for k in self._ghost_q)
        ref.stats = self.stats
        for k in keys.tolist():
            ref.insert(k)
        self._load_from_reference(ref)

    def _load_from_reference(self, ref: S3FIFOCache) -> None:
        self.where[self._small_q] = 0
        self.where[self._main_q] = 0
        self.in_ghost[self._ghost_q] = False
        self._small_q = np.fromiter(ref.small.keys(), np.int64, len(ref.small))
        self._main_q = np.fromiter(ref.main.keys(), np.int64, len(ref.main))
        self._ghost_q = np.fromiter(ref.ghost.keys(), np.int64, len(ref.ghost))
        self.where[self._small_q] = 1
        self.where[self._main_q] = 2
        self.freq[self._small_q] = np.fromiter(ref.small.values(), np.int64,
                                               len(ref.small))
        self.freq[self._main_q] = np.fromiter(ref.main.values(), np.int64,
                                              len(ref.main))
        self.in_ghost[self._ghost_q] = True
        self._ghost_rank[self._ghost_q] = np.arange(self._ghost_q.size)

    # -- debug / equivalence views ------------------------------------------
    def queues(self) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]], List[int]]:
        """(small [(key, freq)], main [(key, freq)], ghost [key]) in FIFO order."""
        small = [(int(k), int(self.freq[k])) for k in self._small_q]
        main = [(int(k), int(self.freq[k])) for k in self._main_q]
        return small, main, [int(k) for k in self._ghost_q]


class ArrayLinkingAlignedCache:
    """Array-native S3-FIFO + linking-aligned admission (the hot-path default).

    Same policy and same decisions as `LinkingAlignedCache`, with the three
    per-neuron hot loops vectorized end-to-end:

      * probe      — one fancy-index over the residency bitmap;
      * classify   — run breaks via `collapse.run_bounds_from_sorted`;
      * sampling   — one `stable_uniform_array` call over segment members,
                     keyed on the same (salt, tick, id) triples as the
                     reference so admission decisions match bit for bit.

    Requires the key space size (`n_keys` = neurons in the FFN block) so
    residency can live in dense arrays.
    """

    def __init__(
        self,
        capacity: int,
        n_keys: int,
        segment_min_len: int = 4,
        segment_admit_p: float = 0.25,
        linking_aligned: bool = True,
        salt: int = 0,
    ) -> None:
        self.cache = ArrayS3FIFOCache(capacity, n_keys)
        self.segment_min_len = segment_min_len
        self.segment_admit_p = segment_admit_p
        self.linking_aligned = linking_aligned
        self.salt = salt
        self._tick = 0

    @property
    def stats(self) -> CacheStats:
        return self.cache.stats

    @property
    def loop_counters(self) -> LoopCounters:
        """Hot per-neuron loop counters stay zero by construction; only the
        exact-replay fallback (per admit batch, not per neuron) is counted."""
        return LoopCounters(probe=0, classify=0, sample=0,
                            fallback_batches=self.cache.fallback_batches,
                            fallback_inserts=self.cache.fallback_inserts)

    def lookup_mask(self, ids: np.ndarray) -> np.ndarray:
        return self.cache.access_batch(ids)

    def peek_mask(self, ids: np.ndarray) -> np.ndarray:
        """Side-effect-free residency probe (see `LinkingAlignedCache.peek_mask`):
        one fancy-index over the bitmap, no stats/frequency mutation."""
        ids = np.asarray(ids, dtype=np.int64)
        if ids.size == 0:
            return np.zeros(0, dtype=bool)
        return self.cache.where[ids] > 0

    def lookup(self, ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.asarray(ids, dtype=np.int64)
        hit_mask = self.lookup_mask(ids)
        return ids[hit_mask], ids[~hit_mask]

    def _classify_arrays(self, miss_ids: np.ndarray,
                         physical: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(ids in physical order, segment-member mask) — fully vectorized."""
        miss_ids = np.asarray(miss_ids, dtype=np.int64)
        physical = np.asarray(physical, dtype=np.int64)
        order = np.argsort(physical)
        phys_sorted = physical[order]
        ids_sorted = miss_ids[order]
        starts, ends = run_bounds_from_sorted(phys_sorted)
        lengths = ends - starts + 1               # ids per run (positions unique)
        seg_mask = np.repeat(lengths >= self.segment_min_len, lengths)
        return ids_sorted, seg_mask

    def classify(self, miss_ids: np.ndarray, physical: np.ndarray) -> Tuple[Set[int], Set[int]]:
        ids_sorted, seg_mask = self._classify_arrays(miss_ids, physical)
        return set(ids_sorted[~seg_mask].tolist()), set(ids_sorted[seg_mask].tolist())

    def admit(self, miss_ids: np.ndarray, physical: np.ndarray) -> None:
        miss_ids = np.asarray(miss_ids, dtype=np.int64)
        if miss_ids.size == 0:
            return
        self._tick += 1
        if not self.linking_aligned:
            self.cache.insert_batch(miss_ids)
            return
        ids_sorted, seg_mask = self._classify_arrays(miss_ids, physical)
        segment = ids_sorted[seg_mask]
        if segment.size:
            u = stable_uniform_array(self.salt, self._tick, segment)
            keep = u < self.segment_admit_p
            self.stats.rejected += int(np.count_nonzero(~keep))
            admitted_segment = segment[keep]
        else:
            admitted_segment = segment
        # sporadic + sampled segment members are disjoint subsets of this
        # step's (unique) misses — skip the duplicate guard
        self.cache.insert_batch(
            np.concatenate([ids_sorted[~seg_mask], admitted_segment]),
            assume_unique=True)

    def resident_ids(self) -> np.ndarray:
        return np.flatnonzero(self.cache.where > 0).astype(np.int64)


def make_linking_aligned_cache(
    capacity: int,
    n_keys: int,
    segment_min_len: int = 4,
    segment_admit_p: float = 0.25,
    linking_aligned: bool = True,
    salt: int = 0,
    impl: str = "array",
):
    """Factory over the two decision-identical implementations."""
    if impl == "array":
        return ArrayLinkingAlignedCache(
            capacity, n_keys, segment_min_len=segment_min_len,
            segment_admit_p=segment_admit_p, linking_aligned=linking_aligned,
            salt=salt)
    if impl == "dict":
        return LinkingAlignedCache(
            capacity, segment_min_len=segment_min_len,
            segment_admit_p=segment_admit_p, linking_aligned=linking_aligned,
            salt=salt)
    raise ValueError(f"unknown cache impl {impl!r} (want 'array' or 'dict')")
