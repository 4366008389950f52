"""Offline neuron-placement search (paper §4.2-4.3, Algorithm 1).

The problem: place neurons on a 1-D flash layout so frequently co-activated
neurons are adjacent — i.e. find the shortest Hamiltonian path on the complete
graph with dist(i, j) = 1 - P(ij). NP-hard (reduces to TSP), so Algorithm 1
greedily merges neuron *links* (paths), nearest endpoints first, using a
priority queue + union-find + per-node neighbour counts.

Two modes:
  * exact  — enumerate all O(n^2) pairs (paper's formulation). Fine to ~8k
    neurons in numpy (the sort dominates).
  * topk   — only the K nearest partners per neuron enter the queue. Pairs with
    P(ij) == 0 all tie at distance 1 and contribute nothing to the objective, so
    dropping them preserves the greedy's choices whenever each neuron has < K
    co-activation partners; leftover path fragments are chained afterwards.
    This keeps the largest paper models (n = 43k) tractable in pure Python.

Complexity: O(E log E) for E queue entries (E = n^2 exact, nK topk) — matching
the paper's O(n^2 log n).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Literal

import numpy as np


class _DSU:
    """Union-find with path compression + union by size."""

    def __init__(self, n: int) -> None:
        self.parent = list(range(n))
        self.size = [1] * n

    def find(self, x: int) -> int:
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a: int, b: int) -> bool:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return False
        if self.size[ra] < self.size[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        self.size[ra] += self.size[rb]
        return True


@dataclasses.dataclass
class PlacementResult:
    placement: np.ndarray          # [n] neuron ids in physical order
    inverse: np.ndarray            # [n] physical position of each neuron id
    edges_used: int
    search_seconds: float
    mode: str

    def physical_of(self, ids: np.ndarray) -> np.ndarray:
        return self.inverse[ids]


def _edge_candidates_exact(dist: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """All i<j pairs sorted by distance. Returns (us, vs) int32 arrays."""
    n = dist.shape[0]
    iu, ju = np.triu_indices(n, k=1)
    order = np.argsort(dist[iu, ju], kind="stable")
    return iu[order].astype(np.int32), ju[order].astype(np.int32)


def _edge_candidates_topk(dist: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-node k nearest partners, deduped and sorted by distance."""
    n = dist.shape[0]
    k = min(k, n - 1)
    nbr = np.argpartition(dist, kth=k - 1, axis=1)[:, :k]          # [n, k]
    us = np.repeat(np.arange(n, dtype=np.int64), k)
    vs = nbr.reshape(-1).astype(np.int64)
    lo, hi = np.minimum(us, vs), np.maximum(us, vs)
    keys = lo * n + hi
    uniq = np.unique(keys)
    lo, hi = (uniq // n).astype(np.int32), (uniq % n).astype(np.int32)
    order = np.argsort(dist[lo, hi], kind="stable")
    return lo[order], hi[order]


def _merge_links_loop(us: np.ndarray, vs: np.ndarray, n: int):
    """Reference greedy (the paper's Algorithm 1 inner loop): one Python
    iteration per candidate edge. Kept as the equivalence oracle for the
    batched implementation below; `search_placement(greedy_impl='loop')`
    routes here."""
    nbr_cnt = np.zeros(n, dtype=np.int8)          # NbrCnt in Algorithm 1
    dsu = _DSU(n)
    acc_u: list[int] = []
    acc_v: list[int] = []
    for u, v in zip(us.tolist(), vs.tolist()):
        if nbr_cnt[u] == 2 or nbr_cnt[v] == 2:    # skip if inside a link
            continue
        if not dsu.union(u, v):                   # would close a cycle
            continue
        nbr_cnt[u] += 1
        nbr_cnt[v] += 1
        acc_u.append(u)
        acc_v.append(v)
        if len(acc_u) == n - 1:
            break
    roots = np.fromiter((dsu.find(i) for i in range(n)), np.int64, n)
    return (np.asarray(acc_u, dtype=np.int64), np.asarray(acc_v, dtype=np.int64),
            nbr_cnt, roots)


def _batch_roots(parent: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """Vectorized union-find root lookup with path compression on `xs`."""
    r = parent[xs]
    while True:
        rr = parent[r]
        if np.array_equal(rr, r):
            break
        r = parent[rr]
    parent[xs] = r
    return r


def _edgewise_first(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per-edge independence mask: True for edge i iff neither a[i] nor b[i]
    occurs in any EARLIER edge (values interleaved in edge order, so edge j
    claims both its slots before edge j+1 claims either)."""
    m = int(a.size)
    inter = np.empty(2 * m, dtype=a.dtype)
    inter[0::2], inter[1::2] = a, b
    first = np.zeros(2 * m, dtype=bool)
    _, idx = np.unique(inter, return_index=True)
    first[idx] = True
    return first[0::2] & first[1::2]


_GREEDY_BATCH = 8192


def _merge_links_batched(us: np.ndarray, vs: np.ndarray, n: int):
    """Array-native greedy link merging, bit-identical to `_merge_links_loop`.

    Candidate edges are processed in numpy batches. Two rejections are FINAL
    regardless of position — a saturated endpoint (degree never decreases)
    and a same-component pair (components never split) — so they are filtered
    with one vectorized pass per batch. Of the survivors, every edge whose
    endpoints AND component roots appear for the first time within the batch
    is independent of all earlier batch edges: the sequential loop would
    accept each one with exactly the state it sees here, so they are applied
    wholesale (degree bump + union-by-size, all disjoint). Dependent edges
    are re-examined on the next inner pass with the updated state — i.e. in
    the same index order the sequential loop would reach them. Each inner
    pass accepts at least one edge, so termination is immediate.
    """
    parent = np.arange(n, dtype=np.int64)
    size = np.ones(n, dtype=np.int64)
    nbr_cnt = np.zeros(n, dtype=np.int8)
    acc_u: list[np.ndarray] = []
    acc_v: list[np.ndarray] = []
    edges_used = 0
    need = n - 1
    for pos in range(0, int(us.size), _GREEDY_BATCH):
        if edges_used >= need:
            break
        bu = us[pos:pos + _GREEDY_BATCH].astype(np.int64)
        bv = vs[pos:pos + _GREEDY_BATCH].astype(np.int64)
        while bu.size and edges_used < need:
            keep = (nbr_cnt[bu] < 2) & (nbr_cnt[bv] < 2)   # final reject
            bu, bv = bu[keep], bv[keep]
            if not bu.size:
                break
            ru = _batch_roots(parent, bu)
            rv = _batch_roots(parent, bv)
            keep = ru != rv                                # final reject (cycle)
            bu, bv, ru, rv = bu[keep], bv[keep], ru[keep], rv[keep]
            if not bu.size:
                break
            indep = _edgewise_first(bu, bv) & _edgewise_first(ru, rv)
            au, av = bu[indep], bv[indep]
            aru, arv = ru[indep], rv[indep]
            if edges_used + au.size > need:                # sequential break
                # The cap can only bind with ONE edge left: k accepted edges
                # have 2k distinct roots, and the component count is exactly
                # (need - edges_used) + 1, so k <= (remaining + 1) / 2 — the
                # cut below therefore always keeps just the batch's first
                # survivor, which is independent by construction, exactly the
                # edge the sequential loop would stop after. No acceptable
                # dependent edge can be skipped by the early exit.
                cut = need - edges_used
                au, av, aru, arv = au[:cut], av[:cut], aru[:cut], arv[:cut]
            if au.size:
                nbr_cnt[au] += 1                           # endpoints disjoint
                nbr_cnt[av] += 1
                swap = size[aru] < size[arv]               # union by size
                ra = np.where(swap, arv, aru)
                rb = np.where(swap, aru, arv)
                parent[rb] = ra                            # roots disjoint
                size[ra] += size[rb]
                acc_u.append(au)
                acc_v.append(av)
                edges_used += int(au.size)
            dep = ~indep
            bu, bv = bu[dep], bv[dep]
    roots = _batch_roots(parent, np.arange(n, dtype=np.int64))
    out_u = (np.concatenate(acc_u) if acc_u else np.zeros(0, dtype=np.int64))
    out_v = (np.concatenate(acc_v) if acc_v else np.zeros(0, dtype=np.int64))
    return out_u, out_v, nbr_cnt, roots


def search_placement(
    dist: np.ndarray,
    mode: Literal["auto", "exact", "topk"] = "auto",
    topk: int = 64,
    greedy_impl: Literal["batched", "loop"] = "batched",
) -> PlacementResult:
    """Algorithm 1: greedy link merging over the co-activation graph.

    The merge loop runs array-native by default (`greedy_impl='batched'`,
    processing candidate edges in numpy batches with a vectorized DSU/degree
    filter); `'loop'` is the per-edge reference implementation, kept for the
    bit-identical equivalence tests and the before/after benchmark.
    """
    t0 = time.perf_counter()
    n = dist.shape[0]
    if n == 0:
        empty = np.zeros(0, dtype=np.int64)
        return PlacementResult(empty, empty.copy(), 0, 0.0, mode)
    if n == 1:
        one = np.zeros(1, dtype=np.int64)
        return PlacementResult(one, one.copy(), 0, 0.0, mode)
    if mode == "auto":
        mode = "exact" if n <= 4096 else "topk"
    if mode == "exact":
        us, vs = _edge_candidates_exact(dist)
    else:
        us, vs = _edge_candidates_topk(dist, topk)

    merge = _merge_links_batched if greedy_impl == "batched" else _merge_links_loop
    acc_u, acc_v, nbr_cnt, roots = merge(us, vs, n)
    edges_used = int(acc_u.size)
    adj = [[] for _ in range(n)]                  # path adjacency (degree <= 2)
    for u, v in zip(acc_u.tolist(), acc_v.tolist()):
        adj[u].append(v)
        adj[v].append(u)

    # Chain any leftover path fragments (topk mode may exhaust candidates).
    if edges_used < n - 1:
        endpoints_by_root: dict[int, list[int]] = {}
        for node in np.flatnonzero(nbr_cnt <= 1).tolist():
            endpoints_by_root.setdefault(int(roots[node]), []).append(node)
        frags = list(endpoints_by_root.values())
        for a, b in zip(frags, frags[1:]):
            u = a[-1] if len(a) > 1 else a[0]      # tail of previous fragment
            v = b[0]
            nbr_cnt[u] += 1
            nbr_cnt[v] += 1
            adj[u].append(v)
            adj[v].append(u)
            edges_used += 1

    # Walk the single remaining path from one endpoint.
    start = next(i for i in range(n) if len(adj[i]) <= 1)
    placement = np.empty(n, dtype=np.int64)
    prev, cur = -1, start
    for pos in range(n):
        placement[pos] = cur
        nxt = -1
        for cand in adj[cur]:
            if cand != prev:
                nxt = cand
                break
        prev, cur = cur, nxt
        if nxt == -1 and pos != n - 1:
            raise AssertionError("placement walk ended early — path is broken")

    inverse = np.empty(n, dtype=np.int64)
    inverse[placement] = np.arange(n)
    return PlacementResult(placement, inverse, edges_used, time.perf_counter() - t0, mode)


# ---------------------------------------------------------------------------
# Baseline placements (evaluation baselines in §6)
# ---------------------------------------------------------------------------

def identity_placement(n: int) -> PlacementResult:
    """Model-structure order — llama.cpp / LLMFlash layout."""
    p = np.arange(n, dtype=np.int64)
    return PlacementResult(p, p.copy(), 0, 0.0, "identity")


def frequency_placement(activation_rate: np.ndarray) -> PlacementResult:
    """Hot-first layout: sort by activation frequency (a natural strawman)."""
    p = np.argsort(-np.asarray(activation_rate), kind="stable").astype(np.int64)
    inv = np.empty_like(p)
    inv[p] = np.arange(len(p))
    return PlacementResult(p, inv, 0, 0.0, "frequency")


def path_length(dist: np.ndarray, placement: np.ndarray) -> float:
    """Total Hamiltonian-path length under dist — the search objective."""
    a, b = placement[:-1], placement[1:]
    return float(dist[a, b].sum())
