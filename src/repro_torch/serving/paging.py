"""Paged KV cache: page pool, page tables, and copy-on-write prefix sharing.

A copy of the reference's host-side bookkeeping (`repro.serving.paging`)
over device arenas. With paging, the `InferenceServer` stops preallocating
one full-`max_len` KV region per decode slot (concurrency bounded by the
WORST-CASE sequence length) and this module owns all KV memory instead:

  * `PagePool` holds the arenas — per attention sublayer, a device tensor of
    physical pages `[num_pages + 1, page_size, KV, hd]` (float, or int8 with
    per-page-row bf16 scales; the trailing null page absorbs inactive-slot
    garbage writes), one dict of them per layer group. ONE set of logical
    pages serves every layer: a page-table entry indexes all layers' arenas
    at once, so allocator accounting is per request, not per layer.
  * a free-list allocator with refcounted pages: LIFO free list
    (deterministic), refcount per page; a page returns to the free list
    exactly when its last reference drops.
  * per-request `PageTable`s grow ONE page at a time during decode
    (`prepare_append`), and every retirement path releases through one choke
    point (`release`).
  * prefix sharing, matched on the raw prompt bytes at admission: the
    PREFIX REGISTRY of full, immutable prompt pages (FIFO eviction under
    pressure, skipping entries whose pages are all pinned), and LIVE-PROMPT
    FORKING of a live request's pages, a partially filled final page
    included, with copy-on-write (`cow_copies`) at the first write into a
    shared page.
  * admission accounting: `plan_admit` prices a candidate's worst-case page
    need and the registry pages it would pin; in strict mode an admitted
    request can always grow to completion, with `overcommit=True` only the
    immediate prompt need is gated (the server preempts when the pool runs
    dry).

Everything here is host-side numpy/python bookkeeping, decision for
decision the reference's. The device work is in-place page copies (prompt
writes, one scatter a cache leaf; CoW) into the arenas, which the decode
step then indexes through `[B, max_pages]` page-table arrays
(`models/kvcache.py` paged writes + `kernels/ops.paged_decode_attention`). Declared divergence: the port
decodes resident and offload through one Python layer loop, so the pool
holds a single list of per-group arenas (`cache_groups`) and the
reference's `layout=` argument has no counterpart.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer
from repro_torch.models.kvcache import SWACache
from repro_torch.obs import get_tracer


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass
class PagePoolStats:
    """Lifetime counters (mirrored into `ServerStats` by the server)."""
    pages_allocated: int = 0       # every successful page allocation
    pages_freed: int = 0           # refcount reached zero, page back on the list
    pages_shared: int = 0          # pages mapped shared at admission (prefix hits)
    prefix_hits: int = 0           # admissions that matched a shared prefix
    cow_copies: int = 0            # copy-on-write page copies (divergence)
    prefix_evictions: int = 0      # registry entries dropped under pressure
    peak_page_occupancy: int = 0   # max pages simultaneously referenced


@dataclasses.dataclass
class AdmitPlan:
    """Priced admission for one candidate prompt (nothing allocated yet)."""
    shared_len: int         # matched prefix length in tokens (0 = no match)
    n_shared: int           # pages mapped shared (incl. a partial final page)
    shared_full: int        # full shared pages — never written again, ever
    new_now: int            # pages allocated during admission itself
    budget: int             # worst-case lifetime allocations for this request
    extra_parent: int       # +1 when forking a live partial page (parent may CoW)
    # shared pages currently held ONLY by the registry: admitting pins them
    # (incref), which removes them from the evictable set — they must be
    # priced as consumed availability or the gate over-admits
    n_shared_evictable: int = 0
    parent: Optional["PageTable"] = None   # live fork source, if any
    shared_pages: Tuple[int, ...] = ()

    @property
    def worst_case(self) -> int:
        return self.budget + self.extra_parent


class PageTable:
    """One request's logical-to-physical page mapping."""
    __slots__ = ("uid", "pages", "length", "prompt_len", "budget",
                 "allocated", "prompt_key", "released")

    def __init__(self, uid: int, prompt_len: int, budget: int,
                 prompt_key: bytes):
        self.uid = uid
        self.pages: List[int] = []
        self.length = 0            # KV rows written (prompt + generated)
        self.prompt_len = prompt_len
        self.budget = budget       # worst-case allocations (commit accounting)
        self.allocated = 0         # allocations so far (<= budget, strict mode)
        self.prompt_key = prompt_key
        self.released = False

    @property
    def n_pages(self) -> int:
        return len(self.pages)


def _arenas(group: Dict[str, Any]) -> List[Tuple[str, Any]]:
    """A group's (sublayer, arena) pairs, without the rings a server keeps
    beside them."""
    return [(sub, c) for sub, c in group.items()
            if not isinstance(c, SWACache)]


class PagePool:
    """Owner of all paged KV memory: arenas + allocator + prefix sharing.

    `cache_groups` is a list of G per-group dicts `{sub_j: arena}` on
    `device` (default cuda; pass "cpu" to run on the CPU), the layout the
    port's decode loop takes. A server whose stack has "window" layers
    (`cfg.attn_layout`) adds their rings, `SWACache` rows a slot, to these
    dicts; the pool writes and copies its arenas only.

    Construction raises `ValueError` — never silently degrades — for layouts
    pages cannot represent: non-attention sublayers (SSM state is per-slot,
    not positional) and stacks windowed everywhere are rejected by
    `init_paged_stack_cache`, `swa` rings by the server; the int8 layout is
    fully supported (per-page-row scales ride in the arenas). A stack with
    some "window" layers has arenas for the others only.
    """

    def __init__(self, cfg: ModelConfig, *, num_pages: int, page_size: int,
                 max_len: int, overcommit: bool = False, dtype=None,
                 device: DeviceLike = None):
        if max_len < 1:
            raise ValueError("max_len must be >= 1")
        self.device = resolve_device(device)
        # init_paged_stack_cache validates num_pages/page_size/layer kinds and
        # picks the float vs int8 arena from cfg.kv_quant
        self.cache_groups = transformer.init_paged_stack_cache(
            cfg, num_pages, page_size, self.device, dtype=dtype)
        self.cfg = cfg
        self.num_pages = num_pages
        self.page_size = page_size
        self.null_page = num_pages           # arena row reserved for garbage
        self.max_len = max_len
        self.max_pages_per_seq = cdiv(max_len, page_size)
        self.overcommit = overcommit
        self.quant = bool(cfg.kv_quant)
        # -- allocator state --------------------------------------------------
        self._refc = np.zeros(num_pages, dtype=np.int64)
        self._free: List[int] = list(range(num_pages - 1, -1, -1))  # pop() -> 0
        # -- prefix sharing ---------------------------------------------------
        self._registry: "OrderedDict[bytes, Tuple[int, Tuple[int, ...]]]" = \
            OrderedDict()
        self._registry_refc = np.zeros(num_pages, dtype=np.int64)
        self._live_prompts: Dict[bytes, PageTable] = {}
        self._active: List[PageTable] = []
        self.stats = PagePoolStats()

    # -- allocator ------------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_live(self) -> int:
        return self.num_pages - len(self._free)

    def n_evictable(self) -> int:
        """Pages held ONLY by the prefix registry — freeable on demand."""
        return int(np.sum((self._refc > 0)
                          & (self._refc == self._registry_refc)))

    def _evictable_entry_key(self) -> Tuple[Optional[bytes], int]:
        """Oldest (FIFO) registry entry holding at least one registry-only
        page, and the number of entries walked to find it. Evicting such
        entries makes progress toward a free page (each eviction strictly
        reduces total registry refs, and a registry-only page's refs are ALL
        registry refs); entries whose pages are all pinned by live tables
        would free nothing and are skipped — evicting them only throws away
        future sharing."""
        scanned = 0
        for key, (_, pages) in self._registry.items():
            scanned += 1
            if any(self._refc[p] == self._registry_refc[p] for p in pages):
                return key, scanned
        return None, scanned

    def _alloc_page(self) -> Optional[int]:
        """Pop a free page, evicting registry prefixes FIFO if the list is
        dry — skipping entries that cannot free a page, and stopping once no
        remaining entry can. None means genuinely out of memory (caller
        preempts/defers)."""
        if not self._free:
            with get_tracer().span("evict") as sp:
                entries = scanned = 0
                while not self._free:
                    key, walked = self._evictable_entry_key()
                    scanned += walked
                    if key is None:
                        break
                    self._evict_one_prefix(key)
                    entries += 1
                sp.set(entries=entries, scanned=scanned)
            if not self._free:
                return None
        p = self._free.pop()
        assert self._refc[p] == 0, f"page {p} on free list with refc>0"
        self._refc[p] = 1
        self.stats.pages_allocated += 1
        self.stats.peak_page_occupancy = max(self.stats.peak_page_occupancy,
                                             self.n_live)
        return p

    def _incref(self, p: int) -> None:
        assert self._refc[p] > 0, f"incref on free page {p}"
        self._refc[p] += 1

    def _decref(self, p: int) -> None:
        assert self._refc[p] > 0, f"decref on free page {p}"
        self._refc[p] -= 1
        if self._refc[p] == 0:
            self._free.append(p)
            self.stats.pages_freed += 1

    def check(self) -> None:
        """Allocator invariants (the property tests drive this after every
        operation): refcounts conserve, the free list is duplicate-free and
        disjoint from live pages, registry refs never exceed total refs."""
        free = self._free
        assert len(set(free)) == len(free), "duplicate pages on the free list"
        assert all(self._refc[p] == 0 for p in free), \
            "live page on the free list"
        n_live = int(np.sum(self._refc > 0))
        assert n_live + len(free) == self.num_pages, \
            f"page conservation violated: {n_live} live + {len(free)} free " \
            f"!= {self.num_pages}"
        assert np.all(self._registry_refc <= self._refc), \
            "registry holds refs on pages it does not reference"
        assert np.all(self._refc >= 0)

    # -- admission ------------------------------------------------------------
    def _match_registry(self, prompt: np.ndarray) -> Tuple[int, Tuple[int, ...]]:
        """Longest registered page-aligned prefix of `prompt` (exact bytes)."""
        T = len(prompt)
        P = self.page_size
        for L in range((T // P) * P, 0, -P):
            hit = self._registry.get(prompt[:L].tobytes())
            if hit is not None:
                return hit
        return 0, ()

    def _match_live(self, prompt: np.ndarray) -> Tuple[int, Optional[PageTable]]:
        """Longest live request whose FULL prompt is a byte-prefix of
        `prompt` (the copy-on-write fork source)."""
        T = len(prompt)
        best_len, best = 0, None
        for key, table in self._live_prompts.items():
            L = table.prompt_len
            if L <= best_len or L > T or table.length < L or table.released:
                continue
            if prompt[:L].tobytes() == key:
                best_len, best = L, table
        return best_len, best

    def plan_admit(self, prompt: np.ndarray, max_new_tokens: int) -> AdmitPlan:
        """Price an admission without touching allocator state."""
        prompt = np.asarray(prompt, dtype=np.int32)
        T = len(prompt)
        P = self.page_size
        L_reg, reg_pages = self._match_registry(prompt)
        L_live, parent = self._match_live(prompt)
        if L_live > L_reg:
            L, shared = L_live, tuple(parent.pages[:cdiv(L_live, P)])
        else:
            L, shared, parent = L_reg, reg_pages, None
        partial = L % P != 0
        n_shared = len(shared)
        shared_full = L // P
        total_prompt_pages = cdiv(T, P)
        # a shared partial page is CoW-replaced the moment this request writes
        # into it: immediately if the prompt extends past L, else on the first
        # decode append
        new_now = total_prompt_pages - n_shared + (1 if partial and T > L else 0)
        budget = cdiv(T + max_new_tokens, P) - shared_full
        n_shared_evictable = sum(
            1 for p in shared if self._refc[p] == self._registry_refc[p])
        return AdmitPlan(shared_len=L, n_shared=n_shared,
                         shared_full=shared_full, new_now=new_now,
                         budget=budget, extra_parent=1 if partial else 0,
                         n_shared_evictable=n_shared_evictable,
                         parent=parent, shared_pages=shared)

    def committed_outstanding(self) -> int:
        """Pages the pool has promised active tables but not yet handed out."""
        return sum(max(t.budget - t.allocated, 0) for t in self._active
                   if not t.released)

    def can_admit(self, plan: AdmitPlan) -> bool:
        """Strict mode reserves the candidate's worst case against everyone
        else's outstanding commitments (admitted => can always finish);
        overcommit gates only the immediate prompt need.

        Shared pages currently held only by the registry stop being
        evictable the instant this candidate pins them (incref), so they are
        subtracted from availability up front — otherwise the gate approves
        admissions the allocator cannot serve, and in strict mode the pinned
        pages would silently invalidate the worst-case reservations already
        promised to active requests."""
        available = (self.n_free + self.n_evictable()
                     - plan.n_shared_evictable)
        if self.overcommit:
            return plan.new_now <= available
        return plan.worst_case <= available - self.committed_outstanding()

    def admit(self, prompt: np.ndarray, max_new_tokens: int, uid: int
              ) -> Tuple[Optional[PageTable], AdmitPlan]:
        """Build a page table for `prompt`: map the matched shared prefix,
        CoW-replace a shared partial page the prompt extends past, allocate
        the rest. Returns (None, plan) only when the pool is dry mid-admission
        (possible in overcommit mode); every partial allocation is rolled
        back, so a failed admit leaves no residue."""
        prompt = np.asarray(prompt, dtype=np.int32)
        T = len(prompt)
        P = self.page_size
        plan = self.plan_admit(prompt, max_new_tokens)
        table = PageTable(uid=uid, prompt_len=T, budget=plan.budget,
                          prompt_key=prompt.tobytes())
        for p in plan.shared_pages:
            self._incref(p)
            table.pages.append(p)
        if plan.shared_len > 0:
            self.stats.prefix_hits += 1
            self.stats.pages_shared += plan.n_shared
        partial_idx = plan.shared_len // P if plan.shared_len % P else -1
        if partial_idx >= 0 and T > plan.shared_len:
            # the prompt extends into the shared partial page: diverge NOW
            if not self._cow(table, partial_idx):
                self._rollback(table)
                return None, plan
        for _ in range(len(table.pages), cdiv(T, P)):
            p = self._alloc_page()
            if p is None:
                self._rollback(table)
                return None, plan
            table.pages.append(p)
            table.allocated += 1
        table.length = T
        if plan.parent is not None and plan.extra_parent:
            # charge the parent's possible CoW only once the admit is final —
            # a rolled-back admit must leave the parent's commitment intact
            plan.parent.budget += plan.extra_parent
        self._active.append(table)
        self._live_prompts.setdefault(table.prompt_key, table)
        return table, plan

    def _rollback(self, table: PageTable) -> None:
        for p in table.pages:
            self._decref(p)
        table.pages.clear()

    # -- arena mutation (in place) -----------------------------------------------
    def _copy_page(self, src: int, dst: int) -> None:
        """Copy one physical page across every layer's arena (CoW)."""
        for group in self.cache_groups:
            for _, arena in _arenas(group):
                for leaf in arena:
                    leaf[dst].copy_(leaf[src])

    def _cow(self, table: PageTable, page_idx: int) -> bool:
        """Replace table.pages[page_idx] with a private copy (the page is
        shared — refcount > 1). Sharers and the registry keep the original."""
        src = table.pages[page_idx]
        dst = self._alloc_page()
        if dst is None:
            return False
        self._copy_page(src, dst)
        self._decref(src)
        table.pages[page_idx] = dst
        table.allocated += 1
        get_tracer().instant("cow_copy", uid=table.uid, src=src, dst=dst)
        self.stats.cow_copies += 1
        return True

    def write_prompt(self, table: PageTable, small_cache: Any) -> None:
        """Block-copy a freshly prefilled B=1 contiguous cache into the
        request's pages, in place, skipping pages mapped shared (their bytes
        are identical by construction — same prompt prefix, same
        deterministic prefill). `small_cache` is the per-group list of
        `{sub_j: KVCache|QuantKVCache [1, S, KV, hd]}` that
        `Model.init_cache(1, ...)` produced.

        Each cache leaf takes one `index_copy_` of all its owned full pages
        (the prompt's rows viewed as [n, page_size, ...] pages) and, when
        the prompt ends inside a page, one copy of the tail's rows alone:
        rows past the prompt keep their bytes, as in the reference. The
        span's `launches` counts those copies, at most two a leaf."""
        T = table.prompt_len
        P = self.page_size
        n_pages = cdiv(T, P)
        n_full = T // P
        with get_tracer().span("write_prompt", uid=table.uid) as sp:
            # first page this request owns (refcount 1): shared full pages
            # and a still-shared partial page (exact-match fork) must not be
            # written
            first = 0
            while first < n_pages and self._refc[table.pages[first]] > 1:
                first += 1
            n = max(n_full - first, 0)
            idx = torch.as_tensor(table.pages[first:first + n],
                                  dtype=torch.int64, device=self.device)
            tail = table.pages[n_full] if first <= n_full < n_pages else None
            launches = 0
            for group, small_group in zip(self.cache_groups, small_cache):
                for sub, arena in _arenas(group):
                    for leaf, s in zip(arena, small_group[sub]):
                        rows = s[0, first * P:T]
                        if rows.dtype != leaf.dtype:
                            rows = rows.to(leaf.dtype)
                        if n:
                            leaf.index_copy_(0, idx, rows[:n * P].view(
                                n, P, *leaf.shape[2:]))
                            launches += 1
                        if tail is not None:
                            leaf[tail, :T - n_full * P].copy_(rows[n * P:])
                            launches += 1
            sp.set(pages=n_pages - first, launches=launches)

    def register_prefixes(self, prompt: np.ndarray, table: PageTable) -> None:
        """Register every page-aligned prefix of a just-written prompt in the
        prefix registry (full pages only — registered pages are immutable, so
        later sharers never force a copy). Entries hold their own refs and
        outlive the request; `clear_prefix_cache` / FIFO eviction releases
        them."""
        prompt = np.asarray(prompt, dtype=np.int32)
        P = self.page_size
        with get_tracer().span("register_prefixes", uid=table.uid) as sp:
            entries = increfs = 0
            for L in range(P, len(prompt) + 1, P):
                key = prompt[:L].tobytes()
                if key in self._registry:
                    continue
                pages = tuple(table.pages[:L // P])
                for p in pages:
                    self._incref(p)
                    self._registry_refc[p] += 1
                self._registry[key] = (L, pages)
                entries += 1
                increfs += len(pages)
            sp.set(entries=entries, increfs=increfs)

    # -- decode growth ---------------------------------------------------------
    def prepare_append(self, table: PageTable, position: int) -> bool:
        """Make `position` writable for this request before the decode step:
        grow the table by one page at a page boundary, CoW a shared page at a
        divergence point. False = pool dry even after prefix eviction (the
        server's page-pressure hook preempts and retries)."""
        idx = position // self.page_size
        if idx >= len(table.pages):
            assert idx == len(table.pages), \
                "page tables grow one page at a time"
            p = self._alloc_page()
            if p is None:
                return False
            table.pages.append(p)
            table.allocated += 1
        elif self._refc[table.pages[idx]] > 1:
            if not self._cow(table, idx):
                return False
        table.length = max(table.length, position + 1)
        return True

    def page_table_row(self, table: Optional[PageTable],
                       out: np.ndarray) -> None:
        """Fill one row of the [B, max_pages] page-table array (null-page
        padded; a None table — free slot — stays all-null)."""
        out[:] = self.null_page
        if table is not None:
            out[:len(table.pages)] = table.pages

    # -- reclamation -----------------------------------------------------------
    def release(self, table: PageTable) -> None:
        """Drop every reference a retired request holds. Idempotent; shared
        pages survive through their other holders (registry included)."""
        if table.released:
            return
        table.released = True
        for p in table.pages:
            self._decref(p)
        table.pages.clear()
        if table in self._active:
            self._active.remove(table)
        if self._live_prompts.get(table.prompt_key) is table:
            del self._live_prompts[table.prompt_key]
            # a still-live duplicate of the same prompt is just as good a
            # fork source — re-point instead of losing the sharing
            for t in self._active:
                if t.prompt_key == table.prompt_key:
                    self._live_prompts[table.prompt_key] = t
                    break

    def _evict_one_prefix(self, key: Optional[bytes] = None) -> None:
        if key is None:
            key, (_, pages) = self._registry.popitem(last=False)   # FIFO
        else:
            _, pages = self._registry.pop(key)
        for p in pages:
            self._registry_refc[p] -= 1
            self._decref(p)
        get_tracer().instant("prefix_evict", n_pages=len(pages))
        self.stats.prefix_evictions += 1

    def clear_prefix_cache(self) -> int:
        """Release every registry entry (end-of-run reclamation; the property
        tests assert the free list is full afterwards)."""
        n = len(self._registry)
        while self._registry:
            self._evict_one_prefix()
        return n

    def summary(self) -> Dict[str, Any]:
        """io_summary-style reporting surface (launch/serve.py prints it)."""
        s = self.stats
        return {
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "kv_positions": self.num_pages * self.page_size,
            "quantized": self.quant,
            "overcommit": self.overcommit,
            "n_free": self.n_free,
            "n_live": self.n_live,
            "registry_entries": len(self._registry),
            "pages_allocated": s.pages_allocated,
            "pages_freed": s.pages_freed,
            "pages_shared": s.pages_shared,
            "prefix_hits": s.prefix_hits,
            "cow_copies": s.cow_copies,
            "prefix_evictions": s.prefix_evictions,
            "peak_page_occupancy": s.peak_page_occupancy,
        }
