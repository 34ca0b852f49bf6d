"""Paged KV cache: the page-table memory manager behind the serving engine.

The dense decode cache pins ``cache_len`` KV lines per slot for a request's
whole lifetime — a short request strands HBM exactly the way an idle node
strands a SLURM partition.  Paging (vLLM's PagedAttention) breaks the cache
into fixed-size *pages* drawn from one device-resident pool:

* **pool** — ``(n_groups, num_pages, page_size, K, Dh)`` per attention
  sublayer, allocated once (``models.attention.init_kv_cache(paging=...)``);
* **page table** — per-slot ``(pages_per_seq,)`` int32 mapping logical page
  ``j`` (KV lines ``[j*page_size, (j+1)*page_size)``) to a physical page in
  the pool, shared by every layer/group (each layer has its own pool but
  the same logical allocation);
* **allocator** (this module, host-side) — free-list with all-or-nothing
  grants, on-demand growth at decode-time page boundaries, and
  eviction-aware reclaim (the engine frees a preempted victim's pages back
  here before retrying a blocked allocation).

Physical page 0 is the **null page**: never granted, it backs unallocated
page-table entries so frozen/dead slots have a harmless in-bounds write
target inside jitted decode chunks.  Its contents are garbage by design
and are always masked out of attention.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

#: physical page id backing every unallocated page-table entry
NULL_PAGE = 0


def pages_for(tokens: int, page_size: int) -> int:
    """Pages needed to hold ``tokens`` KV lines (ceil division)."""
    return -(-int(tokens) // int(page_size)) if tokens > 0 else 0


@dataclass(frozen=True)
class PagedKVConfig:
    """Shape of one paged cache pool.

    ``num_pages`` counts the null page, so usable capacity is
    ``(num_pages - 1) * page_size`` KV lines.
    """
    page_size: int                 # KV lines per page
    num_pages: int                 # physical pages in the pool (incl. null)
    pages_per_seq: int             # logical pages per request (= page-table width)

    def __post_init__(self):
        assert self.page_size >= 1
        assert self.num_pages >= 2, "pool needs the null page + 1 usable page"
        assert self.pages_per_seq >= 1

    @property
    def usable_pages(self) -> int:
        return self.num_pages - 1

    @property
    def capacity_tokens(self) -> int:
        return self.usable_pages * self.page_size

    @classmethod
    def for_budget(cls, budget_tokens: int, page_size: int,
                   cache_len: int) -> "PagedKVConfig":
        """Pool sized to a dense-equivalent HBM budget of
        ``budget_tokens`` KV lines (plus the null page)."""
        assert cache_len % page_size == 0, (cache_len, page_size)
        return cls(page_size=page_size,
                   num_pages=pages_for(budget_tokens, page_size) + 1,
                   pages_per_seq=cache_len // page_size)


class PageAllocator:
    """Host-side free-list over the physical pages of one pool, with
    per-page reference counts.

    Grants are **all-or-nothing**: a request that needs ``n`` pages either
    gets ``n`` or ``None``, so a half-grown request never wedges the pool.
    Page 0 (the null page) is reserved and never granted.

    Reference counts back prefix sharing (``serving.prefix``): a page
    mapped read-only into several page tables — or pinned by the radix
    index itself — carries one reference per holder.  :meth:`alloc`
    grants pages at refcount 1, :meth:`ref` adds holders, and
    :meth:`free` *decrements*: the page returns to the free list only
    when its last holder lets go, so a shared prefix page outlives any
    single request.  A page is never simultaneously free and referenced
    (asserted; property-tested in ``tests/test_prefix.py``).
    """

    def __init__(self, num_pages: int):
        assert num_pages >= 2, num_pages
        self.num_pages = num_pages
        # LIFO free list: recently-freed pages are re-granted first, which
        # keeps the hot working set of physical pages small
        self._free = list(range(num_pages - 1, NULL_PAGE, -1))
        self._refs = [0] * num_pages
        self._in_use = 0
        self.high_water = 0

    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        """Pages with at least one holder."""
        return self._in_use

    def refcount(self, page: int) -> int:
        return self._refs[page]

    @property
    def total_refs(self) -> int:
        """Sum of refcounts over all pages (= page-table occupancy plus
        index pins; the property tests' conservation quantity)."""
        return sum(self._refs)

    def alloc(self, n: int):
        """Grant ``n`` pages (refcount 1 each) or None (all-or-nothing)."""
        if n <= 0:
            return []
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            assert self._refs[p] == 0, (p, self._refs[p])
            self._refs[p] = 1
        self._in_use += n
        self.high_water = max(self.high_water, self._in_use)
        return pages

    def ref(self, pages):
        """Add one holder to each page (must already be allocated)."""
        for p in pages:
            assert NULL_PAGE < p < self.num_pages, p
            assert self._refs[p] > 0, f"ref on free page {p}"
            self._refs[p] += 1

    def free(self, pages):
        """Drop one holder per page; a page whose last holder leaves
        returns to the pool (idempotence is the caller's job)."""
        for p in pages:
            assert NULL_PAGE < p < self.num_pages, p
            assert self._refs[p] > 0, f"double free of page {p}"
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)
                self._in_use -= 1
        assert self._in_use >= 0, self._in_use


class TwoLevelPageTable:
    """(directory, leaf) two-level logical->physical page map (host side).

    A flat per-slot row is ``pages_per_seq`` int32 wide — growing
    ``cache_len`` to long-context sizes scales every slot's table with
    it even when the slot holds a 30-token chat turn.  Here each slot
    keeps a *directory* (dict: leaf index -> ``leaf_size``-wide int32
    leaf, allocated on first touch), so host memory scales with pages
    actually mapped, not with ``slots * pages_per_seq``.

    Device dispatches still need a dense array; :meth:`dense`
    materializes rows at a caller-chosen width (the engine buckets the
    dispatch width to powers of two and grows it monotonically, so the
    jitted decode programs recompile O(log pages_per_seq) times, not per
    width).  :meth:`max_width` reports the minimal width covering every
    live mapping.
    """

    def __init__(self, num_slots: int, pages_per_seq: int,
                 leaf_size: int = 32):
        assert num_slots >= 1 and pages_per_seq >= 1
        self.num_slots = num_slots
        self.pages_per_seq = pages_per_seq
        self.leaf_size = min(int(leaf_size), pages_per_seq)
        self._dirs: list[dict] = [{} for _ in range(num_slots)]
        #: per-slot logical width = 1 + highest mapped index (0 = empty)
        self._widths = [0] * num_slots

    def _leaf(self, slot: int, li: int) -> np.ndarray:
        leaf = self._dirs[slot].get(li)
        if leaf is None:
            leaf = np.full(self.leaf_size, NULL_PAGE, np.int32)
            self._dirs[slot][li] = leaf
        return leaf

    def clear(self, slot: int):
        """Reset a slot's row to all-NULL (drops its leaves)."""
        self._dirs[slot] = {}
        self._widths[slot] = 0

    def set_range(self, slot: int, start: int, pages):
        """Map logical pages ``[start, start + len(pages))`` to ``pages``."""
        n = len(pages)
        if n == 0:
            return
        assert start >= 0 and start + n <= self.pages_per_seq, \
            (start, n, self.pages_per_seq)
        arr = np.asarray(pages, np.int32)
        i = 0
        while i < n:
            li, off = divmod(start + i, self.leaf_size)
            take = min(self.leaf_size - off, n - i)
            self._leaf(slot, li)[off:off + take] = arr[i:i + take]
            i += take
        self._widths[slot] = max(self._widths[slot], start + n)

    def row(self, slot: int, width: int = None) -> np.ndarray:
        """Dense (width,) int32 row for one slot (default: full width)."""
        width = self.pages_per_seq if width is None else width
        out = np.full(width, NULL_PAGE, np.int32)
        for li, leaf in self._dirs[slot].items():
            lo = li * self.leaf_size
            if lo >= width:
                continue
            take = min(self.leaf_size, width - lo)
            out[lo:lo + take] = leaf[:take]
        return out

    def dense(self, width: int = None) -> np.ndarray:
        """Dense (num_slots, width) materialization (device dispatch /
        test introspection)."""
        width = self.pages_per_seq if width is None else width
        return np.stack([self.row(s, width) for s in
                         range(self.num_slots)])

    def max_width(self) -> int:
        """Smallest dense width covering every live mapping."""
        return max(self._widths, default=0)

    @property
    def directory_leaves(self) -> int:
        """Allocated leaves across all slots (host-memory footprint in
        units of ``leaf_size`` int32 — the two-level win over
        ``num_slots * pages_per_seq``)."""
        return sum(len(d) for d in self._dirs)
