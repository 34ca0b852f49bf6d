"""Radix-style prefix cache over the paged KV pool (SGLang-inspired).

In multi-tenant serving most requests share long prompt prefixes — chat
templates, few-shot headers, system prompts — and without reuse the
engine re-runs prefill and allocates fresh pages for every one of them.
The page table (``models.paging``) makes sharing natural: KV lines for a
token block at a fixed position range are *identical* across requests
whose prompts agree up to that block, so the same physical page can back
all of them read-only.

This module is the host-side index that makes the match:

* **radix trie at page granularity** — each node is one *complete* page
  of ``page_size`` prompt tokens, keyed by the token tuple and rooted at
  position 0, so node depth implies absolute position range (RoPE bakes
  positions into the cached K lines — a block is only reusable at the
  depth it was computed);
* **longest-prefix match** — :meth:`PrefixCache.match` walks the trie
  and returns the chain of cached nodes covering the request's prompt,
  capped at ``(len(tokens) - 1) // page_size`` pages: the final token is
  always prefilled so there are logits to sample the first output from;
* **copy-on-write fork** — a request maps the matched pages read-only
  (one allocator reference each, via :meth:`acquire`) and allocates
  private pages from the first divergent page onward; decode writes only
  land at positions past the shared region, so the "copy" never actually
  happens — divergence just stops the sharing;
* **refcount lifetime** — the index itself holds one reference on every
  cached page (taken at :meth:`insert`), so pages survive their
  producing request.  :meth:`evict` is the capacity-pressure valve: LRU
  leaves whose pages have no holder but the index are released back to
  the free pool (the engine tries this before its scavenger-preemption
  reclaim path fires).

Nothing here touches the device: the engine scatters/gathers through
page tables; this class only decides which physical pages mean what.
Tensor parallelism keeps it that way — a sharded pool stores ``1/tp``
of every page's KV heads per device, but page *ids* remain one logical
space, so matching, refcounts, COW forks, and eviction run unchanged
whatever the mesh looks like (the JAX package's ``serving/tp.py``).
"""
from __future__ import annotations

import itertools

from repro_torch.models.paging import NULL_PAGE, PageAllocator


class RadixNode:
    """One cached page: ``page_size`` prompt tokens at depth-implied
    positions, backed by physical ``page``.  ``generated`` marks a page
    whose tokens include model *output* (indexed at request finish
    rather than admission) — lifetime and sharing are identical, the
    flag only feeds the prompt/generated hit split."""
    __slots__ = ("block", "page", "parent", "children", "last_used",
                 "generated")

    def __init__(self, block: tuple, page: int, parent,
                 generated: bool = False):
        self.block = block
        self.page = page
        self.parent = parent
        self.children: dict = {}
        self.last_used = 0
        self.generated = generated


class PrefixCache:
    """Host-side radix index mapping prompt token blocks to pool pages."""

    def __init__(self, allocator: PageAllocator, page_size: int):
        assert page_size >= 1
        self.allocator = allocator
        self.page_size = page_size
        self.root = RadixNode((), NULL_PAGE, None)
        self.nodes = 0                  # cached pages currently indexed
        self.prompt_hits = 0            # acquired pages by provenance
        self.generated_hits = 0
        self._clock = itertools.count(1)

    # ------------------------------------------------------------- match ----
    def _blocks(self, tokens, n: int) -> list:
        ps = self.page_size
        return [tuple(int(t) for t in tokens[j * ps:(j + 1) * ps])
                for j in range(n)]

    def match(self, tokens) -> list:
        """Longest cached chain of complete-page blocks covering a strict
        prefix of ``tokens`` (read-only: no refs taken, no LRU bump).
        At most ``(len - 1) // page_size`` pages match, so at least the
        last token always prefills."""
        limit = max(len(tokens) - 1, 0) // self.page_size
        node, out = self.root, []
        for blk in self._blocks(tokens, limit):
            node = node.children.get(blk)
            if node is None:
                break
            out.append(node)
        return out

    def acquire(self, nodes) -> list:
        """Pin a matched chain for an admitted request: one allocator
        reference per page (released with the request's other pages via
        ``allocator.free``) and an LRU recency bump."""
        now = next(self._clock)
        pages = []
        for n in nodes:
            n.last_used = now
            pages.append(n.page)
            if n.generated:
                self.generated_hits += 1
            else:
                self.prompt_hits += 1
        self.allocator.ref(pages)
        return pages

    # ------------------------------------------------------------ insert ----
    def insert(self, tokens, pages, generated_from=None) -> int:
        """Register the complete-page blocks of ``tokens`` (physical
        ``pages``, logical order).  Blocks already indexed — a request's
        matched chain, or a concurrent twin's insert — are kept as-is
        (first wins); each newly indexed page takes an index-owned
        allocator reference so it outlives the request.  A node whose
        block extends past token index ``generated_from`` (the prompt
        length, when inserting a finished request's full sequence) is
        flagged ``generated``.  Returns the number of nodes added."""
        n_total = min(len(tokens) // self.page_size, len(pages))
        node, added = self.root, 0
        now = next(self._clock)
        for j, blk in enumerate(self._blocks(tokens, n_total)):
            child = node.children.get(blk)
            if child is None:
                if pages[j] == NULL_PAGE:
                    break
                gen = (generated_from is not None
                       and (j + 1) * self.page_size > generated_from)
                child = RadixNode(blk, pages[j], node, generated=gen)
                node.children[blk] = child
                self.allocator.ref([pages[j]])
                self.nodes += 1
                added += 1
            child.last_used = now
            node = child
        return added

    # ---------------------------------------------------------- eviction ----
    def _pinned(self, node: RadixNode) -> bool:
        """A page some active request still maps (refcount beyond the
        index's own reference)."""
        return self.allocator.refcount(node.page) > 1

    def evictable_pages(self) -> int:
        """Pages the index could return to the pool right now: the nodes
        of maximal subtrees where nothing is pinned (leaf-first cascading
        reaches exactly those)."""
        def walk(node):
            count, clean = 0, True
            for c in node.children.values():
                c_count, c_clean = walk(c)
                count += c_count
                clean &= c_clean
            if node is self.root:
                return count, False
            if clean and not self._pinned(node):
                return count + 1, True
            return count, False
        return walk(self.root)[0]

    def evict(self, need: int) -> int:
        """LRU-evict unpinned cached prefixes until ``need`` pages are
        back in the free pool (or nothing evictable remains).  Only
        leaves are dropped — an interior node with a live descendant
        stays, or the descendant's path would dangle — and a freed
        parent becomes the next round's leaf.  Returns pages freed."""
        freed = 0
        while freed < need:
            victim = None
            stack = [self.root]
            while stack:
                n = stack.pop()
                stack.extend(n.children.values())
                if n is self.root or n.children or self._pinned(n):
                    continue
                if victim is None or n.last_used < victim.last_used:
                    victim = n
            if victim is None:
                break
            self.allocator.free([victim.page])
            del victim.parent.children[victim.block]
            self.nodes -= 1
            freed += 1
        return freed
