"""Radix (prefix-trie) KV caches and the cache-tree tensor helpers.

Copy of ``repro/serving/prefix_cache.py``, except that the paged trie
keys a node's children by the first *page* of their edge: the
reference's key, the first token, lets a prompt that diverges inside
the first page (every prompt starts with BOS) replace its sibling, whose
pages then stay referenced and out of eviction's reach.  Two tries:
:class:`PagedPrefixCache` (the paged layout) holds *page ids* of the
engine's KV pool, so a cache hit appends page references to the
requester's page table and copies no KV; :class:`PrefixCache` (the
contiguous layout) holds the KV segments themselves, under a byte budget.
The helpers work on the engine's cache trees (nested dicts of tensors)
along each leaf's sequence axis.

Concurrency: single event loop, no locks.  ``match_and_pin`` pins the
matched path; ``release`` walks by tokens, so a pin stays balanced even
if a concurrent insert split a pinned node.
"""

from __future__ import annotations

import torch

# ---------------------------------------------------------------------------
# cache-tree segment operations (by a per-leaf sequence-axis tree)


def _map(fn, axes, *trees):
    if isinstance(axes, dict):
        return {k: _map(fn, axes[k], *(t[k] for t in trees)) for k in axes}
    return fn(axes, *trees)


def tree_slice(tree, axes, start, stop):
    """Slice every leaf along its sequence axis: positions [start, stop)."""
    return _map(lambda ax, leaf: leaf.narrow(ax, start, stop - start),
                axes, tree)


def tree_concat(trees, axes):
    """Concatenate segments along each leaf's sequence axis."""
    trees = [t for t in trees if t is not None]
    if len(trees) == 1:
        return trees[0]
    return _map(lambda ax, *leaves: torch.cat(leaves, dim=ax), axes, *trees)


def tree_pad_to(tree, axes, target):
    """Zero-pad every leaf along its sequence axis up to ``target``
    positions (padding is masked out by ``prefix_len`` in attention)."""
    def f(ax, leaf):
        n = leaf.shape[ax]
        if n == target:
            return leaf
        shape = list(leaf.shape)
        shape[ax] = target - n
        return torch.cat([leaf, leaf.new_zeros(shape)], dim=ax)
    return _map(f, axes, tree)


def tree_nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


# ---------------------------------------------------------------------------
# paged radix trie (page-reference nodes)


class _PagedNode:
    __slots__ = ("tokens", "pages", "children", "parent", "refs",
                 "last_used")

    def __init__(self, tokens, pages, parent):
        self.tokens = tokens          # edge label (length ≡ 0 mod page_size)
        self.pages = tuple(pages)     # pool page ids covering these tokens
        self.children = {}            # first page (tokens) -> _PagedNode
        self.parent = parent
        self.refs = 0                 # pinned readers
        self.last_used = 0


class PagedPrefixCache:
    """Radix trie over *page references*: a node owns the pool page ids
    covering its edge tokens, holding one allocator ref per page.
    Matching, splitting, insertion and eviction happen at page
    granularity (full pages are immutable under the engine's write
    discipline; a partial page is never shared).  Eviction is LRU over
    unpinned leaves, under ``budget_pages`` and on demand via
    :meth:`reclaim` when the allocator runs dry."""

    def __init__(self, allocator, budget_pages=None):
        self.alloc = allocator
        self.page_size = allocator.page_size
        self.budget_pages = budget_pages
        self.root = _PagedNode((), (), None)
        self.pages = 0                # pages owned by the trie
        self._clock = 0
        self.lookups = 0
        self.hits = 0
        self.tokens_queried = 0
        self.tokens_matched = 0
        self.inserts = 0
        self.insert_tokens = 0
        self.skipped_inserts = 0
        self.splits = 0
        self.evictions = 0
        self.evicted_pages = 0

    # -- internals -----------------------------------------------------------

    def _touch(self, node):
        self._clock += 1
        node.last_used = self._clock

    def _split(self, node, m: int):
        """Refine at edge offset ``m`` (a page multiple): node keeps
        tokens[:m] / pages[:m/ps], a new child takes the rest."""
        ps = self.page_size
        assert 0 < m < len(node.tokens) and m % ps == 0
        lo = _PagedNode(node.tokens[m:], node.pages[m // ps:], node)
        lo.children = node.children
        for c in lo.children.values():
            c.parent = lo
        lo.refs = node.refs
        lo.last_used = node.last_used
        node.tokens = node.tokens[:m]
        node.pages = node.pages[:m // ps]
        node.children = {lo.tokens[:ps]: lo}
        self.splits += 1

    def _walk(self, tokens, *, split=True):
        """Walk over ``tokens``; partial edge matches floor to the page
        boundary.  Children are keyed by their edge's first page, so a
        match inside a first page is a miss and two prompts that diverge
        there are siblings.  Returns (path, matched_len)."""
        ps = self.page_size
        path, node, pos = [], self.root, 0
        while pos < len(tokens):
            child = node.children.get(tokens[pos:pos + ps])
            if child is None:
                break
            et = child.tokens
            m, n = ps, len(et)
            while m < n and pos + m < len(tokens) \
                    and et[m] == tokens[pos + m]:
                m += 1
            if m < n:
                ma = (m // ps) * ps
                if ma == 0 or not split:
                    break
                self._split(child, ma)
                path.append(child)
                pos += ma
                break
            path.append(child)
            pos += m
            node = child
        return path, pos

    def _evictable(self):
        out, stack = [], [self.root]
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            if nd is not self.root and not nd.children and nd.refs == 0:
                out.append(nd)
        return out

    def _drop(self, node):
        node.parent.children.pop(node.tokens[:self.page_size])
        self.pages -= len(node.pages)
        self.evictions += 1
        self.evicted_pages += len(node.pages)
        self.alloc.note_evict(len(node.pages))
        self.alloc.decref(node.pages)

    # -- client API ----------------------------------------------------------

    def probe(self, tokens) -> int:
        """Read-only longest-cached-prefix length, for routing digests (no
        pins, no splits, no accounting; may undershoot a real match)."""
        _, matched = self._walk(tuple(tokens), split=False)
        return matched

    def match_and_pin(self, tokens):
        """Longest cached page-aligned prefix → ``(matched_len, page_ids,
        handle)``; :meth:`release` the handle once the caller holds its
        own allocator refs."""
        tokens = tuple(tokens)
        self.lookups += 1
        self.tokens_queried += len(tokens)
        path, matched = self._walk(tokens)
        for nd in path:
            nd.refs += 1
            self._touch(nd)
        if matched:
            self.hits += 1
            self.tokens_matched += matched
        pages = tuple(p for nd in path for p in nd.pages)
        return matched, pages, (tokens, matched)

    def release(self, handle):
        tokens, length = handle
        ps = self.page_size
        node, pos = self.root, 0
        while pos < length:
            child = node.children.get(tokens[pos:pos + ps])
            assert child is not None, "pinned path evicted?!"
            child.refs -= 1
            pos += len(child.tokens)
            node = child
        assert pos == length, "pinned path boundary moved outside a split"

    def insert(self, tokens, page_ids) -> bool:
        """Record that ``page_ids`` hold the KV for ``tokens``
        (page-aligned); the trie increfs the uncached tail's pages.
        Returns False when the tail didn't fit under ``budget_pages``."""
        tokens = tuple(tokens)
        ps = self.page_size
        assert len(tokens) % ps == 0 and len(page_ids) == len(tokens) // ps
        path, pos = self._walk(tokens)
        for nd in path:
            self._touch(nd)
        if pos >= len(tokens):
            return True
        tail = tuple(page_ids[pos // ps:])
        if self.budget_pages is not None:
            while self.pages + len(tail) > self.budget_pages:
                leaves = self._evictable()
                if not leaves:
                    break
                self._drop(min(leaves, key=lambda nd: nd.last_used))
            if self.pages + len(tail) > self.budget_pages:
                self.skipped_inserts += 1
                return False
        parent = path[-1] if path else self.root
        node = _PagedNode(tokens[pos:], tail, parent)
        parent.children[tokens[pos:pos + ps]] = node
        self._touch(node)
        self.alloc.incref(tail)
        self.pages += len(tail)
        self.inserts += 1
        self.insert_tokens += len(tokens) - pos
        return True

    def reclaim(self, target_free: int) -> int:
        """Evict LRU unpinned leaves until the allocator has at least
        ``target_free`` free pages.  Returns pages released."""
        released = 0
        while self.alloc.free_count < target_free:
            leaves = self._evictable()
            if not leaves:
                break
            victim = min(leaves, key=lambda nd: nd.last_used)
            released += len(victim.pages)
            self._drop(victim)
        return released

    def drop_unpinned(self):
        """Release every unpinned subtree."""
        while True:
            leaves = self._evictable()
            if not leaves:
                return
            for nd in leaves:
                self._drop(nd)

    # -- introspection -------------------------------------------------------

    def evictable_pages(self) -> int:
        return sum(len(nd.pages) for nd in self._evictable())

    def node_count(self) -> int:
        return _node_count(self.root)

    def cached_tokens(self) -> int:
        return self.pages * self.page_size

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def stats(self) -> dict:
        return {
            "pages": self.pages,
            "budget_pages": self.budget_pages,
            "nodes": self.node_count(),
            "cached_tokens": self.cached_tokens(),
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_rate": self.hit_rate,
            "tokens_queried": self.tokens_queried,
            "tokens_matched": self.tokens_matched,
            "inserts": self.inserts,
            "insert_tokens": self.insert_tokens,
            "skipped_inserts": self.skipped_inserts,
            "splits": self.splits,
            "evictions": self.evictions,
            "evicted_pages": self.evicted_pages,
        }


# ---------------------------------------------------------------------------
# radix trie over KV segments (the contiguous layout)


class _Node:
    __slots__ = ("tokens", "kv", "nbytes", "children", "parent", "refs",
                 "last_used")

    def __init__(self, tokens, kv, nbytes, parent):
        self.tokens = tokens          # edge label from parent
        self.kv = kv                  # segment covering exactly these tokens
        self.nbytes = nbytes
        self.children = {}            # first token -> _Node
        self.parent = parent
        self.refs = 0                 # pinned readers
        self.last_used = 0


class PrefixCache:
    """Token-trie keyed store of prefilled KV segments with ref-count
    pinning and LRU eviction of unpinned leaves under ``budget_bytes``.
    A node's segment is a tree of tensors sliced along each leaf's
    sequence axis (``seq_axes``); an insert stores a copy of the uncached
    tail, so a node owns exactly the bytes it counts."""

    def __init__(self, seq_axes, budget_bytes: int):
        assert budget_bytes > 0, "use prefix_cache=None to disable"
        self.axes = seq_axes
        self.budget = int(budget_bytes)
        self.root = _Node((), None, 0, None)
        # assembled-prefix memo: a fan-out burst matches the same path N
        # times; KV is a deterministic function of the tokens, so entries
        # never go stale, and the cap only bounds memory
        self._asm_memo: dict = {}
        self._asm_memo_cap = 4
        self.bytes = 0
        self.peak_bytes = 0
        self._clock = 0
        self.lookups = 0
        self.hits = 0
        self.tokens_queried = 0
        self.tokens_matched = 0
        self.inserts = 0
        self.insert_tokens = 0
        self.skipped_inserts = 0
        self.splits = 0
        self.evictions = 0
        self.evicted_bytes = 0

    # -- internals -----------------------------------------------------------

    def _touch(self, node: _Node):
        self._clock += 1
        node.last_used = self._clock

    def _split(self, node: _Node, m: int):
        """Refine ``node`` at edge offset ``m``: node keeps tokens[:m], a
        new child takes tokens[m:] (and node's children).  Ref-counts are
        copied to both halves: both still lie on every pinned path."""
        assert 0 < m < len(node.tokens)
        lo_kv = tree_slice(node.kv, self.axes, m, len(node.tokens))
        lo = _Node(node.tokens[m:], lo_kv, tree_nbytes(lo_kv), node)
        lo.children = node.children
        for c in lo.children.values():
            c.parent = lo
        lo.refs = node.refs
        lo.last_used = node.last_used
        hi_kv = tree_slice(node.kv, self.axes, 0, m)
        old_bytes = node.nbytes
        node.kv = hi_kv
        node.nbytes = tree_nbytes(hi_kv)
        node.tokens = node.tokens[:m]
        node.children = {lo.tokens[0]: lo}
        self.bytes += node.nbytes + lo.nbytes - old_bytes
        self.splits += 1

    def _walk(self, tokens, *, split=True):
        """Walk the trie over ``tokens``, splitting partially matched
        edges so the matched path is whole nodes.  Returns (path,
        matched_len)."""
        path, node, pos = [], self.root, 0
        while pos < len(tokens):
            child = node.children.get(tokens[pos])
            if child is None:
                break
            et = child.tokens
            m, n = 1, len(et)
            while m < n and pos + m < len(tokens) \
                    and et[m] == tokens[pos + m]:
                m += 1
            if m < n:
                if not split:
                    break
                self._split(child, m)
            path.append(child)
            pos += m
            node = child
        return path, pos

    # -- client API ----------------------------------------------------------

    def probe(self, tokens) -> int:
        """Read-only longest-cached-prefix length: no pins, splits or
        accounting."""
        _, matched = self._walk(tuple(tokens), split=False)
        return matched

    def match_and_pin(self, tokens):
        """Longest cached prefix of ``tokens`` → ``(matched_len, kv,
        handle)``: ``kv`` covers ``tokens[:matched_len]`` (None when
        nothing matched); :meth:`release` the handle once the caller has
        copied the KV out."""
        tokens = tuple(tokens)
        self.lookups += 1
        self.tokens_queried += len(tokens)
        path, matched = self._walk(tokens)
        for nd in path:
            nd.refs += 1
            self._touch(nd)
        if matched:
            self.hits += 1
            self.tokens_matched += matched
        kv = None
        if path:
            key = tokens[:matched]
            kv = self._asm_memo.get(key)
            if kv is None:
                kv = tree_concat([nd.kv for nd in path], self.axes)
                if len(self._asm_memo) >= self._asm_memo_cap:
                    self._asm_memo.pop(next(iter(self._asm_memo)))
                self._asm_memo[key] = kv
        return matched, kv, (tokens, matched)

    def release(self, handle):
        """Unpin a ``match_and_pin`` result, walking by tokens so the pin
        stays balanced across splits made while it was held."""
        tokens, length = handle
        node, pos = self.root, 0
        while pos < length:
            child = node.children.get(tokens[pos])
            assert child is not None, "pinned path evicted?!"
            child.refs -= 1
            pos += len(child.tokens)
            node = child
        assert pos == length, "pinned path boundary moved outside a split"

    def insert(self, tokens, kv) -> bool:
        """Store the KV for ``tokens`` (``kv`` covers the whole sequence;
        only the uncached tail is copied into the trie).  Returns False
        when the tail did not fit under the budget even after eviction."""
        tokens = tuple(tokens)
        path, pos = self._walk(tokens)
        for nd in path:
            self._touch(nd)
        if pos >= len(tokens):
            return True
        seg = _map(lambda ax, leaf: leaf.clone(), self.axes,
                   tree_slice(kv, self.axes, pos, len(tokens)))
        nbytes = tree_nbytes(seg)
        self._evict(need=nbytes)
        if self.bytes + nbytes > self.budget:
            self.skipped_inserts += 1
            return False
        parent = path[-1] if path else self.root
        node = _Node(tokens[pos:], seg, nbytes, parent)
        parent.children[tokens[pos]] = node
        self._touch(node)
        self.bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self.bytes)
        self.inserts += 1
        self.insert_tokens += len(tokens) - pos
        return True

    def _evictable(self):
        """Unpinned leaves, the only safely removable nodes (an interior
        node's segment is part of every descendant's assembled prefix)."""
        out, stack = [], [self.root]
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            if nd is not self.root and not nd.children and nd.refs == 0:
                out.append(nd)
        return out

    def _evict(self, need: int = 0):
        evicted = False
        while self.bytes + need > self.budget:
            leaves = self._evictable()
            if not leaves:
                break
            victim = min(leaves, key=lambda nd: nd.last_used)
            victim.parent.children.pop(victim.tokens[0])
            self.bytes -= victim.nbytes
            self.evictions += 1
            self.evicted_bytes += victim.nbytes
            evicted = True
        if evicted:
            # the memo's assembled copies lie outside the byte accounting
            self._asm_memo.clear()

    # -- introspection -------------------------------------------------------

    def node_count(self) -> int:
        return _node_count(self.root)

    def cached_tokens(self) -> int:
        n, stack = 0, list(self.root.children.values())
        while stack:
            nd = stack.pop()
            n += len(nd.tokens)
            stack.extend(nd.children.values())
        return n

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def stats(self) -> dict:
        return {
            "bytes": self.bytes,
            "peak_bytes": self.peak_bytes,
            "budget_bytes": self.budget,
            "nodes": self.node_count(),
            "cached_tokens": self.cached_tokens(),
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_rate": self.hit_rate,
            "tokens_queried": self.tokens_queried,
            "tokens_matched": self.tokens_matched,
            "inserts": self.inserts,
            "insert_tokens": self.insert_tokens,
            "skipped_inserts": self.skipped_inserts,
            "splits": self.splits,
            "evictions": self.evictions,
            "evicted_bytes": self.evicted_bytes,
        }


def _node_count(root) -> int:
    n, stack = 0, list(root.children.values())
    while stack:
        nd = stack.pop()
        n += 1
        stack.extend(nd.children.values())
    return n
