"""Host-side radix index over token prefixes of KV pages; a copy of
`cloud_tpu/serving/prefixcache.py` (`PrefixCache`, `PrefixMatch`).

Because the paged pool gives every `page_size`-token run of KV cache a
physical identity (kvpool), and because serve prefill writes prompts in
CANONICAL layout (token i of the prompt at cache slot i, engine.py), two
requests whose prompts agree on their first `k * page_size` tokens
produce the same content in their first k pages. This module indexes
those pages by the token runs that produced them, at page granularity: a
trie whose edges are `page_size`-token tuples and whose nodes carry the
physical page holding that run's KV.

At admission the scheduler consults `match(prompt)`: matched pages map
straight into the new request's page table (pool refcount shared, pages
never copied) and prefill starts at the divergence point, so TTFT drops
from O(prompt) to O(suffix). A divergence INSIDE a page yields a partial
match: the matched page becomes a read-only copy-on-write source whose
leading tokens are rebuilt into a fresh page by the insert scatter (the
trie page itself is never written).

The trie holds one pool reference per indexed page, bounded by
`max_pages` (the device page budget). Eviction is LRU over leaf nodes
whose page has no other holder (pool refcount 1 = trie only); pages
referenced by in-flight requests are never evicted.

Only FULL prompt pages strictly before the last prompt token are ever
registered: decode writes start at the first post-prompt slot, so
indexed pages are immutable for the request's lifetime, and a match is
capped at `len(prompt) - 1` tokens (at least one suffix token must
remain to prefill: the first sampled token comes from the last prompt
position).

The request tracer (`serving/reqtrace.py`) is not ported (ROADMAP §1,
item 5c): `_tracer()` is its seam and returns None.

The edges are the page's tokens as the bytes of an int64 array, where
JAX's trie keys tuples: a walk over a long prompt slices one array
instead of building a tuple a page.
"""

import dataclasses
import threading

import numpy as np


def _as_tokens(tokens):
    """A prompt as a 1-D int64 array (itself when it is one)."""
    return np.asarray(tokens, np.int64).reshape(-1)


def _tracer():
    """The request tracer of `cloud_tpu.serving.reqtrace.get()`; none is
    ported yet."""
    return None


@dataclasses.dataclass
class PrefixMatch:
    """A prefix-cache hit. The caller owns one pool reference on every
    page listed here (full pages and the partial CoW source) and must
    `pool.free` them when the request completes or the match is
    trimmed."""
    pages: list           # full shared pages, logical order
    prefix_len: int       # matched tokens: len(pages)*page_size + partial_len
    partial_page: object  # CoW source page id, or None
    partial_len: int      # matched tokens inside partial_page


class _Node:
    __slots__ = ("key", "page", "children", "parent", "stamp")

    def __init__(self, key, page, parent):
        self.key = key          # page_size tokens, int64 bytes
        self.page = page        # physical page id (trie holds one ref)
        self.children = {}      # key bytes -> _Node
        self.parent = parent    # _Node or None (root child)
        self.stamp = 0          # LRU clock at last touch


class PrefixCache:
    """Page-granular radix index with LRU eviction under a page budget.

    Thread-safe. Lock order is trie -> pool (the pool never calls back
    into the trie). `probe` is side-effect-free (window ordering);
    `match` takes pool references on the returned pages so concurrent
    eviction can never recycle a page an admitted request is mapping.
    """

    def __init__(self, pool, max_pages=None):
        self.pool = pool
        self.page_size = pool.page_size
        if max_pages is None:
            max_pages = max(pool.capacity // 2, 1)
        self.max_pages = int(max_pages)
        self._lock = threading.Lock()
        self._root = {}    # key bytes -> _Node
        self._nodes = 0
        self._pages_held = 0
        self._clock = 0
        self._lookups = 0
        self._hits = 0
        self._partial_hits = 0
        self._evictions = 0
        self._matched_tokens = 0

    # -- lookup -------------------------------------------------------

    def _walk(self, tokens):
        """Longest full-page descent for `tokens` (int64 array), capped
        so at least one token remains unmatched. Returns (nodes,
        limit)."""
        limit = len(tokens) - 1  # >=1 suffix token must survive
        page = self.page_size
        nodes = []
        children = self._root
        while (len(nodes) + 1) * page <= limit:
            key = tokens[len(nodes) * page:(len(nodes) + 1) * page].tobytes()
            node = children.get(key)
            if node is None:
                break
            nodes.append(node)
            children = node.children
        return nodes, limit

    def _partial(self, nodes, tokens, limit):
        """Best partial-page continuation below the deepest full match:
        the child sharing the longest nonzero leading token run with the
        remaining prompt."""
        children = nodes[-1].children if nodes else self._root
        start = len(nodes) * self.page_size
        rest = tokens[start:limit]
        best, best_len = None, 0
        for key, node in children.items():
            run = min(self.page_size, len(rest))
            differ = np.flatnonzero(np.frombuffer(key, np.int64)[:run]
                                    != rest[:run])
            if len(differ):
                run = int(differ[0])
            if run > best_len:
                best, best_len = node, run
        return best, best_len

    def probe(self, tokens):
        """Matched-token count for `tokens` with NO side effects — the
        admission window sorts by this (longest radix match first)."""
        tokens = _as_tokens(tokens)
        with self._lock:
            nodes, limit = self._walk(tokens)
            _, part_len = self._partial(nodes, tokens, limit)
            return len(nodes) * self.page_size + part_len

    def match(self, tokens):
        """Longest indexed prefix of `tokens`, with pool references
        taken on every returned page. Returns a PrefixMatch (empty on
        miss: prefix_len 0)."""
        tokens = _as_tokens(tokens)
        with self._lock:
            self._lookups += 1
            nodes, limit = self._walk(tokens)
            part, part_len = self._partial(nodes, tokens, limit)
            self._clock += 1
            for node in nodes:
                node.stamp = self._clock
            if part is not None and part_len > 0:
                part.stamp = self._clock
                self._partial_hits += 1
            pages = [node.page for node in nodes]
            prefix_len = len(pages) * self.page_size + part_len
            if prefix_len:
                self._hits += 1
                self._matched_tokens += prefix_len
            held = pages + ([part.page] if part_len else [])
            if held:
                self.pool.share(held)
            return PrefixMatch(
                pages=pages, prefix_len=prefix_len,
                partial_page=part.page if part_len else None,
                partial_len=part_len)

    # -- registration -------------------------------------------------

    def register(self, tokens, page_ids):
        """Indexes the full prompt pages of a freshly-inserted request:
        `page_ids[i]` holds tokens `[i*page_size, (i+1)*page_size)` in
        canonical layout. Only pages strictly before the last prompt
        token are registered (decode never writes them). Existing nodes
        keep their page (first writer wins — identical content); new
        nodes take a pool reference, evicting LRU entries to stay under
        the budget. Registration quietly stops early when the budget
        cannot be met."""
        page = self.page_size
        tokens = _as_tokens(tokens)
        n_full = min((len(tokens) - 1) // page, len(page_ids))
        if n_full <= 0:
            return 0
        with self._lock:
            self._clock += 1
            children = self._root
            parent = None
            registered = 0
            for i in range(n_full):
                key = tokens[i * page:(i + 1) * page].tobytes()
                node = children.get(key)
                if node is None:
                    if (self._pages_held + 1 > self.max_pages
                            and not self._evict_locked(1)):
                        break
                    node = _Node(key, int(page_ids[i]), parent)
                    self.pool.share([node.page])
                    children[key] = node
                    self._nodes += 1
                    self._pages_held += 1
                    registered += 1
                node.stamp = self._clock
                parent = node
                children = node.children
            return registered

    # -- eviction -----------------------------------------------------

    def _iter_nodes(self):
        stack = list(self._root.values())
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    def _evict_locked(self, need):
        """Drops up to `need` LRU leaf pages with no outside holder.
        Returns pages actually freed."""
        freed = 0
        while freed < need:
            victims = [n for n in self._iter_nodes()
                       if not n.children
                       and self.pool.refcount(n.page) == 1]
            if not victims:
                break
            victim = min(victims, key=lambda n: n.stamp)
            self._unlink_locked(victim)
            freed += 1
        return freed

    def _unlink_locked(self, node):
        siblings = (node.parent.children if node.parent is not None
                    else self._root)
        del siblings[node.key]
        self._nodes -= 1
        self._pages_held -= 1
        self._evictions += 1
        self.pool.free([node.page])

    def evict(self, n_pages):
        """Best-effort LRU eviction of `n_pages` (reclaim pressure from
        a blocked reservation). Returns pages freed."""
        with self._lock:
            freed = self._evict_locked(int(n_pages))
        if freed:
            tracer = _tracer()
            if tracer is not None:
                # Global lane (rid=None): cache-pressure evictions are
                # not owned by any one request but explain why the
                # requests around them waited for pages.
                tracer.emit(None, "prefix_evict", pages=freed,
                            requested=int(n_pages))
        return freed

    def clear(self):
        """Releases every indexed page (pool refs included). Pages
        still mapped by in-flight requests survive via their own refs."""
        with self._lock:
            pages = [n.page for n in self._iter_nodes()]
            if pages:
                self.pool.free(pages)
            self._root = {}
            self._nodes = 0
            self._pages_held = 0

    def held_pages(self):
        """Pages the trie currently holds a reference on."""
        with self._lock:
            return sorted(n.page for n in self._iter_nodes())

    # -- accounting ---------------------------------------------------

    def reset_stats(self):
        with self._lock:
            self._lookups = self._hits = self._partial_hits = 0
            self._matched_tokens = 0
            self._evictions = 0

    def stats(self):
        with self._lock:
            return {
                "nodes": self._nodes,
                "pages_held": self._pages_held,
                "max_pages": self.max_pages,
                "lookups": self._lookups,
                "hits": self._hits,
                "partial_hits": self._partial_hits,
                "hit_rate": (self._hits / self._lookups
                             if self._lookups else 0.0),
                "matched_tokens": self._matched_tokens,
                "evictions": self._evictions,
            }


__all__ = ["PrefixCache", "PrefixMatch"]
