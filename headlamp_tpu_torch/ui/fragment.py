"""Incremental fragment rendering.

The port's copy of ``headlamp_tpu/ui/fragment.py``. The push differ
knows which keyed rows and cells changed in each sync generation, and
every drill-down region has a stable path. Pages mark their row, region
and cell-group subtrees as :class:`FragmentBoundary` nodes (key = the
differ's row key or the region path; salt = every render input beyond
the key), and the host paints through a :class:`FragmentPaint` over a
bounded, counted LRU (:class:`FragmentCache`):

* **resolve** (billed to ``page.component``): every boundary whose bytes
  are not cached for the paint's ``(epoch, degraded, salt)`` is rendered
  once into the cache: O(changed), since push evicted exactly the keys
  the differ saw change.
* **splice** (billed to ``fragment.splice``): the final bytes append
  cached fragment strings instead of descending the subtrees.

Invalidation is push-driven: ``PushPipeline.on_snapshot`` hands the
differ's change set to :meth:`FragmentCache.invalidate` at diff time, so
the request path makes no second diff. The salt is the correctness
backstop: a fragment's bytes must be a pure function of ``(key, salt)``,
so even an entry push missed can never serve stale bytes (a salt
mismatch is a miss, and the entry is replaced in place).

A paint through this layer is byte-identical to plain
:func:`~headlamp_tpu_torch.ui.vdom.render_html` over the same tree,
which descends boundaries itself.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Any, Callable, Iterable

from ..obs.metrics import registry as _metrics_registry
from .vdom import BoundaryNode, Child, Element, _render_html_into

#: LRU entry bound. At the 1024-node fixture the hot set is ~1k node
#: rows + ~1k pod rows + ~4k chip/forecast rows + O(regions) + O(10)
#: section groups, so the default holds a full large-fleet working set
#: without eviction churn while still bounding a hostile key space.
DEFAULT_MAX_ENTRIES = 8192

_HITS = _metrics_registry.counter(
    "headlamp_tpu_torch_render_fragment_hits_total",
    "Fragment-cache hits: boundary subtrees spliced from cached bytes "
    "instead of re-rendered.",
)
_MISSES = _metrics_registry.counter(
    "headlamp_tpu_torch_render_fragment_misses_total",
    "Fragment-cache misses: boundary subtrees (re-)rendered because no "
    "entry matched the (epoch, degraded, salt) invariants.",
)
_EVICTIONS = _metrics_registry.counter(
    "headlamp_tpu_torch_render_fragment_evictions_total",
    "Fragment-cache entries dropped: LRU pressure plus differ-driven "
    "invalidations (changed/removed keys evicted at diff time).",
)

#: The serving cache, for the memory gauge — same weakref discipline as
#: the push clients gauge: tests build many apps per process and
#: the gauge must follow the live one.
_ACTIVE: "weakref.ref[FragmentCache] | None" = None


def set_active_fragments(cache: "FragmentCache | None") -> None:
    global _ACTIVE
    _ACTIVE = weakref.ref(cache) if cache is not None else None


def _bytes_sample() -> float | None:
    cache = _ACTIVE() if _ACTIVE is not None else None
    return float(cache.bytes) if cache is not None else None


_metrics_registry.gauge_fn(
    "headlamp_tpu_torch_render_fragment_cache_bytes",
    "UTF-8 bytes of rendered HTML held by the serving fragment cache.",
    _bytes_sample,
)


class FragmentBoundary(BoundaryNode):
    """A lazy, cacheable subtree.

    ``key`` speaks the differ's vocabulary (row key, region path, or a
    ``cells:``-prefixed group name) so the push pipeline's change set
    maps straight onto cache evictions. ``salt`` must capture EVERY
    render-relevant input that is not implied by the key — including
    request-time strings like formatted ages — because cached bytes
    are reused whenever the salt matches. ``build`` runs only when the
    bytes are not already cached (and at most once per node)."""

    __slots__ = ("key", "salt", "_build", "_built", "_html")

    def __init__(self, key: str, salt: Any, build: Callable[[], Child]) -> None:
        self.key = key
        self.salt = salt
        self._build = build
        self._built: Child = None
        self._html: str | None = None

    def built(self) -> Child:
        if self._built is None:
            self._built = self._build()
        return self._built


def fragment(key: str, salt: Any, build: Callable[[], Child]) -> FragmentBoundary:
    """Hyperscript-style constructor pages use to mark a boundary."""
    return FragmentBoundary(key, salt, build)


class _Entry:
    __slots__ = ("salt", "epoch", "degraded", "html", "nbytes")

    def __init__(self, salt: Any, epoch: int, degraded: bool, html: str) -> None:
        self.salt = salt
        self.epoch = epoch
        self.degraded = degraded
        self.html = html
        self.nbytes = len(html.encode("utf-8"))


class FragmentCache:
    """Bounded, counted LRU of rendered fragment bytes.

    Entries key on ``(page, key)`` and carry the cache epoch and the
    degraded flag plus the salt; a lookup hits only when all three
    match. A new generation needs no stamp: the differ evicts the keys
    it saw change (:meth:`invalidate`). Every miss and every eviction
    is counted — never silent — and byte totals feed the
    ``headlamp_tpu_torch_render_fragment_cache_bytes`` gauge."""

    def __init__(self, max_entries: int = DEFAULT_MAX_ENTRIES) -> None:
        self.max_entries = max(1, int(max_entries))
        self._lock = threading.Lock()
        self._entries: OrderedDict[tuple[str, str], _Entry] = OrderedDict()
        #: key -> pages holding it, so a differ key invalidates every
        #: page namespace it renders under (node rows appear on both
        #: /tpu/nodes and /tpu/fleet) in O(occurrences).
        self._pages_of: dict[str, set[str]] = {}
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(
        self,
        page: str,
        key: str,
        salt: Any,
        *,
        epoch: int,
        degraded: bool,
    ) -> str | None:
        full = (page, key)
        with self._lock:
            entry = self._entries.get(full)
            if (
                entry is not None
                and entry.epoch == epoch
                and entry.degraded == degraded
                and entry.salt == salt
            ):
                self._entries.move_to_end(full)
                self.hits += 1
                _HITS.inc()
                return entry.html
            self.misses += 1
            _MISSES.inc()
            return None

    def put(
        self,
        page: str,
        key: str,
        salt: Any,
        html: str,
        *,
        epoch: int,
        degraded: bool,
    ) -> None:
        full = (page, key)
        entry = _Entry(salt, epoch, degraded, html)
        with self._lock:
            old = self._entries.pop(full, None)
            if old is not None:
                self.bytes -= old.nbytes
            self._entries[full] = entry
            self.bytes += entry.nbytes
            self._pages_of.setdefault(key, set()).add(page)
            while len(self._entries) > self.max_entries:
                (old_page, old_key), dropped = self._entries.popitem(last=False)
                self.bytes -= dropped.nbytes
                self._discard_index(old_page, old_key)
                self.evictions += 1
                _EVICTIONS.inc()

    def _discard_index(self, page: str, key: str) -> None:
        pages = self._pages_of.get(key)
        if pages is not None:
            pages.discard(page)
            if not pages:
                del self._pages_of[key]

    def invalidate(self, keys: Iterable[str]) -> int:
        """Differ-driven eviction: drop every cached fragment
        whose key the differ saw change/disappear this generation —
        across ALL page namespaces holding it. Runs on the sync thread
        at diff time; O(changed keys), never a tree walk. Returns the
        number of entries dropped (each counted as an eviction)."""
        dropped = 0
        with self._lock:
            for key in keys:
                pages = self._pages_of.pop(key, None)
                if not pages:
                    continue
                for page in pages:
                    entry = self._entries.pop((page, key), None)
                    if entry is not None:
                        self.bytes -= entry.nbytes
                        dropped += 1
            if dropped:
                self.evictions += dropped
                _EVICTIONS.inc(dropped)
        return dropped

    def clear(self) -> int:
        with self._lock:
            dropped = len(self._entries)
            self._entries.clear()
            self._pages_of.clear()
            self.bytes = 0
            if dropped:
                self.evictions += dropped
                _EVICTIONS.inc(dropped)
            return dropped

    def __len__(self) -> int:
        return len(self._entries)

    def counters(self) -> dict[str, int]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
        }

    def snapshot(self) -> dict[str, Any]:
        """The /healthz ``runtime.render`` block."""
        hits, misses = self.hits, self.misses
        total = hits + misses
        return {
            "entries": len(self._entries),
            "max_entries": self.max_entries,
            "bytes": self.bytes,
            "hits": hits,
            "misses": misses,
            "evictions": self.evictions,
            "hit_rate": round(hits / total, 4) if total else None,
        }


class FragmentPaint:
    """One paint's fragment context: the cache plus the ETag invariants
    the entries key on. ``prerender`` is the page.component phase
    (renders stale boundaries into the cache); ``splice`` is the
    fragment.splice phase (assembles final bytes, appending cached
    fragments instead of descending)."""

    __slots__ = ("cache", "page", "epoch", "degraded", "rendered", "spliced")

    def __init__(
        self,
        cache: FragmentCache,
        *,
        page: str,
        epoch: int,
        degraded: bool,
    ) -> None:
        self.cache = cache
        self.page = page
        self.epoch = epoch
        self.degraded = degraded
        self.rendered = 0
        self.spliced = 0

    def _resolve(self, node: BoundaryNode) -> str:
        if not isinstance(node, FragmentBoundary):
            raise TypeError(f"not a fragment boundary: {type(node).__name__}")
        # Per-paint memo on the node itself: prerender resolves, splice
        # reuses — one cache lookup per boundary per paint, so the
        # hit/miss counters mean what they say.
        html = node._html
        if html is not None:
            return html
        html = self.cache.get(
            self.page,
            node.key,
            node.salt,
            epoch=self.epoch,
            degraded=self.degraded,
        )
        if html is None:
            buf: list[str] = []
            _render_html_into(node.built(), buf, self._resolve)
            html = "".join(buf)
            self.cache.put(
                self.page,
                node.key,
                node.salt,
                html,
                epoch=self.epoch,
                degraded=self.degraded,
            )
            self.rendered += 1
        else:
            self.spliced += 1
        node._html = html
        return html

    def prerender(self, node: Child) -> None:
        """Render every stale boundary in ``node`` into the cache (the
        changed-fragment re-render the page.component span bills).
        Boundaries inside a cached fragment are never visited — their
        bytes are already inside the parent's entry."""
        stack = [node]
        while stack:
            n = stack.pop()
            if isinstance(n, FragmentBoundary):
                self._resolve(n)
            elif isinstance(n, Element):
                stack.extend(n.children)

    def splice(self, node: Child) -> str:
        """Assemble the full page bytes, splicing cached fragments."""
        out: list[str] = []
        _render_html_into(node, out, self._resolve)
        return "".join(out)


__all__ = [
    "DEFAULT_MAX_ENTRIES",
    "FragmentBoundary",
    "FragmentCache",
    "FragmentPaint",
    "fragment",
    "set_active_fragments",
]
