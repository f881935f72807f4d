"""Fragment boundaries: keyed subtrees that pages mark.

In the JAX package a boundary's bytes may be served from a fragment
cache, keyed and salted. This package has no cache yet: a boundary
builds its subtree inline, once, and every renderer descends through
it, so the page text and HTML are exactly what the JAX package paints.
Boundaries take the JAX signature, salt included; the salt is kept for
the cache and read by nothing yet.
"""

from __future__ import annotations

from typing import Any, Callable

from .vdom import BoundaryNode, Child


class FragmentBoundary(BoundaryNode):
    """A lazy subtree named by ``key`` and salted by every input it
    renders; ``build`` runs at most once."""

    __slots__ = ("key", "salt", "_build", "_built")

    def __init__(self, key: str, salt: Any, build: Callable[[], Child]) -> None:
        self.key = key
        self.salt = salt
        self._build = build
        self._built: Child = None

    def built(self) -> Child:
        if self._built is None:
            self._built = self._build()
        return self._built


def fragment(key: str, salt: Any, build: Callable[[], Child]) -> FragmentBoundary:
    """Hyperscript-style constructor pages use to mark a boundary."""
    return FragmentBoundary(key, salt, build)
