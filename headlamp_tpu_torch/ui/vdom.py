"""Minimal immutable element tree with HTML and text renderers.

The structural role React's element tree plays for the reference: pages
return trees; tests assert on structure/text (the reference's
testing-library ``getByText`` discipline, SURVEY.md §4 tier 3); the
server renders HTML. No diffing — snapshots re-render whole pages, which
at BASELINE scale (256 nodes) is cheap and keeps rendering a pure
function of the snapshot.
"""

from __future__ import annotations

import html
from dataclasses import dataclass, field
from typing import Any

Child = Any  # Element | str | int | float | None (None children are dropped)


@dataclass(frozen=True, slots=True)
class Element:
    tag: str
    props: dict[str, Any] = field(default_factory=dict)
    children: tuple[Any, ...] = ()


class BoundaryNode:
    """Marker base for lazy subtree nodes (``ui.fragment``). Every
    walker in this module descends through :meth:`built`, so text and
    HTML see exactly the tree the boundary builds."""

    __slots__ = ()

    def built(self) -> "Child":
        raise NotImplementedError


def h(tag: str, props: dict[str, Any] | None = None, *children: Child) -> Element:
    """Hyperscript constructor. Nested lists/tuples and None children are
    flattened/dropped so callers can build conditionally:
    ``h('div', None, [rows], error and error_box(error))``."""
    flat: list[Any] = []

    def add(c: Any) -> None:
        if c is None or c is False:
            return
        if isinstance(c, (list, tuple)) and not isinstance(c, Element):
            for item in c:
                add(item)
            return
        flat.append(c)

    for c in children:
        add(c)
    return Element(tag=tag, props=dict(props or {}), children=tuple(flat))


# ---------------------------------------------------------------------------
# Renderers
# ---------------------------------------------------------------------------

_VOID_TAGS = {"br", "hr", "img", "input", "meta", "link"}


def render_html(node: Child) -> str:
    """Escaped HTML. Props: ``class_`` -> class; ``data`` values are
    str()ed; callables/None skipped.

    Single-pass writer into one buffer: the recursive-concat version
    copied every subtree's string once per ancestor level (O(n·depth)
    bytes moved per page; thousands of nodes at fleet scale)."""
    out: list[str] = []
    _render_html_into(node, out)
    return "".join(out)


def _render_html_into(node: Child, out: list[str]) -> None:
    if node is None:
        return
    if isinstance(node, BoundaryNode):
        _render_html_into(node.built(), out)
        return
    if not isinstance(node, Element):
        out.append(html.escape(str(node)))
        return
    attrs = []
    for key, value in node.props.items():
        if value is None or callable(value):
            continue
        name = "class" if key == "class_" else key
        if value is True:
            attrs.append(name)
        else:
            attrs.append(f'{name}="{html.escape(str(value), quote=True)}"')
    attr_str = (" " + " ".join(attrs)) if attrs else ""
    if node.tag in _VOID_TAGS:
        out.append(f"<{node.tag}{attr_str}/>")
        return
    out.append(f"<{node.tag}{attr_str}>")
    for c in node.children:
        _render_html_into(c, out)
    out.append(f"</{node.tag}>")


_BLOCK_TAGS = {
    "div", "p", "section", "table", "tr", "ul", "ol", "li",
    "h1", "h2", "h3", "h4", "header", "footer", "dl",
}


def render_text(node: Child) -> str:
    """Plain-text projection: block tags break lines, table cells are
    tab-separated. What the CLI prints and what tests grep."""
    out: list[str] = []

    def walk(n: Child) -> None:
        if n is None:
            return
        if isinstance(n, BoundaryNode):
            walk(n.built())
            return
        if not isinstance(n, Element):
            out.append(str(n))
            return
        if n.tag in ("td", "th") and out and out[-1] not in ("\n", "\t"):
            out.append("\t")
        for c in n.children:
            walk(c)
        if n.tag == "dt":
            # Name/value pairs: name<TAB>value, one pair per line (the
            # dd below closes the line via _BLOCK_TAGS).
            out.append("\t")
        elif n.tag == "dd":
            out.append("\n")
        elif n.tag in _BLOCK_TAGS:
            out.append("\n")

    walk(node)
    text = "".join(out)
    lines = [line.strip("\t ") for line in text.split("\n")]
    return "\n".join(line for line in lines if line)


def text_content(node: Child) -> str:
    """All text, single-spaced — the assertion helper
    (testing-library's textContent analogue)."""
    parts: list[str] = []

    def walk(n: Child) -> None:
        if n is None:
            return
        if isinstance(n, BoundaryNode):
            walk(n.built())
            return
        if not isinstance(n, Element):
            parts.append(str(n))
            return
        for c in n.children:
            walk(c)

    walk(node)
    return " ".join(" ".join(parts).split())
