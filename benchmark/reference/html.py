"""Read what a served page shows: its name-value pairs, tables and cards.

The pages are the program's output; these helpers only read them. Every
value comes back as the text an operator sees, tags stripped and
entities unescaped.
"""

from __future__ import annotations

import html
import re

_TAG = re.compile(r"<[^>]+>")
_DL = re.compile(r"<dl class=\"hl-namevalue\">(.*?)</dl>", re.S)
_PAIR = re.compile(r"<dt>(.*?)</dt><dd>(.*?)</dd>", re.S)
_TABLE = re.compile(r"<table class=\"hl-table\">(.*?)</table>", re.S)
_ROW = re.compile(r"<tr>(.*?)</tr>", re.S)
_CELL = re.compile(r"<t([dh])>(.*?)</t\1>", re.S)


def text(fragment: str) -> str:
    return html.unescape(_TAG.sub("", fragment)).strip()


def main(body: str) -> str:
    start = body.find("<main>")
    end = body.find("</main>")
    return body[start + 6 : end] if start >= 0 and end > start else ""


def pairs(fragment: str) -> list[tuple[str, str]]:
    """Every ``<dt>``/``<dd>`` pair, in page order."""
    out: list[tuple[str, str]] = []
    for dl in _DL.findall(fragment):
        out.extend((text(k), text(v)) for k, v in _PAIR.findall(dl))
    return out


def tables(fragment: str) -> list[list[list[str]]]:
    """Every table as rows of cell texts; the header row first."""
    return [
        [[text(cell) for _, cell in _CELL.findall(row)] for row in _ROW.findall(t)]
        for t in _TABLE.findall(fragment)
    ]


def sections(fragment: str, css_class: str) -> list[str]:
    """The bodies of the ``<section>`` elements carrying ``css_class``."""
    pattern = re.compile(
        r"<section class=\"hl-section %s\">(.*?)</section>" % re.escape(css_class), re.S
    )
    return pattern.findall(fragment)
