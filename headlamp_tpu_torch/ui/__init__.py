"""UI kit — element tree, the components the pages use, and fragment
boundaries. Pages build trees; renderers are separate."""

from .components import (
    BAR_CRIT_PCT,
    BAR_WARN_PCT,
    BudgetBar,
    EmptyContent,
    ErrorBox,
    Loader,
    NameValueTable,
    PercentageBar,
    SectionBox,
    SectionHeader,
    SimpleTable,
    StatusLabel,
    UtilizationBar,
)
from .fragment import FragmentBoundary, fragment
from .vdom import Element, h, render_html, render_text, text_content

__all__ = [
    "BAR_CRIT_PCT",
    "BAR_WARN_PCT",
    "BudgetBar",
    "Element",
    "EmptyContent",
    "ErrorBox",
    "FragmentBoundary",
    "Loader",
    "NameValueTable",
    "PercentageBar",
    "SectionBox",
    "SectionHeader",
    "SimpleTable",
    "StatusLabel",
    "UtilizationBar",
    "fragment",
    "h",
    "render_html",
    "render_text",
    "text_content",
]
