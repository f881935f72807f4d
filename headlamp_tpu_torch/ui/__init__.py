"""UI kit — element tree, the components the pages use, fragment
boundaries and the fragment cache. Pages build trees; renderers are
separate."""

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
from .fragment import (
    DEFAULT_MAX_ENTRIES,
    FragmentBoundary,
    FragmentCache,
    FragmentPaint,
    fragment,
    set_active_fragments,
)
from .vdom import Element, h, render_html, render_text, text_content

__all__ = [
    "BAR_CRIT_PCT",
    "BAR_WARN_PCT",
    "BudgetBar",
    "DEFAULT_MAX_ENTRIES",
    "Element",
    "EmptyContent",
    "ErrorBox",
    "FragmentBoundary",
    "FragmentCache",
    "FragmentPaint",
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
    "set_active_fragments",
    "text_content",
]
