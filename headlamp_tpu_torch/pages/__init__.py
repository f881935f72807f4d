"""Pages — pure functions from snapshots to element trees."""

from .metrics_page import metrics_page

__all__ = ["metrics_page"]
