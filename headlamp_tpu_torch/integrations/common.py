"""Shared integration helpers (``headlamp_tpu/integrations/common.py``)."""

from __future__ import annotations

from typing import Any, Mapping


def unwrap_json_data(resource: Any) -> Any:
    """Headlamp hands detail-view callbacks either a raw object or a
    wrapper with the raw object under ``jsonData``
    (`NodeDetailSection.tsx:40-41` and `NodeColumns.tsx:21-25` both
    unwrap defensively). Accept both."""
    if isinstance(resource, Mapping) and isinstance(resource.get("jsonData"), Mapping):
        return resource["jsonData"]
    return resource
