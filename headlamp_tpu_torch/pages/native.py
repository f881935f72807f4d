"""Links to the native node and pod views.

The port's copy of ``node_href``, ``pod_href``, ``node_link`` and
``pod_link`` from ``headlamp_tpu/pages/native.py``. Node and pod names
across the dashboard link to the host's native detail views
(``/node/<name>``, ``/pod/<namespace>/<name>``); those views arrive with
the native detail pages.
"""

from __future__ import annotations

from typing import Any

from ..domain import objects as obj
from ..ui import h
from ..ui.vdom import Element


def node_href(node_name: str) -> str:
    return f"/node/{node_name}"


def pod_href(pod: Any) -> str:
    return f"/pod/{obj.namespace(pod) or 'default'}/{obj.name(pod)}"


def node_link(node: Any) -> Element:
    name = obj.name(node)
    return h("a", {"href": node_href(name), "class_": "hl-res-link"}, name)


def pod_link(pod: Any) -> Element:
    ns = obj.namespace(pod)
    label = f"{ns}/{obj.name(pod)}" if ns else obj.name(pod)
    return h("a", {"href": pod_href(pod), "class_": "hl-res-link"}, label)
