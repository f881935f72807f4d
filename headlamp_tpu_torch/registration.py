"""Plugin registration: the routes and sidebar entries the host serves.

The port's counterpart of ``headlamp_tpu/registration.py``, with the
same ``SidebarEntry``, ``Route`` and ``Registry`` types.
:func:`register_plugin` registers only the routes whose page this
package renders (today the metrics page), so the host answers every
other path, ``/`` and ``/tpu`` included, with a 404 and never with a
stand-in page.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from .pages.metrics_page import metrics_page


@dataclass(frozen=True)
class SidebarEntry:
    name: str
    label: str
    url: str
    parent: str | None = None


@dataclass(frozen=True)
class Route:
    path: str
    name: str
    #: Page factory; hosts dispatch on ``kind`` ('metrics' takes the
    #: metrics snapshot and the forecast view).
    component: Callable[..., Any]
    kind: str


@dataclass
class Registry:
    sidebar_entries: list[SidebarEntry] = field(default_factory=list)
    routes: list[Route] = field(default_factory=list)

    def route_for(self, path: str) -> Route | None:
        for r in self.routes:
            if r.path == path:
                return r
        return None


#: The sidebar root the entries hang under, as in the JAX package.
SIDEBAR_ROOT = "tpu"


def register_plugin(registry: Registry | None = None) -> Registry:
    """Populate a registry with the pages this package renders."""
    reg = registry if registry is not None else Registry()
    reg.sidebar_entries.append(
        SidebarEntry("tpu-metrics", "Metrics", "/tpu/metrics", parent=SIDEBAR_ROOT)
    )
    reg.routes.append(Route("/tpu/metrics", "tpu-metrics", metrics_page, kind="metrics"))
    return reg
