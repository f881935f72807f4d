"""Kubernetes API transport: the ``ApiProxy.request`` contract.

Every cluster call goes through one function, ``request(path) -> parsed
JSON``, as in the reference plugin. This module carries the slice of the
JAX package's transport that the metrics page needs:

- :class:`Transport` — the protocol (``request(path, timeout_s)``).
- :class:`MockTransport` — the test and demo double: path -> canned
  response / exception / callable, with call recording.

The real HTTP transport (``KubeTransport``), its connection pool and the
watch protocol are not part of this package yet.
"""

from __future__ import annotations

import inspect
import urllib.parse
from typing import Any, Mapping, Protocol

#: Default per-request timeout (the reference's 2 000 ms).
DEFAULT_TIMEOUT_S = 2.0


class ApiError(Exception):
    """A request failed (HTTP error, bad JSON, connection refused)."""

    def __init__(self, path: str, message: str, status: int | None = None) -> None:
        super().__init__(f"{path}: {message}")
        self.path = path
        self.status = status


class Transport(Protocol):
    """Single entry point for cluster JSON requests."""

    def request(self, path: str, timeout_s: float = DEFAULT_TIMEOUT_S) -> Any:
        """GET ``path`` and return parsed JSON. Raises :class:`ApiError`
        on failure; never returns partial data."""
        ...


class MockTransport:
    """Canned-response transport for tests and the demo.

    ``routes`` maps a path (exact string, or a prefix via
    :meth:`add_prefix`) to either a JSON-shaped value, an Exception
    instance (raised), or a callable (invoked per request, with the path
    when it takes an argument). Unrouted paths raise ``ApiError`` with
    status 404, matching an apiserver's behaviour for absent CRDs.
    """

    #: Query parameters a paginated list request may carry and still be
    #: served by an :meth:`add_list` route.
    _LIST_PARAMS = frozenset({"limit", "continue", "fieldSelector", "resourceVersion"})

    def __init__(self, routes: Mapping[str, Any] | None = None) -> None:
        self.routes: dict[str, Any] = dict(routes or {})
        self._prefix_routes: list[tuple[str, Any]] = []
        self._list_routes: dict[str, Any] = {}
        self.calls: list[str] = []

    def add(self, path: str, response: Any) -> None:
        self.routes[path] = response

    def add_prefix(self, prefix: str, response: Any) -> None:
        self._prefix_routes.append((prefix, response))

    def add_list(self, path: str, items: list[Any]) -> None:
        """Serve a Kubernetes list at ``path`` honoring ``limit=`` /
        ``continue=`` pagination the way the apiserver does (continue
        tokens are plain offsets here). Requests with no ``limit`` get
        the whole list."""

        def respond(req_path: str) -> Any:
            query = urllib.parse.parse_qs(urllib.parse.urlparse(req_path).query)
            limit = int(query.get("limit", ["0"])[0] or 0)
            if not limit:
                return {"kind": "List", "items": list(items)}
            offset = int(query.get("continue", ["0"])[0] or 0)
            page = items[offset : offset + limit]
            next_offset = offset + limit
            metadata = (
                {"continue": str(next_offset)} if next_offset < len(items) else {}
            )
            return {"kind": "List", "metadata": metadata, "items": page}

        self._list_routes[path] = respond

    def _match_list_route(self, path: str) -> Any | None:
        parsed = urllib.parse.urlparse(path)
        respond = self._list_routes.get(parsed.path)
        if respond is None:
            return None
        params = set(urllib.parse.parse_qs(parsed.query))
        if params - self._LIST_PARAMS:
            return None
        return respond

    def request(self, path: str, timeout_s: float = DEFAULT_TIMEOUT_S) -> Any:
        self.calls.append(path)
        if path in self.routes:
            return self._resolve(path, self.routes[path])
        list_route = self._match_list_route(path)
        if list_route is not None:
            return self._resolve(path, list_route)
        for prefix, response in self._prefix_routes:
            if path.startswith(prefix):
                return self._resolve(path, response)
        raise ApiError(path, "HTTP 404", status=404)

    def _resolve(self, path: str, response: Any) -> Any:
        if isinstance(response, Exception):
            raise response
        if callable(response):
            # The call form is chosen by signature, not try/except — a
            # TypeError raised inside the callable must surface as the
            # real bug, not as a dispatch retry.
            try:
                takes_path = len(inspect.signature(response).parameters) >= 1
            except (TypeError, ValueError):  # builtins without signatures
                takes_path = False
            produced = response(path) if takes_path else response()
            return self._resolve(path, produced)
        return response
