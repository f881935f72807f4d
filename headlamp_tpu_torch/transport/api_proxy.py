"""Kubernetes API transport: the ``ApiProxy.request`` contract.

Every cluster call goes through one function, ``request(path) -> parsed
JSON``, as in the reference plugin. This module carries the slice of the
JAX package's transport that the dashboard needs:

- :class:`Transport` — the protocol (``request(path, timeout_s)``; a
  transport that can also ``watch(path, timeout_s)`` serves the
  list+watch protocol).
- :class:`WatchFeed` — mock apiserver state for one watchable list:
  paginated LISTs stamped with a ``resourceVersion``, watch deltas since
  a cursor, 410 Gone after :meth:`WatchFeed.compact`.
- :func:`with_timeout` — a hard wall-clock cap on any callable (the
  reference's ``withTimeout``).
- :class:`KubeTransport` — real HTTP against an apiserver base URL
  (``kubectl proxy``, or in-cluster with the service account's bearer
  token), over the keep-alive :class:`~headlamp_tpu_torch.transport.pool.ConnectionPool`,
  so repeated calls reuse sockets instead of paying a handshake each.
- :class:`MockTransport` — the test and demo double: path -> canned
  response / exception / callable, with call recording, failure
  overrides and watchable lists.
"""

from __future__ import annotations

import contextvars
import http.client
import inspect
import json
import ssl
import threading
import urllib.parse
from typing import Any, Callable, Mapping, Protocol

from ..obs.metrics import registry as _metrics_registry
from .pool import ConnectionPool, PoolExhausted

#: Default per-request timeout (the reference's 2 000 ms).
DEFAULT_TIMEOUT_S = 2.0


class ApiError(Exception):
    """A request failed (HTTP error, bad JSON, connection refused)."""

    def __init__(self, path: str, message: str, status: int | None = None) -> None:
        super().__init__(f"{path}: {message}")
        self.path = path
        self.status = status


class RequestTimeout(ApiError):
    """The request exceeded its wall-clock budget."""

    def __init__(self, path: str, timeout_s: float) -> None:
        super().__init__(path, f"timed out after {timeout_s:g}s")
        self.timeout_s = timeout_s


class Transport(Protocol):
    """Single entry point for cluster JSON requests."""

    def request(self, path: str, timeout_s: float = DEFAULT_TIMEOUT_S) -> Any:
        """GET ``path`` and return parsed JSON. Raises :class:`ApiError`
        (or :class:`RequestTimeout`) on failure; never returns partial
        data."""
        ...


class WatchTransport(Protocol):
    """Optional transport extension: a bounded Kubernetes watch. The
    request (``?watch=true&resourceVersion=N&timeoutSeconds=S``) is a GET
    whose body is newline-delimited JSON events the apiserver streams
    until ``timeoutSeconds`` elapse, served as a batch delta poll. The
    context re-lists when a transport lacks this method."""

    def watch(self, path: str, timeout_s: float = DEFAULT_TIMEOUT_S) -> list[Any]:
        """The stream's parsed events in arrival order. Raises
        :class:`ApiError` on failure (410 means the caller re-lists)."""
        ...


_ABANDONED = _metrics_registry.counter(
    "headlamp_tpu_torch_transport_abandoned_calls_total",
    "Calls with_timeout gave up on; each keeps running on its own thread to its end.",
)


def with_timeout(fn: Callable[[], Any], timeout_s: float, path: str = "") -> Any:
    """Run ``fn`` with a hard wall-clock cap (the reference's
    ``withTimeout``). On expiry raise :class:`RequestTimeout`; the
    abandoned call runs on in its daemon thread, counted in
    ``headlamp_tpu_torch_transport_abandoned_calls_total``, and its result
    is dropped. One fresh thread per call, not a shared pool: a socket
    timeout does not cover DNS resolution, and a stalled resolver would
    exhaust a bounded pool. The call runs under the caller's copied
    contextvars, so the pool's spans land in the request's trace."""
    outcome: dict[str, Any] = {}
    ctx = contextvars.copy_context()

    def runner() -> None:
        try:
            outcome["value"] = ctx.run(fn)
        except BaseException as e:  # noqa: BLE001 — re-raised in the caller
            outcome["error"] = e

    thread = threading.Thread(target=runner, daemon=True, name="hl-torch-timeout")
    thread.start()
    thread.join(timeout_s)
    if thread.is_alive():
        _ABANDONED.inc()
        raise RequestTimeout(path, timeout_s)
    if "error" in outcome:
        raise outcome["error"]
    return outcome.get("value")


class KubeTransport:
    """Real apiserver transport over pooled keep-alive HTTP.

    ``base_url`` is ``http://127.0.0.1:8001`` behind ``kubectl proxy`` (no
    auth), or ``https://kubernetes.default.svc`` in a pod with the service
    account's ``bearer_token`` and ``ca_cert``. Every request runs over
    :attr:`pool` (one per transport, injectable), so a warm scrape→paint
    reuses the sockets the previous one opened. The response is closed on
    every exit path, the non-2xx raises included."""

    #: The service account's mount inside a pod.
    SERVICE_ACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

    def __init__(
        self,
        base_url: str,
        *,
        bearer_token: str | None = None,
        ca_cert: str | None = None,
        insecure_skip_verify: bool = False,
        pool: ConnectionPool | None = None,
    ) -> None:
        self.base_url = base_url.rstrip("/")
        self.pool = pool if pool is not None else ConnectionPool()
        self._headers: dict[str, str] = {"Accept": "application/json"}
        if bearer_token:
            self._headers["Authorization"] = f"Bearer {bearer_token}"
        self._ssl_context: ssl.SSLContext | None = None
        if ca_cert:
            self._ssl_context = ssl.create_default_context(cafile=ca_cert)
        elif insecure_skip_verify:
            ctx = ssl.create_default_context()
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
            self._ssl_context = ctx

    @classmethod
    def in_cluster(cls) -> KubeTransport:
        """Build from the standard in-cluster service-account mount."""
        sa = cls.SERVICE_ACCOUNT_DIR
        with open(f"{sa}/token", encoding="utf-8") as f:
            token = f.read().strip()
        return cls("https://kubernetes.default.svc", bearer_token=token, ca_cert=f"{sa}/ca.crt")

    def _url(self, path: str) -> str:
        return self.base_url + (path if path.startswith("/") else "/" + path)

    def request(self, path: str, timeout_s: float = DEFAULT_TIMEOUT_S) -> Any:
        url = self._url(path)

        def do_request() -> Any:
            try:
                with self.pool.request(
                    url, headers=self._headers, timeout_s=timeout_s, context=self._ssl_context
                ) as resp:
                    # Read the body before the status check: a drained
                    # response is what returns the connection to the pool.
                    body = resp.read()
                    if not 200 <= resp.status < 300:
                        raise ApiError(path, f"HTTP {resp.status}", status=resp.status)
            except PoolExhausted as e:
                raise ApiError(path, f"connection pool exhausted: {e}") from e
            except (OSError, http.client.HTTPException) as e:
                # Refused connect, reset mid-read, truncated chunk, TLS
                # failure: callers see ApiError, never a socket exception.
                raise ApiError(path, f"request failed: {e}") from e
            try:
                return json.loads(body)
            except json.JSONDecodeError as e:
                raise ApiError(path, f"invalid JSON: {e}") from e

        return with_timeout(do_request, timeout_s, path)

    def watch(self, path: str, timeout_s: float = DEFAULT_TIMEOUT_S) -> list[Any]:
        """Bounded watch: read the NDJSON event stream until the server
        closes it (after the ``timeoutSeconds`` the caller put in
        ``path``). ``timeout_s`` is the client's budget and must exceed
        the server's window."""
        url = self._url(path)

        def do_request() -> list[Any]:
            events: list[Any] = []
            try:
                with self.pool.request(
                    url, headers=self._headers, timeout_s=timeout_s, context=self._ssl_context
                ) as resp:
                    if not 200 <= resp.status < 300:
                        resp.read()
                        raise ApiError(path, f"HTTP {resp.status}", status=resp.status)
                    for raw in resp:
                        line = raw.strip()
                        if line:
                            events.append(json.loads(line))
            except PoolExhausted as e:
                raise ApiError(path, f"connection pool exhausted: {e}") from e
            except (OSError, http.client.HTTPException) as e:
                # A stream cut mid-body surfaces as ApiError, so the
                # context falls back to a re-list.
                raise ApiError(path, f"watch stream failed: {e}") from e
            except json.JSONDecodeError as e:
                raise ApiError(path, f"invalid watch JSON: {e}") from e
            return events

        return with_timeout(do_request, timeout_s, path)


class WatchFeed:
    """Mock apiserver state for one watchable list: current objects plus
    a bounded event log keyed by resourceVersion. Tests and the demo
    mutate it with :meth:`push`; the paginated LIST response and the
    watch-delta response both derive from it, so a context driven
    against it sees the list+watch protocol contract (including 410
    Gone after :meth:`compact`)."""

    def __init__(self, items: list[Any], resource_version: int = 1000) -> None:
        self._items: dict[str, Any] = {}
        for item in items:
            self._items[self._uid(item)] = item
        self.resource_version = int(resource_version)
        #: (resource_version, event) pairs, oldest first.
        self.events: list[tuple[int, dict]] = []
        #: Oldest resourceVersion still replayable; watches asking for
        #: anything older get the apiserver's 410 Gone ERROR event.
        self.oldest_retained = int(resource_version)

    @staticmethod
    def _uid(item: Any) -> str:
        metadata = item.get("metadata", {}) if isinstance(item, Mapping) else {}
        return str(metadata.get("uid") or metadata.get("name") or id(item))

    def push(self, event_type: str, obj: Any) -> None:
        """Record an ADDED/MODIFIED/DELETED/BOOKMARK event; object events
        also apply to the current state (BOOKMARK only advances the
        resourceVersion, as the apiserver's does)."""
        self.resource_version += 1
        if event_type == "DELETED":
            self._items.pop(self._uid(obj), None)
        elif event_type != "BOOKMARK":
            self._items[self._uid(obj)] = obj
        self.events.append((self.resource_version, {"type": event_type, "object": obj}))

    def compact(self) -> None:
        """Forget the event log: later watches from any older
        resourceVersion get 410 Gone, forcing the client's re-list (the
        apiserver does this when its watch cache window expires)."""
        self.oldest_retained = self.resource_version
        self.events.clear()

    def list_response(self, req_path: str) -> Any:
        """Kubernetes LIST honoring ``limit``/``continue`` pagination,
        stamped with the feed's current resourceVersion."""
        items = list(self._items.values())
        query = urllib.parse.parse_qs(urllib.parse.urlparse(req_path).query)
        limit = int(query.get("limit", ["0"])[0] or 0)
        metadata: dict[str, Any] = {"resourceVersion": str(self.resource_version)}
        if not limit:
            return {"kind": "List", "metadata": metadata, "items": items}
        offset = int(query.get("continue", ["0"])[0] or 0)
        page = items[offset : offset + limit]
        next_offset = offset + limit
        if next_offset < len(items):
            metadata["continue"] = str(next_offset)
        return {"kind": "List", "metadata": metadata, "items": page}

    def events_since(self, resource_version: str) -> list[Any]:
        """The watch response for ``resourceVersion=N``: every event
        newer than N, or a single 410 ERROR event when N predates the
        retained window."""
        try:
            rv = int(resource_version)
        except (TypeError, ValueError):
            rv = 0
        if rv < self.oldest_retained:
            return [
                {
                    "type": "ERROR",
                    "object": {
                        "kind": "Status",
                        "code": 410,
                        "reason": "Expired",
                        "message": f"too old resource version: {rv}",
                    },
                }
            ]
        out: list[Any] = []
        for ev_rv, event in self.events:
            if ev_rv <= rv:
                continue
            # Stamp each event object's resourceVersion as the apiserver
            # does: clients advance their cursor from it.
            obj = dict(event["object"]) if isinstance(event["object"], Mapping) else {}
            metadata = dict(obj.get("metadata", {}))
            metadata["resourceVersion"] = str(ev_rv)
            obj["metadata"] = metadata
            out.append({"type": event["type"], "object": obj})
        return out


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
        self._overrides: list[tuple[str, Any]] = []
        self._watch_feeds: dict[str, WatchFeed] = {}
        self.calls: list[str] = []
        self.watch_calls: list[str] = []

    def add(self, path: str, response: Any) -> None:
        self.routes[path] = response

    def add_prefix(self, prefix: str, response: Any) -> None:
        self._prefix_routes.append((prefix, response))

    def add_override(self, prefix: str, response: Any) -> None:
        """Route checked before everything else (last registered wins):
        the hook for breaking an endpoint whatever its pagination. A
        query-less prefix matches the endpoint itself and its
        limit/continue/fieldSelector forms, but not selector sub-queries
        (``?labelSelector=``), which are fallback paths with routes of
        their own; break those with an explicit ``?labelSelector``
        prefix. Watch requests match any override by plain prefix."""
        self._overrides.append((prefix, response))

    def _override_matches(self, path: str, prefix: str) -> bool:
        if "?" in prefix:
            return path.startswith(prefix)
        parsed = urllib.parse.urlparse(path)
        if not parsed.path.startswith(prefix):
            return False
        params = set(urllib.parse.parse_qs(parsed.query))
        return not (params - self._LIST_PARAMS)

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

    def add_watchable_list(
        self, path: str, items: list[Any], resource_version: int = 1000
    ) -> WatchFeed:
        """Serve ``path`` as a live list+watch source: LIST requests get
        paginated responses stamped with the feed's resourceVersion,
        watch requests get the deltas pushed since the requested cursor.
        Returns the :class:`WatchFeed`; mutate it with ``push`` /
        ``compact`` to drive a scenario."""
        feed = WatchFeed(items, resource_version)
        self._list_routes[path] = feed.list_response
        self._watch_feeds[path] = feed
        return feed

    def watch(self, path: str, timeout_s: float = DEFAULT_TIMEOUT_S) -> list[Any]:
        """Watch requests route like any other (overrides and exact
        routes can inject failures), then fall through to the endpoint's
        :class:`WatchFeed`. No feed: 404, which a caller treats as
        "watch unsupported, re-list"."""
        self.watch_calls.append(path)
        for prefix, response in reversed(self._overrides):
            if path.startswith(prefix):
                return self._resolve(path, response)
        if path in self.routes:
            return self._resolve(path, self.routes[path])
        parsed = urllib.parse.urlparse(path)
        feed = self._watch_feeds.get(parsed.path)
        if feed is not None:
            query = urllib.parse.parse_qs(parsed.query)
            return feed.events_since(query.get("resourceVersion", ["0"])[0])
        raise ApiError(path, "HTTP 404", status=404)

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
        for prefix, response in reversed(self._overrides):
            if self._override_matches(path, prefix):
                return self._resolve(path, response)
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
