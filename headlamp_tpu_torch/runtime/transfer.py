"""Request-scoped device-to-host transfer accounting.

The port's copy of ``headlamp_tpu/runtime/transfer.py``. Every copy the
serving path makes from the card to the host goes through :func:`fetch`,
which buys two things:

1. **Counting.** :data:`transfer_stats` counts the blocking copies the
   process has paid, and the :class:`TransferBatch` of the current
   request counts its own: the number ``DashboardApp`` reports as
   ``last_request_device_gets``. Only a copy from a CUDA device counts;
   ``Tensor.cpu()`` of a CPU tensor copies nothing.
2. **Coalescing.** Stages of one request may register tensors in the
   batch; the first that needs a value flushes every tensor registered
   so far in one wave: one blocking wait for the stream, then the
   copies of finished results. Device work is asynchronous, so only the
   flush waits.

The batch rides a :mod:`contextvars` ContextVar, so under
``ThreadingHTTPServer`` each request thread sees only its own batch.
Without one (the CLI, tests, a background refit) :func:`fetch` is a
plain counted copy.
"""

from __future__ import annotations

import contextlib
import threading
from contextvars import ContextVar
from typing import Iterator

import torch

from ..obs import graphcost as _graphcost
from ..obs.metrics import registry as _metrics_registry
from ..obs.trace import span as _span


class TransferStats:
    """Process-wide transfer counters, stored in registry counters so
    /metricsz scrapes the same numbers /healthz reports."""

    def __init__(self) -> None:
        self._blocking = _metrics_registry.counter(
            "headlamp_tpu_torch_transfer_blocking_gets_total",
            "Blocking device-to-host copy waves paid by the process (copies from a CUDA device).",
        )
        self._coalesced = _metrics_registry.counter(
            "headlamp_tpu_torch_transfer_coalesced_trees_total",
            "Tensors that rode a flush alongside at least one other tensor.",
        )

    @property
    def blocking_gets(self) -> int:
        return int(self._blocking.value)

    @property
    def coalesced_trees(self) -> int:
        return int(self._coalesced.value)

    def record_blocking_get(self) -> None:
        self._blocking.inc()

    def record_coalesced(self, trees: int) -> None:
        self._coalesced.inc(trees)

    def snapshot(self) -> dict[str, int]:
        return {"blocking_gets": self.blocking_gets, "coalesced_trees": self.coalesced_trees}


transfer_stats = TransferStats()

_ACTIVE: ContextVar[TransferBatch | None] = ContextVar("hl_torch_transfer_batch", default=None)


def _counted_to_host(tensors: list[torch.Tensor], batch: TransferBatch | None) -> list[torch.Tensor]:
    """Copy ``tensors`` to the host; one blocking wave is counted when
    any of them lies on a CUDA device, and its bytes go to the graph
    cost ledger."""
    on_card = [t for t in tensors if t.device.type == "cuda"]
    if on_card:
        transfer_stats.record_blocking_get()
        if batch is not None:
            batch.blocking_gets += 1
        _graphcost.note_transfer(sum(t.numel() * t.element_size() for t in on_card))
    return [t.cpu() for t in tensors]


class _Handle:
    """One registered tensor's future host copy: ``result()`` flushes the
    owning batch on first access."""

    __slots__ = ("_batch", "_value", "_resolved")

    def __init__(self, batch: TransferBatch) -> None:
        self._batch = batch
        self._value: torch.Tensor = None  # type: ignore[assignment]
        self._resolved = False

    def result(self) -> torch.Tensor:
        if not self._resolved:
            self._batch.flush()
        return self._value


class TransferBatch:
    """All pending device-to-host copies of one request. :meth:`register`
    returns a handle; ``handle.result()`` or :meth:`flush` copies every
    pending tensor in one wave.

    A batch serves only the thread that opened its scope. A background
    refit started by the request runs in a copy of the request's context,
    but the request does not wait for it, so its copy is the process's,
    not the request's: :func:`fetch` on another thread ignores the
    batch."""

    def __init__(self) -> None:
        self._pending: list[tuple[torch.Tensor, _Handle]] = []
        self._owner: int | None = None
        #: Blocking waves paid while this batch was active: the
        #: per-request number.
        self.blocking_gets = 0

    def register(self, tensor: torch.Tensor) -> _Handle:
        handle = _Handle(self)
        self._pending.append((tensor, handle))
        return handle

    def flush(self) -> None:
        """Copy every pending tensor to the host in one wave."""
        pending, self._pending = self._pending, []
        if not pending:
            return
        with _span("transfer.flush", trees=len(pending)):
            values = _counted_to_host([t for t, _ in pending], self)
        if len(pending) > 1:
            transfer_stats.record_coalesced(len(pending))
        for (_, handle), value in zip(pending, values):
            handle._value = value
            handle._resolved = True

    @contextlib.contextmanager
    def scope(self) -> Iterator[TransferBatch]:
        """Install this batch for the calling thread's context; flush
        leftovers on exit, so no handle outlives the request unresolved."""
        token = _ACTIVE.set(self)
        self._owner = threading.get_ident()
        try:
            yield self
        finally:
            _ACTIVE.reset(token)
            self._owner = None
            self.flush()


def fetch(tensor: torch.Tensor) -> torch.Tensor:
    """THE serving-path copy to the host: joins the request's batch when
    one is active on this thread, a plain counted copy otherwise."""
    batch = _ACTIVE.get()
    if batch is None or batch._owner != threading.get_ident():
        return _counted_to_host([tensor], None)[0]
    return batch.register(tensor).result()
