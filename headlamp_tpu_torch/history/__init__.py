"""In-process history tier: the port's copy of ``headlamp_tpu/history``'s
store.

:mod:`.store` holds :class:`HistoryStore`, a bounded columnar store of
per-metric ring-buffer shards fed off the request path (the metrics
refresher's store hook and the cluster-sync loop) and read by the
``/tpu/trends`` page, the forecaster and ``/healthz``. Retention and
window math run on injected monotonic clocks only.
"""

from .store import HistoryStore, active_store, set_active_store

__all__ = ["HistoryStore", "active_store", "set_active_store"]
