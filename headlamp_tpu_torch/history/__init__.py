"""In-process history tier: the port's copy of ``headlamp_tpu/history``'s
store and its record and replay.

:mod:`.store` holds :class:`HistoryStore`, a bounded columnar store of
per-metric ring-buffer shards fed off the request path (the metrics
refresher's store hook and the cluster-sync loop) and read by the
``/tpu/trends`` page, the forecaster and ``/healthz``. Retention and
window math run on injected monotonic clocks only. :mod:`.record` tees a
transport's exchanges into a JSONL recording (:class:`RecordingTransport`)
and plays one back as a transport (:class:`ReplaySource`).
"""

from .record import (
    RECORDING_VERSION,
    Exchange,
    Recorder,
    Recording,
    RecordingTransport,
    ReplaySource,
    load_recording,
)
from .store import HistoryStore, active_store, set_active_store

__all__ = [
    "RECORDING_VERSION",
    "Exchange",
    "HistoryStore",
    "Recorder",
    "Recording",
    "RecordingTransport",
    "ReplaySource",
    "active_store",
    "load_recording",
    "set_active_store",
]
