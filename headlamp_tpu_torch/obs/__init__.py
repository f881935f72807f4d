"""Observability for the dashboard host: request span tracing with a
bounded trace ring (``trace``), the metric registry behind
``/metricsz`` (``metrics``), trace exemplars on its histograms
(``exemplars``, installed here), the SLO engine behind ``/sloz``
(``slo``), the flight recorder (``flight``), the sampling profiler
(``profiler``), the generation ledger (``ledger``), the graph cost
ledger, which sorts each device program's runs into captures, replays
and eager runs (``graphcost``), the host process's collections and CPU
as counters (``host``), and the HTML debug pages (``debug_pages``)."""

from . import exemplars as _exemplars

# Every traced histogram observe carries its request's trace id.
_exemplars.install()
