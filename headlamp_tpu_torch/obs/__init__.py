"""Observability for the dashboard host: request span tracing with a
bounded trace ring (``trace``), the metric registry behind
``/metricsz`` (``metrics``) and the graph cost ledger, which sorts each
device program's runs into captures, replays and eager runs
(``graphcost``)."""
