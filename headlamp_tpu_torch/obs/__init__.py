"""Observability for the dashboard host: request span tracing with a
bounded trace ring (``trace``) and the metric registry behind
``/metricsz`` (``metrics``)."""
