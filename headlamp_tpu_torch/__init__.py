"""headlamp_tpu_torch — the dashboard's metrics page and its forecast on PyTorch and CUDA.

The PyTorch counterpart of ``headlamp_tpu``, built for an NVIDIA H100.
Module paths mirror the JAX package (``metrics/client.py`` here is
``headlamp_tpu/metrics/client.py`` there); the JAX package stays the
reference and nothing here imports it or JAX.

- ``device``     — device policy: entry points run on CUDA unless the
                   caller asks for the CPU.
- ``models``     — the utilization forecaster (``nn.Module``, explicit
                   Adam fit, warm starts) and its fused inference kernel.
- ``kernels``    — hand-written CUDA C++ for ``sm_90a`` and its build step.
- ``transport``  — the ``Transport`` protocol, ``KubeTransport`` over a
                   keep-alive ``ConnectionPool`` with RTT-aware fan-out,
                   ``MockTransport`` and the ``WatchFeed`` behind its
                   watchable lists.
- ``gateway``    — the request gateway in front of the host: bounded
                   priority render pool, burn-rate shedding, coalescing.
- ``push``       — the ETag, ``If-None-Match`` and gzip helpers.
- ``fleet``      — deterministic TPU fleet fixtures.
- ``metrics``    — Prometheus client: discovery, batched instant queries,
                   range-query utilization history.
- ``server``     — the HTTP dashboard host
                   (``python -m headlamp_tpu_torch.server --demo large``,
                   ``--apiserver URL``, ``--in-cluster``,
                   ``--background-sync SECONDS`` for the list+watch loop),
                   demo transports with synthetic Prometheus series and a
                   local stand-in apiserver (``server/standin.py``).
- ``history``    — the bounded history store behind ``/tpu/trends`` and
                   the history-first forecast.
- ``runtime``    — stale-while-revalidate refresher, warm-carry store and
                   device-to-host transfer funnel behind the host.
- ``obs``        — request tracing, the ``/metricsz`` registry, the SLO
                   engine and the incident timeline (``/debug/incidentz``).
- ``scenarios``  — the incident drills on scripted clocks (``run_scenario``).
- ``registration`` — the routes the host serves.
- ``ui``/``pages`` — element tree, components and the metrics page.
- ``cli``        — ``python -m headlamp_tpu_torch.cli metrics --demo large``.
"""
