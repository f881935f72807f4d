"""headlamp_tpu_torch — the dashboard's metrics-page forecast on PyTorch and CUDA.

The PyTorch counterpart of ``headlamp_tpu``, built for an NVIDIA H100.
Module paths mirror the JAX package (``metrics/client.py`` here is
``headlamp_tpu/metrics/client.py`` there); the JAX package stays the
reference and nothing here imports it or JAX.

- ``device``     — device policy: entry points run on CUDA unless the
                   caller asks for the CPU.
- ``models``     — the utilization forecaster (``nn.Module``, explicit
                   Adam fit, warm starts) and its fused inference kernel.
- ``kernels``    — hand-written CUDA C++ for ``sm_90a`` and its build step.
- ``transport``  — the ``Transport`` protocol and ``MockTransport``.
- ``fleet``      — deterministic TPU fleet fixtures.
- ``metrics``    — Prometheus client: discovery, batched instant queries,
                   range-query utilization history.
- ``server``     — demo transports with synthetic Prometheus series.
- ``ui``/``pages`` — element tree, components and the metrics page.
- ``cli``        — ``python -m headlamp_tpu_torch.cli metrics --demo large``.
"""
