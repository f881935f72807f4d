"""Text-mode CLI — the dashboard's pages in a terminal.

``python -m headlamp_tpu_torch.cli overview --demo large`` renders the
page the JAX package's CLI renders, through ``ui.vdom.render_text``:
``overview``, ``nodes``, ``pods``, ``deviceplugins``, ``topology``,
``intel``, ``intel-nodes``, ``intel-pods``, ``intel-deviceplugins`` and
``cluster-nodes`` (the native nodes table with the TPU and Intel
columns) from one synced cluster snapshot (the Overview's aggregates
from the fleet rollup on the CUDA device), ``metrics`` with the forecast
fit on the CUDA device and served by the fused CUDA kernel, and
``intel-metrics`` from the i915 power series (``--demo mixed`` has both
providers). ``--device cpu``
runs the rollup, the fit and the kernel's plain version on the CPU
instead. Without CUDA and without ``--device cpu`` it fails.
``--apiserver URL`` or ``--in-cluster`` reads a real cluster over the
pooled ``KubeTransport`` instead of a demo fleet.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable

from .context.accelerator_context import AcceleratorDataContext
from .device import DeviceLike, resolve_device
from .metrics.client import fetch_tpu_metrics
from .metrics.intel_client import fetch_intel_gpu_metrics
from .models.service import compute_forecast
from .registration import register_plugin
from .server.demo import add_mode_arguments, transport_from_args
from .transport.api_proxy import Transport
from .ui import render_text

#: CLI page name -> route path (the pages this package renders).
PAGES = {
    "overview": "/tpu",
    "nodes": "/tpu/nodes",
    "pods": "/tpu/pods",
    "deviceplugins": "/tpu/deviceplugins",
    "topology": "/tpu/topology",
    "metrics": "/tpu/metrics",
    "intel": "/intel",
    "intel-nodes": "/intel/nodes",
    "intel-pods": "/intel/pods",
    "intel-deviceplugins": "/intel/deviceplugins",
    "intel-metrics": "/intel/metrics",
    "cluster-nodes": "/nodes",
}


def render_page(
    page: str,
    transport: Transport,
    *,
    clock: Callable[[], float] = time.time,
    device: DeviceLike = None,
) -> str:
    """Render one page to text against a transport (exposed for tests).

    ``clock`` is wall time on purpose: every use is a displayed
    timestamp or a Prometheus query-range bound."""
    if page not in PAGES:
        raise ValueError(f"unknown page {page!r}: choose from {sorted(PAGES)}")
    dev = resolve_device(device)
    registry = register_plugin()
    route = registry.route_for(PAGES[page])
    assert route is not None
    if route.kind == "metrics":
        metrics = fetch_tpu_metrics(transport, clock=clock)
        forecast = compute_forecast(transport, metrics, clock=clock, device=dev)
        return render_text(route.component(metrics, forecast))
    if route.kind == "intel-metrics":
        return render_text(route.component(fetch_intel_gpu_metrics(transport, clock=clock)))
    snap = AcceleratorDataContext(transport, device=dev, clock=clock).sync()
    if route.kind == "topology":
        return render_text(route.component(snap))
    if route.kind == "native-nodes":
        return render_text(route.component(snap, now=clock(), registry=registry))
    return render_text(route.component(snap, now=clock()))


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="headlamp_tpu_torch.cli")
    parser.add_argument("page", choices=sorted(PAGES), nargs="?", default="overview")
    add_mode_arguments(parser)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args(argv)
    transport, _mode = transport_from_args(parser, args)
    print(render_page(args.page, transport, device=args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
