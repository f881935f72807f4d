"""Text-mode CLI — the metrics page with its forecast, in a terminal.

``python -m headlamp_tpu_torch.cli metrics --demo large`` renders the
page the JAX package's CLI renders, through ``ui.vdom.render_text``,
with the forecast fit on the CUDA device and served by the fused CUDA
kernel. ``--device cpu`` runs the fit and the kernel's plain version on
the CPU instead. Without CUDA and without ``--device cpu`` it fails.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable

from .device import DeviceLike, resolve_device
from .metrics.client import fetch_tpu_metrics
from .models.service import compute_forecast
from .pages.metrics_page import metrics_page
from .server.demo import DEMO_FLEETS, make_demo_transport
from .transport.api_proxy import Transport
from .ui import render_text

#: CLI page name -> route path (the pages this package renders).
PAGES = {"metrics": "/tpu/metrics"}


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
    metrics = fetch_tpu_metrics(transport, clock=clock)
    forecast = compute_forecast(transport, metrics, clock=clock, device=dev)
    return render_text(metrics_page(metrics, forecast))


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="headlamp_tpu_torch.cli")
    parser.add_argument("page", choices=sorted(PAGES), nargs="?", default="metrics")
    parser.add_argument(
        "--demo", nargs="?", const="v5p32", choices=sorted(DEMO_FLEETS), default="v5p32"
    )
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args(argv)
    print(render_page(args.page, make_demo_transport(args.demo), device=args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
