"""Entry point: ``python -m headlamp_tpu_torch.server``.

Modes:
- ``--demo [v5e4|v5p32|large|…]`` — a demo fleet, no cluster (the
  default, ``v5p32``, when no other mode is given);
- ``--apiserver URL`` — a real apiserver (``http://127.0.0.1:8001`` behind
  ``kubectl proxy``), over a pooled keep-alive ``KubeTransport``;
- ``--in-cluster`` — inside a pod, with the service account's token.

Serves the dashboard, its fleet rollup and forecast on the CUDA card,
until interrupted; every GET goes through the request gateway.
``--device cpu`` fits on the CPU with the kernel's plain version instead;
without CUDA and without ``--device cpu`` it fails at startup and never
serves. ``--background-sync SECONDS`` syncs the cluster on a background
thread with list+watch every SECONDS, so page views stop paying for
syncs and each new snapshot's fleet columns reach the device off the
request path. ``--active-pods-only`` drops Succeeded and Failed pods from
the pod list at the apiserver.
"""

from __future__ import annotations

import argparse

from ..context.sources import ACTIVE_PODS_FIELD_SELECTOR
from .app import DashboardApp
from .demo import add_mode_arguments, transport_from_args


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(prog="headlamp_tpu_torch.server")
    add_mode_arguments(parser)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8632)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument(
        "--background-sync", type=float, metavar="SECONDS", default=None,
        help="sync the cluster every SECONDS off the request path, with list+watch",
    )
    parser.add_argument(
        "--active-pods-only", action="store_true",
        help="server-side fieldSelector dropping Succeeded/Failed pods from the pod list",
    )
    args = parser.parse_args(argv)

    transport, mode = transport_from_args(parser, args)
    app = DashboardApp(
        transport, device=args.device,
        pod_field_selector=ACTIVE_PODS_FIELD_SELECTOR if args.active_pods_only else None,
    )
    if args.background_sync:
        app.start_background_sync(args.background_sync)
    server = app.serve(args.host, args.port)
    print(
        f"TPU dashboard on {server.url}/tpu ({mode}, device {app.device}"
        + (f", background sync every {args.background_sync:g} s" if args.background_sync else "")
        + ")",
        flush=True,
    )
    try:
        server.wait()
    except KeyboardInterrupt:  # top of the process: a clean stop is the handling
        pass
    finally:
        server.close()


if __name__ == "__main__":
    main()
