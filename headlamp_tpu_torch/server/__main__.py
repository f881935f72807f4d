"""Entry point: ``python -m headlamp_tpu_torch.server --demo large``.

Serves a demo fleet's dashboard, its fleet rollup and forecast on the CUDA card,
until interrupted. ``--device cpu`` fits on the CPU with the kernel's
plain version instead; without CUDA and without ``--device cpu`` it
fails at startup and never serves. ``--background-sync SECONDS`` syncs
the cluster on a background thread with list+watch every SECONDS, so
page views stop paying for syncs and each new snapshot's fleet columns
reach the device off the request path.
"""

from __future__ import annotations

import argparse

from .app import DashboardApp
from .demo import DEMO_FLEETS, make_demo_transport


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(prog="headlamp_tpu_torch.server")
    parser.add_argument(
        "--demo", nargs="?", const="v5p32", choices=sorted(DEMO_FLEETS), default="v5p32"
    )
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8632)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument(
        "--background-sync", type=float, metavar="SECONDS", default=None,
        help="sync the cluster every SECONDS off the request path, with list+watch",
    )
    args = parser.parse_args(argv)

    app = DashboardApp(make_demo_transport(args.demo), device=args.device)
    if args.background_sync:
        app.start_background_sync(args.background_sync)
    server = app.serve(args.host, args.port)
    print(
        f"TPU dashboard on {server.url}/tpu "
        f"(demo fleet '{args.demo}', device {app.device}"
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
