"""Entry point: ``python -m headlamp_tpu_torch.server --demo large``.

Serves a demo fleet's dashboard, its fleet rollup and forecast on the CUDA card,
until interrupted. ``--device cpu`` fits on the CPU with the kernel's
plain version instead; without CUDA and without ``--device cpu`` it
fails at startup and never serves.
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
    args = parser.parse_args(argv)

    app = DashboardApp(make_demo_transport(args.demo), device=args.device)
    server = app.serve(args.host, args.port)
    print(
        f"TPU dashboard on {server.url}/tpu "
        f"(demo fleet '{args.demo}', device {app.device})",
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
