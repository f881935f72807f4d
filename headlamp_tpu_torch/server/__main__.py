"""Entry point: ``python -m headlamp_tpu_torch.server``.

Modes:
- ``--demo [v5e4|v5p32|mixed|large]`` — a demo fleet, no cluster (the
  default, ``v5p32``, when no other mode is given);
- ``--apiserver URL`` — a real apiserver (``http://127.0.0.1:8001`` behind
  ``kubectl proxy``), over a pooled keep-alive ``KubeTransport``;
- ``--in-cluster`` — inside a pod, with the service account's token.

Read-tier roles and multi-process serving:
- ``--replication-leader`` — publish every snapshot generation on
  ``GET /replicate/bus``, with leader election on an in-process lease
  store (the elected term's fencing token floors the generations);
- ``--replica LEADER_URL`` — no cluster access: consume the bus of the
  leader at LEADER_URL and serve every page, ``/events``, the ETags and
  the 304s from the records it applies. It excludes the cluster modes,
  ``--replication-leader`` and ``--background-sync``;
- ``--workers N`` — this process becomes the supervisor: it syncs the
  cluster mode's transport in the background (every ``--background-sync``
  seconds, default 2), publishes each generation into a shared-memory
  segment and an internal bus, and N worker processes (started with
  ``spawn``) serve the public port from it, each on the card. It excludes
  ``--replica`` and ``--replication-leader``.

Serves the dashboard, its fleet rollup and forecast on the CUDA card,
until interrupted; every GET goes through the request gateway.
``--device cpu`` fits on the CPU with the kernel's plain version instead;
without CUDA and without ``--device cpu`` it fails at startup and never
serves. ``--background-sync SECONDS`` syncs the cluster on a background
thread with list+watch every SECONDS, so page views stop paying for
syncs and each new snapshot's fleet columns reach the device off the
request path. ``--active-pods-only`` drops Succeeded and Failed pods from
the pod list at the apiserver. Every mode, a replica's and each
worker's too, takes ``--device``.
"""

from __future__ import annotations

import argparse

from ..context.sources import ACTIVE_PODS_FIELD_SELECTOR
from ..replicate import (
    BusConsumer,
    BusPublisher,
    LeaderElector,
    LeaseStore,
    ReplicaApp,
    generation_floor,
    pool_fetch,
)
from ..workers import run_supervisor
from .app import DashboardApp, DashboardServer
from .demo import add_mode_arguments, transport_from_args


def _serve_until_interrupted(server: DashboardServer, banner: str) -> None:
    print(banner, flush=True)
    try:
        server.wait()
    except KeyboardInterrupt:  # analysis: disable=EXC001
        pass  # top of the process: a clean stop is the handling
    finally:
        server.close()


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
    parser.add_argument(
        "--replication-leader", action="store_true",
        help="publish snapshot generations on /replicate/bus for read replicas",
    )
    parser.add_argument(
        "--replica", metavar="LEADER_URL", default=None,
        help="serve as a read replica of the leader at LEADER_URL (no cluster access)",
    )
    parser.add_argument(
        "--workers", type=int, metavar="N", default=None,
        help="serve with N worker processes over a shared-memory snapshot plane; this "
        "process becomes the supervisor and leader",
    )
    args = parser.parse_args(argv)

    if args.replica:
        if (args.demo or args.apiserver or args.in_cluster or args.replication_leader
                or args.background_sync or args.active_pods_only):
            parser.error("--replica excludes the cluster modes, --replication-leader "
                         "and --background-sync")
        if args.workers:
            parser.error("--replica excludes --workers (workers are replicas)")
        replica = ReplicaApp(device=args.device)
        try:
            BusConsumer(replica, pool_fetch(args.replica)).start()
            server = replica.serve(args.host, args.port)
        except BaseException:
            replica.close()  # no server whose close() would; stops the consumer
            raise
        # The server's close() closes the replica, which stops the consumer.
        _serve_until_interrupted(
            server,
            f"TPU dashboard replica on {server.url}/tpu (bus {args.replica}, "
            f"device {replica.device})",
        )
        return

    transport, mode = transport_from_args(parser, args)
    selector = ACTIVE_PODS_FIELD_SELECTOR if args.active_pods_only else None
    if args.workers:
        if args.replication_leader:
            parser.error("--workers excludes --replication-leader: the supervisor already "
                         "publishes (its internal bus feeds the workers)")

        def leader_app() -> DashboardApp:
            return DashboardApp(transport, device=args.device, pod_field_selector=selector)

        kwargs = {"sync_interval_s": args.background_sync} if args.background_sync else {}
        run_supervisor(leader_app, host=args.host, port=args.port, workers=args.workers,
                       device=args.device, **kwargs)
        return

    app = DashboardApp(transport, device=args.device, pod_field_selector=selector)
    elector = server = None
    try:
        if args.replication_leader:
            publisher = BusPublisher(note=f"{args.host}:{args.port}", ledger=app.ledger)
            app.replication = publisher

            def elected(fencing: int) -> None:
                # The term's band: its generations outrank every earlier term's.
                publisher.set_fencing(fencing)
                app._ctx.advance_generation_floor(generation_floor(fencing))

            elector = LeaderElector(
                LeaseStore(), f"{args.host}:{args.port}", on_elected=elected, ledger=app.ledger
            )
            publisher.elector = elector
            elector.tick()
            elector.start()
            mode += ", replication leader"
        if args.background_sync:
            app.start_background_sync(args.background_sync)
        server = app.serve(args.host, args.port)
        _serve_until_interrupted(
            server,
            f"TPU dashboard on {server.url}/tpu ({mode}, device {app.device}"
            + (f", background sync every {args.background_sync:g} s" if args.background_sync
               else "")
            + ")",
        )
    finally:
        if elector is not None:
            elector.stop()
            elector.resign()
        if server is None:
            app.close()  # the server's close() closes it otherwise


if __name__ == "__main__":
    main()
