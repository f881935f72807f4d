"""``/tpu/fleet`` at a slice's level: its totals and the rows below them."""

from benchmark.reference.fleet import check_fleet_page as check  # noqa: F401
