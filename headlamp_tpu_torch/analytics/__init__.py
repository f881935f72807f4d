"""Analytics — columnar fleet encoding and the fleet and region rollups
on the device.

The port of ``headlamp_tpu/analytics``: snapshots encode once into
fixed-shape columns (``encode``), and every aggregate the overview needs
comes out of one rollup of torch ops on the columns' device
(``fleet_torch``), dispatched by the measured-winner policy in
``stats``. The viewport tree's per-cluster and per-slice sums come out of
the region rollup over the same columns (``fleet_torch.region_rollup``).
The trend page's per-series statistics come out of one batched program
(``trends.series_stats_batch``; ``series_stats`` is one series').
"""

from .encode import GENERATION_IDS, PHASE_IDS, FleetArrays, encode_fleet
from .fleet_torch import fleet_rollup, region_rollup, rollup_to_dict
from .trends import series_stats

__all__ = [
    "FleetArrays",
    "GENERATION_IDS",
    "PHASE_IDS",
    "encode_fleet",
    "fleet_rollup",
    "region_rollup",
    "rollup_to_dict",
    "series_stats",
]
