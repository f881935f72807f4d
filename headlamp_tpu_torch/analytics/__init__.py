"""Analytics — columnar fleet encoding and the fleet rollup on the device.

The port of ``headlamp_tpu/analytics``: snapshots encode once into
fixed-shape columns (``encode``), and every aggregate the overview needs
comes out of one rollup of torch ops on the columns' device
(``fleet_torch``), dispatched by the measured-winner policy in
``stats``.
"""

from .encode import GENERATION_IDS, PHASE_IDS, FleetArrays, encode_fleet
from .fleet_torch import fleet_rollup, rollup_to_dict

__all__ = [
    "FleetArrays",
    "GENERATION_IDS",
    "PHASE_IDS",
    "encode_fleet",
    "fleet_rollup",
    "rollup_to_dict",
]
