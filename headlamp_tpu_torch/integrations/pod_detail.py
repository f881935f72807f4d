"""Pod detail-page injection.

The port's copy of ``headlamp_tpu/integrations/pod_detail.py``
(`PodDetailSection.tsx`): pure props — it takes only the pod being
viewed, no context (`:25`). Returns None for pods that request no TPU
(`:31`); otherwise rows per container with the TPU request and limit,
plus the phase, node and chip-count summary (`:57-111`).
"""

from __future__ import annotations

from typing import Any

from ..domain import objects as obj
from ..domain import tpu
from ..domain.constants import TPU_RESOURCE
from ..pages.common import phase_label
from ..ui import NameValueTable, SectionBox
from ..ui.vdom import Element
from .common import unwrap_json_data


def pod_detail_section(pod: Any) -> Element | None:
    pod = unwrap_json_data(pod)
    if not tpu.is_tpu_requesting_pod(pod):
        return None

    container_rows: list[tuple[str, Any]] = []
    tpu_containers = 0
    for c in obj.pod_containers(pod):
        req = obj.parse_int(obj.container_requests(c).get(TPU_RESOURCE))
        lim = obj.parse_int(obj.container_limits(c).get(TPU_RESOURCE))
        if req or lim:
            tpu_containers += 1
            container_rows.append(
                (f"{c.get('name', '?')} → google.com/tpu", f"request {req} / limit {lim}")
            )

    return SectionBox(
        "TPU",
        NameValueTable(
            [
                ("Phase", phase_label(pod)),
                ("Node", obj.pod_node_name(pod) or "—"),
                ("TPU containers", tpu_containers),
                ("Effective chips", tpu.format_chip_count(tpu.get_pod_chip_request(pod))),
                *container_rows,
            ]
        ),
        class_="hl-pod-detail",
    )
