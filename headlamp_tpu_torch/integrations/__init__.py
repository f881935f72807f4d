"""Native-view integrations.

The port's copy of ``headlamp_tpu/integrations``. The reference injects
accelerator context into Headlamp's own Node and Pod detail pages and
Nodes table (`NodeDetailSection.tsx`, `PodDetailSection.tsx`,
`integrations/NodeColumns.tsx`). These are the same injections for both
providers: for TPU and for Intel GPU, a section for a single Node, a
section for a single Pod, and extra Nodes-table columns — each guarded
to render nothing for the other provider's resources.
"""

from .intel_views import (
    build_node_intel_columns,
    intel_node_detail_section,
    intel_pod_detail_section,
)
from .node_columns import build_node_tpu_columns
from .node_detail import node_detail_section
from .pod_detail import pod_detail_section

__all__ = [
    "build_node_intel_columns",
    "build_node_tpu_columns",
    "intel_node_detail_section",
    "intel_pod_detail_section",
    "node_detail_section",
    "pod_detail_section",
]
