"""Native-view integrations.

The port's copy of the TPU half of ``headlamp_tpu/integrations``. The
reference injects accelerator context into Headlamp's own Node and Pod
detail pages and Nodes table (`NodeDetailSection.tsx`,
`PodDetailSection.tsx`, `integrations/NodeColumns.tsx`). These are the
same injections for TPU: a section for a single Node, a section for a
single Pod, and extra Nodes-table columns — each guarded to render
nothing for non-TPU resources. The Intel views come with the Intel
pages.
"""

from .node_columns import build_node_tpu_columns
from .node_detail import node_detail_section
from .pod_detail import pod_detail_section

__all__ = [
    "build_node_tpu_columns",
    "node_detail_section",
    "pod_detail_section",
]
