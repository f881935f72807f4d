"""State layer — the provider-agnostic AcceleratorDataContext.

The port's copy of ``headlamp_tpu/context``: one snapshot of the
cluster, built from paginated node and pod lists (kept current by
list+watch once enabled) plus each provider's fallback chains, which
pages read and never the transport.
"""

from .accelerator_context import (
    AcceleratorDataContext,
    ClusterSnapshot,
    ProviderState,
)
from .sources import (
    ACTIVE_PODS_FIELD_SELECTOR,
    NODES_PATH,
    PODS_PATH,
    TPU_SOURCE,
    ProviderSource,
    default_sources,
)

__all__ = [
    "ACTIVE_PODS_FIELD_SELECTOR",
    "AcceleratorDataContext",
    "ClusterSnapshot",
    "NODES_PATH",
    "PODS_PATH",
    "ProviderSource",
    "ProviderState",
    "TPU_SOURCE",
    "default_sources",
]
