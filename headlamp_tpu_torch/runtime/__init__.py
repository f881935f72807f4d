"""Serving-path runtime: the stale-while-revalidate refresher
(``refresh``), the device-to-host transfer funnel (``transfer``) and the
process-wide warm-start carries (``device_cache``)."""
