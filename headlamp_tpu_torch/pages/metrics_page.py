"""MetricsPage — live TPU telemetry with the utilization forecast.

The page of ``headlamp_tpu/pages/metrics_page.py``, rendering the same
tree from the same snapshot; only the inference label names the port's
paths. Rebuild of the reference's `src/components/MetricsPage.tsx` with
the i915 power series replaced by TPU series. Keeps the reference's
three honesty patterns: an always-rendered Metric Availability matrix
(`:125-185`), a guided Prometheus-unreachable box listing the probed
services (`:270-286`), and a no-data diagnostic (`:288-316`). Per-chip
cards use the shared 70/90 utilization thresholds (`:50-119`).
"""

from __future__ import annotations

from typing import Any

from ..metrics.client import (
    LOGICAL_METRICS,
    PROMETHEUS_SERVICES,
    TpuMetricsSnapshot,
)
from ..metrics.format import format_bytes, format_percent, format_ratio_bar
from ..ui import (
    NameValueTable,
    SectionBox,
    SimpleTable,
    StatusLabel,
    UtilizationBar,
    fragment,
    h,
)
from ..ui.vdom import Element

#: Human description of each logical metric for the availability matrix.
_METRIC_DESCRIPTIONS = {
    "tensorcore_utilization": "TensorCore (MXU) utilization per chip",
    "memory_bandwidth_utilization": "HBM bandwidth utilization per chip",
    "hbm_bytes_used": "HBM memory in use",
    "hbm_bytes_total": "HBM memory capacity",
    "duty_cycle": "Accelerator duty cycle (device-plugin exporter)",
}


def availability_matrix(snap: TpuMetricsSnapshot | None) -> Element:
    """Always rendered — tells the user which series their exporters
    actually provide instead of silently showing blanks
    (`MetricsPage.tsx:125-185`)."""
    rows = []
    for logical in LOGICAL_METRICS:
        available = bool(snap and snap.availability.get(logical))
        rows.append(
            {
                "metric": logical,
                "description": _METRIC_DESCRIPTIONS.get(logical, logical),
                "available": available,
                "series": (snap.resolved_series.get(logical, "—") if snap else "—"),
            }
        )
    return SectionBox(
        "Metric Availability",
        SimpleTable(
            [
                {"label": "Metric", "key": "metric"},
                {"label": "Description", "key": "description"},
                {
                    "label": "Available",
                    "getter": lambda r: StatusLabel(
                        "success" if r["available"] else "warning",
                        "Yes" if r["available"] else "No data",
                    ),
                },
                {"label": "Series", "key": "series"},
            ],
            rows,
        ),
        h(
            "p",
            {"class_": "hl-hint"},
            "TPU series come from the GKE tpu-device-plugin or a libtpu "
            "exporter; names vary by exporter version, so each metric is "
            "resolved through a fallback chain.",
        ),
    )


def prometheus_unreachable_box() -> Element:
    """Lists every probed service (`MetricsPage.tsx:270-286`)."""
    return h(
        "div",
        {"class_": "hl-notice hl-prom-missing"},
        h("h3", None, "Prometheus not reachable"),
        h(
            "p",
            None,
            "None of the candidate Prometheus services answered via the "
            "apiserver service proxy:",
        ),
        h(
            "ul",
            None,
            [h("li", None, f"{ns}/{svc}") for ns, svc in PROMETHEUS_SERVICES],
        ),
        h(
            "p",
            None,
            "Install kube-prometheus, the Prometheus Helm chart, or enable "
            "Google Managed Prometheus with the in-cluster frontend.",
        ),
    )


def no_data_box(snap: TpuMetricsSnapshot) -> Element:
    """Prometheus answered but no TPU series exist (`:288-316`)."""
    return h(
        "div",
        {"class_": "hl-notice hl-no-tpu-metrics"},
        h("h3", None, "No TPU metrics found"),
        h(
            "p",
            None,
            f"Prometheus at {snap.namespace}/{snap.service} is reachable but "
            "returned no TPU series. Check that the tpu-device-plugin "
            "metrics endpoint is being scraped (PodMonitoring/ServiceMonitor) "
            "and that TPU workloads have run recently.",
        ),
    )


def chip_card(chip: Any) -> Element:
    rows: list[tuple[str, Any]] = []
    if chip.tensorcore_utilization is not None:
        rows.append(
            (
                "TensorCore utilization",
                UtilizationBar(round(chip.tensorcore_utilization * 100, 1), 100, unit="%"),
            )
        )
    if chip.memory_bandwidth_utilization is not None:
        rows.append(
            (
                "HBM bandwidth",
                UtilizationBar(
                    round(chip.memory_bandwidth_utilization * 100, 1), 100, unit="%"
                ),
            )
        )
    if chip.hbm_bytes_used is not None:
        rows.append(("HBM used", format_ratio_bar(chip.hbm_bytes_used, chip.hbm_bytes_total)))
    if chip.duty_cycle is not None:
        rows.append(("Duty cycle", format_percent(chip.duty_cycle)))
    return SectionBox(
        f"{chip.node} · chip {chip.accelerator_id}",
        NameValueTable(rows) if rows else h("p", None, "No samples"),
        class_="hl-chip-card",
    )


def forecast_section(view: Any) -> Element:
    """Predicted-utilization section (no reference analogue — the TPU
    framework's forward-looking addition). ``view`` is a
    ``models.service.ForecastView``."""
    mins = max(1, round(view.horizon_s / 60))
    at_risk = view.at_risk
    risk_banner = None
    if at_risk:
        names = ", ".join(f"{c.node}/chip {c.accelerator_id}" for c in at_risk[:5])
        risk_banner = h(
            "div",
            {"class_": "hl-notice hl-forecast-risk"},
            h("h3", None, f"{len(at_risk)} chip(s) predicted to saturate"),
            h(
                "p",
                None,
                f"≥90% TensorCore utilization expected within {mins} min: {names}",
            ),
        )
    return SectionBox(
        f"Utilization Forecast (next {mins} min)",
        risk_banner,
        SimpleTable(
            [
                {"label": "Node", "getter": lambda c: c.node},
                {"label": "Chip", "getter": lambda c: c.accelerator_id},
                {"label": "Now", "getter": lambda c: format_percent(c.current)},
                {
                    "label": "Predicted peak",
                    "getter": lambda c: StatusLabel(
                        "error" if c.saturation_risk else "success",
                        format_percent(c.predicted_peak),
                    ),
                },
                {
                    "label": "Predicted mean",
                    "getter": lambda c: format_percent(c.predicted_mean),
                },
            ],
            view.chips[:16],
            empty_message="No history to forecast from",
        ),
        h(
            "p",
            {"class_": "hl-hint"},
            f"Model fit on the last {round(view.window_s / 60)} min of "
            f"{view.data_source} history in {view.fit_ms:g} ms "
            "(online MLP, deterministic seed"
            + (
                # :g keeps tiny well-fit MSEs legible (1.2e-06, not
                # the indistinguishable 0.0000).
                f", final fit MSE {view.fit_mse:g}"
                if view.fit_mse is not None
                else ""
            )
            + f"); inference via {_inference_label(view)}.",
        ),
    )


def _inference_label(view: Any) -> str:
    """Human-readable dispatch record: which inference path served the
    prediction, and whether the fit was warm-started."""
    path = view.inference_path
    warm = ", warm-start fit" if path.endswith("-warm") else ""
    if path.startswith("cuda"):
        return f"CUDA kernel (H100){warm}"
    if path.startswith("torch"):
        return f"PyTorch plain version (CPU){warm}"
    if path == "repeat":
        return "persistence (history shorter than one window; no kernel ran)"
    return f"{path}{warm}"


def metrics_page(
    metrics: TpuMetricsSnapshot | None, forecast: Any | None = None
) -> Element:
    children: list[Any] = [
        fragment("cell:available", lambda: availability_matrix(metrics))
    ]

    if metrics is None:
        children.append(prometheus_unreachable_box())
        return h("div", {"class_": "hl-page hl-metrics"}, children)

    if not metrics.chips:
        children.append(no_data_box(metrics))
        return h("div", {"class_": "hl-page hl-metrics"}, children)

    # Fleet summary (the reference's total-power section `:318-346`,
    # recast as fleet-wide utilization + HBM totals).
    utils = [
        c.tensorcore_utilization
        for c in metrics.chips
        if c.tensorcore_utilization is not None
    ]
    hbm_used = [c.hbm_bytes_used for c in metrics.chips if c.hbm_bytes_used is not None]
    hbm_total = [c.hbm_bytes_total for c in metrics.chips if c.hbm_bytes_total is not None]
    summary_rows: list[tuple[str, Any]] = [("Chips reporting", len(metrics.chips))]
    if utils:
        summary_rows.append(
            ("Mean TensorCore utilization", format_percent(sum(utils) / len(utils)))
        )
    if hbm_used:
        summary_rows.append(("Total HBM used", format_bytes(sum(hbm_used))))
    if hbm_total:
        summary_rows.append(("Total HBM capacity", format_bytes(sum(hbm_total))))
    children.append(
        SectionBox(
            "Fleet Telemetry",
            NameValueTable(summary_rows),
            h(
                "p",
                {"class_": "hl-hint"},
                f"Source: {metrics.namespace}/{metrics.service} via apiserver "
                f"service proxy; scrape→join took {metrics.fetch_ms:g} ms "
                "(target <2000 ms — the scrape_paint objective; burn-rate "
                "status at ",
                h("a", {"href": "/sloz/html"}, "/sloz/html"),
                ").",
            ),
        )
    )

    if forecast is not None:
        children.append(
            fragment("cell:forecast", lambda: forecast_section(forecast))
        )

    # One boundary per chip card, keyed as the JAX package keys them.
    children.extend(
        fragment(f"{c.node}/{c.accelerator_id}", lambda c=c: chip_card(c))
        for c in metrics.chips
    )
    return h("div", {"class_": "hl-page hl-metrics"}, children)
