"""The port's ``/metricsz`` read from the outside, the port's twin of the
exposition checks in ``tests/test_metricsz.py``: one app on the CPU after
real traffic across the instrumented routes, scraped through ``handle()``
the way a Prometheus server reads it. Every family carries one ``# HELP``
and one ``# TYPE`` before its samples, its name matches the port's
``headlamp_tpu_torch_`` grammar with a unit suffix, and a family that
renders no sample is one of a known quiet set.

That quiet set is JAX's (``tests/test_metricsz.py``), each name moved to
the port's family. Two families are named for the port's device:
``graph_capture_seconds`` for JAX's ``jax_compile_seconds`` and
``calibration_device_seconds`` for ``calibration_xla_seconds``. SYN001
reads this set for the port (``tests/test_torch_analysis.py``): an entry
that names no family literal in ``headlamp_tpu_torch/`` is a finding.
"""

from __future__ import annotations

import re

import pytest

from headlamp_tpu_torch.obs.metrics import UNIT_SUFFIXES
from headlamp_tpu_torch.server import DashboardApp, make_demo_transport

NAME_RE = re.compile(r"^headlamp_tpu_torch_[a-z0-9_]+$")
SAMPLE_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*")
HELP_RE = re.compile(r"^# HELP (?P<name>\S+) (?P<text>.+)$")
TYPE_RE = re.compile(r"^# TYPE (?P<name>\S+) (?P<kind>counter|gauge|histogram)$")


def parse_families(text: str) -> tuple[dict[str, str], dict[str, str], list[str]]:
    """(helps, types, sample names in order). Strict on the metadata: a
    malformed or repeated HELP/TYPE, or one after its family's samples,
    fails here. Sample lines are read up to their name only, so a label
    value holding a brace (``route="/node/{name}"``) parses."""
    helps: dict[str, str] = {}
    types: dict[str, str] = {}
    samples: list[str] = []
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# "):
            m = HELP_RE.match(line) or TYPE_RE.match(line)
            assert m, f"malformed comment line: {line!r}"
            name = m.group("name")
            table = helps if line.startswith("# HELP ") else types
            assert name not in table, f"repeated metadata for {name}"
            assert not any(base_name(s, types) == name for s in samples), name
            table[name] = m.group("text") if table is helps else m.group("kind")
            continue
        m = SAMPLE_NAME_RE.match(line)
        assert m and line[m.end():m.end() + 1] in ("{", " "), f"bad sample line: {line!r}"
        samples.append(m.group(0))
    return helps, types, samples


def base_name(sample: str, types: dict[str, str]) -> str:
    for suffix in ("_bucket", "_sum", "_count"):
        if sample.endswith(suffix) and types.get(sample[: -len(suffix)]) == "histogram":
            return sample[: -len(suffix)]
    return sample


@pytest.fixture(scope="module")
def exposition():
    app = DashboardApp(make_demo_transport("v5p32"), device="cpu", min_sync_interval_s=0.0)
    try:
        for path in ("/tpu", "/tpu/nodes", "/tpu/metrics", "/nope", "/healthz"):
            app.handle(path)
        status, ctype, body = app.handle("/metricsz")[:3]
    finally:
        app.close()
    assert status == 200 and ctype == "text/plain"
    return body


def test_every_family_has_help_and_type_before_its_samples(exposition):
    helps, types, samples = parse_families(exposition)
    assert samples and set(helps) == set(types)
    for sample in samples:
        assert base_name(sample, types) in types, sample
    assert all(text.strip() for text in helps.values())


def test_names_follow_the_ports_grammar_with_a_unit_suffix(exposition):
    _, types, _ = parse_families(exposition)
    for name, kind in types.items():
        assert NAME_RE.match(name), name
        assert name.endswith(UNIT_SUFFIXES), name
        if kind == "counter":
            assert name.endswith("_total"), name


def test_metadata_only_families_are_the_known_quiet_set(exposition):
    _, types, samples = parse_families(exposition)
    emitted = {base_name(s, types) for s in samples}
    quiet = {name for name in types if name not in emitted}
    assert quiet <= {
        "headlamp_tpu_torch_calibration_python_per_node_seconds",
        "headlamp_tpu_torch_calibration_device_seconds",
        "headlamp_tpu_torch_transport_connect_latency_seconds",
        "headlamp_tpu_torch_gateway_queue_depth_count",
        "headlamp_tpu_torch_gateway_inflight_renders_count",
        "headlamp_tpu_torch_gateway_queue_wait_seconds",
        "headlamp_tpu_torch_history_memory_bytes",
        "headlamp_tpu_torch_history_window_span_seconds",
        "headlamp_tpu_torch_graph_capture_seconds",
        "headlamp_tpu_torch_profiler_overhead_seconds",
        "headlamp_tpu_torch_push_frames_total",
        "headlamp_tpu_torch_push_evictions_total",
        "headlamp_tpu_torch_push_not_modified_total",
        "headlamp_tpu_torch_push_gzip_bytes_total",
        "headlamp_tpu_torch_push_gzip_cache_total",
        "headlamp_tpu_torch_push_clients_count",
        "headlamp_tpu_torch_replicate_generations_total",
        "headlamp_tpu_torch_replicate_bytes_total",
        "headlamp_tpu_torch_replicate_failovers_total",
        "headlamp_tpu_torch_replicate_lag_seconds",
        "headlamp_tpu_torch_render_fragment_cache_bytes",
        "headlamp_tpu_torch_trace_propagation_total",
        "headlamp_tpu_torch_worker_generations_applied_total",
        "headlamp_tpu_torch_worker_shm_attach_failures_total",
        "headlamp_tpu_torch_worker_fallback_decodes_total",
        "headlamp_tpu_torch_scenario_injections_total",
        "headlamp_tpu_torch_scenario_timeline_events_total",
        "headlamp_tpu_torch_scenario_runs_total",
    }, f"unexpected sample-free families: {sorted(quiet)}"
