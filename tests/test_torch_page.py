"""The port's metrics page and CLI on the CPU: page text and HTML
identical to the JAX package's outside the forecast section and the
scrape timing, and an inference label that names the path that served
the forecast."""

import dataclasses
import re

import numpy as np
import pytest
import torch

from headlamp_tpu import cli as jcli
from headlamp_tpu.metrics import client as jclient
from headlamp_tpu.pages.metrics_page import metrics_page as jax_metrics_page
from headlamp_tpu.server import make_demo_transport as jax_demo_transport
from headlamp_tpu.ui import render_html as jax_render_html
from headlamp_tpu_torch import cli
from headlamp_tpu_torch.metrics import client
from headlamp_tpu_torch.models import service
from headlamp_tpu_torch.pages.metrics_page import metrics_page
from headlamp_tpu_torch.server.demo import make_demo_transport
from headlamp_tpu_torch.ui import render_html, text_content

#: pytest-xdist runs several workers on the same cores: one intra-op
#: thread each keeps torch's spinning thread pools from oversubscribing
#: them (it cuts these tests' CPU time about fourfold).
torch.set_num_threads(1)

CLOCK = 1785283200.0
PROM = ("monitoring", "prometheus-k8s:9090")


def clock():
    return CLOCK


@pytest.fixture(scope="module")
def view():
    t = make_demo_transport("v5e4")
    hist = client.fetch_utilization_history(t, prometheus=PROM, clock=clock)
    return service.forecast_from_history(hist, device="cpu")


def _strip_forecast(text):
    """(page text without the forecast section and with the scrape time
    masked, the forecast section's header lines)."""
    lines = text.splitlines()
    start = next(i for i, line in enumerate(lines) if line.startswith("Utilization Forecast"))
    end = next(i for i, line in enumerate(lines) if line.startswith("Model fit on the last"))
    kept = lines[:start] + lines[end + 1:]
    masked = [re.sub(r"scrape→join took [0-9.]+ ms", "scrape→join took _ ms", s) for s in kept]
    return masked, lines[start:start + 2], end - start


@pytest.mark.parametrize("fleet", ["v5e4", "v5p32", "large"])
def test_cli_page_matches_jax_outside_forecast(fleet):
    got = cli.render_page("metrics", make_demo_transport(fleet), clock=clock, device="cpu")
    want = jcli.render_page("metrics", jax_demo_transport(fleet), clock=clock)
    got_rest, got_head, got_len = _strip_forecast(got)
    want_rest, want_head, want_len = _strip_forecast(want)
    assert got_rest == want_rest
    assert got_head == want_head and got_len == want_len
    assert "inference via PyTorch plain version (CPU)." in got


@pytest.mark.parametrize("fleet", ["v5e4", "v5p32"])
def test_page_html_matches_jax_without_forecast(fleet):
    got = client.fetch_tpu_metrics(make_demo_transport(fleet), clock=clock)
    want = jclient.fetch_tpu_metrics(jax_demo_transport(fleet), clock=clock)

    def masked(html):
        return re.sub(r"took [0-9.]+ ms", "took _ ms", html)

    assert masked(render_html(metrics_page(got, None))) == masked(
        jax_render_html(jax_metrics_page(want, None))
    )


def test_cli_main_cpu(capsys):
    assert cli.main(["metrics", "--demo", "v5e4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Utilization Forecast" in out and "Fleet Telemetry" in out


class TestInferenceLabel:
    @pytest.mark.parametrize(
        "path,label",
        [
            ("cuda", "CUDA kernel (H100)."),
            ("cuda-warm", "CUDA kernel (H100), warm-start fit."),
            ("torch", "PyTorch plain version (CPU)."),
            ("torch-warm", "PyTorch plain version (CPU), warm-start fit."),
            ("repeat", "persistence (history shorter than one window; no kernel ran)."),
        ],
    )
    def test_label_names_the_path(self, view, path, label):
        got = view
        snap = client.fetch_tpu_metrics(make_demo_transport("v5e4"), clock=clock)
        view = dataclasses.replace(got, inference_path=path)
        assert f"inference via {label}" in text_content(metrics_page(snap, view))

    def test_short_history_is_persistence(self):
        t = make_demo_transport("v5e4")
        hist = client.fetch_utilization_history(
            t, prometheus=PROM, window_s=600, clock=clock
        )
        view = service.forecast_from_history(hist, device="cpu")
        assert view.inference_path == "repeat" and view.fit_mse is None
        want = np.array(hist.series)[:, -1]
        assert sorted(c.predicted_peak for c in view.chips) == pytest.approx(sorted(want))
