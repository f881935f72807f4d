"""The port's device policy: entry points run on CUDA unless the caller
asks for the CPU, and no path swaps in the CPU, the plain version or a
missing forecast when CUDA or the kernel is absent."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from headlamp_tpu_torch import cli
from headlamp_tpu_torch.device import resolve_device
from headlamp_tpu_torch.kernels import build
from headlamp_tpu_torch.models import fused_forward as ff
from headlamp_tpu_torch.models.forecast import (
    ForecastConfig,
    fit_and_forecast_incremental,
    fit_and_forecast_with_dispatch,
    init_params,
)
from headlamp_tpu_torch.server.demo import make_demo_transport

#: pytest-xdist runs several workers on the same cores: one intra-op
#: thread each keeps torch's spinning thread pools from oversubscribing
#: them (it cuts these tests' CPU time about fourfold).
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def test_chip_smoke_refuses_without_cuda(tmp_path):
    # Alone in a directory (no package beside it) and without CUDA, the
    # smoke script fails and prints no result line.
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path,
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


class TestDevicePolicy:
    @pytest.fixture
    def no_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def test_none_means_cuda_and_raises_without_it(self, no_cuda):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            resolve_device("cuda")

    def test_cpu_on_request(self, no_cuda):
        assert resolve_device("cpu") == torch.device("cpu")
        assert resolve_device(torch.device("cpu")).type == "cpu"

    def test_other_device_types_rejected(self):
        with pytest.raises(ValueError):
            resolve_device("meta")

    def test_entry_points_default_to_cuda(self, no_cuda):
        series = np.full((2, 48), 0.5, dtype=np.float32)
        with pytest.raises(RuntimeError):
            fit_and_forecast_with_dispatch(series, steps=1)
        with pytest.raises(RuntimeError):
            fit_and_forecast_incremental(series, steps=1)
        with pytest.raises(RuntimeError):
            init_params(torch.Generator().manual_seed(0), ForecastConfig())
        with pytest.raises(RuntimeError):
            cli.render_page("metrics", make_demo_transport("v5e4"))
        with pytest.raises(RuntimeError):
            cli.main(["metrics", "--demo", "v5e4"])


class TestNoHiddenFallback:
    def _params(self):
        return init_params(torch.Generator().manual_seed(0), ForecastConfig(), device="cpu")

    def test_kernel_wrapper_refuses_cpu_tensors(self):
        with pytest.raises(ValueError, match="CUDA tensor"):
            ff.forecast_forward_cuda(self._params(), torch.zeros((4, 32)))

    def test_cpu_path_never_builds_the_kernel(self, monkeypatch):
        def no_build(name):
            raise AssertionError("the CPU path must not build the kernel")

        monkeypatch.setattr(build, "load", no_build)
        out = ff.forecast_forward(self._params(), torch.zeros((4, 32)))
        assert out.shape == (4, 8)

    def test_cuda_tensor_goes_to_the_kernel(self, monkeypatch):
        # The dispatch reads only the device: a CUDA tensor reaches the
        # kernel wrapper, never the plain version.
        seen = []
        monkeypatch.setattr(ff, "forecast_forward_cuda", lambda p, x: seen.append(x) or x)
        monkeypatch.setattr(
            ff, "forecast_forward_reference",
            lambda p, x: pytest.fail("plain version used for a CUDA tensor"),
        )
        fake = torch.empty((2, 32), device="meta")
        with pytest.raises(ValueError):
            ff.forecast_forward(self._params(), fake)

        class CudaLike:
            device = torch.device("cuda")

        x = CudaLike()
        assert ff.forecast_forward(self._params(), x) is x and seen == [x]

    def test_launch_count_starts_at_zero_on_reset(self):
        ff.LAUNCHES.n = 3
        ff.LAUNCHES.reset()
        assert ff.LAUNCHES.n == 0
