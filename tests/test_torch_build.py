"""The kernel builder: nvcc at first use, cached by source hash, loud on
failure. A stand-in compiler script plays nvcc, which this CPU host
lacks."""

from pathlib import Path

import pytest

from headlamp_tpu_torch.kernels import build

REPO = Path(__file__).resolve().parents[1]


class TestBuild:
    """build.build runs nvcc from the kernel's source at first use; here a
    stand-in compiler script shows the caching and the loud failure."""

    def _fake_nvcc(self, tmp_path, body):
        script = tmp_path / "nvcc"
        script.write_text("#!/bin/sh\n" + body)
        script.chmod(0o755)
        return str(script)

    def test_failed_build_raises_with_compiler_output(self, tmp_path, monkeypatch):
        nvcc = self._fake_nvcc(tmp_path, 'echo "error: bad kernel" >&2\nexit 2\n')
        monkeypatch.setattr(build, "find_nvcc", lambda: nvcc)
        monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
        with pytest.raises(RuntimeError, match="bad kernel"):
            build.build("forecast_mlp")
        assert not list((tmp_path / "_build").rglob("*.so"))

    def test_build_is_cached_by_source_hash(self, tmp_path, monkeypatch):
        # Stand-in compiler: touch the file after "-o" and report.
        nvcc = self._fake_nvcc(
            tmp_path,
            'while [ "$1" != "-o" ]; do shift; done\n'
            'touch "$2"\necho "ptxas info : Used 64 registers" >&2\n',
        )
        monkeypatch.setattr(build, "find_nvcc", lambda: nvcc)
        monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
        first = build.build("forecast_mlp")
        second = build.build("forecast_mlp")
        assert not first.cache_hit and "registers" in first.log
        assert second.cache_hit and second.library == first.library
        assert first.library.parent.parent == tmp_path / "_build"
        assert len(first.library.parent.name) == 64  # sha256 hex digest

    def test_flags_target_hopper(self):
        assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
        assert "--use_fast_math" not in build.NVCC_FLAGS

    def test_build_dir_is_ignored_by_git(self):
        ignored = (REPO / ".gitignore").read_text().splitlines()
        assert "headlamp_tpu_torch/kernels/_build/" in ignored
