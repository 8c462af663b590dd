"""Device backend resolution (pipeline/device.py): no silent CPU fallback
for --provider device, the compile cache's location, and the CLI's refusal
of several processes on one GPU."""

from pathlib import Path

import jax
import pytest

from cli_helpers import run_cli
from pgen_tpu.pipeline import device
from pgen_tpu.pipeline.device import (
    DeviceUnavailableError,
    compilation_cache_dir,
    device_backend,
    enable_compilation_cache,
)


@pytest.mark.parametrize("platforms", ["cpu", "cuda,cpu", " cpu "])
def test_cpu_backend_allowed_when_named(monkeypatch, platforms):
    monkeypatch.setenv("JAX_PLATFORMS", platforms)
    assert device_backend() == "cpu"


@pytest.mark.parametrize("platforms", [None, "", "cuda"])
def test_cpu_backend_refused_when_not_named(monkeypatch, platforms):
    if platforms is None:
        monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    else:
        monkeypatch.setenv("JAX_PLATFORMS", platforms)
    with pytest.raises(DeviceUnavailableError, match="needs a GPU"):
        device_backend()


def test_cli_device_provider_without_gpu_fails_clearly(
    tiny_fileset, monkeypatch, capsys
):
    prefix, _ = tiny_fileset
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    rc = run_cli(["stats", prefix, "--provider", "device"])
    assert rc == 1
    assert "needs a GPU" in capsys.readouterr().err


@pytest.fixture()
def restore_cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_cache_follows_env_var(monkeypatch, tmp_path, restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert compilation_cache_dir() == str(tmp_path)
    assert enable_compilation_cache() == str(tmp_path)
    # JAX reads the variable itself; no other directory is set in code
    assert jax.config.jax_compilation_cache_dir is None


def test_cache_defaults_to_checkout(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = str(Path(__file__).resolve().parent.parent / ".jax_cache")
    assert compilation_cache_dir() == want
    assert enable_compilation_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    assert device.CHECKOUT / ".jax_cache" == Path(want)


@pytest.mark.parametrize("extra", [[], ["-o", "OUT"]])
def test_filter_workers_refused_with_device_provider(
    tiny_fileset, tmp_path, capsys, extra
):
    prefix, _ = tiny_fileset
    argv = ["filter", prefix, "--provider", "device", "--workers", "2"]
    argv += [str(tmp_path / "o.vcf") if a == "OUT" else a for a in extra]
    assert run_cli(argv) == 1
    err = capsys.readouterr().err
    assert "--workers" in err and "device mesh" in err
    assert not (tmp_path / "o.vcf").exists()


def test_filter_single_worker_with_device_provider_allowed(
    tiny_fileset, tmp_path
):
    prefix, _ = tiny_fileset
    out = tmp_path / "o.vcf"
    ref = tmp_path / "r.vcf"
    assert run_cli(["filter", prefix, "--provider", "device", "--workers",
                    "1", "-o", str(out)]) == 0
    assert run_cli(["filter", prefix, "--provider", "numpy", "-o",
                    str(ref)]) == 0
    assert out.read_bytes() == ref.read_bytes()
