"""Process-wide configuration: how "auto" resolves per backend, and the
compile-cache helper."""

import importlib

import jax
import pytest

from xrft_tpu import highprec
from xrft_tpu.ops import fft_core

# the module (``xrft_tpu.config`` the attribute is the settings object)
cfg = importlib.import_module("xrft_tpu.config")


@pytest.fixture
def backend(monkeypatch):
    def use(name):
        monkeypatch.setattr(jax, "default_backend", lambda: name)
    return use


@pytest.mark.parametrize("name", ["gpu", "cpu"])
def test_auto_on_supported_backends(backend, name):
    """On gpu (and cpu) "auto" is XLA's FFT, native complex, native
    float64 hp under x64 — no Pallas route and no emulation."""
    backend(name)
    assert cfg.check_backend() == name
    assert cfg.resolve_fft_engine() == "xla"
    assert fft_core.use_split_complex() is False
    with jax.enable_x64(True):
        assert highprec._hp_native() is True
    with jax.enable_x64(False):
        assert highprec._hp_native() is False          # jit pipelines
        assert highprec._hp_native(require_x64=False) is True  # eager


@pytest.mark.parametrize("resolve", [
    lambda: cfg.resolve_fft_engine(),
    lambda: fft_core.use_split_complex(),
    lambda: highprec._hp_native(),
])
def test_auto_refuses_unknown_backend(backend, resolve):
    backend("neuron")
    with pytest.raises(RuntimeError, match="default backend is 'neuron'"):
        resolve()


def test_explicit_settings_need_no_backend(backend):
    """Explicit engine/complex/hp settings do not consult the backend."""
    backend("neuron")
    assert cfg.resolve_fft_engine("matmul") == "matmul"
    with cfg.complex_mode("split"):
        assert fft_core.use_split_complex() is True
    with cfg.hp_impl("emulate"):
        assert highprec._hp_native() is False


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    """A set JAX_COMPILATION_CACHE_DIR is used as is, and no other cache
    is configured in code."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert cfg.enable_compile_cache(tmp_path) == str(tmp_path / "env")
    assert calls == []


def test_compile_cache_default_is_fixed_checkout_path(monkeypatch,
                                                      tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    path = cfg.enable_compile_cache(tmp_path)
    assert path == str(tmp_path / ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    # the same checkout always maps to the same directory
    assert cfg.compile_cache_dir(tmp_path) == path


def test_compile_cache_default_checkout_is_package_parent(monkeypatch):
    from pathlib import Path

    import xrft_tpu

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = Path(xrft_tpu.__file__).resolve().parents[1]
    assert cfg.compile_cache_dir() == str(root / ".jax_cache")
