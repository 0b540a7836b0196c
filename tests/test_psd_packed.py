"""The packed two-sided PSD route (ops/psd_packed.py): half-size complex
FFT of row-paired data + elementwise combine, no mirror pass.

Pins exact agreement (f64, ~1e-12) between the packed route
(engine='matmul', which takes it whenever applicable) and the generic
XLA-FFT route for the same reference semantics
(``/root/reference/xrft/xrft.py:685-750``), across the kwarg grid the
route specializes on.
"""

import numpy as np
import numpy.testing as npt
import pytest

import xrft_tpu
from xrft_tpu import LabeledArray
from xrft_tpu.config import config
from xrft_tpu.ops import psd_packed


@pytest.fixture(autouse=True)
def _enable_packed():
    # the route measured a net loss where it was built, and is
    # default-disabled
    # (config.psd_packed docstring); these tests pin its correctness as
    # an opt-in
    old = config.psd_packed
    config.psd_packed = "auto"
    yield
    config.psd_packed = old


def _field(shape, trend=True, seed=0):
    rng = np.random.RandomState(seed)
    d = rng.randn(*shape)
    if trend:
        for ax, n in enumerate(shape):
            sl = [None] * len(shape)
            sl[ax] = slice(None)
            d = d + 0.05 * (ax + 1) * np.arange(n)[tuple(sl)]
        d = d + 2.0
    return d


def _check(da, dims, rtol=1e-10, applicable=True, **kw):
    half = dims[-1]
    shift = kw.get("shift", True)
    fkw = {k: v for k, v in kw.items()
           if k not in ("scaling", "window_correction")}
    fkw.update({"true_phase": False, "true_amplitude": False})
    assert psd_packed.packed_psd_applicable(
        da, dims, half, shift, {**fkw, "engine": "matmul"}) == applicable
    ref = xrft_tpu.power_spectrum(da, dim=dims, engine="xla", **kw)
    got = xrft_tpu.power_spectrum(da, dim=dims, engine="matmul", **kw)
    assert got.dims == ref.dims
    for c in ref.coords:
        npt.assert_allclose(got.coords[c].values, ref.coords[c].values,
                            atol=1e-12)
    scale = float(np.abs(np.asarray(ref.values)).max())
    npt.assert_allclose(np.asarray(got.values), np.asarray(ref.values),
                        atol=rtol * scale)
    return got


@pytest.mark.parametrize("window", [None, "hann", "blackman"])
@pytest.mark.parametrize("detrend", [None, "constant", "linear"])
@pytest.mark.parametrize("shift", [True, False])
def test_packed_psd_parity_grid(window, detrend, shift):
    da = LabeledArray(_field((32, 48)), dims=("y", "x"),
                      coords={"y": np.arange(32) * 0.5,
                              "x": np.arange(48) * 0.25})
    _check(da, ["y", "x"], window=window, detrend=detrend, shift=shift)


def test_packed_psd_batch_dims():
    """Batch dims anywhere; transform dims in caller-chosen order."""
    da = LabeledArray(_field((3, 32, 2, 48)), dims=("t", "y", "s", "x"),
                      coords={"y": np.arange(32) * 0.5,
                              "x": np.arange(48) * 0.25})
    _check(da, ["y", "x"], window="hann", detrend="linear")


def test_packed_psd_multilevel_plans():
    """Sizes forcing multi-level radix plans on both the packed (Y/2)
    and x axes (cap 128: 512 -> (16, 32)-ish, 384 -> multi-level)."""
    da = LabeledArray(_field((512, 384)), dims=("y", "x"),
                      coords={"y": np.arange(512) * 1.0,
                              "x": np.arange(384) * 1.0})
    _check(da, ["y", "x"], window="hann", detrend="linear")


def test_packed_psd_scalings():
    da = LabeledArray(_field((32, 48)), dims=("y", "x"),
                      coords={"y": np.arange(32) * 0.5,
                              "x": np.arange(48) * 0.25})
    for scaling in ("density", "spectrum"):
        _check(da, ["y", "x"], scaling=scaling)
    _check(da, ["y", "x"], window="hann", window_correction=True)


def test_packed_psd_not_applicable_fallbacks():
    """Odd Y, 1-D, 3-D, complex input, and config='never' all decline."""
    da_odd = LabeledArray(_field((31, 48)), dims=("y", "x"),
                          coords={"y": np.arange(31) * 1.0,
                                  "x": np.arange(48) * 1.0})
    assert not psd_packed.packed_psd_applicable(
        da_odd, ["y", "x"], "x", True, {"engine": "matmul"})
    # still correct through the public API (falls to the fused route)
    _check(da_odd, ["y", "x"], applicable=False)

    da = LabeledArray(_field((32, 48)), dims=("y", "x"),
                      coords={"y": np.arange(32) * 1.0,
                              "x": np.arange(48) * 1.0})
    assert not psd_packed.packed_psd_applicable(
        da, ["x"], "x", True, {"engine": "matmul"})
    da3 = LabeledArray(_field((8, 32, 48)), dims=("z", "y", "x"),
                       coords={"z": np.arange(8) * 1.0,
                               "y": np.arange(32) * 1.0,
                               "x": np.arange(48) * 1.0})
    assert not psd_packed.packed_psd_applicable(
        da3, ["z", "y", "x"], "x", True, {"engine": "matmul"})
    old = config.psd_packed
    config.psd_packed = "never"
    try:
        assert not psd_packed.packed_psd_applicable(
            da, ["y", "x"], "x", True, {"engine": "matmul"})
        _check(da, ["y", "x"], applicable=False)
    finally:
        config.psd_packed = old


def test_packed_psd_f32_grade(monkeypatch):
    """f32 input through the packed route stays at engine-grade accuracy
    (~1e-6) vs the f64 oracle."""
    rng = np.random.RandomState(3)
    da = LabeledArray(rng.randn(64, 64).astype(np.float32),
                      dims=("y", "x"),
                      coords={"y": np.arange(64) * 0.5,
                              "x": np.arange(64) * 0.5})
    got = xrft_tpu.power_spectrum(da, dim=["y", "x"], window="hann",
                                  detrend="linear", engine="matmul")
    da64 = LabeledArray(np.asarray(da.values, np.float64), dims=da.dims,
                        coords=da.coords)
    ref = xrft_tpu.power_spectrum(da64, dim=["y", "x"], window="hann",
                                  detrend="linear", engine="xla")
    scale = np.abs(ref.values).max()
    npt.assert_allclose(np.asarray(got.values), ref.values,
                        atol=2e-5 * scale)


def test_packed_psd_jit_roundtrip():
    """The packed route is jit-traceable end-to-end."""
    import jax

    da = LabeledArray(_field((32, 48)), dims=("y", "x"),
                      coords={"y": np.arange(32) * 0.5,
                              "x": np.arange(48) * 0.25})

    def f(d):
        return xrft_tpu.power_spectrum(d, dim=["y", "x"], window="hann",
                                       detrend="linear",
                                       engine="matmul").data

    eager = f(da)
    jitted = jax.jit(f)(da)
    npt.assert_allclose(np.asarray(jitted), np.asarray(eager), rtol=1e-12)
