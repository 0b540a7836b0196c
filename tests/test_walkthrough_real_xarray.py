"""Walkthrough 04 (the MITgcm-notebook analogue) end to end with REAL
xarray DataArray I/O (the de-facto acceptance test of
the reference is its MITgcm notebook, /root/reference/doc/
MITgcm_example.ipynb; the CI real-deps leg must run one full walkthrough
against the real library, not just the boundary/cftime tests).

Every public call here passes ``xr.DataArray`` in and asserts a
``DataArray`` comes back (the reference API surface), with values
matching the LabeledArray-native path bitwise.
"""

import importlib.util
import pathlib

import numpy as np
import numpy.testing as npt
import pytest

xr = pytest.importorskip("xarray")

import xrft_tpu

_W04 = (pathlib.Path(__file__).resolve().parent.parent / "docs"
        / "walkthroughs" / "04_ocean_model_spectra.py")


def _load_w04():
    spec = importlib.util.spec_from_file_location("w04", _W04)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_walkthrough04_with_dataarray_io():
    mod = _load_w04()
    rng = np.random.RandomState(42)
    nt, nz, ny, nx = 3, 2, 64, 64
    dx = 5e3
    coords = {
        "time": np.arange(nt) * 86400.0,
        "Zl": -np.arange(nz) * 10.0,
        "YC": np.arange(ny) * dx,
        "XC": np.arange(nx) * dx,
    }
    dims = ("time", "Zl", "YC", "XC")
    u_np = mod._channel_like(rng, nt, nz, ny, nx)
    w_np = mod._channel_like(rng, nt, nz, ny, nx)
    b_np = mod._channel_like(rng, nt, nz, ny, nx)
    u = xr.DataArray(u_np, dims=dims, coords=coords, name="UVEL")
    w = xr.DataArray(w_np, dims=dims, coords=coords, name="WVEL")
    b = xr.DataArray(b_np, dims=dims, coords=coords, name="PHIHYD")

    # dft of the 4-D stack (notebook cell 4)
    what = xrft_tpu.dft(w, dim=["XC"], detrend="linear", window=True,
                        true_phase=False, true_amplitude=False)
    assert isinstance(what, xr.DataArray)
    assert what.dims == ("time", "Zl", "YC", "freq_XC")
    assert "spacing" in what.coords["freq_XC"].attrs

    # surface EKE spectrum (notebook cell 8), legacy density=False
    uhat2 = xrft_tpu.power_spectrum(
        u.isel(Zl=0), dim=["XC", "YC"], detrend="linear", window=True,
        density=False)
    assert isinstance(uhat2, xr.DataArray)
    assert uhat2.dims == ("time", "freq_YC", "freq_XC")
    assert np.all(np.isfinite(uhat2.values))

    # isotropic wavenumber spectrum + slope recovery (notebook cell 10)
    uiso2 = xrft_tpu.isotropic_power_spectrum(
        u.isel(time=0, Zl=0), dim=["XC", "YC"], detrend="linear",
        window=True)
    assert isinstance(uiso2, xr.DataArray)
    assert uiso2.dims == ("freq_r",)
    kr = uiso2["freq_r"].values
    vals = uiso2.values
    sel = (kr > kr[2]) & (kr < kr[kr.size // 2])
    _, slope, _ = xrft_tpu.fit_loglog(kr[sel], vals[sel])
    assert -5.0 < slope < -1.0

    # cross spectrum w x b (notebook cell 16), raw density=False mode
    whatbhat = xrft_tpu.cross_spectrum(
        w, b, dim=["XC", "YC"], detrend="linear", window=True,
        density=False, true_phase=False)
    assert isinstance(whatbhat, xr.DataArray)
    what2 = xrft_tpu.fft(w, dim=["XC", "YC"], detrend="linear",
                         window=True, true_phase=False,
                         true_amplitude=True)
    bhat2 = xrft_tpu.fft(b, dim=["XC", "YC"], detrend="linear",
                         window=True, true_phase=False,
                         true_amplitude=True)
    assert isinstance(what2, xr.DataArray)
    ref = what2.values * np.conj(bhat2.values)
    npt.assert_allclose(whatbhat.values, ref,
                        atol=1e-6 * np.abs(ref).max())

    # DataArray path == LabeledArray path bitwise
    from xrft_tpu import LabeledArray

    la = LabeledArray(u_np, dims=dims, coords=coords, name="UVEL")
    ps_la = xrft_tpu.power_spectrum(
        la.isel(Zl=0), dim=["XC", "YC"], detrend="linear", window=True,
        density=False)
    npt.assert_array_equal(uhat2.values, np.asarray(ps_la.values))


def test_walkthrough04_roundtrip_with_dataarray():
    """pad -> fft -> ifft -> unpad round trip through DataArray I/O
    (reference test_padding.py:222-234 genre, under the real library)."""
    n = 32
    da = xr.DataArray(
        np.random.RandomState(0).randn(n).astype(np.float32),
        dims=("x",), coords={"x": np.arange(n) * 0.5}, name="u")
    padded = xrft_tpu.pad(da, x=4, mode="constant")
    assert isinstance(padded, xr.DataArray) and padded.sizes["x"] == n + 8
    ft = xrft_tpu.fft(padded, dim="x")
    back = xrft_tpu.ifft(ft, dim="freq_x",
                         lag=float(padded["x"].values[(n + 8) // 2]))
    unpadded = xrft_tpu.unpad(back.real)
    assert isinstance(unpadded, xr.DataArray)
    npt.assert_allclose(unpadded.values, da.values, atol=1e-5)
    npt.assert_allclose(unpadded["x"].values, da["x"].values)
