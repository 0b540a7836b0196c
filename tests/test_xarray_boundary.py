"""xarray at the API boundary.

xarray is not a dependency, so these tests exercise the boundary
through a minimal in-test stub that implements the DataArray surface the
converters consume (dims/coords/attrs/values/name +
register_dataarray_accessor) — validating the same code paths real xarray
would take.  A final test runs the reference's notebook idioms verbatim
when real xarray is installed (skipped otherwise; reference:
/root/reference/doc/MITgcm_example.ipynb cells 4/8/10).
"""

import sys
import types

import numpy as np
import numpy.testing as npt
import pytest


def _make_stub_xarray():
    """A tiny xarray lookalike: enough DataArray for the converters."""
    mod = types.ModuleType("xarray")

    class _Coord:
        def __init__(self, da):
            self.dims = da.dims
            self.values = da.values
            self.attrs = da.attrs

    class DataArray:
        __module__ = "xarray"

        def __init__(self, data, dims=None, coords=None, attrs=None,
                     name=None):
            self.values = np.asarray(data)
            self.dims = tuple(dims) if dims else tuple(
                f"dim_{i}" for i in range(self.values.ndim))
            self.coords = {}
            for cname, c in (coords or {}).items():
                if isinstance(c, DataArray):
                    self.coords[cname] = _Coord(c)
                else:
                    carr = DataArray(np.asarray(c), dims=(cname,))
                    self.coords[cname] = _Coord(carr)
            self.attrs = dict(attrs) if attrs else {}
            self.name = name

    _accessors = {}

    def register_dataarray_accessor(name):
        def deco(cls):
            _accessors[name] = cls

            def prop(self):
                return cls(self)

            setattr(DataArray, name, property(prop))
            return cls

        return deco

    mod.DataArray = DataArray
    mod.register_dataarray_accessor = register_dataarray_accessor
    return mod


@pytest.fixture
def stub_xr(monkeypatch):
    mod = _make_stub_xarray()
    monkeypatch.setitem(sys.modules, "xarray", mod)
    import xrft_tpu
    from xrft_tpu.xarray_compat import register_accessor

    assert register_accessor(mod)
    return mod


def test_public_functions_accept_and_return_dataarray(stub_xr):
    import xrft_tpu

    N = 32
    da = stub_xr.DataArray(
        np.random.RandomState(0).randn(N, N).astype(np.float32),
        dims=("y", "x"),
        coords={"y": np.arange(N) * 0.5, "x": np.arange(N) * 0.5},
        name="field")

    ft = xrft_tpu.fft(da, dim=["x"])
    assert isinstance(ft, stub_xr.DataArray)
    assert ft.dims == ("y", "freq_x")
    assert "spacing" in ft.coords["freq_x"].attrs

    ps = xrft_tpu.power_spectrum(da, dim=["y", "x"], window="hann")
    assert isinstance(ps, stub_xr.DataArray)
    assert ps.dims == ("freq_y", "freq_x")

    back = xrft_tpu.ifft(ft, dim=["freq_x"], lag=[float((N // 2) * 0.5)])
    assert isinstance(back, stub_xr.DataArray)
    npt.assert_allclose(np.asarray(back.values).real,
                        np.asarray(da.values, np.float64), atol=1e-4)

    # two-input function with mixed representations
    la = xrft_tpu.LabeledArray(np.asarray(da.values), dims=da.dims,
                               coords={"y": np.arange(N) * 0.5,
                                       "x": np.arange(N) * 0.5})
    cs = xrft_tpu.cross_spectrum(da, la, dim=["x"])
    assert isinstance(cs, stub_xr.DataArray)

    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # unsegmented-coherence warning
        coh = xrft_tpu.coherence(da, la, dim=["x"])
    assert isinstance(coh, stub_xr.DataArray)

    sg = xrft_tpu.spectrogram(da, dim="x", seglen=N // 2)
    assert isinstance(sg, stub_xr.DataArray)
    assert sg.dims == ("y", "x_segment", "freq_x")

    iso = xrft_tpu.isotropic_power_spectrum(da, dim=["y", "x"],
                                            truncate=True)
    assert isinstance(iso, stub_xr.DataArray)
    assert iso.dims == ("freq_r",)

    p = xrft_tpu.pad(da, {"x": 2}, mode="constant")
    assert isinstance(p, stub_xr.DataArray)
    assert p.values.shape == (N, N + 4)
    up = xrft_tpu.unpad(p)
    assert up.values.shape == (N, N)

    dt = xrft_tpu.detrend(da, ["y", "x"], "linear")
    assert isinstance(dt, stub_xr.DataArray)


def test_accessor(stub_xr):
    N = 24
    da = stub_xr.DataArray(
        np.random.RandomState(1).randn(N).astype(np.float32),
        dims=("t",), coords={"t": np.arange(N) * 2.0})
    ps = da.xrft.power_spectrum(dim=["t"])
    assert isinstance(ps, stub_xr.DataArray)
    assert ps.dims == ("freq_t",)
    ft = da.xrft.fft(dim="t")
    assert isinstance(ft, stub_xr.DataArray)


def test_labeledarray_passthrough_unchanged(stub_xr):
    """Non-DataArray inputs keep returning LabeledArray."""
    import xrft_tpu

    la = xrft_tpu.LabeledArray(np.random.randn(16).astype(np.float32),
                               dims=("x",),
                               coords={"x": np.arange(16.0)})
    out = xrft_tpu.fft(la, dim="x")
    assert isinstance(out, xrft_tpu.LabeledArray)


def test_real_xarray_notebook_idioms():
    """Reference notebook idioms verbatim on real DataArrays
    (/root/reference/doc/MITgcm_example.ipynb cells 4/8/10); runs only
    where xarray is installed."""
    xr = pytest.importorskip("xarray")
    import xrft_tpu

    N = 32
    theta = xr.DataArray(
        np.random.RandomState(2).rand(4, N, N).astype(np.float32),
        dims=["time", "YC", "XC"],
        coords={"time": np.arange(4.0), "YC": np.arange(N) * 1e3,
                "XC": np.arange(N) * 1e3})
    Ftheta = xrft_tpu.dft(theta, dim=["XC"], shift=False,
                          true_phase=False, true_amplitude=False)
    assert isinstance(Ftheta, xr.DataArray)
    ps = xrft_tpu.power_spectrum(theta, dim=["XC", "YC"], window=True,
                                 density=False)
    assert isinstance(ps, xr.DataArray)
    iso = xrft_tpu.isotropic_power_spectrum(theta, dim=["XC", "YC"],
                                            window=True, density=False,
                                            truncate=True)
    assert isinstance(iso, xr.DataArray)
    assert iso.dims[-1] == "freq_r"
