"""Chirp-Z / zoom-FFT tests: scipy.signal.czt/zoom_fft parity (spirals,
bands, endpoints, complex input), DFT-circle equivalence, the
coordinate-aware fs default, engines/modes, jit staging, and error
contracts.  Beyond the reference (no z-plane evaluation in
/root/reference)."""

import jax
import numpy as np
import numpy.testing as npt
import pytest
import scipy.signal as sps

import xrft_tpu
from xrft_tpu import LabeledArray
from xrft_tpu.config import complex_mode, fft_engine


def make_1d(n, seed=0, complex=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(n) + (1j * rng.randn(n) if complex else 0)
    return x, LabeledArray(x, dims=["t"],
                           coords={"t": np.arange(n) * 0.5}, name="u")


@pytest.mark.parametrize("n", [64, 65])
def test_czt_default_equals_fft(n):
    """czt with defaults samples the DFT circle: czt(x) == fft(x)."""
    x, da = make_1d(n)
    got = np.asarray(xrft_tpu.czt(da).values)
    npt.assert_allclose(got, np.fft.fft(x), atol=1e-10 * n)


@pytest.mark.parametrize("complex_input", [False, True])
@pytest.mark.parametrize("n", [64, 65])
def test_czt_spiral_scipy_parity(n, complex_input):
    """Off-circle spirals (|w| != 1, |a| != 1) match scipy.signal.czt."""
    x, da = make_1d(n, seed=2, complex=complex_input)
    m, w, a = 40, 0.999 * np.exp(-2j * np.pi / 40), 1.1 * np.exp(0.3j)
    got = np.asarray(xrft_tpu.czt(da, m=m, w=w, a=a).values)
    want = sps.czt(x, m=m, w=w, a=a)
    npt.assert_allclose(got, want, atol=1e-11 * np.abs(want).max())
    assert got.shape == (m,)


@pytest.mark.parametrize("endpoint", [False, True])
def test_zoom_fft_scipy_parity(endpoint):
    x, da = make_1d(128, seed=3)
    got = xrft_tpu.zoom_fft(da, [10.0, 20.0], m=31, fs=100.0,
                            endpoint=endpoint)
    want = sps.zoom_fft(x, [10.0, 20.0], m=31, fs=100.0, endpoint=endpoint)
    npt.assert_allclose(np.asarray(got.values), want,
                        atol=1e-11 * np.abs(want).max())
    # scalar fn = band [0, fn]
    g2 = xrft_tpu.zoom_fft(da, 15.0, m=16, fs=100.0, endpoint=endpoint)
    w2 = sps.zoom_fft(x, 15.0, m=16, fs=100.0, endpoint=endpoint)
    npt.assert_allclose(np.asarray(g2.values), w2,
                        atol=1e-11 * np.abs(w2).max())


def test_zoom_fft_coordinate_aware_fs_and_freq_coord():
    """fs defaults to 1/spacing of the dim's coordinate; the output dim is
    freq_<dim> carrying the actual frequency grid (beyond scipy)."""
    x, da = make_1d(128, seed=4)  # spacing 0.5 -> fs = 2.0
    got = xrft_tpu.zoom_fft(da, [0.2, 0.8], m=64)
    want = sps.zoom_fft(x, [0.2, 0.8], m=64, fs=2.0)
    npt.assert_allclose(np.asarray(got.values), want,
                        atol=1e-11 * np.abs(want).max())
    assert got.dims == ("freq_t",)
    f = got.coords["freq_t"].values
    npt.assert_allclose(f, 0.2 + np.arange(64) * (0.6 / 64))
    npt.assert_allclose(got.coords["freq_t"].attrs["spacing"], 0.6 / 64)
    # zoomed band == the matching slice of the full spectrum's grid
    full = np.fft.fftfreq(128, d=0.5)
    assert f[0] >= full.min() and f[-1] <= full.max()


def test_zoom_fft_matches_dense_fft_on_grid():
    """Zooming onto exact DFT bins reproduces those bins of fft(x)."""
    n = 256
    x, da = make_1d(n, seed=5)
    f = np.fft.fftfreq(n, d=0.5)  # coord spacing 0.5 -> fs = 2.0
    # bins 8..23 inclusive
    got = xrft_tpu.zoom_fft(da, [f[8], f[24]], m=16)
    want = np.fft.fft(x)[8:24]
    npt.assert_allclose(np.asarray(got.values), want,
                        atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("mode", ["native", "split"])
@pytest.mark.parametrize("engine", ["xla", "matmul"])
def test_czt_engines_and_modes(mode, engine):
    x, da = make_1d(100, seed=6)
    with complex_mode(mode), fft_engine(engine):
        got = np.asarray(xrft_tpu.czt(da, m=40).values)
    want = sps.czt(x, m=40)
    npt.assert_allclose(got, want, atol=1e-10 * np.abs(want).max())


def test_czt_batch_dims_and_coords():
    rng = np.random.RandomState(7)
    x = rng.randn(3, 50)
    da = LabeledArray(x, dims=["z", "t"],
                      coords={"z": np.arange(3.0), "t": np.arange(50.0)})
    out = xrft_tpu.czt(da, dim="t", m=20)
    npt.assert_allclose(np.asarray(out.values), sps.czt(x, m=20, axis=-1),
                        atol=1e-11 * np.abs(np.asarray(out.values)).max())
    assert out.dims == ("z", "t")
    npt.assert_allclose(out.coords["z"].values, da.coords["z"].values)
    npt.assert_allclose(out.coords["t"].values, np.arange(20))


def test_czt_is_jit_traceable():
    x, da = make_1d(64, seed=8)

    @jax.jit
    def f(la):
        return xrft_tpu.zoom_fft(la, [0.2, 0.6], m=32).data

    from xrft_tpu.ops.carray import to_numpy
    got = to_numpy(f(da))
    want = sps.zoom_fft(x, [0.2, 0.6], m=32, fs=2.0)
    npt.assert_allclose(got, want, atol=1e-11 * np.abs(want).max())


def test_czt_dynamic_range_warning():
    """An off-circle spiral whose chirp exceeds the compute dtype's
    exponent range warns at trace time (device f32 would over/underflow
    silently otherwise)."""
    n = 4096
    rng = np.random.RandomState(9)
    da = LabeledArray(rng.randn(n).astype(np.float32), dims=["t"],
                      coords={"t": np.arange(n) * 1.0})
    with pytest.warns(UserWarning, match="chirp dynamic range"):
        xrft_tpu.czt(da, m=512, w=0.99999 * np.exp(-2j * np.pi / 512))


def test_error_contracts():
    x, da = make_1d(16)
    with pytest.raises(ValueError, match="m must be a positive"):
        xrft_tpu.czt(da, m=0)
    with pytest.raises(ValueError, match="w must be nonzero"):
        xrft_tpu.czt(da, w=0.0)
    with pytest.raises(ValueError, match="fn must be a scalar"):
        xrft_tpu.zoom_fft(da, [1.0, 2.0, 3.0])
    with pytest.raises(ValueError, match="m must be a positive"):
        xrft_tpu.zoom_fft(da, 0.5, m=-1)
