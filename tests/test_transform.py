"""Transform-layer tests: ports of the reference's oracle-parity and
invariant genres (/root/reference/xrft/tests/test_xrft.py:57-270,1114-1341)
against numpy oracles, plus split-complex runs of the same checks.
"""

import numpy as np
import numpy.testing as npt
import pytest
import scipy.signal as sps

import xrft_tpu
from xrft_tpu import LabeledArray, fft, ifft
from xrft_tpu.config import complex_mode, fft_engine

MODES = ["native", "split"]


def make_1d(Nx=16, Lx=1.0, coords=True, seed=0):
    x = np.linspace(0, Lx, Nx)
    rng = np.random.RandomState(seed)
    c = {"x": x} if coords else None
    return LabeledArray(rng.rand(Nx), dims=["x"], coords=c)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("coords", [True, False])
def test_fft_1d(mode, coords):
    """1-D defaults: freq coords, spacing attr, numpy parity with detrend
    options (port of test_xrft.py:58-97)."""
    da = make_1d(coords=coords)
    Nx = da.sizes["x"]
    dx = float(da["x"][1] - da["x"][0]) if coords else 1

    with complex_mode(mode):
        ft = fft(da, detrend="constant", true_phase=False, true_amplitude=False)
        assert ft.dims == ("freq_x",)
        freq_expected = np.fft.fftshift(np.fft.fftfreq(Nx, dx))
        npt.assert_allclose(ft["freq_x"].values, freq_expected)
        assert ft["freq_x"].spacing == freq_expected[1] - freq_expected[0]
        data = da.values - da.values.mean()
        npt.assert_allclose(
            np.fft.fftshift(np.fft.fft(data)), ft.values, atol=1e-12
        )

        # without detrend
        ft = fft(da, true_phase=False, true_amplitude=False)
        npt.assert_allclose(np.fft.fftshift(np.fft.fft(da.values)), ft.values,
                            rtol=1e-12)

        # linear detrend vs scipy oracle
        ft = fft(da, detrend="linear", true_phase=False, true_amplitude=False)
        da_prime = sps.detrend(da.values)
        npt.assert_allclose(np.fft.fftshift(np.fft.fft(da_prime)), ft.values,
                            atol=1e-12)


def test_fft_1d_uneven_raises():
    da = make_1d()
    bad_x = da["x"].values.copy()
    bad_x[-1] *= 2
    da = LabeledArray(da.values, dims=["x"], coords={"x": bad_x})
    with pytest.raises(ValueError, match="evenly"):
        fft(da)


def test_fft_zero_spacing_raises():
    da = LabeledArray(np.random.rand(8), dims=["x"],
                      coords={"x": np.zeros(8)})
    with pytest.raises(ValueError, match="zero"):
        fft(da)


def test_fft_1d_time():
    """datetime64 coords produce frequencies in 1/seconds
    (port of test_xrft.py:99-113)."""
    time = np.arange("2000-01-01", "2000-02-01", dtype="datetime64[D]").astype(
        "datetime64[ns]"
    )
    Nt = len(time)
    da = LabeledArray(np.random.rand(Nt), dims=["time"], coords={"time": time})
    ft = fft(da, shift=False, true_phase=False, true_amplitude=False)
    dt = 24 * 3600.0
    npt.assert_allclose(ft["freq_time"].values, np.fft.fftfreq(Nt, dt))


@pytest.mark.parametrize("mode", MODES)
def test_fft_2d(mode):
    """2-D: plain, windowed+detrended parity (port of test_xrft.py:115-138)."""
    N = 16
    rng = np.random.RandomState(1)
    da = LabeledArray(rng.rand(N, N), dims=["x", "y"],
                      coords={"x": range(N), "y": range(N)})
    with complex_mode(mode):
        ft = fft(da, shift=False, true_phase=False, true_amplitude=False)
        npt.assert_allclose(ft.values, np.fft.fftn(da.values), rtol=1e-10)

        ft = fft(da, shift=False, window="hann", detrend="constant",
                 true_phase=False, true_amplitude=False)
        window = (
            sps.windows.hann(N, sym=False)
            * sps.windows.hann(N, sym=False)[:, np.newaxis]
        )
        da_prime = da.values - da.values.mean()
        npt.assert_allclose(ft.values, np.fft.fftn(da_prime * window),
                            atol=1e-11)


def test_fft_2d_decreasing_coords_ps_nonneg():
    N = 16
    da = LabeledArray(np.random.rand(N, N), dims=["x", "y"],
                      coords={"x": np.arange(N, 0, -1),
                              "y": np.arange(N, 0, -1)})
    ps = xrft_tpu.power_spectrum(da, shift=False, density=True)
    assert (ps.values >= 0.0).all()


def test_dim_str_vs_list():
    N = 16
    da = LabeledArray(np.random.rand(N, N), dims=["x", "y"],
                      coords={"x": range(N), "y": range(N)})
    a = fft(da, dim="y", shift=False, true_phase=False, true_amplitude=False)
    b = fft(da, dim=["y"], shift=False, true_phase=False, true_amplitude=False)
    npt.assert_array_equal(a.values, b.values)
    assert fft(da, dim="y").dims == ("x", "freq_y")


def test_fft_3d_partial_dims():
    N = 8
    da = LabeledArray(np.random.rand(N, N, N), dims=["time", "x", "y"],
                      coords={"time": range(N), "x": range(N),
                              "y": range(N)})
    daft = fft(da, dim=["x", "y"], shift=False, true_phase=False,
               true_amplitude=False)
    npt.assert_allclose(daft.values, np.fft.fftn(da.values, axes=[1, 2]),
                        rtol=1e-10)
    # linear detrend along one dim
    daft = fft(da, dim=["time"], shift=False, detrend="linear",
               true_phase=False, true_amplitude=False)
    da_prime = sps.detrend(da.values, axis=0)
    npt.assert_allclose(daft.values, np.fft.fftn(da_prime, axes=[0]),
                        atol=1e-11)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("coords", [True, False])
def test_fft_real_1d(mode, coords):
    """rfft 1-D parity (port of test_xrft.py:214-254)."""
    da = make_1d(coords=coords)
    Nx = da.sizes["x"]
    dx = float(da["x"][1] - da["x"][0]) if coords else 1
    with complex_mode(mode):
        ft = fft(da, real_dim="x", detrend="constant", true_phase=False,
                 true_amplitude=False)
        assert ft.dims == ("freq_x",)
        npt.assert_allclose(ft["freq_x"].values, np.fft.rfftfreq(Nx, dx))
        data = da.values - da.values.mean()
        npt.assert_allclose(np.fft.rfft(data), ft.values, atol=1e-12)

    with pytest.raises(ValueError):
        fft(da, real_dim="y", detrend="constant")


@pytest.mark.parametrize("mode", MODES)
def test_fft_real_2d(mode):
    """rfft over non-last dim: move-to-last + transpose-back parity
    (port of test_xrft.py:243-270)."""
    Nx, Ny = 16, 32
    rng = np.random.RandomState(3)
    da = LabeledArray(rng.rand(Nx, Ny), dims=["x", "y"],
                      coords={"x": range(Nx), "y": range(Ny)})
    with complex_mode(mode):
        daft = fft(da, real_dim="x", true_phase=False, true_amplitude=False)
        npt.assert_allclose(
            daft.values,
            np.fft.rfftn(da.values.transpose()).transpose(),
            rtol=1e-10, atol=1e-11,
        )
        npt.assert_allclose(
            daft.values,
            fft(da, dim=["y"], real_dim="x", true_phase=False,
                true_amplitude=False).values,
            rtol=1e-12,
        )
        npt.assert_allclose(daft.coords["freq_x"].values,
                            np.fft.rfftfreq(Nx, 1.0))
        npt.assert_allclose(daft.coords["freq_y"].values,
                            np.fft.fftfreq(Ny, 1.0))


def test_fft_nocoords_and_single_dim_window():
    """Issue-17/16 analogues: dims without coords; window on one dim."""
    data = LabeledArray(np.random.random([20, 30, 40]),
                        dims=["time", "lat", "lon"])
    fft(data, dim=["time"])
    xrft_tpu.power_spectrum(data, dim=["time"])
    data2 = LabeledArray(
        np.random.random([20, 30, 40]),
        dims=["time", "lat", "lon"],
        coords={"time": range(20), "lat": range(30), "lon": range(40)},
    )
    xrft_tpu.power_spectrum(data2, dim=["time"], window="hann")


def test_fft_bad_nondim_coord_raises():
    """Non-dimension coords sharing a transform dim are rejected
    (port of test_xrft.py:1344-1361)."""
    N = 8
    da = LabeledArray(
        np.random.rand(N, N), dims=["x", "y"],
        coords={"x": range(N), "y": range(N),
                "x2": (("x",), np.arange(N) * 2.0)},
    )
    with pytest.raises(ValueError, match="drop"):
        fft(da, dim=["x"])
    # transform over y is fine
    fft(da, dim=["y"])


def test_fft_non_numeric_coord_raises():
    da = LabeledArray(
        np.random.rand(4), dims=["x"],
        coords={"x": np.array(["a", "b", "c", "d"])},
    )
    with pytest.raises(ValueError, match="numerical or datetime"):
        fft(da)


# ---------------------------------------------------------------------------
# true_phase machinery & round trips
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_true_phase_translation_invariance(mode):
    """|spectrum| is translation-invariant and phases track the coordinate
    (port of the idea at test_xrft.py:1149-1188)."""
    N = 32
    x0 = np.arange(N) - N // 2
    sig = np.exp(-(x0**2) / 16.0)
    with complex_mode(mode):
        da1 = LabeledArray(sig, dims=["x"], coords={"x": x0 * 0.5})
        da2 = LabeledArray(sig, dims=["x"], coords={"x": x0 * 0.5 + 3.0})
        f1 = fft(da1, true_phase=True, true_amplitude=True)
        f2 = fft(da2, true_phase=True, true_amplitude=True)
        # same magnitude
        npt.assert_allclose(np.abs(f1.values), np.abs(f2.values), atol=1e-12)
        # phases differ by exp(-2i pi f * 3)
        k = f1["freq_x"].values
        npt.assert_allclose(
            f2.values, f1.values * np.exp(-2j * np.pi * k * 3.0), atol=1e-12
        )


@pytest.mark.parametrize("mode", MODES)
def test_true_phase_analytic_gaussian(mode):
    """Continuous-FT parity on a Gaussian: F(exp(-pi x^2)) = exp(-pi k^2)."""
    N = 64
    dx = 0.25
    x = (np.arange(N) - N // 2) * dx
    sig = np.exp(-np.pi * x**2)
    with complex_mode(mode):
        da = LabeledArray(sig, dims=["x"], coords={"x": x})
        F = fft(da, true_phase=True, true_amplitude=True)
        k = F["freq_x"].values
        # atol bounded by truncation/aliasing of the sampled Gaussian
        # (the reference's analytic sinc test uses atol=1e-3)
        npt.assert_allclose(F.values, np.exp(-np.pi * k**2), atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_reversed_coordinates(mode):
    """Decreasing coordinates give the same true-phase spectrum as ascending
    (port of test_xrft.py:1330-1341)."""
    N = 16
    x = np.arange(N) * 0.5
    rng = np.random.RandomState(5)
    sig = rng.randn(N)
    with complex_mode(mode):
        da_up = LabeledArray(sig, dims=["x"], coords={"x": x})
        da_dn = LabeledArray(sig[::-1].copy(), dims=["x"], coords={"x": x[::-1].copy()})
        f_up = fft(da_up, true_phase=True, true_amplitude=True)
        f_dn = fft(da_dn, true_phase=True, true_amplitude=True)
        npt.assert_allclose(f_up.values, f_dn.values, atol=1e-12)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shift", [True, False])
def test_ifft_fft_roundtrip(mode, shift):
    """ifft(fft(s)) == s including coordinates
    (port of test_xrft.py:1253-1300)."""
    N = 40
    x = (np.arange(N) - 11) * 0.3
    rng = np.random.RandomState(6)
    sig = rng.randn(N)
    with complex_mode(mode):
        da = LabeledArray(sig, dims=["x"], coords={"x": x})
        F = fft(da, true_phase=True, true_amplitude=True, shift=shift)
        lag = F["freq_x"].attrs["direct_lag"]
        back = ifft(F, true_phase=True, true_amplitude=True, lag=lag)
        npt.assert_allclose(back.values.real, sig, atol=1e-11)
        npt.assert_allclose(back["x"].values, x, atol=1e-11)


@pytest.mark.parametrize("mode", MODES)
def test_idft_dft_roundtrip_manual_lag(mode):
    N = 24
    x = np.arange(N) * 0.25 + 4.0
    rng = np.random.RandomState(7)
    sig = rng.randn(N) + 1j * rng.randn(N) if mode == "native" else rng.randn(N)
    with complex_mode(mode):
        da = LabeledArray(sig, dims=["x"], coords={"x": x})
        F = fft(da, true_phase=True, true_amplitude=True)
        back = ifft(F, true_phase=True, true_amplitude=True,
                    lag=x[N // 2])
        got = back.values if np.iscomplexobj(sig) else back.values.real
        npt.assert_allclose(got, sig, atol=1e-11)
        npt.assert_allclose(back["x"].values, x, atol=1e-11)


def test_ifft_noncentered_raises():
    """ifft requires zero-centered freq coords
    (port of test_xrft.py:1303-1312)."""
    N = 16
    F = LabeledArray(
        np.random.rand(N) + 0j, dims=["freq_x"],
        coords={"freq_x": np.fft.fftfreq(N, 0.1) + 1.0},
    )
    with pytest.raises(ValueError, match="centered"):
        ifft(F, true_phase=True, lag=0)


@pytest.mark.parametrize("mode", MODES)
def test_ifft_real_dim(mode):
    """irfft roundtrip through the public API."""
    N = 32
    x = np.arange(N) * 0.5
    rng = np.random.RandomState(8)
    sig = rng.randn(N)
    with complex_mode(mode):
        da = LabeledArray(sig, dims=["x"], coords={"x": x})
        F = fft(da, real_dim="x", true_phase=True, true_amplitude=True)
        back = ifft(F, real_dim="freq_x", true_phase=True,
                    true_amplitude=True, lag=x[N // 2])
        npt.assert_allclose(back.values, sig, atol=1e-11)


def test_matmul_engine_full_pipeline():
    """The matmul engine (split pairs) produces the same transform as the XLA
    engine through the full public API."""
    N = 48
    x = np.arange(N) * 0.1
    sig = np.random.RandomState(9).randn(N)
    da = LabeledArray(sig, dims=["x"], coords={"x": x})
    with fft_engine("xla"), complex_mode("native"):
        a = fft(da, detrend="linear", window="hann").values
    with fft_engine("matmul"), complex_mode("split"):
        b = fft(da, detrend="linear", window="hann").values
    npt.assert_allclose(a, b, atol=1e-11)


def test_lag_list_with_none():
    """lag=[value, None] fills None from direct_lag attrs
    (reference /root/reference/xrft/xrft.py:569-572)."""
    N = 16
    x = np.arange(N) * 0.5 + 2.0
    y = np.arange(N) * 0.25 + 1.0
    sig = np.random.RandomState(10).randn(N, N)
    da = LabeledArray(sig, dims=["x", "y"], coords={"x": x, "y": y})
    F = fft(da, true_phase=True, true_amplitude=True)
    back = ifft(F, true_phase=True, true_amplitude=True,
                lag=[x[N // 2], None])
    npt.assert_allclose(back.values.real, sig, atol=1e-10)
    with pytest.raises(ValueError, match="same length"):
        ifft(F, lag=[1.0])


@pytest.mark.parametrize("mode", MODES)
def test_real_dft_is_half_of_full(mode):
    """Real transform equals the conjugate-mirrored upper half of the full
    transform with true_phase (port of test_xrft.py:1231-1250)."""
    Nx = 40
    rng = np.random.RandomState(12)
    dx = rng.rand()
    xc = dx * (np.arange(-Nx // 2, -Nx // 2 + Nx)
               + rng.randint(-Nx // 2, Nx // 2))
    sig = rng.rand(Nx)
    with complex_mode(mode):
        s = LabeledArray(sig, dims=["x"], coords={"x": xc})
        s1 = fft(s, dim="x", true_phase=True, shift=True,
                 true_amplitude=False)
        s2 = fft(s, real_dim="x", true_phase=True, shift=True,
                 true_amplitude=False)
        half = np.conj(s1.values[: s1.sizes["freq_x"] // 2 + 1])[::-1]
        npt.assert_allclose(half, s2.values, atol=1e-11)


def test_spacing_tol():
    """Loose spacing_tol accepts slightly uneven grids; tight rejects
    (port of test_xrft.py test_spacing_tol)."""
    Nx = 16
    x = np.linspace(0, 1.0, Nx)
    x[-1] += 0.001
    da = LabeledArray(np.random.rand(Nx), dims=["x"], coords={"x": x})
    fft(da, spacing_tol=1e-1)
    with pytest.raises(ValueError):
        fft(da, spacing_tol=1e-4)


def test_constant_freq_coordinates_raise():
    """Constant (zero-spacing) coordinates raise on both directions
    (port of test_constant_coordinates)."""
    N = 20
    s = LabeledArray(np.random.rand(N) + 1j * np.random.rand(N),
                     dims="freq_x", coords={"freq_x": np.zeros(N)})
    with pytest.raises(ValueError):
        fft(s, true_phase=False, true_amplitude=False)
    with pytest.raises(ValueError):
        ifft(s, true_phase=False, true_amplitude=False, lag=0)


@pytest.mark.parametrize("mode", MODES)
def test_true_phase_preservation_padding(mode):
    """A signal at the same physical location but with different
    zero-padding extents yields the same true-phase spectrum
    (port of test_true_phase_preservation)."""
    rng = np.random.RandomState(21)
    x = np.arange(-15, 15)
    y = rng.rand(len(x))
    N1, N2 = 9, 14
    N3 = 5
    N4 = N1 + N2 - N3
    def padded(NL, NR):
        l = np.arange(-NL, 0) + x.min()
        r = np.arange(1, NR + 1) + x.max()
        return LabeledArray(
            np.concatenate([np.zeros(NL), y, np.zeros(NR)]),
            dims=("x",),
            coords={"x": np.concatenate([l, x, r])},
        )
    with complex_mode(mode):
        S1 = fft(padded(N1, N2), dim="x", true_phase=True,
                 true_amplitude=False)
        S2 = fft(padded(N3, N4), dim="x", true_phase=True,
                 true_amplitude=False)
        npt.assert_allclose(S1["freq_x"].values, S2["freq_x"].values)
        npt.assert_allclose(S1.values, S2.values, atol=1e-11)


def test_ifft_chunks_to_segments():
    """ifft with chunks_to_segments actually calls ifft per segment
    (reference /root/reference/xrft/xrft.py:578-579): each freq-axis chunk
    becomes an independent inverse transform, compared against a
    per-segment numpy oracle for both true_phase settings."""
    N, seg = 32, 16
    rng = np.random.RandomState(31)
    spec = rng.randn(N) + 1j * rng.randn(N)
    # a freq coord that is valid per segment: two concatenated centered
    # grids (each segment must pass ifft's zero-centering check)
    f16 = np.fft.fftshift(np.fft.fftfreq(seg, 0.5))
    daft = LabeledArray(spec, dims=["freq_t"],
                        coords={"freq_t": np.tile(f16, 2)}
                        ).chunk({"freq_t": seg})

    out = ifft(daft, dim=["freq_t"], chunks_to_segments=True,
               true_phase=True, lag=[0.0], true_amplitude=False, shift=False)
    assert out.dims == ("freq_t_segment", "t")
    ref = np.fft.ifft(np.fft.ifftshift(spec.reshape(2, seg), axes=-1), axis=-1)
    npt.assert_allclose(out.values, ref, atol=1e-11)

    out2 = ifft(daft, dim=["freq_t"], chunks_to_segments=True,
                true_phase=False, true_amplitude=False, shift=False)
    npt.assert_allclose(out2.values, np.fft.ifftshift(ref, axes=-1),
                        atol=1e-11)

    # the phase premultiply (a _binary op) must not discard the declared
    # chunks: nonzero lag exercises daft * exp(2i pi f lag) before the
    # segment reshape
    out3 = ifft(daft, dim=["freq_t"], chunks_to_segments=True,
                true_phase=True, lag=[3.0], true_amplitude=False,
                shift=False)
    pre = spec * np.exp(2j * np.pi * np.tile(f16, 2) * 3.0)
    ref3 = np.fft.ifft(np.fft.ifftshift(pre.reshape(2, seg), axes=-1),
                       axis=-1)
    npt.assert_allclose(out3.values, ref3, atol=1e-11)


def test_fft_segments_unchunked_dim_is_one_segment():
    """A transform dim with no declared chunk length is a single
    full-length segment, matching dask semantics (an unchunked dask dim
    has one chunk spanning the axis; reference
    /root/reference/xrft/xrft.py:115-119)."""
    rng = np.random.RandomState(7)
    da = LabeledArray(rng.randn(8, 12), dims=["x", "y"],
                      coords={"x": np.arange(8.0), "y": np.arange(12.0)}
                      ).chunk({"x": 4})
    out = fft(da, dim=["x", "y"], chunks_to_segments=True, shift=False,
              true_phase=False, true_amplitude=False)
    assert out.dims == ("x_segment", "freq_x", "y_segment", "freq_y")
    ref = np.fft.fftn(da.values.reshape(2, 4, 1, 12), axes=(1, 3))
    npt.assert_allclose(out.values, ref, atol=1e-11)
    # but with no chunks declared at all it still raises
    da2 = LabeledArray(rng.randn(8), dims=["x"],
                       coords={"x": np.arange(8.0)})
    with pytest.raises(ValueError, match="chunk"):
        fft(da2, dim=["x"], chunks_to_segments=True)


def test_pad_stat_kwargs():
    """pad passes stat_length / end_values / reflect_type through."""
    da = LabeledArray(np.array([1.0, 5.0, 2.0, 8.0]), dims=["x"],
                      coords={"x": np.arange(4.0)})
    p = xrft_tpu.pad(da, {"x": 2}, mode="maximum", stat_length=2)
    ref = np.pad(da.values, 2, mode="maximum", stat_length=2)
    npt.assert_allclose(p.values, ref)
    p = xrft_tpu.pad(da, {"x": 1}, mode="linear_ramp", end_values=7.0)
    ref = np.pad(da.values, 1, mode="linear_ramp", end_values=7.0)
    npt.assert_allclose(p.values, ref)
    p = xrft_tpu.pad(da, {"x": 2}, mode="reflect", reflect_type="odd")
    ref = np.pad(da.values, 2, mode="reflect", reflect_type="odd")
    npt.assert_allclose(p.values, ref)


@pytest.mark.parametrize("shape", [(15, 16), (16, 18), (12, 20), (9, 14)])
@pytest.mark.parametrize("true_phase", [True, False])
@pytest.mark.parametrize("shift", [True, False])
def test_irfft_shift_absorption_parity(shape, true_phase, shift):
    """irfft forwards its input/output shifts to the engine for
    absorption (matmul: weight constants + the packed half-length roll
    when n % 4 == 0, explicit fallback when n % 4 == 2); every flag
    combo must match the xla path bit-for-bit-in-f64.  Reference shift
    semantics: /root/reference/xrft/xrft.py:608-621."""
    import warnings as _w

    NY, NX = shape
    rng = np.random.RandomState(1)
    x = rng.randn(3, NY, NX)
    da = LabeledArray(x, dims=("t", "y", "x"),
                      coords={"y": np.arange(NY) * 0.5,
                              "x": np.arange(NX) * 0.25})
    with _w.catch_warnings():
        _w.simplefilter("ignore")
        ft = xrft_tpu.fft(da, dim=["y", "x"], real_dim="x",
                          engine="matmul", true_phase=true_phase,
                          shift=shift)
        kw = dict(dim=["freq_y", "freq_x"], real_dim="freq_x",
                  true_phase=true_phase, shift=shift,
                  lag=[float(np.arange(NY)[NY // 2] * 0.5), 0.0])
        got = xrft_tpu.ifft(ft, engine="matmul", **kw)
        ref = xrft_tpu.ifft(ft, engine="xla", **kw)
    npt.assert_allclose(np.asarray(got.values), np.asarray(ref.values),
                        atol=1e-10)


# ---------------------------------------------------------------------------
# sortby-roll absorption: natural-order frequency grids never materialize a
# device pass (the sort roll composes with the engine's absorbed input
# ifftshift into the identity).  Reference sortby: xrft.py:598.
# ---------------------------------------------------------------------------


def _all_primitives(jaxpr, prims=None):
    """Multiset of every primitive in a jaxpr, recursing into sub-jaxprs."""
    from collections import Counter

    if prims is None:
        prims = Counter()
    for eqn in jaxpr.eqns:
        prims[eqn.primitive.name] += 1
        for v in eqn.params.values():
            vals = v if isinstance(v, (tuple, list)) else [v]
            for item in vals:
                if hasattr(item, "jaxpr"):
                    _all_primitives(item.jaxpr, prims)
                elif hasattr(item, "eqns"):
                    _all_primitives(item, prims)
    return prims


@pytest.mark.parametrize("shape", [(16, 8), (15, 9), (16, 9), (12, 10)])
def test_ifft_natural_order_roundtrip(shape):
    """ifft of a natural-order (unshifted fftfreq) spectrum equals ifft of
    the same spectrum pre-sorted — the roll/ifftshift composition path."""
    import warnings as _w

    N, M = shape
    rng = np.random.RandomState(3)
    x = rng.randn(N, M) + 1j * rng.randn(N, M)
    da = LabeledArray(x, dims=("y", "x"),
                      coords={"y": np.arange(N) * 0.5,
                              "x": np.arange(M) * 0.25})
    lag = [float(np.arange(N)[N // 2] * 0.5),
           float(np.arange(M)[M // 2] * 0.25)]
    with _w.catch_warnings():
        _w.simplefilter("ignore")
        for engine in ("xla", "matmul"):
            nat = fft(da, dim=["y", "x"], shift=False, engine=engine)
            back = ifft(nat, dim=["freq_y", "freq_x"], lag=lag,
                        engine=engine)
            npt.assert_allclose(np.asarray(back.values), x, atol=1e-11)
            npt.assert_allclose(back["y"].values, da["y"].values, atol=1e-12)


def test_ifft_natural_order_jaxpr_structurally_free():
    """The natural-order and pre-sorted ifft2/irfft2 programs are
    structurally identical on the matmul engine (shifts live in the
    constant weights; the sort roll composes to the identity) — no extra
    roll/gather/reverse pass for natural order."""
    import jax

    N, M = 64, 32
    x = np.random.RandomState(0).randn(N, M).astype(np.float32)

    def counts(fy, fx):
        da = LabeledArray(x + 0.0, dims=("freq_y", "freq_x"),
                          coords={"freq_y": fy, "freq_x": fx})
        f = lambda d: ifft(d, dim=["freq_y", "freq_x"], lag=[0.0, 0.0],
                           engine="matmul")
        return _all_primitives(jax.make_jaxpr(f)(da).jaxpr)

    nat = counts(np.fft.fftfreq(N, 0.5), np.fft.fftfreq(M, 0.25))
    srt = counts(np.fft.fftshift(np.fft.fftfreq(N, 0.5)),
                 np.fft.fftshift(np.fft.fftfreq(M, 0.25)))
    assert nat == srt, (nat, srt)
    assert "gather" not in nat

    def counts_r(fy):
        da = LabeledArray(np.zeros((N, M // 2 + 1), np.complex128),
                          dims=("freq_y", "freq_x"),
                          coords={"freq_y": fy,
                                  "freq_x": np.fft.rfftfreq(M, 0.25)})
        f = lambda d: ifft(d, dim=["freq_y", "freq_x"], real_dim="freq_x",
                           lag=[0.0, 0.0], engine="matmul")
        return _all_primitives(jax.make_jaxpr(f)(da).jaxpr)

    natr = counts_r(np.fft.fftfreq(N, 0.5))
    srtr = counts_r(np.fft.fftshift(np.fft.fftfreq(N, 0.5)))
    assert natr == srtr, (natr, srtr)


@pytest.mark.parametrize("roll", [1, 3, -5])
def test_ifft_arbitrary_cyclic_roll_coords(roll):
    """A frequency grid cyclically rolled by an arbitrary amount (not the
    fftshift half) takes the single-explicit-roll path and still inverts
    exactly; an arbitrary (non-cyclic) permutation falls back to sortby."""
    import warnings as _w

    N, M = 16, 12
    rng = np.random.RandomState(7)
    x = rng.randn(N, M) + 1j * rng.randn(N, M)
    da = LabeledArray(x, dims=("y", "x"),
                      coords={"y": np.arange(N) * 0.5,
                              "x": np.arange(M) * 0.25})
    lag = [float(np.arange(N)[N // 2] * 0.5),
           float(np.arange(M)[M // 2] * 0.25)]
    with _w.catch_warnings():
        _w.simplefilter("ignore")
        ft = fft(da, dim=["y", "x"], shift=True)
        ref = ifft(ft, dim=["freq_y", "freq_x"], lag=lag)
        fv = np.asarray(ft.values)

        # cyclic roll of the freq_y axis (data + coord together)
        fy = ft["freq_y"].values
        rolled = LabeledArray(np.roll(fv, roll, axis=0), dims=ft.dims,
                              coords={"freq_y": np.roll(fy, roll),
                                      "freq_x": ft["freq_x"].values})
        got = ifft(rolled, dim=["freq_y", "freq_x"], lag=lag)
        npt.assert_allclose(np.asarray(got.values), np.asarray(ref.values),
                            atol=1e-11)

        # arbitrary permutation: sortby fallback
        perm = rng.permutation(N)
        permuted = LabeledArray(fv[perm], dims=ft.dims,
                                coords={"freq_y": fy[perm],
                                        "freq_x": ft["freq_x"].values})
        got2 = ifft(permuted, dim=["freq_y", "freq_x"], lag=lag)
        npt.assert_allclose(np.asarray(got2.values), np.asarray(ref.values),
                            atol=1e-11)
