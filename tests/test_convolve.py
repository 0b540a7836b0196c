"""fftconvolve/correlate tests: scipy.signal parity (1-D/2-D, all modes,
real/complex, swapped sizes), kernel broadcasting over batch dims, the
coordinate-aware support/lag grids, engines/modes, jit staging, and error
contracts.  Beyond the reference (no convolution in /root/reference)."""

import jax
import numpy as np
import numpy.testing as npt
import pytest
import scipy.signal as sps

import xrft_tpu
from xrft_tpu import LabeledArray
from xrft_tpu.config import complex_mode, fft_engine


def arr(x, dims, coords=None):
    return LabeledArray(np.asarray(x), dims=dims, coords=coords or {})


@pytest.mark.parametrize("complex_input", [False, True])
@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("n1,n2", [(20, 7), (20, 8), (19, 8), (7, 20)])
def test_fftconvolve_1d_scipy_parity(n1, n2, mode, complex_input):
    rng = np.random.RandomState(0)
    x = rng.randn(n1) + (1j * rng.randn(n1) if complex_input else 0)
    y = rng.randn(n2) + (1j * rng.randn(n2) if complex_input else 0)
    got = np.asarray(xrft_tpu.fftconvolve(
        arr(x, ["t"]), arr(y, ["t"]), mode=mode).values)
    want = sps.fftconvolve(x, y, mode=mode)
    npt.assert_allclose(got, want, atol=1e-12 * max(1.0, np.abs(want).max()))
    assert got.shape == want.shape
    assert (got.dtype.kind == "c") == complex_input


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_fftconvolve_2d_scipy_parity(mode):
    rng = np.random.RandomState(1)
    x, y = rng.randn(12, 15), rng.randn(5, 4)
    got = np.asarray(xrft_tpu.fftconvolve(
        arr(x, ["y", "x"]), arr(y, ["y", "x"]), mode=mode).values)
    want = sps.fftconvolve(x, y, mode=mode)
    npt.assert_allclose(got, want, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("complex_input", [False, True])
@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("n1,n2", [(20, 7), (20, 8), (19, 8)])
def test_correlate_scipy_parity(n1, n2, mode, complex_input):
    rng = np.random.RandomState(2)
    x = rng.randn(n1) + (1j * rng.randn(n1) if complex_input else 0)
    y = rng.randn(n2) + (1j * rng.randn(n2) if complex_input else 0)
    got = np.asarray(xrft_tpu.correlate(
        arr(x, ["t"]), arr(y, ["t"]), mode=mode).values)
    want = sps.correlate(x, y, mode=mode, method="fft")
    npt.assert_allclose(got, want, atol=1e-12 * max(1.0, np.abs(want).max()))


def test_correlate_2d_scipy_parity():
    rng = np.random.RandomState(3)
    x, y = rng.randn(10, 12) + 1j * rng.randn(10, 12), \
        rng.randn(4, 5) - 1j * rng.randn(4, 5)
    got = np.asarray(xrft_tpu.correlate(
        arr(x, ["y", "x"]), arr(y, ["y", "x"]), mode="full").values)
    want = sps.correlate(x, y, mode="full", method="fft")
    npt.assert_allclose(got, want, atol=1e-12 * np.abs(want).max())


def test_kernel_broadcast_over_batch_dims():
    """A kernel without the batch dim convolves every batch row."""
    rng = np.random.RandomState(4)
    x, k = rng.randn(3, 30), rng.randn(7)
    got = np.asarray(xrft_tpu.fftconvolve(
        arr(x, ["z", "t"]), arr(k, ["t"]), dims="t", mode="same").values)
    want = np.stack([sps.fftconvolve(row, k, mode="same") for row in x])
    npt.assert_allclose(got, want, atol=1e-12 * np.abs(want).max())


def test_convolution_support_coordinate():
    """With matching-spacing coords the output grid is x0+y0+k*dx."""
    x = np.ones(8)
    k = np.ones(3)
    da = arr(x, ["t"], {"t": 2.0 + np.arange(8) * 0.5})
    dk = arr(k, ["t"], {"t": -1.0 + np.arange(3) * 0.5})
    out = xrft_tpu.fftconvolve(da, dk, mode="full")
    npt.assert_allclose(out.coords["t"].values,
                        1.0 + np.arange(10) * 0.5, atol=1e-12)
    npt.assert_allclose(out.coords["t"].attrs["spacing"], 0.5)
    # same-mode crop shifts the origin consistently
    o2 = xrft_tpu.fftconvolve(da, dk, mode="same")
    npt.assert_allclose(o2.coords["t"].values,
                        1.0 + (1 + np.arange(8)) * 0.5, atol=1e-12)


def test_autocorrelation_lag_coordinate_peaks_at_zero():
    rng = np.random.RandomState(5)
    x = rng.randn(64)
    da = arr(x, ["t"], {"t": 10.0 + np.arange(64) * 0.25})
    out = xrft_tpu.correlate(da, da, mode="full")
    lags = out.coords["t"].values
    npt.assert_allclose(lags, (np.arange(127) - 63) * 0.25, atol=1e-12)
    vals = np.asarray(out.values)
    assert lags[np.argmax(vals)] == 0.0
    npt.assert_allclose(vals.max(), (x * x).sum(), rtol=1e-10)


def test_mismatched_spacing_drops_coord():
    da = arr(np.ones(8), ["t"], {"t": np.arange(8) * 0.5})
    dk = arr(np.ones(3), ["t"], {"t": np.arange(3) * 0.25})
    out = xrft_tpu.fftconvolve(da, dk, mode="full")
    assert "t" not in out.coords


@pytest.mark.parametrize("mode", ["native", "split"])
@pytest.mark.parametrize("engine", ["xla", "matmul"])
def test_convolve_engines_and_modes(mode, engine):
    rng = np.random.RandomState(6)
    x, k = rng.randn(40), rng.randn(9)
    with complex_mode(mode), fft_engine(engine):
        got = np.asarray(xrft_tpu.fftconvolve(
            arr(x, ["t"]), arr(k, ["t"]), mode="same").values)
    npt.assert_allclose(got, sps.fftconvolve(x, k, mode="same"), atol=1e-10)


def test_convolve_is_jit_traceable():
    rng = np.random.RandomState(7)
    x, k = rng.randn(32), rng.randn(5)
    da, dk = arr(x, ["t"]), arr(k, ["t"])

    @jax.jit
    def f(a, b):
        return xrft_tpu.correlate(a, b, mode="valid").data

    from xrft_tpu.ops.carray import to_numpy
    got = np.real(to_numpy(f(da, dk)))
    npt.assert_allclose(got, sps.correlate(x, k, mode="valid"), atol=1e-12)


# ---------------------------------------------------------------------------
# method='direct' (conv_general_dilated) — scipy.signal.convolve/
# correlate(method='direct') parity, dispatch, and error contracts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("complex_input", [False, True])
@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("n1,n2", [(20, 7), (20, 8), (19, 8), (16, 1)])
def test_convolve_direct_1d_scipy_parity(n1, n2, mode, complex_input):
    rng = np.random.RandomState(10)
    x = rng.randn(n1) + (1j * rng.randn(n1) if complex_input else 0)
    y = rng.randn(n2) + (1j * rng.randn(n2) if complex_input else 0)
    got = np.asarray(xrft_tpu.convolve(
        arr(x, ["t"]), arr(y, ["t"]), mode=mode, method="direct").values)
    want = sps.convolve(x, y, mode=mode, method="direct")
    npt.assert_allclose(got, want, atol=1e-12 * max(1.0, np.abs(want).max()))
    assert got.shape == want.shape
    assert (got.dtype.kind == "c") == complex_input


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_convolve_direct_2d_batch_scipy_parity(mode):
    rng = np.random.RandomState(11)
    x, k = rng.randn(3, 12, 15), rng.randn(5, 4)
    got = np.asarray(xrft_tpu.convolve(
        arr(x, ["z", "y", "x"]), arr(k, ["y", "x"]), dims=["y", "x"],
        mode=mode, method="direct").values)
    want = np.stack([sps.convolve(f, k, mode=mode, method="direct")
                     for f in x])
    npt.assert_allclose(got, want, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("complex_input", [False, True])
@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("n1,n2", [(20, 7), (20, 8), (19, 8)])
def test_correlate_direct_scipy_parity(n1, n2, mode, complex_input):
    rng = np.random.RandomState(12)
    x = rng.randn(n1) + (1j * rng.randn(n1) if complex_input else 0)
    y = rng.randn(n2) + (1j * rng.randn(n2) if complex_input else 0)
    got = np.asarray(xrft_tpu.correlate(
        arr(x, ["t"]), arr(y, ["t"]), mode=mode, method="direct").values)
    want = sps.correlate(x, y, mode=mode, method="direct")
    npt.assert_allclose(got, want, atol=1e-12 * max(1.0, np.abs(want).max()))


def test_correlate_direct_mixed_kind_2d():
    """Real field x complex kernel and vice versa, 2-D."""
    rng = np.random.RandomState(13)
    x = rng.randn(10, 12)
    y = rng.randn(4, 5) - 1j * rng.randn(4, 5)
    got = np.asarray(xrft_tpu.correlate(
        arr(x, ["y", "x"]), arr(y, ["y", "x"]), mode="full",
        method="direct").values)
    want = sps.correlate(x, y, mode="full", method="direct")
    npt.assert_allclose(got, want, atol=1e-12 * np.abs(want).max())
    got2 = np.asarray(xrft_tpu.convolve(
        arr(y, ["y", "x"]), arr(y[:3, :3], ["y", "x"]), mode="same",
        method="direct").values)
    want2 = sps.convolve(y, y[:3, :3], mode="same", method="direct")
    npt.assert_allclose(got2, want2, atol=1e-12 * np.abs(want2).max())


def test_convolve_method_fft_matches_fftconvolve():
    rng = np.random.RandomState(14)
    x, k = rng.randn(30), rng.randn(50)  # kernel larger: direct ineligible
    a = np.asarray(xrft_tpu.convolve(
        arr(x, ["t"]), arr(k, ["t"]), mode="full", method="fft").values)
    b = np.asarray(xrft_tpu.fftconvolve(
        arr(x, ["t"]), arr(k, ["t"]), mode="full").values)
    npt.assert_array_equal(a, b)
    # auto on an ineligible-for-direct pair silently picks fft
    c = np.asarray(xrft_tpu.convolve(
        arr(x, ["t"]), arr(k, ["t"]), mode="full", method="auto").values)
    npt.assert_array_equal(c, b)


def test_convolve_direct_coordinate_grids_match_fft_route():
    rng = np.random.RandomState(15)
    x, k = rng.randn(16), rng.randn(5)
    da = arr(x, ["t"], {"t": 2.0 + np.arange(16) * 0.5})
    dk = arr(k, ["t"], {"t": -1.0 + np.arange(5) * 0.5})
    for mode in ("full", "same", "valid"):
        d = xrft_tpu.convolve(da, dk, mode=mode, method="direct")
        f = xrft_tpu.fftconvolve(da, dk, mode=mode)
        npt.assert_allclose(d.coords["t"].values, f.coords["t"].values,
                            atol=1e-12)
        r_d = xrft_tpu.correlate(da, dk, mode=mode, method="direct")
        r_f = xrft_tpu.correlate(da, dk, mode=mode, method="fft")
        npt.assert_allclose(r_d.coords["t"].values, r_f.coords["t"].values,
                            atol=1e-12)


def test_choose_conv_method():
    from xrft_tpu.config import config

    small = arr(np.ones(8), ["t"])
    field = arr(np.ones(4096), ["t"])
    assert xrft_tpu.choose_conv_method(field, small) == "direct"
    big = arr(np.ones(config.direct_conv_max + 1), ["t"])
    wide = arr(np.ones(2 * config.direct_conv_max), ["t"])
    assert xrft_tpu.choose_conv_method(wide, big) == "fft"
    # ineligible shapes always pick fft: kernel larger than data ...
    assert xrft_tpu.choose_conv_method(small, field) == "fft"
    # ... or a kernel carrying a batch (non-transform) dim
    da = arr(np.ones((4, 32)), ["z", "t"])
    dk = arr(np.ones((4, 3)), ["z", "t"])
    assert xrft_tpu.choose_conv_method(da, dk, dims="t") == "fft"
    # measure=True times both and returns one of them
    assert xrft_tpu.choose_conv_method(
        arr(np.ones(64), ["t"]), small, measure=True) in ("direct", "fft")


def test_convolve_direct_is_jit_traceable():
    rng = np.random.RandomState(16)
    x, k = rng.randn(32), rng.randn(5)
    da, dk = arr(x, ["t"]), arr(k, ["t"])

    @jax.jit
    def f(a, b):
        return xrft_tpu.convolve(a, b, mode="valid", method="direct").data

    from xrft_tpu.ops.carray import to_numpy
    got = np.real(to_numpy(f(da, dk)))
    npt.assert_allclose(got, sps.convolve(x, k, mode="valid"), atol=1e-12)


def test_convolve_direct_split_complex():
    """The split-pair representation through the direct route."""
    rng = np.random.RandomState(17)
    x = rng.randn(24) + 1j * rng.randn(24)
    k = rng.randn(6) + 1j * rng.randn(6)
    with complex_mode("split"):
        got = np.asarray(xrft_tpu.convolve(
            arr(x, ["t"]), arr(k, ["t"]), mode="same",
            method="direct").values)
    npt.assert_allclose(got, sps.convolve(x, k, mode="same"), atol=1e-10)


def test_convolve_method_error_contracts():
    da = arr(np.ones((4, 8)), ["z", "t"])
    dk = arr(np.ones((4, 3)), ["z", "t"])
    with pytest.raises(ValueError, match="method='direct' is unavailable"):
        xrft_tpu.convolve(da, dk, dims="t", mode="full", method="direct")
    with pytest.raises(ValueError, match="kernel is larger than the data"):
        xrft_tpu.convolve(arr(np.ones(4), ["t"]), arr(np.ones(9), ["t"]),
                          method="direct")
    with pytest.raises(ValueError, match="method must be"):
        xrft_tpu.convolve(da, arr(np.ones(3), ["t"]), method="bogus")
    with pytest.raises(ValueError, match="inconsistent coord"):
        from xrft_tpu.labeled import Coord
        bad = arr(np.ones(3), ["t"], {"t": np.arange(3) * 1.0})
        bad.coords["t"] = Coord(("t",), np.arange(5) * 1.0, None, "t")
        xrft_tpu.convolve(arr(np.ones(8), ["t"]), bad, method="direct")
    with pytest.raises(ValueError, match="mode must be"):
        xrft_tpu.convolve(arr(np.ones(8), ["t"]), arr(np.ones(3), ["t"]),
                          mode="bogus", method="direct")


def test_error_contracts():
    da = arr(np.ones((4, 8)), ["z", "t"])
    dk = arr(np.ones(3), ["t"])
    with pytest.raises(ValueError, match="mode must be"):
        xrft_tpu.fftconvolve(da, dk, dims="t", mode="bogus")
    with pytest.raises(ValueError, match="must be present in both"):
        xrft_tpu.fftconvolve(da, dk, dims="z")
    with pytest.raises(ValueError, match="not present in the first"):
        xrft_tpu.fftconvolve(dk, arr(np.ones((2, 3)), ["q", "t"]))
    with pytest.raises(ValueError, match="share no dims"):
        xrft_tpu.fftconvolve(dk, arr(np.ones(3), ["s"]))
    with pytest.raises(ValueError, match="mismatched sizes"):
        xrft_tpu.fftconvolve(da, arr(np.ones((3, 8)), ["z", "t"]), dims="t")
    with pytest.raises(ValueError, match="one operand must be at least"):
        xrft_tpu.fftconvolve(arr(np.ones((4, 8)), ["z", "t"]),
                             arr(np.ones((6, 3)), ["z", "t"]), mode="valid")
