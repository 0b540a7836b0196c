"""Spectral-estimator tests: Parseval invariants, scipy.periodogram parity,
window corrections, cross spectra (ports of
/root/reference/xrft/tests/test_xrft.py:340-520,693-842).
"""

import numpy as np
import numpy.testing as npt
import pytest
import scipy.signal as sps

import xrft_tpu
from xrft_tpu import LabeledArray, cross_phase, cross_spectrum, power_spectrum
from xrft_tpu.config import complex_mode

MODES = ["native", "split"]


def make_2d(N=16, seed=0):
    rng = np.random.RandomState(seed)
    return LabeledArray(rng.rand(N, N), dims=["x", "y"],
                        coords={"x": range(N), "y": range(N)})


@pytest.mark.parametrize("mode", MODES)
def test_power_spectrum_periodogram_parity(mode):
    """power_spectrum(density) == scipy.signal.periodogram
    (port of test_xrft.py:400-404)."""
    N = 16
    rng = np.random.RandomState(0)
    da = LabeledArray(rng.rand(N), dims=["x"], coords={"x": range(N)})
    f_scipy, p_scipy = sps.periodogram(
        da.values, window="rectangular", return_onesided=True
    )
    with complex_mode(mode):
        ps = power_spectrum(da, dim="x", real_dim="x", detrend="constant")
    npt.assert_allclose(ps.values, p_scipy, atol=1e-11)


@pytest.mark.parametrize("detrend", [False, "constant", "linear"])
@pytest.mark.parametrize("noverlap", [0, 50])
def test_welch_detrend_scipy_parity(noverlap, detrend):
    """Per-segment detrending under Welch (segments stack first, detrend
    applies over the transform dims of each segment) matches
    scipy.signal.welch's detrend= exactly, with and without overlap."""
    fs, L = 400.0, 100
    rng = np.random.RandomState(7)
    tt = np.arange(1200) / fs
    x = np.sin(2 * np.pi * 30 * tt) + 0.3 * rng.randn(tt.size) + 0.005 * tt
    da = LabeledArray(x, dims=["t"], coords={"t": tt}).chunk({"t": L})
    ps = power_spectrum(
        da, dim="t", real_dim="t", window="hann", chunks_to_segments=True,
        segment_overlap=noverlap or None, window_correction=True,
        detrend=detrend or None,
    ).mean("t_segment")
    f_ref, p_ref = sps.welch(x, fs=fs, window="hann", nperseg=L,
                             noverlap=noverlap, detrend=detrend)
    npt.assert_allclose(ps["freq_t"].values, f_ref)
    npt.assert_allclose(np.asarray(ps.values), p_ref, rtol=1e-5,
                        atol=1e-8 * p_ref.max())


def test_median_welch_scipy_parity():
    """Robust (median-averaged) Welch: LabeledArray.median over the
    segment dim, divided by the chi2 median bias, equals
    scipy.signal.welch(average='median')."""
    fs, L = 400.0, 100
    rng = np.random.RandomState(7)
    tt = np.arange(1200) / fs
    x = np.sin(2 * np.pi * 30 * tt) + 0.3 * rng.randn(tt.size)
    da = LabeledArray(x, dims=["t"], coords={"t": tt}).chunk({"t": L})
    ps = power_spectrum(da, dim="t", real_dim="t", window="hann",
                        chunks_to_segments=True, window_correction=True)
    nseg = ps.sizes["t_segment"]
    # chi2 median bias (scipy _median_bias): 1 + sum(1/(2k+1) - 1/2k)
    ii2 = 2 * np.arange(1.0, (nseg - 1) // 2 + 1)
    bias = 1 + np.sum(1.0 / (ii2 + 1) - 1.0 / ii2)
    med = np.asarray(ps.median("t_segment").values) / bias
    f_ref, p_ref = sps.welch(x, fs=fs, window="hann", nperseg=L,
                             noverlap=0, detrend=False, average="median")
    npt.assert_allclose(med, p_ref, rtol=1e-5, atol=1e-8 * p_ref.max())


@pytest.mark.parametrize("noverlap", [0, 50, 30])
@pytest.mark.parametrize("window_type", ["hann", "boxcar"])
def test_one_sided_welch_scipy_parity(window_type, noverlap):
    """Segment-mean of power_spectrum(real_dim=..., chunks_to_segments=True,
    window_correction=True) == scipy.signal.welch(noverlap=..., detrend=False)
    — the one-sided Welch convention (real-dim doubling except DC/Nyquist,
    density scaling) matches scipy's exactly, including overlapping
    segments via segment_overlap (beyond the reference: dask chunks cannot
    overlap).  Exercises the fused one-sided Welch route end to end against
    an external oracle (reference one-sided convention:
    /root/reference/xrft/xrft.py:673-682,742-748)."""
    fs = 400.0
    nperseg = 100
    rng = np.random.RandomState(7)
    tt = np.arange(1200) / fs
    x = np.sin(2 * np.pi * 30 * tt) + 0.3 * rng.randn(tt.size)
    x_da = LabeledArray(x, dims=["t"], coords={"t": tt}).chunk({"t": nperseg})

    ps = power_spectrum(
        x_da, dim="t", real_dim="t", window=window_type,
        chunks_to_segments=True, window_correction=True,
        segment_overlap=noverlap or None,
    ).mean("t_segment")
    f_ref, p_ref = sps.welch(
        x, fs=fs, window=window_type, nperseg=nperseg, noverlap=noverlap,
        detrend=False,
    )
    npt.assert_allclose(ps["freq_t"].values, f_ref)
    npt.assert_allclose(np.asarray(ps.values), p_ref, rtol=1e-5,
                        atol=1e-8 * p_ref.max())


@pytest.mark.parametrize("noverlap", [0, 50])
def test_cross_spectrum_csd_scipy_parity(noverlap):
    """Segment-mean one-sided cross_spectrum == conj(scipy.signal.csd):
    the reference convention is F(da1)·conj(F(da2))
    (/root/reference/xrft/xrft.py:825) while scipy computes
    conj(F(x))·F(y).  Covers the fused conjugated-product Welch route
    with and without segment_overlap."""
    fs, nperseg = 400.0, 100
    rng = np.random.RandomState(7)
    tt = np.arange(1200) / fs
    x = np.sin(2 * np.pi * 30 * tt) + 0.3 * rng.randn(tt.size)
    y = np.cos(2 * np.pi * 30 * tt) + 0.3 * rng.randn(tt.size)
    xa = LabeledArray(x, dims=["t"], coords={"t": tt}).chunk({"t": nperseg})
    ya = LabeledArray(y, dims=["t"], coords={"t": tt}).chunk({"t": nperseg})

    cs = cross_spectrum(xa, ya, dim="t", real_dim="t", window="hann",
                        chunks_to_segments=True, window_correction=True,
                        segment_overlap=noverlap or None).mean("t_segment")
    f_ref, p_ref = sps.csd(x, y, fs=fs, window="hann", nperseg=nperseg,
                           noverlap=noverlap, detrend=False)
    npt.assert_allclose(cs["freq_t"].values, f_ref)
    npt.assert_allclose(np.asarray(cs.values), p_ref.conj(), rtol=1e-5,
                        atol=1e-7 * np.abs(p_ref).max())


@pytest.mark.parametrize("noverlap", [0, 50])
def test_coherence_scipy_parity(noverlap):
    """coherence(...) == scipy.signal.coherence (Welch-averaged
    magnitude-squared coherence; beyond the reference).  A shared 30 Hz
    component in independent noise: coherence near 1 at 30 Hz, small
    elsewhere."""
    fs, nperseg = 400.0, 100
    rng = np.random.RandomState(9)
    tt = np.arange(2000) / fs
    s = np.sin(2 * np.pi * 30 * tt)
    x = s + 0.5 * rng.randn(tt.size)
    y = 0.7 * s + 0.5 * rng.randn(tt.size)
    xa = LabeledArray(x, dims=["t"], coords={"t": tt},
                      name="x").chunk({"t": nperseg})
    ya = LabeledArray(y, dims=["t"], coords={"t": tt},
                      name="y").chunk({"t": nperseg})

    coh = xrft_tpu.coherence(xa, ya, dim="t", real_dim="t", window="hann",
                             chunks_to_segments=True,
                             segment_overlap=noverlap or None)
    f_ref, c_ref = sps.coherence(x, y, fs=fs, window="hann",
                                 nperseg=nperseg, noverlap=noverlap,
                                 detrend=False)
    assert coh.name == "x_y_coherence"
    npt.assert_allclose(coh["freq_t"].values, f_ref)
    npt.assert_allclose(np.asarray(coh.values), c_ref, rtol=1e-4, atol=1e-6)
    v = np.asarray(coh.values)
    assert v.min() >= 0.0 and v.max() <= 1.0 + 1e-9
    assert v[np.argmin(np.abs(f_ref - 30.0))] > 0.9


def test_coherence_hp_engine():
    """coherence(engine='hp') degrades the df64 estimates to f32 for the
    ratio (normalized statistic; scalings cancel) instead of crashing on
    DF64 arithmetic."""
    rng = np.random.RandomState(3)
    tt = np.arange(128) * 0.5
    xa = LabeledArray(np.sin(tt) + 0.3 * rng.randn(128), dims=["t"],
                      coords={"t": tt}).chunk({"t": 32})
    ya = LabeledArray(0.5 * np.sin(tt) + 0.3 * rng.randn(128), dims=["t"],
                      coords={"t": tt}).chunk({"t": 32})
    coh32 = xrft_tpu.coherence(xa, ya, dim="t", chunks_to_segments=True)
    coh_hp = xrft_tpu.coherence(xa, ya, dim="t", chunks_to_segments=True,
                                engine="hp")
    npt.assert_allclose(np.asarray(coh_hp.values),
                        np.asarray(coh32.values), rtol=1e-4, atol=1e-6)


def test_segment_overlap_chunklen_exceeds_axis_raises():
    da = LabeledArray(np.random.rand(128), dims=["t"],
                      coords={"t": np.arange(128.0)}).chunk({"t": 200})
    with pytest.raises(ValueError, match="exceeds dim"):
        power_spectrum(da, dim="t", chunks_to_segments=True,
                       segment_overlap=50)


def test_coherence_unsegmented_warns_identically_one():
    rng = np.random.RandomState(2)
    tt = np.arange(64.0)
    xa = LabeledArray(rng.randn(64), dims=["t"], coords={"t": tt})
    ya = LabeledArray(rng.randn(64), dims=["t"], coords={"t": tt})
    with pytest.warns(UserWarning, match="identically 1"):
        coh = xrft_tpu.coherence(xa, ya, dim="t")
    npt.assert_allclose(np.asarray(coh.values), 1.0, rtol=1e-5)


def test_segment_overlap_fraction_and_errors():
    """segment_overlap accepts a float fraction of the segment length;
    rejects use without chunks_to_segments, out-of-range values, and
    non-transform dims; warns when trailing samples are dropped."""
    rng = np.random.RandomState(3)
    x = rng.randn(128)
    da = LabeledArray(x, dims=["t"], coords={"t": np.arange(128.0)})
    dac = da.chunk({"t": 32})

    ps_frac = power_spectrum(dac, dim="t", chunks_to_segments=True,
                             segment_overlap=0.5)
    ps_samp = power_spectrum(dac, dim="t", chunks_to_segments=True,
                             segment_overlap=16)
    assert ps_frac.sizes["t_segment"] == (128 - 32) // 16 + 1 == 7
    npt.assert_allclose(np.asarray(ps_frac.values),
                        np.asarray(ps_samp.values))

    with pytest.raises(ValueError, match="requires chunks_to_segments"):
        power_spectrum(da, dim="t", segment_overlap=16)
    with pytest.raises(ValueError, match="requires chunks_to_segments"):
        xrft_tpu.fft(dac, dim="t", segment_overlap=16)
    with pytest.raises(ValueError, match="must be in"):
        power_spectrum(dac, dim="t", chunks_to_segments=True,
                       segment_overlap=32)
    with pytest.raises(ValueError, match="must be in"):
        power_spectrum(dac, dim="t", chunks_to_segments=True,
                       segment_overlap=1.0)
    with pytest.raises(ValueError, match="non-transform dims"):
        power_spectrum(dac, dim="t", chunks_to_segments=True,
                       segment_overlap={"z": 4})

    # 128 - 33 segments of hop 23: drops a tail -> warns, matches manual
    da33 = da.chunk({"t": 33})
    with pytest.warns(UserWarning, match="drops the last"):
        ft = xrft_tpu.fft(da33, dim="t", chunks_to_segments=True,
                          segment_overlap=10, true_phase=False,
                          true_amplitude=False, shift=False)
    nseg = (128 - 33) // 23 + 1
    assert ft.sizes["t_segment"] == nseg
    manual = np.stack([np.fft.fft(x[i * 23:i * 23 + 33])
                       for i in range(nseg)])
    npt.assert_allclose(np.asarray(ft.values), manual, atol=1e-4)


def test_segment_overlap_2d_and_hp():
    """Overlap composes with a second (non-overlapping) segmented dim and
    with engine='hp' (quad-limb slice-stack path)."""
    rng = np.random.RandomState(5)
    x = rng.randn(4, 64)
    da = LabeledArray(x, dims=["y", "t"],
                      coords={"y": np.arange(4.0), "t": np.arange(64.0)})
    da2 = da.chunk({"y": 2, "t": 16})
    ps = power_spectrum(da2, dim=["y", "t"], chunks_to_segments=True,
                        segment_overlap={"t": 8})
    assert ps.sizes["y_segment"] == 2 and ps.sizes["t_segment"] == 7

    da1 = da.chunk({"t": 16})
    ps32 = power_spectrum(da1, dim="t", chunks_to_segments=True,
                          segment_overlap=8, detrend="constant",
                          window="hann")
    ps_hp = power_spectrum(da1, dim="t", chunks_to_segments=True,
                           segment_overlap=8, detrend="constant",
                           window="hann", engine="hp")
    npt.assert_allclose(np.asarray(ps_hp.values), np.asarray(ps32.values),
                        rtol=2e-5, atol=1e-7)


@pytest.mark.parametrize("window_type", ["hann", "bartlett", "tukey", "flattop"])
def test_window_correction_energy_and_amplitude(window_type):
    """Windowed PSD integrates to RMS^2 (density) and recovers peak
    amplitude (spectrum) after correction (port of test_xrft.py:405-442)."""
    A = 20
    fs = 1e4
    n_segments = int(fs // 10)
    fsig = 300
    tt = np.arange(fs) / fs
    x = A * np.sin(2 * np.pi * fsig * tt)
    x_da = LabeledArray(x, dims=["t"], coords={"t": tt}).chunk({"t": n_segments})

    ps = power_spectrum(
        x_da, dim="t", window=window_type, chunks_to_segments=True,
        window_correction=True,
    ).mean("t_segment")
    npt.assert_allclose(
        np.sqrt(np.trapezoid(ps.values, ps["freq_t"].values)),
        A * np.sqrt(2) / 2,
        rtol=1e-3,
    )

    ps = power_spectrum(
        x_da, dim="t", window=window_type, chunks_to_segments=True,
        scaling="spectrum", window_correction=True,
    ).mean("t_segment")
    i = int(np.argmin(np.abs(ps["freq_t"].values - fsig)))
    npt.assert_allclose(ps.values[i], 0.5 * A**2 / 2.0)


def test_window_correction_requires_window():
    da = make_2d()
    with pytest.raises(ValueError, match="window_correction"):
        power_spectrum(da, window=None, window_correction=True)


@pytest.mark.parametrize("chunks_to_segments", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_parseval(mode, chunks_to_segments):
    """Parseval's relation for power/cross spectra, windowed and segmented
    (port of the central test at test_xrft.py:693-842)."""
    N = 16
    rng = np.random.RandomState(1)
    da = LabeledArray(rng.rand(N, N), dims=["x", "y"],
                      coords={"x": range(N), "y": range(N)})
    da2 = LabeledArray(rng.rand(N, N), dims=["x", "y"],
                       coords={"x": range(N), "y": range(N)})
    n_segments = 2 if chunks_to_segments else 1
    if chunks_to_segments:
        da = da.chunk({"x": N // 2, "y": N // 2})
        da2 = da2.chunk({"x": N // 2, "y": N // 2})

    dim = ["x", "y"]
    fftdim = ["freq_x", "freq_y"]
    delta_xy = 1.0  # integer coords

    with complex_mode(mode):
        # plain
        ps = power_spectrum(da, chunks_to_segments=chunks_to_segments)
        seg = N // n_segments
        vals = da.values.reshape(n_segments, seg, n_segments, seg) \
            if chunks_to_segments else da.values
        npt.assert_allclose(
            ps.mean(fftdim).values / delta_xy,
            (vals**2).mean(axis=(-3, -1)) if chunks_to_segments
            else (vals**2).mean(),
            atol=1e-10,
        )

        # windowed + detrended
        ps = power_spectrum(da, window="hann", detrend="constant",
                            chunks_to_segments=chunks_to_segments)
        w1 = sps.windows.hann(seg, sym=False)
        window = w1 * w1[:, np.newaxis]
        if chunks_to_segments:
            vprime = vals - vals.mean(axis=(-3, -1), keepdims=True)
            wv = vprime * window[None, :, None, :]
            expected = (wv**2).mean(axis=(-3, -1))
        else:
            vprime = vals - vals.mean()
            expected = ((vprime * window) ** 2).mean()
        npt.assert_allclose(ps.mean(fftdim).values / delta_xy, expected,
                            atol=1e-10)

        # cross spectrum
        cs = cross_spectrum(da, da2, window="hann", detrend="constant",
                            chunks_to_segments=chunks_to_segments)
        vals2 = da2.values.reshape(n_segments, seg, n_segments, seg) \
            if chunks_to_segments else da2.values
        if chunks_to_segments:
            v2prime = vals2 - vals2.mean(axis=(-3, -1), keepdims=True)
            expected = ((vprime * window[None, :, None, :])
                        * (v2prime * window[None, :, None, :])).mean(axis=(-3, -1))
        else:
            v2prime = vals2 - vals2.mean()
            expected = ((vprime * window) * (v2prime * window)).mean()
        npt.assert_allclose(cs.mean(fftdim).values.real / delta_xy, expected,
                            atol=1e-10)


@pytest.mark.parametrize("mode", MODES)
def test_parseval_dft_1d_2d(mode):
    """Amplitude-true Parseval identity with arbitrary spacings/origins
    (port of test_xrft.py:800-842)."""
    rng = np.random.RandomState(2)
    Nx = 40
    dx = rng.rand()
    xcoord = dx * (np.arange(-Nx // 2, -Nx // 2 + Nx) + rng.randint(-Nx // 2, Nx // 2))
    sig = rng.rand(Nx) + 1j * rng.rand(Nx)
    with complex_mode(mode):
        s = LabeledArray(sig, dims=["x"], coords={"x": xcoord})
        FTs = xrft_tpu.fft(s, dim="x", true_phase=True, true_amplitude=True)
        npt.assert_allclose(
            (np.abs(sig) ** 2).sum() * dx,
            (np.abs(FTs.values) ** 2).sum() * FTs["freq_x"].attrs["spacing"],
            rtol=1e-10,
        )

        Ny, dy = 60, rng.rand()
        ycoord = dy * (np.arange(-Ny // 2, -Ny // 2 + Ny)
                       + rng.randint(-Ny // 2, Ny // 2))
        sig2 = rng.rand(Nx, Ny) + 1j * rng.rand(Nx, Ny)
        s2 = LabeledArray(sig2, dims=("x", "y"),
                          coords={"x": xcoord, "y": ycoord})
        FTs2 = xrft_tpu.fft(s2, dim=("x", "y"), true_phase=True,
                            true_amplitude=True)
        npt.assert_allclose(
            (np.abs(sig2) ** 2).sum() * dx * dy,
            (np.abs(FTs2.values) ** 2).sum()
            * FTs2["freq_x"].attrs["spacing"] * FTs2["freq_y"].attrs["spacing"],
            rtol=1e-10,
        )


@pytest.mark.parametrize("mode", MODES)
def test_cross_spectrum_conj_product(mode):
    """cross_spectrum == F(da1) * conj(F(da2)) with matching kwargs."""
    N = 16
    rng = np.random.RandomState(3)
    da1 = LabeledArray(rng.rand(N, N), dims=["x", "y"],
                       coords={"x": range(N), "y": range(N)})
    da2 = LabeledArray(rng.rand(N, N), dims=["x", "y"],
                       coords={"x": range(N), "y": range(N)})
    with complex_mode(mode):
        cs = cross_spectrum(da1, da2, scaling="false_density",
                            true_phase=True)
        f1 = xrft_tpu.fft(da1, true_phase=True, true_amplitude=True)
        f2 = xrft_tpu.fft(da2, true_phase=True, true_amplitude=True)
        npt.assert_allclose(cs.values, f1.values * np.conj(f2.values),
                            atol=1e-12)


def test_cross_spectrum_dim_mismatch_raises():
    N = 8
    da1 = LabeledArray(np.random.rand(N, N), dims=["x", "y"],
                       coords={"x": range(N), "y": range(N)})
    da2 = LabeledArray(np.random.rand(N, N), dims=["x", "z"],
                       coords={"x": range(N), "z": range(N)})
    with pytest.raises(ValueError, match="different dimensions"):
        cross_spectrum(da1, da2, dim=["x"])


@pytest.mark.parametrize("mode", MODES)
def test_cross_phase(mode):
    """Phase of a lagged sinusoid pair (port of test_xrft.py:445-497
    idea)."""
    N = 64
    x = np.linspace(0, 8 * np.pi, N, endpoint=False)
    phase_shift = np.pi / 3
    s1 = np.cos(x)
    s2 = np.cos(x - phase_shift)  # s2 lags s1
    with complex_mode(mode):
        da1 = LabeledArray(s1, dims=["x"], coords={"x": x}, name="a")
        da2 = LabeledArray(s2, dims=["x"], coords={"x": x}, name="b")
        cp = cross_phase(da1, da2, dim="x")
        assert cp.name == "a_b_phase"
        k = cp["freq_x"].values
        # at the signal frequency (1/(2 pi)), phase = +pi/3
        i = int(np.argmin(np.abs(k - 1.0 / (2 * np.pi))))
        npt.assert_allclose(cp.values[i], phase_shift, atol=1e-10)
        assert (np.abs(cp.values) <= np.pi + 1e-12).all()


@pytest.mark.parametrize("mode", MODES)
def test_real_dim_power_doubling(mode):
    """One-sided power spectrum sums to the two-sided total: doubling except
    DC/Nyquist (reference _psd_real_dim_scaling semantics)."""
    for N in (16, 17):
        rng = np.random.RandomState(N)
        da = LabeledArray(rng.rand(N), dims=["x"], coords={"x": range(N)})
        with complex_mode(mode):
            ps1 = power_spectrum(da, dim="x", real_dim="x")
            ps2 = power_spectrum(da, dim="x")
            npt.assert_allclose(ps1.values.sum(), ps2.values.sum(), rtol=1e-10)


def test_segment_spectra_match_per_segment_loop():
    """chunks_to_segments gives the same result as transforming each segment
    separately (dask-parity analogue)."""
    N, seg = 32, 16
    rng = np.random.RandomState(11)
    vals = rng.rand(N)
    da = LabeledArray(vals, dims=["t"], coords={"t": np.arange(N) * 0.5})
    ps_seg = power_spectrum(da.chunk({"t": seg}), dim="t",
                            chunks_to_segments=True)
    assert ps_seg.dims == ("t_segment", "freq_t")
    for i in range(N // seg):
        sub = LabeledArray(vals[i * seg:(i + 1) * seg], dims=["t"],
                           coords={"t": np.arange(seg) * 0.5})
        ps_i = power_spectrum(sub, dim="t")
        npt.assert_allclose(ps_seg.values[i], ps_i.values, atol=1e-12)


@pytest.mark.parametrize("func", ["power_spectrum", "cross_spectrum"])
def test_keep_multidim_coords(func):
    """Multi-dim coordinates not touching transform dims survive spectra
    (port of test_keep_coords)."""
    T, Y, X = 3, 8, 10
    lon = np.linspace(0, 1, Y * X).reshape(Y, X)
    da = LabeledArray(
        np.random.RandomState(0).rand(T, Y, X),
        dims=["time", "y", "x"],
        coords={"time": np.arange(T), "y": np.arange(Y), "x": np.arange(X),
                "lon": (("y", "x"), lon)},
    )
    if func == "power_spectrum":
        ps = power_spectrum(da, dim="time")
    else:
        ps = cross_spectrum(da, da, dim="time", true_phase=False)
    assert "lon" in ps.coords
    npt.assert_array_equal(ps.coords["lon"].values, lon)
    assert "y" in ps.coords and "x" in ps.coords


def test_cross_spectrum_one_sided_fast_path_parity():
    """cross_spectrum of two real inputs takes the Hermitian one-sided
    path (C(-k) = conj(C(k)) survives the true_phase factors); parity vs
    the two-sided path forced via complex-dtype inputs."""
    rng = np.random.RandomState(31)
    N = 24
    x = np.arange(N) * 0.5 + 3.0  # nonzero lag exercises the phases
    for kw in (
        dict(),
        dict(window="hann", scaling="spectrum"),
        dict(window="hann", window_correction=True),
        dict(detrend="linear"),
        dict(true_phase=False, shift=False),
        dict(scaling="false_density"),
    ):
        v1 = rng.randn(N, N)
        v2 = rng.randn(N, N)
        mk = lambda v: LabeledArray(v, dims=["y", "x"],
                                    coords={"y": x, "x": x})
        fast = cross_spectrum(mk(v1), mk(v2), dim=["y", "x"], **kw)
        slow = cross_spectrum(mk(v1.astype(np.complex128)),
                              mk(v2.astype(np.complex128)),
                              dim=["y", "x"], **kw)
        scale = np.abs(slow.values).max()
        npt.assert_allclose(fast.values, slow.values, atol=1e-11 * scale)
        npt.assert_allclose(fast.coords["freq_x"].values,
                            slow.coords["freq_x"].values)

    # decreasing coordinate flips through the fast path too
    v1, v2 = rng.randn(N, N), rng.randn(N, N)
    mkd = lambda v: LabeledArray(v, dims=["y", "x"],
                                 coords={"y": x[::-1].copy(), "x": x})
    fast = cross_spectrum(mkd(v1), mkd(v2), dim=["y", "x"])
    slow = cross_spectrum(mkd(v1.astype(np.complex128)),
                          mkd(v2.astype(np.complex128)), dim=["y", "x"])
    scale = np.abs(slow.values).max()
    npt.assert_allclose(fast.values, slow.values, atol=1e-11 * scale)


def test_segmented_real_dim_nyquist_parity():
    """Deliberate reference divergence (documented in
    _psd_real_dim_scaling): with chunks_to_segments the one-sided
    real-dim doubling parity follows the SEGMENT length — the rfft runs
    per segment, so the last bin is Nyquist iff the segment length is
    even.  The reference takes the parity from the full input length
    (/root/reference/xrft/xrft.py:678), mis-scaling that bin when the
    parities differ.  N=6 segmented into two length-3 (odd) segments:
    the last bin must be DOUBLED (it is not a Nyquist bin)."""
    N, seg = 6, 3
    rng = np.random.RandomState(5)
    x = rng.randn(N)
    da = LabeledArray(x, dims=["t"], coords={"t": np.arange(N) * 1.0}
                      ).chunk({"t": seg})
    ps = power_spectrum(da, dim=["t"], real_dim="t",
                        chunks_to_segments=True, scaling="false_density")
    # per-segment oracle: one-sided |rfft|^2 with odd-length doubling
    segs = x.reshape(2, seg)
    F = np.fft.rfft(segs, axis=-1)
    ref = np.abs(F) ** 2
    ref[:, 1:] *= 2.0  # odd seg length: every non-DC bin doubles
    npt.assert_allclose(np.asarray(ps.values), ref, rtol=1e-6)
    # engine='hp' agrees (same parity rule)
    ps_hp = power_spectrum(da, dim=["t"], real_dim="t",
                           chunks_to_segments=True,
                           scaling="false_density", engine="hp")
    npt.assert_allclose(np.asarray(ps_hp.values), ref, rtol=1e-10)


@pytest.mark.parametrize("mode", MODES)
def test_segmented_psd_fused_engine_parity(mode):
    """chunks_to_segments through the fused matmul engine matches the xla
    engine, including interleaved *_segment batch
    dims and cross spectra."""
    from xrft_tpu.config import fft_engine

    rng = np.random.RandomState(6)
    N = 32
    da = LabeledArray(rng.rand(N, N), dims=["x", "y"],
                      coords={"x": range(N), "y": range(N)}
                      ).chunk({"x": N // 2, "y": N // 2})
    db = LabeledArray(rng.rand(N, N), dims=["x", "y"],
                      coords={"x": range(N), "y": range(N)}
                      ).chunk({"x": N // 2, "y": N // 2})
    with complex_mode(mode):
        with fft_engine("matmul"):
            got = power_spectrum(da, window="hann", detrend="linear",
                                 chunks_to_segments=True)
            gotc = cross_spectrum(da, db, chunks_to_segments=True)
        with fft_engine("xla"):
            ref = power_spectrum(da, window="hann", detrend="linear",
                                 chunks_to_segments=True)
            refc = cross_spectrum(da, db, chunks_to_segments=True)
    assert got.dims == ref.dims == ("x_segment", "freq_x",
                                    "y_segment", "freq_y")
    npt.assert_allclose(np.asarray(got.values), np.asarray(ref.values),
                        atol=1e-6 * np.abs(np.asarray(ref.values)).max())
    from xrft_tpu.ops.carray import to_numpy
    g, r = to_numpy(gotc.data), to_numpy(refc.data)
    npt.assert_allclose(g, r, atol=1e-6 * np.abs(r).max())


# ---------------------------------------------------------------- spectrogram
@pytest.mark.parametrize("detrend", [False, "constant"])
@pytest.mark.parametrize("noverlap", [0, 50])
def test_spectrogram_scipy_parity(noverlap, detrend):
    """spectrogram(...) == scipy.signal.spectrogram (one-sided PSD per
    sliding segment, mode='psd'), including the segment-center time
    coordinate on the <dim>_segment axis (scipy's t vector when the
    coordinate starts at 0).  Beyond the reference, whose segment index
    is a bare integer."""
    fs, nperseg = 400.0, 100
    rng = np.random.RandomState(11)
    tt = np.arange(1200) / fs
    x = np.sin(2 * np.pi * 30 * tt) + 0.3 * rng.randn(tt.size)
    da = LabeledArray(x, dims=["t"], coords={"t": tt}, name="u")

    sg = xrft_tpu.spectrogram(da, dim="t", seglen=nperseg,
                              segment_overlap=noverlap or 0, window="hann",
                              detrend=detrend or None)
    f_ref, t_ref, s_ref = sps.spectrogram(
        x, fs=fs, window="hann", nperseg=nperseg, noverlap=noverlap,
        detrend=detrend, scaling="density", mode="psd")
    assert sg.name == "u_spectrogram"
    assert sg.dims == ("t_segment", "freq_t")
    npt.assert_allclose(sg["freq_t"].values, f_ref)
    npt.assert_allclose(sg["t_segment"].values, t_ref)
    npt.assert_allclose(np.asarray(sg.values).T, s_ref, rtol=1e-5,
                        atol=1e-8 * s_ref.max())


def test_spectrogram_fractional_overlap_and_chunked_input():
    """Fractional segment_overlap and a pre-declared chunk length (no
    seglen=) give the scipy noverlap semantics; the segment-center
    coordinate honors a nonzero coordinate origin."""
    fs, nperseg = 256.0, 64
    rng = np.random.RandomState(3)
    t0 = 5.0
    tt = t0 + np.arange(640) / fs
    x = rng.randn(tt.size)
    da = LabeledArray(x, dims=["t"], coords={"t": tt}).chunk({"t": nperseg})

    sg = xrft_tpu.spectrogram(da, dim="t", segment_overlap=0.5,
                              window="hann", detrend="constant")
    f_ref, t_ref, s_ref = sps.spectrogram(
        x, fs=fs, window="hann", nperseg=nperseg, noverlap=nperseg // 2,
        detrend="constant", scaling="density", mode="psd")
    npt.assert_allclose(sg["freq_t"].values, f_ref)
    npt.assert_allclose(sg["t_segment"].values, t0 + t_ref)
    npt.assert_allclose(np.asarray(sg.values).T, s_ref, rtol=1e-5,
                        atol=1e-8 * s_ref.max())
    # hop spacing recorded for downstream coordinate math
    npt.assert_allclose(sg.coords["t_segment"].attrs["spacing"],
                        (nperseg // 2) / fs)


def test_spectrogram_two_sided_complex_input():
    """Complex input falls back to a two-sided estimate (scipy
    return_onesided=False): fftfreq grid in raw order with shift=False."""
    fs, nperseg = 128.0, 32
    rng = np.random.RandomState(5)
    tt = np.arange(320) / fs
    x = rng.randn(tt.size) + 1j * rng.randn(tt.size)
    da = LabeledArray(x, dims=["t"], coords={"t": tt})

    sg = xrft_tpu.spectrogram(da, dim="t", seglen=nperseg, window="hann",
                              detrend=None, shift=False, segment_overlap=0)
    f_ref, t_ref, s_ref = sps.spectrogram(
        x, fs=fs, window="hann", nperseg=nperseg, noverlap=0,
        detrend=False, return_onesided=False, scaling="density",
        mode="psd")
    assert sg.dims == ("t_segment", "freq_t")
    npt.assert_allclose(sg["freq_t"].values, f_ref)
    npt.assert_allclose(sg["t_segment"].values, t_ref)
    npt.assert_allclose(np.asarray(sg.values).T, s_ref, rtol=1e-5,
                        atol=1e-8 * s_ref.max())


def test_spectrogram_error_contracts():
    da = LabeledArray(np.random.rand(64), dims=["t"],
                      coords={"t": np.arange(64.0)})
    with pytest.raises(ValueError, match="segment length"):
        xrft_tpu.spectrogram(da, dim="t")
    with pytest.raises(ValueError, match="1-D sliding-segment"):
        da2 = LabeledArray(np.random.rand(8, 8), dims=["x", "y"],
                           coords={"x": range(8), "y": range(8)})
        xrft_tpu.spectrogram(da2, dim=["x", "y"], seglen=4)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        xrft_tpu.spectrogram(da, dim="t", seglen=16, segment_overlap=1.0)


def test_spectrogram_default_overlap_is_scipy_default():
    """With segment_overlap unspecified, the default matches scipy's
    noverlap = nperseg // 8 exactly (advisor r3: the old default 0
    silently diverged from the docstring's scipy-parity claim)."""
    fs, nperseg = 300.0, 80
    rng = np.random.RandomState(21)
    tt = np.arange(960) / fs
    x = rng.randn(tt.size)
    da = LabeledArray(x, dims=["t"], coords={"t": tt}, name="u")
    sg = xrft_tpu.spectrogram(da, dim="t", seglen=nperseg, window="hann",
                              detrend="constant")
    f_ref, t_ref, s_ref = sps.spectrogram(
        x, fs=fs, window="hann", nperseg=nperseg, detrend="constant",
        scaling="density", mode="psd")  # scipy default noverlap
    npt.assert_allclose(sg["t_segment"].values, t_ref)
    npt.assert_allclose(np.asarray(sg.values).T, s_ref, rtol=1e-5,
                        atol=1e-8 * s_ref.max())


def test_spectrogram_tail_drop_zero_overlap():
    """segment_overlap=0 with a signal length not divisible by seglen
    drops the trailing partial segment (scipy convention) instead of
    raising the Welch strict-divisibility error (advisor r3)."""
    fs, nperseg = 128.0, 32
    rng = np.random.RandomState(7)
    tt = np.arange(330) / fs  # 330 = 10*32 + 10 leftover
    x = rng.randn(tt.size)
    da = LabeledArray(x, dims=["t"], coords={"t": tt}, name="u")
    with pytest.warns(UserWarning, match="drops the last 10 samples"):
        sg = xrft_tpu.spectrogram(da, dim="t", seglen=nperseg,
                                  segment_overlap=0, window="hann",
                                  detrend="constant")
    f_ref, t_ref, s_ref = sps.spectrogram(
        x, fs=fs, window="hann", nperseg=nperseg, noverlap=0,
        detrend="constant", scaling="density", mode="psd")
    assert sg.sizes["t_segment"] == len(t_ref) == 10
    npt.assert_allclose(sg["t_segment"].values, t_ref)
    npt.assert_allclose(np.asarray(sg.values).T, s_ref, rtol=1e-5,
                        atol=1e-8 * s_ref.max())


def test_spectrogram_decreasing_coordinate_centers():
    """Decreasing coordinates give segment centers that walk DOWNWARD
    from the first stored value, inside the coordinate range, with a
    negative spacing attr; the PSD values are those of the stored
    (reversed) series (advisor r3: |dx| walked the centers out of
    range)."""
    nperseg = 32
    tt = np.arange(127.0, -1.0, -1.0)  # 127 .. 0, dt = -1
    rng = np.random.RandomState(9)
    x = rng.randn(tt.size)
    da = LabeledArray(x, dims=["t"], coords={"t": tt}, name="u")
    sg = xrft_tpu.spectrogram(da, dim="t", seglen=nperseg,
                              segment_overlap=0, window="hann",
                              detrend="constant")
    centers = np.asarray(sg["t_segment"].values)
    npt.assert_allclose(centers, [111.0, 79.0, 47.0, 15.0])
    assert centers.min() >= tt.min() and centers.max() <= tt.max()
    npt.assert_allclose(sg.coords["t_segment"].attrs["spacing"],
                        -float(nperseg))
    f_ref, t_ref, s_ref = sps.spectrogram(
        x, fs=1.0, window="hann", nperseg=nperseg, noverlap=0,
        detrend="constant", scaling="density", mode="psd")
    npt.assert_allclose(np.asarray(sg.values).T, s_ref, rtol=1e-5,
                        atol=1e-8 * s_ref.max())


def test_spectrogram_integer_input_is_one_sided():
    """Integer-dtype input counts as real (scipy semantics): one-sided
    freq axis of size seglen//2+1, matching scipy on the float-cast
    series (advisor r3: int input silently fell back to two-sided)."""
    nperseg = 16
    rng = np.random.RandomState(17)
    x = rng.randint(-50, 50, size=160).astype(np.int32)
    da = LabeledArray(x, dims=["t"],
                      coords={"t": np.arange(160.0)}, name="u")
    sg = xrft_tpu.spectrogram(da, dim="t", seglen=nperseg,
                              segment_overlap=0, window="hann",
                              detrend="constant")
    assert sg.sizes["freq_t"] == nperseg // 2 + 1
    f_ref, t_ref, s_ref = sps.spectrogram(
        x.astype(np.float64), fs=1.0, window="hann", nperseg=nperseg,
        noverlap=0, detrend="constant", scaling="density", mode="psd")
    npt.assert_allclose(np.asarray(sg.values).T, s_ref, rtol=1e-5,
                        atol=1e-8 * s_ref.max())


# ----------------------------------------------------------- welch / csd
@pytest.mark.parametrize("noverlap_kw", [None, 0, 0.25])
def test_welch_scipy_parity(noverlap_kw):
    """welch(...) == scipy.signal.welch with matching defaults (None ->
    scipy's nperseg//2; samples; fraction), incl. tail drop at 0."""
    fs, nperseg = 500.0, 128
    rng = np.random.RandomState(31)
    n = 1300  # not a multiple of nperseg
    tt = np.arange(n) / fs
    x = np.sin(2 * np.pi * 60 * tt) + 0.4 * rng.randn(n)
    da = LabeledArray(x.astype(np.float32), dims=["t"], coords={"t": tt},
                      name="u")
    nov = {None: nperseg // 2, 0: 0, 0.25: nperseg // 4}[noverlap_kw]
    kw = {} if noverlap_kw is None else {"segment_overlap": noverlap_kw}
    import warnings as _w
    with _w.catch_warnings():
        _w.simplefilter("ignore")
        got = xrft_tpu.welch(da, dim="t", seglen=nperseg, **kw)
    f_ref, p_ref = sps.welch(x, fs=fs, window="hann", nperseg=nperseg,
                             noverlap=nov, detrend="constant",
                             scaling="density")
    assert got.name == "u_welch"
    assert got.dims == ("freq_t",)
    npt.assert_allclose(got["freq_t"].values, f_ref)
    npt.assert_allclose(np.asarray(got.values), p_ref, rtol=1e-5,
                        atol=1e-8 * p_ref.max())


def test_welch_hp_engine_compensated_mean():
    """welch(engine='hp') returns DF64 data with the segment averaging
    done in compensated df64 (not per-plane f32 sums): <=1e-10 vs the
    float64 host oracle."""
    from xrft_tpu.ops.carray import DF64

    fs, nperseg = 100.0, 32
    rng = np.random.RandomState(33)
    n = 8 * nperseg
    x = rng.randn(n).astype(np.float32)
    da = LabeledArray(x, dims=["t"], coords={"t": np.arange(n) / fs},
                      name="u")
    got = xrft_tpu.welch(da, dim="t", seglen=nperseg, segment_overlap=0,
                         engine="hp")
    assert isinstance(got.data, DF64)
    f_ref, p_ref = sps.welch(x.astype(np.float64), fs=fs, window="hann",
                             nperseg=nperseg, noverlap=0,
                             detrend="constant", scaling="density")
    rel = np.abs(np.asarray(got.values) - p_ref).max() / p_ref.max()
    assert rel < 1e-10


def test_welch_complex_two_sided_and_batch():
    """Complex input -> two-sided; batch dims ride along."""
    fs, nperseg = 64.0, 16
    rng = np.random.RandomState(35)
    x = (rng.randn(3, 160) + 1j * rng.randn(3, 160))
    da = LabeledArray(x, dims=["z", "t"],
                      coords={"z": range(3), "t": np.arange(160) / fs})
    got = xrft_tpu.welch(da, dim="t", seglen=nperseg, shift=False)
    f_ref, p_ref = sps.welch(x, fs=fs, window="hann", nperseg=nperseg,
                             noverlap=nperseg // 2, detrend="constant",
                             scaling="density", return_onesided=False)
    assert got.dims == ("z", "freq_t")
    npt.assert_allclose(got["freq_t"].values, f_ref)
    npt.assert_allclose(np.asarray(got.values), p_ref, rtol=1e-5,
                        atol=1e-8 * np.abs(p_ref).max())


def test_csd_scipy_parity():
    """csd(...) == scipy.signal.csd (complex cross PSD, 50% overlap
    default, one-sided for real inputs)."""
    fs, nperseg = 250.0, 64
    rng = np.random.RandomState(37)
    n = 640
    tt = np.arange(n) / fs
    x = np.sin(2 * np.pi * 40 * tt) + 0.3 * rng.randn(n)
    y = np.sin(2 * np.pi * 40 * tt + np.pi / 4) + 0.3 * rng.randn(n)
    da1 = LabeledArray(x.astype(np.float32), dims=["t"],
                       coords={"t": tt}, name="u")
    da2 = LabeledArray(y.astype(np.float32), dims=["t"],
                       coords={"t": tt}, name="v")
    got = xrft_tpu.csd(da1, da2, dim="t", seglen=nperseg)
    f_ref, p_ref = sps.csd(x, y, fs=fs, window="hann", nperseg=nperseg,
                           noverlap=nperseg // 2, detrend="constant",
                           scaling="density")
    assert got.name == "u_v_csd"
    npt.assert_allclose(got["freq_t"].values, f_ref)
    npt.assert_allclose(np.asarray(got.values), p_ref, rtol=1e-4,
                        atol=1e-7 * np.abs(p_ref).max())
    # csd(x, x) == welch(x)
    auto = xrft_tpu.csd(da1, da1, dim="t", seglen=nperseg)
    w = xrft_tpu.welch(da1, dim="t", seglen=nperseg)
    npt.assert_allclose(np.asarray(auto.values).real,
                        np.asarray(w.values), rtol=1e-5)
    assert np.abs(np.asarray(auto.values).imag).max() < 1e-8


def test_spectrogram_datetime64_centers():
    """datetime64 coordinates get datetime64 segment centers (code review
    r4: x0 was raw ns ticks mixed with dx in seconds)."""
    n, seg = 128, 32
    t0 = np.datetime64("2020-01-01T00:00:00", "ns")
    tt = t0 + (np.arange(n) * 1_000_000_000).astype("timedelta64[ns]")
    rng = np.random.RandomState(41)
    da = LabeledArray(rng.randn(n).astype(np.float32), dims=["t"],
                      coords={"t": tt}, name="u")
    sg = xrft_tpu.spectrogram(da, dim="t", seglen=seg, segment_overlap=0)
    centers = np.asarray(sg["t_segment"].values)
    assert np.issubdtype(centers.dtype, np.datetime64)
    want = t0 + (((np.arange(4) * seg + seg / 2) * 1e9)
                 .astype("timedelta64[ns]"))
    npt.assert_array_equal(centers, want)
    assert centers.min() >= tt.min() and centers.max() <= tt.max()


def test_stft_seglen_clamps_like_scipy():
    """seglen > input length clamps with a warning instead of raising
    (scipy's nperseg triage)."""
    n = 100
    rng = np.random.RandomState(43)
    x = rng.randn(n)
    da = LabeledArray(x.astype(np.float32), dims=["t"],
                      coords={"t": np.arange(float(n))}, name="u")
    with pytest.warns(UserWarning, match="greater than input length"):
        got = xrft_tpu.welch(da, dim="t", seglen=256)
    f_ref, p_ref = sps.welch(x, fs=1.0, window="hann", nperseg=256,
                             detrend="constant")
    npt.assert_allclose(got["freq_t"].values, f_ref)
    npt.assert_allclose(np.asarray(got.values), p_ref, rtol=1e-5,
                        atol=1e-8 * p_ref.max())


def test_csd_zero_pads_shorter_input():
    """Different-length csd inputs: the shorter is zero-padded to the
    longer, like scipy (code review r4: previously a segment-count
    conflict crash)."""
    fs, nperseg = 128.0, 64
    rng = np.random.RandomState(47)
    x = rng.randn(512)
    y = rng.randn(320)
    da1 = LabeledArray(x.astype(np.float32), dims=["t"],
                       coords={"t": np.arange(512) / fs}, name="u")
    da2 = LabeledArray(y.astype(np.float32), dims=["t"],
                       coords={"t": np.arange(320) / fs}, name="v")
    got = xrft_tpu.csd(da1, da2, dim="t", seglen=nperseg)
    f_ref, p_ref = sps.csd(x, y, fs=fs, window="hann", nperseg=nperseg,
                           noverlap=nperseg // 2, detrend="constant")
    npt.assert_allclose(got["freq_t"].values, f_ref)
    npt.assert_allclose(np.asarray(got.values), p_ref, rtol=1e-4,
                        atol=1e-7 * np.abs(p_ref).max())
    # and the longer-second-input orientation
    got2 = xrft_tpu.csd(da2, da1, dim="t", seglen=nperseg)
    f2, p2 = sps.csd(y, x, fs=fs, window="hann", nperseg=nperseg,
                     noverlap=nperseg // 2, detrend="constant")
    npt.assert_allclose(np.asarray(got2.values), p2, rtol=1e-4,
                        atol=1e-7 * np.abs(p2).max())


def test_hp_impl_native_guard():
    """Forcing hp_impl='native' without usable f64 raises instead of
    silently truncating (code review r4)."""
    import jax

    from xrft_tpu.config import hp_impl
    from xrft_tpu.highprec import _hp_native

    with hp_impl("native"):
        assert _hp_native()  # cpu + x64 in the test env: fine
        jax.config.update("jax_enable_x64", False)
        try:
            with pytest.raises(ValueError, match="jax_enable_x64"):
                _hp_native()
        finally:
            jax.config.update("jax_enable_x64", True)


def test_csd_dim_mismatch_error():
    da1 = LabeledArray(np.random.rand(32), dims=["t"],
                       coords={"t": np.arange(32.0)})
    da2 = LabeledArray(np.random.rand(32), dims=["s"],
                       coords={"s": np.arange(32.0)})
    with pytest.raises(ValueError, match="same dimensions"):
        xrft_tpu.csd(da1, da2, dim="t", seglen=8)


def test_spectrogram_batch_dim_and_welch_consistency():
    """Extra batch dims pass through; averaging the spectrogram over
    segments reproduces the Welch estimate."""
    fs, nperseg = 200.0, 50
    rng = np.random.RandomState(13)
    tt = np.arange(500) / fs
    x = rng.randn(3, tt.size)
    da = LabeledArray(x, dims=["z", "t"],
                      coords={"z": range(3), "t": tt})
    sg = xrft_tpu.spectrogram(da, dim="t", seglen=nperseg, window="hann",
                              segment_overlap=0)
    assert sg.dims == ("z", "t_segment", "freq_t")
    welch = power_spectrum(
        da.chunk({"t": nperseg}), dim="t", real_dim="t", window="hann",
        chunks_to_segments=True, window_correction=True,
        detrend="constant").mean("t_segment")
    npt.assert_allclose(np.asarray(sg.mean("t_segment").values),
                        np.asarray(welch.values), rtol=1e-6)


def test_periodogram_scipy_parity_default():
    """periodogram() == scipy.signal.periodogram with scipy defaults
    (boxcar window, constant detrend, density scaling, one-sided)."""
    fs, n = 320.0, 256
    rng = np.random.RandomState(41)
    tt = np.arange(n) / fs
    x = np.sin(2 * np.pi * 50 * tt) + 0.3 * rng.randn(n)
    da = LabeledArray(x, dims=["t"], coords={"t": tt}, name="u")
    got = xrft_tpu.periodogram(da)
    f_ref, p_ref = sps.periodogram(x, fs=fs)
    assert got.name == "u_periodogram"
    assert got.dims == ("freq_t",)
    npt.assert_allclose(got["freq_t"].values, f_ref)
    npt.assert_allclose(np.asarray(got.values), p_ref, rtol=1e-9,
                        atol=1e-12 * p_ref.max())


@pytest.mark.parametrize("scaling", ["density", "spectrum"])
def test_periodogram_window_and_scaling(scaling):
    """Windowed periodogram matches scipy in both scaling conventions."""
    fs, n = 100.0, 200
    rng = np.random.RandomState(43)
    x = rng.randn(n)
    da = LabeledArray(x, dims=["t"], coords={"t": np.arange(n) / fs})
    got = xrft_tpu.periodogram(da, window="hann", scaling=scaling)
    f_ref, p_ref = sps.periodogram(x, fs=fs, window="hann",
                                   scaling=scaling)
    npt.assert_allclose(got["freq_t"].values, f_ref)
    npt.assert_allclose(np.asarray(got.values), p_ref, rtol=1e-9,
                        atol=1e-12 * p_ref.max())


def test_periodogram_detrend_false_and_linear():
    """detrend=False/'linear' map to scipy's detrend= conventions."""
    fs, n = 64.0, 128
    rng = np.random.RandomState(47)
    x = rng.randn(n) + 0.05 * np.arange(n)
    da = LabeledArray(x, dims=["t"], coords={"t": np.arange(n) / fs})
    for detrend in (False, "linear"):
        got = xrft_tpu.periodogram(da, detrend=detrend)
        f_ref, p_ref = sps.periodogram(x, fs=fs, detrend=detrend)
        npt.assert_allclose(np.asarray(got.values), p_ref, rtol=1e-9,
                            atol=1e-12 * p_ref.max())


def test_periodogram_complex_two_sided_and_integer_one_sided():
    """Complex input -> two-sided (scipy return_onesided=False order via
    shift=False); integer input counts as real -> one-sided."""
    fs, n = 32.0, 64
    rng = np.random.RandomState(53)
    z = rng.randn(n) + 1j * rng.randn(n)
    da = LabeledArray(z, dims=["t"], coords={"t": np.arange(n) / fs})
    got = xrft_tpu.periodogram(da, shift=False)
    f_ref, p_ref = sps.periodogram(z, fs=fs, return_onesided=False)
    npt.assert_allclose(got["freq_t"].values, f_ref)
    npt.assert_allclose(np.asarray(got.values), p_ref, rtol=1e-9,
                        atol=1e-12 * p_ref.max())

    di = LabeledArray((10 * rng.randn(n)).astype(np.int32), dims=["t"],
                      coords={"t": np.arange(n) / fs})
    one_sided = xrft_tpu.periodogram(di)
    assert one_sided.sizes["freq_t"] == n // 2 + 1


def test_periodogram_batch_dim_rides_along():
    """Non-transform dims pass through untouched (dask-chunk parity)."""
    fs, n = 50.0, 40
    rng = np.random.RandomState(59)
    x = rng.randn(3, n)
    da = LabeledArray(x, dims=["z", "t"],
                      coords={"z": range(3), "t": np.arange(n) / fs})
    got = xrft_tpu.periodogram(da, dim="t")
    assert got.dims == ("z", "freq_t")
    f_ref, p_ref = sps.periodogram(x, fs=fs, axis=-1)
    npt.assert_allclose(np.asarray(got.values), p_ref, rtol=1e-9,
                        atol=1e-12 * p_ref.max())
