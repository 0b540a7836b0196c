"""Isotropic-spectrum tests: conservation, slope recovery, per-slice loop
parity (port of /root/reference/xrft/tests/test_xrft.py:940-1110), exercised
in both native-complex and split representations.
"""

import numpy as np
import numpy.testing as npt
import pytest

import xrft_tpu
from xrft_tpu import (
    LabeledArray,
    fit_loglog,
    isotropic_cross_spectrum,
    isotropic_power_spectrum,
    isotropize,
    power_spectrum,
)
from xrft_tpu.config import complex_mode


def synthetic_field(N, dL, amp, s, seed=0):
    """Real 2-D field with isotropic spectral slope s: random-phase
    Hermitian spectrum with prescribed radial amplitude (equivalent to the
    reference's synthetic_field at test_xrft.py:845-913, built by scaling
    the FFT of white noise — Hermitian symmetry by construction)."""
    rng = np.random.RandomState(seed)
    k = np.fft.fftfreq(N, dL)
    kk, ll = np.meshgrid(k, k)
    K = np.sqrt(kk**2 + ll**2)
    with np.errstate(divide="ignore"):
        r_kl = np.sqrt(amp * 0.5 * np.pi**-1 * K ** (s - 1.0))
    r_kl[~np.isfinite(r_kl)] = 0.0
    F = np.fft.fft2(rng.randn(N, N))
    mag = np.abs(F)
    mag[mag == 0] = 1.0
    F_scaled = F / mag * r_kl
    theta = np.real(np.fft.ifft2(F_scaled))
    return theta


def field_da(N=512, dL=1.0, amp=1e1, s=-3.0, extra=None, seed=0):
    theta = synthetic_field(N, dL, amp, s, seed)
    if extra:
        theta = np.broadcast_to(theta, (extra, N, N)).copy()
        return LabeledArray(theta, dims=["d0", "y", "x"],
                            coords={"y": range(N), "x": range(N)})
    return LabeledArray(theta, dims=["y", "x"],
                        coords={"y": range(N), "x": range(N)})


@pytest.mark.parametrize("mode", ["native", "split"])
@pytest.mark.parametrize("truncate", [False, True])
def test_isotropize_conserves_total(mode, truncate, N=512):
    """Port of test_isotropize (test_xrft.py:942-990): azimuthal sum
    conserves the spectral total (truncation drops only negligible
    beyond-Nyquist corner power)."""
    da = field_da(N)
    with complex_mode(mode):
        ps = power_spectrum(da, dim=["x", "y"])
        if truncate:
            ps_iso = isotropize(ps, ["freq_x", "freq_y"], nfactor=4,
                                truncate=True)
            # beyond-Nyquist bins get NaN radial labels (reference: only the
            # coordinate is masked; no data rows are dropped)
            assert np.isnan(ps_iso.coords["freq_r"].values).any()
        else:
            with pytest.warns(FutureWarning):
                ps_iso = isotropize(ps, ["freq_x", "freq_y"], nfactor=4,
                                    truncate=False)
        assert ps_iso.dims == ("freq_r",)
        npt.assert_allclose(ps_iso.values.sum(), ps.values.sum(), atol=1e-3)


@pytest.mark.parametrize("mode", ["native", "split"])
def test_isotropize_extra_dim(mode, N=256):
    da = field_da(N, extra=4)
    with complex_mode(mode):
        ps = power_spectrum(da, dim=["x", "y"])
        ps_iso = isotropize(ps, ["freq_x", "freq_y"], truncate=True)
        assert ps_iso.dims == ("d0", "freq_r")
        npt.assert_allclose(ps_iso.values.sum(), ps.values.sum(), atol=1e-3)


def test_isotropic_ps_slope(N=512, dL=1.0, amp=1e1, s=-3.0):
    """Slope recovery within atol=0.06 (port of test_xrft.py:996-1031)."""
    da = field_da(N, dL, amp, s, extra=4)
    iso_ps = isotropic_power_spectrum(
        da, dim=["y", "x"], detrend="constant", scaling="density"
    ).mean("d0")
    assert np.isfinite(iso_ps.values).all()
    y_fit, a, b = fit_loglog(iso_ps.coords["freq_r"].values[:-35],
                             iso_ps.values[:-35])
    npt.assert_allclose(a, s, atol=0.06)


def test_isotropic_ps_matches_per_slice_loop(N=128):
    """Batched isotropic spectrum == python loop over slices
    (port of test_xrft.py:1018-1023)."""
    rng = np.random.RandomState(5)
    vals = rng.randn(3, N, N)
    da = LabeledArray(vals, dims=["d0", "y", "x"],
                      coords={"y": range(N), "x": range(N)})
    iso = isotropic_power_spectrum(da, dim=["y", "x"], detrend="constant",
                                   scaling="density")
    for i in range(3):
        sub = LabeledArray(vals[i], dims=["y", "x"],
                           coords={"y": range(N), "x": range(N)})
        iso_i = isotropic_power_spectrum(sub, detrend="constant",
                                         scaling="density")
        npt.assert_allclose(iso.values[i], iso_i.values, rtol=1e-8)


def test_isotropic_ps_extra_coords():
    """Data with extra (non-transform) coords keeps them
    (port of test_xrft.py:1038-1076)."""
    N = 16
    da = LabeledArray(
        np.random.rand(2, 5, N, 2 * N),
        dims=["time", "z", "y", "x"],
        coords={
            "time": np.array(["2019-04-18", "2019-04-19"], dtype="datetime64[ns]"),
            "z": np.arange(5),
            "y": np.arange(N),
            "x": np.arange(2 * N),
        },
    )
    iso = isotropic_power_spectrum(da, dim=["y", "x"])
    assert iso.dims == ("time", "z", "freq_r")
    assert "time" in iso.coords and "z" in iso.coords


def test_isotropic_ps_requires_2d():
    da = LabeledArray(np.random.rand(8), dims=["x"], coords={"x": range(8)})
    with pytest.raises(ValueError, match="two dimensional"):
        isotropic_power_spectrum(da, dim=["x"])


@pytest.mark.parametrize("mode", ["native", "split"])
def test_isotropic_cross_spectrum(mode, N=128):
    """Cross-iso: complex output, conservation, self-cross == power iso
    (port of test_xrft.py:1043-1110 ideas)."""
    da1 = field_da(N, seed=1)
    da2 = field_da(N, seed=2)
    with complex_mode(mode):
        iso_cs = isotropic_cross_spectrum(da1, da2, dim=["y", "x"],
                                          truncate=True)
        assert iso_cs.dims == ("freq_r",)
        assert np.iscomplexobj(iso_cs.values)
        # self cross spectrum equals power spectrum after isotropization
        iso_self = isotropic_cross_spectrum(da1, da1, dim=["y", "x"],
                                            truncate=True)
        iso_ps = isotropic_power_spectrum(da1, dim=["y", "x"], truncate=True)
        npt.assert_allclose(iso_self.values.real, iso_ps.values, rtol=1e-8,
                            atol=1e-12)
    da3 = LabeledArray(np.random.rand(N, N), dims=["y", "z"],
                       coords={"y": range(N), "z": range(N)})
    with pytest.raises(ValueError, match="different dimensions"):
        isotropic_cross_spectrum(da1, da3)


def test_fit_loglog_exact():
    x = np.array([1.0, 2.0, 4.0, 8.0])
    y = 3.0 * x**-2.0
    y_fit, a, b = fit_loglog(x, y)
    npt.assert_allclose(a, -2.0, atol=1e-12)
    npt.assert_allclose(y_fit, y, rtol=1e-12)


def test_binned_sum_large_grid_path():
    """A large grid, summed as many scatter-add groups, matches the
    one-group sum of the same points (the group size is monkeypatched
    down so a 96^2 grid spans 72 groups); ComplexPairs too."""
    import jax.numpy as jnp

    from xrft_tpu.ops import binning, carray

    rng = np.random.RandomState(0)
    k = np.fft.fftshift(np.fft.fftfreq(96, 1.0))
    freq_r = np.sqrt(k[:, None] ** 2 + k[None, :] ** 2)
    codes, nbins = binning.cut_codes(freq_r, 24)
    vals = rng.randn(3, 96 * 96).astype(np.float32)
    pair = carray.ComplexPair(jnp.asarray(vals), jnp.asarray(vals[::-1]))

    old = binning.GROUP
    binning.GROUP = codes.size  # one group
    try:
        ref = binning.binned_sum(jnp.asarray(vals), codes, nbins)
        rp = binning.binned_sum(pair, codes, nbins)
        binning.GROUP = 128  # 72 groups
        got = binning.binned_sum(jnp.asarray(vals), codes, nbins)
        gp = binning.binned_sum(pair, codes, nbins)
    finally:
        binning.GROUP = old
    npt.assert_allclose(np.asarray(got), np.asarray(ref), rtol=2e-6,
                        atol=1e-4)
    npt.assert_allclose(carray.to_numpy(gp), carray.to_numpy(rp), rtol=2e-6,
                        atol=1e-4)


# ---------------------------------------------------------------------------
# 3-D shell averaging (beyond the reference, which is 2-D only)
# ---------------------------------------------------------------------------

def test_isotropize_3d_conservation_and_loop_parity():
    """3-D isotropize: spherical-shell sums conserve the total and match
    a numpy bincount loop over the same static bin codes."""
    from xrft_tpu.ops.binning import cut_codes

    N = 24
    rng = np.random.RandomState(4)
    da = LabeledArray(
        rng.randn(2, N, N, N),
        dims=["b", "z", "y", "x"],
        coords={"b": np.arange(2), "z": np.arange(N) * 1.0,
                "y": np.arange(N) * 1.0, "x": np.arange(N) * 1.0},
    )
    with pytest.warns(FutureWarning, match="Nyquist"):
        iso = isotropic_power_spectrum(da, dim=["z", "y", "x"],
                                       truncate=False)
    assert iso.dims == ("b", "freq_r")

    ps = power_spectrum(da, dim=["z", "y", "x"])
    npt.assert_allclose(
        np.asarray(iso.values).sum(axis=-1),
        np.asarray(ps.values).sum(axis=(-3, -2, -1)),
        rtol=1e-6,
    )

    # loop parity: flatten the reversed-fftdim grid exactly as the library
    kz = ps.coords["freq_z"].values
    ky = ps.coords["freq_y"].values
    kx = ps.coords["freq_x"].values
    gx, gy, gz = np.meshgrid(kx, ky, kz, indexing="ij")
    freq_r = np.sqrt(gx**2 + gy**2 + gz**2)
    nbins = int(N / 4)
    codes, nbins_eff = cut_codes(freq_r, nbins)
    v = np.asarray(ps.values).transpose(0, 3, 2, 1).reshape(2, -1)
    cflat = codes.reshape(-1)
    ref = np.stack([
        np.bincount(cflat[cflat >= 0], weights=row[cflat >= 0],
                    minlength=nbins_eff)
        for row in v
    ])
    npt.assert_allclose(np.asarray(iso.values), ref, rtol=1e-6)

    # shell radius grows monotonically where defined
    kr = iso["freq_r"].values
    finite = kr[np.isfinite(kr)]
    assert (np.diff(finite) > 0).all()


def test_isotropize_3d_truncate_marks_beyond_nyquist():
    N = 16
    rng = np.random.RandomState(6)
    da = LabeledArray(
        rng.randn(N, N, N), dims=["z", "y", "x"],
        coords={"z": np.arange(N) * 2.0, "y": np.arange(N) * 1.0,
                "x": np.arange(N) * 1.0},
    )
    iso = isotropic_power_spectrum(da, dim=["z", "y", "x"], truncate=True)
    kr = iso["freq_r"].values
    # the coarse z axis has the smallest Nyquist: radii beyond it are NaN
    kmax = 0.5 / 2.0
    assert np.isnan(kr[-1])
    assert np.nanmax(kr) <= kmax + 1e-12
