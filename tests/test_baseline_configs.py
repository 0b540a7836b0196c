"""The five BASELINE.json acceptance configurations at test scale.

Full-scale equivalents run on hardware via bench.py / scripts/chip_checks.py;
here each configuration's *semantics* are pinned against numpy oracles on
the CPU backend (both complex representations where relevant).
"""

import jax
import numpy as np
import numpy.testing as npt
import pytest
import scipy.signal as sps

import xrft_tpu
from xrft_tpu import LabeledArray
from xrft_tpu.config import complex_mode


def test_config1_1d_roundtrip_and_ps():
    """1-D fft/ifft round-trip + power_spectrum, 1024-pt signal
    (detrend='constant', numpy parity)."""
    N = 1024
    rng = np.random.RandomState(0)
    t = np.arange(N) * 1e-3
    sig = rng.randn(N)
    da = LabeledArray(sig, dims=["t"], coords={"t": t})

    F = xrft_tpu.fft(da, detrend="constant", true_phase=True,
                     true_amplitude=True)
    back = xrft_tpu.ifft(F, true_phase=True, true_amplitude=True,
                         lag=t[N // 2])
    npt.assert_allclose(back.values.real, sig - sig.mean(), atol=1e-10)

    ps = xrft_tpu.power_spectrum(da, dim="t", detrend="constant")
    prime = sig - sig.mean()
    ref = np.abs(np.fft.fftshift(np.fft.fft(prime)) * 1e-3) ** 2 / (N * 1e-3)
    npt.assert_allclose(ps.values, ref, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("mode", ["native", "split"])
def test_config2_2d_ps_linear_detrend_hann(mode):
    """2-D power_spectrum with linear detrend + Hann window (SSH-field
    style; 256^2 at test scale)."""
    N = 256
    rng = np.random.RandomState(1)
    ssh = (rng.randn(N, N) + 0.01 * np.arange(N)[:, None]
           + 0.02 * np.arange(N)[None, :]).astype(np.float64)
    dx = 20e3
    da = LabeledArray(ssh, dims=["YC", "XC"],
                      coords={"YC": np.arange(N) * dx,
                              "XC": np.arange(N) * dx})
    with complex_mode(mode):
        ps = xrft_tpu.power_spectrum(da, dim=["YC", "XC"], detrend="linear",
                                     window="hann")
    from xrft_tpu.detrend import detrend as dt
    vp = dt(da, ["YC", "XC"], "linear").values
    w = sps.windows.hann(N, sym=False)
    F = np.fft.fftshift(np.fft.fftn(vp * (w * w[:, None]))) * dx * dx
    ref = np.abs(F) ** 2 * (1.0 / (N * dx)) ** 2
    npt.assert_allclose(ps.values, ref, rtol=1e-7, atol=ref.max() * 1e-12)


def test_config3_isotropic_ps_parseval():
    """isotropic_power_spectrum azimuthal binning (256^2 at test scale):
    conservation of the spectral total."""
    N = 256
    rng = np.random.RandomState(2)
    da = LabeledArray(rng.randn(N, N), dims=["y", "x"],
                      coords={"y": np.arange(N), "x": np.arange(N)})
    ps = xrft_tpu.power_spectrum(da, dim=["y", "x"])
    iso = xrft_tpu.isotropize(ps, ["freq_y", "freq_x"], truncate=True)
    npt.assert_allclose(iso.values.sum(), ps.values.sum(),
                        rtol=1e-10)


@pytest.mark.parametrize("mode", ["native", "split"])
def test_config4_cross_spectrum_rfft_time(mode):
    """cross_spectrum + cross_phase on paired (time, y, x) fields with
    rfft over time (64x64x64 at test scale)."""
    T, N = 64, 64
    rng = np.random.RandomState(3)
    u = rng.randn(T, N, N)
    v = np.roll(u, 3, axis=0) + 0.1 * rng.randn(T, N, N)  # time-lagged pair
    dt = 3600.0
    coords = {"time": np.arange(T) * dt, "y": np.arange(N) * 1.0,
              "x": np.arange(N) * 1.0}
    da1 = LabeledArray(u, dims=["time", "y", "x"], coords=coords, name="u")
    da2 = LabeledArray(v, dims=["time", "y", "x"], coords=coords, name="v")

    with complex_mode(mode):
        cs = xrft_tpu.cross_spectrum(da1, da2, dim=["time"],
                                     real_dim="time", true_phase=False)
        cp = xrft_tpu.cross_phase(da1, da2, dim=["time"], real_dim="time",
                                  true_phase=False)
    assert cs.dims == ("freq_time", "y", "x")
    assert cp.name == "u_v_phase"
    npt.assert_allclose(cs.coords["freq_time"].values,
                        np.fft.rfftfreq(T, dt))

    # oracle: one-sided cross spectrum with doubling + density scaling
    F1 = np.fft.rfft(u, axis=0) * dt
    F2 = np.fft.rfft(v, axis=0) * dt
    cs_ref = F1 * np.conj(F2)
    dbl = np.full(T // 2 + 1, 2.0)
    dbl[0] = dbl[-1] = 1.0
    cs_ref *= dbl[:, None, None]
    cs_ref *= 1.0 / (T * dt)
    npt.assert_allclose(cs.values, cs_ref, rtol=1e-8,
                        atol=np.abs(cs_ref).max() * 1e-10)
    npt.assert_allclose(cp.values, np.angle(cs_ref), atol=1e-7)


def test_config5_sharded_3d_fft_parity():
    """Sharded 3-D fft via all_to_all pencil transposes (dask-chunk
    parity at 8-virtual-device scale; chip_smoke.py --cards 4 runs 1024^3
    on four GPUs)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from xrft_tpu.ops import carray
    from xrft_tpu.parallel import make_mesh, pencil_fftn

    mesh = make_mesh({"p1": 2, "p2": 4})
    rng = np.random.RandomState(4)
    x = rng.randn(32, 32, 32) + 1j * rng.randn(32, 32, 32)
    got = pencil_fftn(np.asarray(x), [0, 1, 2], mesh,
                      {0: "p1", 1: "p2"}, "fft")
    ref = np.fft.fftn(x)
    npt.assert_allclose(carray.to_numpy(got), ref,
                        atol=np.abs(ref).max() * 1e-12)
