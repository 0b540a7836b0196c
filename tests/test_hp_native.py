"""Native-f64 engine='hp' pipelines (config.hp_impl='auto' on CPU/GPU).

The 1e-10 precision contract must be PORTABLE —
the reference's accuracy pins (/root/reference/xrft/tests/test_xrft.py:
693-842) hold on every backend the reference supports, so ours must too.
On backends with real float64 the jit hp pipelines promote the quad
planes to f64 and route the transform through the native complex128 XLA
FFT (highprec._hp_fft_nd); the emulated path (pinned by
tests/test_hp_pipeline.py under hp_impl('emulate')) is the x64-off route.

These tests run under the default config on the CPU test backend (x64 on
in conftest), i.e. they assert the contract a CPU/GPU user gets out of
the box — at <=1e-12, far inside the 1e-10 bound.
"""

import numpy as np
import numpy.testing as npt
import scipy.signal as sps

import jax
import jax.numpy as jnp

import xrft_tpu
from xrft_tpu import LabeledArray
from xrft_tpu.config import config, hp_impl
from xrft_tpu.ops.carray import CDF64, DF64

TOL = 1e-12


def _da(N=64, seed=0, dx=0.5):
    rng = np.random.RandomState(seed)
    return LabeledArray(
        rng.randn(N, N).astype(np.float32), dims=("y", "x"),
        coords={"y": np.arange(N) * dx, "x": np.arange(N) * dx})


def test_native_mode_is_default_on_cpu():
    from xrft_tpu.highprec import _hp_native

    assert config.hp_impl == "auto"
    assert jax.default_backend() == "cpu"
    assert _hp_native()
    with hp_impl("emulate"):
        assert not _hp_native()


def test_psd_hp_native_full_pipeline_1e12():
    """The done-criterion: full hp PSD pipeline (linear detrend +
    hann window + density scaling), jit-compiled, <=1e-12 vs the float64
    numpy oracle OFF-chip."""
    N, dx = 64, 0.5
    da = _da(N)

    ps = jax.jit(lambda d: xrft_tpu.power_spectrum(
        d, dim=["y", "x"], window="hann", detrend="linear",
        engine="hp"))(da)
    assert isinstance(ps.data, DF64)

    v = np.asarray(da.values, np.float64)
    i = np.arange(N) - (N - 1) / 2
    vm = v - v.mean()
    a1 = (vm * i[:, None]).sum() / ((i**2).sum() * N)
    a2 = (vm * i[None, :]).sum() / ((i**2).sum() * N)
    vd = vm - a1 * i[:, None] - a2 * i[None, :]
    w = sps.windows.hann(N, sym=False)
    F = np.fft.fftshift(np.fft.fftn(vd * (w[:, None] * w[None, :]))) * dx**2
    ref = np.abs(F) ** 2 * (1.0 / (N * dx)) ** 2
    assert np.abs(np.asarray(ps.values) - ref).max() / ref.max() < TOL

    # and it genuinely beats what the emulated path achieves on XLA:CPU
    with hp_impl("emulate"):
        ps_em = xrft_tpu.power_spectrum(da, dim=["y", "x"], window="hann",
                                        detrend="linear", engine="hp")
    err_native = np.abs(np.asarray(ps.values) - ref).max() / ref.max()
    err_emul = np.abs(np.asarray(ps_em.values) - ref).max() / ref.max()
    assert err_native <= err_emul


def test_fft_ifft_hp_native_roundtrip():
    N = 96
    rng = np.random.RandomState(1)
    da = LabeledArray(rng.randn(3, N).astype(np.float32), dims=("b", "t"),
                      coords={"t": np.arange(N) * 0.25})
    ft = jax.jit(lambda d: xrft_tpu.fft(d, dim="t", engine="hp"))(da)
    assert isinstance(ft.data, CDF64)
    back = xrft_tpu.ifft(ft, dim="freq_t", engine="hp",
                         lag=float(da.coords["t"].values[N // 2]))
    npt.assert_allclose(np.asarray(back.values).real,
                        np.asarray(da.values, np.float64), atol=1e-13)


def test_rfft_hp_native_vs_numpy():
    """One-sided (real_dim) hp transform == np.fft.rfftn in f64, including
    the true_phase pre-ifftshift and lag phase factor."""
    N, dx = 64, 0.5
    da = _da(N, seed=3, dx=dx)
    ft = xrft_tpu.fft(da, dim=["y", "x"], real_dim="x", engine="hp")
    v = np.asarray(da.values, np.float64)
    lag_y = da.coords["y"].values[N // 2]
    lag_x = da.coords["x"].values[N // 2]
    F = np.fft.rfftn(np.fft.ifftshift(v)) * dx * dx
    fy = np.fft.fftfreq(N, dx)
    fx = np.fft.rfftfreq(N, dx)
    F = F * np.exp(-2j * np.pi * (fy[:, None] * lag_y
                                  + fx[None, :] * lag_x))
    npt.assert_allclose(np.asarray(ft.values), F,
                        atol=1e-12 * np.abs(F).max())


def test_irfft_hp_native_roundtrip():
    N = 64
    da = _da(N, seed=5)
    ft = xrft_tpu.fft(da, dim=["y", "x"], real_dim="x", engine="hp")
    back = xrft_tpu.ifft(ft, dim=["freq_y", "freq_x"], real_dim="freq_x",
                         engine="hp", lag=[da.coords["y"].values[N // 2],
                                           da.coords["x"].values[N // 2]])
    assert isinstance(back.data, DF64)
    npt.assert_allclose(np.asarray(back.values),
                        np.asarray(da.values, np.float64), atol=1e-13)


def test_cross_spectrum_hp_native():
    N, dx = 48, 0.25
    da1, da2 = _da(N, seed=7, dx=dx), _da(N, seed=8, dx=dx)
    cs = xrft_tpu.cross_spectrum(da1, da2, dim=["y", "x"], engine="hp",
                                 window="hann", window_correction=True)
    w = sps.windows.hann(N, sym=False)
    w2 = w[:, None] * w[None, :]
    lag = [da1.coords[d].values[N // 2] for d in ("y", "x")]
    f = np.fft.fftfreq(N, dx)

    def F(v):
        out = np.fft.fftshift(np.fft.fftn(
            np.fft.ifftshift(np.asarray(v, np.float64) * w2))) * dx**2
        fs = np.fft.fftshift(f)
        return out * np.exp(-2j * np.pi * (fs[:, None] * lag[0]
                                           + fs[None, :] * lag[1]))

    ref = F(da1.values) * np.conj(F(da2.values))
    ref = ref / np.mean(w2**2) * (1.0 / (N * dx)) ** 2
    got = np.asarray(cs.values)
    assert np.abs(got - ref).max() / np.abs(ref).max() < TOL


def test_hp_native_segments():
    """Welch segmenting composes with the native hp route."""
    N, seg = 128, 32
    rng = np.random.RandomState(11)
    da = LabeledArray(rng.randn(N).astype(np.float32), dims=("t",),
                      coords={"t": np.arange(N) * 0.5}).chunk({"t": seg})
    ps = xrft_tpu.power_spectrum(da, dim="t", engine="hp",
                                 chunks_to_segments=True, window="hann",
                                 window_correction=True)
    assert ps.sizes["t_segment"] == N // seg
    w = sps.windows.hann(seg, sym=False)
    v = np.asarray(da.values, np.float64).reshape(-1, seg) * w
    ref = np.fft.fftshift(np.abs(np.fft.fft(v) * 0.5) ** 2, axes=-1)
    ref = ref / np.mean(w**2) * (1.0 / (seg * 0.5))
    assert np.abs(np.asarray(ps.values) - ref).max() / ref.max() < TOL


def test_hp_fft_nd_dispatch_contract():
    """The native dispatcher reproduces int8_fft_nd's contract exactly
    (pre/post shift rolls, rfft halving, irfft extension) — both modes
    against the same f64 oracle on a shape where CPU emulation stays
    exact enough to compare."""
    from xrft_tpu.highprec import _hp_fft_nd
    from xrft_tpu.ops.hp import as_quad

    rng = np.random.RandomState(2)
    x = rng.randn(8, 16).astype(np.float32)
    x4 = as_quad(x)
    ref = np.fft.fftshift(np.fft.fftn(
        np.fft.ifftshift(x.astype(np.float64))))

    out_native = _hp_fft_nd(tuple(v.astype(jnp.float64) for v in x4),
                            [0, 1], "fft", pre_shift_axes=[0, 1],
                            post_shift_axes=[0, 1])
    zn = (np.asarray(out_native[0], np.float64)
          + np.asarray(out_native[1], np.float64)
          + 1j * (np.asarray(out_native[2], np.float64)
                  + np.asarray(out_native[3], np.float64)))
    npt.assert_allclose(zn, ref, atol=1e-12 * np.abs(ref).max())

    with hp_impl("emulate"):
        out_emul = _hp_fft_nd(x4, [0, 1], "fft", pre_shift_axes=[0, 1],
                              post_shift_axes=[0, 1])
    ze = (np.asarray(out_emul[0], np.float64)
          + np.asarray(out_emul[1], np.float64)
          + 1j * (np.asarray(out_emul[2], np.float64)
                  + np.asarray(out_emul[3], np.float64)))
    npt.assert_allclose(ze, ref, atol=1e-6 * np.abs(ref).max())
