"""High-precision (engine='hp') pipeline tests.

Semantics parity with float64 numpy oracles that replicate the reference's
math (/root/reference/xrft/xrft.py, /root/reference/xrft/detrend.py).
The double-word primitives survive XLA:CPU's FMA contraction (see
ops/df64.py), so the int8-limb engine holds ~1e-13 here; the strict 1e-10
BASELINE bounds are also pinned on the GPU by chip_smoke.py.
"""

import numpy as np
import numpy.testing as npt
import pytest
import scipy.signal as sps

pytestmark = pytest.mark.slow

import jax

import xrft_tpu
from xrft_tpu import LabeledArray
from xrft_tpu.config import hp_impl
from xrft_tpu.ops.carray import CDF64, DF64

# the int8 integer path is exact on every backend; CPU only degrades the
# df64 elementwise tails, which stay ~1e-11 in practice
TOL = 1e-10


@pytest.fixture(autouse=True)
def _force_emulation():
    """Pin the emulated (int8-limb/df64) code path: with the default
    config.hp_impl='auto' the hp pipelines route native-f64 on this CPU
    backend (tests/test_hp_native.py covers that mode) and these tests
    would silently stop exercising the emulation."""
    with hp_impl("emulate"):
        yield


def _da(N=64, seed=0, dx=0.5):
    rng = np.random.RandomState(seed)
    return LabeledArray(
        rng.randn(N, N).astype(np.float32), dims=("y", "x"),
        coords={"y": np.arange(N) * dx, "x": np.arange(N) * dx})


def test_psd_hp_windowed_detrended():
    """BASELINE config 2: 2-D linear-detrend + hann PSD at f64 grade."""
    N, dx = 64, 0.5
    da = _da(N)
    ps = xrft_tpu.power_spectrum(da, dim=["y", "x"], window="hann",
                                 detrend="linear", engine="hp")
    assert isinstance(ps.data, DF64)
    assert ps.values.dtype == np.float64

    v = np.asarray(da.values, np.float64)
    i = np.arange(N) - (N - 1) / 2
    vm = v - v.mean()
    a1 = (vm * i[:, None]).sum() / ((i**2).sum() * N)
    a2 = (vm * i[None, :]).sum() / ((i**2).sum() * N)
    vd = vm - a1 * i[:, None] - a2 * i[None, :]
    w = sps.windows.hann(N, sym=False)
    F = np.fft.fftshift(np.fft.fftn(vd * (w[:, None] * w[None, :]))) * dx**2
    ref = np.abs(F) ** 2 * (1.0 / (N * dx)) ** 2
    assert np.abs(ps.values - ref).max() / ref.max() < TOL


def test_fft_ifft_hp_roundtrip():
    """BASELINE config 1: 1-D roundtrip at f64 grade, jit-compiled."""
    N = 128
    rng = np.random.RandomState(1)
    da = LabeledArray(rng.randn(3, N).astype(np.float32), dims=("b", "t"),
                      coords={"t": np.arange(N) * 0.25})

    @jax.jit
    def roundtrip(d):
        ft = xrft_tpu.fft(d, dim=["t"], engine="hp")
        back = xrft_tpu.ifft(ft, dim=["freq_t"], engine="hp",
                             lag=[float(np.arange(N)[N // 2] * 0.25)])
        return back.data

    out = roundtrip(da)
    assert isinstance(out, CDF64)
    got = np.asarray(out)
    npt.assert_allclose(got.real, np.asarray(da.values, np.float64),
                        atol=1e-11)
    assert np.abs(got.imag).max() < 1e-11


def test_fft_hp_vs_numpy_phase_amplitude():
    N, dx = 96, 0.5
    da = _da(N, seed=3)
    ft = xrft_tpu.fft(da, dim=["x"], engine="hp")
    v = np.asarray(da.values, np.float64)
    lag = np.arange(N)[N // 2] * dx
    f = np.fft.fftshift(np.fft.fftfreq(N, dx))
    ref = np.fft.fftshift(np.fft.fft(np.fft.ifftshift(v, axes=1)), axes=1)
    ref = ref * np.exp(-2j * np.pi * f * lag)[None, :] * dx
    assert np.abs(ft.values - ref).max() / np.abs(ref).max() < TOL
    assert ft.dims == ("y", "freq_x")


def test_rfft_hp_real_dim():
    N, dx = 64, 1.0
    da = _da(N, seed=4, dx=dx)
    ft = xrft_tpu.fft(da, dim=["y"], real_dim="y", engine="hp",
                      true_phase=False, true_amplitude=False)
    ref = np.fft.rfft(np.asarray(da.values, np.float64), axis=0)
    assert ft.dims == ("freq_y", "x")
    assert np.abs(ft.values - ref).max() / np.abs(ref).max() < TOL


def test_cross_spectrum_hp():
    """BASELINE config 4 shape: rfft cross-spectrum + phase."""
    N, dx = 64, 0.5
    da1, da2 = _da(N, seed=5), _da(N, seed=6)
    cs = xrft_tpu.cross_spectrum(da1, da2, dim=["y"], real_dim="y",
                                 engine="hp")
    assert isinstance(cs.data, CDF64)
    v1 = np.asarray(da1.values, np.float64)
    v2 = np.asarray(da2.values, np.float64)
    ly = 0.5 * (N // 2)
    fy = np.fft.rfftfreq(N, dx)
    ph = np.exp(-2j * np.pi * fy * ly)[:, None]
    F1 = np.fft.rfft(v1, axis=0) * dx * ph
    F2 = np.fft.rfft(v2, axis=0) * dx * ph
    ref = F1 * np.conj(F2)
    fct = np.full(N // 2 + 1, 2.0)
    fct[0] = fct[-1] = 1.0
    ref = ref * fct[:, None] / (N * dx)
    assert np.abs(cs.values - ref).max() / np.abs(ref).max() < TOL

    cp = xrft_tpu.cross_phase(da1, da2, dim=["y"], real_dim="y", engine="hp")
    # angle is ill-conditioned where |cs| ~ 0, and +pi == -pi on the branch
    # cut: compare the wrapped difference where significant
    mask = np.abs(ref) > 1e-3 * np.abs(ref).max()
    dphi = np.angle(np.exp(1j * (np.asarray(cp.values, np.float64)
                                 - np.angle(ref))))
    assert np.abs(dphi[mask]).max() < 1e-5


def test_isotropic_hp_conservation():
    """BASELINE config 3: isotropic PSD bin sums conserve the total at f64
    grade (reference conservation test,
    /root/reference/xrft/tests/test_xrft.py:963)."""
    N = 64
    da = _da(N, seed=7, dx=1.0)
    ps = xrft_tpu.power_spectrum(da, dim=["y", "x"], engine="hp")
    iso = xrft_tpu.isotropic_power_spectrum(da, dim=["y", "x"],
                                            truncate=False, engine="hp")
    assert isinstance(iso.data, DF64)
    tot_ps = np.asarray(ps.values).sum()
    tot_iso = np.asarray(iso.values).sum()
    assert abs(tot_iso - tot_ps) / abs(tot_ps) < 1e-12


def test_hp_scaling_variants():
    N = 64
    da = _da(N, seed=8)
    for scaling in ("density", "spectrum", "false_density"):
        ps = xrft_tpu.power_spectrum(da, dim=["y", "x"], scaling=scaling,
                                     engine="hp")
        ref = xrft_tpu.power_spectrum(da, dim=["y", "x"], scaling=scaling)
        rel = np.abs(ps.values - ref.values).max() / np.abs(ref.values).max()
        assert rel < 1e-5  # f32 reference engine grade

    ps = xrft_tpu.power_spectrum(da, dim=["y", "x"], window="hann",
                                 window_correction=True, engine="hp")
    ref = xrft_tpu.power_spectrum(da, dim=["y", "x"], window="hann",
                                  window_correction=True)
    rel = np.abs(ps.values - ref.values).max() / np.abs(ref.values).max()
    assert rel < 1e-5


def test_hp_fft_segments():
    """chunks_to_segments with engine='hp': segment reshape before the
    df64 promotion; per-segment numpy f64 oracle."""
    N, seg = 32, 16
    rng = np.random.RandomState(21)
    da = LabeledArray(rng.randn(N).astype(np.float32), dims=["t"],
                      coords={"t": np.arange(N, dtype=float)}
                      ).chunk({"t": seg})
    out = xrft_tpu.fft(da, dim=["t"], chunks_to_segments=True,
                       true_phase=False, true_amplitude=False,
                       shift=False, engine="hp")
    assert out.dims == ("t_segment", "freq_t")
    ref = np.fft.fft(np.asarray(da.values, np.float64).reshape(2, seg),
                     axis=-1)
    npt.assert_allclose(np.asarray(out.values), ref, atol=1e-10)
    # segmented PSD too
    ps = xrft_tpu.power_spectrum(da, dim=["t"], chunks_to_segments=True,
                                 engine="hp")
    assert "t_segment" in ps.dims


def test_hp_ifft_segments():
    """ifft with chunks_to_segments under engine='hp': segment reshape
    after the lag phase premultiplication (reference
    /root/reference/xrft/xrft.py:574-579), per-segment numpy oracle at
    df64 grade."""
    N, seg = 32, 16
    rng = np.random.RandomState(33)
    spec = rng.randn(N) + 1j * rng.randn(N)
    f16 = np.fft.fftshift(np.fft.fftfreq(seg, 0.5))
    daft = LabeledArray(spec, dims=["freq_t"],
                        coords={"freq_t": np.tile(f16, 2)}
                        ).chunk({"freq_t": seg})

    out = xrft_tpu.ifft(daft, dim=["freq_t"], chunks_to_segments=True,
                        true_phase=True, lag=[0.0], true_amplitude=False,
                        shift=False, engine="hp")
    assert out.dims == ("freq_t_segment", "t")
    ref = np.fft.ifft(np.fft.ifftshift(spec.reshape(2, seg), axes=-1),
                      axis=-1)
    npt.assert_allclose(np.asarray(out.values), ref, atol=1e-12)

    # nonzero lag: the df64 phase premultiply runs on the full coord
    # BEFORE the segment reshape
    out3 = xrft_tpu.ifft(daft, dim=["freq_t"], chunks_to_segments=True,
                         true_phase=True, lag=[3.0], true_amplitude=False,
                         shift=False, engine="hp")
    pre = spec * np.exp(2j * np.pi * np.tile(f16, 2) * 3.0)
    ref3 = np.fft.ifft(np.fft.ifftshift(pre.reshape(2, seg), axes=-1),
                       axis=-1)
    npt.assert_allclose(np.asarray(out3.values), ref3, atol=1e-12)


@pytest.mark.parametrize("shape", [(8, 16), (6, 10)])
@pytest.mark.parametrize("tp,sh", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_ifft_hp_real_dim_flag_combos(shape, tp, sh):
    """ifft(engine='hp', real_dim=) matches the f32 engine for every
    true_phase x shift combo (round 4: the hp path previously dropped
    the output shift on the full-length real axis — reference shifts
    every transformed axis, /root/reference/xrft/xrft.py:617-621)."""
    Ny, Nx = shape
    rng = np.random.RandomState(5)
    v = rng.randn(Ny, Nx)
    F = np.fft.rfftn(v)
    daft = LabeledArray(
        F.astype(np.complex128), dims=("freq_y", "freq_x"),
        coords={"freq_y": np.fft.fftfreq(Ny, 1.0),
                "freq_x": np.fft.rfftfreq(Nx, 1.0)})
    kw = dict(dim=["freq_y", "freq_x"], real_dim="freq_x", true_phase=tp,
              shift=sh, true_amplitude=False, lag=[0.0, 0.0])
    with np.errstate(all="ignore"), _np_warn_silence():
        b32 = np.asarray(xrft_tpu.ifft(daft, **kw).values)
        bhp = np.asarray(xrft_tpu.ifft(daft, engine="hp", **kw).values)
    npt.assert_allclose(bhp, b32, atol=1e-12)


class _np_warn_silence:
    def __enter__(self):
        import warnings as _w

        self._c = _w.catch_warnings()
        self._c.__enter__()
        _w.simplefilter("ignore")

    def __exit__(self, *a):
        self._c.__exit__(*a)


def test_df64_labeledarray_ops():
    """DF64/CDF64 as LabeledArray data: structural ops flow through
    carray._map; values reconstruct float64/complex128."""
    da = _da(16)
    ft = xrft_tpu.fft(da, dim=["x"], engine="hp")
    t = ft.transpose("freq_x", "y")
    assert t.dims == ("freq_x", "y")
    sub = ft.isel(y=slice(0, 4))
    assert sub.shape == (4, 16)
    assert sub.values.dtype == np.complex128
    assert ft.conj().values[0, 1] == np.conj(ft.values[0, 1])
    re = ft.real
    assert re.values.dtype == np.float64


def test_quad_complex_input_detrend_window_combos():
    """Jit-staged host-complex128 input (flattened as a CDF64 quad on
    split-complex backends) through every detrend/window/engine combo:
    the f32 engines degrade the quad cleanly (~1e-7) and engine='hp'
    keeps f64 grade — including detrend/window applied to complex data
    (reference applies them dtype-blind, /root/reference/xrft/xrft.py:
    425-433, /root/reference/xrft/detrend.py:64-95)."""
    from xrft_tpu.config import complex_mode
    from xrft_tpu.ops import carray

    N = 64
    rng = np.random.RandomState(0)
    z = (rng.randn(N) + 1j * rng.randn(N)).astype(np.complex128)
    da = LabeledArray(z, dims=("x",), coords={"x": np.arange(N) * 0.5})

    def host_ref(kw):
        v = z.copy()
        if kw.get("detrend") == "constant":
            v = v - v.mean()
        elif kw.get("detrend") == "linear":
            v = sps.detrend(v.real) + 1j * sps.detrend(v.imag)
        if kw.get("window") == "hann":
            v = v * sps.windows.hann(N, sym=False)
        F = np.fft.fftshift(np.fft.fft(np.fft.ifftshift(v)))
        lag = np.arange(N)[N // 2] * 0.5
        fr = np.fft.fftshift(np.fft.fftfreq(N, 0.5))
        return F * np.exp(-2j * np.pi * fr * lag) * 0.5

    combos = [dict(), dict(detrend="constant"), dict(detrend="linear"),
              dict(window="hann"), dict(detrend="linear", window="hann"),
              dict(engine="hp"), dict(engine="hp", detrend="constant"),
              dict(engine="hp", detrend="linear", window="hann")]
    with complex_mode("split"):
        for kw in combos:
            f = jax.jit(lambda d, kw=kw: xrft_tpu.fft(
                d, dim=["x"], **kw).data)
            got = carray.to_numpy(f(da))
            ref = host_ref(kw)
            tol = 1e-12 if kw.get("engine") == "hp" else 1e-5
            err = np.abs(got - ref).max() / np.abs(ref).max()
            assert err < tol, (kw, err)
