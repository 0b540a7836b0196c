"""Smoke test of xrft_tpu's spectral path on an NVIDIA GPU.

    python chip_smoke.py             # every one-card phase, on one GPU
    python chip_smoke.py --cards 4   # only the sharded phases, on four GPUs

Each phase drives the public API (``xrft_tpu.*``) under ``jax.jit`` at the
benchmark's sizes (bench.py), compares the result on the host with a
float64 numpy/scipy oracle, and prints one line: the error
max|got - ref| / max|ref| beside its tolerance, the precision the phase
ran at, the steady-state wall time (``block_until_ready``, after a
warm-up call), the compile time, ``compiled.memory_analysis()`` and the
device's ``peak_bytes_in_use``.  A phase that fails makes the script exit
non-zero.  The last line of standard output is one JSON object naming the
device.  The script refuses to run on anything but a GPU, and spawns no
JAX process besides itself (``nvidia-smi`` is its only child).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np

ROOT = Path(__file__).resolve().parent

# sizes of bench.py's cells; TINY keeps every phase's code path at a size
# the CPU test suite can afford
FULL = dict(
    batch=8, n=4096, welch_tiles=4, cross=(64, 512), iso=(512, 2048),
    series=(8, 1 << 22, 4096), conv=(4096, 63), hp_psd=1024, hp_fft=2048,
    emulate=256, pencil=1024, sharded=(64, 4096),
)
TINY = dict(
    batch=2, n=64, welch_tiles=4, cross=(8, 32), iso=(32, 64),
    series=(2, 1 << 12, 256), conv=(64, 9), hp_psd=64, hp_fft=64,
    emulate=32, pencil=16, sharded=(4, 32),
)

F32_FFT = "f32 data, XLA FFT (cuFFT on gpu), f32 elementwise"
HIGHEST = "precision=HIGHEST (full f32 products, no TF32)"


class PhaseFailed(Exception):
    pass


@dataclass
class Phase:
    """One measured call: ``fn(*args)`` under jit, compared by
    ``check(out)`` -> (err, tol) against a host float64 oracle."""

    name: str
    fn: Callable
    args: tuple
    check: Callable
    precision: str
    note: str = ""
    context: Callable | None = None
    reps: int = 5
    # sharded phases: each card must hold a quarter of arguments/outputs
    sharded: bool = False
    result: dict = field(default_factory=dict)
    hlo: str = ""


# --------------------------------------------------------------------------
# host float64 oracles
# --------------------------------------------------------------------------


def hann(n: int) -> np.ndarray:
    import scipy.signal as sps

    return sps.windows.hann(n, sym=False)


def detrend_linear_2d(v: np.ndarray) -> np.ndarray:
    """Least-squares plane removed over the last two axes (centered
    index regressors are orthogonal, so each slope is a projection)."""
    ny, nx = v.shape[-2:]
    iy = np.arange(ny) - (ny - 1) / 2
    ix = np.arange(nx) - (nx - 1) / 2
    vm = v - v.mean(axis=(-2, -1), keepdims=True)
    ay = (vm * iy[:, None]).sum(axis=(-2, -1)) / ((iy ** 2).sum() * nx)
    ax = (vm * ix[None, :]).sum(axis=(-2, -1)) / ((ix ** 2).sum() * ny)
    return (vm - ay[..., None, None] * iy[:, None]
            - ax[..., None, None] * ix[None, :])


def psd2_oracle(v, dy, dx, window=True, detrend=True, one_sided=False):
    """Density-scaled 2-D PSD of one float64 field in xrft's layout:
    frequencies fftshifted, except in the one-sided form, whose
    frequencies stay in numpy order."""
    import scipy.fft as sfft

    ny, nx = v.shape
    if detrend:
        v = detrend_linear_2d(v)
    if window:
        v = v * np.outer(hann(ny), hann(nx))
    if one_sided:
        f = sfft.rfft2(v, workers=-1) * (dy * dx)
        ps = np.abs(f) ** 2 / (ny * dy * nx * dx)
        ps[:, 1:nx - nx // 2] *= 2.0   # doubling: all but DC (and Nyquist)
        return ps
    f = np.fft.fftshift(sfft.fft2(v, workers=-1)) * (dy * dx)
    return np.abs(f) ** 2 / (ny * dy * nx * dx)


def pd_cut_codes(r: np.ndarray, nbins: int) -> np.ndarray:
    """pandas.cut equal-width right-closed codes, written independently
    of the library (np.digitize on pandas' edges)."""
    lo, hi = r.min(), r.max()
    edges = np.linspace(lo, hi, nbins + 1)
    edges[0] -= (hi - lo) * 0.001
    return np.digitize(r, edges, right=True) - 1


def isotropic_oracle(v, d, nfactor=4):
    """Azimuthal sum of the density PSD over pandas.cut radial bins."""
    n = v.shape[-1]
    ps = psd2_oracle(v, d, d, window=False, detrend=False)
    k = np.fft.fftshift(np.fft.fftfreq(n, d))
    # flattened in reversed-dim order (x, y), as xrft broadcasts k^2 + l^2
    r = np.sqrt(k[:, None] ** 2 + k[None, :] ** 2).ravel()
    nbins = n // nfactor
    codes = pd_cut_codes(r, nbins)
    return np.bincount(codes, weights=ps.T.ravel(), minlength=nbins)


def rel_err(got, ref) -> float:
    got = np.asarray(got)
    ref = np.asarray(ref)
    if got.shape != ref.shape:
        raise PhaseFailed(f"shape {got.shape} != oracle {ref.shape}")
    if not np.isfinite(got).all():
        raise PhaseFailed("non-finite values in the result")
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def rel_err_fields(got, ref_of, n: int) -> float:
    """rel_err over a batch compared one field at a time (bounds host
    memory for the large oracles)."""
    got = np.asarray(got)
    num = den = 0.0
    for i in range(n):
        ref = ref_of(i)
        g = got[i]
        if g.shape != ref.shape:
            raise PhaseFailed(f"field shape {g.shape} != oracle {ref.shape}")
        if not np.isfinite(g).all():
            raise PhaseFailed("non-finite values in the result")
        num = max(num, float(np.abs(g - ref).max()))
        den = max(den, float(np.abs(ref).max()))
    return num / den


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def single_card_phases(sz: dict, seed: int = 0) -> list[Phase]:
    """The one-card phases, in run order (hp last: it turns on x64)."""
    import jax
    import scipy.fft as sfft
    import scipy.signal as sps

    import xrft_tpu
    from xrft_tpu import LabeledArray, config, highprec
    from xrft_tpu.config import hp_impl
    from xrft_tpu.ops import carray

    rng = np.random.RandomState(seed)
    B, N = sz["batch"], sz["n"]
    d = 0.5
    fields = rng.randn(B, N, N).astype(np.float32)
    da = LabeledArray(fields, dims=("time", "y", "x"),
                      coords={"y": np.arange(N) * d, "x": np.arange(N) * d})
    v64 = fields.astype(np.float64)
    phases = []

    flag_refs = {}

    def flag_ref(i):
        if i not in flag_refs:
            flag_refs[i] = psd2_oracle(v64[i], d, d)
        return flag_refs[i]

    def psd(a):
        return xrft_tpu.power_spectrum(a, dim=["y", "x"], window="hann",
                                       detrend="linear").data

    phases.append(Phase(
        "flagship_psd", psd, (da,),
        lambda o: (rel_err_fields(o, flag_ref, B), 1e-5), F32_FFT))

    phases.append(Phase(
        "onesided_psd",
        lambda a: xrft_tpu.power_spectrum(
            a, dim=["y", "x"], real_dim="x", window="hann",
            detrend="linear").data,
        (da,),
        lambda o: (rel_err_fields(
            o, lambda i: psd2_oracle(v64[i], d, d, one_sided=True), B),
            1e-5), F32_FFT))

    S = N // sz["welch_tiles"]
    dw = da.chunk({"y": S, "x": S})

    def welch_ref(i, step):
        starts = range(0, N - S + 1, step)
        return np.stack([
            np.stack([psd2_oracle(v64[i, a:a + S, b:b + S], d, d,
                                  detrend=False) for b in starts], axis=1)
            for a in starts])                  # (y_seg, fy, x_seg, fx)

    phases.append(Phase(
        "welch_psd",
        lambda a: xrft_tpu.power_spectrum(
            a, dim=["y", "x"], window="hann", chunks_to_segments=True).data,
        (dw,),
        lambda o: (rel_err_fields(o, lambda i: welch_ref(i, S), B), 1e-5),
        F32_FFT, note=f"{S}^2 tiles"))
    phases.append(Phase(
        "welch_overlap_psd",
        lambda a: xrft_tpu.power_spectrum(
            a, dim=["y", "x"], window="hann", chunks_to_segments=True,
            segment_overlap={"y": 0.5, "x": 0.5}).data,
        (dw,),
        lambda o: (rel_err_fields(o, lambda i: welch_ref(i, S // 2), B),
                   1e-5), F32_FFT, note=f"{S}^2 tiles, 50% overlap"))

    T, M = sz["cross"]
    ca = rng.randn(T, M, M).astype(np.float32)
    cb = rng.randn(T, M, M).astype(np.float32)
    ccoords = {"time": np.arange(T) * 1.0, "y": np.arange(M) * 1.0,
               "x": np.arange(M) * 1.0}
    dca = LabeledArray(ca, dims=("time", "y", "x"), coords=ccoords)
    dcb = LabeledArray(cb, dims=("time", "y", "x"), coords=ccoords)

    def cross_ref():
        fa = np.fft.rfft(ca.astype(np.float64), axis=0)
        fb = np.fft.rfft(cb.astype(np.float64), axis=0)
        fac = np.full(T // 2 + 1, 2.0)
        fac[0] = 1.0
        if T % 2 == 0:
            fac[-1] = 1.0
        return fa * np.conj(fb) * fac[:, None, None] / T

    phases.append(Phase(
        "cross_spectrum",
        lambda a, b: xrft_tpu.cross_spectrum(
            a, b, dim=["time"], real_dim="time").data,
        (dca, dcb), lambda o: (rel_err(o, cross_ref()), 1e-5), F32_FFT))

    lags = [float(da.coords["y"].values[N // 2]),
            float(da.coords["x"].values[N // 2])]

    def roundtrip(a):
        ft = xrft_tpu.fft(a, dim=["y", "x"], true_phase=True,
                          true_amplitude=True)
        return carray.real(xrft_tpu.ifft(
            ft, dim=["freq_y", "freq_x"], true_phase=True,
            true_amplitude=True, lag=lags).data)

    phases.append(Phase(
        "fft_ifft_roundtrip", roundtrip, (da,),
        lambda o: (rel_err_fields(o, lambda i: v64[i], B), 1e-5), F32_FFT))

    # an arbitrary half spectrum, not Hermitian-consistent: the result
    # must follow numpy's c2r semantics, as the reference's irfftn does
    half = (rng.randn(B, N, N // 2 + 1)
            + 1j * rng.randn(B, N, N // 2 + 1)).astype(np.complex64)

    # the inverse's output grid is centred: fftshifted on both axes
    def irfft2(a):
        return xrft_tpu.ifft(a, dim=["freq_y", "freq_x"], real_dim="freq_x",
                             shift=False, lag=None, true_phase=False,
                             true_amplitude=False).data

    for order, fy in (("sorted", np.fft.fftshift(np.fft.fftfreq(N, d))),
                      ("natural", np.fft.fftfreq(N, d))):
        hs = np.fft.fftshift(half, axes=1) if order == "sorted" else half
        dh = LabeledArray(hs, dims=("time", "freq_y", "freq_x"),
                          coords={"freq_y": fy,
                                  "freq_x": np.fft.rfftfreq(N, d)})
        phases.append(Phase(
            f"irfft2_{order}", irfft2, (dh,),
            lambda o: (rel_err_fields(
                o, lambda i: np.fft.fftshift(sfft.irfft2(
                    half[i].astype(np.complex128), s=(N, N),
                    workers=-1)), B), 1e-5),
            F32_FFT, note=f"freq_y in {order} order"))

    for n_iso in sz["iso"]:
        vi = rng.randn(n_iso, n_iso).astype(np.float32)
        di = LabeledArray(vi, dims=("y", "x"),
                          coords={"y": np.arange(n_iso) * 1.0,
                                  "x": np.arange(n_iso) * 1.0})
        phases.append(Phase(
            f"isotropic_psd_{n_iso}",
            lambda a: xrft_tpu.isotropic_power_spectrum(
                a, dim=["y", "x"], truncate=True).data,
            (di,),
            lambda o, vi=vi: (rel_err(
                o, isotropic_oracle(vi.astype(np.float64), 1.0)), 1e-5),
            F32_FFT + "; per-bin sums: grouped f32 scatter-add"))

    Bs, Ns, seg = sz["series"]
    xs = rng.randn(Bs, Ns).astype(np.float32)
    fs = 4000.0
    dsr = LabeledArray(xs, dims=("z", "t"),
                       coords={"t": np.arange(Ns) / fs})
    phases.append(Phase(
        "spectrogram",
        lambda a: xrft_tpu.spectrogram(a, dim="t", seglen=seg,
                                       window="hann").data,
        (dsr,),
        lambda o: (rel_err_fields(
            o, lambda i: sps.spectrogram(
                xs[i].astype(np.float64), fs=fs, window="hann",
                nperseg=seg)[2].T, Bs), 1e-5),
        F32_FFT, note=f"{seg}-point segments"))
    phases.append(Phase(
        "stft",
        lambda a: xrft_tpu.stft(a, dim="t", seglen=seg, window="hann").data,
        (dsr,),
        lambda o: (rel_err_fields(
            o, lambda i: sps.stft(xs[i].astype(np.float64), fs=fs,
                                  window="hann", nperseg=seg)[2].T, Bs),
            1e-5), F32_FFT, note=f"{seg}-point segments"))

    phases.append(Phase(
        "dct2",
        lambda a: xrft_tpu.dct(xrft_tpu.dct(a, dim="x"), dim="y").data,
        (da,),
        lambda o: (rel_err_fields(
            o, lambda i: sfft.dctn(v64[i], type=2, workers=-1), B), 1e-5),
        F32_FFT))

    Nc, K = sz["conv"]
    vc = rng.randn(Nc, Nc).astype(np.float32)
    kc = rng.randn(K, K).astype(np.float32)
    dc = LabeledArray(vc, dims=("y", "x"),
                      coords={"y": np.arange(Nc) * 1.0,
                              "x": np.arange(Nc) * 1.0})
    dk = LabeledArray(kc, dims=("y", "x"),
                      coords={"y": np.arange(K) * 1.0,
                              "x": np.arange(K) * 1.0})
    conv_ref = {}

    def conv_check(o):
        if not conv_ref:
            conv_ref[0] = sps.fftconvolve(vc.astype(np.float64),
                                          kc.astype(np.float64), mode="same")
        return rel_err(o, conv_ref[0]), 1e-5

    phases.append(Phase(
        "fftconvolve",
        lambda a, k: xrft_tpu.fftconvolve(a, k, dims=["y", "x"],
                                          mode="same").data,
        (dc, dk), conv_check, F32_FFT, note=f"{Nc}^2 (*) {K}^2"))
    phases.append(Phase(
        "convolve_direct",
        lambda a, k: xrft_tpu.convolve(a, k, dims=["y", "x"], mode="same",
                                       method="direct").data,
        (dc, dk), conv_check, "conv_general_dilated, " + HIGHEST,
        note=f"{Nc}^2 (*) {K}^2; config.direct_conv_max="
             f"{config.direct_conv_max} puts method='auto' here on "
             f"{'direct' if K * K <= config.direct_conv_max else 'fft'}"))

    # engines kept as plain JAX until ROADMAP Design 1.2-1.3 removes them
    phases.append(Phase(
        "flagship_psd_matmul_engine", psd, (da,),
        lambda o: (rel_err_fields(o, flag_ref, B), 1e-5),
        "f32 stacked matmul engine, dots at " + HIGHEST,
        context=lambda: xrft_tpu.fft_engine("matmul")))

    Ne = sz["emulate"]
    ve = rng.randn(Ne, Ne).astype(np.float32)
    de = LabeledArray(ve, dims=("y", "x"),
                      coords={"y": np.arange(Ne) * d, "x": np.arange(Ne) * d})

    def hp_psd(a):
        return xrft_tpu.power_spectrum(a, dim=["y", "x"], window="hann",
                                       detrend="linear", engine="hp").data

    phases.append(Phase(
        "hp_psd_emulated", hp_psd, (de,),
        lambda o: (rel_err(o, psd2_oracle(ve.astype(np.float64), d, d)),
                   1e-10),
        "df64 (float32 pairs) with exact int8-limb DFT dots",
        context=lambda: hp_impl("emulate")))

    # native float64 hp: needs x64, so it runs last
    Nh = sz["hp_psd"]
    vh = rng.randn(Nh, Nh).astype(np.float32)
    dhp = LabeledArray(vh, dims=("y", "x"),
                       coords={"y": np.arange(Nh) * d,
                               "x": np.arange(Nh) * d})
    Nf = sz["hp_fft"]
    vf = rng.randn(Nf, Nf).astype(np.float32)
    dhf = LabeledArray(vf, dims=("y", "x"),
                       coords={"y": np.arange(Nf) * 1.0,
                               "x": np.arange(Nf) * 1.0})

    @contextlib.contextmanager
    def x64_native():
        with jax.enable_x64(True):
            if not highprec._hp_native():
                raise PhaseFailed("hp is not native float64 under x64")
            yield

    phases.append(Phase(
        "hp_psd_native", hp_psd, (dhp,),
        lambda o: (rel_err(o, psd2_oracle(vh.astype(np.float64), d, d)),
                   1e-10), "float64 (x64 on), c128 FFT",
        context=x64_native))
    phases.append(Phase(
        "hp_fft_native",
        lambda a: xrft_tpu.fft(a, dim=["y", "x"], engine="hp",
                               true_phase=False, true_amplitude=False).data,
        (dhf,),
        lambda o: (rel_err(o, np.fft.fftshift(sfft.fft2(
            vf.astype(np.float64), workers=-1))), 1e-10),
        "float64 (x64 on), c128 FFT", context=x64_native))
    return phases


def multi_card_phases(sz: dict, seed: int = 0) -> list[Phase]:
    """The sharded phases: each card must hold a quarter of the data."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax.sharding import SingleDeviceSharding

    import xrft_tpu
    from xrft_tpu import LabeledArray
    from xrft_tpu.parallel import make_mesh, pencil_fftn
    from xrft_tpu.parallel import sharded_power_spectrum

    card0 = SingleDeviceSharding(jax.devices()[0])
    key = jax.random.PRNGKey(seed)
    phases = []

    # batch x pencil PSD on a 2 x 2 mesh
    T, N = sz["sharded"]
    mesh2 = make_mesh({"dp": 2, "fp": 2})
    shard2 = NamedSharding(mesh2, P("dp", None, "fp"))
    stack = jax.jit(lambda k: jax.random.normal(
        jax.random.fold_in(k, 1), (T, N, N), jnp.float32),
        out_shardings=shard2)(key)
    _check_quarters(stack, None)
    coords = {"y": np.arange(N) * 0.5, "x": np.arange(N) * 0.5}
    dsh = LabeledArray(stack, dims=("time", "y", "x"), coords=coords)
    d0 = LabeledArray(jax.device_put(stack, card0),
                      dims=("time", "y", "x"), coords=coords)
    kw = dict(dim=["y", "x"], window="hann", detrend="linear")
    ref_ps, one_ps, one_ps_bytes = _timed(
        lambda a: xrft_tpu.power_spectrum(a, **kw).data, d0)

    def ps_check(o):
        _check_quarters(o, None)
        _check_card_peaks(one_ps_bytes)
        return _device_rel_err(o, ref_ps), 1e-5

    phases.append(Phase(
        "sharded_power_spectrum",
        lambda a: sharded_power_spectrum(
            a, mesh2, {"time": "dp", "x": "fp"}, **kw).data,
        (dsh,), ps_check, F32_FFT + ", all_to_all over NVLink",
        note=f"{T}x{N}^2, time->dp, x->fp on a 2x2 mesh; the same on "
             f"one card: median {one_ps:.3f} ms, footprint "
             f"{_mib(one_ps_bytes)}",
        reps=3, sharded=True))

    # pencil 3-D FFT over a 1-D mesh of four cards
    n = sz["pencil"]
    mesh1 = make_mesh({"fp": 4})
    shard1 = NamedSharding(mesh1, P("fp", None, None))
    cube = jax.jit(lambda k: jax.random.normal(k, (n, n, n), jnp.float32),
                   out_shardings=shard1)(key)
    _check_quarters(cube, 0)
    cube0 = jax.device_put(cube, card0)
    ref_cube, one_fft, one_fft_bytes = _timed(lambda c: jnp.fft.fftn(c),
                                              cube0)

    def pencil_check(o):
        _check_quarters(o, None)
        _check_card_peaks(one_fft_bytes)
        return _device_rel_err(o, ref_cube), 1e-5

    phases.append(Phase(
        "pencil_fftn_3d",
        lambda c: pencil_fftn(c, [0, 1, 2], mesh1, {0: "fp"}, "fft"),
        (cube,), pencil_check,
        "f32 cuFFT per card, all_to_all over NVLink",
        note=f"{n}^3 over mesh fp=4; jnp.fft.fftn on one card: median "
             f"{one_fft:.3f} ms, footprint {_mib(one_fft_bytes)}", reps=3,
        sharded=True))
    return phases


def _timed(f, *args, reps=3):
    """``f(*args)`` under jit, its median wall time in ms after a
    warm-up, and its footprint on the card: the argument, output and
    temporary bytes of the compiled program."""
    import jax

    compiled = jax.jit(f).lower(*args).compile()
    m = compiled.memory_analysis()
    footprint = (m.argument_size_in_bytes + m.output_size_in_bytes
                 + m.temp_size_in_bytes)
    out = jax.block_until_ready(compiled(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    return out, 1e3 * float(np.median(times)), footprint


def _check_quarters(arr, axis):
    """Every card holds one quarter of ``arr`` (shard shapes), and no
    card holds more than a quarter plus a tenth of its bytes."""
    shards = arr.addressable_shards
    devices = {s.device for s in shards}
    if len(devices) != 4:
        raise PhaseFailed(f"array spans {len(devices)} cards, not 4")
    per_dev = {}
    for s in shards:
        per_dev[s.device] = per_dev.get(s.device, 0) + s.data.size
    quarter = arr.size / 4
    if any(c != quarter for c in per_dev.values()):
        raise PhaseFailed(f"shard sizes {sorted(per_dev.values())} are not "
                          f"quarters of {arr.size}")
    if axis is not None:
        want = list(arr.shape)
        want[axis] //= 4
        bad = [s.data.shape for s in shards if list(s.data.shape) != want]
        if bad:
            raise PhaseFailed(f"shard shapes {bad} != {want}")


def _check_card_peaks(one_card_bytes: int, devices=None) -> None:
    """No card held a full copy of the problem: the lifetime peak of
    every card but the first (which also runs the one-card reference)
    stays below the footprint of the one-card program, which a card
    running the whole problem would have to reach.  Only GPUs report
    peaks; elsewhere this checks nothing."""
    import jax

    devices = jax.devices() if devices is None else devices
    if devices[0].platform != "gpu":
        return
    peaks = [(dev.memory_stats() or {}).get("peak_bytes_in_use")
             for dev in devices[1:]]
    if None in peaks:
        raise PhaseFailed("the cards report no peak_bytes_in_use")
    if max(peaks) >= one_card_bytes:
        raise PhaseFailed(f"card peaks {[_mib(p) for p in peaks]} reach "
                          f"the one-card footprint {_mib(one_card_bytes)}")


def _nbytes(tree) -> int:
    import jax

    return sum(leaf.nbytes for leaf in jax.tree_util.tree_leaves(tree))


def _check_card_bytes(compiled, want) -> None:
    """A sharded program's per-card argument and output bytes
    (``memory_analysis`` reports them per device) are the quarters
    ``want`` — nothing gathered onto one card."""
    m = compiled.memory_analysis()
    if m is None:
        return
    got = (m.argument_size_in_bytes, m.output_size_in_bytes)
    if any(abs(g - w) > 0.05 * w for g, w in zip(got, want)):
        raise PhaseFailed(f"per-card (argument, output) bytes "
                          f"{[_mib(g) for g in got]} != "
                          f"{[_mib(w) for w in want]}")


def _device_rel_err(got, ref) -> float:
    """max|got - ref| / max|ref| computed on the devices (moving ``ref``
    to ``got``'s layout first), so no multi-GiB transfer to the host."""
    import jax
    import jax.numpy as jnp

    ref = jax.device_put(ref, got.sharding)
    num, den, finite = jax.jit(lambda a, b: (
        jnp.max(jnp.abs(a - b)), jnp.max(jnp.abs(b)),
        jnp.all(jnp.isfinite(a))))(got, ref)
    if not bool(finite):
        raise PhaseFailed("non-finite values in the result")
    return float(num) / float(den)


# --------------------------------------------------------------------------
# running
# --------------------------------------------------------------------------


def _mib(b) -> str:
    return f"{b / 2 ** 20:.1f}MiB"


def _memory(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "n/a"
    return (f"arg={_mib(m.argument_size_in_bytes)} "
            f"out={_mib(m.output_size_in_bytes)} "
            f"temp={_mib(m.temp_size_in_bytes)} "
            f"code={_mib(m.generated_code_size_in_bytes)}")


def _peaks() -> str:
    import jax

    out = []
    for dev in jax.local_devices():
        stats = dev.memory_stats() or {}
        if "peak_bytes_in_use" in stats:
            out.append(_mib(stats["peak_bytes_in_use"]))
    return ",".join(out) if out else "n/a"


def run_phase(ph: Phase) -> dict:
    """Compile, warm up, time and check one phase; print its line."""
    import jax

    ctx = ph.context() if ph.context else contextlib.nullcontext()
    with ctx:
        t0 = time.perf_counter()
        # a fresh function object per phase: jit's trace cache does not
        # key on xrft_tpu.config, which some phases' contexts change
        compiled = jax.jit(lambda *a: ph.fn(*a)).lower(*ph.args).compile()
        compile_s = time.perf_counter() - t0
        ph.hlo = compiled.as_text()
        out = jax.block_until_ready(compiled(*ph.args))
        if ph.sharded:
            _check_card_bytes(compiled, (_nbytes(ph.args) // 4,
                                         _nbytes(out) // 4))
        times = []
        for _ in range(ph.reps):
            t0 = time.perf_counter()
            out = jax.block_until_ready(compiled(*ph.args))
            times.append(time.perf_counter() - t0)
        err, tol = ph.check(out)
        mem = _memory(compiled)
    del out
    ok = err <= tol
    ph.result = dict(err=err, tol=tol, ok=ok,
                     wall_ms=1e3 * float(np.median(times)),
                     min_ms=1e3 * min(times), compile_s=compile_s)
    print(f"PHASE {ph.name}: {'ok' if ok else 'FAIL'} err={err:.3e} "
          f"tol={tol:.0e} | precision: {ph.precision} | "
          f"wall_ms median={ph.result['wall_ms']:.3f} "
          f"min={ph.result['min_ms']:.3f} (n={ph.reps}) | "
          f"compile_s={compile_s:.2f} | mem {mem} | peak {_peaks()}"
          + (f" | {ph.note}" if ph.note else ""), flush=True)
    if not ok:
        raise PhaseFailed(f"{ph.name}: err {err:.3e} above tol {tol:.0e}")
    return ph.result


def run_phases(phases: list[Phase]) -> None:
    for ph in phases:
        run_phase(ph)


def nvidia_smi() -> list[str]:
    """Card name and power limit per card, read by nvidia-smi (a child
    process that never imports JAX)."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return [f"unavailable ({type(e).__name__}: {e})"]
    lines = [ln.strip() for ln in res.stdout.splitlines() if ln.strip()]
    return lines if res.returncode == 0 and lines else \
        [f"unavailable (rc {res.returncode}: {res.stderr.strip()[:200]})"]


def phases_for(cards: int, sizes: dict, seed: int = 0) -> list[Phase]:
    """``--cards 4`` runs the sharded phases and nothing else."""
    if cards == 4:
        return multi_card_phases(sizes, seed)
    return single_card_phases(sizes, seed)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="1: every one-card phase; 4: only the sharded "
                         "phases, on four cards")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random input data")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    smi = nvidia_smi()
    for line in smi:
        print(f"nvidia-smi: {line}", flush=True)

    import jax

    platform = jax.default_backend()
    if platform != "gpu":
        print(f"chip_smoke: no GPU: JAX's default backend is {platform!r} "
              f"({jax.devices()}); this smoke test runs only on an NVIDIA "
              f"GPU", file=sys.stderr)
        return 2
    if smi[0].startswith("unavailable"):
        print("chip_smoke: nvidia-smi could not read the card",
              file=sys.stderr)
        return 2
    devs = jax.devices()
    print(f"device: platform={devs[0].platform} kind={devs[0].device_kind} "
          f"count={len(devs)}", flush=True)
    if len(devs) < args.cards:
        print(f"chip_smoke: --cards {args.cards} needs {args.cards} GPUs, "
              f"found {len(devs)}", file=sys.stderr)
        return 2

    from xrft_tpu.config import enable_compile_cache

    print(f"compile cache: {enable_compile_cache(ROOT)}", flush=True)
    t0 = time.perf_counter()
    try:
        run_phases(phases_for(args.cards, FULL, args.seed))
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"total_s={time.perf_counter() - t0:.1f}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
