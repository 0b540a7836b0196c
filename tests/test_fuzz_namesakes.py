"""Property fuzz for the scipy-namesake families:
randomized shapes/params vs the scipy oracle, mirroring the transform
core's test_fuzz_parity genre — czt spirals with random w/a, zoom_fft
random bands, resample up/down with random windows, istft roundtrips
with random NOLA-satisfying windows and odd hops, lombscargle on
adversarial uneven grids, the convolution family across random
mode x shape x broadcast cells, dct/dst over random type x norm, hilbert
and fht over random parameters.  Every case is seeded; the whole module
runs in the `slow` CI leg.  Oracle-parity genre per SURVEY.md section 4
genre 1 (the reference's own oracle is numpy/scipy,
/root/reference/xrft/tests/test_xrft.py).
"""

import numpy as np
import numpy.testing as npt
import pytest
import scipy.fft as sfft
import scipy.signal as sps

import xrft_tpu
from xrft_tpu import LabeledArray

pytestmark = pytest.mark.slow


def _arr(vals, dims, dx=None, seed=None):
    rng = np.random.RandomState(0 if seed is None else seed)
    coords = {}
    for i, d in enumerate(dims):
        step = (0.1 + rng.rand()) if dx is None else dx
        coords[d] = rng.randn() + step * np.arange(vals.shape[i])
    return LabeledArray(vals, dims=list(dims), coords=coords)


# ---------------------------------------------------------------------------
# czt: random spirals.  The dynamic-range budget E = max(n,m)^2/2*|ln|w||
# + n*|ln|a|| is kept small enough that float64 holds the spiral exactly
# (documented accuracy contract in xrft_tpu/czt.py).
# ---------------------------------------------------------------------------

CZT_CASES = []
_crng = np.random.RandomState(501)
for i in range(10):
    n = int(_crng.randint(3, 97))
    m = int(_crng.randint(1, n + 21))
    big = max(n, m)
    # |ln w| budget: E_w <= 3  ->  |ln w| <= 6 / big^2
    lw = _crng.uniform(-6.0, 6.0) / big**2
    la = _crng.uniform(-2.0, 2.0) / n
    CZT_CASES.append(dict(
        seed=500 + i, n=n, m=m,
        w=float(np.exp(lw)) * np.exp(1j * _crng.uniform(-np.pi, np.pi)),
        a=float(np.exp(la)) * np.exp(1j * _crng.uniform(-np.pi, np.pi)),
        complex=bool(_crng.rand() < 0.5),
    ))


@pytest.mark.parametrize("case", CZT_CASES, ids=lambda c: f"czt{c['seed']}")
def test_czt_fuzz(case):
    rs = np.random.RandomState(case["seed"])
    x = rs.randn(case["n"])
    if case["complex"]:
        x = x + 1j * rs.randn(case["n"])
    da = _arr(x, ["t"], dx=0.5)
    got = np.asarray(xrft_tpu.czt(da, m=case["m"], w=case["w"],
                                  a=case["a"]).values)
    want = sps.czt(x, m=case["m"], w=case["w"], a=case["a"])
    npt.assert_allclose(got, want, atol=1e-9 * max(np.abs(want).max(), 1.0))


ZOOM_CASES = []
_zrng = np.random.RandomState(601)
for i in range(6):
    n = int(_zrng.randint(16, 200))
    fs = float(_zrng.uniform(1.0, 200.0))
    f1 = float(_zrng.uniform(0.0, fs / 2 * 0.8))
    f2 = float(_zrng.uniform(f1 + fs / 100, fs / 2))
    ZOOM_CASES.append(dict(
        seed=600 + i, n=n, fs=fs, fn=[f1, f2],
        m=int(_zrng.randint(1, 2 * n)),
        endpoint=bool(_zrng.rand() < 0.5),
        complex=bool(_zrng.rand() < 0.4),
    ))


@pytest.mark.parametrize("case", ZOOM_CASES, ids=lambda c: f"zoom{c['seed']}")
def test_zoom_fft_fuzz(case):
    rs = np.random.RandomState(case["seed"])
    x = rs.randn(case["n"])
    if case["complex"]:
        x = x + 1j * rs.randn(case["n"])
    da = _arr(x, ["t"], dx=0.25)
    got = np.asarray(xrft_tpu.zoom_fft(da, case["fn"], m=case["m"],
                                       fs=case["fs"],
                                       endpoint=case["endpoint"]).values)
    want = sps.zoom_fft(x, case["fn"], m=case["m"], fs=case["fs"],
                        endpoint=case["endpoint"])
    npt.assert_allclose(got, want, atol=1e-9 * max(np.abs(want).max(), 1.0))


# ---------------------------------------------------------------------------
# resample: random up/down factors x window kinds (None, named, tuple-
# parameterized, callable, explicit array) x real/complex x batch dims.
# ---------------------------------------------------------------------------

RESAMPLE_CASES = []
_rrng = np.random.RandomState(701)
for i in range(10):
    n = int(_rrng.randint(2, 81))
    num = int(_rrng.randint(2, 81))
    wk = int(_rrng.randint(5))
    window = [None, "hann", ("kaiser", float(_rrng.uniform(1.0, 8.0))),
              "callable", "array"][wk]
    RESAMPLE_CASES.append(dict(
        seed=700 + i, n=n, num=num, window=window,
        complex=bool(_rrng.rand() < 0.4),
        batch=bool(_rrng.rand() < 0.4),
    ))


@pytest.mark.parametrize("case", RESAMPLE_CASES,
                         ids=lambda c: f"rs{c['seed']}")
def test_resample_fuzz(case):
    rs = np.random.RandomState(case["seed"])
    shape = (3, case["n"]) if case["batch"] else (case["n"],)
    x = rs.randn(*shape)
    if case["complex"]:
        x = x + 1j * rs.randn(*shape)
    window = case["window"]
    if window == "callable":
        def window(f):  # noqa: E306 — scipy passes fftfreq(n)
            return 1.0 / (1.0 + (4.0 * f) ** 2)
    elif window == "array":
        window = rs.uniform(0.2, 1.0, case["n"])
    dims = ["b", "t"] if case["batch"] else ["t"]
    da = _arr(x, dims, dx=0.5, seed=case["seed"])
    got = np.asarray(xrft_tpu.resample(da, case["num"], dim="t",
                                       window=window).values)
    want = sps.resample(x, case["num"], axis=-1, window=window)
    npt.assert_allclose(got, want, atol=1e-9 * max(np.abs(want).max(), 1.0))


# ---------------------------------------------------------------------------
# stft/istft: random window names x odd hops, filtered by scipy's NOLA
# check at case-generation time; forward parity vs scipy.signal.stft and
# the istft(stft(x)) roundtrip.
# ---------------------------------------------------------------------------

_STFT_WINDOWS = ["hann", "hamming", "blackman", "bartlett", "boxcar",
                 "nuttall", "triang", "cosine", "flattop"]
STFT_CASES = []
_srng = np.random.RandomState(801)
while len(STFT_CASES) < 10:
    seglen = int(_srng.randint(8, 65))
    overlap = int(_srng.randint(1, seglen))
    window = _STFT_WINDOWS[int(_srng.randint(len(_STFT_WINDOWS)))]
    w = sps.get_window(window, seglen, fftbins=True)
    if not sps.check_NOLA(w, seglen, overlap):
        continue
    STFT_CASES.append(dict(
        seed=800 + len(STFT_CASES),
        n=int(_srng.randint(3 * seglen, 8 * seglen)),
        seglen=seglen, overlap=overlap, window=window,
        scaling=["spectrum", "psd"][int(_srng.randint(2))],
    ))


@pytest.mark.parametrize("case", STFT_CASES, ids=lambda c: f"st{c['seed']}")
def test_stft_istft_fuzz(case):
    rs = np.random.RandomState(case["seed"])
    n, L, o = case["n"], case["seglen"], case["overlap"]
    x = rs.randn(n)
    fs = 4.0
    da = LabeledArray(x, dims=["t"], coords={"t": np.arange(n) / fs})
    Z = xrft_tpu.stft(da, dim="t", seglen=L, segment_overlap=o,
                      window=case["window"], scaling=case["scaling"])
    f_ref, t_ref, Z_ref = sps.stft(x, fs=fs, window=case["window"],
                                   nperseg=L, noverlap=o,
                                   scaling=case["scaling"])
    npt.assert_allclose(np.asarray(Z["freq_t"].values), f_ref, atol=1e-12)
    npt.assert_allclose(np.asarray(Z["t_segment"].values), t_ref,
                        atol=1e-12)
    npt.assert_allclose(np.asarray(Z.values), Z_ref.T,
                        atol=1e-9 * max(np.abs(Z_ref).max(), 1e-6))
    # NOLA-guaranteed roundtrip: attrs carry every inversion parameter
    # (f32-grade overlap-add, see stft.py module docstring)
    back = xrft_tpu.istft(Z)
    npt.assert_allclose(np.asarray(back.values)[:n], x,
                        atol=1e-6 * max(np.abs(x).max(), 1.0))
    npt.assert_allclose(np.asarray(back["t"].values)[:n],
                        np.arange(n) / fs, atol=1e-12)


# ---------------------------------------------------------------------------
# lombscargle: adversarial uneven time grids (clusters with huge gaps,
# geometric spacing, near-duplicate samples) x normalize modes x random
# weights x floating mean.
# ---------------------------------------------------------------------------

def _adversarial_times(kind, n, rng):
    if kind == "clusters":
        k = n // 2
        t = np.concatenate([rng.uniform(0, 1, k),
                            rng.uniform(500, 501, n - k)])
    elif kind == "geometric":
        t = 1e-3 * 1.15 ** np.arange(n)
    elif kind == "near_dup":
        base = np.sort(rng.uniform(0, 30, (n + 1) // 2))
        t = np.concatenate([base, base[: n // 2] + 1e-6])
    else:  # uniform-random
        t = rng.uniform(0, 50, n)
    return np.sort(t)


LOMB_CASES = []
_lrng = np.random.RandomState(901)
for i, kind in enumerate(["clusters", "geometric", "near_dup", "random"] * 2):
    LOMB_CASES.append(dict(
        seed=900 + i, kind=kind, n=int(_lrng.randint(40, 160)),
        normalize=[False, True, "amplitude"][int(_lrng.randint(3))],
        weighted=bool(_lrng.rand() < 0.5),
        floating_mean=bool(_lrng.rand() < 0.5),
    ))


@pytest.mark.parametrize("case", LOMB_CASES, ids=lambda c: f"lg{c['seed']}")
def test_lombscargle_fuzz(case):
    rs = np.random.RandomState(case["seed"])
    t = _adversarial_times(case["kind"], case["n"], rs)
    y = np.cos(2.3 * t + 0.7) + 0.5 + 0.4 * rs.randn(case["n"])
    freqs = np.concatenate([rs.uniform(1e-3, 0.1, 40),
                            rs.uniform(0.1, 8.0, 80)])
    wts = rs.uniform(0.05, 3.0, case["n"]) if case["weighted"] else None
    da = LabeledArray(y, dims=["t"], coords={"t": t})
    got = np.asarray(xrft_tpu.lombscargle(
        da, freqs, dim="t", normalize=case["normalize"], weights=wts,
        floating_mean=case["floating_mean"]).values)
    want = sps.lombscargle(t, y, freqs, normalize=case["normalize"],
                           weights=wts,
                           floating_mean=case["floating_mean"])
    if case["normalize"] == "amplitude":
        got, want = np.abs(got), np.abs(want)
    npt.assert_allclose(got, want,
                        rtol=1e-7, atol=1e-9 * max(np.abs(want).max(), 1.0))


# ---------------------------------------------------------------------------
# convolution family: random ndim x mode x kernel-broadcast cells.  The
# scipy model broadcasts the kernel over batch dims by looping.
# ---------------------------------------------------------------------------

CONV_CASES = []
_vrng = np.random.RandomState(1001)
for i in range(12):
    ndim = int(_vrng.randint(1, 4))
    shape1 = tuple(int(_vrng.randint(6, 28)) for _ in range(ndim))
    n_c = int(_vrng.randint(1, ndim + 1))
    cdims = sorted(_vrng.choice(ndim, size=n_c, replace=False).tolist())
    # mode='valid' requires the kernel to fit inside the data
    shape2 = tuple(int(_vrng.randint(1, shape1[a] + 1)) for a in cdims)
    # oaconvolve blocks a single long dim by contract (convolve.py:201);
    # it only enters single-conv-dim cells
    fns = ["fftconvolve", "correlate"] + (["oaconvolve"] if n_c == 1 else [])
    CONV_CASES.append(dict(
        seed=1000 + i, shape1=shape1, cdims=cdims, shape2=shape2,
        fn=fns[int(_vrng.randint(len(fns)))],
        mode=["full", "same", "valid"][int(_vrng.randint(3))],
        broadcast=bool(_vrng.rand() < 0.5) and n_c < ndim,
    ))


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: f"cv{c['seed']}")
def test_convolve_fuzz(case):
    rs = np.random.RandomState(case["seed"])
    ndim = len(case["shape1"])
    dims = [f"d{i}" for i in range(ndim)]
    cnames = [dims[a] for a in case["cdims"]]
    x = rs.randn(*case["shape1"])
    k = rs.randn(*case["shape2"])
    da = _arr(x, dims, dx=0.5, seed=case["seed"])
    db = LabeledArray(k, dims=cnames,
                      coords={d: np.arange(s) * 0.5
                              for d, s in zip(cnames, case["shape2"])})
    got = np.asarray(getattr(xrft_tpu, case["fn"])(
        da, db, dims=cnames, mode=case["mode"]).values)

    # scipy model: kernel expanded to full ndim (size-1 batch dims), then
    # scipy convolves/correlates over all axes — size-1 batch axes under
    # mode 'full'/'same'/'valid' leave batch extents unchanged
    kshape = [1] * ndim
    for a, s in zip(case["cdims"], case["shape2"]):
        kshape[a] = s
    kfull = k.reshape(kshape)
    if case["fn"] == "correlate":
        want = sps.correlate(x, kfull, mode=case["mode"], method="fft")
    else:
        want = sps.fftconvolve(x, kfull, mode=case["mode"])
    npt.assert_allclose(got, want, atol=1e-9 * max(np.abs(want).max(), 1.0))


# ---------------------------------------------------------------------------
# dct/dst: random type x norm x length x batch, forward and inverse.
# ---------------------------------------------------------------------------

TRIG_CASES = []
_trng = np.random.RandomState(1101)
for i in range(10):
    TRIG_CASES.append(dict(
        seed=1100 + i,
        n=int(_trng.randint(4, 120)),
        kind=["dct", "dst", "idct", "idst"][int(_trng.randint(4))],
        type=int(_trng.randint(1, 5)),
        norm=[None, "ortho"][int(_trng.randint(2))],
        batch=bool(_trng.rand() < 0.4),
    ))


@pytest.mark.parametrize("case", TRIG_CASES, ids=lambda c: f"tr{c['seed']}")
def test_trig_fuzz(case):
    rs = np.random.RandomState(case["seed"])
    shape = (3, case["n"]) if case["batch"] else (case["n"],)
    x = rs.randn(*shape)
    dims = ["b", "t"] if case["batch"] else ["t"]
    da = _arr(x, dims, dx=1.0, seed=case["seed"])
    got = np.asarray(getattr(xrft_tpu, case["kind"])(
        da, dim="t", type=case["type"], norm=case["norm"]).values)
    want = getattr(sfft, case["kind"])(x, type=case["type"], axis=-1,
                                       norm=case["norm"])
    npt.assert_allclose(got, want, atol=1e-9 * max(np.abs(want).max(), 1.0))


# ---------------------------------------------------------------------------
# hilbert and fht: random lengths/parameters.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [1200, 1201, 1202, 1203])
def test_hilbert_fuzz(seed):
    rs = np.random.RandomState(seed)
    n = int(rs.randint(8, 300))
    batch = bool(rs.rand() < 0.5)
    shape = (4, n) if batch else (n,)
    x = rs.randn(*shape)
    dims = ["b", "t"] if batch else ["t"]
    da = _arr(x, dims, dx=0.5, seed=seed)
    got = np.asarray(xrft_tpu.hilbert(da, dim="t").values)
    want = sps.hilbert(x, axis=-1)
    npt.assert_allclose(got, want, atol=1e-9 * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("seed", [1300, 1301, 1302, 1303])
def test_fht_fuzz(seed):
    rs = np.random.RandomState(seed)
    n = int(rs.randint(16, 200))
    mu = float(rs.uniform(-0.5, 3.0))
    bias = float(rs.uniform(-1.0, 1.0)) if rs.rand() < 0.5 else 0.0
    dln = float(rs.uniform(0.02, 0.15))
    offset = (float(xrft_tpu.fhtoffset(dln, mu, bias=bias))
              if rs.rand() < 0.5 else 0.0)
    r = np.exp(np.log(1e-2) + dln * np.arange(n))
    a = r ** (mu + 1) * np.exp(-(r ** 2) / 2) + 0.01 * rs.randn(n)
    da = LabeledArray(a, dims=["r"], coords={"r": r})
    got = np.asarray(xrft_tpu.fht(da, dln=dln, mu=mu, offset=offset,
                                  bias=bias, dim="r").values)
    want = sfft.fht(a, dln, mu=mu, offset=offset, bias=bias)
    npt.assert_allclose(got, want,
                        rtol=1e-7, atol=1e-9 * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("seed", [1400, 1401, 1402, 1403, 1404, 1405])
def test_upfirdn_resample_poly_fuzz(seed):
    """Random (n, up, down, taps, window, padtype) cells vs scipy —
    including up == down, taps longer than the signal, and batch dims."""
    rs = np.random.RandomState(seed)
    n = int(rs.randint(8, 400))
    up = int(rs.randint(1, 9))
    down = int(rs.randint(1, 9))
    taps = int(rs.randint(1, 64))
    batch = bool(rs.rand() < 0.5)
    shape = (3, n) if batch else (n,)
    x = rs.randn(*shape)
    dims = ["b", "t"] if batch else ["t"]
    da = _arr(x, dims, dx=0.5, seed=seed)
    h = rs.randn(taps)
    got = np.asarray(xrft_tpu.upfirdn(h, da, up, down, dim="t").values)
    want = sps.upfirdn(h, x, up, down, axis=-1)
    assert got.shape == want.shape
    npt.assert_allclose(got, want, atol=1e-9 * max(np.abs(want).max(), 1.0))

    padtype = ["constant", "mean", "median", "minimum",
               "maximum"][rs.randint(5)]
    wname = [("kaiser", float(rs.uniform(1.0, 9.0))), "hamming",
             ("gaussian", float(rs.uniform(2.0, 9.0)))][rs.randint(3)]
    got = np.asarray(xrft_tpu.resample_poly(
        da, up, down, dim="t", window=wname, padtype=padtype).values)
    want = sps.resample_poly(x, up, down, axis=-1, window=wname,
                             padtype=padtype)
    assert got.shape == want.shape
    npt.assert_allclose(got, want, atol=1e-9 * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("seed", [1500, 1501, 1502, 1503])
def test_dctn_dstn_fuzz(seed):
    """Random shape x dim-subset x type x norm cells vs scipy.fft."""
    rs = np.random.RandomState(seed)
    ndim = int(rs.randint(2, 4))
    shape = tuple(int(rs.randint(3, 24)) for _ in range(ndim))
    dims = ["a", "b", "c"][:ndim]
    x = rs.randn(*shape)
    da = LabeledArray(x, dims=dims)
    k = int(rs.randint(1, ndim + 1))
    sel = sorted(rs.choice(ndim, size=k, replace=False))
    type_ = int(rs.randint(1, 5))
    norm = [None, "ortho", "forward"][rs.randint(3)]
    if type_ == 1 and any(shape[i] < 2 for i in sel):
        return
    for mine, ref in ((xrft_tpu.dctn, sfft.dctn),
                      (xrft_tpu.dstn, sfft.dstn)):
        got = np.asarray(mine(da, dim=[dims[i] for i in sel], type=type_,
                              norm=norm).values)
        want = ref(x, type=type_, norm=norm, axes=tuple(sel))
        npt.assert_allclose(got, want,
                            atol=1e-10 * max(np.abs(want).max(), 1.0))
