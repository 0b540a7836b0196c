"""Randomized parity sweep: the full fft kwarg space against an
independent numpy implementation of the reference semantics
(/root/reference/xrft/xrft.py:307-476).  Catches interaction bugs between
flags that the targeted tests don't combine.
"""

import numpy as np
import numpy.testing as npt
import pytest
import scipy.signal as sps

pytestmark = pytest.mark.slow

from xrft_tpu import LabeledArray, fft
from xrft_tpu.config import complex_mode


def numpy_reference_fft(values, coords_list, axes, real_axis, shift,
                        detrend, window, true_phase, true_amplitude):
    """Independent numpy model of the reference's fft semantics."""
    v = np.asarray(values, dtype=np.float64)
    ndim = v.ndim

    delta = []
    lags = []
    flips = []
    for a, c in zip(axes, coords_list):
        d = np.diff(c)
        delta.append(abs(d[0]))
        cc = c if c[-1] > c[0] else c[::-1]
        lags.append(cc[len(cc) // 2])
        if c[-1] < c[0]:
            flips.append(a)

    if detrend == "constant":
        v = v - v.mean(axis=tuple(axes), keepdims=True)
    elif detrend == "linear":
        # orthogonal-regressor hyperplane fit == lstsq on regular grids
        mean = v.mean(axis=tuple(axes), keepdims=True)
        fit = mean
        nel = np.prod([v.shape[a] for a in axes])
        for a in axes:
            n = v.shape[a]
            i = np.arange(n) - (n - 1) / 2
            shp = [1] * ndim
            shp[a] = n
            iv = i.reshape(shp)
            css = (i**2).sum() * (nel / n)
            slope = (v * iv).sum(axis=tuple(axes), keepdims=True) / css
            fit = fit + slope * iv
        v = v - fit

    if window is not None:
        for a in axes:
            w = sps.windows.get_window(window, v.shape[a], fftbins=True)
            shp = [1] * ndim
            shp[a] = v.shape[a]
            v = v * w.reshape(shp)

    if true_phase and flips:
        v = np.flip(v, axis=flips)
    if true_phase:
        v = np.fft.ifftshift(v, axes=axes)

    if real_axis is None:
        F = np.fft.fftn(v, axes=axes)
    else:
        F = np.fft.rfftn(v, axes=axes)
        shift = False
    if shift:
        F = np.fft.fftshift(F, axes=axes)

    for a, d, lag in zip(axes, delta, lags):
        n = values.shape[a]
        if real_axis is not None and a == axes[-1]:
            f = np.fft.rfftfreq(n, d)
        else:
            f = np.fft.fftfreq(n, d)
            if shift:
                f = np.fft.fftshift(f)
        if true_phase:
            shp = [1] * ndim
            shp[a] = f.size
            F = F * np.exp(-2j * np.pi * f * lag).reshape(shp)
    if true_amplitude:
        F = F * np.prod(delta)
    return F


CASES = []
rng = np.random.RandomState(99)
for i in range(24):
    ndim = rng.randint(1, 4)
    shape = tuple(rng.choice([8, 12, 15, 16, 20]) for _ in range(ndim))
    n_t = rng.randint(1, ndim + 1)
    tdims = sorted(rng.choice(ndim, size=n_t, replace=False).tolist())
    CASES.append(dict(
        seed=i,
        shape=shape,
        tdims=tdims,
        real=bool(rng.rand() < 0.3),
        shift=bool(rng.rand() < 0.5),
        detrend=[None, "constant", "linear"][rng.randint(3)],
        window=[None, "hann", "blackman"][rng.randint(3)],
        true_phase=bool(rng.rand() < 0.5),
        true_amplitude=bool(rng.rand() < 0.5),
        decreasing=bool(rng.rand() < 0.3),
        engine=[None, "matmul", "hp"][rng.randint(3)],
    ))

# larger 1-D/2-D cases exercising the stacked engine's multi-level radix
# plans (sizes > direct_dft_max) and the hp four-step composition
for i, shape in enumerate([(384,), (512,), (6, 256), (192, 20)]):
    ndim = len(shape)
    CASES.append(dict(
        seed=100 + i,
        shape=shape,
        tdims=list(range(ndim)),
        real=bool(i % 2),
        shift=bool(i % 2 == 0),
        detrend=[None, "linear"][i % 2],
        window=[None, "hann"][(i + 1) % 2],
        true_phase=True,
        true_amplitude=True,
        decreasing=False,
        engine=["matmul", "hp"][i % 2],
    ))


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"case{c['seed']}")
@pytest.mark.parametrize("mode", ["native", "split"])
def test_fft_fuzz_vs_numpy_reference(case, mode):
    rs = np.random.RandomState(case["seed"])
    shape = case["shape"]
    dims = [f"d{i}" for i in range(len(shape))]
    coords = {}
    coords_list = []
    for i, n in enumerate(shape):
        dx = 0.1 + rs.rand()
        x0 = rs.randn() * 3
        c = x0 + dx * np.arange(n)
        if case["decreasing"] and i in case["tdims"] and rs.rand() < 0.5:
            c = c[::-1].copy()
        coords[dims[i]] = c
        if i in case["tdims"]:
            coords_list.append(c)
    vals = rs.randn(*shape)
    da = LabeledArray(vals, dims=dims, coords=coords)

    tnames = [dims[i] for i in case["tdims"]]
    real_dim = tnames[-1] if case["real"] else None
    axes = list(case["tdims"])

    kwargs = dict(
        dim=tnames, shift=case["shift"], detrend=case["detrend"],
        window=case["window"], true_phase=case["true_phase"],
        true_amplitude=case["true_amplitude"],
    )
    with complex_mode(mode):
        got = fft(da, real_dim=real_dim, engine=case.get("engine"), **kwargs)

    # reference model: real axis moved last like the library does
    if real_dim is not None:
        order = [i for i in range(len(shape)) if i != case["tdims"][-1]] \
            + [case["tdims"][-1]]
        v_ref = np.transpose(vals, order)
        coords_ref = [coords[dims[i]] for i in case["tdims"][:-1]] \
            + [coords[dims[case["tdims"][-1]]]]
        axes_ref = [order.index(i) for i in case["tdims"]]
        F = numpy_reference_fft(v_ref, coords_ref, axes_ref,
                                real_axis=axes_ref[-1],
                                shift=case["shift"], detrend=case["detrend"],
                                window=case["window"],
                                true_phase=case["true_phase"],
                                true_amplitude=case["true_amplitude"])
        inv = np.argsort(order)
        F = np.transpose(F, inv)
    else:
        F = numpy_reference_fft(vals, coords_list, axes, None,
                                case["shift"], case["detrend"],
                                case["window"], case["true_phase"],
                                case["true_amplitude"])

    scale = max(np.abs(F).max(), 1e-12)
    # hp on the CPU test backend: float64 tails at ~1e-11 here (the
    # strict bounds are pinned in tests/test_hp_native.py and on the GPU
    # by chip_smoke.py)
    atol = 2e-10 if case.get("engine") == "hp" else 5e-11
    npt.assert_allclose(got.values / scale, F / scale, atol=atol)


# ---------------------------------------------------------------------------
# Estimator fuzz: power_spectrum / cross_spectrum kwarg space vs an
# independent numpy model (reference /root/reference/xrft/xrft.py:685-835),
# including user-requested one-sided output (real_dim=) which rides the
# fused raw-layout route on engine="matmul"
# ---------------------------------------------------------------------------

EST_CASES = []
_erng = np.random.RandomState(7)
for i in range(16):
    ndim = _erng.randint(2, 4)
    shape = tuple(_erng.choice([8, 12, 15, 16, 20, 24]) for _ in range(ndim))
    n_t = _erng.randint(1, ndim)
    tdims = sorted(_erng.choice(ndim, size=max(n_t, 1),
                                replace=False).tolist())
    EST_CASES.append(dict(
        seed=200 + i,
        shape=shape,
        tdims=tdims,
        cross=bool(_erng.rand() < 0.4),
        one_sided=bool(_erng.rand() < 0.6),
        shift=bool(_erng.rand() < 0.5),
        window=[None, "hann", "blackman"][_erng.randint(3)],
        detrend=[None, "constant", "linear"][_erng.randint(3)],
        scaling=["density", "spectrum", "false_density"][_erng.randint(3)],
        wcorr=bool(_erng.rand() < 0.4),
        true_phase=bool(_erng.rand() < 0.5),
        decreasing=bool(_erng.rand() < 0.25),
        engine=[None, "matmul", "xla"][_erng.randint(3)],
    ))
    if EST_CASES[-1]["window"] is None:
        EST_CASES[-1]["wcorr"] = False  # correction requires a window


@pytest.mark.parametrize("case", EST_CASES, ids=lambda c: f"est{c['seed']}")
def test_estimator_fuzz_vs_numpy_reference(case):
    import warnings

    import xrft_tpu
    from xrft_tpu.ops import carray

    rs = np.random.RandomState(case["seed"])
    shape = case["shape"]
    ndim = len(shape)
    dims = [f"d{i}" for i in range(ndim)]
    coords = {}
    for i, n in enumerate(shape):
        dx = 0.1 + rs.rand()
        c = rs.randn() * 2 + dx * np.arange(n)
        if case["decreasing"] and i in case["tdims"] and rs.rand() < 0.5:
            c = c[::-1].copy()
        coords[dims[i]] = c
    vals1 = rs.randn(*shape)
    vals2 = rs.randn(*shape)
    da1 = LabeledArray(vals1, dims=dims, coords=coords)
    da2 = LabeledArray(vals2, dims=dims, coords=coords)

    tnames = [dims[i] for i in case["tdims"]]
    real_i = case["tdims"][-1] if case["one_sided"] else None
    real_dim = dims[real_i] if real_i is not None else None

    kw = dict(dim=tnames, shift=case["shift"], window=case["window"],
              detrend=case["detrend"], scaling=case["scaling"],
              window_correction=case["wcorr"], engine=case["engine"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if case["cross"]:
            got = xrft_tpu.cross_spectrum(da1, da2, real_dim=real_dim,
                                          true_phase=case["true_phase"],
                                          **kw)
            gv = carray.to_numpy(got.data)
        else:
            got = xrft_tpu.power_spectrum(da1, real_dim=real_dim, **kw)
            gv = np.asarray(got.values)

    # ---- independent numpy model
    def model_F(vals, tp):
        if real_dim is not None:
            order = [i for i in range(ndim) if i != real_i] + [real_i]
            v_ref = np.transpose(vals, order)
            coords_ref = [coords[dims[i]] for i in case["tdims"][:-1]] \
                + [coords[dims[real_i]]]
            axes_ref = [order.index(i) for i in case["tdims"]]
            F = numpy_reference_fft(v_ref, coords_ref, axes_ref,
                                    real_axis=axes_ref[-1],
                                    shift=case["shift"],
                                    detrend=case["detrend"],
                                    window=case["window"], true_phase=tp,
                                    true_amplitude=True)
            return np.transpose(F, np.argsort(order))
        coords_list = [coords[dims[i]] for i in case["tdims"]]
        return numpy_reference_fft(vals, coords_list, list(case["tdims"]),
                                   None, case["shift"], case["detrend"],
                                   case["window"], tp, True)

    if case["cross"]:
        F1 = model_F(vals1, case["true_phase"])
        F2 = model_F(vals2, case["true_phase"])
        ref = F1 * np.conj(F2)
    else:
        ref = np.abs(model_F(vals1, False)) ** 2

    if real_dim is not None:
        n = shape[real_i]
        dbl = np.full(n // 2 + 1, 2.0)
        dbl[0] = 1.0
        if n % 2 == 0:
            dbl[-1] = 1.0
        shp = [1] * ndim
        shp[real_i] = dbl.size
        ref = ref * dbl.reshape(shp)

    if case["scaling"] != "false_density":
        fs = 1.0
        for i in case["tdims"]:
            c = coords[dims[i]]
            fs *= 1.0 / (shape[i] * abs(np.diff(c)[0]))
        wcf = 1.0
        if case["wcorr"]:
            wcf = 1.0
            for i in case["tdims"]:
                w = sps.windows.get_window(case["window"], shape[i],
                                           fftbins=True)
                wcf *= ((w**2).mean() if case["scaling"] == "density"
                        else w.mean() ** 2)
        ref = ref / wcf * (fs if case["scaling"] == "density" else fs**2)

    scale = max(np.abs(ref).max(), 1e-12)
    npt.assert_allclose(gv / scale, ref / scale, atol=1e-10)


# ---------------------------------------------------------------------------
# Segmented-estimator fuzz: chunks_to_segments (+ random segment_overlap)
# against a per-segment numpy loop — pins the Welch stacking machinery
# (strided slice-stack, first-window coords) across flag combinations
# ---------------------------------------------------------------------------

SEG_CASES = []
_srng = np.random.RandomState(17)
for i in range(10):
    ndim = _srng.randint(2, 4)
    shape = list(_srng.choice([8, 12, 16, 20], size=ndim))
    n_t = _srng.randint(1, ndim)
    tdims = sorted(_srng.choice(ndim, size=max(n_t, 1),
                                replace=False).tolist())
    seg_i = tdims[_srng.randint(len(tdims))]
    seglen = int(_srng.choice([12, 16, 20]))
    overlap = int(_srng.choice([0, seglen // 4, seglen // 2]))
    # overlap == 0 keeps the reference's exact-divisibility contract;
    # overlapped cases may leave a dropped tail (scipy convention)
    shape[seg_i] = seglen * int(_srng.randint(3, 5)) + (
        int(_srng.randint(0, seglen - overlap)) if overlap else 0)
    SEG_CASES.append(dict(
        seed=400 + i,
        shape=tuple(shape),
        tdims=tdims,
        seg_i=seg_i,
        seglen=seglen,
        overlap=overlap,
        cross=bool(_srng.rand() < 0.4),
        one_sided=bool(_srng.rand() < 0.5),
        window=[None, "hann"][_srng.randint(2)],
        detrend=[None, "constant", "linear"][_srng.randint(3)],
        scaling=["density", "spectrum"][_srng.randint(2)],
        engine=[None, "matmul"][_srng.randint(2)],
    ))


@pytest.mark.parametrize("case", SEG_CASES, ids=lambda c: f"seg{c['seed']}")
def test_segmented_estimator_fuzz_vs_per_segment_loop(case):
    import warnings

    import xrft_tpu
    from xrft_tpu.ops import carray

    rs = np.random.RandomState(case["seed"])
    shape = case["shape"]
    ndim = len(shape)
    dims = [f"d{i}" for i in range(ndim)]
    coords = {dims[i]: rs.randn() + (0.1 + rs.rand()) * np.arange(n)
              for i, n in enumerate(shape)}
    vals1, vals2 = rs.randn(*shape), rs.randn(*shape)
    seg_i, L, o = case["seg_i"], case["seglen"], case["overlap"]
    hop = L - o
    da1 = LabeledArray(vals1, dims=dims,
                       coords=coords).chunk({dims[seg_i]: L})
    da2 = LabeledArray(vals2, dims=dims,
                       coords=coords).chunk({dims[seg_i]: L})

    tnames = [dims[i] for i in case["tdims"]]
    real_i = case["tdims"][-1] if case["one_sided"] else None
    real_dim = dims[real_i] if real_i is not None else None
    kw = dict(dim=tnames, window=case["window"], detrend=case["detrend"],
              scaling=case["scaling"], engine=case["engine"], shift=False,
              chunks_to_segments=True, segment_overlap=o or None)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if case["cross"]:
            got = xrft_tpu.cross_spectrum(da1, da2, real_dim=real_dim,
                                          true_phase=False, **kw)
            gv = carray.to_numpy(got.data)
        else:
            got = xrft_tpu.power_spectrum(da1, real_dim=real_dim, **kw)
            gv = np.asarray(got.values)
    # other (unchunked) transform dims gain size-1 segment axes (reference
    # semantics); squeeze them out for the per-segment model comparison
    drop = tuple(got.dims.index(d + "_segment") for d in tnames
                 if d != dims[seg_i] and (d + "_segment") in got.dims)
    if drop:
        gv = np.squeeze(gv, axis=drop)
    outdims = [dd for dd in got.dims
               if dd == dims[seg_i] + "_segment"
               or not dd.endswith("_segment")]
    seg_ax = outdims.index(dims[seg_i] + "_segment")
    nseg = (shape[seg_i] - L) // hop + 1
    assert gv.shape[seg_ax] == nseg

    # per-segment numpy loop: slice the segmented axis, run the unsegmented
    # estimator model on each window with the FIRST window's coordinates
    # (the stacked coord convention), stack along the segment axis
    seg_coords = dict(coords)
    seg_coords[dims[seg_i]] = coords[dims[seg_i]][:L]

    def est_one(v1, v2):
        coords_list = [seg_coords[dims[i]] for i in case["tdims"]]
        if real_dim is not None:
            order = [i for i in range(ndim) if i != real_i] + [real_i]
            axes_ref = [order.index(i) for i in case["tdims"]]
            F1 = numpy_reference_fft(
                np.transpose(v1, order),
                [seg_coords[dims[i]] for i in case["tdims"][:-1]]
                + [seg_coords[dims[real_i]]],
                axes_ref, real_axis=axes_ref[-1], shift=False,
                detrend=case["detrend"], window=case["window"],
                true_phase=False, true_amplitude=True)
            F1 = np.transpose(F1, np.argsort(order))
            if v2 is not None:
                F2 = numpy_reference_fft(
                    np.transpose(v2, order),
                    [seg_coords[dims[i]] for i in case["tdims"][:-1]]
                    + [seg_coords[dims[real_i]]],
                    axes_ref, real_axis=axes_ref[-1], shift=False,
                    detrend=case["detrend"], window=case["window"],
                    true_phase=False, true_amplitude=True)
                F2 = np.transpose(F2, np.argsort(order))
        else:
            F1 = numpy_reference_fft(v1, coords_list, list(case["tdims"]),
                                     None, False, case["detrend"],
                                     case["window"], False, True)
            if v2 is not None:
                F2 = numpy_reference_fft(v2, coords_list,
                                         list(case["tdims"]), None, False,
                                         case["detrend"], case["window"],
                                         False, True)
        ref = F1 * np.conj(F2) if v2 is not None else np.abs(F1) ** 2
        if real_dim is not None:
            n = L if real_i == seg_i else shape[real_i]
            dbl = np.full(n // 2 + 1, 2.0)
            dbl[0] = 1.0
            if n % 2 == 0:
                dbl[-1] = 1.0
            shp = [1] * ndim
            shp[real_i] = dbl.size
            ref = ref * dbl.reshape(shp)
        fs = 1.0
        for i in case["tdims"]:
            n = L if i == seg_i else shape[i]
            fs *= 1.0 / (n * abs(np.diff(coords[dims[i]])[0]))
        return ref * (fs if case["scaling"] == "density" else fs**2)

    refs = []
    for s in range(nseg):
        sl = [slice(None)] * ndim
        sl[seg_i] = slice(s * hop, s * hop + L)
        refs.append(est_one(vals1[tuple(sl)],
                            vals2[tuple(sl)] if case["cross"] else None))
    ref = np.stack(refs, axis=seg_i)  # segment axis sits where seg dim was
    # library output dims: segment axis directly before the within-seg dim
    assert seg_ax == outdims.index("freq_" + dims[seg_i]) - 1

    scale = max(np.abs(ref).max(), 1e-12)
    npt.assert_allclose(gv / scale, ref / scale, atol=1e-10)


# ---------------------------------------------------------------------------
# Inverse roundtrip fuzz: ifft(fft(s)) == s across random shapes (incl.
# n % 4 == 2 real axes), engines, real/complex kinds, shift flags and
# natural vs shifted freq orders — pins the absorbed-shift inverse paths
# (reference roundtrips /root/reference/xrft/tests/test_xrft.py:1253-1300)
# ---------------------------------------------------------------------------

RT_CASES = []
_rrng = np.random.RandomState(31)
for i in range(14):
    ndim = _rrng.randint(1, 4)
    shape = tuple(_rrng.choice([8, 10, 12, 15, 16, 18, 22]) for _ in range(ndim))
    n_t = _rrng.randint(1, ndim + 1)
    tdims = sorted(_rrng.choice(ndim, size=n_t, replace=False).tolist())
    RT_CASES.append(dict(
        seed=300 + i,
        shape=shape,
        tdims=tdims,
        real=bool(_rrng.rand() < 0.5),
        shift=bool(_rrng.rand() < 0.5),
        engine=[None, "matmul", "xla"][_rrng.randint(3)],
    ))


@pytest.mark.parametrize("case", RT_CASES, ids=lambda c: f"rt{c['seed']}")
def test_roundtrip_fuzz(case):
    import warnings

    import xrft_tpu

    rs = np.random.RandomState(case["seed"])
    shape = case["shape"]
    ndim = len(shape)
    dims = [f"d{i}" for i in range(ndim)]
    coords = {dims[i]: rs.randn() + (0.1 + rs.rand()) * np.arange(n)
              for i, n in enumerate(shape)}
    vals = rs.randn(*shape)
    da = LabeledArray(vals, dims=dims, coords=coords)
    tnames = [dims[i] for i in case["tdims"]]
    real_dim = tnames[-1] if case["real"] else None

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        F = xrft_tpu.fft(da, dim=tnames, real_dim=real_dim,
                         true_phase=True, true_amplitude=True,
                         shift=case["shift"], engine=case["engine"])
        lags = [F.coords[f"freq_{d}"].attrs["direct_lag"] for d in tnames]
        back = xrft_tpu.ifft(
            F, dim=[f"freq_{d}" for d in tnames],
            real_dim=f"freq_{real_dim}" if real_dim else None,
            true_phase=True, true_amplitude=True, lag=lags,
            engine=case["engine"])
    got = np.asarray(back.values)
    if np.iscomplexobj(got):
        got = got.real
    npt.assert_allclose(got, vals, atol=1e-9)
    for d in tnames:
        npt.assert_allclose(back.coords[d].values, coords[d], atol=1e-9)
