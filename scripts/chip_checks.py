"""On-GPU validation suite: scipy/numpy oracles for the estimators and
namesakes beyond chip_smoke.py's phases, compiled for the card at small
sizes (f32 FFT engine parity, the pipeline estimators, the int8-limb DFT,
the hp float64 configs and the scipy namesakes).

Usage, on a machine with an NVIDIA GPU:  python scripts/chip_checks.py
(also run by ``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``).

Prints one PASS/FAIL line per check; exits nonzero on failure or when
JAX finds no GPU.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np

import jax
import jax.numpy as jnp


def run_checks() -> int:
    """Run every check, printing one line each; returns the failures."""
    import xrft_tpu
    from xrft_tpu import LabeledArray
    from xrft_tpu.ops import fft_core
    from xrft_tpu.ops.carray import to_numpy
    from xrft_tpu.ops.df64_fft import df64_to_numpy

    failures = 0

    def check(name, value, bound):
        nonlocal failures
        ok = value <= bound
        failures += 0 if ok else 1
        print(f"{'PASS' if ok else 'FAIL'} {name}: {value:.3e} "
              f"(bound {bound:.0e})")

    print(f"backend: {jax.default_backend()}")
    rng = np.random.RandomState(0)

    # 1. f32 engine: 2-D FFT parity
    x = rng.randn(4, 1024, 1024).astype(np.float32)
    got = to_numpy(jax.jit(lambda a: fft_core.fftn(a, [1, 2]))(jnp.asarray(x)))
    ref = np.fft.fftn(x[0].astype(np.float64), axes=[0, 1])
    check("f32 engine 2-D fftn rel err",
          np.abs(got[0] - ref).max() / np.abs(ref).max(), 1e-6)

    # 2. int8-limb DFT (exact integer dots), the emulated hp engine
    from xrft_tpu.ops.int8_dft import int8_dft_last

    x8 = rng.randn(16, 1024).astype(np.float32)
    got = df64_to_numpy(jax.jit(lambda a: int8_dft_last(a, -1))(x8))
    ref = np.fft.fft(x8.astype(np.float64), axis=-1)
    check("int8-limb DFT rel err",
          np.abs(got - ref).max() / np.abs(ref).max(), 1e-10)

    # 3. fft64 public API: Parseval at 1e-12
    Nx = 512
    dx = 0.37
    xs = dx * (np.arange(Nx) - 100)
    sig = rng.randn(Nx).astype(np.float32)
    da = LabeledArray(sig, dims=["x"], coords={"x": xs})
    F = xrft_tpu.fft64(da, dim="x")
    lhs = (np.abs(F.values) ** 2).sum() * F["freq_x"].attrs["spacing"]
    rhs = (np.abs(sig.astype(np.float64)) ** 2).sum() * dx
    check("fft64 Parseval rel err", abs(lhs - rhs) / rhs, 1e-12)

    # 4. full pipeline: windowed+detrended PSD vs host oracle
    N = 512
    da2 = LabeledArray(rng.rand(N, N).astype(np.float32), dims=["y", "x"],
                       coords={"y": np.arange(N) * 0.5,
                               "x": np.arange(N) * 0.5})
    ps = xrft_tpu.power_spectrum(da2, window="hann", detrend="linear")
    import scipy.signal as sps
    from xrft_tpu.detrend import detrend as _dt
    v = da2.values.astype(np.float64)
    vp = _dt(LabeledArray(v, dims=["y", "x"], coords=da2.coords),
             ["y", "x"], "linear").values
    w = sps.windows.hann(N, sym=False)
    Fo = np.fft.fftshift(np.fft.fftn(vp * (w * w[:, None]))) * 0.25
    refps = np.abs(Fo) ** 2 * (1 / (N * 0.5)) ** 2
    check("pipeline PSD rel err",
          np.abs(ps.values - refps).max() / refps.max(), 1e-5)

    # 4a. user-requested one-sided PSD (real_dim=) — the fused raw-layout
    # route with the doubling folded into |F|^2 and the direct-prune
    # plan, and the segmented (Welch) variant — vs the host oracle
    ps1 = xrft_tpu.power_spectrum(da2, dim=["y", "x"], real_dim="x",
                                  window="hann", detrend="linear")
    M = N // 2 + 1
    Fo1 = np.fft.rfftn(vp * (w * w[:, None]), axes=(0, 1)) * 0.25
    dbl = np.full(M, 2.0)
    dbl[0] = dbl[-1] = 1.0
    refps1 = np.abs(Fo1) ** 2 * dbl[None, :] * (1 / (N * 0.5)) ** 2
    check("one-sided PSD rel err",
          np.abs(ps1.values - refps1).max() / refps1.max(), 1e-5)

    S = N // 2
    daw = da2.chunk({"y": S, "x": S})
    psw = xrft_tpu.power_spectrum(daw, dim=["y", "x"], window="hann",
                                  chunks_to_segments=True)
    ws = sps.windows.hann(S, sym=False)
    err_w = 0.0
    for i in range(2):
        for j in range(2):
            seg = v[i * S:(i + 1) * S, j * S:(j + 1) * S]
            Fs = np.fft.fftshift(np.fft.fftn(seg * (ws * ws[:, None]))) \
                * 0.25
            refs = np.abs(Fs) ** 2 * (1 / (S * 0.5)) ** 2
            err_w = max(err_w, np.abs(
                np.asarray(psw.values)[i, :, j, :] - refs).max()
                / refs.max())
    check("welch segmented PSD rel err", err_w, 1e-5)

    # 4a2. overlapping Welch segments (segment_overlap; strided slice-stack
    # HLOs) vs scipy.signal.welch, and coherence vs scipy.signal.coherence —
    # the estimator surfaces compiled for the card
    pso = xrft_tpu.power_spectrum(
        daw, dim=["x"], real_dim="x", window="hann",
        chunks_to_segments=True, segment_overlap=S // 2,
        window_correction=True).mean("x_segment")
    f_o, p_o = sps.welch(v, fs=2.0, window="hann", nperseg=S,
                         noverlap=S // 2, detrend=False, axis=-1)
    check("overlap Welch PSD vs scipy rel err",
          np.abs(np.asarray(pso.values) - p_o).max() / p_o.max(), 1e-5)

    ca = LabeledArray(v[0].astype(np.float32), dims=["x"],
                      coords={"x": np.arange(N) * 0.5}).chunk({"x": S})
    cb = LabeledArray((0.5 * v[0] + 0.5 * v[1]).astype(np.float32),
                      dims=["x"], coords={"x": np.arange(N) * 0.5},
                      ).chunk({"x": S})
    coh = xrft_tpu.coherence(ca, cb, dim="x", real_dim="x",
                             chunks_to_segments=True,
                             segment_overlap=S // 2)
    _, c_o = sps.coherence(np.asarray(ca.values), np.asarray(cb.values),
                           fs=2.0, window="hann", nperseg=S,
                           noverlap=S // 2, detrend=False)
    check("coherence vs scipy abs err",
          np.abs(np.asarray(coh.values) - c_o).max(), 1e-4)

    # 4a5. welch / csd namesakes vs scipy (round 4), incl. the hp
    # compensated segment mean
    n_w, seg_w = 1280, 128
    t_w = np.arange(n_w) / 500.0
    x_w = (np.sin(2 * np.pi * 60 * t_w)
           + 0.4 * rng.randn(n_w)).astype(np.float32)
    y_w = (np.sin(2 * np.pi * 60 * t_w + 0.7)
           + 0.4 * rng.randn(n_w)).astype(np.float32)
    dw1 = LabeledArray(x_w, dims=["t"], coords={"t": t_w}, name="u")
    dw2 = LabeledArray(y_w, dims=["t"], coords={"t": t_w}, name="v")
    w_got = xrft_tpu.welch(dw1, dim="t", seglen=seg_w)
    _, p_w = sps.welch(x_w.astype(np.float64), fs=500.0, window="hann",
                       nperseg=seg_w, noverlap=seg_w // 2,
                       detrend="constant")
    check("welch vs scipy rel err",
          np.abs(np.asarray(w_got.values) - p_w).max() / p_w.max(), 1e-5)
    c_got = xrft_tpu.csd(dw1, dw2, dim="t", seglen=seg_w)
    _, p_c = sps.csd(x_w.astype(np.float64), y_w.astype(np.float64),
                     fs=500.0, window="hann", nperseg=seg_w,
                     noverlap=seg_w // 2, detrend="constant")
    check("csd vs scipy rel err",
          np.abs(np.asarray(c_got.values) - p_c).max()
          / np.abs(p_c).max(), 1e-5)
    wh_got = xrft_tpu.welch(dw1, dim="t", seglen=seg_w, segment_overlap=0,
                            engine="hp")
    _, p_h = sps.welch(x_w.astype(np.float64), fs=500.0, window="hann",
                       nperseg=seg_w, noverlap=0, detrend="constant")
    check("welch hp (compensated mean) vs scipy rel err",
          np.abs(np.asarray(wh_got.values) - p_h).max() / p_h.max(),
          1e-10)

    # 4a4. spectrogram vs scipy.signal.spectrogram on a >=1024-segment
    # workload (the CPU oracle is tests/test_spectra.py, the time is
    # bench.py spectrogram_flagship_ms)
    fs_sg, seg_sg = 1000.0, 256
    hop_sg = seg_sg - seg_sg // 8
    n_sg = 1024 * hop_sg + seg_sg  # exactly 1025 segments at scipy hop
    t_sg = np.arange(n_sg) / fs_sg
    x_sg = (np.sin(2 * np.pi * 50 * t_sg)
            + 0.2 * rng.randn(n_sg)).astype(np.float32)
    da_sg = LabeledArray(x_sg, dims=["t"], coords={"t": t_sg}, name="u")
    sg = xrft_tpu.spectrogram(da_sg, dim="t", seglen=seg_sg,
                              window="hann", detrend="constant")
    f_sg, tt_sg, s_sg = sps.spectrogram(
        x_sg.astype(np.float64), fs=fs_sg, window="hann", nperseg=seg_sg,
        detrend="constant", scaling="density", mode="psd")
    assert sg.sizes["t_segment"] == tt_sg.size >= 1024, sg.sizes
    check("spectrogram vs scipy rel err",
          np.abs(np.asarray(sg.values).T - s_sg).max() / s_sg.max(), 1e-5)
    check("spectrogram segment centers max err",
          np.abs(np.asarray(sg["t_segment"].values) - tt_sg).max(), 1e-9)

    # 4a6. stft / istft (round 4): forward vs scipy.signal.stft and the
    # NOLA-normalized overlap-add inverse round trip, compiled on the
    # card (CPU oracle: tests/test_stft.py)
    fs_st, seg_st, n_st = 10.0, 64, 300
    x_st = (np.sin(2 * np.pi * 1.3 * np.arange(n_st) / fs_st)
            + 0.5 * rng.randn(n_st)).astype(np.float32)
    da_st = LabeledArray(x_st, dims=["t"],
                         coords={"t": np.arange(n_st) / fs_st}, name="u")
    Z_st = xrft_tpu.stft(da_st, dim="t", seglen=seg_st)
    _, _, Z_ref = sps.stft(x_st.astype(np.float64), fs=fs_st,
                           nperseg=seg_st)
    check("stft vs scipy rel err",
          np.abs(np.asarray(Z_st.values) - Z_ref.T).max()
          / np.abs(Z_ref).max(), 1e-6)
    back_st = xrft_tpu.istft(Z_st)
    check("istft roundtrip abs err",
          np.abs(np.asarray(back_st.values) - x_st).max(), 1e-5)

    # 4a3. 3-D spherical-shell isotropize conservation
    N3d = 64
    d3d = LabeledArray(rng.randn(N3d, N3d, N3d).astype(np.float32),
                       dims=["z", "y", "x"],
                       coords={d: np.arange(N3d) * 1.0
                               for d in ("z", "y", "x")})
    import warnings as _w
    with _w.catch_warnings():
        _w.simplefilter("ignore")
        iso3d = xrft_tpu.isotropic_power_spectrum(
            d3d, dim=["z", "y", "x"], truncate=False)
    ps3d = xrft_tpu.power_spectrum(d3d, dim=["z", "y", "x"])
    t_iso = float(np.asarray(iso3d.values).sum())
    t_ps = float(np.asarray(ps3d.values).sum())
    check("3-D shell isotropize conservation rel err",
          abs(t_iso - t_ps) / abs(t_ps), 1e-4)

    # 4b. large-grid binned sum vs f64 host bincount oracle at 2048^2
    # points, 512 bins (512 scatter-add groups)
    from xrft_tpu.ops import binning

    Nb = 2048
    ky = np.fft.fftfreq(Nb)
    fr = np.sqrt(ky[:, None] ** 2 + ky[None, :] ** 2)
    codes_b, nbins_b = binning.cut_codes(fr, Nb // 4)
    vals_b = rng.randn(Nb * Nb).astype(np.float32)
    got_b = np.asarray(jax.jit(
        lambda v: binning.binned_sum(v, codes_b, nbins_b))(
            jnp.asarray(vals_b)))
    mask_b = codes_b >= 0
    ref_b = np.bincount(codes_b[mask_b],
                        weights=vals_b.astype(np.float64)[mask_b],
                        minlength=nbins_b)
    check("large-grid binned_sum 2048^2 rel err",
          np.abs(got_b - ref_b).max() / np.abs(ref_b).max(), 1e-4)

    # ---- 5. engine='hp': BASELINE configs 1-4 end-to-end at <= 1e-10
    # (BASELINE.md precision contract), native float64 under x64
    with jax.enable_x64(True):
        # config 1: 1-D roundtrip + PSD
        N1 = 512
        t = np.arange(N1) * 0.25
        sig1 = rng.randn(N1).astype(np.float32)
        d1 = LabeledArray(sig1, dims=["t"], coords={"t": t})
        ft = xrft_tpu.fft(d1, dim=["t"], engine="hp")
        back = xrft_tpu.ifft(ft, dim=["freq_t"], engine="hp",
                             lag=[float(t[N1 // 2])])
        check("hp config1 roundtrip abs err",
              np.abs(back.values.real - sig1.astype(np.float64)).max(), 1e-10)
        ps1 = xrft_tpu.power_spectrum(d1, dim=["t"], engine="hp")
        F1 = np.fft.fftshift(np.fft.fft(sig1.astype(np.float64))) * 0.25
        ref1 = np.abs(F1) ** 2 / (N1 * 0.25)
        check("hp config1 PSD rel err",
              np.abs(ps1.values - ref1).max() / ref1.max(), 1e-10)

        # config 2: 2-D linear-detrend + hann windowed PSD (jit-compiled)
        N2 = 256
        d2 = LabeledArray(rng.randn(N2, N2).astype(np.float32), dims=["y", "x"],
                          coords={"y": np.arange(N2) * 0.5,
                                  "x": np.arange(N2) * 0.5})
        ps2 = jax.jit(lambda d: xrft_tpu.power_spectrum(
            d, dim=["y", "x"], window="hann", detrend="linear",
            engine="hp").data)(d2)
        v = np.asarray(d2.values, np.float64)
        i2 = np.arange(N2) - (N2 - 1) / 2
        vm = v - v.mean()
        a1 = (vm * i2[:, None]).sum() / ((i2**2).sum() * N2)
        a2 = (vm * i2[None, :]).sum() / ((i2**2).sum() * N2)
        vd = vm - a1 * i2[:, None] - a2 * i2[None, :]
        Fo2 = np.fft.fftshift(np.fft.fftn(vd * (w2d := np.outer(
            sps.windows.hann(N2, sym=False),
            sps.windows.hann(N2, sym=False))))) * 0.25
        ref2 = np.abs(Fo2) ** 2 * (1 / (N2 * 0.5)) ** 2
        check("hp config2 windowed+detrended PSD rel err",
              np.abs(np.asarray(ps2) - ref2).max() / ref2.max(), 1e-10)

        # config 3: isotropic PSD conservation (compensated bin sums)
        N3 = 512
        d3 = LabeledArray(rng.randn(N3, N3).astype(np.float32), dims=["y", "x"],
                          coords={"y": np.arange(N3) * 1.0,
                                  "x": np.arange(N3) * 1.0})
        ps3 = xrft_tpu.power_spectrum(d3, dim=["y", "x"], engine="hp")
        iso3 = xrft_tpu.isotropic_power_spectrum(d3, dim=["y", "x"],
                                                 truncate=False, engine="hp")
        tot_ps = np.asarray(ps3.values).sum()
        tot_iso = np.asarray(iso3.values).sum()
        check("hp config3 isotropic conservation rel err",
              abs(tot_iso - tot_ps) / abs(tot_ps), 1e-10)

        # config 4: cross_spectrum with rfft over time on (64, 128, 128)
        B4, N4 = 64, 128
        d4a = LabeledArray(rng.randn(B4, N4, N4).astype(np.float32),
                           dims=["time", "y", "x"],
                           coords={"time": np.arange(B4) * 2.0,
                                   "y": np.arange(N4) * 1.0,
                                   "x": np.arange(N4) * 1.0})
        d4b = LabeledArray(rng.randn(B4, N4, N4).astype(np.float32),
                           dims=["time", "y", "x"], coords=d4a.coords)
        cs = xrft_tpu.cross_spectrum(d4a, d4b, dim=["time"], real_dim="time",
                                     engine="hp")
        va, vb = (np.asarray(d.values, np.float64) for d in (d4a, d4b))
        lt = 2.0 * (B4 // 2)
        ftq = np.fft.rfftfreq(B4, 2.0)
        ph = np.exp(-2j * np.pi * ftq * lt)[:, None, None]
        Fa = np.fft.rfft(va, axis=0) * 2.0 * ph
        Fb = np.fft.rfft(vb, axis=0) * 2.0 * ph
        refc = Fa * np.conj(Fb)
        fct = np.full(B4 // 2 + 1, 2.0)
        fct[0] = fct[-1] = 1.0
        refc = refc * fct[:, None, None] / (B4 * 2.0)
        check("hp config4 cross_spectrum rel err",
              np.abs(cs.values - refc).max() / np.abs(refc).max(), 1e-10)

    # analytic signal + periodogram namesake (round-4 additions):
    # scipy oracles
    import scipy.signal as sps

    nh = 4096
    xh = rng.randn(8, nh).astype(np.float32)
    dh = LabeledArray(xh, dims=["z", "t"],
                      coords={"z": np.arange(8) * 1.0,
                              "t": np.arange(nh) * 0.01})
    refh = sps.hilbert(xh.astype(np.float64), axis=-1)
    sc = np.abs(refh).max()
    got = to_numpy(xrft_tpu.hilbert(dh, dim="t").data)
    check("hilbert vs scipy rel err", np.abs(got - refh).max() / sc, 1e-6)
    env = np.asarray(xrft_tpu.envelope(dh, dim="t").values)
    check("envelope vs scipy rel err",
          np.abs(env - np.abs(refh)).max() / sc, 1e-6)
    fp, pp = sps.periodogram(xh, fs=100.0, window="hann", axis=-1)
    gp = np.asarray(xrft_tpu.periodogram(dh, dim="t", window="hann").values)
    check("periodogram vs scipy rel err",
          np.abs(gp - pp).max() / pp.max(), 1e-6)

    # DCT/DST family: every type vs scipy.fft
    import scipy.fft as sfft

    for typ in (1, 2, 3, 4):
        gd = np.asarray(
            xrft_tpu.dct(dh, dim="t", type=typ, norm="ortho").values)
        wd = sfft.dct(xh.astype(np.float64), type=typ, norm="ortho", axis=-1)
        check(f"dct type {typ} vs scipy rel err",
              np.abs(gd - wd).max() / np.abs(wd).max(), 1e-5)
    gs = np.asarray(xrft_tpu.dst(dh, dim="t").values)
    ws = sfft.dst(xh.astype(np.float64), axis=-1)
    check("dst type 2 vs scipy rel err",
          np.abs(gs - ws).max() / np.abs(ws).max(), 1e-5)
    rt = np.asarray(
        xrft_tpu.idct(xrft_tpu.dct(dh, dim="t"), dim="t").values)
    check("dct/idct round-trip rel err",
          np.abs(rt - xh).max() / np.abs(xh).max(), 1e-5)

    # chirp-Z / zoom FFT vs scipy
    # |log w| * max(n,m)^2/2 must stay inside f32's exponent range
    mz, wz, az = 512, (1 - 1e-9) * np.exp(-2j * np.pi / 512), np.exp(0.2j)
    gz = np.asarray(xrft_tpu.czt(dh, dim="t", m=mz, w=wz, a=az).values)
    wantz = sps.czt(xh.astype(np.float64), m=mz, w=wz, a=az, axis=-1)
    check("czt spiral vs scipy rel err",
          np.abs(gz - wantz).max() / np.abs(wantz).max(), 1e-5)
    gzm = np.asarray(
        xrft_tpu.zoom_fft(dh, [5.0, 20.0], m=512, dim="t").values)
    wantm = sps.zoom_fft(xh.astype(np.float64), [5.0, 20.0], m=512,
                         fs=100.0, axis=-1)
    check("zoom_fft vs scipy rel err",
          np.abs(gzm - wantm).max() / np.abs(wantm).max(), 1e-5)

    # Fourier resampling vs scipy (up and down, even/odd, windowed)
    gr = np.asarray(xrft_tpu.resample(dh, 6144, dim="t").values)
    wantr = sps.resample(xh.astype(np.float64), 6144, axis=-1)
    check("resample up 4096->6144 rel err",
          np.abs(gr - wantr).max() / np.abs(wantr).max(), 1e-5)
    grd = np.asarray(
        xrft_tpu.resample(dh, 1000, dim="t", window="hann").values)
    wantrd = sps.resample(xh.astype(np.float64), 1000, window="hann",
                          axis=-1)
    check("resample down windowed rel err",
          np.abs(grd - wantrd).max() / np.abs(wantrd).max(), 1e-5)

    # FFT convolution / correlation vs scipy on a batched workload
    kh = rng.randn(129).astype(np.float32)
    dk = LabeledArray(kh, dims=["t"], coords={"t": np.arange(129) * 0.01})
    gc = np.asarray(xrft_tpu.fftconvolve(dh, dk, dims="t",
                                         mode="same").values)
    wantc = np.stack([sps.fftconvolve(row.astype(np.float64),
                                      kh.astype(np.float64), mode="same")
                      for row in xh])
    check("fftconvolve same rel err",
          np.abs(gc - wantc).max() / np.abs(wantc).max(), 1e-5)
    gx = np.asarray(xrft_tpu.correlate(dh, dk, dims="t",
                                       mode="valid").values)
    wantx = np.stack([sps.correlate(row.astype(np.float64),
                                    kh.astype(np.float64), mode="valid")
                      for row in xh])
    check("correlate valid rel err",
          np.abs(gx - wantx).max() / np.abs(wantx).max(), 1e-5)

    # Generalized Lomb-Scargle (one matmul) vs scipy on an uneven
    # grid, batched where scipy loops
    tun = np.sort(rng.uniform(0.0, 30.0, 1024)).astype(np.float64)
    yun = (np.cos(2.3 * tun) + 0.3 * rng.randn(8, 1024)).astype(np.float32)
    dun = LabeledArray(yun, dims=["z", "t"],
                       coords={"z": np.arange(8) * 1.0, "t": tun})
    wfr = np.linspace(0.2, 6.0, 512)
    gls = np.asarray(xrft_tpu.lombscargle(dun, wfr, dim="t",
                                          floating_mean=True).values)
    wantls = np.stack([sps.lombscargle(tun, row.astype(np.float64), wfr,
                                       floating_mean=True)
                       for row in yun])
    check("lombscargle vs scipy rel err",
          np.abs(gls - wantls).max() / np.abs(wantls).max(), 1e-4)

    # Fast Hankel transform (FFTLog on the engine rfft/irfft) vs scipy
    import scipy.fft as sfft

    rh = np.logspace(-4.0, 2.0, 2048)
    dlnh = float(np.log(rh[1] / rh[0]))
    ah = (rh * np.exp(-(rh ** 2) / 2) * (1 + 0.1 * rng.randn(8, 2048))
          ).astype(np.float32)
    dah = LabeledArray(ah, dims=["z", "r"],
                       coords={"z": np.arange(8) * 1.0, "r": rh})
    gfht = np.asarray(xrft_tpu.fht(dah, mu=0.0, dim="r").values)
    wantfht = sfft.fht(ah.astype(np.float64), dlnh, mu=0.0)
    check("fht vs scipy rel err",
          np.abs(gfht - wantfht).max() / np.abs(wantfht).max(), 1e-5)

    # overlap-add convolution (blocked engine FFT) vs scipy
    goa = np.asarray(xrft_tpu.oaconvolve(dh, dk, dims="t",
                                         mode="same").values)
    wantoa = np.stack([sps.oaconvolve(row.astype(np.float64),
                                      kh.astype(np.float64), mode="same")
                       for row in xh])
    check("oaconvolve same rel err",
          np.abs(goa - wantoa).max() / np.abs(wantoa).max(), 1e-5)

    # polyphase resampling family (upfirdn/resample_poly/decimate) vs scipy
    xp = rng.randn(8, 4096).astype(np.float32)
    dp = LabeledArray(xp, dims=["z", "t"],
                      coords={"z": np.arange(8) * 1.0,
                              "t": np.arange(4096) * 0.25})
    hp_taps = xrft_tpu.firwin(63, 0.35)
    gup = np.asarray(xrft_tpu.upfirdn(hp_taps, dp, 3, 5, dim="t").values)
    wantup = sps.upfirdn(hp_taps, xp.astype(np.float64), 3, 5, axis=-1)
    check("upfirdn 3/5 rel err",
          np.abs(gup - wantup).max() / np.abs(wantup).max(), 1e-5)
    grp = np.asarray(xrft_tpu.resample_poly(dp, 2, 3, dim="t").values)
    wantrp = sps.resample_poly(xp.astype(np.float64), 2, 3, axis=-1)
    check("resample_poly 2/3 rel err",
          np.abs(grp - wantrp).max() / np.abs(wantrp).max(), 1e-5)
    gdec = np.asarray(xrft_tpu.decimate(dp, 4, dim="t").values)
    wantdec = sps.decimate(xp.astype(np.float64), 4, ftype="fir", axis=-1)
    check("decimate q=4 rel err",
          np.abs(gdec - wantdec).max() / np.abs(wantdec).max(), 1e-5)

    # N-D trig + 2-D analytic signal vs scipy
    x2d = rng.randn(4, 512, 512).astype(np.float32)
    d2d = LabeledArray(x2d, dims=["z", "y", "x"])
    gdctn = np.asarray(xrft_tpu.dctn(d2d, dim=["y", "x"],
                                     norm="ortho").values)
    wantdctn = sfft.dctn(x2d.astype(np.float64), norm="ortho",
                         axes=(1, 2))
    check("dctn 512^2 ortho rel err",
          np.abs(gdctn - wantdctn).max() / np.abs(wantdctn).max(), 1e-5)
    gh2 = np.asarray(xrft_tpu.hilbert2(d2d, dim=["y", "x"]).values)
    wanth2 = sps.hilbert2(x2d[0].astype(np.float64))
    check("hilbert2 512^2 rel err",
          np.abs(gh2[0] - wanth2).max() / np.abs(wanth2).max(), 1e-5)

    # Savitzky-Golay smoothing (interp edge matrices as dots) vs scipy
    gsg = np.asarray(xrft_tpu.savgol_filter(dp, 11, 3, deriv=1, delta=0.25,
                                            dim="t").values)
    wantsg = sps.savgol_filter(xp.astype(np.float64), 11, 3, deriv=1,
                               delta=0.25, axis=-1)
    check("savgol_filter w=11 d1 rel err",
          np.abs(gsg - wantsg).max() / np.abs(wantsg).max(), 1e-5)

    return failures


def main():
    if jax.default_backend() != "gpu":
        print(f"chip_checks: no GPU: JAX's default backend is "
              f"{jax.default_backend()!r}; these checks run only on an "
              f"NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    from xrft_tpu.config import enable_compile_cache

    enable_compile_cache(ROOT)
    sys.exit(1 if run_checks() else 0)


if __name__ == "__main__":
    main()
