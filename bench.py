"""Benchmark: end-to-end windowed power spectral density.

Workload: the north-star configuration family (BASELINE.md) — a 4096x4096
windowed, detrended 2-D power_spectrum over a batch of fields, as one
jit-compiled program on the default backend.  The reference publishes no
timings (BASELINE.md), so ``vs_baseline`` is the speedup over the same
computation executed by the numpy/pocketfft stack the reference delegates
to, measured on this host.

Timing methodology: the per-iteration device time is measured by
differencing two chained on-device loops, (t[k=K] - t[k=1]) / (K - 1),
each forced by a scalar transfer.  Iterations are serially data-dependent
(the input is perturbed by a tiny function of the previous output) so XLA
cannot CSE them away.  The hp (float64-grade) cells run under
``jax.enable_x64()``, where engine='hp' is native float64.

Prints exactly one JSON line, which names the device:
  {"metric": ..., "value": <ms/iter>, "unit": "ms", "vs_baseline": <x>,
   "device": {"platform", "kind", "count"}, ...}
"""

import json
import os
import time

import numpy as np

# XRFT_BENCH_SMOKE=1 shrinks every workload so the full script executes
# in seconds on CPU — validates the bench code path itself (imports,
# metric plumbing, JSON emission) without a GPU. Timing values are
# meaningless in smoke mode.
_SMOKE = bool(os.environ.get("XRFT_BENCH_SMOKE"))


def _pipeline_loop(da, iters):
    import jax
    import jax.numpy as jnp

    import xrft_tpu

    def one(d):
        return jnp.sum(xrft_tpu.power_spectrum(
            d, dim=["y", "x"], window="hann", detrend="linear"
        ).data)

    def body(_, carry):
        s, x = carry
        s2 = one(da.copy(data=x))
        # serial dependency: perturb the input by ~1e-38*s2 (never CSEd,
        # numerically invisible)
        return s + s2, x + s2 * 1e-38

    def run(x):
        s, _ = jax.lax.fori_loop(0, iters, body, (jnp.float32(0.0), x))
        return s

    return jax.jit(run)


def main():
    # global watchdog: a hung compile/dispatch must not lose the whole
    # artifact — a deadline plus the error-JSON fallback below guarantees
    # one parseable line.
    import signal

    class _BenchDeadline(BaseException):
        # BaseException so the per-metric _bench guard (which catches
        # Exception) cannot swallow the one-shot alarm
        pass

    def _deadline(signum, frame):
        raise _BenchDeadline("bench global deadline reached")

    try:
        signal.signal(signal.SIGALRM, _deadline)
        signal.alarm(int(os.environ.get("XRFT_BENCH_DEADLINE_S", "2400")))
    except Exception:
        pass
    try:
        _run()
    except BaseException as e:
        print(json.dumps({
            "metric": "bench failed before the flagship completed",
            "value": -1.0,
            "unit": "ms",
            "vs_baseline": 0.0,
            "error": f"{type(e).__name__}: {e}"[:200],
        }))
    finally:
        try:
            signal.alarm(0)
        except Exception:
            pass


def _run():
    import jax
    import scipy.signal as sps

    import xrft_tpu
    from xrft_tpu import LabeledArray
    from xrft_tpu.config import enable_compile_cache

    enable_compile_cache(os.path.dirname(os.path.abspath(__file__)))
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}

    B, N = (2, 256) if _SMOKE else (8, 4096)
    rng = np.random.RandomState(0)
    data = rng.randn(B, N, N).astype(np.float32)
    da = LabeledArray(
        data,
        dims=("time", "y", "x"),
        coords={"y": np.arange(N) * 0.5, "x": np.arange(N) * 0.5},
    )
    x0 = da.data  # device-resident

    K = 9
    f1 = _pipeline_loop(da, 1)
    fk = _pipeline_loop(da, K)
    float(f1(x0))  # compile
    float(fk(x0))

    def _wall(f, *a):
        t0 = time.perf_counter()
        float(f(*a))  # scalar transfer forces full execution
        return (time.perf_counter() - t0) * 1e3

    # variance control: the flagship number is the min over >=3
    # INDEPENDENT chained-loop estimates, and the artifact records the
    # spread.
    t1 = min(_wall(f1, x0) for _ in range(4))
    ests = [max((_wall(fk, x0) - t1) / (K - 1), 1e-3) for _ in range(4)]
    device_ms = min(ests)
    spread_ms = max(ests) - min(ests)
    call_ms = t1

    # numpy/pocketfft baseline: same math, one 4096^2 slice, scaled to B;
    # min of 3 runs to suppress host-load noise
    v = data[0].astype(np.float64)
    i = np.arange(N) - (N - 1) / 2
    w = sps.windows.hann(N, sym=False)

    def np_pipeline():
        vm = v - v.mean()
        sy = (vm * i[:, None]).sum(axis=0) / (i**2).sum()
        sx = (vm * i[None, :]).sum(axis=1) / (i**2).sum()
        vd = vm - i[:, None] * sy[None, :] - sx[:, None] * i[None, :]
        F = np.fft.fftshift(np.fft.fftn(vd * (w * w[:, None]))) * 0.25
        return (np.abs(F) ** 2) * (1.0 / (N * 0.5)) ** 2

    best = np.inf
    for _ in range(3):
        t2 = time.perf_counter()
        np_pipeline()
        best = min(best, time.perf_counter() - t2)
    np_ms = best * 1e3 * B

    # bytes the compiled program accesses (XLA cost analysis)
    def one_fn(d):
        return xrft_tpu.power_spectrum(
            d, dim=["y", "x"], window="hann", detrend="linear").data

    bytes_accessed = None
    try:
        c = jax.jit(one_fn).lower(da).compile()
        ca = c.cost_analysis()
        ca = ca[0] if isinstance(ca, list) else ca
        bytes_accessed = float(ca.get("bytes accessed", 0.0))
    except Exception:
        pass

    extras = {
        "call_ms": round(call_ms, 2),
        "value_spread_ms": round(spread_ms, 2),
    }
    if bytes_accessed:
        extras["bytes_accessed_gb"] = round(bytes_accessed / 1e9, 2)

    def _bench(key, fn):
        # a failure in one secondary metric must not lose the whole
        # artifact: degrade to an error field, keep going
        try:
            extras[key] = fn()
        except Exception as e:
            extras[key + "_error"] = f"{type(e).__name__}: {e}"[:120]

    # ---- BASELINE configs 3 & 4 timings.  Each runs as ONE on-device
    # fori_loop of K serially-dependent iterations:
    # value = (t_loop - t_null) / K.  One compile per config keeps total
    # bench compile time bounded.
    import jax.numpy as jnp

    null_f = jax.jit(lambda v: jnp.sum(v[0, :8]))
    nx = jnp.zeros((8, 64), np.float32)
    float(null_f(nx))
    t_null = min(_wall(null_f, nx) for _ in range(5))

    # heavier workloads pass a smaller k so the bench stays fast
    KC = 4 if _SMOKE else 64

    def loop_per_iter(step, x_init, k=None, reps=4):
        k = KC if k is None else k

        def body(_, carry):
            s, xx = carry
            s2 = step(xx)
            # casts keep the carry's dtypes when an hp step returns f64
            return (s + s2.astype(s.dtype),
                    xx + (s2 * 1e-38).astype(xx.dtype))

        def run(xx):
            s, _ = jax.lax.fori_loop(0, k, body, (jnp.float32(0.0), xx))
            return s

        g = jax.jit(run)
        float(g(x_init))
        t = min(_wall(g, x_init) for _ in range(reps))
        return max((t - t_null) / k, 0.0)

    # config 3: isotropic power spectrum, 512^2 (BASELINE config 3's size)
    N3 = 128 if _SMOKE else 512
    da3 = LabeledArray(rng.randn(N3, N3).astype(np.float32),
                       dims=("y", "x"),
                       coords={"y": np.arange(N3) * 1.0,
                               "x": np.arange(N3) * 1.0})
    def step3(xx):
        return jnp.sum(xrft_tpu.isotropic_power_spectrum(
            da3.copy(data=xx), dim=["y", "x"], truncate=True).data)

    _bench("config3_iso_ps_512_ms",
           lambda: round(loop_per_iter(step3, da3.data), 2))

    # config 3 at 2048^2: the large-grid regime
    N3b = 256 if _SMOKE else 2048
    da3b = LabeledArray(rng.randn(N3b, N3b).astype(np.float32),
                        dims=("y", "x"),
                        coords={"y": np.arange(N3b) * 1.0,
                                "x": np.arange(N3b) * 1.0})

    def step3b(xx):
        return jnp.sum(xrft_tpu.isotropic_power_spectrum(
            da3b.copy(data=xx), dim=["y", "x"], truncate=True).data)

    _bench("config3_iso_ps_2048_ms",
           lambda: round(loop_per_iter(step3b, da3b.data), 2))

    # config 4: cross_spectrum, rfft over time, 64x512x512
    B4, N4 = (8, 64) if _SMOKE else (64, 512)
    da4a = LabeledArray(rng.randn(B4, N4, N4).astype(np.float32),
                        dims=("time", "y", "x"),
                        coords={"time": np.arange(B4) * 1.0,
                                "y": np.arange(N4) * 1.0,
                                "x": np.arange(N4) * 1.0})
    da4b = da4a.copy(data=jnp.asarray(
        rng.randn(B4, N4, N4).astype(np.float32)))

    def step4(xx):
        from xrft_tpu.ops import carray as _c

        cs = xrft_tpu.cross_spectrum(da4a.copy(data=xx), da4b,
                                     dim=["time"], real_dim="time")
        return jnp.sum(_c.real(cs.data))

    _bench("config4_cross_spectrum_64x512x512_ms",
           lambda: round(loop_per_iter(step4, da4a.data), 2))

    # engine="hp": the float64-grade jit pipeline (config-2 shape; the
    # precision contract itself is pinned in scripts/chip_checks.py),
    # native float64 under x64
    N5 = 64 if _SMOKE else 256
    da5 = LabeledArray(rng.randn(N5, N5).astype(np.float32),
                       dims=("y", "x"),
                       coords={"y": np.arange(N5) * 1.0,
                               "x": np.arange(N5) * 1.0})

    def step5(xx):
        ps = xrft_tpu.power_spectrum(da5.copy(data=xx), dim=["y", "x"],
                                     window="hann", detrend="linear",
                                     engine="hp")
        return jnp.sum(ps.data.hi)

    _bench("hp_psd_256_ms", lambda: round(_x64(
        lambda: loop_per_iter(step5, da5.data)), 2))

    # inverse flagship: irfft2 8x4096x(2049->4096).  The spectrum values
    # are arbitrary for timing (irfftn consumes the half grid as-is); the
    # imaginary plane derives from the loop-carried real plane so both
    # stay serially data-dependent without a second 268 MB carry.
    from xrft_tpu.ops import carray as _car

    # freq_y pre-sorted (fftshift order = the forward flagship's shift=True
    # output): ifft's sortby is then a no-op and the input ifftshift is
    # absorbed into the engine weights — no gather pass
    ftc = {"freq_y": np.fft.fftshift(np.fft.fftfreq(N, 0.5)),
           "freq_x": np.fft.rfftfreq(N, 0.5)}
    half = LabeledArray(
        jnp.zeros((B, N, N // 2 + 1), np.float32),  # placeholder struct
        dims=("time", "freq_y", "freq_x"), coords=ftc)
    re0 = jnp.asarray(rng.randn(B, N, N // 2 + 1).astype(np.float32))

    def step_irfft(xx):
        daft = half.copy(data=_car.ComplexPair(xx, xx * 0.3))
        out = xrft_tpu.ifft(daft, dim=["freq_y", "freq_x"],
                            real_dim="freq_x", shift=False, lag=None,
                            true_phase=False, true_amplitude=False)
        return jnp.sum(out.data)

    _bench("irfft2_flagship_ms",
           lambda: round(loop_per_iter(step_irfft, re0, k=8), 2))

    # natural-order leg: freq_y in raw fftfreq order.  The sort roll
    # composes with the input ifftshift into the identity
    # (transform.py sort_rolls), so this should measure equal to the
    # pre-sorted leg within spread.
    ftc_nat = {"freq_y": np.fft.fftfreq(N, 0.5),
               "freq_x": np.fft.rfftfreq(N, 0.5)}
    half_nat = LabeledArray(
        jnp.zeros((B, N, N // 2 + 1), np.float32),
        dims=("time", "freq_y", "freq_x"), coords=ftc_nat)

    def step_irfft_nat(xx):
        daft = half_nat.copy(data=_car.ComplexPair(xx, xx * 0.3))
        out = xrft_tpu.ifft(daft, dim=["freq_y", "freq_x"],
                            real_dim="freq_x", shift=False, lag=None,
                            true_phase=False, true_amplitude=False)
        return jnp.sum(out.data)

    _bench("irfft2_flagship_natural_ms",
           lambda: round(loop_per_iter(step_irfft_nat, re0, k=8), 2))
    del re0

    # Welch flagship: 8x4096^2 PSD over 1024^2 hann segments
    da_w = da.chunk({"y": N // 4, "x": N // 4})

    def step_welch(xx):
        ps = xrft_tpu.power_spectrum(
            da_w.copy(data=xx), dim=["y", "x"], window="hann",
            chunks_to_segments=True)
        return jnp.sum(ps.data)

    _bench("welch_psd_flagship_ms",
           lambda: round(loop_per_iter(step_welch, da_w.data, k=8), 2))

    # overlap-Welch flagship: 8x4096^2 PSD over 1024^2 hann segments at
    # 50% overlap — scipy noverlap semantics (~3x the segment count of
    # the non-overlap Welch flagship: 7x7 strided windows per field vs
    # 4x4 tiles)
    da_wo = da.chunk({"y": N // 4, "x": N // 4})

    def step_welch_overlap(xx):
        ps = xrft_tpu.power_spectrum(
            da_wo.copy(data=xx), dim=["y", "x"], window="hann",
            chunks_to_segments=True,
            segment_overlap={"y": 0.5, "x": 0.5})
        return jnp.sum(ps.data)

    _bench("welch_overlap_psd_flagship_ms",
           lambda: round(loop_per_iter(step_welch_overlap, da_wo.data,
                                       k=4), 2))

    # spectrogram flagship: 8 series x 4M samples,
    # 4096-point hann segments, scipy-default overlap (nperseg//8)
    Bs, Ns, segs = (2, 1 << 14, 256) if _SMOKE else (8, 1 << 22, 4096)
    da_sg = LabeledArray(
        rng.randn(Bs, Ns).astype(np.float32), dims=("z", "t"),
        coords={"t": np.arange(Ns) * 2.5e-4})

    def step_sg(xx):
        sg = xrft_tpu.spectrogram(da_sg.copy(data=xx), dim="t",
                                  seglen=segs, window="hann")
        return jnp.sum(sg.data)

    _bench("spectrogram_flagship_ms",
           lambda: round(loop_per_iter(step_sg, da_sg.data, k=4), 2))

    # ---- flagship-scale cells for the scipy-namesake families

    # stft flagship: same signal family as the spectrogram flagship but
    # through the full scipy-invertible stft (boundary zeros + padding +
    # complex output)
    def step_stft(xx):
        from xrft_tpu.ops import carray as _c

        st = xrft_tpu.stft(da_sg.copy(data=xx), dim="t", seglen=segs,
                           window="hann")
        return jnp.sum(_c.real(st.data)) + jnp.sum(_c.imag(st.data))

    _bench("stft_flagship_ms",
           lambda: round(loop_per_iter(step_stft, da_sg.data, k=4), 2))

    # dct2 flagship: 8 x 4096^2 type-II over both axes (nested 1-D
    # transforms, the scipy.fft.dctn composition)
    def step_dct2(xx):
        out = xrft_tpu.dct(xrft_tpu.dct(da.copy(data=xx), dim="x"),
                           dim="y")
        return jnp.sum(out.data)

    _bench("dct2_flagship_ms",
           lambda: round(loop_per_iter(step_dct2, da.data, k=8), 2))

    # fftconvolve flagship: 4096^2 field (x) 63^2 kernel, mode='same'
    Nc, Kc2 = (256, 9) if _SMOKE else (4096, 63)
    da_c = LabeledArray(rng.randn(Nc, Nc).astype(np.float32),
                        dims=("y", "x"),
                        coords={"y": np.arange(Nc) * 1.0,
                                "x": np.arange(Nc) * 1.0})
    kern = LabeledArray(rng.randn(Kc2, Kc2).astype(np.float32),
                        dims=("y", "x"),
                        coords={"y": np.arange(Kc2) * 1.0,
                                "x": np.arange(Kc2) * 1.0})

    def step_conv(xx):
        out = xrft_tpu.fftconvolve(da_c.copy(data=xx), kern,
                                   dims=["y", "x"], mode="same")
        return jnp.sum(out.data)

    _bench("fftconvolve_2d_ms",
           lambda: round(loop_per_iter(step_conv, da_c.data, k=8), 2))

    # same operands through the direct route (ONE conv_general_dilated,
    # no padded transforms) — the method='auto' crossover check
    def step_conv_direct(xx):
        out = xrft_tpu.convolve(da_c.copy(data=xx), kern,
                                dims=["y", "x"], mode="same",
                                method="direct")
        return jnp.sum(out.data)

    _bench("conv_direct_2d_ms",
           lambda: round(loop_per_iter(step_conv_direct, da_c.data, k=8),
                         2))

    # one-sided flagship: user-requested real_dim= PSD (the scipy.welch /
    # periodogram convention)
    def step_onesided(xx):
        ps = xrft_tpu.power_spectrum(
            da.copy(data=xx), dim=["y", "x"], real_dim="x", window="hann")
        return jnp.sum(ps.data)

    _bench("onesided_psd_flagship_ms",
           lambda: round(loop_per_iter(step_onesided, da.data, k=8), 2))

    # ---- hp at scale (config 2's true shape and a >= 4M-point
    # transform), native float64 under x64
    N6 = 128 if _SMOKE else 1024
    da6 = LabeledArray(rng.randn(N6, N6).astype(np.float32),
                       dims=("y", "x"),
                       coords={"y": np.arange(N6) * 0.5,
                               "x": np.arange(N6) * 0.5})

    def step6(xx):
        ps = xrft_tpu.power_spectrum(da6.copy(data=xx), dim=["y", "x"],
                                     window="hann", detrend="linear",
                                     engine="hp")
        return jnp.sum(ps.data.hi)

    _bench("hp_psd_1024_ms",
           lambda: round(_x64(lambda: loop_per_iter(step6, da6.data, k=8)),
                         2))

    N7 = 256 if _SMOKE else 2048  # 2-D fft, 4.19M points
    da7 = LabeledArray(rng.randn(N7, N7).astype(np.float32),
                       dims=("y", "x"),
                       coords={"y": np.arange(N7) * 1.0,
                               "x": np.arange(N7) * 1.0})

    def step7(xx):
        ft = xrft_tpu.fft(da7.copy(data=xx), dim=["y", "x"], engine="hp",
                          true_phase=False, true_amplitude=False)
        return jnp.sum(ft.data.rh)

    _bench("hp_fft_2048sq_ms",
           lambda: round(_x64(lambda: loop_per_iter(step7, da7.data, k=4)),
                         2))

    # ---- the 1e-10 precision contract: the hp windowed+detrended PSD at
    # config 2's true shape vs the float64 host pipeline, and an hp
    # fft/ifft roundtrip (config 1).  Emitted as hp_max_relerr.
    def hp_relerr():
        ps6 = np.asarray(jax.jit(lambda d: xrft_tpu.power_spectrum(
            d, dim=["y", "x"], window="hann", detrend="linear",
            engine="hp").data)(da6))
        v6 = da6.values.astype(np.float64)
        i6 = np.arange(N6) - (N6 - 1) / 2
        s2 = (i6 ** 2).sum()
        vm = v6 - v6.mean()
        ay = (vm * i6[:, None]).sum() / (s2 * N6)
        ax = (vm * i6[None, :]).sum() / (s2 * N6)
        vd = vm - ay * i6[:, None] - ax * i6[None, :]
        w6 = sps.windows.hann(N6, sym=False)
        F6 = np.fft.fftshift(np.fft.fftn(vd * np.outer(w6, w6))) * 0.25
        ref6 = np.abs(F6) ** 2 * (1.0 / (N6 * 0.5)) ** 2
        relerr_psd = float(np.abs(ps6 - ref6).max() / ref6.max())

        N1 = 512
        tq = np.arange(N1) * 0.25
        sig1 = rng.randn(N1).astype(np.float32)
        d1 = LabeledArray(sig1, dims=("t",), coords={"t": tq})
        ft1 = xrft_tpu.fft(d1, dim=["t"], engine="hp")
        back1 = xrft_tpu.ifft(ft1, dim=["freq_t"], engine="hp",
                              lag=[float(tq[N1 // 2])])
        relerr_rt = float(np.abs(
            np.asarray(back1.values).real - sig1.astype(np.float64)).max())
        return float(f"{max(relerr_psd, relerr_rt):.3e}")

    _bench("hp_max_relerr", lambda: _x64(hp_relerr))

    print(json.dumps({
        "metric": f"windowed+detrended power_spectrum {B}x{N}x{N} f32, "
                  f"end-to-end jit, per-iteration device time on "
                  f"{device['kind']}",
        "value": round(device_ms, 2),
        "unit": "ms",
        "vs_baseline": round(np_ms / device_ms, 2),
        "device": device,
        **extras,
    }))


def _x64(fn):
    """Run ``fn`` with x64 on: engine='hp' is then native float64."""
    import jax

    with jax.enable_x64(True):
        return fn()


if __name__ == "__main__":
    main()
