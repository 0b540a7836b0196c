"""Generalized Lomb-Scargle periodogram for unevenly sampled data.

Beyond the reference (xrft requires evenly spaced coordinates everywhere —
its spacing validation raises for uneven grids,
``/root/reference/xrft/xrft.py:291-304`` — so it has no unevenly-sampled
estimator at all) — matching ``scipy.signal.lombscargle``'s generalized
(Zechmeister & Kürster 2009) formulation: a per-frequency weighted
least-squares fit ``y(w) = a*cos(w*t) + b*sin(w*t) [+ c]`` with optional
sample weights and floating mean, and the three scipy ``normalize`` modes
(``False``/``'power'``, ``True``/``'normalize'``, ``'amplitude'``).

Shape: every quantity that depends only on the sample times,
the weights, and the frequency grid — the trig matrices, the tau phase
rotation that diagonalizes the normal equations, and the CC/SS/C/S
moments — is computed on host in float64 and baked into the jaxpr as
constants.  The only y-dependent terms are the projections
``YC[f] = sum_i w_i y_i cos(w_f (t_i - tau_f))`` (and YS), so the device
work is ONE batched ``[..., N] x [N, 2F]`` matmul plus O(F)
elementwise combines — no FFT, no scan, no dynamic shapes; jit-traceable
end to end and batched over all non-transform dims (scipy is 1-D only).

Coordinate-aware beyond scipy: the sample times are the dim's coordinate
(which may be arbitrarily non-uniform — the one place in the library
where that is legal), with datetime64/cftime coordinates converted to
float seconds since their first sample.
"""

from __future__ import annotations

import numpy as np

from . import coords as ce
from .labeled import Coord, LabeledArray
from .ops import carray, fft_core

__all__ = ["lombscargle"]


def _times_seconds(coord: Coord) -> np.ndarray:
    """Sample times as host float64 — numeric coords as-is; datetime64 /
    cftime coords as seconds since their first sample (phase in the
    ``'amplitude'`` mode is referenced to that origin)."""
    values = np.asarray(coord.values)
    if ce._is_cftime(values):
        import cftime  # optional dependency, gated like the reference

        calendar = values.flat[0].calendar
        dec = np.asarray(
            cftime.date2num(values, ce._CFTIME_UNITS, calendar),
            dtype=np.float64)
        return dec - dec.flat[0]
    if np.issubdtype(values.dtype, np.datetime64):
        ns = values.astype("datetime64[ns]")
        return (ns - ns.flat[0]).astype("timedelta64[ns]").astype("f8") / 1e9
    if not np.issubdtype(values.dtype, np.number):
        raise ValueError(
            "lombscargle: coordinate "
            f"{coord.name or coord.dims[0]!r} must be numeric or "
            "datetime-like to provide sample times")
    return np.asarray(values, dtype=np.float64)


def lombscargle(da, freqs, dim=None, normalize=False, weights=None,
                floating_mean=False) -> LabeledArray:
    """Generalized Lomb-Scargle periodogram along ``dim`` (default: last
    dim) at angular frequencies ``freqs`` — ``scipy.signal.lombscargle``:
    the weighted least-squares power of the best-fit sinusoid at each
    frequency, for arbitrarily unevenly sampled data.

    The dim's coordinate provides the sample times (it does NOT need to
    be evenly spaced; datetime64/cftime coords are converted to seconds
    since their first sample).  ``normalize`` is scipy's: ``False`` /
    ``'power'`` (default) scales a unit-amplitude harmonic to ``N/4``;
    ``True`` / ``'normalize'`` is the [0, 1] power fraction of the
    weighted residuals around zero; ``'amplitude'`` returns the complex
    best-fit amplitude+phase (a split pair in split mode).  ``weights`` are
    per-sample nonnegative weights (host array, length N);
    ``floating_mean`` fits a per-frequency y offset (ZK09).  Real input
    only.  Unlike scipy, the estimate is batched over all non-transform
    dims in one matmul.

    The output replaces ``dim`` by ``freq_<dim>`` carrying ``freqs``
    as its coordinate (angular frequency, rad per coordinate unit; the
    grid may be non-uniform, so there is no ``spacing`` attr).
    """
    import jax
    import jax.numpy as jnp

    from .spectra import _norm_1d_dim

    dim = _norm_1d_dim(da, dim, "lombscargle")
    ax = da.dims.index(dim)
    n = da.sizes[dim]
    if carray.is_complex(da.data):
        raise ValueError("lombscargle: input must be real "
                         "(scipy.signal.lombscargle semantics)")
    if dim not in da.coords:
        raise ValueError(
            f"lombscargle: dim {dim!r} has no coordinate to provide the "
            "sample times")
    t = _times_seconds(da.coords[dim])
    if t.shape != (n,):
        raise ValueError(
            f"lombscargle: coordinate on {dim!r} must be 1-D of length "
            f"{n}, got shape {t.shape}")

    freqs = np.asarray(freqs, dtype=np.float64)
    if not (freqs.ndim == 1 and freqs.size > 0):
        raise ValueError(
            "Parameter freqs must be a 1-D array of non-zero length!")
    if weights is None:
        w = np.ones(n, dtype=np.float64)
    else:
        w = np.asarray(getattr(weights, "values", weights),
                       dtype=np.float64)
        if w.shape != (n,):
            raise ValueError(
                "Parameters x, y, weights must be 1-D arrays of equal "
                "non-zero length!")
    if not (np.all(w >= 0) and np.sum(w) > 0):
        raise ValueError(
            "Parameter weights must have only non-negative entries "
            "which sum to a positive value!")
    if isinstance(normalize, bool):
        normalize = "normalize" if normalize else "power"
    if normalize not in ("power", "normalize", "amplitude"):
        raise ValueError(
            "Normalize must be: False (or 'power'), True (or "
            "'normalize'), or 'amplitude'.")

    # ---- host-static machinery (float64; y never enters) -------------
    # ZK09 moments and the tau rotation that zeroes the cross moment CS,
    # mirroring scipy.signal.lombscargle's vectorized implementation.
    w = w / w.sum()
    wt = t[:, None] * freqs[None, :]            # [N, F] angular phases
    coswt, sinwt = np.cos(wt), np.sin(wt)
    CC = w @ (coswt * coswt)
    SS = 1.0 - CC
    CS = w @ (coswt * sinwt)
    if floating_mean:
        C, S = w @ coswt, w @ sinwt
        CC, SS, CS = CC - C * C, SS - S * S, CS - C * S
    tau = 0.5 * np.arctan2(2.0 * CS, CC - SS)   # [F]
    coswt_tau = np.cos(wt - tau)
    sinwt_tau = np.sin(wt - tau)
    CC = w @ (coswt_tau * coswt_tau)
    SS = 1.0 - CC
    if floating_mean:
        C, S = w @ coswt_tau, w @ sinwt_tau
        CC, SS = CC - C * C, SS - S * S
    else:
        C = S = np.zeros_like(CC)
    # scipy's division-by-zero guard, applied in f64 like scipy
    epsneg = np.finfo(np.float64).epsneg
    CC = np.maximum(CC, epsneg)
    SS = np.maximum(SS, epsneg)

    rdt = np.dtype(da.data.dtype)
    if rdt.kind != "f":
        rdt = np.dtype(np.float64)
    F = freqs.shape[0]

    def const(v):
        return jnp.asarray(np.asarray(v).astype(rdt))

    # ---- device path: one [..., N] x [N, 2F] matmul -------------------
    wb = const(w).reshape([n if i == ax else 1 for i in range(da.ndim)])
    y = da.data.astype(rdt) if da.data.dtype != rdt else da.data
    wy = y * wb
    M = const(np.concatenate([coswt_tau, sinwt_tau], axis=1))  # [N, 2F]
    # HIGHEST precision like the engine's dots (ops/matmul_fft.py): a
    # reduced-precision contraction (TF32 on an H100) would cost ~1e-4
    # relative error here, the full f32 contraction ~1e-7.
    proj = jnp.tensordot(wy, M, axes=[[ax], [0]],
                         precision=jax.lax.Precision.HIGHEST)
    YC, YS = proj[..., :F], proj[..., F:]
    if floating_mean:
        Y = jnp.sum(wy, axis=ax)[..., None]        # [..., 1]
        YC = YC - Y * const(C)
        YS = YS - Y * const(S)
    a = YC / const(CC)
    b = YS / const(SS)

    if normalize == "amplitude":
        # (a + ib) * exp(i*tau), tau rotation folded into host constants
        re = a * const(np.cos(tau)) - b * const(np.sin(tau))
        im = a * const(np.sin(tau)) + b * const(np.cos(tau))
        out = (carray.ComplexPair(re, im) if fft_core.use_split_complex()
               else jnp.asarray(re + 1j * im))
    else:
        pgram = 2.0 * (a * YC + b * YS)
        if normalize == "power":
            pgram = pgram * np.asarray(n / 4.0, dtype=rdt)
        else:  # 'normalize': power fraction of weighted residuals
            YY = jnp.sum(wy * y, axis=ax)[..., None]
            if floating_mean:
                YY = YY - jnp.sum(wy, axis=ax)[..., None] ** 2
            pgram = pgram * (0.5 / YY)
        out = pgram

    out = carray.moveaxis(out, -1, ax) if ax != da.ndim - 1 else out
    fdim = ce.freq_dim_name(dim)
    out_dims = [fdim if d == dim else d for d in da.dims]
    coords = {k: c.copy() for k, c in da.coords.items()
              if dim not in c.dims}
    coords[fdim] = Coord((fdim,), freqs, {}, fdim)
    return LabeledArray(out, dims=out_dims, coords=coords,
                        attrs=dict(da.attrs), name=da.name)
