"""Fused one-sided power-spectrum pipeline: raw-layout |F|^2 with the
window folded into the transform stage.

The standard one-sided path (spectra._power_spectrum_via_rfft) composes
detrend -> window multiply -> stacked rfft -> epilogue reshape -> |.|^2 ->
Hermitian mirror.  When memory bandwidth binds, the epilogue dominates
the non-dot traffic: it restores standard order on the full *stacked
complex* array only for |.|^2 to immediately halve the data.  This path
instead:

1. runs |F|^2 directly on the engine's deferred-interleave digit layout
   (``stacked_fft.fft_nd_stacked(raw=True)``) — elementwise math does not
   care about frequency order — and only the *real, half-size* PSD pays a
   restore pass (one ``lax.reshape(dimensions=...)``, which also performs
   the transpose back to the caller's dim order for free);
2. hands the separable window's per-axis 1-D factors to the engine
   (``pre_weights``), which folds them into direct dot weights or places
   the multiply where it fuses into the preceding dot's output;
3. subtracts the detrend fit inline (same closed form as
   :mod:`..detrend`), where XLA fuses it into the same elementwise pass
   as the first axis's window factor — numerically identical to the
   generic path (a spectral-domain subtraction was measured equal-traffic
   but loses f32 accuracy at low wavenumbers when the trend dominates).

plus an up-front transpose to the dot chain's preferred free-dim order
(see the layout note in :func:`fused_one_sided_psd`).

Together with the Hermitian mirror this computes the reference's
``power_spectrum`` (``/root/reference/xrft/xrft.py:685-750``) semantics
for real input.  It serves only the matmul engine
(``config.fft_engine="matmul"``), plain JAX kept reachable until
ROADMAP.md Design 1.2 removes it; on the default XLA FFT the generic path
runs.
"""

from __future__ import annotations

import types
import warnings

import jax.numpy as jnp
import numpy as np
import scipy.signal as sps

from .. import coords as ce
from ..config import resolve_fft_engine
from ..labeled import Coord, LabeledArray
from . import carray, stacked_fft
from .window import WINDOW_TYPES

__all__ = ["fused_psd_applicable", "fused_one_sided_psd",
           "fused_cross_applicable", "fused_one_sided_cross"]

# every kwarg the fused path understands; anything else falls back to the
# generic fft-based path (which will raise on genuinely unknown kwargs)
_ALLOWED_KW = {
    "engine", "window", "detrend", "spacing_tol", "prefix", "true_phase",
    "true_amplitude", "shift", "chunks_to_segments",
}


def fused_psd_applicable(da, dims, half_dim, shift, kwargs) -> bool:
    """True when the fused raw-layout PSD can serve this request."""
    if set(kwargs) - _ALLOWED_KW:
        return False
    if kwargs.get("true_phase") or kwargs.get("chunks_to_segments"):
        return False
    engine = kwargs.get("engine")
    if callable(engine) or resolve_fft_engine(engine) != "matmul":
        return False
    if kwargs.get("detrend") not in (None, "constant", "linear"):
        return False
    window = kwargs.get("window")
    if not (window is None or window is True or window in WINDOW_TYPES):
        return False
    data = da.data
    if carray.is_pair(data) or np.dtype(data.dtype).kind != "f":
        return False
    # stacked-engine support, evaluated on the half-dim-trailing layout
    newdims = [d for d in da.dims if d != half_dim] + [half_dim]
    ndim = len(newdims)
    axes = [newdims.index(d) for d in dims if d != half_dim] + [ndim - 1]
    shape = tuple(da.sizes[d] for d in newdims)
    proxy = types.SimpleNamespace(shape=shape, dtype=np.dtype(data.dtype))
    post = tuple(axes[:-1]) if shift else ()
    return stacked_fft.stacked_supported(proxy, axes, "rfft", (), post)


def _host_window(window, n: int) -> np.ndarray:
    if window is None:
        return np.ones(n)
    return np.asarray(getattr(sps.windows, window)(n, sym=False),
                      dtype=np.float64)


def _window_multiply(data, window, dims, axes, sizes, rdt):
    """Explicit separable window multiply (one broadcast multiply per
    transform axis), shared by the fused one-sided route (window-only
    placement rule, see the note in _fused_raw_rfft) and the
    packed route (whose y factor differs between packed planes, so the
    engine's per-axis pre_weights cannot carry it)."""
    import jax.numpy as jnp

    for d, ax in zip(dims, axes):
        w1 = _host_window(window, sizes[d]).astype(rdt)
        bshape = [1] * data.ndim
        bshape[ax] = sizes[d]
        data = data * jnp.asarray(w1.reshape(bshape))
    return data


def _steered_front(da, dims, half_dim, kwargs):
    """Shared preprocessing of the fused/packed estimator routes:
    coordinate validation, layout steering (transpose +
    optimization_barrier), and detrend.  Returns
    ``(data, axes, window, ctx)`` with ``window`` already normalized
    (``True`` -> ``"hann"`` with ONE FutureWarning)."""
    from ..transform import _check_bad_transform_coords, _dim_coord

    spacing_tol = kwargs.get("spacing_tol", 1e-3)
    window = kwargs.get("window")
    detrend = kwargs.get("detrend")
    if window is True:
        window = "hann"
        warnings.warn(
            "Please provide the name of window adhering to "
            "scipy.signal.windows. The boolean option will be deprecated "
            "in future releases.",
            FutureWarning,
        )

    ce.check_valid_fft_coords(da, dims)
    _check_bad_transform_coords(da, dims)

    orig_dims = da.dims
    # Input layout: XLA's layout assignment wants the first dot's free
    # transform dim physically major; fed that order the whole dot chain
    # runs without a single relayout copy, while e.g. [t,y,x] input pays
    # one full-array copy before the first dot AND one between the axes.
    # So
    # the path transposes to [non-half transform dims, batch dims, half]
    # up front, behind an optimization_barrier — without the barrier XLA
    # fuses the transpose into the elementwise pass and re-inserts both
    # copies.  The restore reshape hands the caller's dim order back for
    # free (axis_order below), so only this one input pass is paid.
    # Batch dims ordered tile-friendliest LAST: between the per-axis dot
    # chains the last batch dim occupies the sublane (second-minor) slot
    # of every intermediate (the just-transformed axis's digits move to
    # the front, the next axis's final digit stays minor), so a tiny
    # segment dim there pads up to the (8, 128) tile an XLA layout
    # may use — up to a 2x traffic blowup on the largest arrays in the
    # pipeline.
    def _sublane_pad(d):
        s = da.sizes[d]
        if s == 0:
            return 1.0  # zero-length batch dim: nothing to pad
        return (-(-s // 8) * 8) / s
    batch = sorted((d for d in orig_dims if d not in dims),
                   key=_sublane_pad, reverse=True)
    newdims = [d for d in dims if d != half_dim] + batch + [half_dim]
    barrier = tuple(orig_dims) != tuple(newdims)
    if barrier:
        import jax

        da = da.transpose(*newdims)
        data0 = da.data
        if isinstance(data0, np.ndarray):
            from ..labeled import _asjax

            data0 = _asjax(data0)
        da = da.copy(data=jax.lax.optimization_barrier(data0))

    # dims has half_dim last by construction (spectra._half_spectrum_dim)
    axes = [da.get_axis_num(d) for d in dims]
    N = [da.sizes[d] for d in dims]
    delta = [ce.get_coordinate_spacing(_dim_coord(da, d), spacing_tol)
             for d in dims]

    if detrend is not None:
        from ..detrend import detrend as _detrend

        da = _detrend(da, dims, detrend_type=detrend)

    data = da.data
    if isinstance(data, np.ndarray):
        from ..labeled import _asjax

        data = _asjax(data)
    rdt = np.dtype(data.dtype)
    ctx = dict(orig_dims=orig_dims, newdims=newdims, N=N, delta=delta,
               da=da, rdt=rdt)
    return data, axes, window, ctx


def _fused_raw_rfft(da, dims, half_dim, shift, kwargs):
    """Shared front half of the fused one-sided estimators: coordinate
    validation, layout steering (transpose + optimization_barrier),
    detrend, window, and the stacked raw rfft.  Returns
    ``(re, im, layout, ctx)`` with the raw-layout planes and the metadata
    the estimator tails need."""
    data, axes, window, ctx = _steered_front(da, dims, half_dim, kwargs)
    da = ctx["da"]
    rdt = ctx["rdt"]
    detrend = kwargs.get("detrend")

    # Placement rules (chosen by measurement when this engine was tuned;
    # not re-measured on the GPU): with detrend+window the window rides
    # the engine's pre_weights, which decouples the y-axis dots from the
    # detrend-laden input fusion (a schedule effect, not traffic);
    # detrend alone takes an inter-axis barrier; window alone an explicit
    # multiply; bare input nothing.
    pre_weights = None
    if window is not None and detrend is not None:
        pre_weights = {ax: _host_window(window, da.sizes[d])
                       for d, ax in zip(dims, axes)}
    elif window is not None:
        data = _window_multiply(data, window, dims, axes, da.sizes, rdt)

    post_axes = tuple(axes[:-1]) if shift else ()
    a_raw, layout = stacked_fft.fft_nd_stacked(
        data, axes, "rfft", (), post_axes, pre_weights=pre_weights,
        raw=True,
        inter_axis_barrier=(detrend is not None and window is None))
    re, im = stacked_fft.raw_planes(a_raw, layout)
    return re, im, layout, ctx


def _one_sided_labeled(std, ctx, dims, half_dim, shift, prefix, name):
    """Output metadata tail: identical to ``fft(da, real_dim=half_dim,
    shift=False, _shift_nonreal=shift)`` — one-sided half axis, shifted
    non-half grids."""
    da = ctx["da"]
    k = ce.freq_grids(ctx["N"], ctx["delta"], True, False)
    if shift:
        k = [np.fft.fftshift(kk) if d != half_dim else kk
             for kk, d in zip(k, dims)]
    swap = {d: ce.freq_dim_name(d, prefix) for d in dims}
    out_dims = [swap.get(d, d) for d in ctx["orig_dims"]]
    out_coords = {}
    for cname, c in da.coords.items():
        if cname in dims:
            continue
        out_coords[cname] = c.copy()
    for d, kk in zip(dims, k):
        fd = swap[d]
        out_coords[fd] = Coord((fd,), kk, {"spacing": kk[1] - kk[0]}, fd)
    return LabeledArray(std, dims=out_dims, coords=out_coords, name=name)


def fused_one_sided_psd(da, dims, half_dim, shift, scale, kwargs,
                        half_factor=None):
    """One-sided PSD of real `da` over `dims` as a single fused program.

    Returns a LabeledArray shaped like ``fft(da, real_dim=half_dim)`` —
    frequency dims renamed/coord'ed, non-half axes fftshifted when
    ``shift`` — whose data is already ``scale * |F|^2`` (``scale`` folds
    true-amplitude and density/window-correction factors).  The caller
    expands it to the two-sided grid via the Hermitian mirror.

    ``half_factor`` — optional 1-D per-frequency vector over the
    one-sided half axis (standard order, e.g. the real-dim doubling
    factor of ``/root/reference/xrft/xrft.py:673-682``), folded into the
    |.|^2 pass in raw layout (no extra memory pass).
    """
    prefix = kwargs.get("prefix", "freq_")
    re, im, layout, ctx = _fused_raw_rfft(da, dims, half_dim, shift, kwargs)
    rdt = ctx["rdt"]
    orig_dims = ctx["orig_dims"]

    psd = (re * re + im * im) * jnp.asarray(scale, dtype=rdt)
    if half_factor is not None:
        fac = stacked_fft.raw_axis_factor(
            psd.shape, np.asarray(half_factor, dtype=rdt), layout,
            layout.prune_axis)
        psd = psd * jnp.asarray(fac)
    order_in_transposed = [ctx["newdims"].index(d) for d in orig_dims]
    std = stacked_fft.raw_to_standard(psd, layout,
                                      axis_order=order_in_transposed)
    return _one_sided_labeled(std, ctx, dims, half_dim, shift, prefix,
                              ctx["da"].name)


def fused_cross_applicable(da1, da2, dims, half_dim, shift, kwargs,
                           true_phase) -> bool:
    """Fused raw-layout route for the cross spectrum of two real inputs.

    true_phase factors cancel EXACTLY in ``F1 * conj(F2)`` when both
    inputs share identical transform coordinates (the same unit-modulus
    per-frequency factor multiplies both transforms), so the fused path
    also serves ``true_phase=True`` — except for decreasing coordinates,
    whose flip conjugates both transforms and flips the sign of the
    cross-spectrum's imaginary part (reference flip at
    ``/root/reference/xrft/xrft.py:435-442``)."""
    kw = {k: v for k, v in kwargs.items() if k != "true_phase"}
    for da in (da1, da2):
        if not fused_psd_applicable(da, dims, half_dim, shift, kw):
            return False
    for d in dims:
        c1, c2 = da1.coords.get(d), da2.coords.get(d)
        if (c1 is None) != (c2 is None):
            return False
        if c1 is not None:
            v1 = np.asarray(c1.values)
            v2 = np.asarray(c2.values)
            if v1.dtype.kind not in "fiu" or v2.dtype.kind not in "fiu" \
                    or not np.array_equal(v1, v2):
                return False
            if true_phase and v1.size >= 2 and v1[-1] < v1[0]:
                return False
    return True


def fused_one_sided_cross(da1, da2, dims, half_dim, shift, scale, kwargs,
                          half_factor=None):
    """One-sided ``F(da1) * conj(F(da2))`` of two real inputs as a fused
    raw-layout program: both stacked rffts share one layout, the
    conjugated product and the scale run on the raw planes, and only the
    half-size complex result pays the restore passes (one per plane) —
    the per-input epilogues of the generic two-fft path are skipped
    entirely.  Reference semantics: ``/root/reference/xrft/xrft.py:816-825``.

    ``half_factor`` — optional 1-D per-frequency vector over the
    one-sided half axis (e.g. the real-dim doubling), folded into the
    product pass in raw layout.
    """
    prefix = kwargs.get("prefix", "freq_")
    if kwargs.get("window") is True:
        # normalize up front so the shared front half warns ONCE per
        # cross_spectrum call, not once per input
        kwargs = dict(kwargs)
        kwargs["window"] = "hann"
        warnings.warn(
            "Please provide the name of window adhering to "
            "scipy.signal.windows. The boolean option will be deprecated "
            "in future releases.",
            FutureWarning,
        )
    r1, i1, layout, ctx = _fused_raw_rfft(da1, dims, half_dim, shift,
                                          kwargs)
    r2, i2, _, _ = _fused_raw_rfft(da2, dims, half_dim, shift, kwargs)
    s = jnp.asarray(scale, dtype=ctx["rdt"])
    cre = (r1 * r2 + i1 * i2) * s
    cim = (i1 * r2 - r1 * i2) * s
    if half_factor is not None:
        fac = jnp.asarray(stacked_fft.raw_axis_factor(
            cre.shape, np.asarray(half_factor, dtype=ctx["rdt"]), layout,
            layout.prune_axis))
        cre = cre * fac
        cim = cim * fac
    order = [ctx["newdims"].index(d) for d in ctx["orig_dims"]]
    std = carray.ComplexPair(
        stacked_fft.raw_to_standard(cre, layout, axis_order=order),
        stacked_fft.raw_to_standard(cim, layout, axis_order=order),
    )
    return _one_sided_labeled(std, ctx, dims, half_dim, shift, prefix,
                              None)
