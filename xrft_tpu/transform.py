"""Forward and inverse Fourier transforms with coordinate-aware phase and
amplitude handling.

Re-implements the semantics of the reference transform core
(xrft's ``xrft/xrft.py:307-646``) for jit: every decision driven
by coordinates — spacings, lags, frequency grids, axis flips, shifts,
phase factors — is computed host-side at trace time and baked into the
compiled program as constants; the bulk-data path (flip → ifftshift →
detrend → window → FFT → fftshift → phase multiply → amplitude scale) is a
chain of traceable XLA ops that fuses under ``jax.jit``.

All functions accept and return :class:`~xrft_tpu.labeled.LabeledArray` and
are fully jit-traceable (a ``LabeledArray`` is a pytree whose coords/attrs
are static aux data).
"""

from __future__ import annotations

import warnings

import numpy as np

from . import coords as ce
from .labeled import Coord, LabeledArray
from .ops import carray, fft_core

__all__ = ["fft", "ifft", "dft", "idft"]


def _run_core(data, axes, kind, engine, pre_shift_axes=(),
              post_shift_axes=(), post_kind="fftshift"):
    """Run the core N-D transform; `engine` may be an engine name or a
    callable(data, axes, kind) (used by the distributed pencil path).
    Input-ifftshift / output-shift requests are forwarded to the engine
    (the matmul engine absorbs them into its constant matrices — zero
    device cost); callable engines get explicit shifts here."""
    if callable(engine):
        if pre_shift_axes:
            data = fft_core.ifftshift(data, list(pre_shift_axes))
        out = engine(data, axes, kind)
        if post_shift_axes:
            post_fn = (fft_core.fftshift if post_kind == "fftshift"
                       else fft_core.ifftshift)
            out = post_fn(out, list(post_shift_axes))
        return out
    fn = {"fft": fft_core.fftn, "ifft": fft_core.ifftn,
          "rfft": fft_core.rfftn, "irfft": fft_core.irfftn}[kind]
    kw = {}
    if kind in ("ifft", "irfft"):
        kw["post_kind"] = post_kind
    return fn(data, axes, engine=engine, pre_shift_axes=pre_shift_axes,
              post_shift_axes=post_shift_axes, **kw)

_real_flag_warning = (
    "`real` flag will be deprecated in future version of xrft_tpu.fft and "
    "replaced by `real_dim` flag."
)


def _move_to_end(lst, el):
    return [i for i in lst if i != el] + [el]


def _dim_coord(da: LabeledArray, d: str) -> Coord:
    """The 1-D coordinate for dim d, or an implicit integer grid.

    xarray exposes an implicit ``arange(n)`` index for dims without
    coordinates, and the reference relies on that (its 'nocoords' tests get
    spacing 1); we synthesize the same.
    """
    if d in da.coords:
        return da.coords[d]
    return Coord((d,), np.arange(da.sizes[d]), None, d)


def _norm_dim(da, dim):
    if dim is None:
        return list(da.dims)
    if isinstance(dim, str):
        return [dim]
    return list(dim)


def _check_bad_transform_coords(da: LabeledArray, dim):
    """Reject non-dimension coordinates that share a transform dim
    (reference ``/root/reference/xrft/xrft.py:411-420``)."""
    for d in dim:
        bad = [c for c in da.coords if c != d and d in da.coords[c].dims]
        if bad:
            raise ValueError(
                f"The input array contains coordinate variable(s) ({bad}) "
                f"whose dims include the transform dimension(s) `{d}`. "
                f"Please drop these coordinates (`.drop_vars({bad})`) before "
                f"invoking xrft_tpu."
            )


def _degrade_quad(da: LabeledArray) -> LabeledArray:
    """df64 quad data reaching an f32-grade engine — e.g. a jit-staged
    host-complex128 LabeledArray (labeled.tree_flatten emits CDF64 on
    split-complex backends) — degrades to its correctly rounded f32
    representation (the hi limbs)."""
    data = da.data
    if isinstance(data, carray.CDF64):
        return da.copy(data=carray.ComplexPair(data.rh, data.ih))
    if isinstance(data, carray.DF64):
        return da.copy(data=data.hi)
    return da


def _stack_segments(da: LabeledArray, dim, suffix="_segment",
                    overlap=None, plan=None) -> LabeledArray:
    """Reshape each transform dim into (<dim>_segment, <dim>) according to
    the array's declared chunk lengths (Welch/Bartlett segmenting; the
    analogue of the reference's dask-chunk reshape ``_stack_chunks``,
    ``/root/reference/xrft/xrft.py:106-136``).

    ``overlap`` (beyond the reference, whose dask chunks cannot overlap):
    per-dim overlap in samples (int) or as a fraction of the segment
    length (float in [0, 1)); segments become static strided windows —
    a stack of XLA slices, no gather — following scipy.signal.welch's
    ``noverlap`` convention (trailing samples that do not fill a final
    segment are dropped).  ``plan`` short-circuits a precomputed
    :func:`_segment_plan` result (avoids re-warning on dropped tails)."""
    newdims, newshape, newcoords, plans = plan if plan is not None \
        else _segment_plan(da, dim, suffix, overlap)
    if all(hop == seglen for _, _, seglen, hop, _ in plans):
        data = carray.reshape(da.data, tuple(newshape)) \
            if carray.is_pair(da.data) else da.data.reshape(tuple(newshape))
    else:
        data = da.data
        for ax, nseg, seglen, hop, _n in sorted(plans, reverse=True):
            data = _slice_stack_axis(data, ax, nseg, seglen, hop)
    return LabeledArray(data, dims=newdims, coords=newcoords, attrs=da.attrs)


def _slice_stack_axis(data, ax, nseg, seglen, hop):
    """(…, n, …) → (…, nseg, seglen, …) strided windows along axis ``ax``
    as a stack of static slices (bandwidth-bound copies; never a
    gather)."""
    import jax.numpy as jnp

    def one(v):
        xp = np if isinstance(v, np.ndarray) else jnp
        segs = [v[(slice(None),) * ax + (slice(i * hop, i * hop + seglen),)]
                for i in range(nseg)]
        return xp.stack(segs, axis=ax)

    return carray._map(data, one)


def _segment_plan(da: LabeledArray, dim, suffix="_segment", overlap=None):
    """Metadata for :func:`_stack_segments` — (newdims, newshape,
    newcoords, plans) — shared with the quad-plane (engine='hp') path and
    the sharded estimators; ``plans`` lists (axis, nseg, seglen, hop, n)
    per transform dim."""
    chunks = getattr(da, "_chunks", None) or da.attrs.get("_chunks")
    if chunks is None:
        raise ValueError(
            "chunks_to_segments=True requires declared chunks: call "
            "da.chunk({dim: seglen}) first."
        )
    ov = dict(overlap) if isinstance(overlap, dict) else \
        ({d: overlap for d in dim} if overlap else {})
    bad = set(ov) - set(dim)
    if bad:
        raise ValueError(
            f"segment_overlap given for non-transform dims {sorted(bad)}"
        )
    newdims, newshape, newcoords, plans = [], [], {}, []
    for ax, d in enumerate(da.dims):
        n = da.sizes[d]
        if d in dim:
            # a transform dim with no declared chunk length is one
            # full-length chunk = a single segment, matching the
            # reference's dask semantics (an unchunked dask dim has one
            # chunk spanning the axis, /root/reference/xrft/xrft.py:115-119)
            chunklen = chunks.get(d, n)
            o = ov.get(d, 0) or 0
            if isinstance(o, float):
                if not 0.0 <= o < 1.0:
                    raise ValueError(
                        f"fractional segment_overlap for dim {d!r} must be "
                        f"in [0, 1), got {o}"
                    )
                o = int(round(o * chunklen))
            if not 0 <= o < chunklen:
                raise ValueError(
                    f"segment_overlap for dim {d!r} must be in "
                    f"[0, seglen={chunklen}), got {o}"
                )
            hop = chunklen - o
            if o == 0:
                if n % chunklen != 0:
                    raise ValueError("Chunk lengths need to be the same.")
                nseg = n // chunklen
            else:
                if n < chunklen:
                    raise ValueError(
                        f"declared chunk length {chunklen} exceeds dim "
                        f"{d!r} size {n}"
                    )
                nseg = (n - chunklen) // hop + 1
                dropped = n - ((nseg - 1) * hop + chunklen)
                if dropped:
                    warnings.warn(
                        f"segment_overlap drops the last {dropped} samples "
                        f"of dim {d!r} (scipy.signal.welch convention)"
                    )
            newdims += [d + suffix, d]
            newshape += [nseg, chunklen]
            newcoords[d + suffix] = np.arange(nseg)
            coord_vals = _dim_coord(da, d).values
            newcoords[d] = coord_vals[:chunklen]
            plans.append((ax, nseg, chunklen, hop, n))
        else:
            newdims.append(d)
            newshape.append(n)
            if d in da.coords:
                newcoords[d] = da.coords[d].values
    return newdims, newshape, newcoords, plans


def fft(
    da: LabeledArray,
    spacing_tol: float = 1e-3,
    dim=None,
    real_dim: str | None = None,
    shift: bool = True,
    detrend: str | None = None,
    window: str | None = None,
    true_phase: bool = True,
    true_amplitude: bool = True,
    chunks_to_segments: bool = False,
    segment_overlap=None,
    prefix: str = "freq_",
    real: str | None = None,
    engine: str | None = None,
    _shift_nonreal: bool = False,
) -> LabeledArray:
    """Perform the discrete Fourier transform of `da` along specified dims.

    Matches the reference semantics of ``xrft.fft``
    (``/root/reference/xrft/xrft.py:307-476``):

    - ``dim=None`` transforms all dims; ``real_dim`` takes an rfft along that
      dim (moved last; ``shift`` forced False).
    - ``detrend`` in {None, 'constant', 'linear'} removes the mean or the
      linear least-squares fit over the transform dims first.
    - ``window`` applies a separable scipy-named window over the transform
      dims.
    - ``true_phase=True`` accounts for coordinate positions: decreasing
      coordinates are flipped, the input is ``ifftshift``-ed (treating the
      grid as centered on its lag), and the output is multiplied by
      ``exp(-2i*pi*f*lag)``; each output frequency coordinate records its
      ``direct_lag`` attr.
    - ``true_amplitude=True`` multiplies by the product of grid spacings so
      amplitudes match the continuous-transform convention.
    - ``chunks_to_segments=True`` reshapes declared chunks into
      ``<dim>_segment`` dims (Welch segmenting).  ``segment_overlap``
      (int samples, float fraction of the segment length, or per-dim
      dict) makes the segments overlap — scipy.signal.welch's
      ``noverlap``, which the reference's dask-chunk model cannot
      express.
    """
    dim = _norm_dim(da, dim)

    if segment_overlap is not None and not chunks_to_segments:
        raise ValueError("segment_overlap requires chunks_to_segments=True")

    if real is not None:
        real_dim = real
        warnings.warn(_real_flag_warning, FutureWarning)

    if engine == "hp":
        # high-precision path: native float64 under x64, else df64
        # elementwise + int8-limb DFT (see highprec.fft_hp).  Segmenting is a pure
        # metadata reshape of the (still low-precision-representable)
        # input, so it happens before the df64 promotion.
        from .highprec import fft_hp

        return fft_hp(da, spacing_tol, dim, real_dim, shift, detrend,
                      window, true_phase, true_amplitude, prefix,
                      chunks_to_segments=chunks_to_segments,
                      segment_overlap=segment_overlap)

    da = _degrade_quad(da)

    if real_dim is not None:
        if real_dim not in da.dims:
            raise ValueError(
                "The dimension along which real FT is taken must be one of "
                "the existing dimensions."
            )
        dim = _move_to_end(dim, real_dim)

    ce.check_valid_fft_coords(da, dim)

    if chunks_to_segments:
        da = _stack_segments(da, dim, overlap=segment_overlap)

    rawdims = da.dims  # includes segment dims, if any

    nonreal_shift = False
    if real_dim is not None:
        da = da.transpose(*_move_to_end(list(da.dims), real_dim))
        # reference semantics force shift=False for real transforms
        # (/root/reference/xrft/xrft.py:400-404); _shift_nonreal is an
        # internal hook (spectra one-sided fast path) that shifts the
        # non-real axes inside the engine's constants for free
        nonreal_shift = shift and _shift_nonreal
        shift = False

    axis_num = [da.get_axis_num(d) for d in dim]
    N = [da.shape[n] for n in axis_num]

    _check_bad_transform_coords(da, dim)

    delta_x = [
        ce.get_coordinate_spacing(_dim_coord(da, d), spacing_tol) for d in dim
    ]
    lag_x = [ce.lag_coord(_dim_coord(da, d)) for d in dim]

    if detrend is not None:
        from .detrend import detrend as _detrend

        orig_dims = da.dims
        da = _detrend(da, dim, detrend_type=detrend)
        if tuple(da.dims) != tuple(orig_dims):
            da = da.transpose(*orig_dims)

    if window is not None:
        from .ops.window import apply_window

        _, da = apply_window(da, dim, window_type=window)

    data = da.data
    if isinstance(data, np.ndarray):
        from .labeled import _asjax

        data = _asjax(data)

    if true_phase:
        # handle decreasing coordinates by flipping them ascending
        reversed_axes = [
            da.get_axis_num(d)
            for d in dim
            if d in da.coords and da.coords[d].values[-1] < da.coords[d].values[0]
        ]
        if reversed_axes:
            data = carray.flip(data, reversed_axes)

    if nonreal_shift:
        post_axes = [a for a, d in zip(axis_num, dim) if d != real_dim]
    else:
        post_axes = axis_num if shift else ()
    f = _run_core(data, axis_num, "fft" if real_dim is None else "rfft",
                  engine,
                  pre_shift_axes=axis_num if true_phase else (),
                  post_shift_axes=post_axes)

    k = ce.freq_grids(N, delta_x, real_dim is not None, shift)
    if nonreal_shift:
        k = [np.fft.fftshift(kk) if d != real_dim else kk
             for kk, d in zip(k, dim)]

    # build output: transform dims renamed freq_<d> with freq coords;
    # all other dims/coords carried through
    swap = {d: ce.freq_dim_name(d, prefix) for d in dim}
    out_dims = [swap.get(d, d) for d in da.dims]
    out_coords = {}
    for cname, c in da.coords.items():
        if cname in dim:
            continue
        out_coords[cname] = c.copy()
    for d, kk in zip(dim, k):
        spacing = kk[1] - kk[0]
        out_coords[swap[d]] = Coord((swap[d],), kk, {"spacing": spacing}, swap[d])

    daft = LabeledArray(f, dims=out_dims, coords=out_coords, name=da.name)

    if true_phase:
        for d, lag in zip(dim, lag_x):
            fd = swap[d]
            phase = carray.exp_i(
                -2.0 * np.pi * out_coords[fd].values * lag, like=daft.data
            )
            pl = LabeledArray(phase, dims=(fd,), coords={fd: out_coords[fd]})
            daft = (daft * pl).assign_coords(
                {fd: out_coords[fd].copy(
                    attrs={**out_coords[fd].attrs, "direct_lag": lag}
                )}
            )

    if true_amplitude:
        daft = daft * float(np.prod(delta_x))

    daft.name = da.name
    return daft.transpose(*[swap.get(d, d) for d in rawdims])


def ifft(
    daft: LabeledArray,
    spacing_tol: float = 1e-3,
    dim=None,
    real_dim: str | None = None,
    shift: bool = True,
    true_phase: bool = True,
    true_amplitude: bool = True,
    chunks_to_segments: bool = False,
    prefix: str = "freq_",
    lag=None,
    real: str | None = None,
    engine: str | None = None,
) -> LabeledArray:
    """Perform the inverse discrete Fourier transform of `daft` along the
    specified dimensions.

    Matches the reference semantics of ``xrft.ifft``
    (``/root/reference/xrft/xrft.py:479-646``): ``lag`` selects the output
    coordinate offset per dim (``None`` reads each dim's ``direct_lag``
    attr); with ``true_phase`` the input is pre-multiplied by
    ``exp(+2i*pi*f*lag)``; frequency coordinates are sorted and validated to
    be centered on zero; output coordinates are the inverse grids shifted by
    the lag; ``true_amplitude`` divides by the product of output spacings.
    """
    dim = _norm_dim(daft, dim)

    if real is not None:
        real_dim = real
        warnings.warn(_real_flag_warning, FutureWarning)

    if engine == "hp":
        from .highprec import ifft_hp

        return ifft_hp(daft, spacing_tol, dim, real_dim, shift, true_phase,
                       true_amplitude, prefix, lag, chunks_to_segments)

    daft = _degrade_quad(daft)

    if real_dim is not None:
        if real_dim not in daft.dims:
            raise ValueError(
                "The dimension along which real IFT is taken must be one of "
                "the existing dimensions."
            )
        dim = _move_to_end(dim, real_dim)

    ce.check_valid_fft_coords(daft, dim)

    if lag is None:
        lag = [
            (daft.coords[d].attrs.get("direct_lag", 0.0) if d in daft.coords else 0.0)
            for d in dim
        ]
        msg = (
            "Default ifft's behaviour (lag=None) changed! Default value of "
            "lag was zero (centered output coordinates) and is now set to "
            "transformed coordinate's attribute: 'direct_lag'."
        )
        warnings.warn(msg, FutureWarning)
    else:
        if isinstance(lag, (float, int)):
            lag = [lag]
        if len(dim) != len(lag):
            raise ValueError("dim and lag must have the same length.")
        if not true_phase:
            warnings.warn(
                "Setting lag with true_phase=False does not guarantee "
                "accurate ifft.",
                Warning,
            )
        lag = [
            (daft.coords[d].attrs.get("direct_lag", 0.0) if d in daft.coords else 0.0)
            if l is None
            else l
            for d, l in zip(dim, lag)
        ]

    if true_phase:
        for d, l in zip(dim, lag):
            if float(l) == 0.0:
                continue  # exp(0) = 1: skip the identity multiply pass
            c = _dim_coord(daft, d)
            phase = carray.exp_i(2.0 * np.pi * c.values * float(l), like=daft.data)
            pl = LabeledArray(phase, dims=(d,),
                              coords={d: c} if d in daft.coords else None)
            daft = daft * pl

    if chunks_to_segments:
        daft = _stack_segments(daft, dim)

    rawdims = daft.dims

    if real_dim is not None:
        daft = daft.transpose(*_move_to_end(list(daft.dims), real_dim))

    axis_num = [daft.get_axis_num(d) for d in dim]
    N = [daft.shape[n] for n in axis_num]

    # sort by coordinates to handle fftshifted/unsorted grids (reference
    # /root/reference/xrft/xrft.py:598).  A frequency order that is a pure
    # cyclic roll of ascending order — natural fftfreq order being the
    # common case — never materializes a device pass: the sort roll
    # composes with the engine's absorbed input ifftshift into one static
    # roll, which for natural order is the identity.  Only arbitrary
    # permutations (and the one-sided real axis) fall back to a device
    # sortby.
    sort_rolls: dict[str, int] = {}
    device_sort = []
    for d in dim:
        if d not in daft.coords:
            continue
        v = daft.coords[d].values
        n_d = v.shape[0]
        order = np.argsort(v, kind="stable")
        if np.array_equal(order, np.arange(n_d)):
            continue
        k0 = int(order[0])
        if d != real_dim and np.array_equal(order, (np.arange(n_d) + k0) % n_d):
            sort_rolls[d] = k0
            # host-side reorder of every coordinate carrying d; the data
            # roll is deferred into the engine's pre-shift composition
            for cname, c in list(daft.coords.items()):
                if d in c.dims:
                    cax = c.dims.index(d)
                    daft = daft.assign_coords({cname: Coord(
                        c.dims, np.take(c.values, order, axis=cax),
                        c.attrs, cname)})
        else:
            device_sort.append(d)
    if device_sort:
        daft = daft.sortby(device_sort)

    delta_x = [
        ce.get_coordinate_spacing(_dim_coord(daft, d), spacing_tol) for d in dim
    ]
    for d in dim:
        c = _dim_coord(daft, d)
        l = ce.lag_coord(c) if d != real_dim else c.values[0]
        if np.abs(l) > spacing_tol:
            raise ValueError(
                "Inverse Fourier Transform can not be computed because "
                f"coordinate {d} is not centered on zero frequency"
            )

    # engine input-shift composition per non-real axis: the standard
    # absorbed ifftshift (roll by -(n//2)), composed with any deferred
    # sort roll (roll by -k0).  Total roll 0 -> nothing at all (natural
    # order); otherwise one explicit roll replaces the sortby pass.
    axis_shift = []
    extra_rolls = []
    for d in dim:
        if d == real_dim:
            continue
        ax = daft.get_axis_num(d)
        if d in sort_rolls:
            n_d = daft.shape[ax]
            amt = (-(sort_rolls[d] + n_d // 2)) % n_d
            if amt == 0:
                continue
            if amt == (-(n_d // 2)) % n_d:
                axis_shift.append(ax)  # exactly an ifftshift: free absorb
            else:
                extra_rolls.append((ax, amt if amt <= n_d // 2
                                    else amt - n_d))
        else:
            axis_shift.append(ax)
    if extra_rolls:
        data = daft.data
        for ax, amt in extra_rolls:
            data = carray.roll(data, amt, ax)
        daft = daft.copy(data=data)

    # output-shift composition: fftshift o ifftshift is the identity, so
    # only three cases remain; the engine absorbs them into its constants
    if true_phase and shift:
        post_axes, post_kind = axis_num, "fftshift"
    elif (not true_phase) and (not shift):
        post_axes, post_kind = axis_num, "ifftshift"
    else:
        post_axes, post_kind = (), "fftshift"

    kind = "ifft" if real_dim is None else "irfft"
    # both kinds forward the shifts for engine absorption (matmul: into
    # weight constants incl. the packed-irfft half-length roll; xla /
    # callable engines apply them explicitly inside the dispatch)
    f = _run_core(daft.data, axis_num, kind, engine,
                  pre_shift_axes=axis_shift, post_shift_axes=post_axes,
                  post_kind=post_kind)

    k = ce.ifreq_grids(N, delta_x, real_dim is not None, shift)

    swap = {d: ce.freq_dim_name(d, prefix) for d in dim}
    out_dims = [swap.get(d, d) for d in daft.dims]
    out_coords = {}
    for cname, c in daft.coords.items():
        if cname in dim:
            continue
        out_coords[cname] = c.copy()
    out_spacing = []
    for d, kk, l in zip(dim, k, lag):
        spacing = kk[1] - kk[0]
        out_spacing.append(spacing)
        out_coords[swap[d]] = Coord(
            (swap[d],), kk + l, {"spacing": spacing}, swap[d]
        )

    out = LabeledArray(f, dims=out_dims, coords=out_coords, name=daft.name)

    if true_amplitude:
        out = out / float(np.prod(out_spacing))

    out.name = daft.name
    return out.transpose(*[swap.get(d, d) for d in rawdims])


def dft(da, dim=None, true_phase=False, true_amplitude=False, **kwargs):
    """Deprecated alias of :func:`fft` with legacy phase/amplitude defaults
    (reference ``/root/reference/xrft/xrft.py:237-250``)."""
    warnings.warn(
        "This function has been renamed and will disappear in the future. "
        "Please use `fft` instead",
        FutureWarning,
    )
    return fft(da, dim=dim, true_phase=true_phase,
               true_amplitude=true_amplitude, **kwargs)


def idft(daft, dim=None, true_phase=False, true_amplitude=False, **kwargs):
    """Deprecated alias of :func:`ifft` with legacy phase/amplitude defaults
    (reference ``/root/reference/xrft/xrft.py:253-266``)."""
    warnings.warn(
        "This function has been renamed and will disappear in the future. "
        "Please use `ifft` instead",
        FutureWarning,
    )
    return ifft(daft, dim=dim, true_phase=true_phase,
                true_amplitude=true_amplitude, **kwargs)
