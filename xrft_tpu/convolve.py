"""FFT-based N-D convolution and cross-correlation along named dims.

Beyond the reference (xrft has no convolution; its surface stops at
spectral estimates, ``/root/reference/xrft/xrft.py:17-29``) — matching
``scipy.signal.fftconvolve`` / ``scipy.signal.correlate(method='fft')``
semantics: linear convolution by the convolution theorem with ``full``/
``same``/``valid`` output cropping, real-in/real-out, and correlation as
convolution with the conjugate-reversed second operand.

Shape: both operands are zero-padded to the next power of two
>= ``n1 + n2 - 1`` per dim (the engine's fastest plan), transformed with
ONE multi-axis engine fft each, multiplied, and inverse-transformed —
three engine transforms total regardless of ndim, all static shapes,
jit-traceable end to end.  The crop offsets are
host constants.

Coordinate-aware beyond scipy: when both operands carry valid equispaced
coordinates with matching spacing on a transform dim, the output carries
the physically meaningful grid — support ``x0 + y0 + k*dx`` for
convolution, lag ``x0 - y0 + (k - (n2-1))*dx`` for correlation
(mode-cropped consistently) — so ``correlate(x, x)`` peaks at lag 0.
"""

from __future__ import annotations

import numpy as np

from . import coords as ce
from .labeled import Coord, LabeledArray
from .ops import carray, fft_core

__all__ = ["convolve", "fftconvolve", "oaconvolve", "correlate",
           "choose_conv_method"]


def _norm_dims(da, db, dims, caller):
    if dims is None:
        out = [d for d in da.dims if d in db.dims]
        if not out:
            raise ValueError(f"{caller}: the operands share no dims")
        return out
    if isinstance(dims, str):
        dims = [dims]
    dims = list(dims)
    for d in dims:
        if d not in da.dims or d not in db.dims:
            raise ValueError(
                f"{caller}: dim {d!r} must be present in both operands")
    return dims


def _align_second(da, db, caller):
    """Return db's data permuted/expanded to da's dim order (size-1 axes
    for dims db lacks).  Extra dims in db are not allowed."""
    extra = [d for d in db.dims if d not in da.dims]
    if extra:
        raise ValueError(
            f"{caller}: second operand has dims {extra} not present in "
            "the first; transpose/rename it first")
    perm = [db.dims.index(d) for d in da.dims if d in db.dims]
    data = carray.transpose(db.data, perm) if perm != list(
        range(len(perm))) else db.data
    shape = [db.sizes[d] if d in db.dims else 1 for d in da.dims]
    return carray.reshape(data, shape)


def _crop_window(mode, n1, n2, caller):
    """Start offset and length of the mode crop of the full (n1+n2-1)
    linear result, per scipy.signal conventions."""
    full = n1 + n2 - 1
    if mode == "full":
        return 0, full
    if mode == "same":
        return (full - n1) // 2, n1
    if mode == "valid":
        return min(n1, n2) - 1, max(n1, n2) - min(n1, n2) + 1
    raise ValueError(
        f"{caller}: mode must be 'full', 'same' or 'valid', got {mode!r}")


def _fft_convolve(u, v, axes, sizes1, sizes2, engine):
    """ifft(fft(u)*fft(v)) zero-padded to the next power of two >=
    n1+n2-1 per axis; returns the padded result (crop at the caller)."""
    pad_u = [(0, 0)] * u.ndim
    pad_v = [(0, 0)] * v.ndim
    for ax, n1, n2 in zip(axes, sizes1, sizes2):
        L = 1 << int(np.ceil(np.log2(max(n1 + n2 - 1, 1))))
        pad_u[ax] = (0, L - n1)
        pad_v[ax] = (0, L - v.shape[ax])
    U = fft_core.fftn(carray.pad(u, pad_u), axes, engine=engine)
    V = fft_core.fftn(carray.pad(v, pad_v), axes, engine=engine)
    return fft_core.ifftn(carray.multiply(U, V), axes, engine=engine)


def _conv_like(da, db, dims, mode, engine, caller, reverse):
    dims = _norm_dims(da, db, dims, caller)
    axes = [da.dims.index(d) for d in dims]
    sizes1 = [da.sizes[d] for d in dims]
    sizes2 = [db.sizes[d] for d in dims]
    for d, n in zip(dims, sizes2):
        if d in db.coords and db.coords[d].values.shape[0] != n:
            raise ValueError(f"{caller}: inconsistent coord on {d!r}")
    for d in da.dims:
        if d in db.dims and d not in dims and da.sizes[d] != db.sizes[d]:
            raise ValueError(
                f"{caller}: non-transform dim {d!r} has mismatched sizes "
                f"{da.sizes[d]} != {db.sizes[d]}")
    if mode == "valid" and not (all(a >= b for a, b in zip(sizes1, sizes2))
                                or all(b >= a
                                       for a, b in zip(sizes1, sizes2))):
        raise ValueError(
            f"{caller}: for mode='valid' one operand must be at least as "
            "large as the other in every transform dim")

    real_out = (not carray.is_complex(da.data)
                and not carray.is_complex(db.data))
    v = _align_second(da, db, caller)
    if reverse:
        v = carray.conj(carray.flip(v, tuple(axes))) \
            if carray.is_complex(v) else carray.flip(v, tuple(axes))
    y = _fft_convolve(da.data, v, axes, sizes1, sizes2, engine)

    key = [slice(None)] * y.ndim
    starts = {}
    for ax, d, n1, n2 in zip(axes, dims, sizes1, sizes2):
        start, length = _crop_window(mode, n1, n2, caller)
        key[ax] = slice(start, start + length)
        starts[d] = (start, length)
    y = carray.getitem(y, tuple(key))
    if real_out:
        y = carray.real(y)

    coords = _conv_coords(da, db, dims, sizes2, starts, reverse)
    return LabeledArray(y, dims=list(da.dims), coords=coords,
                        attrs=dict(da.attrs), name=da.name)


def _conv_coords(da, db, dims, sizes2, starts, reverse):
    """Output coords: pass-through off-transform coords plus, where both
    operands carry matching-spacing numeric grids, the physical support
    (convolution) or lag (correlation) grid."""
    coords = {k: c.copy() for k, c in da.coords.items()
              if not any(d in c.dims for d in dims)}
    for d, n2 in zip(dims, sizes2):
        start, length = starts[d]
        ca, cb = da.coords.get(d), db.coords.get(d)
        if (ca is not None and cb is not None
                and ce.is_valid_fft_coord(ca) and ce.is_valid_fft_coord(cb)
                and np.issubdtype(np.asarray(ca.values).dtype, np.number)
                and np.issubdtype(np.asarray(cb.values).dtype, np.number)):
            # a single-point operand has no spacing of its own: it lies
            # on any grid, so the other operand's spacing rules (fuzz
            # find: size-1 kernels crashed on diff of an empty array)
            na = np.asarray(ca.values).shape[0]
            nb = np.asarray(cb.values).shape[0]
            dxa = ce.diff_coord(ca)[0] if na > 1 else None
            dxb = ce.diff_coord(cb)[0] if nb > 1 else None
            dx = dxa if dxa is not None else dxb
            if dx is not None and (dxa is None or dxb is None
                                   or np.isclose(dxa, dxb, rtol=1e-6)):
                x0 = np.asarray(ca.values).flat[0]
                y0 = np.asarray(cb.values).flat[0]
                if reverse:  # correlation lag: x grid minus y grid
                    origin = x0 - y0 - (n2 - 1) * dx
                else:  # convolution support: sum of the grids' origins
                    origin = x0 + y0
                coords[d] = Coord(
                    (d,), origin + (start + np.arange(length)) * dx,
                    {"spacing": dx}, d)
    return coords


def fftconvolve(da, db, dims=None, mode="full", engine=None) -> LabeledArray:
    """N-D linear convolution of ``da`` with ``db`` along ``dims``
    (default: all shared dims) — ``scipy.signal.fftconvolve``.  ``db``'s
    dims must be a subset of ``da``'s; missing dims broadcast.  ``mode``
    is scipy's ``full`` (n1+n2-1) / ``same`` (n1, centered) / ``valid``
    (no-edge overlap).  Real inputs give real output.  When both operands
    have matching-spacing coordinates on a dim, the output coordinate is
    the convolution support grid ``x0 + y0 + k*dx``; otherwise the dim is
    index-based (coords dropped), like scipy.
    """
    return _conv_like(da, db, dims, mode, engine, "fftconvolve",
                      reverse=False)


def oaconvolve(da, db, dims=None, mode="full", engine=None) -> LabeledArray:
    """Overlap-add linear convolution of ``da`` with ``db`` along ONE dim
    — ``scipy.signal.oaconvolve``: identical values to
    :func:`fftconvolve`, but a long signal convolved with a short kernel
    is split into blocks of length ``step = nfft - (n2-1)`` and each
    block is transformed at the small size ``nfft`` instead of the full
    next-pow2 of ``n1+n2-1`` — O(n1 log n2) work and O(n1) memory.

    Shape: the blocks become a leading batch axis for one batched engine
    FFT (instead of a giant transform), the kernel's FFT is computed once and broadcast, and the
    overlap-add is two static slices + one add (block ``k``'s tail lands
    exactly in block ``k+1``'s head because ``step >= n2-1`` by
    construction) — no scatter, no dynamic shapes, jit-traceable.

    ``dims`` must resolve to a single dim (scipy's N-D overlap-add
    blocks every axis; for N-D use :func:`fftconvolve`, which this
    function falls back to when the kernel is not much shorter than the
    signal, like scipy falls back on equal shapes).  Modes, kernel
    broadcasting, and coordinate-aware output grids match
    :func:`fftconvolve`.
    """
    dims_l = _norm_dims(da, db, dims, "oaconvolve")
    if len(dims_l) != 1:
        raise ValueError(
            "oaconvolve blocks a single long dim; got "
            f"dims={dims_l!r} (use fftconvolve for N-D convolution)")
    d = dims_l[0]
    ax = da.dims.index(d)
    n1, n2 = da.sizes[d], db.sizes[d]
    # validate before any device work, mirroring _conv_like: a stale
    # kernel coordinate of the wrong length must raise (not silently
    # corrupt the output grid), and a bad mode string must not wait for
    # the post-transform crop to be rejected
    _crop_window(mode, n1, n2, "oaconvolve")
    if d in db.coords and db.coords[d].values.shape[0] != n2:
        raise ValueError(f"oaconvolve: inconsistent coord on {d!r}")
    for dd in da.dims:
        if dd in db.dims and dd != d and da.sizes[dd] != db.sizes[dd]:
            raise ValueError(
                f"oaconvolve: non-transform dim {dd!r} has mismatched "
                f"sizes {da.sizes[dd]} != {db.sizes[dd]}")

    full = n1 + n2 - 1
    nfft = 1 << int(np.ceil(np.log2(max(8 * (n2 - 1), 256))))
    if n2 <= 1 or nfft >= (1 << int(np.ceil(np.log2(max(full, 1))))):
        # kernel not much shorter than the signal (or trivial): the
        # single full-size transform is cheaper — scipy's fallback
        return _conv_like(da, db, dims_l, mode, engine, "oaconvolve",
                          reverse=False)
    step = nfft - (n2 - 1)
    nb = -(-n1 // step)

    real_out = (not carray.is_complex(da.data)
                and not carray.is_complex(db.data))
    v = _align_second(da, db, "oaconvolve")
    x = carray.moveaxis(da.data, ax, -1)
    v = carray.moveaxis(v, ax, -1)

    # kernel spectrum, computed once at the block size
    pad_v = [(0, 0)] * v.ndim
    pad_v[-1] = (0, nfft - n2)
    v = carray.pad(v, pad_v)
    v = carray.reshape(v, list(v.shape[:-1]) + [1, nfft])  # block axis
    if real_out:
        V = fft_core.rfftn(v, [-1], engine=engine)
    else:
        V = fft_core.fftn(v, [-1], engine=engine)

    # signal blocks [..., nb, step] zero-padded to [..., nb, nfft]
    pad_x = [(0, 0)] * x.ndim
    pad_x[-1] = (0, nb * step - n1)
    x = carray.pad(x, pad_x)
    x = carray.reshape(x, list(x.shape[:-1]) + [nb, step])
    pad_b = [(0, 0)] * x.ndim
    pad_b[-1] = (0, nfft - step)
    x = carray.pad(x, pad_b)
    if real_out:
        y = fft_core.irfftn(
            carray.multiply(fft_core.rfftn(x, [-1], engine=engine), V),
            [-1], engine=engine)
    else:
        y = fft_core.ifftn(
            carray.multiply(fft_core.fftn(x, [-1], engine=engine), V),
            [-1], engine=engine)

    # overlap-add: block k's tail (n2-1 <= step wide) lands in block
    # k+1's head — append one zero block to hold the final tail
    nd = y.ndim
    sl = [slice(None)] * nd
    sl[-1] = slice(0, step)
    heads = carray.getitem(y, tuple(sl))
    sl[-1] = slice(step, nfft)
    tails = carray.getitem(y, tuple(sl))
    pad_t = [(0, 0)] * nd
    pad_t[-1] = (0, step - (nfft - step))
    tails = carray.pad(tails, pad_t)
    zshape = list(heads.shape)
    zshape[-2] = 1
    zdt = heads.re.dtype if carray.is_pair(heads) else heads.dtype
    zero = carray.constant(np.zeros(zshape, dtype=zdt), heads)
    heads = carray.concatenate([heads, zero], axis=-2)
    tails = carray.concatenate([zero, tails], axis=-2)
    out = (carray.ComplexPair(heads.re + tails.re, heads.im + tails.im)
           if carray.is_pair(heads) else heads + tails)
    out = carray.reshape(out, zshape[:-2] + [(nb + 1) * step])

    start, length = _crop_window(mode, n1, n2, "oaconvolve")
    sl = [slice(None)] * (nd - 1)
    sl[-1] = slice(start, start + length)
    out = carray.getitem(out, tuple(sl))
    if real_out:
        out = carray.real(out)
    out = carray.moveaxis(out, -1, ax)

    coords = _conv_coords(da, db, [d], [n2], {d: (start, length)},
                          reverse=False)
    return LabeledArray(out, dims=list(da.dims), coords=coords,
                        attrs=dict(da.attrs), name=da.name)


def correlate(da, db, dims=None, mode="full", engine=None,
              method="fft") -> LabeledArray:
    """N-D cross-correlation ``sum da[t+k] * conj(db[t])`` along ``dims``
    — ``scipy.signal.correlate``: convolution with the conjugate-reversed
    second operand.  ``method`` is scipy's: ``'fft'`` (default here, the
    historical behavior), ``'direct'`` (one ``conv_general_dilated``
    — no padded transforms; see :func:`convolve`), or ``'auto'``
    (:func:`choose_conv_method`).  With matching-spacing coordinates the
    output carries the physical lag grid ``x0 - y0 + (k-(n2-1))*dx``
    (``correlate(x, x)`` peaks at lag 0); otherwise index-based, like
    scipy.
    """
    return _method_dispatch(da, db, dims, mode, engine, method,
                            "correlate", reverse=True)


# ---------------------------------------------------------------------------
# Direct method — scipy.signal.convolve/correlate(method='direct'),
# computed as ONE lax.conv_general_dilated (cuDNN on a GPU) instead of
# three padded engine transforms.  A small kernel over a large field is a
# dense contraction of the kernel window; the FFT route must pad both
# operands to the next power of two >= n1+n2-1 per dim (4x the field area
# in 2-D) and stream three full transforms through device memory.  scipy analogue:
# _signaltools.convolve's method dispatch.
# ---------------------------------------------------------------------------


def _direct_eligible(da, db, dims, mode, sizes1, sizes2):
    """Static eligibility of the direct path (None = reason it is not)."""
    if any(d not in dims for d in db.dims):
        return "the kernel has non-transform (batch) dims"
    if any(n2 > n1 for n1, n2 in zip(sizes1, sizes2)):
        return "the kernel is larger than the data on a transform dim"
    return None


def _direct_conv(da, db, dims, mode, caller, reverse):
    """mode-cropped linear convolution/correlation via ONE
    ``lax.conv_general_dilated`` (cross-correlation semantics: the kernel
    is flipped host-side for convolution, conjugated for correlation).
    Caller guarantees :func:`_direct_eligible`."""
    import jax.numpy as jnp
    from jax import lax

    axes = [da.dims.index(d) for d in dims]
    sizes1 = [da.sizes[d] for d in dims]
    sizes2 = [db.sizes[d] for d in dims]
    for d, n in zip(dims, sizes2):
        if d in db.coords and db.coords[d].values.shape[0] != n:
            raise ValueError(f"{caller}: inconsistent coord on {d!r}")

    # per-axis (lo, hi) zero padding reproducing scipy's mode crops of
    # the full linear result: full -> (n2-1, n2-1); same -> the centered
    # window (lo = n2//2 so output k == full[k + (n2-1)//2]); valid -> 0
    pads = []
    starts = {}
    for d, n1, n2 in zip(dims, sizes1, sizes2):
        start, length = _crop_window(mode, n1, n2, caller)
        starts[d] = (start, length)
        if mode == "full":
            pads.append((n2 - 1, n2 - 1))
        elif mode == "same":
            pads.append((n2 // 2, (n2 - 1) // 2))
        else:
            pads.append((0, 0))

    real_out = (not carray.is_complex(da.data)
                and not carray.is_complex(db.data))

    # kernel to `dims` order; flip for convolution (conv_general_dilated
    # does not reverse), conjugate for correlation
    perm = [db.dims.index(d) for d in dims]
    v = carray.transpose(db.data, perm) if perm != list(range(len(perm))) \
        else db.data
    if not reverse:
        v = carray.flip(v, tuple(range(len(dims))))
    elif carray.is_complex(v):
        v = carray.conj(v)

    nb = da.data.ndim - len(axes)
    bperm = [q for q in range(da.data.ndim) if q not in axes] + axes
    inv = list(np.argsort(bperm))

    def conv1(u_real, v_real):
        ub = jnp.transpose(u_real, bperm)
        bshape = ub.shape[:nb]
        lhs = ub.reshape((max(int(np.prod(bshape)), 1), 1) + ub.shape[nb:])
        rhs = v_real.reshape((1, 1) + tuple(v_real.shape))
        o = lax.conv_general_dilated(
            lhs, rhs, window_strides=(1,) * len(axes), padding=pads,
            precision=lax.Precision.HIGHEST)
        o = o.reshape(bshape + o.shape[2:])
        return jnp.transpose(o, inv)

    ur, ui = carray.real(da.data), carray.imag(da.data)
    vr, vi = carray.real(v), carray.imag(v)
    cplx_u = carray.is_complex(da.data)
    cplx_v = carray.is_complex(db.data)
    rr = conv1(ur, vr)
    if real_out:
        y = rr
    else:
        re = rr - (conv1(ui, vi) if (cplx_u and cplx_v) else 0.0)
        im = (conv1(ur, vi) if cplx_v else 0.0) \
            + (conv1(ui, vr) if cplx_u else 0.0)
        y = (carray.ComplexPair(re, im) if carray.is_pair(da.data)
             or carray.is_pair(db.data) else re + 1j * im)

    coords = _conv_coords(da, db, dims, sizes2, starts, reverse)
    return LabeledArray(y, dims=list(da.dims), coords=coords,
                        attrs=dict(da.attrs), name=da.name)


def _method_dispatch(da, db, dims, mode, engine, method, caller, reverse):
    dims_l = _norm_dims(da, db, dims, caller)
    sizes1 = [da.sizes[d] for d in dims_l]
    sizes2 = [db.sizes[d] for d in dims_l]
    if method == "auto":
        method = choose_conv_method(da, db, dims=dims_l, mode=mode)
    if method == "direct":
        why = _direct_eligible(da, db, dims_l, mode, sizes1, sizes2)
        if why is not None:
            raise ValueError(
                f"{caller}: method='direct' is unavailable here ({why}); "
                "use method='fft'")
        # (the fft path's non-transform-dim size check is unreachable
        # here: a kernel with a shared batch dim is already ineligible)
        return _direct_conv(da, db, dims_l, mode, caller, reverse)
    if method != "fft":
        raise ValueError(
            f"{caller}: method must be 'auto', 'direct' or 'fft', "
            f"got {method!r}")
    return _conv_like(da, db, dims_l, mode, engine, caller, reverse)


def choose_conv_method(da, db, dims=None, mode="full",
                       measure=False) -> str:
    """Pick ``'direct'`` or ``'fft'`` for :func:`convolve` /
    :func:`correlate` — ``scipy.signal.choose_conv_method``, with an
    accelerator cost model instead of scipy's CPU constants: the direct
    method's work is ``prod(n_out) * prod(n2)`` MACs of one dense
    contraction, the fft method streams three padded transforms through
    device memory, so small kernels over large fields favor direct up to
    ``config.direct_conv_max`` kernel elements (chip_smoke.py prints
    both routes' times at 4096^2 with a 63^2 kernel).  ``measure=True`` times both compiled
    methods on the actual operands and returns the faster (like scipy).
    """
    from .config import config

    dims_l = _norm_dims(da, db, dims, "choose_conv_method")
    sizes1 = [da.sizes[d] for d in dims_l]
    sizes2 = [db.sizes[d] for d in dims_l]
    if _direct_eligible(da, db, dims_l, mode, sizes1, sizes2) is not None:
        return "fft"
    if measure:
        import time

        import jax

        best, best_ms = "fft", np.inf
        for m in ("fft", "direct"):
            f = jax.jit(lambda x, meth=m: _method_dispatch(
                da.copy(data=x), db, dims_l, mode, None, meth,
                "choose_conv_method", False).data)
            try:
                jax.block_until_ready(f(da.data))  # compile + warm
                t0 = time.perf_counter()
                np.asarray(carray.real(f(da.data)))  # forced transfer
                ms = (time.perf_counter() - t0) * 1e3
            except Exception:
                continue
            if ms < best_ms:
                best, best_ms = m, ms
        return best
    return "direct" if int(np.prod(sizes2)) <= config.direct_conv_max \
        else "fft"


def convolve(da, db, dims=None, mode="full", method="auto",
             engine=None) -> LabeledArray:
    """N-D linear convolution along named dims with method dispatch —
    ``scipy.signal.convolve``: ``method='fft'`` routes to
    :func:`fftconvolve`; ``method='direct'`` computes the mode-cropped
    sum directly as ONE ``lax.conv_general_dilated`` (no padded
    transforms; a 63x63 kernel over a 4096^2 field pays 3 transforms of
    8192^2 on the fft route);
    ``method='auto'`` picks via :func:`choose_conv_method`.  Modes,
    kernel broadcasting over batch dims (fft method; direct requires a
    transform-dims-only kernel and raises otherwise), real/complex
    kinds, and coordinate-aware output grids match :func:`fftconvolve`.
    """
    return _method_dispatch(da, db, dims, mode, engine, method,
                            "convolve", reverse=False)
