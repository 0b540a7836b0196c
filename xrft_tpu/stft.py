"""Short-time Fourier transform and its overlap-add inverse.

Beyond the reference (xrft stops at forward spectral estimates;
``/root/reference/xrft/xrft.py:106-136`` is its closest machinery — the
dask-chunk Welch segmenter), matching ``scipy.signal.stft`` /
``scipy.signal.istft`` semantics: hann analysis window, 50% overlap,
``boundary='zeros'`` half-window padding + tail padding so the signal is
fully covered, 'spectrum' (1/sum(w)) or 'psd' scaling, one-sided for
real input, and the NOLA-normalized weighted overlap-add inverse
``x[n] = sum_k w[n-kH] y_k[n-kH] / sum_k w^2[n-kH]``.

Shape: the forward rides the same strided slice-stack +
batched rfft route as the Welch/spectrogram estimators (one XLA
program, no gathers); the inverse's overlap-add uses a pure reshape
decomposition when ``hop | seglen`` (the scipy default — ``q =
seglen//hop`` shifted reshapes summed, bandwidth-bound adds) and a
``fori_loop`` of dynamic-slice accumulations otherwise.  The NOLA
normalization ``sum_k w^2[n-kH]`` is a host-precomputed constant baked
into the jaxpr.

The STFT result carries everything its inverse needs in ``attrs``
(seglen/hop/window/boundary/scaling/n_orig), so ``istft(stft(x))``
round-trips exactly without re-specifying parameters.
"""

from __future__ import annotations

import warnings

import jax
import jax.numpy as jnp
import numpy as np

from . import coords as ce
from .labeled import Coord, LabeledArray
from .ops import carray
from .spectra import _is_real_input, _norm_1d_dim, _stft_plan
from .transform import _dim_coord, fft, ifft

__all__ = ["stft", "istft"]


def _win1d(window, n) -> np.ndarray:
    import scipy.signal as sps

    from .ops.window import WINDOW_TYPES

    if window is True:
        window = "hann"
    if window not in WINDOW_TYPES:
        raise NotImplementedError(
            f"Window type {window} not supported. Please adhere to "
            "scipy.signal.windows for naming convention."
        )
    return np.asarray(getattr(sps.windows, window)(n, sym=False),
                      np.float64)


def stft(da, dim=None, seglen=256, segment_overlap=None, window="hann",
         real_dim="auto", boundary="zeros", padded=True,
         scaling="spectrum", **kwargs) -> LabeledArray:
    """Short-time Fourier transform — scipy.signal.stft semantics.

    ``segment_overlap=None`` means scipy's ``nperseg // 2``;
    ``boundary='zeros'`` (default) pads ``seglen//2`` zeros on both ends
    so the first/last samples sit at window centers, and ``padded=True``
    zero-extends the tail so every sample lands in an integer number of
    segments (together these make the transform exactly invertible —
    scipy's defaults).  ``scaling='spectrum'`` divides by ``sum(w)``
    ('psd': by ``sqrt(fs * sum(w^2))``).  Returns a complex LabeledArray
    over ``(<dim>_segment, freq_<dim>)`` with segment-center coordinates
    (scipy's ``t``) and the inversion parameters recorded in ``attrs``.
    """
    dim = _norm_1d_dim(da, dim, "stft")
    if real_dim == "auto":
        real_dim = dim if _is_real_input(da) else None

    coord = _dim_coord(da, dim)
    ce.get_coordinate_spacing(coord, kwargs.pop("spacing_tol", 1e-3))
    dx = float(ce.diff_coord(coord)[0])
    n_orig = da.sizes[dim]

    # resolve the overlap the way the plan would, to compute padding
    seglen = int(seglen)
    if seglen > n_orig and boundary is None and not padded:
        warnings.warn(
            f"seglen = {seglen} is greater than input length = {n_orig}, "
            f"using seglen = {n_orig}"
        )
        seglen = n_orig
    ov = segment_overlap
    if ov is None:
        ov = seglen // 2
    if isinstance(ov, float):
        if not 0.0 <= ov < 1.0:
            raise ValueError(
                f"fractional segment_overlap must be in [0, 1), got {ov}"
            )
        ov = int(round(ov * seglen))
    hop = seglen - ov

    pad_pre = seglen // 2 if boundary == "zeros" else 0
    if boundary not in (None, "zeros"):
        raise ValueError(f"boundary must be None or 'zeros', got "
                         f"{boundary!r}")
    n_ext = n_orig + 2 * pad_pre
    if padded:
        nseg = max(int(np.ceil(max(n_ext - seglen, 0) / hop)) + 1, 1)
        n_full = (nseg - 1) * hop + seglen
    else:
        n_full = n_ext
    pad_post = n_full - n_orig - pad_pre
    if pad_pre or pad_post > 0:
        from .spectra import _zero_pad_to

        if pad_pre:
            from .padding import pad as _pad

            da = _pad(da, {dim: (pad_pre, max(pad_post, 0))},
                      mode="constant")
            da.coords[dim].attrs.pop("pad_width", None)
        elif pad_post > 0:
            da = _zero_pad_to(da, dim, n_orig + pad_post)

    da, dim, seglen, ov = _stft_plan(da, dim, seglen, ov, 2, "stft")
    hop = seglen - ov

    ft = fft(da, dim=[dim], real_dim=real_dim, true_phase=False,
             true_amplitude=False, shift=False, chunks_to_segments=True,
             segment_overlap={dim: ov} if ov else None, window=window,
             **kwargs)

    w = _win1d(window, seglen)
    if scaling == "spectrum":
        s = 1.0 / w.sum()
    elif scaling == "psd":
        s = 1.0 / np.sqrt((1.0 / dx) * (w**2).sum())
    else:
        raise ValueError(f"scaling must be 'spectrum' or 'psd', got "
                         f"{scaling!r}")
    sj = jnp.float32(s)
    out = ft.copy(data=carray._map(ft.data, lambda v: v * sj))

    segdim = dim + "_segment"
    nseg_out = out.sizes[segdim]
    vals = np.asarray(coord.values)
    t0 = float(vals.ravel()[0]) if vals.dtype.kind in "fiu" else 0.0
    offset0 = 0.0 if pad_pre else seglen / 2.0
    centers = t0 + (np.arange(nseg_out) * hop + offset0) * dx
    out = out.assign_coords(
        {segdim: Coord(segdim, centers, attrs={"spacing": hop * dx},
                       name=segdim)})
    out.attrs.update({
        "stft_dim": dim, "stft_seglen": seglen, "stft_hop": hop,
        "stft_window": window if window is not True else "hann",
        "stft_boundary": pad_pre, "stft_scaling": scaling,
        "stft_n_orig": n_orig, "stft_dx": dx, "stft_t0": t0,
    })
    out.name = f"{da.name}_stft" if da.name else None
    return out


def _overlap_add(segs, hop: int, n_full: int):
    """(…, nseg, seglen) -> (…, n_full) weighted segments summed at
    ``hop`` spacing.  Pure-reshape decomposition when hop | seglen
    (q = seglen//hop shifted reshapes, each a bandwidth-bound copy);
    sequential fori_loop of dynamic-slice adds otherwise."""
    *batch, nseg, seglen = segs.shape
    out_shape = tuple(batch) + (n_full,)
    if seglen % hop == 0:
        q = seglen // hop
        out = jnp.zeros(out_shape, segs.dtype)
        for j in range(q):
            part = segs[..., j * hop:(j + 1) * hop]
            flat = part.reshape(tuple(batch) + (nseg * hop,))
            pad = [(0, 0)] * len(batch) + [
                (j * hop, n_full - j * hop - nseg * hop)]
            out = out + jnp.pad(flat, pad)
        return out

    def body(k, acc):
        start = k * hop
        cur = jax.lax.dynamic_slice_in_dim(acc, start, seglen, axis=-1)
        seg = jax.lax.dynamic_index_in_dim(segs, k, axis=-2,
                                           keepdims=False)
        return jax.lax.dynamic_update_slice_in_dim(
            acc, cur + seg, start, axis=-1)

    return jax.lax.fori_loop(0, nseg, body,
                             jnp.zeros(out_shape, segs.dtype))


def istft(Zxx: LabeledArray, dim=None, seglen=None, segment_overlap=None,
          window=None, boundary=None, scaling=None,
          input_onesided=None) -> LabeledArray:
    """Inverse STFT — scipy.signal.istft's NOLA-normalized weighted
    overlap-add.  Parameters default to the ``attrs`` :func:`stft`
    recorded, so ``istft(stft(x))`` round-trips with no arguments; pass
    them explicitly for foreign STFTs.  Raises if the window/hop pair
    fails the NOLA invertibility condition (like scipy)."""
    at = Zxx.attrs
    d = dim or at.get("stft_dim")
    if d is None:
        segdims = [x[: -len("_segment")] for x in Zxx.dims
                   if x.endswith("_segment")]
        if len(segdims) != 1:
            raise ValueError(
                "istft needs dim=: could not infer a unique segment dim "
                f"from {Zxx.dims}"
            )
        d = segdims[0]
    segdim, fdim = d + "_segment", f"freq_{d}"
    if segdim not in Zxx.dims or fdim not in Zxx.dims:
        raise ValueError(
            f"istft expects dims ({segdim!r}, {fdim!r}); got {Zxx.dims}"
        )
    nf = Zxx.sizes[fdim]
    if input_onesided is None:
        # recorded seglen disambiguates; scipy's default otherwise
        input_onesided = (at["stft_seglen"] != nf
                          if "stft_seglen" in at else True)
    seglen = int(seglen or at.get("stft_seglen")
                 or (2 * (nf - 1) if input_onesided else nf))
    one_sided = seglen != nf
    if segment_overlap is None:
        hop = int(at.get("stft_hop") or seglen // 2)
    else:
        ov = segment_overlap
        if isinstance(ov, float):
            ov = int(round(ov * seglen))
        hop = seglen - ov
    window = window or at.get("stft_window", "hann")
    scaling = scaling or at.get("stft_scaling", "spectrum")
    pad_pre = int(at.get("stft_boundary", 0)) if boundary is None \
        else (seglen // 2 if boundary == "zeros" else 0)
    n_orig = at.get("stft_n_orig")
    dx = at.get("stft_dx")
    if dx is None:
        # foreign STFT: recover the sample spacing from the frequency
        # grid (df = 1 / (seglen * dx), valid for any DFT convention)
        if fdim in Zxx.coords:
            df = ce.get_coordinate_spacing(Zxx.coords[fdim], 1e-3)
            dx = 1.0 / (seglen * float(df))
        else:
            dx = 1.0
    dx = float(dx)
    t0 = float(at.get("stft_t0", 0.0))

    w = _win1d(window, seglen)
    nseg = Zxx.sizes[segdim]
    n_full = (nseg - 1) * hop + seglen

    # NOLA check + normalization sum_k w^2[n - kH]: host constants
    norm = np.zeros(n_full)
    for k in range(nseg):
        norm[k * hop:k * hop + seglen] += w**2
    lo = pad_pre
    hi = n_full - max(n_full - (n_orig if n_orig is not None else n_full)
                      - pad_pre, 0)
    if np.min(norm[lo:hi]) <= 1e-10:
        raise ValueError(
            "NOLA condition failed: this window/hop pair is not "
            "invertible (scipy.signal.check_NOLA)"
        )
    norm = np.where(norm > 1e-10, norm, 1.0)

    # undo the forward scaling
    if scaling == "spectrum":
        s = w.sum()
    elif scaling == "psd":
        s = np.sqrt((1.0 / dx) * (w**2).sum())
    else:
        raise ValueError(f"scaling must be 'spectrum' or 'psd', got "
                         f"{scaling!r}")
    sjz = jnp.float32(s)
    Z = Zxx.copy(data=carray._map(Zxx.data, lambda v: v * sjz))
    Z.attrs = {}

    # per-segment inverse transform (segment axis rides as batch);
    # one-sided input -> real series, two-sided -> complex series.
    # true_phase=True + lag=0 is the PLAIN inverse DFT: no output
    # ifftshift (the reference's tp=False semantics would roll the
    # reconstructed segments by seglen//2,
    # /root/reference/xrft/xrft.py:617-618)
    if one_sided and seglen % 2 == 1:
        # odd seglen (fuzz find): the real inverse is even-length-only
        # (reference irfftn semantics, /root/reference/xrft/xrft.py:604),
        # which would reconstruct 2*(nf-1) != seglen samples.  Match
        # scipy's irfft(X, n=seglen) by Hermitian-extending the half
        # spectrum to the full circle (one static slice+flip+concat) and
        # running the complex inverse; the natural-order fftfreq coord
        # keeps the sortby absorbed (zero extra device passes).
        ax = Z.get_axis_num(fdim)
        tail = carray.conj(carray.flip(carray._map(
            Z.data, lambda v: jax.lax.slice_in_dim(v, 1, nf, axis=ax)),
            ax))
        full = carray.concatenate([Z.data, tail], ax)
        fullc = Coord((fdim,), np.fft.fftfreq(seglen, dx),
                      {"spacing": 1.0 / (seglen * dx)}, fdim)
        zc = {k: c.copy() for k, c in Z.coords.items()
              if fdim not in c.dims}
        zc[fdim] = fullc
        Zf = LabeledArray(full, dims=Z.dims, coords=zc, name=Z.name)
        back = ifft(Zf, dim=[fdim], real_dim=None, true_phase=True,
                    true_amplitude=False, shift=False, lag=[0.0])
        back = back.copy(data=carray.real(back.data))
    else:
        back = ifft(Z, dim=[fdim], real_dim=fdim if one_sided else None,
                    true_phase=True, true_amplitude=False, shift=False,
                    lag=[0.0])

    # apply the synthesis window, overlap-add, normalize
    wj = jnp.asarray(w.astype(np.float32))
    # move (segdim, d) to the trailing two axes for the overlap-add
    order = [x for x in back.dims if x not in (segdim, d)] + [segdim, d]
    arr = back.transpose(*order)
    segs = carray._map(arr.data, lambda v: v * wj)
    summed = carray._map(segs, lambda v: _overlap_add(v, hop, n_full))
    normj = jnp.asarray((1.0 / norm).astype(np.float32))
    x_full = carray._map(summed, lambda v: v * normj)

    start = pad_pre
    stop = pad_pre + (n_orig if n_orig is not None else n_full - pad_pre)
    stop = min(stop, n_full)
    x_data = carray._map(
        x_full, lambda v: jax.lax.slice_in_dim(v, start, stop, axis=-1))

    n_out = stop - start
    out_dims = [x for x in back.dims if x not in (segdim, d)] + [d]
    coords = {k: c.copy() for k, c in Zxx.coords.items()
              if segdim not in c.dims and fdim not in c.dims}
    coords[d] = Coord((d,), t0 + np.arange(n_out) * dx,
                      {"spacing": dx}, d)
    name = Zxx.name
    if name and name.endswith("_stft"):
        name = name[: -len("_stft")] or None
    return LabeledArray(x_data, dims=out_dims, coords=coords, name=name)
