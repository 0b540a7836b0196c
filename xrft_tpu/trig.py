"""Real trigonometric transforms: DCT/DST types I-IV (scipy.fft namesakes).

Beyond the reference (xrft exposes only Fourier transforms,
``/root/reference/xrft/xrft.py:17-29``; no cosine/sine family) — matching
``scipy.fft.dct/idct/dst/idst`` semantics: types 1-4, ``norm`` in
{None/'backward', 'ortho', 'forward'}, same-length real output, and the
scipy inverse pairings (1<->1, 2<->3, 4<->4).

Shape: every type rides the cross-validated engine dispatch in
:mod:`.ops.fft_core` rather than a dedicated cosine kernel —

* **DCT-I / DST-I**: even / odd extension (a host-static gather) and one
  length ``2N-2`` / ``2N+2`` FFT; the real / imaginary plane of the result
  is the transform.
* **DCT-II**: Makhoul's permutation — FFT of ``x[0::2] ++ reversed(x[1::2])``
  followed by a half-sample twiddle, all host constants.
* **DCT-III**: the exact transpose of the DCT-II pipeline (the DFT matrix is
  symmetric): twiddle the input, FFT, inverse-permute the real plane.
* **DST-II / DST-III**: the classical sign-flip/reversal reductions onto
  DCT-II / DCT-III.
* **DCT-IV / DST-IV**: a single half-shifted trig matrix contracted in
  one dot at ``precision=HIGHEST`` (``O(N^2)``, for the rare
  boundary-condition variants; the matrix is a host constant).

All reorderings, twiddles, permutations, and norm factors are host/static
numpy baked into the jaxpr; only bulk data flows through XLA, so a dct
composes into the same fused program as the surrounding pipeline and is
jit-traceable end to end.  Like :func:`scipy.fft.dct` the transforms are
index-based: the input's dims/coords pass through untouched and no spacing
validation applies.
"""

from __future__ import annotations

import numpy as np

from .labeled import LabeledArray
from .ops import carray, fft_core
from .spectra import _norm_1d_dim, _norm_dim_list

__all__ = ["dct", "idct", "dst", "idst", "dctn", "idctn", "dstn", "idstn"]

_NORMS = (None, "backward", "ortho", "forward")


def _bshape(ndim, ax, n):
    s = [1] * ndim
    s[ax] = n
    return tuple(s)


def _fdtype(x):
    """Float dtype the transform will compute in (ints promote like the
    engine does)."""
    dt = np.dtype(carray._float_of(x.dtype) if carray.is_pair(x) else x.dtype)
    if dt.kind != "f":
        dt = np.dtype(np.float64)  # conftest x64; f32 backends downcast
    return dt


def _validate(kind, type, norm, n):
    if type not in (1, 2, 3, 4):
        raise ValueError(f"{kind} type must be 1, 2, 3 or 4 (got {type})")
    if norm not in _NORMS:
        raise ValueError(f"invalid norm value {norm!r}; should be "
                         "'backward', 'ortho' or 'forward'")
    if kind == "dct" and type == 1 and n < 2:
        raise ValueError("DCT-I requires the input size to be at least 2")


def _makhoul_perm(n):
    """DCT-II input permutation [x0, x2, ..., | ..., x3, x1]."""
    return np.concatenate([np.arange(0, n, 2), np.arange(1, n, 2)[::-1]])


def _dct2_raw(x, ax, n, engine):
    """Unnormalized DCT-II: y[k] = 2 sum x[n] cos(pi k (2n+1) / 2N)."""
    v = carray.take(x, _makhoul_perm(n), axis=ax)
    V = fft_core.fftn(v, [ax], engine=engine)
    th = (np.pi * np.arange(n) / (2.0 * n)).astype(_fdtype(V))
    c = np.cos(th).reshape(_bshape(V.ndim, ax, n))
    s = np.sin(th).reshape(_bshape(V.ndim, ax, n))
    # 2*Re(exp(-i th) V)
    return 2.0 * (carray.real(V) * c + carray.imag(V) * s)


def _dct2_transpose_raw(x, ax, n, engine):
    """The transpose of `_dct2_raw` as a linear map (the DFT matrix is
    symmetric): u = 2 * P^T Re(FFT(exp(-i th) * x))."""
    dt = _fdtype(x)
    th = (np.pi * np.arange(n) / (2.0 * n)).astype(dt)
    c = np.cos(th).reshape(_bshape(x.ndim, ax, n))
    s = np.sin(th).reshape(_bshape(x.ndim, ax, n))
    xr = x if not carray.is_pair(x) else x.re
    b = carray.ComplexPair(xr * c, xr * (-s))
    u = carray.real(fft_core.fftn(b, [ax], engine=engine))
    inv = np.argsort(_makhoul_perm(n))
    return 2.0 * carray.take(u, inv, axis=ax)


def _scale_along(x, ax, vec_np):
    v = np.asarray(vec_np, dtype=_fdtype(x)).reshape(
        _bshape(x.ndim, ax, len(vec_np)))
    return x * v


def _trig4_matrix(kind, n, dt):
    """DCT-IV / DST-IV matrix (backward scaling): 2*cos/sin(pi(2k+1)(2n+1)/4N)."""
    k = np.arange(n)[:, None]
    m = np.arange(n)[None, :]
    arg = np.pi * (2 * k + 1) * (2 * m + 1) / (4.0 * n)
    M = 2.0 * (np.cos(arg) if kind == "dct" else np.sin(arg))
    return M.astype(dt)


def _type4(kind, x, ax, n, engine):
    import jax.numpy as jnp

    from .ops.matmul_fft import _precision

    if carray.is_pair(x):
        x = x.re
    dt = _fdtype(x)
    M = jnp.asarray(_trig4_matrix(kind, n, dt))
    xm = jnp.moveaxis(x.astype(dt), ax, -1)
    y = jnp.einsum("...n,kn->...k", xm, M, precision=_precision())
    return jnp.moveaxis(y, -1, ax)


def _dct_raw(x, ax, n, type, engine):
    """Backward-norm DCT of the given type along ``ax``."""
    if type == 1:
        ext = np.concatenate([np.arange(n), np.arange(n - 2, 0, -1)])
        v = carray.take(x, ext, axis=ax)
        V = fft_core.fftn(v, [ax], engine=engine)
        return carray.getitem(carray.real(V),
                              tuple(slice(None) if i != ax else slice(0, n)
                                    for i in range(V.ndim)))
    if type == 2:
        return _dct2_raw(x, ax, n, engine)
    if type == 3:
        g = np.ones(n)
        g[0] = 0.5
        return _dct2_transpose_raw(_scale_along(x, ax, g), ax, n, engine)
    return _type4("dct", x, ax, n, engine)


def _dst_raw(x, ax, n, type, engine):
    """Backward-norm DST of the given type along ``ax``."""
    if type == 1:
        # odd extension [0, x, 0, -rev(x)], length 2N+2; -Im(FFT)[1:N+1]
        zshape = list(x.shape)
        zshape[ax] = 1
        xr = x if not carray.is_pair(x) else x.re
        import jax.numpy as jnp

        z = jnp.zeros(zshape, dtype=_fdtype(x))
        rev = carray.flip(xr, ax)
        v = carray.concatenate([z, xr, z, -rev], axis=ax)
        V = fft_core.fftn(v, [ax], engine=engine)
        return carray.getitem(-carray.imag(V),
                              tuple(slice(None) if i != ax else slice(1, n + 1)
                                    for i in range(V.ndim)))
    if type == 2:
        alt = (-1.0) ** np.arange(n)
        y = _dct2_raw(_scale_along(x, ax, alt), ax, n, engine)
        return carray.flip(y, ax)
    if type == 3:
        g = np.ones(n)
        g[-1] = 0.5
        xr = carray.flip(_scale_along(x, ax, g), ax)
        y = _dct2_transpose_raw(xr, ax, n, engine)
        return _scale_along(y, ax, (-1.0) ** np.arange(n))
    return _type4("dst", x, ax, n, engine)


def _norm_factors(kind, type, norm, n):
    """(input_scale_vec | None, output_scale_vec | None) turning the
    backward transform into the requested norm — scipy.fft conventions
    (orthogonalize=True for 'ortho', scipy's default)."""
    if norm in (None, "backward"):
        return None, None
    # the "logical length" entering the 1/(2M) forward factor
    M = {1: n - 1 if kind == "dct" else n + 1, 2: n, 3: n, 4: n}[type]
    if norm == "forward":
        return None, np.full(n, 1.0 / (2.0 * M))
    # ortho: symmetric sqrt factors plus endpoint sqrt(2) orthogonalization
    out = np.full(n, np.sqrt(1.0 / (2.0 * M)))
    inp = None
    rt2 = np.sqrt(2.0)
    if kind == "dct":
        if type == 1:
            inp = np.ones(n)
            inp[0] = rt2
            inp[-1] = rt2
            out = out.copy()
            out[0] /= rt2
            out[-1] /= rt2
        elif type == 2:
            out = out.copy()
            out[0] /= rt2
        elif type == 3:
            inp = np.ones(n)
            inp[0] = rt2
    else:
        if type == 2:
            out = out.copy()
            out[-1] /= rt2
        elif type == 3:
            inp = np.ones(n)
            inp[-1] = rt2
    return inp, out


def _trig(kind, da, dim, type, norm, engine, caller):
    dim = _norm_1d_dim(da, dim, caller)
    if carray.is_complex(da.data):
        raise ValueError(f"{caller}: input must be real "
                         "(like scipy.fft, which transforms the real and "
                         "imaginary parts independently; split them "
                         "explicitly if that is what you want)")
    ax = da.dims.index(dim)
    n = da.sizes[dim]
    _validate(kind, type, norm, n)
    x = da.data
    inp, out = _norm_factors(kind, type, norm, n)
    if inp is not None:
        x = _scale_along(x, ax, inp)
    raw = (_dct_raw if kind == "dct" else _dst_raw)(x, ax, n, type, engine)
    if carray.is_pair(raw):
        raw = raw.re
    if out is not None:
        raw = _scale_along(raw, ax, out)
    res = da.copy(data=raw)
    res.name = f"{da.name}_{kind}" if da.name else None
    return res


def dct(da, dim=None, type=2, norm=None, engine=None) -> LabeledArray:
    """Discrete cosine transform along ``dim`` (default: last dim) —
    ``scipy.fft.dct``.  ``type`` in {1, 2, 3, 4}; ``norm`` in
    {None/'backward', 'ortho', 'forward'}.  Real input only; the output is
    real, same length, with the input's dims/coords/attrs unchanged (the
    transform is index-based, like scipy's).
    """
    return _trig("dct", da, dim, type, norm, engine, "dct")


def idct(da, dim=None, type=2, norm=None, engine=None) -> LabeledArray:
    """Inverse DCT — ``scipy.fft.idct``: the type-``{1: 1, 2: 3, 3: 2,
    4: 4}[type]`` transform with the norm direction swapped, so
    ``idct(dct(x, type=t), type=t)`` round-trips for every type and norm.
    """
    _validate("dct", type, norm, da.sizes[_norm_1d_dim(da, dim, "idct")])
    inv_type = {1: 1, 2: 3, 3: 2, 4: 4}[type]
    inv_norm = {"ortho": "ortho", "forward": "backward"}.get(norm, "forward")
    res = _trig("dct", da, dim, inv_type, inv_norm, engine, "idct")
    res.name = f"{da.name}_idct" if da.name else None
    return res


def dst(da, dim=None, type=2, norm=None, engine=None) -> LabeledArray:
    """Discrete sine transform along ``dim`` — ``scipy.fft.dst`` (types
    1-4, same norm/coordinate semantics as :func:`dct`)."""
    return _trig("dst", da, dim, type, norm, engine, "dst")


def idst(da, dim=None, type=2, norm=None, engine=None) -> LabeledArray:
    """Inverse DST — ``scipy.fft.idst`` (see :func:`idct`)."""
    _validate("dst", type, norm, da.sizes[_norm_1d_dim(da, dim, "idst")])
    inv_type = {1: 1, 2: 3, 3: 2, 4: 4}[type]
    inv_norm = {"ortho": "ortho", "forward": "backward"}.get(norm, "forward")
    res = _trig("dst", da, dim, inv_type, inv_norm, engine, "idst")
    res.name = f"{da.name}_idst" if da.name else None
    return res


def _norm_nd_dims(da, dim, caller):
    dims = _norm_dim_list(da, dim)
    if not dims:
        raise ValueError(f"{caller}: dim must name at least one dimension")
    bad = [d for d in dims if d not in da.dims]
    if bad:
        raise ValueError(f"{caller}: dims {bad} not found in {da.dims}")
    if len(set(dims)) != len(dims):
        raise ValueError(f"{caller}: duplicate dims in {dims}")
    return dims


def _trign(kind, inverse, da, dim, type, norm, engine, caller):
    dims = _norm_nd_dims(da, dim, caller)
    one = {("dct", False): dct, ("dct", True): idct,
           ("dst", False): dst, ("dst", True): idst}[(kind, inverse)]
    res = da
    for d in dims:
        res = one(res, dim=d, type=type, norm=norm, engine=engine)
    res.name = f"{da.name}_{caller}" if da.name else None
    return res


def dctn(da, dim=None, type=2, norm=None, engine=None) -> LabeledArray:
    """N-D discrete cosine transform over ``dim`` (a name, a list, or
    ``None`` for all dims) — ``scipy.fft.dctn``.  The transform is
    separable, so it composes the 1-D :func:`dct` along each named dim;
    every host-static permutation/twiddle still bakes into one jaxpr.
    Same type/norm semantics as :func:`dct`.
    """
    return _trign("dct", False, da, dim, type, norm, engine, "dctn")


def idctn(da, dim=None, type=2, norm=None, engine=None) -> LabeledArray:
    """Inverse N-D DCT — ``scipy.fft.idctn`` (``idct`` along each dim)."""
    return _trign("dct", True, da, dim, type, norm, engine, "idctn")


def dstn(da, dim=None, type=2, norm=None, engine=None) -> LabeledArray:
    """N-D discrete sine transform — ``scipy.fft.dstn`` (``dst`` along
    each dim; see :func:`dctn`)."""
    return _trign("dst", False, da, dim, type, norm, engine, "dstn")


def idstn(da, dim=None, type=2, norm=None, engine=None) -> LabeledArray:
    """Inverse N-D DST — ``scipy.fft.idstn`` (``idst`` along each dim)."""
    return _trign("dst", True, da, dim, type, norm, engine, "idstn")
