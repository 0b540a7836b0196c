"""High-precision (float64-grade) transforms.

``fft64``/``ifft64`` return host complex128: on the supported backends the
transform is the float64 FFT; under ``config.hp_impl="emulate"`` it runs
in double-word float32 arithmetic (int8-limb DFT, :mod:`.ops.df64_fft`
fallback; ~1e-12 relative accuracy, see tests/test_df64_fft.py and
docs/precision.md).  Either way this meets the 1e-10 numpy-parity contract
(BASELINE.md).

These functions execute eagerly (the result is materialized to host) and
support the coordinate-aware phase/amplitude semantics of
:func:`xrft_tpu.fft`; preprocessing (detrend/window) is applied in float32
before the transform — pass pre-processed data for full control.
"""

from __future__ import annotations

import jax
import numpy as np

from . import coords as ce
from .labeled import Coord, LabeledArray
from .ops import df64
from .ops.df64_fft import as_df64, df64_fft_nd, df64_to_numpy
from .ops.fft_core import xla_irfftn
from .transform import _dim_coord, _norm_dim

__all__ = ["fft64", "ifft64"]


def fft64(
    da: LabeledArray,
    spacing_tol: float = 1e-3,
    dim=None,
    shift: bool = True,
    true_phase: bool = True,
    true_amplitude: bool = True,
    prefix: str = "freq_",
) -> LabeledArray:
    """:func:`xrft_tpu.fft` at emulated-float64 precision.

    Returns a LabeledArray with host complex128 data.  Eager (not
    jittable); complex and real inputs supported; detrend/window are not
    applied here (preprocess first).
    """
    dim = _norm_dim(da, dim)
    ce.check_valid_fft_coords(da, dim)
    axis_num = [da.get_axis_num(d) for d in dim]
    N = [da.shape[n] for n in axis_num]

    delta_x = [
        ce.get_coordinate_spacing(_dim_coord(da, d), spacing_tol) for d in dim
    ]
    lag_x = [ce.lag_coord(_dim_coord(da, d)) for d in dim]

    x4 = as_df64(da.data)
    if true_phase:
        rev = [
            da.get_axis_num(d)
            for d in dim
            if d in da.coords and da.coords[d].values[-1] < da.coords[d].values[0]
        ]
        if rev:
            import jax.numpy as jnp

            x4 = tuple(jnp.flip(v, axis=rev) for v in x4)
        import jax.numpy as jnp

        x4 = tuple(jnp.fft.ifftshift(v, axes=axis_num) for v in x4)

    if _hp_native(require_x64=False):
        # these backends have native float64: use the host/XLA c128 FFT
        z = df64_to_numpy(x4)
        f = np.fft.fftn(z, axes=axis_num)
    else:
        # int8-limb engine (exact integer matmuls, ~1e-13, much faster
        # than the df64 DFT); df64 fallback for sizes the limb scheme
        # cannot factor
        try:
            from .ops.int8_dft import int8_fft_nd

            out4 = int8_fft_nd(x4, axis_num, "fft")
        except ValueError:
            out4 = df64_fft_nd(x4, axis_num, "fft")
        f = df64_to_numpy(out4)  # host complex128 from here on

    if shift:
        f = np.fft.fftshift(f, axes=axis_num)

    k = ce.freq_grids(N, delta_x, False, shift)

    swap = {d: ce.freq_dim_name(d, prefix) for d in dim}
    out_dims = [swap.get(d, d) for d in da.dims]
    out_coords = {
        c: da.coords[c].copy() for c in da.coords if c not in dim
    }
    for d, kk in zip(dim, k):
        out_coords[swap[d]] = Coord((swap[d],), kk,
                                    {"spacing": kk[1] - kk[0]}, swap[d])

    if true_phase:
        for d, lag in zip(dim, lag_x):
            fd = swap[d]
            ax = out_dims.index(fd)
            phase = np.exp(-2j * np.pi * out_coords[fd].values * lag)
            shape = [1] * len(out_dims)
            shape[ax] = phase.size
            f = f * phase.reshape(shape)
            out_coords[fd].attrs["direct_lag"] = lag

    if true_amplitude:
        f = f * np.prod([np.float64(d) for d in delta_x])

    return LabeledArray(f, dims=out_dims, coords=out_coords, name=da.name)


def ifft64(
    daft: LabeledArray,
    spacing_tol: float = 1e-3,
    dim=None,
    shift: bool = True,
    true_phase: bool = True,
    true_amplitude: bool = True,
    prefix: str = "freq_",
    lag=None,
) -> LabeledArray:
    """:func:`xrft_tpu.ifft` at emulated-float64 precision (host c128 out)."""
    dim = _norm_dim(daft, dim)
    ce.check_valid_fft_coords(daft, dim)

    if lag is None:
        lag = [
            (daft.coords[d].attrs.get("direct_lag", 0.0)
             if d in daft.coords else 0.0)
            for d in dim
        ]
    else:
        if isinstance(lag, (int, float)):
            lag = [lag]
        if len(lag) != len(dim):
            raise ValueError("dim and lag must have the same length.")

    # phase pre-multiply and sorting happen on host (metadata-sized work)
    f = np.asarray(daft.values, dtype=np.complex128)
    work = LabeledArray(f, dims=daft.dims, coords=daft.coords)
    if true_phase:
        for d, l in zip(dim, lag):
            c = _dim_coord(work, d)
            ax = work.get_axis_num(d)
            shape = [1] * work.ndim
            shape[ax] = c.size
            f = f * np.exp(2j * np.pi * c.values * float(l)).reshape(shape)
            work = LabeledArray(f, dims=daft.dims, coords=daft.coords)
    sortable = [d for d in dim if d in work.coords]
    if sortable:
        work = work.sortby(sortable)
        f = np.asarray(work.values, dtype=np.complex128)

    axis_num = [work.get_axis_num(d) for d in dim]
    N = [work.shape[n] for n in axis_num]
    delta_x = [
        ce.get_coordinate_spacing(_dim_coord(work, d), spacing_tol)
        for d in dim
    ]
    for d in dim:
        c = _dim_coord(work, d)
        l = ce.lag_coord(c)
        if np.abs(l) > spacing_tol:
            raise ValueError(
                "Inverse Fourier Transform can not be computed because "
                f"coordinate {d} is not centered on zero frequency"
            )

    f = np.fft.ifftshift(f, axes=axis_num)
    if _hp_native(require_x64=False):
        out = np.fft.ifftn(f, axes=axis_num)
    else:
        re_h, re_l = df64.split_f64_np(np.ascontiguousarray(f.real))
        im_h, im_l = df64.split_f64_np(np.ascontiguousarray(f.imag))
        x4i = tuple(jax.numpy.asarray(v) for v in (re_h, re_l, im_h, im_l))
        try:
            from .ops.int8_dft import int8_fft_nd

            out4 = int8_fft_nd(x4i, axis_num, "ifft")
        except ValueError:
            out4 = df64_fft_nd(x4i, axis_num, "ifft")
        out = df64_to_numpy(out4)

    if not true_phase:
        out = np.fft.ifftshift(out, axes=axis_num)
    if shift:
        out = np.fft.fftshift(out, axes=axis_num)

    k = ce.ifreq_grids(N, delta_x, False, shift)
    swap = {d: ce.freq_dim_name(d, prefix) for d in dim}
    out_dims = [swap.get(d, d) for d in work.dims]
    out_coords = {c: work.coords[c].copy() for c in work.coords if c not in dim}
    out_spacing = []
    for d, kk, l in zip(dim, k, lag):
        sp = kk[1] - kk[0]
        out_spacing.append(sp)
        out_coords[swap[d]] = Coord((swap[d],), kk + l, {"spacing": sp},
                                    swap[d])
    if true_amplitude:
        out = out / np.prod(out_spacing)

    return LabeledArray(out, dims=out_dims, coords=out_coords,
                        name=daft.name)


# ---------------------------------------------------------------------------
# jit-traceable high-precision pipeline (engine="hp")
#
# Unlike fft64/ifft64 above (eager, host-c128 results), these run fully on
# device — native float64 planes and the c128 XLA FFT under x64, else the
# int8-limb DFT (ops/int8_dft.int8_fft_nd) with df64 elementwise/reduction
# stages (ops/hp.py) — and return LabeledArrays whose data is
# carray.CDF64 / carray.DF64 (values -> complex128/float64 on host).  This
# is what makes the 1e-10 BASELINE contract hold for jit-compiled,
# windowed/detrended pipelines; pinned in scripts/chip_checks.py and
# chip_smoke.py on the GPU.
# ---------------------------------------------------------------------------


def fft_hp(
    da: LabeledArray,
    spacing_tol: float = 1e-3,
    dim=None,
    real_dim: str | None = None,
    shift: bool = True,
    detrend: str | None = None,
    window: str | None = None,
    true_phase: bool = True,
    true_amplitude: bool = True,
    prefix: str = "freq_",
    chunks_to_segments: bool = False,
    segment_overlap=None,
) -> LabeledArray:
    """:func:`xrft_tpu.fft` semantics at df64 precision, jit-traceable.

    Reference semantics: ``/root/reference/xrft/xrft.py:307-476``; shift is
    forced False for real transforms like the reference (:400-404).
    """
    import jax.numpy as jnp

    from .ops import carray
    from .ops.hp import as_quad, detrend_quad, window_quad
    from .transform import _move_to_end, _norm_dim, _stack_segments

    dim = _norm_dim(da, dim)
    if segment_overlap is not None and not chunks_to_segments:
        raise ValueError("segment_overlap requires chunks_to_segments=True")
    if chunks_to_segments:
        # metadata reshape before the df64 promotion
        da = _stack_segments(da, dim, overlap=segment_overlap)
    rawdims = da.dims
    if real_dim is not None:
        if real_dim not in da.dims:
            raise ValueError(
                "The dimension along which real FT is taken must be one of "
                "the existing dimensions."
            )
        dim = _move_to_end(dim, real_dim)
        da = da.transpose(*_move_to_end(list(da.dims), real_dim))
        shift = False
    ce.check_valid_fft_coords(da, dim)

    axis_num = [da.get_axis_num(d) for d in dim]
    N = [da.shape[n] for n in axis_num]
    delta_x = [
        ce.get_coordinate_spacing(_dim_coord(da, d), spacing_tol) for d in dim
    ]
    lag_x = [ce.lag_coord(_dim_coord(da, d)) for d in dim]

    x4 = _promote_quad(as_quad(da.data))
    if detrend is not None:
        rh, rl = detrend_quad(x4[0], x4[1], tuple(axis_num), detrend)
        ih, il = detrend_quad(x4[2], x4[3], tuple(axis_num), detrend) \
            if not _is_zero(x4[2]) else (x4[2], x4[3])
        x4 = (rh, rl, ih, il)
    if window is not None:
        das = [(a, da.sizes[d]) for a, d in zip(axis_num, dim)]
        rh, rl, _ = window_quad(x4[0], x4[1], das, window)
        ih, il = x4[2], x4[3]
        if not _is_zero(ih):
            ih, il, _ = window_quad(ih, il, das, window)
        x4 = (rh, rl, ih, il)

    if true_phase:
        rev = [
            da.get_axis_num(d)
            for d in dim
            if d in da.coords
            and da.coords[d].values[-1] < da.coords[d].values[0]
        ]
        if rev:
            x4 = tuple(jnp.flip(v, axis=rev) for v in x4)

    kind = "rfft" if real_dim is not None else "fft"
    out4 = _hp_fft_nd(
        x4, axis_num, kind,
        pre_shift_axes=axis_num if true_phase else (),
        post_shift_axes=axis_num if shift else (),
    )

    k = ce.freq_grids(N, delta_x, real_dim is not None, shift)
    swap = {d: ce.freq_dim_name(d, prefix) for d in dim}
    out_dims = [swap.get(d, d) for d in da.dims]
    out_coords = {c: da.coords[c].copy() for c in da.coords if c not in dim}
    for d, kk in zip(dim, k):
        out_coords[swap[d]] = Coord((swap[d],), kk, {"spacing": kk[1] - kk[0]},
                                    swap[d])

    if true_phase:
        for d, lag in zip(dim, lag_x):
            fd = swap[d]
            ax = out_dims.index(fd)
            out4 = _cmul_host_phase(
                out4, -2.0 * np.pi * out_coords[fd].values * lag, ax)
            out_coords[fd].attrs["direct_lag"] = lag

    if true_amplitude:
        out4 = _scale_quad(out4, float(np.prod(
            [np.float64(v) for v in delta_x])))

    from .ops.carray import CDF64

    out = LabeledArray(CDF64(*out4), dims=out_dims, coords=out_coords,
                       name=da.name)
    # transpose back to the raw dim order (reference
    # /root/reference/xrft/xrft.py:474-476)
    return out.transpose(*[swap.get(d, d) for d in rawdims])


def ifft_hp(
    daft: LabeledArray,
    spacing_tol: float = 1e-3,
    dim=None,
    real_dim: str | None = None,
    shift: bool = True,
    true_phase: bool = True,
    true_amplitude: bool = True,
    prefix: str = "freq_",
    lag=None,
    chunks_to_segments: bool = False,
) -> LabeledArray:
    """:func:`xrft_tpu.ifft` semantics at df64 precision, jit-traceable
    (reference ``/root/reference/xrft/xrft.py:479-646``; segment stacking
    after the lag phase pre-multiplication as at ``:574-579``)."""
    import warnings as _warnings

    import jax.numpy as jnp

    from .ops.carray import CDF64, DF64
    from .ops.hp import as_quad
    from .transform import _move_to_end, _norm_dim

    dim = _norm_dim(daft, dim)
    if real_dim is not None:
        dim = _move_to_end(dim, real_dim)
    ce.check_valid_fft_coords(daft, dim)

    if lag is None:
        lag = [
            (daft.coords[d].attrs.get("direct_lag", 0.0)
             if d in daft.coords else 0.0)
            for d in dim
        ]
        if true_phase and any(l != 0.0 for l in lag):
            _warnings.warn(
                "Default ifft's behaviour (lag=None) changed! Default value "
                "of lag was zero (centered output coordinates) and is now "
                "set to transformed coordinate's attribute: 'direct_lag'.",
                FutureWarning,
            )
    else:
        if isinstance(lag, (int, float)):
            lag = [lag]
        if len(dim) != len(lag):
            raise ValueError("dim and lag must have the same length.")
        if not true_phase:
            _warnings.warn(
                "Setting lag with true_phase=False does not guarantee "
                "accurate ifft.",
                Warning,
            )
        lag = [
            (daft.coords[d].attrs.get("direct_lag", 0.0)
             if d in daft.coords else 0.0) if l is None else l
            for d, l in zip(dim, lag)
        ]

    x4 = _promote_quad(as_quad(daft.data))
    if true_phase:
        for d, l in zip(dim, lag):
            ax = daft.get_axis_num(d)
            x4 = _cmul_host_phase(
                x4, 2.0 * np.pi * _dim_coord(daft, d).values * float(l), ax)

    if chunks_to_segments:
        from .transform import _segment_plan

        newdims, newshape, newcoords, _ = _segment_plan(daft, dim)
        x4 = tuple(v.reshape(tuple(newshape)) for v in x4)
        daft = LabeledArray(x4[0], dims=newdims, coords=newcoords,
                            attrs=daft.attrs)

    rawdims = daft.dims
    work_coords = {c: daft.coords[c].copy() for c in daft.coords}

    if real_dim is not None:
        order = _move_to_end(list(daft.dims), real_dim)
        perm = [daft.dims.index(d) for d in order]
        x4 = tuple(jnp.transpose(v, perm) for v in x4)
        dims_now = tuple(order)
    else:
        dims_now = daft.dims

    # sortby on the (static) freq coords: trace-time argsort permutations
    for d in dim:
        if d in work_coords:
            vals = work_coords[d].values
            if not np.all(np.diff(vals) > 0):
                perm = np.argsort(vals, kind="stable")
                ax = dims_now.index(d)
                x4 = tuple(jnp.take(v, jnp.asarray(perm), axis=ax)
                           for v in x4)
                work_coords[d] = Coord((d,), vals[perm],
                                       work_coords[d].attrs, d)

    axis_num = [dims_now.index(d) for d in dim]
    N = [x4[0].shape[a] for a in axis_num]
    delta_x = []
    for d in dim:
        c = work_coords.get(d)
        if c is None:
            from .labeled import Coord as _C

            c = _C((d,), np.arange(x4[0].shape[dims_now.index(d)],
                                   dtype=np.float64), {}, d)
        delta_x.append(ce.get_coordinate_spacing(c, spacing_tol))
        l0 = ce.lag_coord(c) if d != real_dim else c.values[0]
        if np.abs(l0) > spacing_tol:
            raise ValueError(
                "Inverse Fourier Transform can not be computed because "
                f"coordinate {d} is not centered on zero frequency"
            )

    nonreal_axes = [a for a, d in zip(axis_num, dim) if d != real_dim]
    kind = "irfft" if real_dim is not None else "ifft"
    # output shifts apply to EVERY transformed axis — including the real
    # one at its full irfft length (reference
    # /root/reference/xrft/xrft.py:617-621).  The four flag combos
    # collapse: ifftshift∘fftshift is the identity (they are inverses),
    # so tp=F,sh=T needs nothing, tp=T,sh=T one fftshift, tp=F,sh=F one
    # ifftshift.
    if true_phase and shift:
        post_axes, post_kind = axis_num, "fftshift"
    elif (not true_phase) and (not shift):
        post_axes, post_kind = axis_num, "ifftshift"
    else:
        post_axes, post_kind = (), "fftshift"
    out4 = _hp_fft_nd(x4, axis_num, kind, pre_shift_axes=nonreal_axes,
                      post_shift_axes=post_axes, post_kind=post_kind)

    Nout = [2 * (n - 1) if d == real_dim else n for n, d in zip(N, dim)]
    k = ce.ifreq_grids(N, delta_x, real_dim is not None, shift)
    swap = {d: ce.freq_dim_name(d, prefix) for d in dim}
    out_dims = [swap.get(d, d) for d in dims_now]
    out_coords = {c: v.copy() for c, v in work_coords.items()
                  if c not in dim}
    out_spacing = []
    for d, kk, l in zip(dim, k, lag):
        sp = kk[1] - kk[0]
        out_spacing.append(sp)
        out_coords[swap[d]] = Coord(
            (swap[d],), kk + l,
            {"spacing": sp, **({} if d not in work_coords else
                               {kk2: v for kk2, v in
                                work_coords[d].attrs.items()
                                if kk2 == "spacing"})}, swap[d])

    if true_amplitude:
        s = 1.0 / float(np.prod([np.float64(v) for v in out_spacing]))
        # the irfft transform returns a real (hi, lo) 2-tuple
        out4 = _scale_quad_real(*out4, s) if kind == "irfft" \
            else _scale_quad(out4, s)

    data = DF64(out4[0], out4[1]) if kind == "irfft" else CDF64(*out4)
    out = LabeledArray(data, dims=out_dims, coords=out_coords,
                       name=daft.name)
    return out.transpose(*[swap.get(d, d) for d in rawdims])


def _hp_native(require_x64: bool = True) -> bool:
    """Should the hp path run native float64 (vs the int8/df64 emulation)?

    "auto" (default): native on the supported backends (cpu/gpu; any
    other raises, see :func:`.config.check_backend`) — for the jit
    pipelines additionally requiring jax_enable_x64 (without x64 the f64
    promotion would silently truncate).  config.hp_impl overrides in both
    directions ("emulate" keeps the emulation CPU-testable).
    """
    from .config import check_backend, config

    if config.hp_impl == "emulate":
        return False
    check_backend()
    x64 = bool(jax.config.jax_enable_x64)
    if config.hp_impl == "native":
        # forcing native without x64 would SILENTLY truncate the promoted
        # planes to f32 — refuse instead
        if require_x64 and not x64:
            raise ValueError(
                "config.hp_impl='native' requires jax_enable_x64 for "
                "the jit hp pipelines (without it the f64 promotion "
                "silently truncates to f32)"
            )
        return True
    return x64 or not require_x64


def _promote_quad(x4):
    """f64-plane promotion for the native hp mode: with float64 base dtype
    every df64 sequence downstream (detrend/window/cmul/abs2/scaling) is
    at worst plain-f64 accurate (~1e-16) even where LLVM FMA contraction
    breaks the compensation — which is what makes the 1e-10 contract hold
    off-chip (reference accuracy pins
    /root/reference/xrft/tests/test_xrft.py:693-842 hold on every backend
    the reference supports)."""
    import jax.numpy as jnp

    if _hp_native():
        return tuple(v.astype(jnp.float64) for v in x4)
    return x4


def _hp_fft_nd(x4, axes, kind, pre_shift_axes=(), post_shift_axes=(),
               post_kind: str = "fftshift"):
    """The hp transform, dispatched: native c128 XLA FFT on backends with
    real float64 (x64 on), int8-limb emulation otherwise (or when forced via
    config.hp_impl="emulate").  Contract identical to
    :func:`..ops.int8_dft.int8_fft_nd`: per-axis pre-ifftshift /
    post-shift rolls, 'irfft' returns a real (hi, lo) 2-tuple, everything
    else a complex 4-tuple; in native mode the planes are float64 with
    zero lo."""
    if not _hp_native():
        from .ops.int8_dft import int8_fft_nd

        return int8_fft_nd(x4, axes, kind, pre_shift_axes,
                           post_shift_axes, post_kind)
    import jax.numpy as jnp

    ndim = x4[0].ndim
    axes = [a % ndim for a in axes]
    pre = sorted({a % ndim for a in pre_shift_axes})
    post = sorted({a % ndim for a in post_shift_axes})
    if kind == "rfft":
        # the halved real axis never takes a post-shift (int8_fft_nd
        # skips it the same way)
        post = [a for a in post if a != axes[-1]]
    z = (x4[0].astype(jnp.float64) + x4[1].astype(jnp.float64)
         + 1j * (x4[2].astype(jnp.float64) + x4[3].astype(jnp.float64)))
    # per-axis shifts commute with transforms along OTHER axes, and
    # int8_fft_nd applies each axis' pre-roll before (and post-roll
    # after) that axis' own transform — so batching them around the full
    # N-D transform is equivalent.
    if pre:
        z = jnp.fft.ifftshift(z, axes=pre)
    if kind == "fft":
        out = jnp.fft.fftn(z, axes=axes)
    elif kind == "ifft":
        out = jnp.fft.ifftn(z, axes=axes)
    elif kind == "rfft":
        out = jnp.fft.rfftn(jnp.real(z), axes=axes)
    elif kind == "irfft":
        out = xla_irfftn(z, axes)
    else:
        raise ValueError(f"unknown hp transform kind {kind!r}")
    if post:
        fn = jnp.fft.fftshift if post_kind == "fftshift" \
            else jnp.fft.ifftshift
        out = fn(out, axes=post)
    if kind == "irfft":
        return out, jnp.zeros_like(out)
    re, im = jnp.real(out), jnp.imag(out)
    return (re, jnp.zeros_like(re), im, jnp.zeros_like(im))


def _is_zero(v) -> bool:
    # trace-safe "is this the all-zeros imaginary part we created": only
    # constants created by as_quad are np/jnp zeros with no trace deps
    import jax

    return not isinstance(v, jax.core.Tracer) and np.all(np.asarray(v) == 0)


def _cmul_host_phase(x4, theta_np: np.ndarray, ax: int):
    """Multiply by exp(i*theta) with theta host-f64, split exactly."""
    import jax.numpy as jnp

    ph = np.cos(theta_np.astype(np.float64))
    pi_ = np.sin(theta_np.astype(np.float64))
    shape = [1] * x4[0].ndim
    shape[ax] = ph.size
    consts = []
    for part in (ph, pi_):
        hi, lo = df64.split_f64_np(part.reshape(shape))
        consts.extend([jnp.asarray(hi), jnp.asarray(lo)])
    return df64.cmul(x4, tuple(consts))


def _scale_quad(x4, s: float):
    import jax.numpy as jnp

    hi = np.float32(s)
    lo = np.float32(np.float64(s) - np.float64(hi))
    re = df64.mul(x4[0], x4[1], jnp.float32(hi), jnp.float32(lo))
    im = df64.mul(x4[2], x4[3], jnp.float32(hi), jnp.float32(lo))
    return (*re, *im)


def _scale_quad_real(h, l, s: float):
    import jax.numpy as jnp

    hi = np.float32(s)
    lo = np.float32(np.float64(s) - np.float64(hi))
    return df64.mul(h, l, jnp.float32(hi), jnp.float32(lo))


def _real_parity_n(da, real_dim, kwargs) -> int:
    """Length deciding the one-sided Nyquist-bin parity: the SEGMENT
    length under chunks_to_segments (the rfft runs per segment; same
    deliberate reference divergence as spectra._psd_real_dim_scaling)."""
    n = da.sizes[real_dim]
    if kwargs.get("chunks_to_segments"):
        chunks = getattr(da, "_chunks", None) or da.attrs.get("_chunks") \
            or {}
        n = chunks.get(real_dim, n)
    return n


def power_spectrum_hp(
    da: LabeledArray,
    dim=None,
    real_dim: str | None = None,
    scaling: str = "density",
    window_correction: bool = False,
    **kwargs,
) -> LabeledArray:
    """:func:`xrft_tpu.power_spectrum` at df64 precision (engine='hp').

    Returns a LabeledArray with real df64 (carray.DF64) data; all scalar
    factors (density/spectrum, window correction, real-dim doubling) are
    computed in host float64 and applied in double-word arithmetic.
    Reference: ``/root/reference/xrft/xrft.py:685-750``.
    """
    import jax.numpy as jnp
    import scipy.signal as sps

    from .ops import carray
    from .transform import _norm_dim

    kwargs.setdefault("true_amplitude", True)
    kwargs["true_phase"] = False
    window = kwargs.get("window")
    daft = fft_hp(da, dim=dim, real_dim=real_dim, **kwargs)
    dim = _norm_dim(da, dim)
    updated = [d for d in daft.dims
               if d not in da.dims and "segment" not in d]

    ps = carray.abs2(daft.data)  # DF64
    h, l = ps.hi, ps.lo

    if real_dim is not None:
        fr = next(d for d in updated if d.endswith(real_dim))
        ax = daft.get_axis_num(fr)
        f = np.full(daft.sizes[fr], 2.0, np.float32)
        f[0] = 1.0
        if _real_parity_n(da, real_dim, kwargs) % 2 == 0:
            f[-1] = 1.0
        shape = [1] * h.ndim
        shape[ax] = f.size
        fj = jnp.asarray(f.reshape(shape))
        h, l = h * fj, l * fj  # powers of two: exact

    scale = 1.0
    if scaling != "false_density":
        if window_correction:
            if window is None:
                raise ValueError(
                    "window_correction can only be applied when windowing "
                    "is turned on."
                )
            wname = "hann" if window is True else window
            wfun = getattr(sps.windows, wname)
            corr = 1.0
            for d in dim:
                w = np.asarray(wfun(da.sizes[d], sym=False), np.float64)
                corr *= float(np.mean(w**2)) if scaling == "density" \
                    else float(np.mean(w)) ** 2
            scale /= corr
        fs = float(np.prod([
            np.float64(daft.coords[d].attrs["spacing"]) for d in updated]))
        if scaling == "density":
            scale *= fs
        elif scaling == "spectrum":
            scale *= fs**2
        else:
            raise ValueError(f"Unknown {scaling} scaling flag")
    if scale != 1.0:
        h, l = _scale_quad_real(h, l, scale)

    from .ops.carray import DF64

    out = LabeledArray(DF64(h, l), dims=daft.dims,
                       coords={c: v.copy() for c, v in daft.coords.items()},
                       name=da.name)
    return out


def cross_spectrum_hp(
    da1: LabeledArray,
    da2: LabeledArray,
    dim=None,
    real_dim: str | None = None,
    scaling: str = "density",
    window_correction: bool = False,
    **kwargs,
) -> LabeledArray:
    """:func:`xrft_tpu.cross_spectrum` at df64 precision (engine='hp'):
    F(da1) * conj(F(da2)) with the same scaling tail as power_spectrum_hp.
    Reference: ``/root/reference/xrft/xrft.py:753-835``."""
    import jax.numpy as jnp
    import scipy.signal as sps

    from .ops.carray import CDF64
    from .transform import _norm_dim

    if tuple(da1.dims) != tuple(da2.dims):
        raise ValueError("da1 and da2 must have the same dimensions!")
    kwargs.setdefault("true_amplitude", True)
    kwargs.setdefault("true_phase", True)
    window = kwargs.get("window")
    daft1 = fft_hp(da1, dim=dim, real_dim=real_dim, **kwargs)
    daft2 = fft_hp(da2, dim=dim, real_dim=real_dim, **kwargs)
    dim = _norm_dim(da1, dim)
    updated = [d for d in daft1.dims
               if d not in da1.dims and "segment" not in d]

    q2 = daft2.data.conj().quad
    cs4 = df64.cmul(daft1.data.quad, q2)
    rh, rl, ih, il = cs4

    if real_dim is not None:
        fr = next(d for d in updated if d.endswith(real_dim))
        ax = daft1.get_axis_num(fr)
        f = np.full(daft1.sizes[fr], 2.0, np.float32)
        f[0] = 1.0
        if _real_parity_n(da1, real_dim, kwargs) % 2 == 0:
            f[-1] = 1.0
        shape = [1] * rh.ndim
        shape[ax] = f.size
        fj = jnp.asarray(f.reshape(shape))
        rh, rl, ih, il = rh * fj, rl * fj, ih * fj, il * fj

    scale = 1.0
    if scaling != "false_density":
        if window_correction:
            if window is None:
                raise ValueError(
                    "window_correction can only be applied when windowing "
                    "is turned on."
                )
            wname = "hann" if window is True else window
            wfun = getattr(sps.windows, wname)
            corr = 1.0
            for d in dim:
                w = np.asarray(wfun(da1.sizes[d], sym=False), np.float64)
                corr *= float(np.mean(w**2)) if scaling == "density" \
                    else float(np.mean(w)) ** 2
            scale /= corr
        fs = float(np.prod([
            np.float64(daft1.coords[d].attrs["spacing"]) for d in updated]))
        scale *= fs if scaling == "density" else fs**2
    if scale != 1.0:
        rh, rl, ih, il = _scale_quad((rh, rl, ih, il), scale)

    name = None
    if da1.name and da2.name:
        name = f"{da1.name}_{da2.name}"
    return LabeledArray(CDF64(rh, rl, ih, il), dims=daft1.dims,
                        coords={c: v.copy()
                                for c, v in daft1.coords.items()},
                        name=name)
