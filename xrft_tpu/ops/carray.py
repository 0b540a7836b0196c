"""Split-complex array support.

The spectral pipeline runs complex arithmetic in native complex dtypes by
default; with ``config.complex_mode="split"`` (and inside the matmul
engine) it runs in *split* form — a ``ComplexPair`` pytree of two real
arrays.  Split mode is plain JAX, kept reachable until ROADMAP.md Design
1.2 removes it.

This module is the single dispatch point: every complex operation the
library performs (conjugation, magnitude, phase factors, twiddle multiplies,
Hermitian mirroring, shifts, …) goes through these functions, which accept
either a native complex ``jax.Array`` or a ``ComplexPair`` and return the
same representation.  The two representations are numerically identical by
construction, so CPU tests that force split mode keep that code path
covered.

This design follows arXiv:2002.03260 (PAPERS.md), which likewise formulates the DFT with
separate real/imaginary matmuls.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["ComplexPair", "is_complex", "is_pair"]


@jax.tree_util.register_pytree_node_class
class ComplexPair:
    """A complex array represented as two real arrays (re, im)."""

    __slots__ = ("re", "im")

    def __init__(self, re, im):
        self.re = re
        self.im = im

    def tree_flatten(self):
        return (self.re, self.im), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    # -- array-like surface -------------------------------------------------
    @property
    def shape(self):
        return tuple(self.re.shape)

    @property
    def ndim(self):
        return self.re.ndim

    @property
    def size(self):
        return self.re.size

    @property
    def dtype(self):
        return np.dtype(
            np.complex128 if np.dtype(self.re.dtype) == np.float64 else np.complex64
        )

    @property
    def real(self):
        return self.re

    @property
    def imag(self):
        return self.im

    def conj(self):
        return ComplexPair(self.re, -self.im)

    def astype(self, dtype):
        dtype = np.dtype(dtype)
        if dtype.kind == "c":
            rdtype = np.float64 if dtype == np.dtype(np.complex128) else np.float32
            return ComplexPair(self.re.astype(rdtype), self.im.astype(rdtype))
        return self.re.astype(dtype)

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return ComplexPair(self.re.reshape(shape), self.im.reshape(shape))

    def __getitem__(self, key):
        return ComplexPair(self.re[key], self.im[key])

    def __repr__(self):
        return f"ComplexPair(shape={self.shape}, dtype={self.dtype})"

    def __array__(self, dtype=None, copy=None):
        out = np.asarray(self.re) + 1j * np.asarray(self.im)
        return out.astype(dtype) if dtype is not None else out

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, ComplexPair):
            return ComplexPair(self.re + o.re, self.im + o.im)
        if _is_complex_scalar_or_array(o):
            return self + as_pair(o)
        return ComplexPair(self.re + o, self.im)

    __radd__ = __add__

    def __neg__(self):
        return ComplexPair(-self.re, -self.im)

    def __sub__(self, o):
        return self + (-o if isinstance(o, ComplexPair) else -_maybe_pair(o))

    def __rsub__(self, o):
        return (-self) + o

    def __mul__(self, o):
        if isinstance(o, ComplexPair):
            return ComplexPair(
                self.re * o.re - self.im * o.im, self.re * o.im + self.im * o.re
            )
        if _is_complex_scalar_or_array(o):
            return self * as_pair(o)
        return ComplexPair(self.re * o, self.im * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, ComplexPair):
            d = o.re * o.re + o.im * o.im
            return ComplexPair(
                (self.re * o.re + self.im * o.im) / d,
                (self.im * o.re - self.re * o.im) / d,
            )
        if _is_complex_scalar_or_array(o):
            return self / as_pair(o)
        return ComplexPair(self.re / o, self.im / o)

    def __rtruediv__(self, o):
        return _maybe_pair(o) / self


@jax.tree_util.register_pytree_node_class
class DF64:
    """A real array in double-word float32 ("df64", ~49-bit mantissa):
    value = hi + lo with the error-free invariants of :mod:`.df64`.

    Carried as LabeledArray data by the high-precision (engine='hp')
    pipeline; ``.values``/``to_numpy`` reconstruct float64 on host.
    """

    __slots__ = ("hi", "lo")

    def __init__(self, hi, lo):
        self.hi = hi
        self.lo = lo

    def tree_flatten(self):
        return (self.hi, self.lo), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def shape(self):
        return tuple(self.hi.shape)

    @property
    def ndim(self):
        return self.hi.ndim

    @property
    def size(self):
        return self.hi.size

    @property
    def dtype(self):
        return np.dtype(np.float64)

    def __getitem__(self, key):
        return DF64(self.hi[key], self.lo[key])

    def __array__(self, dtype=None, copy=None):
        out = np.asarray(self.hi).astype(np.float64) \
            + np.asarray(self.lo).astype(np.float64)
        return out.astype(dtype) if dtype is not None else out

    def __repr__(self):
        return f"DF64(shape={self.shape})"


@jax.tree_util.register_pytree_node_class
class CDF64:
    """A complex array in double-word float32: re = rh+rl, im = ih+il."""

    __slots__ = ("rh", "rl", "ih", "il")

    def __init__(self, rh, rl, ih, il):
        self.rh = rh
        self.rl = rl
        self.ih = ih
        self.il = il

    def tree_flatten(self):
        return (self.rh, self.rl, self.ih, self.il), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def shape(self):
        return tuple(self.rh.shape)

    @property
    def ndim(self):
        return self.rh.ndim

    @property
    def size(self):
        return self.rh.size

    @property
    def dtype(self):
        return np.dtype(np.complex128)

    @property
    def quad(self):
        return (self.rh, self.rl, self.ih, self.il)

    @property
    def real(self):
        return DF64(self.rh, self.rl)

    @property
    def imag(self):
        return DF64(self.ih, self.il)

    def conj(self):
        return CDF64(self.rh, self.rl, -self.ih, -self.il)

    def __getitem__(self, key):
        return CDF64(self.rh[key], self.rl[key], self.ih[key], self.il[key])

    def __array__(self, dtype=None, copy=None):
        re = np.asarray(self.rh).astype(np.float64) \
            + np.asarray(self.rl).astype(np.float64)
        im = np.asarray(self.ih).astype(np.float64) \
            + np.asarray(self.il).astype(np.float64)
        out = re + 1j * im
        return out.astype(dtype) if dtype is not None else out

    def __repr__(self):
        return f"CDF64(shape={self.shape})"


def is_df64(x) -> bool:
    return isinstance(x, (DF64, CDF64))


def _is_complex_scalar_or_array(o) -> bool:
    if isinstance(o, complex):
        return True
    dt = getattr(o, "dtype", None)
    return dt is not None and np.dtype(dt).kind == "c"


def _maybe_pair(o):
    return as_pair(o) if _is_complex_scalar_or_array(o) else o


def is_pair(x) -> bool:
    return isinstance(x, ComplexPair)


def is_complex(x) -> bool:
    """True for native complex arrays and ComplexPairs."""
    if is_pair(x):
        return True
    return np.dtype(x.dtype).kind == "c"


def as_pair(x) -> ComplexPair:
    """Split any array (or complex scalar) into a ComplexPair."""
    if is_pair(x):
        return x
    if isinstance(x, complex):
        return ComplexPair(jnp.asarray(x.real), jnp.asarray(x.imag))
    if isinstance(x, np.ndarray) and x.dtype.kind == "c":
        # split on host: the complex array is never device_put
        return ComplexPair(
            jnp.asarray(np.ascontiguousarray(x.real)),
            jnp.asarray(np.ascontiguousarray(x.imag)),
        )
    x = jnp.asarray(x) if not isinstance(x, jax.Array) else x
    if np.dtype(x.dtype).kind == "c":
        return ComplexPair(jnp.real(x), jnp.imag(x))
    return ComplexPair(x, jnp.zeros_like(x))


def as_native(x):
    """Recombine a ComplexPair into a native complex jax array (backends
    with complex support only)."""
    if is_pair(x):
        return jax.lax.complex(
            jnp.asarray(x.re).astype(_float_of(x.dtype)),
            jnp.asarray(x.im).astype(_float_of(x.dtype)),
        )
    return x


def _float_of(cdtype):
    return np.float64 if np.dtype(cdtype) == np.dtype(np.complex128) else np.float32


def to_numpy(x) -> np.ndarray:
    if is_pair(x):
        return np.asarray(x.re) + 1j * np.asarray(x.im)
    if is_df64(x):
        return np.asarray(x)
    return np.asarray(x)


# --------------------------------------------------------------------------
# representation-generic ops (each accepts array-or-pair, returns same kind)
# --------------------------------------------------------------------------


def _map(x, fn):
    if is_pair(x):
        return ComplexPair(fn(x.re), fn(x.im))
    if isinstance(x, DF64):
        return DF64(fn(x.hi), fn(x.lo))
    if isinstance(x, CDF64):
        return CDF64(fn(x.rh), fn(x.rl), fn(x.ih), fn(x.il))
    return fn(x)


def conj(x):
    if is_pair(x) or isinstance(x, CDF64):
        return x.conj()
    return jnp.conj(x)


def real(x):
    if is_pair(x) or isinstance(x, CDF64):
        return x.real
    return jnp.real(x)


def imag(x):
    if is_pair(x) or isinstance(x, CDF64):
        return x.imag
    return jnp.imag(x)


def abs2(x):
    """|x|^2 as a real array (the power-spectrum kernel)."""
    if is_pair(x):
        return x.re * x.re + x.im * x.im
    if isinstance(x, CDF64):
        from . import df64

        r2 = df64.mul(x.rh, x.rl, x.rh, x.rl)
        i2 = df64.mul(x.ih, x.il, x.ih, x.il)
        return DF64(*df64.add(*r2, *i2))
    if isinstance(x, DF64):
        from . import df64

        return DF64(*df64.mul(x.hi, x.lo, x.hi, x.lo))
    if np.dtype(x.dtype).kind == "c":
        return jnp.real(x * jnp.conj(x))
    return x * x


def absolute(x):
    if is_pair(x):
        return jnp.sqrt(abs2(x))
    return jnp.abs(x)


def angle(x):
    if is_pair(x):
        return jnp.arctan2(x.im, x.re)
    if isinstance(x, CDF64):
        # angle is scale-invariant; atan2 is evaluated in f32 on the
        # f64-accurate components (the transcendental itself has no df64
        # implementation here) -> ~1e-7 phase accuracy
        return jnp.arctan2(x.ih + x.il, x.rh + x.rl)
    return jnp.angle(x)


def multiply(a, b):
    if is_pair(a) or is_pair(b):
        a = a if is_pair(a) else _maybe_pair(a)
        b = b if is_pair(b) else _maybe_pair(b)
        if is_pair(a):
            return a * b
        return b * a
    return a * b


def transpose(x, perm):
    return _map(x, lambda v: jnp.transpose(v, perm))


def moveaxis(x, src, dst):
    return _map(x, lambda v: jnp.moveaxis(v, src, dst))


def swapaxes(x, a, b):
    return _map(x, lambda v: jnp.swapaxes(v, a, b))


def reshape(x, shape):
    def f(v):
        try:
            return v.reshape(shape)
        except Exception as e:
            # merging sharded trailing dims needs an explicit output
            # sharding; the merged dim inherits the outermost merged dim's
            # mesh axis (GSPMD resolves any required movement)
            if type(e).__name__ != "ShardingTypeError":
                raise
            from jax.sharding import PartitionSpec as _P

            sh = jax.typeof(v).sharding
            nkeep = len(shape) - 1
            if shape[:nkeep] != v.shape[:nkeep]:
                raise
            spec = list(sh.spec) + [None] * (v.ndim - len(sh.spec))
            out_spec = _P(*(spec[:nkeep] + [spec[nkeep]]))
            return jax.lax.reshape(v, shape,
                                   out_sharding=sh.update(spec=out_spec))

    return _map(x, f)


def flip(x, axis):
    return _map(x, lambda v: jnp.flip(v, axis=axis))


def take(x, indices, axis):
    def f(v):
        try:
            return jnp.take(v, indices, axis=axis)
        except Exception as e:
            # gathers on sharded dims need an explicit output sharding
            # under strict sharding typing; a same-length take along one
            # axis preserves the operand's spec
            if type(e).__name__ != "ShardingTypeError":
                raise
            sh = jax.typeof(v).sharding
            key = tuple(indices if i == axis else slice(None)
                        for i in range(v.ndim))
            return v.at[key].get(out_sharding=sh)

    return _map(x, f)


def roll(x, shift, axis):
    return _map(x, lambda v: jnp.roll(v, shift, axis=axis))


def take_with_sharding(x, idx, axis, sharding):
    """Constant-index gather along ``axis`` with an explicit output
    sharding (required for gathers on sharded dims under strict sharding
    typing; GSPMD inserts the collective)."""

    def f(v):
        key = tuple(idx if i == axis else slice(None)
                    for i in range(v.ndim))
        return v.at[key].get(out_sharding=sharding)

    return _map(x, f)


def getitem(x, key):
    return _map(x, lambda v: v[key])


def pad(x, pad_width, **kw):
    return _map(x, lambda v: jnp.pad(v, pad_width, **kw))


def concatenate(xs, axis):
    if any(isinstance(x, CDF64) for x in xs):
        return CDF64(*(jnp.concatenate([x.quad[i] for x in xs], axis=axis)
                       for i in range(4)))
    if any(isinstance(x, DF64) for x in xs):
        return DF64(
            jnp.concatenate([x.hi for x in xs], axis=axis),
            jnp.concatenate([x.lo for x in xs], axis=axis),
        )
    if any(is_pair(x) for x in xs):
        xs = [as_pair(x) for x in xs]
        return ComplexPair(
            jnp.concatenate([x.re for x in xs], axis=axis),
            jnp.concatenate([x.im for x in xs], axis=axis),
        )
    return jnp.concatenate(xs, axis=axis)


def where(cond, x, other):
    if is_pair(x):
        other = as_pair(other) if _is_complex_scalar_or_array(other) or is_pair(other) else ComplexPair(other, other)
        return ComplexPair(
            jnp.where(cond, x.re, other.re), jnp.where(cond, x.im, other.im)
        )
    return jnp.where(cond, x, other)


def nan_to_num(x, nan=0.0):
    return _map(x, lambda v: jnp.nan_to_num(v, nan=nan))


def reduce(x, fn, axis, **kw):
    """Apply a reduction (jnp.sum / jnp.mean) over axes; componentwise for
    pairs.  Order-dependent reductions (max/min) reject pairs upstream."""
    return _map(x, lambda v: fn(v, axis=axis, **kw))


def fftshift(x, axes):
    return _map(x, lambda v: jnp.fft.fftshift(v, axes=axes))


def ifftshift(x, axes):
    return _map(x, lambda v: jnp.fft.ifftshift(v, axes=axes))


def exp_i(theta_np: np.ndarray, like):
    """exp(i*theta) for a host-side numpy phase array, in the representation
    of `like` (pair -> ComplexPair constant, else native complex constant)."""
    if is_pair(like):
        rdtype = _float_of(like.dtype)
        return ComplexPair(
            jnp.asarray(np.cos(theta_np).astype(rdtype)),
            jnp.asarray(np.sin(theta_np).astype(rdtype)),
        )
    cdtype = np.result_type(np.dtype(like.dtype), np.complex64)
    return jnp.asarray((np.cos(theta_np) + 1j * np.sin(theta_np)).astype(cdtype))


def constant(values_np: np.ndarray, like):
    """Embed a host numpy constant in the representation of `like`."""
    if is_pair(like) and values_np.dtype.kind == "c":
        rdtype = _float_of(like.dtype)
        return ComplexPair(
            jnp.asarray(np.ascontiguousarray(values_np.real).astype(rdtype)),
            jnp.asarray(np.ascontiguousarray(values_np.imag).astype(rdtype)),
        )
    return jnp.asarray(values_np)
