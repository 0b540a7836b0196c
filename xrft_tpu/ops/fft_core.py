"""Backend-dispatched N-D FFT primitives.

Replaces the reference's numpy/dask execution fork (``_fft_module``,
``/root/reference/xrft/xrft.py:32-36``) with an XLA-engine fork:

  * ``xla``    — lower to the FFT HLO (CPU/GPU: pocketfft/ducc & cuFFT),
                 native complex dtypes.  The default.
  * ``matmul`` — the four-step matmul engine over split-complex pairs
                 (plain JAX dots; kept reachable through
                 ``config.fft_engine`` until ROADMAP.md Design 1.2).

Both engines implement the same unnormalized-forward / (1/N)-inverse
convention as ``numpy.fft``, so every downstream scaling rule (true
amplitude, density/spectrum, Parseval factors) is engine-independent.

The *representation* of complex results (native complex array vs
``ComplexPair``) is chosen by :func:`use_split_complex`; all call sites in
the transform layer are representation-generic via :mod:`.carray`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import check_backend, config, resolve_fft_engine
from . import carray
from .carray import as_native, as_pair, is_pair
from .matmul_fft import matmul_fft_nd

__all__ = [
    "fftn", "ifftn", "rfftn", "irfftn", "fftshift", "ifftshift",
    "use_split_complex",
]


def use_split_complex() -> bool:
    """True when complex data must be carried as split (re, im) pairs.

    auto: native complex on the supported backends (and an error on any
    other, see :func:`..config.check_backend`).  Tests force split mode on
    CPU to keep the split-pair code path covered.
    """
    mode = config.complex_mode
    if mode == "auto":
        check_backend()
        return False
    return mode == "split"


def xla_irfftn(x, axes):
    """``np.fft.irfftn(x, axes=axes)`` for ANY input, Hermitian-consistent
    or not: the reference xrft's ``ifft`` with ``real_dim`` is numpy's
    ``irfftn``, and these are its semantics.

    numpy runs complex inverse FFTs over ``axes[:-1]``, then a 1-D c2r
    over ``axes[-1]`` that reads only the real parts of the DC and Nyquist
    planes.  Only those two planes hold redundant bins (k and -k along the
    leading axes), and a multi-dimensional c2r library call (cuFFT's)
    reads inconsistent ones differently.  Replacing each by its Hermitian
    part along the leading axes gives the input whose one c2r transform
    every library agrees on, and it is numpy's result.
    """
    x = jnp.asarray(x)
    *lead, last = [a % x.ndim for a in axes]
    if jnp.iscomplexobj(x):
        m = x.shape[last]
        for k in sorted({0, m - 1}):
            ix = (slice(None),) * last + (slice(k, k + 1),)
            plane = x[ix]
            mirror = plane     # bin -k (mod n) at k along each leading axis
            for a in lead:
                mirror = jnp.roll(jnp.flip(mirror, a), 1, a)
            x = x.at[ix].set((plane + jnp.conj(mirror)) / 2)
    return jnp.fft.irfftn(x, axes=axes)


def _xla_fft_nd(x, axes, kind):
    if kind == "fft":
        return jnp.fft.fftn(x, axes=axes)
    if kind == "ifft":
        return jnp.fft.ifftn(x, axes=axes)
    if kind == "rfft":
        return jnp.fft.rfftn(x, axes=axes)
    if kind == "irfft":
        return xla_irfftn(x, axes)
    raise ValueError(kind)


def _dispatch(x, axes, kind, engine=None, pre_shift_axes=(),
              post_shift_axes=(), post_kind="fftshift"):
    if isinstance(axes, int):
        axes = [axes]
    if isinstance(x, carray.CDF64):
        # df64 quad reaching an f32-grade engine (e.g. a jit-staged
        # complex128 LabeledArray, see labeled.tree_flatten): the hi limbs
        # ARE the correctly rounded f32 values
        x = carray.ComplexPair(x.rh, x.ih)
    elif isinstance(x, carray.DF64):
        x = x.hi
    split_in = is_pair(x)
    if not split_in and not isinstance(x, jax.Array):
        arr = np.asarray(x)
        if arr.dtype.kind == "c" and use_split_complex():
            x = as_pair(arr)  # split on host; never device_put complex
            split_in = True
        else:
            x = jnp.asarray(arr)
    axes = [a % x.ndim for a in axes]
    pre = [a % x.ndim for a in pre_shift_axes]
    post = [a % x.ndim for a in post_shift_axes]
    split_out = split_in or use_split_complex()
    engine = resolve_fft_engine(engine)
    post_fn = carray.fftshift if post_kind == "fftshift" else carray.ifftshift
    if engine == "xla":
        if pre:
            x = carray.ifftshift(x, pre)
        out = _xla_fft_nd(as_native(x), tuple(axes), kind)
        if post:
            out = post_fn(out, post)
        if split_out and np.dtype(out.dtype).kind == "c":
            out = as_pair(out)
        return out
    # shifts are absorbed into the engine's constant matrices (for irfft:
    # non-real axes via weights, the real-axis output roll via the packed
    # half-length transform when n % 4 == 0, explicit otherwise)
    out = matmul_fft_nd(x, axes, kind, pre, post, post_kind)
    if not split_out and is_pair(out):
        out = as_native(out)
    return out


def fftn(x, axes, engine=None, pre_shift_axes=(), post_shift_axes=()):
    return _dispatch(x, axes, "fft", engine, pre_shift_axes, post_shift_axes)


def ifftn(x, axes, engine=None, pre_shift_axes=(), post_shift_axes=(),
          post_kind="fftshift"):
    return _dispatch(x, axes, "ifft", engine, pre_shift_axes,
                     post_shift_axes, post_kind)


def rfftn(x, axes, engine=None, pre_shift_axes=(), post_shift_axes=()):
    """Real N-D FFT; the real (half-spectrum) axis is ``axes[-1]`` which
    must be the trailing axis of ``x``."""
    return _dispatch(x, axes, "rfft", engine, pre_shift_axes,
                     post_shift_axes)


def irfftn(x, axes, engine=None, pre_shift_axes=(), post_shift_axes=(),
           post_kind="fftshift"):
    return _dispatch(x, axes, "irfft", engine, pre_shift_axes,
                     post_shift_axes, post_kind)


def fftshift(x, axes):
    return carray.fftshift(x, axes)


def ifftshift(x, axes):
    return carray.ifftshift(x, axes)
