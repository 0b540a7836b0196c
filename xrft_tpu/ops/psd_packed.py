"""Hermitian row-pair packed two-sided PSD (matmul engine only).

The fused one-sided route (:mod:`.psd_fused`) computes an rfft over the
half axis for every row of every other transform axis, then pays a
Hermitian mirror gather to expand the one-sided PSD to the full grid.
This route instead uses the classic real-FFT *packing* identity in 2-D:
pack adjacent rows along the non-half transform axis as the real and
imaginary parts of ONE complex field,

    z[u, x] = f[2u, x] + i f[2u+1, x],      u in [0, Y/2)

run a half-size complex 2-D FFT ``A = FFT2(z)`` (every engine dot now
touches HALF the elements of the one-sided scheme's intermediates, with
no pruning-padding), and assemble the full two-sided PSD elementwise.
With ``Abar[l,k] = conj(A[-l mod U, -k mod Nx])``:

    E = (A + Abar)/2        (2-D transform of the even rows)
    O = (A - Abar)/(2i)     (2-D transform of the odd rows)
    G[l + b*U, k] = E[l,k] + (-1)^b W_Y^l O[l,k],   W_Y = e^{-2 pi i/Y}

so with P = (|A|^2 + |Abar|^2)/2, Cr = Im(A conj(Abar))/2,
Ci = -(|A|^2 - |Abar|^2)/4:

    |G[l + b*U, k]|^2 = P + (-1)^b 2 (cos(2 pi l/Y) Cr + sin(2 pi l/Y) Ci)

Both output halves (b = 0, 1) read the SAME A — the Hermitian mirror
never happens as a separate pass: k spans the full two-sided grid
already, and the l-axis doubling is the cheap elementwise +-cross split.
The requested fftshift on the output y axis is just the concat order of
the two halves (free); the x-axis shift rides the engine's absorbed
column permutation as usual.

Numerically the combine adds ~1 ulp of f32 elementwise error on top of
the engine's ~1.6e-7; the route is pinned against the generic path at
1e-12 in f64 (tests/test_psd_packed.py).

**Default-disabled** (``config.psd_packed = "never"``): on the
accelerator it was written for it measured a net loss against the
one-sided fused + mirror route.  Why the classic packing identity does
NOT pay here: the one-sided stacked engine already exploits input
realness — its level-0 dots contract a real operand (half the MACs of a
complex dot) and the rfft axis prunes half its final-level weight
columns — so packing's "half-size transform" performs the SAME matmul
work, merely rearranged; meanwhile the
combine must read both standard-layout planes plus their
flip+roll(negation-map) partners, several extra bandwidth-bound passes
that the mirror route never pays.  Kept as an opt-in with parity tests:
the accounting is instructive and the identity may win on hardware
whose FFT path cannot exploit realness directly.

Reference semantics served: ``power_spectrum`` on real input over two
dims (``/root/reference/xrft/xrft.py:685-750``).
"""

from __future__ import annotations

import types

import jax.numpy as jnp
import numpy as np

from .. import coords as ce
from ..config import config, resolve_fft_engine
from ..labeled import Coord, LabeledArray
from . import carray, stacked_fft
from .psd_fused import _ALLOWED_KW, _steered_front, _window_multiply
from .window import WINDOW_TYPES

__all__ = ["packed_psd_applicable", "packed_two_sided_psd"]


def packed_psd_applicable(da, dims, half_dim, shift, kwargs) -> bool:
    """True when the packed two-sided PSD can serve this request: exactly
    two transform dims, real float data, even non-half extent, stacked
    plans for both the packed (Y/2) and x sizes, matmul engine."""
    mode = config.psd_packed
    if mode not in ("auto", "never"):
        raise ValueError(
            f"config.psd_packed must be 'auto' or 'never', got {mode!r}")
    if mode == "never":
        return False
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
    if len(dims) != 2 or dims[-1] != half_dim:
        return False
    y_dim = dims[0]
    Y, Nx = da.sizes[y_dim], da.sizes[half_dim]
    if Y % 2 != 0 or Y < 4:
        return False
    # the packed complex FFT runs (Y/2, Nx); x may absorb the shift
    shape = (Y // 2, Nx)
    proxy = types.SimpleNamespace(shape=shape, dtype=np.dtype(data.dtype))
    post = (1,) if shift else ()
    return stacked_fft.stacked_supported(proxy, [1, 0], "fft", (), post)


def _neg_perm(x, axis, h, n):
    """Apply o -> (2h - o) mod n along `axis` (the negation map on a
    possibly-shifted grid): flip + roll((2h + 1 - n) % n)."""
    out = jnp.flip(x, axis)
    r = (2 * h + 1 - n) % n
    if r:
        out = jnp.roll(out, r, axis)
    return out


def packed_two_sided_psd(da, dims, half_dim, shift, scale, kwargs
                         ) -> LabeledArray:
    """Full two-sided PSD of real `da` over ``dims = [y, x]`` as one
    packed program; `scale` folds true-amplitude and density/correction
    factors.  Output matches ``power_spectrum``'s full-grid layout
    (both freq axes fftshifted when ``shift``)."""
    prefix = kwargs.get("prefix", "freq_")
    data, axes, window, ctx = _steered_front(da, dims, half_dim, kwargs)
    rdt = ctx["rdt"]
    daT = ctx["da"]
    y_ax, x_ax = axes  # in the steered frame: y leading, x trailing
    Y = daT.sizes[dims[0]]
    Nx = daT.sizes[half_dim]
    U = Y // 2

    # window: explicit multiply BEFORE packing (the y factor differs
    # between the packed planes, so the engine's per-axis pre_weights
    # cannot carry it); XLA fuses it into the packing/stack pass
    if window is not None:
        data = _window_multiply(data, window, dims, axes, daT.sizes, rdt)

    # pack adjacent y rows: z = f[0::2] + i f[1::2]
    idx_even = tuple(slice(0, None, 2) if i == y_ax else slice(None)
                     for i in range(data.ndim))
    idx_odd = tuple(slice(1, None, 2) if i == y_ax else slice(None)
                    for i in range(data.ndim))
    z = carray.ComplexPair(data[idx_even], data[idx_odd])

    post = (x_ax,) if shift else ()
    a_raw, layout = stacked_fft.fft_nd_stacked(
        z, [x_ax, y_ax], "fft", (), post, raw=True)
    ar_r, ai_r = stacked_fft.raw_planes(a_raw, layout)

    # restore the complex planes to the CALLER's dim order once; all the
    # elementwise combine work reads these two standard-layout planes
    order = [ctx["newdims"].index(d) for d in ctx["orig_dims"]]
    Are = stacked_fft.raw_to_standard(ar_r, layout, axis_order=order)
    Aim = stacked_fft.raw_to_standard(ai_r, layout, axis_order=order)

    u_pos = ctx["orig_dims"].index(dims[0])
    x_pos = ctx["orig_dims"].index(half_dim)
    hx = Nx // 2 if shift else 0

    # partner Abar = conj(A at the negated (possibly shifted) indices)
    def neg(x):
        out = _neg_perm(x, u_pos, 0, U)
        return _neg_perm(out, x_pos, hx, Nx)

    Bre, Bim = neg(Are), -neg(Aim)

    sA = Are * Are + Aim * Aim
    sB = Bre * Bre + Bim * Bim
    half_c = jnp.asarray(np.asarray(0.5, rdt))
    P = (sA + sB) * half_c
    Cr = Aim * Bre - Are * Bim          # 2*Cr, fold the 1/2 into coeffs
    Ci = sB - sA                        # -4*Ci
    lp = np.arange(U)
    th = 2.0 * np.pi * lp / Y
    cshape = [1] * Are.ndim
    cshape[u_pos] = U
    cc = jnp.asarray((np.cos(th)).astype(rdt).reshape(cshape))
    ss = jnp.asarray((0.5 * np.sin(th)).astype(rdt).reshape(cshape))
    cross = cc * Cr + ss * Ci
    s_c = jnp.asarray(np.asarray(scale, rdt))
    Pp = (P + cross) * s_c              # rows l' (b=0)
    Pm = (P - cross) * s_c              # rows l'+U (b=1)
    # output y order: shifted puts the b=1 half first ((l - Y/2) mod Y)
    full = jnp.concatenate([Pm, Pp] if shift else [Pp, Pm], axis=u_pos)

    # ---- output metadata: identical to the generic full two-sided PSD
    k = ce.freq_grids(ctx["N"], ctx["delta"], False, shift)
    swap = {d: ce.freq_dim_name(d, prefix) for d in dims}
    out_dims = [swap.get(d, d) for d in ctx["orig_dims"]]
    out_coords = {}
    for cname, c in daT.coords.items():
        if cname in dims:
            continue
        out_coords[cname] = c.copy()
    for d, kk in zip(dims, k):
        fd = swap[d]
        spacing = kk[1] - kk[0] if kk.size > 1 else 0.0
        out_coords[fd] = Coord((fd,), kk, {"spacing": spacing}, fd)
    return LabeledArray(full, dims=out_dims, coords=out_coords,
                        name=da.name)
