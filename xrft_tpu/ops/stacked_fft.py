"""Stacked-complex pad-free matmul FFT engine (``fft_engine="matmul"``).

Plain JAX, kept reachable until ROADMAP.md Design 1.2 removes it; the
default engine is XLA's FFT (cuFFT on a GPU).  The pair engine
(:mod:`.matmul_fft`) carries complex data as a ``ComplexPair`` of separate
(re, im) arrays, so every complex DFT step is 4 real matmuls plus
elementwise combines — each materializing full-size intermediates, about
3x the minimum memory traffic per transform axis.

This engine reformulates every complex DFT stage as ONE ``lax.dot_general``
over a *stacked* representation (re/im as a length-2 axis of a single
array), contracting ``(c, j)`` with a host-built block weight
``W[c_in, j, c_out, k] = [[Re W, Im W], [-Im W, Re W]]``:

    out[c'] = re @ Re(W) - im @ Im(W)   /   re @ Im(W) + im @ Re(W)

Two layout rules shape the schedule (chosen with
``compiled.cost_analysis()`` + wall clock when the engine was tuned):

1. **No tiny minor dims.**  An XLA layout that tiles the two
   physically-minor array dims to (8, 128) pads a trailing ``(2, K)``
   stacked-complex axis up to 8-16x memory traffic.  Therefore non-final dots put the constant weight on
   the *LHS* of ``dot_general`` (output = (2, k1, <big free dims>), the
   small dims become major), the final dot merges its output complex planes
   into one ``2*K >= 128`` trailing dim, and radix plans put the largest
   factor (ideally 128) last.
2. **Fold twiddles into the next dot.**  The four-step twiddle
   ``T[k1, m]`` is folded into the following level's weight, batched over
   the ``k1`` digit (dot_general batch dims), eliminating a full
   elementwise memory pass per axis.

Outputs of each level's dot keep the emitted frequency digit wherever the
dot semantics place it ("deferred interleave"); a single epilogue
transpose+reshape pass restores standard order for all axes at once and
also absorbs fftshift/ifftshift permutations (rolled into the constant
weights' rows/columns where digit parity allows).

Supported here: forward ``fft``/``rfft`` (real trailing axis, with the
Hermitian half-spectrum *pruned at the weight level* — only
``r_last//2 + 1`` of the last digit's columns are ever computed) and
``ifft``, for any axis set whose sizes factor into radices
``<= config.direct_dft_max``.  Everything else (Bluestein primes, irfft,
native-complex CPU mode) falls back to the pair engine in
:mod:`.matmul_fft`, which remains the reference implementation this one is
cross-validated against (tests/test_stacked_fft.py, 1e-11 in f64).

Replaces what numpy/pocketfft provides to the reference library
(dispatch: ``/root/reference/xrft/xrft.py:32-36``).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..config import config
from .carray import ComplexPair, as_pair, is_pair
from .matmul_fft import _dft_matrix_np, _twiddle_np, _PRECISIONS

__all__ = ["stacked_supported", "fft_nd_stacked", "RawStacked",
           "raw_planes", "raw_to_standard", "raw_axis_factor"]


def _precision():
    return _PRECISIONS[config.matmul_precision]


# --------------------------------------------------------------------------
# Radix planning
# --------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _largest_divisor(n: int, cap: int) -> int:
    best = 1
    d = 1
    while d * d <= n:
        if n % d == 0:
            if d <= cap and d > best:
                best = d
            q = n // d
            if q <= cap and q > best:
                best = q
        d += 1
    return best


@lru_cache(maxsize=None)
def _plan_naive(n: int, cap: int) -> tuple[int, ...] | None:
    """Greedy big-factor split, sorted ascending (big radix last)."""
    if n <= 1:
        return None  # nothing to gain; let the fallback handle n==1
    if n <= cap:
        return (n,)
    radices = []
    rem = n
    while rem > cap:
        r = _largest_divisor(rem, cap)
        if r == 1:
            return None  # prime factor > cap: Bluestein fallback
        radices.append(r)
        rem //= r
    radices.append(rem)
    return tuple(sorted(radices))


@lru_cache(maxsize=None)
def plan(n: int, cap: int) -> tuple[int, ...] | None:
    """Radix plan [r0, ..., r_last]: r0 is contracted first (the major
    input digit, emitting the least-significant output digit); r_last is
    chosen as large as possible (trailing-dim tiling wants >= 128)."""
    radices = _plan_naive(n, cap)
    if radices is None:
        return None
    if min(radices) < 16:
        # Rebalance degenerate splits (1024 -> (8, 128),
        # 32768 -> (2, 128, 128)): a tiny digit dim pads up to 16x under
        # an (8, 128) tiling when it lands minor in an intermediate or
        # the epilogue — a 16 GB HLO temp (OOM) on a segmented 4096^2
        # pipeline.  Prefer the same-level
        # factorization maximizing the smallest factor
        # (1024 -> (32, 32), 32768 -> (32, 32, 32)).
        bal = _balanced_factors(n, cap, len(radices))
        if bal is not None and min(bal) > min(radices):
            radices = bal
    # contraction order: big radix last
    return tuple(sorted(radices))


@lru_cache(maxsize=None)
def plan_raw(n: int, cap: int, pre: bool, post: bool
             ) -> tuple[int, ...] | None:
    """Radix plan for RAW-layout consumers (``raw=True``): prefer the
    unrebalanced big-last split when its smallest digit still aligns to
    the 8-wide sublane tile and it honors any absorbed shifts.

    The rebalance in :func:`plan` exists for the standard epilogue's
    padded-temp blowup; the raw route never materializes that layout, and
    the big-last plan keeps the final-level merged columns >= 128 wide
    (about half the time on the segmented 1024^2-plan Welch flagship when
    it was measured)."""
    naive = _plan_naive(n, cap)
    reb = plan(n, cap)
    if (naive is not None and naive != reb and min(naive) >= 8
            and _shifts_absorbable(n, naive, pre, post)):
        return naive
    return reb


@lru_cache(maxsize=None)
def _balanced_factors(n: int, cap: int, levels: int) -> tuple | None:
    """Factor n into `levels` factors <= cap maximizing the smallest
    factor (host-side, cached; used to rebalance degenerate plans)."""
    if levels == 1:
        return (n,) if n <= cap else None
    target = round(n ** (1.0 / levels))
    best = None
    for d in sorted((d for d in range(2, cap + 1) if n % d == 0),
                    key=lambda d: abs(d - target)):
        rest = _balanced_factors(n // d, cap, levels - 1)
        if rest is None:
            continue
        cand = tuple(sorted((d,) + rest))
        if best is None or min(cand) > min(best):
            best = cand
            if min(best) >= target:
                break
    return best


def _shifts_absorbable(n: int, F: tuple[int, ...], pre: bool,
                       post: bool) -> bool:
    if len(F) == 1:
        return True  # full row/col permutations on the direct matrix
    if pre and F[0] % 2 != 0:
        return False
    if post and F[-1] % 2 != 0:
        return False
    return True


def stacked_supported(x, axes, kind, pre_axes, post_axes) -> bool:
    """True when this engine can run the request (else: pair engine)."""
    if config.stacked_fft == "never":
        return False
    if kind not in ("fft", "ifft", "rfft"):
        return False
    shape = x.re.shape if is_pair(x) else x.shape
    if kind == "rfft" and (is_pair(x) or np.dtype(x.dtype).kind == "c"):
        return False  # complex rfft input: pair engine full-fft+slice path
    cap = config.direct_dft_max
    for a in axes:
        F = plan(shape[a], cap)
        if F is None:
            return False
        if not _shifts_absorbable(shape[a], F, a in pre_axes, a in post_axes):
            return False
    return True


# --------------------------------------------------------------------------
# Host-side stacked weight factories (f64 trig; see matmul_fft constants)
# --------------------------------------------------------------------------


def _w_complex_np(r: int, sign: int, pre_roll: int = 0, post_roll: int = 0,
                  kcols: int | None = None, pre_perm: bool = False,
                  post_perm: str | None = None,
                  scale: float = 1.0) -> np.ndarray:
    """Dense complex DFT_r with optional absorbed shifts.

    pre_roll:  rows rolled by +h (absorbs input ifftshift: the digit map
               (i - h) mod r, W' = np.roll(W, h, axis=0)).
    post_roll: columns rolled by +h (absorbs output fftshift on this
               axis's most-significant digit).
    pre_perm/post_perm: full single-level permutations (direct case, any
               parity): ifftshift input / fft-/ifftshift output.
    """
    w = _dft_matrix_np(r, sign).copy()
    if pre_perm:
        # y[j] = x[(j + r//2) mod r]  ->  W'[i] = W[(i - r//2) mod r]
        w = np.roll(w, r // 2, axis=0)
    elif pre_roll:
        w = np.roll(w, pre_roll, axis=0)
    if post_perm == "fftshift":
        w = np.roll(w, r // 2, axis=1)
    elif post_perm == "ifftshift":
        w = np.roll(w, -(r // 2), axis=1)
    elif post_roll:
        w = np.roll(w, post_roll, axis=1)
    if kcols is not None:
        w = w[:, :kcols]
    if scale != 1.0:
        w = w * scale
    return w


def _stack_lhs(wc: np.ndarray, real_in: bool, rdt) -> np.ndarray:
    """Weight for W-LHS dots: (2, k, [ci,] j) — output prepends (2, k)."""
    wr = wc.real.astype(rdt).T  # (k, j)
    wi = wc.imag.astype(rdt).T
    if real_in:
        return np.stack([wr, wi], axis=0)  # (2, k, j)
    out = np.empty((2,) + wr.shape[:1] + (2,) + wr.shape[1:], rdt)
    out[0, :, 0, :] = wr   # re @ Re
    out[0, :, 1, :] = -wi  # im @ -Im
    out[1, :, 0, :] = wi
    out[1, :, 1, :] = wr
    return out  # (co, k, ci, j)


def _batched_lhs(tw: np.ndarray, wc: np.ndarray, rdt) -> np.ndarray:
    """Final-level W-LHS with folded twiddle: (kb, co, K, ci, m)."""
    wfull = tw[:, :, None] * wc[None, :, :]  # (kb, m, K)
    kb, m, K = wfull.shape
    out = np.empty((kb, 2, K, 2, m), rdt)
    wr = np.swapaxes(wfull.real, 1, 2).astype(rdt)  # (kb, K, m)
    wi = np.swapaxes(wfull.imag, 1, 2).astype(rdt)
    out[:, 0, :, 0, :] = wr
    out[:, 0, :, 1, :] = -wi
    out[:, 1, :, 0, :] = wi
    out[:, 1, :, 1, :] = wr
    return out


def _merged_rhs(wc: np.ndarray, rdt, tw: np.ndarray | None,
                real_in: bool) -> np.ndarray:
    """Final-dot W-RHS with c-major-merged output columns.

    With twiddle: (kb, ci, m, 2K); without (single-level final axis):
    (ci, m, 2K) or (m, 2K) for real input."""
    if tw is not None:
        wfull = tw[:, :, None] * wc[None, :, :]  # (kb, m, K)
        kb, m, K = wfull.shape
        out = np.empty((kb, 2, m, 2 * K), rdt)
        out[:, 0, :, :K] = wfull.real
        out[:, 1, :, :K] = -wfull.imag
        out[:, 0, :, K:] = wfull.imag
        out[:, 1, :, K:] = wfull.real
        return out
    m, K = wc.shape
    if real_in:
        out = np.empty((m, 2 * K), rdt)
        out[:, :K] = wc.real
        out[:, K:] = wc.imag
        return out
    out = np.empty((2, m, 2 * K), rdt)
    out[0, :, :K] = wc.real
    out[1, :, :K] = -wc.imag
    out[0, :, K:] = wc.imag
    out[1, :, K:] = wc.real
    return out


# --------------------------------------------------------------------------
# Raw (pre-epilogue) layout support
# --------------------------------------------------------------------------


class RawStacked:
    """Layout descriptor for a raw (pre-epilogue) stacked-engine result:
    which token lives at which position of the returned array, plus the
    per-axis radix plans needed to map digit slots back to standard
    frequency indices."""

    def __init__(self, dims, in_shape, order, plans, prune_axis, merged_K):
        self.dims = dims            # token tuple for the raw array's axes
        self.in_shape = in_shape
        self.order = order          # transform axes, in transform order
        self.plans = plans          # {axis: radix plan}
        self.prune_axis = prune_axis
        self.merged_K = merged_K    # K of the merged (c-major 2K) slot
        self.last_ax = order[-1]
        self.ndim = len(in_shape)


def raw_planes(a, layout):
    """(re, im) slices of the merged trailing (c-major 2K) axis — lazy
    views that fuse into the consumer."""
    K = layout.merged_K
    last = a.ndim - 1
    return (lax.slice_in_dim(a, 0, K, axis=last),
            lax.slice_in_dim(a, K, 2 * K, axis=last))


def _axis_dig_positions(layout, ax):
    """Positions (in layout.dims) of ax's digit slots, most significant
    first; the merged col slot (always last) stands in for the last
    transformed axis's final digit."""
    F = layout.plans[ax]
    dims = list(layout.dims)
    if ax == layout.last_ax:
        return [len(dims) - 1] + [dims.index(_dig(ax, lvl))
                                  for lvl in reversed(range(len(F) - 1))]
    return [dims.index(_dig(ax, lvl)) for lvl in reversed(range(len(F)))]


def raw_axis_factor(x_shape, vec, layout, ax, pad_value=1.0):
    """Host-side: reshape a 1-D per-frequency factor ``vec`` (standard
    frequency order) for transform axis ``ax`` into a numpy array that
    broadcasts over a reduced raw-layout array of shape ``x_shape`` (an
    elementwise reduction of the planes, post :func:`raw_planes`).  The
    multiply then fuses into the reduction pass — no extra memory pass,
    vs. a broadcast multiply after the restore.  ``vec`` may be shorter
    than the engine-padded digit width of the pruned axis; the tail (dead
    columns dropped by the restore's prune slice) is filled with
    ``pad_value``."""
    poss = _axis_dig_positions(layout, ax)
    sizes = [int(x_shape[p]) for p in poss]
    need = int(np.prod(sizes))
    v = np.asarray(vec)
    if v.ndim != 1 or v.shape[0] > need:
        raise ValueError(
            f"factor of length {v.shape} does not fit digit width {need}")
    if v.shape[0] < need:
        v = np.concatenate([v, np.full(need - v.shape[0], pad_value,
                                       dtype=v.dtype)])
    vr = v.reshape(sizes)                      # msf digit order
    order = np.argsort(poss)                   # ascending raw positions
    vt = np.transpose(vr, tuple(order))
    bshape = [1] * len(x_shape)
    for p, s in zip(poss, sizes):
        bshape[p] = s
    return vt.reshape(bshape)


def raw_to_standard(x, layout, axis_order=None):
    """Restore a real reduced raw-layout array (an elementwise reduction
    of the planes, e.g. |F|^2) to standard frequency order with ONE
    reshape pass; slices the pruned rfft axis to its one-sided length.
    ``axis_order`` emits the original axes in an arbitrary order (the
    permutation rides the same single pass for free)."""
    perm, new_sizes = [], []
    prune_pos = None
    for i in (axis_order if axis_order is not None else range(layout.ndim)):
        if i in layout.order:
            poss = _axis_dig_positions(layout, i)
            perm.extend(poss)
            if i == layout.prune_axis:
                prune_pos = len(new_sizes)
            new_sizes.append(int(np.prod([x.shape[p] for p in poss])))
        else:
            p = layout.dims.index(_orig(i))
            perm.append(p)
            new_sizes.append(x.shape[p])
    out = lax.reshape(x, tuple(new_sizes), dimensions=tuple(perm))
    if prune_pos is not None:
        n = layout.in_shape[layout.prune_axis]
        out = lax.slice_in_dim(out, 0, n // 2 + 1, axis=prune_pos)
    return out


# --------------------------------------------------------------------------
# Driver
# --------------------------------------------------------------------------

# dims-slot tokens
_C = ("c",)                      # stacked complex plane axis (size 2)


def _orig(i):
    return ("orig", i)


def _dig(ax, lvl):
    return ("dig", ax, lvl)      # emitted output digit


def _in(ax, lvl):
    return ("in", ax, lvl)       # pre-split input digit (level-0 major)


def _ck(ax, lvl):
    return ("ck", ax, lvl)       # merged (c, K) final axis


def fft_nd_stacked(x, axes, kind: str, pre_shift_axes=(), post_shift_axes=(),
                   post_kind: str = "fftshift", pre_weights=None,
                   raw: bool = False, inter_axis_barrier: bool = False):
    """N-D forward/inverse FFT via the stacked-complex pad-free schedule.

    Caller contract matches :func:`matmul_fft.matmul_fft_nd` for the
    supported kinds; call :func:`stacked_supported` first.

    Two extensions serve the fused spectral-estimator paths:

    ``pre_weights`` — ``{axis: 1-D float64 array}`` of per-element input
    weights (separable window factors).  Direct (single-level) plans fold
    the weight into the dot's rows (exactly free); multi-level plans apply
    it as an elementwise broadcast multiply immediately before the axis's
    first dot, where XLA fuses it into the preceding dot's output fusion
    (axes after the first: zero extra memory passes) or the input layout
    copy.  Weighted axes must not also request an absorbed input
    ifftshift.

    ``raw=True`` — skip the standard-order epilogue and return
    ``(array, RawStacked)``: the stacked-complex result in the engine's
    deferred-interleave digit layout plus the metadata needed to (a) build
    broadcastable per-axis frequency factors in that layout
    (:func:`raw_axis_factor`), and (b) restore standard order later with a
    single reshape (:func:`raw_to_standard`).  Estimators that reduce the
    complex planes elementwise (|F|^2) run the reduction in the raw layout
    and only pay the restore pass on the (half-size, real) reduced array.
    """
    if not is_pair(x) and not isinstance(x, jax.Array):
        xx = np.asarray(x)
        x = as_pair(xx) if xx.dtype.kind == "c" else jnp.asarray(xx)
    if not is_pair(x) and np.dtype(x.dtype).kind == "c":
        x = as_pair(x)

    if is_pair(x):
        rdtype = np.dtype(x.re.dtype)
        a = jnp.stack([x.re, x.im], axis=0)       # c leading
        has_c = True
        ndim = x.re.ndim
    else:
        rdtype = np.dtype(x.dtype)
        if rdtype == np.dtype(np.float64) or rdtype == np.dtype(np.float32):
            pass
        else:
            x = x.astype(np.float32)
            rdtype = np.dtype(np.float32)
        a = x
        has_c = False
        ndim = x.ndim

    prec = _precision()
    cap = config.direct_dft_max
    sign = -1 if kind in ("fft", "rfft") else +1
    axes = [ax % ndim for ax in axes]
    pre_set = {ax % ndim for ax in pre_shift_axes}
    post_set = {ax % ndim for ax in post_shift_axes}
    in_shape = x.re.shape if is_pair(x) else x.shape

    # inverse normalization: fold 1/N into the very last dot's weight
    scale = 1.0
    if kind == "ifft":
        for ax in axes:
            scale /= in_shape[ax]

    # rfft: the real (trailing) axis first, pruned; others after
    if kind == "rfft":
        assert axes[-1] == ndim - 1
        order = [axes[-1]] + list(axes[:-1])
        prune_axis = axes[-1]
        assert prune_axis not in post_set
    else:
        order = list(axes)
        prune_axis = None

    # per-axis radix plans: raw-layout consumers prefer the unrebalanced
    # big-last split (see plan_raw); the standard epilogue keeps plan().
    # The pruned rfft axis of a raw-layout consumer gets a SINGLE direct
    # dot up to config.direct_prune_max: one digit leaves the one-sided
    # axis contiguous in the raw layout, collapsing the estimator's
    # restore pass from level-0-digit-sized runs (a pathological
    # transpose at 1024=(8,128)) to a near-free reshape (see
    # config.direct_prune_max).
    axplan = {}
    for ax in order:
        n_ax = in_shape[ax]
        if (raw and ax == prune_axis and ax not in pre_set
                and cap < n_ax <= config.direct_prune_max):
            axplan[ax] = (n_ax,)
        elif raw:
            axplan[ax] = plan_raw(n_ax, cap, ax in pre_set, ax in post_set)
        else:
            axplan[ax] = plan(n_ax, cap)

    dims: list = ([_C] if has_c else []) + [_orig(i) for i in range(ndim)]

    # Pre-split every transform axis into its digit dims in ONE reshape
    # (row-major, level-0 digit major).  At the input this merges into the
    # layout copy / elementwise fusion XLA emits anyway; splitting lazily
    # per level was measured to materialize a full physical reshape
    # between axes (the minor-dims tiling changes when a just-transformed
    # axis stops being trailing).
    new_dims: list = []
    new_shape: list = []
    for q, tok in enumerate(dims):
        if tok != _C and tok[0] == "orig" and tok[1] in order:
            i = tok[1]
            for lvl, r in enumerate(axplan[i]):
                new_dims.append(_in(i, lvl))
                new_shape.append(r)
        else:
            new_dims.append(tok)
            new_shape.append(a.shape[q])
    dims = new_dims
    if tuple(new_shape) != tuple(a.shape):
        a = a.reshape(tuple(new_shape))

    def pos(tok):
        return dims.index(tok)

    total_dots = sum(len(axplan[ax]) for ax in order)
    dot_i = 0

    for ax_i, ax in enumerate(order):
        if inter_axis_barrier and ax_i > 0:
            # decouple this axis's first dot from the previous axis's
            # output fusion: a window pre_weights multiply here (an extra
            # copy pipeline) measured FASTER despite more cost-model
            # traffic — the barrier reproduces the schedule break without
            # the multiply
            a = lax.optimization_barrier(a)
        n = in_shape[ax]
        F = axplan[ax]
        L = len(F)
        pre = ax in pre_set
        post = ax in post_set
        w1d = pre_weights.get(ax) if pre_weights else None
        if w1d is not None:
            assert not pre, "pre_weights with absorbed input shift"
            w1d = np.asarray(w1d, dtype=np.float64)

        if w1d is not None and L > 1:
            # separable input weight (window factor): an elementwise
            # broadcast multiply placed immediately before this axis's
            # first dot.  For axes after the first this fuses into the
            # previous dot's output fusion (zero memory passes); for the
            # first axis XLA can fuse it with the input layout copy.
            # (Folding it into the first-level dot via batching over the
            # remainder digit was measured WORSE: the batched
            # dot forces batch-major layout copies of the full operand.)
            # Direct (L == 1) plans fold the weight into the dot rows
            # below instead — exactly free.
            bshape = [1] * a.ndim
            for lvl2, r2 in enumerate(F):
                bshape[pos(_in(ax, lvl2))] = r2
            a = a * jnp.asarray(w1d.astype(rdtype).reshape(bshape))

        prev_dig = None  # digit token batching the next (final) dot
        pending_tw = None  # (r_prev, rem) twiddle deferred into final dot

        for lvl, r in enumerate(F):
            dot_i += 1
            final_axis_dot = lvl == L - 1
            final_overall = dot_i == total_dots
            p = pos(_in(ax, lvl))

            if not final_axis_dot:
                s = int(np.prod(F[lvl + 1:]))  # remaining block size
                jp = p
                # weight: DFT_r, pre-roll on the first level only
                pre_roll = (r // 2) if (pre and lvl == 0 and L > 1) else 0
                wc = _w_complex_np(r, sign, pre_roll=pre_roll)
                wl = _stack_lhs(wc, real_in=not has_c, rdt=rdtype)
                wj = jnp.asarray(wl)
                if has_c:
                    cp = pos(_C)
                    # W (co, k, ci, j) x a: contract (ci, j)
                    a = lax.dot_general(
                        wj, a, (((2, 3), (cp, jp)), ((), ())),
                        precision=prec)
                    rest = [d for q, d in enumerate(dims)
                            if q not in (cp, jp)]
                else:
                    # W (2, k, j) x a: contract (j)
                    a = lax.dot_general(
                        wj, a, (((2,), (jp,)), ((), ())),
                        precision=prec)
                    rest = [d for q, d in enumerate(dims) if q != jp]
                    has_c = True
                dims = [_C, _dig(ax, lvl)] + rest
                # twiddle between this level and the rest of the axis
                if lvl == L - 2:
                    pending_tw = _twiddle_np(r, s, sign)
                    prev_dig = _dig(ax, lvl)
                else:
                    # explicit twiddle pass (3+ level plans only)
                    tw = _twiddle_np(r, s, sign)
                    a = _twiddle_mul(a, tw, dims, ax, lvl, rdtype, F)
            else:
                # final level of this axis: contract the last digit,
                # twiddle folded via batching over the previous digit
                # when L >= 2
                kcols = None
                if ax == prune_axis:
                    kcols = r // 2 + 1
                post_perm = None
                post_roll = 0
                if post:
                    if L == 1:
                        post_perm = post_kind
                    else:
                        post_roll = (r // 2) if post_kind == "fftshift" \
                            else -(r // 2)
                pre_perm = pre and L == 1
                wsc = scale if final_overall else 1.0
                wc = _w_complex_np(r, sign, post_roll=post_roll,
                                   kcols=kcols, pre_perm=pre_perm,
                                   post_perm=post_perm, scale=wsc)
                if w1d is not None and L == 1:
                    wc = wc * w1d[:, None]  # direct plan: scale input rows
                K = wc.shape[1]
                if final_overall:
                    # W-RHS, merged (2K) trailing output dim
                    wm = jnp.asarray(_merged_rhs(
                        wc, rdtype, pending_tw, real_in=not has_c))
                    if pending_tw is not None:
                        bq = pos(prev_dig)
                        cp = pos(_C)
                        a = lax.dot_general(
                            a, wm, (((cp, p), (1, 2)), ((bq,), (0,))),
                            precision=prec)
                        rest = [d for q, d in enumerate(dims)
                                if q not in (bq, cp, p)]
                        dims = [prev_dig] + rest + [_ck(ax, lvl)]
                    elif has_c:
                        cp = pos(_C)
                        a = lax.dot_general(
                            a, wm, (((cp, p), (0, 1)), ((), ())),
                            precision=prec)
                        rest = [d for q, d in enumerate(dims)
                                if q not in (cp, p)]
                        dims = rest + [_ck(ax, lvl)]
                    else:
                        a = lax.dot_general(
                            a, wm, (((p,), (0,)), ((), ())), precision=prec)
                        rest = [d for q, d in enumerate(dims) if q != p]
                        dims = rest + [_ck(ax, lvl)]
                        has_c = True
                    merged_K = K
                else:
                    # W-LHS (batched when twiddle folded)
                    if pending_tw is not None:
                        wj = jnp.asarray(_batched_lhs(
                            pending_tw, wc, rdtype))  # (kb, co, K, ci, m)
                        bq = pos(prev_dig)
                        cp = pos(_C)
                        a = lax.dot_general(
                            wj, a, (((3, 4), (cp, p)), ((0,), (bq,))),
                            precision=prec)
                        rest = [d for q, d in enumerate(dims)
                                if q not in (bq, cp, p)]
                        dims = [prev_dig, _C, _dig(ax, lvl)] + rest
                    else:
                        wl = _stack_lhs(wc, real_in=not has_c, rdt=rdtype)
                        wj = jnp.asarray(wl)
                        if has_c:
                            cp = pos(_C)
                            a = lax.dot_general(
                                wj, a, (((2, 3), (cp, p)), ((), ())),
                                precision=prec)
                            rest = [d for q, d in enumerate(dims)
                                    if q not in (cp, p)]
                        else:
                            a = lax.dot_general(
                                wj, a, (((2,), (p,)), ((), ())),
                                precision=prec)
                            rest = [d for q, d in enumerate(dims) if q != p]
                            has_c = True
                        dims = [_C, _dig(ax, lvl)] + rest
                pending_tw = None
                prev_dig = None

    if raw:
        plans = {ax2: axplan[ax2] for ax2 in order}
        return a, RawStacked(tuple(dims), tuple(in_shape), tuple(order),
                             plans, prune_axis, merged_K)

    # ------------------------------------------------------------ epilogue
    # ONE lax.reshape(dimensions=...) performs the whole restore: it
    # transposes digit slots to (major..minor) order per axis with the
    # merged (c-major 2K) slot leading the last-transformed axis's group,
    # then the row-major refill simultaneously splits the c plane out and
    # flattens every digit group.  Splitting (.., 2K) -> (.., 2, K) as a
    # materialized intermediate would pad the 2-sized dim 4x under an
    # (8,128) tiling (~4 GB extra on the flagship PSD); this formulation
    # is a single unpadded copy.  The c plane lands immediately before the
    # last-transformed axis; ComplexPair slices it back out (fused views).
    last_ax = order[-1]
    Flast = axplan[last_ax]
    ck_pos = dims.index(_ck(last_ax, len(Flast) - 1))

    perm: list[int] = []
    new_sizes: list[int] = []
    c_axis = None
    out_pos: dict[int, int] = {}
    for i in range(ndim):
        if i in order:
            F = axplan[i]
            if i == last_ax:
                c_axis = len(new_sizes)
                new_sizes.append(2)
                digs = [ck_pos] + [dims.index(_dig(i, lvl))
                                   for lvl in reversed(range(len(F) - 1))]
            else:
                digs = [dims.index(_dig(i, lvl))
                        for lvl in reversed(range(len(F)))]
            perm.extend(digs)
            size = int(np.prod([a.shape[q] for q in digs]))
            if i == last_ax:
                size //= 2
            out_pos[i] = len(new_sizes)
            new_sizes.append(size)
        else:
            p = dims.index(_orig(i))
            perm.append(p)
            out_pos[i] = len(new_sizes)
            new_sizes.append(a.shape[p])
    a = lax.reshape(a, tuple(new_sizes), dimensions=tuple(perm))

    if prune_axis is not None:
        n = in_shape[prune_axis]
        idx = [slice(None)] * a.ndim
        idx[out_pos[prune_axis]] = slice(0, n // 2 + 1)
        a = a[tuple(idx)]

    return ComplexPair(
        lax.index_in_dim(a, 0, c_axis, keepdims=False),
        lax.index_in_dim(a, 1, c_axis, keepdims=False),
    )


def _twiddle_mul(a, tw: np.ndarray, dims: list, ax, lvl, rdtype, F):
    """Explicit twiddle pass for 3+-level plans: a has a c plane axis, the
    just-emitted digit (prepended by the dot, so ahead of the remaining
    input-digit dims), and the remaining digits of `ax` somewhere after;
    tw is (k_lvl, m_rem) with m_rem the row-major flatten of the remaining
    digits."""
    cp = dims.index(_C)

    def adj(q):
        return q - (1 if cp < q else 0)

    kp = adj(dims.index(_dig(ax, lvl)))
    bshape = [1] * (a.ndim - 1)
    bshape[kp] = tw.shape[0]
    for l2 in range(lvl + 1, len(F)):
        bshape[adj(dims.index(_in(ax, l2)))] = F[l2]
    # the emitted digit is prepended by the dot, so it precedes every
    # remaining input digit and the (k, m-digits...) axis order of the
    # reshaped constant matches the slot order
    t = tw.reshape((tw.shape[0],) + tuple(F[lvl + 1:]))
    twr = jnp.asarray(t.real.astype(rdtype).reshape(bshape))
    twi = jnp.asarray(t.imag.astype(rdtype).reshape(bshape))
    re = lax.index_in_dim(a, 0, cp, keepdims=False)
    im = lax.index_in_dim(a, 1, cp, keepdims=False)
    return jnp.stack([re * twr - im * twi, re * twi + im * twr], axis=cp)
