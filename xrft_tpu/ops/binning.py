"""Binned aggregation over static frequency grids.

The reference performs azimuthal binning with a host ``pd.cut`` plus a
``numpy_groupies`` scatter-add per block
(xrft's ``xrft/xrft.py:877-945``).  Here the bin *indices* depend
only on the static frequency grid, so they are computed once on the host
(:func:`cut_codes`, ``pd.cut``'s equal-width right-closed semantics in
numpy) and baked into the program; only the per-bin sums run on the
device (:func:`binned_sum`, a grouped scatter-add).  Out-of-range points
(code -1) drop out of the sum.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec

from . import carray

__all__ = ["cut_codes", "binned_sum", "binned_mean_np"]


def cut_codes(values: np.ndarray, nbins: int):
    """``pd.cut(values, nbins)`` codes for a flattened host array.

    Equal-width right-closed bins over [min, max] of the non-NaN values,
    with the lowest edge moved down by 0.1% of the range so the minimum
    falls in bin 0 (all-equal values instead widen the range by 0.1% of
    their magnitude, or by 0.001 at zero).  Returns (codes, n_bins) with
    codes == -1 for NaN.
    """
    x = np.ravel(np.asarray(values))
    if x.dtype.kind != "f":
        x = x.astype(np.float64)
    nan = np.isnan(x)
    mn, mx = x[~nan].min(), x[~nan].max()
    if mn == mx:
        mn = mn - (0.001 * abs(mn) if mn != 0 else 0.001)
        mx = mx + (0.001 * abs(mx) if mx != 0 else 0.001)
        edges = np.linspace(mn, mx, nbins + 1)
    else:
        edges = np.linspace(mn, mx, nbins + 1)
        edges[0] -= (mx - mn) * 0.001
    ids = np.searchsorted(edges, x, side="left")
    codes = ids - 1
    codes[nan | (ids == 0) | (ids == edges.size)] = -1
    return codes, nbins


def binned_mean_np(values: np.ndarray, codes: np.ndarray, nbins: int) -> np.ndarray:
    """Host-side per-bin mean (used for static quantities like the radial
    coordinate); empty bins give 0 (reference fill_value=0)."""
    flat = np.ravel(values)
    mask = codes >= 0
    sums = np.bincount(codes[mask], weights=flat[mask], minlength=nbins)
    counts = np.bincount(codes[mask], minlength=nbins)
    out = np.zeros(nbins, dtype=np.float64)
    nz = counts > 0
    out[nz] = sums[nz] / counts[nz]
    return out


# points per scatter-add group (see binned_sum)
GROUP = 8192


def binned_sum(data, codes: np.ndarray, nbins: int):
    """Per-bin sum over the trailing (flattened-core) axis of `data`;
    supports real arrays, native complex, and ComplexPairs.
    data shape (..., n_points) -> (..., nbins).

    One grouped scatter-add: the points are cut into groups of ``GROUP``,
    each group adds into its own copy of the bins (plus one bin that
    collects the dropped, code -1, points), and the copies are summed.
    Grouping spreads the scatter's atomic adds over ``nbins + 1`` times
    more addresses and keeps each partial sum short.

    Chosen on an NVIDIA H100 80GB HBM3 (700 W power limit).  Times:
    isotropic_power_spectrum end to end, median ms of 20 calls.  Errors:
    the binned sum of 4 rows of |randn| against a float64 bincount
    oracle, max|err| / max|ref|.

    ==========================  ================  ====================
    route                       512^2, 128 bins   2048^2, 512 bins
    ==========================  ================  ====================
    grouped scatter-add (8192)  0.163, 1.6e-7     0.368, 9.2e-8
    grouped scatter-add (1024)  0.278, 8.4e-8     0.346, 1.1e-7
    plain scatter-add           0.285, 1.9e-6     0.828, 4.4e-6
    sorted gather + prefix      0.330, 8.0e-6     0.305, 4.0e-5
    one-hot matmul (HIGHEST)    0.299, 5.0e-7     (8.6 GB one-hot)
    ==========================  ================  ====================

    The sorted prefix-difference route loses digits to cancellation
    (4e-5 fails the 1e-5 isotropic tolerance) and the one-hot constant
    grows with points x bins, so both were removed.  A scatter-add's
    order of accumulation varies from run to run; the grouped sums stay
    ~1e-7 relative, well inside 1e-5.
    """
    P = codes.size
    gs = max(1, min(GROUP, P))
    pad = (-P) % gs
    c = np.pad(np.where(codes < 0, nbins, codes), (0, pad),
               constant_values=nbins)
    groups = c.size // gs
    ids = jnp.asarray(
        (c + (np.arange(c.size) // gs) * (nbins + 1)).astype(np.int32))

    def mm(x):
        if pad:
            x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
        out = jnp.zeros(x.shape[:-1] + (groups * (nbins + 1),), x.dtype)
        # the output keeps x's batch-dim sharding and replicates the bins
        # (sharding-typed meshes require it stated)
        sh = jax.typeof(x).sharding
        spec = list(sh.spec) + [None] * (x.ndim - len(sh.spec))
        out = out.at[..., ids].add(
            x, out_sharding=sh.update(spec=PartitionSpec(*spec[:-1], None)))
        out = out.reshape(x.shape[:-1] + (groups, nbins + 1))
        return out.sum(axis=-2)[..., :nbins]

    if carray.is_pair(data):
        return carray.ComplexPair(mm(data.re), mm(data.im))
    if np.dtype(data.dtype).kind == "c":
        return jax.lax.complex(mm(jnp.real(data)), mm(jnp.imag(data)))
    return mm(data)
