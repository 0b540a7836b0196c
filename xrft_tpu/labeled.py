"""LabeledArray: the working data type of xrft_tpu.

Design (SURVEY.md §7, decision 1): *coordinate math is host/static; bulk data
is device/traced*.  A ``LabeledArray`` couples

  - ``data``   : a ``jax.Array`` (or numpy array) — the only thing that ever
                 flows through XLA,
  - ``dims``   : a tuple of dimension names (static),
  - ``coords`` : host-side numpy coordinate arrays keyed by name (static),
  - ``attrs``  : a host-side metadata dict (static),

mirroring the subset of the ``xarray.DataArray`` surface the reference
library relies on (reference behaviour: coordinates are *always* eager numpy,
``/root/reference/xrft/xrft.py:140-141``).  Everything decided by coordinates
(spacing, lag, frequency grids, shift/flip decisions, bin indices…) is
computed in trace-time Python and baked into the jaxpr as constants, so whole
spectral pipelines compile to a single fused XLA program.

The class is registered as a JAX pytree, so ``jax.jit`` / ``jax.vmap`` /
sharding utilities apply directly; dims/coords/attrs ride along as static
(hashable) aux data.
"""

from __future__ import annotations

import operator
from typing import Any, Mapping, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .ops import carray
from .ops.carray import ComplexPair

__all__ = ["Coord", "LabeledArray"]


def _values_eq(a: Any, b: Any) -> bool:
    """Robust equality for attr/coord values that may be numpy arrays."""
    if a is b:
        return True
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        try:
            return np.array_equal(np.asarray(a), np.asarray(b))
        except (TypeError, ValueError):
            return False
    try:
        return bool(a == b)
    except (TypeError, ValueError):
        return False


def _dicts_eq(a: Mapping, b: Mapping) -> bool:
    if a.keys() != b.keys():
        return False
    return all(_values_eq(a[k], b[k]) for k in a)


class Coord:
    """A host-side coordinate: a numpy array with named dims and attrs.

    Coordinates are pure metadata — they never enter jit-compiled programs
    except as baked constants.  Analogue of an xarray coordinate variable.
    """

    __slots__ = ("dims", "values", "attrs", "name")

    def __init__(self, dims, values, attrs=None, name=None):
        if isinstance(dims, str):
            dims = (dims,)
        self.dims = tuple(dims)
        self.values = np.asarray(values)
        if self.values.ndim != len(self.dims):
            raise ValueError(
                f"coordinate has {self.values.ndim} axes but dims {self.dims}"
            )
        self.attrs = dict(attrs) if attrs else {}
        self.name = name

    # -- convenience accessors used across the library ---------------------
    @property
    def size(self) -> int:
        return self.values.size

    @property
    def shape(self):
        return self.values.shape

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def data(self) -> np.ndarray:
        return self.values

    def __len__(self) -> int:
        return len(self.values)

    def __getitem__(self, idx):
        return self.values[idx]

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.values, dtype=dtype)

    def __repr__(self):
        return f"Coord({self.name or ''}{self.dims}, {self.values!r})"

    def __getattr__(self, key):
        # xarray-style attribute access to attrs (e.g. ``coord.spacing``)
        try:
            return self.attrs[key]
        except KeyError:
            raise AttributeError(key) from None

    def max(self):
        return self.values.max()

    def min(self):
        return self.values.min()

    def copy(self, values=None, attrs=None) -> "Coord":
        return Coord(
            self.dims,
            self.values if values is None else values,
            dict(self.attrs) if attrs is None else attrs,
            self.name,
        )

    def _eq(self, other: "Coord") -> bool:
        return (
            self.dims == other.dims
            and np.array_equal(self.values, other.values)
            and _dicts_eq(self.attrs, other.attrs)
        )


def _as_coord(name: str, value: Any, dims: Sequence[str]) -> Coord:
    """Normalize a user-provided coords dict entry into a Coord."""
    if isinstance(value, Coord):
        c = value.copy()
        c.name = name
        return c
    if isinstance(value, tuple) and len(value) in (2, 3) and not np.isscalar(value[0]):
        # (dims, values[, attrs]) xarray-style tuple
        cdims, cvals = value[0], value[1]
        cattrs = value[2] if len(value) == 3 else None
        return Coord(cdims, cvals, cattrs, name)
    arr = np.asarray(value)
    if name in dims:
        if arr.ndim != 1:
            raise ValueError(f"dimension coordinate {name!r} must be 1-D")
        return Coord((name,), arr, None, name)
    if arr.ndim == 0:
        return Coord((), arr, None, name)
    raise ValueError(
        f"cannot infer dims for coordinate {name!r}; pass a Coord or a "
        f"(dims, values) tuple"
    )


def _sample_token(arr: np.ndarray) -> bytes:
    """Cheap content token for host-array caches: the bytes of ~64
    elements sampled on a fixed stride.  Detects most in-place mutations
    of a cached buffer without a full-array pass (see the _quad_cache
    note in ``LabeledArray.tree_flatten``)."""
    step = max(1, arr.size // 64)
    if arr.flags.c_contiguous:
        flat = arr.reshape(-1)  # view, no copy
        return flat[::step][:64].tobytes()
    # non-contiguous (e.g. a host-numpy transpose view): flatiter slicing
    # extracts just the ~64 sampled elements instead of materializing a
    # full reshape(-1) copy on every jit dispatch
    return arr.flat[::step][:64].tobytes()


class _Aux:
    """Hashable static payload for the pytree registration."""

    __slots__ = ("dims", "coords", "attrs", "name", "_hash")

    def __init__(self, dims, coords, attrs, name):
        self.dims = dims
        self.coords = coords
        self.attrs = attrs
        self.name = name
        self._hash = hash(
            (dims, tuple(sorted(coords)), name)
            + tuple((k, c.dims, c.shape) for k, c in sorted(coords.items()))
        )

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        if not isinstance(other, _Aux):
            return NotImplemented
        if self.dims != other.dims or self.name != other.name:
            return False
        if self.coords.keys() != other.coords.keys():
            return False
        if not all(self.coords[k]._eq(other.coords[k]) for k in self.coords):
            return False
        return _dicts_eq(self.attrs, other.attrs)


@jax.tree_util.register_pytree_node_class
class LabeledArray:
    """An N-D array with named dimensions, host-side coords, and attrs.

    Provides the (small) subset of the xarray.DataArray API that the
    spectral-analysis layer requires, with xarray-compatible semantics:
    dim-name-based broadcasting for arithmetic, coordinate propagation, and
    metadata preservation.
    """

    __slots__ = ("data", "dims", "coords", "attrs", "name", "_quad_cache")

    def __init__(self, data, dims=None, coords=None, attrs=None, name=None):
        if isinstance(data, LabeledArray):
            dims = data.dims if dims is None else dims
            coords = data.coords if coords is None else coords
            attrs = data.attrs if attrs is None else attrs
            name = data.name if name is None else name
            data = data.data
        if not isinstance(data, (jax.Array, np.ndarray, ComplexPair,
                                 carray.DF64, carray.CDF64)):
            data = np.asarray(data)
        if isinstance(data, np.ndarray) and data.dtype == np.complex128:
            # complex128 stays host-resident: converting would silently drop
            # precision (split pairs and non-x64 jnp are float32-grade), and
            # the high-precision (df64) results depend on keeping it
            pass
        elif isinstance(data, np.ndarray) and data.dtype.kind == "c":
            # complex64 numpy input: split on host in split mode
            # (config.complex_mode); else device-put as native
            from .ops.fft_core import use_split_complex

            data = carray.as_pair(data) if use_split_complex() else jnp.asarray(data)
        elif isinstance(data, np.ndarray) and data.dtype.kind in "fiub":
            # numeric numpy -> device array once at construction; otherwise
            # every jit invocation re-transfers the buffer host->device
            data = jnp.asarray(data)
        if dims is None:
            dims = tuple(f"dim_{i}" for i in range(data.ndim))
        elif isinstance(dims, str):
            dims = (dims,)
        else:
            dims = tuple(dims)
        if len(dims) != data.ndim:
            raise ValueError(f"{len(dims)} dims for {data.ndim}-d data")
        self.data = data
        self.dims = dims
        coords_out: dict[str, Coord] = {}
        if coords:
            for cname, cval in coords.items():
                c = _as_coord(cname, cval, dims)
                coords_out[cname] = c
        self.coords = coords_out
        self.attrs = dict(attrs) if attrs else {}
        self.name = name
        self._validate()

    def _validate(self):
        sizes = self.sizes
        for cname, c in self.coords.items():
            for d, n in zip(c.dims, c.shape):
                if d not in sizes:
                    raise ValueError(
                        f"coordinate {cname!r} has unknown dim {d!r}"
                    )
                if sizes[d] != n:
                    raise ValueError(
                        f"coordinate {cname!r} size {n} along {d!r} != {sizes[d]}"
                    )

    # ------------------------------------------------------------------ core
    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def ndim(self):
        return self.data.ndim

    @property
    def size(self):
        return self.data.size

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def sizes(self) -> dict[str, int]:
        return dict(zip(self.dims, self.data.shape))

    @property
    def values(self) -> np.ndarray:
        return carray.to_numpy(self.data)

    def __array__(self, dtype=None, copy=None):
        out = carray.to_numpy(self.data)
        return out.astype(dtype) if dtype is not None else out

    def __len__(self):
        return self.shape[0]

    def item(self):
        return carray.to_numpy(self.data).item()

    def get_axis_num(self, dim):
        if isinstance(dim, (list, tuple)):
            return [self.dims.index(d) for d in dim]
        return self.dims.index(dim)

    def __getitem__(self, key):
        if isinstance(key, str):
            try:
                return self.coords[key]
            except KeyError:
                raise KeyError(f"no coordinate {key!r}") from None
        raise TypeError(
            "positional indexing is not supported; use .isel(dim=indexer)"
        )

    def __repr__(self):
        coord_names = ", ".join(self.coords)
        return (
            f"<LabeledArray {self.name or ''}{dict(zip(self.dims, self.shape))} "
            f"dtype={self.data.dtype} coords=[{coord_names}]>"
        )

    def copy(self, data=None, deep=False) -> "LabeledArray":
        out = LabeledArray.__new__(LabeledArray)
        out.data = self.data if data is None else data
        if data is not None and getattr(out.data, "ndim", None) != len(self.dims):
            raise ValueError("replacement data has wrong rank")
        out.dims = self.dims
        out.coords = {k: c.copy() for k, c in self.coords.items()}
        out.attrs = dict(self.attrs)
        out.name = self.name
        return out

    # ------------------------------------------------------- pytree protocol
    def tree_flatten(self):
        data = self.data
        if isinstance(data, np.ndarray) and data.dtype == np.complex128:
            # host-resident complex128 (kept unconverted at construction to
            # preserve f64 precision) never crosses a jit boundary as a
            # complex leaf in split mode.  Flatten it as an exact df64 quad instead (CDF64 is itself a
            # pytree, so jit sees four f32 leaves); engine='hp' consumes it
            # at full precision, the f32 engines degrade it to a pair in
            # fft_core._dispatch.
            from .ops.fft_core import use_split_complex

            if use_split_complex():
                # flatten runs on EVERY jit dispatch: cache the host df64
                # split per data object (4 full-array numpy passes saved
                # per call; invalidated when .data is replaced, or when a
                # cheap content token — 64 strided sample elements — shows
                # the array was mutated in place).  The token is a guard,
                # not a guarantee: an in-place write touching none of the
                # sampled elements still reuses the stale quad, so prefer
                # `.copy(data=...)` over mutating host complex128 buffers.
                cached = getattr(self, "_quad_cache", None)
                token = _sample_token(data)
                if (cached is not None and cached[0] is data
                        and cached[2] == token):
                    data = cached[1]
                else:
                    from .ops.df64 import split_f64_np

                    rh, rl = split_f64_np(np.ascontiguousarray(data.real))
                    ih, il = split_f64_np(np.ascontiguousarray(data.imag))
                    quad = carray.CDF64(jnp.asarray(rh), jnp.asarray(rl),
                                        jnp.asarray(ih), jnp.asarray(il))
                    self._quad_cache = (data, quad, token)
                    data = quad
        return (data,), _Aux(self.dims, self.coords, self.attrs, self.name)

    @classmethod
    def tree_unflatten(cls, aux: _Aux, children):
        out = cls.__new__(cls)
        out.data = children[0]
        out.dims = aux.dims
        out.coords = aux.coords
        out.attrs = aux.attrs
        out.name = aux.name
        return out

    # --------------------------------------------------------- manipulation
    def transpose(self, *dims) -> "LabeledArray":
        if not dims:
            dims = self.dims[::-1]
        if len(dims) == 1 and isinstance(dims[0], (list, tuple)):
            dims = tuple(dims[0])
        if set(dims) != set(self.dims) or len(dims) != len(self.dims):
            raise ValueError(f"transpose dims {dims} != array dims {self.dims}")
        perm = [self.dims.index(d) for d in dims]
        data = (np.transpose(self.data, perm)
                if isinstance(self.data, np.ndarray)
                else carray.transpose(self.data, perm))
        out = self.copy(data=data)
        out.dims = tuple(dims)
        return out

    def isel(self, indexers=None, **indexers_kwargs) -> "LabeledArray":
        indexers = dict(indexers or {})
        indexers.update(indexers_kwargs)
        key = []
        dropped = []
        for d in self.dims:
            ix = indexers.get(d, slice(None))
            if isinstance(ix, (int, np.integer)):
                dropped.append(d)
            key.append(ix)
        data = self.data[tuple(key)]
        new_dims = tuple(d for d in self.dims if d not in dropped)
        out = LabeledArray.__new__(LabeledArray)
        out.data = data
        out.dims = new_dims
        out.attrs = dict(self.attrs)
        out.name = self.name
        new_coords = {}
        for cname, c in self.coords.items():
            if any(d in dropped for d in c.dims):
                continue
            if any(d in indexers for d in c.dims):
                ckey = tuple(indexers.get(d, slice(None)) for d in c.dims)
                new_coords[cname] = Coord(c.dims, c.values[ckey], c.attrs, cname)
            else:
                new_coords[cname] = c.copy()
        out.coords = new_coords
        return out

    def sel(self, indexers=None, method=None, **indexers_kwargs
            ) -> "LabeledArray":
        """Select by coordinate value along 1-D dim coords (xarray-style).

        method=None requires exact matches; method='nearest' picks the
        closest coordinate value.
        """
        indexers = dict(indexers or {})
        indexers.update(indexers_kwargs)
        isel_map = {}
        for d, target in indexers.items():
            if d not in self.coords:
                raise KeyError(f"no coordinate for dim {d!r}")
            vals = self.coords[d].values
            scalar = np.ndim(target) == 0
            targets = np.atleast_1d(np.asarray(target))
            idx = []
            for tv in targets:
                if method == "nearest":
                    idx.append(int(np.argmin(np.abs(vals - tv))))
                else:
                    hits = np.nonzero(vals == tv)[0]
                    if hits.size == 0:
                        raise KeyError(
                            f"value {tv!r} not found in coordinate {d!r}"
                        )
                    idx.append(int(hits[0]))
            isel_map[d] = idx[0] if scalar else np.asarray(idx)
        return self.isel(isel_map)

    def sortby(self, dim) -> "LabeledArray":
        """Sort along one or more dims by their 1-D dim-coordinate values."""
        dims = [dim] if isinstance(dim, str) else list(dim)
        out = self
        for d in dims:
            if d not in out.coords:
                raise KeyError(f"no coordinate for dim {d!r}")
            order = np.argsort(out.coords[d].values, kind="stable")
            if np.array_equal(order, np.arange(order.size)):
                continue
            axis = out.get_axis_num(d)
            if isinstance(out.data, np.ndarray):
                data = np.take(out.data, order, axis=axis)
            else:
                n = order.size
                k = int(order[0])
                if np.array_equal(order, (np.arange(n) + k) % n):
                    # cyclic permutation (e.g. natural fftfreq order ->
                    # ascending): slice+concat HLOs instead of a gather
                    data = carray.roll(out.data, -k, axis)
                elif np.array_equal(order, np.arange(n - 1, -1, -1)):
                    data = carray.flip(out.data, [axis])
                else:
                    data = carray.take(out.data, jnp.asarray(order),
                                       axis=axis)
            nxt = out.copy(data=data)
            for cname, c in nxt.coords.items():
                if d in c.dims:
                    cax = c.dims.index(d)
                    nxt.coords[cname] = Coord(
                        c.dims, np.take(c.values, order, axis=cax), c.attrs, cname
                    )
            out = nxt
        return out

    def assign_coords(self, coords=None, **kwargs) -> "LabeledArray":
        coords = dict(coords or {})
        coords.update(kwargs)
        out = self.copy()
        for cname, cval in coords.items():
            out.coords[cname] = _as_coord(cname, cval, out.dims)
        out._validate()
        return out

    def drop_vars(self, names) -> "LabeledArray":
        if isinstance(names, str):
            names = [names]
        out = self.copy()
        for n in names:
            out.coords.pop(n, None)
        return out

    def rename(self, name) -> "LabeledArray":
        out = self.copy()
        out.name = name
        return out

    def assign_attrs(self, **attrs) -> "LabeledArray":
        out = self.copy()
        out.attrs.update(attrs)
        return out

    def chunk(self, chunks: Mapping[str, int] | None = None, **chunks_kwargs
              ) -> "LabeledArray":
        """Declare logical chunk lengths per dim (metadata only).

        The analogue of dask chunking: chunk lengths feed
        ``fft(..., chunks_to_segments=True)`` (Welch segmenting) and batch
        sharding helpers; the data itself is not reorganized.
        """
        merged = dict(self.attrs.get("_chunks") or {})
        merged.update(chunks or {})
        merged.update(chunks_kwargs)
        for d in merged:
            if d not in self.dims:
                raise ValueError(f"chunk dim {d!r} not in {self.dims}")
        return self.assign_attrs(_chunks=merged)

    @property
    def chunks(self):
        return self.attrs.get("_chunks")

    # ----------------------------------------------------------- reductions
    def _reduce(self, fn_jnp, dim=None, **kw) -> "LabeledArray":
        if dim is None:
            dims = list(self.dims)
        elif isinstance(dim, str):
            dims = [dim]
        else:
            dims = list(dim)
        axes = tuple(self.dims.index(d) for d in dims)
        data = carray.reduce(_asjax(self.data), fn_jnp, axes, **kw)
        out = LabeledArray.__new__(LabeledArray)
        out.data = data
        out.dims = tuple(d for d in self.dims if d not in dims)
        out.attrs = dict(self.attrs)
        out.name = self.name
        out.coords = {
            k: c.copy()
            for k, c in self.coords.items()
            if not any(d in dims for d in c.dims)
        }
        return out

    def mean(self, dim=None):
        return self._reduce(jnp.mean, dim)

    def sum(self, dim=None):
        return self._reduce(jnp.sum, dim)

    def max(self, dim=None):
        return self._reduce(jnp.max, dim)

    def min(self, dim=None):
        return self._reduce(jnp.min, dim)

    def std(self, dim=None):
        return self._reduce(jnp.std, dim)

    def var(self, dim=None):
        return self._reduce(jnp.var, dim)

    def median(self, dim=None):
        """Median reduction (e.g. robust Welch averaging over segment
        dims, scipy.signal.welch's average='median' minus its chi2 bias
        factor)."""
        return self._reduce(jnp.median, dim)

    # ---------------------------------------------------------- elementwise
    def _unary(self, fn) -> "LabeledArray":
        return self.copy(data=fn(_asjax(self.data)))

    def conj(self):
        return self._unary(carray.conj)

    @property
    def real(self):
        return self._unary(carray.real)

    @property
    def imag(self):
        return self._unary(carray.imag)

    def astype(self, dtype):
        return self._unary(lambda x: x.astype(dtype))

    def __abs__(self):
        return self._unary(carray.absolute)

    def __neg__(self):
        return self._unary(lambda x: -x if carray.is_pair(x) else jnp.negative(x))

    def fillna(self, value):
        return self._unary(lambda x: carray.nan_to_num(x, nan=value))

    # -------------------------------------------- dim-aligned binary ops
    def _binary(self, other, op, reflexive=False) -> "LabeledArray":
        if isinstance(other, Coord):
            other = LabeledArray(other.values, dims=other.dims,
                                 coords={other.name or other.dims[0]: other}
                                 if other.ndim == 1 else None)
        if isinstance(other, LabeledArray):
            out_dims = list(self.dims) + [
                d for d in other.dims if d not in self.dims
            ]
            for d in self.dims:
                if d in other.dims and self.sizes[d] != other.sizes[d]:
                    raise ValueError(
                        f"conflicting sizes for dim {d!r}: "
                        f"{self.sizes[d]} vs {other.sizes[d]}"
                    )
            a = _expand_to(self, out_dims)
            b = _expand_to(other, out_dims)
            if carray.is_pair(a) != carray.is_pair(b):
                # never mix representations: promote both to pairs
                a, b = carray.as_pair(a), carray.as_pair(b)
            data = op(b, a) if reflexive else op(a, b)
            out = LabeledArray.__new__(LabeledArray)
            out.data = data
            out.dims = tuple(out_dims)
            # user attrs drop (xarray keep_attrs=False parity) but declared
            # chunk lengths are structural, like dask chunks surviving
            # arithmetic (reference ifft multiplies the phase factor *before*
            # _stack_chunks, /root/reference/xrft/xrft.py:574-579)
            chunks = dict(other.attrs.get("_chunks") or {})
            chunks.update(self.attrs.get("_chunks") or {})
            chunks = {d: c for d, c in chunks.items() if d in out_dims}
            out.attrs = {"_chunks": chunks} if chunks else {}
            out.name = None
            coords = {k: c.copy() for k, c in self.coords.items()}
            for k, c in other.coords.items():
                coords.setdefault(k, c.copy())
            out.coords = coords
            return out
        # scalar / raw array (same-shape broadcast against our data)
        a = _asjax(self.data)
        b = other if np.isscalar(other) or isinstance(other, complex) else jnp.asarray(other)
        if isinstance(b, complex) or (
            getattr(b, "dtype", None) is not None
            and np.dtype(b.dtype).kind == "c"
            and carray.is_pair(a)
        ):
            b = carray.as_pair(b) if carray.is_pair(a) else b
        data = op(b, a) if reflexive else op(a, b)
        out = self.copy(data=data)
        chunks = self.attrs.get("_chunks")
        out.attrs = {"_chunks": dict(chunks)} if chunks else {}
        return out

    def __add__(self, o):
        return self._binary(o, operator.add)

    def __radd__(self, o):
        return self._binary(o, operator.add, reflexive=True)

    def __sub__(self, o):
        return self._binary(o, operator.sub)

    def __rsub__(self, o):
        return self._binary(o, operator.sub, reflexive=True)

    def __mul__(self, o):
        return self._binary(o, operator.mul)

    def __rmul__(self, o):
        return self._binary(o, operator.mul, reflexive=True)

    def __truediv__(self, o):
        return self._binary(o, operator.truediv)

    def __rtruediv__(self, o):
        return self._binary(o, operator.truediv, reflexive=True)

    def __pow__(self, o):
        return self._binary(o, operator.pow)

    def __lt__(self, o):
        return self._binary(o, operator.lt)

    def __le__(self, o):
        return self._binary(o, operator.le)

    def __gt__(self, o):
        return self._binary(o, operator.gt)

    def __ge__(self, o):
        return self._binary(o, operator.ge)

    # ------------------------------------------------------------- masking
    def where(self, cond, other=np.nan) -> "LabeledArray":
        """Keep values where cond is True, else fill with `other` (NaN)."""
        if isinstance(cond, LabeledArray):
            out_dims = list(self.dims) + [d for d in cond.dims if d not in self.dims]
            a = _expand_to(self, out_dims)
            c = _expand_to(cond, out_dims)
            out = LabeledArray.__new__(LabeledArray)
            out.data = carray.where(c, a, other)
            out.dims = tuple(out_dims)
            out.attrs = dict(self.attrs)
            out.name = self.name
            coords = {k: v.copy() for k, v in self.coords.items()}
            for k, v in cond.coords.items():
                coords.setdefault(k, v.copy())
            out.coords = coords
            return out
        return self.copy(
            data=carray.where(jnp.asarray(cond), _asjax(self.data), other)
        )

    def dropna(self, dim) -> "LabeledArray":
        """Drop labels along ``dim`` where data (any over other dims) or the
        dim-coordinate is NaN.

        Note: xarray's dropna only inspects data values; we additionally drop
        positions whose dimension-coordinate label is NaN, which implements
        the *intent* of ``isotropize(..., truncate=True)`` (reference
        ``/root/reference/xrft/xrft.py:1007-1010``).
        """
        axis = self.get_axis_num(dim)
        vals = carray.to_numpy(self.data)
        mask = np.zeros(vals.shape[axis], dtype=bool)
        if np.issubdtype(vals.dtype, np.floating) or np.issubdtype(
            vals.dtype, np.complexfloating
        ):
            other_axes = tuple(i for i in range(vals.ndim) if i != axis)
            mask |= np.isnan(vals).any(axis=other_axes)
        if dim in self.coords:
            cvals = self.coords[dim].values
            if np.issubdtype(cvals.dtype, np.floating):
                mask |= np.isnan(cvals)
        keep = np.nonzero(~mask)[0]
        if keep.size == vals.shape[axis]:
            return self.copy()
        return self.isel({dim: keep})


def _asjax(data):
    """Normalize stored data for compute: numpy -> jnp (complex numpy is
    split when the backend lacks complex support); pairs/jax pass through."""
    if isinstance(data, np.ndarray):
        if data.dtype.kind == "c":
            from .ops.fft_core import use_split_complex

            return carray.as_pair(data) if use_split_complex() else jnp.asarray(data)
        return jnp.asarray(data)
    return data


def _expand_to(da: LabeledArray, out_dims: Sequence[str]):
    """Return da.data transposed/newaxis-expanded to out_dims order."""
    own = [d for d in out_dims if d in da.dims]
    perm = [da.dims.index(d) for d in own]
    data = _asjax(da.data)
    if perm != list(range(len(perm))):
        data = carray.transpose(data, perm)
    shape = [da.sizes[d] if d in da.dims else 1 for d in out_dims]
    return carray.reshape(data, tuple(shape))
