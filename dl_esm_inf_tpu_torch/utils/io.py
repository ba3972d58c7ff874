"""Field output: dumps, NetCDF-3 files and history time series.

Counterpart of ``dl_esm_inf_tpu/utils/io.py``, numpy only.  The
analogue of the reference's test-only gnuplot ``dump_field``
(tests/dist_mem/test_halos.f90:267-338) writes a field (with physical
coordinates) for inspection, plus a compact .npz form; a self-contained
NetCDF-3 classic writer and reader carry fields and history files in the
NEMO/GOcean ecosystem's interchange format.  Fields are gathered to the
host (:meth:`~..core.field.Field.gather_inner_data`) before anything is
written, so the files are the same whatever device a field lives on,
and the JAX package's reader reads them.
"""
from __future__ import annotations

import numpy as np

from ..core import layout
from ..core.field import Field


def dump_field(field: Field, path: str, halo_depth: int = 0,
               fmt: str = "npz") -> None:
    """Write one field's global internal data (optionally with the
    per-rank local block views, halo ring included, for halo debugging).

    fmt='npz'  -> arrays x, y, data (global, internal points); with
                  ``halo_depth > 0`` also ``local_views`` of shape
                  (nranks, local_ny, local_nx) — each rank's raw block
                  including its halo/padding cells
    fmt='dat'  -> gnuplot-style "x y value" triples, blank-line-separated
                  rows (the reference's dump format; internal points only)
    """
    g = field.gather_inner_data()
    d = field.grid.decomp
    # global T coordinates of internal points (reference xt/yt formula)
    x = (np.arange(d.global_nx) + 1) * field.grid.dx
    y = (np.arange(d.global_ny) + 1) * field.grid.dy
    if fmt == "npz":
        extra = {}
        if halo_depth > 0:
            # ONE host gather, sliced per rank (field.local_view would
            # re-gather the whole stacked array for every rank)
            stacked = field.get_data()
            extra["local_views"] = np.stack(
                [np.asarray(layout.shard_view(d, stacked, r))
                 for r in range(d.ndomains)])
        np.savez_compressed(path, x=x, y=y, data=g, **extra)
    elif fmt == "dat":
        levels = g.reshape((1,) + g.shape) if g.ndim == 2 else g
        with open(path, "w") as f:
            for k in range(levels.shape[0]):
                if levels.shape[0] > 1:
                    f.write(f"# level {k}\n")
                gk = levels[k]
                for j in range(gk.shape[0]):
                    for i in range(gk.shape[1]):
                        f.write(f"{x[i]:.6e} {y[j]:.6e} {gk[j, i]:.6e}\n")
                    f.write("\n")
    else:
        raise ValueError(f"unknown dump format {fmt!r}")


def load_dump(path: str) -> dict:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


# ----------------------------------------------------------------------
# NetCDF-3 classic writer (CDF-1) — the interchange format of the
# NEMO/GOcean ecosystem the reference serves.  Self-contained encoder
# (the format is ~a page of spec: magic, dim/attr/var header lists,
# big-endian fixed-size data); scipy.io.netcdf_file / netCDF4 /
# ncdump all read the output (pinned by tests/test_torch_utils.py
# against scipy's independent reader and the JAX package's).
# ----------------------------------------------------------------------
_NC_TYPES = {np.dtype("int8"): (1, 1), np.dtype("S1"): (2, 1),
             np.dtype("int16"): (3, 2), np.dtype("int32"): (4, 4),
             np.dtype("float32"): (5, 4), np.dtype("float64"): (6, 8)}


def _nc_pad(b: bytes) -> bytes:
    return b + b"\x00" * (-len(b) % 4)


def _nc_narrow(g: np.ndarray, name: str) -> np.ndarray:
    """Cast an array with no NetCDF-3 type (int64/uint masks) to the
    nearest classic type, refusing silent integer corruption: values
    outside int32 range would wrap."""
    if np.dtype(g.dtype).kind in "iu":
        if g.size and (g.min() < -2**31 or g.max() > 2**31 - 1):
            raise ValueError(
                f"variable {name!r} ({g.dtype}) has values outside the "
                "int32 range; NetCDF-3 classic has no 64-bit integer "
                "type — convert to float64 first")
        return np.asarray(g, np.int32)
    return np.asarray(g, np.float32)


def _nc_name(s: str) -> bytes:
    import struct
    b = s.encode()
    return struct.pack(">I", len(b)) + _nc_pad(b)


def _nc_attrs(attrs: dict) -> bytes:
    import struct
    if not attrs:
        return struct.pack(">II", 0, 0)
    out = [struct.pack(">II", 0x0C, len(attrs))]
    for name, val in attrs.items():
        out.append(_nc_name(name))
        if isinstance(val, str):
            b = val.encode()
            out.append(struct.pack(">II", 2, len(b)) + _nc_pad(b))
        else:
            arr = np.atleast_1d(np.asarray(val))
            if arr.dtype.kind == "f":
                arr = arr.astype(">f8")
                tc = 6
            else:
                arr = arr.astype(">i4")
                tc = 4
            out.append(struct.pack(">II", tc, arr.size)
                       + _nc_pad(arr.tobytes()))
    return b"".join(out)


def dump_netcdf(fields, path: str, *, names=None,
                global_attrs: dict | None = None) -> None:
    """Write one or more fields as a NetCDF-3 classic file.

    ``fields``: a :class:`Field`, a ``{name: Field}`` dict, or a list
    (named via ``names`` / ``var0..``).  Every field is gathered to its
    global internal extent; coordinate variables ``x``/``y`` (physical
    T-point coordinates, reference xt/yt formula) are emitted per
    distinct extent, and a multi-level field gains a ``z<N>`` level
    dimension.  The reference has no structured output at all (its
    dump is a test-only gnuplot writer, test_halos.f90:267-338); this
    is what its NEMO-family clients wrap third-party IO layers for.

    Plain 2D/3D numpy arrays are accepted alongside Fields (dims only,
    no coordinate variables — there is no grid to take them from): the
    prep path for bathymetry/tmask input files, read back by
    :func:`load_netcdf`.
    """
    import struct

    if isinstance(fields, Field):
        fields = {"var0" if not names else names[0]: fields}
    elif not isinstance(fields, dict):
        fields = {(names[i] if names else f"var{i}"): f
                  for i, f in enumerate(fields)}

    dims: dict[str, int] = {}      # name -> length, insertion-ordered
    variables = []                 # (name, dim names, np data, attrs)

    def dim_for(axis: str, n: int) -> str:
        """Dimension name for extent n: the bare axis name first, a
        suffixed one when fields of different extents share the file."""
        if dims.get(axis, n) == n:
            dims[axis] = n
            return axis
        name = f"{axis}{n}"
        dims[name] = n
        return name

    coords_done = set()
    for name, fld in fields.items():
        if not isinstance(fld, Field):            # raw-array prep path
            g = np.asarray(fld)
            if g.ndim not in (2, 3):
                raise ValueError(
                    f"array variable {name!r} must be 2D (y, x) or "
                    f"3D (z, y, x), got shape {g.shape}")
            ydim = dim_for("y", g.shape[-2])
            xdim = dim_for("x", g.shape[-1])
            vdims = (ydim, xdim)
            if g.ndim == 3:
                vdims = (dim_for("z", g.shape[0]),) + vdims
            variables.append((name, vdims, g, {}))
            continue
        g = np.asarray(fld.gather_inner_data())
        d = fld.grid.decomp
        xdim = dim_for("x", d.global_nx)
        ydim = dim_for("y", d.global_ny)
        if xdim not in coords_done:
            coords_done.add(xdim)
            variables.append((xdim, (xdim,),
                              (np.arange(d.global_nx) + 1) * fld.grid.dx,
                              {"units": "m", "axis": "X"}))
        if ydim not in coords_done:
            coords_done.add(ydim)
            variables.append((ydim, (ydim,),
                              (np.arange(d.global_ny) + 1) * fld.grid.dy,
                              {"units": "m", "axis": "Y"}))
        vdims = (ydim, xdim)
        if g.ndim == 3:
            zdim = dim_for("z", g.shape[0])
            vdims = (zdim, ydim, xdim)
        variables.append((name, vdims, g,
                          {"coordinates": f"{ydim} {xdim}"}))

    dim_ids = {n: i for i, n in enumerate(dims)}

    def header(offsets) -> bytes:
        out = [b"CDF\x01", struct.pack(">I", 0)]          # numrecs=0
        out.append(struct.pack(">II", 0x0A, len(dims)))
        for n, ln in dims.items():
            out.append(_nc_name(n) + struct.pack(">I", ln))
        out.append(_nc_attrs(global_attrs or {}))
        out.append(struct.pack(">II", 0x0B, len(variables)))
        for i, (n, vdims, g, attrs) in enumerate(variables):
            out.append(_nc_name(n))
            out.append(struct.pack(">I", len(vdims)))
            for dn in vdims:
                out.append(struct.pack(">I", dim_ids[dn]))
            out.append(_nc_attrs(attrs))
            tc, sz = _NC_TYPES[np.dtype(g.dtype)]
            vsize = -(-g.size * sz // 4) * 4
            out.append(struct.pack(">III", tc, vsize, offsets[i]))
        return b"".join(out)

    # data payloads, big-endian, 4-byte padded
    payloads = []
    for i, (n, vdims, g, attrs) in enumerate(variables):
        if np.dtype(g.dtype) not in _NC_TYPES:   # e.g. bf16, int64 masks
            g = _nc_narrow(g, n)
            variables[i] = (n, vdims, g, attrs)
        payloads.append(_nc_pad(
            np.ascontiguousarray(g).astype(
                np.dtype(g.dtype).newbyteorder(">")).tobytes()))

    hlen = len(header([0] * len(variables)))   # pass 1: header size
    offsets, pos = [], hlen
    for p in payloads:
        offsets.append(pos)
        pos += len(p)
    with open(path, "wb") as f:
        f.write(header(offsets))
        for p in payloads:
            f.write(p)


class NetCDFTimeSeries:
    """Streaming time-series output: one NetCDF-3 file with an
    UNLIMITED (record) time dimension, one record appended per call —
    the production output path (snapshot history files) the reference's
    NEMO-family clients wrap third-party IO layers for.

    The header (fixed coordinate variables included) is written at
    open; each :meth:`append` gathers the fields and writes one record
    slab straight to disk (no host-side history buffering); ``close``
    patches the record count.  Readable mid-stream by readers that
    honour the streaming convention, and by anything after close.

    >>> ts = NetCDFTimeSeries("hist.nc", {"ssh": m.sshn_t})
    >>> for k in range(10):
    ...     m.run(50)
    ...     ts.append(time=50.0 * (k + 1) * rdt)
    >>> ts.close()
    """

    def __init__(self, path: str, fields: dict, *,
                 global_attrs: dict | None = None,
                 time_units: str = "s", dtype=None):
        import struct
        self._fields = dict(fields)
        self._nrec = 0
        g0 = {n: np.asarray(f.gather_inner_data())
              for n, f in self._fields.items()}
        # same kind-based narrowing as dump_netcdf (int64 fields must
        # not silently become float32)
        self._dtypes = {n: np.dtype(dtype) if dtype is not None
                        else (g.dtype if g.dtype in _NC_TYPES
                              else np.dtype(
                                  "i4" if g.dtype.kind in "iu" else "f4"))
                        for n, g in g0.items()}

        dims = {"time": 0}                       # record dim first
        variables = []                           # fixed coords
        rec_vars = [("time", ("time",), np.dtype("f8"),
                     {"units": time_units, "axis": "T"})]
        for n, g in g0.items():
            fld = self._fields[n]
            d = fld.grid.decomp
            for axis, ln, coord in (
                    ("y", d.global_ny, (np.arange(d.global_ny) + 1)
                     * fld.grid.dy),
                    ("x", d.global_nx, (np.arange(d.global_nx) + 1)
                     * fld.grid.dx)):
                if dims.get(axis, ln) != ln:
                    raise ValueError(
                        "all time-series fields must share one grid "
                        f"extent; {axis}={ln} vs {dims[axis]}")
                if axis not in dims:
                    dims[axis] = ln
                    variables.append((axis, (axis,), coord,
                                      {"units": "m",
                                       "axis": axis.upper()}))
            vdims = ("time", "y", "x")
            if g.ndim == 3:
                if dims.setdefault("z", g.shape[0]) != g.shape[0]:
                    raise ValueError("mismatched level counts")
                vdims = ("time", "z", "y", "x")
            rec_vars.append((n, vdims, self._dtypes[n],
                             {"coordinates": "y x"}))

        dim_ids = {n: i for i, n in enumerate(dims)}
        nrecvars = len(rec_vars)

        def rec_slab_bytes(vdims, dt):
            n = int(np.prod([dims[d] for d in vdims[1:]], dtype=np.int64))
            nb = n * dt.itemsize
            return nb if nrecvars == 1 else nb + (-nb % 4)

        def header(fixed_offsets, rec_offsets):
            out = [b"CDF\x01", struct.pack(">i", -1)]   # STREAMING numrecs
            out.append(struct.pack(">II", 0x0A, len(dims)))
            for n, ln in dims.items():
                out.append(_nc_name(n)
                           + struct.pack(">I", 0 if n == "time" else ln))
            out.append(_nc_attrs(global_attrs or {}))
            out.append(struct.pack(
                ">II", 0x0B, len(variables) + nrecvars))
            for i, (n, vdims, g, attrs) in enumerate(variables):
                tc, sz = _NC_TYPES[np.dtype(g.dtype)]
                out.append(_nc_name(n) + struct.pack(">I", len(vdims)))
                out += [struct.pack(">I", dim_ids[d]) for d in vdims]
                out.append(_nc_attrs(attrs))
                out.append(struct.pack(">III", tc,
                                       -(-g.size * sz // 4) * 4,
                                       fixed_offsets[i]))
            for i, (n, vdims, dt, attrs) in enumerate(rec_vars):
                out.append(_nc_name(n) + struct.pack(">I", len(vdims)))
                out += [struct.pack(">I", dim_ids[d]) for d in vdims]
                out.append(_nc_attrs(attrs))
                out.append(struct.pack(">III", _NC_TYPES[dt][0],
                                       rec_slab_bytes(vdims, dt),
                                       rec_offsets[i]))
            return b"".join(out)

        for i, (n, vdims, g, attrs) in enumerate(variables):
            variables[i] = (n, vdims, g.astype(
                np.dtype(g.dtype if g.dtype in _NC_TYPES else "f8")), attrs)
        hlen = len(header([0] * len(variables), [0] * nrecvars))
        fixed_offsets, pos = [], hlen
        payloads = []
        for n, vdims, g, attrs in variables:
            p = _nc_pad(np.ascontiguousarray(g).astype(
                g.dtype.newbyteorder(">")).tobytes())
            fixed_offsets.append(pos)
            payloads.append(p)
            pos += len(p)
        rec_offsets = []
        self._rec_stride = 0
        for n, vdims, dt, attrs in rec_vars:
            rec_offsets.append(pos + self._rec_stride)
            self._rec_stride += rec_slab_bytes(vdims, dt)
        self._rec_vars = rec_vars
        # multi-process: every process gathers (collective), only the
        # master writes — same split as the reference's master-rank IO
        from ..parallel import environment as env
        self._master = env.on_master()
        self._f = open(path, "wb") if self._master else None
        self._closed = False
        if self._master:
            self._f.write(header(fixed_offsets, rec_offsets))
            for p in payloads:
                self._f.write(p)

    def append(self, time: float = None) -> None:
        """Gather every field and write one record (host-side; the
        device arrays are untouched)."""
        if self._closed:
            raise ValueError("time series already closed")
        t = float(self._nrec if time is None else time)
        single = len(self._rec_vars) == 1
        for n, vdims, dt, _ in self._rec_vars:
            if n == "time":
                g = np.asarray(t, "f8")
            else:
                g = np.asarray(self._fields[n].gather_inner_data())
                # any int-kind change can wrap (incl. SAME-width
                # uint32 -> i4 at >= 2**31): range-check whenever the
                # target cannot represent the source exactly
                if (dt.kind == "i" and g.dtype.kind in "iu"
                        and np.dtype(g.dtype) != dt):
                    info = np.iinfo(dt)
                    if g.size and (g.min() < info.min
                                   or g.max() > info.max):
                        raise ValueError(
                            f"record {self._nrec} of {n!r} has values "
                            f"outside the {dt} range")
                g = np.asarray(g, dt)
            if self._f is not None:
                b = np.ascontiguousarray(g).astype(
                    dt.newbyteorder(">")).tobytes()
                self._f.write(b if single else _nc_pad(b))
        self._nrec += 1
        if self._f is not None:
            # crash-safety + the documented mid-stream readability: the
            # streaming numrecs sentinel only helps once records reach
            # the file
            self._f.flush()

    def close(self) -> None:
        import struct
        if self._closed:
            return
        self._closed = True
        if self._f is not None:
            self._f.seek(4)
            self._f.write(struct.pack(">I", self._nrec))
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


_NC_DTYPES = {1: np.dtype("i1"), 2: np.dtype("S1"), 3: np.dtype(">i2"),
              4: np.dtype(">i4"), 5: np.dtype(">f4"), 6: np.dtype(">f8")}


def load_netcdf(path: str) -> dict:
    """Read a NetCDF-3 classic file (CDF-1 or CDF-2, fixed AND record
    variables) with plain numpy — the input half of the NEMO-family
    workflow (bathymetry / tmask / forcing read from .nc files the
    reference's clients produce with third-party IO layers).

    Returns ``{"dimensions": {name: len}, "attributes": {...},
    "variables": {name: ndarray}, "variable_attrs": {name: {...}}}``.
    The record dimension's length is the actual record count.  Pinned
    in tests/test_torch_utils.py against files written by scipy
    (independent producer) and by :func:`dump_netcdf` (round-trip).
    """
    import struct

    with open(path, "rb") as f:
        buf = f.read()
    if buf[:3] != b"CDF" or buf[3] not in (1, 2):
        raise ValueError(f"{path!r} is not a NetCDF-3 classic file")
    osize = 4 if buf[3] == 1 else 8          # CDF-2: 64-bit offsets
    pos = 4

    def u32():
        nonlocal pos
        v = struct.unpack_from(">I", buf, pos)[0]
        pos += 4
        return v

    def name():
        nonlocal pos
        n = u32()
        s = buf[pos:pos + n].decode()
        pos += n + (-n % 4)
        return s

    def attrs():
        nonlocal pos
        tag, natt = u32(), u32()
        if tag not in (0, 0x0C):
            raise ValueError(f"bad attribute-list tag {tag:#x}")
        out = {}
        for _ in range(natt):
            an = name()
            tc, n = u32(), u32()
            if tc == 2:
                out[an] = buf[pos:pos + n].decode(errors="replace")
                pos += n + (-n % 4)
            else:
                dt = _NC_DTYPES[tc]
                nb = n * dt.itemsize
                vals = np.frombuffer(buf, dt, n, pos)
                pos += nb + (-nb % 4)
                out[an] = vals[0] if n == 1 else np.array(vals)
        return out

    numrecs = u32()
    streaming = numrecs == 0xFFFFFFFF        # unclosed/mid-stream file
    tag, ndim = u32(), u32()
    if tag not in (0, 0x0A):
        raise ValueError(f"bad dimension-list tag {tag:#x}")
    dim_names, dim_lens, rec_dim = [], [], None
    for i in range(ndim):
        dim_names.append(name())
        ln = u32()
        if ln == 0:
            rec_dim = i
            ln = 0 if streaming else numrecs
        dim_lens.append(ln)
    gattrs = attrs()
    tag, nvar = u32(), u32()
    if tag not in (0, 0x0B):
        raise ValueError(f"bad variable-list tag {tag:#x}")
    var_meta = []                      # (name, dimids, attrs, dt, begin)
    for _ in range(nvar):
        vn = name()
        dimids = [u32() for _ in range(u32())]
        vattrs = attrs()
        dt = _NC_DTYPES[u32()]
        u32()                          # vsize (unreliable for >2GB; recompute)
        begin = struct.unpack_from(">I" if osize == 4 else ">Q", buf, pos)[0]
        pos += osize
        var_meta.append((vn, dimids, vattrs, dt, begin))

    # record stride: padded per-record slab of every record variable —
    # EXCEPT when there is exactly one record variable (not padded)
    rec_vars = [(dimids, dt) for _, dimids, _, dt, _ in var_meta
                if dimids and dimids[0] == rec_dim]

    def slab(dimids, dt):
        n = int(np.prod([dim_lens[d] for d in dimids[1:]], dtype=np.int64))
        nb = n * dt.itemsize
        return n, (nb if len(rec_vars) == 1 else nb + (-nb % 4))

    rec_stride = sum(slab(dimids, dt)[1] for dimids, dt in rec_vars)
    if streaming:                 # derive the count from the file size
        first = min((b for _, dimids, _, _, b in var_meta
                     if dimids and dimids[0] == rec_dim), default=0)
        numrecs = (len(buf) - first) // rec_stride if rec_stride else 0
        if rec_dim is not None:
            dim_lens[rec_dim] = numrecs

    variables, var_attrs = {}, {}
    for vn, dimids, vattrs, dt, begin in var_meta:
        shape = tuple(dim_lens[d] for d in dimids)
        if dimids and dimids[0] == rec_dim:
            n, _ = slab(dimids, dt)
            recs = [np.frombuffer(buf, dt, n, begin + r * rec_stride)
                    for r in range(numrecs)]
            arr = (np.stack(recs) if recs
                   else np.empty((0,) + shape[1:], dt)).reshape(shape)
        else:
            arr = np.frombuffer(
                buf, dt, int(np.prod(shape, dtype=np.int64)), begin
            ).reshape(shape)
        variables[vn] = arr.astype(dt.newbyteorder("="))
        var_attrs[vn] = vattrs

    return {"dimensions": dict(zip(dim_names, dim_lens)),
            "attributes": gattrs, "variables": variables,
            "variable_attrs": var_attrs}
