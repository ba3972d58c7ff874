"""Derive a kernel's point body from its torch body.

The fused schedule sweep on the card (:mod:`.schedule_sweep`) is CUDA
C++ generated from each kernel's POINT body: the kernel at one cell,
reading its arguments at offsets.  A kernel may carry one written by hand
(``@kernel(..., cuda=...)``); for every other kernel this module derives
it from the torch body, as Pallas traces a jnp body on the TPU:

* :func:`trace` calls the body once per (kernel, argument levels,
  dtypes) on symbolic values.  A field or grid-property argument is a
  symbolic plane, a ``levels=N`` one a stack of N planes; a scalar is a
  symbolic double (a ``float`` whose value the source never sees: the
  sweep's source must not depend on it).  Each operation the body
  applies is recorded into an expression graph; arithmetic on scalars
  alone is recorded in double, as the host folds it.  Python control
  flow on scalars (``if dx == dy``) forks the trace: every branch is
  recorded and the source chooses at run time.  Control flow on a plane,
  a scalar turned into a host float (``math.sin``, ``float()``), or an
  operation outside :data:`OPERATIONS` raises, naming the kernel.
* :func:`lower` pushes the shifts (``torch.roll`` on the last two dims,
  which is how ``stencils.xp/xm/yp/ym/shift`` are built) down to the
  leaf reads: a shifted intermediate is recomputed at the offset, once
  per (node, offset).  A read beyond the argument's declared stencil
  raises ``ValueError``: the fused tier's erosion trusts the metadata.
* :func:`replay` runs the lowered program on real blocks with the same
  torch operations (bitwise equal to the body; how the derivation is
  held on a machine without a card), and :func:`cuda_body` prints it as
  a point body in the generator's language.  The printer follows
  PyTorch's CUDA kernels: ``tensor / scalar`` multiplies by the
  scalar's reciprocal there, a Python float meets a float32 plane
  rounded to float, and a level sum adds in level order (PyTorch's own
  reduction may group differently: the one place a derived body can
  differ from the plain tier on the card).
"""
from __future__ import annotations

import functools
import inspect
import math
import operator
import weakref
from dataclasses import dataclass, replace as _replace

import torch
from torch.overrides import TorchFunctionMode

#: the most branches one body's scalar control flow may fork into
MAX_PATHS = 16

_ROADMAP = "ROADMAP.md queue B4"
_CTYPE = {torch.float32: "float", torch.float64: "double",
          torch.int32: "int32_t", torch.int64: "long long",
          torch.bool: "bool", "f": "double", "i": "long long", "b": "bool"}
_BINARY = {"add": operator.add, "sub": operator.sub, "mul": operator.mul,
           "div": operator.truediv, "eq": operator.eq, "ne": operator.ne,
           "lt": operator.lt, "le": operator.le, "gt": operator.gt,
           "ge": operator.ge}
_CMP = {"eq": "==", "ne": "!=", "lt": "<", "le": "<=", "gt": ">", "ge": ">="}
_ARITH = {"add": "+", "sub": "-", "mul": "*", "div": "/"}


@dataclass(frozen=True)
class ArgSpec:
    """One body parameter: a plane (``levels`` 0 for 2D, else the
    number of stacked planes) of ``dtype``, or a scalar (a double: the
    fused tier hands every scalar to the body as a Python float)."""
    scalar: bool
    dtype: object = None
    levels: int = 0


@dataclass(frozen=True)
class Node:
    op: str
    dtype: object        # torch dtype (planes) or "f"/"i"/"b" (scalars)
    args: tuple = ()     # node indices
    attrs: tuple = ()

    @property
    def scalar(self) -> bool:
        return isinstance(self.dtype, str)


@dataclass(frozen=True)
class Out:
    """One body result: node indices per level (``lev``) or one."""
    nodes: tuple
    lev: bool


@dataclass(frozen=True)
class Path:
    """One branch of the body: its scalar conditions and results."""
    guards: tuple        # ((condition node, taken), ...)
    outs: tuple          # Out per result


@dataclass(frozen=True)
class Record:
    """What :func:`trace` records of one body."""
    name: str
    params: tuple        # parameter names (messages only)
    specs: tuple         # ArgSpec per parameter
    stencils: tuple      # declared Stencil per parameter (None: scalar)
    nodes: tuple         # Node per index
    paths: tuple         # Path per branch
    tuple_out: bool


#: the operations a body may use: those the repository's kernel bodies
#: use (models/nemolite2d_psy.py and the models/nemolite2d.py physics it
#: calls, ops/stencils.py, the schedule tests' kernels)
OPERATIONS = (
    "+ - * / (either operand a scalar), unary -, comparisons, "
    ".to(dtype), torch.where, zeros_like, full_like, full, as_tensor, "
    "minimum, maximum, clamp (scalar bounds), abs, sqrt, torch.roll on "
    "the last two dims; for levels: e[k], e.shape[0], torch.stack(dim=0), "
    "cumsum(dim=0), flip((0,)), .sum(dim=0)")


# --- symbolic values ---------------------------------------------------------

def _is_sym(v) -> bool:
    return isinstance(v, (_Plane, _Scalar))


def _any_sym(obj) -> bool:
    if isinstance(obj, (list, tuple)):
        return any(_any_sym(x) for x in obj)
    if isinstance(obj, dict):
        return any(_any_sym(x) for x in obj.values())
    return _is_sym(obj)


class _Scalar(float):
    """A symbolic scalar.  A ``float`` (its value NaN, never read) so
    that a body's ``isinstance(dx, float)`` holds as on the host."""
    __array_ufunc__ = None

    def __new__(cls, tr, node: int):
        obj = float.__new__(cls, math.nan)
        obj.tr, obj.node = tr, node
        return obj

    @property
    def kind(self) -> str:
        return self.tr.nodes[self.node].dtype

    def _bin(self, other, op, rev=False):
        if isinstance(other, _Plane):
            return NotImplemented
        o = self.tr.scalar_of(other)
        if o is None:
            return NotImplemented
        return self.tr.sop(op, (o, self) if rev else (self, o))

    def __add__(self, o): return self._bin(o, "add")
    def __radd__(self, o): return self._bin(o, "add", True)
    def __sub__(self, o): return self._bin(o, "sub")
    def __rsub__(self, o): return self._bin(o, "sub", True)
    def __mul__(self, o): return self._bin(o, "mul")
    def __rmul__(self, o): return self._bin(o, "mul", True)
    def __truediv__(self, o): return self._bin(o, "div")
    def __rtruediv__(self, o): return self._bin(o, "div", True)
    def __eq__(self, o): return self._bin(o, "eq")
    def __ne__(self, o): return self._bin(o, "ne")
    def __lt__(self, o): return self._bin(o, "lt")
    def __le__(self, o): return self._bin(o, "le")
    def __gt__(self, o): return self._bin(o, "gt")
    def __ge__(self, o): return self._bin(o, "ge")
    def __neg__(self): return self.tr.sop("neg", (self,))
    def __pos__(self): return self
    def __abs__(self): return self.tr.sop("abs", (self,))
    def __hash__(self): return id(self)
    def __bool__(self): return self.tr.decide(self)
    def __repr__(self): return f"<traced scalar #{self.node}>"

    def _host(self, what):
        raise NotImplementedError(
            f"kernel {self.tr.name}: {what} of a scalar argument would "
            "make the generated source depend on its value; keep scalar "
            "arithmetic to + - * / and comparisons, or give the kernel a "
            f"cuda= body ({_ROADMAP})")

    def __float__(self): self._host("float()")
    def __int__(self): self._host("int()")
    def __index__(self): self._host("an index")
    def __floor__(self): self._host("math.floor")
    def __ceil__(self): self._host("math.ceil")
    def __trunc__(self): self._host("math.trunc")
    def __round__(self, n=None): self._host("round()")
    def __pow__(self, o): self.tr.refuse("** on a scalar")
    def __rpow__(self, o): self.tr.refuse("** on a scalar")
    def __floordiv__(self, o): self.tr.refuse("// on a scalar")
    def __rfloordiv__(self, o): self.tr.refuse("// on a scalar")
    def __mod__(self, o): self.tr.refuse("% on a scalar")
    def __rmod__(self, o): self.tr.refuse("% on a scalar")


class _Plane:
    """A symbolic block: one plane (2D) or a stack of level planes."""
    __array_ufunc__ = None

    def __init__(self, tr, nodes, lev: bool):
        self.tr, self.nodes, self.lev = tr, tuple(nodes), lev

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        tr = next(a.tr for a in _flat(args) if isinstance(a, _Plane))
        return tr.torch_call(func, args, kwargs or {})

    @property
    def dtype(self):
        return self.tr.nodes[self.nodes[0]].dtype

    @property
    def device(self):
        return torch.device("cpu")

    @property
    def shape(self):
        return torch.Size(((len(self.nodes),) if self.lev else ()) + (-1, -1))

    @property
    def ndim(self) -> int:
        return 3 if self.lev else 2

    def __getitem__(self, idx):
        if self.lev and isinstance(idx, int):
            return _Plane(self.tr, (self.nodes[idx],), False)
        self.tr.refuse(f"indexing a {self.ndim}D plane with {idx!r} "
                       "(e[k] on levels only)")

    def __getattr__(self, name):
        if hasattr(torch.Tensor, name):
            self.tr.refuse(f"Tensor.{name}")
        raise AttributeError(name)

    def __bool__(self):
        raise ValueError(
            f"kernel {self.tr.name}: Python control flow on a traced "
            "plane (its value differs from point to point); use "
            "torch.where")

    def __float__(self):
        self.tr.refuse("float() of a plane")

    __int__ = __index__ = __float__
    __hash__ = object.__hash__

    def _bin(self, other, op, rev=False):
        return self.tr.pop_(op, (other, self) if rev else (self, other))

    def __add__(self, o): return self._bin(o, "add")
    def __radd__(self, o): return self._bin(o, "add", True)
    def __sub__(self, o): return self._bin(o, "sub")
    def __rsub__(self, o): return self._bin(o, "sub", True)
    def __mul__(self, o): return self._bin(o, "mul")
    def __rmul__(self, o): return self._bin(o, "mul", True)
    def __truediv__(self, o): return self._bin(o, "div")

    def __rtruediv__(self, o):
        # Tensor.__rtruediv__ is self.reciprocal() * other
        return self.tr.unary("reciprocal", self) * o

    def __eq__(self, o): return self._bin(o, "eq")
    def __ne__(self, o): return self._bin(o, "ne")
    def __lt__(self, o): return self._bin(o, "lt")
    def __le__(self, o): return self._bin(o, "le")
    def __gt__(self, o): return self._bin(o, "gt")
    def __ge__(self, o): return self._bin(o, "ge")
    def __neg__(self): return self.tr.unary("neg", self)
    def __pos__(self): return self
    def __pow__(self, o): self.tr.refuse("** // % & | ^ on a plane")
    __rpow__ = __floordiv__ = __rfloordiv__ = __mod__ = __rmod__ = __pow__
    __and__ = __rand__ = __or__ = __ror__ = __xor__ = __rxor__ = __pow__
    def __invert__(self): self.tr.refuse("~ on a plane")

    def to(self, *args, **kwargs):
        dtype = kwargs.pop("dtype", None)
        for a in args:
            if isinstance(a, torch.dtype):
                dtype = a
            elif not isinstance(a, (str, torch.device)):
                self.tr.refuse(f"Tensor.to({a!r})")
        return self if dtype is None else self.tr.cast(self, dtype)

    def sum(self, dim=None, **kw):
        return self.tr.level_sum(self, dim, kw)

    def __repr__(self):
        return f"<traced {'levels' if self.lev else 'plane'} {self.nodes}>"


def _flat(obj):
    if isinstance(obj, (list, tuple)):
        for x in obj:
            yield from _flat(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from _flat(x)
    else:
        yield obj


# --- dtype rules (torch's type promotion, for the printer) -------------------

def _category(d) -> int:
    if d in ("b", torch.bool):
        return 0
    if d == "i" or (isinstance(d, torch.dtype) and not d.is_floating_point):
        return 1
    return 2


def _promote(a, b):
    """torch's result dtype of a binary op on a plane dtype and a plane
    dtype or scalar kind (a Python scalar ranks below any plane of its
    category)."""
    if isinstance(a, str) and isinstance(b, str):
        raise AssertionError("two scalars make a scalar op")
    if isinstance(a, str):
        a, b = b, a
    if not isinstance(b, str):
        return torch.promote_types(a, b)
    if _category(b) <= _category(a):
        return a
    return torch.get_default_dtype() if b == "f" else torch.int64


def _floating(d):
    return d if d.is_floating_point else torch.get_default_dtype()


# --- the tracer --------------------------------------------------------------

class _Tracer:
    def __init__(self, name, nodes, index, prefix):
        self.name = name
        self.nodes, self.index = nodes, index      # shared by the paths
        self.prefix = prefix
        self.guards: list = []

    # graph -----------------------------------------------------------------
    def add(self, op, dtype, args=(), attrs=()) -> int:
        node = Node(op, dtype, tuple(args), tuple(attrs))
        i = self.index.get(node)
        if i is None:
            i = self.index[node] = len(self.nodes)
            self.nodes.append(node)
        return i

    def refuse(self, what):
        raise NotImplementedError(
            f"kernel {self.name}: {what} is outside the operations the "
            f"point tracer derives a CUDA body from ({OPERATIONS}); give "
            f"the kernel a cuda= body or run the plain tier ({_ROADMAP})")

    def decide(self, s: _Scalar) -> bool:
        cond = s.node if s.kind == "b" else self.add(
            "ne", "b", (s.node, self.const(0)))
        for c, taken in self.guards:        # decided before on this path
            if c == cond:
                return taken
        k = len(self.guards)
        taken = self.prefix[k] if k < len(self.prefix) else True
        self.guards.append((cond, taken))
        return taken

    def const(self, v) -> int:
        if isinstance(v, bool):
            return self.add("const", "b", attrs=(v,))
        if isinstance(v, int):
            return self.add("const", "i", attrs=(int(v),))
        v = float(v)
        if math.isnan(v):
            raise NotImplementedError(
                f"kernel {self.name}: a NaN constant in the body, which is "
                "what a scalar argument becomes when a host function "
                "(math.*, numpy, float()) reads it: the generated source "
                f"would depend on its value ({_ROADMAP})")
        return self.add("const", "f", attrs=(v,))

    def scalar_of(self, v):
        """``v`` as a symbolic scalar, or None for a type that is not a
        scalar."""
        if isinstance(v, _Scalar):
            return v
        if isinstance(v, torch.Tensor):
            self.refuse("a tensor constant")
        if isinstance(v, (bool, int, float)):
            return _Scalar(self, self.const(v))
        return None

    def sop(self, op, operands) -> _Scalar:
        kinds = [o.kind for o in operands]
        if op in _CMP:
            kind = "b"
        elif op == "div" or "f" in kinds:
            kind = "f"
        else:
            kind = "i"
        return _Scalar(self, self.add(op, kind, [o.node for o in operands]))

    # planes ----------------------------------------------------------------
    def operand(self, v):
        """(per-level nodes or None, lev, dtype or scalar kind)."""
        if isinstance(v, _Plane):
            return v.nodes, v.lev, v.dtype
        s = self.scalar_of(v)
        if s is None:
            self.refuse(f"an operand of type {type(v).__name__}")
        return (s.node,), None, s.kind

    def levels_of(self, parts):
        levs = {len(n) for n, lev, _ in parts if lev}
        if len(levs) > 1:
            raise ValueError(f"kernel {self.name}: level counts {levs} do "
                             "not broadcast")
        return levs.pop() if levs else 0

    def pointwise(self, op, dtype, values, attrs=()) -> _Plane:
        parts = [self.operand(v) for v in values]
        L = self.levels_of(parts)
        out = [self.add(op, dtype, [n[k] if len(n) > 1 else n[0]
                                    for n, _, _ in parts], attrs)
               for k in range(max(L, 1))]
        return _Plane(self, out, bool(L))

    def pop_(self, op, values):
        dtype = _promote(*[self.operand(v)[2] for v in values])
        if op in _CMP:
            return self.pointwise(op, torch.bool, values)
        if dtype == torch.bool:
            self.refuse(f"arithmetic '{op}' on bool operands")
        if op == "div":
            dtype = _floating(dtype)
        return self.pointwise(op, dtype, values)

    def unary(self, op, x) -> _Plane:
        d = x.dtype
        if op in ("sqrt", "reciprocal"):
            d = _floating(d)
        elif d == torch.bool:
            self.refuse(f"{op} of a bool plane")
        return self.pointwise(op, d, (x,))

    def cast(self, x, dtype) -> _Plane:
        if dtype not in _CTYPE:
            self.refuse(f".to({dtype})")
        return x if dtype == x.dtype else self.pointwise("to", dtype, (x,))

    def clamp(self, x, lo, hi) -> _Plane:
        if isinstance(lo, _Plane) or isinstance(hi, _Plane):
            self.refuse("clamp with plane bounds (use minimum/maximum)")
        if lo is None and hi is None:
            raise ValueError(f"kernel {self.name}: clamp without bounds")
        vals = [x] + [v for v in (lo, hi) if v is not None]
        return self.pointwise("clamp", x.dtype, vals,
                              (lo is not None, hi is not None))

    def where(self, c, a, b) -> _Plane:
        if not isinstance(c, _Plane) or c.dtype != torch.bool:
            self.refuse("torch.where with a condition that is not a bool "
                        "plane")
        dts = [self.operand(v)[2] for v in (a, b)]
        if all(isinstance(d, str) for d in dts):
            dtype = (torch.get_default_dtype() if "f" in dts
                     else torch.int64 if "i" in dts else torch.bool)
        else:
            dtype = _promote(*dts)
        return self.pointwise("where", dtype, (c, a, b))

    def minmax(self, op, a, b) -> _Plane:
        if not (isinstance(a, _Plane) and isinstance(b, _Plane)):
            self.refuse(f"torch.{op} with a scalar operand")
        return self.pointwise(op, _promote(a.dtype, b.dtype), (a, b))

    def full(self, value, dtype, L) -> _Plane:
        s = self.scalar_of(value)
        if s is None:
            self.refuse(f"a fill value of type {type(value).__name__}")
        if dtype is None:
            dtype = {"f": torch.get_default_dtype(), "i": torch.int64,
                     "b": torch.bool}[s.kind]
        n = self.add("full", dtype, (s.node,))
        return _Plane(self, [n] * max(L, 1), bool(L))

    def roll(self, x, shifts, dims) -> _Plane:
        shifts = shifts if isinstance(shifts, (tuple, list)) else (shifts,)
        if dims is None:
            self.refuse("torch.roll of the flattened block")
        dims = dims if isinstance(dims, (tuple, list)) else (dims,)
        dj = di = 0
        for s, d in zip(shifts, dims):
            d = d - x.ndim if d >= 0 else d
            if isinstance(s, _Scalar) or not isinstance(s, int):
                self.refuse(f"torch.roll by {s!r} (integer shifts only)")
            if d == -1:
                di -= s
            elif d == -2:
                dj -= s
            else:
                self.refuse("torch.roll along the levels")
        out = []
        for n in x.nodes:
            node = self.nodes[n]
            if node.op == "shift":           # compose the offsets
                n, (a, b) = node.args[0], node.attrs
                tj, ti = a + dj, b + di
            else:
                tj, ti = dj, di
            out.append(n if not (tj or ti)
                       else self.add("shift", node.dtype, (n,), (tj, ti)))
        return _Plane(self, out, x.lev)

    def levels_only(self, x, dim, what):
        if not isinstance(x, _Plane) or not x.lev:
            self.refuse(f"{what} of a 2D plane")
        if dim not in (0, -3, (0,), [0]):
            self.refuse(f"{what} along dim {dim!r} (dim 0, the levels, "
                        "only)")

    def stack(self, seq, dim=0) -> _Plane:
        seq = list(seq)
        if dim not in (0, -3) or not seq or any(
                not isinstance(p, _Plane) or p.lev for p in seq):
            self.refuse("torch.stack other than 2D planes along dim 0")
        dtype = seq[0].dtype
        for p in seq[1:]:
            dtype = torch.promote_types(dtype, p.dtype)
        seq = [self.cast(p, dtype) for p in seq]
        return _Plane(self, [p.nodes[0] for p in seq], True)

    def cumsum(self, x, dim, kw) -> _Plane:
        if kw:
            self.refuse(f"cumsum with {sorted(kw)}")
        self.levels_only(x, dim, "cumsum")
        d = x.dtype if x.dtype.is_floating_point else torch.int64
        return _Plane(self, [self.add("cumsum", d, x.nodes[:k + 1])
                             for k in range(len(x.nodes))], True)

    def level_sum(self, x, dim, kw) -> _Plane:
        if kw:
            self.refuse(f"sum with {sorted(kw)}")
        if dim is None:
            self.refuse("a sum over the whole block (a reduction: declare "
                        "a GO_SUM argument, which the fused tier refuses)")
        self.levels_only(x, dim, "sum")
        d = x.dtype if x.dtype.is_floating_point else torch.int64
        return _Plane(self, [self.add("lsum", d, x.nodes)], False)

    def flip(self, x, dims) -> _Plane:
        dims = tuple(dims) if isinstance(dims, (tuple, list)) else (dims,)
        self.levels_only(x, dims, "flip")
        return _Plane(self, x.nodes[::-1], True)

    def like(self, x, value, kw) -> _Plane:
        dtype = kw.pop("dtype", None)
        self.placement_only(kw, "a *_like")
        return self.full(value, dtype or x.dtype, len(x.nodes) if x.lev
                         else 0)

    def placement_only(self, kw, what):
        """Refuse keyword arguments beyond where a tensor would live."""
        extra = set(kw) - {"device", "layout", "requires_grad"}
        if extra:
            self.refuse(f"{what} with {sorted(extra)}")

    def torch_call(self, func, args, kwargs):
        h = _TORCH.get(func)
        if h is None:
            if not _any_sym(args) and not _any_sym(kwargs):
                return func(*args, **kwargs)
            self.refuse(f"torch.{getattr(func, '__name__', func)}")
        return h(self, *args, **kwargs)


def _full(tr, size, fill_value, dtype=None, **kw):
    tr.placement_only(kw, "torch.full")
    size = tuple(size)
    if len(size) not in (2, 3):
        tr.refuse(f"torch.full of shape {size}")
    return tr.full(fill_value, dtype, size[0] if len(size) == 3 else 0)


def _as_tensor(tr, data, dtype=None, device=None):
    if isinstance(data, _Plane):
        return data if dtype is None else tr.cast(data, dtype)
    tr.refuse("torch.as_tensor of a scalar (a 0-d tensor)")


def _cumsum(tr, x, dim=None, **kw):
    return tr.cumsum(x, dim, kw)


#: torch functions the tracer takes, with their handlers
_TORCH = {
    torch.roll: lambda tr, x, shifts, dims=None: tr.roll(x, shifts, dims),
    torch.where: lambda tr, c, a, b: tr.where(c, a, b),
    torch.stack: lambda tr, seq, dim=0: tr.stack(seq, dim),
    torch.cumsum: _cumsum,
    torch.flip: lambda tr, x, dims: tr.flip(x, dims),
    torch.zeros_like: lambda tr, x, **kw: tr.like(x, 0, kw),
    torch.full_like: lambda tr, x, v, **kw: tr.like(x, v, kw),
    torch.full: _full,
    torch.as_tensor: _as_tensor,
    torch.minimum: lambda tr, a, b: tr.minmax("minimum", a, b),
    torch.maximum: lambda tr, a, b: tr.minmax("maximum", a, b),
    torch.clamp: lambda tr, x, min=None, max=None: tr.clamp(x, min, max),
    torch.abs: lambda tr, x: tr.unary("abs", x),
    torch.sqrt: lambda tr, x: tr.unary("sqrt", x),
}


class _Mode(TorchFunctionMode):
    """Routes every torch function the body calls to the tracer (also
    factories such as ``torch.full``, whose arguments hold no plane)."""

    def __init__(self, tr):
        super().__init__()
        self.tr = tr

    def __torch_function__(self, func, types, args=(), kwargs=None):
        return self.tr.torch_call(func, args, kwargs or {})


# --- trace -------------------------------------------------------------------

_RECORDS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _param_names(fn, n):
    try:
        names = [p.name for p in inspect.signature(fn).parameters.values()
                 if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    except (TypeError, ValueError):
        names = []
    return tuple(names[:n]) + tuple(f"arg{i}" for i in range(len(names), n))


def trace(fn, name: str, specs, stencils) -> Record:
    """The record of ``fn`` called on symbolic arguments (``specs``, one
    :class:`ArgSpec` per parameter, ``stencils`` the declared Stencil of
    each plane), cached per (fn, specs) for as long as ``fn`` lives."""
    specs, stencils = tuple(specs), tuple(stencils)
    cache = _RECORDS.setdefault(fn, {})
    key = (name, specs, stencils)
    if key in cache:
        return cache[key]
    nodes, index = [], {}
    paths, pending, tuple_out = [], [()], False
    while pending:
        prefix = pending.pop()
        tr = _Tracer(name, nodes, index, prefix)
        args = []
        for i, sp in enumerate(specs):
            if sp.scalar:
                args.append(_Scalar(tr, tr.add("sarg", "f", attrs=(i,))))
            else:
                args.append(_Plane(
                    tr, [tr.add("arg", sp.dtype, attrs=(i, k if sp.levels
                                                       else None))
                         for k in range(max(sp.levels, 1))],
                    bool(sp.levels)))
        with _Mode(tr):
            outs = fn(*args)
        tuple_out = isinstance(outs, tuple)
        outs = outs if tuple_out else (outs,)
        res = []
        for o in outs:
            if isinstance(o, _Plane):
                res.append(Out(o.nodes, o.lev))
            else:
                s = tr.scalar_of(o)
                if s is None:
                    raise NotImplementedError(
                        f"kernel {name}: returned a {type(o).__name__}")
                res.append(Out((s.node,), False))
        for d in range(len(prefix), len(tr.guards)):
            pending.append(tuple(t for _, t in tr.guards[:d]) + (False,))
        paths.append(Path(tuple(tr.guards), tuple(res)))
        if len(paths) > MAX_PATHS:
            raise NotImplementedError(
                f"kernel {name}: its scalar control flow forks into more "
                f"than {MAX_PATHS} branches")
    rec = Record(name=name, params=_param_names(fn, len(specs)),
                 specs=specs, stencils=stencils, nodes=tuple(nodes),
                 paths=tuple(paths), tuple_out=tuple_out)
    cache[key] = rec
    return rec


# --- lower -------------------------------------------------------------------

@dataclass(frozen=True)
class Instr:
    op: str
    dtype: object
    args: tuple = ()     # instruction indices
    attrs: tuple = ()


def _stencil_allows(st, dj: int, di: int) -> bool:
    if not (dj or di):
        return True
    d = st._digits()
    row = 0 if dj > 0 else 1 if dj == 0 else 2
    col = 0 if di < 0 else 1 if di == 0 else 2
    return d[3 * row + col] >= max(abs(dj), abs(di))


def lower(rec: Record, path: Path):
    """(instructions, outputs) of one branch: every shift pushed down to
    the leaf reads, each (node, offset) computed once.  Outputs are Out
    records over instruction indices."""
    instrs, index, memo = [], {}, {}

    def emit(ins):
        i = index.get(ins)
        if i is None:
            i = index[ins] = len(instrs)
            instrs.append(ins)
        return i

    def at(n, dj, di):
        node = rec.nodes[n]
        if node.scalar:
            dj = di = 0
        key = (n, dj, di)
        if key in memo:
            return memo[key]
        if node.op == "shift":
            a, b = node.attrs
            i = at(node.args[0], dj + a, di + b)
        elif node.op == "arg":
            pos, level = node.attrs
            st = rec.stencils[pos]
            if not _stencil_allows(st, dj, di):
                raise ValueError(
                    f"kernel {rec.name}: argument {pos} "
                    f"({rec.params[pos]}) is read at offset (dj={dj}, "
                    f"di={di}), beyond its declared stencil {st}; the "
                    "fused tier's halo erosion trusts the metadata")
            i = emit(Instr("read", node.dtype, (), (pos, level, dj, di)))
        else:
            i = emit(Instr(node.op, node.dtype,
                           tuple(at(c, dj, di) for c in node.args),
                           node.attrs))
        memo[key] = i
        return i

    outs = tuple(Out(tuple(at(n, 0, 0) for n in o.nodes), o.lev)
                 for o in path.outs)
    return tuple(instrs), outs


# --- replay (the derivation on real blocks) ----------------------------------

def _sapply(op, vals):
    """A scalar operation on host values, as Python computes it."""
    if op == "neg":
        return -vals[0]
    if op == "abs":
        return abs(vals[0])
    return _BINARY[op](*vals)


def _seval(rec: Record, n: int, scalars):
    """A scalar node's value on the host, as the body computes it."""
    node = rec.nodes[n]
    if node.op == "const":
        return node.attrs[0]
    if node.op == "sarg":
        return scalars[node.attrs[0]]
    return _sapply(node.op, [_seval(rec, c, scalars) for c in node.args])


def choose(rec: Record, scalars) -> Path:
    """The branch the body takes for these scalar values."""
    for p in rec.paths:
        if all(bool(_seval(rec, c, scalars)) == t for c, t in p.guards):
            return p
    raise AssertionError(f"kernel {rec.name}: no traced branch matches")


def _lowered(rec: Record, path: Path):
    cache = _LOWERED.setdefault(rec, {})
    if path not in cache:
        cache[path] = lower(rec, path)
    return cache[path]


_LOWERED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def replay(rec: Record, blocks):
    """The record's results on real ``blocks`` (one per parameter:
    tensors, levels stacked on dim 0, and Python scalars), through the
    lowered program; equal to the body's, bitwise."""
    scalars = {i: b for i, (b, sp) in enumerate(zip(blocks, rec.specs))
               if sp.scalar}
    instrs, outs = _lowered(rec, choose(rec, scalars))
    ref = next(b for b, sp in zip(blocks, rec.specs) if not sp.scalar)
    plane_shape, device = ref.shape[-2:], ref.device
    vals = []
    for ins in instrs:
        a = [vals[i] for i in ins.args]
        op = ins.op
        if op == "read":
            pos, level, dj, di = ins.attrs
            b = blocks[pos] if level is None else blocks[pos][level]
            v = torch.roll(b, (-dj, -di), (-2, -1)) if (dj or di) else b
        elif op == "sarg":
            v = blocks[ins.attrs[0]]
        elif op == "const":
            v = ins.attrs[0]
        elif isinstance(ins.dtype, str):
            v = _sapply(op, a)
        elif op in _BINARY:
            v = _BINARY[op](*a)
        elif op == "neg":
            v = -a[0]
        elif op in ("abs", "sqrt", "reciprocal"):
            v = getattr(torch, op)(a[0])
        elif op == "to":
            v = a[0].to(ins.dtype)
        elif op == "clamp":
            has_lo, has_hi = ins.attrs
            it = iter(a[1:])
            v = torch.clamp(a[0], min=next(it) if has_lo else None,
                            max=next(it) if has_hi else None)
        elif op == "where":
            v = torch.where(*a)
        elif op in ("minimum", "maximum"):
            v = getattr(torch, op)(*a)
        elif op == "full":
            v = torch.full(plane_shape, a[0], dtype=ins.dtype, device=device)
        elif op == "cumsum":
            v = torch.cumsum(torch.stack(a), 0)[-1]
        elif op == "lsum":
            v = torch.stack(a).sum(0)
        else:
            raise AssertionError(op)
        vals.append(v)
    res = tuple(torch.stack([vals[i] for i in o.nodes]) if o.lev
                else vals[o.nodes[0]] for o in outs)
    return res if rec.tuple_out else res[0]


# --- the CUDA point body -----------------------------------------------------

def _lit(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return f"{v}LL"
    if math.isinf(v):
        return "(-INFINITY)" if v < 0 else "INFINITY"
    return repr(float(v))


def _scalar_c(op, kind, a, kinds) -> str:
    """C++ of a scalar operation on operand expressions ``a`` of kinds
    ``kinds`` ("f" double, "i" long long, "b" bool), as Python computes
    it: an integer meets a double as a double, ``/`` is in double."""
    if op == "neg":
        return f"(-{a[0]})"
    if op == "abs":
        return f"::fabs({a[0]})" if kind == "f" else f"llabs({a[0]})"
    c = "f" if "f" in kinds or op == "div" else "i"
    a = [x if k == c else f"static_cast<{_CTYPE[c]}>({x})"
         for x, k in zip(a, kinds)]
    return f"({a[0]} {_CMP.get(op) or _ARITH[op]} {a[1]})"


class _Printer:
    """Prints one branch's instructions as C++ statements."""

    def __init__(self, rec, names, instrs, lines, tag):
        self.rec, self.names, self.instrs = rec, names, instrs
        self.lines, self.tag = lines, tag
        self.expr: dict = {}
        self.acc: dict = {}     # (summands, dtype) -> local of their sum
        self.n_acc = 0

    def cast(self, i, to) -> str:
        e, d = self.expr[i], self.instrs[i].dtype
        return e if d == to else f"static_cast<{_CTYPE[to]}>({e})"

    def local(self, i, dtype, e) -> str:
        name = f"sw_p{self.tag}_{i}"
        self.lines.append(f"const {_CTYPE[dtype]} {name} = {e};")
        return name

    def sum_chain(self, args, D) -> str:
        """args[0] + args[1] + ... in order, in D; prefixes shared."""
        if len(args) == 1:
            return self.cast(args[0], D)
        k = (tuple(args[:-1]), D)
        if k not in self.acc:
            inner = self.sum_chain(list(k[0]), D)
            self.n_acc += 1
            self.acc[k] = self.local(f"c{self.n_acc}", D, inner)
        return f"{self.acc[k]} + {self.cast(args[-1], D)}"

    def run(self):
        for i, ins in enumerate(self.instrs):
            self.expr[i] = self.one(i, ins)

    def one(self, i, ins) -> str:
        op, D, a = ins.op, ins.dtype, ins.args
        if op == "const":
            return _lit(ins.attrs[0])
        if op == "sarg":
            return self.names[ins.attrs[0]]
        if op == "read":
            pos, level, dj, di = ins.attrs
            idx = f"{dj}, {di}" if level is None else f"{level}, {dj}, {di}"
            return self.local(i, D, f"{self.names[pos]}({idx})")
        if isinstance(D, str):                       # scalar arithmetic
            return self.local(i, D, _scalar_c(
                op, D, [self.expr[j] for j in a],
                [self.instrs[j].dtype for j in a]))
        if op in ("add", "sub", "mul"):
            return self.local(i, D, f"{self.cast(a[0], D)} {_ARITH[op]} "
                                    f"{self.cast(a[1], D)}")
        if op == "div":
            if isinstance(self.instrs[a[1]].dtype, str):
                # PyTorch's CUDA div by a CPU scalar: a * (1 / b) in D
                return self.local(i, D, f"{self.cast(a[0], D)} * "
                                        f"({_CTYPE[D]}(1) / "
                                        f"{self.cast(a[1], D)})")
            return self.local(i, D, f"{self.cast(a[0], D)} / "
                                    f"{self.cast(a[1], D)}")
        if op in _CMP:
            C = _promote(*[self.instrs[j].dtype for j in a])
            return self.local(i, D, f"{self.cast(a[0], C)} {_CMP[op]} "
                                    f"{self.cast(a[1], C)}")
        if op == "neg":
            return self.local(i, D, f"-{self.cast(a[0], D)}")
        if op == "abs":
            return self.local(i, D, f"pt::abs_({self.cast(a[0], D)})")
        if op == "sqrt":
            return self.local(i, D, f"sweep::sqrt_t({self.cast(a[0], D)})")
        if op == "reciprocal":
            return self.local(i, D, f"{_CTYPE[D]}(1) / {self.cast(a[0], D)}")
        if op == "to":
            return self.local(i, D, self.cast(a[0], D))
        if op == "clamp":
            has_lo, has_hi = ins.attrs
            f = ("clamp" if has_lo and has_hi
                 else "clamp_min" if has_lo else "clamp_max")
            args = ", ".join(self.cast(j, D) for j in a)
            return self.local(i, D, f"pt::{f}({args})")
        if op == "where":
            return self.local(i, D, f"{self.expr[a[0]]} ? "
                                    f"{self.cast(a[1], D)} : "
                                    f"{self.cast(a[2], D)}")
        if op in ("minimum", "maximum"):
            return self.local(i, D, f"pt::{op}({self.cast(a[0], D)}, "
                                    f"{self.cast(a[1], D)})")
        if op == "full":
            return self.local(i, D, self.cast(a[0], D))
        if op in ("cumsum", "lsum"):
            name = self.local(i, D, self.sum_chain(list(a), D))
            self.acc.setdefault((tuple(a), D), name)
            return name
        raise AssertionError(op)


def _guard_expr(rec, n, names) -> str:
    node = rec.nodes[n]
    if node.op == "const":
        return _lit(node.attrs[0])
    if node.op == "sarg":
        return names[node.attrs[0]]
    return _scalar_c(node.op, node.dtype,
                     [_guard_expr(rec, c, names) for c in node.args],
                     [rec.nodes[c].dtype for c in node.args])


def cuda_body(rec: Record, names, written) -> str:
    """The record as a point body in the generator's language:
    ``names[i]`` is parameter i's accessor, ``written`` lists, per body
    result in order, ``(accessor name, levels of its slot (0: 2D),
    dtype of its slot)``.  Raises ``ValueError`` for a result whose
    level count does not fit its slot (as the plain tier does)."""
    if len(written) != len(rec.paths[0].outs):
        raise ValueError(f"kernel {rec.name} returned "
                         f"{len(rec.paths[0].outs)} output(s); its "
                         f"metadata declares {len(written)}")

    def branch(path, tag, indent):
        instrs, outs = _lowered(rec, path)
        lines = []
        p = _Printer(rec, names, instrs, lines, tag)
        p.run()
        for (wname, nlev, wdt), o in zip(written, outs):
            if o.lev and not nlev:
                raise ValueError(
                    f"kernel '{rec.name}' returned {len(o.nodes)} level "
                    "planes for a 2D field")
            if o.lev and len(o.nodes) != nlev:
                raise ValueError(
                    f"kernel '{rec.name}' returned {len(o.nodes)} level "
                    f"planes for a levels={nlev} field")
            if o.lev:
                for k, i in enumerate(o.nodes):
                    lines.append(f"{wname}[{k}] = {p.cast(i, wdt)};")
            else:
                lines.append(f"{wname} = {p.cast(o.nodes[0], wdt)};")
        return [indent + ln for ln in lines]

    def tree(paths, depth, indent, tag):
        if len(paths) == 1 and len(paths[0].guards) == depth:
            return branch(paths[0], tag, indent)
        cond = paths[0].guards[depth][0]
        yes = [p for p in paths if p.guards[depth][1]]
        no = [p for p in paths if not p.guards[depth][1]]
        out = [f"{indent}if ({_guard_expr(rec, cond, names)}) {{"]
        out += (tree(yes, depth + 1, indent + "  ", tag + "t") if yes
                else [f"{indent}  __trap();"])
        out.append(f"{indent}}} else {{")
        out += (tree(no, depth + 1, indent + "  ", tag + "f") if no
                else [f"{indent}  __trap();"])
        out.append(f"{indent}}}")
        return out

    return "\n".join(tree(list(rec.paths), 0, "", ""))


# --- kernels -----------------------------------------------------------------

def derived(kern):
    """A clone of a metadata kernel without its hand-written CUDA body:
    on a CUDA grid the fused tier derives its point body from the torch
    body (how a derived body is held against a hand-written one)."""
    def body(*args):
        return kern(*args)
    functools.update_wrapper(body, kern)
    body._meta = _replace(kern._meta, cuda=None)
    return body


def replaying(kern):
    """A clone of a metadata kernel whose torch body runs as the replay of
    its record, traced for the blocks it is called with: a plain tier
    that calls it computes what the derivation computes."""
    from ..api.kernel_meta import _is_reduction
    meta = kern._meta
    args = [a for a in meta.args if not _is_reduction(a)]

    def body(*blocks):
        specs, stencils = [], []
        for b, a in zip(blocks, args):
            if isinstance(b, torch.Tensor):
                specs.append(ArgSpec(False, b.dtype,
                                     int(b.shape[0]) if b.dim() == 3 else 0))
                stencils.append(a.stencil)
            else:
                specs.append(ArgSpec(True))
                stencils.append(None)
        return replay(trace(kern, meta.name, specs, stencils), blocks)
    functools.update_wrapper(body, kern)
    body._meta = meta
    return body
