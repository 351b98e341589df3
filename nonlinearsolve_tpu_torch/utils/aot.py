"""Ahead-of-time export and loading of solvers (the port of
``utils/aot.py``) through ``torch.export``.

The JAX package lowers the whole jitted solve, closed over the template,
to one StableHLO artifact, so whatever the template holds crosses with
it.  The port's solve is a host loop over device tensors, so each
callable the template holds crosses as its own exported program, and
everything else as data:

- the residual ``f(u, p)``, and the function's ``jac(u, p)`` (a ``CSR``
  result as its data, its pattern as data), ``jvp(v, u, p)`` and
  ``vjp(v, u, p)``; with ``batch=``, each also as a row-batched program
  whose leading dimension is symbolic (``make_fx`` of its ``vmap``);
- a preconditioner made by one of the port's factories (tagged by
  ``carried_factory``) as the factory's name and arguments, called again
  on loading; a user's ``precond_fn(u) -> (v -> M⁻¹v)`` as one program
  ``M(u, v)`` (``M(u, fu, v)`` when it ``wants_residual``);
- ``initialization_data``: its sub-problem as a nested archive of
  ``export_solver`` itself, with its state and parameters as data, and
  ``initializeprobmap(sol)`` / ``initializeprobpmap(sol, p)`` as programs
  of the sub-solution's tensors (rebuilt into a ``NonlinearSolution``
  inside the traced function);
- bounds, the sparsity pattern (a ``CSR`` pattern as its index arrays, a
  COO ``(rows, cols)`` as a tuple, a dense mask as a tensor),
  ``colorvec``, ``resid_prototype``, the algorithm and the frozen solve
  options, as data.

A pytree state or parameter is flattened by ``utils/pytree.py`` (JAX's
leaf order): every program takes the leaves of its arguments and returns
the leaves of its result, and the tree specs are stored as data, so a
loaded callable takes and returns the template's trees.  The solve that
runs on them is the port's own, which flattens the state through
``core/solve.py``'s ``FlatMap`` as in-process; a user's preconditioner is
traced on the state that map gives the engines.  ``deserialize_solver``
rebuilds the ``NonlinearFunction``, the problem and the algorithm with
every callable a loaded program, and runs ``solve`` (with ``batch=``,
``solve_ensemble``): the in-process solve, bit for bit.

The blob is a zip archive: ``meta.json`` (the problem's kind and calling
convention, the platforms, the trees, the function's fields, the
algorithm and the options, each dataclass of the port written as its
class's name and its fields), the programs (``*.pt2``,
``torch.export.save``), the tensors and arrays (``data/*``) and the
nested archive (``init.bin``).  A Python callable that is neither a
factory's product nor a ``precond_fn`` cannot be written as data and is
refused with its field's name.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import io
import json
import zipfile

import numpy as np
import torch

_PACKAGE = __name__.split(".")[0]
_PLATFORMS = ("cuda", "cpu")
_TRACE_OPTIONS = ("store_trace", "show_trace", "trace_level")
_FACTORY = "__nls_factory__"
_FUNCTIONS = ("jac", "jvp", "vjp")
_FUNCTION_DATA = ("jac_prototype", "sparsity", "colorvec", "resid_prototype")


def carried_factory(fn):
    """Decorate a factory of the port whose product a solver may hold (a
    preconditioner): the product carries the call that made it, the
    factory's qualified name and arguments, which ``export_solver`` writes
    as data and ``deserialize_solver`` makes again."""
    @functools.wraps(fn)
    def make(*args, **kwargs):
        out = fn(*args, **kwargs)
        setattr(out, _FACTORY,
                (f"{fn.__module__}:{fn.__qualname__}", args, kwargs))
        return out
    return make


def _port_attr(path: str):
    """The object named ``module:qualname``, inside the port only."""
    module, qualname = path.split(":")
    if module.split(".")[0] != _PACKAGE:
        raise ValueError(f"the artifact names a class outside the port: "
                         f"{module}")
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def _encode(x, where: str, out=None):
    """``x`` as JSON data: numbers, strings, None, tuples, lists, dicts,
    tensors, dtypes, the port's dataclasses and the products of its
    factories; with an archive ``out``, also numpy arrays and ``CSR``
    matrices.  With ``out``, tensors and arrays go into it as members
    (else tensors as lists), and a ``precond_fn`` into it as a program."""
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, torch.dtype):
        return {"__dtype__": str(x).split(".")[-1]}
    if isinstance(x, torch.Tensor):
        if out is not None:
            return {"__tensor_member__": out.tensor(x)}
        return {"__tensor__": x.detach().cpu().tolist(),
                "dtype": str(x.dtype).split(".")[-1]}
    if isinstance(x, (np.ndarray, np.generic)) and out is not None:
        return {"__array_member__": out.array(np.asarray(x))}
    if isinstance(x, tuple):
        return {"__tuple__": [_encode(v, f"{where}[{i}]", out)
                              for i, v in enumerate(x)]}
    if isinstance(x, list):
        return [_encode(v, f"{where}[{i}]", out) for i, v in enumerate(x)]
    if isinstance(x, dict):
        return {"__dict__": [[_encode(k, where), _encode(v, f"{where}.{k}",
                                                         out)]
                             for k, v in x.items()]}
    from ..ops.sparse import CSR
    if isinstance(x, CSR) and out is not None:
        return {"__csr__": [_encode(v, f"{where}.{k}", out) for k, v in (
            ("data", x.data), ("indices", x.indices), ("indptr", x.indptr),
            ("shape", list(x.shape)))]}
    cls = type(x)
    if dataclasses.is_dataclass(x) and cls.__module__.startswith(_PACKAGE):
        return {"__dataclass__": f"{cls.__module__}:{cls.__qualname__}",
                "fields": {f.name: _encode(getattr(x, f.name),
                                           f"{where}.{f.name}", out)
                           for f in dataclasses.fields(x) if f.init}}
    if callable(x):
        tag = getattr(x, _FACTORY, None)
        if tag is not None:
            path, args, kwargs = tag
            return {"__factory__": path,
                    "args": _encode(tuple(args), f"{where}(...)", out),
                    "kwargs": _encode(dict(kwargs), f"{where}(...)", out)}
        if out is not None and where.endswith(".precond_fn"):
            return out.precond(x)
        raise ValueError(
            f"export_solver cannot write {where} (a Python callable, "
            f"{getattr(x, '__name__', cls.__name__)}) into the artifact: "
            f"only data, a preconditioner made by the port's factories and "
            f"a precond_fn cross it")
    raise TypeError(f"export_solver cannot write {where} "
                    f"({cls.__name__}) into the artifact")


def _decode(x, store=None):
    if isinstance(x, list):
        return [_decode(v, store) for v in x]
    if not isinstance(x, dict):
        return x
    if "__dtype__" in x:
        return getattr(torch, x["__dtype__"])
    if "__tensor__" in x:
        return torch.tensor(x["__tensor__"], dtype=getattr(torch, x["dtype"]))
    if "__tensor_member__" in x:
        return store.tensor(x["__tensor_member__"])
    if "__array_member__" in x:
        return store.array(x["__array_member__"])
    if "__tuple__" in x:
        return tuple(_decode(v, store) for v in x["__tuple__"])
    if "__dict__" in x:
        return {_decode(k, store): _decode(v, store) for k, v in x["__dict__"]}
    if "__csr__" in x:
        from ..ops.sparse import CSR
        return CSR(*[_decode(v, store) for v in x["__csr__"]])
    if "__factory__" in x:
        return _port_attr(x["__factory__"])(*_decode(x["args"], store),
                                            **_decode(x["kwargs"], store))
    if "__precond__" in x:
        return _LoadedPrecond(store.function(x["__precond__"]),
                              x["wants_residual"])
    cls = _port_attr(x["__dataclass__"])
    return cls(**{k: _decode(v, store) for k, v in x["fields"].items()})


def _spec_data(spec) -> list:
    """A ``utils/pytree.py`` tree spec as data: tuples, lists and dicts of
    leaves (and None)."""
    if spec.kind in ("leaf", "none"):
        return [spec.kind]
    kids = [_spec_data(c) for c in spec.children]
    if spec.kind == "tuple" and spec.meta is tuple:
        return ["tuple", kids]
    if spec.kind == "list":
        return ["list", kids]
    if spec.kind == "dict":
        return ["dict", [_encode(k, "a key") for k in spec.meta], kids]
    raise TypeError(f"export_solver carries trees of tensors in tuples, "
                    f"lists and dicts, not a {spec.kind} node "
                    f"({spec.meta})")


def _spec_of(data):
    from .pytree import TreeSpec
    kind = data[0]
    if kind == "leaf":
        return TreeSpec("leaf")
    if kind == "none":
        return TreeSpec("none")
    if kind == "dict":
        return TreeSpec("dict", tuple(_decode(k) for k in data[1]),
                        tuple(_spec_of(c) for c in data[2]))
    return TreeSpec(kind, tuple if kind == "tuple" else None,
                    tuple(_spec_of(c) for c in data[1]))


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

class _OnLeaves(torch.nn.Module):
    """``fn`` of trees as a module of their leaves: each argument's leaves
    rebuilt into its tree (``specs``: (spec, number of leaves) an
    argument), ``fn``'s result flattened to its leaves (a ``CSR`` result
    to its data)."""

    def __init__(self, fn, specs):
        super().__init__()
        self.fn, self.specs = fn, specs

    def forward(self, *leaves):
        from ..ops.sparse import CSR
        from .pytree import tree_flatten, tree_unflatten
        trees, at = [], 0
        for spec, n in self.specs:
            trees.append(tree_unflatten(spec, leaves[at:at + n]))
            at += n
        out = self.fn(*trees)
        if isinstance(out, CSR):
            out = out.data
        return tuple(tree_flatten(out)[0])


def _batched_program(module, rows, name):
    """``vmap(module)`` over the leading dimension of every input as an
    exported program whose leading dimension ``name`` is symbolic (at
    least 2).  It is traced to plain ATen operations first (``make_fx``):
    exported directly, the vmap leaves functorch calls in the graph that
    ``torch.export.save`` refuses on some versions of torch."""
    from torch.fx.experimental.proxy_tensor import make_fx
    traced = make_fx(torch.func.vmap(module), tracing_mode="symbolic",
                     _allow_non_fake_inputs=True)(*rows)
    dim = torch.export.Dim(str(name), min=2)
    return torch.export.export(traced, rows,
                               dynamic_shapes=tuple({0: dim} for _ in rows))


def _as_tensors(tree, device):
    """``tree`` with every Python number as a 0-d float64 tensor on
    ``device`` (as a Python float is under x64)."""
    from .pytree import tree_map

    def one(v):
        if isinstance(v, torch.Tensor):
            return v
        if isinstance(v, (bool, int, float)):
            return torch.tensor(float(v), dtype=torch.float64, device=device)
        raise TypeError(f"export_solver takes a state and a p of tensors "
                        f"and numbers, not {type(v).__name__}")
    return tree_map(one, tree)


def _sub_solution(u, resid):
    """The initialization sub-solution as the maps see it in-process (the
    maps run only after a successful sub-solve)."""
    from ..core.returncode import ReturnCode
    from ..core.solution import NonlinearSolution
    return NonlinearSolution(u=u, resid=resid, retcode=ReturnCode.Success)


class _Archive:
    """What ``export_solver`` writes beside ``meta.json``: programs, tensors
    and arrays, nested archives.  ``state``: the engines' state, right-hand
    side and residual at the template (a ``precond_fn`` is traced on
    them); ``batch``: the symbolic batch's name or None."""

    def __init__(self, batch):
        self.batch = batch
        self.members: dict = {}
        self.programs: dict = {}
        self.state = None

    def tensor(self, x) -> str:
        name = f"data/{len(self.members)}.pt"
        buf = io.BytesIO()
        torch.save(x.detach().cpu(), buf)
        self.members[name] = buf.getvalue()
        return name

    def array(self, x) -> str:
        name = f"data/{len(self.members)}.npy"
        buf = io.BytesIO()
        np.save(buf, x, allow_pickle=False)
        self.members[name] = buf.getvalue()
        return name

    def function(self, name, fn, trees, batched=False):
        """``fn(*trees)`` as the program ``name`` of the trees' leaves (and,
        ``batched``, its row-batched program); returns the entry the loader
        rebuilds it from, and the result at the template."""
        from ..ops.sparse import CSR
        from .pytree import tree_flatten
        flat = [tree_flatten(t) for t in trees]
        # one tensor given as two arguments (a jvp's v and u at the
        # template) is copied: the trace would take them as one input
        seen: set = set()
        leaves = []
        for v in (v for ls, _ in flat for v in ls):
            leaves.append(v.clone() if id(v) in seen else v)
            seen.add(id(v))
        leaves = tuple(leaves)
        with torch.no_grad():
            # caches the callable fills (constants of a model) get real
            # tensors before the trace, which takes them as constants
            result = fn(*trees)
        entry = {"program": name, "batched": bool(batched),
                 "in": [[_spec_data(s), len(ls)] for ls, s in flat],
                 "csr": None}
        data = result
        if isinstance(result, CSR):
            entry["csr"] = [_encode(v, f"{name}'s pattern", self)
                            for v in (result.indices, result.indptr,
                                      list(result.shape))]
            data = result.data
        entry["out"] = _spec_data(tree_flatten(data)[1])
        module = _OnLeaves(fn, [(s, len(ls)) for ls, s in flat])
        with torch.no_grad():
            self.programs[f"{name}.pt2"] = torch.export.export(module, leaves)
            if batched:
                rows = tuple(torch.stack([v, v]) for v in leaves)
                self.programs[f"{name}_batched.pt2"] = _batched_program(
                    module, rows, self.batch)
        return entry, result

    def precond(self, fn) -> dict:
        """A user's ``precond_fn`` as the program ``M(u, v)`` (``M(u, fu,
        v)`` for a ``wants_residual`` one), traced on the engines' state:
        a factory ``u -> (v -> M⁻¹v)`` is applied as made at ``u``, a plain
        ``v -> M⁻¹v`` (whose call on ``u`` gives a tensor) as itself."""
        u, rhs, fu = self.state
        if getattr(fn, "wants_residual", False):
            def apply(u, fu, v):
                return fn(u, fu)(v)
            trees, wants = (u, fu, rhs), True
        else:
            made = fn(u)

            def apply(u, v):
                return fn(u)(v) if callable(made) else fn(v)
            trees, wants = (u, rhs), False
        name = f"precond_{sum(k.startswith('precond') for k in self.programs)}"
        entry, _ = self.function(name, apply, trees)
        return {"__precond__": entry, "wants_residual": wants}

    def write(self, meta) -> bytes:
        out = io.BytesIO()
        with zipfile.ZipFile(out, "w") as z:
            for name, program in self.programs.items():
                buf = io.BytesIO()
                torch.export.save(program, buf)
                z.writestr(name, buf.getvalue())
            for name, data in self.members.items():
                z.writestr(name, data)
            z.writestr("meta.json", json.dumps(meta))
        return out.getvalue()


def export_solver(prob, alg=None, *, platforms=None, batch=None,
                  **solve_kwargs) -> bytes:
    """Export ``solve(prob.remake(u0=u0, p=p), alg, **solve_kwargs)`` as
    bytes.

    ``prob``: the template ``NonlinearProblem`` (or least-squares
    problem); its ``u0`` (a tensor, or a tuple / list / dict of them) and
    ``p`` (None, a number, a tensor or a tuple / list / dict of them) fix
    the input shapes and dtypes.  Its function, bounds and
    initialization cross as the module docstring says.  ``alg``: None is
    the default polyalgorithm, as in ``solve``.  ``platforms``: the device
    types the artifact may run on ("cuda", "cpu"); by default the
    template's.  ``batch``: the name of a symbolic batch dimension: every
    callable also crosses row-batched, every input gains a leading axis
    of that size (at least 2 in the programs; a batch of one is padded),
    and the loaded callable runs ``solve_ensemble``.  ``solve_kwargs``:
    the frozen solve options (abstol, maxiters, ...); trace options are
    refused: only ``u``, ``resid``, ``retcode`` and the stats come back.
    The calling convention is ``f(u0)`` when the template's ``p`` is
    None, else ``f(u0, p)``."""
    from ..core.problems import NonlinearLeastSquaresProblem
    from ..core.solve import FlatMap, state_device, takes_flat_path
    from .pytree import ravel_pytree, tree_leaves

    bad = sorted(k for k in _TRACE_OPTIONS if solve_kwargs.get(k))
    if bad:
        raise ValueError(
            f"export_solver does not support trace options {bad}: the "
            "exported artifact serializes only u/resid/retcode/stats, so "
            "the trace would be computed and silently dropped")
    f = prob.f
    if not any(isinstance(v, torch.Tensor) for v in tree_leaves(prob.u0)):
        raise TypeError("export_solver takes a template whose u0 is a "
                        "tensor or a tree of tensors")
    dev = state_device(prob.u0, prob.p)
    platforms = tuple(platforms or (dev.type,))
    unknown = [q for q in platforms if q not in _PLATFORMS]
    if unknown:
        raise ValueError(f"unknown platforms {unknown}: the artifact runs "
                         f"on {list(_PLATFORMS)}")
    has_p = prob.p is not None
    u0 = _as_tensors(prob.u0, dev)
    p = _as_tensors(prob.p, dev) if has_p else None
    lsq = isinstance(prob, NonlinearLeastSquaresProblem)
    out = _Archive(batch)
    batched = batch is not None
    functions = {}
    functions["f"], fu0 = out.function("residual", f.f, (u0, p), batched)
    args = {"jac": (u0, p), "jvp": (u0, u0, p), "vjp": (fu0, u0, p)}
    for name in _FUNCTIONS:
        if getattr(f, name) is not None:
            functions[name], _ = out.function(name, getattr(f, name),
                                              args[name], batched)
    for name in _FUNCTION_DATA:
        functions[name] = _encode(getattr(f, name), f"f.{name}", out)
    if f.initialization_data is not None:
        functions["initialization_data"] = _export_initialization(
            f.initialization_data, p, platforms, out, dev)
    # the state the engines see (core/solve.py's decision and map): a
    # precond_fn is traced on it
    if takes_flat_path(prob, alg):
        fmap = FlatMap(u0, dev)
        u_state, fu_state = fmap.u0_flat, ravel_pytree(fu0, device=dev)[0]
    else:
        u_state, fu_state = u0, fu0
    out.state = (u_state, u_state if lsq else fu_state, fu_state)
    options = {**prob.kwargs, **solve_kwargs}
    meta = {"kind": "least_squares" if lsq else "nonlinear",
            "has_p": has_p, "batch": batch,
            "platforms": list(platforms), "device": dev.type,
            "function": functions,
            "lb": _encode(prob.lb, "lb", out),
            "ub": _encode(prob.ub, "ub", out),
            "alg": _encode(alg, "alg", out),
            "options": _encode(options, "the options", out)}
    return out.write(meta)


def _export_initialization(data, p, platforms, out, dev) -> dict:
    """``initialization_data``: the sub-problem as a nested archive (with
    its algorithm and tolerance), its state and parameters as data, the
    maps as programs of the sub-solution's ``u`` and ``resid``."""
    sub = data.initializeprob
    kwargs = {} if data.abstol is None else {"abstol": data.abstol}
    out.members["init.bin"] = export_solver(sub, data.alg,
                                            platforms=platforms, **kwargs)
    sub_u0 = _as_tensors(sub.u0, dev)
    sub_p = None if sub.p is None else _as_tensors(sub.p, dev)
    with torch.no_grad():
        sub_resid = sub.f.f(sub_u0, sub_p)
    entry = {"u0": _encode(sub.u0, "initializeprob.u0", out),
             "p": _encode(sub.p, "initializeprob.p", out)}
    if data.initializeprobmap is not None:
        fn = data.initializeprobmap
        entry["map"], _ = out.function(
            "init_map", lambda u, r: fn(_sub_solution(u, r)),
            (sub_u0, sub_resid))
    if data.initializeprobpmap is not None:
        fn = data.initializeprobpmap
        entry["pmap"], _ = out.function(
            "init_pmap", lambda u, r, q: fn(_sub_solution(u, r), q),
            (sub_u0, sub_resid, p))
    return entry


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------

class _Store:
    """The loaded archive: programs by name (each moved to the device it is
    called on, once a device), tensors (on the device type they were
    exported from, where this process has one, else the CPU) and arrays,
    nested archives."""

    def __init__(self, z: zipfile.ZipFile, device_type: str):
        names = z.namelist()
        self.programs = {n: torch.export.load(io.BytesIO(z.read(n)))
                         for n in names if n.endswith(".pt2")}
        self.members = {n: z.read(n) for n in names
                        if n.startswith("data/") or n.endswith(".bin")}
        self._device = device_type
        self._tensors_on = torch.device(
            device_type if device_type == "cpu" or torch.cuda.is_available()
            else "cpu")
        self._modules: dict = {}

    def module(self, name: str, device: torch.device):
        key = (name, str(device))
        if key not in self._modules:
            program = self.programs[name]
            if device.type != self._device:
                from torch.export.passes import move_to_device_pass
                program = move_to_device_pass(program, device)
            self._modules[key] = program.module()
        return self._modules[key]

    def tensor(self, name):
        return torch.load(io.BytesIO(self.members[name]), weights_only=True,
                          map_location=self._tensors_on)

    def array(self, name):
        return np.load(io.BytesIO(self.members[name]), allow_pickle=False)

    def function(self, entry):
        return _LoadedFn(self, entry)


def _first_device(trees):
    from .pytree import tree_leaves
    for t in trees:
        for v in tree_leaves(t):
            if isinstance(v, torch.Tensor):
                return v.device
    return torch.device("cpu")


class _LoadedFn:
    """A callable rebuilt from its program: the template's trees in, its
    result's tree (or a ``CSR`` on the stored pattern) out; ``batched``
    (from a batched artifact) the same of a whole batch, whose programs
    take at least 2 rows (a batch of one is padded)."""

    def __init__(self, store: _Store, entry: dict):
        self.store = store
        self.name = entry["program"]
        self.out = _spec_of(entry["out"])
        self.csr = (None if entry["csr"] is None
                    else [_decode(v, store) for v in entry["csr"]])
        self.batched = self._batch if entry["batched"] else None

    def module(self, name: str, device: torch.device):
        return self.store.module(name, device)

    def _run(self, name, trees):
        from .pytree import tree_flatten, tree_unflatten
        leaves = [v for t in trees for v in tree_flatten(t)[0]]
        out = self.module(name, _first_device(trees))(*leaves)
        out = tree_unflatten(self.out, out)
        if self.csr is None:
            return out
        from ..ops.sparse import CSR
        return CSR(out, *self.csr)

    def __call__(self, *trees):
        return self._run(f"{self.name}.pt2", trees)

    def _batch(self, *trees):
        from .pytree import tree_leaves, tree_map
        name = f"{self.name}_batched.pt2"
        if tree_leaves(trees)[0].shape[0] >= 2:
            return self._run(name, trees)
        pad = lambda v: torch.cat([v, v])               # noqa: E731
        return tree_map(lambda v: v[:1],
                        self._run(name, tree_map(pad, trees)))


class _LoadedPrecond:
    """A user's ``precond_fn`` rebuilt from its program ``M(u, v)`` (``M(u,
    fu, v)``): called on the state (and residual) as the engines call it,
    it returns ``v -> M⁻¹v``."""

    def __init__(self, program: _LoadedFn, wants_residual: bool):
        self.program = program
        self.wants_residual = wants_residual

    def __call__(self, u, fu=None):
        if self.wants_residual:
            return lambda v: self.program(u, fu, v)
        return lambda v: self.program(u, v)


def _to_device(tree, device):
    from .pytree import tree_map
    if tree is None or isinstance(tree, (bool, int, float)):
        return tree
    return tree_map(lambda v: v.to(device) if isinstance(v, torch.Tensor)
                    else v, tree)


class _Loaded:
    """An archive rebuilt: its problem kind, function (one a device),
    algorithm, options and bounds."""

    def __init__(self, data: bytes):
        from ..core.problems import (NonlinearLeastSquaresProblem,
                                     NonlinearProblem)
        with zipfile.ZipFile(io.BytesIO(bytes(data))) as z:
            self.meta = json.loads(z.read("meta.json"))
            self.store = _Store(z, self.meta["device"])
        meta, store = self.meta, self.store
        self.kind = (NonlinearLeastSquaresProblem
                     if meta["kind"] == "least_squares" else NonlinearProblem)
        self.alg = _decode(meta["alg"], store)
        self.options = _decode(meta["options"], store)
        self.bounds = (_decode(meta["lb"], store), _decode(meta["ub"], store))
        fns = meta["function"]
        self.residual = store.function(fns["f"])
        self.callables = {k: store.function(fns[k]) for k in _FUNCTIONS
                          if k in fns}
        self.data = {k: _decode(fns[k], store) for k in _FUNCTION_DATA}
        self.init = fns.get("initialization_data")
        self._functions: dict = {}

    def function(self, device: torch.device):
        """The ``NonlinearFunction``, built once a device (the sparse plan
        is cached on it)."""
        key = str(device)
        if key not in self._functions:
            from ..core.problems import NonlinearFunction
            self._functions[key] = NonlinearFunction(
                f=self.residual, **self.callables, **self.data,
                initialization_data=self._initialization(device))
        return self._functions[key]

    def _initialization(self, device):
        if self.init is None:
            return None
        from ..core.initialization import InitializationData
        sub = _Loaded(self.store.members["init.bin"])
        entry, store = self.init, self.store
        u0 = _to_device(_decode(entry["u0"], store), device)
        p = _to_device(_decode(entry["p"], store), device)
        maps = {}
        if "map" in entry:
            umap = store.function(entry["map"])
            maps["initializeprobmap"] = lambda sol: umap(sol.u, sol.resid)
        if "pmap" in entry:
            pmap = store.function(entry["pmap"])
            maps["initializeprobpmap"] = lambda sol, q: pmap(sol.u,
                                                             sol.resid, q)
        return InitializationData(
            initializeprob=sub.kind(sub.function(device), u0, p,
                                    lb=_to_device(sub.bounds[0], device),
                                    ub=_to_device(sub.bounds[1], device),
                                    **sub.options),
            alg=sub.alg, **maps)


def deserialize_solver(data: bytes):
    """Rebuild a solver from :func:`export_solver` bytes.  The callable
    takes ``(u0)`` or ``(u0, p)`` as the artifact was exported (a number in
    ``p`` becomes a float64 tensor) and returns a ``NonlinearSolution``;
    with ``batch=``, ``(u0s[, ps])`` with a leading batch axis, solved by
    ``solve_ensemble``.  The inputs' device must be one of the artifact's
    platforms.  ``call.exported`` is the loaded ``ExportedProgram`` of the
    residual, ``call.residual`` the loaded residual; later calls reuse
    them."""
    from .pytree import tree_leaves, tree_map
    loaded = _Loaded(data)
    meta = loaded.meta

    def call(u0, p=None):
        if not any(isinstance(v, torch.Tensor) for v in tree_leaves(u0)):
            raise TypeError("the loaded solver takes u0 as a tensor or a "
                            "tree of tensors")
        device = _first_device((u0,))
        if device.type not in meta["platforms"]:
            raise ValueError(
                f"this artifact runs on {meta['platforms']}, not on "
                f"{device.type}")
        u0 = _as_tensors(u0, device)
        if meta["has_p"]:
            if p is None:
                raise TypeError("the artifact was exported with a p: call "
                                "it as f(u0, p)")
            p = _as_tensors(p, device)
        elif p is not None:
            raise TypeError("the artifact was exported with p None: call "
                            "it as f(u0)")
        fn = loaded.function(device)
        lb, ub = (_to_device(b, device) for b in loaded.bounds)
        if meta["batch"] is None:
            from ..core.solve import solve
            return solve(loaded.kind(fn, u0, p, lb=lb, ub=ub), loaded.alg,
                         **loaded.options)
        from ..core.ensemble import solve_ensemble
        row0 = lambda t: tree_map(lambda v: v[0], t)    # noqa: E731
        template = loaded.kind(fn, row0(u0), None if p is None else row0(p),
                               lb=lb, ub=ub)
        return solve_ensemble(template, loaded.alg, u0s=u0, ps=p,
                              **loaded.options)

    call.exported = loaded.store.programs["residual.pt2"]
    call.residual = loaded.residual
    return call
