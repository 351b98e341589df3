"""Ahead-of-time export and loading of solvers (the port of
``utils/aot.py``) through ``torch.export``.

The JAX package lowers the whole jitted solve to one StableHLO artifact.
The port's solve is a host loop over device tensors, so what crosses the
boundary is the problem's residual: ``export_solver`` exports ``f(u, p)``
at the template's shapes and dtypes with ``torch.export`` (with
``batch=``, the row-batched residual, whose leading dimension is
symbolic), and writes the program into one bytes blob together with the
algorithm and the frozen solve options, as data.  ``deserialize_solver``
rebuilds the residual from the program alone, without the user's Python
function, and returns a callable that runs the port's ``solve`` (with
``batch=``, ``solve_ensemble``: the lockstep route) and gives a
``NonlinearSolution``.

The blob is a zip archive: ``residual.pt2`` (``torch.export.save``;
with ``batch=``, ``residual_batched.pt2`` beside it) and ``meta.json`` (the problem's kind and calling convention, the platforms,
the algorithm and the options, each dataclass of the port written as its
class's name and its fields).  An algorithm or option that holds a Python
callable cannot be written as data and is refused.
"""

from __future__ import annotations

import dataclasses
import importlib
import io
import json
import zipfile

import torch

_PACKAGE = __name__.split(".")[0]
_PLATFORMS = ("cuda", "cpu")
_TRACE_OPTIONS = ("store_trace", "show_trace", "trace_level")


# ---------------------------------------------------------------------------
# algorithms and options as data
# ---------------------------------------------------------------------------

def _encode(x, where: str):
    """``x`` as JSON data: numbers, strings, None, tuples, lists, dicts,
    tensors, dtypes and the port's dataclasses."""
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, torch.dtype):
        return {"__dtype__": str(x).split(".")[-1]}
    if isinstance(x, torch.Tensor):
        return {"__tensor__": x.detach().cpu().tolist(),
                "dtype": str(x.dtype).split(".")[-1]}
    if isinstance(x, tuple):
        return {"__tuple__": [_encode(v, where) for v in x]}
    if isinstance(x, list):
        return [_encode(v, where) for v in x]
    if isinstance(x, dict):
        return {"__dict__": [[_encode(k, where), _encode(v, where)]
                             for k, v in x.items()]}
    cls = type(x)
    if dataclasses.is_dataclass(x) and cls.__module__.startswith(_PACKAGE):
        return {"__dataclass__": f"{cls.__module__}:{cls.__qualname__}",
                "fields": {f.name: _encode(getattr(x, f.name),
                                           f"{where}.{f.name}")
                           for f in dataclasses.fields(x) if f.init}}
    if callable(x):
        raise ValueError(
            f"export_solver cannot write {where} (a Python callable, "
            f"{getattr(x, '__name__', cls.__name__)}) into the artifact: "
            f"only data crosses it; build the algorithm without it")
    raise TypeError(f"export_solver cannot write {where} "
                    f"({cls.__name__}) into the artifact")


def _decode(x):
    if isinstance(x, list):
        return [_decode(v) for v in x]
    if not isinstance(x, dict):
        return x
    if "__dtype__" in x:
        return getattr(torch, x["__dtype__"])
    if "__tensor__" in x:
        return torch.tensor(x["__tensor__"], dtype=getattr(torch, x["dtype"]))
    if "__tuple__" in x:
        return tuple(_decode(v) for v in x["__tuple__"])
    if "__dict__" in x:
        return {_decode(k): _decode(v) for k, v in x["__dict__"]}
    module, qualname = x["__dataclass__"].split(":")
    if module.split(".")[0] != _PACKAGE:
        raise ValueError(f"the artifact names a class outside the port: "
                         f"{module}")
    cls = importlib.import_module(module)
    for part in qualname.split("."):
        cls = getattr(cls, part)
    return cls(**{k: _decode(v) for k, v in x["fields"].items()})


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

class _Residual(torch.nn.Module):
    """``f(u, p)`` as a module for ``torch.export``."""

    def __init__(self, f):
        super().__init__()
        self.f = f

    def forward(self, u, p=None):
        return self.f(u, p)


def _batched_program(f, rows, has_p, name):
    """The row-batched residual ``vmap(f)`` as an exported program with a
    symbolic leading dimension ``name`` (at least 2).  It is traced to
    plain ATen operations first (``make_fx``): exported directly, the
    vmap leaves functorch calls in the graph that ``torch.export.save``
    refuses on some versions of torch."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from .pytree import tree_map
    vf = (torch.func.vmap(f) if has_p
          else torch.func.vmap(lambda u: f(u, None)))
    traced = make_fx(vf, tracing_mode="symbolic",
                     _allow_non_fake_inputs=True)(*rows)
    dim = torch.export.Dim(str(name), min=2)
    return torch.export.export(
        traced, rows, dynamic_shapes=tree_map(lambda v: {0: dim}, rows))


def _as_tensors(p, like):
    """``p`` with every Python number as a 0-d float64 tensor on ``like``'s
    device (as a Python float is under x64)."""
    from .pytree import tree_map

    def one(v):
        if isinstance(v, torch.Tensor):
            return v
        if isinstance(v, (bool, int, float)):
            return torch.tensor(float(v), dtype=torch.float64,
                                device=like.device)
        raise TypeError(f"export_solver takes a p of tensors and numbers, "
                        f"not {type(v).__name__}")
    return tree_map(one, p)


def export_solver(prob, alg=None, *, platforms=None, batch=None,
                  **solve_kwargs) -> bytes:
    """Export ``solve(prob.remake(u0=u0, p=p), alg, **solve_kwargs)`` as
    bytes.

    ``prob``: the template ``NonlinearProblem`` (or least-squares
    problem); its ``u0`` (a tensor) and ``p`` (None, a number, a tensor or
    a tuple / list / dict of them) fix the input shapes and dtypes.  Its
    function must be the residual alone (no analytic ``jac`` / ``jvp`` /
    ``vjp``, no sparsity pattern, no initialization) and it has no
    bounds.  ``alg``: None is the default polyalgorithm, as in ``solve``.
    ``platforms``: the device types the artifact may run on ("cuda",
    "cpu"); by default the template's.  ``batch``: the name of a symbolic
    batch dimension: the row-batched residual is exported, every input
    gains a leading axis of that size (at least 2 in the program; a batch
    of one is padded), and the loaded callable runs ``solve_ensemble``.
    ``solve_kwargs``: the frozen solve options (abstol, maxiters, ...);
    trace options are refused: only ``u``, ``resid``, ``retcode`` and the
    stats come back.  The calling convention is ``f(u0)`` when the
    template's ``p`` is None, else ``f(u0, p)``."""
    from ..core.problems import NonlinearLeastSquaresProblem

    bad = sorted(k for k in _TRACE_OPTIONS if solve_kwargs.get(k))
    if bad:
        raise ValueError(
            f"export_solver does not support trace options {bad}: the "
            "exported artifact serializes only u/resid/retcode/stats, so "
            "the trace would be computed and silently dropped")
    f, u0 = prob.f, prob.u0
    if not isinstance(u0, torch.Tensor):
        raise TypeError("export_solver takes a template whose u0 is one "
                        "tensor")
    extra = [k for k in ("jac", "jvp", "vjp", "jac_prototype", "sparsity",
                         "colorvec", "initialization_data")
             if getattr(f, k) is not None]
    if extra or prob.lb is not None or prob.ub is not None:
        raise ValueError(
            f"export_solver exports the residual alone: the template "
            f"carries {extra or ['bounds']}, which the artifact would drop")
    platforms = tuple(platforms or (u0.device.type,))
    unknown = [q for q in platforms if q not in _PLATFORMS]
    if unknown:
        raise ValueError(f"unknown platforms {unknown}: the artifact runs "
                         f"on {list(_PLATFORMS)}")
    options = {**prob.kwargs, **solve_kwargs}
    meta = {"kind": ("least_squares"
                     if isinstance(prob, NonlinearLeastSquaresProblem)
                     else "nonlinear"),
            "has_p": prob.p is not None, "batch": batch,
            "platforms": list(platforms),
            "device": u0.device.type,
            "alg": _encode(alg, "alg"),
            "options": _encode(options, "the options")}
    has_p = prob.p is not None
    args = (u0,) + ((_as_tensors(prob.p, u0),) if has_p else ())
    programs = {}
    with torch.no_grad():
        # caches the residual fills (constants of the model) get real
        # tensors before the trace, which takes them as constants
        f.f(*args) if has_p else f.f(u0, None)
        programs["residual.pt2"] = torch.export.export(_Residual(f.f),
                                                       args)
        if batch is not None:
            from .pytree import tree_map
            rows = tree_map(lambda v: torch.stack([v, v]), args)
            programs["residual_batched.pt2"] = _batched_program(
                f.f, rows, has_p, batch)
    out = io.BytesIO()
    with zipfile.ZipFile(out, "w") as z:
        for name, program in programs.items():
            buf = io.BytesIO()
            torch.export.save(program, buf)
            z.writestr(name, buf.getvalue())
        z.writestr("meta.json", json.dumps(meta))
    return out.getvalue()


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------

class _LoadedResidual:
    """The residual rebuilt from the programs: ``f(u, p)`` of one state
    (the row program) and, from a batched artifact, ``batched(U, P)`` of
    a whole batch (the batched program, whose batch is at least 2: a
    batch of one is padded).  A program moves to the device it is called
    on, once a device."""

    def __init__(self, programs: dict, meta):
        self.programs = programs
        self.has_p = meta["has_p"]
        self.batched = (self._batch if "residual_batched.pt2" in programs
                        else None)
        self._device = meta["device"]
        self._modules = {}

    def module(self, name: str, device: torch.device):
        key = (name, str(device))
        if key not in self._modules:
            program = self.programs[name]
            if device.type != self._device:
                from torch.export.passes import move_to_device_pass
                program = move_to_device_pass(program, device)
            self._modules[key] = program.module()
        return self._modules[key]

    def _call(self, name, u, p):
        args = (u,) + ((p,) if self.has_p else ())
        return self.module(name, u.device)(*args)

    def __call__(self, u, p=None):
        return self._call("residual.pt2", u, p)

    def _batch(self, U, P):
        if U.shape[0] >= 2:
            return self._call("residual_batched.pt2", U, P)
        from .pytree import tree_map
        pad = lambda v: torch.cat([v, v])               # noqa: E731
        return self._call("residual_batched.pt2", pad(U),
                          tree_map(pad, P))[:1]


def deserialize_solver(data: bytes):
    """Rebuild a solver from :func:`export_solver` bytes.  The callable
    takes ``(u0)`` or ``(u0, p)`` as the artifact was exported (a number
    ``p`` becomes a float64 tensor) and returns a ``NonlinearSolution``;
    with ``batch=``, ``(u0s[, ps])`` with a leading batch axis, solved by
    ``solve_ensemble``.  The inputs' device must be one of the artifact's
    platforms.  ``call.exported`` is the loaded ``ExportedProgram`` of the
    residual; later calls reuse it."""
    from ..core.problems import (NonlinearFunction,
                                 NonlinearLeastSquaresProblem,
                                 NonlinearProblem)

    with zipfile.ZipFile(io.BytesIO(bytes(data))) as z:
        meta = json.loads(z.read("meta.json"))
        programs = {name: torch.export.load(io.BytesIO(z.read(name)))
                    for name in z.namelist() if name.endswith(".pt2")}
    alg = _decode(meta["alg"])
    options = _decode(meta["options"])
    residual = _LoadedResidual(programs, meta)
    fn = NonlinearFunction(f=residual)
    kind = (NonlinearLeastSquaresProblem if meta["kind"] == "least_squares"
            else NonlinearProblem)

    def call(u0, p=None):
        if not isinstance(u0, torch.Tensor):
            raise TypeError("the loaded solver takes u0 as a tensor")
        if u0.device.type not in meta["platforms"]:
            raise ValueError(
                f"this artifact runs on {meta['platforms']}, not on "
                f"{u0.device.type}")
        if meta["has_p"]:
            if p is None:
                raise TypeError("the artifact was exported with a p: call "
                                "it as f(u0, p)")
            p = _as_tensors(p, u0)
        elif p is not None:
            raise TypeError("the artifact was exported with p None: call "
                            "it as f(u0)")
        if meta["batch"] is None:
            from ..core.solve import solve
            return solve(kind(fn, u0, p), alg, **options)
        from ..core.ensemble import solve_ensemble
        template = kind(fn, u0[0], None if p is None else
                        _row0(p))
        return solve_ensemble(template, alg, u0s=u0, ps=p, **options)

    call.exported = programs["residual.pt2"]
    call.residual = residual
    return call


def _row0(p):
    from .pytree import tree_map
    return tree_map(lambda v: v[0], p)
