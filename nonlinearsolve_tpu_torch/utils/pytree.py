"""Pytree helpers (the port of ``utils/pytree.py``, with the flattening of
``jax.flatten_util.ravel_pytree`` that the JAX package's flat path takes).

A pytree here is a tensor, a Python number, a numpy array or scalar, or a
tuple, list, dict or dataclass of pytrees; ``None`` is a node with no
leaves.  The leaf order is JAX's: tuples, lists and dataclass fields in
order, dicts by sorted key (``torch.utils._pytree`` keeps insertion
order, which would permute the Jacobian's columns).

``ravel_pytree`` promotes the leaves to one dtype as JAX's does, a Python
number counting as its default dtype under x64 (float64, int64,
complex128: a float beside an f32 tensor makes the vector f64).  The flat
vector lies on the device of the first tensor leaf (else ``device``);
``unravel`` gives every leaf back its shape and dtype, a Python number as
a 0-d tensor of that default dtype.

``static_config`` and ``pytree_dataclass`` are the JAX module's two
dataclass decorators: a frozen, hashable configuration and a frozen state
record, both with ``.replace``.  A dataclass instance is a node of the
flattening, its fields its children.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, TypeVar

import numpy as np
import torch

T = TypeVar("T")


def static_config(cls: type[T]) -> type[T]:
    """Frozen, hashable dataclass used as configuration."""
    cls = dataclasses.dataclass(frozen=True, eq=True)(cls)
    cls.replace = lambda self, **kw: dataclasses.replace(self, **kw)
    return cls


def pytree_dataclass(cls: type[T]) -> type[T]:
    """Frozen dataclass whose fields are the children of a pytree node."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **kw: dataclasses.replace(self, **kw)
    return cls


# ---------------------------------------------------------------------------
# flatten / unflatten
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TreeSpec:
    """The structure of a pytree: ``kind`` ('leaf', 'none', 'tuple',
    'list', 'dict', 'dataclass'), the node's keys (dict keys, sorted;
    dataclass field names) or type, and the children's specs."""

    kind: str
    meta: Any = None
    children: tuple = ()


_LEAF = TreeSpec("leaf")


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic, bool, int,
                          float, complex))


def tree_flatten(tree) -> tuple[list, TreeSpec]:
    """``(leaves, spec)`` in JAX's leaf order."""
    leaves: list = []

    def go(x):
        if _is_leaf(x):
            leaves.append(x)
            return _LEAF
        if x is None:
            return TreeSpec("none")
        if isinstance(x, dict):
            keys = tuple(sorted(x))
            return TreeSpec("dict", keys, tuple(go(x[k]) for k in keys))
        if isinstance(x, tuple):
            return TreeSpec("tuple", type(x), tuple(go(v) for v in x))
        if isinstance(x, list):
            return TreeSpec("list", None, tuple(go(v) for v in x))
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            names = tuple(f.name for f in dataclasses.fields(x))
            return TreeSpec("dataclass", (type(x), names),
                            tuple(go(getattr(x, n)) for n in names))
        raise TypeError(f"{type(x).__name__} is not a pytree node or leaf")

    spec = go(tree)
    return leaves, spec


def tree_unflatten(spec: TreeSpec, leaves) -> Any:
    """The pytree of ``spec`` with ``leaves`` in order."""
    it = iter(leaves)

    def go(s):
        if s.kind == "leaf":
            return next(it)
        if s.kind == "none":
            return None
        kids = [go(c) for c in s.children]
        if s.kind == "dict":
            return dict(zip(s.meta, kids))
        if s.kind == "tuple":
            return (s.meta(*kids) if hasattr(s.meta, "_fields")
                    else s.meta(kids))
        if s.kind == "list":
            return kids
        cls, names = s.meta
        return cls(**dict(zip(names, kids)))

    return go(spec)


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest) -> Any:
    leaves, spec = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(spec, [fn(x, *ys) for x, *ys
                                 in zip(leaves, *others)])


def tree_add(a, b):
    return tree_map(lambda x, y: x + y, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


# ---------------------------------------------------------------------------
# ravel_pytree
# ---------------------------------------------------------------------------

_DEFAULT_OF = {bool: torch.bool, int: torch.int64, float: torch.float64,
               complex: torch.complex128}


def _as_tensor_leaf(x) -> torch.Tensor:
    """A leaf as a tensor: numpy values in their dtype, Python numbers in
    their type's default dtype (as under x64)."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (np.ndarray, np.generic)):
        return torch.as_tensor(np.asarray(x))
    return torch.tensor(x, dtype=_DEFAULT_OF[type(x)])


def _leaf_device(leaves, device):
    for x in leaves:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu") if device is None else torch.device(device)


def ravel_pytree(tree, device=None):
    """``(flat, unravel)``: the leaves raveled in JAX's order into one 1-d
    tensor of their promoted dtype (a Python number counts as its default
    dtype), and the inverse map."""
    leaves, spec = tree_flatten(tree)
    dev = _leaf_device(leaves, device)
    ts = [_as_tensor_leaf(x) for x in leaves]
    dtype = torch.float64
    for i, t in enumerate(ts):
        dtype = t.dtype if i == 0 else torch.promote_types(dtype, t.dtype)
    metas = [(tuple(t.shape), t.dtype, t.numel()) for t in ts]
    parts = [t.reshape(-1).to(device=dev, dtype=dtype) for t in ts]
    if len(parts) == 1:
        flat = parts[0]
    else:
        flat = (torch.cat(parts) if parts
                else torch.zeros((0,), dtype=dtype, device=dev))

    def unravel(vec):
        out, at = [], 0
        for shape, dt, size in metas:
            piece = vec[at:at + size].reshape(shape)
            if piece.dtype != dt:
                piece = (piece.real if piece.is_complex() and not dt.is_complex
                         else piece).to(dt)
            out.append(piece)
            at += size
        return tree_unflatten(spec, out)

    return flat, unravel
