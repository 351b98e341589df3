"""Structured, toggleable messages (the port of ``core/verbosity.py``).

The message-class matrix grouped into error_control / numerical /
sensitivity, group-level control, a nested ``linear_verbosity``
sub-specifier and the presets none / minimal / standard / detailed / all,
as in the JAX package, with its message texts.  ``emit`` prints to stderr
at host sites; ``traced_emit`` (the engines' sites, the JAX package's
``jax.debug.print``) prints to stdout when its class is on and its
condition holds: it reads the device only then, so an off class costs
nothing.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any

# the message-class matrix
_GROUPS = {
    "error_control": ("non_enclosing_interval", "alias_u0_immutable",
                      "linsolve_failed_noncurrent", "termination_condition",
                      "unsupported_postcondition", "dropped_extension_kwarg"),
    "numerical": ("threshold_state", "forcing"),
    "sensitivity": ("sensitivity_vjp_choice",),
}
_CLASSES = tuple(c for grp in _GROUPS.values() for c in grp)

_PRESETS = {
    "none": frozenset(),
    "minimal": frozenset({"non_enclosing_interval",
                          "linsolve_failed_noncurrent",
                          "dropped_extension_kwarg"}),
    "standard": frozenset({"non_enclosing_interval",
                           "linsolve_failed_noncurrent",
                           "termination_condition",
                           "unsupported_postcondition",
                           "dropped_extension_kwarg"}),
    "detailed": frozenset(set(_CLASSES) - {"forcing"}),
    "all": frozenset(_CLASSES),
}

# nested linear-solver message classes (ops/linear_solve, the Krylov
# route of core/descent)
_LINEAR_CLASSES = ("rank_deficient_fallback", "krylov_breakdown",
                   "krylov_unconverged", "precond_unavailable")
_LINEAR_PRESETS = {
    "none": frozenset(),
    "minimal": frozenset({"rank_deficient_fallback"}),
    "standard": frozenset({"rank_deficient_fallback", "krylov_unconverged",
                           "precond_unavailable"}),
    "detailed": frozenset(_LINEAR_CLASSES),
    "all": frozenset(_LINEAR_CLASSES),
}


@dataclasses.dataclass(frozen=True)
class LinearVerbosity:
    """Nested linear-solver verbosity (the linear sub-specifier of
    ``NonlinearVerbosity``)."""

    preset: str = "none"
    overrides: Any = ()

    def __init__(self, preset="none", **class_toggles):
        if isinstance(preset, bool):
            preset = "standard" if preset else "none"
        if preset not in _LINEAR_PRESETS:
            raise ValueError(f"unknown linear verbosity preset {preset!r}")
        for k in class_toggles:
            if k not in _LINEAR_CLASSES:
                raise ValueError(f"unknown linear message class {k!r}; "
                                 f"known: {_LINEAR_CLASSES}")
        object.__setattr__(self, "preset", preset)
        object.__setattr__(self, "overrides",
                           tuple(sorted(class_toggles.items())))

    def enabled(self, message_class: str) -> bool:
        for k, v in self.overrides:
            if k == message_class:
                return bool(v)
        return message_class in _LINEAR_PRESETS[self.preset]

    def emit(self, message_class: str, message: str):
        if self.enabled(message_class):
            print(f"[nonlinearsolve_tpu:linear:{message_class}] {message}",
                  file=sys.stderr)


@dataclasses.dataclass(frozen=True)
class NonlinearVerbosity:
    """Per-class message toggles.

    Construct from a preset name, set whole groups
    (``error_control=True``), override individual classes
    (``forcing=True``), and/or nest a linear sub-specifier
    (``linear_verbosity=LinearVerbosity("all")``) — individual class
    settings win over group settings, which win over the preset.
    """

    preset: str = "standard"
    overrides: Any = None          # tuple of (class, bool)
    linear_verbosity: Any = None   # LinearVerbosity or None

    def __init__(self, preset="standard", *, linear_verbosity=None,
                 **toggles):
        if isinstance(preset, bool):
            preset = "standard" if preset else "none"
        if preset not in _PRESETS:
            raise ValueError(f"unknown verbosity preset {preset!r}")
        resolved = {}
        # group-level settings first (lower priority)
        for group, members in _GROUPS.items():
            if group in toggles:
                val = bool(toggles.pop(group))
                for m in members:
                    resolved[m] = val
        # individual classes override groups
        for k, v in toggles.items():
            if k not in _CLASSES:
                raise ValueError(
                    f"unknown message class or group {k!r}; known classes: "
                    f"{_CLASSES}, groups: {tuple(_GROUPS)}")
            resolved[k] = bool(v)
        if linear_verbosity is None and preset != "none":
            # every preset carries its matching linear sub-specifier —
            # 'standard' includes precond_unavailable/krylov_unconverged,
            # so verbose=True surfaces linear-layer degradations (a
            # detailed/all-only sub-spec left those classes dead at the
            # advertised verbose=True configuration)
            linear_verbosity = LinearVerbosity(preset)
        elif isinstance(linear_verbosity, str):
            linear_verbosity = LinearVerbosity(linear_verbosity)
        object.__setattr__(self, "preset", preset)
        object.__setattr__(self, "overrides",
                           tuple(sorted(resolved.items())))
        object.__setattr__(self, "linear_verbosity", linear_verbosity)

    def enabled(self, message_class: str) -> bool:
        for k, v in (self.overrides or ()):
            if k == message_class:
                return bool(v)
        return message_class in _PRESETS[self.preset]

    @property
    def linear(self) -> "LinearVerbosity | None":
        return self.linear_verbosity

    def emit(self, message_class: str, message: str):
        """A message at a host site (stderr) when its class is on."""
        if self.enabled(message_class):
            print(f"[nonlinearsolve_tpu:{message_class}] {message}",
                  file=sys.stderr)


VERBOSITY_NONE = NonlinearVerbosity("none")
VERBOSITY_ALL = NonlinearVerbosity("all")


def normalize_verbosity(verbose) -> "NonlinearVerbosity | None":
    """Accept None | bool | preset str | NonlinearVerbosity."""
    if verbose is None or isinstance(verbose, NonlinearVerbosity):
        return verbose
    return NonlinearVerbosity(verbose)


def _host(values: dict) -> dict:
    """The tensors among ``values`` read to the host in one ``fetch``."""
    import torch
    from .._backend import fetch
    keys = [k for k, v in values.items() if isinstance(v, torch.Tensor)]
    out = dict(values)
    if keys:
        for k, v in zip(keys, fetch(*[values[k] for k in keys])):
            out[k] = v
    return out


def _holds(pred) -> bool:
    """A host bool, or a 0-d device bool read in one ``fetch``."""
    import torch
    if isinstance(pred, torch.Tensor):
        from .._backend import fetch
        return bool(fetch(pred)[0])
    return bool(pred)


def traced_emit(verbosity, message_class: str, pred, fmt: str, **kwargs):
    """A message at an engine site: nothing unless the class is on; then,
    when ``pred`` holds, ``fmt`` formatted with ``kwargs`` on stdout."""
    if verbosity is None or not verbosity.enabled(message_class):
        return
    if _holds(pred):
        print(f"[nonlinearsolve_tpu:{message_class}] "
              f"{fmt.format(**_host(kwargs))}")


def traced_emit_linear(verbosity, message_class: str, pred, fmt: str,
                       **kwargs):
    """``traced_emit`` through the nested linear sub-specifier."""
    if verbosity is None:
        return
    lin = getattr(verbosity, "linear", None) \
        if isinstance(verbosity, NonlinearVerbosity) else verbosity
    if lin is None or not lin.enabled(message_class):
        return
    if _holds(pred):
        print(f"[nonlinearsolve_tpu:linear:{message_class}] "
              f"{fmt.format(**_host(kwargs))}")
