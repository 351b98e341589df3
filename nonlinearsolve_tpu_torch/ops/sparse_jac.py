"""Colored sparse-AD Jacobian assembly (the port of ``ops/sparse_jac.py``).

A sparse Jacobian in ``n_colors`` JVPs instead of ``n`` (the reference's
``AutoSparse`` path).  The pattern and the coloring are static, built once
on the host:

    seeds[c]   = Σ_{color(j)=c} e_j                      (n_colors, n)
    compressed = vmap(jvp(f, u, seed))                   (n_colors, n)
    data[k]    = compressed[color(col(k)), row(k)]       a static selection

The selection is K5's unit-data variant (``ops/selection.py``), once per
Jacobian.  The port selects from the (C, n) compressed layout directly
(source ``color·n + row``) where the TPU kernel read its transpose; the
values selected are the same.  ``dia`` assembles straight into the DIA
tier's (ndiag, n) layout with one selection, so a Krylov solve on a
stencil-born pattern runs K4 on it without a CSR step.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .coloring import (detect_sparsity, greedy_column_coloring,
                       pattern_from)
from .selection import StaticSelection
from .sparse import CSR, DIA
from ..core.autodiff import jvp


class ColoredJacobian:
    """Precomputed plan for sparse Jacobian assembly into CSR or DIA."""

    def __init__(self, pattern: CSR, colors: np.ndarray):
        self.pattern = pattern
        self.colors = np.asarray(colors, np.int32)
        self.n_colors = int(self.colors.max()) + 1 if self.colors.size else 0
        n_out, n_in = pattern.shape
        self._seeds = np.zeros((self.n_colors, n_in))
        self._seeds[self.colors, np.arange(n_in)] = 1.0
        self._seed_tensors: dict = {}
        # nnz entry k at (row r, col c) reads compressed[color[c], r]
        self._gather = (self.colors[pattern.indices].astype(np.int64) * n_out
                        + pattern.row_ids.astype(np.int64))
        self._select = None
        self._dia_sel = None

    @property
    def dia_plan(self):
        """The pattern's DiaPlan when the DIA SpMV tier owns it, else
        None — decides whether :meth:`dia` is available."""
        tier, dplan, perm, _pinv, _dperm = self.pattern.tier
        return dplan if tier == "dia" and perm is None else None

    @property
    def dia_selection(self) -> StaticSelection:
        """The assembly-direct selection: slot (d, i) reads
        compressed[color(i+off_d), i]; pattern-absent slots are pads (0)."""
        dplan = self.dia_plan
        if dplan is None:
            raise ValueError("pattern is not DIA-tier eligible")
        if self._dia_sel is None:
            n_src = self.pattern.shape[0] * self.n_colors
            src = np.full((dplan.ndiag, self.pattern.shape[0]), n_src,
                          np.int64)
            src[dplan._dpos, dplan._row_ids] = self._gather
            self._dia_sel = StaticSelection(src.reshape(-1), n_src)
        return self._dia_sel

    def dia(self, f_flat: Callable, u) -> DIA:
        """Assemble directly into the (ndiag, n) layout with one selection
        (``dia_selection``) from the compressed JVPs."""
        sel = self.dia_selection
        dd = sel.apply(self._compressed(f_flat, u).reshape(-1))
        dplan = self.dia_plan
        return DIA(dd.reshape(dplan.ndiag, self.pattern.shape[0]),
                   dplan.offsets, self.pattern.shape)

    def _seeds_for(self, u):
        key = (u.dtype, u.device, tuple(u.shape))
        if key not in self._seed_tensors:
            seeds = torch.as_tensor(self._seeds, dtype=u.dtype,
                                    device=u.device)
            self._seed_tensors[key] = seeds.reshape(
                (self.n_colors,) + tuple(u.shape))
        return self._seed_tensors[key]

    def _compressed(self, f_flat: Callable, u):
        """(n_colors, n_out): one forward JVP per color, batched by vmap."""
        def one_color(seed):
            return jvp(f_flat, u, seed)[1].reshape(-1)

        return torch.func.vmap(one_color)(self._seeds_for(u))

    def __call__(self, f_flat: Callable, u) -> CSR:
        if self._select is None:
            n_out = self.pattern.shape[0]
            self._select = StaticSelection(self._gather,
                                           n_out * self.n_colors)
        compressed = self._compressed(f_flat, u)
        return self.pattern.with_data(
            self._select.apply(compressed.reshape(-1)))


def plan_sparse_jacobian(f_flat: Callable, n_in: int, n_out: int, *,
                         sparsity=None, colorvec=None, dtype=torch.float64,
                         device=None) -> ColoredJacobian:
    """Build the (pattern, coloring) plan.  ``sparsity`` may be a CSR
    pattern, a COO tuple or a dense mask; None detects it
    (``coloring.detect_sparsity``, tracing ``f_flat`` at a state of
    ``dtype`` on ``device``)."""
    if sparsity is None:
        pattern = detect_sparsity(f_flat, n_in, dtype=dtype, device=device)
    else:
        pattern = pattern_from(sparsity, n_out, n_in)
    colors = (np.asarray(colorvec, np.int32) if colorvec is not None
              else greedy_column_coloring(pattern))
    return ColoredJacobian(pattern, colors)
