"""Static selection tables (the port of ``ops/selection.py``).

A selection ``y[i] = values_ext[src[i]]`` with a static ``src`` table is a
sparse matrix with at most one unit entry per row; entries equal to
``n_src`` are pads and give 0.  It is the machinery behind the colored
Jacobian's decompression (``ops/sparse_jac.py``) and the CSR→DIA repack
(``ops/spmv_dia.py``).  ``apply`` is one launch of K5's unit-data variant
(``ops/spmv.gather_select``), as the JAX package rides ``_ell_spmv_packed``
with its validity table as data.  The JAX package's chunking and scatter
tier exist because of the TPU's VMEM and are not carried over: the kernel
takes any table in one pass.
"""

from __future__ import annotations

import numpy as np
import torch

from .spmv import gather_select


class StaticSelection:
    """Plan for ``apply(values) -> values_ext[src]`` with static ``src``."""

    def __init__(self, src, n_src: int):
        src = np.asarray(src)
        self.n_src = int(n_src)
        self.n_out = len(src)
        if self.n_src >= 2 ** 31 - 1:
            raise ValueError(f"n_src = {self.n_src} exceeds the int32 "
                             f"tables of the selection kernel")
        if self.n_out and (src.min() < 0 or src.max() > self.n_src):
            raise ValueError(f"selection source out of range [0, "
                             f"{self.n_src}]")
        self.src = src.astype(np.int32, copy=False)   # the kernel's table
        self._tables: dict = {}

    def table(self, device) -> torch.Tensor:
        """``src`` as an int32 tensor on ``device`` (cached)."""
        key = torch.device(device)
        if key not in self._tables:
            self._tables[key] = torch.as_tensor(self.src, device=key)
        return self._tables[key]

    def apply(self, values):
        """values (n_src,) -> (n_out,) selected (pad slots 0)."""
        if values.shape != (self.n_src,):
            raise ValueError(f"values has shape {tuple(values.shape)}, "
                             f"expected ({self.n_src},)")
        return gather_select(self.table(values.device), values.contiguous())
