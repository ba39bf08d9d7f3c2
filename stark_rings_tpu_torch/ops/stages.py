"""Linear-stage tables: the CRT/ICRT butterfly dataflow as data
(counterpart of ``stark_rings_tpu/ops/stages.py``).

Every stage of the reference's CRT kernels (butterfly layers, slot
isomorphisms, homogenize/dehomogenize, e.g. goldilocks/ntt.rs:135-437)
is a linear map over Fq^D in which each output coefficient depends on
at most two inputs:

    y[i] = A[i] * x[p[i]]  +  B[i] * x[s[i]]

``(p, A, s, B)`` is derived for each stage by probing the integer spec
(:mod:`..spec`) with basis vectors; a stage then runs as gathers along
the coefficient axis, modular products and adds over any batch axes.
The same representation covers the ``reduce_in_place`` fold (up to three
terms) and the slot fields' Frobenius maps (one term).

The ring models apply the whole CRT as one dense digit GEMM
(:mod:`.mxu_dense`); the staged chain stays as their oracle
(``RingModel.crt_staged``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Sequence

import numpy as np
import torch

from ..device import get_device

__all__ = ["StageTable", "derive_stage_tables", "derive_linear_table"]


@dataclass
class StageTable:
    """T-term sparse linear map y[i] = sum_t coeff[t][i] * x[idx[t][i]],
    its tables on one device."""

    idx: List[torch.Tensor]     # each int64 [D_out]
    coeff: List[torch.Tensor]   # each storage [D_out]
    field: object

    def __call__(self, x):
        f = self.field
        acc = None
        for p, a in zip(self.idx, self.coeff):
            term = f.mul(a, f.take_coeff(x, p))
            acc = term if acc is None else f.add(acc, term)
        return acc


def _probe_matrix(fn: Callable[[List[int]], None], d_in: int, d_out: int,
                  q: int) -> List[dict]:
    """Probe an in-place linear spec function with basis vectors.

    Returns per-row dicts {col: coeff} of the d_out x d_in matrix.
    """
    rows: List[dict] = [dict() for _ in range(d_out)]
    for j in range(d_in):
        c = [0] * d_in
        c[j] = 1
        fn(c)
        assert len(c) >= d_out
        for i in range(d_out):
            if c[i] % q:
                rows[i][j] = c[i] % q
    return rows


def _rows_to_table(rows: Sequence[dict], field, max_terms: int,
                   device) -> StageTable:
    T = max((len(r) for r in rows), default=1)
    if T > max_terms:
        raise ValueError(f"stage has {T}-term rows, expected <= {max_terms}")
    T = max(T, 1)
    d_out = len(rows)
    idx = [np.zeros(d_out, dtype=np.int64) for _ in range(T)]
    coeff_ints = [np.zeros(d_out, dtype=object) for _ in range(T)]
    for i, r in enumerate(rows):
        for t, (j, a) in enumerate(sorted(r.items())):
            idx[t][i] = j
            coeff_ints[t][i] = a
    dev = get_device(device)
    return StageTable(idx=[torch.from_numpy(p).to(dev) for p in idx],
                      coeff=[field.encode(c, dev) for c in coeff_ints],
                      field=field)


def derive_linear_table(fn: Callable[[List[int]], None], d_in: int,
                        d_out: int, field, max_terms: int = 3,
                        device="cuda") -> StageTable:
    """Derive a StageTable for any linear in-place spec function."""
    rows = _probe_matrix(fn, d_in, d_out, field.q)
    return _rows_to_table(rows, field, max_terms, device)


def derive_stage_tables(model, field, device="cuda"):
    """(crt_stages, icrt_stages) as lists of StageTable for a spec model."""
    if field.q != model.q:
        raise ValueError(f"field {field.name} does not match model "
                         f"{model.name}")
    crt = [derive_linear_table(s, model.D, model.D, field, 2, device)
           for s in model.crt_stages]
    icrt = [derive_linear_table(s, model.D, model.D, field, 2, device)
            for s in model.icrt_stages]
    return crt, icrt
