"""TCI1 — one-site cross interpolation driven by lazy ACA pivoting.

JAX rebuild of tensor4all-tensorci/src/tensorci1.rs:1-1055
(`TensorCI1`, `TCI1SweepStrategy`) on top of tcicore's ACA machinery
(matrixaca.rs): each bond grows by AT MOST ONE pivot per half-sweep,
found by a lazy rook walk over the implicit Pi matrix
(ops.rrlu.luci_rook_from_blocks warm-started from the bond's current
pivots) — per pivot the function is evaluated on O((|I| + |J|) * rank)
entries (single residual rows/columns), never the full |I| x |J| block.
That is the ACA cost profile of the reference, with every sample
memoized through CachedFunction.

TCI2 (two-site, full re-pivot) remains the primary engine; TCI1 is the
legacy-parity path and the cheaper choice when the rank is known to grow
slowly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.rrlu import luci_rook_from_blocks
from .cached_function import CachedFunction
from .indexset import IndexSet
from .tensorci2 import TensorCI2, _pad_multiindex


@dataclasses.dataclass
class TCI1Options:
    """Ref: TCI1 options / TCI1SweepStrategy (tensorci1.rs:32)."""

    tol: float = 1e-8
    maxbonddim: Optional[int] = None
    max_iter: int = 30
    sweep_strategy: str = "backandforth"  # ref TCI1SweepStrategy
    verbosity: int = 0


class TensorCI1(TensorCI2):
    """One-site TCI: shares the pivot-set/site-tensor state machine with
    TCI2 but grows each bond incrementally by lazy ACA pivoting."""

    def _grow_bond(self, p: int, opts: TCI1Options) -> float:
        """Add at most one pivot at bond p via a warm-started lazy rook
        walk (ref tensorci1.rs add_pivot / matrixaca.rs); returns the new
        pivot's residual magnitude (0 when converged/capped)."""
        d_p, d_q = self.local_dims[p], self.local_dims[p + 1]
        I_cand = [i + (s,) for i in self.Iset[p] for s in range(d_p)]
        J_cand = [(s,) + j for s in range(d_q) for j in self.Jset[p + 1]]
        I_pos = {piv: k for k, piv in enumerate(I_cand)}
        J_pos = {piv: k for k, piv in enumerate(J_cand)}
        cur_rows = [I_pos[piv] for piv in self.Iset[p + 1] if piv in I_pos]
        cur_cols = [J_pos[piv] for piv in self.Jset[p] if piv in J_pos]
        r = min(len(cur_rows), len(cur_cols))
        cur_rows, cur_cols = cur_rows[:r], cur_cols[:r]
        if opts.maxbonddim is not None and r >= opts.maxbonddim:
            return 0.0
        I_arr = _pad_multiindex(I_cand)
        J_arr = _pad_multiindex(J_cand)

        def fill_block(rows, cols):
            return self._eval_block(I_arr, J_arr, rows, cols)

        fac = luci_rook_from_blocks(
            len(I_cand), len(J_cand), fill_block,
            rel_tol=0.0, abs_tol=opts.tol * max(self.f_max, 1e-300),
            max_rank=r + 1, initial_rows=cur_rows, initial_cols=cur_cols)
        new_rows = [int(i) for i in fac.row_indices[r:]]
        new_cols = [int(j) for j in fac.col_indices[r:]]
        err = float(fac.pivot_errors[-1]) if len(fac.pivot_errors) else 0.0
        if new_rows:
            self.Iset[p + 1] = IndexSet(
                [I_cand[i] for i in fac.row_indices])
            self.Jset[p] = IndexSet([J_cand[j] for j in fac.col_indices])
            self.invalidate_site_tensors()
            err = float(fac.pivot_errors[-2]) \
                if len(fac.pivot_errors) >= 2 else err
        self.pivot_errors[p] = err
        return err


def crossinterpolate1(
    f: Optional[Callable] = None,
    local_dims: Optional[Sequence[int]] = None,
    initial_pivots: Optional[Sequence[Sequence[int]]] = None,
    options: Optional[TCI1Options] = None,
    batch_f: Optional[Callable] = None,
    dtype=np.float64,
) -> Tuple[TensorCI1, List[int], List[float]]:
    """Legacy one-site TCI driver (ref tensorci1.rs)."""
    opts = options or TCI1Options()
    func = CachedFunction(f=f, local_dims=local_dims, batch_f=batch_f,
                          dtype=dtype)
    tci = TensorCI1(func, initial_pivots)
    ranks_history: List[int] = []
    errors_history: List[float] = []
    for it in range(opts.max_iter):
        if opts.sweep_strategy == "forward":
            forward = True
        elif opts.sweep_strategy == "backward":
            forward = False
        else:
            forward = it % 2 == 0
        bonds = (range(tci.L - 1) if forward
                 else range(tci.L - 2, -1, -1))
        max_err = 0.0
        for p in bonds:
            max_err = max(max_err, tci._grow_bond(p, opts))
        err = max_err / max(tci.f_max, 1e-300)
        ranks_history.append(max(tci.ranks))
        errors_history.append(err)
        if opts.verbosity:
            print(f"[tci1] iter={it} rank={ranks_history[-1]} "
                  f"err={err:.3e}")
        if err < opts.tol:
            break
    tci.fill_site_tensors()
    return tci, ranks_history, errors_history
