"""Rebuild TCI2 pivot state from an existing TensorTrain.

JAX rebuild of tensor4all-tensorci/src/conversion.rs:1-260
(`tensorci2_from_tensor_train`, `sweep1site_get_indices`, `sweep_pair`):
pivot index sets are extracted *directly* from the TT cores by one-site
LU sweeps — no re-interpolation of the train, no extra function
evaluations. This is the de-facto resume path (SURVEY.md §5.4).

Each forward sweep factorizes core_b matricized as (a*d, b) with a
left-orthogonal LUCI; the selected rows become Iset[b+1] (as Kronecker
expansions of Iset[b]), the right factor is absorbed into the next core.
Backward sweeps mirror this for Jset. Iterations 3+ re-run with the
opposite set held as "spectator" and filtered by the complementary pivot
choice, exactly the reference's alternating refinement.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..ops.rrlu import luci_factors_from_matrix
from ..tt.tensortrain import TensorTrain
from .cached_function import CachedFunction
from .indexset import IndexSet, MultiIndex
from .tensorci2 import TensorCI2


def _sweep_get_indices(
    cores: List[np.ndarray],
    local_dims: List[int],
    forward: bool,
    spectators: Optional[List[List[MultiIndex]]],
    tol: float,
    maxbonddim: Optional[int],
) -> List[List[MultiIndex]]:
    """One alternating one-site extraction sweep; mutates `cores`
    (ref sweep1site_get_indices / sweep_pair, conversion.rs:142-260)."""
    n = len(cores)
    index_set: List[List[MultiIndex]] = [[()]]
    for step in range(n - 1):
        site = step if forward else n - 1 - step
        nxt = site + 1 if forward else site - 1
        a, d, b = cores[site].shape
        if forward:
            mat = cores[site].reshape(a * d, b)
        else:
            mat = cores[site].reshape(a, d * b)
        fac = luci_factors_from_matrix(
            mat, rel_tol=tol, abs_tol=0.0, max_rank=maxbonddim,
            left_orthogonal=forward)
        rank = max(fac.rank, 1)
        if fac.rank == 0:
            # zero core: keep a single deterministic pivot
            rows = np.array([0])
            cols = np.array([0])
            left = np.zeros((mat.shape[0], 1), mat.dtype)
            right = np.zeros((1, mat.shape[1]), mat.dtype)
        else:
            rows, cols = fac.row_indices, fac.col_indices
            left, right = np.asarray(fac.left), np.asarray(fac.right)
        base = index_set[-1]
        if forward:
            candidates = [i + (s,) for i in base for s in range(d)]
            index_set.append([candidates[i] for i in rows])
            if spectators is not None:
                spectators[site] = [spectators[site][j] for j in cols]
            an, dn, cn = cores[nxt].shape
            cores[nxt] = (right @ cores[nxt].reshape(an, dn * cn)).reshape(
                rank, dn, cn)
            cores[site] = left.reshape(a, d, rank)
        else:
            candidates = [(s,) + j for s in range(d) for j in base]
            index_set.append([candidates[j] for j in cols])
            if spectators is not None:
                spectators[site] = [spectators[site][i] for i in rows]
            cn, dn, an = cores[nxt].shape
            cores[nxt] = (cores[nxt].reshape(cn * dn, an) @ left).reshape(
                cn, dn, rank)
            cores[site] = right.reshape(rank, d, b)
    if not forward:
        index_set.reverse()
    return index_set


def tci2_from_tensortrain(
    tt: TensorTrain,
    tol: float = 1e-12,
    maxbonddim: Optional[int] = None,
    max_iter: int = 3,
    f=None,
    batch_f=None,
) -> TensorCI2:
    """Create a TCI2 whose pivot sets + site tensors reproduce `tt`.

    Zero function evaluations: the state is extracted from the cores.
    Pass `f`/`batch_f` to attach the original black box for further
    optimization; by default the TT itself is attached (so continued
    sweeps refine against the train).
    """
    if len(tt) < 2:
        raise ValueError("TCI2 conversion requires at least 2 sites")
    if max_iter < 2:
        raise ValueError("max_iter must be at least 2")
    local_dims = list(tt.local_dims)
    cores = [np.asarray(c) for c in tt.cores]
    i_set = _sweep_get_indices(cores, local_dims, True, None, tol,
                               maxbonddim)
    j_set = _sweep_get_indices(cores, local_dims, False, None, tol,
                               maxbonddim)
    for it in range(3, max_iter + 1):
        if it % 2 == 1:
            filtered_j = [list(s) for s in j_set]
            new_i = _sweep_get_indices(cores, local_dims, True, filtered_j,
                                       tol, maxbonddim)
            j_set = filtered_j
            if new_i == i_set:
                break
            i_set = new_i
        else:
            filtered_i = [list(s) for s in i_set]
            new_j = _sweep_get_indices(cores, local_dims, False, filtered_i,
                                       tol, maxbonddim)
            i_set = filtered_i
            if new_j == j_set:
                break
            j_set = new_j

    if batch_f is None and f is None:
        tt_orig = tt

        def batch_f(idx: np.ndarray) -> np.ndarray:  # noqa: F811
            return np.asarray(tt_orig.evaluate_batch(idx))

    func = CachedFunction(f=f, batch_f=batch_f, local_dims=local_dims,
                          dtype=np.asarray(cores[0]).dtype)
    tci = TensorCI2.__new__(TensorCI2)
    tci.func = func
    tci.local_dims = local_dims
    tci.L = len(local_dims)
    tci.Iset = [IndexSet(s) for s in i_set]
    tci.Jset = [IndexSet(s) for s in j_set]
    tci.site_tensors = list(cores)
    tci.pivot_errors = np.zeros(len(local_dims) - 1)
    tci.f_max = float(max(np.abs(c).max(initial=0.0) for c in cores))
    tci._prev_Iset = None
    tci._prev_Jset = None
    return tci


def opt_first_pivot(
    func: CachedFunction,
    start: Optional[tuple] = None,
    max_rounds: int = 10,
) -> tuple:
    """Greedy coordinate ascent maximizing |f| for the starting pivot.

    Ref: tensorci/src/optfirstpivot.rs:40.
    """
    dims = func.local_dims
    point = np.asarray(start if start is not None else [0] * len(dims),
                       dtype=np.int64)
    best = abs(func(tuple(point)))
    for _ in range(max_rounds):
        improved = False
        for site, d in enumerate(dims):
            cand = np.tile(point, (d, 1))
            cand[:, site] = np.arange(d)
            vals = np.abs(func.eval_batch(cand))
            j = int(np.argmax(vals))
            if vals[j] > best * (1 + 1e-15):
                best = vals[j]
                point = cand[j]
                improved = True
        if not improved:
            break
    return tuple(int(v) for v in point)
