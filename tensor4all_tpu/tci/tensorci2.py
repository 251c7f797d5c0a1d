"""TCI2 — two-site tensor cross interpolation of a black-box function.

JAX rebuild of tensor4all-tensorci/src/tensorci2.rs
(`TensorCI2` :259, `sweep2site` :605, `sweep1site` :713, `update_pivots`
:1552, `fill_site_tensors` :887, `crossinterpolate2` :1279,
`optimize_with_finder` :1389, `TCI2Options` :71, `PivotSearchStrategy`
:191, `Sweep2Strategy` :225, convergence rule :1178).

Architecture (SURVEY.md §3.1, §7): pivot index sets I/J live on host
(IndexSet); the hot loop — filling the Pi matrix with function samples at
every bond (tensorci2.rs:1583-1619) — is ONE batched evaluation per bond
(a single device program for jittable f, or one host callback for Python
black boxes), and pivot selection is the jitted rrLU kernel (ops.rrlu).
Rank growth is data-dependent but all device programs are fixed-shape per
call; only the selected rank syncs back.

Parity points with the reference engine:

- **Nested accumulation** (non-strictly-nested mode, the default): each
  bond's candidate sets are the Kronecker expansions *unioned with the
  previous iteration's pivot sets* (tensorci2.rs:1437-1449, :1571-1581),
  so sweeps never lose previously-found pivots.
- **Site tensors held in state**: after each sweep `fill_site_tensors`
  solves the pivot systems once (cached evaluations), so
  ``to_tensortrain()`` costs zero new function evaluations
  (tensorci2.rs:541 just clones state).
- **Rook pivot search** (``pivot_search="rook"``): lazy block-rook
  pivoting through `ops.rrlu.luci_rook_from_blocks` avoids materializing
  the |I| d x d |J| Pi matrix — the saving is real f-evals.
- **Reference convergence**: tol AND rank-stable AND no-global-pivots for
  `ncheck_history` consecutive iterations, or rank at maxbonddim
  (tensorci2.rs:1178-1202).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.rrlu import luci_factors_from_matrix, luci_rook_from_blocks
from ..tt.tensortrain import TensorTrain
from .cached_function import CachedFunction
from .indexset import IndexSet, MultiIndex


class TCI2Options:
    """Ref: TCI2Options (tensorci2.rs:71-151); defaults match.

    `tol` is relative to the max |f| sample when `normalize_error` (the
    default); `pivot_search` is "full" | "rook" (ref :191);
    `sweep_strategy` is "forward" | "backward" | "backandforth" (ref
    :225). `n_global_pivots`/`global_search_starts` are accepted as
    aliases of `max_nglobal_pivot`/`nsearch`.
    """

    # ---- round-1 compatibility aliases ----
    @property
    def n_global_pivots(self) -> int:
        return self.max_nglobal_pivot

    @n_global_pivots.setter
    def n_global_pivots(self, v: int) -> None:
        self.max_nglobal_pivot = v

    @property
    def global_search_starts(self) -> int:
        return self.nsearch

    @global_search_starts.setter
    def global_search_starts(self, v: int) -> None:
        self.nsearch = v

    def __init__(self, tol: float = 1e-8, maxbonddim: Optional[int] = None,
                 max_iter: int = 20, pivot_search: str = "full",
                 normalize_error: bool = True, verbosity: int = 0,
                 max_nglobal_pivot: int = 5, nsearch: int = 5,
                 sweep_strategy: str = "backandforth",
                 ncheck_history: int = 3, strictly_nested: bool = False,
                 tol_margin_global_search: float = 10.0, seed: int = 0,
                 final_sweep1site: bool = True,
                 n_global_pivots: Optional[int] = None,
                 global_search_starts: Optional[int] = None,
                 device_bond_update: bool = False):
        self.tol = tol
        self.maxbonddim = maxbonddim
        self.max_iter = max_iter
        self.pivot_search = pivot_search
        self.normalize_error = normalize_error
        self.verbosity = verbosity
        self.max_nglobal_pivot = (n_global_pivots if n_global_pivots
                                  is not None else max_nglobal_pivot)
        self.nsearch = (global_search_starts if global_search_starts
                        is not None else nsearch)
        self.sweep_strategy = sweep_strategy
        self.ncheck_history = ncheck_history
        self.strictly_nested = strictly_nested
        self.tol_margin_global_search = tol_margin_global_search
        self.seed = seed
        self.final_sweep1site = final_sweep1site
        # fuse Pi fill + rrLU pivot selection into ONE device program
        # per bond (jittable f only; see TensorCI2._fused_bond_update)
        self.device_bond_update = device_bond_update


class TensorCI2:
    """TCI2 state: nested pivot sets + site tensors + cached function."""

    def __init__(
        self,
        func: CachedFunction,
        initial_pivots: Optional[Sequence[Sequence[int]]] = None,
    ):
        self.func = func
        self.local_dims = list(func.local_dims)
        L = len(self.local_dims)
        if L < 2:
            raise ValueError("TCI2 needs at least 2 sites")
        self.L = L
        # Iset[p]: multi-indices over sites [0, p); Jset[p]: over (p, L-1]
        self.Iset: List[IndexSet] = [IndexSet() for _ in range(L)]
        self.Jset: List[IndexSet] = [IndexSet() for _ in range(L)]
        self.f_max: float = 0.0
        self.site_tensors: List[Optional[np.ndarray]] = [None] * L
        self.pivot_errors = np.zeros(L - 1)  # per-bond last pivot error
        # previous iteration's pivot sets (non-strictly-nested union,
        # ref i_set_history — only the last entry is ever consumed)
        self._prev_Iset: Optional[List[List[MultiIndex]]] = None
        self._prev_Jset: Optional[List[List[MultiIndex]]] = None
        # compiled fused bond-update programs, keyed by bucketed shapes
        self._fused_fns: dict = {}
        if initial_pivots is None:
            initial_pivots = [tuple(0 for _ in range(L))]
        self.add_global_pivots(initial_pivots)

    # ------------------------------------------------------------------
    def add_global_pivots(self, pivots: Sequence[Sequence[int]]) -> None:
        """Insert full multi-index pivots (prefixes into I, suffixes into J).

        Ref: add_global_pivots (tensorci2.rs:546-577); invalidates site
        tensors.
        """
        for piv in pivots:
            piv = tuple(int(v) for v in piv)
            if len(piv) != self.L:
                raise ValueError("pivot length mismatch")
            for v, d in zip(piv, self.local_dims):
                if not 0 <= v < d:
                    raise ValueError(f"pivot {piv} out of range")
            for p in range(self.L):
                self.Iset[p].add(piv[:p])
                self.Jset[p].add(piv[p + 1:])
        self.invalidate_site_tensors()

    def invalidate_site_tensors(self) -> None:
        self.site_tensors = [None] * self.L

    @property
    def ranks(self) -> List[int]:
        return [len(self.Iset[p + 1]) for p in range(self.L - 1)]

    @property
    def rank(self) -> int:
        return max(self.ranks)

    def link_dims(self) -> List[int]:
        return self.ranks

    def max_bond_error(self) -> float:
        return float(self.pivot_errors.max(initial=0.0))

    # ------------------------------------------------------------------
    # batched evaluation helpers (THE hot loop)
    # ------------------------------------------------------------------
    def _eval_matrix(
        self, rows: Sequence[MultiIndex], cols: Sequence[MultiIndex]
    ) -> np.ndarray:
        """Evaluate f on the cartesian product rows x cols -> (R, C)."""
        R, C = len(rows), len(cols)
        if R == 0 or C == 0:
            return np.zeros((R, C), dtype=self.func.dtype)
        rows_a = np.asarray([list(r) for r in rows], dtype=np.int64)
        cols_a = np.asarray([list(c) for c in cols], dtype=np.int64)
        if rows_a.size == 0:
            rows_a = rows_a.reshape(R, 0)
        if cols_a.size == 0:
            cols_a = cols_a.reshape(C, 0)
        idx = np.concatenate(
            [np.repeat(rows_a, C, axis=0), np.tile(cols_a, (R, 1))], axis=1
        )
        vals = self.func.eval_batch(idx)
        self.f_max = max(self.f_max, float(np.abs(vals).max(initial=0.0)))
        return vals.reshape(R, C)

    def kronecker_i(self, p: int) -> List[MultiIndex]:
        """Kron(Iset[p], local dim p) (ref kronecker_i :995)."""
        return [i + (s,) for i in self.Iset[p]
                for s in range(self.local_dims[p])]

    def kronecker_j(self, p: int) -> List[MultiIndex]:
        """Kron(local dim p, Jset[p]) (ref kronecker_j)."""
        return [(s,) + j for s in range(self.local_dims[p])
                for j in self.Jset[p]]

    def _T_tensor(self, p: int) -> np.ndarray:
        """T_p[i, s, j] = f(Iset[p][i] + (s,) + Jset[p][j]) (ref :887)."""
        mat = self._eval_matrix(self.kronecker_i(p), self.Jset[p].items())
        return mat.reshape(len(self.Iset[p]), self.local_dims[p],
                           len(self.Jset[p]))

    def _P_matrix(self, p: int) -> np.ndarray:
        """P_p[i, j] = f(Iset[p+1][i] + Jset[p][j]) (bond p pivot matrix)."""
        return self._eval_matrix(self.Iset[p + 1].items(),
                                 self.Jset[p].items())

    # ------------------------------------------------------------------
    # pivot updates (ref update_pivots, tensorci2.rs:1552)
    # ------------------------------------------------------------------
    def _update_bond(
        self,
        p: int,
        opts: TCI2Options,
        extra_i: Sequence[MultiIndex] = (),
        extra_j: Sequence[MultiIndex] = (),
    ) -> None:
        I_cand = self.kronecker_i(p)
        J_cand = self.kronecker_j(p + 1)
        seen_i = set(I_cand)
        for e in extra_i:
            if e not in seen_i:
                I_cand.append(e)
                seen_i.add(e)
        seen_j = set(J_cand)
        for e in extra_j:
            if e not in seen_j:
                J_cand.append(e)
                seen_j.add(e)
        if not I_cand or not J_cand:
            return
        maxdim = opts.maxbonddim
        if (opts.device_bond_update and opts.pivot_search == "full"
                and self.func.jax_f is not None):
            rank, rp, cp, lastdrop, pimax = self._fused_bond_update(
                I_cand, J_cand, opts)
            self.f_max = max(self.f_max, pimax)
            if rank == 0:
                rp, cp = np.array([0]), np.array([0])
            self.Iset[p + 1] = IndexSet([I_cand[i] for i in rp])
            self.Jset[p] = IndexSet([J_cand[j] for j in cp])
            self.pivot_errors[p] = lastdrop
            return
        if opts.pivot_search == "rook":
            I_arr = _pad_multiindex(I_cand)
            J_arr = _pad_multiindex(J_cand)

            def fill_block(rows, cols):
                return self._eval_block(I_arr, J_arr, rows, cols)

            fac = luci_rook_from_blocks(
                len(I_cand), len(J_cand), fill_block,
                rel_tol=opts.tol, abs_tol=0.0, max_rank=maxdim)
        else:
            Pi = self._eval_matrix(I_cand, J_cand)
            fac = luci_factors_from_matrix(
                Pi, rel_tol=opts.tol, abs_tol=0.0, max_rank=maxdim,
                compute_factors=False)
        if fac.rank == 0:
            rp, cp = np.array([0]), np.array([0])
        else:
            rp, cp = fac.row_indices, fac.col_indices
        self.Iset[p + 1] = IndexSet([I_cand[i] for i in rp])
        self.Jset[p] = IndexSet([J_cand[j] for j in cp])
        self.pivot_errors[p] = fac.last_pivot_error

    def _fused_bond_update(self, I_cand, J_cand, opts):
        """ONE device program per bond: Pi fill (vmapped jax_f over the
        I x J cartesian product) -> rrLU pivot selection -> meta sync.

        The device-resident alternative to `_eval_matrix` + host rrLU
        (VERDICT r3 #3): only the pivot metadata (3*rank+3 scalars)
        crosses back to host, pivot SETS stay host-side, and candidate
        counts are bucket-padded (padded Pi rows/cols are zeroed — the
        rrLU kernels never select a zero row, ops/rrlu.py:444). The
        memo cache is deliberately bypassed: at device fill rates the
        host dict probe costs more than re-evaluating (num_evals counts
        the LIVE product, so evals/s accounting stays honest; the
        padded duplicates are shape artifacts).

        Ref: tensorci2.rs:1583-1619 (Pi fill is THE hot loop) +
        :1552 update_pivots.
        """
        import jax
        import jax.numpy as jnp

        from ..ops.rrlu import _bucket, _rrlu_kernel, _rrlu_kernel_blocked

        nI, nJ = len(I_cand), len(J_cand)
        li = len(I_cand[0])
        Ltot = self.L
        nIp, nJp = _bucket(nI), _bucket(nJ)
        maxdim = opts.maxbonddim or min(nI, nJ)
        kr = min(nIp, nJp, _bucket(min(maxdim, nI, nJ)))
        # the row/col multi-index lengths li / L-li are NOT part of the
        # compile key: both index stacks pad to L columns and the split
        # point enters as a traced column mask, so all L-1 bonds share
        # one compiled program per (bucketed) candidate-count pair
        key = (nIp, nJp, kr)
        fn = self._fused_fns.get(key)
        if fn is None:
            jax_f = self.func.jax_f

            @jax.jit
            def fn(I_arr, J_arr, li_t, n_i, n_j, cap, rtol):
                colmask = jnp.arange(Ltot) < li_t
                idx = jnp.where(colmask[None, None, :],
                                I_arr[:, None, :], J_arr[None, :, :])
                idx = idx.reshape(nIp * nJp, Ltot)
                vals = jax.vmap(jax_f)(idx).reshape(nIp, nJp)
                live = ((jnp.arange(nIp) < n_i)[:, None]
                        & (jnp.arange(nJp) < n_j)[None, :])
                pi = jnp.where(live, vals, 0)
                kernel = (_rrlu_kernel_blocked if kr >= 128
                          else _rrlu_kernel)
                _, _, meta = kernel(pi, rtol, 0.0, kr, cap=cap)
                return meta, jnp.max(jnp.abs(pi))

            self._fused_fns[key] = fn
        I_arr = np.zeros((nIp, Ltot), np.int64)
        I_arr[:nI, :li] = _pad_multiindex(I_cand)
        I_arr[nI:, :li] = I_arr[:1, :li]
        J_arr = np.zeros((nJp, Ltot), np.int64)
        J_arr[:nJ, li:] = _pad_multiindex(J_cand)
        J_arr[nJ:, li:] = J_arr[:1, li:]
        self.func.num_evals += nI * nJ
        cap = min(maxdim, nI, nJ)
        meta, pimax = fn(I_arr, J_arr, li, nI, nJ, cap, opts.tol)
        meta = np.asarray(meta)
        # meta layout shared by both kernels: rows | cols | pivs |
        # rank | lastdrop (blocked kernel buffers carry +block slack)
        third = (len(meta) - 2) // 3
        rank = min(int(meta[3 * third]), cap)
        rows = meta[:third][:rank].astype(np.int64)
        cols = meta[third:2 * third][:rank].astype(np.int64)
        pivs = meta[2 * third:3 * third]
        # reference error convention (_finalize_pivot_errors)
        if rank >= min(nI, nJ):
            lastdrop = 0.0
        elif rank >= cap and rank > 0:
            lastdrop = float(pivs[rank - 1])
        else:
            lastdrop = float(meta[3 * third + 1])
        return rank, rows, cols, lastdrop, float(pimax)

    def _eval_block(self, I_arr: np.ndarray, J_arr: np.ndarray,
                    rows, cols) -> np.ndarray:
        """Evaluate the (rows, cols) sub-block of the implicit Pi matrix
        (rook path): one batched, memoized evaluation."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        ri = I_arr[rows]
        cj = J_arr[cols]
        R, C = len(rows), len(cols)
        idx = np.concatenate(
            [np.repeat(ri, C, axis=0), np.tile(cj, (R, 1))], axis=1
        )
        vals = self.func.eval_batch(idx)
        self.f_max = max(self.f_max, float(np.abs(vals).max(initial=0.0)))
        return vals.reshape(R, C)

    def sweep2site(
        self,
        direction: str,
        opts: TCI2Options,
        extra_Iset: Optional[List[List[MultiIndex]]] = None,
        extra_Jset: Optional[List[List[MultiIndex]]] = None,
    ) -> None:
        """One half-sweep of two-site pivot updates (ref sweep2site :605).

        `extra_Iset[b+1]` / `extra_Jset[b]` are unioned into bond b's
        candidates (non-strictly-nested accumulation).
        """
        self.invalidate_site_tensors()
        bonds = (range(self.L - 1) if direction == "forward"
                 else range(self.L - 2, -1, -1))
        for p in bonds:
            ei = extra_Iset[p + 1] if extra_Iset is not None else ()
            ej = extra_Jset[p] if extra_Jset is not None else ()
            self._update_bond(p, opts, ei, ej)

    # ------------------------------------------------------------------
    # site tensors (ref fill_site_tensors :887, setsitetensor!)
    # ------------------------------------------------------------------
    def fill_site_tensors(self) -> None:
        """T_b = Pi1 @ P^{-1} per bond; last site = direct evaluation.

        All evaluations go through the memoized CachedFunction, so after
        a sweep this costs no *new* f-evals for entries already sampled.
        The solve runs on host (P is rank x rank).
        """
        L = self.L
        for b in range(L):
            nI = max(len(self.Iset[b]), 1) if b > 0 else 1
            d = self.local_dims[b]
            Pi1 = self._eval_matrix(self.kronecker_i(b), self.Jset[b].items())
            if b == L - 1:
                self.site_tensors[b] = np.asarray(Pi1).reshape(nI, d, 1)
                continue
            P = self._P_matrix(b)  # (|I_{b+1}|, |J_b|)
            if P.shape[0] == P.shape[1]:
                X = np.linalg.solve(P.T, Pi1.T).T
            else:
                X = np.linalg.lstsq(P.T, Pi1.T, rcond=None)[0].T
            self.site_tensors[b] = X.reshape(nI, d, P.shape[0])

    def to_tensortrain(self) -> TensorTrain:
        """Materialize the TT from state (ref to_tensor_train :541 — a
        clone of the site tensors; zero new f-evals when they are
        current)."""
        if any(t is None for t in self.site_tensors):
            self.fill_site_tensors()
        import jax.numpy as jnp

        return TensorTrain([jnp.asarray(t) for t in self.site_tensors])

    # ------------------------------------------------------------------
    # one-site sweeps (ref sweep1site :713, make_canonical :975)
    # ------------------------------------------------------------------
    def sweep1site(
        self,
        forward: bool = True,
        rel_tol: float = 1e-14,
        abs_tol: float = 0.0,
        max_bond_dim: Optional[int] = None,
        update_tensors: bool = True,
    ) -> None:
        """One-site cleanup sweep restoring strict nesting; optionally
        leaves canonical site tensors in state (ref sweep1site_at_bond
        :760-880)."""
        self.invalidate_site_tensors()
        L = self.L
        bonds = range(L - 1) if forward else range(L - 1, 0, -1)
        for b in bonds:
            if forward:
                rows = self.kronecker_i(b)
                cols = self.Jset[b].items()
            else:
                rows = self.Iset[b].items()
                cols = self.kronecker_j(b)
            if not rows or not cols:
                continue
            mat = self._eval_matrix(rows, cols)
            fac = luci_factors_from_matrix(
                mat, rel_tol=rel_tol, abs_tol=abs_tol,
                max_rank=max_bond_dim, left_orthogonal=forward,
                compute_factors=update_tensors)
            if fac.rank == 0:
                continue
            if forward:
                self.Iset[b + 1] = IndexSet([rows[i]
                                             for i in fac.row_indices])
                self.Jset[b] = IndexSet([cols[j] for j in fac.col_indices])
            else:
                self.Iset[b] = IndexSet([rows[i] for i in fac.row_indices])
                self.Jset[b - 1] = IndexSet([cols[j]
                                             for j in fac.col_indices])
            bond_idx = b if forward else b - 1
            self.pivot_errors[bond_idx] = fac.last_pivot_error
            if update_tensors:
                d = self.local_dims[b]
                if forward:
                    nI = max(len(self.Iset[b]), 1) if b > 0 else 1
                    self.site_tensors[b] = np.asarray(
                        fac.left).reshape(nI, d, fac.rank)
                else:
                    nJ = (max(len(self.Jset[b]), 1)
                          if b < L - 1 else 1)
                    self.site_tensors[b] = np.asarray(
                        fac.right).reshape(fac.rank, d, nJ)
        if update_tensors:
            # last visited site: direct evaluation (ref :744-757)
            last = L - 1 if forward else 0
            nI = max(len(self.Iset[last]), 1) if last > 0 else 1
            nJ = max(len(self.Jset[last]), 1) if last < L - 1 else 1
            mat = self._eval_matrix(self.kronecker_i(last),
                                    self.Jset[last].items())
            self.site_tensors[last] = np.asarray(mat).reshape(
                nI, self.local_dims[last], nJ)

    def make_canonical(self, rel_tol: float = 1e-14, abs_tol: float = 0.0,
                       max_bond_dim: Optional[int] = None) -> None:
        """3 one-site sweeps: exact fwd, truncating bwd, truncating fwd
        with tensor updates (ref make_canonical :975)."""
        self.sweep1site(True, 0.0, 0.0, None, update_tensors=False)
        self.sweep1site(False, rel_tol, abs_tol, max_bond_dim,
                        update_tensors=False)
        self.sweep1site(True, rel_tol, abs_tol, max_bond_dim,
                        update_tensors=True)

    # ------------------------------------------------------------------
    @classmethod
    def from_tensor_train(cls, tt: TensorTrain, tol: float = 1e-12,
                          maxbonddim: Optional[int] = None,
                          max_iter: int = 3,
                          f=None, batch_f=None) -> "TensorCI2":
        """Extract pivot state directly from an existing TT
        (ref conversion.rs; see tci.conversion.tci2_from_tensortrain)."""
        from .conversion import tci2_from_tensortrain

        return tci2_from_tensortrain(tt, tol=tol, maxbonddim=maxbonddim,
                                     max_iter=max_iter, f=f,
                                     batch_f=batch_f)


def _pad_multiindex(items: Sequence[MultiIndex]) -> np.ndarray:
    return np.asarray([list(t) for t in items], dtype=np.int64).reshape(
        len(items), -1)


# ----------------------------------------------------------------------
# global pivot search (ref globalpivot.rs:100-220)
# ----------------------------------------------------------------------
def _tt_eval_np(cores: List[np.ndarray], idx: np.ndarray) -> np.ndarray:
    """Host numpy TT evaluation — latency-free for the small random
    batches of the global pivot search (a device dispatch per batch
    dominated the search otherwise)."""
    v = np.ones((idx.shape[0], 1), dtype=cores[0].dtype)
    for k, c in enumerate(cores):
        sl = c[:, idx[:, k], :]  # (r0, B, r1)
        v = np.einsum("bi,ibj->bj", v, sl)
    return v[:, 0]


def floating_zone(tt, batch_f, local_dims, init_p=None,
                  early_stop_tol=float("inf")):
    """Coordinate-ascent search for the worst |f - tt| point
    (ref globalsearch.rs:142 `floating_zone`): sweep positions, keeping
    the error monotone, until stable or past `early_stop_tol`.
    Returns ``(pivot, max_error)``."""
    n = len(local_dims)
    pivot = list(init_p) if init_p is not None else [0] * n
    cores = [np.asarray(c) for c in tt.cores]

    def err_of(idx):
        fv = np.asarray(batch_f(np.asarray(idx, dtype=np.int64)))
        tv = _tt_eval_np(cores, np.asarray(idx, dtype=np.int64))
        return np.abs(fv - tv)

    max_error = float(err_of([pivot])[0])
    for _ in range(10 * n):
        prev = max_error
        for ipos in range(n):
            d = local_dims[ipos]
            cand = np.repeat(np.asarray([pivot]), d, axis=0)
            cand[:, ipos] = np.arange(d)
            e = err_of(cand)
            j = int(e.argmax())
            pivot[ipos] = j
            max_error = max(max_error, float(e[j]))
        if max_error == prev or max_error > early_stop_tol:
            break
    return tuple(int(v) for v in pivot), max_error


def find_global_pivots(
    tci: TensorCI2,
    tt: TensorTrain,
    opts: TCI2Options,
    rng: np.random.Generator,
    abs_tol: float,
) -> List[MultiIndex]:
    """Random starts + per-dimension greedy sweep on |f - tt|; keep points
    with error > abs_tol * tol_margin (ref DefaultGlobalPivotFinder).
    All starts share ONE evaluation batch per site."""
    L, dims = tci.L, tci.local_dims
    S = opts.nsearch
    starts = np.stack([rng.integers(0, d, size=S) for d in dims], axis=1)
    cores = [np.asarray(c) for c in tt.cores]
    best_err = np.zeros(S)
    best_point = starts.copy()
    threshold = abs_tol * opts.tol_margin_global_search
    for site in range(L):
        d = dims[site]
        cand = np.repeat(starts, d, axis=0)  # (S*d, L)
        cand[:, site] = np.tile(np.arange(d), S)
        fv = tci.func.eval_batch(cand)
        tv = _tt_eval_np(cores, cand)
        e = np.abs(fv - tv).reshape(S, d)
        j = e.argmax(axis=1)
        better = e[np.arange(S), j] > best_err
        best_err = np.where(better, e[np.arange(S), j], best_err)
        upd = cand.reshape(S, d, L)[np.arange(S), j]
        best_point[better] = upd[better]
        # starts keep their original value at `site` (ref resets)
    found = [tuple(int(v) for v in best_point[s])
             for s in range(S) if best_err[s] > threshold]
    return found[: opts.max_nglobal_pivot]


def estimate_true_error(
    tt: TensorTrain, func: CachedFunction, n_samples: int = 1000, seed: int = 1
) -> float:
    """Sampled max |f - tt| (ref estimate_true_error)."""
    rng = np.random.default_rng(seed)
    idx = np.stack(
        [rng.integers(0, d, size=n_samples) for d in func.local_dims], axis=1
    )
    fv = func.eval_batch(idx)
    tv = np.asarray(tt.evaluate_batch(idx))
    return float(np.abs(fv - tv).max())


def _convergence_criterion(ranks, errors, nglobal, tol, maxbonddim,
                           ncheck_history) -> bool:
    """Ref: convergence_criterion (tensorci2.rs:1178-1202)."""
    if len(errors) < ncheck_history:
        return False
    le = errors[-ncheck_history:]
    lr = ranks[-ncheck_history:]
    lg = nglobal[-ncheck_history:]
    errors_converged = all(e < tol for e in le)
    no_global = all(n == 0 for n in lg)
    rank_stable = min(lr) == lr[-1]
    at_max = (maxbonddim is not None
              and all(r >= maxbonddim for r in lr))
    return (errors_converged and no_global and rank_stable) or at_max


# ----------------------------------------------------------------------
# driver (ref crossinterpolate2, tensorci2.rs:1279 / optimize :1389)
# ----------------------------------------------------------------------
def crossinterpolate2(
    f: Optional[Callable] = None,
    local_dims: Optional[Sequence[int]] = None,
    initial_pivots: Optional[Sequence[Sequence[int]]] = None,
    options: Optional[TCI2Options] = None,
    batch_f: Optional[Callable] = None,
    dtype=np.float64,
    jax_f: Optional[Callable] = None,
    mesh=None,
) -> Tuple[TensorCI2, List[int], List[float]]:
    """Cross-interpolate a black-box function into a tensor train.

    Returns ``(tci, ranks_history, errors_history)`` — call
    ``tci.to_tensortrain()`` for the TT (free: site tensors are state).

    For jittable integrands pass `jax_f` (pointwise, (L,)-int -> scalar);
    with a `mesh` the Pi-matrix fill — the TCI hot loop — is sharded over
    the device mesh by default (SURVEY.md §5.8).
    """
    opts = options or TCI2Options()
    func = CachedFunction(f=f, local_dims=local_dims, batch_f=batch_f,
                          dtype=dtype, jax_f=jax_f, mesh=mesh)
    tci = TensorCI2(func, initial_pivots)
    return optimize(tci, opts)


def optimize(
    tci: TensorCI2, opts: TCI2Options
) -> Tuple[TensorCI2, List[int], List[float]]:
    """Optimization loop on an existing state (ref optimize_with_finder)."""
    rng = np.random.default_rng(opts.seed)
    ranks_history: List[int] = []
    errors_history: List[float] = []
    nglobal_history: List[int] = []
    for it in range(opts.max_iter):
        norm = (tci.f_max if opts.normalize_error and tci.f_max > 0
                else 1.0)
        abs_tol = opts.tol * norm
        if opts.sweep_strategy == "forward":
            direction = "forward"
        elif opts.sweep_strategy == "backward":
            direction = "backward"
        else:
            direction = "forward" if it % 2 == 0 else "backward"
        # non-strictly-nested: union last iteration's pivot sets into the
        # candidates so sweeps accumulate instead of rebuilding
        if not opts.strictly_nested and tci._prev_Iset is not None:
            extra_I = tci._prev_Iset
            extra_J = tci._prev_Jset
        else:
            extra_I = extra_J = None
        tci._prev_Iset = [list(s.items()) for s in tci.Iset]
        tci._prev_Jset = [list(s.items()) for s in tci.Jset]
        tci.sweep2site(direction, opts, extra_I, extra_J)
        tci.fill_site_tensors()
        err = tci.max_bond_error() / norm
        errors_history.append(err)
        # global pivot search on the current TT (free: tensors in state)
        new_pivots: List[MultiIndex] = []
        if opts.max_nglobal_pivot > 0 and opts.nsearch > 0:
            tt = tci.to_tensortrain()
            new_pivots = find_global_pivots(tci, tt, opts, rng, abs_tol)
            if new_pivots:
                tci.add_global_pivots(new_pivots)
        nglobal_history.append(len(new_pivots))
        ranks_history.append(tci.rank)
        if opts.verbosity:
            print(f"[tci2] iter={it} dir={direction} rank={tci.rank} "
                  f"err={err:.3e} fmax={tci.f_max:.3e} "
                  f"nglobal={len(new_pivots)}")
        if _convergence_criterion(ranks_history, errors_history,
                                  nglobal_history, opts.tol,
                                  opts.maxbonddim, opts.ncheck_history):
            break
    if opts.final_sweep1site:
        norm = (tci.f_max if opts.normalize_error and tci.f_max > 0
                else 1.0)
        tci.sweep1site(True, 1e-14, opts.tol * norm, opts.maxbonddim,
                       update_tensors=True)
    elif any(t is None for t in tci.site_tensors):
        tci.fill_site_tensors()
    return tci, ranks_history, errors_history
