"""Adaptive Cross Approximation (ACA) of matrices.

JAX rebuild of tensor4all-tcicore/src/matrixaca.rs:80 `MatrixACA`
(the legacy TCI1 pivot engine): rank-1 residual updates with full-pivot
selection — each pivot is the argmax over the entire current residual
(stronger than the reference's rook walk, at the cost of touching the
full matrix, which its small-cross-matrix use sites afford). The lazy
rook walk that matches the reference's cost profile lives in
ops.rrlu.luci_rook_from_blocks. Runs as host-driven jnp ops on the
reference's use sites are small cross matrices); the fully-jitted variant
is ops.rrlu which subsumes it for production paths.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class ACAResult:
    rank: int
    row_pivots: np.ndarray
    col_pivots: np.ndarray
    U: jnp.ndarray  # (n, rank) column factors
    V: jnp.ndarray  # (rank, m) row factors
    pivot_errors: np.ndarray

    @property
    def approx(self) -> jnp.ndarray:
        return self.U @ self.V


def matrix_aca(
    a,
    rtol: float = 1e-12,
    max_rank: Optional[int] = None,
) -> ACAResult:
    """Cross ACA: ``A ≈ sum_k u_k v_k`` with u from pivot columns, v from
    pivot rows of the running residual."""
    a = jnp.asarray(a)
    n, m = a.shape
    kmax = min(n, m) if max_rank is None else min(max_rank, n, m)
    R = a
    us, vs, rows, cols, errs = [], [], [], [], []
    amax = float(jnp.max(jnp.abs(a)))
    if amax == 0 or kmax == 0:
        return ACAResult(0, np.zeros(0, np.int64), np.zeros(0, np.int64),
                         jnp.zeros((n, 0), a.dtype), jnp.zeros((0, m), a.dtype),
                         np.zeros(0))
    for k in range(kmax):
        flat = int(jnp.argmax(jnp.abs(R)))
        i, j = flat // m, flat % m
        piv = R[i, j]
        pmag = float(jnp.abs(piv))
        if pmag <= rtol * amax:
            errs.append(pmag)
            break
        u = R[:, j] / piv
        v = R[i, :]
        R = R - jnp.outer(u, v)
        us.append(u)
        vs.append(v)
        rows.append(int(i))
        cols.append(int(j))
        errs.append(pmag)
    rank = len(us)
    U = jnp.stack(us, axis=1) if rank else jnp.zeros((n, 0), a.dtype)
    V = jnp.stack(vs, axis=0) if rank else jnp.zeros((0, m), a.dtype)
    return ACAResult(rank, np.asarray(rows, np.int64), np.asarray(cols, np.int64),
                     U, V, np.asarray(errs[:rank]))
