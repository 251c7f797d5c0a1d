"""Rank-revealing full-pivot LU and LU-based cross interpolation (CI).

JAX rebuild of tensor4all-tcicore
(crates/tensor4all-tcicore/src/matrixlu.rs:69 `RrLU`, :713 `rrlu_inplace`,
:822 `rrlu`; matrix_luci.rs:48 `MatrixLUCI`).

Design: the data-dependent pivot loop is the worst case for an
accelerator (SURVEY.md §7 hard part 2). We run it as ONE jitted ``lax.while_loop`` over
a static ``max_rank`` bound: each step is a global argmax over the residual
(a reduction) plus a rank-1 update (outer product). Shapes never change —
rank is carried as a traced scalar, and only that scalar syncs to host.
L/U factor buffers are preallocated at ``max_rank`` and sliced host-side.

Key identities used for the CI factors (all exact for full-pivot LU):
with pivot rows I, cols J, ``P = A[I,J] = L[I,:] @ U[:,J]`` where
``L[I,:]`` is unit lower triangular and ``U[:,J]`` upper triangular; then
``A[:,J] @ inv(P) @ A[I,:] = L @ U`` — so the LU product *is* the CI
approximation and factors can be re-expressed with triangular solves.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class RrLUResult:
    """Ref: RrLU struct (matrixlu.rs:69)."""

    rank: int
    row_pivots: np.ndarray  # (rank,) row index of k-th pivot
    col_pivots: np.ndarray  # (rank,)
    L: jnp.ndarray  # (n, rank); L[row_pivots, :] unit lower-triangular
    U: jnp.ndarray  # (rank, m); U[:, col_pivots] upper-triangular
    pivot_magnitudes: np.ndarray  # (rank,) |pivot| per step (decreasing-ish)
    last_pivot_error: float  # |first discarded pivot| (0 if full rank)

    @property
    def lu(self) -> jnp.ndarray:
        """The rank-`rank` approximation L @ U."""
        return self.L @ self.U

    def ci_factors(self) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """(A[:,J] @ inv(P), A[I,:]) with interpolation property
        ``left[I,:] = eye`` — computed as ``L @ inv(L[I,:])`` and
        ``L[I,:] @ U`` via a triangular solve. Host-resident factors
        (numpy, from the native/numpy twin) solve on host LAPACK so the
        CPU-class path never round-trips through a remote device."""
        LI = self.L[self.row_pivots, :]
        if isinstance(self.L, np.ndarray):
            import scipy.linalg as sla

            left = sla.solve_triangular(
                LI.T, self.L.T, lower=False, unit_diagonal=True
            ).T
            right = LI @ self.U
            return left, right
        left = jax.scipy.linalg.solve_triangular(
            LI.T, self.L.T, lower=False, unit_diagonal=True
        ).T
        right = LI @ self.U
        return left, right


def _bucket(n: int) -> int:
    """Next power-of-two bucket (min 8) — bounds compile count."""
    b = 8
    while b < n:
        b *= 2
    return b


@functools.partial(jax.jit, static_argnames=("max_rank",))
def _rrlu_kernel(a: jnp.ndarray, rtol: float, atol: float, max_rank: int,
                 cap=None):
    """Full-pivot LU loop; returns padded factors + traced rank.

    `max_rank` (static) sizes the factor buffers; `cap` (traced,
    defaults to max_rank) bounds the accepted rank — so data-dependent
    rank caps never force recompilation (bucket-and-mask, SURVEY §7).
    """
    n, m = a.shape
    dtype = a.dtype
    cap_t = jnp.asarray(max_rank if cap is None else cap, jnp.int32)
    Lb = jnp.zeros((n, max_rank), dtype)
    Ub = jnp.zeros((max_rank, m), dtype)
    rows = jnp.full((max_rank,), -1, jnp.int32)
    cols = jnp.full((max_rank,), -1, jnp.int32)
    pivs = jnp.zeros((max_rank,), jnp.float64)
    first = jnp.max(jnp.abs(a))
    thresh = jnp.maximum(rtol * first, atol)

    def cond(carry):
        A, Lb, Ub, rows, cols, pivs, k, done, lastdrop = carry
        return jnp.logical_and(k < cap_t, jnp.logical_not(done))

    def body(carry):
        A, Lb, Ub, rows, cols, pivs, k, done, lastdrop = carry
        absA = jnp.abs(A)
        flat = jnp.argmax(absA)
        i, j = flat // m, flat % m
        piv = A[i, j]
        pmag = jnp.abs(piv)
        good = pmag > thresh

        def take(args):
            A, Lb, Ub, rows, cols, pivs, k = args
            colv = A[:, j] / piv  # L column (unit at row i)
            rowv = A[i, :]  # U row
            A2 = A - jnp.outer(colv, rowv)
            # exact zeros on eliminated row/col to stop re-selection
            A2 = A2.at[i, :].set(0).at[:, j].set(0)
            Lb2 = Lb.at[:, k].set(colv)
            Ub2 = Ub.at[k, :].set(rowv)
            return (
                A2,
                Lb2,
                Ub2,
                rows.at[k].set(i.astype(jnp.int32)),
                cols.at[k].set(j.astype(jnp.int32)),
                pivs.at[k].set(pmag.astype(jnp.float64)),
                k + 1,
            )

        def skip(args):
            return args

        A, Lb, Ub, rows, cols, pivs, k = jax.lax.cond(
            good, take, skip, (A, Lb, Ub, rows, cols, pivs, k)
        )
        lastdrop = jnp.where(good, lastdrop, pmag.astype(jnp.float64))
        return (A, Lb, Ub, rows, cols, pivs, k, jnp.logical_not(good), lastdrop)

    init = (a, Lb, Ub, rows, cols, pivs, jnp.int32(0), jnp.bool_(False),
            jnp.float64(0.0))
    A, Lb, Ub, rows, cols, pivs, k, done, lastdrop = jax.lax.while_loop(
        cond, body, init
    )
    # pack all host-needed metadata into ONE array: every separate
    # device->host read is a synchronizing round trip
    meta = jnp.concatenate([
        rows.astype(jnp.float64),
        cols.astype(jnp.float64),
        pivs,
        jnp.stack([k.astype(jnp.float64), lastdrop]),
    ])
    return Lb, Ub, meta


@functools.partial(jax.jit, static_argnames=("max_rank", "block"))
def _rrlu_kernel_blocked(a: jnp.ndarray, rtol: float, atol: float,
                         max_rank: int, block: int = 32, cap=None):
    """Blocked-ROOK rank-revealing LU for the device (SURVEY §7 hard
    part 2; ref tcicore matrixluci/block_rook.rs localized pivoting).

    Per pivot, the sequential work is a rook walk whose column/row
    corrections are two panel GEMVs against the zero-padded static-shape
    current panel — O((n+m)*block) instead of the naive kernel's O(n*m)
    rank-1 update — and the residual is refreshed once per block with a
    rank-`block` GEMM. A full |R| argmax runs
    once per block (rook restart + tolerance recheck), so rank-stop
    decisions are full-pivot faithful at block granularity while pivot
    ORDER follows the rook walk (the reference's rook strategy shares
    that contract). Within a block, acceptance is prefix-shaped (a
    failed rook pivot ends the block; the next block re-checks on the
    refreshed residual), and panels are written at the CURRENT rank
    offset so factor columns stay aligned with the pivot lists.

    Returns the same ``(Lb, Ub, meta)`` as ``_rrlu_kernel``.
    """
    with jax.default_matmul_precision("highest"):
        return _rrlu_blocked_body(a, rtol, atol, max_rank, block, cap)


def _rrlu_blocked_body(a, rtol, atol, max_rank, block, cap=None):
    # full-f32 matmul passes: the panel corrections and the rank-block
    # residual refresh decide PIVOT ACCEPTANCE — at a bf16-grade default
    # matmul precision the refresh noise (~1e-3 relative) inflates
    # ranks by tens of junk pivots (measured: rank 87 vs true 18)
    n, m = a.shape
    dtype = a.dtype
    # `cap` (traced, defaults to max_rank) bounds ACCEPTED rank so a
    # caller rank cap bounds device work without a recompile (the
    # static max_rank only sizes the factor buffers)
    cap_t = jnp.asarray(max_rank if cap is None else cap, jnp.int32)
    nb = -(-max_rank // block)  # ceil
    Lb = jnp.zeros((n, max_rank + block), dtype)  # slack for panel writes
    Ub = jnp.zeros((max_rank + block, m), dtype)
    rows = jnp.full((max_rank + block,), -1, jnp.int32)
    cols = jnp.full((max_rank + block,), -1, jnp.int32)
    pivs = jnp.zeros((max_rank + block,), jnp.float64)
    rowmask = jnp.ones((n,), dtype)
    colmask = jnp.ones((m,), dtype)
    first = jnp.max(jnp.abs(a))
    thresh = jnp.maximum(rtol * first, atol)

    def block_cond(carry):
        (R, Lb, Ub, rows, cols, pivs, rowmask, colmask, k, bdone,
         lastdrop, bi) = carry
        return jnp.logical_and(bi < nb, jnp.logical_not(bdone))

    def block_body(carry):
        (R, Lb, Ub, rows, cols, pivs, rowmask, colmask, k, _, lastdrop,
         bi) = carry
        # block-start: full argmax on the REFRESHED residual — rook
        # restart point AND the full-pivot-faithful tolerance recheck
        absR = jnp.abs(R) * rowmask[:, None] * colmask[None, :]
        flat = jnp.argmax(absR)
        j0 = (flat % m).astype(jnp.int32)
        start_mag = absR.reshape(-1)[flat]
        bdone = start_mag <= thresh
        lastdrop = jnp.where(bdone, start_mag.astype(jnp.float64),
                             lastdrop)
        k0 = k

        Lp = jnp.zeros((n, block), dtype)
        Up = jnp.zeros((block, m), dtype)

        def step(b, inner):
            (Lp, Up, rows, cols, pivs, rowmask, colmask, k, done,
             lastdrop, jcur) = inner

            def corr_col(j):
                return (R[:, j] - Lp @ Up[:, j]) * rowmask

            def corr_row(i):
                return (R[i, :] - Lp[i, :] @ Up) * colmask

            j = jcur
            for _ in range(2):  # fixed rook iterations
                c = corr_col(j)
                i = jnp.argmax(jnp.abs(c)).astype(jnp.int32)
                r_ = corr_row(i)
                j = jnp.argmax(jnp.abs(r_)).astype(jnp.int32)
            c = corr_col(j)
            i = jnp.argmax(jnp.abs(c)).astype(jnp.int32)
            piv = c[i]
            pmag = jnp.abs(piv)
            good = jnp.logical_and(pmag > thresh, jnp.logical_not(done))
            good = jnp.logical_and(good, k < cap_t)
            gd = good.astype(dtype)
            r_ = corr_row(i)
            colv = gd * c / jnp.where(pmag > 0, piv, jnp.ones((), dtype))
            rowv = gd * r_
            Lp = Lp.at[:, b].set(colv)
            Up = Up.at[b, :].set(rowv)
            slot = k0 + b  # prefix acceptance keeps slot == k when good
            rows = rows.at[slot].set(jnp.where(good, i, rows[slot]))
            cols = cols.at[slot].set(jnp.where(good, j, cols[slot]))
            pivs = pivs.at[slot].set(
                jnp.where(good, pmag.astype(jnp.float64), pivs[slot]))
            rowmask = rowmask.at[i].set(
                jnp.where(good, jnp.zeros((), dtype), rowmask[i]))
            colmask = colmask.at[j].set(
                jnp.where(good, jnp.zeros((), dtype), colmask[j]))
            lastdrop = jnp.where(
                jnp.logical_and(jnp.logical_not(good),
                                jnp.logical_not(done)),
                pmag.astype(jnp.float64), lastdrop)
            done = jnp.logical_or(done, jnp.logical_not(good))
            k = k + good.astype(jnp.int32)
            jnext = jnp.argmax(jnp.abs(rowv) * colmask).astype(jnp.int32)
            return (Lp, Up, rows, cols, pivs, rowmask, colmask, k, done,
                    lastdrop, jnext)

        inner = (Lp, Up, rows, cols, pivs, rowmask, colmask, k, bdone,
                 lastdrop, j0)
        (Lp, Up, rows, cols, pivs, rowmask, colmask, k, _, lastdrop,
         _) = jax.lax.fori_loop(0, block, step, inner)
        # panel lands at the block's rank offset: alignment with the
        # pivot lists is exact because acceptance is prefix-shaped
        Lb = jax.lax.dynamic_update_slice(Lb, Lp, (jnp.int32(0), k0))
        Ub = jax.lax.dynamic_update_slice(Ub, Up, (k0, jnp.int32(0)))
        R = R - Lp @ Up  # rank-`block` GEMM refresh
        R = R * rowmask[:, None] * colmask[None, :]
        # cap: never exceed the traced cap (<= static max_rank buffer)
        bdone = jnp.logical_or(k >= cap_t, bdone)
        return (R, Lb, Ub, rows, cols, pivs, rowmask, colmask, k, bdone,
                lastdrop, bi + 1)

    carry = (a, Lb, Ub, rows, cols, pivs, rowmask, colmask, jnp.int32(0),
             jnp.bool_(False), jnp.float64(0.0), jnp.int32(0))
    (R, Lb, Ub, rows, cols, pivs, rowmask, colmask, k, bdone,
     lastdrop, _) = jax.lax.while_loop(block_cond, block_body, carry)
    # cap-stop leaves lastdrop unset (no tolerance trigger fired); report
    # the dominant remaining residual entry as the truncation error, as
    # the host-side truncation used to do via the next pivot magnitude
    rem = jnp.max(jnp.abs(R) * rowmask[:, None] * colmask[None, :])
    lastdrop = jnp.where(jnp.logical_and(lastdrop == 0.0, k >= cap_t),
                         rem.astype(jnp.float64), lastdrop)
    k = jnp.minimum(k, max_rank)
    meta = jnp.concatenate([
        rows[:max_rank].astype(jnp.float64),
        cols[:max_rank].astype(jnp.float64),
        pivs[:max_rank],
        jnp.stack([k.astype(jnp.float64), lastdrop]),
    ])
    return Lb[:, :max_rank], Ub[:max_rank, :], meta


def _host_small(a, cap: int = 512 * 512) -> bool:
    """Small concrete operand that should factorize on the host: the
    C++/numpy loop beats the jitted kernel's per-call dispatch and
    device round trip. Host-resident numpy operands
    never go to the device for this; jax arrays stay on their backend
    unless it is the CPU."""
    if isinstance(a, jax.core.Tracer):
        return False
    if isinstance(a, np.ndarray):
        return a.size <= cap
    try:
        if jax.default_backend() != "cpu":
            return False
    except Exception:  # noqa: BLE001
        return False
    return a.size <= cap


def _rrlu_native(a: np.ndarray, rtol: float, atol: float,
                 max_rank: int) -> Optional[RrLUResult]:
    """C++ twin of `_rrlu_np` (native/kernels.cpp); None if the shared
    library is unavailable or the dtype unsupported."""
    from ..native import load

    lib = load()
    if lib is None:
        return None
    if a.dtype == np.float64:
        fn, ctype = lib.t4a_rrlu_f64, np.float64
    elif a.dtype == np.complex128:
        fn, ctype = lib.t4a_rrlu_c128, np.complex128
    else:
        return None
    import ctypes

    A = np.ascontiguousarray(a, dtype=ctype)
    n, m = A.shape
    L = np.zeros((n, max_rank), ctype)
    U = np.zeros((max_rank, m), ctype)
    rows = np.zeros(max_rank, np.int64)
    cols = np.zeros(max_rank, np.int64)
    pivs = np.zeros(max_rank, np.float64)
    lastdrop = np.zeros(1, np.float64)

    def ptr(x):
        return x.ctypes.data_as(ctypes.c_void_p)

    k = int(fn(ptr(A), n, m, float(rtol), float(atol), int(max_rank),
               ptr(L), ptr(U), ptr(rows), ptr(cols), ptr(pivs),
               ptr(lastdrop)))
    return RrLUResult(
        rank=k,
        row_pivots=rows[:k],
        col_pivots=cols[:k],
        L=L[:, :k],
        U=U[:k, :],
        pivot_magnitudes=pivs[:k],
        last_pivot_error=float(lastdrop[0]),
    )


def _rrlu_np(a: np.ndarray, rtol: float, atol: float,
             max_rank: int) -> RrLUResult:
    """Host-numpy twin of `_rrlu_kernel` (identical pivot/stop rule).
    Dispatches to the C++ kernel (native/kernels.cpp) when built."""
    res = _rrlu_native(a, rtol, atol, max_rank)
    if res is not None:
        return res
    A = np.array(a, copy=True)
    n, m = A.shape
    dtype = A.dtype
    L = np.zeros((n, max_rank), dtype)
    U = np.zeros((max_rank, m), dtype)
    rows = np.zeros(max_rank, np.int64)
    cols = np.zeros(max_rank, np.int64)
    pivs = np.zeros(max_rank)
    absA = np.abs(A)
    thresh = max(rtol * float(absA.max()), atol)
    k = 0
    lastdrop = 0.0
    while k < max_rank:
        flat = int(absA.argmax())
        i, j = divmod(flat, m)
        piv = A[i, j]
        pmag = abs(piv)
        if pmag <= thresh:
            lastdrop = float(pmag)
            break
        colv = A[:, j] / piv
        rowv = A[i, :].copy()
        A -= np.outer(colv, rowv)
        A[i, :] = 0.0
        A[:, j] = 0.0
        if np.iscomplexobj(A):
            absA = np.abs(A)
        else:
            np.abs(A, out=absA)
        L[:, k] = colv
        U[k, :] = rowv
        rows[k], cols[k], pivs[k] = i, j, pmag
        k += 1
    return RrLUResult(
        rank=k,
        row_pivots=rows[:k],
        col_pivots=cols[:k],
        L=L[:, :k],
        U=U[:k, :],
        pivot_magnitudes=pivs[:k],
        last_pivot_error=lastdrop,
    )


def rrlu(
    a,
    rtol: float = 1e-12,
    atol: float = 0.0,
    max_rank: Optional[int] = None,
) -> RrLUResult:
    """Rank-revealing full-pivot LU: ``A ≈ L @ U`` with chosen pivots.

    Ref: matrixlu.rs:822 `rrlu` / RrLUOptions :668. `rtol` is relative to
    the largest |entry| of A (the first pivot); elimination stops when the
    next pivot magnitude drops below ``max(rtol*|A|_max, atol)``.
    """
    a = jnp.asarray(a) if not isinstance(a, np.ndarray) else a
    n, m = a.shape
    if max_rank is None:
        max_rank = min(n, m)
    else:
        max_rank = min(max_rank, n, m)
    if max_rank == 0 or n == 0 or m == 0:
        return RrLUResult(0, np.zeros(0, np.int64), np.zeros(0, np.int64),
                          jnp.zeros((n, 0), a.dtype), jnp.zeros((0, m), a.dtype),
                          np.zeros(0), 0.0)
    if _host_small(a):
        return _rrlu_np(np.asarray(a), float(rtol), float(atol), max_rank)
    # bucket the operand shape (zero padding is exact: padded rows/cols
    # have zero residual and are never selected) so data-dependent Pi
    # shapes inside TCI sweeps reuse a handful of compiled kernels
    nb = _bucket(n)
    mb = _bucket(m)
    if (nb, mb) != (n, m):
        a = jnp.pad(a, ((0, nb - n), (0, mb - m)))
    kernel_rank = min(nb, mb)
    if kernel_rank >= 128:
        # large operands: the blocked-rook kernel (panel GEMV walks +
        # GEMM block refresh) in place of the one-pivot-per-step loop
        Lb, Ub, meta = _rrlu_kernel_blocked(
            a, float(rtol), float(atol), int(kernel_rank), 32,
            jnp.int32(max_rank)
        )
    else:
        Lb, Ub, meta = _rrlu_kernel(
            a, float(rtol), float(atol), int(kernel_rank), int(max_rank)
        )
    meta = np.asarray(meta)  # single device->host transfer
    rows = meta[:kernel_rank]
    cols = meta[kernel_rank:2 * kernel_rank]
    pivs = meta[2 * kernel_rank:3 * kernel_rank]
    rank = int(meta[3 * kernel_rank])
    lastdrop = float(meta[3 * kernel_rank + 1])
    if rank > max_rank:
        # the blocked kernel caps at the buffer size, not the caller's
        # max_rank; LU is nested, so truncating to the first max_rank
        # pivots IS the rank-capped factorization
        lastdrop = float(pivs[max_rank])
        rank = max_rank
    Lb = Lb[:n]
    Ub = Ub[:, :m]
    return RrLUResult(
        rank=rank,
        row_pivots=rows[:rank].astype(np.int64),
        col_pivots=cols[:rank].astype(np.int64),
        L=Lb[:, :rank],
        U=Ub[:rank, :],
        pivot_magnitudes=pivs[:rank],
        last_pivot_error=lastdrop,
    )


def matrix_ci_factors(
    a,
    rtol: float = 1e-12,
    max_rank: Optional[int] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, np.ndarray, np.ndarray, float]:
    """LU-based cross interpolation of a dense matrix.

    Ref: matrix_luci.rs:365 `matrix_luci_factors_from_matrix`. Returns
    ``(left, right, row_pivots, col_pivots, error)`` with
    ``A ≈ left @ right``, ``left = A[:,J] inv(A[I,J])`` (identity at rows
    I), ``right = A[I,:]``.
    """
    res = rrlu(a, rtol=rtol, max_rank=max_rank)
    if res.rank == 0:
        n, m = jnp.asarray(a).shape
        return (jnp.zeros((n, 0)), jnp.zeros((0, m)),
                res.row_pivots, res.col_pivots, res.last_pivot_error)
    left, right = res.ci_factors()
    return left, right, res.row_pivots, res.col_pivots, res.last_pivot_error


@dataclasses.dataclass
class LuciFactors:
    """Cross-interpolation factors ``A ~= left @ right``.

    Ref: matrix_luci.rs:48 `MatrixLUCI` results. With
    ``left_orthogonal=True`` the left factor interpolates (identity at
    pivot rows); otherwise the right factor does (identity at pivot
    columns). ``pivot_errors`` lists the accepted pivot magnitudes
    followed by the first discarded one (0.0 at full rank, the last
    accepted one when the rank cap was hit) — same convention as the
    reference's `RrLU::pivot_errors`.
    """

    rank: int
    row_indices: np.ndarray
    col_indices: np.ndarray
    left: Optional[jnp.ndarray]
    right: Optional[jnp.ndarray]
    pivot_errors: np.ndarray

    @property
    def last_pivot_error(self) -> float:
        return float(self.pivot_errors[-1])


def _finalize_pivot_errors(pivs: np.ndarray, rank: int, full_rank: int,
                           max_rank: int, lastdrop: float) -> np.ndarray:
    """Reference convention (matrixlu.rs / block_rook.rs:180-186)."""
    if rank >= full_rank:
        last = 0.0
    elif rank >= max_rank and rank > 0:
        # pivs may hold fewer entries than rank (warm-started rook only
        # tracks NEW pivots): fall back to the newest magnitude available
        last = float(pivs[-1]) if len(pivs) else float(lastdrop)
    else:
        last = float(lastdrop)
    return np.concatenate([pivs[: min(rank, len(pivs))], [last]])


def luci_factors_from_matrix(
    a,
    rel_tol: float = 1e-14,
    abs_tol: float = 0.0,
    max_rank: Optional[int] = None,
    left_orthogonal: bool = True,
    compute_factors: bool = True,
) -> LuciFactors:
    """LU-based CI with the reference's RrLUOptions semantics.

    Ref: matrix_luci.rs:365 `matrix_luci_factors_from_matrix` +
    RrLUOptions (matrixlu.rs:668): ``rel_tol`` is relative to the largest
    accepted pivot, ``left_orthogonal`` picks which factor interpolates.
    """
    # numpy operands stay host-side (device_put per Pi matrix costs more
    # than the whole factorization at TCI bond sizes)
    if not isinstance(a, np.ndarray):
        a = jnp.asarray(a)
    n, m = a.shape
    full_rank = min(n, m)
    cap = full_rank if max_rank is None else min(max_rank, full_rank)
    res = rrlu(a, rtol=rel_tol, atol=abs_tol, max_rank=cap)
    errs = _finalize_pivot_errors(res.pivot_magnitudes, res.rank, full_rank,
                                  cap, res.last_pivot_error)
    if res.rank == 0:
        return LuciFactors(0, res.row_pivots, res.col_pivots,
                           jnp.zeros((n, 0), a.dtype),
                           jnp.zeros((0, m), a.dtype), errs)
    left = right = None
    if compute_factors:
        if left_orthogonal:
            left, right = res.ci_factors()
        else:
            # A[:,J] = L @ U[:,J];  inv(P) A[I,:] = inv(U_J) U  (U_J upper
            # triangular by the pivot ordering)
            UJ = res.U[:, res.col_pivots]
            left = res.L @ UJ
            if isinstance(res.U, np.ndarray):
                import scipy.linalg as sla

                right = sla.solve_triangular(UJ, res.U, lower=False)
            else:
                right = jax.scipy.linalg.solve_triangular(UJ, res.U,
                                                          lower=False)
    return LuciFactors(res.rank, res.row_pivots, res.col_pivots, left, right,
                       errs)


def luci_rook_from_blocks(
    nrows: int,
    ncols: int,
    fill_block,
    rel_tol: float = 1e-14,
    abs_tol: float = 0.0,
    max_rank: Optional[int] = None,
    initial_rows: Optional[Sequence[int]] = None,
    initial_cols: Optional[Sequence[int]] = None,
) -> LuciFactors:
    """Lazy block-rook cross interpolation: pivots without materializing
    the full candidate matrix.

    Ref: matrixluci/block_rook.rs:1-214 (`LazyBlockRookKernel`,
    `rook_pivot`, `factorize_lazy`). ``fill_block(rows, cols)`` returns
    the requested submatrix as a numpy array — in TCI this is a batched
    (memoized) function evaluation, so the rook path's saving is real
    f-evals, not just matrix arithmetic. Factor matrices are NOT computed
    here (the reference's TCI sweep fills site tensors separately); only
    pivot indices and errors are returned.
    """
    full_rank = min(nrows, ncols)
    cap = full_rank if max_rank is None else min(max_rank, full_rank)
    # warm start: accepted pivots from a previous sweep (the incremental
    # ACA path of TCI1, ref tensorci1.rs / matrixaca.rs)
    sel_r: list = list(initial_rows or [])
    sel_c: list = list(initial_cols or [])
    if len(sel_r) != len(sel_c):
        raise ValueError("initial pivot row/col counts differ")
    accepted: list = []
    max_err = 0.0
    last_err = np.nan
    eps = np.finfo(np.float64).eps

    def residual(rows, cols):
        R = np.asarray(fill_block(rows, cols))
        if not sel_r:
            return R
        P = np.asarray(fill_block(sel_r, sel_c))
        A_rj = np.asarray(fill_block(rows, sel_c))
        A_ic = np.asarray(fill_block(sel_r, cols))
        return R - A_rj @ np.linalg.solve(P, A_ic)

    while len(sel_r) < cap:
        rem_r = [i for i in range(nrows) if i not in set(sel_r)]
        rem_c = [j for j in range(ncols) if j not in set(sel_c)]
        if not rem_r or not rem_c:
            break
        # rook walk: alternate best-row-in-column / best-column-in-row
        cur_col = rem_c[0]
        cur_row = rem_r[0]
        piv_abs = 0.0
        for _ in range(len(rem_r) + len(rem_c) + 1):
            col_res = residual(rem_r, [cur_col])
            cur_row = rem_r[int(np.argmax(np.abs(col_res[:, 0])))]
            row_res = residual([cur_row], rem_c)
            jbest = int(np.argmax(np.abs(row_res[0, :])))
            piv_abs = float(np.abs(row_res[0, jbest]))
            next_col = rem_c[jbest]
            if next_col == cur_col:
                break
            cur_col = next_col
        last_err = piv_abs
        if sel_r and (piv_abs < rel_tol * max_err or piv_abs < abs_tol):
            break
        if piv_abs < eps:
            break
        max_err = max(max_err, piv_abs)
        sel_r.append(cur_row)
        sel_c.append(cur_col)
        accepted.append(piv_abs)

    rank = len(sel_r)
    errs = _finalize_pivot_errors(np.asarray(accepted, np.float64), rank,
                                  full_rank, cap,
                                  0.0 if np.isnan(last_err) else last_err)
    return LuciFactors(rank, np.asarray(sel_r, np.int64),
                       np.asarray(sel_c, np.int64), None, None, errs)


def factorize_matrix_lu(
    m,
    policy,
    variant: str = "lu",
    canonical: str = "right",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Two-factor LU/CI split used by TT compression (ref compression.rs
    CompressionMethod::{LU, CI}).

    `policy` is an SvdTruncationPolicy; its tol is interpreted as the rrLU
    relative pivot tolerance, maxdim as the rank cap. `canonical='right'`
    returns (left, right) where `right` rows are actual matrix rows
    (CI form: well-conditioned carrier for further sweeping).
    """
    rtol = policy.tol if policy.scale.name == "RELATIVE" else 0.0
    atol = policy.tol if policy.scale.name == "ABSOLUTE" else 0.0
    res = rrlu(m, rtol=rtol, atol=atol, max_rank=policy.maxdim)
    if res.rank == 0:
        # zero matrix: rank-1 zero factorization keeps TT structure valid
        n, mm = jnp.asarray(m).shape
        return jnp.zeros((n, 1), res.L.dtype), jnp.zeros((1, mm), res.U.dtype)
    left, right = res.ci_factors()
    if variant == "lu" and canonical == "left":
        return res.L, res.U  # unused currently; parity hook
    return left, right


def factorize_lu(t, left_inds, alg, canonical, policy, link_tags="Link"):
    """Tensor-level LU/CI factorize (core.decomp.factorize dispatch target)."""
    from ..config import SvdTruncationPolicy
    from ..core.decomp import _split_matrixize
    from ..core.index import Index
    from ..core.tensor import Tensor

    if policy is None:
        policy = SvdTruncationPolicy(tol=1e-12)
    a, left, right = _split_matrixize(t, left_inds)
    lf, rf = factorize_matrix_lu(a, policy, variant=alg.value,
                                 canonical="right")
    r = lf.shape[1]
    bond = Index(r, tags=link_tags)
    L = Tensor(tuple(left) + (bond,), lf.reshape([i.dim for i in left] + [r]))
    R = Tensor((bond,) + tuple(right), rf.reshape([r] + [i.dim for i in right]))
    return L, R, None
