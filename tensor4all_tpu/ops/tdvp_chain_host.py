"""Host-numpy two-site TDVP chain engine — the CPU-backend sibling of
``ops.tdvp_chain.tdvp_run``.

Same Lubich projector-splitting integrator (order 1/2) and the same
environment/einsum conventions as the jitted engine, but executed as
one host loop over BLAS tensordots with ADAPTIVE bond ranks and an
early-exit Lanczos propagator. The journal's chain-TDVP config
(N=8, chi=32, ref tdvp/mod.rs:1101 + BASELINE.md) is latency-bound:
every XLA dispatch costs ~0.1-0.3 ms on a CPU host and padded static
shapes waste FLOPs at tiny ranks, so the host loop wins by an order of
magnitude there. On an accelerator use ``tdvp_chain`` (one compiled
program).

Ref: tensor4all-treetn/src/tdvp/mod.rs:1101 (sweep order, the
backward-evolved one-site step between bonds, adaptive truncation).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def _lanczos_expm_np(apply_a, v0: np.ndarray, t: complex,
                     maxiter: int = 30, rtol: float = 1e-12) -> np.ndarray:
    """``exp(t A) v0`` for Hermitian A on raw ndarrays (early exit)."""
    shape = v0.shape
    v = v0.reshape(-1)
    n0 = np.linalg.norm(v)
    if n0 == 0:
        return v0
    q = v / n0
    Q = [q]
    alphas: List[float] = []
    betas: List[float] = []
    coef = None
    for k in range(maxiter):
        w = apply_a(Q[k].reshape(shape)).reshape(-1)
        a_k = np.vdot(Q[k], w).real
        alphas.append(a_k)
        w = w - a_k * Q[k]
        if k > 0:
            w = w - betas[-1] * Q[k - 1]
        # full reorthogonalization (cheap at these m)
        for qi in Q:
            w = w - np.vdot(qi, w) * qi
        b_k = np.linalg.norm(w)
        T = np.diag(alphas)
        if betas:
            T += np.diag(betas, 1) + np.diag(betas, -1)
        evals, evecs = np.linalg.eigh(T)
        new_coef = evecs @ (np.exp(t * evals) * evecs[0, :].conj())
        if coef is not None and abs(new_coef[-1]) <= rtol * np.linalg.norm(
                new_coef):
            coef = new_coef
            break
        coef = new_coef
        if b_k <= 1e-14 * max(1.0, abs(a_k)):
            break
        betas.append(b_k)
        Q.append(w / b_k)
    x = np.zeros_like(v, dtype=np.result_type(v.dtype, type(coef[0])))
    for c, qi in zip(coef, Q):
        x += c * qi
    return (n0 * x).reshape(shape)


def _apply_h2(L, W1, W2, R, theta):
    # L (a,l,x), W (l,p,i,r), theta (a,i,j,b), R (b,s,B) -> (x,p,q,B)
    t1 = np.tensordot(L, theta, axes=([0], [0]))      # (l,x,i,j,b)
    t2 = np.tensordot(t1, W1, axes=([0, 2], [0, 2]))  # (x,j,b,p,r)
    t3 = np.tensordot(t2, W2, axes=([4, 1], [0, 2]))  # (x,b,p,q,s)
    return np.tensordot(t3, R, axes=([1, 4], [0, 1]))


def _apply_h1(L, W, R, A):
    t1 = np.tensordot(L, A, axes=([0], [0]))          # (l,x,i,b)
    t2 = np.tensordot(t1, W, axes=([0, 2], [0, 2]))   # (x,b,p,r)
    return np.tensordot(t2, R, axes=([1, 3], [0, 1]))


def _update_left_env(L, A, W):
    t1 = np.tensordot(L, A, axes=([0], [0]))          # (l,x,i,b)
    t2 = np.tensordot(t1, W, axes=([0, 2], [0, 2]))   # (x,b,o,r)
    return np.tensordot(t2, A.conj(), axes=([0, 2], [0, 1]))  # (b,r,B)


def _update_right_env(R, A, W):
    t1 = np.tensordot(R, A, axes=([0], [2]))          # (r,B,a,i)
    t2 = np.tensordot(t1, W, axes=([0, 3], [3, 2]))   # (B,a,l,o)
    return np.tensordot(t2, A.conj(), axes=([0, 3], [2, 1]))  # (a,l,x)


def _right_orthogonalize(cores):
    for k in range(len(cores) - 1, 0, -1):
        Dl, d, Dr = cores[k].shape
        m = cores[k].reshape(Dl, d * Dr)
        q, r = np.linalg.qr(m.conj().T)
        rk = q.shape[1]
        cores[k] = q.conj().T.reshape(rk, d, Dr)
        cores[k - 1] = np.tensordot(cores[k - 1], r.conj().T,
                                    axes=([2], [0]))
    return cores


def _split(theta, tol, chi, toward_right):
    Dl, d0, d1, Dr = theta.shape
    m = theta.reshape(Dl * d0, d1 * Dr)
    u, s, vh = np.linalg.svd(m, full_matrices=False)
    scale = s[0] if s.size and s[0] > 0 else 1.0
    r = max(int(np.sum(s >= tol * scale)), 1)
    r = min(r, chi)
    if toward_right:
        left = u[:, :r].reshape(Dl, d0, r)
        right = (s[:r, None] * vh[:r]).reshape(r, d1, Dr)
    else:
        left = (u[:, :r] * s[:r]).reshape(Dl, d0, r)
        right = vh[:r].reshape(r, d1, Dr)
    return left, right


def tdvp_chain_host(
    h_cores: Sequence[np.ndarray],
    init_cores: Sequence[np.ndarray],
    t: complex,
    chi: int,
    nsteps: int = 1,
    order: int = 2,
    tol: float = 1e-12,
    krylov_rtol: float = 1e-12,
    krylov_maxiter: int = 30,
) -> List[np.ndarray]:
    """Evolve ``exp(t*H)|mps>`` on the host; returns adaptive cores.

    Same contract as `tdvp_chain` (which returns a padded device
    array); use this engine on CPU hosts where dispatch latency
    dominates.
    """
    if order not in (1, 2):
        raise ValueError("order must be 1 or 2")
    W = [np.asarray(w) for w in h_cores]
    dtype = np.result_type(np.complex128 if isinstance(t, complex)
                           else np.float64,
                           *[np.asarray(c).dtype for c in init_cores])
    A = [np.asarray(c).astype(dtype) for c in init_cores]
    N = len(A)
    A = _right_orthogonalize(A)
    A[0] = A[0] / np.linalg.norm(A[0])
    one = np.ones((1, 1, 1), dtype)
    dt = t / nsteps
    delta = dt / 2.0 if order == 2 else dt

    def forward(delta):
        # right environments: Renv[k] = sites k..N-1 contracted
        Renv = [None] * (N + 1)
        Renv[N] = one
        for k in range(N - 1, 1, -1):
            Renv[k] = _update_right_env(Renv[k + 1], A[k], W[k])
        Ls = [None] * (N - 1)
        L = one
        for k in range(N - 1):
            Ls[k] = L
            R = Renv[k + 2] if k + 2 <= N else one
            theta = np.tensordot(A[k], A[k + 1], axes=([2], [0]))
            theta = _lanczos_expm_np(
                lambda th: _apply_h2(L, W[k], W[k + 1], R, th), theta,
                delta, krylov_maxiter, krylov_rtol)
            A[k], right = _split(theta, tol, chi, toward_right=True)
            L = _update_left_env(L, A[k], W[k])
            if k < N - 2:
                right = _lanczos_expm_np(
                    lambda v: _apply_h1(L, W[k + 1], R, v), right,
                    -delta, krylov_maxiter, krylov_rtol)
            A[k + 1] = right
        return Ls

    def backward(delta, Ls):
        R = one
        for k in range(N - 2, -1, -1):
            theta = np.tensordot(A[k], A[k + 1], axes=([2], [0]))
            theta = _lanczos_expm_np(
                lambda th: _apply_h2(Ls[k], W[k], W[k + 1], R, th),
                theta, delta, krylov_maxiter, krylov_rtol)
            left, A[k + 1] = _split(theta, tol, chi, toward_right=False)
            R = _update_right_env(R, A[k + 1], W[k + 1])
            if k > 0:
                left = _lanczos_expm_np(
                    lambda v: _apply_h1(Ls[k], W[k], R, v), left,
                    -delta, krylov_maxiter, krylov_rtol)
            A[k] = left
        return A

    for _ in range(nsteps):
        Ls = forward(delta)
        if order == 2:
            backward(delta, Ls)
        else:
            _right_orthogonalize(A)
    return A


def dmrg_chain_host(
    h_cores: Sequence[np.ndarray],
    init_cores: Sequence[np.ndarray],
    chi: int,
    n_sweeps: int = 4,
    tol: float = 1e-12,
    lanczos_iters: int = 30,
    lanczos_rtol: float = 1e-12,
):
    """Host-numpy two-site DMRG sibling (ref dmrg.rs sweep structure):
    adaptive ranks, early-exit Lanczos ground-state solves. Returns
    ``(energy, cores, per_sweep_energies)``. Use on CPU hosts; `ops.dmrg_chain` is the
    one-program device engine."""
    W = [np.asarray(w) for w in h_cores]
    dtype = np.result_type(np.float64,
                           *[np.asarray(c).dtype for c in init_cores])
    A = [np.asarray(c).astype(dtype) for c in init_cores]
    N = len(A)
    A = _right_orthogonalize(A)
    A[0] = A[0] / np.linalg.norm(A[0])
    one = np.ones((1, 1, 1), dtype)
    energy = None
    energies = []

    def _ground(apply_a, v0, maxiter, rtol):
        shape = v0.shape
        v = v0.reshape(-1)
        n0 = np.linalg.norm(v)
        q = v / n0
        Q = [q]
        alphas, betas = [], []
        e_prev = None
        for k in range(maxiter):
            w = apply_a(Q[k].reshape(shape)).reshape(-1)
            a_k = np.vdot(Q[k], w).real
            alphas.append(a_k)
            w = w - a_k * Q[k]
            if k > 0:
                w = w - betas[-1] * Q[k - 1]
            for qi in Q:
                w = w - np.vdot(qi, w) * qi
            b_k = np.linalg.norm(w)
            T = np.diag(alphas)
            if betas:
                T += np.diag(betas, 1) + np.diag(betas, -1)
            evals, evecs = np.linalg.eigh(T)
            e0 = evals[0]
            if (e_prev is not None
                    and abs(e0 - e_prev) <= rtol * max(1.0, abs(e0))):
                e_prev = e0
                break
            e_prev = e0
            if b_k <= 1e-14 * max(1.0, abs(a_k)):
                break
            betas.append(b_k)
            Q.append(w / b_k)
        g = np.zeros_like(v)
        for c, qi in zip(evecs[:, 0], Q):
            g += c * qi
        return e_prev, g.reshape(shape)

    for _ in range(n_sweeps):
        # forward
        Renv = [None] * (N + 1)
        Renv[N] = one
        for k in range(N - 1, 1, -1):
            Renv[k] = _update_right_env(Renv[k + 1], A[k], W[k])
        Ls = [None] * (N - 1)
        L = one
        for k in range(N - 1):
            Ls[k] = L
            R = Renv[k + 2] if k + 2 <= N else one
            theta = np.tensordot(A[k], A[k + 1], axes=([2], [0]))
            energy, theta = _ground(
                lambda th: _apply_h2(L, W[k], W[k + 1], R, th), theta,
                lanczos_iters, lanczos_rtol)
            theta /= np.linalg.norm(theta)
            A[k], A[k + 1] = _split(theta, tol, chi, toward_right=True)
            L = _update_left_env(L, A[k], W[k])
        # backward
        R = one
        for k in range(N - 2, -1, -1):
            theta = np.tensordot(A[k], A[k + 1], axes=([2], [0]))
            energy, theta = _ground(
                lambda th: _apply_h2(Ls[k], W[k], W[k + 1], R, th),
                theta, lanczos_iters, lanczos_rtol)
            theta /= np.linalg.norm(theta)
            A[k], A[k + 1] = _split(theta, tol, chi, toward_right=False)
            R = _update_right_env(R, A[k + 1], W[k + 1])
        energies.append(float(energy))
    return float(energy), A, energies


def _update_left_benv(Lb, A, Bc):
    # Lb (p,B) x conj(A) (p,i,q) x Bc (B,i,C) -> (q,C)
    t1 = np.tensordot(Lb, Bc, axes=([1], [0]))            # (p,i,C)
    return np.tensordot(A.conj(), t1, axes=([0, 1], [0, 1]))


def _update_right_benv(Rb, A, Bc):
    # Rb (a,B) x conj(A) (q,i,a) x Bc (C,i,B) -> (q,C)
    t1 = np.tensordot(Rb, Bc, axes=([1], [2]))            # (a,C,i)
    return np.tensordot(A.conj(), t1, axes=([2, 1], [0, 2]))


def _local_rhs(Lb, Bk, Bk1, Rb):
    # Lb (a,B) x Bk (B,i,C) x Bk1 (C,j,D) x Rb (e,D) -> (a,i,j,e)
    t1 = np.tensordot(Lb, Bk, axes=([1], [0]))            # (a,i,C)
    t2 = np.tensordot(t1, Bk1, axes=([2], [0]))           # (a,i,j,D)
    return np.tensordot(t2, Rb, axes=([3], [1]))


def _gmres_host(apply_a, b_loc, x0, maxiter, rtol):
    """Host GMRES (full Arnoldi — the local dims are small) on the
    local operator: least squares on the (k+2, k+1) Hessenberg each
    iteration, early exit on the lsq residual (= the true GMRES
    residual norm). No symmetry assumption — arbitrary operators,
    matching the generic square_linsolve path and the reference."""
    shape = x0.shape
    bnorm = np.linalg.norm(b_loc)
    r0 = (b_loc - apply_a(x0)).reshape(-1)
    beta = np.linalg.norm(r0)
    if beta <= rtol * max(bnorm, 1e-300):
        return x0
    V = [r0 / beta]
    Hm = np.zeros((maxiter + 1, maxiter), dtype=r0.dtype)
    y = np.zeros((0,), dtype=r0.dtype)
    for k in range(maxiter):
        w = apply_a(V[k].reshape(shape)).reshape(-1)
        for j in range(k + 1):  # modified Gram-Schmidt
            Hm[j, k] = np.vdot(V[j], w)
            w = w - Hm[j, k] * V[j]
        h = np.linalg.norm(w)
        Hm[k + 1, k] = h
        rhs = np.zeros(k + 2, dtype=r0.dtype)
        rhs[0] = beta
        y = np.linalg.lstsq(Hm[:k + 2, :k + 1], rhs, rcond=None)[0]
        resid = np.linalg.norm(Hm[:k + 2, :k + 1] @ y - rhs)
        if resid <= rtol * max(bnorm, 1e-300) or h <= 1e-14 * beta:
            break
        V.append(w / h)
    dx = np.zeros_like(V[0])
    for c, qi in zip(y, V):
        dx = dx + c * qi
    return (x0.reshape(-1) + dx).reshape(shape)


def linsolve_chain_host(
    h_cores: Sequence[np.ndarray],
    b_cores: Sequence[np.ndarray],
    init_cores: Sequence[np.ndarray],
    a0: float,
    a1: float,
    chi: int,
    n_sweeps: int = 4,
    tol: float = 1e-12,
    gmres_rtol: float = 1e-10,
    gmres_maxiter: int = 60,
    residual_tol: float = 0.0,
):
    """Host-numpy two-site ``(a0 + a1 H) x = b`` sweeps — the adaptive
    sibling of `ops.linsolve_chain.linsolve_run` (ref
    tensor4all-treetn/src/linsolve.rs). Same structure as
    `dmrg_chain_host`, with GMRES local solves against projected-rhs
    environments (no symmetry assumption on H). Returns ``(rel_residual, cores, sweep_residuals)``;
    stops early when `residual_tol` > 0 is reached. The rhs is
    per-core normalized with the scale tracked in log space and folded
    back into the result evenly (one ||b||^(1/N) factor per core)."""
    W = [np.asarray(w) for w in h_cores]
    dtype = np.result_type(np.float64,
                           *[np.asarray(c).dtype for c in init_cores],
                           *[np.asarray(c).dtype for c in b_cores])
    A = [np.asarray(c).astype(dtype) for c in init_cores]
    N = len(A)
    B = []
    log_bscale = 0.0
    for c in b_cores:
        c = np.asarray(c).astype(dtype)
        nc = np.linalg.norm(c)
        if nc > 0:
            c = c / nc
            log_bscale += float(np.log(nc))
        B.append(c)
    A = _right_orthogonalize(A)
    n0 = np.linalg.norm(A[0])
    A[0] = A[0] / (n0 if n0 > 0 else 1.0)
    one = np.ones((1, 1, 1), dtype)
    oneb = np.ones((1, 1), dtype)

    def rel_residual():
        # H-moment transfer scans (see ops.linsolve_chain), f64 host
        Txx = oneb.copy()
        Tbb = oneb.copy()
        Txhx = one.copy()
        Tbx = oneb.copy()
        Tbhx = one.copy()
        Txhhx = np.ones((1, 1, 1, 1), dtype)
        for k in range(N):
            Ak, Wk, Bk = A[k], W[k], B[k]
            t1 = np.tensordot(Txx, Ak, axes=([0], [0]))
            Txx = np.tensordot(t1, Ak.conj(), axes=([0, 1], [0, 1]))
            t1 = np.tensordot(Tbb, Bk, axes=([0], [0]))
            Tbb = np.tensordot(t1, Bk.conj(), axes=([0, 1], [0, 1]))
            Txhx = _update_left_env(Txhx, Ak, Wk)
            t1 = np.tensordot(Tbx, Ak, axes=([0], [0]))
            Tbx = np.tensordot(t1, Bk.conj(), axes=([0, 1], [0, 1]))
            # pairwise BLAS chains (a single multi-operand einsum here
            # greedily contracts W with W first, leaving a scaling-10
            # four-way loop that numpy executes without BLAS)
            t1 = np.tensordot(Tbhx, Ak, axes=([0], [0]))      # (l,c,i,b)
            t2 = np.tensordot(t1, Wk, axes=([0, 2], [0, 2]))  # (c,b,o,r)
            Tbhx = np.tensordot(t2, Bk.conj(),
                                axes=([0, 2], [0, 1]))        # (b,r,C)
            t1 = np.tensordot(Txhhx, Ak, axes=([0], [0]))     # (l,m,x,i,b)
            t2 = np.tensordot(t1, Wk, axes=([0, 3], [0, 2]))  # (m,x,b,o,r)
            t3 = np.tensordot(t2, Wk, axes=([0, 3], [0, 2]))  # (x,b,r,p,q)
            Txhhx = np.tensordot(t3, Ak.conj(),
                                 axes=([0, 3], [0, 1]))       # (b,r,q,B)
        xx = float(np.real(Txx[0, 0]))
        bb = float(np.real(Tbb[0, 0]))
        xhx = float(np.real(Txhx[0, 0, 0]))
        bx = float(np.real(Tbx[0, 0]))
        bhx = float(np.real(Tbhx[0, 0, 0]))
        xhhx = float(np.real(Txhhx[0, 0, 0, 0]))
        r2 = (a0 ** 2 * xx + 2 * a0 * a1 * xhx + a1 ** 2 * xhhx
              - 2 * (a0 * bx + a1 * bhx) + bb)
        mag = (a0 ** 2 * abs(xx) + 2 * abs(a0 * a1 * xhx)
               + a1 ** 2 * abs(xhhx)
               + 2 * (abs(a0 * bx) + abs(a1 * bhx)) + abs(bb))
        floor = np.finfo(np.float64).eps * mag
        return float(np.sqrt(max(r2, floor) / max(bb, 1e-300)))

    sweep_residuals = []
    rel = None
    for _ in range(n_sweeps):
        Renv = [None] * (N + 1)
        Renv[N] = one
        Rbenv = [None] * (N + 1)
        Rbenv[N] = oneb
        for k in range(N - 1, 1, -1):
            Renv[k] = _update_right_env(Renv[k + 1], A[k], W[k])
            Rbenv[k] = _update_right_benv(Rbenv[k + 1], A[k], B[k])
        Ls = [None] * (N - 1)
        Lbs = [None] * (N - 1)
        L, Lb = one, oneb
        for k in range(N - 1):
            Ls[k], Lbs[k] = L, Lb
            R = Renv[k + 2] if k + 2 <= N else one
            Rb = Rbenv[k + 2] if k + 2 <= N else oneb
            theta0 = np.tensordot(A[k], A[k + 1], axes=([2], [0]))
            b_loc = _local_rhs(Lb, B[k], B[k + 1], Rb)

            def apply_loc(th):
                return a0 * th + a1 * _apply_h2(L, W[k], W[k + 1], R, th)

            theta = _gmres_host(apply_loc, b_loc, theta0,
                                gmres_maxiter, gmres_rtol)
            A[k], A[k + 1] = _split(theta, tol, chi, toward_right=True)
            L = _update_left_env(L, A[k], W[k])
            Lb = _update_left_benv(Lb, A[k], B[k])
        R, Rb = one, oneb
        for k in range(N - 2, -1, -1):
            theta0 = np.tensordot(A[k], A[k + 1], axes=([2], [0]))
            b_loc = _local_rhs(Lbs[k], B[k], B[k + 1], Rb)
            Lk = Ls[k]

            def apply_loc(th):
                return a0 * th + a1 * _apply_h2(Lk, W[k], W[k + 1], R,
                                                th)

            theta = _gmres_host(apply_loc, b_loc, theta0,
                                gmres_maxiter, gmres_rtol)
            A[k], A[k + 1] = _split(theta, tol, chi, toward_right=False)
            R = _update_right_env(R, A[k + 1], W[k + 1])
            Rb = _update_right_benv(Rb, A[k + 1], B[k + 1])
        rel = rel_residual()
        sweep_residuals.append(rel)
        if residual_tol > 0 and rel < residual_tol:
            break
    s = np.exp(log_bscale / N)
    A = [c * s for c in A]
    return rel, A, sweep_residuals
