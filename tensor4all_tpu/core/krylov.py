"""Krylov solvers generic over a tensor vector space.

JAX rebuild of tensor4all-core/src/krylov.rs (`gmres` :889,
`hermitian_lanczos_lowest_eigenpair` :484, `hermitian_krylov_expm_multiply`
:640, restarted GMRES with truncation :2213).

The operand type only needs the `TensorVectorSpace` protocol
(ref tensor_like.rs:579): axpby / inner / norm / scale — satisfied by
``core.Tensor``, ``tt.TensorTrain`` (with truncation hooks), and plain jax
arrays via the `ArrayVS` adapter. Small dense Krylov subspace problems
(Hessenberg solves, tridiagonal eigs, expm) run on host-side jnp — they
are tiny; the heavy work is the caller's operator application.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Generic, List, Optional, Sequence, TypeVar

import jax.numpy as jnp
import numpy as np

V = TypeVar("V")


class VectorSpace:
    """Protocol adapter: override for non-Tensor operand types."""

    def axpby(self, a, x, b, y):  # a*x + b*y
        return y.axpby(a, x, b)

    def inner(self, x, y):  # <x|y>, conjugate-linear in x
        return complex(x.inner(y))

    def norm(self, x) -> float:
        return float(x.norm())

    def scale(self, a, x):
        return x * a

    def post(self, x):
        """Hook applied after every vector update (e.g. TT truncation —
        ref restart_gmres_with_truncation)."""
        return x


class ArrayVS(VectorSpace):
    def axpby(self, a, x, b, y):
        return a * x + b * y

    def inner(self, x, y):
        return complex(jnp.vdot(x, y))

    def norm(self, x):
        return float(jnp.linalg.norm(x))

    def scale(self, a, x):
        return a * x


@dataclasses.dataclass
class GmresOpProfile:
    """Per-phase wall-clock accounting (ref krylov.rs:49-70 GMRES op
    profile): seconds and call counts per vector-space operation."""

    apply_s: float = 0.0
    inner_s: float = 0.0
    axpby_s: float = 0.0
    norm_s: float = 0.0
    scale_s: float = 0.0
    post_s: float = 0.0
    apply_calls: int = 0
    inner_calls: int = 0
    axpby_calls: int = 0
    norm_calls: int = 0
    scale_calls: int = 0
    post_calls: int = 0

    def report(self) -> str:
        rows = []
        for op in ("apply", "inner", "axpby", "norm", "scale", "post"):
            rows.append(f"{op}: {getattr(self, op + '_s'):.6f}s "
                        f"x{getattr(self, op + '_calls')}")
        return "; ".join(rows)


class _ProfiledVS:
    """VectorSpace wrapper recording per-op timings."""

    def __init__(self, vs: "VectorSpace", prof: GmresOpProfile):
        self._vs = vs
        self._p = prof

    def _timed(self, name, fn, *args):
        import time as _t

        t0 = _t.perf_counter()
        out = fn(*args)
        setattr(self._p, name + "_s",
                getattr(self._p, name + "_s") + _t.perf_counter() - t0)
        setattr(self._p, name + "_calls",
                getattr(self._p, name + "_calls") + 1)
        return out

    def axpby(self, a, x, b, y):
        return self._timed("axpby", self._vs.axpby, a, x, b, y)

    def inner(self, x, y):
        return self._timed("inner", self._vs.inner, x, y)

    def norm(self, x):
        return self._timed("norm", self._vs.norm, x)

    def scale(self, a, x):
        return self._timed("scale", self._vs.scale, a, x)

    def post(self, x):
        return self._timed("post", self._vs.post, x)


@dataclasses.dataclass
class GmresResult(Generic[V]):
    """Ref: GmresResult (krylov.rs:230)."""

    x: V
    residual_norms: List[float]
    converged: bool
    n_iter: int
    profile: Optional[GmresOpProfile] = None


def gmres(
    apply_a: Callable[[V], V],
    b: V,
    x0: Optional[V] = None,
    vs: Optional[VectorSpace] = None,
    rtol: float = 1e-10,
    atol: float = 0.0,
    maxiter: int = 100,
    restart: Optional[int] = None,
    profile: bool = False,
) -> GmresResult:
    """Restarted GMRES for ``A x = b`` (ref krylov.rs:889).

    Modified Gram-Schmidt Arnoldi; the (m+1, m) Hessenberg least-squares
    problem is solved densely on host per restart cycle. With
    ``profile=True`` the result carries per-op wall-clock accounting
    (ref krylov.rs:49-70).
    """
    vs = vs or VectorSpace()
    prof = None
    if profile:
        import time as _t

        prof = GmresOpProfile()
        base_apply = apply_a
        vs = _ProfiledVS(vs, prof)

        def apply_a(x, _f=base_apply, _p=prof):  # noqa: F811
            t0 = _t.perf_counter()
            out = _f(x)
            _p.apply_s += _t.perf_counter() - t0
            _p.apply_calls += 1
            return out

    restart = restart or maxiter
    bnorm = vs.norm(b)
    target = max(rtol * bnorm, atol)
    if bnorm == 0.0:
        return GmresResult(vs.scale(0.0, b), [0.0], True, 0, prof)
    x = x0
    res_norms: List[float] = []
    total = 0
    while total < maxiter:
        if x is None:
            r = b
        else:
            r = vs.axpby(1.0, b, -1.0, vs.post(apply_a(x)))
        rnorm = vs.norm(r)
        res_norms.append(rnorm)
        if rnorm <= target:
            return GmresResult(x if x is not None else vs.scale(0.0, b),
                               res_norms, True, total, prof)
        m = min(restart, maxiter - total)
        Vk: List[V] = [vs.scale(1.0 / rnorm, r)]
        H = np.zeros((m + 1, m), dtype=complex)
        k_used = 0
        for k in range(m):
            w = vs.post(apply_a(Vk[k]))
            for i in range(k + 1):
                H[i, k] = vs.inner(Vk[i], w)
                w = vs.axpby(-H[i, k], Vk[i], 1.0, w)
            H[k + 1, k] = vs.norm(w)
            k_used = k + 1
            total += 1
            # solve the small least-squares for current residual estimate
            e1 = np.zeros(k + 2, dtype=complex)
            e1[0] = rnorm
            y, res, _, _ = np.linalg.lstsq(H[: k + 2, : k + 1], e1, rcond=None)
            est = np.linalg.norm(H[: k + 2, : k + 1] @ y - e1)
            if H[k + 1, k].real <= 1e-14 * rnorm or est <= target or total >= maxiter:
                break
            Vk.append(vs.scale(1.0 / H[k + 1, k], w))
        e1 = np.zeros(k_used + 1, dtype=complex)
        e1[0] = rnorm
        y, _, _, _ = np.linalg.lstsq(H[: k_used + 1, :k_used], e1, rcond=None)
        dx = None
        for i in range(k_used):
            coef = y[i]
            if abs(coef) == 0:
                continue
            dx = vs.scale(coef, Vk[i]) if dx is None else vs.axpby(
                coef, Vk[i], 1.0, dx
            )
        if dx is not None:
            x = dx if x is None else vs.post(vs.axpby(1.0, dx, 1.0, x))
    if x is None:
        x = vs.scale(0.0, b)
    r = vs.axpby(1.0, b, -1.0, vs.post(apply_a(x)))
    rnorm = vs.norm(r)
    res_norms.append(rnorm)
    return GmresResult(x, res_norms, rnorm <= target, total, prof)


def gmres_affine(
    apply_a: Callable[[V], V],
    b: V,
    x0: Optional[V] = None,
    a0: complex = 0.0,
    a1: complex = 1.0,
    vs: Optional[VectorSpace] = None,
    rtol: float = 1e-10,
    atol: float = 0.0,
    maxiter: int = 100,
    restart: Optional[int] = None,
) -> GmresResult:
    """Solve ``(a0 I + a1 A) x = b`` with the KrylovKit affine convention
    (ref krylov.rs:934 gmres_affine): the Arnoldi basis is built from the
    UNSHIFTED ``A``; the affine coefficients enter only the projected
    Hessenberg problem, so affine shifts never change the Krylov basis."""
    vs = vs or VectorSpace()

    def apply_affine(x):
        # never materialize a0 I + a1 A at the operator level — wrap the
        # small problem instead; here we only need residual computations
        y = vs.scale(a1, vs.post(apply_a(x)))
        if a0 != 0:
            y = vs.axpby(a0, x, 1.0, y)
        return y

    restart = restart or maxiter
    bnorm = vs.norm(b)
    target = max(rtol * bnorm, atol)
    if bnorm == 0.0:
        return GmresResult(vs.scale(0.0, b), [0.0], True, 0)
    x = x0
    res_norms: List[float] = []
    total = 0
    while total < maxiter:
        r = b if x is None else vs.axpby(1.0, b, -1.0, apply_affine(x))
        rnorm = vs.norm(r)
        res_norms.append(rnorm)
        if rnorm <= target:
            return GmresResult(x if x is not None else vs.scale(0.0, b),
                               res_norms, True, total)
        m = min(restart, maxiter - total)
        Vk: List[V] = [vs.scale(1.0 / rnorm, r)]
        H = np.zeros((m + 1, m), dtype=complex)
        k_used = 0
        for k in range(m):
            # basis from the UNSHIFTED operator (KrylovKit convention)
            w = vs.post(apply_a(Vk[k]))
            for i in range(k + 1):
                H[i, k] = vs.inner(Vk[i], w)
                w = vs.axpby(-H[i, k], Vk[i], 1.0, w)
            H[k + 1, k] = vs.norm(w)
            k_used = k + 1
            total += 1
            # affine-shifted projected problem: a0 I + a1 H
            Ha = a1 * H[: k + 2, : k + 1]
            Ha[: k + 1, : k + 1] += a0 * np.eye(k + 1)
            e1 = np.zeros(k + 2, dtype=complex)
            e1[0] = rnorm
            y, _, _, _ = np.linalg.lstsq(Ha, e1, rcond=None)
            est = np.linalg.norm(Ha @ y - e1)
            if (H[k + 1, k].real <= 1e-14 * max(rnorm, 1e-300)
                    or est <= target or total >= maxiter):
                break
            Vk.append(vs.scale(1.0 / H[k + 1, k], w))
        Ha = a1 * H[: k_used + 1, :k_used]
        Ha[:k_used, :k_used] += a0 * np.eye(k_used)
        e1 = np.zeros(k_used + 1, dtype=complex)
        e1[0] = rnorm
        y, _, _, _ = np.linalg.lstsq(Ha, e1, rcond=None)
        dx = None
        for i in range(k_used):
            if abs(y[i]) == 0:
                continue
            dx = vs.scale(y[i], Vk[i]) if dx is None else vs.axpby(
                y[i], Vk[i], 1.0, dx)
        if dx is not None:
            x = dx if x is None else vs.post(vs.axpby(1.0, dx, 1.0, x))
    if x is None:
        x = vs.scale(0.0, b)
    r = vs.axpby(1.0, b, -1.0, apply_affine(x))
    rnorm = vs.norm(r)
    res_norms.append(rnorm)
    return GmresResult(x, res_norms, rnorm <= target, total)


@dataclasses.dataclass
class RestartGmresOptions:
    """Ref: RestartGmresOptions (krylov.rs:141-181)."""

    rtol: float = 1e-10
    max_iter: int = 30  # inner cycle length
    max_restarts: int = 10


@dataclasses.dataclass
class RestartGmresResult(Generic[V]):
    solution: V
    iterations: int
    outer_iterations: int
    residual_norm: float
    converged: bool


def restart_gmres_with_truncation(
    apply_a: Callable[[V], V],
    b: V,
    x0: Optional[V] = None,
    options: Optional[RestartGmresOptions] = None,
    truncate: Optional[Callable[[V], V]] = None,
    vs: Optional[VectorSpace] = None,
) -> RestartGmresResult:
    """Restarted GMRES with an operand truncation between cycles (ref
    krylov.rs:2213 restart_gmres_with_truncation): each outer iteration
    solves the residual equation ``A dx = r`` with plain GMRES, applies
    ``x <- truncate(x + dx)``, and re-measures the TRUE residual — the
    pattern that keeps TT/TreeTN ranks bounded across restarts."""
    opts = options or RestartGmresOptions()
    vs = vs or VectorSpace()
    trunc = truncate or (lambda x: x)
    bnorm = vs.norm(b)
    if bnorm < 1e-15:
        sol = x0 if x0 is not None else vs.scale(0.0, b)
        return RestartGmresResult(sol, 0, 0, 0.0, True)
    x = x0
    total = 0
    rnorm = bnorm
    for outer in range(opts.max_restarts):
        r = b if x is None else vs.axpby(1.0, b, -1.0,
                                         vs.post(apply_a(x)))
        rnorm = vs.norm(r)
        if rnorm <= opts.rtol * bnorm:
            sol = x if x is not None else vs.scale(0.0, b)
            return RestartGmresResult(sol, total, outer, rnorm, True)
        inner = gmres(apply_a, r, vs=vs, rtol=0.1 * opts.rtol * bnorm
                      / max(rnorm, 1e-300), maxiter=opts.max_iter)
        total += inner.n_iter
        dx = inner.x
        x = dx if x is None else vs.axpby(1.0, dx, 1.0, x)
        x = trunc(x)
    r = b if x is None else vs.axpby(1.0, b, -1.0, vs.post(apply_a(x)))
    rnorm = vs.norm(r)
    sol = x if x is not None else vs.scale(0.0, b)
    return RestartGmresResult(sol, total, opts.max_restarts, rnorm,
                              rnorm <= opts.rtol * bnorm)


def hermitian_lanczos_lowest_eigenpair(
    apply_a: Callable[[V], V],
    v0: V,
    vs: Optional[VectorSpace] = None,
    maxiter: int = 50,
    rtol: float = 1e-12,
) -> tuple:
    """Lowest eigenpair of Hermitian A (ref krylov.rs:484).

    Lanczos with full reorthogonalization (small maxiter) — the dense
    tridiagonal eigenproblem is solved on host.
    """
    vs = vs or VectorSpace()
    n0 = vs.norm(v0)
    if n0 == 0:
        raise ValueError("zero start vector")
    q = vs.scale(1.0 / n0, v0)
    Q: List[V] = [q]
    alphas: List[float] = []
    betas: List[float] = []
    prev_ev = None
    for k in range(maxiter):
        w = apply_a(Q[k])
        a_k = vs.inner(Q[k], w).real
        alphas.append(a_k)
        w = vs.axpby(-a_k, Q[k], 1.0, w)
        if k > 0:
            w = vs.axpby(-betas[-1], Q[k - 1], 1.0, w)
        # full reorthogonalization
        for qi in Q:
            c = vs.inner(qi, w)
            if abs(c) > 0:
                w = vs.axpby(-c, qi, 1.0, w)
        b_k = vs.norm(w)
        T = np.diag(alphas) + np.diag(betas, 1) + np.diag(betas, -1)
        evals, evecs = np.linalg.eigh(T)
        ev = evals[0]
        # residual estimate ||A x - ev x|| = beta_k * |last eigvec entry|
        res_est = b_k * abs(evecs[-1, 0])
        if res_est <= rtol * max(1.0, abs(ev)):
            break
        prev_ev = ev
        if b_k <= 1e-14 * max(1.0, abs(a_k)):
            break
        betas.append(b_k)
        Q.append(vs.scale(1.0 / b_k, w))
    T = np.diag(alphas) + np.diag(betas[: len(alphas) - 1], 1) + np.diag(
        betas[: len(alphas) - 1], -1
    )
    evals, evecs = np.linalg.eigh(T)
    coef = evecs[:, 0]
    x = None
    for c, qv in zip(coef, Q):
        x = vs.scale(c, qv) if x is None else vs.axpby(c, qv, 1.0, x)
    nx = vs.norm(x)
    x = vs.scale(1.0 / nx, x)
    return float(evals[0]), x


def hermitian_krylov_expm_multiply(
    apply_a: Callable[[V], V],
    v0: V,
    t: complex,
    vs: Optional[VectorSpace] = None,
    maxiter: int = 40,
    rtol: float = 1e-12,
) -> V:
    """``exp(t A) v0`` for Hermitian A (ref krylov.rs:640).

    Lanczos basis + dense expm of the tridiagonal projection
    (via eigh — exact for Hermitian T).
    """
    vs = vs or VectorSpace()
    n0 = vs.norm(v0)
    if n0 == 0:
        return v0
    Q: List[V] = [vs.scale(1.0 / n0, v0)]
    alphas: List[float] = []
    betas: List[float] = []
    prev = None
    for k in range(maxiter):
        w = apply_a(Q[k])
        a_k = vs.inner(Q[k], w).real
        alphas.append(a_k)
        w = vs.axpby(-a_k, Q[k], 1.0, w)
        if k > 0:
            w = vs.axpby(-betas[-1], Q[k - 1], 1.0, w)
        for qi in Q:
            c = vs.inner(qi, w)
            if abs(c) > 0:
                w = vs.axpby(-c, qi, 1.0, w)
        b_k = vs.norm(w)
        # current estimate of exp(tT) e1
        T = np.diag(alphas) + np.diag(betas, 1) + np.diag(betas, -1)
        evals, evecs = np.linalg.eigh(T)
        coef = evecs @ (np.exp(t * evals) * evecs[0, :].conj())
        if prev is not None and len(prev) == len(coef) - 1:
            err = abs(coef[-1])
            if err <= rtol * np.linalg.norm(coef):
                break
        prev = coef
        if b_k <= 1e-14 * max(1.0, abs(a_k)):
            break
        betas.append(b_k)
        Q.append(vs.scale(1.0 / b_k, w))
    T = np.diag(alphas) + np.diag(betas[: len(alphas) - 1], 1) + np.diag(
        betas[: len(alphas) - 1], -1
    )
    evals, evecs = np.linalg.eigh(T)
    coef = evecs @ (np.exp(t * evals) * evecs[0, :].conj())
    x = None
    for c, qv in zip(coef, Q):
        x = vs.scale(c, qv) if x is None else vs.axpby(c, qv, 1.0, x)
    return vs.scale(n0, x)
