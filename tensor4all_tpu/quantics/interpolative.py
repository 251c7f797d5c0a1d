"""Interpolative QTT: Chebyshev-Lagrange construction without TCI.

JAX rebuild of tensor4all-interpolativeqtt
(crates/tensor4all-interpolativeqtt/src/interpolation.rs:47-460
single/multi-scale/adaptive variants, basis.rs LagrangePolynomials +
Chebyshev grid): the multiscale identity
``f((s + y)/2) ≈ sum_b f((s + t_b)/2) L_b(y)`` unrolled over R binary
scales gives explicit TT cores of bond dimension K (the number of
Chebyshev nodes) — no function-adaptive pivoting needed, only K*2*K
Lagrange evaluations per scale plus 2K function samples.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from ..tt.tensortrain import TensorTrain


def chebyshev_nodes(K: int) -> np.ndarray:
    """K Chebyshev points on [0, 1] (ref basis.rs chebyshev grid)."""
    j = np.arange(K)
    return 0.5 * (1.0 - np.cos(np.pi * (j + 0.5) / K))


def lagrange_basis(nodes: np.ndarray, y: np.ndarray) -> np.ndarray:
    """L[b, m] = ell_b(y_m), barycentric form (ref LagrangePolynomials)."""
    nodes = np.asarray(nodes, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    K = nodes.shape[0]
    # barycentric weights
    diff = nodes[:, None] - nodes[None, :]
    np.fill_diagonal(diff, 1.0)
    w = 1.0 / diff.prod(axis=1)
    d = y[None, :] - nodes[:, None]  # (K, M)
    exact = np.isclose(d, 0.0, atol=1e-15)
    d_safe = np.where(exact, 1.0, d)
    terms = w[:, None] / d_safe
    denom = terms.sum(axis=0)
    L = terms / denom[None, :]
    # exact node hits
    hit_cols = exact.any(axis=0)
    if hit_cols.any():
        L[:, hit_cols] = exact[:, hit_cols].astype(np.float64)
    return L


@dataclasses.dataclass
class InterpolativeQtt:
    tt: TensorTrain
    R: int
    K: int
    lower: float
    upper: float

    def evaluate(self, x: np.ndarray) -> np.ndarray:
        x = np.atleast_1d(np.asarray(x, dtype=np.float64))
        u = (x - self.lower) / (self.upper - self.lower)
        m = np.clip((u * 2 ** self.R).astype(np.int64), 0, 2 ** self.R - 1)
        shifts = np.arange(self.R - 1, -1, -1)
        bits = (m[:, None] >> shifts[None, :]) & 1
        return np.asarray(self.tt.evaluate_batch(bits))

    def evaluate_continuous(self, x: np.ndarray) -> np.ndarray:
        """Evaluate the CONTINUOUS interpolant (not just grid points):
        consume R-1 dyadic bits through the cores, then close with the
        Lagrange basis at the remaining fraction
        (ref interpolation.rs evaluation path)."""
        x = np.atleast_1d(np.asarray(x, dtype=np.float64))
        u = np.clip((x - self.lower) / (self.upper - self.lower), 0.0,
                    np.nextafter(1.0, 0.0))
        t = chebyshev_nodes(self.K)
        cores = [np.asarray(c) for c in self.tt.cores]
        out = np.empty(x.shape)
        for i, ui in enumerate(u):
            s = int(ui * 2) if ui < 1 else 1
            ui = 2 * ui - s
            v = cores[0][0, s, :]
            for k in range(1, self.R - 1):
                s = int(ui * 2) if ui < 1 else 1
                ui = 2 * ui - s
                v = v @ cores[k][:, s, :]
            out[i] = v @ lagrange_basis(t, np.asarray([ui]))[:, 0]
        return out


def interpolative_qtt(
    f: Callable[[np.ndarray], np.ndarray],
    R: int,
    K: int = 16,
    lower: float = 0.0,
    upper: float = 1.0,
) -> InterpolativeQtt:
    """Build a quantics TT of ``f`` on [lower, upper) with R binary scales
    and K Chebyshev nodes per scale (ref interpolation.rs:47 single-scale
    construction; bond dimension = K).

    `f` must accept arbitrary real points in the interval (vectorized).
    """
    t = chebyshev_nodes(K)
    width = upper - lower
    # first core: f sampled at depth-1 points (s + t_b)/2
    first = np.empty((1, 2, K))
    for s in (0, 1):
        pts = lower + width * (s + t) / 2.0
        first[0, s, :] = np.asarray(f(pts))
    # middle cores: ell_a((s + t_b)/2)
    mid = np.empty((K, 2, K))
    for s in (0, 1):
        mid[:, s, :] = lagrange_basis(t, (s + t) / 2.0)
    # last core: ell_a(s/2)
    last = np.empty((K, 2, 1))
    for s in (0, 1):
        last[:, s, 0] = lagrange_basis(t, np.asarray([s / 2.0]))[:, 0]
    cores = [first] + [mid.copy() for _ in range(R - 2)] + [last]
    if R == 1:
        # single scale: just sample both points
        pts = lower + width * np.asarray([0.0, 0.5])
        cores = [np.asarray(f(pts)).reshape(1, 2, 1)]
    return InterpolativeQtt(TensorTrain(cores), R, K, lower, upper)


@dataclasses.dataclass
class InterpolativeQttNd:
    """Fused multidimensional interpolative QTT (ref
    interpolation.rs:98 interpolate_single_scale_nd): site dim 2^D, bond
    K^D before compression."""

    tt: TensorTrain
    R: int
    K: int
    lower: np.ndarray
    upper: np.ndarray

    def evaluate(self, x: np.ndarray) -> np.ndarray:
        """Nearest-grid-point evaluation at coordinates (B, D)."""
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        D = x.shape[1]
        u = (x - self.lower) / (self.upper - self.lower)
        m = np.clip((u * 2 ** self.R).astype(np.int64), 0,
                    2 ** self.R - 1)  # (B, D)
        shifts = np.arange(self.R - 1, -1, -1)
        bits = (m[:, :, None] >> shifts[None, None, :]) & 1  # (B, D, R)
        weights = 1 << np.arange(D)  # dim-0 minor fused digit
        fused = (bits * weights[None, :, None]).sum(axis=1)  # (B, R)
        return np.asarray(self.tt.evaluate_batch(fused))


def interpolative_qtt_nd(
    f: Callable[[np.ndarray], np.ndarray],
    lower: Sequence[float],
    upper: Sequence[float],
    R: int,
    K: int = 12,
    compress_tol: Optional[float] = 1e-12,
    maxdim: Optional[int] = None,
) -> InterpolativeQttNd:
    """Fused D-dimensional interpolative QTT (ref interpolation.rs:98):
    each site carries one bit of EVERY dimension (fused digit, dim-0
    minor). `f` maps points (B, D) -> (B,)."""
    lower = np.asarray(lower, dtype=np.float64)
    upper = np.asarray(upper, dtype=np.float64)
    D = len(lower)
    if R < 2:
        raise ValueError("R must be >= 2")
    t = chebyshev_nodes(K)
    width = upper - lower
    # tensor-product node grid: (K^D, D), dim-0 fastest
    grids = np.meshgrid(*([t] * D), indexing="ij")
    T = np.stack([g.reshape(-1, order="F") for g in grids], axis=1)
    # fused s digits: (2^D, D), dim-0 minor
    S = np.stack([(np.arange(1 << D) >> d) & 1 for d in range(D)], axis=1)
    # 1-D building blocks
    M1 = np.empty((K, 2, K))
    for s in (0, 1):
        M1[:, s, :] = lagrange_basis(t, (s + t) / 2.0)
    L1 = np.empty((K, 2))
    for s in (0, 1):
        L1[:, s] = lagrange_basis(t, np.asarray([s / 2.0]))[:, 0]
    # first core: f at depth-1 points
    first = np.empty((1, 1 << D, K ** D))
    for si in range(1 << D):
        pts = lower[None, :] + width[None, :] * (S[si][None, :] + T) / 2.0
        first[0, si, :] = np.asarray(f(pts))
    # middle core: product of per-dim Lagrange maps
    mid = np.ones((K ** D, 1 << D, K ** D))
    idx = np.arange(K ** D)
    for d in range(D):
        a_d = (idx // K ** d) % K
        b_d = (idx // K ** d) % K
        block = M1[a_d[:, None, None], S[None, :, d, None],
                   b_d[None, None, :]]
        mid = mid * block
    last = np.ones((K ** D, 1 << D, 1))
    for d in range(D):
        a_d = (idx // K ** d) % K
        last[:, :, 0] = last[:, :, 0] * L1[a_d[:, None], S[None, :, d]]
    cores = [first] + [mid.copy() for _ in range(R - 2)] + [last]
    tt = TensorTrain(cores)
    if compress_tol is not None:
        tt = tt.compress(tol=compress_tol, maxdim=maxdim, method="svd")
    return InterpolativeQttNd(tt, R, K, lower, upper)


def angular_local_lagrange(nodes: np.ndarray,
                           window_radius: int) -> np.ndarray:
    """Sparse angular local-Lagrange interpolation core (ref basis.rs:437
    `angular_local_lagrange`).

    Replaces the dense core ``P[a, s, b] = L_a((s + t_b)/2)`` by a LOCAL
    Lagrange interpolation in the Chebyshev angle ``theta = acos(1-2x)``:
    for each target point only the ``2*window_radius + 1`` angularly
    nearest nodes contribute (Chebyshev nodes are uniform in theta, so
    the local stencil is well-conditioned); all other entries are exact
    zeros. The zeros make the core compress to much smaller bonds at
    high degree, at a controlled local-interpolation error.
    """
    nodes = np.asarray(nodes, dtype=np.float64)
    K = nodes.shape[0]
    degree = K - 1
    w = int(window_radius)
    if degree < 2 * w:
        raise ValueError(
            f"need degree >= 2 * window_radius, got degree {degree} and "
            f"window_radius {w}")
    theta_nodes = np.arccos(np.clip(1.0 - 2.0 * nodes, -1.0, 1.0))
    core = np.zeros((K, 2, K))
    for s in (0, 1):
        x = (s + nodes) / 2.0
        theta = np.arccos(np.clip(1.0 - 2.0 * x, -1.0, 1.0))
        for b in range(K):
            nearest = int(np.argmin(np.abs(theta_nodes - theta[b])))
            lo = min(max(nearest - w, 0), degree - 2 * w)
            hi = lo + 2 * w
            win = np.arange(lo, hi + 1)
            tw = theta_nodes[win]
            # local barycentric-free Lagrange product in theta
            for a_pos, a in enumerate(win):
                num = theta[b] - np.delete(tw, a_pos)
                den = tw[a_pos] - np.delete(tw, a_pos)
                core[a, s, b] = np.prod(num / den)
    return core


def interpolative_qtt_sparse(
    f: Callable[[np.ndarray], np.ndarray],
    R: int,
    K: int = 16,
    window_radius: int = 2,
    lower: float = 0.0,
    upper: float = 1.0,
) -> InterpolativeQtt:
    """Sparse single-scale interpolative QTT (ref interpolation.rs:409
    `interpolate_single_scale_sparse`): the dense middle interpolation
    core is replaced by the angular local-Lagrange core. Bond dimension
    stays K but each column has only ``2*window_radius + 1`` nonzeros,
    so SVD compression finds far smaller effective ranks at large K."""
    if R < 2:
        raise ValueError("R must be >= 2")
    t = chebyshev_nodes(K)
    width = upper - lower
    first = np.empty((1, 2, K))
    for s in (0, 1):
        pts = lower + width * (s + t) / 2.0
        first[0, s, :] = np.asarray(f(pts))
    mid = angular_local_lagrange(t, window_radius)
    last = np.empty((K, 2, 1))
    for s in (0, 1):
        last[:, s, 0] = lagrange_basis(t, np.asarray([s / 2.0]))[:, 0]
    cores = [first] + [mid.copy() for _ in range(R - 2)] + [last]
    return InterpolativeQtt(TensorTrain(cores), R, K, lower, upper)


def interpolative_qtt_sparse_nd(
    f: Callable[[np.ndarray], np.ndarray],
    lower: Sequence[float],
    upper: Sequence[float],
    R: int,
    K: int = 12,
    window_radius: int = 2,
    compress_tol: Optional[float] = 1e-12,
    maxdim: Optional[int] = None,
) -> InterpolativeQttNd:
    """Fused D-dimensional sparse single-scale interpolative QTT (ref
    interpolation.rs:466 `interpolate_single_scale_sparse_nd`): the
    middle core is the direct product of per-dimension angular
    local-Lagrange cores."""
    lower = np.asarray(lower, dtype=np.float64)
    upper = np.asarray(upper, dtype=np.float64)
    D = len(lower)
    if R < 2:
        raise ValueError("R must be >= 2")
    t = chebyshev_nodes(K)
    width = upper - lower
    grids = np.meshgrid(*([t] * D), indexing="ij")
    T = np.stack([g.reshape(-1, order="F") for g in grids], axis=1)
    S = np.stack([(np.arange(1 << D) >> d) & 1 for d in range(D)], axis=1)
    first = np.empty((1, 1 << D, K ** D))
    for si in range(1 << D):
        pts = lower[None, :] + width[None, :] * (S[si][None, :] + T) / 2.0
        first[0, si, :] = np.asarray(f(pts))
    M1 = angular_local_lagrange(t, window_radius)
    L1 = np.empty((K, 2))
    for s in (0, 1):
        L1[:, s] = lagrange_basis(t, np.asarray([s / 2.0]))[:, 0]
    mid = np.ones((K ** D, 1 << D, K ** D))
    idx = np.arange(K ** D)
    for d in range(D):
        a_d = (idx // K ** d) % K
        b_d = (idx // K ** d) % K
        block = M1[a_d[:, None, None], S[None, :, d, None],
                   b_d[None, None, :]]
        mid = mid * block
    last = np.ones((K ** D, 1 << D, 1))
    for d in range(D):
        a_d = (idx // K ** d) % K
        last[:, :, 0] = last[:, :, 0] * L1[a_d[:, None], S[None, :, d]]
    cores = [first] + [mid.copy() for _ in range(R - 2)] + [last]
    tt = TensorTrain(cores)
    if compress_tol is not None:
        tt = tt.compress(tol=compress_tol, maxdim=maxdim, method="svd")
    return InterpolativeQttNd(tt, R, K, lower, upper)


def invert_qtt(iq: InterpolativeQtt, max_level: Optional[int] = None):
    """Recover the per-interval Chebyshev node values from an
    interpolative QTT (ref interpolation.rs:524 invert_qtt): level ``l``
    yields a (2^l, K) matrix whose row ``i`` holds the interpolant's
    coefficients (= values at the K Chebyshev nodes) of the i-th dyadic
    interval — computed exactly by partial contraction of the cores."""
    R, K = iq.R, iq.K
    if max_level is None:
        max_level = R - 1
    if not 1 <= max_level <= R - 1:
        raise ValueError("max_level must be in [1, R-1]")
    cores = [np.asarray(c) for c in iq.tt.cores]
    out = []
    cur = cores[0][0]  # (2, K): level 1
    out.append(cur.copy())
    for lvl in range(2, max_level + 1):
        cur = np.einsum("pa,asb->psb", cur, cores[lvl - 1]).reshape(
            2 ** lvl, K)
        out.append(cur.copy())
    return out


def adaptive_interpolative_qtt(
    f: Callable[[np.ndarray], np.ndarray],
    R: int,
    tol: float = 1e-10,
    K_min: int = 4,
    K_max: int = 40,
    lower: float = 0.0,
    upper: float = 1.0,
    n_check: int = 200,
    seed: int = 0,
) -> InterpolativeQtt:
    """Grow K until the sampled interpolation error meets `tol`
    (ref interpolation.rs adaptive variant)."""
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 2 ** R, size=n_check)
    x = lower + (upper - lower) * m / 2 ** R
    fx = np.asarray(f(x))
    scale = np.abs(fx).max() or 1.0
    K = K_min
    while True:
        q = interpolative_qtt(f, R, K, lower, upper)
        err = np.abs(q.evaluate(x) - fx).max() / scale
        if err <= tol or K >= K_max:
            return q
        K = min(K * 2, K_max)
