"""Tensor factorizations: SVD / QR / factorize + truncation.

JAX rebuild of tensor4all-core/src/defaults/svd.rs:310 (`svd`),
qr.rs:208 (`qr`), factorize.rs:80 (`factorize`), direct_sum.rs, and the
truncation machinery (truncation.rs:25-208). Tensors are permuted/reshaped
to matrices on-device (pure XLA transposes/reshapes), factorized with
``jnp.linalg`` (CPU: LAPACK, GPU: cuSOLVER), and
truncated per policy. Rank decisions are data-dependent and made on host —
the same place the reference makes them; inside hot sweeps callers can pass
``maxdim``-only policies to keep shapes static.
"""

from __future__ import annotations

import dataclasses
import enum
from functools import partial
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (
    SingularValueMeasure,
    SvdTruncationPolicy,
    ThresholdScale,
    get_default_qr_rtol,
    get_default_svd_truncation_policy,
)
from .index import Index
from .tensor import Tensor


class FactorizeAlg(enum.Enum):
    """Factorization algorithm selector (ref tensor_like.rs:120)."""

    SVD = "svd"
    QR = "qr"
    LU = "lu"
    CI = "ci"


class Canonical(enum.Enum):
    """Which factor carries the orthogonality (ref tensor_like.rs:169)."""

    LEFT = "left"
    RIGHT = "right"
    BOTH = "both"  # SVD with sqrt(S) split on both sides


@dataclasses.dataclass
class TruncationSpec:
    """Report of a truncation decision."""

    rank: int
    error: float  # discarded weight per the policy's measure
    singular_values: np.ndarray


def truncation_rank(s: np.ndarray, policy: SvdTruncationPolicy) -> Tuple[int, float]:
    """Rank to keep for singular values `s` (descending) under `policy`.

    Ref: truncation.rs `SvdTruncationPolicy::rank` semantics. Returns
    (rank, discarded error measure).
    """
    s = np.asarray(s, dtype=np.float64)
    n = s.shape[0]
    if n == 0:
        return 0, 0.0
    maxdim = min(policy.maxdim, n) if policy.maxdim is not None else n
    if policy.measure is SingularValueMeasure.VALUE:
        cut = policy.tol * (s[0] if policy.scale is ThresholdScale.RELATIVE else 1.0)
        rank = int(np.sum(s > cut))
    else:  # SQUARED_TAIL
        s2 = s * s
        total = float(np.sum(s2))
        budget = policy.tol * (total if policy.scale is ThresholdScale.RELATIVE else 1.0)
        # keep the smallest prefix whose discarded tail stays <= budget
        tail = np.concatenate([np.cumsum(s2[::-1])[::-1][1:], [0.0]])
        rank = int(np.searchsorted(-tail, -budget, side="left")) + 1
        rank = min(rank, n)
        # all values could be discarded only if total <= budget
        if total <= budget:
            rank = 0
    rank = max(rank, min(policy.mindim, n))
    rank = min(rank, maxdim)
    rank = max(rank, 1) if n > 0 else 0
    if policy.measure is SingularValueMeasure.VALUE:
        err = float(s[rank]) if rank < n else 0.0
    else:
        err = float(np.sum((s * s)[rank:]))
    return rank, err


def _on_cpu_backend() -> bool:
    try:
        return jax.default_backend() == "cpu"
    except Exception:  # noqa: BLE001 — backend probe must never raise
        return False


def _svd_adjoint(u, s, vh, du, ds, dvh):
    """Adjoint of ``a -> svd(a, full_matrices=False)`` under the
    ``Re tr(A^H B)`` pairing — the transpose of XLA's SVD JVP rule with
    degenerate-pair broadening so exactly-tied (e.g. exactly-zero)
    singular values yield a finite subgradient instead of NaN.

    All factors are FULL-width (k = min(m, n)); truncation enters only
    through zero cotangent blocks, which makes this the exact VJP of
    truncated SVD viewed as full-SVD-then-slice.
    """
    v = vh.conj().T
    dv = dvh.conj().T
    smax = jnp.max(s, initial=0.0)
    # |F| capped near 1/(2e-12 smax^2): degenerate KEPT pairs get a
    # finite subgradient; well-separated pairs are unaffected (the
    # regularizer is ~1e-24 smax^4 against E^2)
    eps = jnp.square(1e-12 * smax * smax) + jnp.finfo(s.dtype).tiny
    E = s[None, :] ** 2 - s[:, None] ** 2  # E_ij = s_j^2 - s_i^2
    F = E / (E * E + eps)
    # under jit XLA fuses the difference of squares with FMA, leaving
    # O(ulp) residue on the diagonal that would make F_ii ~ ulp/eps
    # instead of 0 — mask it explicitly
    F = jnp.where(jnp.eye(s.shape[0], dtype=bool), 0.0, F)
    Gu = u.conj().T @ du
    Gv = v.conj().T @ dv
    Xu = F * Gu
    Xv = F * Gv
    s_zeros = (s == 0).astype(s.dtype)
    s_inv = 1.0 / (s + s_zeros) - s_zeros
    cS = (jnp.diag(ds.real.astype(s.dtype))
          + (Xu + Xu.conj().T) * s[None, :].astype(u.dtype)
          + s[:, None].astype(u.dtype) * (Xv + Xv.conj().T))
    if jnp.iscomplexobj(u):
        gd = jnp.diagonal(Gu)
        cS = cS + jnp.diag(0.5 * (gd - gd.conj()) * s_inv)
    dA = u @ cS @ vh
    m, n = u.shape[0], v.shape[0]
    if m > n:
        dA = dA + (du - u @ Gu) * s_inv[None, :] @ vh
    if n > m:
        dA = dA + u @ (s_inv[:, None] * (dv - v @ Gv).conj().T)
    return dA


@partial(jax.custom_vjp, nondiff_argnums=(1,))
def svd_truncated_fixed_rank(a, rank: int):
    """Differentiable truncated SVD with STATIC rank (ref AD-through-svd,
    tensor4all-core/tests/ad_integration.rs:15-31 — the reference's eager
    tape differentiates through `svd`; under XLA the shape must be static,
    so the rank is a Python int and `jax.grad`/`jit` flow through this).

    Returns ``(u[:, :rank], s[:rank], vh[:rank, :])``. The custom VJP is
    mask-aware: cotangents of the discarded block are zero, and the
    degenerate-pair broadening in `_svd_adjoint` keeps gradients finite
    when the discarded tail contains repeated/zero singular values (where
    the builtin rule produces NaN).
    """
    u, s, vh = jnp.linalg.svd(a, full_matrices=False)
    return u[:, :rank], s[:rank], vh[:rank, :]


def _svd_trunc_fwd(a, rank: int):
    u, s, vh = jnp.linalg.svd(a, full_matrices=False)
    return (u[:, :rank], s[:rank], vh[:rank, :]), (u, s, vh)


def _svd_trunc_bwd(rank: int, res, cots):
    u, s, vh = res
    du_t, ds_t, dvh_t = cots
    k = s.shape[0]
    du = jnp.zeros_like(u).at[:, :rank].set(du_t.conj())
    ds = jnp.zeros_like(s).at[:rank].set(ds_t.real.astype(s.dtype))
    dvh = jnp.zeros_like(vh).at[:rank, :].set(dvh_t.conj())
    dA = _svd_adjoint(u, s, vh, du, ds, dvh)
    return (dA.conj(),)


svd_truncated_fixed_rank.defvjp(_svd_trunc_fwd, _svd_trunc_bwd)


def _static_rank_from_policy(policy: SvdTruncationPolicy,
                             k: int) -> Optional[int]:
    """A policy is shape-static iff it cannot discard by tolerance: only
    then can traced code know the rank without looking at the data."""
    if policy.tol == 0 and policy.maxdim is not None:
        return min(policy.maxdim, k)
    return None


def truncated_svd_matrix(
    a: jnp.ndarray,
    policy: Optional[SvdTruncationPolicy] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, TruncationSpec]:
    """SVD of a matrix, truncated per policy. Returns (U, s, Vh, spec).

    This runs at the HOST level (between jitted kernels); on a CPU
    backend, small matrices use LAPACK directly — each jax dispatch
    costs more than the entire factorization at sweep-sized shapes.
    Device-resident code paths (the jitted engines) never call this.
    """
    if policy is None:
        policy = get_default_svd_truncation_policy()
    if isinstance(a, jax.core.Tracer):
        # Traced (jit/grad) path: legal only when the policy fixes the
        # rank statically (tol=0 + maxdim). Gradients flow through the
        # mask-aware custom VJP (ref differentiates through svd,
        # tensor4all-core/tests/ad_integration.rs:15-31).
        rank = _static_rank_from_policy(policy, min(a.shape))
        if rank is None:
            raise TypeError(
                "truncated_svd_matrix picks a data-dependent rank and "
                "cannot be traced (jit/grad) with a tolerance-based "
                "policy; use a tol=0 + maxdim policy (static rank) or "
                "factorize outside the traced region")
        u, s, vh = svd_truncated_fixed_rank(a, rank)
        spec = TruncationSpec(rank=rank, error=float("nan"),
                              singular_values=None)
        return u, s, vh, spec
    if _on_cpu_backend() and a.shape[0] * a.shape[1] <= 512 * 512:
        un, sn, vhn = np.linalg.svd(np.asarray(a), full_matrices=False)
        rank, err = truncation_rank(sn, policy)
        spec = TruncationSpec(rank=rank, error=err, singular_values=sn)
        # stay numpy on the host path: the three device_puts here cost
        # more than the whole factorization at sweep-sized shapes (r3
        # star profile), and every consumer is np/jnp agnostic
        return un[:, :rank], sn[:rank], vhn[:rank, :], spec
    u, s, vh = jnp.linalg.svd(a, full_matrices=False)
    s_host = np.asarray(s)
    rank, err = truncation_rank(s_host, policy)
    spec = TruncationSpec(rank=rank, error=err, singular_values=s_host)
    return u[:, :rank], s[:rank], vh[:rank, :], spec


def _split_matrixize(t: Tensor, left_inds: Sequence[Index]):
    """Permute to (left..., right...) and reshape to a matrix."""
    left = tuple(left_inds)
    lset = set(left)
    if len(lset) != len(left):
        raise ValueError("duplicate left indices")
    for i in left:
        if not t.hasindex(i):
            raise KeyError(f"left index {i!r} not in tensor")
    right = tuple(i for i in t.indices if i not in lset)
    tp = t.permute(left + right)
    m = int(np.prod([i.dim for i in left], dtype=np.int64)) if left else 1
    n = int(np.prod([i.dim for i in right], dtype=np.int64)) if right else 1
    return tp.data.reshape(m, n), left, right


def svd(
    t: Tensor,
    left_inds: Sequence[Index],
    policy: Optional[SvdTruncationPolicy] = None,
    link_tags: str = "Link",
) -> Tuple[Tensor, Tensor, Tensor, TruncationSpec]:
    """Index-partitioned tensor SVD with truncation.

    Ref: tensor4all-core/src/defaults/svd.rs:310. Returns
    ``(U, S, Vh, spec)`` with ``U: (left..., u)``, ``S: (u, v)`` diagonal,
    ``Vh: (v, right...)`` such that ``contract([U,S,Vh]) ≈ t``.
    """
    a, left, right = _split_matrixize(t, left_inds)
    u, s, vh, spec = truncated_svd_matrix(a, policy)
    r = u.shape[1]
    iu = Index(r, tags=link_tags)
    iv = Index(r, tags=link_tags)
    U = Tensor(left + (iu,), u.reshape([i.dim for i in left] + [r]))
    S = Tensor.diag(s, iu, iv)
    Vh = Tensor((iv,) + right, vh.reshape([r] + [i.dim for i in right]))
    return U, S, Vh, spec


def svd_two(
    t: Tensor,
    left_inds: Sequence[Index],
    policy: Optional[SvdTruncationPolicy] = None,
    canonical: Canonical = Canonical.LEFT,
    link_tags: str = "Link",
) -> Tuple[Tensor, Tensor, TruncationSpec]:
    """Two-factor SVD split: ``t ≈ L · R`` sharing one bond index.

    ``canonical=LEFT`` gives L=U isometric and R=S·Vh; RIGHT the mirror;
    BOTH splits sqrt(S) to each side (Vidal-style).
    """
    a, left, right = _split_matrixize(t, left_inds)
    u, s, vh, spec = truncated_svd_matrix(a, policy)
    r = u.shape[1]
    bond = Index(r, tags=link_tags)
    if canonical is Canonical.LEFT:
        lm, rm = u, s[:, None] * vh
    elif canonical is Canonical.RIGHT:
        lm, rm = u * s[None, :], vh
    else:
        sq = jnp.sqrt(s)
        lm, rm = u * sq[None, :], sq[:, None] * vh
    L = Tensor(left + (bond,), lm.reshape([i.dim for i in left] + [r]))
    R = Tensor((bond,) + right, rm.reshape([r] + [i.dim for i in right]))
    return L, R, spec


def qr(
    t: Tensor,
    left_inds: Sequence[Index],
    link_tags: str = "Link",
    rtol: Optional[float] = None,
) -> Tuple[Tensor, Tensor]:
    """Index-partitioned thin QR: ``t = Q·R`` with Q isometric on the left.

    Ref: tensor4all-core/src/defaults/qr.rs:208. `rtol` (default global,
    qr.rs:105) optionally rank-truncates by the diagonal of R relative to
    its largest magnitude (column-pivot-free heuristic matching the
    reference's default use inside canonicalization where exactness
    dominates: rtol only drops exact-zero tails).
    """
    a, left, right = _split_matrixize(t, left_inds)
    if (_on_cpu_backend() and not isinstance(a, jax.core.Tracer)
            and a.size <= 512 * 512):
        # host LAPACK beats the per-call XLA dispatch at sweep sizes
        q, r = np.linalg.qr(np.asarray(a), mode="reduced")
    else:
        q, r = jnp.linalg.qr(a, mode="reduced")
    if rtol is None:
        rtol = get_default_qr_rtol()
    if rtol > 0 and min(a.shape) > 1 and not isinstance(a, jax.core.Tracer):
        # rank trimming is data-dependent; traced QR keeps full rank and
        # differentiates through jnp.linalg.qr's builtin rule
        # drop only rows of R that are negligible in FULL row norm —
        # unlike a diag(R) criterion this is sound without column
        # pivoting (error bounded by the dropped row norms)
        rn = np.linalg.norm(np.asarray(r), axis=1)
        rmax = rn.max() if rn.size else 0.0
        if rmax > 0:
            keep_mask = rn > rtol * rmax
            keep_mask[0] = True
            if not keep_mask.all():
                keep_idx = np.nonzero(keep_mask)[0]
                q, r = q[:, keep_idx], r[keep_idx, :]
    k = q.shape[1]
    bond = Index(k, tags=link_tags)
    Q = Tensor(left + (bond,), q.reshape([i.dim for i in left] + [k]))
    R = Tensor((bond,) + right, r.reshape([k] + [i.dim for i in right]))
    return Q, R


def lq(
    t: Tensor,
    left_inds: Sequence[Index],
    link_tags: str = "Link",
) -> Tuple[Tensor, Tensor]:
    """LQ split: ``t = L·Q`` with Q isometric on the right."""
    a, left, right = _split_matrixize(t, left_inds)
    qt, rt = jnp.linalg.qr(a.T, mode="reduced")
    k = qt.shape[1]
    bond = Index(k, tags=link_tags)
    L = Tensor(left + (bond,), rt.T.reshape([i.dim for i in left] + [k]))
    Q = Tensor((bond,) + right, qt.T.reshape([k] + [i.dim for i in right]))
    return L, Q


def factorize(
    t: Tensor,
    left_inds: Sequence[Index],
    alg: FactorizeAlg = FactorizeAlg.SVD,
    canonical: Canonical = Canonical.LEFT,
    policy: Optional[SvdTruncationPolicy] = None,
    link_tags: str = "Link",
) -> Tuple[Tensor, Tensor, Optional[TruncationSpec]]:
    """Two-factor split dispatching on algorithm (ref factorize.rs:80).

    Returns ``(L, R, spec)`` with ``contract([L, R]) ≈ t``.
    """
    if alg is FactorizeAlg.SVD:
        L, R, spec = svd_two(t, left_inds, policy, canonical, link_tags)
        return L, R, spec
    if alg is FactorizeAlg.QR:
        if canonical is Canonical.LEFT:
            Q, R = qr(t, left_inds, link_tags)
            return Q, R, None
        elif canonical is Canonical.RIGHT:
            L, Q = lq(t, left_inds, link_tags)
            return L, Q, None
        raise ValueError("QR factorize requires LEFT or RIGHT canonical")
    if alg in (FactorizeAlg.LU, FactorizeAlg.CI):
        # Pivoted-LU / cross-interpolation factorization (ref tcicore rrLU /
        # MatrixLUCI) — implemented in ops.rrlu; imported lazily to avoid a
        # core->ops dependency cycle.
        from ..ops.rrlu import factorize_lu

        return factorize_lu(t, left_inds, alg, canonical, policy, link_tags)
    raise ValueError(f"unknown FactorizeAlg {alg}")


def direct_sum(
    a: Tensor,
    b: Tensor,
    pairs: Sequence[Tuple[Index, Index]],
    link_tags: str = "Link",
) -> Tuple[Tensor, Tuple[Index, ...]]:
    """Direct sum of two tensors along paired axes (ref direct_sum.rs).

    Axes listed in `pairs` are block-concatenated (dims add, producing fresh
    indices, returned second); all other indices must coincide between `a`
    and `b` (those axes are summed elementwise after zero-padding — the TT
    addition rule).
    """
    pa = tuple(p[0] for p in pairs)
    pb = tuple(p[1] for p in pairs)
    resta = tuple(i for i in a.indices if i not in set(pa))
    restb = tuple(i for i in b.indices if i not in set(pb))
    if set(resta) != set(restb):
        raise ValueError("direct_sum: non-paired indices must match")
    a_p = a.permute(pa + resta)
    b_p = b.permute(pb + resta)
    k = len(pairs)
    new_inds = tuple(
        Index(ia.dim + ib.dim, tags=link_tags) for ia, ib in pairs
    )
    out_shape = [ni.dim for ni in new_inds] + [i.dim for i in resta]
    dtype = jnp.promote_types(a.dtype, b.dtype)
    out = jnp.zeros(out_shape, dtype=dtype)
    sl_a = tuple(slice(0, ia.dim) for ia, _ in pairs) + (Ellipsis,)
    sl_b = tuple(slice(ia.dim, ia.dim + ib.dim) for ia, ib in pairs) + (Ellipsis,)
    out = out.at[sl_a].add(a_p.data.astype(dtype))
    out = out.at[sl_b].add(b_p.data.astype(dtype))
    return Tensor(new_inds + resta, out), new_inds


def eigh(
    t: Tensor, left_inds: Sequence[Index], link_tags: str = "Link"
) -> Tuple[jnp.ndarray, Tensor]:
    """Hermitian eigendecomposition over an index bipartition (ref eigh).

    Returns (eigenvalues ascending, U) with ``U: (left..., bond)``.
    """
    a, left, right = _split_matrixize(t, left_inds)
    if a.shape[0] != a.shape[1]:
        raise ValueError("eigh requires square bipartition")
    w, v = jnp.linalg.eigh(a)
    bond = Index(a.shape[0], tags=link_tags)
    U = Tensor(left + (bond,), v.reshape([i.dim for i in left] + [a.shape[0]]))
    return w, U
