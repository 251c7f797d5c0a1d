"""Real/imag-split TDVP chain engine: real-time evolution in REAL
arithmetic only, for backends without complex kernels (the native
complex path is ``ops.tdvp_chain.tdvp_run`` with a complex sweep dtype).

Strategy: every complex tensor is a pair ``(Xr, Xi)`` of real arrays and
every kernel is expressed in real XLA ops:

- pairwise complex contractions = 4 real einsums (2 when one operand is
  real, e.g. the Hamiltonian MPO);
- norms / Rayleigh coefficients via Re<v,w> = <vr,wr> + <vi,wi>;
- the Lanczos tridiagonal T is REAL (Hermitian Lanczos), and
  ``exp(c T) e0`` for complex c runs as GEMM-only scaling-and-squaring
  in pair arithmetic (_expm_tridiag_pair_e0);
- the two-site split's orthonormalization uses POLAR form computed
  through the real embedding E(G) = [[Gr, -Gi], [Gi, Gr]] of the Gram
  matrix: E is a *-algebra homomorphism, so f(E(G)) = E(f(G)) for any
  analytic f — the real eigh of E(G) yields E(G^{-1/2}) whose blocks ARE
  the complex inverse square root. Pseudo-inverse cutoff keeps padded
  zero directions zero (the engine's bucket-and-mask convention).

Mirrors ops.tdvp_chain (`tdvp_run`) semantics: Lubich projector
splitting order 1/2, fixed-m Lanczos exponentials, padded static shapes,
one XLA program for the whole multi-step run. Ref
tensor4all-treetn/src/tdvp/mod.rs:1101; krylov.rs:640.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from .dmrg_chain import pad_mpo, pad_mps  # noqa: F401 (re-export)



def _cmul_ein(expr, ar, ai, br, bi, precision=None):
    """Complex pairwise einsum (4 real einsums)."""
    rr = jnp.einsum(expr, ar, br, optimize=True, precision=precision)
    ii = jnp.einsum(expr, ai, bi, optimize=True, precision=precision)
    ri = jnp.einsum(expr, ar, bi, optimize=True, precision=precision)
    ir = jnp.einsum(expr, ai, br, optimize=True, precision=precision)
    return rr - ii, ri + ir


def _cmul_ein3(expr, ar, ai, br, bi, precision=None):
    """Karatsuba complex pairwise einsum: THREE real einsums instead of
    four (rr, ii, and one on the operand sums), at the cost of one
    extra rounding in the imaginary part (|s - rr - ii| cancellation ~
    eps * |a||b| — f32 trajectory grade, below the Trotter floor for
    production steps; measured against the 4-einsum path). 25% fewer
    real GEMMs on the complex-complex hot stream of the real-time
    engine."""
    rr = jnp.einsum(expr, ar, br, optimize=True, precision=precision)
    ii = jnp.einsum(expr, ai, bi, optimize=True, precision=precision)
    sm = jnp.einsum(expr, ar + ai, br + bi, optimize=True,
                    precision=precision)
    return rr - ii, sm - rr - ii


def _rmul_ein(expr, ar, ai, w, precision=None):
    """Einsum of a complex pair against a REAL operand (2 real einsums)."""
    return (jnp.einsum(expr, ar, w, optimize=True, precision=precision),
            jnp.einsum(expr, ai, w, optimize=True, precision=precision))



def _expm_tridiag_pair_e0(diag, offd, c_re, c_im, max_squarings: int = 20):
    """First column of ``exp((c_re + i c_im) T)`` for real symmetric
    tridiagonal T, in real-pair arithmetic (no complex dtype — this
    chip raises UNIMPLEMENTED for complex kernels).

    Same GEMM-only masked scaling-and-squaring as
    ``tdvp_chain._expm_tridiag_e0`` (which replaced the ~555 us/call
    device eigh), with every complex m x m product expanded into real
    products of the (E_r, E_i) pair. Returns (coef_r, coef_i).
    """
    m = diag.shape[0]
    dt = diag.dtype
    b = offd.at[m - 1].set(0.0).astype(dt)
    T = (jnp.diag(diag) + jnp.diag(b[:-1], 1) + jnp.diag(b[:-1], -1))
    Ar = jnp.asarray(c_re, dt) * T
    Ai = jnp.asarray(c_im, dt) * T
    nrm = jnp.max(jnp.sum(jnp.abs(Ar) + jnp.abs(Ai), axis=0))
    s = jnp.ceil(jnp.maximum(jnp.log2(nrm / 0.5), 0.0))
    s = jnp.minimum(s, max_squarings).astype(jnp.int32)
    scale = (2.0 ** (-s)).astype(dt)
    Ar, Ai = Ar * scale, Ai * scale
    eye = jnp.eye(m, dtype=dt)
    Er, Ei = eye + Ar / 12.0, Ai / 12.0
    for k in range(11, 0, -1):
        # E <- I + (A @ E) / k, complex pair product
        Pr = Ar @ Er - Ai @ Ei
        Pi = Ar @ Ei + Ai @ Er
        Er, Ei = eye + Pr / k, Pi / k
    for i in range(max_squarings):
        Sr = Er @ Er - Ei @ Ei
        Si = Er @ Ei + Ei @ Er
        Er = jnp.where(i < s, Sr, Er)
        Ei = jnp.where(i < s, Si, Ei)
    return Er[:, 0], Ei[:, 0]


def _cproj_out(qr_, qi_, fr, fi):
    """(I - Q Q^H) F for complex pairs."""
    cr = qr_.T @ fr + qi_.T @ fi      # Re(Q^H F)
    ci = qr_.T @ fi - qi_.T @ fr      # Im(Q^H F)
    dr = fr - (qr_ @ cr - qi_ @ ci)
    di = fi - (qr_ @ ci + qi_ @ cr)
    return dr, di


def _merge_into_dead(qr_, qi_, cr_, ci_):
    """Assign C's live columns (orthonormal, perpendicular to Q's live
    span) to Q's dead column slots, order-preserving, no collisions.
    C may be WIDER than Q (extra candidates beyond Q's width are used
    only as far as dead slots remain)."""
    qcols = qr_.shape[1]
    live_q = jnp.sum(qr_ * qr_ + qi_ * qi_, axis=0) > 0.5
    live_c = jnp.sum(cr_ * cr_ + ci_ * ci_, axis=0) > 0.5
    dead_order = jnp.argsort(live_q, stable=True)        # dead slots first
    c_order = jnp.argsort(jnp.logical_not(live_c),
                          stable=True)[:qcols]           # live first
    n_dead = jnp.sum(jnp.logical_not(live_q))
    idx = jnp.arange(qcols)
    valid = ((idx < n_dead) & live_c[c_order]).astype(qr_.dtype)
    add_r = jnp.zeros_like(qr_).at[:, dead_order].set(
        cr_[:, c_order] * valid[None, :])
    add_i = jnp.zeros_like(qi_).at[:, dead_order].set(
        ci_[:, c_order] * valid[None, :])
    return qr_ + add_r, qi_ + add_i



def _frame_mgs(cr_all, ci_all, q, thresh, extra=None, chunk=64):
    """Masked Gram-Schmidt over frame candidates, CHUNK-BLOCKED: each
    chunk is bulk-projected against the accepted basis (and the optional
    `extra` fixed basis) with GEMMs; only within-chunk dedup runs
    sequentially — cutting the sequential matvec count from `width` full
    projections to `width` chunk-local ones plus width/chunk GEMMs (the
    real-time TDVP engine is otherwise MGS-latency-bound)."""
    p, width = cr_all.shape
    chunk = min(chunk, width)
    nch = -(-width // chunk)
    pad = nch * chunk - width
    if pad:
        cr_all = jnp.pad(cr_all, ((0, 0), (0, pad)))
        ci_all = jnp.pad(ci_all, ((0, 0), (0, pad)))
    dtype = cr_all.dtype
    tiny = jnp.finfo(dtype).tiny

    def chunk_body(carry, ci0):
        vr, vi, count = carry
        c0 = ci0 * chunk
        Cr = jax.lax.dynamic_slice(cr_all, (0, c0), (p, chunk))
        Ci = jax.lax.dynamic_slice(ci_all, (0, c0), (p, chunk))
        if extra is not None:
            er_, ei_ = extra
            Pr = er_.T @ Cr + ei_.T @ Ci
            Pi = er_.T @ Ci - ei_.T @ Cr
            Cr = Cr - (er_ @ Pr - ei_ @ Pi)
            Ci = Ci - (er_ @ Pi + ei_ @ Pr)
        # CGS2 ("twice is enough"): near-threshold acceptances normalize
        # residuals by up to 1/thresh ~ 2 sqrt(q), amplifying a single
        # pass's projection error into the accepted basis; one-pass MGS
        # measured orth err 1.2e1 on a kappa=1e6 f32 square operand
        # (stage-1 split of the real-time engine), 1.6e-5 with the
        # second pass (benchmarks/results/2026-08-19-split-fidelity.md)
        for _ in range(2):
            Pr = vr.T @ Cr + vi.T @ Ci
            Pi = vr.T @ Ci - vi.T @ Cr
            Cr = Cr - (vr @ Pr - vi @ Pi)
            Ci = Ci - (vr @ Pi + vi @ Pr)
        Lr = jnp.zeros((p, chunk), dtype)
        Li = jnp.zeros((p, chunk), dtype)

        def step(b, inner):
            vr, vi, Lr, Li, count, lcount = inner
            cr, ci = Cr[:, b], Ci[:, b]
            for _ in range(2):
                pr = Lr.T @ cr + Li.T @ ci
                pi = Lr.T @ ci - Li.T @ cr
                cr = cr - (Lr @ pr - Li @ pi)
                ci = ci - (Lr @ pi + Li @ pr)
            nrm = jnp.sqrt(jnp.sum(cr * cr + ci * ci))
            accept = ((nrm > thresh) & (count < q)).astype(dtype)
            inv = accept / jnp.maximum(nrm, tiny)
            ong = (jnp.arange(q) == count).astype(dtype) * accept
            onl = (jnp.arange(chunk) == lcount).astype(dtype) * accept
            vr = vr + jnp.outer(cr * inv, ong)
            vi = vi + jnp.outer(ci * inv, ong)
            Lr = Lr + jnp.outer(cr * inv, onl)
            Li = Li + jnp.outer(ci * inv, onl)
            a32 = accept.astype(count.dtype)
            return (vr, vi, Lr, Li, count + a32, lcount + a32)

        (vr, vi, Lr, Li, count, _) = jax.lax.fori_loop(
            0, chunk, step, (vr, vi, Lr, Li, count, jnp.int32(0)))
        return (vr, vi, count), None

    init = (jnp.zeros((p, q), dtype), jnp.zeros((p, q), dtype),
            jnp.zeros((), jnp.int32))
    (vr, vi, _), _ = jax.lax.scan(chunk_body, init, jnp.arange(nch))
    return vr, vi


def _corth_qr(yr, yi, seed: int = 11, complete: bool = True):
    """QR-grade complex orthonormalization via the real embedding — the
    accuracy-critical primitive (no Gram kappa^2 squaring anywhere).

    Real Householder QR of E(Y) = [[Yr, -Yi], [Yi, Yr]] (2p x 2q) gives
    an orthonormal REAL basis of the embedded column space; every real
    basis vector [a; b] maps to the complex vector a + i b INSIDE
    colspace(Y), and the mapped set is a TIGHT FRAME with frame constant
    2 (C C^H = 2 P): for any unit uncovered direction x,
    sum_j |<x, c_j>|^2 = 2, so some candidate has component >= 1/sqrt(q)
    — a masked Gram-Schmidt with threshold 0.5/sqrt(q) therefore NEVER
    loses a genuine direction, while pair-duplicates (i*v of an accepted
    v) give residual ~0 and are skipped. Dead slots (rank < q) are
    completed with junk directions orthogonal to the live span (the
    warm-started subspace iteration needs full-dimensional bases).

    Columns are pair-equilibrated to unit norm up front (span-
    preserving; noise columns below 10 eps of the max norm are zeroed,
    the _colnorm_qr contract). Without it the `genuine` R-diagonal mask
    below operates on sigma-weighted columns and kills LIVE tail
    directions of a broad Schmidt spectrum — measured as the real-time
    split engine's fidelity collapsing to 0.19-0.69 over 4 chi=512
    steps while the column-equilibrated _pair_cholqr held 0.99999.
    Equilibration + the CGS2 pass in _frame_mgs take the micro-repro's
    warm-started two-stage split from span residual 2.0e-3 to 3.8e-7
    on a kappa=1e6 f32 operand, beating _pair_cholqr's 7.2e-6
    (benchmarks/results/2026-08-19-split-fidelity.md)."""
    p, q = yr.shape
    yr, yi = _eqpair_cols(yr, yi)
    e = jnp.block([[yr, -yi], [yi, yr]])
    qe, re_ = jnp.linalg.qr(e)
    # mask QR's arbitrary completion of rank-deficient input: those
    # columns are NOT complex-structured (they are not in E(colspace))
    rdiag = jnp.abs(jnp.diagonal(re_))
    rmax = jnp.max(rdiag)
    genuine = (rdiag > 100 * jnp.finfo(yr.dtype).eps * rmax
               ).astype(yr.dtype)
    qe = qe * genuine[None, :]
    thresh = 0.5 / jnp.sqrt(jnp.asarray(float(q), yr.dtype))
    qr_, qi_ = _frame_mgs(qe[:p, :], qe[p:, :], q, thresh)
    if not complete:
        # full-rank operands need no dead-slot completion; skipping it
        # halves the embedded-QR count (production bench path)
        return qr_, qi_
    # completion for dead slots (junk pool wider than q; fixed-seed junk
    # recurs across call sites and can lose rank under the projection)
    key = jax.random.PRNGKey(seed)
    kf1, kf2 = jax.random.split(key)
    w = min(2 * q, p)
    fr = jax.random.normal(kf1, (p, w), yr.dtype)
    fi = jax.random.normal(kf2, (p, w), yr.dtype)
    dr, di = _cproj_out(qr_, qi_, fr, fi)
    er = jnp.block([[dr, -di], [di, dr]])
    qe2, re2 = jnp.linalg.qr(er)
    rd2 = jnp.abs(jnp.diagonal(re2))
    gen2 = (rd2 > 100 * jnp.finfo(yr.dtype).eps
            * jnp.maximum(jnp.max(rd2),
                          jnp.finfo(yr.dtype).tiny)).astype(yr.dtype)
    qe2 = qe2 * gen2[None, :]
    th2 = 0.5 / jnp.sqrt(jnp.asarray(float(w), yr.dtype))
    jr, ji = _frame_mgs(qe2[:p, :], qe2[p:, :], q, th2,
                        extra=(qr_, qi_))
    return _merge_into_dead(qr_, qi_, jr, ji)


def _stacked_qr_pair(yr, yi):
    """Complex-span-preserving basis conditioning by ONE real QR of the
    STACKED pair [Yr; Yi] (2p x q) — no embedding doubling, no
    frame-MGS.

    Why this is legal as the INNER step of a subspace iteration: real
    QR replaces Y by Y T with T a real invertible q x q matrix, and
    real-invertible IS complex-invertible, so the COMPLEX column span
    is exactly preserved. Why it conditions: the stacked columns come
    out real-orthonormal, so the complex Gram is I + iK with K real
    skew-symmetric and ||K|| <= 1 — eigenvalues in [0, 2], i.e. a
    bounded condition number independent of kappa(Y) (it degrades only
    where the complex span is genuinely rank-deficient: a column pair
    v, iv maps to a K eigenvalue at +-1). Columns are pair-equilibrated
    first and QR's arbitrary completion of sub-noise columns is masked
    by the R-diagonal (the `_colnorm_qr` contract). NOT a complex
    orthonormalization — outputs feed another GEMM, never a tensor
    factor."""
    p, _ = yr.shape
    yr, yi = _eqpair_cols(yr, yi)
    e = jnp.concatenate([yr, yi], axis=0)
    qe, re_ = jnp.linalg.qr(e)
    rdiag = jnp.abs(jnp.diagonal(re_))
    genuine = (rdiag > 100 * jnp.finfo(yr.dtype).eps
               * jnp.maximum(jnp.max(rdiag),
                             jnp.finfo(yr.dtype).tiny)).astype(yr.dtype)
    qe = qe * genuine[None, :]
    return qe[:p], qe[p:]


def _ns_polar_pair(wr, wi, iters: int = 48):
    """GEMM-only complex polar orthonormalization in pair arithmetic:
    Higham's Newton-Schulz polar iteration X <- X (3I - X^H X) / 2
    applied to the operand directly. No Cholesky, no triangular solve,
    no embedded QR, no sequential MGS — every step is q x q / p x q
    GEMMs.

    Convergence: each singular value follows s <- s (3 - s^2) / 2,
    monotone to 1 from any s in (0, sqrt(3)); X is pre-scaled by its
    Frobenius norm so s_max <= 1, and a tiny direction s needs about
    log_1.5(1/s) steps to surface — 48 iterations resolve relative
    s >= ~1e-8, past f32 resolution. Exact dead columns (s = 0) are
    fixed points and stay exactly zero (the complete_basis=False
    contract). Unlike the stacked-QR real basis (whose complex Gram is
    near-singular by (v, iv) pairing — measured lambda_min ~ 1e-11),
    the iteration acts on the COMPLEX operand, so the limit is the true
    complex polar factor: orthonormal columns spanning col(X), i.e.
    exactly what the two-site split needs, including the small-Schmidt
    tail (span error ~ eps at every scale; verified against dense expm
    and the corth gold trajectory)."""
    dt = wr.dtype
    q = wr.shape[1]
    hi = jax.lax.Precision.HIGHEST
    mm = functools.partial(jnp.matmul, precision=hi)
    nrm = jnp.sqrt(jnp.sum(wr * wr + wi * wi).astype(jnp.float64))
    s = (1.0 / jnp.maximum(nrm, jnp.finfo(jnp.float64).tiny)).astype(dt)
    xr, xi = wr * s, wi * s
    eye = jnp.eye(q, dtype=dt)
    for _ in range(iters):
        gr = mm(xr.T, xr) + mm(xi.T, xi)
        gi = mm(xr.T, xi) - mm(xi.T, xr)
        tr = 1.5 * eye - 0.5 * gr
        ti = -0.5 * gi
        xr, xi = mm(xr, tr) - mm(xi, ti), mm(xr, ti) + mm(xi, tr)
    return xr, xi


def _eqpair_cols(yr, yi):
    """Pair-column equilibration: scale each complex column (yr_j, yi_j)
    to unit joint norm; columns below the 10-eps noise threshold of the
    largest are zeroed (the `_colnorm_qr` contract). Span-preserving
    and free. The SINGLE definition of the noise threshold for every
    pair orthonormalizer — `_corth_qr`, `_pair_cholqr`,
    `_stacked_qr_pair` all equilibrate through here (the dynamic-range
    guard the r4 fidelity fix introduced), and `split_orth='eq'` uses
    it alone as the inner conditioner."""
    cn = jnp.sqrt(jnp.sum(yr * yr + yi * yi, axis=0, keepdims=True))
    scale = jnp.max(cn)
    keep = cn > 10 * jnp.finfo(yr.dtype).eps * jnp.maximum(
        scale, jnp.finfo(yr.dtype).tiny)
    inv = jnp.where(keep, 1.0 / jnp.where(keep, cn, 1.0), 0.0)
    return yr * inv, yi * inv


def _pair_cholqr(yr, yi, shifts=(1e-4, 1e-6, 0.0)):
    """GEMM-only COMPLEX orthonormalization in pair arithmetic:
    column-equilibrated shifted CholeskyQR through the INTERLEAVED real
    embedding (r4; complex sibling of ops.dmrg_chain._cholqr).

    Key fact: with the interleaved embedding E (each complex entry ->
    a 2x2 block [[a, -b], [b, a]]), E is a *-algebra homomorphism whose
    image is CLOSED under the Cholesky recursion — the diagonal blocks
    of a Hermitian-PD embedding are positive multiples of I_2, so the
    REAL Cholesky of E(G) is exactly E(chol(G)). One real (2q x 2q)
    Cholesky + one real triangular solve per pass therefore implement
    the complex CholeskyQR with no complex kernels at all (this chip
    raises UNIMPLEMENTED for complex dtypes). The solve convention is a
    conjugation sandwich: with row-pairs laid out as interleaved
    columns (r0, i0, r1, i1, ...), X L^H = Y in complex is
    conj_cols(X)_int @ E(L)^T = conj_cols(Y)_int (verified against
    complex Cholesky). Shift cascade + ||G||_inf safety floor as in
    `_cholqr`. Dead/noise columns are zeroed and STAY zero — projector
    completion, so callers that need junk completion for rank growth
    (complete_basis=True semantics) must keep `_corth_qr`."""
    p, q = yr.shape
    dt = yr.dtype
    eps = jnp.finfo(dt).eps
    qr_, qi_ = _eqpair_cols(yr, yi)
    hi = jax.lax.Precision.HIGHEST
    eye = jnp.eye(q, dtype=dt)
    for s in shifts:
        Gr = (jnp.matmul(qr_.T, qr_, precision=hi)
              + jnp.matmul(qi_.T, qi_, precision=hi))
        Gi = (jnp.matmul(qr_.T, qi_, precision=hi)
              - jnp.matmul(qi_.T, qr_, precision=hi))
        tr = jnp.trace(Gr)
        gn = jnp.max(jnp.sum(jnp.abs(Gr) + jnp.abs(Gi), axis=1))
        Gr = Gr + (s * jnp.maximum(tr, 1.0) / q + 60 * eps * gn) * eye
        K = jnp.zeros((2 * q, 2 * q), dt)
        K = K.at[0::2, 0::2].set(Gr).at[1::2, 1::2].set(Gr)
        K = K.at[0::2, 1::2].set(-Gi).at[1::2, 0::2].set(Gi)
        L = jnp.linalg.cholesky(K)
        Qint = jnp.stack([qr_, -qi_], axis=2).reshape(p, 2 * q)
        X = jax.lax.linalg.triangular_solve(
            L, Qint, left_side=False, lower=True, transpose_a=True)
        Xs = X.reshape(p, q, 2)
        qr_, qi_ = Xs[:, :, 0], -Xs[:, :, 1]
    return qr_, qi_


@functools.partial(
    jax.jit,
    static_argnames=("nsteps", "order", "krylov_m", "orthogonalize",
                     "split_iters", "complete_basis", "precision",
                     "reortho", "bf16_tail", "krylov_m1",
                     "expm_max_squarings", "gemm2_apply", "karatsuba",
                     "cholqr_split", "split_orth"),
)
def tdvp_run_split(
    h: jnp.ndarray,
    mps0_r: jnp.ndarray,
    mps0_i: jnp.ndarray,
    t_re: float,
    t_im: float,
    nsteps: int = 1,
    order: int = 2,
    krylov_m: int = 12,
    orthogonalize: bool = False,
    split_iters: int = 2,
    complete_basis: bool = True,
    precision: str = "highest",
    reortho: bool = True,
    bf16_tail: int = 0,
    krylov_m1: int | None = None,
    expm_max_squarings: int = 20,
    gemm2_apply: bool = False,
    karatsuba: bool = False,
    cholqr_split: bool = False,
    split_orth: str = "qr",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Evolve ``exp((t_re + i t_im) * H)|mps0>`` with a REAL padded MPO
    ``h`` and a complex state given as the (real, imag) pair; returns the
    evolved pair. All arrays f32/f64 real — no complex dtypes anywhere,
    with the chi^3 work in real GEMMs.

    ``split_orth`` picks the INNER basis conditioner of each two-site
    subspace iteration (the OUTER complex orthonormalization always
    runs at corth grade — its output is a tensor factor). The inner
    step only needs a complex-span-preserving, well-conditioned
    transform, not complex orthonormality, and the complex
    orthonormalizations are the engine's dominant per-bond fixed cost
    (the ~q sequential frame-MGS steps of `_corth_qr`):

    - ``"qr"`` (default): inner corth too — two complex
      orthonormalizations per iteration, the accuracy reference
      (gold-overlap 1-8e-7 at chi=256, 4 steps).
    - ``"cholqr1"``: ONE-pass complex CholeskyQR (`_pair_cholqr`,
      single small shift) — GEMMs + one (2q) Cholesky + one triangular
      solve, no embedded QR, no MGS. Its ~sqrt(eps) orthonormality
      floor does not matter in the INNER slot: the inner only needs
      complex CONDITIONING so the outer's noise-masking cannot zero a
      live direction, and CholeskyQR conditions to kappa ~ 1 even
      where it cannot orthonormalize to eps. Machine-precision
      trajectories on every fixture measured (6e-15 f64, both the
      near-real and the generic-complex starts) — the recommended
      production knob.
    - ``"stacked"``: ONE real Householder QR of the stacked pair
      [Zr; Zi] — span-exact and half the embedded panel width, but the
      real basis of a complex space can pair up (v, iv) directions
      (complex Gram I + iK with lambda_min -> 0), leaving the outer
      operand complex-ill-conditioned; measured STATE-DEPENDENT: 5e-6
      on one f64 fixture, 4.4e-3 on another (where "qr" holds 5e-15).
      A documented negative result — use "cholqr1".
    - ``"polar"``: "stacked" inner AND a GEMM-only outer — the
      Newton-Schulz complex polar iteration (`_ns_polar_pair`). No
      embedded QR, no frame-MGS, no Cholesky/triangular solve anywhere
      in the hot path — but the iteration passes through the Gram
      X^H X, so directions with relative sigma below ~sqrt(eps(dtype))
      are rounded away (the SAME blind spot that makes cholqr_split
      lose to "qr" on accuracy; _corth_qr's no-Gram design is the
      point). Measured: f64 trajectory err 1.8e-3 at split_iters=1
      (vs 5e-6 for "stacked"), recovered to 7.6e-6 by split_iters=2.
      A measured negative result for the f32 production path — use
      "stacked", which pays one Householder panel but squares nothing.
    - ``"eq"``: free pair-column equilibration only (unit joint norms,
      noise columns zeroed — `ops.dmrg_comb.split_mat`'s form).
      Fastest inner, but measured 6e-4 gold-infidelity over 4 chi=256
      steps (vs 8e-7 for "qr"): without the inner re-basis the f32
      outer product buries small Schmidt directions. Use where
      trajectory error budgets are loose.
    """
    if order not in (1, 2):
        raise ValueError("order must be 1 or 2")
    if split_orth not in ("qr", "cholqr1", "stacked", "eq", "polar"):
        raise ValueError(f"unknown split_orth {split_orth!r}")
    if split_orth == "polar" and complete_basis:
        # _ns_polar_pair has no junk completion: dead columns are fixed
        # points, so a rank-growth run would silently rank-lock
        raise ValueError(
            "split_orth='polar' cannot complete dead slots; it requires "
            "complete_basis=False (full-rank states only)")
    with jax.default_matmul_precision(precision):
        return _tdvp_sweeps_split(h, mps0_r, mps0_i, t_re, t_im, nsteps,
                                  order, krylov_m, orthogonalize,
                                  split_iters, complete_basis, reortho,
                                  bf16_tail, krylov_m1,
                                  expm_max_squarings, gemm2_apply,
                                  karatsuba, cholqr_split, split_orth)


def _tdvp_sweeps_split(h, mps0_r, mps0_i, t_re, t_im, nsteps, order,
                       krylov_m, orthogonalize, split_iters=2,
                       complete_basis=True, reortho=True, bf16_tail=0,
                       krylov_m1=None, expm_max_squarings=20,
                       gemm2_apply=False, karatsuba=False,
                       cholqr_split=False, split_orth="qr"):
    """``complete_basis=False`` skips dead-slot junk completion in every
    orthonormalization — exact for states that keep FULL padded rank
    throughout (e.g. full-rank random inits in benchmarks); states whose
    ranks must GROW during the run need the default True (the
    warm-started subspace iteration relies on full-dimensional bases)."""
    N, chi, d, _ = mps0_r.shape
    st = mps0_r.dtype
    cmul = _cmul_ein3 if karatsuba else _cmul_ein
    if cholqr_split:
        def corth(yr, yi, complete=True):
            # GEMM-only pair CholeskyQR; projector completion (dead
            # columns stay zero) — production full-rank path
            return _pair_cholqr(yr, yi)
    else:
        corth = _corth_qr
    hs = h.astype(st)
    mr, mi = mps0_r.astype(st), mps0_i.astype(st)
    m = krylov_m
    m1 = krylov_m if krylov_m1 is None else krylov_m1
    # bf16 tail (see ops.tdvp_chain.tdvp_run docstring): the factorial
    # decay of the propagator coefficients makes the TAIL Krylov applies
    # bf16-tolerant; f32 sweeps only.
    tail = bf16_tail if (bf16_tail and st == jnp.float32) else 0
    _P1 = jax.lax.Precision.DEFAULT  # fastest pass for bf16 operands

    def norm2_of(ar, ai):
        return (jnp.sum(ar * ar) + jnp.sum(ai * ai)).astype(jnp.float64)

    def apply_h2(Lr, Li, Wl, Wr, Rr, Ri):
        """theta' = L Wl Wr theta R with complex L, theta, R, real W."""

        if gemm2_apply:
            # per-bond precontraction (complex pair x REAL MPO core = 2
            # real einsums each), amortized over the m Krylov
            # iterations: every iteration is then TWO complex GEMMs =
            # 8 real GEMMs with every M/N/K >= chi d — no (w d)-sized
            # contraction (same trade as
            # ops.tdvp_chain.tdvp_run(gemm2_apply=True))
            LWr, LWi = _rmul_ein("alx,lpim->aixpm", Lr, Li, Wl)
            RWr, RWi = _rmul_ein("brB,mqjr->mjbqB", Rr, Ri, Wr)

            def f2(thr, thi):
                t1r, t1i = cmul("aixpm,aijb->xpmjb", LWr, LWi,
                                     thr, thi)
                return cmul("xpmjb,mjbqB->xpqB", t1r, t1i,
                                 RWr, RWi)

            if not tail:
                return f2, None
            bf16 = jnp.bfloat16
            LWrc, LWic = LWr.astype(bf16), LWi.astype(bf16)
            RWrc, RWic = RWr.astype(bf16), RWi.astype(bf16)

            def f2_lo(thr, thi):
                thr_c, thi_c = thr.astype(bf16), thi.astype(bf16)
                t1r, t1i = cmul("aixpm,aijb->xpmjb", LWrc, LWic,
                                     thr_c, thi_c, precision=_P1)
                outr, outi = cmul("xpmjb,mjbqB->xpqB", t1r, t1i,
                                       RWrc, RWic, precision=_P1)
                return outr.astype(st), outi.astype(st)
            return f2, f2_lo

        def f(thr, thi):
            t1r, t1i = cmul("alx,aijb->lxijb", Lr, Li, thr, thi)
            t2r, t2i = _rmul_ein("lxijb,lpim->xpmjb", t1r, t1i, Wl)
            t3r, t3i = _rmul_ein("xpmjb,mqjr->xpqrb", t2r, t2i, Wr)
            return cmul("xpqrb,brB->xpqB", t3r, t3i, Rr, Ri)

        if not tail:
            return f, None
        bf = jnp.bfloat16
        Lrc, Lic, Wlc = Lr.astype(bf), Li.astype(bf), Wl.astype(bf)
        Wrc, Rrc, Ric = Wr.astype(bf), Rr.astype(bf), Ri.astype(bf)

        def f_lo(thr, thi):
            thr_c, thi_c = thr.astype(bf), thi.astype(bf)
            t1r, t1i = cmul("alx,aijb->lxijb", Lrc, Lic,
                                 thr_c, thi_c, precision=_P1)
            t2r, t2i = _rmul_ein("lxijb,lpim->xpmjb", t1r, t1i, Wlc,
                                 precision=_P1)
            t3r, t3i = _rmul_ein("xpmjb,mqjr->xpqrb", t2r, t2i, Wrc,
                                 precision=_P1)
            outr, outi = cmul("xpqrb,brB->xpqB", t3r, t3i,
                                   Rrc, Ric, precision=_P1)
            return outr.astype(st), outi.astype(st)
        return f, f_lo

    def apply_h1(Lr, Li, W, Rr, Ri):
        if gemm2_apply:
            LWr, LWi = _rmul_ein("alx,lpir->aixpr", Lr, Li, W)

            def f1(ar, ai):
                t1r, t1i = cmul("aixpr,aib->xprb", LWr, LWi,
                                     ar, ai)
                return cmul("xprb,brB->xpB", t1r, t1i, Rr, Ri)

            if not tail:
                return f1, None
            bf16 = jnp.bfloat16
            LWrc, LWic = LWr.astype(bf16), LWi.astype(bf16)
            Rrc, Ric = Rr.astype(bf16), Ri.astype(bf16)

            def f1_lo(ar, ai):
                ar_c, ai_c = ar.astype(bf16), ai.astype(bf16)
                t1r, t1i = cmul("aixpr,aib->xprb", LWrc, LWic,
                                     ar_c, ai_c, precision=_P1)
                outr, outi = cmul("xprb,brB->xpB", t1r, t1i,
                                       Rrc, Ric, precision=_P1)
                return outr.astype(st), outi.astype(st)
            return f1, f1_lo

        def f(ar, ai):
            t1r, t1i = cmul("alx,aib->lxib", Lr, Li, ar, ai)
            t2r, t2i = _rmul_ein("lxib,lpir->xprb", t1r, t1i, W)
            return cmul("xprb,brB->xpB", t2r, t2i, Rr, Ri)

        if not tail:
            return f, None
        bf = jnp.bfloat16
        Lrc, Lic, Wc = Lr.astype(bf), Li.astype(bf), W.astype(bf)
        Rrc, Ric = Rr.astype(bf), Ri.astype(bf)

        def f_lo(ar, ai):
            ar_c, ai_c = ar.astype(bf), ai.astype(bf)
            t1r, t1i = cmul("alx,aib->lxib", Lrc, Lic, ar_c, ai_c,
                                 precision=_P1)
            t2r, t2i = _rmul_ein("lxib,lpir->xprb", t1r, t1i, Wc,
                                 precision=_P1)
            outr, outi = cmul("xprb,brB->xpB", t2r, t2i, Rrc, Ric,
                                   precision=_P1)
            return outr.astype(st), outi.astype(st)
        return f, f_lo

    def lanczos_expm(apply_pair, v0r, v0i, c_re, c_im, shape, m):
        """exp((c_re + i c_im) H) v0 by fixed-m Hermitian Lanczos in
        pair arithmetic (T stays real).

        PYTHON-UNROLLED over the static Krylov depth with sweep-grade
        scalars (r4, mirrors ops.tdvp_chain.lanczos_expm): the
        fori_loop + lax.cond form's per-iteration overhead (dynamic
        basis updates, cond scheduling barrier, emulated-f64 scalar
        chains) was the slope-measured bulk of the chain engine's
        fixed cost; the pair engine pays it twice per vector op.
        """
        apply_h, apply_lo = apply_pair
        sdt = st
        tiny = jnp.asarray(jnp.finfo(sdt).tiny, sdt)
        eps10 = jnp.asarray(10 * jnp.finfo(st).eps, sdt)
        n0 = jnp.sqrt(jnp.sum(v0r * v0r) + jnp.sum(v0i * v0i))
        inv = (1.0 / jnp.maximum(n0, tiny)).astype(st)
        vr, vi = v0r * inv, v0i * inv
        basis_r, basis_i = [], []
        alphas, betas, amask = [], [], []
        pvr, pvi = jnp.zeros_like(vr), jnp.zeros_like(vi)
        beta_prev = jnp.zeros((), sdt)
        alive = jnp.ones((), sdt)
        for i in range(m):
            al = alive.astype(st)
            basis_r.append(vr * al)
            basis_i.append(vi * al)
            f = apply_h if (apply_lo is None or i < tail) else apply_lo
            hvr, hvi = f(vr, vi)
            a = (jnp.sum(vr * hvr) + jnp.sum(vi * hvi)).astype(sdt)
            bp = beta_prev.astype(st)
            hvr = hvr - a.astype(st) * vr - bp * pvr
            hvi = hvi - a.astype(st) * vi - bp * pvi
            if reortho:
                bsr, bsi = jnp.stack(basis_r), jnp.stack(basis_i)
                ovr = (jnp.einsum("m...,...->m", bsr, hvr)
                       + jnp.einsum("m...,...->m", bsi, hvi))
                ovi = (jnp.einsum("m...,...->m", bsr, hvi)
                       - jnp.einsum("m...,...->m", bsi, hvr))
                hvr = hvr - (jnp.einsum("m,m...->...", ovr, bsr)
                             - jnp.einsum("m,m...->...", ovi, bsi))
                hvi = hvi - (jnp.einsum("m,m...->...", ovr, bsi)
                             + jnp.einsum("m,m...->...", ovi, bsr))
            b = jnp.sqrt(jnp.sum(hvr * hvr) + jnp.sum(hvi * hvi)
                         ).astype(sdt)
            binv = (1.0 / jnp.maximum(b, tiny)).astype(st)
            alphas.append(jnp.where(alive > 0, a, jnp.zeros((), sdt)))
            amask.append(alive)
            next_alive = alive * (b > eps10 * jnp.maximum(
                1.0, jnp.abs(a))).astype(sdt)
            betas.append(b * next_alive if i + 1 < m
                         else jnp.zeros((), sdt))
            pvr, pvi = vr, vi
            vr, vi = hvr * binv, hvi * binv
            beta_prev = b * alive
            alive = next_alive
        basis_r = jnp.stack(basis_r)
        basis_i = jnp.stack(basis_i)
        alphas = jnp.stack(alphas)
        betas = jnp.stack(betas)
        amask = jnp.stack(amask)
        # exp((c_re + i c_im) T) e0 by pair-arithmetic scaling-and-
        # squaring (dead slots carry zero diag/offd and decouple). The
        # solve runs at the sweep grade: eps(st)-grade coefficients match
        # the st-grade basis.
        coef_r, coef_i = _expm_tridiag_pair_e0(
            alphas.astype(st), betas.astype(st),
            jnp.asarray(c_re, st), jnp.asarray(c_im, st),
            max_squarings=expm_max_squarings)
        coef_r, coef_i = coef_r * amask, coef_i * amask
        cr, ci = coef_r.astype(st), coef_i.astype(st)
        out_r = (jnp.einsum("m,m...->...", cr, basis_r)
                 - jnp.einsum("m,m...->...", ci, basis_i))
        out_i = (jnp.einsum("m,m...->...", cr, basis_i)
                 + jnp.einsum("m,m...->...", ci, basis_r))
        s0 = n0.astype(st)
        return out_r * s0, out_i * s0



    def split_theta(thr, thi, q0r, q0i, toward_right):
        """Top-chi split via warm-started subspace iteration with polar
        orthonormalization after EACH half-application (keeps every
        intermediate at dynamic range sigma, as in dmrg_chain)."""
        mr_ = thr.reshape(chi * d, d * chi)
        mi_ = thi.reshape(chi * d, d * chi)
        # inner-step basis conditioner + outer orthonormalizer (see
        # tdvp_run_split docstring): only the OUTER factor needs
        # complex orthonormality
        if split_orth == "eq":
            inner = _eqpair_cols
        elif split_orth == "cholqr1":
            inner = functools.partial(_pair_cholqr, shifts=(1e-8,))
        elif split_orth in ("stacked", "polar"):
            inner = _stacked_qr_pair
        else:
            inner = lambda zr, zi: corth(zr, zi,  # noqa: E731
                                         complete=complete_basis)
        if split_orth == "polar":
            outer = _ns_polar_pair
        else:
            outer = lambda yr, yi: corth(yr, yi,  # noqa: E731
                                         complete=complete_basis)
        if toward_right:
            q0r_, q0i_ = q0r, q0i
            for _ in range(split_iters):
                zr, zi = inner(mr_.T @ q0r_ + mi_.T @ q0i_,
                               mr_.T @ q0i_ - mi_.T @ q0r_)  # M^H Q0
                qr_, qi_ = outer(mr_ @ zr - mi_ @ zi,
                                 mr_ @ zi + mi_ @ zr)
                q0r_, q0i_ = qr_, qi_
            left_r = qr_.reshape(chi, d, chi)
            left_i = qi_.reshape(chi, d, chi)
            rr = qr_.T @ mr_ + qi_.T @ mi_      # Q^H M
            ri = qr_.T @ mi_ - qi_.T @ mr_
            right_r = rr.reshape(chi, d, chi)
            right_i = ri.reshape(chi, d, chi)
        else:
            q0r_, q0i_ = q0r, q0i
            for _ in range(split_iters):
                zr, zi = inner(mr_ @ q0r_ - mi_ @ q0i_,
                               mr_ @ q0i_ + mi_ @ q0r_)
                qr_, qi_ = outer(mr_.T @ zr + mi_.T @ zi,
                                 mr_.T @ zi - mi_.T @ zr)  # M^H Z
                q0r_, q0i_ = qr_, qi_
            right_r = qr_.T.reshape(chi, d, chi)
            right_i = (-qi_.T).reshape(chi, d, chi)  # (Q^H)
            # left = M Q (ket-side factor)
            lr_ = mr_ @ qr_ - mi_ @ qi_
            li_ = mr_ @ qi_ + mi_ @ qr_
            left_r = lr_.reshape(chi, d, chi)
            left_i = li_.reshape(chi, d, chi)
        return left_r, left_i, right_r, right_i

    def update_left_env(Lr, Li, Ar, Ai, W):
        # L' = sum A W conj(A): bra = conj(A)
        t1r, t1i = cmul("alx,aib->lxib", Lr, Li, Ar, Ai)
        t2r, t2i = _rmul_ein("lxib,loir->xorb", t1r, t1i, W)
        # contract with conj(A): (x o B) over x, o
        rr = (jnp.einsum("xorb,xoB->brB", t2r, Ar)
              + jnp.einsum("xorb,xoB->brB", t2i, Ai))
        ii = (jnp.einsum("xorb,xoB->brB", t2i, Ar)
              - jnp.einsum("xorb,xoB->brB", t2r, Ai))
        return rr, ii

    def update_right_env(Rr, Ri, Ar, Ai, W):
        t1r, t1i = cmul("brB,aib->raiB", Rr, Ri, Ar, Ai)
        t2r, t2i = _rmul_ein("raiB,loir->laoB", t1r, t1i, W)
        rr = (jnp.einsum("laoB,xoB->alx", t2r, Ar)
              + jnp.einsum("laoB,xoB->alx", t2i, Ai))
        ii = (jnp.einsum("laoB,xoB->alx", t2i, Ar)
              - jnp.einsum("laoB,xoB->alx", t2r, Ai))
        return rr, ii

    Lb_r = jnp.zeros((chi, h.shape[1], chi), st).at[0, 0, 0].set(1.0)
    Rb_r = jnp.zeros((chi, h.shape[1], chi), st).at[0, 0, 0].set(1.0)
    Zb = jnp.zeros((chi, h.shape[1], chi), st)

    def get(stacked, k):
        return jax.lax.dynamic_index_in_dim(stacked, k, keepdims=False)

    def put(stacked, k, val):
        return jax.lax.dynamic_update_index_in_dim(stacked, val, k, axis=0)

    def right_env_scan(mr, mi):
        # Rs[k] = env of cores k+2..N-1 (right of block (k, k+1));
        # see ops.dmrg_chain.right_env_scan for the off-by-one history
        def body(R, k):
            Rn = update_right_env(R[0], R[1], get(mr, k), get(mi, k),
                                  get(hs, k))
            return Rn, Rn

        _, Rs = jax.lax.scan(body, (Rb_r, Zb), jnp.arange(N - 1, 1, -1))
        Rr = jnp.concatenate([jnp.flip(Rs[0], axis=0), Rb_r[None]],
                             axis=0)
        Ri = jnp.concatenate([jnp.flip(Rs[1], axis=0), Zb[None]],
                             axis=0)
        return (Rr, Ri)

    def right_orthogonalize_padded(mr, mi, renorm=False):
        """QR gauge sweep via polar orthonormalization of each core's
        right unfolding (any complex-orthonormal row basis works as a
        gauge; polar keeps it matmul+eigh only).

        ``renorm=True`` (initial gauge only): rescale the carried core
        to unit joint norm each step — the residual-factor product of a
        per-core-normalized random chain decays like c^N, and by site 0
        the f32 sum-of-squares lands in the denormal range that
        accelerators may FLUSH TO ZERO, NaN'ing the run (same guard as
        ops.tdvp_chain)."""

        def body(carry, k):
            mr, mi = carry
            ar, ai = get(mr, k), get(mi, k)
            # rows of (chi, d chi): orthonormalize columns of the dagger
            yr = ar.reshape(chi, d * chi).T
            yi = -ai.reshape(chi, d * chi).T  # conj transpose
            qr_, qi_ = corth(yr, yi, complete=complete_basis)  # (d chi, chi)
            core_r = qr_.T.reshape(chi, d, chi)
            core_i = (-qi_.T).reshape(chi, d, chi)
            # residual R = M Q (chi x chi complex); absorb into previous
            mr_flat = ar.reshape(chi, d * chi)
            mi_flat = ai.reshape(chi, d * chi)
            rr = mr_flat @ qr_ - mi_flat @ qi_
            ri = mr_flat @ qi_ + mi_flat @ qr_
            pr, pi = get(mr, k - 1), get(mi, k - 1)
            nr = (jnp.einsum("adb,bc->adc", pr, rr)
                  - jnp.einsum("adb,bc->adc", pi, ri))
            ni = (jnp.einsum("adb,bc->adc", pr, ri)
                  + jnp.einsum("adb,bc->adc", pi, rr))
            if renorm:
                mx = jnp.maximum(jnp.max(jnp.abs(nr)),
                                 jnp.max(jnp.abs(ni)))
                safe = jnp.where(mx > 0, mx, 1.0)
                nr, ni = nr / safe, ni / safe
                pn = jnp.sqrt(jnp.sum(nr * nr) + jnp.sum(ni * ni))
                safe = jnp.where(pn > 0, pn, 1.0).astype(st)
                nr, ni = nr / safe, ni / safe
            mr = put(put(mr, k, core_r), k - 1, nr)
            mi = put(put(mi, k, core_i), k - 1, ni)
            return (mr, mi), None

        (mr, mi), _ = jax.lax.scan(body, (mr, mi),
                                   jnp.arange(N - 1, 0, -1))
        return mr, mi

    if orthogonalize:
        # Two-stage PER-CORE normalization before the gauge sweep (same
        # guard as ops.tdvp_chain / _dmrg_sweeps): the QR sweep
        # concentrates the full state norm into core 0, and raw random
        # cores overflow f32 beyond N~20. Complex pair: one real scale
        # per core from the joint (r, i) magnitude.
        mag = jnp.sqrt(mr * mr + mi * mi)
        core_scale = jnp.max(mag, axis=(1, 2, 3), keepdims=True)
        safe = jnp.where(core_scale > 0, core_scale, 1.0)
        mr, mi = mr / safe, mi / safe
        core_norms = jnp.sqrt(jnp.sum(mr * mr + mi * mi, axis=(1, 2, 3),
                                      keepdims=True))
        safe = jnp.where(core_norms > 0, core_norms, 1.0)
        mr, mi = mr / safe, mi / safe
        mr, mi = right_orthogonalize_padded(mr, mi, renorm=True)
        n0 = jnp.sqrt(norm2_of(get(mr, 0), get(mi, 0)))
        inv = (1.0 / jnp.maximum(n0, jnp.finfo(jnp.float64).tiny)).astype(st)
        mr = put(mr, 0, get(mr, 0) * inv)
        mi = put(mi, 0, get(mi, 0) * inv)

    dt_re = jnp.float64(t_re) / nsteps
    dt_im = jnp.float64(t_im) / nsteps
    if order == 2:
        dt_re, dt_im = dt_re / 2.0, dt_im / 2.0

    def half_sweep_fwd(mr, mi, c_re, c_im):
        Rs = right_env_scan(mr, mi)

        def body(carry, x):
            k, Rkr, Rki = x
            mr, mi, Lr, Li = carry
            Ar, Ai = get(mr, k), get(mi, k)
            Br, Bi = get(mr, k + 1), get(mi, k + 1)
            th0r = (jnp.einsum("asb,btc->astc", Ar, Br)
                    - jnp.einsum("asb,btc->astc", Ai, Bi))
            th0i = (jnp.einsum("asb,btc->astc", Ar, Bi)
                    + jnp.einsum("asb,btc->astc", Ai, Br))
            thr, thi = lanczos_expm(
                apply_h2(Lr, Li, get(hs, k), get(hs, k + 1), Rkr, Rki),
                th0r, th0i, c_re, c_im, (chi, d, d, chi), m)
            lr, li, rr, ri = split_theta(
                thr, thi, Ar.reshape(chi * d, chi),
                Ai.reshape(chi * d, chi), True)
            Lnr, Lni = update_left_env(Lr, Li, lr, li, get(hs, k))
            gate = jnp.where(k < N - 2, 1.0, 0.0)
            rr, ri = lanczos_expm(
                apply_h1(Lnr, Lni, get(hs, k + 1), Rkr, Rki), rr, ri,
                -c_re * gate, -c_im * gate, (chi, d, chi), m1)
            mr = put(put(mr, k, lr), k + 1, rr)
            mi = put(put(mi, k, li), k + 1, ri)
            return (mr, mi, Lnr, Lni), (Lr, Li)

        (mr, mi, _, _), Ls = jax.lax.scan(
            body, (mr, mi, Lb_r, Zb),
            (jnp.arange(N - 1), Rs[0], Rs[1]))
        return mr, mi, Ls

    def half_sweep_bwd(mr, mi, c_re, c_im, Ls):
        def body(carry, x):
            k, Lkr, Lki = x
            mr, mi, Rr, Ri = carry
            Ar, Ai = get(mr, k), get(mi, k)
            Br, Bi = get(mr, k + 1), get(mi, k + 1)
            th0r = (jnp.einsum("asb,btc->astc", Ar, Br)
                    - jnp.einsum("asb,btc->astc", Ai, Bi))
            th0i = (jnp.einsum("asb,btc->astc", Ar, Bi)
                    + jnp.einsum("asb,btc->astc", Ai, Br))
            thr, thi = lanczos_expm(
                apply_h2(Lkr, Lki, get(hs, k), get(hs, k + 1), Rr, Ri),
                th0r, th0i, c_re, c_im, (chi, d, d, chi), m)
            lr, li, rr, ri = split_theta(
                thr, thi, Br.reshape(chi, d * chi).T,
                Bi.reshape(chi, d * chi).T, False)
            Rnr, Rni = update_right_env(Rr, Ri, rr, ri, get(hs, k + 1))
            gate = jnp.where(k > 0, 1.0, 0.0)
            lr, li = lanczos_expm(
                apply_h1(Lkr, Lki, get(hs, k), Rnr, Rni), lr, li,
                -c_re * gate, -c_im * gate, (chi, d, chi), m1)
            mr = put(put(mr, k, lr), k + 1, rr)
            mi = put(put(mi, k, li), k + 1, ri)
            return (mr, mi, Rnr, Rni), None

        (mr, mi, _, _), _ = jax.lax.scan(
            body, (mr, mi, Rb_r, Zb),
            (jnp.arange(N - 2, -1, -1),
             jnp.flip(Ls[0], axis=0), jnp.flip(Ls[1], axis=0)))
        return mr, mi

    def one_step(_, carry):
        mr, mi = carry
        mr, mi, Ls = half_sweep_fwd(mr, mi, dt_re, dt_im)
        if order == 2:
            mr, mi = half_sweep_bwd(mr, mi, dt_re, dt_im, Ls)
        else:
            mr, mi = right_orthogonalize_padded(mr, mi)
        return mr, mi

    mr, mi = jax.lax.fori_loop(0, nsteps, one_step, (mr, mi))
    return mr, mi


def tdvp_chain_split(h_cores, init_cores, t, chi, nsteps=1, order=2,
                     krylov_m=12, dtype=jnp.float32, **knobs):
    """Convenience driver for the split engine: pad on host, run ONE
    real-arithmetic device program. ``t`` complex (e.g. ``-1j*T``);
    ``init_cores`` may be real or complex. Extra ``knobs`` forward to
    `tdvp_run_split` (karatsuba, cholqr_split, bf16_tail, ...)."""
    import numpy as np

    h = pad_mpo([jnp.asarray(np.real(np.asarray(c)), dtype)
                 for c in h_cores])
    normed_r, normed_i = [], []
    for c in init_cores:
        a = np.asarray(c, dtype=np.complex128)
        mmax = float(np.abs(a).max()) if a.size else 0.0
        if mmax > 0:
            a = a / mmax
            a = a / float(np.linalg.norm(a))
        normed_r.append(np.real(a))
        normed_i.append(np.imag(a))
    mr = pad_mps([jnp.asarray(c, dtype) for c in normed_r], chi)
    mi = pad_mps([jnp.asarray(c, dtype) for c in normed_i], chi)
    t = complex(t)
    return tdvp_run_split(h, mr, mi, t.real, t.imag, nsteps=nsteps,
                          order=order, krylov_m=krylov_m,
                          orthogonalize=True, **knobs)
