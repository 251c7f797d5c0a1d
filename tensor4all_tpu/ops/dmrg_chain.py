"""Fully-jitted two-site DMRG engine for chains (the hot path).

This is the bucket-and-mask design of SURVEY.md §7 applied to DMRG: every
MPS core is zero-padded to a static (chi, d, chi) shape (boundaries
embedded at slot 0), so an ENTIRE multi-sweep DMRG run is one XLA program
— no host round trips, no recompilation as ranks grow.

Precision strategy (SURVEY.md §7 hard part 4): the engine runs the sweep
hot loop in a configurable ``sweep_dtype`` (f32 for speed) and recovers
full accuracy from variational structure: the final energy is a global
f64 Rayleigh quotient <psi|H|psi>/<psi|psi> of the optimized MPS, so a
state error eps from the f32 sweeps costs only O(eps^2) ~ 1e-12 in the
energy. That argument needs f32-grade matmuls in the sweeps: on a GPU,
``"high"`` is TF32 (10-bit mantissa), so the accurate settings are
``"highest"`` or an ``*_X3`` dot-algorithm preset.

Two-site splits avoid the SVD entirely: a warm-started subspace
iteration (2 steps of Y <- theta theta^T Y + QR) extracts the dominant
chi-dimensional bond basis. Since the padded engine always keeps exactly
chi directions, only the *span* matters, never the singular-value order —
QR is the only factorization needed.

Local eigensolver: fixed-iteration Lanczos on the two-site block with the
(chi, w, chi) environments applied as one einsum per iteration; the small
tridiagonal Ritz problem is solved by Sturm bisection (or eigh) in f64
with a well-scaled inactive-diagonal sentinel (huge sentinels like 1e8
cost eigh its accuracy).

The flexible host-driven TreeTN DMRG (treetn.dmrg) shares the same
algorithm; this engine is the speed-of-light path for chain topologies
(the reference's headline benchmark, BASELINE.md row 1; ref
crates/tensor4all-treetn/src/dmrg/mod.rs:626).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def pad_mps(cores: List[jnp.ndarray], chi: int) -> jnp.ndarray:
    """Zero-pad rank-3 cores to a stacked (N, chi, d, chi) array."""
    N = len(cores)
    d = cores[0].shape[1]
    out = np.zeros((N, chi, d, chi), dtype=np.asarray(cores[0]).dtype)
    for k, c in enumerate(cores):
        a, dd, b = c.shape
        if a > chi or b > chi:
            raise ValueError(f"core {k} exceeds chi={chi}: {c.shape}")
        out[k, :a, :, :b] = np.asarray(c)
    return jnp.asarray(out)


def _colnorm_qr(Y):
    """Orthonormal basis of Y's column span via column-equilibrated QR.

    The subspace-iteration splits feed QR matrices whose columns span
    11+ orders of magnitude when theta is rank-deficient (live rank r
    << chi: the trailing chi - r columns of mat (mat^H Q0) are pure
    rounding noise at ~1e-11..1e-14 of the leading scale). An f32
    Householder kernel can lose orthonormality catastrophically on that
    dynamic range (seen on an earlier accelerator at N=16 chi=128 and
    N=32 chi=256; the one-site expm then amplified the spurious
    directions and NaN'd the run). Equilibration is EXACT for subspace iteration (only the span
    matters): columns above 10*eps(dtype) of the max norm are scaled to
    unit; columns below it are pure noise and are ZEROED — Householder
    assigns zero columns an orthonormal completion (verified on the
    failing operands: orth error back to ~6e-7, span residual ~3e-6 =
    f32 grade), and Q^H mat maps completions to ~0 so the split is
    unchanged.
    """
    cn = jnp.sqrt(jnp.sum(jnp.abs(Y) ** 2, axis=0, keepdims=True))
    scale = jnp.max(cn)
    keep = cn > 10 * jnp.finfo(Y.dtype).eps * jnp.maximum(
        scale, jnp.finfo(Y.dtype).tiny)
    Yn = jnp.where(keep, Y / jnp.where(keep, cn, 1.0).astype(Y.dtype),
                   jnp.zeros((), Y.dtype))
    return jnp.linalg.qr(Yn)[0]


def _cholqr(Y, shifts=(1e-4, 1e-6, 0.0)):
    """GEMM-only orthonormal basis of Y's column span: column-
    equilibrated SHIFTED CholeskyQR, one pass per entry of ``shifts``.

    Drop-in replacement for `_colnorm_qr`: a CholeskyQR pass is 2 GEMMs
    + a chi x chi Cholesky + a triangular solve, where a Householder QR
    of a (chi d, chi) panel is a long chain of small panel updates.
    Numerics (Fukaya et al., shifted CholeskyQR3):
    pass k forms the Gram G = Q^H Q at f32 HIGHEST precision
    (independent of the surrounding sweep's matmul-precision default —
    a bf16-pass Gram has an ~1e-3 noise floor that no safe shift
    clears), adds ``shifts[k] * tr(G)/q``
    to the diagonal, and replaces Q by Q R^{-1}. The first generous
    shift caps the working condition number at ~sqrt(q / shift) (inside
    the f32 CholeskyQR2 domain cond <~ 1/sqrt(eps)); the later passes
    restore orthonormality to f32 grade. Same dead-column contract as
    `_colnorm_qr`: noise columns are zeroed up front and the shift-only
    diagonal keeps the Cholesky finite, so dead columns stay exactly
    zero (a projector completion, which is what the padded engines'
    masked-rank convention wants) rather than Householder's arbitrary
    orthonormal completion."""
    eps = jnp.finfo(Y.dtype).eps
    q = Y.shape[1]
    cn = jnp.sqrt(jnp.sum(jnp.abs(Y) ** 2, axis=0, keepdims=True))
    scale = jnp.max(cn)
    keep = cn > 10 * eps * jnp.maximum(scale, jnp.finfo(Y.dtype).tiny)
    Q = jnp.where(keep, Y / jnp.where(keep, cn, 1.0).astype(Y.dtype),
                  jnp.zeros((), Y.dtype))
    hi = jax.lax.Precision.HIGHEST
    eye = jnp.eye(q, dtype=Y.dtype)
    for s in shifts:
        G = jnp.matmul(jnp.conj(Q).T, Q, precision=hi)
        # cascading shift (restores weak directions pass by pass) PLUS
        # a ||G||_inf-scaled safety floor: low-rank thetas (chain ends:
        # rank <= d^k << chi) have CORRELATED equilibrated columns, so
        # ||G||_2 ~ tr(G) and the Gram's rounding pushes eigenvalues
        # ~ -eps ||G||_2 below zero — a mean-diag-only shift
        # under-covers that and the Cholesky NaNs (seen at N=32
        # chi=512). The floor is ~4e-6 once G ~ I, so the
        # cascade's tail still restores weak directions.
        tr = jnp.trace(jnp.real(G))
        gn = jnp.max(jnp.sum(jnp.abs(G), axis=1))
        G = G + (s * jnp.maximum(tr, 1.0) / q + 60 * eps * gn) * eye
        R = jnp.linalg.cholesky(G)  # lower: G = R R^H
        Q = jax.lax.linalg.triangular_solve(
            R, Q, left_side=False, lower=True,
            transpose_a=True, conjugate_a=True)  # Q <- Q R^{-H}
    return Q


def pad_mpo(cores: List[jnp.ndarray]) -> jnp.ndarray:
    """Stack rank-4 MPO cores to (N, w, d, d, w), boundaries at slot 0."""
    w = max(max(c.shape[0], c.shape[-1]) for c in cores)
    N = len(cores)
    d = cores[0].shape[1]
    out = np.zeros((N, w, d, d, w), dtype=np.asarray(cores[0]).dtype)
    for k, c in enumerate(cores):
        l, _, _, r = c.shape
        out[k, :l, :, :, :r] = np.asarray(c)
    return jnp.asarray(out)


def _tridiag_ground(diag: jnp.ndarray, offd: jnp.ndarray,
                    n_grid: int = 64, n_rounds: Optional[int] = None,
                    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Ground eigenpair of a symmetric tridiagonal matrix, GEMM-free.

    ``jnp.linalg.eigh`` on an m x m tridiagonal is a full-spectrum
    iterative factorization — and the DMRG/TDVP engines run it once per
    two-site update inside the sweep scan. The engines only need the
    SMALLEST eigenpair, so this uses:

      1. Sturm-sequence bisection, vectorized over ``n_grid`` candidate
         shifts per round (the m-step recurrence runs over (n_grid,)
         lanes — pure elementwise work). ``n_rounds``
         rounds shrink the Gershgorin bracket by grid^rounds ~ 2^24.
      2. Tridiagonal inverse iteration (Thomas solve, scalar scan) at the
         converged lower bracket edge — count(lo)=0 keeps T - lo*I
         positive semidefinite, so the pivot recurrence cannot break —
         followed by a Rayleigh-quotient refinement of the eigenvalue.

    Inputs follow the engines' sentinel convention: inactive slots carry
    a large ``diag`` sentinel and zero ``offd`` (decoupled blocks), so
    the ground state lives in the active block and the inverse iteration
    leaves ~0 weight on the sentinels automatically. Near-degenerate
    clusters (Lanczos ghosts under no-reorthogonalization) yield an
    arbitrary vector inside the cluster, which is exactly as usable as
    eigh's choice (the Ritz combination spans the same state).

    Args:
      diag: (m,) diagonal.
      offd: (m,) off-diagonal; slot i couples i and i+1 (the last slot
        is ignored).
    Returns (eigenvalue, unit eigenvector), both in ``diag.dtype``.
    """
    m = diag.shape[0]
    dt = diag.dtype
    if n_rounds is None:
        # bracket shrink is (n_grid+1)^rounds; 4 rounds already exceed
        # f32 resolution (65^4 ~ 1.8e7 > 1/eps_f32 relevant range), the
        # 5th only pays off in f64
        n_rounds = 5 if dt == jnp.float64 else 4
    b = offd.at[m - 1].set(0.0)
    b2 = b * b
    r = jnp.abs(b) + jnp.abs(jnp.concatenate([jnp.zeros((1,), dt),
                                              b[:-1]]))
    lo = jnp.min(diag - r)
    hi = jnp.max(diag + r)
    tiny = jnp.asarray(jnp.finfo(dt).tiny, dt)
    eps = jnp.asarray(jnp.finfo(dt).eps, dt)

    # everything below unrolls over the (static, small) m: straight-line
    # elementwise code fuses into a handful of loops, where a
    # lax.scan would pay ~1-2 us of sequential-step overhead per site

    def sturm_counts(xs):
        """# eigenvalues < x for each x in xs, via the pivot recurrence
        d_i = (a_i - x) - b_{i-1}^2 / d_{i-1} (negatives counted)."""
        d = diag[0] - xs
        d = jnp.where(jnp.abs(d) < tiny, -tiny, d)
        cnt = (d < 0).astype(jnp.int32)
        for i in range(1, m):
            d = (diag[i] - xs) - b2[i - 1] / d
            # guard exact zeros (x hits a leading-minor eigenvalue)
            d = jnp.where(jnp.abs(d) < tiny, -tiny, d)
            cnt = cnt + (d < 0)
        return cnt

    ts = (jnp.arange(1, n_grid + 1, dtype=dt)) / (n_grid + 1)
    for _ in range(n_rounds):
        xs = lo + ts * (hi - lo)
        cnt = sturm_counts(xs)
        # new lo: largest grid point with count 0; new hi: smallest with
        # count >= 1 (brackets always retain lambda_min)
        lo = jnp.max(jnp.where(cnt == 0, xs, lo))
        hi = jnp.min(jnp.where(cnt >= 1, xs, hi))

    def thomas_solve(shift, rhs):
        """(T - shift I) x = rhs, pivot-guarded Thomas algorithm."""
        dd = diag - shift
        cs, ss = [], []
        cp = jnp.zeros((), dt)
        sp = jnp.zeros((), dt)
        for i in range(m):
            bl = b[i - 1] if i > 0 else jnp.zeros((), dt)
            denom = dd[i] - bl * cp
            denom = jnp.where(jnp.abs(denom) < tiny, tiny, denom)
            cp = b[i] / denom
            sp = (rhs[i] - bl * sp) / denom
            cs.append(cp)
            ss.append(sp)
        x = ss[m - 1]
        out = [x]
        for i in range(m - 2, -1, -1):
            x = ss[i] - cs[i] * x
            out.append(x)
        return jnp.stack(out[::-1])

    # inverse iteration at the PSD lower edge; two passes sharpen the
    # vector when the bracket is loose relative to the spectral gap
    scale = jnp.maximum(jnp.abs(lo), jnp.abs(hi)) + 1.0
    sigma = lo - 4.0 * eps * scale
    v = jnp.ones((m,), dt) / jnp.sqrt(jnp.asarray(m, dt))
    for _ in range(2):
        v = thomas_solve(sigma, v)
        nrm = jnp.sqrt(jnp.sum(v * v))
        v = v / jnp.where(nrm > 0, nrm, 1.0)
    tv = diag * v + jnp.concatenate([b[:-1] * v[1:], jnp.zeros((1,), dt)]) \
        + jnp.concatenate([jnp.zeros((1,), dt), b[:-1] * v[:-1]])
    lam = jnp.sum(v * tv)
    return lam, v


def _rayleigh_chain(h: jnp.ndarray, mps: jnp.ndarray) -> jnp.ndarray:
    """Global Rayleigh quotient <psi|H|psi>/<psi|psi> (transfer scan)."""
    N, chi, d, _ = mps.shape
    w = h.shape[1]
    dtype = mps.dtype

    L0 = jnp.zeros((chi, w, chi), dtype).at[0, 0, 0].set(1.0)

    def body_num(L, k):
        A = jax.lax.dynamic_index_in_dim(mps, k, keepdims=False)
        W = jax.lax.dynamic_index_in_dim(h, k, keepdims=False)
        L = jnp.einsum("alx,aib,loir,xoB->brB", L, A, W, jnp.conj(A),
                       optimize=True)
        return L, None

    Lf, _ = jax.lax.scan(body_num, L0, jnp.arange(N))
    num = Lf[0, 0, 0]

    T0 = jnp.zeros((chi, chi), dtype).at[0, 0].set(1.0)

    def body_den(T, k):
        A = jax.lax.dynamic_index_in_dim(mps, k, keepdims=False)
        T = jnp.einsum("ax,aib,xiB->bB", T, A, jnp.conj(A), optimize=True)
        return T, None

    Tf, _ = jax.lax.scan(body_den, T0, jnp.arange(N))
    den = Tf[0, 0]
    return jnp.real(num / den)


@functools.partial(
    jax.jit, static_argnames=("n_sweeps", "lanczos_iters", "sweep_dtype",
                              "coarse_sweeps", "coarse_lanczos_iters",
                              "coarse_bf16", "coarse_reortho",
                              "coarse_ns_split", "fine_precision",
                              "fine_reortho", "gemm2_apply",
                              "fine_ns_inner", "ritz_solver",
                              "energy_precision", "fine_half_sweep",
                              "fine_cholqr", "fine_split_iters")
)
def dmrg_run(
    h: jnp.ndarray,
    mps0: jnp.ndarray,
    n_sweeps: int = 4,
    lanczos_iters: int = 20,
    sweep_dtype=None,
    coarse_sweeps: int = 0,
    coarse_lanczos_iters: Optional[int] = None,
    coarse_bf16: bool = False,
    coarse_reortho: bool = True,
    coarse_ns_split: bool = False,
    fine_precision: str = "highest",
    fine_reortho: bool = True,
    gemm2_apply: bool = False,
    fine_ns_inner: bool = False,
    ritz_solver: str = "bisect",
    energy_precision: str = "f64",
    fine_half_sweep: bool = False,
    fine_cholqr: bool = False,
    fine_split_iters: int = 2,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Run `n_sweeps` full (left-right-left) two-site DMRG sweeps.

    Args:
      h: (N, w, d, d, w) padded MPO (boundary slots 0).
      mps0: (N, chi, d, chi) padded MPS.
      sweep_dtype: dtype for the sweep hot loop (default: same as input;
        pass ``jnp.float32`` for speed — the final energy is refined to a
        full-precision global Rayleigh quotient regardless).
      coarse_sweeps: run the FIRST `coarse_sweeps` sweeps with fast
        matmuls (the "default" matmul precision) and
        a single subspace iteration per split. DMRG is variational and
        self-correcting: the remaining full-precision sweeps re-factorize
        every core and restore the eps_f32-grade state, so the final
        energy (f64 Rayleigh quotient, error O(eps^2)) is unchanged while
        the chi^3 hot loop runs at the fast rate for most of the run.
      coarse_lanczos_iters: Lanczos depth for the coarse sweeps
        (default: same as fine). Early sweeps only need rough local
        progress; the reference's own eigensolver runs krylovdim=3.
      coarse_bf16: store the Lanczos basis and apply operands in
        bfloat16 during coarse sweeps — halves the HBM traffic of the
        bandwidth-bound reortho/apply loop (accumulation stays f32).
      coarse_reortho: full per-iteration reorthogonalization in coarse
        sweeps; False keeps the plain 3-term recurrence (the reortho
        reads can cost more than the H apply at large chi).
      coarse_ns_split: orthogonalize coarse two-site splits by the
        GEMM-only Newton-Schulz inverse-sqrt iteration instead of
        Householder QR.
      fine_precision: matmul precision of the fine sweeps ('highest' =
        f32-grade products; 'high' is TF32 on a GPU, a 10-bit mantissa,
        too coarse for the eps^2 energy argument).
      fine_reortho: full reorthogonalization in the fine sweeps
        (default True). The reference's own local eigensolver runs
        krylovdim=3 with no reorthogonalization at all
        (dmrg/mod.rs:626) — fine_reortho=False is plain 3-term-recurrence
        Lanczos, whose Ritz values stay within O(eps*|H|) of the spectrum
        (Paige) and whose ground-Ritz vector only feeds the next
        variational step. A full-NS FINAL split orthogonalization in fine
        sweeps was tested and rejected: theta's steeply-decaying spectrum
        leaves NS unconverged mid-spectrum (energy err 0.18 at N=8), so
        the final factor always uses QR outside the coarse schedule.
      gemm2_apply: contract the local H as TWO large GEMMs per Lanczos
        iteration against per-bond precontracted L*Wl / Wr*R operands
        (2x the FLOPs of the minimal 4-stage einsum path, but no small-K
        (w d) GEMMs and no 5-tensor intermediate shuffles).
      fine_ns_inner: use the GEMM-only Newton-Schulz orthogonalization
        for the INNER subspace-iteration steps of fine-sweep splits
        (the final factor stays Householder QR either way). Faster, but
        the NS residual (~1e-6 orthonormality)
        costs ~1e-9 in the final energy at N=8 — leave False when the
        reference's 1e-12 energy-parity contract matters. Coarse sweeps
        always use NS inner steps (self-correcting).
      ritz_solver: solver for the m x m tridiagonal Ritz problem, once
        per two-site update inside the sweep scan. 'bisect' (default):
        Sturm bisection + inverse iteration (_tridiag_ground) in f64,
        ground pair identical to eigh to ~1e-13. 'bisect_f32': the same
        in f32 (coefficient error ~eps_f32 matches the f32 basis grade —
        the final energy is an f64 Rayleigh quotient either way). 'eigh':
        the LAPACK-style iterative kernel.
      energy_precision: dtype of the FINAL global Rayleigh quotient.
        'f64' (default): f64 einsums — evaluation error ~eps_f64 so the
        reported energy carries the full O(eps_sweep^2) variational grade
        (the 1e-12 parity contract at small sizes). 'mixed': the transfer
        scan runs in f32 with 'highest' matmuls and f64 final scalars —
        evaluation error ~sqrt(N K) eps_f32 ~1e-6 RELATIVE, which
        dominates the eps^2 state term; the state itself is identical
        (re-evaluate with 'f64' when needed).
      fine_split_iters: subspace-iteration steps per fine-sweep split
        (default 2). The splits are warm-started from the current core,
        so on a nearly-converged state ONE step already captures the
        dominant span; 1 halves the fine sweep's QR-panel fixed cost.
      fine_cholqr: orthonormalize fine-sweep splits with shifted
        CholeskyQR (`_cholqr`, GEMM-only: Gram at f32 HIGHEST + shifted
        Cholesky + triangular solve) instead of Householder QR panels.
        `_cholqr` pins the Gram/solve to f32 HIGHEST regardless of the
        sweep default (a low-precision Gram NaNs the Cholesky, see the
        NOTE in split_theta) and equilibrates columns first; the final
        factor reaches f32-grade orthogonality for full-rank thetas.
    Returns (energy, optimized padded MPS in sweep_dtype).
    """
    coarse_sweeps = min(coarse_sweeps, n_sweeps)
    # the "default" f32 matmul precision is below f32 grade on
    # accelerators — the FINE sweeps need f32-grade products for the
    # variational eps^2 refinement argument to hold.
    mps = mps0
    if coarse_sweeps > 0:
        m_coarse = (lanczos_iters if coarse_lanczos_iters is None
                    else coarse_lanczos_iters)
        with jax.default_matmul_precision("default"):
            _, mps = _dmrg_sweeps(h, mps, coarse_sweeps, m_coarse,
                                  sweep_dtype, split_iters=1,
                                  store_bf16=coarse_bf16,
                                  reortho=coarse_reortho,
                                  ns_split=coarse_ns_split,
                                  ns_inner=True,
                                  gemm2_apply=gemm2_apply,
                                  ritz=ritz_solver)
        mps = mps.astype(mps0.dtype)
    with jax.default_matmul_precision(fine_precision):
        return _dmrg_sweeps(h, mps, n_sweeps - coarse_sweeps,
                            lanczos_iters, sweep_dtype,
                            reortho=fine_reortho,
                            ns_inner=fine_ns_inner,
                            gemm2_apply=gemm2_apply,
                            ritz=ritz_solver,
                            energy_precision=energy_precision,
                            half_sweep=fine_half_sweep,
                            cholqr=fine_cholqr,
                            split_iters=fine_split_iters)


def _dmrg_sweeps(h, mps0, n_sweeps, lanczos_iters, sweep_dtype,
                 split_iters: int = 2, store_bf16: bool = False,
                 reortho: bool = True, ns_split: bool = False,
                 ns_inner: bool = False, gemm2_apply: bool = False,
                 ritz: str = "eigh", energy_precision: str = "f64",
                 half_sweep: bool = False, cholqr: bool = False):
    N, chi, d, _ = mps0.shape
    w = h.shape[1]
    hi_dtype = mps0.dtype
    st = jnp.dtype(sweep_dtype) if sweep_dtype is not None else hi_dtype
    # compute/storage dtype of the Lanczos hot loop: bf16 halves the
    # HBM traffic of the bandwidth-bound basis reads/writes; GEMMs
    # accumulate in f32 either way, and scalar recurrences stay f64
    ct = jnp.bfloat16 if (store_bf16 and st == jnp.float32) else st
    hs = h.astype(st)
    # Normalize every core BEFORE the precision cast: scaling cores only
    # rescales the state (TT multilinearity), and a right-canonical
    # input concentrates the full state norm in core 0 — random inits
    # put it at ~1e-19 for N=32, whose f32 sum-of-squares underflows and
    # silently zeroed the first theta (garbage/NaN ground states).
    # Two-stage scaling so the guard itself cannot underflow even when
    # mps0 is ALREADY f32 with ~1e-19 entries: max-abs first (exact, no
    # sum-of-squares), then the 2-norm of the O(1)-rescaled core so
    # every core ends at unit norm (a bare max-abs rescale leaves core
    # norms ~sqrt(size), whose product overflows f32 at N = 32).
    core_scale = jnp.max(jnp.abs(mps0), axis=(1, 2, 3), keepdims=True)
    mps_o1 = mps0 / jnp.where(core_scale > 0, core_scale, 1.0)
    core_norms = jnp.sqrt(jnp.sum(jnp.abs(mps_o1) ** 2, axis=(1, 2, 3),
                                  keepdims=True))
    mps = (mps_o1 / jnp.where(core_norms > 0, core_norms, 1.0)).astype(st)
    real_st = jnp.finfo(st).dtype

    def norm_site(A):
        n = jnp.sqrt(jnp.sum(jnp.abs(A) ** 2))
        return A / jnp.where(n > 0, n, 1.0)

    m = lanczos_iters

    def lanczos_ground(theta0, L, Wl, Wr, R):
        """Ritz ground state of the projected 2-site H, fixed-m Lanczos
        with (optional) full reorthogonalization. Coefficients
        accumulate in the sweep dtype; the m x m tridiagonal solve runs
        in f64 with a well-scaled sentinel on inactive slots. The basis
        is stored in `ct` (bf16 under coarse_bf16): its reads/writes are
        the bandwidth bound of the loop, and mixed-dtype einsums keep
        f32 accumulation."""
        Lc, Wlc = L.astype(ct), Wl.astype(ct)
        Wrc, Rc = Wr.astype(ct), R.astype(ct)

        if gemm2_apply:
            # Precontract the environments with their MPO cores ONCE per
            # local solve (O(chi^2 d^2 w^2), amortized over m iterations)
            # so each Lanczos iteration is exactly two large GEMMs:
            #   T1[(x p m),(j b)] = LW[(x p m),(a i)] . th[(a i),(j b)]
            #   y [(x p),(q B)]   = T1[(x p),(m j b)] . RW[(m j b),(q B)]
            # with shapes (chi d w, chi d) x (chi d, d chi) and
            # (chi d, w d chi) x (w d chi, d chi): M, N, K are all
            # >= chi d — no (w d)-sized contraction.
            LW = jnp.einsum("alx,lpim->aixpm", Lc, Wlc)
            RW = jnp.einsum("mqjr,brB->mjbqB", Wrc, Rc)

            def apply_h(th):
                t1 = jnp.einsum("aixpm,aijb->xpmjb", LW, th.astype(ct))
                y = jnp.einsum("xpmjb,mjbqB->xpqB", t1, RW)
                return y.astype(st)
        else:
            def apply_h(th):
                y = jnp.einsum(
                    "alx,lpim,mqjr,aijb,brB->xpqB",
                    Lc, Wlc, Wrc, th.astype(ct), Rc, optimize=True,
                )
                return y.astype(st)

        v0 = norm_site(theta0)
        # PYTHON-UNROLLED over the static Lanczos depth (mirrors
        # ops.tdvp_chain.lanczos_expm): the fori_loop form's dynamic
        # basis update + scalar chain sat on the critical path between
        # the apply GEMMs. Recurrence
        # scalars run at the sweep's real grade; the m x m Ritz solve
        # below consumes them at its own grade as before.
        sdt = real_st
        eps10 = jnp.asarray(10 * jnp.finfo(real_st).eps, sdt)
        basis, alphas, betas, amask = [], [], [], []
        v = v0
        v_prev = jnp.zeros_like(v0)
        beta_prev = jnp.zeros((), sdt)
        alive = jnp.ones((), sdt)
        for i in range(m):
            basis.append((v * alive.astype(st)).astype(ct))
            hv = apply_h(v)
            a = jnp.real(jnp.sum(jnp.conj(v) * hv)).astype(sdt)
            hv = hv - a.astype(st) * v - beta_prev.astype(st) * v_prev
            if reortho:
                # full reorthogonalization against the stored basis;
                # mixed-dtype einsum fuses the bf16->f32 convert into
                # the reads (halved traffic), promotion keeps f32 out
                bs = jnp.stack(basis)
                ov = jnp.einsum("macuy,acuy->m", jnp.conj(bs), hv)
                hv = hv - jnp.einsum("m,macuy->acuy", ov, bs)
            b = jnp.sqrt(jnp.sum(jnp.abs(hv) ** 2)).astype(sdt)
            v_next = hv / jnp.where(b > 0, b, 1.0).astype(st)
            alphas.append(jnp.where(alive > 0, a, jnp.zeros((), sdt)))
            amask.append(alive)
            next_alive = alive * (b > eps10 * jnp.maximum(1.0, jnp.abs(a))
                                  ).astype(sdt)
            betas.append(b * next_alive if i + 1 < m
                         else jnp.zeros((), sdt))
            v_prev, v = v, v_next
            beta_prev = b * alive
            alive = next_alive
        basis = jnp.stack(basis)
        alphas = jnp.stack(alphas).astype(jnp.float64)
        betas = jnp.stack(betas).astype(jnp.float64)
        amask = jnp.stack(amask).astype(jnp.float64)
        # well-scaled sentinel: inactive diagonal sits just above the
        # active spectrum so eigh's minimum stays in the active block
        # without wrecking its (iterative) accuracy
        big = jnp.where(amask > 0, alphas, -jnp.inf).max()
        small = jnp.where(amask > 0, alphas, jnp.inf).min()
        bmax = jnp.abs(betas).max()
        pad = big + (big - small) + 4.0 * bmax + 1.0
        diag = jnp.where(amask > 0, alphas, pad)
        if ritz == "bisect":
            e0, coef = _tridiag_ground(diag, betas)
        elif ritz == "bisect_f32":
            # the bisect unrolls ~hundreds of tiny scalar/vector ops;
            # f32 runs them cheaper where f64 is slow. Ritz-coefficient
            # error ~eps_f32
            # enters the state linearly (same grade as the f32 basis
            # itself); the reported e0 is refreshed by the final f64
            # Rayleigh quotient regardless.
            e0, coef = _tridiag_ground(diag.astype(jnp.float32),
                                       betas.astype(jnp.float32))
            e0 = e0.astype(jnp.float64)
        else:
            T = (jnp.diag(diag) + jnp.diag(betas[:-1], 1)
                 + jnp.diag(betas[:-1], -1))
            evals, evecs = jnp.linalg.eigh(T)
            e0, coef = evals[0], evecs[:, 0]
        theta = jnp.einsum("m,macuy->acuy", coef.astype(st), basis)
        return jnp.real(e0).astype(jnp.float64), norm_site(theta)

    def split_theta(theta, Q0, toward_right):
        """Split theta into (left, right) keeping a chi-dim bond basis.

        Warm-started subspace iteration + QR: the padded engine keeps
        exactly chi directions, so only the dominant *span* is needed
        (never singular values) — two steps of theta theta^T against the
        previous core converge it (the discarded spectrum is ~0 once
        ranks saturate, and DMRG self-corrects earlier).
        """
        # QR between the two half-applications keeps every intermediate
        # at dynamic range sigma (not sigma^2): forming mat (mat^H Q)
        # directly underflows f32 once most kept singular values drop
        # below sqrt(eps_f32) ~ 2e-4 — at N >= 32, chi >= 128 that is
        # the bulk of the spectrum, and the sweep silently diverged
        # (garbage energies or NaN in f32).
        mat = theta.reshape(chi * d, d * chi)
        # NOTE: Householder QR is the accurate default — a shifted-
        # CholeskyQR at the sweep's precision NaN'd under bf16-pass
        # coarse precision (the Gram's noise exceeds any safe PD shift
        # at chi=512); QR is robust at every precision the schedule
        # uses. Under ns_split (coarse sweeps only) orthogonalization
        # runs as the GEMM-only coupled Newton-Schulz inverse-sqrt:
        # division-free, so bf16-pass noise perturbs but cannot NaN it,
        # and the trace regularizer keeps rank-deficient padded thetas
        # finite (under-orthonormalized directions carry ~zero weight
        # and the fine sweeps re-factorize every core).
        if ns_split:
            eye = jnp.eye(chi, dtype=st)
            # precision-aware knobs: under bf16 matmul passes the Gram
            # noise floor is ~1e-3 so a generous shift and few iterations
            # suffice; at f32 'highest' (fine_ns_split) a tighter shift +
            # two extra iterations push orthogonality of the dominant
            # block to ~1e-6 (under-orthonormalized near-null directions
            # carry ~zero weight and the next local solve re-spans them)
            bf16_pass = ct == jnp.bfloat16
            reg = 1e-5 if bf16_pass else 1e-7
            ns_iters = 4 if bf16_pass else 6

            def orth(y):
                g = jnp.conj(y).T @ y
                tr = jnp.trace(jnp.real(g))
                g = g + (reg * tr / chi + 1e-30) * eye
                s = jnp.sqrt(jnp.sum(jnp.real(g * jnp.conj(g))))
                A = g / s
                Y, Z = A, eye
                for _ in range(ns_iters):
                    T = 0.5 * (3.0 * eye - Z @ Y)
                    Y, Z = Y @ T, T @ Z
                return y @ (Z / jnp.sqrt(s))
        elif cholqr:
            orth = _cholqr  # GEMM-only shifted CholeskyQR (fine_cholqr)
        else:
            orth = _colnorm_qr  # column-equilibrated: rank-deficient-safe

        # INNER orthogonalizations only exist to keep the subspace
        # iteration's intermediates well-conditioned in the sweep dtype
        # (dynamic range sigma, not sigma^2). Newton-Schulz returns
        # y @ M with M invertible, so it preserves the iterate's SPAN
        # exactly — approximate orthonormality is sufficient there, and
        # it replaces a ~2.5 ms Householder QR per inner step with
        # ~0.3 ms of pure GEMMs. Only the FINAL factor Q must be truly
        # orthonormal (left.right must reconstruct theta): that one stays
        # `orth` (QR unless ns_split). Net: split_iters=2 runs 3 NS + 1
        # QR instead of 4 QRs. NS's ~1e-6 orthonormality residual costs
        # ~1e-9 in the final N=8 energy, so ns_inner is opt-in for fine
        # sweeps (fine_ns_inner) and always on for coarse ones.
        eye_i = jnp.eye(chi, dtype=st)

        if ns_inner:
            def orth_inner(y):
                g = jnp.conj(y).T @ y
                tr = jnp.trace(jnp.real(g))
                g = g + (1e-6 * tr / chi + 1e-30) * eye_i
                s = jnp.sqrt(jnp.sum(jnp.real(g * jnp.conj(g))))
                A = g / s
                Y, Z = A, eye_i
                for _ in range(4):
                    T = 0.5 * (3.0 * eye_i - Z @ Y)
                    Y, Z = Y @ T, T @ Z
                return y @ (Z / jnp.sqrt(s))
        elif cholqr:
            orth_inner = _cholqr
        else:
            orth_inner = _colnorm_qr

        if toward_right:
            Q0_ = Q0
            for it in range(split_iters):
                last = it == split_iters - 1
                Z = orth_inner(jnp.conj(mat).T @ Q0_)  # (d chi, chi)
                Q = (orth if last else orth_inner)(mat @ Z)  # (chi d, chi)
                Q0_ = Q
            left = Q.reshape(chi, d, chi)
            right = (jnp.conj(Q).T @ mat).reshape(chi, d, chi)
        else:
            Q0_ = Q0
            for it in range(split_iters):
                last = it == split_iters - 1
                Z = orth_inner(mat @ Q0_)  # (chi d, chi)
                Q = (orth if last else orth_inner)(
                    jnp.conj(mat).T @ Z)  # (d chi, chi)
                Q0_ = Q
            right = jnp.conj(Q).T.reshape(chi, d, chi)
            left = (mat @ Q).reshape(chi, d, chi)
        return left, right

    def update_left_env(L, A, W):
        return jnp.einsum("alx,aib,loir,xoB->brB", L, A, W, jnp.conj(A),
                          optimize=True)

    def update_right_env(R, A, W):
        return jnp.einsum("brB,aib,loir,xoB->alx", R, A, W, jnp.conj(A),
                          optimize=True)

    L_bound = jnp.zeros((chi, w, chi), st).at[0, 0, 0].set(1.0)
    R_bound = jnp.zeros((chi, w, chi), st).at[0, 0, 0].set(1.0)

    def get(stacked, k):
        return jax.lax.dynamic_index_in_dim(stacked, k, keepdims=False)

    def put(stacked, k, val):
        return jax.lax.dynamic_update_index_in_dim(stacked, val, k, axis=0)

    def right_env_scan(mps):
        """Rs[k] = env right of the TWO-SITE block (k, k+1): cores
        k+2..N-1 (Rs[N-2] is the boundary). The previous version was
        off by one (env{k+1..}): the forward half-sweeps optimized /
        evolved against an H_eff with site k+1 double-counted — a
        dense-H_eff probe shows that operator has spurious states BELOW
        the true constrained optimum. DMRG still converged because the
        BACKWARD half-sweep (whose env carry is built incrementally and
        was always correct) re-solves every bond variationally each
        sweep; the fwd half was wasted work. Found 2026-08-18 while
        validating a fine_half_sweep knob: a forward half-sweep on a
        CONVERGED state moved the energy by 2e-3 instead of being the
        identity."""

        def body(R, k):
            Rn = update_right_env(R, get(mps, k), get(hs, k))
            return Rn, Rn

        _, Rs = jax.lax.scan(body, R_bound, jnp.arange(N - 1, 1, -1))
        Rs = jnp.flip(Rs, axis=0)
        return jnp.concatenate([Rs, R_bound[None]], axis=0)

    def one_sweep(_, state):
        mps, energy = state

        def fwd_body(carry, x):
            k, Rk = x
            mps, L, _ = carry
            A, B = get(mps, k), get(mps, k + 1)
            theta0 = jnp.einsum("asb,btc->astc", A, B)
            e, theta = lanczos_ground(theta0, L, get(hs, k),
                                      get(hs, k + 1), Rk)
            left, right = split_theta(theta, A.reshape(chi * d, chi),
                                      toward_right=True)
            mps = put(put(mps, k, left), k + 1, right)
            L_next = update_left_env(L, left, get(hs, k))
            return (mps, L_next, e), L

        def bwd_body(carry, x):
            k, Lk = x
            mps, R, _ = carry
            A, B = get(mps, k), get(mps, k + 1)
            theta0 = jnp.einsum("asb,btc->astc", A, B)
            e, theta = lanczos_ground(theta0, Lk, get(hs, k),
                                      get(hs, k + 1), R)
            left, right = split_theta(
                theta, B.reshape(chi, d * chi).T, toward_right=False)
            mps = put(put(mps, k, left), k + 1, right)
            R_next = update_right_env(R, right, get(hs, k + 1))
            return (mps, R_next, e), None

        Rs = right_env_scan(mps)
        (mps, _, energy), Ls = jax.lax.scan(
            fwd_body, (mps, L_bound, energy), (jnp.arange(N - 1), Rs),
        )
        (mps, _, energy), _ = jax.lax.scan(
            bwd_body, (mps, R_bound, energy),
            (jnp.arange(N - 2, -1, -1), jnp.flip(Ls, axis=0)),
        )
        return mps, energy

    mps, _ = jax.lax.fori_loop(
        0, n_sweeps - (1 if half_sweep else 0), one_sweep,
        (mps, jnp.float64(0.0))
    )
    if half_sweep:
        # final FORWARD half only: after coarse convergence one pass
        # re-factorizes every core at the fine grade; the mirror half
        # re-solves bonds the forward half just solved (roofline note
        # 2026-08-18: the fine sweep is 64% of the chi=512 run, its
        # mirror half buys ~0 energy at the contract grade). The state
        # ends LEFT-canonical; the Rayleigh epilogue is gauge-free.
        def fwd_only(state):
            mps, energy = state

            def fwd_body(carry, x):
                k, Rk = x
                mps, L, _ = carry
                A, B = get(mps, k), get(mps, k + 1)
                theta0 = jnp.einsum("asb,btc->astc", A, B)
                e, theta = lanczos_ground(theta0, L, get(hs, k),
                                          get(hs, k + 1), Rk)
                left, right = split_theta(
                    theta, A.reshape(chi * d, chi), toward_right=True)
                mps = put(put(mps, k, left), k + 1, right)
                L_next = update_left_env(L, left, get(hs, k))
                return (mps, L_next, e), None

            Rs = right_env_scan(mps)
            (mps, _, energy), _ = jax.lax.scan(
                fwd_body, (mps, L_bound, energy),
                (jnp.arange(N - 1), Rs))
            return mps, energy

        mps, _ = fwd_only((mps, jnp.float64(0.0)))
    # Full-precision global Rayleigh quotient: a sweep-dtype state error
    # eps costs only O(eps^2) here (variational bound). Under 'mixed' the
    # quotient itself is evaluated at f32-'highest' grade (~1e-6 relative,
    # see dmrg_run docstring).
    if energy_precision == "mixed":
        lo = (jnp.complex64
              if jnp.issubdtype(hi_dtype, jnp.complexfloating)
              else jnp.float32)
        with jax.default_matmul_precision("highest"):
            energy = _rayleigh_chain(h.astype(lo), mps.astype(lo))
    else:
        energy = _rayleigh_chain(h.astype(hi_dtype), mps.astype(hi_dtype))
    return energy.astype(jnp.float64), mps


def dmrg_run_sharded(
    h: jnp.ndarray,
    mps0: jnp.ndarray,
    mesh,
    n_sweeps: int = 4,
    lanczos_iters: int = 20,
    sweep_dtype=None,
    axis: str = "x",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """chi-partitioned flagship DMRG engine: the whole
    two-site sweep runs inside ONE `shard_map` over `mesh`, with explicit
    collectives instead of GSPMD placement guesses.

    Sharding layout (the `parallel/solvers.py:two_site_apply_sharded`
    pattern, extended to the full sweep):

    - every MPS core and environment is sharded on its FIRST bond axis
      (chi/n per device); the MPO is replicated (w is small);
    - the Lanczos H-apply contracts each device's chi/n slice of
      (L, theta) against a gathered R and combines with `psum_scatter`
      over the output's left bond — output sharded exactly like the
      input, so the m-iteration Krylov loop never reshards;
    - inner products and norms are `psum` reductions; the m x m
      tridiagonal solve replicates (identical on every device);
    - the two-site SPLIT runs replicated on a gathered theta (QR of a
      (chi d, chi) panel does not shard; it is a ~1/(m d) fraction of
      the apply work), and the factors are sliced back to shards;
    - environment updates contract the device's own (L, A) shard
      against a gathered conj(A) and `psum_scatter` onto the new bond,
      so the O(N chi^2 w) environment STORAGE stays sharded — the
      per-device memory win that lets chi grow past one chip's HBM.

    Requires ``chi % mesh.shape[axis] == 0`` (pad chi up — the engine is
    already padded-uniform). Energy parity with `dmrg_run` is exact to
    solver tolerance: same math, same iteration counts.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    N, chi, d, _ = mps0.shape
    w = h.shape[1]
    n = int(mesh.shape[axis])
    if chi % n:
        raise ValueError(
            f"chi={chi} must be a multiple of mesh axis size {n}; pad chi")
    csh = chi // n
    hi_dtype = mps0.dtype
    st = jnp.dtype(sweep_dtype) if sweep_dtype is not None else hi_dtype
    hs = h.astype(st)
    # same two-stage per-core normalization as dmrg_run (f32 underflow)
    core_scale = jnp.max(jnp.abs(mps0), axis=(1, 2, 3), keepdims=True)
    mps_o1 = mps0 / jnp.where(core_scale > 0, core_scale, 1.0)
    core_norms = jnp.sqrt(jnp.sum(jnp.abs(mps_o1) ** 2, axis=(1, 2, 3),
                                  keepdims=True))
    mps_n = (mps_o1 / jnp.where(core_norms > 0, core_norms, 1.0)).astype(st)
    real_st = jnp.finfo(st).dtype
    m = lanczos_iters

    def body(hs_r, mps_l):
        # local shapes: mps_l (N, csh, d, chi); hs_r replicated
        me = jax.lax.axis_index(axis)

        def gather(x):
            return jax.lax.all_gather(x, axis, axis=0, tiled=True)

        def scatter(x):
            return jax.lax.psum_scatter(x, axis, scatter_dimension=0,
                                        tiled=True)

        def pdot(u, v):
            return jax.lax.psum(jnp.sum(jnp.conj(u) * v), axis)

        def pnorm_site(A):
            nrm = jnp.sqrt(jnp.real(pdot(A, A)))
            return A / jnp.where(nrm > 0, nrm, 1.0)

        def apply_h(th_l, L_l, Wl, Wr, R_f):
            # partial over this device's a-shard, reduce-scattered onto
            # the output's left bond: y stays sharded like th
            y = jnp.einsum("alx,lpim,mqjr,aijb,brB->xpqB",
                           L_l, Wl, Wr, th_l, R_f, optimize=True)
            return scatter(y)

        def lanczos_ground(theta0_l, L_l, Wl, Wr, R_l):
            R_f = gather(R_l)
            v0 = pnorm_site(theta0_l)
            # mark the zeros-init basis as device-varying so the scan
            # carry types match once shards are written into it
            basis = jax.lax.pcast(jnp.zeros((m, csh, d, d, chi), st),
                                  (axis,), to="varying")
            alphas = jnp.zeros((m,), jnp.float64)
            betas = jnp.zeros((m,), jnp.float64)
            amask = jnp.zeros((m,), jnp.float64)

            def lbody(i, carry):
                basis, alphas, betas, amask, v, v_prev, b_prev, alive = carry
                basis = basis.at[i].set(v * alive.astype(st))
                hv = apply_h(v, L_l, Wl, Wr, R_f)
                a = jnp.real(pdot(v, hv))
                hv = hv - a.astype(st) * v - b_prev.astype(st) * v_prev
                # full reorthogonalization, sharded: the m-vector of
                # overlaps is a psum; the correction is local
                ov = jax.lax.psum(
                    jnp.einsum("macuy,acuy->m", jnp.conj(basis), hv), axis)
                mask = (jnp.arange(m) <= i).astype(hv.dtype)
                hv = hv - jnp.einsum("m,macuy->acuy", ov * mask, basis)
                b = jnp.sqrt(jnp.real(pdot(hv, hv)))
                v_next = hv / jnp.where(b > 0, b, 1.0).astype(st)
                alphas = alphas.at[i].set(
                    jnp.where(alive > 0, a.astype(jnp.float64), 0.0))
                amask = amask.at[i].set(alive)
                eps = jnp.asarray(10 * jnp.finfo(real_st).eps, jnp.float64)
                next_alive = alive * (
                    b.astype(jnp.float64) > eps * jnp.maximum(
                        1.0, jnp.abs(a).astype(jnp.float64)))
                betas = betas.at[i].set(
                    b.astype(jnp.float64) * (i + 1 < m) * next_alive)
                return (basis, alphas, betas, amask, v_next, v,
                        b.astype(jnp.float64) * alive, next_alive)

            carry = (basis, alphas, betas, amask, v0, jnp.zeros_like(v0),
                     jnp.float64(0.0), jnp.float64(1.0))
            basis, alphas, betas, amask, _, _, _, _ = jax.lax.fori_loop(
                0, m, lbody, carry)
            # replicated m x m solve (psum'd scalars are identical on
            # every device), same sentinel as dmrg_run
            big = jnp.where(amask > 0, alphas, -jnp.inf).max()
            small = jnp.where(amask > 0, alphas, jnp.inf).min()
            bmax = jnp.abs(betas).max()
            pad = big + (big - small) + 4.0 * bmax + 1.0
            diag = jnp.where(amask > 0, alphas, pad)
            # replicated small solve (psum'd scalars are identical on
            # every device), same Sturm-bisection path as dmrg_run
            e0, coef = _tridiag_ground(diag, betas)
            theta = jnp.einsum("m,macuy->acuy", coef.astype(st), basis)
            return (jnp.real(e0).astype(jnp.float64),
                    pnorm_site(theta))

        def split_theta(theta_l, Q0, toward_right, split_iters=2):
            # replicated split on the gathered theta, SAME warm-started
            # subspace iteration + QR as dmrg_run (dominant span, never
            # singular values): QR panels do not shard and are a
            # ~1/(m d) fraction of the apply work, so replication costs
            # single-device wall time on a small term
            theta = gather(theta_l)
            mat = theta.reshape(chi * d, d * chi)
            orth = _colnorm_qr  # column-equilibrated: rank-deficient-safe
            if toward_right:
                Q_ = Q0
                for _ in range(split_iters):
                    Z = orth(jnp.conj(mat).T @ Q_)   # (d chi, chi)
                    Q_ = orth(mat @ Z)               # (chi d, chi)
                left = Q_.reshape(chi, d, chi)
                right = (jnp.conj(Q_).T @ mat).reshape(chi, d, chi)
            else:
                Q_ = Q0
                for _ in range(split_iters):
                    Z = orth(mat @ Q_)               # (chi d, chi)
                    Q_ = orth(jnp.conj(mat).T @ Z)   # (d chi, chi)
                right = jnp.conj(Q_).T.reshape(chi, d, chi)
                left = (mat @ Q_).reshape(chi, d, chi)
            sl = me * csh
            return (jax.lax.dynamic_slice_in_dim(left, sl, csh, 0),
                    jax.lax.dynamic_slice_in_dim(right, sl, csh, 0))

        def update_left_env(L_l, A_l, W):
            # contract this device's (a-shard of L, A) against the FULL
            # conj(A); partial over a -> reduce-scatter onto new bond b
            A_f = gather(A_l)
            Lp = jnp.einsum("alx,aib,loir,xoB->brB", L_l, A_l, W,
                            jnp.conj(A_f), optimize=True)
            return scatter(Lp)

        def update_right_env(R_l, A_l, W):
            # R is sharded on its b axis: contract it against the
            # matching b-SLICE of the full A (partial over this shard),
            # conj(A) full; reduce-scatter onto the new bond a
            A_f = gather(A_l)
            A_b = jax.lax.dynamic_slice_in_dim(A_f, me * csh, csh, 2)
            Rp = jnp.einsum("brB,aib,loir,xoB->alx", R_l, A_b, W,
                            jnp.conj(A_f), optimize=True)
            return scatter(Rp)

        L_bound = jnp.zeros((csh, w, chi), st)
        L_bound = jnp.where(me == 0, L_bound.at[0, 0, 0].set(1.0), L_bound)
        R_bound = L_bound

        def get(stacked, k):
            return jax.lax.dynamic_index_in_dim(stacked, k, keepdims=False)

        def put(stacked, k, val):
            return jax.lax.dynamic_update_index_in_dim(stacked, val, k,
                                                       axis=0)

        def right_env_scan(mps):
            # Rs[k] = env of cores k+2..N-1 (right of block (k, k+1));
            # see the unsharded right_env_scan for the off-by-one note
            def rbody(R, k):
                Rn = update_right_env(R, get(mps, k), get(hs_r, k))
                return Rn, Rn

            _, Rs = jax.lax.scan(rbody, R_bound, jnp.arange(N - 1, 1, -1))
            Rs = jnp.flip(Rs, axis=0)
            return jnp.concatenate([Rs, R_bound[None]], axis=0)

        def one_sweep(_, state):
            mps, energy = state

            def fwd_body(carry, x):
                k, Rk = x
                mps, L, _ = carry
                A, B = get(mps, k), get(mps, k + 1)
                theta0 = jnp.einsum("asb,btc->astc", A, gather(B))
                e, theta = lanczos_ground(theta0, L, get(hs_r, k),
                                          get(hs_r, k + 1), Rk)
                Q0 = gather(A).reshape(chi * d, chi)
                left, right = split_theta(theta, Q0, toward_right=True)
                mps = put(put(mps, k, left), k + 1, right)
                L_next = update_left_env(L, left, get(hs_r, k))
                return (mps, L_next, e), L

            def bwd_body(carry, x):
                k, Lk = x
                mps, R, _ = carry
                A, B = get(mps, k), get(mps, k + 1)
                theta0 = jnp.einsum("asb,btc->astc", A, gather(B))
                e, theta = lanczos_ground(theta0, Lk, get(hs_r, k),
                                          get(hs_r, k + 1), R)
                Q0 = gather(B).reshape(chi, d * chi).T
                left, right = split_theta(theta, Q0, toward_right=False)
                mps = put(put(mps, k, left), k + 1, right)
                R_next = update_right_env(R, right, get(hs_r, k + 1))
                return (mps, R_next, e), None

            Rs = right_env_scan(mps)
            (mps, _, energy), Ls = jax.lax.scan(
                fwd_body, (mps, L_bound, energy), (jnp.arange(N - 1), Rs))
            (mps, _, energy), _ = jax.lax.scan(
                bwd_body, (mps, R_bound, energy),
                (jnp.arange(N - 2, -1, -1), jnp.flip(Ls, axis=0)))
            return mps, energy

        mps_out, _ = jax.lax.fori_loop(0, n_sweeps, one_sweep,
                                       (mps_l, jnp.float64(0.0)))
        return mps_out

    sharded_sweeps = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(None, axis)),
        out_specs=P(None, axis),
    )

    @jax.jit
    def run():
        mps = sharded_sweeps(hs, mps_n)
        energy = _rayleigh_chain(h.astype(hi_dtype), mps.astype(hi_dtype))
        return energy.astype(jnp.float64), mps

    return run()


def dmrg_sweep_flops(N: int, chi: int, d: int, w: int,
                     lanczos_iters: int, n_sweeps: int,
                     coarse_sweeps: int = 0,
                     coarse_lanczos_iters: Optional[int] = None,
                     coarse_reortho: bool = True,
                     coarse_ns_split: bool = False,
                     fine_reortho: bool = True,
                     gemm2_apply: bool = False,
                     fine_ns_inner: bool = False,
                     fine_half_sweep: bool = False,
                     fine_split_iters: int = 2,
                     fine_cholqr: bool = False) -> float:
    """Analytic FLOP count of ``dmrg_run``'s sweep loop (rates are
    measured on the real engine, not a synthetic kernel).

    Einsum terms use opt_einsum's contraction-path cost model on the
    exact expressions/shapes the engine executes; QR terms use the
    standard Householder count 2pq^2; Newton-Schulz orthogonalization
    counts its GEMMs (Gram + 3 matmuls x 4 iterations + apply). The
    knob parameters MUST mirror the dmrg_run call being measured
    (a schedule/model mismatch overstates throughput).
    """
    import opt_einsum as oe

    def ec(expr, shapes):
        _, info = oe.contract_path(
            expr, *[np.empty(s, np.float32) for s in shapes])
        return float(info.opt_cost)

    if gemm2_apply:
        # two big GEMMs + per-solve precontractions amortized over m
        apply_f = (2.0 * (chi * d * w) * (chi * d) * (d * chi)
                   + 2.0 * (chi * d) * (w * d * chi) * (d * chi))
        pre_f = (2.0 * (chi * d) * w * (chi * d * w)      # L.Wl
                 + 2.0 * (w * d * chi) * w * (d * chi))   # Wr.R
    else:
        apply_f = ec("alx,lpim,mqjr,aijb,brB->xpqB",
                     [(chi, w, chi), (w, d, d, w), (w, d, d, w),
                      (chi, d, d, chi), (chi, w, chi)])
        pre_f = 0.0
    env_f = ec("alx,aib,loir,xoB->brB",
               [(chi, w, chi), (chi, d, chi), (w, d, d, w), (chi, d, chi)])
    td = chi * d * d * chi  # theta element count
    theta0_f = 2.0 * chi ** 3 * d ** 2

    def lan_f(m, reortho):
        # per iteration: H apply + <v,Hv> + axpbys + optional full
        # reortho (two m-basis einsums) + norm
        ro = 4 * m * td if reortho else 0
        return pre_f + m * (apply_f + 2 * td + 4 * td + ro + 2 * td)

    # one orthogonalization of a (chi d, chi) block. Householder panels
    # count the standard 2pq^2; shifted CholeskyQR (fine_cholqr) counts
    # its 3 passes x (Gram 2pq^2 + triangular solve pq^2) of executed
    # GEMM work — the model mirrors the algorithm actually run.
    qr_orth_f = (9.0 if fine_cholqr else 2.0) * (chi * d) * chi ** 2

    def ns_orth_f(iters):
        return (2.0 * (chi * d) * chi ** 2       # Gram
                + iters * 3 * 2.0 * chi ** 3     # NS iters x 3 matmuls
                + 2.0 * (chi * d) * chi ** 2)    # y @ Z

    mm_pass_f = 2 * 2.0 * (chi * d) * (d * chi) * chi  # per split iter

    def split_f(iters, ns, ns_iters=4, ns_inner=True):
        # 2*iters orthogonalizations per split: inner ones are 4-iter
        # Newton-Schulz when ns_inner (span-exact) else QR; only the
        # final is QR (or NS under ns_split); plus the mat products of
        # each subspace iteration
        final = ns_orth_f(ns_iters) if ns else qr_orth_f
        inner_one = ns_orth_f(4) if ns_inner else qr_orth_f
        inner = (2 * iters - 1) * inner_one
        return inner + final + iters * mm_pass_f

    m_c = lanczos_iters if coarse_lanczos_iters is None \
        else coarse_lanczos_iters
    per_update = (theta0_f + lan_f(lanczos_iters, fine_reortho)
                  + split_f(fine_split_iters, False,
                            ns_inner=fine_ns_inner) + env_f)
    per_update_coarse = (theta0_f + lan_f(m_c, coarse_reortho)
                         + split_f(1, coarse_ns_split, ns_iters=4,
                                   ns_inner=True) + env_f)
    per_sweep = 2 * (N - 1) * per_update + (N - 1) * env_f
    per_sweep_coarse = 2 * (N - 1) * per_update_coarse + (N - 1) * env_f
    fine = max(0, n_sweeps - coarse_sweeps)
    total = fine * per_sweep + min(coarse_sweeps, n_sweeps) * per_sweep_coarse
    if fine_half_sweep and fine > 0:
        # the LAST fine sweep runs its forward half only: (N-1) updates
        # instead of 2(N-1); the env scan still runs once
        total -= (N - 1) * per_update
    return total


def treeoperator_to_mpo_cores(op, order) -> List[np.ndarray]:
    """Chain TreeOperator -> plain (l, o, i, r) MPO core list."""
    cores = []
    net = op.network
    for pos, v in enumerate(order):
        t = net.tensor(v)
        axes = []
        if pos > 0:
            axes.append(net.bond(order[pos - 1], v))
        axes.append(op.site_out[v])
        axes.append(op.site_in[v])
        if pos < len(order) - 1:
            axes.append(net.bond(v, order[pos + 1]))
        arr = np.asarray(t.dense(tuple(axes)))
        if pos == 0:
            arr = arr[None, ...]
        if pos == len(order) - 1:
            arr = arr[..., None]
        cores.append(arr)
    return cores


def dmrg_chain(
    h_cores: List[np.ndarray],
    chi: int,
    n_sweeps: int = 4,
    lanczos_iters: int = 20,
    key=None,
    init_cores: Optional[List[np.ndarray]] = None,
    dtype=jnp.float64,
    sweep_dtype=None,
) -> Tuple[float, jnp.ndarray]:
    """Convenience driver: pad, jit-run, return (energy, padded MPS)."""
    N = len(h_cores)
    d = h_cores[0].shape[1]
    # exact rank cap: bond k can never exceed d^min(k, N-k)
    chi = min(int(chi), int(d) ** (N // 2))
    h = pad_mpo([jnp.asarray(c, dtype) for c in h_cores])
    if init_cores is None:
        from ..tt.tensortrain import TensorTrain

        key = key if key is not None else jax.random.PRNGKey(0)
        tt = TensorTrain.random(key, [d] * N, rank=chi, dtype=dtype)
        init_cores = tt.cores
    # right-orthogonalize so the first forward pass sees exact projected
    # problems (otherwise the first sweep solves a skewed local problem)
    from ..tt.compression import right_orthogonalize
    from ..tt.tensortrain import TensorTrain as _TT

    tt0 = right_orthogonalize(_TT([jnp.asarray(c, dtype)
                                   for c in init_cores]))
    nrm = jnp.sqrt(jnp.sum(jnp.abs(tt0.cores[0]) ** 2))
    cores0 = list(tt0.cores)
    cores0[0] = cores0[0] / jnp.where(nrm > 0, nrm, 1.0)
    mps0 = pad_mps(cores0, chi)
    e, mps = dmrg_run(h, mps0, n_sweeps=n_sweeps,
                      lanczos_iters=lanczos_iters, sweep_dtype=sweep_dtype)
    return e, mps
