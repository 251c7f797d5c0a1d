"""Fully-jitted two-site TDVP engine for chains (the hot path).

The bucket-and-mask design of ops.dmrg_chain applied to time evolution
(ref tensor4all-treetn/src/tdvp/mod.rs:1101, plan.rs): every MPS core is
zero-padded to a static (chi, d, chi) shape so an ENTIRE multi-step TDVP
run is one XLA program — no host round trips inside sweeps.

Integrator: Lubich projector splitting, order 1 or 2 (palindromic
half-sweeps). Local exponentials are fixed-m Lanczos propagators:
``exp(c * H_eff) v ~= |v| * V expm(c * T) e0`` with the small tridiagonal
exponential computed by GEMM-only scaling-and-squaring
(_expm_tridiag_e0). Splits reuse the warm-started
subspace-QR of the DMRG engine (top-chi subspace == TDVP's built-in
truncation). Precision strategy as in dmrg_chain: pass
``sweep_dtype=jnp.complex64`` (or float32 for imaginary time) for speed;
the state error eps from the lower
precision costs only O(eps) in the trajectory (and observables built as
Rayleigh quotients only O(eps^2)).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from .dmrg_chain import (  # noqa: F401 (re-export)
    _cholqr,
    _colnorm_qr,
    pad_mpo,
    pad_mps,
)


def _expm_tridiag_e0(diag: jnp.ndarray, offd: jnp.ndarray, coeff,
                     max_squarings: int = 20) -> jnp.ndarray:
    """First column of ``exp(coeff * T)`` for symmetric tridiagonal T.

    ``jnp.linalg.eigh`` on the m x m Ritz matrix is an iterative
    full-spectrum kernel and the TDVP engine runs it TWICE per bond.
    The propagator only needs exp(c T) e0, so this
    uses GEMM-only scaling-and-squaring: scale A = c T / 2^s to
    ||A||_1 <= 0.5 (s data-dependent, applied as masked squarings so the
    program stays static), a 12-term Taylor-Horner evaluation (error
    <= 0.5^13/13! ~ 2e-14), then s masked squarings. Everything is m x m
    matmuls at m <= 20.

    ``coeff`` may be real (imaginary time) or complex (real time on
    complex-capable backends); the arithmetic follows its dtype. Slots
    with zero diag AND zero offd (dead Lanczos directions) decouple:
    their column of exp is e_i, so they contribute 0 to column 0.
    """
    m = diag.shape[0]
    wt = jnp.result_type(diag.dtype, jnp.asarray(coeff).dtype)
    b = offd.at[m - 1].set(0.0).astype(wt)
    T = (jnp.diag(diag.astype(wt)) + jnp.diag(b[:-1], 1)
         + jnp.diag(b[:-1], -1))
    A = jnp.asarray(coeff, wt) * T
    nrm = jnp.max(jnp.sum(jnp.abs(A), axis=0))
    # number of halvings so ||A/2^s||_1 <= 0.5
    s = jnp.ceil(jnp.maximum(jnp.log2(nrm / 0.5), 0.0))
    s = jnp.minimum(s, max_squarings).astype(jnp.int32)
    A = A * (2.0 ** (-s)).astype(wt)
    eye = jnp.eye(m, dtype=wt)
    E = eye + A / 12.0
    for k in range(11, 0, -1):
        E = eye + (A @ E) / k
    for i in range(max_squarings):
        E = jnp.where(i < s, E @ E, E)
    return E[:, 0]


@functools.partial(
    jax.jit,
    static_argnames=("nsteps", "order", "krylov_m", "sweep_dtype",
                     "orthogonalize", "precision", "reortho",
                     "gemm2_apply", "bf16_tail", "krylov_m1",
                     "expm_max_squarings", "cholqr_split"),
)
def tdvp_run(
    h: jnp.ndarray,
    mps0: jnp.ndarray,
    t: complex,
    nsteps: int = 1,
    order: int = 2,
    krylov_m: int = 12,
    sweep_dtype=None,
    orthogonalize: bool = False,
    precision: str = "highest",
    reortho: bool = True,
    gemm2_apply: bool = False,
    bf16_tail: int = 0,
    krylov_m1: int | None = None,
    expm_max_squarings: int = 20,
    cholqr_split: bool = False,
) -> jnp.ndarray:
    """Evolve ``exp(t*H)|mps0>``; returns the padded MPS.

    Args:
      h: (N, w, d, d, w) padded MPO.
      mps0: (N, chi, d, chi) padded MPS; right-orthogonal unless
        ``orthogonalize=True`` (which runs the QR gauge sweep inside the
        program — keeps the whole call one device dispatch).
      t: total evolution (e.g. ``-1j*T`` for real time).
      precision: matmul precision of the sweeps ('highest' = f32-grade
        products, the default; 'high' is TF32 on a GPU, a 10-bit
        mantissa).
      reortho: full per-iteration reorthogonalization of the Krylov
        basis (default True). False keeps the plain 3-term recurrence —
        for the SHORT-time local propagators here the Krylov space only
        needs to capture exp(c H_eff)v to step tolerance, and lost
        orthogonality perturbs the projected T by O(eps*|H|) (Paige),
        i.e. below the splitting error for production dt.
      gemm2_apply: contract the local H as two large GEMMs per Krylov
        iteration against per-bond precontracted L*Wl / Wr*R operands
        (2x FLOPs, no small-K GEMMs, as in ops.dmrg_chain.dmrg_run).
      bf16_tail: if > 0 (f32 sweeps only), Krylov iterations with index
        ``i >= bf16_tail`` run their H-apply as bf16 GEMMs
        against per-bond bf16-precast operands. Principled mixed
        precision: the propagator coefficient of basis vector k decays
        factorially, ``|coef_k| ~ (|dt| |H_eff|)^k / k!`` — for
        production steps that is <~1e-4 by k=3 — so bf16-grade (~8e-3)
        error in the TAIL vectors enters the evolved state at
        ``coef_k * eps_bf16`` ~ f32 grade, while the tail's GEMMs (the
        bulk of the propagator cost at m >= 12) run 3x faster than
        'high'-precision f32 passes. bf16_tail is the number of
        full-precision LEADING iterations (3 is production grade;
        0 disables).
      krylov_m1: Krylov dimension of the BACKWARD one-site gauge
        propagators (default: krylov_m). The one-site H_eff has the
        same spectral scale as the two-site one but its applies have
        half the arithmetic intensity; a shorter tail there (e.g. 8 vs
        12) trims the low-intensity third of the sweep FLOPs at the
        same factorial-decay accuracy argument.
      expm_max_squarings: static bound on the scaling-squaring halvings
        of the small tridiagonal expm. Production local propagators
        have ``|dt| |H_eff| <~ 1`` so 8 suffices (each unused squaring
        still costs a masked m x m matmul in-program; 20 is the
        conservative default).
      cholqr_split: orthonormalize the two-site splits and the initial
        gauge sweep by shifted CholeskyQR (GEMM-only, `_cholqr`)
        instead of Householder QR panels: a few GEMMs in place of a
        chain of small panel updates, at f32-grade orthonormality.
        Validated for full-rank states
        (random inits); states with strongly rank-deficient thetas
        keep the Householder default (junk completion directions are
        only orthonormal to ~1e-2 under CholeskyQR — zero-amplitude,
        but outside the strict gauge contract).
    """
    if order not in (1, 2):
        raise ValueError("order must be 1 or 2")
    with jax.default_matmul_precision(precision):
        return _tdvp_sweeps(h, mps0, t, nsteps, order, krylov_m,
                            sweep_dtype, orthogonalize, reortho,
                            gemm2_apply, bf16_tail, krylov_m1,
                            expm_max_squarings, cholqr_split)


def _tdvp_sweeps(h, mps0, t, nsteps, order, krylov_m, sweep_dtype,
                 orthogonalize=False, reortho=True, gemm2_apply=False,
                 bf16_tail=0, krylov_m1=None, expm_max_squarings=20,
                 cholqr_split=False):
    orth = _cholqr if cholqr_split else _colnorm_qr
    N, chi, d, _ = mps0.shape
    w = h.shape[1]
    # real sweep dtypes are allowed for IMAGINARY-time evolution (real t);
    # real-time evolution needs a complex dtype.
    st = jnp.dtype(sweep_dtype) if sweep_dtype is not None else \
        jnp.result_type(mps0.dtype, jnp.complex64)
    hs = h.astype(st)
    mps = mps0.astype(st)
    real_st = jnp.finfo(st).dtype
    m = krylov_m
    m1 = krylov_m if krylov_m1 is None else krylov_m1
    # bf16 tail only makes sense for f32 sweeps (bf16 of f64 operands
    # would be a precision cliff; complex has no bf16 kernels)
    tail = bf16_tail if (bf16_tail and st == jnp.float32) else 0

    def norm_of(A):
        return jnp.sqrt(jnp.sum(jnp.abs(A) ** 2).astype(jnp.float64))

    def lanczos_expm(apply_pair, v0, coeff, shape, m):
        """exp(coeff*H) v0 by fixed-m Lanczos (ref krylov.rs:640).

        PYTHON-UNROLLED over the static Krylov depth: in a fori_loop +
        lax.cond form the per-iteration dynamic basis update, the cond's
        scheduling barrier, and the scalar chains all sit on the
        critical path between GEMMs. Unrolling removes the loop and
        cond entirely, lets XLA fuse the axpy/normalize chain into the
        apply epilogues, and runs the recurrence scalars at the sweep's
        real grade (f32 for f32 sweeps — the same grade the expm solve
        and the basis already use; f64 sweeps keep f64 scalars).
        """
        apply_h, apply_lo = apply_pair
        sdt = real_st  # scalar grade matches the sweep
        tiny = jnp.asarray(jnp.finfo(sdt).tiny, sdt)
        eps10 = jnp.asarray(10 * jnp.finfo(real_st).eps, sdt)
        n0 = jnp.sqrt(jnp.sum(jnp.abs(v0) ** 2)).astype(sdt)
        v = v0 / jnp.maximum(n0, tiny).astype(st)
        basis, alphas, betas, amask = [], [], [], []
        v_prev = jnp.zeros_like(v)
        beta_prev = jnp.zeros((), sdt)
        alive = jnp.ones((), sdt)
        for i in range(m):
            basis.append(v * alive.astype(st))
            # factorial coefficient decay makes tail iterations
            # bf16-tolerant (see tdvp_run docstring); the branch is
            # STATIC per unrolled iteration — no lax.cond
            f = apply_h if (apply_lo is None or i < tail) else apply_lo
            hv = f(v)
            a = jnp.real(jnp.sum(jnp.conj(v) * hv)).astype(sdt)
            hv = hv - a.astype(st) * v - beta_prev.astype(st) * v_prev
            if reortho:
                bs = jnp.stack(basis)
                ov = jnp.einsum("m...,...->m", jnp.conj(bs), hv)
                hv = hv - jnp.einsum("m,m...->...", ov, bs)
            b = jnp.sqrt(jnp.sum(jnp.abs(hv) ** 2)).astype(sdt)
            v_next = hv / jnp.maximum(b, tiny).astype(st)
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
        alphas = jnp.stack(alphas)
        betas = jnp.stack(betas)
        amask = jnp.stack(amask)
        # exp(coeff*T) e0 by GEMM-only scaling-and-squaring (dead slots
        # carry zero diag/offd and decouple; masked below for safety).
        # The small solve runs at the SWEEP grade (f32 when sweeping
        # f32): coefficient error ~eps(real_st) enters the state
        # linearly — the same grade as the Krylov basis itself. f64
        # sweeps keep the f64 solve.
        if jnp.issubdtype(st, jnp.complexfloating):
            c = jnp.asarray(coeff, jnp.result_type(real_st, jnp.complex64))
        else:
            c = jnp.real(jnp.asarray(coeff, real_st))
        coef = _expm_tridiag_e0(alphas.astype(real_st),
                                betas.astype(real_st), c,
                                max_squarings=expm_max_squarings)
        coef = coef * amask
        out = jnp.einsum("m,m...->...", coef.astype(st), basis)
        return out * n0.astype(st)

    if gemm2_apply:
        # Precontract the environments with their MPO cores ONCE per
        # local propagator (amortized over the m Krylov iterations) so
        # each iteration is two large GEMMs with every M/N/K >= chi*d —
        # no (w d)-sized contraction. Same trade as
        # ops.dmrg_chain.dmrg_run(gemm2_apply=True): 2x the minimal-path
        # FLOPs.
        _P1 = jax.lax.Precision.DEFAULT  # fastest pass for bf16 operands

        def apply_h2(L, Wl, Wr, R):
            LW = jnp.einsum("alx,lpim->aixpm", L, Wl)
            RW = jnp.einsum("mqjr,brB->mjbqB", Wr, R)

            def f(th):
                t1 = jnp.einsum("aixpm,aijb->xpmjb", LW, th)
                return jnp.einsum("xpmjb,mjbqB->xpqB", t1, RW)

            if not tail:
                return f, None
            LWc, RWc = LW.astype(jnp.bfloat16), RW.astype(jnp.bfloat16)

            def f_lo(th):
                thc = th.astype(jnp.bfloat16)
                t1 = jnp.einsum("aixpm,aijb->xpmjb", LWc, thc,
                                precision=_P1)
                return jnp.einsum("xpmjb,mjbqB->xpqB", t1, RWc,
                                  precision=_P1).astype(st)
            return f, f_lo

        def apply_h1(L, W, R):
            LW = jnp.einsum("alx,lpir->aixpr", L, W)

            def f(A):
                t1 = jnp.einsum("aixpr,aib->xprb", LW, A)
                return jnp.einsum("xprb,brB->xpB", t1, R)

            if not tail:
                return f, None
            LWc, Rc = LW.astype(jnp.bfloat16), R.astype(jnp.bfloat16)

            def f_lo(A):
                Ac = A.astype(jnp.bfloat16)
                t1 = jnp.einsum("aixpr,aib->xprb", LWc, Ac,
                                precision=_P1)
                return jnp.einsum("xprb,brB->xpB", t1, Rc,
                                  precision=_P1).astype(st)
            return f, f_lo
    else:
        def apply_h2(L, Wl, Wr, R):
            def f(th):
                return jnp.einsum("alx,lpim,mqjr,aijb,brB->xpqB",
                                  L, Wl, Wr, th, R, optimize=True)

            if not tail:
                return f, None

            def f_lo(th, _ops=(L, Wl, Wr, R)):
                Lc, Wlc, Wrc, Rc = (o.astype(jnp.bfloat16) for o in _ops)
                return jnp.einsum(
                    "alx,lpim,mqjr,aijb,brB->xpqB", Lc, Wlc, Wrc,
                    th.astype(jnp.bfloat16), Rc, optimize=True,
                    precision=jax.lax.Precision.DEFAULT).astype(st)
            return f, f_lo

        def apply_h1(L, W, R):
            def f(A):
                return jnp.einsum("alx,lpir,aib,brB->xpB",
                                  L, W, A, R, optimize=True)

            if not tail:
                return f, None

            def f_lo(A, _ops=[L, W, R]):
                Lc, Wc, Rc = (o.astype(jnp.bfloat16) for o in _ops)
                return jnp.einsum(
                    "alx,lpir,aib,brB->xpB", Lc, Wc,
                    A.astype(jnp.bfloat16), Rc, optimize=True,
                    precision=jax.lax.Precision.DEFAULT).astype(st)
            return f, f_lo

    def split_theta(theta, Q0, toward_right):
        mat = theta.reshape(chi * d, d * chi)
        if toward_right:
            Q = orth(mat @ (jnp.conj(mat).T @ Q0))
            Q = orth(mat @ (jnp.conj(mat).T @ Q))
            left = Q.reshape(chi, d, chi)
            right = (jnp.conj(Q).T @ mat).reshape(chi, d, chi)
        else:
            Q = orth(jnp.conj(mat).T @ (mat @ Q0))
            Q = orth(jnp.conj(mat).T @ (mat @ Q))
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
        # Rs[k] = env of cores k+2..N-1 (right of block (k, k+1));
        # see ops.dmrg_chain.right_env_scan for the off-by-one history
        def body(R, k):
            Rn = update_right_env(R, get(mps, k), get(hs, k))
            return Rn, Rn

        _, Rs = jax.lax.scan(body, R_bound, jnp.arange(N - 1, 1, -1))
        Rs = jnp.flip(Rs, axis=0)
        return jnp.concatenate([Rs, R_bound[None]], axis=0)

    def right_orthogonalize_padded(mps, renorm=False):
        """In-program right-orthogonalization: QR gauge sweep N-1..1.

        ``renorm=True`` (the INITIAL gauge, where the final core-0
        normalization makes the state scale irrelevant) rescales the
        carried core to unit norm at every step: the R-factor product
        of a per-core-normalized random chain decays like c^N (c<1), so
        by site 0 the entries reach ~1e-18 at N=32 — whose f32
        sum-of-squares lands in the DENORMAL range that accelerators may
        flush to zero, turning the norm guard into a division by ~0 and
        NaN'ing the whole evolution (CPUs keep denormals and hide it).
        Max-abs first (flush-safe), then the 2-norm of the
        O(1)-rescaled core."""

        def ortho_body(carry, k):
            mps = carry
            A = get(mps, k)
            M = A.reshape(chi, d * chi)
            if cholqr_split:
                # GEMM-only gauge: M^H = Q1 R1 => R1^H = M Q1, so the
                # absorbed factor never needs the triangular R at all
                Q1 = _cholqr(jnp.conj(M).T)  # (d chi, chi)
                R1H = M @ Q1
            else:
                Q1, R1 = jnp.linalg.qr(jnp.conj(M).T)  # (d chi, chi)
                R1H = jnp.conj(R1).T
            core = jnp.conj(Q1).T.reshape(chi, d, chi)
            prev = get(mps, k - 1)
            # absorb R1^H into the previous core's right bond
            # (M = R1^H Q1^H)
            prev = jnp.einsum("adb,bc->adc", prev, R1H)
            if renorm:
                mx = jnp.max(jnp.abs(prev))
                prev = prev / jnp.where(mx > 0, mx, 1.0)
                pn = jnp.sqrt(jnp.sum(jnp.abs(prev) ** 2))
                prev = prev / jnp.where(pn > 0, pn, 1.0).astype(st)
            mps = put(put(mps, k, core), k - 1, prev)
            return mps, None

        mps, _ = jax.lax.scan(ortho_body, mps, jnp.arange(N - 1, 0, -1))
        return mps

    if orthogonalize:
        # Two-stage PER-CORE normalization before the gauge sweep (same
        # guard as _dmrg_sweeps): the QR sweep concentrates the full
        # state norm into core 0, and raw random cores have norm
        # ~sqrt(chi^2 d) each — the product overflows f32 beyond N~20,
        # NaN'ing the entire evolution. Scaling cores only rescales the
        # state (TT multilinearity) and this path normalizes at core 0
        # anyway, so the contract is unchanged. Max-abs first (cannot
        # overflow), then the 2-norm of the O(1)-rescaled core.
        core_scale = jnp.max(jnp.abs(mps), axis=(1, 2, 3), keepdims=True)
        mps = mps / jnp.where(core_scale > 0, core_scale, 1.0)
        core_norms = jnp.sqrt(jnp.sum(jnp.abs(mps) ** 2, axis=(1, 2, 3),
                                      keepdims=True))
        mps = mps / jnp.where(core_norms > 0, core_norms, 1.0)
        # initial gauge + normalization (evolution then preserves norm);
        # renorm=True keeps every carried core O(1) through the sweep
        mps = right_orthogonalize_padded(mps, renorm=True)
        n0 = jnp.sqrt(jnp.sum(jnp.abs(get(mps, 0)) ** 2))
        mps = put(mps, 0, get(mps, 0)
                  / jnp.maximum(n0, 1e-300).astype(st))

    coeff_dtype = (jnp.complex128
                   if jnp.issubdtype(st, jnp.complexfloating)
                   else jnp.float64)
    dt = jnp.asarray(t, coeff_dtype) / nsteps
    delta = dt / 2.0 if order == 2 else dt

    def half_sweep_fwd(mps, delta):
        Rs = right_env_scan(mps)

        def body(carry, x):
            k, Rk = x
            mps, L = carry
            A, B = get(mps, k), get(mps, k + 1)
            theta0 = jnp.einsum("asb,btc->astc", A, B)
            theta = lanczos_expm(
                apply_h2(L, get(hs, k), get(hs, k + 1), Rk), theta0,
                delta, (chi, d, d, chi), m)
            left, right = split_theta(theta, A.reshape(chi * d, chi),
                                      toward_right=True)
            L_next = update_left_env(L, left, get(hs, k))
            # backward one-site step on the new center (skip at last bond)
            c = jnp.where(k < N - 2, -delta, 0.0 * delta)
            right = lanczos_expm(
                apply_h1(L_next, get(hs, k + 1), Rk), right, c,
                (chi, d, chi), m1)
            mps = put(put(mps, k, left), k + 1, right)
            return (mps, L_next), L

        (mps, _), Ls = jax.lax.scan(body, (mps, L_bound),
                                    (jnp.arange(N - 1), Rs))
        return mps, Ls

    def half_sweep_bwd(mps, delta, Ls):
        def body(carry, x):
            k, Lk = x
            mps, R = carry
            A, B = get(mps, k), get(mps, k + 1)
            theta0 = jnp.einsum("asb,btc->astc", A, B)
            theta = lanczos_expm(
                apply_h2(Lk, get(hs, k), get(hs, k + 1), R), theta0,
                delta, (chi, d, d, chi), m)
            left, right = split_theta(
                theta, B.reshape(chi, d * chi).T, toward_right=False)
            R_next = update_right_env(R, right, get(hs, k + 1))
            c = jnp.where(k > 0, -delta, 0.0 * delta)
            left = lanczos_expm(
                apply_h1(Lk, get(hs, k), R_next), left, c,
                (chi, d, chi), m1)
            mps = put(put(mps, k, left), k + 1, right)
            return (mps, R_next), None

        (mps, _), _ = jax.lax.scan(
            body, (mps, R_bound),
            (jnp.arange(N - 2, -1, -1), jnp.flip(Ls, axis=0)))
        return mps

    def one_step(_, mps):
        mps, Ls = half_sweep_fwd(mps, delta)
        if order == 2:
            mps = half_sweep_bwd(mps, delta, Ls)
        else:
            # forward-only Lie splitting leaves the chain left-canonical;
            # the next step's right environments require right-canonical
            # form — re-gauge (exact, preserves the state)
            mps = right_orthogonalize_padded(mps)
        return mps

    mps = jax.lax.fori_loop(0, nsteps, one_step, mps)
    return mps


def bond_gemm_flops(chi: int, d: int, w: int):
    """Per-bond FLOPs of the two-GEMM (``gemm2_apply``) local applies:
    ``(apply2, apply1, pre2, pre1)``. apply2/apply1 are the per-Krylov-
    iteration two-site/one-site H·theta streams; pre2/pre1 the per-bond
    MPO precontractions. Single source of truth for
    ``tdvp_sweep_flops`` (duplicated formulas could silently
    desynchronize from the engine)."""
    apply2 = (2.0 * (chi * d * w) * (chi * d) * (d * chi)
              + 2.0 * (chi * d) * (w * d * chi) * (d * chi))
    apply1 = (2.0 * (chi * d * w) * chi * (d * chi)
              + 2.0 * (chi * d) * (chi * w) * chi)
    pre2 = (2.0 * (chi * d) * w * (chi * d * w)
            + 2.0 * (w * d * chi) * w * (d * chi))
    pre1 = 2.0 * (chi * d * w) * w * (d * chi)
    return apply2, apply1, pre2, pre1


def tdvp_sweep_flops(N: int, chi: int, d: int, w: int, krylov_m: int,
                     nsteps: int, order: int = 2,
                     complex_dtype: bool = False,
                     reortho: bool = True,
                     gemm2_apply: bool = False,
                     krylov_m1: int | None = None,
                     karatsuba: bool = False) -> float:
    """Analytic FLOP count of ``tdvp_run``'s sweep loop (same cost model
    as ops.dmrg_chain.dmrg_sweep_flops). The knob parameters MUST
    mirror the tdvp_run call being measured.

    complex_dtype (the real/imag-split engine): complex-complex GEMM
    streams count 4x the real multiplies (3x under ``karatsuba`` —
    ops.tdvp_chain_split._cmul_ein3), pair vector ops and the real-MPO
    precontractions count 2x, split/QR panel terms 4x (the pair
    orthogonalizers run two embedded real panels or an interleaved
    2q-wide Cholesky)."""
    import numpy as np
    import opt_einsum as oe

    def ec(expr, shapes):
        _, info = oe.contract_path(
            expr, *[np.empty(s, np.float32) for s in shapes])
        return float(info.opt_cost)

    m = krylov_m
    if gemm2_apply:
        apply2_f, apply1_f, pre2_f, pre1_f = bond_gemm_flops(chi, d, w)
    else:
        apply2_f = ec("alx,lpim,mqjr,aijb,brB->xpqB",
                      [(chi, w, chi), (w, d, d, w), (w, d, d, w),
                       (chi, d, d, chi), (chi, w, chi)])
        apply1_f = ec("alx,lpir,aib,brB->xpB",
                      [(chi, w, chi), (w, d, d, w), (chi, d, chi),
                       (chi, w, chi)])
        pre2_f = pre1_f = 0.0
    env_f = ec("alx,aib,loir,xoB->brB",
               [(chi, w, chi), (chi, d, chi), (w, d, d, w), (chi, d, chi)])
    td2 = chi * d * d * chi
    td1 = chi * d * chi

    m1 = krylov_m if krylov_m1 is None else krylov_m1

    def lan(apply_f, td, pre_f, mm):
        ro = 4 * mm * td if reortho else 0
        return pre_f + mm * (apply_f + 2 * td + 4 * td + ro + 2 * td)

    theta0_f = 2.0 * chi ** 3 * d ** 2
    qr_f = 4 * 2.0 * (chi * d) * chi ** 2
    mm_f = 4 * 2.0 * (chi * d) * (d * chi) * chi
    per_bond = (theta0_f + lan(apply2_f, td2, pre2_f, m)
                + lan(apply1_f, td1, pre1_f, m1)
                + qr_f + mm_f + env_f)
    half_sweep = (N - 1) * per_bond + (N - 1) * env_f  # + env scan
    per_step = (2 if order == 2 else 1) * half_sweep
    total = nsteps * per_step
    if complex_dtype:
        nb = nsteps * (2 if order == 2 else 1) * (N - 1)
        # pair-arithmetic precontractions multiply a complex pair by the
        # REAL MPO core (2 real einsums, not 4) — don't inflate them
        pre_total = nb * (pre2_f + pre1_f)
        # pair vector ops (axpy/normalize/coef accumulation) are 2x
        vec_total = nb * ((m * (2 + 4 + 2) + (4 * m * m if reortho
                                              else 0)) * td2
                          + (m1 * (2 + 4 + 2) + (4 * m1 * m1 if reortho
                                                 else 0)) * td1)
        cmul_total = (total - pre_total - vec_total)
        cmul_x = 3.0 if karatsuba else 4.0
        return cmul_total * cmul_x + pre_total * 2.0 + vec_total * 2.0
    return total


def tdvp_chain(h_cores, init_cores, t, chi, nsteps=1, order=2,
               krylov_m=12, sweep_dtype=None, engine="auto", **knobs):
    """Convenience driver: pad on host, run ONE device program (the
    orthogonalization sweep is fused into it).

    ``engine``: 'auto' routes CPU backends to the host two-site engine
    (ops.tdvp_chain_host) — measured crossover (1-thread CPU): the
    jitted engine's fixed worst-case-shape work loses at EVERY size
    tested (N=8 chi=32: 576 vs 72 ms; N=16 chi=64: 7.1 s vs 0.89 s;
    N=16 chi=128: 68 s vs 3.3 s) and the gap widens with chi, so on CPU
    there is no crossover — the jitted engine is a device design.
    'jit'/'host' force an engine."""
    import numpy as np

    if engine == "auto":
        try:
            engine = "host" if jax.default_backend() == "cpu" else "jit"
        except Exception:  # noqa: BLE001
            engine = "jit"
    if engine == "host":
        from .tdvp_chain_host import tdvp_chain_host

        out = tdvp_chain_host(
            [np.asarray(c) for c in h_cores],
            # np.array (copy): the host engine normalizes cores
            # in place and np.asarray of a jax.Array is read-only
            [np.array(c) for c in init_cores], t, chi,
            nsteps=nsteps, order=order)
        # match the jitted engine's contract: unit-norm padded stack
        # (transfer-matrix norm, O(N chi^3 d))
        stk = [np.asarray(c) for c in out]
        T = np.ones((1, 1), stk[0].dtype)
        for c in stk:
            T = np.einsum("ab,adr,bds->rs", T, c, np.conj(c),
                          optimize=True)
        nrm = float(np.sqrt(np.abs(T[0, 0])))
        if nrm > 0:
            stk[0] = stk[0] / nrm
        return pad_mps([jnp.asarray(c) for c in stk], chi)

    # NOTE on chi: unlike dmrg_chain (variational, exact at the
    # Hilbert rank cap), the two-site splits here measurably benefit
    # from padding slack — at chi == exact bond rank the trajectory
    # error is ~1e-6 while chi >= 2x the target rank reaches 1e-14
    # (empirical, N=6 Heisenberg), so no automatic clamp is applied.
    dtype = jnp.complex128 if sweep_dtype is None else sweep_dtype
    h = pad_mpo([jnp.asarray(np.asarray(c), dtype) for c in h_cores])
    # Per-core normalization guards low-precision sweeps against the
    # concentrated-norm underflow (see dmrg_chain._dmrg_sweeps): the
    # engine's local steps unit-normalize the state, so its output is
    # UNIT-NORM by convention regardless of input scale, and the
    # rescaling here is invisible in the result.
    normed = []
    for c in init_cores:
        a = np.asarray(c)
        # two-stage: max-abs first (cannot underflow even for f32 cores
        # whose sum-of-squares would flush to zero), then unit 2-norm of
        # the O(1)-rescaled core
        m = float(np.abs(a).max()) if a.size else 0.0
        if m > 0:
            a = a / m
            # widen in the SAME domain: complex cores must keep their
            # imaginary part (astype(float64) would drop it -> a purely
            # imaginary core would divide by ~0 and NaN the evolution)
            wide = np.complex128 if np.iscomplexobj(a) else np.float64
            a = a / float(np.linalg.norm(a.astype(wide)))
        normed.append(a)
    mps0 = pad_mps([jnp.asarray(c, dtype) for c in normed], chi)
    return tdvp_run(h, mps0, t, nsteps=nsteps, order=order,
                    krylov_m=krylov_m, sweep_dtype=sweep_dtype,
                    orthogonalize=True, **knobs)


def tdvp_run_sharded(
    h: jnp.ndarray,
    mps0: jnp.ndarray,
    t: complex,
    mesh,
    nsteps: int = 1,
    order: int = 2,
    krylov_m: int = 12,
    sweep_dtype=None,
    axis: str = "x",
) -> jnp.ndarray:
    """chi-partitioned flagship TDVP engine: the whole projector-splitting
    sweep runs inside ONE `shard_map` over `mesh` with explicit
    collectives — the time-evolution counterpart of
    ops.dmrg_chain.dmrg_run_sharded (ref
    tensor4all-treetn/src/tdvp/mod.rs:1101 is the single-process
    analog).

    Sharding layout (identical to dmrg_run_sharded):

    - every MPS core and environment is sharded on its FIRST bond axis
      (chi/n per device); the MPO is replicated (w is small);
    - each Krylov H-apply (two-site AND the backward one-site gauge
      propagator) contracts the device's chi/n slice of (L, v) against a
      gathered R and `psum_scatter`s onto the output's left bond, so the
      m-iteration Lanczos loop never reshards;
    - inner products / norms are `psum` reductions; the m x m
      tridiagonal exp(cT)e0 solve replicates (identical on every
      device, GEMM-only scaling-and-squaring);
    - two-site splits run replicated on the gathered theta (warm-started
      subspace iteration + QR, a ~1/(m d) fraction of the apply work)
      and slice the factors back to shards;
    - the initial right-orthogonalization gauge sweep runs replicated
      per-core QRs on gathered cores (one (d chi, chi) panel per site,
      paid once per run).

    Requires ``chi % mesh.shape[axis] == 0``. The state is per-core
    normalized and gauge-swept inside the program (same contract as
    ``tdvp_run(orthogonalize=True)``); trajectory parity with the
    single-device engine is exact to solver tolerance.
    """
    from jax.sharding import PartitionSpec as P

    N, chi, d, _ = mps0.shape
    w = h.shape[1]
    n = int(mesh.shape[axis])
    if chi % n:
        raise ValueError(
            f"chi={chi} must be a multiple of mesh axis size {n}; pad chi")
    csh = chi // n
    st = jnp.dtype(sweep_dtype) if sweep_dtype is not None else \
        jnp.result_type(mps0.dtype, jnp.complex64)
    hs = h.astype(st)
    real_st = jnp.finfo(st).dtype
    m = krylov_m
    # same two-stage per-core normalization as the unsharded engine
    # (orthogonalize=True contract; prevents the f32 gauge-sweep
    # overflow seen at N=32)
    core_scale = jnp.max(jnp.abs(mps0), axis=(1, 2, 3), keepdims=True)
    mps_o1 = mps0 / jnp.where(core_scale > 0, core_scale, 1.0)
    core_norms = jnp.sqrt(jnp.sum(jnp.abs(mps_o1) ** 2, axis=(1, 2, 3),
                                  keepdims=True))
    mps_n = (mps_o1 / jnp.where(core_norms > 0, core_norms, 1.0)).astype(st)

    coeff_dtype = (jnp.complex128
                   if jnp.issubdtype(st, jnp.complexfloating)
                   else jnp.float64)
    dt = jnp.asarray(t, coeff_dtype) / nsteps
    delta = dt / 2.0 if order == 2 else dt

    def body(hs_r, mps_l):
        me = jax.lax.axis_index(axis)

        def gather(x):
            return jax.lax.all_gather(x, axis, axis=0, tiled=True)

        def scatter(x):
            return jax.lax.psum_scatter(x, axis, scatter_dimension=0,
                                        tiled=True)

        def pdot(u, v):
            return jax.lax.psum(jnp.sum(jnp.conj(u) * v), axis)

        def pnorm(u):
            return jnp.sqrt(jnp.real(pdot(u, u)).astype(jnp.float64))

        def apply_h2(th_l, L_l, Wl, Wr, R_f):
            y = jnp.einsum("alx,lpim,mqjr,aijb,brB->xpqB",
                           L_l, Wl, Wr, th_l, R_f, optimize=True)
            return scatter(y)

        def apply_h1(A_l, L_l, W, R_f):
            y = jnp.einsum("alx,lpir,aib,brB->xpB",
                           L_l, W, A_l, R_f, optimize=True)
            return scatter(y)

        def lanczos_expm(apply_h, v0_l, coeff, lshape):
            n0 = pnorm(v0_l)
            v = v0_l / jnp.maximum(n0, 1e-300).astype(st)
            basis = jax.lax.pcast(jnp.zeros((m,) + lshape, st),
                                  (axis,), to="varying")
            alphas = jnp.zeros((m,), jnp.float64)
            betas = jnp.zeros((m,), jnp.float64)
            amask = jnp.zeros((m,), jnp.float64)

            def lbody(i, carry):
                basis, alphas, betas, amask, v, v_prev, b_prev, alive = \
                    carry
                basis = basis.at[i].set(v * alive.astype(st))
                hv = apply_h(v)
                a = jnp.real(pdot(v, hv))
                hv = hv - a.astype(st) * v - b_prev.astype(st) * v_prev
                # full reorthogonalization: the m-vector of overlaps is
                # a psum, the correction is local to the shard
                ov = jax.lax.psum(
                    jnp.einsum("m...,...->m", jnp.conj(basis), hv), axis)
                mask = (jnp.arange(m) <= i).astype(st)
                hv = hv - jnp.einsum("m,m...->...", ov * mask, basis)
                b = pnorm(hv)
                v_next = hv / jnp.maximum(b, 1e-300).astype(st)
                alphas = alphas.at[i].set(
                    jnp.where(alive > 0, a.astype(jnp.float64), 0.0))
                amask = amask.at[i].set(alive)
                eps = jnp.asarray(10 * jnp.finfo(real_st).eps,
                                  jnp.float64)
                next_alive = alive * (b > eps * jnp.maximum(
                    1.0, jnp.abs(a).astype(jnp.float64)))
                betas = betas.at[i].set(b * (i + 1 < m) * next_alive)
                return (basis, alphas, betas, amask, v_next, v,
                        b * alive, next_alive)

            carry = (basis, alphas, betas, amask, v, jnp.zeros_like(v),
                     jnp.float64(0.0), jnp.float64(1.0))
            basis, alphas, betas, amask, _, _, _, _ = jax.lax.fori_loop(
                0, m, lbody, carry)
            if jnp.issubdtype(st, jnp.complexfloating):
                c = jnp.asarray(coeff,
                                jnp.result_type(real_st, jnp.complex64))
            else:
                c = jnp.real(jnp.asarray(coeff, real_st))
            coef = _expm_tridiag_e0(alphas.astype(real_st),
                                    betas.astype(real_st), c)
            coef = coef * amask
            out = jnp.einsum("m,m...->...", coef.astype(st), basis)
            return out * n0.astype(st)

        def split_theta(theta_l, Q0, toward_right):
            theta = gather(theta_l)
            mat = theta.reshape(chi * d, d * chi)
            if toward_right:
                Q = _colnorm_qr(mat @ (jnp.conj(mat).T @ Q0))
                Q = _colnorm_qr(mat @ (jnp.conj(mat).T @ Q))
                left = Q.reshape(chi, d, chi)
                right = (jnp.conj(Q).T @ mat).reshape(chi, d, chi)
            else:
                Q = _colnorm_qr(jnp.conj(mat).T @ (mat @ Q0))
                Q = _colnorm_qr(jnp.conj(mat).T @ (mat @ Q))
                right = jnp.conj(Q).T.reshape(chi, d, chi)
                left = (mat @ Q).reshape(chi, d, chi)
            sl = me * csh
            return (jax.lax.dynamic_slice_in_dim(left, sl, csh, 0),
                    jax.lax.dynamic_slice_in_dim(right, sl, csh, 0))

        def update_left_env(L_l, A_l, W):
            A_f = gather(A_l)
            Lp = jnp.einsum("alx,aib,loir,xoB->brB", L_l, A_l, W,
                            jnp.conj(A_f), optimize=True)
            return scatter(Lp)

        def update_right_env(R_l, A_l, W):
            A_f = gather(A_l)
            A_b = jax.lax.dynamic_slice_in_dim(A_f, me * csh, csh, 2)
            Rp = jnp.einsum("brB,aib,loir,xoB->alx", R_l, A_b, W,
                            jnp.conj(A_f), optimize=True)
            return scatter(Rp)

        L_bound = jnp.zeros((csh, w, chi), st)
        L_bound = jnp.where(me == 0, L_bound.at[0, 0, 0].set(1.0),
                            L_bound)
        R_bound = L_bound

        def get(stacked, k):
            return jax.lax.dynamic_index_in_dim(stacked, k,
                                                keepdims=False)

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

        def right_orthogonalize_padded(mps, renorm=False):
            # renorm: same denormal-flush guard as the unsharded
            # engine's initial gauge (see ops.tdvp_chain
            # right_orthogonalize_padded docstring) with collective
            # max/norm over the shard axis
            def obody(mps, k):
                A_f = gather(get(mps, k))
                M = A_f.reshape(chi, d * chi)
                Q1, R1 = jnp.linalg.qr(jnp.conj(M).T)
                core = jnp.conj(Q1).T.reshape(chi, d, chi)
                core_l = jax.lax.dynamic_slice_in_dim(core, me * csh,
                                                      csh, 0)
                prev = jnp.einsum("adb,bc->adc", get(mps, k - 1),
                                  jnp.conj(R1).T)
                if renorm:
                    mx = jax.lax.pmax(jnp.max(jnp.abs(prev)), axis)
                    prev = prev / jnp.where(mx > 0, mx, 1.0)
                    pn = pnorm(prev)
                    prev = prev / jnp.where(pn > 0, pn, 1.0).astype(st)
                return put(put(mps, k, core_l), k - 1, prev), None

            mps, _ = jax.lax.scan(obody, mps, jnp.arange(N - 1, 0, -1))
            return mps

        mps = right_orthogonalize_padded(mps_l, renorm=True)
        n0 = pnorm(get(mps, 0))
        mps = put(mps, 0,
                  get(mps, 0) / jnp.maximum(n0, 1e-300).astype(st))

        def half_sweep_fwd(mps, delta):
            Rs = right_env_scan(mps)

            def fbody(carry, x):
                k, Rk = x
                mps, L = carry
                A, B = get(mps, k), get(mps, k + 1)
                R_f = gather(Rk)
                theta0 = jnp.einsum("asb,btc->astc", A, gather(B))
                theta = lanczos_expm(
                    lambda v: apply_h2(v, L, get(hs_r, k),
                                       get(hs_r, k + 1), R_f),
                    theta0, delta, (csh, d, d, chi))
                Q0 = gather(A).reshape(chi * d, chi)
                left, right = split_theta(theta, Q0, toward_right=True)
                L_next = update_left_env(L, left, get(hs_r, k))
                c = jnp.where(k < N - 2, -delta, 0.0 * delta)
                right = lanczos_expm(
                    lambda v: apply_h1(v, L_next, get(hs_r, k + 1), R_f),
                    right, c, (csh, d, chi))
                mps = put(put(mps, k, left), k + 1, right)
                return (mps, L_next), L

            (mps, _), Ls = jax.lax.scan(fbody, (mps, L_bound),
                                        (jnp.arange(N - 1), Rs))
            return mps, Ls

        def half_sweep_bwd(mps, delta, Ls):
            def bbody(carry, x):
                k, Lk = x
                mps, R = carry
                A, B = get(mps, k), get(mps, k + 1)
                R_f = gather(R)
                theta0 = jnp.einsum("asb,btc->astc", A, gather(B))
                theta = lanczos_expm(
                    lambda v: apply_h2(v, Lk, get(hs_r, k),
                                       get(hs_r, k + 1), R_f),
                    theta0, delta, (csh, d, d, chi))
                Q0 = gather(B).reshape(chi, d * chi).T
                left, right = split_theta(theta, Q0, toward_right=False)
                R_next = update_right_env(R, right, get(hs_r, k + 1))
                Rn_f = gather(R_next)
                c = jnp.where(k > 0, -delta, 0.0 * delta)
                left = lanczos_expm(
                    lambda v: apply_h1(v, Lk, get(hs_r, k), Rn_f),
                    left, c, (csh, d, chi))
                mps = put(put(mps, k, left), k + 1, right)
                return (mps, R_next), None

            (mps, _), _ = jax.lax.scan(
                bbody, (mps, R_bound),
                (jnp.arange(N - 2, -1, -1), jnp.flip(Ls, axis=0)))
            return mps

        def one_step(_, mps):
            mps, Ls = half_sweep_fwd(mps, delta)
            if order == 2:
                mps = half_sweep_bwd(mps, delta, Ls)
            else:
                mps = right_orthogonalize_padded(mps)
            return mps

        return jax.lax.fori_loop(0, nsteps, one_step, mps)

    sharded_sweeps = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(None, axis)),
        out_specs=P(None, axis),
    )
    return jax.jit(sharded_sweeps)(hs, mps_n)
