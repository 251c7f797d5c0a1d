"""Fully-jitted two-site linear-system solver for chains:
variational ``(a0 + a1 H) x = b`` sweeps in ONE XLA program — the
`ops.dmrg_chain` bucket-and-mask design applied to the reference's
third sweeping solver (ref tensor4all-treetn/src/linsolve.rs; the
framework path is `treetn/linsolve.py::square_linsolve`).

Per two-site block (canonical gauge, so the local metric is the
identity): solve ``A_loc theta = b_loc`` with
``A_loc = a0 I + a1 H_eff`` (H_eff through the same L/W/W/R
environments as DMRG) and ``b_loc`` the projection of b through mixed
<x|b> environments. The local solver is fixed-m MINRES (Lanczos on the
SYMMETRIC A_loc + a dense least-squares on the (m+1, m) tridiagonal —
A_loc is symmetric but generally indefinite, so CG is out and MINRES is
the Krylov method of choice; the reference uses GMRES, which reduces to
MINRES for symmetric operators). Splits reuse the column-equilibrated
subspace-QR (`_colnorm_qr`).

Everything is padded/static: the whole multi-sweep solve (gauge +
environments + sweeps + final residual report) is one device program.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from .dmrg_chain import _cholqr, _colnorm_qr, pad_mpo, pad_mps  # noqa: F401


def pad_rhs(cores, chi_b: int) -> jnp.ndarray:
    """Pad a right-hand-side TT's cores to a (N, chi_b, d, chi_b) stack."""
    return pad_mps(cores, chi_b)


@functools.partial(
    jax.jit,
    static_argnames=("n_sweeps", "minres_m", "sweep_dtype",
                     "gemm2_apply", "reortho", "bf16", "precision",
                     "svd_split", "certify"),
)
def linsolve_run(
    h: jnp.ndarray,
    b: jnp.ndarray,
    x0: jnp.ndarray,
    a0: float,
    a1: float,
    n_sweeps: int = 2,
    minres_m: int = 10,
    sweep_dtype=None,
    gemm2_apply: bool = False,
    reortho: bool = True,
    bf16: bool = False,
    precision: str = "high",
    svd_split: bool = False,
    certify: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Sweep-solve ``(a0 + a1 H) x = b``; returns (rel_residual, x).

    Args:
      h: (N, w, d, d, w) padded MPO.
      b: (N, chi_b, d, chi_b) padded right-hand side.
      x0: (N, chi, d, chi) padded initial guess (gauged inside).
      a0, a1: the affine operator coefficients (traced — re-solving with
        new coefficients does not recompile).
      n_sweeps: full (left-right-left) two-site sweeps.
      minres_m: fixed Krylov dimension of each local MINRES solve.
      gemm2_apply: precontract the environments with their MPO cores
        once per local solve so each Lanczos apply is exactly two large
        GEMMs with every M/N/K >= chi*d (same trick and shapes as
        ops.dmrg_chain's gemm2_apply — see its docstring).
      reortho: full reorthogonalization of the Lanczos basis (default).
        MINRES's 3-term recurrence is exact in exact arithmetic; at
        small m dropping reortho trades a little residual for skipping
        the O(m^2 chi^2 d^2) basis sweeps.
      bf16: store the Lanczos basis and apply operands in bfloat16
        (f32 sweeps only): halves the bandwidth bound of the hot loop;
        accumulation stays f32 via mixed-dtype einsums.
      precision: matmul precision for the whole program ('default' and
        'high' are TF32 on a GPU, 'highest' f32-grade). A low-precision
        product caps the attainable residual well above the f32 floor.

    The returned rel_residual is the GLOBAL ||(a0 + a1 H) x - b|| /
    ||b||. With ``certify=True`` (default) it is evaluated by ONE
    f64 H-moment transfer scan — trustworthy to ~1e-8 relative. (A
    sweep-dtype scan is not: measured against the f64 scan on the
    2-sweep chi=256 bench state, the f32 estimate read 7.0e-4 where the
    true residual was 7.1e-3 — the f32 moment
    expansion's accumulated-roundoff error exceeds its nominal
    eps*|terms| floor by the ~sqrt(chi d w) accumulation factor, so it
    under-reports near its floor. The f32 scan remains in use only as
    the tol loop's internal stall control, `linsolve_run_tol`
    rel_estimate.)

    ``certify=False`` returns the sweep-dtype ('high'-precision)
    estimate instead — an ESTIMATE-grade number that under-reports
    near its ~sqrt(eps(st)) floor, per the above. Use it only when the
    report will be certified separately: throughput-sensitive callers
    time certify=False and run one certify=True call (or
    `linsolve_run_tol`) for the verdict.

    Scale management: b is right-orthogonalized INSIDE the program with
    per-step renormalization, accumulating log||b|| in f64 — random
    unnormalized rhs cores over N=32 sites overflow/underflow f32
    transfer scans by 2^±100s otherwise. The solve runs
    against the unit-norm b and the scale is folded back into x evenly,
    one factor ||b||^(1/N) per core, so every returned core stays
    representable at the sweep dtype.
    """
    st = jnp.dtype(sweep_dtype) if sweep_dtype is not None else x0.dtype
    with jax.default_matmul_precision(precision):
        return _linsolve_sweeps(h.astype(st), b.astype(st),
                                x0.astype(st), jnp.asarray(a0, st),
                                jnp.asarray(a1, st), int(n_sweeps),
                                int(minres_m), bool(gemm2_apply),
                                bool(reortho), bool(bf16),
                                svd_split=bool(svd_split),
                                certify=bool(certify))


@functools.partial(
    jax.jit,
    static_argnames=("max_sweeps", "minres_m", "sweep_dtype",
                     "gemm2_apply", "reortho", "bf16", "precision",
                     "extra_sweeps", "svd_split", "split_mode",
                     "refine_sweeps"),
)
def linsolve_run_tol(
    h: jnp.ndarray,
    b: jnp.ndarray,
    x0: jnp.ndarray,
    a0: float,
    a1: float,
    tol: float = 1e-6,
    max_sweeps: int = 10,
    minres_m: int = 16,
    sweep_dtype=None,
    gemm2_apply: bool = False,
    reortho: bool = True,
    bf16: bool = False,
    precision: str = "high",
    extra_sweeps: int = 1,
    svd_split: bool | str = "auto",
    split_mode: str = "interleaved",
    refine_sweeps: int = 2,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Sweep-solve ``(a0 + a1 H) x = b`` UNTIL the relative residual
    meets ``tol`` (the reference's solve contract: sweep to tolerance
    with a residual verify report, ref linsolve/square/updater.rs) —
    still one XLA program, with a `lax.while_loop` over full sweeps.

    Returns ``(rel_certified, rel_estimate, x, sweeps_used)``:

    - ``rel_certified``: ||(a0+a1 H)x - b|| / ||b|| measured by ONE
      f64 moment scan after the loop — trustworthy down to
      ~1e-8 relative, far below the f32 estimator's ~sqrt(eps) floor.
      This is the verify report; assert on THIS value.
    - ``rel_estimate``: the last in-loop sweep-dtype estimate (floor-
      clamped; equals the floor once converged past it).
    - ``sweeps_used``: while-loop trip count (f64 scalar array),
      EXCLUDING the ``refine_sweeps`` epilogue.

    Stopping: estimate <= tol, OR `max_sweeps`, OR the estimate stalls
    (< 30% improvement) for more than `extra_sweeps` consecutive
    sweeps. At f32 sweep dtype the estimator cannot see below its
    ~sqrt(eps_f32) ~ 3e-4 measurement floor, so a tight ``tol`` is
    reached through the stall exit PLUS the ``refine_sweeps`` epilogue:
    a STATIC number of python-unrolled extra sweeps after the loop
    (the true residual keeps improving below the estimator floor; the
    epilogue buys the final decades blind, and the f64 certificate
    reveals where the state landed). ``tol`` is traced (re-solving with
    a new tolerance does not recompile); `max_sweeps` is static.

    ``svd_split``: 'auto' (default) uses SVD two-site splits on CPU
    backends and the ``split_mode`` splits elsewhere (an earlier
    accelerator runtime aborted on `jnp.linalg.svd` inside the sweep
    `while_loop`). Pass True/False to force.

    ``split_mode`` (ignored under ``svd_split``):

    - ``"interleaved"`` (default): warm-started subspace iteration
      with an orthonormalization BETWEEN the two half-products
      (Z = orth(M^H Q); Q = orth(M Z), column-equilibrated Householder
      `_colnorm_qr`). The fused form rounds the product M M^H Q at
      eps * sigma_max^2, burying every direction below
      ~sqrt(eps_f32) * sigma_max and flooring the solve at ~1e-3
      relative (measured: the tol loop stalled at 7e-3 certified).
      Keeping each intermediate at dynamic range sigma (exactly how
      ops.tdvp_chain_split splits) drops the split floor to eps-grade,
      all in f32. The orth
      must be Householder, not `_cholqr`: the iterates at the chain
      ends are heavily rank-deficient and `_cholqr`'s projector
      completion ZEROES sub-threshold columns, collapsing live
      directions whose equilibrated norms sit under 10*eps_f32 of the
      max (measured: cert 1.7e-3 with `_cholqr` interleave vs 9.3e-7
      with Householder on the same solve; the f64 split dodges this
      only because eps_f64 keeps those columns above threshold).
    - ``"fused"``: `linsolve_run`'s throughput split (fewer orths,
      ~1e-3 split floor) — fine when tol is loose.
    - ``"f64"``: run the splits in f64. Numerically ideal and the CPU
      reference; its cost and behaviour on the GPU are not measured
      yet.

    All other args as in `linsolve_run`.
    """
    if svd_split == "auto":
        try:
            svd_split = jax.default_backend() == "cpu"
        except Exception:  # noqa: BLE001
            svd_split = False
    if split_mode not in ("interleaved", "fused", "f64"):
        raise ValueError(f"unknown split_mode {split_mode!r}")
    st = jnp.dtype(sweep_dtype) if sweep_dtype is not None else x0.dtype
    with jax.default_matmul_precision(precision):
        return _linsolve_sweeps(h.astype(st), b.astype(st),
                                x0.astype(st), jnp.asarray(a0, st),
                                jnp.asarray(a1, st), 0,
                                int(minres_m), bool(gemm2_apply),
                                bool(reortho), bool(bf16),
                                tol=jnp.asarray(tol, jnp.float64),
                                max_sweeps=int(max_sweeps),
                                extra_sweeps=int(extra_sweeps),
                                svd_split=bool(svd_split),
                                split_mode=str(split_mode),
                                refine_sweeps=int(refine_sweeps))


def _linsolve_sweeps(h, b, x, a0, a1, n_sweeps, m,
                     gemm2_apply=False, reortho=True, bf16=False,
                     tol=None, max_sweeps=0, extra_sweeps=1,
                     svd_split=False, split_mode="fused",
                     refine_sweeps=0, certify=True):
    N, chi, d, _ = x.shape
    chib = b.shape[1]
    w = h.shape[1]
    st = x.dtype
    hs = h

    def norm_of(A):
        return jnp.sqrt(jnp.sum(jnp.abs(A) ** 2).astype(jnp.float64))

    def get(stacked, k):
        return jax.lax.dynamic_index_in_dim(stacked, k, keepdims=False)

    def put(stacked, k, val):
        return jax.lax.dynamic_update_index_in_dim(stacked, val, k,
                                                   axis=0)

    # ---- initial gauge: right-orthogonalize x (same denormal-safe
    # per-step renorm as ops.tdvp_chain). x0's absorbed scale is
    # DISCARDED: it only conditions the initial guess — the first local
    # MINRES solve restores the true local scale from b_loc.
    core_scale = jnp.max(jnp.abs(x), axis=(1, 2, 3), keepdims=True)
    x = x / jnp.where(core_scale > 0, core_scale, 1.0)
    core_norms = jnp.sqrt(jnp.sum(jnp.abs(x) ** 2, axis=(1, 2, 3),
                                  keepdims=True))
    x = x / jnp.where(core_norms > 0, core_norms, 1.0)

    def right_orthogonalize(x):
        def body(carry, k):
            x = carry
            A = get(x, k)
            M = A.reshape(chi, d * chi)
            Q1, R1 = jnp.linalg.qr(jnp.conj(M).T)
            core = jnp.conj(Q1).T.reshape(chi, d, chi)
            prev = jnp.einsum("adb,bc->adc", get(x, k - 1),
                              jnp.conj(R1).T)
            mx = jnp.max(jnp.abs(prev))
            prev = prev / jnp.where(mx > 0, mx, 1.0)
            pn = jnp.sqrt(jnp.sum(jnp.abs(prev) ** 2))
            prev = prev / jnp.where(pn > 0, pn, 1.0).astype(st)
            return put(put(x, k, core), k - 1, prev), None

        x, _ = jax.lax.scan(body, x, jnp.arange(N - 1, 0, -1))
        return x

    x = right_orthogonalize(x)

    # ---- gauge b: right-orthogonalize with log-scale tracking so the
    # solve sees a UNIT-norm rhs (see linsolve_run docstring). All
    # discarded factors accumulate into log_bscale (f64; immune to the
    # 2^±100s swings that break f32 transfer scans).
    def safe_log(v):
        return jnp.where(v > 0, jnp.log(jnp.maximum(v, 1e-300)), 0.0)

    # In tol mode the gauge runs in f64 so the CERTIFIED residual is
    # measured against the caller's b to f64 grade — an f32 gauge
    # re-encodes b with ~sqrt(N)*eps_f32 ~ 3e-7 relative error, right
    # at the 1e-6 certification target (see linsolve_run_tol).
    if tol is not None:
        b = b.astype(jnp.float64)
    bdt = b.dtype
    bmax = jnp.max(jnp.abs(b), axis=(1, 2, 3), keepdims=True)
    b = b / jnp.where(bmax > 0, bmax, 1.0)
    log_bscale = jnp.sum(safe_log(bmax.astype(jnp.float64)))

    def right_orthogonalize_b(b, log_bscale):
        def body(carry, k):
            b, ls = carry
            A = get(b, k)
            M = A.reshape(chib, d * chib)
            Q1, R1 = jnp.linalg.qr(jnp.conj(M).T)
            core = jnp.conj(Q1).T.reshape(chib, d, chib)
            prev = jnp.einsum("adb,bc->adc", get(b, k - 1),
                              jnp.conj(R1).T)
            mx = jnp.max(jnp.abs(prev)).astype(jnp.float64)
            prev = prev / jnp.where(mx > 0, mx, 1.0).astype(bdt)
            pn = jnp.sqrt(jnp.sum(jnp.abs(prev) ** 2)
                          .astype(jnp.float64))
            prev = prev / jnp.where(pn > 0, pn, 1.0).astype(bdt)
            ls = ls + safe_log(mx) + safe_log(pn)
            return (put(put(b, k, core), k - 1, prev), ls), None

        (b, log_bscale), _ = jax.lax.scan(
            body, (b, log_bscale), jnp.arange(N - 1, 0, -1))
        return b, log_bscale

    b, log_bscale = right_orthogonalize_b(b, log_bscale)
    b64 = b if tol is not None else None
    b = b.astype(st)

    # ---- environments
    L_bound = jnp.zeros((chi, w, chi), st).at[0, 0, 0].set(1.0)
    R_bound = jnp.zeros((chi, w, chi), st).at[0, 0, 0].set(1.0)
    Lb_bound = jnp.zeros((chi, chib), st).at[0, 0].set(1.0)
    Rb_bound = jnp.zeros((chi, chib), st).at[0, 0].set(1.0)

    def update_left_env(L, A, W):
        return jnp.einsum("alx,aib,loir,xoB->brB", L, A, W,
                          jnp.conj(A), optimize=True)

    def update_right_env(R, A, W):
        return jnp.einsum("brB,aib,loir,xoB->alx", R, A, W,
                          jnp.conj(A), optimize=True)

    def update_left_benv(Lb, A, Bc):
        # Lb[x-bond, b-bond]: contract conj(x core) with b core
        return jnp.einsum("pB,piq,BiC->qC", Lb, jnp.conj(A), Bc,
                          optimize=True)

    def update_right_benv(Rb, A, Bc):
        return jnp.einsum("aB,qia,CiB->qC", Rb, jnp.conj(A), Bc,
                          optimize=True)

    def right_env_scan(x):
        # Rs[k] = H-env of cores k+2..N-1 (see ops.dmrg_chain)
        def body(R, k):
            Rn = update_right_env(R, get(x, k), get(hs, k))
            return Rn, Rn

        _, Rs = jax.lax.scan(body, R_bound, jnp.arange(N - 1, 1, -1))
        Rs = jnp.flip(Rs, axis=0)
        return jnp.concatenate([Rs, R_bound[None]], axis=0)

    def right_benv_scan(x):
        def body(Rb, k):
            Rn = update_right_benv(Rb, get(x, k), get(b, k))
            return Rn, Rn

        _, Rbs = jax.lax.scan(body, Rb_bound, jnp.arange(N - 1, 1, -1))
        Rbs = jnp.flip(Rbs, axis=0)
        return jnp.concatenate([Rbs, Rb_bound[None]], axis=0)

    # compute/storage dtype of the MINRES hot loop (see linsolve_run)
    ct = jnp.bfloat16 if (bf16 and st == jnp.float32) else st

    def local_rhs(Lb, bk, bk1, Rb):
        return jnp.einsum("aB,BiC,CjD,eD->aije", Lb, bk, bk1, Rb,
                          optimize=True)

    def minres(theta0, b_loc, L, Wl, Wr, R):
        """Fixed-m MINRES: Lanczos on A_loc from r0, then the dense
        (m+1, m) tridiagonal least squares by unrolled Givens QR."""
        Lc, Wlc = L.astype(ct), Wl.astype(ct)
        Wrc, Rc = Wr.astype(ct), R.astype(ct)
        if gemm2_apply:
            # same two-GEMM apply as ops.dmrg_chain.lanczos_ground:
            # every M/N/K >= chi*d, no (w d)-sized contraction
            LW = jnp.einsum("alx,lpim->aixpm", Lc, Wlc)
            RW = jnp.einsum("mqjr,brB->mjbqB", Wrc, Rc)

            def apply_A(th):
                t1 = jnp.einsum("aixpm,aijb->xpmjb", LW, th.astype(ct))
                y = jnp.einsum("xpmjb,mjbqB->xpqB", t1, RW).astype(st)
                return a0 * th + a1 * y
        else:
            def apply_A(th):
                y = jnp.einsum("alx,lpim,mqjr,aijb,brB->xpqB",
                               Lc, Wlc, Wrc, th.astype(ct), Rc,
                               optimize=True).astype(st)
                return a0 * th + a1 * y

        r0 = b_loc - apply_A(theta0)
        beta = norm_of(r0)
        v = r0 / jnp.maximum(beta, 1e-300).astype(st)
        basis = jnp.zeros((m,) + theta0.shape, ct)
        alphas = jnp.zeros((m,), jnp.float64)
        betas = jnp.zeros((m + 1,), jnp.float64)

        def body(i, carry):
            basis, alphas, betas, v, v_prev, b_prev = carry
            basis = basis.at[i].set(v.astype(ct))
            hv = apply_A(v)
            a_ = jnp.real(jnp.sum(jnp.conj(v) * hv))
            hv = hv - a_.astype(st) * v - b_prev.astype(st) * v_prev
            if reortho:
                # full reorthogonalization (m is small; keeps T
                # faithful); mixed-dtype einsums keep bf16 basis reads
                ov = jnp.einsum("m...,...->m", jnp.conj(basis), hv)
                mask = (jnp.arange(m) <= i).astype(hv.dtype)
                hv = hv - jnp.einsum("m,m...->...", ov * mask, basis)
            b_ = norm_of(hv)
            v_next = hv / jnp.maximum(b_, 1e-300).astype(st)
            alphas = alphas.at[i].set(a_.astype(jnp.float64))
            betas = betas.at[i + 1].set(b_)
            return (basis, alphas, betas, v_next, v, b_)

        carry = (basis, alphas, betas, v, jnp.zeros_like(v),
                 jnp.float64(0.0))
        basis, alphas, betas, _, _, _ = jax.lax.fori_loop(
            0, m, body, carry)
        # T_bar ((m+1) x m): diag alphas, super/sub betas[1..m]
        Tb = jnp.zeros((m + 1, m), jnp.float64)
        Tb = Tb.at[jnp.arange(m), jnp.arange(m)].set(alphas)
        Tb = Tb.at[jnp.arange(1, m + 1), jnp.arange(m)].set(betas[1:])
        Tb = Tb.at[jnp.arange(m - 1), jnp.arange(1, m)].set(betas[1:m])
        rhs = jnp.zeros((m + 1,), jnp.float64).at[0].set(beta)
        # least squares min ||Tb y - rhs|| by UNROLLED Givens QR + back
        # substitution: m is tiny and this stays ELEMENTWISE-only (and
        # normal equations would square the condition number). Dead
        # Krylov directions give zero pivots; their y
        # components are masked to 0.
        tiny = jnp.float64(1e-300)
        R_ = Tb
        g_ = rhs
        for i in range(m):
            a_ = R_[i, i]
            b2 = R_[i + 1, i]
            r_ = jnp.sqrt(a_ * a_ + b2 * b2)
            c_ = a_ / jnp.maximum(r_, tiny)
            s_ = b2 / jnp.maximum(r_, tiny)
            Ri = c_ * R_[i] + s_ * R_[i + 1]
            Ri1 = -s_ * R_[i] + c_ * R_[i + 1]
            R_ = R_.at[i].set(Ri).at[i + 1].set(Ri1)
            gi = c_ * g_[i] + s_ * g_[i + 1]
            gi1 = -s_ * g_[i] + c_ * g_[i + 1]
            g_ = g_.at[i].set(gi).at[i + 1].set(gi1)
        y = jnp.zeros((m,), jnp.float64)
        for i in range(m - 1, -1, -1):
            upper = R_[i, i + 1:] @ y[i + 1:] if i + 1 < m else 0.0
            pivot = R_[i, i]
            yi = jnp.where(jnp.abs(pivot) > 1e-14 * jnp.abs(R_[0, 0]),
                           (g_[i] - upper)
                           / jnp.where(jnp.abs(pivot) > 0, pivot, 1.0),
                           0.0)
            y = y.at[i].set(yi)
        dtheta = jnp.einsum("m,m...->...", y.astype(st), basis)
        return theta0 + dtheta

    def split_theta(theta, Q0, toward_right):
        mat = theta.reshape(chi * d, d * chi)
        if svd_split:
            # exact dominant-subspace split: the subspace-iteration
            # split below squares theta's singular values (a
            # CholeskyQR-grade product), so its split error floors at
            # ~eps * kappa(theta)^2 — measured 1.3e-3 relative residual
            # at f32 on a kappa ~ 1e2 solve, a SYSTEMATIC fixed-point
            # bias. DMRG/TDVP tolerate that floor (energy/trajectory
            # are quadratically insensitive to split error; their
            # thetas are also truncated anyway), but a residual
            # CONTRACT is linearly sensitive, so the to-tolerance
            # engine pays one SVD per bond for an eps-grade split.
            U, S, Vh = jnp.linalg.svd(mat, full_matrices=False)
            if toward_right:
                Q = U[:, :chi]
                left = Q.reshape(chi, d, chi)
                right = (S[:chi, None] * Vh[:chi]).reshape(chi, d, chi)
            else:
                right = Vh[:chi].reshape(chi, d, chi)
                left = (U[:, :chi] * S[None, :chi]).reshape(chi, d, chi)
            return left, right
        orth = _colnorm_qr
        if split_mode == "f64":
            # f64 subspace iteration: numerically ideal (split bias
            # ~eps_f64 * kappa^2 ~ 1e-12). The orthogonalizer is
            # `_cholqr` (GEMM-only) rather than f64 Householder panels.
            wide = (jnp.complex128 if jnp.iscomplexobj(mat)
                    else jnp.float64)
            mat = mat.astype(wide)
            Q0 = Q0.astype(wide)
            orth = _cholqr
        if split_mode == "interleaved":
            # orthonormalize BETWEEN the half-products: each product
            # then rounds at eps * sigma_max * ||orthonormal operand||
            # instead of eps * sigma_max^2, so the split resolves
            # directions all the way down to ~eps_f32 * sigma_max —
            # the fused form's ~sqrt(eps) * sigma_max blind spot is
            # what stalled the tol loop at 7e-3. Householder
            # (_colnorm_qr), NOT _cholqr: the chain-end iterates are
            # heavily rank-deficient and _cholqr's projector completion
            # zeroes live-but-small columns (see linsolve_run_tol).
            if toward_right:
                Q = Q0
                for _ in range(2):
                    Z = _colnorm_qr(jnp.conj(mat).T @ Q)
                    Q = _colnorm_qr(mat @ Z)
                left = Q.reshape(chi, d, chi)
                right = (jnp.conj(Q).T @ mat).reshape(chi, d, chi)
            else:
                Q = Q0
                for _ in range(2):
                    Z = _colnorm_qr(mat @ Q)
                    Q = _colnorm_qr(jnp.conj(mat).T @ Z)
                right = jnp.conj(Q).T.reshape(chi, d, chi)
                left = (mat @ Q).reshape(chi, d, chi)
            return left, right
        if toward_right:
            Q = orth(mat @ (jnp.conj(mat).T @ Q0))
            Q = orth(mat @ (jnp.conj(mat).T @ Q))
            left = Q.astype(st).reshape(chi, d, chi)
            right = (jnp.conj(Q).T @ mat).astype(st).reshape(chi, d, chi)
        else:
            Q = orth(jnp.conj(mat).T @ (mat @ Q0))
            Q = orth(jnp.conj(mat).T @ (mat @ Q))
            right = jnp.conj(Q).T.astype(st).reshape(chi, d, chi)
            left = (mat @ Q).astype(st).reshape(chi, d, chi)
        return left, right

    def one_sweep(_, x):
        Rs = right_env_scan(x)
        Rbs = right_benv_scan(x)

        def fwd(carry, k):
            x, L, Lb = carry
            A, B2 = get(x, k), get(x, k + 1)
            theta0 = jnp.einsum("asb,btc->astc", A, B2)
            theta = minres(
                theta0,
                local_rhs(Lb, get(b, k), get(b, k + 1), get(Rbs, k)),
                L, get(hs, k), get(hs, k + 1), get(Rs, k))
            left, right = split_theta(theta, A.reshape(chi * d, chi),
                                      toward_right=True)
            x = put(put(x, k, left), k + 1, right)
            L = update_left_env(L, left, get(hs, k))
            Lb = update_left_benv(Lb, left, get(b, k))
            return (x, L, Lb), (L, Lb)

        (x, _, _), (Ls, Lbs) = jax.lax.scan(
            fwd, (x, L_bound, Lb_bound), jnp.arange(N - 1))

        def bwd(carry, xk):
            k, Lk, Lbk = xk
            x, R, Rb = carry
            A, B2 = get(x, k), get(x, k + 1)
            theta0 = jnp.einsum("asb,btc->astc", A, B2)
            theta = minres(theta0,
                           local_rhs(Lbk, get(b, k), get(b, k + 1), Rb),
                           Lk, get(hs, k), get(hs, k + 1), R)
            left, right = split_theta(
                theta, B2.reshape(chi, d * chi).T, toward_right=False)
            x = put(put(x, k, left), k + 1, right)
            R = update_right_env(R, right, get(hs, k + 1))
            Rb = update_right_benv(Rb, right, get(b, k + 1))
            return (x, R, Rb), None

        # bwd at bond k needs the PRE-update left envs of bond k: those
        # are the envs EMITTED at bond k-1 of the fwd scan (env of
        # cores 0..k-1); bond 0 uses the boundaries
        Ls_pre = jnp.concatenate([L_bound[None], Ls[:-1]], axis=0)
        Lbs_pre = jnp.concatenate([Lb_bound[None], Lbs[:-1]], axis=0)
        ks_bwd = jnp.arange(N - 2, -1, -1)
        (x, _, _), _ = jax.lax.scan(
            bwd, (x, R_bound, Rb_bound),
            (ks_bwd, Ls_pre[ks_bwd], Lbs_pre[ks_bwd]))
        return x

    if tol is None:
        x = jax.lax.fori_loop(0, n_sweeps, one_sweep, x)
        if not certify:
            # estimate-grade report (see linsolve_run docstring):
            # sweep-dtype scans at f32-grade matmul precision, floor-
            # clamped; the f64 certification scan stays out of the
            # program entirely.
            rel = _moment_rel_residual(h, b, x, a0, a1)
            return rel, _fold_bscale(x, log_bscale)
        return _residual_and_fold(h, b, x, a0, a1, log_bscale)

    # ---- sweep-to-tolerance mode (ref linsolve/square/updater.rs sweeps until the verify report meets
    # tol). One lax.while_loop: each iteration runs a full sweep and
    # re-measures the sweep-dtype moment residual (floor-clamped, so
    # at f32 it bottoms out ~sqrt(eps_f32) ~ 3e-4 relative). The loop
    # stops on (a) estimate <= tol, (b) max_sweeps, or (c) the
    # estimate stalling — failing to improve by >=30% for more than
    # `extra_sweeps` consecutive sweeps, which is what convergence
    # BELOW the estimator's floor looks like from inside f32. The
    # caller then certifies the true residual with one f64 moment scan
    # (linsolve_run_tol).
    def cond(carry):
        _, rel, _, k, stall = carry
        return ((k < max_sweeps) & (rel > tol)
                & (stall <= extra_sweeps))

    def body(carry):
        x_, rel, _, k, stall = carry
        x_ = one_sweep(0, x_)
        # sweep-dtype estimate for the stall control only: it floors
        # at ~sqrt(eps(st)) relative, and the f64 work stays OUT of
        # the while_loop.
        new_rel = _moment_rel_residual(hs, b, x_, a0, a1)
        stall = jnp.where(new_rel > 0.7 * rel, stall + 1,
                          jnp.zeros_like(stall))
        return (x_, new_rel, rel, k + 1, stall)

    carry = (x, jnp.float64(jnp.inf), jnp.float64(jnp.inf),
             jnp.int32(0), jnp.int32(0))
    x, rel_est, _, sweeps_used, _ = jax.lax.while_loop(cond, body,
                                                       carry)
    # refine epilogue: python-unrolled sweeps OUTSIDE the while_loop.
    # The f32 estimator cannot steer below its ~3e-4 floor, but the
    # interleaved splits keep genuinely improving the true residual;
    # these static extra sweeps buy the final decades blind and the
    # f64 certificate below reveals where the state landed.
    for _ in range(refine_sweeps):
        x = one_sweep(0, x)
    rel64 = _moment_rel_residual(hs, b64, x, a0, a1, jnp.float64)
    return rel64, rel_est, _fold_bscale(x, log_bscale), sweeps_used


def _moment_rel_residual(hs, b, x, a0, a1, resid_dtype=None):
    # ---- global relative residual ||(a0 + a1 H) x - b|| / ||b||
    # via transfer contractions: ||r||^2 = <x|(a0+a1H)^2|x>
    #   - 2 <b|(a0+a1H)|x> + <b|b>  expanded into H-moment scans.
    # Separate function so the scans run at f32-grade matmul precision
    # REGARDLESS of the sweep precision: one-bf16-pass moment scans
    # measure pure noise (rel reports of 0.0/0.12 on converged states)
    # while costing a negligible share of the solve.
    #
    # resid_dtype=jnp.float64 runs the scans in f64:
    # the expansion's cancellation floor drops from ~sqrt(eps_f32)
    # (~3e-4 relative) to ~sqrt(eps_f64) (~1e-8) — the CERTIFICATION
    # grade `linsolve_run_tol` reports, per the reference's verify
    # semantics (ref linsolve/square/updater.rs residual report).
    if resid_dtype is not None:
        hs = hs.astype(resid_dtype)
        b = b.astype(resid_dtype)
        x = x.astype(resid_dtype)
    N, chi, d, _ = x.shape
    chib = b.shape[1]
    w = hs.shape[1]
    st = x.dtype

    def get(stacked, k):
        return jax.lax.dynamic_index_in_dim(stacked, k, keepdims=False)

    def update_left_env(L, A, W):
        return jnp.einsum("alx,aib,loir,xoB->brB", L, A, W,
                          jnp.conj(A), optimize=True)
    def scan_xx():
        T = jnp.zeros((chi, chi), st).at[0, 0].set(1.0)

        def body(T, k):
            A = get(x, k)
            return jnp.einsum("ax,aib,xiB->bB", T, A, jnp.conj(A),
                              optimize=True), None

        T, _ = jax.lax.scan(body, T, jnp.arange(N))
        return jnp.real(T[0, 0])

    def scan_bb():
        T = jnp.zeros((chib, chib), st).at[0, 0].set(1.0)

        def body(T, k):
            Bc = get(b, k)
            return jnp.einsum("ax,aib,xiB->bB", T, Bc, jnp.conj(Bc),
                              optimize=True), None

        T, _ = jax.lax.scan(body, T, jnp.arange(N))
        return jnp.real(T[0, 0])

    def scan_xhx():
        T = jnp.zeros((chi, w, chi), st).at[0, 0, 0].set(1.0)

        def body(T, k):
            A = get(x, k)
            return update_left_env(T, A, get(hs, k)), None

        T, _ = jax.lax.scan(body, T, jnp.arange(N))
        return jnp.real(T[0, 0, 0])

    def scan_xhhx():
        T = jnp.zeros((chi, w, w, chi), st)
        T = T.at[0, 0, 0, 0].set(1.0)

        def body(T, k):
            A = get(x, k)
            W = get(hs, k)
            return jnp.einsum("almx,aib,loir,mpoq,xpB->brqB",
                              T, A, W, W, jnp.conj(A),
                              optimize=True), None

        T, _ = jax.lax.scan(body, T, jnp.arange(N))
        return jnp.real(T[0, 0, 0, 0])

    def scan_bhx():
        T = jnp.zeros((chi, w, chib), st).at[0, 0, 0].set(1.0)

        def body(T, k):
            A = get(x, k)
            W = get(hs, k)
            Bc = get(b, k)
            return jnp.einsum("alc,aib,loir,coC->brC", T, A, W,
                              jnp.conj(Bc), optimize=True), None

        T, _ = jax.lax.scan(body, T, jnp.arange(N))
        return jnp.real(T[0, 0, 0])

    def scan_bx():
        T = jnp.zeros((chi, chib), st).at[0, 0].set(1.0)

        def body(T, k):
            A = get(x, k)
            Bc = get(b, k)
            return jnp.einsum("ac,aib,ciC->bC", T, A, jnp.conj(Bc),
                              optimize=True), None

        T, _ = jax.lax.scan(body, T, jnp.arange(N))
        return jnp.real(T[0, 0])

    with jax.default_matmul_precision("highest"):
        xx = scan_xx()
        bb = scan_bb()
        xhx = scan_xhx()
        xhhx = scan_xhhx()
        bx = scan_bx()
        bhx = scan_bhx()
    a0r = jnp.real(a0).astype(jnp.float64)
    a1r = jnp.real(a1).astype(jnp.float64)
    r2 = (a0r ** 2 * xx + 2 * a0r * a1r * xhx + a1r ** 2 * xhhx
          - 2 * (a0r * bx + a1r * bhx) + bb)
    # the moment expansion cancels catastrophically near convergence:
    # its absolute error is ~eps(st) * the MAGNITUDE sum of the terms,
    # so clamp the report to that measurement floor instead of letting
    # a slightly-negative r2 read as an (impossible) exact 0. A report
    # AT the floor means "at or below" — same contract as
    # treetn.linsolve._verify's documented ~sqrt(eps)*||b|| floor.
    mag = (a0r ** 2 * jnp.abs(xx) + 2 * jnp.abs(a0r * a1r * xhx)
           + a1r ** 2 * jnp.abs(xhhx)
           + 2 * (jnp.abs(a0r * bx) + jnp.abs(a1r * bhx)) + jnp.abs(bb))
    # roundoff adds in quadrature across the N-site scans, so the
    # magnitude sum x eps is already a conservative bound
    r2_floor = jnp.finfo(st).eps * mag
    rel = jnp.sqrt(jnp.maximum(r2, r2_floor) / jnp.maximum(bb, 1e-300))
    return rel.astype(jnp.float64)


def _fold_bscale(x, log_bscale):
    # fold ||b|| back into x, one ||b||^(1/N) factor per core (the
    # moment residual is scale-invariant, so it is computed pre-fold)
    N = x.shape[0]
    return x * jnp.exp(log_bscale / N).astype(x.dtype)


def _residual_and_fold(hs, b, x, a0, a1, log_bscale):
    # f64-certified report (see linsolve_run docstring): the sweep-
    # dtype moment scan under-reports near its floor, so the returned
    # residual is always certification-grade. Note b here is the
    # SWEEP-dtype gauged rhs, so the report carries the gauge's
    # ~sqrt(N)*eps(st) re-encoding (~3e-7 at f32) — fine for the
    # fixed-sweep engine's 1e-3-grade regime; the tol engine gauges b
    # in f64 and certifies against the caller's b exactly.
    rel = _moment_rel_residual(hs, b, x, a0, a1, jnp.float64)
    return rel, _fold_bscale(x, log_bscale)


def linsolve_sweep_flops(N: int, chi: int, chib: int, d: int, w: int,
                         minres_m: int, n_sweeps: int,
                         gemm2_apply: bool = False,
                         reortho: bool = True) -> float:
    """Analytic FLOP count of ``linsolve_run``'s sweep loop (same cost
    model family as dmrg_sweep_flops/tdvp_sweep_flops; mirrors the
    engine exactly: m+1 local applies per solve (r0 + m iterations),
    knob-aware apply/reortho costs, 2x2-pass subspace-QR splits, H- and
    b-environment updates)."""
    import numpy as np
    import opt_einsum as oe

    def ec(expr, shapes):
        _, info = oe.contract_path(
            expr, *[np.empty(s, np.float32) for s in shapes])
        return float(info.opt_cost)

    if gemm2_apply:
        pre_f = (ec("alx,lpim->aixpm",
                    [(chi, w, chi), (w, d, d, w)])
                 + ec("mqjr,brB->mjbqB",
                      [(w, d, d, w), (chi, w, chi)]))
        apply_f = (ec("aixpm,aijb->xpmjb",
                      [(chi, d, chi, d, w), (chi, d, d, chi)])
                   + ec("xpmjb,mjbqB->xpqB",
                        [(chi, d, w, d, chi), (w, d, chi, d, chi)]))
    else:
        pre_f = 0.0
        apply_f = ec("alx,lpim,mqjr,aijb,brB->xpqB",
                     [(chi, w, chi), (w, d, d, w), (w, d, d, w),
                      (chi, d, d, chi), (chi, w, chi)])
    rhs_f = ec("aB,BiC,CjD,eD->aije",
               [(chi, chib), (chib, d, chib), (chib, d, chib),
                (chi, chib)])
    envh_f = ec("alx,aib,loir,xoB->brB",
                [(chi, w, chi), (chi, d, chi), (w, d, d, w),
                 (chi, d, chi)])
    envb_f = ec("pB,piq,BiC->qC",
                [(chi, chib), (chi, d, chi), (chib, d, chib)])
    td = chi * d * d * chi
    m = minres_m
    lan = pre_f + (m + 1) * (apply_f + 2 * td) + m * 4 * td
    if reortho:
        lan += m * 4 * m * td
    theta0_f = 2.0 * chi ** 3 * d ** 2
    qr_f = 4 * 2.0 * (chi * d) * chi ** 2
    mm_f = 4 * 2.0 * (chi * d) * (d * chi) * chi
    per_bond = theta0_f + rhs_f + lan + qr_f + mm_f + envh_f + envb_f
    per_sweep = 2 * (N - 1) * per_bond + (N - 1) * (envh_f + envb_f)
    return n_sweeps * per_sweep
