"""Fully-jitted two-site TDVP engine for COMB trees at production chi:
time evolution on the first tree family whose backbone bond dimension
is GEMM-scale — the time-evolution counterpart of `ops.dmrg_comb`
(trees get BOTH flagship solvers on device, not just ground states).

Reference scope: the reference's tree TDVP sweeps arbitrary trees
through per-region plans with projector-splitting time accounting
(tensor4all-treetn/src/tdvp/plan.rs:1-379, tdvp/mod.rs:1101); its
per-local-op dispatch model cannot feed an accelerator. Here the comb's whole
multi-step evolution — gauge, environments, every edge propagator and
backward correction — is ONE XLA program, with the same bucket-and-
mask layout as `dmrg_comb` (`random_comb_state` shapes).

Integrator (order 2): a palindromic Euler-tour Strang splitting.
One step = pass P then reverse(P), where

    P = [D_0, b_0, D_1, b_1, ..., b_{Nb-2}, D_{Nb-1}]

with b_k the backbone edge (k, k+1) and D_k the tooth dive at node k
(root edge down, tooth edges down then up, root edge up — each tooth
edge appears exactly twice inside its dive, so the full step evolves
every comb edge by a total of dt). Per-visit coefficients follow the
local-time bookkeeping that makes every two-site propagator act on a
time-consistent pair (both sites at equal local time) and advances
every site by exactly dt/2 per pass:

  - backbone-edge visits advance +D (D = dt/2), tooth/root-edge visits
    +D/2 (they occur twice per pass);
  - after each split, the new center is evolved BACKWARD by the amount
    that rewinds it to the next region's partner time: -D after
    backbone-type evolutions (arrival at a node, and after a dive when
    a backbone edge follows), -D/2 after tooth-type evolutions;
  - turns (the tooth bottom; the consecutive D_{Nb-1} dives at the
    pass boundary; the chain's last-bond turn when Mt = 0) and the
    step end get no correction.

For Mt = 0 this reduces exactly to the chain scheme of
`ops.tdvp_chain._tdvp_sweeps` (forward half, backward half, -D
one-site corrections except at the turn/end). Order 1 is the Lie
version: pass P alone with D = dt, then a backbone re-gauge.

Splits are the comb subspace-QR with column equilibration between the
two GEMMs (`dmrg_comb.split_mat` rationale: tooth Schmidt spectra decay
fast enough that sigma^2-weighted columns lose live directions in f32)
— exact re-factorizations at full padded rank, so the integrator's
only errors are the splitting error and the chi/chit projection, as in
the reference's trajectory contract.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from .dmrg_chain import _colnorm_qr
from .tdvp_chain import _expm_tridiag_e0


@functools.partial(
    jax.jit,
    static_argnames=("nsteps", "order", "krylov_m", "tooth_krylov_m",
                     "krylov_m1", "sweep_dtype", "gemm2_apply",
                     "reortho", "precision", "expm_max_squarings"),
)
def tdvp_comb_run(
    wb: jnp.ndarray,
    wt: jnp.ndarray,
    ab0: jnp.ndarray,
    at0: jnp.ndarray,
    t: complex,
    nsteps: int = 1,
    order: int = 2,
    krylov_m: int = 12,
    tooth_krylov_m: int = 8,
    krylov_m1: int | None = None,
    sweep_dtype=None,
    gemm2_apply: bool = False,
    reortho: bool = True,
    precision: str = "highest",
    expm_max_squarings: int = 20,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Evolve ``exp(t*H)|ab0, at0>`` on the comb; returns (Ab, At).

    Args:
      wb, wt: padded comb MPO stacks (`dmrg_comb.comb_operator_stacks`).
      ab0, at0: padded comb state (`dmrg_comb.random_comb_state`
        shapes); gauged + unit-normalized inside (the whole call is
        still one device program).
      t: total evolution (``-tau`` imaginary time — real sweep dtypes;
        ``-1j*T`` real time needs a complex sweep dtype).
      krylov_m / tooth_krylov_m / krylov_m1: fixed Krylov depths of the
        backbone-edge / tooth-edge two-site propagators and of the
        backward one-site correctors (default: ``tooth_krylov_m``).
      gemm2_apply: two-GEMM backbone applies by per-propagator
        precontraction (see `dmrg_comb.dmrg_comb_run`).
      reortho: full Krylov reorthogonalization (False keeps the 3-term
        recurrence — the short-time-propagator argument of
        `tdvp_chain.tdvp_run` applies unchanged).
    """
    if order not in (1, 2):
        raise ValueError("order must be 1 or 2")
    st = jnp.dtype(sweep_dtype) if sweep_dtype is not None else \
        jnp.result_type(ab0.dtype, jnp.complex64)
    m1 = tooth_krylov_m if krylov_m1 is None else krylov_m1
    with jax.default_matmul_precision(precision):
        return _tdvp_comb_sweeps(
            wb.astype(st), wt.astype(st), ab0, at0, t, int(nsteps),
            int(order), int(krylov_m), int(tooth_krylov_m), int(m1),
            st, bool(gemm2_apply), bool(reortho),
            int(expm_max_squarings))


def _tdvp_comb_sweeps(wb, wt, ab0, at0, t, nsteps, order, mB, mT, m1,
                      st, gemm2_apply, reortho, expm_max_squarings):
    Nb, chi, d, chit, _ = ab0.shape
    Mt = at0.shape[1]
    w = wb.shape[1]
    real_st = jnp.finfo(st).dtype

    ab = ab0.astype(st)
    at = at0.astype(st)

    def get(x, k):
        return jax.lax.dynamic_index_in_dim(x, k, keepdims=False)

    def put(x, k, v):
        return jax.lax.dynamic_update_index_in_dim(x, v, k, axis=0)

    # ---- initial gauge (teeth up, backbone right-to-left; per-core
    # renormalization is safe here — the state is unit-normalized at
    # node 0 afterward, same contract as tdvp_chain's initial gauge)
    def norm_site(A):
        mx = jnp.max(jnp.abs(A))
        A = A / jnp.where(mx > 0, mx, 1.0)
        n = jnp.sqrt(jnp.sum(jnp.abs(A) ** 2))
        return A / jnp.where(n > 0, n, 1.0).astype(st)

    def gauge_tooth(ab, at, k):
        tk = get(at, k)
        carry = None
        for j in range(Mt - 1, -1, -1):
            G = tk[j]
            if carry is not None:
                G = jnp.einsum("pia,ab->pib", G, carry)
            M = G.reshape(chit, d * chit)
            Q1, R1 = jnp.linalg.qr(jnp.conj(M).T)
            tk = tk.at[j].set(jnp.conj(Q1).T.reshape(chit, d, chit))
            carry = jnp.conj(R1).T
        node = jnp.einsum("aipb,pq->aiqb", get(ab, k), carry)
        return put(ab, k, norm_site(node)), put(at, k, tk)

    core_scale = jnp.max(jnp.abs(ab), axis=(1, 2, 3, 4), keepdims=True)
    ab = ab / jnp.where(core_scale > 0, core_scale, 1.0)
    if Mt > 0:
        t_scale = jnp.max(jnp.abs(at), axis=(2, 3, 4), keepdims=True)
        at = at / jnp.where(t_scale > 0, t_scale, 1.0)
        for k in range(Nb):
            ab, at = gauge_tooth(ab, at, k)

    def gauge_backbone(ab):
        def body(carry, k):
            ab = carry
            A = get(ab, k)
            M = A.reshape(chi, d * chit * chi)
            Q1, R1 = jnp.linalg.qr(jnp.conj(M).T)
            core = jnp.conj(Q1).T.reshape(chi, d, chit, chi)
            prev = jnp.einsum("aipb,bc->aipc", get(ab, k - 1),
                              jnp.conj(R1).T)
            return put(put(ab, k, core), k - 1, norm_site(prev)), None

        ab, _ = jax.lax.scan(body, ab, jnp.arange(Nb - 1, 0, -1))
        return ab

    ab = gauge_backbone(ab)
    n0 = jnp.sqrt(jnp.sum(jnp.abs(get(ab, 0)) ** 2))
    ab = put(ab, 0, get(ab, 0) / jnp.maximum(n0, 1e-300).astype(st))

    # ---- environments (identical index conventions to dmrg_comb)
    T_bound = jnp.zeros((chit, w, chit), st).at[0, 0, 0].set(1.0)
    L_bound = jnp.zeros((chi, w, chi), st).at[0, 0, 0].set(1.0)
    R_bound = jnp.zeros((chi, w, chi), st).at[0, 0, 0].set(1.0)

    def tooth_env_below_from(tk, wtk, j0):
        T = T_bound
        for j in range(Mt - 1, j0 - 1, -1):
            T = jnp.einsum("aip,uoid,pdP,xoP->aux", tk[j], wtk[j], T,
                           jnp.conj(tk[j]), optimize=True)
        return T

    def tooth_envs(at):
        def one(tk, wtk):
            return tooth_env_below_from(tk, wtk, 0)

        if Mt == 0:
            return jnp.broadcast_to(T_bound, (Nb, chit, w, chit))
        return jax.vmap(one)(at, wt)

    def update_left_env(L, A, Wk, Tk):
        return jnp.einsum("alx,aipb,ltoir,ptP,xoPB->brB", L, A, Wk, Tk,
                          jnp.conj(A), optimize=True)

    def update_right_env(R, A, Wk, Tk):
        return jnp.einsum("brB,aipb,ltoir,ptP,xoPB->alx", R, A, Wk, Tk,
                          jnp.conj(A), optimize=True)

    def right_env_scan(ab, Ts):
        def body(R, k):
            Rn = update_right_env(R, get(ab, k), get(wb, k), get(Ts, k))
            return Rn, Rn

        _, Rs = jax.lax.scan(body, R_bound, jnp.arange(Nb - 1, 1, -1))
        Rs = jnp.flip(Rs, axis=0)
        return jnp.concatenate([Rs, R_bound[None]], axis=0)

    def left_env_scan(ab, Ts):
        """Ls[k] = env of nodes 0..k-1 (left of node k)."""
        def body(L, k):
            Ln = update_left_env(L, get(ab, k), get(wb, k), get(Ts, k))
            return Ln, L

        _, Ls = jax.lax.scan(body, L_bound, jnp.arange(Nb))
        return Ls

    # ---- Krylov exp propagator (the chain engine's unrolled form)
    def lanczos_expm(apply_h, v0, coeff, m):
        sdt = real_st
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
            hv = apply_h(v)
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
            next_alive = alive * (b > eps10 * jnp.maximum(
                1.0, jnp.abs(a))).astype(sdt)
            betas.append(b * next_alive if i + 1 < m
                         else jnp.zeros((), sdt))
            v_prev, v = v, v_next
            beta_prev = b * alive
            alive = next_alive
        basis = jnp.stack(basis)
        alphas = jnp.stack(alphas)
        betas = jnp.stack(betas)
        amask = jnp.stack(amask)
        if jnp.issubdtype(st, jnp.complexfloating):
            c = jnp.asarray(coeff, jnp.result_type(real_st,
                                                   jnp.complex64))
        else:
            c = jnp.real(jnp.asarray(coeff, real_st))
        coef = _expm_tridiag_e0(alphas.astype(real_st),
                                betas.astype(real_st), c,
                                max_squarings=expm_max_squarings)
        coef = coef * amask
        out = jnp.einsum("m,m...->...", coef.astype(st), basis)
        return out * n0.astype(st)

    # ---- splits (exact re-factorization; comb-equilibrated subspace QR)
    def eq_cols(Y):
        cn = jnp.sqrt(jnp.sum(jnp.abs(Y) ** 2, axis=0, keepdims=True))
        return Y / jnp.where(cn > 0, cn, 1.0).astype(Y.dtype)

    def split_mat(mat, Q0):
        Q = _colnorm_qr(mat @ eq_cols(jnp.conj(mat).T @ Q0))
        Q = _colnorm_qr(mat @ eq_cols(jnp.conj(mat).T @ Q))
        return Q, jnp.conj(Q).T @ mat

    # ---- H-apply closures
    def apply_backbone2(L, Wk, Wk1, Tk, Tk1, R):
        if gemm2_apply:
            LWT = jnp.einsum("alx,ltoir,ptP->aipxoPr", L, Wk, Tk,
                             optimize=True)
            WTR = jnp.einsum("ruyjs,quQ,bsB->rjqbyQB", Wk1, Tk1, R,
                             optimize=True)

            def f(th):
                t1 = jnp.einsum("aipxoPr,aipjqb->xoPrjqb", LWT, th)
                return jnp.einsum("xoPrjqb,rjqbyQB->xoPyQB", t1, WTR)
            return f

        def f(th):
            return jnp.einsum(
                "alx,ltoir,ptP,ruyjs,quQ,bsB,aipjqb->xoPyQB",
                L, Wk, Tk, Wk1, Tk1, R, th, optimize=True)
        return f

    def apply_node1(L, Wk, Tk, R):
        def f(A):
            return jnp.einsum("alx,ltoir,ptP,brB,aipb->xoPB",
                              L, Wk, Tk, R, A, optimize=True)
        return f

    def apply_root2(L, R, Wk, wtk0, D1):
        def f(th):
            return jnp.einsum("alx,ltoir,tvjf,qfQ,brB,aijqb->xovQB",
                              L, Wk, wtk0, D1, R, th, optimize=True)
        return f

    def apply_tooth2(U, Wa, Wb_, D):
        def f(th):
            return jnp.einsum("aux,uoif,fvjg,qgQ,aijq->xovQ",
                              U, Wa, Wb_, D, th, optimize=True)
        return f

    def apply_tooth1(U, Wa, D):
        def f(A):
            return jnp.einsum("ptP,toif,qfQ,piq->PoQ", U, Wa, D, A,
                              optimize=True)
        return f

    # ---- the tooth dive with TDVP visits (delta = the pass's D; tooth
    # visits advance delta/2 — see module docstring)
    def dive(ab, at, L, Rk, k, delta, last_of_step):
        node = get(ab, k)
        tk = get(at, k)
        wtk = get(wt, k)
        Wk = get(wb, k)
        dT = delta / 2.0
        Ds = [T_bound]
        for j in range(Mt - 1, -1, -1):
            Ds.append(jnp.einsum("aip,uoid,pdP,xoP->aux", tk[j],
                                 wtk[j], Ds[-1], jnp.conj(tk[j]),
                                 optimize=True))
        Ds = Ds[::-1]  # Ds[j] = env of tooth sites j..

        # root edge, down: theta [a,i,j,q,b]
        theta0 = jnp.einsum("aipb,pjq->aijqb", node, tk[0])
        theta = lanczos_expm(apply_root2(L, Rk, Wk, wtk[0], Ds[1]),
                             theta0, dT, mT)
        mat = jnp.transpose(theta, (0, 1, 4, 2, 3)).reshape(
            chi * d * chi, d * chit)
        Q0 = jnp.transpose(node, (0, 1, 3, 2)).reshape(
            chi * d * chi, chit)
        Q, rest = split_mat(mat, Q0)
        node = jnp.transpose(Q.reshape(chi, d, chi, chit), (0, 1, 3, 2))
        t_center = rest.reshape(chit, d, chit)
        U = jnp.einsum("alx,aipb,ltoir,brB,xoPB->ptP", L, node, Wk, Rk,
                       jnp.conj(node), optimize=True)
        Us = [U]
        tk = tk.at[0].set(t_center)
        if Mt > 1:
            # rewind the new center to its lower partner's time
            tk = tk.at[0].set(lanczos_expm(
                apply_tooth1(Us[0], wtk[0], Ds[1]), tk[0], -dT, m1))

        # descend
        for j in range(Mt - 1):
            thj = jnp.einsum("aip,pjq->aijq", tk[j], tk[j + 1])
            theta = lanczos_expm(
                apply_tooth2(Us[j], wtk[j], wtk[j + 1], Ds[j + 2]),
                thj, dT, mT)
            mat = theta.reshape(chit * d, d * chit)
            Q, rest = split_mat(mat, tk[j].reshape(chit * d, chit))
            tk = tk.at[j].set(Q.reshape(chit, d, chit))
            tk = tk.at[j + 1].set(rest.reshape(chit, d, chit))
            Us.append(jnp.einsum("aux,uoif,aip,xoP->pfP", Us[j],
                                 wtk[j], tk[j], jnp.conj(tk[j]),
                                 optimize=True))
            if j < Mt - 2:  # bottom turn gets no correction
                tk = tk.at[j + 1].set(lanczos_expm(
                    apply_tooth1(Us[j + 1], wtk[j + 1], Ds[j + 2]),
                    tk[j + 1], -dT, m1))

        # ascend
        for j in range(Mt - 2, -1, -1):
            thj = jnp.einsum("aip,pjq->aijq", tk[j], tk[j + 1])
            D_next = tooth_env_below_from(tk, wtk, j + 2)
            theta = lanczos_expm(
                apply_tooth2(Us[j], wtk[j], wtk[j + 1], D_next),
                thj, dT, mT)
            mat = theta.reshape(chit * d, d * chit)
            Qt, restT = split_mat(
                jnp.conj(mat).T,
                jnp.conj(tk[j + 1].reshape(chit, d * chit)).T)
            tk = tk.at[j + 1].set(jnp.conj(Qt).T.reshape(chit, d, chit))
            tk = tk.at[j].set(jnp.conj(restT).T.reshape(chit, d, chit))
            D_j1 = tooth_env_below_from(tk, wtk, j + 1)
            tk = tk.at[j].set(lanczos_expm(
                apply_tooth1(Us[j], wtk[j], D_j1), tk[j], -dT, m1))

        # root edge, up
        D1 = tooth_env_below_from(tk, wtk, 1)
        theta0 = jnp.einsum("aipb,pjq->aijqb", node, tk[0])
        theta = lanczos_expm(apply_root2(L, Rk, Wk, wtk[0], D1),
                             theta0, dT, mT)
        mat = jnp.transpose(theta, (0, 1, 4, 2, 3)).reshape(
            chi * d * chi, d * chit)
        Qt, restT = split_mat(jnp.conj(mat).T,
                              jnp.conj(tk[0].reshape(chit,
                                                     d * chit)).T)
        tk = tk.at[0].set(jnp.conj(Qt).T.reshape(chit, d, chit))
        node = jnp.transpose(
            jnp.conj(restT).T.reshape(chi, d, chi, chit), (0, 1, 3, 2))

        # post-dive correction at the node (-delta: a backbone-type
        # region follows), except at the very end of the step
        Tk_new = tooth_env_below_from(tk, wtk, 0)
        c = jnp.where(last_of_step, 0.0 * delta, -delta)
        node = lanczos_expm(apply_node1(L, Wk, Tk_new, Rk), node, c, m1)
        return put(ab, k, node), put(at, k, tk), Tk_new

    def refresh_tooth_env(Ts, at, k):
        return put(Ts, k, tooth_env_below_from(get(at, k), get(wt, k),
                                               0))

    # ---- passes
    def pass_fwd(ab, at, delta):
        """Pass P: [D_0, b_0, D_1, ..., b_{Nb-2}, D_{Nb-1}]. Ends with
        the center at node Nb-1."""
        Ts = tooth_envs(at)
        Rs = right_env_scan(ab, Ts)

        def body(carry, x):
            k, Rk = x
            ab, at, Ts, L = carry
            Rk_node = update_right_env(Rk, get(ab, k + 1),
                                       get(wb, k + 1), get(Ts, k + 1))
            if Mt > 0:
                # arrival correction (chain's post-split backward step,
                # deferred to the arrival; none at k = 0 where the pass
                # starts)
                node = get(ab, k)
                c = jnp.where(k > 0, -delta, 0.0 * delta)
                node = lanczos_expm(
                    apply_node1(L, get(wb, k), get(Ts, k), Rk_node),
                    node, c, m1)
                ab = put(ab, k, node)
                ab, at, Tk_new = dive(ab, at, L, Rk_node, k, delta,
                                      jnp.asarray(False))
                Ts = put(Ts, k, Tk_new)
            else:
                node = get(ab, k)
                c = jnp.where(k > 0, -delta, 0.0 * delta)
                node = lanczos_expm(
                    apply_node1(L, get(wb, k), get(Ts, k), Rk_node),
                    node, c, m1)
                ab = put(ab, k, node)
            # backbone edge (k, k+1), +delta
            A, B = get(ab, k), get(ab, k + 1)
            theta0 = jnp.einsum("aipc,cjqb->aipjqb", A, B)
            theta = lanczos_expm(
                apply_backbone2(L, get(wb, k), get(wb, k + 1),
                                get(Ts, k), get(Ts, k + 1), Rk),
                theta0, delta, mB)
            mat = theta.reshape(chi * d * chit, d * chit * chi)
            Q, rest = split_mat(mat, A.reshape(chi * d * chit, chi))
            left = Q.reshape(chi, d, chit, chi)
            right = rest.reshape(chi, d, chit, chi)
            ab = put(put(ab, k, left), k + 1, right)
            L_next = update_left_env(L, left, get(wb, k), get(Ts, k))
            return (ab, at, Ts, L_next), L

        (ab, at, Ts, L_last), Ls = jax.lax.scan(
            body, (ab, at, Ts, L_bound), (jnp.arange(Nb - 1), Rs))

        if Mt > 0:
            # arrival correction at node Nb-1, then the end-of-pass
            # dive. The dive's closing node correction is ALWAYS
            # skipped here: nothing follows it within the pass — for
            # order 2 the next region is the reverse pass's dive at the
            # same node (the turn: consecutive same-edge visits get no
            # correction), for order 1 this is the end of the step.
            node = get(ab, Nb - 1)
            node = lanczos_expm(
                apply_node1(L_last, get(wb, Nb - 1), get(Ts, Nb - 1),
                            R_bound), node, -delta, m1)
            ab = put(ab, Nb - 1, node)
            ab, at, _ = dive(ab, at, L_last, R_bound, Nb - 1, delta,
                             jnp.asarray(True))
        return ab, at, Ls, L_last

    def pass_bwd(ab, at, delta, Ls, L_last):
        """reverse(P): [D_{Nb-1}, b_{Nb-2}, D_{Nb-2}, ..., b_0, D_0].
        Starts with the center at node Nb-1 (the end of pass P); the
        D_{Nb-1} here is the second of the two consecutive pass-boundary
        dives (no correction in between — the turn)."""
        Ts = tooth_envs(at)
        if Mt > 0:
            ab, at, Tk_new = dive(ab, at, L_last, R_bound, Nb - 1,
                                  delta, jnp.asarray(False))
            Ts = put(Ts, Nb - 1, Tk_new)

        def body(carry, x):
            k, Lk = x
            ab, at, Ts, R = carry
            # backbone edge (k, k+1), +delta, center -> k
            A, B = get(ab, k), get(ab, k + 1)
            theta0 = jnp.einsum("aipc,cjqb->aipjqb", A, B)
            theta = lanczos_expm(
                apply_backbone2(Lk, get(wb, k), get(wb, k + 1),
                                get(Ts, k), get(Ts, k + 1), R),
                theta0, delta, mB)
            mat = theta.reshape(chi * d * chit, d * chit * chi)
            Qt, restT = split_mat(
                jnp.conj(mat).T,
                jnp.conj(B.reshape(chi, d * chit * chi)).T)
            right = jnp.conj(Qt).T.reshape(chi, d, chit, chi)
            left = jnp.conj(restT).T.reshape(chi, d, chit, chi)
            ab = put(put(ab, k, left), k + 1, right)
            R_next = update_right_env(R, right, get(wb, k + 1),
                                      get(Ts, k + 1))
            if Mt > 0:
                # arrival correction at node k (-delta; a dive follows,
                # even at k = 0), then the dive; the dive's own closing
                # correction is skipped at k = 0 (end of step)
                node = lanczos_expm(
                    apply_node1(Lk, get(wb, k), get(Ts, k), R_next),
                    get(ab, k), -delta, m1)
                ab = put(ab, k, node)
                ab, at, Tk_new = dive(ab, at, Lk, R_next, k, delta,
                                      k == 0)
                Ts = put(Ts, k, Tk_new)
            else:
                # chain scheme: -delta at the new center except k = 0
                c = jnp.where(k > 0, -delta, 0.0 * delta)
                node = lanczos_expm(
                    apply_node1(Lk, get(wb, k), get(Ts, k), R_next),
                    get(ab, k), c, m1)
                ab = put(ab, k, node)
            return (ab, at, Ts, R_next), None

        ks = jnp.arange(Nb - 2, -1, -1)
        (ab, at, _, _), _ = jax.lax.scan(
            body, (ab, at, Ts, R_bound), (ks, Ls[ks]))
        return ab, at

    coeff_dtype = (jnp.complex128
                   if jnp.issubdtype(st, jnp.complexfloating)
                   else jnp.float64)
    dt = jnp.asarray(t, coeff_dtype) / nsteps
    delta = dt / 2.0 if order == 2 else dt

    def one_step(_, state):
        ab, at = state
        if order == 2:
            ab, at, Ls, L_last = pass_fwd(ab, at, delta)
            ab, at = pass_bwd(ab, at, delta, Ls, L_last)
        else:
            ab, at, _, _ = pass_fwd(ab, at, delta)
            # forward-only Lie splitting leaves the backbone
            # left-canonical; re-gauge (exact) for the next step's
            # right environments. Teeth end every dive up-gauged.
            def regauge(carry, k):
                ab = carry
                A = get(ab, k)
                M = A.reshape(chi, d * chit * chi)
                Q1, R1 = jnp.linalg.qr(jnp.conj(M).T)
                core = jnp.conj(Q1).T.reshape(chi, d, chit, chi)
                prev = jnp.einsum("aipb,bc->aipc", get(ab, k - 1),
                                  jnp.conj(R1).T)
                return put(put(ab, k, core), k - 1, prev), None

            ab, _ = jax.lax.scan(regauge, ab,
                                 jnp.arange(Nb - 1, 0, -1))
        return ab, at

    ab, at = jax.lax.fori_loop(0, nsteps, one_step, (ab, at))
    return ab, at


# ---------------------------------------------------------------------------
# analytic FLOP model (mirrors the executed sweep work; the VERDICT r1
# contract that MFU is measured on the REAL engine, never a synthetic
# kernel — see ops.dmrg_comb.dmrg_comb_sweep_flops)
# ---------------------------------------------------------------------------

def tdvp_comb_sweep_flops(Nb: int, Mt: int, chi: int, chit: int,
                          d: int, w: int, nsteps: int,
                          order: int = 2,
                          krylov_m: int = 12,
                          tooth_krylov_m: int = 8,
                          krylov_m1: int | None = None,
                          gemm2_apply: bool = False,
                          reortho: bool = True) -> float:
    """FLOPs of ``tdvp_comb_run``'s step loop (gauge prologue excluded,
    as in the chain/DMRG models). Every einsum is costed with
    opt_einsum on the engine's exact expressions and shapes; GEMM/QR
    split terms use the standard 2mnk / 2pq^2 counts. Propagators with
    a zero coefficient (turn/end corrections) still EXECUTE in the
    traced program, so they are counted.

    The knob parameters MUST mirror the ``tdvp_comb_run`` call being
    measured (ADVICE r2 contract)."""
    import numpy as np
    import opt_einsum as oe

    def ec(expr, shapes):
        _, info = oe.contract_path(
            expr, *[np.empty(s, np.float32) for s in shapes])
        return float(info.opt_cost)

    mB, mT = krylov_m, tooth_krylov_m
    m1 = mT if krylov_m1 is None else krylov_m1
    C, T, D = chi, chit, d
    LW = (C, w, C)       # backbone env
    TE = (T, w, T)       # tooth env
    AB = (C, D, T, C)    # backbone core
    AT = (T, D, T)       # tooth core
    WB = (w, w, D, D, w)
    WT = (w, D, D, w)
    THB = (C, D, T, D, T, C)   # backbone two-site theta
    THR = (C, D, D, T, C)      # root-edge theta
    THT = (T, D, D, T)         # tooth-edge theta

    tooth_env_step = ec("aip,uoid,pdP,xoP->aux", [AT, WT, TE, AT])
    up_env = ec("alx,aipb,ltoir,brB,xoPB->ptP", [LW, AB, WB, LW, AB])
    us_step = ec("aux,uoif,aip,xoP->pfP", [TE, WT, AT, AT])
    left_env = ec("alx,aipb,ltoir,ptP,xoPB->brB", [LW, AB, WB, TE, AB])
    right_env = ec("brB,aipb,ltoir,ptP,xoPB->alx", [LW, AB, WB, TE, AB])

    thb = float(np.prod(THB))
    thr = float(np.prod(THR))
    tht = float(np.prod(THT))
    node_sz = float(np.prod(AB))
    t1_sz = float(np.prod(AT))

    if gemm2_apply:
        pre = (ec("alx,ltoir,ptP->aipxoPr", [LW, WB, TE])
               + ec("ruyjs,quQ,bsB->rjqbyQB", [WB, TE, LW]))
        LWT = (C, D, T, C, D, T, w)
        WTR = (w, D, T, C, D, T, C)
        apply_b = (ec("aipxoPr,aipjqb->xoPrjqb", [LWT, THB])
                   + ec("xoPrjqb,rjqbyQB->xoPyQB",
                        [(C, D, T, w, D, T, C), WTR]))
    else:
        pre = 0.0
        apply_b = ec("alx,ltoir,ptP,ruyjs,quQ,bsB,aipjqb->xoPyQB",
                     [LW, WB, TE, WB, TE, LW, THB])
    apply_r = ec("alx,ltoir,tvjf,qfQ,brB,aijqb->xovQB",
                 [LW, WB, WT, TE, LW, THR])
    apply_t = ec("aux,uoif,fvjg,qgQ,aijq->xovQ",
                 [TE, WT, WT, TE, THT])
    apply_n1 = ec("alx,ltoir,ptP,brB,aipb->xoPB",
                  [LW, WB, TE, LW, AB])
    apply_t1 = ec("ptP,toif,qfQ,piq->PoQ", [TE, WT, TE, AT])

    def lan(m, apply_f, tsize):
        ro = 4 * m * tsize if reortho else 0
        return m * (apply_f + 8 * tsize + ro) + 2 * tsize

    def split(P, cols, keep):
        # split_mat: 2 warm-started subspace iterations (2 GEMMs +
        # one (P, keep) QR each) + the final rest GEMM
        per = 2 * (2.0 * P * cols * keep) + 2.0 * P * keep ** 2
        return 2 * per + 2.0 * P * cols * keep

    # backbone-edge visit (theta build, propagator, split); the
    # backward pass's transposed split has identical sizes
    theta0_b = 2.0 * C * (D * T) * (D * T) * C
    backbone = (theta0_b + pre + lan(mB, apply_b, thb)
                + split(C * D * T, D * T * C, C))

    # node arrival/closing corrections (always executed)
    corr_n = lan(m1, apply_n1, node_sz)
    corr_t = lan(m1, apply_t1, t1_sz)

    theta0_r = 2.0 * C * D * C * T * (D * T)
    theta0_t = 2.0 * T * D * T * (D * T)

    dive = 0.0
    if Mt > 0:
        # Ds stack
        dive += Mt * tooth_env_step
        # root edge down (+ rewind when Mt > 1)
        dive += theta0_r + lan(mT, apply_r, thr) + split(C * D * C,
                                                         D * T, T)
        dive += up_env
        if Mt > 1:
            dive += corr_t
        # descend
        dive += (Mt - 1) * (theta0_t + lan(mT, apply_t, tht)
                            + split(T * D, D * T, T) + us_step)
        dive += max(Mt - 2, 0) * corr_t
        # ascend: D_next/D_j1 env recomputes sum to triangular counts
        dive += (Mt - 1) * (theta0_t + lan(mT, apply_t, tht)
                            + split(D * T, T * D, T) + corr_t)
        dive += ((Mt - 2) * (Mt - 1) / 2 + (Mt - 1) * Mt / 2) \
            * tooth_env_step
        # root edge up (transposed split) + Tk_new + closing correction
        dive += (Mt - 1) * tooth_env_step
        dive += theta0_r + lan(mT, apply_r, thr) + split(D * T,
                                                         C * D * C, T)
        dive += Mt * tooth_env_step + corr_n

    # pass P (forward): tooth envs, right-env scan, per-edge work, the
    # end-of-pass arrival + dive
    pass_fwd = (Nb * Mt * tooth_env_step
                + max(Nb - 2, 0) * right_env
                + (Nb - 1) * (right_env + corr_n + dive + backbone
                              + left_env)
                + corr_n + dive)
    # reverse pass: tooth envs, leading dive, per-edge work (uses the
    # stored Ls — no left-env updates)
    pass_bwd = (Nb * Mt * tooth_env_step
                + dive
                + (Nb - 1) * (backbone + right_env + corr_n + dive))
    if Mt == 0:
        # chain reduction: no dives; corrections still run per edge
        pass_fwd = (max(Nb - 2, 0) * right_env
                    + (Nb - 1) * (right_env + corr_n + backbone
                                  + left_env))
        pass_bwd = (Nb - 1) * (backbone + right_env + corr_n)

    if order == 2:
        per_step = pass_fwd + pass_bwd
    else:
        # Lie: forward pass + exact backbone re-gauge QRs
        per_step = pass_fwd + (Nb - 1) * (
            2.0 * (D * T * C) * C ** 2 + 2.0 * C * (D * T * C) * C)
    return nsteps * per_step
