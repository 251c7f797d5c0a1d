"""Fully-jitted two-site DMRG engine for STAR topologies (hub + K
leaves) — the reference's flagship tree benchmark shape
(ref tensor4all-treetn benchmarks, results/2026-06-27-treetn-dmrg-
itensornetworks.md: DMRG on the hub star is its headline tree result).

The framework path (`treetn/dmrg.py`) wins the star row through
TT-factorized dressed cores, but still pays one host dispatch per local
operation — hundreds of sub-millisecond ops per sweep. Here the ENTIRE
multi-sweep run is ONE XLA program, the `ops.dmrg_chain` design applied
to the star:

- every leaf bond has dimension d (a single-site leg's Schmidt rank is
  bounded by its site dimension), so the hub core is a STATIC
  (d, d, ..., d) tensor with K+1 axes and nothing is padded or dynamic;
- the Hamiltonian is given per edge in factorized two-site form
  ``H_k = sum_a A[k,a] (x) B[k,a]`` (plus a pure-hub field), so the
  projected H_eff applies through per-leaf (R, d, d) environments
  ``E[j,a] = leaf_j B[j,a] leaf_j^H`` — the 5^K dressed MPO center that
  the generic path must avoid factorizing is never formed at all;
- each edge solve is a fixed-m Lanczos with the GEMM-only
  Sturm-bisection ground pair (`_tridiag_ground`), and the exact
  (bond = d, no truncation) split keeps the canonical center at the
  hub via one tiny SVD.

Scope: single-site legs (the benchmark shape) natively, and chain legs
of length L >= 2 by the exact dressed-leaf reduction
(`star_chain_legs_terms`): each leg is coarse-grained into ONE
composite leaf of dimension d**L (site 1 = hub-adjacent is the leading
kron factor), intra-leg couplings fold into a leaf onsite term, and the
engine runs unchanged with hub dimension d and leaf dimension d**L.
The two-site (hub, composite-leaf) update with the exact d**L split
bond spans everything a fine-grained per-edge sweep over the leg
spans, so parity vs dense ED is exact, not variational-approximate.

Backend note: this is a LATENCY-bound engine for tiny tensors (the
K=7 benchmark state is 256 elements) — run it on the CPU backend,
where the whole multi-sweep program executes in ~15 ms. Dispatching a
256-element problem to an accelerator buys nothing; large-chi work
belongs to ops/dmrg_chain.py, which is the accelerator path.
"""

from __future__ import annotations

import string
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .dmrg_chain import _tridiag_ground

_BOND_LETTERS = string.ascii_lowercase


def _edge_einsum_specs(K: int):
    """Static einsum strings for each edge k of a K-leaf star.

    Hub axes: 's' (site) then one bond letter per leaf. theta for edge k
    replaces bond letter k with the leaf site letter 't'.
    """
    bonds = _BOND_LETTERS[:K]
    specs = []
    for k in range(K):
        hub_sub = "s" + bonds
        theta_sub = "s" + bonds[:k] + "t" + bonds[k + 1:]
        # hub (x) leaf_k over bond k:  hub[s,..b_k..], leaf[b_k, t]
        contract = f"{hub_sub},{bonds[k]}t->{theta_sub}"
        # direct two-site term: A on s, B on t
        direct = f"xs,yt,{theta_sub}->" + theta_sub.replace("s", "x") \
            .replace("t", "y")
        # environment term on leg j != k: A on s, E_j on bond j
        envs = []
        for j in range(K):
            if j == k:
                envs.append("")
                continue
            out = theta_sub.replace("s", "x").replace(bonds[j], "y")
            envs.append(f"xs,y{bonds[j]},{theta_sub}->{out}")
        # hub field
        field = f"xs,{theta_sub}->" + theta_sub.replace("s", "x")
        # split: merge all non-t axes
        specs.append((contract, direct, envs, field, theta_sub))
    return specs


def star_pair_terms(
    pass_ops: Sequence[np.ndarray],
    complete_ops: Sequence[np.ndarray],
    K: int,
    onsite_hub: np.ndarray | None = None,
    onsite_leaf: np.ndarray | None = None,
    dtype=jnp.float64,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Build the engine's (A, B, h_hub) from the `tree_nn_operator`
    spec (models/spin.py:33): per edge,
    ``H_k = sum_a complete_ops[a](hub) (x) pass_ops[a](leaf)``, leaf
    onsite fields folded in as an extra (I_hub, h_leaf) term so every
    term lives on some edge and the projected H_eff stays a plain sum.
    """
    d = np.asarray(pass_ops[0]).shape[0]
    terms_A = [np.asarray(c, np.float64) for c in complete_ops]
    terms_B = [np.asarray(p, np.float64) for p in pass_ops]
    if onsite_leaf is not None:
        terms_A.append(np.eye(d))
        terms_B.append(np.asarray(onsite_leaf, np.float64))
    A = jnp.asarray(np.broadcast_to(np.stack(terms_A),
                                    (K, len(terms_A), d, d)), dtype)
    B = jnp.asarray(np.broadcast_to(np.stack(terms_B),
                                    (K, len(terms_B), d, d)), dtype)
    h_hub = jnp.asarray(
        np.zeros((d, d)) if onsite_hub is None
        else np.asarray(onsite_hub, np.float64), dtype)
    return A, B, h_hub


def star_chain_legs_terms(
    pass_ops: Sequence[np.ndarray],
    complete_ops: Sequence[np.ndarray],
    K: int,
    L: int,
    onsite_hub: np.ndarray | None = None,
    onsite_leaf: np.ndarray | None = None,
    dtype=jnp.float64,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Dressed-leaf reduction of a star with K chain legs of length L
    to the engine's (A, B, h_hub) format (ref: the reference's general
    tree region plans, tensor4all-treetn/src/tdvp/plan.rs:1-379, cover
    this family; here the legs are coarse-grained exactly instead).

    Each leg becomes one composite leaf of dimension ``d**L`` with
    site 1 (hub-adjacent) as the LEADING kron factor. Per edge k:

    - hub-leg coupling:  ``A_a = complete_ops[a]`` on the hub,
      ``B_a = pass_ops[a] (x) I**(L-1)`` on the composite leaf
      (parent side carries the coefficients, matching
      models.spin.tree_nn_operator's parent/child convention);
    - intra-leg couplings ``sum_j sum_a I**(j-1) (x) complete_a (x)
      pass_a (x) I**(L-j-1)`` and per-site leaf fields fold into ONE
      extra term ``(I_hub, h_leaf_comp)``;
    - ``onsite_hub`` stays the pure-hub field.

    Valid for modest L (the composite dimension is d**L); the engines'
    exact split keeps the hub-leaf bond at d**L so the reduction loses
    nothing variationally.
    """
    if L < 1:
        raise ValueError("leg length L must be >= 1")
    if L == 1:
        return star_pair_terms(pass_ops, complete_ops, K,
                               onsite_hub=onsite_hub,
                               onsite_leaf=onsite_leaf, dtype=dtype)
    d = np.asarray(pass_ops[0]).shape[0]
    D = d ** L
    eyeD = {j: np.eye(d ** j) for j in range(L + 1)}

    def at(j, op, span=1):
        """kron(I**j, op, I**(L - j - span)) on the composite leaf."""
        return np.kron(np.kron(eyeD[j], op), eyeD[L - j - span])

    terms_A = [np.asarray(c, np.float64) for c in complete_ops]
    terms_B = [np.kron(np.asarray(p, np.float64), eyeD[L - 1])
               for p in pass_ops]

    h_leaf = np.zeros((D, D))
    for j in range(L - 1):
        for p, c in zip(pass_ops, complete_ops):
            h_leaf += at(j, np.kron(np.asarray(c, np.float64),
                                    np.asarray(p, np.float64)), span=2)
    if onsite_leaf is not None:
        f = np.asarray(onsite_leaf, np.float64)
        for j in range(L):
            h_leaf += at(j, f)
    if np.abs(h_leaf).max() > 0:
        terms_A.append(np.eye(d))
        terms_B.append(h_leaf)

    R = len(terms_A)
    A = jnp.asarray(np.broadcast_to(np.stack(terms_A), (K, R, d, d)),
                    dtype)
    B = jnp.asarray(np.broadcast_to(np.stack(terms_B), (K, R, D, D)),
                    dtype)
    h_hub = jnp.asarray(
        np.zeros((d, d)) if onsite_hub is None
        else np.asarray(onsite_hub, np.float64), dtype)
    return A, B, h_hub


def unfold_composite_leaf(leaf: np.ndarray, d: int, L: int):
    """Split a converged composite leaf (bond, d**L) back into L chain
    cores [(bond, d, r1), (r1, d, r2), ..., (r_{L-1}, d, 1)] by exact
    sequential SVD (site 1 = hub-adjacent = leading kron factor). For
    users who want the fine-grained TreeTN state back."""
    leaf = np.asarray(leaf)
    bond = leaf.shape[0]
    cores = []
    mat = leaf.reshape(bond, d ** L)
    left = bond
    for j in range(L - 1):
        rest = d ** (L - j - 1)
        m2 = mat.reshape(left * d, rest)
        U, s, Vh = np.linalg.svd(m2, full_matrices=False)
        r = int(np.sum(s > 1e-14 * max(s[0], 1e-300)))
        cores.append(U[:, :r].reshape(left, d, r))
        mat = (s[:r, None] * Vh[:r])
        left = r
    cores.append(mat.reshape(left, d, 1))
    return cores


def dmrg_star_run(
    A: jnp.ndarray,
    B: jnp.ndarray,
    h_hub: jnp.ndarray,
    hub0: jnp.ndarray,
    leaves0: jnp.ndarray,
    n_sweeps: int = 4,
    lanczos_iters: int = 12,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Ground state of ``sum_k sum_a A[k,a] (x) B[k,a] + h_hub`` on a
    K-leaf star. Returns (energy, hub, leaves).

    Args:
      A, B: (K, R, d, d) hub-side / leaf-side factors per edge term.
      h_hub: (d, d) pure-hub field.
      hub0: (d,) + (d,) * K initial hub core (site axis first).
      leaves0: (K, d, d) initial leaf cores as (bond, site).

    The whole run (gauge + environments + all sweeps + final energy) is
    one jitted program; edges are unrolled (K is static and small), the
    Lanczos is a fori_loop.
    """
    return _dmrg_star_jit(A, B, h_hub, hub0, leaves0,
                          int(n_sweeps), int(lanczos_iters))


def _star_engine(A, B, h_hub, hub0, leaves0, n_sweeps, m):
    K = A.shape[0]
    R = A.shape[1]
    d = A.shape[2]
    dt = A.dtype
    specs = _edge_einsum_specs(K)

    def norm_of(x):
        return jnp.sqrt(jnp.sum(jnp.abs(x) ** 2).astype(jnp.float64))

    # gauge: orthonormalize each leaf's rows (bond toward hub), absorb
    # the factor into the hub bond
    def gauge(hub, leaves):
        new_leaves = []
        for k in range(K):
            Lk = leaves[k]  # (bond, site)
            U, S, Vh = jnp.linalg.svd(Lk, full_matrices=False)
            new_leaves.append(Vh)  # orthonormal rows
            M = U * S[None, :]  # (bond_old, bond_new)
            bonds = _BOND_LETTERS[:K]
            sub = "s" + bonds
            out = sub.replace(bonds[k], "z")
            hub = jnp.einsum(f"{sub},{bonds[k]}z->{out}", hub, M)
        hub = hub / jnp.maximum(norm_of(hub), 1e-300).astype(dt)
        return hub, jnp.stack(new_leaves)

    def envs_of(leaves):
        # E[k, a] = leaf_k B[k,a] leaf_k^H   (bond', bond)
        return jnp.einsum("kbs,kast,kct->kabc", leaves, B,
                          jnp.conj(leaves))

    def solve_edge(k, hub, leaves, E):
        contract, direct, env_specs, field, theta_sub = specs[k]
        theta0 = jnp.einsum(contract, hub, leaves[k])

        def apply_h(th):
            # one einsum per term GROUP (the R factor axis contracts in
            # the same product — 4x fewer ops than per-term einsums,
            # which matters at these tiny sizes where per-op overhead
            # dominates)
            y = jnp.einsum(field, h_hub, th)
            y = y + jnp.einsum("r" + direct.replace(",", ",r", 1),
                               A[k], B[k], th)
            for j in range(K):
                if j == k:
                    continue
                y = y + jnp.einsum(
                    "r" + env_specs[j].replace(",", ",r", 1),
                    A[j], E[j], th)
            return y

        # fixed-m Lanczos with full reorthogonalization (tiny state)
        v0 = theta0 / jnp.maximum(norm_of(theta0), 1e-300).astype(dt)
        basis = jnp.zeros((m,) + v0.shape, dt)
        alphas = jnp.zeros((m,), jnp.float64)
        betas = jnp.zeros((m,), jnp.float64)
        amask = jnp.zeros((m,), jnp.float64)

        def body(i, carry):
            basis, alphas, betas, amask, v, v_prev, b_prev, alive = carry
            basis = basis.at[i].set(v * alive.astype(dt))
            hv = apply_h(v)
            a_ = jnp.real(jnp.sum(jnp.conj(v) * hv))
            hv = hv - a_.astype(dt) * v - b_prev.astype(dt) * v_prev
            ov = jnp.einsum("m...,...->m", jnp.conj(basis), hv)
            mask = (jnp.arange(m) <= i).astype(dt)
            hv = hv - jnp.einsum("m,m...->...", ov * mask, basis)
            b = norm_of(hv)
            v_next = hv / jnp.maximum(b, 1e-300).astype(dt)
            alphas = alphas.at[i].set(
                jnp.where(alive > 0, a_.astype(jnp.float64), 0.0))
            amask = amask.at[i].set(alive)
            eps = jnp.asarray(10 * jnp.finfo(dt).eps, jnp.float64)
            next_alive = alive * (b > eps * jnp.maximum(
                1.0, jnp.abs(a_).astype(jnp.float64)))
            betas = betas.at[i].set(b * (i + 1 < m) * next_alive)
            return (basis, alphas, betas, amask, v_next, v,
                    b * alive, next_alive)

        carry = (basis, alphas, betas, amask, v0, jnp.zeros_like(v0),
                 jnp.float64(0.0), jnp.float64(1.0))
        basis, alphas, betas, amask, _, _, _, _ = jax.lax.fori_loop(
            0, m, body, carry)
        big = jnp.where(amask > 0, alphas, -jnp.inf).max()
        small = jnp.where(amask > 0, alphas, jnp.inf).min()
        pad = big + (big - small) + 4.0 * jnp.abs(betas).max() + 1.0
        diag = jnp.where(amask > 0, alphas, pad)
        e0, coef = _tridiag_ground(diag, betas)
        theta = jnp.einsum("m,m...->...", coef.astype(dt), basis)
        theta = theta / jnp.maximum(norm_of(theta), 1e-300).astype(dt)

        # exact split (bond = leaf dim): theta[(rest), t] = M; M = U S
        # Vh, leaf = Vh (orthonormal rows), hub slots = U S. The leaf
        # site dimension is read off theta (it differs from the hub's
        # under the chain-leg reduction, where leaves are composite
        # d**L sites — star_chain_legs_terms).
        perm = theta_sub.index("t")
        dl = theta.shape[perm]
        th_mat = jnp.moveaxis(theta, perm, -1).reshape(-1, dl)
        U, S, Vh = jnp.linalg.svd(th_mat, full_matrices=False)
        leaf_new = Vh  # (d_bond, d_site)
        hub_new = (U * S[None, :]).reshape(
            theta.shape[:perm] + theta.shape[perm + 1:] + (dl,))
        # axis order: put the new bond back at position k+1 of the hub
        hub_new = jnp.moveaxis(hub_new, -1, perm)
        leaves = leaves.at[k].set(leaf_new)
        E_new = jnp.einsum("bs,ast,ct->abc", leaf_new, B[k],
                           jnp.conj(leaf_new))
        return e0, hub_new, leaves, E_new

    def run(hub, leaves):
        hub, leaves = gauge(hub, leaves)
        E = envs_of(leaves)

        def one_sweep(_, state):
            hub, leaves, E, energy = state
            for k in range(K):
                e0, hub, leaves, E_k = solve_edge(k, hub, leaves, E)
                E = E.at[k].set(E_k)
                energy = e0
            return hub, leaves, E, energy

        hub, leaves, E, energy = jax.lax.fori_loop(
            0, n_sweeps, one_sweep,
            (hub, leaves, E, jnp.float64(0.0)))
        return energy, hub, leaves

    return run(hub0.astype(dt), leaves0.astype(dt))


_dmrg_star_jit = jax.jit(_star_engine, static_argnames=("n_sweeps", "m"))


def dmrg_star_heisenberg(K: int, J: float = 1.0, h: float = 0.0,
                         n_sweeps: int = 4, lanczos_iters: int = 12,
                         seed: int = 0, dtype=jnp.float64):
    """Convenience driver: Heisenberg on a K-leaf star from a random
    product-ish start (the journal benchmark shape). Returns
    (energy, hub, leaves)."""
    from ..models.spin import SM, SP, SZ

    A, B, h_hub = star_pair_terms(
        pass_ops=[SZ, SP, SM],
        complete_ops=[J * SZ, (J / 2) * SM, (J / 2) * SP],
        K=K,
        onsite_hub=(h * SZ if h else None),
        onsite_leaf=(h * SZ if h else None),
        dtype=dtype,
    )
    rng = np.random.default_rng(seed)
    d = 2
    hub0 = jnp.asarray(rng.standard_normal((d,) * (K + 1)), dtype)
    leaves0 = jnp.asarray(rng.standard_normal((K, d, d)), dtype)
    return dmrg_star_run(A, B, h_hub, hub0, leaves0,
                         n_sweeps=n_sweeps, lanczos_iters=lanczos_iters)


def dmrg_star_heisenberg_legs(K: int, L: int, J: float = 1.0,
                              h: float = 0.0, n_sweeps: int = 4,
                              lanczos_iters: int = 12, seed: int = 0,
                              dtype=jnp.float64):
    """Heisenberg ground state on a star with K chain legs of length L
    via the dressed-leaf reduction. Returns (energy, hub, leaves) with
    composite (K, d**L, d**L) leaves — `unfold_composite_leaf` recovers
    the fine-grained leg cores."""
    from ..models.spin import SM, SP, SZ

    A, B, h_hub = star_chain_legs_terms(
        pass_ops=[SZ, SP, SM],
        complete_ops=[J * SZ, (J / 2) * SM, (J / 2) * SP],
        K=K, L=L,
        onsite_hub=(h * SZ if h else None),
        onsite_leaf=(h * SZ if h else None),
        dtype=dtype,
    )
    rng = np.random.default_rng(seed)
    d, D = 2, 2 ** L
    hub0 = jnp.asarray(rng.standard_normal((d,) + (D,) * K), dtype)
    leaves0 = jnp.asarray(rng.standard_normal((K, D, D)), dtype)
    return dmrg_star_run(A, B, h_hub, hub0, leaves0,
                         n_sweeps=n_sweeps, lanczos_iters=lanczos_iters)


def star_terms_from_dense(H: np.ndarray, K: int, d: int = 2,
                          tol: float = 1e-10, dtype=jnp.float64):
    """Extract the engine's ``(A, B, h_hub)`` from a DENSE star-local
    Hamiltonian (site order: hub first, then leaves 1..K).

    Hilbert-Schmidt orthogonal projection onto an orthonormal per-site
    operator basis {B_i} (B_0 = I/sqrt(d), the rest traceless): any
    star-local H decomposes UNIQUELY as

        H = c0 I + f_hub + sum_k f_k + sum_k sum_ij g[k,i,j] B_i (x) B_j

    Leaf fields and the scalar fold into edge terms (I (x) f_k and
    (c0/K) I (x) I) so the engine sees per-edge (A, B) stacks plus the
    pure-hub field — its exact input format. Raises if H carries any
    leaf-leaf or >2-site component (not star-local), and verifies the
    reconstruction bit-for-bit, so TreeOperator integration cannot
    silently mis-solve.
    """
    N = K + 1
    D = d ** N
    H = np.asarray(H, np.float64)
    if H.shape != (D, D):
        raise ValueError(f"H must be {D}x{D} for a {K}-leaf star of "
                         f"d={d} sites")

    # orthonormal real basis of d x d under <X,Y> = Tr(X^T Y):
    # identity/sqrt(d), diagonal-traceless, symmetric and antisymmetric
    # off-diagonal pairs
    basis = [np.eye(d) / np.sqrt(d)]
    for i in range(d - 1):
        v = np.zeros(d)
        v[: i + 1] = 1.0
        v[i + 1] = -(i + 1)
        basis.append(np.diag(v) / np.linalg.norm(v))
    for i in range(d):
        for j in range(i + 1, d):
            Bm = np.zeros((d, d))
            Bm[i, j] = Bm[j, i] = 1.0 / np.sqrt(2)
            basis.append(Bm)
            Bm = np.zeros((d, d))
            Bm[i, j] = 1.0 / np.sqrt(2)
            Bm[j, i] = -1.0 / np.sqrt(2)
            basis.append(Bm)
    stack = np.stack(basis)  # (d^2, d, d)

    # coefficient tensor c[i0..iK] = <(x)_s B_{i_s}, H>_HS
    coef = H.reshape([d] * N + [d] * N)
    for site in range(N):
        n_rem = N - site
        # out axis of the current site at `site`, its in axis n_rem later
        coef = np.tensordot(stack, coef,
                            axes=([1, 2], [site, site + n_rem]))
        coef = np.moveaxis(coef, 0, site)

    idx = np.argwhere(np.abs(coef) > tol * max(1.0, np.abs(coef).max()))
    A_terms = [[] for _ in range(K)]
    B_terms = [[] for _ in range(K)]
    h_hub = np.zeros((d, d))
    c_iden = 0.0
    for ix in idx:
        nz = [s for s in range(N) if ix[s] != 0]
        c = float(coef[tuple(ix)])
        if len(nz) == 0:
            c_iden = c * d ** (-N / 2)  # scalar shift of H
        elif len(nz) == 1:
            s = nz[0]
            op_ = c * basis[ix[s]] * d ** (-(N - 1) / 2)
            if s == 0:
                h_hub += op_
            else:
                A_terms[s - 1].append(np.eye(d))
                B_terms[s - 1].append(op_)
        elif len(nz) == 2 and 0 in nz:
            s = [v for v in nz if v != 0][0]
            w = c * d ** (-(N - 2) / 2)
            A_terms[s - 1].append(w * basis[ix[0]])
            B_terms[s - 1].append(basis[ix[s]])
        else:
            raise ValueError(
                "H is not star-local: found a term on sites "
                f"{nz} (leaf-leaf or >2-site support)")
    if abs(c_iden) > tol:
        for k in range(K):
            A_terms[k].append((c_iden / K) * np.eye(d))
            B_terms[k].append(np.eye(d))
    R = max(max((len(a) for a in A_terms), default=1), 1)
    A = np.zeros((K, R, d, d))
    B = np.zeros((K, R, d, d))
    for k in range(K):
        for r, (a_, b_) in enumerate(zip(A_terms[k], B_terms[k])):
            A[k, r] = a_
            B[k, r] = b_

    # exactness check: reconstruct and compare
    def kron_at(ops):
        out = np.eye(1)
        for v in range(N):
            out = np.kron(out, ops.get(v, np.eye(d)))
        return out

    rec = kron_at({0: h_hub})
    for k in range(K):
        for r in range(R):
            rec = rec + kron_at({0: A[k, r], k + 1: B[k, r]})
    err = np.abs(rec - H).max()
    if err > 1e-8 * max(1.0, np.abs(H).max()):
        raise ValueError(f"star term extraction failed: {err:.2e}")
    return (jnp.asarray(A, dtype), jnp.asarray(B, dtype),
            jnp.asarray(h_hub, dtype))


def star_terms_from_treeoperator(op, hub, leaves, dtype=jnp.float64):
    """(A, B, h_hub) for the star engines from a library TreeOperator:
    densify (the star engines' domain is K <~ 12 where this is cheap —
    the hub core itself is d^(K+1)), then Hilbert-Schmidt-project onto
    star-local terms with an exactness assert (star_terms_from_dense).
    Site order: hub first, then `leaves` in engine leg order."""
    order = [hub] + list(leaves)
    H = np.asarray(op.to_dense_matrix(order=order))
    d = op.site_in[hub].dim
    return star_terms_from_dense(H, K=len(leaves), d=d, dtype=dtype)
