"""Jitted COMB-tree TDVP engine tests (ops.tdvp_comb).

The comb TDVP engine is the time-evolution counterpart of the comb
DMRG engine; these tests pin its trajectory contract against dense
``expm`` on small combs, on every code path: real and imaginary time,
tooth depths Mt = 0..2, order 1 and 2, gemm2 applies, f32 sweeps.

The full-rank tests are the strong validator of the Euler-tour time
accounting (module docstring of ops/tdvp_comb.py): when chi/chit cover
every exact Schmidt rank, the splitting factors telescope and the
integrator must reproduce dense ``expm`` to roundoff — any wrong
backward-correction coefficient shows up at O(dt) >> 1e-8.

Reference parity: tensor4all-treetn/src/tdvp/mod.rs:1101 (trajectory
contract), tdvp/plan.rs:1-379 (tree region plans).
"""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.linalg import expm

from tensor4all_tpu.models.spin import dense_heisenberg
from tensor4all_tpu.ops.dmrg_comb import (
    comb_graph,
    comb_heisenberg_stacks,
    random_comb_state,
)
from tensor4all_tpu.ops.tdvp_comb import tdvp_comb_run


def dense_h(Nb, Mt):
    g = comb_graph(Nb, Mt)
    return np.asarray(dense_heisenberg(g, list(g.nodes)))


def densify_comb(ab, at, Nb, Mt):
    """Contract the padded comb stacks to the dense state vector in
    `comb_graph` node order (b_k, t_{k,0}, ..., t_{k,Mt-1}, b_{k+1},
    ...). Boundary bonds slice their live slot 0."""
    ab = np.asarray(ab)
    at = np.asarray(at)
    chit = ab.shape[3]
    C = np.ones((1, 1))  # (prefix, bond)
    for k in range(Nb):
        A = ab[k]
        if k == 0:
            A = A[:1]
        if k == Nb - 1:
            A = A[..., :1]
        if Mt == 0:
            T = np.zeros((chit,))
            T[0] = 1.0
            B = np.einsum("lipr,p->lir", A, T)
            B = B.reshape(A.shape[0], 2, A.shape[-1])
        else:
            T = at[k, 0]  # (chit, d, chit)
            for j in range(1, Mt):
                T = np.einsum("p...q,qsr->p...sr", T, at[k, j])
            T = T[..., 0]  # live bottom slot
            B = np.einsum("lipr,p...->li...r", A, T)
        pref = C.shape[0]
        out = np.tensordot(C, B, axes=(1, 0))  # (pref, d, ..., bond)
        C = out.reshape(pref * 2 ** (1 + Mt), B.shape[-1])
    return C[:, 0]


def start_state(key, Nb, Mt, chi, chit, dense_hmat):
    wb, wt = comb_heisenberg_stacks(Nb, Mt)
    ab0, at0 = random_comb_state(key, Nb, Mt, chi, chit)
    psi0 = densify_comb(ab0, at0, Nb, Mt)
    psi0 = psi0 / np.linalg.norm(psi0)
    return wb, wt, ab0, at0, psi0


@pytest.mark.parametrize("Nb,Mt,chi,chit", [
    (3, 1, 8, 2),
    (2, 2, 8, 4),
])
def test_tdvp_comb_real_time_full_rank(key, Nb, Mt, chi, chit):
    """Full padded rank: the Euler-tour splitting telescopes and must
    match dense expm to roundoff (the time-accounting validator)."""
    H = dense_h(Nb, Mt)
    wb, wt, ab0, at0, psi0 = start_state(key, Nb, Mt, chi, chit, H)
    T = 0.08
    ab, at = tdvp_comb_run(wb, wt, ab0.astype(jnp.complex128),
                           at0.astype(jnp.complex128), -1j * T,
                           nsteps=4, order=2)
    got = densify_comb(ab, at, Nb, Mt)
    expect = expm(-1j * T * H) @ psi0
    # densify starts from the engine's own normalized initial state
    assert np.linalg.norm(got - expect) < 1e-8
    assert abs(np.linalg.norm(got) - 1.0) < 1e-10


def test_tdvp_comb_order1_full_rank_exact(key):
    H = dense_h(3, 1)
    wb, wt, ab0, at0, psi0 = start_state(key, 3, 1, 8, 2, H)
    T = 0.04
    ab, at = tdvp_comb_run(wb, wt, ab0.astype(jnp.complex128),
                           at0.astype(jnp.complex128), -1j * T,
                           nsteps=4, order=1)
    got = densify_comb(ab, at, 3, 1)
    expect = expm(-1j * T * H) @ psi0
    assert np.linalg.norm(got - expect) < 1e-8


def test_tdvp_comb_truncating_projection(key):
    """chit below the exact tooth rank: the projected trajectory stays
    close to the exact one at short times (PS projection error)."""
    H = dense_h(2, 2)
    wb, wt, ab0, at0, psi0 = start_state(key, 2, 2, 8, 2, H)
    T = 0.05
    ab, at = tdvp_comb_run(wb, wt, ab0.astype(jnp.complex128),
                           at0.astype(jnp.complex128), -1j * T,
                           nsteps=4, order=2)
    got = densify_comb(ab, at, 2, 2)
    expect = expm(-1j * T * H) @ psi0
    # a random chit=2 state grows tooth rank past 2 immediately; the
    # tangent-space projection discards that growth at every visit —
    # measured ~1.2e-2 here, an order above the full-rank roundoff and
    # two orders below an unprojected/broken integrator
    assert np.linalg.norm(got - expect) < 3e-2
    # truncating splits shed the discarded weight from the norm
    assert abs(np.linalg.norm(got) - 1.0) < 1e-3


def test_tdvp_comb_mt0_matches_dense(key):
    """Mt = 0 reduces to the chain scheme."""
    H = dense_h(5, 0)
    wb, wt, ab0, at0, psi0 = start_state(key, 5, 0, 8, 1, H)
    T = 0.08
    ab, at = tdvp_comb_run(wb, wt, ab0.astype(jnp.complex128),
                           at0.astype(jnp.complex128), -1j * T,
                           nsteps=4, order=2)
    got = densify_comb(ab, at, 5, 0)
    expect = expm(-1j * T * H) @ psi0
    assert np.linalg.norm(got - expect) < 1e-8


def test_tdvp_comb_imaginary_time_real_dtype(key):
    """Real f64 sweeps (the real-arithmetic path): imaginary time
    matches the dense direction."""
    H = dense_h(3, 1)
    wb, wt, ab0, at0, psi0 = start_state(key, 3, 1, 8, 2, H)
    tau = 0.3
    ab, at = tdvp_comb_run(wb, wt, ab0, at0, -tau, nsteps=4, order=2,
                           sweep_dtype=jnp.float64)
    got = densify_comb(ab, at, 3, 1)
    expect = expm(-tau * H) @ psi0
    dev = np.linalg.norm(got / np.linalg.norm(got)
                         - expect / np.linalg.norm(expect))
    assert dev < 1e-6


def test_tdvp_comb_gemm2_and_f32(key):
    """gemm2 applies + f32 sweeps: same trajectory at f32 grade."""
    H = dense_h(3, 1)
    wb, wt, ab0, at0, psi0 = start_state(key, 3, 1, 8, 2, H)
    tau = 0.2
    ab, at = tdvp_comb_run(wb, wt, ab0, at0, -tau, nsteps=2, order=2,
                           sweep_dtype=jnp.float32, gemm2_apply=True,
                           reortho=False)
    assert bool(jnp.isfinite(ab).all() & jnp.isfinite(at).all())
    got = densify_comb(ab, at, 3, 1)
    expect = expm(-tau * H) @ psi0
    dev = np.linalg.norm(got / np.linalg.norm(got)
                         - expect / np.linalg.norm(expect))
    assert dev < 1e-4


def test_tdvp_comb_flop_model_sanity():
    """The analytic FLOP model tracks the engine's executed work: the
    Mt=0 chain reduction prices within 10% of the chain engine's own
    model (the engines differ in per-edge correction/refresh structure,
    so exact agreement is not expected), scales superlinearly in chi,
    and grows with teeth."""
    from tensor4all_tpu.ops.tdvp_chain import tdvp_sweep_flops
    from tensor4all_tpu.ops.tdvp_comb import tdvp_comb_sweep_flops

    a = tdvp_comb_sweep_flops(32, 0, 128, 1, 2, 5, 2, order=2,
                              krylov_m=12, krylov_m1=8,
                              gemm2_apply=True, reortho=False)
    b = tdvp_sweep_flops(32, 128, 2, 5, 12, 2, order=2, reortho=False,
                         gemm2_apply=True, krylov_m1=8)
    assert abs(a - b) / b < 0.10, (a, b)

    f1 = tdvp_comb_sweep_flops(8, 2, 64, 4, 2, 5, 2)
    f2 = tdvp_comb_sweep_flops(8, 2, 128, 4, 2, 5, 2)
    assert f2 > 3.0 * f1  # two-site work is ~chi^3
    f3 = tdvp_comb_sweep_flops(8, 3, 64, 4, 2, 5, 2)
    assert f3 > f1
    # order 1 is roughly half an order-2 step
    f4 = tdvp_comb_sweep_flops(8, 2, 64, 4, 2, 5, 2, order=1)
    assert 0.3 * f1 < f4 < 0.8 * f1
