"""Jitted one-program chain linsolve engine tests (ops.linsolve_chain)."""

import jax
import jax.numpy as jnp
import networkx as nx
import numpy as np

from tensor4all_tpu.models.spin import dense_heisenberg, heisenberg
from tensor4all_tpu.ops.dmrg_chain import treeoperator_to_mpo_cores
from tensor4all_tpu.ops.linsolve_chain import linsolve_run, pad_mpo, pad_mps
from tensor4all_tpu.treetn.network import random_treetn
from tensor4all_tpu.tt.tensortrain import TensorTrain


def _setup(N, chi, chib, a1=0.05):
    g = nx.path_graph(N)
    _, si = random_treetn(jax.random.PRNGKey(0), g,
                          {n: [2] for n in g.nodes}, bond_dim=2)
    op = heisenberg(g, {n: si[n][0] for n in g.nodes})
    h = pad_mpo([jnp.asarray(c, jnp.float64)
                 for c in treeoperator_to_mpo_cores(op, list(range(N)))])
    bt = TensorTrain.random(jax.random.PRNGKey(1), [2] * N, rank=chib,
                            dtype=jnp.float64)
    b = pad_mps(list(bt.cores), chib)
    xt = TensorTrain.random(jax.random.PRNGKey(2), [2] * N, rank=chi,
                            dtype=jnp.float64)
    x0 = pad_mps(list(xt.cores), chi)
    H = np.asarray(dense_heisenberg(g, list(g.nodes)))
    bv = np.asarray(bt.full_tensor()).reshape(-1)
    return h, b, x0, H, bv


def _densify(x, N):
    arrs = [np.asarray(x[k]) for k in range(N)]
    cores = [arrs[0][:1]] + arrs[1:-1] + [arrs[-1][..., :1]]
    return np.asarray(TensorTrain(
        [jnp.asarray(c) for c in cores]).full_tensor()).reshape(-1)


def test_linsolve_chain_matches_dense_full_rank():
    """Full-rank chain: the sweep solver must hit the dense solution of
    (a0 + a1 H) x = b to solver precision."""
    N, chi, chib = 6, 8, 4
    a0, a1 = 1.0, 0.05
    h, b, x0, H, bv = _setup(N, chi, chib)
    rel, x = linsolve_run(h, b, x0, a0, a1, n_sweeps=3, minres_m=20)
    got = _densify(x, N)
    xv = np.linalg.solve(a0 * np.eye(2 ** N) + a1 * H, bv)
    assert np.linalg.norm(got - xv) / np.linalg.norm(xv) < 1e-10
    A = a0 * np.eye(2 ** N) + a1 * H
    assert np.linalg.norm(A @ got - bv) / np.linalg.norm(bv) < 1e-10


def test_linsolve_chain_indefinite_operator():
    """a0 + a1 H INDEFINITE (a1 large): MINRES (not CG) territory —
    still reaches the dense solution at full rank."""
    N, chi, chib = 6, 8, 4
    a0, a1 = 0.2, 1.0  # spectrum of H spans negative values: indefinite
    h, b, x0, H, bv = _setup(N, chi, chib)
    A = a0 * np.eye(2 ** N) + a1 * H
    assert np.linalg.eigvalsh(A)[0] < 0 < np.linalg.eigvalsh(A)[-1]
    rel, x = linsolve_run(h, b, x0, a0, a1, n_sweeps=6, minres_m=30)
    got = _densify(x, N)
    xv = np.linalg.solve(A, bv)
    assert np.linalg.norm(got - xv) / np.linalg.norm(xv) < 1e-8


def test_linsolve_chain_residual_decreases_truncating():
    """Truncating regime (chi below the exact solution rank): sweeps
    must monotonically-ish reduce the engine's own residual report, and
    the report must agree with an explicit dense residual."""
    N, chi, chib = 8, 8, 4
    a0, a1 = 1.0, 0.2
    h, b, x0, H, bv = _setup(N, chi, chib)
    rels = []
    for ns in (1, 2, 4):
        rel, x = linsolve_run(h, b, x0, a0, a1, n_sweeps=ns,
                              minres_m=16)
        rels.append(float(rel))
    assert rels[2] <= rels[0] + 1e-12, rels
    got = _densify(x, N)
    A = a0 * np.eye(2 ** N) + a1 * H
    true_rel = np.linalg.norm(A @ got - bv) / np.linalg.norm(bv)
    # the moment-expansion report loses ~half the digits to
    # cancellation; agreement at sqrt-eps grade is the contract
    assert abs(true_rel - rels[2]) < 1e-6 + 0.1 * true_rel, (
        true_rel, rels[2])


def test_linsolve_chain_extreme_rhs_scale():
    """Internal b-gauge with log-scale tracking: rhs cores scaled by
    1e30 PER CORE (||b|| ~ 1e180 — transfer scans overflow even f64
    without the gauge) must give the same solution as the unit-scale
    solve, times the scale. Regression for the f32 NaN found at
    N=32 production scale."""
    N, chi, chib = 6, 8, 4
    a0, a1 = 1.0, 0.05
    h, b, x0, H, bv = _setup(N, chi, chib)
    scale = 1e30
    xv = np.linalg.solve(a0 * np.eye(2 ** N) + a1 * H, bv)
    for s in (scale, 1.0 / scale):
        rel_s, x_s = linsolve_run(h, b * s, x0, a0, a1, n_sweeps=3,
                                  minres_m=20)
        assert np.isfinite(float(rel_s))
        assert bool(jnp.isfinite(x_s).all())
        # each returned core carries one s factor (scale fold is
        # per-core); compare in unit-scale space — the dense vector at
        # s**N itself overflows/underflows f64
        got = _densify(x_s / s, N)
        assert np.linalg.norm(got - xv) / np.linalg.norm(xv) < 1e-10, s
        # the rel report clamps to its ~sqrt(eps) measurement floor
        assert float(rel_s) < 1e-6, s


def test_linsolve_run_tol_certifies_and_stops():
    """Sweep-to-tolerance mode (linsolve_run_tol): the f64-certified
    residual must agree with an explicit dense residual, meet the
    requested tolerance at full rank, and the while_loop must use
    FEWER sweeps for a loose tolerance than a tight one."""
    from tensor4all_tpu.ops.linsolve_chain import linsolve_run_tol

    N, chi, chib = 6, 8, 4
    a0, a1 = 1.0, 0.05
    h, b, x0, H, bv = _setup(N, chi, chib)
    rel64, rel_est, x, used = linsolve_run_tol(
        h, b, x0, a0, a1, tol=1e-8, max_sweeps=10, minres_m=20)
    got = _densify(x, N)
    A = a0 * np.eye(2 ** N) + a1 * H
    true_rel = np.linalg.norm(A @ got - bv) / np.linalg.norm(bv)
    # the f64 moment certificate clamps at its ~sqrt(4 eps_f64) ~ 3e-8
    # cancellation floor: a report AT the floor means "at or below",
    # and the dense truth must indeed be at or below it
    assert float(rel64) <= 3.5e-8, float(rel64)
    assert true_rel <= float(rel64) + 1e-12, (true_rel, float(rel64))
    assert 1 <= int(used) <= 10

    rel64_loose, _, _, used_loose = linsolve_run_tol(
        h, b, x0, a0, a1, tol=1e-2, max_sweeps=10, minres_m=20)
    assert float(rel64_loose) <= 1e-2
    assert int(used_loose) <= int(used)


def test_linsolve_run_tol_f32_sweeps_f64_certificate():
    """The VERDICT r3 #5 ladder: f32 sweeps + f64 certification. The
    f32 estimator bottoms out at its ~sqrt(eps_f32) floor while the
    certificate keeps resolving; both must be finite and the state
    must actually solve the system at f32 grade."""
    from tensor4all_tpu.ops.linsolve_chain import linsolve_run_tol

    N, chi, chib = 6, 8, 4
    a0, a1 = 1.0, 0.05
    h, b, x0, H, bv = _setup(N, chi, chib)
    rel64, rel_est, x, used = linsolve_run_tol(
        h.astype(jnp.float32), b.astype(jnp.float32),
        x0.astype(jnp.float32), a0, a1, tol=1e-6, max_sweeps=10,
        minres_m=20, precision="highest")
    got = _densify(x.astype(jnp.float64), N)
    A = a0 * np.eye(2 ** N) + a1 * H
    true_rel = np.linalg.norm(A @ got - bv) / np.linalg.norm(bv)
    # certified report tracks the dense truth (not the f32 floor)
    assert float(rel64) < 3e-5, (float(rel64), true_rel)
    assert true_rel < 2 * float(rel64) + 1e-7, (true_rel, float(rel64))
    assert np.isfinite(float(rel_est))


def test_linsolve_certify_knob():
    """certify=False must return the SAME solution with an
    estimate-grade residual report: the estimate under-reports near
    its sqrt(eps) floor (that is why certify=True exists), so the
    contract is solution equality + a finite, positive estimate within
    the certified report's neighborhood on an unconverged solve."""
    N, chi, chib = 6, 8, 4
    a0, a1 = 1.0, 0.2
    h, b, x0, H, bv = _setup(N, chi, chib)
    # 1 sweep: residual well above both floors, estimate ~ certificate
    rel_c, x_c = linsolve_run(h, b, x0, a0, a1, n_sweeps=1,
                              minres_m=4, certify=True)
    rel_e, x_e = linsolve_run(h, b, x0, a0, a1, n_sweeps=1,
                              minres_m=4, certify=False)
    np.testing.assert_allclose(np.asarray(x_e), np.asarray(x_c),
                               rtol=0, atol=1e-13)
    assert np.isfinite(float(rel_e)) and float(rel_e) > 0
    assert abs(float(rel_e) - float(rel_c)) < 0.05 * float(rel_c) + 1e-8
