"""Real/imag-split TDVP engine tests (ops.tdvp_chain_split): real-time
evolution with NO complex dtypes anywhere (VERDICT r1 #9 — the path that
runs on backends that lack complex kernels)."""

import jax
import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
from scipy.linalg import expm

from tensor4all_tpu.models.spin import dense_heisenberg, heisenberg
from tensor4all_tpu.ops.dmrg_chain import treeoperator_to_mpo_cores
from tensor4all_tpu.ops.tdvp_chain_split import (
    _corth_qr,
    tdvp_chain_split,
)
from tensor4all_tpu.treetn.network import random_treetn


def _chain_fixture(N, chi_init=2, seed=0):
    g = nx.path_graph(N)
    tn, si = random_treetn(jax.random.PRNGKey(seed), g,
                           {n: [2] for n in g.nodes}, bond_dim=chi_init)
    sites = {n: si[n][0] for n in g.nodes}
    op = heisenberg(g, sites)
    h_cores = treeoperator_to_mpo_cores(op, list(range(N)))
    cores = []
    for k in range(N):
        t = tn.tensor(k)
        axes = ([tn.bond(k - 1, k)] if k else []) + [sites[k]] \
            + ([tn.bond(k, k + 1)] if k < N - 1 else [])
        arr = np.asarray(t.dense(tuple(axes)))
        if k == 0:
            arr = arr[None]
        if k == N - 1:
            arr = arr[..., None]
        cores.append(arr)
    H = np.asarray(dense_heisenberg(g, list(range(N))))
    return h_cores, cores, H


def _vec(mr, mi):
    m = np.asarray(mr) + 1j * np.asarray(mi)
    acc = m[0][0]
    for k in range(1, len(m)):
        acc = np.einsum("...a,aib->...ib", acc, m[k])
    return acc[..., 0].reshape(-1)


def test_corth_qr_properties(rng):
    """Frame-MGS orthonormalization: orthonormal output, exact span,
    completion of dead slots, robust to graded/degenerate spectra."""
    Y0 = rng.standard_normal((16, 6)) + 1j * rng.standard_normal((16, 6))
    U, s, Vh = np.linalg.svd(Y0, full_matrices=False)
    cases = {
        "generic": Y0,
        "graded": (U * (s * np.array([1, 1, 1e-2, 1e-5, 1e-8, 1e-11]))) @ Vh,
        "degenerate": (U * np.array([1, 1, 1, .5, .5, .5])) @ Vh,
        "rank2": (U[:, :2] * s[:2]) @ Vh[:2],
    }
    for label, Y in cases.items():
        qr_, qi_ = _corth_qr(jnp.asarray(Y.real), jnp.asarray(Y.imag))
        Q = np.asarray(qr_) + 1j * np.asarray(qi_)
        orth = np.max(np.abs(Q.conj().T @ Q - np.eye(Y.shape[1])))
        assert orth < 1e-10, (label, orth)
        # significant directions of Y lie in span(Q)
        k = int((np.linalg.svd(Y, compute_uv=False)
                 > 1e-6 * np.abs(Y).max()).sum())
        Uk = np.linalg.svd(Y, full_matrices=False)[0][:, :k]
        P = Q @ Q.conj().T
        assert np.max(np.abs(Uk - P @ Uk)) < 1e-5, label


def test_split_tdvp_matches_dense_f64():
    """Real-time evolution vs dense expm — f64 parity with the complex
    engine (the 'done' criterion: matches the CPU complex path at the
    1e-5 L2 accuracy contract, here far below)."""
    h_cores, cores, H = _chain_fixture(6)
    T = 0.3
    mr, mi = tdvp_chain_split(h_cores, cores, -1j * T, chi=8, nsteps=6,
                              order=2, krylov_m=12, dtype=jnp.float64)
    got = _vec(mr, mi)
    acc = cores[0][0]
    for c in cores[1:]:
        acc = np.einsum("...a,aib->...ib", acc, c)
    psi0 = acc.reshape(-1)
    psi0 = psi0 / np.linalg.norm(psi0)
    expect = expm(-1j * T * H) @ psi0
    ph = np.vdot(got, expect)
    got = got * ph / abs(ph)
    assert np.linalg.norm(got - expect) < 5e-6


def test_split_tdvp_f32_contract():
    """f32 (the fast dtype) stays within the reference accuracy contract
    scale (TDVP L2 ~1.4e-5 at dt=0.02; ref BASELINE.md)."""
    h_cores, cores, H = _chain_fixture(6)
    T = 0.3
    mr, mi = tdvp_chain_split(h_cores, cores, -1j * T, chi=8, nsteps=6,
                              order=2, krylov_m=12, dtype=jnp.float32)
    got = _vec(mr, mi)
    acc = cores[0][0]
    for c in cores[1:]:
        acc = np.einsum("...a,aib->...ib", acc, c)
    psi0 = acc.reshape(-1)
    psi0 = psi0 / np.linalg.norm(psi0)
    expect = expm(-1j * T * H) @ psi0
    ph = np.vdot(got, expect)
    got = got * ph / abs(ph)
    assert np.linalg.norm(got - expect) < 3e-4


def test_split_tdvp_imag_time_matches_complex_engine():
    """Imaginary-time parity: the split engine's trajectory matches the
    complex engine's with identical parameters."""
    from tensor4all_tpu.ops.tdvp_chain import tdvp_chain

    h_cores, cores, H = _chain_fixture(5)
    mr, mi = tdvp_chain_split(h_cores, cores, -2.5, chi=8, nsteps=10,
                              order=2, krylov_m=12, dtype=jnp.float64)
    got = _vec(mr, mi)
    got = got / np.linalg.norm(got)
    out = np.asarray(tdvp_chain(h_cores, cores, -2.5, chi=8, nsteps=10,
                                order=2, krylov_m=12))
    acc = out[0][0]
    for k in range(1, len(out)):
        acc = np.einsum("...a,aib->...ib", acc, out[k])
    ref = acc[..., 0].reshape(-1)
    ref = ref / np.linalg.norm(ref)
    ph = np.vdot(got, ref)
    got = got * ph / abs(ph)
    assert np.linalg.norm(got - np.real(ref)
                          .astype(complex)) < 1e-6 or \
        np.linalg.norm(got - ref) < 1e-6


def test_split_tdvp_karatsuba_and_cholqr_knobs():
    """r4 speed knobs hold the trajectory contract: Karatsuba 3-GEMM
    complex multiplies and the pair-CholeskyQR splits must reproduce
    the default engine's dense-expm parity (these knobs back the
    production bench rows).

    karatsuba composes with rank GROWTH (bond-2 start, chi=8);
    cholqr_split is projector-completing by contract (dead columns stay
    zero — _pair_cholqr docstring), so its variants run on a FULL-RANK
    start, the production bench regime. A growth start under
    cholqr_split measurably under-evolves (6e-2 here) — that is the
    documented semantics, not an accuracy bug."""
    for chi_init, knob_list in (
        (2, [dict(karatsuba=True)]),
        (8, [dict(cholqr_split=True),
             dict(karatsuba=True, cholqr_split=True)]),
    ):
        h_cores, cores, H = _chain_fixture(6, chi_init=chi_init)
        T = 0.3
        acc = cores[0][0]
        for c in cores[1:]:
            acc = np.einsum("...a,aib->...ib", acc, c)
        psi0 = acc.reshape(-1)
        psi0 = psi0 / np.linalg.norm(psi0)
        expect = expm(-1j * T * H) @ psi0
        for knobs in knob_list:
            mr, mi = tdvp_chain_split(h_cores, cores, -1j * T, chi=8,
                                      nsteps=6, order=2, krylov_m=12,
                                      dtype=jnp.float64, **knobs)
            got = _vec(mr, mi)
            ph = np.vdot(got, expect)
            got = got * ph / abs(ph)
            assert np.linalg.norm(got - expect) < 5e-6, knobs


def test_split_tdvp_split_orth_modes():
    """The cheap inner-conditioner modes (split_orth='eq'/'stacked':
    one corth per subspace iteration — the production latency knobs)
    must hold the dense-expm trajectory contract, both on a rank-growth
    start and on a full-rank start with the full production knob
    stack."""
    for chi_init, knobs in (
        (2, dict(split_orth="eq")),
        (2, dict(split_orth="stacked")),
        (2, dict(split_orth="cholqr1")),
        (8, dict(split_orth="eq", karatsuba=True, reortho=False,
                 complete_basis=False, split_iters=1)),
        (8, dict(split_orth="stacked", karatsuba=True, reortho=False,
                 complete_basis=False, split_iters=1)),
        # the production knob (bench _sec_tdvp_rt): one-pass pair-
        # CholeskyQR inner conditioning
        (8, dict(split_orth="cholqr1", karatsuba=True, reortho=False,
                 complete_basis=False, split_iters=1)),
        # polar needs split_iters=2: its Gram pass loses sigma_rel <
        # sqrt(eps) directions and the second subspace iteration must
        # recover them (documented negative result, see tdvp_run_split)
        (8, dict(split_orth="polar", karatsuba=True, reortho=False,
                 complete_basis=False, split_iters=2)),
    ):
        h_cores, cores, H = _chain_fixture(6, chi_init=chi_init)
        T = 0.3
        acc = cores[0][0]
        for c in cores[1:]:
            acc = np.einsum("...a,aib->...ib", acc, c)
        psi0 = acc.reshape(-1)
        psi0 = psi0 / np.linalg.norm(psi0)
        expect = expm(-1j * T * H) @ psi0
        mr, mi = tdvp_chain_split(h_cores, cores, -1j * T, chi=8,
                                  nsteps=6, order=2, krylov_m=12,
                                  dtype=jnp.float64, **knobs)
        got = _vec(mr, mi)
        ph = np.vdot(got, expect)
        got = got * ph / abs(ph)
        # polar's Gram blind spot leaves it a touch above the others
        # even with the si=2 recovery (7.6e-6 measured — the documented
        # negative result); eq/stacked hold the 5e-6 grade
        bound = 2e-5 if knobs.get("split_orth") == "polar" else 5e-6
        assert np.linalg.norm(got - expect) < bound, (chi_init, knobs)


def test_split_orth_polar_requires_incomplete_basis():
    """polar has no junk completion (dead columns are fixed points of
    the NS iteration): the engine must refuse the rank-growth contract
    instead of silently rank-locking."""
    h_cores, cores, _ = _chain_fixture(4, chi_init=2)
    import pytest as _pytest
    with _pytest.raises(ValueError, match="complete_basis"):
        tdvp_chain_split(h_cores, cores, -0.1j, chi=4, nsteps=1,
                         split_orth="polar")
