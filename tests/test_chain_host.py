"""Host-numpy chain engines (ops.tdvp_chain_host): accuracy vs dense
oracles — the CPU-backend siblings of the jitted device engines."""

import numpy as np
import pytest
from scipy.linalg import expm

from tensor4all_tpu.ops.tdvp_chain_host import (
    dmrg_chain_host, tdvp_chain_host,
)


def _setup(N, chi, seed=0):
    import jax

    import networkx as nx
    from tensor4all_tpu.models.spin import heisenberg
    from tensor4all_tpu.ops.dmrg_chain import treeoperator_to_mpo_cores
    from tensor4all_tpu.treetn.network import random_treetn
    from tensor4all_tpu.tt.tensortrain import TensorTrain

    g = nx.path_graph(N)
    _, si = random_treetn(jax.random.PRNGKey(seed), g,
                          {n: [2] for n in g.nodes}, bond_dim=2)
    op = heisenberg(g, {n: si[n][0] for n in g.nodes})
    h_cores = treeoperator_to_mpo_cores(op, list(g.nodes))
    H = np.asarray(op.to_dense_matrix(order=list(g.nodes)))
    tt = TensorTrain.random(jax.random.PRNGKey(seed + 1), [2] * N,
                            rank=chi)
    cores0 = [np.asarray(c) for c in tt.cores]
    # dense |psi0> after right-orthogonalization + normalization
    from tensor4all_tpu.ops.tdvp_chain_host import _right_orthogonalize
    A = _right_orthogonalize([c.astype(complex) for c in cores0])
    A[0] = A[0] / np.linalg.norm(A[0])
    v = A[0]
    for c in A[1:]:
        v = np.tensordot(v, c, axes=([-1], [0]))
    return h_cores, cores0, H, v.reshape(-1)


def _densify(cores):
    v = cores[0]
    for c in cores[1:]:
        v = np.tensordot(v, c, axes=([-1], [0]))
    return v.reshape(-1)


def test_tdvp_host_real_time():
    N = 8
    h_cores, cores0, H, psi0 = _setup(N, 32)
    T = 0.08
    out = tdvp_chain_host(h_cores, cores0, -1j * T, 32, nsteps=4,
                          order=2)
    expect = expm(-1j * T * H) @ psi0
    assert np.linalg.norm(_densify(out) - expect) < 1e-10
    # ranks stayed adaptive (no blind padding)
    assert max(c.shape[0] for c in out) <= 16


def test_tdvp_host_order1():
    N = 6
    h_cores, cores0, H, psi0 = _setup(N, 16)
    T = 0.02
    expect = expm(-1j * T * H) @ psi0
    errs = []
    for nsteps in (4, 8):
        out = tdvp_chain_host(h_cores, cores0, -1j * T, 16,
                              nsteps=nsteps, order=1)
        errs.append(np.linalg.norm(_densify(out) - expect))
    assert max(errs) < 1e-10   # chi >= full rank: exact up to roundoff


def test_tdvp_host_imaginary_time():
    N = 8
    h_cores, cores0, H, psi0 = _setup(N, 32)
    tau = 0.3
    out = tdvp_chain_host(h_cores, cores0, -tau, 32, nsteps=4, order=2)
    got = _densify(out)
    expect = expm(-tau * H) @ psi0
    dev = np.linalg.norm(got / np.linalg.norm(got)
                         - expect / np.linalg.norm(expect))
    assert dev < 1e-10


def test_dmrg_host_ground_state():
    N = 8
    h_cores, cores0, H, _ = _setup(N, 32)
    e, A, energies = dmrg_chain_host(h_cores, cores0, 32, n_sweeps=4)
    assert len(energies) == 4
    e_exact = np.linalg.eigvalsh(H)[0]
    assert abs(e - e_exact) < 1e-10
    v = _densify(A)
    v = v / np.linalg.norm(v)
    assert abs(abs(v.conj() @ H @ v) - abs(e_exact)) < 1e-9
