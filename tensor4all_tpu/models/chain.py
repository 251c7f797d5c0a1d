"""Open-chain spin Hamiltonians as plain MPO core lists (numpy only).

The chain engines (``ops.dmrg_chain``, ``ops.tdvp_chain``) take an MPO as
a list of ``(l, o, i, r)`` cores, which ``pad_mpo`` stacks. This module
builds those cores directly by the standard finite-state-machine
construction, without the tree-operator compiler of ``models.spin`` and
so without ``networkx``.

Auxiliary bond states: 0 = nothing placed yet, 1..K = one factor of a
two-site term placed on the left, K+1 = a term completed. The first core
is row 0 of the bulk core, the last one its column K+1.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

# spin-1/2 operators (same conventions as models.spin)
SZ = np.array([[0.5, 0.0], [0.0, -0.5]])
SP = np.array([[0.0, 1.0], [0.0, 0.0]])
SM = SP.T.copy()
ID2 = np.eye(2)
PAULI_X = np.array([[0.0, 1.0], [1.0, 0.0]])
PAULI_Z = np.diag([1.0, -1.0])


def nn_chain_mpo(N: int, left_ops: Sequence[np.ndarray],
                 right_ops: Sequence[np.ndarray],
                 onsite: np.ndarray | None = None) -> List[np.ndarray]:
    """Cores of ``sum_i sum_k left_k(i) right_k(i+1) + sum_i onsite(i)``.

    Returns N cores of shape ``(l, d, d, r)`` with ``l = 1`` on the first
    and ``r = 1`` on the last core, bond width ``K + 2`` in between.
    """
    if N < 2:
        raise ValueError(f"need N >= 2 sites, got {N}")
    K = len(left_ops)
    if len(right_ops) != K:
        raise ValueError("left_ops and right_ops differ in length")
    d = np.asarray(left_ops[0]).shape[0]
    w, done = K + 2, K + 1
    W = np.zeros((w, d, d, w))
    W[0, :, :, 0] = np.eye(d)
    W[done, :, :, done] = np.eye(d)
    for k in range(K):
        W[0, :, :, 1 + k] = left_ops[k]
        W[1 + k, :, :, done] = right_ops[k]
    if onsite is not None:
        W[0, :, :, done] = onsite
    return [W[0:1]] + [W] * (N - 2) + [W[:, :, :, done:done + 1]]


def heisenberg_chain_mpo(N: int, J: float = 1.0,
                         h: float = 0.0) -> List[np.ndarray]:
    """``J sum_i (Sz Sz + (S+ S- + S- S+)/2) + h sum_i Sz``, width 5."""
    return nn_chain_mpo(N, [SZ, SP, SM], [J * SZ, (J / 2) * SM, (J / 2) * SP],
                        h * SZ if h else None)


def tfi_chain_mpo(N: int, J: float = 1.0, h: float = 1.0) -> List[np.ndarray]:
    """Transverse-field Ising ``-J sum_i Z Z - h sum_i X`` (Pauli), width 3."""
    return nn_chain_mpo(N, [-J * PAULI_Z], [PAULI_Z], -h * PAULI_X)


def mpo_to_dense(cores: Sequence[np.ndarray]) -> np.ndarray:
    """Dense ``d^N x d^N`` matrix of an MPO core list (rows = outputs)."""
    out = np.asarray(cores[0])[0]  # (o, i, r)
    for c in cores[1:]:
        c = np.asarray(c)
        o, i, _ = out.shape
        out = np.einsum("oir,rpjs->opijs", out, c)
        out = out.reshape(o * c.shape[1], i * c.shape[2], c.shape[3])
    return out[:, :, 0]
