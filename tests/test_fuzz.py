"""Seeded randomized consistency sweeps against dense oracles.

The deterministic suites pin one configuration per feature; these fuzz
loops run many random shapes/topologies through the load-bearing
invariants (the reference's closed-form-oracle style, SURVEY §4.4,
with seeded RNG so failures reproduce)."""

import itertools

import jax
import networkx as nx
import numpy as np
import pytest

from tensor4all_tpu import Index, Tensor, contract
from tensor4all_tpu.config import SvdTruncationPolicy
from tensor4all_tpu.core.decomp import FactorizeAlg, factorize
from tensor4all_tpu.treetn.network import random_treetn
from tensor4all_tpu.tt.tensortrain import TensorTrain


def _random_tree(rng, n):
    """Random labelled tree on n nodes via a Prüfer-like growth."""
    g = nx.Graph()
    g.add_node(0)
    for v in range(1, n):
        g.add_edge(v, int(rng.integers(0, v)))
    return g


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_factorize_all_algs(seed):
    rng = np.random.default_rng(seed)
    dims = [int(rng.integers(2, 6)) for _ in range(4)]
    inds = tuple(Index(d) for d in dims)
    t = Tensor(inds, np.asarray(rng.standard_normal(dims)))
    n_left = int(rng.integers(1, 4))
    left = inds[:n_left]
    for alg in (FactorizeAlg.SVD, FactorizeAlg.QR, FactorizeAlg.LU,
                FactorizeAlg.CI):
        L, R, _ = factorize(t, left, alg=alg,
                            policy=SvdTruncationPolicy(tol=1e-13))
        recon = contract([L, R]).permute(inds)
        np.testing.assert_allclose(np.asarray(recon.data),
                                   np.asarray(t.data), atol=1e-9,
                                   err_msg=f"alg={alg} seed={seed}")


@pytest.mark.parametrize("seed", range(5))
def test_fuzz_treetn_gauge_invariants(seed):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(4, 9))
    g = _random_tree(rng, n)
    chi = int(rng.integers(2, 5))
    tn, si = random_treetn(jax.random.PRNGKey(seed), g,
                           {v: [2] for v in g.nodes}, bond_dim=chi)
    order = tuple(si[v][0] for v in sorted(g.nodes))
    dense0 = np.asarray(tn.contract_to_tensor().dense(order))
    center = sorted(g.nodes)[int(rng.integers(0, n))]
    form = [FactorizeAlg.QR, FactorizeAlg.LU,
            FactorizeAlg.CI][int(rng.integers(0, 3))]
    tn.canonicalize([center], form=form)
    np.testing.assert_allclose(
        np.asarray(tn.contract_to_tensor().dense(order)), dense0,
        atol=1e-9, err_msg=f"canonicalize {form} seed={seed}")
    assert set(tn.canonical_region()) == {center}
    tn.truncate(SvdTruncationPolicy(tol=1e-13))
    np.testing.assert_allclose(
        np.asarray(tn.contract_to_tensor().dense(order)), dense0,
        atol=1e-8, err_msg=f"truncate seed={seed}")
    # norm via gauge equals dense norm
    assert abs(float(tn.norm()) - np.linalg.norm(dense0)) < 1e-8


@pytest.mark.parametrize("seed", range(5))
def test_fuzz_tt_compression_methods(seed):
    rng = np.random.default_rng(200 + seed)
    L = int(rng.integers(3, 7))
    dims = [int(rng.integers(2, 4)) for _ in range(L)]
    rank = int(rng.integers(2, 5))
    tt = TensorTrain.random(jax.random.PRNGKey(seed), dims, rank=rank)
    d = np.asarray(tt.full_tensor())
    for method in ("svd", "lu", "ci"):
        c = tt.compress(tol=1e-12, method=method)
        np.testing.assert_allclose(np.asarray(c.full_tensor()), d,
                                   atol=1e-8 * max(1.0, np.abs(d).max()),
                                   err_msg=f"{method} seed={seed}")
    # hadamard + add against dense
    other = TensorTrain.random(jax.random.PRNGKey(1000 + seed), dims,
                               rank=2)
    od = np.asarray(other.full_tensor())
    np.testing.assert_allclose(np.asarray((tt + other).full_tensor()),
                               d + od, atol=1e-10)
    np.testing.assert_allclose(np.asarray(tt.hadamard(other).full_tensor()),
                               d * od, atol=1e-10)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_contract_nary(seed):
    """n-ary contraction == pairwise numpy einsum on random connected
    networks."""
    rng = np.random.default_rng(300 + seed)
    n = int(rng.integers(3, 6))
    g = _random_tree(rng, n)
    # one shared index per edge + one free index per node
    bonds = {tuple(sorted(e)): Index(int(rng.integers(2, 5)))
             for e in g.edges}
    free = {v: Index(int(rng.integers(2, 4))) for v in g.nodes}
    tensors = []
    for v in g.nodes:
        inds = [free[v]] + [bonds[tuple(sorted((v, u)))]
                            for u in g.neighbors(v)]
        tensors.append(Tensor(tuple(inds), np.asarray(
            rng.standard_normal([i.dim for i in inds]))))
    out = contract(tensors)
    order = tuple(free[v] for v in sorted(g.nodes))
    got = np.asarray(out.dense(order))
    # numpy oracle via repeated tensordot in graph order
    import string

    labels = {}
    counter = itertools.count()
    def lab(ix):
        if ix not in labels:
            labels[ix] = string.ascii_letters[next(counter)]
        return labels[ix]

    expr = ",".join("".join(lab(i) for i in t.indices) for t in tensors)
    expr += "->" + "".join(lab(i) for i in order)
    want = np.einsum(expr, *[np.asarray(t.data) for t in tensors],
                     optimize=True)
    np.testing.assert_allclose(got, want, atol=1e-10,
                               err_msg=f"seed={seed}")


@pytest.mark.parametrize("seed", range(5))
def test_fuzz_gse_preserves_state_random_trees(seed):
    """Per-bond GSE on random tree topologies: expansion must preserve
    the represented state exactly and leave a verifiable gauge."""
    from tensor4all_tpu.models.spin import heisenberg
    from tensor4all_tpu.treetn.gse import GseOptions, global_subspace_expand

    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 7))
    g = _random_tree(rng, n)
    chi = int(rng.integers(1, 4))
    tn, si = random_treetn(jax.random.PRNGKey(seed), g,
                           {v: [2] for v in g.nodes}, bond_dim=chi)
    sites = {v: si[v][0] for v in g.nodes}
    op = heisenberg(g, sites)
    res = global_subspace_expand(
        op, tn, options=GseOptions(krylov_dim=int(rng.integers(1, 3))))
    order = list(g.nodes)
    v0 = np.asarray(tn.contract_to_tensor().dense(
        [sites[v] for v in order])).reshape(-1)
    v1 = np.asarray(res.state.contract_to_tensor().dense(
        [sites[v] for v in order])).reshape(-1)
    nrm = np.linalg.norm(v0)
    assert np.linalg.norm(v1 - v0) < 1e-9 * max(nrm, 1.0), seed
    res.state.verify_canonical(atol=1e-8)


@pytest.mark.parametrize("seed", range(5))
def test_fuzz_aci_alternating_random_ops(seed):
    """Alternating-CI on random input TTs and random smooth elementwise
    operators vs dense oracle samples."""
    from tensor4all_tpu.tt.aci import AciOptions, elementwise_batched

    rng = np.random.default_rng(seed)
    L = int(rng.integers(3, 7))
    d = int(rng.integers(2, 4))
    k = int(rng.integers(1, 4))
    tts = [TensorTrain.random(jax.random.PRNGKey(seed * 10 + j),
                              [d] * L, rank=int(rng.integers(1, 4)))
           for j in range(k)]
    coef = rng.standard_normal(k)

    def op(*cols):
        out = np.zeros_like(cols[0])
        for c, col in zip(coef, cols):
            out = out + c * col
        return out + 0.1 * np.prod(np.stack(cols), axis=0)

    res = elementwise_batched(op, tts,
                              AciOptions(tol=1e-10, max_iter=12))
    idx = rng.integers(0, d, size=(100, L))
    got = np.asarray(res.evaluate_batch(idx))
    expect = op(*[np.asarray(t.evaluate_batch(idx)) for t in tts])
    scale = max(np.max(np.abs(expect)), 1e-12)
    assert np.max(np.abs(got - expect)) < 1e-7 * scale, seed


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_blocked_rrlu_random_spectra(seed):
    """Blocked-rook device kernel vs the sequential reference across
    random shapes/spectra: rank within rook tolerance, reconstruction
    at the requested accuracy."""
    import jax.numpy as jnp

    from tensor4all_tpu.ops.rrlu import _rrlu_kernel_blocked, rrlu

    rng = np.random.default_rng(seed)
    n = int(rng.integers(40, 200))
    m = int(rng.integers(40, 200))
    r = int(rng.integers(1, min(n, m)))
    A = (rng.standard_normal((n, r))
         * np.logspace(0, -float(rng.integers(2, 10)), r)) \
        @ rng.standard_normal((r, m))
    ref = rrlu(np.asarray(A), rtol=1e-9)
    mr = min(n, m)
    Lb, Ub, meta = _rrlu_kernel_blocked(jnp.asarray(A), 1e-9, 0.0, mr, 32)
    meta = np.asarray(meta)
    kk = int(meta[3 * mr])
    L = np.asarray(Lb)[:, :kk]
    U = np.asarray(Ub)[:kk, :]
    err = np.max(np.abs(L @ U - A)) / np.abs(A).max()
    assert err < 5e-8, (seed, err)
    assert abs(kk - ref.rank) <= 4, (seed, kk, ref.rank)


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_split_tdvp_random_states(seed):
    """Real/imag-split TDVP vs the complex engine from random complex
    initial states (not just real ones)."""
    import jax.numpy as jnp
    import networkx as nx

    from tensor4all_tpu.models.spin import heisenberg
    from tensor4all_tpu.ops.dmrg_chain import treeoperator_to_mpo_cores
    from tensor4all_tpu.ops.tdvp_chain import tdvp_chain
    from tensor4all_tpu.ops.tdvp_chain_split import tdvp_chain_split

    rng = np.random.default_rng(seed)
    N = int(rng.integers(3, 6))
    g = nx.path_graph(N)
    tn, si = random_treetn(jax.random.PRNGKey(seed), g,
                           {v: [2] for v in g.nodes}, bond_dim=2)
    sites = {v: si[v][0] for v in g.nodes}
    op = heisenberg(g, sites)
    h_cores = treeoperator_to_mpo_cores(op, list(range(N)))
    cores = []
    for k in range(N):
        t = tn.tensor(k)
        axes = ([tn.bond(k - 1, k)] if k else []) + [sites[k]] \
            + ([tn.bond(k, k + 1)] if k < N - 1 else [])
        arr = np.asarray(t.dense(tuple(axes))).astype(complex)
        arr = arr * np.exp(1j * rng.uniform(0, 2 * np.pi))
        arr = arr + 0.3j * rng.standard_normal(arr.shape)
        if k == 0:
            arr = arr[None]
        if k == N - 1:
            arr = arr[..., None]
        cores.append(arr)
    T = 0.1
    mr, mi = tdvp_chain_split(h_cores, cores, -1j * T, chi=8, nsteps=2,
                              order=2, krylov_m=10, dtype=jnp.float64)
    m = np.asarray(mr) + 1j * np.asarray(mi)
    acc = m[0][0]
    for k in range(1, N):
        acc = np.einsum("...a,aib->...ib", acc, m[k])
    got = acc[..., 0].reshape(-1)
    out = np.asarray(tdvp_chain(h_cores, cores, -1j * T, chi=8, nsteps=2,
                                engine="jit",
                                order=2, krylov_m=10))
    acc = out[0][0]
    for k in range(1, N):
        acc = np.einsum("...a,aib->...ib", acc, out[k])
    ref = acc[..., 0].reshape(-1)
    ph = np.vdot(got, ref)
    got = got * ph / abs(ph)
    assert np.linalg.norm(got - ref) < 1e-8, seed


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_tdvp_speed_knobs_random_configs(seed):
    """Random (bf16_tail, krylov_m1, expm_max_squarings, reortho,
    gemm2_apply, precision) knob combinations on random chains must stay
    FINITE and within the integrator's error envelope of the
    all-defaults trajectory (the knobs are approximation-grade choices,
    never correctness switches; an f32 NaN episode in the production
    rows is the motivating regression class)."""
    import jax.numpy as jnp

    from tensor4all_tpu.models.spin import heisenberg
    from tensor4all_tpu.ops.dmrg_chain import (
        pad_mpo,
        pad_mps,
        treeoperator_to_mpo_cores,
    )
    from tensor4all_tpu.ops.tdvp_chain import tdvp_run

    rng = np.random.default_rng(seed)
    N = int(rng.integers(4, 9))
    chi = int(2 ** rng.integers(2, 5))
    g = nx.path_graph(N)
    tn, si = random_treetn(jax.random.PRNGKey(seed), g,
                           {v: [2] for v in g.nodes}, bond_dim=2)
    op = heisenberg(g, {v: si[v][0] for v in g.nodes})
    h = pad_mpo([jnp.asarray(c, jnp.float32)
                 for c in treeoperator_to_mpo_cores(op, list(range(N)))])
    cores = [jnp.asarray(rng.standard_normal(
        (chi if k else 1, 2, chi if k < N - 1 else 1)), jnp.float32)
        for k in range(N)]
    mps0 = pad_mps(cores, chi)

    ref = np.asarray(tdvp_run(h, mps0, -0.1, nsteps=2, order=2,
                              krylov_m=10, sweep_dtype=jnp.float32,
                              orthogonalize=True))

    def fid(a, b):
        Tab = np.ones((1, 1))
        Ta = np.ones((1, 1))
        Tb = np.ones((1, 1))
        for k in range(N):
            Tab = np.einsum("ab,adr,bds->rs", Tab, a[k], b[k],
                            optimize=True)
            Ta = np.einsum("ab,adr,bds->rs", Ta, a[k], a[k],
                           optimize=True)
            Tb = np.einsum("ab,adr,bds->rs", Tb, b[k], b[k],
                           optimize=True)
        return abs(Tab[0, 0]) / np.sqrt(abs(Ta[0, 0]) * abs(Tb[0, 0]))

    for _ in range(3):
        m = int(rng.integers(6, 13))
        knobs = dict(
            krylov_m=m,
            precision=str(rng.choice(["default", "high", "highest"])),
            reortho=bool(rng.integers(0, 2)),
            gemm2_apply=bool(rng.integers(0, 2)),
            bf16_tail=int(rng.integers(0, 5)),
            krylov_m1=int(rng.integers(4, m + 1)),
            expm_max_squarings=int(rng.choice([6, 8, 20])),
        )
        out = np.asarray(tdvp_run(h, mps0, -0.1, nsteps=2, order=2,
                                  sweep_dtype=jnp.float32,
                                  orthogonalize=True, **knobs))
        assert np.isfinite(out).all(), knobs
        f = fid(out, ref)
        # 'default' precision = single bf16 pass everywhere (~1e-3
        # grade); everything else must stay f32-grade-ish
        bar = 5e-3 if knobs["precision"] == "default" else 5e-4
        assert f > 1 - bar, (f, knobs)
