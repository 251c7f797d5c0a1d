"""Benchmark journal: reproduce the reference's results journal
(ref benchmarks/results/*.md; BASELINE.md rows) as one command.

    python benchmarks/journal.py [--quick] [--out results/<date>.md]

Each rung emits a JSON record {metric, value, unit, baseline,
vs_baseline}; the driver prints the full table and writes a results
markdown. These configs are latency-bound CPU-class workloads
(chi <= 64, host-driven sweeps) — the reference's numbers are
single-thread CPU; run this journal with JAX_PLATFORMS=cpu for a
like-for-like comparison. The accelerator rows (the one-program
engines at production chi) live in bench.py / benchmarks/mxu.py.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Pin the CPU backend up front: every row here is compared against the
# reference's single-thread CPU numbers.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def _median(fn, warmup=1, reps=5):
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def _best(fn, warmup=2, reps=15):
    """Steady-state latency for sub-10ms rows: this box's LAPACK calls
    jitter 2x call-to-call (shared machine), which a median of 5 still
    inherits; min over 15 is the reproducible number."""
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _setup_chain(N, chi, key=0):
    import jax
    import networkx as nx

    from tensor4all_tpu.models.spin import heisenberg
    from tensor4all_tpu.treetn.network import random_treetn

    g = nx.Graph()
    for i in range(N - 1):
        g.add_edge(i, i + 1)
    tn, site_inds = random_treetn(jax.random.PRNGKey(key), g,
                                  {n: [2] for n in g.nodes}, bond_dim=chi)
    sites = {n: site_inds[n][0] for n in g.nodes}
    return g, tn, sites, heisenberg(g, sites)


def _setup_star(N, chi, key=0):
    import jax
    import networkx as nx

    from tensor4all_tpu.models.spin import heisenberg
    from tensor4all_tpu.treetn.network import random_treetn

    g = nx.Graph()
    arms, per = 3, (N - 1) // 3
    prev_names = []
    for a in range(arms):
        prev = "c"
        for i in range(per):
            g.add_edge(prev, (a, i))
            prev = (a, i)
        prev_names.append(prev)
    tn, site_inds = random_treetn(jax.random.PRNGKey(key), g,
                                  {n: [2] for n in g.nodes}, bond_dim=chi)
    sites = {n: site_inds[n][0] for n in g.nodes}
    return g, tn, sites, heisenberg(g, sites)


def bench_dmrg_chain(quick=False):
    """The BASELINE headline (DMRG chain N=8 chi=32, 4 sweeps) on the
    host-numpy adaptive engine, the CPU-class engine at this size."""
    from tensor4all_tpu.models.chain import heisenberg_chain_mpo, mpo_to_dense
    from tensor4all_tpu.ops.tdvp_chain_host import dmrg_chain_host
    from tensor4all_tpu.tt.compression import right_orthogonalize
    from tensor4all_tpu.tt.tensortrain import TensorTrain

    N, chi = 8, 32
    h_cores = heisenberg_chain_mpo(N)
    tt = right_orthogonalize(TensorTrain.random(jax.random.PRNGKey(0),
                                                [2] * N, rank=chi))
    cores0 = [np.asarray(c) for c in tt.cores]
    out = {}

    def body():
        out["e"], _, _ = dmrg_chain_host(h_cores, cores0, chi, n_sweeps=4)

    t = _median(body, warmup=2, reps=5)
    e0 = np.linalg.eigvalsh(mpo_to_dense(h_cores))[0]
    return {"metric": "treetn_dmrg_chain_N8_chi32", "value": t * 1e3,
            "unit": "ms", "baseline": 135.4,
            "vs_baseline": 135.4 / (t * 1e3),
            "detail": {"energy_abs_err": abs(float(out["e"]) - e0),
                       "engine": "host-numpy adaptive"}}


def _setup_star8_reference(chi_init=1):
    """The reference DMRG benchmark's star: center site0 + 7 leaves,
    near-product initial state (benchmark_dmrg.rs edges_for :77,
    make_initial_state :84)."""
    import jax
    import networkx as nx

    from tensor4all_tpu.models.spin import heisenberg
    from tensor4all_tpu.treetn.network import random_treetn

    g = nx.star_graph(7)  # node 0 center, 1..7 leaves
    tn, site_inds = random_treetn(jax.random.PRNGKey(0), g,
                                  {n: [2] for n in g.nodes},
                                  bond_dim=chi_init)
    sites = {n: site_inds[n][0] for n in g.nodes}
    return g, tn, sites, heisenberg(g, sites)


def bench_dmrg_star(quick=False):
    """TreeTN DMRG on the star topology — the reference's headline
    tree-topology win (242.8 ms, 7.9x vs Julia; ref
    2026-06-27-treetn-dmrg-itensornetworks.md:47-48)."""
    import numpy as np

    from tensor4all_tpu.models.spin import dense_heisenberg
    from tensor4all_tpu.treetn.dmrg import DmrgOptions, dmrg

    g, tn, sites, op = _setup_star8_reference(chi_init=2)
    order = list(g.nodes)
    e_exact = float(np.linalg.eigvalsh(
        np.asarray(dense_heisenberg(g, order)))[0])
    opts = DmrgOptions(nsweeps=4, maxdim=32, cutoff=1e-12,
                       lanczos_maxiter=16, lanczos_rtol=1e-12)
    out = {}

    def body():
        out["res"] = dmrg(op, tn, center=1, options=opts)

    t = _median(body, warmup=1, reps=2 if quick else 3)
    err = abs(out["res"].energy - e_exact)
    rows = [{"metric": "treetn_dmrg_star_N8_chi32", "value": t * 1e3,
             "unit": "ms", "baseline": 242.8,
             "vs_baseline": 242.8 / (t * 1e3),
             "detail": {"energy_abs_err": err, "exact": e_exact,
                        "note": ("above baseline since the r3 "
                                 "TT-factorized dressed region cores + "
                                 "contract promotion (projected.py): the "
                                 "hub's 5^7*4 dressed center core is "
                                 "never materialized dense; each local "
                                 "apply rides the factorized form")}}]
    # The jitted ONE-PROGRAM star engine (ops/dmrg_star.py): same
    # problem, whole multi-sweep run in one XLA program — the
    # bucket-and-mask chain-engine design applied to the star.
    from tensor4all_tpu.ops.dmrg_star import dmrg_star_heisenberg

    def body_jit():
        e, _, _ = dmrg_star_heisenberg(7, n_sweeps=3, lanczos_iters=16)
        out["e_jit"] = float(e)

    body_jit()  # compile
    t_jit = _median(body_jit, warmup=0, reps=3 if quick else 5)
    rows.append({
        "metric": "dmrg_star_jit_N8", "value": t_jit * 1e3,
        "unit": "ms", "baseline": 242.8,
        "vs_baseline": 242.8 / (t_jit * 1e3),
        "detail": {"energy_abs_err": abs(out["e_jit"] - e_exact),
                   "engine": "ops/dmrg_star.py jitted one-program "
                             "(factorized per-edge H, exact d-bond "
                             "splits)"}})
    return rows


def bench_rrlu64(quick=False):
    """rrLU on Hilbert 64x64 (ref 2026-05-22-matrix-lu-hilbert.md:
    0.092 ms, rank 13)."""
    import numpy as np

    from tensor4all_tpu.ops.rrlu import rrlu

    n = 64
    i = np.arange(n)
    h = 1.0 / (1.0 + i[:, None] + i[None, :])
    out = rrlu(h, rtol=1e-10)
    ts = []
    for r in range(15):
        t0 = time.perf_counter()
        rrlu(h * (1.0 + 1e-9 * r), rtol=1e-10)
        ts.append(time.perf_counter() - t0)
    ts.sort()
    t = ts[len(ts) // 2]
    return {"metric": "rrlu_hilbert_64", "value": t * 1e3, "unit": "ms",
            "baseline": 0.092, "vs_baseline": 0.092 / (t * 1e3),
            "detail": {"rank": int(out.rank),
                       "last_pivot_error": out.last_pivot_error}}


def bench_tci2_gauss10d(quick=False):
    """North-star config 2 (BASELINE.json): TCI2 of a 10-D multivariate
    Gaussian to tol 1e-8, dynamic pivots. No reference wall-clock exists;
    the row records OUR time + achieved error for round-over-round
    tracking."""
    import numpy as np

    from tensor4all_tpu.tci.tensorci2 import (
        TCI2Options,
        crossinterpolate2,
        estimate_true_error,
    )

    L, d = 10, 10
    xs = np.linspace(-1.0, 1.0, d)
    # anisotropic correlated Gaussian (genuinely coupled dims)
    w = 0.3 + 0.1 * np.arange(L)

    def batch_f(idx):
        x = xs[idx]  # (B, L)
        quad = np.sum(w * x * x, axis=1) + 0.2 * np.sum(
            x[:, :-1] * x[:, 1:], axis=1)
        return np.exp(-quad)

    out = {}

    def body():
        out["tci"], out["ranks"], out["errs"] = crossinterpolate2(
            batch_f=batch_f, local_dims=[d] * L,
            options=TCI2Options(tol=1e-8, max_iter=10))

    t = _median(body, warmup=1, reps=2 if quick else 3)
    tci = out["tci"]
    err = estimate_true_error(tci.to_tensortrain(), tci.func,
                              n_samples=4000)
    return {"metric": "tci2_gauss10d_tol1e-8", "value": t * 1e3,
            "unit": "ms", "baseline": float("nan"),
            "vs_baseline": float("nan"),
            "detail": {"rank": max(out["ranks"]),
                       "sampled_rel_err": float(err / tci.f_max),
                       "n_evals": tci.func.num_evals}}


def bench_quantics_r30(quick=False):
    """North-star config 3 (BASELINE.json): quantics TT of a 1-D
    oscillatory function at R=30 bits + shift and derivative
    (difference-kernel) MPO application. Timed row for round tracking
    (no reference wall-clock exists)."""
    import numpy as np

    from tensor4all_tpu.quantics.grids import DiscretizedGrid
    from tensor4all_tpu.quantics.qtci import quanticscrossinterpolate
    from tensor4all_tpu.quantics.transforms import (
        apply_quantics_operator,
        difference_kernel_mpo,
        shift_operator,
    )
    from tensor4all_tpu.tci.tensorci2 import TCI2Options

    R = 30
    grid = DiscretizedGrid.create(R, 0.0, 1.0)

    def f(x):
        x = np.asarray(x)[:, 0]
        return np.sin(50.0 * x) * np.exp(-x) + 0.3 * np.cos(511.0 * x)

    out = {}

    def body():
        qtt = quanticscrossinterpolate(
            f, grid, options=TCI2Options(tol=1e-10, max_iter=12))
        tt = qtt.tt
        sh = shift_operator(R, 1)          # x -> x + 2^-R
        dk = difference_kernel_mpo(R, kind="central")
        out["qtt"] = qtt
        out["shifted"] = apply_quantics_operator(sh, tt, tol=1e-12,
                                                 maxdim=64)
        out["deriv"] = apply_quantics_operator(dk, tt, tol=1e-12,
                                               maxdim=64)

    t = _median(body, warmup=1, reps=2 if quick else 3)
    qtt = out["qtt"]
    # accuracy spot check on the base interpolant
    rng = np.random.default_rng(0)
    m = rng.integers(0, 1 << R, size=256)
    x = (m.astype(np.float64) / (1 << R))[:, None]
    err = float(np.max(np.abs(qtt.evaluate(x) - f(x))))
    return {"metric": "quantics_r30_interp_shift_deriv", "value": t * 1e3,
            "unit": "ms", "baseline": float("nan"),
            "vs_baseline": float("nan"),
            "detail": {"interp_abs_err": err,
                       "rank": qtt.tt.max_rank}}


def bench_tt_constant(quick=False):
    """North-star config 1 (BASELINE.json): TensorTrain.constant([2,3,4])
    evaluate/sum + SVD recompression (of the rank-2 sum back to rank 1).
    Sub-ms sanity row for round tracking (no reference wall-clock)."""
    import numpy as np

    from tensor4all_tpu.tt.compression import compress
    from tensor4all_tpu.tt.tensortrain import TensorTrain

    dims = [2, 3, 4]
    out = {}

    def body():
        tt = TensorTrain.constant(dims, 0.5)
        v = complex(tt.evaluate([1, 2, 3]))
        s = complex(tt.sum())
        two = tt.axpby(1.0, tt, 1.0)         # rank-2 representation of 2*tt
        rec = compress(two, tol=1e-12)       # SVD recompression -> rank 1
        out.update(v=v, s=s, rank=rec.max_rank,
                   v2=complex(rec.evaluate([1, 2, 3])))

    t = _median(body, warmup=2, reps=3 if quick else 7)
    assert abs(out["v"] - 0.5) < 1e-14, out["v"]
    assert abs(out["s"] - 0.5 * 24) < 1e-12, out["s"]
    assert out["rank"] == 1 and abs(out["v2"] - 1.0) < 1e-12
    return {"metric": "tt_constant_eval_sum_recompress", "value": t * 1e3,
            "unit": "ms", "baseline": float("nan"),
            "vs_baseline": float("nan"),
            "detail": {"recompressed_rank": out["rank"]}}


def bench_treetn_roundtrip(quick=False):
    """North-star config 4 (BASELINE.json): TreeTN arbitrary-topology
    canonicalization + truncation + contraction on a fixed 10-node
    random tree (hub degree 4), chi=16 -> truncate to 8. Asserts the
    canonical region verifies and the truncated network stays within
    the SVD tail bound of the dense oracle."""
    import networkx as nx
    import numpy as np

    from tensor4all_tpu.treetn.network import random_treetn

    g = nx.Graph()
    g.add_edges_from([(0, 1), (1, 2), (2, 3), (2, 4), (2, 5), (5, 6),
                      (6, 7), (6, 8), (8, 9)])
    tn0, site_inds = random_treetn(jax.random.PRNGKey(7), g,
                                   {v: [2] for v in g.nodes},
                                   bond_dim=16)
    order = list(g.nodes)
    sites = [site_inds[v][0] for v in order]
    dense = np.asarray(tn0.contract_to_tensor().dense(sites)).reshape(-1)
    out = {}

    def body():
        from tensor4all_tpu.config import SvdTruncationPolicy

        tn = tn0.copy()
        tn.canonicalize([2])
        tn.verify_canonical()
        tn.truncate(policy=SvdTruncationPolicy(maxdim=8))
        out["vec"] = np.asarray(
            tn.contract_to_tensor().dense(sites)).reshape(-1)
        out["chi"] = tn.max_bond_dim()

    t = _median(body, warmup=1, reps=3 if quick else 5)
    rel = float(np.linalg.norm(out["vec"] - dense)
                / np.linalg.norm(dense))
    assert out["chi"] <= 8
    assert rel < 0.5, rel  # random-state truncation: bounded, not tiny
    return {"metric": "treetn_canon_trunc_contract_10node",
            "value": t * 1e3, "unit": "ms", "baseline": float("nan"),
            "vs_baseline": float("nan"),
            "detail": {"rel_err_vs_dense": rel,
                       "chi_after": out["chi"]}}


def bench_tdvp(topology: str, quick=False):
    from tensor4all_tpu.treetn.tdvp import TdvpOptions, tdvp

    if topology == "chain":
        g, tn, sites, op = _setup_chain(8, 8)
        baseline = 104.6
    else:
        # the reference's star is the HUB star (center + 7 leaves,
        # benchmark_tdvp.rs edges_for :105), not a 3-arm comb
        g, tn, sites, op = _setup_star8_reference(chi_init=2)
        baseline = 1739.5
    tn.set_tensor(list(g.nodes)[0],
                  tn.tensor(list(g.nodes)[0]) / float(tn.norm()))
    opts = TdvpOptions(nsteps=4, order=2, maxdim=32, cutoff=1e-12)

    def body():
        tdvp(op, tn, t=-1j * 0.08, options=opts)

    t = _median(body, warmup=1, reps=2 if quick else 3)
    rows = [{"metric": f"treetn_tdvp_{topology}_N8_chi32",
             "value": t * 1e3, "unit": "ms", "baseline": baseline,
             "vs_baseline": baseline / (t * 1e3)}]
    if topology == "star":
        # jitted ONE-PROGRAM star TDVP engine (ops/tdvp_star.py): the
        # same 4-step order-2 evolution in one XLA program
        from tensor4all_tpu.ops.tdvp_star import tdvp_star_heisenberg

        def body_jit():
            hub, _ = tdvp_star_heisenberg(7, -1j * 0.08, nsteps=4,
                                          order=2, krylov_m=10)
            return float(jnp.sum(jnp.abs(hub)))

        import jax.numpy as jnp

        body_jit()  # compile
        t_jit = _median(body_jit, warmup=0, reps=3 if quick else 5)
        rows.append({
            "metric": "tdvp_star_jit_N8", "value": t_jit * 1e3,
            "unit": "ms", "baseline": baseline,
            "vs_baseline": baseline / (t_jit * 1e3),
            "detail": {"engine": "ops/tdvp_star.py jitted one-program "
                                 "(factorized per-edge H, exact "
                                 "d-bond splits)"}})
    return rows


def bench_tdvp_chain_host(quick=False):
    """Host-numpy adaptive TDVP chain engine — the CPU-backend engine
    the library recommends at this latency-bound size
    (ops/tdvp_chain_host.py)."""
    import jax

    from tensor4all_tpu.ops.dmrg_chain import treeoperator_to_mpo_cores
    from tensor4all_tpu.ops.tdvp_chain_host import tdvp_chain_host
    from tensor4all_tpu.tt.tensortrain import TensorTrain

    g, tn, sites, op = _setup_chain(8, 8)
    h_cores = treeoperator_to_mpo_cores(op, list(g.nodes))
    tt = TensorTrain.random(jax.random.PRNGKey(1), [2] * 8, rank=32)
    cores0 = [np.asarray(c) for c in tt.cores]

    def body():
        tdvp_chain_host(h_cores, cores0, -1j * 0.08, 32, nsteps=4,
                        order=2)

    t = _median(body, warmup=1, reps=5)
    return {"metric": "tdvp_chain_host_N8_chi32", "value": t * 1e3,
            "unit": "ms", "baseline": 104.6,
            "vs_baseline": 104.6 / (t * 1e3)}


def bench_tdvp_chain_jit(quick=False):
    """Fully-jitted TDVP chain engine (ops.tdvp_chain): the speed-of-
    light path next to the flexible host-driven treetn.tdvp row."""
    import jax
    import jax.numpy as jnp

    from tensor4all_tpu.ops.dmrg_chain import treeoperator_to_mpo_cores
    from tensor4all_tpu.ops.tdvp_chain import tdvp_chain
    from tensor4all_tpu.tt.tensortrain import TensorTrain

    g, tn, sites, op = _setup_chain(8, 8)
    h_cores = treeoperator_to_mpo_cores(op, list(g.nodes))
    tt = TensorTrain.random(jax.random.PRNGKey(1), [2] * 8, rank=32)
    cores0 = list(tt.cores)

    def body():
        mps = tdvp_chain(h_cores, cores0, -1j * 0.08, 32, nsteps=4,
                         order=2)
        float(jnp.sum(jnp.abs(mps)))

    t = _median(body, warmup=1, reps=3)
    return {"metric": "tdvp_chain_jit_N8_chi32", "value": t * 1e3,
            "unit": "ms", "baseline": 104.6,
            "vs_baseline": 104.6 / (t * 1e3),
            "detail": {"note": (
                "tdvp_chain now routes by backend (VERDICT r2 #9): on "
                "CPU 'auto' delegates to the host two-site engine — "
                "measured crossover study (1-thread CPU): jit-vs-host "
                "576/72 ms at N=8 chi=32, 7134/886 at N=16 chi=64, "
                "67659/3348 at N=16 chi=128, i.e. NO CPU crossover, "
                "the padded fixed-shape engine is a device design. "
                "Accelerator rows live in bench.py detail "
                "(tdvp_N32_chi256_*, split real-time)")}}


def bench_projected_apply(chi: int, quick=False):
    """Warm local two-site projected-operator apply, N=38
    (ref 2026-05-18-projected-apply.md)."""
    from tensor4all_tpu.treetn.projected import ProjectedOperator

    N = 38
    g, tn, sites, op = _setup_chain(N, chi)
    tn.canonicalize([N // 2])
    proj = ProjectedOperator(op, tn)
    from tensor4all_tpu.core.contract import contract

    a, b = N // 2, N // 2 + 1
    theta = contract([tn.tensor(a), tn.tensor(b)])
    proj.apply_local(theta, (a, b))  # build envs (warm)

    def body():
        y = proj.apply_local(theta, (a, b))
        np.asarray(y.data)

    t = _best(body, warmup=2, reps=5 if quick else 11)
    baseline = 6.0 if chi == 32 else 68.2
    return {"metric": f"projected_apply_N38_chi{chi}", "value": t * 1e3,
            "unit": "ms", "baseline": baseline,
            "vs_baseline": baseline / (t * 1e3)}


def bench_local_linsolve(quick=False):
    """Prepared local linsolve sweeps (ref 2026-05-18-local-linsolve.md):
    N=38, chi=32 operator/state."""
    from tensor4all_tpu.treetn.linsolve import (
        LinsolveOptions,
        square_linsolve,
    )

    N = 38 if not quick else 16
    g, x0, sites, op = _setup_chain(N, 16)
    _, b, _, _ = _setup_chain(N, 16, key=1)
    # b must share x0's site indices
    from tensor4all_tpu.treetn.network import TreeTN
    import jax

    from tensor4all_tpu.core.index import Index
    from tensor4all_tpu.core.tensor import Tensor
    from tensor4all_tpu.treetn.network import _edge_key

    bonds = {}
    for u, v in g.edges:
        bonds[_edge_key(u, v)] = Index(16, tags="Link")
    bb = TreeTN()
    ks = jax.random.split(jax.random.PRNGKey(2), N)
    for k, n in zip(ks, g.nodes):
        inds = [sites[n]] + [bonds[_edge_key(n, nb)]
                             for nb in g.neighbors(n)]
        bb.add_node(n, Tensor.random(k, inds))
    for u, v in g.edges:
        bb.graph.add_edge(u, v, bond=bonds[_edge_key(u, v)])

    opts = LinsolveOptions(nsweeps=1, maxdim=32, cutoff=1e-10,
                           gmres_maxiter=10, a0=1.0, a1=0.05)

    def body():
        square_linsolve(op, bb, x0, options=opts)

    t = _median(body, warmup=1, reps=2)
    rows = [{"metric": "local_linsolve_N38_chi32_1sweep", "value": t,
             "unit": "s", "baseline": 6.89 / 2,  # ref runs 2 sweeps/74 steps
             "vs_baseline": (6.89 / 2) / t}]
    # jitted ONE-PROGRAM chain linsolve engine (ops/linsolve_chain.py):
    # the same 1-sweep (a0 + a1 H)x = b solve in one XLA program with
    # fixed-m MINRES local solves
    import jax.numpy as jnp

    from tensor4all_tpu.ops.dmrg_chain import treeoperator_to_mpo_cores
    from tensor4all_tpu.ops.linsolve_chain import (
        linsolve_run,
        pad_mpo,
        pad_mps,
    )
    from tensor4all_tpu.tt.tensortrain import TensorTrain

    h = pad_mpo([jnp.asarray(c, jnp.float64) for c in
                 treeoperator_to_mpo_cores(op, list(range(N)))])
    bt = TensorTrain.random(jax.random.PRNGKey(11), [2] * N, rank=16,
                            dtype=jnp.float64)
    bpad = pad_mps(list(bt.cores), 16)
    xt = TensorTrain.random(jax.random.PRNGKey(12), [2] * N, rank=16,
                            dtype=jnp.float64)
    xpad = pad_mps(list(xt.cores), 32)
    out_jit = {}

    def body_jit():
        rel, _ = linsolve_run(h, bpad, xpad, 1.0, 0.05, n_sweeps=1,
                              minres_m=10)
        out_jit["rel"] = float(rel)

    body_jit()  # compile
    t_jit = _median(body_jit, warmup=0, reps=3 if quick else 5)
    rows.append({
        "metric": "linsolve_chain_jit_N38", "value": t_jit,
        "unit": "s", "baseline": 6.89 / 2,
        "vs_baseline": (6.89 / 2) / t_jit,
        "detail": {"rel_residual_report": out_jit["rel"],
                   "engine": "ops/linsolve_chain.py jitted one-program "
                             "(fixed-m MINRES local solves)"}})
    return rows


def _aci_deterministic_tt(input_index: int, n_sites: int, d: int, chi: int):
    """The reference benchmark's deterministic closed-form TT fixture
    (tensor4all-aci/benches/elementwise_scaling.rs:25-97 `core_value` /
    `deterministic_tt`): values depend on physical AND bond coordinates
    so the fixture has genuine (not merely structural) bond content."""
    import numpy as np

    from tensor4all_tpu.tt.tensortrain import TensorTrain

    links = [min(d ** min(s + 1, n_sites - s - 1), chi)
             for s in range(n_sites - 1)]
    cores = []
    for s in range(n_sites):
        dl = 1 if s == 0 else links[s - 1]
        dr = 1 if s == n_sites - 1 else links[s]
        left = np.arange(1, dl + 1)[:, None, None]
        phys = np.arange(1, d + 1)[None, :, None]
        right = np.arange(1, dr + 1)[None, None, :]
        inp, site = input_index + 1.0, s + 1.0
        phase = (0.173 * inp * site + 0.193 * phys + 0.071 * left * right
                 + 0.109 * inp * left + 0.131 * site * right)
        bond_mix = (0.29 * np.sin(phase)
                    + 0.23 * np.cos(0.157 * inp * phys * right
                                    + 0.211 * site * left)
                    + 0.17 * (left / (dl + 1.0) - right / (dr + 1.0)) * phys)
        cores.append((0.31 + bond_mix) / (dl * dr) ** 0.25)
    return TensorTrain(cores)


def bench_aci_elementwise(chi: int = 8, quick=False):
    """ACI elementwise product, reference benchmark config mirrored
    (elementwise_scaling.rs: N=12 d=2, deterministic fixture, tol 1e-10,
    no bond cap, deterministic initial guess; ref results
    2026-05-21-aci-elementwise.md)."""
    import numpy as np

    from tensor4all_tpu.tt.aci import AciOptions, elementwise_batched

    L, d = 12, 2
    a = _aci_deterministic_tt(0, L, d, chi)
    b = _aci_deterministic_tt(1, L, d, chi)
    guess = _aci_deterministic_tt(2, L, d, chi)
    opts = AciOptions(tol=1e-10, max_iter=20, initial_guess=guess)

    out = {}

    def body():
        out["res"] = elementwise_batched(lambda x, y: x * y, [a, b], opts)

    t = _median(body, warmup=1, reps=2 if quick else 3)
    # accuracy contract of the reference bench: sampled err < 1e-8
    rng = np.random.default_rng(64 + chi)
    idx = rng.integers(0, d, size=(64, L))
    err = float(np.max(np.abs(
        np.asarray(out["res"].evaluate_batch(idx))
        - np.asarray(a.evaluate_batch(idx))
        * np.asarray(b.evaluate_batch(idx)))))
    baseline = {4: 25.551, 8: 84.297, 16: 4216.9}[chi]
    return {"metric": f"aci_elementwise_chi{chi}", "value": t * 1e3,
            "unit": "ms", "baseline": baseline,
            "vs_baseline": baseline / (t * 1e3),
            "detail": {"sampled_max_abs_err": err,
                       "output_max_chi": out["res"].tt.max_rank,
                       "sweeps": len(out["res"].ranks)}}


def bench_mps_ops(quick=False):
    """MPS inner / direct-sum add, L=32 chi=8 complex128
    (ref 2026-05-19-tt-ops.md)."""
    import jax

    from tensor4all_tpu.tt.tensortrain import TensorTrain

    L, d, chi = 32, 2, 8
    a = TensorTrain.random(jax.random.PRNGKey(0), [d] * L, rank=chi,
                           dtype=np.complex128)
    b = TensorTrain.random(jax.random.PRNGKey(1), [d] * L, rank=chi,
                           dtype=np.complex128)

    def inner():
        complex(a.inner(b))

    def add():
        np.asarray((a + b).cores[-1])  # sync (cores may be host numpy)

    t_i = _best(inner, warmup=2, reps=15)
    t_a = _best(add, warmup=2, reps=15)
    return [
        {"metric": "mps_inner_L32_chi8", "value": t_i * 1e3, "unit": "ms",
         "baseline": 1.151, "vs_baseline": 1.151 / (t_i * 1e3)},
        {"metric": "mps_add_L32_chi8", "value": t_a * 1e3, "unit": "ms",
         "baseline": 1.149, "vs_baseline": 1.149 / (t_a * 1e3)},
    ]


def bench_mpo_zipup(quick=False):
    import jax
    import jax.numpy as jnp

    from tensor4all_tpu.tt import MPO

    L, d, chi = 10, 2, 8
    links = [1] + [chi] * (L - 1) + [1]
    ks = jax.random.split(jax.random.PRNGKey(0), 2 * L)
    a = MPO([jax.random.normal(ks[k], (links[k], d, d, links[k + 1]),
                               jnp.float64) / chi for k in range(L)])
    b = MPO([jax.random.normal(ks[L + k], (links[k], d, d, links[k + 1]),
                               jnp.float64) / chi for k in range(L)])

    def body():
        out = a.compose_zipup_fast(b, tol=1e-12, maxdim=chi)
        np.asarray(out.cores[-1])  # sync (cores may be host numpy)

    t = _best(body, warmup=2, reps=15)
    return {"metric": "mpo_zipup_L10_chi8", "value": t * 1e3,
            "unit": "ms", "baseline": 2.297,
            "vs_baseline": 2.297 / (t * 1e3)}


def bench_rrlu(quick=False):
    import sys as _s

    _s.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from bench import bench_rrlu as rung

    r = rung()
    return {"metric": "rrlu_hilbert_128", "value": r["value"],
            "unit": "ms", "baseline": 0.329,
            "vs_baseline": r["vs_baseline"],
            "detail": r.get("detail", {})}


def main():
    quick = "--quick" in sys.argv
    import jax

    # Pin BLAS/LAPACK pools to ONE thread for the whole journal, exactly
    # as the reference does (ref benchmarks/README.md:31
    # RAYON_NUM_THREADS=1 / BLAS_NUM_THREADS=1): multi-thread LAPACK
    # inflated some round-1 wins (VERDICT r1 weak #7). Pass --mt to
    # measure unpinned. Thread state is recorded in the output header.
    thread_note = "unpinned (--mt)"
    ctx = None
    if "--mt" not in sys.argv:
        try:
            from threadpoolctl import threadpool_limits

            ctx = threadpool_limits(limits=1)
            thread_note = "BLAS pools pinned to 1 thread (threadpoolctl)"
        except Exception as e:  # noqa: BLE001
            thread_note = f"pin unavailable ({type(e).__name__}); unpinned"

    # latency-bound micro-rows run FIRST: the heavyweight sweeps leave
    # warm thread pools/allocator state that inflates sub-ms rows by 2-3x
    rungs = [
        ("rrlu", lambda: bench_rrlu(quick)),
        ("rrlu 64", lambda: bench_rrlu64(quick)),
        ("mps ops", lambda: bench_mps_ops(quick)),
        ("mpo zipup", lambda: bench_mpo_zipup(quick)),
        ("proj apply 32", lambda: bench_projected_apply(32, quick)),
        ("proj apply 64", lambda: bench_projected_apply(64, quick)),
        ("aci chi4", lambda: bench_aci_elementwise(4, quick)),
        ("aci chi8", lambda: bench_aci_elementwise(8, quick)),
        ("aci chi16", lambda: bench_aci_elementwise(16, quick)),
        ("dmrg", lambda: bench_dmrg_chain(quick)),
        ("dmrg star", lambda: bench_dmrg_star(quick)),
        ("tci2 gauss10d", lambda: bench_tci2_gauss10d(quick)),
        ("quantics r30", lambda: bench_quantics_r30(quick)),
        ("tt constant", lambda: bench_tt_constant(quick)),
        ("treetn roundtrip", lambda: bench_treetn_roundtrip(quick)),
        ("tdvp chain", lambda: bench_tdvp("chain", quick)),
        ("tdvp star", lambda: bench_tdvp("star", quick)),
        ("tdvp chain host", lambda: bench_tdvp_chain_host(quick)),
        ("tdvp chain jit", lambda: bench_tdvp_chain_jit(quick)),
        ("linsolve", lambda: bench_local_linsolve(quick)),
    ]
    records = []
    for name, fn in rungs:
        try:
            r = fn()
        except Exception as e:  # noqa: BLE001 — keep the journal running
            records.append({"metric": name, "error": f"{type(e).__name__}: {e}"})
            continue
        records.extend(r if isinstance(r, list) else [r])
    device = str(jax.devices()[0])
    print(f"\n== benchmark journal ({device}; {thread_note}) ==")
    hdr = f"{'metric':38s} {'value':>12s} {'unit':>5s} {'baseline':>10s} {'vs':>8s}"
    print(hdr)
    import os as _os
    lines = ["# Benchmark journal", "",
             f"Device: {device}",
             f"Threads: {thread_note}",
             f"Host CPUs: {_os.cpu_count()} "
             "(CPU rows scale with the VM's core count — compare "
             "journals only at equal topology)", "",
             "| metric | value | unit | baseline | vs_baseline |",
             "|---|---|---|---|---|"]
    for r in records:
        if "error" in r:
            print(f"{r['metric']:38s} ERROR {r['error']}")
            lines.append(f"| {r['metric']} | ERROR {r['error']} | | | |")
            continue
        print(f"{r['metric']:38s} {r['value']:12.3f} {r['unit']:>5s} "
              f"{r['baseline']:10.3f} {r['vs_baseline']:8.3f}")
        lines.append(
            f"| {r['metric']} | {r['value']:.3f} | {r['unit']} | "
            f"{r['baseline']:.3f} | {r['vs_baseline']:.3f} |")
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "results")
    os.makedirs(out_dir, exist_ok=True)
    stamp = time.strftime("%Y-%m-%d")
    path = os.path.join(out_dir, f"{stamp}-journal.md")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"\nwrote {path}")
    print(json.dumps(records))


if __name__ == "__main__":
    main()
