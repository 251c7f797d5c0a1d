"""TDVP: time evolution on tree tensor networks.

JAX rebuild of tensor4all-treetn/src/tdvp/
(mod.rs:1101 `tdvp`, :1237 `tdvp_with_treetn_operator`, `TdvpOptions`
:273, plan.rs:1-379 ITensorNetworks-compatible region plans).

Integrator (Lubich projector-splitting, order 2): the tangent projector on
a tree decomposes as ``P = sum_e P_e^(2site) - sum_v (d_v - 1) P_v^(1site)``.
One half-sweep visits the edges in DFS first-visit order, evolving each
two-site region by ``exp(+c*delta*H_proj)`` with a backward single-site
``exp(-c*delta*H_proj)`` at each region's start vertex (except the first
region) — this places exactly ``d_v - 1`` backward steps per vertex per
half-sweep. The second half-sweep is the exact mirror, giving a palindromic
(order-2) composition; order 1 runs the forward half only with full steps.
The orthogonality center moves between regions by exact QR gauge moves
(TreeTN.move_center). Local exponentials are Hermitian Krylov propagators;
environments come from the ProjectedOperator cache.

Convention: ``tdvp(op, state, t)`` produces ``exp(t*H)|state>`` —
``t = -1j*T`` for real time, ``t = -T`` for imaginary time.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import networkx as nx

from ..config import (
    SingularValueMeasure,
    SvdTruncationPolicy,
    ThresholdScale,
)
from ..core.contract import contract
from ..core.decomp import Canonical, svd_two
from ..core.krylov import hermitian_krylov_expm_multiply
from .network import TreeTN, NodeName
from .operator import TreeOperator
from .projected import ProjectedOperator


@dataclasses.dataclass
class TdvpOptions:
    """Ref: TdvpOptions (tdvp/mod.rs:273)."""

    nsteps: int = 1
    order: int = 2  # Suzuki-Trotter order 1 or 2
    nsite: int = 2
    maxdim: int = 64
    cutoff: float = 1e-12
    krylov_maxiter: int = 30
    krylov_rtol: float = 1e-12
    normalize: bool = False
    verbosity: int = 0

    def policy(self) -> SvdTruncationPolicy:
        return SvdTruncationPolicy(
            tol=self.cutoff,
            scale=ThresholdScale.RELATIVE,
            measure=SingularValueMeasure.SQUARED_TAIL,
            maxdim=self.maxdim,
        )


def _region_plan(state: TreeTN, root: NodeName, order: int):
    """Op list [('edge', (u,v)) | ('site', w)] (ref tdvp/plan.rs).

    Forward half: DFS first-visit edges (u=parent side), backward site at
    each region's start vertex between regions. Order 2 appends the exact
    mirror.
    """
    edges: List[Tuple[NodeName, NodeName]] = []

    def walk(u, par):
        for v in state.graph.neighbors(u):
            if v == par:
                continue
            edges.append((u, v))
            walk(v, u)

    walk(root, None)
    fwd: List[tuple] = []
    for j, (u, v) in enumerate(edges):
        if j > 0:
            fwd.append(("site", u))
        fwd.append(("edge", (u, v)))
    if order == 1:
        return fwd
    if order == 2:
        return fwd + list(reversed(fwd))
    raise ValueError("order must be 1 or 2")


def _evolve_edge(proj, state, u, v, coeff, opts, pol, toward):
    """Evolve two-site region (u,v); leave the center on `toward`."""
    state.move_center(u)
    bond = state.bond(u, v)
    tu, tv = state.tensor(u), state.tensor(v)
    theta = contract([tu, tv])
    theta = hermitian_krylov_expm_multiply(
        lambda th: proj.apply_local(th, (u, v)),
        theta,
        coeff,
        maxiter=opts.krylov_maxiter,
        rtol=opts.krylov_rtol,
    )
    if toward == v:
        a, ta = u, tu
    else:
        a, ta = v, tv
    b = v if a == u else u
    a_side = tuple(i for i in ta.indices if i != bond)
    L, R, _ = svd_two(theta, a_side, pol, canonical=Canonical.LEFT)
    state.set_tensor(a, L)
    state.set_tensor(b, R)
    state.set_bond(a, b, L.indices[-1])
    state._set_ortho(a, b, b)
    proj.invalidate([a, b])


def _evolve_site(proj, state, w, coeff, opts):
    state.move_center(w)
    tw = hermitian_krylov_expm_multiply(
        lambda th: proj.apply_local(th, (w,)),
        state.tensor(w),
        coeff,
        maxiter=opts.krylov_maxiter,
        rtol=opts.krylov_rtol,
    )
    state.set_tensor(w, tw)
    proj.invalidate([w])


def _fwd_site1(proj, state, w, coeff, opts):
    """exp(+coeff * H_proj(w)) on node w (center must be at w)."""
    state.move_center(w)
    tw = hermitian_krylov_expm_multiply(
        lambda th: proj.apply_local(th, (w,)),
        state.tensor(w),
        coeff,
        maxiter=opts.krylov_maxiter,
        rtol=opts.krylov_rtol,
    )
    state.set_tensor(w, tw)
    proj.invalidate([w])


def _bwd_bond1(proj, state, w, nb, coeff, opts):
    """Zero-site backward bond step: QR-split w toward nb, evolve the
    bond tensor by exp(-coeff * H_proj(bond)), absorb it into nb
    (center moves w -> nb). Requires the center at w."""
    from ..core.decomp import FactorizeAlg, factorize

    state.move_center(w)
    tw = state.tensor(w)
    bond_old = state.bond(w, nb)
    left = tuple(i for i in tw.indices if i != bond_old)
    Q, C, _ = factorize(tw, left, alg=FactorizeAlg.QR,
                        canonical=Canonical.LEFT)
    beta = next(i for i in Q.indices if i not in left)
    # nb-side message must be captured BEFORE the edge bond is renamed
    env_nb = proj.env(nb, w)
    state.set_tensor(w, Q)
    state.set_bond(w, nb, beta)
    state._set_ortho(w, nb, nb)
    proj.invalidate([w])
    env_w = proj.env(w, nb)

    def apply_bond(th):
        y = contract([th, env_w, env_nb], check_connected=False)
        return y.replaceinds([beta.prime(), bond_old.prime()],
                             [beta, bond_old])

    C = hermitian_krylov_expm_multiply(
        apply_bond, C, -coeff,
        maxiter=opts.krylov_maxiter, rtol=opts.krylov_rtol)
    state.set_tensor(nb, contract([C, state.tensor(nb)]))
    proj.invalidate([nb])


def _tdvp_1site(op, state, root, t, opts):
    """nsite=1 projector splitting (ref tdvp/plan.rs:33-48, OneSite):
    each node evolved forward once and each edge backward once per pass,
    edge corrections tied to the DFS-tree parent edges so the order-2
    composition is an exact palindrome on arbitrary trees. Bond
    dimensions are preserved exactly."""
    proj = ProjectedOperator(op, state)
    dt = t / opts.nsteps
    delta = dt / 2.0 if opts.order == 2 else dt
    post = list(nx.dfs_postorder_nodes(state.graph, root))
    parent = dict(nx.dfs_predecessors(state.graph, root))

    def forward_pass(coeff):
        # leaves-to-root: w+, then backward on (w, parent(w))
        for w in post:
            _fwd_site1(proj, state, w, coeff, opts)
            if w in parent:
                _bwd_bond1(proj, state, w, parent[w], coeff, opts)

    def reverse_pass(coeff):
        # exact mirror: root+, then per pre-order v: backward on
        # (parent(v), v), then v+
        for v in reversed(post):
            if v in parent:
                _bwd_bond1(proj, state, parent[v], v, coeff, opts)
            _fwd_site1(proj, state, v, coeff, opts)

    for step in range(opts.nsteps):
        forward_pass(delta)
        if opts.order == 2:
            reverse_pass(delta)
        if opts.normalize:
            nn = float(state.norm())
            if nn > 0:
                region = state.canonical_region()
                c = next(iter(region)) if region else root
                state.set_tensor(c, state.tensor(c) / nn)
        if opts.verbosity:
            print(f"[tdvp1] step={step} maxdim={state.max_bond_dim()}")
    return state


def _chain_order(state: TreeTN):
    """Ordered node list when the state graph is a path, else None."""
    import networkx as nx

    g = state.graph
    if len(g) < 2 or not nx.is_connected(g):
        return None
    degs = dict(g.degree)
    ends = [v for v, d in degs.items() if d == 1]
    if len(ends) != 2 or any(d > 2 for d in degs.values()):
        return None
    order = [ends[0]]
    prev = None
    while len(order) < len(g):
        nxts = [u for u in g.neighbors(order[-1]) if u != prev]
        if len(nxts) != 1:
            return None
        prev = order[-1]
        order.append(nxts[0])
    return order


def _try_chain_fast_path(op: TreeOperator, init: TreeTN, t: complex,
                         opts: TdvpOptions) -> Optional[TreeTN]:
    """Delegate chain topologies to the host two-site engine
    (ops.tdvp_chain_host) on CPU backends, where the generic per-node
    Tensor machinery is dispatch-bound (~10x slower at journal sizes).
    Same integrator and accuracy; see tests/test_chain_host.py."""
    import jax
    import numpy as np

    try:
        if jax.default_backend() != "cpu":
            return None
    except Exception:  # noqa: BLE001
        return None
    order = _chain_order(init)
    if order is None or set(op.node_names) != set(order):
        return None
    if any(len(init.site_indices(v)) != 1 for v in order):
        return None
    for v in order:
        if isinstance(init.tensor(v).data, jax.core.Tracer):
            return None
    from ..core.tensor import Tensor
    from ..ops.dmrg_chain import treeoperator_to_mpo_cores
    from ..ops.tdvp_chain_host import tdvp_chain_host

    try:
        h_cores = treeoperator_to_mpo_cores(op, order)
    except Exception:  # noqa: BLE001 — operator not a chain MPO
        return None
    sites = {v: init.site_indices(v)[0] for v in order}
    cores = []
    for pos, v in enumerate(order):
        t_v = init.tensor(v)
        axes = []
        if pos > 0:
            axes.append(init.bond(order[pos - 1], v))
        axes.append(sites[v])
        if pos < len(order) - 1:
            axes.append(init.bond(v, order[pos + 1]))
        arr = np.asarray(t_v.dense(tuple(axes)))
        if pos == 0:
            arr = arr[None, ...]
        if pos == len(order) - 1:
            arr = arr[..., None]
        cores.append(arr)
    n_in = float(np.real(
        np.sqrt(complex(init.inner(init)))))
    out_cores = tdvp_chain_host(
        h_cores, cores, t, opts.maxdim, nsteps=opts.nsteps,
        order=opts.order, tol=opts.cutoff,
        krylov_rtol=opts.krylov_rtol,
        krylov_maxiter=opts.krylov_maxiter)
    # the host engine normalizes the initial state; restore the input
    # scale unless the caller asked for normalization
    if not opts.normalize:
        out_cores[0] = out_cores[0] * n_in
    from .network import TreeTN as _TreeTN
    from ..core.index import Index

    net = _TreeTN()
    bonds = [Index(int(out_cores[k].shape[2]), tags="Link")
             for k in range(len(order) - 1)]
    for pos, v in enumerate(order):
        c = out_cores[pos]
        inds = []
        data = c
        if pos == 0:
            data = data[0]
        else:
            inds.append(bonds[pos - 1])
        inds.append(sites[v])
        if pos == len(order) - 1:
            data = data[..., 0]
        else:
            inds.append(bonds[pos])
        net.add_node(v, Tensor(tuple(inds), data))
    for pos in range(len(order) - 1):
        net.connect(order[pos], order[pos + 1], bonds[pos])
    return net


def tdvp(
    op: TreeOperator,
    init: TreeTN,
    t: complex,
    center: Optional[NodeName] = None,
    options: Optional[TdvpOptions] = None,
) -> TreeTN:
    """Evolve ``exp(t*H)|init>`` by TDVP sweeps (ref tdvp :1101).

    ``nsite=2`` (default) grows bonds up to `maxdim`; ``nsite=1``
    preserves bond dimensions exactly (projector-splitting with zero-site
    backward bond steps, ref tdvp/plan.rs:33-48).
    """
    opts = options or TdvpOptions()
    if opts.nsite not in (1, 2):
        raise ValueError("nsite must be 1 or 2")
    if opts.nsite == 2:
        fast = _try_chain_fast_path(op, init, t, opts)
        if fast is not None:
            return fast
    state = init.copy()
    state.validate_tree()
    root = center if center is not None else state.node_names[0]
    state.canonicalize([root])
    if opts.nsite == 1:
        return _tdvp_1site(op, state, root, t, opts)
    proj = ProjectedOperator(op, state)
    pol = opts.policy()
    dt = t / opts.nsteps
    delta = dt / 2.0 if opts.order == 2 else dt
    plan = _region_plan(state, root, opts.order)
    n = len(plan)
    for step in range(opts.nsteps):
        for k, item in enumerate(plan):
            if item[0] == "edge":
                u, v = item[1]
                # forward half leaves center deep (at v); mirror half
                # leaves it at the parent side (u) for the walk back
                toward = v if k < n // 2 or opts.order == 1 else u
                _evolve_edge(proj, state, u, v, delta, opts, pol, toward)
            else:
                _evolve_site(proj, state, item[1], -delta, opts)
        if opts.normalize:
            nn = float(state.norm())
            if nn > 0:
                region = state.canonical_region()
                c = next(iter(region)) if region else root
                state.set_tensor(c, state.tensor(c) / nn)
        if opts.verbosity:
            print(f"[tdvp] step={step} maxdim={state.max_bond_dim()}")
    return state
