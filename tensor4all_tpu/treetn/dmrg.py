"""DMRG: two-site ground-state search on tree tensor networks.

JAX rebuild of tensor4all-treetn/src/dmrg/mod.rs
(`dmrg` :626, `dmrg_with_treetn_operator` :751, `DmrgOptions` :174,
local solve :409): canonicalize to the sweep origin, walk the Euler tour
with two-site regions, solve each local eigenproblem with Lanczos on the
projected operator (cached environments), SVD-truncate, move the center,
and invalidate affected environments.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from ..config import (
    SingularValueMeasure,
    SvdTruncationPolicy,
    ThresholdScale,
)
from ..core.contract import contract
from ..core.decomp import Canonical, svd_two
from ..core.krylov import hermitian_lanczos_lowest_eigenpair
from .localupdate import (
    BaseUpdater,
    LocalUpdateSweepPlan,
    apply_local_update_sweep,
)
from .network import TreeTN, NodeName
from .operator import TreeOperator
from .projected import ProjectedOperator


@dataclasses.dataclass
class DmrgOptions:
    """Ref: DmrgOptions (dmrg/mod.rs:174)."""

    nsweeps: int = 4
    maxdim: int = 32
    cutoff: float = 1e-12  # ITensors-style squared-tail relative cutoff
    lanczos_maxiter: int = 30
    lanczos_rtol: float = 1e-12
    energy_tol: float = 0.0  # stop early when |dE| < energy_tol
    verbosity: int = 0
    mesh: object = None  # jax.sharding.Mesh: chi-partition two-site local solves

    def policy(self) -> SvdTruncationPolicy:
        return SvdTruncationPolicy(
            tol=self.cutoff,
            scale=ThresholdScale.RELATIVE,
            measure=SingularValueMeasure.SQUARED_TAIL,
            maxdim=self.maxdim,
        )


@dataclasses.dataclass
class DmrgResult:
    state: TreeTN
    energy: float
    energies: List[float]  # per sweep
    converged: bool


class _DmrgUpdater(BaseUpdater):
    """Two-site ground-state updater for the shared sweep framework
    (ref dmrg/mod.rs:409 local solve)."""

    def __init__(self, proj: ProjectedOperator, policy, opts: "DmrgOptions"):
        self.proj = proj
        self.policy = policy
        self.opts = opts
        self.last_energy = None

    def update(self, subtree: TreeTN, step, full: TreeTN) -> TreeTN:
        a = next(v for v in step.nodes if v != step.new_center)
        b = step.new_center
        bond = subtree.bond(a, b)
        ta, tb = subtree.tensor(a), subtree.tensor(b)
        theta = contract([ta, tb])
        ev, theta = hermitian_lanczos_lowest_eigenpair(
            lambda th: self.proj.apply_local(th, (a, b)),
            theta,
            maxiter=self.opts.lanczos_maxiter,
            rtol=self.opts.lanczos_rtol,
        )
        self.last_energy = ev
        a_side = tuple(i for i in ta.indices if i != bond)
        L, R, _ = svd_two(theta, a_side, self.policy,
                          canonical=Canonical.LEFT)
        out = TreeTN()
        out.add_node(a, L)
        out.add_node(b, R)
        new_bond = next(i for i in L.indices if i not in a_side)
        out.graph.add_edge(a, b, bond=new_bond)
        from .network import _edge_key

        out.ortho_towards[_edge_key(a, b)] = b
        return out

    def after_step(self, step, full: TreeTN) -> None:
        self.proj.invalidate(step.nodes)


def _try_chain_fast_path(op: TreeOperator, init: TreeTN,
                         opts: DmrgOptions) -> Optional[DmrgResult]:
    """Delegate chain topologies to the host two-site engine
    (ops.tdvp_chain_host.dmrg_chain_host) on CPU backends — same
    sweeps, adaptive ranks, ~10x faster at dispatch-bound sizes."""
    import jax
    import numpy as np

    try:
        if jax.default_backend() != "cpu":
            return None
    except Exception:  # noqa: BLE001
        return None
    if opts.energy_tol > 0:
        return None  # early-stop semantics stay with the generic path
    from .tdvp import _chain_order

    order = _chain_order(init)
    if order is None or set(op.node_names) != set(order):
        return None
    if any(len(init.site_indices(v)) != 1 for v in order):
        return None
    for v in order:
        if isinstance(init.tensor(v).data, jax.core.Tracer):
            return None
    from ..core.index import Index
    from ..core.tensor import Tensor
    from ..ops.dmrg_chain import treeoperator_to_mpo_cores
    from ..ops.tdvp_chain_host import dmrg_chain_host

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
    energy, out_cores, sweep_energies = dmrg_chain_host(
        h_cores, cores, opts.maxdim, n_sweeps=opts.nsweeps,
        tol=opts.cutoff, lanczos_iters=opts.lanczos_maxiter,
        lanczos_rtol=opts.lanczos_rtol)
    net = TreeTN()
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
    return DmrgResult(state=net, energy=float(energy),
                      energies=sweep_energies, converged=True)


def dmrg(
    op: TreeOperator,
    init: TreeTN,
    center: Optional[NodeName] = None,
    options: Optional[DmrgOptions] = None,
) -> DmrgResult:
    """Two-site DMRG ground-state search (ref dmrg/mod.rs:626)."""
    opts = options or DmrgOptions()
    fast = None if opts.mesh is not None \
        else _try_chain_fast_path(op, init, opts)
    if fast is not None:
        return fast
    state = init.copy()
    state.validate_tree()
    root = center if center is not None else state.node_names[0]
    state.canonicalize([root])
    # normalize (keeps local problems well-scaled)
    n0 = float(state.norm())
    if n0 == 0:
        raise ValueError("zero initial state")
    state.set_tensor(root, state.tensor(root) / n0)
    proj = ProjectedOperator(op, state, mesh=opts.mesh)
    pol = opts.policy()
    energies: List[float] = []
    last_energy = None
    converged = False
    plan = LocalUpdateSweepPlan.from_treetn(state, root, nsite=2)
    updater = _DmrgUpdater(proj, pol, opts)
    for sweep in range(opts.nsweeps):
        apply_local_update_sweep(state, plan, updater)
        energy = updater.last_energy
        energies.append(float(energy))
        if opts.verbosity:
            print(f"[dmrg] sweep={sweep} E={energy:.12f} "
                  f"maxdim={state.max_bond_dim()}")
        if (
            last_energy is not None
            and opts.energy_tol > 0
            and abs(energy - last_energy) < opts.energy_tol
        ):
            converged = True
            break
        last_energy = energy
    return DmrgResult(state, energies[-1], energies, converged)
