"""square_linsolve: solve (a0 + a1*A)|x> = |b> on tree tensor networks.

JAX rebuild of tensor4all-treetn/src/linsolve/square/
(mod.rs:137 entry, updater.rs `SquareLinsolveUpdater`, local_linop.rs,
LinsolveOptions/GmresToleranceMode in common/): canonicalize x, walk the
Euler tour with two-site regions, solve each local projected system
``(a0 + a1 A_proj) theta = b_proj`` with GMRES (core.krylov), split with
truncation, move the center, update cached environments. Ends with a
residual verification report (ref LinsolveVerifyReport, updater.rs).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..config import (
    SingularValueMeasure,
    SvdTruncationPolicy,
    ThresholdScale,
)
from ..core.contract import contract
from ..core.decomp import Canonical, svd_two
from ..core.krylov import gmres
from .network import TreeTN, NodeName
from .operator import TreeOperator
from .projected import ProjectedOperator, ProjectedState


@dataclasses.dataclass
class LinsolveOptions:
    """Ref: LinsolveOptions (linsolve/common)."""

    nsweeps: int = 4
    maxdim: int = 64
    cutoff: float = 1e-12
    gmres_rtol: float = 1e-10
    gmres_maxiter: int = 60
    a0: complex = 0.0
    a1: complex = 1.0
    residual_tol: float = 0.0  # stop early when verified residual below
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
class LinsolveVerifyReport:
    """Ref: LinsolveVerifyReport (square/updater.rs)."""

    residual_norm: float
    rhs_norm: float

    @property
    def relative_residual(self) -> float:
        return self.residual_norm / self.rhs_norm if self.rhs_norm else 0.0


@dataclasses.dataclass
class LinsolveResult:
    x: TreeTN
    report: LinsolveVerifyReport
    converged: bool
    sweep_residuals: List[float]


def _verify(op: TreeOperator, x: TreeTN, b: TreeTN,
            opts: LinsolveOptions) -> LinsolveVerifyReport:
    """Residual ||a0 x + a1 A x - b|| via exact network arithmetic.

    Note: the norm of the difference network is evaluated through inner
    products whose cross terms cancel, so the smallest resolvable relative
    residual is ~sqrt(eps)*||b|| ≈ 1e-8 in f64 — residuals at or below
    that are at the metric's floor (the true residual may be far smaller).
    """
    ax = op.apply(x, method="naive")
    lhs = ax.scale(opts.a1)
    if opts.a0 != 0:
        lhs = lhs.add(x.scale(opts.a0))
    diff = lhs.add(b.scale(-1.0))
    return LinsolveVerifyReport(
        residual_norm=float(diff.norm()), rhs_norm=float(b.norm())
    )


def _extract_chain_cores(tn: TreeTN, order, sites):
    """Host (Dl, d, Dr) cores of a chain TreeTN in `order`."""
    import numpy as np

    cores = []
    for pos, v in enumerate(order):
        axes = []
        if pos > 0:
            axes.append(tn.bond(order[pos - 1], v))
        axes.append(sites[v])
        if pos < len(order) - 1:
            axes.append(tn.bond(v, order[pos + 1]))
        arr = np.asarray(tn.tensor(v).dense(tuple(axes)))
        if pos == 0:
            arr = arr[None, ...]
        if pos == len(order) - 1:
            arr = arr[..., None]
        cores.append(arr)
    return cores


def _try_chain_fast_path(op: TreeOperator, b: TreeTN, x0: TreeTN,
                         opts: LinsolveOptions
                         ) -> Optional[LinsolveResult]:
    """Delegate chain topologies to the host two-site GMRES engine
    (ops.tdvp_chain_host.linsolve_chain_host) on CPU backends — same
    adaptive-rank sweeps, transfer-scan residuals instead of a full
    `op.apply` verify per sweep (the dominant cost of the generic path
    at dispatch-bound sizes). Mirrors dmrg._try_chain_fast_path."""
    import jax
    import numpy as np

    try:
        if jax.default_backend() != "cpu":
            return None
    except Exception:  # noqa: BLE001
        return None
    a0c, a1c = complex(opts.a0), complex(opts.a1)
    if a0c.imag != 0 or a1c.imag != 0:
        return None  # the moment-scan residual derivation is real
    from .tdvp import _chain_order

    order = _chain_order(x0)
    if order is None or set(op.node_names) != set(order):
        return None
    if set(b.node_names) != set(order):
        return None
    if any(len(x0.site_indices(v)) != 1 for v in order):
        return None
    for v in order:
        for tn in (x0, b):
            if isinstance(tn.tensor(v).data, jax.core.Tracer):
                return None
    if set(map(frozenset, b.graph.edges)) != set(
            frozenset((order[i], order[i + 1]))
            for i in range(len(order) - 1)):
        return None
    sites = {v: x0.site_indices(v)[0] for v in order}
    if any(tuple(b.site_indices(v)) != (sites[v],) for v in order):
        return None
    from ..core.index import Index
    from ..core.tensor import Tensor
    from ..ops.dmrg_chain import treeoperator_to_mpo_cores
    from ..ops.tdvp_chain_host import linsolve_chain_host

    try:
        h_cores = treeoperator_to_mpo_cores(op, order)
    except Exception:  # noqa: BLE001 — operator not a chain MPO
        return None
    x_cores = _extract_chain_cores(x0, order, sites)
    b_cores = _extract_chain_cores(b, order, sites)
    rel, out_cores, hist = linsolve_chain_host(
        h_cores, b_cores, x_cores, float(a0c.real), float(a1c.real),
        opts.maxdim, n_sweeps=opts.nsweeps, tol=opts.cutoff,
        gmres_rtol=opts.gmres_rtol, gmres_maxiter=opts.gmres_maxiter,
        residual_tol=opts.residual_tol)
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
    # per-sweep residuals come from the engine's cheap transfer scans
    # (floor-clamped at sqrt(eps)); the FINAL report re-contracts the
    # residual network exactly like the generic path so both paths
    # grade results with the same metric
    report = _verify(op, net, b, opts)
    converged = (opts.residual_tol > 0
                 and report.relative_residual < opts.residual_tol)
    return LinsolveResult(net, report, converged, hist)


def square_linsolve(
    op: TreeOperator,
    b: TreeTN,
    x0: TreeTN,
    center: Optional[NodeName] = None,
    options: Optional[LinsolveOptions] = None,
) -> LinsolveResult:
    """Solve ``(a0 + a1 A) x = b`` by local GMRES sweeps (ref mod.rs:137).

    `b` must share the site indices of `x0` (same physical space).

    Chain topologies on CPU backends route to the host two-site GMRES
    engine (same adaptive-rank sweeps, ~dispatch-free) the way `dmrg`
    and `tdvp` route; pass `center=` or a mesh to force the generic
    tree path.
    """
    opts = options or LinsolveOptions()
    if center is None and opts.mesh is None:
        fast = _try_chain_fast_path(op, b, x0, opts)
        if fast is not None:
            return fast
    x = x0.copy()
    x.validate_tree()
    root = center if center is not None else x.node_names[0]
    x.canonicalize([root])
    proj_a = ProjectedOperator(op, x, mesh=opts.mesh)
    proj_b = ProjectedState(b, x)
    pol = opts.policy()
    sweep_residuals: List[float] = []
    converged = False
    if len(x.node_names) == 1:
        # Single-node network: no edges to sweep, solve the one local
        # problem directly (the Julia linsolve example is exactly this
        # shape, ref docs/examples/julia/treetn.jl "linsolve" anchor).
        theta0 = x.tensor(root)
        rhs = proj_b.project((root,))
        rhs = rhs.permute(theta0.indices) if set(rhs.indices) == set(
            theta0.indices
        ) else rhs

        def apply_single(th):
            y = proj_a.apply_local(th, (root,)) * opts.a1
            if opts.a0 != 0:
                y = y.axpby(opts.a0, th, 1.0)
            return y

        res = gmres(apply_single, rhs, x0=theta0,
                    rtol=opts.gmres_rtol, maxiter=opts.gmres_maxiter)
        x.set_tensor(root, res.x)
        report = _verify(op, x, b, opts)
        conv = (opts.residual_tol <= 0
                or report.relative_residual < opts.residual_tol)
        return LinsolveResult(x, report, conv,
                              [report.relative_residual])
    for sweep in range(opts.nsweeps):
        for (u, v) in x._euler_edges(root):
            bond = x.bond(u, v)
            tu, tv = x.tensor(u), x.tensor(v)
            theta0 = contract([tu, tv])
            rhs = proj_b.project((u, v))
            rhs = rhs.permute(theta0.indices) if set(rhs.indices) == set(
                theta0.indices
            ) else rhs

            def apply_local(th):
                y = proj_a.apply_local(th, (u, v)) * opts.a1
                if opts.a0 != 0:
                    y = y.axpby(opts.a0, th, 1.0)
                return y

            res = gmres(
                apply_local, rhs, x0=theta0,
                rtol=opts.gmres_rtol, maxiter=opts.gmres_maxiter,
            )
            theta = res.x
            u_side = tuple(i for i in tu.indices if i != bond)
            L, R, _ = svd_two(theta, u_side, pol, canonical=Canonical.LEFT)
            x.set_tensor(u, L)
            x.set_tensor(v, R)
            x.set_bond(u, v, L.indices[-1])
            x._set_ortho(u, v, v)
            proj_a.invalidate([u, v])
            proj_b.invalidate([u, v])
        rep = _verify(op, x, b, opts)
        sweep_residuals.append(rep.relative_residual)
        if opts.verbosity:
            print(f"[linsolve] sweep={sweep} rel_res={rep.relative_residual:.3e}")
        if opts.residual_tol > 0 and rep.relative_residual < opts.residual_tol:
            converged = True
            break
    report = _verify(op, x, b, opts)
    if opts.residual_tol > 0:
        converged = report.relative_residual < opts.residual_tol
    return LinsolveResult(x, report, converged, sweep_residuals)
