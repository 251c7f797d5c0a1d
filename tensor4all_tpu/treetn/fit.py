"""Variational (fit) application of operators on tree networks.

JAX rebuild of tensor4all-treetn/src/contraction fit
(fit.rs:1053 `C ≈ A·B` with environment caches + Euler-tour local updates;
operator/apply.rs ApplyOptions::fit): sweep two-site regions of the output
network, replacing each region by the environment-projected image of
``A|x>`` — the optimal local update in the least-squares sense when the
output is kept orthogonal toward the region.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import networkx as nx

from ..config import SvdTruncationPolicy
from ..core.contract import contract
from ..core.decomp import Canonical, svd_two
from ..core.tensor import Tensor
from .network import TreeTN, NodeName
from .operator import TreeOperator


class _FitEnv:
    """Triple-layer <y| A |x> messages, bra = evolving output y."""

    def __init__(self, op: TreeOperator, x: TreeTN, y: TreeTN):
        self.op = op
        self.x = x
        self.y = y
        self._env: Dict[Tuple[NodeName, NodeName], Tensor] = {}
        self._subtree: Dict[Tuple[NodeName, NodeName], frozenset] = {}
        g = x.graph
        for a, b in g.edges:
            for (u, v) in ((a, b), (b, a)):
                gg = g.copy()
                gg.remove_edge(u, v)
                self._subtree[(u, v)] = frozenset(
                    nx.node_connected_component(gg, u)
                )

    def invalidate(self, nodes) -> None:
        nodes = set(nodes)
        for k in [k for k in self._env if self._subtree[k] & nodes]:
            del self._env[k]

    def _bra_y(self, v: NodeName) -> Tensor:
        t = self.y.tensor(v).dag()
        for nb in self.y.neighbors(v):
            t = t.replaceind(self.y.bond(v, nb), self.y.bond(v, nb).prime())
        # bra carries the OUTPUT site (the operator's image index)
        t = t.replaceind(self.op.site_in[v], self.op.site_out[v])
        return t

    def env(self, a: NodeName, to: NodeName) -> Tensor:
        key = (a, to)
        if key in self._env:
            return self._env[key]
        ops = [self._bra_y(a), self.op.tensor(a), self.x.tensor(a)]
        for c in self.x.neighbors(a):
            if c != to:
                ops.append(self.env(c, a))
        msg = contract(ops, check_connected=False)
        self._env[key] = msg
        return msg

    def local_image(self, region) -> Tensor:
        """Env-projected A|x> on the region, in y's ket space."""
        region = list(region)
        rset = set(region)
        ops = [self.op.tensor(v) for v in region]
        ops += [self.x.tensor(v) for v in region]
        for v in region:
            for nb in self.x.neighbors(v):
                if nb not in rset:
                    ops.append(self.env(nb, v))
        img = contract(ops, check_connected=False)
        old, new = [], []
        for v in region:
            old.append(self.op.site_out[v])
            new.append(self.op.site_in[v])
            for nb in self.y.neighbors(v):
                if nb not in rset:
                    bond = self.y.bond(v, nb)
                    old.append(bond.prime())
                    new.append(bond)
        return img.replaceinds(old, new)


class _FitEnvNetworks:
    """Triple-layer <y | a.b> messages for generic two-network fit."""

    def __init__(self, a: TreeTN, b: TreeTN, y: TreeTN):
        self.a = a
        self.b = b
        self.y = y
        self._env: Dict[Tuple[NodeName, NodeName], Tensor] = {}
        self._subtree: Dict[Tuple[NodeName, NodeName], frozenset] = {}
        g = a.graph
        for u, v in g.edges:
            for (s, t) in ((u, v), (v, u)):
                gg = g.copy()
                gg.remove_edge(s, t)
                self._subtree[(s, t)] = frozenset(
                    nx.node_connected_component(gg, s))

    def invalidate(self, nodes) -> None:
        nodes = set(nodes)
        for k in [k for k in self._env if self._subtree[k] & nodes]:
            del self._env[k]

    def _bra_y(self, v: NodeName) -> Tensor:
        t = self.y.tensor(v).dag()
        for nb in self.y.neighbors(v):
            t = t.replaceind(self.y.bond(v, nb), self.y.bond(v, nb).prime())
        return t

    def env(self, v: NodeName, to: NodeName) -> Tensor:
        key = (v, to)
        if key in self._env:
            return self._env[key]
        ops = [self._bra_y(v), self.a.tensor(v), self.b.tensor(v)]
        for c in self.a.neighbors(v):
            if c != to:
                ops.append(self.env(c, v))
        msg = contract(ops, check_connected=False)
        self._env[key] = msg
        return msg

    def local_image(self, region) -> Tensor:
        region = list(region)
        rset = set(region)
        ops = [self.a.tensor(v) for v in region]
        ops += [self.b.tensor(v) for v in region]
        for v in region:
            for nb in self.a.neighbors(v):
                if nb not in rset:
                    ops.append(self.env(nb, v))
        img = contract(ops, check_connected=False)
        old, new = [], []
        for v in region:
            for nb in self.y.neighbors(v):
                if nb not in rset:
                    bond = self.y.bond(v, nb)
                    old.append(bond.prime())
                    new.append(bond)
        return img.replaceinds(old, new)


def fit_networks(
    a: TreeTN,
    b: TreeTN,
    center: Optional[NodeName] = None,
    policy: Optional[SvdTruncationPolicy] = None,
    nsweeps: int = 2,
    initial: Optional[TreeTN] = None,
    max_rank: Optional[int] = None,
) -> TreeTN:
    """Variational ``y ~= a . b`` for two same-topology TreeTNs contracted
    over their shared site indices (ref contraction/fit.rs:1053).

    The initial guess defaults to the one-pass zipup; each sweep refines
    two-site regions with the environment-projected exact image (optimal
    local least-squares update while y stays canonical toward the
    region).
    """
    from .contraction import contract_zipup

    pol = policy or SvdTruncationPolicy(tol=1e-12)
    if max_rank is not None:
        import dataclasses

        pol = dataclasses.replace(
            pol, maxdim=(max_rank if pol.maxdim is None
                         else min(pol.maxdim, max_rank)))
    # preserve topology (no scalar-subtree pruning): the fit sweeps need
    # y to retain a/b's node set (ref ZipupTopologyMode::PreserveInputTopology)
    y = (initial.copy() if initial is not None
         else contract_zipup(a, b, center=center, policy=pol,
                             prune_scalar_subtrees=False))
    root = center if center is not None else y.node_names[0]
    y.canonicalize([root])
    env = _FitEnvNetworks(a, b, y)
    for _ in range(nsweeps):
        for (u, v) in y._euler_edges(root):
            y.move_center(u)
            theta = env.local_image((u, v))
            bond = y.bond(u, v)
            u_side = tuple(i for i in y.tensor(u).indices if i != bond)
            L, R, _ = svd_two(theta, u_side, pol, canonical=Canonical.LEFT)
            y.set_tensor(u, L)
            y.set_tensor(v, R)
            y.set_bond(u, v, L.indices[-1])
            y._set_ortho(u, v, v)
            env.invalidate([u, v])
    return y


def fit_apply(
    op: TreeOperator,
    x: TreeTN,
    policy: Optional[SvdTruncationPolicy] = None,
    nsweeps: int = 2,
    initial: Optional[TreeTN] = None,
) -> TreeTN:
    """Variational ``y ≈ A|x>`` (ref ApplyOptions::fit / fit.rs).

    The initial guess defaults to a zipup application (already close);
    each sweep then refines it with optimal local updates — the cheap
    path when the zipup rank cap bites.
    """
    pol = policy or SvdTruncationPolicy(tol=1e-12)
    y = initial.copy() if initial is not None else op.apply(
        x, method="zipup", policy=pol
    )
    root = y.node_names[0]
    y.canonicalize([root])
    env = _FitEnv(op, x, y)
    for _ in range(nsweeps):
        for (a, b) in y._euler_edges(root):
            y.move_center(a)
            theta = env.local_image((a, b))
            bond = y.bond(a, b)
            a_side = tuple(i for i in y.tensor(a).indices if i != bond)
            L, R, _ = svd_two(theta, a_side, pol, canonical=Canonical.LEFT)
            y.set_tensor(a, L)
            y.set_tensor(b, R)
            y.set_bond(a, b, L.indices[-1])
            y._set_ortho(a, b, b)
            env.invalidate([a, b])
    return y
