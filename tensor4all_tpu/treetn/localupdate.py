"""Reusable local-update sweep framework for TreeTNs.

JAX rebuild of tensor4all-treetn/src/treetn/localupdate.rs:25-896
(`LocalUpdateStep`, `LocalUpdateSweepPlan`, `LocalUpdater`,
`apply_local_update_sweep`, `TruncateUpdater`, `extract_subtree` :606,
`replace_subtree` :767) and local_update_support.rs.

Every sweeping algorithm (truncate, DMRG, TDVP, linsolve, fit) consumes
the same plan/updater abstraction instead of re-implementing its own
Euler tour: a plan is a host-side list of (region nodes, new center)
steps; an updater transforms the extracted local subtree; the framework
handles center movement, subtree replacement, and orthogonality
bookkeeping. nsite=1 and nsite=2 plans are both supported (ref
tdvp/plan.rs:33-48).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Protocol, Sequence

import networkx as nx

from ..config import SvdTruncationPolicy
from ..core.contract import contract
from ..core.decomp import Canonical, svd_two
from ..core.index import Index
from ..core.tensor import Tensor
from .network import TreeTN, NodeName, _edge_key


@dataclasses.dataclass
class LocalUpdateStep:
    """One step: the region to update and the center after the update
    (ref localupdate.rs:31)."""

    nodes: List[NodeName]
    new_center: NodeName


@dataclasses.dataclass
class LocalUpdateSweepPlan:
    """Euler-tour sweep plan (ref localupdate.rs:60-160).

    nsite=2: one step per Euler-tour edge (each bond visited in both
    directions); nsite=1: one step per Euler-tour vertex visit.
    """

    steps: List[LocalUpdateStep]
    nsite: int

    @staticmethod
    def from_treetn(tn: TreeTN, root: NodeName, nsite: int
                    ) -> "LocalUpdateSweepPlan":
        if nsite not in (1, 2):
            raise ValueError("nsite must be 1 or 2")
        if nsite == 2:
            steps = [LocalUpdateStep([a, b], b)
                     for a, b in tn._euler_edges(root)]
            return LocalUpdateSweepPlan(steps, 2)
        # nsite=1: Euler tour vertex sequence, minus the final return
        verts: List[NodeName] = [root]

        def walk(u, par):
            for v in tn.graph.neighbors(u):
                if v == par:
                    continue
                verts.append(v)
                walk(v, u)
                verts.append(u)

        walk(root, None)
        steps = [LocalUpdateStep([v], v) for v in verts[:-1]] \
            if len(verts) > 1 else [LocalUpdateStep([root], root)]
        return LocalUpdateSweepPlan(steps, 1)

    def __len__(self):
        return len(self.steps)

    def reversed(self) -> "LocalUpdateSweepPlan":
        steps = [LocalUpdateStep(list(reversed(s.nodes)),
                                 list(reversed(s.nodes))[-1])
                 for s in reversed(self.steps)]
        return LocalUpdateSweepPlan(steps, self.nsite)


class LocalUpdater(Protocol):
    """Updater hook trio (ref localupdate.rs:270 LocalUpdater trait)."""

    def before_step(self, step: LocalUpdateStep, full: TreeTN) -> None:
        ...

    def update(self, subtree: TreeTN, step: LocalUpdateStep,
               full: TreeTN) -> TreeTN:
        ...

    def after_step(self, step: LocalUpdateStep, full: TreeTN) -> None:
        ...


class BaseUpdater:
    """No-op hooks; subclass and override `update`."""

    def before_step(self, step, full):
        pass

    def update(self, subtree, step, full):
        raise NotImplementedError

    def after_step(self, step, full):
        pass


def extract_subtree(tn: TreeTN, nodes: Sequence[NodeName]) -> TreeTN:
    """Copy the induced (connected) sub-network; boundary bonds dangle
    (ref localupdate.rs:606)."""
    nodes = list(nodes)
    nset = set(nodes)
    sub = tn.graph.subgraph(nset)
    if len(nodes) > 1 and not nx.is_connected(sub):
        raise ValueError("extract_subtree: nodes are not connected")
    out = TreeTN()
    for v in nodes:
        out.add_node(v, tn.tensor(v))
    for a, b in sub.edges:
        out.graph.add_edge(a, b, bond=tn.bond(a, b))
        key = _edge_key(a, b)
        if key in tn.ortho_towards:
            out.ortho_towards[key] = tn.ortho_towards[key]
    return out


def replace_subtree(tn: TreeTN, nodes: Sequence[NodeName],
                    replacement: TreeTN) -> None:
    """Insert an updated subtree back (same nodes, same external
    indices; internal bonds may have changed) (ref localupdate.rs:767)."""
    nset = set(nodes)
    if set(replacement.node_names) != nset:
        raise ValueError("replace_subtree: node set mismatch")
    for v in nodes:
        tn.set_tensor(v, replacement.tensor(v))
    sub = tn.graph.subgraph(nset)
    for a, b in sub.edges:
        tn.set_bond(a, b, replacement.bond(a, b))
        key = _edge_key(a, b)
        if key in replacement.ortho_towards:
            tn.ortho_towards[key] = replacement.ortho_towards[key]


def apply_local_update_sweep(tn: TreeTN, plan: LocalUpdateSweepPlan,
                             updater) -> None:
    """Run a sweep plan (ref localupdate.rs:355): per step, move the
    center into the region, extract, update, replace, re-point the
    orthogonality."""
    for step in plan.steps:
        region = tn.canonical_region()
        center = next(iter(region)) if region and len(region) == 1 else None
        if center is None or center not in step.nodes:
            target = step.nodes[0]
            if center is not None:
                path = nx.shortest_path(tn.graph, center, target)
                for v in path:
                    if v in step.nodes:
                        target = v
                        break
            tn.move_center(target)
        updater.before_step(step, tn)
        subtree = extract_subtree(tn, step.nodes)
        updated = updater.update(subtree, step, tn)
        replace_subtree(tn, step.nodes, updated)
        if len(step.nodes) == 2:
            a = next(v for v in step.nodes if v != step.new_center)
            tn._set_ortho(a, step.new_center, step.new_center)
        elif step.new_center not in step.nodes:
            tn.move_center(step.new_center)
        updater.after_step(step, tn)


class TruncateUpdater(BaseUpdater):
    """Two-site SVD truncation updater (ref localupdate.rs:465)."""

    def __init__(self, policy: Optional[SvdTruncationPolicy] = None,
                 max_rank: Optional[int] = None):
        pol = policy or SvdTruncationPolicy(tol=0.0)
        if max_rank is not None:
            pol = dataclasses.replace(
                pol, maxdim=(max_rank if pol.maxdim is None
                             else min(pol.maxdim, max_rank)))
        self.policy = pol

    def update(self, subtree: TreeTN, step: LocalUpdateStep,
               full: TreeTN) -> TreeTN:
        a = next(v for v in step.nodes if v != step.new_center)
        b = step.new_center
        bond = subtree.bond(a, b)
        ta, tb = subtree.tensor(a), subtree.tensor(b)
        theta = contract([ta, tb])
        a_side = tuple(i for i in ta.indices if i != bond)
        L, R, _ = svd_two(theta, a_side, self.policy,
                          canonical=Canonical.LEFT)
        out = TreeTN()
        out.add_node(a, L)
        out.add_node(b, R)
        new_bond = next(i for i in L.indices if i not in a_side)
        out.graph.add_edge(a, b, bond=new_bond)
        out.ortho_towards[_edge_key(a, b)] = b
        return out
