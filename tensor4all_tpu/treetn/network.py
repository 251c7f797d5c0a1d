"""Tree tensor networks over named nodes.

JAX rebuild of tensor4all-treetn
(crates/tensor4all-treetn/src/treetn/mod.rs:125 `TreeTN`, :238
`from_tensors`, named_graph.rs `NamedGraph`, site_index_network.rs): host
Python owns the topology (a networkx graph of named nodes, edges carrying
the shared bond Index) and the canonical-region state machine
(mod.rs:1252-1329); every numeric step is an XLA contraction/factorization
on the node payloads.

Canonical-form invariant (ref mod.rs:1035-1118): ``ortho_towards[edge]``
names the endpoint the edge's isometry points toward; the canonical region
is the set of nodes all edges point toward. ``verify_canonical`` replicates
the reference's ``verify_internal_consistency`` (:1780) as a debug check.
"""

from __future__ import annotations

from typing import Dict, Hashable, Iterable, List, Optional, Sequence, Set, Tuple

import jax.numpy as jnp
import networkx as nx
import numpy as np

from ..config import SvdTruncationPolicy
from ..core.contract import contract
from ..core.decomp import (
    Canonical,
    FactorizeAlg,
    factorize,
    svd_two,
)
from ..core.index import Index
from ..core.tensor import Tensor

NodeName = Hashable


def _edge_key(a: NodeName, b: NodeName) -> Tuple[NodeName, NodeName]:
    return (a, b) if repr(a) <= repr(b) else (b, a)


class TreeTN:
    """Tensors on named nodes of a tree; bond indices on edges."""

    def __init__(self):
        self.graph = nx.Graph()
        self._tensors: Dict[NodeName, Tensor] = {}
        self.ortho_towards: Dict[Tuple[NodeName, NodeName], NodeName] = {}
        # which factorization produced the current gauge (ref treetn
        # CanonicalForm tracking); None until the first canonicalize
        self.canonical_form: Optional[FactorizeAlg] = None

    # ------------------------------------------------------------------
    # construction (ref from_tensors :238, connect :401)
    # ------------------------------------------------------------------
    @staticmethod
    def from_tensors(named_tensors: Dict[NodeName, Tensor]) -> "TreeTN":
        """Auto-connect nodes by shared index identities."""
        tn = TreeTN()
        for name, t in named_tensors.items():
            tn.add_node(name, t)
        owners: Dict[Index, List[NodeName]] = {}
        for name, t in named_tensors.items():
            for i in t.indices:
                owners.setdefault(i, []).append(name)
        for idx, who in owners.items():
            if len(who) == 2:
                tn.connect(who[0], who[1], idx)
            elif len(who) > 2:
                raise ValueError(
                    f"index {idx!r} shared by {len(who)} tensors; trees allow 2"
                )
        return tn

    def add_node(self, name: NodeName, tensor: Tensor) -> None:
        if name in self._tensors:
            raise ValueError(f"duplicate node {name!r}")
        self._tensors[name] = tensor
        self.graph.add_node(name)

    def connect(self, a: NodeName, b: NodeName, bond: Index) -> None:
        if not self._tensors[a].hasindex(bond) or not self._tensors[b].hasindex(bond):
            raise ValueError(f"bond {bond!r} not present on both {a!r},{b!r}")
        self.graph.add_edge(a, b, bond=bond)

    def validate_tree(self) -> None:
        """Ref: validate_tree — connected and acyclic."""
        n = self.graph.number_of_nodes()
        if n == 0:
            raise ValueError("empty network")
        if not nx.is_connected(self.graph):
            raise ValueError("network is disconnected")
        if self.graph.number_of_edges() != n - 1:
            raise ValueError("network has cycles")

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    def tensor(self, name: NodeName) -> Tensor:
        return self._tensors[name]

    def set_tensor(self, name: NodeName, t: Tensor) -> None:
        if name not in self._tensors:
            raise KeyError(name)
        self._tensors[name] = t
        # replacing a tensor voids any isometry claim the OLD tensor
        # made (edges where `name` is oriented toward a neighbor);
        # claims about neighbors pointing toward `name` still hold
        for nb in self.graph.neighbors(name):
            k = _edge_key(name, nb)
            if self.ortho_towards.get(k) == nb:
                del self.ortho_towards[k]

    @property
    def node_names(self) -> List[NodeName]:
        return list(self._tensors)

    def __len__(self):
        return len(self._tensors)

    def neighbors(self, name: NodeName) -> List[NodeName]:
        return list(self.graph.neighbors(name))

    def bond(self, a: NodeName, b: NodeName) -> Index:
        return self.graph.edges[a, b]["bond"]

    def set_bond(self, a: NodeName, b: NodeName, bond: Index) -> None:
        self.graph.edges[a, b]["bond"] = bond

    def site_indices(self, name: NodeName) -> Tuple[Index, ...]:
        """Indices of `name` not used as bonds (the physical legs)."""
        bonds = {self.bond(name, nb) for nb in self.neighbors(name)}
        return tuple(i for i in self._tensors[name].indices if i not in bonds)

    def all_site_indices(self) -> Dict[NodeName, Tuple[Index, ...]]:
        return {n: self.site_indices(n) for n in self.node_names}

    def copy(self) -> "TreeTN":
        tn = TreeTN()
        tn.graph = self.graph.copy()
        tn._tensors = dict(self._tensors)
        tn.ortho_towards = dict(self.ortho_towards)
        tn.canonical_form = self.canonical_form
        return tn

    def sim_linkinds(self) -> "TreeTN":
        """Copy with fresh bond-index identities (ref treetn/mod.rs
        `sim_linkinds`): same dims/tags, new ids. Use before contracting
        a network with (a copy of) itself — with shared bond ids the
        node-wise contraction would sum over the bonds too."""
        out = self.copy()
        for u, v in list(out.graph.edges):
            old = out.bond(u, v)
            new = Index(old.dim, tags=old.tags, plev=old.plev)
            out.set_bond(u, v, new)
            for n in (u, v):
                out._tensors[n] = out._tensors[n].replaceind(old, new)
        return out

    @property
    def dtype(self):
        return jnp.result_type(*[t.dtype for t in self._tensors.values()])

    def max_bond_dim(self) -> int:
        return max(
            (self.bond(a, b).dim for a, b in self.graph.edges), default=1
        )

    # ------------------------------------------------------------------
    # canonical-region state machine (ref mod.rs:1252-1329)
    # ------------------------------------------------------------------
    def canonical_region(self) -> Optional[Set[NodeName]]:
        """Nodes every oriented edge points toward (None if untracked)."""
        if len(self.ortho_towards) != self.graph.number_of_edges():
            return None
        region = set(self.node_names)
        for (a, b), toward in self.ortho_towards.items():
            away = a if toward == b else b
            region.discard(away)
        return region or None

    def _set_ortho(self, a: NodeName, b: NodeName, toward: NodeName) -> None:
        self.ortho_towards[_edge_key(a, b)] = toward

    def verify_canonical(self, atol: float = 1e-10) -> None:
        """Debug check: every edge orientation's isometry actually holds.

        Ref: verify_internal_consistency (mod.rs:1780).
        """
        for (a, b), toward in self.ortho_towards.items():
            away = a if toward == b else b
            t = self._tensors[away]
            bond = self.bond(a, b)
            others = tuple(i for i in t.indices if i != bond)
            td = t.conj().replaceind(bond, bond.prime())
            g = contract([td, t], check_connected=False)
            eye = np.eye(bond.dim)
            got = np.asarray(g.dense((bond.prime(), bond)))
            if not np.allclose(got, eye, atol=atol):
                raise AssertionError(
                    f"edge {(a, b)} claims isometry toward {toward!r} "
                    f"but deviation is {np.abs(got - eye).max():.2e}"
                )

    # ------------------------------------------------------------------
    # canonicalization (ref canonicalize.rs:62,98)
    # ------------------------------------------------------------------
    def canonicalize(
        self,
        centers: Sequence[NodeName],
        form: FactorizeAlg = FactorizeAlg.QR,
        policy: Optional[SvdTruncationPolicy] = None,
    ) -> "TreeTN":
        """Orient all edges toward `centers` by QR (or LU/CI) sweeps.

        Processes nodes outward-in (BFS order reversed from the first
        center); each off-center node is factorized with the toward-center
        bond on the R side, Q stays, R is absorbed inward.
        """
        self.validate_tree()
        centers = list(centers)
        center = centers[0]
        # parent pointers toward center
        parent = dict(nx.bfs_predecessors(self.graph, center))
        order = list(nx.bfs_tree(self.graph, center))[::-1]  # leaves first
        center_set = set(centers)
        for node in order:
            if node in center_set or node not in parent:
                continue
            p = parent[node]
            t = self._tensors[node]
            bond = self.bond(node, p)
            left = tuple(i for i in t.indices if i != bond)
            Q, R, _ = factorize(
                t, left, alg=form, canonical=Canonical.LEFT, policy=policy
            )
            new_bond = Q.indices[-1]
            self._tensors[node] = Q
            self._tensors[p] = contract([R, self._tensors[p]])
            self.set_bond(node, p, new_bond)
            self._set_ortho(node, p, p)
        self.canonical_form = form
        return self

    # ------------------------------------------------------------------
    # truncation (ref truncate.rs:1-182)
    # ------------------------------------------------------------------
    def truncate(
        self,
        policy: Optional[SvdTruncationPolicy] = None,
        centers: Optional[Sequence[NodeName]] = None,
    ) -> "TreeTN":
        """Canonicalize then two-site SVD sweep over an Euler tour
        (consumes the shared local-update framework, ref truncate.rs +
        localupdate.rs TruncateUpdater)."""
        from .localupdate import (
            LocalUpdateSweepPlan,
            TruncateUpdater,
            apply_local_update_sweep,
        )

        self.validate_tree()
        root = (centers[0] if centers else self.node_names[0])
        self.canonicalize([root])
        plan = LocalUpdateSweepPlan.from_treetn(self, root, nsite=2)
        apply_local_update_sweep(self, plan, TruncateUpdater(policy))
        return self

    def _euler_edges(self, root: NodeName) -> List[Tuple[NodeName, NodeName]]:
        """Edges in DFS-visit order, each (from, to) as first entered —
        the sweep moves the center along this walk (ref localupdate.rs
        Euler tours)."""
        edges: List[Tuple[NodeName, NodeName]] = []

        def walk(u, par):
            for v in self.graph.neighbors(u):
                if v == par:
                    continue
                edges.append((u, v))
                walk(v, u)
                edges.append((v, u))

        walk(root, None)
        return edges

    def _two_site_truncate(
        self, a: NodeName, b: NodeName, policy: Optional[SvdTruncationPolicy]
    ) -> None:
        """Contract (a,b), SVD with truncation, center moves a -> b."""
        bond = self.bond(a, b)
        ta, tb = self._tensors[a], self._tensors[b]
        theta = contract([ta, tb])
        a_side = tuple(i for i in ta.indices if i != bond)
        L, R, _ = svd_two(theta, a_side, policy, canonical=Canonical.LEFT)
        new_bond = L.indices[-1]
        self._tensors[a] = L
        self._tensors[b] = R
        self.set_bond(a, b, new_bond)
        self._set_ortho(a, b, b)

    def move_center(self, target: NodeName) -> "TreeTN":
        """Move a tracked single-node canonical center to `target` by QR
        factorizations along the connecting path (exact gauge moves).
        Falls back to full canonicalization when no center is tracked."""
        region = self.canonical_region()
        if region is None or len(region) != 1:
            return self.canonicalize([target])
        (c,) = region
        if c == target:
            return self
        path = nx.shortest_path(self.graph, c, target)
        for x, y in zip(path, path[1:]):
            t = self._tensors[x]
            bond = self.bond(x, y)
            left = tuple(i for i in t.indices if i != bond)
            Q, R, _ = factorize(t, left, alg=FactorizeAlg.QR,
                                canonical=Canonical.LEFT)
            new_bond = Q.indices[-1]
            self._tensors[x] = Q
            self._tensors[y] = contract([R, self._tensors[y]])
            self.set_bond(x, y, new_bond)
            self._set_ortho(x, y, y)
        return self

    # ------------------------------------------------------------------
    # full contraction / inner products (ref contraction.rs:138, evaluator)
    # ------------------------------------------------------------------
    def contract_to_tensor(self) -> Tensor:
        """Contract the whole tree (DFS children-into-parent order)."""
        self.validate_tree()
        root = self.node_names[0]
        order = list(nx.dfs_postorder_nodes(self.graph, root))
        acc: Dict[NodeName, Tensor] = {}
        parent = dict(nx.dfs_predecessors(self.graph, root))
        for node in order:
            t = self._tensors[node]
            kids = [c for c, p in parent.items() if p == node]
            ops = [acc.pop(c) for c in kids if c in acc]
            if ops:
                t = contract([t] + ops)
            acc[node] = t
        return acc[root]

    def inner(self, other: "TreeTN") -> jnp.ndarray:
        """<self|other>: double-layer tree contraction by upward messages."""
        if set(self.node_names) != set(other.node_names):
            raise ValueError("inner: node sets differ")
        root = self.node_names[0]
        parent = dict(nx.dfs_predecessors(self.graph, root))
        order = list(nx.dfs_postorder_nodes(self.graph, root))
        msgs: Dict[NodeName, Tensor] = {}
        for node in order:
            ta = self._tensors[node].dag()
            tb = other._tensors[node]
            # rename bra bonds to primed copies to keep them separate
            for nb in self.neighbors(node):
                bond = self.bond(node, nb)
                ta = ta.replaceind(bond, bond.prime(1000))
            kids = [c for c, p in parent.items() if p == node]
            ops = [ta, tb] + [msgs.pop(c) for c in kids]
            msgs[node] = contract(ops, check_connected=False)
        return msgs[root].scalar()

    def norm(self) -> jnp.ndarray:
        # <x|x> can come out a hair negative for near-zero networks
        # built by cancelling direct sums (the linsolve verify metric's
        # f64 cancellation floor); clamp so norm is 0, not NaN
        return jnp.sqrt(jnp.maximum(jnp.real(self.inner(self)), 0.0))

    def scale(self, s) -> "TreeTN":
        out = self.copy()
        n0 = out.node_names[0]
        out._tensors[n0] = out._tensors[n0] * s
        return out

    # ------------------------------------------------------------------
    # addition (ref addition.rs direct-sum)
    # ------------------------------------------------------------------
    def add(self, other: "TreeTN") -> "TreeTN":
        """Direct-sum addition: matching topology and site indices."""
        from ..core.decomp import direct_sum

        if set(self.node_names) != set(other.node_names):
            raise ValueError("add: node sets differ")
        out = TreeTN()
        out.graph = nx.Graph()
        new_bonds: Dict[Tuple[NodeName, NodeName], Tuple[Index, Index, Index]] = {}
        for a, b in self.graph.edges:
            ba = self.bond(a, b)
            bb = other.bond(a, b)
            new_bonds[_edge_key(a, b)] = (ba, bb, None)
        for name in self.node_names:
            ta, tb = self._tensors[name], other._tensors[name]
            pairs = []
            for nb in self.neighbors(name):
                k = _edge_key(name, nb)
                ba, bb, created = new_bonds[k]
                pairs.append((ba, bb))
            t, fresh = direct_sum(ta, tb, pairs)
            # record the fresh index per edge (create once, reuse on the
            # second endpoint)
            for (nb, ni) in zip(self.neighbors(name), fresh):
                k = _edge_key(name, nb)
                ba, bb, created = new_bonds[k]
                if created is None:
                    new_bonds[k] = (ba, bb, ni)
                else:
                    t = t.replaceind(ni, created)
            out.add_node(name, t)
        for a, b in self.graph.edges:
            out.graph.add_edge(a, b, bond=new_bonds[_edge_key(a, b)][2])
        return out

    def __add__(self, other: "TreeTN") -> "TreeTN":
        return self.add(other)

    # ------------------------------------------------------------------
    # evaluation (ref evaluator.rs)
    # ------------------------------------------------------------------
    def evaluate(self, assignment: Dict[Index, int]) -> jnp.ndarray:
        """Value at fixed site-index assignment (single point)."""
        fixed = {}
        for name in self.node_names:
            t = self._tensors[name]
            for i in self.site_indices(name):
                if i not in assignment:
                    raise KeyError(f"missing assignment for {i!r}")
                t = t.select(i, assignment[i])
            fixed[name] = t
        root = self.node_names[0]
        parent = dict(nx.dfs_predecessors(self.graph, root))
        order = list(nx.dfs_postorder_nodes(self.graph, root))
        msgs: Dict[NodeName, Tensor] = {}
        for node in order:
            kids = [c for c, p in parent.items() if p == node]
            ops = [fixed[node]] + [msgs.pop(c) for c in kids]
            msgs[node] = contract(ops, check_connected=False) if len(ops) > 1 else ops[0]
        return msgs[root].scalar()


def random_treetn(
    key,
    topology: nx.Graph,
    site_dims: Dict[NodeName, Sequence[int]],
    bond_dim=2,
    dtype=jnp.float64,
) -> TreeTN:
    """Random TreeTN on the given topology (ref random.rs `random_treetn`).

    `bond_dim` is either a uniform int or a per-edge mapping keyed by
    ``(a, b)`` node pairs in either order (ref random.rs `LinkSpace::
    {Uniform, PerEdge}`).
    """
    import jax

    tn = TreeTN()
    bonds: Dict[Tuple[NodeName, NodeName], Index] = {}
    if isinstance(bond_dim, dict):
        per_edge = {_edge_key(a, b): int(v) for (a, b), v in bond_dim.items()}
        for a, b in topology.edges:
            k = _edge_key(a, b)
            if k not in per_edge:
                raise ValueError(f"no bond dim for edge {k}")
            bonds[k] = Index(per_edge[k], tags="Link")
    else:
        for a, b in topology.edges:
            bonds[_edge_key(a, b)] = Index(int(bond_dim), tags="Link")
    site_inds = {
        n: tuple(Index(d, tags="Site") for d in dims)
        for n, dims in site_dims.items()
    }
    keys = jax.random.split(key, topology.number_of_nodes())
    for k, n in zip(keys, topology.nodes):
        inds = list(site_inds[n]) + [
            bonds[_edge_key(n, nb)] for nb in topology.neighbors(n)
        ]
        tn.add_node(n, Tensor.random(k, inds, dtype=dtype))
    for a, b in topology.edges:
        tn.connect(a, b, bonds[_edge_key(a, b)])
    return tn, site_inds
