"""SiteIndexNetwork: topology + site-space bookkeeping without tensors.

JAX rebuild of tensor4all-treetn/src/site_index_network.rs:1-593
(inspired by ITensorNetworks.jl's IndsNetwork): an undirected tree graph
(networkx) plus a per-node set of physical (site) indices. This is the
structural contract restructure_to targets, operators validate against,
and networks compare with — independent of tensor values.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Set

import networkx as nx

from ..core.index import Index
from .network import TreeTN, NodeName


class SiteIndexNetwork:
    """Topology + site spaces (ref SiteIndexNetwork)."""

    def __init__(self):
        self.graph = nx.Graph()
        self._sites: Dict[NodeName, Set[Index]] = {}

    # ------------------------------------------------------------------
    @staticmethod
    def from_treetn(tn: TreeTN) -> "SiteIndexNetwork":
        out = SiteIndexNetwork()
        for v in tn.node_names:
            out.add_node(v, set(tn.site_indices(v)))
        for a, b in tn.graph.edges:
            out.add_edge(a, b)
        return out

    def add_node(self, name: NodeName,
                 sites: Optional[Iterable[Index]] = None) -> None:
        if name in self._sites:
            raise ValueError(f"node {name!r} already present")
        self.graph.add_node(name)
        self._sites[name] = set(sites or ())

    def has_node(self, name: NodeName) -> bool:
        return name in self._sites

    def rename_node(self, old: NodeName, new: NodeName) -> None:
        if old not in self._sites:
            raise KeyError(old)
        if new in self._sites:
            raise ValueError(f"node {new!r} already present")
        nx.relabel_nodes(self.graph, {old: new}, copy=False)
        self._sites[new] = self._sites.pop(old)

    def add_edge(self, a: NodeName, b: NodeName) -> None:
        if a not in self._sites or b not in self._sites:
            raise KeyError("both endpoints must exist")
        self.graph.add_edge(a, b)

    # ------------------------------------------------------------------
    def site_space(self, name: NodeName) -> Set[Index]:
        return set(self._sites[name])

    def set_site_space(self, name: NodeName,
                       sites: Iterable[Index]) -> None:
        if name not in self._sites:
            raise KeyError(name)
        self._sites[name] = set(sites)

    def add_site_index(self, name: NodeName, idx: Index) -> None:
        if self.contains_index(idx):
            raise ValueError(f"index {idx!r} already present")
        self._sites[name].add(idx)

    def remove_site_index(self, name: NodeName, idx: Index) -> bool:
        if idx in self._sites[name]:
            self._sites[name].discard(idx)
            return True
        return False

    def replace_site_index(self, name: NodeName, old: Index,
                           new: Index) -> None:
        if old not in self._sites[name]:
            raise KeyError(f"{old!r} not at node {name!r}")
        if old.dim != new.dim:
            raise ValueError("replacement index dimension mismatch")
        self._sites[name].discard(old)
        self._sites[name].add(new)

    def find_node_by_index(self, idx: Index) -> Optional[NodeName]:
        for v, s in self._sites.items():
            if idx in s:
                return v
        return None

    def contains_index(self, idx: Index) -> bool:
        return self.find_node_by_index(idx) is not None

    @property
    def node_names(self):
        return list(self._sites)

    def node_count(self) -> int:
        return len(self._sites)

    def edge_count(self) -> int:
        return self.graph.number_of_edges()

    def site_index_count(self) -> int:
        return sum(len(s) for s in self._sites.values())

    # ------------------------------------------------------------------
    # comparisons / compatibility (ref site_index_network.rs operator-
    # topology application + compatibility checks)
    # ------------------------------------------------------------------
    def same_topology(self, other: "SiteIndexNetwork") -> bool:
        if set(self.node_names) != set(other.node_names):
            return False
        mine = {frozenset(e) for e in self.graph.edges}
        theirs = {frozenset(e) for e in other.graph.edges}
        return mine == theirs

    def same_site_spaces(self, other: "SiteIndexNetwork") -> bool:
        return (set(self.node_names) == set(other.node_names)
                and all(self._sites[v] == other._sites[v]
                        for v in self._sites))

    def __eq__(self, other) -> bool:
        return (isinstance(other, SiteIndexNetwork)
                and self.same_topology(other)
                and self.same_site_spaces(other))

    def validate_tree(self) -> None:
        n = self.graph.number_of_nodes()
        if n and (not nx.is_connected(self.graph)
                  or self.graph.number_of_edges() != n - 1):
            raise ValueError("site index network is not a tree")

    def operator_compatible(self, op) -> bool:
        """True when a TreeOperator's input sites live on this network's
        nodes with matching placement (ref operator-compat checks)."""
        for v in op.node_names:
            if v not in self._sites:
                return False
            if op.site_in[v] not in self._sites[v]:
                return False
        return True
