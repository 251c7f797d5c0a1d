"""Linear operators (tree MPOs) on TreeTN states.

JAX rebuild of tensor4all-treetn/src/operator/
(linear_operator.rs:70 `LinearOperator`, apply.rs:300
`apply_linear_operator`, `ApplyOptions` :168-187): an operator is a TreeTN
on the same topology whose node tensors carry an (out, in) site pair —
out = in.prime() by convention — plus operator bonds on the edges.

Apply methods (ref ContractMethod): ``naive`` (exact, bond dims multiply),
``zipup`` (naive per-node contraction followed by an on-the-fly Euler-tour
truncation sweep), ``fit`` (variational — treetn.fit).
"""

from __future__ import annotations

from typing import Dict, Hashable, Optional, Tuple

import networkx as nx

from ..config import SvdTruncationPolicy
from ..core.contract import contract
from ..core.index import Index
from ..core.tensor import Tensor
from .network import TreeTN, NodeName, _edge_key


def _unprime_sites(t: Tensor, state: TreeTN, v: NodeName) -> Tensor:
    """Map every primed state-site index at node v back to its unprimed
    identity (operator outputs re-enter the input space; identity
    gap-fill nodes may carry several site pairs)."""
    for s in state.site_indices(v):
        sp = s.prime()
        if t.hasindex(sp):
            t = t.replaceind(sp, s)
    return t


class TreeOperator:
    """Tree MPO: TreeTN whose nodes map in-site -> out-site indices.

    `site_in[v]` / `site_out[v]` give the unprimed input index and the
    primed output index at node v (ref IndexMapping, linear_operator.rs).
    """

    def __init__(
        self,
        network: TreeTN,
        site_in: Dict[NodeName, Index],
        site_out: Dict[NodeName, Index],
    ):
        self.network = network
        self.site_in = dict(site_in)
        self.site_out = dict(site_out)
        for v in network.node_names:
            t = network.tensor(v)
            if not (t.hasindex(self.site_in[v]) and t.hasindex(self.site_out[v])):
                raise ValueError(f"operator node {v!r} missing site pair")

    def tensor(self, v: NodeName) -> Tensor:
        return self.network.tensor(v)

    @property
    def node_names(self):
        return self.network.node_names

    def transpose(self) -> "TreeOperator":
        """Swap in/out roles (ref linear_operator.rs transpose)."""
        net = self.network.copy()
        s_in, s_out = {}, {}
        for v in net.node_names:
            i, o = self.site_in[v], self.site_out[v]
            # swapping the two identities on the tensor transposes the
            # local matrix while keeping the same external in/out indices
            net.set_tensor(v, net.tensor(v).replaceinds([i, o], [o, i]))
            s_in[v], s_out[v] = i, o
        return TreeOperator(net, s_in, s_out)

    def conj(self) -> "TreeOperator":
        net = self.network.copy()
        for v in net.node_names:
            net.set_tensor(v, net.tensor(v).conj())
        return TreeOperator(net, self.site_in, self.site_out)

    def scale(self, s) -> "TreeOperator":
        net = self.network.copy()
        v0 = net.node_names[0]
        net.set_tensor(v0, net.tensor(v0) * s)
        return TreeOperator(net, self.site_in, self.site_out)

    # ------------------------------------------------------------------
    def to_dense_matrix(self, order=None):
        """Dense matrix oracle: rows = out sites, cols = in sites."""
        t = self.network.contract_to_tensor()
        names = order or sorted(self.node_names, key=repr)
        outs = [self.site_out[v] for v in names]
        ins = [self.site_in[v] for v in names]
        tt, (ro, ci) = t.fuse_indices([outs, ins])
        return tt.dense((ro, ci))

    # ------------------------------------------------------------------
    def rebind_inputs(self, new_in: Dict[NodeName, Index]) -> "TreeOperator":
        """Rebind the operator's input site indices to the given true
        indices (ref IndexMapping, operator/index_mapping.rs): the
        returned operator acts on states carrying ``new_in[v]`` and its
        outputs unprime back to them."""
        net = self.network.copy()
        s_in, s_out = {}, {}
        for v in net.node_names:
            old_i, old_o = self.site_in[v], self.site_out[v]
            t = net.tensor(v)
            if v in new_in and new_in[v] != old_i:
                ni = new_in[v]
                if ni.dim != old_i.dim:
                    raise ValueError(
                        f"rebind_inputs: dim mismatch at {v!r}")
                no = ni.prime()
                t = t.replaceinds([old_i, old_o], [ni, no])
                s_in[v], s_out[v] = ni, no
            else:
                s_in[v], s_out[v] = old_i, old_o
            net.set_tensor(v, t)
        return TreeOperator(net, s_in, s_out)

    def restructure_to(self, target_graph, target_nodes,
                       policy=None) -> "TreeOperator":
        """Restructure the operator's network to a target topology
        (ref linear_operator.rs restructure_to): `target_nodes[t]` lists
        the CURRENT operator nodes whose (in, out) site pairs move to
        target node `t`. Built on treetn.restructure.restructure_to with
        the site groups = the union of those nodes' in/out indices."""
        from .restructure import restructure_to

        target_sites = {}
        for t, group in target_nodes.items():
            s = set()
            for v in group:
                s.add(self.site_in[v])
                s.add(self.site_out[v])
            target_sites[t] = s
        net = restructure_to(self.network, target_graph, target_sites,
                             policy=policy)
        s_in, s_out = {}, {}
        for t, group in target_nodes.items():
            # one representative pair per target node (the first); the
            # remaining pairs ride along as extra site indices
            v0 = group[0]
            s_in[t], s_out[t] = self.site_in[v0], self.site_out[v0]
        return TreeOperator(net, s_in, s_out)

    def gap_fill(self, state: TreeTN) -> "TreeOperator":
        """Extend an operator defined on a node subset to the full state
        topology by filling identity nodes (ref operator/apply.rs:300
        gap-fill + identity.rs:12).

        Filled nodes act as the identity on every state site index there;
        edges outside the original operator get dimension-1 bonds. When
        the subset is NOT a connected subtree of the state graph
        (e.g. a 1-D operator on the x-sites of an interleaved 2-D
        quantics state), operator bonds are routed through pass-through
        identity nodes along the state-graph paths (the reference's
        Steiner-tree partial apply)."""
        sub = state.graph.subgraph(set(self.node_names))
        if len(self.node_names) == 0 or nx.is_connected(sub):
            return compose_exclusive([self], state)
        return route_gap_fill(self, state)

    def apply(
        self,
        state: TreeTN,
        method: str = "zipup",
        policy: Optional[SvdTruncationPolicy] = None,
        max_rank: Optional[int] = None,
        center: Optional[NodeName] = None,
    ) -> TreeTN:
        """Apply the operator to a state (ref apply_linear_operator :300).

        The state's site index at node v must equal ``site_in[v]``; the
        output state carries ``site_out[v]`` unprimed back to the input
        identity (so repeated application composes). Operators defined on
        a node *subset* are identity-gap-filled automatically.

        ``zipup`` is the one-pass truncating contraction
        (contraction.rs:268): peak bond never exceeds the policy cap.
        """
        op: TreeOperator = self
        if set(state.node_names) != set(self.node_names):
            if set(self.node_names) <= set(state.node_names):
                op = self.gap_fill(state)
            else:
                raise ValueError("apply: operator nodes not a subset of "
                                 "the state's")
        for v in state.node_names:
            if not state.tensor(v).hasindex(op.site_in[v]):
                raise ValueError(
                    f"state node {v!r} lacks operator input index "
                    f"{op.site_in[v]!r}"
                )
        if method == "fit":
            from .fit import fit_apply

            return fit_apply(op, state, policy)
        if method == "zipup":
            from .contraction import contract_zipup

            out = contract_zipup(op.network, state, center=center,
                                 policy=policy, max_rank=max_rank,
                                 prune_scalar_subtrees=False)
            for v in out.node_names:
                out.set_tensor(v, _unprime_sites(out.tensor(v), state, v))
            return out
        if method == "naive":
            out = self._apply_naive(op, state)
            return out
        raise ValueError(f"unknown apply method {method!r}")

    @staticmethod
    def _apply_naive(op: "TreeOperator", state: TreeTN) -> TreeTN:
        """Exact node-wise application; bond dims multiply (ref
        ApplyOptions::naive)."""
        out = TreeTN()
        fused_bond: Dict[Tuple, Index] = {}
        for v in state.node_names:
            x = state.tensor(v)
            w = op.tensor(v)
            y = contract([w, x])
            groups = []
            nbrs = list(state.neighbors(v))
            for nb in nbrs:
                ob = op.network.bond(v, nb)
                sb = state.bond(v, nb)
                groups.append([ob, sb])
            if groups:
                y, fresh = y.fuse_indices(groups)
                for nb, fi in zip(nbrs, fresh):
                    k = _edge_key(v, nb)
                    if k in fused_bond:
                        y = y.replaceind(fi, fused_bond[k])
                    else:
                        fused_bond[k] = fi
            y = _unprime_sites(y, state, v)
            out.add_node(v, y)
        for a, b in state.graph.edges:
            out.graph.add_edge(a, b, bond=fused_bond[_edge_key(a, b)])
        return out


def identity_operator_tensor(site_indices, bond_indices=(),
                             dtype=None) -> Tensor:
    """Identity node tensor: product of deltas over each (site', site)
    pair, outer-extended by the given dimension-1 bonds
    (ref operator/identity.rs:12 build_identity_operator_tensor)."""
    import numpy as np

    dtype = dtype or np.float64
    t: Optional[Tensor] = None
    for s in site_indices:
        eye = Tensor((s.prime(), s), np.eye(s.dim, dtype=dtype))
        t = eye if t is None else contract([t, eye], check_connected=False)
    if t is None:
        raise ValueError("identity node needs at least one site index")
    for b in bond_indices:
        if b.dim != 1:
            raise ValueError("identity extension bonds must be dim 1")
        ones = Tensor((b,), np.ones(1, dtype=dtype))
        t = contract([t, ones], check_connected=False)
    return t


def are_exclusive_operators(state: TreeTN, operators) -> bool:
    """Operators are exclusive iff vertex-disjoint and each forms a
    connected subtree of the state graph (ref compose.rs:36)."""
    node_sets = [set(op.node_names) for op in operators]
    for i in range(len(node_sets)):
        for j in range(i + 1, len(node_sets)):
            if node_sets[i] & node_sets[j]:
                return False
    for ns in node_sets:
        if not ns:
            continue
        if not ns <= set(state.node_names):
            return False
        sub = state.graph.subgraph(ns)
        if not nx.is_connected(sub):
            return False
    return True


def compose_exclusive(operators, state: TreeTN) -> TreeOperator:
    """Compose operators acting on non-overlapping node subsets into ONE
    operator on the full state topology (ref compose.rs:168
    compose_exclusive_linear_operators).

    Uncovered nodes become identities over the state's site indices
    there; edges outside the pieces get dimension-1 bonds.
    """
    import numpy as np

    if not are_exclusive_operators(state, operators):
        raise ValueError("compose_exclusive: operators overlap or are not "
                         "connected subtrees of the state")
    owner: Dict[NodeName, TreeOperator] = {}
    for op in operators:
        for v in op.node_names:
            owner[v] = op
    dtype = np.asarray(state.tensor(state.node_names[0]).data).dtype
    net = TreeTN()
    s_in: Dict[NodeName, Index] = {}
    s_out: Dict[NodeName, Index] = {}
    # dim-1 bonds for every state edge not internal to a piece
    edge_bond: Dict[Tuple, Index] = {}
    for a, b in state.graph.edges:
        k = _edge_key(a, b)
        if (a in owner and b in owner and owner[a] is owner[b]
                and owner[a].network.graph.has_edge(a, b)):
            edge_bond[k] = owner[a].network.bond(a, b)
        else:
            edge_bond[k] = Index(1, tags="OpLink")
    for v in state.node_names:
        extra = []
        for nb in state.neighbors(v):
            k = _edge_key(v, nb)
            op = owner.get(v)
            covered_edge = (op is not None and nb in owner
                            and owner[nb] is op
                            and op.network.graph.has_edge(v, nb))
            if not covered_edge:
                extra.append(edge_bond[k])
        if v in owner:
            op = owner[v]
            t = op.tensor(v)
            for b in extra:
                t = contract([t, Tensor((b,), np.ones(1, dtype=dtype))],
                             check_connected=False)
            net.add_node(v, t)
            s_in[v], s_out[v] = op.site_in[v], op.site_out[v]
        else:
            sites = list(state.site_indices(v))
            if not sites:
                raise ValueError(
                    f"compose_exclusive: node {v!r} has no site index to "
                    f"act on as identity")
            net.add_node(v, identity_operator_tensor(sites, extra, dtype))
            s_in[v], s_out[v] = sites[0], sites[0].prime()
    for a, b in state.graph.edges:
        net.graph.add_edge(a, b, bond=edge_bond[_edge_key(a, b)])
    return TreeOperator(net, s_in, s_out)


def route_gap_fill(op: TreeOperator, state: TreeTN) -> TreeOperator:
    """Steiner-tree gap fill (ref operator/apply.rs partial apply):
    extend ``op``, defined on a node subset that need NOT be connected
    in the state graph, to the full state topology. Every operator bond
    whose endpoints are not state-adjacent is routed along the unique
    state-graph path through pass-through identity nodes
    (identity on the sites x delta on the routed bond). State edges
    crossed by several routed bonds fuse them into one bond.
    """
    import numpy as np

    nodes = set(op.node_names)
    if not nodes <= set(state.node_names):
        raise ValueError("route_gap_fill: operator nodes not a subset "
                         "of the state's")
    dtype = np.asarray(state.tensor(state.node_names[0]).data).dtype

    tensors: Dict[NodeName, Tensor] = {v: op.tensor(v) for v in nodes}
    crossing: Dict[Tuple, list] = {_edge_key(a, b): []
                                   for a, b in state.graph.edges}
    deltas: Dict[NodeName, list] = {}   # node -> [(b_in, b_out), ...]

    for (u, w) in op.network.graph.edges:
        B = op.network.bond(u, w)
        path = nx.shortest_path(state.graph, u, w)
        hop = [B] + [Index(B.dim, tags="OpLink")
                     for _ in range(len(path) - 2)]
        for i in range(len(path) - 1):
            crossing[_edge_key(path[i], path[i + 1])].append(hop[i])
        for i in range(1, len(path) - 1):
            deltas.setdefault(path[i], []).append((hop[i - 1], hop[i]))
        if len(path) > 2:
            # w's tensor referenced B; it now connects to the last hop
            tensors[w] = tensors[w].replaceind(B, hop[-1])

    net = TreeTN()
    s_in: Dict[NodeName, Index] = {}
    s_out: Dict[NodeName, Index] = {}
    edge_bond: Dict[Tuple, Index] = {}

    # materialize node tensors (identity + pass-through deltas off-op)
    for v in state.node_names:
        if v in nodes:
            t = tensors[v]
            s_in[v], s_out[v] = op.site_in[v], op.site_out[v]
        else:
            sites = list(state.site_indices(v))
            if not sites:
                raise ValueError(
                    f"route_gap_fill: node {v!r} has no site index to "
                    f"act on as identity")
            t = identity_operator_tensor(sites, (), dtype)
            s_in[v], s_out[v] = sites[0], sites[0].prime()
        for b_in, b_out in deltas.get(v, ()):
            t = contract(
                [t, Tensor((b_in, b_out), np.eye(b_in.dim, dtype=dtype))],
                check_connected=False)
        tensors[v] = t

    # resolve per-state-edge bonds: 0 crossings -> dim-1; 1 -> as-is;
    # >1 -> fuse on both endpoint tensors (same order -> same layout)
    for a, b in state.graph.edges:
        k = _edge_key(a, b)
        bonds = crossing[k]
        if not bonds:
            e = Index(1, tags="OpLink")
            one = Tensor((e,), np.ones(1, dtype=dtype))
            tensors[a] = contract([tensors[a], one],
                                  check_connected=False)
            tensors[b] = contract([tensors[b], one],
                                  check_connected=False)
            edge_bond[k] = e
        elif len(bonds) == 1:
            edge_bond[k] = bonds[0]
        else:
            ta, (fa,) = tensors[a].fuse_indices([list(bonds)])
            tb, (fb,) = tensors[b].fuse_indices([list(bonds)])
            tensors[a] = ta
            tensors[b] = tb.replaceind(fb, fa)
            edge_bond[k] = fa

    for v in state.node_names:
        net.add_node(v, tensors[v])
    for a, b in state.graph.edges:
        net.graph.add_edge(a, b, bond=edge_bond[_edge_key(a, b)])
    return TreeOperator(net, s_in, s_out)


def mpo_to_treeoperator(mpo, site_indices, nodes=None) -> TreeOperator:
    """Chain MPO (tt.MPO rank-4 cores) -> TreeOperator.

    `site_indices[k]` is the state's site Index at node k; the operator
    maps it to `site_indices[k].prime()`. Node names default to
    0..L-1; pass `nodes` to bind the chain onto other state nodes
    (e.g. the x-sites of an interleaved 2-D quantics state — combine
    with the Steiner-tree `gap_fill`/`apply` for partial application).
    """
    L = len(mpo)
    names = list(nodes) if nodes is not None else list(range(L))
    if len(names) != L:
        raise ValueError("nodes must match the MPO length")
    net = TreeTN()
    bonds = [Index(int(mpo.cores[k].shape[-1]), tags="OpLink")
             for k in range(L - 1)]
    s_in, s_out = {}, {}
    for k in range(L):
        W = mpo.cores[k]  # (l, out, in, r)
        s = site_indices[k]
        sp = s.prime()
        if L == 1:
            data, inds = W[0, :, :, 0], (sp, s)
        elif k == 0:
            data, inds = W[0], (sp, s, bonds[0])
        elif k == L - 1:
            data, inds = W[..., 0], (bonds[k - 1], sp, s)
        else:
            data, inds = W, (bonds[k - 1], sp, s, bonds[k])
        net.add_node(names[k], Tensor(inds, data))
        s_in[names[k]], s_out[names[k]] = s, sp
    for k in range(L - 1):
        net.connect(names[k], names[k + 1], bonds[k])
    return TreeOperator(net, s_in, s_out)
