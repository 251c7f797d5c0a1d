"""Topology restructuring: fuse, split, and site-index swaps.

JAX rebuild of tensor4all-treetn/src/restructure/
(mod.rs:1-2048 plan-first restructuring, transform.rs:1-998 `fuse_to`/
`split_to` with Steiner-tree regions, swap.rs:1-589 scheduled site swaps).
Operations mutate a copy and return it; numerics are single contractions
or factorizations per step.
"""

from __future__ import annotations

from typing import Optional, Sequence, Set, Tuple

import networkx as nx

from ..config import SvdTruncationPolicy
from ..core.contract import contract
from ..core.decomp import Canonical, FactorizeAlg, factorize, svd_two
from ..core.index import Index
from .network import TreeTN, NodeName


def steiner_nodes(tn: TreeTN, nodes: Sequence[NodeName]) -> Set[NodeName]:
    """Minimal connected subtree containing `nodes`
    (ref transform.rs:27 `steiner_tree_indices`; exact on trees)."""
    nodes = list(nodes)
    out: Set[NodeName] = set(nodes)
    for a, b in zip(nodes, nodes[1:]):
        out.update(nx.shortest_path(tn.graph, a, b))
    return out


def fuse_to(tn: TreeTN, nodes: Sequence[NodeName],
            new_name: Optional[NodeName] = None) -> TreeTN:
    """Contract the Steiner subtree of `nodes` into one node
    (ref fuse_to, transform.rs)."""
    out = tn.copy()
    region = steiner_nodes(out, nodes)
    if not region:
        raise ValueError("empty fuse region")
    name = new_name if new_name is not None else sorted(region, key=repr)[0]
    t = contract([out.tensor(v) for v in region], check_connected=False) \
        if len(region) > 1 else out.tensor(next(iter(region)))
    # external edges of the region
    ext = []
    for v in region:
        for nb in out.neighbors(v):
            if nb not in region:
                ext.append((nb, out.bond(v, nb)))
    g = out.graph
    for v in region:
        g.remove_node(v)
        del out._tensors[v]
    out.ortho_towards = {}
    out.add_node(name, t)
    for nb, bond in ext:
        g.add_edge(name, nb, bond=bond)
    return out


def split_node(
    tn: TreeTN,
    node: NodeName,
    left_indices: Sequence[Index],
    left_name: NodeName,
    right_name: NodeName,
    policy: Optional[SvdTruncationPolicy] = None,
    alg: FactorizeAlg = FactorizeAlg.SVD,
) -> TreeTN:
    """Factorize `node` into two connected nodes; `left_indices` (site
    and/or bond indices of the node) go to the left factor
    (ref split_to, transform.rs)."""
    out = tn.copy()
    t = out.tensor(node)
    left_indices = tuple(left_indices)
    for i in left_indices:
        if not t.hasindex(i):
            raise KeyError(f"{i!r} not on node {node!r}")
    L, R, _ = factorize(t, left_indices, alg=alg,
                        canonical=Canonical.LEFT, policy=policy)
    new_bond = L.indices[-1]
    nbrs = [(nb, out.bond(node, nb)) for nb in out.neighbors(node)]
    g = out.graph
    g.remove_node(node)
    del out._tensors[node]
    out.ortho_towards = {}
    out.add_node(left_name, L)
    out.add_node(right_name, R)
    g.add_edge(left_name, right_name, bond=new_bond)
    lset = set(left_indices)
    for nb, bond in nbrs:
        target = left_name if bond in lset else right_name
        g.add_edge(target, nb, bond=bond)
    return out


def move_indices(
    tn: TreeTN,
    a: NodeName,
    b: NodeName,
    indices: Sequence[Index],
    policy: Optional[SvdTruncationPolicy] = None,
) -> TreeTN:
    """Move the given indices (sites or dangling bonds of `a`) across the
    edge (a, b) — one two-site contraction + factorization (the scheduled
    transport primitive of ref restructure/swap.rs)."""
    out = tn.copy()
    if b not in out.neighbors(a):
        raise ValueError("move_indices requires adjacent nodes")
    idxset = set(indices)
    ta = out.tensor(a)
    for i in idxset:
        if not ta.hasindex(i):
            raise KeyError(f"{i!r} not on node {a!r}")
    bond = out.bond(a, b)
    if bond in idxset:
        raise ValueError("cannot move the connecting bond itself")
    theta = contract([ta, out.tensor(b)])
    a_side = tuple(i for i in ta.indices if i != bond and i not in idxset)
    L, R, _ = svd_two(theta, a_side, policy, canonical=Canonical.LEFT)
    out.set_tensor(a, L)
    out.set_tensor(b, R)
    out.set_bond(a, b, L.indices[-1])
    # a moved index may itself be a bond of the tree: re-point its edge
    for i in idxset:
        for x in list(out.neighbors(a)):
            if x != b and out.bond(a, x) == i:
                out.graph.remove_edge(a, x)
                out.graph.add_edge(b, x, bond=i)
                break
    out.ortho_towards = {}
    return out


def restructure_to(
    tn: TreeTN,
    target_graph: nx.Graph,
    target_sites,
    policy: Optional[SvdTruncationPolicy] = None,
) -> TreeTN:
    """Plan-first restructuring to an arbitrary target topology
    (ref restructure/mod.rs:1306 `restructure_to`, transport phase of
    swap.rs, split/fuse phases of transform.rs).

    `target_graph` is the desired tree; `target_sites[t]` is the set of
    site Index objects each target node must carry (a partition of the
    current network's site indices).

    Plan: process target nodes in post-order from an arbitrary target
    root; for each node, ROUTE its sites (and bonds to already-carved
    target children) to a single host via scheduled adjacent moves, then
    SPLIT the host so the carved node detaches with exactly its target
    payload. The remainder becomes the target root. Each step is one
    two-site factorization; `policy` bounds transport bond growth.
    """
    target_sites = {t: set(s) for t, s in target_sites.items()}
    if set(target_graph.nodes) != set(target_sites):
        raise ValueError("target_sites must cover every target node")
    all_sites = set()
    for v in tn.node_names:
        all_sites.update(tn.site_indices(v))
    want = set()
    for s in target_sites.values():
        if s & want:
            raise ValueError("target site groups overlap")
        want |= s
    if want != all_sites:
        raise ValueError("target site groups must partition the sites")
    if target_graph.number_of_nodes() > 1 and not nx.is_tree(target_graph):
        raise ValueError("target must be a tree")

    work = tn.copy()
    work.ortho_towards = {}
    t_root = next(iter(target_graph.nodes))
    t_parent = dict(nx.bfs_predecessors(target_graph, t_root)) \
        if target_graph.number_of_nodes() > 1 else {}
    post = list(nx.dfs_postorder_nodes(target_graph, t_root))

    loc: dict = {}  # index -> last known node (verified before use)

    def node_of(idx: Index) -> NodeName:
        # never pick a finalized (carved) node: routing through one would
        # corrupt its target payload
        v = loc.get(idx)
        if (v is not None and v not in final_names
                and work.graph.has_node(v) and work.tensor(v).hasindex(idx)):
            return v
        for v in work.node_names:
            if v in final_names:
                continue
            if work.tensor(v).hasindex(idx):
                loc[idx] = v
                return v
        raise KeyError(f"index {idx!r} not found")

    def route(idx: Index, dest: NodeName) -> None:
        nonlocal work
        src = node_of(idx)
        if src == dest:
            return
        # the tree topology is invariant under move_indices (only node
        # payloads change), so one shortest-path query serves every hop
        # (ref batches moves into scheduled swap plans, swap.rs)
        path = nx.shortest_path(work.graph, src, dest)
        for nxt in path[1:]:
            work = move_indices(work, src, nxt, [idx], policy)
            src = nxt
        loc[idx] = dest

    carved_bond: dict = {}  # target name -> bond Index linking to remainder
    final_names: dict = {}  # work node -> target name
    for t in post:
        if t == t_root:
            continue
        payload = set(target_sites[t])
        child_bonds = [carved_bond[c] for c in target_graph.neighbors(t)
                       if c != t_parent.get(t) and c in carved_bond]
        anchors = list(payload) + child_bonds
        if not anchors:
            raise ValueError(f"target node {t!r} has no sites and no "
                             f"children — cannot be carved")
        # host: the work node already holding the first anchor
        host = node_of(anchors[0])
        for idx in anchors[1:]:
            route(idx, host)
            host = node_of(anchors[0])
        # detach: left = payload + child bonds; right = remainder
        left = tuple(anchors)
        host_t = work.tensor(host)
        remainder_inds = [i for i in host_t.indices if i not in set(left)]
        if not remainder_inds:
            raise ValueError(
                f"carving {t!r} leaves the host with no remainder legs — "
                f"the target root's subtree would disconnect")
        tmp_name = ("__carve__", t)
        work = split_node(work, host, left, tmp_name, host, policy=policy)
        carved_bond[t] = work.bond(tmp_name, host)
        final_names[tmp_name] = t
    # remainder: fuse whatever is left (uncarved work nodes) into t_root
    leftover = [v for v in work.node_names if v not in final_names]
    if len(leftover) > 1:
        work = fuse_to(work, leftover, new_name=("__carve__", t_root))
        final_names[("__carve__", t_root)] = t_root
    else:
        final_names[leftover[0]] = t_root

    out = TreeTN()
    for v, t in final_names.items():
        out.add_node(t, work.tensor(v))
    for a, b in work.graph.edges:
        out.graph.add_edge(final_names[a], final_names[b],
                           bond=work.bond(a, b))
    # structural check: carved adjacency must equal the target tree
    got = {frozenset((a, b)) for a, b in out.graph.edges}
    wanted = {frozenset((a, b)) for a, b in target_graph.edges}
    if got != wanted:
        raise ValueError(
            f"restructure_to: produced topology {sorted(map(tuple, got), key=repr)} "
            f"!= target {sorted(map(tuple, wanted), key=repr)}")
    out.validate_tree()
    return out


def swap_site_indices(
    tn: TreeTN,
    a: NodeName,
    b: NodeName,
    policy: Optional[SvdTruncationPolicy] = None,
) -> TreeTN:
    """Swap the site indices of two ADJACENT nodes (ref swap.rs): contract
    the pair and re-split with the groups exchanged. Long-range moves
    chain adjacent swaps (ref scheduled swap steps)."""
    out = tn.copy()
    if b not in out.neighbors(a):
        raise ValueError("swap requires adjacent nodes")
    bond = out.bond(a, b)
    sites_a = out.site_indices(a)
    sites_b = out.site_indices(b)
    theta = contract([out.tensor(a), out.tensor(b)])
    # new a-side: a's outer bonds + b's former sites
    a_side = tuple(i for i in out.tensor(a).indices
                   if i != bond and i not in sites_a) + sites_b
    L, R, _ = svd_two(theta, a_side, policy, canonical=Canonical.LEFT)
    out.set_tensor(a, L)
    out.set_tensor(b, R)
    out.set_bond(a, b, L.indices[-1])
    out.ortho_towards = {}
    return out
