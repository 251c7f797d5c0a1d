"""Evaluators: single-point and device-batched TreeTN evaluation.

JAX rebuild of tensor4all-treetn/src/evaluator.rs (TreeTNEvaluator)
and cached_evaluator.rs:1-1866 (TreeTNCachedEvaluator — batch evaluation
with environment caching). Where the reference caches per-assignment
environment tensors host-side, this design vectorizes the whole
batch on device: each node's tensor is gathered at the batch's site values
and messages flow leaf-to-root as batched contractions (matmuls) — a
single jitted program per (topology, shapes) signature.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import networkx as nx
import numpy as np

from ..core.index import Index
from .network import TreeTN, NodeName


class TreeTNEvaluator:
    """Batched evaluator over a fixed TreeTN."""

    def __init__(self, tn: TreeTN, site_order: Sequence[Index]):
        tn.validate_tree()
        self.tn = tn
        self.site_order = list(site_order)
        # map site index -> (node, axis); precompute a postorder schedule
        owner: Dict[Index, NodeName] = {}
        for v in tn.node_names:
            for s in tn.site_indices(v):
                owner[s] = v
        for s in self.site_order:
            if s not in owner:
                raise KeyError(f"site index {s!r} not in network")
        self.owner = owner
        root = tn.node_names[0]
        self.root = root
        self.parent = dict(nx.dfs_predecessors(tn.graph, root))
        self.order = list(nx.dfs_postorder_nodes(tn.graph, root))
        # per node: (array, axes meta) with axes arranged as
        # (sites in site_order slice..., child bonds..., parent bond?)
        self._plan = []
        for v in self.order:
            t = tn.tensor(v)
            sites = [s for s in self.site_order if owner[s] == v]
            kids = [c for c, p in self.parent.items() if p == v]
            kid_bonds = [tn.bond(v, c) for c in kids]
            par_bond = [tn.bond(v, self.parent[v])] if v in self.parent else []
            t = t.permute(tuple(sites) + tuple(kid_bonds) + tuple(par_bond))
            self._plan.append(
                (v, t.data, len(sites),
                 [self.site_order.index(s) for s in sites], kids,
                 v in self.parent)
            )
        self._eval_jit = jax.jit(self._eval_impl)

    def _eval_impl(self, arrays: Tuple[jnp.ndarray, ...], idx: jnp.ndarray):
        B = idx.shape[0]
        msgs: Dict[NodeName, jnp.ndarray] = {}
        for (v, _, n_sites, site_pos, kids, has_parent), arr in zip(
            self._plan, arrays
        ):
            if n_sites:
                # advanced indexing over the leading site axes -> (B, bonds...)
                cur = arr[tuple(idx[:, sp] for sp in site_pos)]
            else:
                cur = jnp.broadcast_to(arr, (B,) + arr.shape)
            # contract child messages (B, chi_c) over the leading bond axes
            for c in kids:
                m = msgs.pop(c)
                cur = jnp.einsum("bc,bc...->b...", m, cur)
            msgs[v] = cur if has_parent else cur.reshape(B)
        return msgs[self.root]

    def evaluate_batch(self, idx) -> np.ndarray:
        idx = jnp.asarray(np.asarray(idx, dtype=np.int32))
        arrays = tuple(p[1] for p in self._plan)
        return np.asarray(self._eval_jit(arrays, idx))

    def evaluate(self, assignment: Dict[Index, int]):
        idx = np.asarray([[assignment[s] for s in self.site_order]])
        return self.evaluate_batch(idx)[0]


class TreeTNCachedEvaluator:
    """Batch evaluation with per-subtree environment caching and greedy
    center search (ref cached_evaluator.rs:1-1866).

    For batches with repeated sub-assignments on subtrees (the access
    pattern of tree-TCI pivot enumeration: one side fixed, the other
    scanned), each DISTINCT sub-assignment's environment is contracted
    once and memoized; the per-row combine at the center is one
    vectorized contraction. The center is chosen by greedy descent on
    the cache-cost model (sum over subtrees of distinct-key counts, ref
    GreedyCenterSearch), or pinned via `center`.
    """

    def __init__(self, tn: TreeTN, site_order: Sequence[Index],
                 center: NodeName = None,
                 initial_centers: Sequence[NodeName] = (),
                 max_greedy_steps: int = None):
        tn.validate_tree()
        self.tn = tn
        self.site_order = list(site_order)
        self.fixed_center = center
        self.initial_centers = list(initial_centers)
        self.max_greedy_steps = max_greedy_steps
        owner: Dict[Index, NodeName] = {}
        for v in tn.node_names:
            for s in tn.site_indices(v):
                owner[s] = v
        for s in self.site_order:
            if s not in owner:
                raise KeyError(f"site index {s!r} not in network")
        self.owner = owner
        # per directed edge (c -> p): subtree nodes on c's side + their
        # site positions in site_order (the interned cache key)
        g = tn.graph
        self._subtree_nodes: Dict[Tuple[NodeName, NodeName], list] = {}
        self._subtree_pos: Dict[Tuple[NodeName, NodeName], list] = {}
        for a, b in g.edges:
            for (c, p) in ((a, b), (b, a)):
                gg = g.copy()
                gg.remove_edge(c, p)
                nodes = list(nx.node_connected_component(gg, c))
                self._subtree_nodes[(c, p)] = nodes
                pos = [k for k, s in enumerate(self.site_order)
                       if owner[s] in nodes]
                self._subtree_pos[(c, p)] = pos
        # node-local metadata: site positions + permuted dense data,
        # arranged (sites..., neighbor bonds in sorted-neighbor order)
        self._node_sites: Dict[NodeName, list] = {}
        self._node_perm: Dict[NodeName, tuple] = {}
        for v in tn.node_names:
            sites = [s for s in self.site_order if owner[s] == v]
            self._node_sites[v] = [self.site_order.index(s)
                                   for s in sites]
            nbrs = list(tn.neighbors(v))
            perm = tuple(sites) + tuple(tn.bond(v, nb) for nb in nbrs)
            self._node_perm[v] = (np.asarray(
                tn.tensor(v).permute(perm).data), nbrs)
        self._env_cache: Dict[tuple, np.ndarray] = {}
        self.hits = 0
        self.misses = 0

    # -- environment of subtree c (toward p) at a concrete assignment --
    def _env(self, c: NodeName, p: NodeName, row: np.ndarray) -> np.ndarray:
        key = (c, p, tuple(int(row[k]) for k in self._subtree_pos[(c, p)]))
        env = self._env_cache.get(key)
        if env is not None:
            self.hits += 1
            return env
        self.misses += 1
        arr, nbrs = self._node_perm[c]
        sel = tuple(int(row[k]) for k in self._node_sites[c])
        cur = arr[sel]  # axes = neighbor bonds in `nbrs` order
        # move the parent bond last, then eat child axes front-to-back
        cur = np.moveaxis(cur, nbrs.index(p), -1)
        for nb in nbrs:
            if nb == p:
                continue
            e = self._env(nb, c, row)
            cur = np.tensordot(e, cur, axes=([0], [0]))
        self._env_cache[key] = cur  # (parent_bond,)
        return cur

    def center_cost(self, center: NodeName, idx: np.ndarray) -> int:
        """Cache-cost model: total distinct subtree keys at `center`."""
        cost = 0
        for nb in self.tn.neighbors(center):
            pos = self._subtree_pos[(nb, center)]
            if pos:
                cost += np.unique(idx[:, pos], axis=0).shape[0]
            else:
                cost += 1
        return cost

    def search_center(self, idx: np.ndarray) -> NodeName:
        """Greedy descent on the cost model (ref GreedyCenterSearch)."""
        starts = self.initial_centers or [self.tn.node_names[0]]
        best, best_cost = None, None
        for start in starts:
            cur, cur_cost = start, self.center_cost(start, idx)
            steps = 0
            while True:
                if (self.max_greedy_steps is not None
                        and steps >= self.max_greedy_steps):
                    break
                cands = [(self.center_cost(nb, idx), nb)
                         for nb in self.tn.neighbors(cur)]
                if not cands:
                    break
                c_cost, c_node = min(cands, key=lambda t: t[0])
                if c_cost >= cur_cost:
                    break
                cur, cur_cost = c_node, c_cost
                steps += 1
            if best_cost is None or cur_cost < best_cost:
                best, best_cost = cur, cur_cost
        return best

    def evaluate_batch(self, idx) -> np.ndarray:
        idx = np.asarray(idx, dtype=np.int64)
        center = self.fixed_center or self.search_center(idx)
        arr, nbrs = self._node_perm[center]
        B = idx.shape[0]
        sel = tuple(idx[:, k] for k in self._node_sites[center])
        cur = arr[sel] if sel else np.broadcast_to(arr, (B,) + arr.shape)
        # per-neighbor env matrices, interned over distinct subtree keys
        for j, nb in enumerate(nbrs):
            pos = self._subtree_pos[(nb, center)]
            if pos:
                uniq, inverse = np.unique(idx[:, pos], axis=0,
                                          return_inverse=True)
            else:
                uniq = np.zeros((1, 0), np.int64)
                inverse = np.zeros(B, np.int64)
            envs = []
            row = np.zeros(len(self.site_order), np.int64)
            for u in uniq:
                row[pos] = u
                envs.append(self._env(nb, center, row))
            E = np.stack(envs)[inverse]  # (B, chi)
            cur = np.einsum("bc,bc...->b...", E, cur)
        return cur.reshape(B)

    @property
    def cache_size(self) -> int:
        return len(self._env_cache)
