"""N-ary contraction engine.

JAX rebuild of the reference contraction choke point
(tensor4all-core/src/defaults/contract.rs:273 `contract`,
tensorbackend/src/tenferro_bridge.rs einsum path): axes are matched by
Index identity, lowered to one ``jnp.einsum`` call with opt_einsum path
optimization (the role omeco plays in the reference). XLA then maps every
pairwise contraction onto ``dot_general``s and fuses the elementwise
glue — the graph-compiler/buffer-pool caching of the reference's L0
(context.rs:73-85) is exactly XLA's compilation cache here.
"""

from __future__ import annotations

import threading

import numpy as _np
from typing import Iterable, Optional, Sequence

import jax
import jax.numpy as jnp
import opt_einsum

from ..config import env_flag
from .index import Index
from .tensor import Tensor

# Contraction-path cache keyed by (labels, shapes) — the role of the
# reference's persistent GraphCompiler plan cache (context.rs:73-85).
# opt_einsum path search is pure Python and dominates small-tensor sweeps
# if re-run per call; XLA separately caches the compiled executable.
_path_cache: dict = {}
_path_lock = threading.Lock()
_stats = {"hits": 0, "misses": 0}


def contract_path_cache_stats() -> dict:
    """Counters (ref T4A_PROFILE_CONTRACT env profiling, contract.rs:79)."""
    with _path_lock:
        return dict(_stats)


def _einsum_args(tensors, retain):
    """Build interleaved einsum arguments with integer axis labels.

    Output indices = indices appearing exactly once across operands, plus
    any retained indices (ref contract.rs `retain_indices`), in first-seen
    order.
    """
    label = {}
    counts = {}
    order = []
    for t in tensors:
        for i in t.indices:
            if i not in label:
                label[i] = len(label)
                order.append(i)
            counts[i] = counts.get(i, 0) + 1
    retained = set(retain) if retain else set()
    out_inds = tuple(
        i for i in order if counts[i] == 1 or i in retained
    )
    args = []
    for t in tensors:
        args.append(t.data)
        args.append([label[i] for i in t.indices])
    args.append([label[i] for i in out_inds])
    return args, out_inds


def _check_connected(tensors) -> None:
    """Reject disconnected networks (ref contract.rs:300 connectivity check);
    use `outer_product` for deliberate outer products."""
    n = len(tensors)
    if n <= 1:
        return
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    owner = {}
    for k, t in enumerate(tensors):
        for i in t.indices:
            if i in owner:
                ra, rb = find(owner[i]), find(k)
                parent[ra] = rb
            else:
                owner[i] = k
    roots = {find(k) for k in range(n)}
    if len(roots) != 1:
        raise ValueError(
            f"contract: network is disconnected ({len(roots)} components); "
            "use outer_product for deliberate outer products"
        )


_compiled_cache: dict = {}


def _contract_compiled(args, out_inds, tensors, path=None):
    """One jitted XLA einsum per (subscripts, shapes, dtypes) signature.

    For contraction signatures that recur many times with identical
    shapes (env refresh / local-operator builds in tree sweeps), a
    compiled program beats both eager jnp (per-op dispatch) and numpy
    (tensordot's transpose copies dominate at 5^k-sized intermediates):
    XLA fuses the transposes into the GEMMs. The compile cost (~100 ms)
    amortizes after a handful of calls. Hot expensive signatures are
    promoted here automatically by ``contract`` (r3: the star-hub apply
    ran 70x slower through numpy tensordot than through this path);
    callers can also opt in via ``contract(..., compile=True)``.
    """
    n = len(tensors)
    subs_in = []
    for k in range(n):
        subs_in.append("".join(opt_einsum.get_symbol(l)
                               for l in args[2 * k + 1]))
    subs_out = "".join(opt_einsum.get_symbol(l) for l in args[-1])
    expr = ",".join(subs_in) + "->" + subs_out
    ops = [t.data for t in tensors]
    key = (expr, tuple(tuple(o.shape) for o in ops),
           tuple(str(getattr(o, "dtype", None) or "f64") for o in ops))
    fn = _compiled_cache.get(key)
    if fn is None:
        # never let the traced einsum re-run path search with 'optimal'
        # at >5 operands (exhaustive DFS explodes); reuse the cached
        # dp/auto path when the caller has one
        opt = path if path is not None else (
            "optimal" if n <= 5 else _path_method(n))
        fn = jax.jit(lambda *xs: jnp.einsum(expr, *xs, optimize=opt))
        _compiled_cache[key] = fn
    return Tensor(out_inds, fn(*ops))


def _path_method(n_operands: int) -> str:
    """Path-search strategy by operand count: exhaustive only when tiny,
    dynamic-programming (near-optimal, poly-ish for trees) for the
    mid range, greedy beyond. r3: 'auto' fell back to greedy at >8
    operands and picked a path 2x the flops AND far worse constants on
    the star-hub apply (absorbing envs into theta instead of dressing
    the operator core)."""
    if n_operands <= 5:
        return "optimal"
    if n_operands <= 24:
        return "dp"
    return "auto"


# Promotion thresholds: a signature whose cached path costs at least
# _COMPILE_COST flops and whose CUMULATIVE eager work (hits x cost, a
# proxy for time at the ~2 GFLOP/s many-small-dim eager rate) exceeds
# _COMPILE_AMORTIZE is routed through a cached jitted XLA program
# (transposes fused into GEMMs) instead of numpy/eager dispatch.
# Fixed-shape tree sweeps (the star-hub apply: one signature, hundreds
# of hits) promote within the first sweep; adaptive-rank solvers
# (linsolve/TCI), whose signatures mutate every sweep and recur only
# O(krylov_iters) times each, spend at most ~0.3 s eager per signature
# and almost never pay the ~100 ms XLA compile (a flat hits>=3 rule
# here compiled ~200 one-off programs per linsolve run and tripled the
# N=38 journal row, r3 regression).
_COMPILE_COST = 1e6
_COMPILE_AMORTIZE = 6e8


def contract(
    tensors: Sequence[Tensor],
    *,
    retain: Optional[Iterable[Index]] = None,
    conj: Optional[Sequence[bool]] = None,
    check_connected: bool = True,
    optimize: Optional[object] = None,
    compile: bool = False,
) -> Tensor:
    """Contract a connected network of tensors over all shared indices.

    Args:
      tensors: operands; shared Index identities define the hyper-edges.
      retain: indices to keep in the output even though they are shared
        (ref contract.rs `retain_indices` — hyperedge semantics).
      conj: per-operand conjugation flags (ref conj flags in contract).
      check_connected: reject disconnected networks (ref behavior).
      optimize: opt_einsum path spec; default 'optimal' for <=5 operands
        else 'auto' (mirrors omeco time-optimized path choice,
        tenferro_bridge.rs:290-390).
    """
    tensors = list(tensors)
    if not tensors:
        raise ValueError("contract: empty operand list")
    if conj is not None:
        tensors = [t.conj() if c else t for t, c in zip(tensors, conj)]
    if len(tensors) == 1:
        t = tensors[0]
        shared = ()  # sum over nothing; single tensor passes through
        return t
    if check_connected:
        _check_connected(tensors)
    args, out_inds = _einsum_args(tensors, retain)
    if compile and not any(isinstance(t.data, jax.core.Tracer)
                           for t in tensors):
        return _contract_compiled(args, out_inds, tensors)
    cost = None
    hits = 0
    if optimize is None:
        # cached path lookup: labels + shapes fully determine the plan
        key = tuple(
            (tuple(args[2 * k + 1]), tensors[k].shape)
            for k in range(len(tensors))
        ) + (tuple(args[-1]),)
        entry = None
        with _path_lock:
            entry = _path_cache.get(key)
            if entry is not None:
                entry[2] += 1
                optimize, cost, hits = entry[0], entry[1], entry[2]
                _stats["hits"] += 1
        if optimize is None:


            method = _path_method(len(tensors))
            path_args = []
            for k in range(len(tensors)):
                # zero-cost stand-ins: contract_path only reads shapes
                path_args.append(_np.broadcast_to(_np.float32(0),
                                                  tensors[k].shape))
                path_args.append(args[2 * k + 1])
            path_args.append(args[-1])
            path, info = opt_einsum.contract_path(*path_args,
                                                  optimize=method)
            cost = float(info.opt_cost)
            entry = [path, cost, 1, None]
            with _path_lock:
                _path_cache[key] = entry
                _stats["misses"] += 1
            optimize = path
    concrete = not any(isinstance(t.data, jax.core.Tracer)
                       for t in tensors)
    if (concrete and cost is not None and cost >= _COMPILE_COST
            and hits * cost >= _COMPILE_AMORTIZE):
        # hot + expensive recurring signature: cached XLA program. The
        # jitted fn lives ON the path-cache entry so repeat calls skip
        # the per-call expr/key rebuild (~1 ms of Python that tripled
        # warm linsolve applies when this routed through the global
        # signature dict).
        fn = entry[3] if entry is not None and len(entry) > 3 else None
        if fn is None:
            n = len(tensors)
            subs_in = [
                "".join(opt_einsum.get_symbol(l) for l in args[2 * k + 1])
                for k in range(n)
            ]
            subs_out = "".join(opt_einsum.get_symbol(l) for l in args[-1])
            expr = ",".join(subs_in) + "->" + subs_out
            opt = optimize
            fn = jax.jit(lambda *xs: jnp.einsum(expr, *xs, optimize=opt))
            if entry is not None:
                while len(entry) < 4:
                    entry.append(None)
                entry[3] = fn
        data = fn(*(t.data for t in tensors))
        if all(isinstance(t.data, _np.ndarray)
                                   for t in tensors):
            # host-driven pipeline (numpy payloads end to end): hand the
            # result back as numpy, or every downstream vector op
            # (axpby/norm in GMRES) pays a per-op np->device conversion
            # on its mixed operands — measured ~1.4 s per warm N=38
            # linsolve sweep (r3 regression hunt)
            data = _np.asarray(data)
        return Tensor(out_inds, data)
    if _host_fast_case(tensors):
        # CPU-backend small-tensor fast path: one np.einsum avoids the
        # per-call XLA dispatch (~0.1 ms) that dominates host-driven
        # sweeps (treetn DMRG/TDVP/linsolve at chi <= 64). Never taken
        # under tracing (tracers fail the concrete-array check), so
        # jit/grad through contract() are untouched.


        np_args = list(args)
        for k in range(len(tensors)):
            np_args[2 * k] = _np.asarray(tensors[k].data)
        opt = optimize
        if (isinstance(opt, (list, tuple)) and opt
                and not isinstance(opt[0], str)):
            opt = ["einsum_path", *opt]   # numpy's explicit-path form
        data = _np.einsum(*np_args, optimize=opt)
        return Tensor(out_inds, data)
    data = jnp.einsum(*args, optimize=optimize)
    return Tensor(out_inds, data)


_HOST_FAST_ELEMS = 1 << 20  # 1M elements per operand: covers chi<=64 cores
# AND high-degree tree-operator centers (star Heisenberg: 5^7*4 = 312k);
# above this XLA:CPU wins on raw GEMM throughput


def _host_fast_case(tensors) -> bool:


    try:
        if jax.default_backend() != "cpu":
            return False
    except Exception:  # noqa: BLE001
        return False
    for t in tensors:
        d = t.data
        if isinstance(d, _np.ndarray):
            if d.size > _HOST_FAST_ELEMS:
                return False
            continue
        if isinstance(d, jax.core.Tracer) or not isinstance(d, jax.Array):
            return False  # abstract value: stay on the traceable path
        if d.size > _HOST_FAST_ELEMS:
            return False
    return True


def tensordot(a: Tensor, b: Tensor, **kw) -> Tensor:
    """Pairwise contraction over all shared indices (ref contract.rs:369)."""
    return contract([a, b], **kw)


def outer_product(a: Tensor, b: Tensor) -> Tensor:
    """Outer product of tensors with disjoint index sets (ref :381)."""
    if a.common_indices(b):
        raise ValueError("outer_product: operands share indices")
    return contract([a, b], check_connected=False)
