"""Device-mesh parallelism for tensor-network workloads.

This subsystem is NEW relative to the reference: tensor4all-rs is single
process (SURVEY.md §2.17) — its only parallelism is a CPU thread pool
inside the dense backend. The device-mesh equivalents (SURVEY.md §5.8),
on 1-D meshes shaped by the algorithm alone (the cards of one host are
joined all to all, so no axis is cheaper than another):

- **batch sharding**: the TCI hot loop (Pi-matrix fill = batched
  function evaluation over candidate indices) is embarrassingly parallel
  over the batch; we shard the batch axis over a 1-D mesh and let XLA
  partition the evaluation (replicated TT cores / closure constants,
  sharded index batches).
- **coarse distribution**: independent PartitionedTT patches and batched
  QTCI components distribute coarsely (parallel_map_patches).
- Distributed reductions (inner products for GMRES/Lanczos over sharded
  operands) ride `jax.lax.psum` inside `shard_map` — see
  `__graft_entry__.dryrun_multichip` for the compiled multi-chip path.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def default_mesh(n_devices: Optional[int] = None,
                 axis: str = "batch") -> Mesh:
    """1-D mesh over the first n available devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def shard_batch_eval(
    jax_batch_f: Callable,
    mesh: Optional[Mesh] = None,
    axis: str = "batch",
) -> Callable[[np.ndarray], np.ndarray]:
    """Wrap a jittable batched evaluator ``f((B, L) int) -> (B,)`` so the
    batch axis is sharded over the mesh.

    The batch is padded to a multiple of the mesh size (masked out after),
    placed with a NamedSharding, and evaluated by one jitted call — XLA
    partitions the gather/matmul chain across devices with no collectives
    on the forward path (the batch is independent).

    The result is a drop-in ``batch_f`` for tci.CachedFunction — i.e. the
    multi-chip TCI hot path.
    """
    mesh = mesh or default_mesh()
    n = mesh.devices.size
    jf = jax.jit(jax_batch_f)

    def batch_f(idx: np.ndarray) -> np.ndarray:
        from ..tci.cached_function import _bucket_batch

        idx = np.asarray(idx)
        B = idx.shape[0]
        if B == 0:
            return np.zeros((0,), dtype=np.float64)
        # bucket to a power of two rounded up to a mesh multiple: one
        # XLA compile per distinct batch shape costs seconds on real
        # chips, and TCI emits a new B at every bond update (for
        # power-of-two meshes the round-up is a no-op)
        target = _bucket_batch(max(B, n))
        target = ((target + n - 1) // n) * n
        pad = target - B
        if pad:
            idx = np.concatenate([idx, np.repeat(idx[-1:], pad, axis=0)])
        idx_dev = jax.device_put(
            jnp.asarray(idx), NamedSharding(mesh, P(axis, None))
        )
        out = jf(idx_dev)
        batch_f.last_out_sharding = out.sharding  # observability hook
        return np.asarray(out)[:B]

    batch_f.mesh = mesh
    batch_f.last_out_sharding = None
    return batch_f


def make_sharded_tt_batch_eval(tt, mesh: Optional[Mesh] = None):
    """Sharded batched evaluation of a TensorTrain (cores replicated,
    index batch sharded)."""
    cores = tuple(tt.cores)

    def f(idx):
        v = jnp.ones((idx.shape[0], 1), dtype=cores[0].dtype)
        for k, core in enumerate(cores):
            sl = jnp.moveaxis(jnp.take(core, idx[:, k], axis=1), 1, 0)
            v = jnp.einsum("bi,bij->bj", v, sl)
        return v[:, 0]

    return shard_batch_eval(f, mesh)


def sharded_gram(vectors: jnp.ndarray, mesh: Optional[Mesh] = None,
                 axis: str = "batch") -> jnp.ndarray:
    """Gram matrix of row vectors with the row axis sharded: per-device
    partial products reduced with psum (the collective pattern
    distributed Krylov inner products use)."""
    mesh = mesh or default_mesh()

    @jax.jit
    def gram(v):
        def body(v_local):
            return jax.lax.psum(
                jnp.einsum("bi,bj->ij", jnp.conj(v_local), v_local),
                axis_name=axis,
            )

        return jax.shard_map(
            body, mesh=mesh, in_specs=(P(axis, None),), out_specs=P()
        )(v)

    v_dev = jax.device_put(vectors, NamedSharding(mesh, P(axis, None)))
    return gram(v_dev)


def shard_vector(x, mesh: Optional[Mesh] = None, axis: str = "batch"):
    """Place a vector (axis 0 sharded) on the mesh."""
    mesh = mesh or default_mesh()
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(axis)))


class ShardedArrayVS:
    """Krylov VectorSpace over mesh-sharded 1-D arrays: inner products
    and norms are per-device partial reductions combined with `psum`
    (SURVEY.md §5.8); axpby/scale stay sharded elementwise.

    Plug into core.krylov.gmres / hermitian_lanczos_lowest_eigenpair to
    run distributed Krylov solves (VERDICT r1 #8)."""

    def __init__(self, mesh: Optional[Mesh] = None, axis: str = "batch"):
        self.mesh = mesh or default_mesh()
        self.axis = axis

        @jax.jit
        def _inner(a, b):
            def body(al, bl):
                return jax.lax.psum(jnp.vdot(al, bl), axis_name=axis)

            return jax.shard_map(body, mesh=self.mesh,
                                 in_specs=(P(axis), P(axis)),
                                 out_specs=P())(a, b)

        self._inner_jit = _inner

    def axpby(self, a, x, b, y):
        return a * x + b * y

    def inner(self, x, y):
        return complex(self._inner_jit(x, y))

    def norm(self, x) -> float:
        return float(np.sqrt(np.real(self._inner_jit(x, x))))

    def scale(self, a, x):
        return a * x

    def post(self, x):
        return x


def parallel_map_patches(fn: Callable, items: Sequence,
                         n_workers: Optional[int] = None) -> list:
    """Coarse work distribution over independent items:
    each item's host-driven loop runs in its own thread, so device work
    from different patches interleaves. Ref embarrassingly-parallel
    patches (partitionedtt patching.rs) / batched QTCI components."""
    import concurrent.futures as cf

    n = n_workers or min(len(items), 8)
    if len(items) <= 1 or n <= 1:
        return [fn(it) for it in items]
    with cf.ThreadPoolExecutor(max_workers=n) as ex:
        return list(ex.map(fn, items))
