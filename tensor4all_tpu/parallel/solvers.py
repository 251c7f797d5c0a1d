"""Sharded solver kernels on real network states (SURVEY §5.8).

NEW relative to the reference (tensor4all-rs is single-process): the
two-site projected-operator apply — the chi^3 d^2 hot kernel of
DMRG/TDVP/linsolve local solves (ref linsolve/common/projected_operator.
rs:223, benchmarked in 2026-05-18-projected-apply.md) — partitioned over
a device mesh:

- theta and the left environment are sharded along the LEFT BOND (chi)
  axis; operator cores and the right environment are replicated.
- each device contracts its chi/n slice (the dominant chi^3 d^2 w work
  splits n ways, per-device memory for the Krylov vectors is chi^2 d^2/n),
- the partial results are combined with `psum_scatter` — the
  canonical matmul reduce-scatter pattern — leaving the output sharded
  exactly like the input, so Krylov iterations chain without resharding.

`ShardedThetaVS` supplies the matching VectorSpace (psum inner products)
so core.krylov Lanczos/GMRES run with vectors that LIVE sharded.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import default_mesh


@partial(jax.jit, static_argnames=("mesh", "axis"))
def two_site_apply_sharded(L, W1, W2, R, theta, mesh: Mesh,
                           axis: str = "x"):
    """y[a,s,t,b] = L[a,a',w] W1[w,s,s',w'] W2[w',t,t',w''] R[b,b',w'']
    theta[a',s',t',b'], chi-partitioned over `mesh`.

    ``L`` is sharded on its ket axis (1), ``theta`` on its left bond
    (0); the output is sharded on ITS left bond — same placement as the
    input, so repeated applies (Lanczos/GMRES) stay sharded end to end.
    Requires ``theta.shape[0] % mesh.size == 0``.
    """

    def body(Ll, W1l, W2l, Rl, thl):
        # Ll: (A, A'/n, w); thl: (A'/n, s', t', B')
        t1 = jnp.einsum("axw,xstb->awstb", Ll, thl)        # chi^3 d^2 w
        t2 = jnp.einsum("awstb,wzsv->azvtb", t1, W1l)
        t3 = jnp.einsum("azvtb,vutw->azuwb", t2, W2l)
        y = jnp.einsum("azuwb,Bbw->azuB", t3, Rl)          # (A, s, t, B)
        return jax.lax.psum_scatter(y, axis, scatter_dimension=0,
                                    tiled=True)

    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(None, axis, None), P(), P(), P(),
                  P(axis, None, None, None)),
        out_specs=P(axis, None, None, None),
    )(L, W1, W2, R, theta)


def place_two_site_operands(L, W1, W2, R, theta, mesh: Mesh,
                            axis: str = "x"):
    """Device_put the apply operands with their sharding layout."""
    Ls = jax.device_put(jnp.asarray(L),
                        NamedSharding(mesh, P(None, axis, None)))
    th = jax.device_put(jnp.asarray(theta),
                        NamedSharding(mesh, P(axis, None, None, None)))
    rep = NamedSharding(mesh, P())
    return (Ls, jax.device_put(jnp.asarray(W1), rep),
            jax.device_put(jnp.asarray(W2), rep),
            jax.device_put(jnp.asarray(R), rep), th)


class ShardedThetaVS:
    """VectorSpace over mesh-sharded two-site theta blocks: inner/norm
    ride `psum`, axpby/scale stay sharded elementwise. Plug
    into core.krylov gmres / hermitian_lanczos_lowest_eigenpair for
    local solves whose Krylov vectors never live on one device."""

    def __init__(self, mesh: Optional[Mesh] = None,
                 axis: Optional[str] = None):
        self.mesh = mesh or default_mesh(axis=axis or "x")
        self.axis = axis or self.mesh.axis_names[0]
        mesh_, ax = self.mesh, self.axis

        @jax.jit
        def _inner(a, b):
            def body(al, bl):
                return jax.lax.psum(jnp.vdot(al, bl), axis_name=ax)

            spec = P(ax, None, None, None)
            return jax.shard_map(body, mesh=mesh_,
                                 in_specs=(spec, spec),
                                 out_specs=P())(a, b)

        self._inner_jit = _inner

    def place(self, theta):
        return jax.device_put(
            jnp.asarray(theta),
            NamedSharding(self.mesh, P(self.axis, None, None, None)))

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


def sharded_tt_inner(a_cores, b_cores, mesh: Optional[Mesh] = None,
                     axis: Optional[str] = None):
    """<a|b> of two TTs with every interior bond SHARDED over the mesh
    (per-site cores sharded on their left-bond axis; XLA's GSPMD
    partitions each transfer-matrix GEMM and inserts the collectives).

    Returns (value, sharding_of_last_transfer) so callers can assert the
    intermediates really were distributed."""
    mesh = mesh or default_mesh(axis=axis or "x")
    axis = axis or mesh.axis_names[0]

    def shard_core(c):
        c = jnp.asarray(c)
        spec = P(axis if c.shape[0] % mesh.size == 0 and c.shape[0] > 1
                 else None, None, None)
        return jax.device_put(c, NamedSharding(mesh, spec))

    A = [shard_core(c) for c in a_cores]
    B = [shard_core(c) for c in b_cores]

    @jax.jit
    def chain(A, B):
        E = jnp.einsum("asx,bsy->axby", jnp.conj(A[0]), B[0])[0, :, 0, :]
        for ca, cb in zip(A[1:], B[1:]):
            E = jnp.einsum("xy,xsa,ysb->ab", E, jnp.conj(ca), cb)
        return E[0, 0]

    # trace once to observe the intermediate sharding GSPMD assigns
    val = chain(A, B)
    return val, A[len(A) // 2].sharding
