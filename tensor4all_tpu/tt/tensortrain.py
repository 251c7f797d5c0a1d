"""Tensor trains (MPS) over plain rank-3 cores.

JAX rebuild of tensor4all-simplett
(crates/tensor4all-simplett/src/tensortrain.rs:1-593 `TensorTrain`,
traits.rs:74-375 `AbstractTensorTrain`): a TT is a host list of rank-3
``jax.Array`` cores ``cores[k] : (r_{k-1}, d_k, r_k)`` with boundary ranks
1. All evaluation paths are batched device programs: point evaluation is a
chain of matvecs, batch evaluation gathers per-site core slices and runs a
batched matmul chain on the device — this is the kernel the reference runs
per-sample on CPU (tensortrain.rs `evaluate`) and the TCI hot loop
batches over.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _as_core(a) -> jnp.ndarray:
    # host numpy cores are kept as-is: they convert for free at any jit
    # boundary, while eager per-core jnp.asarray costs ~0.1 ms dispatch
    # each — which dominates CPU-class sweep workloads (see
    # compression._compress_np)
    if not isinstance(a, np.ndarray):
        a = jnp.asarray(a)
    if a.ndim != 3:
        raise ValueError(f"TT core must be rank-3, got shape {a.shape}")
    return a


@functools.partial(jax.jit, static_argnums=())
def _eval_batch_impl(cores: Tuple[jnp.ndarray, ...], idx: jnp.ndarray) -> jnp.ndarray:
    """Batched TT evaluation: idx (B, L) int -> values (B,)."""
    B = idx.shape[0]
    v = jnp.ones((B, 1), dtype=cores[0].dtype)
    for k, core in enumerate(cores):
        # gather (B, r_{k-1}, r_k) slices then batched matvec
        sl = jnp.take(core, idx[:, k], axis=1)  # (r0, B, r1)
        sl = jnp.moveaxis(sl, 1, 0)  # (B, r0, r1)
        v = jnp.einsum("bi,bij->bj", v, sl)
    return v[:, 0]


class TensorTrain:
    """Tensor train of rank-3 cores (ref simplett ``TensorTrain<T>``)."""

    def __init__(self, cores: Sequence[jnp.ndarray]):
        cores = [_as_core(c) for c in cores]
        if not cores:
            raise ValueError("TensorTrain needs at least one core")
        if cores[0].shape[0] != 1 or cores[-1].shape[-1] != 1:
            raise ValueError("boundary ranks must be 1")
        for a, b in zip(cores, cores[1:]):
            if a.shape[-1] != b.shape[0]:
                raise ValueError(
                    f"bond mismatch: {a.shape} -> {b.shape}"
                )
        self.cores: List[jnp.ndarray] = cores
        self._stacked_interior = None  # cached for uniform fast paths

    # ------------------------------------------------------------------
    # constructors (ref tensortrain.rs ctors)
    # ------------------------------------------------------------------
    @staticmethod
    def constant(local_dims: Sequence[int], value: float = 1.0, dtype=jnp.float64):
        """TT representing the constant function `value` (rank 1)."""
        L = len(local_dims)
        cores = [jnp.ones((1, d, 1), dtype=dtype) for d in local_dims]
        if L:
            cores[0] = cores[0] * value
        return TensorTrain(cores)

    @staticmethod
    def zeros(local_dims: Sequence[int], dtype=jnp.float64):
        return TensorTrain([jnp.zeros((1, d, 1), dtype=dtype) for d in local_dims])

    @staticmethod
    def random(key, local_dims: Sequence[int], rank: int, dtype=jnp.float64):
        """Random TT with (clamped) uniform internal rank."""
        L = len(local_dims)
        ranks = [1] + [rank] * (L - 1) + [1]
        # clamp ranks to representable sizes; the dim products are
        # capped at `rank` DURING accumulation (np.prod int64 silently
        # overflows past ~60 binary sites, producing negative shapes)
        def _capped_prod(dims, cap):
            p = 1
            for d in dims:
                p *= int(d)
                if p >= cap:
                    return cap
            return p

        for k in range(1, L):
            left = _capped_prod(local_dims[:k], ranks[k])
            right = _capped_prod(local_dims[k:], ranks[k])
            ranks[k] = min(ranks[k], left, right)
        keys = jax.random.split(key, L)
        cores = []
        for k in range(L):
            shape = (ranks[k], local_dims[k], ranks[k + 1])
            if jnp.issubdtype(dtype, jnp.complexfloating):
                kr, ki = jax.random.split(keys[k])
                real_dt = np.zeros(1, dtype).real.dtype
                c = (jax.random.normal(kr, shape, real_dt)
                     + 1j * jax.random.normal(ki, shape, real_dt)).astype(dtype)
            else:
                c = jax.random.normal(keys[k], shape, dtype)
            # plain-float divisor keeps weak typing (a numpy scalar would
            # silently promote f32 cores to f64 under x64)
            cores.append(c / float(np.sqrt(shape[0] * shape[2])))
        return TensorTrain(cores)

    @staticmethod
    def from_dense(a, tol: float = 0.0, maxdim: Optional[int] = None):
        """Exact (or tol-truncated) TT-SVD of a dense array."""
        from .compression import tt_svd_dense

        return tt_svd_dense(a, tol=tol, maxdim=maxdim)

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.cores)

    @property
    def local_dims(self) -> List[int]:
        return [int(c.shape[1]) for c in self.cores]

    @property
    def ranks(self) -> List[int]:
        """Internal bond dimensions (length L-1)."""
        return [int(c.shape[-1]) for c in self.cores[:-1]]

    @property
    def max_rank(self) -> int:
        return max(self.ranks, default=1)

    @property
    def dtype(self):
        return jnp.result_type(*[c.dtype for c in self.cores])

    def copy(self) -> "TensorTrain":
        return TensorTrain(list(self.cores))

    # ------------------------------------------------------------------
    # evaluation (ref tensortrain.rs `evaluate`, traits.rs)
    # ------------------------------------------------------------------
    def evaluate(self, idx: Sequence[int]):
        """Value at one multi-index."""
        out = self.evaluate_batch(np.asarray(idx, dtype=np.int32)[None, :])
        return out[0]

    def evaluate_batch(self, idx) -> jnp.ndarray:
        """Values at a batch of multi-indices: (B, L) -> (B,).

        Device-batched — the rebuild's answer to the reference's
        per-sample host evaluation; shard over devices via
        ``parallel.shard_batch_eval`` for multi-chip runs.
        """
        idx = jnp.asarray(idx)
        if idx.ndim != 2 or idx.shape[1] != len(self):
            raise ValueError(f"index batch must be (B, {len(self)})")
        B = idx.shape[0]
        try:
            on_cpu = jax.default_backend() == "cpu"
        except Exception:  # noqa: BLE001
            on_cpu = True
        if not on_cpu and B > 0:
            # bucket the batch axis: each distinct shape is an XLA
            # compile (seconds); padded index 0
            # rows are valid and sliced off after
            from ..tci.cached_function import _bucket_batch

            Bp = _bucket_batch(B)
            if Bp != B:
                idx = jnp.concatenate(
                    [idx, jnp.zeros((Bp - B, idx.shape[1]), idx.dtype)])
        out = _eval_batch_impl(tuple(self.cores), idx.astype(jnp.int32))
        return out[:B]

    def full_tensor(self) -> jnp.ndarray:
        """Dense tensor (test oracle; exponential — small sizes only)."""
        out = self.cores[0]  # (1, d0, r1)
        for c in self.cores[1:]:
            out = jnp.tensordot(out, c, axes=[[-1], [0]])
        return out[0, ..., 0]

    def sum(self):
        """Sum over all entries (ref traits.rs `sum`)."""
        v = jnp.ones((1,), dtype=self.dtype)
        for c in self.cores:
            v = v @ jnp.sum(c, axis=1)
        return v[0]

    def _padded_stack(self):
        """Zero-padded (L, c, d, c) stack of all cores (cached) — exact
        for transfer-matrix scans since padded rows/cols stay zero.
        None when sites have mixed physical dimensions."""
        if self._stacked_interior is None:
            dims = self.local_dims
            if len(set(dims)) != 1:
                self._stacked_interior = False
                return None
            c = max(self.max_rank, 1)
            d = dims[0]
            pads = []
            for core in self.cores:
                r0, _, r1 = core.shape
                pads.append(jnp.pad(core, ((0, c - r0), (0, 0),
                                           (0, c - r1))))
            self._stacked_interior = jnp.stack(pads)
        if self._stacked_interior is False:
            return None
        return self._stacked_interior

    def inner(self, other: "TensorTrain"):
        """<self|other> with conj on self, via transfer matrices.

        Equal-physical-dim trains run as ONE jitted scan program over a
        zero-padded core stack (the per-site host loop costs a dispatch
        per site otherwise)."""
        if self.local_dims != other.local_dims:
            raise ValueError("inner: local dims mismatch")
        if len(self) == len(other) and len(self) >= 2:
            sa = self._padded_stack()
            sb = other._padded_stack()
            if sa is not None and sb is not None:
                return _inner_stacked(sa, sb)
        E = jnp.ones((1, 1), dtype=jnp.result_type(self.dtype, other.dtype))
        for a, b in zip(self.cores, other.cores):
            # E (ra, rb); a (ra, d, ra'); b (rb, d, rb')
            E = jnp.einsum("ab,adx,bdy->xy", E, jnp.conj(a), b)
        return E[0, 0]

    def norm(self):
        return jnp.sqrt(jnp.real(self.inner(self)))

    def log_norm(self):
        """log ||tt|| computed stably by per-site rescaling."""
        acc = 0.0
        E = jnp.ones((1, 1), dtype=jnp.result_type(self.dtype))
        for a in self.cores:
            E = jnp.einsum("ab,adx,bdy->xy", E, jnp.conj(a), a)
            s = jnp.linalg.norm(E)
            E = E / s
            acc = acc + jnp.log(s)
        return 0.5 * (acc + jnp.log(jnp.real(E[0, 0])))

    # ------------------------------------------------------------------
    # arithmetic (ref tensortrain.rs +, scale, hadamard)
    # ------------------------------------------------------------------
    def __add__(self, other: "TensorTrain") -> "TensorTrain":
        if self.local_dims != other.local_dims:
            raise ValueError("add: local dims mismatch")
        L = len(self)
        if L == 1:
            return TensorTrain([self.cores[0] + other.cores[0]])
        # build the direct sum on the host when everything is concrete:
        # 3L jnp.concatenate dispatches cost ~15 ms at L=32 on CPU while
        # the numpy blocks are microseconds (tracers fall through)
        host = not any(isinstance(c, jax.core.Tracer)
                       for c in list(self.cores) + list(other.cores))
        xp = np if host else jnp
        dtype = jnp.result_type(self.dtype, other.dtype)
        out = []
        for k, (a, b) in enumerate(zip(self.cores, other.cores)):
            if host:
                a = np.asarray(a)
                b = np.asarray(b)
            ra0, d, ra1 = a.shape
            rb0, _, rb1 = b.shape
            if k == 0:
                c = xp.concatenate([a, b], axis=2).astype(dtype)
            elif k == L - 1:
                c = xp.concatenate([a, b], axis=0).astype(dtype)
            else:
                top = xp.concatenate(
                    [a, xp.zeros((ra0, d, rb1), dtype)], axis=2
                )
                bot = xp.concatenate(
                    [xp.zeros((rb0, d, ra1), dtype), b], axis=2
                )
                c = xp.concatenate([top, bot], axis=0)
            out.append(c)
        return TensorTrain(out)

    def __sub__(self, other: "TensorTrain") -> "TensorTrain":
        return self + other.scale(-1.0)

    def __mul__(self, s) -> "TensorTrain":
        return self.scale(s)

    __rmul__ = __mul__

    def axpby(self, a, x: "TensorTrain", b) -> "TensorTrain":
        """``a*x + b*self`` (TensorVectorSpace protocol — what puts TTs
        into the generic Krylov solvers, ref tensor_like.rs:579)."""
        return x.scale(a) + self.scale(b)

    def scale(self, s) -> "TensorTrain":
        out = list(self.cores)
        out[0] = out[0] * s
        return TensorTrain(out)

    __mul__ = scale
    __rmul__ = scale

    def hadamard(self, other: "TensorTrain") -> "TensorTrain":
        """Elementwise product; ranks multiply (ref hadamard)."""
        if self.local_dims != other.local_dims:
            raise ValueError("hadamard: local dims mismatch")
        out = []
        for a, b in zip(self.cores, other.cores):
            ra0, d, ra1 = a.shape
            rb0, _, rb1 = b.shape
            c = jnp.einsum("adx,bdy->abdxy", a, b).reshape(ra0 * rb0, d, ra1 * rb1)
            out.append(c)
        return TensorTrain(out)

    def conj(self) -> "TensorTrain":
        return TensorTrain([jnp.conj(c) for c in self.cores])

    def reverse(self) -> "TensorTrain":
        return TensorTrain([jnp.transpose(c, (2, 1, 0)) for c in self.cores[::-1]])

    # ------------------------------------------------------------------
    # compression (ref compression.rs) — delegates to tt.compression
    # ------------------------------------------------------------------
    def compress(self, tol: float = 1e-12, maxdim: Optional[int] = None,
                 method: str = "svd") -> "TensorTrain":
        from .compression import compress

        return compress(self, tol=tol, maxdim=maxdim, method=method)


@jax.jit
def _inner_stacked(sa, sb):
    """One-program transfer-matrix scan over zero-padded core stacks."""
    ca = sa.shape[1]
    cb = sb.shape[1]
    dtype = jnp.result_type(sa.dtype, sb.dtype)
    E = jnp.zeros((ca, cb), dtype).at[0, 0].set(1.0)

    def body(E, ab):
        a, b = ab
        return jnp.einsum("ab,adx,bdy->xy", E, jnp.conj(a), b), None

    E, _ = jax.lax.scan(body, E, (sa, sb))
    return E[0, 0]


def tt_from_function_samples(
    f=None,
    local_dims=None,
    batch_f=None,
    tol: float = 1e-8,
    maxdim: Optional[int] = None,
    **tci_kwargs,
) -> "TensorTrain":
    """Build a TT from a black-box function via TCI2 (the reference's
    from-samples entry; delegates to tci.crossinterpolate2)."""
    from ..tci.tensorci2 import TCI2Options, crossinterpolate2

    tci, _, _ = crossinterpolate2(
        f=f, local_dims=local_dims, batch_f=batch_f,
        options=TCI2Options(tol=tol, maxbonddim=maxdim, **tci_kwargs))
    return tci.to_tensortrain()


jax.tree_util.register_pytree_node(
    TensorTrain,
    lambda tt: (tuple(tt.cores), None),
    lambda aux, cores: TensorTrain(list(cores)),
)
