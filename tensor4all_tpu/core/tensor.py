"""Dynamic-rank tensor keyed by identity-carrying indices.

JAX rebuild of the reference's ``TensorDynLen``
(tensor4all-core/src/defaults/tensordynlen.rs:457: Vec<DynIndex> +
Arc<Storage>): here a tuple of :class:`Index` labels the axes of a dense
``jax.Array``. The host keeps only the index bookkeeping; all numerics are
XLA ops, and ``Tensor`` is a registered pytree (indices as static aux data)
so tensors flow through ``jax.jit`` / ``jax.grad`` unchanged — JAX's AD
replaces the reference's tenferro-ad payloads
(tensordynlen.rs:2043-2146 enable_grad/backward/grad/detach).
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from .index import Index

Scalar = Union[int, float, complex]


class Tensor:
    """Dense tensor with named axes.

    ``data.shape[k] == indices[k].dim`` always holds. Axis order is an
    internal detail: all operations match axes by Index identity.
    """

    __slots__ = ("indices", "data")

    def __init__(self, indices: Sequence[Index], data):
        indices = tuple(indices)
        # host numpy payloads are kept as-is: they convert for free at
        # any jit boundary, while an eager jnp.asarray here costs a
        # dispatch (~0.1 ms) per tensor — the dominant cost of
        # host-driven sweeps at CPU-class sizes (journal workloads)
        if not isinstance(data, np.ndarray):
            data = jnp.asarray(data)
        if data.ndim != len(indices):
            raise ValueError(
                f"rank mismatch: {len(indices)} indices vs data.ndim={data.ndim}"
            )
        for k, (i, d) in enumerate(zip(indices, data.shape)):
            if i.dim != d:
                raise ValueError(
                    f"axis {k}: index dim {i.dim} != data dim {d} "
                    f"(index {i!r}, shape {data.shape})"
                )
        if len(set(indices)) != len(indices):
            raise ValueError(f"duplicate indices in tensor: {indices}")
        self.indices = indices
        self.data = data

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------
    @staticmethod
    def zeros(indices: Sequence[Index], dtype=jnp.float64) -> "Tensor":
        indices = tuple(indices)
        return Tensor(indices, jnp.zeros([i.dim for i in indices], dtype=dtype))

    @staticmethod
    def ones(indices: Sequence[Index], dtype=jnp.float64) -> "Tensor":
        indices = tuple(indices)
        return Tensor(indices, jnp.ones([i.dim for i in indices], dtype=dtype))

    @staticmethod
    def random(key, indices: Sequence[Index], dtype=jnp.float64) -> "Tensor":
        """Gaussian random tensor (ref tensordynlen random ctors)."""
        indices = tuple(indices)
        shape = [i.dim for i in indices]
        if jnp.issubdtype(dtype, jnp.complexfloating):
            kr, ki = jax.random.split(key)
            real_dt = jnp.finfo(dtype).dtype.type(0).real.dtype
            data = (
                jax.random.normal(kr, shape, dtype=real_dt)
                + 1j * jax.random.normal(ki, shape, dtype=real_dt)
            ).astype(dtype)
        else:
            data = jax.random.normal(key, shape, dtype=dtype)
        return Tensor(indices, data)

    @staticmethod
    def delta(i: Index, j: Index, dtype=jnp.float64) -> "Tensor":
        """Identity (Kronecker delta) between two indices (ref `delta`)."""
        if i.dim != j.dim:
            raise ValueError("delta requires equal dims")
        return Tensor((i, j), jnp.eye(i.dim, dtype=dtype))

    @staticmethod
    def onehot(index: Index, pos: int, dtype=jnp.float64) -> "Tensor":
        """Rank-1 basis vector e_pos (ref `onehot`)."""
        return Tensor((index,), jnp.zeros(index.dim, dtype).at[pos].set(1))

    @staticmethod
    def diag(values, i: Index, j: Index) -> "Tensor":
        """Diagonal matrix tensor from a vector of values (ref diag storage).

        The reference keeps a structured diagonal Storage
        (tensorbackend/src/storage.rs `axis_classes`); here we materialize
        dense — XLA fuses the construction and bond dims here are O(chi).
        """
        values = jnp.asarray(values)
        if i.dim != j.dim or values.shape != (i.dim,):
            raise ValueError("diag requires matching dims")
        return Tensor((i, j), jnp.diag(values))

    @staticmethod
    def from_scalar(value: Scalar, dtype=None) -> "Tensor":
        arr = jnp.asarray(value, dtype=dtype)
        return Tensor((), arr)

    # ------------------------------------------------------------------
    # basic queries
    # ------------------------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.indices)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape)

    def hasindex(self, index: Index) -> bool:
        return index in self.indices

    def axis(self, index: Index) -> int:
        try:
            return self.indices.index(index)
        except ValueError:
            raise KeyError(f"index {index!r} not in tensor {self.indices}")

    def common_indices(self, other: "Tensor") -> Tuple[Index, ...]:
        o = set(other.indices)
        return tuple(i for i in self.indices if i in o)

    def uncommon_indices(self, other: "Tensor") -> Tuple[Index, ...]:
        o = set(other.indices)
        return tuple(i for i in self.indices if i not in o)

    # ------------------------------------------------------------------
    # index manipulation
    # ------------------------------------------------------------------
    def permute(self, new_order: Sequence[Index]) -> "Tensor":
        new_order = tuple(new_order)
        if new_order == self.indices:
            return self
        if set(new_order) != set(self.indices) or len(new_order) != self.ndim:
            raise ValueError(f"permute: {new_order} is not a permutation of {self.indices}")
        perm = [self.indices.index(i) for i in new_order]
        xp = np if isinstance(self.data, np.ndarray) else jnp
        return Tensor(new_order, xp.transpose(self.data, perm))

    def replaceinds(self, old: Sequence[Index], new: Sequence[Index]) -> "Tensor":
        """Rebind index identities (ref tensordynlen `replaceinds`)."""
        old, new = tuple(old), tuple(new)
        if len(old) != len(new):
            raise ValueError("replaceinds: length mismatch")
        mapping = dict(zip(old, new))
        out = []
        for i in self.indices:
            r = mapping.get(i, i)
            if r.dim != i.dim:
                raise ValueError(f"replaceinds: dim mismatch {i!r} -> {r!r}")
            out.append(r)
        return Tensor(tuple(out), self.data)

    def replaceind(self, old: Index, new: Index) -> "Tensor":
        return self.replaceinds([old], [new])

    def prime(self, inc: int = 1, only: Optional[Iterable[Index]] = None) -> "Tensor":
        sel = set(only) if only is not None else None
        new = tuple(
            i.prime(inc) if (sel is None or i in sel) else i for i in self.indices
        )
        return Tensor(new, self.data)

    def noprime(self) -> "Tensor":
        return Tensor(tuple(i.noprime() for i in self.indices), self.data)

    def fuse_indices(self, groups: Sequence[Sequence[Index]]) -> Tuple["Tensor", Tuple[Index, ...]]:
        """Fuse each group of indices into one combined index.

        Ref: tensordynlen.rs:4035 `fuse_indices`. Row-major (C) order within
        each group. Returns (tensor, fused indices in group order).
        """
        groups = [tuple(g) for g in groups]
        flat = [i for g in groups for i in g]
        if len(set(flat)) != len(flat):
            raise ValueError("fuse groups overlap")
        rest = [i for i in self.indices if i not in set(flat)]
        t = self.permute(tuple(flat) + tuple(rest))
        fused = []
        shape = []
        for g in groups:
            d = int(np.prod([i.dim for i in g], dtype=np.int64)) if g else 1
            fused.append(Index(d, tags="fused"))
            shape.append(d)
        shape += [i.dim for i in rest]
        return Tensor(tuple(fused) + tuple(rest), t.data.reshape(shape)), tuple(fused)

    def split_index(self, fused: Index, parts: Sequence[Index]) -> "Tensor":
        """Inverse of fuse: split one index into several (ref `unfuse`)."""
        parts = tuple(parts)
        d = int(np.prod([p.dim for p in parts], dtype=np.int64)) if parts else 1
        if d != fused.dim:
            raise ValueError("split_index: dim product mismatch")
        ax = self.axis(fused)
        order = (fused,) + tuple(i for i in self.indices if i != fused)
        t = self.permute(order)
        new_shape = [p.dim for p in parts] + list(t.data.shape[1:])
        return Tensor(parts + t.indices[1:], t.data.reshape(new_shape))

    # ------------------------------------------------------------------
    # elementwise / vector-space ops (ref TensorVectorSpace, tensor_like.rs:579)
    # ------------------------------------------------------------------
    def _aligned(self, other: "Tensor") -> "Tensor":
        if set(other.indices) != set(self.indices):
            raise ValueError(
                f"tensors have different index sets: {self.indices} vs {other.indices}"
            )
        return other.permute(self.indices)

    def __add__(self, other: "Tensor") -> "Tensor":
        return Tensor(self.indices, self.data + self._aligned(other).data)

    def __sub__(self, other: "Tensor") -> "Tensor":
        return Tensor(self.indices, self.data - self._aligned(other).data)

    def __mul__(self, s: Scalar) -> "Tensor":
        return Tensor(self.indices, self.data * s)

    __rmul__ = __mul__

    def __truediv__(self, s: Scalar) -> "Tensor":
        return Tensor(self.indices, self.data / s)

    def __neg__(self) -> "Tensor":
        return Tensor(self.indices, -self.data)

    def axpby(self, a: Scalar, x: "Tensor", b: Scalar) -> "Tensor":
        """a*x + b*self (ref tensordynlen axpby)."""
        return Tensor(self.indices, a * self._aligned(x).data + b * self.data)

    def hadamard(self, other: "Tensor") -> "Tensor":
        return Tensor(self.indices, self.data * self._aligned(other).data)

    def conj(self) -> "Tensor":
        xp = np if isinstance(self.data, np.ndarray) else jnp
        return Tensor(self.indices, xp.conj(self.data))

    def dag(self) -> "Tensor":
        """Conjugate data and flip index conj flags (ref conj state)."""
        xp = np if isinstance(self.data, np.ndarray) else jnp
        return Tensor(tuple(i.dag() for i in self.indices),
                      xp.conj(self.data))

    def inner(self, other: "Tensor") -> jax.Array:
        """<self|other> = sum(conj(self) * other), axes matched by identity."""
        o = self._aligned(other)
        if (isinstance(self.data, np.ndarray)
                and isinstance(o.data, np.ndarray)):
            return np.vdot(self.data.reshape(-1), o.data.reshape(-1))
        return jnp.vdot(self.data.reshape(-1), o.data.reshape(-1))

    def norm(self) -> jax.Array:
        if isinstance(self.data, np.ndarray):
            return np.linalg.norm(self.data.reshape(-1))
        return jnp.linalg.norm(self.data.reshape(-1))

    def sum(self) -> jax.Array:
        if isinstance(self.data, np.ndarray):
            return np.sum(self.data)
        return jnp.sum(self.data)

    def real(self) -> "Tensor":
        return Tensor(self.indices, jnp.real(self.data))

    def astype(self, dtype) -> "Tensor":
        return Tensor(self.indices, self.data.astype(dtype))

    # ------------------------------------------------------------------
    # slicing / reduction
    # ------------------------------------------------------------------
    def select(self, index: Index, value: int) -> "Tensor":
        """Fix `index` to `value` and drop the axis (ref `select`)."""
        ax = self.axis(index)
        data = jax.lax.index_in_dim(self.data, value, axis=ax, keepdims=False)
        return Tensor(self.indices[:ax] + self.indices[ax + 1:], data)

    def sum_over(self, indices: Iterable[Index]) -> "Tensor":
        axes = sorted(self.axis(i) for i in indices)
        keep = tuple(i for k, i in enumerate(self.indices) if k not in set(axes))
        return Tensor(keep, jnp.sum(self.data, axis=tuple(axes)))

    def scalar(self):
        if self.ndim != 0:
            raise ValueError(f"scalar() on rank-{self.ndim} tensor")
        return self.data[()]

    def dense(self, order: Sequence[Index]) -> jax.Array:
        """Dense payload in the given axis order (ref `to_dense`)."""
        return self.permute(tuple(order)).data

    def __getitem__(self, key) -> jax.Array:
        return self.data[key]

    def __repr__(self) -> str:
        return f"Tensor({list(self.indices)}, dtype={self.data.dtype})"


def _tensor_flatten(t: Tensor):
    return (t.data,), t.indices


def _tensor_unflatten(indices, children):
    obj = object.__new__(Tensor)
    obj.indices = indices
    obj.data = children[0]
    return obj


jax.tree_util.register_pytree_node(Tensor, _tensor_flatten, _tensor_unflatten)
