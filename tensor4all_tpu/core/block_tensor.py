"""Block-structured tensors for block linear systems.

JAX rebuild of tensor4all-core/src/block_tensor.rs:1-581
(`BlockTensor`): a named collection of component tensors implementing the
TensorVectorSpace protocol (axpby / inner / norm / scale), so block
systems run through the same GMRES (core.krylov) unchanged — e.g. solving
for several right-hand sides or coupled components at once.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, Mapping

import jax.numpy as jnp

from .tensor import Tensor


class BlockTensor:
    """Mapping block-name -> Tensor with vector-space semantics."""

    def __init__(self, blocks: Mapping[Hashable, Tensor]):
        if not blocks:
            raise ValueError("empty block tensor")
        self.blocks: Dict[Hashable, Tensor] = dict(blocks)

    def _match(self, other: "BlockTensor") -> None:
        if set(self.blocks) != set(other.blocks):
            raise ValueError("block structures differ")

    def __getitem__(self, k) -> Tensor:
        return self.blocks[k]

    def keys(self):
        return self.blocks.keys()

    # vector-space protocol (core.krylov.VectorSpace default impl)
    def axpby(self, a, x: "BlockTensor", b) -> "BlockTensor":
        self._match(x)
        return BlockTensor({
            k: self.blocks[k].axpby(a, x.blocks[k], b) for k in self.blocks
        })

    def inner(self, other: "BlockTensor"):
        self._match(other)
        acc = None
        for k in self.blocks:
            v = self.blocks[k].inner(other.blocks[k])
            acc = v if acc is None else acc + v
        return acc

    def norm(self):
        return jnp.sqrt(jnp.real(self.inner(self)))

    def __mul__(self, s) -> "BlockTensor":
        return BlockTensor({k: t * s for k, t in self.blocks.items()})

    __rmul__ = __mul__

    def __add__(self, other: "BlockTensor") -> "BlockTensor":
        self._match(other)
        return BlockTensor({
            k: self.blocks[k] + other.blocks[k] for k in self.blocks
        })

    def map(self, fn: Callable[[Tensor], Tensor]) -> "BlockTensor":
        return BlockTensor({k: fn(t) for k, t in self.blocks.items()})
