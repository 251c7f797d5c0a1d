"""TensorLike protocol family — the abstraction algorithms are generic
over.

JAX rebuild of tensor4all-core/src/tensor_like.rs
(`TensorIndex` :520, `TensorVectorSpace` :579, `TensorContractionLike`
:619, `TensorFactorizationLike` :637, `TensorConstructionLike` :791,
umbrella `TensorLike`): in Python these are `typing.Protocol`s checked
structurally, so `core.Tensor`, `tt.TensorTrain`, `mps.MPS`, and
`treetn.TreeTN` participate without inheritance — and Krylov solvers,
BlockTensor, and the sweep frameworks stay generic exactly like the
reference's trait bounds.

`conforms(obj, protocol)` gives a runtime conformance report (the
Python analog of the reference's compile-time bounds + its
`send_sync.rs` assertion test).
"""

from __future__ import annotations

from typing import Any, List, Protocol, Tuple, runtime_checkable


@runtime_checkable
class TensorIndexLike(Protocol):
    """Index-carrying tensor (ref TensorIndex, tensor_like.rs:520)."""

    @property
    def indices(self) -> Tuple[Any, ...]: ...

    def hasindex(self, index) -> bool: ...

    def replaceind(self, old, new): ...


@runtime_checkable
class TensorVectorSpaceLike(Protocol):
    """Normed vector space ops (ref TensorVectorSpace :579) — what
    GMRES/Lanczos/expm require."""

    def axpby(self, a, x, b): ...

    def inner(self, other): ...

    def norm(self): ...

    def __mul__(self, scalar): ...


@runtime_checkable
class TensorContractionLike(Protocol):
    """Pairwise contraction capability (ref :619)."""

    def contract_pair(self, other): ...


@runtime_checkable
class TensorFactorizationLike(Protocol):
    """Two-factor splits (ref TensorFactorizationLike :637)."""

    def factorize(self, left_indices, **options): ...


@runtime_checkable
class TensorConstructionLike(Protocol):
    """Construction from dense payloads (ref :791)."""

    @classmethod
    def from_dense(cls, indices, data): ...


def conforms(obj, protocol) -> Tuple[bool, List[str]]:
    """Structural conformance report: (ok, missing member names)."""
    missing = []
    for name in getattr(protocol, "__protocol_attrs__", None) or [
        n for n in dir(protocol)
        if not n.startswith("_") or n in ("__mul__",)
    ]:
        if not hasattr(obj, name):
            missing.append(name)
    return (not missing, missing)
