"""Identity-carrying tensor indices.

JAX rebuild of the reference index system
(tensor4all-core/src/defaults/index.rs:27,65 `DynId`/`Index`,
tagset.rs `TagSet`, index_like.rs:1-417 `IndexLike`): an ``Index`` is pure
host-side metadata — a 64-bit identity, a dimension, a prime level, string
tags, and a conjugation flag. Identity (not position) drives contraction,
exactly as in ITensors.jl. Nothing here ever reaches the device; XLA sees
only the dense payloads whose axes these objects label.
"""

from __future__ import annotations

import dataclasses
import secrets
from typing import Iterable, Tuple, Union

TagArg = Union[str, Iterable[str], None]


def new_id() -> int:
    """Fresh 64-bit index identity (ref DynId(u64), index.rs:27)."""
    return secrets.randbits(63) + 1  # nonzero, fits in int64


def _norm_tags(tags: TagArg) -> Tuple[str, ...]:
    """Normalize tags to a sorted unique tuple.

    The reference's TagSet stores comma-separated fixed-capacity strings
    (smallstring.rs); we keep plain Python strings, sorted for canonical
    equality/hashing.
    """
    if tags is None:
        return ()
    if isinstance(tags, str):
        parts = [t.strip() for t in tags.split(",")]
    else:
        parts = []
        for t in tags:
            parts.extend(p.strip() for p in str(t).split(","))
    return tuple(sorted({p for p in parts if p}))


class TagSet(frozenset):
    """Immutable set of string tags (ref: tagset.rs)."""

    def __new__(cls, tags: TagArg = None):
        return super().__new__(cls, _norm_tags(tags))

    def __str__(self) -> str:  # ITensors-style "a,b,c"
        return ",".join(sorted(self))


@dataclasses.dataclass(frozen=True)
class Index:
    """An identity-carrying index.

    Two Index objects label the same tensor axis (and therefore contract)
    iff id, dim, plev, tags and conj all match — ITensors semantics, as in
    ref index_like.rs (IndexLike: id/dim/plev/tags/conj accessors).

    Create with ``Index(dim)`` or ``Index(dim, tags="s,Site")``.
    """

    dim: int
    tags: TagSet = dataclasses.field(default_factory=TagSet)
    plev: int = 0
    # conj is metadata only (excluded from equality/hash): without QN arrows
    # a dagged index still matches the original, as in ITensors.jl.
    conj: bool = dataclasses.field(default=False, compare=False)
    id: int = dataclasses.field(default_factory=new_id)

    def __post_init__(self):
        if not isinstance(self.tags, TagSet):
            object.__setattr__(self, "tags", TagSet(self.tags))
        if self.dim < 0:
            raise ValueError(f"Index dim must be >= 0, got {self.dim}")

    # --- identity-preserving transforms -------------------------------
    def prime(self, inc: int = 1) -> "Index":
        """Raise prime level (ref index_like.rs `prime`)."""
        return dataclasses.replace(self, plev=self.plev + inc)

    def noprime(self) -> "Index":
        return dataclasses.replace(self, plev=0)

    def setprime(self, plev: int) -> "Index":
        return dataclasses.replace(self, plev=plev)

    def settags(self, tags: TagArg) -> "Index":
        return dataclasses.replace(self, tags=TagSet(tags))

    def addtags(self, tags: TagArg) -> "Index":
        return dataclasses.replace(self, tags=TagSet(self.tags | TagSet(tags)))

    def removetags(self, tags: TagArg) -> "Index":
        return dataclasses.replace(self, tags=TagSet(self.tags - TagSet(tags)))

    def hastags(self, tags: TagArg) -> bool:
        return TagSet(tags) <= self.tags

    def dag(self) -> "Index":
        """Flip the conjugation flag (ref Index conj state, index.rs)."""
        return dataclasses.replace(self, conj=not self.conj)

    # --- misc ---------------------------------------------------------
    def sim(self) -> "Index":
        """Same dim/tags/plev, fresh identity (ITensors `sim`)."""
        return dataclasses.replace(self, id=new_id())

    def __repr__(self) -> str:
        t = f",{self.tags}" if self.tags else ""
        p = "'" * self.plev if 0 < self.plev < 4 else (f"'^{self.plev}" if self.plev else "")
        c = "†" if self.conj else ""
        return f"(dim={self.dim}|id={self.id % 1000:03d}{t}){p}{c}"


def sim(index: Index) -> Index:
    return index.sim()


def prime_all(indices: Iterable[Index], inc: int = 1) -> Tuple[Index, ...]:
    return tuple(i.prime(inc) for i in indices)
