"""Partitioned tensor trains: domain decomposition with projectors.

JAX rebuild of tensor4all-partitionedtt
(crates/tensor4all-partitionedtt/src/lib.rs:12-33 `Projector`,
`SubDomainTT`, `PartitionedTT`; patching.rs:37-346 adaptive patching).

A Projector fixes a subset of sites to concrete values; a SubDomainTT is
a TT over the free sites valid only on its patch; a PartitionedTT is a
set of sub-domain TTs on pairwise-disjoint patches whose sum represents
the full function. Patches are embarrassingly parallel — the natural
coarse axis for multi-device runs (SURVEY.md §5.8).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..tci.tensorci2 import TCI2Options, crossinterpolate2, estimate_true_error
from .tensortrain import TensorTrain


@dataclasses.dataclass(frozen=True)
class Projector:
    """Site -> fixed value map (ref projector.rs)."""

    fixed: Tuple[Tuple[int, int], ...]  # sorted ((site, value), ...)

    @staticmethod
    def make(fixed: Dict[int, int]) -> "Projector":
        return Projector(tuple(sorted((int(k), int(v))
                                      for k, v in fixed.items())))

    @property
    def as_dict(self) -> Dict[int, int]:
        return dict(self.fixed)

    def matches(self, idx: Sequence[int]) -> bool:
        return all(idx[site] == val for site, val in self.fixed)

    def matches_batch(self, idx: np.ndarray) -> np.ndarray:
        ok = np.ones(idx.shape[0], dtype=bool)
        for site, val in self.fixed:
            ok &= idx[:, site] == val
        return ok

    def overlaps(self, other: "Projector") -> bool:
        """Patches overlap unless they conflict on some shared site."""
        d = self.as_dict
        for site, val in other.fixed:
            if site in d and d[site] != val:
                return False
        return True


@dataclasses.dataclass
class SubDomainTT:
    """TT over the free sites of one patch (ref subdomain_tt.rs)."""

    projector: Projector
    tt: TensorTrain  # over free sites, in increasing site order
    local_dims: List[int]  # full-domain dims

    @property
    def free_sites(self) -> List[int]:
        fixed = {s for s, _ in self.projector.fixed}
        return [k for k in range(len(self.local_dims)) if k not in fixed]

    def evaluate_batch(self, idx: np.ndarray) -> np.ndarray:
        idx = np.asarray(idx)
        out = np.zeros(idx.shape[0], dtype=np.asarray(self.tt.cores[0]).dtype)
        ok = self.projector.matches_batch(idx)
        if ok.any():
            sub = idx[ok][:, self.free_sites]
            out[ok] = np.asarray(self.tt.evaluate_batch(sub))
        return out

    def sum(self) -> complex:
        return complex(self.tt.sum())

    def project(self, proj: Projector) -> Optional["SubDomainTT"]:
        """Restrict to the merge of this patch's projector with `proj`
        (ref subdomain_tt.rs `project`); ``None`` when incompatible."""
        merged = _merge_compatible(self.projector, proj)
        if merged is None:
            return None
        return _restrict(self, merged)


class PartitionedTT:
    """Disjoint patches covering (part of) the domain (ref lib.rs)."""

    def __init__(self, patches: Sequence[SubDomainTT]):
        patches = list(patches)
        for i, a in enumerate(patches):
            for b in patches[i + 1:]:
                if a.projector.overlaps(b.projector):
                    raise ValueError(
                        f"patches overlap: {a.projector} / {b.projector}"
                    )
        self.patches = patches

    def __len__(self):
        return len(self.patches)

    def evaluate_batch(self, idx) -> np.ndarray:
        idx = np.asarray(idx)
        out = None
        for p in self.patches:
            v = p.evaluate_batch(idx)
            out = v if out is None else out + v
        return out

    def sum(self) -> complex:
        return sum((p.sum() for p in self.patches), 0.0)

    def max_rank(self) -> int:
        return max((p.tt.max_rank for p in self.patches), default=1)

    def add(self, other: "PartitionedTT",
            tol: float = 1e-12, maxdim: Optional[int] = None) -> "PartitionedTT":
        """Patch-wise addition; requires identical partitions
        (ref add_with_patching handles refinement — here both operands
        must already share the partition; use `refine_like` first)."""
        if len(self.patches) != len(other.patches):
            raise ValueError("partitions differ")
        by_proj = {p.projector: p for p in other.patches}
        out = []
        for p in self.patches:
            q = by_proj.get(p.projector)
            if q is None:
                raise ValueError("partitions differ")
            s = (p.tt + q.tt).compress(tol=tol, maxdim=maxdim)
            out.append(SubDomainTT(p.projector, s, p.local_dims))
        return PartitionedTT(out)


def contract(m1: SubDomainTT, m2: SubDomainTT, tol: float = 1e-12,
             maxdim: Optional[int] = None) -> Optional[SubDomainTT]:
    """Contract two SubDomainTTs (ref contract.rs:18 `contract`): the
    result lives on the merged projector, ``None`` when the projectors
    are incompatible. This package's PartitionedTT carries scalar
    function patches, so "contract" is the pointwise (Hadamard) product
    — the role the reference's MPO-valued patches play in contract.rs."""
    proj = _merge_compatible(m1.projector, m2.projector)
    if proj is None:
        return None
    ra = _restrict(m1, proj)
    rb = _restrict(m2, proj)
    tt = ra.tt.hadamard(rb.tt).compress(tol=tol, maxdim=maxdim)
    return SubDomainTT(proj, tt, m1.local_dims)


def proj_contract(m1: SubDomainTT, m2: SubDomainTT, proj: Projector,
                  tol: float = 1e-12,
                  maxdim: Optional[int] = None) -> Optional[SubDomainTT]:
    """Project both operands to `proj` before contracting (ref
    contract.rs:27 `proj_contract`); ``None`` when either projection or
    the contraction vanishes."""
    a = m1.project(proj)
    if a is None:
        return None
    b = m2.project(proj)
    if b is None:
        return None
    return contract(a, b, tol=tol, maxdim=maxdim)


def _tt_fix_site(tt: TensorTrain, pos: int, v: int) -> TensorTrain:
    """Fix free site `pos` of a TT to value `v` (absorb the slice into a
    neighbor core) — the split primitive of ref patching.rs:666
    split_subdomain."""
    import jax.numpy as jnp

    cores = [jnp.asarray(c) for c in tt.cores]
    sl = cores[pos][:, v, :]
    if len(cores) == 1:
        raise ValueError("cannot fix the only site")
    if pos + 1 < len(cores):
        cores[pos + 1] = jnp.einsum("ab,bdc->adc", sl, cores[pos + 1])
    else:
        cores[pos - 1] = jnp.einsum("adb,bc->adc", cores[pos - 1], sl)
    del cores[pos]
    return TensorTrain(cores)


def split_subdomain(patch: SubDomainTT, site: int) -> List[SubDomainTT]:
    """Split a patch by fixing global site `site` to each of its values
    (ref patching.rs:666)."""
    fixed = patch.projector.as_dict
    if site in fixed:
        raise ValueError(f"site {site} already fixed")
    free = patch.free_sites
    pos = free.index(site)
    out = []
    for v in range(patch.local_dims[site]):
        proj = Projector.make({**fixed, site: v})
        out.append(SubDomainTT(proj, _tt_fix_site(patch.tt, pos, v),
                               patch.local_dims))
    return out


def _restrict(patch: SubDomainTT, proj: Projector) -> SubDomainTT:
    """Restrict a patch's TT to a finer projector (slice the extra
    fixed sites out)."""
    extra = {s: v for s, v in proj.as_dict.items()
             if s not in patch.projector.as_dict}
    tt = patch.tt
    free = list(patch.free_sites)
    for s in sorted(extra):
        pos = free.index(s)
        tt = _tt_fix_site(tt, pos, extra[s])
        free.remove(s)
    return SubDomainTT(proj, tt, patch.local_dims)


def _merge_compatible(pa: Projector, pb: Projector) -> Optional[Projector]:
    da, db = pa.as_dict, pb.as_dict
    for s in set(da) & set(db):
        if da[s] != db[s]:
            return None
    return Projector.make({**da, **db})


def _adaptive_patch_op(pa: SubDomainTT, pb: SubDomainTT, proj: Projector,
                       combine, tol: float, maxdim: int,
                       depth: int) -> List[SubDomainTT]:
    """Combine two patches on region `proj`; split recursively when the
    rank cap binds (ref patching.rs add_with_patching/contract_adaptive)."""
    ra = _restrict(pa, proj)
    rb = _restrict(pb, proj)
    tt = combine(ra.tt, rb.tt).compress(tol=tol)
    if tt.max_rank <= maxdim or depth <= 0 or len(ra.free_sites) < 3:
        if tt.max_rank > maxdim:
            tt = tt.compress(tol=tol, maxdim=maxdim)
        return [SubDomainTT(proj, tt, pa.local_dims)]
    # split on the largest-dimension free site of the region
    free = ra.free_sites
    site = max(free, key=lambda s: pa.local_dims[s])
    out: List[SubDomainTT] = []
    for v in range(pa.local_dims[site]):
        child = Projector.make({**proj.as_dict, site: v})
        out.extend(_adaptive_patch_op(pa, pb, child, combine, tol, maxdim,
                                      depth - 1))
    return out


def _pairwise_adaptive(a: "PartitionedTT", b: "PartitionedTT", combine,
                       tol: float, maxdim: int,
                       max_depth: int) -> "PartitionedTT":
    patches: List[SubDomainTT] = []
    for pa in a.patches:
        for pb in b.patches:
            proj = _merge_compatible(pa.projector, pb.projector)
            if proj is None:
                continue
            patches.extend(_adaptive_patch_op(pa, pb, proj, combine, tol,
                                              maxdim, max_depth))
    return PartitionedTT(patches)


def add_with_patching(a: PartitionedTT, b: PartitionedTT,
                      tol: float = 1e-12, maxdim: int = 64,
                      max_depth: int = 3) -> PartitionedTT:
    """Add two partitioned TTs over the COMMON REFINEMENT of their
    partitions, splitting patches adaptively where the sum's rank would
    exceed `maxdim` (ref patching.rs:152 add_with_patching)."""
    return _pairwise_adaptive(a, b, lambda x, y: x + y, tol, maxdim,
                              max_depth)


def contract_adaptive(a: PartitionedTT, b: PartitionedTT,
                      tol: float = 1e-12, maxdim: int = 64,
                      max_depth: int = 3) -> PartitionedTT:
    """Element-wise (Hadamard) product with adaptive patch refinement
    (ref patching.rs:273 contract_adaptive)."""
    return _pairwise_adaptive(a, b, lambda x, y: x.hadamard(y), tol,
                              maxdim, max_depth)


def truncate_adaptive(p: PartitionedTT, tol: float = 1e-12,
                      maxdim: int = 64,
                      max_depth: int = 3) -> PartitionedTT:
    """Compress every patch; split patches whose tolerance-compressed
    rank exceeds `maxdim` (ref patching.rs:346 truncate_adaptive)."""
    out: List[SubDomainTT] = []

    def work(patch: SubDomainTT, depth: int) -> None:
        tt = patch.tt.compress(tol=tol)
        if tt.max_rank <= maxdim or depth <= 0 or \
                len(patch.free_sites) < 3:
            if tt.max_rank > maxdim:
                tt = tt.compress(tol=tol, maxdim=maxdim)
            out.append(SubDomainTT(patch.projector, tt, patch.local_dims))
            return
        free = patch.free_sites
        site = max(free, key=lambda s: patch.local_dims[s])
        for child in split_subdomain(patch, site):
            work(child, depth - 1)

    for patch in p.patches:
        work(patch, max_depth)
    return PartitionedTT(out)


def partitioned_interpolate(
    batch_f: Callable[[np.ndarray], np.ndarray],
    local_dims: Sequence[int],
    tol: float = 1e-8,
    maxbonddim: int = 64,
    max_patch_depth: int = 3,
    options: Optional[TCI2Options] = None,
    _projector: Optional[Projector] = None,
) -> PartitionedTT:
    """Adaptive patching interpolation (ref patching.rs:37-346
    `add_with_patching` / adaptive split strategies): TCI the domain; if
    the rank cap binds before `tol` is met, fix the first free site to
    each of its values and recurse into the sub-domains."""
    local_dims = list(local_dims)
    proj = _projector or Projector.make({})
    fixed = proj.as_dict
    free = [k for k in range(len(local_dims)) if k not in fixed]
    if len(free) < 2:
        raise ValueError("patching exhausted the free sites")

    def sub_f(sub_idx: np.ndarray) -> np.ndarray:
        B = sub_idx.shape[0]
        full = np.zeros((B, len(local_dims)), dtype=np.int64)
        for s, v in fixed.items():
            full[:, s] = v
        full[:, free] = sub_idx
        return batch_f(full)

    import copy

    opts = copy.copy(options or TCI2Options(tol=tol, max_iter=10))
    opts.maxbonddim = maxbonddim
    tci, _, errs = crossinterpolate2(
        batch_f=sub_f, local_dims=[local_dims[k] for k in free],
        options=opts,
    )
    tt = tci.to_tensortrain()
    err = estimate_true_error(tt, tci.func, n_samples=500)
    rel = err / max(tci.f_max, 1e-300)
    if rel <= tol * 10 or max_patch_depth == 0:
        return PartitionedTT([SubDomainTT(proj, tt, local_dims)])
    # split on the first free site
    split_site = free[0]
    patches: List[SubDomainTT] = []
    for v in range(local_dims[split_site]):
        child = Projector.make({**fixed, split_site: v})
        sub = partitioned_interpolate(
            batch_f, local_dims, tol=tol, maxbonddim=maxbonddim,
            max_patch_depth=max_patch_depth - 1, options=options,
            _projector=child,
        )
        patches.extend(sub.patches)
    return PartitionedTT(patches)
