"""ITensorMPS-style MPS/MPO layer over TreeTN chains.

JAX rebuild of tensor4all-itensorlike
(crates/tensor4all-itensorlike/src/tensortrain.rs:125-1925 `TensorTrain`
with llim/rlim, `from_treetn` :337, `orthogonalize` :1073, `truncate`
:1152, `inner` :1215; contract.rs:1-156 `ContractMethod`; linsolve.rs:34):
an MPS is a thin indexed shell over a chain TreeTN — exactly the
reference's design ("internally a thin shell over treetn") — carrying
ITensors-style orthogonality limits (tensors 0..llim are left-isometric,
rlim..L-1 right-isometric).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SvdTruncationPolicy
from ..core.decomp import FactorizeAlg
from ..core.index import Index
from ..core.tensor import Tensor
from ..treetn.linsolve import LinsolveOptions, LinsolveResult, square_linsolve
from ..treetn.network import TreeTN
from ..treetn.operator import TreeOperator, mpo_to_treeoperator
from ..tt.mpo import MPO as PlainMPO
from ..tt.tensortrain import TensorTrain as PlainTT


class MPS:
    """Finite MPS with orthogonality limits (ref `TensorTrain` :125)."""

    def __init__(self, tn: TreeTN, sites: Sequence[Index],
                 llim: int = -1, rlim: Optional[int] = None):
        self.tn = tn
        self.sites = list(sites)
        L = len(self.sites)
        self.llim = llim
        self.rlim = rlim if rlim is not None else L

    # ------------------------------------------------------------------
    @property
    def L(self) -> int:
        return len(self.sites)

    def __len__(self):
        return self.L

    def tensor(self, k: int) -> Tensor:
        return self.tn.tensor(k)

    def linkind(self, k: int) -> Index:
        """Bond between sites k and k+1 (ref linkinds)."""
        return self.tn.bond(k, k + 1)

    @property
    def linkdims(self) -> List[int]:
        return [self.linkind(k).dim for k in range(self.L - 1)]

    @property
    def maxlinkdim(self) -> int:
        return max(self.linkdims, default=1)

    # ------------------------------------------------------------------
    @staticmethod
    def from_tt(tt: PlainTT, sites: Optional[Sequence[Index]] = None) -> "MPS":
        """Plain rank-3 cores -> indexed chain (ref simplett_bridge.rs)."""
        L = len(tt)
        if sites is None:
            sites = [Index(d, tags=f"Site,n={k}")
                     for k, d in enumerate(tt.local_dims)]
        sites = list(sites)
        bonds = [Index(r, tags="Link") for r in tt.ranks]
        tn = TreeTN()
        for k in range(L):
            core = tt.cores[k]
            inds, data = [], core
            if L == 1:
                inds, data = [sites[0]], core[0, :, 0]
            elif k == 0:
                inds, data = [sites[0], bonds[0]], core[0]
            elif k == L - 1:
                inds, data = [bonds[k - 1], sites[k]], core[..., 0]
            else:
                inds = [bonds[k - 1], sites[k], bonds[k]]
            tn.add_node(k, Tensor(tuple(inds), data))
        for k in range(L - 1):
            tn.connect(k, k + 1, bonds[k])
        return MPS(tn, sites)

    def to_tt(self) -> PlainTT:
        """Back to plain cores (bond-left, site, bond-right order)."""
        cores = []
        for k in range(self.L):
            t = self.tn.tensor(k)
            order = []
            if k > 0:
                order.append(self.tn.bond(k - 1, k))
            order.append(self.sites[k])
            if k < self.L - 1:
                order.append(self.tn.bond(k, k + 1))
            d = t.dense(tuple(order))
            if k == 0:
                d = d[None, ...]
            if k == self.L - 1:
                d = d[..., None]
            cores.append(d)
        return PlainTT(cores)

    @staticmethod
    def random(key, sites: Sequence[Index], linkdim: int = 1) -> "MPS":
        dims = [s.dim for s in sites]
        tt = PlainTT.random(key, dims, rank=linkdim)
        return MPS.from_tt(tt, sites)


    # ------------------------------------------------------------------
    # itensorlike accessors (ref tensortrain.rs:125-1073)
    # ------------------------------------------------------------------
    def siteinds(self) -> List[Index]:
        return list(self.sites)

    def siteind(self, k: int) -> Index:
        return self.sites[k]

    def set_tensor(self, k: int, t: Tensor) -> None:
        """Replace site tensor k (indices must match the chain's)."""
        self.tn.set_tensor(k, t)

    def haslink(self, k: int) -> bool:
        return 0 <= k < self.L - 1

    def bond_dim(self, k: int) -> int:
        return self.linkind(k).dim

    def bond_dims(self) -> List[int]:
        return self.linkdims

    def norm_squared(self) -> float:
        return float(abs(self.inner(self)))

    def dense_maxabs(self) -> float:
        """max |entry| of the represented tensor via power-style local
        bound: exact by densifying for short chains, else the product
        bound (ref dense_maxabs)."""
        import numpy as np

        if self.L <= 20 and max(s.dim for s in self.sites) ** self.L <= 2 ** 20:
            return float(np.abs(np.asarray(self.to_dense())).max())
        return float(np.prod([np.abs(np.asarray(self.tensor(k).data)).max()
                              for k in range(self.L)]))

    def ortho_lims(self):
        """(llim, rlim) ITensors-style orthogonality window."""
        return (self.llim, self.rlim)

    def isortho(self) -> bool:
        return self.rlim - self.llim == 2

    def orthocenter(self) -> int:
        if not self.isortho():
            raise ValueError("MPS has no single orthogonality center")
        return self.llim + 1

    def sim_linkinds(self) -> "MPS":
        """Fresh link-index identities, same data (ref sim_linkinds)."""
        from ..core.index import sim

        out = self.copy()
        for k in range(self.L - 1):
            old = out.tn.bond(k, k + 1)
            new = sim(old)
            out.tn.set_tensor(k, out.tn.tensor(k).replaceind(old, new))
            out.tn.set_tensor(k + 1,
                              out.tn.tensor(k + 1).replaceind(old, new))
            out.tn.set_bond(k, k + 1, new)
        return out

    def axpby(self, a, x: "MPS", b) -> "MPS":
        """``a*x + b*self`` (TensorVectorSpace convention)."""
        return x.scale(a).add(self.scale(b))

    def add_reindexed_like_self(self, other: "MPS") -> "MPS":
        """Add `other` after re-pointing its site indices onto self's
        (ref add_reindexed_like_self): dimensions must match sitewise."""
        o = other.copy()
        for k in range(self.L):
            so, sn = o.sites[k], self.sites[k]
            if so == sn:
                continue
            if so.dim != sn.dim:
                raise ValueError(f"site {k}: dim {so.dim} != {sn.dim}")
            o.tn.set_tensor(k, o.tn.tensor(k).replaceind(so, sn))
            o.sites[k] = sn
        return self.add(o)

    def copy(self) -> "MPS":
        return MPS(self.tn.copy(), self.sites, self.llim, self.rlim)

    # ------------------------------------------------------------------
    def orthogonalize(self, center: int,
                      form: FactorizeAlg = FactorizeAlg.QR) -> "MPS":
        """Move orthogonality center (ref orthogonalize :1073)."""
        if self.tn.canonical_region() is not None:
            self.tn.move_center(center)
        else:
            self.tn.canonicalize([center], form=form)
        self.llim, self.rlim = center - 1, center + 1
        return self

    def truncate(self, policy: Optional[SvdTruncationPolicy] = None,
                 center: int = 0) -> "MPS":
        """SVD truncation sweep (ref truncate :1152)."""
        self.tn.truncate(policy, centers=[center])
        return self

    # ------------------------------------------------------------------
    def inner(self, other: "MPS"):
        return self.tn.inner(other.tn)

    def norm(self):
        return self.tn.norm()

    def add(self, other: "MPS") -> "MPS":
        """Direct-sum addition (ref add / direct sum)."""
        if [s for s in self.sites] != [s for s in other.sites]:
            raise ValueError("MPS add: site indices differ")
        return MPS(self.tn.add(other.tn), self.sites)

    def __add__(self, other):
        return self.add(other)

    def scale(self, s) -> "MPS":
        return MPS(self.tn.scale(s), self.sites, self.llim, self.rlim)

    def to_dense(self) -> jnp.ndarray:
        return self.tn.contract_to_tensor().dense(tuple(self.sites))

    def evaluate_batch(self, idx) -> np.ndarray:
        return np.asarray(self.to_tt().evaluate_batch(idx))


def mpo_operator(mpo: PlainMPO, sites: Sequence[Index]) -> TreeOperator:
    """Indexed MPO over the chain (ref itensorlike MPO alias)."""
    return mpo_to_treeoperator(mpo, list(sites))


def contract_mpo_mps(
    op: TreeOperator,
    mps: MPS,
    method: str = "zipup",
    policy: Optional[SvdTruncationPolicy] = None,
) -> MPS:
    """MPO x MPS via ContractMethod::{Zipup,Fit,Naive}
    (ref contract.rs:1-156)."""
    out = op.apply(mps.tn, method=method, policy=policy)
    return MPS(out, mps.sites)


def linsolve(
    op: TreeOperator,
    b: MPS,
    x0: MPS,
    options: Optional[LinsolveOptions] = None,
) -> LinsolveResult:
    """(a0 + a1 A)x = b facade over treetn.square_linsolve
    (ref itensorlike linsolve.rs:34)."""
    return square_linsolve(op, b.tn, x0.tn, options=options)
