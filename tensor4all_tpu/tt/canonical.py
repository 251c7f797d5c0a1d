"""Canonical TT forms: center-canonical and Vidal (Gamma-Lambda).

JAX rebuild of tensor4all-simplett/src/canonical.rs:1-515
(`SiteTensorTrain`) and vidal.rs:1-749 (`VidalTensorTrain`).
"""

from __future__ import annotations

from typing import List, Optional

import jax.numpy as jnp

from ..config import SvdTruncationPolicy
from ..core.decomp import truncated_svd_matrix
from .tensortrain import TensorTrain


class SiteTensorTrain:
    """Center-canonical TT: cores left of `center` are left-isometric,
    cores right of it right-isometric (ref canonical.rs `SiteTensorTrain`)."""

    def __init__(self, cores, center: int):
        self.tt = TensorTrain(cores)
        if not 0 <= center < len(self.tt):
            raise ValueError("center out of range")
        self.center = center

    @staticmethod
    def from_tt(tt: TensorTrain, center: int = 0) -> "SiteTensorTrain":
        from .compression import right_orthogonalize

        t = right_orthogonalize(tt)
        s = SiteTensorTrain(t.cores, 0)
        s.move_center(center)
        return s

    @property
    def cores(self):
        return self.tt.cores

    def move_center(self, new_center: int) -> "SiteTensorTrain":
        """QR-shift the orthogonality center (ref canonical.rs moves)."""
        cores = list(self.tt.cores)
        c = self.center
        while c < new_center:
            r0, d, r1 = cores[c].shape
            q, r = jnp.linalg.qr(cores[c].reshape(r0 * d, r1), mode="reduced")
            cores[c] = q.reshape(r0, d, q.shape[1])
            cores[c + 1] = jnp.tensordot(r, cores[c + 1], axes=[[1], [0]])
            c += 1
        while c > new_center:
            r0, d, r1 = cores[c].shape
            qt, rt = jnp.linalg.qr(cores[c].reshape(r0, d * r1).T, mode="reduced")
            cores[c] = qt.T.reshape(qt.shape[1], d, r1)
            cores[c - 1] = jnp.tensordot(cores[c - 1], rt.T, axes=[[2], [0]])
            c -= 1
        self.tt = TensorTrain(cores)
        self.center = c
        return self

    def to_tt(self) -> TensorTrain:
        return self.tt.copy()


class VidalTensorTrain:
    """Vidal form: Gamma cores + explicit bond singular values Lambda
    (ref vidal.rs `VidalTensorTrain`). ``gammas[k] : (r_k, d, r_{k+1})``,
    ``lambdas[k] : (r_{k+1},)`` for k < L-1."""

    def __init__(self, gammas: List[jnp.ndarray], lambdas: List[jnp.ndarray]):
        if len(lambdas) != len(gammas) - 1:
            raise ValueError("need L-1 lambda vectors")
        self.gammas = [jnp.asarray(g) for g in gammas]
        self.lambdas = [jnp.asarray(l) for l in lambdas]

    @staticmethod
    def from_tt(
        tt: TensorTrain,
        policy: Optional[SvdTruncationPolicy] = None,
    ) -> "VidalTensorTrain":
        """Left-orthogonalize, then SVD right-to-left extracting Lambdas."""
        from .compression import left_orthogonalize

        cores = list(left_orthogonalize(tt).cores)
        L = len(cores)
        policy = policy or SvdTruncationPolicy()
        lambdas: List[jnp.ndarray] = [None] * (L - 1)
        # right-to-left: split S off each bond
        for k in range(L - 1, 0, -1):
            r0, d, r1 = cores[k].shape
            u, s, vh, _ = truncated_svd_matrix(cores[k].reshape(r0, d * r1), policy)
            rk = u.shape[1]
            lambdas[k - 1] = s
            cores[k] = vh.reshape(rk, d, r1)
            # absorb U*S leftward: keeps the product intact and makes the
            # stored lambdas the true Schmidt coefficients of bond k-1
            cores[k - 1] = jnp.tensordot(
                cores[k - 1], u * s[None, :], axes=[[2], [0]]
            )
        # cores[] is now center-at-0 with B-matrices; extract gammas:
        # gamma_k = B_k / lambda_{k-1} on the left bond
        gammas = [cores[0]]
        for k in range(1, L):
            inv = jnp.where(lambdas[k - 1] > 0, 1.0 / lambdas[k - 1], 0.0)
            gammas.append(cores[k] * inv[:, None, None])
        return VidalTensorTrain(gammas, lambdas)

    def to_tt(self) -> TensorTrain:
        """Back to plain TT by absorbing each Lambda leftward."""
        cores = [self.gammas[0]]
        for k in range(1, len(self.gammas)):
            lam = self.lambdas[k - 1]
            cores.append(self.gammas[k] * lam[:, None, None])
        return TensorTrain(cores)

    @property
    def ranks(self):
        return [int(l.shape[0]) for l in self.lambdas]


class InverseTensorTrain:
    """Inverse-weight form (ref vidal.rs:515 `InverseTensorTrain`,
    Hastings' trick): site tensors carry the bond weights absorbed on
    BOTH sides, ``T_k = Lambda_{k-1} Gamma_k Lambda_k``, plus the inverse
    singular values per bond. A local two-site update touches only
    ``T_k inv(Lambda_k) T_{k+1}`` — no global re-gauging."""

    def __init__(self, tensors: List[jnp.ndarray],
                 inv_lambdas: List[jnp.ndarray],
                 lambdas: List[jnp.ndarray]):
        if len(inv_lambdas) != len(tensors) - 1:
            raise ValueError("need L-1 inverse weights")
        self.tensors = [jnp.asarray(t) for t in tensors]
        self.inv_lambdas = [jnp.asarray(v) for v in inv_lambdas]
        self.lambdas = [jnp.asarray(v) for v in lambdas]

    @staticmethod
    def from_vidal(v: "VidalTensorTrain") -> "InverseTensorTrain":
        L = len(v.gammas)
        tensors = []
        for k in range(L):
            t = v.gammas[k]
            if k > 0:
                t = t * v.lambdas[k - 1][:, None, None]
            if k < L - 1:
                t = t * v.lambdas[k][None, None, :]
            tensors.append(t)
        invs = [jnp.where(lam > 0, 1.0 / lam, 0.0) for lam in v.lambdas]
        return InverseTensorTrain(tensors, invs, list(v.lambdas))

    @staticmethod
    def from_tt(tt: TensorTrain,
                policy: Optional[SvdTruncationPolicy] = None
                ) -> "InverseTensorTrain":
        return InverseTensorTrain.from_vidal(
            VidalTensorTrain.from_tt(tt, policy))

    def to_tt(self) -> TensorTrain:
        cores = []
        L = len(self.tensors)
        for k in range(L):
            t = self.tensors[k]
            if k < L - 1:
                t = t * self.inv_lambdas[k][None, None, :]
            cores.append(t)
        return TensorTrain(cores)

    def two_site_block(self, k: int) -> jnp.ndarray:
        """``theta = T_k inv(Lambda_k) T_{k+1}`` (both outer weights
        absorbed)."""
        left = self.tensors[k] * self.inv_lambdas[k][None, None, :]
        return jnp.einsum("adb,bec->adec", left, self.tensors[k + 1])

    def set_two_site(self, k: int, theta: jnp.ndarray,
                     policy: Optional[SvdTruncationPolicy] = None) -> None:
        """Replace bond k's block by SVD of `theta` (ref vidal.rs
        set_two_site_tensors): T_k <- U S, Lambda_k <- S,
        T_{k+1} <- S Vh — a purely local update."""
        r0, d0, d1, r1 = theta.shape
        pol = policy or SvdTruncationPolicy()
        u, s, vh, _ = truncated_svd_matrix(
            theta.reshape(r0 * d0, d1 * r1), pol)
        rk = s.shape[0]
        self.tensors[k] = (u * s[None, :]).reshape(r0, d0, rk)
        self.tensors[k + 1] = (s[:, None] * vh).reshape(rk, d1, r1)
        self.lambdas[k] = s
        self.inv_lambdas[k] = jnp.where(s > 0, 1.0 / s, 0.0)

    @property
    def ranks(self):
        return [int(v.shape[0]) for v in self.inv_lambdas]


# ----------------------------------------------------------------------
# MPO canonical forms (ref simplett/src/mpo/: SiteMPO, VidalMPO,
# InverseMPO) — the MPO is treated as a TT over fused (out, in) sites.
# ----------------------------------------------------------------------
def _mpo_fused_tt(mpo) -> TensorTrain:
    cores = []
    for c in mpo.cores:
        l, o, i, r = c.shape
        cores.append(jnp.asarray(c).reshape(l, o * i, r))
    return TensorTrain(cores)


def _fused_tt_mpo(tt: TensorTrain, shapes) :
    from .mpo import MPO

    cores = []
    for c, (o, i) in zip(tt.cores, shapes):
        l, _, r = c.shape
        cores.append(jnp.asarray(c).reshape(l, o, i, r))
    return MPO(cores)


class SiteMPO:
    """Center-canonical MPO (ref mpo/site_mpo.rs)."""

    def __init__(self, mpo, center: int = 0):
        self._shapes = [(c.shape[1], c.shape[2]) for c in mpo.cores]
        self._stt = SiteTensorTrain.from_tt(_mpo_fused_tt(mpo), center)

    @property
    def center(self) -> int:
        return self._stt.center

    def move_center(self, new_center: int) -> "SiteMPO":
        self._stt = self._stt.move_center(new_center)
        return self

    def to_mpo(self):
        return _fused_tt_mpo(self._stt.to_tt(), self._shapes)


class VidalMPO:
    """Vidal-form MPO with explicit bond singular values
    (ref mpo/vidal_mpo.rs)."""

    def __init__(self, mpo, policy: Optional[SvdTruncationPolicy] = None):
        self._shapes = [(c.shape[1], c.shape[2]) for c in mpo.cores]
        self._v = VidalTensorTrain.from_tt(_mpo_fused_tt(mpo), policy)

    @property
    def lambdas(self):
        return self._v.lambdas

    @property
    def ranks(self):
        return self._v.ranks

    def to_mpo(self):
        return _fused_tt_mpo(self._v.to_tt(), self._shapes)


class InverseMPO:
    """Inverse-weight MPO for local updates (ref mpo/inverse_mpo.rs)."""

    def __init__(self, mpo, policy: Optional[SvdTruncationPolicy] = None):
        self._shapes = [(c.shape[1], c.shape[2]) for c in mpo.cores]
        self._inv = InverseTensorTrain.from_tt(_mpo_fused_tt(mpo), policy)

    @property
    def ranks(self):
        return self._inv.ranks

    def two_site_block(self, k: int):
        return self._inv.two_site_block(k)

    def to_mpo(self):
        return _fused_tt_mpo(self._inv.to_tt(), self._shapes)
