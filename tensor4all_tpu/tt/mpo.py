"""Matrix product operators over rank-4 cores, with naive and zipup apply.

JAX rebuild of tensor4all-simplett/src/mpo/
(mod.rs:1-31 `MPO`, contract_zipup.rs, contract_fit.rs, environment.rs).
Core layout: ``W[k] : (l_k, out_d, in_d, l_{k+1})`` with boundary links 1.

``apply_naive`` multiplies cores exactly (ranks multiply) —
the test oracle (ref ContractMethod::Naive, options.rs:119-121).
``apply_zipup`` contracts site-by-site with on-the-fly SVD truncation
(ref contract_zipup.rs). Variational ``fit`` lives with the tree framework
(treetn.fit) which subsumes the chain case.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (
    SingularValueMeasure,
    SvdTruncationPolicy,
    ThresholdScale,
)
from ..core.decomp import truncated_svd_matrix
from .tensortrain import TensorTrain


class MPO:
    """Matrix product operator (ref simplett `MPO`)."""

    def __init__(self, cores: Sequence[jnp.ndarray]):
        # host-numpy cores are kept as-is (jnp ops accept them; forcing
        # device_put here costs ~0.2 ms/core of pure dispatch on the
        # latency-bound host paths)
        cores = [c if isinstance(c, (np.ndarray, jax.Array))
                 else jnp.asarray(c) for c in cores]
        for c in cores:
            if c.ndim != 4:
                raise ValueError(f"MPO core must be rank-4, got {c.shape}")
        if cores[0].shape[0] != 1 or cores[-1].shape[-1] != 1:
            raise ValueError("boundary links must be 1")
        for a, b in zip(cores, cores[1:]):
            if a.shape[-1] != b.shape[0]:
                raise ValueError(f"link mismatch {a.shape}->{b.shape}")
        self.cores: List[jnp.ndarray] = cores

    def __len__(self):
        return len(self.cores)

    @property
    def out_dims(self):
        return [int(c.shape[1]) for c in self.cores]

    @property
    def in_dims(self):
        return [int(c.shape[2]) for c in self.cores]

    @property
    def ranks(self):
        return [int(c.shape[-1]) for c in self.cores[:-1]]

    @staticmethod
    def identity(local_dims: Sequence[int], dtype=jnp.float64) -> "MPO":
        return MPO([jnp.eye(d, dtype=dtype)[None, :, :, None] for d in local_dims])

    def to_dense_matrix(self) -> jnp.ndarray:
        """Dense operator matrix (prod(out) x prod(in)); test oracle."""
        out = self.cores[0]  # (1, o, i, r)
        n_out = out.shape[1]
        n_in = out.shape[2]
        acc = out[0]  # (o, i, r)
        for c in self.cores[1:]:
            acc = jnp.einsum("oir,rpjs->opijs", acc, c).reshape(
                acc.shape[0] * c.shape[1], acc.shape[1] * c.shape[2], c.shape[3]
            )
        return acc[..., 0]

    def transpose(self) -> "MPO":
        return MPO([jnp.swapaxes(c, 1, 2) for c in self.cores])

    def conj(self) -> "MPO":
        return MPO([jnp.conj(c) for c in self.cores])

    def scale(self, s) -> "MPO":
        cores = list(self.cores)
        cores[0] = cores[0] * s
        return MPO(cores)

    def __add__(self, other: "MPO") -> "MPO":
        """Direct-sum addition of MPOs."""
        if self.out_dims != other.out_dims or self.in_dims != other.in_dims:
            raise ValueError("MPO add: dims mismatch")
        L = len(self)
        if L == 1:
            return MPO([self.cores[0] + other.cores[0]])
        dtype = jnp.result_type(self.cores[0].dtype, other.cores[0].dtype)
        out = []
        for k, (a, b) in enumerate(zip(self.cores, other.cores)):
            ra0, o, i, ra1 = a.shape
            rb0, _, _, rb1 = b.shape
            if k == 0:
                c = jnp.concatenate([a, b], axis=3).astype(dtype)
            elif k == L - 1:
                c = jnp.concatenate([a, b], axis=0).astype(dtype)
            else:
                top = jnp.concatenate([a, jnp.zeros((ra0, o, i, rb1), dtype)], axis=3)
                bot = jnp.concatenate([jnp.zeros((rb0, o, i, ra1), dtype), b], axis=3)
                c = jnp.concatenate([top, bot], axis=0)
            out.append(c)
        return MPO(out)

    # ------------------------------------------------------------------
    # application to a TT / another MPO
    # ------------------------------------------------------------------
    def apply_naive(self, tt: TensorTrain) -> TensorTrain:
        """Exact MPO|tt>: per-site core contraction, ranks multiply."""
        if self.in_dims != tt.local_dims:
            raise ValueError("apply: dims mismatch")
        out = []
        for W, A in zip(self.cores, tt.cores):
            l0, o, i, l1 = W.shape
            a0, _, a1 = A.shape
            c = jnp.einsum("loim,aib->laomb", W, A)
            out.append(c.reshape(l0 * a0, o, l1 * a1))
        return TensorTrain(out)

    def apply_zipup(
        self,
        tt: TensorTrain,
        tol: float = 1e-12,
        maxdim: Optional[int] = None,
    ) -> TensorTrain:
        """MPO|tt> with on-the-fly truncation (ref contract_zipup.rs).

        Sweeps left-to-right: at each site contract (bond, W_k, A_k),
        SVD-split keeping `bond` truncated, carry the remainder.
        """
        if self.in_dims != tt.local_dims:
            raise ValueError("apply: dims mismatch")
        pol = SvdTruncationPolicy(
            tol=tol,
            scale=ThresholdScale.RELATIVE,
            measure=SingularValueMeasure.VALUE,
            maxdim=maxdim,
        )
        L = len(tt)
        dtype = jnp.result_type(self.cores[0].dtype, tt.cores[0].dtype)
        # carry C: (chi, l_k, a_k) mapping new bond -> (mpo link, tt bond)
        C = jnp.ones((1, 1, 1), dtype=dtype)
        out_cores = []
        for k in range(L):
            W, A = self.cores[k], tt.cores[k]
            l0, o, i, l1 = W.shape
            a0, _, a1 = A.shape
            # theta: (chi, o, l1, a1)
            theta = jnp.einsum("xla,loid,aib->xodb", C, W, A)
            chi = theta.shape[0]
            if k == L - 1:
                out_cores.append(theta.reshape(chi, o, l1 * a1))
                break
            m = theta.reshape(chi * o, l1 * a1)
            u, s, vh, _ = truncated_svd_matrix(m, pol)
            r = u.shape[1]
            out_cores.append(u.reshape(chi, o, r))
            C = (s[:, None] * vh).reshape(r, l1, a1)
        return TensorTrain(out_cores)

    def apply_fit(
        self,
        tt: TensorTrain,
        tol: float = 1e-12,
        maxdim: Optional[int] = None,
        nsweeps: int = 2,
        initial: Optional[TensorTrain] = None,
    ) -> TensorTrain:
        """Variational ``y ~= W|tt>`` with cached environments on raw
        cores (ref mpo/contract_fit.rs + environment.rs): two-site
        sweeps replace each region by the environment-projected exact
        image — the cheap path when the zipup rank cap binds."""
        if self.in_dims != tt.local_dims:
            raise ValueError("apply: dims mismatch")
        pol = SvdTruncationPolicy(
            tol=tol, scale=ThresholdScale.RELATIVE,
            measure=SingularValueMeasure.VALUE, maxdim=maxdim)
        L = len(tt)
        if L < 2:
            return self.apply_naive(tt)
        y = (initial.copy() if initial is not None
             else self.apply_zipup(tt, tol=tol, maxdim=maxdim))
        Y = [jnp.asarray(c) for c in y.cores]
        W = [jnp.asarray(c) for c in self.cores]
        X = [jnp.asarray(c) for c in tt.cores]
        dtype = jnp.result_type(Y[0].dtype, W[0].dtype, X[0].dtype)

        def lstep(E, k):
            # E (c, w, a): y-bond, mpo-bond, x-bond left of site k
            return jnp.einsum("cwa,cid,wiju,ajb->dub", E, jnp.conj(Y[k]),
                              W[k], X[k], optimize=True)

        def rstep(E, k):
            return jnp.einsum("dub,cid,wiju,ajb->cwa", E, jnp.conj(Y[k]),
                              W[k], X[k], optimize=True)

        Rs = [None] * (L + 1)
        Rs[L] = jnp.ones((1, 1, 1), dtype)
        for k in range(L - 1, 1, -1):
            Rs[k] = rstep(Rs[k + 1], k)
        E1 = jnp.ones((1, 1, 1), dtype)  # left env of site 0
        for _ in range(nsweeps):
            # left -> right
            E = E1
            Ls = [None] * L
            for k in range(L - 1):
                Ls[k] = E
                img = jnp.einsum(
                    "cwa,wiju,uklv,ajb,blm,evm->cike", E, W[k],
                    W[k + 1], X[k], X[k + 1], Rs[k + 2], optimize=True)
                c, i, kk, e = img.shape
                u, s, vh, _ = truncated_svd_matrix(
                    img.reshape(c * i, kk * e), pol)
                r = u.shape[1]
                Y[k] = u.reshape(c, i, r)
                Y[k + 1] = (s[:, None] * vh).reshape(r, kk, e)
                E = lstep(E, k)
            # right -> left (left envs from the forward pass stay valid:
            # cores < k are untouched until the sweep reaches them)
            for k in range(L - 2, -1, -1):
                img = jnp.einsum(
                    "cwa,wiju,uklv,ajb,blm,evm->cike",
                    Ls[k] if k > 0 else E1, W[k], W[k + 1], X[k],
                    X[k + 1], Rs[k + 2], optimize=True)
                c, i, kk, e = img.shape
                u, s, vh, _ = truncated_svd_matrix(
                    img.reshape(c * i, kk * e), pol)
                r = u.shape[1]
                Y[k] = (u * s[None, :]).reshape(c, i, r)
                Y[k + 1] = vh.reshape(r, kk, e)
                Rs[k + 1] = rstep(Rs[k + 2], k + 1)
        return TensorTrain(Y)

    def compose_fit(self, other: "MPO", tol: float = 1e-12,
                    maxdim: Optional[int] = None,
                    nsweeps: int = 2) -> "MPO":
        """Variational MPO x MPO composition: apply ``self (x) I`` to
        `other` viewed as an MPS over fused (out, in) sites (ref
        mpo/contract_fit.rs for MPOs)."""
        if self.in_dims != other.out_dims:
            raise ValueError("compose: dims mismatch")
        ext_cores = []
        for k, Wc in enumerate(self.cores):
            l, o, i, r = Wc.shape
            din = other.in_dims[k]
            eye = jnp.eye(din, dtype=Wc.dtype)
            # fused site: out' = (o, m), in' = (i, n), o/i-major
            ext = jnp.einsum("loir,mn->lominr", Wc, eye)
            ext_cores.append(ext.reshape(l, o * din, i * din, r))
        ext_mpo = MPO(ext_cores)
        b_tt = TensorTrain([
            jnp.asarray(c).reshape(c.shape[0], c.shape[1] * c.shape[2],
                                   c.shape[3])
            for c in other.cores])
        y = ext_mpo.apply_fit(b_tt, tol=tol, maxdim=maxdim,
                              nsweeps=nsweeps)
        out = []
        for k, c in enumerate(y.cores):
            l, _, r = c.shape
            out.append(jnp.asarray(c).reshape(
                l, self.out_dims[k], other.in_dims[k], r))
        return MPO(out)

    def compose_zipup_fast(self, other: "MPO", tol: float = 1e-12,
                           maxdim: int = 64) -> "MPO":
        """One-program zipup composition: cores zero-padded to uniform
        shapes and the whole left-to-right truncating sweep runs as a
        single jitted scan (the per-site host loop costs a dispatch per
        op otherwise). Exact up to the same (tol, maxdim) policy as
        `compose_zipup`; trailing zero bond slots are trimmed on exit."""
        if self.in_dims != other.out_dims:
            raise ValueError("compose: dims mismatch")
        if _small_cpu_mpo(self) and _small_cpu_mpo(other):
            # latency-bound CPU-class sizes: one host-LAPACK sweep beats
            # the jitted scan's fixed dispatch cost (see _compose_zipup_np)
            return _compose_zipup_np(self, other, tol, maxdim)
        o_dims = set(self.out_dims)
        i_dims = set(other.in_dims)
        m_dims = set(self.in_dims)
        if len(o_dims) != 1 or len(i_dims) != 1 or len(m_dims) != 1:
            return self.compose_zipup(other, tol=tol, maxdim=maxdim)
        L = len(self)
        dtype = jnp.result_type(self.cores[0].dtype,
                                other.cores[0].dtype)
        wA = max(max(c.shape[0], c.shape[3]) for c in self.cores)
        wB = max(max(c.shape[0], c.shape[3]) for c in other.cores)
        o = self.out_dims[0]
        i = other.in_dims[0]
        m = self.in_dims[0]

        def pad4(c, w):
            l, x, y, r = c.shape
            return jnp.pad(c.astype(dtype),
                           ((0, w - l), (0, 0), (0, 0), (0, w - r)))

        A = jnp.stack([pad4(c, wA) for c in self.cores])
        B = jnp.stack([pad4(c, wB) for c in other.cores])
        cap = int(min(maxdim, o * i * min(wA * wB, maxdim)))
        out, ranks = _compose_zipup_scan(A, B, float(tol), cap)
        # trim: rank k bond = max used rank (host, once)
        ranks = np.asarray(ranks)
        cores = []
        prev = 1
        for k in range(L):
            ck = np.asarray(out[k])
            r = int(ranks[k]) if k < L - 1 else 1
            cores.append(jnp.asarray(ck[:prev, :, :, :r]))
            prev = max(r, 1)
        return MPO(cores)

    def compose_naive(self, other: "MPO") -> "MPO":
        """self @ other as an MPO (ranks multiply)."""
        if self.in_dims != other.out_dims:
            raise ValueError("compose: dims mismatch")
        out = []
        for W, V in zip(self.cores, other.cores):
            l0, o, m, l1 = W.shape
            k0, _, i, k1 = V.shape
            c = jnp.einsum("lomd,kmie->lkoide", W, V)
            out.append(c.reshape(l0 * k0, o, i, l1 * k1))
        return MPO(out)

    def compose_zipup(
        self, other: "MPO", tol: float = 1e-12, maxdim: Optional[int] = None
    ) -> "MPO":
        """self @ other with on-the-fly truncation (ref MPO zipup)."""
        if self.in_dims != other.out_dims:
            raise ValueError("compose: dims mismatch")
        pol = SvdTruncationPolicy(
            tol=tol,
            scale=ThresholdScale.RELATIVE,
            measure=SingularValueMeasure.VALUE,
            maxdim=maxdim,
        )
        L = len(self)
        dtype = jnp.result_type(self.cores[0].dtype, other.cores[0].dtype)
        C = jnp.ones((1, 1, 1), dtype=dtype)
        out_cores = []
        for k in range(L):
            W, V = self.cores[k], other.cores[k]
            l0, o, m, l1 = W.shape
            k0, _, i, k1 = V.shape
            theta = jnp.einsum("xlk,lomd,kmie->xoide", C, W, V)
            chi = theta.shape[0]
            if k == L - 1:
                out_cores.append(theta.reshape(chi, o, i, l1 * k1))
                break
            mm = theta.reshape(chi * o * i, l1 * k1)
            u, s, vh, _ = truncated_svd_matrix(mm, pol)
            r = u.shape[1]
            out_cores.append(u.reshape(chi, o, i, r))
            C = (s[:, None] * vh).reshape(r, l1, k1)
        return MPO(out_cores)


@functools.partial(jax.jit, static_argnames=("cap",))
def _compose_zipup_scan(A, B, tol, cap):
    """Jitted left-to-right truncating zipup over stacked padded MPO
    cores: A (L, wA, o, m, wA), B (L, wB, m, i, wB). Returns padded
    output cores (L, cap, o, i, cap) + per-bond used ranks."""
    L, wA, o, m, _ = A.shape
    wB = B.shape[1]
    i = B.shape[3]
    dtype = jnp.result_type(A.dtype, B.dtype)

    def body(carry, ab):
        C = carry  # (cap, wA, wB)
        Ak, Bk = ab
        theta = jnp.einsum("xab,aopu,bpiv->xoiuv", C, Ak, Bk,
                           optimize=True)
        mat = theta.reshape(cap * o * i, wA * wB)
        u, s, vh = jnp.linalg.svd(mat, full_matrices=False)
        keep = jnp.minimum(cap, s.shape[0])
        thresh = tol * jnp.maximum(s[0], 1e-300)
        mask = (s >= thresh) & (jnp.arange(s.shape[0]) < keep)
        rank = jnp.sum(mask).astype(jnp.int32)
        s_m = jnp.where(mask, s, 0.0)
        r = min(int(s.shape[0]), cap)  # static
        # pad/trim factor columns out to cap (masked tail is exact zero)
        u_p = jnp.zeros((cap * o * i, cap), dtype).at[:, :r].set(
            (u * mask[None, :].astype(dtype))[:, :r])
        c_p = jnp.zeros((cap, wA * wB), dtype).at[:r, :].set(
            (s_m[:, None].astype(dtype) * vh)[:r, :])
        core = u_p.reshape(cap, o, i, cap)
        return c_p.reshape(cap, wA, wB), (core, rank)

    C0 = jnp.zeros((cap, wA, wB), dtype).at[0, 0, 0].set(1.0)
    Cf, (cores, ranks) = jax.lax.scan(body, C0, (A, B))
    # the scan also split the LAST site; fold the residual carry back in
    # (its boundary links live at slot 0 of the padding)
    last = jnp.einsum("xoiu,u->xoi", cores[-1], Cf[:, 0, 0])
    cores = cores.at[-1].set(jnp.zeros_like(cores[-1])
                             .at[:, :, :, 0].set(last))
    return cores, ranks


def _svd_np(mm: np.ndarray):
    """Host SVD tuned for small matrices: scipy skips the finite check
    and reuses the operand buffer (np.linalg.svd costs ~4x at 32x64)."""
    try:
        import scipy.linalg as sla

        return sla.svd(mm, full_matrices=False, overwrite_a=True,
                       check_finite=False)
    except Exception:  # noqa: BLE001 — scipy optional
        return np.linalg.svd(mm, full_matrices=False)


def _small_cpu_mpo(mpo: "MPO", cap: int = 64) -> bool:
    """True when the composition is latency-bound on the CPU backend:
    every bond small enough that host LAPACK wins over jit dispatch."""
    from ..core.decomp import _on_cpu_backend

    if not _on_cpu_backend():
        return False
    return all(max(c.shape[0], c.shape[3]) <= cap
               and c.shape[1] * c.shape[2] <= 16 for c in mpo.cores)


def _compose_zipup_np(a: "MPO", b: "MPO", tol: float,
                      maxdim: Optional[int]) -> "MPO":
    """Host-numpy zipup composition (same policy/semantics as
    `MPO.compose_zipup`): one LAPACK sweep, no per-op jit dispatch."""
    A = [np.asarray(c) for c in a.cores]
    B = [np.asarray(c) for c in b.cores]
    L = len(A)
    dtype = np.result_type(A[0].dtype, B[0].dtype)
    C = np.ones((1, 1, 1), dtype=dtype)
    out = []
    for k in range(L):
        W, V = A[k], B[k]
        _, o, _, l1 = W.shape
        _, _, i, k1 = V.shape
        # xlk,lomd,kmie->xoide via two BLAS tensordots (np.einsum with
        # optimize=True re-searches the path every call — measurable at
        # these latency-bound sizes)
        t1 = np.tensordot(C, W, axes=([1], [0]))  # x,k,o,m,d
        theta = np.tensordot(t1, V, axes=([1, 3], [0, 1]))  # x,o,d,i,e
        theta = theta.transpose(0, 1, 3, 2, 4)  # x,o,i,d,e
        chi = theta.shape[0]
        if k == L - 1:
            out.append(theta.reshape(chi, o, i, l1 * k1))
            break
        mm = theta.reshape(chi * o * i, l1 * k1)
        u, s, vh = _svd_np(mm)
        scale = s[0] if s.size and s[0] > 0 else 1.0
        r = max(int(np.sum(s >= tol * scale)), 1)
        if maxdim is not None:
            r = min(r, maxdim)
        out.append(u[:, :r].reshape(chi, o, i, r))
        C = (s[:r, None] * vh[:r]).reshape(r, l1, k1)
    return MPO(out)
