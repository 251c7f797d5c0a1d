"""Quantics-space transform operators (MPO constructors).

JAX rebuild of tensor4all-quanticstransform/src/
(flip.rs:41 `flip_operator`, shift.rs:45,81 `shift_operator{,_multivar}`,
phase_rotation.rs:55, cumsum.rs:72,106 `cumsum_operator`/`triangle`,
fourier.rs:202 `quantics_fourier_operator` (Chen-Lindsey QFT MPO,
arXiv:2404.03182), affine.rs:487 `affine_operator`,
difference_kernel.rs:24 `difference_kernel_mpo`).

Conventions: 1-D quantics TTs have R sites of dim 2, MSB first (site 0 is
the most significant bit). An operator O acts as ``(O f)(x) = f(sigma(x))``
with MPO element ``O[out=x, in=y]``. Carry automata (shift/affine) run
LSB->MSB, i.e. the MPO bond carries the carry right-to-left; boundary
condition ``periodic`` wraps mod 2^R, ``open`` zeroes out-of-range.

All cores are built densely on host (they are tiny: bond dims 2..a+2) and
handed to XLA as rank-4 arrays (tt.MPO).
"""

from __future__ import annotations

import enum
from typing import List, Optional, Sequence

import numpy as np

from ..tt.mpo import MPO
from ..tt.tensortrain import TensorTrain


def _bits_msb_first(value: int, R: int) -> List[int]:
    return [(value >> (R - 1 - b)) & 1 for b in range(R)]


def shift_operator(R: int, shift: int, bc: str = "periodic",
                   dtype=np.float64) -> MPO:
    """(O f)(x) = f(x + shift) (ref shift.rs:45).

    Carry automaton: ``in = out + shift`` bit by bit, LSB->MSB. Bond value
    on the link right of site b = carry into site b. ``periodic`` wraps
    modulo 2^R; ``open`` gives 0 where x + shift leaves [0, 2^R).
    """
    if bc not in ("periodic", "open"):
        raise ValueError("bc must be 'periodic' or 'open'")
    s = shift % (1 << R) if bc == "periodic" else shift
    if bc == "open" and not (-(1 << R) < shift < (1 << R)):
        return MPO([np.zeros((1, 2, 2, 1), dtype)[...] for _ in range(R)])
    if bc == "open" and shift < 0:
        # f(x + s) with negative s: in = out + s fails the non-negative
        # carry automaton; build as the transpose of the +|s| shift
        pos = shift_operator(R, -shift, bc="open", dtype=dtype)
        return MPO([np.swapaxes(c, 1, 2) for c in pos.cores])
    sbits = _bits_msb_first(s if s >= 0 else s % (1 << R), R)
    # carry in {0,1}
    cores = []
    for b in range(R):
        l_dim = 1 if b == 0 else 2
        r_dim = 1 if b == R - 1 else 2
        W = np.zeros((l_dim, 2, 2, r_dim), dtype)
        for out in (0, 1):
            for r in range(r_dim):
                tot = out + sbits[b] + r
                inn = tot & 1
                carry = tot >> 1
                if b == 0:
                    if bc == "open" and carry != 0:
                        continue  # overflow forbidden
                    W[0, out, inn, r] += 1.0
                else:
                    W[carry, out, inn, r] += 1.0
        cores.append(W)
    return MPO(cores)


def bitflip_operator(R: int, dtype=np.float64) -> MPO:
    """(O f)(x) = f(2^R - 1 - x): bitwise NOT, rank 1."""
    X = np.array([[0.0, 1.0], [1.0, 0.0]], dtype)
    return MPO([X[None, :, :, None] for _ in range(R)])


def flip_operator(R: int, dtype=np.float64) -> MPO:
    """(O f)(x) = f((-x) mod 2^R) (ref flip.rs:41).

    Composition: bitflip then +1 shift — f((2^R-1-x)+1) = f(-x mod 2^R).
    """
    return bitflip_operator(R, dtype).compose_zipup(
        shift_operator(R, 1, bc="periodic", dtype=dtype), tol=1e-14
    )


def phase_rotation_operator(R: int, theta: float) -> MPO:
    """(O f)(x) = e^{i theta x} f(x) (ref phase_rotation.rs:55); rank 1."""
    cores = []
    for b in range(R):
        w = np.exp(1j * theta * (1 << (R - 1 - b)))
        D = np.diag([1.0 + 0j, w])
        cores.append(D[None, :, :, None])
    return MPO(cores)


def cumsum_operator(R: int, inclusive: bool = False,
                    dtype=np.float64) -> MPO:
    """(O f)(x) = sum_{y < x} f(y) (ref cumsum.rs:72); ``inclusive`` adds
    the y = x term (triangle_operator, :106).

    Comparison automaton MSB->LSB: state 0 = bits equal so far,
    state 1 = already y < x. Exact bond dimension 2.
    """
    E, D = 0, 1
    cores = []
    for b in range(R):
        l_dim = 1 if b == 0 else 2
        r_dim = 1 if b == R - 1 else 2
        W = np.zeros((l_dim, 2, 2, r_dim), dtype)
        for l in range(2):
            if b == 0 and l != E:
                continue
            for x in (0, 1):
                for y in (0, 1):
                    if l == D:
                        nxt = D
                    elif x == y:
                        nxt = E
                    elif y < x:
                        nxt = D
                    else:
                        continue  # y > x with equal prefix: rejected
                    if b == R - 1:
                        accept = (nxt == D) or (inclusive and nxt == E)
                        if accept:
                            W[min(l, l_dim - 1), x, y, 0] += 1.0
                    else:
                        W[min(l, l_dim - 1), x, y, nxt] += 1.0
        cores.append(W)
    return MPO(cores)


class TriangleType(enum.Enum):
    """Which strict triangle a triangle_operator realizes
    (ref cumsum.rs:35 `TriangleType`)."""

    LOWER = "lower"  # M[i,j] = 1 for i > j: prefix sum
    UPPER = "upper"  # M[i,j] = 1 for i < j: suffix sum


def triangle_operator(R: int, triangle: "TriangleType | str" = TriangleType.LOWER,
                      inclusive: bool = False, dtype=np.float64) -> MPO:
    """Strict triangular sum operator (ref cumsum.rs:106
    `triangle_operator`): LOWER gives y_i = sum_{j<i} x_j (== cumsum),
    UPPER gives y_i = sum_{j>i} x_j. `inclusive=True` adds the j = i
    term (this package's extension; the reference triangles are strict)."""
    if isinstance(triangle, str):
        triangle = TriangleType(triangle)
    lower = cumsum_operator(R, inclusive=inclusive, dtype=dtype)
    if triangle is TriangleType.LOWER:
        return lower
    return lower.transpose()


def _chebyshev_grid(K: int):
    """Chebyshev points on [0,1] + barycentric weights
    (ref fourier.rs chebyshev_grid)."""
    j = np.arange(K + 1)
    grid = 0.5 * (1.0 - np.cos(np.pi * j / K))
    w = np.ones(K + 1)
    for a in range(K + 1):
        diff = grid[a] - np.delete(grid, a)
        w[a] = 1.0 / np.prod(diff)
    return grid, w


def _lagrange_matrix(grid: np.ndarray, w: np.ndarray,
                     x: np.ndarray) -> np.ndarray:
    """P[alpha, m] = P_alpha(x_m), barycentric form, exact at nodes."""
    diff = x[None, :] - grid[:, None]  # (K+1, M)
    exact = np.abs(diff) < 1e-14
    safe = np.where(exact, 1.0, diff)
    # stable product over all nodes, handling the exact-node case per col
    full_prod = np.ones(x.shape)
    for g in grid:
        full_prod = full_prod * (x - g)
    P = full_prod[None, :] * w[:, None] / safe
    # columns where x hits a node exactly: delta
    hit_col = exact.any(axis=0)
    if hit_col.any():
        P[:, hit_col] = exact[:, hit_col].astype(float)
    return P


def quantics_fourier_operator(
    R: int,
    sign: int = -1,
    tol: float = 1e-14,
    maxdim: Optional[int] = 12,
    normalize: bool = True,
    K: int = 25,
) -> MPO:
    """QFT as a quantics MPO, built by the DIRECT Chen-Lindsey
    interpolative construction (ref fourier.rs:202-388,
    arXiv:2404.03182) — deterministic, no TCI at construction time.

    ``F[k, x] = 2^{-R/2} exp(sign * 2*pi*i * k x / 2^R)`` with the OUTPUT
    bits in bit-reversed order (site j carries k_{R-1-j}); apply then
    ``TensorTrain.reverse()`` for MSB-first ordering of k.

    Core tensor: ``A[alpha, tau, sigma, beta] = P_alpha(x) *
    exp(2*pi*i*sign*x*tau)`` with ``x = (sigma + cheb[beta]) / 2`` on a
    (K+1)-point Chebyshev grid; first core sums alpha, last selects
    beta=0; SVD-compressed to `maxdim` (bond ~11 at 1e-12, independent
    of R — LU compression was measurably worse here: rank-12 LU left
    3e-4 error at R=10 where rank-11 SVD is exact to 1e-14).
    """
    if R < 2:
        raise ValueError("R must be at least 2")
    grid, w = _chebyshev_grid(K)
    # x[sigma, beta] = (sigma + grid[beta]) / 2
    sig = np.arange(2)
    x = (sig[:, None] + grid[None, :]) / 2.0  # (2, K+1)
    P = _lagrange_matrix(grid, w, x.reshape(-1)).reshape(
        K + 1, 2, K + 1)  # (alpha, sigma, beta)
    tau = np.arange(2)
    phase = np.exp(2j * np.pi * float(sign) * x[None, :, :]
                   * tau[:, None, None])  # (tau, sigma, beta)
    core = P[:, None, :, :] * phase[None, :, :, :]  # (alpha,tau,sigma,beta)
    first = core.sum(axis=0)[None]  # (1, tau, sigma, K+1)
    last = core[..., :1]  # (alpha, tau, sigma, 1)
    cores3 = [first.reshape(1, 4, K + 1)]
    for _ in range(1, R - 1):
        cores3.append(core.reshape(K + 1, 4, K + 1))
    cores3.append(last.reshape(K + 1, 4, 1))
    tt = TensorTrain([c.astype(np.complex128) for c in cores3])
    tt = tt.compress(tol=tol, maxdim=maxdim, method="svd")
    norm = 2.0 ** (-0.5) if normalize else 1.0
    cores = []
    for c in tt.cores:
        l, _, r = c.shape
        cores.append(np.asarray(c).reshape(l, 2, 2, r) * norm)
    return MPO(cores)


def _affine_scaled(A, b, m: int, n: int):
    """Rational (A, b) -> integer (A_int, b_int, scale) with scale = lcm
    of denominators (ref affine.rs to_integer_scaled)."""
    from fractions import Fraction
    from math import lcm

    A = [[Fraction(A[i][j]) for j in range(n)] for i in range(m)]
    b = [Fraction(v) for v in b]
    scale = 1
    for row in A:
        for v in row:
            scale = lcm(scale, v.denominator)
    for v in b:
        scale = lcm(scale, v.denominator)
    A_int = [[int(A[i][j] * scale) for j in range(n)] for i in range(m)]
    b_int = [int(v * scale) for v in b]
    return A_int, b_int, scale


def _affine_core(A_int, b_curr, scale, m, n, carries_in, activebit):
    """One bit-plane of the carry automaton (ref affine.rs:1194
    affine_transform_core): condition ``scale*y = A x + b`` bit by bit.

    Returns (carries_out sorted, tensor[cout, cin, site]) with
    site = y_bits | (x_bits << m); inactive planes have site dim 1.
    """
    x_range = 1 << n if activebit else 1
    y_range = 1 << m if activebit else 1
    site_dim = x_range * y_range
    cmap = {}
    for c_idx, cin in enumerate(carries_in):
        for x_bits in range(x_range):
            x = [(x_bits >> j) & 1 for j in range(n)]
            z = [cin[i] + b_curr[i]
                 + sum(A_int[i][j] * x[j] for j in range(n))
                 for i in range(m)]
            if scale % 2 == 1:
                y = [zi & 1 for zi in z]
                if not activebit and any(y):
                    continue
                y_bits = sum(yi << i for i, yi in enumerate(y))
                cout = tuple((zi - scale * yi) >> 1
                             for zi, yi in zip(z, y))
                site = y_bits | (x_bits << m)
                cmap.setdefault(cout, set()).add((c_idx, site))
            else:
                if any(zi % 2 for zi in z):
                    continue
                for y_bits in range(y_range):
                    y = [(y_bits >> i) & 1 for i in range(m)]
                    cout = tuple((zi - scale * yi) >> 1
                                 for zi, yi in zip(z, y))
                    site = y_bits | (x_bits << m)
                    cmap.setdefault(cout, set()).add((c_idx, site))
    carries_out = sorted(cmap)
    T = np.zeros((len(carries_out), len(carries_in), site_dim))
    for ci, c in enumerate(carries_out):
        for (cin_idx, site) in cmap[c]:
            T[ci, cin_idx, site] = 1.0
    return carries_out, T


def _affine_bc_weight(carry, bc) -> float:
    w = 1.0
    for c, cond in zip(carry, bc):
        if cond == "periodic":
            pass
        elif cond == "antiperiodic":
            w *= 1.0 if c % 2 == 0 else -1.0
        elif cond == "open":
            if c != 0:
                return 0.0
        else:
            raise ValueError(f"unknown boundary condition {cond!r}")
    return w


def affine_transform_cores(R: int, A, b, bc, dtype=np.float64):
    """Cores of the FORWARD affine map ``y = A x + b`` over quantics bits
    (ref affine.rs:986 affine_transform_tensors): rational M x N matrix
    `A`, M-vector `b` (ints / fractions.Fraction / strings like "1/3"),
    per-output boundary conditions in {"periodic", "open",
    "antiperiodic"}.

    Returns a list of R arrays of shape (l, 2^M, 2^N, r) — site j holds
    bit j (MSB first) of every output (fused, y-minor ordering
    ``y_bits``) and input variable (``x_bits``).
    """
    if R < 1:
        raise ValueError("R must be positive")
    A = [list(row) for row in A]
    m, n = len(A), len(A[0])
    b = list(b)
    if len(b) != m:
        raise ValueError("b length must match A rows")
    if isinstance(bc, str):
        bc = [bc] * m
    if len(bc) != m:
        raise ValueError("bc length must match output count")
    A_int, b_int, scale = _affine_scaled(A, b, m, n)
    bsign = [1 if v >= 0 else -1 for v in b_int]
    b_work = [abs(v) for v in b_int]
    carries = [tuple([0] * m)]
    planes = []  # LSB first: (carries_in, carries_out, tensor)
    for _ in range(R):
        b_curr = [(bw & 1) * s for bw, s in zip(b_work, bsign)]
        cin = carries
        carries, T = _affine_core(A_int, b_curr, scale, m, n, cin, True)
        planes.append((cin, carries, T))
        b_work = [bw >> 1 for bw in b_work]
    # extension cap for open/antiperiodic when |b| >= 2^R
    needs_ext = any(bw > 0 for bw in b_work) and any(
        c in ("open", "antiperiodic") for c in bc)
    if needs_ext:
        ext = []
        while any(bw > 0 for bw in b_work):
            b_curr = [(bw & 1) * s for bw, s in zip(b_work, bsign)]
            cin = carries
            carries, T = _affine_core(A_int, b_curr, scale, m, n, cin,
                                      False)
            ext.append((cin, carries, T))
            b_work = [bw >> 1 for bw in b_work]
        weights = np.asarray([_affine_bc_weight(c, bc) for c in carries])
        for (cin, couts, T) in reversed(ext):
            weights = np.einsum("o,oip->i", weights, T)
        cap = weights  # indexed by the MSB plane's carry-out
    else:
        cap = np.asarray([_affine_bc_weight(c, bc)
                          for c in planes[-1][1]])
    # assemble cores MSB-first (plane R-1 is the MSB)
    cores = []
    for idx in range(R - 1, -1, -1):
        cin, couts, T = planes[idx]
        is_msb = idx == R - 1
        is_lsb = idx == 0
        ncout, ncin, sd = T.shape
        l_dim = 1 if is_msb else ncout
        r_dim = 1 if is_lsb else ncin
        W = np.zeros((l_dim, sd, r_dim), dtype)
        if is_msb:
            # BC weights close the left boundary (carry_in dim is 1 at
            # the LSB, so this covers R == 1 too)
            W[0] = np.einsum("o,oip->pi", cap, T)
        elif is_lsb:
            W[:, :, 0] = T[:, 0, :]
        else:
            W = np.transpose(T, (0, 2, 1)).astype(dtype)
        # fused site = y_bits | (x_bits << m) is x-major: split as (x, y)
        # then swap to (out=y, in=x)
        W4 = W.reshape(l_dim, 1 << n, 1 << m, r_dim).swapaxes(1, 2)
        cores.append(np.ascontiguousarray(W4))
    return cores


def affine_transform_operator(R: int, A, b, bc="periodic",
                              dtype=np.float64) -> MPO:
    """Forward affine operator ``O[y, x] = [y == A x + b]`` with fused
    per-site dims (2^M out, 2^N in) (ref affine.rs:487
    affine_operator). Transpose for the pullback ``f(y) = g(A y + b)``."""
    return MPO(affine_transform_cores(R, A, b, bc, dtype))


def affine_cores_unfused(R: int, A, b, bc="periodic", dtype=np.float64):
    """Interleaved-variable form (ref affine.rs:566
    affine_operator_interleaved): each core reshaped to
    ``(l, y_0..y_{M-1}, x_0..x_{N-1}, r)`` with binary legs in
    Quantics.jl order."""
    A = [list(row) for row in A]
    m, n = len(A), len(A[0])
    out = []
    for W in affine_transform_cores(R, A, b, bc, dtype):
        l, dy, dx, r = W.shape
        # fused y_bits is y-minor (bit i has weight 2^i): unfuse with
        # y0 fastest (Quantics.jl order y0..yM-1, x0..xN-1)
        t = W.reshape(l, dy, dx, r)
        ybits = np.unravel_index(np.arange(dy), [2] * m, order="F")
        xbits = np.unravel_index(np.arange(dx), [2] * n, order="F")
        full = np.zeros([l] + [2] * (m + n) + [r], dtype)
        for yb in range(dy):
            for xb in range(dx):
                sel = (slice(None),) + tuple(int(v[yb]) for v in ybits) \
                    + tuple(int(v[xb]) for v in xbits) + (slice(None),)
                full[sel] = t[:, yb, xb, :]
        out.append(full)
    return out


def affine_operator(R: int, a, b=0, bc="periodic",
                    dtype=np.float64) -> MPO:
    """(O f)(x) = f(a*x + b) — the 1-D pullback affine operator
    (ref affine.rs:487; transpose of the forward map). `a`, `b` may be
    negative integers or rationals (fractions.Fraction / "p/q")."""
    fwd = affine_transform_operator(R, [[a]], [b], bc=bc, dtype=dtype)
    return MPO([np.swapaxes(c, 1, 2) for c in fwd.cores])


def difference_kernel_mpo(R: int, kind: str = "central",
                          bc: str = "open", dtype=np.float64) -> MPO:
    """Finite-difference kernels from shift operators
    (ref difference_kernel.rs:24): central ``(f(x+1) - f(x-1))/2``,
    forward ``f(x+1) - f(x)``, backward ``f(x) - f(x-1)``.
    Multiply by 1/h (grid step) for a derivative estimate.

    Accuracy note: the output magnitude is ~``h |f'|`` while the apply's
    intermediate bonds carry the un-cancelled ``f`` scale, so a RELATIVE
    apply tolerance ``tol`` leaves an absolute error ``~tol |f|`` that
    is ``tol |f| / h`` in the derivative. At large R (tiny h) use an
    apply tolerance well below ``h``, or ``apply_naive`` (measured at
    R=30: tol 1e-10 -> 1.2% derivative error, tol 1e-14 -> 2e-7).
    """
    if kind == "central":
        m = shift_operator(R, 1, bc, dtype) + shift_operator(R, -1, bc, dtype).scale(-1.0)
        return m.scale(0.5)
    if kind == "forward":
        return shift_operator(R, 1, bc, dtype) + shift_operator(R, 0, bc, dtype).scale(-1.0)
    if kind == "backward":
        return shift_operator(R, 0, bc, dtype) + shift_operator(R, -1, bc, dtype).scale(-1.0)
    raise ValueError("kind must be central/forward/backward")


def difference_kernel_mpo_from_qtt(f, bc: str = "periodic") -> MPO:
    """Convolution (Toeplitz) MPO ``A[x, x'] = f((x - x') mod 2^R)``
    from a binary kernel QTT over the difference coordinate
    (ref difference_kernel.rs:24 `difference_kernel_mpo`).

    The ``z = x - x'`` map is the 2-input affine automaton
    ``A = [[1, -1]]``; its unfused cores carry legs (z, x, x') per bit,
    and contracting the z leg with the kernel cores yields the MPO.
    ``bc="antiperiodic"`` multiplies entries with ``x < x'`` by -1;
    ``"open"`` is rejected (a difference kernel needs wrap-around),
    matching the reference's error contract.
    """
    if bc == "open":
        raise ValueError("open boundary is not supported for "
                         "difference kernels")
    cores = [np.asarray(c) for c in f.cores]
    R = len(cores)
    if R == 0:
        raise ValueError("difference kernel requires a non-empty QTT")
    for s, c in enumerate(cores):
        if c.shape[1] != 2:
            raise ValueError(f"difference kernel requires binary QTT "
                             f"cores; site {s} has site_dim={c.shape[1]}")
    dtype = np.result_type(*[c.dtype for c in cores], np.float64)
    delta = affine_cores_unfused(R, [[1, -1]], [0], bc=bc,
                                 dtype=np.float64)
    out = []
    for dc, fc in zip(delta, cores):
        # dc: (dl, z, x, x', dr); fc: (fl, z, fr)
        t = np.einsum("lzxpr,azb->laxprb", dc, fc.astype(dtype))
        dl, fl, _, _, dr, fr = t.shape
        out.append(t.reshape(dl * fl, 2, 2, dr * fr))
    return MPO(out)


def shift_operator_multivar(R: int, d: int, shifts: Sequence[int],
                            bc: str = "periodic", dtype=np.float64) -> MPO:
    """Per-dimension shifts on an interleaved multivariate quantics TT
    (ref shift.rs:81): dimension k occupies sites k, k+d, k+2d, ...

    Built as the product of per-dimension shift automata embedded with
    identity pass-through on the other dimensions' sites, composed with
    on-the-fly truncation.
    """
    if len(shifts) != d:
        raise ValueError("need one shift per dimension")
    n_sites = R * d
    total: Optional[MPO] = None
    for k, s in enumerate(shifts):
        base = shift_operator(R, s, bc, dtype)
        first, last = k, (R - 1) * d + k  # dim-k sites span [first, last]

        def link_dim(pos: int) -> int:
            """Dim of the link between sites pos and pos+1: the carry is
            in flight only strictly inside the dim-k span."""
            return 2 if first <= pos < last else 1

        cores = []
        for site in range(n_sites):
            scale, dim = divmod(site, d)
            l_dim = 1 if site == 0 else link_dim(site - 1)
            r_dim = 1 if site == n_sites - 1 else link_dim(site)
            if dim == k:
                cores.append(np.asarray(base.cores[scale], dtype).reshape(
                    l_dim, 2, 2, r_dim
                ))
            else:
                c = np.zeros((l_dim, 2, 2, r_dim), dtype)
                for t in range(min(l_dim, r_dim)):
                    c[t, 0, 0, t] = 1.0
                    c[t, 1, 1, t] = 1.0
                cores.append(c)
        m = MPO(cores)
        total = m if total is None else total.compose_zipup(m, tol=1e-13)
    return total


def embed_operator_interleaved(base: MPO, d: int, target_var: int,
                               dtype=None) -> MPO:
    """Embed a 1-D R-site quantics operator into an interleaved
    d-variable layout acting on variable `target_var` (identity on the
    others). Exact: bonds carry the base operator's links between its
    sites; all other links are trivial. This is the common mechanism
    behind the reference's `*_operator_multivar` constructors
    (flip.rs:81, phase_rotation.rs:95, shift.rs:81)."""
    if not 0 <= target_var < d:
        raise ValueError("target_var out of range")
    R = len(base)
    if dtype is None:
        dtype = np.result_type(*[np.asarray(c).dtype for c in base.cores])
    n_sites = R * d

    def link(c: int) -> int:
        """Link dim between base cores c-1 and c (1 outside the span)."""
        if c <= 0 or c >= R:
            return 1
        return int(base.cores[c].shape[0])

    cores = []
    for site in range(n_sites):
        scale, dim = divmod(site, d)
        # base cores fully placed strictly before this site
        placed = scale + (1 if dim > target_var else 0)
        l_dim = 1 if site == 0 else link(placed if dim != target_var
                                         else scale)
        if dim == target_var:
            cores.append(np.asarray(base.cores[scale], dtype))
        else:
            r_dim = link(placed)
            c = np.zeros((l_dim, 2, 2, r_dim), dtype)
            for t in range(min(l_dim, r_dim)):
                c[t, 0, 0, t] = 1.0
                c[t, 1, 1, t] = 1.0
            cores.append(c)
    return MPO(cores)


def flip_operator_multivar(R: int, d: int, target_var: int,
                           dtype=np.float64) -> MPO:
    """Flip x -> (-x) mod 2^R on one variable of an interleaved
    multivariate quantics operator (ref flip.rs:81)."""
    return embed_operator_interleaved(flip_operator(R, dtype), d,
                                      target_var, dtype)


def phase_rotation_operator_multivar(R: int, theta: float, d: int,
                                     target_var: int) -> MPO:
    """e^{i theta x_k} on one interleaved variable
    (ref phase_rotation.rs:95)."""
    return embed_operator_interleaved(phase_rotation_operator(R, theta),
                                      d, target_var, np.complex128)


def cumsum_operator_multivar(R: int, d: int, target_var: int,
                             inclusive: bool = False,
                             dtype=np.float64) -> MPO:
    """Prefix sum over one interleaved variable (ref capi
    t4a_qtransform_cumsum_materialize's target_var)."""
    return embed_operator_interleaved(
        cumsum_operator(R, inclusive=inclusive, dtype=dtype), d,
        target_var, dtype)


def difference_kernel_operator(f, bc: str = "periodic",
                               site_indices=None):
    """Convolution-kernel MPO wrapped as a TreeOperator (ref
    difference_kernel.rs:100 `difference_kernel_operator`): builds
    `difference_kernel_mpo_from_qtt(f, bc)` and binds it to
    `site_indices` (one dim-2 Index per site)."""
    from ..treetn.operator import mpo_to_treeoperator

    mpo = difference_kernel_mpo_from_qtt(f, bc=bc)
    if site_indices is None:
        from ..core.index import Index

        site_indices = [Index(2, tags=f"Site,q{k}")
                        for k in range(len(mpo))]
    return mpo_to_treeoperator(mpo, list(site_indices))


def apply_quantics_operator(op: MPO, tt: TensorTrain, tol: float = 1e-12,
                            maxdim: Optional[int] = None) -> TensorTrain:
    """Apply a transform MPO to a quantics TT with truncation."""
    return op.apply_zipup(tt, tol=tol, maxdim=maxdim)
