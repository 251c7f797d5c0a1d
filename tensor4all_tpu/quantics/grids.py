"""Quantics grids: coordinates <-> bit-string tensor indices.

JAX rebuild of the reference's external `quanticsgrids` dependency
(used by tensor4all-quanticstci, src/lib.rs:1-99): a d-dimensional box is
discretized on 2^R points per dimension; grid points are addressed by R
bits per dimension (MSB first), unfolded into tensor sites either
``interleaved`` (R*d sites of local dim 2: bit-major, dimension-minor) or
``fused`` (R sites of local dim 2^d: one bit of every dimension per site).

All index math is vectorized numpy over batches — the form the TCI hot
loop consumes.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Sequence, Tuple

import numpy as np


class UnfoldingScheme(enum.Enum):
    INTERLEAVED = "interleaved"
    FUSED = "fused"


@dataclasses.dataclass(frozen=True)
class InherentDiscreteGrid:
    """Integer grid {0..2^R-1}^d (ref quanticsgrids InherentDiscreteGrid)."""

    R: int
    d: int = 1
    unfolding: UnfoldingScheme = UnfoldingScheme.INTERLEAVED

    @property
    def n_sites(self) -> int:
        return self.R * self.d if self.unfolding is UnfoldingScheme.INTERLEAVED else self.R

    @property
    def local_dims(self) -> list:
        if self.unfolding is UnfoldingScheme.INTERLEAVED:
            return [2] * (self.R * self.d)
        return [2 ** self.d] * self.R

    # ------------------------------------------------------------------
    def index_to_quantics(self, m: np.ndarray) -> np.ndarray:
        """(B, d) integer coords -> (B, n_sites) quantics digits."""
        if self.R > 62:
            return self._index_to_quantics_bigint(m)
        m = np.asarray(m, dtype=np.int64)
        if m.ndim == 1:
            m = m[:, None]
        B, d = m.shape
        if d != self.d:
            raise ValueError(f"expected {self.d} coords, got {d}")
        if np.any((m < 0) | (m >= 2 ** self.R)):
            raise ValueError("coordinate out of range")
        # bits[b, :, k] = bit at scale b (MSB first) of dim k
        shifts = np.arange(self.R - 1, -1, -1, dtype=np.int64)
        bits = (m[:, None, :] >> shifts[None, :, None]) & 1  # (B, R, d)
        if self.unfolding is UnfoldingScheme.INTERLEAVED:
            return bits.reshape(B, self.R * self.d)
        # fused: digit at scale b = sum_k bit_k 2^k (dim-0 least significant)
        weights = (1 << np.arange(self.d, dtype=np.int64))
        return (bits * weights[None, None, :]).sum(axis=2)

    def _index_to_quantics_bigint(self, m) -> np.ndarray:
        """Arbitrary-R path via Python big ints (the reference's
        quanticsgrids uses u64->bigint widening; int64 shifts silently
        overflow past R = 62). Digits stay an int64 array — each digit
        is tiny — only the coordinate integers are unbounded."""
        rows = np.asarray(m, dtype=object)
        if rows.ndim == 1:
            rows = rows[:, None]
        B = len(rows)
        top = 1 << self.R
        out = np.zeros((B, self.n_sites), dtype=np.int64)
        for bi in range(B):
            vals = [int(v) for v in rows[bi]]
            if len(vals) != self.d:
                raise ValueError(f"expected {self.d} coords")
            for v in vals:
                if not 0 <= v < top:
                    raise ValueError("coordinate out of range")
            for b in range(self.R):
                sh = self.R - 1 - b
                if self.unfolding is UnfoldingScheme.INTERLEAVED:
                    for k, v in enumerate(vals):
                        out[bi, b * self.d + k] = (v >> sh) & 1
                else:
                    out[bi, b] = sum(((v >> sh) & 1) << k
                                     for k, v in enumerate(vals))
        return out

    def quantics_to_index(self, q: np.ndarray) -> np.ndarray:
        """(B, n_sites) quantics digits -> (B, d) integer coords
        (object-dtype Python ints when R > 62)."""
        q = np.asarray(q, dtype=np.int64)
        B = q.shape[0]
        if q.shape[1] != self.n_sites:
            raise ValueError(f"expected {self.n_sites} sites")
        if self.unfolding is UnfoldingScheme.INTERLEAVED:
            bits = q.reshape(B, self.R, self.d)
        else:
            weights = np.arange(self.d, dtype=np.int64)
            bits = (q[:, :, None] >> weights[None, None, :]) & 1
        if self.R > 62:
            out = np.empty((B, self.d), dtype=object)
            for bi in range(B):
                for k in range(self.d):
                    v = 0
                    for b in range(self.R):
                        v = (v << 1) | int(bits[bi, b, k])
                    out[bi, k] = v
            return out
        shifts = (1 << np.arange(self.R - 1, -1, -1, dtype=np.int64))
        return (bits * shifts[None, :, None]).sum(axis=1)


@dataclasses.dataclass(frozen=True)
class DiscretizedGrid:
    """Continuous box discretized on 2^R points per dim
    (ref quanticsgrids DiscretizedGrid). Point m maps to
    ``lower + m * (upper - lower) / 2^R`` (half-open box)."""

    R: int
    lower: Tuple[float, ...]
    upper: Tuple[float, ...]
    unfolding: UnfoldingScheme = UnfoldingScheme.INTERLEAVED

    def __post_init__(self):
        if len(self.lower) != len(self.upper):
            raise ValueError("lower/upper length mismatch")
        object.__setattr__(self, "lower", tuple(float(x) for x in self.lower))
        object.__setattr__(self, "upper", tuple(float(x) for x in self.upper))

    @staticmethod
    def create(R: int, lower, upper, unfolding=UnfoldingScheme.INTERLEAVED):
        if np.isscalar(lower):
            lower, upper = (lower,), (upper,)
        return DiscretizedGrid(R, tuple(lower), tuple(upper), unfolding)

    @property
    def d(self) -> int:
        return len(self.lower)

    @property
    def discrete(self) -> InherentDiscreteGrid:
        return InherentDiscreteGrid(self.R, self.d, self.unfolding)

    @property
    def n_sites(self) -> int:
        return self.discrete.n_sites

    @property
    def local_dims(self) -> list:
        return self.discrete.local_dims

    @property
    def step(self) -> np.ndarray:
        return (np.asarray(self.upper) - np.asarray(self.lower)) / 2 ** self.R

    @property
    def cell_volume(self) -> float:
        return float(np.prod(self.step))

    def index_to_coord(self, m: np.ndarray) -> np.ndarray:
        if self.R > 62:
            m = np.asarray(m, dtype=object)
            if m.ndim == 1:
                m = m[:, None]
            m = m.astype(np.float64)  # coords are float64 anyway
        else:
            m = np.asarray(m, dtype=np.int64)
            if m.ndim == 1:
                m = m[:, None]
        return np.asarray(self.lower)[None, :] + m * self.step[None, :]

    def coord_to_index(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        if x.ndim == 1:
            x = x[:, None]
        scaled = np.floor(
            (x - np.asarray(self.lower)[None, :]) / self.step[None, :] + 0.5
        )
        if self.R > 62:
            # float64 resolves ~2^53 distinct coordinates; the bit index
            # beyond that is exact for the float value itself (the
            # precision limit is inherent to float coordinates, as in
            # the reference's f64-based quanticsgrids)
            top = (1 << self.R) - 1
            out = np.empty(scaled.shape, dtype=object)
            for pos, v in np.ndenumerate(scaled):
                out[pos] = min(max(int(v), 0), top)
            return out
        m = scaled.astype(np.int64)
        return np.clip(m, 0, 2 ** self.R - 1)

    def quantics_to_coord(self, q: np.ndarray) -> np.ndarray:
        return self.index_to_coord(self.discrete.quantics_to_index(q))

    def coord_to_quantics(self, x: np.ndarray) -> np.ndarray:
        return self.discrete.index_to_quantics(self.coord_to_index(x))
