"""Memoized black-box function evaluation with batch support.

JAX rebuild of tensor4all-tcicore/src/cached_function/mod.rs:391-793
(`CachedFunction`): thread-safe memoization of ``f(multi-index) -> value``
keyed by mixed-radix packed integers, with batch evaluation and hit
statistics.

The host/device boundary design (SURVEY.md §7 hard part 3): the *primary*
contract is a batched function ``f_batch(idx: (B, L) int array) -> (B,)``.
For jittable f this is a single device program over the whole batch (and
shardable over a mesh via `parallel`); for Python black boxes it is one
host callback per batch instead of per point — preserving the reference's
batched-f API (tensorci2.rs:1586-1608).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Sequence

import numpy as np


class CachedFunction:
    """Memoized function over multi-indices.

    Args:
      f: scalar function ``f(tuple) -> value`` (optional if batch_f given).
      local_dims: dimension of each index slot (defines the key packing).
      batch_f: batched evaluator ``f(np.ndarray (B,L)) -> np.ndarray (B,)``.
        If absent, batches loop over `f` on host.
    """

    def __init__(
        self,
        f: Optional[Callable] = None,
        local_dims: Optional[Sequence[int]] = None,
        batch_f: Optional[Callable] = None,
        dtype=np.float64,
        jax_f: Optional[Callable] = None,
        mesh=None,
    ):
        if f is None and batch_f is None and jax_f is None:
            raise ValueError("need f, batch_f, or jax_f")
        if jax_f is not None:
            # pure-device fast path; with a mesh the batch axis is
            # sharded over it (the multi-chip TCI Pi-fill, SURVEY §5.8)
            batch_f = make_jax_batch_f(jax_f, len(local_dims or ()),
                                       mesh=mesh)
        self.f = f
        self.batch_f = batch_f
        # kept for device-resident consumers (the fused Pi+rrLU bond
        # update jits jax_f INTO its per-bond program)
        self.jax_f = jax_f
        if local_dims is None:
            raise ValueError("local_dims required")
        self.local_dims = tuple(int(d) for d in local_dims)
        # mixed-radix weights for packed integer keys (ref cache_key.rs /
        # index_int.rs — Python ints are arbitrary-precision, subsuming the
        # reference's u64->U1024 auto-widening)
        w = [1]
        for d in self.local_dims[:-1]:
            w.append(w[-1] * d)
        self._weights = np.asarray(w, dtype=object)
        self._wvec = np.asarray(w, dtype=np.float64)  # overflow check only
        # vectorized int64 packing when the key space fits (the common
        # case; Python big-int fallback keeps the reference's u64->U1024
        # auto-widening semantics)
        total = w[-1] * self.local_dims[-1]
        self._w64 = (np.asarray(w, dtype=np.int64)
                     if total < (1 << 62) else None)
        self._dims_arr = np.asarray(self.local_dims, dtype=np.int64)
        self.dtype = np.dtype(dtype)
        self._cache: dict = {}
        self._lock = threading.Lock()
        self.num_evals = 0
        self.num_cache_hits = 0

    def __len__(self):
        return len(self.local_dims)

    def _key(self, idx) -> int:
        k = 0
        for v, d, w in zip(idx, self.local_dims, self._weights):
            vi = int(v)
            if not 0 <= vi < d:
                raise IndexError(f"index {vi} out of range for dim {d}")
            k += vi * w
        return k

    def __call__(self, idx):
        key = self._key(idx)
        with self._lock:
            if key in self._cache:
                self.num_cache_hits += 1
                return self._cache[key]
        val = self._eval_batch_raw(np.asarray([idx], dtype=np.int64))[0]
        with self._lock:
            self._cache[key] = val
        return val

    def _eval_batch_raw(self, idx: np.ndarray) -> np.ndarray:
        self.num_evals += int(idx.shape[0])
        if self.batch_f is not None:
            out = np.asarray(self.batch_f(idx))
            if out.shape != (idx.shape[0],):
                raise ValueError(
                    f"batch_f returned shape {out.shape}, expected ({idx.shape[0]},)"
                )
            return out.astype(self.dtype, copy=False)
        return np.asarray([self.f(tuple(row)) for row in idx], dtype=self.dtype)

    def eval_batch(self, idx) -> np.ndarray:
        """Evaluate a batch (B, L), consulting and filling the cache."""
        idx = np.asarray(idx, dtype=np.int64)
        if idx.ndim != 2 or idx.shape[1] != len(self.local_dims):
            raise ValueError(f"batch must be (B, {len(self.local_dims)})")
        B = idx.shape[0]
        if self._w64 is not None:
            if ((idx < 0) | (idx >= self._dims_arr[None, :])).any():
                raise IndexError("index out of range")
            keys = (idx @ self._w64).tolist()
        else:
            keys = [self._key(row) for row in idx]
        with self._lock:
            # one C-level pass for the probe (per-element Python loops
            # dominate the TCI sweep cost otherwise)
            hit_vals = list(map(self._cache.get, keys))
            missing_pos = [b for b, v in enumerate(hit_vals) if v is None]
            n_miss = len(missing_pos)
            self.num_cache_hits += B - n_miss
        if not n_miss:
            return np.asarray(hit_vals, dtype=self.dtype)
        out = np.asarray([0 if v is None else v for v in hit_vals],
                         dtype=self.dtype)
        vals = self._eval_batch_raw(idx[missing_pos])
        out[missing_pos] = vals
        typ = self.dtype.type
        with self._lock:
            for b, v in zip(missing_pos, vals.tolist()):
                self._cache[keys[b]] = typ(v)
        return out

    def cache_items(self):
        """Decode the memo into (multi-index tuple, value) pairs
        (ref quantics_tci.rs `cachedata`)."""
        out = []
        with self._lock:
            items = list(self._cache.items())
        for key, val in items:
            idx = []
            k = int(key)
            for d, w in zip(self.local_dims, self._weights):
                idx.append((k // int(w)) % d)
            out.append((tuple(idx), val))
        return out

    @property
    def cache_size(self) -> int:
        return len(self._cache)

    @property
    def cache_hit_ratio(self) -> float:
        tot = self.num_cache_hits + self.num_evals
        return self.num_cache_hits / tot if tot else 0.0

    def clear(self):
        with self._lock:
            self._cache.clear()


def make_jax_batch_f(jax_f, n_args: int, mesh=None):
    """Wrap a jittable pointwise JAX function into a batched evaluator.

    `jax_f` takes an (L,)-int array (or L scalars) and returns a scalar;
    the result is vmapped+jitted over the batch — the pure-device fast path
    for jittable integrands. With `mesh`, the batch axis is sharded over
    the device mesh (parallel.shard_batch_eval): the TCI hot loop runs
    data-parallel over the mesh.
    """
    import jax

    batched = jax.vmap(jax_f)
    if mesh is not None:
        from ..parallel.mesh import shard_batch_eval

        return shard_batch_eval(batched, mesh=mesh)
    jitted = jax.jit(batched)

    def batch_f(idx: np.ndarray) -> np.ndarray:
        # bucket-pad the batch axis: TCI emits a different B at every
        # bond update, and one XLA compile per distinct B costs seconds.
        # Padding repeats row 0 (always a valid index tuple).
        idx = np.asarray(idx)
        B = idx.shape[0]
        Bp = _bucket_batch(B)
        if Bp != B:
            idx = np.concatenate(
                [idx, np.repeat(idx[:1], Bp - B, axis=0)])
        return np.asarray(jitted(idx))[:B]

    return batch_f


def _bucket_batch(B: int, floor: Optional[int] = None) -> int:
    """Next power-of-two batch bucket (bounds compile count).

    On accelerator backends the floor is 1024: an XLA compile costs
    seconds per distinct shape while evaluating 1024 padded points costs
    about the same dispatch as 32, so one fixed shape for all small
    batches means ONE compile for the whole TCI run. On CPU padding is
    real compute, so the floor stays small."""
    if floor is None:
        try:
            import jax

            floor = 32 if jax.default_backend() == "cpu" else 1024
        except Exception:  # noqa: BLE001
            floor = 32
    b = floor
    while b < B:
        b *= 2
    return b
