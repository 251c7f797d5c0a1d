"""Profiling / tracing / observability.

JAX rebuild of the reference's env-gated, zero-cost-when-off
counters (SURVEY.md §5.1: tenferro_bridge.rs:108-420 per-signature einsum
profiles, contract.rs:79 T4A_PROFILE_CONTRACT, krylov.rs:49-70 GMRES op
profiles; §5.5 counters): JAX's own profiler (jax.profiler.trace) subsumes
the kernel-level timing; this module keeps the reference's per-signature
aggregation idea as a thin host-side wrapper plus the counter registry
(cache hit ratios, eval counts, residual histories live on their owning
objects — CachedFunction, TTCache, GmresResult — as in the reference).

Env vars (ref T4A_* inventory):
  T4A_PROFILE_CONTRACT=1  — time every core.contract call by signature.
  T4A_TRACE_DIR=<path>    — wrap `profiled()` blocks in jax.profiler.trace.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

from ..config import env_flag

_lock = threading.Lock()
_timings: Dict[str, list] = defaultdict(lambda: [0, 0.0])  # name -> [n, total]


def record(name: str, seconds: float) -> None:
    with _lock:
        t = _timings[name]
        t[0] += 1
        t[1] += seconds


@contextlib.contextmanager
def timed(name: str) -> Iterator[None]:
    """Aggregate wall time under `name` (per-signature style)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record(name, time.perf_counter() - t0)


def profile_report(reset: bool = False) -> str:
    """Ref: print_and_reset_native_einsum_profile (tensorbackend lib.rs:59)."""
    with _lock:
        lines = [
            f"{name:50s} n={n:8d} total={total * 1e3:10.2f} ms "
            f"mean={total / n * 1e6:8.1f} us"
            for name, (n, total) in sorted(
                _timings.items(), key=lambda kv: -kv[1][1]
            )
        ]
        if reset:
            _timings.clear()
    return "\n".join(lines) if lines else "(no profile data)"


def print_and_reset_profile() -> None:
    print(profile_report(reset=True))


@contextlib.contextmanager
def profiled(label: str = "t4a") -> Iterator[None]:
    """Optionally wrap a block in the JAX/XLA profiler
    (T4A_TRACE_DIR -> TensorBoard trace)."""
    trace_dir = os.environ.get("T4A_TRACE_DIR")
    if trace_dir:
        import jax

        with jax.profiler.trace(os.path.join(trace_dir, label)):
            yield
    else:
        yield


def contract_profiling_enabled() -> bool:
    return env_flag("T4A_PROFILE_CONTRACT")
