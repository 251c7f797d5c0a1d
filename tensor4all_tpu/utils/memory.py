"""Memory pressure relief and device memory introspection.

JAX rebuild of tensor4all-tensorbackend/src/memory.rs:37-90
(malloc_trim / malloc_zone_pressure_relief hooks): on the JAX runtime the
equivalents are clearing compilation/dispatch caches, dropping live-array
references, and querying the device allocator.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import jax


def memory_pressure_relief() -> None:
    """Best-effort release of framework caches (ref relieve hooks)."""
    jax.clear_caches()


def live_array_bytes() -> int:
    """Total bytes of live device arrays (this process)."""
    return sum(
        int(a.size * a.dtype.itemsize) for a in jax.live_arrays()
    )


def device_memory_stats(device: Optional[jax.Device] = None) -> Dict:
    """Allocator stats where the backend exposes them (GPU does; CPU may
    return an empty dict)."""
    dev = device or jax.devices()[0]
    stats = getattr(dev, "memory_stats", None)
    if stats is None:
        return {}
    try:
        return dict(dev.memory_stats() or {})
    except Exception:
        return {}
