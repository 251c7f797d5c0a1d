"""Checkpoint / resume for long-running TCI optimizations.

JAX extension of the reference's persistence story (SURVEY.md
§5.4): the reference's de-facto resume path is rebuilding TCI2 state from
a TT (conversion.rs); here we ALSO checkpoint the live pivot state
(orbax-style: a directory with a JSON manifest + npz payloads) so long
interpolations on preemptible machines can resume exactly.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from ..tci.cached_function import CachedFunction
from ..tci.indexset import IndexSet
from ..tci.tensorci2 import TensorCI2
from ..tt.tensortrain import TensorTrain


def save_tci2(path: str, tci: TensorCI2) -> None:
    """Write pivot sets + metadata; the function itself is not stored
    (the caller re-supplies it on restore, as with any black box)."""
    os.makedirs(path, exist_ok=True)
    manifest = {
        "format": "t4a-tci2-checkpoint",
        "version": 2,
        "local_dims": list(tci.local_dims),
        "f_max": tci.f_max,
        "pivot_errors": list(map(float, tci.pivot_errors)),
        "Iset": [[list(p) for p in s] for s in tci.Iset],
        "Jset": [[list(p) for p in s] for s in tci.Jset],
        "has_site_tensors": all(t is not None for t in tci.site_tensors),
    }
    if manifest["has_site_tensors"]:
        np.savez(os.path.join(path, "site_tensors.npz"), **{
            f"t_{k}": np.asarray(t) for k, t in enumerate(tci.site_tensors)
        })
    tmp = os.path.join(path, "manifest.json.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, os.path.join(path, "manifest.json"))


def load_tci2(path: str, f=None, batch_f=None, dtype=np.float64) -> TensorCI2:
    """Restore a TCI2 from `save_tci2`, reattaching the function."""
    with open(os.path.join(path, "manifest.json")) as fh:
        m = json.load(fh)
    if m.get("format") != "t4a-tci2-checkpoint":
        raise ValueError("not a TCI2 checkpoint")
    func = CachedFunction(f=f, batch_f=batch_f, local_dims=m["local_dims"],
                          dtype=dtype)
    tci = TensorCI2.__new__(TensorCI2)
    tci.func = func
    tci.local_dims = list(m["local_dims"])
    tci.L = len(tci.local_dims)
    tci.f_max = float(m["f_max"])
    tci.pivot_errors = np.asarray(m["pivot_errors"], dtype=np.float64)
    tci.Iset = [IndexSet([tuple(p) for p in s]) for s in m["Iset"]]
    tci.Jset = [IndexSet([tuple(p) for p in s]) for s in m["Jset"]]
    tci.site_tensors = [None] * tci.L
    tci._prev_Iset = None
    tci._prev_Jset = None
    st_path = os.path.join(path, "site_tensors.npz")
    if m.get("has_site_tensors") and os.path.exists(st_path):
        with np.load(st_path) as z:
            tci.site_tensors = [z[f"t_{k}"] for k in range(tci.L)]
    return tci


def save_tensortrain(path: str, tt: TensorTrain) -> None:
    """npz checkpoint of TT cores (orbax-style single-file payload)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{
        f"core_{k}": np.asarray(c) for k, c in enumerate(tt.cores)
    })


def load_tensortrain(path: str) -> TensorTrain:
    with np.load(path) as z:
        cores = [z[f"core_{k}"] for k in range(len(z.files))]
    return TensorTrain(cores)
