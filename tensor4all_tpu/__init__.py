"""tensor4all_tpu — a JAX tensor-network framework.

A ground-up JAX/XLA re-design of the capabilities of
``tensor4all/tensor4all-rs`` (tensor trains, tensor cross interpolation,
quantics tensor trains, tree tensor networks, DMRG/TDVP/linsolve), built
for an accelerator:

- contraction lowers to ``jax.numpy.einsum`` / ``lax.dot_general``,
- decompositions (SVD/QR/rrLU) run as jitted XLA programs with static-shape
  masking so data-dependent ranks never force recompilation inside sweeps,
- batched function evaluation (the TCI hot loop) is shardable over a
  ``jax.sharding.Mesh`` via ``parallel``,
- host Python keeps only the control plane (index identity, pivot sets,
  tree topology, sweep schedules) — exactly the state the reference keeps
  in Rust ``Vec``/``HashMap``.

The reference implementation studied for feature/behavior parity lives at
tensor4all-rs (Rust); file:line citations in docstrings point there.
"""

from __future__ import annotations

import os

import jax

# The reference is float64/complex128 end-to-end with 1e-10..1e-14 accuracy
# contracts (SURVEY.md §6); x64 is required for parity. Opt out with
# T4A_NO_X64=1 for pure-speed experiments.
if not os.environ.get("T4A_NO_X64"):
    jax.config.update("jax_enable_x64", True)

from .config import (  # noqa: E402
    SingularValueMeasure,
    SvdTruncationPolicy,
    ThresholdScale,
    get_default_qr_rtol,
    get_default_svd_truncation_policy,
    set_default_qr_rtol,
    set_default_svd_truncation_policy,
)
from .core.index import Index, TagSet, new_id, sim  # noqa: E402
from .core.tensor import Tensor  # noqa: E402
from .core.contract import contract  # noqa: E402
from .core.decomp import (  # noqa: E402
    FactorizeAlg,
    Canonical,
    factorize,
    qr,
    svd,
    truncated_svd_matrix,
)

__all__ = [
    "Index",
    "TagSet",
    "Tensor",
    "contract",
    "svd",
    "qr",
    "factorize",
    "FactorizeAlg",
    "Canonical",
    "truncated_svd_matrix",
    "new_id",
    "sim",
    "SvdTruncationPolicy",
    "ThresholdScale",
    "SingularValueMeasure",
    "get_default_svd_truncation_policy",
    "set_default_svd_truncation_policy",
    "get_default_qr_rtol",
    "set_default_qr_rtol",
]

__version__ = "0.1.0"
