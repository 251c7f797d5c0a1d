"""ACI: elementwise operations on tensor trains by cross interpolation.

JAX rebuild of tensor4all-aci
(crates/tensor4all-aci/src/elementwise.rs:76 `elementwise_batched`,
options.rs `AciOptions`, batch.rs `ElementwiseBatch`, state.rs
`ElementwiseProblem`, local.rs `LocalBlockEvaluator`, random_tt.rs
initial guess): given input TTs A_1..A_k and an elementwise map ``g``,
produce a TT of ``g(A_1(x), ..., A_k(x))``.

The default engine is the reference's TRUE alternating-CI algorithm:
per-input left/right FRAMES (the input cores contracted against the
solution's pivot selections) are maintained along the sweep, each
two-site local block is materialized by one (nrows x D_i) @ (D_i x
ncols) matmul per input followed by a single vectorized operator
application, and the block is CI-factorized (rrLU) into the new solution
cores. Operator evaluations therefore number (r_sol*d)^2 per bond and
frame updates cost matmuls scaling with the INPUT ranks — no full-chain
TT evaluation ever happens, unlike the TCI2-of-the-composed-function
reduction (kept as ``engine="tci2"``), whose every sample pays a full
k-chain contraction over the output's pivot volume.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..ops.rrlu import luci_factors_from_matrix
from ..tci.tensorci2 import TCI2Options, crossinterpolate2
from .tensortrain import TensorTrain


@dataclasses.dataclass
class AciOptions:
    """Ref: AciOptions (aci/src/options.rs; defaults are conservative,
    tests.rs `default_options_are_conservative`). `min_iters` is the
    Julia-parity convergence window: the last error must be under `tol`
    and ranks must be stable over the last `min_iters` iterations
    (elementwise.rs `convergence_criterion_like_julia`).

    ``scale_tolerance`` switches `tol` from absolute to relative against
    each bond's largest sampled operator output (options.rs:64-73).
    ``engine`` selects the alternating-CI algorithm (reference parity,
    default) or the TCI2-of-the-composed-function reduction."""

    tol: float = 1e-10
    maxbonddim: Optional[int] = None
    max_iter: int = 16
    min_iters: Optional[int] = None  # default: min(2, max_iter)
    scale_tolerance: bool = False
    initial_guess: Optional[TensorTrain] = None
    engine: str = "alternating"  # "alternating" | "tci2"
    n_global_pivots: int = 2  # tci2 engine only
    global_search_starts: int = 32  # tci2 engine only
    seed: int = 0

    def __post_init__(self):
        if self.max_iter < 1:
            raise ValueError("max_iter must be >= 1")
        if self.min_iters is None:
            self.min_iters = min(2, self.max_iter)
        if self.min_iters < 1 or self.min_iters > self.max_iter:
            raise ValueError("need 1 <= min_iters <= max_iter")
        if self.maxbonddim is not None and self.maxbonddim < 1:
            raise ValueError("maxbonddim must be >= 1")
        if not np.isfinite(self.tol) or self.tol < 0:
            raise ValueError("tol must be finite and >= 0")
        if self.engine not in ("alternating", "tci2"):
            raise ValueError(f"unknown ACI engine {self.engine!r}")

    def to_tci2(self) -> TCI2Options:
        return TCI2Options(
            tol=self.tol,
            maxbonddim=self.maxbonddim,
            max_iter=self.max_iter,
            ncheck_history=self.min_iters,
            n_global_pivots=self.n_global_pivots,
            global_search_starts=self.global_search_starts,
            seed=self.seed,
        )


@dataclasses.dataclass
class AciResult:
    """Driver result (ref elementwise.rs `AciResult`): the interpolant
    plus per-iteration rank/error histories and the operator-evaluation
    count (the user-side cost of the run)."""

    tt: TensorTrain
    ranks: List[int]
    errors: List[float]
    n_operator_evals: int
    n_full_chain_evals: int = 0  # input-TT full evaluations (0 for the
    #                              alternating engine — frames only)

    # the result quacks like its TT for the common consumption patterns
    def evaluate(self, idx):
        return self.tt.evaluate(idx)

    def evaluate_batch(self, idx):
        return self.tt.evaluate_batch(idx)

    def __len__(self):
        return len(self.tt)


class ElementwiseBatch:
    """Column-major (input-fastest) batch view (ref batch.rs
    `ElementwiseBatch`): `values[input + n_inputs * point]`. Used at the
    C boundary, where the reference hands operators flat col-major
    buffers; Python operators receive per-input rows via `input_rows`."""

    def __init__(self, values: np.ndarray, n_inputs: int, n_points: int):
        values = np.asarray(values).ravel()
        if n_inputs <= 0 or n_points <= 0:
            raise ValueError("n_inputs and n_points must be nonzero")
        if values.size != n_inputs * n_points:
            raise ValueError(
                f"need {n_inputs * n_points} values, got {values.size}")
        self._values = values
        self._n_inputs = int(n_inputs)
        self._n_points = int(n_points)

    @property
    def n_inputs(self) -> int:
        return self._n_inputs

    @property
    def n_points(self) -> int:
        return self._n_points

    def get(self, input: int, point: int):
        if not 0 <= input < self._n_inputs:
            raise IndexError("input out of range")
        if not 0 <= point < self._n_points:
            raise IndexError("point out of range")
        return self._values[input + self._n_inputs * point]

    def input_rows(self) -> List[np.ndarray]:
        """One (n_points,) array per input."""
        m = self._values.reshape(self._n_points, self._n_inputs)
        return [m[:, k] for k in range(self._n_inputs)]

    def as_col_major_array(self) -> np.ndarray:
        return self._values


def _validate_inputs(tts: Sequence[TensorTrain]) -> List[int]:
    """Ref validation.rs `validate_inputs`."""
    if not tts:
        raise ValueError("need at least one input TT")
    dims = tts[0].local_dims
    if len(dims) == 0:
        raise ValueError("input TTs must have at least one site")
    for t in tts[1:]:
        if t.local_dims != dims:
            raise ValueError("input TTs must share local dims")
    return dims


def _default_link_dims(inputs: Sequence[TensorTrain], dims: Sequence[int],
                       maxbonddim: Optional[int]) -> List[int]:
    """Initial-guess link dims (ref random_tt.rs `default_link_dims`):
    min over the inputs' link dims, capped by the left/right site-space
    products and max_bond_dim, floored at 1."""
    n = len(dims)
    cap = maxbonddim if maxbonddim is not None else 1 << 60
    lp = 1
    left_products = []
    for d in dims[:-1]:
        lp = min(lp * d, 1 << 60)
        left_products.append(lp)
    rp = 1
    right_products = [1] * (n - 1)
    for b in range(n - 2, -1, -1):
        rp = min(rp * dims[b + 1], 1 << 60)
        right_products[b] = rp
    out = []
    for b in range(n - 1):
        m = min(t.ranks[b] for t in inputs)
        out.append(max(1, min(left_products[b], right_products[b], m, cap)))
    return out


class ElementwiseProblem:
    """Alternating-CI sweep state (ref state.rs `ElementwiseProblem`):
    input cores, solution cores, and per-input left/right frames.

    ``left_frames[i][s]``: (sol_left_rank(s), input_left_dim(s)) — the
    input's cores 0..s-1 contracted at the solution's left pivot rows.
    ``right_frames[i][s]``: (input_right_dim(s-1), sol_right_rank(s-1))
    mirrored from the right. Frame updates are one matmul + row/column
    selection (state.rs update_left_frame/update_right_frame; the
    reference's batched variants are a single vectorized einsum here).
    """

    def __init__(self, inputs: Sequence[TensorTrain], options: AciOptions,
                 dtype=np.float64):
        self.dims = _validate_inputs(inputs)
        self.k = len(inputs)
        self.n = len(self.dims)
        self.opts = options
        self.input_cores = [[np.asarray(c) for c in t.cores]
                            for t in inputs]
        self.dtype = np.result_type(
            dtype, *[c.dtype for cores in self.input_cores for c in cores])
        # initial guess (ref random_tt.rs initial_guess)
        if options.initial_guess is not None:
            guess = options.initial_guess
            if list(guess.local_dims) != list(self.dims):
                raise ValueError("initial guess site dims must match inputs")
            self.sol = [np.asarray(c, dtype=self.dtype) for c in guess.cores]
        else:
            link = _default_link_dims(inputs, self.dims, options.maxbonddim)
            rng = np.random.default_rng(options.seed)
            self.sol = []
            for s, d in enumerate(self.dims):
                dl = 1 if s == 0 else link[s - 1]
                dr = 1 if s == self.n - 1 else link[s]
                core = rng.standard_normal((dl, d, dr))
                if np.issubdtype(self.dtype, np.complexfloating):
                    core = core + 1j * rng.standard_normal((dl, d, dr))
                self.sol.append(core.astype(self.dtype))
        one = np.ones((1, 1), dtype=self.dtype)
        self.left_frames = [[None] * (self.n + 1) for _ in range(self.k)]
        self.right_frames = [[None] * (self.n + 1) for _ in range(self.k)]
        for i in range(self.k):
            self.left_frames[i][0] = one
            self.right_frames[i][self.n] = one
        self.pivot_errors = np.zeros(max(self.n - 1, 0))
        self.pivot_scales = np.zeros(max(self.n - 1, 0))
        self.n_op_evals = 0
        self._initialize_right_frames()

    # -- frames ---------------------------------------------------------
    def _full_left_frame(self, i: int, s: int) -> np.ndarray:
        """(sol_left_rank(s) * d_s, input_right_dim(s)): candidate rows
        for the next left frame (row index = p * d + site)."""
        frame = self.left_frames[i][s]
        core = self.input_cores[i][s]
        full = np.einsum("pl,lsr->psr", frame, core, optimize=True)
        return full.reshape(-1, core.shape[2])

    def _full_right_frame(self, i: int, s: int) -> np.ndarray:
        """(input_left_dim(s), d_s * sol_right_rank(s)): candidate
        columns for the next right frame (col index = site * q + pivot)."""
        core = self.input_cores[i][s]
        frame = self.right_frames[i][s + 1]
        full = np.einsum("lsr,rq->lsq", core, frame, optimize=True)
        return full.reshape(core.shape[0], -1)

    def update_left_frames(self, s: int, rows: Sequence[int]) -> None:
        for i in range(self.k):
            self.left_frames[i][s + 1] = self._full_left_frame(i, s)[rows, :]

    def update_right_frames(self, s: int, cols: Sequence[int]) -> None:
        for i in range(self.k):
            self.right_frames[i][s] = self._full_right_frame(i, s)[:, cols]

    # -- local blocks ---------------------------------------------------
    def local_input_blocks(self, b: int) -> List[np.ndarray]:
        """Per-input local (nrows x ncols) value blocks at bond b (ref
        local.rs LocalInputFactors.materialize_values): one matmul per
        input, cost O(nrows * D_i * ncols) — structured by input rank."""
        out = []
        for i in range(self.k):
            L = self._full_left_frame(i, b)            # (nrows, D_i)
            R = self._full_right_frame(i, b + 1)       # (D_i, ncols)
            out.append(L @ R)
        return out

    def local_update(self, b: int, forward: bool,
                     op: Callable[..., np.ndarray]) -> None:
        """Two-site alternating update at bond b (ref state.rs:496
        `local_update`): materialize the operator's local block from the
        input blocks, CI-factorize, install the new solution cores, and
        refresh the sweep-direction frames at the chosen pivots."""
        opts = self.opts
        blocks = self.local_input_blocks(b)
        nrows, ncols = blocks[0].shape
        vals = np.asarray(op(*[blk.ravel() for blk in blocks]))
        self.n_op_evals += nrows * ncols
        if vals.shape != (nrows * ncols,):
            raise ValueError("op must map (B,)-arrays to a (B,) array")
        local = vals.reshape(nrows, ncols)
        scale = float(np.max(np.abs(vals))) if vals.size else 0.0

        fac = luci_factors_from_matrix(
            np.ascontiguousarray(local),
            rel_tol=opts.tol if opts.scale_tolerance else 0.0,
            abs_tol=0.0 if opts.scale_tolerance else opts.tol,
            max_rank=opts.maxbonddim,
            left_orthogonal=forward,
        )
        err = float(fac.pivot_errors[-1]) if len(fac.pivot_errors) else 0.0
        if fac.rank == 0:
            # zero block: keep a rank-1 zero bond (ref state.rs:589)
            r = 1
            left = np.zeros((nrows, 1), dtype=local.dtype)
            right = np.zeros((1, ncols), dtype=local.dtype)
            rows, cols = [0], [0]
        else:
            r = fac.rank
            left = np.asarray(fac.left)
            right = np.asarray(fac.right)
            rows = [int(x) for x in fac.row_indices]
            cols = [int(x) for x in fac.col_indices]
        d_l, d_r = self.dims[b], self.dims[b + 1]
        self.sol[b] = left.reshape(nrows // d_l, d_l, r)
        self.sol[b + 1] = right.reshape(r, d_r, ncols // d_r)
        if forward:
            self.update_left_frames(b, rows)
        else:
            self.update_right_frames(b + 1, cols)
        self.pivot_errors[b] = err
        self.pivot_scales[b] = scale

    def _initialize_right_frames(self) -> None:
        """Right-to-left exact CI pass over the initial guess (ref
        state.rs:640 `initialize_right_frames`): each core is replaced by
        its interpolating right factor, the left factor is absorbed into
        the previous core, and the chosen column pivots seed the right
        frames."""
        for s in range(self.n - 1, 0, -1):
            core = self.sol[s]
            dl, d, dr = core.shape
            mat = core.reshape(dl, d * dr)
            fac = luci_factors_from_matrix(np.ascontiguousarray(mat),
                                           rel_tol=0.0, abs_tol=0.0,
                                           left_orthogonal=False)
            if fac.rank == 0:
                r = 1
                left = np.zeros((dl, 1), dtype=self.dtype)
                right = np.zeros((1, d * dr), dtype=self.dtype)
                cols = [0]
            else:
                r = fac.rank
                left = np.asarray(fac.left)
                right = np.asarray(fac.right)
                cols = [int(x) for x in fac.col_indices]
            self.sol[s] = right.reshape(r, d, dr)
            prev = self.sol[s - 1]
            pl, pd, _ = prev.shape
            self.sol[s - 1] = (prev.reshape(pl * pd, dl) @ left).reshape(
                pl, pd, r)
            self.update_right_frames(s, cols)

    def max_error_metric(self) -> float:
        """Ref elementwise.rs `max_error_metric`."""
        if self.opts.scale_tolerance:
            scales = np.where(self.pivot_scales > 0, self.pivot_scales, 1.0)
            return float(np.max(self.pivot_errors / scales, initial=0.0))
        return float(np.max(self.pivot_errors, initial=0.0))

    def solution_tt(self) -> TensorTrain:
        return TensorTrain([np.array(c) for c in self.sol])


def _converged(ranks: List[int], errors: List[float], min_iters: int,
               tol: float) -> bool:
    """Ref elementwise.rs `convergence_criterion_like_julia`."""
    it = len(ranks)
    if it < min_iters or min_iters == 0:
        return False
    if errors[-1] > tol:
        return False
    baseline = ranks[it - min_iters]
    return not any(r > baseline for r in ranks[it - min_iters:])


def elementwise(
    op,
    tts,
    options=None,
    initial_pivots=None,
    dtype=np.float64,
) -> "AciResult":
    """Scalar-callback variant of `elementwise_batched`
    (ref elementwise.rs:213 `elementwise`): `op` receives k scalars and
    returns one scalar; vectorized internally."""
    def batched(*cols):
        return np.array([op(*vals) for vals in zip(*cols)])

    return elementwise_batched(batched, tts, options=options,
                               initial_pivots=initial_pivots, dtype=dtype)


def elementwise_batched(
    op: Callable[..., np.ndarray],
    tts: Sequence[TensorTrain],
    options: Optional[AciOptions] = None,
    initial_pivots: Optional[Sequence[Sequence[int]]] = None,
    dtype=np.float64,
) -> AciResult:
    """TT of ``op(A_1(x), ..., A_k(x))`` (ref elementwise.rs:76).

    `op` receives k arrays of shape (B,) and returns (B,). Returns an
    `AciResult` with rank/error histories (the result delegates
    `evaluate`/`evaluate_batch` to its `.tt`).
    """
    dims = _validate_inputs(tts)
    options = options or AciOptions()

    if len(dims) == 1:
        # one-site input: evaluate op on the full (tiny) grid directly
        # (ref elementwise.rs:135 `elementwise_batched_one_site`)
        vals_in = [np.asarray(t.evaluate_batch(
            np.arange(dims[0], dtype=np.int64)[:, None])) for t in tts]
        vals = np.asarray(op(*vals_in)).astype(dtype)
        tt = TensorTrain([np.asarray(vals)[None, :, None]])
        return AciResult(tt, ranks=[1], errors=[0.0],
                         n_operator_evals=dims[0],
                         n_full_chain_evals=dims[0] * len(tts))

    if options.engine == "tci2":
        return _elementwise_tci2(op, tts, dims, options, initial_pivots,
                                 dtype)

    problem = ElementwiseProblem(tts, options, dtype)
    ranks: List[int] = []
    errors: List[float] = []
    for it in range(options.max_iter):
        forward = it % 2 == 0
        bonds = range(problem.n - 1) if forward \
            else range(problem.n - 2, -1, -1)
        for b in bonds:
            problem.local_update(b, forward, op)
        ranks.append(max(c.shape[2] for c in problem.sol[:-1]) if
                     problem.n > 1 else 1)
        errors.append(problem.max_error_metric())
        if _converged(ranks, errors, options.min_iters, options.tol):
            break
    return AciResult(problem.solution_tt(), ranks=ranks, errors=errors,
                     n_operator_evals=problem.n_op_evals,
                     n_full_chain_evals=0)


def _elementwise_tci2(op, tts, dims, options, initial_pivots,
                      dtype) -> AciResult:
    """Fallback reduction: TCI2 of the composed function with
    TTCache-backed input evaluation (the pre-parity round-1 engine;
    useful when the operator needs global pivot search)."""
    from .cache import TTCache

    caches = [TTCache(t) for t in tts]
    n_op_evals = [0]
    n_chain = [0]

    def batch_f(idx: np.ndarray) -> np.ndarray:
        vals = [c.evaluate_batch(idx) for c in caches]
        out = np.asarray(op(*vals))
        n_op_evals[0] += int(idx.shape[0])
        n_chain[0] += int(idx.shape[0]) * len(caches)
        if out.shape != (idx.shape[0],):
            raise ValueError("op must map (B,)-arrays to a (B,) array")
        return out

    tci, ranks, errors = crossinterpolate2(
        batch_f=batch_f, local_dims=dims,
        initial_pivots=initial_pivots, options=options.to_tci2(),
        dtype=dtype,
    )
    return AciResult(tci.to_tensortrain(), ranks=list(ranks),
                     errors=[float(e) for e in errors],
                     n_operator_evals=n_op_evals[0],
                     n_full_chain_evals=n_chain[0])


def hadamard_aci(a: TensorTrain, b: TensorTrain,
                 options: Optional[AciOptions] = None) -> TensorTrain:
    """Elementwise product via ACI (rank-adaptive alternative to the exact
    kron-product ``TensorTrain.hadamard`` whose ranks multiply)."""
    return elementwise_batched(lambda x, y: x * y, [a, b], options).tt


def invert_tt(a: TensorTrain, options: Optional[AciOptions] = None,
              eps: float = 0.0) -> TensorTrain:
    """Elementwise reciprocal ``1/(A(x) + eps)`` via ACI (ref
    interpolativeqtt `invert_qtt` role)."""
    return elementwise_batched(lambda x: 1.0 / (x + eps), [a], options).tt
