"""A GLM solver on the tabmat_torch kernels.

Port of ``tabmat_tpu/glm.py``: iteratively reweighted least squares with a
conjugate-gradient inner solve, and FISTA for the elastic net.  The
reference jit-compiles each step; the port runs eagerly, so its fixed-count
loops (``lax.fori_loop``) are Python loops over device tensors with no
host synchronisation inside a step.  On a CUDA card the CG loop is captured
once as a CUDA graph and replayed: on an explicit Hessian, and on a
design's Hessian-vector product.

Functional core:
  - ``irls_step(X, y, weights, beta, family=...)`` — one Newton step
  - ``fista_epoch(...)`` — ``n_steps`` proximal-gradient steps
  - ``fit_glm(...)`` — host loop with convergence check

On a :class:`~tabmat_torch.parallel.design.DeviceDesign` the Newton step
builds one explicit Hessian through the sandwich kernel, in float32 by
default (``inner_precision='float32'``) or float64.

The three run unchanged on a row-sharded design
(``DeviceDesign.shard``), as the reference's shard over a row mesh: y, the
weights and the offset are the rank's rows, beta is whole on every rank.
The design's transpose-matvec, sandwich and float32 scale bound are
all-reduced over the ranks, so the CG solve, the step and the convergence
test are the same on every rank.
"""

import threading
from collections import OrderedDict
from typing import Callable

import numpy as np
import torch

from . import _trace
from ._config import DEFAULT_DTYPE
from .utils.arrays import to_tensor

FAMILIES = (
    "gaussian",
    "poisson",
    "logistic",
    "gamma",
    "inverse_gaussian",
    "tweedie",
)

# glum-compatible spellings (glum: Normal/Binomial/InverseGaussian etc.)
_FAMILY_ALIASES = {
    "normal": "gaussian",
    "binomial": "logistic",
    "bernoulli": "logistic",
    "inverse.gaussian": "inverse_gaussian",
}


def _parse_family(family: str):
    """'tweedie(p)' → ('tweedie', p); other names pass through."""
    family = _FAMILY_ALIASES.get(family, family)
    if family.startswith("tweedie"):
        if "(" in family:
            power = float(family[family.index("(") + 1 : family.rindex(")")])
        else:
            power = 1.5
        if not 1.0 < power < 2.0:
            raise ValueError(
                f"tweedie power must be in (1, 2), got {power}"
            )
        return "tweedie", power
    return family, None


def _family_terms(family: str, eta: torch.Tensor, y: torch.Tensor):
    """Return (mu, irls_weight, working_residual) for the canonical link.

    For canonical links the IRLS weight is Var(mu) = dmu/deta and the
    Newton step solves  (Xᵀ W X) δ = Xᵀ (y - mu).
    """
    family = _FAMILY_ALIASES.get(family, family)
    if family == "gaussian":
        mu = eta
        w = torch.ones_like(eta)
    elif family == "poisson":
        mu = torch.exp(eta)
        w = mu
    elif family == "logistic":
        mu = torch.sigmoid(eta)
        w = mu * (1 - mu)
    elif family == "gamma":
        # log link: w = mu²/V(mu) = 1 and the score is Xᵀ((y - mu)/mu)
        mu = torch.exp(eta)
        w = torch.ones_like(eta)
        return mu, w, (y - mu) / mu
    elif family == "inverse_gaussian":
        # V(mu) = mu³ under the log link: Fisher weight mu^{-1},
        # score Xᵀ((y - mu)/mu²)
        mu = torch.exp(eta)
        w = 1.0 / mu
        return mu, w, (y - mu) / (mu * mu)
    elif family.startswith("tweedie"):
        # V(mu) = mu^p under the log link: Fisher weight mu^{2-p},
        # score Xᵀ((y - mu)·mu^{1-p})
        _, power = _parse_family(family)
        mu = torch.exp(eta)
        w = mu ** (2.0 - power)
        return mu, w, (y - mu) * mu ** (1.0 - power)
    else:
        raise ValueError(f"Unknown family {family!r}; options: {FAMILIES}")
    return mu, w, y - mu


def _make_mv_tmv(X):
    """Matvec/transpose-matvec closures for a tensor or DeviceDesign."""
    return (lambda v: X @ v), (lambda r: X.T @ r)


def _cg_solve(matvec: Callable, b: torch.Tensor, n_iter: int) -> torch.Tensor:
    """Fixed-iteration conjugate gradient.

    Convergence-safe: once the residual has collapsed (or ``pᵀAp`` flushes
    to zero on FTZ hardware), the step sizes are forced to 0 instead of
    dividing by a flushed denominator — running past convergence would
    otherwise overflow into inf−inf = NaN.
    """
    tiny = torch.finfo(b.dtype).tiny
    x = torch.zeros_like(b)
    r = b
    p = b
    rs = torch.dot(b, b)
    for _ in range(n_iter):
        Ap = matvec(p)
        denom = torch.dot(p, Ap)
        live = denom > tiny
        alpha = torch.where(live, rs / torch.where(live, denom, 1.0), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = torch.dot(r, r)
        beta = torch.where(rs > tiny, rs_new / torch.where(rs > tiny, rs, 1.0), 0.0)
        p = r + beta * p
        rs = rs_new
    return x


# the CUDA graphs of _cg_solve_dense by (device, dtype, k, n_iter), the most
# recently used last; past _CG_GRAPHS_KEPT the oldest is dropped.  The lock
# makes a call's copies in, replay and copy out one sequence on its stream
_CG_GRAPHS_KEPT = 4
_cg_graphs = OrderedDict()
_cg_lock = threading.Lock()
# one side stream a device for every capture, made at the first: cuBLAS keeps
# a workspace (32 MiB on the H100) for each stream it has run on, for the
# process's life
_capture_streams = {}


def _capture_stream() -> torch.cuda.Stream:
    """The current device's capture stream; callers hold ``_cg_lock``."""
    device = torch.cuda.current_device()
    if device not in _capture_streams:
        _capture_streams[device] = torch.cuda.Stream()
    return _capture_streams[device]


def _cg_solve_dense(H: torch.Tensor, b: torch.Tensor, n_iter: int) -> torch.Tensor:
    """``_cg_solve(lambda v: H @ v, b, n_iter)`` on an explicit (k, k) ``H``.

    On a CUDA tensor the loop's launches (a GEMV, two dots and about fifteen
    small elementwise kernels an iteration) are one CUDA graph, captured at
    the first call of its (device, dtype, k, n_iter) and replayed after:
    ``H`` and ``b`` are copied into the graph's own tensors, the graph runs
    the same kernels in the same order on them, and a copy of its result is
    returned, so the result is bit for bit the eager loop's on a contiguous
    ``H`` (every Hessian of the port is one).  On the CPU, or while the
    current stream is being captured into a caller's graph, the loop runs
    eagerly.
    """
    if H.device.type != "cuda":
        return _cg_solve(lambda v: H @ v, b, n_iter)
    with torch.cuda.device(H.device):
        if torch.cuda.is_current_stream_capturing():
            return _cg_solve(lambda v: H @ v, b, n_iter)
        key = (H.device, H.dtype, b.shape[0], n_iter)
        with _cg_lock:
            entry = _cg_graphs.get(key)
            if entry is None:
                entry = _cg_graphs[key] = _cg_capture(H, b, n_iter)
                while len(_cg_graphs) > _CG_GRAPHS_KEPT:
                    _cg_graphs.popitem(last=False)
            else:
                _cg_graphs.move_to_end(key)
            graph, H_static, b_static, x_static, done = entry
            stream = torch.cuda.current_stream()
            # the last call's copy out, whichever stream it was queued on
            stream.wait_event(done)
            H_static.copy_(H)
            b_static.copy_(b)
            graph.replay()
            x = x_static.clone()
            done.record(stream)
            _trace.count("cg_graph_replays")
        return x


def _cg_capture(H: torch.Tensor, b: torch.Tensor, n_iter: int):
    """(graph, H, b, x, event) of ``_cg_solve_dense``: the loop on contiguous
    copies of ``H`` and ``b``, run once on the capture stream (which sets up
    its cuBLAS workspace outside the capture), then captured; the event marks
    the end of a call's copy out."""
    H_static = H.clone(memory_format=torch.contiguous_format)
    b_static = b.clone(memory_format=torch.contiguous_format)
    stream = _capture_stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        _cg_solve(lambda v: H_static @ v, b_static, n_iter)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
        x_static = _cg_solve(lambda v: H_static @ v, b_static, n_iter)
    _trace.count("cg_graph_captures")
    return graph, H_static, b_static, x_static, torch.cuda.Event()


def _hessian_product(X, w: torch.Tensor, ps: torch.Tensor, l2: float) -> Callable:
    """``v ↦ Xᵀ (w ∘ (X v)) + l2 · ps ∘ v``, for a tensor or a design ``X``."""
    return lambda v: X.T @ (w * (X @ v)) + l2 * ps * v


def _hvp_graphs(X, Xs):
    """The CUDA graphs of the Hessian-vector solve on ``Xs``, held by that
    design, or None where the solve runs eagerly: a tensor, a design off
    the card, a ``ShardedDesign`` (its transpose-matvec all-reduces), and a
    float32 cast ``X`` did not keep (the cache ledger refused it), which
    dies with the step.  ``Xs`` is ``X`` or ``X.astype_float(float32)``."""
    from .parallel.design import DeviceDesign, ShardedDesign

    if (not isinstance(Xs, DeviceDesign) or isinstance(Xs, ShardedDesign)
            or Xs.device.type != "cuda" or (Xs is not X and X._f32 is not Xs)):
        return None
    return Xs._hvp_graphs


def _cg_solve_hvp(X, Xs, w: torch.Tensor, ps: torch.Tensor, b: torch.Tensor, l2: float,
                  n_iter: int) -> torch.Tensor:
    """``_cg_solve`` on ``_hessian_product(Xs, w, ps, l2)``, counting a product
    in ``hvp``.

    On the card (:func:`_hvp_graphs`) the loop is one CUDA graph, captured at
    the first call of its (dtype, k, n_iter, l2) and held by ``Xs``, whose
    tensors it reads by address, so it goes with the design: ``w``, ``ps``
    and ``b`` are copied into the graph's own tensors, the graph runs the
    eager loop's kernels in the same order, and a copy of its result is
    returned, bit for bit the eager loop's.  While the current stream is
    being captured into a caller's graph the loop runs eagerly.
    """
    graphs = _hvp_graphs(X, Xs)
    if graphs is None:
        return _cg_solve(_counted(_hessian_product(Xs, w, ps, l2)), b, n_iter)
    with torch.cuda.device(Xs.device):
        if torch.cuda.is_current_stream_capturing():
            return _cg_solve(_counted(_hessian_product(Xs, w, ps, l2)), b, n_iter)
        key = (b.dtype, b.shape[0], n_iter, l2)
        with _cg_lock:
            entry = graphs.get(key)
            if entry is None:
                entry = graphs[key] = _hvp_capture(Xs, w, ps, b, l2, n_iter)
            graph, w_static, ps_static, b_static, x_static, done, launched = entry
            stream = torch.cuda.current_stream()
            # the last call's copy out, whichever stream it was queued on
            stream.wait_event(done)
            w_static.copy_(w)
            ps_static.copy_(ps)
            b_static.copy_(b)
            graph.replay()
            x = x_static.clone()
            done.record(stream)
            for counts, name, n in launched:
                counts[name] += n
            _trace.count("hvp", n_iter)
            _trace.count("hvp_graph_replays")
        return x


def _counted(hvp: Callable) -> Callable:
    def counted(v):
        _trace.count("hvp")
        return hvp(v)

    return counted


def _kernel_launch_counts() -> list:
    """The kernel wrappers' ``launches`` dicts."""
    from .ops import (gather_kernel, sandwich_kernel, segsum_kernel, sparse_gram_kernel,
                      spmv_kernel, std_expand_kernel)

    return [m.launches for m in (gather_kernel, sandwich_kernel, segsum_kernel,
                                 sparse_gram_kernel, spmv_kernel, std_expand_kernel)]


def _hvp_capture(X, w: torch.Tensor, ps: torch.Tensor, b: torch.Tensor, l2: float, n_iter: int):
    """The entry of :func:`_cg_solve_hvp`: (graph, w, ps, b, x, event,
    launches).  One product runs on the capture stream first, which gives
    cuBLAS its workspace there and builds any kernel table the float32
    design's plans still lack; then the loop is captured.  The capture runs
    no kernel, so the wrappers' launch counts it raised are taken back and
    listed as (dict, name, count), which each replay adds."""
    w_static, ps_static, b_static = (t.clone(memory_format=torch.contiguous_format)
                                     for t in (w, ps, b))
    hvp = _hessian_product(X, w_static, ps_static, l2)
    stream = _capture_stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        hvp(b_static)
    counts = _kernel_launch_counts()
    before = [dict(c) for c in counts]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
        x_static = _cg_solve(hvp, b_static, n_iter)
    launched = [(c, name, n - old[name]) for c, old in zip(counts, before)
                for name, n in c.items() if n != old[name]]
    for c, old in zip(counts, before):
        c.update(old)
    _trace.count("hvp_graph_captures")
    return graph, w_static, ps_static, b_static, x_static, torch.cuda.Event(), launched


def _f32_hessian_scale(X32, w: torch.Tensor) -> torch.Tensor:
    """Power of two ``s ≤ 1`` with ``max |x_ij| · |w_i| · s ≤ 1``, on the device.

    The float32 Newton system ``(s H) δ = s g`` has the solution of
    ``H δ = g``.  Scaling by a power of two is exact, so while the unscaled
    terms fit in float32 the step is bit for bit the unscaled one; where the
    weights would overflow float32 (large Poisson or Gamma weights, or
    sample weights) the scaled Hessian still fits.  This is the port's use of
    the reference's exponent prepass (``pallas_sandwich_v4._max_prepass``),
    which keeps the TPU's narrow planes in range in the same way.  The
    design gives a bound of that maximum (the prepass kernel on dense
    columns, ``max |w|`` on one-hot columns); any power of two at or above
    it keeps the scale exact.  A zero, inf or NaN bound leaves ``s = 1``.
    No host sync.
    """
    m = X32.absmax_bound(w)
    e = torch.clamp(torch.ceil(torch.log2(m)), min=0.0)
    return torch.where(torch.isfinite(e), torch.exp2(-e), torch.ones_like(e))


def irls_step(
    X,
    y: torch.Tensor,
    sample_weight: torch.Tensor,
    beta: torch.Tensor,
    family: str = "gaussian",
    n_cg: int = 16,
    l2: float = 0.0,
    inner_precision: str = "float32",
    penalty_scale=None,
    offset=None,
) -> torch.Tensor:
    """One IRLS Newton step with a conjugate-gradient inner solve.

    ``X`` is a tensor or a :class:`DeviceDesign`.  The linear predictor and
    gradient are evaluated in the operand dtype; by default the inner solve
    runs in float32 — an inexact-Newton direction, which IRLS absorbs
    (same fixed point).  Pass ``inner_precision='float64'`` for a fully f64
    step.

    A design with an explicit sandwich builds the Hessian once
    (``Xᵀ diag(w) X``, the CUDA kernel on a GPU) and runs CG on the (k, k)
    matrix, on a GPU as one CUDA graph (``_cg_solve_dense``); otherwise the
    Hessian-vector product is two matvecs, and on a design on the card the
    CG loop over it is one CUDA graph the design holds (``_cg_solve_hvp``).
    On that route the counter ``hvp_steps`` takes one a step, ``hvp`` one a
    product, and ``hvp_route.<reason>`` one a step for each of the design's
    ``sandwich_refusals``.
    """
    with _trace.span("step"):
        _trace.count("steps")
        mv, tmv = _make_mv_tmv(X)
        with _trace.span("step.matvec"):
            eta = mv(beta)
            if offset is not None:
                eta = eta + offset
        with _trace.span("step.family"):
            mu, w_irls, resid = _family_terms(family, eta, y)
            w = sample_weight * w_irls
        with _trace.span("step.tmv"):
            # penalty_scale (e.g. 0 on the intercept) keeps chosen coords unpenalized
            ps = torch.ones_like(beta) if penalty_scale is None else penalty_scale
            grad = tmv(sample_weight * resid) - l2 * ps * beta
        f32_inner = inner_precision == "float32" and X.dtype == torch.float64

        if getattr(X, "supports_sandwich", False):
            # explicit-Hessian path: ONE sandwich per step, then CG on (k, k)
            if f32_inner:
                with _trace.span("step.scale"):
                    X32 = X.astype_float(torch.float32)
                    s = _f32_hessian_scale(X32, w)
                with _trace.span("step.sandwich"):
                    H = X32.sandwich((w * s).to(torch.float32))
                    if l2:
                        H = H + torch.diag((l2 * s * ps).to(torch.float32))
                with _trace.span("step.cg"):
                    delta = _cg_solve_dense(H, (grad * s).to(torch.float32), n_cg)
                    return beta + delta.to(beta.dtype)
            with _trace.span("step.sandwich"):
                H = X.sandwich(w)
                if l2:
                    H = H + l2 * torch.diag(ps)
            with _trace.span("step.cg"):
                delta = _cg_solve_dense(H, grad, n_cg)
                return beta + delta

        _trace.count("hvp_steps")
        if _trace.enabled():
            for reason in getattr(X, "sandwich_refusals", ()):
                _trace.count("hvp_route." + reason)
        if f32_inner:
            with _trace.span("step.scale"):
                if torch.is_tensor(X):
                    X32 = X.to(torch.float32)
                else:
                    X32 = X.astype_float(torch.float32)
                w32 = w.to(torch.float32)
                ps32 = ps.to(torch.float32)
            with _trace.span("step.cg"):
                delta = _cg_solve_hvp(X, X32, w32, ps32, grad.to(torch.float32), l2, n_cg)
                return beta + delta.to(beta.dtype)
        with _trace.span("step.cg"):
            delta = _cg_solve_hvp(X, X, w, ps, grad, l2, n_cg)
            return beta + delta


def fista_epoch(
    X,
    y: torch.Tensor,
    sample_weight: torch.Tensor,
    beta: torch.Tensor,
    step,
    family: str = "gaussian",
    n_steps: int = 50,
    l1: float = 0.0,
    l2: float = 0.0,
    penalty_scale=None,
    offset=None,
) -> torch.Tensor:
    """``n_steps`` of FISTA for the elastic-net GLM objective.

    Proximal gradient with Nesterov momentum: the smooth part is the
    negative log-likelihood (+ l2/2·|β|²), the prox is soft-thresholding at
    ``step·l1``.  ``step`` ≈ 1/L with L the gradient Lipschitz constant
    (estimated by power iteration in :func:`fit_glm`).
    """
    mv, tmv = _make_mv_tmv(X)

    ps = torch.ones_like(beta) if penalty_scale is None else penalty_scale

    def grad(b):
        eta = mv(b)
        if offset is not None:
            eta = eta + offset
        _, _, resid = _family_terms(family, eta, y)
        return -tmv(sample_weight * resid) + l2 * ps * b

    def soft(b, thresh):
        return torch.sign(b) * torch.clamp(torch.abs(b) - thresh, min=0.0)

    with _trace.span("fit.epoch"):
        b, z = beta, beta
        t = torch.tensor(1.0, dtype=beta.dtype, device=beta.device)
        for _ in range(n_steps):
            b_new = soft(z - step * grad(z), step * l1 * ps)
            t_new = 0.5 * (1 + torch.sqrt(1 + 4 * t * t))
            z = b_new + ((t - 1) / t_new) * (b_new - b)
            b, t = b_new, t_new
        return b


def _power_iteration_lipschitz(mv, tmv, w, k, dtype, device, n_iter=12):
    """Estimate L = λmax(Xᵀ diag(w) X) by power iteration (matvec-based)."""
    v = torch.ones(k, dtype=dtype, device=device) / np.sqrt(k)
    lam = torch.tensor(1.0, dtype=dtype, device=device)
    for _ in range(n_iter):
        hv = tmv(w * mv(v))
        lam = torch.linalg.vector_norm(hv)
        v = hv / torch.clamp(lam, min=1e-30)
    return float(lam)


def _as_float(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` on ``like``'s device; integer data takes ``like``'s dtype."""
    t = to_tensor(x, device=like.device)
    return t if t.is_floating_point() else t.to(like.dtype)


def fit_glm(
    X,
    y,
    sample_weight=None,
    family: str = "gaussian",
    max_iter: int = 25,
    tol: float = 1e-10,
    n_cg: int = 16,
    l2: float = 0.0,
    l1: float = 0.0,
    inner_precision: str = "float32",
    penalty_scale=None,
    offset=None,
    P1=None,
    P2=None,
    device=None,
):
    """Fit a GLM by IRLS; accepts numpy arrays, tensors, a scipy sparse
    matrix, a DenseMatrix, a SparseMatrix, a CategoricalMatrix, a SplitMatrix
    of them, or a StandardizedMatrix over one of those.

    Matrices become a :class:`DeviceDesign` on their own device; a tensor
    stays on its device; a numpy array or a scipy sparse matrix goes to
    ``device``, which defaults to the CUDA card (``device="cpu"`` asks for
    the CPU).  ``offset`` adds a fixed
    term to the linear predictor.  ``P1``/``P2`` are per-feature penalty
    multipliers in glum's convention: the effective penalties are
    ``l1·P1[j]`` and ``l2·P2[j]``.

    Returns (beta, n_iter), beta a tensor on the design's device.
    Convergence: max |Δβ| < tol.
    """
    from .models.base import MatrixBase
    from .models.split import as_tabmat
    from .models.standardized import StandardizedMatrix
    from .parallel.design import DeviceDesign

    with _trace.span("fit"):
        if _is_scipy_sparse(X):
            X = as_tabmat(X, device=device)
        if isinstance(X, (MatrixBase, StandardizedMatrix)):
            X = DeviceDesign.from_matrix(X)
        if not isinstance(X, DeviceDesign):
            X = to_tensor(X, device=device)
            if not X.is_floating_point():
                X = X.to(DEFAULT_DTYPE)
        beta = torch.zeros(X.shape[1], dtype=X.dtype, device=X.device)
        y = _as_float(y, beta)
        if sample_weight is None:
            # a sharded design's rows on this rank
            n_rows = X.n_local if isinstance(X, DeviceDesign) else X.shape[0]
            sample_weight = torch.ones(n_rows, dtype=X.dtype, device=X.device)
        else:
            sample_weight = _as_float(sample_weight, beta)

        if penalty_scale is not None:
            penalty_scale = to_tensor(penalty_scale, device=beta.device, dtype=beta.dtype)
        if P1 is not None or P2 is not None:
            # glum-style per-feature multipliers fold into penalty_scale; when
            # P1 and P2 differ the l1/l2 terms need separate scales — supported
            # for the common case P1 == P2 (or only one penalty active)
            base = penalty_scale if penalty_scale is not None else torch.ones_like(beta)
            if P1 is not None and P2 is not None and not np.array_equal(
                np.asarray(P1), np.asarray(P2)
            ) and l1 > 0 and l2 > 0:
                raise NotImplementedError(
                    "distinct P1 and P2 with both l1 and l2 active are not yet supported"
                )
            pf = P1 if P1 is not None else P2
            penalty_scale = base * to_tensor(pf, device=beta.device, dtype=beta.dtype)
        if offset is not None:
            offset = to_tensor(offset, device=beta.device, dtype=beta.dtype)

        if l1 > 0:
            # elastic net → FISTA epochs (IRLS can't handle the nonsmooth term)
            mv, tmv = _make_mv_tmv(X)
            # Lipschitz bound of the smooth part: the IRLS weight is bounded for
            # gaussian/logistic/gamma; poisson (w=mu), inverse_gaussian (w=1/mu)
            # and tweedie (w=mu^{2-p}) are unbounded in mu, so estimate at w=1
            # and add step slack below
            family_base, _ = _parse_family(family)
            caps = {"gaussian": 1.0, "logistic": 0.25, "gamma": 1.0}
            w_cap = caps.get(family_base)
            w_est = sample_weight * (w_cap if w_cap is not None else 1.0)
            L = _power_iteration_lipschitz(
                mv, tmv, w_est, X.shape[1], beta.dtype, beta.device
            ) + l2
            if w_cap is None:
                L *= 4.0  # slack for the mu-dependent weight near the optimum
            step = 0.95 / max(L, 1e-30)
            for it in range(max_iter):
                new_beta = fista_epoch(
                    X, y, sample_weight, beta, step,
                    family=family, n_steps=50, l1=l1, l2=l2,
                    penalty_scale=penalty_scale, offset=offset,
                )
                with _trace.span("fit.converge"):
                    delta = float(torch.max(torch.abs(new_beta - beta)))
                beta = new_beta
                if delta < tol:
                    return beta, it + 1
            return beta, max_iter

        for it in range(max_iter):
            new_beta = irls_step(
                X, y, sample_weight, beta, family=family, n_cg=n_cg, l2=l2,
                inner_precision=inner_precision, penalty_scale=penalty_scale,
                offset=offset,
            )
            with _trace.span("fit.converge"):
                delta = float(torch.max(torch.abs(new_beta - beta)))
            beta = new_beta
            if delta < tol:
                return beta, it + 1
        return beta, max_iter


def _is_scipy_sparse(X) -> bool:
    from scipy import sparse as sps

    return sps.issparse(X)


class GeneralizedLinearRegressor:
    """Minimal sklearn-style GLM estimator over tabmat_torch matrices.

    Accepts numpy arrays, tensors, a scipy sparse matrix, a DenseMatrix, a
    SparseMatrix, a CategoricalMatrix, a SplitMatrix, a StandardizedMatrix
    (with ``fit_intercept=False``: as in the reference, the intercept column
    cannot be stacked beside it), or a DataFrame (through ``from_df``).
    With ``formula='y ~ ...'`` the design and the response come from the
    frame passed as ``X`` (``from_formula``), and ``predict`` re-encodes a
    new frame with the training levels.

    Parameters
    ----------
    family: 'gaussian' | 'poisson' | 'logistic' | 'gamma' | ...
    l2: ridge penalty strength
    fit_intercept: prepend a constant column
    max_iter / tol / n_cg: IRLS and inner-CG controls
    formula: a Wilkinson formula; ``fit`` then takes a frame
    device: where numpy inputs and frames go; None means the CUDA card
    """

    def __init__(
        self,
        family: str = "gaussian",
        l2: float = 0.0,
        l1: float = 0.0,
        fit_intercept: bool = True,
        max_iter: int = 50,
        tol: float = 1e-10,
        n_cg: int = 20,
        inner_precision: str = "float32",
        formula: str = None,
        device=None,
    ):
        family = _FAMILY_ALIASES.get(family, family)
        if family not in FAMILIES and not family.startswith("tweedie"):
            raise ValueError(f"Unknown family {family!r}; options: {FAMILIES}")
        if family.startswith("tweedie"):
            _parse_family(family)  # validates the power
        self.family = family
        self.l2 = l2
        self.l1 = l1
        self.fit_intercept = fit_intercept
        self.max_iter = max_iter
        self.tol = tol
        self.n_cg = n_cg
        self.inner_precision = inner_precision
        self.formula = formula
        self.device = device
        self._formula_spec = None

    @staticmethod
    def _is_frame(X) -> bool:
        """Anything but an array, a tensor, a matrix or a scipy sparse
        matrix is read as a frame."""
        from .models.base import MatrixBase
        from .models.standardized import StandardizedMatrix

        return not (isinstance(X, (MatrixBase, StandardizedMatrix, np.ndarray, torch.Tensor))
                    or _is_scipy_sparse(X))

    def _design(self, X):
        from .constructors import from_df
        from .models.split import hstack
        from .utils.validation import as_numpy_dtype

        if self._is_frame(X):
            X = from_df(X, device=self.device)
        if self.fit_intercept:
            ones = np.ones((X.shape[0], 1), dtype=as_numpy_dtype(X.dtype))
            X = hstack([ones, X], device=self.device)
        return X

    def _penalty_scale(self, k_total, has_intercept):
        """Exclude the intercept column from l1/l2 penalties (glum/sklearn
        convention)."""
        if not (has_intercept and (self.l1 > 0 or self.l2 > 0)):
            return None
        ps = np.ones(k_total)
        ps[0] = 0.0
        return ps

    def _formula_design(self, X, y):
        """``(design, y)`` of ``formula=`` on the frame ``X`` (the JAX
        package's ``tabmat_tpu/glm.py:476-500``); keeps the model spec."""
        from .formula import from_formula
        from .formula.engine import materialize_response

        if y is None:
            y = materialize_response(self.formula, X)
        design = from_formula(
            self.formula,
            X,
            include_intercept=self.fit_intercept,
            # estimators need an identifiable design: drop reference
            # levels of categoricals spanned by the intercept
            ensure_full_rank=True,
            device=self.device,
        )
        self._formula_spec = design.model_spec
        return design, y

    def fit(self, X, y=None, sample_weight=None):
        """Fit by IRLS; stores ``coef_``, ``intercept_``, ``n_iter_``.

        With ``formula='y ~ ...'`` set, pass the dataframe as ``X``: the
        response is evaluated from the formula's left-hand side unless ``y``
        is given, and ``feature_names_`` holds the design's column names.
        """
        if self.formula is not None:
            design, y = self._formula_design(X, y)
            names = design.column_names
            # the intercept column is recognised by name; it is left out of
            # the penalty even where fit_intercept=False kept it in coef_
            has_icpt = bool(names) and names[0] == "Intercept"
        else:
            design, has_icpt = self._design(X), self.fit_intercept
        beta, n_iter = fit_glm(
            design,
            y,
            sample_weight=sample_weight,
            family=self.family,
            max_iter=self.max_iter,
            tol=self.tol,
            n_cg=self.n_cg,
            l2=self.l2,
            l1=self.l1,
            inner_precision=self.inner_precision,
            penalty_scale=self._penalty_scale(design.shape[1], has_icpt),
            device=self.device,
        )
        beta = beta.cpu().numpy()
        split = self.fit_intercept and has_icpt
        self.intercept_ = float(beta[0]) if split else 0.0
        self.coef_ = beta[1:] if split else beta
        if self.formula is not None:
            self.feature_names_ = names[1:] if split else names
        self.n_iter_ = n_iter
        return self

    def linear_predictor(self, X):
        """``X @ coef_ + intercept_`` as host numpy (same X types as fit).

        A frame goes through the kept formula spec, which re-encodes it with
        the training levels, or else through ``from_df``.
        """
        if self._is_frame(X):
            if self._formula_spec is not None:
                Xm = self._formula_spec.get_model_matrix(X)
                names = Xm.column_names
                beta_full = (
                    np.concatenate([[self.intercept_], self.coef_])
                    if names and names[0] == "Intercept"
                    else self.coef_
                )
                return np.asarray(Xm.matvec(beta_full))
            from .constructors import from_df

            X = from_df(X, device=self.device)
        if isinstance(X, np.ndarray) or _is_scipy_sparse(X):
            eta = X @ self.coef_
        elif torch.is_tensor(X):
            coef = torch.as_tensor(self.coef_, device=X.device, dtype=X.dtype)
            eta = (X @ coef).cpu().numpy()
        else:
            eta = np.asarray(X.matvec(self.coef_))
        return eta + self.intercept_

    def predict(self, X):
        """Mean prediction on the response scale."""
        eta = self.linear_predictor(X)
        if self.family in ("poisson", "gamma") or self.family.startswith("tweedie"):
            return np.exp(eta)
        if self.family == "logistic":
            return 1 / (1 + np.exp(-eta))
        return eta
