"""Adaptive approximate-BC estimator (λ moments, CIs, stopping rule).

A copy of ``repro/approx/driver.py`` without the deprecated ``approx_bc``
shim. The sampling loop lives in ``repro_torch.bc.solve``: it pulls padded
source batches from a strategy (``approx.sampling``), pushes them through
an executor and folds the per-vertex dependency moments into the
``LambdaEstimator`` defined here, testing ``stopping_check`` at epoch
boundaries (epoch-doubling, 1910.11039 §4). ``choose_sample_batch`` is the
n_b cost-model pick that ``repro_torch.bc.BCPlanner`` consults.

Estimator. For τ uniform source samples with running sums
``S1(v) = Σ_s δ_s(v)`` and ``S2(v) = Σ_s δ_s(v)²``:

  λ̂(v)  = (n/τ)·S1(v)                      (unbiased for λ(v) = Σ_s δ_s(v))
  x̄(v)  = S1(v)/((n-2)·τ) ∈ [0, 1]         (normalized-scale mean)
  hw(v)  = CI halfwidth of x̄(v)            (Bernstein or CLT rule)

Convergence: ``max_v hw(v) ≤ ε`` — or, when a ``topk`` query is given,
the earlier of that and CI-separation of the top-k set (every vertex in
the estimated top-k has a lower confidence bound above the upper bound of
every vertex outside it).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.approx import sampling as S


def _topk_separated(lam: np.ndarray, halfwidth: np.ndarray, k: int) -> bool:
    """True iff the k largest estimates are CI-separated from the rest."""
    if k >= lam.shape[0]:
        return True
    order = np.argsort(lam)[::-1]
    lo = lam[order[:k]] - halfwidth[order[:k]]
    hi = lam[order[k:]] + halfwidth[order[k:]]
    return bool(lo.min() > hi.max())


@dataclasses.dataclass
class ApproxResult:
    """Outcome of one approximate-BC run (λ convention of ``core.mfbc``)."""

    lam: np.ndarray  # (n,) λ̂ estimate, unnormalized
    halfwidth: np.ndarray  # (n,) CI halfwidth, same unnormalized scale
    n_samples: int
    n_epochs: int
    converged: bool  # stopping rule met (False: hit the sample cap)
    eps: float
    delta: float
    rule: str
    has_moments: bool = True  # CIs backed by real Σδ² (always)

    def topk(self, k: int) -> np.ndarray:
        """Vertex ids of the k largest estimates, descending."""
        order = np.argsort(self.lam)[::-1]
        return order[:k]

    def topk_separated(self, k: int) -> bool:
        """True iff the top-k set is CI-separated from the rest."""
        return _topk_separated(self.lam, self.halfwidth, k)


class LambdaEstimator:
    """Running moments of per-source dependencies, with CIs.

    The (Σδ, Σδ²) contract: every batch step feeding this estimator
    (``core.mfbc.metric_batch_moments`` through the executor) returns
    per-vertex first and second moments of the *unnormalized* dependency
    ``δ_s(v) ∈ [0, n-2]`` summed over the batch's valid sources:
    ``S1(v) = Σ_s δ_s(v)`` and ``S2(v) = Σ_s δ_s(v)²``. ``update`` folds
    them into running sums; halfwidths are computed on the normalized
    scale ``x_s(v) = δ_s(v)/(n-2) ∈ [0, 1]`` (divide S1 by n-2, S2 by
    (n-2)²).

    ``rule="bernstein"`` — rigorous empirical-Bernstein CIs
    (``sampling.bernstein_halfwidth``), the default of ``BCQuery`` and
    ``launch.bc_run --approx``; ``rule="normal"`` — CLT profile
    (``sampling.normal_halfwidth``). Both consume the same sums.
    """

    def __init__(self, n: int, eps: float, delta: float, rule: str):
        if rule not in ("bernstein", "normal"):
            raise ValueError(f"unknown stopping rule {rule!r}")
        self.n = n
        self.eps = eps
        self.delta = delta
        self.rule = rule
        self.s1 = np.zeros(n, dtype=np.float64)
        self.s2 = np.zeros(n, dtype=np.float64)
        self.tau = 0
        # Epoch-by-epoch convergence trace: ``stopping_check`` appends
        # (τ, max normalized halfwidth) at each boundary it tests, so
        # serving can stream partial convergence to polling clients.
        self.hw_history: list = []

    def update(self, s1_batch: np.ndarray, s2_batch: np.ndarray,
               n_valid: int) -> None:
        """Fold one batch's (S1, S2) sums over ``n_valid`` sources in."""
        self.s1 += s1_batch
        self.s2 += s2_batch
        self.tau += n_valid

    def _norm(self) -> float:
        return float(max(self.n - 2, 1))

    def halfwidth_normalized(self, delta: Optional[float] = None
                             ) -> np.ndarray:
        """CI halfwidth of x̄(v) on the [0, 1] normalized-dependency scale.

        The failure budget (``delta`` overrides ``self.delta`` — used by
        the sequential ``stopping_check``) is split non-uniformly across
        vertices (``sampling.allocate_delta``): empirical variance decides
        where δ is spent, so hub CIs — the ones the max over v binds on —
        shrink fastest.

        Fewer than two samples carry no variance estimate: the halfwidth
        is +inf everywhere, so a zero/one-sample run can never be
        mistaken for a converged one (``stopping_check`` sees an
        infinite max halfwidth, and a retired ``ApproxResult`` honestly
        reports unbounded CIs instead of finite garbage).
        """
        if self.tau < 2:
            return np.full(self.n, np.inf)
        d = self.delta if delta is None else delta
        c = self._norm()
        x1, x2 = self.s1 / c, self.s2 / (c * c)
        mean = x1 / self.tau
        var = np.maximum(x2 / self.tau - mean * mean, 0.0)
        delta_v = S.allocate_delta(var, d)
        fn = (S.bernstein_halfwidth if self.rule == "bernstein"
              else S.normal_halfwidth)
        return fn(x1, x2, self.tau, delta_v)

    def lam_scaled(self) -> np.ndarray:
        """λ̂(v) = (n/τ)·S1(v) — unnormalized λ units.

        Same ordered-pair convention as ``core.mfbc.mfbc`` (λ(v) =
        Σ_s δ_s(v), endpoints excluded): the Horvitz–Thompson scale-up
        n/τ makes the uniform-source sample mean unbiased for λ. Divide
        by n·(n-2) to land on the normalized [0, 1] scale that ``eps``
        is quoted on.
        """
        return self.s1 * (self.n / max(self.tau, 1))

    def hw_scaled(self, hw_normalized: np.ndarray) -> np.ndarray:
        """Normalized-scale CI halfwidth → λ units (λ̂ = n·(n-2)·x̄)."""
        return hw_normalized * self.n * self._norm()

    def converged(self) -> bool:
        if self.tau < 2:
            return False
        return bool(self.halfwidth_normalized().max() <= self.eps)

    def result(self, *, n_epochs: int, converged: bool) -> ApproxResult:
        return ApproxResult(
            lam=self.lam_scaled(),
            halfwidth=self.hw_scaled(self.halfwidth_normalized()),
            n_samples=self.tau,
            n_epochs=n_epochs,
            converged=converged,
            eps=self.eps,
            delta=self.delta,
            rule=self.rule,
        )


def adjacency_bytes(n: int, m_edges: int, *, backend: str = "dense",
                    p: int = 1, transpose: bool = False) -> float:
    """Per-device bytes of the adjacency operand.

    The one memory model shared by ``choose_sample_batch`` (n_b
    rejection) and ``repro_torch.bc.BCPlanner`` (plan predictions): f32 dense
    (n, n) divided across ``p`` devices, replicated COO (src, dst, w)
    edge arrays, or the CSR backend's dual-sorted arc lists (by-src and
    by-dst copies plus two int32 row-pointer arrays). ``transpose=True``
    doubles dense storage for paths that keep A and Aᵀ resident (the
    distributed step does).
    """
    if backend == "dense":
        b = 4.0 * n * n / max(p, 1)
        return 2.0 * b if transpose else b
    if backend == "csr":
        return 24.0 * m_edges + 8.0 * (n + 1)
    return 12.0 * m_edges


def state_bytes(n: int, nb: int, *, p: int = 1) -> float:
    """Per-device bytes of one batch's BC state (≈6 f32 (nb, n) mats)."""
    return 6.0 * 4.0 * nb * n / max(p, 1)


def choose_sample_batch(n: int, m_edges: int, *, p: int = 1,
                        backend: str = "dense",
                        mem_bytes: float = 4 * 2 ** 30,
                        budget_hint: Optional[int] = None,
                        candidates: Tuple[int, ...] = (16, 32, 64, 128, 256),
                        dispatch_overhead_s: float = 5e-4,
                        calibration=None) -> int:
    """Pick the sample-batch size n_b from the SpGEMM cost model.

    Scores each candidate with per-iteration relax seconds from
    ``spgemm.autotune.choose_bc_regime`` (dense/COO regime min) plus an
    amortized per-batch dispatch overhead, per *source*; rejects batch
    state that busts the memory budget (6 f32 state matrices of (n_b, n)
    plus the adjacency — dense (n, n) only when ``backend="dense"`` on a
    single device; COO edge arrays or a p-way sharded adjacency
    otherwise). With a ``budget_hint`` (e.g. the first epoch's length)
    candidates larger than the whole budget only waste padded rows and
    are skipped.

    ``p`` divides the adjacency across devices for a sharded plan (the
    distributed step is slice 6 of ROADMAP.md; plans price it all the
    same).

    With a measured ``calibration`` (``spgemm.cost_model.Calibration``)
    both the per-iteration seconds and the per-batch dispatch overhead
    come from the fitted α-β constants instead of the analytic model,
    so n_b tracks the host the run actually executes on.
    """
    from repro_torch.spgemm.autotune import choose_bc_regime

    adj_b = adjacency_bytes(n, m_edges, backend=backend, p=p)
    best_nb, best_cost = candidates[0], float("inf")
    for nb in candidates:
        if budget_hint is not None and nb > max(budget_hint, candidates[0]):
            continue
        # state priced unsharded (p=1) on purpose: a conservative bound
        # that keeps n_b picks stable whatever the batch-axis layout
        if adj_b + state_bytes(n, nb) > mem_bytes:
            continue
        reg = choose_bc_regime(n, m_edges, nb, fill=0.5, p=p,
                               calibration=calibration)
        step_s = min(reg["dense_s"], reg["coo_s"],
                     reg.get("csr_s", float("inf")))
        overhead = dispatch_overhead_s
        if calibration is not None and calibration.has(backend):
            overhead = calibration.overhead_seconds(backend)
        per_source = step_s + overhead / nb
        if per_source < best_cost:
            best_nb, best_cost = nb, per_source
    return best_nb


def stopping_check(est: "LambdaEstimator", eps: float, topk: Optional[int],
                   check_index: int):
    """One sequential convergence test; returns (stop, hw_normalized).

    The failure budget for the *sequence* of epoch-boundary checks is
    split geometrically — check i tests at level δ/2^(i+1), Σ_i δ_i ≤ δ —
    so repeatedly peeking at the CIs does not inflate the overall failure
    probability (the per-epoch budget split of 1910.11039 Alg. 1).
    Shared by ``bc.solve`` and ``bc.refine``.
    """
    delta_check = est.delta / (2.0 ** (check_index + 1))
    hw = est.halfwidth_normalized(delta=delta_check)
    est.hw_history.append((int(est.tau), float(hw.max())))
    if hw.max() <= eps:
        return True, hw
    if topk is not None and est.tau >= 2:
        return _topk_separated(est.lam_scaled(), est.hw_scaled(hw), topk), hw
    return False, hw

