"""Source-sampling strategies and stopping rules for approximate BC.

A numpy copy of ``repro/approx/sampling.py``: the same RNG streams for the
same ``(seed, rid)``, ``n_b``, cap and chunking, and the same statistics.

Samples are *sources*: one sample scores every vertex v with the
normalized dependency ``x_s(v) = δ_s(v)/(n-2) ∈ [0, 1]`` computed by one
row of the batched MFBC step. Strategies emit padded fixed-shape batches
(the same convention as ``core.mfbc``: padding rows carry ``valid=False``
and contribute nothing).

Stopping rules (all on the normalized scale, see ``approx/__init__``):

* ``hoeffding_budget`` — a-priori sample count ``τ ≥ ln(2n/δ)/(2ε²)``
  such that P(∃v: |x̄(v) − μ(v)| > ε) ≤ δ. The uniform strategy's fixed
  budget and the adaptive strategy's hard cap.
* ``bernstein_halfwidth`` — empirical-Bernstein CI [Maurer & Pontil 2009]
  with the failure budget union-bounded across vertices
  (δ_v = δ/n), the rule of 1910.11039 Alg. 1: adaptive sampling stops as
  soon as every vertex's halfwidth ≤ ε. Variance-adaptive: vertices with
  near-zero dependency variance (almost all of them on power-law graphs)
  converge in one epoch; only the hubs keep the loop alive.
* ``normal_halfwidth`` — CLT profile (z·σ̂/√τ, per-vertex δ): the
  practical production rule, matching how deployed approximate-BC systems
  trade the concentration-bound slack for ~3-5× fewer samples. Selected
  with ``rule="normal"``; the rigorous default is ``"bernstein"``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Optional, Tuple

import numpy as np


def hoeffding_budget(n: int, eps: float, delta: float) -> int:
    """Samples for a uniform ε-approximation of all n vertices w.p. 1-δ."""
    if eps <= 0:
        raise ValueError("eps must be positive")
    return int(math.ceil(math.log(2.0 * max(n, 2) / delta) / (2.0 * eps * eps)))


def epoch_schedule(tau0: int, growth: float = 2.0) -> Iterator[int]:
    """Epoch lengths ``tau0, tau0·g, tau0·g², …`` (1910.11039 §4 doubling).

    The stopping rule is only evaluated at epoch boundaries, so the
    host-device sync cost is logarithmic in the total sample count.
    """
    t = max(1, int(tau0))
    while True:
        yield t
        t = max(t + 1, int(t * growth))


def allocate_delta(var: np.ndarray, delta: float, *, n: Optional[int] = None,
                   total: Optional[float] = None) -> np.ndarray:
    """Non-uniform per-vertex failure budget (the KADABRA δ-splitting).

    Half of δ is spread uniformly; the other half proportionally to the
    empirical variance. The union bound Σδ_v = δ holds for any fixed
    allocation, and the few high-variance hubs that dominate
    ``max_v hw(v)`` get orders of magnitude more budget than the δ/n
    uniform split — a ~25% tighter CI exactly where the stopping rule
    binds. Caveat (shared with KADABRA's δ-splitting heuristic): the
    allocation is estimated from the same samples the CI is computed on,
    so the bound is rigorous under a two-phase reading (allocate on epoch
    e, test on epoch e+1) and a practical approximation as implemented.

    ``n`` and ``total`` (the whole graph's vertex count and ``var.sum()``)
    evaluate the split on a slice of the vertices' variances, element for
    element what the whole array gives.
    """
    n = var.shape[0] if n is None else n
    total = float(var.sum()) if total is None else total
    if total <= 0.0:
        return np.full(var.shape[0], delta / n)
    return delta * (0.5 / n + 0.5 * var / total)


def bernstein_halfwidth(s1: np.ndarray, s2: np.ndarray, tau: int,
                        delta_v) -> np.ndarray:
    """Empirical-Bernstein CI halfwidth for means of [0,1] samples.

    ``s1``/``s2`` are running Σx and Σx² per vertex; ``delta_v`` the
    per-vertex failure budget — scalar (uniform δ/n union bound) or array
    (``allocate_delta``). With probability ≥ 1-δ_v:
      |x̄ − μ| ≤ √(2·V̂·ln(3/δ_v)/τ) + 3·ln(3/δ_v)/τ,
    where V̂ is the *unbiased* sample variance (the Maurer–Pontil bound
    is stated for Σ(x_i − x̄)²/(τ−1), not the biased Σx²/τ − x̄²).
    Fewer than two samples carry no variance estimate at all: the
    halfwidth is +inf, so no stopping rule can certify from them.
    """
    if tau < 2:
        return np.full_like(np.asarray(s1, np.float64), np.inf)
    mean = s1 / tau
    var = np.maximum(s2 / tau - mean * mean, 0.0) * tau / (tau - 1)
    log_term = np.log(3.0 / np.asarray(delta_v, np.float64))
    return np.sqrt(2.0 * var * log_term / tau) + 3.0 * log_term / tau


def normal_halfwidth(s1: np.ndarray, s2: np.ndarray, tau: int,
                     delta_v) -> np.ndarray:
    """CLT halfwidth z_{1-δ_v/2}·σ̂/√τ with a 1/τ small-sample cushion.

    σ̂² is the unbiased sample variance; τ < 2 yields +inf (no variance
    estimate exists), matching ``bernstein_halfwidth``.
    """
    if tau < 2:
        return np.full_like(np.asarray(s1, np.float64), np.inf)
    mean = s1 / tau
    var = np.maximum(s2 / tau - mean * mean, 0.0) * tau / (tau - 1)
    z = math.sqrt(2.0) * _erfinv(1.0 - np.asarray(delta_v, np.float64))
    return z * np.sqrt(var / tau) + 1.0 / tau


def _erfinv(y):
    """Inverse error function (Winitzki's approximation, |err| < 2e-3)."""
    y = np.clip(np.asarray(y, np.float64), -(1 - 1e-12), 1 - 1e-12)
    a = 0.147
    ln1my2 = np.log(1.0 - y * y)
    t1 = 2.0 / (math.pi * a) + ln1my2 / 2.0
    return np.sign(y) * np.sqrt(np.sqrt(t1 * t1 - ln1my2 / a) - t1)


@dataclasses.dataclass(frozen=True)
class SampleBatch:
    """One padded static-shape source batch for ``mfbc_batch``."""

    sources: np.ndarray  # (n_b,) int32, padded with 0
    valid: np.ndarray  # (n_b,) bool, False on padding rows
    epoch: int

    @property
    def n_valid(self) -> int:
        return int(self.valid.sum())


class UniformSampler:
    """Fixed-budget uniform source sampling (Brandes & Pich 2007).

    Draws the full Hoeffding budget (or an explicit ``budget``) uniformly
    with replacement, chopped into ``n_b``-sized padded batches.
    """

    def __init__(self, n: int, *, eps: float = 0.05, delta: float = 0.1,
                 n_b: int = 64, budget: Optional[int] = None, seed: int = 0):
        self.n = n
        self.n_b = n_b
        self.budget = int(budget if budget is not None
                          else hoeffding_budget(n, eps, delta))
        self.rng = np.random.default_rng(seed)
        self._drawn = 0

    def batches(self) -> Iterator[SampleBatch]:
        epoch = 0
        while self._drawn < self.budget:
            k = min(self.n_b, self.budget - self._drawn)
            yield self._pad(self.rng.integers(0, self.n, k), epoch)
            self._drawn += k
            epoch += 1

    def _pad(self, srcs: np.ndarray, epoch: int) -> SampleBatch:
        k = srcs.shape[0]
        sources = np.zeros(self.n_b, np.int32)
        sources[:k] = srcs.astype(np.int32)
        valid = np.zeros(self.n_b, bool)
        valid[:k] = True
        return SampleBatch(sources, valid, epoch)


class AdaptiveSampler:
    """Epoch-doubling adaptive source sampling (1910.11039 §4).

    Demand and assembly are separate surfaces. The *demand* side —
    ``next_epoch() -> (epoch_index, m)`` ("give me m sources this
    epoch") plus ``draw(k)`` — is what cross-request fusion consumes:
    ``repro_torch.bc.fusion.BatchAssembler`` drains many live samplers' demand
    on the same graph and packs it into slot-tagged fused batches, so
    how sources are *drawn* (this class) is decoupled from how they are
    *batched* (the assembler, or the classic per-request chunking). The
    ``epochs()`` iterator is the single-query assembly built on that
    demand side: padded ``n_b``-sized batches, drawing chunk by chunk —
    the sequential driver in ``repro_torch.bc.solve`` pulls these and updates
    the estimator at epoch boundaries, then calls ``stop()``. Both
    assemblies consume the identical RNG stream (numpy draws bounded
    integers element-wise), so a request samples the same sources
    whichever path batches it.

    ``cap`` bounds the total draw at the Hoeffding budget — by then the
    a-priori guarantee holds regardless of what the empirical CIs say,
    so sampling past it is pure waste.

    ``seed`` is anything ``np.random.default_rng`` accepts — an int, or
    a sequence of ints such as ``(seed, rid)``, which is how
    the serving layer derives an independent stream per request
    without giving up exact reproducibility (same (seed, rid), same
    stream).
    """

    def __init__(self, n: int, *, eps: float = 0.05, delta: float = 0.1,
                 n_b: int = 64, tau0: Optional[int] = None,
                 growth: float = 2.0, cap: Optional[int] = None,
                 seed: int = 0):
        self.n = n
        self.n_b = n_b
        self.eps = eps
        self.delta = delta
        self.cap = int(cap if cap is not None
                       else hoeffding_budget(n, eps, delta))
        self._epochs = epoch_schedule(tau0 if tau0 else n_b, growth)
        self._ei = 0
        self.rng = np.random.default_rng(seed)
        self._drawn = 0
        self._stop = False

    def stop(self) -> None:
        """Signal convergence: no further epochs are generated."""
        self._stop = True

    @property
    def drawn(self) -> int:
        return self._drawn

    @property
    def capped(self) -> bool:
        return self._drawn >= self.cap

    # ----------------------------------------------------- checkpointing
    def state(self) -> dict:
        """Portable snapshot of the sampling stream position.

        Everything ``from_state`` needs to continue this exact stream:
        the epoch-schedule position, the draw count, and the generator's
        bit-level state. The stop latch is *not* captured — a restored
        sampler is re-armed on purpose (resumption exists to keep
        sampling past the point the original run stopped at).
        """
        return {
            "ei": self._ei,
            "drawn": self._drawn,
            "rng_state": self.rng.bit_generator.state,
        }

    @classmethod
    def from_state(cls, n: int, state: dict, *, eps: float, delta: float,
                   n_b: int, tau0: Optional[int] = None, growth: float = 2.0,
                   cap: Optional[int] = None) -> "AdaptiveSampler":
        """Rebuild a sampler mid-stream from a ``state()`` snapshot.

        ``eps``/``delta``/``cap`` are the *new* run's targets (a
        refinement resumes under a tighter ε, hence a larger Hoeffding
        cap); ``n_b``/``tau0``/``growth`` must match the original run or
        the epoch schedule — and with it the drawn stream — diverges.
        The schedule generator is re-advanced to the snapshot's epoch
        index, so the next ``next_epoch()`` demands exactly the epoch
        the original sampler would have demanded next.
        """
        s = cls(n, eps=eps, delta=delta, n_b=n_b, tau0=tau0, growth=growth,
                cap=cap)
        for _ in range(state["ei"]):
            next(s._epochs)
        s._ei = int(state["ei"])
        s._drawn = int(state["drawn"])
        s.rng.bit_generator.state = state["rng_state"]
        return s

    # ------------------------------------------------------- demand side
    def next_epoch(self) -> Optional[Tuple[int, int]]:
        """Demand for one epoch: ``(epoch_index, n_sources)``, or ``None``
        once stopped/capped. Advances the epoch schedule — callers must
        ``draw`` the returned count (in any chunking) before asking for
        the next epoch."""
        if self._stop or self._drawn >= self.cap:
            return None
        tau_e = min(next(self._epochs), self.cap - self._drawn)
        ei = self._ei
        self._ei += 1
        return ei, tau_e

    def draw(self, k: int) -> np.ndarray:
        """Draw k uniform sources (int32) and account for them."""
        srcs = self.rng.integers(0, self.n, k).astype(np.int32)
        self._drawn += k
        return srcs

    # ---------------------------------------------- single-query assembly
    def epochs(self) -> Iterator[Tuple[int, Iterator[SampleBatch]]]:
        """Yields (epoch_index, batch iterator); check ``stop`` between."""
        while True:
            nxt = self.next_epoch()
            if nxt is None:
                return
            ei, tau_e = nxt
            yield ei, self._epoch_batches(ei, tau_e)

    def _epoch_batches(self, epoch: int, tau_e: int) -> Iterator[SampleBatch]:
        left = tau_e
        while left > 0:
            k = min(self.n_b, left)
            sources = np.zeros(self.n_b, np.int32)
            sources[:k] = self.draw(k)
            valid = np.zeros(self.n_b, bool)
            valid[:k] = True
            left -= k
            yield SampleBatch(sources, valid, epoch)
