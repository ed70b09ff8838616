"""α–β communication cost model for distributed SpGEMM (paper §5.2).

Multiplying ``A (m×k) · B (k×n) → C (m×n)``, all potentially sparse, on a
processor grid. Costs are in seconds given ``CostParams``; sizes are in
*bytes* (the paper counts words — a constant factor absorbed into β).

Formulas implemented verbatim from the paper:

* 1D variant X ∈ {A, B, C}:       W_X  = α·log p + β·nnz(X)
* 2D variant YZ ∈ {AB, AC, BC}:   W_YZ = α·max(p_r, p_c)·log p
                                         + β·(nnz(Y)/p_r + nnz(Z)/p_c)
* 3D nesting (X over p₁, YZ over p₂×p₃) — the paper's composite expression,
  including the X=Y / X=Z / X∉{Y,Z} cases.
* ``w_mm`` — the W_MM envelope: min over factorizations p₁p₂p₃ = p of
  α·max(pᵢ)·log p + β·(nnzA/(p₁p₂)·δ(p₃) + nnzB/(p₂p₃)·δ(p₁)
  + nnzC/(p₁p₃)·δ(p₂)).
* ``w_mfbc`` — the Theorem 5.1 BC bound with replication factor c.
* ``mem_3d`` — the M_X,YZ memory footprint.

The same formulas drive the runtime autotuner
(``repro_torch.spgemm.autotune``) — the analogue of CTF's model-based
mapping search.

This is a copy of ``repro/spgemm/cost_model.py``, so the port's planner
prices a query exactly as the reference's does (``BCPlan.to_json`` is held
equal by ``tests/test_torch_bc_api.py``). The analytic constants below are
the reference's model of its TPU target, kept for that equality; they are
not the H100's. The card's step rates enter only through the port's own
measured calibration file (``DEFAULT_CALIBRATION_PATH`` /
``$REPRO_TORCH_BC_CALIBRATION``), which the reference never reads, and
this module never reads the reference's.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, List, Optional, Tuple

# --- the reference's analytic hardware constants (TPU v5e, per chip) ------
V5E_PEAK_BF16_FLOPS = 197e12  # FLOP/s
V5E_HBM_BW = 819e9  # bytes/s
V5E_ICI_BW = 50e9  # bytes/s per link
V5E_ICI_LATENCY = 1e-6  # seconds per message (α)


@dataclasses.dataclass(frozen=True)
class CostParams:
    alpha: float = V5E_ICI_LATENCY  # s per message
    beta: float = 1.0 / V5E_ICI_BW  # s per byte

    def cost(self, msgs: float, bytes_: float) -> float:
        return self.alpha * msgs + self.beta * bytes_


DEFAULT = CostParams()


@dataclasses.dataclass(frozen=True)
class ProblemSizes:
    """Byte counts of the three operands (and flops for sanity checks)."""

    nnz_a: float
    nnz_b: float
    nnz_c: float
    flops: float = 0.0

    def nnz(self, which: str) -> float:
        return {"A": self.nnz_a, "B": self.nnz_b, "C": self.nnz_c}[which]


def _log2(p: float) -> float:
    return math.log2(max(p, 2.0))


def w_1d(variant: str, sizes: ProblemSizes, p: int,
         params: CostParams = DEFAULT) -> float:
    """W_X(X, p) = O(α log p + β nnz(X))."""
    assert variant in ("A", "B", "C")
    if p <= 1:
        return 0.0
    return params.cost(_log2(p), sizes.nnz(variant))


def w_2d(variant: str, sizes: ProblemSizes, pr: int, pc: int,
         params: CostParams = DEFAULT) -> float:
    """W_YZ(Y, Z, p_r, p_c)."""
    assert variant in ("AB", "AC", "BC")
    y, z = variant[0], variant[1]
    p = pr * pc
    if p <= 1:
        return 0.0
    bytes_ = sizes.nnz(y) / pr + sizes.nnz(z) / pc
    return params.cost(max(pr, pc) * _log2(p), bytes_)


def w_3d(x: str, yz: str, sizes: ProblemSizes, p1: int, p2: int, p3: int,
         params: CostParams = DEFAULT) -> float:
    """Nested 1D(X over p₁) ∘ 2D(YZ over p₂×p₃), paper's simplified form.

    The inner 2D problem sees operand sizes shrunk by the 1D blocking:
    X is gathered from a p₂×p₃ distribution (bytes nnz(X)/(p₂p₃) per step
    before replication — the paper's W_X(X[p₂,p₃]) term), and operands not
    replicated are sliced by p₁.
    """
    assert x in ("A", "B", "C") and yz in ("AB", "AC", "BC")
    y, z = yz[0], yz[1]
    inner = dataclasses.asdict(sizes)
    key = {"A": "nnz_a", "B": "nnz_b", "C": "nnz_c"}
    if x == y:
        inner[key[z]] = sizes.nnz(z) / p1
    elif x == z:
        inner[key[y]] = sizes.nnz(y) / p1
    else:
        inner[key[y]] = sizes.nnz(y) / p1
        inner[key[z]] = sizes.nnz(z) / p1
    inner_sizes = ProblemSizes(**inner)
    # 1D replication of X from its (p2, p3) distribution:
    w_repl = params.cost(_log2(p1) if p1 > 1 else 0.0,
                         sizes.nnz(x) / (p2 * p3) * max(p1 - 1, 0))
    return w_repl + w_2d(yz, inner_sizes, p2, p3, params)


def mem_3d(x: str, yz: str, sizes: ProblemSizes, p: int, p1: int) -> float:
    """M_X,YZ = O(nnz(X)·p₁/p + (nnz(Y)+nnz(Z))/p) bytes per processor."""
    y, z = yz[0], yz[1]
    return sizes.nnz(x) * p1 / p + (sizes.nnz(y) + sizes.nnz(z)) / p


def factorizations(p: int, ways: int = 3) -> List[Tuple[int, ...]]:
    """All ordered factorizations of p into ``ways`` positive factors."""
    if ways == 1:
        return [(p,)]
    out = []
    for d in range(1, p + 1):
        if p % d == 0:
            for rest in factorizations(p // d, ways - 1):
                out.append((d,) + rest)
    return out


def w_mm(sizes: ProblemSizes, p: int, params: CostParams = DEFAULT,
         mem_limit: float = float("inf")) -> Tuple[float, Tuple[int, int, int]]:
    """The paper's W_MM envelope: best cost over p₁p₂p₃ = p factorizations.

    Returns (cost_seconds, (p1, p2, p3)). δ(x)=0 iff x==1 — an axis of size
    1 moves nothing for its operand.
    """
    best, best_f = float("inf"), (p, 1, 1)
    for (p1, p2, p3) in factorizations(p):
        bytes_ = 0.0
        bytes_ += (sizes.nnz_a / (p1 * p2)) * (0 if p3 == 1 else 1)
        bytes_ += (sizes.nnz_b / (p2 * p3)) * (0 if p1 == 1 else 1)
        bytes_ += (sizes.nnz_c / (p1 * p3)) * (0 if p2 == 1 else 1)
        cost = params.cost(max(p1, p2, p3) * _log2(p), bytes_)
        # rough memory: replicated fraction of each operand
        mem = (sizes.nnz_a / (p1 * p2) + sizes.nnz_b / (p2 * p3)
               + sizes.nnz_c / (p1 * p3))
        if mem > mem_limit:
            continue
        if cost < best:
            best, best_f = cost, (p1, p2, p3)
    return best, best_f


V5E_VPU_OPS = 3.9e12  # elementwise min-plus ops/s (VPU, not MXU)


def w_mfbc(n: int, m_edges: int, p: int, c: int, d: int, word: int = 8,
           params: CostParams = DEFAULT, flop_rate: float = V5E_VPU_OPS
           ) -> Dict[str, float]:
    """Theorem 5.1 cost terms for one full BC computation.

    n vertices, m arcs, p processors, replication factor c, diameter d.
    word = bytes per matrix element (multpath = 8: w + m as f32 pairs).

    β term per batch: Σ_i (nnz(F_i)+nnz(G_i))/√(pc) ≤ 4cm/√(pc) words
    (unweighted frontier-uniqueness bound), plus the amortized adjacency
    replication cm/p. Total over n²/(cm) batches = 4n²/√(cp) + cm/p —
    the Theorem 5.1 bound. ``seconds`` adds a sparse-work compute term
    (8·n·m relaxation ops over p VPUs) so TEPS projections are grounded.
    """
    c = max(1, min(c, p))
    n_batches = max(1.0, n * n / (c * m_edges))
    msgs = d * n_batches * math.sqrt(p / c) * _log2(p)
    bytes_ = word * (c * m_edges / p  # adjacency replication (amortized)
                     + n_batches * (4.0 * c * m_edges) / math.sqrt(p * c))
    comm = params.cost(msgs, bytes_)
    compute = 8.0 * n * m_edges / (p * flop_rate)
    return {
        "alpha_msgs": msgs,
        "beta_bytes": bytes_,
        "seconds": max(comm, compute),
        "comm_seconds": comm,
        "compute_seconds": compute,
        "n_b": c * m_edges / n,
        "n_batches": n_batches,
        "memory_per_p": word * c * m_edges / p,
    }


# --- measured step-time calibration ---------------------------------------
#
# The analytic per-relax estimates above price the reference's target from
# first-principles hardware constants; on a real host they are off by
# orders of magnitude. ``Calibration`` closes the loop: a calibration run
# measures warm batch-step times per execution variant, fits the α-β pair
# (fixed per-device-call overhead α, effective relax throughput 1/β) from
# two batch sizes, and persists it; ``load_calibration`` is how the
# planner and ``choose_bc_regime`` pick it up. The port's calibration
# command is ``repro_torch.launch.calibrate``; with no file, plans use the
# analytic model.

#: The port's own file (override with $REPRO_TORCH_BC_CALIBRATION). The
#: reference's ``results/cost_calibration.json`` and $REPRO_BC_CALIBRATION
#: hold rates of another host and package and are never read here.
DEFAULT_CALIBRATION_PATH = "results/cost_calibration_torch.json"
CALIBRATION_ENV = "REPRO_TORCH_BC_CALIBRATION"
CALIBRATION_VERSION = 1

#: Execution variants the calibration prices (see ``variant_key``).
STEP_VARIANTS = ("dense", "dense_kernel", "coo", "csr")


def variant_key(backend: str, use_kernel: bool = False) -> str:
    """Calibration table key for a (backend, kernel flag) pair."""
    backend = str(getattr(backend, "value", backend))
    if backend == "dense":
        return "dense_kernel" if use_kernel else "dense"
    return backend


def relax_ops(backend: str, n: int, m_edges: int, nb: int,
              *, p: int = 1, use_kernel: bool = False,
              est_iters: Optional[int] = None) -> float:
    """Work units of ONE relax iteration of one batch, per device.

    The unit the calibrated throughput is expressed in: dense relax
    touches every (source, vertex²) candidate (``4·nb·n²/p`` min-plus +
    tie updates, kernel or jnp fallback alike); the COO relax is
    segment ops over the *full* padded edge list every iteration
    (``4·nb·m/p`` — that implementation does not compact frontiers, so
    work is fill-independent; the analytic model's ``fill`` knob only
    applies to the uncalibrated estimate).

    The CSR relax compacts the maximal frontier, so its per-iteration
    work is *occupancy-aware*: each (source, vertex) entry enters the
    maximal frontier O(1) times per sweep, so the sweep's total
    candidate work is ≈ ``nb·m`` — ``Σ_iter frontier_nnz·k̄`` — spread
    over ``est_iters`` iterations, plus the per-iteration ``(nb, n)``
    mask/compaction floor: ``4·nb·(m/est_iters + n)/p``. Callers that
    price a whole sweep (W = 2·est_iters·relax_ops) must pass the same
    ``est_iters`` the fit used, so the heuristic cancels.
    """
    backend = str(getattr(backend, "value", backend))
    if backend == "dense":
        return 4.0 * nb * n * n / max(p, 1)
    if backend == "csr":
        iters = max(int(est_iters or 1), 1)
        return 4.0 * nb * (m_edges / iters + n) / max(p, 1)
    return 4.0 * nb * m_edges / max(p, 1)


@dataclasses.dataclass(frozen=True)
class StepRates:
    """Fitted α-β constants for one execution variant.

    ``seconds(batch) = overhead_s + relaxes · ops_per_relax / ops_per_s``
    — ``overhead_s`` is the fixed per-device-call cost (dispatch, host
    sync), ``ops_per_s`` the measured effective relax throughput.
    """

    ops_per_s: float
    overhead_s: float = 0.0

    def relax_seconds(self, ops: float) -> float:
        return ops / max(self.ops_per_s, 1.0)


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Measured step-time constants, keyed by execution variant.

    ``rates`` maps ``variant_key(backend, use_kernel)`` →
    ``StepRates``; ``meta`` records where the numbers came from
    (device, graph shape, batch sizes, iteration model) so a stale
    calibration is auditable. Missing variants fall back to the
    analytic model at the call site.
    """

    rates: Dict[str, StepRates]
    meta: Dict = dataclasses.field(default_factory=dict)

    def has(self, backend: str, use_kernel: bool = False) -> bool:
        return variant_key(backend, use_kernel) in self.rates

    def step_seconds(self, backend: str, n: int, m_edges: int, nb: int,
                     *, p: int = 1, use_kernel: bool = False,
                     est_iters: Optional[int] = None) -> float:
        """Calibrated seconds of ONE relax iteration of one batch.

        ``est_iters`` only matters for the frontier-compacting CSR
        variant (its per-iteration work amortizes the sweep, see
        ``relax_ops``) and must match the value the fit used.
        """
        r = self.rates[variant_key(backend, use_kernel)]
        return r.relax_seconds(relax_ops(backend, n, m_edges, nb, p=p,
                                         use_kernel=use_kernel,
                                         est_iters=est_iters))

    def overhead_seconds(self, backend: str, use_kernel: bool = False
                         ) -> float:
        """Fixed per-batch (per device call) overhead of a variant."""
        return self.rates[variant_key(backend, use_kernel)].overhead_s

    def kernel_pays(self) -> bool:
        """Measured verdict: does the dense kernel variant beat the plain
        one on this host? Conservative when the kernel variant was not
        measured. (The port's relaxes run the kernels on the card
        whatever ``BCPlan.use_kernel`` says; the flag is kept for the
        plan's JSON.)"""
        if "dense" not in self.rates or "dense_kernel" not in self.rates:
            return False
        return (self.rates["dense_kernel"].ops_per_s
                > self.rates["dense"].ops_per_s)

    def to_json(self) -> Dict:
        return {
            "version": CALIBRATION_VERSION,
            "meta": dict(self.meta),
            "rates": {k: {"ops_per_s": r.ops_per_s,
                          "overhead_s": r.overhead_s}
                      for k, r in self.rates.items()},
        }

    @classmethod
    def from_json(cls, d: Dict) -> "Calibration":
        if d.get("version") != CALIBRATION_VERSION:
            raise ValueError(f"unsupported calibration version "
                             f"{d.get('version')!r}")
        rates = {k: StepRates(ops_per_s=float(r["ops_per_s"]),
                              overhead_s=float(r.get("overhead_s", 0.0)))
                 for k, r in d.get("rates", {}).items()}
        if not rates:
            raise ValueError("calibration has no rates")
        return cls(rates=rates, meta=dict(d.get("meta", {})))


_CAL_CACHE: Dict[Tuple[str, float], Optional[Calibration]] = {}


def calibration_path(path: Optional[str] = None) -> str:
    return path or os.environ.get(CALIBRATION_ENV, DEFAULT_CALIBRATION_PATH)


def load_calibration(path: Optional[str] = None) -> Optional[Calibration]:
    """Load the persisted calibration, or None when there is none.

    Cached per (absolute path, mtime): a benchmark that recalibrates
    and replans in one process sees the fresh numbers, while the
    planner's per-plan lookups stay free. An unreadable or malformed
    file is treated as "not calibrated" (the analytic model is always
    a safe fallback), not an error.
    """
    p = os.path.abspath(calibration_path(path))
    try:
        mtime = os.path.getmtime(p)
    except OSError:
        return None
    key = (p, mtime)
    if key not in _CAL_CACHE:
        _CAL_CACHE.clear()  # one live entry: old mtimes never return
        try:
            with open(p) as f:
                _CAL_CACHE[key] = Calibration.from_json(json.load(f))
        except (OSError, ValueError, KeyError, TypeError):
            _CAL_CACHE[key] = None
    return _CAL_CACHE[key]


def save_calibration(cal: Calibration, path: Optional[str] = None) -> str:
    """Persist a calibration (the measurement loop's last step)."""
    p = calibration_path(path)
    d = os.path.dirname(p)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(p, "w") as f:
        json.dump(cal.to_json(), f, indent=1)
    return p


def best_replication(n: int, m_edges: int, p: int, mem_bytes: float,
                     d: int = 10, word: int = 8,
                     params: CostParams = DEFAULT) -> int:
    """Paper: c* = p^{1/3} n²/m, clamped by memory M = Ω(c·m/p)."""
    c_star = p ** (1.0 / 3.0) * n * n / m_edges
    c_mem = mem_bytes * p / (word * m_edges)
    c = int(max(1, min(c_star, c_mem, p)))
    # refine within a factor-2 neighbourhood by direct evaluation
    cands = sorted({max(1, c // 2), c, min(p, 2 * c), 1})
    return min(cands, key=lambda cc: w_mfbc(n, m_edges, p, cc, d, word,
                                            params)["seconds"])
