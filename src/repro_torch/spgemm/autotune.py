"""Decomposition autotuner — the CTF "automatic mapping search" (§6.2).

Given operand byte counts and a mesh, enumerate every implemented variant ×
mesh-axis role assignment, evaluate the §5.2 α–β cost (plus a resharding
penalty when the plan's input layout differs from the caller's persistent
layout), reject plans that exceed the per-device memory budget, and return
the cheapest plan.

A copy of ``repro/spgemm/autotune.py`` with the frozen ``Plan`` record of
``repro/spgemm/dist.py`` copied in: the distributed SpGEMM variants it
names are slice 6 of ROADMAP.md, but the planner's regime choice
(``choose_bc_regime``) runs here on every query, and the search is pure
arithmetic that ``tests/test_torch_bc_api.py`` holds equal to the
reference's.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.spgemm.cost_model import (DEFAULT, CostParams, ProblemSizes,
                                           _log2)


@dataclasses.dataclass(frozen=True)
class Plan:
    """A decomposition choice: variant name + mesh axis assignment.

    axes: (q,) for 1d, (r, c) for 2d, (p1, r, c) for 3d.
    """

    variant: str
    axes: Tuple[str, ...]

    def __post_init__(self):
        n_axes = {"1": 1, "2": 2, "3": 3}[self.variant[0]]
        if len(self.axes) != n_axes:
            raise ValueError(f"variant {self.variant!r} takes {n_axes} "
                             f"axes, got {self.axes!r}")


@dataclasses.dataclass(frozen=True)
class PlanCost:
    plan: Plan
    seconds: float
    bytes_moved: float
    messages: float
    mem_per_device: float

    def __repr__(self):
        return (f"PlanCost({self.plan.variant}@{self.plan.axes}, "
                f"t={self.seconds:.3e}s, B={self.bytes_moved:.3e}, "
                f"M={self.mem_per_device:.3e})")


def _axis_perms(axes: Dict[str, int], k: int) -> Iterable[Tuple[str, ...]]:
    names = list(axes)
    return itertools.permutations(names, k)


def plan_cost(plan: Plan, sizes: ProblemSizes, axes: Dict[str, int],
              params: CostParams = DEFAULT) -> PlanCost:
    """Bytes/messages moved by our implementation of ``plan``.

    Byte counts mirror dist.py's collectives exactly (all-gather along an
    axis of size q multiplies a local shard by (q-1); monoid reductions
    cost 2x a psum — see semiring.py).
    """
    v = plan.variant
    nA, nB, nC = sizes.nnz_a, sizes.nnz_b, sizes.nnz_c
    total = math.prod(axes.values())

    def ag(nnz_global: float, shard_frac: float, q: int) -> Tuple[float, float]:
        """all_gather: local shard is nnz*shard_frac; returns (bytes, msgs)."""
        if q <= 1:
            return 0.0, 0.0
        return nnz_global * shard_frac * (q - 1), _log2(q)

    def rs(nnz_out_local: float, q: int) -> Tuple[float, float]:
        if q <= 1:
            return 0.0, 0.0
        return nnz_out_local * (q - 1) / q, _log2(q)

    b = m = 0.0
    sz = {a: axes[a] for a in plan.axes}
    if v == "1d_a":
        q = sz[plan.axes[0]]
        bb, mm = ag(nA, 1.0 / q, q)
        b, m = bb, mm
    elif v == "1d_b":
        q = sz[plan.axes[0]]
        b, m = ag(nB, 1.0 / q, q)
    elif v == "1d_c":
        q = sz[plan.axes[0]]
        b, m = rs(nC, q)
        b *= 2  # reduce to replicated (allreduce) ≈ 2x reduce-scatter
    elif v.startswith("2d") or v.startswith("3d"):
        if v.startswith("3d"):
            _, x, yz = v.split("_")
            p1, r, c = plan.axes
            q1, qr, qc = axes[p1], axes[r], axes[c]
            if x == "c":
                bb, mm = rs(nC / (qr * qc), q1)
                b += 2 * bb
                m += mm
            # l/r replication is amortized (replicate_adjacency) — charge 0
            inner_axes = (r, c)
        else:
            yz = v.split("_")[1]
            inner_axes = plan.axes
            qr, qc = axes[inner_axes[0]], axes[inner_axes[1]]
            q1 = 1
        qr, qc = axes[inner_axes[0]], axes[inner_axes[1]]
        frac = 1.0 / (qr * qc * q1)
        if yz == "ab":
            bb, mm = ag(nA, frac, qc)
            b += bb
            m += mm
            bb, mm = ag(nB, frac, qr)
            b += bb
            m += mm
        elif yz == "ac":
            bb, mm = ag(nA, frac, qc)
            b += bb
            m += mm
            bb, mm = rs(nC / (qc * q1), qr)
            b += bb
            m += mm
        elif yz == "bc":
            bb, mm = ag(nB, frac, qr)
            b += bb
            m += mm
            bb, mm = rs(nC / (qr * q1), qc)
            b += bb
            m += mm
    else:
        raise ValueError(v)

    # per-device memory after gathers (peak working set)
    mem = (nA + nB + nC) / total
    if v == "1d_a":
        mem += nA
    if v == "1d_b":
        mem += nB
    if v == "1d_c":
        mem += nC
    if v.startswith(("2d", "3d")):
        qr, qc = axes[inner_axes[0]], axes[inner_axes[1]]
        if yz == "ab":
            mem += nA / (qr * q1) + nB / (qc * q1)
        elif yz == "ac":
            mem += nA / (qr * q1) + nC / (qc * q1)
        elif yz == "bc":
            mem += nB / (qc * q1) + nC / (qr * q1)
        if v.startswith("3d") and v.split("_")[1] in ("l", "r"):
            which = nA if v.split("_")[1] == "l" else nB
            mem += which / (qr * qc)  # replicated over p1

    return PlanCost(plan, params.cost(m, b), b, m, mem)


def enumerate_plans(axes: Dict[str, int]) -> List[Plan]:
    plans: List[Plan] = []
    for (q,) in _axis_perms(axes, 1):
        for var in ("1d_a", "1d_b", "1d_c"):
            plans.append(Plan(var, (q,)))
    if len(axes) >= 2:
        for pair in _axis_perms(axes, 2):
            for var in ("2d_ab", "2d_ac", "2d_bc"):
                plans.append(Plan(var, pair))
    if len(axes) >= 3:
        for trip in _axis_perms(axes, 3):
            for x in ("l", "r", "c"):
                for yz in ("ab", "ac", "bc"):
                    plans.append(Plan(f"3d_{x}_{yz}", trip))
    return plans


def autotune(sizes: ProblemSizes, axes: Dict[str, int],
             mem_limit: float = float("inf"),
             params: CostParams = DEFAULT,
             allow: Optional[Sequence[str]] = None) -> PlanCost:
    """Pick the cheapest plan for the given operand sizes and mesh axes."""
    best: Optional[PlanCost] = None
    for plan in enumerate_plans(axes):
        if allow is not None and plan.variant not in allow:
            continue
        pc = plan_cost(plan, sizes, axes, params)
        if pc.mem_per_device > mem_limit:
            continue
        if best is None or pc.seconds < best.seconds:
            best = pc
    if best is None:
        raise ValueError("no feasible plan (memory limit too tight)")
    return best


def choose_bc_regime(n: int, m_edges: int, nb: int, fill: float,
                     *, vpu_ops: float = 3.9e12,
                     hbm_bw: float = 819e9, p: int = 256,
                     calibration=None,
                     est_iters: Optional[int] = None) -> Dict[str, float]:
    """Dense/COO/CSR relax regime choice (the paper's §7 observation that
    MFBC shines on dense frontiers, made quantitative with the reference's
    analytic constants).

    dense: work = 4·nb·n²/p VPU ops, traffic ≈ tile-model (compute-bound).
    coo:   work = 4·nb·m·fill/p ops but gather/segment traffic
           ≈ 24 bytes per (frontier-entry × edge) touch, memory-bound.
    csr:   frontier-occupancy-aware — the compacting relax's sweep-total
           work ``Σ_iter frontier_nnz·k̄ ≈ nb·m`` amortizes over
           ``est_iters`` iterations plus an ``nb·n`` per-iteration floor
           (``cost_model.relax_ops``); ``est_iters`` must be the same
           heuristic the planner prices sweeps with.

    With a measured ``calibration`` (``cost_model.Calibration``), the
    analytic estimates are replaced by fitted per-relax seconds for
    every measured variant — including the kernel dense route
    (``dense_kernel_s``) and the frontier-compacted CSR rate
    (``csr_s``, present only when that variant was measured) — and the
    result carries ``calibrated: True``. Note the calibrated COO
    estimate is fill-independent: the real COO relax processes the full
    padded edge list every iteration (no frontier compaction), so
    ``fill`` only shapes the analytic fallback.

    Returns per-iteration second estimates and the winner; the driver
    switches per iteration as the frontier fills (fill = fraction of
    active frontier entries).
    """
    out: Dict[str, float] = {}
    csr_s: Optional[float] = None
    if calibration is not None and calibration.has("dense") \
            and calibration.has("coo"):
        dense_s = calibration.step_seconds("dense", n, m_edges, nb, p=p)
        coo_s = calibration.step_seconds("coo", n, m_edges, nb, p=p)
        if calibration.has("dense", use_kernel=True):
            out["dense_kernel_s"] = calibration.step_seconds(
                "dense", n, m_edges, nb, p=p, use_kernel=True)
        if calibration.has("csr"):
            csr_s = calibration.step_seconds("csr", n, m_edges, nb, p=p,
                                             est_iters=est_iters)
        out["calibrated"] = True
    else:
        dense_s = 4.0 * nb * n * n / (p * vpu_ops)
        coo_touch = nb * fill * m_edges / p
        coo_s = max(4.0 * coo_touch / vpu_ops, 24.0 * coo_touch / hbm_bw)
        iters = max(int(est_iters or 1), 1)
        # Matches cost_model.relax_ops("csr"): sweep-total nb·m amortized
        # over est_iters plus the per-iteration (nb, n) compaction floor.
        csr_touch = nb * (m_edges / iters + n) / p
        csr_s = max(4.0 * csr_touch / vpu_ops, 24.0 * csr_touch / hbm_bw)
        out["calibrated"] = False
    candidates = {"dense": dense_s, "coo": coo_s}
    if csr_s is not None:
        out["csr_s"] = csr_s
        candidates["csr"] = csr_s
    out.update({"dense_s": dense_s, "coo_s": coo_s,
                "regime": min(candidates, key=candidates.get),
                "crossover_fill": min(1.0, (n * n) / max(m_edges, 1)
                                      * (4.0 / vpu_ops)
                                      / max(4.0 / vpu_ops, 24.0 / hbm_bw))})
    return out
