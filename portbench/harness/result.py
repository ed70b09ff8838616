"""What a run hands back, the answers' check, and the result's last line."""
from __future__ import annotations

import dataclasses
import json
import sys
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from portbench.harness.trace import DeviceTrace


@dataclasses.dataclass
class LayerContext:
    """What the per-layer readers read, from the traced window."""

    batches: int  # calls into the program in the window
    trace: Optional[DeviceTrace]
    launches: Dict[str, int]  # hand-written kernels' launches in the window
    # (nb, n, n2) of each dense product launch, or None
    product_shape: Optional[Tuple[int, int, int]]
    occupancy: Optional[Dict[str, int]]  # CSR compaction counts, window
    peak_window_bytes: int  # device memory peak inside the window


@dataclasses.dataclass
class Record:
    """One run's outcome, as a driver hands it to the harness."""

    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    checks: List[Tuple[str, float, float]]  # (name, worst value, limit)
    device: Dict[str, Any]
    layers: LayerContext

    @property
    def correct(self) -> bool:
        return (self.attempted > 0 and self.failed == 0 and bool(self.checks)
                and all(v <= lim for _, v, lim in self.checks))


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length, drawn
    from ``seed`` (Vitter's algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.items: List[Any] = []
        self.seen = 0
        self._rng = np.random.default_rng([seed, 2])

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self._rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def lam_rel_err(got: np.ndarray, want: np.ndarray) -> float:
    """max_v |got(v) - want(v)| / max(|want(v)|, 1): λ's error against the
    reference, relative where λ is 1 or more and absolute below."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        return float("inf")
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0)))


def line(cell, record: Record, traced: bool,
         metrics: Dict[str, Dict]) -> Dict:
    """The result object; ``checks`` comes last."""
    if not traced:
        metrics = {m["name"]: {"value": float(record.end_to_end[m["name"]]),
                               "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in
                   record.end_to_end}
    out: Dict[str, Any] = {"correct": record.correct,
                           "attempted": record.attempted,
                           "failed": record.failed, "metrics": metrics,
                           "device": record.device}
    if traced and record.layers.trace is not None:
        out["breakdown"] = {"device_ops": record.layers.trace.top_ops(),
                            "idle_gaps": record.layers.trace.top_idle()}
    out["checks"] = {name: {"value": value, "limit": limit}
                     for name, value, limit in record.checks}
    return out


def emit(out: Dict) -> None:
    """Each compared number beside its limit as the last lines on standard
    error, then the result as the last line of standard output."""
    for name, c in out["checks"].items():
        print(f"[portbench] check {name} = {c['value']!r} (limit "
              f"{c['limit']!r})", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
