"""ExecutionConfig — the typed backend-dispatch vocabulary of the solver.

A copy of ``repro/bc/config.py``. ``ExecutionConfig`` is carried on every
``BCPlan`` and resolved against the backend registry in
``repro_torch.bc.executor``. Field semantics are two-sided:

* on a **query** (``BCQuery.execution``) every field is an optional
  *pin* — ``None`` means "the planner decides" (backend from the
  dense-vs-COO-vs-CSR regime model, kernel flag from a calibration's
  measured verdict, placement from the device topology);
* on a **plan** (``BCPlan.execution``) the config is fully *resolved*:
  ``backend``, ``use_kernel`` and ``placement`` are concrete, and the
  executor layer dispatches on them without re-deciding anything.

In the port ``use_kernel`` only records the plan's choice, for the plan's
JSON: on the card the dense relaxes always run the hand-written kernels,
and on the CPU always their plain versions.

``Backend`` subclasses ``str`` so comparisons (``plan.backend == "coo"``)
and JSON serialization work verbatim; use ``.value`` when formatting
messages.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional, Union

PLACEMENTS = ("single_host", "mesh")


class Backend(str, enum.Enum):
    """Relax-step backend: which sparse-multiplication routine runs.

    ``DENSE`` — tropical matmul over an (n, n) adjacency: the Hopper
    kernels (``kernels.tropical_mm`` / ``kernels.centpath_mm``) on the
    card, the blocked plain versions (``monoids.*_relax_dense``) on the
    CPU. The only backend with a distributed (mesh) step.

    ``COO`` — edge-list relaxation with segment reductions; work scales
    with nnz instead of n². ``CSR`` — the same over a frontier-compacted
    arc list. Both single-host only; their relax runs in the sparse-relax
    kernel (``kernels.segment_relax``) on the card.
    """

    DENSE = "dense"
    COO = "coo"
    CSR = "csr"


def as_backend(value: Union["Backend", str, None]) -> Optional[Backend]:
    """Coerce a legacy backend string (or None) to the enum."""
    if value is None or isinstance(value, Backend):
        return value
    try:
        return Backend(value)
    except ValueError:
        raise ValueError(
            f"backend must be one of "
            f"{tuple(b.value for b in Backend)}, got {value!r}") from None


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """One typed execution choice: (backend, kernel flag, placement).

    ``None`` fields mean "planner decides" (query-side pins); the
    planner always emits a fully resolved config on the ``BCPlan``
    (``resolved`` is True). ``block`` is the dense relax block size —
    it has no "decide for me" state, so it carries a concrete default.
    """

    backend: Optional[Backend] = None
    use_kernel: Optional[bool] = None
    placement: Optional[str] = None  # "single_host" | "mesh"
    block: int = 512

    def __post_init__(self) -> None:
        object.__setattr__(self, "backend", as_backend(self.backend))
        if self.placement is not None and self.placement not in PLACEMENTS:
            raise ValueError(f"placement must be None or one of "
                             f"{PLACEMENTS}, got {self.placement!r}")
        if self.block <= 0:
            raise ValueError(f"block must be positive, got {self.block}")

    @property
    def resolved(self) -> bool:
        """True when nothing is left for the planner to decide."""
        return (self.backend is not None and self.use_kernel is not None
                and self.placement is not None)

    def resolve(self, **overrides) -> "ExecutionConfig":
        """A copy with the given fields pinned (planner's resolution step)."""
        return dataclasses.replace(self, **overrides)

    def to_json(self) -> Dict:
        return {
            "backend": None if self.backend is None else self.backend.value,
            "use_kernel": self.use_kernel,
            "placement": self.placement,
            "block": self.block,
        }

    @classmethod
    def from_json(cls, d: Dict) -> "ExecutionConfig":
        return cls(backend=as_backend(d.get("backend")),
                   use_kernel=d.get("use_kernel"),
                   placement=d.get("placement"),
                   block=int(d.get("block", 512)))

    def describe(self) -> str:
        be = "auto" if self.backend is None else self.backend.value
        return f"{be}@{self.placement or 'auto'}"
