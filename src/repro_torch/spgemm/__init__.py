"""The α-β cost layer of the planner (paper §5.2) and its decomposition
search. The distributed SpGEMM itself (``dist.py``, ``semiring.py`` of the
reference) is slice 6 of ROADMAP.md."""
from repro_torch.spgemm.autotune import (Plan, PlanCost, autotune,
                                         choose_bc_regime, enumerate_plans,
                                         plan_cost)
from repro_torch.spgemm.cost_model import (DEFAULT, CostParams, ProblemSizes,
                                           best_replication, w_1d, w_2d, w_3d,
                                           w_mfbc, w_mm)

__all__ = [
    "PlanCost", "autotune", "enumerate_plans", "plan_cost",
    "choose_bc_regime",
    "CostParams", "DEFAULT", "ProblemSizes", "best_replication",
    "w_1d", "w_2d", "w_3d", "w_mfbc", "w_mm",
    "Plan",
]
