"""Communication-efficient distributed SpGEMM (the paper's §5): the α-β
cost layer of the planner and its decomposition search, the generalized
semirings, and the distributed variants over ``torch.distributed``."""
from repro_torch.spgemm.autotune import (Plan, PlanCost, autotune,
                                         choose_bc_regime, enumerate_plans,
                                         plan_cost)
from repro_torch.spgemm.cost_model import (DEFAULT, CostParams, ProblemSizes,
                                           best_replication, w_1d, w_2d, w_3d,
                                           w_mfbc, w_mm)
from repro_torch.spgemm.dist import local_block, plan_specs, spgemm
from repro_torch.spgemm.semiring import (GeneralizedSemiring, arithmetic,
                                         by_name, centpath, multpath)

__all__ = [
    "PlanCost", "autotune", "enumerate_plans", "plan_cost",
    "choose_bc_regime",
    "CostParams", "DEFAULT", "ProblemSizes", "best_replication",
    "w_1d", "w_2d", "w_3d", "w_mfbc", "w_mm",
    "Plan", "plan_specs", "local_block", "spgemm",
    "GeneralizedSemiring", "arithmetic", "by_name", "centpath", "multpath",
]
