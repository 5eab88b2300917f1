"""The paper's core: monoids, the zoo, the cost model and the planner."""
from . import monoids
from .monoid import (KernelLowering, Monoid, MonoidTypeError, check_laws,
                     check_structure, fold_map, register_kernel_lowering,
                     scan_fold, tree_fold)
from .plan import Plan, TierPlan, execute_fold, plan_fold

__all__ = [
    "KernelLowering", "Monoid", "MonoidTypeError", "Plan", "TierPlan",
    "check_laws", "check_structure", "execute_fold", "fold_map", "monoids",
    "plan_fold", "register_kernel_lowering", "scan_fold", "tree_fold",
]
