"""The paper's core: monoids, the zoo, the cost model, the planner and the
MapReduce jobs (Algorithms 1-5), under the JAX package's names."""
from . import monoids
from .aggregation import grad_accum_fold, local_fold, tree_bytes
from .calibration import (Calibration, TierCoeff, calibration_path,
                          default_calibration, get_calibration,
                          load_calibration, save_calibration,
                          set_calibration, use_calibration)
from .mapreduce import (STRATEGIES, MapReduceJob, ShuffleStats,
                        algorithm2_combiner, average_by_key_job,
                        cooccurrence_stripes_job, fold_stats,
                        validate_combiner, word_count_job)
from .monoid import (KernelLowering, Monoid, MonoidTypeError, check_laws,
                     check_structure, fold_map, register_kernel_lowering,
                     scan_fold, tree_fold)
from .monoids import REGISTRY, product
from .plan import (Plan, TierPlan, collective_algorithm, execute_fold,
                   plan_fold, segment_fold)

__all__ = [
    "Calibration", "KernelLowering", "MapReduceJob", "Monoid",
    "MonoidTypeError", "Plan", "REGISTRY", "STRATEGIES", "ShuffleStats",
    "TierCoeff", "TierPlan", "algorithm2_combiner", "average_by_key_job",
    "calibration_path", "check_laws", "check_structure",
    "collective_algorithm", "cooccurrence_stripes_job", "default_calibration",
    "execute_fold", "fold_map", "fold_stats", "get_calibration",
    "grad_accum_fold",
    "load_calibration", "local_fold", "monoids", "plan_fold", "product",
    "register_kernel_lowering", "save_calibration", "scan_fold",
    "segment_fold", "set_calibration", "tree_bytes", "tree_fold",
    "use_calibration", "validate_combiner", "word_count_job",
]
