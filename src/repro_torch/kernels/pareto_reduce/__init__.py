"""The exact Pareto entrants of a batch against a front (CUDA kernel +
plain torch version)."""
from repro_torch.kernels.pareto_reduce.ops import (entrants, pareto_reduce,
                                                   pareto_reduce_cost,
                                                   pareto_reduce_plain,
                                                   sort_key)

__all__ = ["entrants", "pareto_reduce", "pareto_reduce_cost",
           "pareto_reduce_plain", "sort_key"]
