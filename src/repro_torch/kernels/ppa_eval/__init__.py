"""Batched design-point PPA evaluation (CUDA kernel + plain torch version)."""
from repro_torch.kernels.ppa_eval.ops import (KernelTables, kernel_tables,
                                              op_table, op_table_tensor,
                                              ppa_eval, ppa_eval_op_count,
                                              ppa_eval_plain,
                                              ppa_eval_workloads, workload_tp)

__all__ = ["KernelTables", "kernel_tables", "op_table", "op_table_tensor",
           "ppa_eval", "ppa_eval_op_count", "ppa_eval_plain",
           "ppa_eval_workloads", "workload_tp"]
