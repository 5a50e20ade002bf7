from repro_torch.core.bench.generator import (
    BenchmarkSuite, generate_suite, generate_bottleneck, generate_prediction,
    generate_tuning,
)
from repro_torch.core.bench.harness import evaluate_backend, accuracy_table

__all__ = [
    "BenchmarkSuite", "generate_suite", "generate_bottleneck",
    "generate_prediction", "generate_tuning", "evaluate_backend",
    "accuracy_table",
]
