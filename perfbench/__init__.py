"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one H100.

``python perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints its
result as the last line of standard output."""
