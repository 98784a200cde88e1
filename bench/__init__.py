"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once; ``bench/README.md`` says
how to add a configuration, a traffic mix, a cell or a per-layer metric.
Nothing here imports the JAX package or anything under ``benchmarks/``.
"""
