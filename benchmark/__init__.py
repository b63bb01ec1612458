"""The benchmark of ``ance_tpu_torch`` on one NVIDIA H100.

``python -m benchmark.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that measures, generates traffic, counts work and
decides ``correct`` lives in this folder; the port is only driven.
"""
