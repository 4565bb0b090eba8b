"""The benchmark of the PyTorch and CUDA port (``iv2019_tpu_torch``).

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once; README.md says
how cells, configurations, traffic mixes and metrics are laid out as
files of their own.
"""
