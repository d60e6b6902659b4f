"""The benchmark of the PyTorch/CUDA port (``hqp_tpu_torch``).

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once; see
``portbench/README.md``.
"""
