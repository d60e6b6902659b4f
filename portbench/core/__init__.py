"""The benchmark's general machinery: cells are found by name from
``BENCHMARK.json`` and the data files under ``portbench/``."""
