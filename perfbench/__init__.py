"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``): see
``perfbench/run.py`` and ``BENCHMARK.json`` at the repository's root."""
