"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``perfbench/run.py`` runs one cell of ``BENCHMARK.json``; everything of one
configuration, traffic mix, cell or metric is a data file or a small module
of its own that the harness finds by name.  Nothing here imports ``jax`` or
the JAX package; ``perfbench/reference`` imports nothing of the port either.
"""
