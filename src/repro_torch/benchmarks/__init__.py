"""Benchmarks of the port (counterparts of the reference's
``benchmarks/``), run on the CUDA card unless ``--device cpu`` is given."""
