"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

Each wrapper launches its kernel on a CUDA tensor (or raises) and takes the
plain version on a CPU tensor; ``<wrapper>.launches`` counts launches."""
