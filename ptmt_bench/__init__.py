"""The benchmark of the PyTorch/CUDA port of PTMT (see README.md)."""
