"""Pair-sweep backends of the torch port (the strip backend and its
CUDA kernels)."""
