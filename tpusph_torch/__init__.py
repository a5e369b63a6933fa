"""tpusph_torch — the PyTorch/CUDA port of tpusph for NVIDIA Hopper.

The JAX package ``tpusph`` stays the reference; this package never imports
it (nor jax). The strip backend's three pair sweeps and the phase-change
vapor query (``csrc/strip_sweeps.cu``) and the column kernel's three
sweeps over the cell grid (``csrc/column_sweeps.cu``) are hand-written
CUDA kernels, built with nvcc at first use; on CPU tensors every sweep
runs its plain PyTorch version. Entry points run on the card unless the
caller passes ``device="cpu"``.
"""

from tpusph_torch.api import Simulation

__all__ = ["Simulation"]
