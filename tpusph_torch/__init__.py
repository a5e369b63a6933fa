"""tpusph_torch — the PyTorch/CUDA port of tpusph for NVIDIA Hopper.

The JAX package ``tpusph`` stays the reference; this package never imports
it (nor jax). Hand-written CUDA kernels, built with nvcc at first use: the
strip backend's three pair sweeps and the phase-change vapor query
(``csrc/strip_sweeps.cu``), the column kernel's three sweeps over the cell
grid (``csrc/column_sweeps.cu``), the band backend's three sweeps over the
slot-resident sub-cells (``csrc/band_sweeps.cu``), and the compacted force
sweep over the strip windows (``csrc/compact_force.cu``), which no path of
``Simulation`` runs: ``python -m tpusph_torch.proto_mxu_compact`` measures
it against the strip force sweep. On CPU tensors every sweep runs its
plain PyTorch version. At 2,048 particles or fewer ``auto`` takes the
dense backend (``ops/dense.py``, plain PyTorch, as the reference's XLA
dense rung). The input-script interpreter (``tpusph_torch.script``) and
the CLI (``python -m tpusph_torch.cli run in.script``) drive
``Simulation``. Entry points run on the card unless the caller passes
``device="cpu"``.
"""

from tpusph_torch.api import Simulation

__all__ = ["Simulation"]
