"""aligator_tpu_torch — the PyTorch/CUDA port of aligator_tpu.

Batched constrained trajectory optimization on one NVIDIA GPU: every
solver-facing tensor carries a leading batch axis (one scenario per entry),
and the fused small-dim Riccati solve runs as a hand-written CUDA kernel
(``gar/fused_riccati.py``, ``csrc/fused_riccati.cu``) with a plain PyTorch
version beside it for CPU tensors. Entry points that create tensors take
``device=`` (default ``"cuda"``) and raise when CUDA is requested but absent.
"""

from . import _precision

_precision.use_full_fp32()

from . import core, gar, solvers  # noqa: E402

__all__ = ["core", "gar", "solvers"]
