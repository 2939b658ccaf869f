"""aligator_tpu_torch — the PyTorch/CUDA port of aligator_tpu.

Batched constrained trajectory optimization on one NVIDIA GPU: every
solver-facing tensor carries a leading batch axis (one scenario per entry).
Each Pallas TPU kernel of the JAX package has a hand-written CUDA kernel
here (``csrc/``: K1 fused Riccati, K2 SPD solve, K3/K4 medium-dim sweeps,
K5 contact-dynamics derivative rows), with a plain PyTorch version beside
it for CPU tensors; ``csrc/free_fd.cu`` is the free forward dynamics of the
nonlinear rollout, which the JAX package leaves to XLA. Entry points that create tensors take
``device=`` (default ``"cuda"``) and raise when CUDA is requested but absent.
"""

from . import _precision

_precision.use_full_fp32()

from . import core, gar, solvers  # noqa: E402

__all__ = ["core", "gar", "solvers"]
