"""Float32 precision policy of the port.

The μ-scaled KKT blocks of the proximal Riccati recursion lose positive
definiteness under reduced-precision products: the JAX reference measured
23% non-finite solves when its matmuls ran in bf16 passes. TF32 keeps about
three decimal digits, so it stays off for matmuls and cuDNN alike and every
float32 product runs in full float32.
"""

from __future__ import annotations

import torch


def use_full_fp32() -> None:
    """Turn TF32 off for CUDA matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
