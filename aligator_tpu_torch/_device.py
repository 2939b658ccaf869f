"""Resolution of the ``device=`` argument of the port's entry points."""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """Return ``torch.device(device)``.

    A CUDA request on a machine without a usable CUDA device raises: the
    port never falls back to the CPU on its own.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but torch finds no CUDA "
            "device; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
