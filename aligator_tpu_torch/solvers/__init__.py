"""solvers — batched ProxDDP."""

from .proxddp import ProxDDPConfig, ProxDDPResults, solve

__all__ = ["ProxDDPConfig", "ProxDDPResults", "solve"]
