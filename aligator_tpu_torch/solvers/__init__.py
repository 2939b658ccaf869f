"""solvers — batched ProxDDP and FDDP."""

from . import fddp
from .fddp import FDDPConfig, FDDPResults
from .proxddp import ProxDDPConfig, ProxDDPResults, solve

__all__ = ["FDDPConfig", "FDDPResults", "ProxDDPConfig", "ProxDDPResults",
           "fddp", "solve"]
