"""solvers — batched ProxDDP and FDDP."""

from . import fddp, sensitivity
from .fddp import FDDPConfig, FDDPResults
from .proxddp import ProxDDPConfig, ProxDDPResults, solve
from .sensitivity import solve_with_sensitivities, theta_sensitivities

__all__ = ["FDDPConfig", "FDDPResults", "ProxDDPConfig", "ProxDDPResults",
           "fddp", "sensitivity", "solve", "solve_with_sensitivities",
           "theta_sensitivities"]
