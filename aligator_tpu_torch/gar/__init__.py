"""gar — batched proximal LQ problems and Riccati solvers."""

from .lqr_problem import (
    LQRKnots,
    LQRProblem,
    dense_kkt,
    dense_solve,
    kkt_error,
    split_solution,
)
from .riccati import RiccatiFactors, backward, forward, solve, solve_and_gains
from . import fused_riccati, fused_stage, spd_solve

__all__ = [
    "LQRKnots",
    "LQRProblem",
    "dense_kkt",
    "dense_solve",
    "kkt_error",
    "split_solution",
    "RiccatiFactors",
    "backward",
    "forward",
    "solve",
    "solve_and_gains",
    "fused_riccati",
    "fused_stage",
    "spd_solve",
]
