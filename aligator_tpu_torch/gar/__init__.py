"""gar — batched proximal LQ problems and Riccati solvers."""

from .lqr_problem import (
    LQRKnots,
    LQRProblem,
    add_parameterization,
    dense_kkt,
    dense_solve,
    kkt_error,
    kkt_residual_vectors,
    split_solution,
)
from .riccati import RiccatiFactors, backward, forward, solve, solve_and_gains
from . import (associative, block_tridiag, diff, fused_riccati, fused_stage,
               parallel, spd_solve)

__all__ = [
    "LQRKnots",
    "LQRProblem",
    "add_parameterization",
    "dense_kkt",
    "dense_solve",
    "kkt_error",
    "kkt_residual_vectors",
    "split_solution",
    "RiccatiFactors",
    "backward",
    "forward",
    "solve",
    "solve_and_gains",
    "associative",
    "block_tridiag",
    "diff",
    "fused_riccati",
    "fused_stage",
    "parallel",
    "spd_solve",
]
