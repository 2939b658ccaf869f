"""core — manifolds, functions, costs, constraint sets, dynamics, problems."""

from .costs import (
    Cost,
    CostStack,
    QuadraticControlCost,
    QuadraticCost,
    QuadraticResidualCost,
    QuadraticStateCost,
)
from .dynamics import ExplicitDynamics, LinearDiscreteDynamics
from .functions import (ControlErrorResidual, StageFunction, StateErrorResidual,
                        stage_param)
from .manifolds import (CartesianProduct, Manifold, TangentBundle, VectorSpace,
                        batched_jacfwd)
from .problem import (
    ProblemData,
    StageModel,
    TrajOptProblem,
    compute_derivatives,
    evaluate,
    make_problem,
    make_stage,
)
from .sets import (
    BoxConstraint,
    ConstraintSet,
    ConstraintSetProduct,
    EqualityConstraint,
    L1Penalty,
    NegativeOrthant,
)
