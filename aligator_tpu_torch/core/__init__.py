"""core — manifolds, functions, costs, constraint sets, dynamics, problems."""

from .costs import (
    ConstantCost,
    Cost,
    CostStack,
    DirectSumCost,
    LogResidualCost,
    QuadraticControlCost,
    QuadraticCost,
    QuadraticResidualCost,
    QuadraticStateCost,
    RelaxedLogBarrierCost,
)
from .dynamics import (ExplicitDynamics, ImplicitDynamics, LinearDiscreteDynamics,
                       dynamics_at)
from .functions import (ControlBoxFunction, ControlErrorResidual, FunctionSlice,
                        GatedFunction, LinearFunction, LinearFunctionComposition,
                        StageFunction, StateErrorResidual, stage_param)
from .manifolds import (CartesianProduct, Manifold, TangentBundle, VectorSpace,
                        batched_jacfwd)
from .problem import (
    ProblemData,
    StageModel,
    TrajOptProblem,
    compute_derivatives,
    dynamics_vhp,
    evaluate,
    make_problem,
    make_stage,
    replicate_stage,
    stack_stages,
)
from .sets import (
    BoxConstraint,
    ConstraintSet,
    ConstraintSetProduct,
    EqualityConstraint,
    L1Penalty,
    NegativeOrthant,
)
