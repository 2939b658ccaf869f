"""modelling — state spaces and dynamics models."""

from .dynamics.ode import (ODE, ContinuousDynamics, IntegratorEuler,
                           IntegratorMidpoint, IntegratorRK2, IntegratorRK4,
                           IntegratorSemiImplEuler, LinearODE)
from .spaces.se2 import SE2, SO2
from .spaces.se3 import SE3, SO3

__all__ = ["ODE", "ContinuousDynamics", "IntegratorEuler", "IntegratorMidpoint",
           "IntegratorRK2", "IntegratorRK4", "IntegratorSemiImplEuler",
           "LinearODE", "SE2", "SO2", "SE3", "SO3"]
