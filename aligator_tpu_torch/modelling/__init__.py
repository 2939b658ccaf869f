"""modelling — state spaces and dynamics models."""

from .dynamics.ode import ODE, IntegratorEuler
from .spaces.se2 import SE2, SO2

__all__ = ["ODE", "IntegratorEuler", "SE2", "SO2"]
