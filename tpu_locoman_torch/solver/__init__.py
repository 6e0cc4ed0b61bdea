"""SQP solver and its block-tridiagonal ADMM QP."""

from .qp import ADMMConfig  # noqa: F401
from .sqp import SQPConfig, SQPSolver, SolverState  # noqa: F401
