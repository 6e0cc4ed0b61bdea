"""Dynamics formulations."""

from .formulations import (  # noqa: F401
    FORMULATIONS,
    CentroidalAcc,
    CentroidalVel,
    Formulation,
    WholeBodyABA,
    WholeBodyAcc,
    WholeBodyRNEA,
    make_formulation,
)
