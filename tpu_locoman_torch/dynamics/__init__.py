"""Dynamics formulations."""

from .formulations import FORMULATIONS, make_formulation  # noqa: F401
