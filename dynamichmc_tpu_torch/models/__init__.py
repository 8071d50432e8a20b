"""Target models of the port."""

from .base import TestModel
from .funnel import funnel
from .gaussian import (
    correlated_gaussian,
    extreme_variance_gaussian,
    ill_conditioned_gaussian,
    mvnormal,
    std_normal,
)
from .hierarchical import (
    eight_schools_centered,
    eight_schools_noncentered,
    rosenbrock,
)
from .logreg import logistic_regression, logistic_regression_from_data
from .mixture import mixture
from .transforms import elongate

__all__ = [
    "TestModel",
    "correlated_gaussian",
    "eight_schools_centered",
    "eight_schools_noncentered",
    "elongate",
    "extreme_variance_gaussian",
    "funnel",
    "ill_conditioned_gaussian",
    "logistic_regression",
    "logistic_regression_from_data",
    "mixture",
    "mvnormal",
    "rosenbrock",
    "std_normal",
]
