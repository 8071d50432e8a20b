"""Target models of the port."""

from .base import TestModel
from .funnel import funnel
from .gaussian import correlated_gaussian, mvnormal, std_normal
from .logreg import logistic_regression, logistic_regression_from_data

__all__ = ["TestModel", "correlated_gaussian", "funnel",
           "logistic_regression", "logistic_regression_from_data",
           "mvnormal", "std_normal"]
