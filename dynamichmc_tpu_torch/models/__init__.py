"""Target models of the port."""

from .base import TestModel
from .gaussian import correlated_gaussian, mvnormal, std_normal

__all__ = ["TestModel", "correlated_gaussian", "mvnormal", "std_normal"]
