"""TPC-DS miniature q1-q20 on the port: the generator, the templates
and their pandas oracles."""

from .data import generate
from .queries import PLANS, QUERIES

__all__ = ["generate", "PLANS", "QUERIES"]
