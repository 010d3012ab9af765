"""TPC-DS q1-q20 on the port: the miniature's generator, the
specification's (``generate_spec``), the templates and their pandas
oracles."""

from .data import generate, generate_spec
from .queries import PLANS, QUERIES

__all__ = ["generate", "generate_spec", "PLANS", "QUERIES"]
