"""Operator library: lowerings reached through ``registry.dispatch``."""
