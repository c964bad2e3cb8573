"""Elliptic-curve arithmetic on the host (Python ints)."""
