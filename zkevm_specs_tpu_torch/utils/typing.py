"""The ``is_circuit_code`` marker (copy of ``zkevm_specs_tpu/utils/typing.py``).

It marks a function as constraint code: pure over its inputs, with no
data-dependent Python control flow, so the same body runs eagerly on host
tensors and as a device check unchanged.
"""
from __future__ import annotations

from typing import Callable, TypeVar

F = TypeVar("F", bound=Callable)


def is_circuit_code(func: F) -> F:
    """Mark ``func`` as circuit (constraint) code."""
    func.__is_circuit_code__ = True  # type: ignore[attr-defined]
    return func
