"""Mask-aware constraint accumulation and lane-uniform branching.

Counterpart of ``zkevm_specs_tpu/dsl/cs.py``.  A constraint is a boolean
tensor over a *batch* of lanes; failures are ORed per lane under the
current condition mask:

* eager mode keeps lazy message records so the earliest-failing lane can
  raise an error equivalent to the reference's, and supports *lane
  splitting*: when gadget code branches on a non-uniform condition, a
  ``LaneSplit`` is raised and the runner re-evaluates each lane subset;
* replay mode only ORs failure bits, with branch decisions replayed from
  the traced signature and witness hints from the recorded hint stream.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .value import Ctx, F, Word


class ConstraintUnsatFailure(AssertionError):
    def __init__(self, message: str) -> None:
        super().__init__(message)
        self.message = message


class LookupUnsatFailure(AssertionError):
    def __init__(self, table_name: str, inputs=None) -> None:
        message = f"Lookup {table_name} is unsatisfied on inputs {inputs}"
        super().__init__(message)
        self.message = message
        self.inputs = inputs


class LookupAmbiguousFailure(AssertionError):
    def __init__(self, table_name: str, inputs=None) -> None:
        message = f"Lookup {table_name} is ambiguous on inputs {inputs}"
        super().__init__(message)
        self.message = message
        self.inputs = inputs


class LaneSplit(Exception):
    """Raised by branch() when lanes disagree; the runner partitions them."""

    def __init__(self, mask) -> None:
        super().__init__("non-uniform branch")
        self.mask = np.asarray(mask)


def _host_bools(mask, batch: int) -> np.ndarray:
    arr = mask.detach().cpu().numpy() if isinstance(mask, torch.Tensor) else np.asarray(mask)
    return np.broadcast_to(arr, (batch,))


class ConstraintSystem:
    """Accumulates per-lane failure bits under a stack of condition masks."""

    def __init__(self, ctx: Ctx):
        self.ctx = ctx
        self.fail = torch.zeros((ctx.batch,), dtype=torch.bool, device=ctx.device)
        self.records: List[Tuple[object, Callable[[], str]]] = []
        self._mask = None  # current condition mask (None = all lanes)
        # branch-decision machinery (consumed/extended by branch())
        self.decisions: List = []
        self._decision_idx = 0
        # witness-hint stream: the eager trace records hint arrays; the
        # replay reads them back as inputs (two-phase hint protocol)
        self.hint_record: Optional[List] = None
        self.hint_bits: Optional[List] = None
        self.hint_replay: Optional[List] = None
        self._hint_idx = 0
        # the logUp query log of an eager pass: (table, row index, enabled)
        # for each lookup (tables/engine.py, parallel/logup_shard.py)
        self.lookup_log: Optional[List] = None

    # -- condition masks ---------------------------------------------------

    def push_mask(self, mask):
        prev = self._mask
        self._mask = mask if prev is None else (prev & mask)
        return prev

    def pop_mask(self, prev):
        self._mask = prev

    # -- constraint recording ---------------------------------------------

    def check(self, ok_mask: torch.Tensor, msg: Callable[[], str]):
        """Record a constraint: ok_mask must hold wherever the current
        condition mask is active."""
        bad = ~ok_mask
        if self._mask is not None:
            bad = bad & self._mask
        bad = torch.broadcast_to(bad, (self.ctx.batch,))
        self.fail = self.fail | bad
        if self.ctx.eager:
            self.records.append((bad, msg))

    # -- reference-compatible constraint API ------------------------------

    def constrain_zero(self, value: F, name: str = "value"):
        self.check(value.is_zero_mask(), lambda: f"Expected {name} to be 0, but got {value!r}")

    def constrain_not_zero(self, value: F, name: str = "value"):
        self.check(~value.is_zero_mask(), lambda: f"Expected {name} to be != 0")

    def constrain_zero_word(self, value: Word, name: str = "word"):
        self.check(value.is_zero_mask(), lambda: f"Expected {name} to be 0, but got {value!r}")

    def constrain_not_zero_word(self, value: Word, name: str = "word"):
        self.check(~value.is_zero_mask(), lambda: f"Expected {name} to be != 0")

    def constrain_equal(self, lhs: F, rhs: F, name: str = "values"):
        self.check(
            lhs.eq_mask(rhs),
            lambda: f"Expected {name} to be equal, but got {lhs!r} and {rhs!r}",
        )

    def constrain_equal_word(self, lhs: Word, rhs: Word, name: str = "words"):
        self.check(
            lhs.eq_mask(rhs),
            lambda: f"Expected {name} to be equal, but got {lhs!r} and {rhs!r}",
        )

    def constrain_bool(self, value: F, name: str = "value"):
        self.check(value.is_bool_mask(), lambda: f"Expected {name} to be a bool, but got {value!r}")

    def constrain_in_consts(self, value: F, options, name: str = "value"):
        mask = value.eq_mask(F.const(self.ctx, int(options[0])))
        for o in options[1:]:
            mask = mask | value.eq_mask(F.const(self.ctx, int(o)))
        self.check(mask, lambda: f"Expected {name} to be in {options}, but got {value!r}")

    def range_check(self, value: F, n_bytes: int, name: str = "value"):
        """value must fit in n_bytes (mirrors reference range_check,
        util/constraint_system.py:64-69)."""
        self.check(
            value.le_bits_mask(8 * n_bytes),
            lambda: f"Value {value!r} has too many bytes to fit {n_bytes} bytes",
        )

    # -- branching ---------------------------------------------------------

    def branch(self, cond_mask: torch.Tensor) -> bool:
        """Resolve a data-dependent Python branch to a lane-uniform bool.

        In eager mode a disagreement raises LaneSplit and the runner re-runs
        each subset; decisions are recorded to form the group's control
        signature.  In replay mode decisions come from the signature and the
        condition is *constrained* to match, preserving soundness.
        """
        if self._decision_idx < len(self.decisions):
            decided = self.decisions[self._decision_idx]
            self._decision_idx += 1
            self.check(
                cond_mask == decided,
                lambda: f"Branch condition diverged from signature {decided}",
            )
            return decided
        assert self.ctx.eager, "replay mode requires a full branch signature"
        arr = _host_bools(cond_mask, self.ctx.batch)
        if arr.all():
            decided = True
        elif not arr.any():
            decided = False
        else:
            raise LaneSplit(arr)
        self.decisions.append(decided)
        self._decision_idx += 1
        return decided

    # -- results -----------------------------------------------------------

    def first_failure_message(self) -> List[Optional[str]]:
        """Eager mode: per-lane message of the first failing constraint."""
        msgs: List[Optional[str]] = [None] * self.ctx.batch
        for bad, msg in self.records:
            arr = _host_bools(bad, self.ctx.batch)
            for i in np.flatnonzero(arr):
                if msgs[i] is None:
                    msgs[i] = msg()
        return msgs
