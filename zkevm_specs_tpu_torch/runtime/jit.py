"""The compiled group verifier: eager trace on the host, replay on the card.

Counterpart of ``zkevm_specs_tpu/runtime/jit.py``:

1. an eager *trace pass* over the group, on host tensors, captures the
   gadget's control signature (branch decisions), the static magnitude
   bounds of every step column and the witness-hint stream (the row index
   of every lookup);
2. the replay (``__call__``) runs the same gadget code again on the
   device, with the signature and the hints replayed, and returns the
   per-lane failure bits.  There is no tracing compiler: the replay is a
   Python pass that launches the limb, field and lookup kernels.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..dsl.cs import ConstraintSystem
from ..dsl.value import Ctx, F, Word
from ..evm.instruction import Instruction
from ..evm.main import verify_step
from ..evm.step import StepState, StepStateBatch
from ..tables.container import TABLE_NAMES, Tables, fixed_tables
from ..tables.engine import Table
from .convert import to_device


# -- tables as a tree of limb tensors ----------------------------------------

def tables_to_pytree(tables: Tables):
    tree = {}
    for name in TABLE_NAMES:
        t: Table = getattr(tables, name)
        cols = {}
        for cname, v in t.data.items():
            if isinstance(v, Word):
                cols[cname] = {"lo": v.lo.limbs, "hi": v.hi.limbs}
            else:
                cols[cname] = {"f": v.limbs}
        # lookup indexes stay on the host: the replay does each lookup as a
        # hinted gather, so only the raw columns travel
        tree[name] = {"cols": cols}
    return tree


def tables_meta(tables: Tables):
    meta = {}
    for name in TABLE_NAMES:
        t: Table = getattr(tables, name)
        bits = {}
        for cname, v in t.data.items():
            bits[cname] = (v.lo.bits, v.hi.bits) if isinstance(v, Word) else v.bits
        meta[name] = {"n_rows": t.n_rows, "schema": t.schema, "bits": bits}
    return meta


def tables_from_pytree(ctx: Ctx, tree, meta) -> Tables:
    out = object.__new__(Tables)
    out.ctx = ctx
    out.fixed = fixed_tables()
    for name in TABLE_NAMES:
        m = meta[name]
        cols = {}
        for cname, arrs in tree[name]["cols"].items():
            b = m["bits"][cname]
            if "lo" in arrs:
                cols[cname] = Word(F(ctx, arrs["lo"], b[0]), F(ctx, arrs["hi"], b[1]))
            else:
                cols[cname] = F(ctx, arrs["f"], b)
        setattr(out, name, Table(ctx, m["schema"], cols, m["n_rows"]))
    return out


def _slice_lanes(tree, lane_idx: np.ndarray):
    """Gather the leading (lane) axis of every array leaf (CPU tensors and
    numpy arrays alike, each keeping its type)."""
    if isinstance(tree, dict):
        return {k: _slice_lanes(v, lane_idx) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_slice_lanes(v, lane_idx) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree[torch.from_numpy(lane_idx)]
    return np.asarray(tree)[lane_idx]


# -- compiled group verifier --------------------------------------------------

class CompiledGroupVerifier:
    """One (execution_state, signature) group of the EVM circuit, traced on
    the host and replayed on ``device`` ("cuda" unless the caller asks for
    "cpu"; there is no fallback)."""

    def __init__(self, tables: Tables, state, steps: List[StepState],
                 next_steps: List[StepState], is_first=False, is_last=False,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CompiledGroupVerifier: device 'cuda' requested but no CUDA device is "
                "available; pass device='cpu' to replay on the CPU")
        self.state = state
        self.is_first = is_first
        self.is_last = is_last

        # eager trace pass on host tensors: signature + column bounds + the
        # witness-hint stream (reused by prepare_inputs for the same steps)
        ctx = Ctx("cpu", len(steps), "eager")
        cs = ConstraintSystem(ctx)
        cs.hint_record, cs.hint_bits = [], []
        curr = StepStateBatch(ctx, steps, state)
        nxt = StepStateBatch(ctx, next_steps)
        self._tables = tables
        inst = Instruction(ctx, cs, tables.with_ctx(ctx), curr, nxt, is_first, is_last)
        verify_step(inst)  # raises LaneSplit if the group isn't uniform
        self.signature = list(cs.decisions)
        self.hint_bits = list(cs.hint_bits)
        self.curr_bits = curr.column_bits()
        self.next_bits = nxt.column_bits()
        self.tables_tree = tables_to_pytree(tables)
        self.meta = tables_meta(tables)
        self._built_inputs = (steps, next_steps,
                              (curr.to_columns(), nxt.to_columns(), self.tables_tree,
                               list(cs.hint_record)))
        self.n_constraints = len(cs.records)
        self.n_hints = len(self.hint_bits)

    @classmethod
    def from_trace(cls, tables: Tables, state, steps: List[StepState],
                   next_steps: List[StepState], is_first, is_last, signature,
                   trace: dict, lane_idx, device="cuda") -> "CompiledGroupVerifier":
        """Build without running the gadget eagerly again: slice the columns
        and the hint stream that an earlier pass over the whole group
        captured (the block verifier's partition pass) down to this chunk's
        lanes; ``lane_idx`` indexes the traced group's lanes, padding
        repeats a lane (the JAX package's ``from_trace``, jit.py:153-180)."""
        self = object.__new__(cls)
        self.device = torch.device(device)
        self.state = state
        self.is_first = is_first
        self.is_last = is_last
        self._tables = tables
        self.signature = list(signature)
        self.hint_bits = list(trace["hint_bits"])
        self.curr_bits = trace["curr_bits"]
        self.next_bits = trace["next_bits"]
        self.tables_tree = trace["tables_tree"]
        self.meta = trace["meta"]
        lane_idx = np.asarray(lane_idx, dtype=np.int64)
        self._built_inputs = (steps, next_steps,
                              (_slice_lanes(trace["curr_cols"], lane_idx),
                               _slice_lanes(trace["next_cols"], lane_idx),
                               self.tables_tree,
                               _slice_lanes(trace["hint_record"], lane_idx)))
        self.n_constraints = trace["n_constraints"]
        self.n_hints = len(self.hint_bits)
        return self

    def prepare_inputs(self, steps: List[StepState], next_steps: List[StepState]):
        """Host hint pass for the batch, then the inputs on the device."""
        return to_device(self.host_inputs(steps, next_steps), self.device)

    def host_inputs(self, steps: List[StepState], next_steps: List[StepState]):
        """Host hint pass for the batch: the replay's inputs as a host tree
        (CPU limb tensors, numpy hint indexes).  For the steps the verifier
        was traced on, the trace's columns and hints are reused instead of
        running the gadget eagerly a second time."""
        built_steps, built_next, built = self._built_inputs
        if steps is built_steps and next_steps is built_next:
            return built
        ctx = Ctx("cpu", len(steps), "eager")
        cs = ConstraintSystem(ctx)
        cs.decisions = list(self.signature)
        cs.hint_record, cs.hint_bits = [], []
        curr = StepStateBatch(ctx, steps, self.state)
        nxt = StepStateBatch(ctx, next_steps)
        inst = Instruction(ctx, cs, self._tables.with_ctx(ctx), curr, nxt,
                           self.is_first, self.is_last)
        verify_step(inst)
        assert len(cs.hint_record) == self.n_hints, (
            f"hint stream diverged: {len(cs.hint_record)} != {self.n_hints}")
        assert cs.hint_bits == self.hint_bits, (
            "hint magnitude bounds diverged from the traced group "
            "(malformed witness? verify it in spec mode instead)")
        return curr.to_columns(), nxt.to_columns(), self.tables_tree, cs.hint_record

    def __call__(self, curr_cols, next_cols, tables_tree, hints) -> torch.Tensor:
        """Replay the group on the inputs' device; returns the per-lane
        failure bits, a bool tensor [B] on that device."""
        batch = next(iter(curr_cols.values())).shape[0]
        ctx = Ctx(self.device, batch, "replay")
        cs = ConstraintSystem(ctx)
        cs.decisions = list(self.signature)
        cs.hint_replay = hints
        cs.hint_bits = self.hint_bits
        tables = tables_from_pytree(ctx, tables_tree, self.meta)
        curr = StepStateBatch.from_columns(ctx, curr_cols, self.state, self.curr_bits)
        nxt = StepStateBatch.from_columns(ctx, next_cols, None, self.next_bits)
        verify_step(Instruction(ctx, cs, tables, curr, nxt, self.is_first, self.is_last))
        return cs.fail
