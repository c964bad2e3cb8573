"""The verdicts a block verifier owes a witness of the benchmark's blocks
with its planted faults, and the faults planted in the reference's own
trace, so the port's witness can be compared with it row for row.

What each fault fails, from the zkEVM specification:

* a step's gas left + 1 breaks two gas transitions, ``next.gas_left ==
  gas_left - cost``: the step before it (whose next step it is) and its
  own, so both lanes fail;
* an EndTx step's gas left + 1 fails that lane alone: EndTx prices the
  caller's refund from it, and the root STOP before it does not constrain
  its successor's gas;
* a stack or storage write's value + 1 fails the writing step (its value
  no longer follows from what it read);
* a memory byte a SHA3 reads + 1 fails that byte's read row of the copy
  circuit (its rw lookup), which lays out two rows a byte, read then
  write, copy events in block order (the mixes copy only in SHA3);
* in the state circuit, sorted by (tag, id, address, field, storage key,
  rw counter), a read must equal the value its key last held (memory and
  the stack start at zero): a changed row fails if it is a read, and so
  does the next row if it reads the same key;
* a tx signed with a key other than its sender's fails that tx's row of
  the tx circuit (the recovered address is not the tx's caller); the
  signature is valid, so the sig circuit passes;
* an input of a circuit check altered at one row fails that row of that
  check alone, each by a rule that reads the row and no other: the
  prologue's constant rows must hold the tx's id, depth 1, is-root 1; a bytecode byte row's push
  size must be the push size of its byte; a keccak row's input RLC must be
  the RLC of its preimage's bytes; a sig row's key hash must be keccak of
  its key's bytes; a withdrawal row's MPT update must be in the MPT table;
  a pi tx-table row's value times its inverse witness must be 0 or 1.

Lanes and rows no fault touches pass."""
from __future__ import annotations

from typing import Set

from .evm import STATE_TAG, STEP_FIELDS, T_MEMORY, T_STACK, T_STORAGE, Trace, state_key

GAS_LEFT = STEP_FIELDS.index("gas_left")
VALUE = 7
ROW_KINDS = {"stack_value": (T_STACK, 1), "storage_value": (T_STORAGE, 1),
             "memory_value": (T_MEMORY, 0)}     # fault kind: (target, rw of the changed row)


def _changed_row(trace: Trace, index, f) -> int:
    """The rw row (index in ``trace.rws``) a row fault changes: the one
    row of its target its step writes, or the step's memory read ``f.key``
    (mod their count)."""
    key0, rw = ROW_KINDS[f.kind]
    lo, hi = trace.steps[f.step][1], trace.steps[f.step + 1][1]
    found = [i for c in range(lo, hi) for i in index.get(c, ())
             if trace.rws[i][2] == key0 and trace.rws[i][1] == rw]
    if rw == 0:
        return found[f.key % len(found)]
    if len(found) != 1:
        raise ValueError(f"step {f.step} writes {len(found)} rows of target {key0}")
    return found[0]


def _index(trace: Trace):
    index = {}
    for i, row in enumerate(trace.rws):
        if row[2] in (T_STACK, T_STORAGE, T_MEMORY):
            index.setdefault(row[0], []).append(i)
    return index


def plant(trace: Trace, faults) -> None:
    """The same faults as ``zkbench.faults.plant`` puts in the port's
    witness, in the reference's trace (the tx signatures are not part of
    it)."""
    index = _index(trace)
    for f in faults:
        if f.kind in ("gas_left", "end_tx_gas"):
            s = list(trace.steps[f.step])
            s[GAS_LEFT] += 1
            trace.steps[f.step] = tuple(s)
        elif f.kind in ROW_KINDS:
            i = _changed_row(trace, index, f)
            row = list(trace.rws[i])
            row[VALUE] = (row[VALUE] + 1) % (256 if f.kind == "memory_value" else 1 << 256)
            trace.rws[i] = tuple(row)


def expected_failures(trace: Trace, faults) -> Set[object]:
    """{step index | ("state", row) | (circuit, row)} of every lane or row
    that fails, for the clean trace ``trace`` with ``faults`` planted."""
    out: Set[object] = set()
    index = _index(trace)
    rows = [r for r in trace.rws if r[2] in STATE_TAG]
    order = sorted(range(len(rows)), key=lambda i: state_key(rows[i]))
    rank = {rows[i][0]: r for r, i in enumerate(order) if rows[i][2] != 1}
    memory = [r[0] for r in trace.rws if r[2] == T_MEMORY]
    for f in faults:
        if f.kind == "gas_left":
            out |= {f.step - 1, f.step}
        elif f.kind == "end_tx_gas":
            out.add(f.step)
        elif f.kind == "tx_signature":
            out.add(("tx", f.tx))
        elif f.kind in ROW_KINDS:
            row = trace.rws[_changed_row(trace, index, f)]
            if f.kind == "memory_value":
                out.add(("copy", 2 * memory.index(row[0])))
            else:
                out.add(f.step)
            r = rank[row[0]]
            if row[1] == 0:
                out.add(("state", r))
            if r + 1 < len(order):
                after = rows[order[r + 1]]
                if state_key(after)[:5] == state_key(row)[:5] and after[1] == 0:
                    out.add(("state", r + 1))
    return out


def check_failures(rows) -> Set[object]:
    """{(check, row)} of the circuit-check faults planted at ``rows``
    ((check, row) pairs): each fails its row alone."""
    return {(check, int(row)) for check, row in rows}
