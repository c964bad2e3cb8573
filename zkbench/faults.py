"""The faults the benchmark plants in every block it hands the verifier,
so that the verdicts it compares are not all "pass": which lanes a fault
touches is drawn from the seed, and how many of each kind the
configuration states.

* ``gas_left``: a step's gas left + 1 (a step inside a round);
* ``stack_value``: the value a step pushes + 1 (the stack write of a
  PUSH, ADD or SLOAD inside a round);
* ``storage_value``: the value an SSTORE writes to storage + 1;
* ``memory_value``: a byte that a SHA3 reads from memory + 1 (its copy
  event's memory read row);
* ``end_tx_gas``: an EndTx step's gas left + 1: first the block's first and
  last txs', whose EndTx differs from the others' (the first reads no
  earlier receipt, the last no next tx), then others drawn from the seed;
* ``tx_signature``: a tx re-signed with a key that is not its sender's;
* ``check_rows``: {check: count}, one input of a circuit check altered at
  one row, where the check reads it and nowhere else, after the build
  (``plant_checks``): the prologue's expected value of a constant row (a
  tx's id, its depth or is-root), a bytecode byte row's push size, a byte
  of a keccak row's preimage (a SHA3's, or a bytecode's where the block
  runs no SHA3), a byte of a sig row's public key, the padding
  withdrawal's id, a pi tx-table row's inverse witness.
  A check's faults go to rows in its first and second halves in turn, so
  that a check that evaluates half its rows misses one.

Round faults sit in distinct rounds, never in a tx's first round and never
in two neighbouring rounds of one tx, so no two faults meet in one
transition.  Positions come from the block's template alone (every tx of
the mixes runs its code straight through), so they are known before the
block is traced."""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from .gen.blocks import instructions_per_tx
from .reference.secp256k1 import N

ROUND_KINDS = ("gas_left", "stack_value", "storage_value")
WRITES_STACK = ("PUSH1", "PUSH2", "ADD", "SLOAD")
T_STORAGE, T_STACK, T_MEMORY = 6, 8, 9
BYTECODE_BYTE_TAG = 2


@dataclass(frozen=True)
class Fault:
    kind: str
    step: int = -1       # the step (index in the block's steps)
    tx: int = -1         # the tx (index in the block), for tx_signature
    key: int = 0         # the other signing key (tx_signature); which byte (memory_value,
    #                      check_row) and which row of the half (check_row)
    check: str = ""      # the circuit check (check_row)
    half: int = 0        # the half of the check's rows the row is drawn from (check_row)


def choose(config: dict, seed: int) -> List[Fault]:
    rng = random.Random(f"faults/{config['name']}/{seed}")
    counts: Dict[str, int] = config["faults"]
    n_txs, rounds, body = config["txs"], config["rounds"], config["round"]
    per_tx = 2 + instructions_per_tx(config)          # BeginTx, the code, EndTx
    eligible = [(t, r) for t in range(n_txs) for r in range(1, rounds)]
    rng.shuffle(eligible)
    taken: set = set()
    faults: List[Fault] = []
    for kind in ROUND_KINDS:
        if kind == "stack_value":
            offsets = [k for k, ins in enumerate(body) if ins[0] in WRITES_STACK]
        elif kind == "storage_value":
            offsets = [k for k, ins in enumerate(body) if ins[0] == "SSTORE"]
        else:
            offsets = list(range(len(body)))
        for _ in range(counts.get(kind, 0)):
            while True:
                if not eligible:
                    raise ValueError(f"{config['name']}: too few rounds for its faults")
                t, r = eligible.pop()
                if not {(t, r - 1), (t, r), (t, r + 1)} & taken:
                    break
            taken.add((t, r))
            step = t * per_tx + 1 + r * len(body) + rng.choice(offsets)
            faults.append(Fault(kind, step=step))
    sha3 = [k for k, ins in enumerate(config["tail"]) if ins[0] == "SHA3"]
    tail0 = 1 + rounds * len(body)
    for t in rng.sample(range(n_txs), counts.get("memory_value", 0)):
        faults.append(Fault("memory_value", step=t * per_tx + tail0 + sha3[0],
                            key=rng.randrange(1 << 16)))
    ends = [0, n_txs - 1] + rng.sample(range(1, n_txs - 1), n_txs - 2)
    for t in ends[:counts.get("end_tx_gas", 0)]:
        faults.append(Fault("end_tx_gas", step=(t + 1) * per_tx - 1))
    for t in rng.sample(range(n_txs), counts.get("tx_signature", 0)):
        faults.append(Fault("tx_signature", tx=t, key=rng.randrange(1, N)))
    for check, n in counts.get("check_rows", {}).items():
        for j in range(n):
            faults.append(Fault("check_row", check=check, half=j % 2, key=rng.randrange(1 << 62)))
    return faults


def _step_rows(rows, steps, step: int, key0: int, rw: int) -> list:
    """The rows of ``key0`` that step ``step`` reads (rw 0) or writes (1)."""
    lo, hi = steps[step].rw_counter, steps[step + 1].rw_counter
    return [r for c in range(lo, hi) for r in rows.get(c, ()) if r["key0"] == key0
            and r["rw"] == rw]


def _written_row(rows, steps, step: int, key0: int) -> dict:
    found = _step_rows(rows, steps, step, key0, 1)
    if len(found) != 1:
        raise ValueError(f"step {step} writes {len(found)} rows of target {key0}")
    return found[0]


def plant(witness, faults: List[Fault], sign_tx) -> None:
    """Plant ``faults`` in a traced witness of the port (its steps, rw rows
    and signed txs, in place); ``sign_tx(key, tx, chain_id)`` re-signs."""
    steps = witness.steps
    rows: Dict[int, List[dict]] = {}
    if any(f.kind in ("stack_value", "storage_value", "memory_value") for f in faults):
        for r in witness.rw.rws:
            if r["key0"] in (T_STACK, T_STORAGE, T_MEMORY):
                rows.setdefault(r["rw_counter"], []).append(r)
    for f in faults:
        if f.kind in ("gas_left", "end_tx_gas"):
            steps[f.step].gas_left += 1
        elif f.kind == "stack_value":
            row = _written_row(rows, steps, f.step, T_STACK)
            row["value"] = (row["value"] + 1) % (1 << 256)
        elif f.kind == "storage_value":
            row = _written_row(rows, steps, f.step, T_STORAGE)
            row["value"] = (row["value"] + 1) % (1 << 256)
        elif f.kind == "memory_value":
            reads = _step_rows(rows, steps, f.step, T_MEMORY, 0)
            row = reads[f.key % len(reads)]
            row["value"] = (row["value"] + 1) % 256
        elif f.kind == "tx_signature":
            witness.signed_txs[f.tx] = sign_tx(f.key, witness.signed_txs[f.tx], witness.chain_id)
        elif f.kind != "check_row":           # planted after the build (plant_checks)
            raise ValueError(f"unknown fault kind {f.kind!r}")


def _f(cols, name):
    """The limb array [rows, limbs] of a packed F column."""
    return cols[name]["f"]


def _eligible(check: str, cols, extra, n: int) -> np.ndarray:
    """The rows of ``check`` whose altered input fails that row alone."""
    if check == "prologue":               # constant rows: value == the tx's id, 1
        return np.flatnonzero(extra["const_mask"])
    if check == "bytecode":               # byte rows: push size == that of the byte
        return np.flatnonzero((_f(cols, "tag")[:, 0] == BYTECODE_BYTE_TAG)
                              & (_f(cols, "q_last")[:, 0] == 0))
    if check in ("keccak", "sig"):        # any row: its preimage's RLC, its key's hash
        return np.arange(n)
    if check == "withdrawal":             # one row: its MPT update (no id chain to break)
        return np.arange(n) if n == 1 else np.arange(0)
    if check == "pi":                     # tx-table rows with a nonzero value: value * inv
        q_tx = _f(cols, "q_tx_table")[:, 0] != 0
        nonzero = _f(cols, "tx_value_lo").any(axis=1)
        after_calldata = np.roll(_f(cols, "q_tx_calldata")[:, 0] != 0, 1)
        return np.flatnonzero(q_tx & nonzero & ~after_calldata)
    raise ValueError(f"no fault of check {check!r}")


def _alter(check: str, cols, extra, row: int, key: int) -> None:
    if check == "prologue":
        extra["const_val"][row] ^= 1
    elif check == "bytecode":
        _f(cols, "push_data_size")[row, 0] ^= 1
    elif check == "keccak":
        active = np.flatnonzero(extra["active_cols"][:, row])
        extra["byte_cols"][active[key % len(active)], row] ^= 1
    elif check == "sig":
        extra["pk_byte_cols"][key % 64, row] ^= 1
    elif check == "withdrawal":
        _f(cols, "withdrawal_id")[row, 0] ^= 1
    elif check == "pi":
        _f(cols, "tx_value_lo_inv")[row, 0] ^= 1


def plant_checks(bv, faults: List[Fault]) -> List[Tuple[str, int]]:
    """Plant the ``check_row`` faults in a built verifier's circuit checks
    (their host inputs, which every ``prepare`` uploads); the (check, row)
    of each, which the block now owes as failing."""
    kernels = dict(bv.circuit_kernels)
    taken: List[Tuple[str, int]] = []
    for f in faults:
        if f.kind != "check_row":
            continue
        k = kernels[f.check]
        cols, _tables, extra = k.args
        rows = [int(r) for r in _eligible(f.check, cols, extra, k.n)
                if (f.check, int(r)) not in taken]
        half = [r for r in rows if (r >= k.n // 2) == bool(f.half)] or rows
        if not half:
            raise ValueError(f"{f.check}: no row left for a fault")
        row = half[(f.key >> 8) % len(half)]
        _alter(f.check, cols, extra, row, f.key & 0xFF)
        taken.append((f.check, row))
    return taken
