"""ECC circuit: the BN254 EcAdd / EcMul / EcPairing ops of the precompiles
0x06-0x08 (reference: src/zkevm_specs/ecc_circuit.py:1-433).

Counterpart of ``zkevm_specs_tpu/circuits/ecc.py``.  The curve arithmetic
(``ops/ecc/bn254.py``: additions, multiplications, subgroup checks and the
pairing) runs on the host on Python ints, as in the JAX package, whose
circuit takes each row's chip verdict as a hint bit; ``ecc_kernel``'s check
constrains the verdict bits and the table-facing row shape on the device.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np

from ..dsl.cs import ConstraintSystem
from ..dsl.value import Ctx, F
from ..ops import limbs as L
from ..ops.ecc import bn254
from ..tables.schemas import EccOpTag
from ..utils.typing import is_circuit_code
from ..witness.rlc import RLC


def _check_fq(value: int) -> bool:
    return value < bn254.P


def _g1(x: int, y: int) -> bn254.PointG1:
    return None if x == 0 and y == 0 else (x, y)


def _pairing_rlc(values: List[int], n_pairs: int, keccak_randomness: int) -> int:
    """The RLC of the pairs' 6 coordinates each, as 32 little-endian bytes
    a coordinate, reversed."""
    input_bytes = b"".join(v.to_bytes(32, "little") for v in values)
    return RLC(bytes(reversed(input_bytes)), keccak_randomness, n_bytes=n_pairs * 192).expr()


def _in_subgroups(g1, g2) -> bool:
    valid_p = bn254.g1_mul(g1, bn254.R) is None
    valid_q = bn254.g2_mul(g2, bn254.R) is None if g2 is not None else True
    return valid_p and valid_q


class EcAdd(NamedTuple):
    p: Tuple[int, int]
    q: Tuple[int, int]
    out: Tuple[int, int]


class EcMul(NamedTuple):
    p: Tuple[int, int]
    s: int
    out: Tuple[int, int]


class EcPairing(NamedTuple):
    g1_pts: List[Tuple[int, int]]
    g2_pts: List[Tuple[int, int, int, int]]  # (x2, x1, y2, y1), the EVM's byte order
    out: int


class EccCircuitRow:
    """One ecc-table row and the chip's data to verify it (reference
    EccCircuitRow :12-333)."""

    def __init__(self, row: dict, chip_points=None, pairing_points=None):
        self.row = row
        self.chip_points = chip_points        # (p0, p1, out) for add and mul
        self.pairing_points = pairing_points  # (g1s, g2s as FQ2 pairs, out)

    @classmethod
    def assign_add(cls, p0: Tuple[int, int], p1: Tuple[int, int], out: Tuple[int, int]):
        prechecks = all(_check_fq(v) for v in (*p0, *p1))
        valid_points = bn254.g1_is_on_curve(_g1(*p0)) and bn254.g1_is_on_curve(_g1(*p1))
        row = {"op_type": int(EccOpTag.Add), "px": p0[0], "py": p0[1], "qx": p1[0],
               "qy": p1[1], "input_rlc": 0, "out_x": out[0], "out_y": out[1],
               "is_valid": int(prechecks and valid_points)}
        return cls(row, chip_points=(p0, p1, out))

    @classmethod
    def assign_mul(cls, p0: Tuple[int, int], s: int, out: Tuple[int, int]):
        prechecks = _check_fq(p0[0]) and _check_fq(p0[1])
        valid_point = bn254.g1_is_on_curve(_g1(*p0))
        row = {"op_type": int(EccOpTag.Mul), "px": p0[0], "py": p0[1], "qx": s, "qy": 0,
               "input_rlc": 0, "out_x": out[0], "out_y": out[1],
               "is_valid": int(prechecks and valid_point)}
        return cls(row, chip_points=(p0, (s, 0), out))

    @classmethod
    def assign_pairing(cls, pts: List[Tuple[int, int, int, int, int, int]], out: int,
                       keccak_randomness: int):
        g1s, g2s, values = [], [], []
        is_valid = True
        for (p_x, p_y, q_x2, q_x1, q_y2, q_y1) in pts:
            g1 = _g1(p_x, p_y)
            g2 = (None if q_x1 == q_x2 == q_y1 == q_y2 == 0
                  else (bn254.FQ2([q_x1, q_x2]), bn254.FQ2([q_y1, q_y2])))
            g1s.append(g1)
            g2s.append(g2)
            prechecks = all(_check_fq(v) for v in (p_x, p_y, q_x1, q_x2, q_y1, q_y2))
            on_curves = bn254.g1_is_on_curve(g1) and bn254.g2_is_on_curve(g2)
            is_valid = is_valid and prechecks and on_curves and _in_subgroups(g1, g2)
            values += [p_x, p_y, q_x1, q_x2, q_y1, q_y2]
        row = {"op_type": int(EccOpTag.Pairing), "px": 0, "py": 0, "qx": 0, "qy": 0,
               "input_rlc": _pairing_rlc(values, len(pts), keccak_randomness),
               # the boolean result sits in out_y (reference :224)
               "out_x": out >> 128, "out_y": out & ((1 << 128) - 1),
               "is_valid": int(is_valid)}
        return cls(row, pairing_points=(g1s, g2s, out))

    # -- verification --------------------------------------------------------

    def verify(self, max_add_ops: int, max_mul_ops: int, max_pairing_ops: int,
               keccak_randomness: int, counters: dict):
        op = self.row["op_type"]
        assert op in (int(EccOpTag.Add), int(EccOpTag.Mul), int(EccOpTag.Pairing)), \
            "unknown ecc op"
        assert self.row["is_valid"] in (0, 1)
        if op == int(EccOpTag.Add):
            counters["add"] += 1
            assert counters["add"] <= max_add_ops, "exceeds max number of add operations"
            self._verify_add()
        elif op == int(EccOpTag.Mul):
            counters["mul"] += 1
            assert counters["mul"] <= max_mul_ops, "exceeds max number of mul operations"
            self._verify_mul()
        else:
            counters["pairing"] += 1
            assert counters["pairing"] <= max_pairing_ops, "exceeds max number of pairings"
            self._verify_pairing(keccak_randomness)

    def _verify_add(self):
        p0, p1, out = self.chip_points
        assert self.row["input_rlc"] == 0
        result = bn254.g1_add(_g1(*p0), _g1(*p1))
        ok = ((0, 0) if result is None else result) == out
        assert int(ok) == self.row["is_valid"], "ecAdd result/validity mismatch"

    def _verify_mul(self):
        p0, p1, out = self.chip_points
        assert self.row["qy"] == 0
        assert self.row["input_rlc"] == 0
        result = bn254.g1_mul(_g1(*p0), p1[0])
        ok = ((0, 0) if result is None else result) == out
        assert int(ok) == self.row["is_valid"], "ecMul result/validity mismatch"

    def _verify_pairing(self, keccak_randomness: int):
        g1s, g2s, out = self.pairing_points
        assert self.row["out_x"] == out >> 128
        assert self.row["out_y"] == out & ((1 << 128) - 1)
        values = []
        for g1, g2 in zip(g1s, g2s):
            assert _in_subgroups(g1, g2), "pairing input not in the r-order subgroup"
            p_x, p_y = g1 if g1 is not None else (0, 0)
            q_x1, q_x2, q_y1, q_y2 = ((0, 0, 0, 0) if g2 is None
                                      else (*g2[0].c, *g2[1].c))
            values += [p_x, p_y, q_x1, q_x2, q_y1, q_y2]
        assert self.row["input_rlc"] == _pairing_rlc(values, len(g1s), keccak_randomness), \
            "pairing input rlc mismatch"
        result = int(bn254.pairing_check(list(zip(g1s, g2s))))
        assert result == out, "pairing result mismatch"


class EccCircuit:
    def __init__(self, max_add_ops: int, max_mul_ops: int, max_pairing_ops: int):
        self.add_ops: List[EcAdd] = []
        self.mul_ops: List[EcMul] = []
        self.pairing_ops: List[EcPairing] = []
        self.max_add_ops = max_add_ops
        self.max_mul_ops = max_mul_ops
        self.max_pairing_ops = max_pairing_ops

    def append_add(self, op: EcAdd):
        self.add_ops.append(op)

    def append_mul(self, op: EcMul):
        self.mul_ops.append(op)

    def append_pairing(self, op: EcPairing):
        self.pairing_ops.append(op)


def circuit2rows(circuit: EccCircuit, randomness_keccak: int) -> List[EccCircuitRow]:
    rows = [EccCircuitRow.assign_add(op.p, op.q, op.out) for op in circuit.add_ops]
    rows += [EccCircuitRow.assign_mul(op.p, op.s, op.out) for op in circuit.mul_ops]
    for op in circuit.pairing_ops:
        pts = [(g1[0], g1[1], g2[0], g2[1], g2[2], g2[3])
               for g1, g2 in zip(op.g1_pts, op.g2_pts)]
        rows.append(EccCircuitRow.assign_pairing(pts, op.out, randomness_keccak))
    return rows


def ecc_table_rows(circuit: EccCircuit, randomness_keccak: int) -> List[dict]:
    """The rows of the shared ecc table."""
    return [r.row for r in circuit2rows(circuit, randomness_keccak)]


def _chip_verdicts(circuit: EccCircuit, rows: List[EccCircuitRow],
                   randomness_keccak: int) -> List[bool]:
    """Each row's chip verdict, in order (the op counters run across rows)."""
    counters = {"add": 0, "mul": 0, "pairing": 0}
    out = []
    for row in rows:
        try:
            row.verify(circuit.max_add_ops, circuit.max_mul_ops, circuit.max_pairing_ops,
                       randomness_keccak, counters)
            out.append(True)
        except AssertionError:
            out.append(False)
    return out


def verify_circuit(circuit: EccCircuit, randomness_keccak: int) -> None:
    """Spec mode: the rows' chip checks in order, the first failure raising."""
    counters = {"add": 0, "mul": 0, "pairing": 0}
    for row in circuit2rows(circuit, randomness_keccak):
        row.verify(circuit.max_add_ops, circuit.max_mul_ops, circuit.max_pairing_ops,
                   randomness_keccak, counters)


# -- the production path ---------------------------------------------------------

@is_circuit_code
def check_ecc(ctx: Ctx, cs: ConstraintSystem, cols, tables, static, extra):
    """op_type one of the three ops, is_valid boolean and the host chip
    verdict of every row true (the JAX ``ecc_kernel``'s body)."""
    cs.constrain_in_consts(cols["op_type"], [int(EccOpTag.Add), int(EccOpTag.Mul),
                                             int(EccOpTag.Pairing)], "op_type")
    cs.constrain_bool(cols["is_valid"], "is_valid")
    ok = F(ctx, extra["chip_ok"].to(L.DTYPE)[:, None], 1)
    cs.constrain_equal(ok, F.const(ctx, 1), "ecc chip verification")


def ecc_inputs(circuit: EccCircuit, randomness_keccak: int, rows=None):
    """The check's columns and its ``chip_ok`` bits (built on the host from
    ``rows``, the circuit's ``circuit2rows`` when given); None when the
    circuit has no op."""
    rows = circuit2rows(circuit, randomness_keccak) if rows is None else rows
    if not rows:
        return None
    ctx = Ctx("cpu", len(rows), "eager")
    cols = {"op_type": F.from_ints(ctx, [r.row["op_type"] for r in rows], 8),
            "is_valid": F.from_ints(ctx, [r.row["is_valid"] for r in rows], 1)}
    ok = _chip_verdicts(circuit, rows, randomness_keccak)
    return cols, {"chip_ok": np.asarray(ok, dtype=np.uint8)}


def ecc_kernel(circuit: EccCircuit, randomness_keccak: int, device="cuda", rows=None):
    """The block verifier's ecc check as one ``CircuitKernel`` on ``device``
    (the card unless the caller asks for "cpu"); None when the circuit has
    no op.  The curve arithmetic stays host work (the reference's py_ecc
    chip boundary, ecc_circuit.py:48-333); the kernel constrains each row's
    verdict bit and its shape."""
    from ..runtime.kernels import CircuitKernel, require_device

    require_device(device, "ecc")
    inputs = ecc_inputs(circuit, randomness_keccak, rows)
    if inputs is None:
        return None
    cols, extra = inputs
    return CircuitKernel("ecc", check_ecc, cols, None, None, extra, device=device)
