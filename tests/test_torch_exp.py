"""The port's exp circuit (zkevm_specs_tpu_torch.circuits.exp) against the
JAX package's ``check_exp`` in spec mode, on the CPU, tolerance 0: the fail
bit of every row, and the first failure message of every row, on the
bases and exponents of tests/test_block_exp_sweep.py and
tests/test_bytecode_copy_exp.py (one event each, all in one circuit, with
the dummy fill), clean and with one row corrupted.  The port's check runs
eagerly and as its ``CircuitKernel`` on the CPU (the device mode, with K11's
plain version)."""
import numpy as np
import pytest
import torch

from zkevm_specs_tpu.circuits import exp as jexp
from zkevm_specs_tpu.dsl.cs import ConstraintSystem as JCS
from zkevm_specs_tpu.dsl.value import Ctx as JCtx
from zkevm_specs_tpu.witness import typing as JY
from zkevm_specs_tpu_torch.circuits import exp as pexp
from zkevm_specs_tpu_torch.dsl.cs import ConstraintSystem
from zkevm_specs_tpu_torch.dsl.value import Ctx
from zkevm_specs_tpu_torch.witness import typing as PY

torch.set_num_threads(1)

U256M = (1 << 256) - 1
# tests/test_block_exp_sweep.py's classes, then tests/test_bytecode_copy_exp.py's
EVENTS = [(2, 3), (3, 2), (2, 16), (7, 21), (0xFF, 0x100), (U256M, 3), (2, 255),
          (123456789, 2**31 - 1), (5, 11), (7, 2**15 + 1), (2**120, 5), (0, 2), (1, 3)]


def _circuit(Y, events, dummy=False, corrupt=None):
    c = Y.ExpCircuit()
    for i, (base, exponent) in enumerate(events):
        c.add_event(base, exponent, 7 + 13 * i)
    if dummy:
        c.fill_dummy_events()
    if corrupt is not None:
        row, field = corrupt
        c.rows[row][field] = (c.rows[row][field] + 1) % (1 << 256)
    return c


def _jax_rows(circuit):
    rows = circuit.table()
    ctx = JCtx(np, len(rows), "eager")
    cs = JCS(ctx)
    jexp.check_exp(ctx, cs, jexp.build_exp_cols(ctx, rows), {}, {}, {})
    return np.asarray(cs.fail), cs.first_failure_message()


def _port_rows(circuit):
    rows = circuit.table()
    ctx = Ctx("cpu", len(rows), "eager")
    cs = ConstraintSystem(ctx)
    pexp.check_exp(ctx, cs, pexp.build_exp_cols(ctx, rows), {}, {}, {})
    return cs.fail.numpy(), cs.first_failure_message()


def _both(events, **kw):
    jax_fail, jax_msgs = _jax_rows(_circuit(JY, events, **kw))
    port = _circuit(PY, events, **kw)
    assert port.rows == _circuit(JY, events, **kw).rows
    fail, msgs = _port_rows(port)
    np.testing.assert_array_equal(fail, jax_fail)
    assert msgs == jax_msgs
    on_device = pexp.exp_kernel(port, device="cpu")()
    np.testing.assert_array_equal(on_device.numpy(), jax_fail)
    return fail


@pytest.mark.parametrize("base,exponent", EVENTS)
def test_one_event_matches_jax(base, exponent):
    assert not _both([(base, exponent)]).any()


def test_all_events_with_dummy_fill_match_jax():
    assert not _both(EVENTS, dummy=True).any()


@pytest.mark.parametrize("field", ["d", "exponentiation", "exponent", "q", "r", "a", "b",
                                   "base", "identifier", "is_last"])
def test_corrupted_row_matches_jax(field):
    """One row of the (7, 21) event with ``field`` + 1: the rows that fail
    (it, and its predecessor where the change breaks the chaining) are the
    JAX package's."""
    row = 3
    fail = _both([(2, 3), (7, 21), (3, 2)], corrupt=(row, field))
    assert fail.any() and set(np.flatnonzero(fail)) <= {row - 1, row}


def test_empty_circuit():
    assert pexp.exp_kernel(PY.ExpCircuit(), device="cpu") is None
    pexp.verify_exp_circuit(PY.ExpCircuit())


def test_verify_raises_on_a_bad_row():
    c = _circuit(PY, [(3, 7)])
    c.rows[-1]["exponentiation"] += 1
    c.rows[-1]["d"] += 1
    pexp.verify_exp_circuit(c, success=False)
    with pytest.raises(AssertionError, match="exp row"):
        pexp.verify_exp_circuit(c)


def test_exp_table_matches_jax():
    assert (PY.exp_circuit_to_table(_circuit(PY, EVENTS))
            == JY.exp_circuit_to_table(_circuit(JY, EVENTS)))
